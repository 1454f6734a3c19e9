"""The elastic agent: failure detection and resize-and-resume supervision
(counterpart of ``deepspeed_tpu/elasticity/elastic_agent.py``, after
DeepSpeed's ``DSElasticAgent``).

The agent is a supervisor process that

1. resolves the elastic batch triangle for the current world size
   (:func:`~.elasticity.compute_elastic_config`);
2. launches the worker command (``make_cmd(spec)``; the command starts the
   spec's ranks) and watches it (its exit code, and the device count);
3. on a failure or a change of membership re-resolves the triangle at the
   new world size and relaunches; the workers resume from the newest
   committed tag, which loads at any world size (reshard-on-load).

A preempted exit (:data:`~..resilience.preemption.PREEMPTED_EXIT_CODE`: the
worker drained and saved) and a change of membership spend no restart
budget; a crash does, with backoff, and ``crash_loop_threshold`` crashes on
one tag quarantine it (the next resume falls back to the previous tag).

The agent never initialises CUDA: :func:`probe_device_count` asks a child
process, so the card stays free for the workers it launches.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

from ..resilience import RecoveryLog, quarantine_tag, read_latest
from ..resilience.preemption import PREEMPTED_EXIT_CODE
from ..resilience.retry import backoff_delay
from ..utils.logging import logger
from .elasticity import (ELASTICITY_CONFIG_ENV, ElasticityError,
                         compute_elastic_config, validate_elasticity_block)


def probe_device_count(timeout: float = 120.0) -> int:
    """The CUDA device count, asked of a child process: the supervisor never
    initialises CUDA itself (a context in the agent would hold memory on
    the cards its workers need). ``DS_ELASTIC_WORLD`` overrides it."""
    forced = os.environ.get("DS_ELASTIC_WORLD")
    if forced:
        return int(forced)
    p = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.cuda.device_count())"],
        capture_output=True, text=True, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"device probe failed: {p.stderr[-300:]}")
    return int(p.stdout.strip().splitlines()[-1])


@dataclasses.dataclass
class WorkerSpec:
    """One launch decision: the resolved decomposition for a world size."""

    world_size: int
    micro_batch: int
    gas: int
    global_batch: int


@dataclasses.dataclass
class AgentResult:
    state: str  # "SUCCEEDED" | "FAILED"
    restarts: int
    history: List[WorkerSpec]
    preemptions: int = 0            # graceful drain exits survived
    quarantined: List[str] = dataclasses.field(default_factory=list)
    membership_changes: int = 0     # budget-free resize relaunches


class DSElasticAgent:
    """Supervise an elastic training worker: DeepSpeed's monitor / restart
    semantics, with checkpoint-resume in place of the rendezvous.

    Args:
      make_cmd: ``(spec: WorkerSpec) -> argv`` building the worker command; the
        worker must resume from its checkpoint dir on start.
      ds_config: dict with the ``elasticity`` block (and anything the caller's
        ``make_cmd`` needs).
      device_count_fn: current usable world size (devices). Defaults to
        :func:`probe_device_count` (out-of-process, cached per poll). A change
        triggers restart-at-new-size.
      max_restarts: give up after this many failures (parity: torchelastic
        ``max_restarts``). Graceful preemption exits
        (:data:`~deepspeed_tpu_torch.resilience.preemption.PREEMPTED_EXIT_CODE`)
        do NOT consume restart budget — the worker checkpointed and left on
        purpose; it is relaunched immediately without backoff. Membership
        changes are equally budget-free (docs/RESILIENCE.md "Elastic
        membership"): a worker dying together with a device-count change (a
        lost host kills its worker) relaunches at the re-resolved world size
        with no restart counted and a ``membership_change`` recovery event;
        only same-world crashes spend budget and back off.
      poll_interval: seconds between membership checks while the worker runs.
      checkpoint_dir: the worker's checkpoint directory. When set, the agent
        (a) applies exponential restart backoff, (b) detects crash loops —
        ``crash_loop_threshold`` consecutive failures while ``latest`` points
        at the same tag quarantine that tag
        (:func:`~deepspeed_tpu_torch.resilience.quarantine_tag`: the next resume
        falls back to the previous committed tag instead of dying on the
        poisoned one forever), and (c) appends recovery events to
        ``<checkpoint_dir>/recovery_events.jsonl``.
      crash_loop_threshold: K consecutive failures on one tag before it is
        quarantined.
      backoff_base / backoff_max: restart delay ``min(max, base * 2**(n-1))``
      with decorrelating jitter; reset on any successful-looking transition
        (preemption, membership change, new tag).
    """

    def __init__(self, make_cmd: Callable[[WorkerSpec], Sequence[str]],
                 ds_config: dict,
                 device_count_fn: Optional[Callable[[], int]] = None,
                 max_restarts: int = 10, poll_interval: float = 1.0,
                 checkpoint_dir: Optional[str] = None,
                 crash_loop_threshold: int = 3,
                 backoff_base: float = 1.0, backoff_max: float = 60.0,
                 preempted_exit_code: int = PREEMPTED_EXIT_CODE):
        self.make_cmd = make_cmd
        self.ds_config = ds_config
        # config may be a dict or an object with .elasticity (the
        # DeepSpeedConfig): normalize once for the fingerprint export
        self._elastic_block = dict(
            ds_config.get("elasticity", {}) if isinstance(ds_config, dict)
            else getattr(ds_config, "elasticity", None) or {})
        if self._elastic_block.get("enabled"):
            # fail at construction, not at the first resize: this is the same
            # validation runtime/config.py applies to the worker's copy
            self._elastic_block = validate_elasticity_block(
                self._elastic_block, warn=logger.warning)
        self.device_count_fn = device_count_fn or probe_device_count
        self.max_restarts = int(max_restarts)
        self.poll_interval = float(poll_interval)
        self.checkpoint_dir = checkpoint_dir
        self.crash_loop_threshold = int(crash_loop_threshold)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        # must match the worker's resilience.exit_code when that knob is
        # customized — otherwise graceful drains are counted as crashes
        code = int(preempted_exit_code)
        if code == PREEMPTED_EXIT_CODE:  # not overridden: read the config
            res_block = (ds_config.get("resilience", {})
                         if isinstance(ds_config, dict)
                         else getattr(ds_config, "resilience", None))
            if isinstance(res_block, dict):
                code = int(res_block.get("exit_code", PREEMPTED_EXIT_CODE))
            elif res_block is not None:
                code = int(getattr(res_block, "exit_code", PREEMPTED_EXIT_CODE))
        self.preempted_exit_code = code
        self._events = (RecoveryLog.for_dir(checkpoint_dir, role="agent")
                        if checkpoint_dir else RecoveryLog(role="agent"))

    # ------------------------------------------------------------- resolution
    def resolve(self, world_size: int) -> WorkerSpec:
        """Largest valid world size <= ``world_size``, and its decomposition
        keeping the elastic global batch fixed."""
        final_bs, valid, _ = compute_elastic_config(self.ds_config, 0)
        usable = [w for w in valid if w <= world_size]
        if not usable:
            raise ElasticityError(
                f"no valid elastic world size <= {world_size} (valid: {valid})")
        w = max(usable)
        _, _, micro = compute_elastic_config(self.ds_config, w)
        gas = final_bs // (micro * w)
        return WorkerSpec(world_size=w, micro_batch=micro, gas=gas,
                          global_batch=final_bs)

    # ------------------------------------------------------------- supervision
    def _latest_tag(self) -> Optional[str]:
        return read_latest(self.checkpoint_dir) if self.checkpoint_dir else None

    def _backoff(self, consecutive_failures: int) -> float:
        return backoff_delay(consecutive_failures,
                             self.backoff_base, self.backoff_max)

    def run(self) -> AgentResult:
        restarts = 0
        preemptions = 0
        membership_changes = 0
        quarantined: List[str] = []
        history: List[WorkerSpec] = []
        consecutive_failures = 0    # resets on preemption/membership change
        same_tag_failures = 0
        last_failed_tag: Optional[str] = None
        prev_spec: Optional[WorkerSpec] = None
        # the (world, spec) a post-death probe already resolved: carried into
        # the next launch so ONE probe drives both the budget decision and
        # the membership event/relaunch — two independent probes around an
        # unstable dying runtime could classify the death one way and
        # relaunch another
        pending: Optional[Tuple[int, WorkerSpec]] = None
        while True:
            # re-probe device count before EVERY launch: the world this
            # worker group is resolved for is the world that exists NOW, not
            # the one the agent started with
            if pending is not None:
                world, spec = pending
                pending = None
            else:
                world = self.device_count_fn()
                spec = self.resolve(world)
            if prev_spec is not None and spec.world_size != prev_spec.world_size:
                # membership change: budget-free like a drained preemption —
                # losing a device is the cluster's fault, not the worker's
                membership_changes += 1
                consecutive_failures = 0
                same_tag_failures = 0
                last_failed_tag = None
                self._events.record(
                    "membership_change", value=membership_changes,
                    old_world=prev_spec.world_size,
                    new_world=spec.world_size,
                    tag=self._latest_tag() or "")
                logger.warning(
                    f"elastic agent: membership change "
                    f"{prev_spec.world_size} -> {spec.world_size}; "
                    f"relaunching at the new decomposition (budget-free, "
                    f"{membership_changes} change(s) absorbed)")
            prev_spec = spec
            history.append(spec)
            resume_tag = self._latest_tag()
            argv = list(self.make_cmd(spec))
            logger.info(
                f"elastic agent: launching worker (attempt "
                f"{restarts + preemptions + membership_changes + 1}): "
                f"world={spec.world_size} "
                f"micro={spec.micro_batch} gas={spec.gas} "
                f"global_batch={spec.global_batch}"
                + (f" resume_tag={resume_tag}" if resume_tag else ""))
            # export the fingerprint the worker's runtime must match
            # (ensure_immutable_elastic_config, elasticity.py) — the agent IS
            # the resource scheduler here
            env = dict(os.environ)
            env[ELASTICITY_CONFIG_ENV] = json.dumps(
                {"elasticity": self._elastic_block})
            proc = subprocess.Popen(argv, env=env)
            rc = self._watch(proc, launched_world=world)
            if rc == 0:
                logger.info("elastic agent: worker SUCCEEDED")
                return AgentResult("SUCCEEDED", restarts, history,
                                   preemptions=preemptions,
                                   quarantined=quarantined,
                                   membership_changes=membership_changes)
            if rc == self.preempted_exit_code:
                # graceful drain: the worker committed an emergency checkpoint
                # and left — relaunch immediately, spend no restart budget
                preemptions += 1
                consecutive_failures = 0
                self._events.record("preemption_restart",
                                    value=preemptions, tag=resume_tag or "")
                logger.warning(
                    f"elastic agent: worker preempted (rc={rc}, drained "
                    f"cleanly); relaunching from its emergency checkpoint "
                    f"({preemptions} preemption(s) survived)")
                continue
            post = self._probe_after_death()
            if rc is None or (post is not None
                              and post[1].world_size != spec.world_size):
                # the worker died WITH a membership change (a lost device
                # kills its worker): budget-free — the SAME probe that made
                # this call is carried to the loop top, which records the
                # membership_change event and launches at its decomposition
                pending = post
                logger.warning(
                    f"elastic agent: worker exited rc={rc} with a membership "
                    "change pending; re-resolving the world size "
                    "(budget-free restart)")
                continue
            restarts += 1
            consecutive_failures += 1
            if restarts > self.max_restarts:
                logger.error(
                    f"elastic agent: giving up after {restarts - 1} restarts")
                return AgentResult("FAILED", restarts - 1, history,
                                   preemptions=preemptions,
                                   quarantined=quarantined,
                                   membership_changes=membership_changes)
            self._events.record("worker_restart", value=restarts,
                                rc=rc, tag=resume_tag or "")
            # crash-loop detection: K consecutive crashes while 'latest'
            # still points at the same tag → the tag is poisoned (loads but
            # kills the worker); quarantine it so the next resume falls back
            # to the previous committed tag
            failed_tag = self._latest_tag()
            if failed_tag is not None:
                if failed_tag == last_failed_tag:
                    same_tag_failures += 1
                else:
                    # latest moved since the previous failure: the worker made
                    # real progress, so this is not an escalating crash loop
                    consecutive_failures = 1
                    same_tag_failures = 1
                    last_failed_tag = failed_tag
                if same_tag_failures >= self.crash_loop_threshold:
                    new_latest = quarantine_tag(
                        self.checkpoint_dir, failed_tag,
                        f"crash loop: {same_tag_failures} consecutive worker "
                        f"failures (last rc={rc}) resuming this tag")
                    quarantined.append(failed_tag)
                    self._events.record("tag_quarantined", tag=failed_tag,
                                        new_latest=new_latest or "")
                    same_tag_failures = 0
                    last_failed_tag = None
            delay = self._backoff(consecutive_failures)
            logger.warning(
                f"elastic agent: worker exited rc={rc}; restarting in "
                f"{delay:.1f}s ({restarts}/{self.max_restarts}) from the "
                f"latest committed checkpoint")
            time.sleep(delay)

    def _probe_after_death(self) -> Optional[Tuple[int, WorkerSpec]]:
        """ONE device probe after a worker death, resolved against the
        ladder. Its spec decides whether the death was a membership change
        (budget-free) AND — carried to the loop top — what to launch next,
        so a probe flapping between the two decisions cannot classify the
        death one way and relaunch another. ``None`` when the probe or
        resolution fails: not a membership change the agent can act on, so
        the exit counts as a plain crash (backoff + budget)."""
        try:
            world = self.device_count_fn()
            return world, self.resolve(world)
        except (ElasticityError, RuntimeError, OSError) as e:
            logger.warning(f"elastic agent: post-crash device probe failed "
                           f"({e}); counting the exit as a crash")
            return None

    def _watch(self, proc: subprocess.Popen,
               launched_world: int) -> Optional[int]:
        """Wait on the worker, polling membership against the world size the
        launch was RESOLVED for (a change in the launch window is caught on the
        first poll); a change kills + restarts (``None`` re-resolves — a
        synthetic int would collide with real signal exits, ``poll()`` returns
        ``-signum``)."""
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc
            time.sleep(self.poll_interval)
            now = self.device_count_fn()
            if now != launched_world:
                logger.warning(
                    f"elastic agent: membership change {launched_world} -> {now}; "
                    "restarting worker group")
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The ``ds_elastic`` command line: supervise
    ``python <script> ...`` with `--world/--micro/--gas` appended per launch."""
    import argparse

    p = argparse.ArgumentParser("ds_elastic")
    p.add_argument("--config", required=True, help="DeepSpeed JSON with an elasticity block")
    p.add_argument("--max-restarts", type=int, default=10)
    p.add_argument("--checkpoint-dir", default=None,
                   help="worker checkpoint dir: enables crash-loop tag "
                        "quarantine + recovery-event logging")
    p.add_argument("--crash-loop-threshold", type=int, default=3)
    p.add_argument("script", help="worker script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    with open(args.config) as f:
        ds_config = json.load(f)

    def make_cmd(spec: WorkerSpec):
        return [sys.executable, args.script, *args.script_args,
                "--elastic-world", str(spec.world_size),
                "--elastic-micro", str(spec.micro_batch),
                "--elastic-gas", str(spec.gas)]

    agent = DSElasticAgent(make_cmd, ds_config,
                           device_count_fn=probe_device_count,
                           max_restarts=args.max_restarts,
                           poll_interval=30.0,
                           checkpoint_dir=args.checkpoint_dir,
                           crash_loop_threshold=args.crash_loop_threshold)
    result = agent.run()
    return 0 if result.state == "SUCCEEDED" else 1


if __name__ == "__main__":
    sys.exit(main())
