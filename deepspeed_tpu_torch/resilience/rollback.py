"""Divergence sentinels, automatic rollback and the wire demotion
(counterpart of ``deepspeed_tpu/resilience/rollback.py``).

:class:`HealthController` runs once per completed step (the engine calls
``after_step(metrics)`` with the step's loss already read to the host, so
each check is host arithmetic):

- :class:`SpikeDetector`: an EMA z-score over a scalar stream (loss, grad
  norm). A non-finite value fires at once; a finite one fires past
  ``zscore`` standard deviations above the EMA mean, after ``warmup``
  healthy samples and past a relative floor. A spike is not absorbed.
- Rollback: load the newest committed tag (verified before anything
  changes), else restore the in-memory anchor (a host copy of the state,
  restored bitwise), then skip every batch consumed since the anchor
  (``[restored cursor, cursor at the divergence)``) without running it.
  ``max_rollbacks`` bounds the loop: :class:`DivergenceError` after it.
  A silent-data-corruption rollback (:meth:`HealthController.sdc_rollback`)
  replays the window instead: the data was clean, the state was not.
- :class:`WireDemotionController`: ``demote_after`` consecutive overflow
  steps move the quantized gradient exchange to the fp32 wire;
  ``repromote_after`` clean steps bring it back with the error-feedback
  residuals zeroed.

A periodic save that fails degrades to the in-memory anchor and records
``checkpoint_io_degraded``; the step is never lost to the filesystem.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.logging import log_dist, logger


def _host_copy(x):
    """A host copy of a state tree (tensors copied, the rest kept)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host_copy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host_copy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_host_copy(v) for v in x)
    return x


def _to_device(x, device):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_device(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, device) for v in x)
    return x


class DivergenceError(RuntimeError):
    """Self-healing exhausted: rollback budget spent or no anchor exists."""


class SpikeDetector:
    """EMA z-score spike detector over one scalar stream.

    ``update(value)`` returns a reason string when ``value`` is divergent
    (non-finite, or a > ``zscore``-sigma spike after ``warmup`` healthy
    samples), else None. Only healthy samples update the EMA statistics.

    ``min_rel``: relative-deviation floor. A converged loss curve drives the
    EMA variance toward zero, where ordinary batch-to-batch wobble measures
    as tens of sigma — a spike must ALSO exceed ``min_rel * |mean|`` above
    the mean before it counts as divergence, so the detector stays calm on
    flat curves without losing real blow-ups (which are never 1% events).
    """

    def __init__(self, zscore: float = 6.0, beta: float = 0.98,
                 warmup: int = 20, min_rel: float = 0.1, name: str = "loss"):
        self.zscore = float(zscore)
        self.beta = float(beta)
        self.warmup = int(warmup)
        self.min_rel = float(min_rel)
        self.name = name
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def update(self, value: float) -> Optional[str]:
        v = float(value)
        if not math.isfinite(v):
            return f"non-finite {self.name} ({v})"
        if self.count >= self.warmup:
            std = math.sqrt(max(self.var, 1e-12))
            z = (v - self.mean) / std
            floor = self.min_rel * max(abs(self.mean), 1e-8)
            if z > self.zscore and (v - self.mean) > floor:
                return (f"{self.name} spike: {v:.4g} is {z:.1f} sigma above "
                        f"EMA {self.mean:.4g} (threshold {self.zscore}, "
                        f"rel floor {self.min_rel})")
        b = self.beta if self.count > 0 else 0.0
        delta = v - self.mean
        self.mean = b * self.mean + (1.0 - b) * v
        self.var = b * (self.var + (1.0 - b) * delta * delta)
        self.count += 1
        return None

    def state_dict(self) -> Dict[str, float]:
        return {"mean": self.mean, "var": self.var, "count": self.count}


class WireDemotionController:
    """Overflow-driven demotion of the quantized gradient wire (see module
    docstring). ``after_step`` returns "demoted"/"repromoted"/None."""

    def __init__(self, engine, demote_after: int = 3, repromote_after: int = 100,
                 recovery_log=None):
        self.engine = engine
        self.demote_after = int(demote_after)
        self.repromote_after = int(repromote_after)
        self.recovery_log = recovery_log
        self.consecutive_overflows = 0
        self.clean_steps = 0
        self.demotions = 0

    @property
    def active(self) -> bool:
        return bool(self.engine._qcomm.gradients)

    def after_step(self, metrics: Dict[str, Any]) -> Optional[str]:
        if not self.active:
            return None
        overflow = bool(metrics.get("overflow", False))
        if not self.engine._qgrad_demoted:
            self.consecutive_overflows = (
                self.consecutive_overflows + 1 if overflow else 0)
            if self.consecutive_overflows >= self.demote_after:
                self._demote()
                return "demoted"
            return None
        self.clean_steps = 0 if overflow else self.clean_steps + 1
        if self.clean_steps >= self.repromote_after:
            self._repromote()
            return "repromoted"
        return None

    def _demote(self) -> None:
        from ..comm.runtime_accounting import wire_ledger

        eng = self.engine
        step = int(eng.global_steps)
        reason = (f"{self.consecutive_overflows} consecutive overflow steps "
                  f"on the quantized gradient exchange")
        logger.error(
            f"wire demotion: qgrad -> fp32 wire at step {step} ({reason}); "
            f"re-promotion after {self.repromote_after} clean steps")
        eng._qgrad_demoted = True
        wire_ledger.record_demotion("qgrad", step, reason)
        self.demotions += 1
        self.consecutive_overflows = 0
        self.clean_steps = 0
        if self.recovery_log is not None:
            self.recovery_log.record("wire_demoted", step=step, op="qgrad",
                                     reason=reason)

    def _repromote(self) -> None:
        from ..comm.runtime_accounting import wire_ledger

        eng = self.engine
        step = int(eng.global_steps)
        log_dist(f"wire re-promotion: qgrad back to the quantized wire at "
                 f"step {step} ({self.clean_steps} clean steps)")
        # stale EF residuals predate the blow-up; a fresh start is the only
        # sound baseline for the re-promoted exchange
        for key in ("qgrad_residual", "qgrad_bucket_residual"):
            if key in eng.state:
                eng.state[key].zero_()
        eng._qgrad_demoted = False
        wire_ledger.record_repromotion("qgrad", step)
        self.clean_steps = 0
        if self.recovery_log is not None:
            self.recovery_log.record("wire_repromoted", step=step, op="qgrad")


class HealthController:
    """Per-step health orchestration for one engine (see module docstring)."""

    def __init__(self, engine):
        self.engine = engine
        res = engine.config.resilience
        self.cfg = res.sentinel
        self.save_dir = res.save_dir
        self.recovery_log = engine._recovery_log
        self.loss_detector = SpikeDetector(
            zscore=self.cfg.zscore, beta=self.cfg.ema_beta,
            warmup=self.cfg.warmup_steps,
            min_rel=self.cfg.min_relative_spike, name="loss")
        self.grad_detector = (
            SpikeDetector(zscore=self.cfg.grad_norm_zscore,
                          beta=self.cfg.ema_beta,
                          warmup=self.cfg.warmup_steps,
                          min_rel=self.cfg.min_relative_spike,
                          name="grad_norm")
            if self.cfg.grad_norm_zscore > 0 else None)
        self.demotion = WireDemotionController(
            engine, demote_after=res.degraded.demote_after,
            repromote_after=res.degraded.repromote_after,
            recovery_log=self.recovery_log)
        self.rollbacks = 0
        self.skipped_cursors: List[int] = []
        self._skip_until: Optional[int] = None
        self._memory_snapshot: Optional[Dict[str, Any]] = None
        self.checkpoint_io_degraded = False
        if self.cfg.enabled and self.cfg.memory_fallback:
            # the init-time state (possibly just auto-resumed) is the floor
            # anchor: a divergence before the first committed save still has
            # somewhere sound to land
            self._take_memory_snapshot()

    # ------------------------------------------------------------- skip set
    def should_skip(self, cursor: int) -> bool:
        """Whether the batch at ``cursor`` is inside the poisoned window."""
        return (self.cfg.skip_poisoned_batches
                and self._skip_until is not None
                and cursor < self._skip_until)

    def note_skipped(self, cursor: int) -> None:
        self.skipped_cursors.append(int(cursor))
        if self._skip_until is not None and cursor + 1 >= self._skip_until:
            self._skip_until = None  # window cleared; back to normal
        if self.recovery_log is not None:
            self.recovery_log.record("poison_skip", step=self.engine.global_steps,
                                     cursor=int(cursor))

    # ------------------------------------------------------------ per step
    def after_step(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Run all health checks for one completed step. May mutate the
        engine (rollback, wire demotion, auto-checkpoint). Returns a dict of
        what happened (empty when healthy)."""
        info: Dict[str, Any] = {}
        demoted = self.demotion.after_step(metrics)
        if demoted:
            info["wire"] = demoted
        if self.cfg.enabled:
            reason = None
            overflow = bool(metrics.get("overflow", False))
            if not overflow:
                # overflow steps report non-finite/garbage loss by
                # construction and are already healed by the loss-scale
                # machinery — only non-overflow metrics feed the sentinels.
                # The imperative boundary path carries no "loss" key (the
                # boundary program computes no loss); its loss channel is
                # merged in by the caller when available.
                loss = metrics.get("loss")
                if loss is not None:
                    reason = self.loss_detector.update(float(loss))
                if reason is None and self.grad_detector is not None:
                    gn = float(metrics.get("grad_norm", 0.0))
                    if math.isfinite(gn):  # finite-only: inf grad == overflow
                        reason = self.grad_detector.update(gn)
            if reason is not None:
                info["rolled_back"] = self._rollback(reason)
                return info
            interval = int(self.cfg.checkpoint_interval or 0)
            if interval > 0 and self.engine.global_steps % interval == 0:
                self._auto_checkpoint()
        return info

    # ----------------------------------------------------------- anchoring
    def _take_memory_snapshot(self) -> None:
        """The anchor: a host copy of the state (1.7 GB at GPT-2-125M with an
        fp32 master and Adam), taken after the device finished the step."""
        eng = self.engine
        runner = eng._offload or eng._param_stream
        host = None
        if runner is not None and runner.master is not None:
            # the offload runner's masters and moments: the host state a
            # restore must bring back with the device state
            host = {k: np.array(v, copy=True) for k, v in runner.host_state_dict().items()}
        self._memory_snapshot = {
            "host": host,
            "state": _host_copy(eng.state),
            "global_steps": eng.global_steps,
            "micro_steps": eng.micro_steps,
            "skipped_steps": eng.skipped_steps,
            "data_cursor": eng.data_cursor,
        }

    def _auto_checkpoint(self) -> None:
        from .retry import RetryBudgetExceeded

        eng = self.engine
        try:
            eng.save_checkpoint(self.save_dir)
            if self.checkpoint_io_degraded:
                self.checkpoint_io_degraded = False
                log_dist("health: checkpoint I/O recovered; disk anchors "
                         "resume")
        except (OSError, RetryBudgetExceeded) as e:
            # degrade, don't die: the step already succeeded — losing the
            # run to a sick filesystem would be worse than a stale anchor
            if not self.checkpoint_io_degraded:
                self.checkpoint_io_degraded = True
                logger.error(
                    f"health: periodic checkpoint failed ({e}); degrading to "
                    f"the in-memory anchor until I/O recovers")
            if self.recovery_log is not None:
                self.recovery_log.record("checkpoint_io_degraded",
                                         step=eng.global_steps, error=str(e))
        if self.cfg.memory_fallback:
            self._take_memory_snapshot()

    def _restore_memory_snapshot(self) -> None:
        snap = self._memory_snapshot
        eng = self.engine
        eng.load_state(_to_device(snap["state"], eng.device))
        runner = eng._offload or eng._param_stream
        if runner is not None and snap["host"] is not None:
            runner.load_host_state_dict({k: np.array(v, copy=True)
                                         for k, v in snap["host"].items()})
        eng._grad_acc = None
        eng.global_steps = int(snap["global_steps"])
        eng.micro_steps = int(snap["micro_steps"])
        eng.skipped_steps = int(snap["skipped_steps"])
        eng.data_cursor = int(snap["data_cursor"])

    # ------------------------------------------------------------ rollback
    def sdc_rollback(self, detail: Dict[str, Any]) -> Dict[str, Any]:
        """Containment for a verified silent-data-corruption detection
        (docs/RESILIENCE.md "Data integrity"): restore the newest anchor —
        re-verified before trust, a corrupt anchor falls back older — but
        unlike a divergence rollback the DATA was never at fault, the state
        was. The consumed batches are therefore replayed, not skipped: a
        deterministic dataloader reproduces the exact fault-free
        trajectory, making the heal step-exact."""
        reason = (f"sdc:{detail.get('domain')}:{detail.get('unit')}"
                  f":block{detail.get('block')}")
        info = self._rollback(reason)
        self._skip_until = None  # replay, don't skip: the data was clean
        info["skip_cursors"] = []
        info["sdc"] = dict(detail)
        if self.recovery_log is not None:
            self.recovery_log.record(
                "sdc_rollback", step=info.get("to_step"),
                domain=detail.get("domain"), unit=detail.get("unit"),
                block=detail.get("block"))
        return info

    def _rollback(self, reason: str) -> Dict[str, Any]:
        eng = self.engine
        if self.rollbacks >= self.cfg.max_rollbacks:
            raise DivergenceError(
                f"divergence detected ({reason}) but the rollback budget "
                f"({self.cfg.max_rollbacks}) is spent — the run cannot "
                f"self-heal; inspect recovery_events.jsonl")
        from_step = int(eng.global_steps)
        from_cursor = int(eng.data_cursor)
        t0 = time.monotonic()
        logger.error(f"divergence at step {from_step} ({reason}): rolling "
                     f"back to the newest committed checkpoint")
        source = "disk"
        loaded = None
        try:
            loaded, _ = eng.load_checkpoint(self.save_dir)
        except Exception as e:
            logger.error(f"rollback: disk anchor unusable ({e})")
        if loaded is None:
            if self._memory_snapshot is None:
                raise DivergenceError(
                    f"divergence detected ({reason}) but no rollback anchor "
                    f"exists (no committed checkpoint in {self.save_dir!r} "
                    f"and memory_fallback is off)")
            self._restore_memory_snapshot()
            source = "memory"
        to_step = int(eng.global_steps)
        to_cursor = int(eng.data_cursor)
        # poison window: every batch consumed since the anchor. The detector
        # cannot know which of them started the divergence (the spike crosses
        # the threshold with a lag), so the whole window is skipped — the
        # deterministic cursor makes the exclusion exact and replayable.
        self._skip_until = from_cursor if from_cursor > to_cursor else None
        self.rollbacks += 1
        elapsed = time.monotonic() - t0
        skipped = list(range(to_cursor, from_cursor))
        log_dist(
            f"rollback complete ({source} anchor, {elapsed:.2f}s): step "
            f"{from_step} -> {to_step}; skipping poisoned data cursors "
            f"{skipped if skipped else '(none)'}")
        if self.recovery_log is not None:
            self.recovery_log.record(
                "divergence_rollback", value=elapsed, step=to_step,
                reason=reason, from_step=from_step, source=source,
                skip_cursors=skipped)
        return {"reason": reason, "from_step": from_step, "to_step": to_step,
                "source": source, "skip_cursors": skipped,
                "latency_s": elapsed}


__all__ = ["SpikeDetector", "HealthController", "WireDemotionController",
           "DivergenceError"]
