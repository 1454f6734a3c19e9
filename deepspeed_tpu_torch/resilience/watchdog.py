"""Hang and straggler watchdog: per-phase deadlines over a host-side
heartbeat (counterpart of ``deepspeed_tpu/resilience/watchdog.py``).

A run that hangs (a deadlocked collective, a wedged filesystem, a kernel
that never returns) burns card time silently. The engine brackets each
phase of its step loop (``compile``, ``step``, ``collective``,
``checkpoint``) and the serving scheduler each dispatch
(:data:`SERVING_PHASES`) with :meth:`HealthWatchdog.phase`; a daemon thread
checks the open phases against their deadlines. On a stall it dumps every
thread's stack to :data:`STACKS_FILENAME`, logs the quantized wire's ledger,
records ``watchdog_stall`` and calls ``on_stall`` (the engine's: a drain
request, so a stall that clears ends in a committed emergency save and the
preemption exit code). A phase that completes after its stall records
``watchdog_recovered``.

CUDA launches return before the card finishes, so the engine closes its
``step`` bracket only after a synchronisation the step pays for anyway (the
sentinel's read of the loss): a wedged kernel then holds the bracket open,
and a slow one is charged to its own step, not to the next phase.

:func:`identify_stragglers` is the pure policy (per-rank step times ->
outliers); :func:`allgather_host_stats` gathers the rows over the port's
comm facade at a step boundary (never from the watchdog thread: a
collective issued there while the main thread is inside another would
deadlock the group). The thread only reads phase state and writes logs and
events; it never touches device state.
"""

from __future__ import annotations

import faulthandler
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.logging import logger

STACKS_FILENAME = "watchdog_stacks.txt"

#: Engine phases with independent deadlines. ``idle`` (between steps, waiting
#: on the caller's dataloader) is deliberately unbounded: the engine cannot
#: distinguish a slow dataloader from a finished run.
PHASES = ("compile", "step", "collective", "checkpoint")

#: Serving phases (the reference's docs/SERVING.md "Overload & failure"): the
#: continuous-batching scheduler brackets every executor dispatch with one
#: of these, each with its own deadline (prefill is a multi-chunk forward,
#: decode a fixed-slot step/block — very different time scales; verify is
#: the speculative k+1-token analog of a decode step and shares its
#: deadline). A stalled dispatch gets the same treatment a stalled
#: training collective does: stack dump, wire-ledger log,
#: ``watchdog_stall`` recovery event, escalation callback.
SERVING_PHASES = ("serving_prefill", "serving_decode", "serving_verify")

#: The offload runners' phases: the blocking host<->device waits and the
#: host optimizer pass / host-shard flush, nested inside ``step``.
OFFLOAD_PHASES = ("offload_fetch", "offload_flush")


class HealthWatchdog:
    """Deadline monitor over the engine's step-loop phases.

    ``deadlines``: seconds per phase name (missing/<=0 disables that phase's
    check). ``on_stall(phase, elapsed)``: escalation callback, invoked once
    per stall episode from the watchdog thread. ``stacks_dir``: where the
    stall stack dump lands (None disables the dump).
    """

    def __init__(
        self,
        deadlines: Dict[str, float],
        poll_interval: float = 1.0,
        on_stall: Optional[Callable[[str, float], None]] = None,
        recovery_log=None,
        stacks_dir: Optional[str] = None,
    ):
        self.deadlines = {k: float(v) for k, v in deadlines.items()}
        self.poll_interval = float(poll_interval)
        self.on_stall = on_stall
        self.recovery_log = recovery_log
        self.stacks_dir = stacks_dir
        self._lock = threading.Lock()
        # open phases, outermost first: [name, start_monotonic, seq]. A stack
        # (not a single slot) because the offload runners bracket host-DMA
        # waits INSIDE the engine's step/checkpoint phases — every open
        # phase's deadline is checked independently.
        self._stack: List[list] = []
        self._seq = 0                 # increments on every enter
        self._stalled: set = set()    # seqs a stall already fired for
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0
        self.last_stall: Optional[Tuple[str, float]] = None

    # ------------------------------------------------------------- phase API
    @contextmanager
    def phase(self, name: str):
        """Bracket one deadline-checked phase (the engine's step loop).
        Nestable: an inner phase (e.g. ``offload_fetch`` inside ``step``)
        does not suspend the outer one's deadline."""
        seq = self._enter(name)
        try:
            yield self
        finally:
            self._exit(seq)

    def _enter(self, name: str) -> int:
        with self._lock:
            self._seq += 1
            self._stack.append([name, time.monotonic(), self._seq])
            return self._seq

    def _exit(self, seq: int) -> None:
        with self._lock:
            phase, elapsed = None, 0.0
            for i in range(len(self._stack) - 1, -1, -1):
                if self._stack[i][2] == seq:
                    name, start, _ = self._stack.pop(i)
                    phase = name
                    elapsed = time.monotonic() - start
                    break
            recovered = seq in self._stalled
            self._stalled.discard(seq)
        if recovered and phase is not None:
            # the stall cleared: a straggler, not a deadlock — record it so
            # the run record distinguishes "slow" from "dead"
            logger.warning(
                f"watchdog: phase {phase!r} recovered after {elapsed:.1f}s "
                f"(deadline {self.deadlines.get(phase, 0)}s)")
            if self.recovery_log is not None:
                self.recovery_log.record("watchdog_recovered", value=elapsed,
                                         phase=phase)

    # ---------------------------------------------------------- thread loop
    def start(self) -> "HealthWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="ds-health-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5 * self.poll_interval + 1.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            self._check()

    def _check(self) -> None:
        now = time.monotonic()
        with self._lock:
            snapshot = [(name, now - start, seq)
                        for name, start, seq in self._stack
                        if seq not in self._stalled]
        for phase, elapsed, seq in snapshot:
            deadline = self.deadlines.get(phase, 0.0)
            if deadline <= 0 or elapsed <= deadline:
                continue
            with self._lock:
                if not any(e[2] == seq for e in self._stack):
                    continue  # phase ended while we decided
                self._stalled.add(seq)
            self.stall_count += 1
            self.last_stall = (phase, elapsed)
            self._on_stall_detected(phase, elapsed)

    def _on_stall_detected(self, phase: str, elapsed: float) -> None:
        logger.error(
            f"watchdog: phase {phase!r} exceeded its {self.deadlines[phase]}s "
            f"deadline ({elapsed:.1f}s elapsed) — dumping stacks and "
            f"escalating to the drain path")
        self._dump_stacks(phase, elapsed)
        self._dump_wire_ledger()
        if self.recovery_log is not None:
            try:
                self.recovery_log.record("watchdog_stall", value=elapsed,
                                         phase=phase,
                                         deadline_s=self.deadlines[phase])
            except Exception as e:  # event export must never kill the thread
                logger.warning(f"watchdog: stall event not recorded: {e}")
        if self.on_stall is not None:
            try:
                self.on_stall(phase, elapsed)
            except Exception as e:
                logger.error(f"watchdog: escalation callback failed: {e}")

    def _dump_stacks(self, phase: str, elapsed: float) -> None:
        if self.stacks_dir is None:
            return
        try:
            os.makedirs(self.stacks_dir, exist_ok=True)
            path = os.path.join(self.stacks_dir, STACKS_FILENAME)
            with open(path, "a") as f:
                f.write(f"\n=== watchdog stall: phase={phase} "
                        f"elapsed={elapsed:.1f}s unix_time={time.time():.0f} "
                        f"pid={os.getpid()} ===\n")
                f.flush()
                faulthandler.dump_traceback(file=f, all_threads=True)
            logger.error(f"watchdog: thread stacks dumped to {path}")
        except OSError as e:
            logger.warning(f"watchdog: stack dump failed: {e}")

    def _dump_wire_ledger(self) -> None:
        try:
            from ..comm.runtime_accounting import wire_ledger

            if wire_ledger.records:
                logger.error("watchdog: wire state at stall:\n"
                             + wire_ledger.summary())
        except Exception as e:  # accounting must never kill the watchdog
            logger.warning(f"watchdog: wire ledger dump failed: {e}")


# ------------------------------------------------------------- stragglers
def identify_stragglers(
    durations_s: Sequence[float], factor: float = 2.0, floor_s: float = 1.0,
) -> List[int]:
    """Indices of hosts whose step duration marks them sick.

    A host is a straggler when its duration exceeds ``factor`` x the LOWER
    median of all hosts AND the absolute excess is above ``floor_s`` (tiny
    steps jitter far more than 2x without meaning anything). The lower
    median matters on even host counts: with the upper one, a 2-rank group
    could structurally never flag its slow host (the reference point would
    BE the straggler's own duration), and half-sick groups would hide
    themselves. Pure policy — the engine supplies the allgathered per-host
    durations.
    """
    vals = [float(d) for d in durations_s]
    if len(vals) < 2:
        return []
    med = sorted(vals)[(len(vals) - 1) // 2]
    return [i for i, d in enumerate(vals)
            if d > max(med * factor, med + floor_s)]


def allgather_host_stats(duration_s: float, fingerprint: Optional[int] = None,
                         device=None) -> Optional[List[dict]]:
    """Allgather ``{process_index, hostname, step_s[, fingerprint]}`` over
    the ranks of the process group, one fixed-width byte row each (the
    reference's layout). Call only from the main thread at a step boundary
    (it is a collective). None with one rank. ``fingerprint`` (uint32)
    carries the integrity monitor's boundary fingerprint on the same
    exchange, for the majority vote; every rank must agree on passing one.
    ``device``: where the row is exchanged (the engine's: NCCL takes CUDA
    tensors, gloo either)."""
    import socket

    import numpy as np
    import torch

    from ..comm import comm

    if comm.get_world_size() == 1:
        return None
    width = 80 if fingerprint is not None else 72
    name = socket.gethostname().encode()[:64]
    row = np.zeros(width, np.uint8)
    row[:len(name)] = np.frombuffer(name, np.uint8)
    row[64:72] = np.frombuffer(np.asarray([duration_s], np.float64).tobytes(), np.uint8)
    if fingerprint is not None:
        row[72:80] = np.frombuffer(np.asarray([fingerprint], np.uint64).tobytes(), np.uint8)
    t = torch.from_numpy(row)
    if device is not None:
        t = t.to(device)
    rows = comm.all_gather(t, axis=0, tiled=False).cpu().numpy().reshape(-1, width)
    out = []
    for i, r in enumerate(rows):
        host = bytes(r[:64]).rstrip(b"\0").decode(errors="replace")
        dur = float(np.frombuffer(bytes(r[64:72]), np.float64)[0])
        entry = {"process_index": i, "hostname": host, "step_s": dur}
        if fingerprint is not None:
            entry["fingerprint"] = int(np.frombuffer(bytes(r[72:80]), np.uint64)[0])
        out.append(entry)
    return out


__all__ = ["HealthWatchdog", "identify_stragglers", "allgather_host_stats",
           "PHASES", "SERVING_PHASES", "OFFLOAD_PHASES", "STACKS_FILENAME"]
