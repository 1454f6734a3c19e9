"""Fault injection (counterpart of ``deepspeed_tpu/resilience/chaos.py``).

:class:`FaultPlan` describes the failures to inject, and the real code
paths call the hooks here, so an armed plan fires against the code that
runs in production, not a mock:

- the save protocol calls :func:`fault_point` at each phase, in write
  order: ``begin-save`` -> ``shard`` (after each array, with its index) ->
  ``pre-manifest`` -> ``pre-commit`` -> ``post-commit`` -> ``pre-latest``
  -> ``end-save``; :class:`~.retry.RetryingWriter` calls :meth:`FaultPlan.on_io`
  before every attempt;
- the training engine resolves :func:`training_faults` once per executed
  batch (by data cursor) and :func:`sdc_flip_fault` once per step;
- the serving scheduler calls :func:`serving_dispatch_fault` inside each
  dispatch's watchdog phase and before the executor call,
  :func:`serving_alloc_fault` from ``PageAllocator.alloc`` and
  :func:`sdc_flip_fault` (domain ``kv_page``) once per step.

A plan is armed by the environment (``DS_FAULT_PLAN``, JSON), by the
``resilience.chaos`` config block (installed at engine init) or in code
(:func:`install_plan`). The offload runners call :func:`offload_fetch_fault`
at every blocking host<->device wait (inside the ``offload_fetch`` watchdog
bracket) and the host-shard flush calls :func:`fault_point` with
``host-shard`` after each shard. The injectors of a module the port does
not have yet raise when a plan arms them, naming their ROADMAP.md item, so
none sits inert: the tenant flood (``tenant_flood_*``, A10).

Imports neither torch nor the rest of the package beyond logging: the
elastic agent arms plans for its workers.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Any, Dict, Optional

from ..utils.errors import unported
from ..utils.logging import logger

FAULT_PLAN_ENV = "DS_FAULT_PLAN"

_TENANT_FLOOD_FIELDS = ("tenant_flood_at", "tenant_flood_requests", "tenant_flood_prompt",
                        "tenant_flood_max_new", "tenant_flood_vocab", "tenant_flood_tenant")


@dataclasses.dataclass
class FaultPlan:
    """The failures to inject; every field is the reference's.

    Save path: ``kill_at_phase`` (a phase, or ``"shard:N"``) SIGKILLs this
    process there on save number ``kill_at_save`` (0-based from install):
    no handler runs, as for a preemption that missed its grace window.
    ``corrupt_shard`` / ``truncate_manifest`` rot that save's committed tag
    right after ``COMMIT`` (the load must reject it and fall back).
    ``stall_io_seconds`` x ``stall_io_times`` sleep and ``fail_io_times``
    raise ``OSError`` on the first I/O attempts (the retrying writer
    absorbs them).

    Training path (by data cursor, the count of batches consumed):
    ``nan_at_step`` reports a NaN loss for the batch at that cursor (the
    sentinel rolls back and skips the window; a broken skip would loop
    until ``max_rollbacks``); ``stall_collective`` seconds of host stall in
    the ``collective`` watchdog phase at the first batch at or past
    ``stall_collective_at_step``; ``ef_overflow_steps`` steps reported as
    quantized-gradient overflows (drives the wire demotion);
    ``lose_worker_at_step`` SIGKILLs this process before the batch at that
    cursor runs (a data-parallel rank lost with its device).

    Serving path: dispatches (every attempt counts, 0-based) in
    ``[dispatch_raise_at, + dispatch_raise_times)`` raise
    :class:`InjectedDispatchError`; ``dispatch_stall_at`` sleeps
    ``dispatch_stall_seconds`` inside the dispatch's watchdog phase;
    ``PageAllocator.alloc`` calls in ``[alloc_fail_at, + alloc_fail_times)``
    report exhaustion.

    ``flip_bit_at`` + ``flip_bit_domain``: one real bit flipped inside a
    fingerprint-stamped block of the named integrity domain at the first
    training cursor (``"master"``) or scheduler step (``"kv_page"``) at or
    past ``flip_bit_at``. One-shot.

    Offload path: the ``stall_offload_at``-th (0-based, process-wide)
    blocking host<->device wait sleeps ``stall_offload_seconds`` before it
    blocks (one-shot), a hung copy that the ``offload_fetch`` deadline must
    flag; ``kill_at_phase: "host-shard:N"`` SIGKILLs right after host shard
    N of the flush lands; ``flip_bit_domain`` ``"host_shards"`` (the default)
    flips a bit of the host optimizer state.

    ``tenant_flood_*`` (A10) raises when armed.
    """

    kill_at_phase: Optional[str] = None
    kill_at_save: int = 0
    corrupt_shard: Optional[int] = None
    truncate_manifest: bool = False
    stall_io_seconds: float = 0.0
    stall_io_times: int = 1
    fail_io_times: int = 0
    # training-path injectors
    nan_at_step: Optional[int] = None
    stall_collective: float = 0.0
    stall_collective_at_step: int = 1
    ef_overflow_steps: int = 0
    lose_worker_at_step: Optional[int] = None
    # serving-path injectors
    dispatch_raise_at: Optional[int] = None
    dispatch_raise_times: int = 1
    dispatch_stall_at: Optional[int] = None
    dispatch_stall_seconds: float = 0.0
    alloc_fail_at: Optional[int] = None
    alloc_fail_times: int = 1
    # noisy-neighbor injection (multi-tenant serving, A10)
    tenant_flood_at: Optional[int] = None
    tenant_flood_requests: int = 8
    tenant_flood_prompt: int = 8
    tenant_flood_max_new: int = 8
    tenant_flood_vocab: int = 64
    tenant_flood_tenant: str = "flooder"
    # offload-path injectors
    stall_offload_at: Optional[int] = None
    stall_offload_seconds: float = 0.0
    # silent-data-corruption injector
    flip_bit_at: Optional[int] = None
    flip_bit_domain: str = "host_shards"

    # runtime counters (not part of the plan)
    _save_index: int = dataclasses.field(default=-1, repr=False)
    _io_calls: int = dataclasses.field(default=0, repr=False)
    _io_failures_left: int = dataclasses.field(default=0, repr=False)
    _stalls_left: int = dataclasses.field(default=0, repr=False)
    _collective_stall_fired: bool = dataclasses.field(default=False, repr=False)
    _ef_overflows_left: int = dataclasses.field(default=0, repr=False)
    _flip_bit_fired: bool = dataclasses.field(default=False, repr=False)
    _offload_stall_fired: bool = dataclasses.field(default=False, repr=False)

    def __post_init__(self) -> None:
        defaults = FaultPlan.__dataclass_fields__
        if any(getattr(self, f) != defaults[f].default for f in _TENANT_FLOOD_FIELDS):
            raise unported("FaultPlan.tenant_flood_* (the noisy-neighbor injection of "
                           "multi-tenant serving)", "A10")
        self._io_failures_left = int(self.fail_io_times)
        self._stalls_left = int(self.stall_io_times)
        self._ef_overflows_left = int(self.ef_overflow_steps)

    # ------------------------------------------------------------- construction
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        known = {f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultPlan keys {sorted(unknown)}; known: {sorted(known)}")
        return cls(**d)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        raw = os.environ.get(FAULT_PLAN_ENV, "").strip()
        if not raw:
            return None
        return cls.from_dict(json.loads(raw))

    # ------------------------------------------------------------------ hooks
    def _kill_armed(self, phase: str, index: Optional[int]) -> bool:
        if self.kill_at_phase is None or self._save_index != self.kill_at_save:
            return False
        want = self.kill_at_phase
        if ":" in want:
            want_phase, want_idx = want.split(":", 1)
            return phase == want_phase and index == int(want_idx)
        return phase == want

    def fault_point(self, phase: str, index: Optional[int] = None,
                    tag_dir: Optional[str] = None) -> None:
        """Called by the save protocol at each phase (no-op when disarmed)."""
        if phase == "begin-save":
            self._save_index += 1
        if self._kill_armed(phase, index):
            logger.warning(f"chaos: SIGKILL at phase {phase!r}"
                           + (f" shard {index}" if index is not None else "")
                           + f" (save #{self._save_index})")
            os.kill(os.getpid(), signal.SIGKILL)
        if (phase == "post-commit" and self._save_index == self.kill_at_save
                and tag_dir is not None):
            self._apply_bit_rot(tag_dir)

    def _apply_bit_rot(self, tag_dir: str) -> None:
        if self.corrupt_shard is not None:
            path = os.path.join(tag_dir, "state", "arrays", f"{self.corrupt_shard}.npy")
            if os.path.exists(path):
                with open(path, "r+b") as f:
                    f.seek(max(0, os.path.getsize(path) // 2))
                    chunk = f.read(16) or b"\0"
                    f.seek(-len(chunk), os.SEEK_CUR)
                    f.write(bytes(b ^ 0xFF for b in chunk))
                logger.warning(f"chaos: corrupted shard {path}")
            self.corrupt_shard = None  # fire once
        if self.truncate_manifest:
            path = os.path.join(tag_dir, "MANIFEST.json")
            if os.path.exists(path):
                with open(path, "r+b") as f:
                    f.truncate(max(0, os.path.getsize(path) // 2))
                logger.warning(f"chaos: truncated {path}")
            self.truncate_manifest = False

    def training_faults(self, cursor: int) -> "TrainingFaults":
        """The training-path injections for the batch at ``cursor``."""
        if self.lose_worker_at_step is not None and cursor == int(self.lose_worker_at_step):
            logger.warning(f"chaos: SIGKILL at data cursor {cursor} (a lost data-parallel "
                           "worker)")
            os.kill(os.getpid(), signal.SIGKILL)
        nan = self.nan_at_step is not None and cursor == int(self.nan_at_step)
        if nan:
            logger.warning(f"chaos: poisoning batch at data cursor {cursor} (loss -> NaN)")
        stall = 0.0
        if (self.stall_collective > 0 and not self._collective_stall_fired
                and cursor >= int(self.stall_collective_at_step)):
            self._collective_stall_fired = True
            stall = float(self.stall_collective)
            logger.warning(f"chaos: stalling collective for {stall}s at cursor {cursor}")
        ef = False
        if self._ef_overflows_left > 0:
            self._ef_overflows_left -= 1
            ef = True
            logger.warning(f"chaos: forcing quantized-gradient overflow at cursor {cursor} "
                           f"({self._ef_overflows_left} more)")
        return TrainingFaults(nan_loss=nan, stall_s=stall, ef_overflow=ef)

    def offload_fetch(self, index: int) -> float:
        """Seconds to stall blocking offload wait ``index`` (one-shot)."""
        if (self.stall_offload_at is None or self._offload_stall_fired
                or index < int(self.stall_offload_at) or self.stall_offload_seconds <= 0):
            return 0.0
        self._offload_stall_fired = True
        return float(self.stall_offload_seconds)

    def serving_dispatch(self, index: int) -> "ServingFault":
        """The injections for executor dispatch ``index`` (every attempt,
        retries included, advances it)."""
        raise_error = (self.dispatch_raise_at is not None
                       and int(self.dispatch_raise_at) <= index
                       < int(self.dispatch_raise_at) + max(1, int(self.dispatch_raise_times)))
        stall = 0.0
        if (self.dispatch_stall_at is not None and index == int(self.dispatch_stall_at)
                and self.dispatch_stall_seconds > 0):
            stall = float(self.dispatch_stall_seconds)
        return ServingFault(raise_error=raise_error, stall_s=stall)

    def sdc_flip(self, index: int, scope: str) -> Optional[str]:
        """The integrity domain to bit-flip at training cursor / scheduler
        step ``index``, or None. The engine consumes every domain but
        ``"kv_page"``, the scheduler only ``"kv_page"``. One-shot."""
        if self.flip_bit_at is None or self._flip_bit_fired or index < int(self.flip_bit_at):
            return None
        if (scope == "serving") != (self.flip_bit_domain == "kv_page"):
            return None
        self._flip_bit_fired = True
        return str(self.flip_bit_domain)

    def serving_alloc(self, index: int) -> bool:
        """Whether ``PageAllocator.alloc`` call ``index`` reports exhaustion."""
        return (self.alloc_fail_at is not None
                and int(self.alloc_fail_at) <= index
                < int(self.alloc_fail_at) + max(1, int(self.alloc_fail_times)))

    def on_io(self, what: str) -> None:
        """Called by the retrying writer before each I/O attempt."""
        self._io_calls += 1
        if self._stalls_left > 0 and self.stall_io_seconds > 0:
            self._stalls_left -= 1
            logger.warning(f"chaos: stalling I/O {what!r} for {self.stall_io_seconds}s")
            time.sleep(self.stall_io_seconds)
        if self._io_failures_left > 0:
            self._io_failures_left -= 1
            raise OSError(f"chaos: injected transient I/O error on {what!r}")


@dataclasses.dataclass(frozen=True)
class TrainingFaults:
    """The injections for one executed batch (all off without a plan)."""

    nan_loss: bool = False
    stall_s: float = 0.0
    ef_overflow: bool = False


@dataclasses.dataclass(frozen=True)
class ServingFault:
    """The injections for one serving dispatch (all off without a plan)."""

    raise_error: bool = False
    stall_s: float = 0.0


class InjectedDispatchError(RuntimeError):
    """The plan's synthetic dispatch failure, a type of its own so that an
    injected fault is told from an executor's bug."""


# an installed plan wins over the environment's; clearing it re-exposes the
# environment's, which is re-parsed when DS_FAULT_PLAN changes and keeps its
# fire-once counters while it does not
_INSTALLED: Optional[FaultPlan] = None
_ENV_PLAN: Optional[FaultPlan] = None
_ENV_SNAPSHOT: Optional[str] = None


def install_plan(plan: Optional[FaultPlan]) -> None:
    """Install (or clear, with None) the process-wide plan."""
    global _INSTALLED
    _INSTALLED = plan
    if plan is not None:
        logger.warning(f"chaos: fault plan armed: {plan}")


def get_fault_plan() -> Optional[FaultPlan]:
    """The installed plan, else the one ``DS_FAULT_PLAN`` names."""
    global _ENV_PLAN, _ENV_SNAPSHOT
    if _INSTALLED is not None:
        return _INSTALLED
    raw = os.environ.get(FAULT_PLAN_ENV, "").strip() or None
    if raw != _ENV_SNAPSHOT:
        _ENV_SNAPSHOT = raw
        _ENV_PLAN = FaultPlan.from_env() if raw else None
    return _ENV_PLAN


def fault_point(phase: str, index: Optional[int] = None, tag_dir: Optional[str] = None) -> None:
    plan = get_fault_plan()
    if plan is not None:
        plan.fault_point(phase, index=index, tag_dir=tag_dir)


_NO_FAULTS = TrainingFaults()


def training_faults(cursor: int) -> TrainingFaults:
    """The training-path injections for data cursor ``cursor``."""
    plan = get_fault_plan()
    return _NO_FAULTS if plan is None else plan.training_faults(cursor)


def serving_dispatch_fault(kind: str, index: int) -> None:
    """Fire the injections for dispatch ``index``: the stall first (a slow
    dispatch), then the raise (a failing one)."""
    plan = get_fault_plan()
    if plan is None:
        return
    f = plan.serving_dispatch(index)
    if f.stall_s > 0:
        logger.warning(f"chaos: stalling serving {kind} dispatch #{index} for {f.stall_s}s")
        time.sleep(f.stall_s)
    if f.raise_error:
        logger.warning(f"chaos: raising on serving {kind} dispatch #{index}")
        raise InjectedDispatchError(f"chaos: injected failure on serving {kind} dispatch "
                                    f"#{index}")


def sdc_flip_fault(index: int, scope: str = "training") -> Optional[str]:
    """The integrity domain armed for a bit flip at ``index``, or None. The
    caller flips through the integrity monitor (training) or the executor
    (serving), so the flip lands inside a stamped block."""
    plan = get_fault_plan()
    if plan is None:
        return None
    domain = plan.sdc_flip(index, scope)
    if domain is not None:
        logger.warning(f"chaos: arming bit flip in integrity domain {domain!r} at {scope} "
                       f"index {index}")
    return domain


def offload_fetch_fault(index: int) -> None:
    """Fire the stall armed for blocking offload wait ``index``; the caller
    is inside its ``offload_fetch`` watchdog bracket, so the deadline sees the
    hang as it would a wedged copy."""
    plan = get_fault_plan()
    if plan is None:
        return
    stall = plan.offload_fetch(index)
    if stall > 0:
        logger.warning(f"chaos: stalling offload fetch #{index} for {stall}s (an injected "
                       "host<->device copy hang)")
        time.sleep(stall)


def serving_alloc_fault(index: int) -> bool:
    """Whether the armed plan fails ``PageAllocator.alloc`` call ``index``."""
    plan = get_fault_plan()
    if plan is None:
        return False
    fired = plan.serving_alloc(index)
    if fired:
        logger.warning(f"chaos: failing page alloc call #{index} (simulated pool exhaustion)")
    return fired


__all__ = ["FaultPlan", "TrainingFaults", "ServingFault", "InjectedDispatchError",
           "FAULT_PLAN_ENV", "install_plan", "get_fault_plan", "fault_point",
           "training_faults", "serving_dispatch_fault", "serving_alloc_fault",
           "sdc_flip_fault", "offload_fetch_fault"]
