"""Preemption (SIGTERM/SIGINT) drain handling (counterpart of
``deepspeed_tpu/resilience/preemption.py``).

Preemptible capacity delivers a SIGTERM and a short grace window. The
guard converts the async signal into a *drain flag* the engine polls at
micro-batch boundaries — the only points where device state is consistent
enough to checkpoint — then the engine performs an emergency save and exits
with :data:`PREEMPTED_EXIT_CODE`, a code supervisors (``DSElasticAgent``)
recognize as a graceful preemption rather than a crash.

A second signal while draining restores the previous handlers and re-raises:
the operator's Ctrl-C-twice escape hatch, and the scheduler's hard-kill path.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Iterable, Optional

from ..utils.logging import logger

# Distinguished from crash codes (1, 134, 139, 137=SIGKILL'd, 143=SIGTERM'd
# without drain): "the worker saved its state and left on purpose".
PREEMPTED_EXIT_CODE = 83


class PreemptionGuard:
    """Installable signal-to-drain-flag bridge.

    Deliberately LOCK-FREE: a Python signal handler runs on the main thread
    between bytecodes, so a handler that acquires a lock the interrupted main
    thread already holds deadlocks the process — the exact grace window the
    guard exists to use. All state transitions are plain attribute writes
    (GIL-atomic); the one benign race (two near-simultaneous "first" signals)
    at worst overwrites ``signal_name`` with an equally true value.

    Installation must happen on the main thread (Python restriction) —
    elsewhere it degrades to a warning and an inert guard, so library code
    can construct one unconditionally.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._drain = False
        self._signal_name: Optional[str] = None
        self._requested_at: Optional[float] = None
        self._previous: Dict[int, object] = {}
        self.installed = False

    # ------------------------------------------------------------------ state
    @property
    def drain_requested(self) -> bool:
        return self._drain

    @property
    def signal_name(self) -> Optional[str]:
        return self._signal_name

    @property
    def requested_at(self) -> Optional[float]:
        """``time.monotonic()`` of the first signal (grace-window budgeting)."""
        return self._requested_at

    def request_drain(self, reason: str = "manual") -> None:
        """Programmatic drain (tests; cooperative shutdown APIs)."""
        if not self._drain:
            self._signal_name = reason
            self._requested_at = time.monotonic()
            self._drain = True  # flag last: readers see complete metadata

    # ------------------------------------------------------------- installation
    def _handler(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        first = not self._drain
        if first:
            self._signal_name = name
            self._requested_at = time.monotonic()
            self._drain = True
        if first:
            logger.warning(
                f"{name} received (pid {os.getpid()}): draining — will "
                f"checkpoint at the next micro-batch boundary and exit "
                f"{PREEMPTED_EXIT_CODE}; send again to abort immediately")
        else:
            logger.error(f"second {name} while draining: aborting immediately")
            self.uninstall()
            os.kill(os.getpid(), signum)

    def install(self) -> "PreemptionGuard":
        if self.installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "PreemptionGuard.install() called off the main thread; signal "
                "handlers cannot be registered — preemption drain disabled "
                "(call engine.install_preemption_guard() from the main thread)")
            return self
        for s in self.signals:
            self._previous[s] = signal.getsignal(s)
            signal.signal(s, self._handler)
        self.installed = True
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        self._previous.clear()
        self.installed = False


__all__ = ["PreemptionGuard", "PREEMPTED_EXIT_CODE"]
