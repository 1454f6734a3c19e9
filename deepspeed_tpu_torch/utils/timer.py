"""Throughput timer (counterpart of ``ThroughputTimer`` in
``deepspeed_tpu/utils/timer.py``).

The reference blocks on every step's loss to time it. Here the timer never
synchronises inside a step: it synchronises once when the first counted
step starts (so that queued warm-up work is not counted) and once when a
rate is read, and divides the tokens of the steps in between by the wall
time. Over a run of steps that is the device's rate where the host queues
work ahead of it (the engine copies each batch from pinned memory, so the
copy does not wait for the device either), and the host's rate where it
does not.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class ThroughputTimer:
    def __init__(self, start_step: int = 2, synchronize: Optional[Callable[[], None]] = None):
        self.start_step = start_step  # steps before this one are warm-up
        self.synchronize = synchronize or (lambda: None)
        self.steps = 0
        self.tokens = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        if self.steps + 1 == self.start_step:
            self.synchronize()
            self._t0 = time.perf_counter()

    def stop(self, tokens: int) -> None:
        self.steps += 1
        if self._t0 is not None:
            self.tokens += tokens

    def tokens_per_sec(self) -> float:
        """Tokens per second over the counted steps (0.0 before any)."""
        if self._t0 is None:
            return 0.0
        self.synchronize()
        return self.tokens / (time.perf_counter() - self._t0)
