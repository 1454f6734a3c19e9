"""Wall-clock and throughput timers (counterpart of
``deepspeed_tpu/utils/timer.py``).

:class:`SynchronizedWallClockTimer` is the reference's registry of named
timers. A timer's ``stop(sync_on=...)`` waits for the device work that
produced ``sync_on`` before it reads the clock: for a CUDA tensor it
synchronises that tensor's device, for a CPU tensor there is nothing to wait
for. The engine starts and stops these timers only under
``wall_clock_breakdown``, so no step synchronises otherwise.

:class:`ThroughputTimer` never synchronises inside a step: it synchronises
once when the first counted step starts (so that queued warm-up work is not
counted) and once when a rate is read, and divides the tokens of the steps
in between by the wall time. Over a run of steps that is the device's rate
where the host queues work ahead of it (the engine copies each batch from
pinned memory, so the copy does not wait for the device either), and the
host's rate where it does not.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from .logging import log_dist
from .tree import tree_leaves


def _synchronize_on(value) -> None:
    """Wait for the CUDA devices that hold the tensors of ``value`` (a
    tensor or a tree of them); CPU tensors are ready already."""
    devices = {t.device for t in tree_leaves(value) if torch.is_tensor(t) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = 0.0
        self.count = 0

    def start(self) -> None:
        if self.started_:
            raise RuntimeError(f"timer {self.name} already started")
        self.start_time = time.perf_counter()
        self.started_ = True

    def stop(self, sync_on=None) -> None:
        if not self.started_:
            raise RuntimeError(f"timer {self.name} not started")
        if sync_on is not None:
            _synchronize_on(sync_on)
        self.elapsed_ += time.perf_counter() - self.start_time
        self.count += 1
        self.started_ = False

    def reset(self) -> None:
        self.elapsed_ = 0.0
        self.count = 0
        self.started_ = False

    def elapsed(self, reset: bool = True) -> float:
        e = self.elapsed_
        if reset:
            self.reset()
        return e

    def mean(self) -> float:
        return self.elapsed_ / max(self.count, 1)


class SynchronizedWallClockTimer:
    """Registry of named timers (the reference's ``SynchronizedWallClockTimer``)."""

    def __init__(self):
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    def log(self, names: Optional[List[str]] = None, reset: bool = True,
            memory_breakdown=False) -> str:
        """Log ``time (ms) | name: X.XXms | ...`` for ``names`` (default all)
        and return the line; ``reset`` clears what was read."""
        names = names or list(self.timers)
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0
                parts.append(f"{name}: {ms:.2f}ms")
        msg = "time (ms) | " + " | ".join(parts)
        log_dist(msg)
        return msg


class ThroughputTimer:
    def __init__(self, start_step: int = 2, synchronize: Optional[Callable[[], None]] = None):
        self.start_step = start_step  # steps before this one are warm-up
        self.synchronize = synchronize or (lambda: None)
        self.steps = 0
        self.tokens = 0
        self.samples = 0
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None  # the host clock at the last counted stop

    def start(self) -> None:
        if self.steps + 1 == self.start_step:
            self.synchronize()
            self._t0 = time.perf_counter()

    def stop(self, tokens: int, samples: int = 0) -> None:
        self.steps += 1
        if self._t0 is not None:
            self.tokens += tokens
            self.samples += samples
            self._t_last = time.perf_counter()

    def tokens_per_sec(self) -> float:
        """Tokens per second over the counted steps (0.0 before any)."""
        if self._t0 is None:
            return 0.0
        self.synchronize()
        return self.tokens / (time.perf_counter() - self._t0)

    def avg_samples_per_sec(self) -> float:
        """Samples per second over the counted steps that have stopped, on
        the host clock (the reference's monitor rate; 0.0 before any). It
        does not synchronise: a caller that reads a device value every step,
        as the monitor does, paces the host to the device."""
        if self._t_last is None or self._t_last <= self._t0:
            return 0.0
        return self.samples / (self._t_last - self._t0)
