"""Bounded-retry file I/O for checkpoint durability (counterpart of
``deepspeed_tpu/resilience/retry.py``).

Checkpoint writes cross filesystems that fail transiently (network mounts,
overlay filesystems under memory pressure). A failed write two shards into
a 50-shard checkpoint should be retried with backoff, and only a persistent
failure surfaces. :class:`RetryingWriter` wraps every durable-write
primitive of the commit protocol (tmp-write, fsync, atomic replace) in
bounded exponential backoff with jitter. The jitter comes from
``os.urandom``, so checkpoint I/O draws from no seeded random stream. An
armed :class:`~.chaos.FaultPlan` stalls or fails attempts inside
:meth:`RetryingWriter.call`, so the chaos tests exercise the retry path
production runs.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Any, Callable, Optional, Tuple, Type

from ..utils.logging import logger

# the transient-filesystem class; everything else propagates at once
TRANSIENT_ERRORS: Tuple[Type[BaseException], ...] = (OSError,)


def _jitter01() -> float:
    """Uniform [0, 1) that consumes no seeded random stream."""
    return struct.unpack("<I", os.urandom(4))[0] / 2**32


def backoff_delay(attempt: int, base_delay: float, max_delay: float) -> float:
    """Jittered exponential backoff before retry ``attempt`` (1-based):
    ``min(max_delay, base_delay * 2**(attempt-1)) * (0.5 + jitter/2)``."""
    delay = min(max_delay, base_delay * 2 ** max(0, attempt - 1))
    return delay * (0.5 + _jitter01() / 2)


class RetryBudgetExceeded(OSError):
    """A durable write failed every attempt; the last error is chained."""


class RetryingWriter:
    """Run file-I/O callables with bounded exponential backoff and jitter.
    ``attempts`` is the total number of tries (1: no retry)."""

    def __init__(self, attempts: int = 5, base_delay: float = 0.05, max_delay: float = 2.0,
                 sleep: Callable[[float], None] = time.sleep):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = int(attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self._sleep = sleep
        self.retries_performed = 0

    def call(self, fn: Callable[..., Any], *args: Any, describe: Optional[str] = None,
             **kwargs: Any) -> Any:
        from .chaos import get_fault_plan

        what = describe or getattr(fn, "__name__", "io")
        plan = get_fault_plan()
        last: Optional[BaseException] = None
        for attempt in range(1, self.attempts + 1):
            try:
                if plan is not None:
                    plan.on_io(what)  # may stall or raise a transient error
                return fn(*args, **kwargs)
            except TRANSIENT_ERRORS as e:
                last = e
                if attempt == self.attempts:
                    break
                delay = backoff_delay(attempt, self.base_delay, self.max_delay)
                self.retries_performed += 1
                logger.warning(f"checkpoint I/O {what!r} failed (attempt {attempt}/"
                               f"{self.attempts}): {e}; retrying in {delay:.3f}s")
                self._sleep(delay)
        raise RetryBudgetExceeded(
            f"checkpoint I/O {what!r} failed after {self.attempts} attempts: {last}") from last

    def atomic_write(self, path: str, dump: Callable[[Any], None], fsync: bool = True,
                     describe: Optional[str] = None) -> None:
        """``dump(file)`` into a tmp file beside ``path``, optionally fsync'd,
        then ``os.replace`` onto ``path`` (and, when fsync'd, the directory
        entry flushed). Afterwards the target is absent, old or complete,
        never torn; on failure no tmp file survives."""

        def _write() -> None:
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                with open(tmp, "wb") as f:
                    dump(f)
                    if fsync:
                        f.flush()
                        os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
            if fsync:
                self.fsync_dir(os.path.dirname(path) or ".")

        self.call(_write, describe=describe or f"write {os.path.basename(path)}")

    def write_bytes(self, path: str, data: bytes, fsync: bool = True) -> None:
        self.atomic_write(path, lambda f: f.write(data), fsync=fsync)

    def write_array(self, path: str, arr, fsync: bool = False) -> None:
        """Atomic ``.npy`` write. The fsync waits for the commit's pass over
        the whole tag (``manifest.commit_tag``): a fsync per shard would
        serialize the save on flush latency."""
        import numpy as np

        self.atomic_write(path, lambda f: np.save(f, arr), fsync=fsync)

    def fsync_dir(self, directory: str) -> None:
        """Durably record a directory's entries (the renames above)."""
        try:
            fd = os.open(directory, os.O_RDONLY)
        except OSError:
            return  # a target without directory fds; the rename is still atomic
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def fsync_file(self, path: str) -> None:
        def _sync() -> None:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)

        self.call(_sync, describe=f"fsync {os.path.basename(path)}")


__all__ = ["RetryingWriter", "RetryBudgetExceeded", "TRANSIENT_ERRORS", "backoff_delay"]
