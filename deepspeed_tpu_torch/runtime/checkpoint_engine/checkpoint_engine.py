"""Checkpoint engines (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``):
``create(tag)``, then ``save`` / ``save_array``, then ``commit(tag)``, the
durability point. The native engine writes synchronously; the async engine
hands the host copies to background writer threads, so the caller goes on
while they write, and ``commit`` waits for them and raises if any failed.
The ``"checkpoint"`` config block picks one: ``{"checkpoint_engine":
"native" | "async", "writers": N}``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...resilience.retry import RetryingWriter
from ...utils.logging import log_dist, logger


class CheckpointWriteError(IOError):
    """A checkpoint write failed for good; the tag must not be committed."""


class CheckpointEngine:
    """The interface (the reference's ``CheckpointEngine``)."""

    def __init__(self, config_params=None):
        self.config = config_params

    def create(self, tag: str) -> None:
        """Start a checkpoint under ``tag``."""

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def commit(self, tag: str) -> bool:
        """Durability point: when this returns, every write of the tag is done."""
        return True


class NativeCheckpointEngine(CheckpointEngine):
    """Synchronous writer. Every write is atomic (tmp + ``os.replace``) and
    retried with backoff (:class:`~..resilience.retry.RetryingWriter`)."""

    def __init__(self, config_params=None):
        super().__init__(config_params)
        self._writer = RetryingWriter()

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._writer.atomic_write(path, lambda f: np.savez(f, **state_dict), fsync=False,
                                  describe=f"save {os.path.basename(path)}")

    def save_array(self, path: str, arr: np.ndarray) -> None:
        """One ``.npy`` (the serialization layer's file granularity)."""
        self._writer.write_array(path, arr)

    def load(self, path: str, map_location=None) -> Dict[str, np.ndarray]:
        with np.load(path, allow_pickle=False) as d:
            return dict(d)


class AsyncCheckpointEngine(CheckpointEngine):
    """Background writer threads: ``save`` and ``save_array`` enqueue and
    return; ``commit`` blocks until everything queued is written."""

    def __init__(self, config_params=None, writers: int = 2):
        super().__init__(config_params)
        self._q: "queue.Queue[Optional[Tuple[Dict, str]]]" = queue.Queue()
        self._errors: List[str] = []
        self._errors_lock = threading.Lock()
        self._inner = NativeCheckpointEngine()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(writers)]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            sd, path = item
            try:
                if set(sd) == {"__single__"}:
                    self._inner.save_array(path, sd["__single__"])
                else:
                    self._inner.save(sd, path)
            except Exception as e:  # recorded, and raised by commit()
                with self._errors_lock:
                    self._errors.append(f"{path}: {e}")
            finally:
                self._q.task_done()

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        # a snapshot: the caller may change its arrays once this returns
        snap = {k: np.array(v, copy=True) for k, v in state_dict.items()}
        self._q.put((snap, path))

    def save_array(self, path: str, arr: np.ndarray) -> None:
        # the serialization layer hands over arrays that own their memory
        self._q.put(({"__single__": arr}, path))

    def _raise_errors(self) -> None:
        with self._errors_lock:
            errs, self._errors = self._errors, []
        if errs:
            raise CheckpointWriteError(f"async checkpoint writes failed: {errs}")

    def load(self, path: str, map_location=None) -> Dict[str, np.ndarray]:
        self._q.join()
        self._raise_errors()
        return self._inner.load(path)

    def commit(self, tag: str) -> bool:
        """Durability barrier. Raises, never logs, when a background write
        failed: the COMMIT marker written after this call would otherwise
        bless a partial tag."""
        self._q.join()
        self._raise_errors()
        log_dist(f"checkpoint tag {tag} committed (async)")
        return True

    def shutdown(self) -> None:
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=10)


def get_checkpoint_engine(ds_config) -> CheckpointEngine:
    """The engine the ``"checkpoint"`` block of a config (a dict or a
    ``DeepSpeedConfig``) selects."""
    block = {}
    if ds_config is not None:
        block = (ds_config.get("checkpoint", {}) if isinstance(ds_config, dict)
                 else getattr(ds_config, "checkpoint", {}) or {})
    kind = str(block.get("checkpoint_engine", "native")).lower()
    if kind in ("async", "nebula"):
        return AsyncCheckpointEngine(block, writers=int(block.get("writers", 2)))
    if kind in ("native", "torch", ""):
        return NativeCheckpointEngine(block)
    logger.warning(f"unknown checkpoint_engine {kind!r}; using native")
    return NativeCheckpointEngine(block)
