"""NVMe swapping of the host optimizer state, ZeRO-Infinity's (counterpart of
``deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py``).

Each leaf's fp32 (master, m, v) lives in three files under the store's
directory, ``leaf_<i>_master.bin``, ``leaf_<i>_m.bin`` and ``leaf_<i>_v.bin``,
each the raw native-endian fp32 bytes of the leaf in C order: the JAX
package's layout, so a store one package writes the other reads. The
optimizer loop reads leaf i+1 and writes leaf i-1 back on the asynchronous
I/O pool (:mod:`...ops.aio`) while it steps leaf i, so host RAM holds a
window of leaves and the whole state sits on disk.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from ...ops.aio import AsyncIOHandle
from ...utils.logging import log_dist

_STREAMS = ("master", "m", "v")


class NVMeLeafStore:
    """Per-leaf (master, m, v) triples on disk with pipelined prefetch."""

    def __init__(self, path: str, aio_threads: int = 4):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.aio = AsyncIOHandle(num_threads=aio_threads)
        self.shapes: List[Tuple[int, ...]] = []
        # leaf -> {stream: (buffer, request id)}
        self._inflight_reads: Dict[int, Dict[str, Tuple[np.ndarray, int]]] = {}
        # buffers being written back, alive until the drain
        self._inflight_writes: List[np.ndarray] = []
        log_dist(f"NVMe optimizer store at {path} ({self.aio.num_threads} aio threads)")

    def _file(self, i: int, stream: str) -> str:
        return os.path.join(self.path, f"leaf_{i}_{stream}.bin")

    def write_init(self, leaves: List[np.ndarray]) -> None:
        """Write (master, zeros, zeros) for every leaf; blocking."""
        self.shapes = [tuple(leaf.shape) for leaf in leaves]
        zeros: Dict[Tuple[int, ...], np.ndarray] = {}
        for i, master in enumerate(leaves):
            self._write_now(self._file(i, "master"), np.ascontiguousarray(master, np.float32))
            z = zeros.setdefault(master.shape, np.zeros(master.shape, np.float32))
            for stream in ("m", "v"):
                self._write_now(self._file(i, stream), z)

    def _write_now(self, path: str, buf: np.ndarray) -> None:
        rc = self.aio.wait(self.aio.pwrite(path, buf))
        if rc != 0:
            raise IOError(f"aio write of {path} failed: {rc}")

    @property
    def num_leaves(self) -> int:
        return len(self.shapes)

    def prefetch(self, i: int) -> None:
        """Start the reads of leaf ``i``'s three streams."""
        if i in self._inflight_reads or not 0 <= i < self.num_leaves:
            return
        entry = {}
        for stream in _STREAMS:
            buf = np.empty(self.shapes[i], np.float32)
            entry[stream] = (buf, self.aio.pread(self._file(i, stream), buf))
        self._inflight_reads[i] = entry

    def get(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Leaf ``i``'s (master, m, v), prefetched or not; blocking."""
        self.prefetch(i)
        entry = self._inflight_reads.pop(i)
        out = []
        for stream in _STREAMS:
            buf, rid = entry[stream]
            rc = self.aio.wait(rid)
            if rc != 0:
                raise IOError(f"aio read failed for leaf {i}/{stream}: {rc}")
            out.append(buf)
        return tuple(out)

    def writeback(self, i: int, master: np.ndarray, m: np.ndarray, v: np.ndarray) -> None:
        """Asynchronous write-back; the buffers are kept until :meth:`drain`."""
        for stream, buf in zip(_STREAMS, (master, m, v)):
            self.aio.pwrite(self._file(i, stream), buf)
            self._inflight_writes.append(buf)

    def drain(self) -> None:
        self.aio.drain()
        self._inflight_writes.clear()

    def read_all(self) -> Dict[str, np.ndarray]:
        """Every leaf as ``master_<i>`` / ``m_<i>`` / ``v_<i>``."""
        self.drain()
        out = {}
        for i in range(self.num_leaves):
            out[f"master_{i}"], out[f"m_{i}"], out[f"v_{i}"] = self.get(i)
        return out

    def write_all(self, d: Dict[str, np.ndarray]) -> None:
        self.drain()
        for i in range(self.num_leaves):
            self.writeback(i, *(np.ascontiguousarray(d[f"{s}_{i}"], np.float32)
                                for s in _STREAMS))
        self.drain()
