"""The asynchronous file I/O handle over the host thread pool (counterpart of
``deepspeed_tpu/ops/aio/handle.py``).

``pread`` / ``pwrite`` submit a request on the pool of ``csrc/host/aio.cpp``
and return its id at once; :meth:`AsyncIOHandle.wait` blocks on one id
(0, or minus the errno), :meth:`AsyncIOHandle.drain` on all of them and
raises if a request nobody waited on failed. Buffers are C-contiguous numpy
arrays (a pinned tensor's ``.numpy()`` view among them) that must stay alive
until their request is waited on or drained. There is no synchronous
fallback: a build or load failure raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .. import _build


@functools.lru_cache(maxsize=None)
def aio_ops() -> ctypes.CDLL:
    """The loaded I/O pool library, built at its first use."""
    lib = _build.load_host("aio")
    if lib.ds_aio_version() != 1:
        raise _build.KernelBuildError("aio: library version is not 1")
    lib.ds_aio_create.restype = ctypes.c_void_p
    lib.ds_aio_create.argtypes = [ctypes.c_int]
    lib.ds_aio_destroy.restype = None
    lib.ds_aio_destroy.argtypes = [ctypes.c_void_p]
    lib.ds_aio_pread.restype = ctypes.c_int
    lib.ds_aio_pread.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int64]
    lib.ds_aio_pwrite.restype = ctypes.c_int
    lib.ds_aio_pwrite.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.ds_aio_wait.restype = ctypes.c_int
    lib.ds_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ds_aio_drain.restype = ctypes.c_int
    lib.ds_aio_drain.argtypes = [ctypes.c_void_p]
    return lib


def _buffer(buf: np.ndarray) -> ctypes.c_void_p:
    if not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be C-contiguous")
    return ctypes.c_void_p(buf.ctypes.data)


class AsyncIOHandle:
    """Submit asynchronous reads and writes of numpy buffers; wait on ids."""

    def __init__(self, num_threads: int = 4):
        self.num_threads = max(1, int(num_threads))
        self._lib = aio_ops()
        self._pool = self._lib.ds_aio_create(self.num_threads)

    def pread(self, path: str, buf: np.ndarray, offset: int = 0) -> int:
        """Read ``buf.nbytes`` bytes of ``path`` from ``offset`` into ``buf``."""
        if not buf.flags["WRITEABLE"]:
            raise ValueError("aio read into a read-only buffer")
        return self._lib.ds_aio_pread(self._pool, path.encode(), _buffer(buf), buf.nbytes,
                                      int(offset))

    def pwrite(self, path: str, buf: np.ndarray, offset: int = 0, fsync: bool = False) -> int:
        """Write ``buf`` to ``path`` at ``offset`` (the file is created if missing)."""
        return self._lib.ds_aio_pwrite(self._pool, path.encode(), _buffer(buf), buf.nbytes,
                                       int(offset), 1 if fsync else 0)

    def wait(self, request_id: int) -> int:
        """Block until the request ends: 0 on success, minus the errno on
        failure, -22 (EINVAL) for an id unknown or already waited on."""
        return self._lib.ds_aio_wait(self._pool, int(request_id))

    def drain(self) -> None:
        """Block until every submitted request ends; raise if one nobody
        waited on failed since the last drain."""
        rc = self._lib.ds_aio_drain(self._pool)
        if rc < 0:
            raise IOError(f"aio: {-rc} asynchronous request(s) failed before drain")

    def close(self) -> None:
        if self._pool is not None:
            self._lib.ds_aio_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown
            pass
