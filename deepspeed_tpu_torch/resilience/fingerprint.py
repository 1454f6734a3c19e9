"""Live-state fingerprints over the one checksum registry (counterpart of
the live-state part of ``deepspeed_tpu/resilience/fingerprint.py``).

The manifest stamps checkpoint files and :mod:`.integrity` stamps live
state (master and optimizer leaves, KV pages) with the same algorithms of
:data:`.checksum.CHECKSUMS`, so one algorithm name means one bit pattern
everywhere. The algorithm is :func:`.checksum.preferred_checksum`'s unless a
caller names one: ``crc32`` here (the reference prefers ``crc32c`` where a C
CRC-32C is importable), each forced by ``DS_CHECKPOINT_CHECKSUM``.

A tensor is fingerprinted over the raw bytes of its contiguous storage, on
whatever device it lives: the bytes are viewed as ``uint8`` there and only
the slice a block covers is copied to the host, so a budgeted scan moves
only the blocks it checks.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .checksum import CHECKSUMS, preferred_checksum

__all__ = ["DEFAULT_BLOCK_BYTES", "fingerprint_bytes", "fingerprint_array",
           "blockwise_fingerprints", "byte_view", "nbytes_of", "host_bytes"]

#: the default fingerprint block of live state, the reference's
DEFAULT_BLOCK_BYTES = 1 << 20


def fingerprint_bytes(data, algo: str = None) -> int:
    """Fingerprint one in-memory buffer (anything the buffer protocol covers)."""
    return CHECKSUMS[algo or preferred_checksum()](bytes(data))


def byte_view(arr):
    """The raw bytes of ``arr`` as a flat ``uint8`` view: of a torch tensor
    on its own device (contiguous storage, no copy when it already is), of
    anything else through numpy. Writing the view writes ``arr`` when
    ``arr`` is contiguous."""
    if hasattr(arr, "untyped_storage"):  # a torch tensor
        import torch

        return arr.detach().contiguous().reshape(-1).view(torch.uint8)
    return np.ascontiguousarray(np.asarray(arr)).reshape(-1).view(np.uint8)


def nbytes_of(arr) -> int:
    if hasattr(arr, "untyped_storage"):
        return int(arr.numel() * arr.element_size())
    return int(np.asarray(arr).nbytes)


def host_bytes(view, start: int = 0, stop: int = None) -> bytes:
    """The bytes ``[start, stop)`` of a :func:`byte_view`, the slice taken
    before the copy to the host."""
    part = view[start:stop]
    if hasattr(part, "untyped_storage"):
        part = part.cpu().numpy()
    return part.tobytes()


def fingerprint_array(arr, algo: str = None) -> int:
    """Fingerprint a tensor's or an array's raw bytes: the value, not the
    placement (a device tensor and its host copy print alike)."""
    return CHECKSUMS[algo or preferred_checksum()](host_bytes(byte_view(arr)))


def blockwise_fingerprints(arr, block_bytes: int = DEFAULT_BLOCK_BYTES,
                           algo: str = None) -> List[int]:
    """Per-block fingerprints of the raw bytes, in order. The split is
    positional over the flat byte view, so re-running with the same
    ``block_bytes`` compares block for block."""
    view = byte_view(arr)
    fn = CHECKSUMS[algo or preferred_checksum()]
    nbytes = nbytes_of(arr)
    if nbytes == 0:
        return [fn(b"")]
    step = max(1, int(block_bytes))
    return [fn(host_bytes(view, s, s + step)) for s in range(0, nbytes, step)]
