"""The checksums a checkpoint manifest may record (counterpart of the
checksum part of ``deepspeed_tpu/resilience/fingerprint.py``).

A manifest names its algorithm, so each package verifies the other's tags
whatever either one prefers. The reference prefers CRC-32C (Castagnoli)
when a C implementation of it is importable and zlib's CRC-32 otherwise.
The port imports no CRC-32C package, so it writes ``crc32`` (zlib, C speed)
and keeps CRC-32C's table implementation to verify the reference's tags:
correct, but about 5 MB/s. ``DS_CHECKPOINT_CHECKSUM`` forces an algorithm,
as in the reference. The live-state fingerprints of the reference's module
are ROADMAP.md A11.
"""

from __future__ import annotations

import os
import zlib
from typing import List, Tuple

__all__ = ["CHECKSUMS", "crc32c", "preferred_checksum", "checksum_file"]


def _make_crc32c_table() -> List[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def crc32c(data: bytes, value: int = 0) -> int:
    """CRC-32C of ``data``, continuing from ``value``."""
    crc = value ^ 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _crc32(data: bytes, value: int = 0) -> int:
    return zlib.crc32(data, value) & 0xFFFFFFFF


#: every algorithm a manifest may record
CHECKSUMS = {"crc32c": crc32c, "crc32": _crc32}


def preferred_checksum() -> str:
    """``crc32``, the reference's choice where no C CRC-32C is importable,
    unless ``DS_CHECKPOINT_CHECKSUM`` names another."""
    forced = os.environ.get("DS_CHECKPOINT_CHECKSUM", "").strip().lower()
    if forced:
        if forced not in CHECKSUMS:
            raise ValueError(f"DS_CHECKPOINT_CHECKSUM={forced!r}; known: {sorted(CHECKSUMS)}")
        return forced
    return "crc32"


def checksum_file(path: str, algo: str, chunk_bytes: int = 4 << 20) -> Tuple[int, int]:
    """(checksum, byte size) of a file, streamed."""
    fn = CHECKSUMS[algo]
    crc = 0
    n = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            crc = fn(chunk, crc)
            n += len(chunk)
    return crc, n
