"""MessagePack for the subset a checkpoint's ``state.msgpack`` uses: maps,
arrays, str, bool, nil, ints and floats.

The reference writes ``state.msgpack`` with the ``msgpack`` package
(``deepspeed_tpu/checkpoint/serialization.py``), which the port does not
import. :func:`packb` gives the bytes ``msgpack.packb`` (msgpack 1.x,
``use_bin_type=True``) gives for the same object: the smallest encoding of
each int (positive fixint, uint8-64, negative fixint, int8-64), floats as
float64, str as fixstr / str8 / str16 / str32, lists and tuples as
fixarray / array16 / array32, dicts in insertion order as fixmap / map16 /
map32. :func:`unpackb` reads every encoding of the subset (float32 too) and
returns lists for arrays, as ``msgpack.unpackb`` does; its decoder lives in
``utils/zero_to_fp32.py``, which every tag carries and which must run
without the port.
"""

from __future__ import annotations

import struct
from typing import Any

from ..utils.zero_to_fp32 import unpack_msgpack

__all__ = ["packb", "unpackb"]


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xFF)  # negative fixint
    elif n >= 0:
        for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit msgpack's 64 bits")
    else:
        for tag, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, tags, out: bytearray) -> None:
    """The header of a str / array / map of ``n`` entries: a fix byte, else
    the first of ``tags`` ((tag, struct format, limit), ...) that holds n."""
    if n < fix_max:
        out.append(fix | n)
        return
    for tag, fmt, top in tags:
        if n < top:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


_STR_TAGS = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_ARRAY_TAGS = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP_TAGS = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, _STR_TAGS, out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, _ARRAY_TAGS, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, _MAP_TAGS, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def unpackb(data: bytes) -> Any:
    buf = bytes(data)
    try:
        obj, pos = unpack_msgpack(buf, 0)
    except (IndexError, struct.error) as e:
        raise ValueError(f"msgpack data truncated: {e}") from e
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} bytes of extra data")
    return obj
