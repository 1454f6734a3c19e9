"""The int4 nibble layout shared by quantized weights and quantized KV pages.

Counterpart of ``pack_int4`` / ``unpack_int4`` in
``deepspeed_tpu/ops/pallas/int8_matmul.py``: the half-split layout, where
byte j of a packed last axis holds value j in its low nibble and value
j + F/2 in its high nibble. The int8 and int4 weight-matmul kernels of that
file (``int8_matmul``, ``int4_matmul``) are ROADMAP.md A8 and not ported yet.
"""

from __future__ import annotations

import torch


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (integers in [-8, 7], in any integer or float dtype)
    two per byte along the last axis, half-split: byte j holds ``q[..., j]``
    in its low nibble and ``q[..., j + F/2]`` in its high nibble. Returns int8
    ``[..., F/2]``."""
    F = q.shape[-1]
    if F % 2:
        raise ValueError(f"int4 packing needs an even last dim, got {F}")
    lo = q[..., :F // 2].to(torch.int32) & 0xF
    hi = q[..., F // 2:].to(torch.int32)
    return (lo | (hi << 4)).to(torch.int8)


def _unpack_nibble(t: torch.Tensor, high: bool) -> torch.Tensor:
    """Sign-extended int4 from packed int32 (the xor-sub trick)."""
    nib = ((t >> 4) if high else t) & 0xF
    return (nib ^ 8) - 8


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 ``[..., F/2]`` -> int8 ``[..., F]``."""
    t = q4.to(torch.int32)
    return torch.cat([_unpack_nibble(t, False), _unpack_nibble(t, True)],
                     dim=-1).to(torch.int8)
