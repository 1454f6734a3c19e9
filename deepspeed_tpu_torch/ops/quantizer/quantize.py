"""Group-wise weight quantization (counterpart of
``deepspeed_tpu/ops/quantizer/quantize.py``: ``quantize`` and
``dequantize``).

Symmetric group-wise quantization to ``bits`` with fp32 scales: the tensor is
flattened row-major and cut into ``num_groups`` contiguous runs; each run's
scale is ``absmax / qmax`` (1 for an all-zero run) and its values round half
to even and clip to ``[-qmax - 1, qmax]``. Any width up to 8 bits is stored
as int8. These are plain tensor ops on any device, as in the reference
(where XLA fuses them); the quantization-aware-training variants
(``fake_quant*``, ``annealed_bits``) are ROADMAP.md A3b.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _group(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    n = x.numel()
    if n % num_groups != 0:
        raise ValueError(f"size {n} not divisible into {num_groups} groups")
    return x.reshape(num_groups, n // num_groups)


def quantize(x: torch.Tensor, bits: int = 8, num_groups: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(q, scales)``: ``q`` int8 of ``x.shape``, ``scales`` fp32
    ``[num_groups]``."""
    g = _group(x.float(), num_groups)
    qmax = 2.0 ** (bits - 1) - 1.0
    absmax = g.abs().amax(dim=1, keepdim=True)
    scales = torch.where(absmax > 0, absmax / qmax, 1.0)
    q = torch.clamp(torch.round(g / scales), -qmax - 1, qmax).to(torch.int8)
    return q.reshape(x.shape), scales[:, 0]


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q`` (any shape) times its group's scale, in fp32, cast to ``dtype``."""
    g = _group(q.float(), scales.shape[0])
    return (g * scales.float()[:, None]).reshape(q.shape).to(dtype)
