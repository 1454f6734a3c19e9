"""Group-wise weight quantization (counterpart of
``deepspeed_tpu/ops/quantizer/quantize.py``: ``quantize`` and
``dequantize``, and the quantization-aware-training variants ``fake_quant``,
``fake_quant_dynamic`` and ``annealed_bits``).

Symmetric group-wise quantization to ``bits`` with fp32 scales: the tensor is
flattened row-major and cut into ``num_groups`` contiguous runs; each run's
scale is ``absmax / qmax`` (1 for an all-zero run) and its values round half
to even and clip to ``[-qmax - 1, qmax]``. Any width up to 8 bits is stored
as int8. These are plain tensor ops on any device, as in the reference
(where XLA fuses them). The fake-quant functions quantize and dequantize
in the forward and pass the gradient straight through to ``x``
(``torch.autograd.Function``s whose backward returns ``g``), as the
reference's ``custom_vjp``s do.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

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


def _fake_quant_dynamic(x: torch.Tensor, bits: Union[float, torch.Tensor],
                        num_groups: int) -> torch.Tensor:
    xf = x.float()
    if torch.is_tensor(bits) and bits.dim() == 1:  # one bit count a layer
        g = xf.reshape(x.shape[0], num_groups, -1)
        b = bits.to(device=x.device, dtype=torch.float32).reshape(-1, 1, 1)
    else:
        g = _group(xf, num_groups)
        b = torch.as_tensor(bits, dtype=torch.float32, device=x.device)
    qmax = 2.0 ** (b - 1.0) - 1.0
    absmax = g.abs().amax(dim=-1, keepdim=True)
    scales = torch.where(absmax > 0, absmax / qmax, 1.0)
    q = torch.clamp(torch.round(g / scales), -qmax - 1.0, qmax)
    return (q * scales).reshape(x.shape).to(x.dtype)


class _FakeQuantDynamic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits, num_groups):
        return _fake_quant_dynamic(x, bits, num_groups)

    @staticmethod
    def backward(ctx, g):
        return g, None, None  # straight through to x; the bits get no gradient


def fake_quant_dynamic(x: torch.Tensor, bits: Union[float, torch.Tensor],
                       num_groups: int = 1) -> torch.Tensor:
    """Fake-quant at a bit count that is a number, a 0-dim tensor, or a
    ``[L]`` tensor of one count per slice of ``x``'s leading dimension (MoQ's
    per-layer schedules): the count is arithmetic on the scale and clip
    bounds, so the anneal needs no other code path. Straight-through
    gradient to ``x``."""
    return _FakeQuantDynamic.apply(x, bits, num_groups)


def annealed_bits(step, start_bits: int, target_bits: int, period: int, factor=1.0):
    """The scheduled bit width at ``step`` (steps since the quantization
    onset): drop k (from 1) fires at ``period * (2 factor)**(k-1)``, each
    drop doubling the period stretched by the eigenvalue ``factor``.
    ``step`` and ``factor`` are numbers or host arrays (``factor`` [L] for
    per-layer schedules); the result is a CPU fp32 tensor of their broadcast
    shape.

    The drop count is the reference's ``1 + floor(log(t / period) /
    log(2 factor))``, made exact on the host: the float64 estimate is moved
    until ``period * (2 factor)**m <= t < period * (2 factor)**(m+1)``, so a
    drop lands on its documented step whatever a device's ``log`` rounds to
    (the reference's eager evaluation and its tests give these steps; under
    ``jit`` XLA multiplies by the reciprocal of ``log(2 factor)`` and puts a
    few exact drop points of factors 3 and 5 one step later)."""
    if target_bits >= start_bits:
        return torch.tensor(float(start_bits))
    t, f = np.broadcast_arrays(np.asarray(step, np.float64), np.asarray(factor, np.float64))
    base = 2.0 * f
    m = np.floor(np.log(np.maximum(t, 1.0) / period) / np.log(base))
    m = np.maximum(m, 0.0)
    for _ in range(2):  # the estimate is off by at most one
        m = np.where(period * base ** (m + 1) <= t, m + 1, m)
        m = np.where((m > 0) & (period * base ** m > t), m - 1, m)
    drops = np.where(t >= period, 1.0 + m, 0.0)
    bits = np.maximum(float(target_bits), start_bits - drops)
    return torch.from_numpy(np.asarray(bits, np.float32))


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits, num_groups):
        q, scales = quantize(x, bits=bits, num_groups=num_groups)
        return dequantize(q, scales, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None  # straight through


def fake_quant(x: torch.Tensor, bits: int = 8, num_groups: int = 1) -> torch.Tensor:
    """Quantize-dequantize at a fixed bit count with a straight-through
    gradient (quantization-aware training)."""
    return _FakeQuant.apply(x, bits, num_groups)
