"""Quantized collectives: block-int8/int4 wire formats for ZeRO traffic
(counterpart of ``deepspeed_tpu/comm/quantized.py``).

- Primitives: :func:`quantize_blockwise` / :func:`dequantize_blockwise`,
  per-block affine quantization (scale and zero-point per block of the
  trailing dimension, edge-padded to a whole block), 8-bit or packed 4-bit
  payloads (low nibble first), optional stochastic rounding from a
  ``torch.Generator``; their numpy mirrors for the host; the error-feedback
  step. Deterministic rounding is the reference's bit for bit: the same fp32
  operations in the same order, round half to even.
- Collectives over the :mod:`.comm` facade: :func:`qall_gather`,
  :func:`qreduce_scatter` (dequantize, then reduce in fp32: only the wire is
  int) and :func:`qall_to_all`.
- Autograd functions: :func:`quantized_reshard` gathers a leaf's shards as
  int payloads and dequantizes them (the stage-3 gather of
  ``runtime/zero/gather.py``); its backward is straight through the
  quantizer and mean-reduces the cotangent back to the shards, which is what
  the GSPMD-inserted collectives do in the reference.
  :func:`quantized_matmul_reshard` feeds the payload straight into the
  dequant-fused product (kernel B8, ``ops/cuda/dequant_matmul.py``), keeps
  the payload as the only weight residual, and recomputes the dequantized
  weight for ``d_h`` in the backward; ``d_w`` passes straight through.

Every quantized op records its logical bytes (what full precision would
move) and wire bytes (payload plus per-block scales and zero-points) in the
facade's :class:`~.comm.CommsLogger` and in
:data:`~.runtime_accounting.wire_ledger`, once per executed call.

Wire format per block of ``B`` elements: ``B`` bytes (int8) or ``B/2``
(int4) of payload, a 4-byte fp32 scale and a 4-byte fp32 zero-point: 3.88x
less than fp32 at B = 256.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..ops.cuda import dequant_matmul as dqm
from . import comm
from .runtime_accounting import wire_ledger

DEFAULT_BLOCK = 256
SUPPORTED_BITS = (4, 8)


# --------------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class QuantizedCommConfig:
    """Resolved quantized-collective knobs (from the ``zero_optimization`` block)."""

    weights: bool = False    # zero_quantized_weights: stage-3 parameter gathers
    gradients: bool = False  # zero_quantized_gradients: the dp gradient exchange
    bits: int = 8
    block_size: int = DEFAULT_BLOCK
    stochastic: bool = False
    error_feedback: bool = False

    def __post_init__(self):
        if self.bits not in SUPPORTED_BITS:
            raise ValueError(f"zero_quantize_bits must be one of {SUPPORTED_BITS}, "
                             f"got {self.bits}")
        if self.block_size < 8 or self.block_size % 2:
            raise ValueError(f"zero_quantize_block_size must be an even int >= 8, "
                             f"got {self.block_size}")

    @classmethod
    def from_zero_config(cls, zero_cfg: Any) -> "QuantizedCommConfig":
        g = lambda k, d: getattr(zero_cfg, k, d)  # noqa: E731
        return cls(weights=bool(g("zero_quantized_weights", False)),
                   gradients=bool(g("zero_quantized_gradients", False)),
                   bits=int(g("zero_quantize_bits", 8)),
                   block_size=int(g("zero_quantize_block_size", DEFAULT_BLOCK)),
                   stochastic=bool(g("zero_quantize_stochastic", False)),
                   error_feedback=bool(g("zero_quantize_error_feedback", False)))


# --------------------------------------------------------------------------- accounting
def _record(op_name: str, logical_bytes: int, wire_bytes: int) -> None:
    comm.comms_logger.record(op_name, logical_bytes, wire_bytes=wire_bytes)
    wire_ledger.record(op_name, logical_bytes, wire_bytes)


def _payload_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------- primitives
def effective_block(n_last: int, block_size: int) -> int:
    """Block size used for a trailing dim of ``n_last``: the requested size,
    shrunk for short rows so that padding never dominates, and kept even so
    that int4 packing stays byte-aligned."""
    eff = min(int(block_size), int(n_last) + (int(n_last) % 2))
    return max(eff, 2)


def quantization_shrinks(n_last: int, bits: int, block_size: int,
                         logical_itemsize: int) -> bool:
    """Whether the quantized wire (payload plus per-block scale and
    zero-point) is smaller than full precision for this row length."""
    eff = effective_block(n_last, block_size)
    return bits / 8.0 + 8.0 / eff < float(logical_itemsize)


def _pad_last(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % multiple
    if pad == 0:
        return x
    # edge padding keeps the tail block's [min, max] range tight
    return torch.cat([x, x[..., -1:].expand(*x.shape[:-1], pad)], dim=-1)


def quantize_blockwise(x: torch.Tensor, bits: int = 8, block_size: int = DEFAULT_BLOCK,
                       stochastic: bool = False, generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block affine quantization over trailing-dimension blocks.

    Returns ``(q, scale, zero_point)``: ``q`` uint8 ``[..., n_pad]`` (8-bit)
    or ``[..., n_pad/2]`` (4-bit, element 2j in the low nibble of byte j);
    ``scale`` / ``zero_point`` fp32 ``[..., n_blocks]``, with
    ``x_hat = q * scale + zero_point`` per block. ``stochastic=True`` rounds
    ``floor(v + u)`` with ``u ~ U[0, 1)`` from ``generator`` (unbiased); it
    gives other bits than the reference's ``jax.random`` draws."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    levels = (1 << bits) - 1
    block_size = effective_block(x.shape[-1], block_size)
    x32 = _pad_last(x.float(), block_size)
    lead = tuple(x32.shape[:-1])
    nb = x32.shape[-1] // block_size
    xb = x32.reshape(lead + (nb, block_size))
    mn = xb.amin(dim=-1)
    mx = xb.amax(dim=-1)
    scale = torch.clamp_min((mx - mn) / levels, 1e-12)
    v = (xb - mn[..., None]) / scale[..., None]
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding requires a torch.Generator")
        v = torch.floor(v + torch.rand(v.shape, generator=generator, device=v.device))
    else:
        v = torch.round(v)  # half to even, as jnp.round
    q = v.clamp(0, levels).to(torch.uint8).reshape(lead + (nb * block_size,))
    if bits == 4:
        q = q[..., 0::2] | (q[..., 1::2] << 4)
    return q, scale, mn


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor,
                         bits: int = 8, block_size: int = DEFAULT_BLOCK,
                         orig_size: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (fp32, trailing padding trimmed
    to ``orig_size``). The block extent comes from the payload and scale
    shapes; ``block_size`` is accepted for signature symmetry."""
    del block_size
    lead = tuple(q.shape[:-1])
    if bits == 4:
        q = torch.stack([q & 0xF, q >> 4], dim=-1).reshape(lead + (q.shape[-1] * 2,))
    nb = scale.shape[-1]
    block = q.shape[-1] // nb
    xb = q.reshape(lead + (nb, block)).float()
    x = (xb * scale[..., None] + zero_point[..., None]).reshape(lead + (nb * block,))
    if orig_size is not None and orig_size != x.shape[-1]:
        x = x[..., :orig_size]
    return x


# numpy mirrors of the pair: the host side (GatheredParameters(quantized=True)
# dequantizes fetched payloads with them), with the same effective block,
# edge padding and round-half-even
def np_quantize_blockwise(x: np.ndarray, bits: int = 8, block_size: int = DEFAULT_BLOCK
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host :func:`quantize_blockwise` (deterministic rounding only)."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    levels = (1 << bits) - 1
    block_size = effective_block(x.shape[-1], block_size)
    x32 = np.asarray(x, np.float32)
    pad = (-x32.shape[-1]) % block_size
    if pad:
        x32 = np.pad(x32, [(0, 0)] * (x32.ndim - 1) + [(0, pad)], mode="edge")
    lead = x32.shape[:-1]
    nb = x32.shape[-1] // block_size
    xb = x32.reshape(lead + (nb, block_size))
    mn = np.min(xb, axis=-1).astype(np.float32)
    mx = np.max(xb, axis=-1).astype(np.float32)
    scale = np.maximum((mx - mn) / levels, np.float32(1e-12))
    v = (xb - mn[..., None]) / scale[..., None]
    q = np.clip(np.round(v), 0, levels).astype(np.uint8).reshape(lead + (nb * block_size,))
    if bits == 4:
        q = (q[..., 0::2] | (q[..., 1::2] << 4)).astype(np.uint8)
    return q, scale, mn


def np_dequantize_blockwise(q: np.ndarray, scale: np.ndarray, zero_point: np.ndarray,
                            bits: int = 8, orig_size: Optional[int] = None) -> np.ndarray:
    """Host :func:`dequantize_blockwise` (fp32, trimmed to ``orig_size``)."""
    lead = q.shape[:-1]
    if bits == 4:
        q = np.stack([q & 0xF, q >> 4], axis=-1).reshape(lead + (q.shape[-1] * 2,))
    nb = scale.shape[-1]
    block = q.shape[-1] // nb
    xb = q.reshape(lead + (nb, block)).astype(np.float32)
    x = (xb * np.asarray(scale, np.float32)[..., None]
         + np.asarray(zero_point, np.float32)[..., None]).reshape(lead + (nb * block,))
    if orig_size is not None and orig_size != x.shape[-1]:
        x = x[..., :orig_size]
    return np.ascontiguousarray(x)


def error_feedback_step(buf, quantize_fn, dequantize_fn):
    """Compress ``buf`` and keep what the wire format lost: returns
    ``(payload, new_residual)``; the caller folds the residual into the next
    step's ``buf``."""
    payload = quantize_fn(buf)
    return payload, buf - dequantize_fn(payload)


def wire_bytes_per_element(bits: int, block_size: int) -> float:
    """Wire bytes per element (payload plus amortised scale and zero-point)."""
    return bits / 8.0 + 8.0 / block_size


# --------------------------------------------------------------------------- collectives
def qall_gather(x: torch.Tensor, group=None, axis: int = 0, tiled: bool = True, bits: int = 8,
                block_size: int = DEFAULT_BLOCK, op_name: str = "qall_gather") -> torch.Tensor:
    """Quantized all-gather, shaped like :func:`.comm.all_gather`: each rank's
    ``x`` travels as int blocks with their scales and is dequantized on arrival."""
    q, s, z = quantize_blockwise(x, bits=bits, block_size=block_size)
    _record(f"{op_name}[{comm._name(group)}]", _payload_bytes(x), _payload_bytes(q, s, z))
    Q, S, Z = (comm.all_gather(t, group, axis=0, tiled=False) for t in (q, s, z))
    deq = dequantize_blockwise(Q, S, Z, bits=bits, orig_size=x.shape[-1]).to(x.dtype)
    stacked = deq.movedim(0, axis)  # [W, *x.shape] with the world dim at axis
    if not tiled:
        return stacked
    shape = list(x.shape)
    shape[axis] *= deq.shape[0]
    return stacked.reshape(shape)


def qreduce_scatter(x: torch.Tensor, group=None, axis: int = 0, bits: int = 8,
                    block_size: int = DEFAULT_BLOCK, stochastic: bool = False,
                    generator: Optional[torch.Generator] = None,
                    residual: Optional[torch.Tensor] = None, mean: bool = False,
                    op_name: str = "qreduce_scatter"):
    """Quantized reduce-scatter, shaped like :func:`.comm.reduce_scatter`.

    The ZeRO++ gradient exchange: split the fp32 buffer into W chunks along
    ``axis``, quantize each, all-to-all so rank i receives every rank's chunk
    i, dequantize and sum in fp32. ``residual``: a same-shaped fp32
    error-feedback buffer folded into ``x`` first; the call then returns
    ``(result, new_residual)``. ``mean`` divides by W. Stochastic rounding
    draws from ``generator``, which each rank seeds for itself."""
    W = comm.get_world_size(group)
    buf = x.float()
    if residual is not None:
        buf = buf + residual
    xm = buf.movedim(axis, 0)
    if xm.shape[0] % W:
        raise ValueError(f"qreduce_scatter: dim {axis} extent {xm.shape[0]} not divisible "
                         f"by the world size {W}")
    chunks = xm.reshape((W, xm.shape[0] // W) + tuple(xm.shape[1:]))
    q, s, z = quantize_blockwise(chunks, bits=bits, block_size=block_size,
                                 stochastic=stochastic, generator=generator)
    _record(f"{op_name}[{comm._name(group)}]", _payload_bytes(x), _payload_bytes(q, s, z))
    recv = [comm.all_to_all(t, group, split_axis=0, concat_axis=0) for t in (q, s, z)]
    deq = dequantize_blockwise(*recv, bits=bits, orig_size=chunks.shape[-1])
    out = deq.sum(dim=0)
    if mean:
        out = out / W
    out = out.movedim(0, axis).to(x.dtype)
    if residual is None:
        return out
    sent = dequantize_blockwise(q, s, z, bits=bits, orig_size=chunks.shape[-1])
    return out, buf - sent.reshape(xm.shape).movedim(0, axis)


def qall_to_all(x: torch.Tensor, group=None, split_axis: int = 0, concat_axis: int = 0,
                bits: int = 8, block_size: int = DEFAULT_BLOCK,
                op_name: str = "qall_to_all") -> torch.Tensor:
    """Quantized all-to-all, shaped like :func:`.comm.all_to_all`. Neither
    axis may be the trailing one: blocks live there."""
    last = x.dim() - 1
    if split_axis % x.dim() == last or concat_axis % x.dim() == last:
        raise ValueError("qall_to_all: split/concat over the trailing dimension would cut "
                         "quantization blocks; move features to the last axis")
    q, s, z = quantize_blockwise(x, bits=bits, block_size=block_size)
    _record(f"{op_name}[{comm._name(group)}]", _payload_bytes(x), _payload_bytes(q, s, z))
    Q, S, Z = (comm.all_to_all(t, group, split_axis=split_axis, concat_axis=concat_axis)
               for t in (q, s, z))
    return dequantize_blockwise(Q, S, Z, bits=bits, orig_size=x.shape[-1]).to(x.dtype)


# --------------------------------------------------------------------------- autograd
def shard_grad(g: torch.Tensor, dim: Optional[int], group=None) -> torch.Tensor:
    """The cotangent of a gathered leaf, mean-reduced back to this rank's
    shard: a reduce-scatter along ``dim`` over W, or for a leaf every rank
    holds whole (``dim`` None) an all-reduce mean. The identity at world 1."""
    W = comm.get_world_size(group)
    if W == 1:
        return g
    if dim is None:
        return comm.all_reduce(g, group, op="mean")
    return comm.reduce_scatter(g, group, axis=dim) / W


class _QuantizedReshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, bits, block_size, op_name):
        ctx.dim, ctx.group = dim, group
        W = comm.get_world_size(group) if dim is not None else 1
        if x.dim() == 0 or not quantization_shrinks(x.shape[-1], bits, block_size,
                                                    x.element_size()):
            # short rows: the per-block scale and zero-point would inflate the
            # wire, so the leaf travels at full precision
            return x if dim is None else comm.all_gather(x, group, axis=dim)
        if dim is not None and dim % x.dim() == x.dim() - 1:
            raise ValueError("quantized_reshard: gathering along the trailing dim would "
                             "cut quantization blocks")
        q, s, z = quantize_blockwise(x, bits=bits, block_size=block_size)
        _record(f"{op_name}(dim={dim})", W * _payload_bytes(x), W * _payload_bytes(q, s, z))
        if dim is not None:
            q, s, z = (comm.all_gather(t, group, axis=dim) for t in (q, s, z))
        return dequantize_blockwise(q, s, z, bits=bits, orig_size=x.shape[-1]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return shard_grad(g, ctx.dim, ctx.group), None, None, None, None, None


def quantized_reshard(x: torch.Tensor, dim: Optional[int] = None, group=None, bits: int = 8,
                      block_size: int = DEFAULT_BLOCK, op_name: str = "qreshard"
                      ) -> torch.Tensor:
    """Gather ``x``'s shards along ``dim`` over ``group`` with an int wire
    (``dim`` None: ``x`` is whole on every rank and is only quantized and
    dequantized). Each rank quantizes its own shard, so ``dim`` must not be
    the trailing one and the values do not depend on the world size. Leaves
    whose rows are too short for quantization to shrink them travel at full
    precision. Backward: straight through the quantizer, mean-reduced to the
    shards (:func:`shard_grad`)."""
    return _QuantizedReshard.apply(x, dim, group, bits, block_size, op_name)


class _QuantizedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, w, bits, block_size, op_name):
        F = w.shape[1]
        ctx.bits, ctx.F, ctx.wdtype = bits, F, w.dtype
        if not quantization_shrinks(F, bits, block_size, w.element_size()):
            ctx.quantized = False
            ctx.save_for_backward(h2, w)
            return h2 @ w.to(h2.dtype)
        q, s, z = quantize_blockwise(w, bits=bits, block_size=block_size)
        _record(f"{op_name}(dim=None)", _payload_bytes(w), _payload_bytes(q, s, z))
        ctx.quantized = True
        # the int payload is the only weight residual kept for the backward
        ctx.save_for_backward(h2, q, s, z)
        return dqm.dequant_matmul(h2.float(), q, s, z, orig_size=F, bits=bits).to(h2.dtype)

    @staticmethod
    def backward(ctx, g):
        h2, *wres = ctx.saved_tensors
        g2 = g.float()
        d_h = d_w = None
        if ctx.needs_input_grad[0]:
            w_hat = (dequantize_blockwise(*wres, bits=ctx.bits, orig_size=ctx.F)
                     if ctx.quantized else wres[0].float())
            d_h = (g2 @ w_hat.t()).to(h2.dtype)
        if ctx.needs_input_grad[1]:
            d_w = (h2.float().t() @ g2).to(ctx.wdtype)  # straight through the quantizer
        return d_h, d_w, None, None, None


def quantized_matmul_reshard(h: torch.Tensor, w: torch.Tensor, bits: int = 8,
                             block_size: int = DEFAULT_BLOCK,
                             op_name: str = "qmatmul_reshard") -> torch.Tensor:
    """``h @ w`` with ``w`` consumed as its int payload, never as a
    dequantized copy: quantize, then the dequant-fused product B8 on fp32
    ``h``, cast back to ``h``'s dtype. ``h`` [..., D], ``w`` [D, F] whole on
    this rank. Backward: ``d_h = g @ w_hat^T`` in fp32 from the saved payload,
    ``d_w = h^T @ g`` straight through the quantizer. A ``w`` whose rows are
    too short for quantization to shrink it takes a plain product."""
    lead = h.shape[:-1]
    out = _QuantizedMatmul.apply(h.reshape(-1, h.shape[-1]), w, bits, block_size, op_name)
    return out.reshape(*lead, w.shape[1])


__all__ = [
    "QuantizedCommConfig", "effective_block", "quantization_shrinks", "quantize_blockwise",
    "dequantize_blockwise", "np_quantize_blockwise", "np_dequantize_blockwise",
    "error_feedback_step", "qall_gather", "qreduce_scatter", "qall_to_all",
    "quantized_reshard", "quantized_matmul_reshard", "shard_grad", "wire_bytes_per_element",
    "DEFAULT_BLOCK", "SUPPORTED_BITS",
]
