"""Quantized-weight matrix products: the hand-written CUDA kernels, their
plain versions, and the int4 nibble layout.

Counterpart of ``deepspeed_tpu/ops/pallas/int8_matmul.py``:

- :func:`int8_matmul` (B6, the reference's ``_kernel``) and
  :func:`int4_matmul` (B7, ``_kernel4``): ``x @ W`` with ``W`` stored as
  int8, or nibble-packed int4, plus one fp32 scale per ``group_size``
  consecutive weights of the row-major flattened ``[D, F]`` weight. Both are
  ``deepspeed_tpu_torch/csrc/int8_matmul.cu``; its header says how it is
  split and what bounds it.
- :func:`pack_int4` / :func:`unpack_int4`: the half-split layout, where byte
  j of a packed last axis holds value j in its low nibble and value j + F/2
  in its high nibble (shared with the quantized KV pools).

Dispatch keeps the reference's shape rule: at most ``_MAX_M`` rows of ``x``
(decode) take the kernel on CUDA and the plain version on the CPU; a larger
``x`` (prefill) takes the reference's own route on any device, the layer's
weight dequantized to ``x.dtype`` and one ``torch.matmul``. The TPU tile
rules of the reference (``group % 128``, ``D % block_d``, ``F % block_f``)
are Mosaic layout constraints and do not carry over: every shape runs the
kernel. The kernels are inference-only and raise where autograd would
differentiate them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from .. import _build
from ..quantizer import dequantize
from .flash_attention import DTYPE_CODE

_MAX_M = 256  # the reference's bound: more rows take dequantize-then-matmul
_WARPS = 8  # warps of a block, each its own rows of a chunk (kWarps)
_MAX_CLUSTER = 8  # blocks of one cluster along D (kMaxCluster)

# kernel launches since import or the last reset to 0 (chip_smoke.py reads
# them to show that a main path went through the kernels): B6 and B7
int8_launches = 0
int4_launches = 0


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


# ------------------------------------------------------------------ plain versions
def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                    group_size: int = 64) -> torch.Tensor:
    """Plain PyTorch version of B6: flat-group dequantize in fp32 (each
    ``group_size`` run of the row-major flatten times its scale; runs may
    cross rows), an fp32 product, one cast to ``x.dtype`` (the Pallas
    kernel's arithmetic)."""
    return (x.float() @ dequantize(q, s.reshape(-1))).to(x.dtype)


def int4_matmul_ref(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                    group_size: int = 128) -> torch.Tensor:
    """Plain PyTorch version of B7: unpack, then :func:`int8_matmul_ref`."""
    return int8_matmul_ref(x, unpack_int4(q4), s, group_size)


# ------------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_quant_matmul.argtypes = [ptr, i64] + [ptr] * 3 + [i32] * 9 + [ptr]
    lib.ds_quant_matmul.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def split_plan(M: int, D: int, Fq: int, sms: int) -> Tuple[int, int, int]:
    """(lanes, chunk, cluster) of one launch. ``lanes`` (32, 16 or 8) lanes
    cover a row of a block's column tile of ``4 * lanes`` q bytes: narrower
    tiles until the grid, with clusters of 8, reaches a block for every
    second SM (more, narrower blocks measured slower on wide int4). D is
    then cut into ``cluster`` chunks of ``chunk`` rows, one block of a thread
    block cluster each: the cluster doubles, up to 8 blocks, while the grid
    is under two blocks per SM and each warp keeps a row. A pure function of
    the shapes, so a result is bitwise repeatable."""
    tm = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    m_tiles = math.ceil(M / tm)
    lanes = 32
    while lanes > 8 and 2 * math.ceil(Fq / (4 * lanes)) * m_tiles * _MAX_CLUSTER < sms:
        lanes //= 2
    base = math.ceil(Fq / (4 * lanes)) * m_tiles
    cluster = 1
    while (cluster < _MAX_CLUSTER and base * cluster < 2 * sms
           and math.ceil(D / (2 * cluster)) >= _WARPS):
        cluster *= 2
    return lanes, math.ceil(D / cluster), cluster


def _check(name: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, F: int,
           group_size: int) -> None:
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and q {tuple(q.shape)} do not make "
                         "[M, D] @ [D, ...]")
    if q.dtype != torch.int8:
        raise TypeError(f"{name}: q must be int8, got {q.dtype}")
    D = q.shape[0]
    if group_size < 1 or s.numel() * group_size != D * F:
        raise ValueError(f"{name}: {s.numel()} scales of group {group_size} do not cover "
                         f"the [{D}, {F}] weight")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"{name} is inference-only and has no backward: call it under "
                           "torch.no_grad() or on tensors that do not require grad")


def _launch(name: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, F: int,
            group_size: int, bits: int) -> torch.Tensor:
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"{name} kernel: x dtype {x.dtype}; expected float32, bfloat16 "
                        "or float16")
    if s.dtype != torch.float32:
        raise TypeError(f"{name} kernel: scales must be float32, got {s.dtype}")
    if not (x.device == q.device == s.device):
        raise ValueError(f"{name}: x, q and s on different devices")
    if x.stride(-1) != 1:
        x = x.contiguous()
    q, s = q.contiguous(), s.contiguous()
    M, D = x.shape
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lanes, chunk, cluster = split_plan(M, D, q.shape[1], _num_sms(index))
    out = torch.empty((M, F), dtype=x.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(index):
        status = lib.ds_quant_matmul(
            x.data_ptr(), x.stride(0), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, D, F,
            group_size, chunk, cluster, lanes, bits, DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(index).cuda_stream)
    _build.check(lib, status, name)
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                group_size: int = 64) -> torch.Tensor:
    """``x @ dequantize(q, s)`` without a dequantized weight.

    x [M, D] float; q int8 [D, F]; s fp32 scales (any shape, read flat) for
    the row-major ``group_size`` runs of the weight (the
    ``models.gpt.quantize_for_inference`` layout). Returns [M, F] in x's dtype."""
    global int8_launches
    F = q.shape[-1]
    _check("int8_matmul", x, q, s, F, group_size)
    if x.shape[0] > _MAX_M:
        return x @ dequantize(q, s.reshape(-1), x.dtype)
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, s, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    out = _launch("int8_matmul", x, q, s, F, group_size, 8)
    int8_launches += 1
    return out


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                group_size: int = 128) -> torch.Tensor:
    """``x @ dequantize(unpack_int4(q4), s)`` without an unpacked or
    dequantized weight.

    x [M, D] float; q4 int8 [D, F/2] in the :func:`pack_int4` layout; s fp32
    scales for the row-major ``group_size`` runs of the UNPACKED [D, F]
    weight. Returns [M, F] in x's dtype."""
    global int4_launches
    F = 2 * q4.shape[-1]
    _check("int4_matmul", x, q4, s, F, group_size)
    if x.shape[0] > _MAX_M:
        return x @ dequantize(unpack_int4(q4), s.reshape(-1), x.dtype)
    if x.device.type == "cpu":
        return int4_matmul_ref(x, q4, s, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    out = _launch("int4_matmul", x, q4, s, F, group_size, 4)
    int4_launches += 1
    return out
