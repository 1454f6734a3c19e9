"""Quantized-weight matrix products: the hand-written CUDA kernels, their
plain versions, the route between them, and the int4 nibble layout.

Counterpart of ``deepspeed_tpu/ops/pallas/int8_matmul.py``:

- :func:`int8_matmul` (B6, the reference's ``_kernel``) and
  :func:`int4_matmul` (B7, ``_kernel4``): ``x @ W`` with ``W`` stored as
  int8, or nibble-packed int4, plus one fp32 scale per ``group_size``
  consecutive weights of the row-major flattened ``[D, F]`` weight. Three
  kernels compute it: ``deepspeed_tpu_torch/csrc/int8_matmul_decode.cu`` on
  the tensor cores at decode rows (1-8 rows of x in any float dtype, mma.sync
  over the weight streamed into registers), ``csrc/int8_matmul_tc.cu`` on the
  tensor cores at prefill and verify rows (9-256 rows: bf16 / fp16 x against
  hi + lo halves of the weight, fp32 x as three exact bf16 parts of x times
  the scales against the exact integers; the decode kernel computes every
  dtype that way), and ``csrc/int8_matmul.cu`` on the CUDA cores for the
  layouts neither takes (groups that cross rows or split a 64-column panel,
  D off 64-row steps; at decode rows also groups under 64); each header says
  how it is split and what bounds it.
- :func:`pack_int4` / :func:`unpack_int4`: the half-split layout, where byte
  j of a packed last axis holds value j in its low nibble and value j + F/2
  in its high nibble (shared with the quantized KV pools).

:func:`qmm_route` picks the route from the shapes alone. It keeps the
reference's shape rule: more than ``_MAX_M`` rows of ``x`` (a large prefill)
take the reference's own route on any device, the layer's weight
dequantized to ``x.dtype`` and one ``torch.matmul``. At most ``_MAX_M`` rows
take a kernel on CUDA and its plain version on the CPU: the decode kernel
for x of at most ``_TC_MIN_M`` rows in a layout it takes (groups of whole
64-column panels), the tensor-core kernel for more rows in a layout it takes
(fp32 x: whole 64-column panels inside a group), the CUDA-core kernel
otherwise. The TPU tile rules of the reference
(``group % 128``, ``D % block_d``, ``F % block_f``) are Mosaic layout
constraints and do not carry over: every shape runs a kernel. The kernels
are inference-only and raise where autograd would differentiate them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import _build
from ..quantizer import dequantize
from .dequant_matmul import split3
from .flash_attention import DTYPE_CODE

_MAX_M = 256  # the reference's bound: more rows take dequantize-then-matmul
_WARPS = 8  # warps of a block, each its own rows of a chunk (kWarps)
_MAX_CLUSTER = 8  # blocks of one cluster along D (kMaxCluster, both kernels)
# x with more rows than this takes the tensor-core kernel, with at most
# this many the decode kernel (mma's n8 side holds a decode step's 8 slots).
# On the H100 (chip_smoke.py phase 2, the kernels on the same inputs, cold
# L2) the 64-row tiles of the tensor-core kernel were 1.1-2.1x faster than
# the CUDA-core kernel already at 8 rows in bf16, while in fp32 the two
# split the 8 projection shapes of GPT-2-125M and gpt2-350m (0.87-1.68x);
# the decode kernel streams the weight through registers with no 64-row
# tile to fill.
_TC_MIN_M = 8
_TC_ROWS = 128  # rows of x a tensor-core block owns (64 for M <= 64)
_TC_STEP = 64  # rows of D a tensor-core step consumes (kStep)
_TC_COLS = 128  # output columns a tensor-core block owns (kCols)

_DEC_SLAB = 32  # rows of D a decode warp loads at once (kSlab)
_DEC_TILE = 64  # q bytes of a row a decode warp covers (kTileBytes)
_DEC_MAX_WARPS = 8  # warps of a decode block (kMaxWarps)

# kernel launches since import or the last reset to 0 (chip_smoke.py reads
# them to show that a main path went through the kernels): B6 and B7 on the
# CUDA cores, on the tensor cores at 9-256 rows, and at decode rows
int8_launches = 0
int4_launches = 0
int8_tc_launches = 0
int4_tc_launches = 0
int8_dec_launches = 0
int4_dec_launches = 0


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


def _panel_exponents(s: torch.Tensor, F: int, group_size: int, qmax: float) -> torch.Tensor:
    """fp16's power of two for each 64-column panel of a chunk's rows: the
    exponent e that puts ``qmax`` times the panel's largest scale in [2^14,
    2^15) (0 for a panel of zero scales), clamped to [-126, 126]."""
    col_s = s.abs().repeat_interleave(group_size, dim=1)[:, :F]  # [rows, F]
    top = col_s.amax(dim=0).reshape(F // 64, 64).amax(dim=1)
    _, ex = torch.frexp(qmax * top)  # qmax top = m 2^ex, m in [0.5, 1)
    return torch.where(top > 0, (15 - ex).clamp(-126, 126), torch.zeros_like(ex))


def qmatmul_split_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, group_size: int,
                      bits: int = 8, chunk: Optional[int] = None) -> torch.Tensor:
    """The tensor-core kernel's rounding, for the tests: the fp32 weight w =
    q s enters as hi = T(w) and lo = T(w - hi) of x's 16-bit dtype T, fp16's
    weights first times 2^e per 64-column panel and chunk of D
    (:func:`_panel_exponents`, with |q| at most 128 for int8 and 8 for
    int4); each ``chunk`` of D (all of it by default: a cluster of one)
    sums x_tile hi_tile + x_tile lo_tile in fp32 over 64-deep steps, in
    order, undoes its 2^e, and the chunks add in order before one rounding
    to T. ``q`` is int8 [D, F], or packed [D, F/2] for bits 4; needs F % 64
    == 0 and F % group_size == 0 (the kernel's layouts)."""
    w_q = unpack_int4(q) if bits == 4 else q
    D, F = w_q.shape
    w = dequantize(w_q, s.reshape(-1).float())
    s_rows = s.reshape(D, F // group_size).float()
    dtype, xf = x.dtype, x.float()
    chunk = chunk or D
    out = torch.zeros((x.shape[0], F), dtype=torch.float32, device=x.device)
    for d0 in range(0, D, chunk):
        wc = w[d0:d0 + chunk]
        e = torch.zeros(F // 64, dtype=torch.int32, device=x.device)
        if dtype == torch.float16:
            e = _panel_exponents(s_rows[d0:d0 + chunk], F, group_size, 128.0 if bits == 8 else 8.0)
        up = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e).repeat_interleave(64)
        w2 = wc * up
        hi = w2.to(dtype).float()
        lo = (w2 - hi).to(dtype).float()
        part = torch.zeros_like(out)
        for k in range(0, wc.shape[0], _TC_STEP):
            xs = xf[:, d0 + k:d0 + k + _TC_STEP]
            part = part + (xs @ hi[k:k + _TC_STEP] + xs @ lo[k:k + _TC_STEP])
        out = out + part / up
    return out.to(dtype)


def qmatmul_fp32_split_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, group_size: int,
                           bits: int = 8, chunk: Optional[int] = None) -> torch.Tensor:
    """The tensor-core kernel's arithmetic for fp32 x, in IEEE fp32, for the
    tests: for each 64-deep step of D and each column group g, v = x s_g
    rounded once in fp32 and cut by :func:`split3` into three bf16 parts,
    whose products with the exact integers q sum in fp32 (hi, mid, lo);
    each ``chunk`` of D (all of it by default: a cluster of one) sums its
    steps in order, and the chunks add in order. ``q`` is int8 [D, F], or
    packed [D, F/2] for bits 4; needs group_size % 64 == 0 and F %
    group_size == 0 (the kernel's fp32 layouts). The decode kernel computes
    the same for x of every dtype (x widened to fp32 first, the result
    rounded once to x's dtype), its steps 16 deep and its chunks as
    :func:`decode_plan` cuts D: every step's x s is the same, only the order
    of the fp32 sums differs."""
    w_q = unpack_int4(q) if bits == 4 else q
    D, F = w_q.shape
    G = F // group_size
    s_rows = s.reshape(D, G).float()
    qg = w_q.float().reshape(D, G, group_size)
    xf = x.float()
    chunk = chunk or D
    out = torch.zeros((x.shape[0], G, group_size), dtype=torch.float32, device=x.device)
    for d0 in range(0, D, chunk):
        part = torch.zeros_like(out)
        for k in range(d0, min(d0 + chunk, D), _TC_STEP):
            ks = slice(k, min(k + _TC_STEP, d0 + chunk, D))
            v = xf[:, None, ks] * s_rows[ks].t()[None]  # [M, G, 64]: x s_g
            hi, mid, lo = split3(v)
            step = [torch.einsum("mgk,kgc->mgc", t, qg[ks]) for t in (hi, mid, lo)]
            part = part + ((step[0] + step[1]) + step[2])
        out = out + part
    return out.reshape(x.shape[0], F).to(x.dtype)


# ------------------------------------------------------------------ the route
def tc_layout(D: int, F: int, group_size: int, bits: int) -> bool:
    """Whether the tensor-core kernel takes this weight layout: whole 64-row
    steps of D, whole groups in a row, no 64-column panel across a group
    boundary, and whole panels (int4: whole packed panels in each half)."""
    return (D % _TC_STEP == 0 and group_size >= 8 and F % group_size == 0
            and (group_size % 64 == 0 or 64 % group_size == 0)
            and F % (128 if bits == 4 else 64) == 0)


def tc_takes(dtype: torch.dtype, D: int, F: int, group_size: int, bits: int) -> bool:
    """Whether the tensor-core kernel takes x of ``dtype`` over this weight
    layout: :func:`tc_layout`, and for fp32 x each 64-column panel inside
    one group (its x s is one product per panel)."""
    if dtype == torch.float32:
        return group_size % 64 == 0 and tc_layout(D, F, group_size, bits)
    return dtype in (torch.bfloat16, torch.float16) and tc_layout(D, F, group_size, bits)


def decode_takes(dtype: torch.dtype, D: int, F: int, group_size: int, bits: int) -> bool:
    """Whether the decode kernel takes x of ``dtype`` over this weight
    layout: :func:`tc_layout` with groups of whole 64-column panels (each
    warp's 64 columns in one group), in every float dtype."""
    return (dtype in (torch.float32, torch.bfloat16, torch.float16) and group_size % 64 == 0
            and tc_layout(D, F, group_size, bits))


def qmm_route(M: int, dtype: torch.dtype, D: int, F: int, group_size: int, bits: int) -> str:
    """The route of one quantized product of ``M`` rows: ``"dequantize"``
    (more than ``_MAX_M`` rows: the reference's dequantize-then-matmul),
    ``"decode"`` (at most ``_TC_MIN_M`` rows of fp32, bf16 or fp16 x, in a
    layout :func:`decode_takes`), ``"tensor_cores"`` (more rows, in a
    layout :func:`tc_takes`) or ``"cuda_cores"`` (the other layouts). On the
    CPU the three kernel routes run the plain version."""
    if M > _MAX_M:
        return "dequantize"
    if M <= _TC_MIN_M:
        return "decode" if decode_takes(dtype, D, F, group_size, bits) else "cuda_cores"
    return "tensor_cores" if tc_takes(dtype, D, F, group_size, bits) else "cuda_cores"


# ------------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_quant_matmul.argtypes = [ptr, i64] + [ptr] * 3 + [i32] * 9 + [ptr]
    lib.ds_quant_matmul.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _lib_tc() -> ctypes.CDLL:
    lib = _build.load("int8_matmul_tc")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_quant_matmul_tc.argtypes = [ptr, i64] + [ptr] * 3 + [i32] * 8 + [ptr]
    lib.ds_quant_matmul_tc.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _lib_decode() -> ctypes.CDLL:
    lib = _build.load("int8_matmul_decode")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_quant_matmul_decode.argtypes = [ptr, i64] + [ptr] * 3 + [i32] * 9 + [ptr]
    lib.ds_quant_matmul_decode.restype = i32
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


@functools.lru_cache(maxsize=None)
def tc_plan(M: int, D: int, F: int, sms: int) -> Tuple[int, int]:
    """(chunk, cluster) of one tensor-core launch: the grid has a block per
    128-row (64 for M <= 64) x 128-column output tile; D is cut into
    ``cluster`` chunks of ``chunk`` rows (whole 64-row steps), one block of
    a thread block cluster each. A block's time is a fixed cost (the first
    tiles' latency, the cluster's reduction) plus a time per step, so the
    split takes the largest cluster, up to 8, that keeps every chunk
    at least two steps long and the grid within one block per SM; clusters
    of more than 3 within three quarters of the SMs (on the H100, grids of
    128 blocks in clusters of 4 or 8 ran markedly slower than smaller grids:
    such clusters do not all fit on the card at once). Empty chunks are
    dropped. A pure function of the shapes, so a result is bitwise
    repeatable."""
    tiles = math.ceil(F / _TC_COLS) * (1 if M <= 64 else math.ceil(M / _TC_ROWS))
    steps = D // _TC_STEP
    cluster = 1
    for c in range(2, _MAX_CLUSTER + 1):
        if steps >= 2 * c and tiles * c <= (sms if c <= 3 else 3 * sms // 4):
            cluster = c
    per_chunk = math.ceil(steps / cluster)
    return _TC_STEP * per_chunk, math.ceil(steps / per_chunk)


@functools.lru_cache(maxsize=None)
def decode_plan(D: int, Fq: int, sms: int, bits: int = 8) -> Tuple[int, int, int]:
    """(warps, per_warp, cluster) of one decode launch over a weight of D
    rows and ``Fq`` bytes a row: a block per 64-byte column tile and chunk
    of D, ``warps`` warps a block, each ``per_warp`` slabs of 32 rows, and
    ``cluster`` blocks of one column tile along D. A warp takes one slab
    while the grid fits the card at once (the weight at most 8 slabs an SM;
    int4 at most 6: its warps hold more registers, one block an SM, and on
    the H100 128 such blocks in clusters of 4 ran markedly slower than two
    slabs a warp, scripts/qmm_plan_sweep.py), else two (4 KB of weight in its
    registers, all requested before it computes), more where D would need
    more than 8 x 8 warps. The blocks along D are the fewest that keep 8 warps a block,
    doubled (up to 8) while the grid stays within one block an SM and every
    warp keeps a slab: the weight spreads over the card and each SM requests
    its share at once. A pure function of the shapes, so a result is bitwise
    repeatable."""
    tiles, slabs = Fq // _DEC_TILE, D // _DEC_SLAB
    per_warp = 1 if tiles * slabs <= (8 if bits == 8 else 6) * sms else 2
    per_warp = max(per_warp, math.ceil(slabs / (_DEC_MAX_WARPS * _MAX_CLUSTER)))
    groups = math.ceil(slabs / per_warp)  # warps along D
    cluster = math.ceil(groups / _DEC_MAX_WARPS)
    while 2 * cluster <= _MAX_CLUSTER and 2 * tiles * cluster <= sms and groups >= 4 * cluster:
        cluster *= 2
    return math.ceil(groups / cluster), per_warp, cluster


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


def _launch_checks(name: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> int:
    """Raise on what neither kernel takes; returns the card's index."""
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"{name} kernel: x dtype {x.dtype}; expected float32, bfloat16 "
                        "or float16")
    if s.dtype != torch.float32:
        raise TypeError(f"{name} kernel: scales must be float32, got {s.dtype}")
    if not (x.device == q.device == s.device):
        raise ValueError(f"{name}: x, q and s on different devices")
    dev = x.device
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _launch(name: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, F: int,
            group_size: int, bits: int) -> torch.Tensor:
    """One launch of the CUDA-core kernel (any dtype, any layout)."""
    index = _launch_checks(name, x, q, s)
    if x.stride(-1) != 1:
        x = x.contiguous()
    q, s = q.contiguous(), s.contiguous()
    M, D = x.shape
    dev = x.device
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` with 16-byte-aligned rows (a fresh copy of a view that lacks them)."""
    if t.stride(-1) != 1 or t.stride(0) * t.element_size() % 16 or t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _launch_tc(name: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, F: int,
               group_size: int, bits: int) -> torch.Tensor:
    """One launch of the tensor-core kernel (x's dtype and the layout
    :func:`tc_takes`); raises on anything else."""
    index = _launch_checks(name, x, q, s)
    M, D = x.shape
    if not tc_takes(x.dtype, D, F, group_size, bits):
        raise ValueError(f"{name} tensor-core kernel: x {x.dtype} with D {D}, F {F}, group "
                         f"{group_size} is not a dtype and layout it takes")
    x, q, s = _aligned(x), _aligned(q.contiguous()), s.contiguous()
    chunk, cluster = tc_plan(M, D, F, _num_sms(index))
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    lib = _lib_tc()
    with torch.cuda.device(index):
        status = lib.ds_quant_matmul_tc(
            x.data_ptr(), x.stride(0), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, D, F,
            group_size, chunk, cluster, bits, DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(index).cuda_stream)
    _build.check(lib, status, name)
    return out


def _launch_decode(name: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, F: int,
                   group_size: int, bits: int) -> torch.Tensor:
    """One launch of the decode kernel (at most ``_TC_MIN_M`` rows, a layout
    :func:`decode_takes`); raises on anything else."""
    index = _launch_checks(name, x, q, s)
    M, D = x.shape
    if M > _TC_MIN_M or not decode_takes(x.dtype, D, F, group_size, bits):
        raise ValueError(f"{name} decode kernel: {M} rows of {x.dtype} x with D {D}, F {F}, "
                         f"group {group_size} is not a shape it takes")
    x, q, s = _aligned(x), _aligned(q.contiguous()), s.contiguous()
    warps, per_warp, cluster = decode_plan(D, q.shape[1], _num_sms(index), bits)
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    lib = _lib_decode()
    with torch.cuda.device(index):
        status = lib.ds_quant_matmul_decode(
            x.data_ptr(), x.stride(0), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, D, F,
            group_size, warps, per_warp, cluster, bits, DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(index).cuda_stream)
    _build.check(lib, status, name)
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                group_size: int = 64) -> torch.Tensor:
    """``x @ dequantize(q, s)`` without a dequantized weight.

    x [M, D] float; q int8 [D, F]; s fp32 scales (any shape, read flat) for
    the row-major ``group_size`` runs of the weight (the
    ``models.gpt.quantize_for_inference`` layout). Returns [M, F] in x's dtype."""
    global int8_launches, int8_tc_launches, int8_dec_launches
    F = q.shape[-1]
    _check("int8_matmul", x, q, s, F, group_size)
    route = qmm_route(x.shape[0], x.dtype, q.shape[0], F, group_size, 8)
    if route == "dequantize":
        return x @ dequantize(q, s.reshape(-1), x.dtype)
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, s, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if route == "decode":
        out = _launch_decode("int8_matmul", x, q, s, F, group_size, 8)
        int8_dec_launches += 1
        return out
    if route == "tensor_cores":
        out = _launch_tc("int8_matmul", x, q, s, F, group_size, 8)
        int8_tc_launches += 1
        return out
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
    global int4_launches, int4_tc_launches, int4_dec_launches
    F = 2 * q4.shape[-1]
    _check("int4_matmul", x, q4, s, F, group_size)
    route = qmm_route(x.shape[0], x.dtype, q4.shape[0], F, group_size, 4)
    if route == "dequantize":
        return x @ dequantize(unpack_int4(q4), s.reshape(-1), x.dtype)
    if x.device.type == "cpu":
        return int4_matmul_ref(x, q4, s, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if route == "decode":
        out = _launch_decode("int4_matmul", x, q4, s, F, group_size, 4)
        int4_dec_launches += 1
        return out
    if route == "tensor_cores":
        out = _launch_tc("int4_matmul", x, q4, s, F, group_size, 4)
        int4_tc_launches += 1
        return out
    out = _launch("int4_matmul", x, q4, s, F, group_size, 4)
    int4_launches += 1
    return out
