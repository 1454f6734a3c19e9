"""The dequant-fused product over the quantized wire format (kernel B8): the
hand-written CUDA kernel, its plain version and the route to it.

Counterpart of ``deepspeed_tpu/ops/pallas/dequant_matmul.py``:

    out[M, F] = x[M, D] @ (q * scale + zero_point)[:, :orig_size]

with ``q`` the uint8 ``[D, Fp]`` payload of ``comm.quantized.quantize_blockwise``
and ``scale`` / ``zero_point`` fp32 ``[D, Fp / block]``, the block extent
``Fp // nb`` taken from the shapes (any even block that ``effective_block``
gives). One kernel computes it for every 8-bit payload of an even block,
reading x as fp32 whatever its dtype and writing x's dtype:
``deepspeed_tpu_torch/csrc/dequant_matmul_tc.cu`` on the tensor cores
(``wgmma``), at every number of rows (the LM head at every batch, from one
row up), every D (the last 64-row step zero-filled past D) and every even
scale block (256, 128 and 64 on whole 64-column panels; any other, such as
a user's ``zero_quantize_block_size`` of 96 or the effective block of short
rows, padded to the next multiple of 64 columns): x times each column
block's scales as three exact bf16 parts against the exact bf16 q - 128,
plus a side product (the zero-points and the 128 taken off q), an
fp32-accurate product (modelled by :func:`dequant_matmul_split_ref`), tiled
by :func:`dqm_tile`. The tensor cores' fp32 accumulators truncate, so past
a D of 1024 fp32 x adds them into IEEE fp32 sums every 256 rows of D
(:func:`dqm_promotes`; :func:`dequant_matmul_trunc_ref` models both). Its
header says how it is tiled and what bounds it.

The reference's ``_eligible`` tile rule is a Mosaic limit and does not carry
over: every 8-bit payload takes the kernel, ragged tiles masked. Packed int4
payloads take the plain route on every device, as the reference's do. On a
CUDA tensor an 8-bit payload launches the kernel or raises (an odd block,
which no quantizer gives); a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build
from .flash_attention import DTYPE_CODE

# the tensor-core kernel's granularity: a warpgroup's columns inside one
# scale block come in 64-column panels
_TC_PANEL = 64
# the kernel's step of D, and its steps between promotions of the
# accumulators into fp32 sums (kPromote); fp32 x past _PROMOTE_D promotes
_TC_STEP = 64
_PROMOTE_STEPS = 4
_PROMOTE_D = 1024

# kernel launches since import or the last reset to 0 (chip_smoke.py reads
# them to show that a main path went through the kernel)
tc_launches = 0


def dqm_route(M: int, D: int, Fp: int, nb: int, bits: int = 8) -> str:
    """The route of one product of ``M`` rows over a ``[D, Fp]`` payload in
    ``nb`` scale blocks: ``"plain"`` for a packed 4-bit payload (on every
    device, as the reference's); for 8 bits ``"tensor_cores"`` at any
    number of rows, any D and any even block (every block
    ``quantize_blockwise`` gives), and ``"none"`` for an odd block (no
    kernel: a CUDA tensor raises). On the CPU every route runs the plain
    version."""
    del M, D  # every row count and every D take the tensor cores
    if bits == 4:
        return "plain"
    return "tensor_cores" if nb >= 1 and Fp % nb == 0 and (Fp // nb) % 2 == 0 else "none"


def padded_block(Fp: int, nb: int) -> int:
    """The tensor-core kernel's virtual block: the scale block rounded up to
    whole 64-column panels (the block itself at 64, 128, 256; 128 at 96)."""
    return -(-(Fp // nb) // _TC_PANEL) * _TC_PANEL


def dqm_promotes(D: int, dtype: torch.dtype) -> bool:
    """Whether the tensor-core kernel adds its accumulators into IEEE fp32
    sums every 256 rows of D: for fp32 x past a D of 1024. wgmma's fp32
    accumulators truncate each addition, so their error grows with the rows
    summed into one: 2.29e-5 of the largest output at gpt-neox-20b's D 6144
    on the H100 (over the 1e-5 bar), 3.8e-6 at GPT-2's D 768;
    :func:`dequant_matmul_trunc_ref` gives 1.9-3.0e-5 and 2.7-3.1e-6 there,
    4.6e-6 at D 1024, and ~1.3e-6 at any D with the promotion. bf16 / fp16
    outputs round far above that error and never promote."""
    return dtype == torch.float32 and D > _PROMOTE_D


def dqm_tile(M: int, Fp: int, nb: int, promote: bool = False) -> Tuple[int, int]:
    """(row_wgs, cols) of the tensor-core kernel's block for this shape: the
    two warpgroups stacked along rows (2: 128 rows, ``cols`` columns in one
    scale block: 256, 128 or 64, the largest that divides the block; 128 or
    64 with ``promote``, whose fp32 sums take a second set of accumulator
    registers that 128 x 256 has no room for) where
    x has more than 64 rows, side by side (1: 64 rows, each warpgroup
    ``cols / 2`` columns in one scale block) at 64 rows or fewer, where a
    second row half would be empty. The side-by-side block takes 256
    columns where the scale block is a multiple of 128, 128 (a warpgroup a
    block of 64) otherwise. A block off 64-column panels counts as its
    :func:`padded_block`. On the H100 (``scripts/quant_tc_bench.py``, x
    fp32 over GPT-2-125M's head, every tiling on the same inputs): at 32
    rows, block 256, the 64 x 256 block 0.0682 ms, 64 x 128 0.0748-0.0751,
    128 x 256 0.0914-0.0916; at 4096 rows, block 128, 128 x 128 2.560-2.562
    ms against 64 x 256 (each warpgroup its own block) 3.061-3.116 and 128 x
    64 3.882-3.884; at block 256, 128 x 256 2.039-2.043 against 128 x 128
    2.554-2.564. Promoting at gpt-neox-20b's D 6144 (256 rows, block 256):
    128 x 128 1.214-1.219 ms against the unpromoted 128 x 256's
    0.918-0.919; at a block of 96 the 64 x 256 block's promoting padded
    instance spills (5.10 ms against 64 x 128's 3.90), so a promoting block
    off 64-column panels takes 128 columns at 64 rows or fewer."""
    block = padded_block(Fp, nb)
    if M > 64:
        return 2, next(c for c in ((128, 64) if promote else (256, 128, 64)) if block % c == 0)
    if promote and (Fp // nb) % _TC_PANEL:
        return 1, 128
    return 1, 256 if block % 128 == 0 else 128


def _dequantize(q, scale, zero_point, bits, orig_size):
    # comm.quantized imports this module; the import here runs at call time
    from ...comm.quantized import dequantize_blockwise

    return dequantize_blockwise(q, scale, zero_point, bits=bits, orig_size=orig_size)


def dequant_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                       zero_point: torch.Tensor, orig_size: int, bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of B8: ``dequantize_blockwise`` trimmed to
    ``orig_size``, an fp32 product, one cast to x's dtype."""
    return (x.float() @ _dequantize(q, scale, zero_point, bits, orig_size)).to(x.dtype)


def _bf16_top(v: torch.Tensor) -> torch.Tensor:
    """The top 16 bits of fp32 ``v`` (a bf16 value, truncated), as fp32."""
    return (v.view(torch.int32) & -65536).view(torch.float32)


def split3(v: torch.Tensor):
    """fp32 ``v`` as three bf16-representable parts by truncation, as the
    tensor-core kernel cuts it: hi = the top 16 bits of v, mid = those of v -
    hi, lo = v - hi - mid. Each difference is exact, so hi + mid + lo == v."""
    hi = _bf16_top(v)
    r = v - hi
    mid = _bf16_top(r)
    return hi, mid, r - mid


def dequant_matmul_split_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                             zero_point: torch.Tensor, orig_size: int) -> torch.Tensor:
    """The tensor-core kernel's arithmetic, for the tests: for each scale
    block b (of any even size: the kernel pads it to whole panels with zero
    weights, which add nothing), v = x times the block's scales rounded once
    in fp32 and cut by :func:`split3`, the three parts' fp32 products with
    the exact q - 128, plus the side product ``x @ zero_point[:, b] + 128
    v.sum(1)`` in fp32; one rounding to x's dtype. 8-bit payloads only."""
    xf = x.float()
    nb = scale.shape[1]
    block = q.shape[1] // nb
    out = torch.empty((x.shape[0], nb * block), dtype=torch.float32, device=x.device)
    for b in range(nb):
        cols = slice(b * block, (b + 1) * block)
        qb = q[:, cols].float() - 128.0
        v = xf * scale[:, b]
        hi, mid, lo = split3(v)
        side = xf @ zero_point[:, b] + 128.0 * v.sum(dim=1)
        out[:, cols] = (hi @ qb + mid @ qb + lo @ qb) + side[:, None]
    return out[:, :orig_size].to(x.dtype)


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` rounded toward zero to fp32."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def dequant_matmul_trunc_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                             zero_point: torch.Tensor, orig_size: int,
                             promote: bool = False) -> torch.Tensor:
    """A model of the tensor-core kernel's fp32 accumulators, for the tests
    (fp32 x): :func:`dequant_matmul_split_ref`'s arithmetic, each wgmma's
    k16 slice of each part summed exactly and added to the fp32 accumulator
    rounded toward zero (the tensor cores' additions truncate), D in the
    kernel's order (64-deep steps of 4 k16 x 3 parts); with ``promote`` the
    accumulator is added into an IEEE fp32 sum every 4 steps and zeroed, as
    the kernel's PROMO instances do. Returns fp32 [M, orig_size]."""
    xf = x.float()
    D = xf.shape[1]
    nb = scale.shape[1]
    block = q.shape[1] // nb
    out = torch.empty((x.shape[0], nb * block), dtype=torch.float32, device=x.device)
    for b in range(nb):
        cols = slice(b * block, (b + 1) * block)
        qb = q[:, cols].double() - 128.0
        v = xf * scale[:, b]
        parts = [p.double() for p in split3(v)]
        acc = torch.zeros((x.shape[0], block), dtype=torch.float32, device=x.device)
        total = torch.zeros_like(acc)
        steps = -(-D // _TC_STEP)
        for k in range(steps):
            for k0 in range(k * _TC_STEP, min(D, (k + 1) * _TC_STEP), 16):
                rows = slice(k0, min(D, k0 + 16))
                for p in parts:
                    acc = _round_toward_zero(acc.double() + p[:, rows] @ qb[rows])
            if promote and ((k + 1) % _PROMOTE_STEPS == 0 or k + 1 == steps):
                total, acc = total + acc, torch.zeros_like(acc)
        side = xf @ zero_point[:, b] + 128.0 * v.sum(dim=1)
        out[:, cols] = (total + acc) + side[:, None]
    return out[:, :orig_size]


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [rows, cols] as TMA reads it: unit column stride and 16-byte
    aligned rows, as it is or as a copy whose row stride is padded to 16
    bytes."""
    step = 16 // t.element_size()
    if t.stride(-1) == 1 and t.stride(0) % step == 0 and t.data_ptr() % 16 == 0:
        return t
    rows, cols = t.shape
    padded = torch.empty((rows, -(-cols // step) * step), dtype=t.dtype, device=t.device)
    padded[:, :cols] = t
    return padded[:, :cols]


@functools.lru_cache(maxsize=None)
def _lib_tc() -> ctypes.CDLL:
    lib = _build.load("dequant_matmul_tc")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_dequant_matmul_tc.argtypes = [ptr, i64, ptr, i64] + [ptr] * 3 + [i32] * 9 + [ptr]
    lib.ds_dequant_matmul_tc.restype = i32
    return lib


def _launch(x, q, scale, zero_point, orig_size: int,
            tile: Optional[Tuple[int, int]] = None,
            promote: Optional[bool] = None) -> torch.Tensor:
    """One launch of the tensor-core kernel (``tile`` and ``promote``
    override its :func:`dqm_tile` and :func:`dqm_promotes`, for
    measurements)."""
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"dequant_matmul kernel: x dtype {x.dtype}; expected float32, "
                        "bfloat16 or float16")
    if scale.dtype != torch.float32 or zero_point.dtype != torch.float32:
        raise TypeError("dequant_matmul kernel: scale and zero_point must be float32")
    if not (x.device == q.device == scale.device == zero_point.device):
        raise ValueError("dequant_matmul: x, q, scale and zero_point on different devices")
    q, scale, zero_point = q.contiguous(), scale.contiguous(), zero_point.contiguous()
    M, D = x.shape
    Fp, nb = q.shape[1], scale.shape[1]
    promote = dqm_promotes(D, x.dtype) if promote is None else promote
    # the kernel copies x's rows and q's by TMA, which needs 16-byte aligned
    # rows: an x or a payload whose rows are not gets a copy of padded stride
    x, q = _tma_rows(x), _tma_rows(q)
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = torch.empty((M, orig_size), dtype=x.dtype, device=dev)
    tail = (scale.data_ptr(), zero_point.data_ptr(), out.data_ptr(), M, D, Fp, nb, orig_size,
            DTYPE_CODE[x.dtype])
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        lib = _lib_tc()
        status = lib.ds_dequant_matmul_tc(x.data_ptr(), x.stride(0), q.data_ptr(), q.stride(0),
                                          *tail, *(tile or dqm_tile(M, Fp, nb, promote)),
                                          int(promote), stream)
    _build.check(lib, status, "dequant_matmul")
    return out


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   zero_point: torch.Tensor, orig_size: int, bits: int = 8) -> torch.Tensor:
    """``x @ dequantize_blockwise(q, scale, zero_point)[:, :orig_size]``
    without a dequantized weight. x [M, D] float; q uint8 [D, Fp] (8-bit; a
    packed 4-bit payload takes the plain route); scale / zero_point fp32
    [D, nb]. Returns [M, orig_size] in x's dtype. It has no autograd rule of
    its own: ``comm.quantized.quantized_matmul_reshard`` carries it."""
    global tc_launches
    if bits not in (4, 8):
        raise ValueError(f"dequant_matmul: bits must be 8 or 4, got {bits}")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"dequant_matmul: x {tuple(x.shape)} and q {tuple(q.shape)} do not "
                         "make [M, D] @ [D, Fp]")
    if q.dtype != torch.uint8:
        raise TypeError(f"dequant_matmul: q must be uint8, got {q.dtype}")
    nb = scale.shape[-1]
    width = q.shape[1] * (2 if bits == 4 else 1)
    if (scale.shape != (q.shape[0], nb) or zero_point.shape != scale.shape or nb < 1
            or width % nb or not 0 < orig_size <= width):
        raise ValueError(f"dequant_matmul: scale {tuple(scale.shape)}, zero_point "
                         f"{tuple(zero_point.shape)} and orig_size {orig_size} do not fit q "
                         f"{tuple(q.shape)} of {bits} bits")
    route = dqm_route(x.shape[0], q.shape[0], q.shape[1], nb, bits)
    if route == "plain" or x.device.type == "cpu":
        return dequant_matmul_ref(x, q, scale, zero_point, orig_size, bits)
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul: unsupported device {x.device}")
    if route != "tensor_cores":
        raise ValueError(f"dequant_matmul: the kernel takes even scale blocks; q "
                         f"{tuple(q.shape)} in {nb} blocks has blocks of {q.shape[1] / nb:g}")
    out = _launch(x, q, scale, zero_point, orig_size)
    tc_launches += 1
    return out
