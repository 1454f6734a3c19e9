"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``. Every kernel
runs on the tensor cores but delta (:func:`flash_route`): the forward
(``_fwd`` / ``_fwd_kernel``, B1) is ``csrc/flash_attention_fwd_tc.cu`` for
bf16 / fp16 inputs and ``csrc/flash_attention_fwd_tf32.cu`` (3xTF32: each
fp32 product as three TF32 passes, which keeps the fp32 function) for fp32;
the backward's dq and dk/dv (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``, B2) are
``csrc/flash_attention_bwd_tc.cu`` and ``csrc/flash_attention_bwd_tf32.cu``
likewise, and delta (``_bwd_delta_kernel``) is the CUDA-core kernel of
``csrc/flash_attention_bwd.cu`` in every dtype. Each source's header says
how it is split and what bounds it. :class:`FlashAttention` is the counterpart of the reference's
``jax.custom_vjp`` around ``_flash``: it saves (q, k, v, o, lse) in the
forward and runs the three backward kernels.

``stochastic_mode`` is the reference's second function (its kernels' ``lo``
is the input dtype): q scaled in fp32 and rounded to the input dtype, P cast
once for P V; in the backward dO, P and dS cast once for their products. For
bf16 / fp16 inputs the tensor-core kernels have a single-cast instance of
each; for fp32 inputs it is the default function.

Every wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import _build
from ...profiling.flops_profiler import add_kernel_flops

NEG_INF = -1e30
# the kernels' template instances: the head dims of every preset the
# reference has (gpt2-760m and gpt-neox-20b have 96)
HEAD_DIMS = (64, 96, 128)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# the kernels' route by input dtype (flash_route): "tf32" the 3xTF32
# kernels for fp32, "tc" the 16-bit tensor-core kernels
ROUTES = {torch.float32: "tf32", torch.bfloat16: "tc", torch.float16: "tc"}

# kernel launches since import or the last reset to 0 (chip_smoke.py reads
# them to show that the main path went through the kernels): the forward,
# dq and dk/dv by route (_tf32 for fp32, _tc for bf16 / fp16, _tc_stochastic
# the 16-bit kernels' single-cast instances, stochastic_mode) and the
# backward's delta in every dtype
fwd_tf32_launches = 0
fwd_tc_launches = 0
fwd_tc_stochastic_launches = 0
bwd_delta_launches = 0
bwd_dq_tf32_launches = 0
bwd_dkv_tf32_launches = 0
bwd_dq_tc_launches = 0
bwd_dkv_tc_launches = 0
bwd_dq_tc_stochastic_launches = 0
bwd_dkv_tc_stochastic_launches = 0


@functools.lru_cache(maxsize=None)
def _fwd_tf32_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_fwd_tf32")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_flash_attention_fwd_tf32.argtypes = (
        [ptr] * 5 + [i32] * 6 + [i64] * 9 + [ctypes.c_float, i32, ptr])
    lib.ds_flash_attention_fwd_tf32.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_tc_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_fwd_tc")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_flash_attention_fwd_tc.argtypes = (
        [ptr] * 5 + [i32] * 6 + [i64] * 9 + [ctypes.c_float, i32, i32, ptr])
    lib.ds_flash_attention_fwd_tc.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _delta_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_flash_attention_bwd_delta.argtypes = [ptr] * 3 + [i32] * 5 + [i64] * 6 + [ptr]
    lib.ds_flash_attention_bwd_delta.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_tf32_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd_tf32")
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ds_flash_attention_bwd_dq_tf32.argtypes = (
        [ptr] * 7 + [i32] * 6 + [i64] * 12 + [f32, i32, ptr])
    lib.ds_flash_attention_bwd_dkv_tf32.argtypes = (
        [ptr] * 8 + [i32] * 6 + [i64] * 12 + [f32, i32, ptr])
    lib.ds_flash_attention_bwd_dq_tf32.restype = i32
    lib.ds_flash_attention_bwd_dkv_tf32.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_tc_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd_tc")
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ds_flash_attention_bwd_dq_tc.argtypes = (
        [ptr] * 7 + [i32] * 6 + [i64] * 12 + [f32, i32, i32, ptr])
    lib.ds_flash_attention_bwd_dkv_tc.argtypes = (
        [ptr] * 8 + [i32] * 6 + [i64] * 12 + [f32, i32, i32, ptr])
    lib.ds_flash_attention_bwd_dq_tc.restype = i32
    lib.ds_flash_attention_bwd_dkv_tc.restype = i32
    return lib


def _scale(q: torch.Tensor, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _stochastic(q: torch.Tensor, stochastic: bool) -> bool:
    """stochastic_mode's single-cast function applies to 16-bit inputs; for
    fp32 ones it is the default function."""
    return bool(stochastic) and q.dtype != torch.float32


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded once to ``dtype`` and widened back."""
    return x.to(dtype).float()


def _visible(T: int, S: int, causal: bool, device) -> Optional[torch.Tensor]:
    """[T, S] bool of the keys each query row sees (bottom-right causal), or None."""
    if not causal:
        return None
    return (torch.arange(S, device=device)[None, :]
            <= torch.arange(T, device=device)[:, None] + (S - T))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, softmax_scale: Optional[float] = None,
                        stochastic: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward, the CPU path. The default is
    ``dot_product_attention`` with the logsumexp, every operand widened to
    fp32 (the reference's ``stochastic_mode=False``); ``stochastic`` with
    16-bit inputs is the reference's single-cast function
    (:func:`_tiled_forward`: q scaled in fp32 and rounded to its dtype, P
    cast once, relative to each 64-key tile's running maximum as the
    kernels hold it). Returns (o [B, T, H, D] in q's dtype, lse [B*H, T]
    fp32)."""
    if _stochastic(q, stochastic):
        return _tiled_forward(q, k, v, causal, _scale(q, softmax_scale), True,
                              lambda p: _cast(p, q.dtype))
    B, T, H, D = q.shape
    S = k.shape[1]
    logits = torch.einsum("bthd,bshd->bhts", q.float() * _scale(q, softmax_scale), k.float())
    visible = _visible(T, S, causal, q.device)
    if visible is not None:
        logits = logits.masked_fill(~visible, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)
    return o, lse.reshape(B * H, T)


# keys per tile of the tensor-core kernels: the forward's running maximum
# and fp16's running row scale in the backward change only between tiles
_TC_TILE = 64
# the tensor-core forward holds fp16's P times 2^14 (so its lo half stays
# above fp16's subnormal range; P <= 1 after the running maximum)
FP16_P_EXP = 14


def _running_tile_max(s: torch.Tensor) -> torch.Tensor:
    """The running row maximum of [..., S] scores as a forward kernel holds it
    while it streams keys in tiles of 64: each entry gets the maximum of its
    row over its own and the earlier tiles."""
    n = s.shape[-1]
    a = torch.nn.functional.pad(s, (0, -n % _TC_TILE), value=NEG_INF)
    m = a.reshape(*a.shape[:-1], -1, _TC_TILE).amax(-1)
    m = torch.cummax(m, dim=-1).values
    return m.repeat_interleave(_TC_TILE, -1)[..., :n]


def _tiled_forward(q, k, v, causal: bool, scale: float, stochastic: bool, round_p
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core forward's arithmetic as plain PyTorch. Scores: the fp32
    product times the scale, or with ``stochastic`` the product of q~ =
    dtype(fp32(q) scale) and k (the reference's single-cast q). Each 64-key
    tile's P = exp(s - m_t) is taken relative to the row's running maximum
    m_t as of that tile and enters P V as ``round_p(P)`` (fp32 in, fp32
    out), weighted by exp(m_t - m), which is what the kernel's rescales of
    its accumulator by alpha amount to; l sums the unrounded P. Returns (o in
    q's dtype, lse [B*H, T] fp32)."""
    B, T, H, _ = q.shape
    S = k.shape[1]
    if stochastic:
        s = torch.einsum("bthd,bshd->bhts", _cast(q.float() * scale, q.dtype), k.float())
    else:
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    visible = _visible(T, S, causal, q.device)
    if visible is not None:
        s = s.masked_fill(~visible, NEG_INF)
    m_t = _running_tile_max(s)
    m = m_t[..., -1:]
    p = torch.exp(s - m_t)
    w = torch.exp(m_t - m)
    l = (p * w).sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhts,bshd->bthd", round_p(p) * w / l_safe, v.float())
    return o.to(q.dtype), (m + torch.log(l_safe)).reshape(B * H, T)


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, softmax_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the tensor-core forward's rounding (bf16 / fp16
    inputs, the default function): :func:`_tiled_forward` with each tile's P
    entering P V as hi + lo halves of the input dtype, fp16's times
    2^FP16_P_EXP before the split (exact both ways). For the tests: the CPU
    path runs :func:`flash_attention_ref`, the reference's fp32 function."""
    f = 2.0**FP16_P_EXP if q.dtype == torch.float16 else 1.0

    def split(p: torch.Tensor) -> torch.Tensor:
        y = p * f
        hi = _cast(y, q.dtype)
        return (hi + _cast(y - hi, q.dtype)) / f

    return _tiled_forward(q, k, v, causal, _scale(q, softmax_scale), False, split)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: 10 explicit
    mantissa bits, to nearest with ties away from zero (half of the dropped
    13 bits' weight added to the magnitude, then those bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int = 3,
             a_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the fp32 kernels take it on the tensor cores:
    with big = tf32(x) and small = tf32(x - big), 3xTF32 sums small_a big_b,
    big_a small_b and big_a big_b (``passes`` 1: big_a big_b alone, one TF32
    pass, for the tests). ``a_weight`` multiplies a's parts after the split
    (the forward's per-tile rescale of its fp32 accumulator)."""
    a, b = a.float(), b.float()
    ab, bb = _tf32(a), _tf32(b)
    w = 1.0 if a_weight is None else a_weight
    out = torch.einsum(eq, ab * w, bb)
    if passes == 3:
        out = (torch.einsum(eq, _tf32(a - ab) * w, bb) + torch.einsum(eq, ab * w, _tf32(b - bb))
               + out)
    elif passes != 1:
        raise ValueError(f"_mm_tf32: passes {passes} (3, or 1 for the tests)")
    return out


def flash_attention_tf32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True, softmax_scale: Optional[float] = None,
                             passes: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fp32 kernel's arithmetic (3xTF32, for the tests;
    the CPU path runs :func:`flash_attention_ref`): S = q k^T in
    :func:`_mm_tf32` times the scale, each 64-key tile's P = exp(s - m_t)
    relative to the row's running maximum, P V in :func:`_mm_tf32` with P
    weighted by exp(m_t - m) after its split, as the kernel rescales its
    accumulator. ``passes`` 1 is one TF32 pass, which the fp32 bars must
    refuse. Returns (o fp32, lse [B*H, T] fp32)."""
    B, T, H, _ = q.shape
    S = k.shape[1]
    s = _mm_tf32("bthd,bshd->bhts", q, k, passes) * _scale(q, softmax_scale)
    visible = _visible(T, S, causal, q.device)
    if visible is not None:
        s = s.masked_fill(~visible, NEG_INF)
    m_t = _running_tile_max(s)
    m = m_t[..., -1:]
    p = torch.exp(s - m_t)
    w = torch.exp(m_t - m)
    l = (p * w).sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = _mm_tf32("bhts,bshd->bthd", p, v, passes, a_weight=w / l_safe)
    return o, (m + torch.log(l_safe)).reshape(B * H, T)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, T, H, D] / [B, S, H, D]")
    B, T, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if T == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODE:
        raise TypeError(f"flash_attention: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "expected one of float32, bfloat16, float16 for all three")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")


def _readable(t: torch.Tensor) -> bool:
    """The kernels read rows with 16-byte loads through the given strides:
    the head dim contiguous, every row 16-byte aligned."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any((s * es) % 16 for s in t.stride()[:3]))


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernels CUDA inputs of ``dtype`` and ``head_dim`` take: "tf32" (the
    3xTF32 forward, dq and dk/dv for fp32) or "tc" (the 16-bit tensor-core
    ones for bf16 / fp16), at every head dim the kernels are built for; delta
    is the CUDA-core kernel on both routes. Other head dims raise
    NotImplementedError, other dtypes TypeError: nothing falls back."""
    if head_dim not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention kernel: head dim {head_dim} (built for {HEAD_DIMS}, the head "
            "dims of the reference's presets)")
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention kernel: dtype {dtype} (built for {tuple(ROUTES)})")
    return ROUTES[dtype]


def _check_kernel_layout(*ts: torch.Tensor) -> str:
    """The route of ``ts[0]``'s dtype and head dim (:func:`flash_route`), after
    checking that the kernels can read every tensor of ``ts``."""
    route = flash_route(ts[0].dtype, ts[0].shape[-1])
    for t in ts:
        if not _readable(t):
            raise ValueError("flash_attention kernel: the head dim must be contiguous and "
                             f"rows 16-byte aligned (strides {t.stride()}, element size "
                             f"{t.element_size()})")
    return route


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def attention_flops(B: int, H: int, T: int, S: int, D: int) -> int:
    """The flops each kernel adds to an open flop count: the two products of
    the forward (QK^T and PV), or the two of dq (dO V^T and dS K), or the two
    of dk/dv (P^T dO and dS^T Q), each 2·B·H·T·S·D. A causal call counts
    the whole T×S product, as the plain attention path computes it, so the
    kernels' step counts what the plain path's does (B1 + B2 = 3x this)."""
    return 4 * B * H * T * S * D


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, softmax_scale: Optional[float] = None,
                        stochastic: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, T, H, D], k/v [B, S, H, D] -> (o [B, T, H, D] in q's dtype,
    lse [B*H, T] fp32). Causal masking is aligned bottom-right: query row t
    sees keys up to t + S - T. On CUDA, bf16 / fp16 launch the tensor-core
    kernel (its single-cast instance with ``stochastic``), fp32 the 3xTF32
    one (:func:`flash_route`)."""
    global fwd_tf32_launches, fwd_tc_launches, fwd_tc_stochastic_launches
    _check(q, k, v)
    scale = _scale(q, softmax_scale)
    stochastic = _stochastic(q, stochastic)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale, stochastic)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    route = _check_kernel_layout(q, k, v)
    B, T, H, D = q.shape
    S = k.shape[1]
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, T, S, D, DTYPE_CODE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale, int(bool(causal)))
    with torch.cuda.device(q.device):
        if route == "tc":
            lib = _fwd_tc_lib()
            status = lib.ds_flash_attention_fwd_tc(*args, int(stochastic), _stream())
        else:
            lib = _fwd_tf32_lib()
            status = lib.ds_flash_attention_fwd_tf32(*args, _stream())
    _build.check(lib, status, f"flash_attention_fwd_{route}")
    add_kernel_flops("flash_attention_fwd", attention_flops(B, H, T, S, D))
    if stochastic:
        fwd_tc_stochastic_launches += 1
    elif route == "tc":
        fwd_tc_launches += 1
    else:
        fwd_tf32_launches += 1
    return o, lse


# --------------------------------------------------------------------------- backward
def _probs(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, causal: bool,
           scale: float, stochastic: bool = False) -> torch.Tensor:
    """P = exp(scale * q k^T - lse) as [B, H, T, S] fp32, 0 where a key is
    hidden; q scaled in fp32 first (as the CUDA-core kernels score), or with
    ``stochastic`` the product scaled (the reference's backward order)."""
    B, T, H, _ = q.shape
    S = k.shape[1]
    if stochastic:
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    else:
        s = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    visible = _visible(T, S, causal, q.device)
    return p if visible is None else p.masked_fill(~visible, 0.0)


def flash_attention_bwd_delta_ref(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Plain version of the delta kernel: rowsum(dO * O) in fp32, [B*H, T]."""
    B, T, H, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * H, T)


def _lo(q: torch.Tensor, stochastic: bool):
    """The reference's ``astype(lo)`` of a product's fp32 operand: a single
    cast to q's dtype in stochastic_mode, nothing otherwise."""
    return (lambda x: _cast(x, q.dtype)) if stochastic else (lambda x: x)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool, scale: float,
                               stochastic: bool = False) -> torch.Tensor:
    """Plain version of the dq kernel: dS = P * (dO v^T - delta) * scale,
    dQ = dS k, in q's dtype; with ``stochastic`` (16-bit inputs) dO and dS
    cast once to q's dtype for their products."""
    B, T, H, _ = q.shape
    stochastic = _stochastic(q, stochastic)
    lo = _lo(q, stochastic)
    p = _probs(q, k, lse, causal, scale, stochastic)
    dp = torch.einsum("bthd,bshd->bhts", lo(do.float()), v.float())
    ds = p * (dp - delta.reshape(B, H, T, 1)) * scale
    return torch.einsum("bhts,bshd->bthd", lo(ds), k.float()).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool, scale: float,
                                stochastic: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: dV = P^T dO, dK = dS^T q, in k's
    and v's dtypes; with ``stochastic`` (16-bit inputs) P, dO and dS cast
    once to q's dtype for their products."""
    B, T, H, _ = q.shape
    stochastic = _stochastic(q, stochastic)
    lo = _lo(q, stochastic)
    p = _probs(q, k, lse, causal, scale, stochastic)
    do_lo = lo(do.float())
    dv = torch.einsum("bhts,bthd->bshd", lo(p), do_lo)
    dp = torch.einsum("bthd,bshd->bhts", do_lo, v.float())
    ds = p * (dp - delta.reshape(B, H, T, 1)) * scale
    dk = torch.einsum("bhts,bthd->bshd", lo(ds), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            softmax_scale: Optional[float] = None, stochastic: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, written with its explicit
    formulas (not autograd of the forward), every operand widened to fp32:
    P = exp(S * scale - lse), delta = rowsum(dO * O), dV = P^T dO,
    dS = P * (dO V^T - delta) * scale, dQ = dS K, dK = dS^T Q; with
    ``stochastic`` (16-bit inputs) the reference's single-cast function: S
    scaled after the product, P, dO and dS cast once to the input dtype for
    the products."""
    scale = _scale(q, softmax_scale)
    delta = flash_attention_bwd_delta_ref(o, do)
    dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale, stochastic)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale, stochastic)
    return dq, dk, dv


def _row_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The fp16 kernels' running row exponent e of ``x`` [B, H, T, S] (as
    fp32, one per entry): each row (the axis other than ``dim``) is streamed
    along ``dim`` in tiles of 64, and an entry of tile t gets the largest e
    that keeps every entry of tiles 0..t of its row below 2^15 (the row's
    largest so far in [2^14, 2^15)), clamped to [-126, 126]; 0 before the
    row's first nonzero tile."""
    a = x.abs().movedim(dim, -1)
    n = a.shape[-1]
    a = torch.nn.functional.pad(a, (0, -n % _TC_TILE))
    m = a.reshape(*a.shape[:-1], -1, _TC_TILE).amax(-1)
    _, ex = torch.frexp(m)  # m = f 2^ex, f in [0.5, 1): floor(log2 m) = ex - 1
    none = 1 << 30
    need = torch.where(m > 0, (15 - ex).clamp(-126, 126), torch.full_like(ex, none))
    e = torch.cummin(need, dim=-1).values
    e = torch.where(e == none, torch.zeros_like(e), e)
    return e.repeat_interleave(_TC_TILE, -1)[..., :n].movedim(-1, dim)


def _split(x: torch.Tensor, dtype: torch.dtype, dim: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` [B, H, T, S] as the tensor-core kernels feed it to a
    product, both halves widened back to fp32: hi = dtype(y), lo =
    dtype(y - hi) of y = x 2^e, divided by 2^e again (the kernels divide
    their fp32 sums). e = 0 for bf16 (fp32's exponent range); for fp16 with
    ``dim`` given it is :func:`_row_scale`, which keeps hi and lo above
    fp16's subnormal range, where they would lose bits."""
    e = _row_scale(x, dim) if dtype == torch.float16 and dim is not None else None
    y = x if e is None else torch.ldexp(x, e.float())
    hi = y.to(dtype).float()
    lo = (y - hi).to(dtype).float()
    if e is not None:
        hi, lo = torch.ldexp(hi, -e.float()), torch.ldexp(lo, -e.float())
    return hi, lo


def flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal: bool = True,
                                  softmax_scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the tensor-core kernels' rounding (bf16 / fp16
    inputs): :func:`flash_attention_bwd_ref`, except that P and dS enter dV,
    dK and dQ as hi + lo halves in the input dtype (:func:`_split`), each
    product taken on both halves in fp32. fp16 scales the rows as the
    kernels do: dQ's dS by query row, dV's P and dK's dS by key row. For the
    tests: the CPU path runs :func:`flash_attention_bwd_ref`, the reference's
    fp32 function."""
    scale = _scale(q, softmax_scale)
    B, T, H, _ = q.shape
    delta = flash_attention_bwd_delta_ref(o, do)
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta.reshape(B, H, T, 1)) * scale
    # the dk/dv kernel streams query tiles (rows are keys), the dq kernel key tiles
    dv = sum(torch.einsum("bhts,bthd->bshd", x, do.float()) for x in _split(p, q.dtype, -2))
    dk = sum(torch.einsum("bhts,bthd->bshd", x, q.float()) for x in _split(ds, q.dtype, -2))
    dq = sum(torch.einsum("bhts,bshd->bthd", x, k.float()) for x in _split(ds, q.dtype, -1))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_tf32_ref(q, k, v, o, lse, do, causal: bool = True,
                                 softmax_scale: Optional[float] = None, passes: int = 3
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fp32 backward kernels' arithmetic (3xTF32, for
    the tests; the CPU path runs :func:`flash_attention_bwd_ref`): every
    product of the backward (q k^T scored as the forward scores it, dO v^T,
    P^T dO, dS k, dS^T q) in :func:`_mm_tf32`; delta is the fp32 rowsum of
    the CUDA-core kernel. ``passes`` 1 is one TF32 pass. Returns (dq, dk, dv)
    fp32."""
    B, T, H, _ = q.shape
    S = k.shape[1]
    scale = _scale(q, softmax_scale)
    delta = flash_attention_bwd_delta_ref(o, do)
    s = _mm_tf32("bthd,bshd->bhts", q, k, passes) * scale
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    visible = _visible(T, S, causal, q.device)
    if visible is not None:
        p = p.masked_fill(~visible, 0.0)
    dp = _mm_tf32("bthd,bshd->bhts", do, v, passes)
    ds = p * (dp - delta.reshape(B, H, T, 1)) * scale
    dv = _mm_tf32("bhts,bthd->bshd", p, do, passes)
    dk = _mm_tf32("bhts,bthd->bshd", ds, q, passes)
    dq = _mm_tf32("bhts,bshd->bthd", ds, k, passes)
    return dq, dk, dv


def flash_attention_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) as [B*H, T] fp32 (the delta kernel)."""
    global bwd_delta_launches
    if o.device.type == "cpu":
        return flash_attention_bwd_delta_ref(o, do)
    _check_kernel_layout(o, do)
    B, T, H, D = o.shape
    delta = torch.empty((B * H, T), dtype=torch.float32, device=o.device)
    lib = _delta_lib()
    with torch.cuda.device(o.device):
        status = lib.ds_flash_attention_bwd_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, H, T, D, DTYPE_CODE[o.dtype],
            *o.stride()[:3], *do.stride()[:3], _stream())
    _build.check(lib, status, "flash_attention_bwd_delta")
    bwd_delta_launches += 1
    return delta


def _bwd_route(q, k, v, do) -> str:
    """The route of a dq or dk/dv launch on CUDA tensors (:func:`flash_route`)."""
    if not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise TypeError(f"flash_attention backward: q/k/v/dO dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}/{do.dtype} differ")
    return _check_kernel_layout(q, k, v, do)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                           stochastic: bool = False) -> torch.Tensor:
    """dq [B, T, H, D] in q's dtype (the dq kernel: tensor cores for bf16 /
    fp16, their single-cast instance with ``stochastic``; 3xTF32 for fp32)."""
    global bwd_dq_tf32_launches, bwd_dq_tc_launches, bwd_dq_tc_stochastic_launches
    stochastic = _stochastic(q, stochastic)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale, stochastic)
    route = _bwd_route(q, k, v, do)
    B, T, H, D = q.shape
    S = k.shape[1]
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B, H, T, S, D, DTYPE_CODE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            scale, int(bool(causal)))
    with torch.cuda.device(q.device):
        if route == "tc":
            lib = _bwd_tc_lib()
            status = lib.ds_flash_attention_bwd_dq_tc(*args, int(stochastic), _stream())
        else:
            lib = _bwd_tf32_lib()
            status = lib.ds_flash_attention_bwd_dq_tf32(*args, _stream())
    _build.check(lib, status, f"flash_attention_bwd_dq_{route}")
    add_kernel_flops("flash_attention_bwd_dq", attention_flops(B, H, T, S, D))
    if stochastic:
        bwd_dq_tc_stochastic_launches += 1
    elif route == "tc":
        bwd_dq_tc_launches += 1
    else:
        bwd_dq_tf32_launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                            stochastic: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, S, H, D] in k's dtype (the dk/dv kernel: tensor cores for
    bf16 / fp16, their single-cast instance with ``stochastic``; 3xTF32 for
    fp32)."""
    global bwd_dkv_tf32_launches, bwd_dkv_tc_launches, bwd_dkv_tc_stochastic_launches
    stochastic = _stochastic(q, stochastic)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale, stochastic)
    route = _bwd_route(q, k, v, do)
    B, T, H, D = q.shape
    S = k.shape[1]
    dk = torch.empty((B, S, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, S, H, D), dtype=v.dtype, device=v.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, T, S, D,
            DTYPE_CODE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            scale, int(bool(causal)))
    with torch.cuda.device(q.device):
        if route == "tc":
            lib = _bwd_tc_lib()
            status = lib.ds_flash_attention_bwd_dkv_tc(*args, int(stochastic), _stream())
        else:
            lib = _bwd_tf32_lib()
            status = lib.ds_flash_attention_bwd_dkv_tf32(*args, _stream())
    _build.check(lib, status, f"flash_attention_bwd_dkv_{route}")
    add_kernel_flops("flash_attention_bwd_dkv", attention_flops(B, H, T, S, D))
    if stochastic:
        bwd_dkv_tc_stochastic_launches += 1
    elif route == "tc":
        bwd_dkv_tc_launches += 1
    else:
        bwd_dkv_tf32_launches += 1
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        softmax_scale: Optional[float] = None, stochastic: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward from the forward's saved (q, k, v, o, lse [B*H, T]) and
    dO: (dq, dk, dv) in the shapes and dtypes of q, k, v. Three kernel
    launches on a CUDA device (delta, dq, dk/dv), the plain versions on the
    CPU. dq and dk/dv run on the tensor cores (:func:`flash_route`), for
    bf16 / fp16 inputs with ``stochastic`` their single-cast instances."""
    _check(q, k, v)
    if do.shape != q.shape or o.shape != q.shape or lse.shape != (q.shape[0] * q.shape[2],
                                                                  q.shape[1]):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} / dO {tuple(do.shape)} / "
                         f"lse {tuple(lse.shape)} do not match q {tuple(q.shape)}")
    scale = _scale(q, softmax_scale)
    if q.device.type == "cuda":
        do = do.to(q.dtype)
        if not _readable(do):  # autograd may hand dO over in any layout
            do = do.contiguous()
        lse = lse.float().contiguous()
    elif q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    delta = flash_attention_bwd_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale, stochastic)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale, stochastic)
    return dq, dk, dv


def refuse_double_backward(name: str) -> None:
    """Raise where a backward is asked to build a graph of its gradients
    (grad mode is on inside a backward only under ``create_graph=True``)."""
    if torch.is_grad_enabled():
        raise NotImplementedError(
            f"{name} is not twice differentiable: its backward kernels return gradients "
            "without a graph (run the plain attention path, use_flash=False, for "
            "second-order derivatives)")


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: B1 forward, B2 backward from the
    saved logsumexp (the reference's ``custom_vjp`` around ``_flash``).
    On CPU tensors both halves take their plain versions.

    Once differentiable, never twice: the kernels' gradients carry no graph,
    so a backward asked to build one (``create_graph=True``, as a
    Hessian-vector product does) raises ``NotImplementedError`` on every
    device, as the reference's ``custom_vjp`` has no rule for a second
    derivative. Without it the attention term of a second derivative would
    vanish on the card and not on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, softmax_scale: Optional[float],
                stochastic: bool = False):
        o, lse = flash_attention_fwd(q, k, v, causal, softmax_scale, stochastic)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.softmax_scale = softmax_scale
        ctx.stochastic = stochastic
        return o

    @staticmethod
    def backward(ctx, do):
        refuse_double_backward("FlashAttention")
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal, ctx.softmax_scale,
                                         ctx.stochastic)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, softmax_scale: Optional[float] = None,
                    stochastic_mode: bool = False) -> torch.Tensor:
    """Blockwise attention with online softmax; differentiable through
    :class:`FlashAttention`. Where no input needs a gradient (``no_grad``
    scoring and serving) autograd builds no graph, so nothing stays saved.

    ``stochastic_mode`` trades bit-exactness for speed, as the reference's:
    for bf16 / fp16 inputs q is rounded to the input dtype after its scale
    and P, dO and dS are cast once for their products (the kernels' single-
    cast instances); fp32 inputs compute the default function."""
    return FlashAttention.apply(q, k, v, causal, softmax_scale, bool(stochastic_mode))
