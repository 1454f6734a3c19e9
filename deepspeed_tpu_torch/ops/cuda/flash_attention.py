"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``: the forward
(``_fwd`` / ``_fwd_kernel``, B1) is ``csrc/flash_attention_fwd.cu``; the
backward (``_bwd``: ``_bwd_delta_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``, B2) is ``csrc/flash_attention_bwd.cu`` for fp32 inputs
and, for dq and dk/dv on bf16 / fp16 inputs, the tensor-core kernels of
``csrc/flash_attention_bwd_tc.cu`` (delta stays on the first source in every
dtype). Each source's header says how it is split and what bounds it.
:class:`FlashAttention` is the counterpart of the reference's
``jax.custom_vjp`` around ``_flash``: it saves (q, k, v, o, lse) in the
forward and runs the three backward kernels.

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

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernel's template instances
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches since import or the last reset to 0 (chip_smoke.py reads
# them to show that the main path went through the kernels): the forward, and
# the backward's delta, dq and dk/dv passes (dq and dk/dv on fp32 inputs; the
# _tc counters are the tensor-core kernels that bf16 / fp16 inputs take)
launches = 0
bwd_delta_launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0
bwd_dq_tc_launches = 0
bwd_dkv_tc_launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_fwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_flash_attention_fwd.argtypes = (
        [ptr] * 5 + [i32] * 6 + [i64] * 9 + [ctypes.c_float, i32, ptr])
    lib.ds_flash_attention_fwd.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ds_flash_attention_bwd_delta.argtypes = [ptr] * 3 + [i32] * 5 + [i64] * 6 + [ptr]
    lib.ds_flash_attention_bwd_dq.argtypes = (
        [ptr] * 7 + [i32] * 6 + [i64] * 12 + [f32, i32, ptr])
    lib.ds_flash_attention_bwd_dkv.argtypes = (
        [ptr] * 8 + [i32] * 6 + [i64] * 12 + [f32, i32, ptr])
    for fn in (lib.ds_flash_attention_bwd_delta, lib.ds_flash_attention_bwd_dq,
               lib.ds_flash_attention_bwd_dkv):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_tc_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd_tc")
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ds_flash_attention_bwd_dq_tc.argtypes = (
        [ptr] * 7 + [i32] * 6 + [i64] * 12 + [f32, i32, ptr])
    lib.ds_flash_attention_bwd_dkv_tc.argtypes = (
        [ptr] * 8 + [i32] * 6 + [i64] * 12 + [f32, i32, ptr])
    lib.ds_flash_attention_bwd_dq_tc.restype = i32
    lib.ds_flash_attention_bwd_dkv_tc.restype = i32
    return lib


def _scale(q: torch.Tensor, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _visible(T: int, S: int, causal: bool, device) -> Optional[torch.Tensor]:
    """[T, S] bool of the keys each query row sees (bottom-right causal), or None."""
    if not causal:
        return None
    return (torch.arange(S, device=device)[None, :]
            <= torch.arange(T, device=device)[:, None] + (S - T))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``dot_product_attention`` with the
    logsumexp, every operand widened to fp32 as the kernel does
    (``stochastic_mode=False``). Returns (o [B, T, H, D] in q's dtype,
    lse [B*H, T] fp32)."""
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


def _check_kernel_layout(*ts: torch.Tensor) -> None:
    D = ts[0].shape[-1]
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention kernel: head dim {D} (built for {HEAD_DIMS}; other "
            "head dims are ROADMAP.md queue B, B1 follow-up)")
    for t in ts:
        if not _readable(t):
            raise ValueError("flash_attention kernel: the head dim must be contiguous and "
                             f"rows 16-byte aligned (strides {t.stride()}, element size "
                             f"{t.element_size()})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, T, H, D], k/v [B, S, H, D] -> (o [B, T, H, D] in q's dtype,
    lse [B*H, T] fp32). Causal masking is aligned bottom-right: query row t
    sees keys up to t + S - T."""
    global launches
    _check(q, k, v)
    scale = _scale(q, softmax_scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_kernel_layout(q, k, v)
    B, T, H, D = q.shape
    S = k.shape[1]
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        status = lib.ds_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, T, S, D, DTYPE_CODE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            scale, int(bool(causal)), _stream())
    _build.check(lib, status, "flash_attention_fwd")
    launches += 1
    return o, lse


# --------------------------------------------------------------------------- backward
def _probs(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, causal: bool,
           scale: float) -> torch.Tensor:
    """P = exp(scale * q k^T - lse) as [B, H, T, S] fp32, 0 where a key is hidden."""
    B, T, H, _ = q.shape
    S = k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    visible = _visible(T, S, causal, q.device)
    return p if visible is None else p.masked_fill(~visible, 0.0)


def flash_attention_bwd_delta_ref(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Plain version of the delta kernel: rowsum(dO * O) in fp32, [B*H, T]."""
    B, T, H, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * H, T)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool, scale: float
                               ) -> torch.Tensor:
    """Plain version of the dq kernel: dS = P * (dO v^T - delta) * scale,
    dQ = dS k, in q's dtype."""
    B, T, H, _ = q.shape
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta.reshape(B, H, T, 1)) * scale
    return torch.einsum("bhts,bshd->bthd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool, scale: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: dV = P^T dO, dK = dS^T q, in k's
    and v's dtypes."""
    B, T, H, _ = q.shape
    p = _probs(q, k, lse, causal, scale)
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta.reshape(B, H, T, 1)) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            softmax_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, written with its explicit
    formulas (not autograd of the forward), every operand widened to fp32:
    P = exp(S * scale - lse), delta = rowsum(dO * O), dV = P^T dO,
    dS = P * (dO V^T - delta) * scale, dQ = dS K, dK = dS^T Q."""
    scale = _scale(q, softmax_scale)
    delta = flash_attention_bwd_delta_ref(o, do)
    dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


# the tensor-core kernels stream their rows' operands in tiles of this many
# columns; fp16's running row scale changes only between tiles
_TC_TILE = 64


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


def flash_attention_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) as [B*H, T] fp32 (the delta kernel)."""
    global bwd_delta_launches
    if o.device.type == "cpu":
        return flash_attention_bwd_delta_ref(o, do)
    _check_kernel_layout(o, do)
    B, T, H, D = o.shape
    delta = torch.empty((B * H, T), dtype=torch.float32, device=o.device)
    lib = _bwd_lib()
    with torch.cuda.device(o.device):
        status = lib.ds_flash_attention_bwd_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, H, T, D, DTYPE_CODE[o.dtype],
            *o.stride()[:3], *do.stride()[:3], _stream())
    _build.check(lib, status, "flash_attention_bwd_delta")
    bwd_delta_launches += 1
    return delta


def _bwd_route(q, k, v, do) -> Tuple[ctypes.CDLL, bool]:
    """The library of a dq or dk/dv launch on CUDA tensors: the tensor-core
    kernels for bf16 / fp16, the CUDA-core kernels for fp32."""
    _check_kernel_layout(q, k, v, do)
    if not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise TypeError(f"flash_attention backward: q/k/v/dO dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}/{do.dtype} differ")
    tc = q.dtype in (torch.bfloat16, torch.float16)
    return (_bwd_tc_lib() if tc else _bwd_lib()), tc


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float
                           ) -> torch.Tensor:
    """dq [B, T, H, D] in q's dtype (the dq kernel: tensor cores for bf16 /
    fp16, CUDA cores for fp32)."""
    global bwd_dq_launches, bwd_dq_tc_launches
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)
    lib, tc = _bwd_route(q, k, v, do)
    B, T, H, D = q.shape
    S = k.shape[1]
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    fn = lib.ds_flash_attention_bwd_dq_tc if tc else lib.ds_flash_attention_bwd_dq
    with torch.cuda.device(q.device):
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B, H, T, S, D, DTYPE_CODE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            scale, int(bool(causal)), _stream())
    _build.check(lib, status, "flash_attention_bwd_dq" + ("_tc" if tc else ""))
    if tc:
        bwd_dq_tc_launches += 1
    else:
        bwd_dq_launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, S, H, D] in k's dtype (the dk/dv kernel: tensor cores for
    bf16 / fp16, CUDA cores for fp32)."""
    global bwd_dkv_launches, bwd_dkv_tc_launches
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale)
    lib, tc = _bwd_route(q, k, v, do)
    B, T, H, D = q.shape
    S = k.shape[1]
    dk = torch.empty((B, S, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, S, H, D), dtype=v.dtype, device=v.device)
    fn = lib.ds_flash_attention_bwd_dkv_tc if tc else lib.ds_flash_attention_bwd_dkv
    with torch.cuda.device(q.device):
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, T, S, D,
            DTYPE_CODE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            scale, int(bool(causal)), _stream())
    _build.check(lib, status, "flash_attention_bwd_dkv" + ("_tc" if tc else ""))
    if tc:
        bwd_dkv_tc_launches += 1
    else:
        bwd_dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward from the forward's saved (q, k, v, o, lse [B*H, T]) and
    dO: (dq, dk, dv) in the shapes and dtypes of q, k, v. Three kernel
    launches on a CUDA device (delta, dq, dk/dv), the plain versions on the
    CPU. dq and dk/dv run on the tensor cores for bf16 / fp16 inputs."""
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
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: B1 forward, B2 backward from the
    saved logsumexp (the reference's ``custom_vjp`` around ``_flash``).
    On CPU tensors both halves take their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, softmax_scale: Optional[float]):
        o, lse = flash_attention_fwd(q, k, v, causal, softmax_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.softmax_scale = softmax_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal, ctx.softmax_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, softmax_scale: Optional[float] = None,
                    stochastic_mode: bool = False) -> torch.Tensor:
    """Blockwise attention with online softmax; differentiable through
    :class:`FlashAttention`. Where no input needs a gradient (``no_grad``
    scoring and serving) autograd builds no graph, so nothing stays saved.

    ``stochastic_mode`` (bf16 matmul operands) is not ported: it raises
    until the kernel-redesign PR (ROADMAP.md queue B, B1)."""
    if stochastic_mode:
        raise NotImplementedError(
            "flash_attention stochastic_mode is not ported yet "
            "(ROADMAP.md queue B: B1 kernel redesign)")
    return FlashAttention.apply(q, k, v, causal, softmax_scale)
