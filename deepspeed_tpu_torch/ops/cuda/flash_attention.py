"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Counterpart of the forward of ``deepspeed_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` -> ``_fwd`` / ``_fwd_kernel``). The kernel is
``deepspeed_tpu_torch/csrc/flash_attention_fwd.cu``; its header says how it is
split and what bounds it.

:func:`flash_attention_fwd` takes the plain version only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises. The backward
(B2) belongs to the training slice and is not here.
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

# kernel launches since import or the last reset to 0 (chip_smoke.py reads it
# to show that the main path went through the kernel)
launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_fwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_flash_attention_fwd.argtypes = (
        [ptr] * 5 + [i32] * 6 + [i64] * 9 + [ctypes.c_float, i32, ptr])
    lib.ds_flash_attention_fwd.restype = i32
    return lib


def _scale(q: torch.Tensor, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])


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
    if causal:
        visible = (torch.arange(S, device=q.device)[None, :]
                   <= torch.arange(T, device=q.device)[:, None] + (S - T))
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


def _check_kernel_layout(*ts: torch.Tensor) -> None:
    """The kernel reads rows with 16-byte loads through the given strides."""
    D = ts[0].shape[-1]
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention kernel: head dim {D} (built for {HEAD_DIMS}; other "
            "head dims are ROADMAP.md queue B, B1 follow-up)")
    for t in ts:
        es = t.element_size()
        if t.stride(-1) != 1:
            raise ValueError("flash_attention kernel: the head dim must be contiguous")
        if t.data_ptr() % 16 or any((s * es) % 16 for s in t.stride()[:3]):
            raise ValueError("flash_attention kernel: rows must be 16-byte aligned "
                             f"(strides {t.stride()}, element size {es})")


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
            scale, int(bool(causal)), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "flash_attention_fwd")
    launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, softmax_scale: Optional[float] = None,
                    stochastic_mode: bool = False) -> torch.Tensor:
    """Blockwise attention with online softmax (forward only); returns o.

    ``stochastic_mode`` (bf16 matmul operands) is not ported: it raises
    until the kernel-redesign PR (ROADMAP.md queue B, B1)."""
    if stochastic_mode:
        raise NotImplementedError(
            "flash_attention stochastic_mode is not ported yet "
            "(ROADMAP.md queue B: B1 kernel redesign)")
    return flash_attention_fwd(q, k, v, causal, softmax_scale)[0]
