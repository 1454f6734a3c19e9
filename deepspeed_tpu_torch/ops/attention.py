"""Attention ops (counterpart of ``deepspeed_tpu/ops/attention.py``).

This module is the dispatch point; models call :func:`multihead_attention`
and never pick a kernel themselves. An eligible call on a CUDA device goes to
the hand-written flash-attention kernels (``ops/cuda/flash_attention.py``),
which launch or raise; that route is differentiable (the forward kernel and
the three backward kernels under one ``torch.autograd.Function``) and runs
the forward alone where no gradient is wanted. Everything else takes the
plain PyTorch :func:`dot_product_attention`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .cuda.flash_attention import NEG_INF, flash_attention


def causal_mask(q_len: int, kv_len: int, device=None) -> torch.Tensor:
    """[q, kv] bool, aligned bottom-right: query i sees keys up to i + kv_len - q_len."""
    i = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    j = torch.arange(kv_len, device=device)[None, :]
    return j <= i


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, bias: Optional[torch.Tensor] = None,
                          softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q [B, T, H, Dh], k/v [B, S, H, Dh]. fp32 logits and
    softmax whatever the input dtype; the probabilities are cast to v's dtype
    before P V."""
    q_len, head_dim = q.shape[1], q.shape[-1]
    kv_len = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(head_dim)
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        logits = logits.masked_fill(~causal_mask(q_len, kv_len, q.device), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, bias: Optional[torch.Tensor] = None,
                        use_flash: Optional[bool] = None,
                        softmax_scale: Optional[float] = None,
                        stochastic_mode: bool = False) -> torch.Tensor:
    """Kernel dispatch: the flash-attention kernel on CUDA when eligible (or
    forced with ``use_flash=True``), the plain path otherwise."""
    if use_flash is None:
        use_flash = _flash_eligible(q, k, bias)
    elif use_flash and bias is not None:
        # the flash kernel has no bias input; computing without it would be wrong
        from ..utils.logging import warning_once

        warning_once("flash attention forced on but an attention bias is "
                     "present; using the plain attention path")
        use_flash = False
    if use_flash:
        return flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale,
                               stochastic_mode=stochastic_mode)
    return dot_product_attention(q, k, v, causal=causal, bias=bias,
                                 softmax_scale=softmax_scale)


def _flash_eligible(q: torch.Tensor, k: torch.Tensor, bias) -> bool:
    if bias is not None:
        return False
    if q.device.type != "cuda":
        return False
    # the reference's tiling rule: 128-divisible sequence lengths, head dim >= 64
    return q.shape[-1] >= 64 and q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0
