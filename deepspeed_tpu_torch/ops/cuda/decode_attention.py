"""Single-token decode attention over a contiguous KV cache: the hand-written
CUDA kernel and its plain version.

Counterpart of ``decode_attention`` and ``_as_lengths`` in
``deepspeed_tpu/ops/pallas/decode_attention.py``. The kernel is
``deepspeed_tpu_torch/csrc/decode_attention.cu``; its header says how it is
split and what bounds it.

:func:`decode_attention` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Union

import torch

from .. import _build
from .flash_attention import DTYPE_CODE, HEAD_DIMS, NEG_INF

# kernel launches since import or the last reset to 0 (chip_smoke.py reads it
# to show that the main path went through the kernel)
launches = 0

Lengths = Union[int, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_decode_attention.argtypes = (
        [ptr] * 5 + [i32] * 6 + [i64] * 2 + [ctypes.c_float, ptr])
    lib.ds_decode_attention.restype = i32
    return lib


def _as_lengths(cur_len: Lengths, batch: int, device: torch.device) -> torch.Tensor:
    """A scalar length (one for the whole batch) or a [B] per-row vector, as an
    int32 [B] tensor on ``device``."""
    lens = torch.as_tensor(cur_len, dtype=torch.int32, device=device)
    if lens.dim() == 0:
        return lens.expand(batch)
    if lens.shape != (batch,):
        raise ValueError(f"cur_len must be a scalar or [batch]={batch} vector, "
                         f"got shape {tuple(lens.shape)}")
    return lens


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         cur_len: Lengths, softmax_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the fp32 softmax over cache
    positions below each row's length, masked with -1e30. A row of length 0
    gives zeros, as the kernel's l_safe does."""
    B, _, H, Dh = q.shape
    S = k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(Dh)
    lens = _as_lengths(cur_len, B, q.device)
    s = torch.einsum("bthd,bhsd->bhts", q.float() * scale, k_cache.float())
    valid = torch.arange(S, device=q.device)[None, :] < lens[:, None]  # [B, S]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bhsd->bthd", p, v_cache.float())
    return (out * (lens > 0).to(out.dtype)[:, None, None, None]).to(q.dtype)


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q must be [B, 1, H, Dh], got {tuple(q.shape)}")
    B, _, H, Dh = q.shape
    if (k_cache.dim() != 4 or k_cache.shape != v_cache.shape
            or k_cache.shape[:2] != (B, H) or k_cache.shape[3] != Dh):
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in DTYPE_CODE:
        raise TypeError(f"decode_attention: q/k/v dtypes {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}; expected one of float32, bfloat16, float16 "
                        "for all three (cast q to the cache dtype)")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("decode_attention: q and the caches on different devices")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: Lengths, softmax_scale: Optional[float] = None
                     ) -> torch.Tensor:
    """q [B, 1, H, Dh] (the new token's query), k/v cache [B, H, S, Dh],
    ``cur_len`` an int or an int32 scalar or [B] tensor: the valid entries
    INCLUDING the new token, whose k/v must already be in the cache.
    Returns [B, 1, H, Dh] in q's dtype."""
    global launches
    _check(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cur_len, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, _, H, Dh = q.shape
    S = k_cache.shape[2]
    if Dh not in HEAD_DIMS:
        raise NotImplementedError(
            f"decode_attention kernel: head dim {Dh} (built for {HEAD_DIMS}; other "
            "head dims are ROADMAP.md queue B, B3 follow-up)")
    if q.stride(-1) != 1 or not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention kernel: q's head dim and the caches "
                         "must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention kernel: caches must be 16-byte aligned")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(Dh)
    if isinstance(cur_len, int):
        lens, lens_ptr, scalar = None, None, max(0, min(cur_len, S))
    else:
        lens = _as_lengths(cur_len, B, q.device).contiguous()
        lens_ptr, scalar = lens.data_ptr(), 0
    o = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        status = lib.ds_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
            lens_ptr, scalar, B, H, S, Dh, DTYPE_CODE[q.dtype],
            q.stride(0), q.stride(2), scale, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "decode_attention")
    launches += 1
    return o
