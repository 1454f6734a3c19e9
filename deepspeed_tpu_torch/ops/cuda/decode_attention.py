"""Decode attention over a KV cache (one token, or a speculation window):
the hand-written CUDA kernels and their plain versions.

Counterpart of ``decode_attention``, ``paged_decode_attention``,
``paged_verify_attention``, ``unpack_kv_int4`` and ``_as_lengths`` in
``deepspeed_tpu/ops/pallas/decode_attention.py``. Three kernels:

- :func:`decode_attention` (B3) over a contiguous ``[B, H, S, Dh]`` cache,
  ``deepspeed_tpu_torch/csrc/decode_attention.cu``;
- :func:`paged_decode_attention` (B4) through a block table over a shared
  page pool, dense or quantized (int8, nibble-packed int4),
  ``deepspeed_tpu_torch/csrc/paged_decode_attention.cu``;
- :func:`paged_verify_attention` (B5), a speculation window of W queries
  per row over the same pools plus the window's own dense K/V,
  ``deepspeed_tpu_torch/csrc/paged_verify_attention.cu``.

Each source's header says how it is split and what bounds it. All three
split each row's cache over several blocks and merge the partials in the same
launch (:func:`split_plan`; the workspace is cached per device and shape,
:func:`_workspace`). The wrappers take the plain version only for tensors on
the CPU (or, for the paged ones, when asked with ``impl="gather"``); for
CUDA tensors they launch the kernel or raise. All are inference-only and
raise where autograd would differentiate them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple, Union

import torch

from .. import _build
from .flash_attention import DTYPE_CODE, HEAD_DIMS, NEG_INF, _readable
from .int8_matmul import unpack_int4

# kernel launches since import or the last reset to 0 (chip_smoke.py reads
# them to show that a main path went through the kernels): B3, and B4 and B5
# by pool layout (dense, int8, int4)
launches = 0
paged_launches = 0
paged_kv8_launches = 0
paged_kv4_launches = 0
verify_launches = 0
verify_kv8_launches = 0
verify_kv4_launches = 0

Lengths = Union[int, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_decode_attention.argtypes = (
        [ptr] * 5 + [i32] * 6 + [i64] * 2 + [ctypes.c_float] + [i32] * 2 + [ptr] * 4)
    lib.ds_decode_attention.restype = i32
    return lib


# the smallest split of a row's cache (positions), the split's granularity
# (B5's tensor-core tile), and the blocks per SM a grid need not exceed
SPLIT_MIN_SPAN = 128
SPLIT_TILE = 64
SPLIT_BLOCKS_PER_SM = 4


def split_plan(rows: int, capacity: int, sms: int) -> Tuple[int, int]:
    """(n_split, span): how B3, B4 and B5 split each of ``rows`` (b, h) rows'
    ``capacity`` cache positions. Splits of at least SPLIT_MIN_SPAN positions,
    as many as fill about SPLIT_BLOCKS_PER_SM blocks an SM and no more, each a
    multiple of SPLIT_TILE, ``n_split * span >= capacity``. Shapes only: the
    lengths stay on the device (reading them would stall the host's decode
    loop), and a split past a row's length is skipped by the kernel."""
    n = max(1, min(-(-capacity // SPLIT_MIN_SPAN), -(-SPLIT_BLOCKS_PER_SM * sms // rows)))
    span = max(SPLIT_TILE, -(-capacity // n // SPLIT_TILE) * SPLIT_TILE)
    return max(1, -(-capacity // span)), span


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORKSPACES: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, kernel: str, rows: int, n_split: int, per_split: int,
               D: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split kernels' scratch, cached per device and shape: fp32 partial
    (m, l) pairs [rows * n_split * per_split * 2] and sums [rows * n_split *
    per_split * D] (per_split window rows, 1 for B3 and B4), and int32 tickets [rows]
    that start at 0 and that the kernel's last split of a row resets to 0.
    Launches on one stream use it in turn."""
    key = (device, kernel, rows, n_split, per_split, D)
    if key not in _WORKSPACES:
        n = rows * n_split * per_split
        _WORKSPACES[key] = (torch.empty(2 * n, dtype=torch.float32, device=device),
                            torch.empty(n * D, dtype=torch.float32, device=device),
                            torch.zeros(rows, dtype=torch.int32, device=device))
    return _WORKSPACES[key]


@functools.lru_cache(maxsize=None)
def _paged_lib() -> ctypes.CDLL:
    lib = _build.load("paged_decode_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_paged_decode_attention.argtypes = (
        [ptr] * 8 + [i32] * 8 + [i64] * 2 + [ctypes.c_float] + [i32] * 2 + [ptr] * 4)
    lib.ds_paged_decode_attention.restype = i32
    return lib


def _refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is inference-only and has no backward: call it "
                           "under torch.no_grad() or on tensors that do not require grad")


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
    Returns [B, 1, H, Dh] in q's dtype.

    Inference only: the kernel's output has no gradient, so a call that
    autograd would differentiate raises (on the CPU as well, so that the
    two devices agree) rather than cut the graph without a word."""
    global launches
    _check(q, k_cache, v_cache)
    _refuse_autograd("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cur_len, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, _, H, Dh = q.shape
    S = k_cache.shape[2]
    if Dh not in HEAD_DIMS:
        raise NotImplementedError(
            f"decode_attention kernel: head dim {Dh} (built for {HEAD_DIMS}, the head "
            "dims of the reference's presets)")
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
        n_split, span = split_plan(B * H, S, _sm_count(q.device.index or 0))
        ws_ml, ws_acc, tickets = _workspace(q.device, "decode", B * H, n_split, 1, Dh)
        status = lib.ds_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
            lens_ptr, scalar, B, H, S, Dh, DTYPE_CODE[q.dtype],
            q.stride(0), q.stride(2), scale, n_split, span, ws_ml.data_ptr(),
            ws_acc.data_ptr(), tickets.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "decode_attention")
    launches += 1
    return o


# ------------------------------------------------------------------ paged (B4)
# kv_mode codes of csrc/paged_decode_attention.cu by quantization width
_KV_MODE = {None: 0, 8: 8, 4: 4}


def unpack_kv_int4(packed: torch.Tensor) -> torch.Tensor:
    """Two int4 values per int8 byte, half-split along the last dim (the
    ``int8_matmul.pack_int4`` layout), widened to float32."""
    return unpack_int4(packed).float()


def _pool_bits(k_pages: torch.Tensor, k_scales, v_scales, head_dim: int) -> Optional[int]:
    """The pool's quantization width (None = dense), with the reference's checks."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if k_scales is None:
        return None
    if k_pages.shape[-1] * 2 == head_dim:
        return 4
    if k_pages.shape[-1] != head_dim:
        raise ValueError(
            f"quantized pool last dim {k_pages.shape[-1]} matches neither int8 "
            f"({head_dim}) nor packed int4 ({head_dim // 2})")
    return 8


def gather_pages(pages: torch.Tensor, scales: Optional[torch.Tensor],
                  tables: torch.Tensor, head_dim: int) -> torch.Tensor:
    """[H, P, ps, Dq] pool -> [B, H, pages * ps, Dh]: each row's pages in
    table order, dequantized against ``scales[:, tables]`` when quantized."""
    g = pages[:, tables]  # [H, B, n, ps, Dq]
    if scales is not None:
        g = unpack_kv_int4(g) if g.shape[-1] * 2 == head_dim else g.float()
        g = g * scales[:, tables][..., None, None]
    g = g.permute(1, 0, 2, 3, 4)
    return g.reshape(g.shape[0], g.shape[1], -1, head_dim)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, lengths: Lengths,
                               block_tables: torch.Tensor,
                               softmax_scale: Optional[float] = None,
                               k_scales: Optional[torch.Tensor] = None,
                               v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the paged kernel (the counterpart of
    ``_paged_gather_attention``): gather each row's pages contiguously,
    dequantize quantized pools, then exactly :func:`decode_attention_ref`'s
    masked fp32 softmax, so the result is bitwise that of the contiguous
    formula over the gathered cache. A row of length 0 gives zeros."""
    Dh = q.shape[-1]
    tables = block_tables.long()
    k = gather_pages(k_pages, k_scales, tables, Dh)
    v = gather_pages(v_pages, v_scales, tables, Dh)
    return decode_attention_ref(q, k, v, lengths, softmax_scale)


def _check_pool_shapes(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor) -> None:
    B, H = q.shape[0], q.shape[2]
    if (k_pages.dim() != 4 or k_pages.shape != v_pages.shape or k_pages.shape[0] != H
            or block_tables.dim() != 2 or block_tables.shape[0] != B):
        raise ValueError(f"{name}: pools {tuple(k_pages.shape)} / {tuple(v_pages.shape)} and "
                         f"tables {tuple(block_tables.shape)} do not match q {tuple(q.shape)}")


def _check_paged_kernel(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor, bits: Optional[int],
                        k_scales, v_scales) -> None:
    """What the paged kernels (B4, B5) take: CUDA tensors on one device, head
    dim 64, 96 or 128, q in fp32/bf16/fp16, dense pools in q's dtype or int8
    pools with contiguous fp32 [H, P] scales, q's head dim contiguous, the
    pools contiguous and 16-byte aligned."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernel: needs CUDA tensors, got {q.device}")
    H, Dh = q.shape[2], q.shape[3]
    P = k_pages.shape[1]
    if Dh not in HEAD_DIMS:
        raise NotImplementedError(
            f"{name} kernel: head dim {Dh} (built for {HEAD_DIMS}, the head dims of "
            "the reference's presets)")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"{name} kernel: q dtype {q.dtype}; expected "
                        "float32, bfloat16 or float16")
    if bits is None and not (k_pages.dtype == v_pages.dtype == q.dtype):
        raise TypeError(f"{name} kernel: dense pools {k_pages.dtype}/"
                        f"{v_pages.dtype} must have q's dtype {q.dtype}")
    if bits is not None:
        if not (k_pages.dtype == v_pages.dtype == torch.int8):
            raise TypeError(f"{name} kernel: quantized pools must be int8")
        if (k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32
                or k_scales.shape != (H, P) or v_scales.shape != (H, P)
                or not (k_scales.is_contiguous() and v_scales.is_contiguous())):
            raise ValueError(f"{name} kernel: scales must be contiguous "
                             f"float32 [H, P] = {(H, P)}")
    pools = (k_pages, v_pages) + ((k_scales, v_scales) if bits is not None else ())
    if any(t.device != q.device for t in pools + (block_tables,)):
        raise ValueError(f"{name}: q, pools and tables on different devices")
    if q.stride(-1) != 1 or not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError(f"{name} kernel: q's head dim and the pools must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name} kernel: pools must be 16-byte aligned")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           lengths: Lengths, block_tables: torch.Tensor,
                           softmax_scale: Optional[float] = None, impl: Optional[str] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention reading K/V through a block table.

    q [B, 1, H, Dh]; k/v pages one layer's pool [H, P, page_size, Dh] (dense,
    in q's dtype), or int8 [H, P, page_size, Dh] / nibble-packed int4
    [H, P, page_size, Dh // 2] with fp32 ``k_scales``/``v_scales`` [H, P];
    ``lengths`` an int or an int32 [B] tensor of valid tokens INCLUDING the
    new one; ``block_tables`` int32 [B, pages_per_seq] of valid page ids
    (page 0, the sink, past a row's length). Returns [B, 1, H, Dh] in q's
    dtype.

    ``impl``: None launches the kernel for CUDA tensors and takes the plain
    version for CPU tensors; "gather" is the plain version on any device (the
    comparison path); "kernel" insists on the kernel and raises on the CPU.
    Inference only: a call autograd would differentiate raises."""
    global paged_launches, paged_kv8_launches, paged_kv4_launches
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention: q must be [B, 1, H, Dh], got {tuple(q.shape)}")
    B, _, H, Dh = q.shape
    bits = _pool_bits(k_pages, k_scales, v_scales, Dh)
    _check_pool_shapes("paged_decode_attention", q, k_pages, v_pages, block_tables)
    _refuse_autograd("paged_decode_attention", q, k_pages, v_pages)
    if impl not in (None, "kernel", "gather"):
        raise ValueError(f"impl must be None, 'kernel' or 'gather': {impl!r}")
    if impl == "gather" or (impl is None and q.device.type == "cpu"):
        return paged_decode_attention_ref(q, k_pages, v_pages, lengths, block_tables,
                                          softmax_scale, k_scales, v_scales)
    _check_paged_kernel("paged_decode_attention", q, k_pages, v_pages, block_tables, bits,
                        k_scales, v_scales)
    P, ps = k_pages.shape[1], k_pages.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(Dh)
    lens = _as_lengths(lengths, B, q.device).contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    o = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    lib = _paged_lib()
    with torch.cuda.device(q.device):
        n_split, span = split_plan(B * H, tables.shape[1] * ps, _sm_count(q.device.index or 0))
        ws_ml, ws_acc, tickets = _workspace(q.device, "paged", B * H, n_split, 1, Dh)
        status = lib.ds_paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if bits is not None else None,
            v_scales.data_ptr() if bits is not None else None,
            o.data_ptr(), lens.data_ptr(), tables.data_ptr(), B, H, P, ps,
            tables.shape[1], Dh, DTYPE_CODE[q.dtype], _KV_MODE[bits],
            q.stride(0), q.stride(2), scale, n_split, span, ws_ml.data_ptr(),
            ws_acc.data_ptr(), tickets.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "paged_decode_attention")
    if bits is None:
        paged_launches += 1
    elif bits == 8:
        paged_kv8_launches += 1
    else:
        paged_kv4_launches += 1
    return o


# ------------------------------------------------------------ verify window (B5)
# the widest window the kernel takes: spec_k 16 drafts + the verified token
VERIFY_MAX_WINDOW = 17


@functools.lru_cache(maxsize=None)
def _verify_lib() -> ctypes.CDLL:
    lib = _build.load("paged_verify_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_paged_verify_attention.argtypes = (
        [ptr] * 10 + [i32] * 9 + [i64] * 9 + [ctypes.c_float] + [i32] * 2 + [ptr] * 4)
    lib.ds_paged_verify_attention.restype = i32
    return lib


def paged_verify_attention_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                               lengths: Lengths, block_tables: torch.Tensor,
                               win_k: torch.Tensor, win_v: torch.Tensor,
                               softmax_scale: Optional[float] = None,
                               k_scales: Optional[torch.Tensor] = None,
                               v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the verify kernel (the counterpart of
    ``_paged_verify_gather``): gather each row's pages contiguously and
    dequantize them, scatter the window K/V at their absolute positions
    ``lengths[b] + i`` (gathered order is table order), DROPPING the
    positions at or past the gathered length S (never clipping them onto S -
    1, where a rejected draft's K/V would overwrite a committable token's),
    then the masked fp32 softmax of :func:`decode_attention_ref` with limit
    ``lengths[b] + i + 1`` per window query. At W = 1 over a pool that holds
    the window token it is bitwise :func:`paged_decode_attention_ref` at
    ``lengths + 1``."""
    B, W, H, Dh = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(Dh)
    tables = block_tables.long()
    k = gather_pages(k_pages, k_scales, tables, Dh)  # [B, H, S, Dh], a copy of the pool's rows
    v = gather_pages(v_pages, v_scales, tables, Dh)
    S = k.shape[2]
    lens = _as_lengths(lengths, B, q.device).long()
    pos = lens[:, None] + torch.arange(W, device=q.device)[None, :]  # [B, W]
    keep = pos < S
    rows = torch.arange(B, device=q.device)[:, None].expand(B, W)[keep]
    k[rows, :, pos[keep]] = win_k[keep].to(k.dtype)
    v[rows, :, pos[keep]] = win_v[keep].to(v.dtype)
    s = torch.einsum("bwhd,bhsd->bhws", q.float() * scale, k.float())
    limit = pos + 1  # query i sees the history, the window prefix and itself
    mask = torch.arange(S, device=q.device)[None, None, :] < limit[:, :, None]  # [B, W, S]
    s = s.masked_fill(~mask[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhws,bhsd->bwhd", p, v.float()).to(q.dtype)


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           lengths: Lengths, block_tables: torch.Tensor,
                           win_k: torch.Tensor, win_v: torch.Tensor,
                           softmax_scale: Optional[float] = None, impl: Optional[str] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Speculative-decoding verify attention: a W-token window per row in
    one call.

    q, ``win_k``, ``win_v`` [B, W, H, Dh]: the window's queries and its dense
    post-rope keys and values; window position i sits at absolute position
    ``lengths[b] + i`` and attends the pool history (positions below
    ``lengths[b]``, the pool tokens BEFORE the window, read through
    ``block_tables`` and dequantized as :func:`paged_decode_attention` does)
    plus window positions 0..i. The pools (as for
    :func:`paged_decode_attention`) are read-only: the window's accepted
    prefix is committed later (``models.gpt.commit_window_kv``). For dense
    pools the window is first cast to the pool dtype, the bits a committed
    window token would have. Returns [B, W, H, Dh] in q's dtype.

    ``impl``: None launches the kernel (B5) for CUDA tensors and takes the
    plain version for CPU tensors; "gather" is the plain version on any
    device; "kernel" insists on the kernel. The two differ only at window
    positions at or past the table's capacity, which the plain version
    drops and the kernel attends; those are never committed. Inference
    only: a call autograd would differentiate raises."""
    global verify_launches, verify_kv8_launches, verify_kv4_launches
    if q.dim() != 4:
        raise ValueError(f"paged_verify_attention: q must be [B, W, H, Dh], got {tuple(q.shape)}")
    B, W, H, Dh = q.shape
    if win_k.shape != (B, W, H, Dh) or win_v.shape != (B, W, H, Dh):
        raise ValueError(f"win_k/win_v must be [B, W, H, Dh]={(B, W, H, Dh)}, got "
                         f"{tuple(win_k.shape)} / {tuple(win_v.shape)}")
    bits = _pool_bits(k_pages, k_scales, v_scales, Dh)
    _check_pool_shapes("paged_verify_attention", q, k_pages, v_pages, block_tables)
    _refuse_autograd("paged_verify_attention", q, k_pages, v_pages, win_k, win_v)
    if impl not in (None, "kernel", "gather"):
        raise ValueError(f"impl must be None, 'kernel' or 'gather': {impl!r}")
    if bits is None:
        win_k, win_v = win_k.to(k_pages.dtype), win_v.to(v_pages.dtype)
    if impl == "gather" or (impl is None and q.device.type == "cpu"):
        return paged_verify_attention_ref(q, k_pages, v_pages, lengths, block_tables,
                                          win_k, win_v, softmax_scale, k_scales, v_scales)
    _check_paged_kernel("paged_verify_attention", q, k_pages, v_pages, block_tables, bits,
                        k_scales, v_scales)
    if not 1 <= W <= VERIFY_MAX_WINDOW:
        raise ValueError(f"paged_verify_attention kernel: window {W} outside "
                         f"[1, {VERIFY_MAX_WINDOW}] (spec_k <= 16)")
    if win_k.dtype != q.dtype or win_v.dtype != q.dtype:
        raise TypeError(f"paged_verify_attention kernel: window {win_k.dtype}/{win_v.dtype} "
                        f"must have q's dtype {q.dtype}")
    if win_k.device != q.device or win_v.device != q.device:
        raise ValueError("paged_verify_attention: q and the window on different devices")
    if win_k.stride(-1) != 1 or win_v.stride(-1) != 1:
        raise ValueError("paged_verify_attention kernel: the window's head dim must be "
                         "contiguous")
    # the kernel copies the window's rows with 16-byte copies
    win_k, win_v = (w if _readable(w) else w.contiguous() for w in (win_k, win_v))
    P, ps = k_pages.shape[1], k_pages.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(Dh)
    lens = _as_lengths(lengths, B, q.device).contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    o = torch.empty((B, W, H, Dh), dtype=q.dtype, device=q.device)
    strides = [t.stride(i) for t in (q, win_k, win_v) for i in (0, 1, 2)]
    lib = _verify_lib()
    with torch.cuda.device(q.device):
        n_split, span = split_plan(B * H, tables.shape[1] * ps, _sm_count(q.device.index or 0))
        ws_ml, ws_acc, tickets = _workspace(q.device, "verify", B * H, n_split,
                                            VERIFY_MAX_WINDOW, Dh)
        status = lib.ds_paged_verify_attention(
            q.data_ptr(), win_k.data_ptr(), win_v.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), k_scales.data_ptr() if bits is not None else None,
            v_scales.data_ptr() if bits is not None else None, o.data_ptr(), lens.data_ptr(),
            tables.data_ptr(), B, W, H, P, ps, tables.shape[1], Dh, DTYPE_CODE[q.dtype],
            _KV_MODE[bits], *strides, scale, n_split, span, ws_ml.data_ptr(),
            ws_acc.data_ptr(), tickets.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "paged_verify_attention")
    if bits is None:
        verify_launches += 1
    elif bits == 8:
        verify_kv8_launches += 1
    else:
        verify_kv4_launches += 1
    return o
