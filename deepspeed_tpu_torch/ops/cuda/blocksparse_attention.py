"""Blocksparse attention (kernel B9): the hand-written CUDA kernels and their
plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/blocksparse_attention.py``:
attention restricted to the active blocks of a static ``[H, T/block,
T/block]`` 0/1 layout, with flash-style online softmax, so neither the dense
``[T, T]`` scores nor the score blocks reach device memory. Every pass runs
on the tensor cores at every block (16, 32, 64, 128): the forward (``_fwd`` /
``_fwd_kernel``) and the backward's two passes (``_bwd_dq_kernel``,
``_bwd_dkv_kernel``; the dq pass also writes delta = rowsum(dO * O) for the
dk/dv pass) are ``csrc/blocksparse_attention_{fwd,bwd}_tc.cu`` for bf16 /
fp16, which keep the reference's fp32 function from 16-bit operands (P and
dS as hi + lo halves; :func:`blocksparse_attention_split_ref` and
:func:`blocksparse_attention_bwd_split_ref` model their rounding), and
``csrc/blocksparse_attention_{fwd,bwd}_tf32.cu`` for fp32, as 3xTF32
(:func:`blocksparse_attention_fwd_tf32_ref` and
:func:`blocksparse_attention_bwd_tf32_ref` model them). :func:`bs_route`
names each pass's kernels. Each source's header says how it is split and
what bounds it.
:class:`BlocksparseAttention` is the counterpart of the reference's
``jax.custom_vjp`` around ``_bs_attn``: it saves (q, k, v, o, lse) and the
index tables in the forward and runs dq, then dk/dv.

The layout reaches every kernel as :func:`tile_tables`: the layout at the
kernels' 64-token tiles with a bit mask of active sub-blocks per tile
(blocks of 16 and 32 share a tile), each with its work order
(:func:`work_order`), moved to the device once by the caller that keeps them
(:func:`device_tables`, ``ops/sparse_attention``); the forward and dq walk
each query tile's list of key tiles, dk/dv each key tile's list of query
tiles. :func:`blocksparse_attention_fwd_tiles_ref` and
:func:`blocksparse_attention_bwd_tiles_ref` are plain models of those walks.
:func:`layout_tables` (bitwise the reference's block lists) stays for the
tests. ``causal`` masks keys after the query (T == S, aligned top-left);
blocks above the diagonal of a bidirectional layout are then wholly masked
and the kernels skip them.

Every wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its route's kernel or raises: the kernels are built for
blocks of 16, 32, 64 and 128 and head dims 64, 96 and 128.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from . import flash_attention as fa
from .flash_attention import DTYPE_CODE, NEG_INF, _readable, _stream

BLOCKS = (16, 32, 64, 128)  # the kernels' block sizes
HEAD_DIMS = (64, 96, 128)  # the kernels' template instances
TILE = 64  # the kernels' tile: 64 queries x 64 keys, of one or more blocks

# kernel launches since import or the last reset to 0 (chip_smoke.py reads
# them to show that the main path went through the kernels): the forward,
# dq and dk/dv passes by route, bf16 / fp16 on the tensor cores ("tc") and
# fp32 as 3xTF32 on them ("tf32")
fwd_tc_launches = 0
fwd_tf32_launches = 0
bwd_dq_tc_launches = 0
bwd_dkv_tc_launches = 0
bwd_dq_tf32_launches = 0
bwd_dkv_tf32_launches = 0


class Tables(NamedTuple):
    """A layout's :func:`tile_tables` as int32 tensors on one device, with
    their work orders (the forward and dq walk each 64-query tile's list of
    64-key tiles, dk/dv each key tile's list of query tiles)."""
    qt_idx: torch.Tensor
    qt_cnt: torch.Tensor
    qt_mask: torch.Tensor
    qt_order: torch.Tensor
    kt_idx: torch.Tensor
    kt_cnt: torch.Tensor
    kt_mask: torch.Tensor
    kt_order: torch.Tensor


@functools.lru_cache(maxsize=None)
def _fwd_lib(route: str) -> ctypes.CDLL:
    """The forward's library of ``route``: "tc" (bf16 / fp16) or "tf32"
    (fp32); both take the same arguments."""
    lib = _build.load(f"blocksparse_attention_fwd_{route}")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = getattr(lib, f"ds_blocksparse_attention_fwd_{route}")
    fn.argtypes = [ptr] * 9 + [i32] * 7 + [i64] * 9 + [ctypes.c_float, i32, ptr]
    fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib(route: str) -> ctypes.CDLL:
    """The backward's library of ``route``: "tc" (bf16 / fp16) or "tf32"
    (fp32); both take the same arguments."""
    lib = _build.load(f"blocksparse_attention_bwd_{route}")
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    dq, dkv = (getattr(lib, f"ds_blocksparse_attention_bwd_{p}_{route}") for p in ("dq", "dkv"))
    dq.argtypes = [ptr] * 12 + [i32] * 7 + [i64] * 15 + [f32, i32, ptr]
    dkv.argtypes = [ptr] * 12 + [i32] * 7 + [i64] * 12 + [f32, i32, ptr]
    dq.restype = dkv.restype = i32
    return lib


def layout_tables(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Static index tables from a [H, nQ, nK] 0/1 layout.

    Returns (kidx [H,nQ,A], kcnt [H,nQ], qidx [H,nK,Aq], qcnt [H,nK]) int32,
    padded with 0 (padding entries are never read: the loop bound is the
    count); the active indices are ascending."""
    H, nQ, nK = layout.shape
    max_k = max(1, int(layout.sum(axis=2).max()))
    max_q = max(1, int(layout.sum(axis=1).max()))
    kidx = np.zeros((H, nQ, max_k), np.int32)
    kcnt = np.zeros((H, nQ), np.int32)
    qidx = np.zeros((H, nK, max_q), np.int32)
    qcnt = np.zeros((H, nK), np.int32)
    for h in range(H):
        for i in range(nQ):
            cols = np.nonzero(layout[h, i])[0]
            kidx[h, i, : len(cols)] = cols
            kcnt[h, i] = len(cols)
        for j in range(nK):
            rows = np.nonzero(layout[h, :, j])[0]
            qidx[h, j, : len(rows)] = rows
            qcnt[h, j] = len(rows)
    return kidx, kcnt, qidx, qcnt


def work_order(cnt: np.ndarray) -> np.ndarray:
    """The (head, block) pairs of a [H, n] count table as flat indices h * n
    + i, the largest count first (ties in index order): the order in which
    the tensor-core kernels hand out their tiles, so that the longest lists
    start first and the short ones fill the tail."""
    return np.argsort(-np.asarray(cnt).reshape(-1), kind="stable").astype(np.int32)


def tile_masks(layout: np.ndarray, block: int) -> np.ndarray:
    """[H, nT, nT] int32, nT = ceil(T / 64): for each (64-query tile, 64-key
    tile) of a [H, T/block, T/block] layout, the bit mask of its active
    block x block sub-blocks: bit r g + c for query sub-block r and key
    sub-block c, g = 64 / block (16 bits at a block of 16, 4 at 32; sub-blocks
    past T are clear). A block of 64 or 128 covers whole tiles: 1 where its
    block is active. 0 where the tile holds no active block."""
    lay = np.asarray(layout).astype(bool)
    H, n, _ = lay.shape
    if block >= TILE:
        f = block // TILE
        return np.repeat(np.repeat(lay, f, 1), f, 2).astype(np.int32)
    g = TILE // block
    nT = -(-n // g)
    padded = np.zeros((H, nT * g, nT * g), bool)
    padded[:, :n, :n] = lay
    sub = padded.reshape(H, nT, g, nT, g).transpose(0, 1, 3, 2, 4).reshape(H, nT, nT, g * g)
    return (sub.astype(np.int64) << np.arange(g * g)).sum(-1).astype(np.int32)


def _tile_lists(masks: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """idx [H, n, A] (the ascending columns of each row with a nonzero mask,
    padded with 0), cnt [H, n] and their masks [H, n, A] of a [H, n, m] mask
    table."""
    H, n, _ = masks.shape
    cnt = (masks != 0).sum(-1).astype(np.int32)
    A = max(1, int(cnt.max()))
    idx = np.zeros((H, n, A), np.int32)
    msk = np.zeros((H, n, A), np.int32)
    for h in range(H):
        for i in range(n):
            cols = np.nonzero(masks[h, i])[0]
            idx[h, i, : len(cols)] = cols
            msk[h, i, : len(cols)] = masks[h, i, cols]
    return idx, cnt, msk


def tile_tables(layout: np.ndarray, block: int) -> Tuple[np.ndarray, ...]:
    """The kernels' tables of a [H, T/block, T/block] layout, at their
    64-token tiles (:func:`tile_masks`): (qt_idx [H, nT, A], qt_cnt
    [H, nT], qt_mask [H, nT, A]) the ascending key tiles of each query tile
    that hold an active sub-block, with their masks; (kt_idx, kt_cnt,
    kt_mask) the same for each key tile's query tiles (the masks' bits keep
    the query-major order). int32, padded with 0 past each count."""
    masks = tile_masks(layout, block)
    return (*_tile_lists(masks), *_tile_lists(masks.transpose(0, 2, 1)))


def device_tables(layout: np.ndarray, block: int, device) -> Tables:
    """:func:`tile_tables` and the work orders of their two counts
    (:func:`work_order`) as int32 tensors on ``device``."""
    qt_idx, qt_cnt, qt_mask, kt_idx, kt_cnt, kt_mask = tile_tables(np.asarray(layout), block)
    tables = (qt_idx, qt_cnt, qt_mask, work_order(qt_cnt), kt_idx, kt_cnt, kt_mask,
              work_order(kt_cnt))
    return Tables(*(torch.from_numpy(t).to(device) for t in tables))


def _scale(q: torch.Tensor, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def layout_mask(layout, block: int, causal: bool, device) -> torch.Tensor:
    """[H, T, T] bool: the layout expanded to elements (``layout ⊗
    ones(block, block)``), and under ``causal`` keys at or before the query."""
    lay = torch.as_tensor(np.asarray(layout), device=device).bool()
    vis = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        T = vis.shape[-1]
        vis = vis & torch.ones((T, T), dtype=torch.bool, device=device).tril()
    return vis


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout, block: int) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"blocksparse_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} must all be [B, T, H, D]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODE:
        raise TypeError(f"blocksparse_attention: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "expected one of float32, bfloat16, float16 for all three")
    if not (q.device == k.device == v.device):
        raise ValueError("blocksparse_attention: q, k, v on different devices")
    B, T, H, D = q.shape
    if tuple(np.shape(layout)) != (H, T // block, T // block):
        raise ValueError(
            f"layout {tuple(np.shape(layout))} != (H={H}, {T // block}, {T // block})")
    if T % block:
        raise ValueError(f"blocksparse_attention: T={T} is not a multiple of block {block}")


def bs_route(dtype: torch.dtype, block: int, head_dim: int, pass_: str) -> str:
    """The kernels CUDA inputs of ``dtype``, ``block`` and ``head_dim`` take
    in ``pass_`` "fwd" (the forward) or "bwd" (dq and dk/dv): "tc" (the
    tensor cores on 16-bit operands) for bf16 / fp16 and "tf32" (3xTF32 on
    the tensor cores) for fp32, in both passes, at every block and head dim
    the kernels are built for. Other blocks and head dims raise
    NotImplementedError, other dtypes TypeError, other passes ValueError:
    nothing falls back."""
    if block not in BLOCKS or head_dim not in HEAD_DIMS:
        raise NotImplementedError(
            f"blocksparse_attention kernel: block {block}, head dim {head_dim} (built for "
            f"blocks {BLOCKS} and head dims {HEAD_DIMS}, the head dims of the reference's "
            "presets)")
    if dtype not in DTYPE_CODE:
        raise TypeError(f"blocksparse_attention kernel: dtype {dtype} (built for "
                        f"{tuple(DTYPE_CODE)})")
    if pass_ not in ("fwd", "bwd"):
        raise ValueError(f"bs_route: pass {pass_!r} (fwd or bwd)")
    return "tf32" if dtype == torch.float32 else "tc"


def _check_kernel(block: int, pass_: str, *ts: torch.Tensor) -> str:
    """The route of ``ts[0]`` in ``pass_`` (:func:`bs_route`), after checking
    that the kernels can read every tensor of ``ts``."""
    route = bs_route(ts[0].dtype, block, ts[0].shape[-1], pass_)
    for t in ts:
        if not _readable(t):
            raise ValueError("blocksparse_attention kernel: the head dim must be contiguous "
                             f"and rows 16-byte aligned (strides {t.stride()}, element size "
                             f"{t.element_size()})")
    return route


# --------------------------------------------------------------------------- plain versions
def blocksparse_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout,
                                  block: int, causal: bool = True,
                                  softmax_scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward: dense attention masked by the
    expanded layout (and the causal mask), every operand widened to fp32.
    A row with no visible key gives o = 0 and lse = -1e30, as the kernel's
    ``l_safe`` does. Returns (o [B, T, H, D] in q's dtype, lse [B*H, T] fp32)."""
    B, T, H, D = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.float() * _scale(q, softmax_scale), k.float())
    vis = layout_mask(layout, block, causal, q.device)
    s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~vis, 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhts,bshd->bthd", p / l_safe, v.float()).to(q.dtype)
    return o, (m + torch.log(l_safe)).reshape(B * H, T)


def _probs(q, k, lse, layout, block: int, causal: bool, scale: float,
           scale_q: bool = True) -> torch.Tensor:
    """P = exp(scale * q k^T - lse) as [B, H, T, T] fp32, 0 where a key is
    hidden; q scaled in fp32 first (as the reference scores), or with
    ``scale_q`` False the fp32 product scaled (as the kernels score)."""
    B, T, H, _ = q.shape
    if scale_q:
        s = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    else:
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    return p.masked_fill(~layout_mask(layout, block, causal, q.device), 0.0)


def blocksparse_attention_bwd_dq_ref(q, k, v, o, do, lse, layout, block: int, causal: bool,
                                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dq pass: delta = rowsum(dO * O) ([B*H, T] fp32),
    dS = P * (dO v^T - delta) * scale, dQ = dS k in q's dtype. Returns
    (dq, delta)."""
    B, T, H, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * H, T)
    p = _probs(q, k, lse, layout, block, causal, scale)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta.reshape(B, H, T, 1)) * scale
    return torch.einsum("bhts,bshd->bthd", ds, k.float()).to(q.dtype), delta


def blocksparse_attention_bwd_dkv_ref(q, k, v, do, lse, delta, layout, block: int,
                                      causal: bool, scale: float
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv pass: dV = P^T dO, dK = dS^T q, in k's and
    v's dtypes."""
    B, T, H, _ = q.shape
    p = _probs(q, k, lse, layout, block, causal, scale)
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta.reshape(B, H, T, 1)) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def blocksparse_attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout,
                                    block: int, causal: bool = True,
                                    softmax_scale: Optional[float] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the tensor-core forward's rounding (bf16 / fp16
    inputs, every block): the fp32 product times the scale; each 64-key
    tile's P = exp(s - m_t) relative to the row's running maximum m_t as of
    that tile (the kernel visits a query tile's listed key tiles in ascending
    order; hidden keys, by the layout's sub-block bits or the causal mask,
    move no maximum, and a tile it skips holds only hidden keys), entering P V as hi + lo halves of the input dtype
    (fp16's times 2^14 first, exact both ways), weighted by exp(m_t - m); l
    sums the unrounded P; hidden keys have P = 0, so a row with no visible
    key gives o = 0 and lse = -1e30. For the tests and the card check: the
    CPU path runs :func:`blocksparse_attention_fwd_ref`, the reference's fp32
    function. Returns (o in q's dtype, lse [B*H, T] fp32)."""
    B, T, H, _ = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * _scale(q, softmax_scale)
    vis = layout_mask(layout, block, causal, q.device)
    s = s.masked_fill(~vis, NEG_INF)
    m_t = fa._running_tile_max(s)
    m = m_t[..., -1:]
    p = torch.exp(s - m_t).masked_fill(~vis, 0.0)
    w = torch.exp(m_t - m)
    l = (p * w).sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    f = 2.0**fa.FP16_P_EXP if q.dtype == torch.float16 else 1.0
    hi = (p * f).to(q.dtype).float()
    lo = (p * f - hi).to(q.dtype).float()
    o = torch.einsum("bhts,bshd->bthd", (hi + lo) / f * w / l_safe, v.float())
    return o.to(q.dtype), (m + torch.log(l_safe)).reshape(B * H, T)


def blocksparse_attention_bwd_split_ref(q, k, v, o, lse, do, layout, block: int,
                                        causal: bool = True,
                                        softmax_scale: Optional[float] = None
                                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the tensor-core backward's rounding (bf16 / fp16
    inputs): P from the fp32 product times the scale, and P and dS entering
    dV, dK and dQ as hi + lo halves of the input dtype (``fa._split``), each
    product taken on both halves in fp32; fp16 scales each row by the
    kernels' running power of two first (dQ's dS by query row, dV's P and
    dK's dS by key row: the kernels stream a row's active tiles in ascending
    order, and inactive tiles are zero, which moves no scale). For the tests
    and the card check: the CPU path runs the reference's fp32 function.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    scale = _scale(q, softmax_scale)
    B, T, H, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B, H, T, 1)
    p = _probs(q, k, lse, layout, block, causal, scale, scale_q=False)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta) * scale
    # the dk/dv kernel streams query tiles (rows are keys), the dq kernel key tiles
    dv = sum(torch.einsum("bhts,bthd->bshd", x, do.float()) for x in fa._split(p, q.dtype, -2))
    dk = sum(torch.einsum("bhts,bthd->bshd", x, q.float()) for x in fa._split(ds, q.dtype, -2))
    dq = sum(torch.einsum("bhts,bshd->bthd", x, k.float()) for x in fa._split(ds, q.dtype, -1))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def blocksparse_attention_fwd_tf32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       layout, block: int, causal: bool = True,
                                       softmax_scale: Optional[float] = None, passes: int = 3
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fp32 forward kernel's arithmetic (3xTF32, for the
    tests and the card check; the CPU path runs the plain version): S = q
    k^T in ``fa._mm_tf32`` times the scale over the expanded layout, each
    64-key tile's P = exp(s - m_t) relative to the row's running maximum as
    of that tile (hidden keys move none and have P = 0), P V in
    ``fa._mm_tf32`` with P weighted by exp(m_t - m) after its split, as the
    kernel rescales its accumulator. A row with no visible key gives o = 0
    and lse = -1e30. ``passes`` 1 is one TF32 pass, which the fp32 bars must
    refuse. Returns (o fp32, lse [B*H, T] fp32)."""
    B, T, H, _ = q.shape
    s = fa._mm_tf32("bthd,bshd->bhts", q, k, passes) * _scale(q, softmax_scale)
    vis = layout_mask(layout, block, causal, q.device)
    s = s.masked_fill(~vis, NEG_INF)
    m_t = fa._running_tile_max(s)
    m = m_t[..., -1:]
    p = torch.exp(s - m_t).masked_fill(~vis, 0.0)
    w = torch.exp(m_t - m)
    l = (p * w).sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = fa._mm_tf32("bhts,bshd->bthd", p, v, passes, a_weight=w / l_safe)
    return o, (m + torch.log(l_safe)).reshape(B * H, T)


def blocksparse_attention_fwd_tiles_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        layout, block: int, causal: bool = True,
                                        softmax_scale: Optional[float] = None
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain model of the forward kernels' walk over :func:`tile_tables`,
    in fp32, for the tests: each (head, 64-query tile) visits its listed key
    tiles in ascending order with an online softmax whose running maximum
    moves once a tile; an entry is kept by its sub-block bit and the causal
    mask (:func:`_tile_visible`), a hidden one scores -1e30 and has P set to
    0 (not left to exp: a row whose earlier tiles hid all its keys still has
    its maximum at -1e30). A row that no listed tile shows gives o = 0 and
    lse = -1e30. Returns (o fp32, lse [B*H, T] fp32)."""
    B, T, H, D = q.shape
    scale = _scale(q, softmax_scale)
    qf, kf, vf = (x.float() for x in (q, k, v))
    qt_idx, qt_cnt, qt_mask, _, _, _ = tile_tables(layout, block)
    o = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    lse = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    for h in range(H):
        for i in range(qt_cnt.shape[1]):
            rows = slice(i * TILE, min(T, (i + 1) * TILE))
            qh = qf[:, rows, h]
            nq = qh.shape[1]
            m = torch.full((B, nq, 1), NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros((B, nq, 1), dtype=torch.float32, device=q.device)
            acc = torch.zeros((B, nq, D), dtype=torch.float32, device=q.device)
            for t in range(qt_cnt[h, i]):
                j = int(qt_idx[h, i, t])
                cols = slice(j * TILE, min(T, (j + 1) * TILE))
                s = torch.einsum("btd,bsd->bts", qh, kf[:, cols, h]) * scale
                vis = _tile_visible(int(qt_mask[h, i, t]), block, i * TILE, j * TILE, nq,
                                    s.shape[-1], causal, q.device)
                s = s.masked_fill(~vis, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new).masked_fill(~vis, 0.0)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + torch.einsum("bts,bsd->btd", p, vf[:, cols, h])
                m = m_new
            l_safe = torch.where(l == 0.0, 1.0, l)
            o[:, rows, h] = acc / l_safe
            lse[:, h, rows] = (m + torch.log(l_safe))[..., 0]
    return o, lse.reshape(B * H, T)


def blocksparse_attention_bwd_tf32_ref(q, k, v, o, lse, do, layout, block: int,
                                       causal: bool = True,
                                       softmax_scale: Optional[float] = None, passes: int = 3
                                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fp32 backward kernels' arithmetic (3xTF32, for
    the tests and the card check; the CPU path runs the plain versions):
    every product of the backward (q k^T scored as the fp32 product times the
    scale, dO v^T, P^T dO, dS k, dS^T q) in ``fa._mm_tf32`` over the
    expanded layout; delta the fp32 rowsum of the dq pass. ``passes`` 1 is
    one TF32 pass, which the fp32 bars must refuse. Returns (dq, dk, dv)
    fp32."""
    B, T, H, _ = q.shape
    scale = _scale(q, softmax_scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B, H, T, 1)
    s = fa._mm_tf32("bthd,bshd->bhts", q, k, passes) * scale
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    p = p.masked_fill(~layout_mask(layout, block, causal, q.device), 0.0)
    dp = fa._mm_tf32("bthd,bshd->bhts", do, v, passes)
    ds = p * (dp - delta) * scale
    dv = fa._mm_tf32("bhts,bthd->bshd", p, do, passes)
    dk = fa._mm_tf32("bhts,bthd->bshd", ds, q, passes)
    dq = fa._mm_tf32("bhts,bshd->bthd", ds, k, passes)
    return dq, dk, dv


def _tile_visible(bits: int, block: int, q0: int, k0: int, nq: int, nk: int, causal: bool,
                  device) -> torch.Tensor:
    """[nq, nk] bool: the entries of the 64-token tile pair at (q0, k0) that
    a kernel keeps: its sub-block's bit of the tile's mask ``bits``
    set (every entry at blocks of 64 / 128), and under ``causal`` key <=
    query."""
    r = torch.arange(nq, device=device)[:, None]
    c = torch.arange(nk, device=device)[None, :]
    if block < TILE:
        g = TILE // block
        vis = ((bits >> ((r // block) * g + c // block)) & 1).bool()
    else:
        vis = torch.ones((nq, nk), dtype=torch.bool, device=device)
    return vis & (k0 + c <= q0 + r) if causal else vis


def blocksparse_attention_bwd_tiles_ref(q, k, v, o, lse, do, layout, block: int,
                                        causal: bool = True,
                                        softmax_scale: Optional[float] = None
                                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A plain model of the backward kernels' walk over :func:`tile_tables`,
    in fp32, for the tests: dq sums, for each (head, 64-query tile), its
    listed key tiles in ascending order, each entry kept by its sub-block bit
    and the causal mask (:func:`_tile_visible`); dk and dv sum each key
    tile's listed query tiles the same way. Tiles not listed add nothing.
    Returns (dq, dk, dv) fp32."""
    B, T, H, D = q.shape
    scale = _scale(q, softmax_scale)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    lse_ = lse.reshape(B, H, T)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # [B, H, T]
    qt_idx, qt_cnt, qt_mask, kt_idx, kt_cnt, kt_mask = tile_tables(layout, block)
    dq, dk, dv = (torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
                  for _ in range(3))

    def tile(h, i, j, bits):
        """P and dS [B, nq, nk] of query tile i and key tile j of head h."""
        rows = slice(i * TILE, min(T, (i + 1) * TILE))
        cols = slice(j * TILE, min(T, (j + 1) * TILE))
        qh, kh = qf[:, rows, h], kf[:, cols, h]
        p = torch.exp(torch.einsum("btd,bsd->bts", qh, kh) * scale - lse_[:, h, rows, None])
        vis = _tile_visible(int(bits), block, i * TILE, j * TILE, qh.shape[1], kh.shape[1],
                            causal, q.device)
        p = p.masked_fill(~vis, 0.0)
        dp = torch.einsum("btd,bsd->bts", dof[:, rows, h], vf[:, cols, h])
        return rows, cols, p, p * (dp - delta[:, h, rows, None]) * scale

    for h in range(H):
        for i in range(qt_cnt.shape[1]):
            for t in range(qt_cnt[h, i]):
                rows, cols, _, ds = tile(h, i, qt_idx[h, i, t], qt_mask[h, i, t])
                dq[:, rows, h] += torch.einsum("bts,bsd->btd", ds, kf[:, cols, h])
        for j in range(kt_cnt.shape[1]):
            for t in range(kt_cnt[h, j]):
                rows, cols, p, ds = tile(h, kt_idx[h, j, t], j, kt_mask[h, j, t])
                dv[:, cols, h] += torch.einsum("bts,btd->bsd", p, dof[:, rows, h])
                dk[:, cols, h] += torch.einsum("bts,btd->bsd", ds, qf[:, rows, h])
    return dq, dk, dv


# --------------------------------------------------------------------------- kernels
def _device_tables(layout, block: int, tables: Optional[Tables], device) -> Tables:
    if tables is None:
        return device_tables(layout, block, device)
    return Tables(*(t if t.device == device else t.to(device) for t in tables))


def blocksparse_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout,
                              block: int, causal: bool = True,
                              softmax_scale: Optional[float] = None,
                              tables: Optional[Tables] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v [B, T, H, D] -> (o [B, T, H, D] in q's dtype, lse [B*H, T]
    fp32), the forward kernel of :func:`bs_route`'s route. ``tables`` are
    :func:`device_tables` of ``layout`` (built here when None)."""
    global fwd_tc_launches, fwd_tf32_launches
    _check(q, k, v, layout, block)
    scale = _scale(q, softmax_scale)
    if q.device.type == "cpu":
        return blocksparse_attention_fwd_ref(q, k, v, layout, block, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"blocksparse_attention: unsupported device {q.device}")
    route = _check_kernel(block, "fwd", q, k, v)
    t = _device_tables(layout, block, tables, q.device)
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    lib = _fwd_lib(route)
    with torch.cuda.device(q.device):
        status = getattr(lib, f"ds_blocksparse_attention_fwd_{route}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            t.qt_idx.data_ptr(), t.qt_cnt.data_ptr(), t.qt_mask.data_ptr(),
            t.qt_order.data_ptr(), B, H, T, D, DTYPE_CODE[q.dtype], block, t.qt_idx.shape[-1],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale, int(bool(causal)),
            _stream())
    _build.check(lib, status, f"blocksparse_attention_fwd ({route})")
    if route == "tc":
        fwd_tc_launches += 1
    else:
        fwd_tf32_launches += 1
    return o, lse


def blocksparse_attention_bwd_dq(q, k, v, o, do, lse, layout, block: int, causal: bool,
                                 scale: float, tables: Optional[Tables] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq [B, T, H, D] in q's dtype, delta [B*H, T] fp32), the dq kernel of
    :func:`bs_route`'s backward route, over each query tile's list of key
    tiles."""
    global bwd_dq_tc_launches, bwd_dq_tf32_launches
    if q.device.type == "cpu":
        return blocksparse_attention_bwd_dq_ref(q, k, v, o, do, lse, layout, block, causal,
                                                scale)
    route = _check_kernel(block, "bwd", q, k, v, o, do)
    t = _device_tables(layout, block, tables, q.device)
    B, T, H, D = q.shape
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    lib = _bwd_lib(route)
    with torch.cuda.device(q.device):
        status = getattr(lib, f"ds_blocksparse_attention_bwd_dq_{route}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), t.qt_idx.data_ptr(),
            t.qt_cnt.data_ptr(), t.qt_mask.data_ptr(), t.qt_order.data_ptr(), B, H, T, D,
            DTYPE_CODE[q.dtype], block, t.qt_idx.shape[-1], *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], *do.stride()[:3], scale, int(bool(causal)),
            _stream())
    _build.check(lib, status, f"blocksparse_attention_bwd_dq ({route})")
    if route == "tc":
        bwd_dq_tc_launches += 1
    else:
        bwd_dq_tf32_launches += 1
    return dq, delta


def blocksparse_attention_bwd_dkv(q, k, v, do, lse, delta, layout, block: int, causal: bool,
                                  scale: float, tables: Optional[Tables] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, T, H, D] in k's dtype, the dk/dv kernel of
    :func:`bs_route`'s backward route, over each key tile's list of query
    tiles; ``delta`` is the dq pass's."""
    global bwd_dkv_tc_launches, bwd_dkv_tf32_launches
    if q.device.type == "cpu":
        return blocksparse_attention_bwd_dkv_ref(q, k, v, do, lse, delta, layout, block,
                                                 causal, scale)
    route = _check_kernel(block, "bwd", q, k, v, do)
    t = _device_tables(layout, block, tables, q.device)
    B, T, H, D = q.shape
    dk = torch.empty((B, T, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, T, H, D), dtype=v.dtype, device=v.device)
    lib = _bwd_lib(route)
    with torch.cuda.device(q.device):
        status = getattr(lib, f"ds_blocksparse_attention_bwd_dkv_{route}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), t.kt_idx.data_ptr(),
            t.kt_cnt.data_ptr(), t.kt_mask.data_ptr(), t.kt_order.data_ptr(), B, H, T, D,
            DTYPE_CODE[q.dtype], block, t.kt_idx.shape[-1], *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], scale, int(bool(causal)), _stream())
    _build.check(lib, status, f"blocksparse_attention_bwd_dkv ({route})")
    if route == "tc":
        bwd_dkv_tc_launches += 1
    else:
        bwd_dkv_tf32_launches += 1
    return dk, dv


def blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block: int, causal: bool = True,
                              softmax_scale: Optional[float] = None,
                              tables: Optional[Tables] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward from the forward's saved (q, k, v, o, lse [B*H, T]) and
    dO: (dq, dk, dv) in the shapes and dtypes of q, k, v. Two kernel launches
    on a CUDA device (dq with delta, then dk/dv), the plain versions on the
    CPU."""
    _check(q, k, v, layout, block)
    if do.shape != q.shape or o.shape != q.shape or lse.shape != (q.shape[0] * q.shape[2],
                                                                  q.shape[1]):
        raise ValueError(f"blocksparse_attention_bwd: o {tuple(o.shape)} / dO "
                         f"{tuple(do.shape)} / lse {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    scale = _scale(q, softmax_scale)
    if q.device.type == "cuda":
        do = do.to(q.dtype)
        if not _readable(do):  # autograd may hand dO over in any layout
            do = do.contiguous()
        lse = lse.float().contiguous()
        tables = _device_tables(layout, block, tables, q.device)
    elif q.device.type != "cpu":
        raise ValueError(f"blocksparse_attention: unsupported device {q.device}")
    dq, delta = blocksparse_attention_bwd_dq(q, k, v, o, do, lse, layout, block, causal, scale,
                                             tables)
    dk, dv = blocksparse_attention_bwd_dkv(q, k, v, do, lse, delta, layout, block, causal,
                                           scale, tables)
    return dq, dk, dv


class BlocksparseAttention(torch.autograd.Function):
    """Differentiable blocksparse attention: the forward kernel, then the dq
    and dk/dv kernels from the saved logsumexp (the reference's
    ``custom_vjp`` around ``_bs_attn``). On CPU tensors both halves take
    their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block: int, causal: bool,
                softmax_scale: Optional[float], tables: Optional[Tables]):
        o, lse = blocksparse_attention_fwd(q, k, v, layout, block, causal, softmax_scale,
                                           tables)
        ctx.save_for_backward(q, k, v, o, lse, *(tables or ()))
        ctx.layout, ctx.block, ctx.causal = layout, block, causal
        ctx.softmax_scale = softmax_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, *tables = ctx.saved_tensors
        dq, dk, dv = blocksparse_attention_bwd(q, k, v, o, lse, do, ctx.layout, ctx.block,
                                               ctx.causal, ctx.softmax_scale,
                                               Tables(*tables) if tables else None)
        return dq, dk, dv, None, None, None, None, None


def blocksparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout,
                          block: int, causal: bool = True,
                          softmax_scale: Optional[float] = None,
                          tables: Optional[Tables] = None) -> torch.Tensor:
    """Attention restricted to the active blocks of ``layout`` ([H, T/block,
    T/block], static 0/1) on q/k/v [B, T, H, D]; differentiable through
    :class:`BlocksparseAttention`. ``tables`` are the layout's
    :func:`device_tables`, kept by a caller that calls again (built per call
    when None). A layout whose shape is not [H, T/block, T/block] raises the
    reference's ValueError."""
    return BlocksparseAttention.apply(q, k, v, layout, block, causal, softmax_scale, tables)
