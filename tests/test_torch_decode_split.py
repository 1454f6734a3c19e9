"""A CPU model of the split-KV decode kernels (B3 ``decode_attention``, B4
``paged_decode_attention`` and B5 ``paged_verify_attention``,
``csrc/decode_attention.cu``, ``csrc/paged_decode_attention.cu`` and
``csrc/paged_verify_attention.cu``) against the JAX package's functions.

The kernels split each (b, h) row's cache into ``n_split`` spans
(``split_plan``), compute one partial (m, l, acc) per span that holds a
position below the row's length, skip every span wholly past it, and merge
the partials in split order. B5's split 0 also attends the window, causally.
B4 and B5 resolve each position's page from the block table, so a split may
start inside a page. Quantized pools enter as integers: a page's K scale
multiplies each position's score and its V scale each position's
probability. ``decode_split_ref``, ``paged_split_ref`` and
``verify_split_ref`` below compute the same in
float64 on the CPU, split by split, so the algebra of the split (empty spans,
the window's owner, the merge) is held to the JAX package's function here;
the kernels themselves are held to the plain versions on the card
(``test_torch_kernels.py``, ``chip_smoke.py``). Tolerance: 1e-5 absolute
(the JAX functions compute in fp32, the model in float64).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu.ops.pallas.int8_matmul import pack_int4 as jax_pack_int4
from deepspeed_tpu_torch.ops.cuda import decode_attention as da

ATOL = 1e-5
NEG_INF = -1e30


def _merge(parts):
    """Partials [(m, l, acc)] in split order -> acc / l (l == 0 -> 1)."""
    if not parts:
        return None
    m_all = max(p[0] for p in parts)
    l_all = sum(p[1] * math.exp(p[0] - m_all) for p in parts)
    acc = sum(p[2] * math.exp(p[0] - m_all) for p in parts)
    return acc / (l_all if l_all != 0 else 1.0)


def _partial(s, v, valid, skip_empty=True):
    """One span's (m, l, acc) over scores ``s`` [n] and values ``v`` [n, D]
    (probability factors folded into v's rows by the caller); a span with no
    valid position is None (skipped) unless ``skip_empty`` is False, when it
    is masked with -1e30 instead, as the kernels must not do."""
    if not valid.any():
        if skip_empty:
            return None
        s = np.full_like(s, NEG_INF)
        valid = np.ones_like(valid)
    s = np.where(valid, s, NEG_INF)
    m = s.max()
    p = np.where(valid, np.exp(s - m), 0.0)
    return m, p.sum(), p @ v


def decode_split_ref(q, k, v, lengths, span, scale=None, skip_empty=True):
    """B3's split-KV function: q [B, 1, H, D], k/v [B, H, S, D], lengths [B]."""
    B, _, H, D = q.shape
    S = k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    n_split = -(-S // span)
    out = np.zeros((B, 1, H, D))
    for b in range(B):
        n = min(max(int(lengths[b]), 0), S)
        for h in range(H):
            parts = []
            for sp in range(n_split):
                pos = np.arange(sp * span, min((sp + 1) * span, S))
                s = (k[b, h, pos].astype(np.float64) @ (q[b, 0, h].astype(np.float64) * scale))
                part = _partial(s, v[b, h, pos].astype(np.float64), pos < n, skip_empty)
                if part is not None:
                    parts.append(part)
            merged = _merge(parts)
            out[b, 0, h] = 0.0 if merged is None else merged
    return out


def _unpack4(packed):
    """Nibble-packed int4 rows [..., D/2] -> integers [..., D]: byte j holds
    dim j in its low nibble and dim j + D/2 in its high one."""
    p = packed.astype(np.int16)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return np.concatenate([lo, hi], axis=-1)


def _pool_rows(k_pages, v_pages, tables, b, h, k_scales, v_scales, D):
    """Row b's positions 0 .. capacity - 1 read through its table for head h:
    K and V as float64 (integers for quantized pools) and each position's K
    and V page scale (ones for dense pools)."""
    ps, pps = k_pages.shape[2], tables.shape[1]
    pos = np.arange(ps * pps)
    page, off = tables[b, pos // ps], pos % ps
    kk, vv = k_pages[h, page, off], v_pages[h, page, off]
    if k_scales is None:
        ks = vs = np.ones(len(pos))
    else:
        widen = _unpack4 if k_pages.shape[-1] * 2 == D else (lambda x: x)
        kk, vv = widen(kk), widen(vv)
        ks, vs = k_scales[h, page], v_scales[h, page]
    return kk.astype(np.float64), vv.astype(np.float64), ks, vs


def paged_split_ref(q, k_pages, v_pages, lengths, tables, span, scale=None, k_scales=None,
                    v_scales=None):
    """B4's split-KV function: q [B, 1, H, D], pools [H, P, ps, Dq] dense or
    int8 / nibble-packed int4 with [H, P] scales, tables [B, pps]; split s
    holds positions [s * span, (s + 1) * span) below the row's length
    (their pages from the table: a split may start inside a page), a split
    with none is skipped."""
    B, _, H, D = q.shape
    cap = k_pages.shape[2] * tables.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = np.zeros((B, 1, H, D))
    for b in range(B):
        n = min(max(int(lengths[b]), 0), cap)
        for h in range(H):
            kk, vv, ks, vs = _pool_rows(k_pages, v_pages, tables, b, h, k_scales, v_scales, D)
            qh = q[b, 0, h].astype(np.float64) * scale
            parts = []
            for sp in range(-(-n // span)):
                pos = np.arange(sp * span, min((sp + 1) * span, n))
                parts.append(_partial((kk[pos] @ qh) * ks[pos], vv[pos] * vs[pos][:, None],
                                      np.ones(len(pos), bool)))
            merged = _merge(parts)
            out[b, 0, h] = 0.0 if merged is None else merged
    return out


def verify_split_ref(q, k_pages, v_pages, lengths, tables, win_k, win_v, span, scale=None,
                     k_scales=None, v_scales=None):
    """B5's split-KV function: q / window [B, W, H, D], pools [H, P, ps, Dq]
    dense or int8 / nibble-packed int4 with [H, P] scales, tables [B, pps]."""
    B, W, H, D = q.shape
    ps, pps = k_pages.shape[2], tables.shape[1]
    cap = ps * pps
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    quant = k_scales is not None
    widen = (_unpack4 if k_pages.shape[-1] * 2 == D else (lambda x: x)) if quant else None
    out = np.zeros((B, W, H, D))
    for b in range(B):
        n = min(max(int(lengths[b]), 0), cap)
        n_part = max(-(-n // span), 1)
        pos = np.arange(cap)
        page, off = tables[b, pos // ps], pos % ps
        for h in range(H):
            kk, vv = k_pages[h, page, off], v_pages[h, page, off]
            if quant:  # the integers; the scales apply to scores and probabilities
                kk, vv = widen(kk), widen(vv)
                ks, vs = k_scales[h, page], v_scales[h, page]
            else:
                ks = vs = np.ones(cap)
            kk, vv = kk.astype(np.float64), vv.astype(np.float64)
            for w in range(W):
                qw = q[b, w, h].astype(np.float64) * scale
                parts = []
                for sp in range(n_part):
                    hist = np.arange(sp * span, min((sp + 1) * span, n))
                    s = (kk[hist] @ qw) * ks[hist]
                    vals = vv[hist] * vs[hist][:, None]
                    valid = np.ones(len(hist), bool)
                    if sp == 0:  # the window's owner: window positions 0..w
                        s = np.concatenate([s, win_k[b, :W, h].astype(np.float64) @ qw])
                        vals = np.concatenate([vals, win_v[b, :W, h].astype(np.float64)])
                        valid = np.concatenate([valid, np.arange(W) <= w])
                    part = _partial(s, vals, valid)
                    if part is not None:
                        parts.append(part)
                out[b, w, h] = _merge(parts)
    return out


# ---------------------------------------------------------------- B3
def _decode_inputs(B, H, S, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((B, 1, H, D), (B, H, S, D), (B, H, S, D)))


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("span", [64, 128])
def test_decode_split_model_matches_jax(D, span):
    """Lengths 0, 1, a span's edge (span - 1, span, span + 1), spans wholly
    past the length (1 of 4), and the capacity; the length-0 row gives
    zeros, as the reference's does."""
    S = 256
    lengths = np.array([0, 1, span - 1, span, span + 1, S // 2 + 3, S - 1, S], np.int32)
    q, k, v = _decode_inputs(len(lengths), 2, S, D, seed=D + span)
    out = decode_split_ref(q, k, v, lengths, span)
    ref = np.asarray(jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(lengths), block_k=128))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert not out[0].any()
    port = da.decode_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(lengths))
    np.testing.assert_allclose(port.numpy(), out, atol=ATOL, rtol=0)


def test_masking_an_empty_split_would_return_the_mean_of_v():
    """Why the kernels skip a span past the length instead of masking it: a
    masked span's partial has m = -1e30 and exp(-1e30 - (-1e30)) = 1 at every
    position, so a row of length 0 (all spans masked) would return the mean
    of V where the reference returns zeros."""
    q, k, v = _decode_inputs(2, 2, 192, 64, seed=3)
    lengths = np.array([0, 70], np.int32)
    skipped = decode_split_ref(q, k, v, lengths, 64)
    masked = decode_split_ref(q, k, v, lengths, 64, skip_empty=False)
    assert not skipped[0].any()
    np.testing.assert_allclose(masked[0, 0], v[0].astype(np.float64).mean(axis=1), atol=1e-6)
    # a row with positions outweighs the masked span (its m is -1e30)
    np.testing.assert_array_equal(masked[1], skipped[1])


# ---------------------------------------------------------------- B5
def _verify_case(bits, D, W, ps, pages, lengths, seed):
    rng = np.random.default_rng(seed)
    H, B = 2, len(lengths)
    pool = B * pages + 1
    tables = rng.permutation(np.arange(1, pool))[:B * pages].reshape(B, pages).astype(np.int32)
    q, wk, wv = (rng.standard_normal((B, W, H, D), dtype=np.float32) for _ in range(3))
    if bits is None:
        k, v = (rng.standard_normal((H, pool, ps, D), dtype=np.float32) for _ in range(2))
        return q, wk, wv, k, v, None, None, tables
    qmax = 127 if bits == 8 else 7
    k, v = (rng.integers(-qmax - 1, qmax + 1, (H, pool, ps, D)).astype(np.int8)
            for _ in range(2))
    if bits == 4:
        k, v = (np.array(jax_pack_int4(jnp.asarray(t))) for t in (k, v))
    ks, vs = (rng.uniform(0.001, 0.05, (H, pool)).astype(np.float32) for _ in range(2))
    return q, wk, wv, k, v, ks, vs, tables


def _jax_verify(case, lengths):
    q, wk, wv, k, v, ks, vs, tables = case
    j = jnp.asarray
    return np.asarray(jda.paged_verify_attention(
        j(q), j(k), j(v), j(lengths), j(tables), j(wk), j(wv), impl="gather",
        k_scales=None if ks is None else j(ks), v_scales=None if vs is None else j(vs)),
        np.float64)


def _verify_lengths(span, cap, W):
    """0, 1, a span's edge, spans wholly past the length, the capacity."""
    return np.array([0, 1, span - 1, span, span + 1, cap // 2 + 5, cap - W, cap], np.int32)


def _check_verify(bits, D, W, ps=16, pages=16, span=64, seed=0):
    cap = ps * pages
    lengths = _verify_lengths(span, cap, W)
    case = _verify_case(bits, D, W, ps, pages, lengths, seed)
    q, wk, wv, k, v, ks, vs, tables = case
    out = verify_split_ref(q, k, v, lengths, tables, wk, wv, span, k_scales=ks, v_scales=vs)
    ref = _jax_verify(case, lengths)
    # the gather reference drops window positions at or past the table's
    # capacity (never committed); the kernels attend them: compare the rest
    keep = (lengths[:, None] + np.arange(W)[None, :]) < cap
    np.testing.assert_allclose(out[keep], ref[keep], atol=ATOL, rtol=0)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("W", list(range(1, 18)))
def test_verify_split_model_matches_jax_every_window(W):
    """Every window width 1-17 (one or two 16-row m tiles on the tensor
    cores), Dh 96, dense pools, four spans of 64."""
    _check_verify(None, 96, W, seed=W)


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("W", [2, 5, 17])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
def test_verify_split_model_matches_jax(bits, W, D):
    """Dense, int8 and int4 pools (the scales on scores and probabilities)
    at Dh 64 / 96 / 128."""
    _check_verify(bits, D, W, seed=D + W + (bits or 0))


@pytest.mark.parametrize("span", [64, 128, 256])
def test_verify_split_model_is_independent_of_the_split(span):
    """One span over the whole capacity (no merge), and merges of 2 and 4:
    the same function."""
    _check_verify(8, 64, 5, span=span, seed=11)


# ---------------------------------------------------------------- B4
def _paged_case(bits, D, ps, pages, lengths, seed):
    """q, one layer's pools (+ scales) and scattered tables for a B4 case."""
    rng = np.random.default_rng(seed)
    H, B = 2, len(lengths)
    pool = B * pages + 1
    tables = rng.permutation(np.arange(1, pool))[:B * pages].reshape(B, pages).astype(np.int32)
    q = rng.standard_normal((B, 1, H, D), dtype=np.float32)
    if bits is None:
        k, v = (rng.standard_normal((H, pool, ps, D), dtype=np.float32) for _ in range(2))
        return q, k, v, None, None, tables
    qmax = 127 if bits == 8 else 7
    k, v = (rng.integers(-qmax - 1, qmax + 1, (H, pool, ps, D)).astype(np.int8)
            for _ in range(2))
    if bits == 4:
        k, v = (np.array(jax_pack_int4(jnp.asarray(t))) for t in (k, v))
    ks, vs = (rng.uniform(0.001, 0.05, (H, pool)).astype(np.float32) for _ in range(2))
    return q, k, v, ks, vs, tables


def _check_paged(bits, D, ps, span, seed=0):
    """Lengths 0, 1, a span's edge (span - 1, span, span + 1) and the
    capacity of a 512-position table; the length-0 row gives zeros."""
    cap = 512
    lengths = np.array([0, 1, span - 1, span, span + 1, cap], np.int32)
    q, k, v, ks, vs, tables = _paged_case(bits, D, ps, cap // ps, lengths, seed)
    out = paged_split_ref(q, k, v, lengths, tables, span, k_scales=ks, v_scales=vs)
    j = jnp.asarray
    opt = {} if ks is None else {"k_scales": j(ks), "v_scales": j(vs)}
    # the Pallas kernel (interpret mode on the CPU): its length-0 row gives
    # zeros, where the reference's gather fallback returns the mean of V
    ref = np.asarray(jda.paged_decode_attention(j(q), j(k), j(v), j(lengths), j(tables),
                                                impl="kernel", **opt), np.float64)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert not out[0].any()
    t = {} if ks is None else {"k_scales": torch.from_numpy(ks), "v_scales": torch.from_numpy(vs)}
    port = da.paged_decode_attention(*map(torch.from_numpy, (q, k, v, lengths, tables)), **t)
    np.testing.assert_allclose(port.numpy(), out, atol=ATOL, rtol=0)


@pytest.mark.parametrize("span", [64, 128, 192])
@pytest.mark.parametrize("ps", [64, 128])
@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
def test_paged_split_model_matches_jax(bits, D, ps, span):
    """Dense, int8 and int4 pools (the scales on scores and probabilities)
    at Dh 64 / 96, pages of 64 and 128, spans of 64 (inside a page of 128:
    every odd split starts mid-page), 128 and 192 (the 16-page plan's span:
    splits start mid-page at either page size)."""
    _check_paged(bits, D, ps, span, seed=D + ps + span + (bits or 0))


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
def test_paged_split_model_is_independent_of_the_split(bits):
    """The same pools and lengths split at spans 64, 128, 192 and one span
    over the whole table (no merge): the same function."""
    cap, ps = 512, 128
    lengths = np.array([0, 1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 300, cap], np.int32)
    q, k, v, ks, vs, tables = _paged_case(bits, 64, ps, cap // ps, lengths, 7)
    outs = [paged_split_ref(q, k, v, lengths, tables, span, k_scales=ks, v_scales=vs)
            for span in (64, 128, 192, cap)]
    for out in outs[1:]:
        np.testing.assert_allclose(out, outs[0], atol=1e-12, rtol=0)


@pytest.mark.parametrize("rows,capacity,expect", [
    (48, 640, (5, 128)),    # B3 at the serving path's B4 H12 S640
    (96, 512, (4, 128)),    # B4 and B5 at phase 6's / 8's 8 slots H12, 8 pages of 64
    (96, 1024, (6, 192)),   # B4 at 16 pages of 64 (phase 2's long row)
    (192, 512, (3, 192)),   # B5 at 16 slots, 4 pages of 128
    (1024, 2048, (1, 2048)),  # a grid that fills the card unsplit
    (2, 64, (1, 64)),       # shorter than a span
    (4, 4096, (32, 128)),   # a long cache at a small batch
])
def test_split_plan(rows, capacity, expect):
    """Splits of at least 128 positions, about four blocks an SM at most,
    multiples of 64 that cover the capacity (132 SMs)."""
    n, span = da.split_plan(rows, capacity, 132)
    assert (n, span) == expect
    assert span % 64 == 0 and n * span >= capacity > (n - 1) * span or capacity <= span
