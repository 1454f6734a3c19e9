"""The port's speculative verify path vs the JAX package's: the verify
attention (B5) plain version against ``paged_verify_attention``'s gather
fallback (``impl="gather"``) and its Pallas kernel in interpret mode
(``impl="kernel"``), ``models.gpt.paged_verify_step`` and
``commit_window_kv``. The CUDA kernel itself is held against the plain
version on the card (``test_torch_kernels.py`` and ``chip_smoke.py``).

Inputs are numpy from a seed; weights cross through
``deepspeed_tpu_torch.bridge``. Tolerances: attention fp32 1e-6 against the
gather fallback (the same masked fp32 softmax) and 1e-5 against the Pallas
kernel (an online softmax over pages, then the window tile), int8/int4
pools 1e-5, bf16 2e-2 (both round the output to bf16); verify-step logits and
window K/V atol 1e-5 (fp32 matmuls summed in another order); committed
payloads and dense pools bitwise, scales rtol 1e-6 (XLA may turn the divide
into a reciprocal multiply).

The Pallas kernel attends every window position, the gather fallback drops
those at or past the table's capacity (``pages_per_seq * page_size``);
neither output is ever committed there, so the comparison with the kernel
covers the committable positions, ``lengths[b] + i < capacity``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import gpt as G
from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu.ops.pallas.int8_matmul import pack_int4 as jax_pack_int4
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.models import gpt as TG
from deepspeed_tpu_torch.ops.cuda import decode_attention as da

H, DH, PAGES = 2, 32, 4
ATOL = {("dense", "float32"): 1e-6, ("dense", "bfloat16"): 2e-2, (8, "float32"): 1e-5,
        (4, "float32"): 1e-5}
KERNEL_ATOL = 1e-5
SCALE_RTOL = 1e-6
LOGIT_ATOL = 1e-5


def _lengths(ps, W):
    """0, 1, a page boundary -1/0/+1, a window ending at the capacity, one
    crossing it, and a full table."""
    cap = PAGES * ps
    return [0, 1, ps - 1, ps, ps + 1, cap - W, cap - W // 2 - 1, cap]


def _case(bits, ps, W, seed):
    """q, window, pools (+ scales) and scattered tables from numpy."""
    rng = np.random.default_rng(seed)
    lens = np.array(_lengths(ps, W), np.int32)
    B = len(lens)
    pool = B * PAGES + 1
    tables = rng.permutation(np.arange(1, pool))[:B * PAGES].reshape(B, PAGES).astype(np.int32)
    q, wk, wv = (rng.standard_normal((B, W, H, DH), dtype=np.float32) for _ in range(3))
    if bits is None:
        k, v = (rng.standard_normal((H, pool, ps, DH), dtype=np.float32) for _ in range(2))
        return q, wk, wv, k, v, None, None, tables, lens
    qmax = 127 if bits == 8 else 7
    k, v = (rng.integers(-qmax - 1, qmax + 1, (H, pool, ps, DH)).astype(np.int8)
            for _ in range(2))
    if bits == 4:
        k, v = (np.array(jax_pack_int4(jnp.asarray(t))) for t in (k, v))
    ks, vs = (rng.uniform(0.001, 0.05, (H, pool)).astype(np.float32) for _ in range(2))
    return q, wk, wv, k, v, ks, vs, tables, lens


def _port(case, dtype=torch.float32, impl=None):
    q, wk, wv, k, v, ks, vs, tables, lens = case
    t = torch.from_numpy
    kk, vv = (t(k), t(v)) if ks is not None else (t(k).to(dtype), t(v).to(dtype))
    return da.paged_verify_attention(
        t(q).to(dtype), kk, vv, t(lens), t(tables), t(wk).to(dtype), t(wv).to(dtype),
        impl=impl, k_scales=None if ks is None else t(ks), v_scales=None if vs is None else t(vs))


def _jax(case, impl, dtype=jnp.float32):
    q, wk, wv, k, v, ks, vs, tables, lens = case
    j = jnp.asarray
    kk, vv = (j(k), j(v)) if ks is not None else (j(k, dtype), j(v, dtype))
    return np.asarray(jda.paged_verify_attention(
        j(q, dtype), kk, vv, j(lens), j(tables), j(wk, dtype), j(wv, dtype), impl=impl,
        k_scales=None if ks is None else j(ks), v_scales=None if vs is None else j(vs)),
        np.float32)


def _committable(lens, W, ps):
    return (lens[:, None] + np.arange(W)[None, :]) < PAGES * ps  # [B, W]


KINDS = [(None, "float32"), (None, "bfloat16"), (8, "float32"), (4, "float32")]


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("W", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("bits,dtype", KINDS, ids=["dense_f32", "dense_bf16", "kv8", "kv4"])
def test_plain_verify_matches_jax_gather(bits, dtype, W, ps):
    """Every position, the capacity edge included: both drop window
    positions past the table."""
    case = _case(bits, ps, W, seed=W * 10 + ps)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out = _port(case, tdt).float().numpy()
    ref = _jax(case, "gather", jdt)
    np.testing.assert_allclose(out, ref, atol=ATOL[(bits or "dense", dtype)], rtol=0)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("W", [2, 5, 9])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
def test_plain_verify_matches_the_pallas_kernel(bits, W, ps):
    """fp32; the committable positions only (see the module docstring)."""
    case = _case(bits, ps, W, seed=W * 7 + ps)
    out = _port(case).numpy()
    ref = _jax(case, "kernel")
    keep = _committable(case[-1], W, ps)
    np.testing.assert_allclose(out[keep], ref[keep], atol=KERNEL_ATOL, rtol=0)


def test_window_positions_past_the_table_drop():
    """The capacity-edge rule: a window position at or past the table's
    capacity is dropped, never clipped onto the last slot, so the committable
    positions before it see no rejected draft's K/V; past the edge the plain
    version differs from the Pallas kernel, which attends the whole window."""
    ps, W = 8, 5
    case = _case(None, ps, W, seed=3)
    lens = case[-1]
    out = _port(case).numpy()
    ref = _jax(case, "kernel")
    keep = _committable(lens, W, ps)
    assert (~keep).any() and keep.any()
    np.testing.assert_allclose(out[keep], ref[keep], atol=KERNEL_ATOL, rtol=0)
    # the row whose window crosses the edge: past it the two differ
    row = int(np.flatnonzero(keep.any(1) & ~keep.all(1))[0])
    assert not np.allclose(out[row, ~keep[row]], ref[row, ~keep[row]], atol=1e-3)
    # and its committable positions do not depend on the dropped drafts
    q, wk, wv, k, v, ks, vs, tables, _ = case
    wk2, wv2 = wk.copy(), wv.copy()
    wk2[row, ~keep[row]] += 5.0
    wv2[row, ~keep[row]] -= 5.0
    again = _port((q, wk2, wv2, k, v, ks, vs, tables, lens)).numpy()
    np.testing.assert_array_equal(again[row, keep[row]], out[row, keep[row]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w1_is_bitwise_the_single_token_version(dtype):
    """W = 1 equals :func:`paged_decode_attention_ref` at ``lengths + 1``
    bit for bit once the window token is in the pool where the sequential
    append would have put it."""
    ps = 8
    q, wk, wv, k, v, _, _, tables, lens = _case(None, ps, 1, seed=11)
    keep = _committable(lens, 1, ps)[:, 0]
    tdt = getattr(torch, dtype)
    out = _port((q, wk, wv, k, v, None, None, tables, lens), tdt)
    kp, vp = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    for b in np.flatnonzero(keep):
        pg, off = tables[b, lens[b] // ps], lens[b] % ps
        kp[:, pg, off] = torch.from_numpy(wk[b, 0]).to(tdt)
        vp[:, pg, off] = torch.from_numpy(wv[b, 0]).to(tdt)
    ref = da.paged_decode_attention_ref(torch.from_numpy(q).to(tdt), kp, vp,
                                        torch.from_numpy(lens + 1), torch.from_numpy(tables))
    assert torch.equal(out[keep], ref[keep])


def test_verify_attention_checks():
    case = _case(None, 8, 3, seed=1)
    q, wk, wv, k, v, _, _, tables, lens = (torch.from_numpy(np.asarray(x)) if x is not None
                                           else None for x in case)
    with pytest.raises(ValueError, match="win_k/win_v"):
        da.paged_verify_attention(q, k, v, lens, tables, wk[:, :2], wv)
    with pytest.raises(ValueError, match="impl"):
        da.paged_verify_attention(q, k, v, lens, tables, wk, wv, impl="pallas")
    with pytest.raises(ValueError, match="needs CUDA"):
        da.paged_verify_attention(q, k, v, lens, tables, wk, wv, impl="kernel")
    with pytest.raises(RuntimeError, match="inference-only"):
        da.paged_verify_attention(q.requires_grad_(True), k, v, lens, tables, wk, wv)


# --------------------------------------------------------------- verify step
PS, POOL = 8, 20


def _setup(cfg, bits, seed, quantized_weights=False):
    """Prefill three prompts (5, 8 and 3 tokens) into a pool, as the engine
    does; returns the JAX and port params, the pool, tables and lengths."""
    rng = np.random.default_rng(seed)
    jparams = G.init_params(cfg, jax.random.PRNGKey(seed))
    lens = np.array([5, 8, 3], np.int32)
    ids = rng.integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    dense = G.init_cache(cfg, 3, 16, jnp.float32)
    _, dense = jax.jit(G.forward_with_cache, static_argnums=0)(cfg, jparams, jnp.asarray(ids),
                                                               dense)
    tables = np.array([[4, 7, 13, 0], [2, 11, 15, 0], [9, 17, 0, 0]], np.int32)
    paged = G.init_paged_cache(cfg, POOL, PS, jnp.float32, kv_bits=bits)
    paged = G.write_prompt_kv_batch(paged, dense, jnp.asarray(tables), jnp.asarray(lens))
    if quantized_weights:
        jparams = G.quantize_for_inference(cfg, jparams, bits=8, group_size=32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_numpy(np_params, "cpu"), paged, tables, lens, rng


VARIANTS = {"learned": {}, "rotary": dict(rotary=True, rotary_pct=0.5),
            "parallel_rotary": dict(rotary=True, parallel_residual=True),
            "d96": dict(n_head=2, d_model=192)}  # head dim 96


@pytest.mark.parametrize("variant,bits,qweights", [
    ("learned", None, False), ("rotary", None, False), ("parallel_rotary", None, False),
    ("learned", 8, False), ("rotary", 4, False), ("learned", None, True),
    ("d96", None, False), ("d96", 8, False), ("d96", 4, False)],
    ids=["learned", "rotary", "parallel_rotary", "kv8", "kv4", "int8_weights", "d96",
         "d96-kv8", "d96-kv4"])
def test_paged_verify_step_matches_jax(variant, bits, qweights):
    """A 4-token window at mixed lengths on ``tiny``: logits and the window
    K/V to 1e-5; the pools are left as they were."""
    cfg = dataclasses.replace(G.PRESETS["tiny"], **VARIANTS[variant])
    tcfg = dataclasses.replace(TG.PRESETS["tiny"], **VARIANTS[variant])
    jparams, params, paged, tables, lens, rng = _setup(cfg, bits, 5, qweights)
    win = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    ref, rk, rv = jax.jit(G.paged_verify_step, static_argnums=0, static_argnames="impl")(
        cfg, jparams, jnp.asarray(win), paged, jnp.asarray(tables), jnp.asarray(lens),
        impl="gather")
    tpaged = {k: torch.from_numpy(np.array(v)) for k, v in paged.items()}
    before = {k: v.clone() for k, v in tpaged.items()}
    out, wk, wv = TG.paged_verify_step(tcfg, params, torch.from_numpy(win), tpaged,
                                       torch.from_numpy(tables), torch.from_numpy(lens))
    assert out.shape == (3, 4, cfg.vocab_size)
    assert wk.shape == wv.shape == (cfg.n_layer, 3, 4, cfg.n_head, cfg.head_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(wk.numpy(), np.asarray(rk), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(wv.numpy(), np.asarray(rv), atol=LOGIT_ATOL, rtol=0)
    for key in tpaged:
        assert torch.equal(tpaged[key], before[key]), key


def test_paged_verify_step_rejects_alibi():
    cfg = dataclasses.replace(TG.PRESETS["tiny"], alibi=True)
    with pytest.raises(ValueError, match="alibi"):
        TG.paged_verify_step(cfg, {}, np.zeros((1, 2), np.int32), {}, np.zeros((1, 1)),
                             np.zeros(1))


# ------------------------------------------------------------------ commit
L, HC, DC, W = 2, 4, 16, 4


def _commit_case(bits, rng):
    """Pools with real content, three rows (mid-page, page-opening, and a
    window reaching the table's capacity) and the window's K/V, with
    outliers that grow mid-page scales."""
    tables = np.array([[3, 9, 5], [7, 2, 11], [4, 8, 6]], np.int32)
    lens = np.array([5, 8, 21], np.int32)  # row 2: positions 21..24, capacity 24
    if bits is None:
        pools = {k: rng.standard_normal((L, HC, 12, PS, DC), dtype=np.float32)
                 for k in ("k_pages", "v_pages")}
    else:
        dq = DC // 2 if bits == 4 else DC
        pools = {k: rng.integers(-8, 8, (L, HC, 12, PS, dq)).astype(np.int8)
                 for k in ("k_pages", "v_pages")}
        pools.update({k: rng.uniform(0.05, 0.2, (L, HC, 12)).astype(np.float32)
                      for k in ("k_scales", "v_scales")})
    wk, wv = (rng.standard_normal((L, 3, W, HC, DC), dtype=np.float32) * 3.0 for _ in range(2))
    return pools, wk, wv, tables, lens


def _compare(out, ref, skip_sink=False):
    for key in ref:
        a, b = out[key].numpy(), np.asarray(ref[key])
        if skip_sink:
            a, b = a[:, :, 1:], b[:, :, 1:]
        if "scales" in key:
            np.testing.assert_allclose(a, b, rtol=SCALE_RTOL, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("n", [[0, 2, 4], [4, 0, 3], [1, 4, 4], [3, 1, 0]])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
def test_commit_window_kv_matches_jax(bits, n):
    """``n_commit`` from 0 to W per row, a row at the table's capacity: the
    pools bitwise the reference's (scales to 1e-6). Dense pools are compared
    whole, the sink page 0 included (one scatter in step order leaves it as
    the sequential writes do); quantized pools without the sink, whose
    duplicate-index requantize leaves an order-dependent, never-read
    content."""
    rng = np.random.default_rng(sum(n) + (bits or 0))
    pools, wk, wv, tables, lens = _commit_case(bits, rng)
    ref = G.commit_window_kv({k: jnp.asarray(v) for k, v in pools.items()}, jnp.asarray(wk),
                             jnp.asarray(wv), jnp.asarray(tables), jnp.asarray(lens),
                             jnp.asarray(np.array(n, np.int32)))
    out = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    got = TG.commit_window_kv(out, torch.from_numpy(wk), torch.from_numpy(wv),
                              torch.from_numpy(tables), torch.from_numpy(lens),
                              torch.tensor(n))
    assert got is out
    _compare(out, ref, skip_sink=bits is not None)
    # a row committing nothing leaves its pages as they were
    for row in np.flatnonzero(np.array(n) == 0):
        for key, v in pools.items():
            np.testing.assert_array_equal(out[key].numpy()[:, :, tables[row]],
                                          v[:, :, tables[row]], err_msg=key)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
def test_commit_equals_one_step_commits(bits):
    """The one-shot commit equals committing each window step on its own
    (token i at position lengths + i for rows still inside their prefix)."""
    rng = np.random.default_rng(7)
    pools, wk, wv, tables, lens = _commit_case(bits, rng)
    n = np.array([1, 3, 4])
    out = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    TG.commit_window_kv(out, torch.from_numpy(wk), torch.from_numpy(wv), tables, lens, n)
    ref = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    for i in range(W):
        TG.commit_window_kv(ref, torch.from_numpy(wk[:, :, i:i + 1]),
                            torch.from_numpy(wv[:, :, i:i + 1]), tables, lens + i,
                            (n > i).astype(np.int64))
    for key in ref:
        assert torch.equal(out[key][:, :, 1:], ref[key][:, :, 1:]), key


def test_verify_then_commit_equals_sequential_decode_steps():
    """Dense pools: a W-token window whose drafts are the greedy continuation
    gives the logits of W sequential ``paged_decode_step`` calls to 1e-5 with
    every argmax equal, and committing all W leaves the pools the sequential
    steps leave, to 1e-5. (Over quantized pools the window attends its own
    positions at dense precision where the sequential steps read them back
    quantized, so there the two agree only to quantization tolerance; the
    commit itself is held bitwise above.)"""
    cfg = G.PRESETS["tiny"]
    tcfg = TG.PRESETS["tiny"]
    _, params, paged, tables, lens, rng = _setup(cfg, None, 6)
    seq = {k: torch.from_numpy(np.array(v)) for k, v in paged.items()}
    spec = {k: v.clone() for k, v in seq.items()}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, 3).astype(np.int64))
    cur, seq_logits, window = torch.from_numpy(lens), [], [toks]
    for _ in range(W):
        lg, _ = TG.paged_decode_step(tcfg, params, window[-1], seq, tables, cur)
        seq_logits.append(lg)
        window.append(lg.argmax(-1))
        cur = cur + 1
    win = torch.stack(window[:W], dim=1)
    vlog, wk, wv = TG.paged_verify_step(tcfg, params, win, spec, tables, lens)
    for i in range(W):
        np.testing.assert_allclose(vlog[:, i].numpy(), seq_logits[i].numpy(), atol=LOGIT_ATOL,
                                   rtol=0)
        assert torch.equal(vlog[:, i].argmax(-1), seq_logits[i].argmax(-1)), i
    TG.commit_window_kv(spec, wk, wv, tables, lens, torch.full((3,), W))
    for key in seq:
        np.testing.assert_allclose(spec[key][:, :, 1:].numpy(), seq[key][:, :, 1:].numpy(),
                                   atol=LOGIT_ATOL, rtol=0, err_msg=key)
