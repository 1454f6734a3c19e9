"""The port's paged KV cache vs the JAX package's: the page allocator, the
pool layout and its byte price, the prompt scatter (dense and quantized),
the quantized decode append, and the paged decode step.

Inputs are numpy from a seed and cross to both packages as numpy; weights
cross through ``deepspeed_tpu_torch.bridge``. Tolerances: payloads and dense
pools bitwise; scales rtol 1e-6 (the same fp32 divide, which XLA may turn
into a reciprocal multiply); decode-step logits atol 1e-5 (fp32 on both
sides, matmuls summed in another order).
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import gpt as G
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference.serving.paging import RESERVED_PAGE, PageAllocator, pages_for
from deepspeed_tpu_torch.models import gpt as TG

SCALE_RTOL = 1e-6
LOGIT_ATOL = 1e-5


# ---------------------------------------------------------------- allocator
def test_pages_for():
    assert pages_for(0, 8) == 0
    assert pages_for(1, 8) == 1
    assert pages_for(8, 8) == 1
    assert pages_for(9, 8) == 2


def test_allocator_never_double_allocates():
    """Random alloc/free interleavings never hand out a page twice, never
    lose a page, and never touch the reserved sink."""
    rng = np.random.default_rng(0)
    alloc = PageAllocator(64)
    held = []
    for _ in range(2000):
        if held and rng.random() < 0.45:
            alloc.free(held.pop(rng.integers(len(held))))
        else:
            n = int(rng.integers(1, 6))
            pages = alloc.alloc(n)
            if pages is None:
                assert alloc.free_pages < n  # refusal only under pressure
                continue
            assert len(pages) == n
            held.append(pages)
        outstanding = [p for ps in held for p in ps]
        assert len(outstanding) == len(set(outstanding)), "double allocation"
        assert RESERVED_PAGE not in outstanding
        assert alloc.free_pages + len(outstanding) == 63  # conservation
    for ps in held:
        alloc.free(ps)
    assert alloc.free_pages == 63
    assert alloc.allocated_pages == 0


def test_allocator_free_is_checked():
    alloc = PageAllocator(8)
    pages = alloc.alloc(3)
    alloc.free(pages)
    with pytest.raises(ValueError, match="double-free"):
        alloc.free(pages)
    with pytest.raises(ValueError, match="reserved"):
        alloc.free([RESERVED_PAGE])
    with pytest.raises(ValueError):
        PageAllocator(1)  # nothing left after the sink


def test_allocator_all_or_nothing():
    alloc = PageAllocator(6)  # 5 usable
    assert alloc.alloc(7) is None
    assert alloc.free_pages == 5  # a failed alloc takes nothing
    got = alloc.alloc(5)
    assert got is not None and alloc.free_pages == 0


def test_allocator_audit_conservation():
    """audit() is clean through alloc/free churn and names the violated
    invariant when the ledger is corrupted."""
    rng = np.random.default_rng(3)
    alloc = PageAllocator(32)
    held = []
    for _ in range(300):
        if held and rng.random() < 0.5:
            alloc.free(held.pop(rng.integers(len(held))))
        else:
            pages = alloc.alloc(int(rng.integers(1, 4)))
            if pages is not None:
                held.append(pages)
        rep = alloc.audit()
        assert rep["ok"], rep
        assert rep["free"] + rep["allocated"] == rep["total"] == 31
    assert alloc.allocated_ids == frozenset(p for ps in held for p in ps)
    a = PageAllocator(8)
    del a._ref[a.alloc(2)[0]]
    rep = a.audit()
    assert not rep["ok"] and any("conservation" in e for e in rep["errors"])
    b = PageAllocator(8)
    b._free.append(b._free[0])
    assert any("duplicate" in e for e in b.audit()["errors"])
    c = PageAllocator(8)
    c._ref[c._free[0]] = 1
    assert any("both free and allocated" in e for e in c.audit()["errors"])
    d = PageAllocator(8)
    d._ref[d.alloc(1)[0]] = 0
    assert any("refcount" in e for e in d.audit()["errors"])


def test_allocator_share_free_materialize_cycles():
    """Random alloc/share/free/materialize interleavings conserve pages; a
    page returns to the free list only when its last reference dies."""
    rng = np.random.default_rng(7)
    alloc = PageAllocator(48)
    held = []
    for _ in range(600):
        r = rng.random()
        if held and r < 0.30:
            for p in alloc.free(held.pop(rng.integers(len(held)))):
                assert alloc.refcount(p) == 0
        elif held and r < 0.55:
            ref = held[rng.integers(len(held))]
            alloc.share(ref)
            held.append(list(ref))
        elif held and r < 0.65:
            ref = held[rng.integers(len(held))]
            i = rng.integers(len(ref))
            before = alloc.refcount(ref[i])
            got = alloc.materialize(ref[i])
            if got is None:
                assert alloc.free_pages == 0
            elif before == 1:
                assert got == ref[i]
            else:
                assert got != ref[i] and alloc.refcount(got) == 1
                ref[i] = got
        else:
            pages = alloc.alloc(int(rng.integers(1, 4)))
            if pages is not None:
                held.append(pages)
        assert alloc.audit()["ok"]
        want = Counter(p for ref in held for p in ref)
        assert all(alloc.refcount(p) == n for p, n in want.items())
        assert set(want) == set(alloc.allocated_ids)
    with pytest.raises(ValueError, match="reserved"):
        alloc.share([RESERVED_PAGE])


# ------------------------------------------------------------- pool layout
@pytest.mark.parametrize("kv_bits,dtype", [(None, "float32"), (None, "bfloat16"), (8, "float32"),
                                           (4, "bfloat16")])
def test_init_paged_cache_and_bytes_match_jax(kv_bits, dtype):
    cfg = G.PRESETS["tiny"]
    ref = G.init_paged_cache(cfg, 7, 8, getattr(jnp, dtype), kv_bits=kv_bits)
    out = TG.init_paged_cache(TG.PRESETS["tiny"], 7, 8, getattr(torch, dtype), kv_bits=kv_bits,
                              device="cpu")
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert tuple(out[key].shape) == ref[key].shape
        assert str(out[key].dtype).split(".")[-1] == ref[key].dtype.name
        np.testing.assert_array_equal(out[key].float().numpy(),
                                      np.asarray(ref[key], np.float32))
    assert TG.paged_cache_bits(out, cfg.head_dim) == G.paged_cache_bits(ref, cfg.head_dim)
    assert (TG.paged_kv_bytes_per_token(TG.PRESETS["tiny"], kv_bits, 8, getattr(torch, dtype))
            == G.paged_kv_bytes_per_token(cfg, kv_bits, 8, getattr(jnp, dtype)))


# ----------------------------------------------------------------- scatter
L, H, Dh, PS, POOL = 2, 4, 16, 8, 12


def _pools(bits, rng):
    """Random pool contents (so that a stray or a missing write shows)."""
    if bits is None:
        pools = {k: rng.standard_normal((L, H, POOL, PS, Dh), dtype=np.float32)
                 for k in ("k_pages", "v_pages")}
    else:
        dq = Dh // 2 if bits == 4 else Dh
        pools = {k: rng.integers(-128, 128, (L, H, POOL, PS, dq)).astype(np.int8)
                 for k in ("k_pages", "v_pages")}
        pools.update({k: rng.uniform(0.5, 40.0, (L, H, POOL)).astype(np.float32)
                      for k in ("k_scales", "v_scales")})
    return pools


def _compare_pools(out, ref):
    for key in ref:
        a, b = out[key].numpy(), np.asarray(ref[key])
        if "scales" in key:
            np.testing.assert_allclose(a, b, rtol=SCALE_RTOL, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
def test_write_prompt_kv_batch_matches_jax(bits):
    """Three rows over a 24-position scratch and 2-page tables (the scratch
    is longer than the table): a partial second page, a full table written
    from start 8 (its first page borrowed), and an inactive row of length 0.
    Everything the reference drops stays as it was."""
    rng = np.random.default_rng(0)
    pools = _pools(bits, rng)
    dense = {k: rng.standard_normal((L, 3, H, 24, Dh), dtype=np.float32) * 3
             for k in ("k", "v")}
    tables = np.array([[3, 9], [5, 7], [0, 0]], np.int32)
    lengths = np.array([11, 16, 0], np.int32)
    starts = np.array([0, 8, 0], np.int32)
    ref = G.write_prompt_kv_batch({k: jnp.asarray(v) for k, v in pools.items()},
                                  {k: jnp.asarray(v) for k, v in dense.items()},
                                  jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(starts))
    out = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    TG.write_prompt_kv_batch(out, {k: torch.from_numpy(v) for k, v in dense.items()},
                             tables, lengths, starts)
    _compare_pools(out, ref)
    # the single-row form is the batch form of one row
    one = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    TG.write_prompt_kv(one, {k: torch.from_numpy(v) for k, v in dense.items()}, tables[0], 11,
                       row=0)
    ref_one = G.write_prompt_kv({k: jnp.asarray(v) for k, v in pools.items()},
                                {k: jnp.asarray(v) for k, v in dense.items()},
                                jnp.asarray(tables[0]), jnp.int32(11), row=0)
    _compare_pools(one, ref_one)


def test_write_prompt_kv_refuses_a_length_past_the_table():
    pools = {k: torch.zeros(L, H, POOL, PS, Dh) for k in ("k_pages", "v_pages")}
    dense = {k: torch.zeros(L, 1, H, 24, Dh) for k in ("k", "v")}
    with pytest.raises(ValueError, match="past the block table"):
        TG.write_prompt_kv(pools, dense, np.array([3, 9]), 17)


# ---------------------------------------------------------- quantized append
def _append_case(case, bits, rng):
    """pages [H, P, ps, Dq], scales [H, P], tok [H, B, Dh], page/off [B] for
    three rows on distinct pages: 'opening' (offset 0 over a page whose scale
    is a previous tenant's 37.0), 'grow' (one mid-page row's token exceeds its
    page scale, so every row's page requantizes), 'steady' (no scale grows)."""
    qmax = 127 if bits == 8 else 7
    dq = Dh // 2 if bits == 4 else Dh
    pages = rng.integers(-qmax - 1, qmax + 1, (H, POOL, PS, Dh)).astype(np.int8)
    if bits == 4:
        pages = np.asarray(G._pack_kv_int4(jnp.asarray(pages)))
    assert pages.shape[-1] == dq
    scales = rng.uniform(0.05, 0.2, (H, POOL)).astype(np.float32)
    page = np.array([2, 5, 9])
    off = np.array([3, 1, 6])
    tok = rng.uniform(-1, 1, (H, 3, Dh)).astype(np.float32) * 0.04 * qmax
    if case == "opening":
        off[1] = 0
        scales[:, 5] = 37.0
    elif case == "grow":
        tok[:, 2] *= 10.0
    return np.array(pages), scales, tok, page, off


@pytest.mark.parametrize("case", ["opening", "grow", "steady"])
@pytest.mark.parametrize("bits", [8, 4])
def test_append_kv_token_matches_jax(case, bits):
    rng = np.random.default_rng({"opening": 1, "grow": 2, "steady": 3}[case] + bits)
    pages, scales, tok, page, off = _append_case(case, bits, rng)
    ref_pages, ref_scales = G._append_kv_token(jnp.asarray(pages), jnp.asarray(scales),
                                               jnp.asarray(tok), jnp.asarray(page),
                                               jnp.asarray(off), bits)
    tp, ts = torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy())
    TG._append_kv_token(tp, ts, torch.from_numpy(tok), torch.from_numpy(page),
                        torch.from_numpy(off), bits)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(ref_pages))
    np.testing.assert_allclose(ts.numpy(), np.asarray(ref_scales), rtol=SCALE_RTOL, atol=0)
    grew = not np.array_equal(ts.numpy()[:, page[off > 0]], scales[:, page[off > 0]])
    assert grew == (case == "grow")
    if case == "opening":  # the opened page's scale comes from its own token
        assert (ts.numpy()[:, 5] < 1.0).all()


# ------------------------------------------------------------- decode step
def _decode_setup(cfg, bits, seed):
    """Prefill three prompts (5, 8 and 3 tokens) into a pool, as the engine
    does: forward_with_cache into a dense scratch, then the batch scatter."""
    rng = np.random.default_rng(seed)
    jparams = G.init_params(cfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    lens = np.array([5, 8, 3], np.int32)
    ids = rng.integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    dense = G.init_cache(cfg, 3, 16, jnp.float32)
    _, dense = jax.jit(G.forward_with_cache, static_argnums=0)(cfg, jparams, jnp.asarray(ids),
                                                               dense)
    tables = np.array([[4, 7, 0, 0], [2, 11, 0, 0], [9, 0, 0, 0]], np.int32)
    paged = G.init_paged_cache(cfg, POOL, PS, jnp.float32, kv_bits=bits)
    paged = G.write_prompt_kv_batch(paged, dense, jnp.asarray(tables), jnp.asarray(lens))
    toks = rng.integers(0, cfg.vocab_size, (3, 3)).astype(np.int32)
    return jparams, np_params, paged, tables, lens, toks


@pytest.mark.parametrize("variant,bits", [("learned", None), ("rotary", None),
                                          ("parallel_rotary", None), ("learned", 8),
                                          ("rotary", 4), ("d96", None), ("d96", 8),
                                          ("d96", 4)])
def test_paged_decode_step_matches_jax(variant, bits):
    """Three decode steps at mixed lengths (crossing a page boundary) on
    ``tiny``: logits to 1e-5 and the pools afterwards. Learned and rotary
    positions, the parallel residual, and int8 / int4 pools."""
    over = {"learned": {}, "rotary": dict(rotary=True, rotary_pct=0.5),
            "parallel_rotary": dict(rotary=True, parallel_residual=True),
            "d96": dict(n_head=2, d_model=192)}[variant]  # head dim 96
    cfg = dataclasses.replace(G.PRESETS["tiny"], **over)
    tcfg = dataclasses.replace(TG.PRESETS["tiny"], **over)
    jparams, np_params, paged, tables, lens, toks = _decode_setup(cfg, bits, seed=5)
    params = params_from_numpy(np_params, "cpu")
    tpaged = {k: torch.from_numpy(np.array(v)) for k, v in paged.items()}
    lengths = lens.copy()
    step = jax.jit(G.paged_decode_step, static_argnums=0, static_argnames="impl")
    for t in range(3):
        ref, paged = step(cfg, jparams, jnp.asarray(toks[:, t]), paged, jnp.asarray(tables),
                          jnp.asarray(lengths), impl="gather")
        out, tpaged = TG.paged_decode_step(tcfg, params, torch.from_numpy(toks[:, t]), tpaged,
                                           torch.from_numpy(tables), torch.from_numpy(lengths))
        assert out.shape == (3, cfg.vocab_size)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)
        lengths += 1
    # the appended K/V come out of each package's own matmuls (fp32, summed
    # in another order): values to the logits' tolerance, int payloads to
    # one quantization step, scales to 1e-5
    for key in paged:
        a, b = tpaged[key].numpy().astype(np.float64), np.asarray(paged[key], np.float64)
        tol = dict(atol=LOGIT_ATOL) if bits is None else (
            dict(rtol=1e-5, atol=0) if "scales" in key else dict(atol=1))
        np.testing.assert_allclose(a, b, **tol, err_msg=key)


@pytest.mark.parametrize("bits", [None, 8], ids=["dense", "kv8"])
def test_inactive_slots_on_the_sink_page_do_not_reach_active_rows(bits):
    """Inactive slots (length 0, a table row of page 0) all append at page 0,
    offset 0: duplicate writes whose winner is unspecified. Page 0 is never
    read as valid, so the active rows' logits and pages must not depend on
    the sink's content or on the inactive slots' tokens."""
    cfg = G.PRESETS["tiny"]
    _, np_params, paged, tables, lens, toks = _decode_setup(cfg, bits, seed=6)
    params = params_from_numpy(np_params, "cpu")
    tables = np.concatenate([tables, np.zeros((3, 4), np.int32)])
    lengths = np.concatenate([lens, np.zeros(3, np.int32)])
    results = []
    for fill, inactive_tok in ((0, 1), (7, 200)):
        tpaged = {k: torch.from_numpy(np.array(v)) for k, v in paged.items()}
        for key in tpaged:
            tpaged[key][:, :, 0] = fill  # the sink's content
        ids = np.concatenate([toks[:, 0], np.full(3, inactive_tok, np.int32)])
        out, tpaged = TG.paged_decode_step(TG.PRESETS["tiny"], params, torch.from_numpy(ids),
                                           tpaged, torch.from_numpy(tables),
                                           torch.from_numpy(lengths))
        results.append((out[:3], {k: v[:, :, 1:] for k, v in tpaged.items()}))
    (a, pa), (b, pb) = results
    assert torch.equal(a, b)
    for key in pa:
        assert torch.equal(pa[key], pb[key]), key
