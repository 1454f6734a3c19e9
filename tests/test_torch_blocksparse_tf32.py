"""The backward kernels' tile tables and arithmetic of the port's blocksparse
attention (B9) vs the JAX package's B9, on the CPU.

On the card, B9's dq and dk/dv walk :func:`tile_tables`: the layout at the
kernels' 64-token tiles, each listed tile with the bit mask of its active
block x block sub-blocks (blocks of 16 and 32 share a tile). fp32 inputs take
the 3xTF32 kernels (``bs_route``'s "tf32"), bf16 / fp16 the 16-bit ones.
Here:

- the tables, for blocks 16 / 32 / 64 / 128 and every sparsity family (and
  random layouts), expand back to the layout bitwise, list no empty tile and
  list each row's tiles in ascending order;
- ``blocksparse_attention_bwd_tiles_ref``, a plain fp32 model that walks
  those tables as the kernels do, gives JAX's gradients: within 1e-5 of the
  largest entry of each (fp32 sums in another order);
- ``blocksparse_attention_bwd_tf32_ref``, the CPU model of the 3xTF32
  kernels' arithmetic (TF32 emulated on the fp32 bits), lies within 1e-5 of
  the largest entry of JAX's gradients and of the plain versions', where one
  TF32 pass (~2^-11 a term) misses that bar.

The JAX side is ``deepspeed_tpu.ops.pallas.blocksparse_attention`` (its
Pallas kernels in interpret mode on the CPU, as
``tests/test_torch_blocksparse_attention.py`` runs them), fp32. Inputs and
the output cotangent come from numpy with a seed; B1, H2, T <= 256.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import blocksparse_attention as jbs
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

H = 2
BWD_RTOL = 1e-5
TILE = bs.TILE


def _family(kind, block, T):
    """The [H, T/block, T/block] layout of one sparsity family."""
    if kind == "fixed-uni":
        return sa.FixedSparsityConfig(H, block=block, num_local_blocks=2,
                                      attention="unidirectional").make_layout(T)
    if kind == "fixed-bi":
        return sa.FixedSparsityConfig(H, block=block, num_local_blocks=2).make_layout(T)
    if kind == "variable":
        return sa.VariableSparsityConfig(H, block=block, num_random_blocks=1,
                                         different_layout_per_head=True, seed=4).make_layout(T)
    if kind == "bigbird":
        return sa.BigBirdSparsityConfig(H, block=block, num_random_blocks=1,
                                        num_sliding_window_blocks=3, num_global_blocks=1,
                                        different_layout_per_head=True, seed=3).make_layout(T)
    if kind == "longformer":
        return sa.BSLongformerSparsityConfig(H, block=block,
                                             num_sliding_window_blocks=3).make_layout(T)
    if kind == "sliding":
        return sa.LocalSlidingWindowSparsityConfig(H, block=block,
                                                   num_sliding_window_blocks=3).make_layout(T)
    if kind == "dense":
        return sa.DenseSparsityConfig(H, block=block).make_layout(T)
    # an empty block row (head 1) and an empty block column (head 0)
    n = T // block
    layout = np.ones((H, n, n), np.int64)
    layout[1, n // 2] = 0
    layout[0, :, 1] = 0
    return layout


def _elements(layout, block):
    """[H, T, T] bool: the layout expanded to its elements."""
    lay = np.asarray(layout).astype(bool)
    return lay.repeat(block, 1).repeat(block, 2)


def _expand(idx, cnt, msk, block, T, transposed):
    """[H, T, T] bool: the elements a tile table's listed tiles keep (their
    sub-block bits), rows queries; ``transposed`` for the key tiles' table
    (its rows are key tiles, its entries query tiles)."""
    Hn, nT = cnt.shape
    out = np.zeros((Hn, nT * TILE, nT * TILE), bool)
    g = max(1, TILE // block)
    sub = TILE // g
    for h in range(Hn):
        for i in range(nT):
            entries = idx[h, i, : cnt[h, i]]
            assert (np.diff(entries) > 0).all(), "a list is not ascending"
            for j, bits in zip(entries, msk[h, i, : cnt[h, i]]):
                assert bits != 0, "an empty tile is listed"
                qt, kt = (j, i) if transposed else (i, j)
                for r in range(g):
                    for c in range(g):
                        if (bits >> (r * g + c)) & 1:
                            out[h, qt * TILE + r * sub: qt * TILE + (r + 1) * sub,
                                kt * TILE + c * sub: kt * TILE + (c + 1) * sub] = True
    return out[:, :T, :T]


def _check_tables(layout, block):
    T = np.asarray(layout).shape[1] * block
    qt_idx, qt_cnt, qt_mask, kt_idx, kt_cnt, kt_mask = bs.tile_tables(layout, block)
    nT = -(-T // TILE)
    assert qt_cnt.shape == kt_cnt.shape == (layout.shape[0], nT)
    for t in (qt_idx, qt_cnt, qt_mask, kt_idx, kt_cnt, kt_mask):
        assert t.dtype == np.int32
    want = _elements(layout, block)
    np.testing.assert_array_equal(_expand(qt_idx, qt_cnt, qt_mask, block, T, False), want)
    np.testing.assert_array_equal(_expand(kt_idx, kt_cnt, kt_mask, block, T, True), want)
    # the two tables list the same tiles with the same bits
    assert qt_cnt.sum() == kt_cnt.sum()


FAMILIES = ["fixed-uni", "fixed-bi", "variable", "bigbird", "longformer", "sliding", "dense",
            "empty-row-col"]


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", FAMILIES)
def test_tile_tables_expand_back_to_the_layout(kind, block):
    """Every family at every block: the tables' tiles and sub-block bits
    expand to the layout's elements bitwise, in both orientations; no empty
    tile is listed and every list ascends."""
    _check_tables(_family(kind, block, 4 * max(block, TILE)), block)


@pytest.mark.parametrize("block,n", [(16, 13), (32, 7), (16, 1)])
def test_tile_tables_at_t_off_64(block, n):
    """T off 64-token tiles (blocks of 16 / 32): the last tile's sub-blocks
    past T stay clear."""
    _check_tables(_family("sliding", block, n * block), block)
    masks = bs.tile_masks(np.ones((H, n, n), np.int64), block)
    g = TILE // block
    last = (n - 1) % g  # the last real sub-block of the last tile
    bits = int(masks[0, -1, -1])
    assert bits == sum(1 << (r * g + c) for r in range(last + 1) for c in range(last + 1))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), block=st.sampled_from([16, 32, 64, 128]),
       n=st.integers(1, 12), heads=st.integers(1, 3), density=st.floats(0.0, 1.0))
def test_tile_tables_of_random_layouts(seed, block, n, heads, density):
    """Any 0/1 layout: the tables expand back to it bitwise."""
    layout = (np.random.default_rng(seed).random((heads, n, n)) < density).astype(np.int64)
    T = n * block
    qt_idx, qt_cnt, qt_mask, kt_idx, kt_cnt, kt_mask = bs.tile_tables(layout, block)
    want = _elements(layout, block)
    np.testing.assert_array_equal(_expand(qt_idx, qt_cnt, qt_mask, block, T, False), want)
    np.testing.assert_array_equal(_expand(kt_idx, kt_cnt, kt_mask, block, T, True), want)


# (id, family, block, T, D, causal): every block, T off 64-token tiles
# (longformer-32 T224, sliding-16 T208), head dims 64 / 96 / 128, an empty
# block row and column
CASES = [
    ("fixed-uni-16", "fixed-uni", 16, 256, 64, True),
    ("variable-per-head-32", "variable", 32, 256, 64, True),
    ("longformer-32-noncausal-t224", "longformer", 32, 224, 64, False),
    ("sliding-16-t208-d96", "sliding", 16, 208, 96, True),
    ("bigbird-per-head-64", "bigbird", 64, 256, 64, True),
    ("fixed-bi-128-under-causal-d128", "fixed-bi", 128, 256, 128, True),
    ("empty-row-col-16", "empty-row-col", 16, 128, 64, False),
]


def _inputs(T, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, T, H, D), dtype=np.float32) for _ in range(4)]


def _jax(q, k, v, do, layout, block, causal):
    """JAX's fp32 (o, lse [B*H, T], (dq, dk, dv)) as torch tensors."""
    args = [jnp.asarray(x) for x in (q, k, v)]

    def f(q, k, v):
        return jbs.blocksparse_attention(q, k, v, layout, block, causal=causal)

    o, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do))
    kidx, kcnt, _, _ = (jnp.asarray(t) for t in jbs.layout_tables(layout))
    T, D = q.shape[1], q.shape[-1]
    flat = [x.transpose(0, 2, 1, 3).reshape(H, T, D) for x in args]
    _, lse = jbs._fwd(*flat, kidx, kcnt, H, 1.0 / np.sqrt(D), causal, block)
    as_torch = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return as_torch(o), torch.from_numpy(np.asarray(lse)[:, :, 0].copy()), [
        as_torch(g) for g in grads]


def _rel(x, ref):
    return ((x - ref).abs().max() / ref.abs().max()).item()


def _case(case, seed):
    _, kind, block, T, D, causal = case
    layout = _family(kind, block, T)
    q, k, v, do = _inputs(T, D, seed)
    o, lse, grads = _jax(q, k, v, do, layout, block, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    return layout, block, causal, (tq, tk, tv, o, lse, tdo), grads


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tile_walk_gives_jax_gradients(case):
    """The kernels' walk over the tile tables (every listed tile, each entry
    kept by its sub-block bit and the causal mask; unlisted tiles add
    nothing), in fp32: dq, dk, dv within 1e-5 of JAX's largest entry; an
    empty block row has dq = 0, an empty block column dk = dv = 0."""
    layout, block, causal, args, ref = _case(case, seed=case[2])
    grads = bs.blocksparse_attention_bwd_tiles_ref(*args, layout, block, causal)
    for g, r, name in zip(grads, ref, ("dq", "dk", "dv")):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        assert _rel(g, r) <= BWD_RTOL, (name, _rel(g, r))
    if case[1] == "empty-row-col":
        n = layout.shape[1]
        rows = slice(n // 2 * block, (n // 2 + 1) * block)
        assert (grads[0][:, rows, 1] == 0).all()
        cols = slice(block, 2 * block)
        assert (grads[1][:, cols, 0] == 0).all() and (grads[2][:, cols, 0] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tf32_backward_model_matches_jax_and_plain(case):
    """The 3xTF32 arithmetic of the fp32 kernels: dq, dk, dv within 1e-5 of
    the largest entry of JAX's gradients and of the port's plain versions';
    one TF32 pass misses that bar on at least one of them (so the bar tells
    a dropped pass apart)."""
    layout, block, causal, args, ref = _case(case, seed=case[2] + 1)
    q, k, v, o, lse, do = args
    grads = bs.blocksparse_attention_bwd_tf32_ref(*args, layout, block, causal)
    plain = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal)
    one = bs.blocksparse_attention_bwd_tf32_ref(*args, layout, block, causal, passes=1)
    for g, r, p, name in zip(grads, ref, plain, ("dq", "dk", "dv")):
        assert _rel(g, r) <= BWD_RTOL, (name, _rel(g, r))
        assert _rel(g, p) <= BWD_RTOL, (name, _rel(g, p))
    assert max(_rel(g, r) for g, r in zip(one, ref)) > BWD_RTOL
