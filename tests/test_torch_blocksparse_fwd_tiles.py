"""The forward kernels' walk over the tile tables and the 3xTF32 forward's
arithmetic of the port's blocksparse attention (B9) vs the JAX package's B9,
on the CPU.

On the card, B9's forward walks :func:`tile_tables` as its dq pass does: each
64-query tile's ascending list of 64-key tiles, each with the bit mask of its
active block x block sub-blocks (blocks of 16 and 32 share a tile), an
online softmax whose running maximum moves once a tile, and an entry whose
bit is clear hidden by the test (P set to 0, not left to exp's underflow).
fp32 inputs take the 3xTF32 kernel (``bs_route``'s "tf32"), bf16 / fp16 the
16-bit one. Here:

- ``blocksparse_attention_fwd_tiles_ref``, a plain fp32 model of that walk,
  gives JAX's o and lse within 1e-5 of the largest entry of each at blocks
  16 / 32 / 64 / 128 for every sparsity family, at T off 64-token tiles, for
  a row whose first listed tile hides it and for a row that no listed tile
  shows (o = 0, lse = -1e30);
- ``blocksparse_attention_fwd_tf32_ref``, the CPU model of the 3xTF32
  kernel's arithmetic (TF32 emulated on the fp32 bits), lies within 1e-5 of
  the largest entry of JAX's o and lse and of the plain version's, where one
  TF32 pass (~2^-11 a term) misses that bar.

The JAX side is ``deepspeed_tpu.ops.pallas.blocksparse_attention``'s forward
(``_fwd``, its Pallas kernel in interpret mode on the CPU, as
``tests/test_torch_blocksparse_tf32.py`` runs it), fp32. Inputs come from
numpy with a seed; B1, H2, T <= 256.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import blocksparse_attention as jbs
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

H = 2
RTOL = 1e-5
NEG_INF = -1e30


def _family(kind, block, T):
    """(layout [H, T/block, T/block], causal) of one sparsity family:
    unidirectional families and a bidirectional Fixed layout under causal
    (the blocks above the diagonal skipped), the others not causal."""
    if kind == "fixed-uni":
        return sa.FixedSparsityConfig(H, block=block, num_local_blocks=2,
                                      attention="unidirectional").make_layout(T), True
    if kind == "fixed-bi":
        return sa.FixedSparsityConfig(H, block=block, num_local_blocks=2).make_layout(T), True
    if kind == "variable":
        return sa.VariableSparsityConfig(H, block=block, num_random_blocks=1,
                                         different_layout_per_head=True,
                                         seed=4).make_layout(T), False
    if kind == "bigbird":
        return sa.BigBirdSparsityConfig(H, block=block, num_random_blocks=1,
                                        num_sliding_window_blocks=3, num_global_blocks=1,
                                        different_layout_per_head=True, seed=3,
                                        attention="unidirectional").make_layout(T), True
    if kind == "longformer":
        return sa.BSLongformerSparsityConfig(H, block=block,
                                             num_sliding_window_blocks=3).make_layout(T), False
    if kind == "sliding":
        return sa.LocalSlidingWindowSparsityConfig(H, block=block,
                                                   num_sliding_window_blocks=3).make_layout(T), True
    if kind == "dense":
        return sa.DenseSparsityConfig(H, block=block).make_layout(T), False
    return _hidden_rows(T // block), False


def _hidden_rows(n):
    """A layout of n x n blocks (not causal) in which block row 0's only
    block lies in the last column (so at blocks of 16 / 32 the first tile of
    its query tile's list, which block row 1 fills, hides it), block row 2
    (where n > 2) has none (its query tile's listed tiles never show it),
    and every other row holds its diagonal block and block column 0."""
    layout = np.zeros((H, n, n), np.int64)
    layout[:, 0, n - 1] = 1
    layout[:, 1, :2] = 1
    for i in range(3, n):
        layout[:, i, i] = layout[:, i, 0] = 1
    if n > 4:
        layout[1, 4, n // 2] = 1  # head 1 differs
    return layout


def _inputs(T, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, T, H, D), dtype=np.float32) for _ in range(3)]


def _jax_forward(q, k, v, layout, block, causal):
    """JAX's fp32 (o [1, T, H, D], lse [H, T]) as torch tensors."""
    T, D = q.shape[1], q.shape[-1]
    flat = [jnp.asarray(x.transpose(0, 2, 1, 3).reshape(H, T, D)) for x in (q, k, v)]
    kidx, kcnt, _, _ = (jnp.asarray(t) for t in jbs.layout_tables(layout))
    o, lse = jbs._fwd(*flat, kidx, kcnt, H, 1.0 / np.sqrt(D), causal, block)
    o = np.asarray(o).reshape(1, H, T, D).transpose(0, 2, 1, 3).copy()
    return torch.from_numpy(o), torch.from_numpy(np.asarray(lse)[:, :, 0].copy())


def _errors(o, lse, o_ref, lse_ref):
    """o's largest error relative to o_ref's largest entry, and lse's
    relative to the largest |lse| of the rows that see a key (rows that see
    none must be exactly -1e30 in both, which the caller checks)."""
    seen = lse_ref > NEG_INF / 2
    o_rel = ((o - o_ref).abs().max() / o_ref.abs().max()).item()
    lse_rel = ((lse - lse_ref)[seen].abs().max() / lse_ref[seen].abs().max()).item()
    return o_rel, lse_rel


def _check_empty_rows(o, lse, lse_ref):
    empty = lse_ref <= NEG_INF / 2
    assert torch.equal(lse[empty], lse_ref[empty])
    o_rows = o[0].transpose(0, 1)  # [H, T, D]
    assert (o_rows[empty] == 0).all()
    return int(empty.sum())


FAMILIES = ["fixed-uni", "fixed-bi", "variable", "bigbird", "longformer", "sliding", "dense",
            "hidden-rows"]


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", FAMILIES)
def test_tile_walk_gives_jax_forward(kind, block):
    """Every family at every block (T 256): the walk over the tile tables,
    with a running maximum per 64-key tile and hidden entries zeroed by the
    bit, gives JAX's o and lse within 1e-5 of the largest entry."""
    T = 256
    layout, causal = _family(kind, block, T)
    q, k, v = _inputs(T, 64, seed=block + len(kind))
    o_ref, lse_ref = _jax_forward(q, k, v, layout, block, causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = bs.blocksparse_attention_fwd_tiles_ref(tq, tk, tv, layout, block, causal)
    assert o.shape == tq.shape and o.dtype == torch.float32 and lse.shape == (H, T)
    o_rel, lse_rel = _errors(o, lse, o_ref, lse_ref)
    assert o_rel <= RTOL and lse_rel <= RTOL, (o_rel, lse_rel)
    empty = _check_empty_rows(o, lse, lse_ref)
    if kind == "hidden-rows" and layout.shape[1] > 2:  # block row 2 of each head
        assert empty == H * block


@pytest.mark.parametrize("block,T,kind", [(16, 128, "hidden-rows"), (32, 128, "hidden-rows"),
                                          (16, 208, "hidden-rows"), (32, 224, "hidden-rows"),
                                          (16, 208, "sliding"), (32, 224, "fixed-uni")])
def test_tile_walk_hidden_rows_and_t_off_64(block, T, kind):
    """A row whose first listed tile hides it (its maximum still -1e30 when
    the tile's other rows see keys), a row that no listed tile shows (o = 0,
    lse = -1e30), and T off 64-token tiles (the last tile's rows past T
    zero, their bits clear): o and lse within 1e-5 of JAX's largest entry."""
    layout, causal = _family(kind, block, T)
    q, k, v = _inputs(T, 64, seed=T + block)
    o_ref, lse_ref = _jax_forward(q, k, v, layout, block, causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = bs.blocksparse_attention_fwd_tiles_ref(tq, tk, tv, layout, block, causal)
    o_rel, lse_rel = _errors(o, lse, o_ref, lse_ref)
    assert o_rel <= RTOL and lse_rel <= RTOL, (o_rel, lse_rel)
    empty = _check_empty_rows(o, lse, lse_ref)
    if kind == "hidden-rows":
        assert empty == H * block  # block row 2 of each head
        # block row 0 sees only its last column, which its tile list reaches
        # after a tile that hides it (at blocks of 16 / 32)
        qt_idx, qt_cnt, qt_mask, *_ = bs.tile_tables(layout, block)
        g = bs.TILE // block
        first_bits = int(qt_mask[0, 0, 0])
        assert qt_idx[0, 0, 0] == 0 and not any((first_bits >> c) & 1 for c in range(g))
        assert (lse_ref[:, :block] > NEG_INF / 2).all()


# (id, family, block, T, D): every block, T off 64-token tiles, head dims 64
# / 96 / 128, rows hidden by their first tile and rows no tile shows
CASES = [
    ("fixed-uni-16", "fixed-uni", 16, 256, 64),
    ("variable-per-head-32", "variable", 32, 256, 64),
    ("longformer-32-noncausal-t224", "longformer", 32, 224, 64),
    ("sliding-16-t208-d96", "sliding", 16, 208, 96),
    ("bigbird-per-head-64", "bigbird", 64, 256, 64),
    ("fixed-bi-128-under-causal-d128", "fixed-bi", 128, 256, 128),
    ("hidden-rows-16", "hidden-rows", 16, 128, 64),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tf32_forward_model_matches_jax_and_plain(case):
    """The 3xTF32 arithmetic of the fp32 forward kernel: o and lse within
    1e-5 of the largest entry of JAX's and of the port's plain version's;
    one TF32 pass misses that bar (so the bar tells a dropped pass apart)."""
    _, kind, block, T, D = case
    layout, causal = _family(kind, block, T)
    q, k, v = _inputs(T, D, seed=block + D + 5)
    o_ref, lse_ref = _jax_forward(q, k, v, layout, block, causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = bs.blocksparse_attention_fwd_tf32_ref(tq, tk, tv, layout, block, causal)
    plain_o, plain_lse = bs.blocksparse_attention_fwd(tq, tk, tv, layout, block, causal)
    for ref in ((o_ref, lse_ref), (plain_o, plain_lse)):
        o_rel, lse_rel = _errors(o, lse, *ref)
        assert o_rel <= RTOL and lse_rel <= RTOL, (o_rel, lse_rel)
    _check_empty_rows(o, lse, lse_ref)
    one_o, one_lse = bs.blocksparse_attention_fwd_tf32_ref(tq, tk, tv, layout, block, causal,
                                                           passes=1)
    assert max(_errors(one_o, one_lse, o_ref, lse_ref)) > RTOL
