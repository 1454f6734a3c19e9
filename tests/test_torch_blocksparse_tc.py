"""The tensor-core route of the port's blocksparse attention (B9): its route,
and the plain versions of its rounding against the JAX package's B9.

``blocksparse_attention_split_ref`` and ``blocksparse_attention_bwd_split_ref``
compute what the card's tensor-core kernels compute for bf16 / fp16 inputs
(the forward and the backward at every block: 16-bit operands, fp32 sums, P
and dS as hi + lo halves of the dtype, fp16 with its powers of two; the
kernels' 64-token tiles hold several blocks of 16 or 32, the forward's
running maximum moves once a tile, and the backward's fp16 row scales run
over those tiles). The reference side is
``deepspeed_tpu.ops.pallas.blocksparse_attention`` in the same dtype (the
Pallas kernels in interpret mode on the CPU, as
``tests/test_sparse_attention.py`` runs them): every operand widened to fp32,
the outputs rounded once to the dtype, which is the reference's fp32
function. Inputs and the output cotangent come from numpy with a seed; B1,
H2, T512.

Tolerances. The split versions keep P and dS to ~2^-16 (bf16) / ~2^-22
(fp16) of the fp32 function, another summation order besides, so after both
round to the dtype o, dq, dk and dv are within 2 ulps of the dtype of
JAX's on every entry of at least 1e-3 of the largest (below that,
cancellation makes an ulp of the entry smaller than the sums' error); lse
within 1e-4. The backward takes JAX's o and lse, as JAX's backward does. A
single cast of P (2^-8 / 2^-11) misses that bar, so the check has teeth.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import blocksparse_attention as jbs
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

from _torch_ulps import ulp_err

H, T = 2, 512
MAX_ULP = 2.0
LSE_ATOL = 1e-4


def _empty_row_and_column(n, causal):
    """Block row 2 of head 1 and block column 1 of head 0 with no active
    block (a dense or causal layout otherwise)."""
    layout = np.ones((H, n, n), np.int64)
    if causal:
        layout = np.tril(layout)
    layout[1, 2] = 0
    layout[0, :, 1] = 0
    return layout


def _layout(kind, block):
    n = T // block
    if kind == "fixed":
        return sa.FixedSparsityConfig(H, block=block, num_local_blocks=2,
                                      attention="unidirectional").make_layout(T)
    if kind == "bigbird":
        return sa.BigBirdSparsityConfig(H, block=block, different_layout_per_head=True,
                                        attention="unidirectional", seed=3).make_layout(T)
    if kind == "longformer":
        return sa.BSLongformerSparsityConfig(H, block=block).make_layout(T)
    return _empty_row_and_column(n, causal=kind == "empty-causal")


# (id, layout kind, block, D, causal, dtype, dO scale)
CASES = [
    ("fixed-128-bf16", "fixed", 128, 64, True, "bfloat16", 1.0),
    ("fixed-128-fp16", "fixed", 128, 64, True, "float16", 1.0),
    ("fixed-64-d96-bf16", "fixed", 64, 96, True, "bfloat16", 1.0),
    ("fixed-64-d96-fp16", "fixed", 64, 96, True, "float16", 1.0),
    ("bigbird-per-head-64-bf16", "bigbird", 64, 64, True, "bfloat16", 1.0),
    ("bigbird-per-head-128-d96-fp16", "bigbird", 128, 96, True, "float16", 1.0),
    ("longformer-128-noncausal-bf16", "longformer", 128, 64, False, "bfloat16", 1.0),
    ("longformer-64-noncausal-d96-fp16", "longformer", 64, 96, False, "float16", 1.0),
    ("empty-row-col-64-bf16", "empty", 64, 64, False, "bfloat16", 1.0),
    ("empty-row-col-128-causal-fp16", "empty-causal", 128, 64, True, "float16", 1.0),
    ("fixed-128-fp16-small-grad", "fixed", 128, 64, True, "float16", 2.0**-8),
    ("bigbird-per-head-64-d96-fp16-small-grad", "bigbird", 64, 96, True, "float16", 2.0**-8),
    ("fixed-16-bf16", "fixed", 16, 64, True, "bfloat16", 1.0),
    ("longformer-32-noncausal-d96-fp16", "longformer", 32, 96, False, "float16", 1.0),
    ("bigbird-per-head-32-fp16-small-grad", "bigbird", 32, 64, True, "float16", 2.0**-8),
]


def _inputs(D, dtype, do_scale, seed):
    """q, k, v, dO [1, T, H, D] as numpy fp32 values representable in ``dtype``."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((1, T, H, D), dtype=np.float32) for _ in range(4)]
    xs[3] *= do_scale
    return [torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy() for x in xs]


def _jax(q, k, v, do, layout, block, causal, dtype):
    """JAX's (o, lse [B*H, T], (dq, dk, dv)) in fp32: the Pallas custom_vjp in
    ``dtype``, and its forward's lse."""
    args = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)]

    def f(q, k, v):
        return jbs.blocksparse_attention(q, k, v, layout, block, causal=causal)

    o, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do, getattr(jnp, dtype)))
    kidx, kcnt, _, _ = (jnp.asarray(t) for t in jbs.layout_tables(layout))
    D = q.shape[-1]
    flat = [x.transpose(0, 2, 1, 3).reshape(H, T, D) for x in args]
    _, lse = jbs._fwd(*flat, kidx, kcnt, H, 1.0 / np.sqrt(D), causal, block)
    as_torch = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32)))  # noqa: E731
    return as_torch(o), torch.from_numpy(np.asarray(lse)[:, :, 0].copy()), [
        as_torch(g) for g in grads]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_refs_within_two_ulps_of_jax(case):
    """The tensor-core route's rounding gives the reference's fp32 function:
    o, dq, dk, dv within 2 ulps of JAX's in the dtype, lse within 1e-4; a
    q-block row with no active block gives o = 0, lse = -1e30 and dq = 0, a
    k-block column with none dk = dv = 0."""
    _, kind, block, D, causal, dtype, do_scale = case
    layout = _layout(kind, block)
    q, k, v, do = _inputs(D, dtype, do_scale, seed=block + D)
    o_ref, lse_ref, g_ref = _jax(q, k, v, do, layout, block, causal, dtype)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    o, lse = bs.blocksparse_attention_split_ref(tq, tk, tv, layout, block, causal)
    assert o.dtype == tdt and o.shape == tq.shape and lse.shape == (H, T)
    assert ulp_err(o, o_ref, tdt) <= MAX_ULP
    assert (lse - lse_ref).abs().max().item() <= LSE_ATOL
    # the backward from JAX's o and lse, as JAX's backward takes them: delta =
    # rowsum(dO * o) moves entries near the 1e-3 floor by many of their ulps
    # when o differs in a last bit
    grads = bs.blocksparse_attention_bwd_split_ref(tq, tk, tv, o_ref.to(tdt), lse_ref, tdo,
                                                   layout, block, causal)
    for g, r, name in zip(grads, g_ref, ("dq", "dk", "dv")):
        assert g.dtype == tdt and g.shape == tq.shape, name
        assert ulp_err(g, r, tdt) <= MAX_ULP, name
    if kind.startswith("empty"):
        rows = slice(2 * block, 3 * block)
        assert (o[:, rows, 1] == 0).all() and (lse[1, rows] == -1e30).all()
        assert (grads[0][:, rows, 1] == 0).all()
        cols = slice(block, 2 * block)
        assert (grads[1][:, cols, 0] == 0).all() and (grads[2][:, cols, 0] == 0).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_single_cast_of_p_misses_the_bar(dtype):
    """The 2-ulp bar tells the hi + lo split from one cast of P: o and dV
    with P cast once to the dtype (stochastic_mode's rounding) are more than
    2 ulps from the fp32 function, where the split versions are within it."""
    layout, block, D = _layout("fixed", 128), 128, 64
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(tdt) for x in _inputs(D, dtype, 1.0, seed=7))
    o, lse = bs.blocksparse_attention_fwd_ref(q, k, v, layout, block, True)
    ref = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, True)
    p = bs._probs(q, k, lse, layout, block, True, bs._scale(q, None))
    o_cast = torch.einsum("bhts,bshd->bthd", p.to(tdt).float(), v.float()).to(tdt)
    dv_cast = torch.einsum("bhts,bthd->bshd", p.to(tdt).float(), do.float()).to(tdt)
    assert ulp_err(o_cast, o, tdt) > MAX_ULP
    assert ulp_err(dv_cast, ref[2], tdt) > MAX_ULP
    split, _ = bs.blocksparse_attention_split_ref(q, k, v, layout, block, True)
    split_dv = bs.blocksparse_attention_bwd_split_ref(q, k, v, o, lse, do, layout, block)[2]
    assert ulp_err(split, o, tdt) <= MAX_ULP and ulp_err(split_dv, ref[2], tdt) <= MAX_ULP


def _route(dtype, block, pass_):
    return "tf32" if dtype == torch.float32 else "tc"


ROUTES = [(dt, block, D, pass_, _route(dt, block, pass_))
          for dt in (torch.float32, torch.bfloat16, torch.float16)
          for block in (16, 32, 64, 128) for D in (64, 96, 128) for pass_ in ("fwd", "bwd")]


@pytest.mark.parametrize("dtype,block,D,pass_,route", ROUTES,
                         ids=[f"{str(r[0])[6:]}-b{r[1]}-d{r[2]}-{r[3]}" for r in ROUTES])
def test_bs_route(dtype, block, D, pass_, route):
    """Both passes on the tensor cores at every block: bf16 / fp16 on 16-bit
    operands ("tc"), fp32 as 3xTF32 ("tf32"). At every head dim the kernels
    are built for."""
    assert bs.bs_route(dtype, block, D, pass_) == route


@pytest.mark.parametrize("dtype,block,D,error", [
    (torch.bfloat16, 8, 64, NotImplementedError), (torch.bfloat16, 256, 64, NotImplementedError),
    (torch.float16, 64, 80, NotImplementedError), (torch.float32, 32, 32, NotImplementedError),
    (torch.float64, 64, 64, TypeError), (torch.int8, 128, 64, TypeError)])
def test_bs_route_raises_for_unbuilt_shapes_and_dtypes(dtype, block, D, error):
    with pytest.raises(error):
        bs.bs_route(dtype, block, D, "bwd")


def test_work_order_puts_the_longest_lists_first():
    """The kernels hand out (head, tile) pairs by their count, largest
    first, ties in index order; the device tables carry the tile tables,
    which every kernel walks, with an order for each count. At blocks of 128
    a query tile's list is its block's list expanded to 64-key tiles, in the
    same ascending order."""
    cnt = np.array([[1, 3, 2], [3, 0, 1]], np.int32)
    assert bs.work_order(cnt).tolist() == [1, 3, 2, 0, 5, 4]
    layout = _layout("fixed", 128)
    t = bs.device_tables(layout, 128, "cpu")
    for got, ref in zip((t.qt_idx, t.qt_cnt, t.qt_mask, t.kt_idx, t.kt_cnt, t.kt_mask),
                        bs.tile_tables(layout, 128)):
        np.testing.assert_array_equal(got.numpy(), ref)
    kidx, kcnt, _, _ = bs.layout_tables(layout)
    for tile in range(t.qt_cnt.shape[1]):
        blocks = kidx[:, tile // 2, :]
        for h in range(H):
            want = [2 * j + f for j in blocks[h, :kcnt[h, tile // 2]] for f in (0, 1)]
            assert t.qt_idx[h, tile, :t.qt_cnt[h, tile]].tolist() == want
    for order, cnt in ((t.qt_order, t.qt_cnt), (t.kt_order, t.kt_cnt)):
        assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(cnt.numel()))
        assert (np.diff(cnt.reshape(-1)[order.long()].numpy()) <= 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cpu_tensors_never_reach_a_library(monkeypatch, dtype):
    """On CPU tensors every wrapper runs its plain version in every dtype
    (the tensor-core route's blocks included): nothing is built or loaded,
    and no launch counter moves."""
    def refuse(name):
        raise AssertionError(f"a CPU call reached the kernel library {name}")

    monkeypatch.setattr(_build, "load", refuse)
    counters = ("fwd_tc_launches", "fwd_tf32_launches", "bwd_dq_tc_launches",
                "bwd_dkv_tc_launches", "bwd_dq_tf32_launches", "bwd_dkv_tf32_launches")
    before = [getattr(bs, c) for c in counters]
    layout, block = _layout("fixed", 128), 128
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _inputs(64, "float32", 1.0, seed=9))
    tables = bs.device_tables(layout, block, "cpu")
    o, lse = bs.blocksparse_attention_fwd(q, k, v, layout, block, tables=tables)
    grads = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, tables=tables)
    assert [getattr(bs, c) for c in counters] == before
    ref_o, ref_lse = bs.blocksparse_attention_fwd_ref(q, k, v, layout, block, True)
    torch.testing.assert_close(o, ref_o, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    for g in grads:
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
