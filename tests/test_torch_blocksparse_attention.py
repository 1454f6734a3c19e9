"""The port's blocksparse attention (B9's plain versions, SparseSelfAttention,
the grafting utilities) vs the JAX package's.

The JAX side runs the Pallas kernels in interpret mode on the CPU, as
``tests/test_sparse_attention.py`` runs them; the port runs the plain
versions its wrappers take for CPU tensors. Inputs come from numpy with a
seed. Tolerances (fp32): o and lse within 1e-5 (online softmax against a
dense masked softmax, another summation order), dq/dk/dv within 1e-4 of
``jax.grad`` of sum(o * g) with a random cotangent g (the backward sums
over up to T keys); bf16 o within 2e-2 (both round the output to bf16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import blocksparse_attention as jbs
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

O_ATOL = 1e-5
LSE_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _empty_row_layout(H, n):
    """A hand-made layout whose block row 2 has no active block in head 1."""
    layout = np.tril(np.ones((H, n, n), np.int64))
    layout[1, 2] = 0
    return layout


# (id, config name or None, kwargs, B, T, H, D, causal)
CASES = [
    ("dense-causal", "DenseSparsityConfig", {"block": 8}, 2, 32, 2, 16, True),
    ("dense-full", "DenseSparsityConfig", {"block": 8}, 1, 32, 2, 16, False),
    ("fixed-uni", "FixedSparsityConfig", {"block": 8, "num_local_blocks": 2,
                                          "attention": "unidirectional"}, 2, 64, 2, 16, True),
    # the bidirectional default under causal=True: blocks above the diagonal masked
    ("fixed-bi-under-causal", "FixedSparsityConfig", {"block": 8, "num_local_blocks": 4},
     1, 64, 2, 16, True),
    ("fixed-bi", "FixedSparsityConfig", {"block": 8, "num_local_blocks": 4}, 1, 64, 2, 16,
     False),
    ("fixed-patterns-per-head", "FixedSparsityConfig", {
        "block": 8, "num_local_blocks": 4, "different_layout_per_head": True,
        "num_different_global_patterns": 2, "attention": "unidirectional"}, 1, 64, 2, 16, True),
    ("variable-random-per-head", "VariableSparsityConfig", {
        "block": 8, "num_random_blocks": 1, "different_layout_per_head": True, "seed": 2},
     1, 64, 2, 16, False),
    ("bigbird-per-head", "BigBirdSparsityConfig", {
        "block": 8, "different_layout_per_head": True, "attention": "unidirectional",
        "seed": 3}, 2, 64, 2, 16, True),
    ("longformer", "BSLongformerSparsityConfig", {"block": 8}, 1, 64, 2, 16, False),
    ("sliding-d64", "LocalSlidingWindowSparsityConfig", {"block": 16}, 1, 64, 2, 64, True),
    ("empty-row", None, {}, 1, 32, 2, 16, False),
]


def _case(case):
    _, name, kwargs, B, T, H, D, causal = case
    if name is None:
        return _empty_row_layout(H, T // 8), 8, B, T, H, D, causal
    layout = getattr(sa, name)(num_heads=H, **kwargs).make_layout(T)
    ref = getattr(jsa, name)(num_heads=H, **kwargs).make_layout(T)
    np.testing.assert_array_equal(layout, ref)
    return layout, kwargs.get("block", 128), B, T, H, D, causal


def _inputs(B, T, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_o_and_lse_match_jax(case):
    layout, block, B, T, H, D, causal = _case(case)
    q, k, v, _ = _inputs(B, T, H, D)
    ref = jbs.blocksparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout,
                                    block, causal=causal)
    tables = [jnp.asarray(t) for t in jbs.layout_tables(layout)]
    flat = [jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, T, D) for x in (q, k, v)]
    _, ref_lse = jbs._fwd(*flat, tables[0], tables[1], H, 1.0 / np.sqrt(D), causal, block)
    o, lse = bs.blocksparse_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), layout,
                                          block, causal)
    assert o.shape == (B, T, H, D) and lse.shape == (B * H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=O_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :, 0], atol=LSE_ATOL, rtol=0)
    if case[0] == "empty-row":  # l == 0 -> o = 0, lse = -1e30, as the kernel's l_safe
        rows = slice(2 * 8, 3 * 8)
        assert (o[:, rows, 1] == 0).all() and (lse[1, rows] == -1e30).all()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gradients_match_jax_grad(case):
    """dq/dk/dv through BlocksparseAttention (the plain dq and dk/dv passes)
    against jax.grad of sum(o * g) through the Pallas custom_vjp."""
    layout, block, B, T, H, D, causal = _case(case)
    q, k, v, g = _inputs(B, T, H, D, seed=1)

    def f(q, k, v):
        return (jbs.blocksparse_attention(q, k, v, layout, block, causal=causal) * g).sum()

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = bs.blocksparse_attention(tq, tk, tv, layout, block, causal=causal)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL, rtol=0)


def test_bf16_forward_matches_jax():
    layout, block, B, T, H, D, causal = _case(CASES[2])
    q, k, v, _ = _inputs(B, T, H, D, seed=2)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref = jbs.blocksparse_attention(*bf, layout, block, causal=causal)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16() for x in bf)
    o, _ = bs.blocksparse_attention_fwd(tq, tk, tv, layout, block, causal)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


def test_layout_shape_errors_match_jax():
    q = np.zeros((1, 32, 2, 16), np.float32)
    layout = np.ones((2, 3, 3), np.int64)
    with pytest.raises(ValueError) as ref:
        jbs.blocksparse_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), layout, 8)
    with pytest.raises(ValueError) as out:
        bs.blocksparse_attention(*(torch.from_numpy(q),) * 3, layout, 8)
    assert str(out.value) == str(ref.value)
    with pytest.raises(ValueError, match="multiple of block"):  # T=36 floors to 4 blocks
        bs.blocksparse_attention_fwd(*(torch.zeros(1, 36, 2, 16),) * 3,
                                     np.ones((2, 4, 4), np.int64), 8)


# ----------------------------------------------------------------- SparseSelfAttention
def test_sparse_self_attention_module_matches_jax():
    kwargs = {"block": 8, "attention": "unidirectional"}
    ref_mod = jsa.SparseSelfAttention(jsa.BigBirdSparsityConfig(num_heads=2, **kwargs))
    mod = sa.SparseSelfAttention(sa.BigBirdSparsityConfig(num_heads=2, **kwargs))
    assert isinstance(mod, torch.nn.Module) and not list(mod.parameters())
    assert mod.causal is ref_mod.causal is True
    q, k, v, _ = _inputs(1, 64, 2, 16, seed=3)
    ref = ref_mod(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = mod(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=O_ATOL, rtol=0)
    for T in (64, 128):
        assert mod.density(T) == ref_mod.density(T)
        np.testing.assert_array_equal(mod.get_layout(T), ref_mod.get_layout(T))
    with pytest.raises(ValueError, match="heads") as err:
        mod(*(torch.from_numpy(x[:, :, :1]) for x in (q, k, v)))
    with pytest.raises(ValueError) as ref_err:
        ref_mod(*(jnp.asarray(x[:, :, :1]) for x in (q, k, v)))
    assert str(err.value) == str(ref_err.value)


def test_tables_built_once_per_length_and_device(monkeypatch):
    """The functional path builds a config's layout and tables at the first
    call for a (config, T, device) and reuses them at every later call."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ssa

    built = []
    real = ssa.device_tables
    monkeypatch.setattr(ssa, "device_tables", lambda *a: built.append(a) or real(*a))
    cfg = sa.FixedSparsityConfig(num_heads=2, block=8, attention="unidirectional")
    mod = sa.SparseSelfAttention(cfg)
    for T in (32, 32, 64, 32, 64):
        x = torch.zeros(1, T, 2, 16)
        mod(x, x, x)
        sa.sparse_attention(x, x, x, cfg)
    assert [a[0].shape for a in built] == [(2, 4, 4), (2, 8, 8)]
    assert ssa._tables(cfg, 32, torch.device("cpu")) is ssa._tables(cfg, 32, torch.device("cpu"))
    assert sa.SparseSelfAttention().sparsity_config.num_heads == 4  # the reference's default


# --------------------------------------------------------------------------- utilities
def test_replace_self_attention_errors_match_jax():
    from deepspeed_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from deepspeed_tpu_torch.models.gpt import GPTConfig

    with pytest.raises(ValueError, match="heads") as ref:
        jsa.replace_self_attention_with_sparse(JaxGPTConfig(n_head=4),
                                               jsa.FixedSparsityConfig(num_heads=8))
    with pytest.raises(ValueError) as out:
        sa.replace_self_attention_with_sparse(GPTConfig(n_head=4),
                                              sa.FixedSparsityConfig(num_heads=8))
    assert str(out.value) == str(ref.value)

    class NotAModel:
        n_head = 4

    with pytest.raises(TypeError) as ref:
        jsa.replace_self_attention_with_sparse(NotAModel(), jsa.FixedSparsityConfig(4))
    with pytest.raises(TypeError) as out:
        sa.replace_self_attention_with_sparse(NotAModel(), sa.FixedSparsityConfig(4))
    assert str(out.value) == str(ref.value)
    sc = sa.FixedSparsityConfig(num_heads=4)
    assert sa.replace_self_attention_with_sparse(GPTConfig(n_head=4), sc).sparse_attention is sc


@pytest.mark.parametrize("rows,new", [(6, 15), (6, 7), (32, 64)])
def test_extend_position_embedding_bitwise_jax(rows, new):
    table = np.random.default_rng(rows).standard_normal((rows, 4)).astype(np.float32)
    ref = np.asarray(jsa.extend_position_embedding({"wpe": table, "wte": 1}, new)["wpe"])
    out = sa.extend_position_embedding({"wpe": torch.from_numpy(table), "wte": 1}, new)
    assert out["wte"] == 1 and out["wpe"].dtype == torch.float32
    assert out["wpe"].numpy().tobytes() == ref.tobytes()
    for bad in ({"wpe": table}, 4), ({"other": table}, 32):
        with pytest.raises(ValueError) as ref_err:
            jsa.extend_position_embedding(*bad)
        with pytest.raises(ValueError) as err:
            sa.extend_position_embedding({k: torch.from_numpy(v) for k, v in bad[0].items()},
                                         bad[1])
        assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("T,block", [(30, 16), (32, 16), (5, 8)])
def test_pad_unpad_match_jax(T, block):
    ids = np.random.default_rng(T).integers(1, 50, (2, T)).astype(np.int32)
    mask = np.ones((2, T), np.int32)
    ref_ids, ref_mask, ref_pad = jsa.pad_to_block_size(jnp.asarray(ids), block, pad_token_id=9,
                                                       attention_mask=jnp.asarray(mask))
    out_ids, out_mask, pad = sa.pad_to_block_size(torch.from_numpy(ids), block, pad_token_id=9,
                                                  attention_mask=torch.from_numpy(mask))
    assert pad == ref_pad
    np.testing.assert_array_equal(out_ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
    hidden = np.random.default_rng(1).standard_normal((2, T + pad, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        sa.unpad_sequence_output(torch.from_numpy(hidden), pad).numpy(),
        np.asarray(jsa.unpad_sequence_output(jnp.asarray(hidden), ref_pad)))
    assert sa.pad_to_block_size(torch.from_numpy(ids), block)[1] is None
