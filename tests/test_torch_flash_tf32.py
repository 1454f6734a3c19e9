"""The fp32 flash kernels' arithmetic (3xTF32) vs the JAX package's flash
attention, on the CPU.

On the card, fp32 inputs take the 3xTF32 kernels (``flash_route``: B1's
forward, B2's dq and dk/dv): every product as three TF32 passes, big_a
big_b + big_a small_b + small_a big_b with big = tf32(x) and small = tf32(x
- big). Their CPU models, ``flash_attention_tf32_ref`` and
``flash_attention_bwd_tf32_ref`` (TF32 emulated on the fp32 bits), are held
here to the reference: ``deepspeed_tpu.ops.pallas.flash_attention`` (its
Pallas kernels in interpret mode on the CPU, as tests/test_flash_attention.py
runs them) and ``jax.vjp`` of it, and to the port's plain fp32 versions.
Inputs and the cotangent come from numpy with a seed; B1, H2, T <= 200, head
dims 64 / 96 / 128.

Tolerances are the fp32 bars the card checks (``chip_smoke.py``): o within
5e-5 (``ATOL``), lse within 1e-4 (``LSE_ATOL``), each gradient within 5e-5 of
its largest entry (``BWD_RTOL``). 3xTF32 keeps each term to ~2^-21 and lands
within 1/40 of each bar (1e-6 and below); one TF32 pass keeps ~2^-11 and
misses every bar by 2.8-28x, so the checks tell a dropped pass apart.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import gpt as jax_gpt
from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

ATOL, LSE_ATOL, BWD_RTOL = 5e-5, 1e-4, 5e-5
# (T, S, causal, D): causal, the bottom-right offset S - T, non-causal, head
# dims 96 and 128, a ragged T100 S200 (one JAX block each: its blocks must
# divide the lengths)
CASES = [(128, 128, True, 64), (64, 128, True, 64), (128, 128, False, 64),
         (128, 128, True, 96), (128, 128, True, 128), (100, 200, True, 64)]
IDS = ["causal", "offset", "non-causal", "d96", "d128", "ragged"]


def _inputs(T, S, D, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((1, T, 2, D), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, S, 2, D), dtype=np.float32) for _ in range(2))
    return q, k, v, do


def _blocks(T, S):
    return (64, 64) if T % 64 == 0 and S % 64 == 0 else (T, S)


def _jax(q, k, v, do, causal):
    """JAX's fp32 (o, lse [B*H, T], (dq, dk, dv)) as torch tensors."""
    bq, bk = _blocks(q.shape[1], k.shape[1])

    def f(q, k, v):
        return jax_flash.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)

    args = [jnp.asarray(x) for x in (q, k, v)]
    o, vjp = jax.vjp(f, *args)
    B, _, H, D = q.shape
    flat = [x.transpose(0, 2, 1, 3).reshape(B * H, -1, D) for x in args]
    _, lse = jax_flash._fwd(*flat, 1.0 / np.sqrt(D), causal, bq, bk, False)
    grads = vjp(jnp.asarray(do))
    return (torch.from_numpy(np.array(o)), torch.from_numpy(np.asarray(lse)[:, :, 0].copy()),
            [torch.from_numpy(np.array(g)) for g in grads])


def _rel(x, ref):
    return ((x - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("T,S,causal,D", CASES, ids=IDS)
def test_tf32_forward_model_matches_jax_and_plain(T, S, causal, D):
    """The 3xTF32 forward: o within ATOL and lse within LSE_ATOL of JAX's
    flash forward and of the plain fp32 version."""
    q, k, v, do = _inputs(T, S, D)
    o_jax, lse_jax, _ = _jax(q, k, v, do, causal)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = fa.flash_attention_tf32_ref(qt, kt, vt, causal)
    o_plain, lse_plain = fa.flash_attention_ref(qt, kt, vt, causal)
    assert o.dtype == torch.float32 and o.shape == qt.shape and lse.shape == (2, T)
    for o_ref, lse_ref in ((o_jax, lse_jax), (o_plain, lse_plain)):
        assert (o - o_ref).abs().max().item() <= ATOL
        assert (lse - lse_ref).abs().max().item() <= LSE_ATOL


@pytest.mark.parametrize("T,S,causal,D", CASES, ids=IDS)
def test_tf32_backward_model_matches_jax_and_plain(T, S, causal, D):
    """The 3xTF32 backward from the plain forward's (o, lse): dq, dk and dv
    within BWD_RTOL of their largest entries of JAX's gradients and of the
    plain fp32 version's."""
    q, k, v, do = _inputs(T, S, D, seed=1)
    _, _, grads_jax = _jax(q, k, v, do, causal)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_ref(qt, kt, vt, causal)
    grads = fa.flash_attention_bwd_tf32_ref(qt, kt, vt, o, lse, dot, causal)
    plain = fa.flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, causal)
    for g, j, p in zip(grads, grads_jax, plain):
        assert g.shape == p.shape and g.dtype == torch.float32
        assert _rel(g, j) <= BWD_RTOL
        assert _rel(g, p) <= BWD_RTOL


@pytest.mark.parametrize("T,S,causal,D", CASES, ids=IDS)
def test_one_tf32_pass_misses_the_fp32_bars(T, S, causal, D):
    """One TF32 pass (big_a big_b alone) is not the fp32 function: its o,
    lse and every gradient miss the bars against JAX that 3xTF32 meets."""
    q, k, v, do = _inputs(T, S, D, seed=2)
    o_jax, lse_jax, grads_jax = _jax(q, k, v, do, causal)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_tf32_ref(qt, kt, vt, causal, passes=1)
    assert (o - o_jax).abs().max().item() > ATOL
    assert (lse - lse_jax).abs().max().item() > LSE_ATOL
    o_plain, lse_plain = fa.flash_attention_ref(qt, kt, vt, causal)
    grads = fa.flash_attention_bwd_tf32_ref(qt, kt, vt, o_plain, lse_plain, dot, causal,
                                            passes=1)
    for g, j in zip(grads, grads_jax):
        assert _rel(g, j) > BWD_RTOL
    three = fa.flash_attention_tf32_ref(qt, kt, vt, causal)[0]
    assert (three - o_jax).abs().max().item() <= ATOL


def test_tf32_rounding_and_split():
    """tf32 rounds to nearest with ties away from zero onto 10 explicit
    mantissa bits (cvt.rna.tf32.f32); big + small restores x to ~2^-21."""
    one = 1.0 + 2.0**-10
    x = torch.tensor([1.0, 1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-11 + 2.0**-20,
                      1.0 + 2.0**-12, one + 2.0**-11], dtype=torch.float32)
    want = torch.tensor([1.0, one, -one, one, 1.0, one + 2.0**-10])
    assert torch.equal(fa._tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(4096, dtype=np.float32))
    big = fa._tf32(y)
    small = fa._tf32(y - big)
    assert not (big.view(torch.int32) & 0x1FFF).any() and not (small.view(torch.int32)
                                                                & 0x1FFF).any()
    assert ((big - y).abs() <= y.abs() * 2.0**-11).all()
    assert ((big + small - y).abs() <= y.abs() * 2.0**-21).all()


@pytest.mark.parametrize("dtype,route", [(torch.float32, "tf32"), (torch.bfloat16, "tc"),
                                         (torch.float16, "tc")])
@pytest.mark.parametrize("D", [64, 96, 128])
def test_flash_route_by_dtype_and_head_dim(dtype, route, D):
    """CUDA inputs take the 3xTF32 kernels in fp32 and the 16-bit
    tensor-core ones in bf16 / fp16, at every head dim the kernels are built
    for: no route by shape, and no CUDA-core forward, dq or dk/dv."""
    assert fa.flash_route(dtype, D) == route
    assert set(fa.ROUTES.values()) == {"tf32", "tc"}


@pytest.mark.parametrize("D", [32, 80, 256])
def test_flash_route_refuses_unbuilt_head_dims(D):
    with pytest.raises(NotImplementedError, match="head dim"):
        fa.flash_route(torch.float32, D)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_route(torch.float64, 64)


def test_tiny_gpt_through_the_tf32_models_matches_jax(monkeypatch):
    """The slice as a whole: a tiny fp32 GPT whose every attention forward
    and backward runs the 3xTF32 models (the card's fp32 route, on the
    flash path) gives JAX's loss to 1e-5 and every gradient within BWD_RTOL
    of its largest entry."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, causal=True, softmax_scale=None, stochastic=False):
        calls["fwd"] += 1
        return fa.flash_attention_tf32_ref(q, k, v, causal, softmax_scale)

    def bwd(q, k, v, o, lse, do, causal=True, softmax_scale=None, stochastic=False):
        calls["bwd"] += 1
        return fa.flash_attention_bwd_tf32_ref(q, k, v, o, lse, do, causal, softmax_scale)

    monkeypatch.setattr(fa, "flash_attention_ref", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    kw = dict(dataclasses.asdict(jax_gpt.PRESETS["tiny"]), use_flash=True)
    jcfg = jax_gpt.GPTConfig(**kw)
    jparams = jax_gpt.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = jax.tree_util.tree_map(lambda t: t.requires_grad_(True),
                                    params_from_numpy(tree, "cpu"))
    cfg = gpt.GPTConfig(**kw)
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: jax_gpt.loss_fn(jcfg, p, {"input_ids": jnp.asarray(ids)}, train=False),
        has_aux=True)(jparams)
    loss, _ = gpt.loss_fn(cfg, params, {"input_ids": ids}, train=False)
    loss.backward()
    assert calls == {"fwd": cfg.n_layer, "bwd": cfg.n_layer}
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for path, g in jax.tree_util.tree_leaves_with_path(ref_grads):
        t = params
        for p in path:
            t = t[p.key]
        want = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=BWD_RTOL * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))
