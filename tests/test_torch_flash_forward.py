"""The flash-attention forward (B1) of the port vs the JAX package's: the
tensor-core kernel's rounding and ``stochastic_mode``.

The reference side is ``deepspeed_tpu.ops.pallas.flash_attention`` (the
Pallas kernels in interpret mode on the CPU, blocks of 64, as
tests/test_flash_attention.py runs them) and ``jax.vjp`` of it; the port side
is its plain versions, which the wrappers take on CPU tensors. Inputs and the
output cotangent come from numpy with a seed; B1-2, H2, T <= 128 (S 2048 for
the long row).

Tolerances. ``flash_attention_split_ref`` (P as hi + lo halves of the input
dtype, fp16's times 2^14: the card's tensor-core rounding) keeps P to ~2^-16
(bf16) / ~2^-22 (fp16), so its 16-bit output is within 1 ulp of the dtype of
the fp32 function and of JAX's default path, on entries of at least 1e-3 of
the largest; a single cast of P (2^-8 / 2^-11) is not. The single-cast
function (``stochastic_mode``) rounds P once: where the port's fp32 P and
JAX's differ in their last bits, a few entries of P round the other way, so
it is held to JAX's at most 1 ulp of the dtype at the largest entry
(``ulp_of_max_err``) and bitwise on at least 99% of the entries (the default
function is bitwise on about 65%); lse within 1e-5.
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

from _torch_ulps import ulp_err, ulp_of_max_err

BLOCK = 64
# (T, S, causal, D): causal, non-causal, the bottom-right offset S - T, D128
CASES = [(128, 128, True, 64), (128, 128, False, 64), (64, 128, True, 64),
         (128, 128, True, 128)]
IDS = ["causal", "non-causal", "offset", "d128"]
DTYPES = ["bfloat16", "float16"]
# the single-cast function against JAX's: bitwise on at least this share
SINGLE_CAST_EQUAL = 0.99


def _inputs(T, S, D=64, B=1, H=2, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, T, H, D), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, H, D), dtype=np.float32) for _ in range(2))
    return q, k, v, do


def _torch(xs, dtype):
    return [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]


def _jax_forward(q, k, v, causal, dtype, stochastic=False):
    """JAX's (o, lse [B*H, T]) in fp32."""
    args = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)]
    o = jax_flash.flash_attention(*args, causal=causal, block_q=BLOCK, block_k=BLOCK,
                                  stochastic_mode=stochastic)
    B, _, H, D = q.shape
    flat = [x.transpose(0, 2, 1, 3).reshape(B * H, -1, D) for x in args]
    _, lse = jax_flash._fwd(*flat, 1.0 / np.sqrt(D), causal, BLOCK, BLOCK, stochastic)
    return (torch.from_numpy(np.array(o.astype(jnp.float32))),
            torch.from_numpy(np.asarray(lse)[:, :, 0].copy()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,S,causal,D", CASES, ids=IDS)
def test_split_ref_matches_jax_flash(T, S, causal, D, dtype):
    """The tensor-core forward's rounding gives the reference's default
    function: within 1 ulp of JAX's 16-bit output, lse within 1e-5."""
    q, k, v, _ = _inputs(T, S, D)
    o_ref, lse_ref = _jax_forward(q, k, v, causal, dtype)
    o, lse = fa.flash_attention_split_ref(*_torch((q, k, v), dtype), causal)
    assert o.dtype == getattr(torch, dtype) and o.shape == q.shape
    assert ulp_err(o, o_ref, o.dtype) <= 1.0
    assert (lse - lse_ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,S,causal,D", CASES + [(100, 200, True, 64)], ids=IDS + ["ragged"])
def test_split_ref_within_one_ulp_of_the_fp32_function(T, S, causal, D, dtype):
    """hi + lo keeps P to ~2^-16 / ~2^-22: the split version's output is
    within one ulp of flash_attention_ref's (the fp32 function); a single
    cast of P (stochastic_mode's function) is not."""
    q, k, v = _torch(_inputs(T, S, D, seed=1)[:3], dtype)
    ref, lse_ref = fa.flash_attention_ref(q, k, v, causal)
    split, lse = fa.flash_attention_split_ref(q, k, v, causal)
    cast, _ = fa.flash_attention_ref(q, k, v, causal, stochastic=True)
    assert ulp_err(split, ref, q.dtype) <= 1.0
    assert (lse - lse_ref).abs().max().item() <= 1e-5
    assert ulp_err(cast, ref, q.dtype) > 2.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_ref_long_row(dtype):
    """64 queries over 2048 keys: most of P lies below 2^-3, where fp16's lo
    half would be subnormal without the 2^14 on P; the split output stays
    within one ulp of the fp32 function, a single cast of P does not."""
    q, k, v = _torch(_inputs(64, 2048, seed=3)[:3], dtype)
    ref, lse = fa.flash_attention_ref(q, k, v, True)
    p = fa._probs(q, k, lse, True, fa._scale(q, None))
    visible = fa._visible(64, 2048, True, "cpu")
    assert (p[:, :, visible] < 2.0**-3).float().mean().item() > 0.9
    split, _ = fa.flash_attention_split_ref(q, k, v, True)
    cast, _ = fa.flash_attention_ref(q, k, v, True, stochastic=True)
    assert ulp_err(split, ref, q.dtype) <= 1.0
    assert ulp_err(cast, ref, q.dtype) > 2.0


def test_running_tile_max_and_fp16_scale():
    """The running maximum moves only between 64-key tiles; fp16's 2^14 on P
    is exact to apply and to undo (the split of P = 1 is hi = 1, lo = 0)."""
    s = torch.full((1, 1, 1, 130), -5.0)
    s[..., 3] = 1.0  # tile 0
    s[..., 70] = 2.0  # tile 1 raises it
    s[..., 129] = 0.5  # tile 2 keeps it
    m = fa._running_tile_max(s)
    assert m[..., :64].eq(1.0).all() and m[..., 64:].eq(2.0).all()
    q = torch.zeros(1, 64, 1, 64, dtype=torch.float16)
    k = torch.zeros(1, 64, 1, 64, dtype=torch.float16)
    v = torch.randn(1, 64, 1, 64).half()
    o, lse = fa.flash_attention_split_ref(q, k, v, causal=False)  # P = 1 everywhere
    assert ulp_err(o, v.float().mean(1, keepdim=True).expand_as(o), torch.float16) <= 0.5
    torch.testing.assert_close(lse, torch.full_like(lse, float(np.log(64.0))), rtol=0, atol=1e-6)


def _single_cast_close(x, ref, dtype):
    assert ulp_of_max_err(x, ref, dtype) <= 1.0
    assert (x.float() == ref.float()).float().mean().item() >= SINGLE_CAST_EQUAL


@pytest.mark.parametrize("T,S,causal,D", CASES, ids=IDS)
def test_stochastic_forward_and_grads_match_jax_bf16(T, S, causal, D):
    """stochastic_mode through the port's autograd Function (the CPU path:
    the single-cast plain versions) vs JAX's stochastic flash_attention and
    its vjp, in bf16; the default function is not as close."""
    q, k, v, do = _inputs(T, S, D, seed=2)
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]

    def f(q_, k_, v_):
        return jax_flash.flash_attention(q_, k_, v_, causal=causal, block_q=BLOCK,
                                         block_k=BLOCK, stochastic_mode=True)

    o_ref, vjp = jax.vjp(f, *args)
    g_ref = [torch.from_numpy(np.array(g.astype(jnp.float32)))
             for g in vjp(jnp.asarray(do, jnp.bfloat16))]
    o_ref = torch.from_numpy(np.array(o_ref.astype(jnp.float32)))
    _, lse_ref = _jax_forward(q, k, v, causal, "bfloat16", stochastic=True)

    qt, kt, vt = (t.requires_grad_(True) for t in _torch((q, k, v), "bfloat16"))
    o = fa.flash_attention(qt, kt, vt, causal=causal, stochastic_mode=True)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do).bfloat16())
    _single_cast_close(o.detach(), o_ref, torch.bfloat16)
    for g, r in zip(grads, g_ref):
        assert g.dtype == torch.bfloat16
        _single_cast_close(g, r, torch.bfloat16)
    with torch.no_grad():
        _, lse = fa.flash_attention_fwd(qt, kt, vt, causal, stochastic=True)
        default, _ = fa.flash_attention_fwd(qt, kt, vt, causal)
    assert (lse - lse_ref).abs().max().item() <= 1e-5
    assert (default.float() == o_ref).float().mean().item() < 0.9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_stochastic_plain_versions(dtype):
    """The single-cast backward is the reference's formulas with dO, P and
    dS rounded once to the input dtype and the scale on the product; for
    fp32 inputs stochastic_mode is the default function, bitwise."""
    q, k, v, do = _torch(_inputs(96, 128, seed=4), dtype)
    o, lse = fa.flash_attention_ref(q, k, v, True, stochastic=True)
    grads = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, True, stochastic=True)
    if dtype == "float32":
        ref = fa.flash_attention_ref(q, k, v, True)
        assert all(torch.equal(a, b) for a, b in zip((o, lse), ref))
        default = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, True)
        assert all(torch.equal(a, b) for a, b in zip(grads, default))
        return
    scale = fa._scale(q, None)
    B, T, H, _ = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    s = s.masked_fill(~fa._visible(T, 128, True, "cpu"), fa.NEG_INF)
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    c = q.dtype
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta) * scale
    want = (torch.einsum("bhts,bshd->bthd", ds.to(c).float(), k.float()).to(c),
            torch.einsum("bhts,bthd->bshd", ds.to(c).float(), q.float()).to(c),
            torch.einsum("bhts,bthd->bshd", p.to(c).float(), do.float()).to(c))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_tiny_gpt_stochastic_mode_matches_jax():
    """A tiny GPT in bf16 with stochastic_mode (the flash path forced, bridge
    weights): loss and every gradient match JAX's at rtol 2e-2 (atol 2e-2 of
    the leaf's largest), as tests/test_flash_attention.py holds the
    stochastic path; the flag reaches every layer's forward."""
    kw = dict(dataclasses.asdict(jax_gpt.PRESETS["tiny"]), use_flash=True, stochastic_mode=True)
    jcfg = jax_gpt.GPTConfig(**kw)
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                     jax_gpt.init_params(jcfg, jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)), jparams)
    params = jax.tree_util.tree_map(
        lambda t: t.to(torch.bfloat16).requires_grad_(True), params_from_numpy(tree, "cpu"))
    cfg = gpt.GPTConfig(**kw)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)

    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: jax_gpt.loss_fn(jcfg, p, {"input_ids": jnp.asarray(ids)}, train=False),
        has_aux=True)(jparams)
    flags = []
    fwd = fa.flash_attention_fwd

    def spy(*a, **kw_):
        flags.append(a[5] if len(a) > 5 else kw_.get("stochastic"))
        return fwd(*a, **kw_)

    fa.flash_attention_fwd = spy
    try:
        loss, _ = gpt.loss_fn(cfg, params, {"input_ids": ids}, train=False)
    finally:
        fa.flash_attention_fwd = fwd
    assert flags == [True] * cfg.n_layer
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=2e-2)
    for path, g in jax.tree_util.tree_leaves_with_path(ref_grads):
        t = params
        for p in path:
            t = t[p.key]
        want = np.asarray(g.astype(jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))
