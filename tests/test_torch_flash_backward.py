"""The flash-attention backward (B2) of the port vs the JAX package's.

The reference side is ``jax.vjp`` of ``deepspeed_tpu.ops.pallas.flash_attention``
(the custom-VJP Pallas kernels, in interpret mode on the CPU, as
tests/test_flash_attention.py runs them); the port side is its
:class:`FlashAttention` autograd Function and the plain
``flash_attention_bwd_ref``, which the Function takes on CPU tensors. Inputs
and the output cotangent come from numpy with a seed. Tolerances: fp32 atol
1e-5 (fp32 arithmetic in another order, gradients of O(1)); bf16 atol 5e-2
(both sides round q/k/v/dO and the gradients to bf16). The split plain
version (``flash_attention_bwd_split_ref``: P and dS as hi + lo halves of
the input dtype, the card's tensor-core rounding) is held to the same 5e-2
against JAX in bf16, and to 1 ulp of its dtype of the fp32 plain version on
entries of at least 1e-3 of the largest (its fp32 sums differ by ~2^-16 in
bf16, ~2^-22 in fp16 with its rows scaled, so the two round at most one step
apart).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.cuda import decode_attention as da
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.models import gpt

from _torch_ulps import ulp_err

B, H, D = 1, 2, 64


def _inputs(T, S, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, T, H, D), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, H, D), dtype=np.float32) for _ in range(2))
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, dtype):
    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, block_q=128, block_k=128)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    o, vjp = jax.vjp(f, *args)
    return np.asarray(o.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32))
                                               for g in vjp(jnp.asarray(do, dtype))]


@pytest.mark.parametrize("T,S,causal,dtype,atol", [
    (256, 256, True, "float32", 1e-5),
    (256, 256, False, "float32", 1e-5),
    (128, 256, True, "float32", 1e-5),  # bottom-right causal offset S - T
    (128, 128, True, "bfloat16", 5e-2),
], ids=["causal", "non-causal", "offset", "bf16"])
def test_backward_matches_jax_grad(T, S, causal, dtype, atol):
    q, k, v, do = _inputs(T, S)
    o_ref, g_ref = _jax_grads(q, k, v, do, causal, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v))
    dot = torch.from_numpy(do).to(tdt)

    # the autograd Function (the route models take with use_flash=True)
    o = fa.flash_attention(qt, kt, vt, causal=causal)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(o, (qt, kt, vt), dot)
    np.testing.assert_allclose(o.detach().float().numpy(), o_ref, rtol=0, atol=atol)
    for g, r, name in zip(grads, g_ref, "qkv"):
        assert g.dtype == tdt and g.shape == qt.shape[:1] + r.shape[1:]
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=atol, err_msg=name)

    # the plain version on its own, from the saved (o, lse)
    with torch.no_grad():
        o2, lse = fa.flash_attention_fwd(qt, kt, vt, causal)
        plain = fa.flash_attention_bwd_ref(qt, kt, vt, o2, lse, dot, causal)
    for g, p in zip(grads, plain):
        torch.testing.assert_close(g, p, rtol=0, atol=0)


def test_explicit_formulas_match_autograd_of_the_forward():
    """flash_attention_bwd_ref is written from its formulas; it agrees with
    autograd of the plain forward in float64, causal offset included."""
    q, k, v, do = (torch.from_numpy(x).double() for x in _inputs(64, 96, seed=1))
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    o, lse = fa.flash_attention_ref(qr, kr, vr, causal=True)
    auto = torch.autograd.grad(o, (qr, kr, vr), do.float())
    plain = fa.flash_attention_bwd_ref(q, k, v, o.detach(), lse.detach(), do, causal=True)
    for a, p in zip(auto, plain):
        torch.testing.assert_close(a.double(), p.double(), rtol=0, atol=1e-5)


def test_no_grad_runs_the_forward_alone():
    """Scoring and serving (no gradient wanted) go through the same
    Function, but autograd builds no node and saves nothing; with a
    gradient wanted it saves (q, k, v, o, lse)."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(64, 64))
    q.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        with torch.no_grad():
            assert fa.flash_attention(q, k, v).grad_fn is None
        assert fa.flash_attention(q.detach(), k, v).grad_fn is None
        assert saved == []
        assert fa.flash_attention(q, k, v).grad_fn is not None
        assert len(saved) == 5


def test_gpt_grads_through_flash_equal_plain_attention():
    """The whole model: loss gradients through the flash Function
    (use_flash=True) equal those through the plain attention path."""
    cfg = gpt.GPTConfig(vocab_size=256, n_layer=2, n_head=4, d_model=128, max_seq_len=64)
    params = gpt.init_params(cfg, 0, device="cpu")
    leaves = [params["wte"], params["blocks"]["qkv_w"], params["blocks"]["ln1_scale"]]
    for t in leaves:
        t.requires_grad_(True)
    ids = np.random.default_rng(0).integers(0, 256, (2, 64))
    grads = {}
    for use_flash in (True, False):
        c = dataclasses.replace(cfg, use_flash=use_flash)
        loss, _ = gpt.loss_fn(c, params, {"input_ids": ids})
        grads[use_flash] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


def test_decode_attention_refuses_autograd():
    """decode_attention has no backward: a call autograd would differentiate
    raises instead of cutting the graph; under no_grad it runs."""
    q = torch.randn(2, 1, 2, 64, requires_grad=True)
    cache = torch.randn(2, 2, 16, 64)
    with pytest.raises(RuntimeError, match="inference-only"):
        da.decode_attention(q, cache, cache, 5)
    with torch.no_grad():
        out = da.decode_attention(q, cache, cache, 5)
    assert out.shape == (2, 1, 2, 64) and out.grad_fn is None


SPLIT_CASES = [(256, 256, True), (256, 256, False), (128, 256, True)]
SPLIT_IDS = ["causal", "non-causal", "offset"]


@pytest.mark.parametrize("T,S,causal", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_ref_matches_jax_grad_bf16(T, S, causal):
    """The tensor-core kernels' rounding (P and dS as hi + lo bf16 halves)
    gives the reference's gradients: JAX's vjp of the Pallas kernels at the
    file's bf16 tolerance."""
    q, k, v, do = _inputs(T, S, seed=2)
    _, g_ref = _jax_grads(q, k, v, do, causal, jnp.bfloat16)
    qt, kt, vt, dot = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    o, lse = fa.flash_attention_fwd(qt, kt, vt, causal)
    grads = fa.flash_attention_bwd_split_ref(qt, kt, vt, o, lse, dot, causal)
    for g, r, name in zip(grads, g_ref, "qkv"):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=5e-2, err_msg=name)


@pytest.mark.parametrize("T,S,causal", SPLIT_CASES + [(100, 200, True)],
                         ids=SPLIT_IDS + ["ragged"])
def test_split_ref_within_one_ulp_of_the_fp32_function(T, S, causal):
    """hi + lo keeps P and dS to ~2^-16: the split version's bf16 gradients
    are within one bf16 ulp of flash_attention_bwd_ref's (the reference's
    fp32 function) on every entry of at least 1e-3 of the largest; a single
    bf16 cast of P and dS (stochastic_mode's function) is not."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(T, S, seed=3))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    split = fa.flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal)
    for a, r in zip(split, ref):
        assert ulp_err(a, r, torch.bfloat16) <= 1.0
    # the single cast, for contrast: dV = bf16(P)^T dO
    p = fa._probs(q, k, lse, causal, fa._scale(q, None)).to(torch.bfloat16).float()
    dv_cast = torch.einsum("bhts,bthd->bshd", p, do.float()).to(torch.bfloat16)
    assert ulp_err(dv_cast, ref[2], torch.bfloat16) > 1.0


@pytest.mark.parametrize("do_scale", [1.0, 2.0**-8], ids=["unit", "small-grad"])
@pytest.mark.parametrize("T,S,causal", SPLIT_CASES + [(100, 200, True)],
                         ids=SPLIT_IDS + ["ragged"])
def test_split_ref_fp16_within_one_ulp_of_the_fp32_function(T, S, causal, do_scale):
    """fp16: with each row of P and dS scaled by the kernels' running power
    of two before the split, the gradients are within one fp16 ulp of
    flash_attention_bwd_ref's, also for small gradients (dO 2^-8 of unit
    scale), where dS lies below fp16's normal range; a single fp16 cast of
    P, and the unscaled split of a small dS, are not."""
    q, k, v, do = (torch.from_numpy(x).to(torch.float16) for x in _inputs(T, S, seed=5))
    do = do * do_scale
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    split = fa.flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal)
    for a, r in zip(split, ref):
        assert a.dtype == torch.float16
        assert ulp_err(a, r, torch.float16) <= 1.0
    scale = fa._scale(q, None)
    p = fa._probs(q, k, lse, causal, scale)
    if do_scale == 1.0:  # dV = fp16(P)^T dO
        dv_cast = torch.einsum("bhts,bthd->bshd", p.half().float(), do.float()).half()
        assert ulp_err(dv_cast, ref[2], torch.float16) > 1.0
    else:  # dQ from the hi + lo halves of dS without the row scale
        dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
        delta = fa.flash_attention_bwd_delta_ref(o, do).reshape(B, H, T, 1)
        hi, lo = fa._split(p * (dp - delta) * scale, torch.float16)
        dq_unscaled = torch.einsum("bhts,bshd->bthd", hi + lo, k.float()).half()
        assert ulp_err(dq_unscaled, ref[0], torch.float16) > 1.0


def test_fp16_row_scale_follows_the_running_maximum():
    """The fp16 row exponent of a row streamed in 64-wide tiles: 0 before
    the first nonzero tile, then the largest e with every entry so far
    below 2^15, which only falls; the split halves undo it exactly."""
    x = torch.zeros(1, 1, 3, 192)
    x[0, 0, 0, 64:128] = 0.75  # tile 1: largest 0.75 -> e = 15
    x[0, 0, 0, 128] = 3.0  # tile 2: largest 3 -> e = 13
    x[0, 0, 0, 129] = 0.5  # smaller than the row's largest so far: e stays
    x[0, 0, 1, :64] = 2.0**-100  # far below fp16's range: e = 114
    x[0, 0, 2, 100] = 2.0**-140  # an fp32 subnormal: e clamps at 126
    e = fa._row_scale(x, -1)
    assert e[0, 0, 0, :64].eq(0).all() and e[0, 0, 0, 64:128].eq(15).all()
    assert e[0, 0, 0, 128:].eq(13).all() and e[0, 0, 1].eq(114).all()
    assert e[0, 0, 2, :64].eq(0).all() and e[0, 0, 2, 64:].eq(126).all()
    hi, lo = fa._split(x, torch.float16, -1)
    assert torch.equal(hi + lo, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cpu_tensors_take_the_plain_versions(dtype):
    """On CPU tensors every backward wrapper runs its plain version, in every
    dtype, and launches nothing: no kernel counter moves."""
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _inputs(64, 128, seed=4))
    counters = ("bwd_delta_launches", "bwd_dq_launches", "bwd_dkv_launches",
                "bwd_dq_tc_launches", "bwd_dkv_tc_launches")
    before = [getattr(fa, c) for c in counters]
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    delta = fa.flash_attention_bwd_delta(o, do)
    scale = fa._scale(q, None)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True, scale)
    assert [getattr(fa, c) for c in counters] == before
    ref = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, True)
    for g, w, r in zip(grads, (dq, dk, dv), ref):
        assert g.dtype == dtype
        torch.testing.assert_close(g, r, rtol=0, atol=0)
        torch.testing.assert_close(w, r, rtol=0, atol=0)
