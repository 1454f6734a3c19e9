"""The flash-attention backward (B2) of the port vs the JAX package's.

The reference side is ``jax.vjp`` of ``deepspeed_tpu.ops.pallas.flash_attention``
(the custom-VJP Pallas kernels, in interpret mode on the CPU, as
tests/test_flash_attention.py runs them); the port side is its
:class:`FlashAttention` autograd Function and the plain
``flash_attention_bwd_ref``, which the Function takes on CPU tensors. Inputs
and the output cotangent come from numpy with a seed. Tolerances: fp32 atol
1e-5 (fp32 arithmetic in another order, gradients of O(1)); bf16 atol 5e-2
(both sides round q/k/v/dO and the gradients to bf16).
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
