"""The GPT variants of the port vs the JAX package's, with the same weights:
ALiBi (Bloom), GPT-Neo's alternating local window, and the chunked
cross-entropy (``loss_chunk``); and the paged paths' refusals of the biases.

Weights come from the JAX ``init_params`` and cross over through
``deepspeed_tpu_torch.bridge``; inputs come from numpy with a seed. All in
fp32 on the CPU. Tolerances: logits and losses 1e-5 absolute (the same
arithmetic in another summation order); gradients 1e-5 of each leaf's
largest entry; an engine trajectory rtol 1e-5 on the loss and 1e-4 on the
grad norm, as ``tests/test_torch_engine.py`` holds it.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as torch_leaves

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as jax_gpt
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import serving
from deepspeed_tpu_torch.models import gpt
from test_torch_engine import batch, config, engines

LOGIT_ATOL = 1e-5
LOSS_ATOL = 1e-5

TINY = dataclasses.asdict(jax_gpt.PRESETS["tiny"])
# bloom-7b1's flags (ALiBi, embedding LayerNorm, tied head) at tiny width, with
# a head count that is not a power of two
BLOOM_TINY = {**TINY, "n_head": 6, "d_model": 96, "alibi": True, "embed_layernorm": True,
              "tie_embeddings": True}
# GPT-Neo's alternation, with a window that bites at T 64
LOCAL = {**TINY, "local_attention_period": 2, "window_size": 16}
VARIANTS = {
    "bloom-flags-6-heads": BLOOM_TINY,
    # both biases summed on the last of three layers, alibi alone on the others
    "bloom-flags-local-period-3": {**BLOOM_TINY, "local_attention_period": 3,
                                   "window_size": 16, "n_layer": 3},
}


def _pair(cfg_kwargs, seed=0):
    """(jax cfg, jax params, port cfg, port params) from one JAX init."""
    jcfg = jax_gpt.GPTConfig(**cfg_kwargs)
    jparams = jax_gpt.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, gpt.GPTConfig(**cfg_kwargs), params_from_numpy(tree, "cpu")


def _ids(V, shape, seed=0):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def test_alibi_slopes_bitwise():
    for n in range(1, 65):
        ref = jax_gpt.alibi_slopes(n)
        out = gpt.alibi_slopes(n)
        assert out.dtype == ref.dtype == np.float32 and out.shape == (n,)
        np.testing.assert_array_equal(out, ref, err_msg=f"n_head={n}")


def test_bias_helpers_match_jax():
    cfg = gpt.GPTConfig(**{**LOCAL, "alibi": True})
    jcfg = jax_gpt.GPTConfig(**{**LOCAL, "alibi": True})
    pos = np.array([[3, 4, 5], [20, 21, 22]], np.int64)
    np.testing.assert_array_equal(gpt._alibi_bias(cfg, torch.from_numpy(pos), 24).numpy(),
                                  np.asarray(jax_gpt._alibi_bias(jcfg, jnp.asarray(pos), 24)))
    for layer in range(4):
        is_local = gpt._is_local_layer(cfg, layer)
        assert is_local == bool(jax_gpt._is_local_layer(jcfg, layer))
        np.testing.assert_array_equal(
            gpt._local_window_bias(cfg, torch.from_numpy(pos), 24, is_local).numpy(),
            np.asarray(jax_gpt._local_window_bias(jcfg, jnp.asarray(pos), 24, is_local)))
    assert gpt._is_local_layer(gpt.GPTConfig(**TINY), 1) is None


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_loss_and_grads_match_jax(name):
    jcfg, jparams, cfg, params = _pair(VARIANTS[name], seed=1)
    ids = _ids(cfg.vocab_size, (2, 64), seed=1)

    @jax.jit
    def reference(p, ids):
        loss, grads = jax.value_and_grad(
            lambda p: jax_gpt.loss_fn(jcfg, p, {"input_ids": ids}, train=False)[0])(p)
        return jax_gpt.forward(jcfg, p, ids, train=False), loss, grads

    ref_logits, ref_loss, jgrads = reference(jparams, jnp.asarray(ids))
    logits = gpt.forward(cfg, params, torch.from_numpy(ids), train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=LOGIT_ATOL, rtol=0)

    batch = {"input_ids": ids}
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(params)]
    loss, _ = gpt.loss_fn(cfg, params, batch, train=False)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=LOSS_ATOL, rtol=0)
    grads = torch.autograd.grad(loss, leaves)
    for g, r in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * max(np.abs(r).max(), 1e-3))


def test_bloom_flags_at_width_start_above_ln_v_like_jax():
    """Bloom's flags at d 1024 (one layer): the embedding LayerNorm and the
    tied head make the init's hidden state carry the input token's embedding
    / 0.02, so that token's own logit is ~ d * 0.02 and the first loss sits
    well above ln(V), in the JAX package as in the port (equal to 1e-5)."""
    kw = {**BLOOM_TINY, "n_layer": 1, "n_head": 8, "d_model": 1024, "vocab_size": 512}
    jcfg, jparams, cfg, params = _pair(kw, seed=5)
    ids = _ids(cfg.vocab_size, (2, 32), seed=5)
    ref = float(jax.jit(lambda p, i: jax_gpt.loss_fn(jcfg, p, {"input_ids": i}, train=False)[0])(
        jparams, jnp.asarray(ids)))
    loss = gpt.loss_fn(cfg, params, {"input_ids": ids}, train=False)[0].item()
    np.testing.assert_allclose(loss, ref, atol=LOSS_ATOL, rtol=0)
    assert loss > np.log(cfg.vocab_size) + 5


def test_window_bites_and_layers_alternate():
    """At T 64 a window of 16 changes the local layer's output, and with
    one layer of a period of 2 (layer 0, global) nothing changes."""
    base = gpt.GPTConfig(**TINY)
    params = gpt.init_params(base, 0, device="cpu")
    ids = torch.from_numpy(_ids(base.vocab_size, (2, 64)))
    dense = gpt.forward(base, params, ids, train=False)
    local = gpt.forward(dataclasses.replace(base, local_attention_period=2, window_size=16),
                        params, ids, train=False)
    assert torch.equal(dense[:, :16], local[:, :16])  # inside the window everywhere
    assert (dense[:, 16:] - local[:, 16:]).abs().max() > 1e-3
    one = {**params, "blocks": {k: v[:1] for k, v in params["blocks"].items()}}
    c1 = dataclasses.replace(base, n_layer=1)
    torch.testing.assert_close(
        gpt.forward(c1, one, ids, train=False),
        gpt.forward(dataclasses.replace(c1, local_attention_period=2, window_size=16), one,
                    ids, train=False), rtol=0, atol=0)


def test_cached_prefill_and_decode_match_jax_and_the_uncached_forward(monkeypatch):
    """Bloom's flags with a local layer: prefill 24 tokens, then 8
    single-token steps (the window of 16 bites from step 1), with
    ``use_flash=True`` on both sides: no decode step may reach the decode
    kernel (it has no bias input). Per-step logits agree with JAX's
    ``forward_with_cache`` and with the port's uncached forward over the
    same sequence."""
    jcfg, jparams, cfg, params = _pair(
        {**VARIANTS["bloom-flags-local-period-3"], "use_flash": True}, seed=2)
    ref_step = jax.jit(lambda p, ids, c: jax_gpt.forward_with_cache(jcfg, p, ids, c))

    def no_kernel(*a, **k):
        raise AssertionError("a biased decode step reached the decode kernel")

    monkeypatch.setattr(gpt, "decode_attention", no_kernel)
    rng = np.random.default_rng(2)
    prompt = _ids(cfg.vocab_size, (2, 24), seed=3)
    steps = rng.integers(0, cfg.vocab_size, (8, 2, 1)).astype(np.int32)
    jcache = jax_gpt.init_cache(jcfg, 2, 40, jnp.float32)
    cache = gpt.init_cache(cfg, 2, 40, torch.float32, "cpu")
    outs = []
    for ids in [prompt, *steps]:
        ref, jcache = ref_step(jparams, jnp.asarray(ids), jcache)
        out, cache = gpt.forward_with_cache(cfg, params, torch.from_numpy(ids), cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)
        outs.append(out)
    assert cache["pos"] == int(jcache["pos"]) == 32
    full = np.concatenate([prompt, *steps], axis=1)
    uncached = gpt.forward(dataclasses.replace(cfg, use_flash=False), params,
                           torch.from_numpy(full), train=False)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), uncached.numpy(),
                               atol=LOGIT_ATOL, rtol=0)


# ------------------------------------------------------------------ chunked loss
# tests/test_chunked_loss.py's geometry
CHUNK_CFG = dict(vocab_size=97, d_model=32, n_layer=2, n_head=2, max_seq_len=32)


def _chunk_batch(V, bs=3, seq=32, with_mask=False, with_labels=False, seed=0):
    r = np.random.default_rng(seed)
    b = {"input_ids": r.integers(0, V, (bs, seq)).astype(np.int32)}
    if with_labels:
        b["labels"] = r.integers(0, V, (bs, seq)).astype(np.int32)
    if with_mask:
        b["loss_mask"] = (r.random((bs, seq)) > 0.3).astype(np.float32)
    return b


@pytest.mark.parametrize("over,chunk,seq,with_mask,with_labels,jax_grads", [
    ({}, 8, 32, False, False, True),  # the masked dummy column
    ({}, 8, 32, True, False, False),
    ({}, 8, 32, True, True, False),
    ({"tie_embeddings": False, "lm_head_bias": True}, 16, 32, True, False, True),
    ({}, 8, 33, True, False, False),  # seq+1 packing: max_seq_len + 1 tokens
], ids=["plain", "mask", "labels-mask", "untied-head-bias", "seq+1-mask"])
def test_chunked_loss_and_grads_match_jax(over, chunk, seq, with_mask, with_labels,
                                          jax_grads):
    """The port's chunked loss equals JAX's chunked and whole-sequence
    losses and the port's whole-sequence loss, with the same num_tokens; its
    gradients equal the port's whole-sequence gradients, and (in the cases
    that differ in the head's leaves) jax.grad of JAX's chunked loss."""
    kw = {**CHUNK_CFG, **over, "loss_chunk": chunk}
    jcfg, jparams, cfg, params = _pair(kw, seed=3)
    b = _chunk_batch(cfg.vocab_size, seq=seq, with_mask=with_mask, with_labels=with_labels)
    jcfg0 = dataclasses.replace(jcfg, loss_chunk=0)

    @jax.jit
    def reference(p, jb):
        def chunked(p):
            return jax_gpt.loss_fn(jcfg, p, jb, train=False)

        if jax_grads:
            (loss, aux), grads = jax.value_and_grad(chunked, has_aux=True)(p)
        else:
            (loss, aux), grads = chunked(p), None
        whole, whole_aux = jax_gpt.loss_fn(jcfg0, p, jb, train=False)
        return loss, aux["num_tokens"], grads, whole, whole_aux["num_tokens"]

    ref, ref_n, jgrads, whole, whole_n = reference(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(params)]
    loss, aux = gpt.loss_fn(cfg, params, b, train=False)
    grads = torch.autograd.grad(loss, leaves)
    loss0, aux0 = gpt.loss_fn(dataclasses.replace(cfg, loss_chunk=0), params, b, train=False)
    grads0 = torch.autograd.grad(loss0, leaves)
    for other in (float(ref), float(whole), loss0.item()):
        np.testing.assert_allclose(loss.item(), other, atol=LOSS_ATOL, rtol=0)
    assert aux["num_tokens"] == int(ref_n) == int(whole_n) == aux0["num_tokens"]
    refs = jax.tree_util.tree_leaves(jgrads) if jax_grads else [g.numpy() for g in grads0]
    for g, g0, r in zip(grads, grads0, refs):
        r = np.asarray(r)
        tol = 1e-5 * max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=tol)
        np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=0, atol=tol)


def test_chunked_loss_errors_match_jax():
    jcfg, jparams, cfg, params = _pair({**CHUNK_CFG, "loss_chunk": 7})
    b = _chunk_batch(cfg.vocab_size)
    with pytest.raises(ValueError, match="must divide"):
        jax_gpt.loss_fn(jcfg, jparams, {k: jnp.asarray(v) for k, v in b.items()}, train=False)
    with pytest.raises(ValueError, match="must divide"):
        gpt.loss_fn(cfg, params, b, train=False)
    for fn, c, p in ((jax_gpt.loss_fn, jcfg, jparams), (gpt.loss_fn, cfg, params)):
        with pytest.raises(ValueError, match="loss_chunk needs an LM head"):
            fn(dataclasses.replace(c, loss_chunk=8, has_lm_head=False), p, b, train=False)


class _LargestFloat(TorchDispatchMode):
    """The most elements of any floating-point tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.most = max(self.most, t.numel())
        return out


def test_chunked_loss_never_holds_the_whole_logits():
    """Forward and backward of the chunked loss return no tensor of B*T*V
    elements: the largest is one chunk's logits or the [V, D] head gradient
    (the whole-sequence loss, held the same way, does return one)."""
    cfg = gpt.GPTConfig(**{**CHUNK_CFG, "vocab_size": 512, "loss_chunk": 8})
    params = gpt.init_params(cfg, 0, device="cpu")
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(params)]
    b = _chunk_batch(cfg.vocab_size, bs=4, seq=32)
    B, T, V, D = 4, 32, cfg.vocab_size, cfg.d_model
    sizes = {}
    for chunk in (8, 0):
        with _LargestFloat() as probe:
            loss, _ = gpt.loss_fn(dataclasses.replace(cfg, loss_chunk=chunk), params, b,
                                  train=False)
            torch.autograd.grad(loss, leaves)
        sizes[chunk] = probe.most
    assert sizes[8] <= max(B * 8 * V, V * D) < B * T * V <= sizes[0]


def test_engine_trajectory_with_chunked_loss_matches_jax():
    """5 steps of tests/test_torch_engine.py's fp32 configuration (AdamW,
    warmup, clipping) on one batch, for an ALiBi model through the chunked
    loss: the losses fall, as the reference's
    ``test_engine_trains_with_chunked_loss`` asks, and follow JAX's."""
    jengine, engine = engines(config(), loss_chunk=8, alibi=True)
    b = batch(0)
    losses = []
    for _ in range(5):
        ref = jengine.train_batch(b)
        out = engine.train_batch(b)
        np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"].item(), float(ref["grad_norm"]), rtol=1e-4)
        losses.append(out["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ------------------------------------------------------------------ serving
SERVE_CFG = dict(vocab_size=64, n_layer=2, n_head=4, d_model=32, max_seq_len=32)


@pytest.mark.parametrize("over", [{"alibi": True}, {"local_attention_period": 2}],
                         ids=["alibi", "local"])
def test_paged_paths_refuse_biases_like_jax(over):
    """paged_decode_step and paged_verify_step raise the reference's
    ValueError, before they read anything."""
    jcfg = jax_gpt.GPTConfig(**SERVE_CFG, **over)
    cfg = gpt.GPTConfig(**SERVE_CFG, **over)
    for ref_fn, fn, ids, what in ((jax_gpt.paged_decode_step, gpt.paged_decode_step,
                                   np.zeros(2, np.int32), "paged decode"),
                                  (jax_gpt.paged_verify_step, gpt.paged_verify_step,
                                   np.zeros((2, 3), np.int32), "paged verification")):
        for f, c in ((ref_fn, jcfg), (fn, cfg)):
            with pytest.raises(ValueError, match=f"{what} does not support alibi/local"):
                f(c, {}, ids, {}, np.zeros((2, 1), np.int32), np.zeros(2, np.int32))


def test_serving_engine_exempts_alibi_from_the_position_bound_like_jax():
    """An ALiBi model serves past max_seq_len in both packages (a learned-
    position model raises at construction in both); its prefill gives the
    same first token in both, and its first decode step raises the paged
    path's ValueError in both."""
    jcfg, jparams, cfg, params = _pair({**SERVE_CFG, "alibi": True}, seed=4)
    sc = dict(num_slots=2, page_size=8, max_model_len=64, prefill_chunk=16, dtype="float32")
    ref = jserving.ServingEngine(jcfg, jparams, jserving.ServingConfig(**sc))
    eng = serving.ServingEngine(cfg, params, serving.ServingConfig(**sc), device="cpu")
    row = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32)
    prompt = _ids(cfg.vocab_size, (12,), seed=5)
    assert eng.prefill(0, prompt, row) == ref.prefill(0, prompt, row)
    args = (np.zeros(2, np.int32), np.zeros((2, 8), np.int32), np.zeros(2, np.int32),
            np.zeros(2, bool))
    for e in (ref, eng):
        with pytest.raises(ValueError, match="paged decode does not support alibi"):
            e.decode(*args)
    for mod, c, p, kw in ((jserving, jax_gpt.GPTConfig(**SERVE_CFG), jparams, {}),
                          (serving, gpt.GPTConfig(**SERVE_CFG), params, {"device": "cpu"})):
        with pytest.raises(ValueError, match="learned position table"):
            mod.ServingEngine(c, p, mod.ServingConfig(**sc), **kw)
