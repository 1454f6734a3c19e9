"""The port's GPT model vs the JAX package's, with the same weights.

Weights come from the JAX ``init_params`` and cross over through
``deepspeed_tpu_torch.bridge``; inputs come from numpy with a seed. All in
fp32 on the CPU, where the port takes the plain versions of its kernels.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import gpt as jax_gpt
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.models import gpt

# fp32 logits: the same arithmetic in another summation order
LOGITS_ATOL = 1e-4
LOSS_RTOL = 1e-5


def _pair(cfg_kwargs, seed=0):
    """(jax cfg, jax params, port cfg, port params) from one JAX init."""
    jcfg = jax_gpt.GPTConfig(**cfg_kwargs)
    jparams = jax_gpt.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, gpt.GPTConfig(**cfg_kwargs), params_from_numpy(tree, "cpu")


TINY = dataclasses.asdict(jax_gpt.PRESETS["tiny"])
# tiny's depth at head dim 96 (gpt2-760m's and gpt-neox-20b's)
TINY_D96 = {**TINY, "n_head": 2, "d_model": 192}
# two layers of GPT-2-125M at full width
GPT2_WIDTH_2L = dict(n_layer=2, n_head=12, d_model=768, vocab_size=50304, max_seq_len=128)


@pytest.mark.parametrize("cfg_kwargs,T,masked", [
    (TINY, 32, True),
    (GPT2_WIDTH_2L, 128, False),
    # rotate-half rotary with the NeoX parallel residual
    ({**TINY, "rotary": True, "parallel_residual": True}, 32, False),
    # GPT-J rotate-every-two rotary on half the head dim, untied biased head,
    # embedding LN, exact GELU, OPT's position offset
    ({**TINY, "rotary": True, "rotary_interleaved": True, "rotary_pct": 0.5,
      "activation": "gelu_exact", "tie_embeddings": False, "lm_head_bias": True,
      "embed_layernorm": True, "pos_offset": 2}, 32, False),
    (TINY_D96, 64, True),
], ids=["tiny", "gpt2-width-2l", "rotary-half-parallel-residual",
        "rotary-interleaved-untied-head", "tiny-d96"])
def test_forward_and_loss_match_jax(cfg_kwargs, T, masked):
    jcfg, jparams, cfg, params = _pair(cfg_kwargs)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    ref_logits = jax_gpt.forward(jcfg, jparams, jnp.asarray(ids), train=False)
    logits = gpt.forward(cfg, params, torch.from_numpy(ids), train=False)
    assert logits.shape == (2, T, cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=LOGITS_ATOL, rtol=0)

    batches = [{"input_ids": ids}]
    if masked:
        mask = (np.arange(T) % 3 != 0).astype(np.float32)[None].repeat(2, 0)
        batches.append({"input_ids": ids, "loss_mask": mask})
    for batch in batches:
        ref_loss, ref_aux = jax_gpt.loss_fn(jcfg, jparams, {k: jnp.asarray(v) for k, v in
                                                           batch.items()}, train=False)
        loss, aux = gpt.loss_fn(cfg, params, batch, train=False)
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
        assert aux["num_tokens"] == ref_aux["num_tokens"]


@pytest.mark.parametrize("cfg_kwargs", [TINY, TINY_D96], ids=["tiny", "tiny-d96"])
def test_loss_grads_match_jax(cfg_kwargs):
    """The scoring loss's gradients with respect to every parameter (the
    port through its flash Function's plain versions at head dim 96, whose
    head dim takes the flash route; tiny's 16 the plain attention) against
    jax.grad of the reference's loss: fp32, 1e-5 of each leaf's largest
    entry (the same arithmetic in another summation order)."""
    jcfg, jparams, cfg, params = _pair(cfg_kwargs, seed=4)
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    jgrads = jax.grad(lambda p: jax_gpt.loss_fn(jcfg, p, {"input_ids": jnp.asarray(ids)},
                                                train=False)[0])(jparams)
    leaves, jleaves = [], jax.tree_util.tree_leaves(jgrads)
    for t in jax.tree_util.tree_leaves(params):
        leaves.append(t.requires_grad_(True))
    loss, _ = gpt.loss_fn(cfg, params, {"input_ids": ids}, train=False)
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == len(jleaves)
    for g, r in zip(grads, jleaves):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * max(np.abs(r).max(), 1e-3))


def test_cached_decode_matches_jax_kernel_path():
    """Prefill, then 4 single-token decode steps with ``use_flash=True``: the
    JAX side runs the Pallas decode kernel in interpret mode, the port the
    decode wrapper's plain version; per-step logits agree."""
    jcfg, jparams, cfg, params = _pair({**TINY, "use_flash": True})
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (4, 2, 1)).astype(np.int32)

    jcache = jax_gpt.init_cache(jcfg, 2, 32, jnp.float32)
    cache = gpt.init_cache(cfg, 2, 32, torch.float32, "cpu")
    for ids in [prompt, *steps]:
        ref, jcache = jax_gpt.forward_with_cache(jcfg, jparams, jnp.asarray(ids), jcache)
        out, cache = gpt.forward_with_cache(cfg, params, torch.from_numpy(ids), cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGITS_ATOL, rtol=0)
    assert cache["pos"] == int(jcache["pos"]) == 12
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5, rtol=0)


def test_gpt_model_module_and_init_params():
    cfg = gpt.PRESETS["tiny"]
    params = gpt.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    jshapes = jax.eval_shape(lambda: jax_gpt.init_params(jax_gpt.PRESETS["tiny"],
                                                         jax.random.PRNGKey(0)))
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert shapes == jax.tree_util.tree_map(lambda s: tuple(s.shape), jshapes)
    model = gpt.GPTModel(cfg, params)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 16)))
    torch.testing.assert_close(model(ids), gpt.forward(cfg, params, ids, train=False),
                               rtol=0, atol=0)
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("field,value", [("seq_parallel_impl", "ring")])
def test_unported_options_raise(field, value):
    cfg = dataclasses.replace(gpt.PRESETS["tiny"], **{field: value})
    params = gpt.init_params(gpt.PRESETS["tiny"], 0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        gpt.forward(cfg, params, torch.zeros((1, 4), dtype=torch.long), train=False)
