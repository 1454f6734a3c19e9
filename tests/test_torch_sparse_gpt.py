"""The port's sparse GPT route vs the JAX package's, with the same weights.

``GPTConfig.sparse_attention`` sends every layer's attention in ``forward``,
``loss_fn`` and training through ``ops.sparse_attention`` (kernel B9 on the
card; here the plain versions its wrappers take for CPU tensors); the JAX
side runs the Pallas kernels in interpret mode. The model is the ``tiny``
preset at T128 with a Fixed unidirectional layout of 16-token blocks.
Tolerances as ``tests/test_torch_gpt.py`` and ``tests/test_torch_engine.py``
state them: fp32 logits atol 1e-4, loss rtol 1e-5; per training step loss
rtol 1e-5, grad norm and lr rtol 1e-4, parameters after 5 steps atol 2e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference import for_gpt as jax_for_gpt
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.models import gpt as jax_gpt
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.inference import for_gpt
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

LOGITS_ATOL = 1e-4
LOSS_RTOL = 1e-5
T = 128
FIXED = dict(num_heads=4, block=16, num_local_blocks=2, attention="unidirectional")


def _pair(jax_sc, port_sc, seed=0, **over):
    """(jax cfg, jax params, port cfg, port params) of ``tiny`` with the two
    packages' sparsity configs, from one JAX init."""
    base = dataclasses.replace(jax_gpt.PRESETS["tiny"], **over)
    jcfg = dataclasses.replace(base, sparse_attention=jax_sc)
    jparams = jax_gpt.init_params(jcfg, jax.random.PRNGKey(seed))
    params = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    cfg = dataclasses.replace(gpt.PRESETS["tiny"], sparse_attention=port_sc, **over)
    return jcfg, jparams, cfg, params


def _ids(seed, B=2):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(np.int32)


@pytest.mark.parametrize("name,kwargs", [
    ("FixedSparsityConfig", FIXED),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                   num_sliding_window_blocks=2)),
], ids=["fixed-uni", "bigbird-per-head"])
def test_sparse_logits_and_loss_match_jax(name, kwargs):
    jcfg, jparams, cfg, params = _pair(getattr(jsa, name)(**kwargs), getattr(sa, name)(**kwargs))
    ids = _ids(0)
    ref = jax_gpt.forward(jcfg, jparams, jnp.asarray(ids), train=False)
    logits = gpt.forward(cfg, params, torch.from_numpy(ids), train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=LOGITS_ATOL, rtol=0)
    ref_loss, _ = jax_gpt.loss_fn(jcfg, jparams, {"input_ids": jnp.asarray(ids)}, train=False)
    loss, _ = gpt.loss_fn(cfg, params, {"input_ids": ids}, train=False)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)


def test_dense_graft_equals_ungrafted_and_bigbird_differs():
    """An all-ones layout is the dense model (the reference's
    kernel-equivalence check); BigBird's is not."""
    cfg = gpt.PRESETS["tiny"]
    params = gpt.init_params(cfg, 0, device="cpu")
    batch = {"input_ids": _ids(1)}
    dense = gpt.loss_fn(cfg, params, batch, train=False)[0].item()
    grafted = sa.replace_self_attention_with_sparse(cfg, sa.DenseSparsityConfig(4, block=16))
    np.testing.assert_allclose(gpt.loss_fn(grafted, params, batch, train=False)[0].item(),
                               dense, rtol=2e-5)
    bigbird = sa.replace_self_attention_with_sparse(cfg, sa.BigBirdSparsityConfig(
        4, block=16, num_random_blocks=1, num_sliding_window_blocks=2))
    sparse = gpt.loss_fn(bigbird, params, batch, train=False)[0].item()
    assert np.isfinite(sparse) and abs(sparse - dense) > 1e-6


def _train_config():
    return {
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 3e-3,
                                 "warmup_num_steps": 4}},
        "gradient_clipping": 1.0,
        "steps_per_print": 0,
    }


def test_sparse_train_batch_trajectory_matches_jax():
    """5 fp32 ``train_batch`` steps of the sparse model, from the JAX engine's
    exact state, against the JAX engine (forward and backward through B9)."""
    jcfg, _, cfg, _ = _pair(jsa.FixedSparsityConfig(**FIXED), sa.FixedSparsityConfig(**FIXED))
    jmodel, _ = build_gpt(jcfg)
    jengine, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, config=JaxDeepSpeedConfig.load(_train_config(), world_size=1),
        topology=MeshTopology.single_device(), seed=0)
    model, _ = gpt.build(cfg)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_train_config(),
                                                device="cpu")
    state = jax.tree_util.tree_map(np.asarray, jengine.state)
    engine.load_state(bridge.train_state_from_numpy(state, "cpu", engine.pc.compute_dtype))
    for step in range(5):
        batch = {"input_ids": _ids(10 + step)}
        ref = jengine.train_batch(batch)
        out = engine.train_batch(batch)
        np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["grad_norm"].item(), float(ref["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(out["lr"].item(), float(ref["lr"]), rtol=1e-4)
    for a, b in zip(tree_leaves(engine.state["params"]),
                    jax.tree_util.tree_leaves(jengine.state["params"])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=2e-5)


def test_sparse_greedy_generate_token_identical_to_jax():
    """The cached path ignores the layout and attends densely, in both packages."""
    jcfg, jparams, cfg, params = _pair(jsa.FixedSparsityConfig(**FIXED),
                                       sa.FixedSparsityConfig(**FIXED))
    ref_engine = JaxInferenceEngine(jax_for_gpt(jcfg, jparams), JaxInferenceConfig(dtype="float32"))
    engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype="float32",
                                                device="cpu")
    prompt = _ids(2)[:, :16]
    ref = ref_engine.generate(prompt, max_new_tokens=16)
    out = engine.generate(prompt, max_new_tokens=16)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_sparse_remat_grads_equal_no_remat_grads():
    """The blocksparse Function composes with activation checkpointing: the
    recomputed blocks give the gradients of the stored ones."""
    cfg = dataclasses.replace(gpt.PRESETS["tiny"], sparse_attention=sa.FixedSparsityConfig(
        **FIXED))
    params = tree_map(lambda t: t.requires_grad_(True), gpt.init_params(cfg, 0, device="cpu"))
    ids = torch.from_numpy(_ids(3))
    runs = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        loss, _ = gpt.loss_fn(c, params, {"input_ids": ids}, train=True)
        runs.append((loss, torch.autograd.grad(loss, tree_leaves(params))))
    (loss, grads), (loss_r, grads_r) = runs
    assert float(loss.detach()) == float(loss_r.detach())
    for g, gr in zip(grads, grads_r):
        torch.testing.assert_close(g, gr, rtol=0, atol=1e-6)


def test_sparse_with_alibi_or_local_attention_raises_their_item():
    """Sparse attention with an alibi or local-window bias raises the
    reference's ValueError (the blocksparse kernel has no bias input)."""
    sc = sa.FixedSparsityConfig(**FIXED)
    params = gpt.init_params(gpt.PRESETS["tiny"], 0, device="cpu")
    for over in ({"alibi": True}, {"local_attention_period": 2}):
        cfg = dataclasses.replace(gpt.PRESETS["tiny"], sparse_attention=sc, **over)
        with pytest.raises(ValueError, match="cannot compose with alibi/local-window"):
            gpt.forward(cfg, params, torch.from_numpy(_ids(4)), train=False)
