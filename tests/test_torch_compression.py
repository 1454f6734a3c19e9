"""``compression_training`` (MoQ quantization-aware training with annealed
bits, sparse / row / head / channel pruning, layer reduction, post-training
quantization) and the quantizer's fake-quant functions against the JAX
package, on the same numpy inputs, in fp32.

- ``fake_quant`` and ``fake_quant_dynamic`` (a scalar bit count and one a
  layer) are JAX's bitwise (the same fp32 operations); their gradient is
  straight through (ones).
- ``annealed_bits`` gives JAX's eagerly evaluated bits at every step of a
  range covering three drops for every factor 1-5 (and per-layer factor
  vectors): the reference's documented drop points, ``period (2 f)**(k-1)``.
  Under ``jit`` XLA multiplies by the reciprocal of ``log(2 f)`` and puts
  some exact drop points of factors 3 and 5 one step later: the test
  records that this is the only difference, and the port keeps the
  documented points.
- Each pruning family, the scheduler's plan on a ``tiny`` GPT tree,
  ``redundancy_clean`` and ``quantize_params_for_inference``: bitwise
  JAX's. ``transform`` with and without a curvature vector at steps around
  the offsets: within 2 fp32 ulps (rtol 2.4e-7) of the engine's ``jit``
  program, which divides by the constant ``qmax`` as a multiply by its
  reciprocal.
- The engine (``tiny`` GPT, AdamW, bits 8 -> 4 from step 1, L1 pruning
  from step 2): in lockstep from the JAX engine's state each step, losses
  within 1e-5 and grad norms 1e-4 relative (the straight-through gradient
  reaches the master weights); the imperative API is ``train_batch``
  bitwise; stage 3 gives stage 0's losses (1e-6); no weight is sorted
  before the pruning offset; the reference's refusals.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import compression as jc
from deepspeed_tpu.compression import compress as jcompress
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.models import gpt as jax_gpt
from deepspeed_tpu.ops import quantizer as jquant
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu_torch import bridge, compression as tcomp
from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths
from deepspeed_tpu_torch.compression import compress as tcompress
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.ops import quantizer as tquant

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=128)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _same_tree(got, want, rtol=0.0):
    got, want = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(v), rtol=rtol, atol=0, err_msg=k)


@pytest.mark.parametrize("bits,groups", [(8, 1), (4, 4), (3, 8)])
def test_fake_quant_is_jax_bitwise_and_straight_through(bits, groups):
    x = np.random.default_rng(bits).normal(size=(8, 32)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tquant.fake_quant(xt, bits, groups)
    np.testing.assert_array_equal(_np(out), np.asarray(jquant.fake_quant(jnp.asarray(x), bits,
                                                                         groups)))
    out.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))
    dyn = tquant.fake_quant_dynamic(torch.from_numpy(x), float(bits), groups)
    np.testing.assert_array_equal(_np(dyn), np.asarray(
        jquant.fake_quant_dynamic(jnp.asarray(x), jnp.float32(bits), groups)))


def test_fake_quant_dynamic_per_layer_bits_is_jax_bitwise():
    x = np.random.default_rng(0).normal(size=(3, 4, 16)).astype(np.float32)
    bits = np.array([8.0, 5.0, 3.0], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tquant.fake_quant_dynamic(xt, torch.from_numpy(bits), 2)
    np.testing.assert_array_equal(_np(out), np.asarray(
        jquant.fake_quant_dynamic(jnp.asarray(x), jnp.asarray(bits), 2)))
    out.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def test_annealed_bits_match_jax_at_every_step():
    period = 3
    for f in (1.0, 2.0, 3.0, 4.0, 5.0):
        steps = np.arange(-2, period * int((2 * f) ** 3) + 3, dtype=np.float32)
        got = tquant.annealed_bits(steps, 8, 2, period, f).numpy()
        want = np.asarray(jquant.annealed_bits(jnp.asarray(steps), 8, 2, period, f))
        np.testing.assert_array_equal(got, want, err_msg=f"factor {f}")
        # under jit: only exact drop points may land one step later
        jit = np.asarray(jax.jit(lambda s, f=f: jquant.annealed_bits(s, 8, 2, period, f))(
            jnp.asarray(steps)))
        late = np.nonzero(jit != got)[0]
        drops = {period * (2 * f) ** k for k in range(4)}
        assert all(steps[i] in drops and jit[i] == got[i] + 1 for i in late), (f, steps[late])
    factors = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)  # one a layer
    t = np.arange(0, 6 * period * 36, dtype=np.float32)[:, None] - 2.0 * factors
    np.testing.assert_array_equal(
        tquant.annealed_bits(t, 8, 4, period, factors).numpy(),
        np.asarray(jquant.annealed_bits(jnp.asarray(t), 8, 4, period, jnp.asarray(factors))))
    assert float(tquant.annealed_bits(10_000, 8, 8, 4, 1.0)) == 8.0


def test_pruning_families_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 24)).astype(np.float32)
    x[0, 0, :3] = x[0, 0, 3]  # ties at the threshold are kept, as in JAX
    for ratio in (0.1, 0.5, 0.73):
        np.testing.assert_array_equal(
            _np(tcompress._prune_l1(torch.from_numpy(x), ratio)),
            np.asarray(jcompress._prune_l1(jnp.asarray(x), ratio)))
        np.testing.assert_array_equal(
            _np(tcompress._prune_rows(torch.from_numpy(x), ratio)),
            np.asarray(jcompress._prune_rows(jnp.asarray(x), ratio)))
        np.testing.assert_array_equal(
            _np(tcompress._prune_heads(torch.from_numpy(x), ratio, 4)),
            np.asarray(jcompress._prune_heads(jnp.asarray(x), ratio, 4)))
    conv = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    np.testing.assert_array_equal(_np(tcompress._prune_rows(torch.from_numpy(conv), 0.25)),
                                  np.asarray(jcompress._prune_rows(jnp.asarray(conv), 0.25)))
    with pytest.raises(ValueError, match="not divisible"):
        tcompress._prune_heads(torch.from_numpy(x), 0.5, 5)


FULL = {
    "weight_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": 2, "quantize_groups": 2},
        "different_groups": {
            "mlp": {"params": {"start_bits": 8, "target_bits": 4, "quantization_period": 1},
                    "modules": ["mlp_*"]},
            "rest": {"params": {"start_bits": 6}, "modules": ["*"]}}},
    "sparse_pruning": {"shared_parameters": {"enabled": True, "schedule_offset": 3},
                       "different_groups": {"s": {"params": {"dense_ratio": 0.4},
                                                  "modules": ["qkv"]}}},
    "row_pruning": {"shared_parameters": {"enabled": True, "schedule_offset": 4},
                    "different_groups": {"r": {"params": {"dense_ratio": 0.75},
                                               "modules": ["mlp_down"]}}},
    "head_pruning": {"shared_parameters": {"enabled": True, "schedule_offset": 1,
                                           "num_heads": 4},
                     "different_groups": {"h": {"params": {"dense_ratio": 0.5}}}},
}


@functools.lru_cache(maxsize=None)
def _tiny_params():
    jparams = jax.jit(lambda k: jax_gpt.init_params(JaxGPTConfig(**TINY), k))(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, bridge.params_from_numpy(tree, "cpu")


def test_scheduler_plan_matches_jax():
    jparams, params = _tiny_params()
    got, want = tcomp.init_compression(params, FULL), jc.init_compression(jparams, FULL)
    assert got.plan == want.plan and got.plan
    assert "wte" not in got.plan and "blocks/qkv_b" not in got.plan
    assert got.curvature_scope == want.curvature_scope == "blocks"
    with pytest.raises(ValueError, match="num_heads"):
        tcomp.CompressionScheduler({"head_pruning": {"shared_parameters": {"enabled": True}}},
                                   params)
    with pytest.raises(NotImplementedError, match="activation_quantization"):
        tcomp.CompressionScheduler({"activation_quantization": {
            "shared_parameters": {"enabled": True}}}, params)


@pytest.mark.parametrize("curvature", [None, [0.0, 1.0], [0.6, 0.2]],
                         ids=["flat", "curv-0-1", "curv-mixed"])
def test_transform_matches_jax_around_the_offsets(curvature):
    jparams, params = _tiny_params()
    sched, jsched = tcomp.init_compression(params, FULL), jc.init_compression(jparams, FULL)
    curv = None if curvature is None else np.asarray(curvature, np.float32)
    # the engine's program: the step (and the curvature) traced
    jfn = jax.jit(lambda p, s, c: jsched.transform(p, s, curvature=c))
    for step in (0, 1, 2, 3, 4, 5, 8, 11, 17):
        got = sched.transform(params, step, curvature=curv)
        want = jfn(jparams, jnp.int32(step), None if curv is None else jnp.asarray(curv))
        # under jit XLA divides by the constant qmax as a multiply by its
        # reciprocal: each scale within an ulp, so each value within 2 ulps
        _same_tree(got, want, rtol=2.4e-7)


def test_no_weight_is_sorted_before_the_pruning_offset(monkeypatch):
    _, params = _tiny_params()
    sched = tcomp.init_compression(params, {"sparse_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 3}}})
    calls = []
    real = torch.sort
    monkeypatch.setattr(torch, "sort", lambda *a, **k: calls.append(1) or real(*a, **k))
    for step in range(3):
        out = sched.transform(params, step)
        assert out["blocks"]["qkv_w"] is params["blocks"]["qkv_w"]
    assert not calls
    sched.transform(params, 3)
    assert len(calls) == len(sched.plan)


def test_redundancy_clean_and_inference_quantization_match_jax():
    jparams, params = _tiny_params()
    _same_tree(tcomp.redundancy_clean(params, {"compression_training": FULL}),
               jc.redundancy_clean(jparams, {"compression_training": FULL}))
    assert tcomp.redundancy_clean(params, {"compression_training": {}}) is params
    q, s, meta = tcomp.quantize_params_for_inference(params, bits=8, group_size=64)
    jq, js, jmeta = jc.quantize_params_for_inference(jparams, bits=8, group_size=64)
    _same_tree(q, jq)
    assert meta["quantized"] == jmeta["quantized"] and len(s) == len(js)
    for a, b in zip(s, js):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _same_tree(meta["dequantize"](torch.float32), jmeta["dequantize"](jnp.float32))
    assert tcomp.layer_reduction_map(12, 4) == jc.layer_reduction_map(12, 4) == [0, 4, 7, 11]
    assert tcomp.layer_reduction_map(6, 3, [1, 3, 5]) == [1, 3, 5]


MOQ = {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 1},
    "different_groups": {"g": {"params": {"start_bits": 8, "target_bits": 4,
                                          "quantization_period": 1}}}},
    "sparse_pruning": {"shared_parameters": {"enabled": True, "schedule_offset": 2},
                       "different_groups": {"s": {"params": {"dense_ratio": 0.5}}}}}


def _config(**over):
    cfg = {"train_micro_batch_size_per_gpu": 4, "steps_per_print": 0,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "compression_training": MOQ}
    cfg.update(over)
    return cfg


def _batch(s):
    return {"input_ids": np.random.default_rng(30 + s).integers(0, 256, (4, 32),
                                                                dtype=np.int32)}


def _port(cfg):
    return deepspeed_tpu_torch.initialize(model=gpt.build(gpt.GPTConfig(**TINY))[0],
                                          config=cfg, device="cpu", seed=0)[0]


def test_engine_compression_matches_jax_in_lockstep():
    cfg = _config()
    je = deepspeed_tpu.initialize(model=build_gpt(JaxGPTConfig(**TINY))[0],
                                  config=JaxDeepSpeedConfig.load(cfg, 1),
                                  topology=MeshTopology.single_device(), seed=0)[0]
    pe = _port(cfg)
    assert pe._compression.plan == je._compression.plan
    for s in range(5):  # bits 8 at step 1, then 7, 6, 6, 5; pruned from step 2
        pe.load_state(bridge.train_state_from_numpy(
            jax.tree_util.tree_map(np.array, je.state), "cpu"))
        jm, pm = je.train_batch(_batch(s)), pe.train_batch(_batch(s))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


def test_engine_imperative_api_and_stage3_match_train_batch():
    fused, imperative, stage3 = (_port(_config()), _port(_config()),
                                 _port(_config(zero_optimization={"stage": 3})))
    for s in range(4):
        m = fused.train_batch(_batch(s))
        loss = imperative.forward(_batch(s))
        imperative.backward(loss)
        imperative.step()
        assert float(loss.detach()) == float(m["loss"])
        np.testing.assert_allclose(float(stage3.train_batch(_batch(s))["loss"]),
                                   float(m["loss"]), rtol=1e-6)
    for a, b in zip(flatten_with_paths(fused.state["params"]),
                    flatten_with_paths(imperative.state["params"])):
        assert torch.equal(a[1], b[1]), a[0]


def test_engine_refuses_compression_with_the_quantized_gradient_exchange():
    with pytest.raises(ValueError, match="zero_quantized_gradients does not compose"):
        _port(_config(zero_optimization={"stage": 2, "zero_quantized_gradients": True}))
    engine = _port(_config(compression_training={
        "weight_quantization": {"shared_parameters": {"enabled": False}}}))
    assert engine._compression is None  # an empty plan trains plainly
