"""The port's optimizers, LR schedules, loss scaler, clipping and config vs
the JAX package's.

Trees, gradients and step sequences come from numpy with a seed; states
cross through ``deepspeed_tpu_torch.bridge``. Tolerances: optimizer updates
rtol 1e-6 (the same fp32 arithmetic; atol 1e-7 for values near 0); LR
schedules rtol 1e-6 with atol 1e-9, a millionth of the peak LR (the port
evaluates them in float64 on the host, the reference in float32, which
loses relative precision where the cosine schedule nears 0); norms rtol
1e-6; the scaler and the config exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import optimizers as jax_opt
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import precision as jax_prec
from deepspeed_tpu.runtime import utils as jax_utils
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.ops import optimizers
from deepspeed_tpu_torch.runtime import lr_schedules, precision
from deepspeed_tpu_torch.runtime import utils as rt_utils
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.utils.tree import tree_leaves


def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((8, 16)) * scale).astype(np.float32),
            "blocks": {"b": (rng.standard_normal((3, 16)) * scale).astype(np.float32),
                       "s": (rng.standard_normal((5,)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("name,params", [
    ("Adam", {}),
    ("AdamW", {"weight_decay": 0.1}),
    ("Adam", {"weight_decay": 0.1, "adam_w_mode": False}),  # L2-style decay
    ("Adam", {"bias_correction": False, "betas": (0.8, 0.99)}),
    ("Lamb", {"weight_decay": 0.01}),
    ("Adagrad", {"weight_decay": 0.01}),
    ("SGD", {}),
    ("SGD", {"momentum": 0.9, "nesterov": True, "weight_decay": 0.01}),
], ids=["adam", "adamw", "adam-l2", "adam-nobc", "lamb", "adagrad", "sgd",
        "sgd-nesterov"])
def test_optimizer_matches_jax_over_three_updates(name, params):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(3)]
    jopt = jax_opt.get_optimizer(name, params)
    opt = optimizers.get_optimizer(name, params)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = jopt.init(jp)
    p = bridge.params_from_numpy(tree, "cpu")
    s = opt.init(p)
    for g in grads:
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, 1e-2)
        p, s = opt.update(bridge.params_from_numpy(g, "cpu"), s, p, torch.tensor(1e-2))
    for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    ref_state = bridge.opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert type(s) is type(ref_state)
    for a, b in zip(s, ref_state):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=1e-7)


def test_bf16_params_without_master_update_in_fp32():
    """bf16 leaves (bf16 without a master copy) are updated in fp32 and
    rounded back, as the reference's ``.astype(p.dtype)``."""
    rng = np.random.default_rng(1)
    tree, g = _tree(rng), _tree(rng, 0.1)
    jopt, opt = jax_opt.fused_adam(), optimizers.fused_adam()
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    jp, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jopt.init(jp), jp, 1e-2)
    p = bridge.params_from_numpy(tree, "cpu", torch.bfloat16)
    p, _ = opt.update(bridge.params_from_numpy(g, "cpu"), opt.init(p), p, 1e-2)
    for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_one_bit_optimizers_raise():
    """The 1-bit names give their dense warmup counterparts, as the
    reference's ``get_optimizer`` does (the engine runs their compressed
    stage); an unknown name still raises."""
    assert optimizers.get_optimizer("OneBitAdam", {}).name == "FusedAdam"
    assert optimizers.get_optimizer("ZeroOneAdam", {}).name == "FusedAdam"
    assert optimizers.get_optimizer("OneBitLamb", {}).name == "FusedLamb"
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.get_optimizer("TwoBitAdam", {})


@pytest.mark.parametrize("sched,params", [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 7}),
    ("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 7, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 20, "warmup_max_lr": 1e-3, "warmup_num_steps": 5}),
    ("WarmupCosineLR", {"total_num_steps": 20, "warmup_num_steps": 5,
                        "warmup_min_ratio": 0.1, "warmup_max_lr": 2e-3}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 4,
                  "decay_step_size": 3, "decay_lr_rate": 0.5}),
    ("LRRangeTest", {"lr_range_test_step_size": 3, "lr_range_test_staircase": True}),
], ids=["warmup-log", "warmup-linear", "warmup-decay", "warmup-cosine", "one-cycle",
        "range-test"])
def test_lr_schedule_matches_jax(sched, params):
    jfn = jax_lr.schedule_fn_from_config(sched, params)
    fn = lr_schedules.schedule_fn_from_config(sched, params)
    steps = np.arange(25)
    np.testing.assert_allclose([fn(int(s)) for s in steps],
                               [float(jfn(jnp.asarray(s))) for s in steps], rtol=1e-6,
                               atol=1e-9)
    wrapper = getattr(lr_schedules, sched)(**params)
    wrapper.step(3)
    assert wrapper.get_lr() == [fn(3)] and wrapper.state_dict() == {"last_step": 3}


@pytest.mark.parametrize("consecutive", [False, True])
def test_loss_scaler_state_machine_matches_jax(consecutive):
    kw = dict(initial_scale=2.0 ** 8, scale_window=3, hysteresis=2, min_scale=4.0,
              consecutive_hysteresis=consecutive)
    jpc = jax_prec.PrecisionConfig(compute_dtype=jnp.float16, master_weights=True,
                                   loss_scaling=True, **kw)
    pc = precision.PrecisionConfig(compute_dtype=torch.float16, master_weights=True,
                                   loss_scaling=True, **kw)
    js, s = jax_prec.init_scaler_state(jpc), precision.init_scaler_state(pc)
    # overflow/good sequence: isolated overflows, growth windows, a run of
    # overflows down to the floor
    seq = [1, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1]
    for finite in seq:
        js = jax_prec.update_scaler(jpc, js, jnp.bool_(finite))
        s = precision.update_scaler(pc, s, torch.tensor(bool(finite)))
        assert [float(x) for x in s] == [float(x) for x in js], (finite, s, js)
    back = bridge.scaler_state_to_numpy(bridge.scaler_state_from_numpy(js, "cpu"))
    assert [float(x) for x in back] == [float(x) for x in js]


def test_grads_finite_and_casts():
    g = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not bool(precision.grads_finite(g)) and bool(precision.grads_finite(g[:1]))
    pc = precision.PrecisionConfig(compute_dtype=torch.bfloat16, master_weights=True,
                                   loss_scaling=False)
    tree = {"a": torch.randn(2), "n": torch.arange(3)}
    assert precision.cast_to_compute(tree, pc)["a"].dtype == torch.bfloat16
    assert precision.cast_to_compute(tree, pc)["n"].dtype == torch.int64
    master = precision.make_master(tree, pc)
    assert master["a"].dtype == torch.float32 and master["a"] is not tree["a"]
    with pytest.raises(ValueError, match="compute dtype"):
        precision.validate_comm_dtype("fp16", torch.bfloat16)
    precision.validate_comm_dtype("bf16", torch.bfloat16)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(2)
    tree = _tree(rng, 3.0)
    leaves = tree_leaves(bridge.params_from_numpy(tree, "cpu"))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    np.testing.assert_allclose(float(rt_utils.global_norm(leaves)),
                               float(jax_utils.global_norm(jtree)), rtol=1e-6)
    clipped, norm = rt_utils.clip_by_global_norm(leaves, 1.0)
    jclipped, jnorm = jax_utils.clip_by_global_norm(jtree, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for a, b in zip(clipped, jax.tree_util.tree_leaves(jclipped)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(rt_utils.global_norm(clipped)), 1.0, rtol=1e-5)


@pytest.mark.parametrize("cfg,world", [
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4}, 2),
    ({"train_batch_size": 32, "gradient_accumulation_steps": 2}, 4),
    ({"train_batch_size": 16}, 2),
    ({"train_micro_batch_size_per_gpu": 3, "gradient_accumulation_steps": 5}, 1),
    ({"gradient_accumulation_steps": 4}, 2),
    ({}, 1),
    ({"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4,
      "gradient_accumulation_steps": 2}, 2),  # violates the triangle
    ({"train_batch_size": 8, "fp16": {"enabled": True}, "bf16": {"enabled": True}}, 1),
])
def test_config_batch_triangle_matches_jax(cfg, world):
    try:
        ref = JaxDeepSpeedConfig.load(cfg, world_size=world)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            DeepSpeedConfig.load(cfg, world_size=world)
        assert str(err.value) == str(e)
        return
    out = DeepSpeedConfig.load(cfg, world_size=world)
    assert (out.train_batch_size, out.train_micro_batch_size_per_gpu,
            out.gradient_accumulation_steps) == (
        ref.train_batch_size, ref.train_micro_batch_size_per_gpu,
        ref.gradient_accumulation_steps)


def test_config_blocks_and_unknown_keys(tmp_path):
    import json

    path = tmp_path / "ds.json"
    path.write_text(json.dumps({
        "train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True, "unknown": 1},
        "optimizer": {"type": "AdamW", "params": {"lr": 6e-4}}, "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 2, "overlap_comm": True,
                              "offload_optimizer": {"device": "none"}},
        "no_such_key": 3}))
    cfg = DeepSpeedConfig.load(str(path))
    assert cfg.bf16.enabled and cfg.zero_optimization.stage == 2 and cfg.zero_enabled
    assert cfg.optimizer.type == "AdamW" and cfg.gradient_clipping == 1.0
    assert precision.PrecisionConfig.from_ds_config(cfg).compute_dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9c"):
        DeepSpeedConfig.load({"zero_optimization": {"stage": 3,
                                                    "zero_quantized_gradients": True}})
