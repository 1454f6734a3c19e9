"""The port's training engine vs the JAX package's, from the same state.

The JAX engine runs on one CPU device; its initial train state (params,
optimizer state, scaler) crosses into the port's engine through
``deepspeed_tpu_torch.bridge``, and both take the same numpy batches.
Tolerances: fp32 per-step loss rtol 1e-5 (the same arithmetic in another
summation order), grad_norm and lr rtol 1e-4; bf16 (master weights on)
rtol 2e-2 on the loss and 5e-2 on the grad norm, since the two frameworks
round bf16 at other places.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.ops import optimizers
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=64)
SEQ = 32


def config(gas=1, micro=4, **over):
    cfg = {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 3e-3,
                                 "warmup_num_steps": 4}},
        "gradient_clipping": 1.0,
        "steps_per_print": 0,
    }
    cfg.update(over)
    return cfg


def batch(seed, micro=4, gas=1):
    shape = (micro, SEQ) if gas == 1 else (gas, micro, SEQ)
    return {"input_ids": np.random.default_rng(seed).integers(0, 256, shape, dtype=np.int32)}


def engines(cfg, **gpt_over):
    """(JAX engine, port engine started from the JAX engine's exact state)."""
    jmodel, _ = build_gpt(JaxGPTConfig(**TINY, **gpt_over))
    jengine, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, config=JaxDeepSpeedConfig.load(cfg, world_size=1),
        topology=MeshTopology.single_device(), seed=0)
    model, _ = gpt.build(gpt.GPTConfig(**TINY, **gpt_over))
    engine, opt, loader, lr_fn = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                                 device="cpu")
    assert opt is engine.optimizer and loader is None and lr_fn is engine.lr_fn
    state = jax.tree_util.tree_map(np.asarray, jengine.state)
    engine.load_state(bridge.train_state_from_numpy(state, "cpu", engine.pc.compute_dtype))
    return jengine, engine


def _f(x):
    return float(np.asarray(x.detach().float().cpu() if torch.is_tensor(x) else x))


@pytest.mark.parametrize("gas,over,loss_rtol,norm_rtol", [
    (1, {}, 1e-5, 1e-4),
    (2, {}, 1e-5, 1e-4),
    (1, {"bf16": {"enabled": True}, "zero_optimization": {"stage": 2}}, 2e-2, 5e-2),
], ids=["fp32", "fp32-gas2", "bf16-master-zero2"])
def test_train_batch_trajectory_matches_jax(gas, over, loss_rtol, norm_rtol):
    jengine, engine = engines(config(gas=gas, micro=4 // gas, **over))
    for step in range(5):
        b = batch(step, micro=4 // gas, gas=gas)
        ref = jengine.train_batch(b)
        out = engine.train_batch(b)
        np.testing.assert_allclose(_f(out["loss"]), _f(ref["loss"]), rtol=loss_rtol)
        np.testing.assert_allclose(_f(out["grad_norm"]), _f(ref["grad_norm"]), rtol=norm_rtol)
        np.testing.assert_allclose(_f(out["lr"]), _f(ref["lr"]), rtol=1e-4)
        assert _f(out["overflow"]) == _f(ref["overflow"]) == 0
    assert engine.global_steps == jengine.global_steps == 5
    assert engine.micro_steps == jengine.micro_steps == 5 * gas
    if not over:  # fp32: the params themselves agree (bf16 Adam steps may flip sign)
        for a, b in zip(tree_leaves(engine.state["params"]),
                        jax.tree_util.tree_leaves(jengine.state["params"])):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=2e-5)
    else:
        assert engine.state["params"]["wte"].dtype == torch.bfloat16
        assert engine.state["master"]["wte"].dtype == torch.float32
        assert engine.state["opt"].mu["wte"].dtype == torch.float32


def test_warmup_lr_starts_at_min_lr():
    """The schedule is read at the count of steps taken BEFORE the update,
    so the first step of a log warmup runs at warmup_min_lr."""
    _, engine = engines(config())
    assert _f(engine.train_batch(batch(0))["lr"]) == pytest.approx(1e-4, rel=1e-6)


def test_fp16_overflow_skip_matches_jax():
    """A loss scale of 2^40 overflows fp16 gradients: both engines skip the
    update, keep the params, and move the scaler the same way (hysteresis 2:
    the first overflow spends the budget, each later one halves the scale)."""
    jengine, engine = engines(config(fp16={"enabled": True, "initial_scale_power": 40}))
    before = [t.detach().clone() for t in tree_leaves(engine.state["master"])]
    for step in range(3):
        ref = jengine.train_batch(batch(step))
        out = engine.train_batch(batch(step))
        assert bool(out["overflow"]) and bool(ref["overflow"])
        assert _f(out["loss_scale"]) == _f(ref["loss_scale"])
        np.testing.assert_allclose(_f(out["loss"]), _f(ref["loss"]), rtol=1e-2)
    assert engine.skipped_steps == jengine.skipped_steps == 3
    js = jengine.state["scaler"]
    assert engine.get_loss_scale() == float(js.scale) == 2.0 ** 38
    assert int(engine.state["scaler"].hysteresis) == int(js.hysteresis)
    assert int(engine.state["opt"].count) == int(jengine.state["opt"].count) == 0
    for a, b in zip(tree_leaves(engine.state["master"]), before):
        assert torch.equal(a, b)


def test_forward_backward_step_matches_train_batch():
    """The imperative API over the same micro-batches lands on the same
    params as the fused train_batch (the counterpart of
    tests/test_engine.py::test_forward_backward_step_matches_train_batch)."""
    cfg = config(gas=2, micro=2)
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    e1, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    e2, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    b = batch(0, micro=2, gas=2)
    m = e1.train_batch(b)
    losses = []
    for i in range(2):
        loss = e2.forward({k: v[i] for k, v in b.items()})
        e2.backward(loss)
        losses.append(float(loss.detach()))
        assert e2.is_gradient_accumulation_boundary() == (i == 1)
        e2.step()  # a no-op until the boundary
        assert int(e2.state["step"]) == i
    assert e2.global_steps == 1 and not e2.is_gradient_accumulation_boundary()
    np.testing.assert_allclose(float(m["loss"]), np.mean(losses), rtol=1e-6)
    for a, b_ in zip(tree_leaves(e1.state["params"]), tree_leaves(e2.state["params"])):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-7)


def test_train_batches_stacks_k_steps():
    cfg = config()
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    e1, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    e2, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    bs = [batch(i) for i in range(3)]
    per_step = [e1.train_batch(b) for b in bs]
    out = e2.train_batches({"input_ids": np.stack([b["input_ids"] for b in bs])})
    assert out["steps"]["loss"].shape == (3,)
    torch.testing.assert_close(out["steps"]["loss"], torch.stack([m["loss"] for m in per_step]))
    torch.testing.assert_close(out["mean_loss"], out["steps"]["loss"].mean())
    assert e2.global_steps == 3


def _grads(cfg, params, ids, seed):
    leaves = tree_leaves(params)
    loss, _ = gpt.loss_fn(cfg, params, {"input_ids": ids}, rngs={"dropout": seed}, train=True)
    return loss, torch.autograd.grad(loss, leaves)


def test_remat_grads_equal_no_remat_grads():
    """Activation checkpointing recomputes each block with the same dropout
    seeds, so the gradients equal those without it (dropout and stochastic
    depth on, to show the recompute draws the same masks)."""
    cfg = gpt.GPTConfig(**TINY, dropout=0.2, stochastic_depth=0.3)
    params = tree_map(lambda t: t.requires_grad_(True), gpt.init_params(cfg, 0, device="cpu"))
    ids = torch.from_numpy(batch(0)["input_ids"])
    loss, grads = _grads(cfg, params, ids, 7)
    loss_r, grads_r = _grads(dataclasses.replace(cfg, remat=True), params, ids, 7)
    assert float(loss.detach()) == float(loss_r.detach())
    for g, gr in zip(grads, grads_r):
        torch.testing.assert_close(g, gr, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        gpt.forward(dataclasses.replace(cfg, remat=True, remat_policy="dots_saveables"),
                    params, ids)


def test_dropout_reproducible_from_seed_and_differs_across_steps():
    cfg = gpt.GPTConfig(**TINY, dropout=0.1)
    params = gpt.init_params(cfg, 0, device="cpu")
    b = {"input_ids": batch(0)["input_ids"]}
    loss = [gpt.loss_fn(cfg, params, b, rngs={"dropout": s}, train=True)[0].item()
            for s in (1, 1, 2)]
    assert loss[0] == loss[1] != loss[2]
    plain = gpt.loss_fn(cfg, params, b, train=False)[0].item()
    assert gpt.loss_fn(cfg, params, b, train=True)[0].item() == plain  # no seed: no dropout
    # in the engine: the same seed gives the same run, successive steps differ
    model, _ = gpt.build(cfg)
    runs = []
    for _ in range(2):
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config(), seed=3,
                                                    device="cpu")
        runs.append([engine.train_batch(b)["loss"].item() for _ in range(2)])
    assert runs[0] == runs[1]
    frozen, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config(scheduler=None, optimizer={"type": "SGD",
                                                              "params": {"lr": 0.0}}),
        seed=3, device="cpu")
    losses = [frozen.train_batch(b)["loss"].item() for _ in range(2)]
    assert losses[0] != losses[1]  # same params and batch, fresh masks each step


# a data_efficiency curriculum over a metric other than seqlen: the
# reference's engine refuses it too, with this message
_NON_SEQLEN = {"data_efficiency": {"enabled": True, "data_sampling": {"curriculum_learning": {
    "enabled": True, "curriculum_metrics": {"vocab_rarity": {
        "min_difficulty": 1, "max_difficulty": 10}}}}}}


@pytest.mark.parametrize("block", [
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 3, "zero_quantized_gradients": True}},
    {"mesh": {"tp": 2}},
    {"aio": {"block_size": 1048576}},
    {"autotuning": {"enabled": True}},
    {"analysis": {"enabled": True}},
    _NON_SEQLEN,
    {"resilience": {"enabled": True, "save_dir": "/nonexistent"}},
    {"elasticity": {"enabled": True}},
], ids=lambda b: "-".join(str(k) for k in b) + ("-" + str(list(b.values())[0])[:24]))
def test_unported_config_blocks_raise(block, tmp_path):
    """The blocks of items still to port raise naming their item. The
    ``resilience`` and ``elasticity`` blocks (A11, ported) reach the engine:
    the recovery log and the drain handlers under ``save_dir``; the elastic
    ladder's check, which refuses this config's batch knobs as the
    reference's does. The offload blocks and ``aio`` (A12, ported) build
    their runner, which trains a step, and set the NVMe stores' threads."""
    model, _ = gpt.build("tiny")
    zero = block.get("zero_optimization", {})
    if "offload_param" in zero or "offload_optimizer" in zero or "aio" in block:
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={**config(), **block},
                                                    device="cpu")
        if "aio" in block:
            assert engine.config.aio == block["aio"] and engine.config.aio_threads(4) == 4
            return
        runner = engine._param_stream if "offload_param" in zero else engine._offload
        assert runner is not None and engine.state["opt"] == {}
        assert np.isfinite(_f(engine.train_batch(batch(0))["loss"])) and runner.count == 1
        return
    if "resilience" in block:
        block = {"resilience": {**block["resilience"], "save_dir": str(tmp_path),
                                "install_signal_handlers": False}}
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={**config(), **block},
                                                    device="cpu")
        assert engine._recovery_log.path == str(tmp_path / "recovery_events.jsonl")
        assert engine.config.resilience.enabled and engine._preemption_guard is None
        return
    if "elasticity" in block:
        with pytest.raises(ValueError, match="elastic ladder"):
            deepspeed_tpu_torch.initialize(model=model, config={**config(), **block},
                                           device="cpu")
        return
    match = "unsupported in-engine" if block is _NON_SEQLEN else "ROADMAP.md"
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.initialize(model=model, config={**config(), **block},
                                       device="cpu")


def test_info_surface_and_set_train_batch_size():
    """The reference's accessors read the engine's own state; changing the
    global batch moves the accumulation steps, not the micro-batch."""
    model, _ = gpt.build("tiny")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config(zero_optimization={"stage": 1}), device="cpu")
    assert engine.get_lr() == [pytest.approx(1e-4)]  # WarmupLR at step 0
    m = engine.train_batch(batch(0))
    assert engine.get_global_grad_norm() == _f(m["grad_norm"]) > 0
    assert engine.get_lr()[0] > 1e-4
    assert engine.get_loss_scale() == 2.0 ** 16  # unused without fp16, as in the reference
    assert engine.zero_optimization_stage() == 1 and engine.module is model
    assert engine.train_micro_batch_size_per_gpu() == 4
    engine.set_train_batch_size(8)
    assert engine.gradient_accumulation_steps() == 2 == engine.config.gradient_accumulation_steps
    m = engine.train_batch(batch(1, micro=4, gas=2))
    assert engine.global_steps == 2 and engine.micro_steps == 3 and np.isfinite(_f(m["loss"]))
    with pytest.raises(ValueError, match="not divisible"):
        engine.set_train_batch_size(6)


@pytest.mark.parametrize("method", ["comms_verify", "measure_overlap",
                                    "analyze", "install_preemption_guard", "request_drain"])
def test_unported_engine_methods_raise(method):
    """The methods of items still to port raise naming their item; A11's,
    ported, act: ``install_preemption_guard`` installs the SIGTERM / SIGINT
    handlers, and ``request_drain`` without the resilience block refuses, as
    the reference's does."""
    model, _ = gpt.build("tiny")
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config(), device="cpu")
    if method == "install_preemption_guard":
        guard = engine.install_preemption_guard()
        try:
            assert guard.installed and not guard.drain_requested
        finally:
            guard.uninstall()
        return
    if method == "request_drain":
        with pytest.raises(ValueError, match="resilience.enabled"):
            engine.request_drain()
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\d+"):
        getattr(engine, method)()


def test_initialize_rejects_foreign_optimizer_and_accepts_port_one():
    model, _ = gpt.build("tiny")
    with pytest.raises(TypeError, match="Optimizer"):
        deepspeed_tpu_torch.initialize(model=model, config=config(),
                                       optimizer=torch.optim.SGD, device="cpu")
    sgd = optimizers.sgd(momentum=0.9)
    engine, opt, _, _ = deepspeed_tpu_torch.initialize(model=model, config=config(),
                                                       optimizer=sgd, device="cpu")
    assert opt is sgd and isinstance(engine.state["opt"], optimizers.SGDState)
    assert np.isfinite(engine.train_batch({"input_ids": batch(0)["input_ids"] % 256})["loss"]
                       .item())


def _first_loss_from_jax_state(jengine, engine):
    """The first train_batch loss of both engines, the port's started from
    the JAX engine's state."""
    state = jax.tree_util.tree_map(np.asarray, jengine.state)
    engine.load_state(bridge.train_state_from_numpy(state, "cpu", engine.pc.compute_dtype))
    return _f(jengine.train_batch(batch(0))["loss"]), _f(engine.train_batch(batch(0))["loss"])


@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_initialize_takes_the_reference_signature(call):
    """Both packages' initialize with the same arguments, in the reference's
    order (args, model, optimizer, model_parameters, training_data,
    lr_scheduler, topology, dist_init_required, config, config_params, seed),
    the config read from ``args.deepspeed_config``: the same first loss
    (fp32, rtol 1e-5). The one argument that differs is topology: the
    reference gets its single-device mesh (the simulated CPU mesh has 8
    devices), the port None, since it has no mesh (A13)."""
    cfg = config()
    args = argparse.Namespace(deepspeed_config=cfg)
    jmodel, _ = build_gpt(JaxGPTConfig(**TINY))
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    jtopo = MeshTopology.single_device()
    if call == "positional":
        jengine, *_ = deepspeed_tpu.initialize(args, jmodel, None, None, None, None, jtopo,
                                               False, None, None, 0)
        engine, opt, loader, lr_fn = deepspeed_tpu_torch.initialize(
            args, model, None, None, None, None, None, False, None, None, 0, "cpu")
    else:
        kw = dict(args=args, model_parameters=None, dist_init_required=None, seed=0)
        jengine, *_ = deepspeed_tpu.initialize(model=jmodel, topology=jtopo, **kw)
        engine, opt, loader, lr_fn = deepspeed_tpu_torch.initialize(model=model, device="cpu",
                                                                    **kw)
    assert opt is engine.optimizer and loader is None and lr_fn is engine.lr_fn
    assert engine.train_micro_batch_size_per_gpu() == 4
    ref, out = _first_loss_from_jax_state(jengine, engine)
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_initialize_config_wins_over_args_and_model_parameters_is_accepted():
    """``config`` (or ``config_params``) is read before ``args.deepspeed_config``,
    and ``model_parameters`` is accepted and unused, as in the reference."""
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    args = argparse.Namespace(deepspeed_config=config(micro=2))
    for kw in ({"config": config()}, {"config_params": config()}):
        engine, *_ = deepspeed_tpu_torch.initialize(args=args, model=model, device="cpu",
                                                    model_parameters=model, **kw)
        assert engine.train_micro_batch_size_per_gpu() == 4
    engine, *_ = deepspeed_tpu_torch.initialize(args=args, model=model, device="cpu")
    assert engine.train_micro_batch_size_per_gpu() == 2


@pytest.mark.parametrize("kw,model_over,item", [
    ({"topology": object()}, {}, "A13"),
    ({}, {"seq_parallel_impl": "ring"}, "A13"),
], ids=["topology", "seq_parallel_impl"])
def test_initialize_unported_arguments_raise_their_item(kw, model_over, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        model, _ = gpt.build(gpt.GPTConfig(**TINY, **model_over))
        deepspeed_tpu_torch.initialize(model=model, config=config(), device="cpu", **kw)
