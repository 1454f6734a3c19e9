"""ZeRO-3 with the quantized weight wire and LM head: the port against the
JAX package at one rank.

- ``quantize_blockwise`` and ``dequantize_blockwise``, and their numpy
  mirrors, are the reference's bit for bit (the same fp32 operations, round
  half to even, the product and the sum of the affine rounded apart).
- ``quantized_matmul_reshard``'s value and straight-through gradients equal
  JAX's to fp32 summation order (1e-5 relative).
- On ``tiny`` (vocab 256, and 300 so that the head pads to two blocks of
  256 and trims), stage 3 with quantized weights and head: the forward's
  logits equal JAX's (fp32, 2e-5), and the port's engine started from the
  JAX engine's state follows its 5-step trajectory. fp32: losses rtol 1e-5
  and grad norms 1e-4, as the unquantized engine test; step 1's payloads
  are bitwise JAX's, and later steps can differ by one quantization level
  where last-bit Adam differences flip a round-half case, which the
  tolerances cover (largest seen: 5.2e-6 / 5.6e-5 over the 5 steps, the
  step-1 payloads being bitwise). bf16: 2e-2 / 5e-2, as there (seen:
  1.3e-4 / 1.7e-3).
- Both wire ledgers hold the same op prefixes with the same wire/logical
  ratios (the port records per call, the reference per trace, so counts
  differ).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import quantized as jq
from deepspeed_tpu.comm.runtime_accounting import wire_ledger as jledger
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu.runtime.zero.gather import gather_window as jgather_window
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.comm import quantized as tq
from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger as tledger
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.zero import policy as zpolicy
from deepspeed_tpu_torch.runtime.zero.gather import gather_window
from deepspeed_tpu_torch.runtime.zero.partitioned_params import GatheredParameters
from deepspeed_tpu_torch.utils.tree import tree_leaves

TINY = dict(n_layer=2, n_head=4, d_model=64, max_seq_len=64)
SEQ = 32
ZERO3Q = {"stage": 3, "zero_quantized_weights": True, "zero_quantized_head": True}


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else x)


# ------------------------------------------------------------------ primitives
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,block", [
    ((3, 512), 256), ((3, 300), 256), ((5, 520), 128), ((4, 96), 256), ((2, 3, 7), 256),
    ((6, 130), 64),
], ids=["aligned", "pad-256", "pad-128", "effective-96", "effective-8", "pad-64"])
def test_quantize_blockwise_is_bitwise_jax(bits, shape, block):
    x = np.random.default_rng(sum(shape) + bits).normal(size=shape).astype(np.float32) * 3
    jqs = jq.quantize_blockwise(jnp.asarray(x), bits=bits, block_size=block)
    tqs = tq.quantize_blockwise(torch.from_numpy(x), bits=bits, block_size=block)
    nqs = tq.np_quantize_blockwise(x, bits=bits, block_size=block)
    for j, t, n in zip(jqs, tqs, nqs):
        assert t.dtype == (torch.uint8 if j.dtype == jnp.uint8 else torch.float32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(n, np.asarray(j))
    ref = np.asarray(jq.dequantize_blockwise(*jqs, bits=bits, orig_size=shape[-1]))
    got = tq.dequantize_blockwise(*tqs, bits=bits, orig_size=shape[-1]).numpy()
    host = tq.np_dequantize_blockwise(*nqs, bits=bits, orig_size=shape[-1])
    assert got.shape == host.shape == ref.shape == shape
    np.testing.assert_array_equal(host, got)
    np.testing.assert_array_equal(got, ref)


def test_stochastic_rounding_unbiased():
    """The mean over 100 draws of a stochastically rounded vector lies within
    one quantization step of it (the reference's test, on torch Generators)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256,)).astype(np.float32))
    outs = []
    for i in range(100):
        q, s, z = tq.quantize_blockwise(x, bits=8, block_size=64, stochastic=True,
                                        generator=torch.Generator().manual_seed(i))
        outs.append(tq.dequantize_blockwise(q, s, z, bits=8, orig_size=256))
    bias = (torch.stack(outs).mean(0) - x).abs().max().item()
    assert bias < float(s.max())
    with pytest.raises(ValueError, match="Generator"):
        tq.quantize_blockwise(x, stochastic=True)


@pytest.mark.parametrize("n,block", [(32, 256), (1024, 256), (7, 256), (2, 256), (300, 128)])
def test_block_rules_match_jax(n, block):
    assert tq.effective_block(n, block) == jq.effective_block(n, block)
    for bits in (8, 4):
        for item in (4, 2):
            assert (tq.quantization_shrinks(n, bits, block, item)
                    == jq.quantization_shrinks(n, bits, block, item))
        assert tq.wire_bytes_per_element(bits, block) == jq.wire_bytes_per_element(bits, block)


def test_error_feedback_step_keeps_what_the_wire_lost():
    buf = torch.randn(4, 256, generator=torch.Generator().manual_seed(1))
    (q, s, z), resid = tq.error_feedback_step(
        buf, lambda b: tq.quantize_blockwise(b, bits=4, block_size=64),
        lambda p: tq.dequantize_blockwise(*p, bits=4, orig_size=256))
    torch.testing.assert_close(tq.dequantize_blockwise(q, s, z, bits=4) + resid, buf)


def test_quantized_matmul_reshard_values_and_grads_match_jax():
    rng = np.random.default_rng(1)
    h = rng.normal(size=(4, 6, 128)).astype(np.float32)
    w = rng.normal(size=(128, 384)).astype(np.float32)
    g = rng.normal(size=(4, 6, 384)).astype(np.float32)

    def jfn(hh, ww):
        return jq.quantized_matmul_reshard(hh, ww, P(), 8, 128)

    ref, vjp = jax.vjp(jfn, jnp.asarray(h), jnp.asarray(w))
    ref_dh, ref_dw = vjp(jnp.asarray(g))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = tq.quantized_matmul_reshard(th, tw, bits=8, block_size=128)
    dh, dw = torch.autograd.grad(out, (th, tw), torch.from_numpy(g))
    for a, b in ((out, ref), (dh, ref_dh), (dw, ref_dw)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-4)
    # straight through: d_w is exactly h^T g, with no quantizer jacobian
    np.testing.assert_allclose(_np(dw), h.reshape(-1, 128).T @ g.reshape(-1, 384),
                               rtol=1e-5, atol=1e-4)


def test_quantized_reshard_at_one_rank_is_quantize_then_dequantize():
    x = torch.randn(64, 300, generator=torch.Generator().manual_seed(2), requires_grad=True)
    out = tq.quantized_reshard(x, None, bits=8, block_size=256)
    torch.testing.assert_close(out, tq.dequantize_blockwise(
        *tq.quantize_blockwise(x.detach(), 8, 256), orig_size=300), rtol=0, atol=0)
    g = torch.randn(64, 300)
    assert torch.equal(torch.autograd.grad(out, x, g)[0], g)  # straight through
    short = torch.randn(8, 2, dtype=torch.bfloat16)  # quantizing would inflate it
    assert torch.equal(tq.quantized_reshard(short, None), short)


# ------------------------------------------------------------------ policy
def test_shard_leaf_over_keeps_blocks_whole():
    """The split never cuts the trailing (block) dim nor the layer axis; 1-D
    leaves and the stacked [L, n] vectors stay whole."""
    assert zpolicy.shard_leaf_over((12, 768, 2304), 2, stacked=True) == 1
    assert zpolicy.shard_leaf_over((12, 3072, 768), 2, stacked=True) == 1
    assert zpolicy.shard_leaf_over((12, 2304), 2, stacked=True) is None
    assert zpolicy.shard_leaf_over((50304, 768), 2) == 0
    assert zpolicy.shard_leaf_over((768,), 2) is None
    assert zpolicy.shard_leaf_over((50304, 768), 2, threshold=int(1e8)) is None
    assert zpolicy.shard_leaf_over((50304, 768), 1) is None
    assert zpolicy.shard_leaf_over((7, 768), 2) is None  # no divisible dim
    cfg = DeepSpeedConfig.load({"zero_optimization": {
        "stage": 3, "stage3_param_persistence_threshold": 0}}, world_size=1).zero_optimization
    pol = zpolicy.ZeroShardingPolicy(cfg, world_size=2, rank=1)
    specs = pol.tree_param_specs(
        gpt.init_params(gpt.GPTConfig(vocab_size=256, **TINY), 0, device="cpu"))
    assert specs["blocks"]["qkv_w"] == 1 and specs["blocks"]["ln1_scale"] is None
    assert specs["wte"] == 0 and specs["lnf_bias"] is None
    assert pol.grad_spec((256, 64)) == pol.opt_spec((256, 64)) == pol.param_spec((256, 64)) == 0
    x = np.arange(24).reshape(4, 6)
    np.testing.assert_array_equal(pol.shard(x, 0), x[2:])


# ------------------------------------------------------------------ the model and engine
def _cfg(**over):
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "steps_per_print": 0,
           "zero_optimization": dict(ZERO3Q)}
    cfg.update(over)
    return cfg


def _batch(seed, vocab):
    return {"input_ids": np.random.default_rng(seed).integers(0, vocab, (4, SEQ),
                                                              dtype=np.int32)}


@pytest.mark.parametrize("vocab", [256, 300])
def test_stage3_quantized_logits_match_jax(vocab):
    """The forward under the bound stage-3 config: every layer leaf through
    the quantized gather, the head through quantized_matmul_reshard (and
    B8's plain version here); logits equal JAX's at fp32 tolerance."""
    jcfg = JaxGPTConfig(vocab_size=vocab, **TINY)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    ids = _batch(0, vocab)["input_ids"]
    zj = JaxDeepSpeedConfig.load(_cfg(), world_size=1).zero_optimization
    with jgather_window(zj):
        ref = jgpt.forward(jcfg, jparams, jnp.asarray(ids), train=False)
    params = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tcfg = gpt.GPTConfig(vocab_size=vocab, **TINY)
    zt = DeepSpeedConfig.load(_cfg()).zero_optimization
    tledger.reset()
    with gather_window(zt):
        out = gpt.forward(tcfg, params, ids, train=False)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=2e-5, atol=2e-5)
    # 12 leaves per layer, all shrink at fp32; the head once
    assert sum(r.count for n, r in tledger.records.items()
               if n.startswith("qgather[zero3]")) == 12 * TINY["n_layer"]
    assert tledger.records["qmatmul[lm_head](dim=None)"].count == 1
    plain = gpt.forward(tcfg, params, ids, train=False)  # no bound config: no quantization
    assert not torch.equal(plain, out)


def _engines(cfg, vocab):
    jmodel, _ = build_gpt(JaxGPTConfig(vocab_size=vocab, **TINY))
    jengine, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, config=JaxDeepSpeedConfig.load(cfg, world_size=1),
        topology=MeshTopology.single_device(), seed=0)
    model, _ = gpt.build(gpt.GPTConfig(vocab_size=vocab, **TINY))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    state = jax.tree_util.tree_map(np.asarray, jengine.state)
    engine.load_state(bridge.train_state_from_numpy(state, "cpu", engine.pc.compute_dtype,
                                                    policy=engine.zero_policy))
    return jengine, engine


@pytest.mark.parametrize("vocab,over,loss_rtol,norm_rtol", [
    (256, {}, 1e-5, 1e-4),
    (300, {}, 1e-5, 1e-4),
    (300, {"bf16": {"enabled": True}}, 2e-2, 5e-2),
], ids=["fp32-v256", "fp32-v300", "bf16-v300"])
def test_stage3_quantized_trajectory_matches_jax(vocab, over, loss_rtol, norm_rtol):
    jengine, engine = _engines(_cfg(**over), vocab)
    jledger.reset()
    tledger.reset()
    for step in range(5):
        b = _batch(step, vocab)
        ref, out = jengine.train_batch(b), engine.train_batch(b)
        np.testing.assert_allclose(_np(out["loss"]), float(ref["loss"]), rtol=loss_rtol)
        np.testing.assert_allclose(_np(out["grad_norm"]), float(ref["grad_norm"]),
                                   rtol=norm_rtol)
    for prefix in ("qgather[zero3", "qmatmul[lm_head]"):
        assert any(n.startswith(prefix) for n in jledger.records), prefix
        assert any(n.startswith(prefix) for n in tledger.records), prefix
        assert tledger.ratio(prefix) == pytest.approx(jledger.ratio(prefix), rel=1e-9)
    assert engine.global_steps == 5 and engine.zero_optimization_stage() == 3
    summary = engine.comms_summary()
    assert "qmatmul[lm_head]" in summary and "qgather[zero3]" in summary


def test_bf16_layer_norms_quantize_as_the_reference_does():
    """Which leaves quantize follows quantization_shrinks at the compute
    dtype's itemsize: under bf16 the LayerNorm scales and biases (64 wide)
    quantize too, as in the reference."""
    _, engine = _engines(_cfg(bf16={"enabled": True}), 256)
    tledger.reset()
    engine.train_batch(_batch(0, 256))
    per_layer = tledger.records["qgather[zero3](dim=None)"].count // TINY["n_layer"]
    assert per_layer == 12


def test_gathered_parameters_reads_and_writes_back():
    model, _ = gpt.build(gpt.GPTConfig(vocab_size=256, **TINY))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_cfg(bf16={"enabled": True}), device="cpu")
    with GatheredParameters(engine, paths=["wte", "blocks.qkv_w"], modify=True) as full:
        assert full["wte"].shape == (256, 64) and full["blocks.qkv_w"].shape == (2, 64, 192)
        full["wte"][:] = 0.5
    assert bool((engine.state["params"]["wte"] == 0.5).all())
    assert bool((engine.state["master"]["wte"] == 0.5).all())
    with GatheredParameters(engine, paths=["blocks.qkv_w"], quantized=True) as q:
        ref = engine.state["params"]["blocks"]["qkv_w"].detach().float().numpy()
        assert np.abs(q["blocks.qkv_w"] - ref).max() < 0.05
    with pytest.raises(ValueError, match="quantization noise"):
        GatheredParameters(engine, quantized=True, modify=True)


@pytest.mark.parametrize("block,match", [
    ({"zero_optimization": {"stage": 3, "zero_quantized_gradients": True}}, "A9b"),
    ({"zero_optimization": {"stage": 2, "zero_quantize_error_feedback": True}}, "A9b"),
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}}}, "A12"),
    ({"mesh": {"dp": 1, "tp": 2}}, "A13"),
])
def test_knobs_still_to_port_raise(block, match):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {match}"):
        DeepSpeedConfig.load({**_cfg(), **block})


def test_config_checks_and_accepts_the_ported_blocks():
    cfg = DeepSpeedConfig.load(_cfg(
        mesh={"dp": 1}, comms_logger={"enabled": True, "prof_ops": ["qgather"]},
        zero_optimization={**ZERO3Q, "overlap_comm": True, "overlap_prefetch_depth": 2,
                           "zero_quantize_bits": 4, "zero_quantize_block_size": 128}))
    z = cfg.zero_optimization
    assert z.stage == 3 and z.zero_quantize_bits == 4 and z.overlap_prefetch_depth == 2
    assert z.stage3_param_persistence_threshold == int(1e5)  # the reference's default
    assert cfg.comms_logger.enabled and cfg.comms_logger.prof_ops == ["qgather"]
    with pytest.raises(ValueError, match="mesh.dp=2"):
        DeepSpeedConfig.load(_cfg(mesh={"dp": 2}))
    with pytest.raises(ValueError, match="zero_quantize_bits"):
        DeepSpeedConfig.load(_cfg(zero_optimization={"stage": 3, "zero_quantize_bits": 2}))
    model, _ = gpt.build("tiny")
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_cfg(), device="cpu")
    for method in ("comms_verify", "measure_overlap"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A9b"):
            getattr(engine, method)()


def test_int4_wire_trains_and_keeps_straight_through_grads():
    """zero_quantize_bits 4: packed payloads through the gathers, the head on
    B8's plain route (as the reference); the leaves still get gradients."""
    model, _ = gpt.build(gpt.GPTConfig(vocab_size=256, **TINY))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_cfg(
        zero_optimization={**ZERO3Q, "zero_quantize_bits": 4}), device="cpu")
    before = [t.detach().clone() for t in tree_leaves(engine.state["params"])]
    losses = [float(engine.train_batch(_batch(0, 256))["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(engine.state["params"])))


def test_gather_windows_give_the_per_layer_values():
    """An explicit ``stage3_prefetch_bucket_size`` of two layers' elements
    gathers both tiny layers in one window: the same logits as the
    per-layer schedule, half the gather records."""
    tcfg = gpt.GPTConfig(vocab_size=256, **TINY)
    params = gpt.init_params(tcfg, 0, device="cpu")
    ids = _batch(1, 256)["input_ids"]
    per_layer = sum(v[0].numel() for v in params["blocks"].values())
    runs = {}
    for name, extra in (("layer", {}), ("window", {"stage3_prefetch_bucket_size": 2 * per_layer})):
        z = DeepSpeedConfig.load(_cfg(zero_optimization={**ZERO3Q, **extra})).zero_optimization
        before = tledger.snapshot()
        with gather_window(z):
            runs[name] = gpt.forward(tcfg, params, ids, train=False)
        runs[name + "_calls"] = sum(tledger.delta(before).values())
    assert torch.equal(runs["layer"], runs["window"])
    assert runs["layer_calls"] == 2 * runs["window_calls"] - 1  # the head records once in each


def test_wire_ledger_surface():
    from deepspeed_tpu_torch.comm.runtime_accounting import WireLedger
    from deepspeed_tpu_torch.runtime.zero.partitioned_params import Init

    ledger = WireLedger()
    ledger.record("qgather[a]", 400, 100)
    before = ledger.snapshot()
    ledger.record("qgather[a]", 400, 100)
    ledger.record("qmatmul[b]", 300, 200)
    assert ledger.delta(before) == {"qgather[a]": 1, "qmatmul[b]": 1}
    assert ledger.ratio("qgather") == 4.0 and ledger.ratio() == 1100 / 400
    assert ledger.summary_dict()["qmatmul[b]"]["ratio"] == 1.5
    assert "qgather[a]" in ledger.summary()
    ledger.reset()
    assert ledger.ratio() == 1.0 and "no quantized collectives" in ledger.summary()
    with Init():
        pass
