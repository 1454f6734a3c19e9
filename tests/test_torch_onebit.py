"""The 1-bit optimizers (1-bit Adam, 1-bit LAMB, 0/1 Adam) and their
compressed allreduce against the JAX package, at world size 1, fp32.

- The wire: ``pack_signs`` is ``np.packbits(x >= 0)`` byte for byte (-0.0
  packs as 1, NaN as 0) and JAX's; ``quantize_1bit``'s bytes are JAX's and
  its scale within 1e-6 relative (another summation order of the norm).
- The compressed allreduce at world 1 against the JAX body on a 1-device
  mesh: the signed buffer ``x + worker_error`` bitwise, its packed bytes
  bitwise, the result and both residuals within 1e-6 of the scale (fp32
  rounding of two norms). The wire ledger records ``2 n 4`` logical bytes
  against the signs and scales.
- The engine on the linear probe of ``_torch_onebit_workers.py`` (the same
  gradients in both packages), each variant with gas 1 and 2, 5 steps across
  ``freeze_step`` 2: losses within 1e-5 absolute, grad norms 1e-5 relative,
  every state leaf (params, moments, count, the residual rows) within 2e-5
  absolute at every step. The warmup is bitwise the port's dense Adam /
  LAMB run.
- The GPT (``tiny``, 1-bit Adam): each step from the JAX engine's state
  (lockstep), losses 1e-5 and grad norms 1e-4 relative on both sides of
  the freeze.
  Its parameters are not compared past the freeze: the key bias's gradient
  is rounding noise (softmax ignores a shift of the keys), its sign is the
  summation order's, and 1-bit Adam divides the compressed momentum by
  ``sqrt(v) + eps`` there, in both packages alike.
- The reference's refusals, the imperative API and ``train_batches``, and
  tags with ``onebit`` state crossing both ways.
Two ranks: ``test_torch_onebit_dist.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_onebit_ref as ref
import _torch_onebit_workers as workers
import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import quantized as jq
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths
from deepspeed_tpu_torch.comm import quantized as tq
from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.runtime.comm.compressed import (
    compressed_allreduce,
    compression_error_shapes,
)

VARIANTS = ("OneBitAdam", "OneBitLamb", "ZeroOneAdam")
STATE_ATOL = 2e-5
LOSS_ATOL = 1e-5
NORM_RTOL = 1e-5


def test_pack_signs_is_numpy_packbits_and_jax():
    x = np.random.default_rng(0).normal(size=(256,)).astype(np.float32)
    x[:4] = [0.0, -0.0, np.nan, -np.inf]
    got = tq.pack_signs(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.packbits(x >= 0))
    np.testing.assert_array_equal(got, np.asarray(jq.pack_signs(jnp.asarray(x))))
    assert got[0] >> 6 == 0b11  # 0.0 and -0.0 pack as non-negative
    np.testing.assert_array_equal(tq.unpack_signs(torch.from_numpy(got), 256).numpy(),
                                  np.asarray(jq.unpack_signs(jnp.asarray(got), 256)))
    with pytest.raises(ValueError, match="multiple of 8"):
        tq.pack_signs(torch.zeros(12))


def test_quantize_1bit_matches_jax():
    x = np.random.default_rng(1).normal(size=(1000,)).astype(np.float32)
    packed, scale = tq.quantize_1bit(torch.from_numpy(x))
    jpacked, jscale = jq.quantize_1bit(jnp.asarray(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)
    np.testing.assert_allclose(tq.dequantize_1bit(packed, scale, 1000).numpy(),
                               np.asarray(jq.dequantize_1bit(jpacked, jscale, 1000)),
                               rtol=1e-6)


def test_compressed_allreduce_at_world_1_matches_jax():
    x, werr, serr = ref.compressed_inputs(1)
    assert compression_error_shapes(x.shape[1], 1) == (x.shape[1], x.shape[1])
    with pytest.raises(ValueError, match="multiple of world"):
        compression_error_shapes(100, 2)
    jres, jw, js = ref.jax_compressed(x, werr, serr)
    wire_ledger.reset()
    res, w2, s2 = compressed_allreduce(*(torch.from_numpy(a[0]) for a in (x, werr, serr)))
    buf = x[0] + werr[0]
    np.testing.assert_array_equal((torch.from_numpy(x[0]) + torch.from_numpy(werr[0])).numpy(),
                                  np.asarray(jnp.asarray(x[0]) + jnp.asarray(werr[0])))
    np.testing.assert_array_equal(tq.pack_signs(torch.from_numpy(buf)).numpy(),
                                  np.asarray(jq.pack_signs(jnp.asarray(buf))))
    scale = float(np.linalg.norm(buf) / np.sqrt(buf.size))
    for got, want in ((res, jres[0]), (w2, jw[0]), (s2, js[0])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    n = x.shape[1]
    rec = wire_ledger.summary_dict()["compressed_allreduce[dp]"]
    assert rec["count"] == 1 and rec["logical_bytes"] == 2 * n * 4
    assert rec["wire_bytes"] == 2 * n // 8 + 8 and rec["ratio"] > 31


def _assert_runs_close(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=LOSS_ATOL,
                               err_msg=f"{what} losses")
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=NORM_RTOL,
                               err_msg=f"{what} grad norms")
    for s, (g, w) in enumerate(zip(got["states"], want["states"])):
        assert set(g) == set(w), (what, set(g) ^ set(w))
        for k in w:
            diff = np.abs(np.asarray(g[k], np.float32) - w[k])
            assert diff.max() <= STATE_ATOL, (
                f"{what} step {s + 1} {k}: {diff.max():.3g} at flat index "
                f"{int(diff.argmax())} (a 1-bit sign flipped where the signed buffer is "
                f"within rounding of 0 moves an entry by 2 x the scale)")


@pytest.mark.parametrize("gas", [1, 2])
@pytest.mark.parametrize("opt", VARIANTS)
def test_probe_trajectory_matches_jax_across_the_freeze(opt, gas):
    cfg = workers.config(opt, gas=gas)
    batches = [workers.batch(g) for g in workers.grads(1, gas)]
    want = ref.jax_run(ref.jax_engine(cfg), batches)
    got = workers.run(workers.make_engine(cfg), batches)
    _assert_runs_close(got, want, f"{opt} gas {gas}")
    assert got["states"][-1]["onebit/worker_error"].shape == (1, 4728)  # 4725 padded to 8
    assert np.abs(got["states"][-1]["onebit/worker_error"]).max() > 0


@pytest.mark.parametrize("opt", VARIANTS)
def test_warmup_is_bitwise_the_dense_optimizer(opt):
    dense = "Lamb" if opt == "OneBitLamb" else "Adam"
    batches = [workers.batch(g) for g in workers.grads()][:workers.FREEZE]
    onebit = workers.run(workers.make_engine(workers.config(opt)), batches)
    plain = workers.run(workers.make_engine(workers.config(dense)), batches)
    assert onebit["losses"] == plain["losses"] and onebit["norms"] == plain["norms"]
    for a, b in zip(onebit["states"], plain["states"]):
        for k, v in b.items():
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        assert not np.any(a["onebit/worker_error"])  # untouched before the freeze


TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=128)


def test_gpt_losses_match_jax_in_lockstep():
    opt = "OneBitAdam"  # the variant the key bias's noise reaches (module docstring)
    cfg = {"train_micro_batch_size_per_gpu": 4, "steps_per_print": 0,
           "optimizer": {"type": opt, "params": {"lr": 3e-3, "freeze_step": 2,
                                                 "var_freeze_step": 3, "weight_decay": 0.01}}}
    je = deepspeed_tpu.initialize(model=build_gpt(JaxGPTConfig(**TINY))[0],
                                  config=JaxDeepSpeedConfig.load(cfg, 1),
                                  topology=MeshTopology.single_device(), seed=0)[0]
    pe = deepspeed_tpu_torch.initialize(model=gpt.build(gpt.GPTConfig(**TINY))[0], config=cfg,
                                        device="cpu", seed=0)[0]
    for s in range(4):
        b = {"input_ids": np.random.default_rng(10 + s).integers(0, 256, (4, 32),
                                                                 dtype=np.int32)}
        pe.load_state(bridge.train_state_from_numpy(
            jax.tree_util.tree_map(np.array, je.state), "cpu"))
        jm, pm = je.train_batch(b), pe.train_batch(b)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert pe.state["onebit"]["worker_error"].abs().max() > 0


def _tiny_engine(cfg):
    return deepspeed_tpu_torch.initialize(model=gpt.build(gpt.GPTConfig(**TINY))[0],
                                          config=cfg, device="cpu", seed=0)[0]


_ONEBIT = {"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": 1}},
           "train_micro_batch_size_per_gpu": 2, "steps_per_print": 0}
_LTD = {"enabled": True, "data_routing": {"random_ltd": {
    "enabled": True, "total_layer_num": 2, "random_ltd_layer_num": 1,
    "random_ltd_layer_id": [1], "random_ltd_schedule": {
        "min_value": 16, "max_value": 32, "schedule_type": "fixed_linear",
        "schedule_config": {"seq_per_step": 16, "require_steps": 2}}}}}


@pytest.mark.parametrize("over,match", [
    ({"zero_optimization": {"stage": 2}}, "ZeRO stage >= 2"),
    ({"zero_optimization": {"stage": 3}}, "ZeRO stage >= 2"),
    ({"fp16": {"enabled": True}}, "dynamic loss scaling"),
    ({"mesh": {"tp": 2}}, "pure data parallelism"),
    ({"zero_optimization": {"stage": 1, "zero_quantized_gradients": True}},
     "zero_quantized_gradients and 1-bit optimizers are exclusive"),
    ({"progressive_layer_drop": {"enabled": True}}, "progressive_layer_drop is not supported"),
    ({"compression_training": {"weight_quantization": {"shared_parameters": {
        "enabled": True}}}}, "compression_training is not supported together"),
    ({"data_efficiency": _LTD}, "random_ltd is not supported together"),
], ids=["zero2", "zero3", "fp16", "tp", "qgrad", "pld", "compression", "random_ltd"])
def test_restrictions_raise_the_reference_errors(over, match):
    with pytest.raises(ValueError, match=match):
        _tiny_engine({**_ONEBIT, **over})


def test_imperative_api_and_train_batches_refuse_onebit():
    engine = _tiny_engine(_ONEBIT)
    b = {"input_ids": np.zeros((2, 16), np.int32)}
    with pytest.raises(RuntimeError, match="fused train_batch"):
        engine.forward(b)
    with pytest.raises(ValueError, match="train_batches requires"):
        engine.train_batches({"input_ids": np.zeros((2, 2, 16), np.int32)})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_onebit_tags_cross_both_ways(direction, tmp_path):
    """A tag saved after the first compressed step holds ``onebit``'s
    residuals under the reference's names and global shapes; the other
    package loads it bitwise and both go on two steps to the probe's bars."""
    cfg = workers.config("OneBitAdam")
    batches = [workers.batch(g) for g in workers.grads()]
    je, pe = ref.jax_engine(cfg), workers.make_engine(cfg)
    for b in batches[:3]:
        je.train_batch(b)
        pe.train_batch(b)
    if direction == "jax_to_port":
        je.save_checkpoint(str(tmp_path))
        loaded = workers.make_engine(cfg)
        loaded.load_checkpoint(str(tmp_path))
        saved = dict(flatten_with_paths(jax.tree_util.tree_map(
            lambda x: np.array(x, np.float32), je.state)))
        got = dict(flatten_with_paths(bridge.train_state_to_numpy(loaded.state)))
        assert set(got) == set(saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(np.asarray(got[k], np.float32), v, err_msg=k)
        assert got["onebit/worker_error"].shape == (1, 4728)
        _assert_runs_close(workers.run(loaded, batches[3:]), ref.jax_run(je, batches[3:]),
                           "jax tag in the port")
    else:
        pe.save_checkpoint(str(tmp_path))
        je.load_checkpoint(str(tmp_path))
        w = np.array(je.state["onebit"]["worker_error"])
        np.testing.assert_array_equal(w, pe.state["onebit"]["worker_error"].numpy())
        _assert_runs_close(workers.run(pe, batches[3:]), ref.jax_run(je, batches[3:]),
                           "port tag in jax")
