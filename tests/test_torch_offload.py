"""ZeRO-Offload in the port against the JAX package's ``HostOffloadRunner``.

Both engines start from the JAX engine's initial state (bridged) and take
the same numpy batches; the port's runner fetches the gradients into pinned
buffers, clips on the host and steps the host SIMD optimizer. Bars, those of
``test_torch_engine.py``: fp32 loss rtol 1e-5 and grad norm 1e-4, and the
updated host masters rtol 1e-3 / atol 2e-5 (the reference's own bar for
offload against the device optimizer); bf16 rtol 2e-2 on the loss and 5e-2
on the grad norm. The JAX runs are shared across cases (a module fixture).
NVMe mode is bitwise the RAM mode; the legacy ``cpu_offload`` flag routes
to the runner; the reference's refusals are pinned in both packages; host
shards go under the tag's MANIFEST, ``zero_to_fp32`` reads them, and tags
cross both ways; a flipped host-shard bit is detected and healed bitwise.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu.resilience as jres
import deepspeed_tpu_torch
import deepspeed_tpu_torch.resilience as tres
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu.utils import zero_to_fp32 as jax_zero_to_fp32
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.utils import zero_to_fp32

TINY = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, max_seq_len=32)
OFFLOAD = {"stage": 2, "offload_optimizer": {"device": "cpu"}}
# case -> (config blocks, loss rtol, grad-norm rtol, what else is held: the
# host masters against JAX's ("masters"), or the bf16 copy-back ("bf16")).
# Adagrad's masters are not compared entry by entry: its first step moves an
# entry by about lr * sign(g) down to |g| ~ eps = 1e-10, and the key bias's
# gradient is 0 up to each framework's rounding
CASES = {
    "fp32": ({"zero_optimization": OFFLOAD}, 1e-5, 1e-4, "masters"),
    "fp32-gas2": ({"zero_optimization": OFFLOAD, "gradient_accumulation_steps": 2},
                  1e-5, 1e-4, "masters"),
    "adagrad": ({"zero_optimization": OFFLOAD,
                 "optimizer": {"type": "Adagrad", "params": {"lr": 1e-2}}}, 1e-5, 1e-4, None),
    "bf16": ({"zero_optimization": OFFLOAD, "bf16": {"enabled": True}}, 2e-2, 5e-2, "bf16"),
}
STEPS = 3


def config(**over):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "steps_per_print": 0}
    cfg.update(over)
    return cfg


def batch(i, gas=1):
    shape = (2, 16) if gas == 1 else (gas, 2, 16)
    return {"input_ids": np.random.default_rng(i).integers(0, 64, shape).astype(np.int32)}


def jax_engine(cfg):
    model, _ = build_gpt(JaxGPTConfig(**TINY))
    return deepspeed_tpu.initialize(model=model, config=JaxDeepSpeedConfig.load(cfg, 1),
                                    topology=MeshTopology.single_device(), seed=0)[0]


def port_engine(cfg, state=None):
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    engine = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")[0]
    if state is not None:
        engine.load_state(bridge.train_state_from_numpy(state, "cpu", engine.pc.compute_dtype))
    return engine


def _f(x):
    return float(x.detach().float() if torch.is_tensor(x) else np.asarray(x))


@pytest.fixture(scope="module")
def reference():
    """Per case: the JAX engine's initial state, then its losses, grad
    norms and host masters after STEPS steps."""
    out = {}
    for name, (over, *_) in CASES.items():
        cfg = config(**over)
        je = jax_engine(cfg)
        state = jax.tree_util.tree_map(np.asarray, je.state)
        gas = cfg.get("gradient_accumulation_steps", 1)
        ms = [je.train_batch(batch(i, gas)) for i in range(STEPS)]
        out[name] = (cfg, state, [_f(m["loss"]) for m in ms], [_f(m["grad_norm"]) for m in ms],
                     [np.array(x) for x in je._offload.master])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_the_jax_runner(reference, case):
    cfg, state, losses, norms, masters = reference[case]
    _, loss_rtol, norm_rtol, held = CASES[case]
    engine = port_engine(cfg, state)
    assert engine._offload is not None and engine._param_stream is None
    gas = cfg.get("gradient_accumulation_steps", 1)
    for i in range(STEPS):
        m = engine.train_batch(batch(i, gas))
        np.testing.assert_allclose(_f(m["loss"]), losses[i], rtol=loss_rtol)
        np.testing.assert_allclose(_f(m["grad_norm"]), norms[i], rtol=norm_rtol)
        assert not bool(m["overflow"])
    runner = engine._offload
    assert runner.count == STEPS and engine.global_steps == STEPS
    assert engine.micro_steps == STEPS * gas
    if held == "masters":
        for a, b in zip(runner.master, masters):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-5)
    # the device parameters are the pushed masters (bf16: the copy-back
    # written in the optimizer's pass, bitwise the torch cast)
    for p, mst in zip(gpt_leaves(engine), runner.master):
        assert p.dtype == (torch.bfloat16 if held == "bf16" else torch.float32)
        want = torch.from_numpy(mst).to(p.dtype)
        assert torch.equal(p.detach().view(torch.int16) if held == "bf16" else p.detach(),
                           want.view(torch.int16) if held == "bf16" else want)


def gpt_leaves(engine):
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    return tree_leaves(engine.state["params"])


def test_nvme_state_is_bitwise_the_ram_run(reference, tmp_path):
    cfg, state, *_ = reference["fp32"]
    ram = port_engine(cfg, state)
    nvme = port_engine(config(zero_optimization={"stage": 2, "offload_optimizer": {
        "device": "nvme", "nvme_path": str(tmp_path), "buffer_count": 2}}), state)
    assert nvme._offload.store is not None
    for i in range(STEPS):
        a, b = ram.train_batch(batch(i)), nvme.train_batch(batch(i))
        assert _f(a["loss"]) == _f(b["loss"]) and _f(a["grad_norm"]) == _f(b["grad_norm"])
    d = nvme._offload.store.read_all()
    for i, (mst, m, v) in enumerate(zip(ram._offload.master, ram._offload.m, ram._offload.v)):
        for got, want in ((d[f"master_{i}"], mst), (d[f"m_{i}"], m), (d[f"v_{i}"], v)):
            np.testing.assert_array_equal(got, want)
    assert sorted(os.listdir(tmp_path / "optimizer"))[0] == "leaf_0_m.bin"


def test_legacy_flag_device_state_and_surface():
    engine = port_engine(config(zero_optimization={"stage": 2, "cpu_offload": True}))
    assert engine._offload is not None
    assert engine.state["master"] == {} and engine.state["opt"] == {}
    assert engine.state["params"]["wte"].dtype == torch.float32
    engine.train_batch(batch(0))
    stats = engine.memory_stats()
    assert stats["host_step_s"] >= 0 and stats["fetch_s"] >= 0 and stats["host_cores"] >= 1
    with pytest.raises(ValueError, match="train_batch per step"):
        engine.train_batches({"input_ids": np.stack([batch(1)["input_ids"]] * 2)})
    with pytest.raises(RuntimeError, match="fused train_batch"):
        engine.forward(batch(1))


MOQ = {"weight_quantization": {"shared_parameters": {"enabled": True, "schedule_offset": 1},
                               "different_groups": {"g": {"params": {
                                   "start_bits": 8, "target_bits": 4,
                                   "quantization_period": 1}}}}}
LTD = {"enabled": True, "data_routing": {"enabled": True, "random_ltd": {
    "enabled": True, "total_layer_num": 2, "random_ltd_layer_num": 1, "random_ltd_layer_id": [1],
    "random_ltd_schedule": {"min_value": 8, "max_value": 16, "schedule_type": "fixed_linear",
                            "schedule_config": {"seq_per_step": 8, "require_steps": 4}}}}}


@pytest.mark.parametrize("over,match", [
    ({"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": 2}},
      "zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}}},
     "1-bit optimizers are exclusive"),
    ({"compression_training": MOQ}, "compression_training is not supported"),
    ({"progressive_layer_drop": {"enabled": True}}, "progressive_layer_drop is not supported"),
    ({"data_efficiency": LTD}, "random_ltd is not supported"),
    ({"zero_optimization": {**OFFLOAD, "zero_quantized_gradients": True}},
     "zero_quantized_gradients"),
    ({"fp16": {"enabled": True}}, "no dynamic loss scaling"),
], ids=["onebit", "compression", "pld", "random_ltd", "qgrad", "fp16"])
def test_refusals_are_the_reference_s(over, match):
    cfg = config(zero_optimization=OFFLOAD)
    cfg.update(over)
    with pytest.raises(ValueError, match=match):
        port_engine(cfg)
    with pytest.raises(ValueError, match=match):
        jax_engine(cfg)


def test_host_shards_under_the_manifest_and_zero_to_fp32(reference, tmp_path):
    """RAM mode saves host_state/ shards before the manifest, which covers
    them; both packages' zero_to_fp32 read the masters back positionally."""
    cfg, state, *_ = reference["fp32"]
    engine = port_engine(cfg, state)
    engine.train_batch(batch(0))
    tag = engine.save_checkpoint(str(tmp_path))
    manifest = json.loads(open(os.path.join(tag, "MANIFEST.json")).read())
    shards = sorted(f for f in os.listdir(os.path.join(tag, "host_state")) if f.endswith(".npz"))
    assert shards and all(f"host_state/{s}" in manifest["files"] for s in shards)
    assert "host_state/host_meta.json" in manifest["files"]
    assert os.path.exists(os.path.join(tag, "COMMIT"))
    for sd in (zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path)),
               jax_zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))):
        assert len(sd) == len(engine._offload.master)
        for got, want in zip(sd.values(), engine._offload.master):
            np.testing.assert_array_equal(got.ravel(), want.ravel())


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_tags_with_host_state_cross_both_ways(reference, tmp_path, direction):
    """A tag of 2 offload steps saved by one package loads into the other:
    the host masters and moments bitwise, the counters, then the next step
    within the fp32 bars."""
    cfg, state, *_ = reference["fp32"]
    je, te = jax_engine(cfg), port_engine(cfg, state)
    for i in range(2):
        je.train_batch(batch(i))
        te.train_batch(batch(i))
    src, dst = (je, port_engine(cfg)) if direction == "jax-to-port" else (te, jax_engine(cfg))
    src.save_checkpoint(str(tmp_path))
    dst.load_checkpoint(str(tmp_path))
    assert dst._offload.count == 2 and dst.global_steps == 2
    for name in ("master", "m", "v"):
        for a, b in zip(getattr(dst._offload, name), getattr(src._offload, name)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref = (je if direction == "jax-to-port" else te).train_batch(batch(2))
    out = dst.train_batch(batch(2))
    np.testing.assert_allclose(_f(out["loss"]), _f(ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(_f(out["grad_norm"]), _f(ref["grad_norm"]), rtol=1e-4)


def _resilient(tmp_path, chaos=None):
    res = {"enabled": True, "save_dir": str(tmp_path), "install_signal_handlers": False,
           "auto_resume": False,
           "sentinel": {"enabled": True, "warmup_steps": 1, "checkpoint_interval": 2},
           "integrity": {"enabled": True, "scan_interval": 1, "blocks_per_scan": 4,
                         "block_bytes": 4096}}
    if chaos:
        res["chaos"] = chaos
    return port_engine(config(zero_optimization=OFFLOAD, resilience=res))


def test_host_shard_flip_is_detected_and_healed(tmp_path):
    """A bit flipped in the host masters at cursor 3 is caught before the
    next step mutates them, the engine rolls back to the step-2 tag (its
    host shards) and replays: the run ends bitwise on the clean run."""
    tres.install_plan(None)
    clean = _resilient(tmp_path / "clean")
    assert clean._integrity.domains == ["host_shards"]
    while clean.global_steps < 5:
        clean.train_batch(batch(clean.data_cursor))
    saw = []
    try:
        hit = _resilient(tmp_path / "hit", {"flip_bit_at": 3, "flip_bit_domain": "host_shards"})
        while hit.global_steps < 5:
            saw.append("sdc" in hit.train_batch(batch(hit.data_cursor)))
    finally:
        tres.install_plan(None)
        jres.install_plan(None)
    assert any(saw)
    events = [ev["event"] for ev in tres.read_events(str(tmp_path / "hit"))]
    assert "sdc_detected" in events and "sdc_rollback" in events
    for a, b in zip(hit._offload.master, clean._offload.master):
        np.testing.assert_array_equal(a, b)
