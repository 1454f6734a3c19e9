"""The port's checkpoints against the JAX package's, both ways.

Each configuration (bf16 at stage 0, fp32 at stage 3, fp16 with the loss
scaler; tiny GPT, AdamW) trains a JAX engine and a port engine 2 steps and
saves each. A fresh port engine loads JAX's tag; the JAX engine then loads
the port's tag through ``deepspeed_tpu.checkpoint.load_checkpoint``, which
verifies every file against the port's manifest. In both directions every
state leaf (params, master, opt, scaler, step, micro) is bitwise the saved
one, the counters and ``client_state`` cross, and both engines go on 2
steps on the same batches to the tolerances of
``test_torch_engine.py::test_train_batch_trajectory_matches_jax``: fp32
loss rtol 1e-5 and grad norm 1e-4; 16-bit (bf16, fp16) 2e-2 and 5e-2.
Mid-accumulation tags cross both ways too (fp32, gas 2): the accumulated
gradients bitwise, and the step after the finished window to the fp32
tolerances. (The window's own Adam step is not compared leaf by leaf: a
first Adam step moves each entry by about lr * sign(g), so an entry whose
gradient is near 0 in one framework's rounding moves differently.)
``state.msgpack``, ``zero_to_fp32`` and ``save_16bit_model`` are compared
byte for byte and array for array.
"""

import json
import os

import msgpack
import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint.serialization import _flatten_with_paths
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.resilience.fingerprint import _CRC32C_IS_NATIVE
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu.utils import zero_to_fp32 as jax_zero_to_fp32
from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths, leaf_to_numpy
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.utils import zero_to_fp32

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=64)
SEQ = 32
# name -> (config blocks, loss rtol, grad-norm rtol)
CONFIGS = {
    "bf16-stage0": ({"bf16": {"enabled": True}}, 2e-2, 5e-2),
    "fp32-stage3": ({"zero_optimization": {"stage": 3,
                                           "stage3_gather_16bit_weights_on_model_save": True}},
                    1e-5, 1e-4),
    "fp16-scaler": ({"fp16": {"enabled": True, "initial_scale_power": 8}}, 2e-2, 5e-2),
}


def config(gas=1, micro=4, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "steps_per_print": 0}
    cfg.update(over)
    return cfg


def batch(seed, micro=4):
    return {"input_ids": np.random.default_rng(seed).integers(0, 256, (micro, SEQ),
                                                              dtype=np.int32)}


def jax_engine(cfg):
    model, _ = build_gpt(JaxGPTConfig(**TINY))
    return deepspeed_tpu.initialize(model=model, config=JaxDeepSpeedConfig.load(cfg, world_size=1),
                                    topology=MeshTopology.single_device(), seed=0)[0]


def port_engine(cfg, seed=0):
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    return deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu", seed=seed)[0]


def port_leaves(tree):
    """{key: (dtype name, raw bytes)} of a port tree (bf16 by its bits)."""
    out = {}
    for key, leaf in flatten_with_paths(tree):
        arr, name, _ = leaf_to_numpy(leaf)
        out[key] = (name, np.ascontiguousarray(arr).tobytes())
    return out


def jax_leaves(tree):
    """The same of a JAX tree, keyed as the JAX package's serialization keys it."""
    out = {}
    for key, leaf in _flatten_with_paths(tree)[0]:
        arr = np.asarray(jax.device_get(leaf))
        name = str(arr.dtype)
        if arr.dtype.kind not in "biufc":  # ml_dtypes' bfloat16
            arr = arr.view(np.uint16)
        out[key] = (name, np.ascontiguousarray(arr).tobytes())
    return out


def counters(e):
    return (e.global_steps, e.micro_steps, e.skipped_steps, e.data_cursor)


def _f(x):
    return float(np.asarray(x.detach().float() if torch.is_tensor(x) else x))


def go_on(jengine, engine, seeds):
    """Both engines' (loss, grad norm) over the same batches."""
    out = []
    for s in seeds:
        ref, got = jengine.train_batch(batch(s)), engine.train_batch(batch(s))
        out.append(((_f(ref["loss"]), _f(ref["grad_norm"])),
                    (_f(got["loss"]), _f(got["grad_norm"]))))
    return out


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request, tmp_path_factory):
    over, loss_rtol, norm_rtol = CONFIGS[request.param]
    cfg = config(**over)
    root = tmp_path_factory.mktemp(request.param)
    je, pe = jax_engine(cfg), port_engine(cfg)
    for s in range(2):
        je.train_batch(batch(s))
        pe.train_batch(batch(s))
    r = {"root": root, "rtol": (loss_rtol, norm_rtol),
         "jax_tag": je.save_checkpoint(str(root / "jax"), client_state={"from": "jax"}),
         "port_tag": pe.save_checkpoint(str(root / "port"), client_state={"from": "port"})}
    # JAX -> port
    p2 = port_engine(cfg, seed=1)
    r["j2p_path"], r["j2p_client"] = p2.load_checkpoint(str(root / "jax"))
    r["j2p"] = (jax_leaves(je.state), port_leaves(p2.state))
    r["j2p_counters"] = (counters(je), counters(p2))
    r["j16"] = je.save_16bit_model(str(root / "j16"))
    r["p16"] = p2.save_16bit_model(str(root / "p16"))
    r["j2p_curves"] = go_on(je, p2, (10, 11))
    # port -> JAX, through the JAX package's verified load
    r["p2j_path"], r["p2j_client"] = je.load_checkpoint(str(root / "port"))
    r["p2j"] = (port_leaves(pe.state), jax_leaves(je.state))
    r["p2j_counters"] = (counters(pe), counters(je))
    r["p2j_curves"] = go_on(je, pe, (20, 21))
    return r


def _assert_leaves_equal(saved, loaded):
    assert list(saved) == list(loaded)
    assert {k.split("/")[0] for k in saved} >= {"params", "opt", "scaler", "step", "micro"}
    for k in saved:
        assert saved[k] == loaded[k], k


def _assert_curves(curves, rtol):
    for ref, got in curves:
        np.testing.assert_allclose(got[0], ref[0], rtol=rtol[0])
        np.testing.assert_allclose(got[1], ref[1], rtol=rtol[1])


def test_jax_tag_loads_into_the_port_bitwise(run):
    assert run["j2p_path"] == run["jax_tag"] and run["j2p_client"] == {"from": "jax"}
    _assert_leaves_equal(*run["j2p"])
    jc, pc = run["j2p_counters"]
    assert jc == pc == (2, 2, 0, 2)


def test_jax_tag_resumes_in_the_port(run):
    _assert_curves(run["j2p_curves"], run["rtol"])


def test_port_tag_loads_into_jax_bitwise(run):
    assert run["p2j_path"] == run["port_tag"] and run["p2j_client"] == {"from": "port"}
    _assert_leaves_equal(*run["p2j"])
    pc, jc = run["p2j_counters"]
    assert pc == jc == (2, 2, 0, 2)


def test_port_tag_resumes_in_jax(run):
    _assert_curves(run["p2j_curves"], run["rtol"])


def test_state_msgpack_is_the_reference_bytes(run):
    port = open(os.path.join(run["port_tag"], "state", "state.msgpack"), "rb").read()
    ref = open(os.path.join(run["jax_tag"], "state", "state.msgpack"), "rb").read()
    meta = msgpack.unpackb(port)
    assert msgpack.packb(meta) == port
    assert [(m["key"], m["index"]) for m in meta["leaves"]] == [
        (m["key"], m["index"]) for m in msgpack.unpackb(ref)["leaves"]]
    assert port == ref  # the same shapes and dtypes: the same file


def test_meta_and_manifest_carry_the_reference_layout(run):
    port = json.load(open(os.path.join(run["port_tag"], "meta.json")))
    ref = json.load(open(os.path.join(run["jax_tag"], "meta.json")))
    assert list(port)[:len(ref)] == list(ref) and list(port)[len(ref):] == ["seed"]
    for key in ("has_grad_acc", "world_size", "partition", "global_steps", "micro_steps",
                "skipped_steps", "data_cursor", "emergency", "preemptions_survived"):
        assert port[key] == ref[key], key
    jm = json.load(open(os.path.join(run["jax_tag"], "MANIFEST.json")))
    pm = json.load(open(os.path.join(run["port_tag"], "MANIFEST.json")))
    assert sorted(jm["files"]) == sorted(pm["files"]) and pm["checksum"] == "crc32"
    # the JAX tag the port verified was stamped CRC-32C (read by the table)
    assert jm["checksum"] == ("crc32c" if _CRC32C_IS_NATIVE else "crc32")


@pytest.mark.parametrize("tag", ["jax_tag", "port_tag"])
def test_zero_to_fp32_matches_the_reference_script(run, tag):
    ours = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(run[tag])
    ref = jax_zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(run[tag])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], ref[k])


def test_save_16bit_model_is_the_reference_file(run):
    with np.load(run["j16"]) as ref, np.load(run["p16"]) as ours:
        assert sorted(ours.files) == sorted(ref.files)
        for k in ref.files:
            assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes(), k


# ------------------------------------------------------------------ mid-accumulation
@pytest.fixture(scope="module")
def mid(tmp_path_factory):
    """fp32, gas 2 x micro 2: tags saved after the first micro-step of a
    window, loaded by the other package, the window finished there, then
    one more step on both sides."""
    root = tmp_path_factory.mktemp("mid")
    cfg = config(gas=2, micro=2)
    b0, b1 = batch(0, micro=2), batch(1, micro=2)
    after = {"input_ids": np.random.default_rng(7).integers(0, 256, (2, 2, SEQ), dtype=np.int32)}

    def micro(e, b):
        e.backward(e.forward(b))
        e.step()

    def acc(leaves):
        return [x.numpy().copy() if torch.is_tensor(x) else np.array(jax.device_get(x))
                for x in leaves]

    def next_step(e):
        m = e.train_batch(after)
        return _f(m["loss"]), _f(m["grad_norm"])

    je = jax_engine(cfg)
    micro(je, b0)
    je.save_checkpoint(str(root / "jax"))
    r = {"jax_acc": acc(jax.tree_util.tree_leaves(je._grad_acc))}
    micro(je, b1)  # JAX's uninterrupted window
    r["jax_next"] = next_step(je)
    p1 = port_engine(cfg, seed=3)
    p1.load_checkpoint(str(root / "jax"))
    r["port_loaded_acc"], r["port_loaded_micro"] = acc(p1._grad_acc), p1._micro
    micro(p1, b1)
    r["port_resumed_steps"] = p1.global_steps
    r["port_resumed_next"] = next_step(p1)

    p2 = port_engine(cfg)
    micro(p2, b0)
    p2.save_checkpoint(str(root / "port"))
    r["port_acc"] = acc(p2._grad_acc)
    micro(p2, b1)  # the port's uninterrupted window
    r["port_next"] = next_step(p2)
    je.load_checkpoint(str(root / "port"))
    r["jax_loaded_acc"] = acc(jax.tree_util.tree_leaves(je._grad_acc))
    micro(je, b1)
    r["jax_resumed_steps"] = je.global_steps
    r["jax_resumed_next"] = next_step(je)
    r["metas"] = [json.load(open(root / d / "global_step0" / "meta.json"))
                  for d in ("jax", "port")]
    return r


def _assert_acc_equal(saved, loaded):
    assert len(saved) == len(loaded) > 0
    for a, b in zip(saved, loaded):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_mid_accumulation_jax_tag_resumes_in_the_port(mid):
    assert all(m["has_grad_acc"] and m["micro_steps"] == 1 for m in mid["metas"])
    assert mid["port_loaded_micro"] == 1 and mid["port_resumed_steps"] == 1
    _assert_acc_equal(mid["jax_acc"], mid["port_loaded_acc"])
    _assert_curves([(mid["jax_next"], mid["port_resumed_next"])], (1e-5, 1e-4))


def test_mid_accumulation_port_tag_resumes_in_jax(mid):
    assert mid["jax_resumed_steps"] == 1
    _assert_acc_equal(mid["port_acc"], mid["jax_loaded_acc"])
    _assert_curves([(mid["port_next"], mid["jax_resumed_next"])], (1e-5, 1e-4))
