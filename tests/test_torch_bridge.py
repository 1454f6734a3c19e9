"""Weight transfer between the packages, and the port's isolation from JAX."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jax_gpt
from deepspeed_tpu_torch.bridge import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.inference import for_gpt
from deepspeed_tpu_torch.models import gpt

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "deepspeed_tpu_torch"


def test_gpt2_125m_tree_round_trips_bitwise():
    jparams = jax_gpt.init_params(jax_gpt.PRESETS["gpt2-125m"], jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_numpy(tree, "cpu")
    assert params["blocks"]["qkv_w"].shape == (12, 768, 3 * 768)  # x @ W layout, [L, d, 3d]
    back = params_to_numpy(params)
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_bf16_leaves_cross_bitwise():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(x)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x.astype(jnp.float32)))
    assert params_to_numpy({"w": t})["w"].dtype == np.float32


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; before = set(sys.modules); import deepspeed_tpu_torch, "
            "deepspeed_tpu_torch.inference, deepspeed_tpu_torch.inference.serving, "
            "deepspeed_tpu_torch.models.gpt, deepspeed_tpu_torch.ops.sparse_attention, "
            "deepspeed_tpu_torch.ops.cuda.blocksparse_attention, "
            "deepspeed_tpu_torch.bridge, deepspeed_tpu_torch.runtime.engine; "
            "new = set(sys.modules) - before; "
            "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', "
            "'deepspeed_tpu')); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_imports_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "deepspeed_tpu"), (
                f"{path} imports {name}")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """``device=None`` means the CUDA device; with none available the entry
    points raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt.PRESETS["tiny"]
    model = for_gpt(cfg, gpt.init_params(cfg, 0, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        deepspeed_tpu_torch.init_inference(model, dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA device"):
        gpt.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        deepspeed_tpu_torch.get_accelerator()
    with pytest.raises(RuntimeError, match="CUDA device"):
        deepspeed_tpu_torch.initialize(model=gpt.build("tiny")[0], config={})
    assert deepspeed_tpu_torch.get_accelerator("cpu").preferred_dtype() == torch.float32


def test_train_state_round_trips_bitwise():
    """A JAX engine state (bf16 params, fp32 master, AdamState after one
    step, ScalerState) crosses into the port and back unchanged."""
    import deepspeed_tpu
    from deepspeed_tpu.models import build_gpt
    from deepspeed_tpu.runtime.config import DeepSpeedConfig
    from deepspeed_tpu.runtime.topology import MeshTopology
    from deepspeed_tpu_torch.bridge import train_state_from_numpy, train_state_to_numpy

    model, _ = build_gpt(jax_gpt.PRESETS["tiny"])
    cfg = DeepSpeedConfig.load({"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
                                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}, 1)
    engine, *_ = deepspeed_tpu.initialize(model=model, config=cfg, seed=0,
                                          topology=MeshTopology.single_device())
    engine.train_batch({"input_ids": np.arange(32, dtype=np.int32).reshape(2, 16)})
    tree = jax.tree_util.tree_map(np.asarray, engine.state)
    state = train_state_from_numpy(tree, "cpu", torch.bfloat16)
    assert state["params"]["wte"].dtype == torch.bfloat16
    assert state["opt"].mu["wte"].dtype == torch.float32 and int(state["opt"].count) == 1
    back = train_state_to_numpy(state)
    flat = jax.tree_util.tree_leaves(tree)
    flat_back = jax.tree_util.tree_leaves(back)
    assert len(flat) == len(flat_back)
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))
