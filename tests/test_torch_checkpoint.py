"""The port's checkpoints on their own: the msgpack codec against the
``msgpack`` package, the commit protocol (COMMIT, manifest, fallback), the
engine's save / load surface, the checkpoint engines, ``zero_to_fp32`` and
``save_16bit_model``. The format against the JAX package, both ways, is
``test_torch_checkpoint_jax.py``; stage 3 across two ranks is
``test_torch_zero3_dist.py``. Everything here is bitwise: a checkpoint
copies bits.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import msgpack_codec, serialization
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.resilience import (
    CheckpointCorruptionError,
    RetryBudgetExceeded,
    RetryingWriter,
    UncommittedTagError,
    commit_tag,
    crc32c,
)
from deepspeed_tpu_torch.resilience.checksum import preferred_checksum
from deepspeed_tpu_torch.runtime.checkpoint_engine import (
    AsyncCheckpointEngine,
    NativeCheckpointEngine,
    get_checkpoint_engine,
)
from deepspeed_tpu_torch.utils import zero_to_fp32
from deepspeed_tpu_torch.utils.tree import tree_leaves

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "deepspeed_tpu_torch"
TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=64)


def config(gas=1, micro=4, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "steps_per_print": 0}
    cfg.update(over)
    return cfg


def engine(cfg=None, seed=0):
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    return deepspeed_tpu_torch.initialize(model=model, config=cfg or config(), device="cpu",
                                          seed=seed)[0]


def batch(seed, micro=4):
    return {"input_ids": np.random.default_rng(seed).integers(0, 256, (micro, 32),
                                                              dtype=np.int32)}


def state_leaves(e):
    return serialization.flatten_with_paths(e.state)


def assert_states_equal(a, b):
    fa, fb = state_leaves(a), state_leaves(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach()), k


# --------------------------------------------------------------------------- codec
# every width boundary of msgpack's ints, strs, arrays and maps
BOUNDARY_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]


@pytest.mark.parametrize("value", BOUNDARY_INTS + [
    None, True, False, 0.0, -0.0, 1.5, -2.25e300, float("inf"),
    "", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 65535, "a" * 65536, "é",
    list(range(15)), list(range(16)), list(range(65536)), (1, "x"),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): None for i in range(65536)},
], ids=lambda v: repr(v)[:24] if not isinstance(v, (list, dict, str)) or len(v) < 20
    else f"{type(v).__name__}{len(v)}")
def test_codec_matches_msgpack_at_every_width(value):
    packed = msgpack.packb(value)
    assert msgpack_codec.packb(value) == packed
    assert msgpack_codec.unpackb(packed) == msgpack.unpackb(packed)


_SCALARS = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40))
_TREES = st.recursive(_SCALARS, lambda kids: st.lists(kids, max_size=20)
                      | st.dictionaries(st.text(max_size=8), kids, max_size=20), max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_TREES)
def test_codec_property_against_msgpack(value):
    packed = msgpack.packb(value)
    assert msgpack_codec.packb(value) == packed
    assert msgpack_codec.unpackb(packed) == msgpack.unpackb(packed)


def test_codec_rejects_what_is_not_the_subset():
    with pytest.raises(TypeError):
        msgpack_codec.packb(b"bytes")
    with pytest.raises(OverflowError):
        msgpack_codec.packb(2**64)
    with pytest.raises(ValueError, match="extra data"):
        msgpack_codec.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        msgpack_codec.unpackb(msgpack.packb("abcdef")[:-2])
    with pytest.raises(ValueError, match="outside the checkpoint subset"):
        msgpack_codec.unpackb(msgpack.packb(b"raw bytes"))


# ------------------------------------------------------------------- checksums, retry
def test_crc32c_table_and_the_checksum_choice(monkeypatch):
    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert crc32c(b"6789", crc32c(b"12345")) == 0xE3069283  # streamed
    monkeypatch.delenv("DS_CHECKPOINT_CHECKSUM", raising=False)
    assert preferred_checksum() == "crc32"  # no CRC-32C package is imported
    monkeypatch.setenv("DS_CHECKPOINT_CHECKSUM", "crc32c")
    assert preferred_checksum() == "crc32c"
    monkeypatch.setenv("DS_CHECKPOINT_CHECKSUM", "md5")
    with pytest.raises(ValueError, match="known"):
        preferred_checksum()


def test_retrying_writer_retries_transient_errors_then_gives_up(tmp_path):
    sleeps = []
    writer = RetryingWriter(attempts=3, sleep=sleeps.append)
    fails = iter([OSError("flaky"), OSError("flaky")])

    def flaky():
        err = next(fails, None)
        if err:
            raise err
        return "done"

    assert writer.call(flaky) == "done"
    assert writer.retries_performed == 2 and len(sleeps) == 2
    with pytest.raises(RetryBudgetExceeded):
        writer.call(lambda: (_ for _ in ()).throw(OSError("down")))
    with pytest.raises(TypeError):  # not transient: no retry
        writer.call(lambda: (_ for _ in ()).throw(TypeError("bug")))
    writer.write_bytes(str(tmp_path / "f"), b"abc")
    assert (tmp_path / "f").read_bytes() == b"abc"
    assert os.listdir(tmp_path) == ["f"]  # no tmp file left behind


# --------------------------------------------------------------------------- protocol
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A bf16 engine after 2 steps, saved at step 1 and step 2."""
    root = tmp_path_factory.mktemp("trained")
    e = engine(config(bf16={"enabled": True}))
    e.train_batch(batch(0))
    e.save_checkpoint(str(root), client_state={"epoch": 3, "note": "hi"})
    e.train_batch(batch(1))
    e.save_checkpoint(str(root))
    return e, root


def _copy(src, dst):
    import shutil

    shutil.copytree(src, dst)
    return dst


def test_tag_layout_and_latest(trained):
    e, root = trained
    assert (root / "latest").read_text() == "global_step2"
    tag = root / "global_step2"
    assert sorted(os.listdir(tag)) == ["COMMIT", "MANIFEST.json", "meta.json", "state",
                                       "zero_to_fp32.py"]
    meta = json.loads((tag / "meta.json").read_text())
    assert meta["global_steps"] == 2 and meta["data_cursor"] == 2 and meta["world_size"] == 1
    assert meta["partition"] == {"format": "flat-padded-v1", "dp": 1, "micro_batch": 4,
                                 "gas": 1, "global_batch": 4}
    assert meta["rng_key"] is None and meta["seed"] == 0 and meta["has_grad_acc"] is False
    manifest = json.loads((tag / "MANIFEST.json").read_text())
    assert manifest["checksum"] == "crc32" and manifest["manifest_version"] == 1
    keys = [m["key"] for m in serialization.read_meta(str(tag / "state"))["leaves"]]
    assert keys == [k for k, _ in state_leaves(e)]
    assert keys[0] == "master/blocks/attn_out_b" and keys[-1] == "step"


def test_load_restores_state_counters_and_client_state(trained):
    e, root = trained
    e2 = engine(config(bf16={"enabled": True}), seed=7)
    path, client = e2.load_checkpoint(str(root), tag="global_step1")
    assert path.endswith("global_step1") and client == {"epoch": 3, "note": "hi"}
    assert (e2.global_steps, e2.micro_steps, e2.skipped_steps, e2.data_cursor, e2.seed) == (
        1, 1, 0, 1, 0)
    path, client = e2.load_checkpoint(str(root))
    assert path.endswith("global_step2") and client == {}
    assert_states_equal(e, e2)
    assert e2.state["params"]["wte"].dtype == torch.bfloat16
    assert e2.state["params"]["wte"].requires_grad
    # two loads go on the same way (the fixture's engine stays at step 2)
    e3 = engine(config(bf16={"enabled": True}), seed=8)
    e3.load_checkpoint(str(root))
    np.testing.assert_array_equal(e3.train_batch(batch(5))["loss"].detach().numpy(),
                                  e2.train_batch(batch(5))["loss"].detach().numpy())
    assert_states_equal(e3, e2)


def test_missing_directory_and_missing_tag(tmp_path):
    e = engine()
    assert e.load_checkpoint(str(tmp_path / "nothing")) == (None, {})
    with pytest.raises(FileNotFoundError):
        e.load_checkpoint(str(tmp_path), tag="global_step9")


def test_a_tag_without_commit_is_skipped(trained, tmp_path):
    _, root = trained
    root = _copy(root, tmp_path / "ckpt")
    os.remove(root / "global_step2" / "COMMIT")
    e = engine(config(bf16={"enabled": True}), seed=3)
    path, _ = e.load_checkpoint(str(root))
    assert path.endswith("global_step1")
    with pytest.raises(UncommittedTagError, match="no COMMIT"):
        e.load_checkpoint(str(root), tag="global_step2")


def test_a_flipped_byte_falls_back_or_raises(trained, tmp_path):
    src, root = trained
    root = _copy(root, tmp_path / "ckpt")
    victim = root / "global_step2" / "state" / "arrays" / "3.npy"
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0x10
    victim.write_bytes(bytes(data))
    e = engine(config(bf16={"enabled": True}), seed=3)
    path, client = e.load_checkpoint(str(root))
    assert path.endswith("global_step1") and client["epoch"] == 3
    assert e.global_steps == 1
    with pytest.raises(CheckpointCorruptionError, match="corrupted shard") as info:
        e.load_checkpoint(str(root), tag="global_step2")
    assert "state/arrays/3.npy" in info.value.reason
    os.truncate(victim, 10)
    with pytest.raises(CheckpointCorruptionError, match="truncated"):
        e.load_checkpoint(str(root), tag="global_step2")
    # every candidate rejected: nothing loads silently
    for name in ("global_step1", "global_step2"):
        os.remove(root / name / "MANIFEST.json")
    with pytest.raises(CheckpointCorruptionError, match="no loadable checkpoint"):
        e.load_checkpoint(str(root))


def test_a_resaved_tag_loses_commit_before_its_content_changes(tmp_path, monkeypatch):
    import deepspeed_tpu_torch.checkpoint as ckpt

    e = engine()
    e.train_batch(batch(0))
    e.save_checkpoint(str(tmp_path))
    commit = tmp_path / "global_step1" / "COMMIT"
    seen = []
    real = ckpt.save_pytree

    def spy(tree, directory, file_writer=None):
        seen.append(commit.exists())
        real(tree, directory, file_writer=file_writer)

    monkeypatch.setattr(ckpt, "save_pytree", spy)
    e.save_checkpoint(str(tmp_path))  # the same step: the same tag, rewritten
    assert seen == [False] and commit.exists()


def test_load_without_optimizer_states_keeps_opt_and_master(trained):
    e, root = trained
    e2 = engine(config(bf16={"enabled": True}), seed=11)
    opt, master = e2.state["opt"], e2.state["master"]
    e2.load_checkpoint(str(root), load_optimizer_states=False)
    assert e2.state["opt"] is opt and e2.state["master"] is master
    for a, b in zip(tree_leaves(e2.state["params"]), tree_leaves(e.state["params"])):
        assert torch.equal(a.detach(), b.detach())


def test_async_engine_writes_the_native_engines_bytes(tmp_path):
    files = {}
    for kind in ("native", "async"):
        e = engine(config(checkpoint={"checkpoint_engine": kind, "writers": 3}))
        e.train_batch(batch(0))
        tag = pathlib.Path(e.save_checkpoint(str(tmp_path / kind)))
        assert isinstance(e._ckpt_engine,
                          AsyncCheckpointEngine if kind == "async" else NativeCheckpointEngine)
        files[kind] = {p.relative_to(tag): p.read_bytes() for p in (tag / "state").rglob("*")
                       if p.is_file()}
        if kind == "async":
            e._ckpt_engine.shutdown()
    assert files["native"] == files["async"] and len(files["native"]) > 1


def test_checkpoint_engine_selection_and_async_errors(tmp_path):
    assert isinstance(get_checkpoint_engine({}), NativeCheckpointEngine)
    assert isinstance(get_checkpoint_engine({"checkpoint": {"checkpoint_engine": "bogus"}}),
                      NativeCheckpointEngine)
    e = get_checkpoint_engine({"checkpoint": {"checkpoint_engine": "async", "writers": 1}})
    arr = np.arange(6, dtype=np.float32)
    e.save({"a": arr}, str(tmp_path / "x.npz"))
    arr[:] = -1  # the queued save holds a snapshot
    e.save_array(str(tmp_path / "missing_dir" / "y.npy"), arr)  # fails in the background
    with pytest.raises(IOError, match="async checkpoint writes failed"):
        e.commit("t")
    np.testing.assert_array_equal(e.load(str(tmp_path / "x.npz"))["a"], np.arange(6))
    e.shutdown()


def _recommit(tag_dir, **meta_over):
    meta = json.loads((tag_dir / "meta.json").read_text())
    meta.update(meta_over)
    (tag_dir / "meta.json").write_text(json.dumps(meta))
    commit_tag(str(tag_dir))


def test_other_world_size_and_offload_state_raise_their_items(trained, tmp_path):
    _, root = trained
    root = _copy(root, tmp_path / "ckpt")
    _recommit(root / "global_step2", world_size=2)
    e = engine(config(bf16={"enabled": True}))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9b"):
        e.load_checkpoint(str(root), tag="global_step2")
    (root / "global_step1" / "host_state").mkdir()
    (root / "global_step1" / "host_state" / "host_meta.json").write_text("{}")
    commit_tag(str(root / "global_step1"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A12"):
        e.load_checkpoint(str(root), tag="global_step1")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A12"):
        zero_to_fp32_without_master(root)
    assert e.global_steps == 0  # nothing changed before the raise


def zero_to_fp32_without_master(root):
    """zero_to_fp32 on a tag whose masters would live in offload state."""
    tag = root / "global_step1"
    meta = serialization.read_meta(str(tag / "state"))
    meta["leaves"] = [m for m in meta["leaves"] if not m["key"].startswith("master/")]
    (tag / "state" / "state.msgpack").write_bytes(msgpack_codec.packb(meta))
    return zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(root), "global_step1")


def test_mid_accumulation_round_trip_is_bitwise(tmp_path):
    """A save between forward() calls keeps the accumulated gradients: the
    resumed window ends on the uninterrupted window's params, bitwise (the
    counterpart of tests/test_checkpoint.py::test_mid_accumulation_roundtrip)."""
    cfg = config(gas=2, micro=2)
    b0, b1 = batch(0, micro=2), batch(1, micro=2)

    def micro(e, b):
        e.backward(e.forward(b))
        e.step()

    ref = engine(cfg)
    micro(ref, b0)
    micro(ref, b1)
    a = engine(cfg)
    micro(a, b0)
    a.save_checkpoint(str(tmp_path))
    meta = json.loads((tmp_path / "global_step0" / "meta.json").read_text())
    assert meta["has_grad_acc"] and meta["micro_steps"] == 1
    b = engine(cfg, seed=5)
    b.load_checkpoint(str(tmp_path))
    assert b._micro == 1 and not b.is_gradient_accumulation_boundary()
    for x, y in zip(a._grad_acc, b._grad_acc):
        assert torch.equal(x, y)
    micro(b, b1)
    assert b.global_steps == 1 and b.micro_steps == 2 and b._grad_acc is None
    assert_states_equal(ref, b)


def test_config_keys_and_universal_flag_no_longer_raise():
    e = engine(config(checkpoint={"checkpoint_engine": "native"},
                      load_universal_checkpoint=True))
    assert e.load_universal_checkpoint() is True and e.config.checkpoint == {
        "checkpoint_engine": "native"}
    assert engine().load_universal_checkpoint() is False


# ------------------------------------------------------------- 16-bit model, fp32 consolidation
def test_save_16bit_model_holds_the_params_bitwise(trained, tmp_path):
    e, _ = trained
    path = e.save_16bit_model(str(tmp_path))
    assert path.endswith("pytorch_model.npz")
    with np.load(path) as npz:
        stored = dict(npz)
    keys = [f"{k}::bfloat16" for k, _ in serialization.flatten_with_paths(e.state["params"])]
    assert sorted(stored) == sorted(keys)
    for key, p in serialization.flatten_with_paths(e.state["params"]):
        got = torch.from_numpy(stored[f"{key}::bfloat16"].view(np.int16)).view(torch.bfloat16)
        assert torch.equal(got, p.detach()), key


def test_save_16bit_model_under_stage3_needs_the_gather_flag(tmp_path):
    e = engine(config(zero_optimization={"stage": 3}))
    with pytest.raises(ValueError, match="stage3_gather_16bit_weights_on_model_save"):
        e.save_16bit_model(str(tmp_path))
    e = engine(config(zero_optimization={"stage": 3,
                                         "stage3_gather_16bit_weights_on_model_save": True}))
    with np.load(e.save_16bit_model(str(tmp_path))) as npz:
        assert npz["wte"].dtype == np.float32 and npz["wte"].shape == (256, 64)


def test_zero_to_fp32_prefers_the_master_and_runs_standalone(trained, tmp_path):
    e, root = trained
    sd = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(root))
    for key, m in serialization.flatten_with_paths(e.state["master"]):
        assert sd[key].dtype == np.float32
        np.testing.assert_array_equal(sd[key], m.numpy())
    # the copy in the tag, run by a bare interpreter from another directory
    out = tmp_path / "fp32.npz"
    proc = subprocess.run([sys.executable, "-I", str(root / "global_step2" / "zero_to_fp32.py"),
                           str(root), str(out)], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-600:]
    with np.load(out) as npz:
        assert sorted(npz.files) == sorted(sd)
        for k in sd:
            np.testing.assert_array_equal(npz[k], sd[k])


def test_zero_to_fp32_widens_bf16_params_without_a_master(tmp_path):
    e = engine(config(bf16={"enabled": True, "master_weights": False}))
    e.save_checkpoint(str(tmp_path))
    sd = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path), "global_step0")
    for key, p in serialization.flatten_with_paths(e.state["params"]):
        np.testing.assert_array_equal(sd[key], p.detach().float().numpy())


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_zero_to_fp32_imports_only_the_standard_library_and_numpy():
    names = {n.split(".")[0] for n in _imports(PORT / "utils" / "zero_to_fp32.py")}
    assert names - set(sys.stdlib_module_names) == {"numpy"}


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_imports_msgpack_ml_dtypes_or_a_crc32c_package(path):
    for name in _imports(path):
        assert name.split(".")[0] not in ("msgpack", "ml_dtypes", "google_crc32c",
                                          "crc32c"), f"{path} imports {name}"
