"""ZeRO-3 and the quantized collectives across two ranks: two processes on
gloo, started once for the module with the ``spawn`` method (a fork after
JAX's threads start can hang; the rank side, ``_torch_zero3_workers.py``,
imports no JAX, and the JAX results are computed here in the parent).

- ``qall_gather`` and ``qreduce_scatter`` (sum and mean, with and without
  the error-feedback residual) and ``qall_to_all`` give each rank what the
  JAX package's give the same rank on a 2-device mesh, to the rounding of
  the dequantize (2e-6 absolute, values up to ~5): the payloads are bitwise
  the same, but under ``jit`` XLA fuses the dequantize's multiply and add
  into one fused multiply-add, where the port rounds them apart (as the
  reference does outside ``jit``, bitwise, ``test_torch_zero3.py``).
- The stage-3 engine at dp2 (fp32, quantized weights and head, the
  persistence threshold at 0 so that the layers are split) gathers layer 0
  bitwise equal to the world-1 engine's (every rank's quantization blocks
  are whole rows of the logical leaf), and its 3-step losses and grad norms
  equal the world-1 run's to the summation order of a split batch (losses
  1e-5, grad norms 1e-4 relative: after step 1 a last-bit difference can
  flip a round-half case by one quantization level); the joined final state
  equals world 1's within 2e-5.
- Checkpoints at dp2: the tag saved right after the start state was loaded
  holds the full logical leaves, bitwise the world-1 state's (the ranks'
  slices joined, and the format topology-free); the trained state saved and
  loaded back into an engine from another seed gives each rank bitwise the
  slices it saved, and the layer gathered over the int wire after the load
  is bitwise the one before (a slice never cuts a quantization block); a
  world-1 engine refuses the dp2 tag (reshard-on-load, ROADMAP.md A9b).
"""

import json
import os
import time

import numpy as np
import pytest
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import _torch_zero3_workers as workers
import deepspeed_tpu_torch
from deepspeed_tpu.comm import quantized as jq
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.checkpoint import serialization
from deepspeed_tpu_torch.models import gpt

W = 2
JOIN_TIMEOUT_S = 120.0
ATOL = 2e-6  # one rounding of the dequantize, see above


def _collective_inputs():
    rng = np.random.default_rng(0)
    return {"ag": rng.normal(size=(W, 1024)).astype(np.float32),
            "rs": rng.normal(size=(W, 1024)).astype(np.float32),
            "resid": rng.normal(size=(W, 1024)).astype(np.float32) * 0.01,
            "a2a": rng.normal(size=(W, 8, 4, 256)).astype(np.float32)}


def _world1_engine():
    model, _ = gpt.build(gpt.GPTConfig(**workers.TINY))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=workers.CONFIG,
                                                device="cpu", seed=0)
    return engine


def _batches():
    return [{"input_ids": np.random.default_rng(10 + s).integers(
        0, workers.TINY["vocab_size"], (4, 32), dtype=np.int32)} for s in range(3)]


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """Both ranks' results ({name: array} per rank) and the world-1 run's."""
    tmp = tmp_path_factory.mktemp("zero3_dist")
    engine = _world1_engine()
    state0 = bridge.train_state_to_numpy(engine.state)
    inputs = {"collectives": _collective_inputs(), "state": state0, "batches": _batches()}
    ctx = mp.start_processes(workers.rank_main,
                             args=(W, str(tmp / "init"), str(tmp), inputs),
                             nprocs=W, join=False, start_method="spawn")
    end = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(0.1, end - time.monotonic())):
        if time.monotonic() >= end:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the 2-rank run did not finish within {JOIN_TIMEOUT_S} s")
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(W)]
    world1 = {"layer0": workers.first_layer(engine)}
    world1["losses"], world1["grad_norms"] = workers.train(engine, inputs["batches"])
    world1["final"] = bridge.train_state_to_numpy(engine.state)
    world1["ckpt"] = tmp / "ckpt"
    return ranks, world1


def _jax_per_rank(body, *arrays, out_specs=P("dp", None)):
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("dp",))
    in_specs = tuple(P("dp", *([None] * (a.ndim - 1))) for a in arrays)
    return jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs))(
        *(jnp.asarray(a) for a in arrays))


def test_qall_gather_matches_jax(dist_run):
    ranks, _ = dist_run
    xs = _collective_inputs()["ag"]
    ref = np.asarray(_jax_per_rank(lambda x: jq.qall_gather(x[0], "dp")[None], xs))
    for r in range(W):
        np.testing.assert_allclose(ranks[r]["qall_gather"], ref[r], rtol=0, atol=ATOL)


@pytest.mark.parametrize("mean", [False, True])
def test_qreduce_scatter_matches_jax(dist_run, mean):
    ranks, _ = dist_run
    xs = _collective_inputs()["rs"]
    ref = np.asarray(_jax_per_rank(
        lambda x: jq.qreduce_scatter(x[0], "dp", mean=mean)[None], xs))
    for r in range(W):
        np.testing.assert_allclose(ranks[r][f"qreduce_scatter_mean{int(mean)}"], ref[r],
                                   rtol=0, atol=ATOL)


def test_qreduce_scatter_with_residual_matches_jax(dist_run):
    ranks, _ = dist_run
    ins = _collective_inputs()

    def body(x, res):
        o, nr = jq.qreduce_scatter(x[0], "dp", residual=res[0], bits=4, block_size=64)
        return o[None], nr[None]

    out, new_resid = _jax_per_rank(body, ins["rs"], ins["resid"],
                                   out_specs=(P("dp", None), P("dp", None)))
    for r in range(W):
        np.testing.assert_allclose(ranks[r]["qreduce_scatter_resid"], np.asarray(out)[r],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(ranks[r]["qreduce_scatter_new_resid"],
                                   np.asarray(new_resid)[r], rtol=0, atol=ATOL)


def test_qall_to_all_and_the_facade_match(dist_run):
    ranks, _ = dist_run
    ins = _collective_inputs()
    ref = np.asarray(_jax_per_rank(
        lambda x: jq.qall_to_all(x[0], "dp", split_axis=0, concat_axis=1)[None], ins["a2a"],
        out_specs=P("dp", None, None, None)))
    for r in range(W):
        np.testing.assert_allclose(ranks[r]["qall_to_all"], ref[r], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(ranks[r]["broadcast"], ins["ag"][1])
        np.testing.assert_array_equal(ranks[r]["all_reduce_max"], ins["ag"].max(0))


def test_dp2_gathers_the_world1_layer_bitwise(dist_run):
    ranks, world1 = dist_run
    for r in range(W):
        assert int(ranks[r]["qkv_w_slice_rows"]) == workers.TINY["d_model"] // W
        for k, v in world1["layer0"].items():
            np.testing.assert_array_equal(ranks[r][f"layer0.{k}"], v, err_msg=k)
        assert float(ranks[r]["wire_ratio_qgather"]) > 3.0
        assert int(ranks[r]["reduce_scatter_calls"]) > 0


def test_dp2_trajectory_and_state_match_world1(dist_run):
    ranks, world1 = dist_run
    for r in range(W):
        np.testing.assert_allclose(ranks[r]["losses"], world1["losses"], rtol=1e-5)
        np.testing.assert_allclose(ranks[r]["grad_norms"], world1["grad_norms"], rtol=1e-4)
        final = world1["final"]
        for k, v in final["params"].items():
            if k != "blocks":
                np.testing.assert_allclose(ranks[r][f"final.{k}"], v, rtol=0, atol=2e-5)
        np.testing.assert_allclose(ranks[r]["final.blocks.qkv_w"],
                                   final["params"]["blocks"]["qkv_w"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(ranks[r]["final.opt.mu.wte"], final["opt"].mu["wte"],
                                   rtol=0, atol=2e-5)


def _tag_leaves(tag_dir):
    directory = os.path.join(tag_dir, "state")
    return {m["key"]: np.load(os.path.join(directory, "arrays", f"{m['index']}.npy"))
            for m in serialization.read_meta(directory)["leaves"]}


def test_dp2_tag_holds_the_world1_state_bitwise(dist_run):
    _, world1 = dist_run
    stored = _tag_leaves(world1["ckpt"] / "init")
    state0 = bridge.train_state_to_numpy(_world1_engine().state)
    want = dict(serialization.flatten_with_paths(state0))
    assert list(stored) == list(want)
    for k, v in want.items():
        assert stored[k].dtype == v.dtype and stored[k].tobytes() == v.tobytes(), k
    meta = json.loads((world1["ckpt"] / "init" / "meta.json").read_text())
    assert meta["world_size"] == 2 and meta["partition"]["global_batch"] == 4
    final = _tag_leaves(world1["ckpt"] / "global_step3")
    np.testing.assert_allclose(final["params/blocks/qkv_w"],
                               world1["final"]["params"]["blocks"]["qkv_w"], rtol=0, atol=2e-5)


def test_dp2_reload_gives_each_rank_its_slices_bitwise(dist_run):
    ranks, _ = dist_run
    for r in range(W):
        assert ranks[r]["reload_slices_bitwise"] == 1
        assert ranks[r]["reload_layer0_bitwise"] == 1


def test_world1_refuses_the_dp2_tag(dist_run):
    _, world1 = dist_run
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9b"):
        _world1_engine().load_checkpoint(str(world1["ckpt"]))
