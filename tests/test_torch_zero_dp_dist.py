"""Data parallelism below stage 3, the ZeRO++ quantized gradient exchange
and reshard-on-load across two ranks: two processes on gloo, started once
for the module with the ``spawn`` method (the rank side,
``_torch_zero_dp_workers.py``, imports no JAX); the JAX results are
computed here, on a 2-device mesh, while the ranks run. fp32, the ``tiny``
GPT, global batch 4 (2 rows a rank), 3 steps of AdamW + clipping from the
JAX engine's start state.

- The exchanges (``grad_bucket_reduce``, ``qreduce_scatter`` +
  ``qall_gather``) give each rank bitwise the payload JAX's quantizer makes
  of its buffer and the values JAX's functions give that rank, within 2e-6
  (the FMA under ``jit``), with and without a residual, at a loss scale of
  2^10.
- Stages 0, 1 and 2 against one JAX dp2 run (its stage only places the
  same values): losses 1e-5 relative, grad norms 1e-4 (the two ranks'
  rows are summed in another order), the final params 2e-5; the two ranks'
  parameters are bitwise equal after every step; at stages 1-2 each rank's
  Adam moments are its slice of JAX's logical leaves (2e-5) and take
  exactly the bytes of their slices (half of every leaf the policy cuts).
- Stage 2 with int8 quantized gradients (monolithic and per-layer buckets,
  with and without error feedback): the bars of ``test_torch_zero_dp.py``
  (step 1's loss 1e-6 and its exchanged gradients within two quantization
  steps of their block; later losses 1e-4, grad norms 1e-3), the residual
  rows nonzero and joined into JAX's shapes, the ledger's counts and
  ratios.
- A ``loss_mask`` with unequal counts on the two ranks: the loss and the
  update are JAX's global masked mean (1e-5 / 1e-4 / 2e-5). LAMB at stage
  2 and at stage 3: JAX's trajectory (the trust ratios over the logical
  leaves). fp16 with an inf in one rank's slice only: both ranks skip.
- Reshard-on-load: the ranks' stage-2 qgrad + EF tag loads at world 1
  (logical leaves bitwise, residuals zero at the world-1 shape, the cursor
  kept at the same global batch, rescaled at half of it, refused where it
  would split one; the engine trains on) and at dp2 (bitwise, residuals
  verbatim); a mid-accumulation tag drops its window at world 1 and keeps
  it at dp2; the world-1 tag written here gives each rank bitwise its
  slices; a JAX tag written at dp2 loads into the port at world 1, and the
  ranks' tag into the JAX engine at dp1.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax

import _torch_zero_dp_workers as workers
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.checkpoint import serialization
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.policy import ZeroShardingPolicy
from deepspeed_tpu_torch.runtime.zero.reshard import ReshardError
from _torch_zero_dp_ref import (
    ATOL,
    QCASES,
    exchanged_within_a_step,
    expected_payloads,
    jax_engine,
    jax_exchanged_grads,
    jax_exchanges,
    jax_run,
)

W = 2
JOIN_TIMEOUT_S = 180.0


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """Both ranks' results ({name: array} per rank), the JAX runs and the
    tags' directory."""
    tmp = tmp_path_factory.mktemp("zero_dp_dist")
    dense = jax_engine("s2", W=W)
    state0 = jax.tree_util.tree_map(np.asarray, dense.state)
    # the world-1 tag the ranks load: one qgrad + EF step from the same start
    w1 = workers.make_engine(workers.config(workers.CASES["q_bucket_ef"][0]), state0)
    w1.train_batch(workers.batches("s2")[0])
    w1.save_checkpoint(str(tmp / "world1"))
    inputs = {"exchange": workers.exchange_inputs(), "state0": state0}
    ctx = mp.start_processes(workers.rank_main, args=(W, str(tmp / "init"), str(tmp), inputs),
                             nprocs=W, join=False, start_method="spawn")
    try:
        runs = {"s2": jax_run(dense, "s2"), "grad1": {}}
        for name in QCASES + ("mask", "lamb2"):
            je = jax_engine(name, W=W)
            if name.endswith("_ef"):  # step 1's residual is zero: the same exchange
                runs["grad1"][name] = runs["grad1"][name[:-3]] = jax_exchanged_grads(
                    je, workers.batches(name)[0])
            runs[name] = jax_run(je, name)
            if name == "q_bucket_ef":
                je.save_checkpoint(str(tmp / "jaxtag"))
        runs["exchange"] = jax_exchanges(inputs["exchange"], W)
    finally:
        end = time.monotonic() + JOIN_TIMEOUT_S
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            if time.monotonic() >= end:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the 2-rank run did not finish within {JOIN_TIMEOUT_S} s")
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(W)]
    return ranks, runs, tmp, state0


def _policy(zero, rank):
    return ZeroShardingPolicy(DeepSpeedZeroConfig.from_dict(zero), W, rank)


def _named(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_named(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _slices(zero, rank, tree, kind="opt"):
    """{key: this rank's slice} of a full numpy parameter tree under ``zero``."""
    pol = _policy(zero, rank)
    specs = _named(getattr(pol, f"tree_{kind}_specs")(tree))
    return {k: pol.shard(v, specs[k]) for k, v in _named(tree).items()}


def test_exchanges_at_dp2_match_jax(dist_run):
    ranks, runs, _, _ = dist_run
    ins = workers.exchange_inputs()
    for r in range(W):
        for k, v in runs["exchange"].items():
            np.testing.assert_allclose(ranks[r][k], v[r], rtol=0, atol=ATOL, err_msg=k)
        for k, v in expected_payloads(ins, W, r).items():
            np.testing.assert_array_equal(ranks[r][k], v, err_msg=k)


def _check_ranks_agree(ranks, name):
    if workers.CASES[name][0]["stage"] < 3:  # stage 3 keeps slices of the params
        np.testing.assert_array_equal(ranks[0][f"{name}.digests"], ranks[1][f"{name}.digests"])
    for key in ("losses", "grad_norms"):
        np.testing.assert_array_equal(ranks[0][f"{name}.{key}"], ranks[1][f"{name}.{key}"])


def _check_trajectory(ranks, run, name, loss_rtol=1e-5, norm_rtol=1e-4, atol=2e-5):
    losses, norms, final = run
    zero = workers.CASES[name][0]
    for r in range(W):
        np.testing.assert_allclose(ranks[r][f"{name}.losses"], losses, rtol=loss_rtol)
        np.testing.assert_allclose(ranks[r][f"{name}.grad_norms"], norms, rtol=norm_rtol)
        for k, v in _named(final["params"]).items():
            np.testing.assert_allclose(ranks[r][f"{name}.full.params/{k}"], v, rtol=0, atol=atol,
                                       err_msg=k)
        for k, v in _slices(zero, r, final["opt"].mu).items():
            np.testing.assert_allclose(ranks[r][f"{name}.local.mu.{k}"], v, rtol=0, atol=atol,
                                       err_msg=k)
    _check_ranks_agree(ranks, name)


@pytest.mark.parametrize("name", ["s0", "s1", "s2"])
def test_dense_stages_match_jax_and_the_ranks_agree(dist_run, name):
    ranks, runs, _, _ = dist_run
    _check_trajectory(ranks, runs["s2"], name)
    mu = runs["s2"][2]["opt"].mu
    for r in range(W):
        want = 2 * 4 * sum(v.size for v in _slices(workers.CASES[name][0], r, mu).values())
        assert int(ranks[r][f"{name}.opt_bytes"]) == want
    full = 2 * 4 * sum(v.size for v in _named(mu).values())
    if name == "s0":
        assert int(ranks[0]["s0.opt_bytes"]) == full
    else:
        assert int(ranks[0][f"{name}.opt_bytes"]) < 0.51 * full


@pytest.mark.parametrize("name", QCASES)
def test_quantized_gradients_at_dp2_match_jax(dist_run, name):
    ranks, runs, _, _ = dist_run
    losses, norms, final = runs[name]
    for r in range(W):
        got = ranks[r][f"{name}.losses"]
        np.testing.assert_allclose(got[0], losses[0], rtol=1e-6)
        np.testing.assert_allclose(got[1:], losses[1:], rtol=1e-4)
        np.testing.assert_allclose(ranks[r][f"{name}.grad_norms"], norms, rtol=1e-3)
        exchanged_within_a_step({k: ranks[r][f"{name}.grad1.{k}"] for k in runs["grad1"][name]},
                                runs["grad1"][name])
        bucketed = name.startswith("q_bucket")
        want = {"qgrad_reduce_scatter[dp]": 3, "qgrad_all_gather[dp]": 3}
        if bucketed:
            L = workers.TINY["n_layer"]
            want.update({"qgrad_bucket_rs[dp]": 3 * L, "qgrad_bucket_ag[dp]": 3 * L})
        ledger = {k.split(".ledger.")[1]: v for k, v in ranks[r].items()
                  if k.startswith(f"{name}.ledger.")}
        assert {k: int(v[0]) for k, v in ledger.items()} == want
        assert all(v[1] >= 3.5 for v in ledger.values()), ledger
        for key in ("qgrad_residual", "qgrad_bucket_residual"):
            if f"{name}.{key}" in ranks[r]:
                row = ranks[r][f"{name}.{key}"]
                assert np.abs(row).max() > 0
                assert ranks[r][f"{name}.{key}.full"].shape == final[key].shape
                assert row.shape[-2 if key == "qgrad_bucket_residual" else 0] == 1
    _check_ranks_agree(ranks, name)


def test_loss_mask_across_ranks_is_the_global_masked_mean(dist_run):
    ranks, runs, _, _ = dist_run
    masks = [b["loss_mask"] for b in workers.batches("mask")]
    counts = [[int(m[r * 2:(r + 1) * 2, 1:].sum()) for r in range(W)] for m in masks]
    assert all(a != b for a, b in counts)  # unequal counts on the two ranks
    _check_trajectory(ranks, runs["mask"], "mask")


@pytest.mark.parametrize("name", ["lamb2", "lamb3"])
def test_lamb_across_ranks_matches_jax(dist_run, name):
    ranks, runs, _, _ = dist_run
    _check_trajectory(ranks, runs["lamb2"], name)


def test_fp16_overflow_on_one_rank_skips_both(dist_run):
    ranks, _, _, _ = dist_run
    for r in range(W):
        assert ranks[r]["fp16.overflow"] == 1 and ranks[r]["fp16.skipped"] == 1
        assert ranks[r]["fp16.unchanged"] and ranks[r]["fp16.next_overflow"] == 0


def _stored(tag_dir):
    directory = os.path.join(tag_dir, "state")
    return {m["key"]: np.load(os.path.join(directory, "arrays", f"{m['index']}.npy"))
            for m in serialization.read_meta(directory)["leaves"]}


def _port_leaves(engine):
    return dict(serialization.flatten_with_paths(bridge.train_state_to_numpy(engine.state)))


def test_dp2_tag_loads_at_world1_and_at_dp2(dist_run):
    ranks, _, tmp, _ = dist_run
    ckpt = tmp / "ckpt"
    meta = json.loads((ckpt / "global_step3" / "meta.json").read_text())
    assert meta["world_size"] == 2 and meta["partition"]["global_batch"] == 4
    stored = _stored(ckpt / "global_step3")
    e = workers.make_engine(workers.config(workers.CASES["q_bucket_ef"][0]), seed=5)
    e.load_checkpoint(str(ckpt))
    assert e.global_steps == 3 and e.data_cursor == 3
    for k, v in _port_leaves(e).items():
        if k.startswith("qgrad"):  # reset at the world-1 decomposition
            assert stored[k].shape[-2 if "bucket" in k else 0] == 2
            assert v.shape == tuple(e.state[k].shape) and not v.any(), k
        else:
            assert v.tobytes() == stored[k].tobytes(), k
    m = e.train_batch(workers.batches("s2")[0])
    assert np.isfinite(float(m["loss"])) and e.data_cursor == 4
    # at dp2 the ranks loaded every slice and residual row verbatim, and train on
    for r in range(W):
        assert ranks[r]["reload_bitwise"] and np.isfinite(ranks[r]["reload_next_loss"])


def test_dp2_tag_cursor_rescaled_or_refused(dist_run):
    _, _, tmp, _ = dist_run
    ckpt = str(tmp / "ckpt")
    zero = workers.CASES["q_bucket_ef"][0]
    half = workers.make_engine(workers.config(zero, micro=2))  # global batch 2
    half.load_checkpoint(ckpt)
    assert half.data_cursor == 6 and half.global_steps == 3
    e = workers.make_engine(workers.config(zero, micro=8))  # 12 samples: not a batch of 8
    before = {k: v.copy() for k, v in _port_leaves(e).items()}
    with pytest.raises(ReshardError, match="global-batch boundary"):
        e.load_checkpoint(ckpt)
    assert e.global_steps == 0 and e.data_cursor == 0
    assert all(v.tobytes() == before[k].tobytes() for k, v in _port_leaves(e).items())


def test_mid_accumulation_tag_rewinds_at_another_world(dist_run):
    ranks, _, tmp, _ = dist_run
    e = workers.make_engine(workers.config({"stage": 2}, micro=2, gas=2))
    e.load_checkpoint(str(tmp / "ckpt" / "mid"), tag="mid")
    assert e._grad_acc is None and int(e.state["micro"]) == 0 and e._micro == 0
    assert e.data_cursor == 1 and e.global_steps == 1
    for r in range(W):  # the same world keeps the window
        assert ranks[r]["mid_same_world_acc"] and ranks[r]["mid_same_world_micro"] == 1


def test_world1_tag_gives_each_rank_its_slices(dist_run):
    ranks, _, tmp, _ = dist_run
    stored = _stored(tmp / "world1" / "global_step1")
    zero = workers.CASES["q_bucket_ef"][0]
    params = {k[len("params/"):]: v for k, v in stored.items() if k.startswith("params/")}
    mu = {k[len("opt/mu/"):]: v for k, v in stored.items() if k.startswith("opt/mu/")}

    def tree(flat):
        out = {}
        for k, v in flat.items():
            *path, leaf = k.split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return out

    for r in range(W):
        for k, v in _slices(zero, r, tree(params), "param").items():
            assert ranks[r][f"w1load.params/{k}"].tobytes() == v.tobytes(), k
        for k, v in _slices(zero, r, tree(mu)).items():
            assert ranks[r][f"w1load.mu/{k}"].tobytes() == v.tobytes(), k
        assert ranks[r]["w1load.resid_zero"] and ranks[r]["w1load.cursor"] == 1


def test_tags_cross_with_the_jax_engine_across_worlds(dist_run):
    """A JAX tag written at dp2 loads into the port at world 1; the ranks'
    dp2 tag loads into the JAX engine at dp1 (both reshard the residuals)."""
    _, _, tmp, _ = dist_run
    jstored = _stored(next((tmp / "jaxtag").glob("global_step*")))
    e = workers.make_engine(workers.config(workers.CASES["q_bucket_ef"][0]), seed=5)
    e.load_checkpoint(str(tmp / "jaxtag"))
    assert e.global_steps == 3
    for k, v in _port_leaves(e).items():
        if k.startswith("qgrad"):
            assert not v.any() and v.shape[-2 if "bucket" in k else 0] == 1, k
        else:
            assert v.tobytes() == np.ascontiguousarray(jstored[k]).tobytes(), k
    je = jax_engine("q_bucket_ef", W=1)
    je.load_checkpoint(str(tmp / "ckpt"))
    assert je.global_steps == 3
    stored = _stored(tmp / "ckpt" / "global_step3")
    got = dict(serialization.flatten_with_paths(jax.tree_util.tree_map(np.asarray, je.state)))
    for k, v in got.items():
        if k.startswith("qgrad"):
            assert not np.asarray(v).any(), k
        else:
            assert np.asarray(v).tobytes() == stored[k].tobytes(), k
