"""The 1-bit optimizers across two ranks: two processes on gloo, started once
for the module with the ``spawn`` method (the rank side,
``_torch_onebit_workers.py``, imports no JAX); the JAX results are computed
here, on a 2-device mesh, while the ranks run. fp32, the linear probe (the
same gradients in both packages), 5 steps across ``freeze_step`` 2.

- The compressed allreduce at world 2 against the JAX body: every rank's
  result and residuals within 1e-6 of the scale, the result the same on
  both ranks bitwise.
- 1-bit Adam at stages 0 and 1 (gas 2 at stage 1), 1-bit LAMB at stage 1,
  0/1 Adam at stage 1 and at stage 0 with gas 2, against the JAX engine at
  dp2: losses 1e-5 absolute, grad norms 1e-5 relative, every state leaf
  (params, moments, the residuals joined into the reference's [W, Np]) 2e-5
  absolute after every step; the two ranks' parameters bitwise equal after
  every step; at stage 1 a rank keeps half of the moments (0.512 with the
  small leaves the policy keeps whole).
- The GPT (``tiny``) at dp2 against world 1: the probe's curvature (each
  rank's HVP averaged over the ranks) within 1e-4; MoQ + pruning at stage
  3 (the planned leaves gathered whole for the transform), losses 1e-5.
- Tags: the ranks' dp2 tag (1-bit Adam, stage 1, saved after step 3) loads
  into the JAX engine at dp2 and goes on to the ranks' steps 4-5 (the bars
  above), and loads at world 1 with the residuals reset to zeros of the new
  shape ([1, Np] padded to 8, not 16) and every other leaf bitwise.
"""

import os
import time

import numpy as np
import pytest
import torch.multiprocessing as mp

import _torch_onebit_ref as ref
import _torch_onebit_workers as workers
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths

W = 2
JOIN_TIMEOUT_S = 180.0
STATE_ATOL, LOSS_ATOL, NORM_RTOL = 2e-5, 1e-5, 1e-5


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("onebit_dist")
    inputs = {"compressed": ref.compressed_inputs(W)}
    ctx = mp.start_processes(workers.rank_main, args=(W, str(tmp / "init"), str(tmp), inputs),
                             nprocs=W, join=False, start_method="spawn")
    try:
        runs = {"compressed": ref.jax_compressed(*inputs["compressed"])}
        for name, (_, _, gas) in workers.DIST_CASES.items():
            runs[name] = ref.jax_run(ref.jax_engine(workers.dist_config(name), W=W),
                                     [workers.batch(g) for g in workers.grads(W, gas)])
    finally:
        end = time.monotonic() + JOIN_TIMEOUT_S
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            if time.monotonic() >= end:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the 2-rank run did not finish within {JOIN_TIMEOUT_S} s")
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(W)]
    return ranks, runs, tmp


def _rank_run(rank, name):
    states = []
    for s in range(workers.STEPS):
        prefix = f"{name}.s{s}."
        states.append({k[len(prefix):]: v for k, v in rank.items() if k.startswith(prefix)})
    return {"losses": rank[f"{name}.losses"], "norms": rank[f"{name}.norms"], "states": states}


def _assert_close(got, want, what, first_step=1):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=LOSS_ATOL,
                               err_msg=f"{what} losses")
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=NORM_RTOL,
                               err_msg=f"{what} grad norms")
    assert len(got["states"]) == len(want["states"])
    for s, (g, w) in enumerate(zip(got["states"], want["states"])):
        assert set(g) == set(w), (what, set(g) ^ set(w))
        for k in w:
            diff = np.abs(np.asarray(g[k], np.float32) - w[k])
            assert diff.max() <= STATE_ATOL, f"{what} step {first_step + s} {k}: {diff.max():.3g}"


@pytest.mark.parametrize("name", list(workers.GPT_CASES))
def test_gpt_at_dp2_is_the_world_1_run(dist_run, name):
    """The probe at dp2 (each rank's HVP averaged over the ranks) gives the
    world-1 curvature of the whole batch (1e-4); compression at stage 3
    (each planned leaf gathered whole before the transform) gives the
    world-1 losses (1e-5 relative)."""
    ranks, _, _ = dist_run
    losses, curv = workers.gpt_run(name, world=1)
    for r in range(W):
        np.testing.assert_allclose(ranks[r][f"{name}.losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(ranks[r][f"{name}.curvature"], curv, rtol=0, atol=1e-4)
    if name == "probe":
        assert curv.max() == 1.0


def test_compressed_allreduce_at_world_2_matches_jax(dist_run):
    ranks, runs, _ = dist_run
    x, werr, _ = ref.compressed_inputs(W)
    for r in range(W):
        buf = x[r] + werr[r]
        scale = float(np.linalg.norm(buf) / np.sqrt(buf.size))
        for i, key in enumerate(("result", "worker_error", "server_error")):
            np.testing.assert_allclose(ranks[r][f"compressed.{key}"], runs["compressed"][i][r],
                                       rtol=0, atol=1e-6 * scale, err_msg=key)
    np.testing.assert_array_equal(ranks[0]["compressed.result"], ranks[1]["compressed.result"])


@pytest.mark.parametrize("name", list(workers.DIST_CASES))
def test_dp2_matches_jax_and_the_ranks_agree(dist_run, name):
    ranks, runs, _ = dist_run
    for r in range(W):
        _assert_close(_rank_run(ranks[r], name), runs[name], f"{name} rank {r}")
    for s in range(workers.STEPS):
        for k in ranks[0]:
            if k.startswith(f"{name}.s{s}.params/"):
                np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    rows = [ranks[r][f"{name}.row"] for r in range(W)]
    assert rows[0].shape == (1, 4736) and not np.array_equal(rows[0], rows[1])  # 4725 -> 16
    kept = [int(ranks[r][f"{name}.opt_elems"]) / workers.n_elems() for r in range(W)]
    if workers.DIST_CASES[name][1] == 0:
        assert kept == [1.0, 1.0]
    else:  # the policy keeps the smallest leaves whole
        assert all(0.5 <= k < 0.52 for k in kept), kept


@pytest.fixture(scope="module")
def tag_runs(dist_run):
    """The ranks' dp2 tag in the JAX engine at dp2 (steps 4-5) and in the
    port at world 1."""
    _, _, tmp = dist_run
    name, at = workers.TAG_CASE, workers.SAVE_AT
    batches = [workers.batch(g) for g in workers.grads(W, workers.DIST_CASES[name][2])]
    je = ref.jax_engine(workers.dist_config(name), W=W)
    je.load_checkpoint(str(tmp / "tag"))
    jax_after = ref.jax_run(je, batches[at:])
    w1 = workers.make_engine(workers.dist_config(name, world=1))
    w1.load_checkpoint(str(tmp / "tag"))
    return jax_after, w1


def test_dp2_tag_resumes_in_the_jax_engine(dist_run, tag_runs):
    ranks, _, _ = dist_run
    jax_after, _ = tag_runs
    got = {k: v[workers.SAVE_AT:] for k, v in _rank_run(ranks[0], workers.TAG_CASE).items()}
    _assert_close(got, jax_after, "the dp2 tag in JAX", first_step=workers.SAVE_AT + 1)


def test_dp2_tag_at_world_1_resets_the_residuals(dist_run, tag_runs):
    ranks, _, _ = dist_run
    _, w1 = tag_runs
    assert w1.global_steps == workers.SAVE_AT and w1.world_size == 1
    state = dict(flatten_with_paths(bridge.train_state_to_numpy(w1.state)))
    assert state["onebit/worker_error"].shape == (1, 4728)
    assert state["onebit/server_error"].shape == (1, 4728)
    assert not state["onebit/worker_error"].any() and not state["onebit/server_error"].any()
    saved = {k.split(".", 2)[2]: v for k, v in ranks[0].items()
             if k.startswith(f"{workers.TAG_CASE}.s{workers.SAVE_AT - 1}.")}
    for k, v in state.items():
        if not k.startswith("onebit/"):
            np.testing.assert_array_equal(np.asarray(v, np.float32), saved[k], err_msg=k)
    batches = [workers.batch(g) for g in workers.grads(1, workers.DIST_CASES[workers.TAG_CASE][2])]
    after = workers.run(w1, batches[workers.SAVE_AT:])
    assert np.isfinite(after["losses"]).all() and after["states"][-1]["onebit/worker_error"].any()
