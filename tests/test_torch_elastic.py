"""The port's elasticity against the JAX package's: the compatible-batch
computation on a grid of blocks and world sizes; the agent's crash-loop
quarantine and its budget-free preempted exit (trivial worker commands);
and the agent supervising two gloo ranks of the port on the CPU that lose
one (``lose_worker_at_step``): it relaunches at world size 1 from the
newest committed tag (reshard-on-load), and the losses of the resumed steps
equal an uninterrupted world-1 run's within the fp32 bar of the
data-parallel parity tests (rtol 1e-5; the two ranks' reduction order is
the only difference)."""

import json
import os
import sys

import numpy as np

from deepspeed_tpu import elasticity as jel
from deepspeed_tpu_torch import elasticity as tel
from deepspeed_tpu_torch.elasticity.elastic_agent import DSElasticAgent, WorkerSpec
from deepspeed_tpu_torch.resilience import (PREEMPTED_EXIT_CODE, commit_tag, is_committed,
                                            read_events, read_latest, write_latest)

sys.path.insert(0, os.path.dirname(__file__))
import _torch_elastic_worker as worker  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "_torch_elastic_worker.py")
ELASTIC = {"elasticity": {"enabled": True, "max_train_batch_size": 16,
                          "micro_batch_sizes": [2, 4], "min_world_size": 1,
                          "max_world_size": 4}}


def _outcome(fn):
    try:
        return fn()
    except Exception as e:
        return type(e).__name__


def test_elastic_batch_math_equals_the_references():
    rng = np.random.default_rng(0)
    for _ in range(40):
        micro = sorted({int(m) for m in rng.integers(1, 9, int(rng.integers(1, 4)))})
        block = {"enabled": True, "max_train_batch_size": int(rng.integers(4, 200)),
                 "micro_batch_sizes": micro, "min_world_size": int(rng.integers(1, 3)),
                 "max_world_size": int(rng.integers(3, 12)),
                 "prefer_larger_batch": bool(rng.integers(0, 2))}
        cfg = {"elasticity": block}
        assert _outcome(lambda: tel.elastic_ladder(cfg)) == _outcome(
            lambda: jel.elastic_ladder(cfg))
        for world in range(0, 6):
            assert _outcome(lambda: tel.compute_elastic_config(cfg, world)) == _outcome(
                lambda: jel.compute_elastic_config(cfg, world))
        assert tel.get_candidate_batch_sizes(micro, block["max_train_batch_size"]) == \
            jel.get_candidate_batch_sizes(micro, block["max_train_batch_size"])
    for bad in ({"enabled": True, "micro_batch_sizes": []}, {"nope": 1},
                {"enabled": True, "min_world_size": 3, "max_world_size": 2}):
        assert _outcome(lambda: tel.validate_elasticity_block(bad)) == "ElasticityError"


def _fake_committed(ckpt, tags):
    for i, t in enumerate(tags):
        os.makedirs(os.path.join(ckpt, t, "state"))
        with open(os.path.join(ckpt, t, "state", "state.msgpack"), "wb") as f:
            f.write(bytes([i]) * 64)
        commit_tag(os.path.join(ckpt, t))
    write_latest(ckpt, tags[-1])


def test_crash_loop_quarantines_the_poisoned_tag(tmp_path):
    """Crashes while ``latest`` stays on one tag quarantine it; the next
    resume falls back to the previous committed tag."""
    ckpt = str(tmp_path / "ckpt")
    _fake_committed(ckpt, ["global_step1", "global_step2"])
    agent = DSElasticAgent(lambda s: [sys.executable, "-c", "import sys; sys.exit(3)"],
                           ELASTIC, device_count_fn=lambda: 4, max_restarts=3,
                           poll_interval=0.05, checkpoint_dir=ckpt, crash_loop_threshold=2,
                           backoff_base=0.01, backoff_max=0.05)
    result = agent.run()
    assert (result.state, result.quarantined) == ("FAILED", ["global_step2"])
    assert read_latest(ckpt) == "global_step1" and not is_committed(
        os.path.join(ckpt, "global_step2"))
    assert {"worker_restart", "tag_quarantined"} <= {e["event"] for e in read_events(ckpt)}


def test_preempted_exit_spends_no_restart_budget(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    marker = tmp_path / "first"
    script = (f"import os, sys\np = {str(marker)!r}\nif not os.path.exists(p):\n"
              f"    open(p, 'w').write('x'); sys.exit({PREEMPTED_EXIT_CODE})\nsys.exit(0)\n")
    agent = DSElasticAgent(lambda s: [sys.executable, "-c", script], ELASTIC,
                           device_count_fn=lambda: 4, max_restarts=0, poll_interval=0.05,
                           checkpoint_dir=str(ckpt))
    result = agent.run()
    assert (result.state, result.restarts, result.preemptions) == ("SUCCEEDED", 0, 1)
    assert [e["event"] for e in read_events(str(ckpt))] == ["preemption_restart"]
    assert agent.resolve(3).world_size == 2 and agent.resolve(4).gas == 1


def test_agent_relaunches_at_world_1_after_losing_a_gloo_rank(tmp_path):
    """Two gloo ranks train with a committed tag each step; rank 1 is lost
    at cursor 2 (SIGKILL); the agent, told the device count is now 1,
    relaunches (budget-free, a membership change) at world 1 from
    ``global_step2``, resharded from 2 ranks, and the run finishes at 5
    steps, its resumed losses the uninterrupted world-1 run's."""
    ckpt, log, world_file = tmp_path / "ckpt", tmp_path / "log.jsonl", tmp_path / "world"
    world_file.write_text("2")
    steps = 5
    env_plan = json.dumps({"lose_worker_at_step": 2})

    def make_cmd(spec: WorkerSpec):
        return [sys.executable, WORKER, "--ckpt-dir", str(ckpt), "--log", str(log),
                "--steps", str(steps), "--world", str(spec.world_size),
                "--world-file", str(world_file), "--fault-ranks", "1"]

    old = os.environ.get("DS_FAULT_PLAN")
    os.environ["DS_FAULT_PLAN"] = env_plan
    try:
        agent = DSElasticAgent(make_cmd, {"elasticity": worker.ELASTICITY},
                               device_count_fn=lambda: int(world_file.read_text()),
                               max_restarts=1, poll_interval=0.2,
                               checkpoint_dir=str(ckpt), backoff_base=0.01)
        result = agent.run()
    finally:
        os.environ.pop("DS_FAULT_PLAN", None) if old is None else \
            os.environ.__setitem__("DS_FAULT_PLAN", old)
    assert result.state == "SUCCEEDED"
    assert (result.restarts, result.membership_changes) == (0, 1)
    assert [(s.world_size, s.micro_batch, s.gas) for s in result.history] == [(2, 4, 1),
                                                                             (1, 4, 2)]
    records = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [(r["step"], r["world"]) for r in records] == [(1, 2), (2, 2), (3, 1), (4, 1),
                                                          (5, 1)]
    events = [e["event"] for e in read_events(str(ckpt))]
    assert "membership_change" in events and "reshard_applied" in events
    assert "sdc_suspect" not in events  # the ranks' spot-check fingerprints agreed

    ref = worker.train(worker.build(tmp_path / "ref"), steps)
    for r in records:
        assert abs(r["loss"] - ref[r["step"]]) <= 1e-5 * abs(ref[r["step"]]), (r, ref)
