"""The port's in-run health against the JAX package's: the spike detector and
the straggler policy on a grid; a NaN injected at a data cursor (both
engines start from the same state, the port resuming the JAX engine's tag)
rolls back to the same tag, skips the same cursors and leaves the same event
trail, and the losses of every executed step agree within the fp32 bars of
``test_torch_engine.py`` (rtol 1e-5); forced quantized-gradient overflows
demote and re-promote the wire at the same steps; the in-memory anchor
restores bitwise; the rollback budget; the watchdog's stall -> emergency
save; the checkpoint-I/O degradation; the imperative path's poison skip."""

import os
import sys
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu.resilience as jres
import deepspeed_tpu_torch
import deepspeed_tpu_torch.resilience as tres
from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.utils.tree import tree_leaves

sys.path.insert(0, os.path.dirname(__file__))
from _torch_health_pair import (TINY, _config, assert_same_run, batch_for, drive,  # noqa: E402
                                engines, trail)


@pytest.fixture(autouse=True)
def _no_plans():
    tres.install_plan(None)
    jres.install_plan(None)
    yield
    tres.install_plan(None)
    jres.install_plan(None)


# -------------------------------------------------------------- pure policies
def test_spike_detector_and_stragglers_equal_on_a_grid():
    rng = np.random.default_rng(0)
    for zscore, warmup, min_rel in ((6.0, 20, 0.1), (2.0, 3, 0.0), (3.0, 1, 0.5)):
        stream = list(10 + rng.standard_normal(60))
        stream[25], stream[40], stream[41] = 40.0, float("nan"), float("inf")
        a = tres.SpikeDetector(zscore=zscore, warmup=warmup, min_rel=min_rel)
        b = jres.SpikeDetector(zscore=zscore, warmup=warmup, min_rel=min_rel)
        assert [a.update(v) for v in stream] == [b.update(v) for v in stream]
        assert a.state_dict() == b.state_dict()
    for _ in range(50):
        n = int(rng.integers(1, 9))
        durs = list(rng.exponential(5.0, n))
        for factor in (1.5, 2.0, 4.0):
            assert tres.identify_stragglers(durs, factor) == jres.identify_stragglers(durs,
                                                                                      factor)


# ------------------------------------------------------------- NaN -> rollback
def test_nan_rolls_back_to_the_same_tag_and_skips_the_same_cursors(tmp_path):
    """``nan_at_step`` 5 with an anchor every 2 steps: both engines roll back
    to ``global_step4`` and skip cursors 4 and 5 (every batch consumed since
    the tag), with the same recovery events; the run rejoins."""
    res = {"sentinel": {"enabled": True, "warmup_steps": 1, "checkpoint_interval": 2},
           "chaos": {"nan_at_step": 5}}
    jeng, teng = engines(tmp_path, res)
    jrun, trun = drive(jeng, 8), drive(teng, 8)
    assert_same_run(jrun, trun)
    assert trail(tmp_path / "jax") == trail(tmp_path / "port")
    assert teng._health.skipped_cursors == jeng._health.skipped_cursors == [4, 5]
    rb = [e for e in tres.read_events(str(tmp_path / "port"))
          if e["event"] == "divergence_rollback"]
    assert [(e["from_step"], e["step"], e["source"]) for e in rb] == [(6, 4, "disk")]
    assert teng.data_cursor == jeng.data_cursor == 10


def test_memory_anchor_restores_bitwise(tmp_path):
    """With no committed tag the rollback lands on the in-memory anchor (the
    state after auto-resume, a host copy), restored bitwise, and the trail is
    the JAX engine's."""
    res = {"sentinel": {"enabled": True, "warmup_steps": 1}, "chaos": {"nan_at_step": 1}}
    jeng, teng = engines(tmp_path, res)
    for name in ("jax", "port"):  # the init tags: no disk anchor remains
        tag = tmp_path / name / "global_step0"
        if tag.exists():
            (tag / "COMMIT").unlink()
    start = {k: v.clone() for k, v in teng._device_master_units().items()}
    start_params = [p.detach().clone() for p in tree_leaves(
        teng.state["params"])]
    for eng in (jeng, teng):
        eng.train_batch(batch_for(0))
        m = eng.train_batch(batch_for(1))
        assert m["health"]["rolled_back"]["source"] == "memory"
    assert trail(tmp_path / "jax") == trail(tmp_path / "port")
    for k, v in teng._device_master_units().items():
        assert torch.equal(v, start[k]), k
    for a, b in zip(tree_leaves(teng.state["params"]), start_params):
        assert torch.equal(a, b)
    assert (teng.global_steps, teng.data_cursor) == (0, 0)


def test_rollback_budget_exhaustion_raises(tmp_path):
    """A poison the skip cannot clear fails loudly once the budget is spent."""
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    eng = deepspeed_tpu_torch.initialize(model=model, config=_config(tmp_path, {
        "sentinel": {"enabled": True, "warmup_steps": 1, "max_rollbacks": 2,
                     "checkpoint_interval": 1, "skip_poisoned_batches": False}}),
        device="cpu")[0]
    eng.train_batch(batch_for(0))
    tres.install_plan(tres.FaultPlan(nan_at_step=1))
    with pytest.raises(tres.DivergenceError, match="budget"):
        for _ in range(6):
            eng.train_batch(batch_for(eng.data_cursor))
    assert eng._health.rollbacks == 2


# ----------------------------------------------------------- wire demotion
def test_ef_overflow_demotes_and_repromotes_at_the_same_steps(tmp_path):
    """Forced overflows (``ef_overflow_steps`` 2) demote the quantized
    gradient exchange at the same step in both packages; 3 clean steps
    re-promote it with the residuals zeroed; the overflow skips and the
    wire events match."""
    wire_ledger.reset()
    res = {"degraded": {"demote_after": 2, "repromote_after": 3}}
    zero = {"stage": 2, "zero_quantized_gradients": True, "zero_quantize_error_feedback": True}
    jeng, teng = engines(tmp_path, res, zero_optimization=zero)
    runs = []
    for eng, pkg in ((jeng, jres), (teng, tres)):
        eng.train_batch(batch_for(0))
        pkg.install_plan(pkg.FaultPlan(ef_overflow_steps=2))
        run = drive(eng, 3)
        pkg.install_plan(None)
        run += drive(eng, 7)
        runs.append([r[:2] + r[3:] for r in run])
    assert runs[0] == runs[1]
    assert [w for *_, w in runs[1]] == ["step", "demoted", "step", "step", "repromoted",
                                        "step"]
    assert not teng._qgrad_demoted and float(teng.state["qgrad_residual"].abs().max()) > 0
    assert trail(tmp_path / "jax") == trail(tmp_path / "port")
    assert "re-promoted at step 6" in teng.comms_summary()
    wire_ledger.reset()


# ---------------------------------------------------------------- watchdog
def test_stall_escalates_to_an_emergency_save(tmp_path):
    """A collective stall past its deadline is flagged within the deadline,
    dumps the stacks, and escalates through the drain to a committed
    emergency tag and exit 83; a healthy run stays quiet."""
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    eng = deepspeed_tpu_torch.initialize(model=model, config=_config(tmp_path, {
        "watchdog": {"enabled": True, "poll_interval_s": 0.05,
                     "collective_deadline_s": 0.3}}), device="cpu")[0]
    try:
        eng.train_batch(batch_for(0))
        time.sleep(0.2)
        assert eng._watchdog.stall_count == 0
        tres.install_plan(tres.FaultPlan(stall_collective=1.2, stall_collective_at_step=1))
        with pytest.raises(SystemExit) as exit_info:
            eng.train_batch(batch_for(1))
        assert exit_info.value.code == tres.PREEMPTED_EXIT_CODE
        phase, elapsed = eng._watchdog.last_stall
        assert (eng._watchdog.stall_count, phase) == (1, "collective") and elapsed < 1.0
    finally:
        eng._watchdog.stop()
    assert tres.committed_tags(str(tmp_path)) == ["global_step2"]
    events = [e["event"] for e in tres.read_events(str(tmp_path))]
    assert events == ["watchdog_stall", "watchdog_recovered", "emergency_save"]
    stacks = (tmp_path / tres.STACKS_FILENAME).read_text()
    assert "watchdog stall: phase=collective" in stacks and "train_batch" in stacks


def test_checkpoint_io_failure_degrades_to_the_memory_anchor(tmp_path, monkeypatch):
    """A periodic anchor save that fails costs no step: the run goes on with
    the in-memory anchor and records ``checkpoint_io_degraded``."""
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    eng = deepspeed_tpu_torch.initialize(model=model, config=_config(tmp_path, {
        "sentinel": {"enabled": True, "warmup_steps": 1, "checkpoint_interval": 1}}),
        device="cpu")[0]

    def broken(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(eng, "save_checkpoint", broken)
    for c in range(2):
        eng.train_batch(batch_for(c))
    assert eng._health.checkpoint_io_degraded and eng.global_steps == 2
    assert [e["event"] for e in tres.read_events(str(tmp_path))] == [
        "checkpoint_io_degraded"] * 2
    assert eng._health._memory_snapshot["global_steps"] == 2


def test_imperative_path_skips_the_poisoned_window(tmp_path):
    """After a rollback the imperative forward / backward / step consume a
    poisoned window's micro-batches without running them (no step, the
    cursor advanced), then train again."""
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    eng = deepspeed_tpu_torch.initialize(model=model, config=_config(tmp_path, {
        "sentinel": {"enabled": True, "warmup_steps": 1}},
        gradient_accumulation_steps=2), device="cpu")[0]
    eng._health._skip_until = 1  # cursor 0 is poisoned
    for i in range(2):
        eng.forward({"input_ids": batch_for(i)["input_ids"]})
        eng.backward()
        eng.step()
    assert (eng.global_steps, eng.data_cursor, eng._health.skipped_cursors) == (0, 1, [0])
    for i in range(2):
        eng.forward({"input_ids": batch_for(i)["input_ids"]})
        eng.backward()
        eng.step()
    assert (eng.global_steps, eng.data_cursor) == (1, 2)
