"""The port's silent-data-corruption defense against the JAX package's: the
integrity monitor's stamp / verify rotation over the same units stamps the
same blocks and names the same flipped block (both under ``crc32``, named);
the majority vote and the payload fingerprints on a grid; the allocator's
fingerprint audit; and on the engines (the port resuming the JAX engine's
initial tag), a chaos flip in the master domain is named at the same
domain, unit and block, and the rollback lands on the same tag and step,
the replayed steps' losses within the fp32 bars (rtol 1e-5). The port's
spot check is quiet on a clean run (bitwise reruns on the CPU); a save
refuses state whose stamps no longer verify."""

import os
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu.resilience as jres
import deepspeed_tpu_torch
import deepspeed_tpu_torch.resilience as tres
from deepspeed_tpu.inference.serving.paging import PageAllocator as JaxAllocator
from deepspeed_tpu_torch.inference.serving.paging import PageAllocator
from deepspeed_tpu_torch.models import gpt

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


def _units(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(700).astype(np.float32),
            "b": rng.standard_normal((3, 50)).astype(np.float32),
            "c": np.arange(10, dtype=np.int32)}


def test_monitor_rotation_and_flip_match_the_reference():
    """Budgeted rounds over three units (blocks of 512 bytes, 3 a scan):
    the same pending blocks after each round, the same bytes read, the flip
    in the same block and byte, the same mismatch named."""
    monitors = []
    for pkg, torch_units in ((jres, False), (tres, True)):
        units = _units()
        if torch_units:  # the port fingerprints tensors in place
            units = {k: torch.from_numpy(v) for k, v in units.items()}
        mon = pkg.IntegrityMonitor(scan_interval=1, blocks_per_scan=3, block_bytes=512,
                                   algo="crc32")
        mon.register_domain("master", lambda u=units: u)
        monitors.append((mon, units))
    (jm, _), (tm, _) = monitors
    for _ in range(3):
        for mon, _ in monitors:
            mon.stamp_next()
        assert list(tm._pending) == list(jm._pending)
        assert tm._pending == jm._pending
        assert tm.verify_pending() == jm.verify_pending() == []
    for mon, _ in monitors:
        mon.stamp_next()
    assert tm.inject_flip("master") == jm.inject_flip("master")
    bad_t, bad_j = tm.verify_pending(), jm.verify_pending()
    assert bad_t == bad_j and len(bad_t) == 1
    assert tm.report()["mismatches"] == jm.report()["mismatches"] == 1
    # the flip is in the tensor itself: the unit now differs from a clean copy
    assert not torch.equal(monitors[1][1][bad_t[0]["unit"]],
                           torch.from_numpy(_units()[bad_t[0]["unit"]]))
    tm.stamp_next()
    tm.invalidate("load")
    assert tm.pending_blocks == 0 and tm.counters["invalidations"] == 1


def test_vote_and_payload_fingerprints_match_on_a_grid():
    rng = np.random.default_rng(0)
    for _ in range(60):
        n = int(rng.integers(1, 7))
        rows = [{"process_index": i, "hostname": f"h{i}",
                 "fingerprint": int(rng.integers(0, 3))} for i in range(n)]
        assert tres.fingerprint_vote(rows) == jres.fingerprint_vote(rows)
    tensors = {"k_pages": {"data": rng.bytes(256)}, "v_pages": {"data": rng.bytes(256)}}
    for algo in ("crc32", "crc32c"):
        stamp = tres.payload_fingerprints(tensors, algo)
        assert stamp == jres.payload_fingerprints(tensors, algo)
        assert tres.verify_payload_fingerprints(tensors, stamp) == []
        torn = dict(tensors, v_pages={"data": b"\0" + tensors["v_pages"]["data"][1:]})
        assert tres.verify_payload_fingerprints(torn, stamp) == \
            jres.verify_payload_fingerprints(torn, stamp) == ["v_pages"]
    assert tres.allgather_host_stats(1.0, fingerprint=7) is None  # one rank: no exchange


def test_allocator_audit_sweeps_stamped_shared_pages():
    """The audit re-fingerprints every stamped page with more than one
    reference and names a mismatch, as the reference's allocator does."""
    prints = {p: 100 + p for p in range(1, 8)}
    for cls in (PageAllocator, JaxAllocator):
        a = cls(8)
        pages = a.alloc(3)
        a.share(pages[:2])
        now = dict(prints)
        now[pages[1]] += 1  # a shared page rotted

        rep = a.audit(expected_fingerprints=prints,
                      fingerprint_fn=lambda ps: [now[p] for p in ps])
        assert (rep["ok"], rep["fingerprinted"], rep["mismatches"]) == (False, 2, [pages[1]])
        assert a.audit()["ok"]


# ----------------------------------------------------------------- engines
def test_master_flip_is_named_alike_and_the_rollback_is_step_exact(tmp_path):
    """A flip in the master domain at cursor 3 (scans every step, 2 blocks of
    4 KiB; anchors every 2 steps) is detected before the step that would
    mutate the state, named at the same unit and block by both engines, and
    rolled back to ``global_step2``; the replay (no skip: the data was clean)
    runs the same steps."""
    res = {"sentinel": {"enabled": True, "warmup_steps": 1, "checkpoint_interval": 2},
           "integrity": {"enabled": True, "scan_interval": 1, "blocks_per_scan": 2,
                         "block_bytes": 4096},
           "chaos": {"flip_bit_at": 3, "flip_bit_domain": "master"}}
    jeng, teng = engines(tmp_path, res)
    jrun, trun = drive(jeng, 5), drive(teng, 5)
    assert_same_run(jrun, trun)
    assert trail(tmp_path / "jax") == trail(tmp_path / "port")
    sdc = [e for e in tres.read_events(str(tmp_path / "port")) if e["event"] == "sdc_detected"]
    assert len(sdc) == 1 and sdc[0]["domain"] == "master"
    rb = [e for e in tres.read_events(str(tmp_path / "port")) if e["event"] == "sdc_rollback"]
    assert [(e["step"], e["unit"], e["block"]) for e in rb] == [
        (2, sdc[0]["unit"], sdc[0]["block"])]
    assert [w for *_, w in trun].count("rollback") == 1
    assert teng._integrity.counters["mismatches"] == 1
    # step-exact: the replayed step 3 is bitwise the first one (the same
    # state from the tag, the same batch at the same cursor)
    step3 = [loss for gs, cur, loss, w in trun if gs == 3 and w == "step"]
    assert len(step3) == 2 and step3[0] == step3[1]


def test_spot_check_is_quiet_on_a_clean_run(tmp_path):
    """The spot check reruns a micro-batch every step: bitwise equal each
    time on a clean run (gas 2: the window's first micro-batch)."""
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    eng = deepspeed_tpu_torch.initialize(model=model, config=_config(tmp_path, {
        "integrity": {"enabled": True, "scan_interval": 1, "spot_check_interval": 1}},
        gradient_accumulation_steps=2), device="cpu")[0]
    for c in range(4):
        eng.train_batch({"input_ids": np.stack([batch_for(c)["input_ids"]] * 2)})
    rep = eng._integrity.report()
    assert (rep["spot_checks"], rep["spot_mismatches"], rep["mismatches"]) == (4, 0, 0)
    assert rep["bytes_fingerprinted"] > 0 and eng._integrity_boundary_fp is not None


def test_save_refuses_state_whose_stamps_no_longer_verify(tmp_path):
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    eng = deepspeed_tpu_torch.initialize(model=model, config=_config(tmp_path, {
        "integrity": {"enabled": True, "scan_interval": 1}}), device="cpu")[0]
    eng.train_batch(batch_for(0))
    info = eng._integrity.inject_flip("master")
    with pytest.raises(tres.SDCError, match=f"block={info['block']}"):
        eng.save_checkpoint(str(tmp_path))
    assert tres.committed_tags(str(tmp_path)) == []
