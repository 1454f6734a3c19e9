"""The port's resilience primitives and preemption lifecycle against the JAX
package's: fingerprints of the same bytes under each checksum algorithm (a
parity test names its algorithm; it never assumes one: this host's JAX
package prefers ``crc32c``, the port ``crc32``), the recovery log read by
the other package, ``FaultPlan`` firing at the same indices, quarantine, the
injectors of modules still to port raising, a SIGKILL at every save phase
(a torn or unpointed tag both packages resolve alike, and the resume
bitwise the uninterrupted run), and the drain's emergency tag as the JAX
package reads it. Bars: fingerprints, event trails and resolved tags equal;
resumed states bitwise."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deepspeed_tpu.resilience as jres
import deepspeed_tpu_torch.resilience as tres
from deepspeed_tpu.checkpoint import load_checkpoint as jax_load_checkpoint

sys.path.insert(0, os.path.dirname(__file__))
import _torch_resilience_worker as worker  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "_torch_resilience_worker.py")
ALGOS = ["crc32", "crc32c"]


@pytest.fixture(autouse=True)
def _no_plans():
    tres.install_plan(None)
    jres.install_plan(None)
    yield
    tres.install_plan(None)
    jres.install_plan(None)


# ----------------------------------------------------------------- fingerprints
@pytest.mark.parametrize("algo", ALGOS)
def test_fingerprints_equal_under_each_algorithm(algo):
    """The same bytes print alike in both packages: a buffer, fp32 and bf16
    arrays (a torch tensor against the JAX array), and per-block prints with
    the last block short."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32)
    assert tres.fingerprint_bytes(x.tobytes(), algo) == jres.fingerprint_bytes(x.tobytes(), algo)
    assert tres.fingerprint_array(torch.from_numpy(x), algo) == \
        jres.fingerprint_array(x, algo)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    assert tres.fingerprint_array(bf, algo) == jres.fingerprint_array(
        jnp.asarray(x, jnp.bfloat16), algo)
    for block in (256, 1000, 4000, 1 << 20):
        want = jres.blockwise_fingerprints(x, block, algo)
        got = tres.blockwise_fingerprints(torch.from_numpy(x), block, algo)
        assert got == want and len(got) == -(-4000 // block)
    assert tres.blockwise_fingerprints(np.zeros(0, np.float32), 64, algo) == \
        jres.blockwise_fingerprints(np.zeros(0, np.float32), 64, algo)


# ---------------------------------------------------------------- recovery log
def test_recovery_log_read_by_the_other_package(tmp_path):
    """Each package's log (rotated by size) is read whole by the other's
    ``read_events``, event for event."""
    for write, read, name in ((tres, jres, "port"), (jres, tres, "jax")):
        d = tmp_path / name
        log = write.RecoveryLog.for_dir(str(d), role="engine", max_bytes=400, keep=3)
        for i in range(8):
            log.record("poison_skip", step=i, cursor=i, tag=f"global_step{i}")
        assert os.path.exists(str(d / tres.EVENTS_FILENAME) + ".1")  # rotated
        got, want = read.read_events(str(d)), write.read_events(str(d))
        assert got == want and [e["cursor"] for e in got][-3:] == [5, 6, 7]
        assert log.count("poison_skip") == 8


# ------------------------------------------------------------------ fault plans
PLAN = {"nan_at_step": 3, "stall_collective": 0.0, "ef_overflow_steps": 2,
        "dispatch_raise_at": 2, "dispatch_raise_times": 3, "dispatch_stall_at": 7,
        "dispatch_stall_seconds": 0.5, "alloc_fail_at": 4, "alloc_fail_times": 2,
        "flip_bit_at": 5, "flip_bit_domain": "kv_page", "kill_at_phase": "shard:2",
        "kill_at_save": 1}


@pytest.mark.parametrize("source", ["dict", "env"])
def test_fault_plan_fires_at_the_same_indices(source, monkeypatch):
    """``from_dict`` and ``from_env`` plans of both packages resolve every
    injection alike over a grid of cursors, dispatches, alloc calls and
    scheduler steps."""
    if source == "env":
        monkeypatch.setenv(tres.FAULT_PLAN_ENV, json.dumps(PLAN))
        tp, jp = tres.FaultPlan.from_env(), jres.FaultPlan.from_env()
    else:
        tp, jp = tres.FaultPlan.from_dict(dict(PLAN)), jres.FaultPlan.from_dict(dict(PLAN))
    for i in range(12):
        a, b = tp.training_faults(i), jp.training_faults(i)
        assert (a.nan_loss, a.stall_s, a.ef_overflow) == (b.nan_loss, b.stall_s, b.ef_overflow)
        a, b = tp.serving_dispatch(i), jp.serving_dispatch(i)
        assert (a.raise_error, a.stall_s) == (b.raise_error, b.stall_s)
        assert tp.serving_alloc(i) == jp.serving_alloc(i)
        assert tp.sdc_flip(i, "training") == jp.sdc_flip(i, "training")
        assert tp.sdc_flip(i, "serving") == jp.sdc_flip(i, "serving")
    for plan in (tp, jp):
        plan.fault_point("begin-save")
    for plan in (tp, jp):  # save #1: the armed one
        plan.fault_point("begin-save")
        assert plan._kill_armed("shard", 2) and not plan._kill_armed("shard", 1)
    with pytest.raises(ValueError, match="unknown FaultPlan keys"):
        tres.FaultPlan.from_dict({"kill_at_phse": "x"})


@pytest.mark.parametrize("arm,item", [
    ({"stall_offload_at": 0, "stall_offload_seconds": 1.0}, None),
    ({"kill_at_phase": "host-shard:0"}, None),
    ({"flip_bit_at": 2}, None),  # the default domain: the offload host shards
    ({"tenant_flood_at": 3}, "A10"),
])
def test_unported_injectors_raise_naming_their_item(arm, item, tmp_path):
    """An injector of a module the port does not have yet raises when armed,
    in code and through the config block, so none sits inert. The offload
    injectors (``item`` None) are ported: the plan builds both ways and
    fires as the JAX package's does (the fetch stall once, at its wait
    index; the kill after host shard 0 of the armed save; the flip in the
    host-shard domain at its cursor)."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    block = {"resilience": {"enabled": True, "save_dir": str(tmp_path), "chaos": arm}}
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            tres.FaultPlan(**arm)
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            DeepSpeedConfig.load(block)
        return
    assert DeepSpeedConfig.load(block).resilience.chaos == arm
    tp, jp = tres.FaultPlan(**arm), jres.FaultPlan(**arm)
    if "stall_offload_at" in arm:
        assert [tp.offload_fetch(i) for i in range(3)] == \
            [jp.offload_fetch(i) for i in range(3)] == [1.0, 0.0, 0.0]
    elif "kill_at_phase" in arm:
        for plan in (tp, jp):
            plan.fault_point("begin-save")
            assert plan._kill_armed("host-shard", 0) and not plan._kill_armed("host-shard", 1)
            assert not plan._kill_armed("shard", 0)
    else:
        assert [tp.sdc_flip(i, "training") for i in range(4)] == \
            [jp.sdc_flip(i, "training") for i in range(4)] == [None, None, "host_shards", None]


def test_retrying_writer_absorbs_injected_io_faults(tmp_path):
    """The plan's transient failures and stalls fire inside the port's
    ``RetryingWriter.call``: absorbed within the budget, raised past it."""
    tres.install_plan(tres.FaultPlan(fail_io_times=2))
    w = tres.RetryingWriter(attempts=3, base_delay=0.001, max_delay=0.002)
    w.write_bytes(str(tmp_path / "a"), b"x")
    assert w.retries_performed == 2 and (tmp_path / "a").read_bytes() == b"x"
    tres.install_plan(tres.FaultPlan(fail_io_times=5))
    with pytest.raises(tres.RetryBudgetExceeded):
        tres.RetryingWriter(attempts=2, base_delay=0.001).write_bytes(str(tmp_path / "b"), b"y")


def test_quarantine_marker_read_by_both_packages(tmp_path):
    """The port's quarantine marker revokes the tag for both packages and
    repoints ``latest`` at the newest remaining committed tag."""
    for i, t in enumerate(("global_step1", "global_step2")):
        os.makedirs(tmp_path / t / "state")
        (tmp_path / t / "state" / "state.msgpack").write_bytes(bytes([i]) * 64)
        tres.commit_tag(str(tmp_path / t))
    tres.write_latest(str(tmp_path), "global_step2")
    assert tres.quarantine_tag(str(tmp_path), "global_step2", "crash loop") == "global_step1"
    for pkg in (tres, jres):
        assert pkg.committed_tags(str(tmp_path)) == ["global_step1"]
        assert pkg.read_latest(str(tmp_path)) == "global_step1"
        with pytest.raises(pkg.UncommittedTagError, match="quarantined"):
            pkg.verify_tag(str(tmp_path / "global_step2"))


# -------------------------------------------------------- SIGKILL at every phase
STEPS = 4


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The run every kill case resumes to: 4 steps with a save after each,
    uninterrupted, in this process."""
    d = tmp_path_factory.mktemp("uninterrupted")
    return worker.flat_state(worker.run(d / "ckpt", STEPS, install_signal_handlers=False))


@pytest.mark.parametrize("phase", ["shard:1", "pre-manifest", "pre-commit", "post-commit",
                                   "pre-latest"])
def test_sigkill_at_every_save_phase_resumes_bitwise(phase, tmp_path, uninterrupted):
    """One child trains with a SIGKILL armed at ``phase`` of its third save.
    The tag it leaves is resolved to the same tag by both packages (a torn
    one rejected by both), and the resume, in this process, ends bitwise
    equal to the uninterrupted run."""
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, **{tres.FAULT_PLAN_ENV: json.dumps(
        {"kill_at_phase": phase, "kill_at_save": 2})}, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, WORKER, "--ckpt-dir", str(ckpt), "--steps",
                        str(STEPS)], env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == -signal.SIGKILL, p.stderr[-1500:]
    torn = ckpt / "global_step3"
    assert torn.is_dir()
    committed = tres.is_committed(str(torn))
    assert committed == jres.is_committed(str(torn)) == (phase in ("post-commit", "pre-latest"))
    if not committed:
        for pkg in (tres, jres):
            with pytest.raises(pkg.CheckpointCorruptionError):
                pkg.verify_tag(str(torn))
    assert tres.resolve_tag_for_load(str(ckpt))[0] == jres.resolve_tag_for_load(str(ckpt))[0]
    resumed = worker.flat_state(worker.run(ckpt, STEPS, install_signal_handlers=False))
    assert resumed.keys() == uninterrupted.keys()
    for k in resumed:
        np.testing.assert_array_equal(resumed[k], uninterrupted[k], err_msg=k)


# ------------------------------------------------------------ the drain's tag
def test_sigterm_drain_writes_an_emergency_tag_the_jax_package_reads(tmp_path):
    """A SIGTERM sets the drain flag; the next boundary saves an emergency
    tag (``emergency``, ``resume_state``, the data cursor) and exits 83. The
    JAX package's loader reads it alike: the counters, the cursor, the
    resumed state and the survived preemption. A relaunch auto-resumes."""
    ckpt = tmp_path / "ckpt"
    eng = worker.make_engine(ckpt, install_signal_handlers=True)
    eng.resume_state_provider = lambda: {"sampler_epoch": 1, "cursor": eng.data_cursor}
    try:
        eng.train_batch(worker.batch(0))
        os.kill(os.getpid(), signal.SIGTERM)
        assert eng._preemption_guard.drain_requested
        with pytest.raises(SystemExit) as exit_info:
            eng.train_batch(worker.batch(1))
        assert exit_info.value.code == tres.PREEMPTED_EXIT_CODE
    finally:
        eng._preemption_guard.uninstall()
    tag = tres.read_latest(str(ckpt))
    meta = json.load(open(ckpt / tag / "meta.json"))
    assert tag == "global_step2" and meta["emergency"] is True
    assert meta["resume_state"] == {"sampler_epoch": 1, "cursor": 2}
    assert meta["data_cursor"] == 2
    events = [e["event"] for e in tres.read_events(str(ckpt))]
    assert events == ["emergency_save"]

    import deepspeed_tpu
    from deepspeed_tpu.models import GPTConfig, build_gpt
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JCfg
    from deepspeed_tpu.runtime.topology import MeshTopology

    model, _ = build_gpt(GPTConfig(vocab_size=64, n_layer=2, n_head=2, d_model=32,
                                   max_seq_len=32))
    jeng = deepspeed_tpu.initialize(model=model, config=JCfg.load({
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}, world_size=1),
        topology=MeshTopology.single_device())[0]
    loaded, _ = jax_load_checkpoint(jeng, str(ckpt))
    assert loaded.endswith(tag)
    assert (jeng.global_steps, jeng.data_cursor, jeng._preemptions_survived,
            jeng.resumed_state) == (2, 2, 1, meta["resume_state"])

    again = worker.make_engine(ckpt, install_signal_handlers=False)
    assert (again.global_steps, again.data_cursor, again._preemptions_survived,
            again.resumed_state) == (2, 2, 1, meta["resume_state"])
    assert [e["event"] for e in tres.read_events(str(ckpt))][-2:] == [
        "preemption_survived", "resume_latency_s"]


def test_request_drain_and_guard_api(tmp_path):
    """``request_drain`` drains at the next boundary like a signal;
    without the resilience block it refuses; ``install_preemption_guard``
    installs the handlers (main thread) and the second call is idempotent."""
    eng = worker.make_engine(tmp_path / "ckpt", install_signal_handlers=False)
    guard = eng.install_preemption_guard()
    try:
        assert guard.installed and eng.install_preemption_guard() is guard
        eng.request_drain("test")
        with pytest.raises(SystemExit) as exit_info:
            eng.train_batch(worker.batch(0))
        assert exit_info.value.code == 83
    finally:
        guard.uninstall()
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt

    model, _ = gpt.build(gpt.GPTConfig(vocab_size=64, n_layer=1, n_head=2, d_model=32,
                                       max_seq_len=32))
    plain = dt.initialize(model=model, config={"train_micro_batch_size_per_gpu": 2},
                          device="cpu")[0]
    with pytest.raises(ValueError, match="request_drain needs resilience.enabled"):
        plain.request_drain()


def test_resilience_config_validators_are_the_references(tmp_path):
    """The block's validators: a save_dir for enabled, the parent block for
    the sentinel / watchdog / integrity, the exit code's range, the chaos
    keys, the fields' ranges."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JCfg
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TCfg

    bad = [{"enabled": True}, {"sentinel": {"enabled": True}},
           {"integrity": {"enabled": True}}, {"watchdog": {"enabled": True}},
           {"enabled": True, "save_dir": "x", "exit_code": 0},
           {"enabled": True, "save_dir": "x", "chaos": {"nope": 1}},
           {"enabled": True, "save_dir": "x", "sentinel": {"ema_beta": 1.0}},
           {"enabled": True, "save_dir": "x", "integrity": {"block_bytes": 16}}]
    for block in bad:
        for cfg in (JCfg, TCfg):
            with pytest.raises(Exception):
                cfg.load({"resilience": block})
    out = TCfg.load({"resilience": {"enabled": True, "save_dir": str(tmp_path),
                                    "integrity": {"enabled": True, "blocks_per_scan": 2}}})
    assert out.resilience.integrity.blocks_per_scan == 2 and out.resilience.exit_code == 83
