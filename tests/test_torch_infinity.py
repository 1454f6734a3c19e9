"""ZeRO-Infinity's parameter stream in the port against the JAX package's
``ParamStreamRunner``.

Both runners make the host masters from the model's per-unit host init
(``GPTStream.init_unit``, the same numpy draws), so they start from the same
weights without a bridge, and take the same numpy batches. Bars, those of
``test_torch_engine.py``: fp32 loss rtol 1e-5 and grad norm 1e-4 with the
host masters rtol 1e-3 / atol 2e-5 (the reference's bar for the stream
against the in-device step); bf16 rtol 2e-2 / 5e-2. The JAX runs are shared
across cases (a module fixture). Within the port: the streamed schedule is
BITWISE fetch-on-demand at depths 1 and 2 (only the copies' issue points
move); the quantized fetch is within the reference's rel 0.05 of the exact
run with a wire ratio over 3 (fp32 logical bytes) and at the fp32 bars of
JAX's quantized run; an injected stall trips the ``offload_fetch``
deadline; host shards go under the MANIFEST and ``zero_to_fp32`` reads the
stream's ``unit/name`` masters; a SIGKILL between host shards resumes
bitwise from the last committed tag; the host-state reshard functions are
bitwise the reference's; tags cross both ways.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
import deepspeed_tpu_torch.resilience as tres
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu.runtime.zero import reshard as jax_reshard
from deepspeed_tpu.runtime.zero.gather import prefetch_schedule as jax_prefetch_schedule
from deepspeed_tpu.utils import zero_to_fp32 as jax_zero_to_fp32
from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.runtime.zero import reshard
from deepspeed_tpu_torch.runtime.zero.gather import prefetch_schedule
from deepspeed_tpu_torch.runtime.zero.stream import DeviceTransfer, UnitFetchStream
from deepspeed_tpu_torch.utils import zero_to_fp32

TINY = dict(vocab_size=64, n_layer=4, n_head=2, d_model=32, max_seq_len=32)
WORKER = os.path.join(os.path.dirname(__file__), "_torch_offload_worker.py")
STEPS = 3


def stream_cfg(**op):
    # buffer_count 1: one layer kept for the backward, so the backward streams
    return {"offload_param": {"device": "cpu", "buffer_count": 1, **op}}


def config(**over):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "steps_per_print": 0, "zero_optimization": stream_cfg()}
    cfg.update(over)
    return cfg


# case -> (config blocks, GPT overrides, batch maker, loss rtol, norm rtol, masters held)
def _ids(i):
    return np.random.default_rng(i).integers(0, 64, (2, 16)).astype(np.int32)


def _masked(i):
    b = {"input_ids": _ids(i)}
    b["loss_mask"] = (np.random.default_rng(100 + i).random((2, 16)) > 0.3).astype(np.float32)
    return b


def _labelled(i):
    return {"input_ids": _ids(i), "labels": _ids(200 + i)}


CASES = {
    "fp32": ({}, {}, lambda i: {"input_ids": _ids(i)}, 1e-5, 1e-4, True),
    "bf16": ({"bf16": {"enabled": True}}, {}, lambda i: {"input_ids": _ids(i)}, 2e-2, 5e-2,
             False),
    "loss_mask": ({}, {}, _masked, 1e-5, 1e-4, True),
    "labels-untied": ({}, {"tie_embeddings": False}, _labelled, 1e-5, 1e-4, True),
    "depth0-nvme": ({"zero_optimization": {"offload_param": {
        "device": "nvme", "buffer_count": 2, "stream": False}}}, {},
        lambda i: {"input_ids": _ids(i)}, 1e-5, 1e-4, True),
}


def jax_engine(cfg, **gpt_over):
    model, _ = build_gpt(JaxGPTConfig(**TINY, **gpt_over))
    return deepspeed_tpu.initialize(model=model, config=JaxDeepSpeedConfig.load(cfg, 1),
                                    topology=MeshTopology.single_device(), seed=0)[0]


def port_engine(cfg, **gpt_over):
    model, _ = gpt.build(gpt.GPTConfig(**TINY, **gpt_over))
    return deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")[0]


def _f(x):
    return float(x.detach().float() if torch.is_tensor(x) else np.asarray(x))


def _nvme(cfg, path):
    op = cfg["zero_optimization"]["offload_param"]
    if op["device"] == "nvme":
        cfg = {**cfg, "zero_optimization": {"offload_param": {**op, "nvme_path": str(path)}}}
    return cfg


def _masters(runner):
    d = runner.host_state_dict()  # RAM or NVMe
    return [d[f"master_{i}"] for i in range(len(runner._leaves))]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = {}
    for name, (over, gpt_over, make, *_) in CASES.items():
        cfg = _nvme(config(**over), tmp_path_factory.mktemp("jax_nvme"))
        je = jax_engine(cfg, **gpt_over)
        ms = [je.train_batch(make(i)) for i in range(STEPS)]
        out[name] = ([_f(m["loss"]) for m in ms], [_f(m["grad_norm"]) for m in ms],
                     [np.array(x) for x in _masters(je._param_stream)],
                     [(u, n) for u, n, _ in je._param_stream._leaves])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_the_jax_runner(reference, case, tmp_path):
    over, gpt_over, make, loss_rtol, norm_rtol, cmp_masters = CASES[case]
    losses, norms, masters, leaves = reference[case]
    engine = port_engine(_nvme(config(**over), tmp_path), **gpt_over)
    runner = engine._param_stream
    assert runner is not None and engine._offload is None
    assert engine.state["params"] == {} and engine.state["opt"] == {}
    for i in range(STEPS):
        m = engine.train_batch(make(i))
        np.testing.assert_allclose(_f(m["loss"]), losses[i], rtol=loss_rtol)
        np.testing.assert_allclose(_f(m["grad_norm"]), norms[i], rtol=norm_rtol)
    assert [(u, n) for u, n, _ in runner._leaves] == leaves
    assert runner.count == STEPS and engine.global_steps == STEPS
    if cmp_masters:
        for a, b in zip(_masters(runner), masters):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-5)
    else:  # bf16: every push buffer is its master's bf16 copy-back, bitwise
        for buf, mst in zip(runner._push_bufs, _masters(runner)):
            assert torch.equal(buf.view(torch.int16),
                               torch.from_numpy(mst).to(torch.bfloat16).view(torch.int16))


# case -> (GPT overrides, batch): the stream's first step beside the dense loss_fn
LOSS_CASES = {
    "shift": ({}, lambda: {"input_ids": _ids(0)}),
    "loss_mask": ({}, lambda: _masked(0)),
    "labels-untied": ({"tie_embeddings": False}, lambda: _labelled(0)),
    "seq+1": ({}, lambda: {"input_ids": np.random.default_rng(7).integers(
        0, 64, (2, TINY["max_seq_len"] + 1)).astype(np.int32)}),
    "loss_chunk": ({"loss_chunk": 8}, lambda: _masked(0)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_stream_step_scores_the_dense_loss(case):
    """The stream's first step scores, bitwise, the dense ``loss_fn`` on the
    same weights (its units' host init, stacked): the head's loss is
    ``next_token_loss``'s, ``chunked_head_loss``'s with ``loss_chunk``, and
    seq+1 packing runs the units on all but the last token."""
    gpt_over, make = LOSS_CASES[case]
    cfg = gpt.GPTConfig(**TINY, **gpt_over)
    engine = port_engine(config(), **gpt_over)
    runner = engine._param_stream
    units = {u: {k: torch.from_numpy(v) for k, v in runner.stream.init_unit(u, runner.seed).items()}
             for u in runner.stream.unit_names()}
    layers = [units[f"layer_{i}"] for i in range(cfg.n_layer)]
    params = {**units["embed"], **units["final"],
              "blocks": {k: torch.stack([w[k] for w in layers]) for k in layers[0]}}
    batch = make()
    want = gpt.loss_fn(cfg, params, batch)[0]
    assert _f(engine.train_batch(batch)["loss"]) == _f(want)


def test_prefetch_schedule_is_the_reference_s():
    for n, d in [(5, 0), (5, 1), (5, 2), (5, 4), (3, 8), (0, 2), (1, 0)]:
        events = list(prefetch_schedule(n, d))
        assert events == list(jax_prefetch_schedule(n, d))
        for i in range(n):  # unit i + d is out before unit i is consumed
            pos = events.index(("consume", i))
            issued = {j for k, j in events[:pos] if k == "issue"}
            assert issued == set(range(min(i + max(d, 0) + 1, n)))


def test_unit_fetch_stream_mechanics():
    issued = []

    def fetch(name):
        issued.append(name)
        return DeviceTransfer({"w": torch.zeros(2)}, None)

    s = UnitFetchStream(fetch, ["a", "b", "c", "d"], depth=2)
    assert set(s.take("a")) == {"w"}
    assert issued == ["a", "b", "c"]
    s.take("b")
    assert issued == ["a", "b", "c", "d"]
    with pytest.raises(ValueError, match="out-of-order"):
        s.take("b")
    s.take("c")
    s.take("d")
    issued.clear()
    s0 = UnitFetchStream(fetch, ["a", "b"], depth=0)
    assert issued == []
    s0.take("a")
    assert issued == ["a"]
    issued.clear()
    sp = UnitFetchStream(fetch, ["a", "b", "c"], depth=2)
    sp.prime()
    assert issued == ["a", "b"]
    sp.take("a")
    assert issued == ["a", "b", "c"]


@pytest.mark.parametrize("depth", [1, 2])
def test_streamed_is_bitwise_fetch_on_demand(depth):
    """Same seed, same host masters; only the copies' issue points move, so
    the losses, grad norms and every updated master agree bitwise."""
    e_str = port_engine(config(zero_optimization=stream_cfg(prefetch_depth=depth)))
    e_inl = port_engine(config(zero_optimization=stream_cfg(stream=False)))
    assert e_str._param_stream.prefetch_depth == depth
    assert e_inl._param_stream.prefetch_depth == 0
    for i in range(STEPS):
        b = {"input_ids": _ids(i)}
        m1, m2 = e_str.train_batch(b), e_inl.train_batch(b)
        assert _f(m1["loss"]) == _f(m2["loss"]) and _f(m1["grad_norm"]) == _f(m2["grad_norm"])
    for a, b in zip(_masters(e_str._param_stream), _masters(e_inl._param_stream)):
        np.testing.assert_array_equal(a, b)
    dma = e_str.memory_stats()["host_dma"]
    L = TINY["n_layer"]
    # embed + final + L units forward, L - 1 re-streamed backward
    # (embed 2 leaves, final 2, 12 a layer): L layer units forward, L - 1 backward
    assert dma["prefetch_depth"] == depth and dma["pushes"] == 4 + 12 * (2 * L - 1)
    assert dma["waits"] == (2 * L - 1) + (L + 3) and dma["grad_fetches"] == L + 3
    assert wire_ledger.host_dma == e_inl.memory_stats()["host_dma"]  # the last step's


def test_quantized_fetch_tolerance_ratio_and_jax_parity():
    wire_ledger.reset()
    cfg_q = config(zero_optimization=stream_cfg(quantized_fetch=True))
    e_q, e_x, je_q = port_engine(cfg_q), port_engine(config()), jax_engine(cfg_q)
    for i in range(2):
        b = {"input_ids": _ids(i)}
        mq, mx, mj = e_q.train_batch(b), e_x.train_batch(b), je_q.train_batch(b)
        # int8 blocks move the weights by up to half a step: never bitwise
        assert _f(mq["loss"]) == pytest.approx(_f(mx["loss"]), rel=0.05)
        np.testing.assert_allclose(_f(mq["loss"]), _f(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(_f(mq["grad_norm"]), _f(mj["grad_norm"]), rtol=1e-4)
    assert "qpush[host-dma]" in wire_ledger.records
    assert wire_ledger.ratio("qpush") > 3.0  # fp32 logical against int8 + scales
    dma = e_q.memory_stats()["host_dma"]
    assert dma["quantized"] and dma["ratio"] > 3.0
    assert "host DMA" in e_q.comms_summary()
    wire_ledger.reset()


@pytest.mark.parametrize("runner", ["param_stream", "offload"])
def test_watchdog_flags_an_injected_copy_stall(tmp_path, runner):
    zero = (stream_cfg(prefetch_depth=1) if runner == "param_stream"
            else {"offload_optimizer": {"device": "cpu"}})
    e = port_engine(config(zero_optimization=zero, resilience={
        "enabled": True, "save_dir": str(tmp_path), "install_signal_handlers": False,
        "watchdog": {"enabled": True, "poll_interval_s": 0.05,
                     "offload_fetch_deadline_s": 0.3, "escalate": False}}))
    try:
        tres.install_plan(tres.FaultPlan(stall_offload_at=0, stall_offload_seconds=1.2))
        from deepspeed_tpu_torch.runtime.zero import stream

        stream._fetch_wait_index = 0
        e.train_batch({"input_ids": _ids(0)})
        deadline = time.monotonic() + 3.0
        while e._watchdog.stall_count == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert e._watchdog.stall_count >= 1
        assert e._watchdog.last_stall[0] == "offload_fetch"
        events = [ev for ev in tres.read_events(str(tmp_path)) if ev["event"] == "watchdog_stall"]
        assert events and events[-1]["phase"] == "offload_fetch"
    finally:
        tres.install_plan(None)
        e._watchdog.stop()


def test_host_shards_under_the_manifest_and_zero_to_fp32(tmp_path):
    e = port_engine(config())
    e.train_batch({"input_ids": _ids(0)})
    tag = e.save_checkpoint(str(tmp_path))
    host = os.path.join(tag, "host_state")
    shards = sorted(f for f in os.listdir(host) if f.endswith(".npz"))
    assert len(shards) == TINY["n_layer"] + 2  # one per unit
    manifest = json.loads(open(os.path.join(tag, "MANIFEST.json")).read())
    assert all(f"host_state/{s}" in manifest["files"] for s in shards)
    runner = e._param_stream
    for sd in (zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path)),
               jax_zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))):
        assert "layer_1/qkv_w" in sd and "embed/wte" in sd
        for i, (u, n, _) in enumerate(runner._leaves):
            np.testing.assert_array_equal(sd[f"{u}/{n}"], runner._state[i][0])
    e2 = port_engine(config())
    with pytest.raises(ValueError, match="host master"):
        e2.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    e2.load_checkpoint(str(tmp_path))
    b = {"input_ids": _ids(7)}
    assert _f(e.train_batch(b)["loss"]) == _f(e2.train_batch(b)["loss"])


def _start_worker(ckpt, steps, log, plan):
    env = {**os.environ, "DS_FAULT_PLAN": plan}
    return subprocess.Popen([sys.executable, WORKER, "--ckpt-dir", str(ckpt), "--steps",
                             str(steps), "--log", str(log)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc):
    """(returncode, stderr) of a worker, killed at the deadline."""
    try:
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, err


def _log(path):
    with open(path) as f:
        return {row["step"]: row for row in map(json.loads, f)}


def test_sigkill_between_host_shards_resumes_bitwise(tmp_path):
    """A SIGKILL after host shard 1 of the step-3 save leaves the step-2 tag
    the newest committed one; the auto-resumed run takes steps 3 and 4
    bitwise as the uninterrupted run."""
    plan = json.dumps({"kill_at_phase": "host-shard:1", "kill_at_save": 2})
    clean = _start_worker(tmp_path / "clean", 4, tmp_path / "clean.jsonl", "")  # alongside
    rc, err = _finish(_start_worker(tmp_path / "ckpt", 4, tmp_path / "killed.jsonl", plan))
    assert rc in (-signal.SIGKILL, 128 + signal.SIGKILL), err[-2000:]
    assert os.path.exists(tmp_path / "ckpt" / "global_step2" / "COMMIT")
    assert not os.path.exists(tmp_path / "ckpt" / "global_step3" / "COMMIT")
    rc, err = _finish(_start_worker(tmp_path / "ckpt", 4, tmp_path / "resumed.jsonl", ""))
    assert rc == 0, err[-2000:]
    rc, err = _finish(clean)
    assert rc == 0, err[-2000:]
    resumed, clean = _log(tmp_path / "resumed.jsonl"), _log(tmp_path / "clean.jsonl")
    assert sorted(resumed) == [3, 4]
    for step in (3, 4):
        assert resumed[step] == clean[step]


def test_host_state_reshard_is_bitwise_the_reference_s():
    r = np.random.default_rng(0)
    host = {"count": np.int64(5), "master_0": r.normal(size=(7, 3)).astype(np.float32),
            "m_0": r.normal(size=(11,)).astype(np.float32),
            "v_0": r.normal(size=(2, 2, 5)).astype(np.float32)}
    shards, sizes = reshard.partition_host_state(host, 3)
    jshards, jsizes = jax_reshard.partition_host_state(host, 3)
    assert sizes == jsizes and sorted(shards) == sorted(jshards)
    for k in shards:
        np.testing.assert_array_equal(shards[k], jshards[k])
    for new in (1, 2, 5):
        got = reshard.repartition_host_state(shards, sizes, new)
        want = jax_reshard.repartition_host_state(jshards, jsizes, new)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        # N -> M -> N is the identity, and merging gives the leaves back
        back = reshard.repartition_host_state(got, sizes, 3)
        for k in back:
            np.testing.assert_array_equal(back[k], shards[k])
        for k in ("master_0", "m_0", "v_0"):
            np.testing.assert_array_equal(
                reshard.merge_flat(got[k], sizes[k]).reshape(host[k].shape), host[k])


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_stream_tags_cross_both_ways(tmp_path, direction):
    je, te = jax_engine(config()), port_engine(config())
    for i in range(2):
        je.train_batch({"input_ids": _ids(i)})
        te.train_batch({"input_ids": _ids(i)})
    src, dst = (je, port_engine(config())) if direction == "jax-to-port" \
        else (te, jax_engine(config()))
    src.save_checkpoint(str(tmp_path))
    dst.load_checkpoint(str(tmp_path))
    assert dst._param_stream.count == 2 and dst.global_steps == 2
    for a, b in zip(dst._param_stream._state, src._param_stream._state):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    b = {"input_ids": _ids(2)}
    ref, out = src.train_batch(b), dst.train_batch(b)
    np.testing.assert_allclose(_f(out["loss"]), _f(ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(_f(out["grad_norm"]), _f(ref["grad_norm"]), rtol=1e-4)


def test_refusals_and_the_copy_check():
    for mk in (port_engine, jax_engine):
        with pytest.raises(ValueError, match="gradient_accumulation_steps"):
            mk(config(gradient_accumulation_steps=2))
    e = port_engine(config(zero_optimization={"offload_param": {"device": "cpu"},
                                              "offload_optimizer": {"device": "cpu"}}))
    assert e._param_stream is not None and e._offload is None  # supersedes
    b = {"input_ids": _ids(0), "attention_mask": np.ones((2, 16), np.int32)}
    with pytest.raises(ValueError, match="unknown"):
        e.train_batch(b)
    runner = e._param_stream
    runner.verify_copies = True
    e.train_batch({"input_ids": _ids(0)})
    L = TINY["n_layer"]
    assert runner.copy_check["drains"] == L + 3 and runner.copy_check["mismatches"] == 0
    assert runner.copy_check["tensors"] > 0
