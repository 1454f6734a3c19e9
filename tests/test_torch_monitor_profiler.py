"""The port's observability against the JAX package's: the monitors, the
wall-clock timers and the flops profiler, on the CPU at ``tiny`` size.

- A 4-step fp32 run writes CSV and JSONL files that name the same events at
  the same steps as the JAX engine's from the same start state, with values
  within rtol 1e-5 (``Train/samples_per_sec`` is wall time: its steps only);
  an fp16 run whose loss scale overflows writes the reference's
  ``Resilience/overflow_skip`` and ``Train/loss_scale`` events exactly.
- A backend that raises buffers its events and flushes them in order when it
  recovers, as the reference's does; a backend whose package is missing is
  left out with a warning.
- ``wall_clock_breakdown`` logs its timers in the reference's format.
- The flops profiler's total on the CPU's plain path equals an analytic
  count of the step's products exactly (FlopCounterMode counts products
  only). Against JAX's ``cost_analysis`` of the same one-layer loss gradient
  (one layer, because XLA counts a loop's body once) the JAX total is at
  least the port's and at most 10% above it: XLA adds the elementwise work
  (layer norms, softmax, GELU, the cross entropy and their backward), about
  6 of every 100 flops at these widths. The flash kernels' formula is the
  plain path's count; ``number_to_string`` is the reference's, bitwise.
"""

import csv
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.models import gpt as jax_gpt
from deepspeed_tpu.monitor import monitor as jmon
from deepspeed_tpu.profiling import flops_profiler as jfp
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu.utils import timer as jtimer
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.monitor import monitor as tmon
from deepspeed_tpu_torch.ops.attention import dot_product_attention
from deepspeed_tpu_torch.ops.cuda.flash_attention import attention_flops
from deepspeed_tpu_torch.profiling import flops_profiler as tfp
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.utils import logging as tlog
from deepspeed_tpu_torch.utils import timer as ttimer
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=64)
SEQ = 32


def _config(micro=4, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_min_lr": 1e-4, "warmup_max_lr": 3e-3, "warmup_num_steps": 4}},
           "gradient_clipping": 1.0, "steps_per_print": 0}
    cfg.update(over)
    return cfg


def _batch(seed, micro=4):
    return {"input_ids": np.random.default_rng(seed).integers(0, 256, (micro, SEQ),
                                                              dtype=np.int32)}


def _monitored(root):
    return {"csv_monitor": {"enabled": True, "output_path": str(root), "job_name": "j"},
            "monitor_config": {"jsonl": {"enabled": True, "output_path": str(root),
                                         "job_name": "j"}}}


def _run_pair(tmp_path, steps, **over):
    """The JAX engine and the port's from its start state, each writing CSV
    and JSONL under its own directory, ``steps`` steps on the same batches."""
    jengine = deepspeed_tpu.initialize(
        model=build_gpt(JaxGPTConfig(**TINY))[0],
        config=JaxDeepSpeedConfig.load(_config(**over, **_monitored(tmp_path / "jax")), 1),
        topology=MeshTopology.single_device(), seed=0)[0]
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    engine = deepspeed_tpu_torch.initialize(
        model=model, config=_config(**over, **_monitored(tmp_path / "port")), device="cpu")[0]
    engine.load_state(bridge.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jengine.state), "cpu", engine.pc.compute_dtype))
    for s in range(steps):
        jengine.train_batch(_batch(s))
        engine.train_batch(_batch(s))
    return jengine, engine


def _csv_events(root):
    out = {}
    d = os.path.join(root, "j")
    for f in sorted(os.listdir(d)):
        if f.endswith(".csv"):
            with open(os.path.join(d, f)) as fh:
                rows = list(csv.reader(fh))
            out[rows[0][1]] = [(int(r[0]), float(r[1])) for r in rows[1:]]
    return out


def _jsonl_events(root):
    out = {}
    with open(os.path.join(root, "j", "events.jsonl")) as f:
        for line in f:
            e = json.loads(line)
            out.setdefault(e["name"], []).append((e["step"], e["value"]))
    return out


def test_monitor_files_match_the_jax_engine(tmp_path):
    _run_pair(tmp_path, 4)
    for read in (_csv_events, _jsonl_events):
        got, want = read(tmp_path / "port"), read(tmp_path / "jax")
        assert sorted(got) == sorted(want) == ["Train/grad_norm", "Train/loss", "Train/lr",
                                               "Train/samples_per_sec"]
        for name in got:
            assert [s for s, _ in got[name]] == [s for s, _ in want[name]], name
            if name != "Train/samples_per_sec":
                np.testing.assert_allclose([v for _, v in got[name]],
                                           [v for _, v in want[name]], rtol=1e-5, err_msg=name)
        assert [s for s, _ in got["Train/loss"]] == [1, 2, 3, 4]
        assert [s for s, _ in got["Train/samples_per_sec"]] == [3, 4]
    # the files hold the metrics train_batch returned, bitwise in the JSONL
    assert _csv_events(tmp_path / "port")["Train/loss"] == \
        _jsonl_events(tmp_path / "port")["Train/loss"]


def test_overflow_skips_write_the_reference_events(tmp_path):
    _run_pair(tmp_path, 2, fp16={"enabled": True, "initial_scale_power": 40})
    got, want = _jsonl_events(tmp_path / "port"), _jsonl_events(tmp_path / "jax")
    assert got["Resilience/overflow_skip"] == want["Resilience/overflow_skip"] == \
        [(1, 1.0), (2, 1.0)]
    assert got["Train/loss_scale"] == want["Train/loss_scale"] == [(1, 2.0 ** 40),
                                                                  (2, 2.0 ** 40)]
    assert sorted(got) == sorted(want)


class _Flaky:
    """Raises for its first ``fails`` writes, then records."""

    def __init__(self, fails):
        self.fails = fails
        self.written = []

    def write_events(self, events):
        if self.fails:
            self.fails -= 1
            raise OSError("disk full")
        self.written.extend(events)


def test_a_failing_backend_buffers_and_flushes_in_order():
    writes = [[(f"e{i}", float(i), i)] for i in range(8)]
    results = {}
    for name, mod in (("jax", jmon), ("port", tmon)):
        sink = _Flaky(3)
        safe = mod._SafeBackend(sink, buffer_limit=2)
        states = []
        for w in writes:
            safe.write_events(w)
            states.append((safe.degraded, list(safe._buffer)))
        results[name] = (sink.written, states, safe.dropped)
    assert results["port"] == results["jax"]
    written, states, dropped = results["port"]
    assert [e[0] for e in written] == ["e1", "e2", "e3", "e4", "e5", "e6", "e7"]
    assert dropped == 1 and states[2][0] and not states[3][0]
    master = tmon.MonitorMaster(DeepSpeedConfig.load({}).monitor, extra_backends=[_Flaky(1)])
    master.write_events(writes[0])
    assert master.degraded
    master.write_events(writes[1])
    assert not master.degraded and master.backends[0].backend.written == writes[0] + writes[1]


@pytest.fixture()
def log_lines():
    """The messages the port's logger emits (it does not propagate)."""
    lines = []

    class H(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    h = H()
    tlog.logger.addHandler(h)
    yield lines
    tlog.logger.removeHandler(h)


def test_missing_backend_packages_are_left_out_with_a_warning(monkeypatch, tmp_path,
                                                              log_lines):
    for mod in ("tensorboardX", "torch.utils.tensorboard", "wandb"):
        monkeypatch.setitem(sys.modules, mod, None)  # import raises ImportError
    cfg = DeepSpeedConfig.load({
        "tensorboard": {"enabled": True, "output_path": str(tmp_path)},
        "wandb": {"enabled": True},
        "csv_monitor": {"enabled": True, "output_path": str(tmp_path)}})
    master = tmon.MonitorMaster(cfg.monitor)
    assert [b.name for b in master.backends] == ["CSVMonitor"]
    assert any("tensorboard monitor disabled" in m for m in log_lines)
    assert any("wandb monitor disabled" in m for m in log_lines)
    monkeypatch.setattr(tmon.comm, "get_rank", lambda group=None: 1)
    quiet = tmon.MonitorMaster(cfg.monitor)  # only rank 0 writes
    assert not quiet.enabled and not quiet.backends


def test_jsonl_rotation_matches_the_reference(tmp_path):
    for pkg in (jmon, tmon):
        root = tmp_path / pkg.__name__.split(".")[0]
        m = pkg.JSONLMonitor(str(root), "j", max_bytes=200, keep=2)
        for i in range(20):
            m.write_events([("Train/loss", float(i), i)])
    names = {p: sorted(os.listdir(tmp_path / p / "j")) for p in ("deepspeed_tpu",
                                                                 "deepspeed_tpu_torch")}
    assert names["deepspeed_tpu_torch"] == names["deepspeed_tpu"] == \
        ["events.jsonl", "events.jsonl.1", "events.jsonl.2"]
    for f in names["deepspeed_tpu"]:
        def steps(p):
            with open(tmp_path / p / "j" / f) as fh:
                return [json.loads(x)["step"] for x in fh]
        assert steps("deepspeed_tpu_torch") == steps("deepspeed_tpu")


def test_wall_clock_breakdown_logs_the_timers(log_lines):
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    engine = deepspeed_tpu_torch.initialize(model=model, config=_config(
        wall_clock_breakdown=True, steps_per_print=2), device="cpu")[0]
    for s in range(4):
        engine.train_batch(_batch(s))
    logged = [m for m in log_lines if m.startswith("time (ms) | ")]
    assert len(logged) == 2
    for m in logged:
        parts = m[len("time (ms) | "):].split(" | ")
        assert [p.split(":")[0] for p in parts] == ["batch_input", "train_batch"]
        assert all(p.endswith("ms") and float(p.split(": ")[1][:-2]) >= 0 for p in parts)
    engine.forward(_batch(5))
    engine.backward()
    engine.step()
    assert engine.timers("forward").count == 1 and engine.timers("step").count == 1
    quiet = deepspeed_tpu_torch.initialize(model=model, config=_config(), device="cpu")[0]
    quiet.train_batch(_batch(0))
    assert quiet.timers.timers == {}  # off: no timer runs, nothing synchronises


def test_timers_match_the_reference_format():
    lines = {}
    for name, mod in (("jax", jtimer), ("port", ttimer)):
        t = mod.SynchronizedWallClockTimer()
        for n, secs in (("forward", 0.0123), ("step", 1.5)):
            t(n).elapsed_ = secs
            t(n).count = 2
        assert t("forward").mean() == pytest.approx(0.00615)
        lines[name] = t.log(["forward", "step", "absent"])
        assert t("forward").elapsed_ == 0.0  # read and reset
    assert lines["port"] == lines["jax"] == "time (ms) | forward: 12.30ms | step: 1500.00ms"
    t = ttimer.SynchronizedWallClockTimer()
    t("x").start()
    with pytest.raises(RuntimeError, match="already started"):
        t("x").start()
    t("x").stop(sync_on={"loss": torch.zeros(())})  # CPU tensors: nothing to wait for
    assert t("x").count == 1
    with pytest.raises(RuntimeError, match="not started"):
        t("x").stop()


# ------------------------------------------------------------------ flops
def _analytic_step_flops(B, T, cfg):
    """2 flops a multiply-add over every product of the forward (the four
    projections, QK^T and PV, the head), and twice that in the backward."""
    D, F, V, L = cfg.d_model, cfg.ffn_dim, cfg.vocab_size, cfg.n_layer
    N = B * T
    fwd = L * (2 * N * D * 3 * D + 2 * N * D * D + 2 * N * D * F + 2 * N * F * D
               + 4 * B * T * T * D) + 2 * N * D * V
    return 3 * fwd


def test_profiler_total_is_the_analytic_count_and_leaves_the_state(tmp_path, log_lines):
    cfg = gpt.GPTConfig(**TINY)
    out = str(tmp_path / "profile.txt")
    runs = {}
    for on in (False, True):
        model, _ = gpt.build(cfg)
        engine = deepspeed_tpu_torch.initialize(model=model, config=_config(
            flops_profiler={"enabled": on, "profile_step": 2, "output_file": out}),
            device="cpu")[0]
        runs[on] = [float(engine.train_batch(_batch(s))["loss"]) for s in range(3)]
    assert runs[True] == runs[False]  # profiling takes no step
    prof = engine._flops_profiler
    want = _analytic_step_flops(4, SEQ, cfg)
    assert prof.get_total_flops() == pytest.approx(want, rel=1e-3)
    assert prof.get_total_flops() == want and prof.profile["kernel_flops"] == {}
    text = open(out).read()
    assert "profile step:                   2" in text
    assert f"fwd+bwd flops per step:         {tfp.number_to_string(want, 'FLOPs')}" in text
    assert "(layers x2)" in text and "(optimizer)" in text
    assert prof.get_total_params() == sum(t.numel() for t in tree_leaves(engine.state["params"]))
    prof.start_profile()
    gpt.forward(cfg, engine.state["params"], torch.from_numpy(_batch(0)["input_ids"]),
                train=False)
    prof.stop_profile()
    assert prof.get_total_flops() == want // 3


def test_profiler_total_within_the_bound_of_jax_cost_analysis():
    kw = {**TINY, "n_layer": 1}
    jcfg = JaxGPTConfig(**kw)
    jparams = jax_gpt.init_params(jcfg, jax.random.PRNGKey(0))
    ids = _batch(0)["input_ids"]
    lowered = jax.jit(jax.grad(lambda p: jax_gpt.loss_fn(
        jcfg, p, {"input_ids": jnp.asarray(ids)})[0])).lower(jparams)
    jax_flops = jfp._cost_analysis(lowered.compile())["flops"]
    cfg = gpt.GPTConfig(**kw)
    params = tree_map(lambda t: t.requires_grad_(True), bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    with tfp.FlopCount() as count:
        loss, _ = gpt.loss_fn(cfg, params, {"input_ids": ids})
        torch.autograd.grad(loss, tree_leaves(params))
    assert count.total == _analytic_step_flops(4, SEQ, cfg)
    assert count.total <= jax_flops <= 1.10 * count.total, (jax_flops, count.total)


def test_kernel_counts_are_the_plain_paths_and_only_while_counting():
    B, T, H, D = 2, 64, 4, 16
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(B, T, H, D)), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    with tfp.FlopCount() as count:
        o = dot_product_attention(q, k, v, causal=True)
        torch.autograd.grad(o.sum(), [q, k, v])
    # B1's forward plus B2's dq and dk/dv: what the plain path counts
    assert count.total == 3 * attention_flops(B, H, T, T, D)
    tfp.add_kernel_flops("flash_attention_fwd", 7)  # no count open: dropped
    with tfp.FlopCount() as outer, tfp.FlopCount() as inner:
        tfp.add_kernel_flops("flash_attention_fwd", 5)
    assert outer.kernels == inner.kernels == {"flash_attention_fwd": 5} and outer.total == 5
    assert not tfp.counting()


def test_number_to_string_module_tree_and_model_profile_match_the_reference():
    for num in (0, 1, 999.994, 1000, 12345.678, 9.99e5, 1e6, 2.5e9, 7.123e12, -3e6, 1e15):
        for units in ("", "FLOPs", "params"):
            assert tfp.number_to_string(num, units) == jfp.number_to_string(num, units)
    cfg = gpt.GPTConfig(**TINY)
    mods = tfp.per_module_profile(cfg, 2, SEQ, n_timing_runs=1, device="cpu",
                                  dtype=torch.float32)
    text = tfp.format_module_tree(mods)
    assert text.startswith("GPT(") and "(layers x2)" in text and "(head)" in text
    layer = mods["units"]["layer"]
    N = 2 * SEQ
    D, F = cfg.d_model, cfg.ffn_dim
    assert layer["fwd"]["flops"] == 2 * N * D * (3 * D + D + 2 * F) + 4 * 2 * SEQ * SEQ * D
    assert layer["bwd"]["flops"] == 2 * layer["fwd"]["flops"]
    model, _ = gpt.build(cfg)
    prof = tfp.get_model_profile(model, _batch(0), device="cpu", n_timing_runs=1)
    assert prof["flops"] == _analytic_step_flops(4, SEQ, cfg) // 3
    assert prof["params"] == cfg.num_params() and prof["latency_s"] > 0
