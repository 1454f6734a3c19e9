"""The port's continuous-batching serving stack vs the JAX package's: the
scheduler under one fake executor, the knobs the port refuses and the A7
knobs it honours, the workload generator, and ``ServingEngine`` end to end.

The end-to-end runs use the JAX serving tests' configuration (GPT 2 layers,
d 32, 4 heads, vocab 64; 3 slots, page 8, model length 64, prefill chunk
16, fp32, decode blocks of 4) and workload (6 open-loop requests of seed 3
plus one prompt longer than a chunk). The weights cross through
``deepspeed_tpu_torch.bridge``. The bar is the reference's own: greedy
tokens identical per request (fp32 on both sides; argmax of logits that
agree to ~1e-6)."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as G
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import for_gpt
from deepspeed_tpu_torch.inference import serving
from deepspeed_tpu_torch.models import gpt as TG


class FakeExecutor:
    """Deterministic device-free executor (the JAX serving tests' own):
    prefill answers last+1, decode answers prev+1 (mod 97). It logs every
    call, so two schedulers can be held to the same executor traffic."""

    def __init__(self, batched=False):
        self.calls = []
        if batched:
            self.prefill_many = self._prefill_many

    def prefill(self, slot, tokens, table_row):
        self.calls.append(("prefill", slot, list(map(int, tokens)), list(map(int, table_row))))
        return (int(tokens[-1]) + 1) % 97

    def _prefill_many(self, items):
        self.calls.append(("prefill_many", [(slot, list(map(int, t)), list(map(int, row)))
                                            for slot, t, row in items]))
        return {slot: (int(t[-1]) + 1) % 97 for slot, t, _ in items}

    def decode(self, tokens, tables, lengths, active, steps=1):
        self.calls.append(("decode", tokens.tolist(), tables.tolist(), lengths.tolist(),
                           active.tolist(), steps))
        return np.stack([(tokens + k + 1) % 97 for k in range(steps)])


# the streams of the JAX scheduler tests: (scheduler kwargs, [(prompt, max_new, eos)], batched)
STREAMS = {
    "mixed": (dict(num_slots=2),
              [(np.arange(n), m, None) for n, m in [(3, 4), (7, 2), (2, 6), (5, 3), (1, 1)]],
              False),
    "deterministic": (dict(num_slots=3), [(np.array([10, 20]), 5, None)], False),
    "preemption": (dict(num_slots=2, num_pages=8, page_size=2, pages_per_seq=8),
                   [(np.array([1, 2, 3]), 8, None), (np.array([50, 51, 52]), 8, None)], False),
    "oversized": (dict(pages_per_seq=2, page_size=4),
                  [(np.zeros(6), 4, None), (np.zeros(2), 3, None)], False),
    "larger_than_pool": (dict(num_pages=3, page_size=4, pages_per_seq=8),
                         [(np.zeros(8), 4, None), (np.zeros(4), 3, None)], False),
    "eos": (dict(num_slots=1), [(np.zeros(1), 20, 4)], False),
    "decode_block_1": (dict(num_slots=2), [(np.arange(3), 9, None)] * 2, False),
    "decode_block_4": (dict(num_slots=2, decode_block=4), [(np.arange(3), 9, None)] * 2, False),
    "prefill_many": (dict(num_slots=3), [(np.array([i]), 2, None) for i in range(3)], True),
}


def _run_stream(pkg, name):
    kw, reqs, batched = STREAMS[name]
    kw = {"num_slots": 2, "num_pages": 16, "page_size": 4, "pages_per_seq": 8,
          "decode_block": 1, **kw}
    ex = FakeExecutor(batched)
    sched = pkg.ContinuousBatchingScheduler(ex, **kw)
    requests = [pkg.Request(prompt=np.asarray(p, np.int32), max_new_tokens=m,
                            eos_token_id=eos) for p, m, eos in reqs]
    verdicts = [(bool(v), v.reason) for v in map(sched.submit, requests)]
    sched.run_to_completion(max_steps=200)
    return {"verdicts": verdicts, "tokens": [r.tokens for r in requests],
            "states": [r.state.value for r in requests],
            "preemptions": [r.preemptions for r in requests], "steps": sched.steps,
            "calls": ex.calls, "audit": sched.audit()["ok"],
            "allocated": sched.allocator.allocated_pages, "idle": sched.idle}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_scheduler_matches_jax_under_one_fake_executor(name):
    """Identical verdicts, tokens, preemption and step counts and executor
    call logs, stream by stream; plus the JAX tests' own assertions."""
    ref = _run_stream(jserving, name)
    out = _run_stream(serving, name)
    assert out == ref
    assert out["audit"] and out["allocated"] == 0 and out["idle"]
    if name == "deterministic":
        assert out["tokens"] == [[21, 22, 23, 24, 25]]
    if name == "preemption":  # newest-admitted yields first
        assert out["preemptions"][0] == 0 and out["preemptions"][1] >= 1
        assert out["tokens"] == [[(4 + i) % 97 for i in range(8)],
                                 [(53 + i) % 97 for i in range(8)]]
    if name in ("oversized", "larger_than_pool"):
        assert out["verdicts"] == [(False, "unservable"), (True, "admitted")]
    if name == "eos":
        assert out["tokens"][0][-1] == 4 and len(out["tokens"][0]) == 4
    if name == "prefill_many":
        assert out["calls"][0][0] == "prefill_many" and len(out["calls"][0][1]) == 3


def test_decode_blocks_batch_steps_without_changing_tokens():
    one, four = _run_stream(serving, "decode_block_1"), _run_stream(serving, "decode_block_4")
    assert one["tokens"] == four["tokens"]
    assert len(four["calls"]) < len(one["calls"])


def test_executor_fault_propagates_and_drain_refuses():
    """A decode that always fails is retried, healed by requeue, and after
    ``dispatch_failure_budget`` failed episodes ends in ``ServingFaultError``
    chained from the device error, with the audit clean (the reference's
    semantics); a drain then refuses new work."""
    class Broken(FakeExecutor):
        def decode(self, *a, **kw):
            raise RuntimeError("device fault")

    sched = serving.ContinuousBatchingScheduler(Broken(), num_slots=1, num_pages=8,
                                                page_size=4, pages_per_seq=4,
                                                dispatch_failure_budget=3,
                                                retry_base_delay=0.001, retry_max_delay=0.002)
    # each healed episode re-prefills, which appends a token: 4 outlast 3 failures
    sched.submit(serving.Request(prompt=np.zeros(2, np.int32), max_new_tokens=4))
    with pytest.raises(serving.ServingFaultError, match="3 consecutive decode") as err:
        sched.run_to_completion(max_steps=50)
    assert isinstance(err.value.__cause__, RuntimeError)
    assert str(err.value.__cause__) == "device fault"
    assert sched.counters["dispatch_failed"] == 3
    assert sched.counters["dispatch_error"] == 3 * (sched.dispatch_retries + 1)
    assert sched.audit()["ok"]
    sched.drain()
    verdict = sched.submit(serving.Request(prompt=np.zeros(2, np.int32), max_new_tokens=3))
    assert not verdict and verdict.reason == "draining"


# ------------------------------------ refused knobs, and A7's and A11's honoured
SCHED_KNOBS = [("max_queue", 8, "A7"), ("ttft_deadline_s", 1.0, "A7"),
               ("dispatch_retries", 0, "A7"), ("quarantine_after", 1, "A7"),
               ("dispatch_failure_budget", 1, "A7"), ("prefix_cache", object(), "A7"),
               ("role", "prefill", "A10"),
               ("tiers", {"interactive": {}}, "A10"), ("recovery_log", object(), "A11"),
               ("watchdog", object(), "A11"), ("page_fingerprints", True, "A11")]


@pytest.mark.parametrize("name,value,item", SCHED_KNOBS, ids=[k[0] for k in SCHED_KNOBS])
def test_scheduler_refuses_unported_arguments(name, value, item):
    """A10 arguments raise naming their item; the A7 and A11 ones, ported,
    are kept as the reference's scheduler keeps them."""
    if item in ("A7", "A11"):
        kw = dict(num_slots=1, num_pages=4, page_size=4, pages_per_seq=2)
        if name == "prefix_cache":
            out = serving.ContinuousBatchingScheduler(FakeExecutor(), **kw,
                                                      prefix_cache=serving.PrefixIndex(4))
            assert isinstance(out.prefix_cache, serving.PrefixIndex)
            return
        ref = jserving.ContinuousBatchingScheduler(FakeExecutor(), **kw, **{name: value})
        out = serving.ContinuousBatchingScheduler(FakeExecutor(), **kw, **{name: value})
        assert getattr(out, name) == getattr(ref, name) == value
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        serving.ContinuousBatchingScheduler(FakeExecutor(), num_slots=1, num_pages=4,
                                            page_size=4, pages_per_seq=2, **{name: value})
    # the reference's default is accepted
    default = inspect.signature(jserving.ContinuousBatchingScheduler).parameters[name].default
    serving.ContinuousBatchingScheduler(FakeExecutor(), num_slots=1, num_pages=4, page_size=4,
                                        pages_per_seq=2, **{name: default})


# the ServingConfig fields A7 ported: the scheduler attribute each reaches
A7_CONFIG_KNOBS = {"enable_prefix_cache": "prefix_cache", "max_queue": "max_queue",
                   "max_queued_tokens": "max_queued_tokens", "shed_policy": "shed_policy",
                   "ttft_deadline_s": "ttft_deadline_s", "request_deadline_s": "deadline_s",
                   "dispatch_retries": "dispatch_retries", "quarantine_after": "quarantine_after",
                   "dispatch_failure_budget": "dispatch_failure_budget"}
# the fields A11 ported: what each reaches in the scheduler or its watchdog
A11_CONFIG_KNOBS = {
    "page_fingerprints": lambda sc: sc.page_fingerprints,
    "pages_scan_per_step": lambda sc: sc.pages_scan_per_step,
    "prefill_deadline_s": lambda sc: sc.watchdog.deadlines["serving_prefill"],
    "decode_deadline_s": lambda sc: (sc.watchdog.deadlines["serving_decode"],
                                     sc.watchdog.deadlines["serving_verify"]),
    "watchdog_poll_s": lambda sc: sc.watchdog.poll_interval,
    "stacks_dir": lambda sc: sc.watchdog.stacks_dir}
CONFIG_KNOBS = [(f.name, item) for item, names in
                [("A7", tuple(A7_CONFIG_KNOBS)), ("A11", tuple(A11_CONFIG_KNOBS))]
                + list(serving.engine._UNPORTED_KNOBS.items())
                for f in dataclasses.fields(serving.ServingConfig) if f.name in names]


def test_every_serving_config_field_is_the_references():
    ref = {f.name: f.default for f in dataclasses.fields(jserving.ServingConfig)}
    out = {f.name: f.default for f in dataclasses.fields(serving.ServingConfig)}
    assert out == ref


def _knob_value(name, default):
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 1
    return {"shed_policy": "reject_largest", "role": "decode", "max_queue": 8,
            "max_queued_tokens": 4096, "ttft_deadline_s": 1.0,
            "request_deadline_s": 30.0, "prefill_deadline_s": 5.0,
            "decode_deadline_s": 5.0, "stacks_dir": "stacks"}.get(name, "set")


@pytest.mark.parametrize("name,item", CONFIG_KNOBS, ids=[k[0] for k in CONFIG_KNOBS])
def test_serving_config_refuses_unported_knobs(name, item, weights):
    """A10 / A14 knobs raise naming their item; each A7 and A11 knob reaches
    the scheduler ``make_scheduler()`` builds (or its watchdog) with the value
    the JAX engine's ``make_scheduler()`` gives it."""
    value = _knob_value(name, getattr(serving.ServingConfig(), name))
    if item == "A11":
        # the watchdog's knobs need a phase deadline for a watchdog to exist
        over = {"max_model_len": 64, "decode_deadline_s": 5.0, name: value}
        ref = jserving.ServingEngine(CFG, weights[0],
                                     jserving.ServingConfig(**over)).make_scheduler()
        out = serving.ServingEngine(TCFG, params_from_numpy(weights[1], "cpu"),
                                    serving.ServingConfig(**over), device="cpu").make_scheduler()
        try:
            got, want = A11_CONFIG_KNOBS[name](out), A11_CONFIG_KNOBS[name](ref)
            assert got == want and (got == value or got == (value, value))
        finally:
            out.close()
            ref.close()
        return
    if item == "A7":
        over = {"max_model_len": 64, name: value}
        ref = jserving.ServingEngine(CFG, weights[0],
                                     jserving.ServingConfig(**over)).make_scheduler()
        out = serving.ServingEngine(TCFG, params_from_numpy(weights[1], "cpu"),
                                    serving.ServingConfig(**over), device="cpu").make_scheduler()
        attr = A7_CONFIG_KNOBS[name]
        if name == "enable_prefix_cache":
            assert isinstance(out.prefix_cache, serving.PrefixIndex)
            assert out.prefix_cache.page_size == ref.prefix_cache.page_size == 64
        else:
            assert getattr(out, attr) == getattr(ref, attr) == value
        return
    cfg = TG.PRESETS["tiny"]
    params = TG.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        serving.ServingEngine(cfg, params, serving.ServingConfig(**{name: value}), device="cpu")


def test_serving_engine_refuses_auto_slots_monitor_and_draft(monkeypatch):
    """``num_slots="auto"`` raises naming its item; ``monitor`` (A11) is kept
    and fed the ``Serving/*`` trail through the recovery log
    ``make_scheduler`` makes for it and ``Serving/compile_events``;
    ``draft`` (the draft model of speculative decoding) is accepted and
    kept."""
    cfg = TG.PRESETS["tiny"]
    params = TG.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A14"):
        serving.ServingEngine(cfg, params, device="cpu",
                              serving=serving.ServingConfig(num_slots="auto"))

    class Monitor:
        def __init__(self):
            self.events = []

        def write_events(self, events):
            self.events.extend(events)

    mon = Monitor()
    eng = serving.ServingEngine(cfg, params, serving.ServingConfig(max_model_len=64),
                                monitor=mon, device="cpu")
    assert eng.monitor is mon
    sched = eng.make_scheduler()
    assert sched.recovery_log.monitor is mon and sched.recovery_log.prefix == "Serving"
    sched.drain()
    eng.decode(np.zeros(eng.num_slots, np.int32),
               np.zeros((eng.num_slots, eng.serving.pages_per_seq), np.int32),
               np.zeros(eng.num_slots, np.int32), np.zeros(eng.num_slots, bool))
    assert [e[0] for e in mon.events] == ["Serving/drain_started", "Serving/compile_events"]
    draft = (cfg, params)
    eng = serving.ServingEngine(cfg, params, serving.ServingConfig(
        max_model_len=64, spec_drafter="draft_model"), draft=draft, device="cpu")
    assert eng.draft is draft
    assert isinstance(eng.make_scheduler().drafter, serving.DraftModelDrafter)
    # device=None means the CUDA device, and raises where there is none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        serving.ServingEngine(cfg, params, serving.ServingConfig(max_model_len=64))


def test_open_loop_workload_draws_the_references():
    ref = jserving.make_open_loop_workload(24, 8.0, (32, 128), (16, 96), 50304, seed=0)
    out = serving.make_open_loop_workload(24, 8.0, (32, 128), (16, 96), 50304, seed=0)
    for a, b in zip(ref, out):
        assert a.arrival_time == b.arrival_time and a.max_new_tokens == b.max_new_tokens
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert serving.percentile([3.0, 1.0, 2.0], 50) == jserving.percentile([3.0, 1.0, 2.0], 50)


# -------------------------------------------------------------- end to end
CFG = G.GPTConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4, max_seq_len=128)
TCFG = TG.GPTConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4, max_seq_len=128)
BASE = dict(num_slots=3, page_size=8, max_model_len=64, prefill_chunk=16, dtype="float32",
            decode_block=4)


@pytest.fixture(scope="module")
def weights():
    jparams = G.init_params(CFG, jax.random.PRNGKey(0))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _workload(pkg):
    """Every request present at the start: the admissions, and with them the
    step and preemption counts, then depend on steps only, not on how fast
    each engine's first steps run on a loaded host."""
    wl = pkg.make_open_loop_workload(6, rate_rps=1e4, prompt_len=(3, 30), max_new=(2, 8),
                                     vocab_size=64, seed=3)
    # one prompt longer than a chunk, for the chunked prefill path
    wl.append(pkg.Request(prompt=np.arange(20, dtype=np.int32) + 1, max_new_tokens=4))
    for r in wl:
        r.arrival_time = 0.0
    return wl


@pytest.mark.parametrize("over", [{}, {"num_pages": 5}, {"kv_bits": 8}],
                         ids=["dense", "preemption", "kv8"])
def test_served_tokens_match_the_jax_engine(weights, over):
    """Every request's tokens equal the JAX ServingEngine's; so do the
    preemption and decode-step counts. A pool of 4 usable pages forces
    preemption; kv8 serves from int8 pools."""
    jparams, np_params = weights
    ref_wl, wl = _workload(jserving), _workload(serving)
    ref = jserving.run_continuous(
        jserving.ServingEngine(CFG, jparams, jserving.ServingConfig(**BASE, **over)), ref_wl)
    eng = serving.ServingEngine(TCFG, params_from_numpy(np_params, "cpu"),
                                serving.ServingConfig(**BASE, **over), device="cpu")
    rep = serving.run_continuous(eng, wl)
    assert rep["finished"] == len(wl) and rep["pool_audit_ok"]
    assert [r.tokens for r in wl] == [r.tokens for r in ref_wl]
    for key in ("preemptions", "decode_steps", "total_tokens"):
        assert rep[key] == ref[key], key
    if over.get("num_pages"):
        assert rep["preemptions"] >= 1
    if over.get("kv_bits"):
        assert eng.paged_cache["k_pages"].dtype == torch.int8
        assert eng.kv_bytes_per_token() < 4 * CFG.n_layer * CFG.n_head * CFG.head_dim


def test_serving_config_eos_token_id_is_inert(weights):
    """``ServingConfig.eos_token_id`` is accepted and read by nothing, in the
    port as in the reference: both engines built with it set serve the
    tokens of the port's engine without it."""
    jparams, np_params = weights
    ref_wl, wl, plain_wl = _workload(jserving), _workload(serving), _workload(serving)
    serving.run_continuous(serving.ServingEngine(
        TCFG, params_from_numpy(np_params, "cpu"), serving.ServingConfig(**BASE),
        device="cpu"), plain_wl)
    eos = plain_wl[0].tokens[0]  # a token every run emits first for request 0
    jserving.run_continuous(jserving.ServingEngine(
        CFG, jparams, jserving.ServingConfig(**BASE, eos_token_id=eos)), ref_wl)
    serving.run_continuous(serving.ServingEngine(
        TCFG, params_from_numpy(np_params, "cpu"),
        serving.ServingConfig(**BASE, eos_token_id=eos), device="cpu"), wl)
    assert [r.tokens for r in wl] == [r.tokens for r in ref_wl] == [r.tokens for r in plain_wl]


def test_served_tokens_match_generate_and_gather(weights):
    """The port's served tokens equal its own greedy ``generate`` per request
    and the ``kernel_impl="gather"`` engine's; after warmup, traffic hits
    only shapes already seen."""
    _, np_params = weights
    params = params_from_numpy(np_params, "cpu")
    runs = []
    for impl in (None, "gather"):
        eng = serving.ServingEngine(TCFG, params, serving.ServingConfig(**BASE, kernel_impl=impl),
                                    device="cpu")
        eng.warmup()
        seen = len(eng.compile_log)
        wl = _workload(serving)
        serving.run_continuous(eng, wl)
        assert len(eng.compile_log) == seen, eng.compile_log[seen:]
        runs.append([r.tokens for r in wl])
    assert runs[0] == runs[1]
    ie = init_inference(for_gpt(TCFG, params), dtype="float32", device="cpu")
    for r, toks in zip(_workload(serving), runs[0]):
        ref = ie.generate(np.asarray(r.prompt)[None], max_new_tokens=r.max_new_tokens)
        assert ref[0, len(r.prompt):].tolist() == toks


def test_static_baseline_serves_the_same_tokens(weights):
    """Prompts of one length (the baseline right-pads a batch to its longest
    prompt), so each row's tokens are its own ``generate``'s."""
    _, np_params = weights
    params = params_from_numpy(np_params, "cpu")
    ie = init_inference(for_gpt(TCFG, params), dtype="float32", device="cpu")
    rng = np.random.default_rng(4)
    wl = [serving.Request(prompt=rng.integers(0, 64, 10).astype(np.int32), max_new_tokens=m,
                          arrival_time=0.001 * i) for i, m in enumerate((3, 5, 4))]
    rep = serving.run_static_baseline(ie, wl, batch_size=3)
    assert rep["mode"] == "static" and rep["finished"] == 3
    for r in wl:
        ref = ie.generate(np.asarray(r.prompt)[None], max_new_tokens=r.max_new_tokens)
        assert r.tokens == ref[0, len(r.prompt):].tolist()


def test_saturation_estimate_runs_a_closed_loop(weights):
    _, np_params = weights
    eng = serving.ServingEngine(TCFG, params_from_numpy(np_params, "cpu"),
                                serving.ServingConfig(**BASE), device="cpu")
    rps = serving.estimate_saturation_rps(eng, (3, 10), (2, 5), 64, n_requests=4)
    assert rps > 0 and eng.last_scheduler.idle and eng.last_scheduler.audit()["ok"]
