"""The port's serving resilience against the JAX package's: each chaos case
of ``tests/test_serving_chaos.py`` (a dispatch raised once and through a
whole episode, a failing block shape, a dead executor, a stalled prefill
under the serving watchdog, a failed page allocation, deadlines under
load) run by both schedulers on the same device-free executor and fault
plan leaves the same tokens, counters and recovery-event trail; a failed
allocation in a claim that borrowed prefix pages unwinds them; a flipped
KV page is caught at share time, by the background scan and by the audit
at the same scheduler step in both; the serving engines' page
fingerprints and bit flip agree over dense, int8 and int4 pools (under
``crc32``, named); and end to end on the CPU a flipped shared page is
healed with the cache-off run's tokens. Trails compare every event's name,
step, value and fields, with rids mapped to request indices and the
free-text ``detail`` / ``error`` fields left out."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import deepspeed_tpu.resilience as jres
import deepspeed_tpu_torch.resilience as tres
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as G
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import serving
from deepspeed_tpu_torch.models import gpt as TG

PKGS = ((jserving, jres), (serving, tres))


@pytest.fixture(autouse=True)
def _no_plans():
    tres.install_plan(None)
    jres.install_plan(None)
    yield
    tres.install_plan(None)
    jres.install_plan(None)


class FakeExecutor:
    """Prefill answers last+1, decode prev+1 (mod 97), the JAX chaos tests'
    executor. ``fail_steps``: decode blocks of that many steps raise;
    ``dead``: every decode raises. With ``page_size`` it also keeps each
    page's content (the tokens written at its positions), so pages can be
    fingerprinted and flipped like the card's pools."""

    def __init__(self, fail_steps=None, dead=False, page_size=None):
        self.fail_steps, self.dead, self.ps = fail_steps, dead, page_size
        self.pages = {}

    def _write(self, page, offset, token):
        if self.ps:
            buf = self.pages.setdefault(int(page), np.zeros(self.ps, np.int32))
            buf[offset] = token

    def prefill(self, slot, tokens, table_row, start=0):
        for pos in range(int(start), len(tokens)):
            self._write(table_row[pos // self.ps] if self.ps else 0,
                        pos % self.ps if self.ps else 0, tokens[pos])
        return (int(tokens[-1]) + 1) % 97

    def decode(self, tokens, tables, lengths, active, steps=1):
        if self.dead or steps == self.fail_steps:
            raise RuntimeError(f"decode block of {steps} steps fails")
        out = np.stack([(tokens + k + 1) % 97 for k in range(steps)])
        if self.ps:
            for s in np.flatnonzero(active):
                for k in range(steps):
                    pos = int(lengths[s]) + k
                    self._write(tables[s, pos // self.ps], pos % self.ps,
                                tokens[s] if k == 0 else out[k - 1, s])
        return out

    def fingerprint_pages(self, page_ids):
        return [tres.fingerprint_bytes(self.pages.get(int(p), np.zeros(self.ps, np.int32))
                                       .tobytes(), "crc32") for p in page_ids]

    def corrupt_page_bit(self, page):
        self.pages[int(page)].view(np.uint8)[2] ^= 0x01


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


SPEC = ((3, 6), (5, 4), (2, 8), (4, 3))


def run(pkgs, plan=None, spec=SPEC, executor=None, requests=None, clock_dt=None,
        watchdog=None, steps=500, audit_each_step=False, **kw):
    """One scheduler of ``pkgs`` over the workload: tokens, counters, the
    normalized trail, the exception raised (type name) and the audits."""
    ser, res = pkgs
    if plan is not None:
        res.install_plan(res.FaultPlan(**plan))
    log = res.RecoveryLog(role="serving", prefix="Serving")
    events = []
    original = log.record

    def record(event, value=1.0, step=0, **fields):
        events.append((event, step, value, fields))
        original(event, value=value, step=step, **fields)

    log.record = record
    clock = ManualClock()
    wd = None
    if watchdog:
        wd = res.HealthWatchdog(watchdog, poll_interval=0.01, recovery_log=log).start()
    kw.setdefault("retry_base_delay", 0.001)
    kw.setdefault("retry_max_delay", 0.002)
    sched = ser.ContinuousBatchingScheduler(
        executor or FakeExecutor(), num_slots=kw.pop("num_slots", 2),
        num_pages=kw.pop("num_pages", 32), page_size=kw.pop("page_size", 4),
        pages_per_seq=kw.pop("pages_per_seq", 8), clock=clock, recovery_log=log,
        watchdog=wd, **kw)
    reqs = (requests(ser) if requests else
            [ser.Request(prompt=np.arange(1, n + 1, dtype=np.int32), max_new_tokens=m)
             for n, m in spec])
    index = {r.rid: i for i, r in enumerate(reqs)}
    raised, audits = None, []
    try:
        for r in reqs:
            sched.submit(r)
        for _ in range(steps):
            if sched.idle:
                break
            sched.step()
            if audit_each_step:
                rep = sched.audit()
                audits.append((sched.steps, rep["ok"], rep.get("mismatches")))
            if clock_dt:
                clock.t += clock_dt
    except Exception as e:  # the schedulers must fail alike
        raised = type(e).__name__
    finally:
        if wd is not None:
            wd.stop()
        res.install_plan(None)
    trail = []
    for event, step, value, fields in events:
        f = {k: (index.get(v, v) if k == "rid" else v) for k, v in fields.items()
             if k not in ("detail", "error")}
        if event.startswith("watchdog_"):  # the wall clock's: kind and phase only
            value, f = None, {"phase": f.get("phase")}
        trail.append((event, step, value, tuple(sorted(f.items()))))
    return {"tokens": [list(r.tokens) for r in reqs], "counters": dict(sched.counters),
            "trail": trail, "raised": raised, "audits": audits,
            "audit_ok": sched.audit()["ok"], "allocated": sched.allocator.allocated_pages}


CASES = {
    "raise_retried_in_place": dict(plan={"dispatch_raise_at": 2}),
    "raise_heals_by_requeue": dict(plan={"dispatch_raise_at": 3, "dispatch_raise_times": 3},
                                   decode_block=4, dispatch_retries=2),
    "failing_block_quarantined": dict(spec=((3, 9), (5, 9)), decode_block=4,
                                      dispatch_retries=1, quarantine_after=2,
                                      executor=lambda: FakeExecutor(fail_steps=4)),
    "dead_executor_budget": dict(spec=((1, 4),), dispatch_retries=0,
                                 dispatch_failure_budget=3,
                                 executor=lambda: FakeExecutor(dead=True)),
    "alloc_failure_queues": dict(plan={"alloc_fail_at": 0, "alloc_fail_times": 1}),
    "alloc_failure_at_growth": dict(plan={"alloc_fail_at": 3, "alloc_fail_times": 2},
                                    num_slots=3),
    "deadlines_under_load": dict(spec=((3, 6), (5, 4), (2, 8)), num_slots=1,
                                 deadline_s=6.5, clock_dt=1.0),
    "queue_cap_sheds": dict(max_queue=2, shed_policy="reject_largest"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chaos_case_trail_equals_the_references(case):
    kw = dict(CASES[case])
    make = kw.pop("executor", None)
    outs = [run(pkgs, executor=make() if make else None, **kw) for pkgs in PKGS]
    assert outs[0] == outs[1]
    assert outs[1]["audit_ok"]
    if case == "dead_executor_budget":
        assert outs[1]["raised"] == "ServingFaultError"
    else:
        assert outs[1]["raised"] is None and outs[1]["allocated"] == 0
        clean = run(PKGS[1], spec=kw.get("spec", SPEC))["tokens"]
        if "deadline" not in case and "queue" not in case:
            assert outs[1]["tokens"] == clean  # healed runs are greedy-identical


def test_stalled_prefill_is_flagged_by_the_serving_watchdog():
    """An injected prefill stall past the ``serving_prefill`` deadline is
    flagged (a stall, then its recovery), and the tokens are the clean
    run's, in both packages."""
    outs = [run(pkgs, plan={"dispatch_stall_at": 0, "dispatch_stall_seconds": 0.25},
                watchdog={"serving_prefill": 0.05, "serving_decode": 5.0}) for pkgs in PKGS]
    assert outs[0] == outs[1]
    events = [t[0] for t in outs[1]["trail"]]
    assert events.count("watchdog_stall") == events.count("watchdog_recovered") == 1
    assert outs[1]["tokens"] == run(PKGS[1])["tokens"]


# ---------------------------------------------------------- page fingerprints
def _shared_prompt_requests(ser):
    """Four requests behind the same two full prompt pages (page size 4):
    the first runs long, the second ends at once, so the third shares the
    first's pages from step 2."""
    head = np.arange(1, 9, dtype=np.int32)
    return [ser.Request(prompt=np.concatenate([head, np.asarray(t, np.int32)]),
                        max_new_tokens=m) for t, m in (([20], 12), ([21, 22], 2),
                                                       ([23], 8), ([24], 4))]


@pytest.mark.parametrize("where,scan,flip_at", [("scan", 8, 3), ("share", 0, 1),
                                                 ("audit", 0, 3)])
def test_page_flip_is_caught_at_the_same_step(where, scan, flip_at):
    """A bit flipped in a stamped prompt page: with the scan on, the scan
    catches it at the flip's step; with it off, a flip before the page is
    shared is caught when the next admission would share it, and a flip of
    a page already shared is caught by the audit over shared pages. Both
    packages name the same page at the same step; a detected page is healed
    (its borrowers re-prefill) and the tokens are the clean run's."""
    kw = dict(plan={"flip_bit_at": flip_at, "flip_bit_domain": "kv_page"},
              requests=_shared_prompt_requests, page_fingerprints=True,
              pages_scan_per_step=scan, audit_each_step=True)
    outs = [run((ser, res), executor=FakeExecutor(page_size=4),
                prefix_cache=ser.PrefixIndex(4), **kw) for ser, res in PKGS]
    assert outs[0] == outs[1]
    out = outs[1]
    events = [(e, step, dict(f)) for e, step, _, f in out["trail"]]
    flips = [(step, f["page"]) for e, step, f in events if e == "chaos_injected"]
    assert len(flips) == 1
    detected = [(step, f["context"], f["page"]) for e, step, f in events
                if e == "sdc_detected"]
    failed_audits = [(step, mism) for step, ok, mism in out["audits"] if not ok]
    if where == "audit":
        # shared when it rotted: the audit names it from the flip's step on
        assert failed_audits[0] == (flips[0][0] + 1, [flips[0][1]])
        assert all(step > failed_audits[0][0] for step, _, _ in detected)
    else:
        assert detected[0][1:] == (where, flips[0][1]) and not failed_audits
        assert [f["context"] for e, _, f in events if e == "sdc_healed"] == [where]
    clean = run(PKGS[1], executor=FakeExecutor(page_size=4),
                requests=_shared_prompt_requests, prefix_cache=serving.PrefixIndex(4))
    assert out["tokens"] == clean["tokens"] and out["audit_ok"]


def _claims_failed_at_the_first_borrow(ser, res):
    """The shared-prompt workload with ``alloc_fail_at`` armed at the first
    admission claim that borrows prefix pages. Returns each failed claim's
    trace (borrowed pages, claimed, still queued, refcounts as before,
    audit), the tokens, the final audit, and the scheduler."""
    plan = res.FaultPlan()
    res.install_plan(plan)
    sched = ser.ContinuousBatchingScheduler(
        FakeExecutor(page_size=4), num_slots=2, num_pages=32, page_size=4, pages_per_seq=8,
        clock=ManualClock(), prefix_cache=ser.PrefixIndex(4))
    original, claims = sched._claim_pages, []

    def claim(req, need):
        hashes = ser.prefix_chain_hashes(np.asarray(req.prompt), 4)
        borrowed = len(sched.prefix_cache.lookup_chain(hashes)[:need])
        if plan.alloc_fail_at is None and borrowed:
            plan.alloc_fail_at = sched.allocator._alloc_calls
        alloc = sched.allocator
        refs = {p: alloc.refcount(p) for p in alloc.allocated_ids}
        out = original(req, need)
        if plan.alloc_fail_at == alloc._alloc_calls - 1:
            claims.append((sched.steps, borrowed, out is not None, req in sched.queue,
                           refs == {p: alloc.refcount(p) for p in alloc.allocated_ids},
                           sched.audit()["ok"]))
        return out

    sched._claim_pages = claim
    reqs = _shared_prompt_requests(ser)
    try:
        for r in reqs:
            sched.submit(r)
        while not sched.idle:
            sched.step()
    finally:
        res.install_plan(None)
    return claims, [list(r.tokens) for r in reqs], sched.audit()["ok"], sched


def test_failed_borrowing_claim_unwinds_and_queues():
    """An injected allocation failure in a claim that has already taken
    references on borrowed prefix pages: the claim gives them back (every
    refcount as before), the request stays queued, the audit is clean, and
    it is admitted later with the clean run's tokens, in both packages; the
    port's allocator counts the one injected failure."""
    outs = [_claims_failed_at_the_first_borrow(*pkgs) for pkgs in PKGS]
    assert outs[0][:3] == outs[1][:3]
    claims, tokens, audit_ok, sched = outs[1]
    assert len(claims) == 1 and claims[0][1] > 0
    assert claims[0][2:] == (False, True, True, True)
    assert audit_ok and sched.allocator._alloc_faults == 1
    clean = run(PKGS[1], executor=FakeExecutor(page_size=4),
                requests=_shared_prompt_requests, prefix_cache=serving.PrefixIndex(4))
    assert tokens == clean["tokens"]


# -------------------------------------------------------------- the engines
CFG = G.GPTConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4, max_seq_len=128)
TCFG = TG.GPTConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4, max_seq_len=128)
BASE = dict(num_slots=3, page_size=8, max_model_len=64, prefill_chunk=16, dtype="float32",
            decode_block=4)


@pytest.fixture(scope="module")
def weights():
    jparams = G.init_params(CFG, jax.random.PRNGKey(0))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_engine_page_fingerprints_and_flip_match_the_references(kv_bits, weights,
                                                                 monkeypatch):
    """Over the same pool contents (dense fp32, int8 and int4 with their
    scales), ``fingerprint_pages`` of both engines agree page for page, and
    ``corrupt_page_bit`` flips the same bit (the pools stay bitwise equal)."""
    monkeypatch.setenv("DS_CHECKPOINT_CHECKSUM", "crc32")
    jparams, np_params = weights
    cfgs = dict(BASE, kv_bits=kv_bits)
    jeng = jserving.ServingEngine(CFG, jparams, jserving.ServingConfig(**cfgs))
    teng = serving.ServingEngine(TCFG, params_from_numpy(np_params, "cpu"),
                                 serving.ServingConfig(**cfgs), device="cpu")
    rng = np.random.default_rng(0)
    for key, arr in teng.paged_cache.items():
        data = (rng.integers(-100, 100, arr.shape) if not arr.is_floating_point()
                else rng.standard_normal(arr.shape)).astype(np.asarray(jeng.paged_cache[key]).dtype)
        arr.copy_(serving.engine.torch.from_numpy(data))
        jeng.paged_cache[key] = jnp.asarray(data)
    pages = [1, 5, 2, 9]
    assert teng.fingerprint_pages(pages) == jeng.fingerprint_pages(pages)
    teng.corrupt_page_bit(5)
    jeng.corrupt_page_bit(5)
    for key, arr in teng.paged_cache.items():
        np.testing.assert_array_equal(arr.numpy(), np.asarray(jeng.paged_cache[key]))
    after = teng.fingerprint_pages(pages)
    assert after == jeng.fingerprint_pages(pages)
    assert [a != b for a, b in zip(after, jeng.fingerprint_pages(pages))] == [False] * 4


def _chat_workload(pkg):
    sysp = (np.arange(16, dtype=np.int32) * 7 + 3) % 64
    wl = pkg.make_open_loop_workload(7, rate_rps=1e4, prompt_len=(3, 20), max_new=(2, 8),
                                     vocab_size=64, seed=3)
    return [pkg.Request(prompt=np.concatenate([sysp, r.prompt]), max_new_tokens=r.max_new_tokens)
            for r in wl]


def test_engine_heals_a_flipped_shared_page_end_to_end(weights, tmp_path):
    """The port's engine with the prefix cache, page fingerprints and a scan
    of 8 pages a step (every stamped page of this small pool): a flip in a
    system-prompt page is detected by the scan at the flip's step and
    healed, and every request's tokens equal the cache-off run's, with a
    failed page allocation on the way; a run without a fault records no
    ``sdc_detected``; the events reach the recovery log and its monitor."""
    _, np_params = weights
    params = params_from_numpy(np_params, "cpu")
    toks = {}
    for name, over, plan in (
            ("off", dict(enable_prefix_cache=False), None),
            ("clean", dict(enable_prefix_cache=True, page_fingerprints=True,
                           pages_scan_per_step=8), None),
            ("flip", dict(enable_prefix_cache=True, page_fingerprints=True,
                          pages_scan_per_step=8),
             {"flip_bit_at": 3, "flip_bit_domain": "kv_page", "alloc_fail_at": 5})):
        seen = []
        mon = type("M", (), {"write_events": lambda self, ev: seen.extend(ev)})()
        eng = serving.ServingEngine(TCFG, params, serving.ServingConfig(**BASE, **over),
                                    monitor=mon, device="cpu")
        if plan:
            tres.install_plan(tres.FaultPlan(**plan))
        log = tres.RecoveryLog.for_dir(str(tmp_path / name), monitor=mon, role="serving",
                                       prefix="Serving")
        wl = _chat_workload(serving)
        rep = serving.run_continuous(eng, wl, scheduler=eng.make_scheduler(recovery_log=log))
        tres.install_plan(None)
        assert rep["finished"] == len(wl) and rep["pool_audit_ok"]
        toks[name] = [r.tokens for r in wl]
        events = [e["event"] for e in tres.read_events(str(tmp_path / name))]
        if name == "clean":
            assert "sdc_detected" not in events
        if name == "flip":
            assert events.index("chaos_injected") < events.index("sdc_detected") < \
                events.index("sdc_healed")
            assert any(n == "Serving/sdc_healed" for n, _, _ in seen)
    assert toks["clean"] == toks["off"] and toks["flip"] == toks["off"]
