"""The port's speculation host half vs the JAX package's: the n-gram
drafter, the draft-length ladder and its adaptive controller, and the
scheduler's speculation step under one fake executor (the JAX speculation
tests' own), stream by stream.

Everything here is host arithmetic on integers, so the bar is equality:
proposals, ladders, controller trajectories, served tokens, ``spec_stats``,
event counters and executor call logs."""

import numpy as np
import pytest

from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.inference.serving import speculate as jspec
from deepspeed_tpu_torch.inference import serving
from deepspeed_tpu_torch.inference.serving import speculate as tspec


# ------------------------------------------------------------------ drafters
def _contexts():
    """Seeded random contexts over small and large vocabularies, repetitive
    ones (a constant run, period-2 and period-5 cycles with noise), and the
    reference tests' hand-made ones."""
    rng = np.random.default_rng(0)
    out = [(rng.integers(0, vocab, n), rng.integers(0, vocab, m).tolist())
           for vocab, n, m in [(4, 12, 5), (8, 30, 10), (64, 40, 0), (3, 3, 3), (50304, 20, 4)]]
    cyc = np.array([1, 2] * 8)
    noisy = np.tile(np.arange(5), 6)
    noisy[rng.integers(0, len(noisy), 4)] = 9
    out += [(np.full(10, 5), []), (cyc, [1, 2, 1]), (noisy, [0, 1]),
            (np.array([1, 7, 8, 9, 4, 5, 6, 7, 8]), []), (np.array([5, 6, 7]), [8, 5, 6]),
            (np.array([1, 2, 9, 8, 7, 1, 2, 3, 1, 2]), []), (np.array([1, 2, 9, 8, 7, 1, 2]), []),
            (np.arange(10), []), (np.array([3]), []), (np.array([], np.int64), [])]
    return out


@pytest.mark.parametrize("max_n", [1, 2, 3, 4])
def test_ngram_proposals_are_the_references(max_n):
    """Every context, every k from 0 to 8, every order up to ``max_n``."""
    for min_n in range(1, max_n + 1):
        ref, out = jspec.NGramDrafter(max_n, min_n), tspec.NGramDrafter(max_n, min_n)
        for prompt, toks in _contexts():
            prompt = np.asarray(prompt, np.int32)
            for k in range(9):
                a = ref.draft(0, 0, prompt, toks, k)
                b = out.draft(0, 0, prompt, toks, k)
                assert b.dtype == np.int32 and b.tolist() == a.tolist(), (prompt, toks, k)
    with pytest.raises(ValueError):
        tspec.NGramDrafter(max_n=1, min_n=2)


def test_spec_k_ladder_is_the_references():
    for k in range(1, 20):
        assert tspec.spec_k_ladder(k) == jspec.spec_k_ladder(k)
    assert tspec.spec_k_ladder(16) == (1, 2, 4, 8, 16)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="spec_k"):
            tspec.spec_k_ladder(bad)
        with pytest.raises(ValueError):
            jspec.spec_k_ladder(bad)


@pytest.mark.parametrize("adaptive", [True, False])
def test_adaptive_spec_k_follows_the_references_trajectory(adaptive):
    rng = np.random.default_rng(1)
    offered = rng.integers(0, 17, 200)
    rates = np.concatenate([np.zeros(40), np.ones(60), rng.uniform(0, 1, 100)])
    accepted = (offered * rates).astype(int)
    ref = jspec.AdaptiveSpecK(jspec.spec_k_ladder(16), adaptive=adaptive)
    out = tspec.AdaptiveSpecK(tspec.spec_k_ladder(16), adaptive=adaptive)
    levels = set()
    for o, a in zip(offered.tolist(), accepted.tolist()):
        ref.observe(o, a)
        out.observe(o, a)
        assert (out.level, out.k, out.ema) == (ref.level, ref.k, ref.ema)
        levels.add(out.level)
    assert len(levels) > 1 if adaptive else levels == {4}
    with pytest.raises(ValueError):
        tspec.AdaptiveSpecK(())


# --------------------------------------------------------- scheduler (fake)
class SpecFakeExecutor:
    """The JAX speculation tests' deterministic executor: the 'model'
    continues any token as prev + 1 (mod 97), and acceptance, eos and budget
    follow the verify program's rules. It logs every call."""

    def __init__(self):
        self.calls = []

    def prefill(self, slot, tokens, table_row, start=0):
        self.calls.append(("prefill", slot, list(map(int, tokens)), list(map(int, table_row))))
        return (int(tokens[-1]) + 1) % 97

    def decode(self, tokens, tables, lengths, active, steps=1):
        self.calls.append(("decode", tokens.tolist(), tables.tolist(), lengths.tolist(), steps))
        return np.stack([(tokens + k + 1) % 97 for k in range(steps)])

    def verify(self, tokens, tables, lengths, active, eos, budget):
        self.calls.append(("verify", tokens.tolist(), tables.tolist(), lengths.tolist(),
                           active.tolist(), eos.tolist(), budget.tolist()))
        outs = (tokens + 1) % 97
        agree = (tokens[:, 1:] == outs[:, :-1]).astype(np.int64)
        n = 1 + np.cumprod(agree, axis=1).sum(axis=1)
        is_eos = (outs == eos[:, None]) & (eos[:, None] >= 0)
        n = np.where(is_eos.any(axis=1), np.minimum(n, np.argmax(is_eos, axis=1) + 1), n)
        return outs, np.clip(n, 0, np.maximum(budget, 0)).astype(np.int64)


class ChainDrafter:
    """Perfect drafter for the chain model; records its releases."""

    kind = "chain"

    def __init__(self):
        self.released = []

    def draft(self, slot, rid, prompt, tokens, k):
        last = tokens[-1] if tokens else int(prompt[-1])
        return np.asarray([(last + 1 + i) % 97 for i in range(k)], np.int32)

    def release(self, slot):
        self.released.append(slot)


class WrongDrafter(ChainDrafter):
    """Always wrong: every window is a full reject."""

    kind = "wrong"

    def draft(self, slot, rid, prompt, tokens, k):
        return np.full(k, 96, np.int32)


class SilentDrafter(ChainDrafter):
    """Never drafts: every step falls back to decode."""

    kind = "silent"

    def draft(self, slot, rid, prompt, tokens, k):
        return np.empty(0, np.int32)


class HalfDrafter(ChainDrafter):
    """Right for even request ids, broken (raising) for odd ones."""

    kind = "half"

    def draft(self, slot, rid, prompt, tokens, k):
        if rid % 2:
            raise RuntimeError("draft model fault")
        return super().draft(slot, rid, prompt, tokens, k)


# (drafter, scheduler kwargs, [(prompt, max_new, eos)]) -- the JAX tests' streams
STREAMS = {
    "chain": (ChainDrafter, {}, [(np.arange(1, n + 2), m, None) for n, m in [(3, 9), (6, 4),
                                                                              (2, 7)]]),
    "eos_truncates": (ChainDrafter, {}, [(np.array([10]), 20, 13)]),
    "budget_truncates": (ChainDrafter, {}, [(np.array([1, 2, 3]), 2, None)]),
    "full_reject": (WrongDrafter, {}, [(np.array([1, 2]), 6, None)]),
    "no_drafts": (SilentDrafter, {}, [(np.array([1, 2]), 4, None)]),
    "released_on_finish": (ChainDrafter, {}, [(np.array([1]), 3, None)]),
    "preemption": (ChainDrafter, dict(num_pages=8, page_size=2),
                   [(np.array([1, 2, 3]), 8, None), (np.array([50, 51, 52]), 8, None)]),
    "drafter_error": (HalfDrafter, dict(num_slots=3),
                      [(np.arange(4) + 3 * i, 7, None) for i in range(4)]),
    "k_2_frozen": (ChainDrafter, dict(spec_k=2, spec_adaptive=False),
                   [(np.arange(5), 11, None), (np.array([40]), 6, 44)]),
}


def _run(pkg, name):
    drafter_cls, kw, reqs = STREAMS[name]
    kw = {"num_slots": 2, "num_pages": 32, "page_size": 4, "pages_per_seq": 8, "spec_k": 4,
          **kw}
    ex, drafter = SpecFakeExecutor(), drafter_cls()
    sched = pkg.ContinuousBatchingScheduler(ex, drafter=drafter, **kw)
    requests = [pkg.Request(prompt=np.asarray(p, np.int32), max_new_tokens=m, eos_token_id=e)
                for p, m, e in reqs]
    # the reference's request ids are its own counter's: the drafters see the
    # same ids on both sides
    for i, r in enumerate(requests):
        r.rid = i
    for r in requests:
        sched.submit(r)
    sched.run_to_completion(max_steps=500)
    return {"tokens": [r.tokens for r in requests],
            "spec": [(r.spec_drafted, r.spec_accepted) for r in requests],
            "preemptions": [r.preemptions for r in requests], "steps": sched.steps,
            "spec_stats": dict(sched.spec_stats), "counters": dict(sched.counters),
            "k": sched._spec_ctl.k, "calls": ex.calls, "released": drafter.released,
            "audit": sched.audit()["ok"], "allocated": sched.allocator.allocated_pages}


def _chain(prompt, n):
    return [(int(prompt[-1]) + 1 + i) % 97 for i in range(n)]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_spec_scheduler_matches_jax_under_one_fake_executor(name):
    """Identical tokens, per-request ledgers, ``spec_stats``, counters,
    executor call logs and drafter releases; plus the JAX tests' own
    assertions."""
    ref = _run(jserving, name)
    out = _run(serving, name)
    # the reference records its counters with payloads the port's do not carry
    ref_counters = {k: v for k, v in ref.pop("counters").items()}
    counters = out.pop("counters")
    assert out == ref
    assert counters == ref_counters
    assert out["audit"] and out["allocated"] == 0
    _, _, reqs = STREAMS[name]
    stats = out["spec_stats"]
    if name in ("chain", "preemption", "k_2_frozen"):
        assert out["tokens"] == [_chain(p, m) if e is None else out["tokens"][i]
                                 for i, (p, m, e) in enumerate(reqs)]
        assert stats["accepted"] > 0 and stats["windows"] > 0
    if name == "eos_truncates":
        assert out["tokens"] == [[11, 12, 13]]
    if name == "budget_truncates":
        assert out["tokens"] == [[4, 5]]
    if name == "full_reject":
        assert out["tokens"] == [[3, 4, 5, 6, 7, 8]]
        assert stats["full_reject_windows"] > 0 and stats["accepted"] == 0
        assert out["k"] == 1 and out["spec"][0][0] > 0 and out["spec"][0][1] == 0
    if name == "no_drafts":
        assert out["tokens"] == [[3, 4, 5, 6]]
        assert not any(c[0] == "verify" for c in out["calls"])
        assert stats["fallback_steps"] > 0
    if name == "released_on_finish":
        assert out["released"]
    if name == "preemption":
        assert sum(out["preemptions"]) >= 1
    if name == "drafter_error":
        assert counters["drafter_error"] > 0
        assert out["tokens"] == [_chain(p, m) for p, m, _ in reqs]
    if name == "k_2_frozen":
        assert all(len(c[1][0]) in (3,) for c in out["calls"] if c[0] == "verify")


def test_spec_scheduler_outputs_match_plain_decode_in_fewer_calls():
    """The perfect drafter changes no token and needs fewer executor calls."""
    runs = {}
    for drafter in (None, ChainDrafter()):
        ex = SpecFakeExecutor()
        sched = serving.ContinuousBatchingScheduler(ex, num_slots=2, num_pages=32, page_size=4,
                                                    pages_per_seq=8, drafter=drafter)
        reqs = [serving.Request(prompt=np.arange(1, n + 2, dtype=np.int32), max_new_tokens=m)
                for n, m in [(3, 9), (6, 4), (2, 7)]]
        for r in reqs:
            sched.submit(r)
        sched.run_to_completion()
        runs[drafter is None] = ([r.tokens for r in reqs],
                                 sum(c[0] != "prefill" for c in ex.calls))
    assert runs[True][0] == runs[False][0]
    assert runs[False][1] < runs[True][1]


def test_executor_fault_in_verify_propagates():
    class Broken(SpecFakeExecutor):
        def verify(self, *a):
            raise RuntimeError("device fault")

    sched = serving.ContinuousBatchingScheduler(Broken(), num_slots=1, num_pages=8, page_size=4,
                                                pages_per_seq=4, drafter=ChainDrafter())
    sched.submit(serving.Request(prompt=np.arange(3, dtype=np.int32), max_new_tokens=5))
    with pytest.raises(RuntimeError, match="device fault"):
        sched.step()
