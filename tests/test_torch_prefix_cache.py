"""The port's copy-on-write prefix cache against the JAX package's: the hash
chain and ``PrefixIndex`` on seeded token streams, the two schedulers with a
prefix index under one fake executor (the JAX prefix tests' cases), and the
two ``ServingEngine``s end to end on a shared-system-prompt workload.

The scheduler cases compare tokens, request states and reject reasons,
verdicts, ``counters``, ``page_stats``, each dispatch with its ``start``
arguments, refcount snapshots and the audit after every step. The end-to-end
runs use ``tests/test_torch_serving.py``'s configuration (GPT 2 layers, d 32,
vocab 64; 3 slots, page 8, chunk 16, fp32) with the weights bridged through
numpy: tokens identical per request (fp32 on both sides), ``page_stats``
equal, and the cache-on tokens equal to the cache-off ones."""

import numpy as np
import pytest

import jax

from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.inference.serving import paging as jpaging
from deepspeed_tpu.models import gpt as G
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import serving
from deepspeed_tpu_torch.inference.serving import paging
from deepspeed_tpu_torch.models import gpt as TG

from _torch_sched_pair import drive


# ------------------------------------------------------------------ the index
@pytest.mark.parametrize("n,page_size", [(0, 4), (3, 4), (8, 4), (13, 4), (64, 16), (200, 64)])
def test_prefix_chain_hashes_match_jax_byte_for_byte(n, page_size):
    toks = np.random.default_rng(n).integers(0, 50304, n).astype(np.int32)
    out = paging.prefix_chain_hashes(toks, page_size)
    assert out == jpaging.prefix_chain_hashes(toks, page_size)
    assert len(out) == n // page_size
    # entry j commits to blocks 0..j: a change in block 0 changes every entry
    if len(out) > 1:
        moved = paging.prefix_chain_hashes(np.concatenate([[toks[0] + 1], toks[1:]]), page_size)
        assert all(a != b for a, b in zip(out, moved))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_index_matches_jax_on_seeded_streams(seed):
    """Registrations, lookups (counted and not) and forgets on streams that
    share seeded prefixes give the JAX index's pages, entry counts and hit /
    miss statistics, operation by operation."""
    rng = np.random.default_rng(seed)
    ps = 4
    heads = [rng.integers(0, 16, int(rng.integers(4, 20))) for _ in range(3)]
    ref, out = jpaging.PrefixIndex(ps), paging.PrefixIndex(ps)
    next_page, live = 1, []
    for _ in range(60):
        head = heads[int(rng.integers(0, 3))]
        toks = np.concatenate([head, rng.integers(0, 16, int(rng.integers(0, 9)))])
        op = int(rng.integers(0, 4))
        if op == 0:  # a prefill's pages registered
            n = len(toks) // ps + int(rng.integers(0, 2))
            pages = list(range(next_page, next_page + n))
            next_page += n
            live += pages
            assert out.register(toks, pages) == ref.register(toks, pages)
        elif op == 1:
            assert out.lookup(toks) == ref.lookup(toks)
        elif op == 2:
            hashes = paging.prefix_chain_hashes(toks, ps)
            assert out.lookup_chain(hashes) == ref.lookup_chain(hashes)
        elif live:  # pages whose last reference died
            gone = [live.pop(int(rng.integers(0, len(live)))) for _ in range(min(3, len(live)))]
            out.forget(gone)
            ref.forget(gone)
        assert (len(out), out.hits, out.misses) == (len(ref), ref.hits, ref.misses)
    assert out.hits > 0 and out.misses > 0


# ------------------------------------------------------- the two schedulers
PREFIX = np.arange(8, dtype=np.int32) + 1  # 2 full pages at page size 4


def _with_prefix(tail, max_new, **extra):
    return (np.concatenate([PREFIX, np.asarray(tail, np.int32)]), max_new, extra)


CASES = {
    # the first writer admits alone and registers; two sharers borrow 2 pages
    "sharing": dict(
        requests=[_with_prefix([40 + i], 4) for i in range(3)],
        script=[("submit", 0), ("step",), ("snap",), ("submit", 1), ("submit", 2), ("step",),
                ("snap",), ("run", 0.0)],
        sched=dict(num_slots=3, num_pages=32)),
    # the same with prefill_many: 4-tuples with the start of each row
    "sharing_batched": dict(
        requests=[_with_prefix([40 + i], 4) for i in range(3)],
        script=[("submit", 0), ("step",), ("submit", 1), ("submit", 2), ("run", 0.0)],
        sched=dict(num_slots=3, num_pages=32), executor=dict(batched=True)),
    # 8 usable pages against ~12 of joint demand: a slot holding borrowed
    # pages is preempted, unwinds, and re-shares at re-admission
    "preemption": dict(
        requests=[_with_prefix([40 + i], 16) for i in range(2)],
        script=[("submit", 0), ("step",), ("submit", 1), ("run", 0.0)],
        sched=dict(num_slots=2, num_pages=9)),
    # a deadline-evicted borrower drops only its own references
    "deadline_evicts_borrower": dict(
        requests=[_with_prefix([40], 12), _with_prefix([41], 12, deadline_s=0.5)],
        script=[("submit", 0), ("step",), ("submit", 1), ("step",), ("snap",),
                ("clock", 1.0), ("step",), ("snap",), ("run", 0.0)],
        sched=dict(num_slots=2, num_pages=32)),
    # the unshared remainder does not fit: nothing is claimed, the head
    # blocks, and admits once the pool frees
    "pool_exhaustion": dict(
        requests=[_with_prefix(np.arange(7), 2), _with_prefix(np.arange(8), 4)],
        script=[("submit", 0), ("step",), ("submit", 1), ("step",), ("snap",), ("run", 0.0)],
        sched=dict(num_slots=2, num_pages=6)),
}


def _pair(name, prefix=True):
    case = CASES[name]
    args = (case["requests"], case["script"], case["sched"], case.get("executor"))
    return drive(jserving, *args, prefix=prefix), drive(serving, *args, prefix=prefix)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefix_scheduler_matches_jax(name):
    """Everything the run records equals the JAX scheduler's; the audit is
    clean after every step; at the end no page is allocated and the index is
    empty. Plus the JAX prefix tests' own assertions."""
    ref, out = _pair(name)
    assert out == ref
    assert all(out["audits"]) and out["audit_ok"] and out["raised"] is None
    assert out["allocated"] == 0 and out["indexed"] == 0
    stats = out["page_stats"]
    assert stats["physical"] + stats["shared"] == stats["logical"]
    if name != "pool_exhaustion":
        assert stats["shared"] > 0 and stats["physical"] < stats["logical"]
    starts = [c[1][2] for c in out["calls"] if c[0] == "prefill"]
    if name == "sharing":
        assert stats["shared"] == 4 and sorted(starts) == [0, 8, 8]
        assert out["snaps"][1][0] == {1: 3, 2: 3, 3: 1, 4: 1, 5: 1}
    if name == "sharing_batched":
        items = [it for kind, d in out["calls"] if kind == "prefill_many" for it in d]
        assert all(n == 4 for _, _, n, _ in items)
        assert sorted(st for *_, st in items) == [0, 8, 8]
    if name == "preemption":
        assert sum(out["preemptions"]) >= 1
    if name == "deadline_evicts_borrower":
        assert out["states"] == ["finished", "expired"]
        assert out["reject_reasons"] == [None, "deadline_running"]
        shared = [p for p, n in out["snaps"][0][0].items() if n == 2]
        assert len(shared) == 2 and all(out["snaps"][1][0][p] == 1 for p in shared)
    if name == "pool_exhaustion":
        # the blocked head took no reference; by its admission the first
        # writer's pages were freed and forgotten, so nothing was shared
        assert all(n == 1 for n in out["snaps"][0][0].values())
        assert stats["shared"] == 0
        assert out["states"] == ["finished", "finished"]


@pytest.mark.parametrize("name", ["sharing", "preemption", "deadline_evicts_borrower"])
def test_prefix_cache_keeps_the_cache_off_tokens(name):
    """The port's tokens with the cache equal its tokens without it; without
    it the executor sees the 3-argument protocol and nothing is shared."""
    _, on = _pair(name)
    _, off = _pair(name, prefix=False)
    assert on["tokens"] == off["tokens"]
    assert off["page_stats"]["shared"] == 0
    assert all(c[1][2] == 0 for c in off["calls"] if c[0] == "prefill")
    if name == "preemption":  # fewer physical pages preempt no more
        assert sum(on["preemptions"]) <= sum(off["preemptions"])


# -------------------------------------------------------------- end to end
CFG = G.GPTConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4, max_seq_len=128)
TCFG = TG.GPTConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4, max_seq_len=128)
BASE = dict(num_slots=3, page_size=8, max_model_len=64, prefill_chunk=16, dtype="float32",
            decode_block=4)


@pytest.fixture(scope="module")
def weights():
    jparams = G.init_params(CFG, jax.random.PRNGKey(0))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _chat_workload(pkg):
    """7 requests present at the start, each opening with the reference
    bench's system prompt ``(arange(16) * 7 + 3) % V``: two pages, exactly
    one prefill chunk."""
    sysp = (np.arange(16, dtype=np.int32) * 7 + 3) % 64
    wl = pkg.make_open_loop_workload(7, rate_rps=1e4, prompt_len=(3, 20), max_new=(2, 8),
                                     vocab_size=64, seed=3)
    return [pkg.Request(prompt=np.concatenate([sysp, r.prompt]), max_new_tokens=r.max_new_tokens)
            for r in wl]


def test_prefix_cache_engine_matches_the_jax_engine(weights):
    jparams, np_params = weights
    params = params_from_numpy(np_params, "cpu")
    ref_wl = _chat_workload(jserving)
    ref = jserving.run_continuous(jserving.ServingEngine(
        CFG, jparams, jserving.ServingConfig(**BASE, enable_prefix_cache=True)), ref_wl)
    runs = {}
    for on in (True, False):
        eng = serving.ServingEngine(TCFG, params,
                                    serving.ServingConfig(**BASE, enable_prefix_cache=on),
                                    device="cpu")
        wl = _chat_workload(serving)
        runs[on] = (serving.run_continuous(eng, wl), [r.tokens for r in wl], eng.last_scheduler)
    rep, toks, sched = runs[True]
    assert rep["finished"] == len(ref_wl) and rep["pool_audit_ok"]
    assert toks == [r.tokens for r in ref_wl]
    assert rep["page_stats"] == ref["page_stats"]
    assert rep["page_stats"]["shared"] > 0 and rep["physical_logical_page_ratio"] < 1
    assert toks == runs[False][1]
    assert runs[False][0]["page_stats"]["shared"] == 0
    assert sched.allocator.allocated_pages == 0 and len(sched.prefix_cache) == 0
    assert sched.prefix_cache.hits == ref["page_stats"]["shared"]
