"""Drive the JAX package's ``ContinuousBatchingScheduler`` and the port's
through one scripted scenario each, with the same device-free fake executor
and a manual clock, and record everything the two must agree on."""

import numpy as np


class FakeExecutor:
    """prefill answers last+1, decode prev+1 (mod 97), as the JAX serving
    tests' executors do. Every call is one dispatch: ``calls`` logs its kind
    with the ``start`` arguments (prefill) or the block size (decode). A
    dispatch whose index is in ``fail_at``, and every decode block of
    ``fail_steps`` steps, raises before answering."""

    def __init__(self, fail_at=(), fail_steps=None, batched=False):
        self.fail_at = set(fail_at)
        self.fail_steps = fail_steps
        self.calls = []
        if batched:
            self.prefill_many = self._prefill_many

    def _dispatch(self, kind, detail):
        index = len(self.calls)
        self.calls.append((kind, detail))
        if index in self.fail_at:
            raise RuntimeError(f"injected fault at dispatch {index}")

    def prefill(self, slot, tokens, table_row, start=0):
        self._dispatch("prefill", (int(slot), len(tokens), int(start)))
        return (int(tokens[-1]) + 1) % 97

    def _prefill_many(self, items):
        # a 3-tuple item is the protocol without a prefix cache
        self._dispatch("prefill_many", [(int(it[0]), len(it[1]), len(it),
                                         int(it[3]) if len(it) > 3 else None) for it in items])
        return {it[0]: (int(it[1][-1]) + 1) % 97 for it in items}

    def decode(self, tokens, tables, lengths, active, steps=1):
        self._dispatch("decode", int(steps))
        if steps == self.fail_steps:
            raise RuntimeError(f"decode block of {steps} steps fails")
        return np.stack([(tokens + k + 1) % 97 for k in range(steps)])

    def verify(self, tokens, tables, lengths, active, eos, budget):
        """Greedy longest-prefix acceptance of the drafts against prev+1,
        ended at an accepted eos and truncated at the budget."""
        self._dispatch("verify", int(tokens.shape[1]))
        outs = (np.asarray(tokens) + 1) % 97
        agree = np.cumprod(tokens[:, 1:] == outs[:, :-1], axis=1)
        n = 1 + agree.sum(axis=1)
        for s in range(len(n)):
            hits = np.flatnonzero(outs[s] == eos[s]) if eos[s] >= 0 else []
            if len(hits):
                n[s] = min(n[s], hits[0] + 1)
        return outs, np.clip(np.minimum(n, budget), 0, None)


class FakeDrafter:
    """Drafts the executor's own continuation for even slots and a wrong one
    for odd slots, so windows are fully accepted and fully rejected."""

    kind = "fake"

    def draft(self, slot, rid, prompt, tokens, k):
        last = int(tokens[-1]) if len(tokens) else int(prompt[-1])
        stride = 1 if slot % 2 == 0 else 2
        return [(last + stride * (i + 1)) % 97 for i in range(k)]

    def release(self, slot):
        pass


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def drive(pkg, requests, script, sched_kw, executor_kw=None, prefix=False, drafter=False):
    """Run ``script`` on a scheduler of package ``pkg`` (``deepspeed_tpu``'s
    or the port's serving module). ``requests``: [(prompt, max_new, Request
    kwargs)]. Script ops: ``("submit", i)``, ``("step",)``, ``("clock", t)``,
    ``("run", dt)`` (step until idle, the clock advancing ``dt`` after each
    step) and ``("snap",)`` (the refcount of every allocated page, by id, and
    the prefix index's size). ``drafter``: speculate with
    :class:`FakeDrafter`. The audit runs after every step. An exception of the
    scheduler ends the script and is recorded by type, message and cause.
    Shed rids are given as request indices (rids are per process)."""
    clock = ManualClock()
    ex = FakeExecutor(**(executor_kw or {}))
    kw = {"num_slots": 2, "num_pages": 16, "page_size": 4, "pages_per_seq": 8,
          "decode_block": 1, "retry_base_delay": 0.001, "retry_max_delay": 0.002, **sched_kw}
    if prefix:
        kw["prefix_cache"] = pkg.PrefixIndex(kw["page_size"])
    if drafter:
        kw["drafter"] = FakeDrafter()
    sched = pkg.ContinuousBatchingScheduler(ex, clock=clock, **kw)
    reqs = [pkg.Request(prompt=np.asarray(p, np.int32), max_new_tokens=m, **extra)
            for p, m, extra in requests]
    index = {r.rid: i for i, r in enumerate(reqs)}
    verdicts, audits, snaps, raised = [], [], [], None

    def step():
        sched.step()
        audits.append(sched.audit()["ok"])

    try:
        for op in script:
            if op[0] == "submit":
                v = sched.submit(reqs[op[1]])
                verdicts.append((bool(v), v.reason, index.get(v.shed_rid)))
            elif op[0] == "step":
                step()
            elif op[0] == "clock":
                clock.t = op[1]
            elif op[0] == "snap":
                snaps.append(({p: sched.allocator.refcount(p)
                               for p in sorted(sched.allocator.allocated_ids)},
                              len(sched.prefix_cache) if prefix else None))
            elif op[0] == "run":
                for _ in range(500):
                    if sched.idle:
                        break
                    step()
                    clock.t += op[1]
                assert sched.idle, "the scheduler did not drain"
    except Exception as e:  # the schedulers must fail alike
        raised = (type(e).__name__, str(e), type(e.__cause__).__name__, str(e.__cause__))
    rep = sched.audit()
    return {
        "tokens": [list(r.tokens) for r in reqs],
        "states": [r.state.value for r in reqs],
        "reject_reasons": [r.reject_reason for r in reqs],
        "preemptions": [r.preemptions for r in reqs],
        "verdicts": verdicts,
        "counters": dict(sched.counters),
        "page_stats": dict(sched.page_stats),
        "calls": ex.calls,
        "audits": audits,
        "snaps": snaps,
        "audit_ok": rep["ok"],
        "allocated": sched.allocator.allocated_pages,
        "queued_tokens": sched.queued_tokens,
        "quarantined": sorted(sched._quarantined_blocks),
        "indexed": len(sched.prefix_cache) if prefix else None,
        "spec_stats": dict(sched.spec_stats),
        "raised": raised,
    }
