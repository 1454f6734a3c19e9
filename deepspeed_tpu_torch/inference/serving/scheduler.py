"""Continuous-batching scheduler: per-decode-step admit / evict / preempt.

The port's copy of the default configuration of
``deepspeed_tpu/inference/serving/scheduler.py`` (the port imports nothing of
the JAX package). The unit of scheduling is a decode slot: the decode step
runs over a fixed number of slots whether they are occupied or not.
Requests flow

    submit -> FIFO queue -> [admit: alloc pages, prefill] -> slot
           -> one token per scheduler step -> [finish: free pages, evict]

Page growth is on demand: a slot crossing a page boundary allocates a page
mid-flight; when the pool is exhausted the most recently admitted slot is
preempted (pages freed, request requeued at the FRONT with its generated
tokens kept; re-admission prefills prompt + tokens, which greedy decoding
reproduces exactly), so the oldest work always completes.

The scheduler is host-only: all device work goes through an *executor*
(``serving.engine.ServingEngine``, or a fake in tests) with

- ``prefill(slot, tokens, table_row) -> first_token`` and optionally
  ``prefill_many(items) -> {slot: first_token}`` for one admission cycle;
- ``decode(tokens, tables, lengths, active, steps=1) -> [steps, num_slots]``;
- with a drafter, ``verify(tokens, tables, lengths, active, eos, budget) ->
  (outputs [num_slots, W], n_accept [num_slots])``.

Speculative decoding: with a ``drafter`` (``speculate.py``), each step asks
it for up to k tokens per active slot, scores the k + 1 window positions in
one ``verify`` call (acceptance and the commit of the accepted prefix run in
the executor) and appends the accepted tokens; k follows the accept rate
(``AdaptiveSpecK``). A step in which no slot drafted falls back to plain
decode.

An executor exception propagates out of :meth:`step` unchanged: nothing
here retries, so a device fault is never hidden.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP.md item when a constructor argument asks for it: overload control,
deadlines and dispatch-fault recovery (retries, quarantine, failure budget)
and the prefix cache (A7); SLO tiers, tenants, the brownout
ladder and the disaggregated prefill/decode roles (A10); the recovery log,
the watchdog and page fingerprints (A11).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from ...utils.errors import unported
from .paging import PageAllocator, pages_for
from .speculate import AdaptiveSpecK, spec_k_ladder


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    REJECTED = "rejected"   # refused at submit (unservable, or draining)


@dataclasses.dataclass(frozen=True)
class AdmissionVerdict:
    """The typed result of :meth:`ContinuousBatchingScheduler.submit`.
    ``reason``: ``admitted`` | ``unservable`` (prompt + max_new can never fit
    the serving bound: a caller bug, not load) | ``draining`` (the scheduler
    finishes accepted work and admits nothing new)."""

    admitted: bool
    reason: str = "admitted"
    detail: str = ""

    def __bool__(self) -> bool:
        return self.admitted


_rid = itertools.count()


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request plus its lifecycle bookkeeping. Requests
    compare by identity (the queue removes THE request, not a lookalike)."""

    prompt: np.ndarray                  # [T] int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    arrival_time: float = 0.0           # offset into the workload (open loop)
    rid: int = dataclasses.field(default_factory=lambda: next(_rid))

    # lifecycle (filled by the scheduler)
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    preemptions: int = 0
    reject_reason: Optional[str] = None
    # the request's speculation ledger: draft positions offered to the
    # verifier, and confirmed by it
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def context_len(self) -> int:
        """Tokens whose KV must be live to continue this request."""
        return len(self.prompt) + len(self.tokens)

    @property
    def done(self) -> bool:
        return (len(self.tokens) >= self.max_new_tokens
                or (self.eos_token_id is not None and bool(self.tokens)
                    and self.tokens[-1] == self.eos_token_id))


# constructor arguments the port does not honour yet: (default, ROADMAP.md item)
_UNPORTED_ARGS = {
    "max_queue": (None, "A7"), "max_queued_tokens": (None, "A7"),
    "shed_policy": ("reject_newest", "A7"), "ttft_deadline_s": (None, "A7"),
    "deadline_s": (None, "A7"), "dispatch_retries": (2, "A7"),
    "retry_base_delay": (0.02, "A7"), "retry_max_delay": (0.25, "A7"),
    "quarantine_after": (2, "A7"), "dispatch_failure_budget": (8, "A7"),
    "prefix_cache": (None, "A7"), "role": ("both", "A10"), "tiers": (None, "A10"),
    "tenants": (None, "A10"), "brownout": (None, "A10"),
    "latency_preempt_budget": (2, "A10"), "recovery_log": (None, "A11"),
    "watchdog": (None, "A11"), "page_fingerprints": (False, "A11"),
    "pages_scan_per_step": (1, "A11"),
}


class ContinuousBatchingScheduler:
    def __init__(self, executor: Any, num_slots: int, num_pages: int, page_size: int,
                 pages_per_seq: int, decode_block: int = 1,
                 max_context: Optional[int] = None, clock=time.monotonic, drafter=None,
                 spec_k: int = 4, spec_adaptive: bool = True, **unported_args):
        for name, value in unported_args.items():
            if name not in _UNPORTED_ARGS:
                raise TypeError(f"ContinuousBatchingScheduler got an unexpected argument "
                                f"{name!r}")
            default, item = _UNPORTED_ARGS[name]
            if value != default:
                raise unported(f"ContinuousBatchingScheduler({name}={value!r})", item)
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.executor = executor
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        if not (1 <= decode_block <= self.page_size):
            raise ValueError(f"decode_block {decode_block} outside [1, page_size]")
        self.decode_block = int(decode_block)
        # the engine's model-length bound can sit below the page capacity by
        # a partial page: admission honours the tighter of the two
        self.max_context = int(max_context if max_context is not None
                               else pages_per_seq * page_size)
        self.allocator = PageAllocator(num_pages)
        self.clock = clock
        # cumulative page accounting: pages every admission or growth asked
        # for (logical), allocated (physical), served shared (always 0 here)
        self.page_stats: Dict[str, int] = {"logical": 0, "physical": 0, "shared": 0}
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * self.num_slots
        self._slot_pages: List[List[int]] = [[] for _ in range(self.num_slots)]
        self._admit_seq: List[int] = [0] * self.num_slots  # admission order
        self._admissions = 0
        self.tables = np.zeros((self.num_slots, self.pages_per_seq), np.int32)
        self.lengths = np.zeros(self.num_slots, np.int32)
        self.next_input = np.zeros(self.num_slots, np.int32)
        self.finished: List[Request] = []
        self.shed: List[Request] = []      # REJECTED at submit
        self.counters: Dict[str, int] = {}
        self.steps = 0
        self._draining = False
        self.drafter = drafter
        self._spec_ctl = (AdaptiveSpecK(spec_k_ladder(spec_k), adaptive=spec_adaptive)
                          if drafter is not None else None)
        self.spec_stats: Dict[str, Any] = {
            "drafter": getattr(drafter, "kind", None),
            "windows": 0,               # verify calls
            "drafted": 0,               # draft positions offered
            "accepted": 0,              # draft positions confirmed
            "committed_tokens": 0,      # tokens the verify windows produced
            "full_accept_windows": 0,   # slot-windows where every draft held
            "full_reject_windows": 0,   # slot-windows with drafts, none held
            "fallback_steps": 0,        # steps with no draft: plain decode
        }

    # ------------------------------------------------------------ bookkeeping
    @property
    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots)
                if r is not None and r.state is RequestState.RUNNING]

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active_slots

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        """A drain was requested and every accepted request has left."""
        return self._draining and self.idle

    def drain(self) -> None:
        """Graceful, idempotent drain: refuse new submissions while queued
        and running requests step to completion."""
        if not self._draining:
            self._draining = True
            self._record("drain_started")

    def _record(self, event: str) -> None:
        self.counters[event] = self.counters.get(event, 0) + 1

    def _mark_shed(self, req: Request, reason: str) -> None:
        req.state = RequestState.REJECTED
        req.reject_reason = reason
        self.shed.append(req)
        self._record("request_shed")

    def submit(self, req: Request) -> AdmissionVerdict:
        """Admission control: a request that can never fit the serving bound
        (the model length, the table, or the whole pool) is refused here, at
        the front door, and never enters the queue."""
        if self._draining:
            detail = (f"request {req.rid} rejected: scheduler is draining "
                      f"({len(self.queue)} queued + {len(self.active_slots)} running "
                      f"to finish)")
            self._mark_shed(req, "draining")
            return AdmissionVerdict(False, "draining", detail)
        worst = len(req.prompt) + req.max_new_tokens
        pool = self.allocator.num_pages - 1  # page 0 reserved
        need = pages_for(worst, self.page_size)
        if worst > self.max_context or need > self.pages_per_seq or need > pool:
            # a request needing more pages than exist could never admit (the
            # queue head would block forever) or, admitted, would preempt
            # itself in an endless recompute loop once it outgrew the pool
            detail = (f"request {req.rid}: prompt+max_new={worst} tokens exceeds the "
                      f"serving bound (max_context={self.max_context}, pages_per_seq="
                      f"{self.pages_per_seq} x page_size={self.page_size}, pool={pool} "
                      f"pages) -- reject at the front door, not mid-decode")
            self._mark_shed(req, "unservable")
            return AdmissionVerdict(False, "unservable", detail)
        req.state = RequestState.QUEUED
        if req.t_submit is None:
            req.t_submit = self.clock()
        self.queue.append(req)
        return AdmissionVerdict(True)

    def _release(self, slot: int) -> None:
        if self.drafter is not None:
            self.drafter.release(slot)
        self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.tables[slot] = 0
        self.lengths[slot] = 0
        self.next_input[slot] = 0
        self.slots[slot] = None

    def _finish(self, slot: int) -> None:
        req = self.slots[slot]
        req.state = RequestState.FINISHED
        req.t_done = self.clock()
        self.finished.append(req)
        self._record("request_finished")
        self._release(slot)

    def _preempt(self, slot: int) -> None:
        """Recompute-style preemption: pages freed, generated tokens kept;
        the request requeues at the front."""
        req = self.slots[slot]
        req.preemptions += 1
        req.state = RequestState.QUEUED
        self._record("preemption")
        self._release(slot)
        self.queue.appendleft(req)

    # ----------------------------------------------------------- page audit
    def audit(self) -> Dict[str, Any]:
        """The allocator's conservation invariant plus the scheduler's
        cross-checks: every allocated page is owned by exactly as many slots
        as its refcount says, no slot lists a page twice, and no page shared
        between slots reaches a slot's write frontier (the next append lands
        at ``lengths[slot]``)."""
        rep = self.allocator.audit()
        errors: List[str] = list(rep["errors"])
        refs: Dict[int, int] = {}
        for s_idx, pages in enumerate(self._slot_pages):
            if len(pages) != len(set(pages)):
                errors.append(f"slot {s_idx} lists a page twice")
            for p in pages:
                refs[p] = refs.get(p, 0) + 1
        if set(refs) != self.allocator.allocated_ids:
            leaked = sorted(self.allocator.allocated_ids - set(refs))
            foreign = sorted(set(refs) - self.allocator.allocated_ids)
            if leaked:
                errors.append(f"pages allocated but owned by no slot (leak): {leaked}")
            if foreign:
                errors.append(f"slot-held pages unknown to the allocator: {foreign}")
        for p, n in refs.items():
            have = self.allocator.refcount(p)
            if have != n:
                errors.append(f"page {p}: {n} slot reference(s) vs allocator refcount "
                              f"{have} (leaked refcount)")
        for s_idx, pages in enumerate(self._slot_pages):
            frontier = int(self.lengths[s_idx])
            for idx, p in enumerate(pages):
                if (self.allocator.refcount(p) > 1
                        and (idx + 1) * self.page_size > frontier):
                    errors.append(f"shared page {p} (table index {idx}) reaches slot "
                                  f"{s_idx}'s write frontier {frontier}")
        rep["errors"] = errors
        rep["ok"] = not errors
        rep["page_stats"] = dict(self.page_stats)
        return rep

    # ------------------------------------------------------------ admission
    def _admit(self) -> int:
        # phase 1: claim slots + pages for everything that fits this cycle,
        # in FIFO order; a head that does not fit blocks the queue
        batch = []  # (slot, context tokens)
        free = deque(s for s in range(self.num_slots) if self.slots[s] is None)
        while free and self.queue:
            req = self.queue[0]
            ctx = req.context_len
            # +1: the first decode step appends its token's KV at position
            # ctx, which may open a fresh page
            need = pages_for(ctx + 1, self.page_size)
            pages = self.allocator.alloc(need)
            if pages is None:
                break
            self.page_stats["logical"] += need
            self.page_stats["physical"] += need
            slot = free.popleft()
            self.queue.popleft()
            self._slot_pages[slot] = pages
            self.tables[slot] = 0
            self.tables[slot, :len(pages)] = pages
            tokens = np.concatenate([np.asarray(req.prompt, np.int32),
                                     np.asarray(req.tokens, np.int32)])
            self.lengths[slot] = ctx
            self.slots[slot] = req
            self._admissions += 1
            self._admit_seq[slot] = self._admissions
            req.state = RequestState.RUNNING
            batch.append((slot, tokens))
        if not batch:
            return 0
        # phase 2: prefill the whole admission cycle, batched when the
        # executor can
        if hasattr(self.executor, "prefill_many"):
            results = self.executor.prefill_many(
                [(slot, toks, self.tables[slot]) for slot, toks in batch])
        else:
            results = {slot: self.executor.prefill(slot, toks, self.tables[slot])
                       for slot, toks in batch}
        for slot, _ in batch:
            req = self.slots[slot]
            first = int(results[slot])
            self.next_input[slot] = first
            # prefill's sample is the next new token, for a fresh admission
            # and for a re-prefill after preemption alike
            req.tokens.append(first)
            if req.t_first_token is None:
                req.t_first_token = self.clock()
            if req.done:
                self._finish(slot)
        return len(batch)

    def _ensure_page(self, slot: int, horizon: int = 1) -> bool:
        """Make sure pages exist for write positions ``lengths[slot]`` up to
        ``lengths[slot] + horizon - 1``."""
        last_pi = (int(self.lengths[slot]) + horizon - 1) // self.page_size
        if last_pi >= self.pages_per_seq:
            raise RuntimeError(f"slot {slot} outgrew pages_per_seq -- admission bound broken")
        for pi in range(last_pi + 1):
            if self.tables[slot, pi] != 0:
                continue
            page = self.allocator.alloc(1)
            if page is None:
                return False
            self._slot_pages[slot].append(page[0])
            self.tables[slot, pi] = page[0]
            self.page_stats["logical"] += 1
            self.page_stats["physical"] += 1
        return True

    # ------------------------------------------------------------ one step
    def _block_size(self) -> int:
        """Steps safely runnable as one decode block: no slot may finish
        inside it and no eos may fire unseen (eos requests decode step by
        step). Rounded down to a power of two, so at most
        log2(decode_block) + 1 block sizes occur."""
        if self.decode_block <= 1:
            return 1
        reqs = [self.slots[s] for s in self.active_slots]
        if any(r.eos_token_id is not None for r in reqs):
            return 1
        remaining = min(r.max_new_tokens - len(r.tokens) for r in reqs)
        k = 1
        while k * 2 <= min(remaining, self.decode_block):
            k *= 2
        return k

    def step(self) -> int:
        """Admit what fits, then run one decode step (or one safe decode
        block, or with a drafter one speculation window) over the slot
        array. Returns the tokens produced."""
        self._admit()
        if not self.active_slots:
            return 0
        if self.drafter is not None:
            produced = self._spec_step()
            if produced is not None:
                return produced
            # no slot drafted this step: plain decode
            self.spec_stats["fallback_steps"] += 1
        return self._decode_step()

    def _grow_pages(self, horizon) -> None:
        """Pages for each active slot's next ``horizon(req)`` writes,
        preempting newest-first under pool pressure; the growing slot itself
        may be the newest, so an old request is never evicted by a younger
        grower."""
        for slot in list(self.active_slots):
            req = self.slots[slot]
            if req is None:
                continue
            while not self._ensure_page(slot, horizon=horizon(req)):
                victim = max(self.active_slots, key=lambda s: self._admit_seq[s])
                self._preempt(victim)
                if victim == slot:
                    break

    def _spec_step(self) -> Optional[int]:
        """One speculation window: up to k drafts per active slot, one
        ``verify`` call over the k + 1 positions (acceptance and the commit
        of the accepted prefix run in the executor), then the accepted
        tokens. Returns the tokens produced, or None when no slot drafted."""
        k = self._spec_ctl.k
        W = k + 1
        drafts: Dict[int, np.ndarray] = {}
        for slot in self.active_slots:
            req = self.slots[slot]
            try:
                d = np.asarray(self.drafter.draft(slot, req.rid, np.asarray(req.prompt, np.int32),
                                                  req.tokens, k), np.int32)[:k]
            except Exception:  # a broken drafter must not stop serving: no drafts
                self._record("drafter_error")
                d = np.empty(0, np.int32)
            drafts[slot] = d
        if not any(len(d) for d in drafts.values()):
            return None
        # pages for each slot's commit horizon (never past its remaining
        # budget: commits are budget-truncated in the executor)
        self._grow_pages(lambda req: max(min(W, req.max_new_tokens - len(req.tokens)), 1))
        active = self.active_slots
        if not active:
            return 0
        win = np.zeros((self.num_slots, W), np.int32)
        eos = np.full(self.num_slots, -1, np.int32)
        budget = np.zeros(self.num_slots, np.int32)
        offered: Dict[int, int] = {}
        for slot in active:
            req = self.slots[slot]
            d = drafts.get(slot, np.empty(0, np.int32))
            win[slot, 0] = self.next_input[slot]
            win[slot, 1:1 + len(d)] = d
            offered[slot] = len(d)
            if req.eos_token_id is not None:
                eos[slot] = req.eos_token_id
            budget[slot] = req.max_new_tokens - len(req.tokens)
        mask = np.zeros(self.num_slots, bool)
        mask[active] = True
        outs, n_acc = self.executor.verify(win, self.tables.copy(), self.lengths.copy(), mask,
                                           eos, budget)
        outs, n_acc = np.asarray(outs), np.asarray(n_acc)
        self.steps += 1
        produced = step_offered = step_accepted = 0
        for slot in active:
            req = self.slots[slot]
            if req is None or req.state is not RequestState.RUNNING:
                continue
            n = int(n_acc[slot])
            self.lengths[slot] += n  # the n accepted inputs' K/V is cached
            dr = offered[slot]
            acc = min(max(n - 1, 0), dr)
            req.spec_drafted += dr
            req.spec_accepted += acc
            step_offered += dr
            step_accepted += acc
            if dr and acc == dr:
                self.spec_stats["full_accept_windows"] += 1
            elif dr and acc == 0:
                self.spec_stats["full_reject_windows"] += 1
            req.tokens.extend(int(t) for t in outs[slot, :n])
            produced += n
            if n:
                self.next_input[slot] = req.tokens[-1]
            if req.done:
                self._finish(slot)
        self.spec_stats["windows"] += 1
        self.spec_stats["drafted"] += step_offered
        self.spec_stats["accepted"] += step_accepted
        self.spec_stats["committed_tokens"] += produced
        self._spec_ctl.observe(step_offered, step_accepted)
        self._record("spec_window")
        return produced

    def _decode_step(self) -> int:
        block = self._block_size()
        self._grow_pages(lambda req: block)
        active = self.active_slots
        if not active:
            return 0
        block = min(block, self._block_size())  # preemption may shrink it
        mask = np.zeros(self.num_slots, bool)
        mask[active] = True
        out = np.asarray(self.executor.decode(self.next_input.copy(), self.tables.copy(),
                                              self.lengths.copy(), mask, steps=block))
        if out.ndim == 1:  # simple executors may return a flat single step
            if block != 1:
                raise ValueError(f"executor returned a flat token vector for a {block}-step "
                                 "decode block; multi-step decode must return "
                                 "[steps, num_slots]")
            out = out[None]
        self.steps += 1
        produced = 0
        for k in range(block):
            for slot in active:
                req = self.slots[slot]
                if req is None or req.state is not RequestState.RUNNING:
                    continue
                self.lengths[slot] += 1  # the input token's KV is now cached
                tok = int(out[k, slot])
                req.tokens.append(tok)
                self.next_input[slot] = tok
                produced += 1
                if req.done:
                    self._finish(slot)
        return produced

    def run_to_completion(self, max_steps: int = 100_000) -> None:
        """Drain the queue and the slots (closed loop; the open-loop driver
        is ``serving.bench.run_continuous``)."""
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError(f"scheduler did not drain in {max_steps} steps")
