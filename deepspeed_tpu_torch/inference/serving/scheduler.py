"""Continuous-batching scheduler: per-decode-step admit / evict / preempt.

The port's copy of the untiered configuration of
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
  ``prefill_many(items) -> {slot: first_token}`` for one admission cycle
  (with the prefix cache, each call or item also carries ``start``);
- ``decode(tokens, tables, lengths, active, steps=1) -> [steps, num_slots]``;
- with a drafter, ``verify(tokens, tables, lengths, active, eos, budget) ->
  (outputs [num_slots, W], n_accept [num_slots])``.

Speculative decoding: with a ``drafter`` (``speculate.py``), each step asks
it for up to k tokens per active slot, scores the k + 1 window positions in
one ``verify`` call (acceptance and the commit of the accepted prefix run in
the executor) and appends the accepted tokens; k follows the accept rate
(``AdaptiveSpecK``). A step in which no slot drafted falls back to plain
decode.

Overload control: ``submit`` returns a typed :class:`AdmissionVerdict`.
Past ``max_queue`` requests or ``max_queued_tokens`` of queued work
(:attr:`Request.work_tokens`), the shed policy rejects the newcomer
(``reject_newest``) or sheds strictly larger queued requests to make room
(``reject_largest``, only when that admits the newcomer).

Deadlines: per-request TTFT and end-to-end deadlines (the scheduler's
defaults where a request sets none) are swept on the injected ``clock`` at
every step. An expired request leaves as ``EXPIRED`` with its pages freed
and a ``deadline_miss`` counted; TTFT applies only while the first token is
still owed.

Dispatch-fault recovery: every executor call runs through :meth:`_dispatch`,
which retries ``dispatch_retries`` times on ``backoff_delay``'s curve and
counts each failed attempt as ``dispatch_error``. When a whole episode fails
(``dispatch_failed``), the affected slots are preempted and requeued with
their tokens kept (greedy re-prefill reproduces the state), a decode block
shape that failed ``quarantine_after`` episodes is no longer used, the page
audit runs, and ``dispatch_failure_budget`` consecutive failed episodes of
one kind raise :class:`ServingFaultError`. A retry that succeeds is visible
only in ``counters``.

Copy-on-write prefix cache: with a :class:`~.paging.PrefixIndex` attached,
admission shares the physical pages of the longest indexed page-aligned
prompt prefix (allocator refcounts) instead of allocating them, passes the
executor each row's first unshared position as ``start`` (the prefill
forward still runs the whole context; its KV scatter skips the borrowed
pages), and registers the request's full prompt pages after the prefill.
:meth:`audit` then also checks every refcount against the slots' references
and that no shared page reaches a write frontier.

Resilience: every counted event also goes to ``recovery_log`` (a
:class:`~...resilience.events.RecoveryLog`, the reference's ``Serving/*``
trail and fields); each dispatch runs inside the ``watchdog``'s
``serving_<kind>`` phase, with the chaos plan's dispatch injections inside
it and before the executor call; the allocator consults the plan's
``alloc_fail_at``. With ``page_fingerprints`` the executor's
``fingerprint_pages`` stamps each full prompt page once when it is
registered in the prefix index, and the stamp is verified when the page is
about to be shared, by a round-robin scan of ``pages_scan_per_step`` pages a
step (before admission) and by the audit over every shared page; a
mismatch (``sdc_detected``) evicts the page from the index and preempts its
borrowers, who re-prefill into clean pages (``sdc_healed``). The chaos
plan's ``flip_bit_at`` in the ``kv_page`` domain flips a real bit of a
stamped page (a shared one first) through the executor's
``corrupt_page_bit``.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP.md item when a constructor argument asks for it: SLO tiers, tenants,
the brownout ladder and the disaggregated prefill/decode roles (A10).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, Deque, Dict, List, Optional, Set

import numpy as np

from ...resilience.chaos import sdc_flip_fault, serving_dispatch_fault
from ...resilience.retry import backoff_delay
from ...utils.errors import unported
from ...utils.logging import logger
from .paging import PageAllocator, PrefixIndex, pages_for, prefix_chain_hashes
from .speculate import AdaptiveSpecK, spec_k_ladder


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    REJECTED = "rejected"   # shed at or after submit (overload, unservable, draining)
    EXPIRED = "expired"     # missed its deadline; evicted, pages freed


class ServingFaultError(RuntimeError):
    """``dispatch_failure_budget`` consecutive dispatch episodes of one kind
    failed, each already retried: the serving process should be recycled."""


class _DispatchFailure(RuntimeError):
    """One dispatch episode failed on every attempt."""

    def __init__(self, kind: str, attempts: int, last: BaseException):
        super().__init__(f"{kind} dispatch failed after {attempts} attempts: {last!r}")
        self.kind = kind
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass(frozen=True)
class AdmissionVerdict:
    """The typed result of :meth:`ContinuousBatchingScheduler.submit`.
    ``reason``: ``admitted`` | ``unservable`` (prompt + max_new can never fit
    the serving bound: a caller bug, not load) | ``queue_full`` |
    ``token_backlog`` (the queued work would pass ``max_queued_tokens``) |
    ``draining`` (the scheduler finishes accepted work and admits nothing
    new). ``shed_rid``: under ``reject_largest``, the rid of the queued
    request shed to make room."""

    admitted: bool
    reason: str = "admitted"
    detail: str = ""
    shed_rid: Optional[int] = None

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
    # deadlines in seconds from t_submit (None: the scheduler's defaults);
    # TTFT while the first token is owed, end to end for the whole lifetime
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None
    rid: int = dataclasses.field(default_factory=lambda: next(_rid))

    # lifecycle (filled by the scheduler)
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    preemptions: int = 0
    reject_reason: Optional[str] = None  # set when REJECTED or EXPIRED
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

    @property
    def work_tokens(self) -> int:
        """Remaining worst-case work, what ``max_queued_tokens`` charges:
        the prompt's KV plus the tokens still to decode."""
        return len(self.prompt) + self.max_new_tokens - len(self.tokens)


SHED_POLICIES = ("reject_newest", "reject_largest")

# constructor arguments the port does not honour yet: (default, ROADMAP.md item)
_UNPORTED_ARGS = {
    "role": ("both", "A10"), "tiers": (None, "A10"),
    "tenants": (None, "A10"), "brownout": (None, "A10"),
    "latency_preempt_budget": (2, "A10"),
}


class ContinuousBatchingScheduler:
    def __init__(self, executor: Any, num_slots: int, num_pages: int, page_size: int,
                 pages_per_seq: int, decode_block: int = 1,
                 max_context: Optional[int] = None, clock=time.monotonic,
                 max_queue: Optional[int] = None, max_queued_tokens: Optional[int] = None,
                 shed_policy: str = "reject_newest", ttft_deadline_s: Optional[float] = None,
                 deadline_s: Optional[float] = None, dispatch_retries: int = 2,
                 retry_base_delay: float = 0.02, retry_max_delay: float = 0.25,
                 quarantine_after: int = 2, dispatch_failure_budget: int = 8,
                 recovery_log: Any = None, watchdog: Any = None,
                 prefix_cache: Optional[PrefixIndex] = None, drafter=None,
                 spec_k: int = 4, spec_adaptive: bool = True, page_fingerprints: bool = False,
                 pages_scan_per_step: int = 1, **unported_args):
        for name, value in unported_args.items():
            if name not in _UNPORTED_ARGS:
                raise TypeError(f"ContinuousBatchingScheduler got an unexpected argument "
                                f"{name!r}")
            default, item = _UNPORTED_ARGS[name]
            if value != default:
                raise unported(f"ContinuousBatchingScheduler({name}={value!r})", item)
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy {shed_policy!r} not in {SHED_POLICIES}")
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
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_queued_tokens = None if max_queued_tokens is None else int(max_queued_tokens)
        self.shed_policy = shed_policy
        self.ttft_deadline_s = ttft_deadline_s
        self.deadline_s = deadline_s
        self.dispatch_retries = int(dispatch_retries)
        self.retry_base_delay = float(retry_base_delay)
        self.retry_max_delay = float(retry_max_delay)
        self.quarantine_after = int(quarantine_after)
        self.dispatch_failure_budget = int(dispatch_failure_budget)
        self.recovery_log = recovery_log
        self.watchdog = watchdog
        self._owns_watchdog = False  # set by ServingEngine.make_scheduler
        self._dispatch_count = 0  # the chaos plan's dispatch index
        # KV pages behind the write frontier are stamped when they become
        # shareable and verified at every trust boundary
        self.page_fingerprints = bool(page_fingerprints)
        self.pages_scan_per_step = max(0, int(pages_scan_per_step))
        self._page_fp: Dict[int, int] = {}
        self._page_scan_rr = 0  # round-robin cursor over the stamped pages
        # failed episodes in a row, per kind: a healthy prefill path must not
        # reset the count of a dead decode path
        self._consecutive_failures: Dict[str, int] = {}
        self._block_failures: Dict[int, int] = {}
        self._quarantined_blocks: Set[int] = set()
        self.prefix_cache = prefix_cache
        # cumulative page accounting: pages every admission or growth asked
        # for (logical), allocated (physical), served from the prefix index
        # (shared)
        self.page_stats: Dict[str, int] = {"logical": 0, "physical": 0, "shared": 0}
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * self.num_slots
        self._slot_pages: List[List[int]] = [[] for _ in range(self.num_slots)]
        # leading pages of each slot that are borrowed from the prefix index
        self._slot_shared: List[int] = [0] * self.num_slots
        self._admit_seq: List[int] = [0] * self.num_slots  # admission order
        self._admissions = 0
        self.tables = np.zeros((self.num_slots, self.pages_per_seq), np.int32)
        self.lengths = np.zeros(self.num_slots, np.int32)
        self.next_input = np.zeros(self.num_slots, np.int32)
        self.finished: List[Request] = []
        self.shed: List[Request] = []      # REJECTED (at submit or by policy)
        self.expired: List[Request] = []   # EXPIRED (deadline misses)
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
            self._record("drain_started", queued=len(self.queue), active=len(self.active_slots))

    @property
    def queued_tokens(self) -> int:
        """The queue's worst-case work in tokens, what ``max_queued_tokens``
        bounds."""
        return sum(r.work_tokens for r in self.queue)

    def _record(self, event: str, value: float = 1.0, **fields: Any) -> None:
        self.counters[event] = self.counters.get(event, 0) + 1
        if self.recovery_log is not None:
            try:
                self.recovery_log.record(event, value=value, step=self.steps, **fields)
            except Exception:  # event export must never fail serving
                pass

    def _mark_shed(self, req: Request, reason: str, detail: str = "") -> None:
        req.state = RequestState.REJECTED
        req.reject_reason = reason
        self.shed.append(req)
        self._record("request_shed", rid=req.rid, reason=reason, work_tokens=req.work_tokens,
                     detail=detail[:200])

    def submit(self, req: Request) -> AdmissionVerdict:
        """Admission control: a request that can never fit the serving bound
        (the model length, the table, or the whole pool) is refused here, at
        the front door, and so is one the overload bounds turn away; a
        rejected request is ``REJECTED`` and never enters the queue."""
        if self._draining:
            detail = (f"request {req.rid} rejected: scheduler is draining "
                      f"({len(self.queue)} queued + {len(self.active_slots)} running "
                      f"to finish)")
            self._mark_shed(req, "draining", detail)
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
            self._mark_shed(req, "unservable", detail)
            return AdmissionVerdict(False, "unservable", detail)
        verdict = self._admission_control(req)
        if not verdict.admitted:
            return verdict
        if req.ttft_deadline_s is None:
            req.ttft_deadline_s = self.ttft_deadline_s
        if req.deadline_s is None:
            req.deadline_s = self.deadline_s
        req.state = RequestState.QUEUED
        if req.t_submit is None:
            req.t_submit = self.clock()
        self.queue.append(req)
        return verdict

    def _admission_control(self, req: Request) -> AdmissionVerdict:
        """The queue-depth cap, then the token backlog. Over either bound,
        ``reject_largest`` plans to shed the largest queued requests, each
        strictly larger than the newcomer, and sheds them only if the
        newcomer then fits; otherwise the newcomer is rejected."""
        max_q, max_t = self.max_queue, self.max_queued_tokens

        def over(queued: List[Request]) -> bool:
            return ((max_q is not None and len(queued) >= max_q)
                    or (max_t is not None
                        and sum(r.work_tokens for r in queued) + req.work_tokens > max_t))

        queued = list(self.queue)
        if not over(queued):
            return AdmissionVerdict(True)
        if self.shed_policy == "reject_largest":
            sim, victims = list(queued), []
            while sim and over(sim):
                v = max(sim, key=lambda r: r.work_tokens)
                if v.work_tokens <= req.work_tokens:
                    break
                sim.remove(v)
                victims.append(v)
            if not over(sim):
                for v in victims:
                    self.queue.remove(v)
                    self._mark_shed(v, "shed_for_smaller", f"shed for request {req.rid}")
                return AdmissionVerdict(True, shed_rid=victims[-1].rid if victims else None)
        reason = "queue_full" if max_q is not None and len(queued) >= max_q else "token_backlog"
        detail = (f"request {req.rid} rejected ({reason}): queue depth {len(queued)}"
                  + (f"/{max_q}" if max_q is not None else "")
                  + f", queued work {sum(r.work_tokens for r in queued)} tokens"
                  + (f"/{max_t}" if max_t is not None else ""))
        self._mark_shed(req, reason, detail)
        return AdmissionVerdict(False, reason, detail)

    def _release(self, slot: int) -> None:
        if self.drafter is not None:
            self.drafter.release(slot)
        released = self.allocator.free(self._slot_pages[slot])
        if self.prefix_cache is not None and released:
            # a page whose last reference died is recycled: it must never
            # serve another request's prefix lookup
            self.prefix_cache.forget(released)
        for p in released:
            self._page_fp.pop(p, None)  # a recycled page's stamp means nothing
        self._slot_pages[slot] = []
        self._slot_shared[slot] = 0
        self.tables[slot] = 0
        self.lengths[slot] = 0
        self.next_input[slot] = 0
        self.slots[slot] = None

    def _finish(self, slot: int) -> None:
        req = self.slots[slot]
        req.state = RequestState.FINISHED
        req.t_done = self.clock()
        self.finished.append(req)
        self._record("request_finished", value=float(len(req.tokens)), rid=req.rid,
                     tokens=len(req.tokens))
        self._release(slot)

    def _preempt(self, slot: int, why: str = "pool") -> None:
        """Recompute-style preemption: pages freed, generated tokens kept;
        the request requeues at the front. ``why``: ``pool`` (page
        pressure) or ``sdc`` (a corrupt page it read)."""
        req = self.slots[slot]
        req.preemptions += 1
        req.state = RequestState.QUEUED
        self._record("preemption", rid=req.rid, why=why, tokens_done=len(req.tokens))
        self._release(slot)
        self.queue.appendleft(req)

    # ------------------------------------------------------------- deadlines
    def _expire(self, req: Request, where: str, now: float) -> None:
        req.state = RequestState.EXPIRED
        req.reject_reason = f"deadline_{where}"
        self.expired.append(req)
        t0 = req.t_submit if req.t_submit is not None else now
        self._record("deadline_miss", value=now - t0, rid=req.rid, where=where,
                     tokens_done=len(req.tokens))

    def _sweep_deadlines(self) -> int:
        """Evict expired requests: queued ones past their TTFT deadline (while
        the first token is owed; a preempted request has delivered it) or
        their end-to-end one, running ones past their end-to-end one (pages
        freed). Returns the number evicted; any eviction is followed by the
        page audit."""
        now = self.clock()
        evicted = 0
        for req in list(self.queue):
            t0 = req.t_submit if req.t_submit is not None else now
            miss_ttft = (req.ttft_deadline_s is not None and req.t_first_token is None
                         and now - t0 > req.ttft_deadline_s)
            miss_e2e = req.deadline_s is not None and now - t0 > req.deadline_s
            if miss_ttft or miss_e2e:
                self.queue.remove(req)
                self._expire(req, "queued", now)
                evicted += 1
        for slot in self.active_slots:
            req = self.slots[slot]
            t0 = req.t_submit if req.t_submit is not None else now
            if req.deadline_s is not None and now - t0 > req.deadline_s:
                self._release(slot)
                self._expire(req, "running", now)
                evicted += 1
        if evicted:
            self._audit_after_recovery("deadline_sweep")
        return evicted

    # ----------------------------------------------------- dispatch recovery
    def _phase(self, kind: str):
        if self.watchdog is None:
            return nullcontext()
        return self.watchdog.phase(f"serving_{kind}")

    def _dispatch(self, kind: str, fn, *args: Any, **kw: Any) -> Any:
        """One dispatch episode: ``fn`` tried ``dispatch_retries + 1`` times,
        with ``backoff_delay`` between attempts; every failed attempt counts
        as ``dispatch_error``. Raises :class:`_DispatchFailure` when all fail.
        Each attempt runs in the watchdog's ``serving_<kind>`` phase, the
        chaos plan's injections first (a stall is seen by the deadline, a
        raise tears no device state)."""
        attempts = self.dispatch_retries + 1
        last: Optional[BaseException] = None
        for attempt in range(1, attempts + 1):
            idx = self._dispatch_count
            self._dispatch_count += 1
            try:
                with self._phase(kind):
                    serving_dispatch_fault(kind, idx)
                    out = fn(*args, **kw)
                self._consecutive_failures[kind] = 0
                return out
            except Exception as e:  # the episode's verdict comes after every attempt
                last = e
                self._record("dispatch_error", kind=kind, attempt=attempt,
                             error=f"{type(e).__name__}: {e}"[:200])
                logger.warning(f"serving {kind} dispatch failed (attempt {attempt}/{attempts}): "
                               f"{type(e).__name__}: {e}")
                if attempt < attempts:
                    time.sleep(backoff_delay(attempt, self.retry_base_delay,
                                             self.retry_max_delay))
        raise _DispatchFailure(kind, attempts, last)

    def _on_dispatch_episode_failed(self, fail: _DispatchFailure, affected: List[int],
                                    block: Optional[int] = None) -> None:
        """A whole episode failed: quarantine a decode block shape after
        ``quarantine_after`` failures, preempt and requeue the affected slots
        (newest first, so the oldest ends at the queue's head), audit the
        pool, and raise :class:`ServingFaultError` once
        ``dispatch_failure_budget`` consecutive episodes of this kind failed."""
        if block is not None and block > 1:
            n = self._block_failures.get(block, 0) + 1
            self._block_failures[block] = n
            if n >= self.quarantine_after and block not in self._quarantined_blocks:
                self._quarantined_blocks.add(block)
                self._record("block_quarantined", value=block, block=block, failures=n)
        for slot in sorted(affected, key=lambda s: self._admit_seq[s], reverse=True):
            if self.slots[slot] is not None:
                self._preempt(slot)
        n = self._consecutive_failures.get(fail.kind, 0) + 1
        self._consecutive_failures[fail.kind] = n
        self._record("dispatch_failed", kind=fail.kind, attempts=fail.attempts, consecutive=n,
                     error=f"{type(fail.last).__name__}: {fail.last}"[:200])
        self._audit_after_recovery(f"dispatch_failed[{fail.kind}]")
        if n >= self.dispatch_failure_budget:
            raise ServingFaultError(
                f"{n} consecutive {fail.kind} dispatch episodes failed (budget "
                f"{self.dispatch_failure_budget}); last: {fail}") from fail.last

    # ----------------------------------------------------------- page audit
    def audit(self) -> Dict[str, Any]:
        """The allocator's conservation invariant plus the scheduler's
        cross-checks: every allocated page is owned by exactly as many slots
        as its refcount says, no slot lists a page twice, no slot's write
        frontier lies inside its borrowed prefix pages, and no page shared
        between slots reaches a slot's write frontier (the next append lands
        at ``lengths[slot]``). With page fingerprints, every stamped shared
        page is re-fingerprinted too."""
        fp_fn = (getattr(self.executor, "fingerprint_pages", None)
                 if self.page_fingerprints else None)
        rep = (self.allocator.audit(expected_fingerprints=self._page_fp, fingerprint_fn=fp_fn)
               if fp_fn is not None else self.allocator.audit())
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
            if self._slot_shared[s_idx] * self.page_size > frontier:
                errors.append(f"slot {s_idx} records {self._slot_shared[s_idx]} borrowed "
                              f"prefix pages but its write frontier {frontier} is inside them")
            for idx, p in enumerate(pages):
                if (self.allocator.refcount(p) > 1
                        and (idx + 1) * self.page_size > frontier):
                    errors.append(f"shared page {p} (table index {idx}) reaches slot "
                                  f"{s_idx}'s write frontier {frontier}")
        rep["errors"] = errors
        rep["ok"] = not errors
        rep["page_stats"] = dict(self.page_stats)
        return rep

    def _audit_after_recovery(self, context: str) -> None:
        rep = self.audit()
        if not rep["ok"]:
            self._record("page_audit_failed", context=context,
                         errors="; ".join(rep["errors"])[:400])
            raise RuntimeError(f"page conservation broken after {context}: {rep['errors']}")

    # ---------------------------------------------- KV-page data integrity
    def _stamp_pages(self, pages: List[int]) -> None:
        """Fingerprint pages whose content just became immutable (full
        prompt pages at registration). Stamp once: a page keeps its first
        writer's fingerprint (a re-stamp would bless whatever is there now);
        stamps die with the page in :meth:`_release`."""
        if not self.page_fingerprints:
            return
        fn = getattr(self.executor, "fingerprint_pages", None)
        todo = [p for p in pages if p not in self._page_fp]
        if fn is None or not todo:
            return
        for p, fp in zip(todo, fn(todo)):
            self._page_fp[p] = int(fp)

    def _verify_pages(self, pages: List[int], context: str) -> List[int]:
        """Re-fingerprint the stamped ones of ``pages``; returns the
        mismatches, each recorded as ``sdc_detected``."""
        fn = getattr(self.executor, "fingerprint_pages", None)
        check = [p for p in pages if p in self._page_fp]
        if fn is None or not check:
            return []
        bad = [p for p, fp in zip(check, fn(check)) if int(fp) != self._page_fp[p]]
        for p in bad:
            self._record("sdc_detected", domain="kv_page", page=int(p), context=context,
                         refcount=self.allocator.refcount(p))
        return bad

    def _quarantine_page(self, page: int, context: str) -> None:
        """Contain and heal a corrupt KV page: out of the prefix index (no
        admission borrows it again), its stamp voided, and every slot
        reading it preempted, recompute-style: each re-prefills prompt +
        kept tokens into clean pages, and greedy decoding reproduces its
        stream. Never a retry over rotten KV."""
        if self.prefix_cache is not None:
            self.prefix_cache.forget([page])
        self._page_fp.pop(page, None)
        victims = [i for i, pages in enumerate(self._slot_pages)
                   if page in pages and self.slots[i] is not None]
        for i in victims:
            self._preempt(i, why="sdc")
        self._record("sdc_healed", domain="kv_page", page=int(page), context=context,
                     victims=len(victims))
        self._audit_after_recovery(f"sdc_{context}")

    def _integrity_scan(self) -> None:
        """The budgeted background sweep: up to ``pages_scan_per_step``
        stamped pages verified round-robin a step, a mismatch quarantined.
        Also where the chaos plan's ``flip_bit_at`` (domain ``kv_page``)
        lands: in a stamped page's pool bytes, a shared page first."""
        flip = sdc_flip_fault(self.steps, scope="serving")
        if flip is not None and self._page_fp:
            corrupt = getattr(self.executor, "corrupt_page_bit", None)
            if corrupt is not None:
                shared = [p for p in sorted(self._page_fp) if self.allocator.refcount(p) > 1]
                target = (shared or sorted(self._page_fp))[0]
                corrupt(target)
                self._record("chaos_injected", kind="sdc_flip", page=int(target))
        stamped = sorted(self._page_fp)
        if not stamped or self.pages_scan_per_step <= 0:
            return
        k = min(self.pages_scan_per_step, len(stamped))
        start = self._page_scan_rr % len(stamped)
        batch = [stamped[(start + j) % len(stamped)] for j in range(k)]
        self._page_scan_rr = (start + k) % len(stamped)
        for p in self._verify_pages(batch, "scan"):
            self._quarantine_page(p, "scan")

    def close(self) -> None:
        """Stop a watchdog the engine made for this scheduler (a no-op for
        one the caller owns, or none)."""
        if self._owns_watchdog and self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None

    # ------------------------------------------------------------ admission
    def _claim_pages(self, req: Request, need: int) -> Optional[tuple]:
        """Pages for one admission: the borrowed prefix pages from the index
        (a reference taken on each) and fresh ones for the rest. Returns
        (pages, borrowed count), or None, claiming nothing, when the pool
        cannot cover the unshared remainder: the free list is probed before
        any reference is taken. The borrowed count is below ``need``, since
        the first decode write lands past the prompt's full pages. The
        prompt's chain is hashed once and kept on the request, and the index
        counts a hit only at the admission that proceeds."""
        shared: List[int] = []
        hashes = ()
        if self.prefix_cache is not None:
            hashes = getattr(req, "_prefix_hashes", None)
            if hashes is None:
                hashes = prefix_chain_hashes(np.asarray(req.prompt), self.page_size)
                req._prefix_hashes = hashes
            shared = self.prefix_cache.lookup_chain(hashes)[:need]
        if shared and self.page_fingerprints:
            # a trust boundary: these pages are about to serve another
            # request's prefix. A mismatch cuts the borrow at the first
            # corrupt page (the chain's suffix runs through it) and
            # quarantines; the admission goes on as a (partial) miss
            bad = self._verify_pages(shared, "share")
            if bad:
                cut = min(shared.index(p) for p in bad)
                for p in bad:
                    self._quarantine_page(p, "share")
                shared = shared[:cut]
        if not self.allocator.can_alloc(need - len(shared)):
            return None
        if shared:
            self.allocator.share(shared)
        own = self.allocator.alloc(need - len(shared))
        if own is None:  # the chaos plan's alloc_fail_at, through the normal path
            if shared:
                self.prefix_cache.forget(self.allocator.free(shared))
            return None
        if self.prefix_cache is not None:
            self.prefix_cache.count(hashes, shared)
        self.page_stats["logical"] += need
        self.page_stats["physical"] += len(own)
        self.page_stats["shared"] += len(shared)
        return shared + own, len(shared)

    def _admit(self) -> int:
        # phase 1: claim slots + pages for everything that fits this cycle,
        # in FIFO order; a head that does not fit blocks the queue
        batch = []  # (slot, context tokens, first unshared position)
        free = deque(s for s in range(self.num_slots) if self.slots[s] is None)
        while free and self.queue:
            req = self.queue[0]
            ctx = req.context_len
            # +1: the first decode step appends its token's KV at position
            # ctx, which may open a fresh page
            need = pages_for(ctx + 1, self.page_size)
            claim = self._claim_pages(req, need)
            if claim is None:
                break
            pages, shared = claim
            slot = free.popleft()
            # remove THIS request: a page quarantined during the claim
            # requeues its borrowers at the front
            self.queue.remove(req)
            self._slot_pages[slot] = pages
            self._slot_shared[slot] = shared
            self.tables[slot] = 0
            self.tables[slot, :len(pages)] = pages
            tokens = np.concatenate([np.asarray(req.prompt, np.int32),
                                     np.asarray(req.tokens, np.int32)])
            self.lengths[slot] = ctx
            self.slots[slot] = req
            self._admissions += 1
            self._admit_seq[slot] = self._admissions
            req.state = RequestState.RUNNING
            batch.append((slot, tokens, shared * self.page_size))
        if not batch:
            return 0
        # phase 2: prefill the whole admission cycle, batched when the
        # executor can. With the prefix cache each row also carries its first
        # unshared position, where its KV scatter starts (the forward runs
        # the whole context); without it the 3-tuple protocol stands. A
        # failed episode requeues the whole cycle: no token was appended yet
        try:
            if hasattr(self.executor, "prefill_many"):
                items = [(slot, toks, self.tables[slot])
                         + ((start,) if self.prefix_cache is not None else ())
                         for slot, toks, start in batch]
                results = self._dispatch("prefill", self.executor.prefill_many, items)
            else:
                results = {}
                for slot, toks, start in batch:
                    args = (slot, toks, self.tables[slot])
                    if self.prefix_cache is not None:
                        args += (start,)
                    results[slot] = int(self._dispatch("prefill", self.executor.prefill, *args))
        except _DispatchFailure as fail:
            self._on_dispatch_episode_failed(fail, [slot for slot, _, _ in batch])
            return 0
        for slot, _, _ in batch:
            req = self.slots[slot]
            first = int(results[slot])
            self.next_input[slot] = first
            # prefill's sample is the next new token, for a fresh admission
            # and for a re-prefill after preemption alike
            req.tokens.append(first)
            if req.t_first_token is None:
                req.t_first_token = self.clock()
            if self.prefix_cache is not None:
                # the slot's full prompt pages hold their final KV now: index
                # them for later arrivals (first writer wins) and stamp them
                self.prefix_cache.register(np.asarray(req.prompt), self._slot_pages[slot])
                self._stamp_pages(self._slot_pages[slot][:len(req.prompt) // self.page_size])
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
        while k > 1 and k in self._quarantined_blocks:
            k //= 2  # shapes that keep failing dispatch are off the menu
        return k

    def step(self) -> int:
        """Expire blown deadlines, admit what fits, then run one decode step
        (or one safe decode block, or with a drafter one speculation window)
        over the slot array. Returns the tokens produced."""
        self._sweep_deadlines()
        if self.page_fingerprints:
            # before admission: a rotten page is quarantined before this
            # step's admissions could borrow it
            self._integrity_scan()
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
            except Exception as e:  # a broken drafter must not stop serving: no drafts
                self._record("drafter_error", error=f"{type(e).__name__}: {e}"[:200])
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
        try:
            outs, n_acc = self._dispatch("verify", self.executor.verify, win,
                                         self.tables.copy(), self.lengths.copy(), mask, eos,
                                         budget)
        except _DispatchFailure as fail:
            # no token of the window was seen: every slot requeues with exactly
            # its tokens (whatever the call wrote lies past any borrowed page,
            # in pages freed with the slot)
            self._on_dispatch_episode_failed(fail, active)
            return 0
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
        self._record("spec_window", value=float(produced), k=k, drafted=step_offered,
                     accepted=step_accepted,
                     accept_rate=round(step_accepted / max(step_offered, 1), 4),
                     tokens_per_dispatch=produced, drafter=self.spec_stats["drafter"])
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
        try:
            out = np.asarray(self._dispatch("decode", self.executor.decode,
                                            self.next_input.copy(), self.tables.copy(),
                                            self.lengths.copy(), mask, steps=block))
        except _DispatchFailure as fail:
            # no token of the episode was seen: every active slot requeues
            # with exactly its tokens, so the healed rerun is greedy-identical
            self._on_dispatch_episode_failed(fail, active, block=block)
            return 0
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
