"""Request-level serving benchmark: open-loop arrivals, TTFT and tokens/s.

Counterpart of ``deepspeed_tpu/inference/serving/bench.py``. Open loop
(arrivals follow a Poisson clock whatever the completions) is the honest
serving load: a closed loop would slow its arrivals whenever the server
stalls and hide the tail it is meant to expose. The workload is synthetic
and seeded (the reference's numpy draws, so a seed gives both packages the
same requests), and two runners share one report schema:

- :func:`run_continuous`: the paged continuous-batching stack
  (``ServingEngine`` + ``ContinuousBatchingScheduler``);
- :func:`run_static_baseline`: ``InferenceEngine.generate`` over batches in
  arrival order, each padded to the longest prompt and decoded to the
  longest ``max_new_tokens``.

``make_tiered_workload`` and the per-tier report rows go with SLO tiers
(ROADMAP.md A10).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .scheduler import ContinuousBatchingScheduler, Request, RequestState


def percentile(xs: Sequence[float], p: float) -> float:
    if not xs:
        return float("nan")
    xs = sorted(xs)
    idx = min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1))))
    return float(xs[idx])


def make_open_loop_workload(n_requests: int, rate_rps: float, prompt_len: tuple,
                            max_new: tuple, vocab_size: int, seed: int = 0,
                            eos_token_id: Optional[int] = None) -> List[Request]:
    """Poisson arrivals at ``rate_rps``; prompt and generation lengths
    uniform in the given inclusive ranges."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        pl = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        mn = int(rng.integers(max_new[0], max_new[1] + 1))
        out.append(Request(prompt=rng.integers(0, vocab_size, (pl,)).astype(np.int32),
                           max_new_tokens=mn, eos_token_id=eos_token_id, arrival_time=t))
    return out


def _report(requests: Sequence[Request], t0: float, t_end: float, mode: str,
            extra: Optional[Dict] = None, slo_s: Optional[float] = None) -> Dict:
    """The shared report schema. ``slo_s`` is an evaluation deadline
    (arrival -> completion) applied identically to every run, for goodput.
    TTFT percentiles cover accepted requests only."""
    ttft, per_tok, total_tokens = [], [], 0
    goodput_tokens = 0
    late = 0
    for r in requests:
        arrive = t0 + r.arrival_time
        if r.t_first_token is not None:
            ttft.append(r.t_first_token - arrive)
        n = min(len(r.tokens), r.max_new_tokens)
        total_tokens += n
        if r.t_done is not None:
            if slo_s is None or r.t_done - arrive <= slo_s:
                goodput_tokens += n
            else:
                late += 1
        # run-to-completion baselines deliver every token at once
        # (t_done == t_first): per-token cadence is undefined there, not 0
        if r.t_done is not None and n > 1 and r.t_done > r.t_first_token:
            per_tok.append((r.t_done - r.t_first_token) / (n - 1))

    def ms(x, nd=2):
        return None if x != x else round(x * 1e3, nd)  # NaN -> JSON null

    shed = [r for r in requests if r.state is RequestState.REJECTED]
    accepted = len(requests) - len(shed)
    unfinished = [r for r in requests
                  if r.state is not RequestState.REJECTED and r.t_done is None]
    if slo_s is not None:
        late += sum(1 for r in unfinished if t_end - (t0 + r.arrival_time) > slo_s)
    wall = max(t_end - t0, 1e-9)
    row = {
        "mode": mode,
        "requests": len(requests),
        "finished": sum(r.t_done is not None for r in requests),
        "total_tokens": int(total_tokens),
        "wall_s": round(wall, 3),
        "tokens_per_sec": round(total_tokens / wall, 2),
        "ttft_p50_ms": ms(percentile(ttft, 50)),
        "ttft_p99_ms": ms(percentile(ttft, 99)),
        "per_token_p50_ms": ms(percentile(per_tok, 50), 3),
        "per_token_p99_ms": ms(percentile(per_tok, 99), 3),
        "shed": len(shed),
        "shed_rate": round(len(shed) / max(len(requests), 1), 4),
        "unfinished": len(unfinished),
        "deadline_misses": late,
        "deadline_miss_rate": round(late / max(accepted, 1), 4),
        "goodput_tokens_per_sec": round(goodput_tokens / wall, 2),
    }
    if slo_s is not None:
        row["slo_s"] = slo_s
    if extra:
        row.update(extra)
    return row


def run_continuous(engine, workload: Sequence[Request], max_wall_s: float = 600.0,
                   slo_s: Optional[float] = None,
                   scheduler: Optional[ContinuousBatchingScheduler] = None) -> Dict:
    """Drive the scheduler under the workload's arrival clock. Rejected
    submissions are terminal and score as shed."""
    sched = scheduler if scheduler is not None else engine.make_scheduler()
    pending = sorted(workload, key=lambda r: r.arrival_time)
    t0 = time.monotonic()
    i = 0
    while i < len(pending) or not sched.idle:
        now = time.monotonic() - t0
        if now > max_wall_s:
            break
        while i < len(pending) and pending[i].arrival_time <= now:
            sched.submit(pending[i])
            i += 1
        if sched.idle:
            if i < len(pending):  # nothing in flight: sleep to the next arrival
                time.sleep(min(max(pending[i].arrival_time - now, 0.0), 0.25))
            continue
        sched.step()
    t_end = time.monotonic()
    stats = dict(sched.page_stats)
    extra = {
        "decode_steps": sched.steps,
        "preemptions": sum(r.preemptions for r in workload),
        "num_slots": sched.num_slots,
        "hbm_token_slots": engine.hbm_token_slots(),
        "compiled_programs": len(engine.compile_log),
        "recovery_counters": dict(sched.counters),
        "pool_audit_ok": bool(sched.audit()["ok"]),
        "page_stats": stats,
        "physical_logical_page_ratio": round(stats["physical"] / stats["logical"], 4)
        if stats["logical"] else None,
    }
    if sched.drafter is not None:
        # the speculation ledger: the accept rate, and the tokens a verify
        # call produced on average (1.0: no better than plain decode)
        ss = dict(sched.spec_stats)
        ss["accept_rate"] = round(ss["accepted"] / max(ss["drafted"], 1), 4)
        ss["tokens_per_dispatch"] = round(ss["committed_tokens"] / max(ss["windows"], 1), 3)
        extra["spec"] = ss
    return _report(workload, t0, t_end, "continuous", slo_s=slo_s, extra=extra)


def estimate_saturation_rps(engine, prompt_len: tuple, max_new: tuple, vocab_size: int,
                            n_requests: int = 8, seed: int = 1234) -> float:
    """The server's saturation point: a short closed-loop batch (every
    request present at t=0) whose aggregate tokens/s is converted to
    requests/s at the workload's mean generation length."""
    wl = make_open_loop_workload(n_requests, rate_rps=1e9, prompt_len=prompt_len,
                                 max_new=max_new, vocab_size=vocab_size, seed=seed)
    rep = run_continuous(engine, wl)
    mean_gen = float(np.mean([r.max_new_tokens for r in wl]))
    return float(rep["tokens_per_sec"]) / max(mean_gen, 1.0)


def run_static_baseline(infer_engine, workload: Sequence[Request], batch_size: int,
                        max_wall_s: float = 600.0) -> Dict:
    """Static batching over the same requests: fill a batch in arrival
    order, right-pad the prompts, generate everyone to the batch's largest
    ``max_new_tokens``; first token and completion land when the batch
    returns."""
    pending = sorted(workload, key=lambda r: r.arrival_time)
    # one batch shape for the whole run (workload max prompt and generation)
    tmax = max(len(r.prompt) for r in pending)
    gen = max(r.max_new_tokens for r in pending)
    t0 = time.monotonic()
    for start in range(0, len(pending), batch_size):
        group = pending[start:start + batch_size]
        # open loop: the batch cannot launch before its last member arrives
        launch = t0 + max(r.arrival_time for r in group)
        now = time.monotonic()
        if now + max_wall_s < launch:
            break
        if launch > now:
            time.sleep(launch - now)
        if time.monotonic() - t0 > max_wall_s:
            break
        ids = np.zeros((batch_size, tmax), np.int32)
        for j, r in enumerate(group):
            ids[j, :len(r.prompt)] = r.prompt
        out = np.asarray(infer_engine.generate(ids, max_new_tokens=gen))
        t_batch = time.monotonic()
        for j, r in enumerate(group):
            r.t_first_token = t_batch
            r.t_done = t_batch
            r.tokens = [int(x) for x in out[j, tmax:tmax + r.max_new_tokens]]
    t_end = time.monotonic()
    return _report(workload, t0, t_end, "static", extra={"batch_size": batch_size})
