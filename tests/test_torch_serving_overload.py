"""The port's overload control, request deadlines and dispatch-fault recovery
against the JAX package's scheduler: each case of the JAX chaos and overload
tests (``tests/test_serving_chaos.py``) runs on both schedulers with one
device-free fake executor and a manual clock, and the two must give the same
tokens, request states and reject reasons, verdicts (with the shed request),
``counters``, ``page_stats``, dispatches, and the audit after every step.

Faults come from the executor itself (it raises at given dispatch indices,
or at every decode block of a given size), so no chaos plan is involved;
with none installed, the JAX scheduler's chaos hook does nothing. Retry
delays are 1-2 ms, as in the JAX tests."""

import dataclasses

import numpy as np
import pytest

from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.inference.serving import bench as jbench
from deepspeed_tpu.resilience import install_plan
from deepspeed_tpu_torch.inference import serving
from deepspeed_tpu_torch.inference.serving import bench

from _torch_sched_pair import drive


@pytest.fixture(autouse=True)
def _no_chaos_plan():
    install_plan(None)
    yield
    install_plan(None)


def _arange_reqs(spec, **extra):
    return [(np.arange(1, n + 1, dtype=np.int32), m, dict(extra)) for n, m in spec]


CHAOS_SPEC = ((3, 6), (5, 4), (2, 8), (4, 3))  # the JAX chaos tests' workload
SUBMIT_ALL = [("submit", i) for i in range(4)] + [("run", 0.0)]


def _ones(n, m, **extra):
    return (np.ones(n, np.int32), m, extra)


CASES = {
    # ------------------------------------------------------ overload control
    "queue_depth_cap": dict(
        requests=[(np.array([1]), 2, {}), (np.array([1]), 2, {}), (np.array([9]), 2, {})],
        script=[("submit", 0), ("submit", 1), ("submit", 2), ("run", 0.0)],
        sched=dict(num_slots=1, max_queue=2)),
    "token_backpressure": dict(
        requests=[_ones(8, 8), _ones(4, 4)],
        script=[("submit", 0), ("submit", 1), ("run", 0.0)],
        sched=dict(num_slots=1, max_queued_tokens=20)),
    "reject_newest_caps_and_serves": dict(
        requests=_arange_reqs(CHAOS_SPEC), script=SUBMIT_ALL,
        sched=dict(num_slots=1, max_queue=2)),
    "reject_largest_sheds_the_biggest": dict(
        requests=[_ones(12, 8), _ones(3, 3), _ones(20, 8)],
        script=[("submit", 0), ("submit", 1), ("submit", 2), ("run", 0.0)],
        sched=dict(num_slots=1, max_queued_tokens=24, shed_policy="reject_largest")),
    "reject_largest_sheds_to_admit": dict(
        requests=[_ones(8, 6), _ones(8, 6), _ones(6, 6), _ones(5, 8)],
        script=[("submit", 0), ("submit", 1), ("submit", 2), ("submit", 3), ("run", 0.0)],
        sched=dict(num_slots=1, max_queued_tokens=30, shed_policy="reject_largest")),
    "reject_largest_never_sheds_without_admitting": dict(
        requests=[_ones(2, 2), _ones(8, 8)],
        script=[("submit", 0), ("submit", 1), ("run", 0.0)],
        sched=dict(num_slots=1, max_queue=1, shed_policy="reject_largest")),
    # ------------------------------------------------------------- deadlines
    "e2e_deadline_under_load": dict(
        requests=_arange_reqs(((3, 6),)) + [(np.array([7]), 4, {})] * 2
        + _arange_reqs(((3, 6),)),
        script=[("submit", 0), ("submit", 1), ("submit", 2), ("step",), ("clock", 11.0),
                ("step",), ("clock", 12.0), ("submit", 3), ("run", 0.0)],
        sched=dict(num_slots=1, deadline_s=10.0)),
    "ttft_deadline_expires_only_queued": dict(
        requests=[(np.array([1]), 10, {}), (np.array([2]), 10, {})],
        script=[("submit", 0), ("submit", 1), ("step",), ("clock", 2.0), ("run", 0.0)],
        sched=dict(num_slots=1, ttft_deadline_s=1.0)),
    "ttft_deadline_spares_preempted": dict(
        requests=[(np.array([1, 2, 3]), 8, {}), (np.array([50, 51, 52]), 8, {})],
        script=[("submit", 0), ("submit", 1), ("run", 2.0)],
        sched=dict(num_slots=2, num_pages=8, page_size=2, pages_per_seq=8,
                   ttft_deadline_s=1.0)),
    "per_request_deadline_over_default": dict(
        requests=[(np.array([1]), 20, dict(deadline_s=1.0)), (np.array([2]), 4, {})],
        script=[("submit", 0), ("submit", 1), ("step",), ("clock", 2.0), ("run", 0.0)],
        sched=dict(num_slots=2, deadline_s=100.0)),
    # ------------------------------------------------ dispatch-fault recovery
    "retry_in_place": dict(
        requests=_arange_reqs(CHAOS_SPEC), script=SUBMIT_ALL, sched=dict(),
        executor=dict(fail_at=(2,))),
    "decode_block_episode_healed_by_requeue": dict(
        requests=_arange_reqs(CHAOS_SPEC), script=SUBMIT_ALL,
        sched=dict(decode_block=4, dispatch_retries=2), executor=dict(fail_at=(3, 4, 5))),
    "prefill_episode_healed_by_requeue": dict(
        requests=_arange_reqs(CHAOS_SPEC), script=SUBMIT_ALL,
        sched=dict(dispatch_retries=1), executor=dict(fail_at=(0, 1), batched=True)),
    "block_shape_quarantined": dict(
        requests=_arange_reqs(((3, 9), (5, 9))), script=[("submit", 0), ("submit", 1),
                                                          ("run", 0.0)],
        sched=dict(decode_block=4, dispatch_retries=1, quarantine_after=2,
                   dispatch_failure_budget=8), executor=dict(fail_steps=4)),
    "verify_episode_healed_by_requeue": dict(
        requests=_arange_reqs(((3, 9), (5, 7), (2, 8))), script=[("submit", i) for i in range(3)]
        + [("run", 0.0)], sched=dict(dispatch_retries=1), executor=dict(fail_at=(2, 3)),
        drafter=True),
    "failure_budget_raises": dict(
        requests=[(np.array([1]), 4, {})], script=[("submit", 0), ("run", 0.0)],
        sched=dict(dispatch_retries=0, dispatch_failure_budget=3),
        executor=dict(fail_at=range(1, 100, 2))),
}

# the fault-free run each recovery case must reproduce
CLEAN = {"retry_in_place": dict(), "decode_block_episode_healed_by_requeue":
         dict(decode_block=4), "prefill_episode_healed_by_requeue": dict(),
         "block_shape_quarantined": dict(decode_block=4),
         "verify_episode_healed_by_requeue": dict()}


def _run(pkg, name, clean=False):
    """Case ``name`` on package ``pkg``'s scheduler; ``clean``: its
    fault-free twin."""
    case = CASES[name]
    sched, executor = (CLEAN[name], None) if clean else (case["sched"], case.get("executor"))
    return drive(pkg, case["requests"], case["script"], sched, executor,
                 drafter=case.get("drafter", False))


@pytest.mark.parametrize("name", sorted(CASES))
def test_overload_deadline_and_fault_cases_match_jax(name):
    ref, out = _run(jserving, name), _run(serving, name)
    assert out == ref
    assert all(out["audits"]) and out["audit_ok"] and out["allocated"] == 0
    counters, states = out["counters"], out["states"]
    if name in CLEAN:  # healed runs are greedy-identical to a fault-free one
        assert out["tokens"] == _run(serving, name, clean=True)["tokens"]
        assert set(states) == {"finished"}
    # the JAX tests' own assertions
    if name == "queue_depth_cap":
        assert out["verdicts"][2] == (False, "queue_full", None)
        assert out["reject_reasons"][2] == "queue_full" and states[:2] == ["finished"] * 2
    if name == "token_backpressure":
        assert out["verdicts"][1] == (False, "token_backlog", None)
    if name == "reject_newest_caps_and_serves":
        assert [v[0] for v in out["verdicts"]] == [True, True, False, False]
        assert states == ["finished", "finished", "rejected", "rejected"]
    if name == "reject_largest_sheds_the_biggest":
        assert out["verdicts"] == [(True, "admitted", None), (True, "admitted", 0),
                                   (False, "token_backlog", None)]
        assert out["reject_reasons"][0] == "shed_for_smaller"
    if name == "reject_largest_sheds_to_admit":
        # each newcomer sheds one 14-token request and is admitted
        assert out["verdicts"][2][2] in (0, 1) and out["verdicts"][3][2] in (0, 1)
        assert out["verdicts"][2][2] != out["verdicts"][3][2]
        assert counters["request_shed"] == 2 and states[2:] == ["finished"] * 2
    if name == "reject_largest_never_sheds_without_admitting":
        assert out["verdicts"][1] == (False, "queue_full", None)
        assert states == ["finished", "rejected"] and counters["request_shed"] == 1
    if name == "e2e_deadline_under_load":
        assert states == ["expired"] * 3 + ["finished"] and counters["deadline_miss"] == 3
        assert out["tokens"][3] == [(4 + i) % 97 for i in range(6)]
    if name == "ttft_deadline_expires_only_queued":
        assert states == ["finished", "expired"]
        assert out["reject_reasons"][1] == "deadline_queued"
    if name == "ttft_deadline_spares_preempted":
        assert out["preemptions"][1] >= 1 and states == ["finished", "finished"]
        assert out["tokens"] == [[(4 + i) % 97 for i in range(8)],
                                 [(53 + i) % 97 for i in range(8)]]
    if name == "per_request_deadline_over_default":
        assert states == ["expired", "finished"]
    if name == "retry_in_place":
        assert counters["dispatch_error"] == 1 and "dispatch_failed" not in counters
    if name == "decode_block_episode_healed_by_requeue":
        assert counters["dispatch_failed"] == 1 and counters["dispatch_error"] == 3
        assert sum(out["preemptions"]) >= 1
    if name == "prefill_episode_healed_by_requeue":
        assert counters["dispatch_failed"] == 1 and counters["dispatch_error"] == 2
    if name == "block_shape_quarantined":
        assert out["quarantined"] == [4] and counters["block_quarantined"] == 1
        assert counters["dispatch_failed"] == 2
        assert 4 not in [d for kind, d in out["calls"][-5:] if kind == "decode"]
    if name == "verify_episode_healed_by_requeue":
        assert counters["dispatch_failed"] == 1 and counters["dispatch_error"] == 2
        assert out["calls"][2:4] == [("verify", 5)] * 2 and sum(out["preemptions"]) == 2
        stats = out["spec_stats"]
        assert stats["full_accept_windows"] > 0 and stats["full_reject_windows"] > 0
    if name == "failure_budget_raises":
        assert out["raised"][0] == "ServingFaultError" and "3 consecutive" in out["raised"][1]
        assert out["raised"][2:] == ("RuntimeError", "injected fault at dispatch 5")
    else:
        assert out["raised"] is None


def test_scheduler_rejects_an_unknown_shed_policy():
    for pkg in (jserving, serving):
        with pytest.raises(ValueError, match="shed_policy"):
            pkg.ContinuousBatchingScheduler(None, num_slots=1, num_pages=4, page_size=4,
                                            pages_per_seq=2, shed_policy="drop_oldest")
    assert serving.SHED_POLICIES == jserving.SHED_POLICIES


def test_report_counts_expired_requests_as_deadline_misses():
    """``_report`` of both packages on the same request outcomes: expired
    requests count as deadline misses, not as unfinished; shed ones as
    shed; an unfinished accepted request past the SLO as a miss."""
    def outcomes(pkg):
        reqs = [pkg.Request(prompt=np.zeros(3, np.int32), max_new_tokens=4,
                            arrival_time=0.1 * i) for i in range(5)]
        done = dict(state=pkg.RequestState.FINISHED, tokens=[1, 2, 3, 4], t_first_token=0.5,
                    t_done=0.9)
        for r, over in zip(reqs, (done, {**done, "t_done": 4.0},
                                  dict(state=pkg.RequestState.EXPIRED, tokens=[1]),
                                  dict(state=pkg.RequestState.REJECTED),
                                  dict(state=pkg.RequestState.RUNNING, tokens=[1, 2],
                                       t_first_token=0.6))):
            for k, v in over.items():
                setattr(r, k, v)
        return reqs

    ref = jbench._report(outcomes(jserving), 0.0, 5.0, "continuous", slo_s=2.0)
    out = bench._report(outcomes(serving), 0.0, 5.0, "continuous", slo_s=2.0)
    assert out == ref
    assert (out["unfinished"], out["shed"], out["deadline_misses"]) == (1, 1, 3)
    assert out["deadline_miss_rate"] == 0.75


def test_request_work_tokens_and_deadline_fields_are_the_references():
    ref = {f.name for f in dataclasses.fields(jserving.Request)}
    out = {f.name for f in dataclasses.fields(serving.Request)}
    # session_id, kv_payload, tenant_id and tier belong to ROADMAP.md A10
    assert ref - out == {"session_id", "kv_payload", "tenant_id", "tier"} and out <= ref
    r = serving.Request(prompt=np.zeros(5, np.int32), max_new_tokens=7, tokens=[1, 2])
    assert r.work_tokens == 10 == jserving.Request(prompt=np.zeros(5, np.int32),
                                                   max_new_tokens=7, tokens=[1, 2]).work_tokens
