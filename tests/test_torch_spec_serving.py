"""The port's speculative serving end to end vs the JAX package's
``ServingEngine``: the same seeded workload (the JAX speculation tests'
draws, every request present at the start) through both engines with a
drafter, on the JAX speculation tests' configuration (GPT 2 layers, d
32, 4 heads, vocab 64; 2 slots, page 8, model length 64, prefill chunk 16,
fp32, decode blocks of 2, ``spec_k`` 4). Weights, and the draft model's,
cross through ``deepspeed_tpu_torch.bridge``.

The bar is the reference's own: greedy tokens identical per request (fp32
on both sides; argmax of logits that agree to ~1e-6), and the speculation
ledger (``spec_stats``: windows, drafted, accepted, ...) equal, since it is
integer bookkeeping over those tokens."""

import numpy as np
import pytest

import jax

from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as G
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import serving
from deepspeed_tpu_torch.models import gpt as TG

CFG = G.GPTConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4, max_seq_len=128)
TCFG = TG.GPTConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4, max_seq_len=128)
BASE = dict(num_slots=2, page_size=8, max_model_len=64, prefill_chunk=16, dtype="float32",
            decode_block=2)
SPEC = dict(spec_drafter="ngram", spec_k=4)


@pytest.fixture(scope="module")
def weights():
    jparams = G.init_params(CFG, jax.random.PRNGKey(0))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _workload(pkg, seed=11):
    """The JAX speculation tests' draws, every request present at the start:
    the scheduling, and with it ``spec_stats``, then depends on steps only,
    not on how fast each engine's first steps run on a loaded host."""
    wl = pkg.make_open_loop_workload(5, rate_rps=500.0, prompt_len=(3, 20), max_new=(4, 12),
                                     vocab_size=64, seed=seed)
    for r in wl:
        r.arrival_time = 0.0
    return wl


def _port_engine(np_params, draft=None, **over):
    return serving.ServingEngine(TCFG, params_from_numpy(np_params, "cpu"),
                                 serving.ServingConfig(**BASE, **over), draft=draft,
                                 device="cpu")


def _serve(eng, pkg):
    wl = _workload(pkg)
    rep = pkg.run_continuous(eng, wl)
    assert rep["finished"] == len(wl) and rep["pool_audit_ok"]
    return [r.tokens for r in wl], rep


@pytest.mark.parametrize("over", [{}, {"kv_bits": 8}], ids=["dense", "kv8"])
def test_spec_serving_matches_the_jax_engine(weights, over):
    """n-gram drafts: tokens per request and ``spec_stats`` equal the JAX
    engine's, and so do the scheduler step and preemption counts."""
    jparams, np_params = weights
    ref_toks, ref = _serve(jserving.ServingEngine(
        CFG, jparams, jserving.ServingConfig(**BASE, **SPEC, **over)), jserving)
    toks, rep = _serve(_port_engine(np_params, **SPEC, **over), serving)
    assert toks == ref_toks
    assert rep["spec"] == ref["spec"]
    assert rep["spec"]["windows"] > 0 and rep["spec"]["accepted"] > 0
    for key in ("decode_steps", "preemptions", "total_tokens"):
        assert rep[key] == ref[key], key


@pytest.mark.parametrize("over", [{}, {"kv_bits": 8}], ids=["dense", "kv8"])
def test_spec_on_serves_the_spec_off_tokens(weights, over):
    """Speculation changes no token (dense pools exactly; kv8 on this model
    too, as in the reference's test), in fewer scheduler steps."""
    _, np_params = weights
    off, off_rep = _serve(_port_engine(np_params, **over), serving)
    on, on_rep = _serve(_port_engine(np_params, **SPEC, **over), serving)
    assert on == off
    assert on_rep["decode_steps"] < off_rep["decode_steps"]
    assert "spec" not in off_rep and on_rep["spec"]["tokens_per_dispatch"] > 1.0


def test_draft_model_drafter_matches_the_jax_engine(weights):
    """draft == target, the pair bridged to the port: the served tokens equal
    the JAX engine's with the same draft pair and the spec-off tokens, with
    near-total acceptance. The draft's shapes land in the compile log."""
    jparams, np_params = weights
    spec = dict(spec_drafter="draft_model", spec_k=4)
    ref_toks, ref = _serve(jserving.ServingEngine(
        CFG, jparams, jserving.ServingConfig(**BASE, **spec), draft=(CFG, jparams)), jserving)
    eng = _port_engine(np_params, draft=(TCFG, params_from_numpy(np_params, "cpu")), **spec)
    toks, rep = _serve(eng, serving)
    off, _ = _serve(_port_engine(np_params), serving)
    assert toks == ref_toks == off
    assert rep["spec"] == ref["spec"]
    assert rep["spec"]["accept_rate"] > 0.5
    kinds = {e["kind"] for e in eng.compile_log}
    assert {"draft_feed", "draft_step"} <= kinds


def test_draft_model_preset_without_a_draft_pair(weights):
    """``spec_draft_model`` names a preset built at seed 0 when no pair is
    passed; the drafts differ from the reference's, never the tokens."""
    _, np_params = weights
    eng = _port_engine(np_params, spec_drafter="draft_model", spec_k=2,
                       spec_draft_model="tiny")
    toks, rep = _serve(eng, serving)
    off, _ = _serve(_port_engine(np_params), serving)
    assert toks == off and rep["spec"]["drafter"] == "draft_model"
    with pytest.raises(ValueError, match="needs either"):
        _port_engine(np_params, spec_drafter="draft_model").make_scheduler()


def test_spec_window_at_table_capacity(weights):
    """prompt + max_new equals the model length, so the last windows reach
    past the table: out-of-range window positions drop, never clip onto a
    committable one, and the tokens equal spec-off's."""
    _, np_params = weights

    def run(**over):
        eng = _port_engine(np_params, **over)
        req = serving.Request(prompt=(np.arange(32, dtype=np.int32) % 7 + 1),
                              max_new_tokens=BASE["max_model_len"] - 32)
        sched = eng.make_scheduler()
        assert sched.submit(req)
        sched.run_to_completion()
        assert sched.audit()["ok"]
        return req.tokens, sched.spec_stats

    off, _ = run()
    on, stats = run(**SPEC)
    assert len(on) == len(off) == 32 and on == off
    assert stats["windows"] > 0


def test_warmup_visits_exactly_the_ladders_verify_shapes(weights):
    """One verify shape per ladder entry (W = 2, 3, 5 for spec_k 4) at
    warmup, and traffic adds no shape."""
    _, np_params = weights
    eng = _port_engine(np_params, **SPEC)
    n = eng.warmup()
    assert [tuple(e["shape"]) for e in eng.compile_log
            if e["kind"] == "serving_verify"] == [(2, 2), (3, 2), (5, 2)]
    assert eng.serving.spec_k_set == (1, 2, 4)
    _serve(eng, serving)
    assert len(eng.compile_log) == n, eng.compile_log[n:]
    assert serving.ServingConfig().spec_k_set == ()


def test_spec_k_outside_its_range_raises(weights):
    _, np_params = weights
    for k in (0, 17):
        with pytest.raises(ValueError, match="spec_k"):
            _port_engine(np_params, spec_drafter="ngram", spec_k=k)
    with pytest.raises(ValueError, match="unknown spec_drafter"):
        _port_engine(np_params, spec_drafter="oracle").make_scheduler()
    # the equivalence-harness flag is accepted and changes nothing
    _port_engine(np_params, spec_equivalence_harness=True)
