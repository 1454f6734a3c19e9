"""``generate``'s decoding modes in the port vs the JAX package's: the logit
filter of a sampled step, the degenerate samplers, the eos freeze, the
distribution of the port's draw, and beam search.

The weights come from the JAX ``init_params`` at ``tiny`` and cross through
``deepspeed_tpu_torch.bridge``; both engines run in fp32 on the CPU. The
port's random stream is a ``torch.Generator`` and cannot be JAX's
``PRNGKey``, so a sampled run is held to the reference by its distribution
and by the settings that leave one token (top-k 1, top-p 1e-6), never token
for token. Tolerances: filtered logits 1e-6 absolute and the same -inf
positions; tokens exactly; the draw's chi-square below the 0.999 quantile of
its degrees of freedom at a fixed seed (so the test is deterministic).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import for_gpt as jax_for_gpt
from deepspeed_tpu.models import gpt as jax_gpt
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import filter_logits, for_gpt
from deepspeed_tpu_torch.inference.engine import categorical
from deepspeed_tpu_torch.models import gpt

PROMPT = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)
NEW = 8


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_gpt.PRESETS["tiny"]
    jparams = jax_gpt.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    ref = JaxEngine(jax_for_gpt(jcfg, jparams), JaxConfig(dtype="float32"))
    port = deepspeed_tpu_torch.init_inference(for_gpt(gpt.PRESETS["tiny"], params),
                                              dtype="float32", device="cpu")
    return ref, port


def reference_filter(logits, temperature, top_k, top_p):
    """The filter lines of the reference's ``sample``
    (``deepspeed_tpu/inference/engine.py:317-330``), transcribed: the
    closure that holds them cannot be imported."""
    logits = logits / temperature
    if top_k > 0:
        kth = jnp.sort(logits, axis=-1)[..., -top_k][..., None]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if 0.0 < top_p < 1.0:
        desc = jnp.sort(logits, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(desc, axis=-1)
        exclusive_cum = jnp.cumsum(probs, axis=-1) - probs
        kept = jnp.where(exclusive_cum >= top_p, jnp.inf, desc)
        thr = jnp.min(kept, axis=-1, keepdims=True)
        logits = jnp.where(logits < thr, -jnp.inf, logits)
    return logits


def _tied_logits(seed=0):
    """[6, 64] fp32 logits whose rows hold ties: at the 5th largest value, at
    the top, and a row of one value repeated."""
    x = np.random.default_rng(seed).standard_normal((6, 64)).astype(np.float32) * 2
    order = np.argsort(-x, axis=1)
    x[0, order[0, 5]] = x[0, order[0, 4]]  # a tie at the 5th largest
    x[1, order[1, 1]] = x[1, order[1, 0]]  # a tie at the top
    x[2, order[2, :8]] = x[2, order[2, 3]]  # eight tied at the top
    x[3] = 0.5  # every logit the same
    return x


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 5, 0.0), (0.7, 1, 0.0), (1.0, 0, 0.9), (1.3, 0, 0.3), (0.8, 5, 0.5),
    (1.0, 64, 0.0), (1.0, 0, 1e-6), (1.0, 0, 1.0),
], ids=["k5", "k1-t0.7", "p0.9", "p0.3-t1.3", "k5-p0.5", "k-all", "p-tiny", "p1-off"])
def test_filter_logits_matches_the_references_sample(temperature, top_k, top_p):
    x = _tied_logits()
    ref = np.asarray(reference_filter(jnp.asarray(x), temperature, top_k, top_p))
    out = filter_logits(torch.from_numpy(x), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    np.testing.assert_allclose(out[np.isfinite(out)], ref[np.isfinite(ref)], atol=1e-6, rtol=0)
    if top_k == 5 and not top_p:  # the tie at the 5th largest is kept: 6 survive in row 0
        assert np.isfinite(out[0]).sum() == 6
    assert np.isfinite(out).any(axis=1).all()  # the top token always survives


def test_one_token_samplers_are_greedy_and_equal_jax(engines):
    """top_k=1 and top_p=1e-6 (temperature 1) leave one token a step: the
    same tokens as JAX's generate with the same settings and as greedy
    decoding, whatever the seed; with eos (a token the greedy run emits) the
    row freezes on it in both. temperature=0 ignores top_k, as the
    reference's ``sample`` does."""
    ref, port = engines
    greedy = port.generate(PROMPT, max_new_tokens=NEW)
    eos = int(greedy[0, 16 + 3])
    for kw in ({"top_k": 1, "seed": 3}, {"top_p": 1e-6, "seed": 4},
               {"top_k": 1, "eos_token_id": eos}):
        out = port.generate(PROMPT, max_new_tokens=NEW, temperature=1.0, **kw)
        np.testing.assert_array_equal(out, ref.generate(PROMPT, max_new_tokens=NEW,
                                                        temperature=1.0, **kw))
        if "eos_token_id" not in kw:
            np.testing.assert_array_equal(out, greedy)
        else:
            first = 16 + int(np.argmax(greedy[0, 16:] == eos))
            np.testing.assert_array_equal(out[0, :first + 1], greedy[0, :first + 1])
            assert (out[0, first:] == eos).all()
    np.testing.assert_array_equal(port.generate(PROMPT, max_new_tokens=NEW, top_k=5), greedy)


def test_sampling_is_seeded_and_freezes_at_eos(engines):
    """The same seed gives the same tokens; another seed other ones. With
    eos set to a token the sampled run emits, the row repeats it from there
    and the draws before it are unchanged (one draw a step)."""
    _, port = engines
    kw = dict(max_new_tokens=NEW, temperature=1.0, top_k=50)
    a = port.generate(PROMPT, seed=11, **kw)
    np.testing.assert_array_equal(a, port.generate(PROMPT, seed=11, **kw))
    assert not np.array_equal(a, port.generate(PROMPT, seed=12, **kw))
    eos = int(a[1, 16 + 2])
    first = 16 + int(np.argmax(a[1, 16:] == eos))
    b = port.generate(PROMPT, seed=11, eos_token_id=eos, **kw)
    np.testing.assert_array_equal(b[1, :first + 1], a[1, :first + 1])
    assert (b[1, first:] == eos).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 0.0), (0.8, 6, 0.0),
                                                     (1.2, 0, 0.8)],
                         ids=["t1", "t0.8-k6", "t1.2-p0.8"])
def test_draw_follows_softmax_of_the_filtered_logits(temperature, top_k, top_p):
    """200000 draws from one row of 10 logits (ties included): a filtered
    token never comes up, and the counts of the others fit softmax(filtered)
    by Pearson's chi-square below its 0.999 quantile."""
    x = torch.tensor([[2.0, 1.5, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -1.0, -2.0]])
    filtered = filter_logits(x, temperature, top_k, top_p)[0]
    gen = torch.Generator().manual_seed(1234)
    n = 200_000
    toks = categorical(filtered.expand(n, -1), gen)
    counts = torch.bincount(toks, minlength=10).numpy()
    keep = torch.isfinite(filtered).numpy()
    assert counts[~keep].sum() == 0
    p = torch.softmax(filtered.double(), dim=-1).numpy()[keep]
    chi2 = float(((counts[keep] - n * p) ** 2 / (n * p)).sum())
    # 0.999 quantiles of chi-square at 1-9 degrees of freedom
    q999 = [10.83, 13.82, 16.27, 18.47, 20.52, 22.46, 24.32, 26.12, 27.88]
    assert chi2 < q999[keep.sum() - 2], (chi2, counts)


@pytest.mark.parametrize("K,with_eos", [(2, False), (2, True), (4, False), (4, True)],
                         ids=["k2", "k2-eos", "k4", "k4-eos"])
def test_beam_search_token_identical_to_jax(engines, K, with_eos):
    """B2, K beams: the port's beams (one [B*K]-row cache reordered every
    step) give JAX's tokens; with eos, a token the beams emit, the finished
    beams ride the eos lane in both."""
    ref, port = engines
    kw = {"num_beams": K}
    if with_eos:
        kw["eos_token_id"] = int(port.generate(PROMPT, max_new_tokens=NEW, num_beams=K)[0, 18])
    out = port.generate(PROMPT, max_new_tokens=NEW, **kw)
    np.testing.assert_array_equal(out, ref.generate(PROMPT, max_new_tokens=NEW, **kw))
    assert out.shape == (2, 16 + NEW) and out.dtype == np.int32


def test_beam_search_rejects_sampling_knobs_like_jax(engines):
    ref, port = engines
    for kw in ({"temperature": 0.7}, {"top_k": 5}, {"top_p": 0.9},
               {"repetition_penalty": 1.2}):
        for eng in (ref, port):
            with pytest.raises(ValueError, match="beam search is deterministic"):
                eng.generate(PROMPT, max_new_tokens=4, num_beams=2, **kw)


def test_beam_one_step_and_bucketed_lengths(engines):
    """max_new_tokens 1 is the row's best first token; decode buckets pad the
    run and slice it back, as greedy decoding does."""
    _, port = engines
    one = port.generate(PROMPT, max_new_tokens=1, num_beams=3)
    greedy = port.generate(PROMPT, max_new_tokens=1)
    np.testing.assert_array_equal(one, greedy)
    cfg = dataclasses.replace(port.config, decode_buckets=[4, 8])
    bucketed = type(port)(port.model, cfg, device="cpu")
    np.testing.assert_array_equal(bucketed.generate(PROMPT, max_new_tokens=3, num_beams=2),
                                  port.generate(PROMPT, max_new_tokens=4, num_beams=2)[:, :19])
