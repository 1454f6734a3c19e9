"""The port's quantized-weight inference vs the JAX package's: the
quantized trees (``quantize_for_inference``, ``init_quantized_decode_params``),
the weight bridge, ``init_inference(..., quant=...)`` (prefill logits,
greedy ``generate``, a tree that arrives quantized), the paged decode step,
and ``ServingEngine`` over int8 weights.

Weights cross through ``deepspeed_tpu_torch.bridge``; inputs are numpy from
a seed. The engine runs use ``tests/test_int8_inference.py``'s model (vocab
64, 4 layers, d 32, group 32), the serving run ``tests/test_torch_serving.py``'s
configuration. Tolerances: quantized leaves bitwise (the same fp32 divide
and round-half-even on both sides); fp32 logits atol 1e-4 (prefill) and
1e-5 (one paged step), the same dequantized weights summed in another
order; greedy tokens identical.
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
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as G
from deepspeed_tpu_torch.bridge import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.inference import for_gpt, serving
from deepspeed_tpu_torch.models import gpt as TG
from deepspeed_tpu_torch.utils.tree import tree_leaves

CFG = G.GPTConfig(vocab_size=64, n_layer=4, n_head=2, d_model=32, max_seq_len=64)
TCFG = TG.GPTConfig(vocab_size=64, n_layer=4, n_head=2, d_model=32, max_seq_len=64)
GROUP = 32
PROMPT = np.random.default_rng(0).integers(0, 64, (2, 8)).astype(np.int32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a.astype(jnp.float32))
                                  if a.dtype == jnp.bfloat16 else np.array(a), tree)


def _assert_trees_bitwise(jtree, ttree):
    """Same leaves in the same (sorted-key) order, dtype, shape and bytes;
    bf16 leaves compared through their exact fp32 widening."""
    ref = jax.tree_util.tree_leaves(_np(jtree))
    out = [t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
           for t in tree_leaves(ttree)]
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def weights():
    jparams = G.init_params(CFG, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(_np(jparams), "cpu")


# ------------------------------------------------------------ quantized trees
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", ["tiny", "gpt2-125m-width"])
def test_quantize_for_inference_bitwise_vs_jax(model, bits, dtype):
    cfg = (G.PRESETS["tiny"] if model == "tiny" else
           G.GPTConfig(vocab_size=512, n_layer=2, n_head=12, d_model=768, max_seq_len=64))
    tcfg = TG.GPTConfig(**dataclasses.asdict(cfg))
    jparams = G.init_params(cfg, jax.random.PRNGKey(1))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(dtype), jparams)
    params = params_from_numpy(_np(jparams), "cpu", getattr(torch, dtype))
    ref = G.quantize_for_inference(cfg, jparams, bits=bits, group_size=128)
    out = TG.quantize_for_inference(tcfg, params, bits=bits, group_size=128)
    qkey = "q4" if bits == 4 else "q"
    for k in ("qkv_w", "attn_out_w", "mlp_up_w", "mlp_down_w"):
        leaf = out["blocks"][k]
        assert set(leaf) == {qkey, "s"} and leaf[qkey].dtype == torch.int8
        assert leaf["s"].dtype == torch.float32 and leaf["s"].shape[0] == cfg.n_layer
    _assert_trees_bitwise(ref, out)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bits", [4, 8])
def test_init_quantized_decode_params_bitwise_vs_jax(bits, dtype):
    ref = G.init_quantized_decode_params(CFG, seed=3, bits=bits, group_size=GROUP,
                                         compute_dtype=getattr(jnp, dtype))
    out = TG.init_quantized_decode_params(TCFG, seed=3, bits=bits, group_size=GROUP,
                                          compute_dtype=getattr(torch, dtype), device="cpu")
    assert out["wte"].dtype == getattr(torch, dtype)
    assert out["blocks"]["qkv_w"]["s"].dtype == torch.float32
    _assert_trees_bitwise(ref, out)


def test_the_stream_units_are_the_references():
    ref, out = G.GPTStream(CFG), TG.GPTStream(TCFG)
    assert out.unit_names() == ref.unit_names()
    for name in ("embed", "layer_2", "final"):
        a, b = ref.init_unit(name, 7), out.init_unit(name, 7)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


# ------------------------------------------------------------ the weight bridge
@pytest.mark.parametrize("bits", [8, 4])
def test_bridge_carries_a_quantized_tree_bitwise(weights, bits):
    """int8 payloads stay int8 and the scales stay fp32 even when a dtype is
    asked for; params_to_numpy gives the JAX tree back."""
    jparams, _ = weights
    tree = _np(G.quantize_for_inference(CFG, jparams, bits=bits, group_size=GROUP))
    params = params_from_numpy(tree, "cpu", torch.bfloat16)
    leaf = params["blocks"]["qkv_w"]
    assert leaf["q4" if bits == 4 else "q"].dtype == torch.int8
    assert leaf["s"].dtype == torch.float32
    assert params["wte"].dtype == torch.bfloat16
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_engines_keep_scales_fp32_under_bf16(weights):
    jparams, _ = weights
    tree = _np(G.quantize_for_inference(CFG, jparams, bits=8, group_size=GROUP))
    q_ref = tree["blocks"]["mlp_up_w"]["q"]
    eng = deepspeed_tpu_torch.init_inference(for_gpt(TCFG, tree), dtype="bfloat16",
                                             device="cpu")
    srv = serving.ServingEngine(TCFG, tree, serving.ServingConfig(max_model_len=64, page_size=8),
                                device="cpu")
    for params in (eng.params, srv.params):
        leaf = params["blocks"]["mlp_up_w"]
        assert leaf["s"].dtype == torch.float32 and leaf["q"].dtype == torch.int8
        np.testing.assert_array_equal(leaf["q"].numpy(), q_ref)
        assert params["blocks"]["mlp_up_b"].dtype == torch.bfloat16
    assert TG.has_quantized_leaves(eng.params)


# ------------------------------------------------------------ the engine
def _engines(jparams, params, bits):
    quant = {"enabled": True, "bits": bits, "group_size": GROUP}
    ref = JaxEngine(jax_for_gpt(CFG, jparams), JaxConfig(dtype="float32", max_out_tokens=32,
                                                         quant=quant))
    out = deepspeed_tpu_torch.init_inference(for_gpt(TCFG, params), dtype="float32",
                                             device="cpu", quant=quant)
    return ref, out


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_engine_matches_jax(weights, bits):
    """The quantized tree the engine builds, its prefill logits (atol 1e-4)
    and its greedy tokens equal the JAX engine's."""
    jparams, params = weights
    ref, eng = _engines(jparams, params, bits)
    assert ref._per_layer_quant and TG.has_quantized_leaves(eng.params)
    _assert_trees_bitwise(ref.params, eng.params)
    np.testing.assert_allclose(eng.forward(PROMPT).numpy(), np.asarray(ref.forward(PROMPT)),
                               atol=1e-4, rtol=0)
    out = eng.generate(PROMPT, max_new_tokens=16)
    np.testing.assert_array_equal(out, np.asarray(ref.generate(PROMPT, max_new_tokens=16)))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_logits_equal_the_dequantized_dense_tree(weights, bits):
    """``dequantize_params`` is the dense tree the quantized one stands for:
    the cached forward over either gives the same logits."""
    _, params = weights
    qparams = TG.quantize_for_inference(TCFG, params, bits=bits, group_size=GROUP)
    dense = TG.dequantize_params(qparams)
    assert dense["blocks"]["qkv_w"].shape == params["blocks"]["qkv_w"].shape
    logits = []
    for tree in (qparams, dense):
        cache = TG.init_cache(TCFG, 2, 16, torch.float32, "cpu")
        logits.append(TG.forward_with_cache(TCFG, tree, torch.from_numpy(PROMPT), cache)[0])
    torch.testing.assert_close(logits[0], logits[1], atol=1e-5, rtol=0)


def test_a_pre_quantized_tree_is_used_as_it_is():
    """A tree that arrives quantized (the host-streamed init) is detected and
    not quantized again, even with quant.enabled; generate equals JAX's."""
    jtree = G.init_quantized_decode_params(CFG, seed=1, bits=4, group_size=GROUP,
                                           compute_dtype=jnp.float32)
    tree = TG.init_quantized_decode_params(TCFG, seed=1, bits=4, group_size=GROUP,
                                           compute_dtype=torch.float32, device="cpu")
    eng = deepspeed_tpu_torch.init_inference(for_gpt(TCFG, tree), dtype="float32", device="cpu",
                                             quant={"enabled": True, "bits": 8})
    assert TG.has_quantized_leaves(eng.params)
    for k, leaf in tree["blocks"].items():
        if isinstance(leaf, dict):
            assert set(eng.params["blocks"][k]) == {"q4", "s"}
            assert all(torch.equal(eng.params["blocks"][k][kk], v) for kk, v in leaf.items())
    ref = JaxEngine(jax_for_gpt(CFG, jtree), JaxConfig(dtype="float32", max_out_tokens=32))
    np.testing.assert_array_equal(eng.generate(PROMPT, max_new_tokens=8),
                                  np.asarray(ref.generate(PROMPT, max_new_tokens=8)))


def test_scoring_forward_and_adapters_without_quantize_params_refuse(weights):
    _, params = weights
    qparams = TG.quantize_for_inference(TCFG, params, bits=8, group_size=GROUP)
    with pytest.raises(TypeError, match="dense weights"):
        TG.forward(TCFG, qparams, torch.from_numpy(PROMPT), train=False)

    class Adapter:  # an inference adapter with no quantize_params
        def __init__(self):
            self.params = params

    with pytest.raises(NotImplementedError, match="ROADMAP.md A13"):
        deepspeed_tpu_torch.init_inference(Adapter(), dtype="float32", device="cpu",
                                           quant={"enabled": True})


# ------------------------------------------------------------ paged decode
def test_paged_decode_step_over_int8_weights_matches_jax(weights):
    """The port of ``tests/test_paged_kv.py``'s quantized-stack test: two
    prompts prefilled into a dense-pool cache, one paged decode step over
    the int8 weight stacks; logits equal JAX's (atol 1e-5)."""
    jparams, _ = weights
    jq = G.quantize_for_inference(CFG, jparams, bits=8, group_size=GROUP)
    qparams = params_from_numpy(_np(jq), "cpu")
    rng = np.random.default_rng(2)
    B, ps, P = 2, 8, 16
    prompts = [rng.integers(0, 64, (6,)).astype(np.int32) for _ in range(B)]
    paged = G.init_paged_cache(CFG, P, ps, jnp.float32)
    tables = np.array([[15, 0, 0, 0], [14, 0, 0, 0]], np.int32)
    for b in range(B):
        ids = np.zeros((1, 8), np.int32)
        ids[0, :6] = prompts[b]
        dense = G.init_cache(CFG, 1, 8, jnp.float32)
        _, dense = G.forward_with_cache(CFG, jq, jnp.asarray(ids), dense)
        paged = G.write_prompt_kv(paged, dense, jnp.asarray(tables[b]), jnp.int32(6))
    tpaged = {k: torch.from_numpy(np.array(v)) for k, v in paged.items()}
    lengths = np.full(B, 6, np.int32)
    tok = rng.integers(0, 64, (B,)).astype(np.int32)
    ref, _ = G.paged_decode_step(CFG, jq, jnp.asarray(tok), paged, jnp.asarray(tables),
                                 jnp.asarray(lengths), impl="gather")
    out, _ = TG.paged_decode_step(TCFG, qparams, torch.from_numpy(tok), tpaged,
                                  torch.from_numpy(tables), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


SCFG = G.GPTConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4, max_seq_len=128)
STCFG = TG.GPTConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4, max_seq_len=128)
BASE = dict(num_slots=3, page_size=8, max_model_len=64, prefill_chunk=16, dtype="float32",
            decode_block=4)


def _workload(pkg):
    """Every request present at the start, so the step counts depend on
    steps only, not on the wall clock (see test_torch_serving.py)."""
    wl = pkg.make_open_loop_workload(6, rate_rps=1e4, prompt_len=(3, 30), max_new=(2, 8),
                                     vocab_size=64, seed=3)
    wl.append(pkg.Request(prompt=np.arange(20, dtype=np.int32) + 1, max_new_tokens=4))
    for r in wl:
        r.arrival_time = 0.0
    return wl


def test_served_tokens_over_int8_weights_match_the_jax_engine():
    """Every request's tokens equal the JAX ServingEngine's over the same
    int8 weights (dense fp32 pools), and so do the step counts."""
    jq = G.quantize_for_inference(SCFG, G.init_params(SCFG, jax.random.PRNGKey(0)),
                                  bits=8, group_size=GROUP)
    ref_wl, wl = _workload(jserving), _workload(serving)
    ref = jserving.run_continuous(
        jserving.ServingEngine(SCFG, jq, jserving.ServingConfig(**BASE)), ref_wl)
    eng = serving.ServingEngine(STCFG, params_from_numpy(_np(jq), "cpu"),
                                serving.ServingConfig(**BASE), device="cpu")
    rep = serving.run_continuous(eng, wl)
    assert rep["finished"] == len(wl) and rep["pool_audit_ok"]
    assert [r.tokens for r in wl] == [r.tokens for r in ref_wl]
    for key in ("preemptions", "decode_steps", "total_tokens"):
        assert rep[key] == ref[key], key
