"""The port's inference engine vs the JAX package's, with the same weights.

``init_inference(for_gpt(...), dtype="float32", device="cpu").generate`` must be
token-identical to the JAX ``InferenceEngine.generate`` on ``tiny``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu_torch
from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import for_gpt as jax_for_gpt
from deepspeed_tpu.models import gpt as jax_gpt
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import DeepSpeedInferenceConfig, InferenceEngine, for_gpt
from deepspeed_tpu_torch.inference.serving.buckets import bucket_for, default_buckets
from deepspeed_tpu_torch.models import gpt


# tiny's depth at head dim 96 (gpt2-760m's), whose decode steps take B3
D96 = dict(n_head=2, d_model=192)


@pytest.fixture(scope="module")
def engines():
    weights = {}

    def make(head_dim=16, **cfg):
        over = D96 if head_dim == 96 else {}
        jcfg = dataclasses.replace(jax_gpt.PRESETS["tiny"], **over)
        tcfg = dataclasses.replace(gpt.PRESETS["tiny"], **over)
        if head_dim not in weights:
            jparams = jax_gpt.init_params(jcfg, jax.random.PRNGKey(0))
            weights[head_dim] = (jparams, params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
        jparams, params = weights[head_dim]
        ref = JaxEngine(jax_for_gpt(jcfg, jparams), JaxConfig(dtype="float32", **cfg))
        port = deepspeed_tpu_torch.init_inference(
            for_gpt(tcfg, params), dtype="float32", device="cpu", **cfg)
        return ref, port

    return make


PROMPT = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)


@pytest.mark.parametrize("kwargs,cfg", [
    ({}, {}),
    ({"repetition_penalty": 1.5}, {}),
    ({}, {"decode_buckets": [4, 32]}),
    ({}, {"head_dim": 96}),
], ids=["greedy", "repetition-penalty", "decode-buckets", "greedy-d96"])
def test_generate_token_identical_to_jax(engines, kwargs, cfg):
    ref_engine, engine = engines(**cfg)
    ref = ref_engine.generate(PROMPT, max_new_tokens=16, **kwargs)
    out = engine.generate(PROMPT, max_new_tokens=16, **kwargs)
    assert out.shape == (2, 32) and out.dtype == np.int32
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_generate_eos_freezes_rows_like_jax(engines):
    """An eos token that row 0 emits mid-way freezes that row (it repeats the
    eos), exactly as the JAX engine does."""
    ref_engine, engine = engines()
    plain = engine.generate(PROMPT, max_new_tokens=16)
    eos = int(plain[0, 16 + 3])
    ref = ref_engine.generate(PROMPT, max_new_tokens=16, eos_token_id=eos)
    out = engine.generate(PROMPT, max_new_tokens=16, eos_token_id=eos)
    np.testing.assert_array_equal(out, np.asarray(ref))
    first = 16 + int(np.argmax(out[0, 16:] == eos))
    assert (out[0, first:] == eos).all()


def test_forward_matches_jax(engines):
    ref_engine, engine = engines()
    np.testing.assert_allclose(engine.forward(PROMPT).numpy(),
                               np.asarray(ref_engine.forward(PROMPT)), atol=1e-4, rtol=0)


def test_generate_enforces_batch_and_token_bounds():
    cfg = gpt.GPTConfig(vocab_size=32, d_model=16, n_layer=1, n_head=2, max_seq_len=64)
    eng = InferenceEngine(for_gpt(cfg, gpt.init_params(cfg, 0, device="cpu")),
                          DeepSpeedInferenceConfig(dtype="float32", max_out_tokens=32,
                                                   min_out_tokens=4, max_batch_size=2),
                          device="cpu")
    with pytest.raises(ValueError, match="max_batch_size"):
        eng.generate(np.zeros((3, 4), np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="min_out_tokens"):
        eng.generate(np.zeros((1, 4), np.int32), max_new_tokens=2)
    assert eng.generate(np.zeros((2, 4), np.int32), max_new_tokens=4).shape == (2, 8)
    assert eng.generate(np.zeros((1, 4), np.int32)).shape == (1, 36)  # max_out_tokens


def test_unported_options_raise():
    cfg = gpt.PRESETS["tiny"]
    model = for_gpt(cfg, gpt.init_params(cfg, 0, device="cpu"))
    for config, item in (({"tp": {"tp_size": 2}}, "A10"), ({"moe": {"ep_size": 2}}, "A13"),
                         ({"dtype": "int8"}, "A13"), ({"checkpoint": "ckpt_dir"}, "A13")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            deepspeed_tpu_torch.init_inference(model, config, device="cpu")
    # weight-only quantization is ported: it builds int8 layer stacks
    eng = deepspeed_tpu_torch.init_inference(model, {"quant": {"enabled": True}}, device="cpu")
    assert eng.params["blocks"]["qkv_w"]["q"].dtype == torch.int8


def test_config_keys_aliases_and_buckets():
    c = DeepSpeedInferenceConfig.from_dict(
        {"dtype": "fp16", "tp": {"tp_size": 1, "unknown": 3}, "max_tokens": 77,
         "replace_with_kernel_inject": True, "not_a_key": 1})
    assert c.torch_dtype() == torch.float16 and c.max_out_tokens == 77
    assert c.tensor_parallel.tp_size == 1
    assert DeepSpeedInferenceConfig().torch_dtype() == torch.bfloat16
    assert default_buckets(32, 100) == (32, 64, 128)
    assert bucket_for(33, (32, 64)) == 64
    with pytest.raises(ValueError, match="largest bucket"):
        bucket_for(65, (32, 64))
