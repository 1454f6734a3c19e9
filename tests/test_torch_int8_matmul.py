"""The port's group-wise quantizer and the plain versions of its
quantized-weight kernels (B6 ``int8_matmul``, B7 ``int4_matmul``) vs the JAX
package's.

Inputs are numpy from a seed and cross to both packages as numpy. On the
CPU the JAX side runs its Pallas kernel in interpret mode where the shape is
eligible for it (``_on_tpu()`` is true there) and its dequantize-then-matmul
fallback elsewhere; the port's wrapper takes its plain version (M <= 256) or
the same dequantize-then-matmul route (M > 256). Tolerances: the quantizer
bitwise (the same fp32 divide and round-half-even on both sides); products
in fp32 rtol 1e-5 / atol 1e-4 (the same dequantized weights, summed in
another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import int8_matmul as jmm
from deepspeed_tpu.ops.quantizer import dequantize as jax_dequantize
from deepspeed_tpu.ops.quantizer import quantize as jax_quantize
from deepspeed_tpu_torch.ops.cuda import int8_matmul as im
from deepspeed_tpu_torch.ops.quantizer import dequantize, quantize

RTOL, ATOL = 1e-5, 1e-4


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_dequantize_bitwise_vs_jax(bits, dtype):
    w = np.random.default_rng(bits).standard_normal((4, 64, 96)).astype(np.float32) * 0.02
    w[0, :2] = 0.0  # all-zero groups take scale 1
    groups = w.size // 32
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jq, js = jax_quantize(jw, bits=bits, num_groups=groups)
    q, s = quantize(tw, bits=bits, num_groups=groups)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and q.shape == tw.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    assert (s.numpy()[:6] == 1.0).all()
    for out_dtype in ("float32", "bfloat16"):
        ref = jax_dequantize(jq, js, dtype=getattr(jnp, out_dtype))
        out = dequantize(q, s, dtype=getattr(torch, out_dtype))
        assert out.dtype == getattr(torch, out_dtype)
        # bf16 -> fp32 widening is exact, so equal fp32 bits are equal bf16 bits
        np.testing.assert_array_equal(_bits(out.float().numpy()),
                                      _bits(np.asarray(ref.astype(jnp.float32))))


def test_quantize_refuses_a_partial_group():
    with pytest.raises(ValueError, match="not divisible"):
        quantize(torch.zeros(10, 3), num_groups=4)


def _operands(M, D, F, group, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w = rng.standard_normal((D, F)).astype(np.float32)
    q, s = jax_quantize(jnp.asarray(w), bits=bits, num_groups=D * F // group)
    q, s = np.array(q), np.array(s)
    if bits == 4:
        q = np.array(jmm.pack_int4(jnp.asarray(q)))
    return x, q, s


def _both(bits, x, q, s, group):
    jfn = jmm.int4_matmul if bits == 4 else jmm.int8_matmul
    tfn = im.int4_matmul if bits == 4 else im.int8_matmul
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), group_size=group))
    before = (im.int8_launches, im.int4_launches)
    out = tfn(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s), group_size=group)
    assert (im.int8_launches, im.int4_launches) == before  # the CPU launches no kernel
    return out, ref


# the TPU-eligible shapes of tests/test_int8_matmul.py: the JAX side runs the
# Pallas kernel (interpret mode)
@pytest.mark.parametrize("M,D,F,group", [(1, 256, 512, 128), (8, 512, 1536, 128),
                                         (5, 256, 512, 128), (2, 256, 512, 256)])
def test_int8_plain_matches_the_pallas_kernel(M, D, F, group):
    assert jmm._on_tpu() and jmm._eligible(M, D, F, group, min(256, D), min(512, F))
    x, q, s = _operands(M, D, F, group, 8, 0)
    out, ref = _both(8, x, q, s, group)
    assert out.shape == (M, F) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        im.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                           group).numpy(), ref, rtol=RTOL, atol=ATOL)


# the JAX fallback's shapes: group 64 (below the lane width), a group that
# crosses rows (F % group != 0), a prefill-sized M, and GPT-2-125M's qkv
@pytest.mark.parametrize("M,D,F,group", [(2, 128, 256, 64), (2, 320, 960, 128),
                                         (1024, 256, 512, 128), (8, 768, 2304, 128)],
                         ids=["group64", "ragged", "prefill-M", "gpt2-125m-qkv"])
def test_int8_plain_matches_the_jax_fallback(M, D, F, group):
    assert not jmm._eligible(M, D, F, group, min(256, D), min(512, F))
    x, q, s = _operands(M, D, F, group, 8, 1)
    out, ref = _both(8, x, q, s, group)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("M,D,F,group", [(1, 256, 1024, 128), (8, 512, 3072, 128),
                                         (5, 256, 1024, 256), (2, 256, 512, 128),
                                         (300, 256, 1024, 128)],
                         ids=["gemv", "b8-qkv", "ragged-M", "odd-n_f", "prefill-M"])
def test_int4_plain_matches_jax(M, D, F, group):
    """The first three run the Pallas kernel on the JAX side; F=512 at
    block_f 512 (one f-block, no halves) and M=300 take its fallback."""
    x, q, s = _operands(M, D, F, group, 4, 2)
    assert q.shape == (D, F // 2)
    out, ref = _both(4, x, q, s, group)
    assert out.shape == (M, F)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_activations_give_bf16_out(bits):
    x, q, s = _operands(8, 256, 512, 128, bits, 3)
    fn = im.int4_matmul if bits == 4 else im.int8_matmul
    out = fn(torch.from_numpy(x).bfloat16(), torch.from_numpy(q), torch.from_numpy(s), 128)
    assert out.dtype == torch.bfloat16 and out.shape == (8, 512)
    ref = (im.int4_matmul_ref if bits == 4 else im.int8_matmul_ref)(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(q), torch.from_numpy(s), 128)
    assert torch.equal(out, ref)


def test_wrapper_checks_shapes_scales_and_autograd():
    x = torch.zeros(2, 64)
    q = torch.zeros(64, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="do not cover"):
        im.int8_matmul(x, q, torch.ones(10), 64)
    with pytest.raises(ValueError, match="do not make"):
        im.int8_matmul(torch.zeros(2, 63), q, torch.ones(32), 64)
    with pytest.raises(TypeError, match="int8"):
        im.int8_matmul(x, q.float(), torch.ones(32), 64)
    with pytest.raises(RuntimeError, match="inference-only"):
        im.int4_matmul(x.requires_grad_(True), q, torch.ones(64), 64)


def test_split_plan_covers_d_and_fills_the_card():
    """The D chunks cover D with no empty chunk, a cluster is at most 8
    blocks, every warp of a block keeps a row, and a narrow matrix takes
    narrower column tiles."""
    for M, D, Fq in ((4, 768, 2304), (8, 3072, 768), (1, 32, 16), (256, 1024, 4096),
                     (8, 4096, 1024), (2, 100, 15)):
        lanes, chunk, cluster = im.split_plan(M, D, Fq, 132)
        assert lanes in (32, 16, 8) and cluster in (1, 2, 4, 8)
        assert chunk * cluster >= D > chunk * (cluster - 1) and chunk >= min(D, 8)
    assert im.split_plan(4, 768, 2304, 132) == (32, 96, 8)  # 18 tiles of 128 bytes x 8
    assert im.split_plan(4, 768, 768, 132) == (16, 96, 8)  # 12 tiles of 64 bytes x 8
    assert im.split_plan(8, 3072, 384, 132) == (8, 384, 8)  # 12 tiles of 32 bytes x 8
    assert im.split_plan(256, 768, 2304, 132) == (32, 768, 1)  # 18 x 32 tiles fill the card
