"""The arithmetic of B6 / B7's decode kernel (``csrc/int8_matmul_decode.cu``:
1-8 rows of x in any float dtype on mma.sync) and of B8's tensor-core kernel
at scale blocks off 64-column panels, on the CPU, against the JAX package.

- ``qmatmul_fp32_split_ref`` is the decode kernel's arithmetic in every
  dtype: x widened to fp32, times each group's scales, rounded once and cut
  into three bf16 parts against the exact integers, fp32 sums in chunks of
  D as ``decode_plan`` cuts it, one rounding to x's dtype. Held against the
  JAX package's ``int8_matmul`` / ``int4_matmul`` at 1-8 rows: its Pallas
  kernel in interpret mode at a TPU-eligible shape (group 128), its XLA
  fallback at group 64. fp32 x within 1e-5 of the largest output of JAX's
  and of the float64 product (both fp32-accurate products); bf16 x within 1
  ulp of the Pallas kernel's output (both the fp32 function rounded once)
  and within 2e-2 of the largest output of the fallback's (which rounds the
  weight to bf16 first).
- ``decode_plan``: the grid covers D and stays within the kernel's limits.
- ``dequant_matmul_split_ref`` at blocks of 8, 96 and 250 (the tensor-core
  kernel pads each to whole 64-column panels with zero weights) against the
  JAX package's ``dequant_matmul`` (its fallback), within 1e-5.

Inputs are numpy from a seed (GPT-2's weight scale, 0.02). The kernels
themselves run on the card only (``tests/test_torch_kernels.py``,
``chip_smoke.py`` phase 2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.comm import quantized as jq
from deepspeed_tpu.ops.pallas import int8_matmul as jmm
from deepspeed_tpu.ops.pallas.dequant_matmul import dequant_matmul as jdequant_matmul
from deepspeed_tpu.ops.quantizer import quantize as jax_quantize
from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm
from deepspeed_tpu_torch.ops.cuda import int8_matmul as im

from _torch_ulps import ulp_err

RTOL = 1e-5  # fp32: relative to the largest output, both sides fp32 products
BF16_RTOL = 2e-2  # bf16 x against a fallback that rounds the weight to bf16
SMS = 132  # the H100's SMs: the plan the card runs


def _operands(M, D, F, group, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w = rng.standard_normal((D, F)).astype(np.float32) * 0.02
    q, s = jax_quantize(jnp.asarray(w), bits=bits, num_groups=D * F // group)
    q = np.array(q)
    exact = x.astype(np.float64) @ (q.astype(np.float64).reshape(-1, group)
                                    * np.array(s, np.float64).reshape(-1, 1)).reshape(D, F)
    return x, (jmm.pack_int4(jnp.asarray(q)) if bits == 4 else jnp.asarray(q)), s, exact


def _within(got, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


def _model(x, q, s, group, bits, dtype):
    """The decode kernel's arithmetic on x cast to ``dtype``, chunked along D
    as the card's plan cuts it."""
    M, D = x.shape
    F = q.shape[1] * (2 if bits == 4 else 1)
    assert im.qmm_route(M, dtype, D, F, group, bits) == "decode"
    warps, per_warp, cluster = im.decode_plan(D, q.shape[1], SMS, bits)
    got = im.qmatmul_fp32_split_ref(torch.from_numpy(x).to(dtype), torch.from_numpy(np.array(q)),
                                    torch.from_numpy(np.array(s)), group, bits,
                                    chunk=32 * warps * per_warp)
    assert got.dtype == dtype and got.shape == (M, F)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_decode_model_matches_the_pallas_kernel_in_interpret_mode(M, bits, dtype):
    """(D, F, group) = (768, 3072, 128), GPT-2-125M's mlp_up at a decode
    step's rows: the JAX package runs its Pallas kernel (interpret mode on
    the CPU), the fp32 function rounded once to x's dtype."""
    D, F, group = 768, 3072, 128
    x, q, s, exact = _operands(M, D, F, group, bits, 3 * M + bits)
    eligible = jmm._eligible4 if bits == 4 else jmm._eligible
    assert jmm._on_tpu() and eligible(M, D, F, group, 256, 512)
    jfn = jmm.int4_matmul if bits == 4 else jmm.int8_matmul
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jfn(jnp.asarray(x, jdt), q, s, group_size=group)
    got = _model(x, q, s, group, bits, dtype)
    if dtype == torch.float32:
        _within(got.numpy(), np.asarray(ref))
        _within(got.numpy(), exact)
    else:
        ref_t = torch.from_numpy(np.array(ref.astype(jnp.float32)))
        assert ulp_err(got, ref_t, dtype) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("M,D,F,group", [(2, 768, 2304, 64), (8, 1024, 4096, 64),
                                         (5, 3072, 768, 64)],
                         ids=["qkv-M2", "350m-mlp_up-M8", "mlp_down-M5"])
def test_decode_model_matches_the_xla_fallback(M, D, F, group, bits, dtype):
    """Group 64, which the Pallas kernel does not take: the JAX package's XLA
    dequantize-then-matmul in x's dtype."""
    x, q, s, exact = _operands(M, D, F, group, bits, M + D + F + bits)
    eligible = jmm._eligible4 if bits == 4 else jmm._eligible
    assert not eligible(M, D, F, group, min(256, D), min(512, F))
    jfn = jmm.int4_matmul if bits == 4 else jmm.int8_matmul
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jfn(jnp.asarray(x, jdt), q, s, group_size=group).astype(jnp.float32))
    got = _model(x, q, s, group, bits, dtype).float().numpy()
    if dtype == torch.float32:
        _within(got, ref)
        _within(got, exact)
    else:
        _within(got, ref, BF16_RTOL)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("D,F", [(768, 2304), (768, 768), (768, 3072), (3072, 768), (1024, 3072),
                                 (1024, 1024), (1024, 4096), (4096, 1024), (6144, 6144)])
def test_decode_plan_covers_d_within_the_kernels_limits(D, F, bits):
    """At most 8 warps a block and 8 blocks a cluster; the warps' slabs of
    32 rows cover D with no block along D empty; the grid stays within two
    blocks an SM at the projection shapes of GPT-2-125M and gpt2-350m."""
    Fq = F // 2 if bits == 4 else F
    warps, per_warp, cluster = im.decode_plan(D, Fq, SMS, bits)
    assert 1 <= warps <= 8 and 1 <= cluster <= 8 and per_warp >= 1
    rows = 32 * warps * per_warp  # rows of D a block covers
    assert rows * cluster >= D > rows * (cluster - 1)
    if D <= 4096:
        assert Fq // 64 * cluster <= 2 * SMS and per_warp <= 2


def test_decode_plan_at_gpt2_350m():
    """The plans of gpt2-350m's mlp_up and mlp_down: int8, 128 blocks of 8
    warps, each warp two slabs (32 KB of weight a block); int4 mlp_up two
    slabs a warp in clusters of 4, whose 128 blocks of one slab a warp in
    clusters of 4 would not all fit the card at once."""
    assert im.decode_plan(1024, 4096, SMS) == (8, 2, 2)
    assert im.decode_plan(4096, 1024, SMS) == (8, 2, 8)
    assert im.decode_plan(1024, 2048, SMS, 4) == (4, 2, 4)
    assert im.decode_plan(1024, 1536, SMS, 4) == (8, 1, 4)


@pytest.mark.parametrize("block", [8, 96, 250])
@pytest.mark.parametrize("M", [1, 32])
def test_dequant_split_model_at_blocks_off_whole_panels(M, block):
    """B8's tensor-core arithmetic at scale blocks the kernel pads to whole
    64-column panels (8 to 64, 96 to 128, 250 to 256) against the JAX
    package's fallback, D 768 and a width padded to whole blocks."""
    D, F = 768, 1000
    rng = np.random.default_rng(M + block)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w = rng.standard_normal((D, F)).astype(np.float32) * 0.02
    q, s, z = (np.array(a) for a in jq.quantize_blockwise(jnp.asarray(w), bits=8,
                                                            block_size=block))
    assert q.shape[1] // s.shape[1] == block
    assert dqm.dqm_route(M, D, q.shape[1], s.shape[1]) == "tensor_cores"
    assert dqm.padded_block(q.shape[1], s.shape[1]) == -(-block // 64) * 64
    ref = np.asarray(jdequant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                     jnp.asarray(z), orig_size=F))
    got = dqm.dequant_matmul_split_ref(*(torch.from_numpy(a) for a in (x, q, s, z)),
                                       orig_size=F)
    assert got.dtype == torch.float32 and got.shape == (M, F)
    _within(got.numpy(), ref)
