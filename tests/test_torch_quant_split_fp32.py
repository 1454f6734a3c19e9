"""The fp32 arithmetic of the tensor-core routes of B6 / B7 (int8 / int4
weights) and of B8 (the dequant-fused product of the quantized wire) at the
shapes they newly take, on the CPU, against the JAX package.

- ``qmatmul_fp32_split_ref`` (B6 / B7 with fp32 x on the tensor cores: for
  each 64-deep step of D and each column group, x times the group's scales
  rounded once and cut into three bf16 parts against the exact integers,
  chunked along D as ``tc_plan`` cuts it) against the JAX package's
  ``int8_matmul`` / ``int4_matmul`` with fp32 x at 9-256 rows: its Pallas
  kernel in interpret mode at a TPU-eligible shape, its XLA fallback
  elsewhere (group 64, F off 512-column tiles). Both within 1e-5 of the
  largest output of each other and of the float64 product.
- ``dequant_matmul_split_ref`` (B8 on the tensor cores) at 1, 32 and 63 rows
  and scale blocks of 64 and 128 against the JAX package's
  ``dequant_matmul`` (its fallback; in interpret mode at block 128), within
  1e-5 of the largest output; and ``dqm_tile``, the kernel's tiling.

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

RTOL = 1e-5  # relative to the largest output: both sides are fp32 products


def _qmm_operands(M, D, F, group, bits, seed):
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


def _model(x, q, s, group, bits):
    M, D = x.shape
    F = q.shape[1] * (2 if bits == 4 else 1)
    assert im.qmm_route(M, torch.float32, D, F, group, bits) == "tensor_cores"
    chunk, _ = im.tc_plan(M, D, F, 132)  # the H100's 132 SMs
    got = im.qmatmul_fp32_split_ref(torch.from_numpy(x), torch.from_numpy(np.array(q)),
                                    torch.from_numpy(np.array(s)), group, bits, chunk)
    assert got.dtype == torch.float32 and got.shape == (M, F)
    return got.numpy()


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [9, 64, 256])
def test_fp32_split_model_matches_the_pallas_kernel_in_interpret_mode(M, bits):
    """(D, F, group) = (768, 3072, 128), GPT-2-125M's mlp_up: the JAX package
    runs its Pallas kernel (interpret mode on the CPU) with fp32 x."""
    D, F, group = 768, 3072, 128
    x, q, s, exact = _qmm_operands(M, D, F, group, bits, M + bits)
    eligible = jmm._eligible4 if bits == 4 else jmm._eligible
    assert jmm._on_tpu() and eligible(M, D, F, group, 256, 512)
    jfn = jmm.int4_matmul if bits == 4 else jmm.int8_matmul
    ref = np.asarray(jfn(jnp.asarray(x), q, s, group_size=group))
    got = _model(x, q, s, group, bits)
    _within(got, ref)
    _within(got, exact)
    _within(ref, exact)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("M,D,F,group", [(9, 768, 2304, 128), (16, 768, 768, 64),
                                         (40, 3072, 768, 128), (100, 1024, 1024, 64),
                                         (256, 768, 2304, 64)],
                         ids=["qkv-M9", "attn_out-g64", "mlp_down-M40", "350m-g64-M100",
                              "qkv-g64-M256"])
def test_fp32_split_model_matches_the_xla_fallback(M, D, F, group, bits):
    """Shapes the Pallas kernel does not take (group 64, F off its 512-column
    tiles): the JAX package's XLA dequantize-then-matmul in fp32."""
    x, q, s, exact = _qmm_operands(M, D, F, group, bits, M + D + F + bits)
    eligible = jmm._eligible4 if bits == 4 else jmm._eligible
    assert not eligible(M, D, F, group, min(256, D), min(512, F))
    jfn = jmm.int4_matmul if bits == 4 else jmm.int8_matmul
    ref = np.asarray(jfn(jnp.asarray(x), q, s, group_size=group))
    got = _model(x, q, s, group, bits)
    _within(got, ref)
    _within(got, exact)


def test_fp32_split_model_needs_more_than_one_bf16_part():
    """x s cut into three bf16 parts sums back to itself exactly; its top
    part alone (one bf16 pass) lands off the float64 product by more than
    the 1e-5 bar, so the bar tells the two apart."""
    M, D, F, group, bits = 64, 768, 768, 128, 8
    x, q, s, exact = _qmm_operands(M, D, F, group, bits, 7)
    G = F // group
    v = torch.from_numpy(x)[:, None, :] * torch.from_numpy(np.array(s)).reshape(D, G).t()[None]
    hi, mid, lo = dqm.split3(v)  # [M, G, D]: x s_g
    torch.testing.assert_close((hi + mid) + lo, v, rtol=0, atol=0)
    qg = torch.from_numpy(np.array(q)).float().reshape(D, G, group)
    one = torch.einsum("mgk,kgc->mgc", hi, qg).reshape(M, F).numpy().astype(np.float64)
    assert np.abs(one - exact).max() > RTOL * np.abs(exact).max()
    _within(_model(x, q, s, group, bits), exact)


def _dqm_operands(M, D, F, block, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w = rng.standard_normal((D, F)).astype(np.float32) * 0.02
    return x, [np.array(a) for a in jq.quantize_blockwise(jnp.asarray(w), bits=8,
                                                          block_size=block)]


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("M", [1, 32, 63])
def test_dequant_split_model_matches_the_jax_fallback(M, block):
    """B8's tensor-core arithmetic at the rows and blocks this route newly
    takes (9d's 32 rows; ``zero_quantize_block_size`` 64 and 128) against
    the JAX package's fallback, D 768 and a vocabulary padded to whole
    blocks."""
    D, F = 768, 1000
    x, (q, s, z) = _dqm_operands(M, D, F, block, M + block)
    assert dqm.dqm_route(M, D, q.shape[1], s.shape[1]) == "tensor_cores"
    ref = np.asarray(jdequant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                     jnp.asarray(z), orig_size=F))
    got = dqm.dequant_matmul_split_ref(*(torch.from_numpy(a) for a in (x, q, s, z)),
                                       orig_size=F)
    assert got.dtype == torch.float32 and got.shape == (M, F)
    _within(got.numpy(), ref)


def test_dequant_split_model_matches_the_pallas_kernel_at_block_128(monkeypatch):
    """At a block of 128 (a whole TPU lane tile) the JAX package's Pallas
    kernel takes [32, 256] x [256, 512] in interpret mode."""
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    x, (q, s, z) = _dqm_operands(32, 256, 512, 128, 11)
    ref = np.asarray(jdequant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                     jnp.asarray(z), orig_size=512))
    got = dqm.dequant_matmul_split_ref(*(torch.from_numpy(a) for a in (x, q, s, z)),
                                       orig_size=512)
    _within(got.numpy(), ref)


@pytest.mark.parametrize("M,Fp,nb,tile", [
    (4096, 50432, 197, (2, 256)),  # 9b's head at B8 x T512, blocks of 256
    (4096, 50304, 393, (2, 128)),  # 9e: blocks of 128
    (4096, 50304, 786, (2, 64)),   # blocks of 64
    (100, 3072, 16, (2, 64)),      # a block of 192: 64-column tiles
    (65, 50432, 197, (2, 256)),    # the first row count past one 64-row tile
    (64, 50432, 197, (1, 256)),    # at most 64 rows: the warpgroups side by side
    (32, 50432, 197, (1, 256)),    # 9d's head
    (1, 50304, 393, (1, 256)),     # a block of 128: a warpgroup each block
    (63, 50304, 786, (1, 128)),    # a block of 64: a warpgroup each block
    (4096, 50304, 524, (2, 128)),  # a block of 96, padded to 128
    (32, 50304, 524, (1, 256)),    # 9d's head at a block of 96
    (4096, 50500, 202, (2, 256)),  # a block of 250, padded to 256
    (256, 50400, 315, (2, 64)),    # a block of 160, padded to 192
    (32, 50400, 315, (1, 128)),
    (1, 50304, 6288, (1, 128)),    # a block of 8, padded to 64
])
def test_dqm_tile(M, Fp, nb, tile):
    """The tensor-core kernel's tiling from the shapes: each warpgroup's
    columns inside one scale block, padded to whole 64-column panels."""
    assert dqm.dqm_tile(M, Fp, nb) == tile
    rw, cols = tile
    assert dqm.padded_block(Fp, nb) % (cols if rw == 2 else cols // 2) == 0


@pytest.mark.parametrize("M,Fp,nb,tile", [
    (4096, 50432, 197, (2, 128)),  # a block of 256: 128 columns, not 256
    (256, 6144, 24, (2, 128)),     # gpt-neox-20b's width, a block of 256
    (256, 6144, 64, (2, 128)),     # a block of 96, padded to 128
    (256, 6144, 32, (2, 64)),      # a block of 192
    (256, 6144, 96, (2, 64)),      # a block of 64
    (32, 50432, 197, (1, 256)),    # at most 64 rows: as without promotion at whole panels
    (63, 50304, 786, (1, 128)),
    (32, 6144, 64, (1, 128)),      # a block of 96: 64 x 256's padded instance would spill
])
def test_dqm_tile_when_promoting(M, Fp, nb, tile):
    """With promotion the 128-row block takes at most 128 columns (its fp32
    sums need the registers that 128 x 256 holds); the 64-row tilings are
    unchanged at whole 64-column panels and take 128 columns at padded
    blocks."""
    assert dqm.dqm_tile(M, Fp, nb, promote=True) == tile
    rw, cols = tile
    assert dqm.padded_block(Fp, nb) % (cols if rw == 2 else cols // 2) == 0


@pytest.mark.parametrize("D,dtype,promotes", [
    (768, torch.float32, False), (1024, torch.float32, False), (1536, torch.float32, True),
    (6144, torch.float32, True), (6144, torch.bfloat16, False), (6144, torch.float16, False)])
def test_dqm_promotes_fp32_x_past_d_1024(D, dtype, promotes):
    assert dqm.dqm_promotes(D, dtype) is promotes


@pytest.mark.parametrize("D", [768, 6144])
def test_truncating_accumulators_and_their_promotion(D):
    """``dequant_matmul_trunc_ref`` (the kernel's arithmetic with every
    addition into the fp32 accumulator rounded toward zero): one accumulator
    over gpt-neox-20b's D 6144 misses the 1e-5 bar against the float64
    product (the card: 2.29e-5), over GPT-2's D 768 it keeps it (the card:
    3.8e-6); added into fp32 sums every 256 rows of D it stays within 3e-6
    at both, and the same arithmetic in IEEE fp32
    (``dequant_matmul_split_ref``) within 1e-6."""
    rng = np.random.default_rng(D)
    x = rng.standard_normal((8, D)).astype(np.float32)
    w = rng.standard_normal((D, 256)).astype(np.float32) * 0.02
    q, s, z = (np.array(a) for a in jq.quantize_blockwise(jnp.asarray(w), bits=8,
                                                           block_size=256))
    exact = x.astype(np.float64) @ (q.astype(np.float64) * np.repeat(s, 256, 1)
                                    + np.repeat(z, 256, 1))
    args = [torch.from_numpy(a) for a in (x, q, s, z)]
    rel = {}
    for name, fn in (("one", lambda: dqm.dequant_matmul_trunc_ref(*args, orig_size=256)),
                     ("promoted", lambda: dqm.dequant_matmul_trunc_ref(*args, orig_size=256,
                                                                      promote=True)),
                     ("ieee", lambda: dqm.dequant_matmul_split_ref(*args, orig_size=256))):
        rel[name] = np.abs(fn().double().numpy() - exact).max() / np.abs(exact).max()
    assert rel["promoted"] <= 3e-6 and rel["ieee"] <= 1e-6, rel
    assert (rel["one"] > 1e-5) if D == 6144 else (rel["one"] <= 1e-5), rel
