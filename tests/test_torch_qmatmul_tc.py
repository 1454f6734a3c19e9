"""The route of the port's quantized-weight products (B6 int8, B7 int4) and
the arithmetic of their tensor-core kernel, on the CPU.

- :func:`qmm_route` over rows, dtype, group layout and bits, and the
  tensor-core kernel's split plan (``tc_plan``).
- ``qmatmul_split_ref``, the kernel's rounding modelled in torch (the fp32
  weight as hi + lo halves of x's 16-bit dtype, fp16's weights times a power
  of two per 64-column panel and chunk of D, fp32 sums in 64-deep steps and
  chunks in order, one rounding), against the fp32 plain version: within 1
  ulp of bf16 and of fp16 on the entries of at least 1e-3 of the largest. A
  product over the weight cast once to the dtype is worse.
- The plain version with bf16 x against the JAX package's Pallas kernels
  (interpret mode) at a TPU-eligible prefill row.

Inputs are numpy from a seed (GPT-2's weight scale, 0.02).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import int8_matmul as jmm
from deepspeed_tpu.ops.quantizer import quantize as jax_quantize
from deepspeed_tpu_torch.ops.cuda import int8_matmul as im
from deepspeed_tpu_torch.ops.quantizer import quantize

from _torch_ulps import ulp_err

BF16, FP16, FP32 = torch.bfloat16, torch.float16, torch.float32
_COUNTERS = ("int8_launches", "int4_launches", "int8_tc_launches", "int4_tc_launches",
             "int8_dec_launches", "int4_dec_launches")


@pytest.mark.parametrize("M,dtype,D,F,group,bits,route", [
    (256, BF16, 768, 3072, 128, 8, "tensor_cores"),      # the _MAX_M edge
    (257, BF16, 768, 3072, 128, 8, "dequantize"),
    (2048, FP32, 768, 3072, 128, 4, "dequantize"),
    (9, FP16, 768, 2304, 128, 4, "tensor_cores"),        # just above the crossover
    (8, BF16, 768, 2304, 128, 8, "decode"),              # a decode step's rows
    (1, FP16, 768, 768, 128, 4, "decode"),
    (256, FP32, 768, 3072, 128, 8, "tensor_cores"),      # fp32: three bf16 parts of x s
    (40, FP32, 768, 3072, 128, 4, "tensor_cores"),
    (8, FP32, 768, 3072, 128, 8, "decode"),              # fp32 decode rows
    (9, FP32, 1024, 4096, 64, 4, "tensor_cores"),        # fp32 at group 64
    (64, FP32, 768, 768, 32, 8, "cuda_cores"),           # fp32: a group under a panel
    (40, BF16, 3072, 768, 64, 4, "tensor_cores"),        # group 64
    (64, BF16, 768, 768, 32, 8, "tensor_cores"),         # four scales a panel row
    (64, BF16, 768, 768, 256, 8, "tensor_cores"),        # a panel inside a group
    (40, BF16, 320, 960, 128, 8, "cuda_cores"),          # groups cross rows
    (64, BF16, 100, 768, 128, 8, "cuda_cores"),          # D not whole 64-row steps
    (64, BF16, 768, 768, 96, 8, "cuda_cores"),           # a panel crosses a group
    (64, BF16, 768, 768, 4, 8, "cuda_cores"),            # groups under 8
    (64, BF16, 768, 960, 64, 8, "tensor_cores"),         # int8: whole 64-column panels
    (64, BF16, 768, 960, 64, 4, "cuda_cores"),           # int4: halves of whole panels
    (2, FP32, 1024, 4096, 64, 4, "decode"),              # decode: group 64, every dtype
    (4, FP16, 4096, 1024, 128, 8, "decode"),
    (8, BF16, 768, 768, 256, 8, "decode"),               # a group of whole panels
    (8, BF16, 768, 768, 32, 8, "cuda_cores"),            # decode: a group under a panel
    (1, FP32, 320, 960, 128, 8, "cuda_cores"),           # decode: groups cross rows
    (8, BF16, 100, 768, 128, 8, "cuda_cores"),           # decode: D off 64-row steps
    (4, BF16, 768, 960, 64, 4, "cuda_cores"),            # decode, int4: halves of panels
    (9, BF16, 768, 768, 32, 8, "tensor_cores"),          # past decode rows: the tc layouts
], ids=lambda v: str(v).replace("torch.", ""))
def test_qmm_route(M, dtype, D, F, group, bits, route):
    assert im.qmm_route(M, dtype, D, F, group, bits) == route


def test_tc_plan_covers_d_in_steps_and_fills_the_card():
    """Chunks are whole 64-row steps that cover D with none empty, a cluster
    is at most 8 blocks, the grid stays within one block per SM (clusters of
    more than 3 within three quarters of them) and a split chunk keeps at
    least two steps."""
    for M, D, F in ((256, 768, 2304), (256, 768, 768), (256, 768, 3072), (256, 3072, 768),
                    (256, 1024, 4096), (256, 4096, 1024), (16, 768, 2304), (40, 768, 768),
                    (64, 1024, 1024), (100, 3072, 768), (128, 4096, 1024), (9, 64, 128)):
        chunk, cluster = im.tc_plan(M, D, F, 132)
        blocks = -(-F // 128) * -(-M // 128) * cluster
        assert chunk % 64 == 0 and 1 <= cluster <= 8
        assert chunk * cluster >= D > chunk * (cluster - 1)
        assert blocks <= (132 if cluster <= 3 else 99) or cluster == 1
        assert cluster == 1 or chunk >= 128
    assert im.tc_plan(256, 768, 3072, 132) == (384, 2)  # 48 tiles x 2 chunks of 6 steps
    assert im.tc_plan(256, 768, 2304, 132) == (256, 3)  # 36 tiles x 3 chunks of 4 steps
    assert im.tc_plan(256, 3072, 768, 132) == (384, 8)  # 12 tiles x 8 chunks of 6 steps
    assert im.tc_plan(256, 768, 768, 132) == (128, 6)  # 12 tiles x 6 chunks of 2 steps
    assert im.tc_plan(256, 1024, 4096, 132) == (512, 2)  # 64 tiles x 2
    assert im.tc_plan(128, 1024, 4096, 132) == (384, 3)  # 32 tiles: 4 x 32 would not fit
    assert im.tc_plan(64, 3072, 768, 132) == (384, 8)  # 6 tiles x 8 chunks of 6 steps
    assert im.tc_plan(9, 64, 128, 132) == (64, 1)  # one step: no split


def _operands(M, D, F, group, bits, dtype, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((D, F), dtype=np.float32) * 0.02)
    q, s = quantize(w, bits=bits, num_groups=D * F // group)
    x = torch.from_numpy(rng.standard_normal((M, D), dtype=np.float32)).to(dtype)
    return x, (im.pack_int4(q) if bits == 4 else q), s


@pytest.mark.parametrize("dtype", [BF16, FP16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("M,D,F", [(64, 3072, 768), (256, 768, 3072)],
                         ids=["mlp_down-M64", "mlp_up-M256"])
def test_split_model_within_one_ulp_where_a_single_cast_is_not(dtype, bits, M, D, F):
    """The kernel's hi + lo arithmetic, split along D as its plan splits it,
    stays within 1 ulp of the dtype of the fp32 plain version; one cast of
    the weight to the dtype lands many ulps off on the smaller entries."""
    x, q, s = _operands(M, D, F, 128, bits, dtype, 0)
    ref_fn = im.int4_matmul_ref if bits == 4 else im.int8_matmul_ref
    ref = ref_fn(x.float(), q, s, 128)
    chunk, _ = im.tc_plan(M, D, F, 132)
    model = im.qmatmul_split_ref(x, q, s, 128, bits, chunk)
    assert model.dtype == dtype and model.shape == (M, F)
    assert ulp_err(model, ref, dtype) <= 1.0
    w = im.unpack_int4(q) if bits == 4 else q
    single = (x.float() @ im.dequantize(w, s).to(dtype).float()).to(dtype)
    assert ulp_err(single, ref, dtype) > 4.0


def test_split_model_fp16_needs_its_panel_scale():
    """At GPT-2's weight magnitudes fp16's lo half is subnormal without the
    panel's power of two: the unscaled split leaves 1 ulp, the scaled one
    stays inside it (the kernel's exponents, read back from the model)."""
    x, q, s = _operands(256, 768, 3072, 128, 8, FP16, 0)
    ref = im.int8_matmul_ref(x.float(), q, s, 128)
    e = im._panel_exponents(s.reshape(768, 24), 3072, 128, 128.0)
    assert e.shape == (48,) and int(e.min()) >= 12  # 128 * max scale ~ 2^-1..2^2
    w = im.dequantize(q, s)
    hi = w.to(FP16).float()
    unscaled = (x.float() @ hi + x.float() @ (w - hi).to(FP16).float()).to(FP16)
    assert ulp_err(unscaled, ref, FP16) > 1.0
    assert ulp_err(im.qmatmul_split_ref(x, q, s, 128, 8), ref, FP16) <= 1.0


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_plain_bf16_matches_the_pallas_kernel_at_a_prefill_row(bits):
    """(M, D, F, group) = (256, 768, 3072, 128), bf16 x: the JAX package
    runs its Pallas kernel (interpret mode); the port's wrapper on the CPU
    takes the plain version and launches nothing. Both sum in fp32 in
    another order and round once to bf16: at most 1 ulp apart."""
    M, D, F, group = 256, 768, 3072, 128
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w = rng.standard_normal((D, F)).astype(np.float32) * 0.02
    jq, js = jax_quantize(jnp.asarray(w), bits=bits, num_groups=D * F // group)
    if bits == 4:
        jq = jmm.pack_int4(jq)
        assert jmm._eligible4(M, D, F, group, 256, 512)
    else:
        assert jmm._eligible(M, D, F, group, 256, 512)
    assert jmm._on_tpu()
    jfn = jmm.int4_matmul if bits == 4 else jmm.int8_matmul
    ref = jfn(jnp.asarray(x, jnp.bfloat16), jq, js, group_size=group)
    assert ref.dtype == jnp.bfloat16
    fn = im.int4_matmul if bits == 4 else im.int8_matmul
    before = [getattr(im, c) for c in _COUNTERS]
    out = fn(torch.from_numpy(x).to(BF16), torch.from_numpy(np.array(jq)),
             torch.from_numpy(np.array(js)), group)
    assert [getattr(im, c) for c in _COUNTERS] == before
    assert out.dtype == BF16 and out.shape == (M, F)
    ref_t = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert ulp_err(out, ref_t, BF16) <= 1.0
