"""Kernel B8's plain route (``ops/cuda/dequant_matmul.py``) against the JAX
package's ``dequant_matmul``: on its XLA fallback at shapes the Pallas
kernel does not take, and in Pallas interpret mode at one it does
(``[8, 256] x [256, 512]``, as ``tests/test_overlap.py`` runs it). Both
sides get the same uint8 payload, bitwise the reference's quantizer's.
Tolerances: fp32 1e-5 relative to the largest output (another summation
order); bf16 x 2e-2 (the reference's fallback multiplies in bf16, the port
in fp32 with one rounding of the output). The kernel itself runs on the card
only (``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.comm import quantized as jq
from deepspeed_tpu.ops.pallas.dequant_matmul import dequant_matmul as jdequant_matmul
from deepspeed_tpu_torch.comm import quantized as tq
from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm


def _inputs(M, D, F, block, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, D)).astype(np.float32)
    w = rng.normal(size=(D, F)).astype(np.float32) * 0.02
    payload = jq.quantize_blockwise(jnp.asarray(w), bits=bits, block_size=block)
    return x, [np.array(a) for a in payload]


def _close(got, ref, rtol):
    ref = np.asarray(ref, np.float32)
    assert np.abs(np.asarray(got, np.float32) - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,D,F,block", [(37, 96, 300, 256), (5, 64, 96, 256),
                                         (16, 128, 700, 128), (3, 768, 2304, 256)],
                         ids=["pad-256", "effective-96", "block-128", "qkv-leaf"])
def test_plain_route_matches_the_jax_fallback(M, D, F, block, bits, dtype, rtol):
    x, (q, s, z) = _inputs(M, D, F, block, bits, M + D + F)
    ref = jdequant_matmul(jnp.asarray(x, dtype), jnp.asarray(q), jnp.asarray(s),
                          jnp.asarray(z), orig_size=F, bits=bits)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    before = dqm.tc_launches
    got = dqm.dequant_matmul(tx, *(torch.from_numpy(a) for a in (q, s, z)), orig_size=F,
                             bits=bits)
    assert dqm.tc_launches == before  # a CPU tensor takes the plain version
    assert got.dtype == tx.dtype and got.shape == (M, F)
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol)


def test_plain_route_matches_the_jax_kernel_in_interpret_mode(monkeypatch):
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    x, (q, s, z) = _inputs(8, 256, 512, 256, 8, 0)
    ref = jdequant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(z),
                          orig_size=512)
    got = dqm.dequant_matmul(torch.from_numpy(x), *(torch.from_numpy(a) for a in (q, s, z)),
                             orig_size=512)
    _close(got.numpy(), np.asarray(ref), 1e-5)
    # and the plain version is the dequantize-then-product it stands for
    w = tq.dequantize_blockwise(*(torch.from_numpy(a) for a in (q, s, z)), orig_size=512)
    torch.testing.assert_close(got, torch.from_numpy(x) @ w, rtol=0, atol=0)


def test_rejects_what_the_kernel_does_not_take():
    x, (q, s, z) = _inputs(4, 64, 96, 256, 8, 1)
    x, q, s, z = (torch.from_numpy(a) for a in (x, q, s, z))
    with pytest.raises(TypeError, match="uint8"):
        dqm.dequant_matmul(x, q.to(torch.int8), s, z, orig_size=96)
    with pytest.raises(ValueError, match="do not fit"):
        dqm.dequant_matmul(x, q, s[:, :0], z[:, :0], orig_size=96)
    with pytest.raises(ValueError, match="do not fit"):
        dqm.dequant_matmul(x, q, s, z, orig_size=97)
    with pytest.raises(ValueError, match="make"):
        dqm.dequant_matmul(x[:, :10], q, s, z, orig_size=96)
    with pytest.raises(ValueError, match="bits"):
        dqm.dequant_matmul(x, q, s, z, orig_size=96, bits=2)


def _exact(x, q, s, z, F):
    """x @ (q s + z) in float64, the weights unrounded: the function the
    fp32 route approximates."""
    block = q.shape[1] // s.shape[1]
    w = (q.astype(np.float64) * np.repeat(s.astype(np.float64), block, axis=1)
         + np.repeat(z.astype(np.float64), block, axis=1))
    return x.astype(np.float64) @ w[:, :F]


@pytest.mark.parametrize("M,D,F,block", [(64, 64, 512, 256), (96, 128, 700, 256),
                                         (130, 192, 1000, 512), (64, 768, 600, 256),
                                         (37, 100, 1000, 256), (32, 480, 600, 96)],
                         ids=["one-tile", "ragged-F", "block-512", "head-width", "D100",
                              "D480-block96"])
def test_tensor_core_model_matches_the_jax_fallback(M, D, F, block):
    """The tensor-core route's arithmetic (x times each block's scales cut
    into three bf16 parts, the exact q, the zero-point side product; modelled
    by ``dequant_matmul_split_ref``) against the JAX fallback, within 5e-5 of
    the largest output (chip_smoke.py's fp32 tolerance for B8), and as close
    to the float64 function as the plain fp32 version (1e-5: both are fp32
    products, which cancel z against q s)."""
    x, (q, s, z) = _inputs(M, D, F, block, 8, M + D + F)
    assert dqm.dqm_route(M, D, q.shape[1], s.shape[1]) == "tensor_cores"
    ref = np.asarray(jdequant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                     jnp.asarray(z), orig_size=F))
    t = [torch.from_numpy(a) for a in (x, q, s, z)]
    got = dqm.dequant_matmul_split_ref(*t, orig_size=F)
    assert got.dtype == torch.float32 and got.shape == (M, F)
    _close(got.numpy(), ref, 5e-5)
    exact = _exact(x, q, s, z, F)
    top = np.abs(exact).max()
    assert np.abs(got.numpy() - exact).max() <= 1e-5 * top
    plain = dqm.dequant_matmul(*t, orig_size=F).numpy()
    assert np.abs(plain - exact).max() <= 1e-5 * top


def test_three_bf16_parts_are_exact():
    """split3 cuts fp32 values (normal, tiny and large magnitudes, both
    signs) into three bf16-representable parts whose sum is the value,
    bitwise, in either order of addition."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096))
                         .astype(np.float32))
    hi, mid, lo = dqm.split3(v)
    for part in (hi, mid, lo):
        torch.testing.assert_close(part.to(torch.bfloat16).float(), part, rtol=0, atol=0)
    torch.testing.assert_close((hi + mid) + lo, v, rtol=0, atol=0)
    torch.testing.assert_close(hi + (mid + lo), v, rtol=0, atol=0)


@pytest.mark.parametrize("M,D,Fp,nb,bits,route", [
    (4096, 768, 50432, 197, 8, "tensor_cores"),  # the LM head at B8 x T512 (phase 9b)
    (2048, 768, 50432, 197, 8, "tensor_cores"),  # B4 x T512 (phase 9a)
    (64, 64, 512, 2, 8, "tensor_cores"),         # one 64-row wgmma tile
    (64, 128, 1024, 2, 8, "tensor_cores"),       # a block of 512: two tiles a block
    (63, 768, 50432, 197, 8, "tensor_cores"),    # under 64 rows: the 64-row tiling
    (1, 768, 50432, 197, 8, "tensor_cores"),     # one row
    (4096, 768, 3072, 24, 8, "tensor_cores"),    # a block of 128: 128-column tiles
    (32, 768, 50304, 786, 8, "tensor_cores"),    # 9d's head at a block of 64
    (4096, 768, 3000, 15, 8, "tensor_cores"),    # a block of 200, padded to 256 columns
    (4096, 64, 96, 1, 8, "tensor_cores"),        # an effective block of 96
    (4096, 100, 512, 2, 8, "tensor_cores"),      # D off whole 64-row steps
    (32, 768, 50304, 524, 8, "tensor_cores"),    # 9d's head at a block of 96
    (4096, 768, 50304, 524, 8, "tensor_cores"),  # the LM head at a block of 96
    (1, 768, 50304, 6288, 8, "tensor_cores"),    # a block of 8
    (32, 768, 50304, 1048, 8, "tensor_cores"),   # a block of 48
    (256, 768, 50400, 315, 8, "tensor_cores"),   # a block of 160
    (63, 768, 50500, 202, 8, "tensor_cores"),    # a block of 250
    (64, 768, 3003, 1, 8, "none"),               # an odd block: no kernel
    (32, 480, 50432, 197, 8, "tensor_cores"),    # a head of d 480 (D off 64-row steps)
    (37, 768, 50304, 128, 8, "none"),            # an odd block of 393
    (4096, 768, 25216, 197, 4, "plain"),         # packed int4: the plain route everywhere
])
def test_dqm_route(M, D, Fp, nb, bits, route):
    """The route from the shapes alone, at its edges."""
    assert dqm.dqm_route(M, D, Fp, nb, bits) == route

