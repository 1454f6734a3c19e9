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
    before = dqm.launches
    got = dqm.dequant_matmul(tx, *(torch.from_numpy(a) for a in (q, s, z)), orig_size=F,
                             bits=bits)
    assert dqm.launches == before  # a CPU tensor takes the plain version
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
