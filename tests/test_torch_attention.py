"""The port's attention ops vs the JAX package's.

On the CPU the port's flash-attention wrapper takes its plain PyTorch version;
it is held against the JAX Pallas ``flash_attention`` run in interpret mode,
as the JAX package's own tests run it. The CUDA kernel itself is held against
the plain version on the card (``test_torch_kernels.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops import attention as jax_attention
from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu_torch.ops import attention
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

# fp32 on both sides; the online and the whole-row softmax differ by rounding
ATOL = 1e-5


def _qkv(T, S, B=2, H=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, n, H, D), dtype=np.float32) for n in (T, S, S)]


@pytest.mark.parametrize("T,S,causal", [(256, 256, True), (256, 256, False),
                                        (128, 256, True)])
def test_flash_plain_matches_jax_flash(T, S, causal):
    """o and lse of the port's plain flash version vs the Pallas kernel
    (interpret mode, blocks 128); T=128/S=256 checks the bottom-right
    causal alignment."""
    q, k, v = _qkv(T, S)
    B, _, H, D = q.shape
    o_ref = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, block_q=128, block_k=128)
    flat = [jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, -1, D)) for x in (q, k, v)]
    _, lse_ref = jax_flash._fwd(*flat, 1.0 / np.sqrt(D), causal, 128, 128)

    o, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert o.shape == q.shape and o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[:, :, 0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_flash", [None, True, False])
def test_multihead_attention_dispatch_on_cpu(use_flash):
    """On the CPU auto dispatch takes the plain path (no kernel is eligible),
    and forcing flash takes the kernel's plain version: both agree with the
    JAX dispatch (XLA path / Pallas interpret)."""
    q, k, v = _qkv(128, 256, seed=1)
    assert not attention._flash_eligible(torch.from_numpy(q), torch.from_numpy(k), None)
    ref = jax_attention.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        use_flash=use_flash, block_q=128, block_k=128)
    launches = fa.launches
    out = attention.multihead_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                                        use_flash=use_flash)
    assert fa.launches == launches  # no kernel runs for CPU tensors
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_causal_mask_and_dot_product_match_jax():
    np.testing.assert_array_equal(attention.causal_mask(3, 5).numpy(),
                                  np.asarray(jax_attention.causal_mask(3, 5)))
    q, k, v = _qkv(8, 8, D=16, seed=2)
    bias = np.random.default_rng(3).standard_normal((2, 2, 8, 8), dtype=np.float32)
    ref = jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias),
        softmax_scale=0.3)
    out = attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                          bias=torch.from_numpy(bias), softmax_scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = map(torch.from_numpy, _qkv(128, 128))
    with pytest.raises(TypeError, match="dtypes"):
        fa.flash_attention_fwd(q, k.double(), v)
    with pytest.raises(ValueError, match="does not match"):
        fa.flash_attention_fwd(q, k[:, :, :1], v)
    with pytest.raises(NotImplementedError, match="stochastic_mode"):
        fa.flash_attention(q, k, v, stochastic_mode=True)

