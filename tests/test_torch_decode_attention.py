"""The port's decode attention vs the JAX package's Pallas ``decode_attention``
(interpret mode on the CPU). The CUDA kernel itself is held against the
plain version on the card (``test_torch_kernels.py`` and ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from deepspeed_tpu_torch.ops.cuda import decode_attention as da

# fp32 on both sides; tile-wise online softmax vs one masked softmax
ATOL = 1e-5


def _inputs(B=4, H=2, S=256, Dh=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, Dh), dtype=np.float32)
    k = rng.standard_normal((B, H, S, Dh), dtype=np.float32)
    v = rng.standard_normal((B, H, S, Dh), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("lengths", [[1, 77, 200, 256], [128, 3, 129, 1]])
def test_decode_plain_matches_jax_per_row_lengths(lengths):
    """Per-row lengths, including 1 and lengths that are not a multiple of
    the JAX kernel's 128-position tile."""
    q, k, v = _inputs()
    lens = np.asarray(lengths, np.int32)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                     block_k=128)
    out = da.decode_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(lens))
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cur_len", [1, 45, 64])
def test_decode_plain_matches_jax_scalar_length(cur_len):
    """A scalar length is broadcast over the batch, as ``_as_lengths`` does;
    an int and a 0-d tensor give the same result."""
    q, k, v = _inputs(B=2, H=3, S=64, Dh=16, seed=1)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(cur_len),
                     block_k=16, softmax_scale=0.2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = da.decode_attention(tq, tk, tv, cur_len, softmax_scale=0.2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    out_t = da.decode_attention(tq, tk, tv, torch.tensor(cur_len), softmax_scale=0.2)
    np.testing.assert_array_equal(out_t.numpy(), out.numpy())


def test_as_lengths_and_input_checks():
    assert da._as_lengths(5, 3, torch.device("cpu")).tolist() == [5, 5, 5]
    with pytest.raises(ValueError, match="scalar or"):
        da._as_lengths(torch.tensor([1, 2]), 3, torch.device("cpu"))
    q, k, v = map(torch.from_numpy, _inputs(B=2, S=32))
    with pytest.raises(TypeError, match="cache dtype"):
        da.decode_attention(q.half(), k, v, 4)
    with pytest.raises(ValueError, match="do not match"):
        da.decode_attention(q, k[:, :1], v[:, :1], 4)
    # a zero length gives zeros, as the kernel's l_safe does
    assert torch.count_nonzero(da.decode_attention(q, k, v, 0)) == 0

