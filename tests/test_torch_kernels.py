"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine with the card and
no JAX: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_kernels.py`` (``--noconftest`` skips ``tests/conftest.py``,
which sets up JAX).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import decode_attention as da
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

# fp32: the kernel and the plain version both accumulate in fp32, in another
# order; bf16: both round the output to bf16 (2^-8 relative)
TOLERANCES = [(torch.float32, 5e-5), (torch.bfloat16, 2e-2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_kernels.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(shape, device, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLERANCES)
@pytest.mark.parametrize("T,S,causal,D", [(512, 512, True, 64), (128, 512, True, 64),
                                          (256, 256, False, 64), (256, 256, True, 128)])
def test_flash_kernel_matches_plain(cuda_device, dtype, atol, T, S, causal, D):
    q = _normal((2, T, 3, D), cuda_device, dtype, 0)
    k = _normal((2, S, 3, D), cuda_device, dtype, 1)
    v = _normal((2, S, 3, D), cuda_device, dtype, 2)
    before = fa.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
    assert (o.float() - o_ref.float()).abs().max().item() <= atol
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLERANCES)
def test_decode_kernel_matches_plain(cuda_device, dtype, atol):
    """GPT-2-125M decode shapes, per-row and scalar lengths."""
    B, H, S, Dh = 4, 12, 640, 64
    q = _normal((B, 1, H, Dh), cuda_device, dtype, 3)
    k = _normal((B, H, S, Dh), cuda_device, dtype, 4)
    v = _normal((B, H, S, Dh), cuda_device, dtype, 5)
    lens = torch.tensor([1, 77, 513, 640], dtype=torch.int32, device=cuda_device)
    for cur_len in (lens, 300):
        before = da.launches
        out = da.decode_attention(q, k, v, cur_len)
        torch.cuda.synchronize()
        assert da.launches == before + 1
        ref = da.decode_attention_ref(q, k, v, cur_len)
        assert (out.float() - ref.float()).abs().max().item() <= atol
