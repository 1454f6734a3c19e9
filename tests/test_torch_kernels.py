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
from deepspeed_tpu_torch.ops.cuda import int8_matmul as im

from _torch_ulps import ulp_err, ulp_of_max_err

# fp32: the kernel and the plain version both accumulate in fp32, in another
# order; bf16: both round the output to bf16 (2^-8 relative)
TOLERANCES = [(torch.float32, 5e-5), (torch.bfloat16, 2e-2)]


def _d96(T, S, causal):
    """A (T, S, causal, D) case at head dim 96, selectable with ``-k d96``."""
    return pytest.param(T, S, causal, 96, id=f"{T}-{S}-{causal}-d96")


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


_FWD_COUNTERS = ("fwd_tf32_launches", "fwd_tc_launches", "fwd_tc_stochastic_launches")
_FLASH_COUNTERS = _FWD_COUNTERS + (
    "bwd_delta_launches", "bwd_dq_tf32_launches", "bwd_dkv_tf32_launches", "bwd_dq_tc_launches",
    "bwd_dkv_tc_launches", "bwd_dq_tc_stochastic_launches", "bwd_dkv_tc_stochastic_launches")


def _counts(names=_FLASH_COUNTERS):
    return {c: getattr(fa, c) for c in names}


def _moved(before, after):
    """The counters that moved, and by how much."""
    return {c: after[c] - n for c, n in before.items() if after[c] != n}


def _fused_qkv(T, S, H, D, device, dtype, seed):
    """q [B, T, H, D] and k, v [B, S, H, D] as strided views of one fused
    [B, S, 3HD] buffer (the model's qkv projection; q its last T rows)."""
    qkv = _normal((2, S, 3 * H * D), device, dtype, seed)
    k = qkv[..., H * D:2 * H * D].reshape(2, S, H, D)
    v = qkv[..., 2 * H * D:].reshape(2, S, H, D)
    return qkv[:, S - T:, :H * D].reshape(2, T, H, D), k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLERANCES)
@pytest.mark.parametrize("T,S,causal,D", [(512, 512, True, 64), (128, 512, True, 64),
                                          (256, 256, False, 64), (256, 256, True, 128),
                                          _d96(256, 256, True), _d96(100, 200, False)])
def test_flash_kernel_matches_plain(cuda_device, dtype, atol, T, S, causal, D):
    """B1 vs its plain version: fp32 launches the 3xTF32 kernel
    (``fwd_tf32_launches``), also within the fp32 bars of its CPU model
    (``flash_attention_tf32_ref``) and bitwise on a re-run; bf16 the
    tensor-core one (``fwd_tc_launches``)."""
    q = _normal((2, T, 3, D), cuda_device, dtype, 0)
    k = _normal((2, S, 3, D), cuda_device, dtype, 1)
    v = _normal((2, S, 3, D), cuda_device, dtype, 2)
    before = _counts(_FWD_COUNTERS)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    route = "fwd_tf32_launches" if dtype == torch.float32 else "fwd_tc_launches"
    assert _moved(before, _counts(_FWD_COUNTERS)) == {route: 1}
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
    assert (o.float() - o_ref.float()).abs().max().item() <= atol
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    if dtype == torch.float32:
        again, lse_again = fa.flash_attention_fwd(q, k, v, causal=causal)
        assert torch.equal(o, again) and torch.equal(lse, lse_again)
        o_model, lse_model = fa.flash_attention_tf32_ref(q, k, v, causal)
        assert (o - o_model).abs().max().item() <= atol
        assert (lse - lse_model).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("T,S,causal,D", [(512, 512, True, 64), (128, 512, True, 64),
                                          (256, 256, False, 64), (512, 512, True, 128),
                                          (100, 200, True, 64), (200, 200, False, 128),
                                          _d96(512, 512, True), _d96(100, 200, True)])
def test_flash_forward_tc_kernel_within_two_ulps_and_rerun_bitwise(cuda_device, dtype, T, S,
                                                                   causal, D):
    """The tensor-core B1 on fused-qkv views: within 2 ulps of its dtype of
    the fp32 function and of flash_attention_split_ref (its rounding) on
    entries of at least 1e-3 of the largest, lse within 1e-4, bitwise on a
    re-run; a single cast of P is not within 2 ulps."""
    q, k, v = _fused_qkv(T, S, 3, D, cuda_device, dtype, 20)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    again, lse_again = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o, again) and torch.equal(lse, lse_again)
    ref, lse_ref = fa.flash_attention_ref(q, k, v, causal)
    split, _ = fa.flash_attention_split_ref(q, k, v, causal)
    assert o.dtype == dtype and o.shape == q.shape
    assert ulp_err(o, ref, dtype) <= 2.0
    assert ulp_err(o, split, dtype) <= 2.0
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    cast, _ = fa.flash_attention_ref(q, k, v, causal, stochastic=True)
    assert ulp_err(cast, ref, dtype) > 2.0


def _single_cast_close(x, ref, dtype):
    """A kernel's single-cast (stochastic_mode) output against its plain
    version: where the two fp32 values of a term straddle a rounding
    boundary of the dtype they round apart (more often for fp16's 11-bit
    P than for bf16's 8-bit one), so the bar is 2 ulps at the largest entry
    and bitwise on at least 95% of the entries."""
    assert ulp_of_max_err(x, ref, dtype) <= 2.0
    assert (x.float() == ref.float()).float().mean().item() >= 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("T,S,causal,D", [(512, 512, True, 64), (128, 512, True, 64),
                                          (256, 256, False, 128), (100, 200, True, 64),
                                          _d96(256, 256, True)])
def test_flash_stochastic_kernels_match_single_cast_plain(cuda_device, dtype, T, S, causal, D):
    """stochastic_mode on the card: the single-cast instances of B1 and of
    B2's tensor-core dq and dk/dv against the single-cast plain versions
    (from the kernel's own lse), bitwise on a re-run, one launch each of
    the _tc_stochastic counters (delta as always) and none of the others."""
    q, k, v = _fused_qkv(T, S, 3, D, cuda_device, dtype, 21)
    do = _normal((2, T, 3, D), cuda_device, dtype, 22)
    before = _counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, stochastic=True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, stochastic=True)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, stochastic=True)
    o2, _ = fa.flash_attention_fwd(q, k, v, causal, stochastic=True)
    torch.cuda.synchronize()
    assert _moved(before, _counts()) == {
        "fwd_tc_stochastic_launches": 2, "bwd_delta_launches": 2,
        "bwd_dq_tc_stochastic_launches": 2, "bwd_dkv_tc_stochastic_launches": 2}
    assert torch.equal(o, o2)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, stochastic=True)
    _single_cast_close(o, o_ref, dtype)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    ref = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, stochastic=True)
    for g, g2, r in zip(grads, again, ref):
        assert g.dtype == dtype and torch.equal(g, g2)
        _single_cast_close(g, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,stochastic,path", [
    (torch.float32, False, ("fwd_tf32_launches", "bwd_dq_tf32_launches",
                            "bwd_dkv_tf32_launches")),
    (torch.float32, True, ("fwd_tf32_launches", "bwd_dq_tf32_launches",
                           "bwd_dkv_tf32_launches")),
    (torch.bfloat16, False, ("fwd_tc_launches", "bwd_dq_tc_launches", "bwd_dkv_tc_launches")),
    (torch.bfloat16, True, ("fwd_tc_stochastic_launches", "bwd_dq_tc_stochastic_launches",
                            "bwd_dkv_tc_stochastic_launches")),
    (torch.float16, False, ("fwd_tc_launches", "bwd_dq_tc_launches", "bwd_dkv_tc_launches")),
    (torch.float16, True, ("fwd_tc_stochastic_launches", "bwd_dq_tc_stochastic_launches",
                           "bwd_dkv_tc_stochastic_launches")),
], ids=["fp32", "fp32-stochastic", "bf16", "bf16-stochastic", "fp16", "fp16-stochastic"])
def test_flash_routes_by_dtype_and_mode(cuda_device, dtype, stochastic, path):
    """One forward and backward through FlashAttention launch exactly the
    route's kernels once each (delta in every dtype): fp32 the 3xTF32
    kernels (stochastic_mode is the default function there), bf16 / fp16
    the tensor-core ones, their single-cast instances with stochastic_mode."""
    q, k, v = (_normal((2, 256, 4, 64), cuda_device, dtype, s).requires_grad_(True)
               for s in (30, 31, 32))
    before = _counts()
    out = fa.flash_attention(q, k, v, causal=True, stochastic_mode=stochastic)
    torch.autograd.grad(out, (q, k, v), _normal(out.shape, cuda_device, dtype, 33))
    torch.cuda.synchronize()
    assert _moved(before, _counts()) == {c: 1 for c in path + ("bwd_delta_launches",)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLERANCES + [(torch.float16, 2e-2)])
@pytest.mark.parametrize("Dh", [64, pytest.param(96, id="d96"), 128])
def test_decode_kernel_matches_plain(cuda_device, dtype, atol, Dh):
    """B3, split over the cache (5 splits of 128 at S 640), at GPT-2-125M's
    decode shapes with Dh 64, 96 and 128: per-row lengths (0 gives zeros, 1,
    a split's edge 128 / 129, a length inside the last split, the
    capacity), a scalar one and 0 for every row; bitwise on a re-run."""
    B, H, S = 8, 12, 640
    q = _normal((B, 1, H, Dh), cuda_device, dtype, 3)
    k = _normal((B, H, S, Dh), cuda_device, dtype, 4)
    v = _normal((B, H, S, Dh), cuda_device, dtype, 5)
    lens = torch.tensor([0, 1, 77, 128, 129, 513, 639, 640], dtype=torch.int32,
                        device=cuda_device)
    for cur_len in (lens, 300, 0):
        before = da.launches
        out = da.decode_attention(q, k, v, cur_len)
        again = da.decode_attention(q, k, v, cur_len)
        torch.cuda.synchronize()
        assert da.launches == before + 2 and torch.equal(out, again)
        ref = da.decode_attention_ref(q, k, v, cur_len)
        assert (out.float() - ref.float()).abs().max().item() <= atol
    assert torch.count_nonzero(da.decode_attention(q, k, v, lens)[0]) == 0


_BWD_COUNTERS = ("bwd_delta_launches", "bwd_dq_tf32_launches", "bwd_dkv_tf32_launches",
                 "bwd_dq_tc_launches", "bwd_dkv_tc_launches")


def _bwd_counts():
    return {c: getattr(fa, c) for c in _BWD_COUNTERS}


def _single_cast_dv(q, k, lse, do, causal):
    """dV from one cast of P to q's dtype (not the kernels' hi/lo split)."""
    p = fa._probs(q, k, lse, causal, fa._scale(q, None)).to(q.dtype).float()
    return torch.einsum("bhts,bthd->bshd", p, do.float()).to(q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 5e-5), (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-2)])
@pytest.mark.parametrize("T,S,causal,D", [(512, 512, True, 64), (128, 512, True, 64),
                                          (256, 256, False, 64), (256, 256, True, 128),
                                          (100, 200, True, 64), _d96(256, 256, True),
                                          _d96(100, 200, False)])
def test_flash_backward_kernels_match_plain_and_rerun_bitwise(cuda_device, dtype, rtol, T, S,
                                                              causal, D):
    """B2 (delta, dq, dk/dv) vs its plain version, with q/k/v read as views of
    one fused buffer, and two runs giving bitwise-equal gradients (no atomics).
    Tolerance relative to the largest gradient entry. bf16 / fp16 take the
    tensor-core dq and dk/dv kernels (the _tc counters), fp32 the 3xTF32
    ones (the _tf32 counters), also within the fp32 bar of their CPU model
    (``flash_attention_bwd_tf32_ref``); bf16 / fp16 gradients are within 2
    ulps of their dtype of the fp32 plain version on entries of at least
    1e-3 of the largest, where dV from a single cast of P is not."""
    H = 3
    qkv = _normal((2, S, 3 * H * D), cuda_device, dtype, 6)
    k = qkv[..., H * D:2 * H * D].reshape(2, S, H, D)
    v = qkv[..., 2 * H * D:].reshape(2, S, H, D)
    q = qkv[:, S - T:, :H * D].reshape(2, T, H, D)
    do = _normal((2, T, H, D), cuda_device, dtype, 7)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    before = _bwd_counts()
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    route = (("bwd_dq_tc_launches", "bwd_dkv_tc_launches") if dtype != torch.float32
             else ("bwd_dq_tf32_launches", "bwd_dkv_tf32_launches"))
    assert _bwd_counts() == {c: n + (2 if c in route or c == "bwd_delta_launches" else 0)
                             for c, n in before.items()}
    ref = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    for g, g2, r in zip(grads, again, ref):
        assert g.shape == r.shape and g.dtype == dtype
        assert torch.equal(g, g2)
        scale = r.float().abs().max().item()
        assert (g.float() - r.float()).abs().max().item() <= rtol * scale
        if dtype != torch.float32:
            assert ulp_err(g, r, dtype) <= 2.0
    if dtype != torch.float32:
        assert ulp_err(_single_cast_dv(q, k, lse, do, causal), ref[2], dtype) > 2.0
    else:
        model = fa.flash_attention_bwd_tf32_ref(q, k, v, o, lse, do, causal)
        for g, m in zip(grads, model):
            assert (g - m).abs().max().item() <= rtol * m.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, pytest.param(96, id="d96"), 128])
@pytest.mark.parametrize("B,T,H", [(8, 512, 12), (2, 100, 12), (3, 37, 5)])
def test_flash_delta_kernel_rerun_bitwise_and_within_fp32_rounding(cuda_device, dtype, D, B,
                                                                   T, H):
    """B2's delta = rowsum(dO * O) in every dtype and head dim, with o read
    as a strided view of a fused buffer and row counts off the kernel's
    block of rows (B3 T37 H5): one launch a call, bitwise equal on a re-run,
    and within fp32 rounding of the plain version (both sum D products in
    fp32 in another order: each row within 2 D 2^-24 of its sum of |dO O|)."""
    fused = _normal((B, T, 2 * H * D), cuda_device, dtype, 31)
    o = fused[..., H * D:].reshape(B, T, H, D)
    do = _normal((B, T, H, D), cuda_device, dtype, 32)
    before = _counts()
    delta = fa.flash_attention_bwd_delta(o, do)
    again = fa.flash_attention_bwd_delta(o, do)
    torch.cuda.synchronize()
    assert _moved(before, _counts()) == {"bwd_delta_launches": 2}
    assert delta.shape == (B * H, T) and delta.dtype == torch.float32
    assert torch.equal(delta, again)
    ref = fa.flash_attention_bwd_delta_ref(o, do)
    mag = (do.float() * o.float()).abs().sum(-1).transpose(1, 2).reshape(B * H, T)
    assert ((delta - ref).abs() <= 2 * D * 2.0**-24 * mag).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, pytest.param(96, id="d96"), 128])
def test_flash_backward_fp16_small_gradients_on_the_card(cuda_device, D):
    """fp16 with dO 2^-8 of unit scale, as a loss averaged over many tokens
    gives it: dS lies below fp16's normal range, and the kernels' running
    row scale keeps dq, dk and dv within 2 fp16 ulps of the fp32 plain
    version, bitwise on a re-run."""
    H, T = 3, 512
    q, k, v = (_normal((2, T, H, D), cuda_device, torch.float16, s) for s in (12, 13, 14))
    do = _normal((2, T, H, D), cuda_device, torch.float16, 15) * 2.0**-8
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    ref = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, True)
    for g, g2, r in zip(grads, again, ref):
        assert torch.equal(g, g2)
        assert ulp_err(g, r, torch.float16) <= 2.0


@pytest.mark.cuda
def test_flash_autograd_function_on_the_card(cuda_device):
    """gradients through FlashAttention (B1 forward + B2 backward) equal
    autograd of the plain forward, and no_grad saves nothing."""
    q, k, v = (_normal((2, 256, 4, 64), cuda_device, torch.float32, s).requires_grad_(True)
               for s in (8, 9, 10))
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = torch.autograd.grad(fa.flash_attention_ref(q, k, v, True)[0].square().sum(), (q, k, v))
    for g, r in zip(grads, ref):
        assert (g - r).abs().max().item() <= 5e-5 * r.abs().max().item()
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None


@pytest.mark.cuda
def test_flash_autograd_function_bf16_on_the_card(cuda_device):
    """bf16 gradients through FlashAttention take the tensor-core backward
    (one launch of each _tc kernel, none of the 3xTF32 dq / dk/dv) and
    equal autograd of the plain fp32 forward on the same bf16 inputs to
    2e-2 of the largest entry (both round the gradients to bf16)."""
    q, k, v = (_normal((2, 256, 4, 64), cuda_device, torch.bfloat16, s).requires_grad_(True)
               for s in (8, 9, 10))
    before = _bwd_counts()
    out = fa.flash_attention(q, k, v, causal=True)
    cot = _normal(out.shape, cuda_device, torch.bfloat16, 11)
    grads = torch.autograd.grad(out, (q, k, v), cot)
    torch.cuda.synchronize()
    after = _bwd_counts()
    assert {c: after[c] - before[c] for c in _BWD_COUNTERS} == {
        "bwd_delta_launches": 1, "bwd_dq_tf32_launches": 0, "bwd_dkv_tf32_launches": 0,
        "bwd_dq_tc_launches": 1, "bwd_dkv_tc_launches": 1}
    q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    ref = torch.autograd.grad(fa.flash_attention_ref(q32, k32, v32, True)[0], (q32, k32, v32),
                              cot.float())
    for g, r in zip(grads, ref):
        assert g.dtype == torch.bfloat16
        assert (g.float() - r).abs().max().item() <= 2e-2 * r.abs().max().item()


def _paged_inputs(device, dtype, bits, B, H, pages, pool, seed, Dh=64):
    """q, one layer's pools (+ scales), scattered tables, and lengths
    {0, 1, 63, 64, 65, full} at page size 64."""
    ps = 64
    rng = np.random.default_rng(seed)
    q = _normal((B, 1, H, Dh), device, dtype, seed)
    tables = np.zeros((B, pages), np.int32)
    ids = rng.permutation(np.arange(1, pool))
    lens = [0, 1, 63, 64, 65, pages * ps] + [pages * ps // 2] * (B - 6)
    for b, n in enumerate(lens):
        used = -(-n // ps)
        tables[b, :used] = ids[:used]
        ids = np.roll(ids, -used)
    t = {"tables": torch.from_numpy(tables).to(device),
         "lengths": torch.tensor(lens, dtype=torch.int32, device=device)}
    if bits is None:
        k = _normal((H, pool, ps, Dh), device, dtype, seed + 1)
        v = _normal((H, pool, ps, Dh), device, dtype, seed + 2)
        return q, k, v, None, None, t
    dq = Dh // 2 if bits == 4 else Dh
    k = torch.from_numpy(rng.integers(-128, 128, (H, pool, ps, dq)).astype(np.int8)).to(device)
    v = torch.from_numpy(rng.integers(-128, 128, (H, pool, ps, dq)).astype(np.int8)).to(device)
    ks = torch.from_numpy(rng.uniform(0.001, 0.02, (H, pool)).astype(np.float32)).to(device)
    vs = torch.from_numpy(rng.uniform(0.001, 0.02, (H, pool)).astype(np.float32)).to(device)
    return q, k, v, ks, vs, t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLERANCES)
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
@pytest.mark.parametrize("pages,pool", [(8, 17), (16, 257)])
@pytest.mark.parametrize("Dh", [64, pytest.param(96, id="d96"), 128])
def test_paged_kernel_matches_plain(cuda_device, dtype, atol, bits, pages, pool, Dh):
    """B4 (dense pools) and B4q (int8, int4) at the serving shape (8 slots,
    H12, page 64, 8 pages per row, pool 17) and a long one (16 pages per
    row, pool 257), Dh 64 / 96 / 128, against the gather + plain softmax
    version."""
    counter = {None: "paged_launches", 8: "paged_kv8_launches", 4: "paged_kv4_launches"}[bits]
    q, k, v, ks, vs, t = _paged_inputs(cuda_device, dtype, bits, 8, 12, pages, pool, 11, Dh)
    before = getattr(da, counter)
    out, again = (da.paged_decode_attention(q, k, v, t["lengths"], t["tables"], k_scales=ks,
                                            v_scales=vs) for _ in range(2))
    torch.cuda.synchronize()
    assert getattr(da, counter) == before + 2
    ref = da.paged_decode_attention(q, k, v, t["lengths"], t["tables"], impl="gather",
                                    k_scales=ks, v_scales=vs)
    assert getattr(da, counter) == before + 2
    assert out.dtype == dtype and torch.count_nonzero(out[0]) == 0  # the length-0 row
    assert torch.equal(out, again)  # the split's merge runs in split order
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLERANCES + [(torch.float16, 2e-2)])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
@pytest.mark.parametrize("Dh", [64, pytest.param(96, id="d96")])
def test_paged_kernel_splits_inside_a_page(cuda_device, dtype, atol, bits, Dh):
    """B4 over pages of 128 at 16 slots and 4 pages a row (phase 8b's
    table): 3 splits of 192 positions, so split 1 starts inside page 1;
    lengths in one split (1, 191, 192), across a page inside a split (129),
    across splits (193, 300) and the capacity; bitwise on a re-run."""
    B, H, ps, pages, pool = 16, 12, 128, 4, 65
    assert da.split_plan(B * H, pages * ps, 132) == (3, 192)
    rng = np.random.default_rng(31)
    lens = [0, 1, 127, 128, 129, 191, 192, 193, 255, 256, 300, 383, 384, 385, 500, 512]
    tables = np.stack([rng.permutation(np.arange(1, pool))[:pages] for _ in lens]).astype(np.int32)
    q = _normal((B, 1, H, Dh), cuda_device, dtype, 32)
    if bits is None:
        k, v = (_normal((H, pool, ps, Dh), cuda_device, dtype, s) for s in (33, 34))
        ks = vs = None
    else:
        dq = Dh // 2 if bits == 4 else Dh
        k, v = (torch.from_numpy(rng.integers(-128, 128, (H, pool, ps, dq)).astype(np.int8))
                .to(cuda_device) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.001, 0.02, (H, pool)).astype(np.float32))
                  .to(cuda_device) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    tables = torch.from_numpy(tables).to(cuda_device)
    out, again = (da.paged_decode_attention(q, k, v, lengths, tables, k_scales=ks, v_scales=vs)
                  for _ in range(2))
    ref = da.paged_decode_attention(q, k, v, lengths, tables, impl="gather", k_scales=ks,
                                    v_scales=vs)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[0]) == 0 and torch.equal(out, again)
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLERANCES)
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
@pytest.mark.parametrize("W", [1, 2, 5, 16, 17])
@pytest.mark.parametrize("Dh", [64, pytest.param(96, id="d96"), 128])
def test_verify_kernel_matches_plain(cuda_device, dtype, atol, bits, W, Dh):
    """B5 (split over the pages: 4 splits of 128) at the serving shape (8
    slots, H12, page 64, 8 pages per row, pool 17), Dh 64 / 96 / 128, with q
    and the window as strided views of one fused qkv buffer, against the
    plain version on the committable positions (the plain version drops
    window positions past the table, the kernel attends them); a second run
    is bitwise equal."""
    counter = {None: "verify_launches", 8: "verify_kv8_launches",
               4: "verify_kv4_launches"}[bits]
    B, H, ps, pages = 8, 12, 64, 8
    _, k, v, ks, vs, t = _paged_inputs(cuda_device, dtype, bits, B, H, pages, 17, 12, Dh)
    qkv = _normal((B, W, 3 * H * Dh), cuda_device, dtype, 13)
    q, wk, wv = (x.reshape(B, W, H, Dh) for x in qkv.split(H * Dh, dim=-1))
    before = getattr(da, counter)
    out = da.paged_verify_attention(q, k, v, t["lengths"], t["tables"], wk, wv, k_scales=ks,
                                    v_scales=vs)
    again = da.paged_verify_attention(q, k, v, t["lengths"], t["tables"], wk, wv, k_scales=ks,
                                      v_scales=vs)
    torch.cuda.synchronize()
    assert getattr(da, counter) == before + 2
    ref = da.paged_verify_attention(q, k, v, t["lengths"], t["tables"], wk, wv, impl="gather",
                                    k_scales=ks, v_scales=vs)
    assert getattr(da, counter) == before + 2
    keep = (t["lengths"][:, None] + torch.arange(W, device=cuda_device)) < pages * ps
    assert out.dtype == dtype and torch.equal(out, again)
    assert (out[keep].float() - ref[keep].float()).abs().max().item() <= atol
    with pytest.raises(ValueError, match="window"):
        da.paged_verify_attention(q.new_zeros(B, 18, H, Dh), k, v, t["lengths"], t["tables"],
                                  q.new_zeros(B, 18, H, Dh), q.new_zeros(B, 18, H, Dh),
                                  k_scales=ks, v_scales=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
@pytest.mark.parametrize("W", [2, 5, 17])
@pytest.mark.parametrize("Dh", [64, pytest.param(96, id="d96")])
def test_verify_kernel_16bit_within_two_ulps_of_the_fp32_function(cuda_device, dtype, bits, W,
                                                                  Dh):
    """B5 on the tensor cores (mma.sync, P as hi + lo halves): within 2 ulps
    of its dtype of the fp32 function (the plain version on the same inputs
    widened to fp32) on the committable entries of at least 1e-3 of the
    largest, as B1 is; bitwise on a re-run."""
    B, H, ps, pages = 8, 12, 64, 8
    _, k, v, ks, vs, t = _paged_inputs(cuda_device, dtype, bits, B, H, pages, 17, 21, Dh)
    qkv = _normal((B, W, 3 * H * Dh), cuda_device, dtype, 22)
    q, wk, wv = (x.reshape(B, W, H, Dh) for x in qkv.split(H * Dh, dim=-1))
    out = da.paged_verify_attention(q, k, v, t["lengths"], t["tables"], wk, wv, k_scales=ks,
                                    v_scales=vs)
    again = da.paged_verify_attention(q, k, v, t["lengths"], t["tables"], wk, wv, k_scales=ks,
                                      v_scales=vs)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    pools = (k, v) if bits is not None else (k.float(), v.float())
    ref = da.paged_verify_attention(q.float(), *pools, t["lengths"], t["tables"], wk.float(),
                                    wv.float(), impl="gather", k_scales=ks, v_scales=vs)
    keep = (t["lengths"][:, None] + torch.arange(W, device=cuda_device)) < pages * ps
    assert ulp_err(out[keep], ref[keep], dtype) <= 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged", "verify"])
def test_int4_nibble_order_at_d96_on_the_card(cuda_device, kernel):
    """At Dh 96 a lane's output dims straddle the two nibbles of a byte (dim
    d < 48 is byte d's low nibble, d >= 48 byte d - 48's high one): B4 and
    B5 over an int4 pool equal the dense formula over the pool unpacked by
    unpack_kv_int4 and scaled (fp32, 5e-5)."""
    B, H, Dh, ps, pages = 8, 4, 96, 64, 8
    q, k, v, ks, vs, t = _paged_inputs(cuda_device, torch.float32, 4, B, H, pages, 17, 23, Dh)
    tables = t["tables"].long()
    dense = [(da.unpack_kv_int4(p) * s[:, :, None, None]) for p, s in ((k, ks), (v, vs))]
    if kernel == "paged":
        out = da.paged_decode_attention(q, k, v, t["lengths"], t["tables"], k_scales=ks,
                                        v_scales=vs)
        kc, vc = (da.gather_pages(d, None, tables, Dh) for d in dense)
        ref = da.decode_attention_ref(q, kc, vc, t["lengths"])
    else:
        wk, wv = (_normal((B, 3, H, Dh), cuda_device, torch.float32, s) for s in (24, 25))
        q3 = _normal((B, 3, H, Dh), cuda_device, torch.float32, 26)
        out = da.paged_verify_attention(q3, k, v, t["lengths"], t["tables"], wk, wv,
                                        k_scales=ks, v_scales=vs)
        ref = da.paged_verify_attention(q3, *dense, t["lengths"], t["tables"], wk, wv,
                                        impl="gather")
        keep = (t["lengths"][:, None] + torch.arange(3, device=cuda_device)) < pages * ps
        out, ref = out[keep], ref[keep]
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 5e-5


# the launch counter of each B6 / B7 route
_QMM_COUNTER = {"cuda_cores": "int{bits}_launches", "tensor_cores": "int{bits}_tc_launches",
                "decode": "int{bits}_dec_launches"}


def _quantized(D, F, group, bits, device, seed):
    from deepspeed_tpu_torch.ops.quantizer import quantize

    w = _normal((D, F), device, torch.float32, seed)
    q, s = quantize(w, bits=bits, num_groups=D * F // group)
    return (im.pack_int4(q) if bits == 4 else q), s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 5e-5), (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-2)])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("M,D,F,group", [(1, 768, 2304, 128), (4, 768, 768, 128),
                                         (8, 768, 3072, 128), (8, 3072, 768, 128),
                                         (8, 1024, 3072, 128), (8, 1024, 1024, 128),
                                         (64, 1024, 4096, 128), (8, 4096, 1024, 128),
                                         (256, 768, 2304, 128),
                                         (2, 128, 256, 64), (2, 320, 960, 128),
                                         (3, 100, 30, 10)])
def test_quantized_matmul_kernels_match_plain(cuda_device, dtype, rtol, bits, M, D, F, group):
    """B6 (int8) and B7 (int4) against their plain versions, at GPT-2-125M's
    and gpt2-350m's projection shapes, group 64, a group that crosses rows
    and an odd packed width, through the route's kernel (x at 64 and 256
    rows on the tensor cores, at 1-8 rows in the preset layouts on the
    decode kernel); bitwise equal over two runs. Tolerance relative
    to the largest output entry: fp32, both accumulate in fp32 in another
    order; bf16/fp16, both round the output once."""
    q, s = _quantized(D, F, group, bits, cuda_device, 12)
    x = _normal((M, D), cuda_device, dtype, 13)
    fn, ref_fn = ((im.int4_matmul, im.int4_matmul_ref) if bits == 4
                  else (im.int8_matmul, im.int8_matmul_ref))
    route = im.qmm_route(M, dtype, D, F, group, bits)
    counter = _QMM_COUNTER[route].format(bits=bits)
    before = getattr(im, counter)
    out, again = fn(x, q, s, group), fn(x, q, s, group)
    torch.cuda.synchronize()
    assert getattr(im, counter) == before + 2
    ref = ref_fn(x, q, s, group)
    assert out.dtype == dtype and out.shape == (M, F) and torch.equal(out, again)
    scale = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= rtol * scale


_QMM_COUNTERS = ("int8_launches", "int4_launches", "int8_tc_launches", "int4_tc_launches",
                 "int8_dec_launches", "int4_dec_launches")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("group", [128, 64])
@pytest.mark.parametrize("M,D,F", [(16, 768, 2304), (40, 768, 768), (64, 3072, 768),
                                   (100, 1024, 4096), (256, 768, 3072), (256, 4096, 1024),
                                   (9, 1024, 3072)])
def test_qmatmul_tc_kernel_within_two_ulps_and_rerun_bitwise(cuda_device, dtype, bits, group, M,
                                                             D, F):
    """B6 / B7 on the tensor cores (bf16 / fp16 x above the crossover rows)
    against the fp32 plain version: at most 2 ulps of the dtype on the
    entries of at least 1e-3 of the largest (the hi/lo split keeps the fp32
    function to ~2^-16), bitwise equal over two runs, two tensor-core
    launches and no other."""
    q, s = _quantized(D, F, group, bits, cuda_device, 16)
    s = s * 0.02  # GPT-2's weight magnitudes: fp16's lo half needs its panel scale
    x = _normal((M, D), cuda_device, dtype, 17)
    assert im.qmm_route(M, dtype, D, F, group, bits) == "tensor_cores"
    fn, ref_fn = ((im.int4_matmul, im.int4_matmul_ref) if bits == 4
                  else (im.int8_matmul, im.int8_matmul_ref))
    before = {c: getattr(im, c) for c in _QMM_COUNTERS}
    out, again = fn(x, q, s, group), fn(x, q, s, group)
    torch.cuda.synchronize()
    assert _moved(before, {c: getattr(im, c) for c in _QMM_COUNTERS}) == {
        f"int{bits}_tc_launches": 2}
    assert out.dtype == dtype and out.shape == (M, F) and torch.equal(out, again)
    assert ulp_err(out, ref_fn(x.float(), q, s, group), dtype) <= 2


_QMM_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768), (1024, 3072), (1024, 1024),
               (1024, 4096), (4096, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("group", [128, 64])
@pytest.mark.parametrize("M", [16, 64, 256])
@pytest.mark.parametrize("D,F", _QMM_SHAPES, ids=[f"{d}x{f}" for d, f in _QMM_SHAPES])
def test_qmatmul_tc_fp32_kernel_matches_plain(cuda_device, D, F, M, group, bits):
    """B6 / B7 with fp32 x on the tensor cores (x times each group's scales
    as three exact bf16 parts against the exact integers) at the 8
    projection shapes of GPT-2-125M and gpt2-350m: within 5e-5 of the
    largest output of the fp32 plain version (both fp32-accurate products of
    the same function, rounded at other places), bitwise equal over two
    runs, two tensor-core launches and no other."""
    q, s = _quantized(D, F, group, bits, cuda_device, 20)
    s = s * 0.02  # GPT-2's weight magnitudes
    x = _normal((M, D), cuda_device, torch.float32, 21)
    assert im.qmm_route(M, torch.float32, D, F, group, bits) == "tensor_cores"
    fn, ref_fn = ((im.int4_matmul, im.int4_matmul_ref) if bits == 4
                  else (im.int8_matmul, im.int8_matmul_ref))
    before = {c: getattr(im, c) for c in _QMM_COUNTERS}
    out, again = fn(x, q, s, group), fn(x, q, s, group)
    torch.cuda.synchronize()
    assert _moved(before, {c: getattr(im, c) for c in _QMM_COUNTERS}) == {
        f"int{bits}_tc_launches": 2}
    assert out.dtype == torch.float32 and out.shape == (M, F) and torch.equal(out, again)
    ref = ref_fn(x, q, s, group)
    assert (out - ref).abs().max().item() <= 5e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("M,dtype,D,F,group,route", [
    (8, torch.bfloat16, 768, 3072, 128, "decode"),
    (4, torch.float32, 768, 768, 32, "cuda_cores"),
    (9, torch.bfloat16, 768, 3072, 128, "tensor_cores"),
    (64, torch.float32, 768, 3072, 128, "tensor_cores"),
    (40, torch.bfloat16, 320, 960, 128, "cuda_cores"),
    (40, torch.float16, 768, 960, 64, "tensor_cores")])
def test_qmatmul_routes_by_rows_dtype_and_layout(cuda_device, M, dtype, D, F, group, route):
    """The wrapper launches the kernel qmm_route names, once, and it agrees
    with the plain version; a layout with F % 64 == 64 takes the
    tensor-core kernel with its second panel empty."""
    q, s = _quantized(D, F, group, 8, cuda_device, 18)
    x = _normal((M, D), cuda_device, dtype, 19)
    assert im.qmm_route(M, dtype, D, F, group, 8) == route
    before = {c: getattr(im, c) for c in _QMM_COUNTERS}
    out = im.int8_matmul(x, q, s, group)
    torch.cuda.synchronize()
    counter = _QMM_COUNTER[route].format(bits=8)
    assert _moved(before, {c: getattr(im, c) for c in _QMM_COUNTERS}) == {counter: 1}
    ref = im.int8_matmul_ref(x, q, s, group)
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("group", [128, 64])
@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("D,F", _QMM_SHAPES, ids=[f"{d}x{f}" for d, f in _QMM_SHAPES])
def test_qmatmul_decode_kernel_holds_its_bars(cuda_device, D, F, M, group, bits, dtype):
    """B6 / B7's decode kernel (1-8 rows on mma.sync, x s as three exact
    bf16 parts against the exact integers) at the 8 projection shapes of
    GPT-2-125M and gpt2-350m: fp32 within 5e-5 of the largest output of the
    fp32 plain version and 1e-5 of the float64 product's; bf16 / fp16 at most
    2 ulps of the dtype of the fp32 plain version on the entries of at least
    1e-3 of the largest; bitwise equal over two runs, two decode launches
    and no other."""
    q, s = _quantized(D, F, group, bits, cuda_device, 30 + M)
    s = s * 0.02  # GPT-2's weight magnitudes
    x = _normal((M, D), cuda_device, dtype, 31 + M)
    assert im.qmm_route(M, dtype, D, F, group, bits) == "decode"
    fn, ref_fn = ((im.int4_matmul, im.int4_matmul_ref) if bits == 4
                  else (im.int8_matmul, im.int8_matmul_ref))
    before = {c: getattr(im, c) for c in _QMM_COUNTERS}
    out, again = fn(x, q, s, group), fn(x, q, s, group)
    torch.cuda.synchronize()
    assert _moved(before, {c: getattr(im, c) for c in _QMM_COUNTERS}) == {
        f"int{bits}_dec_launches": 2}
    assert out.dtype == dtype and out.shape == (M, F) and torch.equal(out, again)
    ref = ref_fn(x.float(), q, s, group)
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 5e-5 * ref.abs().max().item()
        wq = im.unpack_int4(q) if bits == 4 else q
        exact = x.double() @ (wq.double().reshape(-1, group)
                              * s.double().reshape(-1, 1)).reshape(D, F)
        assert (out.double() - exact).abs().max().item() <= 1e-5 * exact.abs().max().item()
    else:
        assert ulp_err(out, ref, dtype) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decode-int8", "decode-int4", "tc64-int8", "tc64-int4",
                                  "b8-block256", "b8-block96", "b8-block256-rows32",
                                  "b8-block96-rows32"])
def test_fp32_accumulators_at_gpt_neox_d6144(cuda_device, case):
    """The tensor-core kernels' fp32 accumulators truncate, so their error
    grows with D: at gpt-neox-20b's width (D 6144, random weights at GPT-2's
    scale) the decode kernel (8 rows), the fp32 tensor-core B6 / B7 (64
    rows) and B8 (256 and 32 rows at blocks of 256 and 96, promoted into
    fp32 sums every 256 rows of D: ``dqm_promotes``) stay within 1e-5 of the
    largest entry of the float64 product. Prints the error (``-s``)."""
    from deepspeed_tpu_torch.comm.quantized import quantize_blockwise
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    D, F = 6144, 6144
    kind, arg, *rows = case.split("-")
    if kind == "b8":
        block, M = int(arg[len("block"):]), int(rows[0][len("rows"):]) if rows else 256
        q, s, z = quantize_blockwise(_normal((D, F), cuda_device, torch.float32, 40) * 0.02,
                                     bits=8, block_size=block)
        x = _normal((M, D), cuda_device, torch.float32, 41)
        assert dqm.dqm_route(M, D, q.shape[1], s.shape[1]) == "tensor_cores"
        out = dqm.dequant_matmul(x, q, s, z, orig_size=F)
        w = (q.double() * s.double().repeat_interleave(block, 1)
             + z.double().repeat_interleave(block, 1))[:, :F]
    else:
        bits, M = int(arg[3:]), 8 if kind == "decode" else 64
        q, s = _quantized(D, F, 128, bits, cuda_device, 42)
        s = s * 0.02
        x = _normal((M, D), cuda_device, torch.float32, 43)
        route = im.qmm_route(M, torch.float32, D, F, 128, bits)
        assert route == ("decode" if kind == "decode" else "tensor_cores")
        out = (im.int4_matmul if bits == 4 else im.int8_matmul)(x, q, s, 128)
        wq = im.unpack_int4(q) if bits == 4 else q
        w = (wq.double().reshape(-1, 128) * s.double().reshape(-1, 1)).reshape(D, F)
    exact = x.double() @ w
    rel = (out.double() - exact).abs().max().item() / exact.abs().max().item()
    print(f"D6144 {case}: {rel:.3e} of the largest entry of the float64 product")
    assert rel <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decode-int8", "decode-int4", "tc64-int8", "tc64-int4"])
def test_fp32_accumulators_at_gpt_neox_mlp_down_d24576(cuda_device, case):
    """gpt-neox-20b's mlp_down (D 24576, F 6144, random weights at GPT-2's
    scale), the widest D of the presets: the decode kernel (8 rows) and the
    fp32 tensor-core B6 / B7 (64 rows, whose accumulators are promoted into
    fp32 sums every 256 rows of D) stay within 1e-5 of the largest entry of
    the float64 product. Prints the error (``-s``)."""
    D, F = 24576, 6144
    kind, arg = case.split("-")
    bits, M = int(arg[3:]), 8 if kind == "decode" else 64
    q, s = _quantized(D, F, 128, bits, cuda_device, 44)
    s = s * 0.02
    x = _normal((M, D), cuda_device, torch.float32, 45)
    route = im.qmm_route(M, torch.float32, D, F, 128, bits)
    assert route == ("decode" if kind == "decode" else "tensor_cores")
    out = (im.int4_matmul if bits == 4 else im.int8_matmul)(x, q, s, 128)
    wq = im.unpack_int4(q) if bits == 4 else q
    exact = x.double() @ (wq.double().reshape(-1, 128) * s.double().reshape(-1, 1)).reshape(D, F)
    rel = (out.double() - exact).abs().max().item() / exact.abs().max().item()
    print(f"D24576 {case}: {rel:.3e} of the largest entry of the float64 product")
    assert rel <= 1e-5


@pytest.mark.cuda
def test_quantized_matmul_takes_the_dequantize_route_past_256_rows(cuda_device):
    """Prefill-sized x (M > 256) is the reference's dequantize-then-matmul, no launch."""
    q, s = _quantized(256, 512, 128, 8, cuda_device, 14)
    x = _normal((300, 256), cuda_device, torch.float32, 15)
    before = im.int8_launches
    out = im.int8_matmul(x, q, s, 128)
    assert im.int8_launches == before
    torch.testing.assert_close(out, im.int8_matmul_ref(x, q, s, 128), atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 5e-5), (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-2)])
@pytest.mark.parametrize("M,D,F,block", [(256, 768, 50304, 256), (1, 768, 2304, 256),
                                         (37, 768, 3072, 256), (64, 64, 96, 256),
                                         (130, 256, 520, 128), (8, 768, 2304, 256),
                                         (5, 100, 301, 64), (128, 768, 2304, 256),
                                         (70, 128, 600, 512)])
def test_dequant_matmul_kernel_matches_plain(cuda_device, dtype, rtol, M, D, F, block):
    """B8 against its plain version, each case on the tensor cores
    (``dqm_route``): the LM head's vocabulary padded to whole blocks and
    trimmed, M = 1 and 37, an effective block of 96, a block of 128, the qkv
    leaf, a ragged 70-row block of 512, ragged D and F; bitwise equal over
    two runs.
    Tolerance relative to the largest output entry: fp32, both accumulate in
    fp32 in another order; bf16/fp16, both round the output once."""
    from deepspeed_tpu_torch.comm.quantized import quantize_blockwise
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    q, s, z = quantize_blockwise(_normal((D, F), cuda_device, torch.float32, 16) * 0.02,
                                 bits=8, block_size=block)
    x = _normal((M, D), cuda_device, dtype, 17)
    assert dqm.dqm_route(M, D, q.shape[1], s.shape[1]) == "tensor_cores"
    before = dqm.tc_launches
    out, again = (dqm.dequant_matmul(x, q, s, z, orig_size=F) for _ in range(2))
    torch.cuda.synchronize()
    assert dqm.tc_launches - before == 2
    ref = dqm.dequant_matmul_ref(x, q, s, z, orig_size=F)
    assert out.dtype == dtype and out.shape == (M, F) and torch.equal(out, again)
    scale = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= rtol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("M", [64, 256])
def test_dequant_matmul_routes_against_float64(cuda_device, M):
    """At the LM head's width (D 768, vocabulary 50304 in blocks of 256) the
    tensor-core kernel (three bf16 parts of x s, exact q, the zero-point side
    product) and the plain fp32 version (each weight rounded to fp32 first)
    on the same fp32 inputs: both within 1e-5 of the largest entry of the
    float64 product over the unrounded weights q s + z."""
    from deepspeed_tpu_torch.comm.quantized import quantize_blockwise
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    D, F = 768, 50304
    q, s, z = quantize_blockwise(_normal((D, F), cuda_device, torch.float32, 18) * 0.02, bits=8)
    x = _normal((M, D), cuda_device, torch.float32, 19)
    assert dqm.dqm_route(M, D, q.shape[1], s.shape[1]) == "tensor_cores"
    tc = dqm._launch(x, q, s, z, F)
    plain = dqm.dequant_matmul_ref(x, q, s, z, orig_size=F)
    block = q.shape[1] // s.shape[1]
    w = (q.double() * s.double().repeat_interleave(block, 1)
         + z.double().repeat_interleave(block, 1))[:, :F]
    exact = x.double() @ w
    top = exact.abs().max().item()
    for out in (tc, plain):
        assert (out.double() - exact).abs().max().item() <= 1e-5 * top


@pytest.mark.cuda
@pytest.mark.parametrize("M,block", [(32, 256), (1, 256), (63, 256), (256, 64), (256, 128),
                                     (4096, 64), (4096, 128), (32, 128), (1, 64),
                                     (32, 96), (4096, 96), (1, 8), (256, 8), (37, 48),
                                     (256, 48), (32, 160), (200, 160), (63, 250), (4096, 250)],
                         ids=["9d-M32", "M1", "M63", "M256-block64", "M256-block128",
                              "M4096-block64", "M4096-block128", "M32-block128", "M1-block64",
                              "9d-M32-block96", "M4096-block96", "M1-block8", "M256-block8",
                              "M37-block48", "M256-block48", "M32-block160", "M200-block160",
                              "M63-block250", "M4096-block250"])
def test_dequant_matmul_tc_new_shapes(cuda_device, M, block):
    """B8 on the tensor cores at the shapes its route newly takes, at the LM
    head's width (D 768, vocabulary 50304): fewer than 64 rows (9d's 32, one,
    63; the 64-row tiling), scale blocks of 64 and 128 (the narrower tiles)
    and blocks off 64-column panels (8, 48, 96, 160, 250: padded to whole
    panels). Two tensor-core launches; within 5e-5 of
    the largest output of the plain version and 1e-5 of the float64 product
    over the unrounded weights; bitwise equal over two runs."""
    from deepspeed_tpu_torch.comm.quantized import quantize_blockwise

    D, F = 768, 50304
    q, s, z = quantize_blockwise(_normal((D, F), cuda_device, torch.float32, 22) * 0.02, bits=8,
                                 block_size=block)
    _hold_b8_to_its_bars(_normal((M, D), cuda_device, torch.float32, 23), q, s, z, F)


def _hold_b8_to_its_bars(x, q, s, z, F):
    """Two tensor-core launches of B8, bitwise equal; within 5e-5 (fp32) /
    2e-2 (bf16, fp16) of the largest output of the plain version, and fp32
    within 1e-5 of the largest entry of the float64 product over the
    unrounded weights."""
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    M, block = x.shape[0], q.shape[1] // s.shape[1]
    assert dqm.dqm_route(M, x.shape[1], q.shape[1], s.shape[1]) == "tensor_cores"
    before = dqm.tc_launches
    out, again = (dqm.dequant_matmul(x, q, s, z, orig_size=F) for _ in range(2))
    torch.cuda.synchronize()
    assert dqm.tc_launches - before == 2
    assert out.shape == (M, F) and out.dtype == x.dtype and torch.equal(out, again)
    ref = dqm.dequant_matmul_ref(x, q, s, z, orig_size=F).float()
    rtol = 5e-5 if x.dtype == torch.float32 else 2e-2
    assert (out.float() - ref).abs().max().item() <= rtol * ref.abs().max().item()
    if x.dtype == torch.float32:
        w = (q.double() * s.double().repeat_interleave(block, 1)
             + z.double().repeat_interleave(block, 1))[:, :F]
        exact = x.double() @ w
        assert (out.double() - exact).abs().max().item() <= 1e-5 * exact.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,F,block,dtype", [
    (32, 480, 50304, 256, torch.float32), (256, 480, 1920, 96, torch.bfloat16),
    (100, 300, 1000, 256, torch.float32), (7, 100, 3000, 96, torch.bfloat16),
    (200, 333, 2304, 256, torch.float16), (4096, 200, 2304, 256, torch.float32),
    (5, 70, 1000, 250, torch.float32)],
    ids=["D480", "D480-block96-bf16", "D300", "D100-block96-bf16", "D333-fp16", "M4096-D200",
         "D70-block250"])
def test_dequant_matmul_tc_ragged_d(cuda_device, M, D, F, block, dtype):
    """B8 on the tensor cores where D is off 64-row steps (the last step
    zero-filled past D; rows of x or q off 16 bytes copied by the wrapper),
    held to its bars (``_hold_b8_to_its_bars``)."""
    from deepspeed_tpu_torch.comm.quantized import quantize_blockwise

    q, s, z = quantize_blockwise(_normal((D, F), cuda_device, torch.float32, 24) * 0.02,
                                 bits=8, block_size=block)
    _hold_b8_to_its_bars(_normal((M, D), cuda_device, dtype, 25), q, s, z, F)


@pytest.mark.cuda
@pytest.mark.parametrize("D,F,block", [(768, 50304, 393), (200, 225, 75), (768, 3003, 3003)])
def test_dequant_matmul_raises_for_odd_blocks(cuda_device, D, F, block):
    """An odd block (no quantizer gives one) has no kernel: on a CUDA tensor
    the call raises and launches nothing."""
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    q = torch.randint(0, 256, (D, F), dtype=torch.uint8).to(cuda_device)
    s = torch.full((D, F // block), 1e-4, device=cuda_device)
    x = _normal((37, D), cuda_device, torch.float32, 26)
    assert dqm.dqm_route(37, D, F, F // block) == "none"
    before = dqm.tc_launches
    with pytest.raises(ValueError, match="even scale blocks"):
        dqm.dequant_matmul(x, q, s, -128 * s, orig_size=F)
    assert dqm.tc_launches == before


def _bs_layouts():
    """(name, layout [H, T/block, T/block], block, causal) for the B9 card
    cases: the sparse GPT's Fixed unidirectional layout, a bidirectional
    Fixed layout under causal (blocks above the diagonal skipped), BigBird
    with a layout per head, Variable / BSLongformer / LocalSlidingWindow at
    blocks 16 and 32, non-causal runs and a hand-made layout with an empty
    block row."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    H = 4
    empty = np.ones((H, 8, 8), np.int64)
    empty[:, 3] = 0
    return [
        ("fixed-uni-128", sa.FixedSparsityConfig(H, block=128, attention="unidirectional")
         .make_layout(1024), 128, True),
        ("fixed-bi-128-causal", sa.FixedSparsityConfig(H).make_layout(512), 128, True),
        ("bigbird-per-head-64", sa.BigBirdSparsityConfig(H, block=64,
                                                         different_layout_per_head=True)
         .make_layout(512), 64, True),
        ("variable-16", sa.VariableSparsityConfig(H, block=16, num_random_blocks=1,
                                                  different_layout_per_head=True)
         .make_layout(256), 16, True),
        ("longformer-32", sa.BSLongformerSparsityConfig(H, block=32).make_layout(256), 32,
         False),
        ("sliding-16", sa.LocalSlidingWindowSparsityConfig(H, block=16).make_layout(256), 16,
         True),
        ("sliding-32-noncausal", sa.LocalSlidingWindowSparsityConfig(
            H, block=32, attention="bidirectional").make_layout(256), 32, False),
        ("empty-row-32", empty, 32, False),
        # T off 64-token tiles: the backward's last tile holds rows past T
        ("sliding-16-t208", sa.LocalSlidingWindowSparsityConfig(H, block=16)
         .make_layout(208), 16, True),
    ]


# B9's counters by route ("tc": bf16 / fp16, "tf32": fp32): the forward's,
# and the backward's (dq, dk/dv)
_BS_FWD_COUNTERS = {"tc": "fwd_tc_launches", "tf32": "fwd_tf32_launches"}
_BS_BWD_COUNTERS = {"tc": ("bwd_dq_tc_launches", "bwd_dkv_tc_launches"),
                    "tf32": ("bwd_dq_tf32_launches", "bwd_dkv_tf32_launches")}


def _bs_counts(bs):
    names = [*_BS_FWD_COUNTERS.values(), *(c for cs in _BS_BWD_COUNTERS.values() for c in cs)]
    return {c: getattr(bs, c) for c in names}


def _bs_route_counts(bs, dtype, block, D):
    """The counters two forward and two backward runs move at ``dtype``,
    ``block`` and ``D`` (``bs_route`` of each pass)."""
    fwd = _BS_FWD_COUNTERS[bs.bs_route(dtype, block, D, "fwd")]
    return {fwd: 2, **dict.fromkeys(_BS_BWD_COUNTERS[bs.bs_route(dtype, block, D, "bwd")], 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 5e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D", [64, pytest.param(96, id="d96"), 128])
@pytest.mark.parametrize("case", range(9))
def test_blocksparse_kernels_match_plain_and_rerun_bitwise(cuda_device, dtype, rtol, D, case):
    """B9 (forward, dq with delta, dk/dv) vs the plain versions, with q/k/v
    read as views of one fused buffer, two forward and two backward runs
    giving bitwise-equal outputs (no atomics), each pass through its route's
    kernels (every pass on the tensor cores at every block: fp32 as 3xTF32,
    bf16 on 16-bit operands). fp32 o within 5e-5 of the largest entry of the
    plain version and of the CPU model of the 3xTF32 forward
    (``blocksparse_attention_fwd_tf32_ref``), bf16 o within 2 ulps of the
    fp32 function and of the split model on entries of at least 1e-3 of the
    largest; lse within 1e-4; gradients relative to the largest entry, fp32
    gradients also within 5e-5 of the CPU model of the 3xTF32 backward
    (``blocksparse_attention_bwd_tf32_ref``)."""
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

    _, layout, block, causal = _bs_layouts()[case]
    H, n = layout.shape[:2]
    T = n * block
    qkv = _normal((2, T, 3 * H * D), cuda_device, dtype, 20 + case)
    q, k, v = (t.reshape(2, T, H, D) for t in qkv.split(H * D, dim=-1))
    do = _normal((2, T, H, D), cuda_device, dtype, 40 + case)
    tables = bs.device_tables(layout, block, cuda_device)
    before = _bs_counts(bs)
    o, lse = bs.blocksparse_attention_fwd(q, k, v, layout, block, causal, tables=tables)
    o2, lse2 = bs.blocksparse_attention_fwd(q, k, v, layout, block, causal, tables=tables)
    grads = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal,
                                         tables=tables)
    again = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal,
                                         tables=tables)
    torch.cuda.synchronize()
    assert _moved(before, _bs_counts(bs)) == _bs_route_counts(bs, dtype, block, D)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_ref, lse_ref = bs.blocksparse_attention_fwd_ref(q, k, v, layout, block, causal)
    assert (o.float() - o_ref.float()).abs().max().item() <= (5e-5 if dtype == torch.float32
                                                              else 2e-2)
    if dtype == torch.float32:
        o_model, lse_model = bs.blocksparse_attention_fwd_tf32_ref(q, k, v, layout, block, causal)
        for ref in (o_ref, o_model):
            assert (o - ref).abs().max().item() <= 5e-5 * ref.abs().max().item()
        assert (lse - lse_model).abs().max().item() <= 1e-4
    else:
        o_split, _ = bs.blocksparse_attention_split_ref(q, k, v, layout, block, causal)
        assert ulp_err(o, o_ref, dtype) <= 2.0 and ulp_err(o, o_split, dtype) <= 2.0
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    scale = 1.0 / np.sqrt(D)
    dq_ref, delta = bs.blocksparse_attention_bwd_dq_ref(q, k, v, o, do, lse, layout, block,
                                                        causal, scale)
    ref = (dq_ref, *bs.blocksparse_attention_bwd_dkv_ref(q, k, v, do, lse, delta, layout, block,
                                                        causal, scale))
    for g, g2, r in zip(grads, again, ref):
        assert g.shape == r.shape and g.dtype == dtype
        assert torch.equal(g, g2)
        assert (g.float() - r.float()).abs().max().item() <= rtol * r.float().abs().max().item()
    if dtype == torch.float32:
        model = bs.blocksparse_attention_bwd_tf32_ref(q, k, v, o, lse, do, layout, block, causal)
        for g, m in zip(grads, model):
            assert (g - m).abs().max().item() <= rtol * m.abs().max().item()


@pytest.mark.cuda
def test_blocksparse_autograd_and_module_on_the_card(cuda_device):
    """gradients through SparseSelfAttention (B9 forward + dq + dk/dv) equal
    autograd of the plain forward; the tables are built once per T and kept
    on the card; no_grad saves nothing."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

    module = sa.SparseSelfAttention(sa.BigBirdSparsityConfig(
        4, block=32, attention="unidirectional", different_layout_per_head=True))
    q, k, v = (_normal((2, 256, 4, 64), cuda_device, torch.float32, s).requires_grad_(True)
               for s in (50, 51, 52))
    out = module(q, k, v)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    layout = module.get_layout(256)
    ref_out = bs.blocksparse_attention_fwd_ref(q, k, v, layout, 32, True)[0]
    ref = torch.autograd.grad(ref_out.square().sum(), (q, k, v))
    assert (out - ref_out).abs().max().item() <= 5e-5
    for g, r in zip(grads, ref):
        assert (g - r).abs().max().item() <= 5e-5 * r.abs().max().item()
    tables = sa.sparse_self_attention._tables(module.sparsity_config, 256, q.device)
    assert all(t.device == q.device for t in tables)
    assert sa.sparse_self_attention._tables(module.sparsity_config, 256, q.device) is tables
    with torch.no_grad():
        assert module(q, k, v).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("block,D", [(8, 64), (256, 64), (32, 32), (32, 80)])
def test_blocksparse_kernel_raises_for_unbuilt_shapes(cuda_device, block, D):
    """Blocks other than 16-128 and head dims other than 64 / 96 / 128 raise
    on the card; they never fall back to the plain version."""
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

    T = 2 * block
    q = _normal((1, T, 2, D), cuda_device, torch.float32, 60)
    layout = np.ones((2, 2, 2), np.int64)
    before = _bs_counts(bs)
    with pytest.raises(NotImplementedError, match="built for blocks"):
        bs.blocksparse_attention(q, q, q, layout, block)
    assert _bs_counts(bs) == before


def _bs_tc_layouts():
    """(name, layout, block, causal) of the tensor-core B9 card cases: the
    sparse GPT's Fixed unidirectional layout at blocks of 128 and 64,
    BigBird with a layout per head, BSLongformer not causal, a layout with
    an empty block row (head 1) and an empty block column (head 0); and at
    blocks of 16 and 32 (several blocks a 64-token tile, each entry tested
    against its sub-block's bit): Variable, BSLongformer not causal,
    LocalSlidingWindow at a T off 64-token tiles."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    H = 4
    empty = np.tril(np.ones((H, 8, 8), np.int64))
    empty[1, 3] = 0
    empty[0, :, 2] = 0
    return [
        ("fixed-uni-128", sa.FixedSparsityConfig(H, block=128, attention="unidirectional")
         .make_layout(1024), 128, True),
        ("fixed-uni-64", sa.FixedSparsityConfig(H, block=64, num_local_blocks=4,
                                                attention="unidirectional").make_layout(512),
         64, True),
        ("bigbird-per-head-64", sa.BigBirdSparsityConfig(H, block=64,
                                                         different_layout_per_head=True,
                                                         attention="unidirectional")
         .make_layout(512), 64, True),
        ("longformer-128-noncausal", sa.BSLongformerSparsityConfig(H, block=128)
         .make_layout(1024), 128, False),
        ("empty-row-col-128", empty, 128, True),
        ("variable-16", sa.VariableSparsityConfig(H, block=16, num_random_blocks=2,
                                                  local_window_blocks=[4],
                                                  attention="unidirectional")
         .make_layout(512), 16, True),
        ("longformer-32-noncausal", sa.BSLongformerSparsityConfig(
            H, block=32, num_sliding_window_blocks=5).make_layout(512), 32, False),
        ("sliding-32-t224", sa.LocalSlidingWindowSparsityConfig(
            H, block=32, num_sliding_window_blocks=4).make_layout(224), 32, True),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, pytest.param(96, id="d96"), 128])
@pytest.mark.parametrize("case", range(8))
def test_blocksparse_tc_kernels_within_two_ulps_and_rerun_bitwise(cuda_device, dtype, D, case):
    """B9 on the tensor cores (bf16 / fp16, every pass at every block): the
    forward, dq and dk/dv within 2 ulps of the dtype of the fp32 plain
    versions and of the split plain versions (the kernels' own rounding) on
    entries of at least 1e-3 of the largest, lse within 1e-4; a single cast
    of P more than 2 ulps off; the forward and the backward bitwise on a
    re-run; only the route's counters move. fp16 also runs with
    dO 2^-8 of unit scale, where dS lies below fp16's normal range unless the
    kernels scale its rows."""
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

    _, layout, block, causal = _bs_tc_layouts()[case]
    H, n = layout.shape[:2]
    T = n * block
    qkv = _normal((2, T, 3 * H * D), cuda_device, dtype, 70 + case)
    q, k, v = (t.reshape(2, T, H, D) for t in qkv.split(H * D, dim=-1))
    tables = bs.device_tables(layout, block, cuda_device)
    assert bs.bs_route(dtype, block, D, "fwd") == bs.bs_route(dtype, block, D, "bwd") == "tc"
    for do_scale in (1.0, 2.0**-8) if dtype == torch.float16 else (1.0,):
        do = _normal((2, T, H, D), cuda_device, dtype, 90 + case) * do_scale
        before = _bs_counts(bs)
        o, lse = bs.blocksparse_attention_fwd(q, k, v, layout, block, causal, tables=tables)
        o2, lse2 = bs.blocksparse_attention_fwd(q, k, v, layout, block, causal, tables=tables)
        grads = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal,
                                             tables=tables)
        again = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal,
                                             tables=tables)
        torch.cuda.synchronize()
        assert _moved(before, _bs_counts(bs)) == _bs_route_counts(bs, dtype, block, D)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        o_ref, lse_ref = bs.blocksparse_attention_fwd_ref(q, k, v, layout, block, causal)
        assert ulp_err(o, o_ref, dtype) <= 2.0
        assert (lse - lse_ref).abs().max().item() <= 1e-4
        o_split, lse_split = bs.blocksparse_attention_split_ref(q, k, v, layout, block, causal)
        assert ulp_err(o, o_split, dtype) <= 2.0
        assert (lse - lse_split).abs().max().item() <= 1e-4
        scale = 1.0 / np.sqrt(D)
        dq_ref, delta = bs.blocksparse_attention_bwd_dq_ref(q, k, v, o, do, lse, layout, block,
                                                            causal, scale)
        ref = (dq_ref, *bs.blocksparse_attention_bwd_dkv_ref(q, k, v, do, lse, delta, layout,
                                                            block, causal, scale))
        split = bs.blocksparse_attention_bwd_split_ref(q, k, v, o, lse, do, layout, block,
                                                       causal)
        for g, g2, r, m in zip(grads, again, ref, split):
            assert g.dtype == dtype and torch.equal(g, g2)
            assert ulp_err(g, r, dtype) <= 2.0
            assert ulp_err(g, m, dtype) <= 2.0
        p = bs._probs(q, k, lse, layout, block, causal, bs._scale(q, None))
        dv_cast = torch.einsum("bhts,bthd->bshd", p.to(dtype).float(), do.float()).to(dtype)
        assert ulp_err(dv_cast, ref[2], dtype) > 2.0
        if case == 4:  # the empty block row and column
            assert (o[:, 3 * block:4 * block, 1] == 0).all()
            assert (lse.view(2, H, T)[:, 1, 3 * block:4 * block] == -1e30).all()
            assert (grads[0][:, 3 * block:4 * block, 1] == 0).all()
            assert (grads[1][:, 2 * block:3 * block, 0] == 0).all()
            assert (grads[2][:, 2 * block:3 * block, 0] == 0).all()
