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

from _torch_ulps import ulp_err

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


_BWD_COUNTERS = ("bwd_delta_launches", "bwd_dq_launches", "bwd_dkv_launches",
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
                                          (100, 200, True, 64)])
def test_flash_backward_kernels_match_plain_and_rerun_bitwise(cuda_device, dtype, rtol, T, S,
                                                              causal, D):
    """B2 (delta, dq, dk/dv) vs its plain version, with q/k/v read as views of
    one fused buffer, and two runs giving bitwise-equal gradients (no atomics).
    Tolerance relative to the largest gradient entry. bf16 / fp16 take the
    tensor-core dq and dk/dv kernels (the _tc counters), fp32 the CUDA-core
    ones; bf16 / fp16 gradients are within 2 ulps of their dtype of the fp32
    plain version on entries of at least 1e-3 of the largest, where dV from
    a single cast of P is not."""
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
             else ("bwd_dq_launches", "bwd_dkv_launches"))
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


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
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
    (one launch of each _tc kernel, none of the CUDA-core dq / dk/dv) and
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
        "bwd_delta_launches": 1, "bwd_dq_launches": 0, "bwd_dkv_launches": 0,
        "bwd_dq_tc_launches": 1, "bwd_dkv_tc_launches": 1}
    q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    ref = torch.autograd.grad(fa.flash_attention_ref(q32, k32, v32, True)[0], (q32, k32, v32),
                              cot.float())
    for g, r in zip(grads, ref):
        assert g.dtype == torch.bfloat16
        assert (g.float() - r).abs().max().item() <= 2e-2 * r.abs().max().item()


def _paged_inputs(device, dtype, bits, B, H, pages, pool, seed):
    """q, one layer's pools (+ scales), scattered tables, and lengths
    {0, 1, 63, 64, 65, full} at page size 64."""
    Dh, ps = 64, 64
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
def test_paged_kernel_matches_plain(cuda_device, dtype, atol, bits, pages, pool):
    """B4 (dense pools) and B4q (int8, int4) at the serving shape (8 slots,
    H12, page 64, 8 pages per row, pool 17) and a long one (16 pages per
    row, pool 257), against the gather + plain softmax version."""
    counter = {None: "paged_launches", 8: "paged_kv8_launches", 4: "paged_kv4_launches"}[bits]
    q, k, v, ks, vs, t = _paged_inputs(cuda_device, dtype, bits, 8, 12, pages, pool, 11)
    before = getattr(da, counter)
    out = da.paged_decode_attention(q, k, v, t["lengths"], t["tables"], k_scales=ks,
                                    v_scales=vs)
    torch.cuda.synchronize()
    assert getattr(da, counter) == before + 1
    ref = da.paged_decode_attention(q, k, v, t["lengths"], t["tables"], impl="gather",
                                    k_scales=ks, v_scales=vs)
    assert getattr(da, counter) == before + 1
    assert out.dtype == dtype and torch.count_nonzero(out[0]) == 0  # the length-0 row
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLERANCES)
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "kv8", "kv4"])
@pytest.mark.parametrize("W", [1, 2, 5, 17])
def test_verify_kernel_matches_plain(cuda_device, dtype, atol, bits, W):
    """B5 at the serving shape (8 slots, H12, page 64, 8 pages per row, pool
    17) with q and the window as strided views of one fused qkv buffer,
    against the plain version on the committable positions (the plain
    version drops window positions past the table, the kernel attends
    them); a second run is bitwise equal."""
    counter = {None: "verify_launches", 8: "verify_kv8_launches",
               4: "verify_kv4_launches"}[bits]
    B, H, Dh, ps, pages = 8, 12, 64, 64, 8
    _, k, v, ks, vs, t = _paged_inputs(cuda_device, dtype, bits, B, H, pages, 17, 12)
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
    and an odd packed width; bitwise equal over two runs. Tolerance relative
    to the largest output entry: fp32, both accumulate in fp32 in another
    order; bf16/fp16, both round the output once."""
    q, s = _quantized(D, F, group, bits, cuda_device, 12)
    x = _normal((M, D), cuda_device, dtype, 13)
    fn, ref_fn = ((im.int4_matmul, im.int4_matmul_ref) if bits == 4
                  else (im.int8_matmul, im.int8_matmul_ref))
    counter = "int4_launches" if bits == 4 else "int8_launches"
    before = getattr(im, counter)
    out, again = fn(x, q, s, group), fn(x, q, s, group)
    torch.cuda.synchronize()
    assert getattr(im, counter) == before + 2
    ref = ref_fn(x, q, s, group)
    assert out.dtype == dtype and out.shape == (M, F) and torch.equal(out, again)
    scale = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= rtol * scale


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
                                         (5, 100, 301, 64)])
def test_dequant_matmul_kernel_matches_plain(cuda_device, dtype, rtol, M, D, F, block):
    """B8 against its plain version: the LM head's vocabulary padded to whole
    blocks and trimmed, M = 1 and 37, an effective block of 96, a block of
    128, the qkv leaf, ragged D and F; bitwise equal over two runs.
    Tolerance relative to the largest output entry: fp32, both accumulate in
    fp32 in another order; bf16/fp16, both round the output once."""
    from deepspeed_tpu_torch.comm.quantized import quantize_blockwise
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    q, s, z = quantize_blockwise(_normal((D, F), cuda_device, torch.float32, 16) * 0.02,
                                 bits=8, block_size=block)
    x = _normal((M, D), cuda_device, dtype, 17)
    before = dqm.launches
    out, again = (dqm.dequant_matmul(x, q, s, z, orig_size=F) for _ in range(2))
    torch.cuda.synchronize()
    assert dqm.launches == before + 2
    ref = dqm.dequant_matmul_ref(x, q, s, z, orig_size=F)
    assert out.dtype == dtype and out.shape == (M, F) and torch.equal(out, again)
    scale = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= rtol * scale


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
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 5e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", range(8))
def test_blocksparse_kernels_match_plain_and_rerun_bitwise(cuda_device, dtype, rtol, D, case):
    """B9 (forward, dq with delta, dk/dv) vs the plain versions, with q/k/v
    read as views of one fused buffer, and two backward runs giving
    bitwise-equal gradients (no atomics). o within the forward tolerances
    (fp32 5e-5, bf16 2e-2), lse within 1e-4, gradients relative to the
    largest entry."""
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

    _, layout, block, causal = _bs_layouts()[case]
    H, n = layout.shape[:2]
    T = n * block
    qkv = _normal((2, T, 3 * H * D), cuda_device, dtype, 20 + case)
    q, k, v = (t.reshape(2, T, H, D) for t in qkv.split(H * D, dim=-1))
    do = _normal((2, T, H, D), cuda_device, dtype, 40 + case)
    tables = bs.device_tables(layout, cuda_device)
    before = (bs.launches, bs.bwd_dq_launches, bs.bwd_dkv_launches)
    o, lse = bs.blocksparse_attention_fwd(q, k, v, layout, block, causal, tables=tables)
    grads = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal,
                                         tables=tables)
    again = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal,
                                         tables=tables)
    torch.cuda.synchronize()
    assert (bs.launches, bs.bwd_dq_launches, bs.bwd_dkv_launches) == (
        before[0] + 1, before[1] + 2, before[2] + 2)
    o_ref, lse_ref = bs.blocksparse_attention_fwd_ref(q, k, v, layout, block, causal)
    assert (o.float() - o_ref.float()).abs().max().item() <= (5e-5 if dtype == torch.float32
                                                              else 2e-2)
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
@pytest.mark.parametrize("block,D", [(8, 64), (256, 64), (32, 32), (32, 96)])
def test_blocksparse_kernel_raises_for_unbuilt_shapes(cuda_device, block, D):
    """Blocks other than 16-128 and head dims other than 64/128 raise on the
    card; they never fall back to the plain version."""
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

    T = 2 * block
    q = _normal((1, T, 2, D), cuda_device, torch.float32, 60)
    layout = np.ones((2, 2, 2), np.int64)
    before = bs.launches
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        bs.blocksparse_attention(q, q, q, layout, block)
    assert bs.launches == before
