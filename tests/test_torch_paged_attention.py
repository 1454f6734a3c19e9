"""The port's paged decode attention (B4: dense, int8 and int4 pools) vs the
JAX package's ``paged_decode_attention``: its Pallas kernel in interpret mode
(``impl="kernel"``) and its gather fallback (``impl="gather"``). The CUDA
kernel itself is held against the plain version on the card
(``test_torch_kernels.py`` and ``chip_smoke.py``).

Tolerances: fp32 dense pools 1e-6 (the Pallas kernel's online softmax over
pages vs one masked softmax, both fp32); bf16 2e-2 (both round the output
to bf16, a few ulps of O(1) values); int8/int4 pools 1e-5 (the same fp32
softmax over dequantized values that are up to the pool's absmax)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu.ops.pallas.int8_matmul import pack_int4 as jax_pack_int4
from deepspeed_tpu_torch.ops.cuda import decode_attention as da
from deepspeed_tpu_torch.ops.cuda.int8_matmul import pack_int4, unpack_int4

ATOL = {("dense", "float32"): 1e-6, ("dense", "bfloat16"): 2e-2, (8, "float32"): 1e-5,
        (4, "float32"): 1e-5}
B, H, Dh, PS, PAGES, POOL = 6, 3, 64, 8, 4, 19
# lengths: the sink row (0), 1, a page boundary -1/0/+1, and a full table
LENGTHS = [0, 1, PS - 1, PS, PS + 1, PAGES * PS]


def _case(bits, seed=0, Dh=Dh):
    """q, pools (+ scales) and scattered tables from numpy; page 0 is the
    sink every table slot past a row's pages names."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, Dh), dtype=np.float32)
    tables = np.zeros((B, PAGES), np.int32)
    ids = rng.permutation(np.arange(1, POOL))
    for b, n in enumerate(LENGTHS):
        used = -(-n // PS)
        tables[b, :used] = ids[:used]
        ids = np.roll(ids, -used)
    if bits is None:
        k = rng.standard_normal((H, POOL, PS, Dh), dtype=np.float32)
        v = rng.standard_normal((H, POOL, PS, Dh), dtype=np.float32)
        return q, k, v, None, None, tables
    qmax = 127 if bits == 8 else 7
    k = rng.integers(-qmax - 1, qmax + 1, (H, POOL, PS, Dh)).astype(np.int8)
    v = rng.integers(-qmax - 1, qmax + 1, (H, POOL, PS, Dh)).astype(np.int8)
    if bits == 4:
        k, v = (np.array(jax_pack_int4(jnp.asarray(t))) for t in (k, v))
    ks = rng.uniform(0.001, 0.05, (H, POOL)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (H, POOL)).astype(np.float32)
    return q, k, v, ks, vs, tables


def _port(q, k, v, ks, vs, tables, lengths, dtype=torch.float32, **kw):
    t = torch.from_numpy
    qq = t(q).to(dtype)
    kk, vv = (t(k), t(v)) if ks is not None else (t(k).to(dtype), t(v).to(dtype))
    return da.paged_decode_attention(
        qq, kk, vv, t(lengths), t(tables), k_scales=None if ks is None else t(ks),
        v_scales=None if vs is None else t(vs), **kw)


def _jax(q, k, v, ks, vs, tables, lengths, impl, dtype=jnp.float32):
    quant = ks is not None
    return jda.paged_decode_attention(
        jnp.asarray(q, dtype), jnp.asarray(k if quant else k.astype(np.float32), None if quant
                                           else dtype),
        jnp.asarray(v if quant else v.astype(np.float32), None if quant else dtype),
        jnp.asarray(lengths), jnp.asarray(tables), impl=impl,
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs))


@pytest.mark.parametrize("bits,head_dim", [(None, 64), (8, 64), (4, 64),
                                           (None, 96), (8, 96), (4, 96)],
                         ids=["dense", "kv8", "kv4", "dense-d96", "kv8-d96", "kv4-d96"])
def test_paged_plain_matches_jax_kernel_and_gather(bits, head_dim):
    """Every length of LENGTHS, sink row included, against the Pallas kernel
    (interpret mode); against the gather fallback on rows of length > 0 (its
    softmax over an all-masked row is uniform over the sink's garbage, where
    the kernel and the port give zeros). Head dim 64, and 96 (gpt2-760m's):
    an odd number of 32-dim lane groups, whose int4 dims straddle the
    nibble halves."""
    q, k, v, ks, vs, tables = _case(bits, Dh=head_dim)
    lengths = np.asarray(LENGTHS, np.int32)
    out = _port(q, k, v, ks, vs, tables, lengths)
    assert out.shape == (B, 1, H, head_dim) and out.dtype == torch.float32
    atol = ATOL[("dense" if bits is None else bits, "float32")]
    ref = np.asarray(_jax(q, k, v, ks, vs, tables, lengths, "kernel"))
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=0)
    gather = np.asarray(_jax(q, k, v, ks, vs, tables, lengths, "gather"))
    live = lengths > 0
    np.testing.assert_allclose(out.numpy()[live], gather[live], atol=atol, rtol=0)
    assert torch.count_nonzero(out[~torch.from_numpy(live)]) == 0  # the sink row


def test_paged_plain_matches_jax_bf16():
    q, k, v, ks, vs, tables = _case(None, seed=1)
    lengths = np.asarray(LENGTHS, np.int32)
    out = _port(q, k, v, ks, vs, tables, lengths, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ref = _jax(q, k, v, ks, vs, tables, lengths, "kernel", dtype=jnp.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=ATOL[("dense", "bfloat16")], rtol=0)


@pytest.mark.parametrize("bits,Dh", [(None, 64), (8, 64), (4, 64), (4, 96)],
                         ids=["dense", "kv8", "kv4", "kv4-d96"])
def test_paged_plain_is_bitwise_the_contiguous_formula(bits, Dh):
    """The reference's own claim, about the port: the paged plain version is
    bitwise ``decode_attention_ref`` over the gathered (dequantized) cache."""
    q, k, v, ks, vs, tables = _case(bits, seed=2, Dh=Dh)
    lengths = torch.tensor([5, 17, 32, 9, 1, 24], dtype=torch.int32)
    out = _port(q, k, v, ks, vs, tables, lengths.numpy(), impl="gather")
    t = torch.from_numpy
    pages_k, pages_v = t(k), t(v)
    if ks is None:
        kc, vc = (p[:, t(tables).long()].permute(1, 0, 2, 3, 4).reshape(B, H, -1, Dh)
                  for p in (pages_k, pages_v))
    else:
        def deq(p, s):
            x = unpack_int4(p).float() if bits == 4 else p.float()
            return x * t(s)[..., None, None]
        kc, vc = (deq(p, s)[:, t(tables).long()].permute(1, 0, 2, 3, 4).reshape(B, H, -1, Dh)
                  for p, s in ((pages_k, ks), (pages_v, vs)))
    ref = da.decode_attention_ref(t(q), kc, vc, lengths)
    assert torch.equal(out, ref)


def test_int4_nibble_order_at_head_dim_96_matches_jax():
    """At head dim 96 a row packs into 48 bytes: dim d < 48 is byte d's low
    nibble, dim d >= 48 byte d - 48's high one (the JAX package's
    pack_int4). The port's unpack_kv_int4 gives each dim its own value back,
    and the paged plain version over an int4 pool equals the dense formula
    over the pool unpacked by it (bitwise) and the JAX kernel (1e-5)."""
    dims = np.arange(96) % 16 - 8  # every dim its own nibble value, in [-8, 7]
    rows = np.stack([np.roll(dims, r) for r in range(8)]).astype(np.int8)  # [8, 96]
    packed = np.array(jax_pack_int4(jnp.asarray(rows)))
    assert packed.shape == (8, 48)
    np.testing.assert_array_equal(da.unpack_kv_int4(torch.from_numpy(packed)).numpy(), rows)
    q, k, v, ks, vs, tables = _case(4, seed=6, Dh=96)
    lengths = np.asarray(LENGTHS, np.int32)
    out = _port(q, k, v, ks, vs, tables, lengths)
    t = torch.from_numpy
    kc, vc = (da.gather_pages(da.unpack_kv_int4(t(p)) * t(sc)[..., None, None], None,
                              t(tables).long(), 96) for p, sc in ((k, ks), (v, vs)))
    assert torch.equal(out, da.decode_attention_ref(t(q), kc, vc, t(lengths)))
    ref = np.asarray(_jax(q, k, v, ks, vs, tables, lengths, "kernel"))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL[(4, "float32")], rtol=0)


def test_pack_int4_matches_jax_and_round_trips():
    q = np.random.default_rng(3).integers(-8, 8, (5, 7, 16)).astype(np.int8)
    packed = pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(da.unpack_kv_int4(packed).numpy(),
                                  np.asarray(jda.unpack_kv_int4(jnp.asarray(packed.numpy()))))
    with pytest.raises(ValueError, match="even"):
        pack_int4(torch.zeros(3, 5))


def test_paged_dispatch_and_checks():
    q, k, v, ks, vs, tables = _case(8, seed=4)
    lengths = np.asarray(LENGTHS, np.int32)
    with pytest.raises(ValueError, match="on the CPU|CUDA"):
        _port(q, k, v, ks, vs, tables, lengths, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        _port(q, k, v, ks, vs, tables, lengths, impl="pallas")
    with pytest.raises(ValueError, match="both"):
        _port(q, k, v, ks, None, tables, lengths)
    with pytest.raises(ValueError, match="neither"):
        _port(q, k[..., :10], v[..., :10], ks, vs, tables, lengths)
    qt = torch.from_numpy(q).requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference-only"):
        da.paged_decode_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(lengths), torch.from_numpy(tables),
                                  k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    before = (da.paged_launches, da.paged_kv8_launches, da.paged_kv4_launches)
    _port(q, k, v, ks, vs, tables, lengths)  # the plain version counts no launch
    assert (da.paged_launches, da.paged_kv8_launches, da.paged_kv4_launches) == before
