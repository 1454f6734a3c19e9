"""The per-layer Hessian eigenvalue probe against the JAX package's, fp32 on
a ``tiny`` GPT with the plain attention path.

- One power-iteration step per layer from the same numpy start vector: the
  next vector within 2e-5 and the eigenvalue within 1e-4 relative of JAX's
  (forward over reverse there, reverse over reverse here: two summation
  orders of the same second derivative), with and without ``loss_chunk``
  (``_ChunkedCE`` differentiated twice: its graph-building backward).
- ``compute`` from JAX's own start vectors (``PRNGKey(17)``, drawn here the
  way the reference draws them and handed in as numpy): the normalized
  eigenvalues within 1e-4; ``post_process`` and the subtree checks are
  JAX's.
- Double differentiation through ``FlashAttention`` and
  ``BlocksparseAttention`` raises ``NotImplementedError`` (on every device;
  first derivatives are unchanged), so an engine on the kernels
  (``use_flash=True``) disables its probe with the reference's log line.
  The reference's Pallas kernel refuses forward-over-reverse too; on the
  CPU its interpret mode raises an ``AssertionError`` (not the TPU's
  ``TypeError``), which the test pins.
- The engine's ``curvature`` after a probed step equals the JAX engine's
  (1e-4) given the same start vectors; the imperative API probes on its last
  micro-batch; ``Train/eigenvalue_mean`` is written; ``curvature`` crosses in
  tags both ways.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.eigenvalue import Eigenvalue as JaxEigenvalue
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=128)
BATCH = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)}


def _models(**over):
    jm, _ = build_gpt(JaxGPTConfig(**TINY, use_flash=False, **over))
    pm, _ = gpt.build(gpt.GPTConfig(**TINY, use_flash=False, **over))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    pp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jloss = lambda p, b: jm.apply(p, b, train=False)[0].astype(jnp.float32)  # noqa: E731
    tloss = lambda p, b: pm.apply(p, b, train=False)[0].float()  # noqa: E731
    return jp, pp, jloss, tloss


def _jax_start_vectors(jp, n_layer=2, key=jax.random.PRNGKey(17)):
    """The reference's draws (``Eigenvalue.compute``), unnormalized, as numpy."""
    out = []
    for i in range(n_layer):
        theta = jax.tree_util.tree_map(lambda a: a[i].astype(jnp.float32), jp["blocks"])
        leaves = jax.tree_util.tree_leaves(theta)
        keys = jax.random.split(jax.random.fold_in(key, i), len(leaves))
        out.append([np.asarray(jax.random.normal(k, x.shape, jnp.float32))
                    for k, x in zip(keys, leaves)])
    return out


@pytest.fixture(scope="module", params=[0, 16], ids=["loss", "loss_chunk16"])
def hvp_pair(request):
    """The two packages' models at one ``loss_chunk`` and the reference's
    compiled power-iteration step."""
    jp, pp, jloss, tloss = _models(loss_chunk=request.param)
    jeig = JaxEigenvalue(max_iter=20, tol=1e-3)
    jeig._iter_fn = jeig._build_iter_fn(jloss, "blocks", True)
    jeig._iter_loss_fn = (jloss, True)  # compute() reuses the compiled step
    return jp, pp, jloss, tloss, jeig


def test_one_hvp_step_per_layer_matches_jax(hvp_pair):
    jp, pp, _, tloss, jeig = hvp_pair
    jb = {k: jnp.asarray(v) for k, v in BATCH.items()}
    tb = {k: torch.from_numpy(v) for k, v in BATCH.items()}
    for i, start in enumerate(_jax_start_vectors(jp)):
        norm = np.float32(np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in start)))
        v = [x / norm for x in start]
        theta = jax.tree_util.tree_map(lambda a: a[i].astype(jnp.float32), jp["blocks"])
        jv, jev = jeig._iter_fn(jp, jb, theta, jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(theta), [jnp.asarray(x) for x in v]), jnp.int32(i))
        tv, tev = Eigenvalue().one_iter(tloss, pp, tb, i, [torch.from_numpy(x) for x in v])
        np.testing.assert_allclose(float(tev), float(jev), rtol=1e-4)
        for a, b in zip(tv, jax.tree_util.tree_leaves(jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)


def test_compute_from_jax_start_vectors_matches_jax(hvp_pair):
    jp, pp, jloss, tloss, jeig = hvp_pair
    jb = {k: jnp.asarray(v) for k, v in BATCH.items()}
    tb = {k: torch.from_numpy(v) for k, v in BATCH.items()}
    want = jeig.compute(jloss, jp, batch=jb)
    got = Eigenvalue(max_iter=20, tol=1e-3).compute(tloss, pp, batch=tb,
                                                    start_vectors=_jax_start_vectors(jp))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got.max() == 1.0 and (got >= 0).all()


def test_chunked_loss_hvp_is_the_unchunked_one():
    """No term of the second derivative is dropped in ``_ChunkedCE``."""
    _, pp, _, plain = _models()
    _, _, _, chunked = _models(loss_chunk=8)
    tb = {k: torch.from_numpy(v) for k, v in BATCH.items()}
    v = [torch.randn(t[0].shape, generator=torch.Generator().manual_seed(3))
         for t in gpt_blocks(pp)]
    a = Eigenvalue().hvp(plain, pp, tb, 1, v)
    b = Eigenvalue().hvp(chunked, pp, tb, 1, v)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=1e-6 * x.abs().max())


def gpt_blocks(params):
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    return tree_leaves(params["blocks"])


def test_post_process_and_subtree_checks_match_jax():
    for vals in ([0.0, 2.0, -4.0], [0.0, 0.0], [3.0], [1e-30, -2.0, 0.5]):
        np.testing.assert_array_equal(Eigenvalue.post_process(vals),
                                      JaxEigenvalue.post_process(vals))
    params = {"blocks": {"w": torch.ones(3, 4), "b": torch.ones(3)}}
    assert Eigenvalue(layer_name="bert.encoder.layer")._blocks(params)[::2] == ("blocks", 3)
    with pytest.raises(ValueError, match="no stacked layer subtree"):
        Eigenvalue()._blocks({"layers": {"w": torch.ones(2, 2)}})
    with pytest.raises(ValueError, match="layer_num=4"):
        Eigenvalue(layer_num=4)._blocks(params)
    with pytest.raises(ValueError, match="disagree"):
        Eigenvalue()._blocks({"blocks": {"w": torch.ones(3, 4), "b": torch.ones(2)}})
    # a quadratic with per-layer Hessians a_l I: the eigenvalues a_l / max a
    coefs = torch.tensor([1.0, 2.0, 4.0])
    w = {"blocks": {"w": torch.randn(3, 8, generator=torch.Generator().manual_seed(0))}}
    ev = Eigenvalue(max_iter=10, tol=1e-4).compute(
        lambda p: 0.5 * (coefs[:, None] * p["blocks"]["w"] ** 2).sum(), w)
    np.testing.assert_allclose(ev, [0.25, 0.5, 1.0], rtol=1e-5)


def test_double_differentiation_through_the_kernels_raises():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 16, generator=g, requires_grad=True) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    first = torch.autograd.grad(out.sum(), (q, k, v))  # first order: unchanged
    assert all(torch.isfinite(t).all() for t in first)
    with pytest.raises(NotImplementedError, match="FlashAttention is not twice"):
        torch.autograd.grad(fa.flash_attention(q, k, v).sum(), (q, k, v), create_graph=True)
    layout = torch.ones(2, 4, 4, dtype=torch.int64).tril()
    with pytest.raises(NotImplementedError, match="BlocksparseAttention is not twice"):
        torch.autograd.grad(bs.blocksparse_attention(q, k, v, layout, 16).sum(), (q, k, v),
                            create_graph=True)


def _config(**over):
    cfg = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "eigenvalue": {"enabled": True, "max_iter": 20, "tol": 1e-3}}
    cfg.update(over)
    return cfg


def _jax_engine(cfg, **over):
    return deepspeed_tpu.initialize(model=build_gpt(JaxGPTConfig(**TINY, **over))[0],
                                    config=JaxDeepSpeedConfig.load(cfg, 1),
                                    topology=MeshTopology.single_device(), seed=0)[0]


def _port_engine(cfg, **over):
    return deepspeed_tpu_torch.initialize(model=gpt.build(gpt.GPTConfig(**TINY, **over))[0],
                                          config=cfg, device="cpu", seed=0)[0]


def test_the_engine_on_the_kernels_disables_the_probe():
    """The port's probe logs and disables itself on the kernels' refusal and
    training goes on. The reference's probe is meant to do the same on its
    Pallas kernel (``TypeError`` on the TPU); on the CPU, in interpret mode,
    JAX's forward-over-reverse through the kernel fails with an
    ``AssertionError`` inside ``pallas_call``'s JVP rule instead, which the
    reference's engine does not catch: pinned here, so that a JAX whose
    interpret mode gains the TypeError shows up."""
    import logging

    from deepspeed_tpu_torch.utils.logging import logger

    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger.addHandler(handler)
    try:
        pe = _port_engine(_config(), use_flash=True)
        assert pe.state["curvature"].shape == (2,)
        for _ in range(2):
            assert np.isfinite(float(pe.train_batch(BATCH)["loss"]))
    finally:
        logger.removeHandler(handler)
    assert pe._eigenvalue is None and not pe.state["curvature"].any()
    assert [x for x in lines if "second-order differentiation" in x
            and "FlashAttention is not twice differentiable" in x and "disabling probe" in x]
    from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

    q = jnp.asarray(np.random.default_rng(0).normal(size=(1, 128, 2, 64)), jnp.float32)
    grad = jax.grad(lambda x: jax_flash(x, q, q, causal=True).sum())
    assert np.isfinite(np.asarray(grad(q))).all()
    with pytest.raises(AssertionError):
        jax.jvp(grad, (q,), (q,))


@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    """A JAX engine and a port engine from its state, one probed step each,
    the port's probe handed the reference's start vectors."""
    cfg = _config()
    je = _jax_engine(cfg, use_flash=False)
    pe = _port_engine(cfg, use_flash=False)
    pe.load_state(bridge.train_state_from_numpy(jax.tree_util.tree_map(np.array, je.state),
                                                "cpu"))
    pe._eigenvalue.start_vectors = lambda params, generator=None: _jax_start_vectors(
        jax.tree_util.tree_map(jnp.asarray, bridge.params_to_numpy(params)))
    jm, pm = je.train_batch(BATCH), pe.train_batch(BATCH)
    return je, pe, (jm, pm), tmp_path_factory.mktemp("ev")


def test_engine_curvature_after_a_probed_step_matches_jax(probed):
    je, pe, (jm, pm), _ = probed
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    want = np.asarray(je.state["curvature"])
    np.testing.assert_allclose(pe.state["curvature"].numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(pe._curvature_np, pe.state["curvature"].numpy())
    assert want.max() == 1.0


def test_curvature_crosses_in_tags_both_ways(probed):
    je, pe, _, root = probed
    pe.save_checkpoint(str(root / "port"))
    je.save_checkpoint(str(root / "jax"))
    p2 = _port_engine(_config(), use_flash=False)
    p2.load_checkpoint(str(root / "jax"))
    np.testing.assert_array_equal(p2.state["curvature"].numpy(), np.asarray(je.state["curvature"]))
    np.testing.assert_array_equal(p2._curvature_np, np.asarray(je.state["curvature"]))
    j2 = _jax_engine(_config(), use_flash=False)
    j2.load_checkpoint(str(root / "port"))
    np.testing.assert_array_equal(np.asarray(j2.state["curvature"]),
                                  pe.state["curvature"].numpy())


def test_imperative_api_probes_and_the_monitor_writes_the_mean(tmp_path):
    cfg = _config(csv_monitor={"enabled": True, "output_path": str(tmp_path), "job_name": "ev"})
    fused, imperative = _port_engine(cfg, use_flash=False), _port_engine(cfg, use_flash=False)
    fused.train_batch(BATCH)
    loss = imperative.forward(BATCH)
    imperative.backward(loss)
    imperative.step()
    curv = imperative.state["curvature"].numpy()
    assert curv.max() == 1.0
    np.testing.assert_array_equal(curv, fused.state["curvature"].numpy())
    rows = (tmp_path / "ev" / "Train_eigenvalue_mean.csv").read_text().splitlines()
    assert len(rows) == 3 and float(rows[1].split(",")[1]) == pytest.approx(curv.mean())
