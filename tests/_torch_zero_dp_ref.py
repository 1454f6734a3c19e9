"""The JAX side shared by ``tests/test_torch_zero_dp.py`` and
``tests/test_torch_zero_dp_dist.py``: the reference's exchanges on a W-rank
mesh, the payloads its quantizer makes, and its engine's runs of the
cases of ``_torch_zero_dp_workers.py``."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import _torch_zero_dp_workers as workers
import deepspeed_tpu
from deepspeed_tpu.comm import quantized as jq
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology, mesh_context
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths

ATOL = 2e-6  # one rounding of the dequantize (the FMA under jit)
QCASES = ("q_mono", "q_mono_ef", "q_bucket", "q_bucket_ef")


def jax_exchanges(ins, W):
    """The JAX functions on a W-rank mesh: per rank, the bucket exchange
    (through ``grad_bucket_reduce``'s backward, the cotangents being the
    rank's buffers) and the monolithic one, with and without residuals."""
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("dp",))
    s = jnp.float32(workers.SCALE)
    out = {}
    for ef in (False, True):
        def bucket(a, b, r):
            tree = {"a": jnp.zeros_like(a[0]), "b": jnp.zeros_like(b[0])}

            def f(t, rr):
                o = jq.grad_bucket_reduce(t, rr if ef else None, s)
                return jnp.vdot(o["a"], a[0]) + jnp.vdot(o["b"], b[0])

            (g, gr) = jax.grad(f, argnums=(0, 1))(tree, r[0])
            return g["a"][None], g["b"][None], (gr if ef else r[0] * 0)[None]

        sp = lambda x: P("dp", *([None] * (x.ndim - 1)))  # noqa: E731
        a, b, r = ins["bucket.a"][:W], ins["bucket.b"][:W], ins["bucket.resid"][:W]
        ga, gb, gr = jax.jit(shard_map(bucket, mesh=mesh, in_specs=(sp(a), sp(b), sp(r)),
                                       out_specs=(sp(a), sp(b), sp(r))))(a, b, r)
        out[f"bucket{int(ef)}.a"], out[f"bucket{int(ef)}.b"] = np.asarray(ga), np.asarray(gb)
        if ef:
            out["bucket1.resid"] = np.asarray(gr)

        def mono(x, r):
            kw = dict(mean=True)
            if ef:
                red, nr = jq.qreduce_scatter(x[0], "dp", residual=r[0] * s, **kw)
                return jq.qall_gather(red, "dp")[None], (nr / s)[None]
            return jq.qall_gather(jq.qreduce_scatter(x[0], "dp", **kw), "dp")[None], r * 0

        x, r = ins["flat"][:W], ins["flat.resid"][:W]
        full, nr = jax.jit(shard_map(mono, mesh=mesh, in_specs=(P("dp", None), P("dp", None)),
                                     out_specs=(P("dp", None), P("dp", None))))(x, r)
        out[f"flat{int(ef)}"] = np.asarray(full)
        if ef:
            out["flat1.resid"] = np.asarray(nr)
    return out


def expected_payloads(ins, W, rank):
    """The int payload rank ``rank`` sends in each exchange's reduce-scatter,
    from JAX's quantizer run eagerly (bitwise the reference's rounding)."""
    s = np.float32(workers.SCALE)
    out = {}
    for ef in (False, True):
        flat = np.concatenate([ins["bucket.a"][rank].ravel(), ins["bucket.b"][rank].ravel()])
        flat = np.pad(flat, (0, -flat.size % W))
        if ef:
            flat = flat + ins["bucket.resid"][rank] * s
        out[f"bucket{int(ef)}.payload"] = np.asarray(
            jq.quantize_blockwise(jnp.asarray(flat.reshape(W, -1)))[0])
        flat = ins["flat"][rank] + (ins["flat.resid"][rank] * s if ef else 0)
        out[f"flat{int(ef)}.payload"] = np.asarray(
            jq.quantize_blockwise(jnp.asarray(flat.reshape(W, -1)))[0])
    return out


def jax_engine(name_or_zero, W=1, micro=None, **over):
    zero, opt, extra = (workers.CASES[name_or_zero] if isinstance(name_or_zero, str)
                        else (name_or_zero, "AdamW", {}))
    cfg = workers.config(zero, opt, micro=micro or workers.GLOBAL_B // W, **{**extra, **over})
    model, _ = build_gpt(JaxGPTConfig(**workers.TINY))
    return deepspeed_tpu.initialize(
        model=model, config=JaxDeepSpeedConfig.load(cfg, world_size=W),
        topology=MeshTopology.create(dp=W, devices=jax.devices()[:W]), seed=0)[0]


def jax_exchanged_grads(jengine, batch):
    """Step 1's gradients as the JAX engine's ``_qdp_grads`` exchanges them
    (from its start state), by the port's leaf names."""
    st = jengine.state
    with mesh_context(jengine.mesh):
        _, grads, _, _ = jax.jit(jengine._qdp_grads)(
            st["params"], {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(1.0),
            jax.random.PRNGKey(0), st.get("qgrad_residual"), st.get("qgrad_bucket_residual"))
    return {k: np.asarray(v) for k, v in flatten_with_paths(jax.tree_util.tree_map(
        np.asarray, grads))}


def jax_run(jengine, name):
    """(losses, grad norms, final numpy state) of 3 steps."""
    ms = [jengine.train_batch(b) for b in workers.batches(name)]
    return ([float(m["loss"]) for m in ms], [float(m["grad_norm"]) for m in ms],
            jax.tree_util.tree_map(np.asarray, jengine.state))


def exchanged_within_a_step(got, want, bits=8):
    """Each entry within two quantization steps of its block of the
    exchanged gradients (the rs payload's and the ag payload's roundings)."""
    levels = (1 << bits) - 1
    for k, w in want.items():
        g = got[k]
        flat_w = w.reshape(-1)
        blocks = np.pad(flat_w, (0, -flat_w.size % 256), mode="edge").reshape(-1, 256)
        step = ((blocks.max(1) - blocks.min(1)) / levels).repeat(256)[:flat_w.size]
        err = np.abs(g.reshape(-1) - flat_w)
        assert (err <= 2 * step + 1e-7).all(), (k, float(err.max()), float(step.max()))
