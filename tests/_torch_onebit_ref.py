"""The JAX side of the 1-bit optimizer tests: the reference's engine on the
linear probe of ``_torch_onebit_workers.py`` (on a W-device mesh), its
compressed allreduce body, and its runs."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import _torch_onebit_workers as workers
import deepspeed_tpu
from deepspeed_tpu.models.api import Module as JaxModule
from deepspeed_tpu.runtime.comm.compressed import compressed_allreduce
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths


def jax_probe_module():
    p0 = workers.start_params()

    def apply(params, batch, rngs=None, train=True):
        g = batch["g"].astype(jnp.float32).mean(axis=0)
        loss, off = 0.0, 0
        for leaf in jax.tree_util.tree_leaves(params):
            loss = loss + jnp.sum(leaf.astype(jnp.float32).reshape(-1) * g[off:off + leaf.size])
            off += leaf.size
        return loss, {}

    return JaxModule(init=lambda rng: jax.tree_util.tree_map(jnp.asarray, p0), apply=apply)


def jax_engine(cfg, W=1):
    return deepspeed_tpu.initialize(
        model=jax_probe_module(), config=JaxDeepSpeedConfig.load(cfg, world_size=W),
        topology=MeshTopology.create(dp=W, devices=jax.devices()[:W]), seed=0)[0]


def jax_run(engine, batches):
    out = {"losses": [], "norms": [], "states": []}
    for b in batches:
        m = engine.train_batch(b)
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
        # copies: the engine donates its state buffers to the next step
        out["states"].append(dict(flatten_with_paths(
            jax.tree_util.tree_map(lambda x: np.array(x, np.float32), engine.state))))
    return out


def jax_compressed(xs, werr, serr):
    """The reference's compressed allreduce on a W-device mesh (W = rows of
    ``xs``): (result per rank, new worker errors, new server errors)."""
    W = xs.shape[0]
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("dp",))

    def body(x, w, s):
        r, w2, s2 = compressed_allreduce(x[0], w[0], s[0], "dp")
        return r[None], w2[None], s2[None]

    spec = P("dp", None)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                          out_specs=(spec, spec, spec), check_vma=False))
    return tuple(np.asarray(a) for a in f(xs, werr, serr))


def compressed_inputs(W, n=4096):
    """Per-rank vectors and residuals for the allreduce (rows: ranks)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(W, n)).astype(np.float32)
    x[:, 3] = 0.0
    x[:, 5] = -0.0
    return (x, (rng.normal(size=(W, n)) * 0.1).astype(np.float32),
            (rng.normal(size=(W, n // W)) * 0.1).astype(np.float32))
