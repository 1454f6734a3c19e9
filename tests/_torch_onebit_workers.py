"""The port side of the 1-bit optimizer tests (``tests/test_torch_onebit.py``
and, in ``spawn``ed gloo ranks, ``tests/test_torch_onebit_dist.py``). It
imports no JAX.

The engines train a *linear probe*: a parameter tree shaped like a small
GPT's (a stacked ``blocks`` subtree, an embedding, a norm scale, a bias of 5
so that the flat size is no multiple of 8 W), whose loss is ``sum(p * g)``
with ``g`` a batch input. Its gradient is ``g`` itself, bitwise, in both
packages: the optimizers see the same gradients, so the compressed stage is
held without the model's rounding in the way (a GPT's key bias has a
gradient that is rounding noise, which 1-bit Adam divides by
``sqrt(v) + eps``; ``test_torch_onebit.py`` holds the GPT's losses
separately).
"""

import numpy as np
import torch

SHAPES = {"blocks": {"qkv_w": (2, 16, 48), "qkv_b": (2, 48), "mlp_w": (2, 16, 64)},
          "wte": (64, 16), "ln_f_scale": (16,), "head_b": (5,)}
STEPS = 5
FREEZE = 2
LR = 1e-2


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def n_elems() -> int:
    return sum(int(np.prod(s)) for _, s in _leaves(SHAPES))


def start_params():
    """The probe's start parameters (fp32 numpy tree)."""
    rng = np.random.default_rng(3)

    def build(node):
        return {k: build(v) if isinstance(v, dict) else
                (rng.normal(size=v) * 0.05).astype(np.float32) for k, v in node.items()}

    return build(SHAPES)


def grads(world=1, gas=1):
    """STEPS gradient batches: [world, n] per step (gas > 1: [gas, world,
    n]), each leaf at its own scale; the first compressed step's has exact
    zeros and -0.0 (both pack as a non-negative sign: with a zero momentum
    in 0/1 Adam's first exchange)."""
    rng = np.random.default_rng(11)
    scales = np.concatenate([np.full(int(np.prod(s)), 2.0 ** -(i % 3))
                             for i, (_, s) in enumerate(_leaves(SHAPES))])
    out = []
    for step in range(STEPS):
        g = (rng.normal(size=(gas, world, n_elems())) * scales).astype(np.float32)
        if step == FREEZE:
            g[..., 7:9] = 0.0
            g[..., 9:11] = -0.0
        out.append(g if gas > 1 else g[0])
    return out


def batch(g):
    """A train batch around a gradient array (input_ids for the engines'
    bookkeeping, one token a row)."""
    return {"input_ids": np.zeros(g.shape[:-1] + (1,), np.int32), "g": g}


def config(opt, zero_stage=0, gas=1, world=1, bf16=False, **params):
    cfg = {"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": gas,
           "optimizer": {"type": opt, "params": {
               "lr": LR, "freeze_step": FREEZE, "var_freeze_step": FREEZE + 1,
               "weight_decay": 0.01, **params}},
           "zero_optimization": {"stage": zero_stage}, "steps_per_print": 0}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def probe_module():
    """The port's probe model."""
    from deepspeed_tpu_torch.models.api import Module
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    p0 = start_params()

    def init(seed, device=None):
        return {k: init_tree(v, device) for k, v in p0.items()}

    def init_tree(node, device):
        if isinstance(node, dict):
            return {k: init_tree(v, device) for k, v in node.items()}
        return torch.tensor(node, device=device)

    def apply(params, batch, rngs=None, train=True, **kw):
        g = batch["g"].float().mean(dim=0)
        loss, off = 0.0, 0
        for leaf in tree_leaves(params):
            n = leaf.numel()
            loss = loss + (leaf.float().reshape(-1) * g[off:off + n]).sum()
            off += n
        return loss, {}

    return Module(init=init, apply=apply)


def make_engine(cfg, device="cpu"):
    import deepspeed_tpu_torch

    return deepspeed_tpu_torch.initialize(model=probe_module(), config=cfg, device=device,
                                          seed=0)[0]


def run(engine, batches):
    """Losses, grad norms and the flat numpy state after every step (the
    residual rows as this rank holds them)."""
    from deepspeed_tpu_torch import bridge
    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths

    out = {"losses": [], "norms": [], "states": []}
    for b in batches:
        m = engine.train_batch(b)
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
        state = bridge.train_state_to_numpy(engine.state, specs=engine.param_specs,
                                            opt_specs=engine.opt_specs)
        # copies: the engine updates its tensors in place
        out["states"].append({k: np.array(v) for k, v in flatten_with_paths(state)})
    return out


# --------------------------------------------------------------------------- two ranks
# name -> (optimizer, ZeRO stage, gas)
DIST_CASES = {
    "adam_s0": ("OneBitAdam", 0, 1),
    "adam_s1_gas2": ("OneBitAdam", 1, 2),
    "lamb_s1": ("OneBitLamb", 1, 1),
    "zo_s1": ("ZeroOneAdam", 1, 1),
    "zo_s0_gas2": ("ZeroOneAdam", 0, 2),
}
TAG_CASE = "adam_s1_gas2"  # saves a dp2 tag after step SAVE_AT
SAVE_AT = 3


# the GPT cases at dp2 against the same runs at world 1 (the parent's): the
# probe's HVP averaged over the ranks, and stage 3's compression transform on
# gathered leaves
TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=64)
MOQ = {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 1},
    "different_groups": {"g": {"params": {"start_bits": 8, "target_bits": 4,
                                          "quantization_period": 1}}}},
    "sparse_pruning": {"shared_parameters": {"enabled": True, "schedule_offset": 2},
                       "different_groups": {"s": {"params": {"dense_ratio": 0.5}}}}}
GPT_CASES = {
    "probe": {"eigenvalue": {"enabled": True, "max_iter": 20, "tol": 1e-3}},
    "moq_s3": {"compression_training": MOQ,
               "zero_optimization": {"stage": 3, "stage3_param_persistence_threshold": 0}},
}


def gpt_config(name, world=2):
    return {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 4 // world,
            "steps_per_print": 0, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}}, **GPT_CASES[name]}


def gpt_batches():
    return [{"input_ids": np.random.default_rng(40 + s).integers(0, 256, (4, 32), dtype=np.int32)}
            for s in range(3)]


def gpt_run(name, world=2):
    """Losses of 3 steps (the probe's case: 1) and the curvature."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt

    engine = deepspeed_tpu_torch.initialize(model=gpt.build(gpt.GPTConfig(**TINY))[0],
                                            config=gpt_config(name, world), device="cpu",
                                            seed=0)[0]
    batches = gpt_batches()[:1 if name == "probe" else 3]
    losses = [float(engine.train_batch(b)["loss"]) for b in batches]
    curv = engine.state["curvature"].numpy() if "curvature" in engine.state else np.zeros(0)
    return np.array(losses), curv


def dist_config(name, world=2):
    opt, stage, gas = DIST_CASES[name]
    return config(opt, zero_stage=stage, gas=gas, world=world)


def rank_main(rank, world, init_file, out_dir, inputs):
    """One rank: the compressed allreduce of its rows of ``inputs``, and
    every DIST_CASES run (the TAG_CASE run saving a tag into
    ``out_dir/tag``). Writes ``rank<r>.npz``."""
    import os

    torch.set_num_threads(1)
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.comm.compressed import compressed_allreduce
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    comm.init_distributed(init_method=f"file://{init_file}", world_size=world, rank=rank,
                          device="cpu")
    out = {}
    x, werr, serr = (torch.from_numpy(a[rank]) for a in inputs["compressed"])
    for key, val in zip(("result", "worker_error", "server_error"),
                        compressed_allreduce(x, werr, serr)):
        out[f"compressed.{key}"] = val.numpy()
    for name in DIST_CASES:
        gas = DIST_CASES[name][2]
        engine = make_engine(dist_config(name, world))
        batches = [batch(g) for g in grads(world, gas)]
        if name == TAG_CASE:
            run_a, run_b = run(engine, batches[:SAVE_AT]), None
            engine.save_checkpoint(os.path.join(out_dir, "tag"))
            run_b = run(engine, batches[SAVE_AT:])
            res = {k: run_a[k] + run_b[k] for k in run_a}
        else:
            res = run(engine, batches)
        out[f"{name}.losses"] = np.array(res["losses"])
        out[f"{name}.norms"] = np.array(res["norms"])
        for s, state in enumerate(res["states"]):
            for k, v in state.items():
                out[f"{name}.s{s}.{k}"] = v
        out[f"{name}.row"] = engine.state["onebit"]["worker_error"].numpy()
        out[f"{name}.opt_elems"] = sum(t.numel() for t in tree_leaves(engine.state["opt"].mu))
    for name in GPT_CASES:
        out[f"{name}.losses"], out[f"{name}.curvature"] = gpt_run(name, world)
    comm.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
