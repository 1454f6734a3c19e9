"""The rank side of ``tests/test_torch_zero_dp_dist.py``: data parallelism
at ZeRO stages 0-2, the quantized gradient exchange and reshard-on-load, in
processes started with the ``spawn`` method, on gloo. It imports no JAX
(the parent computes the JAX results), so a rank never inherits JAX's
threads.
"""

import hashlib
import os

import numpy as np
import torch

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=64)
SEQ = 32
GLOBAL_B = 4
STEPS = 3
SCALE = 2.0 ** 10  # the loss scale the exchange tests' gradients carry
QGRAD = {"zero_quantized_gradients": True}
EF = {"zero_quantize_error_feedback": True}

# the engine runs: name -> (zero_optimization block, optimizer type, extra config)
CASES = {
    "s0": ({"stage": 0}, "AdamW", {}),
    "s1": ({"stage": 1}, "AdamW", {}),
    "s2": ({"stage": 2}, "AdamW", {}),
    "q_mono": ({"stage": 2, **QGRAD, "overlap_comm": False}, "AdamW", {}),
    "q_mono_ef": ({"stage": 2, **QGRAD, **EF, "overlap_comm": False}, "AdamW", {}),
    "q_bucket": ({"stage": 2, **QGRAD}, "AdamW", {}),
    "q_bucket_ef": ({"stage": 2, **QGRAD, **EF}, "AdamW", {}),
    "mask": ({"stage": 2}, "AdamW", {}),
    "lamb2": ({"stage": 2}, "Lamb", {}),
    "lamb3": ({"stage": 3, "stage3_param_persistence_threshold": 0}, "Lamb", {}),
}
# the JAX run each case is held against (the JAX engine's stage only places
# the same values; one dense run covers stages 0-2, one LAMB run stages 2-3)
JAX_RUN = {"s0": "s2", "s1": "s2", "s2": "s2", "lamb2": "lamb2", "lamb3": "lamb2"}


def config(zero, opt="AdamW", micro=None, gas=1, **over):
    micro = GLOBAL_B if micro is None else micro
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
           "optimizer": {"type": opt, "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "steps_per_print": 0, "zero_optimization": zero}
    cfg.update(over)
    return cfg


def batches(case):
    """The global batches of a case (a loss_mask with unequal counts on the
    two ranks' rows for "mask")."""
    out = []
    for s in range(STEPS):
        rng = np.random.default_rng(100 + s)
        b = {"input_ids": rng.integers(0, TINY["vocab_size"], (GLOBAL_B, SEQ), dtype=np.int32)}
        if case == "mask":
            keep = np.array([0.9, 0.7, 0.2, 0.05])[:, None]
            b["loss_mask"] = (rng.random((GLOBAL_B, SEQ)) < keep).astype(np.int32)
        out.append(b)
    return out


def exchange_inputs():
    """Per-rank gradient buffers for the exchange functions (rows: ranks):
    one layer's leaves for the bucket, and a flat vector (with a residual)
    for the monolithic exchange."""
    rng = np.random.default_rng(7)
    # gradients as they come out of a backward at the loss scale (O(1)); the
    # residuals in unscaled units
    return {"bucket.a": rng.normal(size=(2, 24, 40)).astype(np.float32),
            "bucket.b": rng.normal(size=(2, 72)).astype(np.float32) * 0.1,
            "bucket.resid": rng.normal(size=(2, 1032)).astype(np.float32) * 1e-3 / SCALE,
            "flat": rng.normal(size=(2, 2000)).astype(np.float32),
            "flat.resid": rng.normal(size=(2, 2000)).astype(np.float32) * 1e-3 / SCALE}


def run_exchanges(rank, ins, bits=8, block=256):
    """The port's bucket and monolithic exchanges of this rank's rows, with
    and without a residual, and the int payloads each sends."""
    from deepspeed_tpu_torch.comm import comm, quantized as tq

    sent = []
    real = comm.all_to_all

    def spy(x, *a, **kw):
        if x.dtype == torch.uint8:
            sent.append(x.clone())
        return real(x, *a, **kw)

    out = {}
    t = {k: torch.from_numpy(np.array(v[rank])) for k, v in ins.items()}
    tree = {"a": t["bucket.a"], "b": t["bucket.b"]}
    comm.all_to_all = spy
    try:
        for ef in (False, True):
            sent.clear()
            r = t["bucket.resid"] if ef else None
            got, new_r = tq.grad_bucket_reduce(tree, r, SCALE, bits=bits, block_size=block)
            out[f"bucket{int(ef)}.a"], out[f"bucket{int(ef)}.b"] = got["a"], got["b"]
            out[f"bucket{int(ef)}.payload"] = sent[0]
            if ef:
                out["bucket1.resid"] = new_r
            sent.clear()
            kw = dict(bits=bits, block_size=block, mean=True)
            if ef:
                red, nr = tq.qreduce_scatter(t["flat"], residual=t["flat.resid"] * SCALE, **kw)
                out["flat1.resid"] = nr / SCALE
            else:
                red = tq.qreduce_scatter(t["flat"], **kw)
            out[f"flat{int(ef)}"] = tq.qall_gather(red, bits=bits, block_size=block)
            out[f"flat{int(ef)}.payload"] = sent[0]
    finally:
        comm.all_to_all = real
    return out


def digest(tensors):
    """sha256 of the tensors' bytes, as a uint8 array (ranks compare these)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)


def micro():
    """Each rank's rows of the global batch."""
    from deepspeed_tpu_torch.comm import comm

    return GLOBAL_B // comm.get_world_size()


def make_engine(cfg, state0=None, seed=0):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import bridge
    from deepspeed_tpu_torch.models import gpt

    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu",
                                                seed=seed)
    if state0 is not None:
        fresh = {k: v for k, v in engine.state.items() if k.startswith("qgrad")}
        engine.load_state({**bridge.train_state_from_numpy(state0, "cpu",
                                                           policy=engine.zero_policy), **fresh})
    return engine


def run_case(rank, name, state0, out):
    """3 steps of a case; per step the loss, the grad norm and a digest of
    the params; then this rank's slices and the joined state."""
    from deepspeed_tpu_torch import bridge
    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths
    from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    zero, opt, extra = CASES[name]
    engine = make_engine(config(zero, opt, micro=micro(), **extra), state0)
    wire_ledger.reset()
    losses, norms, digests = [], [], []
    for step, b in enumerate(batches(name)):
        if step == 0 and name.startswith("q_"):
            # step 1's exchanged gradients: one micro-step through the
            # imperative API, read before the boundary
            loss = engine.forward(b)
            engine.backward()
            for k, g in zip((k for k, _ in flatten_with_paths(engine.state["params"])),
                            engine._grad_acc):
                out[f"{name}.grad1.{k}"] = g.detach().clone()
            engine.step()
            m = engine._last_metrics
            m["loss"] = loss.detach()
        else:
            m = engine.train_batch(b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        digests.append(digest(tree_leaves(engine.state["params"])))
    out[f"{name}.losses"] = torch.tensor(losses, dtype=torch.float64)
    out[f"{name}.grad_norms"] = torch.tensor(norms, dtype=torch.float64)
    out[f"{name}.digests"] = torch.stack(digests)
    local = {"master": engine.state["master"], "mu": engine.state["opt"].mu,
             "nu": engine.state["opt"].nu}
    for tree_name, tree in local.items():
        for k, v in flatten_with_paths(tree):
            out[f"{name}.local.{tree_name}.{k}"] = v.detach().clone()
    for k, v in flatten_with_paths(engine.state["params"]):
        out[f"{name}.params.{k}"] = v.detach().clone()
    out[f"{name}.opt_bytes"] = torch.tensor(sum(
        t.numel() * t.element_size() for t in tree_leaves(local)))
    full = bridge.train_state_to_numpy(engine.state, specs=engine.param_specs,
                                       opt_specs=engine.opt_specs)
    for k, v in flatten_with_paths({"params": full["params"], "mu": full["opt"].mu}):
        out[f"{name}.full.{k}"] = torch.from_numpy(np.ascontiguousarray(v))
    for key in ("qgrad_residual", "qgrad_bucket_residual"):
        if key in engine.state:
            out[f"{name}.{key}"] = engine.state[key].clone()
            out[f"{name}.{key}.full"] = torch.from_numpy(full[key])
    for op, row in wire_ledger.summary_dict().items():
        out[f"{name}.ledger.{op}"] = torch.tensor([row["count"], row["ratio"]])
    return engine


def run_fp16_overflow_on_one_rank(rank, out):
    """fp16 at stage 2: rank 1 alone finds an inf in its slice of the
    reduced gradients; the min-reduced flag makes both ranks skip."""
    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    engine = make_engine(config({"stage": 2}, micro=micro(), fp16={"enabled": True}))
    before = digest(tree_leaves(engine.state["params"]))
    engine.forward(batches("s2")[0])
    engine.backward()
    keys = [k for k, _ in flatten_with_paths(engine.state["params"])]
    if rank == 1:  # the last row of wte is rank 1's slice after the reduce-scatter
        engine._grad_acc[keys.index("wte")][-1, 0] = float("inf")
    engine.step()
    out["fp16.overflow"] = torch.tensor(float(engine._last_metrics["overflow"]))
    out["fp16.skipped"] = torch.tensor(engine.skipped_steps)
    out["fp16.unchanged"] = torch.tensor(bool(torch.equal(
        before, digest(tree_leaves(engine.state["params"])))))
    m = engine.train_batch(batches("s2")[1])
    out["fp16.next_overflow"] = torch.tensor(float(m["overflow"]))


def run_checkpoints(rank, engine, ckpt, state0, out):
    """The qgrad + EF engine's tag after step 3; the same-world reload keeps
    every slice and the residual rows; a mid-accumulation tag at gas 2."""
    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths

    engine.save_checkpoint(ckpt)
    again = make_engine(config(CASES["q_bucket_ef"][0], micro=micro()), seed=1)
    again.load_checkpoint(ckpt)
    out["reload_bitwise"] = torch.tensor(all(
        torch.equal(a.detach(), b.detach()) for (_, a), (_, b) in
        zip(flatten_with_paths(engine.state), flatten_with_paths(again.state))))
    m = again.train_batch(batches("q_bucket_ef")[0])
    out["reload_next_loss"] = torch.tensor(float(m["loss"]))
    # mid-accumulation at gas 2 x micro 1 a rank: one step, then half a window
    cfg = config({"stage": 2}, micro=1, gas=2)
    mid = make_engine(cfg, state0)
    b = batches("s2")
    mid.train_batch({"input_ids": b[0]["input_ids"].reshape(2, 2, SEQ)})
    mid.forward({"input_ids": b[1]["input_ids"][:2]})
    mid.backward()
    mid.save_checkpoint(os.path.join(ckpt, "mid"), tag="mid")
    same = make_engine(cfg, seed=1)
    same.load_checkpoint(os.path.join(ckpt, "mid"), tag="mid")
    out["mid_same_world_micro"] = torch.tensor(int(same.state["micro"]))
    out["mid_same_world_acc"] = torch.tensor(same._grad_acc is not None)


def rank_main(rank, world, init_file, out_dir, inputs):
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths
    from deepspeed_tpu_torch.comm import comm

    comm.init_distributed(init_method=f"file://{init_file}", world_size=world, rank=rank,
                          device="cpu")
    comm.configure(enabled=True)
    out = run_exchanges(rank, inputs["exchange"])
    engines = {name: run_case(rank, name, inputs["state0"], out) for name in CASES}
    run_fp16_overflow_on_one_rank(rank, out)
    ckpt = os.path.join(out_dir, "ckpt")
    run_checkpoints(rank, engines["q_bucket_ef"], ckpt, inputs["state0"], out)
    # the world-1 tag the parent saved loads into both ranks: each gets its slices
    w1 = make_engine(config(CASES["q_bucket_ef"][0], micro=micro()), seed=2)
    w1.load_checkpoint(os.path.join(out_dir, "world1"))
    for k, v in flatten_with_paths({"params": w1.state["params"], "mu": w1.state["opt"].mu,
                                    "master": w1.state["master"]}):
        out[f"w1load.{k}"] = v.detach().clone()
    out["w1load.resid_zero"] = torch.tensor(
        not w1.state["qgrad_residual"].any() and not w1.state["qgrad_bucket_residual"].any())
    out["w1load.cursor"] = torch.tensor(w1.data_cursor)
    comm.barrier()
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if v.dtype in (torch.uint8, torch.float64, torch.int64,
                                                      torch.bool)
                    else v.detach().float().numpy()) for k, v in out.items()})
