"""The rank side of ``tests/test_torch_zero3_dist.py``: run in processes
started with the ``spawn`` method, on gloo. It imports no JAX (the parent
computes the JAX results), so a rank never inherits JAX's threads.
"""

import os

import numpy as np
import torch

CONFIG = {"train_batch_size": 4,
          "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
          "gradient_clipping": 1.0, "steps_per_print": 0,
          "zero_optimization": {"stage": 3, "zero_quantized_weights": True,
                                "zero_quantized_head": True,
                                "stage3_param_persistence_threshold": 0}}
TINY = dict(vocab_size=300, n_layer=2, n_head=4, d_model=64, max_seq_len=64)


def train(engine, batches):
    """(losses, grad norms) of one train_batch per batch."""
    metrics = [engine.train_batch(b) for b in batches]
    return ([float(m["loss"]) for m in metrics], [float(m["grad_norm"]) for m in metrics])


def first_layer(engine):
    """Layer 0's parameters as the model's stage-3 gather gives them."""
    from deepspeed_tpu_torch.runtime.zero.gather import gather_window, zero3_layers

    with torch.no_grad(), gather_window(engine.config.zero_optimization,
                                        engine.param_specs.get("blocks")):
        return {k: v.numpy() for k, v in next(zero3_layers(engine.state["params"]["blocks"]))[1]
                .items()}


def rank_main(rank, world, init_file, out_dir, inputs):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import bridge
    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths
    from deepspeed_tpu_torch.comm import comm, quantized as tq
    from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
    from deepspeed_tpu_torch.models import gpt

    comm.init_distributed(init_method=f"file://{init_file}", world_size=world, rank=rank,
                          device="cpu")
    out = {}
    t = {k: torch.from_numpy(np.array(v[rank])) for k, v in inputs["collectives"].items()}
    out["qall_gather"] = tq.qall_gather(t["ag"], axis=0, tiled=True)
    for mean in (False, True):
        out[f"qreduce_scatter_mean{int(mean)}"] = tq.qreduce_scatter(t["rs"], axis=0, mean=mean)
    out["qreduce_scatter_resid"], out["qreduce_scatter_new_resid"] = tq.qreduce_scatter(
        t["rs"], axis=0, residual=t["resid"], bits=4, block_size=64)
    out["qall_to_all"] = tq.qall_to_all(t["a2a"], split_axis=0, concat_axis=1)
    out["broadcast"] = comm.broadcast(t["ag"], src_index=1)
    out["all_reduce_max"] = comm.all_reduce(t["ag"], op="max")

    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={**CONFIG, "comms_logger": {"enabled": True}}, device="cpu", seed=0)
    engine.load_state(bridge.train_state_from_numpy(inputs["state"], "cpu",
                                                    policy=engine.zero_policy))
    out["qkv_w_slice_rows"] = torch.tensor(engine.state["params"]["blocks"]["qkv_w"].shape[1])
    for k, v in first_layer(engine).items():
        out[f"layer0.{k}"] = torch.from_numpy(v)
    ckpt = os.path.join(out_dir, "ckpt")
    engine.save_checkpoint(ckpt, tag="init")  # every rank's slices joined, rank 0 writes
    losses, norms = train(engine, inputs["batches"])
    out["losses"], out["grad_norms"] = torch.tensor(losses), torch.tensor(norms)
    full = bridge.train_state_to_numpy(engine.state, specs=engine.param_specs)
    for k, v in full["params"].items():
        if k != "blocks":
            out[f"final.{k}"] = torch.from_numpy(v)
    out["final.blocks.qkv_w"] = torch.from_numpy(full["params"]["blocks"]["qkv_w"])
    out["final.opt.mu.wte"] = torch.from_numpy(full["opt"].mu["wte"])
    # the trained state saved at dp2 and loaded back into an engine from another seed
    engine.save_checkpoint(ckpt)
    reloaded, *_ = deepspeed_tpu_torch.initialize(model=model, config=CONFIG, device="cpu",
                                                  seed=1)
    reloaded.load_checkpoint(ckpt)
    out["reload_slices_bitwise"] = torch.tensor(all(
        torch.equal(a.detach(), b.detach()) for (_, a), (_, b) in
        zip(flatten_with_paths(engine.state), flatten_with_paths(reloaded.state))))
    out["reload_layer0_bitwise"] = torch.tensor(all(
        np.array_equal(first_layer(engine)[k], v) for k, v in first_layer(reloaded).items()))
    out["wire_ratio_qgather"] = torch.tensor(wire_ledger.ratio("qgather[zero3]"))
    out["reduce_scatter_calls"] = torch.tensor(
        comm.comms_logger.records["reduce_scatter[dp]"].count)
    comm.barrier()
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.detach().float().numpy() for k, v in out.items()})
