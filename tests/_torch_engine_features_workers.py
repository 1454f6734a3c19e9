"""The rank side of the data-parallel loader test in
``tests/test_torch_data_pipeline.py``: each rank builds its engine through
``initialize(training_data=...)`` on gloo, in a process started with the
``spawn`` method, and takes 3 steps from the loader. It imports no JAX (the
parent computes the JAX results)."""

import os

import numpy as np
import torch

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=64)
SEQ = 32
MICRO = 2  # rows a rank
STEPS = 3
N_SAMPLES = 10  # 2 global batches of 4 an epoch: step 3 wraps it


def dataset():
    rng = np.random.default_rng(31)
    return [{"input_ids": rng.integers(0, TINY["vocab_size"], SEQ, dtype=np.int32)}
            for _ in range(N_SAMPLES)]


def config():
    return {"train_micro_batch_size_per_gpu": MICRO,
            "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "steps_per_print": 0, "zero_optimization": {"stage": 1}}


def rank_main(rank, world, init_file, out_dir, state0):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import bridge
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    comm.init_distributed(init_method=f"file://{init_file}", world_size=world, rank=rank,
                          device="cpu")
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, config=config(), training_data=dataset(), device="cpu", seed=0)
    engine.load_state(bridge.train_state_from_numpy(state0, "cpu", policy=engine.zero_policy))
    out = {}
    it = RepeatingLoader(loader)
    for step in range(STEPS):
        batch = next(it)
        out[f"batch{step}"] = batch["input_ids"]
        out[f"rows{step}"] = engine._place_batch(batch)["input_ids"].numpy()
        out[f"loss{step}"] = np.float32(engine.train_batch(batch)["loss"].item())
    comm.barrier()
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"loader_rank{rank}.npz"), **out)
