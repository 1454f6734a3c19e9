"""A child process for tests/test_torch_infinity.py: a tiny GPT trained by
the port's ZeRO-Infinity parameter stream on the CPU with the ``resilience``
block on (auto-resume), saving after every step. Faults come from
``DS_FAULT_PLAN`` in the environment: ``kill_at_phase: "host-shard:N"``
SIGKILLs the process inside the real per-unit host-state flush.

    python _torch_offload_worker.py --ckpt-dir D --steps N --log L.jsonl

Exit codes: 0 at --steps; -9 / 137 where the plan's SIGKILL fired.
"""

import argparse
import json
import os
import sys


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--log", default=None)
    p.add_argument("--prefetch-depth", type=int, default=2)
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt

    model, _ = gpt.build(gpt.GPTConfig(vocab_size=64, n_layer=3, n_head=2, d_model=32,
                                       max_seq_len=32))
    engine = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
        "steps_per_print": 0,
        "zero_optimization": {"offload_param": {"device": "cpu", "buffer_count": 1,
                                                "prefetch_depth": args.prefetch_depth}},
        "resilience": {"enabled": True, "save_dir": args.ckpt_dir,
                       "install_signal_handlers": False},
    })[0]
    while engine.global_steps < args.steps:
        r = np.random.default_rng(1000 + engine.global_steps)
        m = engine.train_batch({"input_ids": r.integers(0, 64, (2, 16)).astype(np.int32)})
        if args.log:
            with open(args.log, "a") as f:
                f.write(json.dumps({"step": engine.global_steps, "loss": float(m["loss"]),
                                    "grad_norm": float(m["grad_norm"])}) + "\n")
        engine.save_checkpoint(args.ckpt_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
