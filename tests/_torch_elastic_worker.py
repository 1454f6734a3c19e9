"""An elastic training worker of the port, launched by ``DSElasticAgent``:
``--world`` gloo ranks on the CPU (this process is rank 0 and starts the
others), the tiny GPT at ZeRO stage 1 with the ``elasticity`` block (the
global batch of 8 fixed: micro 4 x gas 8 / (4 x world)) and ``resilience``
(a committed tag after every step, the watchdog's straggler exchange and
the integrity spot check's vote every step). The batch of data cursor c is
the same 8 rows at every world size.

``DS_FAULT_PLAN`` reaches the ranks named by ``--fault-ranks``. When a rank
dies by a signal (a lost device), rank 0 writes ``world - 1`` to
``--world-file``, the device count the agent reads, and exits 1. Rank 0
appends ``{"step", "world", "loss", "gas"}`` to ``--log`` after
each step.
"""

import argparse
import json
import os
import subprocess
import sys

ELASTICITY = {"enabled": True, "max_train_batch_size": 8, "micro_batch_sizes": [4],
              "min_world_size": 1, "max_world_size": 2}


def global_batch(cursor: int):
    import numpy as np

    return np.random.default_rng(500 + cursor).integers(0, 64, (8, 16), dtype=np.int64)


def config(ckpt_dir):
    return {"optimizer": {"type": "Adam", "params": {"lr": 1e-2}}, "steps_per_print": 0,
            "zero_optimization": {"stage": 1}, "elasticity": dict(ELASTICITY),
            "resilience": {"enabled": True, "save_dir": str(ckpt_dir),
                           "install_signal_handlers": False,
                           "sentinel": {"enabled": True, "warmup_steps": 1,
                                        "checkpoint_interval": 1},
                           "watchdog": {"enabled": True, "straggler_check_every": 1},
                           "integrity": {"enabled": True, "spot_check_interval": 1}}}


def train(engine, steps, log=None):
    """The cursor-driven loop; each step's batch laid out [gas, micro, T]."""
    losses = {}
    gas = engine.gradient_accumulation_steps()
    while engine.global_steps < steps:
        rows = global_batch(engine.data_cursor)
        ids = rows.reshape(gas, -1, rows.shape[-1]) if gas > 1 else rows
        m = engine.train_batch({"input_ids": ids})
        losses[engine.global_steps] = float(m["loss"])
        if log:
            with open(log, "a") as f:
                f.write(json.dumps({"step": engine.global_steps, "world": engine.world_size,
                                    "loss": losses[engine.global_steps],
                                    "gas": gas}) + "\n")
    return losses


def build(ckpt_dir):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt

    model, _ = gpt.build(gpt.GPTConfig(vocab_size=64, n_layer=2, n_head=2, d_model=32,
                                       max_seq_len=32))
    return dt.initialize(model=model, config=config(ckpt_dir), device="cpu", seed=0)[0]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--log", required=True)
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world-file", default=None)
    p.add_argument("--fault-ranks", default="")
    p.add_argument("--store", default=None)
    args = p.parse_args()
    os.makedirs(args.ckpt_dir, exist_ok=True)
    # one rendezvous file per launch, named by rank 0
    store = args.store or os.path.join(args.ckpt_dir, f"store_w{args.world}_{os.getpid()}")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    fault_ranks = {int(r) for r in args.fault_ranks.split(",") if r}
    plan = os.environ.pop("DS_FAULT_PLAN", None)
    if plan and args.rank in fault_ranks:
        os.environ["DS_FAULT_PLAN"] = plan
    peers = []
    if args.rank == 0:
        for r in range(1, args.world):
            env = dict(os.environ)
            if plan:
                env["DS_FAULT_PLAN"] = plan
            peers.append(subprocess.Popen(
                [sys.executable, __file__, "--ckpt-dir", args.ckpt_dir, "--log", args.log,
                 "--steps", str(args.steps), "--world", str(args.world), "--rank", str(r),
                 "--fault-ranks", args.fault_ranks, "--store", store], env=env))
    import torch

    torch.set_num_threads(1)
    from deepspeed_tpu_torch.comm import comm

    if args.world > 1:
        comm.init_distributed(init_method=f"file://{store}", world_size=args.world,
                              rank=args.rank, device="cpu", timeout_s=60)
    rc = 0
    try:
        engine = build(args.ckpt_dir)
        train(engine, args.steps, args.log if args.rank == 0 else None)
    except Exception as e:  # a lost peer breaks the collectives
        print(f"rank {args.rank}: {type(e).__name__}: {e}", file=sys.stderr)
        rc = 1
    for peer in peers:
        try:
            code = peer.wait(timeout=60)
        except subprocess.TimeoutExpired:
            peer.kill()
            code = peer.wait()
        if code < 0 and args.world_file:  # killed by a signal: its device is gone
            with open(args.world_file, "w") as f:
                f.write(str(args.world - 1))
        rc = rc or (1 if code else 0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
