"""A training worker of the port for the kill tests: the tiny GPT on the CPU,
a committed save after every step, the ``resilience`` block on (auto-resume,
the drain handlers). Faults come from ``DS_FAULT_PLAN``: the worker holds no
fault code, so the kill lands in the save path production runs.

Exit codes: 0 at ``--steps``; 83 after a drain; -9 when the plan's SIGKILL
fired. ``--out-state`` writes the final state (``bridge.train_state_to_numpy``)
as an ``.npz`` for a bitwise comparison.
"""

import argparse
import os
import sys


def batch(step: int):
    import numpy as np

    return {"input_ids": np.random.default_rng(1000 + step).integers(0, 64, (2, 16),
                                                                      dtype=np.int64)}


def make_engine(ckpt_dir, **res):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt

    model, _ = gpt.build(gpt.GPTConfig(vocab_size=64, n_layer=2, n_head=2, d_model=32,
                                       max_seq_len=32))
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}, "steps_per_print": 0,
           "resilience": {"enabled": True, "save_dir": str(ckpt_dir), **res}}
    return dt.initialize(model=model, config=cfg, device="cpu", seed=0)[0]


def flat_state(engine):
    from deepspeed_tpu_torch import bridge

    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
        elif hasattr(node, "_fields"):
            for f in node._fields:
                walk(f"{prefix}/{f}", getattr(node, f))
        else:
            import numpy as np

            out[prefix] = np.asarray(node)

    walk("", bridge.train_state_to_numpy(engine.state))
    return out


def run(ckpt_dir, steps, out_state=None, **res):
    """Train to ``steps``, saving after each; returns the engine."""
    import numpy as np

    engine = make_engine(ckpt_dir, **res)
    while engine.global_steps < steps:
        engine.train_batch(batch(engine.global_steps))
        engine.save_checkpoint(str(ckpt_dir))
    if out_state:
        np.savez(out_state, **flat_state(engine))
    return engine


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--out-state", default=None)
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    run(args.ckpt_dir, args.steps, args.out_state, install_signal_handlers=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
