"""The JAX engine and the port's engine from the same state, each with its
own ``resilience.save_dir``, and the cursor-driven loop and event trail the
health and integrity parity tests compare."""

import math

import numpy as np
import torch

import deepspeed_tpu
import deepspeed_tpu.resilience as jres
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu_torch.models import gpt

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=64)
LOSS_RTOL = 1e-5  # fp32, the engine parity tests' bar
# the fields of an event both packages must agree on (times and latencies aside)
TRAIL_FIELDS = ("cursor", "skip_cursors", "from_step", "source", "reason", "domain", "unit",
                "block", "op", "data_cursor", "phase")


def _config(save_dir, res=None, **over):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}, "steps_per_print": 0,
           "resilience": {"enabled": True, "save_dir": str(save_dir),
                          "install_signal_handlers": False, **(res or {})}}
    cfg.update(over)
    return cfg


def batch_for(cursor: int):
    return {"input_ids": np.random.default_rng(1000 + cursor).integers(0, 256, (2, 32),
                                                                       dtype=np.int32)}


def engines(tmp_path, res=None, **over):
    """A JAX engine and a port engine, each with its own save_dir, from the
    same state: the JAX engine's initial state saved into the port's
    directory, which the port's auto-resume loads."""
    jmodel, _ = build_gpt(JaxGPTConfig(**TINY))
    jeng = deepspeed_tpu.initialize(
        model=jmodel, config=JaxDeepSpeedConfig.load(_config(tmp_path / "jax", res, **over),
                                                     world_size=1),
        topology=MeshTopology.single_device(), seed=0)[0]
    jeng.save_checkpoint(str(tmp_path / "port"))
    model, _ = gpt.build(gpt.GPTConfig(**TINY))
    teng = deepspeed_tpu_torch.initialize(model=model, config=_config(tmp_path / "port", res,
                                                                      **over),
                                          device="cpu", seed=0)[0]
    assert teng.global_steps == 0 and teng.data_cursor == 0
    return jeng, teng


def drive(engine, steps: int):
    """The cursor-driven loop rollback assumes: ``[(global_steps, cursor,
    loss or None, what happened)]`` per call."""
    out = []
    while engine.global_steps < steps:
        m = engine.train_batch(batch_for(engine.data_cursor))
        what = ("skip" if m.get("skipped_batch") else
                "rollback" if m.get("health", {}).get("rolled_back") else
                m.get("health", {}).get("wire", "step"))
        loss = float(np.asarray(m["loss"].detach() if torch.is_tensor(m["loss"])
                                else m["loss"])) if what in ("step", "demoted",
                                                             "repromoted") else None
        out.append((engine.global_steps, engine.data_cursor, loss, what))
    return out


def trail(save_dir):
    return [(e["event"], e["step"]) + tuple((k, e[k]) for k in TRAIL_FIELDS if k in e)
            for e in jres.read_events(str(save_dir))
            if e["event"] not in ("tag_rejected_on_load",)]


def assert_same_run(jrun, trun):
    assert [r[:2] + r[3:] for r in jrun] == [r[:2] + r[3:] for r in trun]
    for (_, _, a, _), (_, _, b, _) in zip(jrun, trun):
        if a is not None:
            assert math.isfinite(b) == math.isfinite(a)
            if math.isfinite(a):
                assert abs(a - b) <= LOSS_RTOL * abs(a), (a, b)


