"""Learning-rate schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``).

Each schedule is a pure ``step -> lr`` function of the count of optimizer
steps taken before this one, evaluated on the host (the engine knows that
count without asking the device); the engine hands the result to the
optimizer as a 0-dim tensor. ``LRScheduler`` keeps the reference's
``step()`` / ``get_lr()`` surface.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

VALID_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR", "WarmupCosineLR"]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


# ----------------------------------------------------------------- pure schedules
def warmup_lr(base_lr: float, warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log") -> Callable:
    warmup_num_steps = max(warmup_num_steps, 2)

    def fn(step) -> float:
        step = float(step)
        if warmup_type == "log":
            # log(1+step)/log(1+N), the reference's default
            gamma = _clip(math.log1p(step) / math.log(1 + warmup_num_steps), 0.0, 1.0)
        else:
            gamma = _clip(step / warmup_num_steps, 0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return fn


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Callable:
    wfn = warmup_lr(warmup_max_lr, warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def fn(step) -> float:
        step = float(step)
        if step < warmup_num_steps:
            return wfn(step)
        decay = _clip((total_num_steps - step) / max(total_num_steps - warmup_num_steps, 1),
                      0.0, 1.0)
        return warmup_max_lr * decay

    return fn


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 1e-4,
                     base_lr: float = 0.001) -> Callable:
    def fn(step) -> float:
        step = float(step)
        if step < warmup_num_steps:
            ratio = warmup_min_ratio + (1 - warmup_min_ratio) * _clip(
                step / max(warmup_num_steps, 1), 0.0, 1.0)
        else:
            progress = _clip((step - warmup_num_steps) / max(total_num_steps - warmup_num_steps, 1),
                             0.0, 1.0)
            ratio = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (1 + math.cos(math.pi * progress))
        return base_lr * ratio

    return fn


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None, decay_step_size: int = 0,
              decay_lr_rate: float = 0.0, **_unused) -> Callable:
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    cycle_len = cycle_first_step_size + second

    def fn(step) -> float:
        step = float(step)
        if step <= cycle_first_step_size:
            up = _clip(step / cycle_first_step_size, 0.0, 1.0)
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up
        if step <= cycle_len:
            down = _clip((step - cycle_first_step_size) / max(second, 1), 0.0, 1.0)
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down
        post = step - cycle_len
        decay = (1.0 / (1.0 + decay_lr_rate * post / max(decay_step_size, 1))
                 if decay_step_size > 0 else 1.0)
        return cycle_min_lr * decay

    return fn


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Callable:
    def fn(step) -> float:
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return fn


_FACTORY = {
    "WarmupLR": lambda p: warmup_lr(
        base_lr=p.get("warmup_max_lr", 0.001),
        warmup_min_lr=p.get("warmup_min_lr", 0.0),
        warmup_max_lr=p.get("warmup_max_lr", 0.001),
        warmup_num_steps=p.get("warmup_num_steps", 1000),
        warmup_type=p.get("warmup_type", "log")),
    "WarmupDecayLR": lambda p: warmup_decay_lr(
        total_num_steps=p.get("total_num_steps", 10000),
        warmup_min_lr=p.get("warmup_min_lr", 0.0),
        warmup_max_lr=p.get("warmup_max_lr", 0.001),
        warmup_num_steps=p.get("warmup_num_steps", 1000),
        warmup_type=p.get("warmup_type", "log")),
    "WarmupCosineLR": lambda p: warmup_cosine_lr(
        total_num_steps=p.get("total_num_steps", 10000),
        warmup_min_ratio=p.get("warmup_min_ratio", 0.0),
        warmup_num_steps=p.get("warmup_num_steps", 1000),
        cos_min_ratio=p.get("cos_min_ratio", 1e-4),
        base_lr=p.get("warmup_max_lr", p.get("base_lr", 0.001))),
    "OneCycle": lambda p: one_cycle(
        cycle_min_lr=p.get("cycle_min_lr", 0.0),
        cycle_max_lr=p.get("cycle_max_lr", 0.001),
        cycle_first_step_size=p.get("cycle_first_step_size", 2000),
        cycle_second_step_size=p.get("cycle_second_step_size"),
        decay_step_size=p.get("decay_step_size", 0),
        decay_lr_rate=p.get("decay_lr_rate", 0.0)),
    "LRRangeTest": lambda p: lr_range_test(
        lr_range_test_min_lr=p.get("lr_range_test_min_lr", 1e-3),
        lr_range_test_step_size=p.get("lr_range_test_step_size", 2000),
        lr_range_test_step_rate=p.get("lr_range_test_step_rate", 1.0),
        lr_range_test_staircase=p.get("lr_range_test_staircase", False)),
}


def schedule_fn_from_config(sched_type: str, params: dict) -> Callable:
    if sched_type not in _FACTORY:
        raise ValueError(f"unknown scheduler {sched_type!r}; valid: {VALID_SCHEDULES}")
    return _FACTORY[sched_type](params)


class LRScheduler:
    """Stateful wrapper keeping the reference's step()/get_lr() surface."""

    def __init__(self, fn: Callable, last_step: int = 0):
        self.fn = fn
        self.last_step = last_step

    def step(self, increment: int = 1) -> None:
        self.last_step += increment

    def get_lr(self) -> List[float]:
        return [float(self.fn(self.last_step))]

    def get_last_lr(self) -> List[float]:
        return self.get_lr()

    def state_dict(self) -> dict:
        return {"last_step": self.last_step}

    def load_state_dict(self, sd: dict) -> None:
        self.last_step = int(sd["last_step"])


def WarmupLR(optimizer=None, **params) -> LRScheduler:
    return LRScheduler(_FACTORY["WarmupLR"](params))


def WarmupDecayLR(optimizer=None, **params) -> LRScheduler:
    return LRScheduler(_FACTORY["WarmupDecayLR"](params))


def WarmupCosineLR(optimizer=None, **params) -> LRScheduler:
    return LRScheduler(_FACTORY["WarmupCosineLR"](params))


def OneCycle(optimizer=None, **params) -> LRScheduler:
    return LRScheduler(_FACTORY["OneCycle"](params))


def LRRangeTest(optimizer=None, **params) -> LRScheduler:
    return LRScheduler(_FACTORY["LRRangeTest"](params))
