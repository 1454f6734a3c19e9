"""Curriculum learning difficulty scheduler (counterpart of
``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``).

Maps the global step to a difficulty value (typically the sequence length)
under one of the reference's schedule types: ``fixed_linear``,
``fixed_root``, ``fixed_discrete``, ``custom``. Pure host-side math, the
reference's to the bit. The engine truncates the batch's sequence keys to
the value (``curriculum_type`` ``seqlen``); the attention kernels take only
sequence lengths divisible by 128, so a ``difficulty_step`` of 128 keeps
every step on them (other lengths run the plain attention path).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:
    """Config schema follows the reference's ``"curriculum_learning"`` block:

    {"enabled": true, "curriculum_type": "seqlen", "min_difficulty": 8,
     "max_difficulty": 1024, "schedule_type": "fixed_linear",
     "schedule_config": {"total_curriculum_step": 10000, "difficulty_step": 8}}
    """

    def __init__(self, config: Dict[str, Any]):
        self.state: Dict[str, Any] = {}
        self.curriculum_type = config.get("curriculum_type", "seqlen")
        self.min_difficulty = int(config.get("min_difficulty", 1))
        self.max_difficulty = int(config.get("max_difficulty", 1))
        self.schedule_type = config.get("schedule_type", FIXED_LINEAR)
        cfg = config.get("schedule_config", {})
        self.current_difficulty = self.min_difficulty
        self.first_step = True
        self._custom_fn: Optional[Callable[[int], int]] = None

        if self.schedule_type in (FIXED_LINEAR, FIXED_ROOT):
            self.total_curriculum_step = int(cfg.get("total_curriculum_step", 1000))
            self.difficulty_step = int(cfg.get("difficulty_step", 8))
            self.root_degree = int(cfg.get("root_degree", 2)) \
                if self.schedule_type == FIXED_ROOT else 1
        elif self.schedule_type == FIXED_DISCRETE:
            self.difficulties = list(cfg.get("difficulty", [self.max_difficulty]))
            self.max_steps = list(cfg.get("max_step", []))
            if len(self.max_steps) != len(self.difficulties) - 1:
                raise ValueError(
                    "fixed_discrete: need len(max_step) == len(difficulty) - 1")
        elif self.schedule_type == CUSTOM:
            pass  # set via set_custom_get_difficulty
        else:
            raise ValueError(f"unknown schedule_type {self.schedule_type!r}")

    def set_custom_get_difficulty(self, fn: Callable[[int], int]) -> None:
        """The custom schedule's ``global_steps -> difficulty`` callback."""
        self._custom_fn = fn

    def get_difficulty(self, global_steps: int) -> int:
        if self.schedule_type == CUSTOM:
            if self._custom_fn is None:
                raise RuntimeError("custom schedule requires set_custom_get_difficulty")
            return int(self._custom_fn(global_steps))
        if self.schedule_type == FIXED_DISCRETE:
            for d, s in zip(self.difficulties, self.max_steps):
                if global_steps <= s:
                    return int(d)
            return int(self.difficulties[-1])
        # fixed_linear / fixed_root: min + (max-min) * (t/T)^(1/root)
        frac = min(1.0, global_steps / max(1, self.total_curriculum_step))
        frac = frac ** (1.0 / self.root_degree)
        diff = self.min_difficulty + (self.max_difficulty - self.min_difficulty) * frac
        # quantize to difficulty_step
        diff = int(diff / self.difficulty_step) * self.difficulty_step
        return max(self.min_difficulty, min(self.max_difficulty, diff))

    def update_difficulty(self, global_steps: int) -> int:
        self.current_difficulty = self.get_difficulty(global_steps)
        return self.current_difficulty

    def get_current_difficulty(self) -> int:
        return self.current_difficulty

    def state_dict(self) -> Dict[str, Any]:
        return {"current_difficulty": self.current_difficulty}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.current_difficulty = int(sd["current_difficulty"])
