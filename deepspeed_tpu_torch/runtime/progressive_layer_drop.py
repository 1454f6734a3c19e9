"""Progressive layer drop, the host-side schedule (counterpart of
``deepspeed_tpu/runtime/progressive_layer_drop.py``).

``theta(t) = (1 - theta) * exp(-gamma * t) + theta`` decays the global keep
probability from 1 toward ``theta``. The engine hands the model
``theta(step)`` at the count of steps taken before the current one, and
this tracker follows it after each step (``update_state(global_steps)``),
for ``get_state`` and the monitor's ``Train/pld_theta``, as the reference's
does.
"""

from __future__ import annotations

import math

from ..utils.logging import log_dist


def pld_theta(theta: float, gamma: float, step: int) -> float:
    """The keep probability at ``step``."""
    return (1.0 - theta) * math.exp(-gamma * float(step)) + theta


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = float(theta)
        self.gamma = float(gamma)
        self.current_theta = 1.0
        log_dist(f"Enabled progressive layer dropping (theta = {self.theta})")

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> None:
        self.current_theta = pld_theta(self.theta, self.gamma, global_step)
