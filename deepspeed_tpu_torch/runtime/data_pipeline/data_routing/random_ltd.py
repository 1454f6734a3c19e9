"""Random layer-wise token dropping, random-LTD (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_routing/random_ltd.py``).

During training the listed layers see only a random subset of ``keep``
tokens of each row, in their order; their outputs are scattered back into
the full hidden stream, so the dropped tokens pass those layers unchanged.
The kept count grows on a schedule (:class:`RandomLTDScheduler`) until the
layers see every token.

The draw is split from the gather: :func:`random_ltd_indices` draws each
row's sorted subset from an explicit ``torch.Generator`` (uniform scores,
the ``keep`` smallest), and :func:`random_ltd_gather` /
:func:`random_ltd_scatter` take given indices, so a test can hand them the
indices the reference drew. The streams differ from ``jax.random``'s.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch


def random_ltd_indices(batch: int, seq: int, keep: int,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
    """[batch, keep] int64: each row's ``keep`` of ``seq`` positions, drawn
    uniformly without replacement, in ascending order."""
    dev = generator.device if generator is not None else device
    scores = torch.rand((batch, seq), generator=generator, device=dev)
    idx = torch.argsort(scores, dim=1)[:, :keep]
    return torch.sort(idx, dim=1).values


def random_ltd_gather(x: torch.Tensor, keep: int, generator: Optional[torch.Generator] = None,
                      idx: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> (x_kept [B, keep, D], idx [B, keep]); ``idx`` is drawn
    from ``generator`` unless given."""
    B, T, D = x.shape
    if idx is None:
        idx = random_ltd_indices(B, T, keep, generator, device=x.device)
    idx = idx.to(device=x.device, dtype=torch.int64)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, D)), idx


def random_ltd_scatter(x_kept: torch.Tensor, idx: torch.Tensor,
                       x_full: torch.Tensor) -> torch.Tensor:
    """``x_full`` with the rows of ``x_kept`` written at ``idx``: the
    positions outside ``idx`` keep ``x_full``'s values. Out of place, so both
    inputs get gradients."""
    D = x_full.shape[-1]
    return x_full.scatter(1, idx[:, :, None].expand(-1, -1, D), x_kept.to(x_full.dtype))


def random_ltd_layer(layer_fn, x: torch.Tensor, keep: int,
                     generator: Optional[torch.Generator] = None, *args,
                     idx: Optional[torch.Tensor] = None, **kwargs) -> torch.Tensor:
    """``layer_fn`` on a random ``keep``-token subset of ``x`` (or on the
    subset ``idx``); the other tokens pass through. ``keep >= T`` runs the
    layer on all of ``x``."""
    if idx is None and keep >= x.shape[1]:
        return layer_fn(x, *args, **kwargs)
    kept, idx = random_ltd_gather(x, keep, generator, idx=idx)
    return random_ltd_scatter(layer_fn(kept, *args, **kwargs), idx, x)


class RandomLTDScheduler:
    """The kept-token schedule, from the reference's ``"random_ltd"`` block:

    {"total_layer_num": 24, "random_ltd_layer_num": 22,
     "random_ltd_layer_id": [...],
     "random_ltd_schedule": {"min_value": 128, "max_value": 2048,
        "schedule_type": "fixed_linear",
        "schedule_config": {"seq_per_step": 16, "require_steps": 10000}}}

    The value rises linearly from ``min_value`` to ``max_value`` over
    ``require_steps`` steps, in steps of ``seq_per_step`` (128 keeps the
    LTD layers on the attention kernels, which take lengths divisible by
    128)."""

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        sched = config.get("random_ltd_schedule", {})
        self.min_value = int(sched.get("min_value", 128))
        self.max_value = int(sched.get("max_value", 1024))
        cfg = sched.get("schedule_config", {})
        self.seq_per_step = int(cfg.get("seq_per_step", 16))
        self.require_steps = int(cfg.get("require_steps", 1000))
        self.layer_ids = list(config.get("random_ltd_layer_id", []))
        self.current_value = self.min_value

    def get_value(self, global_steps: int) -> int:
        frac = min(1.0, global_steps / max(1, self.require_steps))
        v = self.min_value + (self.max_value - self.min_value) * frac
        v = int(v / self.seq_per_step) * self.seq_per_step
        return max(self.min_value, min(self.max_value, v))

    def update(self, global_steps: int) -> int:
        self.current_value = self.get_value(global_steps)
        return self.current_value

    def state_dict(self) -> Dict[str, Any]:
        return {"current_value": self.current_value}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.current_value = int(sd["current_value"])
