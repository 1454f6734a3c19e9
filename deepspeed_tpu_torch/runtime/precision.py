"""Mixed precision: bf16 master-weight training and fp16 dynamic loss scaling
(counterpart of ``deepspeed_tpu/runtime/precision.py``).

The precision policy decides the dtypes; the engine wires the cast points.
The loss scaler is a small state machine of 0-dim tensors (scale, good-step
counter, hysteresis budget) evolved with ``torch.where`` on the device, so
it needs no host synchronisation; the engine skips an overflowing step as
the reference's ``_boundary_step`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Resolved precision mode for the engine."""

    compute_dtype: torch.dtype  # dtype params are stored/computed in (bf16/fp16/fp32)
    master_weights: bool  # keep an fp32 master copy in the train state
    loss_scaling: bool  # fp16-style loss scaling with overflow skip
    initial_scale: float = 2.0 ** 16
    scale_window: int = 1000
    hysteresis: int = 2
    min_scale: float = 1.0
    static_scale: Optional[float] = None
    # True: refill the hysteresis budget after every good step; False
    # (default): the budget stays depleted until the scale grows
    consecutive_hysteresis: bool = False

    @classmethod
    def from_ds_config(cls, cfg) -> "PrecisionConfig":
        if cfg.bf16.enabled:
            return cls(compute_dtype=torch.bfloat16, master_weights=cfg.bf16.master_weights,
                       loss_scaling=False)
        if cfg.fp16.enabled:
            return cls(
                compute_dtype=torch.float16, master_weights=True,
                loss_scaling=True,  # static or dynamic, fp16 always scales + overflow-skips
                initial_scale=2.0 ** cfg.fp16.initial_scale_power,
                scale_window=cfg.fp16.loss_scale_window,
                hysteresis=cfg.fp16.hysteresis,
                min_scale=cfg.fp16.min_loss_scale,
                static_scale=None if cfg.fp16.dynamic_loss_scale else cfg.fp16.loss_scale,
                consecutive_hysteresis=cfg.fp16.consecutive_hysteresis)
        return cls(compute_dtype=torch.float32, master_weights=False, loss_scaling=False)


_WIRE_DTYPES = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32,
                "float16": torch.float16, "bfloat16": torch.bfloat16,
                "float32": torch.float32}


def validate_comm_dtype(comm_dt: Optional[str], compute_dtype: torch.dtype) -> None:
    """``communication_data_type``: the gradient wire dtype equals the compute
    dtype, as in the reference; a request for any other dtype is refused
    rather than silently unhonored."""
    if not comm_dt:
        return
    want = _WIRE_DTYPES.get(comm_dt)
    if want is None:
        raise ValueError(f"communication_data_type={comm_dt!r}: unknown dtype")
    if want != compute_dtype:
        raise ValueError(
            f"communication_data_type={comm_dt}: the gradient wire dtype equals the "
            f"compute dtype ({compute_dtype}) — a request for {want} cannot be "
            "honored. Set the training dtype to match the wire request.")


class ScalerState(NamedTuple):
    scale: torch.Tensor  # f32 scalar
    good_steps: torch.Tensor  # i32 consecutive non-overflow steps
    hysteresis: torch.Tensor  # i32 remaining tolerated overflows before a scale cut


def init_scaler_state(pc: PrecisionConfig, device=None) -> ScalerState:
    scale = pc.static_scale if pc.static_scale else pc.initial_scale
    return ScalerState(scale=torch.tensor(scale, dtype=torch.float32, device=device),
                       good_steps=torch.zeros((), dtype=torch.int32, device=device),
                       hysteresis=torch.tensor(pc.hysteresis, dtype=torch.int32,
                                               device=device))


def grads_finite(grads) -> torch.Tensor:
    """0-dim bool: every gradient entry is finite."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def update_scaler(pc: PrecisionConfig, state: ScalerState, finite: torch.Tensor) -> ScalerState:
    """Dynamic loss-scale evolution (the reference's ``DynamicLossScaler``).

    With a static scale the scale never moves; overflow steps are still
    skipped by the engine."""
    if not pc.loss_scaling or pc.static_scale is not None:
        return state
    full = torch.full_like(state.hysteresis, pc.hysteresis)
    zero = torch.zeros_like(state.good_steps)
    # a good step: grow the scale after scale_window of them
    grown = state.good_steps + 1 >= pc.scale_window
    good_scale = torch.where(grown, state.scale * 2.0, state.scale)
    good_steps = torch.where(grown, zero, state.good_steps + 1)
    good_hyst = full if pc.consecutive_hysteresis else torch.where(grown, full, state.hysteresis)
    # an overflow: cut the scale once the hysteresis budget is spent
    cut = state.hysteresis <= 1
    bad_scale = torch.where(cut, torch.clamp(state.scale / 2.0, min=pc.min_scale), state.scale)
    bad_hyst = torch.clamp(state.hysteresis - 1, min=0)
    return ScalerState(scale=torch.where(finite, good_scale, bad_scale),
                       good_steps=torch.where(finite, good_steps, zero),
                       hysteresis=torch.where(finite, good_hyst, bad_hyst))


def cast_to_compute(params: Dict[str, Any], pc: PrecisionConfig) -> Dict[str, Any]:
    """The tree with every floating-point leaf cast to the compute dtype."""
    return tree_map(lambda p: p.to(pc.compute_dtype) if p.is_floating_point() else p, params)


def make_master(params: Dict[str, Any], pc: PrecisionConfig) -> Optional[Dict[str, Any]]:
    """fp32 master copy (or None when params are already full precision)."""
    if not pc.master_weights:
        return None
    return tree_map(lambda p: p.to(torch.float32, copy=True) if p.is_floating_point() else p,
                    params)
