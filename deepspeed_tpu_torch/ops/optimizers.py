"""Optimizers (counterpart of ``deepspeed_tpu/ops/optimizers.py``).

The reference's interface is kept: ``init(params) -> state`` and
``update(grads, state, params, lr) -> (params, state)``, with the same state
layouts (``AdamState(count, mu, nu)`` and the others), so a JAX optimizer
state crosses over through :mod:`deepspeed_tpu_torch.bridge` unchanged.
``lr`` is a float or a 0-dim tensor; the optimizer never reads a value back
to the host.

Each update is written over the whole list of leaves with
``torch._foreach_*``: a few multi-tensor launches per operation instead of
one launch per tensor per operation. This is the eager counterpart of what
XLA fuses in the reference, in plain PyTorch. The math follows the
reference's order of operations in fp32 (bias correction from the integer
step count; decoupled weight decay added to the step).

Unlike the reference, ``update`` works IN PLACE: the fp32 leaves of
``params`` and the state's tensors are updated where they are (saving a
second copy of the model and its moments), and the same trees are returned.
Leaves of another dtype (bf16 params without a master copy) are updated in
fp32 and copied back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from ..utils.errors import unported
from ..utils.tree import tree_leaves, tree_map

Params = Any
Grads = Any
State = Any
LR = Union[float, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optimizer: ``init(params) -> state`` and
    ``update(grads, state, params, lr) -> (params, state)``."""

    init: Callable[[Params], State]
    update: Callable[[Grads, State, Params, LR], Tuple[Params, State]]
    name: str = "optimizer"


class AdamState(NamedTuple):
    count: torch.Tensor  # i32 scalar: updates taken
    mu: Params
    nu: Params


def _zeros_like(params, fill: float = 0.0):
    return tree_map(lambda p: torch.full(p.shape, fill, dtype=torch.float32, device=p.device),
                    params)


def _fp32(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """fp32 views of the leaves: the leaf itself when it is fp32, else a copy."""
    return [t if t.dtype == torch.float32 else t.float() for t in tensors]


def _apply(params: List[torch.Tensor], p32: List[torch.Tensor], step: List[torch.Tensor],
           lr: LR) -> None:
    """params -= lr * step, in fp32; leaves that are not fp32 get the result
    copied back in their own dtype."""
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(p32, step)
    for p, q in zip(params, p32):
        if q is not p:
            p.copy_(q)


def _bias_corrections(count: torch.Tensor, betas: Tuple[float, ...], enabled: bool):
    """1 - beta**count in fp32 for each beta (ones when disabled)."""
    cf = count.to(torch.float32)
    if not enabled:
        return [torch.ones_like(cf) for _ in betas]
    return [1.0 - torch.pow(b, cf) for b in betas]


def _adam_moments(g: List[torch.Tensor], mu: List[torch.Tensor], nu: List[torch.Tensor],
                  b1: float, b2: float) -> None:
    """mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, in place."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))


def _adam_direction(mu, nu, bc1, bc2, eps: float) -> List[torch.Tensor]:
    """(mu / bc1) / (sqrt(nu / bc2) + eps), a new list."""
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(mu, bc1)
    torch._foreach_div_(step, denom)
    return step


def fused_adam(
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    adam_w_mode: bool = True,
    bias_correction: bool = True,
) -> Optimizer:
    """Adam/AdamW (the reference's ``fused_adam``)."""
    b1, b2 = betas

    def init(params):
        device = tree_leaves(params)[0].device
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                         mu=_zeros_like(params), nu=_zeros_like(params))

    def update(grads, state, params, lr):
        count = state.count + 1
        bc1, bc2 = _bias_corrections(count, (b1, b2), bias_correction)
        leaves = tree_leaves(params)
        p32 = _fp32(leaves)
        g = _fp32(tree_leaves(grads))
        if weight_decay and not adam_w_mode:  # L2-style
            g = torch._foreach_add(g, torch._foreach_mul(p32, weight_decay))
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        _adam_moments(g, mu, nu, b1, b2)
        step = _adam_direction(mu, nu, bc1, bc2, eps)
        if weight_decay and adam_w_mode:  # decoupled
            torch._foreach_add_(step, torch._foreach_mul(p32, weight_decay))
        _apply(leaves, p32, step, lr)
        return params, AdamState(count=count, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update, name="FusedAdam")


def fused_lamb(
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_coeff: float = 10.0,
    min_coeff: float = 0.01,
    bias_correction: bool = True,
) -> Optimizer:
    """LAMB with a per-tensor trust ratio (the reference's ``fused_lamb``)."""
    b1, b2 = betas

    def init(params):
        device = tree_leaves(params)[0].device
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                         mu=_zeros_like(params), nu=_zeros_like(params))

    def update(grads, state, params, lr):
        count = state.count + 1
        bc1, bc2 = _bias_corrections(count, (b1, b2), bias_correction)
        leaves = tree_leaves(params)
        p32 = _fp32(leaves)
        g = _fp32(tree_leaves(grads))
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        _adam_moments(g, mu, nu, b1, b2)
        upd = _adam_direction(mu, nu, bc1, bc2, eps)
        if weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(p32, weight_decay))
        w_norm = torch.stack(torch._foreach_norm(p32))
        u_norm = torch.stack(torch._foreach_norm(upd))
        trust = torch.where((w_norm > 0) & (u_norm > 0),
                            torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
                            torch.ones_like(w_norm))
        torch._foreach_mul_(upd, list(trust.unbind()))
        _apply(leaves, p32, upd, lr)
        return params, AdamState(count=count, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update, name="FusedLamb")


class AdagradState(NamedTuple):
    count: torch.Tensor
    accum: Params


def adagrad(eps: float = 1e-10, weight_decay: float = 0.0,
            initial_accumulator_value: float = 0.0) -> Optimizer:
    """Adagrad (the reference's ``adagrad``)."""

    def init(params):
        device = tree_leaves(params)[0].device
        return AdagradState(count=torch.zeros((), dtype=torch.int32, device=device),
                            accum=_zeros_like(params, initial_accumulator_value))

    def update(grads, state, params, lr):
        leaves = tree_leaves(params)
        p32 = _fp32(leaves)
        g = _fp32(tree_leaves(grads))
        if weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p32, weight_decay))
        accum = tree_leaves(state.accum)
        torch._foreach_add_(accum, torch._foreach_mul(g, g))
        denom = torch._foreach_sqrt(accum)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(g, denom)
        _apply(leaves, p32, step, lr)
        return params, AdagradState(count=state.count + 1, accum=state.accum)

    return Optimizer(init=init, update=update, name="Adagrad")


class SGDState(NamedTuple):
    momentum: Optional[Params]


def sgd(momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD with optional (Nesterov) momentum (the reference's ``sgd``)."""

    def init(params):
        return SGDState(momentum=_zeros_like(params) if momentum else None)

    def update(grads, state, params, lr):
        leaves = tree_leaves(params)
        p32 = _fp32(leaves)
        g = _fp32(tree_leaves(grads))
        if weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p32, weight_decay))
        if momentum:
            m = tree_leaves(state.momentum)
            torch._foreach_mul_(m, momentum)
            torch._foreach_add_(m, g)
            step = (torch._foreach_add(g, torch._foreach_mul(m, momentum)) if nesterov
                    else [t.clone() for t in m])
        else:
            step = [t.clone() for t in g]
        _apply(leaves, p32, step, lr)
        return params, state

    return Optimizer(init=init, update=update, name="SGD")


# --------------------------------------------------------------------------- registry
def get_optimizer(name: str, params: Dict[str, Any]) -> Optimizer:
    """Build an optimizer from a DeepSpeed ``"optimizer"`` config block (the
    reference's name dispatch). The 1-bit optimizers are not ported yet."""
    name_l = name.lower()
    opts = {k: v for k, v in params.items() if k != "lr"}
    betas = tuple(opts.get("betas", (0.9, 0.999)))
    eps = opts.get("eps", 1e-8)
    wd = opts.get("weight_decay", 0.0)
    if name_l in ("adam", "adamw", "fusedadam"):
        return fused_adam(betas=betas, eps=eps, weight_decay=wd,
                          adam_w_mode=(name_l != "adam") or opts.get("adam_w_mode", True),
                          bias_correction=opts.get("bias_correction", True))
    if name_l in ("onebitadam", "zerooneadam", "onebitlamb"):
        raise unported(f"the 1-bit optimizer {name!r}", "A3b")
    if name_l in ("lamb", "fusedlamb"):
        return fused_lamb(betas=betas, eps=eps, weight_decay=wd,
                          max_coeff=opts.get("max_coeff", 10.0),
                          min_coeff=opts.get("min_coeff", 0.01))
    if name_l == "adagrad":
        return adagrad(eps=opts.get("eps", 1e-10), weight_decay=wd)
    if name_l == "sgd":
        return sgd(momentum=opts.get("momentum", 0.0), weight_decay=wd,
                   nesterov=opts.get("nesterov", False))
    raise ValueError(f"unknown optimizer type {name!r}")
