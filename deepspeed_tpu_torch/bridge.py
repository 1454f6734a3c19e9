"""Carries parameter trees and training state between the JAX package and
the port as numpy arrays.

The port keeps the reference's leaf names, its layer-stacked ``[L, ...]``
leaves and its ``x @ W`` layout (``qkv_w`` is ``[L, d, 3d]``), so a tree
crosses over leaf by leaf with no reshaping: a test hands both packages the
same weights, and parity never depends on matching random streams. The
optimizer states (``AdamState(count, mu, nu)``, ``AdagradState``,
``SGDState``) and the loss scaler's ``ScalerState`` keep the reference's
field names too, so a whole engine state crosses over
(:func:`train_state_from_numpy` / :func:`train_state_to_numpy`). The JAX
side's NamedTuples are read by their field names; nothing here imports JAX.

Under ZeRO a rank holds slices (the parameters at stage 3, the master copy
and the optimizer state from stage 1): ``train_state_from_numpy(...,
policy=engine.zero_policy)`` cuts a full state into this rank's slices, and
``train_state_to_numpy(state, specs=engine.param_specs,
opt_specs=engine.opt_specs)`` joins every rank's slices back into the full
state (a collective: every rank calls it). The error-feedback residuals
cross too: a rank holds its row of the reference's global arrays (the
quantized gradient exchange's ``[W, npad]`` / ``[L, W, npad_l]``, the 1-bit
optimizers' ``onebit`` ``worker_error`` [W, Np] and ``server_error`` [W,
Np / W]), and so does the eigenvalue probe's ``curvature`` [n_layer].
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .accelerator import resolve_device
from .comm import comm
from .models import gpt as gpt_mod
from .ops.optimizers import AdagradState, AdamState, SGDState
from .runtime.precision import ScalerState
from .runtime.zero.reshard import RESIDUAL_RANK_AXIS, get_path, set_path
from .utils.tree import tree_map


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, as JAX hands it over: carry the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """A nested dict of numpy arrays -> the same dict of tensors on ``device``
    (default: the CUDA device). ``dtype`` casts the floating-point leaves;
    quantized ``{"q"|"q4", "s"}`` leaves cross whole (int8 payloads, fp32
    scales), as the engines keep them."""
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node)

    return gpt_mod.cast_params(convert(tree), resolve_device(device), dtype)


def params_to_numpy(params: Any) -> Any:
    """The inverse of :func:`params_from_numpy`. bfloat16 leaves come back as
    float32 (an exact widening), since numpy has no bfloat16 of its own."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


# optimizer-state NamedTuples by their field names (the same on both sides)
_OPT_STATES = {cls._fields: cls for cls in (AdamState, AdagradState, SGDState)}


def _scalar(a: Any, device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)


def opt_state_from_numpy(state: Any, device=None) -> Any:
    """An optimizer state (a NamedTuple with the reference's fields, numpy or
    JAX leaves) -> the port's NamedTuple on ``device``: the int32 step count,
    fp32 moment trees. An empty dict (the offload runners keep the optimizer
    state on the host) stays one."""
    dev = resolve_device(device)
    if isinstance(state, dict) and not state:
        return {}
    cls = _OPT_STATES.get(tuple(state._fields))
    if cls is None:
        raise TypeError(f"unknown optimizer state fields {state._fields}")
    return cls(**{f: (_scalar(v, dev, torch.int32) if f == "count" else
                      None if v is None else params_from_numpy(v, dev, torch.float32))
                  for f, v in zip(state._fields, state)})


def opt_state_to_numpy(state: Any) -> Any:
    """The inverse of :func:`opt_state_from_numpy`: the same NamedTuple type
    with numpy leaves."""
    if isinstance(state, dict) and not state:
        return {}
    return type(state)(*(None if v is None else params_to_numpy(v) for v in state))


def scaler_state_from_numpy(state: Any, device=None) -> ScalerState:
    dev = resolve_device(device)
    return ScalerState(scale=_scalar(state.scale, dev, torch.float32),
                       good_steps=_scalar(state.good_steps, dev, torch.int32),
                       hysteresis=_scalar(state.hysteresis, dev, torch.int32))


def scaler_state_to_numpy(state: ScalerState) -> ScalerState:
    return ScalerState(*(np.asarray(t.detach().cpu().numpy()) for t in state))


def _map_opt(state: Any, fn) -> Any:
    """``fn`` over the parameter-shaped trees of an optimizer state."""
    if isinstance(state, dict) and not state:
        return {}
    return type(state)(*(v if (v is None or f == "count") else fn(v)
                         for f, v in zip(state._fields, state)))


def map_param_trees(state: Dict[str, Any], fn, opt_fn=None) -> Dict[str, Any]:
    """``fn`` over the parameter-shaped trees of a train state: ``params``,
    ``master`` (when there is one) and the optimizer state's moments;
    ``opt_fn`` (default ``fn``) takes the master copy and the moments."""
    opt_fn = opt_fn or fn
    return {**state, "params": fn(state["params"]),
            "master": opt_fn(state["master"]) if state["master"] else {},
            "opt": _map_opt(state["opt"], opt_fn)}


def join_tree(tree: Any, specs: Any) -> Any:
    """Every rank's slices of a parameter-shaped tree joined into the full
    leaves, in their dtype (a collective: every rank calls it)."""
    return tree_map(lambda t, d: t.detach() if d is None else comm.all_gather(t.detach(), axis=d),
                    tree, specs)


def join_state(state: Dict[str, Any], specs: Any, opt_specs: Any = None) -> Dict[str, Any]:
    """:func:`join_tree` over every parameter-shaped tree of a train state
    (the master copy and the moments by ``opt_specs``, default ``specs``),
    and every rank's error-feedback residual row joined into the global
    array."""
    opt_specs = specs if opt_specs is None else opt_specs
    out = map_param_trees(state, lambda tree: join_tree(tree, specs),
                          lambda tree: join_tree(tree, opt_specs))
    for key, axis in RESIDUAL_RANK_AXIS.items():
        row = get_path(state, key)
        if row is not None:
            set_path(out, key, comm.all_gather(row.detach(), axis=axis))
    return out


def train_state_from_numpy(state: Dict[str, Any], device=None,
                           dtype: Optional[torch.dtype] = None,
                           policy: Any = None) -> Dict[str, Any]:
    """A whole engine state {params, master, opt, step, micro, scaler} with
    numpy (or JAX) leaves -> the port's, on ``device``. ``dtype`` is the
    compute dtype of ``params`` (default: as given); the master copy and the
    optimizer state are fp32. ``policy`` (a ``ZeroShardingPolicy``, the
    engine's ``zero_policy``) cuts every parameter-shaped tree to this
    rank's slices (the params by ``param_spec``, the master copy and the
    moments by ``opt_spec``) and each error-feedback residual to its row."""
    dev = resolve_device(device)
    state = {**state, "master": state.get("master") or {}}
    if policy is not None:
        specs = policy.tree_param_specs(state["params"])
        opt_specs = policy.tree_opt_specs(state["params"])
        state = map_param_trees(
            state, lambda tree: policy.shard_tree(tree_map(np.asarray, tree), specs),
            lambda tree: policy.shard_tree(tree_map(np.asarray, tree), opt_specs))
        for key, axis in RESIDUAL_RANK_AXIS.items():
            if get_path(state, key) is not None:
                set_path(state, key, policy.shard(np.asarray(get_path(state, key)), axis))
    master = state["master"]
    out = {
        "params": params_from_numpy(state["params"], dev, dtype),
        "master": params_from_numpy(master, dev, torch.float32) if master else {},
        "opt": opt_state_from_numpy(state["opt"], dev),
        "step": _scalar(state["step"], dev, torch.int32),
        "micro": _scalar(state["micro"], dev, torch.int32),
        "scaler": scaler_state_from_numpy(state["scaler"], dev),
    }
    for key in (*RESIDUAL_RANK_AXIS, "curvature"):
        if get_path(state, key) is not None:
            set_path(out, key, _tensor(get_path(state, key)).to(device=dev, dtype=torch.float32))
    return out


def train_state_to_numpy(state: Dict[str, Any], specs: Any = None,
                         opt_specs: Any = None) -> Dict[str, Any]:
    """The inverse of :func:`train_state_from_numpy` (bf16 leaves widen to
    fp32). ``specs`` (the engine's ``param_specs``) and ``opt_specs`` (its
    ``opt_specs``, default ``specs``) join every rank's slices into the full
    leaves first, and the residuals' rows into their global arrays."""
    if specs is not None:
        state = join_state(state, specs, opt_specs)
    out = {
        "params": params_to_numpy(state["params"]),
        "master": params_to_numpy(state["master"]) if state["master"] else {},
        "opt": opt_state_to_numpy(state["opt"]),
        "step": state["step"].cpu().numpy(),
        "micro": state["micro"].cpu().numpy(),
        "scaler": scaler_state_to_numpy(state["scaler"]),
    }
    for key in (*RESIDUAL_RANK_AXIS, "curvature"):
        if get_path(state, key) is not None:
            set_path(out, key, get_path(state, key).detach().cpu().numpy())
    return out
