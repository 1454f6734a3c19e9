"""Per-layer top Hessian eigenvalue by power iteration (counterpart of
``deepspeed_tpu/runtime/eigenvalue.py``), the curvature that stretches the
MoQ quantization schedule per layer (``compression/compress.py``).

Models stack their per-layer parameters along a leading ``L`` axis (one
``blocks`` subtree of ``[L, ...]`` leaves), so a layer is a slice of that
subtree. The Hessian-vector product is restricted to one layer's slice:
reverse over reverse, ``torch.autograd.grad(..., create_graph=True)`` and
then the gradient of ``<g, v>``, with the slice an fp32 copy put back into
the stacked leaves in their dtype. The power iteration runs on the host, a
diagnostic the engine runs every ``gas_boundary_resolution``-th step, not
part of the step itself.

A model whose kernels refuse double differentiation (``FlashAttention`` and
``BlocksparseAttention`` raise ``NotImplementedError`` in a backward that
builds a graph) makes :meth:`Eigenvalue.compute` raise; the engine then logs
and disables the probe, as the reference's does where its attention is a
``custom_vjp`` kernel.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.logging import log_dist
from ..utils.tree import tree_leaves, tree_unflatten


def _resolve_path(tree, dotted: str):
    """Follow a dotted key path into a tree of dicts; None if absent."""
    node = tree
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return None
    return node


def _set_path(tree, dotted: str, value):
    parts = dotted.split(".")
    out = dict(tree)
    node = out
    for part in parts[:-1]:
        node[part] = dict(node[part])
        node = node[part]
    node[parts[-1]] = value
    return out


def _inner(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum over leaves of <a, b> in fp32."""
    return sum(torch.vdot(x.reshape(-1).float(), y.reshape(-1).float()) for x, y in zip(a, b))


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


class Eigenvalue:
    """The top Hessian eigenvalue of each layer block.

    ``max_iter`` / ``tol`` bound the power iteration, ``stability``
    regularizes the normalization, ``layer_name`` is the dotted path of the
    stacked layer subtree in the parameter tree (falling back to
    ``"blocks"``), ``layer_num`` optionally checks the layer count."""

    def __init__(self, max_iter: int = 100, tol: float = 1e-2, stability: float = 1e-6,
                 gas_boundary_resolution: int = 1, layer_name: str = "blocks",
                 layer_num: int = 0, verbose: bool = False):
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.stability = float(stability)
        self.gas_boundary_resolution = max(int(gas_boundary_resolution), 1)
        self.layer_name = layer_name
        self.layer_num = int(layer_num)
        self.verbose = verbose

    @classmethod
    def from_config(cls, cfg) -> "Eigenvalue":
        return cls(max_iter=cfg.max_iter, tol=cfg.tol, stability=cfg.stability,
                   gas_boundary_resolution=cfg.gas_boundary_resolution,
                   layer_name=cfg.layer_name, layer_num=cfg.layer_num, verbose=cfg.verbose)

    def _blocks(self, params) -> Tuple[str, Any, int]:
        name = self.layer_name
        sub = _resolve_path(params, name)
        if sub is None and name != "blocks":
            name, sub = "blocks", _resolve_path(params, "blocks")
        if sub is None:
            raise ValueError(f"eigenvalue: no stacked layer subtree at '{self.layer_name}' "
                             "(or 'blocks') in the parameter tree")
        leaves = tree_leaves(sub)
        n_layer = int(leaves[0].shape[0])
        if any(leaf.shape[0] != n_layer for leaf in leaves):
            raise ValueError(f"eigenvalue: leaves under '{name}' disagree on the leading "
                             "(layer) dimension")
        if self.layer_num and self.layer_num != n_layer:
            raise ValueError(f"eigenvalue: layer_num={self.layer_num} but subtree '{name}' "
                             f"stacks {n_layer} layers")
        return name, sub, n_layer

    def hvp(self, loss_fn: Callable, params, batch, i: int,
            v: List[torch.Tensor]) -> List[torch.Tensor]:
        """The Hessian of ``loss_fn`` with respect to layer ``i``'s slice of
        the stacked subtree, times ``v`` (fp32 leaves in the subtree's
        :func:`tree_leaves` order), at ``params``."""
        name, blocks, _ = self._blocks(params)
        leaves = tree_leaves(blocks)
        theta = [a[i].detach().float().requires_grad_(True) for a in leaves]
        with torch.enable_grad():
            stacked = [torch.cat([a[:i].detach(), t.to(a.dtype)[None], a[i + 1:].detach()])
                       for a, t in zip(leaves, theta)]
            p = _set_path(params, name, tree_unflatten(blocks, stacked))
            loss = loss_fn(p) if batch is None else loss_fn(p, batch)
            g = torch.autograd.grad(loss, theta, create_graph=True)
            return list(torch.autograd.grad(_inner(g, v), theta))

    def one_iter(self, loss_fn: Callable, params, batch, i: int, v: List[torch.Tensor],
                 reduce: Optional[Callable] = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """One power-iteration step from ``v``: (the next unit vector, the
        Rayleigh quotient <Hv, v>). ``reduce`` maps the product first."""
        hv = [_finite(x) for x in self.hvp(loss_fn, params, batch, i, v)]
        if reduce is not None:
            hv = reduce(hv)
        ev = _inner(hv, v)
        norm = torch.sqrt(_inner(hv, hv)) + self.stability
        return [_finite(x / norm) for x in hv], ev

    def start_vectors(self, params, generator: Optional[torch.Generator] = None
                      ) -> List[List[np.ndarray]]:
        """Each layer's unnormalized start vector (standard normal draws per
        leaf of the subtree, fp32), from ``generator`` (a CPU generator seeded
        17 when None, the counterpart of the reference's ``PRNGKey(17)``)."""
        _, blocks, n_layer = self._blocks(params)
        gen = generator if generator is not None else torch.Generator().manual_seed(17)
        return [[torch.randn(tuple(a.shape[1:]), generator=gen, dtype=torch.float32).numpy()
                 for a in tree_leaves(blocks)] for _ in range(n_layer)]

    def compute(self, loss_fn: Callable, params, generator: Optional[torch.Generator] = None,
                batch=None, start_vectors: Optional[Sequence[Sequence[np.ndarray]]] = None,
                reduce: Optional[Callable[[List[torch.Tensor]], List[torch.Tensor]]] = None
                ) -> np.ndarray:
        """The normalized (``[0, 1]``) top Hessian eigenvalue of each layer.

        ``loss_fn(params)`` (or ``loss_fn(params, batch)`` with ``batch``)
        must be twice differentiable. ``start_vectors`` (numpy, one list of
        leaves a layer, as :meth:`start_vectors` draws them) replace the draws
        from ``generator``. ``reduce`` maps each layer's Hessian-vector product
        before its use (the engine's mean over data-parallel ranks)."""
        _, blocks, n_layer = self._blocks(params)
        device = tree_leaves(blocks)[0].device
        if start_vectors is None:
            start_vectors = self.start_vectors(params, generator)
        raw: List[float] = []
        for i in range(n_layer):
            v = [torch.as_tensor(np.asarray(x, np.float32), device=device)
                 for x in start_vectors[i]]
            norm = torch.sqrt(_inner(v, v)) + self.stability
            v = [x / norm for x in v]
            ev_cur, ev_prev, it = 1.0, 0.0, 0
            while (it < self.max_iter and abs(ev_cur) > 0
                   and abs((ev_cur - ev_prev) / ev_cur) >= self.tol):
                ev_prev = ev_cur
                v, ev = self.one_iter(loss_fn, params, batch, i, v, reduce)
                ev_cur = float(ev)
                it += 1
            raw.append(ev_cur)
            if self.verbose:
                log_dist(f"eigenvalue: layer {i}, {it} iterations, eigenvalue {ev_cur:.4e}")
        return self.post_process(raw)

    @staticmethod
    def post_process(values: List[float]) -> np.ndarray:
        """Eigenvalues mapped to ``[0, 1]`` by the largest ``|ev|``; a layer
        that gave 0 (no curvature signal at this precision) maps to 1.0, the
        most conservative schedule."""
        arr = np.asarray(values, np.float32)
        max_abs = float(np.max(np.abs(arr))) if arr.size else 0.0
        if max_abs == 0.0:
            return np.ones_like(arr)
        out = np.abs(arr) / max_abs
        out[arr == 0.0] = 1.0
        return out
