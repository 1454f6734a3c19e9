"""ZeRO-3 gathers: each layer's parameters gathered just before it runs
(counterpart of ``deepspeed_tpu/runtime/zero/gather.py``).

The engine binds its ``zero_optimization`` block, and the split dimension of
each layer-stacked leaf, around the forward (:func:`gather_window`); the
model walks its layers through :func:`zero3_layers`, which yields each
layer's parameters gathered from the ranks' slices: at full precision
(:class:`AllGatherShards`) or, with ``zero_quantized_weights``, as int
payloads through ``comm/quantized.py`` ``quantized_reshard``. Both are
autograd functions whose backward mean-reduces the gathered leaf's gradient
back to its owners' slices. Without a bound stage-3 config a layer is its
slice of the stacked leaves, as at stages 0-2.

``window_size`` picks how many layers one gather covers, from
``stage3_prefetch_bucket_size`` and ``stage3_max_live_parameters``, as the
reference's does. The reference's default schedule (``overlap_comm``)
software-pipelines the gathers inside its ``lax.scan``: window i + d is
issued while window i computes. That moves only where a gather is issued,
and the reference's docstring states that its forward is bitwise the inline
schedule's. The port accepts ``overlap_comm`` and
``overlap_prefetch_depth`` and runs the inline schedule, one gather per
window issued just before the window runs (op name ``qgather[zero3]``); the
prefetch on a side stream is ROADMAP.md A9c. The reference's scan is also
where its per-layer gradient buckets are issued, inside the backward; the
port's engine exchanges them after the backward (``runtime/engine.py``),
and issuing them during it is A9c as well.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ...comm import comm
from ...comm.quantized import QuantizedCommConfig, quantized_reshard, shard_grad
from ...utils.logging import warning_once

_state = threading.local()


def _active_cfg():
    return getattr(_state, "cfg", None)


def _active_dims() -> Dict[str, Optional[int]]:
    return getattr(_state, "dims", None) or {}


@contextlib.contextmanager
def gather_window(zero_config, shard_dims: Optional[Dict[str, Optional[int]]] = None):
    """Bind the ZeRO config for the duration of a forward (engine-internal).
    ``shard_dims`` maps each layer-stacked leaf's name to the dimension of
    the stacked leaf that the ranks of the default process group split
    (None or absent: whole on every rank)."""
    prev = (getattr(_state, "cfg", None), getattr(_state, "dims", None))
    _state.cfg, _state.dims = zero_config, shard_dims
    try:
        yield
    finally:
        _state.cfg, _state.dims = prev


def _stage3() -> bool:
    cfg = _active_cfg()
    return cfg is not None and int(getattr(cfg, "stage", 0)) >= 3


def window_size(blocks: Dict[str, torch.Tensor], L: int) -> int:
    """Layers per gather window, from the bound config: with an explicitly
    set ``stage3_prefetch_bucket_size`` (elements),
    ``k = clamp(prefetch // per_layer, 1, min(L, max_live // per_layer))``,
    rounded down to a divisor of L; 1 otherwise (the minimal-residency
    per-layer schedule). ``per_layer`` counts this rank's elements of a layer."""
    cfg = _active_cfg()
    if not _stage3() or "stage3_prefetch_bucket_size" not in getattr(cfg, "fields_set", ()):
        return 1
    prefetch = int(cfg.stage3_prefetch_bucket_size or 0)
    max_live = int(cfg.stage3_max_live_parameters or 0)
    per_layer = sum(v.numel() for v in blocks.values()) // max(1, L)
    if per_layer <= 0 or prefetch <= 0:
        return 1
    cap = min(L, max(1, max_live // per_layer)) if max_live > 0 else L
    k = max(1, min(cap, prefetch // per_layer))
    while L % k:  # the largest divisor of L within the budget
        k -= 1
    if k > 1:
        warning_once(f"ZeRO-3 gather windowing: {k} layers per gather window (prefetch_bucket "
                     f"{prefetch}, max_live {max_live}, {per_layer} params/layer)")
    return k


def _quantization() -> Optional[QuantizedCommConfig]:
    """The quantized-weights config for stage-3 gathers, or None."""
    cfg = _active_cfg()
    if not _stage3() or not getattr(cfg, "zero_quantized_weights", False):
        return None
    return QuantizedCommConfig.from_zero_config(cfg)


class AllGatherShards(torch.autograd.Function):
    """Full-precision gather of a leaf's slices along ``dim`` (None: the leaf
    is whole on every rank, and the forward is the identity); the backward
    mean-reduces the gradient to the slices (``comm.quantized.shard_grad``)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return x if dim is None else comm.all_gather(x, group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return shard_grad(g, ctx.dim, ctx.group), None, None


def gather_leaf(x: torch.Tensor, dim: Optional[int], group=None) -> torch.Tensor:
    return AllGatherShards.apply(x, dim, group)


def _gather_layer(tree: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                  qc: Optional[QuantizedCommConfig],
                  op_name: str = "qgather[zero3]") -> Dict[str, torch.Tensor]:
    """Gather a window of layers (leaves ``[k, ...]``) from the ranks'
    slices: through the quantized wire when ``qc`` is set, else at full
    precision."""
    if qc is None:
        return {k: gather_leaf(v, dims.get(k)) for k, v in tree.items()}
    return {k: quantized_reshard(v, dims.get(k), None, qc.bits, qc.block_size, op_name)
            for k, v in tree.items()}


def zero3_layers(blocks: Dict[str, torch.Tensor]) -> Iterator[Tuple[int, Dict[str, Any]]]:
    """Yield ``(i, layer i's parameters)`` for the layer-stacked ``blocks``.
    Under a bound stage-3 config each window of layers is gathered (and,
    with ``zero_quantized_weights``, sent over the int wire) just before its
    first layer runs; otherwise layer i is ``blocks[...][i]``. Autograd keeps
    a gathered window until the backward has used it (the reference's XLA
    may gather it again instead), so what stage 3 saves here is the stored
    slices of the parameters, the master copy and the optimizer state."""
    L = next(iter(blocks.values())).shape[0]
    if not _stage3():
        for i in range(L):
            yield i, {k: v[i] for k, v in blocks.items()}
        return
    k = window_size(blocks, L)
    qc, dims = _quantization(), _active_dims()
    for w in range(L // k):
        window = _gather_layer({n: v[w * k:(w + 1) * k] for n, v in blocks.items()}, dims, qc)
        for j in range(k):
            yield w * k + j, {n: v[j] for n, v in window.items()}


def prefetch_schedule(n: int, depth: int):
    """The software-pipelined issue / consume order of ``n`` units at
    ``depth`` (the reference's): yields ``("issue", i)`` / ``("consume", i)``.
    ``depth`` issues go out first, then unit i + depth is issued before unit i
    is consumed; ``depth`` 0 is fetch-on-demand. Units are consumed in order
    0..n-1 at every depth, so a pipelined consumer computes what an inline
    one does. The offload stream (``stream.py``) runs its host->device copies
    on this schedule."""
    n = int(n)
    d = max(0, min(int(depth), n))
    for i in range(d):
        yield ("issue", i)
    for i in range(n):
        if i + d < n:
            yield ("issue", i + d)
        yield ("consume", i)
