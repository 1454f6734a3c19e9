"""Which slice of each leaf a rank owns under ZeRO (counterpart of
``deepspeed_tpu/runtime/zero/policy.py``).

The reference states partitioning as sharding specs and lets GSPMD place
the slices; here the same decisions are shape functions: for a leaf's full
shape they return the dimension that the ranks split into equal contiguous
slices, rank r owning the r-th, or ``None`` for a leaf every rank holds
whole.

One rule differs from the reference's, on purpose. The reference picks the
largest divisible dimension, and quantizes the logical array, so its values
do not depend on the split. The port quantizes each rank's slice on its own
(``comm/quantized.py`` ``quantized_reshard``), so a split must not cut a
quantization block: blocks run along the trailing dimension, and the split
takes the largest divisible dimension other than the trailing one (and
other than the layer axis of a layer-stacked leaf, so that each layer is
gathered from every rank). 1-D leaves and the layer-stacked ``[L, n]``
vectors stay whole on every rank. Then a rank's quantization blocks are
whole rows of the logical leaf and its payload is the logical leaf's.

At stage 3 a leaf's gradient and optimizer state live on its parameter's
slice, so the update needs no gather; stages 0-2 keep everything whole
(partitioning optimizer states or gradients across ranks is ROADMAP.md A9b).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from .config import DeepSpeedZeroConfig

# the subtree of a parameter dict whose leaves are stacked on a leading
# layer axis (models/gpt.py's layout)
STACKED = "blocks"


def shard_leaf_over(shape: Sequence[int], axis_size: int, threshold: int = 0,
                    stacked: bool = False) -> Optional[int]:
    """The dimension of a ``shape`` leaf that ``axis_size`` ranks split, or
    None. Leaves of at most ``threshold`` elements stay whole (the
    ``stage3_param_persistence_threshold``)."""
    if axis_size <= 1 or int(np.prod(shape or (1,))) <= threshold:
        return None
    best = None
    for d in range(1 if stacked else 0, len(shape) - 1):
        n = shape[d]
        if n % axis_size == 0 and n >= axis_size and (best is None or n > shape[best]):
            best = d
    return best


class ZeroShardingPolicy:
    """Maps a leaf's full shape to the dimension a rank's slice cuts, for
    the parameters, gradients and optimizer state at the configured stage."""

    def __init__(self, config: Optional[DeepSpeedZeroConfig] = None, world_size: int = 1,
                 rank: int = 0):
        self.config = config or DeepSpeedZeroConfig()
        self.stage = int(self.config.stage)
        self.world_size = int(world_size)
        self.rank = int(rank)

    # ------------------------------------------------------------------ per leaf
    def param_spec(self, shape: Sequence[int], stacked: bool = False) -> Optional[int]:
        if self.stage < 3:
            return None
        return shard_leaf_over(shape, self.world_size,
                               self.config.stage3_param_persistence_threshold, stacked)

    def grad_spec(self, shape: Sequence[int], stacked: bool = False) -> Optional[int]:
        return self.param_spec(shape, stacked)

    def opt_spec(self, shape: Sequence[int], stacked: bool = False) -> Optional[int]:
        return self.param_spec(shape, stacked)

    # ------------------------------------------------------------------ trees
    def tree_param_specs(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The ``param_spec`` of every leaf of a parameter dict (anything with
        a ``shape``), the ``blocks`` subtree read as layer-stacked."""
        def walk(node, stacked):
            if isinstance(node, dict):
                return {k: walk(v, stacked or k == STACKED) for k, v in node.items()}
            return self.param_spec(tuple(node.shape), stacked)

        return walk(params, False)

    def shard(self, x, dim: Optional[int]):
        """This rank's slice of a full leaf (a tensor or numpy array)."""
        if dim is None:
            return x
        n = x.shape[dim] // self.world_size
        index = [slice(None)] * x.ndim
        index[dim] = slice(self.rank * n, (self.rank + 1) * n)
        return x[tuple(index)]

    def shard_tree(self, tree: Dict[str, Any], specs: Dict[str, Any]) -> Dict[str, Any]:
        if isinstance(tree, dict):
            return {k: self.shard_tree(v, specs[k]) for k, v in tree.items()}
        return self.shard(tree, specs)
