"""User surface for partitioned (ZeRO-3) parameters (counterpart of
``deepspeed_tpu/runtime/zero/partitioned_params.py``).

- :func:`Init`: a no-op context. The engine builds the full tree from its
  seed and keeps each rank's slices (``runtime/zero/policy.py``), so there
  is no construction for it to partition.
- :class:`GatheredParameters`: gathers the full value of the named leaves to
  host numpy (every rank takes part in the gather), yields them for reading
  or mutation, and with ``modify=True`` writes each leaf back into this
  rank's slice of the parameters and, where there is one, of the fp32
  master copy (cut by the optimizer state's layout). ``quantized=True`` fetches float leaves over the int8/int4
  wire (quantized on the device, dequantized on the host), for reading only.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ...comm import comm
from ...comm.quantized import (np_dequantize_blockwise, quantization_shrinks,
                               quantize_blockwise)
from ...comm.runtime_accounting import wire_ledger
from ...utils.logging import log_dist


@contextlib.contextmanager
def Init(config: Any = None, **kwargs):
    """Parity shim for ``deepspeed.zero.Init``: the engine partitions the tree
    it builds, so the context does nothing. Yields nothing."""
    log_dist("zero.Init: the engine partitions the tree it builds; the context is a no-op")
    yield


def _leaf(tree, dotted: str):
    for p in dotted.split("."):
        tree = tree[p]
    return tree


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1]


class GatheredParameters:
    """Gather engine parameters to host, optionally writing mutations back.

    ``paths``: dotted paths into ``engine.state["params"]`` (None: every
    leaf). ``modify``: write the leaves back on exit, each rank into its own
    slice, in the leaf's dtype. ``quantized``: fetch float leaves over the
    quantized wire (half a quantization step of error per block at most);
    never with ``modify``, which would write that noise back."""

    def __init__(self, engine, paths: Optional[Iterable[str]] = None, modify: bool = False,
                 quantized: bool = False):
        if quantized and modify:
            raise ValueError("GatheredParameters: quantized=True with modify=True would write "
                             "quantization noise back into untouched leaves; gather full "
                             "precision when mutating")
        self.engine = engine
        self.paths = list(paths) if paths is not None else None
        self.modify = modify
        self.quantized = bool(quantized)
        self._gathered: Dict[str, np.ndarray] = {}

    def _fetch(self, leaf: torch.Tensor, dim: Optional[int]) -> np.ndarray:
        zc = self.engine.config.zero_optimization
        bits, block = int(zc.zero_quantize_bits), int(zc.zero_quantize_block_size)
        leaf = leaf.detach()
        if dim is not None:
            leaf = comm.all_gather(leaf, axis=dim)
        if (not self.quantized or not leaf.is_floating_point() or leaf.dim() == 0
                or not quantization_shrinks(leaf.shape[-1], bits, block,
                                            leaf.element_size())):
            return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).cpu().numpy()
        q, s, z = quantize_blockwise(leaf, bits=bits, block_size=block)
        wire_ledger.record("qgather[host]", leaf.numel() * leaf.element_size(),
                           sum(t.numel() * t.element_size() for t in (q, s, z)))
        return np_dequantize_blockwise(q.cpu().numpy(), s.cpu().numpy(), z.cpu().numpy(),
                                       bits=bits, orig_size=leaf.shape[-1])

    def __enter__(self) -> Dict[str, np.ndarray]:
        params, specs = self.engine.state["params"], self.engine.param_specs
        paths = self.paths if self.paths is not None else list(_paths(params))
        self._gathered = {p: self._fetch(_leaf(params, p), _leaf(specs, p)) for p in paths}
        return self._gathered

    def __exit__(self, *exc) -> bool:
        if exc[0] is not None or not self.modify:
            return False
        state, policy = self.engine.state, self.engine.zero_policy
        with torch.no_grad():
            for p, full in self._gathered.items():
                for tree, specs in ((state["params"], self.engine.param_specs),
                                    (state["master"], self.engine.opt_specs)):
                    if tree:
                        mine = policy.shard(full, _leaf(specs, p))
                        mine = torch.as_tensor(np.ascontiguousarray(mine))
                        t = _leaf(tree, p)
                        t.copy_(mine.to(t.device, t.dtype))
        return False
