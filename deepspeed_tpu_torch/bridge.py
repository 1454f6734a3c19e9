"""Carries parameter trees between the JAX package and the port as numpy arrays.

The port keeps the reference's leaf names, its layer-stacked ``[L, ...]``
leaves and its ``x @ W`` layout (``qkv_w`` is ``[L, d, 3d]``), so a tree
crosses over leaf by leaf with no reshaping: a test hands both packages the
same weights, and parity never depends on matching random streams.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .accelerator import resolve_device


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, as JAX hands it over: carry the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """A nested dict of numpy arrays -> the same dict of tensors on ``device``
    (default: the CUDA device). ``dtype`` casts the floating-point leaves."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = _tensor(node)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree)


def params_to_numpy(params: Any) -> Any:
    """The inverse of :func:`params_from_numpy`. bfloat16 leaves come back as
    float32 (an exact widening), since numpy has no bfloat16 of its own."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
