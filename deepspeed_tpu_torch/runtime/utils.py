"""Engine math helpers (counterpart of ``deepspeed_tpu/runtime/utils.py``).

The global gradient norm and clipping by it, over a list of tensors, with
no host synchronisation: both return and take 0-dim device tensors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every tensor (fp32 accumulation), as a 0-dim fp32 tensor."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale every tensor by ``min(1, max_norm / (norm + 1e-6))``. Returns
    (clipped, pre-clip norm); the inputs are left as they are."""
    tensors = list(tensors)
    norm = norm if norm is not None else global_norm(tensors)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    clipped = torch._foreach_mul([t.float() for t in tensors], scale)
    return [c.to(t.dtype) for c, t in zip(clipped, tensors)], norm


def count_parameters(tensors: Sequence[torch.Tensor]) -> int:
    return int(sum(t.numel() for t in tensors))
