"""The module contract between models and the engine (counterpart of
``deepspeed_tpu/models/api.py``).

A model is a pair of functions over a parameter dict, as in the reference:

- ``init(seed, device) -> params``: build the fp32 parameter tree;
- ``apply(params, batch, rngs=None, train=True) -> (loss, aux)``: forward
  plus loss.

``gpt_config`` is the GPTConfig a ``models.gpt.build`` module was built
from. The reference's partitioning, pipeline and streaming hooks belong to
later slices (ROADMAP.md A9, A12, A13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Module:
    """A trainable model: functional (init, apply)."""

    init: Callable[..., Params]
    apply: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]
    gpt_config: Optional[Any] = None
