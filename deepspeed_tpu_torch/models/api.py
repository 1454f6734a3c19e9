"""The module contract between models and the engine (counterpart of
``deepspeed_tpu/models/api.py``).

A model is a pair of functions over a parameter dict, as in the reference:

- ``init(seed, device) -> params``: build the fp32 parameter tree;
- ``apply(params, batch, rngs=None, train=True) -> (loss, aux)``: forward
  plus loss.

``gpt_config`` is the GPTConfig a ``models.gpt.build`` module was built
from. ``grad_bucket_key`` names the layer-stacked subtree whose gradients
the quantized exchange sends one layer (bucket) at a time, as the
reference's does. ``loss_count(batch)`` is the number of targets the loss
averages over (a 0-dim fp32 tensor): across data-parallel ranks the engine
weights each rank's masked mean by its share of the total, so that the
loss is the global masked mean. ``with_ltd_keep(keep, layer_ids)`` gives
the model whose listed layers train on ``keep``-token subsets (random-LTD;
the engine calls it when the schedule moves). ``stream()`` gives the
model's unit decomposition for ZeRO-Infinity's parameter stream
(``models.gpt.GPTStream``). The reference's pipeline hook belongs to a
later slice (ROADMAP.md A13).
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
    grad_bucket_key: Optional[str] = None
    loss_count: Optional[Callable[[Dict[str, Any]], torch.Tensor]] = None
    with_ltd_keep: Optional[Callable[[int, Tuple[int, ...]], "Module"]] = None
    stream: Optional[Callable[[], Any]] = None
