"""The ``"zero_optimization"`` block (counterpart of
``deepspeed_tpu/runtime/zero/config.py``), as a dataclass.

This slice ports the stage field only. Stages 0-2 at world size 1 run the
unsharded update: partitioning optimizer states or gradients over one rank
is the identity. Stage 3, offload and the quantized collectives raise until
their ROADMAP.md items. The block's other keys (bucket sizes, overlap,
prefetch) only shape the traffic between ranks; at one rank there is
nothing for them to do, and they are ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ...utils.errors import unported

# keys whose non-default value asks for a feature this slice does not have,
# with the ROADMAP.md item that ports it
_UNPORTED: Dict[str, str] = {
    "offload_param": "A12", "offload_optimizer": "A12", "cpu_offload": "A12",
    "zero_quantized_weights": "A9", "zero_quantized_gradients": "A9",
    "zero_quantized_head": "A9",
}


@dataclasses.dataclass
class DeepSpeedZeroConfig:
    stage: int = 0

    @classmethod
    def from_dict(cls, block: Optional[Dict[str, Any]]) -> "DeepSpeedZeroConfig":
        block = block or {}
        stage = int(block.get("stage", 0))
        if not 0 <= stage <= 3:
            raise ValueError(f"zero_optimization.stage must be 0-3, got {stage}")
        if stage == 3:
            raise unported("ZeRO stage 3 (parameter partitioning)", "A9")
        for key, item in _UNPORTED.items():
            value = block.get(key)
            if value and (not isinstance(value, dict) or value.get("device", "none") != "none"):
                raise unported(f"zero_optimization.{key}", item)
        return cls(stage=stage)
