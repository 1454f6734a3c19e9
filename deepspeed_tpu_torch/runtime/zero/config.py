"""The ``"zero_optimization"`` block (counterpart of
``deepspeed_tpu/runtime/zero/config.py``), as a dataclass.

Every field of the reference's ``DeepSpeedZeroConfig`` parses with its
default. Stages 0-3 run: stage 3 partitions the parameters, their fp32
master copy and the optimizer state over the data-parallel ranks
(``runtime/zero/policy.py``) and gathers each layer just before it runs
(``runtime/zero/gather.py``); at world size 1 partitioning is the identity.
``zero_quantized_weights`` sends the stage-3 gathers over the int8/int4 wire
and ``zero_quantized_head`` the LM head through the dequant-fused product
(``comm/quantized.py``). The knobs still to port raise
``NotImplementedError`` naming their ROADMAP.md item: the quantized gradient
exchange and its error feedback (A9b), offload (A12). ``overlap_comm`` and
``overlap_prefetch_depth`` are accepted: they only move where a gather is
issued, and the port runs the inline schedule (see ``gather.py``). The
bucket sizes and the other stage-3 tuning fields shape traffic the eager
port does not batch; they are read by nothing but ``window_size``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, Optional

from ...utils.errors import unported

# keys whose non-default value asks for a feature not ported yet, with the
# ROADMAP.md item that ports it
_UNPORTED: Dict[str, str] = {
    "offload_param": "A12", "offload_optimizer": "A12", "cpu_offload": "A12",
    "zero_quantized_gradients": "A9b", "zero_quantize_error_feedback": "A9b",
}


@dataclasses.dataclass
class DeepSpeedZeroConfig:
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    overlap_prefetch_depth: int = 1
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    cpu_offload: Optional[bool] = None
    offload_param: Optional[Dict[str, Any]] = None
    offload_optimizer: Optional[Dict[str, Any]] = None
    sub_group_size: int = int(1e9)
    stage3_max_live_parameters: int = int(1e9)
    stage3_max_reuse_distance: int = int(1e9)
    stage3_prefetch_bucket_size: int = int(5e7)
    stage3_param_persistence_threshold: int = int(1e5)
    stage3_gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    round_robin_gradients: bool = False
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_quantized_head: bool = False
    zero_quantize_bits: int = 8
    zero_quantize_block_size: int = 256
    zero_quantize_stochastic: bool = False
    zero_quantize_error_feedback: bool = False
    # the keys the block set explicitly (pydantic's model_fields_set in the
    # reference): window_size engages only on an explicit prefetch bucket
    fields_set: FrozenSet[str] = dataclasses.field(default=frozenset(), compare=False,
                                                    repr=False)

    @classmethod
    def from_dict(cls, block: Optional[Dict[str, Any]]) -> "DeepSpeedZeroConfig":
        block = dict(block or {})
        names = {f.name for f in dataclasses.fields(cls)} - {"fields_set"}
        known = {k: v for k, v in block.items() if k in names}
        self = cls(**known, fields_set=frozenset(known))
        if not 0 <= int(self.stage) <= 3:
            raise ValueError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        self.stage = int(self.stage)
        for key, item in _UNPORTED.items():
            value = block.get(key)
            if value and (not isinstance(value, dict) or value.get("device", "none") != "none"):
                raise unported(f"zero_optimization.{key}", item)
        if self.zero_quantize_bits not in (4, 8):
            raise ValueError(f"zero_quantize_bits must be 4 or 8, got {self.zero_quantize_bits}")
        if self.zero_quantize_block_size < 8 or self.zero_quantize_block_size % 2:
            raise ValueError("zero_quantize_block_size must be an even int >= 8 (int4 packs "
                             f"two values per byte), got {self.zero_quantize_block_size}")
        if not 1 <= self.overlap_prefetch_depth <= 4:
            raise ValueError("overlap_prefetch_depth must be 1-4, got "
                             f"{self.overlap_prefetch_depth}")
        return self
