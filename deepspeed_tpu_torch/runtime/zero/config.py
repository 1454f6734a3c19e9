"""The ``"zero_optimization"`` block (counterpart of
``deepspeed_tpu/runtime/zero/config.py``), as a dataclass.

Every field of the reference's ``DeepSpeedZeroConfig`` parses with its
default. Stages 0-3 run at any world size: stage 1 partitions the
optimizer state and the fp32 master copy over the data-parallel ranks,
stage 2 the gradients too, and stage 3 the parameters
(``runtime/zero/policy.py``), each layer then gathered just before it runs
(``runtime/zero/gather.py``); at world size 1 partitioning is the identity.
``zero_quantized_weights`` sends the stage-3 gathers over the int8/int4 wire
and ``zero_quantized_head`` the LM head through the dequant-fused product;
``zero_quantized_gradients`` (stages 0-2) exchanges the gradients over it,
with ``zero_quantize_error_feedback``'s residuals (``comm/quantized.py``,
``runtime/engine.py``). ``offload_optimizer`` (or the legacy
``cpu_offload: true``, migrated into it) keeps the optimizer state on the
host (``runtime/zero/offload.py``), and ``offload_param`` streams the
parameters from host masters too (``runtime/zero/infinity.py``),
superseding ``offload_optimizer``; both run at world size 1 (more ranks
raise A12b). Quantized gradients at stage 3 raise A9c. ``overlap_comm`` and
``overlap_prefetch_depth`` are accepted: they only move where a gather or a
gradient bucket is issued, and the port runs the inline schedule (see
``gather.py``; the side-stream schedule is A9c); ``overlap_comm`` also picks
the per-layer gradient buckets, as in the reference. The bucket sizes and
the other stage-3 tuning fields shape traffic the eager port does not
batch; they are read by nothing but ``window_size``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, Optional

from ...utils.errors import unported

OFFLOAD_DEVICES = ("none", "cpu", "nvme")


def _offload_block(cls, block: Optional[Dict[str, Any]], name: str):
    if block is None:
        return None
    if isinstance(block, cls):
        return block
    names = {f.name for f in dataclasses.fields(cls)}
    self = cls(**{k: v for k, v in dict(block).items() if k in names})
    if self.device not in OFFLOAD_DEVICES:
        raise ValueError(f"zero_optimization.{name}.device must be one of {OFFLOAD_DEVICES}, "
                         f"got {self.device!r}")
    if self.buffer_count < 0:
        raise ValueError(f"zero_optimization.{name}.buffer_count must be >= 0")
    return self


@dataclasses.dataclass
class DeepSpeedZeroOffloadParamConfig:
    """``offload_param``: the masters on the host (``cpu``) or on NVMe, the
    layer units streamed through the device. ``stream`` (unset: on) with
    ``prefetch_depth`` d (0-8) keeps d unit copies in flight ahead of the
    layer that consumes them; ``stream: false`` or depth 0 fetches on
    demand, bitwise the same values. ``quantized_fetch`` pushes the units
    over the block-int wire (``zero_quantize_bits`` / ``_block_size``).
    ``buffer_count`` is the number of last layer units kept on the device for
    the backward."""

    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = int(1e8)
    max_in_cpu: int = int(1e9)
    pin_memory: bool = False
    stream: Optional[bool] = None
    prefetch_depth: int = 2
    quantized_fetch: bool = False

    def __post_init__(self):
        if not 0 <= int(self.prefetch_depth) <= 8:
            raise ValueError(f"offload_param.prefetch_depth must be 0-8, got "
                             f"{self.prefetch_depth}")

    @property
    def stream_effective(self) -> bool:
        return self.stream is not False and self.prefetch_depth >= 1

    @property
    def effective_prefetch_depth(self) -> int:
        return self.prefetch_depth if self.stream_effective else 0


@dataclasses.dataclass
class DeepSpeedZeroOffloadOptimizerConfig:
    """``offload_optimizer``: the optimizer state on the host (``cpu``) or on
    NVMe, stepped by the host SIMD optimizer."""

    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False


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
    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None
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

    @property
    def overlap_comm_effective(self) -> bool:
        """``overlap_comm`` with the unset default resolved to on."""
        return self.overlap_comm is not False

    @property
    def offload_optimizer_device(self) -> str:
        return self.offload_optimizer.device if self.offload_optimizer else "none"

    @property
    def offload_param_device(self) -> str:
        return self.offload_param.device if self.offload_param else "none"

    @classmethod
    def from_dict(cls, block: Optional[Dict[str, Any]]) -> "DeepSpeedZeroConfig":
        block = dict(block or {})
        names = {f.name for f in dataclasses.fields(cls)} - {"fields_set"}
        known = {k: v for k, v in block.items() if k in names}
        self = cls(**known, fields_set=frozenset(known))
        if not 0 <= int(self.stage) <= 3:
            raise ValueError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        self.stage = int(self.stage)
        self.offload_param = _offload_block(DeepSpeedZeroOffloadParamConfig,
                                            self.offload_param, "offload_param")
        self.offload_optimizer = _offload_block(DeepSpeedZeroOffloadOptimizerConfig,
                                                self.offload_optimizer, "offload_optimizer")
        if self.cpu_offload and self.offload_optimizer is None:
            # the legacy flat key: offload_optimizer={"device": "cpu"}
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(device="cpu")
        if self.zero_quantized_gradients and self.stage >= 3:
            # the reference gathers the whole parameter set per device for
            # this and discourages it (its engine's warning)
            raise unported("zero_optimization.zero_quantized_gradients at ZeRO stage 3", "A9c")
        if self.zero_quantize_bits not in (4, 8):
            raise ValueError(f"zero_quantize_bits must be 4 or 8, got {self.zero_quantize_bits}")
        if self.zero_quantize_block_size < 8 or self.zero_quantize_block_size % 2:
            raise ValueError("zero_quantize_block_size must be an even int >= 8 (int4 packs "
                             f"two values per byte), got {self.zero_quantize_block_size}")
        if not 1 <= self.overlap_prefetch_depth <= 4:
            raise ValueError("overlap_prefetch_depth must be 1-4, got "
                             f"{self.overlap_prefetch_depth}")
        return self
