"""DeepSpeed-JSON-compatible runtime configuration (counterpart of
``deepspeed_tpu/runtime/config.py``), built on ``dataclasses``.

A DeepSpeed JSON config (a dict or a path) parses unchanged: unknown
top-level keys warn and are ignored, as in the reference; unknown keys
inside a block are ignored. The batch triangle (train batch = micro batch x
gradient accumulation x data-parallel world) is completed and checked with
the reference's rules and error messages.

Ported blocks: ``fp16``, ``bf16``, ``optimizer``, ``scheduler``,
``gradient_clipping``, ``prescale_gradients`` / ``gradient_predivide_factor``,
``communication_data_type``, ``seed``, ``steps_per_print``, ``dump_state``,
``zero_optimization`` (see :mod:`.zero.config`), ``comms_logger``,
``checkpoint`` (the checkpoint engine), ``load_universal_checkpoint``, and
``mesh`` with a data-parallel axis only: ``{"dp": W}`` must name the world
size the config is loaded for (``initialize`` passes the initialized
process group's). Every other block the reference knows raises
``NotImplementedError`` naming its ROADMAP.md item when it is set to
something other than its default.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Union

from ..utils.errors import unported
from ..utils.logging import logger
from .zero.config import DeepSpeedZeroConfig

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"


def _from_dict(cls, block: Optional[Dict[str, Any]]):
    """A dataclass from the known keys of ``block``; the rest are ignored."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (block or {}).items() if k in names})


@dataclasses.dataclass
class FP16Config:
    """The ``"fp16"`` block (loss-scaling mixed precision)."""

    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0.0


@dataclasses.dataclass
class BF16Config:
    """The ``"bf16"`` block: bf16 compute, with an fp32 master copy and fp32
    gradient accumulation unless ``master_weights`` is off."""

    enabled: bool = False
    master_weights: bool = True


@dataclasses.dataclass
class OptimizerConfig:
    """The ``"optimizer"`` block ({type, params})."""

    type: str = "Adam"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    """The ``"scheduler"`` block ({type, params})."""

    type: str = "WarmupLR"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _enabled(block: Any) -> bool:
    """A block that asks for its feature: ``enabled`` set, or (for blocks
    without that flag) any content at all."""
    if not block:
        return False
    if isinstance(block, dict) and "enabled" in block:
        return bool(block["enabled"])
    if isinstance(block, dict):
        return any(_enabled(v) if isinstance(v, dict) else bool(v) for v in block.values())
    return bool(block)


def _mesh_asks(mesh: Optional[Dict[str, Any]]) -> bool:
    """A model-parallel mesh axis (A13); the dp axis is checked in ``_validate``."""
    return any(int((mesh or {}).get(ax, 1)) > 1 for ax in ("tp", "pp", "ep", "sp"))


@dataclasses.dataclass
class CommsLoggerConfig:
    """The ``"comms_logger"`` block (``comm.configure``'s fields)."""

    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = dataclasses.field(default_factory=list)


# Known blocks and flags this slice does not port: key -> (is it asking for
# the feature?, ROADMAP.md item). Default values pass.
_UNPORTED_BLOCKS = {
    "mesh": (_mesh_asks, "A13"),
    "pipeline": (lambda v: any(v.get(k, d) != d for k, d in
                               (("stages", 1), ("activation_checkpoint_interval", 0),
                                ("micro_batches", 0))), "A13"),
    "activation_checkpointing": (_enabled, "A3b"),
    "flops_profiler": (_enabled, "A3b"),
    "monitor_config": (_enabled, "A3b"),
    "tensorboard": (_enabled, "A3b"),
    "csv_monitor": (_enabled, "A3b"),
    "wandb": (_enabled, "A3b"),
    "eigenvalue": (_enabled, "A3b"),
    "progressive_layer_drop": (_enabled, "A3b"),
    "compression_training": (_enabled, "A3b"),
    "curriculum_learning": (_enabled, "A3b"),
    "data_efficiency": (_enabled, "A3b"),
    "analysis": (_enabled, "A14"),
    "resilience": (_enabled, "A11"),
    "elasticity": (_enabled, "A11"),
    "autotuning": (_enabled, "A13"),
    "aio": (_enabled, "A12"),
    "wall_clock_breakdown": (bool, "A3b"),
}


@dataclasses.dataclass
class DeepSpeedConfig:
    """Top-level config. Build it with :meth:`load`."""

    # ---- batch triangle
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None

    # ---- core knobs
    steps_per_print: int = 10
    dump_state: bool = False
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    gradient_clipping: float = 0.0
    communication_data_type: Optional[str] = None
    seed: int = 1234
    sparse_gradients: bool = False
    memory_breakdown: bool = False
    disable_allgather: bool = False
    zero_allow_untested_optimizer: bool = False

    # ---- blocks
    fp16: FP16Config = dataclasses.field(default_factory=FP16Config)
    bf16: BF16Config = dataclasses.field(default_factory=BF16Config)
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    zero_optimization: DeepSpeedZeroConfig = dataclasses.field(
        default_factory=DeepSpeedZeroConfig)
    comms_logger: CommsLoggerConfig = dataclasses.field(default_factory=CommsLoggerConfig)
    mesh: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # {"checkpoint_engine": "native" | "async", "writers": N}
    checkpoint: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # every tag is universal (each leaf stored whole): a plain flag
    load_universal_checkpoint: bool = False

    # ------------------------------------------------------------------ loading
    @classmethod
    def load(cls, config: Union[str, os.PathLike, Dict[str, Any], None],
             world_size: int = 1) -> "DeepSpeedConfig":
        if config is None:
            config = {}
        if isinstance(config, (str, os.PathLike)):
            with open(config, "r") as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise TypeError(f"config must be a dict or path, got {type(config)}")
        blocks = {"fp16", "bf16", "optimizer", "scheduler", "zero_optimization",
                  "comms_logger", "mesh", "checkpoint"}
        scalars = {f.name for f in dataclasses.fields(cls)} - blocks
        for key in config:
            if key not in scalars and key not in blocks and key not in _UNPORTED_BLOCKS:
                logger.warning(f"DeepSpeedConfig: ignoring unrecognized key {key!r}")
        for key, (asks, item) in _UNPORTED_BLOCKS.items():
            if key in config and asks(config[key]):
                raise unported(f"the {key!r} config block", item)
        self = cls(**{k: v for k, v in config.items() if k in scalars})
        self.fp16 = _from_dict(FP16Config, config.get("fp16"))
        self.bf16 = _from_dict(BF16Config, config.get("bf16"))
        if config.get("optimizer") is not None:
            self.optimizer = _from_dict(OptimizerConfig, config["optimizer"])
        if config.get("scheduler") is not None:
            self.scheduler = _from_dict(SchedulerConfig, config["scheduler"])
        self.zero_optimization = DeepSpeedZeroConfig.from_dict(config.get("zero_optimization"))
        self.comms_logger = _from_dict(CommsLoggerConfig, config.get("comms_logger"))
        self.mesh = dict(config.get("mesh") or {})
        self.checkpoint = dict(config.get("checkpoint") or {})
        self._resolve_batch(world_size)
        self._validate(world_size)
        return self

    # The reference's batch triangle (train = micro * gas * dp_world): fill
    # any one missing vertex, default gas=1.
    def _resolve_batch(self, world_size: int) -> None:
        train, micro, gas = (
            self.train_batch_size,
            self.train_micro_batch_size_per_gpu,
            self.gradient_accumulation_steps,
        )
        if train is not None and micro is not None and gas is None:
            gas = train // (micro * world_size)
        elif train is not None and micro is None and gas is not None:
            micro = train // (gas * world_size)
        elif train is not None and micro is None and gas is None:
            gas = 1
            micro = train // world_size
        elif train is None and micro is not None:
            gas = gas or 1
            train = micro * gas * world_size
        elif train is None and micro is None:
            # only gas (or nothing) specified: micro defaults to 1, keep the user's gas
            micro = 1
            gas = gas or 1
            train = micro * gas * world_size
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    def _validate(self, world_size: int) -> None:
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        if train != micro * gas * world_size:
            raise ValueError(
                f"batch triangle violated: train_batch_size={train} != "
                f"micro({micro}) * gas({gas}) * world({world_size})")
        dp = int(self.mesh.get("dp", -1))
        if dp not in (-1, world_size):
            raise ValueError(f"mesh.dp={dp} does not match the world size {world_size}: the "
                             "port's data-parallel axis is the whole process group")
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        if self.zero_enabled and not (self.fp16.enabled or self.bf16.enabled):
            logger.warning("ZeRO enabled without fp16/bf16: running fp32 sharded training")
        if self.sparse_gradients and self.zero_optimization.stage >= 2:
            raise ValueError(
                "sparse_gradients is incompatible with ZeRO stage >= 2 "
                "(gradient partitioning), matching the reference's constraint")

    # ------------------------------------------------------------------ helpers
    @property
    def zero_enabled(self) -> bool:
        return self.zero_optimization.stage > 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def print_config(self) -> None:
        logger.info(json.dumps(self.to_dict(), indent=2, default=str))
