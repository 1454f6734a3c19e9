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
``checkpoint`` (the checkpoint engine), ``load_universal_checkpoint``,
``activation_checkpointing``, ``flops_profiler``, the monitors
(``monitor_config`` and the legacy top-level ``tensorboard`` /
``csv_monitor`` / ``wandb`` blocks, merged by :attr:`DeepSpeedConfig.monitor`),
``progressive_layer_drop``, ``curriculum_learning``, ``data_efficiency``
(read by the engine: seqlen curriculum and random-LTD), ``eigenvalue``,
``compression_training``, ``resilience`` (preemption, the watchdog,
rollback, integrity, chaos), ``elasticity`` (the elastic batch ladder),
``wall_clock_breakdown``, and ``mesh`` with a data-parallel axis only:
``{"dp": W}`` must name the world size the config is loaded for
(``initialize`` passes the initialized process group's). Every other block
the reference knows raises ``NotImplementedError`` naming its ROADMAP.md
item when it is set to something other than its default.
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


@dataclasses.dataclass
class FlopsProfilerConfig:
    """The ``"flops_profiler"`` block (:mod:`...profiling.flops_profiler`)."""

    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclasses.dataclass
class ActivationCheckpointingConfig:
    """The ``"activation_checkpointing"`` block (read by
    ``runtime.activation_checkpointing.configure``)."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclasses.dataclass
class TensorBoardConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class CSVConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class WandbConfig:
    enabled: bool = False
    team: Optional[str] = None
    group: Optional[str] = None
    project: str = "deepspeed"


@dataclasses.dataclass
class JSONLConfig:
    """The append-only JSONL monitor backend; ``rotate_mb`` bounds the file
    by size (0 = the default cap), keeping ``rotate_keep`` generations."""

    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"
    rotate_mb: float = 0.0
    rotate_keep: int = 3


@dataclasses.dataclass
class MonitorConfig:
    """The ``"monitor_config"`` block: one sub-block per backend."""

    tensorboard: TensorBoardConfig = dataclasses.field(default_factory=TensorBoardConfig)
    csv_monitor: CSVConfig = dataclasses.field(default_factory=CSVConfig)
    wandb: WandbConfig = dataclasses.field(default_factory=WandbConfig)
    jsonl: JSONLConfig = dataclasses.field(default_factory=JSONLConfig)

    @classmethod
    def from_dict(cls, block: Optional[Dict[str, Any]]) -> "MonitorConfig":
        block = block or {}
        return cls(tensorboard=_from_dict(TensorBoardConfig, block.get("tensorboard")),
                   csv_monitor=_from_dict(CSVConfig, block.get("csv_monitor")),
                   wandb=_from_dict(WandbConfig, block.get("wandb")),
                   jsonl=_from_dict(JSONLConfig, block.get("jsonl")))

    @property
    def enabled(self) -> bool:
        return (self.tensorboard.enabled or self.csv_monitor.enabled
                or self.wandb.enabled or self.jsonl.enabled)


@dataclasses.dataclass
class EigenvalueConfig:
    """The ``"eigenvalue"`` block: the per-layer Hessian eigenvalue probe
    (``runtime/eigenvalue.py``). The reference's default ``layer_name``
    names BERT's layers; a tree without it falls back to ``blocks``."""

    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "bert.encoder.layer"
    layer_num: int = 0


@dataclasses.dataclass
class ProgressiveLayerDropConfig:
    """Progressive layer drop: ``theta`` is the asymptotic keep probability,
    ``gamma`` the decay rate, theta(t) = (1 - theta) exp(-gamma t) + theta."""

    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


def _check_ranges(obj, rules) -> None:
    """The reference's field constraints: ``rules`` maps a field to
    (operator, bound), each of ``gt`` / ``ge`` / ``lt``."""
    ops = {"gt": lambda v, b: v > b, "ge": lambda v, b: v >= b, "lt": lambda v, b: v < b}
    for name, checks in rules.items():
        for op, bound in checks:
            v = getattr(obj, name)
            if not ops[op](v, bound):
                raise ValueError(f"{type(obj).__name__}.{name}={v!r} must be {op} {bound}")


@dataclasses.dataclass
class SentinelConfig:
    """``resilience.sentinel``: the divergence sentinels and rollback
    (``resilience/rollback.py``). Every completed step's loss (and grad norm
    when ``grad_norm_zscore`` > 0) feeds an EMA z-score detector; a
    non-finite loss or a spike rolls back to the newest committed tag and
    skips the batches consumed since it. ``checkpoint_interval`` > 0 saves
    an anchor every N steps; ``memory_fallback`` keeps a host copy of the
    last anchor; ``max_rollbacks`` bounds the loop."""

    enabled: bool = False
    zscore: float = 6.0
    grad_norm_zscore: float = 8.0  # 0 disables the grad-norm channel
    min_relative_spike: float = 0.1
    ema_beta: float = 0.98
    warmup_steps: int = 20
    max_rollbacks: int = 3
    checkpoint_interval: int = 0  # 0: the caller saves
    skip_poisoned_batches: bool = True
    memory_fallback: bool = True
    cursor_checkpointable: bool = False

    def __post_init__(self):
        _check_ranges(self, {"zscore": [("gt", 0)], "grad_norm_zscore": [("ge", 0)],
                             "min_relative_spike": [("ge", 0)],
                             "ema_beta": [("gt", 0), ("lt", 1)], "warmup_steps": [("ge", 1)],
                             "max_rollbacks": [("ge", 1)], "checkpoint_interval": [("ge", 0)]})


@dataclasses.dataclass
class WatchdogConfig:
    """``resilience.watchdog``: per-phase deadlines in seconds (<= 0 turns a
    phase's check off). A stall dumps the stacks to
    ``<save_dir>/watchdog_stacks.txt``, records ``watchdog_stall`` and, with
    ``escalate``, requests a drain. ``straggler_check_every`` > 0 gathers
    each rank's step time every N steps and names the ranks slower than
    ``straggler_factor`` x the median. The offload deadlines are read by
    the offload runners' waits and host passes (``runtime/zero/offload.py``,
    ``infinity.py``), nested inside ``step``."""

    enabled: bool = False
    poll_interval_s: float = 1.0
    compile_deadline_s: float = 1800.0
    step_deadline_s: float = 300.0
    collective_deadline_s: float = 120.0
    checkpoint_deadline_s: float = 600.0
    offload_fetch_deadline_s: float = 120.0
    offload_flush_deadline_s: float = 600.0
    escalate: bool = True
    straggler_check_every: int = 0
    straggler_factor: float = 2.0

    def __post_init__(self):
        _check_ranges(self, {"poll_interval_s": [("gt", 0)],
                             "straggler_check_every": [("ge", 0)],
                             "straggler_factor": [("gt", 1)]})


@dataclasses.dataclass
class IntegrityConfig:
    """``resilience.integrity``: every ``scan_interval`` steps
    ``blocks_per_scan`` blocks of ``block_bytes`` of the master and
    optimizer state are fingerprinted after the step and verified before
    the next; a mismatch rolls back (``sdc_detected``). ``spot_check_interval``
    > 0 reruns one micro-batch every N steps and compares the loss and the
    gradient norm bitwise; across ranks the boundary fingerprint rides the
    straggler exchange to a majority vote."""

    enabled: bool = False
    scan_interval: int = 16
    blocks_per_scan: int = 4
    block_bytes: int = 1 << 20
    spot_check_interval: int = 0
    verify_anchors: bool = True

    def __post_init__(self):
        _check_ranges(self, {"scan_interval": [("ge", 1)], "blocks_per_scan": [("ge", 1)],
                             "block_bytes": [("ge", 256)],
                             "spot_check_interval": [("ge", 0)]})


@dataclasses.dataclass
class DegradedModeConfig:
    """``resilience.degraded``: ``demote_after`` consecutive overflow steps
    move the quantized gradient exchange to the fp32 wire,
    ``repromote_after`` clean steps bring it back (residuals zeroed)."""

    demote_after: int = 3
    repromote_after: int = 100

    def __post_init__(self):
        _check_ranges(self, {"demote_after": [("ge", 1)], "repromote_after": [("ge", 1)]})


@dataclasses.dataclass
class ResilienceConfig:
    """The ``resilience`` block (``resilience/``). Enabled (it needs
    ``save_dir``), the engine installs the SIGTERM / SIGINT drain handlers,
    resumes from the newest committed tag in ``save_dir`` at init (or
    ``resume_tag``), and on a drain saves an emergency tag and exits with
    ``exit_code``. ``deep_verify`` checks every file's checksum on load.
    ``chaos``: a :class:`~deepspeed_tpu_torch.resilience.chaos.FaultPlan`
    dict, installed at engine init (fault-injection tests only)."""

    enabled: bool = False
    save_dir: Optional[str] = None
    resume_tag: Optional[str] = None
    auto_resume: bool = True
    install_signal_handlers: bool = True
    exit_code: int = 83
    deep_verify: bool = True
    chaos: Dict[str, Any] = dataclasses.field(default_factory=dict)
    sentinel: SentinelConfig = dataclasses.field(default_factory=SentinelConfig)
    watchdog: WatchdogConfig = dataclasses.field(default_factory=WatchdogConfig)
    degraded: DegradedModeConfig = dataclasses.field(default_factory=DegradedModeConfig)
    integrity: IntegrityConfig = dataclasses.field(default_factory=IntegrityConfig)

    @classmethod
    def from_dict(cls, block: Optional[Dict[str, Any]]) -> "ResilienceConfig":
        block = dict(block or {})
        subs = {"sentinel": SentinelConfig, "watchdog": WatchdogConfig,
                "degraded": DegradedModeConfig, "integrity": IntegrityConfig}
        out = _from_dict(cls, {k: v for k, v in block.items() if k not in subs})
        for name, sub in subs.items():
            setattr(out, name, _from_dict(sub, block.get(name)))
        out._check()
        return out

    def _check(self) -> None:
        """The reference's validators."""
        if self.enabled and not self.save_dir:
            raise ValueError("resilience.enabled requires resilience.save_dir (where "
                             "emergency checkpoints land and auto-resume looks)")
        if (self.sentinel.enabled or self.watchdog.enabled) and not self.enabled:
            raise ValueError("resilience.sentinel / resilience.watchdog require "
                             "resilience.enabled (rollback anchors and drain escalation "
                             "both live in resilience.save_dir)")
        if self.integrity.enabled and not self.enabled:
            raise ValueError("resilience.integrity requires resilience.enabled (SDC "
                             "containment rolls back to anchors in resilience.save_dir)")
        if not (0 < self.exit_code < 256):
            raise ValueError(f"resilience.exit_code must be in 1..255, got {self.exit_code}")
        if self.chaos:
            from ..resilience.chaos import FaultPlan

            FaultPlan.from_dict(dict(self.chaos))  # validate keys up front


# Known blocks and flags this slice does not port: key -> (is it asking for
# the feature?, ROADMAP.md item). Default values pass.
_UNPORTED_BLOCKS = {
    "mesh": (_mesh_asks, "A13"),
    "pipeline": (lambda v: any(v.get(k, d) != d for k, d in
                               (("stages", 1), ("activation_checkpoint_interval", 0),
                                ("micro_batches", 0))), "A13"),
    "analysis": (_enabled, "A14"),
    "autotuning": (_enabled, "A13"),
}

# the "aio" block's keys (DeepSpeed's asynchronous I/O settings) and their
# defaults; the offload runners' NVMe stores read thread_count
AIO_DEFAULTS = {"block_size": 1048576, "queue_depth": 8, "thread_count": 1,
                "single_submit": False, "overlap_events": True}


@dataclasses.dataclass
class DeepSpeedConfig:
    """Top-level config. Build it with :meth:`load`."""

    # ---- batch triangle
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None

    # ---- core knobs
    steps_per_print: int = 10
    wall_clock_breakdown: bool = False
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
    activation_checkpointing: ActivationCheckpointingConfig = dataclasses.field(
        default_factory=ActivationCheckpointingConfig)
    flops_profiler: FlopsProfilerConfig = dataclasses.field(default_factory=FlopsProfilerConfig)
    monitor_config: MonitorConfig = dataclasses.field(default_factory=MonitorConfig)
    tensorboard: Optional[TensorBoardConfig] = None  # the legacy top-level blocks
    csv_monitor: Optional[CSVConfig] = None
    wandb: Optional[WandbConfig] = None
    progressive_layer_drop: ProgressiveLayerDropConfig = dataclasses.field(
        default_factory=ProgressiveLayerDropConfig)
    eigenvalue: EigenvalueConfig = dataclasses.field(default_factory=EigenvalueConfig)
    # the compression_training block as given (compression/config.py normalizes it)
    compression_training: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # read by the engine: the seqlen curriculum and random-LTD
    data_efficiency: Dict[str, Any] = dataclasses.field(default_factory=dict)
    curriculum_learning: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mesh: Dict[str, Any] = dataclasses.field(default_factory=dict)
    resilience: ResilienceConfig = dataclasses.field(default_factory=ResilienceConfig)
    # the elasticity block as given (elasticity/elasticity.py validates it)
    elasticity: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # {"checkpoint_engine": "native" | "async", "writers": N}
    checkpoint: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # every tag is universal (each leaf stored whole): a plain flag
    load_universal_checkpoint: bool = False
    # DeepSpeed's asynchronous I/O settings, as given (keys of AIO_DEFAULTS)
    aio: Dict[str, Any] = dataclasses.field(default_factory=dict)

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
                  "comms_logger", "mesh", "checkpoint", "activation_checkpointing",
                  "flops_profiler", "monitor_config", "tensorboard", "csv_monitor", "wandb",
                  "progressive_layer_drop", "data_efficiency", "curriculum_learning",
                  "eigenvalue", "compression_training", "resilience", "elasticity", "aio"}
        scalars = {f.name for f in dataclasses.fields(cls)} - blocks
        for key in config:
            if key not in scalars and key not in blocks and key not in _UNPORTED_BLOCKS:
                logger.warning(f"DeepSpeedConfig: ignoring unrecognized key {key!r}")
        opt_type = str((config.get("optimizer") or {}).get("type", "")).lower()
        if opt_type in ("onebitadam", "onebitlamb", "zerooneadam") and _mesh_asks(
                config.get("mesh")):
            raise ValueError(f"{opt_type}: 1-bit optimizers require pure data parallelism "
                             "(tp=pp=sp=ep=1), matching the reference's restrictions")
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
        self.activation_checkpointing = _from_dict(ActivationCheckpointingConfig,
                                                   config.get("activation_checkpointing"))
        self.flops_profiler = _from_dict(FlopsProfilerConfig, config.get("flops_profiler"))
        self.monitor_config = MonitorConfig.from_dict(config.get("monitor_config"))
        for key, cls_ in (("tensorboard", TensorBoardConfig), ("csv_monitor", CSVConfig),
                          ("wandb", WandbConfig)):
            if config.get(key) is not None:
                setattr(self, key, _from_dict(cls_, config[key]))
        self.progressive_layer_drop = _from_dict(ProgressiveLayerDropConfig,
                                                 config.get("progressive_layer_drop"))
        self.eigenvalue = _from_dict(EigenvalueConfig, config.get("eigenvalue"))
        self.compression_training = dict(config.get("compression_training") or {})
        self.data_efficiency = dict(config.get("data_efficiency") or {})
        self.curriculum_learning = dict(config.get("curriculum_learning") or {})
        self.resilience = ResilienceConfig.from_dict(config.get("resilience"))
        self.elasticity = dict(config.get("elasticity") or {})
        self.aio = dict(config.get("aio") or {})
        unknown = set(self.aio) - set(AIO_DEFAULTS)
        if unknown:
            raise ValueError(f"aio: unknown keys {sorted(unknown)}; known: {sorted(AIO_DEFAULTS)}")
        if int(self.aio.get("thread_count", 1)) < 1:
            raise ValueError(f"aio.thread_count must be >= 1, got {self.aio['thread_count']}")
        self._adopt_elastic_batch(world_size)
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

    def _elastic_world(self, world_size: int) -> int:
        """The data-parallel world the elastic ladder is judged at: an
        explicit ``mesh.dp`` wins over the process group's."""
        dp = int(self.mesh.get("dp", -1) or -1)
        return dp if dp > 0 else world_size

    def _adopt_elastic_batch(self, world_size: int) -> None:
        """With an enabled ``elasticity`` block and no batch knob, the batch
        triangle is the ladder's decomposition at this world size, as in the
        reference."""
        e = self.elasticity
        if not (e and e.get("enabled")) or e.get("ignore_non_elastic_batch_info", False):
            return
        if (self.train_batch_size is not None or self.train_micro_batch_size_per_gpu is not None
                or self.gradient_accumulation_steps is not None):
            return  # explicit knobs: checked against the ladder in _validate
        from ..elasticity import ElasticityError, compute_elastic_config

        world = self._elastic_world(world_size)
        try:
            final_bs, _, micro = compute_elastic_config({"elasticity": dict(e)}, world)
        except ElasticityError as err:
            raise ValueError(f"invalid elasticity block: {err}") from err
        self.train_batch_size = final_bs
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = final_bs // (micro * world)
        logger.info(f"elasticity: adopted batch plan for world={world}: global={final_bs} "
                    f"micro={micro} gas={self.gradient_accumulation_steps}")

    def _validate_elasticity(self, world_size: int) -> None:
        """The ``elasticity`` block is validated at load (a malformed block,
        or a batch triangle off the ladder, fails here, not at the first
        resize)."""
        e = self.elasticity
        if not e:
            return
        from ..elasticity import ElasticityError, compute_elastic_config, \
            validate_elasticity_block

        try:
            block = validate_elasticity_block(dict(e), warn=logger.warning)
        except ElasticityError as err:
            raise ValueError(f"invalid elasticity block: {err}") from err
        if not block.get("enabled"):
            return
        final_bs, valid, _ = compute_elastic_config({"elasticity": block}, 0)
        if block.get("ignore_non_elastic_batch_info", False):
            logger.warning("elasticity.ignore_non_elastic_batch_info: the batch triangle is "
                           "NOT checked against the elastic ladder; resizes may change the "
                           "effective batch")
            return
        world = self._elastic_world(world_size)
        if world not in valid:
            raise ValueError(
                f"elasticity: world size {world} is not among the valid elastic sizes "
                f"{valid} for batch {final_bs}: the resize plan could never have launched "
                "this decomposition (set ignore_non_elastic_batch_info to override)")
        if self.train_batch_size != final_bs:
            raise ValueError(
                f"elasticity: train_batch_size={self.train_batch_size} is off the elastic "
                f"ladder (the block resolves to {final_bs}): a resize would change the "
                "effective batch; drop the batch knobs to adopt the ladder, or set "
                "ignore_non_elastic_batch_info to override")

    def _validate(self, world_size: int) -> None:
        self._validate_elasticity(world_size)
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

    @property
    def monitor(self) -> MonitorConfig:
        """``monitor_config`` with the enabled legacy top-level ``tensorboard``
        / ``csv_monitor`` / ``wandb`` blocks in place of its own."""
        updates = {key: getattr(self, key) for key in ("tensorboard", "csv_monitor", "wandb")
                   if getattr(self, key) is not None and getattr(self, key).enabled}
        return dataclasses.replace(self.monitor_config, **updates) if updates \
            else self.monitor_config

    def aio_threads(self, buffer_count: int) -> int:
        """The I/O threads of an NVMe store: the ``aio`` block's
        ``thread_count`` where it sets one, else the offload block's
        ``buffer_count`` (the reference's choice), at least 1."""
        if "thread_count" in self.aio:
            return int(self.aio["thread_count"])
        return max(1, int(buffer_count))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def print_config(self) -> None:
        logger.info(json.dumps(self.to_dict(), indent=2, default=str))
