"""The training engine (counterpart of
``deepspeed_tpu/runtime/engine.py``).

It owns the model, the optimizer, the precision policy, the LR schedule
and the throughput timer, and exposes the reference's surface:
``train_batch`` / ``train_batches`` and the imperative ``forward`` /
``backward`` / ``step`` with gradient accumulation at the same boundaries.

The train state keeps the reference's keys and leaf names: ``params`` (the
compute-dtype parameters, which are the autograd leaves), ``master`` (the
fp32 master copy, or ``{}``), ``opt`` (the optimizer state, fp32),
``step``, ``micro`` and ``scaler``. One micro-step is the reference's
``_micro_step``: forward, ``torch.autograd.grad`` of the (loss-scaled,
predivided) loss, the gradients cast to fp32, unscaled and accumulated
times 1/gas. The boundary is its ``_boundary_step``: the gradient reduction
across ranks, the overflow check (fp16 loss scaling), the global norm,
clipping, the LR at the count of steps taken so far, the optimizer on the
master (or the params), and the recast of the master to the compute dtype.

Nothing reads a device value back per leaf: metrics come back as 0-dim
tensors (``loss``, ``grad_norm``, ``lr``, ``loss_scale``, ``overflow``).
With fp16 loss scaling the engine reads the overflow flag once per step,
to skip the update. ``save_checkpoint`` / ``load_checkpoint`` write and
read the reference's tagged format (:mod:`..checkpoint`), the open
accumulation window included; a tag loads at any world size.

Every ZeRO stage runs at any world size of the process group
(``comm.init_distributed``; none is needed at world size 1). Each rank
takes its rows of the global batch. The stages are the reference's
(``zero/policy.py``): from stage 1 a rank keeps its slices of the fp32
master copy and of the optimizer state and updates only those; the recast
parameters are all-gathered whole, so every rank holds bitwise the same
parameters after each step. At the boundary the accumulated fp32 gradients
are mean-reduced: all-reduced at stages 0-1, reduce-scattered to the
owners' slices at stage 2. At stage 3 the parameters are sliced too; the
forward gathers the top-level leaves whole and, under the bound
:func:`~.zero.gather.gather_window`, the model gathers each layer just
before it runs (over the int wire with ``zero_quantized_weights``), and the
gathers' backward mean-reduces each gradient to its owners' slices. The
global norm for clipping, the overflow flag (min-reduced), LAMB's trust
ratios and the reported loss are reduced over the ranks; a ``loss_mask``
weights each rank's masked mean by its share of the mask, so the loss and
the gradients are the global masked mean.

``zero_quantized_gradients`` (stages 0-2) replaces the gradient reduction
with the reference's ``_qdp_grads`` exchange after each micro-step's
backward (``comm/quantized.py``): with ``overlap_comm`` (the default),
deterministic rounding and a model with ``grad_bucket_key``, one quantized
reduce-scatter + all-gather per layer of the stacked ``blocks``
(``qgrad_bucket_rs`` / ``qgrad_bucket_ag``) and one for the rest
(``qgrad_reduce_scatter`` / ``qgrad_all_gather``); otherwise one exchange
for the whole tree. With ``zero_quantize_error_feedback`` each rank keeps
its row of the residuals ``qgrad_residual`` [W, npad] and
``qgrad_bucket_residual`` [L, W, npad_l] in ``state``, zeroed at an
overflow. The buckets are exchanged after the backward, layer by layer;
issuing them during the backward, the side-stream gather prefetch,
``comms_verify`` and ``measure_overlap`` are ROADMAP.md A9c.

The engine features of the reference run at its places: the seqlen
curriculum (``curriculum_learning``, or ``data_efficiency``'s
``data_sampling`` with a ``seqlen`` metric) truncates each batch's sequence
keys to the scheduler's value at ``global_steps + 1``; random-LTD
(``data_efficiency.data_routing.random_ltd``) moves the model to the
schedule's ``keep`` before each ``train_batch`` (``Module.with_ltd_keep``),
in the default sandwich of layers 1..n unless ``random_ltd_layer_id`` names
them; progressive layer drop hands the model ``theta`` at the count of steps
taken before the current one and the host tracker follows it after each
step; the monitors get the reference's events at every boundary
(``Train/loss``, ``lr``, ``grad_norm``, ``loss_scale`` under loss scaling,
``pld_theta``, ``samples_per_sec``; ``Resilience/overflow_skip`` on a
skipped step); ``wall_clock_breakdown`` times ``batch_input`` and
``train_batch`` (``forward`` and ``step`` on the imperative path), each
timer synchronising only under the flag; the flops profiler profiles the
step at its ``profile_step``; and the ``activation_checkpointing`` block
configures :mod:`.activation_checkpointing`.

The 1-bit optimizers (``OneBitAdam``, ``OneBitLamb``, ``ZeroOneAdam``) train
with their dense counterpart until ``freeze_step``; from there the boundary
is :mod:`.fp16.onebit`'s, on each rank's local gradients, with the
residual rows in ``state["onebit"]``. ``compression_training`` applies
:mod:`..compression`'s transform to the parameters inside the loss at the
count of steps taken (at stage 3 the planned layer-stacked leaves are
gathered whole first). The ``eigenvalue`` probe runs after every
``gas_boundary_resolution``-th step on the step's (first micro-)batch and
writes ``state["curvature"]``, which stretches the MoQ schedule per layer;
where the model cannot be differentiated twice (the attention kernels) it
logs and disables itself. The reference's refusals of what these do not
compose with are kept.

ZeRO-Offload and ZeRO-Infinity run through the same ``train_batch``:
``offload_optimizer`` (or the legacy ``cpu_offload``) hands the step to
:class:`~.zero.offload.HostOffloadRunner` (the device computes the
gradients, the host steps the fp32 masters and moments and pushes the
compute-dtype copy back); ``offload_param`` supersedes it with
:class:`~.zero.infinity.ParamStreamRunner` (the masters on the host, the
layer units streamed through the device; the device state holds no
parameters). The runners' state is ``engine._offload`` /
``engine._param_stream``, their last step's numbers ``last_stats`` (with
``host_dma``, the stream's copy accounting) and :meth:`memory_stats`. They
run at world size 1 (more ranks raise A12b) and keep the reference's
refusals: fp16 loss scaling, the 1-bit optimizers, ``compression_training``,
random-LTD, progressive layer drop, the quantized gradient exchange, and
gradient accumulation with ``offload_param``.

The ``resilience`` block arms the reference's lifecycle around the step
(``resilience/``): at init the chaos plan, the drain handlers and the
auto-resume from the newest committed tag, the watchdog, the health
controller (the divergence sentinel with rollback, the poisoned window's
skip, the in-memory anchor, the periodic anchor saves, the quantized wire's
demotion) and the integrity monitor (the master and optimizer state's
blockwise fingerprints, stamped after a step and verified before the next
and before a save, and the spot check); per step the chaos injections, the
watchdog's phases, the straggler poll and the drain at each micro-batch
boundary (:meth:`request_drain`, or SIGTERM: an emergency tag, then exit
``resilience.exit_code``). Everything else the reference engine does and the
port does not raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..accelerator import resolve_device, to_device
from ..comm import comm
from ..comm.quantized import QuantizedCommConfig, grad_bucket_reduce, qall_gather, qreduce_scatter
from ..comm.runtime_accounting import wire_ledger
from ..models.api import Module
from ..ops.optimizers import Optimizer, get_optimizer
from ..utils.errors import unported
from ..utils.logging import log_dist, logger
from ..utils.rng import fold_in
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .config import ActivationCheckpointingConfig, DeepSpeedConfig
from .lr_schedules import schedule_fn_from_config
from .progressive_layer_drop import ProgressiveLayerDrop, pld_theta
from .precision import (
    PrecisionConfig,
    cast_to_compute,
    grads_finite,
    init_scaler_state,
    make_master,
    update_scaler,
    validate_comm_dtype,
)
from .utils import clip_by_global_norm, count_parameters, global_norm
from .zero.gather import gather_leaf, gather_window
from .zero.policy import STACKED, ZeroShardingPolicy
from .zero.reshard import RESIDUAL_RANK_AXIS, get_path


class DeepSpeedEngine:
    """Training engine over the ranks of the process group. See the module
    docstring."""

    def __init__(self, model: Module, config: DeepSpeedConfig, seed: Optional[int] = None,
                 lr_scheduler_fn: Optional[Callable] = None,
                 client_optimizer: Optional[Optimizer] = None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.pc = PrecisionConfig.from_ds_config(config)
        validate_comm_dtype(config.communication_data_type, self.pc.compute_dtype)
        self.gas = int(config.gradient_accumulation_steps or 1)
        self.micro_batch_size = int(config.train_micro_batch_size_per_gpu or 1)
        self.train_batch_size = int(config.train_batch_size or 1)
        stage = config.zero_optimization.stage
        self.world_size, self.rank = comm.get_world_size(), comm.get_rank()
        if self.train_batch_size != self.micro_batch_size * self.gas * self.world_size:
            raise ValueError(f"train_batch_size {self.train_batch_size} != micro "
                             f"{self.micro_batch_size} x gas {self.gas} x world "
                             f"{self.world_size}: load the config for this world size")
        self.zero_policy = ZeroShardingPolicy(config.zero_optimization, self.world_size,
                                              self.rank)
        self._qcomm = QuantizedCommConfig.from_zero_config(config.zero_optimization)
        cl = config.comms_logger
        if cl.enabled:
            comm.configure(enabled=True, verbose=cl.verbose or cl.debug, prof_all=cl.prof_all,
                           prof_ops=cl.prof_ops)
        # a user's configure() before initialize wins unless the config's
        # block asks for something, as in the reference
        from .activation_checkpointing import checkpointing as ac

        if (not ac.is_configured()
                or config.activation_checkpointing != ActivationCheckpointingConfig()):
            ac.configure(deepspeed_config=config)
        self._init_data_efficiency(model, config)

        # ---------------- optimizer + lr schedule
        opt_cfg = config.optimizer
        if client_optimizer is not None:
            if stage > 0 and not config.zero_allow_untested_optimizer:
                raise ValueError(
                    "a client optimizer with ZeRO requires "
                    "zero_allow_untested_optimizer=true (its state layout "
                    "must tolerate sharding)")
            self.optimizer = client_optimizer
            self.base_lr = float(opt_cfg.params.get("lr", 1e-3)) if opt_cfg else 1e-3
        elif opt_cfg is None:
            self.optimizer = get_optimizer("Adam", {"lr": 1e-3})
            self.base_lr = 1e-3
        else:
            self.optimizer = get_optimizer(opt_cfg.type, opt_cfg.params)
            self.base_lr = float(opt_cfg.params.get("lr", 1e-3))
        if lr_scheduler_fn is not None:
            self.lr_fn = lr_scheduler_fn
        elif config.scheduler is not None:
            self.lr_fn = schedule_fn_from_config(config.scheduler.type, config.scheduler.params)
        else:
            base = self.base_lr
            self.lr_fn = lambda step: base

        # ---------------- counters, timer, state
        self.seed = int(seed if seed is not None else config.seed)
        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        # global batches consumed (stepped on or skipped), saved in checkpoints
        self.data_cursor = 0
        self._ckpt_engine = None  # built from the "checkpoint" block at the first save
        self._micro = 0  # micro-steps accumulated in the open window (host mirror of state["micro"])
        self._grad_acc: Optional[List[torch.Tensor]] = None
        self._pending = None  # the scaled loss of the last imperative forward()
        self._last_metrics: Dict[str, Any] = {}
        sync = torch.cuda.synchronize if self.device.type == "cuda" else None
        self.tput_timer = ThroughputTimer(synchronize=sync)
        self.timers = SynchronizedWallClockTimer()
        self._monitor = None
        if config.monitor.enabled:
            from ..monitor.monitor import MonitorMaster

            self._monitor = MonitorMaster(config.monitor)
        self._flops_profiler = None
        if config.flops_profiler.enabled:
            from ..profiling import FlopsProfiler

            self._flops_profiler = FlopsProfiler(self, config.flops_profiler)
        # stochastic rounding of the gradient exchange: a stream per rank
        self._qgrad_gen = (torch.Generator(device=self.device).manual_seed(
            fold_in(self.seed, self.rank)) if self._qcomm.gradients and self._qcomm.stochastic
            else None)
        # the quantized exchange demoted to the fp32 wire (the health
        # controller's WireDemotionController); read by every micro-step
        self._qgrad_demoted = False
        self._preemption_guard = None
        self._recovery_log = None
        self._draining = False
        self._drain_polled_at = None  # micro_steps of the last drain poll
        self._preemptions_survived = 0
        # a callable whose value a save stores as resume_state, handed back
        # after a load as resumed_state (a dataloader's position, say)
        self.resume_state_provider: Optional[Callable[[], Any]] = None
        self.resumed_state: Any = None
        self._watchdog = None
        self._health = None
        self._integrity = None
        self._integrity_boundary_fp = None
        self._tb_dispatched = False  # the first step runs under the "compile" deadline
        self._skip_window_remaining = 0  # imperative poison skip: micro-batches left
        self._skip_backward = False
        self._last_loss = None
        self._offload = self._param_stream = None
        self.state = self._init_state()
        if self._offload_requested:
            from .zero.offload import HostOffloadRunner

            self._offload = HostOffloadRunner(self)
        if self._param_stream_requested:
            from .zero.infinity import ParamStreamRunner

            self._param_stream = ParamStreamRunner(self)
        log_dist(
            f"engine ready: {count_parameters(tree_leaves(self.state['params'])) / 1e6:.1f}M "
            f"params, ZeRO stage {stage}, dtype {self.pc.compute_dtype}, device "
            f"{self.device}, micro_bs {self.micro_batch_size} x gas {self.gas}")
        if config.dump_state:
            config.print_config()
        self._init_resilience()

    # ------------------------------------------------------------------ state
    def _init_state(self) -> Dict[str, Any]:
        zc = self.config.zero_optimization
        self._param_stream_requested = zc.offload_param_device in ("cpu", "nvme")
        # offload_param implies the host optimizer: it supersedes offload_optimizer
        self._offload_requested = (zc.offload_optimizer_device in ("cpu", "nvme")
                                   and not self._param_stream_requested)
        if (self._offload_requested or self._param_stream_requested) and self.world_size > 1:
            raise unported("ZeRO-Offload at world size > 1", "A12b")
        if self._param_stream_requested:
            # the model never exists whole on the device: the runner makes the
            # host masters unit by unit; the device state is bookkeeping only
            self._init_a3c(self.model.init(self.seed, device="cpu")
                           if self.config.compression_training else {})
            self.param_specs = self.grad_specs = self.opt_specs = {}
            self._param_dims, self._grad_dims, self._opt_dims = [], [], []
            return {"params": {}, "master": {}, "opt": {},
                    "step": torch.zeros((), dtype=torch.int32, device=self.device),
                    "micro": torch.zeros((), dtype=torch.int32, device=self.device),
                    "scaler": init_scaler_state(self.pc, self.device)}
        params_f32 = self.model.init(self.seed, device=self.device)
        self._init_a3c(params_f32)
        if self._qcomm.gradients:
            self._init_qgrad(params_f32)
        # every rank builds the whole tree from the seed and keeps its slices:
        # of the params by param_spec, of the master copy and the optimizer
        # state by opt_spec
        policy = self.zero_policy
        self.param_specs = policy.tree_param_specs(params_f32)
        self.grad_specs = policy.tree_grad_specs(params_f32)
        self.opt_specs = policy.tree_opt_specs(params_f32)

        def dims(specs):
            return [t[0] for t in tree_leaves(tree_map(lambda p, d: (d,), params_f32, specs))]

        self._param_dims, self._grad_dims, self._opt_dims = (
            dims(self.param_specs), dims(self.grad_specs), dims(self.opt_specs))
        master = make_master(tree_map(lambda p, d: policy.shard(p, d), params_f32,
                                      self.opt_specs), self.pc)
        params = cast_to_compute(tree_map(lambda p, d: policy.shard(p, d).clone(), params_f32,
                                          self.param_specs), self.pc)
        del params_f32
        if self._offload_requested:
            # the master copy and the moments live on the host (the runner);
            # the device keeps the compute-dtype parameters only
            master = None
            opt = {}
        else:
            opt = self.optimizer.init(master if master is not None else self._opt_view(params))
        state = {
            "params": params,
            "master": master if master is not None else {},
            "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=self.device),
            "micro": torch.zeros((), dtype=torch.int32, device=self.device),
            "scaler": init_scaler_state(self.pc, self.device),
        }
        if self._qcomm.gradients and self._qcomm.error_feedback:
            # this rank's row of the reference's [W, npad] / [L, W, npad_l]
            zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                               device=self.device)
            state["qgrad_residual"] = zeros(1, self._qgrad_npad)
            if self._qgrad_bucket_key is not None:
                state["qgrad_bucket_residual"] = zeros(self._qgrad_bucket_L, 1,
                                                       self._qgrad_bucket_npad)
        if self._onebit is not None:
            state["onebit"] = self._onebit.init_state(self.device)
        if self._eigenvalue is not None:
            # normalized per-layer eigenvalues; 0 = not probed yet (factor 1 in the MoQ gate)
            state["curvature"] = torch.zeros(len(self._curvature_np), dtype=torch.float32,
                                             device=self.device)
        return self._with_leaves(state)

    def _init_a3c(self, params_f32) -> None:
        """The 1-bit runner, the compression scheduler and the eigenvalue
        probe, and the reference's refusals of what they do not compose with."""
        from ..compression import init_compression
        from .eigenvalue import Eigenvalue
        from .fp16.onebit import ONEBIT_TYPES, OnebitRunner

        config = self.config
        self._onebit = None
        opt_type = config.optimizer.type.lower() if config.optimizer else ""
        if opt_type in ONEBIT_TYPES:
            self._onebit = OnebitRunner(self, opt_type, config.optimizer.params,
                                        sum(t.numel() for t in tree_leaves(params_f32)))
        self._compression = None
        if config.compression_training:
            sched = init_compression(params_f32, config)
            self._compression = sched if sched.enabled else None
        self._eigenvalue = None
        self._ev_last_batch = None
        self._curvature_np = None  # the host copy of state["curvature"]
        self._check_offload()
        if config.eigenvalue.enabled and self._param_stream_requested:
            raise ValueError("the eigenvalue probe differentiates the in-device parameters; "
                             "offload_param keeps none on the device")
        if config.eigenvalue.enabled:
            self._eigenvalue = Eigenvalue.from_config(config.eigenvalue)
            scope, _, n_layer = self._eigenvalue._blocks(params_f32)
            self._curvature_np = np.zeros(n_layer, np.float32)
            if self._compression is not None:
                # the per-layer MoQ gate covers the probed subtree only
                self._compression.curvature_scope = scope.replace(".", "/")
        if self._onebit is not None and self._random_ltd is not None:
            raise ValueError("random_ltd is not supported together with ZeRO-Offload or 1-bit "
                             "optimizers (their compiled programs cannot follow the "
                             "keep-schedule's model rebuilds)")
        if self._onebit is not None and self.progressive_layer_drop is not None:
            raise ValueError("progressive_layer_drop is not supported together with "
                             "ZeRO-Offload/Infinity or 1-bit optimizers")
        if self._compression is not None and self._onebit is not None:
            raise ValueError("compression_training is not supported together with "
                             "ZeRO-Offload or 1-bit optimizers")
        if self._qcomm.gradients and self._onebit is not None:
            raise ValueError("zero_quantized_gradients and 1-bit optimizers are exclusive "
                             "(each owns the gradient exchange)")
        if self._qcomm.gradients and self._compression is not None:
            raise ValueError("zero_quantized_gradients does not compose with "
                             "compression_training or progressive_layer_drop")

    def _check_offload(self) -> None:
        """The reference's refusals of what the offload runners do not
        compose with (their gradient programs bypass these)."""
        stream, offload = self._param_stream_requested, self._offload_requested
        if not (stream or offload):
            return
        if stream and self._onebit is not None:
            raise ValueError("offload_param and 1-bit optimizers are exclusive")
        if stream and self._compression is not None:
            raise ValueError("compression_training is not supported with offload_param "
                             "(the streamed per-unit programs bypass the QAT transform)")
        if self._random_ltd is not None:
            if self.config.zero_optimization.offload_optimizer_device != "none":
                raise ValueError("random_ltd is not supported together with ZeRO-Offload or "
                                 "1-bit optimizers (their compiled programs cannot follow the "
                                 "keep-schedule's model rebuilds)")
            raise ValueError("random_ltd is not supported with offload_param")
        if offload and self._onebit is not None:
            raise ValueError("offload_optimizer and 1-bit optimizers are exclusive")
        if self.progressive_layer_drop is not None:
            raise ValueError("progressive_layer_drop is not supported together with "
                             "ZeRO-Offload/Infinity or 1-bit optimizers")
        if offload and self._compression is not None:
            raise ValueError("compression_training is not supported together with "
                             "ZeRO-Offload or 1-bit optimizers")
        if self._qcomm.gradients:
            raise ValueError("zero_quantized_gradients is not supported with "
                             "ZeRO-Offload/Infinity (their runners own the gradient program)")

    def _init_data_efficiency(self, model: Module, config: DeepSpeedConfig) -> None:
        """The curriculum scheduler, random-LTD's scheduler and progressive
        layer drop's tracker, with the reference's resolution and refusals."""
        # the seqlen curriculum: the legacy block, or the data-efficiency
        # schema's data_sampling.curriculum_learning with a seqlen metric
        self.curriculum_scheduler = None
        cl = config.curriculum_learning
        if not (cl and cl.get("enabled")):
            de = config.data_efficiency or {}
            ds_blk = de.get("data_sampling", {})
            decl = ds_blk.get("curriculum_learning", {})
            if de.get("enabled") and ds_blk.get("enabled", True) and decl.get("enabled"):
                metrics = decl.get("curriculum_metrics", {})
                if set(metrics) == {"seqlen"}:
                    m = metrics["seqlen"]
                    cl = {"enabled": True, "curriculum_type": "seqlen",
                          "min_difficulty": m["min_difficulty"],
                          "max_difficulty": m["max_difficulty"],
                          "schedule_type": m.get("schedule_type", "fixed_linear"),
                          "schedule_config": m.get("schedule_config", {})}
                elif metrics:
                    raise NotImplementedError(
                        f"data_efficiency curriculum metrics {sorted(metrics)} unsupported "
                        "in-engine (only 'seqlen' truncation is; metric-file sampling goes "
                        "through DeepSpeedDataSampler)")
        if cl and cl.get("enabled"):
            from .data_pipeline import CurriculumScheduler

            self.curriculum_scheduler = CurriculumScheduler(cl)
        # random-LTD: the listed layers train on keep-token subsets
        self._random_ltd = None
        self._ltd_keep = None
        de = config.data_efficiency or {}
        routing = de.get("data_routing", {})
        rl = routing.get("random_ltd", {})
        if de.get("enabled") and routing.get("enabled", True) and rl.get("enabled"):
            from .data_pipeline.data_routing.random_ltd import RandomLTDScheduler

            if model.with_ltd_keep is None:
                raise ValueError("random_ltd requires a model with a with_ltd_keep rebuild "
                                 "hook (models.gpt.build provides one)")
            self._random_ltd = RandomLTDScheduler(rl)
            if not self._random_ltd.layer_ids:
                n = int(rl.get("random_ltd_layer_num", 0))
                total = int(rl.get("total_layer_num", n + 2))
                # the default sandwich: the first and last layers stay dense
                self._random_ltd.layer_ids = list(range(1, min(n + 1, total - 1)))
            if not self._random_ltd.layer_ids:
                raise ValueError(
                    "random_ltd resolved ZERO layers to drop tokens in: set "
                    "random_ltd_layer_id or a positive random_ltd_layer_num (a silently "
                    "inert schedule would still log transitions)")
        self.progressive_layer_drop = None
        if config.progressive_layer_drop.enabled:
            if self._qcomm.gradients:
                raise ValueError("zero_quantized_gradients does not compose with "
                                 "compression_training or progressive_layer_drop")
            self.progressive_layer_drop = ProgressiveLayerDrop(
                config.progressive_layer_drop.theta, config.progressive_layer_drop.gamma)

    def _init_qgrad(self, params_f32) -> None:
        """The flat geometry of the quantized gradient exchange (the
        reference's): the layer stack of ``grad_bucket_key`` goes in
        per-layer buckets when ``overlap_comm`` is on, rounding is
        deterministic and the stack has more than one layer; the rest, or
        the whole tree, in one padded fp32 vector."""
        qc, W = self._qcomm, self.world_size
        total = sum(t.numel() for t in tree_leaves(params_f32))
        self._qgrad_bucket_key = None
        bk = self.model.grad_bucket_key
        if (self.config.zero_optimization.overlap_comm_effective and not qc.stochastic and bk
                and bk in params_f32):
            bleaves = tree_leaves(params_f32[bk])
            L = int(bleaves[0].shape[0]) if bleaves else 0
            if L > 1 and all(t.shape[:1] == (L,) for t in bleaves):
                n_layer = sum(t[0].numel() for t in bleaves)
                self._qgrad_bucket_key = bk
                self._qgrad_bucket_L = L
                self._qgrad_bucket_npad = -(-n_layer // W) * W
                total -= L * n_layer
        self._qgrad_n = total
        self._qgrad_npad = -(-total // W) * W
        log_dist(f"zero_quantized_gradients: int{qc.bits} block={qc.block_size} exchange over "
                 f"dp={W} ({total} grads monolithic, padded {self._qgrad_npad}"
                 + (f"; {self._qgrad_bucket_L} per-layer buckets of {self._qgrad_bucket_npad} "
                    "exchanged after the backward" if self._qgrad_bucket_key else "")
                 + (", error feedback on" if qc.error_feedback else "") + ")")

    def _opt_view(self, params):
        """This rank's params in the optimizer's layout: a whole leaf that
        the optimizer state slices is cut to this rank's slice (a view, so
        an in-place update writes through)."""
        return tree_map(lambda p, pd, od: self.zero_policy.shard(p, od) if pd is None else p,
                        params, self.param_specs, self.opt_specs)

    @property
    def _qgrad_live(self) -> bool:
        """The quantized gradient exchange runs this step (configured, not
        demoted)."""
        return self._qcomm.gradients and not self._qgrad_demoted

    def _init_resilience(self) -> None:
        """The reference's order (its engine's init): the chaos plan, the
        recovery log, the drain handlers and the auto-resume, then the
        watchdog and the health controller (whose in-memory anchor holds the
        resumed state), then integrity (whose first stamps cover it)."""
        res = self.config.resilience
        if res.chaos:
            from ..resilience.chaos import FaultPlan, install_plan

            install_plan(FaultPlan.from_dict(dict(res.chaos)))
        if not res.enabled:
            return
        from ..resilience import PreemptionGuard, RecoveryLog

        if self.rank == 0:
            self._recovery_log = RecoveryLog.for_dir(res.save_dir, monitor=self._monitor)
        if res.install_signal_handlers:
            self._preemption_guard = PreemptionGuard().install()
        if res.auto_resume:
            loaded, _ = self.load_checkpoint(res.save_dir, tag=res.resume_tag)
            if loaded is not None:
                log_dist(f"resilience: auto-resumed from {loaded} (step {self.global_steps})")
        wd = res.watchdog
        if wd.enabled:
            from ..resilience.watchdog import HealthWatchdog

            self._watchdog = HealthWatchdog(
                deadlines={"compile": wd.compile_deadline_s, "step": wd.step_deadline_s,
                           "collective": wd.collective_deadline_s,
                           "checkpoint": wd.checkpoint_deadline_s,
                           # the offload runners' host<->device waits and host
                           # passes, nested inside step
                           "offload_fetch": wd.offload_fetch_deadline_s,
                           "offload_flush": wd.offload_flush_deadline_s},
                poll_interval=wd.poll_interval_s,
                on_stall=self._watchdog_escalate if wd.escalate else None,
                recovery_log=self._recovery_log, stacks_dir=res.save_dir).start()
        if res.sentinel.enabled or self._qcomm.gradients:
            from ..resilience.rollback import HealthController

            self._health = HealthController(self)
        if res.integrity.enabled:
            self._init_integrity()

    @staticmethod
    def _with_leaves(state: Dict[str, Any]) -> Dict[str, Any]:
        """Make the compute-dtype params the autograd leaves."""
        state["params"] = tree_map(
            lambda p: p.detach().requires_grad_(True) if p.is_floating_point() else p,
            state["params"])
        return state

    def load_state(self, state: Dict[str, Any]) -> None:
        """Replace the train state (for example one carried over from the
        JAX engine by ``bridge.train_state_from_numpy``, cut to this rank's
        slices by ``policy=engine.zero_policy``). It must have the keys of the
        engine's own state; the step counters follow it."""
        missing = set(self.state) - set(state)
        if missing:
            raise ValueError(f"load_state: missing keys {sorted(missing)}")
        host_masters = self._offload_requested or self._param_stream_requested
        if bool(state["master"]) != (self.pc.master_weights and not host_masters):
            raise ValueError("load_state: the master copy does not match the precision mode")
        self.state = self._with_leaves(dict(state))
        if "curvature" in state:
            self._curvature_np = state["curvature"].detach().cpu().numpy().astype(np.float32)
        self.global_steps = int(state["step"])
        self._micro = int(state["micro"])
        self._grad_acc = None
        self._pending = None

    @property
    def params(self):
        return self.state["params"]

    @property
    def module(self):
        """The wrapped model, as the reference exposes it."""
        return self.model

    # ------------------------------------------------------------------ steps
    def _place_batch(self, batch, rows_axis: int = 0) -> Dict[str, torch.Tensor]:
        """The batch on the device, this rank's rows of it along ``rows_axis``."""
        cast = self.pc.compute_dtype if (self.config.fp16.enabled
                                         and self.config.fp16.auto_cast) else None
        if self.world_size > 1:
            batch = {k: self.zero_policy.shard(v, rows_axis) for k, v in batch.items()}

        def place(x):
            # pinned and non-blocking: a copy from pageable memory would wait
            # for the device to drain the previous step
            x = to_device(x, self.device)
            if cast is not None and x.is_floating_point():
                x = x.to(cast)  # fp16 auto_cast: float inputs ride the compute dtype
            return x

        return {k: place(v) for k, v in batch.items()}

    def _micro_seed(self) -> int:
        """The dropout seed of the next micro-step: fresh for every micro-step,
        a function of the engine seed and the micro-step count only."""
        return fold_in(self.seed, self.micro_steps)

    def _scales(self):
        """(loss multiplier, gradient multiplier): the loss scale over the
        predivide factor and its inverse (the reference's eff_scale, inv)."""
        # the quantized exchange carries the loss scale alone, as the
        # reference's _qdp_grads does
        predivide = (float(self.config.gradient_predivide_factor or 1.0)
                     if self.config.prescale_gradients and not self._qgrad_live else 1.0)
        if self.pc.loss_scaling:
            eff = self.state["scaler"].scale / predivide
            return eff, 1.0 / eff
        return 1.0 / predivide, predivide

    def _model_params(self):
        """The parameters the model runs on: at stage 3 the top-level leaves
        gathered whole; the layer-stacked blocks stay sliced, since the model
        gathers each layer as it runs."""
        params = self.state["params"]
        if self.zero_policy.stage < 3:
            return params
        return {k: v if k == STACKED else tree_map(gather_leaf, v, self.param_specs[k])
                for k, v in params.items()}

    # sequence-bearing batch keys that the seqlen curriculum truncates
    _SEQ_KEYS = ("input_ids", "labels", "attention_mask", "position_ids", "token_type_ids")

    def _apply_curriculum(self, batch):
        """The batch with its sequence keys cut to the curriculum's length at
        ``global_steps + 1``."""
        if self.curriculum_scheduler is None:
            return batch
        seqlen = self.curriculum_scheduler.update_difficulty(self.global_steps + 1)

        def trunc(x):
            if hasattr(x, "ndim") and x.ndim >= 2 and x.shape[-1] > seqlen:
                return x[..., :seqlen]
            return x

        return {k: (trunc(v) if k in self._SEQ_KEYS else v) for k, v in batch.items()}

    def _apply_random_ltd(self) -> None:
        """Move the model to random-LTD's ``keep`` at ``global_steps`` when it
        changes."""
        if self._random_ltd is None:
            return
        keep = self._random_ltd.update(self.global_steps)
        if keep == self._ltd_keep:
            return
        self._ltd_keep = keep
        self.model = self.model.with_ltd_keep(keep, tuple(self._random_ltd.layer_ids))
        log_dist(f"random_ltd: keep -> {keep} tokens (layers {self._random_ltd.layer_ids})")

    def wall_clock_breakdown(self) -> bool:
        return bool(self.config.wall_clock_breakdown)

    def _forward(self, batch):
        """The model's training loss on one placed micro-batch, with its graph."""
        kwargs = {}
        if self.progressive_layer_drop is not None:
            pcfg = self.config.progressive_layer_drop
            # theta at the count of steps taken before this one
            kwargs["pld_theta"] = pld_theta(pcfg.theta, pcfg.gamma, self.global_steps)
        params, dims = self._model_params(), self.param_specs.get(STACKED)
        if self._compression is not None:
            params, dims = self._compressed(params, dims)
        with gather_window(self.config.zero_optimization, dims):
            try:
                out = self.model.apply(params, batch,
                                       rngs={"dropout": self._micro_seed()}, train=True,
                                       **kwargs)
            except TypeError as e:
                if "pld_theta" in str(e):
                    raise ValueError("progressive_layer_drop is enabled but this model's "
                                     "apply() takes no pld_theta (models.gpt.build models "
                                     "take it)") from e
                raise
        loss, _ = out if isinstance(out, tuple) else (out, {})
        weight = self._loss_weight(batch)
        if weight is not None:
            loss = loss * weight
        eff, _ = self._scales()
        return loss.float() * eff, loss

    def _compressed(self, params, dims):
        """The compression transform at the count of steps taken, inside the
        loss so that the straight-through gradient reaches the weights. At
        stage 3 each planned layer-stacked leaf is gathered whole first (its
        layers then skip the per-layer gather): the transform sees the
        logical leaves, as the reference's does."""
        if self.zero_policy.stage >= 3:
            stacked = {k for k in self._compression.plan if k.startswith(STACKED + "/")}
            names = {k.split("/", 1)[1] for k in stacked}
            params = {**params, STACKED: {k: gather_leaf(v, dims.get(k)) if k in names else v
                                          for k, v in params[STACKED].items()}}
            dims = {k: None if k in names else d for k, d in dims.items()}
        return (self._compression.transform(params, self.global_steps,
                                            curvature=self._curvature_np), dims)

    def _loss_weight(self, batch) -> Optional[torch.Tensor]:
        """With a ``loss_mask`` across ranks, W times this rank's share of
        the mask's targets: the mean of the weighted per-rank masked means
        is the global masked mean, as the reference computes it over the
        whole batch. The quantized exchange keeps the reference's mean of
        per-rank means (its ``_qdp_grads`` loss is per rank)."""
        if (self.world_size == 1 or "loss_mask" not in batch or self._qgrad_live
                or (self._onebit is not None and self._onebit.compressed())):
            return None
        if self.model.loss_count is None:
            raise ValueError("a loss_mask across data-parallel ranks needs the model's "
                             "loss_count (the targets its masked mean divides by)")
        count = self.model.loss_count(batch).float()
        return count * self.world_size / comm.all_reduce(count).clamp(min=1.0)

    def _accumulate(self, scaled_loss: torch.Tensor) -> None:
        """Gradients of ``scaled_loss`` w.r.t. the params, in fp32, unscaled,
        added times 1/gas into the accumulation buffer."""
        leaves = tree_leaves(self.state["params"])
        grads = torch.autograd.grad(scaled_loss, leaves, materialize_grads=True)
        eff, inv = self._scales()
        if self._qgrad_live:
            grads = self._qgrad_exchange(list(grads), eff)
        grads = [g.float() for g in grads]  # bf16/fp16 leaves give grads in their dtype
        if not (isinstance(inv, float) and inv == 1.0):
            torch._foreach_mul_(grads, inv)
        if self.gas > 1:
            torch._foreach_mul_(grads, 1.0 / self.gas)
        if self._grad_acc is None:
            self._grad_acc = grads  # 0 + g, without the zeros
        else:
            torch._foreach_add_(self._grad_acc, grads)
        self._micro += 1
        self.micro_steps += 1
        self.state["micro"] += 1

    def _qgrad_exchange(self, grads: List[torch.Tensor], scale) -> List[torch.Tensor]:
        """One micro-step's quantized gradient exchange (the reference's
        ``_qdp_grads`` after its backward): ``grads`` carry the loss scale
        ``scale``; each rank gets the mean over the ranks, dequantized. The
        per-layer buckets come back in the leaves' dtype, the monolithic
        rest in fp32, as the reference's do. Updates the residuals in
        ``state`` in place of the old ones."""
        qc, state = self._qcomm, self.state
        g_tree = tree_unflatten(state["params"], grads)
        bk = self._qgrad_bucket_key
        rest = g_tree
        if bk is not None:
            blocks = g_tree[bk]
            resid = state.get("qgrad_bucket_residual")
            layers, new_resid = [], []
            for i in range(self._qgrad_bucket_L):
                layer, r = grad_bucket_reduce(
                    {k: v[i] for k, v in blocks.items()}, None if resid is None else resid[i],
                    scale, bits=qc.bits, block_size=qc.block_size, op_name="qgrad_bucket")
                layers.append(layer)
                new_resid.append(r)
            g_tree = {**g_tree, bk: {k: torch.stack([lay[k] for lay in layers])
                                     for k in blocks}}
            if resid is not None:
                state["qgrad_bucket_residual"] = torch.stack(new_resid)
            rest = {k: v for k, v in g_tree.items() if k != bk}
        rest_leaves = tree_leaves(rest)
        n, npad = self._qgrad_n, self._qgrad_npad
        flat = torch.nn.functional.pad(torch.cat([g.float().reshape(-1) for g in rest_leaves]),
                                       (0, npad - n))
        kw = dict(bits=qc.bits, block_size=qc.block_size, stochastic=qc.stochastic,
                  generator=self._qgrad_gen, mean=True, op_name="qgrad_reduce_scatter")
        if "qgrad_residual" in state:
            # the residual persists in unscaled units, so that it survives a
            # change of the loss scale
            red, new_r = qreduce_scatter(flat, residual=state["qgrad_residual"][0] * scale, **kw)
            state["qgrad_residual"] = (new_r / scale)[None]
        else:
            red = qreduce_scatter(flat, **kw)
        full = qall_gather(red, axis=0, tiled=True, bits=qc.bits, block_size=qc.block_size,
                           op_name="qgrad_all_gather")
        out, off = [], 0
        for g in rest_leaves:
            out.append(full[off:off + g.numel()].reshape(g.shape))
            off += g.numel()
        if bk is None:
            return out
        return tree_leaves({**g_tree, **tree_unflatten(rest, out)})

    def _reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The accumulated gradients, mean-reduced over the ranks (an
        all-reduce at stages 0-1, a reduce-scatter to the owners' slices at
        stage 2; stage 3's gathers and the quantized exchange have reduced
        them already), in the optimizer state's layout."""
        layout = self._param_dims
        if self.world_size > 1 and self.zero_policy.stage < 3 and not self._qgrad_live:
            W = self.world_size
            grads = [comm.all_reduce(g, op="mean") if d is None
                     else comm.reduce_scatter(g, axis=d) / W
                     for g, d in zip(grads, self._grad_dims)]
            layout = self._grad_dims
        # a leaf whole here and sliced in the optimizer state keeps this rank's slice
        return [self.zero_policy.shard(g, o) if d is None and o is not None else g
                for g, d, o in zip(grads, layout, self._opt_dims)]

    def _publish(self, target: List[torch.Tensor], has_master: bool) -> None:
        """The updated slices (``target``, in the optimizer's layout) into
        the compute-dtype params: the recast of the master, and an
        all-gather where the params are whole and the slice is not."""
        for p, t, pd, od in zip(tree_leaves(self.state["params"]), target, self._param_dims,
                                self._opt_dims):
            if od != pd:
                p.copy_(comm.all_gather(t.to(p.dtype), axis=od))
            elif has_master:
                p.copy_(t)  # the recast to the compute dtype

    def _boundary_step(self) -> Dict[str, Any]:
        """The optimizer step at the accumulation boundary (the reference's
        ``_boundary_step``, overflow skip included)."""
        state = self.state
        grads = self._reduce_grads(self._grad_acc)
        self._grad_acc = None
        if self.pc.loss_scaling:
            finite = grads_finite(grads)
            if self.world_size > 1:  # a slice may overflow on one rank only
                finite = comm.all_reduce(finite.float(), op="min") > 0
            do_update = bool(finite)  # the one host read per step, fp16 only
        else:
            finite = torch.ones((), dtype=torch.bool, device=self.device)
            do_update = True
        gnorm = self._global_norm(grads)
        if self.config.gradient_clipping and self.config.gradient_clipping > 0:
            grads, gnorm = clip_by_global_norm(grads, self.config.gradient_clipping, norm=gnorm)
        # torch.full, not torch.tensor: a fill launch, not a synchronising copy
        lr = torch.full((), float(self.lr_fn(self.global_steps)), dtype=torch.float32,
                        device=self.device)
        has_master = bool(state["master"])
        target = state["master"] if has_master else self._opt_view(state["params"])
        kw = ({"sliced": [d is not None for d in self._opt_dims]}
              if self.optimizer.name == "FusedLamb" and self.world_size > 1 else {})
        if do_update:
            with torch.no_grad():
                target, state["opt"] = self.optimizer.update(
                    tree_unflatten(target, grads), state["opt"], target, lr, **kw)
                self._publish(tree_leaves(target), has_master)
        else:
            # an overflow poisons the error-feedback residuals (a block's scale
            # goes inf): drop them with the skipped update, as the reference does
            for key in RESIDUAL_RANK_AXIS:
                if get_path(state, key) is not None:
                    get_path(state, key).zero_()
        loss_scale = state["scaler"].scale
        state["scaler"] = update_scaler(self.pc, state["scaler"], finite)
        state["step"] = state["step"] + 1
        state["micro"] = torch.zeros_like(state["micro"])
        self._micro = 0
        return {"grad_norm": gnorm, "lr": lr, "loss_scale": loss_scale, "overflow": ~finite,
                "_skipped": not do_update}

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm of the reduced gradients (in the
        optimizer's layout): the squares of the sliced leaves summed over
        the ranks, plus those of the leaves every rank holds whole."""
        if all(d is None for d in self._opt_dims):
            return global_norm(grads)

        def sq(ts):
            if not ts:
                return torch.zeros((), dtype=torch.float32, device=self.device)
            return torch.stack(torch._foreach_norm([t.float() for t in ts])).square().sum()

        sliced = [g for g, d in zip(grads, self._opt_dims) if d is not None]
        whole = [g for g, d in zip(grads, self._opt_dims) if d is None]
        return torch.sqrt(comm.all_reduce(sq(sliced)) + sq(whole))

    def _finish_step(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        skipped = metrics.pop("_skipped")
        self.global_steps += 1
        self._last_metrics = metrics
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        if skipped:
            self.skipped_steps += 1
            log_dist(f"step {self.global_steps}: non-finite grads, step skipped; loss scale "
                     f"-> {float(self.state['scaler'].scale)}")
            if self._recovery_log is not None:  # writes the monitor's scalar too
                self._recovery_log.record(
                    "overflow_skip", step=self.global_steps, data_cursor=int(self.data_cursor),
                    loss_scale=(float(self.state["scaler"].scale) if self.pc.loss_scaling
                                else None))
            elif self._monitor is not None:
                self._monitor.write_events([("Resilience/overflow_skip", 1.0,
                                             self.global_steps)])
        if self._monitor is not None and "loss" in metrics:
            step = self.global_steps
            events = [("Train/loss", float(metrics["loss"]), step),
                      ("Train/lr", float(metrics["lr"]), step),
                      ("Train/grad_norm", float(metrics["grad_norm"]), step)]
            if self.pc.loss_scaling:
                events.append(("Train/loss_scale", float(metrics["loss_scale"]), step))
            if self.progressive_layer_drop is not None:
                events.append(("Train/pld_theta", self.progressive_layer_drop.get_theta(), step))
            sps = self.tput_timer.avg_samples_per_sec()
            if sps:
                events.append(("Train/samples_per_sec", sps, step))
            self._monitor.write_events(events)
        spp = self.config.steps_per_print
        if spp and self.global_steps % spp == 0:
            loss = metrics.get("loss")
            loss_str = f"loss={float(loss):.4f} " if loss is not None else ""
            log_dist(f"step={self.global_steps} {loss_str}lr={float(metrics['lr']):.3e} "
                     f"grad_norm={float(metrics['grad_norm']):.3f}")
        self.data_cursor += 1  # after the events, which carry the step's own cursor
        return metrics

    # ------------------------------------------------------------------ public API
    def train_batch(self, batch) -> Dict[str, Any]:
        """One full step: ``gas`` micro-batches and the optimizer update.
        ``batch`` arrays are [gas, micro, ...] when gas > 1, else [micro, ...].
        Under ``resilience``, in the reference's order: a batch inside the
        poisoned window after a rollback is consumed without running; the
        chaos plan's injections for this cursor; integrity's verification of
        the blocks stamped after the last step; the step inside the
        watchdog's bracket (closed after the loss is read to the host, which
        waits for the card); the health checks; integrity's stamps and spot
        check; the straggler poll; the drain."""
        if self._micro:
            raise RuntimeError("train_batch: an imperative accumulation window is open "
                               f"({self._micro} of {self.gas} micro-steps); finish it with "
                               "step() first")
        if self._health is not None and self._health.should_skip(self.data_cursor):
            return self._skip_poisoned_batch()
        from ..resilience.chaos import training_faults

        inj = training_faults(self.data_cursor)
        if self._integrity is not None:
            sdc_metrics = self._integrity_prestep()
            if sdc_metrics is not None:
                return sdc_metrics
        self.tput_timer.start()
        prof = self._flops_profiler
        if prof is not None and self.global_steps + 1 == self.config.flops_profiler.profile_step:
            pcfg = self.config.flops_profiler
            prof.profile_train_batch(batch)
            prof.print_model_profile(profile_step=pcfg.profile_step,
                                     module_depth=pcfg.module_depth,
                                     top_modules=pcfg.top_modules, detailed=pcfg.detailed,
                                     output_file=pcfg.output_file)
        wcb = self.wall_clock_breakdown()
        self._apply_random_ltd()
        if wcb:
            self.timers("batch_input").start()
        batch = self._place_batch(self._apply_curriculum(batch),
                                  rows_axis=1 if self.gas > 1 else 0)
        if wcb:
            self.timers("batch_input").stop()
        if inj.stall_s:
            # a stalled collective, inside the phase whose deadline sees one
            with self._watch_phase("collective"):
                time.sleep(inj.stall_s)
        t_step = time.monotonic()
        with self._watch_phase("compile" if not self._tb_dispatched else "step"):
            if wcb:
                self.timers("train_batch").start()
            metrics = self._step(batch)
            self._tb_dispatched = True
            if wcb:
                self.timers("train_batch").stop(sync_on=metrics["loss"])
            metrics = self._inject(metrics, inj)
            if self._watchdog is not None or self._health is not None:
                # the read the sentinel needs: the bracket closes once the card
                # has finished the step, so a wedged kernel holds it open
                float(metrics["loss"])
            self._finish_step(metrics)
        if self._health is not None:
            hinfo = self._health.after_step(metrics)
            if hinfo:
                metrics = dict(metrics)
                metrics["health"] = hinfo
        if self._eigenvalue is not None:  # on the step's batch, the first micro-batch
            self._update_curvature(batch if self.gas == 1 else {k: v[0] for k, v in
                                                                 batch.items()})
        spp = self.config.steps_per_print
        if wcb and spp and self.global_steps % spp == 0:
            self.timers.log(["batch_input", "train_batch"])
        self._stop_tput(batch)
        if self._integrity is not None:
            self._integrity_poststep(batch, time.monotonic() - t_step)
        self._straggler_poll(time.monotonic() - t_step)
        self._maybe_drain()
        return metrics

    def _inject(self, metrics, inj) -> Dict[str, Any]:
        """The chaos plan's metric injections for this step: a NaN loss, a
        quantized-gradient overflow."""
        if inj.nan_loss:
            metrics = dict(metrics)
            metrics["loss"] = torch.full((), float("nan"), device=self.device)
        if inj.ef_overflow:  # accounted as a skipped overflow step, as the reference does
            metrics = dict(metrics)
            metrics["overflow"] = torch.ones((), dtype=torch.bool, device=self.device)
            metrics["_skipped"] = True
        self._last_loss = metrics["loss"]
        return metrics

    def _step(self, batch) -> Dict[str, Any]:
        """``gas`` micro-steps over the placed ``batch`` and the boundary (or
        the offload runner's step)."""
        runner = self._offload or self._param_stream
        if runner is not None:
            return runner.train_batch(batch)
        ids = batch["input_ids"]
        if self.gas > 1 and (ids.dim() != 3 or ids.shape[0] != self.gas):
            raise ValueError(f"train_batch: with gas={self.gas} the batch leaves are "
                             f"[gas, micro, T]; got input_ids {tuple(ids.shape)}")
        losses = []
        for i in range(self.gas):
            mb = batch if self.gas == 1 else {k: v[i] for k, v in batch.items()}
            scaled, loss = self._forward(mb)
            self._accumulate(scaled)
            losses.append(loss.detach())
        if self._onebit is not None and self._onebit.compressed():
            metrics = self._onebit.boundary()
        else:
            metrics = self._boundary_step()
        loss = losses[0] if self.gas == 1 else torch.stack(losses).mean()
        metrics["loss"] = comm.all_reduce(loss, op="mean")
        return metrics

    def _stop_tput(self, placed) -> None:
        ids = placed["input_ids"]
        rows = ids.shape[0] * (ids.shape[1] if self.gas > 1 else 1)
        self.tput_timer.stop(tokens=ids.numel() * self.world_size,
                             samples=rows * self.world_size)

    def train_batches(self, batch) -> Dict[str, Any]:
        """K full steps. Batch leaves are [k, gas, micro, ...] when gas > 1,
        else [k, micro, ...]. Returns the last step's metrics, with
        ``mean_loss`` over the K steps and each metric's K values stacked
        under ``"steps"``. Random-LTD's keep and the curriculum's length are
        those of the window's first step, as in the reference. The window
        has no pre-step boundary for integrity (its stamps are voided); a
        window overlapping the poisoned cursors is consumed without running;
        a rollback inside it ends it, the metrics those of the steps
        accepted before it."""
        k = int(next(iter(batch.values())).shape[0])
        if self._micro:
            raise RuntimeError("train_batches: an imperative accumulation window is open")
        if self._onebit is not None or self._offload is not None or self._param_stream is not None:
            raise ValueError("train_batches requires the fully in-HBM fused path; the "
                             "1-bit/offload/param-stream runners interleave host work per "
                             "step — call train_batch per step instead")
        if self._integrity is not None:
            self._integrity.invalidate("train-batches-window")
        if self._health is not None and any(self._health.should_skip(self.data_cursor + i)
                                            for i in range(k)):
            out = None
            for _ in range(k):
                out = self._skip_poisoned_batch()
            return out
        self._apply_random_ltd()
        batch = self._apply_curriculum(batch)
        per_step, hinfo = [], None
        with self._watch_phase("compile" if not self._tb_dispatched else "step"):
            for i in range(k):
                self.tput_timer.start()
                placed = self._place_batch({name: v[i] for name, v in batch.items()},
                                           rows_axis=1 if self.gas > 1 else 0)
                metrics = self._step(placed)
                self._tb_dispatched = True
                self._last_loss = metrics["loss"]
                self._finish_step(metrics)
                self._stop_tput(placed)
                if self._health is not None:
                    hinfo = self._health.after_step(metrics)
                    if hinfo.get("rolled_back"):
                        break
                per_step.append(metrics)
        if not per_step:
            last = {"loss": float("nan"), "mean_loss": float("nan")}
        else:
            last = dict(per_step[-1])
            last["steps"] = {name: torch.stack([torch.as_tensor(m[name]) for m in per_step])
                             for name in per_step[-1]}
            last["mean_loss"] = last["steps"]["loss"].mean()
        if hinfo and hinfo.get("rolled_back"):
            last["health"] = hinfo
        self._maybe_drain()
        return last

    def forward(self, batch) -> torch.Tensor:
        """The training loss of one micro-batch (across ranks: its mean over
        them), with its graph kept for :meth:`backward`."""
        if self._onebit is not None:
            raise RuntimeError(
                "1-bit optimizers use the fused train_batch() API (the compressed stage is a "
                "single program; the split forward/backward/step surface cannot express "
                "per-rank gradient exchange)")
        if self._offload is not None or self._param_stream is not None:
            raise RuntimeError("ZeRO-Offload/Infinity uses the fused train_batch() API (the host "
                               "optimizer step is driven once per global batch)")
        # the imperative poison skip: at a window start a poisoned cursor arms
        # a gas-wide skip; the caller keeps its forward / backward / step
        # rhythm while the window's micro-batches are consumed unrun
        if (self._health is not None and self._skip_window_remaining == 0 and self._micro == 0
                and self._health.should_skip(self.data_cursor)):
            cursor = self.data_cursor
            self.data_cursor += 1
            self._health.note_skipped(cursor)
            self._skip_window_remaining = self.gas
            log_dist(f"health: skipping poisoned global batch at data cursor {cursor} "
                     f"({self.gas} micro-batch(es))")
        if self._skip_window_remaining > 0:
            self._skip_window_remaining -= 1
            self._skip_backward = True
            return (self._last_loss if self._last_loss is not None
                    else torch.full((), float("nan"), device=self.device))
        wcb = self.wall_clock_breakdown()
        if wcb:
            self.timers("forward").start()
        placed = self._place_batch(self._apply_curriculum(batch))
        scaled, loss = self._forward(placed)
        if self._eigenvalue is not None:  # probed at the next step() boundary
            self._ev_last_batch = placed
        self._pending = scaled
        loss = comm.all_reduce(loss, op="mean")
        self._last_loss = loss.detach()
        if wcb:
            self.timers("forward").stop(sync_on=loss)
        return loss

    def backward(self, loss: Optional[torch.Tensor] = None) -> None:
        """Accumulate the gradients of the last :meth:`forward`'s loss, then
        poll the drain: a micro-batch boundary, where the open window is
        state a save can carry."""
        if self._skip_backward:  # the forward was a skipped poisoned micro-batch
            self._skip_backward = False
            return
        if self._pending is None:
            raise RuntimeError("backward(): no forward() loss to differentiate")
        scaled, self._pending = self._pending, None
        self._accumulate(scaled)
        self._maybe_drain()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro >= self.gas

    def step(self) -> None:
        """Apply the optimizer iff at the accumulation boundary."""
        if not self.is_gradient_accumulation_boundary():
            return
        if self._grad_acc is None:
            raise RuntimeError("step(): gradient-accumulation boundary reached with no "
                               "accumulated gradients")
        wcb = self.wall_clock_breakdown()
        if wcb:
            self.timers("step").start()
        self._finish_step(self._boundary_step())
        if self._health is not None:
            # the boundary computes no loss: the window's last forward()'s
            # feeds the sentinel
            m = dict(self._last_metrics)
            if "loss" not in m and self._last_loss is not None:
                m["loss"] = self._last_loss
            self._health.after_step(m)
        if self._eigenvalue is not None and self._ev_last_batch is not None:
            self._update_curvature(self._ev_last_batch)
        if wcb:
            self.timers("step").stop(sync_on=self.state["step"])
        self._maybe_drain()

    # ------------------------------------------------------------------ eigenvalue
    def _ev_loss(self, params, batch) -> torch.Tensor:
        """The probe's loss: the model's loss at ``train=False`` (one stable
        function, no compression transform)."""
        out = self.model.apply(params, batch, train=False)
        return (out[0] if isinstance(out, tuple) else out).float()

    def _update_curvature(self, batch) -> None:
        """The per-layer eigenvalues refreshed every
        ``gas_boundary_resolution``-th step, on ``batch`` (this rank's rows;
        across ranks each Hessian-vector product is their mean). A model that
        cannot be differentiated twice (the attention kernels' Functions
        raise ``NotImplementedError``) logs and disables the probe, as the
        reference does; any other error propagates."""
        if self.global_steps % self._eigenvalue.gas_boundary_resolution != 0:
            return
        from .. import bridge

        params = bridge.join_tree(self.state["params"], self.param_specs)  # detached
        reduce = ((lambda hv: [comm.all_reduce(h, op="mean") for h in hv])
                  if self.world_size > 1 else None)
        try:
            ev = self._eigenvalue.compute(self._ev_loss, params, batch=batch, reduce=reduce)
        except (TypeError, NotImplementedError) as e:
            log_dist(f"eigenvalue: model does not support second-order differentiation ({e}); "
                     "disabling probe")
            self._eigenvalue = None
            return
        self._curvature_np = ev
        self.state["curvature"] = torch.as_tensor(ev, dtype=torch.float32, device=self.device)
        if self._monitor is not None:
            self._monitor.write_events([("Train/eigenvalue_mean", float(np.mean(ev)),
                                         self.global_steps)])

    # ------------------------------------------------------------------ info surface
    def comms_summary(self) -> str:
        """The facade's per-op collective counts and bytes (one record per
        executed call, so no scaling by steps), followed by the quantized
        wire's logical-vs-wire ledger when a quantized op ran."""
        out = comm.comms_logger.log_summary()
        if wire_ledger.records or wire_ledger.host_dma:
            # host_dma: the offload stream's copy column, quantized or not
            out += "\n" + wire_ledger.summary()
        return out

    def memory_stats(self) -> Dict[str, Any]:
        """The device's bytes in use and peak (``hbm_bytes_in_use``,
        ``hbm_peak_bytes``, on a CUDA device) and the host's resident bytes;
        under an offload runner, its last step's numbers too (``host_dma``,
        ``host_step_s``, ...)."""
        from .zero.offload import memory_stats

        runner = self._offload or self._param_stream
        return {**(runner.last_stats if runner is not None else {}),
                **memory_stats(self.device)}

    def tokens_per_sec(self) -> float:
        """Training throughput over the steps after the first (synchronises)."""
        return self.tput_timer.tokens_per_sec()

    def get_global_grad_norm(self) -> float:
        return float(self._last_metrics.get("grad_norm", 0.0))

    def get_lr(self) -> List[float]:
        return [float(self.lr_fn(self.global_steps))]

    def get_loss_scale(self) -> float:
        return float(self.state["scaler"].scale)

    def zero_optimization_stage(self) -> int:
        return self.config.zero_optimization.stage

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.micro_batch_size

    def gradient_accumulation_steps(self) -> int:
        return self.gas

    def set_train_batch_size(self, train_batch_size: int) -> None:
        """Change the global batch size through the accumulation steps; the
        micro-batch size stays."""
        per_step = self.micro_batch_size * self.world_size
        if train_batch_size % per_step:
            raise ValueError(f"train_batch_size {train_batch_size} not divisible by "
                             f"micro_batch x dp = {per_step}")
        self.gas = train_batch_size // per_step
        self.train_batch_size = train_batch_size
        self.config.gradient_accumulation_steps = self.gas
        self.config.train_batch_size = train_batch_size

    def load_universal_checkpoint(self) -> bool:
        """The reference's accessor. Every tag is universal here (each leaf
        is stored whole), so the flag selects no other path."""
        return bool(self.config.load_universal_checkpoint)

    # ------------------------------------------------------------------ checkpoint
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None, save_latest: bool = True) -> str:
        """A committed tag under ``save_dir`` (``global_step<N>`` by default);
        see :func:`deepspeed_tpu_torch.checkpoint.save_checkpoint`."""
        from ..checkpoint import save_checkpoint

        if self._integrity is not None:
            # the stamped blocks must still verify before a save blesses the
            # bytes: a committed rotten state would poison every later anchor
            from ..resilience.integrity import SDCError

            mismatches = self._integrity.verify_pending()
            if mismatches:
                raise SDCError(mismatches)
        with self._watch_phase("checkpoint"):
            return save_checkpoint(self, save_dir, tag=tag, client_state=client_state or {},
                                   save_latest=save_latest)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True) -> Tuple[Optional[str], dict]:
        """(tag directory, client_state) of the verified tag loaded, or
        (None, {}); see :func:`deepspeed_tpu_torch.checkpoint.load_checkpoint`."""
        from ..checkpoint import load_checkpoint

        out = load_checkpoint(self, load_dir, tag=tag,
                              load_optimizer_states=load_optimizer_states)
        if self._integrity is not None:
            self._integrity.invalidate("checkpoint-load")  # stamps over replaced state
        return out

    def save_16bit_model(self, save_dir: str, save_filename: str = "pytorch_model.npz") -> str:
        """The compute-dtype weights in one ``.npz``; see
        :func:`deepspeed_tpu_torch.checkpoint.save_16bit_model`."""
        from ..checkpoint import save_16bit_model

        return save_16bit_model(self, save_dir, save_filename)

    # ------------------------------------------------------------------ not ported yet
    def comms_verify(self, *args, **kwargs):
        raise unported("DeepSpeedEngine.comms_verify", "A9c")

    def measure_overlap(self, *args, **kwargs):
        raise unported("DeepSpeedEngine.measure_overlap", "A9c")

    def analyze(self, *args, **kwargs):
        raise unported("DeepSpeedEngine.analyze (static analysis)", "A14")


    # ------------------------------------------------------------------ resilience
    def install_preemption_guard(self):
        """Install the SIGTERM / SIGINT drain handlers (main thread only).
        ``resilience.enabled`` with ``install_signal_handlers`` does it at
        init; this is for an engine built off the main thread or with the
        handlers off."""
        if self._preemption_guard is None:
            from ..resilience import PreemptionGuard

            self._preemption_guard = PreemptionGuard()
        return self._preemption_guard.install()

    def request_drain(self, reason: str = "manual") -> None:
        """Save and exit at the next micro-batch boundary, as a SIGTERM
        would. Needs the ``resilience`` block (its ``save_dir``)."""
        if not self.config.resilience.enabled:
            raise ValueError("request_drain needs resilience.enabled with a save_dir: without "
                             "it the drain would be silently ignored at the next boundary")
        if self._preemption_guard is None:
            from ..resilience import PreemptionGuard

            self._preemption_guard = PreemptionGuard()
        self._preemption_guard.request_drain(reason)

    def _maybe_drain(self) -> None:
        """At a micro-batch boundary: when a drain was signalled, save an
        emergency tag and exit with ``resilience.exit_code``. Across ranks the
        flags are max-reduced first, so that every rank drains at the same
        boundary (the save is a collective)."""
        res = self.config.resilience
        if self._draining or not res.enabled:
            return
        if self._drain_polled_at == self.micro_steps:
            return  # backward() polled this boundary already
        self._drain_polled_at = self.micro_steps
        g = self._preemption_guard
        local = bool(g is not None and g.drain_requested)
        if self.world_size > 1:
            with self._watch_phase("collective"):
                flag = torch.full((1,), float(local), device=self.device)
                drain = bool(comm.all_reduce(flag, op="max").item() > 0)
        else:
            drain = local
        if not drain:
            return
        signal_name = g.signal_name if local and g is not None else "peer-preemption"
        self._draining = True  # the save marks its meta as emergency
        t0 = time.monotonic()
        log_dist(f"drain requested ({signal_name}): emergency checkpoint to {res.save_dir} at "
                 f"step {self.global_steps}")
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # every issued step has landed
            path = self.save_checkpoint(res.save_dir)
        except BaseException as e:
            if self._recovery_log is not None:
                self._recovery_log.record("emergency_save_failed", step=self.global_steps,
                                          error=str(e))
            logger.error(f"emergency checkpoint FAILED: {e}")
            raise SystemExit(1) from e
        if self._recovery_log is not None:
            self._recovery_log.record("emergency_save", value=time.monotonic() - t0,
                                      step=self.global_steps, tag=os.path.basename(path),
                                      signal=signal_name or "")
        log_dist(f"drain complete: {path} committed in {time.monotonic() - t0:.2f}s; exiting "
                 f"{res.exit_code}")
        raise SystemExit(res.exit_code)

    def _watch_phase(self, name: str):
        """The watchdog's deadline bracket for ``name``; inert without one."""
        if self._watchdog is not None:
            return self._watchdog.phase(name)
        return contextlib.nullcontext()

    def _watchdog_escalate(self, phase: str, elapsed: float) -> None:
        """A stall (from the watchdog's thread) becomes a drain request: if
        it clears, the next boundary saves and exits with the preemption
        code."""
        try:
            self.request_drain(f"watchdog-stall:{phase}")
        except Exception as e:  # escalation must never kill the watchdog
            logger.error(f"watchdog escalation failed: {e}")

    def _skip_poisoned_batch(self) -> Dict[str, Any]:
        """Consume one data cursor without running it (the poisoned window
        after a rollback); no optimizer step happens."""
        cursor = self.data_cursor
        self.data_cursor += 1
        self._health.note_skipped(cursor)
        log_dist(f"health: skipped poisoned batch at data cursor {cursor} (step stays "
                 f"{self.global_steps})")
        m = dict(self._last_metrics) if self._last_metrics else {"loss": float("nan")}
        m["skipped_batch"] = True
        m["skipped_cursor"] = cursor
        return m

    # ------------------------------------------------------------------ integrity
    def _init_integrity(self) -> None:
        """The integrity monitor over the device-resident state: the master
        copy and the optimizer state (a rank's slices at stages 1-2)."""
        from ..resilience.integrity import IntegrityMonitor

        icfg = self.config.resilience.integrity
        mon = IntegrityMonitor(scan_interval=icfg.scan_interval,
                               blocks_per_scan=icfg.blocks_per_scan,
                               block_bytes=icfg.block_bytes, recovery_log=self._recovery_log)
        runner = self._offload or self._param_stream
        if runner is not None:
            # the in-RAM host state (NVMe-backed state is not resident and is
            # not scanned); a chaos flip is a bit flipped in RAM
            mon.register_domain("host_shards", runner.host_units)
        else:
            mon.register_domain("master", self._device_master_units)
        self._integrity = mon
        log_dist(f"integrity: armed ({mon.algo}, scan every {mon.scan_interval} steps x "
                 f"{mon.blocks_per_scan} blocks of {mon.block_bytes} B, domains {mon.domains})")

    def _device_master_units(self) -> Dict[str, Any]:
        """The master and optimizer leaves keyed by their tree path, as the
        reference names them (``master['blocks']['qkv_w']``, ``opt.mu[...]``)."""
        out: Dict[str, Any] = {}

        def walk(prefix, node):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(f"{prefix}[{k!r}]", node[k])
            elif isinstance(node, tuple) and hasattr(node, "_fields"):
                for f in node._fields:
                    walk(f"{prefix}.{f}", getattr(node, f))
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(f"{prefix}[{i}]", v)
            elif isinstance(node, torch.Tensor):
                out[prefix] = node

        for name in ("master", "opt"):
            tree = self.state.get(name)
            if tree:
                walk(name, tree)
        return out

    def _integrity_prestep(self) -> Optional[Dict[str, Any]]:
        """Before the step: an armed chaos flip lands (inside a stamped
        block), then the stamped blocks are verified. A mismatch rolls back
        through the health controller (the window replayed, not skipped),
        or raises :class:`~..resilience.integrity.SDCError` without one."""
        from ..resilience.chaos import sdc_flip_fault
        from ..resilience.integrity import SDCError

        mon = self._integrity
        domain = sdc_flip_fault(self.data_cursor, scope="training")
        if domain is not None:
            mon.inject_flip(domain)
        mismatches = mon.verify_pending()
        if not mismatches:
            return None
        if self._health is None:
            raise SDCError(mismatches)
        info = self._health.sdc_rollback(mismatches[0])
        m = dict(self._last_metrics) if self._last_metrics else {"loss": float("nan")}
        m["health"] = {"rolled_back": info}
        m["sdc"] = mismatches
        return m

    def _integrity_poststep(self, batch, step_dt: float) -> None:
        """After the step: the next blocks of the rotation stamped (verified
        before the next step), the spot check, the boundary fingerprint."""
        mon = self._integrity
        mon.note_step_time(step_dt)
        if mon.scan_due(self.global_steps):
            stamped = mon.stamp_next()
            if stamped and self._recovery_log is not None:
                self._recovery_log.record("integrity_scan", value=float(stamped),
                                          step=self.global_steps, pending=mon.pending_blocks)
        sci = int(self.config.resilience.integrity.spot_check_interval or 0)
        if (sci > 0 and self.global_steps % sci == 0 and self._onebit is None
                and not self._qcomm.gradients and self._offload is None
                and self._param_stream is None):
            self._integrity_spot_check(batch)
        elif self._last_loss is not None:
            from ..resilience.fingerprint import fingerprint_array

            self._integrity_boundary_fp = fingerprint_array(
                torch.as_tensor(self._last_loss, dtype=torch.float32))

    def _integrity_spot_check(self, batch) -> None:
        """The redundant-compute canary: one micro-batch's loss and gradient
        norm (reduced over the ranks) computed twice on the current state (the
        same dropout seed, no update) and compared bitwise; the first doubles
        as the boundary fingerprint of the majority vote."""
        from ..resilience.fingerprint import fingerprint_bytes

        mon = self._integrity
        t0 = time.monotonic()
        mb = batch if self.gas == 1 else {k: v[0] for k, v in batch.items()}
        leaves = tree_leaves(self.state["params"])

        def canary() -> bytes:
            scaled, loss = self._forward(mb)
            grads = torch.autograd.grad(scaled, leaves, materialize_grads=True)
            # reduced over the ranks, as at the boundary: every rank's
            # fingerprint is then the same, and the vote can name a deviant
            gnorm = self._global_norm(self._reduce_grads([g.float() for g in grads]))
            loss = comm.all_reduce(loss.detach().float(), op="mean")
            return torch.stack([loss, gnorm.float()]).cpu().numpy().tobytes()

        fp_a = fingerprint_bytes(canary())
        fp_b = fingerprint_bytes(canary())
        self._integrity_boundary_fp = fp_a
        mon.record_spot_check(fp_a == fp_b, self.global_steps,
                              detail=None if fp_a == fp_b else
                              {"check": "spot", "fp_a": int(fp_a), "fp_b": int(fp_b)})
        mon.add_overhead(time.monotonic() - t0)

    def _straggler_poll(self, step_duration_s: float) -> None:
        """Every ``straggler_check_every`` steps across ranks: gather each
        rank's step time (and the integrity boundary fingerprint, for the
        majority vote) and name the outliers. A collective at a step
        boundary, never from the watchdog's thread."""
        if self._watchdog is None or self.world_size == 1:
            return
        wd = self.config.resilience.watchdog
        every = int(wd.straggler_check_every or 0)
        if every <= 0 or self.global_steps % every != 0:
            return
        from ..resilience.watchdog import allgather_host_stats, identify_stragglers

        fp = self._integrity_boundary_fp if self._integrity is not None else None
        stats = allgather_host_stats(step_duration_s, fingerprint=fp, device=self.device)
        if not stats:
            return
        if fp is not None:
            from ..resilience.integrity import fingerprint_vote

            _majority, deviants = fingerprint_vote(stats)
            for d in deviants:
                logger.error(f"integrity: rank {d['process_index']} ({d['hostname']!r}) "
                             "deviates from the majority boundary fingerprint at step "
                             f"{self.global_steps}: SDC suspect")
                if self._recovery_log is not None:
                    self._recovery_log.record("sdc_suspect", step=self.global_steps,
                                              hostname=d["hostname"],
                                              process_index=d["process_index"])
        for idx in identify_stragglers([s["step_s"] for s in stats], factor=wd.straggler_factor):
            s = stats[idx]
            logger.warning(f"straggler: rank {s['process_index']} ({s['hostname']!r}) took "
                           f"{s['step_s']:.2f}s against the median at step {self.global_steps}")
            if self._recovery_log is not None:
                self._recovery_log.record("straggler_detected", value=s["step_s"],
                                          step=self.global_steps, hostname=s["hostname"],
                                          process_index=s["process_index"])
