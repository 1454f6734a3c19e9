"""The training engine on one device (counterpart of
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
times 1/gas. The boundary is its ``_boundary_step``: the overflow check
(fp16 loss scaling), the global norm, clipping, the LR at the count of
steps taken so far, the optimizer on the master (or the params), and the
recast of the master to the compute dtype.

Nothing reads a device value back per leaf: metrics come back as 0-dim
tensors (``loss``, ``grad_norm``, ``lr``, ``loss_scale``, ``overflow``).
With fp16 loss scaling the engine reads the overflow flag once per step,
to skip the update. ZeRO stages 0-2 run at world size 1, where partitioning
over one rank is the identity. ``save_checkpoint`` / ``load_checkpoint``
write and read the reference's tagged format (:mod:`..checkpoint`), the
open accumulation window included.

ZeRO stage 3 runs at any world size of the process group
(``comm.init_distributed``; none is needed at world size 1). Each rank keeps
its slices of the parameters, of the fp32 master copy and of the optimizer
state (``zero/policy.py``), and takes its rows of the global batch. The
forward gathers the top-level leaves whole and, under the bound
:func:`~.zero.gather.gather_window`, the model gathers each layer just
before it runs (over the int wire with ``zero_quantized_weights``); the
gathers' backward mean-reduces each gradient to its owners' slices, so the
update is rank-local. The global norm for clipping, the overflow flag and
the reported loss are reduced over the ranks. A ``loss_mask`` across ranks
(a mean of per-rank means is not the global masked mean), LAMB's per-leaf
trust ratios over slices, and stages 1-2 across ranks raise ROADMAP.md A9b;
everything else the reference engine does and the port does not raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..accelerator import resolve_device, to_device
from ..comm import comm
from ..comm.runtime_accounting import wire_ledger
from ..models.api import Module
from ..ops.optimizers import Optimizer, get_optimizer
from ..utils.errors import unported
from ..utils.logging import log_dist
from ..utils.rng import fold_in
from ..utils.timer import ThroughputTimer
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .config import DeepSpeedConfig
from .lr_schedules import schedule_fn_from_config
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


class DeepSpeedEngine:
    """Training engine on one device. See the module docstring."""

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
        if self.world_size > 1 and stage < 3:
            raise unported(f"data parallelism across {self.world_size} ranks at ZeRO stage "
                           f"{stage}", "A9b")
        if self.train_batch_size != self.micro_batch_size * self.gas * self.world_size:
            raise ValueError(f"train_batch_size {self.train_batch_size} != micro "
                             f"{self.micro_batch_size} x gas {self.gas} x world "
                             f"{self.world_size}: load the config for this world size")
        if stage in (1, 2):
            log_dist(f"ZeRO stage {stage} at world size 1: partitioning over one rank is "
                     "the identity, so the update runs unsharded")
        self.zero_policy = ZeroShardingPolicy(config.zero_optimization, self.world_size,
                                              self.rank)
        cl = config.comms_logger
        if cl.enabled:
            comm.configure(enabled=True, verbose=cl.verbose or cl.debug, prof_all=cl.prof_all,
                           prof_ops=cl.prof_ops)

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
        if self.world_size > 1 and self.optimizer.name == "FusedLamb":
            raise unported("LAMB's per-leaf trust ratio over ZeRO-3 slices", "A9b")

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
        self.state = self._init_state()
        log_dist(
            f"engine ready: {count_parameters(tree_leaves(self.state['params'])) / 1e6:.1f}M "
            f"params, ZeRO stage {stage}, dtype {self.pc.compute_dtype}, device "
            f"{self.device}, micro_bs {self.micro_batch_size} x gas {self.gas}")
        if config.dump_state:
            config.print_config()

    # ------------------------------------------------------------------ state
    def _init_state(self) -> Dict[str, Any]:
        params_f32 = self.model.init(self.seed, device=self.device)
        # every rank builds the whole tree from the seed and keeps its slices
        self.param_specs = self.zero_policy.tree_param_specs(params_f32)
        self._leaf_dims = [t[0] for t in tree_leaves(
            tree_map(lambda p, d: (d,), params_f32, self.param_specs))]
        params_f32 = tree_map(lambda p, d: self.zero_policy.shard(p, d).clone(),
                              params_f32, self.param_specs)
        params = cast_to_compute(params_f32, self.pc)
        master = make_master(params_f32, self.pc)
        opt = self.optimizer.init(master if master is not None else params)
        return self._with_leaves({
            "params": params,
            "master": master if master is not None else {},
            "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=self.device),
            "micro": torch.zeros((), dtype=torch.int32, device=self.device),
            "scaler": init_scaler_state(self.pc, self.device),
        })

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
        missing = {"params", "master", "opt", "step", "micro", "scaler"} - set(state)
        if missing:
            raise ValueError(f"load_state: missing keys {sorted(missing)}")
        if bool(state["master"]) != self.pc.master_weights:
            raise ValueError("load_state: the master copy does not match the precision mode")
        self.state = self._with_leaves(dict(state))
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
            if "loss_mask" in batch:
                raise unported("a loss_mask across data-parallel ranks", "A9b")
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
        predivide = (float(self.config.gradient_predivide_factor or 1.0)
                     if self.config.prescale_gradients else 1.0)
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

    def _forward(self, batch):
        """The model's training loss on one placed micro-batch, with its graph."""
        with gather_window(self.config.zero_optimization, self.param_specs.get(STACKED)):
            out = self.model.apply(self._model_params(), batch,
                                   rngs={"dropout": self._micro_seed()}, train=True)
        loss, _ = out if isinstance(out, tuple) else (out, {})
        eff, _ = self._scales()
        return loss.float() * eff, loss

    def _accumulate(self, scaled_loss: torch.Tensor) -> None:
        """Gradients of ``scaled_loss`` w.r.t. the params, in fp32, unscaled,
        added times 1/gas into the accumulation buffer."""
        leaves = tree_leaves(self.state["params"])
        grads = torch.autograd.grad(scaled_loss, leaves, materialize_grads=True)
        grads = [g.float() for g in grads]  # bf16/fp16 leaves give grads in their dtype
        _, inv = self._scales()
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

    def _boundary_step(self) -> Dict[str, Any]:
        """The optimizer step at the accumulation boundary (the reference's
        ``_boundary_step``, overflow skip included)."""
        state = self.state
        grads = self._grad_acc
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
        target = state["master"] if has_master else state["params"]
        if do_update:
            with torch.no_grad():
                target, state["opt"] = self.optimizer.update(
                    tree_unflatten(target, grads), state["opt"], target, lr)
                if has_master:
                    for p, m in zip(tree_leaves(state["params"]), tree_leaves(target)):
                        p.copy_(m)  # the recast to the compute dtype
        loss_scale = state["scaler"].scale
        state["scaler"] = update_scaler(self.pc, state["scaler"], finite)
        state["step"] = state["step"] + 1
        state["micro"] = torch.zeros_like(state["micro"])
        self._micro = 0
        return {"grad_norm": gnorm, "lr": lr, "loss_scale": loss_scale, "overflow": ~finite,
                "_skipped": not do_update}

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm: the squares of the sliced leaves summed
        over the ranks, plus those of the leaves every rank holds whole."""
        if self.world_size == 1:
            return global_norm(grads)

        def sq(ts):
            if not ts:
                return torch.zeros((), dtype=torch.float32, device=self.device)
            return torch.stack(torch._foreach_norm([t.float() for t in ts])).square().sum()

        sliced = [g for g, d in zip(grads, self._leaf_dims) if d is not None]
        whole = [g for g, d in zip(grads, self._leaf_dims) if d is None]
        return torch.sqrt(comm.all_reduce(sq(sliced)) + sq(whole))

    def _finish_step(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        skipped = metrics.pop("_skipped")
        self.global_steps += 1
        self.data_cursor += 1
        self._last_metrics = metrics
        if skipped:
            self.skipped_steps += 1
            log_dist(f"step {self.global_steps}: non-finite grads, step skipped; loss scale "
                     f"-> {float(self.state['scaler'].scale)}")
        spp = self.config.steps_per_print
        if spp and self.global_steps % spp == 0:
            loss = metrics.get("loss")
            loss_str = f"loss={float(loss):.4f} " if loss is not None else ""
            log_dist(f"step={self.global_steps} {loss_str}lr={float(metrics['lr']):.3e} "
                     f"grad_norm={float(metrics['grad_norm']):.3f}")
        return metrics

    # ------------------------------------------------------------------ public API
    def train_batch(self, batch) -> Dict[str, Any]:
        """One full step: ``gas`` micro-batches and the optimizer update.
        ``batch`` arrays are [gas, micro, ...] when gas > 1, else [micro, ...]."""
        if self._micro:
            raise RuntimeError("train_batch: an imperative accumulation window is open "
                               f"({self._micro} of {self.gas} micro-steps); finish it with "
                               "step() first")
        self.tput_timer.start()
        batch = self._place_batch(batch, rows_axis=1 if self.gas > 1 else 0)
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
        metrics = self._boundary_step()
        loss = losses[0] if self.gas == 1 else torch.stack(losses).mean()
        metrics["loss"] = comm.all_reduce(loss, op="mean")
        self.tput_timer.stop(tokens=ids.numel() * self.world_size)
        return self._finish_step(metrics)

    def train_batches(self, batch) -> Dict[str, Any]:
        """K full steps. Batch leaves are [k, gas, micro, ...] when gas > 1,
        else [k, micro, ...]. Returns the last step's metrics, with
        ``mean_loss`` over the K steps and each metric's K values stacked
        under ``"steps"``."""
        k = int(next(iter(batch.values())).shape[0])
        per_step = [self.train_batch({name: v[i] for name, v in batch.items()})
                    for i in range(k)]
        out = dict(per_step[-1])
        out["steps"] = {name: torch.stack([torch.as_tensor(m[name]) for m in per_step])
                        for name in per_step[-1]}
        out["mean_loss"] = out["steps"]["loss"].mean()
        return out

    def forward(self, batch) -> torch.Tensor:
        """The training loss of one micro-batch (across ranks: its mean over
        them), with its graph kept for :meth:`backward`."""
        scaled, loss = self._forward(self._place_batch(batch))
        self._pending = scaled
        return comm.all_reduce(loss, op="mean")

    def backward(self, loss: Optional[torch.Tensor] = None) -> None:
        """Accumulate the gradients of the last :meth:`forward`'s loss."""
        if self._pending is None:
            raise RuntimeError("backward(): no forward() loss to differentiate")
        scaled, self._pending = self._pending, None
        self._accumulate(scaled)

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro >= self.gas

    def step(self) -> None:
        """Apply the optimizer iff at the accumulation boundary."""
        if not self.is_gradient_accumulation_boundary():
            return
        if self._grad_acc is None:
            raise RuntimeError("step(): gradient-accumulation boundary reached with no "
                               "accumulated gradients")
        self._finish_step(self._boundary_step())

    # ------------------------------------------------------------------ info surface
    def comms_summary(self) -> str:
        """The facade's per-op collective counts and bytes (one record per
        executed call, so no scaling by steps), followed by the quantized
        wire's logical-vs-wire ledger when a quantized op ran."""
        out = comm.comms_logger.log_summary()
        if wire_ledger.records:
            out += "\n" + wire_ledger.summary()
        return out

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

        return save_checkpoint(self, save_dir, tag=tag, client_state=client_state or {},
                               save_latest=save_latest)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True) -> Tuple[Optional[str], dict]:
        """(tag directory, client_state) of the verified tag loaded, or
        (None, {}); see :func:`deepspeed_tpu_torch.checkpoint.load_checkpoint`."""
        from ..checkpoint import load_checkpoint

        return load_checkpoint(self, load_dir, tag=tag,
                               load_optimizer_states=load_optimizer_states)

    def save_16bit_model(self, save_dir: str, save_filename: str = "pytorch_model.npz") -> str:
        """The compute-dtype weights in one ``.npz``; see
        :func:`deepspeed_tpu_torch.checkpoint.save_16bit_model`."""
        from ..checkpoint import save_16bit_model

        return save_16bit_model(self, save_dir, save_filename)

    # ------------------------------------------------------------------ not ported yet
    def comms_verify(self, *args, **kwargs):
        raise unported("DeepSpeedEngine.comms_verify", "A9b")

    def measure_overlap(self, *args, **kwargs):
        raise unported("DeepSpeedEngine.measure_overlap", "A9b")

    def analyze(self, *args, **kwargs):
        raise unported("DeepSpeedEngine.analyze (static analysis)", "A14")

    def install_preemption_guard(self, *args, **kwargs):
        raise unported("DeepSpeedEngine.install_preemption_guard", "A11")

    def request_drain(self, *args, **kwargs):
        raise unported("DeepSpeedEngine.request_drain", "A11")
