"""The 1-bit optimizers: 1-bit Adam, 1-bit LAMB and 0/1 Adam (counterpart of
``deepspeed_tpu/runtime/fp16/onebit.py``).

Two phases, switched on the host at ``freeze_step``, as in the reference:

- **warmup** (``global_steps < freeze_step``): the engine's dense step with
  the dense counterpart that ``ops.optimizers.get_optimizer`` returns for
  the name (Adam for ``onebitadam`` / ``zerooneadam``, LAMB for
  ``onebitlamb``);
- **compressed** (from ``freeze_step`` on): this runner's boundary. The
  engine's micro-steps accumulate each rank's LOCAL gradients (the mean of
  the micro-gradients with ``gas > 1``) and nothing reduces them; then
  - 1-bit Adam / LAMB fold the local gradient into the momentum and send
    the momentum through the compressed allreduce
    (``runtime/comm/compressed.py``); the variance stays frozen;
  - 0/1 Adam sends the gradient through it and updates the variance while
    ``count < var_freeze_step``.

  The buffers are flattened in the leaves' order and zero-padded to a
  multiple of ``world * 8``. The variance's bias correction freezes at the
  freeze step (``min(count, v_freeze)``: the reference's own choice, not
  upstream DeepSpeed's). LAMB's trust ratio is clipped to ``[min_coeff,
  max_coeff]`` per leaf. The fp32 master (or the fp32 params) is stepped and
  recast; there is no clipping in this stage; the reported ``grad_norm`` is
  the norm of the update over the real elements; the lr is ``lr_fn`` at the
  count of steps taken.

Each rank keeps its rows of the error-feedback residuals in
``state["onebit"]``: ``worker_error`` [1, Np] and ``server_error`` [1,
Np / W] (checkpoints store the reference's [W, Np] / [W, Np / W]). At stage
1 the master copy and the moments stay sliced: the compressed momentum is
the same on every rank, each keeps its slices of it, and 1-bit Adam / LAMB
all-gather the momentum's slices before folding the local gradient in. The
reference takes them whole on every rank; the values are the same.

Restrictions (the reference's): pure data parallelism, ZeRO stage 0 or 1,
no dynamic loss scaling, and the fused ``train_batch`` (the engine raises
the rest: ``zero_quantized_gradients``, progressive layer drop, random-LTD,
``compression_training``, ``train_batches`` and the imperative API).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from ...comm import comm
from ...ops.optimizers import AdamState, lamb_trust_ratios
from ...utils.logging import log_dist
from ...utils.tree import tree_leaves, tree_unflatten
from ..comm.compressed import compressed_allreduce

ONEBIT_TYPES = ("onebitadam", "onebitlamb", "zerooneadam")


@dataclasses.dataclass(frozen=True)
class OnebitParams:
    variant: str  # "onebitadam" | "onebitlamb" | "zerooneadam"
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    freeze_step: int = 100
    var_freeze_step: int = 100  # zerooneadam only
    max_coeff: float = 10.0  # LAMB's trust clip
    min_coeff: float = 0.01
    bias_correction: bool = True

    @classmethod
    def from_config(cls, variant: str, params: Dict[str, Any]) -> "OnebitParams":
        return cls(variant=variant, betas=tuple(params.get("betas", (0.9, 0.999))),
                   eps=params.get("eps", 1e-8), weight_decay=params.get("weight_decay", 0.0),
                   freeze_step=int(params.get("freeze_step", 100)),
                   var_freeze_step=int(params.get("var_freeze_step",
                                                  params.get("freeze_step", 100))),
                   max_coeff=params.get("max_coeff", 10.0),
                   min_coeff=params.get("min_coeff", 0.01),
                   bias_correction=params.get("bias_correction", True))


class OnebitRunner:
    """The compressed stage's boundary and error-feedback state of an engine."""

    def __init__(self, engine, variant: str, params: Dict[str, Any], n_elems: int):
        self.engine = engine
        self.p = OnebitParams.from_config(variant, params)
        if engine.zero_policy.stage >= 2:
            raise ValueError(f"{variant}: incompatible with ZeRO stage >= 2 (reference "
                             "parity); use stage 0/1")
        if engine.pc.loss_scaling:
            raise ValueError(f"{variant}: dynamic loss scaling unsupported; use bf16")
        self.world = engine.world_size
        pad_to = max(self.world * 8, 1)
        self.n_elems = int(n_elems)
        self.n_pad = -(-self.n_elems // pad_to) * pad_to
        self._announced = False
        log_dist(f"{variant}: freeze_step={self.p.freeze_step}, {self.n_elems} params (padded "
                 f"{self.n_pad}) over dp={self.world}")

    def init_state(self, device) -> Dict[str, torch.Tensor]:
        """This rank's rows of the error-feedback buffers."""
        zeros = lambda n: torch.zeros((1, n), dtype=torch.float32, device=device)  # noqa: E731
        return {"worker_error": zeros(self.n_pad), "server_error": zeros(self.n_pad // self.world)}

    def compressed(self) -> bool:
        """Whether the next boundary is a compressed one."""
        return self.engine.global_steps >= self.p.freeze_step

    # ------------------------------------------------------------------ layout
    def _flat(self, leaves: List[torch.Tensor]) -> torch.Tensor:
        flat = torch.cat([t.float().reshape(-1) for t in leaves])
        return torch.nn.functional.pad(flat, (0, self.n_pad - self.n_elems))

    def _full(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole leaves from the optimizer's layout (this rank's slices
        all-gathered)."""
        return [t if d is None else comm.all_gather(t, axis=d)
                for t, d in zip(leaves, self.engine._opt_dims)]

    def _sliced(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """A padded flat buffer as the leaves of the optimizer's layout."""
        e = self.engine
        out, off = [], 0
        for p, d in zip(tree_leaves(e.state["params"]), e._opt_dims):
            n = p.numel()
            out.append(e.zero_policy.shard(flat[off:off + n].reshape(p.shape), d))
            off += n
        return out

    # ------------------------------------------------------------------ the step
    def boundary(self) -> Dict[str, Any]:
        """The compressed stage's optimizer step on the accumulated local
        gradients (the reference's compressed ``step`` body)."""
        e, p = self.engine, self.p
        st = e.state
        b1, b2 = p.betas
        if not self._announced:
            log_dist(f"{p.variant}: entering compressed stage at step {e.global_steps} "
                     f"(freeze_step={p.freeze_step})")
            self._announced = True
        g_flat = self._flat(e._grad_acc)  # local, not reduced
        e._grad_acc = None
        opt, ob = st["opt"], st["onebit"]
        count = opt.count + 1
        cf = count.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=cf.device)
        bc1 = 1.0 - torch.pow(b1, cf) if p.bias_correction else one
        # the variance is frozen past its freeze step, so its bias correction
        # freezes with it
        v_freeze = float(p.var_freeze_step if p.variant == "zerooneadam" else p.freeze_step)
        bc2 = 1.0 - torch.pow(b2, torch.clamp_max(cf, v_freeze)) if p.bias_correction else one
        mu, nu = tree_leaves(opt.mu), tree_leaves(opt.nu)
        if p.variant == "zerooneadam":
            g_avg, w_new, s_new = compressed_allreduce(g_flat, ob["worker_error"][0],
                                                       ob["server_error"][0])
            g_avg = self._sliced(g_avg)
            m_new = [b1 * m + (1.0 - b1) * g for m, g in zip(mu, g_avg)]
            v_live = opt.count < p.var_freeze_step
            v_new = [torch.where(v_live, b2 * v + (1.0 - b2) * g * g, v)
                     for v, g in zip(nu, g_avg)]
        else:
            m_local = b1 * self._flat(self._full(mu)) + (1.0 - b1) * g_flat
            m_flat, w_new, s_new = compressed_allreduce(m_local, ob["worker_error"][0],
                                                        ob["server_error"][0])
            m_new, v_new = self._sliced(m_flat), nu
        upd = [(m / bc1) / (torch.sqrt(v / bc2) + p.eps) for m, v in zip(m_new, v_new)]
        gnorm = e._global_norm(upd)  # over the real elements only
        lr = torch.full((), float(e.lr_fn(e.global_steps)), dtype=torch.float32,
                        device=e.device)
        has_master = bool(st["master"])
        target = tree_leaves(st["master"] if has_master else e._opt_view(st["params"]))
        with torch.no_grad():
            t32 = [t if t.dtype == torch.float32 else t.float() for t in target]
            if p.weight_decay:
                upd = [u + p.weight_decay * t for u, t in zip(upd, t32)]
            if p.variant == "onebitlamb":
                sliced = [d is not None for d in e._opt_dims] if e.world_size > 1 else None
                trust = lamb_trust_ratios(t32, upd, p.min_coeff, p.max_coeff, sliced)
                upd = [u * s for u, s in zip(upd, trust)]
            for t, t_32, u in zip(target, t32, upd):
                t.copy_(t_32 - lr * u)
            e._publish(target, has_master)
        st["opt"] = AdamState(count=count, mu=tree_unflatten(opt.mu, m_new),
                              nu=tree_unflatten(opt.nu, v_new))
        st["onebit"] = {"worker_error": w_new[None], "server_error": s_new[None]}
        st["step"] = st["step"] + 1
        st["micro"] = torch.zeros_like(st["micro"])
        e._micro = 0
        return {"grad_norm": gnorm, "lr": lr,
                "loss_scale": torch.ones((), dtype=torch.float32, device=e.device),
                "overflow": torch.zeros((), dtype=torch.bool, device=e.device),
                "_skipped": False}
