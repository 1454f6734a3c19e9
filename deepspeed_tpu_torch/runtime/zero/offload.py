"""ZeRO-Offload: the optimizer state in host RAM (or on NVMe), stepped by the
host SIMD optimizer (counterpart of ``deepspeed_tpu/runtime/zero/offload.py``).

The device holds only the compute-dtype parameters and runs the forward and
the backward. At the boundary the accumulated fp32 gradients are copied
device->host into pinned buffers on a drain stream (:class:`~.stream.GradDrain`);
the host synchronises that copy under the ``offload_fetch`` watchdog phase
(the chaos plan's ``stall_offload_at`` fires there), computes the global norm
and clips, then steps the fp32 masters and moments with
:class:`~...ops.adam.DeepSpeedCPUAdam` (Adam / AdamW) or
:class:`~...ops.adam.DeepSpeedCPUAdagrad` under ``offload_flush``; in bf16 the
host optimizer writes the bf16 copy of each updated master into its pinned
push buffer in the same pass. The push buffers are copied back into the
device parameters on the compute stream, so the next forward is ordered after
them; the host rewrites a push buffer only after the event recorded behind
those copies.

With ``offload_optimizer.device: "nvme"`` the masters and moments live in an
:class:`~..swap_tensor.NVMeLeafStore`, and the host loop reads leaf i+1 and
writes leaf i-1 back while it steps leaf i. The masters start as the
compute-dtype parameters widened to fp32 (the reference's). Loss scaling
(fp16) is refused, as the reference refuses it.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...ops.adam import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam
from ...utils.logging import log_dist
from ...utils.tree import tree_leaves
from .stream import GradDrain, fetch_wait, fill_push_buffer, pinned_empty, uint16_view


def host_optimizer(opt_cfg, what: str):
    """(the host optimizer of the ``optimizer`` block, its kind): Adam / AdamW
    (``"adam"``; the reference's ``adam_w_mode`` default is on) or Adagrad."""
    opt_type = (opt_cfg.type if opt_cfg else "Adam").lower()
    params = dict(opt_cfg.params) if opt_cfg else {}
    lr = float(params.get("lr", 1e-3))
    if opt_type in ("adam", "adamw", "fusedadam"):
        return DeepSpeedCPUAdam(
            lr=lr, betas=tuple(params.get("betas", (0.9, 0.999))),
            eps=params.get("eps", 1e-8), weight_decay=params.get("weight_decay", 0.0),
            adamw_mode=(opt_type != "adam") or params.get("adam_w_mode", True),
            bias_correction=params.get("bias_correction", True)), "adam"
    if opt_type == "adagrad":
        return DeepSpeedCPUAdagrad(lr=lr, eps=params.get("eps", 1e-10),
                                   weight_decay=params.get("weight_decay", 0.0)), "adagrad"
    raise ValueError(f"{what} supports Adam/AdamW/Adagrad on host (got {opt_type!r})")


def host_step(runner, mst: np.ndarray, m: Optional[np.ndarray], v: np.ndarray,
              g: np.ndarray, lr: float, bf16_out: Optional[np.ndarray]) -> None:
    """One leaf's host optimizer step, flat and in place."""
    if runner._kind == "adam":
        runner.cpu_opt.step(mst.reshape(-1), m.reshape(-1), v.reshape(-1), g.reshape(-1),
                            runner.count, lr=lr, bf16_out=bf16_out)
    else:
        runner.cpu_opt.step(mst.reshape(-1), v.reshape(-1), g.reshape(-1), lr=lr,
                            bf16_out=bf16_out)


def memory_stats(device: torch.device) -> Dict[str, int]:
    """The device's bytes in use and peak (the reference's ``hbm_*`` keys)
    and the process's resident host bytes."""
    out: Dict[str, int] = {}
    if device.type == "cuda":
        out["hbm_bytes_in_use"] = int(torch.cuda.memory_allocated(device))
        out["hbm_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    try:
        with open("/proc/self/statm") as f:
            out["host_rss_bytes"] = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        pass
    return out


class HostOffloadRunner:
    """Host-resident optimizer state and the gradients-only device step."""

    #: leaves per host shard file
    SHARD_LEAVES = 32

    def __init__(self, engine):
        self.engine = engine
        cfg = engine.config
        if engine.pc.loss_scaling:
            raise ValueError("ZeRO-Offload: use bf16 or fp32 (no dynamic loss scaling)")
        self.cpu_opt, self._kind = host_optimizer(cfg.optimizer, "ZeRO-Offload")
        self.count = 0
        self.device = engine.device
        self.bf16 = engine.pc.compute_dtype == torch.bfloat16
        self.master: Optional[Any] = None  # list of fp32 arrays, or "nvme"
        self.m: Optional[List] = None
        self.v: Optional[List] = None
        self.store = None
        oo = cfg.zero_optimization.offload_optimizer
        if oo is not None and oo.device == "nvme":
            from ..swap_tensor import NVMeLeafStore

            nvme_path = oo.nvme_path or os.path.join(tempfile.gettempdir(), "ds_tpu_nvme_swap")
            self.store = NVMeLeafStore(os.path.join(nvme_path, "optimizer"),
                                       aio_threads=cfg.aio_threads(oo.buffer_count))
        self._drain = GradDrain(self.device)
        self._pushed = None  # the event after the last push (CUDA)
        self.last_stats: Dict[str, Any] = {}
        log_dist(f"ZeRO-Offload: host {self._kind} (SIMD {self.cpu_opt._lib.ds_cpu_ops_simd()}, "
                 f"{os.cpu_count()} host cores"
                 + (", NVMe swap" if self.store is not None else "") + ")")

    # ------------------------------------------------------------------ state
    def _leaves(self) -> List[torch.Tensor]:
        return tree_leaves(self.engine.state["params"])

    def init_host_state(self, for_load: bool = False) -> None:
        """The host masters (the compute-dtype parameters in fp32), zero
        moments and the pinned gradient and push buffers. ``for_load``: a
        checkpoint load follows, so only the shapes are needed."""
        leaves = self._leaves()
        self._grad_bufs = [pinned_empty(p.shape, torch.float32, self.device) for p in leaves]
        self._push_bufs = [pinned_empty(p.shape, p.dtype, self.device) for p in leaves]
        if self.store is not None:
            if for_load:
                self.store.shapes = [tuple(p.shape) for p in leaves]
            else:
                self.store.write_init([p.detach().float().cpu().numpy() for p in leaves])
            self.master = "nvme"
            return
        if for_load:
            self.master = [None] * len(leaves)
            self.m = [None] * len(leaves)
            self.v = [None] * len(leaves)
            return
        self.master = [p.detach().float().cpu().numpy().copy() for p in leaves]
        self.m = [np.zeros_like(x) for x in self.master]
        self.v = [np.zeros_like(x) for x in self.master]

    def host_units(self) -> Dict[str, np.ndarray]:
        """The in-RAM masters and moments as ``master_<i>`` / ``m_<i>`` /
        ``v_<i>`` (the arrays themselves; none with NVMe masters or before
        the init)."""
        out: Dict[str, np.ndarray] = {}
        if self.store is None and isinstance(self.master, list):
            for i, (ms, mm, vv) in enumerate(zip(self.master, self.m, self.v)):
                if ms is not None:
                    out[f"master_{i}"], out[f"m_{i}"], out[f"v_{i}"] = ms, mm, vv
        return out

    def host_state_dict(self) -> Dict[str, Any]:
        host = self.store.read_all() if self.store is not None else self.host_units()
        return {"count": np.int64(self.count), **host}

    def load_host_state_dict(self, d: Dict[str, Any]) -> None:
        self.count = int(d["count"])
        n = len(self._leaves())
        if self.store is not None:
            self.store.write_all(d)
            masters = [np.asarray(d[f"master_{i}"], np.float32) for i in range(n)]
        else:
            self.master = [np.array(d[f"master_{i}"], np.float32) for i in range(n)]
            self.m = [np.array(d[f"m_{i}"], np.float32) for i in range(n)]
            self.v = [np.array(d[f"v_{i}"], np.float32) for i in range(n)]
            masters = self.master
        self._push_landed()
        for buf, mst in zip(self._push_bufs, masters):
            fill_push_buffer(buf, mst)
        self._push()

    # ------------------------------------------------------------------ step
    def _push(self) -> None:
        """The push buffers into the device parameters, on the compute stream
        (the next forward is ordered after them), then an event the host
        waits on before it rewrites a push buffer."""
        with torch.no_grad():
            for p, buf in zip(self._leaves(), self._push_bufs):
                p.copy_(buf, non_blocking=True)
        if self.device.type == "cuda":
            self._pushed = torch.cuda.Event()
            self._pushed.record(torch.cuda.current_stream(self.device))

    def _push_landed(self) -> None:
        """Block until the last push has read its host buffers."""
        if self._pushed is not None:
            self._pushed.synchronize()
            self._pushed = None

    def train_batch(self, batch) -> Dict[str, Any]:
        """One step on the placed ``batch`` ([gas, micro, ...] when gas > 1)."""
        engine = self.engine
        if self.master is None:
            self.init_host_state()
        t_step = time.perf_counter()
        leaves = self._leaves()
        acc, losses = None, []
        for k in range(engine.gas):
            mb = batch if engine.gas == 1 else {n: v[k] for n, v in batch.items()}
            _, loss = engine._forward(mb)
            grads = torch.autograd.grad(loss.float(), leaves, materialize_grads=True)
            grads = [g.float() for g in grads]
            if engine.gas > 1:
                torch._foreach_mul_(grads, 1.0 / engine.gas)
            if acc is None:
                acc = grads
            else:
                torch._foreach_add_(acc, grads)
            losses.append(loss.detach())
            engine.micro_steps += 1
        # the device->host gradient fetch, synchronised inside the bracket
        t0 = time.perf_counter()
        fetch_wait(self._drain.issue(zip(acc, self._grad_bufs)), engine._watch_phase)
        fetch_s = time.perf_counter() - t0
        del acc
        g_np = [b.numpy() for b in self._grad_bufs]
        gnorm = math.sqrt(sum(float((g ** 2).sum()) for g in g_np))
        clip = float(engine.config.gradient_clipping or 0.0)
        if clip > 0.0 and gnorm > clip:
            scale = clip / (gnorm + 1e-6)
            for g in g_np:
                g *= scale
        self.count += 1
        lr = float(engine.lr_fn(engine.global_steps))
        t0 = time.perf_counter()
        with engine._watch_phase("offload_flush"):
            self._host_step(g_np, lr)
        host_step_s = time.perf_counter() - t0
        engine.state["step"] = engine.state["step"] + 1
        self.last_stats = {**memory_stats(self.device), "fetch_s": fetch_s,
                           "host_step_s": host_step_s, "step_s": time.perf_counter() - t_step,
                           "host_cores": os.cpu_count()}
        dev = self.device
        loss = losses[0] if engine.gas == 1 else torch.stack(losses).mean()
        return {"loss": loss, "grad_norm": torch.full((), gnorm, device=dev),
                "lr": torch.full((), lr, device=dev),
                "loss_scale": torch.ones((), device=dev),
                "overflow": torch.zeros((), dtype=torch.bool, device=dev), "_skipped": False}

    def _host_step(self, g_np: List[np.ndarray], lr: float) -> None:
        """The host optimizer pass and the push (the ``offload_flush`` phase)."""
        self._push_landed()  # (the gradient drain's synchronisation implies it)
        for i, g in enumerate(g_np):
            if self.store is not None:
                if i == 0:
                    self.store.prefetch(0)
                if i + 1 < len(g_np):
                    self.store.prefetch(i + 1)
                mst, m, v = self.store.get(i)
            else:
                mst, m, v = self.master[i], self.m[i], self.v[i]
            out = uint16_view(self._push_bufs[i]).reshape(-1) if self.bf16 else None
            host_step(self, mst, m, v, g, lr, out)
            if not self.bf16:
                fill_push_buffer(self._push_bufs[i], mst)
            if self.store is not None:
                self.store.writeback(i, mst, m, v)
        if self.store is not None:
            self.store.drain()
        self._push()

    # ------------------------------------------------------------------ shards
    def flush_host_shards(self, dir_path: str, writer=None) -> bool:
        """The host state as groups of ``SHARD_LEAVES`` leaves per atomic
        ``shard_<k>.npz`` (:func:`~.stream.flush_host_shards`). Returns False in
        NVMe mode, whose format is the consolidated ``host_optimizer.npz``."""
        from .stream import flush_host_shards

        if self.store is not None:
            return False

        def shards():
            n = len(self.master)
            for k0 in range(0, n, self.SHARD_LEAVES):
                arrays: Dict[str, Any] = {}
                for i in range(k0, min(n, k0 + self.SHARD_LEAVES)):
                    arrays[f"master_{i}"] = self.master[i]
                    arrays[f"m_{i}"] = self.m[i]
                    arrays[f"v_{i}"] = self.v[i]
                yield f"leaves_{k0}", arrays

        with self.engine._watch_phase("offload_flush"):
            flush_host_shards(dir_path, shards(),
                              meta={"count": int(self.count), "runner": "offload"},
                              writer=writer)
        return True

    def load_host_shards_dir(self, dir_path: str) -> None:
        from .stream import load_host_shards

        d, meta = load_host_shards(dir_path)
        d["count"] = np.int64(meta.get("count", 0))
        self.load_host_state_dict(d)
