"""ZeRO-Infinity's parameter stream: a model bigger than the device's memory
trains on one card (counterpart of ``deepspeed_tpu/runtime/zero/infinity.py``).

Every fp32 master, with its moments, lives in host RAM (or on NVMe through
:class:`~..swap_tensor.NVMeLeafStore`); the device holds a window of layer
units, the per-layer activations and one unit's gradients. The model's unit
decomposition (``Module.stream``, :class:`~...models.gpt.GPTStream`) gives
``embed`` / ``layer_0..L-1`` / ``final`` and their programs.

One step (``gradient_accumulation_steps`` 1):

- the forward streams the layer units host->device with
  ``offload_param.prefetch_depth`` d units in flight
  (:class:`~.stream.UnitFetchStream`; 0, or ``stream: false``, is
  fetch-on-demand) and keeps each layer's input; the last ``buffer_count``
  units stay on the device for the backward;
- the head's loss and its gradients (the final unit, the tied ``wte``, the
  hidden state);
- the backward re-streams the other units in reverse and recomputes each
  layer's forward from its saved input (the device never holds more than the
  window), and each unit's gradients, in the compute dtype, are copied
  device->host into pinned buffers as they come (:class:`~.stream.GradDrain`),
  the host waiting for a drain only when d (at least one) newer ones are
  queued; each unit's squared gradient norm is summed on the device;
- the embedding's gradients, with the head's ``wte`` gradient added on the
  host; the global norm, the clip and the host optimizer pass, which writes
  each leaf's bf16 push buffer in place (``bf16_out``).

The attention of each layer goes through the model's dispatch, so on the card
every layer's forward and its recompute run the flash forward kernel (B1)
and its backward the flash backward kernels (B2). Copies and compute are
ordered by events on the card: a unit's kernels wait for its copies' event,
the host synchronises a drain's event before it reads a gradient, and the
copy stream is synchronised before the host optimizer rewrites the push
buffers. Refused as in the reference: dynamic loss scaling, gradient
accumulation, a batch key other than ``input_ids`` / ``labels`` /
``loss_mask``.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...comm.runtime_accounting import HostDmaStats, wire_ledger
from ...utils.logging import log_dist
from ...utils.rng import fold_in
from .offload import host_optimizer, host_step, memory_stats
from .stream import (
    DeviceTransfer,
    GradDrain,
    PinnedHostStage,
    UnitFetchStream,
    fetch_wait,
    fill_push_buffer,
    flush_host_shards,
    load_host_shards,
    pinned_empty,
    quantized_push,
    uint16_view,
)

BATCH_KEYS = {"input_ids", "labels", "loss_mask"}


def _sq_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(g.float().square().sum() for g in grads.values())


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers (NaN payloads compare too)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _leaves_of(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fresh autograd leaves over a unit's tensors."""
    return {k: v.detach().requires_grad_(True) for k, v in tree.items()}


class ParamStreamRunner:
    """The host masters and the per-unit streamed step."""

    def __init__(self, engine):
        self.engine = engine
        cfg = engine.config
        if engine.pc.loss_scaling:
            raise ValueError("offload_param: use bf16 or fp32 (no dynamic loss scaling)")
        if engine.gas != 1:
            raise ValueError("offload_param streaming requires gradient_accumulation_steps=1 "
                             "(per-unit grads are consumed by the host optimizer as they "
                             "arrive; accumulate by raising train_micro_batch_size_per_gpu)")
        if engine.model.stream is None:
            raise ValueError("offload_param requires a model with a stream decomposition "
                             "hook (models.gpt.build provides one)")
        self.stream = engine.model.stream()
        self.cpu_opt, self._kind = host_optimizer(cfg.optimizer, "offload_param")
        self.cdtype = engine.pc.compute_dtype
        self.bf16 = self.cdtype == torch.bfloat16
        self.device = engine.device
        op = cfg.zero_optimization.offload_param
        # the last buffer_count layer units stay on the device for the backward
        self.keep_layers = max(0, int(op.buffer_count))
        self.prefetch_depth = int(op.effective_prefetch_depth)
        self.quantized_fetch = bool(op.quantized_fetch)
        self.qbits = int(cfg.zero_optimization.zero_quantize_bits)
        self.qblock = int(cfg.zero_optimization.zero_quantize_block_size)
        self.count = 0
        self.seed = int(engine.seed)
        self._leaves: Optional[List[Tuple[str, str, tuple]]] = None  # (unit, name, shape)
        self._unit_leaf_ids: Dict[str, List[int]] = {}
        self._state: Optional[Any] = None  # [(master, m, v)] or "nvme"
        self._push_bufs: List[torch.Tensor] = []
        self._grad_bufs: List[torch.Tensor] = []
        self.store = None
        if op.device == "nvme":
            from ..swap_tensor import NVMeLeafStore

            nvme_path = op.nvme_path or os.path.join(tempfile.gettempdir(), "ds_tpu_nvme_swap")
            self.store = NVMeLeafStore(os.path.join(nvme_path, "param_stream"),
                                       aio_threads=cfg.aio_threads(op.buffer_count or 4))
        self._stage = PinnedHostStage(self.device)
        self._drain = GradDrain(self.device)
        # on: each drained gradient is held against a synchronous copy of the
        # same device tensor (copy_check counts drains and mismatches)
        self.verify_copies = False
        self.copy_check = {"drains": 0, "tensors": 0, "mismatches": 0}
        self.last_stats: Dict[str, Any] = {}
        log_dist(f"ZeRO-Infinity param stream: {len(self.stream.unit_names())} units, host "
                 f"{self._kind}{', NVMe masters' if self.store is not None else ''}, "
                 f"keep_layers={self.keep_layers}, prefetch_depth={self.prefetch_depth}"
                 f"{' (fetch-on-demand)' if self.prefetch_depth == 0 else ''}"
                 f"{', quantized fetch' if self.quantized_fetch else ''}"
                 f"{', pinned staging' if self._stage.pinned else ''}")

    # `master is None` is the checkpoint layer's "initialised yet?" probe
    @property
    def master(self):
        return self._state

    # ------------------------------------------------------------------ host state
    def init_host_state(self, for_load: bool = False) -> None:
        """The masters, moments and pinned buffers, one unit at a time from
        the model's host init. ``for_load``: a checkpoint load follows."""
        self._leaves, self._unit_leaf_ids = [], {}
        self._push_bufs, self._grad_bufs = [], []
        state: List = []
        zeros: Dict[tuple, np.ndarray] = {}
        if self.store is not None:
            self.store.shapes = []
        units = self.stream.unit_names()
        # each unit draws from its own generator, whose fills release the GIL
        with ThreadPoolExecutor(max_workers=min(len(units), os.cpu_count() or 1)) as pool:
            inits = list(pool.map(lambda u: self.stream.init_unit(u, self.seed), units))
        for unit, init in zip(units, inits):
            ids = []
            for name in sorted(init):
                i = len(self._leaves)
                ids.append(i)
                master = init[name]
                shape = tuple(master.shape)
                self._leaves.append((unit, name, shape))
                self._push_bufs.append(pinned_empty(shape, self.cdtype, self.device))
                self._grad_bufs.append(pinned_empty(shape, self.cdtype, self.device))
                if self.store is not None:
                    self.store.shapes.append(shape)
                if for_load:
                    state.append(None)
                    continue
                fill_push_buffer(self._push_bufs[i], master)
                if self.store is not None:
                    z = zeros.setdefault(shape, np.zeros(shape, np.float32))
                    self.store.writeback(i, np.ascontiguousarray(master, np.float32), z, z)
                    self.store.drain()  # z is reused: the writes land first
                else:
                    state.append((master, np.zeros_like(master), np.zeros_like(master)))
            self._unit_leaf_ids[unit] = ids
        wte = self._leaves[self._index("embed", "wte")][2]
        self._dwte_buf = pinned_empty(wte, self.cdtype, self.device)
        self._state = "nvme" if self.store is not None else state

    def _index(self, unit: str, name: str) -> int:
        return next(i for i in self._unit_leaf_ids[unit] if self._leaves[i][1] == name)

    def _push_unit(self, unit: str, stats: Optional[HostDmaStats] = None) -> DeviceTransfer:
        """Issue one unit's host->device copies (over the quantized wire with
        ``quantized_fetch``) on the copy stream."""
        out = {}
        with self._stage.issuing():
            for i in self._unit_leaf_ids[unit]:
                name, buf = self._leaves[i][1], self._push_bufs[i]
                if self.quantized_fetch:
                    out[name] = quantized_push(buf, self._stage, self.qbits, self.qblock,
                                               self.cdtype, stats=stats)
                else:
                    nbytes = buf.numel() * buf.element_size()
                    if stats is not None:
                        stats.record_push(nbytes, nbytes)
                    out[name] = self._stage.put(buf)
            return DeviceTransfer(out, self._stage.fence())

    # ------------------------------------------------------------------ step
    def train_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        engine = self.engine
        unknown = set(batch) - BATCH_KEYS
        if unknown:
            raise ValueError("offload_param streaming understands batch keys input_ids/"
                             f"labels/loss_mask; got unknown {sorted(unknown)}")
        if self._state is None:
            self.init_host_state()
        s, cd = self.stream, self.cdtype
        ids = batch["input_ids"].long()
        labels, loss_mask = batch.get("labels"), batch.get("loss_mask")
        ids_in = s.forward_ids(ids, labels)  # seq+1 packing drops the last token
        L = s.n_layer
        keep = min(self.keep_layers, L)
        d = self.prefetch_depth
        drop_seed = engine._micro_seed()
        seeds = [fold_in(drop_seed, i) for i in range(L)]
        stats = HostDmaStats(prefetch_depth=d, quantized=self.quantized_fetch)
        watch = engine._watch_phase
        t_step = time.perf_counter()

        def fetch(unit):
            return self._push_unit(unit, stats=stats)

        host_grads: Dict[str, Dict[str, torch.Tensor]] = {}

        def issue_drain(unit: str, grads: Dict[str, torch.Tensor], bufs=None):
            bufs = bufs or {name: self._grad_bufs[self._index(unit, name)] for name in grads}
            names = sorted(grads)
            pairs = [(grads[n], bufs[n]) for n in names]
            return unit, names, pairs, self._drain.issue(pairs)

        def drain(pending):
            unit, names, pairs, event = pending
            wait = fetch_wait(event, watch)
            stats.record_grad_fetch(sum(h.numel() * h.element_size() for _, h in pairs), wait)
            if self.verify_copies:
                self._check_copies(pairs)
            host_grads[unit] = {n: h for n, (_, h) in zip(names, pairs)}

        # ---- forward: the layer units stream through the device
        emb = fetch("embed").consume()
        final = fetch("final").consume()
        with torch.no_grad():
            x = s.embed_fwd(emb, ids_in, cd)
        acts: List[Optional[torch.Tensor]] = [x]
        cache: Dict[int, Dict[str, torch.Tensor]] = {}
        fwd = UnitFetchStream(fetch, [f"layer_{i}" for i in range(L)], depth=d, stats=stats,
                              watch=watch)
        for i in range(L):
            w = fwd.take(f"layer_{i}")
            with torch.no_grad():
                x = s.layer_fwd(w, x, i, seeds[i])
            acts.append(x)
            if i >= L - keep:
                cache[i] = w
            del w

        # ---- head: the loss and its gradients w.r.t. (final, wte, x)
        with torch.enable_grad():
            final_g, wte_g = _leaves_of(final), emb["wte"].detach().requires_grad_(True)
            xg = acts[L].detach().requires_grad_(True)
            loss = s.head_loss(final_g, wte_g, xg, ids, labels, loss_mask)
            names = sorted(final_g)
            # an untied head leaves wte out of the loss: its gradient is zeros
            gs = torch.autograd.grad(loss.float(), [final_g[n] for n in names] + [wte_g, xg],
                                     allow_unused=True, materialize_grads=True)
        df = {n: g.to(cd) for n, g in zip(names, gs)}
        dwte_head, dx = gs[-2].to(cd), gs[-1].to(cd)
        del final_g, wte_g, xg, gs, final
        acts[L] = None
        gn2_dev = [_sq_norm(df)]
        pending = [issue_drain("final", df)]
        pending.append(issue_drain("head_wte", {"wte": dwte_head}, {"wte": self._dwte_buf}))
        del df, dwte_head

        # ---- backward: the other units re-streamed in reverse, each layer's
        # forward recomputed from its saved input
        bwd = UnitFetchStream(fetch, [f"layer_{i}" for i in reversed(range(L - keep))],
                              depth=d, stats=stats, watch=watch)
        bwd.prime()  # the first d copies land under the cached layers' backward
        queue: List[Tuple] = []
        for i in reversed(range(L)):
            w = cache.pop(i, None)
            if w is None:
                w = bwd.take(f"layer_{i}")
            with torch.enable_grad():
                wg = _leaves_of(w)
                xi = acts[i].detach().requires_grad_(True)
                y = s.layer_fwd(wg, xi, i, seeds[i])
                names = sorted(wg)
                gs = torch.autograd.grad(y, [wg[n] for n in names] + [xi], dx)
            dw = {n: g.to(cd) for n, g in zip(names, gs)}
            dx = gs[-1].to(cd)
            del w, wg, xi, y, gs
            acts[i + 1] = None
            gn2_dev.append(_sq_norm(dw))
            queue.append(issue_drain(f"layer_{i}", dw))
            del dw
            if len(queue) > max(1, d):  # the pipelined device->host drain
                drain(queue.pop(0))
        with torch.enable_grad():
            emb_g = _leaves_of(emb)
            xe = s.embed_fwd(emb_g, ids_in, cd)
            names = sorted(emb_g)
            gs = torch.autograd.grad(xe, [emb_g[n] for n in names], dx)
        demb = {n: g.to(cd) for n, g in zip(names, gs)}
        del emb_g, xe, gs, emb, dx, acts
        for p in queue:
            drain(p)
        drain(issue_drain("embed", demb))
        del demb
        for p in pending:
            drain(p)
        gn2_host = float(sum(gn2_dev))

        # ---- host: the global norm, the clip, the SIMD optimizer. The
        # embedding's gradients (with the head's tied wte) are summed and
        # normed here; every other unit's norm came from the device
        emb32 = {k: v.float().numpy() for k, v in host_grads["embed"].items()}
        emb32["wte"] = emb32["wte"] + host_grads["head_wte"]["wte"].float().numpy()
        host_grads["embed"] = emb32
        gnorm = math.sqrt(max(gn2_host + sum(float((g * g).sum()) for g in emb32.values()),
                              0.0))
        finite = math.isfinite(gnorm)
        clip = float(engine.config.gradient_clipping or 0.0)
        scale = clip / (gnorm + 1e-6) if (clip > 0.0 and gnorm > clip) else 1.0
        lr = float(engine.lr_fn(engine.global_steps))
        host_step_s = 0.0
        if finite:
            self.count += 1
            t0 = time.perf_counter()
            with watch("offload_flush"):
                # no copy issued this step may still read a push buffer
                self._stage.synchronize()
                self._apply_host_optimizer(host_grads, scale, lr)
            host_step_s = time.perf_counter() - t0
        engine.state["step"] = engine.state["step"] + 1
        engine.micro_steps += 1
        stats.step_s = time.perf_counter() - t_step
        self.last_stats = self._memory_stats()
        self.last_stats["host_step_s"] = host_step_s
        self.last_stats["host_dma"] = stats.to_dict()
        wire_ledger.set_host_dma(self.last_stats["host_dma"])
        dev = self.device
        return {"loss": loss.detach(), "grad_norm": torch.full((), gnorm, device=dev),
                "lr": torch.full((), lr, device=dev), "loss_scale": torch.ones((), device=dev),
                "overflow": torch.full((), not finite, dtype=torch.bool, device=dev),
                "_skipped": not finite}

    def _check_copies(self, pairs) -> None:
        """Each drained host buffer against a synchronous ``.cpu()`` of its
        device tensor, bit for bit."""
        self.copy_check["drains"] += 1
        for dev, host in pairs:
            self.copy_check["tensors"] += 1
            if not torch.equal(_bits(dev.detach().cpu()), _bits(host)):
                self.copy_check["mismatches"] += 1

    def _apply_host_optimizer(self, grads: Dict[str, Any], scale: float, lr: float) -> None:
        if self.store is not None:
            self.store.prefetch(0)
        for unit in self.stream.unit_names():
            unit_grads = grads[unit]
            for i in self._unit_leaf_ids[unit]:
                name = self._leaves[i][1]
                g = unit_grads[name]
                # fp32 and writable: the embedding's host sums, a bf16 buffer
                # widened, or an fp32 drain buffer itself (consumed here)
                g32 = (g if isinstance(g, np.ndarray) else g.float().numpy()).reshape(-1)
                if scale != 1.0:
                    g32 *= scale
                if self.store is not None:
                    if i + 1 < len(self._leaves):
                        self.store.prefetch(i + 1)
                    mst, m, v = self.store.get(i)
                else:
                    mst, m, v = self._state[i]
                out = uint16_view(self._push_bufs[i]).reshape(-1) if self.bf16 else None
                host_step(self, mst, m, v, g32, lr, out)
                if not self.bf16:
                    fill_push_buffer(self._push_bufs[i], mst)
                if self.store is not None:
                    self.store.writeback(i, mst, m, v)
            grads[unit] = None
        if self.store is not None:
            self.store.drain()

    # ------------------------------------------------------------------ stats
    def _memory_stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = memory_stats(self.device)

        def unit_size(u):
            return sum(int(np.prod(self._leaves[i][2])) for i in self._unit_leaf_ids.get(u, ()))

        itemsize = torch.empty((), dtype=self.cdtype).element_size()
        n_params = sum(int(np.prod(shape)) for (_, _, shape) in (self._leaves or []))
        L = self.stream.n_layer
        repushed = sum(unit_size(f"layer_{i}") for i in range(max(0, L - self.keep_layers)))
        out["n_params"] = n_params
        # the forward pushes every unit, the backward re-pushes the units not
        # kept, every unit's gradients come back: all in the compute dtype
        out["wire_bytes_per_step"] = (2 * n_params + repushed) * itemsize
        # the in-flight units past the live window sit on the device in the
        # compute dtype (a quantized fetch dequantizes at issue), its payload
        # beside them until the unit is taken
        per_elem = float(itemsize)
        if self.quantized_fetch:
            from ...comm.quantized import wire_bytes_per_element

            per_elem += wire_bytes_per_element(self.qbits, self.qblock)
        out["prefetch_depth"] = self.prefetch_depth
        out["stream_buffer_bytes"] = int(self.prefetch_depth * unit_size("layer_0") * per_elem)
        out["host_cores"] = os.cpu_count()
        return out

    # ------------------------------------------------------------------ checkpoint
    def flush_host_shards(self, dir_path: str, writer=None) -> bool:
        """One atomic ``shard_<k>.npz`` per unit (:func:`~.stream.flush_host_shards`),
        with the leaves' (unit, name) in the meta for ``zero_to_fp32``. Returns
        False with NVMe masters, whose format is ``host_optimizer.npz``."""
        if self.store is not None:
            return False

        def shards():
            for unit in self.stream.unit_names():
                arrays: Dict[str, np.ndarray] = {}
                for i in self._unit_leaf_ids[unit]:
                    mst, m, v = self._state[i]
                    arrays[f"master_{i}"], arrays[f"m_{i}"], arrays[f"v_{i}"] = mst, m, v
                yield unit, arrays

        with self.engine._watch_phase("offload_flush"):
            flush_host_shards(
                dir_path, shards(),
                meta={"count": int(self.count), "runner": "param_stream",
                      "leaves": [{"i": i, "unit": u, "name": n}
                                 for i, (u, n, _) in enumerate(self._leaves)]},
                writer=writer)
        return True

    def load_host_shards_dir(self, dir_path: str) -> None:
        d, meta = load_host_shards(dir_path)
        d["count"] = np.int64(meta.get("count", 0))
        self.load_host_state_dict(d)

    def host_units(self) -> Dict[str, np.ndarray]:
        """The in-RAM masters and moments as ``master_<i>`` / ``m_<i>`` /
        ``v_<i>`` (the arrays themselves; none with NVMe masters or before
        the init)."""
        out: Dict[str, np.ndarray] = {}
        if self.store is None and isinstance(self._state, list):
            for i, entry in enumerate(self._state):
                if entry is not None:
                    out[f"master_{i}"], out[f"m_{i}"], out[f"v_{i}"] = entry
        return out

    def host_state_dict(self) -> Dict[str, Any]:
        host = self.store.read_all() if self.store is not None else self.host_units()
        return {"count": np.int64(self.count), **host}

    def load_host_state_dict(self, d: Dict[str, Any]) -> None:
        if self._state is None:
            self.init_host_state(for_load=True)
        self.count = int(d["count"])
        n = len(self._leaves)
        self._stage.synchronize()
        if self.store is not None:
            self.store.write_all(d)
            for i in range(n):
                fill_push_buffer(self._push_bufs[i], d[f"master_{i}"])
            return
        self._state = [(np.array(d[f"master_{i}"], np.float32),
                        np.array(d[f"m_{i}"], np.float32),
                        np.array(d[f"v_{i}"], np.float32)) for i in range(n)]
        for i in range(n):
            fill_push_buffer(self._push_bufs[i], self._state[i][0])
