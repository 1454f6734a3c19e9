"""FLOPs profiler (counterpart of ``deepspeed_tpu/profiling/flops_profiler.py``).

The reference asks XLA's ``cost_analysis`` for the compiled step's flops.
Here the step runs under ``torch.utils.flop_counter.FlopCounterMode``, which
counts the aten products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ...),
forward and backward, and counts no elementwise work (XLA's count includes
it). The hand-written kernels launch through ctypes, where no aten op is
seen, so each adds the flops of the product it computes while a count is
open (:func:`add_kernel_flops`): the flash forward (B1) 4·B·H·T·S·D and its
backward's dq and dk/dv kernels (B2) 4·B·H·T·S·D each, delta none; a
causal call counts the whole T×S product, masked entries included, because
the plain attention path computes and counts the whole product too, so a
step on the kernels reports the plain path's total. The blocksparse kernels
(B9) count the layout's visible blocks, forward 4·B·D·block²·(visible
blocks over the heads), dq and dk/dv 4·B·D·block²·(visible blocks) each; their
plain versions compute, and count, the dense masked product.

Latency comes from CUDA events on a CUDA device and from the host clock on
the CPU. The engine profiles the step at ``flops_profiler.profile_step``
and prints :meth:`FlopsProfiler.print_model_profile`.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..utils.logging import log_dist
from ..utils.tree import tree_leaves

# the kernel-flop tallies of the counts now open (one dict per count)
_open_counts: List[Dict[str, int]] = []


def counting() -> bool:
    """Whether a count is open."""
    return bool(_open_counts)


def add_kernel_flops(name: str, flops: int) -> None:
    """Add a hand-written kernel's flops to every open count (a no-op when
    none is open)."""
    for tally in _open_counts:
        tally[name] = tally.get(name, 0) + int(flops)


class FlopCount:
    """Counts the flops of the code it encloses: the aten products through
    ``FlopCounterMode`` plus the kernels' own counts."""

    def __init__(self):
        self.mode = FlopCounterMode(display=False)
        self.kernels: Dict[str, int] = {}

    def __enter__(self) -> "FlopCount":
        _open_counts.append(self.kernels)
        self.mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.mode.__exit__(*exc)
        _open_counts.remove(self.kernels)

    @property
    def aten_flops(self) -> int:
        return int(self.mode.get_total_flops())

    @property
    def total(self) -> int:
        return self.aten_flops + sum(self.kernels.values())


def _latency_s(fn: Callable[[], Any], device: torch.device, n_runs: int) -> float:
    """Mean seconds of ``fn`` over ``n_runs`` runs: CUDA events on a CUDA
    device, the host clock elsewhere."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(n_runs):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n_runs
    t0 = time.perf_counter()
    for _ in range(n_runs):
        fn()
    return (time.perf_counter() - t0) / n_runs


def profile_fn(fn: Callable[[], Any], device, n_timing_runs: int = 3) -> Dict[str, Any]:
    """``fn()`` once under a count (which also warms it up), then timed over
    ``n_timing_runs`` runs: flops (aten products plus kernels), the kernels'
    share by name, latency and achieved FLOP/s."""
    device = torch.device(device)
    with FlopCount() as count:
        fn()
    latency = _latency_s(fn, device, n_timing_runs)
    return {"flops": float(count.total), "aten_flops": float(count.aten_flops),
            "kernel_flops": dict(count.kernels), "latency_s": latency,
            "flops_per_s": count.total / latency if latency > 0 else 0.0,
            "device": str(device)}


def _tree_params(tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(tree))


class FlopsProfiler:
    """The engine's profiler: ``start_profile`` / ``stop_profile`` around any
    code, or :meth:`profile_train_batch` for one training step, then the
    ``get_total_*`` accessors and :meth:`print_model_profile`."""

    def __init__(self, engine=None, config=None):
        self.engine = engine
        self.config = config
        self.profile: Dict[str, Any] = {}
        self._count: Optional[FlopCount] = None
        self._t0 = 0.0

    def start_profile(self, ignore_list=None) -> None:
        self._count = FlopCount().__enter__()
        dev = self.engine.device if self.engine is not None else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._t0 = time.perf_counter()

    def stop_profile(self) -> None:
        if self._count is None:
            return
        dev = self.engine.device if self.engine is not None else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        latency = time.perf_counter() - self._t0
        self._count.__exit__(None, None, None)
        c, self._count = self._count, None
        self.profile = {"flops": float(c.total), "aten_flops": float(c.aten_flops),
                        "kernel_flops": dict(c.kernels), "latency_s": latency,
                        "flops_per_s": c.total / latency if latency > 0 else 0.0}

    def get_total_flops(self, as_string: bool = False):
        f = self.profile.get("flops", 0.0)
        return number_to_string(f, "FLOPs") if as_string else f

    def get_total_params(self, as_string: bool = False):
        if self.engine is None:
            return 0
        n = _tree_params(self.engine.state["params"])
        return number_to_string(n, "params") if as_string else n

    def get_total_duration(self, as_string: bool = False):
        d = self.profile.get("latency_s", 0.0)
        return f"{d * 1e3:.2f} ms" if as_string else d

    def profile_train_batch(self, batch, n_timing_runs: int = 3) -> Dict[str, Any]:
        """Profile the engine's training step on ``batch`` (the forward and
        backward of each micro-batch, as ``train_batch`` runs them) without
        changing the engine's state: no gradient is accumulated and no
        optimizer step is taken."""
        engine = self.engine
        batch = engine._apply_curriculum(batch)
        placed = engine._place_batch(batch, rows_axis=1 if engine.gas > 1 else 0)
        micro = ([placed] if engine.gas == 1
                 else [{k: v[i] for k, v in placed.items()} for i in range(engine.gas)])
        leaves = tree_leaves(engine.state["params"])

        def step():
            for mb in micro:
                scaled, _ = engine._forward(mb)
                torch.autograd.grad(scaled, leaves, materialize_grads=True)

        self.profile = profile_fn(step, engine.device, n_timing_runs)
        self.profile["batch_shape"] = tuple(int(v) for v in placed["input_ids"].shape)
        return self.profile

    def profile_modules(self, micro_bs: Optional[int] = None,
                        seq: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Per-unit decomposition (embed / layer x L / head / optimizer) when
        the engine's model carries a GPTConfig; None otherwise."""
        cfg = getattr(getattr(self.engine, "model", None), "gpt_config", None)
        if cfg is None:
            return None
        shape = self.profile.get("batch_shape")
        if micro_bs is None:
            micro_bs = self.engine.micro_batch_size
        if seq is None:
            seq = shape[-1] if shape else min(cfg.max_seq_len, 1024)
        self.profile["modules"] = per_module_profile(
            cfg, int(micro_bs), int(seq), device=self.engine.device,
            dtype=self.engine.pc.compute_dtype)
        return self.profile["modules"]

    def print_model_profile(self, profile_step: int = 1, module_depth: int = -1,
                            top_modules: int = 1, detailed: bool = True,
                            output_file: Optional[str] = None) -> str:
        lines = [
            "-------------------------- DeepSpeed Flops Profiler --------------------------",
            f"profile step:                   {profile_step}",
            f"params:                         {self.get_total_params(True)}",
            f"fwd+bwd flops per step:         {self.get_total_flops(True)}",
            f"of which hand-written kernels:  "
            f"{number_to_string(sum(self.profile.get('kernel_flops', {}).values()), 'FLOPs')}",
            "bytes accessed:                 not measured",
            f"step latency:                   {self.get_total_duration(True)}",
            f"achieved:                       "
            f"{number_to_string(self.profile.get('flops_per_s', 0), 'FLOPS')}",
        ]
        if detailed:
            modules = self.profile.get("modules")
            if modules is None:
                try:
                    modules = self.profile_modules()
                except Exception as e:  # the module tree is a report: training goes on
                    log_dist(f"flops-profiler module tree failed: {e}")
            if modules is not None:
                lines.append(format_module_tree(modules))
        text = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(text + "\n")
        else:
            log_dist(text)
        return text


def per_module_profile(cfg, micro_bs: int, seq: int, n_timing_runs: int = 3, device=None,
                       dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """One training step decomposed into the units the GPT is built from:
    embed (forward), one layer (forward, and backward alone) times L, the
    head's loss (forward and backward) and the AdamW update of one layer's
    fp32 master, scaled to the whole tree. Each unit is counted and timed
    on ``device`` in ``dtype`` from ``GPTStream``'s per-unit init (seed 0)."""
    import numpy as np
    import torch.nn.functional as F

    from ..accelerator import resolve_device
    from ..models import gpt
    from ..ops.optimizers import get_optimizer

    dev = resolve_device(device)
    s = gpt.GPTStream(cfg)
    L = cfg.n_layer

    def place(unit, grad=False):
        return {k: torch.from_numpy(v).to(dev, dtype).requires_grad_(grad)
                for k, v in s.init_unit(unit, 0).items()}

    emb, layer, final = place("embed"), place("layer_0", True), place("final", True)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (micro_bs, seq))).to(dev)
    positions = torch.arange(seq, device=dev).expand(micro_bs, seq)
    x = torch.from_numpy(rng.standard_normal((micro_bs, seq, cfg.d_model),
                                             np.float32)).to(dev, dtype).requires_grad_(True)
    units: Dict[str, Any] = {}
    with torch.no_grad():
        units["embed"] = {"params": _tree_params(emb), "count": 1, "fwd": profile_fn(
            lambda: gpt._embed(cfg, {**emb, "blocks": {"qkv_w": layer["qkv_w"]}}, ids,
                               positions), dev, n_timing_runs)}
        layer_fwd = profile_fn(lambda: gpt._block(cfg, x, layer, positions, layer_idx=0), dev,
                               n_timing_runs)
    out = gpt._block(cfg, x, layer, positions, layer_idx=0)
    dy = torch.ones_like(out)
    wl = [x, *tree_leaves(layer)]
    units["layer"] = {"params": _tree_params(layer), "count": L, "fwd": layer_fwd,
                      "bwd": profile_fn(lambda: torch.autograd.grad(out, wl, dy,
                                                                    retain_graph=True),
                                        dev, n_timing_runs)}
    wte = emb["wte"].detach().requires_grad_(True)

    def head_fwd_bwd():
        h = gpt.layer_norm(x, final["lnf_scale"], final["lnf_bias"], cfg.layer_norm_eps)
        logits = gpt._head(cfg, {"wte": wte, **final}, h)
        loss = F.cross_entropy(logits.float().flatten(0, 1), ids.flatten())
        return torch.autograd.grad(loss, [x, wte, *tree_leaves(final)], allow_unused=True)

    # an untied lm_head lives in the final unit; a tied head reuses wte (embed's)
    units["head"] = {"params": _tree_params(final), "count": 1,
                     "fwd_bwd": profile_fn(head_fwd_bwd, dev, n_timing_runs)}
    opt = get_optimizer("AdamW", {"lr": 3e-4, "weight_decay": 0.1})
    master = {k: v.detach().float() for k, v in layer.items()}
    grads = {k: torch.ones_like(v) for k, v in master.items()}
    state = opt.init(master)
    lr = torch.full((), 3e-4, device=dev)
    total_params = units["embed"]["params"] + L * units["layer"]["params"] \
        + units["head"]["params"]
    scale = total_params / max(units["layer"]["params"], 1)
    with torch.no_grad():
        one = profile_fn(lambda: opt.update(grads, state, master, lr), dev, n_timing_runs)
    units["optimizer"] = {
        "params": total_params, "count": 1,
        "update": {**one, "flops": one["flops"] * scale, "latency_s": one["latency_s"] * scale},
        "measured_unit": "one layer tree, scaled x%.1f" % scale,
    }
    step_flops = (units["embed"]["fwd"]["flops"]
                  + L * (layer_fwd["flops"] + units["layer"]["bwd"]["flops"])
                  + units["head"]["fwd_bwd"]["flops"] + units["optimizer"]["update"]["flops"])
    step_latency = (units["embed"]["fwd"]["latency_s"]
                    + L * (layer_fwd["latency_s"] + units["layer"]["bwd"]["latency_s"])
                    + units["head"]["fwd_bwd"]["latency_s"]
                    + units["optimizer"]["update"]["latency_s"])
    return {"micro_bs": micro_bs, "seq": seq, "n_layer": L, "d_model": cfg.d_model,
            "units": units, "totals": {"params": total_params, "flops": step_flops,
                                       "latency_s": step_latency}}


def format_module_tree(profile: Dict[str, Any]) -> str:
    """The per-module report: one line per unit with params, flops, latency
    and its share of the step's latency."""
    units, totals = profile["units"], profile["totals"]
    tot_lat = max(totals["latency_s"], 1e-12)

    def fmt(name, params, flops, lat, extra=""):
        share = lat / tot_lat * 100
        return (f"  ({name}): {number_to_string(params, 'params')}, "
                f"{number_to_string(flops, 'FLOPs')}, {lat * 1e3:.2f} ms ({share:.1f}%)"
                + (f" {extra}" if extra else ""))

    lyr, opt = units["layer"], units["optimizer"]
    return "\n".join([
        "GPT(",
        f"  step: micro_bs {profile['micro_bs']} x seq {profile['seq']}, "
        f"{number_to_string(totals['params'], 'params')}, "
        f"{number_to_string(totals['flops'], 'FLOPs')}, {totals['latency_s'] * 1e3:.2f} ms",
        fmt("embed", units["embed"]["params"], units["embed"]["fwd"]["flops"],
            units["embed"]["fwd"]["latency_s"]),
        fmt(f"layers x{lyr['count']}", lyr["params"] * lyr["count"],
            lyr["count"] * (lyr["fwd"]["flops"] + lyr["bwd"]["flops"]),
            lyr["count"] * (lyr["fwd"]["latency_s"] + lyr["bwd"]["latency_s"]),
            extra=(f"[per layer fwd {lyr['fwd']['latency_s'] * 1e3:.2f} ms, "
                   f"bwd {lyr['bwd']['latency_s'] * 1e3:.2f} ms]")),
        fmt("head", units["head"]["params"], units["head"]["fwd_bwd"]["flops"],
            units["head"]["fwd_bwd"]["latency_s"]),
        fmt("optimizer", opt["params"], opt["update"]["flops"], opt["update"]["latency_s"],
            extra=f"[{opt['measured_unit']}]"),
        ")",
    ])


def number_to_string(num: float, units: str = "") -> str:
    """``1.23 G<units>``-style: two decimals and a T / G / M / K prefix."""
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(num) >= scale:
            return f"{num / scale:.2f} {suffix}{units}"
    return f"{num:.2f} {units}"


def get_model_profile(model, batch, config: Optional[Dict] = None, device=None,
                      n_timing_runs: int = 3) -> Dict[str, Any]:
    """Flops, params and latency of one scoring forward of ``model.apply``
    (a ``models.api.Module``) on ``batch``, from the parameters of seed 0 on
    ``device`` (default: the CUDA device)."""
    from ..accelerator import resolve_device

    dev = resolve_device(device)
    params = model.init(0, device=dev)
    placed = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with torch.no_grad():
        prof = profile_fn(lambda: model.apply(params, placed, train=False), dev, n_timing_runs)
    prof["params"] = _tree_params(params)
    return prof
