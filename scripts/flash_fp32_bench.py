#!/usr/bin/env python3
"""Times the fp32 flash-attention kernels of one checkout of the PyTorch/CUDA
port on one CUDA card: B1's forward and B2's dq and dk/dv (with delta) at
the kernel table's shapes, beside SDPA's forward and backward in fp32 and
both bounds (three TF32 passes at the TF32 peak; one fp32 pass on the CUDA
cores), B2's delta in fp32 and bf16 at the same backward shapes (phase 5b's
B8 x T512 H12 D64 among them) beside one ``einsum`` of rowsum(dO * O) and
its byte bound, and the device-busy time of ``chip_smoke.py`` phase 3's fp32
scoring forward (GPT-2-125M, B4 x T512) and of one phase 5a fp32 training
step (the same model and shape, one micro-step, AdamW + clipping).

    python3 scripts/flash_fp32_bench.py [--tree DIR] [--tag NAME] [--out FILE] [--no-paths]
                                        [--delta-sweep]

``--tree`` names the checkout whose ``deepspeed_tpu_torch`` is imported and
built (default: the one holding this script). To compare two commits on one
card, unpack the other with ``git archive`` into a directory ``.gitignore``
lists and run the two in turns, in one command: parent, change, change,
parent. Each row prints as one JSON line (also appended to ``--out``) with
the tree's route for fp32 inputs. Kernel times are CUDA events around one
call with the L2 flushed before it and the host's launch kept out (median
of 15), as ``chip_smoke.py`` times them; busy times are the kernels' self
times in a ``torch.profiler`` trace (mean of 3 calls after 2 warm-ups).
``--no-paths`` times the kernels alone; ``--delta-sweep`` adds delta over T
256-8192 with the L2 evicted by writes and by reads, beside ``torch.mul``
and an empty launch (what holds a byte-bound kernel of ~10 us).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)  # after --tree's entry, so that the tree's package is the one imported

from chip_smoke import (Timer, _engine, _fused_qkv, _sdpa_backward_ms,  # noqa: E402
                        _sdpa_forward, _train_config, device_kernels, flash_bound,
                        flash_bwd_bounds)

# (B, T, S, H, D, causal): the scoring / training shapes of GPT-2-125M (B4
# for B1, B8 for B2: phase 3 and phase 2's training row) and gpt2-760m's
# head dim 96 (phase 11)
FWD_SHAPES = [(4, 512, 512, 12, 64, True), (4, 512, 512, 16, 96, True),
              (4, 512, 512, 12, 128, True)]
BWD_SHAPES = [(8, 512, 512, 12, 64, True), (4, 512, 512, 16, 96, True),
              (4, 512, 512, 12, 128, True)]


def busy(torch, fn, reps: int = 3) -> float:
    """Mean device-busy ms of one call of ``fn`` (its kernels' self times)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    return sum(ms for _, _, ms in device_kernels(torch, lambda: [fn() for _ in range(reps)])) / reps


def kernel_rows(torch, fa, timer, emit, route):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for B, T, S, H, D, causal in FWD_SHAPES:
        q, k, v = _fused_qkv(randn, B, T, S, H, D, torch.float32)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
        bms, by = flash_bound(B, T, S, H, D, causal, "tf32x3", 4)
        cms, cby = flash_bound(B, T, S, H, D, causal, "float32", 4)
        emit({"kernel": "B1", "route": route, "B": B, "T": T, "S": S, "H": H, "D": D,
              "causal": causal, "dtype": "float32",
              "max_abs_err": (o - o_ref).abs().max().item(),
              "lse_err": (lse - lse_ref).abs().max().item(),
              "kernel_ms": timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal)),
              "library_ms": timer.ms(_sdpa_forward(torch, q, k, v, causal)),
              "bound_ms": bms, "bound_by": by, "cuda_core_bound_ms": cms,
              "cuda_core_bound_by": cby})
        del q, k, v, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()

    for B, T, S, H, D, causal in BWD_SHAPES:
        q, k, v = _fused_qkv(randn, B, T, S, H, D, torch.float32)
        do = randn((B, T, H, D), torch.float32)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        scale = 1.0 / math.sqrt(D)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        ref = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
        rel = max(((g - r).abs().max() / r.abs().max()).item() for g, r in zip(grads, ref))
        delta = fa.flash_attention_bwd_delta(o, do)
        ms = {
            "delta": timer.ms(lambda: fa.flash_attention_bwd_delta(o, do)),
            "dq": timer.ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                                             scale)),
            "dkv": timer.ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                                               scale)),
        }
        bounds = flash_bwd_bounds(B, T, S, H, D, causal, "tf32x3", 4)
        cc = flash_bwd_bounds(B, T, S, H, D, causal, "float32", 4)
        emit({"kernel": "B2", "route": route, "B": B, "T": T, "S": S, "H": H, "D": D,
              "causal": causal, "dtype": "float32", "max_rel_err": rel,
              **{f"{n}_ms": t for n, t in ms.items()},
              "dq+dkv_ms": ms["dq"] + ms["dkv"],
              "library_ms": _sdpa_backward_ms(torch, timer, q, k, v, do, causal),
              **{f"{n}_bound_ms": bounds[n][0] for n in ("dq", "dkv")},
              **{f"{n}_cuda_core_bound_ms": cc[n][0] for n in ("dq", "dkv")}})
        del q, k, v, do, o, lse, grads, ref, delta
        torch.cuda.empty_cache()

    # B2's delta (o and dO read once, delta written once: byte-bound) in fp32
    # and bf16, o a strided view of a fused buffer as the training path's is
    for B, T, S, H, D, causal in BWD_SHAPES:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            o = randn((B, T, 2 * H * D), dtype)[..., H * D:].reshape(B, T, H, D)
            do = randn((B, T, H, D), dtype)
            delta = fa.flash_attention_bwd_delta(o, do)
            bitwise = torch.equal(delta, fa.flash_attention_bwd_delta(o, do))
            err = (delta - fa.flash_attention_bwd_delta_ref(o, do)).abs().max().item()
            bms, by = flash_bwd_bounds(B, T, S, H, D, causal, dt, o.element_size())["delta"]
            emit({"kernel": "B2 delta", "B": B, "T": T, "H": H, "D": D, "dtype": dt,
                  "max_abs_err": err, "bitwise_rerun": bitwise,
                  "kernel_ms": timer.ms(lambda: fa.flash_attention_bwd_delta(o, do)),
                  "plain_ms": timer.ms(lambda: fa.flash_attention_bwd_delta_ref(o, do)),
                  "library_ms": timer.ms(lambda: torch.einsum("bthd,bthd->bht", o, do)),
                  "bound_ms": bms, "bound_by": by})
            del o, do, delta
            torch.cuda.empty_cache()


class ReadFlushTimer(Timer):
    """``Timer`` that evicts the L2 cache by reading 128 MB: the lines left
    behind are clean, so a kernel's reads evict nothing that must be written
    back first."""

    def flush(self):
        self.flush_buf.sum()


def delta_sweep(torch, fa, emit):
    """What holds B2's delta: its time at B8 H12 D64 over T 256-8192 (bf16
    and fp32), with the L2 evicted by writes (``Timer``, as every kernel is
    timed) and by reads, beside ``torch.mul(o, dO)`` (reads both, writes one)
    and an empty launch's time (``zero_`` of one element)."""
    timer, read_timer = Timer(torch), ReadFlushTimer(torch)
    one = torch.empty(1, device="cuda")
    emit({"kernel": "empty launch", "write_flush_ms": timer.ms(lambda: one.zero_()),
          "read_flush_ms": read_timer.ms(lambda: one.zero_())})
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, H, D = 8, 12, 64
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        for T in (256, 512, 1024, 2048, 4096, 8192):
            o, do = (torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
                     for _ in range(2))
            bms, _ = flash_bwd_bounds(B, T, T, H, D, True, dt, o.element_size())["delta"]
            emit({"kernel": "B2 delta sweep", "B": B, "T": T, "H": H, "D": D, "dtype": dt,
                  "bytes": 2 * o.numel() * o.element_size() + B * H * T * 4,
                  "write_flush_ms": timer.ms(lambda: fa.flash_attention_bwd_delta(o, do)),
                  "read_flush_ms": read_timer.ms(lambda: fa.flash_attention_bwd_delta(o, do)),
                  "mul_write_flush_ms": timer.ms(lambda: torch.mul(o, do)),
                  "mul_read_flush_ms": read_timer.ms(lambda: torch.mul(o, do)),
                  "bound_ms": bms})
            del o, do
            torch.cuda.empty_cache()


def path_rows(torch, emit, route):
    """Device busy of phase 3's fp32 scoring forward and of one phase 5a
    fp32 training step, with the flash kernels' share of each."""
    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    params = gpt.init_params(cfg, 0, device="cuda")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 512)).astype(np.int32)
    ids_t = torch.as_tensor(ids, device="cuda")

    def flash_ms(kernels):
        return sum(ms for name, _, ms in kernels if "flash_" in name)

    with torch.no_grad():
        def forward():
            gpt.forward(cfg, params, ids_t, train=False)

        total = busy(torch, forward)
        kernels = device_kernels(torch, forward)
    emit({"path": "phase 3 scoring forward, gpt2-125m B4xT512 fp32", "route": route,
          "device_busy_ms": total, "flash_ms": flash_ms(kernels)})
    del params
    torch.cuda.empty_cache()

    engine = _engine(_train_config(4), cfg)
    batch = {"input_ids": np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 512))
             .astype(np.int32)}

    def step():
        engine.train_batch(batch)

    total = busy(torch, step)
    kernels = device_kernels(torch, step)
    emit({"path": "phase 5a training step, gpt2-125m B4xT512 fp32 (one micro-step)",
          "route": route, "device_busy_ms": total, "flash_ms": flash_ms(kernels)})
    del engine
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--no-paths", action="store_true")
    ap.add_argument("--delta-sweep", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_fp32_bench.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    assert os.path.abspath(fa.__file__).startswith(os.path.abspath(args.tree)), fa.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else torch.cuda.get_device_name(0)
    route = fa.flash_route(torch.float32, 64) if hasattr(fa, "flash_route") else "cuda_cores"

    def emit(row):
        row = {"tag": args.tag, "tree": args.tree, "card": card, **row}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    kernel_rows(torch, fa, Timer(torch), emit, route)
    if args.delta_sweep:
        delta_sweep(torch, fa, emit)
    if not args.no_paths:
        path_rows(torch, emit, route)
    return 0


if __name__ == "__main__":
    sys.exit(main())
