#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (the script exits 1 otherwise and prints no
result line):

1. build: nvcc builds every kernel under ``deepspeed_tpu_torch/csrc`` (one
   process per source, all at once); TF32 is switched off for fp32 products.
2. kernels: each CUDA kernel against its plain PyTorch version on the same
   card inputs, at the shapes of the serving and scoring paths, with the
   kernel's time, the plain version's, one PyTorch library call's
   (``scaled_dot_product_attention``, a yardstick the port never calls) and
   the least time the card could take (``bound_ms``), all from CUDA events on
   a cold L2 cache.
3. scoring path: GPT-2-125M forward + next-token loss at B4 x T512 in fp32
   (the workload of ``__graft_entry__.entry()``) through the flash kernel.
4. serving path: ``init_inference(...).generate`` on GPT-2-125M, B4, prompt
   512, 64 new greedy tokens, through the decode kernel, in fp32 (tokens
   identical to the plain path) and bf16 (throughput, greedy match rate).

Each main path runs with every kernel's launch count set to 0 just before it
and read just after. The last lines are the card's name and power limit
(nvidia-smi), a ``{"kernels": [...]}`` line and the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
# tolerances of a kernel against its plain version: fp32 -- both accumulate
# in fp32, in another order; bf16/fp16 -- both round the output to 8 or 11
# mantissa bits, and a few ulps of O(1) outputs is up to 2e-2
ATOL = {"float32": 5e-5, "bfloat16": 2e-2, "float16": 2e-2}
LSE_ATOL = 1e-4  # fp32 logsumexp in every dtype

FLASH_SRC = "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu"
DECODE_SRC = "deepspeed_tpu_torch/csrc/decode_attention.cu"
FLASH_TPU = "deepspeed_tpu/ops/pallas/flash_attention.py:118"
DECODE_TPU = "deepspeed_tpu/ops/pallas/decode_attention.py:109"


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Median per-call device time from CUDA events, with the 50 MB L2
    flushed before each call (the callers on the main paths find their
    inputs cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 15, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(iters):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


def device_breakdown(torch, fn, wall_ms: float, top: int = 4) -> str:
    """Device-busy time of one call of ``fn`` from a torch.profiler trace (the
    sum of the CUDA kernels' self times), its share of ``wall_ms`` (the same
    call timed without the profiler), and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side rows only: a CPU op's row carries its kernels' time as well
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        return "device_busy_ms=not measured (the profiler saw no device time)"
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    tops = "; ".join(f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                     for e in kernels[:top])
    return (f"device_busy_ms={busy_ms:.3f} wall_ms={wall_ms:.3f} "
            f"device_idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} top: {tops}")


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(B, T, S, H, D, causal, dtype, elt):
    if causal:  # score entries this run needs: row t sees min(S, t + S - T + 1) keys
        t = np.arange(T)
        entries = int(np.clip(t + S - T + 1, 0, S).sum())
    else:
        entries = T * S
    flops = 4.0 * D * entries * B * H  # two products, 2 flops per multiply-add
    nbytes = (2 * B * T * H * D + 2 * B * S * H * D) * elt + B * H * T * 4  # q,o,k,v + lse
    return bound(nbytes, flops, dtype)


def decode_bound(lens, H, S, Dh, dtype, elt):
    positions = int(np.minimum(np.asarray(lens), S).sum()) * H
    nbytes = 2.0 * positions * Dh * elt + 2 * len(lens) * H * Dh * elt + 4 * len(lens)
    return bound(nbytes, 4.0 * Dh * positions, dtype)


# --------------------------------------------------------------------------- phases
def phase_build(torch, ctx):
    from deepspeed_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase1 tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"phase1 build: {len(_build.sources())} kernel sources in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase1 ptxas {name}: {line.strip()}")


def phase_kernels(torch, ctx):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    timer = ctx["timer"]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # B1 forward: the scoring shape in fp32 (the main-path row) and bf16, the
    # bottom-right causal case, non-causal, and head dim 128
    flash_cases = [(4, 512, 512, 12, 64, True, "float32"), (4, 512, 512, 12, 64, True, "bfloat16"),
                   (4, 128, 512, 12, 64, True, "float32"), (4, 128, 512, 12, 64, True, "bfloat16"),
                   (4, 256, 256, 12, 64, False, "float32"), (4, 256, 256, 12, 64, False, "bfloat16"),
                   (4, 512, 512, 12, 128, True, "float32"), (4, 512, 512, 12, 128, True, "bfloat16")]
    flash_err = 0.0
    for i, (B, T, S, H, D, causal, dt) in enumerate(flash_cases):
        dtype = getattr(torch, dt)
        q, k, v = randn((B, T, H, D), dtype), randn((B, S, H, D), dtype), randn((B, S, H, D), dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        flash_err = max(flash_err, err)
        mask = None
        if causal and T != S:  # SDPA's is_causal aligns top-left; pass the bottom-right mask
            mask = (torch.arange(S, device="cuda")[None, :]
                    <= torch.arange(T, device="cuda")[:, None] + (S - T))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=causal and mask is None)

        kernel_ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
        plain_ms = timer.ms(lambda: fa.flash_attention_ref(q, k, v, causal=causal))
        library_ms = timer.ms(library)
        bound_ms, bound_by = flash_bound(B, T, S, H, D, causal, dt, q.element_size())
        log(f"phase2 flash_attention_fwd B{B} T{T} S{S} H{H} D{D} causal={causal} {dt}: "
            f"max_abs_err={err:.3e} lse_err={lse_err:.3e} kernel_ms={kernel_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by})")
        check(err <= ATOL[dt], f"flash {flash_cases[i]}: max_abs_err {err} > {ATOL[dt]}")
        check(lse_err <= LSE_ATOL, f"flash {flash_cases[i]}: lse error {lse_err}")
        if i == 0:
            ctx["flash"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bound_ms, bound_by=bound_by)
    ctx["flash"]["max_abs_err"] = flash_err

    # B3: GPT-2-125M decode shapes (B4, H12, cache 640 = 512 + 64 padded to
    # 128, Dh 64); per-row lengths {1, 77, 513, 640}, then the serving path's
    # mid-run length 544 for every row in bf16 (the main-path row)
    B, H, S, Dh = 4, 12, 640, 64
    decode_cases = [([1, 77, 513, 640], "float32"), ([1, 77, 513, 640], "bfloat16"),
                    ([544] * 4, "bfloat16")]
    decode_err = 0.0
    for lens_list, dt in decode_cases:
        dtype = getattr(torch, dt)
        q = randn((B, 1, H, Dh), dtype)
        k, v = randn((B, H, S, Dh), dtype), randn((B, H, S, Dh), dtype)
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        out = da.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        err = (out.float() - da.decode_attention_ref(q, k, v, lens).float()).abs().max().item()
        decode_err = max(decode_err, err)
        valid = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)

        def library():
            return F.scaled_dot_product_attention(qt, k, v, attn_mask=valid)

        kernel_ms = timer.ms(lambda: da.decode_attention(q, k, v, lens))
        plain_ms = timer.ms(lambda: da.decode_attention_ref(q, k, v, lens))
        library_ms = timer.ms(library)
        bound_ms, bound_by = decode_bound(lens_list, H, S, Dh, dt, q.element_size())
        log(f"phase2 decode_attention B{B} H{H} S{S} Dh{Dh} lengths={lens_list} {dt}: "
            f"max_abs_err={err:.3e} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
        check(err <= ATOL[dt], f"decode {lens_list} {dt}: max_abs_err {err} > {ATOL[dt]}")
        ctx["decode"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    ctx["decode"]["max_abs_err"] = decode_err


def _reset_counts():
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    fa.launches = 0
    da.launches = 0
    return fa, da


def phase_scoring(torch, ctx):
    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    params = gpt.init_params(cfg, 0, device="cuda")
    ctx["params"] = params
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 512)).astype(np.int32)
    batch = {"input_ids": ids}
    with torch.no_grad():
        fa, da = _reset_counts()  # the scoring main path
        loss, _ = gpt.loss_fn(cfg, params, batch, train=False)
        torch.cuda.synchronize()
        flash_launches, decode_launches = fa.launches, da.launches
        loss = loss.item()
        plain = gpt.loss_fn(dataclasses.replace(cfg, use_flash=False), params, batch,
                            train=False)[0].item()
        ids_t = torch.as_tensor(ids, device="cuda")
        fwd_ms = ctx["timer"].ms(lambda: gpt.forward(cfg, params, ids_t, train=False),
                                 iters=5, warmup=2)
        profile = device_breakdown(
            torch, lambda: gpt.forward(cfg, params, ids_t, train=False), fwd_ms)
    log(f"phase3 scoring gpt2-125m B4xT512 fp32: loss={loss:.6f} plain_loss={plain:.6f} "
        f"|diff|={abs(loss - plain):.3e} ln(V)={math.log(cfg.vocab_size):.4f} "
        f"flash_launches={flash_launches} decode_launches={decode_launches} "
        f"forward_ms={fwd_ms:.3f}")
    log(f"phase3 scoring forward profile: {profile}")
    check(math.isfinite(loss), "scoring loss is not finite")
    check(abs(loss - math.log(cfg.vocab_size)) < 0.5, f"scoring loss {loss} far from ln(V)")
    check(abs(loss - plain) <= 1e-4, f"flash loss {loss} vs plain {plain}")
    check(flash_launches == cfg.n_layer, f"{flash_launches} flash launches, expected 12")
    ctx["flash"]["launches"] = flash_launches


def phase_serving(torch, ctx):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import for_gpt
    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    params = ctx["params"]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 512)).astype(np.int32)
    new = 64
    expected = cfg.n_layer * (new - 1)

    def run(engine, max_new=new):
        t0 = time.perf_counter()
        out = engine.generate(prompt, max_new_tokens=max_new)  # returns host numpy: synced
        return out, time.perf_counter() - t0

    for dtype in ("float32", "bfloat16"):
        engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype=dtype)
        plain = deepspeed_tpu_torch.init_inference(for_gpt(plain_cfg, params), dtype=dtype)
        run(engine, 2)  # warm-up
        fa, da = _reset_counts()  # the serving main path
        out, _ = run(engine)
        decode_launches, flash_launches = da.launches, fa.launches
        ref, _ = run(plain)
        check(out.shape == (4, 512 + new), f"generate shape {out.shape}")
        match = float(np.mean(out[:, 512:] == ref[:, 512:]))
        prefill_s = float(np.median([run(engine, 1)[1] for _ in range(3)]))
        total_s = float(np.median([run(engine)[1] for _ in range(3)]))
        tok_s = 4 * (new - 1) / (total_s - prefill_s)
        log(f"phase4 serving gpt2-125m B4 prompt512 new{new} {dtype}: "
            f"decode_launches={decode_launches} flash_launches={flash_launches} "
            f"greedy_match_rate={match:.4f} prefill_ms={prefill_s * 1e3:.2f} "
            f"generate_ms={total_s * 1e3:.2f} decode_tokens_per_s={tok_s:.1f}")
        log(f"phase4 serving {dtype} profile of 8 decode steps at position "
            f"{prompt.shape[1]}: "
            + _decode_profile(torch, engine, prompt, steps=8))
        check(decode_launches == expected,
              f"{dtype}: {decode_launches} decode launches, expected {expected}")
        if dtype == "float32":
            check(match == 1.0, f"fp32 generate differs from the plain path ({match})")
        else:
            ctx["decode"]["launches"] = decode_launches


def _decode_profile(torch, engine, prompt, steps: int) -> str:
    """Device breakdown of ``steps`` cached single-token forwards after a
    prefill of ``prompt``, as generate runs them."""
    model, params = engine.model, engine.params
    B, T = prompt.shape
    with torch.no_grad():
        cache = model.init_cache(B, -(-(T + steps) // 128) * 128, engine.dtype, engine.device)
        _, cache = model.prefill(params, torch.as_tensor(prompt, device=engine.device).long(),
                                 cache)
        tok = torch.zeros((B, 1), dtype=torch.long, device=engine.device)

        def decode():
            c = dict(cache)  # every call restarts at position T
            for _ in range(steps):
                _, c = model.prefill(params, tok, c)

        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return device_breakdown(torch, decode, float(np.median(walls[1:])) * 1e3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch  # noqa: F401  (fails where the repo is absent)

    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    ctx = {"timer": Timer(torch)}
    failures = []
    for phase in (phase_build, phase_kernels, phase_scoring, phase_serving):
        t0 = time.perf_counter()
        try:
            phase(torch, ctx)
        except Exception as e:  # report every phase, then fail the run
            failures.append(f"{phase.__name__}: {e}")
            traceback.print_exc()
            if phase is phase_build:
                break
        log(f"{phase.__name__} took {time.perf_counter() - t0:.1f} s")
    if failures:
        for f in failures:
            print(f"FAILED {f}", file=sys.stderr)
        return 1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": FLASH_SRC,
         "replaces": FLASH_TPU, **ctx["flash"]},
        {"name": "decode_attention", "route": "cuda", "source": DECODE_SRC,
         "replaces": DECODE_TPU, **ctx["decode"]},
    ]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    log(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
