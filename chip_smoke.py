#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (the script exits 1 otherwise and prints no
result line):

1. build: nvcc builds every kernel under ``deepspeed_tpu_torch/csrc`` (one
   process per source, all at once); TF32 is switched off for fp32 products;
   every instance of the tensor-core kernels holds HGMMA instructions in
   its SASS (``cuobjdump -sass`` of the built library).
2. kernels: each CUDA kernel against its plain PyTorch version on the same
   card inputs, at the shapes of the serving, scoring and training paths,
   with the kernel's time, the plain version's, one PyTorch library call's
   (``scaled_dot_product_attention`` forward, or its backward through
   ``torch.autograd.grad``, or for B2's delta one ``einsum``; for the paged
   B4 kernels SDPA over the already-gathered, already-dequantized cache,
   the gather excluded, with the gather + SDPA time beside it; for B6/B7
   the cuBLAS dense product over the weight already dequantized to x's
   dtype, the dequantize excluded: no PyTorch call computes the group
   layout; for the B5 verify kernels SDPA over the gathered cache with the
   window scattered in and a [B, H, W, S] mask, the gather excluded; the
   port never calls these) and the least
   time the card could take (``bound_ms``), all device time from CUDA
   events on a cold L2 cache (the host's launch overhead kept out, see
   ``Timer``). The flash backward (three kernels: delta, dq, dk/dv; dq and
   dk/dv on the tensor cores for bf16 / fp16, on the CUDA cores for fp32,
   each case printing its route, its launches and, in bf16 / fp16, its
   largest error in ulps of its dtype against the fp32 plain version, at
   most 2 over the entries of at least 1e-3 of the largest, beside the
   error of dV from a single cast of P, which must exceed it; the cases
   include phase 10b's B2 x T4096 and fp16 with small gradients) is also
   run twice on the same inputs and must give bitwise-equal gradients, and
   B5 (dense, int8, int4 pools) over 90 cases (windows 2-17, pages 8-128,
   fp32 and bf16) must agree with its plain version on the committable
   window positions and be bitwise equal on a re-run. B8 (the dequant-fused
   product of the quantized wire) at the LM head's shape (x [4096, 768],
   vocabulary 50304 padded to 197 blocks of 256; fp32 x, the main path,
   and bf16 x), M = 1 and 37, an effective block of 96, a block of 128, the
   [768, 2304] leaf and ragged D and F, bitwise on a re-run; its library
   yardstick is cuBLAS fp32 (TF32 off) over the weight already dequantized,
   with the dequantize + cuBLAS time beside it, and ptxas's report. B9
   (blocksparse attention: forward, dq with delta, dk/dv) over nine layouts
   (the sparse GPT-2-125M's Fixed unidirectional layout of 128-blocks at
   phase 10a's B2 x T1024 fp32 and 10b's B2 x T4096 bf16, the main-path
   row; bench.py's bidirectional Fixed row at B4 x T1024 H16 under causal;
   BigBird with a layout per head at block 64; Variable, BSLongformer and
   LocalSlidingWindow at blocks 16 and 32; D128 non-causal), the backward
   bitwise on a re-run; its yardstick is one SDPA call with the layout
   expanded to a boolean [H, T, T] mask (mask construction excluded) and
   that call's backward, with B1 / B2's dense causal times beside it.
3. scoring path: GPT-2-125M forward + next-token loss at B4 x T512 in fp32
   (the workload of ``__graft_entry__.entry()``) through the flash kernel.
4. serving path: ``init_inference(...).generate`` on GPT-2-125M, B4, prompt
   512, 64 new greedy tokens, through the decode kernel, in fp32 (tokens
   identical to the plain path) and bf16 (throughput, greedy match rate).
5. training path: ``initialize(model=build("gpt2-125m"), ...).train_batch``
   at full width and depth. (a) fp32, B4 x T512, AdamW + clipping, 5 steps
   through the flash kernels and 5 through plain attention from the same
   state: losses and grad norms agree, and each micro-step launches the
   forward and each backward kernel 12 times. (b) bf16 with the fp32 master
   and ZeRO stage 2 (the verify-notes configuration), B8 x T512, 10 steps on
   one batch: the loss starts near ln(V) and falls, the forward, delta and
   the tensor-core dq and dk/dv kernels launch 12 times a step and the
   CUDA-core dq and dk/dv never; step time, tokens/s, peak memory and a
   profiler breakdown of one step with B2's device time and its share of
   the busy time. (c) gas 2 x micro 4
   and gas 1 x micro 8 over the same 8 rows give the same grad norm.
6. paged serving: ``ServingEngine`` + ``run_continuous`` on GPT-2-125M with
   the reference's serving bench configuration (8 slots, page 64, model
   length 512, pool 17, prefill chunk 128; 24 open-loop requests at 8 rps,
   prompts 32-128, generations 16-96, seed 0), decode attention through the
   B4 kernels. (a) fp32 dense pools: every request finishes, the pool audit
   is clean, each request's tokens equal ``generate``'s and the
   ``kernel_impl="gather"`` run's, B4 launches 12 times per decode step and
   B1/B3 never. (b) bf16: TTFT, per-token time, tokens/s, the greedy match
   rate against the gather path, and a profiler breakdown of 8 decode steps
   at 8 active slots. (c) fp32 with a pool small enough to preempt: at least
   one preemption, tokens equal to (a)'s. (d) int8 and int4 pools, fp32:
   every request finishes with a clean audit; the kernel agrees with the
   gather path on the pools serving wrote, layer by layer; the free-running
   match rate against the gather path (at least 0.5) and (a), and the bytes
   a cached token costs.
7. quantized-weight inference (weights int8 or int4, group 128, through the
   B6 / B7 kernels in every decode projection). (a) GPT-2-125M fp32,
   ``init_inference(..., quant=...)``, B4, prompt 512, +64: tokens identical
   to a dense fp32 engine over the dequantized tree; B6 or B7 launch 4 x 12
   x 63 times (prefill, 2048 rows, takes the dequantize-then-matmul route)
   and B3 12 x 63. (b) the reference's ``gpt2-350m-decode-b8-int4`` bench
   row beside int8 and dense bf16: bf16, B8, prompt 128, +64; the marginal
   per-token decode latency (generate 16 vs 64, five repetitions, p50, as
   the reference's bench measures it), tokens/s, the block stacks' weight
   bytes, the greedy match rate against dense bf16 (reported only), and a
   profile of 8 decode steps. (c) phase 6's serving run over
   ``quantize_for_inference(bits=8)`` weights, fp32, dense pools: every
   request finishes, the audit is clean, tokens equal serving over the
   dequantized dense tree, and B6 launches 48 times per decode step.
8. speculative serving (n-gram drafts unless named, spec_k 4, decode_block
   1), every verify window's attention through B5. (a) phase 6's
   configuration, fp32 dense pools: tokens equal 6a's spec-off tokens and
   the gather path's; B5 launches 12 times a verify window and B4 12 times a
   fallback decode step. (b) the reference's gpt2-125m-serving-cb-spec
   shapes (16 slots, page 128, 32 requests, prompts 32-160, generations
   8-128) in bf16 at 8 rps, spec off and on: TTFT, TPOT, tokens/s, accept
   rate, tokens per verify call, the greedy match (reported only), and the
   device's idle share over 8 verify windows against 8 decode steps. (c)
   int8 and int4 pools, fp32: B5 against its plain version on the served
   pools, the spec-on vs spec-off match at least 0.5. (d) the draft-model
   drafter drafting with the target's own weights: tokens equal spec-off,
   accept rate at least 0.8, B3 12 times a single-token draft forward. (e)
   int8 weights, 12 requests: tokens equal spec-off over the same tree, B6
   48 times a verify window.

9. ZeRO-3 with the quantized weight wire and the quantized LM head
   (``zero_optimization: {stage: 3, zero_quantized_weights: true,
   zero_quantized_head: true}``) through ``initialize(...).train_batch`` on
   GPT-2-125M at full width and depth, one rank: every layer's leaves
   quantized and dequantized as they are gathered, the head's product
   through B8. (a) fp32, B4 x T512, AdamW + clipping, 5 steps through B8
   and 5 with B8's plain version in its place, from the same seed: losses
   and grad norms agree; B8 launches 5 times, B1/B2 12 times a micro-step.
   (b) bf16 with the fp32 master, B8 x T512, 10 steps on one batch: the
   loss starts near ln(V) and falls, B8 launches 10 times; step time, host
   issue time, tokens/s, peak memory and a profile of one step beside phase
   5b's ZeRO-2 step, and the wire ledger's ops and ratios. (c)
   ``comm.init_distributed`` over NCCL at world size 1 with a file store
   under ``build/``: one NCCL all-reduce, and ``qall_gather`` of a
   [768, 2304] leaf equal to quantize-then-dequantize, bitwise.

10. blocksparse attention: GPT-2-125M at full width and depth with
   ``sparse_attention=FixedSparsityConfig(num_heads=12, block=128,
   num_local_blocks=4, num_global_blocks=1, attention="unidirectional")``,
   every layer's attention through B9. (a) fp32, B2 x T1024 (GPT-2's own
   length): the scoring loss through B9 equals its plain versions' (12
   forward launches, no B1); 5 ``train_batch`` steps (AdamW + clipping)
   through B9 and 5 with its plain versions in their places, from the same
   seed and batches: losses and grad norms agree, and B9's forward, dq and
   dk/dv launch 60 times each, B1/B2 never. (b) bf16 with the fp32 master
   and ZeRO stage 2, B2 x T4096 (``max_seq_len=4096``), 10 steps on one
   batch: the loss starts near ln(V) and falls; step time, host issue time,
   tokens/s, peak memory and a profile of one step, beside the same model
   with dense attention (B1/B2, B2's share of the busy time reported) at
   the same shape (no gain claimed).

Each main path runs with every kernel's launch count set to 0 just before it
and read just after. The last lines are the card's name and power limit
(nvidia-smi), a ``{"kernels": [...]}`` line (19 kernels) and the ``{"ok": true, ...}``
line.
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

# tolerance of the flash backward against its plain version, relative to the
# largest gradient entry: fp32 -- both accumulate in fp32 in another order;
# bf16 -- both round the gradients to bf16 (2^-8)
BWD_RTOL = {"float32": 5e-5, "bfloat16": 2e-2, "float16": 2e-2}
# bf16 / fp16 gradients of the tensor-core kernels against the fp32 plain
# version, in ulps of the dtype: the kernels' fp32 sums differ from it by
# ~2^-16 (bf16) or ~2^-22 (fp16) of the terms (the hi/lo halves of P and dS,
# another order), so after both round to the dtype they are at most a
# rounding apart; entries below 1e-3 of the largest are left out, where
# cancellation makes an ulp of the entry smaller than the sums' error
BWD_MAX_ULP = 2
BWD_ULP_FLOOR = 1e-3

FLASH_SRC = "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu"
FLASH_BWD_SRC = "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu"
FLASH_BWD_TC_SRC = "deepspeed_tpu_torch/csrc/flash_attention_bwd_tc.cu"
DECODE_SRC = "deepspeed_tpu_torch/csrc/decode_attention.cu"
PAGED_SRC = "deepspeed_tpu_torch/csrc/paged_decode_attention.cu"
FLASH_TPU = "deepspeed_tpu/ops/pallas/flash_attention.py:118"
DECODE_TPU = "deepspeed_tpu/ops/pallas/decode_attention.py:109"
# B4's two bodies behind the one pallas_call (:260): dense, and int8 / int4
PAGED_TPU = {"dense": "deepspeed_tpu/ops/pallas/decode_attention.py:269",
             "kv8": "deepspeed_tpu/ops/pallas/decode_attention.py:277",
             "kv4": "deepspeed_tpu/ops/pallas/decode_attention.py:277"}
PAGED_KINDS = {"dense": None, "kv8": 8, "kv4": 4}
VERIFY_SRC = "deepspeed_tpu_torch/csrc/paged_verify_attention.cu"
VERIFY_TPU = "deepspeed_tpu/ops/pallas/decode_attention.py:443"  # _verify_kernel, call :434
# the backward's three pallas_call sites in _bwd
BWD_TPU = {"delta": "deepspeed_tpu/ops/pallas/flash_attention.py:277",
           "dq": "deepspeed_tpu/ops/pallas/flash_attention.py:291",
           "dkv": "deepspeed_tpu/ops/pallas/flash_attention.py:309"}
BWD_KERNELS = ("delta", "dq", "dkv")
# the tensor-core dq and dk/dv kernels that bf16 / fp16 inputs take
BWD_TC_KERNELS = ("dq_tc", "dkv_tc")
# the backward kernels each dtype's main path launches
BWD_PATH = {"float32": BWD_KERNELS, "bfloat16": ("delta", *BWD_TC_KERNELS)}
# each tensor-core library and the kernels whose every instance must hold
# wgmma (HGMMA in SASS)
TC_KERNELS = {"flash_attention_bwd_tc": ("flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")}
QMM_SRC = "deepspeed_tpu_torch/csrc/int8_matmul.cu"
QMM_TPU = {"int8": "deepspeed_tpu/ops/pallas/int8_matmul.py:42",
           "int4": "deepspeed_tpu/ops/pallas/int8_matmul.py:145"}
QUANT_GROUP = 128
DQM_SRC = "deepspeed_tpu_torch/csrc/dequant_matmul.cu"
DQM_TPU = "deepspeed_tpu/ops/pallas/dequant_matmul.py:41"  # _kernel, call :86
BS_FWD_SRC = "deepspeed_tpu_torch/csrc/blocksparse_attention_fwd.cu"
BS_BWD_SRC = "deepspeed_tpu_torch/csrc/blocksparse_attention_bwd.cu"
# B9: _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel (calls :186, :215, :239)
BS_TPU = {"fwd": "deepspeed_tpu/ops/pallas/blocksparse_attention.py:68",
          "dq": "deepspeed_tpu/ops/pallas/blocksparse_attention.py:102",
          "dkv": "deepspeed_tpu/ops/pallas/blocksparse_attention.py:133"}
BS_KERNELS = ("fwd", "dq", "dkv")
# the sparse GPT-2-125M's layout (phases 2 and 10): Sparse Transformers'
# fixed pattern, 4 local blocks of 128 and the last one of each window global
SPARSE_GPT_LAYOUT = dict(num_heads=12, block=128, num_local_blocks=4, num_global_blocks=1,
                         attention="unidirectional")
# B6/B7 against their plain versions, relative to the largest output entry:
# fp32 -- both accumulate in fp32 in another order; bf16 -- both round once
QMM_RTOL = {"float32": 5e-5, "bfloat16": 2e-2}


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
    inputs cold).

    With ``device_only`` (for a kernel's time) the stream spins for ~1 ms
    on the device before each start event, so the host has queued the whole
    call before the device reaches the event: the time between the events
    is the device's work alone, not the host's launch overhead (a ctypes
    call, autograd's dispatch) waited out by an idle device. Without it
    (for a path's time) the host's overhead counts, as a caller feels it."""

    HOST_LEAD_CYCLES = 2_000_000  # ~1 ms at the H100's 1.98 GHz boost clock

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 15, warmup: int = 3, device_only: bool = True) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(iters):
            self.flush_buf.zero_()
            if device_only:
                torch.cuda._sleep(self.HOST_LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


def device_kernels(torch, fn):
    """The CUDA kernels of one call of ``fn`` from a torch.profiler trace, as
    [(name, count, self device ms)], largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side rows only: a CPU op's row carries its kernels' time as well
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: r[2], reverse=True)


def device_breakdown(torch, fn, wall_ms: float, top: int = 4, kernels=None) -> str:
    """Device-busy time of one call of ``fn`` (the sum of the CUDA kernels'
    self times in a profiler trace), its share of ``wall_ms`` (the same call
    timed without the profiler), and the kernels that take the most."""
    kernels = kernels if kernels is not None else device_kernels(torch, fn)
    busy_ms = sum(r[2] for r in kernels)
    if busy_ms == 0:
        return "device_busy_ms=not measured (the profiler saw no device time)"
    tops = "; ".join(f"{name[:48]} x{count} {ms:.3f} ms" for name, count, ms in kernels[:top])
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


def causal_pairs(T, S, causal):
    """Visible (query, key) pairs of one (b, h): row t sees min(S, t + S - T + 1) keys."""
    if not causal:
        return T * S
    return int(np.clip(np.arange(T) + S - T + 1, 0, S).sum())


def flash_bwd_bounds(B, T, S, H, D, causal, dtype, elt):
    """Least time of each backward kernel: (delta, dq, dkv) -> (ms, by).
    delta reads o and dO and writes delta; dq does 3 products per visible
    pair (q k^T, dO v^T, dS k) and reads q, k, v, dO, lse, delta, writes dq;
    dkv does 4 (q k^T, dO v^T, P^T dO, dS^T q) and writes dk, dv. The whole
    backward needs 5 products (``bwd_total``): the two passes recompute 2."""
    pairs = causal_pairs(T, S, causal) * B * H
    qo = B * T * H * D * elt  # one of q, o, dO, dq
    kv = B * S * H * D * elt  # one of k, v, dk, dv
    rows = B * H * T * 4  # lse or delta, fp32
    return {
        "delta": bound(2 * qo + rows, 2.0 * B * T * H * D, dtype),
        "dq": bound(3 * qo + 2 * kv + 2 * rows, 6.0 * D * pairs, dtype),
        "dkv": bound(2 * qo + 4 * kv + 2 * rows, 8.0 * D * pairs, dtype),
        "bwd_total": bound(4 * qo + 4 * kv + 2 * rows, 10.0 * D * pairs, dtype),
    }


def decode_bound(lens, H, S, Dh, dtype, elt):
    positions = int(np.minimum(np.asarray(lens), S).sum()) * H
    nbytes = 2.0 * positions * Dh * elt + 2 * len(lens) * H * Dh * elt + 4 * len(lens)
    return bound(nbytes, 4.0 * Dh * positions, dtype)


def verify_bound(lens, W, H, Dh, ps, bits, dtype, q_elt):
    """Least time of one verify call: the pool's K/V rows below each length
    at the pool's element size, the table entry (and for quantized pools the
    two scales) of every page they touch, q, the window's K and V and o once
    each; 4 * Dh flops per (query, visible key): each window query sees its
    row's history and on average (W + 1) / 2 window positions."""
    lens = np.asarray(lens)
    row = Dh * q_elt if bits is None else (Dh if bits == 8 else Dh // 2)
    pages = int((-(-lens // ps)).sum())
    B = len(lens)
    nbytes = (2.0 * int(lens.sum()) * H * row + 4 * pages + (2 * 4 * H * pages if bits else 0)
              + 4 * B * W * H * Dh * q_elt + 4 * B)
    flops = 4.0 * H * W * Dh * (float(lens.sum()) + B * (W + 1) / 2)
    return bound(nbytes, flops, dtype)


def paged_bound(lens, H, Dh, ps, bits, dtype, q_elt):
    """Least time of one paged call: the K/V rows below each length at the
    pool's element size (half a byte for int4), the table entry (and, for
    quantized pools, the two scales) of every page they touch, q read and o
    written; 4 * Dh flops per position."""
    lens = np.asarray(lens)
    positions = int(lens.sum()) * H
    row = Dh * q_elt if bits is None else (Dh if bits == 8 else Dh // 2)
    pages = int((-(-lens // ps)).sum())
    nbytes = (2.0 * positions * row + 4 * pages + (2 * 4 * H * pages if bits else 0)
              + 2 * len(lens) * H * Dh * q_elt + 4 * len(lens))
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
    for lib, kernels in TC_KERNELS.items():
        counts = sass_tensor_ops(_build, lib)
        for kernel in kernels:
            per_instance = sorted(c for fn, c in counts.items() if kernel in fn)
            log(f"phase1 sass {lib} {kernel}: {len(per_instance)} instances, "
                f"HGMMA per instance {per_instance}")
            check(bool(per_instance) and min(per_instance) > 0,
                  f"{kernel} in {lib}: an instance without wgmma ({per_instance})")


def sass_tensor_ops(_build, lib: str) -> dict:
    """HGMMA (wgmma) instructions in each function of a built library's SASS."""
    from pathlib import Path

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target(lib))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


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
    phase_kernels_bwd(torch, ctx, randn)
    phase_kernels_paged(torch, ctx)
    phase_kernels_verify(torch, ctx)
    phase_kernels_qmatmul(torch, ctx)
    phase_kernels_dequant(torch, ctx)
    phase_kernels_blocksparse(torch, ctx, randn)


def dqm_bound(M, D, F, Fp, nb, elt):
    """Least time of one B8 product: x, the uint8 payload and its fp32
    scales and zero-points read once, the output written once; 2 flops per
    multiply-add at the fp32 peak (the kernel computes in fp32 whatever x's
    dtype)."""
    nbytes = M * D * elt + D * Fp + 8 * D * nb + M * F * elt
    return bound(nbytes, 2.0 * M * D * F, "float32")


def phase_kernels_dequant(torch, ctx):
    """B8 against its plain version: the main-path shape (the GPT-2-125M LM
    head at B8 x T512, x fp32 as the forward casts it, and with bf16 x),
    M = 1 and 37, D 64 x F 96 (an effective block of 96), a block of 128,
    the qkv leaf [768, 2304], ragged D and F; every case also bitwise on a
    re-run. The main-path row is timed against its plain version, cuBLAS
    fp32 (TF32 off) over the weight already dequantized, and the dequantize
    plus cuBLAS."""
    from deepspeed_tpu_torch.comm.quantized import dequantize_blockwise, quantize_blockwise
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    timer = ctx["timer"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    V = 50304
    cases = [(4096, 768, V, 256, "float32"), (4096, 768, V, 256, "bfloat16"),
             (1, 768, V, 256, "float32"), (37, 768, V, 256, "float32"),
             (64, 64, 96, 256, "float32"), (256, 768, 3072, 128, "float32"),
             (2048, 768, 2304, 256, "float32"), (2048, 768, 2304, 256, "bfloat16"),
             (100, 300, 1000, 256, "float32"), (37, 768, 3000, 128, "bfloat16")]
    worst = 0.0
    payloads = {}
    for M, D, F, block, dt in cases:
        if (D, F, block) not in payloads:
            w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
            payloads[(D, F, block)] = quantize_blockwise(w, bits=8, block_size=block)
        q, s, z = payloads[(D, F, block)]
        x = torch.randn((M, D), generator=gen, device="cuda").to(getattr(torch, dt))
        out = dqm.dequant_matmul(x, q, s, z, orig_size=F)
        again = dqm.dequant_matmul(x, q, s, z, orig_size=F)
        torch.cuda.synchronize()
        ref = dqm.dequant_matmul_ref(x, q, s, z, orig_size=F)
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-30)
        worst = max(worst, err)
        kernel_ms = timer.ms(lambda: dqm.dequant_matmul(x, q, s, z, orig_size=F), iters=7)
        bound_ms, bound_by = dqm_bound(M, D, F, q.shape[1], s.shape[1], x.element_size())
        line = (f"phase2 dequant_matmul M{M} D{D} F{F} Fp{q.shape[1]} block{q.shape[1] // s.shape[1]} "
                f"{dt}: max_abs_err={err:.3e} rel_err={rel:.3e} "
                f"bitwise_rerun={torch.equal(out, again)} kernel_ms={kernel_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by})")
        if (M, D, F, dt) == (4096, 768, V, "float32"):
            w_hat = dequantize_blockwise(q, s, z, orig_size=F)
            plain_ms = timer.ms(lambda: dqm.dequant_matmul_ref(x, q, s, z, orig_size=F), iters=7)
            library_ms = timer.ms(lambda: torch.matmul(x, w_hat), iters=7)
            deq_library_ms = timer.ms(
                lambda: torch.matmul(x, dequantize_blockwise(q, s, z, orig_size=F)), iters=7)
            line += (f" plain_ms={plain_ms:.4f} library_ms(cuBLAS fp32, TF32 off, dequantize "
                     f"excluded)={library_ms:.4f} dequantize+cuBLAS_ms={deq_library_ms:.4f} "
                     f"kernel_tflops={2.0 * M * D * F / kernel_ms / 1e9:.2f}")
            ctx["dqm"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
            del w_hat
        log(line)
        check(torch.equal(out, again), f"dequant_matmul {M, D, F, block, dt}: two runs differ")
        check(rel <= QMM_RTOL[dt], f"dequant_matmul {M, D, F, block, dt}: rel error {rel}")
        del out, again, ref
    ctx["dqm"]["max_abs_err"] = worst
    for line in _build.build_logs.get("dequant_matmul", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"phase2 dequant_matmul ptxas: {line.strip()}")
    torch.cuda.empty_cache()


def qmm_bound(M, D, F, group, bits, dtype, elt):
    """Least time of one quantized product: the weight payload (a byte per
    weight, half for int4), its fp32 scales, x read and out written once;
    2 flops per multiply-add at the peak of x's dtype."""
    nbytes = D * F * bits / 8 + 4 * D * F / group + (M * D + M * F) * elt
    return bound(nbytes, 2.0 * M * D * F, dtype)


def phase_kernels_qmatmul(torch, ctx):
    """B6 (int8) and B7 (int4) against their plain versions at the four
    projection shapes of GPT-2-125M and of gpt2-350m, at the decode and
    prefill-chunk row counts, group 128, fp32 and bf16; int8 also at group 64
    and at a group that crosses rows. The kernels' rows of the result line
    are GPT-2-125M's mlp_up at M=4 in fp32, phase 7a's decode shape."""
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im
    from deepspeed_tpu_torch.ops.quantizer import dequantize, quantize

    timer = ctx["timer"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(768, 2304), (768, 768), (768, 3072), (3072, 768),
              (1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
    cases = [(M, D, F, QUANT_GROUP, bits, dt) for bits in (8, 4) for dt in ("float32", "bfloat16")
             for D, F in shapes for M in (1, 4, 8, 64, 256)]
    cases += [(M, D, F, g, 8, dt) for dt in ("float32", "bfloat16")
              for M, D, F, g in ((8, 768, 3072, 64), (8, 320, 960, 128))]
    errs = {8: 0.0, 4: 0.0}
    weights = {}
    for M, D, F, group, bits, dt in cases:
        dtype = getattr(torch, dt)
        key = (D, F, group, bits)
        if key not in weights:
            w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
            q, s = quantize(w, bits=bits, num_groups=D * F // group)
            weights[key] = (im.pack_int4(q) if bits == 4 else q, s)
        q, s = weights[key]
        x = torch.randn((M, D), generator=gen, device="cuda").to(dtype)
        kernel_fn, plain_fn = ((im.int4_matmul, im.int4_matmul_ref) if bits == 4
                               else (im.int8_matmul, im.int8_matmul_ref))
        out = kernel_fn(x, q, s, group)
        again = kernel_fn(x, q, s, group)
        torch.cuda.synchronize()
        ref = plain_fn(x, q, s, group)
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-30)
        errs[bits] = max(errs[bits], err)
        w_dense = dequantize(im.unpack_int4(q) if bits == 4 else q, s, dtype)
        kernel_ms = timer.ms(lambda: kernel_fn(x, q, s, group))
        plain_ms = timer.ms(lambda: plain_fn(x, q, s, group))
        library_ms = timer.ms(lambda: torch.matmul(x, w_dense))
        bound_ms, bound_by = qmm_bound(M, D, F, group, bits, dt, x.element_size())
        name = "int4_matmul" if bits == 4 else "int8_matmul"
        log(f"phase2 {name} M{M} D{D} F{F} group{group} {dt}: max_abs_err={err:.3e} "
            f"rel_err={rel:.3e} bitwise_rerun={torch.equal(out, again)} kernel_ms={kernel_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(cuBLAS dense, dequantize excluded)="
            f"{library_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
        check(torch.equal(out, again), f"{name} {M, D, F, group, dt}: two runs differ")
        check(rel <= QMM_RTOL[dt], f"{name} {M, D, F, group, dt}: rel error {rel}")
        if (M, D, F, group, dt) == (4, 768, 3072, QUANT_GROUP, "float32"):
            ctx[f"qmm_int{bits}"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                         bound_ms=bound_ms, bound_by=bound_by)
    for bits in (8, 4):
        ctx[f"qmm_int{bits}"]["max_abs_err"] = errs[bits]


def phase_kernels_paged(torch, ctx):
    """B4 (dense pools) and B4q (int8, int4 pools) against the gather + plain
    softmax version, at the serving bench shape (8 slots, H12, Dh64, page 64,
    8 pages per row, pool 17) and a long one (16 pages per row, pool 257),
    fp32 and bf16, lengths {0, 1, 63, 64, 65, full, ...} over scattered page
    ids. The kernels' rows of the result line are the bench shape in fp32,
    the dtype of the paths that count their launches (phase 6 a and d)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    timer = ctx["timer"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(5)
    B, H, Dh, ps = 8, 12, 64, 64

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    errs = {kind: 0.0 for kind in PAGED_KINDS}
    for pages, pool in ((8, 17), (16, 257)):
        full = pages * ps
        lens_list = [0, 1, 63, 64, 65, full, full // 2 + 7, full - 1]
        tables_np = np.zeros((B, pages), np.int32)
        for b, n in enumerate(lens_list):
            used = -(-n // ps)
            tables_np[b, :used] = rng.choice(np.arange(1, pool), used, replace=False)
        tables = torch.from_numpy(tables_np).cuda()
        tl = tables.long()
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        S = pages * ps
        valid = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            for kind, bits in PAGED_KINDS.items():
                q = randn((B, 1, H, Dh), dtype)
                if bits is None:
                    k, v = randn((H, pool, ps, Dh), dtype), randn((H, pool, ps, Dh), dtype)
                    ks = vs = None
                else:
                    dq = Dh // 2 if bits == 4 else Dh
                    k, v = (torch.randint(-128, 128, (H, pool, ps, dq), generator=gen,
                                          device="cuda", dtype=torch.int8) for _ in range(2))
                    ks, vs = (torch.rand((H, pool), generator=gen, device="cuda") * 0.02 + 1e-3
                              for _ in range(2))

                def kernel():
                    return da.paged_decode_attention(q, k, v, lens, tables, k_scales=ks,
                                                     v_scales=vs)

                def plain():
                    return da.paged_decode_attention(q, k, v, lens, tables, impl="gather",
                                                     k_scales=ks, v_scales=vs)

                out = kernel()
                torch.cuda.synchronize()
                err = (out.float() - plain().float()).abs().max().item()
                errs[kind] = max(errs[kind], err)
                qt = q.transpose(1, 2)
                kc = da.gather_pages(k, ks, tl, Dh).to(dtype)
                vc = da.gather_pages(v, vs, tl, Dh).to(dtype)

                def library():  # the gather (and dequantization) excluded
                    return F.scaled_dot_product_attention(qt, kc, vc, attn_mask=valid)

                def gather_library():
                    return F.scaled_dot_product_attention(
                        qt, da.gather_pages(k, ks, tl, Dh).to(dtype),
                        da.gather_pages(v, vs, tl, Dh).to(dtype), attn_mask=valid)

                kernel_ms, plain_ms = timer.ms(kernel), timer.ms(plain)
                library_ms, gather_sdpa_ms = timer.ms(library), timer.ms(gather_library)
                bound_ms, bound_by = paged_bound(lens_list, H, Dh, ps, bits, dt,
                                                 q.element_size())
                log(f"phase2 paged_decode_attention {kind} B{B} H{H} Dh{Dh} ps{ps} "
                    f"pages_per_seq{pages} pool{pool} lengths={lens_list} {dt}: "
                    f"max_abs_err={err:.3e} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms(sdpa, gather excluded)={library_ms:.4f} "
                    f"gather_sdpa_ms={gather_sdpa_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
                check(err <= ATOL[dt], f"paged {kind} {pages} {dt}: max_abs_err {err}")
                check(torch.count_nonzero(out[0]).item() == 0,
                      f"paged {kind} {pages} {dt}: the length-0 row is not zero")
                if (pages, dt) == (8, "float32"):
                    ctx[f"paged_{kind}"] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                                library_ms=library_ms, bound_ms=bound_ms,
                                                bound_by=bound_by)
    for kind in PAGED_KINDS:
        ctx[f"paged_{kind}"]["max_abs_err"] = errs[kind]


def _verify_library_inputs(torch, da, k, v, ks, vs, tables, lens, wk, wv, dtype):
    """SDPA's inputs for the verify function: each row's pages gathered and
    dequantized, the window scattered at its positions (dropped past the
    table), and the [B, 1, W, S] mask of what each window query sees."""
    B, W, H, Dh = wk.shape
    tl = tables.long()
    kc, vc = da.gather_pages(k, ks, tl, Dh).to(dtype), da.gather_pages(v, vs, tl, Dh).to(dtype)
    S = kc.shape[2]
    pos = lens.long()[:, None] + torch.arange(W, device="cuda")[None, :]
    keep = pos < S
    rows = torch.arange(B, device="cuda")[:, None].expand(B, W)[keep]
    kc[rows, :, pos[keep]] = wk[keep].to(dtype)
    vc[rows, :, pos[keep]] = wv[keep].to(dtype)
    mask = torch.arange(S, device="cuda")[None, None, :] < (pos + 1)[:, :, None]
    return kc, vc, mask[:, None]


def phase_kernels_verify(torch, ctx):
    """B5 (dense, int8, int4 pools) against the plain version, on the
    committable window positions (the plain version drops positions past the
    table, the kernel attends them), at 8 slots, H12, Dh64, a 512-token
    table of page size 8, 64 or 128, windows W of 2, 3, 5, 9 and 17, fp32
    and bf16, lengths {0, 1, ps - 1, ps, ps + 1, mid, near capacity}, with q
    and the window as strided views of one fused qkv buffer; a second run is
    bitwise equal. Timed at page 64 for W 2, 5 and 17 (kernel, plain, SDPA
    over the gathered cache with the window scattered in and a [B, H, W, S]
    mask, the gather excluded). The kernels' rows of the result line are B4's
    shape (page 64, 8 pages per row, pool 17), W 5, fp32."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    timer = ctx["timer"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.default_rng(6)
    B, H, Dh, cap = 8, 12, 64, 512

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    errs = {kind: 0.0 for kind in PAGED_KINDS}
    timed = 0
    for ps in (8, 64, 128):
        pages = cap // ps
        pool = 17 if ps == 64 else B * pages + 1
        lens_list = [0, 1, ps - 1, ps, ps + 1, cap // 2 + 7, cap - 9, cap - 1]
        tables_np = np.zeros((B, pages), np.int32)
        for b, n in enumerate(lens_list):
            used = min(-(-(n + 17) // ps), pages)  # the pages a window may commit to
            tables_np[b, :used] = rng.choice(np.arange(1, pool), used, replace=False)
        tables = torch.from_numpy(tables_np).cuda()
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            for kind, bits in PAGED_KINDS.items():
                if bits is None:
                    k, v = randn((H, pool, ps, Dh), dtype), randn((H, pool, ps, Dh), dtype)
                    ks = vs = None
                else:
                    dq = Dh // 2 if bits == 4 else Dh
                    k, v = (torch.randint(-128, 128, (H, pool, ps, dq), generator=gen,
                                          device="cuda", dtype=torch.int8) for _ in range(2))
                    ks, vs = (torch.rand((H, pool), generator=gen, device="cuda") * 0.02 + 1e-3
                              for _ in range(2))
                for W in (2, 3, 5, 9, 17):
                    qkv = randn((B, W, 3 * H * Dh), dtype)
                    q, wk, wv = (x.reshape(B, W, H, Dh) for x in qkv.split(H * Dh, dim=-1))

                    def kernel():
                        return da.paged_verify_attention(q, k, v, lens, tables, wk, wv,
                                                         k_scales=ks, v_scales=vs)

                    def plain():
                        return da.paged_verify_attention(q, k, v, lens, tables, wk, wv,
                                                         impl="gather", k_scales=ks, v_scales=vs)

                    out, again = kernel(), kernel()
                    torch.cuda.synchronize()
                    ref = plain()
                    # the committable positions: inside the table
                    keep = lens.long()[:, None] + torch.arange(W, device="cuda") < cap
                    err = (out[keep].float() - ref[keep].float()).abs().max().item()
                    errs[kind] = max(errs[kind], err)
                    tag = f"{kind} ps{ps} W{W} {dt}"
                    check(torch.equal(out, again), f"verify {tag}: two runs differ")
                    check(err <= ATOL[dt], f"verify {tag}: max_abs_err {err} > {ATOL[dt]}")
                    if ps != 64 or W not in (2, 5, 17):
                        continue
                    qt = q.transpose(1, 2)
                    kc, vc, mask = _verify_library_inputs(torch, da, k, v, ks, vs, tables, lens,
                                                          wk, wv, dtype)

                    def library():  # the gather, dequantization and scatter excluded
                        return F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask)

                    kernel_ms, plain_ms, library_ms = (timer.ms(kernel), timer.ms(plain),
                                                       timer.ms(library))
                    bound_ms, bound_by = verify_bound(lens_list, W, H, Dh, ps, bits, dt,
                                                      q.element_size())
                    timed += 1
                    log(f"phase2 paged_verify_attention {kind} B{B} H{H} Dh{Dh} ps{ps} "
                        f"pages_per_seq{pages} pool{pool} W{W} lengths={lens_list} {dt}: "
                        f"max_abs_err={err:.3e} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
                        f"library_ms(sdpa, gather excluded)={library_ms:.4f} "
                        f"bound_ms={bound_ms:.5f} ({bound_by})")
                    if (W, dt) == (5, "float32"):
                        ctx[f"verify_{kind}"] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                                     library_ms=library_ms, bound_ms=bound_ms,
                                                     bound_by=bound_by)
    log(f"phase2 paged_verify_attention: 90 cases within tolerance and bitwise on re-run "
        f"({timed} timed); max_abs_err dense/kv8/kv4 = "
        + "/".join(f"{errs[k]:.3e}" for k in PAGED_KINDS))
    for kind in PAGED_KINDS:
        ctx[f"verify_{kind}"]["max_abs_err"] = errs[kind]


def phase_kernels_bwd(torch, ctx, randn):
    """B2: the three backward kernels against their plain versions, a
    bitwise re-run, and their times beside the SDPA backward's. q/k/v are
    views of one fused [B, T, 3HD] buffer, as the model's qkv projection
    gives them. dq and dk/dv run on the tensor cores for bf16 / fp16 inputs
    (route ``tc``) and on the CUDA cores for fp32 (route ``fp32``)."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    timer = ctx["timer"]
    # the training shape B8 T=S512 H12 D64 (bf16 is the main-path row, fp32
    # the fp32 training path's), the bottom-right causal offset T128 S512,
    # non-causal, D128, a ragged T100 S200 and phase 10b's B2 x T4096 (64 k
    # tiles a q tile); then fp16 with dO 2^-8 of the others' (small
    # gradients: dS falls below fp16's normal range unless the kernels scale
    # its rows)
    cases = [(8, 512, 512, 12, 64, True, "float32"), (8, 512, 512, 12, 64, True, "bfloat16"),
             (8, 512, 512, 12, 64, True, "float16"),
             (4, 128, 512, 12, 64, True, "float32"), (4, 128, 512, 12, 64, True, "bfloat16"),
             (4, 128, 512, 12, 64, True, "float16"),
             (4, 256, 256, 12, 64, False, "bfloat16"), (4, 256, 256, 12, 64, False, "float16"),
             (4, 512, 512, 12, 128, True, "float32"), (4, 512, 512, 12, 128, True, "bfloat16"),
             (4, 512, 512, 12, 128, True, "float16"), (2, 100, 200, 12, 64, True, "bfloat16"),
             (2, 4096, 4096, 12, 64, True, "bfloat16"), (2, 4096, 4096, 12, 64, True, "float16")]
    small_do = [(4, 512, 512, 12, 64, True, "float16")]
    errs = {name: 0.0 for name in BWD_KERNELS + BWD_TC_KERNELS}
    for (B, T, S, H, D, causal, dt), do_scale in ([(c, 1.0) for c in cases]
                                                  + [(c, 2.0**-8) for c in small_do]):
        dtype = getattr(torch, dt)
        tc = dt != "float32"
        names = {"delta": "delta", "dq": "dq_tc" if tc else "dq", "dkv": "dkv_tc" if tc else "dkv"}
        qkv = randn((B, S, 3 * H * D), dtype)
        k = qkv[..., H * D:2 * H * D].reshape(B, S, H, D)
        v = qkv[..., 2 * H * D:].reshape(B, S, H, D)
        q = qkv[:, S - T:, :H * D].reshape(B, T, H, D)
        do = randn((B, T, H, D), dtype) * do_scale
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        scale = 1.0 / math.sqrt(D)
        before = _bwd_launches(fa)
        first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        counted = {n: c - before[n] for n, c in _bwd_launches(fa).items()}
        expected = {n: 2 if n in names.values() else 0 for n in counted}
        bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
        delta = fa.flash_attention_bwd_delta(o, do)
        delta_ref = fa.flash_attention_bwd_delta_ref(o, do)
        ref = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
        rel = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(first, ref)]
        absd = [(a.float() - b.float()).abs().max().item() for a, b in zip(first, ref)]
        ulps = cast_ulps = None
        if tc:  # against a single cast of P, which the check must tell apart
            ulps = [ulp_err(torch, a, b, dtype) for a, b in zip(first, ref)]
            p_cast = fa._probs(q, k, lse, causal, scale).to(dtype).float()
            dv_cast = torch.einsum("bhts,bthd->bshd", p_cast, do.float()).to(dtype)
            cast_ulps = ulp_err(torch, dv_cast, ref[2], dtype)
            del p_cast, dv_cast
        delta_err = (delta - delta_ref).abs().max().item()
        errs["delta"] = max(errs["delta"], delta_err)
        errs[names["dq"]] = max(errs[names["dq"]], absd[0])
        errs[names["dkv"]] = max(errs[names["dkv"]], absd[1], absd[2])

        kernel_ms = {
            "delta": timer.ms(lambda: fa.flash_attention_bwd_delta(o, do)),
            "dq": timer.ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                                             scale)),
            "dkv": timer.ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                               causal, scale)),
        }
        plain_ms = {
            "delta": timer.ms(lambda: fa.flash_attention_bwd_delta_ref(o, do)),
            "dq": timer.ms(lambda: fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                                 causal, scale)),
            "dkv": timer.ms(lambda: fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                                   causal, scale)),
        }
        library_ms = _sdpa_backward_ms(torch, timer, q, k, v, do, causal)
        # delta's yardstick: rowsum(dO * O) as one einsum ([B, H, T] is a view
        # of the kernel's [B*H, T])
        delta_library_ms = timer.ms(lambda: torch.einsum("bthd,bthd->bht", o, do))
        bounds = flash_bwd_bounds(B, T, S, H, D, causal, dt, q.element_size())
        pair_ms = kernel_ms["dq"] + kernel_ms["dkv"]
        log(f"phase2 flash_attention_bwd B{B} T{T} S{S} H{H} D{D} causal={causal} {dt} "
            + (f"dO_scale={do_scale} " if do_scale != 1.0 else "")
            + f"route={'tc' if tc else 'fp32'}: "
            f"rel_err dq/dk/dv={rel[0]:.3e}/{rel[1]:.3e}/{rel[2]:.3e} "
            f"max_abs_err dq/dk/dv={absd[0]:.3e}/{absd[1]:.3e}/{absd[2]:.3e} "
            + (f"max_ulp_err dq/dk/dv={ulps[0]:.2f}/{ulps[1]:.2f}/{ulps[2]:.2f} "
               f"single_cast_dv_ulp_err={cast_ulps:.2f} " if ulps else "")
            + f"delta_err={delta_err:.3e} bitwise_rerun={bitwise} launches={counted} "
            + " ".join(f"{n}: kernel_ms={kernel_ms[n]:.4f} plain_ms={plain_ms[n]:.4f} "
                       f"bound_ms={bounds[n][0]:.4f} ({bounds[n][1]})" for n in BWD_KERNELS)
            + f" delta_einsum_ms={delta_library_ms:.4f}"
            f" sum_kernel_ms={sum(kernel_ms.values()):.4f} "
            f"bwd_bound_ms={bounds['bwd_total'][0]:.4f} ({bounds['bwd_total'][1]}) "
            f"dq+dkv_ms={pair_ms:.4f} sdpa_backward_ms={library_ms:.4f} "
            f"dq+dkv/sdpa_backward={pair_ms / library_ms:.3f}")
        check(bitwise, f"flash backward {B, T, S, D, dt}: two runs differ")
        check(counted == expected, f"flash backward {B, T, S, D, dt}: launches {counted}")
        check(max(rel) <= BWD_RTOL[dt], f"flash backward {B, T, S, D, dt}: rel error {rel}")
        check(ulps is None or max(ulps) <= BWD_MAX_ULP,
              f"flash backward {B, T, S, D, dt, do_scale}: {ulps} {dt} ulps")
        check(cast_ulps is None or cast_ulps > BWD_MAX_ULP,
              f"flash backward {B, T, S, D, dt, do_scale}: a single cast of P is within "
              f"{cast_ulps} ulps, the ulp check cannot tell it from the hi/lo split")
        check(delta_err <= LSE_ATOL * max(1.0, delta_ref.abs().max().item()),
              f"flash backward delta {B, T, S, D, dt}: error {delta_err}")
        if (B, T, D) == (8, 512, 64) and dt in BWD_PATH:  # the training paths' rows
            for role, n in names.items():
                if n in BWD_PATH[dt]:
                    ctx[f"bwd_{n}"] = dict(ms=kernel_ms[role], plain_ms=plain_ms[role],
                                           library_ms=delta_library_ms if role == "delta"
                                           else library_ms,
                                           bound_ms=bounds[role][0], bound_by=bounds[role][1])
    for n in errs:
        ctx[f"bwd_{n}"]["max_abs_err"] = errs[n]


def ulp_err(torch, x, ref, dtype) -> float:
    """Largest |x - ref| in ulps of ``dtype`` at ref, over the entries with
    |ref| at least BWD_ULP_FLOOR of the largest: an ulp of a value in
    [2^e, 2^(e+1)) is eps 2^e (eps 2^-7 for bf16, 2^-10 for fp16), and eps
    times the smallest normal below the normal range."""
    info = torch.finfo(dtype)
    r = ref.float()
    keep = r.abs() >= BWD_ULP_FLOOR * r.abs().max()
    _, ex = torch.frexp(r[keep])  # |r| = f 2^ex, f in [0.5, 1)
    ulp = info.eps * torch.clamp(torch.ldexp(torch.ones_like(r[keep]), ex - 1), min=info.tiny)
    return ((x.float()[keep] - r[keep]).abs() / ulp).max().item()


def _sdpa_backward_ms(torch, timer, q, k, v, do, causal) -> float:
    """The yardstick: torch.autograd.grad through scaled_dot_product_attention
    at the same shape, its forward excluded (the graph is kept and reused)."""
    import torch.nn.functional as F

    T, S = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    mask = None
    if causal and T != S:  # SDPA's is_causal aligns top-left; pass the bottom-right mask
        mask = (torch.arange(S, device="cuda")[None, :]
                <= torch.arange(T, device="cuda")[:, None] + (S - T))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=causal and mask is None)
    dot = do.transpose(1, 2)
    return timer.ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))


def bs_visible_pairs(layout, block, causal):
    """Visible (query, key) pairs of one batch row under ``layout`` [H, n, n]
    (and the causal mask): a block below the diagonal gives block^2 pairs,
    the diagonal block block * (block + 1) / 2 under causal, a block above
    it none under causal."""
    layout = np.asarray(layout).astype(bool)
    n = layout.shape[1]
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    if not causal:
        return int(layout.sum()) * block * block
    per = np.where(j < i, block * block, np.where(j == i, block * (block + 1) // 2, 0))
    return int((layout * per[None]).sum())


def bs_bounds(B, T, H, D, pairs, dtype, elt):
    """Least time of each B9 kernel at ``pairs`` visible pairs over the
    batch: (fwd, dq, dkv, bwd_total) -> (ms, by). fwd does 2 products (4 * D
    flops a pair) and reads q, k, v, writes o and lse; dq does 3 (q k^T,
    dO v^T, dS k) plus delta, reads q, k, v, o, dO, lse and writes dq and
    delta; dkv does 4 (q k^T, dO v^T, P^T dO, dS^T q), reads q, k, v, dO,
    lse, delta and writes dk, dv. The whole backward needs 5 products
    (``bwd_total``): the two passes recompute 2."""
    t = B * T * H * D * elt  # one of q, k, v, o, dO, dq, dk, dv
    rows = B * H * T * 4  # lse or delta, fp32
    return {
        "fwd": bound(4 * t + rows, 4.0 * D * pairs, dtype),
        "dq": bound(6 * t + 2 * rows, 6.0 * D * pairs + 2.0 * B * T * H * D, dtype),
        "dkv": bound(6 * t + 2 * rows, 8.0 * D * pairs, dtype),
        "bwd_total": bound(8 * t + rows, 10.0 * D * pairs + 2.0 * B * T * H * D, dtype),
    }


def _bs_cases():
    """The B9 rows of phase 2: (label, layout, block, B, H, D, causal, dtype)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                          BSLongformerSparsityConfig,
                                                          FixedSparsityConfig,
                                                          LocalSlidingWindowSparsityConfig,
                                                          VariableSparsityConfig)

    fixed = FixedSparsityConfig(**SPARSE_GPT_LAYOUT)
    fixed_d128 = FixedSparsityConfig(num_heads=8, block=128)
    return [
        # (i) phase 10a's shape; (ii) phase 10b's, the main-path row
        ("fixed-uni-128 (10a)", fixed.make_layout(1024), 128, 2, 12, 64, True, "float32"),
        ("fixed-uni-128 (10b, main path)", fixed.make_layout(4096), 128, 2, 12, 64, True,
         "bfloat16"),
        # (iii) bench.py's row: the bidirectional default under causal=True
        ("fixed-bi-128 bench", FixedSparsityConfig(num_heads=16, block=128).make_layout(1024),
         128, 4, 16, 64, True, "bfloat16"),
        # (iv) a layout per head
        ("bigbird-per-head-64", BigBirdSparsityConfig(
            num_heads=12, block=64, different_layout_per_head=True,
            attention="unidirectional").make_layout(1024), 64, 2, 12, 64, True, "float32"),
        # (v) small blocks
        ("variable-16", VariableSparsityConfig(
            num_heads=12, block=16, num_random_blocks=2, local_window_blocks=[4],
            global_block_indices=[0], attention="unidirectional").make_layout(512), 16, 2, 12,
         64, True, "float32"),
        ("longformer-32", BSLongformerSparsityConfig(
            num_heads=12, block=32, num_sliding_window_blocks=5).make_layout(512), 32, 2, 12,
         64, False, "float32"),
        ("sliding-16", LocalSlidingWindowSparsityConfig(
            num_heads=12, block=16, num_sliding_window_blocks=8).make_layout(512), 16, 2, 12, 64,
         True, "bfloat16"),
        ("sliding-32", LocalSlidingWindowSparsityConfig(
            num_heads=12, block=32, num_sliding_window_blocks=4).make_layout(512), 32, 2, 12, 64,
         True, "float32"),
        # (vi) head dim 128, not causal
        ("fixed-bi-128 D128 noncausal", fixed_d128.make_layout(1024), 128, 2, 8, 128, False,
         "float32"),
    ]


def phase_kernels_blocksparse(torch, ctx, randn):
    """B9: the forward, dq and dk/dv kernels against their plain versions on
    q/k/v views of one fused [B, T, 3HD] buffer, the backward twice (bitwise),
    their times beside one SDPA call with the expanded boolean layout (and
    causal) mask (mask construction excluded) and its backward, and beside
    B1 / B2's dense causal times at the same shape."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    timer = ctx["timer"]
    errs = {n: 0.0 for n in BS_KERNELS}
    for label, layout, block, B, H, D, causal, dt in _bs_cases():
        dtype = getattr(torch, dt)
        T = layout.shape[1] * block
        qkv = randn((B, T, 3 * H * D), dtype)
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        do = randn((B, T, H, D), dtype)
        tables = bs.device_tables(layout, "cuda")
        scale = 1.0 / math.sqrt(D)
        o, lse = bs.blocksparse_attention_fwd(q, k, v, layout, block, causal, tables=tables)
        first = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal,
                                             tables=tables)
        again = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal,
                                             tables=tables)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
        o_ref, lse_ref = bs.blocksparse_attention_fwd_ref(q, k, v, layout, block, causal)
        dq_ref, delta = bs.blocksparse_attention_bwd_dq_ref(q, k, v, o, do, lse, layout, block,
                                                            causal, scale)
        ref = (dq_ref, *bs.blocksparse_attention_bwd_dkv_ref(q, k, v, do, lse, delta, layout,
                                                            block, causal, scale))
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        rel = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(first, ref)]
        absd = [(a.float() - b.float()).abs().max().item() for a, b in zip(first, ref)]
        errs["fwd"] = max(errs["fwd"], o_err)
        errs["dq"] = max(errs["dq"], absd[0])
        errs["dkv"] = max(errs["dkv"], absd[1], absd[2])
        del o_ref, lse_ref, dq_ref, ref

        kernel_ms = {
            "fwd": timer.ms(lambda: bs.blocksparse_attention_fwd(q, k, v, layout, block, causal,
                                                                 tables=tables)),
            "dq": timer.ms(lambda: bs.blocksparse_attention_bwd_dq(
                q, k, v, o, do, lse, layout, block, causal, scale, tables)),
            "dkv": timer.ms(lambda: bs.blocksparse_attention_bwd_dkv(
                q, k, v, do, lse, delta, layout, block, causal, scale, tables)),
        }
        plain_ms = {
            "fwd": timer.ms(lambda: bs.blocksparse_attention_fwd_ref(q, k, v, layout, block,
                                                                     causal), iters=5),
            "dq": timer.ms(lambda: bs.blocksparse_attention_bwd_dq_ref(
                q, k, v, o, do, lse, layout, block, causal, scale), iters=5),
            "dkv": timer.ms(lambda: bs.blocksparse_attention_bwd_dkv_ref(
                q, k, v, do, lse, delta, layout, block, causal, scale), iters=5),
        }
        # the yardstick: SDPA with the layout expanded to a [H, T, T] bool mask
        mask = bs.layout_mask(layout, block, causal, "cuda")
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        dot = do.transpose(1, 2)
        sdpa_bwd_ms = timer.ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                           retain_graph=True))
        del out, mask, qt, kt, vt
        # B1 / B2 dense causal at the same shape
        fo, flse = fa.flash_attention_fwd(q, k, v, causal=True)
        flash_ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
        flash_bwd_ms = timer.ms(lambda: fa.flash_attention_bwd(q, k, v, fo, flse, do, True))
        del fo, flse
        pairs = bs_visible_pairs(layout, block, causal) * B
        bounds = bs_bounds(B, T, H, D, pairs, dt, q.element_size())
        log(f"phase2 blocksparse_attention {label} B{B} T{T} H{H} D{D} block{block} "
            f"causal={causal} {dt}: active_blocks={int(np.asarray(layout).sum())} "
            f"visible_pairs={pairs} o_err={o_err:.3e} lse_err={lse_err:.3e} "
            f"rel_err dq/dk/dv={rel[0]:.3e}/{rel[1]:.3e}/{rel[2]:.3e} "
            f"max_abs_err dq/dk/dv={absd[0]:.3e}/{absd[1]:.3e}/{absd[2]:.3e} "
            f"bitwise_rerun={bitwise} "
            + " ".join(f"{n}: kernel_ms={kernel_ms[n]:.4f} plain_ms={plain_ms[n]:.4f} "
                       f"bound_ms={bounds[n][0]:.4f} ({bounds[n][1]})" for n in BS_KERNELS)
            + f" sum_bwd_kernel_ms={kernel_ms['dq'] + kernel_ms['dkv']:.4f} "
            f"bwd_bound_ms={bounds['bwd_total'][0]:.4f} ({bounds['bwd_total'][1]}) "
            f"sdpa_masked_ms={sdpa_ms:.4f} sdpa_masked_backward_ms={sdpa_bwd_ms:.4f} "
            f"b1_dense_causal_ms={flash_ms:.4f} b2_dense_causal_ms={flash_bwd_ms:.4f}")
        check(o_err <= ATOL[dt], f"blocksparse {label}: o error {o_err} > {ATOL[dt]}")
        check(lse_err <= LSE_ATOL, f"blocksparse {label}: lse error {lse_err}")
        check(bitwise, f"blocksparse backward {label}: two runs differ")
        check(max(rel) <= BWD_RTOL[dt], f"blocksparse backward {label}: rel error {rel}")
        if "main path" in label:
            for n in BS_KERNELS:
                ctx[f"bs_{n}"] = dict(ms=kernel_ms[n], plain_ms=plain_ms[n],
                                      library_ms=sdpa_ms if n == "fwd" else sdpa_bwd_ms,
                                      bound_ms=bounds[n][0], bound_by=bounds[n][1])
        del q, k, v, qkv, do, o, lse, first, again, delta
        torch.cuda.empty_cache()
    for n in BS_KERNELS:
        ctx[f"bs_{n}"]["max_abs_err"] = errs[n]


def _reset_counts():
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im

    fa.launches = 0
    fa.bwd_delta_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    fa.bwd_dq_tc_launches = fa.bwd_dkv_tc_launches = 0
    da.launches = 0
    da.paged_launches = da.paged_kv8_launches = da.paged_kv4_launches = 0
    da.verify_launches = da.verify_kv8_launches = da.verify_kv4_launches = 0
    im.int8_launches = im.int4_launches = 0
    dqm.launches = 0
    bs.launches = bs.bwd_dq_launches = bs.bwd_dkv_launches = 0
    return fa, da


def _bwd_launches(fa):
    return {"delta": fa.bwd_delta_launches, "dq": fa.bwd_dq_launches,
            "dkv": fa.bwd_dkv_launches, "dq_tc": fa.bwd_dq_tc_launches,
            "dkv_tc": fa.bwd_dkv_tc_launches}


def path_launches(launches, n, path):
    """The exact launch counts of a run: ``n`` for each counter in ``path``,
    0 for every other (the other dtype's backward kernels among them)."""
    return {name: n if name in path else 0 for name in launches}


def b2_profile(kernels, busy_ms: float) -> str:
    """B2's kernels (delta, dq, dk/dv) in one step's profile: their device
    ms, each and together, and their share of the device-busy time."""
    rows = [(name, ms) for name, _, ms in kernels if "flash_bwd" in name]
    b2_ms = sum(ms for _, ms in rows)
    each = "; ".join(f"{name.replace('(anonymous namespace)::', '')[:32]} {ms:.3f} ms"
                     for name, ms in rows)
    share = f"{b2_ms / busy_ms:.3f}" if busy_ms else "not measured"
    return f"b2_ms={b2_ms:.3f} b2_share_of_busy={share} ({each})"


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
        bwd_launches = _bwd_launches(fa)
        loss = loss.item()
        plain = gpt.loss_fn(dataclasses.replace(cfg, use_flash=False), params, batch,
                            train=False)[0].item()
        ids_t = torch.as_tensor(ids, device="cuda")
        fwd_ms = ctx["timer"].ms(lambda: gpt.forward(cfg, params, ids_t, train=False),
                                 iters=5, warmup=2, device_only=False)
        profile = device_breakdown(
            torch, lambda: gpt.forward(cfg, params, ids_t, train=False), fwd_ms)
    log(f"phase3 scoring gpt2-125m B4xT512 fp32: loss={loss:.6f} plain_loss={plain:.6f} "
        f"|diff|={abs(loss - plain):.3e} ln(V)={math.log(cfg.vocab_size):.4f} "
        f"flash_launches={flash_launches} decode_launches={decode_launches} "
        f"flash_bwd_launches={bwd_launches} "
        f"forward_ms={fwd_ms:.3f}")
    log(f"phase3 scoring forward profile: {profile}")
    check(math.isfinite(loss), "scoring loss is not finite")
    check(abs(loss - math.log(cfg.vocab_size)) < 0.5, f"scoring loss {loss} far from ln(V)")
    check(abs(loss - plain) <= 1e-4, f"flash loss {loss} vs plain {plain}")
    check(flash_launches == cfg.n_layer, f"{flash_launches} flash launches, expected 12")
    check(not any(bwd_launches.values()), f"no_grad scoring ran the backward: {bwd_launches}")
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


def _train_config(micro: int, gas: int = 1, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": 6e-4}},
           "gradient_clipping": 1.0, "steps_per_print": 0}
    cfg.update(over)
    return cfg


def _engine(cfg_dict, gpt_cfg, seed=0):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt

    model, _ = gpt.build(gpt_cfg)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=cfg_dict, seed=seed)
    return engine


def _timed_steps(torch, engine, batch, n):
    """``n`` train_batch calls on one batch: (losses, grad norms, device
    step ms between CUDA events, host issue ms of each call)."""
    losses, norms, events, host_ms = [], [], [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        m = engine.train_batch(batch)  # no host read inside: this is the host's issue time
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        events.append((start, end))
    torch.cuda.synchronize()
    return ([x.item() for x in losses], [x.item() for x in norms],
            [s.elapsed_time(e) for s, e in events], host_ms)


def phase_training(torch, ctx):
    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    V = cfg.vocab_size
    rng = np.random.default_rng(2)

    # (a) fp32 (TF32 off since phase 1), B4 x T512, 5 steps through the
    # kernels and 5 through plain attention, from the same seed and batches
    batches = [{"input_ids": rng.integers(0, V, (4, 512)).astype(np.int32)} for _ in range(5)]
    runs = {}
    for use_flash in (None, False):  # None: the default dispatch, the kernels on CUDA
        engine = _engine(_train_config(4), dataclasses.replace(cfg, use_flash=use_flash))
        fa, _ = _reset_counts()  # the fp32 training main path
        metrics = [engine.train_batch(b) for b in batches]
        torch.cuda.synchronize()
        launches = {"fwd": fa.launches, **_bwd_launches(fa)}
        runs[use_flash] = ([m["loss"].item() for m in metrics],
                           [m["grad_norm"].item() for m in metrics], launches)
        del engine
    (loss_k, norm_k, launches), (loss_p, norm_p, plain_launches) = runs[None], runs[False]
    log(f"phase5a train fp32 gpt2-125m B4xT512 AdamW clip1.0: losses={loss_k} "
        f"plain_losses={loss_p} grad_norms={norm_k} plain_grad_norms={norm_p} "
        f"launches over 5 micro-steps={launches} plain-path launches={plain_launches}")
    check(np.allclose(loss_k, loss_p, rtol=1e-4, atol=0), f"fp32 losses differ: {loss_k} vs {loss_p}")
    check(np.allclose(norm_k, norm_p, rtol=1e-3, atol=0), f"fp32 grad norms differ: {norm_k} vs {norm_p}")
    expected = path_launches(launches, 5 * cfg.n_layer, ("fwd", *BWD_PATH["float32"]))
    check(launches == expected, f"launches over 5 fp32 micro-steps {launches}, expected {expected}")
    check(not any(plain_launches.values()), f"plain path launched kernels: {plain_launches}")
    for n in ("dq", "dkv"):  # the CUDA-core kernels' main path
        ctx[f"bwd_{n}"]["launches"] = launches[n]
    torch.cuda.empty_cache()

    # (b) bf16 + fp32 master + ZeRO stage 2 (the verify-notes configuration),
    # B8 x T512, 10 steps on one fixed batch
    batch = {"input_ids": rng.integers(0, V, (8, 512)).astype(np.int32)}
    engine = _engine(_train_config(8, bf16={"enabled": True},
                                   zero_optimization={"stage": 2}), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa, _ = _reset_counts()  # the bf16 training main path
    losses, norms, step_ms, host_ms = _timed_steps(torch, engine, batch, 10)
    launches = {"fwd": fa.launches, **_bwd_launches(fa)}
    tokens_per_s = engine.tokens_per_sec()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady_ms = float(np.median(step_ms[1:]))
    ctx["train5b"] = dict(step_ms=steady_ms, host_ms=float(np.median(host_ms[1:])),
                          tokens_per_s=tokens_per_s, peak_gb=peak_gb)
    kernels = device_kernels(torch, lambda: engine.train_batch(batch))
    attn_ms = sum(ms for name, _, ms in kernels if "flash_" in name)
    busy_ms = sum(ms for _, _, ms in kernels)
    ctx["train5b"]["b2"] = b2_profile(kernels, busy_ms)
    log(f"phase5b train bf16 master zero2 gpt2-125m B8xT512: losses={losses} "
        f"grad_norms={norms} launches over 10 steps={launches}")
    log(f"phase5b train bf16 step_ms (CUDA events, median of steps 2-10)={steady_ms:.3f} "
        f"step_ms_all={[round(x, 3) for x in step_ms]} "
        f"host_issue_ms (median of steps 2-10)={float(np.median(host_ms[1:])):.3f} "
        f"tokens_per_s={tokens_per_s:.1f} "
        f"peak_memory_gb={peak_gb:.3f}")
    log(f"phase5b train bf16 profile of one step: "
        + device_breakdown(torch, None, steady_ms, top=6, kernels=kernels)
        + f" flash_fwd+bwd_ms={attn_ms:.3f} flash_share_of_busy="
        + (f"{attn_ms / busy_ms:.3f}" if busy_ms else "not measured")
        + f" {ctx['train5b']['b2']}")
    check(abs(losses[0] - math.log(V)) < 0.5, f"bf16 step-1 loss {losses[0]} far from ln(V)")
    check(losses[-1] < losses[0], f"bf16 loss did not fall: {losses}")
    check(all(math.isfinite(x) for x in losses + norms), "bf16 loss or grad norm not finite")
    expected = path_launches(launches, 10 * cfg.n_layer, ("fwd", *BWD_PATH["bfloat16"]))
    check(launches == expected, f"launches over 10 bf16 steps {launches}, expected {expected}")
    for n in BWD_PATH["bfloat16"]:  # delta and the tensor-core kernels' main path
        ctx[f"bwd_{n}"]["launches"] = launches[n]
    del engine
    torch.cuda.empty_cache()

    # (c) gas 2 x micro 4 and gas 1 x micro 8 over the same 8 rows (fp32)
    rows = rng.integers(0, V, (8, 512)).astype(np.int32)
    e_gas = _engine(_train_config(4, gas=2), cfg)
    n_gas = e_gas.train_batch({"input_ids": rows.reshape(2, 4, 512)})["grad_norm"].item()
    del e_gas
    e_one = _engine(_train_config(8), cfg)
    n_one = e_one.train_batch({"input_ids": rows})["grad_norm"].item()
    del e_one
    torch.cuda.empty_cache()
    log(f"phase5c grad_norm gas2 x micro4={n_gas:.6f} gas1 x micro8={n_one:.6f} "
        f"rel_diff={abs(n_gas - n_one) / n_one:.3e}")
    check(abs(n_gas - n_one) <= 1e-3 * n_one, f"gas grad norms differ: {n_gas} vs {n_one}")


# quantized pools (phase 6d): the least free-running greedy match rate of
# the kernel path against the gather path. int8/int4 rounding of the
# appended K/V lets the two drift apart (0.9896 and 1.0 for kv8, 0.9150 for
# kv4, measured on an H100); a broken kernel would match near 1/V. The
# kernel's own agreement is held per layer on the served pools.
PAGED_MATCH_FLOOR = 0.5
# the reference's serving bench configuration (bench.py's serving cell)
SERVE_CFG = dict(num_slots=8, page_size=64, max_model_len=512, num_pages=17, prefill_chunk=128)


SERVE_WORKLOAD = (24, 8.0, (32, 128), (16, 96))  # requests, rps, prompt and generation ranges


def _serve(torch, cfg, params, dtype, workload=SERVE_WORKLOAD, serve_cfg=SERVE_CFG, draft=None,
           **over):
    """One ``run_continuous`` of an open-loop workload (seed 0; by default
    the bench's: 24 requests at 8 rps, prompts 32-128, generations 16-96)
    after ``warmup``, with the launch counts set to 0 just before and read
    just after. Checks what the path must launch: B4 12 times a decode step,
    B5 12 times a verify window (by pool kind; neither on the gather path),
    B3 12 times a single-token draft-model forward and never otherwise, B1
    never, B6/B7 4 per layer per decode step and per verify window over a
    quantized tree. Returns the report, the requests' tokens, the requests,
    the launches and the engine."""
    from deepspeed_tpu_torch.inference.serving import (ServingConfig, ServingEngine,
                                                       make_open_loop_workload, run_continuous)

    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im

    eng = ServingEngine(cfg, params, ServingConfig(**{**serve_cfg, "dtype": dtype, **over}),
                        draft=draft)
    eng.warmup()
    decode, verify, forward_with_cache = eng.decode, eng.verify, gpt.forward_with_cache
    count = {"steps": 0, "windows": 0, "draft_tokens": 0}
    qmm = {f"{k}_in_{where}": 0 for k in ("int8", "int4") for where in ("decode", "verify")}

    def counted(fn, where, n):
        def call(*args, **kw):
            count[where] += n(*args, **kw)
            before = (im.int8_launches, im.int4_launches)
            out = fn(*args, **kw)
            path = "decode" if where == "steps" else "verify"
            qmm[f"int8_in_{path}"] += im.int8_launches - before[0]
            qmm[f"int4_in_{path}"] += im.int4_launches - before[1]
            return out
        return call

    def counted_forward(cfg_, params_, ids, cache):
        count["draft_tokens"] += int(np.asarray(ids.shape)[-1] == 1)
        return forward_with_cache(cfg_, params_, ids, cache)

    eng.decode = counted(decode, "steps", lambda *a, steps=1: steps)
    eng.verify = counted(verify, "windows", lambda *a: 1)
    n_req, rps, prompts, gens = workload
    wl = make_open_loop_workload(n_req, rps, prompts, gens, cfg.vocab_size, seed=0)
    gpt.forward_with_cache = counted_forward
    try:
        fa, da = _reset_counts()  # a paged serving main path
        rep = run_continuous(eng, wl)
        torch.cuda.synchronize()
    finally:
        gpt.forward_with_cache = forward_with_cache
    launches = {"flash": fa.launches, "decode": da.launches, "dense": da.paged_launches,
                "kv8": da.paged_kv8_launches, "kv4": da.paged_kv4_launches,
                "verify_dense": da.verify_launches, "verify_kv8": da.verify_kv8_launches,
                "verify_kv4": da.verify_kv4_launches,
                "int8_matmul": im.int8_launches, "int4_matmul": im.int4_launches, **qmm}
    tag = " ".join([dtype] + [f"{k}={v}" for k, v in over.items()])
    spec = rep.get("spec", {})
    log(f"phase run {tag}: finished={rep['finished']}/{len(wl)} audit_ok={rep['pool_audit_ok']} "
        f"scheduler_steps={rep['decode_steps']} decode_steps={count['steps']} "
        f"verify_windows={count['windows']} draft_single_token_forwards={count['draft_tokens']} "
        f"preemptions={rep['preemptions']} launches={launches} "
        f"ttft_p50_ms={rep['ttft_p50_ms']} ttft_p99_ms={rep['ttft_p99_ms']} "
        f"per_token_p50_ms={rep['per_token_p50_ms']} tokens_per_sec={rep['tokens_per_sec']} "
        f"wall_s={rep['wall_s']} kv_bytes_per_token={eng.kv_bytes_per_token()}"
        + (f" spec={spec}" if spec else ""))
    check(rep["finished"] == len(wl), f"{tag}: {rep['finished']} of {len(wl)} finished")
    check(rep["pool_audit_ok"], f"{tag}: the page audit failed")
    check(launches["flash"] == 0, f"{tag}: B1 launched on the paged path: {launches}")
    check(launches["decode"] == cfg.n_layer * count["draft_tokens"],
          f"{tag}: B3 launches {launches['decode']}, expected 12 per single-token draft "
          f"forward ({count['draft_tokens']})")
    kind = {None: "dense", 8: "kv8", 4: "kv4"}[over.get("kv_bits")]
    paged = {k: launches[k] for k in PAGED_KINDS}
    verified = {k: launches[f"verify_{k}"] for k in PAGED_KINDS}
    if over.get("kernel_impl") == "gather":
        check(not any(paged.values()) and not any(verified.values()),
              f"{tag}: the gather path launched B4/B5: {paged} {verified}")
    else:
        want = {k: cfg.n_layer * count["steps"] if k == kind else 0 for k in PAGED_KINDS}
        check(paged == want, f"{tag}: B4 launches {paged}, expected {want}")
        want = {k: cfg.n_layer * count["windows"] if k == kind else 0 for k in PAGED_KINDS}
        check(verified == want, f"{tag}: B5 launches {verified}, expected {want}")
    # quantized weights: every decode or verify projection (at most 256 rows)
    # is one B6/B7 launch, 4 per layer; dense weights launch neither anywhere
    qleaf = params["blocks"]["qkv_w"]
    wkind = ("int4" if "q4" in qleaf else "int8") if gpt._is_qleaf(qleaf) else None
    want_q = {f"{k}_in_{where}": (4 * cfg.n_layer * count[n] if k == wkind else 0)
              for k in ("int8", "int4") for where, n in (("decode", "steps"),
                                                          ("verify", "windows"))}
    check(qmm == want_q, f"{tag}: B6/B7 launches {qmm}, expected {want_q}")
    if wkind is None:
        check(launches["int8_matmul"] == launches["int4_matmul"] == 0,
              f"{tag}: dense weights launched B6/B7: {launches}")
    return rep, [r.tokens[:r.max_new_tokens] for r in wl], wl, launches, eng


def _match(a, b) -> float:
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return float(np.mean([x == y for x, y in pairs]))


def phase_paged_serving(torch, ctx):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import for_gpt
    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    params = ctx["params"]

    # (a) fp32, dense pools: tokens == generate == the gather path
    _, toks_a, wl_a, launches_a, _ = _serve(torch, cfg, params, "float32")
    ctx["toks_6a"] = toks_a
    _, toks_ag, _, _, _ = _serve(torch, cfg, params, "float32", kernel_impl="gather")
    engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype="float32")
    gen = [engine.generate(r.prompt[None], max_new_tokens=r.max_new_tokens)[0, len(r.prompt):]
           .tolist() for r in wl_a]
    log(f"phase6a fp32 dense: match vs gather={_match(toks_a, toks_ag):.4f} "
        f"match vs generate={_match(toks_a, gen):.4f}")
    check(toks_a == toks_ag, "fp32 served tokens differ from the gather path")
    check(toks_a == gen, "fp32 served tokens differ from generate")
    ctx["paged_dense"]["launches"] = launches_a["dense"]
    del engine

    # (b) bf16, dense pools: the bench numbers
    rep_b, toks_b, _, _, eng_b = _serve(torch, cfg, params, "bfloat16")
    _, toks_bg, _, _, _ = _serve(torch, cfg, params, "bfloat16", kernel_impl="gather")
    log(f"phase6b bf16 dense: ttft_p50_ms={rep_b['ttft_p50_ms']} "
        f"ttft_p99_ms={rep_b['ttft_p99_ms']} tpot_p50_ms={rep_b['per_token_p50_ms']} "
        f"output_tokens_per_s={rep_b['tokens_per_sec']} "
        f"greedy_match_rate_vs_gather={_match(toks_b, toks_bg):.4f}")
    slots = SERVE_CFG["num_slots"]
    tables = np.zeros((slots, 8), np.int32)
    tables[:, :2] = np.arange(1, 2 * slots + 1).reshape(slots, 2)
    tokens = np.zeros(slots, np.int32)
    mask = np.ones(slots, bool)

    def eight_steps():  # two blocks of 4 at 8 active slots, lengths 100..107
        eng_b.decode(tokens, tables, np.full(slots, 100, np.int32), mask, steps=4)
        eng_b.decode(tokens, tables, np.full(slots, 104, np.int32), mask, steps=4)

    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        eight_steps()
        walls.append(time.perf_counter() - t0)
    log("phase6b bf16 profile of 8 decode steps at 8 active slots: "
        + device_breakdown(torch, eight_steps, float(np.median(walls[1:])) * 1e3, top=6))
    del eng_b

    # (c) fp32 under pool pressure: preemption, the tokens of (a)
    rep_c, toks_c, _, _, _ = _serve(torch, cfg, params, "float32", num_pages=9)
    log(f"phase6c fp32 pool 9: preemptions={rep_c['preemptions']} "
        f"match vs (a)={_match(toks_c, toks_a):.4f}")
    check(rep_c["preemptions"] >= 1, "pool 9 forced no preemption")
    check(toks_c == toks_a, "tokens under preemption differ from (a)")

    # (d) int8 and int4 pools, fp32. Free-running, the kernel and gather
    # paths need not give the same tokens: their attention sums differ in
    # the last fp32 bits, an appended K/V element then now and then rounds
    # to the neighbouring int8/int4 step, and the two runs drift apart (the
    # dense pools of (a) have no such rounding). So the kernel is held to the
    # gather path on the pools serving wrote, layer by layer, and the
    # free-running greedy match rate is bounded below.
    for bits in (8, 4):
        _, toks_d, _, launches_d, eng_d = _serve(torch, cfg, params, "float32", kv_bits=bits)
        ctx[f"toks_6d_kv{bits}"] = toks_d
        _, toks_dg, _, _, _ = _serve(torch, cfg, params, "float32", kv_bits=bits,
                                     kernel_impl="gather")
        err, _ = _kernel_on_served_pools(torch, eng_d)
        match = _match(toks_d, toks_dg)
        log(f"phase6d fp32 kv{bits}: kernel vs gather on the served pools, 12 layers: "
            f"max_abs_err={err:.3e}; free-running match vs gather={match:.4f} "
            f"match vs (a) dense={_match(toks_d, toks_a):.4f} "
            f"kv_bytes_per_token={eng_d.kv_bytes_per_token()} (dense fp32 "
            f"{gpt.paged_kv_bytes_per_token(cfg, None, 64, torch.float32)})")
        check(err <= ATOL["float32"], f"kv{bits}: kernel vs gather on served pools: {err}")
        check(match >= PAGED_MATCH_FLOOR, f"kv{bits}: free-running match {match}")
        ctx[f"paged_kv{bits}"]["launches"] = launches_d[f"kv{bits}"]
        del eng_d
    torch.cuda.empty_cache()


def _block_weight_bytes(params) -> int:
    """Bytes of the block stacks' weight matrices: the payloads and scales of
    quantized leaves, or the dense [L, D, F] stacks."""
    from deepspeed_tpu_torch.models import gpt

    total = 0
    for leaf in params["blocks"].values():
        if gpt._is_qleaf(leaf):
            total += sum(t.numel() * t.element_size() for t in leaf.values())
        elif leaf.dim() >= 3:
            total += leaf.numel() * leaf.element_size()
    return total


def _marginal_decode_ms(engine, prompt, short=16, long_=64, reps=5):
    """The reference bench's per-token decode latency: generate ``short`` and
    ``long_`` new tokens back to back, ``reps`` times; the difference of the
    two times over ``long_ - short`` tokens, p50 (host clock; generate
    returns host numpy, so each call ends synchronized)."""
    engine.generate(prompt, max_new_tokens=short)
    engine.generate(prompt, max_new_tokens=long_)
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.generate(prompt, max_new_tokens=short)
        t1 = time.perf_counter()
        engine.generate(prompt, max_new_tokens=long_)
        t2 = time.perf_counter()
        lat.append(((t2 - t1) - (t1 - t0)) / (long_ - short) * 1e3)
    return sorted(lat)[len(lat) // 2], lat


def phase_quantized(torch, ctx):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import for_gpt
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im

    cfg = gpt.PRESETS["gpt2-125m"]
    params = ctx["params"]
    new = 64

    # (a) GPT-2-125M fp32, int8 and int4 weights: tokens equal the plain
    # path, a dense fp32 engine over the dequantized tree
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 512)).astype(np.int32)
    for bits in (8, 4):
        kind = f"int{bits}"
        quant = {"enabled": True, "bits": bits, "group_size": QUANT_GROUP}
        engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype="float32",
                                                    quant=quant)
        plain = deepspeed_tpu_torch.init_inference(
            for_gpt(cfg, gpt.dequantize_params(engine.params)), dtype="float32")
        engine.generate(prompt, max_new_tokens=2)  # warm-up
        fa, da = _reset_counts()  # the quantized generate main path
        out = engine.generate(prompt, max_new_tokens=new)
        launches = {"int8": im.int8_launches, "int4": im.int4_launches, "decode": da.launches,
                    "flash": fa.launches}
        ref = plain.generate(prompt, max_new_tokens=new)
        match = float(np.mean(out[:, 512:] == ref[:, 512:]))
        log(f"phase7a generate gpt2-125m B4 prompt512 new{new} fp32 {kind} group{QUANT_GROUP}: "
            f"greedy_match_rate vs dequantized dense={match:.4f} launches={launches} "
            f"block_weight_bytes={_block_weight_bytes(engine.params)} "
            f"(dense fp32 {_block_weight_bytes(plain.params)})")
        check(match == 1.0, f"{kind} fp32 generate differs from the dequantized dense path")
        want = {"int8": 0, "int4": 0, "decode": cfg.n_layer * (new - 1), "flash": 0}
        want[kind] = 4 * cfg.n_layer * (new - 1)
        check(launches == want, f"{kind}: launches {launches}, expected {want}")
        ctx[f"qmm_{kind}"]["launches"] = launches[kind]
        del engine, plain
    torch.cuda.empty_cache()

    # (b) the reference's gpt2-350m-decode-b8-int4 bench row, with int8 and
    # dense bf16 beside it
    cfg350 = gpt.PRESETS["gpt2-350m"]
    p350 = gpt.init_params(cfg350, 0, device="cuda")
    prompt = np.random.default_rng(0).integers(0, cfg350.vocab_size, (8, 128)).astype(np.int32)
    toks, rows = {}, {}
    for kind, bits in (("bf16", None), ("int8", 8), ("int4", 4)):
        quant = {"enabled": True, "bits": bits, "group_size": QUANT_GROUP} if bits else {}
        engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg350, p350), dtype="bfloat16",
                                                    quant=quant)
        p50, lat = _marginal_decode_ms(engine, prompt)
        _reset_counts()
        toks[kind] = engine.generate(prompt, max_new_tokens=new)[:, 128:]
        launches = {"int8": im.int8_launches, "int4": im.int4_launches}
        nbytes = _block_weight_bytes(engine.params)
        rows[kind] = nbytes
        log(f"phase7b gpt2-350m-decode-b8 {kind} bf16 B8 prompt128 +{new}: "
            f"decode_p50_ms={p50:.3f} decode_ms_all={[round(x, 3) for x in lat]} "
            f"tokens_per_s={1e3 / p50 * 8:.1f} block_weight_bytes={nbytes} "
            f"launches over one generate={launches}")
        log(f"phase7b {kind} profile of 8 decode steps at position 128: "
            + _decode_profile(torch, engine, prompt, steps=8))
        if bits:
            want = {"int8": 0, "int4": 0}
            want[kind] = 4 * cfg350.n_layer * (new - 1)
            check(launches == want, f"350m {kind}: launches {launches}, expected {want}")
        del engine
        torch.cuda.empty_cache()
    log(f"phase7b greedy match vs dense bf16 (reported only: quantization changes the "
        f"function): int8={float(np.mean(toks['int8'] == toks['bf16'])):.4f} "
        f"int4={float(np.mean(toks['int4'] == toks['bf16'])):.4f}; weight bytes vs bf16: "
        f"int8={rows['int8'] / rows['bf16']:.4f} int4={rows['int4'] / rows['bf16']:.4f}")
    # a byte per weight (half for int4) plus a 4-byte scale per 128
    check(abs(rows["int4"] / rows["bf16"] - (0.5 + 4 / QUANT_GROUP) / 2) < 1e-3,
          f"int4 block bytes {rows['int4']} vs bf16 {rows['bf16']}")
    del p350
    torch.cuda.empty_cache()

    # (c) paged serving over int8 weights (fp32, dense pools): tokens equal
    # serving over the dequantized dense tree
    qparams = gpt.quantize_for_inference(cfg, params, bits=8, group_size=QUANT_GROUP)
    rep, toks_q, wl, _, eng_q = _serve(torch, cfg, qparams, "float32")
    _, toks_d, _, _, _ = _serve(torch, cfg, gpt.dequantize_params(qparams), "float32")
    log(f"phase7c serving int8 weights fp32: finished={rep['finished']}/{len(wl)} "
        f"audit_ok={rep['pool_audit_ok']} match vs dequantized dense={_match(toks_q, toks_d):.4f} "
        f"tpot_p50_ms={rep['per_token_p50_ms']} tokens_per_sec={rep['tokens_per_sec']}")
    check(toks_q == toks_d, "int8-weight served tokens differ from the dequantized dense run")
    del eng_q
    torch.cuda.empty_cache()


def _kernel_on_served_pools(torch, eng):
    """Prefill 8 prompts of 100 tokens through ``eng`` and decode a block of
    4 (the quantized writers of the serving path fill the pools), then hold
    B4 and B5 (a 5-token window) to their plain versions on each layer's
    pools at those rows' lengths, with a random query and window: the
    largest differences (B4, B5)."""
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    slots = SERVE_CFG["num_slots"]
    rng = np.random.default_rng(7)
    tables = np.zeros((slots, 8), np.int32)
    tables[:, :2] = np.arange(1, 2 * slots + 1).reshape(slots, 2)
    first = eng.prefill_many([(s, rng.integers(0, eng.cfg.vocab_size, 100), tables[s])
                              for s in range(slots)])
    eng.decode(np.array([first[s] for s in range(slots)], np.int32), tables,
               np.full(slots, 100, np.int32), np.ones(slots, bool), steps=4)
    tbl = torch.from_numpy(tables).cuda()
    lens = torch.full((slots,), 104, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    pools = eng.paged_cache
    H, Dh = eng.cfg.n_head, eng.cfg.head_dim
    err = verr = 0.0
    for layer in range(eng.cfg.n_layer):
        q, wq, wk, wv = (torch.randn(shape, generator=gen, device="cuda")
                         for shape in ((slots, 1, H, Dh),) + ((slots, 5, H, Dh),) * 3)
        kw = dict(k_scales=pools["k_scales"][layer], v_scales=pools["v_scales"][layer])
        args = (pools["k_pages"][layer], pools["v_pages"][layer])
        out = da.paged_decode_attention(q, *args, lens, tbl, **kw)
        ref = da.paged_decode_attention(q, *args, lens, tbl, impl="gather", **kw)
        err = max(err, (out - ref).abs().max().item())
        out = da.paged_verify_attention(wq, *args, lens, tbl, wk, wv, **kw)
        ref = da.paged_verify_attention(wq, *args, lens, tbl, wk, wv, impl="gather", **kw)
        verr = max(verr, (out - ref).abs().max().item())
    return err, verr


# spec-on against spec-off over quantized pools (8c): the window attends its
# own positions at dense precision where spec-off decode reads them back
# int8/int4-rounded, so the two runs drift apart like 6d's kernel and gather
# runs; the same floor
SPEC_QUANT_MATCH_FLOOR = PAGED_MATCH_FLOOR
# the draft model drafter with the target's own weights (8d): only
# budget-truncated drafts and fp32 rounding differences are rejected
DRAFT_SELF_ACCEPT_FLOOR = 0.8
# the reference's gpt2-125m-serving-cb-spec bench row (bench.py): 16 slots,
# page 128, model length 512, chunk 128, 32 requests, prompts 32-160,
# generations 8-128, spec_k 4, decode_block 1 on both sides; at the
# -serving-cb row's 8 rps (its 2x-saturation rate needs max_queue and
# request_deadline_s, which are not ported)
SPEC_BENCH_CFG = dict(num_slots=16, page_size=128, max_model_len=512, prefill_chunk=128,
                      decode_block=1)
SPEC_BENCH_WORKLOAD = (32, 8.0, (32, 160), (8, 128))
SPEC = dict(spec_drafter="ngram", spec_k=4, decode_block=1)


def _spec_line(rep) -> str:
    sp = rep["spec"]
    return (f"windows={sp['windows']} fallback_steps={sp['fallback_steps']} "
            f"accept_rate={sp['accept_rate']} tokens_per_dispatch={sp['tokens_per_dispatch']}")


def phase_spec_serving(torch, ctx):
    """Phase 8: speculative serving on GPT-2-125M (ngram drafts unless
    named, spec_k 4, decode_block 1), through B5 in every verify window."""
    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    params = ctx["params"]

    # (a) fp32 dense pools, phase 6's configuration: tokens = 6a's spec-off
    # tokens = the gather path's; exact B4/B5 launch counts (in _serve)
    rep_a, toks_a, _, launches_a, _ = _serve(torch, cfg, params, "float32", **SPEC)
    _, toks_ag, _, _, _ = _serve(torch, cfg, params, "float32", kernel_impl="gather", **SPEC)
    log(f"phase8a fp32 dense spec: {_spec_line(rep_a)} match vs spec-off (6a)="
        f"{_match(toks_a, ctx['toks_6a']):.4f} match vs gather={_match(toks_a, toks_ag):.4f} "
        f"B5 launches={launches_a['verify_dense']} B4 launches={launches_a['dense']} "
        f"tpot_p50_ms={rep_a['per_token_p50_ms']} tokens_per_sec={rep_a['tokens_per_sec']}")
    check(toks_a == ctx["toks_6a"], "fp32 spec-on tokens differ from spec-off (6a)")
    check(toks_a == toks_ag, "fp32 spec-on tokens differ from the gather path")
    check(rep_a["spec"]["windows"] > 0, "no verify window ran")
    ctx["verify_dense"]["launches"] = launches_a["verify_dense"]

    # (b) bf16, the reference's -serving-cb-spec shapes: spec off and on
    runs = {}
    for name, over in (("off", {}), ("on", SPEC)):
        runs[name] = _serve(torch, cfg, params, "bfloat16", workload=SPEC_BENCH_WORKLOAD,
                            serve_cfg=SPEC_BENCH_CFG, **over)
    (rep_off, toks_off, _, _, _), (rep_on, toks_on, _, _, eng_on) = runs["off"], runs["on"]
    for name, rep in (("off", rep_off), ("on", rep_on)):
        log(f"phase8b bf16 spec-{name} gpt2-125m 16 slots page128: ttft_p50_ms={rep['ttft_p50_ms']} "
            f"ttft_p99_ms={rep['ttft_p99_ms']} tpot_p50_ms={rep['per_token_p50_ms']} "
            f"output_tokens_per_s={rep['tokens_per_sec']} scheduler_steps={rep['decode_steps']} "
            f"wall_s={rep['wall_s']}" + (f" {_spec_line(rep)}" if name == "on" else ""))
    log(f"phase8b greedy match spec-on vs spec-off (reported only: bf16 B4 and B5 round "
        f"differently)={_match(toks_on, toks_off):.4f}")
    slots, W = SPEC_BENCH_CFG["num_slots"], 5
    tables = np.zeros((slots, 4), np.int32)
    tables[:, :2] = np.arange(1, 2 * slots + 1).reshape(slots, 2)
    mask = np.ones(slots, bool)
    window = np.random.default_rng(8).integers(0, cfg.vocab_size, (slots, W)).astype(np.int32)

    def eight(kind):
        def run():
            for i in range(8):
                lens = np.full(slots, 100 + i * W, np.int32)
                if kind == "verify":  # budget 5: every window commits what it accepts
                    eng_on.verify(window, tables, lens, mask, np.full(slots, -1, np.int32),
                                  np.full(slots, W, np.int32))
                else:
                    eng_on.decode(window[:, 0], tables, lens, mask, steps=1)
        return run

    for kind in ("verify", "decode"):
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            eight(kind)()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        label = "verify windows (W 5)" if kind == "verify" else "decode steps"
        log(f"phase8b bf16 profile of 8 {label} at 16 active slots: "
            + device_breakdown(torch, eight(kind), float(np.median(walls[1:])) * 1e3, top=6))
    del eng_on, runs
    torch.cuda.empty_cache()

    # (c) int8 and int4 pools, fp32: B5 against its plain version on the
    # pools serving wrote; spec-on vs spec-off (6d) match rate floored
    for bits in (8, 4):
        rep_c, toks_c, _, launches_c, eng_c = _serve(torch, cfg, params, "float32",
                                                     kv_bits=bits, **SPEC)
        _, verr = _kernel_on_served_pools(torch, eng_c)
        match = _match(toks_c, ctx[f"toks_6d_kv{bits}"])
        log(f"phase8c fp32 kv{bits} spec: {_spec_line(rep_c)} B5 vs plain on the served pools, "
            f"12 layers, W5: max_abs_err={verr:.3e}; match vs spec-off (6d)={match:.4f} "
            f"B5 launches={launches_c[f'verify_kv{bits}']}")
        check(verr <= ATOL["float32"], f"kv{bits}: B5 vs plain on served pools: {verr}")
        check(match >= SPEC_QUANT_MATCH_FLOOR, f"kv{bits}: spec-on vs spec-off match {match}")
        ctx[f"verify_kv{bits}"]["launches"] = launches_c[f"verify_kv{bits}"]
        del eng_c
    torch.cuda.empty_cache()

    # (d) the draft-model drafter, drafting with the target's own weights:
    # tokens = spec-off; B3 runs in the draft (counted in _serve)
    rep_d, toks_d, _, launches_d, _ = _serve(
        torch, cfg, params, "float32", draft=(cfg, params),
        **{**SPEC, "spec_drafter": "draft_model"})
    log(f"phase8d fp32 draft_model (draft = target): {_spec_line(rep_d)} match vs spec-off (6a)="
        f"{_match(toks_d, ctx['toks_6a']):.4f} B3 launches={launches_d['decode']} "
        f"B5 launches={launches_d['verify_dense']} tpot_p50_ms={rep_d['per_token_p50_ms']}")
    check(toks_d == ctx["toks_6a"], "draft-model spec tokens differ from spec-off")
    check(rep_d["spec"]["accept_rate"] >= DRAFT_SELF_ACCEPT_FLOOR,
          f"draft = target accept rate {rep_d['spec']['accept_rate']}")
    check(launches_d["decode"] > 0, "the draft model launched no B3")

    # (e) int8 weights, fp32, 12 requests: tokens = spec-off over the same
    # tree; 48 B6 launches per verify window (checked in _serve)
    qparams = gpt.quantize_for_inference(cfg, params, bits=8, group_size=QUANT_GROUP)
    wl12 = (12,) + SERVE_WORKLOAD[1:]
    rep_e, toks_e, _, launches_e, _ = _serve(torch, cfg, qparams, "float32", workload=wl12, **SPEC)
    _, toks_eo, _, _, _ = _serve(torch, cfg, qparams, "float32", workload=wl12, decode_block=1)
    log(f"phase8e fp32 int8 weights spec: {_spec_line(rep_e)} match vs spec-off="
        f"{_match(toks_e, toks_eo):.4f} B6 launches in verify={launches_e['int8_in_verify']}")
    check(toks_e == toks_eo, "int8-weight spec tokens differ from spec-off")
    del qparams
    torch.cuda.empty_cache()


ZERO3Q = {"stage": 3, "zero_quantized_weights": True, "zero_quantized_head": True}


def phase_zero3(torch, ctx):
    """Phase 9: ZeRO-3 with the quantized weight wire and the quantized LM
    head (B8) on GPT-2-125M at full width and depth, one rank."""
    import os

    from deepspeed_tpu_torch.comm import comm, quantized as tq
    from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    cfg = gpt.PRESETS["gpt2-125m"]
    V = cfg.vocab_size
    rng = np.random.default_rng(9)

    # (a) fp32, B4 x T512, AdamW + clipping, 5 steps through B8 and 5 with
    # B8's plain version in its place, from the same seed and batches
    batches = [{"input_ids": rng.integers(0, V, (4, 512)).astype(np.int32)} for _ in range(5)]
    kernel_fn = dqm.dequant_matmul
    runs = {}
    for route in ("kernel", "plain"):
        engine = _engine(_train_config(4, zero_optimization=ZERO3Q), cfg)
        if route == "plain":
            dqm.dequant_matmul = dqm.dequant_matmul_ref
        try:
            fa, _ = _reset_counts()  # the fp32 stage-3 training main path
            metrics = [engine.train_batch(b) for b in batches]
            torch.cuda.synchronize()
        finally:
            dqm.dequant_matmul = kernel_fn
        runs[route] = ([m["loss"].item() for m in metrics], [m["grad_norm"].item() for m in metrics],
                       {"b8": dqm.launches, "fwd": fa.launches, **_bwd_launches(fa)})
        del engine
    (loss_k, norm_k, launches), (loss_p, norm_p, plain_launches) = runs["kernel"], runs["plain"]
    log(f"phase9a train fp32 zero3 quantized weights+head gpt2-125m B4xT512: losses={loss_k} "
        f"plain_b8_losses={loss_p} grad_norms={norm_k} plain_b8_grad_norms={norm_p} "
        f"launches over 5 micro-steps={launches} plain-B8 launches={plain_launches}")
    check(np.allclose(loss_k, loss_p, rtol=1e-4, atol=0), f"9a losses differ: {loss_k} vs {loss_p}")
    check(np.allclose(norm_k, norm_p, rtol=1e-3, atol=0), f"9a grad norms differ: {norm_k} vs {norm_p}")
    check(launches["b8"] == 5 and plain_launches["b8"] == 0,
          f"9a B8 launches {launches['b8']} / plain {plain_launches['b8']}, expected 5 / 0")
    flash = {n: c for n, c in launches.items() if n != "b8"}
    expected = path_launches(flash, 5 * cfg.n_layer, ("fwd", *BWD_PATH["float32"]))
    check(flash == expected, f"9a flash launches {flash}, expected {expected}")
    torch.cuda.empty_cache()

    # (b) bf16 + fp32 master, the same ZeRO-3 config, B8 x T512, 10 steps on
    # one batch, beside phase 5b's ZeRO-2 step of this run
    batch = {"input_ids": rng.integers(0, V, (8, 512)).astype(np.int32)}
    engine = _engine(_train_config(8, bf16={"enabled": True}, zero_optimization=ZERO3Q), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wire_ledger.reset()
    fa, _ = _reset_counts()  # the bf16 stage-3 training main path
    losses, norms, step_ms, host_ms = _timed_steps(torch, engine, batch, 10)
    launches = {"b8": dqm.launches, "fwd": fa.launches, **_bwd_launches(fa)}
    ledger = wire_ledger.summary_dict()
    tokens_per_s = engine.tokens_per_sec()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady_ms = float(np.median(step_ms[1:]))
    kernels = device_kernels(torch, lambda: engine.train_batch(batch))
    b8_ms = sum(ms for name, _, ms in kernels if "dequant_matmul" in name)
    z2 = ctx.get("train5b", {})
    log(f"phase9b train bf16 master zero3 quantized weights+head gpt2-125m B8xT512: "
        f"losses={losses} grad_norms={norms} launches over 10 steps={launches}")
    log(f"phase9b step_ms (CUDA events, median of steps 2-10)={steady_ms:.3f} "
        f"step_ms_all={[round(x, 3) for x in step_ms]} "
        f"host_issue_ms (median of steps 2-10)={float(np.median(host_ms[1:])):.3f} "
        f"tokens_per_s={tokens_per_s:.1f} peak_memory_gb={peak_gb:.3f}; phase5b zero2 in this "
        f"run: step_ms={z2.get('step_ms', float('nan')):.3f} "
        f"host_issue_ms={z2.get('host_ms', float('nan')):.3f} "
        f"tokens_per_s={z2.get('tokens_per_s', float('nan')):.1f} "
        f"peak_memory_gb={z2.get('peak_gb', float('nan')):.3f}")
    log("phase9b profile of one step: "
        + device_breakdown(torch, None, steady_ms, top=6, kernels=kernels)
        + f" dequant_matmul_ms={b8_ms:.3f}")
    log("phase9b wire ledger over 10 steps: " + "; ".join(
        f"{name} count={row['count']} logical={row['logical_bytes']} wire={row['wire_bytes']} "
        f"ratio={row['ratio']}" for name, row in ledger.items()))
    check(abs(losses[0] - math.log(V)) < 0.5, f"9b step-1 loss {losses[0]} far from ln(V)")
    check(losses[-1] < losses[0], f"9b loss did not fall: {losses}")
    check(all(math.isfinite(x) for x in losses + norms), "9b loss or grad norm not finite")
    check(launches["b8"] == 10, f"9b B8 launches {launches['b8']}, expected 10")
    flash = {n: c for n, c in launches.items() if n != "b8"}
    expected = path_launches(flash, 10 * cfg.n_layer, ("fwd", *BWD_PATH["bfloat16"]))
    check(flash == expected, f"9b flash launches {flash}, expected {expected}")
    check(any(n.startswith("qgather[zero3]") for n in ledger)
          and any(n.startswith("qmatmul[lm_head]") for n in ledger), f"9b ledger {ledger}")
    ctx["dqm"]["launches"] = launches["b8"]
    del engine
    torch.cuda.empty_cache()

    # (c) the facade over NCCL at world size 1, a file store under build/:
    # qall_gather of the qkv leaf is quantize-then-dequantize, bitwise
    store = os.path.abspath(os.path.join("build", f"nccl_init_{os.getpid()}"))
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    comm.init_distributed(init_method=f"file://{store}", world_size=1, rank=0)
    try:
        backend = torch.distributed.get_backend()
        probe = torch.full((4,), 3.0, device="cuda")
        torch.distributed.all_reduce(probe)  # one NCCL call: the communicator works
        leaf = torch.randn((768, 2304), generator=torch.Generator(device="cuda").manual_seed(5),
                           device="cuda")
        got = tq.qall_gather(leaf)
        want = tq.dequantize_blockwise(*tq.quantize_blockwise(leaf), orig_size=2304)
        torch.cuda.synchronize()
        log(f"phase9c init_distributed backend={backend} world={comm.get_world_size()} "
            f"all_reduce_probe={probe.tolist()} qall_gather bitwise={torch.equal(got, want)}")
        check(backend == "nccl", f"9c backend {backend}, expected nccl")
        check(probe.tolist() == [3.0] * 4, f"9c NCCL all_reduce gave {probe.tolist()}")
        check(torch.equal(got, want), "9c qall_gather differs from quantize-then-dequantize")
    finally:
        torch.distributed.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


def _bs_launches(fa):
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

    return {"b9_fwd": bs.launches, "b9_dq": bs.bwd_dq_launches, "b9_dkv": bs.bwd_dkv_launches,
            "b1": fa.launches, **{f"b2_{n}": c for n, c in _bwd_launches(fa).items()}}


def _plain_b9(bs):
    """B9's plain versions in the wrappers' places (the reference has no
    knob for this): the autograd Function looks the wrappers up by name and
    passes the device tables last, which the plain versions do not take."""
    return {"blocksparse_attention_fwd": lambda *a: bs.blocksparse_attention_fwd_ref(*a[:-1]),
            "blocksparse_attention_bwd_dq": lambda *a: bs.blocksparse_attention_bwd_dq_ref(
                *a[:-1]),
            "blocksparse_attention_bwd_dkv": lambda *a: bs.blocksparse_attention_bwd_dkv_ref(
                *a[:-1])}


def phase_sparse(torch, ctx):
    """Phase 10: a sparse GPT-2-125M (every layer's attention through B9)
    at full width and depth, scored and trained through the entry points."""
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    cfg = dataclasses.replace(gpt.PRESETS["gpt2-125m"],
                              sparse_attention=FixedSparsityConfig(**SPARSE_GPT_LAYOUT))
    V, L = cfg.vocab_size, cfg.n_layer
    rng = np.random.default_rng(10)
    kernels = {name: getattr(bs, name) for name in _plain_b9(bs)}

    def swap(fns):
        for name, fn in fns.items():
            setattr(bs, name, fn)

    # (a) fp32 (TF32 off since phase 1), B2 x T1024: the scoring loss through
    # B9 and through its plain versions, then 5 train_batch steps of each
    # from the same seed and batches, AdamW + clipping
    ids = rng.integers(0, V, (2, 1024)).astype(np.int32)
    params = gpt.init_params(cfg, 0, device="cuda")
    with torch.no_grad():
        fa, _ = _reset_counts()  # the sparse scoring main path
        loss = gpt.loss_fn(cfg, params, {"input_ids": ids}, train=False)[0].item()
        score_launches = _bs_launches(fa)
        swap(_plain_b9(bs))
        try:
            plain_loss = gpt.loss_fn(cfg, params, {"input_ids": ids}, train=False)[0].item()
        finally:
            swap(kernels)
    del params
    log(f"phase10a scoring sparse gpt2-125m B2xT1024 fp32: loss={loss:.6f} "
        f"plain_b9_loss={plain_loss:.6f} |diff|={abs(loss - plain_loss):.3e} "
        f"launches={score_launches}")
    check(abs(loss - math.log(V)) < 0.5, f"10a scoring loss {loss} far from ln(V)")
    check(abs(loss - plain_loss) <= 1e-4, f"10a B9 loss {loss} vs plain {plain_loss}")
    check(score_launches["b9_fwd"] == L and score_launches["b9_dq"] == 0
          and score_launches["b1"] == 0, f"10a scoring launches {score_launches}")

    batches = [{"input_ids": rng.integers(0, V, (2, 1024)).astype(np.int32)} for _ in range(5)]
    runs = {}
    for route in ("kernel", "plain"):
        engine = _engine(_train_config(2), cfg)
        if route == "plain":
            swap(_plain_b9(bs))
        try:
            fa, _ = _reset_counts()  # the fp32 sparse training main path
            metrics = [engine.train_batch(b) for b in batches]
            torch.cuda.synchronize()
        finally:
            swap(kernels)
        runs[route] = ([m["loss"].item() for m in metrics], [m["grad_norm"].item() for m in metrics],
                       _bs_launches(fa))
        del engine
    (loss_k, norm_k, launches), (loss_p, norm_p, plain_launches) = runs["kernel"], runs["plain"]
    log(f"phase10a train fp32 sparse gpt2-125m B2xT1024 AdamW clip1.0: losses={loss_k} "
        f"plain_b9_losses={loss_p} grad_norms={norm_k} plain_b9_grad_norms={norm_p} "
        f"launches over 5 micro-steps={launches} plain-B9 launches={plain_launches}")
    check(np.allclose(loss_k, loss_p, rtol=1e-4, atol=0), f"10a losses differ: {loss_k} vs {loss_p}")
    check(np.allclose(norm_k, norm_p, rtol=1e-3, atol=0),
          f"10a grad norms differ: {norm_k} vs {norm_p}")
    check(all(launches[f"b9_{n}"] == 5 * L for n in BS_KERNELS),
          f"10a B9 launches {launches}, expected {5 * L} each")
    check(not any(n for name, n in launches.items() if not name.startswith("b9")),
          f"10a dense kernels launched: {launches}")
    check(not any(plain_launches.values()), f"10a plain run launched kernels: {plain_launches}")
    torch.cuda.empty_cache()

    # (b) bf16 + fp32 master + ZeRO stage 2, B2 x T4096 (max_seq_len 4096),
    # 10 steps on one batch; the same model dense (B1/B2) beside it
    batch = {"input_ids": rng.integers(0, V, (2, 4096)).astype(np.int32)}
    rows = {}
    for name, sc in (("sparse", cfg.sparse_attention), ("dense", None)):
        model_cfg = dataclasses.replace(cfg, max_seq_len=4096, sparse_attention=sc)
        engine = _engine(_train_config(2, bf16={"enabled": True},
                                       zero_optimization={"stage": 2}), model_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa, _ = _reset_counts()  # the bf16 sparse training main path (and its dense twin)
        losses, norms, step_ms, host_ms = _timed_steps(torch, engine, batch, 10)
        launches = _bs_launches(fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steady_ms = float(np.median(step_ms[1:]))
        tokens_per_s = engine.tokens_per_sec()
        kernels_run = device_kernels(torch, lambda: engine.train_batch(batch))
        attn_ms = sum(ms for kname, _, ms in kernels_run
                      if "blocksparse_" in kname or "flash_" in kname)
        busy_ms = sum(ms for _, _, ms in kernels_run)
        rows[name] = dict(step_ms=steady_ms, launches=launches)
        log(f"phase10b train bf16 master zero2 {name} gpt2-125m B2xT4096: losses={losses} "
            f"grad_norms={norms} launches over 10 steps={launches}")
        log(f"phase10b {name} step_ms (CUDA events, median of steps 2-10)={steady_ms:.3f} "
            f"step_ms_all={[round(x, 3) for x in step_ms]} "
            f"host_issue_ms (median of steps 2-10)={float(np.median(host_ms[1:])):.3f} "
            f"tokens_per_s={tokens_per_s:.1f} peak_memory_gb={peak_gb:.3f}")
        log(f"phase10b {name} profile of one step: "
            + device_breakdown(torch, None, steady_ms, top=6, kernels=kernels_run)
            + f" attention_fwd+bwd_ms={attn_ms:.3f} attention_share_of_busy="
            + (f"{attn_ms / busy_ms:.3f}" if busy_ms else "not measured")
            + (f" {b2_profile(kernels_run, busy_ms)}" if name == "dense" else ""))
        check(abs(losses[0] - math.log(V)) < 0.5, f"10b {name} step-1 loss {losses[0]} far from ln(V)")
        check(losses[-1] < losses[0], f"10b {name} loss did not fall: {losses}")
        check(all(math.isfinite(x) for x in losses + norms), f"10b {name} loss or norm not finite")
        del engine
        torch.cuda.empty_cache()
    sparse, dense = rows["sparse"]["launches"], rows["dense"]["launches"]
    log(f"phase10b sparse/dense step ratio={rows['sparse']['step_ms'] / rows['dense']['step_ms']:.4f} "
        f"(reported only; no gain is claimed)")
    check(all(sparse[f"b9_{n}"] == 10 * L for n in BS_KERNELS)
          and not any(n for k, n in sparse.items() if not k.startswith("b9")),
          f"10b sparse launches {sparse}, expected {10 * L} of each B9 kernel and no B1/B2")
    expected = path_launches(dense, 10 * L, ("b1", *(f"b2_{n}" for n in BWD_PATH["bfloat16"])))
    check(dense == expected, f"10b dense launches {dense}, expected {expected}")
    for n in BS_KERNELS:
        ctx[f"bs_{n}"]["launches"] = sparse[f"b9_{n}"]


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
    for phase in (phase_build, phase_kernels, phase_scoring, phase_serving, phase_training,
                  phase_paged_serving, phase_quantized, phase_spec_serving, phase_zero3,
                  phase_sparse):
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
    ] + [{"name": f"flash_attention_bwd_{n}", "route": "cuda", "source": FLASH_BWD_SRC,
          "replaces": BWD_TPU[n], **ctx[f"bwd_{n}"]} for n in BWD_KERNELS] + [
        {"name": f"flash_attention_bwd_{n}", "route": "cuda", "source": FLASH_BWD_TC_SRC,
         "replaces": BWD_TPU[n[:-3]], **ctx[f"bwd_{n}"]} for n in BWD_TC_KERNELS] + [
        {"name": "paged_decode_attention" + ("" if kind == "dense" else f"_{kind}"),
         "route": "cuda", "source": PAGED_SRC, "replaces": PAGED_TPU[kind],
         **ctx[f"paged_{kind}"]} for kind in PAGED_KINDS] + [
        {"name": f"int{bits}_matmul", "route": "cuda", "source": QMM_SRC,
         "replaces": QMM_TPU[f"int{bits}"], **ctx[f"qmm_int{bits}"]} for bits in (8, 4)] + [
        {"name": "paged_verify_attention" + ("" if kind == "dense" else f"_{kind}"),
         "route": "cuda", "source": VERIFY_SRC, "replaces": VERIFY_TPU,
         **ctx[f"verify_{kind}"]} for kind in PAGED_KINDS] + [
        {"name": "dequant_matmul", "route": "cuda", "source": DQM_SRC, "replaces": DQM_TPU,
         **ctx["dqm"]}] + [
        {"name": "blocksparse_attention_" + ("fwd" if n == "fwd" else f"bwd_{n}"),
         "route": "cuda", "source": BS_FWD_SRC if n == "fwd" else BS_BWD_SRC,
         "replaces": BS_TPU[n], **ctx[f"bs_{n}"]} for n in BS_KERNELS]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    log(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
