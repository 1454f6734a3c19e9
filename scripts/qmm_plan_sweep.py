#!/usr/bin/env python3
"""Times B6 / B7's decode kernel (``csrc/int8_matmul_decode.cu``) at every
plan that covers D, beside the plan ``decode_plan`` picks, on one CUDA card:
x [8, D] bf16 over the 8 projection shapes of GPT-2-125M and gpt2-350m,
int8 and int4, group 128. A plan is (warps a block, 32-row slabs a warp,
blocks of a cluster along D); the sweep takes every one of 2 / 4 / 8 warps,
1 / 2 / 4 slabs and clusters of 1-8 that covers D with no block empty and
keeps the grid within four blocks an SM.

    python3 scripts/qmm_plan_sweep.py [--out FILE]

Two times a plan: CUDA events around one call with the L2 flushed before it
and the host's launch kept out (median of 15), as ``chip_smoke.py`` times
kernels; and the mean of 96 launches back to back over copies of the weight
that together exceed the 50 MB L2 (queued behind a 10 ms device sleep, so
the host's launches stay ahead). One JSON line a shape (also appended to
``--out``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import QMM_SHAPES, Timer  # noqa: E402

M, GROUP, LAUNCHES = 8, 128, 96


def stream_ms(torch, run, copies):
    """Mean device time of LAUNCHES calls back to back, rotating over the
    weight copies."""
    for c in copies[:4]:
        run(c)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(10 * Timer.HOST_LEAD_CYCLES)
    start.record()
    for i in range(LAUNCHES):
        run(copies[i % len(copies)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("qmm_plan_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im
    from deepspeed_tpu_torch.ops.quantizer import quantize

    lib = im._lib_decode()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bits in (8, 4):
        for D, F in QMM_SHAPES:
            w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
            q, s = quantize(w, bits=bits, num_groups=D * F // GROUP)
            q = im.pack_int4(q) if bits == 4 else q
            copies = [(q.clone(), s.clone()) for _ in range(int(60e6 // q.numel()) + 4)]
            x = torch.randn((M, D), generator=gen, device="cuda").to(torch.bfloat16)
            out = torch.empty((M, F), dtype=torch.bfloat16, device="cuda")
            Fq = q.shape[1]
            picked = im.decode_plan(D, Fq, sms, bits)
            plans = {picked}
            for warps, per_warp, cluster in itertools.product((2, 4, 8), (1, 2, 4), range(1, 9)):
                rows = 32 * warps * per_warp
                if rows * cluster >= D > rows * (cluster - 1) and Fq // 64 * cluster <= 4 * sms:
                    plans.add((warps, per_warp, cluster))
            times = {}
            for plan in sorted(plans):
                def run(qs=(q, s), plan=plan):
                    status = lib.ds_quant_matmul_decode(
                        x.data_ptr(), x.stride(0), qs[0].data_ptr(), qs[1].data_ptr(),
                        out.data_ptr(), M, D, F, GROUP, *plan, bits, 1,
                        torch.cuda.current_stream().cuda_stream)
                    if status != 0:
                        raise RuntimeError(f"qmm_plan_sweep {plan}: CUDA error {status}")
                times[str(plan)] = (timer.ms(run), stream_ms(torch, run, copies))
            row = {"card": card, "bits": bits, "D": D, "F": F, "picked": str(picked),
                   "picked_ms": times[str(picked)],
                   "fastest_cold": min(times.items(), key=lambda kv: kv[1][0]),
                   "fastest_stream": min(times.items(), key=lambda kv: kv[1][1]),
                   "all_ms": times}
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            del copies
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
