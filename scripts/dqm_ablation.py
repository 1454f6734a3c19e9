#!/usr/bin/env python3
"""Where the time of B8's tensor-core kernel goes, by ablation, on one CUDA
card: copies of ``deepspeed_tpu_torch/csrc/dequant_matmul_tc.cu`` with parts
of its work cut out are built under ``build/dqm_ablation/`` and timed on the
same inputs as the kernel itself.

Variants (each removes the named work from every step and keeps the rest):
``full`` (the kernel as it is); ``no_xconv`` (x times the scales is not cut
into parts); ``no_qwiden`` (the q bytes are not widened); ``no_mma`` (no
wgmma); ``no_conv`` (neither conversion); ``copies`` (no conversion and no
wgmma: the copies, barriers and epilogue alone); ``copies_no_scales``,
``copies_no_x``, ``copies_no_store`` (the copies without the scale copies,
the x tile or the epilogue's stores); ``q_stream`` (only the q tiles' copies
and the barriers). The outputs of every variant but ``full`` are wrong by
design; only their times are read. Shapes: x fp32 over GPT-2-125M's LM head
(D 768, vocabulary 50304, blocks of 256) at phase 9d's 32 rows (both 64-row
tilings) and at 4096 rows (the 128 x 256 tiling).

    python3 scripts/dqm_ablation.py [--out FILE]

Times are CUDA events around one call with the L2 flushed before it and the
host's launch kept out (median of 15), as ``chip_smoke.py`` times them; one
JSON line per shape and tiling (also appended to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import Timer  # noqa: E402

# (text of the kernel, the same text with a guard around the work it does)
CUTS = {
    "XCONV": ("      if (RW == 1 && r >= rows_in) continue;  // past M: its outputs are not stored",
              "      if (RW == 1 && r >= rows_in) continue;  // past M: its outputs are not stored\n"
              "#ifdef NO_XCONV\n      continue;\n#endif"),
    "QWIDEN": ("    constexpr int qr = BN / 8;  // reads a row",
               "    constexpr int qr = BN / 8;  // reads a row\n"
               "#ifdef NO_QWIDEN\n    if (true) { fence_proxy_async(); return; }\n#endif"),
    "MMA": ("    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < kBK / 16; ++kk) {",
            "    wgmma_fence();\n#ifndef NO_MMA\n#pragma unroll\n"
            "    for (int kk = 0; kk < kBK / 16; ++kk) {"),
    "MMA_END": ("      }\n    }\n    wgmma_commit();", "      }\n    }\n#endif\n    wgmma_commit();"),
    "SCALES": ("      cp_async4(st + L::raw_s + 4 * tid, src, in);",
               "#ifndef NO_SCALES\n      cp_async4(st + L::raw_s + 4 * tid, src, in);\n#endif"),
    "XLOAD": ("      mbar_expect_tx(bar0 + 8 * slot, L::rows * L::raw_row + kBK * BN);\n"
              "      tma_load_2d(st + L::raw_x, &tmx, bar0 + 8 * slot, k0, m0);",
              "#ifdef NO_XLOAD\n      mbar_expect_tx(bar0 + 8 * slot, kBK * BN);\n#else\n"
              "      mbar_expect_tx(bar0 + 8 * slot, L::rows * L::raw_row + kBK * BN);\n"
              "      tma_load_2d(st + L::raw_x, &tmx, bar0 + 8 * slot, k0, m0);\n#endif"),
    "STORE": ("      if (row >= M || col >= F) continue;\n      const float add",
              "      if (row >= M || col >= F) continue;\n"
              "#ifdef NO_STORE\n      if (acc[h][i] != 12345.f) continue;\n#endif\n"
              "      const float add"),
}
COPIES = ["NO_XCONV", "NO_QWIDEN", "NO_MMA"]
VARIANTS = {"full": [], "no_xconv": ["NO_XCONV"], "no_qwiden": ["NO_QWIDEN"],
            "no_mma": ["NO_MMA"], "no_conv": ["NO_XCONV", "NO_QWIDEN"], "copies": COPIES,
            "copies_no_scales": COPIES + ["NO_SCALES"], "copies_no_x": COPIES + ["NO_XLOAD"],
            "copies_no_store": COPIES + ["NO_STORE"],
            "q_stream": COPIES + ["NO_SCALES", "NO_XLOAD", "NO_STORE"]}
# (M, block, (row_wgs, cols)): 9d's head at both 64-row tilings, the LM head
SHAPES = [(32, 256, (1, 256)), (32, 256, (1, 128)), (4096, 256, (2, 256))]


def build(nvcc, flags, out_dir):
    """The patched source and one library per variant, built at once."""
    from deepspeed_tpu_torch.ops import _build

    csrc = os.path.join(REPO, "deepspeed_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "dequant_matmul_tc.cu")).read()
    for name, (text, guarded) in CUTS.items():
        if src.count(text) != 1:
            raise RuntimeError(f"dqm_ablation: the kernel no longer holds the {name} anchor")
        src = src.replace(text, guarded)
    os.makedirs(out_dir, exist_ok=True)
    patched = os.path.join(out_dir, "dequant_matmul_tc_ablation.cu")
    with open(patched, "w") as f:
        f.write(src)
    procs = {v: subprocess.Popen([nvcc, *flags, "-I", csrc, *[f"-D{d}" for d in defs], "-o",
                                  os.path.join(out_dir, f"{v}.so"), patched],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v, defs in VARIANTS.items()}
    libs = {}
    for v, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise _build.KernelBuildError(f"nvcc failed on variant {v}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{v}.so"))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ds_dequant_matmul_tc.argtypes = [ptr, i64, ptr, i64] + [ptr] * 3 + [i32] * 8 + [ptr]
        lib.ds_dequant_matmul_tc.restype = i32
        libs[v] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dqm_ablation.py: no CUDA device", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.comm.quantized import quantize_blockwise
    from deepspeed_tpu_torch.ops import _build

    libs = build(_build._nvcc(), _build.NVCC_FLAGS, os.path.join(REPO, "build", "dqm_ablation"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else torch.cuda.get_device_name(0)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    D, F = 768, 50304
    for M, block, tile in SHAPES:
        w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
        q, s, z = quantize_blockwise(w, bits=8, block_size=block)
        x = torch.randn((M, D), generator=gen, device="cuda")
        out = torch.empty((M, F), device="cuda")
        row = {"card": card, "M": M, "D": D, "F": F, "block": block, "tile": list(tile)}
        for v, lib in libs.items():
            def run(lib=lib):
                status = lib.ds_dequant_matmul_tc(
                    x.data_ptr(), x.stride(0), q.data_ptr(), q.stride(0), s.data_ptr(),
                    z.data_ptr(), out.data_ptr(), M, D, q.shape[1], s.shape[1], F, 0, tile[0],
                    tile[1], torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError(f"dqm_ablation {v}: CUDA error {status}")
            row[f"{v}_ms"] = timer.ms(run)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
