#!/usr/bin/env python3
"""Where the time of B6 / B7 at decode rows goes, by ablation, on one CUDA
card: copies of the CUDA-core kernel (``deepspeed_tpu_torch/csrc/int8_matmul.cu``,
the earlier decode route) and of the decode kernel
(``csrc/int8_matmul_decode.cu``) with parts of their work cut out are built
under ``build/qmm_ablation/`` and timed on the same inputs as the kernels.

Variants, each adding a part to the one before:
- CUDA-core kernel: ``empty`` (x staged in shared memory, no weight byte
  read: the launch, the cluster and x alone); ``loads`` (every weight word
  and scale loaded, each folded into one sum, no dequantization, no
  products, no reduction); ``dequant`` (the words dequantized and scaled,
  each weight added once: no products with x, no reduction); ``fma`` (the
  products with x's rows, no reduction across lanes, warps and the
  cluster); ``full`` (the kernel as it is).
- decode kernel: ``empty`` (no weight, x or scale read, no reduction: the
  launch of the cluster grid alone); ``loads`` (every weight word, x pair
  and scale loaded, folded into one sum); ``convert`` (the A fragments
  built from the words and the B fragments from x s, no mma); ``mma`` (the
  products, no reduction across warps and the cluster); ``full``.
The outputs of every variant but ``full`` are wrong by design; only their
times are read. Shapes: x [8, D] bf16 over gpt2-350m's mlp_up (D 1024, F
4096) and mlp_down (D 4096, F 1024), int8 and int4 weights, group 128, with
the plan each wrapper gives its kernel.

    python3 scripts/qmm_ablation.py [--out FILE]

Times are CUDA events around one call with the L2 flushed before it and the
host's launch kept out (median of 15), as ``chip_smoke.py`` times kernels;
one JSON line per kernel and shape (also appended to ``--out``).
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
CUTS = {"int8_matmul": {
    "EMPTY": ("    if (col >= Fq) continue;\n",
              "    if (col >= Fq) continue;\n#ifdef ABL_EMPTY\n    continue;\n#endif\n"),
    "LOADS": ("        if (dl >= sn) continue;\n        float w[NH][4];",
              "        if (dl >= sn) continue;\n#ifdef ABL_LOADS\n"
              "        acc[0][0][0] += __uint_as_float(words[r]) + sc[r][0];\n"
              "        continue;\n#endif\n        float w[NH][4];"),
    "DEQUANT": ("#pragma unroll\n        for (int m = 0; m < TM; ++m) {\n"
                "          const float xv = xs[m][dl];",
                "#ifdef ABL_DEQUANT\n#pragma unroll\n        for (int h = 0; h < NH; ++h)\n"
                "#pragma unroll\n          for (int u = 0; u < 4; ++u) acc[h][0][u] += w[h][u];\n"
                "        continue;\n#endif\n"
                "#pragma unroll\n        for (int m = 0; m < TM; ++m) {\n"
                "          const float xv = xs[m][dl];"),
    "REDUCE": ("  // the lanes of a warp that share columns add their sums: a shuffle",
               "#ifdef ABL_NO_REDUCE\n  {\n    float sum = 0.f;\n#pragma unroll\n"
               "    for (int h = 0; h < NH; ++h)\n#pragma unroll\n"
               "      for (int m = 0; m < TM; ++m)\n#pragma unroll\n"
               "        for (int u = 0; u < 4; ++u) sum += acc[h][m][u];\n"
               "    if (sum == 12345.f) out[0] = ds::from_float<T>(sum);\n    return;\n  }\n"
               "#endif\n  // the lanes of a warp that share columns add their sums: a shuffle"),
}, "int8_matmul_decode": {
    "EMPTY": ("  for (int b = 0; b < per_warp; b += kBatch) {",
              "#ifdef ABL_EMPTY\n  per_warp = 0;\n#endif\n"
              "  for (int b = 0; b < per_warp; b += kBatch) {"),
    "LOADS": ("#pragma unroll\n    for (int k = 0; k < kBatch; ++k) {\n"
              "      if (!(b + k < per_warp && slab0 + b + k < n_slabs)) continue;",
              "#ifdef ABL_LOADS\n#pragma unroll\n    for (int k = 0; k < kBatch; ++k)\n"
              "#pragma unroll\n      for (int i = 0; i < 8; ++i)\n"
              "        acc[0][0] += __uint_as_float(w[k][i].x ^ w[k][i].y) + xv[k][i / 2].x +\n"
              "                     sc[k][NS - 1][i];\n    continue;\n#endif\n"
              "#pragma unroll\n    for (int k = 0; k < kBatch; ++k) {\n"
              "      if (!(b + k < per_warp && slab0 + b + k < n_slabs)) continue;"),
    "MMA": ("            mma_bf16(d, a, bh[0], bh[1]);\n            mma_bf16(d, a, bm[0], bm[1]);\n"
            "            mma_bf16(d, a, bl[0], bl[1]);",
            "#ifdef ABL_NO_MMA\n"
            "            d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3]) + (bh[0] ^ bh[1]) +\n"
            "                                    (bm[0] ^ bm[1]) + (bl[0] ^ bl[1]));\n#else\n"
            "            mma_bf16(d, a, bh[0], bh[1]);\n            mma_bf16(d, a, bm[0], bm[1]);\n"
            "            mma_bf16(d, a, bl[0], bl[1]);\n#endif"),
    "REDUCE": ("  // the warp's sums: mma j of set h holds rows 2t, 2t + 1 of x at columns",
               "#ifdef ABL_NO_REDUCE\n  {\n    float sum = 0.f;\n#pragma unroll\n"
               "    for (int j = 0; j < NS * 4; ++j)\n#pragma unroll\n"
               "      for (int u = 0; u < 4; ++u) sum += acc[j][u];\n"
               "    if (sum == 12345.f) out[0] = ds::from_float<T>(sum);\n    return;\n  }\n"
               "#endif\n"
               "  // the warp's sums: mma j of set h holds rows 2t, 2t + 1 of x at columns"),
}}
VARIANTS = {
    "int8_matmul": {"empty": ["ABL_EMPTY", "ABL_NO_REDUCE"],
                    "loads": ["ABL_LOADS", "ABL_NO_REDUCE"],
                    "dequant": ["ABL_DEQUANT", "ABL_NO_REDUCE"], "fma": ["ABL_NO_REDUCE"],
                    "full": []},
    "int8_matmul_decode": {"empty": ["ABL_EMPTY", "ABL_NO_REDUCE"],
                           "loads": ["ABL_LOADS", "ABL_NO_REDUCE"],
                           "convert": ["ABL_NO_MMA", "ABL_NO_REDUCE"],
                           "mma": ["ABL_NO_REDUCE"], "full": []}}
ENTRY = {"int8_matmul": "ds_quant_matmul", "int8_matmul_decode": "ds_quant_matmul_decode"}
# (label, D, F): gpt2-350m's mlp_up and mlp_down
SHAPES = [("350m mlp_up", 1024, 4096), ("350m mlp_down", 4096, 1024)]
M, GROUP = 8, 128


def build(nvcc, flags, out_dir):
    """Each kernel's patched source and one library per variant, all built at once."""
    from deepspeed_tpu_torch.ops import _build

    csrc = os.path.join(REPO, "deepspeed_tpu_torch", "csrc")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for kernel, cuts in CUTS.items():
        src = open(os.path.join(csrc, f"{kernel}.cu")).read()
        for name, (text, guarded) in cuts.items():
            if src.count(text) != 1:
                raise RuntimeError(f"qmm_ablation: {kernel} no longer holds the {name} anchor")
            src = src.replace(text, guarded)
        patched = os.path.join(out_dir, f"{kernel}_ablation.cu")
        with open(patched, "w") as f:
            f.write(src)
        for v, defs in VARIANTS[kernel].items():
            procs[(kernel, v)] = subprocess.Popen(
                [nvcc, *flags, "-I", csrc, *[f"-D{d}" for d in defs], "-o",
                 os.path.join(out_dir, f"{kernel}_{v}.so"), patched],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for (kernel, v), p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise _build.KernelBuildError(f"nvcc failed on {kernel} variant {v}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{kernel}_{v}.so"))
        fn = getattr(lib, ENTRY[kernel])
        fn.argtypes = [ptr, i64] + [ptr] * 3 + [i32] * 9 + [ptr]
        fn.restype = i32
        libs[(kernel, v)] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("qmm_ablation.py: no CUDA device", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im
    from deepspeed_tpu_torch.ops.quantizer import quantize

    libs = build(_build._nvcc(), _build.NVCC_FLAGS, os.path.join(REPO, "build", "qmm_ablation"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, D, F in SHAPES:
        for bits in (8, 4):
            w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
            q, s = quantize(w, bits=bits, num_groups=D * F // GROUP)
            q = im.pack_int4(q) if bits == 4 else q
            x = torch.randn((M, D), generator=gen, device="cuda").to(torch.bfloat16)
            out = torch.empty((M, F), dtype=torch.bfloat16, device="cuda")
            plans = {"int8_matmul": im.split_plan(M, D, q.shape[1], sms),
                     "int8_matmul_decode": im.decode_plan(D, q.shape[1], sms, bits)}
            for kernel in CUTS:
                lanes_or_warps, second, cluster = plans[kernel]
                row = {"card": card, "kernel": kernel, "shape": label, "M": M, "D": D, "F": F,
                       "bits": bits, "group": GROUP, "dtype": "bfloat16",
                       "plan": list(plans[kernel]), "weight_bytes": q.numel() + 4 * s.numel()}
                for v in VARIANTS[kernel]:
                    fn = libs[(kernel, v)]

                    def run(fn=fn, v=v):
                        if kernel == "int8_matmul":  # (lanes, chunk, cluster)
                            plan = (second, cluster, lanes_or_warps)
                        else:  # (warps, per_warp, cluster)
                            plan = (lanes_or_warps, second, cluster)
                        status = fn(x.data_ptr(), x.stride(0), q.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), M, D, F, GROUP, *plan, bits, 1,
                                    torch.cuda.current_stream().cuda_stream)
                        if status != 0:
                            raise RuntimeError(f"qmm_ablation {kernel} {v}: CUDA error {status}")
                    row[f"{v}_ms"] = timer.ms(run)
                name = f"int{bits}_matmul"
                want = (im._launch if kernel == "int8_matmul" else im._launch_decode)(
                    name, x, q, s, F, GROUP, bits)
                row["full_matches_the_wrapper"] = bool(torch.equal(out, want))
                line = json.dumps(row)
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
