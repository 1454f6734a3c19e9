#!/usr/bin/env python3
"""Times the quantized-weight products of one checkout of the PyTorch/CUDA
port on one CUDA card: B8 (the dequant-fused product of the ZeRO-3 quantized
LM head) and B6 / B7 (int8 / int4 weights) with fp32 x, through the route
the checkout's wrapper picks and through each of its kernels directly.

B8 rows, x fp32 over GPT-2-125M's head (D 768, vocabulary 50304): phase 9d's
32 rows (block 256, and at a block of 96), 4096 rows at a block of 128
(``zero_quantize_block_size`` 128: phase 9e's configuration), at the default
block of 256 (phase 9b's) and at a block of 96; and a head whose D is off
64-row steps (D 480, 32 and 4096 rows, block 256), and gpt-neox-20b's D 6144
(256 rows, blocks of 256 and 96: where the checkout promotes its
accumulators into fp32 sums, the unpromoted kernel's time and error on the
same inputs too); each beside cuBLAS fp32 (TF32 off) over the weight already dequantized, the
plain version, the bound and the error against the float64 product. Where
the checkout has ``dqm_tile``, the tensor-core kernel is also timed at each
of its tilings that take the shape; where it has the CUDA-core B8, that
kernel on the same inputs. B6 / B7 rows: fp32 x at the 8 projection
shapes of GPT-2-125M and gpt2-350m, M 16 / 64 / 256, group 128: the route's
kernel, the CUDA-core and (where the checkout's takes fp32) the tensor-core
kernel on the same inputs, cuBLAS fp32 over the dequantized weight, the
bound and the error against the float64 product. Decode rows: bf16 and
fp32 x at M 1 / 4 / 8 over the same shapes, int8 and int4, group 128,
through the route (the decode kernel, where the checkout has it), the CUDA-core kernel on
the same inputs, cuBLAS in x's dtype over the weight dequantized to it and
the bound. Paths rows: the device-busy time of 8 bf16 decode steps of
gpt2-350m at B8 (phase 7b's row) over dense bf16, int8 and int4 weights and
B6 / B7's share of it (torch.profiler). Neox rows: B6 / B7 with fp32 x at
gpt-neox-20b's mlp_down (D 24576), 8 and 64 rows, with the error against the
float64 product. ``--parts`` picks the groups of rows (default
``b8,decode,qmm``; add ``paths``, ``neox``).

    python3 scripts/quant_tc_bench.py [--tree DIR] [--tag NAME] [--out FILE] [--parts LIST]

``--tree`` names the checkout whose ``deepspeed_tpu_torch`` is imported and
built (default: the one holding this script). To compare two commits on one
card, unpack the other with ``git archive`` into a directory ``.gitignore``
lists and run the two in turns, in one command: parent, change, change,
parent. Each row prints as one JSON line (also appended to ``--out``).
Kernel times are CUDA events around one call with the L2 flushed before it
and the host's launch kept out (median of 15), as ``chip_smoke.py`` times
them. Bounds are ``chip_smoke.py``'s: the bytes read and written once, and
the fp32 function's operations as three bf16 passes at the bf16 peak.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)  # after --tree's entry, so that the tree's package is the one imported

from chip_smoke import (QMM_SHAPES, Timer, _decode_profile, _dqm_exact, dqm_bound,  # noqa: E402
                        qmm_bound)

V = 50304
# (label, M, D, block): phase 9d's head, 9e's and 9b's at B8 x T512, both
# at a block of 96 (off 64-column panels), a head of d 480 (off 64-row
# steps), and gpt-neox-20b's D 6144 at 256 rows
DQM_ROWS = [("9d", 32, 768, 256), ("9e", 4096, 768, 128), ("9b", 4096, 768, 256),
            ("9d-block96", 32, 768, 96), ("4096-block96", 4096, 768, 96),
            ("d480", 32, 480, 256), ("4096-d480", 4096, 480, 256),
            ("neox-d6144", 256, 6144, 256), ("neox-d6144-block96", 256, 6144, 96)]
QMM_ROWS = (16, 64, 256)
DECODE_ROWS = (1, 4, 8)
GROUP = 128


def _rel(out, exact):
    return (out.double() - exact).abs().max().item() / exact.abs().max().item()


def dqm_rows(torch, timer, emit):
    from deepspeed_tpu_torch.comm.quantized import dequantize_blockwise, quantize_blockwise
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    gen = torch.Generator(device="cuda").manual_seed(3)
    # the checkouts up to the CUDA-core B8's removal pass a route to _launch
    routed = hasattr(dqm, "_lib")
    for label, M, D, block in DQM_ROWS:
        w = torch.randn((D, V), generator=gen, device="cuda") * 0.02
        q, s, z = quantize_blockwise(w, bits=8, block_size=block)
        x = torch.randn((M, D), generator=gen, device="cuda")
        Fp, nb = q.shape[1], s.shape[1]
        route = dqm.dqm_route(M, D, Fp, nb)
        exact = _dqm_exact(torch, x, q, s, z, V)
        w_hat = dequantize_blockwise(q, s, z, orig_size=V)
        row = {"kernel": "dequant_matmul", "row": label, "M": M, "D": D, "F": V, "block": block,
               "route": route,
               "ms": timer.ms(lambda: dqm.dequant_matmul(x, q, s, z, orig_size=V), iters=15),
               "rel_err_vs_fp64": _rel(dqm.dequant_matmul(x, q, s, z, orig_size=V), exact),
               "plain_ms": timer.ms(lambda: dqm.dequant_matmul_ref(x, q, s, z, orig_size=V)),
               "library_ms": timer.ms(lambda: torch.matmul(x, w_hat)),
               "plain_rel_err_vs_fp64": _rel(torch.matmul(x, w_hat), exact)}
        row["bound_ms"], row["bound_by"] = dqm_bound(M, D, V, Fp, nb, 4)
        if routed:
            row["cuda_cores_ms"] = timer.ms(lambda: dqm._launch(x, q, s, z, V, "cuda_cores"))
        padded = getattr(dqm, "padded_block", lambda Fp, nb: Fp // nb)(Fp, nb)
        promote = hasattr(dqm, "dqm_promotes") and dqm.dqm_promotes(D, x.dtype)
        if promote:  # one accumulator over all of D, on the same inputs
            tile = dqm.dqm_tile(M, Fp, nb)
            row["unpromoted_ms"] = timer.ms(lambda: dqm._launch(x, q, s, z, V, tile, False))
            row["unpromoted_rel_err_vs_fp64"] = _rel(dqm._launch(x, q, s, z, V, tile, False),
                                                     exact)
        if hasattr(dqm, "dqm_tile") and route == "tensor_cores":
            # every tiling of the tensor-core kernel that takes it (promoting
            # where the checkout does: not 128 x 256)
            row["tile"] = list(dqm.dqm_tile(M, Fp, nb, promote) if promote
                               else dqm.dqm_tile(M, Fp, nb))
            for tile in ((2, 256), (2, 128), (2, 64), (1, 256), (1, 128)):
                wn = tile[1] if tile[0] == 2 else tile[1] // 2
                if padded % wn == 0 and not (promote and tile == (2, 256)):
                    args = ("tensor_cores", tile) if routed else (tile,)
                    row[f"tile_{tile[0]}x{tile[1]}_ms"] = timer.ms(
                        lambda: dqm._launch(x, q, s, z, V, *args))
        elif route == "tensor_cores":
            row["tensor_cores_ms"] = row["ms"]
        emit(row)
        del w, q, s, z, x, exact, w_hat
        torch.cuda.empty_cache()


def qmm_rows(torch, timer, emit):
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im
    from deepspeed_tpu_torch.ops.quantizer import dequantize, quantize

    gen = torch.Generator(device="cuda").manual_seed(5)
    tc_fp32 = hasattr(im, "tc_takes")  # the checkout's tensor-core kernel takes fp32 x
    for bits in (8, 4):
        name = f"int{bits}_matmul"
        fn, plain = ((im.int4_matmul, im.int4_matmul_ref) if bits == 4
                     else (im.int8_matmul, im.int8_matmul_ref))
        for D, F in QMM_SHAPES:
            w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
            q, s = quantize(w, bits=bits, num_groups=D * F // GROUP)
            wq = q
            q = im.pack_int4(q) if bits == 4 else q
            w_dense = dequantize(wq, s)
            w64 = (wq.double().reshape(-1, GROUP) * s.double().reshape(-1, 1)).reshape(D, F)
            for M in QMM_ROWS:
                x = torch.randn((M, D), generator=gen, device="cuda")
                exact = x.double() @ w64
                row = {"kernel": name, "M": M, "D": D, "F": F, "group": GROUP, "dtype": "float32",
                       "route": im.qmm_route(M, torch.float32, D, F, GROUP, bits),
                       "ms": timer.ms(lambda: fn(x, q, s, GROUP)),
                       "rel_err_vs_fp64": _rel(fn(x, q, s, GROUP), exact),
                       "plain_ms": timer.ms(lambda: plain(x, q, s, GROUP)),
                       "library_ms": timer.ms(lambda: torch.matmul(x, w_dense)),
                       "plain_rel_err_vs_fp64": _rel(plain(x, q, s, GROUP), exact),
                       "cuda_cores_ms": timer.ms(
                           lambda: im._launch(name, x, q, s, F, GROUP, bits))}
                if tc_fp32:
                    row["tensor_cores_ms"] = timer.ms(
                        lambda: im._launch_tc(name, x, q, s, F, GROUP, bits))
                row["bound_ms"], row["bound_by"] = qmm_bound(M, D, F, GROUP, bits, "float32", 4)
                emit(row)
            del w, q, s, wq, w_dense, w64
            torch.cuda.empty_cache()


def decode_rows(torch, timer, emit):
    """B6 / B7 at decode rows through the route, beside the CUDA-core kernel
    on the same inputs and cuBLAS in x's dtype."""
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im
    from deepspeed_tpu_torch.ops.quantizer import dequantize, quantize

    gen = torch.Generator(device="cuda").manual_seed(7)
    for bits in (8, 4):
        name = f"int{bits}_matmul"
        fn = im.int4_matmul if bits == 4 else im.int8_matmul
        for D, F in QMM_SHAPES:
            w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
            q, s = quantize(w, bits=bits, num_groups=D * F // GROUP)
            wq = q
            q = im.pack_int4(q) if bits == 4 else q
            w64 = (wq.double().reshape(-1, GROUP) * s.double().reshape(-1, 1)).reshape(D, F)
            for dt in ("bfloat16", "float32"):
                dtype = getattr(torch, dt)
                w_dense = dequantize(wq, s, dtype)
                for M in DECODE_ROWS:
                    x = torch.randn((M, D), generator=gen, device="cuda").to(dtype)
                    row = {"kernel": name, "M": M, "D": D, "F": F, "group": GROUP, "dtype": dt,
                           "route": im.qmm_route(M, dtype, D, F, GROUP, bits),
                           "ms": timer.ms(lambda: fn(x, q, s, GROUP)),
                           "library_ms": timer.ms(lambda: torch.matmul(x, w_dense)),
                           "cuda_cores_ms": timer.ms(
                               lambda: im._launch(name, x, q, s, F, GROUP, bits))}
                    if dt == "float32":
                        row["rel_err_vs_fp64"] = _rel(fn(x, q, s, GROUP), x.double() @ w64)
                    row["bound_ms"], row["bound_by"] = qmm_bound(M, D, F, GROUP, bits, "float32",
                                                                 x.element_size())
                    emit(row)
                del w_dense
            del w, q, s, wq, w64
            torch.cuda.empty_cache()


def neox_rows(torch, timer, emit):
    """B6 / B7 with fp32 x at gpt-neox-20b's mlp_down (D 24576, F 6144,
    group 128, weights at GPT-2's scale): 8 rows (the decode kernel) and 64
    rows (the tensor cores, whose accumulators truncate: the widest D of the
    presets), int8 and int4, each with its error against the float64
    product and its time."""
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im
    from deepspeed_tpu_torch.ops.quantizer import quantize

    gen = torch.Generator(device="cuda").manual_seed(11)
    D, F = 24576, 6144
    for bits in (8, 4):
        fn = im.int4_matmul if bits == 4 else im.int8_matmul
        w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
        q, s = quantize(w, bits=bits, num_groups=D * F // GROUP)
        w64 = (q.double().reshape(-1, GROUP) * s.double().reshape(-1, 1)).reshape(D, F)
        q = im.pack_int4(q) if bits == 4 else q
        for M in (8, 64):
            x = torch.randn((M, D), generator=gen, device="cuda")
            row = {"kernel": f"int{bits}_matmul", "row": "neox-mlp_down", "M": M, "D": D, "F": F,
                   "group": GROUP, "dtype": "float32",
                   "route": im.qmm_route(M, torch.float32, D, F, GROUP, bits),
                   "ms": timer.ms(lambda: fn(x, q, s, GROUP)),
                   "rel_err_vs_fp64": _rel(fn(x, q, s, GROUP), x.double() @ w64)}
            row["bound_ms"], row["bound_by"] = qmm_bound(M, D, F, GROUP, bits, "float32", 4)
            emit(row)
        del w, q, s, w64
        torch.cuda.empty_cache()


def path_rows(torch, emit):
    """Device-busy time of 8 bf16 decode steps of gpt2-350m at B8 after a
    128-token prompt (phase 7b), dense bf16, int8 and int4 weights."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import for_gpt
    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-350m"]
    params = gpt.init_params(cfg, 0, device="cuda")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 128)).astype(np.int32)
    for kind, bits in (("bf16", None), ("int8", 8), ("int4", 4)):
        quant = {"enabled": True, "bits": bits, "group_size": GROUP} if bits else {}
        engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype="bfloat16",
                                                    quant=quant)
        for rep in range(2):
            kernels = []
            _decode_profile(torch, engine, prompt, steps=8, sink=kernels)
            busy = sum(r[2] for r in kernels)
            qmm = [r for r in kernels if "qmatmul" in r[0]]
            emit({"path": "7b decode, 8 steps", "weights": kind, "rep": rep,
                  "device_busy_ms": busy, "b6b7_ms": sum(r[2] for r in qmm),
                  "b6b7_launches": sum(r[1] for r in qmm),
                  "b6b7_kernels": sorted({r[0][:60] for r in qmm})})
        del engine
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--parts", default="b8,decode,qmm")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    import torch

    if not torch.cuda.is_available():
        print("quant_tc_bench.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    assert os.path.abspath(dqm.__file__).startswith(os.path.abspath(args.tree)), dqm.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else torch.cuda.get_device_name(0)

    def emit(row):
        row = {"tag": args.tag, "tree": args.tree, "card": card, **row}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    timer = Timer(torch)
    for part, rows in (("b8", dqm_rows), ("decode", decode_rows), ("qmm", qmm_rows),
                       ("neox", neox_rows)):
        if part in parts:
            rows(torch, timer, emit)
    if "paths" in parts:
        path_rows(torch, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
