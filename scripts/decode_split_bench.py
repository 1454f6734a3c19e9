#!/usr/bin/env python3
"""Times the decode attention kernels B3 (``decode_attention``), B4
(``paged_decode_attention``) and B5 (``paged_verify_attention``) and the
dequant-fused LM-head product B8 (``dequant_matmul``) of one checkout of the
PyTorch/CUDA port on one CUDA card, beside SDPA (cuBLAS fp32 for B8) and
their bounds, and the device-busy time of one bf16 decode step (GPT-2-125M,
B4, position 512: ``chip_smoke.py`` phase 4's ``generate`` step), of one
paged decode step (8 slots, page 64: phase 6b's) and of one verify window (W
5 at 16 active slots, page 128: phase 8b's) with their idle shares.

    python3 scripts/decode_split_bench.py [--tree DIR] [--tag NAME] [--out FILE]

``--tree`` names the checkout whose ``deepspeed_tpu_torch`` is imported and
built (default: the one holding this script). To compare two commits on one
card, unpack the other with ``git archive`` into a directory ``.gitignore``
lists and run the two in turns, in one command: parent, change, change,
parent. Each row prints as one JSON line (also appended to ``--out``).
Shapes the tree's kernels do not take (head dim 96 before it was built) print
``"unsupported"``. Kernel times are CUDA events around one call with the L2
flushed before it and the host's launch kept out (median of 15), as
``chip_smoke.py`` times them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)  # after --tree's entry, so that the tree's package is the one imported

from chip_smoke import (Timer, _dqm_exact, _paged_lengths,  # noqa: E402
                        _verify_library_inputs, decode_bound, device_kernels, dqm_bound,
                        paged_bound, verify_bound)


def busy(torch, fn) -> float:
    """Device-busy ms of one call of ``fn`` (its kernels' self times)."""
    return sum(ms for _, _, ms in device_kernels(torch, fn))


def wall(torch, fn, reps: int = 4) -> float:
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls[1:]))


def decode_rows(torch, da, timer, emit):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, S = 4, 12, 640
    for Dh, lens_list, dt in [(64, [544] * 4, "bfloat16"), (64, [1, 77, 513, 640], "float32"),
                              (64, [1, 77, 513, 640], "bfloat16"), (96, [544] * 4, "bfloat16"),
                              (96, [1, 77, 513, 640], "float32")]:
        dtype = getattr(torch, dt)
        q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, H, S, Dh), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        row = dict(kernel="B3", B=B, H=H, S=S, Dh=Dh, lengths=lens_list, dtype=dt)
        try:
            out = da.decode_attention(q, k, v, lens)
        except NotImplementedError:
            emit({**row, "kernel_ms": "unsupported"})
            continue
        err = (out.float() - da.decode_attention_ref(q, k, v, lens).float()).abs().max().item()
        valid = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)
        bms, by = decode_bound(lens_list, H, S, Dh, dt, q.element_size())
        emit({**row, "max_abs_err": err,
              "kernel_ms": timer.ms(lambda: da.decode_attention(q, k, v, lens)),
              "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                  qt, k, v, attn_mask=valid)),
              "bound_ms": bms, "bound_by": by})


def paged_rows(torch, da, timer, emit):
    """B4 at the serving shape (8 slots, H12, page 64, 8 pages a row, pool
    17) and at 16 pages a row (pool 257), dense / int8 / int4 pools, fp32 and
    bf16, over the same lengths and page ids as chip_smoke.py phase 2."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(5)
    B, H, Dh, ps = 8, 12, 64, 64
    for pages, pool in ((8, 17), (16, 257)):
        full = pages * ps
        lens_list = _paged_lengths(B, pages, ps, rng)
        tables_np = np.zeros((B, pages), np.int32)
        for b, n in enumerate(lens_list):
            used = -(-n // ps)
            tables_np[b, :used] = rng.choice(np.arange(1, pool), used, replace=False)
        tables = torch.from_numpy(tables_np).cuda()
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        valid = (torch.arange(full, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            for kind, bits in (("dense", None), ("kv8", 8), ("kv4", 4)):
                q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(dtype)
                if bits is None:
                    k, v = (torch.randn((H, pool, ps, Dh), generator=gen, device="cuda")
                            .to(dtype) for _ in range(2))
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

                ref = da.paged_decode_attention(q, k, v, lens, tables, impl="gather",
                                                k_scales=ks, v_scales=vs)
                err = (kernel().float() - ref.float()).abs().max().item()
                tl = tables.long()
                kc = da.gather_pages(k, ks, tl, Dh).to(dtype)
                vc = da.gather_pages(v, vs, tl, Dh).to(dtype)
                qt = q.transpose(1, 2)
                bms, by = paged_bound(lens_list, H, Dh, ps, bits, dt, q.element_size())
                emit({"kernel": "B4", "kind": kind, "B": B, "H": H, "Dh": Dh, "ps": ps,
                      "pages": pages, "dtype": dt, "lengths": lens_list, "max_abs_err": err,
                      "kernel_ms": timer.ms(kernel),
                      "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                          qt, kc, vc, attn_mask=valid)),
                      "bound_ms": bms, "bound_by": by})
                del kc, vc


def dequant_rows(torch, timer, emit):
    """B8 at the main-path shape (the GPT-2-125M LM head at B8 x T512: x
    [4096, 768] fp32, vocabulary 50304 in blocks of 256) through the tree's
    own route, its error and cuBLAS fp32's (TF32 off, over the weight
    already dequantized) against the float64 product."""
    from deepspeed_tpu_torch.comm.quantized import dequantize_blockwise, quantize_blockwise
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    gen = torch.Generator(device="cuda").manual_seed(3)
    M, D, F = 4096, 768, 50304
    w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
    q, s, z = quantize_blockwise(w, bits=8)
    x = torch.randn((M, D), generator=gen, device="cuda")
    w_hat = dequantize_blockwise(q, s, z, orig_size=F)
    out, lib = dqm.dequant_matmul(x, q, s, z, orig_size=F), torch.matmul(x, w_hat)
    exact = _dqm_exact(torch, x, q, s, z, F)
    top = exact.abs().max().item()
    route = dqm.dqm_route(M, D, q.shape[1], s.shape[1]) if hasattr(dqm, "dqm_route") else (
        "cuda_cores")
    bms, by = dqm_bound(M, D, F, q.shape[1], s.shape[1], 4, route)
    emit({"kernel": "B8", "M": M, "D": D, "F": F, "dtype": "float32", "route": route,
          "rel_err_vs_fp64": (out.double() - exact).abs().max().item() / top,
          "library_rel_err_vs_fp64": (lib.double() - exact).abs().max().item() / top,
          "kernel_ms": timer.ms(lambda: dqm.dequant_matmul(x, q, s, z, orig_size=F), iters=7),
          "library_ms": timer.ms(lambda: torch.matmul(x, w_hat), iters=7),
          "bound_ms": bms, "bound_by": by})


def verify_rows(torch, da, timer, emit):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.default_rng(6)
    B, H, ps, pages, pool = 8, 12, 64, 8, 17
    cap = ps * pages
    lens_list = [0, 1, ps - 1, ps, ps + 1, cap // 2 + 7, cap - 9, cap - 1]
    tables_np = np.zeros((B, pages), np.int32)
    for b, n in enumerate(lens_list):
        used = min(-(-(n + 17) // ps), pages)
        tables_np[b, :used] = rng.choice(np.arange(1, pool), used, replace=False)
    tables = torch.from_numpy(tables_np).cuda()
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    for Dh in (64, 96):
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            for kind, bits in (("dense", None), ("kv8", 8), ("kv4", 4)):
                if bits is None:
                    k, v = (torch.randn((H, pool, ps, Dh), generator=gen, device="cuda")
                            .to(dtype) for _ in range(2))
                    ks = vs = None
                else:
                    dq = Dh // 2 if bits == 4 else Dh
                    k, v = (torch.randint(-128, 128, (H, pool, ps, dq), generator=gen,
                                          device="cuda", dtype=torch.int8) for _ in range(2))
                    ks, vs = (torch.rand((H, pool), generator=gen, device="cuda") * 0.02 + 1e-3
                              for _ in range(2))
                for W in (2, 5, 17):
                    qkv = torch.randn((B, W, 3 * H * Dh), generator=gen, device="cuda").to(dtype)
                    q, wk, wv = (x.reshape(B, W, H, Dh) for x in qkv.split(H * Dh, dim=-1))
                    row = dict(kernel="B5", kind=kind, B=B, H=H, Dh=Dh, ps=ps, W=W, dtype=dt,
                               lengths=lens_list)

                    def kernel():
                        return da.paged_verify_attention(q, k, v, lens, tables, wk, wv,
                                                         k_scales=ks, v_scales=vs)

                    try:
                        out = kernel()
                    except NotImplementedError:
                        emit({**row, "kernel_ms": "unsupported"})
                        continue
                    ref = da.paged_verify_attention(q, k, v, lens, tables, wk, wv,
                                                    impl="gather", k_scales=ks, v_scales=vs)
                    keep = lens.long()[:, None] + torch.arange(W, device="cuda") < cap
                    err = (out[keep].float() - ref[keep].float()).abs().max().item()
                    kc, vc, mask = _verify_library_inputs(torch, da, k, v, ks, vs, tables, lens,
                                                          wk, wv, dtype)
                    qt = q.transpose(1, 2)
                    bms, by = verify_bound(lens_list, W, H, Dh, ps, bits, dt, q.element_size())
                    emit({**row, "max_abs_err": err, "kernel_ms": timer.ms(kernel),
                          "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                              qt, kc, vc, attn_mask=mask)),
                          "bound_ms": bms, "bound_by": by})
                    del kc, vc, mask


def step_rows(torch, emit):
    """Device busy and wall of one bf16 decode step (phase 4's) and one
    verify window (phase 8b's), each the mean over 8."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import for_gpt
    from deepspeed_tpu_torch.inference.serving import ServingConfig, ServingEngine
    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    params = gpt.init_params(cfg, 0, device="cuda")

    engine = init_inference(for_gpt(cfg, params), dtype="bfloat16")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 512)).astype(np.int32)
    m, p = engine.model, engine.params
    with torch.no_grad():
        cache = m.init_cache(4, 640, engine.dtype, engine.device)
        _, cache = m.prefill(p, torch.as_tensor(prompt, device=engine.device).long(), cache)
        tok = torch.zeros((4, 1), dtype=torch.long, device=engine.device)

        def eight_decode():
            c = dict(cache)
            for _ in range(8):
                _, c = m.prefill(p, tok, c)

        w, b = wall(torch, eight_decode), busy(torch, eight_decode)
    emit(dict(path="decode step (phase 4, bf16, B4, position 512)", device_busy_ms=b / 8,
              wall_ms=w / 8, idle_share=max(0.0, 1 - b / w)))
    del engine, cache

    eng = ServingEngine(cfg, params, ServingConfig(
        num_slots=16, page_size=128, max_model_len=512, prefill_chunk=128, decode_block=1,
        dtype="bfloat16", spec_drafter="ngram", spec_k=4))
    eng.warmup()
    slots, W = 16, 5
    tables = np.zeros((slots, 4), np.int32)
    tables[:, :2] = np.arange(1, 2 * slots + 1).reshape(slots, 2)
    mask = np.ones(slots, bool)
    window = np.random.default_rng(8).integers(0, cfg.vocab_size, (slots, W)).astype(np.int32)

    def eight_verify():
        for i in range(8):
            lens = np.full(slots, 100 + i * W, np.int32)
            eng.verify(window, tables, lens, mask, np.full(slots, -1, np.int32),
                       np.full(slots, W, np.int32))

    w, b = wall(torch, eight_verify), busy(torch, eight_verify)
    emit(dict(path="verify window (phase 8b, bf16, 16 slots, page 128, W 5)",
              device_busy_ms=b / 8, wall_ms=w / 8, idle_share=max(0.0, 1 - b / w)))
    del eng

    # phase 6b's paged decode step: 8 active slots of 8 pages of 64, lengths
    # near 300, one token each
    eng = ServingEngine(cfg, params, ServingConfig(
        num_slots=8, page_size=64, max_model_len=512, num_pages=65, prefill_chunk=128,
        decode_block=1, dtype="bfloat16"))
    eng.warmup()
    slots = 8
    tables = np.arange(1, 8 * slots + 1, dtype=np.int32).reshape(slots, 8)
    mask = np.ones(slots, bool)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (slots, 1)).astype(np.int32)

    def eight_decode_paged():
        for i in range(8):
            eng.decode(toks, tables, np.full(slots, 300 + i, np.int32), mask)

    w, b = wall(torch, eight_decode_paged), busy(torch, eight_decode_paged)
    emit(dict(path="paged decode step (phase 6b, bf16, 8 slots, page 64, lengths ~300)",
              device_busy_ms=b / 8, wall_ms=w / 8, idle_share=max(0.0, 1 - b / w)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_split_bench.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
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

    assert os.path.abspath(da.__file__).startswith(os.path.abspath(args.tree)), da.__file__
    timer = Timer(torch)
    decode_rows(torch, da, timer, emit)
    paged_rows(torch, da, timer, emit)
    verify_rows(torch, da, timer, emit)
    dequant_rows(torch, timer, emit)
    step_rows(torch, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
