#!/usr/bin/env python3
"""Times B9 (blocksparse attention: the forward, dq with delta, dk/dv) of one
checkout of the PyTorch/CUDA port on one CUDA card, at ``chip_smoke.py``
phase 10b's shape (the sparse GPT-2-125M: B2 x T4096, H12, D64, bf16, the Fixed
unidirectional layout of blocks of 128, 4 local and 1 global: 192 of the 528
causal blocks active), at phase 2's D96 row (the same pattern at
gpt2-760m's 16 heads of 96, B2 x T1024, bf16), at phase 10a's fp32 row (the
sparse GPT-2-125M at B2 x T1024), at phase 10c's (the same window at blocks
of 32, B2 x T1024 bf16) and at phase 2's small blocks (B2 x T512, H12, D64:
Variable at blocks of 16, BSLongformer not causal at 32), in bf16 and fp32,
beside B1 / B2 over dense causal attention at the same shape (and
that time scaled to the layout's share of the causal blocks), one SDPA call
with the layout expanded to a boolean [H, T, T] mask and its backward, and
the bounds (fp32: three TF32 passes at the TF32 peak, and one fp32 pass on
the CUDA cores); then phase 10b's sparse and dense training step (bf16
master + ZeRO-2, B2 x T4096), phase 10a's fp32 step and 10c's bf16 step at
blocks of 32: step ms, device busy and B9's (or B1 / B2's) share of it.

    python3 scripts/blocksparse_bench.py [--tree DIR] [--tag NAME] [--out FILE] [--no-paths]
                                         [--fwd-ref FILE]

``--tree`` names the checkout whose ``deepspeed_tpu_torch`` is imported and
built (default: the one holding this script). To compare two commits on one
card, unpack the other with ``git archive`` into a directory ``.gitignore``
lists and run the two in turns, in one command: parent, change, change,
parent. Each row prints as one JSON line (also appended to ``--out``) with
the tree's route for the row's inputs. Kernel times are CUDA events around
one call with the L2 flushed before it and the host's launch kept out
(median of 15), as ``chip_smoke.py`` times them; step times are CUDA events
around ``train_batch`` (median of steps 2-6); busy times are the kernels'
self times in a ``torch.profiler`` trace of one step. ``--no-paths`` times
the kernels alone. ``--fwd-ref FILE`` keeps each row's forward output (o
and lse): a run that finds FILE missing writes it, a run that finds it
compares its own with it bitwise (``fwd_bitwise_vs_ref`` in each row), so
a parent run followed by a change run shows whether the change keeps the
parent's forward bit for bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)  # after --tree's entry, so that the tree's package is the one imported

from chip_smoke import (SMALL_BLOCK_LAYOUT, SPARSE_GPT_LAYOUT, Timer, _engine,  # noqa: E402
                        _timed_steps, _train_config, bs_bounds, bs_visible_pairs,
                        bs_visited_tiles, device_kernels, flash_bound, flash_bwd_bounds)

# (label, B, T, H, D, dtype): phase 10b's main-path row, phase 2's D96 row,
# phase 10a's fp32 row (the fixed layout of SPARSE_GPT_LAYOUT at H heads),
# phase 10c's (SMALL_BLOCK_LAYOUT), then phase 2's small blocks
SHAPES = [("10b", 2, 4096, 12, 64, "bfloat16"), ("d96", 2, 1024, 16, 96, "bfloat16"),
          ("10a", 2, 1024, 12, 64, "float32"), ("10c", 2, 1024, 12, 64, "bfloat16"),
          ("variable-16", 2, 512, 12, 64, "bfloat16"), ("variable-16", 2, 512, 12, 64, "float32"),
          ("longformer-32", 2, 512, 12, 64, "bfloat16"),
          ("longformer-32", 2, 512, 12, 64, "float32")]


def _layout(label, H, T):
    """(layout, block, causal) of a row: phase 2's layouts."""
    from deepspeed_tpu_torch.ops.sparse_attention import (BSLongformerSparsityConfig,
                                                          FixedSparsityConfig,
                                                          VariableSparsityConfig)

    if label == "variable-16":
        cfg = VariableSparsityConfig(num_heads=H, block=16, num_random_blocks=2,
                                     local_window_blocks=[4], global_block_indices=[0],
                                     attention="unidirectional")
        return cfg.make_layout(T), 16, True
    if label == "longformer-32":
        cfg = BSLongformerSparsityConfig(num_heads=H, block=32, num_sliding_window_blocks=5)
        return cfg.make_layout(T), 32, False
    if label == "10c":
        cfg = FixedSparsityConfig(**{**SMALL_BLOCK_LAYOUT, "num_heads": H})
        return cfg.make_layout(T), cfg.block, True
    cfg = FixedSparsityConfig(**{**SPARSE_GPT_LAYOUT, "num_heads": H})
    return cfg.make_layout(T), cfg.block, True


def _routes(bs, dtype, block, D):
    """(forward, backward) routes of the tree's B9 (an older tree's bs_route
    names one route for both passes)."""
    if not hasattr(bs, "tile_tables"):
        route = bs.bs_route(dtype, block, D) if hasattr(bs, "bs_route") else "cuda"
        return route, route
    return bs.bs_route(dtype, block, D, "fwd"), bs.bs_route(dtype, block, D, "bwd")


def kernel_rows(torch, bs, fa, timer, emit, fwd_ref=""):
    import torch.nn.functional as F

    saved = {}
    if fwd_ref and os.path.exists(fwd_ref):
        saved = torch.load(fwd_ref, map_location="cuda")
    outputs = {}

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for label, B, T, H, D, dt in SHAPES:
        dtype = getattr(torch, dt)
        layout, block, causal = _layout(label, H, T)
        qkv = randn((B, T, 3 * H * D), dtype)
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        do = randn((B, T, H, D), dtype)
        tables = (bs.device_tables(layout, block, "cuda") if hasattr(bs, "tile_tables")
                  else bs.device_tables(layout, "cuda"))
        scale = 1.0 / math.sqrt(D)
        route = _routes(bs, dtype, block, D)

        o, lse = bs.blocksparse_attention_fwd(q, k, v, layout, block, causal, tables=tables)
        dq, delta = bs.blocksparse_attention_bwd_dq(q, k, v, o, do, lse, layout, block, causal,
                                                    scale, tables)
        dk, dv = bs.blocksparse_attention_bwd_dkv(q, k, v, do, lse, delta, layout, block,
                                                  causal, scale, tables)
        o_ref, lse_ref = bs.blocksparse_attention_fwd_ref(q, k, v, layout, block, causal)
        dq_ref, delta_ref = bs.blocksparse_attention_bwd_dq_ref(q, k, v, o, do, lse, layout,
                                                                block, causal, scale)
        ref = (dq_ref, *bs.blocksparse_attention_bwd_dkv_ref(q, k, v, do, lse, delta_ref,
                                                            layout, block, causal, scale))
        rel = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip((dq, dk, dv), ref)]
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref, dq_ref, ref, dq, dk, dv
        row_key = f"{label} {dt}"
        fwd_bitwise = None
        if row_key in saved:  # the reference run's forward on the same inputs
            fwd_bitwise = (torch.equal(o, saved[row_key][0])
                           and torch.equal(lse, saved[row_key][1]))
        elif fwd_ref:
            outputs[row_key] = (o.clone(), lse.clone())

        ms = {
            "fwd": timer.ms(lambda: bs.blocksparse_attention_fwd(q, k, v, layout, block, causal,
                                                                 tables=tables)),
            "dq": timer.ms(lambda: bs.blocksparse_attention_bwd_dq(
                q, k, v, o, do, lse, layout, block, causal, scale, tables)),
            "dkv": timer.ms(lambda: bs.blocksparse_attention_bwd_dkv(
                q, k, v, do, lse, delta, layout, block, causal, scale, tables)),
        }
        # B1 / B2 on the tensor cores over dense causal attention at the same shape
        fo, flse = fa.flash_attention_fwd(q, k, v, causal=True)
        fdelta = fa.flash_attention_bwd_delta(fo, do)
        dense = {
            "fwd": timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
            "dq": timer.ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, flse, fdelta, True,
                                                             scale)),
            "dkv": timer.ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, flse, fdelta, True,
                                                               scale)),
        }
        del fo, flse, fdelta
        n = layout.shape[1]
        active = int(np.tril(np.asarray(layout)).sum())
        share = active / (H * n * (n + 1) // 2)  # of the causal blocks
        # the yardstick: SDPA with the layout expanded to a [H, T, T] bool mask
        mask = bs.layout_mask(layout, block, causal, "cuda")
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        dot = do.transpose(1, 2)
        sdpa_bwd_ms = timer.ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                           retain_graph=True))
        del out, mask, qt, kt, vt
        pairs = bs_visible_pairs(layout, block, causal) * B
        elt = q.element_size()
        bounds = bs_bounds(B, T, H, D, pairs, dt, elt)
        # fp32: the backward's bound as three TF32 passes on the tensor cores
        tf32 = bs_bounds(B, T, H, D, pairs, "tf32x3", elt) if dt == "float32" else None
        tiles = bs_visited_tiles(layout, block, causal)
        dense_bounds = {"fwd": flash_bound(B, T, T, H, D, True, dt, elt),
                        **flash_bwd_bounds(B, T, T, H, D, True, dt, elt)}
        emit({"kernel": "B9", "shape": label, "route": route, "B": B, "T": T, "H": H, "D": D,
              "block": block, "causal": causal, "dtype": dt,
              "active_blocks": int(np.asarray(layout).sum()),
              "causal_share": share, "visible_pairs": pairs,
              "visited_tiles": tiles, "visited_share": pairs / (B * tiles * 64 * 64),
              "o_err": o_err, "lse_err": lse_err, "rel_err_dq_dk_dv": rel,
              **({"fwd_bitwise_vs_ref": fwd_bitwise} if fwd_bitwise is not None else {}),
              **{f"{n}_ms": t for n, t in ms.items()}, "dq+dkv_ms": ms["dq"] + ms["dkv"],
              **{f"{n}_bound_ms": bounds[n][0] for n in ms}, "bound_by": bounds["fwd"][1],
              **({f"{n}_tf32x3_bound_ms": tf32[n][0] for n in ("fwd", "dq", "dkv")}
                 if tf32 else {}),
              **{f"dense_tc_{n}_ms": t for n, t in dense.items()},
              **{f"dense_tc_{n}_x_share_ms": t * share for n, t in dense.items()},
              **{f"dense_{n}_bound_ms": dense_bounds[n][0] for n in ms},
              "sdpa_masked_ms": sdpa_ms, "sdpa_masked_backward_ms": sdpa_bwd_ms})
        del q, k, v, qkv, do, o, lse, delta
        torch.cuda.empty_cache()
    if outputs:
        torch.save(outputs, fwd_ref)


def path_rows(torch, bs, emit):
    """Phase 10b's bf16 ZeRO-2 step at B2 x T4096, sparse and dense, then
    phase 10a's fp32 step (B2 x T1024, Fixed 128) and 10c's bf16 ZeRO-2 step
    (B2 x T1024, Fixed at blocks of 32), each one micro-step: step ms (CUDA
    events, median of steps 2-6), host issue ms, device busy of one step and
    the attention kernels' (and B9's) share of it."""
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    base = gpt.PRESETS["gpt2-125m"]
    rng = np.random.default_rng(10)
    bf16 = dict(bf16={"enabled": True}, zero_optimization={"stage": 2})
    rows = [("phase 10b sparse step, gpt2-125m B2xT4096 bf16 ZeRO-2", 4096,
             FixedSparsityConfig(**SPARSE_GPT_LAYOUT), bf16, torch.bfloat16),
            ("phase 10b dense step, gpt2-125m B2xT4096 bf16 ZeRO-2", 4096, None, bf16,
             torch.bfloat16),
            ("phase 10a step, sparse gpt2-125m B2xT1024 fp32", 1024,
             FixedSparsityConfig(**SPARSE_GPT_LAYOUT), {}, torch.float32),
            ("phase 10c step, sparse gpt2-125m blocks of 32 B2xT1024 bf16 ZeRO-2", 1024,
             FixedSparsityConfig(**SMALL_BLOCK_LAYOUT), bf16, torch.bfloat16)]
    for name, T, sc, over, dtype in rows:
        cfg = dataclasses.replace(base, max_seq_len=max(T, base.max_seq_len),
                                  sparse_attention=sc)
        batch = {"input_ids": rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)}
        engine = _engine(_train_config(2, **over), cfg)
        losses, _, step_ms, host_ms = _timed_steps(torch, engine, batch, 6)
        kernels = device_kernels(torch, lambda: engine.train_batch(batch))
        busy = sum(ms for _, _, ms in kernels)
        attn = sum(ms for kname, _, ms in kernels if "blocksparse_" in kname or "flash_" in kname)
        b9 = sum(ms for kname, _, ms in kernels if "blocksparse_" in kname)
        emit({"path": name,
              "route": _routes(bs, dtype, sc.block, 64) if sc else "dense",
              "step_ms": float(np.median(step_ms[1:])), "step_ms_all": step_ms,
              "host_issue_ms": float(np.median(host_ms[1:])), "device_busy_ms": busy,
              "attention_ms": attn, "b9_ms": b9, "b9_share_of_busy": b9 / busy if busy else None,
              "b9_kernels": [(k, n, ms) for k, n, ms in kernels if "blocksparse_" in k],
              "losses": [float(x) for x in losses]})
        del engine
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--no-paths", action="store_true")
    ap.add_argument("--fwd-ref", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("blocksparse_bench.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    assert os.path.abspath(bs.__file__).startswith(os.path.abspath(args.tree)), bs.__file__
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

    kernel_rows(torch, bs, fa, Timer(torch), emit, args.fwd_ref)
    if not args.no_paths:
        path_rows(torch, bs, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
