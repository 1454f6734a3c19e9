#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (the script exits 1 otherwise and prints no
result line):

1. build: nvcc builds every kernel under ``deepspeed_tpu_torch/csrc`` (one
   process per source, all at once; ptxas's registers and spills printed);
   TF32 is switched off for fp32 products; each tensor-core kernel (B1's
   forward, B2's dq and dk/dv: 12 instances, bf16 / fp16, D 64 / 96 / 128,
   the default and the single-cast function; their fp32 3xTF32 kernels: 3,
   D 64 / 96 / 128; B6/B7's: 8, bf16 / fp16 x int8 / int4 x 64 / 128 rows a
   block, and 4 of its fp32 kernel, int8 / int4 x 64 / 128 rows) has its
   instances and every one holds HGMMA instructions in its SASS
   (``cuobjdump -sass`` of the library), and so does each of B8's 38
   tensor-core instances (fp32 / bf16 / fp16 x 5 tilings x whole or padded
   blocks, and fp32's promoting instances: 4 tilings x whole or padded) and
   of B9's tensor-core forward (6: bf16 / fp16, D 64 / 96 / 128), dq and
   dk/dv (12 each: bf16 / fp16 x D x whole tiles or sub-block masks) and
   3xTF32 dq and dk/dv (6 each: D x whole tiles or sub-block masks); every
   3xTF32 instance also holds HMMA (``mma.sync``, its products with an
   MN-major B); B5's 36 bf16 /
   fp16 instances each hold HMMA and its 9 fp32 ones none, and so do B6/B7's
   6 decode instances (fp32 / bf16 / fp16 x int8 / int4).
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
   ``Timer``). B1 on the tensor cores (bf16 / fp16) on fused-qkv views, at
   phase 5b's B8 x T512 (the main-path row) and 10b's B2 x T4096, fp16,
   D128, non-causal, offset and ragged cases: at most 2 ulps of its dtype
   of the fp32 plain version beside a single cast of P's error (which must
   exceed it), bitwise on a re-run, kernel / plain / SDPA / bound times; B1
   in fp32 (3xTF32 on the tensor cores) at the scoring shape, the offset,
   non-causal, D128 and D96 cases: within the fp32 bars of the plain
   version and of its CPU model (``flash_attention_tf32_ref``), where one
   TF32 pass must miss them, bitwise on a re-run, with both bounds (three
   TF32 passes at the TF32 peak; one fp32 pass on the CUDA cores). stochastic_mode's
   single-cast instances of B1 and B2 against the single-cast plain
   versions (at most 2 ulps of the dtype at the largest entry, bitwise on
   at least 99% of the entries), bitwise on a re-run. The flash backward
   (three kernels: delta, dq, dk/dv; dq and
   dk/dv on the tensor cores, 3xTF32 for fp32 (held to the plain version and
   the CPU model, both bounds), each case printing its route, its launches
   and, in bf16 / fp16, its
   largest error in ulps of its dtype against the fp32 plain version, at
   most 2 over the entries of at least 1e-3 of the largest, beside the
   error of dV from a single cast of P, which must exceed it; the cases
   include phase 10b's B2 x T4096 and fp16 with small gradients) is also
   run twice on the same inputs and must give bitwise-equal gradients. B3
   (split over the cache) at Dh 64 / 96 / 128 with a length-0 row (zeros),
   a split's edge and the capacity, bitwise on a re-run, beside the earlier
   one-block-a-row kernel's time.
   B4 (dense, int8, int4 pools; split over the pages) at the
   serving shape, 16 pages, Dh 96, pages of 128 at 16 slots (3 splits of
   192: a split starts inside a page) and Dh 128 at 64 slots (one split a
   row), fp32 and bf16 (fp16 at page 128), each case's split plan printed,
   bitwise on a re-run, beside the earlier one-block-a-row kernel's time.
   B5 (dense, int8, int4 pools; split over the pages) over 126 cases
   (90 base cases: windows 2-17, pages 8-128, fp32 and bf16; 36 more at Dh96 and
   in fp16) must agree with its plain version on the committable window
   positions, be bitwise equal on a re-run, and in bf16 / fp16 lie within 2
   ulps of the dtype of the fp32 function. Both also run on block tables as
   the prefix cache leaves them, seven of 8 rows beginning with the same two
   physical pages (B4: dense and int8 pools; B5: dense, windows 2 / 5 / 17;
   fp32 and bf16), at the same tolerances and bitwise on a re-run. B1, B2, B4 and B9 also run cases
   at Dh 96. B8 (the dequant-fused
   product of the quantized wire) at the LM head's shape (x [4096, 768],
   vocabulary 50304 padded to 197 blocks of 256; fp32 x, the main path,
   and bf16 x), at phase 9d's head (x [32, 768] fp32: the 64-row tiling),
   M = 1, 37 and 63, blocks of 64 and 128 at 4096 rows (9e's head) and 256
   rows, blocks off 64-column panels (8, 48, 96 at 9d's head and at 4096
   rows, 160, 250, an effective block of 96: padded to whole panels), D off
   64-row steps (70-480), the [768, 2304] leaf, each through
   the tensor cores (``dqm_route``, checked by the counter); bitwise on a
   re-run (an odd block raises), each case's error against the float64
   product over the unrounded weights beside its plain version's (fp32
   within 1e-5 of its largest entry); at the result line's rows the plain
   version, cuBLAS fp32 (TF32 off) over the weight already dequantized, the
   dequantize + cuBLAS and the bound (three bf16 passes at the bf16 peak);
   and ptxas's report; at gpt-neox-20b's D 6144 (fp32, 256 and 32 rows,
   blocks of 256 and 96) B8 promotes its accumulators into fp32 sums every 256 rows
   of D (``dqm_promotes``): its error against the float64 product beside
   the unpromoted kernel's on the same inputs. B6/B7
   through their routes (fp32 and bf16, M 1-256, the 8 projection shapes of
   GPT-2-125M and gpt2-350m; GPT-2-125M's four at group 32, M 4 and 256,
   phase 7e's CUDA-core layout, fp32 within 1e-5 of the float64 product), then
   the decode kernel at those shapes, M 1 / 2 / 4 / 8, int8 / int4, fp32 /
   bf16 / fp16, groups 128 and 64 (the fp32 and 16-bit bars below, bitwise
   on a re-run, exact decode launches; at group 128 its time beside the
   CUDA-core kernel's on the same inputs, cuBLAS in x's dtype and the
   bound), then on the tensor cores at those shapes, M
   16-256, bf16, fp16 and fp32, groups 128 and 64: bf16 / fp16 at most 2
   ulps of the dtype of the fp32 plain version (entries of at least 1e-3 of
   the largest), fp32 within 5e-5 of the plain version's largest output and
   1e-5 of the float64 product's, bitwise on a re-run; in bf16 and fp32 at
   group 128 the tensor-core and the CUDA-core kernel timed on the same
   inputs at every M and at the crossover rows 8-64 (the speedup at M=256
   and the ratio to cuBLAS reported), with plain / cuBLAS / bound times. B9
   (blocksparse attention: forward, dq with delta, dk/dv) over 27 cases, each
   pass through its route (``bs_route``, checked by the counters: every
   pass on the tensor cores at every block, bf16 / fp16 on 16-bit operands
   and fp32 as 3xTF32): the sparse GPT-2-125M's Fixed unidirectional layout of
   128-blocks at phase 10a's B2 x T1024 fp32 (the fp32 main-path row), 10b's
   B2 x T4096 bf16 (the bf16 main-path row) and fp16, and 10c's layout of
   32-blocks at B2 x T1024 bf16 (the small-block main-path row); bench.py's
   bidirectional Fixed row at B4 x T1024 H16 under causal; BigBird with a
   layout per head at block 64 (fp32, bf16, fp16 D96); Variable,
   BSLongformer and LocalSlidingWindow at blocks 16 and 32 in every dtype
   (fp32 D128, fp16 D96, fp16 with dO 2^-8); BSLongformer not causal at
   blocks 128 (bf16) and 64 (fp16 D96); D128 not causal and D96 at
   gpt2-760m's 16 heads, fp32 and bf16; layouts with an empty block row and
   column (zeros, lse -1e30); fp16 with dO 2^-8. The tensor-core forward
   and backward lie within 2 ulps of their dtype of the fp32 plain versions
   (and, up to T 2048, of the split plain versions that model their
   rounding) where a single cast of P must miss; the 3xTF32 forward within
   5e-5 of the largest entry of the plain version and of its CPU model
   (``blocksparse_attention_fwd_tf32_ref``), lse within 1e-4, and the
   3xTF32 backward within 5e-5 of the largest gradient of the plain versions
   and of its CPU model (``blocksparse_attention_bwd_tf32_ref``); the
   forward and the backward are bitwise on a re-run; each case prints the share
   of its visited tiles' products that its layout keeps; the yardstick is
   one SDPA call with the layout expanded to a boolean [H, T, T] mask (mask
   construction excluded) and that call's backward, with B1 / B2's dense
   causal times beside it.
3. scoring path: GPT-2-125M forward + next-token loss at B4 x T512 in fp32
   (the workload of ``__graft_entry__.entry()``) through the flash kernel.
4. serving path: ``init_inference(...).generate`` on GPT-2-125M, B4, prompt
   512, 64 new greedy tokens, through the decode kernel, in fp32 (tokens
   identical to the plain path) and bf16 (throughput, greedy match rate).
5. training path: ``initialize(model=build("gpt2-125m"), ...).train_batch``
   at full width and depth. (a) fp32, B4 x T512, AdamW + clipping, 5 steps
   through the flash kernels and 5 through plain attention from the same
   state: losses and grad norms agree, and each micro-step launches the
   3xTF32 forward, delta and the 3xTF32 dq and dk/dv 12 times each and no
   other flash kernel. (b) bf16 with the fp32 master
   and ZeRO stage 2 (the verify-notes configuration), B8 x T512, 10 steps on
   one batch: the loss starts near ln(V) and falls, the tensor-core
   forward, delta and the tensor-core dq and dk/dv kernels launch 12 times
   a step and no other flash kernel; step time, tokens/s, peak memory and a
   profiler breakdown of one step with B1's and B2's device time and their
   shares of the busy time. (c) gas 2 x micro 4 and gas 1 x micro 8 over
   the same 8 rows give the same grad norm, their 3 micro-steps through
   (a)'s kernels (36 launches each). (d) (b)'s configuration with
   ``stochastic_mode``, 5 steps: the loss starts near ln(V) and falls, only
   the single-cast instances (and delta) launch, 12 times a step.
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
   B6 / B7 kernels in every projection of at most 256 rows). (a) GPT-2-125M fp32,
   ``init_inference(..., quant=...)``, B4, prompt 512, +64: tokens identical
   to a dense fp32 engine over the dequantized tree; B6's or B7's decode
   kernel launches 4 x 12 x 63 times (prefill, 2048 rows, takes the
   dequantize-then-matmul route), the other kernels never, and B3 12 x 63.
   (b) the reference's ``gpt2-350m-decode-b8-int4`` bench
   row beside int8 and dense bf16: bf16, B8, prompt 128, +64; the marginal
   per-token decode latency (generate 16 vs 64, three repetitions after
   one warm call, p50, as the reference's bench measures it), tokens/s, the block stacks' weight
   bytes, the greedy match rate against dense bf16 (reported only), exact
   decode-kernel launches, and a profile of 8 decode steps with each kind's
   device-busy time and B6/B7's share of it. (c) phase 6's serving run over
   ``quantize_for_inference(bits=8)`` and ``(bits=4)`` weights, fp32, dense
   pools: every request finishes, the audit is clean, tokens equal serving
   over the dequantized dense tree (where one differs, the first flip's
   logit gap is printed), each prefill forward of 9-256 rows launches the
   tensor-core B6/B7 48 times (the fp32 kernel), each decode step the
   decode kernel 48 times, the CUDA-core kernel never. (d)
   phase 6's serving run in bf16 over int8 and over int4 weights: every
   request finishes, the audit is clean, each prefill forward of 9-256 rows
   launches the tensor-core B6/B7 48 times, each decode step the decode
   kernel 48 times, each larger prefill neither, the CUDA-core kernel
   never; TTFT, TPOT, tokens/s, the
   greedy match against the dequantized dense tree (reported only) and a
   profile of one 128-row prefill forward with B6/B7's share. (e) a user's
   group of 32, int8 and int4, fp32, B4, prompt 64, +16: a layout neither
   tensor-core kernel takes in fp32, so every projection (prefill and
   decode) launches the CUDA-core kernel, 4 x 12 x 16 times; tokens
   identical to the dequantized dense tree.
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
   48 times a verify window (its 40 fp32 rows on the tensor cores), 48 times
   a fallback decode step on the decode kernel, never on the CUDA cores.

9. ZeRO-3 with the quantized weight wire and the quantized LM head
   (``zero_optimization: {stage: 3, zero_quantized_weights: true,
   zero_quantized_head: true}``) through ``initialize(...).train_batch`` on
   GPT-2-125M at full width and depth, one rank: every layer's leaves
   quantized and dequantized as they are gathered, the head's product
   through B8. (a) fp32, B4 x T512, AdamW + clipping, 5 steps through B8
   and 5 with B8's plain version in its place, from the same seed: losses
   and grad norms agree; B8 launches 5 times, B1/B2 12 times a micro-step. (b) bf16 with the fp32
   master, B8 x T512, 10 steps on one batch: the loss starts near ln(V) and
   falls, B8 launches 10 times on the tensor cores; step time, host
   issue time, tokens/s, peak memory and a profile of one step beside phase
   5b's ZeRO-2 step, and the wire ledger's ops and ratios. (c)
   ``comm.init_distributed`` over NCCL at world size 1 with a file store
   under ``build/``: one NCCL all-reduce, and ``qall_gather`` of a
   [768, 2304] leaf equal to quantize-then-dequantize, bitwise. (d) fp32
   at B1 x T32 (a short fine-tuning batch: 32 rows of the head), 2 steps:
   finite losses; B8 launches twice (the 64-row tiling); then the same with
   ``zero_quantize_block_size`` 96 (a block off 64-column panels, padded to
   128 columns): twice. (e)
   (b)'s configuration with ``zero_quantize_block_size`` 128, 3 steps: the
   loss starts near ln(V) and stays finite, B8 launches 3 times on the
   tensor cores (the 128-column tiles); step time beside (b)'s.

10. blocksparse attention: GPT-2-125M at full width and depth with
   ``sparse_attention=FixedSparsityConfig(num_heads=12, block=128,
   num_local_blocks=4, num_global_blocks=1, attention="unidirectional")``,
   every layer's attention through B9. (a) fp32, B2 x T1024 (GPT-2's own
   length): the scoring loss through B9 equals its plain versions' (12
   forward launches, no B1); 5 ``train_batch`` steps (AdamW + clipping)
   through B9 and 5 with its plain versions in their places, from the same
   seed and batches: losses and grad norms agree, and B9's 3xTF32
   forward, dq and dk/dv launch 60 times each, its other kernels and B1/B2
   never. (b) bf16 with the fp32 master and ZeRO stage 2, B2 x T4096
   (``max_seq_len=4096``), 10 steps on one batch: the loss starts near
   ln(V) and falls, B9's tensor-core forward, dq and dk/dv launch 120 times
   each and no other attention kernel; step time, host issue time,
   tokens/s, peak memory and a profile of one step, beside the same model
   with dense attention (B1/B2, B2's share of the busy time reported) at
   the same shape. (c) bf16 + ZeRO-2, B2 x T1024, the fixed pattern at
   blocks of 32 (16 local, the last global: the 512-token window of (a)), 3
   steps: the loss starts near ln(V) and stays finite, B9's tensor-core
   forward, dq and dk/dv (their sub-block-mask instances) launch 36 times
   each and nothing else of B9.

11. head dim 96: ``PRESETS["gpt2-760m"]`` (d 1536, 16 heads of 96) at full
   width, depth cut to 4 of 24 layers: (a) fp32 scoring B4 x T512 (B1 =
   plain attention), (b) 3 bf16 ZeRO-2 steps (B1/B2 on the tensor cores),
   (c) greedy ``generate`` = the plain path (B3), (d) paged serving =
   ``generate`` (B4), (e) n-gram speculative serving = spec-off (B5), each
   with exact launch counts.

12. checkpointing: GPT-2-125M at full width and depth, the tags under a
   ``tempfile.mkdtemp()`` directory (its free space printed first), each
   part's removed as soon as it ends. (a) bf16 + ZeRO-2, B8 x T512 (5b's
   configuration): 5 uninterrupted steps from seed 0; a second engine takes
   3, saves, and saves again under a second tag; a third, from seed 1,
   loads (the newer tag, through ``latest``) and takes steps 4-5 (B1/B2 on
   the tensor cores, 24 launches each). (b) ZeRO-3 with the quantized wire
   and head, fp32 B4 x T512 (9a's): a save at step 2, a load into a fresh
   engine, step 3 (B8 once, the 3xTF32 flash kernels 12 times). In both the
   loaded state is bitwise the saver's (``torch.equal`` on the card) and
   the resumed losses and grad norms are within rtol 1e-6 of the
   uninterrupted run's (whether bitwise is printed); the save and
   verified-load ms, the tag's bytes, GB/s and checksum are printed. (c)
   mid-accumulation at 5c's gas 2 x 4 (fp32) through ``forward`` /
   ``backward`` / ``step``: a save after the first micro-step, a load, the
   window finished: the accumulation buffer and then the params bitwise
   those of the uninterrupted window. (d) ``save_16bit_model`` after (a):
   every array of the ``.npz`` bitwise the engine's params. (e) one byte of
   one array of (a)'s newer tag flipped: ``load_checkpoint(tag=None)``
   falls back to the older committed tag and logs the rejection, and the
   newer tag by name raises ``CheckpointCorruptionError``.

13. GPT variants. (a) ``PRESETS["bloom-7b1"]`` at full width and depth
   (7.07 G params, ALiBi on every layer), random weights drawn on the card
   from a seed: fp32 ``generate`` B4, prompt 512, +64; the cached path's
   logits at every generated position (prefill, then single-token steps fed
   generate's tokens) equal the uncached ``forward``'s over the same
   sequence within 1e-4 of their largest magnitude (greedy match printed),
   and neither reaches a kernel (B3 and B1 take no bias: 0 launches); bf16
   prefill ms, decode tokens/s and a profile of 8 decode steps. (b) bloom's geometry at 2 of 30 layers,
   bf16 + ZeRO-2, B2 x T2048, 3 steps with ``loss_chunk`` 256 and with 0:
   step 1 equal in both, finite, falling, within 2e-2 of each other; the
   chunked step's ``max_memory_allocated`` below the unchunked one's by at
   least 3/4 of one fp32 [2, 2048, 250880] tensor (3.08 GB). (c) GPT-2-125M
   fp32 with ``loss_chunk`` 128 on phase 5a's batches: 5a's losses and grad
   norms (rtol 1e-5) and launches. (d) GPT-2-125M with
   ``local_attention_period`` 2, ``window_size`` 128, fp32 B4, prompt 512,
   +16: cached = uncached as in (a), no B3 or B1 launch.

14. decoding modes, GPT-2-125M B4, prompt 512, +64. fp32: ``top_k=1`` and
   ``top_p=1e-6`` (temperature 1) return phase 4's greedy tokens;
   ``temperature=1, top_k=50`` with one seed gives the same tokens twice;
   ``num_beams=4`` the plain path's beam tokens, with B3 launched 12 x 63
   times over 16 rows. bf16: greedy, sampled and beam tokens/s.

15. the serving levers on phase 6's configuration. (a) the copy-on-write
   prefix cache, fp32: phase 6a's workload with the reference bench's
   128-token system prompt ahead of every prompt, served with the cache
   off, on, on with n-gram speculation (spec_k 4) and on at pool 9: every
   cache-on run gives the cache-off tokens, shares pages (physical/logical
   below 1), ends with a clean audit, no page allocated and an empty index;
   pool 9 preempts at least one slot holding borrowed pages; B4 12 times a
   decode step, B5 12 times a verify window. (b) overload control, bf16:
   the reference's overload worker at full width (saturation calibrated by
   ``estimate_saturation_rps``, 24 requests at 2x that rate, seed 5, an SLO
   of 2 s) through a scheduler with ``max_queue`` = slots,
   ``max_queued_tokens`` = the pool's tokens and TTFT / end-to-end
   deadlines of SLO / 2 and SLO, and through one without: no controlled
   request unfinished, clean audits, B4 12 times a decode step; goodput,
   shed and deadline-miss rates and the accepted TTFT p99 of both. (c)
   dispatch-fault recovery, fp32: every decode block of 4 steps raises,
   ``dispatch_retries`` 1, ``quarantine_after`` 2: 6a's tokens, 2 failed
   episodes of 2 attempts each, the block shape of 4 quarantined, a clean
   audit. Every serving phase (6, 7c, 7d, 8, 11, 15) fails on a
   ``dispatch_error`` or ``dispatch_failed`` it did not inject, so a retry
   never hides a failed launch.

16. data parallelism and the ZeRO++ quantized gradient exchange on
   GPT-2-125M at full width and depth, from seed 0. (a) 5b's configuration
   with ``zero_quantized_gradients`` (int8, block 256), error feedback and
   the per-layer buckets, 10 steps on 5b's batch: step 1's loss equal to a
   dense ZeRO-2 step 1's (whether bitwise is printed) and its grad norm
   within 10%, the loss from near ln(V) falling, both residuals finite and
   nonzero, the wire ledger's ``qgrad_bucket_rs`` / ``qgrad_bucket_ag`` 12
   times a step and the monolithic pair once, every ratio at least 3.5, the
   tensor-core B1 / B2 exactly 120 launches each; step ms, host issue ms,
   tokens/s and peak memory beside 5b's, and a profile of one step with the
   exchange's share of the busy time (against a dense step's busy time);
   then int4, 3 steps: finite, every ratio at least 7. (b) fp16 with the
   fp32 master, a NaN residual: the step overflows and is skipped, the
   residuals read zero, the next step is finite without overflow. (c) two
   rank processes on the one card (``comm.init_distributed(backend="gloo",
   device="cuda")`` over a file store; the card's compute mode printed
   first), fp32 B4 x T512 (2 rows a rank), AdamW + clipping, 2 steps each
   at stages 0, 1, 2 and stage 2 with int8 quantized gradients and error
   feedback, against the same runs at world size 1 in this process: losses
   rtol 1e-5 and grad norms 1e-4 of world 1's, the ranks' params bitwise
   equal after every step (checksums of their bits), the final params within
   2e-5 of world 1's but for at most a millionth of the entries and none
   past 2 lr a step (AdamW's normalized update turns a last-bit difference
   of a nearly cancelling gradient entry into up to 2 lr), a rank's master
   and optimizer-state bytes at most 0.502 of world 1's at stages 1-2
   (equal at stage 0), the 3xTF32 B1 / B2 dq / dk/dv and delta 12 launches
   a micro-step on each rank; with the
   quantized exchange, step 1's loss equal to the dense dp2 step's, its
   grad norm within 10%, finite losses, each rank's residual rows nonzero,
   its ledger ratios at least 3.5; each rank's step ms (gloo: the
   collectives cross host memory, no figure for NCCL). (d) the dp2 run's
   tag after step 2 loads into a world-1 engine: every leaf bitwise the
   stored one, the residuals zero at the world-1 shape, global_steps and the
   cursor 2; step 3 finite through B1 / B2; the tag saved after it loads
   into two rank processes, each leaf bitwise the rank's slice.

17. the engine features on GPT-2-125M at full width and depth, from seed 0,
   through ``initialize``, each part's kernel path against the plain
   attention path (``use_flash=False``) from the same seed and draws
   (losses rtol 1e-4, grad norms 1e-3), launches counted exactly. (a)
   ``initialize(training_data=...)`` over 64 samples of 512 tokens, fp32
   B4 x T512, 20 steps through a ``RepeatingLoader`` (the epoch wraps) with
   the CSV and JSONL monitors and ``wall_clock_breakdown``: the batches a
   numpy replay of the sampler, the losses bitwise the same batches fed by
   hand, 12 launches of each fp32 kernel a micro-step, 20 rows of each
   ``Train/*`` event (18 of ``samples_per_sec``), ``Train/loss`` bitwise the
   metrics, the timers' two log lines. (b) 5b's configuration and batch, 3
   steps under no remat and each recomputing policy (``nothing_saveable``,
   ``save_attn_mlp_out``, ``dots_with_no_batch_dims_saveable``,
   ``dots_saveable``): losses equal to no remat's (bitwise printed), B1 24
   launches a micro-step under a policy and 12 without, each B2 kernel 12,
   peak memory in the policies' order; step ms and peak GB each. (c) the
   seqlen curriculum 128 -> 512 in steps of 128 over 3 steps, fp32, 5 steps:
   T 256, 384, 512, 512, 512, 12 launches of each kernel every step. (d)
   random-LTD in layers 1-10, keep 128 -> 512 in steps of 128 over 4 steps,
   bf16 B8 x T512, 6 steps: keep 128, 128, 256, 384, 512, 512; step 3's
   launches at T 256 in the LTD layers and 512 in the other two, 12 of each
   kernel; one forward's dropped positions bitwise through each LTD layer.
   (e) progressive layer drop (theta 0.5, gamma 0.5), bf16, 6 steps: B1 and
   each B2 kernel once per kept layer, the host draw's count; the kept
   layers per step. (f) the flops profiler at profile_step 2 on 5b's
   configuration: the kernel path's total equal to the plain path's (0.1%),
   the step ms and achieved TFLOPS beside the card's name and power limit.

18. the 1-bit optimizers, ``compression_training`` and the eigenvalue probe
   on GPT-2-125M at full width and depth, from seed 0, through
   ``initialize``. (a) 1-bit Adam, 1-bit LAMB and 0/1 Adam at dp2 (two rank
   processes on the card over gloo, as in 16c), bf16, B4 x T512, freeze_step
   2, 5 steps: the warmup steps bitwise the dense Adam / LAMB run from the
   same seed, the ranks' params bitwise equal after every step, finite
   losses, 12 launches of each bf16 kernel a micro-step, the compressed
   wire bytes a step against the fp32 ones (ratio at least 31), the
   residual rows finite and nonzero; 1-bit Adam's tag after step 4 resumes
   to step 5 bitwise, residuals included. (b) 5b's cell with MoQ bits 8 -> 4
   from step 1 (period 1) and L1 pruning to half density from step 3, 10
   steps in lockstep with the plain path (losses rtol 1e-4, grad norms
   1e-3): the bits of every step equal to the host schedule, each pruned
   weight's density 0.5 (what it keeps past the k largest only ties at the
   threshold, which bf16 values often are), exact launches;
   step ms with and without compression. (c) the probe on the kernels (bf16,
   B2 x T512): disabled with the log line after one forward, training goes
   on, exact launches; on the plain path (fp32, all 12 layers): the
   curvature finite in [0, 1] with a maximum of 1, the MoQ onsets stretched
   per layer and the transform gated by them, the probe's time a layer; one
   layer's HVP at full width and depth 2 in fp64 within 1e-3 of the
   central difference of two gradients.
19. resilience and elasticity on GPT-2-125M at full width and depth, from
   seeds, the tags in a temporary directory. (a) 5b's cell
   armed: ``resilience`` with the sentinel (an anchor every 2 steps), the
   watchdog, integrity (4 blocks of 1 MiB stamped after every step and
   verified before the next, a spot check every 2 steps) and the chaos plan
   ``RES_CHAOS``: the NaN at data cursor 5 rolls back to global_step4 and
   skips cursors 4-5, the bit flipped in the master domain at cursor 8 is
   named and rolled back to global_step6 before the step; the recovery-event
   trail equal to ``RES_TRAIL``; every spot check bitwise; the steps after
   the rejoin and the final state bitwise a clean run's from global_step4;
   B1 / B2 12 launches a forward / backward, spot checks included; the
   in-memory anchor restored bitwise; the armed step's ms beside the
   unarmed one's, and the scan's MiB and ms a step. (b) children of this
   script (``--phase19-child``), fp32 B4 x T512: a SIGTERM after step 3
   drains to an emergency tag and exit 83, the relaunch finishes bitwise the
   uninterrupted run; a SIGKILL at the second save's pre-commit leaves a
   torn tag that is rejected, and the resume from the previous tag is
   bitwise too. (c) beside (b), ``DSElasticAgent`` over two gloo ranks
   sharing the card (``--phase19-elastic``), fp32, the elastic batch of 4:
   rank 1 lost at cursor 2 (``lose_worker_at_step``), the agent relaunches
   at world 1 from global_step2 (resharded; a membership change, no
   restart), every step's loss within 1e-5 and grad norm within 1e-4 of an
   uninterrupted world-1 run's; a preempted exit spends no restart budget.
   (d) 15a's cell with n-gram speculation, page fingerprints (a scan of 2
   pages a step) and the serving watchdog (0.5 s deadlines): a bit flipped
   in a shared KV page, an allocation failure at the first admission claim
   that borrows prefix pages, and a 1.5 s dispatch stall; the tokens equal
   the cache-off run's, the flip detected and healed, the failed claim
   unwound (every refcount as before, the audit clean) with its request
   queued and finished later, the stall flagged, B4 12 a decode step and
   B5 12 a window; the same run without faults detects nothing. Each of
   (c)'s rank 0s leads a process group, recorded in the phase's directory:
   the phase stops those groups and no other process. (b)'s resumes and
   (c)'s world-1 run train while phase 20 runs; their checks close phase 19
   after it (``phase_resilience_join``).

20. ZeRO-Offload and ZeRO-Infinity on GPT-2-125M at full width and depth,
   from seed 0, the tags and NVMe stores in a temporary directory. (a)
   ``offload_optimizer`` cpu (the legacy ``cpu_offload`` key), fp32 B4 x
   T512, 3 steps against the in-device AdamW run from the same weights:
   losses rtol 2e-4, host masters rtol 1e-3 / atol 2e-5, exact launches;
   step ms, host-step ms, peak memory beside the in-device run's; NVMe
   optimizer state with the ``aio`` block, a step bitwise the RAM run's.
   (b) ``offload_param`` cpu, bf16, 5b's batch, 3 steps at
   prefetch depths 0, 1, 2: losses, grad norms and every host master bitwise
   equal across depths, step 1 within 0.5 of ln V, the loss falling, B1 24
   launches a step (each layer's forward and its recompute) and each B2
   kernel 12; peak memory, the host-DMA row. (c) the drained gradients
   bitwise synchronous copies, the bf16 push buffers bitwise the masters'
   casts. (d) the int8 quantized fetch within rel 0.05, wire ratio >= 1.9.
   (e) + (f) a save at step 2 (host shards under the manifest) resumed by an
   engine with NVMe masters, step 3 bitwise the RAM run's; an injected
   fetch stall named ``offload_fetch`` by the watchdog. Phase 1 also builds
   the host C++ (``csrc/host``: the SIMD Adam and the I/O pool) with the
   host compiler.

``--only phase_a,phase_b`` runs those phases alone and prints no result line
(a partial run). A phase that reads an earlier phase's results needs that
phase in the list (phase 20 reads 5b's batch and peak, and phase 5 the kernel
phase's results: ``--only phase_build,phase_kernels,phase_training,phase_offload``).

Each main path runs with every kernel's launch count set to 0 just before it
and read just after: each path's exact launch counts name the route (fp32
paths the 3xTF32 flash kernels only, bf16 paths the 16-bit tensor-core ones
only, delta on both; B9's by route). The last lines are the card's name and power limit
(nvidia-smi), a ``{"kernels": [...]}`` line (35 kernels) and the ``{"ok": true, ...}`` line.
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

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit); "tf32x3" is
# an fp32 product as three TF32 passes at the TF32 peak (the fp32 flash
# kernels), "float32" one fp32 pass on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12, "tf32x3": 495e12 / 3}
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

FLASH_TF32_SRC = "deepspeed_tpu_torch/csrc/flash_attention_fwd_tf32.cu"
FLASH_TC_SRC = "deepspeed_tpu_torch/csrc/flash_attention_fwd_tc.cu"
FLASH_BWD_SRC = "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu"  # delta
FLASH_BWD_TF32_SRC = "deepspeed_tpu_torch/csrc/flash_attention_bwd_tf32.cu"
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
# the dq and dk/dv kernels by route: 3xTF32 for fp32, the 16-bit tensor-core
# kernels for bf16 / fp16 (delta is one CUDA-core kernel in every dtype)
BWD_TF32_KERNELS = ("dq_tf32", "dkv_tf32")
BWD_TC_KERNELS = ("dq_tc", "dkv_tc")
# the backward kernels each dtype's main path launches, and stochastic_mode's
BWD_PATH = {"float32": ("delta", *BWD_TF32_KERNELS), "bfloat16": ("delta", *BWD_TC_KERNELS),
            "stochastic": ("delta", "dq_tc_stochastic", "dkv_tc_stochastic")}
# the forward kernel each path launches: the 3xTF32 kernel for fp32, the
# tensor-core one for bf16 / fp16 (its single-cast instance in stochastic_mode)
FWD_PATH = {"float32": ("fwd_tf32",), "bfloat16": ("fwd_tc",),
            "stochastic": ("fwd_tc_stochastic",)}
# each tensor-core library, its kernels whose every instance must hold wgmma
# (HGMMA in SASS), and each kernel's instances
# (flash: bf16 / fp16 x D 64 / 96 / 128 x the default and the single-cast
# (stochastic_mode) function; flash 3xTF32: D 64 / 96 / 128; B6/B7: bf16 /
# fp16 x int8 / int4 x 64 / 128 rows a block, and fp32 x int8 / int4 x 64 /
# 128 rows a block; B8: fp32 / bf16 / fp16 x x 5 tilings (128 rows x 256 /
# 128 / 64 columns, 64 rows x 256 / 128 columns) x blocks of whole 64-column
# panels or padded to them, and fp32's promoting instances (every tiling but
# 128 x 256, whole or padded); B9's forward, dq and dk/dv: bf16 / fp16 x D
# 64 / 96 / 128 x whole tiles (blocks 64 / 128) or sub-block masks (16 /
# 32), and 3xTF32: D x whole tiles or masks)
TC_KERNELS = {"flash_attention_fwd_tc": (("flash_fwd_tc_kernel", 12),),
              "flash_attention_bwd_tc": (("flash_bwd_dq_tc_kernel", 12),
                                         ("flash_bwd_dkv_tc_kernel", 12)),
              "flash_attention_fwd_tf32": (("flash_fwd_tf32_kernel", 3),),
              "flash_attention_bwd_tf32": (("flash_bwd_dq_tf32_kernel", 3),
                                           ("flash_bwd_dkv_tf32_kernel", 3)),
              "int8_matmul_tc": (("qmatmul_tc_kernel", 8), ("qmatmul_tc_f32_kernel", 4)),
              "dequant_matmul_tc": (("dequant_matmul_tc_kernel", 38),),
              "blocksparse_attention_fwd_tc": (("blocksparse_fwd_tc_kernel", 12),),
              "blocksparse_attention_fwd_tf32": (("blocksparse_fwd_tf32_kernel", 6),),
              "blocksparse_attention_bwd_tc": (("blocksparse_bwd_dq_tc_kernel", 12),
                                               ("blocksparse_bwd_dkv_tc_kernel", 12)),
              "blocksparse_attention_bwd_tf32": (("blocksparse_bwd_dq_tf32_kernel", 6),
                                                 ("blocksparse_bwd_dkv_tf32_kernel", 6))}
# B5's mma.sync instances: bf16 / fp16 x D 64 / 96 / 128 x dense / int8 /
# int4 x one or two 16-row m tiles hold HMMA; fp32's 9 (CUDA cores) none. An
# instance's mangled name starts its template arguments with its type
# (If: float)
VERIFY_KERNEL = "verify_split_kernel"
# the 3xTF32 kernels' products whose B is MN-major (P V, dS k, P^T dO, dS^T
# q) run on mma.sync: HMMA in every instance beside the HGMMA above
TF32_MMA_LIBS = ("flash_attention_fwd_tf32", "flash_attention_bwd_tf32",
                 "blocksparse_attention_fwd_tf32", "blocksparse_attention_bwd_tf32")
VERIFY_MMA_INSTANCES = 36
VERIFY_FP32_INSTANCES = 9
# the times of the earlier one-block-per-row B3 and B5 at the main-path rows
# (PERF.md kernel table), printed beside the split kernels' for comparison
OLD_MS = {"decode bfloat16": 0.0504, "verify dense bfloat16": 0.0944,
          "verify dense float32": 0.0989}
# the one-block-a-row B4 (PERF.md kernel table), by (pool, dtype, Dh, pages
# a row)
OLD_PAGED_MS = {("dense", "float32", 64, 8): 0.0469, ("kv8", "float32", 64, 8): 0.0404,
                ("kv4", "float32", 64, 8): 0.0318, ("dense", "bfloat16", 64, 8): 0.0408,
                ("kv8", "bfloat16", 64, 8): 0.0399, ("kv4", "bfloat16", 64, 8): 0.0318,
                ("dense", "bfloat16", 64, 16): 0.0799,
                ("dense", "float32", 96, 8): 0.0572, ("kv8", "float32", 96, 8): 0.0406,
                ("kv4", "float32", 96, 8): 0.0549, ("dense", "bfloat16", 96, 8): 0.0404,
                ("kv8", "bfloat16", 96, 8): 0.0404, ("kv4", "bfloat16", 96, 8): 0.0555}
# stochastic_mode's kernels against their single-cast plain versions: a
# term whose two fp32 values straddle a rounding boundary of the dtype
# rounds apart, so at most 2 ulps of the dtype at the largest entry and
# bitwise on at least 95% of the entries (fp16's 11-bit P flips more often
# than bf16's 8-bit one: 98.1-98.8% against 99.8-99.9%; the default
# function against the single cast is bitwise on about 65% in bf16)
SINGLE_MAX_ULP = 2
SINGLE_EQUAL = 0.95
QMM_SRC = "deepspeed_tpu_torch/csrc/int8_matmul.cu"
QMM_TC_SRC = "deepspeed_tpu_torch/csrc/int8_matmul_tc.cu"
QMM_DEC_SRC = "deepspeed_tpu_torch/csrc/int8_matmul_decode.cu"
# the quantized-weight launch counters, by kernel: CUDA cores, tensor cores
# (9-256 rows), the decode kernel (1-8 rows)
QMM_COUNTERS = {"int8": "int8_launches", "int4": "int4_launches",
                "int8_tc": "int8_tc_launches", "int4_tc": "int4_tc_launches",
                "int8_dec": "int8_dec_launches", "int4_dec": "int4_dec_launches"}
# each route's counter key (bits filled in)
QMM_ROUTE_KEY = {"cuda_cores": "int{bits}", "tensor_cores": "int{bits}_tc",
                 "decode": "int{bits}_dec"}
# the decode kernel's mma.sync instances (fp32 / bf16 / fp16 x int8 / int4),
# each must hold HMMA
QMM_DEC_KERNEL = "qmatmul_decode_kernel"
QMM_DEC_INSTANCES = 6
QMM_TPU = {"int8": "deepspeed_tpu/ops/pallas/int8_matmul.py:42",
           "int4": "deepspeed_tpu/ops/pallas/int8_matmul.py:145"}
QUANT_GROUP = 128
DQM_TC_SRC = "deepspeed_tpu_torch/csrc/dequant_matmul_tc.cu"
DQM_TPU = "deepspeed_tpu/ops/pallas/dequant_matmul.py:41"  # _kernel, call :86
BS_FWD_TF32_SRC = "deepspeed_tpu_torch/csrc/blocksparse_attention_fwd_tf32.cu"
BS_FWD_TC_SRC = "deepspeed_tpu_torch/csrc/blocksparse_attention_fwd_tc.cu"
BS_BWD_TC_SRC = "deepspeed_tpu_torch/csrc/blocksparse_attention_bwd_tc.cu"
BS_BWD_TF32_SRC = "deepspeed_tpu_torch/csrc/blocksparse_attention_bwd_tf32.cu"
# B9: _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel (calls :186, :215, :239)
BS_TPU = {"fwd": "deepspeed_tpu/ops/pallas/blocksparse_attention.py:68",
          "dq": "deepspeed_tpu/ops/pallas/blocksparse_attention.py:102",
          "dkv": "deepspeed_tpu/ops/pallas/blocksparse_attention.py:133"}
BS_KERNELS = ("fwd", "dq", "dkv")
# B9's launch counters by kernel and route (ops/cuda/blocksparse_attention.py
# bs_route): every pass on the tensor cores at every block, bf16 / fp16
# ("tc") and fp32 as 3xTF32 ("tf32")
BS_COUNTERS = {"fwd_tc": "fwd_tc_launches", "fwd_tf32": "fwd_tf32_launches",
               "dq_tc": "bwd_dq_tc_launches", "dkv_tc": "bwd_dkv_tc_launches",
               "dq_tf32": "bwd_dq_tf32_launches", "dkv_tf32": "bwd_dkv_tf32_launches"}
# the B9 kernels each main path launches: 10a's fp32 and 10b's bf16 training
BS_PATH = {"float32": ("fwd_tf32", "dq_tf32", "dkv_tf32"),
           "bfloat16": ("fwd_tc", "dq_tc", "dkv_tc")}
# the sparse GPT-2-125M's layout (phases 2 and 10): Sparse Transformers'
# fixed pattern, 4 local blocks of 128 and the last one of each window global
SPARSE_GPT_LAYOUT = dict(num_heads=12, block=128, num_local_blocks=4, num_global_blocks=1,
                         attention="unidirectional")
# phase 10c's: the same 512-token window at blocks of 32 (sub-block masks in
# the backward's 64-token tiles)
SMALL_BLOCK_LAYOUT = {**SPARSE_GPT_LAYOUT, "block": 32, "num_local_blocks": 16}
# B6/B7 against their plain versions, relative to the largest output entry:
# fp32 -- both accumulate in fp32 in another order; bf16 -- both round once
QMM_RTOL = {"float32": 5e-5, "bfloat16": 2e-2, "float16": 2e-2}
# an fp32 route of B6/B7/B8 against the float64 product over the unrounded
# weights, relative to its largest entry: both are fp32-accurate products
# (the tensor-core kernels' fp32 accumulators truncate: ~4e-6 at D 768)
DQM_FP64_RTOL = 1e-5


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

    def flush(self):
        """Evict the L2 cache by writing 128 MB (the lines it leaves are dirty)."""
        self.flush_buf.zero_()

    def ms(self, fn, iters: int = 15, warmup: int = 3, device_only: bool = True) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(iters):
            self.flush()
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


# the host's wait between starting a trace and the call it traces: on a
# loaded host, traces of calls made at once have lost the calls' first
# device records (at a 50 ms lead still, in 7d's int8 trace on a host whose
# 5b step was 79 ms; at 0.25 s in all 6 tries on one whose 5b step was 74
# ms, so complete_trace doubles the lead on each retry)
PROFILER_LEAD_S = 0.25


def device_kernels(torch, fn, lead_s: float = PROFILER_LEAD_S):
    """The CUDA kernels of one call of ``fn`` from a torch.profiler trace, as
    [(name, count, self device ms)], largest first. The call starts
    ``lead_s`` after the trace, the device idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(lead_s)
        fn()
        torch.cuda.synchronize()
    # device-side rows only: a CPU op's row carries its kernels' time as well
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: r[2], reverse=True)


# traces taken at most for one complete record of a call (complete_trace)
TRACE_TRIES = 6


def complete_trace(torch, fn, name: str, counter, tries: int = TRACE_TRIES):
    """A trace of one call of ``fn`` (``device_kernels``) that holds a record
    for every launch ``counter()`` counted in that call of the kernels whose
    name holds ``name``: taken again, up to ``tries`` times, while records
    are missing (a trace has been seen to drop one of 48, on a loaded host in
    three traces running). Each try doubles the lead before the call (0.25 s
    to 8 s), since the records a short trace lacks are the call's first ones.
    Returns (kernels, launches, records) of the last trace taken."""
    for k in range(tries):
        before = counter()
        kernels = device_kernels(torch, fn, PROFILER_LEAD_S * 2 ** k)
        launches = counter() - before
        records = sum(r[1] for r in kernels if name in r[0])
        if records == launches:
            break
    return kernels, launches, records


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
    import threading

    t0 = time.perf_counter()
    host = {}  # the host C++ of ZeRO-Offload (phase 20), beside nvcc

    def build_host():
        try:
            for name in ("cpu_adam", "aio"):
                _build.load_host(name)
            host["s"] = time.perf_counter() - t0
        except Exception as e:  # raised below, in this thread
            host["error"] = e

    th = threading.Thread(target=build_host)
    th.start()
    _build.build_all()
    log(f"phase1 build: {len(_build.sources())} kernel sources in "
        f"{time.perf_counter() - t0:.2f} s")
    th.join()
    if "error" in host:
        raise host["error"]
    log(f"phase1 host build: cpu_adam and aio in {host['s']:.2f} s with "
        f"{' '.join(_build.host_flags())} (cpu_adam SIMD level "
        f"{_build.load_host('cpu_adam').ds_cpu_ops_simd()})")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase1 ptxas {name}: {line.strip()}")
    t0 = time.perf_counter()
    sass = sass_texts(_build, sorted({*TC_KERNELS, "paged_verify_attention",
                                      "int8_matmul_decode"}))
    log(f"phase1 sass: {len(sass)} libraries disassembled in {time.perf_counter() - t0:.2f} s")
    for lib, kernels in TC_KERNELS.items():
        counts = sass_tensor_ops(sass[lib])
        for kernel, instances in kernels:
            per_instance = sorted(c for fn, c in counts.items() if kernel in fn)
            log(f"phase1 sass {lib} {kernel}: {len(per_instance)} instances, "
                f"HGMMA per instance {per_instance}")
            check(len(per_instance) == instances and min(per_instance) > 0,
                  f"{kernel} in {lib}: {len(per_instance)} instances, expected {instances}, "
                  f"each with wgmma ({per_instance})")
    for lib in TF32_MMA_LIBS:
        counts = sass_tensor_ops(sass[lib], op="HMMA")
        for kernel, instances in TC_KERNELS[lib]:
            per_instance = sorted(c for fn, c in counts.items() if kernel in fn)
            log(f"phase1 sass {lib} {kernel}: HMMA (mma.sync) per instance {per_instance}")
            check(len(per_instance) == instances and min(per_instance) > 0,
                  f"{kernel} in {lib}: {len(per_instance)} instances, expected {instances}, "
                  f"each with mma.sync ({per_instance})")
    counts = sass_tensor_ops(sass["paged_verify_attention"], op="HMMA")
    fp32 = sorted(c for fn, c in counts.items() if VERIFY_KERNEL + "If" in fn)
    mma = sorted(c for fn, c in counts.items() if VERIFY_KERNEL in fn
                 and VERIFY_KERNEL + "If" not in fn)
    log(f"phase1 sass paged_verify_attention {VERIFY_KERNEL}: {len(mma)} bf16/fp16 instances, "
        f"HMMA per instance {mma}; {len(fp32)} fp32 instances, HMMA {fp32}")
    check(len(mma) == VERIFY_MMA_INSTANCES and min(mma) > 0,
          f"B5's bf16/fp16 instances: {len(mma)}, expected {VERIFY_MMA_INSTANCES}, each with "
          f"HMMA ({mma})")
    check(len(fp32) == VERIFY_FP32_INSTANCES and max(fp32) == 0,
          f"B5's fp32 instances: {len(fp32)}, expected {VERIFY_FP32_INSTANCES}, none with "
          f"HMMA ({fp32})")
    counts = sass_tensor_ops(sass["int8_matmul_decode"], op="HMMA")
    dec = sorted(c for fn, c in counts.items() if QMM_DEC_KERNEL in fn)
    log(f"phase1 sass int8_matmul_decode {QMM_DEC_KERNEL}: {len(dec)} instances, HMMA per "
        f"instance {dec}")
    check(len(dec) == QMM_DEC_INSTANCES and min(dec) > 0,
          f"B6/B7's decode instances: {len(dec)}, expected {QMM_DEC_INSTANCES}, each with "
          f"HMMA ({dec})")


def sass_texts(_build, libs) -> dict:
    """Each built library's SASS: one ``cuobjdump`` a library, all started
    together."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"

    def dump(lib):
        return subprocess.run([str(cuobjdump), "-sass", str(_build._target(lib))],
                              capture_output=True, text=True, timeout=300, check=True).stdout

    with ThreadPoolExecutor(len(libs)) as pool:
        return dict(zip(libs, pool.map(dump, libs)))


def sass_tensor_ops(sass: str, op: str = "HGMMA") -> dict:
    """``op`` instructions (HGMMA: wgmma; HMMA: mma.sync) in each function
    of a library's SASS."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and op in line:
            counts[fn] += 1
    return counts


def phase_kernels(torch, ctx):
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    timer = ctx["timer"]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # B1 forward in fp32 on the tensor cores (3xTF32) on fused-qkv views: the
    # scoring shape (the main-path row), the bottom-right causal case,
    # non-causal, head dim 128, and head dim 96 at gpt2-760m's 16 heads;
    # against the plain fp32 version (the fp32 bars) and the CPU model of its
    # arithmetic, bitwise on a re-run, with both bounds (three TF32 passes at
    # the TF32 peak, one fp32 pass on the CUDA cores)
    flash_cases = [(4, 512, 512, 12, 64, True), (4, 128, 512, 12, 64, True),
                   (4, 256, 256, 12, 64, False), (4, 512, 512, 12, 128, True),
                   (4, 512, 512, 16, 96, True)]
    flash_err = 0.0
    for i, (B, T, S, H, D, causal) in enumerate(flash_cases):
        dt = "float32"
        q, k, v = _fused_qkv(randn, B, T, S, H, D, torch.float32)
        before = _fwd_launches(fa)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        again, lse_again = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        counted = {n: c - before[n] for n, c in _fwd_launches(fa).items()}
        bitwise = torch.equal(o, again) and torch.equal(lse, lse_again)
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        o_model, lse_model = fa.flash_attention_tf32_ref(q, k, v, causal)
        model_err = (o - o_model).abs().max().item()
        model_lse_err = (lse - lse_model).abs().max().item()
        one_pass_err = (fa.flash_attention_tf32_ref(q, k, v, causal, passes=1)[0]
                        - o_ref).abs().max().item()
        flash_err = max(flash_err, err)
        del again, o_model
        kernel_ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
        plain_ms = timer.ms(lambda: fa.flash_attention_ref(q, k, v, causal=causal))
        library_ms = timer.ms(_sdpa_forward(torch, q, k, v, causal))
        bound_ms, bound_by = flash_bound(B, T, S, H, D, causal, "tf32x3", q.element_size())
        cc_ms, cc_by = flash_bound(B, T, S, H, D, causal, dt, q.element_size())
        log(f"phase2 flash_attention_fwd B{B} T{T} S{S} H{H} D{D} causal={causal} {dt} "
            f"route=tf32: max_abs_err={err:.3e} lse_err={lse_err:.3e} "
            f"tf32_model_err={model_err:.3e} tf32_model_lse_err={model_lse_err:.3e} "
            f"one_pass_model_err={one_pass_err:.3e} bitwise_rerun={bitwise} "
            f"launches={counted} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, 3xTF32) "
            f"cuda_core_bound_ms={cc_ms:.4f} ({cc_by}) kernel/sdpa={kernel_ms / library_ms:.3f} "
            f"kernel/bound={kernel_ms / bound_ms:.2f}")
        check(err <= ATOL[dt], f"flash {flash_cases[i]}: max_abs_err {err} > {ATOL[dt]}")
        check(lse_err <= LSE_ATOL, f"flash {flash_cases[i]}: lse error {lse_err}")
        check(model_err <= ATOL[dt] and model_lse_err <= LSE_ATOL,
              f"flash {flash_cases[i]}: {model_err} / {model_lse_err} from the 3xTF32 model")
        check(one_pass_err > ATOL[dt], f"flash {flash_cases[i]}: one TF32 pass is within "
              f"{one_pass_err}, the check cannot tell it from 3xTF32")
        check(bitwise, f"flash {flash_cases[i]}: two runs differ")
        check(counted == path_launches(counted, 2, FWD_PATH["float32"]),
              f"flash {flash_cases[i]}: launches {counted}")
        if i == 0:
            ctx["flash"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    ctx["flash"]["max_abs_err"] = flash_err
    phase_kernels_flash_tc(torch, ctx, randn)

    phase_kernels_decode(torch, ctx, randn)
    phase_kernels_bwd(torch, ctx, randn)
    phase_kernels_paged(torch, ctx)
    phase_kernels_verify(torch, ctx)
    phase_kernels_qmatmul(torch, ctx)
    phase_kernels_dequant(torch, ctx)
    phase_kernels_blocksparse(torch, ctx, randn)


def phase_kernels_decode(torch, ctx, randn):
    """B3, split over the cache (``split_plan``: 5 splits of 128 at S 640 and
    B4), against its plain version at GPT-2-125M's decode shapes (H12, cache
    640 = 512 + 64 padded to 128) with Dh 64, 96 and 128: per-row lengths
    {0, 1, 77, 128, 129, 513, 639, 640} at B8 (0 must give zeros; a split's
    edge; a length inside the last split; the capacity) in fp32 / bf16 / fp16,
    the earlier row {1, 77, 513, 640}, and the serving path's mid-run length 544
    for every row in bf16 (the main-path row); bitwise on a re-run; kernel /
    plain / SDPA / bound times, beside the earlier one-block-a-row kernel's."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    timer = ctx["timer"]
    H, S = 12, 640
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edge = [0, 1, 77, 128, 129, 513, 639, 640]
    cases = [(8, edge, "float32", 64), (8, edge, "bfloat16", 64), (8, edge, "float16", 64),
             (8, edge, "float32", 96), (8, edge, "bfloat16", 96), (8, edge, "bfloat16", 128),
             (4, [1, 77, 513, 640], "float32", 64), (4, [1, 77, 513, 640], "bfloat16", 64),
             (4, [544] * 4, "bfloat16", 64), (4, [544] * 4, "bfloat16", 96),
             (4, [544] * 4, "float32", 96)]
    decode_err = 0.0
    for B, lens_list, dt, Dh in cases:
        dtype = getattr(torch, dt)
        q = randn((B, 1, H, Dh), dtype)
        k, v = randn((B, H, S, Dh), dtype), randn((B, H, S, Dh), dtype)
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        before = da.launches
        out, again = da.decode_attention(q, k, v, lens), da.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        launched = da.launches - before
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
        main = (B, lens_list, dt, Dh) == (4, [544] * 4, "bfloat16", 64)
        log(f"phase2 decode_attention B{B} H{H} S{S} Dh{Dh} lengths={lens_list} {dt} "
            f"splits={da.split_plan(B * H, S, sms)}: "
            f"max_abs_err={err:.3e} bitwise_rerun={torch.equal(out, again)} launches={launched} "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({bound_by}) kernel/sdpa={kernel_ms / library_ms:.3f}"
            + (f" one_block_a_row_ms={OLD_MS['decode bfloat16']}" if main else ""))
        check(err <= ATOL[dt], f"decode {B} {lens_list} {dt} Dh{Dh}: max_abs_err {err}")
        check(torch.equal(out, again), f"decode {lens_list} {dt} Dh{Dh}: two runs differ")
        check(launched == 2, f"decode {lens_list} {dt} Dh{Dh}: {launched} launches")
        if 0 in lens_list:
            check(torch.count_nonzero(out[lens_list.index(0)]).item() == 0,
                  f"decode {dt} Dh{Dh}: the length-0 row is not zero")
        if main:
            ctx["decode"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                 bound_ms=bound_ms, bound_by=bound_by)
    ctx["decode"]["max_abs_err"] = decode_err


def _sdpa_forward(torch, q, k, v, causal):
    """The yardstick of B1: one scaled_dot_product_attention call at the same
    shape (SDPA's is_causal aligns top-left, so T != S passes the
    bottom-right mask)."""
    import torch.nn.functional as F

    T, S = q.shape[1], k.shape[1]
    mask = None
    if causal and T != S:
        mask = (torch.arange(S, device="cuda")[None, :]
                <= torch.arange(T, device="cuda")[:, None] + (S - T))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=causal and mask is None)


def _fused_qkv(randn, B, T, S, H, D, dtype):
    """q [B, T, H, D] and k, v [B, S, H, D] as strided views of one fused
    [B, S, 3HD] buffer, as the model's qkv projection gives them (q its last
    T rows)."""
    qkv = randn((B, S, 3 * H * D), dtype)
    k = qkv[..., H * D:2 * H * D].reshape(B, S, H, D)
    v = qkv[..., 2 * H * D:].reshape(B, S, H, D)
    return qkv[:, S - T:, :H * D].reshape(B, T, H, D), k, v


def phase_kernels_flash_tc(torch, ctx, randn):
    """B1 on the tensor cores (bf16 / fp16, route ``tc``) against the fp32
    plain version in ulps of the dtype (at most 2, entries of at least 1e-3
    of the largest) beside a single cast of P's error (which must exceed
    2), against its own rounding (``flash_attention_split_ref``), bitwise on
    a re-run, with kernel / plain (the split version) / SDPA / bound times.
    q/k/v are views of one fused buffer. Cases: phase 5b's B8 x T512 (bf16:
    the main-path row; fp16), the bottom-right offset T128 S512, non-causal,
    D128 (bf16, fp16), a ragged T100 S200, phase 10b's B2 x T4096 (bf16,
    fp16), and D96 (gpt2-760m's: bf16, fp16, ragged). Then stochastic_mode's
    single-cast instances of B1 and of B2's tensor-core dq and dk/dv against
    the single-cast plain versions."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    timer = ctx["timer"]
    cases = [(8, 512, 512, 12, 64, True, "bfloat16"), (8, 512, 512, 12, 64, True, "float16"),
             (4, 128, 512, 12, 64, True, "bfloat16"), (4, 256, 256, 12, 64, False, "bfloat16"),
             (4, 512, 512, 12, 128, True, "bfloat16"), (4, 512, 512, 12, 128, True, "float16"),
             (2, 100, 200, 12, 64, True, "bfloat16"),
             (2, 4096, 4096, 12, 64, True, "bfloat16"), (2, 4096, 4096, 12, 64, True, "float16"),
             # head dim 96 (gpt2-760m's H16): the padded second panel
             (4, 512, 512, 16, 96, True, "bfloat16"), (4, 512, 512, 16, 96, True, "float16"),
             (2, 100, 200, 16, 96, True, "bfloat16")]
    err_max = 0.0
    for i, (B, T, S, H, D, causal, dt) in enumerate(cases):
        dtype = getattr(torch, dt)
        q, k, v = _fused_qkv(randn, B, T, S, H, D, dtype)
        before = _fwd_launches(fa)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        again, lse_again = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        counted = {n: c - before[n] for n, c in _fwd_launches(fa).items()}
        bitwise = torch.equal(o, again) and torch.equal(lse, lse_again)
        ref, lse_ref = fa.flash_attention_ref(q, k, v, causal)
        ulps = ulp_err(torch, o, ref, dtype)
        split_ulps = ulp_err(torch, o, fa.flash_attention_split_ref(q, k, v, causal)[0], dtype)
        cast_ulps = ulp_err(torch, fa.flash_attention_ref(q, k, v, causal, stochastic=True)[0],
                            ref, dtype)
        err = (o.float() - ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        err_max = max(err_max, err)
        del ref, again
        kernel_ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
        plain_ms = timer.ms(lambda: fa.flash_attention_split_ref(q, k, v, causal))
        library_ms = timer.ms(_sdpa_forward(torch, q, k, v, causal))
        bound_ms, bound_by = flash_bound(B, T, S, H, D, causal, dt, q.element_size())
        tag = f"B{B} T{T} S{S} H{H} D{D} causal={causal} {dt}"
        log(f"phase2 flash_attention_fwd {tag} route=tc: max_ulp_err={ulps:.2f} "
            f"split_ref_ulp_err={split_ulps:.2f} single_cast_p_ulp_err={cast_ulps:.2f} "
            f"max_abs_err={err:.3e} lse_err={lse_err:.3e} bitwise_rerun={bitwise} "
            f"launches={counted} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
            f"kernel/sdpa={kernel_ms / library_ms:.3f} kernel/bound={kernel_ms / bound_ms:.2f}")
        check(bitwise, f"flash tc {tag}: two runs differ")
        check(counted == path_launches(counted, 2, FWD_PATH["bfloat16"]),
              f"flash tc {tag}: launches {counted}")
        check(ulps <= BWD_MAX_ULP and split_ulps <= BWD_MAX_ULP,
              f"flash tc {tag}: {ulps} / {split_ulps} {dt} ulps")
        check(cast_ulps > BWD_MAX_ULP, f"flash tc {tag}: a single cast of P is within "
              f"{cast_ulps} ulps, the ulp check cannot tell it from the hi/lo split")
        check(lse_err <= LSE_ATOL, f"flash tc {tag}: lse error {lse_err}")
        if i == 0:
            ctx["flash_tc"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    ctx["flash_tc"]["max_abs_err"] = err_max

    # stochastic_mode: B1's and B2's single-cast instances against the
    # single-cast plain versions (the backward from the kernel's own lse)
    for B, T, S, H, D, causal, dt in [(8, 512, 512, 12, 64, True, "bfloat16"),
                                      (4, 256, 256, 12, 128, False, "float16"),
                                      (2, 100, 200, 12, 64, True, "bfloat16"),
                                      (4, 256, 256, 16, 96, True, "bfloat16")]:
        dtype = getattr(torch, dt)
        q, k, v = _fused_qkv(randn, B, T, S, H, D, dtype)
        do = randn((B, T, H, D), dtype)
        before = {**_fwd_launches(fa), **_bwd_launches(fa)}
        o, lse = fa.flash_attention_fwd(q, k, v, causal, stochastic=True)
        o2, _ = fa.flash_attention_fwd(q, k, v, causal, stochastic=True)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, stochastic=True)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, stochastic=True)
        torch.cuda.synchronize()
        counted = {n: c - before[n] for n, c in {**_fwd_launches(fa), **_bwd_launches(fa)}.items()}
        bitwise = torch.equal(o, o2) and all(torch.equal(a, b) for a, b in zip(grads, again))
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, stochastic=True)
        refs = (o_ref, *fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, stochastic=True))
        outs = (o, *grads)
        ulps = [ulp_of_max_err(torch, a, r, dtype) for a, r in zip(outs, refs)]
        equal = [(a.float() == r.float()).float().mean().item() for a, r in zip(outs, refs)]
        lse_err = (lse - lse_ref).abs().max().item()
        scale = 1.0 / math.sqrt(D)
        delta = fa.flash_attention_bwd_delta(o, do)
        ms = {
            "fwd": timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal, stochastic=True)),
            "dq": timer.ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                                             scale, stochastic=True)),
            "dkv": timer.ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                                               scale, stochastic=True)),
            "fwd_default": timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal)),
        }
        tag = f"B{B} T{T} S{S} H{H} D{D} causal={causal} {dt}"
        log(f"phase2 flash_attention stochastic_mode {tag}: o/dq/dk/dv ulp_of_max_err="
            + "/".join(f"{u:.2f}" for u in ulps) + " bitwise_equal_share="
            + "/".join(f"{e:.5f}" for e in equal)
            + f" lse_err={lse_err:.3e} bitwise_rerun={bitwise} launches={counted} "
            + " ".join(f"{n}_kernel_ms={t:.4f}" for n, t in ms.items()))
        want = path_launches(counted, 2, (*FWD_PATH["stochastic"], *BWD_PATH["stochastic"]))
        check(counted == want, f"stochastic {tag}: launches {counted}, expected {want}")
        check(bitwise, f"stochastic {tag}: two runs differ")
        check(max(ulps) <= SINGLE_MAX_ULP and min(equal) >= SINGLE_EQUAL,
              f"stochastic {tag}: {ulps} ulps of the largest, bitwise shares {equal}")
        check(lse_err <= LSE_ATOL, f"stochastic {tag}: lse error {lse_err}")
        del q, k, v, do, o, o2, grads, again, refs, outs
        torch.cuda.empty_cache()


def dqm_bound(M, D, F, Fp, nb, elt):
    """Least time of one B8 product: x, the uint8 payload and its fp32
    scales and zero-points read once, the output written once; its
    operations for the fp32-accurate function at the card's fastest rate,
    three bf16 passes (x s as three exact parts against the exact q) at the
    bf16 peak on the tensor cores."""
    nbytes = M * D * elt + D * Fp + 8 * D * nb + M * F * elt
    return bound(nbytes, 3 * 2.0 * M * D * F, "bfloat16")


def _dqm_exact(torch, x, q, s, z, F):
    """x @ (q s + z)[:, :F] in float64 over the unrounded weights: the
    function the fp32 route approximates."""
    block = q.shape[1] // s.shape[1]
    w = (q.double() * s.double().repeat_interleave(block, 1)
         + z.double().repeat_interleave(block, 1))[:, :F]
    return x.double() @ w


# B8's timed rows, by phase 2 case (M, D, F, block, dtype): the LM head's
# shape (phases 9a / 9b), under 64 rows (9d's B1 x T32 head), at a block of
# 128 (9e), at a block of 96 (off 64-column panels: 9d's head, and the LM
# head at 4096 rows, timed only), and a head whose D is off 64-row steps
# (d 480, timed only)
DQM_ROWS = {(4096, 768, 50304, 256, "float32"): "dqm_tc",
            (32, 768, 50304, 256, "float32"): "dqm_tc_few_rows",
            (4096, 768, 50304, 128, "float32"): "dqm_tc_block128",
            (32, 768, 50304, 96, "float32"): "dqm_tc_block96",
            (4096, 768, 50304, 96, "float32"): "dqm_tc_block96_rows4096",
            (32, 480, 50304, 256, "float32"): "dqm_tc_d480"}


def phase_kernels_dequant(torch, ctx):
    """B8 against its plain version, each case through the tensor-core
    kernel (``dqm_route``, checked by the counter): the main-path shape (the
    GPT-2-125M LM head at B8 x T512, x fp32 as the forward casts it, and with
    bf16 x), 9d's head at 32 rows, M = 1, 37 and 63 (the 64-row tiling),
    blocks of 64 and 128 at 4096 and 256 rows (the narrower tiles), blocks
    off 64-column panels (8, 48, 96 at 9d's head and at 4096 rows, 160, 250:
    padded to whole panels), an effective block of 96 (D 64 x F 96), D off
    64-row steps (70, 100, 300, 333, 480; rows of x or q off 16 bytes copied
    by the wrapper), the leaf at 2048 rows; every case also bitwise on a
    re-run, with its error and its plain version's against the float64
    product. The rows of ``DQM_ROWS`` also time the plain version, cuBLAS
    fp32 (TF32 off) over the weight already dequantized and the dequantize
    plus cuBLAS. An odd block (no quantizer gives one) must raise, with no
    launch."""
    from deepspeed_tpu_torch.comm.quantized import dequantize_blockwise, quantize_blockwise
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    timer = ctx["timer"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    V = 50304
    cases = [(4096, 768, V, 256, "float32"), (4096, 768, V, 256, "bfloat16"),
             (32, 768, V, 256, "float32"),  # phase 9d's head
             (1, 768, V, 256, "float32"), (37, 768, V, 256, "float32"),
             (63, 768, V, 128, "float32"), (1, 768, V, 64, "float32"),
             (4096, 768, V, 128, "float32"),  # phase 9e's head
             (4096, 768, V, 64, "bfloat16"), (256, 768, 3072, 128, "float32"),
             (256, 768, 3072, 64, "float16"),
             (32, 768, V, 96, "float32"),  # 9d's head at a block of 96
             (4096, 768, V, 96, "float32"), (1, 768, V, 8, "float32"),
             (37, 768, V, 48, "float32"), (256, 768, V, 160, "bfloat16"),
             (63, 768, V, 250, "float32"), (256, 768, 3072, 96, "float16"),
             (64, 64, 96, 256, "float32"),
             (2048, 768, 2304, 256, "float32"), (2048, 768, 2304, 256, "bfloat16"),
             (37, 768, 3000, 128, "bfloat16"), (200, 768, 2304, 256, "float16"),
             # D off 64-row steps
             (32, 480, V, 256, "float32"), (256, 480, 1920, 96, "bfloat16"),
             (100, 300, 1000, 256, "float32"), (7, 100, 3000, 96, "bfloat16"),
             (200, 333, 2304, 256, "float16"), (5, 70, 1000, 250, "float32"),
             # gpt-neox-20b's D 6144: fp32 promotes its accumulators (dqm_promotes)
             (256, 6144, 6144, 256, "float32"), (256, 6144, 6144, 96, "float32"),
             (32, 6144, 6144, 256, "float32"), (32, 6144, 6144, 96, "float32")]
    worst = 0.0
    payloads = {}
    for M, D, F, block, dt in cases:
        if (D, F, block) not in payloads:
            w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
            payloads[(D, F, block)] = quantize_blockwise(w, bits=8, block_size=block)
        q, s, z = payloads[(D, F, block)]
        Fp, nb = q.shape[1], s.shape[1]
        route = dqm.dqm_route(M, D, Fp, nb)
        x = torch.randn((M, D), generator=gen, device="cuda").to(getattr(torch, dt))
        before = dqm.tc_launches
        out = dqm.dequant_matmul(x, q, s, z, orig_size=F)
        again = dqm.dequant_matmul(x, q, s, z, orig_size=F)
        torch.cuda.synchronize()
        moved = dqm.tc_launches - before
        ref = dqm.dequant_matmul_ref(x, q, s, z, orig_size=F)
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-30)
        worst = max(worst, err)
        exact = _dqm_exact(torch, x, q, s, z, F)
        top = exact.abs().max().item()
        rel64 = (out.double() - exact).abs().max().item() / top
        plain_rel64 = (ref.double() - exact).abs().max().item() / top
        promote = dqm.dqm_promotes(D, x.dtype)
        unpromoted = ""
        if promote:  # the same inputs through one accumulator over all of D
            one = dqm._launch(x, q, s, z, F, dqm.dqm_tile(M, Fp, nb), promote=False)
            one_rel64 = (one.double() - exact).abs().max().item() / top
            unpromoted = f"unpromoted_rel_err_vs_fp64={one_rel64:.3e} "
            del one
        del exact
        kernel_ms = timer.ms(lambda: dqm.dequant_matmul(x, q, s, z, orig_size=F), iters=7)
        bound_ms, bound_by = dqm_bound(M, D, F, Fp, nb, x.element_size())
        line = (f"phase2 dequant_matmul M{M} D{D} F{F} Fp{Fp} block{Fp // nb} {dt} "
                f"route={route} tile={dqm.dqm_tile(M, Fp, nb, promote)} promote={promote} "
                f"launches={moved}: "
                f"max_abs_err={err:.3e} rel_err={rel:.3e} rel_err_vs_fp64={rel64:.3e} "
                f"plain_rel_err_vs_fp64={plain_rel64:.3e} " + unpromoted +
                f"bitwise_rerun={torch.equal(out, again)} kernel_ms={kernel_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by})")
        row = DQM_ROWS.get((M, D, F, block, dt))
        if row:
            w_hat = dequantize_blockwise(q, s, z, orig_size=F)
            plain_ms = timer.ms(lambda: dqm.dequant_matmul_ref(x, q, s, z, orig_size=F), iters=7)
            library_ms = timer.ms(lambda: torch.matmul(x, w_hat), iters=7)
            deq_library_ms = timer.ms(
                lambda: torch.matmul(x, dequantize_blockwise(q, s, z, orig_size=F)), iters=7)
            line += (f" plain_ms={plain_ms:.4f} library_ms(cuBLAS fp32, TF32 off, dequantize "
                     f"excluded)={library_ms:.4f} dequantize+cuBLAS_ms={deq_library_ms:.4f} "
                     f"kernel/cuBLAS={kernel_ms / library_ms:.2f} "
                     f"kernel/bound={kernel_ms / bound_ms:.2f} "
                     f"kernel_tflops(fp32 function)={2.0 * M * D * F / kernel_ms / 1e9:.2f}")
            ctx[row] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
            del w_hat
        log(line)
        tag = f"dequant_matmul {M, D, F, block, dt}"
        check(route == "tensor_cores" and moved == 2,
              f"{tag}: route {route}, launches {moved}; expected tensor_cores, 2")
        check(torch.equal(out, again), f"{tag}: two runs differ")
        check(rel <= QMM_RTOL[dt], f"{tag}: rel error {rel}")
        if dt == "float32":  # the fp32 function, held to the float64 product
            check(rel64 <= DQM_FP64_RTOL, f"{tag}: {rel64} from the float64 product")
        del out, again, ref
    ctx["dqm_tc"]["max_abs_err"] = worst
    # an odd block (393 columns): no kernel takes it, so the call raises
    q = torch.randint(0, 256, (768, V), generator=gen, device="cuda", dtype=torch.uint8)
    s = torch.full((768, V // 393), 1e-4, device="cuda")
    before, refused = dqm.tc_launches, False
    try:
        dqm.dequant_matmul(torch.randn((37, 768), generator=gen, device="cuda"), q, s, -128 * s,
                           orig_size=V)
    except ValueError:
        refused = True
    log(f"phase2 dequant_matmul odd block 393: refused={refused} "
        f"launches={dqm.tc_launches - before}")
    check(refused and dqm.tc_launches == before, "dequant_matmul: an odd block did not raise")
    for line in _build.build_logs.get("dequant_matmul_tc", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"phase2 dequant_matmul_tc ptxas: {line.strip()}")
    torch.cuda.empty_cache()


def qmm_bound(M, D, F, group, bits, dtype, elt):
    """Least time of one quantized product: the weight payload (a byte per
    weight, half for int4), its fp32 scales, x read and out written once;
    2 flops per multiply-add at the peak of x's dtype, and for fp32 x the
    fp32 function at the card's fastest rate for it, three bf16 passes (x
    times the scales as three exact parts against the exact integers) at
    the bf16 peak, whichever route serves the case."""
    nbytes = D * F * bits / 8 + 4 * D * F / group + (M * D + M * F) * elt
    if dtype == "float32":
        return bound(nbytes, 3 * 2.0 * M * D * F, "bfloat16")
    return bound(nbytes, 2.0 * M * D * F, dtype)


def phase_kernels_qmatmul(torch, ctx):
    """B6 (int8) and B7 (int4) against their plain versions at the four
    projection shapes of GPT-2-125M and of gpt2-350m, at the decode and
    prefill-chunk row counts, group 128, fp32 and bf16, each through the
    kernel its route names (1-8 rows: the decode kernel; 64 and 256 rows:
    the tensor cores); int8 also at group 64 and at a group that crosses
    rows; int8 and int4 at phase 7e's layout (GPT-2-125M's four projections
    at group 32 in fp32, at its 4 decode rows and 256 prefill rows: the
    CUDA cores). Every case bitwise on a re-run and within QMM_RTOL of the
    plain version; fp32 also within DQM_FP64_RTOL of the float64 product.
    The CUDA-core kernels' rows of the result line are 7e's mlp_up at M=4.
    Then the tensor-core kernel's own cases (phase_kernels_qmatmul_tc) and
    the decode kernel's (phase_kernels_qmatmul_decode)."""
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
    cases += [(M, D, F, 32, bits, "float32") for bits in (8, 4) for D, F in shapes[:4]
              for M in (4, 256)]  # 7e's layout
    errs = {8: 0.0, 4: 0.0}
    weights = {}
    for M, D, F, group, bits, dt in cases:
        dtype = getattr(torch, dt)
        key = (D, F, group, bits)
        if key not in weights:
            w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
            q, s = quantize(w, bits=bits, num_groups=D * F // group)
            w64 = (q.double().reshape(-1, group) * s.double().reshape(-1, 1)).reshape(D, F)
            weights[key] = (im.pack_int4(q) if bits == 4 else q, s, w64)
        q, s, w64 = weights[key]
        x = torch.randn((M, D), generator=gen, device="cuda").to(dtype)
        kernel_fn, plain_fn = ((im.int4_matmul, im.int4_matmul_ref) if bits == 4
                               else (im.int8_matmul, im.int8_matmul_ref))
        route = im.qmm_route(M, dtype, D, F, group, bits)
        out = kernel_fn(x, q, s, group)
        again = kernel_fn(x, q, s, group)
        torch.cuda.synchronize()
        ref = plain_fn(x, q, s, group)
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-30)
        errs[bits] = max(errs[bits], err)
        exact = x.double() @ w64
        rel64 = (out.double() - exact).abs().max().item() / exact.abs().max().item()
        del exact
        w_dense = dequantize(im.unpack_int4(q) if bits == 4 else q, s, dtype)
        kernel_ms = timer.ms(lambda: kernel_fn(x, q, s, group))
        plain_ms = timer.ms(lambda: plain_fn(x, q, s, group))
        library_ms = timer.ms(lambda: torch.matmul(x, w_dense))
        bound_ms, bound_by = qmm_bound(M, D, F, group, bits, dt, x.element_size())
        name = "int4_matmul" if bits == 4 else "int8_matmul"
        log(f"phase2 {name} M{M} D{D} F{F} group{group} {dt} route={route}: max_abs_err={err:.3e} "
            f"rel_err={rel:.3e} rel_err_vs_fp64={rel64:.3e} "
            f"bitwise_rerun={torch.equal(out, again)} kernel_ms={kernel_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(cuBLAS dense, dequantize excluded)="
            f"{library_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
        check(torch.equal(out, again), f"{name} {M, D, F, group, dt}: two runs differ")
        check(rel <= QMM_RTOL[dt], f"{name} {M, D, F, group, dt}: rel error {rel}")
        if dt == "float32":
            check(rel64 <= DQM_FP64_RTOL, f"{name} {M, D, F, group}: {rel64} from float64")
        if group == 32:  # 7e: the CUDA cores
            check(route == "cuda_cores", f"{name} {M, D, F} at group 32: route {route}")
        if (M, D, F, group, dt) == (4, 768, 3072, 32, "float32"):
            ctx[f"qmm_int{bits}"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                         bound_ms=bound_ms, bound_by=bound_by)
    for bits in (8, 4):
        ctx[f"qmm_int{bits}"]["max_abs_err"] = errs[bits]
    phase_kernels_qmatmul_tc(torch, ctx)
    phase_kernels_qmatmul_decode(torch, ctx)


QMM_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768),
              (1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
# B6/B7 on the tensor cores against the fp32 plain version, in ulps of x's
# dtype: w enters as hi + lo halves (~2^-16 of w in bf16, ~2^-22 in fp16),
# the fp32 sums run in another order, and both round once to the dtype
QMM_TC_MAX_ULP = 2
# the row counts the tensor-core cases cover (verify windows 40-80, prefill
# chunks 32-128, a batched admission 256), and the crossover rows at which
# both kernels are timed
QMM_TC_ROWS = (16, 32, 40, 64, 100, 128, 256)
QMM_CROSSOVER_ROWS = (8, 16, 32, 40, 64)
# PR 9's CUDA-core times at M=256 bf16, group 128 (PERF.md kernel table)
# are re-timed in this run beside the tensor-core kernel; the redesign's
# target is at least this factor faster on each shape (reported)
QMM_TC_TARGET_SPEEDUP = 3.0


def phase_kernels_qmatmul_tc(torch, ctx):
    """B6 / B7 on the tensor cores (``csrc/int8_matmul_tc.cu``) at the 8
    projection shapes of GPT-2-125M and gpt2-350m, M in QMM_TC_ROWS, groups
    128 and 64, bf16 / fp16 and fp32 x: bf16 / fp16 at most QMM_TC_MAX_ULP
    ulps of the dtype of the fp32 plain version on the entries of at least
    1e-3 of the largest; fp32 (three bf16 parts of x times the scales
    against the exact integers) within QMM_RTOL of the largest output of the
    plain version and DQM_FP64_RTOL of the float64 product; all bitwise on a
    re-run, two tensor-core launches and no other. bf16 and fp32 at group
    128 are timed at every M and at the crossover rows: the tensor-core
    kernel, the CUDA-core kernel on the same inputs (each launched directly,
    whatever the route), the plain version, cuBLAS over the weight already
    dequantized to x's dtype, and the bound; fp16 at M=256. The result
    line's rows are mlp_up (768 x 3072) at M=128, a prefill chunk of phase
    7d (bf16) and 7c (fp32), group 128."""
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im
    from deepspeed_tpu_torch.ops.quantizer import dequantize, quantize

    timer = ctx["timer"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {(bits, f32): 0.0 for bits in (8, 4) for f32 in (False, True)}
    worst_ulp = {"bfloat16": 0.0, "float16": 0.0}
    worst_fp32 = {"plain": 0.0, "fp64": 0.0}
    speedups = {}
    for bits in (8, 4):
        name = f"int{bits}_matmul"
        kernel_fn, plain_fn = ((im.int4_matmul, im.int4_matmul_ref) if bits == 4
                               else (im.int8_matmul, im.int8_matmul_ref))
        for D, F in QMM_SHAPES:
            for group in (QUANT_GROUP, 64):
                w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
                q, s = quantize(w, bits=bits, num_groups=D * F // group)
                w64 = (q.double().reshape(-1, group) * s.double().reshape(-1, 1)).reshape(D, F)
                q = im.pack_int4(q) if bits == 4 else q
                w_deq = {dt: dequantize(im.unpack_int4(q) if bits == 4 else q, s,
                                        getattr(torch, dt)) for dt in ("bfloat16", "float32")}
                rows = sorted(set(QMM_TC_ROWS) | (set(QMM_CROSSOVER_ROWS) if group == QUANT_GROUP
                                                  else set()))
                for M in rows:
                    for dt in ("bfloat16", "float16", "float32"):
                        dtype = getattr(torch, dt)
                        x = torch.randn((M, D), generator=gen, device="cuda").to(dtype)
                        tag = f"{name} M{M} D{D} F{F} group{group} {dt}"
                        line = f"phase2 {tag}"
                        if M in QMM_TC_ROWS:
                            before = {k: getattr(im, c) for k, c in QMM_COUNTERS.items()}
                            out = kernel_fn(x, q, s, group)
                            again = kernel_fn(x, q, s, group)
                            torch.cuda.synchronize()
                            moved = {k: getattr(im, c) - before[k]
                                     for k, c in QMM_COUNTERS.items()}
                            ref = plain_fn(x.float(), q, s, group)
                            err = (out.float() - ref).abs().max().item()
                            bitwise = torch.equal(out, again)
                            worst[(bits, dt == "float32")] = max(worst[(bits, dt == "float32")],
                                                                 err)
                            if dt == "float32":
                                rel = err / ref.abs().max().item()
                                exact = x.double() @ w64
                                rel64 = (out.double() - exact).abs().max().item() / \
                                    exact.abs().max().item()
                                worst_fp32["plain"] = max(worst_fp32["plain"], rel)
                                worst_fp32["fp64"] = max(worst_fp32["fp64"], rel64)
                                line += (f" route=tc: rel_err={rel:.3e} rel_err_vs_fp64="
                                         f"{rel64:.3e} max_abs_err={err:.3e} "
                                         f"bitwise_rerun={bitwise} launches={moved}")
                                check(rel <= QMM_RTOL[dt], f"{tag}: rel error {rel}")
                                check(rel64 <= DQM_FP64_RTOL, f"{tag}: {rel64} from float64")
                                del exact
                            else:
                                ulps = ulp_err(torch, out, ref, dtype)
                                worst_ulp[dt] = max(worst_ulp[dt], ulps)
                                line += (f" route=tc: max_ulp_err={ulps:.2f} max_abs_err={err:.3e} "
                                         f"bitwise_rerun={bitwise} launches={moved}")
                                check(ulps <= QMM_TC_MAX_ULP, f"{tag}: {ulps} {dt} ulps")
                            check(bitwise, f"{tag}: two runs differ")
                            want = {k: 2 if k == f"int{bits}_tc" else 0 for k in QMM_COUNTERS}
                            check(moved == want, f"{tag}: launches {moved}, expected {want}")
                            del out, again, ref
                        timed = group == QUANT_GROUP and (dt != "float16" or M == 256)
                        if timed:
                            tc_ms = timer.ms(lambda: im._launch_tc(name, x, q, s, F, group, bits))
                            line += f" tc_ms={tc_ms:.4f}"
                        if timed and dt != "float16":
                            w_lib = w_deq[dt]
                            cc_ms = timer.ms(lambda: im._launch(name, x, q, s, F, group, bits))
                            plain_ms = timer.ms(lambda: plain_fn(x, q, s, group))
                            library_ms = timer.ms(lambda: torch.matmul(x, w_lib))
                            bound_ms, bound_by = qmm_bound(M, D, F, group, bits, dt,
                                                           x.element_size())
                            lib = "cuBLAS fp32, TF32 off" if dt == "float32" else "cuBLAS bf16"
                            line += (f" cuda_cores_ms={cc_ms:.4f} plain_ms={plain_ms:.4f} "
                                     f"library_ms({lib}, dequantize excluded)="
                                     f"{library_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
                                     f"cuda_cores/tc={cc_ms / tc_ms:.2f} "
                                     f"tc/cublas={tc_ms / library_ms:.2f} "
                                     f"plan={im.tc_plan(M, D, F, sms)}")
                            if M == 256:
                                speedups[(bits, dt, D, F)] = (cc_ms / tc_ms, tc_ms / library_ms)
                            if (D, F, M) == (768, 3072, 128):
                                key = "qmm_tc_f32" if dt == "float32" else "qmm_tc"
                                ctx[f"{key}_int{bits}"] = dict(
                                    ms=tc_ms, plain_ms=plain_ms, library_ms=library_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
                        log(line)
                del w, q, s, w64, w_deq
    for bits in (8, 4):
        ctx[f"qmm_tc_int{bits}"]["max_abs_err"] = worst[(bits, False)]
        ctx[f"qmm_tc_f32_int{bits}"]["max_abs_err"] = worst[(bits, True)]
    for (bits, dt, D, F), (fast, vs_lib) in speedups.items():
        target = QMM_TC_TARGET_SPEEDUP if dt == "bfloat16" else 1.0
        log(f"phase2 int{bits}_matmul_tc M256 D{D} F{F} {dt}: {fast:.2f}x faster than the "
            f"CUDA-core kernel (target {target}: {'met' if fast >= target else 'missed'}), "
            f"{vs_lib:.2f}x cuBLAS (target {1.5 if dt == 'bfloat16' else 1.0}: "
            f"{'met' if vs_lib <= (1.5 if dt == 'bfloat16' else 1.0) else 'missed'})")
    log(f"phase2 int8/int4_matmul_tc: largest ulps bf16={worst_ulp['bfloat16']:.2f} "
        f"fp16={worst_ulp['float16']:.2f}; fp32 largest rel error vs plain="
        f"{worst_fp32['plain']:.3e} vs fp64={worst_fp32['fp64']:.3e} over "
        f"{len(QMM_SHAPES) * len(QMM_TC_ROWS) * 12} cases")
    for line in _build.build_logs.get("int8_matmul_tc", "").splitlines():
        if "registers" in line or "spill" in line or "C75" in line:
            log(f"phase2 int8_matmul_tc ptxas: {line.strip()}")
    torch.cuda.empty_cache()


# B6/B7's decode kernel: the rows it takes (a decode step of 1-8 slots)
QMM_DEC_ROWS = (1, 2, 4, 8)


def phase_kernels_qmatmul_decode(torch, ctx):
    """B6 / B7's decode kernel (``csrc/int8_matmul_decode.cu``) at the 8
    projection shapes of GPT-2-125M and gpt2-350m, M in QMM_DEC_ROWS, groups
    128 and 64, int8 / int4, fp32 / bf16 / fp16 x, through the wrapper's
    route: fp32 within QMM_RTOL of the largest output of the plain version
    and DQM_FP64_RTOL of the float64 product's; bf16 / fp16 at most
    QMM_TC_MAX_ULP ulps of the dtype of the fp32 plain version on the
    entries of at least 1e-3 of the largest; bitwise on a re-run, two decode
    launches and no other. At group 128 in fp32 and bf16 (fp16 at M=8) the
    decode kernel, the CUDA-core kernel on the same inputs (the route before
    it), the plain version, cuBLAS in x's dtype over the weight already
    dequantized to it and the bound (three bf16 passes of x s in every
    dtype, or the bytes) are timed. The result line's rows are gpt2-350m's mlp_up at M=8 in bf16,
    phase 7b's decode shape."""
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im
    from deepspeed_tpu_torch.ops.quantizer import dequantize, quantize

    timer = ctx["timer"]
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {8: 0.0, 4: 0.0}
    worst_ulp = {"bfloat16": 0.0, "float16": 0.0}
    worst_fp32 = {"plain": 0.0, "fp64": 0.0}
    versus = {"cublas": [], "cuda_cores": []}  # (kernel / cuBLAS, CUDA cores / kernel)
    n_cases = 0
    for bits in (8, 4):
        name = f"int{bits}_matmul"
        kernel_fn, plain_fn = ((im.int4_matmul, im.int4_matmul_ref) if bits == 4
                               else (im.int8_matmul, im.int8_matmul_ref))
        for D, F in QMM_SHAPES:
            for group in (QUANT_GROUP, 64):
                w = torch.randn((D, F), generator=gen, device="cuda") * 0.02
                q, s = quantize(w, bits=bits, num_groups=D * F // group)
                w64 = (q.double().reshape(-1, group) * s.double().reshape(-1, 1)).reshape(D, F)
                q = im.pack_int4(q) if bits == 4 else q
                w_deq = {dt: dequantize(im.unpack_int4(q) if bits == 4 else q, s,
                                        getattr(torch, dt))
                         for dt in ("float32", "bfloat16", "float16")}
                plan = im.decode_plan(D, q.shape[1], im._num_sms(0), bits)
                for M in QMM_DEC_ROWS:
                    for dt in ("float32", "bfloat16", "float16"):
                        dtype = getattr(torch, dt)
                        x = torch.randn((M, D), generator=gen, device="cuda").to(dtype)
                        tag = f"{name} M{M} D{D} F{F} group{group} {dt}"
                        before = {k: getattr(im, c) for k, c in QMM_COUNTERS.items()}
                        out = kernel_fn(x, q, s, group)
                        again = kernel_fn(x, q, s, group)
                        torch.cuda.synchronize()
                        moved = {k: getattr(im, c) - before[k] for k, c in QMM_COUNTERS.items()}
                        ref = plain_fn(x.float(), q, s, group)
                        err = (out.float() - ref).abs().max().item()
                        bitwise = torch.equal(out, again)
                        worst[bits] = max(worst[bits], err)
                        n_cases += 1
                        line = f"phase2 {tag} route=decode plan={plan}:"
                        if dt == "float32":
                            rel = err / ref.abs().max().item()
                            exact = x.double() @ w64
                            rel64 = ((out.double() - exact).abs().max().item()
                                     / exact.abs().max().item())
                            worst_fp32["plain"] = max(worst_fp32["plain"], rel)
                            worst_fp32["fp64"] = max(worst_fp32["fp64"], rel64)
                            line += f" rel_err={rel:.3e} rel_err_vs_fp64={rel64:.3e}"
                            check(rel <= QMM_RTOL[dt], f"{tag}: rel error {rel}")
                            check(rel64 <= DQM_FP64_RTOL, f"{tag}: {rel64} from float64")
                            del exact
                        else:
                            ulps = ulp_err(torch, out, ref, dtype)
                            worst_ulp[dt] = max(worst_ulp[dt], ulps)
                            line += f" max_ulp_err={ulps:.2f}"
                            check(ulps <= QMM_TC_MAX_ULP, f"{tag}: {ulps} {dt} ulps")
                        line += f" max_abs_err={err:.3e} bitwise_rerun={bitwise} launches={moved}"
                        check(bitwise, f"{tag}: two runs differ")
                        want = {k: 2 if k == f"int{bits}_dec" else 0 for k in QMM_COUNTERS}
                        check(moved == want, f"{tag}: launches {moved}, expected {want}")
                        if group == QUANT_GROUP and (dt != "float16" or M == 8):
                            w_lib = w_deq[dt]
                            dec_ms = timer.ms(lambda: im._launch_decode(name, x, q, s, F, group,
                                                                        bits))
                            cc_ms = timer.ms(lambda: im._launch(name, x, q, s, F, group, bits))
                            plain_ms = timer.ms(lambda: plain_fn(x, q, s, group))
                            library_ms = timer.ms(lambda: torch.matmul(x, w_lib))
                            bound_ms, bound_by = qmm_bound(M, D, F, group, bits, "float32",
                                                           x.element_size())
                            lib = "cuBLAS fp32, TF32 off" if dt == "float32" else f"cuBLAS {dt}"
                            line += (f" dec_ms={dec_ms:.4f} cuda_cores_ms={cc_ms:.4f} "
                                     f"plain_ms={plain_ms:.4f} "
                                     f"library_ms({lib}, dequantize excluded)={library_ms:.4f} "
                                     f"bound_ms={bound_ms:.5f} ({bound_by}) "
                                     f"dec/cublas={dec_ms / library_ms:.2f} "
                                     f"cuda_cores/dec={cc_ms / dec_ms:.2f} "
                                     f"dec/bound={dec_ms / bound_ms:.2f}")
                            versus["cublas"].append(dec_ms / library_ms)
                            versus["cuda_cores"].append(cc_ms / dec_ms)
                            if (D, F, M, dt) == (1024, 4096, 8, "bfloat16"):
                                ctx[f"qmm_dec_int{bits}"] = dict(
                                    ms=dec_ms, plain_ms=plain_ms, library_ms=library_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
                        log(line)
                        del out, again, ref
                del w, q, s, w64, w_deq
    for bits in (8, 4):
        ctx[f"qmm_dec_int{bits}"]["max_abs_err"] = worst[bits]
    log(f"phase2 int8/int4_matmul_decode over {n_cases} cases: largest ulps bf16="
        f"{worst_ulp['bfloat16']:.2f} fp16={worst_ulp['float16']:.2f}; fp32 largest rel error "
        f"vs plain={worst_fp32['plain']:.3e} vs fp64={worst_fp32['fp64']:.3e}; over the "
        f"{len(versus['cublas'])} timed cases dec/cuBLAS {min(versus['cublas']):.2f}-"
        f"{max(versus['cublas']):.2f} (at or below 1: "
        f"{sum(v <= 1.0 for v in versus['cublas'])}), CUDA cores/dec "
        f"{min(versus['cuda_cores']):.2f}-{max(versus['cuda_cores']):.2f}")
    for line in _build.build_logs.get("int8_matmul_decode", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"phase2 int8_matmul_decode ptxas: {line.strip()}")
    torch.cuda.empty_cache()


def _paged_lengths(B, pages, ps, rng):
    """Lengths of a B4 case: 0, 1, a page's edge (ps - 1, ps, ps + 1), the
    capacity, mid and one short of it, then split edges and random ones."""
    full = pages * ps
    lens = [0, 1, ps - 1, ps, ps + 1, full, full // 2 + 7, full - 1]
    extra = [191, 192, 193, 255, 256, 300, 383, 384]
    lens += [n for n in extra if n <= full][:max(0, B - len(lens))]
    lens += [int(n) for n in rng.integers(0, full + 1, max(0, B - len(lens)))]
    return lens[:B]


def _aliased_table(lens_list, pages, pool, ps, shared, rng, ahead=0):
    """A block table as a prefix cache leaves it: every row whose length
    covers ``shared`` full pages begins with the same ``shared`` physical
    pages; the rest of each row (the pages its length, plus ``ahead``
    positions, reaches) are private pages, distinct across rows."""
    common = rng.choice(np.arange(1, pool), shared, replace=False)
    private = [p for p in rng.permutation(np.arange(1, pool)) if p not in common]
    table = np.zeros((len(lens_list), pages), np.int32)
    for b, n in enumerate(lens_list):
        used = min(-(-(n + ahead) // ps), pages)
        lead = shared if n >= shared * ps else 0
        table[b, :lead] = common[:lead]
        for i in range(lead, used):
            table[b, i] = private.pop()
    return table


# the aliased-table rows of B4 and B5 (phase 6's cell: 8 slots, page 64, 8
# pages a row, pool 17): seven rows borrow the same two leading pages (a
# 128-token system prompt), one short row does not
ALIASED_LENS = {"B4": [128, 129, 191, 192, 200, 250, 300, 5],
                "B5": [128, 129, 150, 191, 192, 200, 250, 5]}


def phase_kernels_paged(torch, ctx):
    """B4 (dense pools) and B4q (int8, int4 pools), split over each row's
    pages (``split_plan``), against the gather + plain softmax version: the
    serving bench shape (8 slots, H12, Dh64, page 64, 8 pages per row, pool
    17), a long one (16 pages per row, pool 257: 6 splits of 192), the bench
    shape at Dh 96 (whose int4 dims straddle a byte's nibbles), pages of 128
    at 16 slots (phase 8b's table: 3 splits of 192, so a split starts inside
    a page; also fp16) and Dh 128 at 64 slots (768 rows fill the card: one
    split a row, every output written directly), fp32 and bf16, lengths {0,
    1, ps - 1, ps, ps + 1, full, ...} over scattered page ids; every case
    bitwise on a re-run, beside the one-block-a-row kernel's time where an
    earlier run measured it (``OLD_PAGED_MS``). The kernels' rows of the result line are the bench shape in
    fp32, the dtype of the paths that count their launches (phase 6 a and
    d)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    timer = ctx["timer"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(5)
    H = 12
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    errs = {kind: 0.0 for kind in PAGED_KINDS}
    shapes = ((64, 8, 8, 17, 64, ("float32", "bfloat16")),
              (64, 8, 16, 257, 64, ("float32", "bfloat16")),
              (96, 8, 8, 17, 64, ("float32", "bfloat16")),
              (64, 16, 4, 65, 128, ("float32", "bfloat16", "float16")),
              (128, 64, 8, 513, 64, ("float32", "bfloat16")))
    for Dh, B, pages, pool, ps, dtypes in shapes:
        full = pages * ps
        lens_list = _paged_lengths(B, pages, ps, rng)
        tables_np = np.zeros((B, pages), np.int32)
        for b, n in enumerate(lens_list):
            used = -(-n // ps)
            tables_np[b, :used] = rng.choice(np.arange(1, pool), used, replace=False)
        tables = torch.from_numpy(tables_np).cuda()
        tl = tables.long()
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        valid = (torch.arange(full, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        n_split, span = da.split_plan(B * H, full, sms)
        for dt in dtypes:
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
                again = kernel()
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
                old = OLD_PAGED_MS.get((kind, dt, Dh, pages)) if (B, ps) == (8, 64) else None
                log(f"phase2 paged_decode_attention {kind} B{B} H{H} Dh{Dh} ps{ps} "
                    f"pages_per_seq{pages} pool{pool} split={n_split}x{span} "
                    f"lengths={lens_list} {dt}: max_abs_err={err:.3e} "
                    f"bitwise_rerun={torch.equal(out, again)} kernel_ms={kernel_ms:.4f} "
                    f"(one block a row: {old if old is not None else 'not measured'}) "
                    f"plain_ms={plain_ms:.4f} library_ms(sdpa, gather excluded)={library_ms:.4f} "
                    f"gather_sdpa_ms={gather_sdpa_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
                tag = f"paged {kind} B{B} ps{ps} {pages} pages Dh{Dh} {dt}"
                check(err <= ATOL[dt], f"{tag}: max_abs_err {err}")
                check(torch.count_nonzero(out[0]).item() == 0,
                      f"{tag}: the length-0 row is not zero")
                check(torch.equal(out, again), f"{tag}: two runs differ")
                if (Dh, B, pages, dt) == (64, 8, 8, "float32"):
                    ctx[f"paged_{kind}"] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                                library_ms=library_ms, bound_ms=bound_ms,
                                                bound_by=bound_by)
                del q, k, v, kc, vc, out, again
        torch.cuda.empty_cache()

    # tables whose leading pages are the same physical pages in several
    # slots, as the prefix cache leaves them (phase 15)
    lens_list = ALIASED_LENS["B4"]
    tables = torch.from_numpy(_aliased_table(lens_list, 8, 17, 64, 2, rng)).cuda()
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for kind in ("dense", "kv8"):
            q = randn((8, 1, H, 64), dtype)
            if kind == "dense":
                k, v = randn((H, 17, 64, 64), dtype), randn((H, 17, 64, 64), dtype)
                ks = vs = None
            else:
                k, v = (torch.randint(-128, 128, (H, 17, 64, 64), generator=gen, device="cuda",
                                      dtype=torch.int8) for _ in range(2))
                ks, vs = (torch.rand((H, 17), generator=gen, device="cuda") * 0.02 + 1e-3
                          for _ in range(2))
            out = da.paged_decode_attention(q, k, v, lens, tables, k_scales=ks, v_scales=vs)
            again = da.paged_decode_attention(q, k, v, lens, tables, k_scales=ks, v_scales=vs)
            ref = da.paged_decode_attention(q, k, v, lens, tables, impl="gather", k_scales=ks,
                                            v_scales=vs)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            errs[kind] = max(errs[kind], err)
            log(f"phase2 paged_decode_attention {kind} aliased tables (rows 0-6 share pages "
                f"{tables[0, :2].tolist()}) B8 H{H} Dh64 ps64 pool17 lengths={lens_list} {dt}: "
                f"max_abs_err={err:.3e} bitwise_rerun={torch.equal(out, again)}")
            check(err <= ATOL[dt], f"paged {kind} aliased {dt}: max_abs_err {err}")
            check(torch.equal(out, again), f"paged {kind} aliased {dt}: two runs differ")
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
    """B5 (dense, int8, int4 pools; split over the pages by ``split_plan``;
    bf16 / fp16 on mma.sync) against the plain version, on the committable
    window positions (the plain version drops positions past the table, the
    kernel attends them): 90 base cases (8 slots, H12, Dh64, a 512-token
    table of page size 8, 64 or 128, windows W of 2, 3, 5, 9 and 17, fp32 and
    bf16, lengths {0, 1, ps - 1, ps, ps + 1, mid, near capacity}) and 36 more
    at page 64 and W 2 / 5 / 17: Dh96 in fp32 / bf16 / fp16 and Dh64 in fp16;
    q and the window strided views of one fused qkv buffer; a second run
    bitwise equal; bf16 / fp16 within 2 ulps of the dtype of the fp32
    function (the plain version on the inputs widened to fp32) on entries of
    at least 1e-3 of the largest. Timed at page 64 for W 2, 5 and 17, fp32
    and bf16, Dh 64 and 96 (kernel, plain, SDPA over the gathered cache with
    the window scattered in and a [B, H, W, S] mask, the gather excluded).
    The kernels' rows of the result line are B4's shape (page 64, 8 pages per
    row, pool 17), W 5, fp32, Dh 64."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    timer = ctx["timer"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.default_rng(6)
    B, H, cap = 8, 12, 512
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # (page size, dtypes, head dim, windows): the 90 base cases, then 36 more
    groups = [(ps, ("float32", "bfloat16"), 64, (2, 3, 5, 9, 17)) for ps in (8, 64, 128)]
    groups += [(64, ("float32", "bfloat16", "float16"), 96, (2, 5, 17)),
               (64, ("float16",), 64, (2, 5, 17))]
    errs = {kind: 0.0 for kind in PAGED_KINDS}
    worst_ulp = {"bfloat16": 0.0, "float16": 0.0}
    n_cases = timed = 0
    for ps, dts, Dh, windows in groups:
        pages = cap // ps
        pool = 17 if ps == 64 else B * pages + 1
        lens_list = [0, 1, ps - 1, ps, ps + 1, cap // 2 + 7, cap - 9, cap - 1]
        tables_np = np.zeros((B, pages), np.int32)
        for b, n in enumerate(lens_list):
            used = min(-(-(n + 17) // ps), pages)  # the pages a window may commit to
            tables_np[b, :used] = rng.choice(np.arange(1, pool), used, replace=False)
        tables = torch.from_numpy(tables_np).cuda()
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        for dt in dts:
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
                for W in windows:
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
                    tag = f"{kind} ps{ps} Dh{Dh} W{W} {dt}"
                    n_cases += 1
                    check(torch.equal(out, again), f"verify {tag}: two runs differ")
                    check(err <= ATOL[dt], f"verify {tag}: max_abs_err {err} > {ATOL[dt]}")
                    ulps = None
                    if dt != "float32":  # against the fp32 function of the same inputs
                        pools = (k, v) if bits is not None else (k.float(), v.float())
                        ref32 = da.paged_verify_attention(
                            q.float(), *pools, lens, tables, wk.float(), wv.float(),
                            impl="gather", k_scales=ks, v_scales=vs)
                        ulps = ulp_err(torch, out[keep], ref32[keep], dtype)
                        worst_ulp[dt] = max(worst_ulp[dt], ulps)
                        check(ulps <= BWD_MAX_ULP, f"verify {tag}: {ulps} {dt} ulps of the "
                              "fp32 function")
                    if ps != 64 or W not in (2, 5, 17) or dt == "float16":
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
                    old = OLD_MS.get(f"verify {kind} {dt}") if (W, Dh) == (5, 64) else None
                    log(f"phase2 paged_verify_attention {kind} B{B} H{H} Dh{Dh} ps{ps} "
                        f"pages_per_seq{pages} pool{pool} W{W} lengths={lens_list} {dt} "
                        f"splits={da.split_plan(B * H, cap, sms)}: max_abs_err={err:.3e} "
                        + (f"max_ulp_err={ulps:.2f} " if ulps is not None else "")
                        + f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
                        f"library_ms(sdpa, gather excluded)={library_ms:.4f} "
                        f"bound_ms={bound_ms:.5f} ({bound_by}) "
                        f"kernel/sdpa={kernel_ms / library_ms:.3f}"
                        + (f" one_block_a_row_ms={old}" if old else ""))
                    if (W, dt, Dh) == (5, "float32", 64):
                        ctx[f"verify_{kind}"] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                                     library_ms=library_ms, bound_ms=bound_ms,
                                                     bound_by=bound_by)
                    del kc, vc, mask
    log(f"phase2 paged_verify_attention: {n_cases} cases within tolerance and bitwise on re-run "
        f"({timed} timed); max_abs_err dense/kv8/kv4 = "
        + "/".join(f"{errs[k]:.3e}" for k in PAGED_KINDS)
        + f"; largest ulps of the fp32 function bf16={worst_ulp['bfloat16']:.2f} "
        f"fp16={worst_ulp['float16']:.2f}")
    check(n_cases == 126, f"B5: {n_cases} cases, expected 90 + 36")

    # tables whose leading pages are the same physical pages in several
    # slots, as the prefix cache leaves them (phase 15): dense pools
    lens_list = ALIASED_LENS["B5"]
    tables = torch.from_numpy(_aliased_table(lens_list, 8, 17, 64, 2, rng, ahead=17)).cuda()
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        k, v = randn((H, 17, 64, 64), dtype), randn((H, 17, 64, 64), dtype)
        for W in (2, 5, 17):
            qkv = randn((B, W, 3 * H * 64), dtype)
            q, wk, wv = (x.reshape(B, W, H, 64) for x in qkv.split(H * 64, dim=-1))
            out = da.paged_verify_attention(q, k, v, lens, tables, wk, wv)
            again = da.paged_verify_attention(q, k, v, lens, tables, wk, wv)
            ref = da.paged_verify_attention(q, k, v, lens, tables, wk, wv, impl="gather")
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            errs["dense"] = max(errs["dense"], err)
            ulps = None
            if dt != "float32":  # against the fp32 function of the same inputs
                ref32 = da.paged_verify_attention(q.float(), k.float(), v.float(), lens, tables,
                                                  wk.float(), wv.float(), impl="gather")
                ulps = ulp_err(torch, out, ref32, dtype)
                check(ulps <= BWD_MAX_ULP, f"verify aliased W{W} {dt}: {ulps} ulps")
            log(f"phase2 paged_verify_attention dense aliased tables (rows 0-6 share pages "
                f"{tables[0, :2].tolist()}) B{B} H{H} Dh64 ps64 pool17 W{W} lengths={lens_list} "
                f"{dt}: max_abs_err={err:.3e} "
                + (f"max_ulp_err={ulps:.2f} " if ulps is not None else "")
                + f"bitwise_rerun={torch.equal(out, again)}")
            check(err <= ATOL[dt], f"verify aliased W{W} {dt}: max_abs_err {err}")
            check(torch.equal(out, again), f"verify aliased W{W} {dt}: two runs differ")
    for kind in PAGED_KINDS:
        ctx[f"verify_{kind}"]["max_abs_err"] = errs[kind]


def phase_kernels_bwd(torch, ctx, randn):
    """B2: the three backward kernels against their plain versions, a
    bitwise re-run, and their times beside the SDPA backward's. q/k/v are
    views of one fused [B, T, 3HD] buffer, as the model's qkv projection
    gives them. dq and dk/dv run on the tensor cores: for bf16 / fp16 inputs
    the 16-bit kernels (route ``tc``), for fp32 the 3xTF32 ones (route
    ``tf32``: also held to their CPU model, and a one-pass model must miss
    the bar; both bounds, three TF32 passes and one fp32 pass on the CUDA
    cores)."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    timer = ctx["timer"]
    # the training shape B8 T=S512 H12 D64 (bf16 is the main-path row, fp32
    # the fp32 training path's), the bottom-right causal offset T128 S512,
    # non-causal, D128, a ragged T100 S200, phase 10b's B2 x T4096 (64 k
    # tiles a q tile) and D96 (gpt2-760m's); then fp16 with dO 2^-8 of the
    # others' (small gradients: dS falls below fp16's normal range unless the
    # kernels scale its rows)
    cases = [(8, 512, 512, 12, 64, True, "float32"), (8, 512, 512, 12, 64, True, "bfloat16"),
             (8, 512, 512, 12, 64, True, "float16"),
             (4, 128, 512, 12, 64, True, "float32"), (4, 128, 512, 12, 64, True, "bfloat16"),
             (4, 128, 512, 12, 64, True, "float16"),
             (4, 256, 256, 12, 64, False, "bfloat16"), (4, 256, 256, 12, 64, False, "float16"),
             (4, 512, 512, 12, 128, True, "float32"), (4, 512, 512, 12, 128, True, "bfloat16"),
             (4, 512, 512, 12, 128, True, "float16"), (2, 100, 200, 12, 64, True, "bfloat16"),
             (2, 4096, 4096, 12, 64, True, "bfloat16"), (2, 4096, 4096, 12, 64, True, "float16"),
             # head dim 96 (gpt2-760m's H16)
             (4, 512, 512, 16, 96, True, "float32"), (4, 512, 512, 16, 96, True, "bfloat16"),
             (4, 512, 512, 16, 96, True, "float16"), (2, 100, 200, 16, 96, True, "bfloat16")]
    small_do = [(4, 512, 512, 12, 64, True, "float16"), (4, 512, 512, 16, 96, True, "float16")]
    errs = {name: 0.0 for name in ("delta", *BWD_TF32_KERNELS, *BWD_TC_KERNELS)}
    for (B, T, S, H, D, causal, dt), do_scale in ([(c, 1.0) for c in cases]
                                                  + [(c, 2.0**-8) for c in small_do]):
        dtype = getattr(torch, dt)
        tc = dt != "float32"
        route = "tc" if tc else "tf32"
        names = {"delta": "delta", "dq": f"dq_{route}", "dkv": f"dkv_{route}"}
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
        delta_bitwise = torch.equal(delta, fa.flash_attention_bwd_delta(o, do))
        delta_ref = fa.flash_attention_bwd_delta_ref(o, do)
        ref = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
        rel = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(first, ref)]
        absd = [(a.float() - b.float()).abs().max().item() for a, b in zip(first, ref)]
        ulps = cast_ulps = model_rel = one_pass_rel = None
        if not tc:  # against the 3xTF32 model and one TF32 pass, which must miss
            model = fa.flash_attention_bwd_tf32_ref(q, k, v, o, lse, do, causal)
            model_rel = max(((a - b).abs().max() / b.abs().max()).item()
                            for a, b in zip(first, model))
            one = fa.flash_attention_bwd_tf32_ref(q, k, v, o, lse, do, causal, passes=1)
            one_pass_rel = min(((a - b).abs().max() / b.abs().max()).item()
                               for a, b in zip(one, ref))
            del model, one
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
        bounds = flash_bwd_bounds(B, T, S, H, D, causal, dt if tc else "tf32x3",
                                  q.element_size())
        cc = flash_bwd_bounds(B, T, S, H, D, causal, dt, q.element_size())
        pair_ms = kernel_ms["dq"] + kernel_ms["dkv"]
        log(f"phase2 flash_attention_bwd B{B} T{T} S{S} H{H} D{D} causal={causal} {dt} "
            + (f"dO_scale={do_scale} " if do_scale != 1.0 else "")
            + f"route={route}: "
            f"rel_err dq/dk/dv={rel[0]:.3e}/{rel[1]:.3e}/{rel[2]:.3e} "
            f"max_abs_err dq/dk/dv={absd[0]:.3e}/{absd[1]:.3e}/{absd[2]:.3e} "
            + (f"max_ulp_err dq/dk/dv={ulps[0]:.2f}/{ulps[1]:.2f}/{ulps[2]:.2f} "
               f"single_cast_dv_ulp_err={cast_ulps:.2f} " if ulps else "")
            + (f"tf32_model_rel_err={model_rel:.3e} one_pass_model_rel_err={one_pass_rel:.3e} "
               if model_rel is not None else "")
            + f"delta_err={delta_err:.3e} delta_bitwise_rerun={delta_bitwise} "
            f"bitwise_rerun={bitwise} launches={counted} "
            + " ".join(f"{n}: kernel_ms={kernel_ms[n]:.4f} plain_ms={plain_ms[n]:.4f} "
                       f"bound_ms={bounds[n][0]:.4f} ({bounds[n][1]})" for n in BWD_KERNELS)
            + f" delta_einsum_ms={delta_library_ms:.4f}"
            f" sum_kernel_ms={sum(kernel_ms.values()):.4f} "
            f"bwd_bound_ms={bounds['bwd_total'][0]:.4f} ({bounds['bwd_total'][1]}) "
            + ("" if tc else "cuda_core_bound_ms dq/dkv="
               f"{cc['dq'][0]:.4f}/{cc['dkv'][0]:.4f} ({cc['dq'][1]}) ")
            + f"dq+dkv_ms={pair_ms:.4f} sdpa_backward_ms={library_ms:.4f} "
            f"dq+dkv/sdpa_backward={pair_ms / library_ms:.3f}")
        check(bitwise, f"flash backward {B, T, S, D, dt}: two runs differ")
        check(delta_bitwise, f"flash backward delta {B, T, S, D, dt}: two runs differ")
        check(counted == expected, f"flash backward {B, T, S, D, dt}: launches {counted}")
        check(max(rel) <= BWD_RTOL[dt], f"flash backward {B, T, S, D, dt}: rel error {rel}")
        check(ulps is None or max(ulps) <= BWD_MAX_ULP,
              f"flash backward {B, T, S, D, dt, do_scale}: {ulps} {dt} ulps")
        check(model_rel is None or (model_rel <= BWD_RTOL[dt] and one_pass_rel > BWD_RTOL[dt]),
              f"flash backward {B, T, S, D, dt}: {model_rel} from the 3xTF32 model, one "
              f"TF32 pass {one_pass_rel} (must exceed {BWD_RTOL[dt]})")
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


def ulp_of_max_err(torch, x, ref, dtype) -> float:
    """Largest |x - ref| over all entries in ulps of ``dtype`` at ref's
    largest entry (the measure of the single-cast checks)."""
    r = ref.float()
    _, ex = torch.frexp(r.abs().max())
    ulp = torch.finfo(dtype).eps * torch.ldexp(torch.ones((), device=r.device), ex - 1)
    return ((x.float() - r).abs().max() / ulp).item()


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


def bs_visited_tiles(layout, block, causal):
    """The (64-query, 64-key) tile pairs of one batch row that B9's backward
    kernels visit: those holding an active block (of several blocks at 16 /
    32), less those wholly above the diagonal under causal. Their products
    cost 64 x 64 pairs each, whatever the layout keeps of them."""
    lay = np.asarray(layout).astype(bool)
    H, n, _ = lay.shape
    if block >= 64:
        tiles = lay.repeat(block // 64, 1).repeat(block // 64, 2)
    else:
        g = 64 // block
        nt = -(-n // g)
        padded = np.zeros((H, nt * g, nt * g), bool)
        padded[:, :n, :n] = lay
        tiles = padded.reshape(H, nt, g, nt, g).any(axis=(2, 4))
    if causal:
        tiles = tiles & np.tril(np.ones(tiles.shape[1:], bool))[None]
    return int(tiles.sum())


def _bs_cases():
    """The B9 rows of phase 2: (label, layout, block, B, H, D, causal, dtype,
    dO scale). Every pass takes the tensor cores in every case
    (``bs_route``)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                          BSLongformerSparsityConfig,
                                                          FixedSparsityConfig,
                                                          LocalSlidingWindowSparsityConfig,
                                                          VariableSparsityConfig)

    fixed = FixedSparsityConfig(**SPARSE_GPT_LAYOUT)
    fixed_d128 = FixedSparsityConfig(num_heads=8, block=128)
    fixed_d96 = FixedSparsityConfig(**{**SPARSE_GPT_LAYOUT, "num_heads": 16})
    bigbird = BigBirdSparsityConfig(num_heads=12, block=64, different_layout_per_head=True,
                                    attention="unidirectional").make_layout(1024)
    variable = VariableSparsityConfig(
        num_heads=12, block=16, num_random_blocks=2, local_window_blocks=[4],
        global_block_indices=[0], attention="unidirectional").make_layout(512)
    longformer = BSLongformerSparsityConfig(num_heads=12, block=32,
                                            num_sliding_window_blocks=5).make_layout(512)
    sliding_32 = LocalSlidingWindowSparsityConfig(
        num_heads=12, block=32, num_sliding_window_blocks=4).make_layout(512)
    # an empty block row (head 1) and an empty block column (head 0)
    empty_128 = np.tril(np.ones((12, 8, 8), np.int64))
    empty_128[1, 3] = 0
    empty_128[0, :, 2] = 0
    empty_64 = np.ones((12, 16, 16), np.int64)
    empty_64[1, 5] = 0
    empty_64[0, :, 9] = 0
    return [
        # (i) phase 10a's shape (the fp32 main-path row); (ii) phase 10b's
        # (the bf16 main-path row), in bf16 and fp16; phase 10c's (the
        # small-block main-path row)
        ("fixed-uni-128 (10a)", fixed.make_layout(1024), 128, 2, 12, 64, True, "float32", 1.0),
        ("fixed-uni-128 (10b, main path)", fixed.make_layout(4096), 128, 2, 12, 64, True,
         "bfloat16", 1.0),
        ("fixed-uni-128 (10b)", fixed.make_layout(4096), 128, 2, 12, 64, True, "float16", 1.0),
        ("fixed-uni-32 (10c)", FixedSparsityConfig(**SMALL_BLOCK_LAYOUT).make_layout(1024), 32,
         2, 12, 64, True, "bfloat16", 1.0),
        # (iii) bench.py's row: the bidirectional default under causal=True
        ("fixed-bi-128 bench", FixedSparsityConfig(num_heads=16, block=128).make_layout(1024),
         128, 4, 16, 64, True, "bfloat16", 1.0),
        # (iv) a layout per head
        ("bigbird-per-head-64", bigbird, 64, 2, 12, 64, True, "float32", 1.0),
        ("bigbird-per-head-64", bigbird, 64, 2, 12, 64, True, "bfloat16", 1.0),
        ("bigbird-per-head-64 D96", bigbird, 64, 2, 12, 96, True, "float16", 1.0),
        # (v) small blocks: the backward's 64-token tiles hold several blocks
        ("variable-16", variable, 16, 2, 12, 64, True, "float32", 1.0),
        ("variable-16", variable, 16, 2, 12, 64, True, "bfloat16", 1.0),
        ("variable-16 D96", variable, 16, 2, 12, 96, True, "float16", 1.0),
        ("variable-16 D128", variable, 16, 2, 12, 128, True, "float32", 1.0),
        ("longformer-32", longformer, 32, 2, 12, 64, False, "float32", 1.0),
        ("longformer-32", longformer, 32, 2, 12, 64, False, "bfloat16", 1.0),
        ("sliding-16", LocalSlidingWindowSparsityConfig(
            num_heads=12, block=16, num_sliding_window_blocks=8).make_layout(512), 16, 2, 12, 64,
         True, "bfloat16", 1.0),
        ("sliding-32", sliding_32, 32, 2, 12, 64, True, "float32", 1.0),
        ("sliding-32 D96 small dO", sliding_32, 32, 2, 12, 96, True, "float16", 2.0**-8),
        # (vi) not causal, and head dim 128
        ("longformer-128", BSLongformerSparsityConfig(num_heads=12, block=128)
         .make_layout(2048), 128, 2, 12, 64, False, "bfloat16", 1.0),
        ("longformer-64 D96", BSLongformerSparsityConfig(num_heads=12, block=64)
         .make_layout(1024), 64, 2, 12, 96, False, "float16", 1.0),
        ("fixed-bi-128 D128 noncausal", fixed_d128.make_layout(1024), 128, 2, 8, 128, False,
         "float32", 1.0),
        ("fixed-bi-128 D128 noncausal", fixed_d128.make_layout(1024), 128, 2, 8, 128, False,
         "bfloat16", 1.0),
        # (vii) head dim 96: the fixed pattern at gpt2-760m's width (H16)
        ("fixed-uni-128 D96", fixed_d96.make_layout(1024), 128, 2, 16, 96, True, "float32",
         1.0),
        ("fixed-uni-128 D96", fixed_d96.make_layout(1024), 128, 2, 16, 96, True, "bfloat16",
         1.0),
        # (viii) empty block rows and columns: o = 0, lse = -1e30, dq / dk / dv = 0
        ("empty-row-col-128", empty_128, 128, 2, 12, 64, True, "bfloat16", 1.0),
        ("empty-row-col-64", empty_64, 64, 2, 12, 64, False, "float16", 1.0),
        # (ix) fp16 with small gradients (dS below fp16's normal range unless
        # the kernels scale its rows)
        ("fixed-uni-128 small dO", fixed.make_layout(1024), 128, 2, 12, 64, True, "float16",
         2.0**-8),
        ("bigbird-per-head-64 D96 small dO", bigbird, 64, 2, 12, 96, True, "float16", 2.0**-8),
    ]


def _bs_counts(bs):
    return {name: getattr(bs, c) for name, c in BS_COUNTERS.items()}


# the phase 2 rows that give the {"kernels": [...]} line B9's numbers, by
# label, dtype and the kernels' keys there: 10a's (the 3xTF32 kernels), 10b's
# (the tensor cores at blocks of 128) and 10c's (the tensor-core kernels'
# sub-block-mask instances)
BS_ROWS = {
    ("fixed-uni-128 (10a)", "float32"): {"fwd": "bs_tf32_fwd", "dq": "bs_tf32_dq",
                                         "dkv": "bs_tf32_dkv"},
    ("fixed-uni-128 (10b, main path)", "bfloat16"): {"fwd": "bs_tc_fwd", "dq": "bs_tc_dq",
                                                     "dkv": "bs_tc_dkv"},
    ("fixed-uni-32 (10c)", "bfloat16"): {"fwd": "bs_tc_small_fwd", "dq": "bs_tc_small_dq",
                                         "dkv": "bs_tc_small_dkv"}}


def phase_kernels_blocksparse(torch, ctx, randn):
    """B9: the forward, dq and dk/dv kernels against their plain versions on
    q/k/v views of one fused [B, T, 3HD] buffer, each pass through its route
    (``bs_route``, checked by the counters), the forward and the backward
    twice (bitwise), their times beside one SDPA call with the expanded
    boolean layout (and causal) mask (mask construction excluded) and its
    backward, and beside B1 / B2's dense causal times at the same shape.
    bf16 / fp16 are also held to at most 2 ulps of the dtype of the fp32
    plain versions on entries of at least 1e-3 of the largest (and, up to T
    2048, of the split plain versions that model the tensor cores'
    rounding), where a single cast of P must miss that bar (in o and dV);
    fp32 (3xTF32) o and gradients to the plain versions and to
    ``blocksparse_attention_fwd_tf32_ref`` / ``_bwd_tf32_ref`` within 5e-5
    of the largest entry, lse within 1e-4 of both. Every case prints the
    share of the visited tiles' products its layout keeps."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    timer = ctx["timer"]
    errs = {key: 0.0 for keys in BS_ROWS.values() for key in keys.values()}
    for label, layout, block, B, H, D, causal, dt, do_scale in _bs_cases():
        dtype = getattr(torch, dt)
        route = (bs.bs_route(dtype, block, D, "fwd"), bs.bs_route(dtype, block, D, "bwd"))
        T = layout.shape[1] * block
        qkv = randn((B, T, 3 * H * D), dtype)
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        do = randn((B, T, H, D), dtype) * do_scale
        tables = bs.device_tables(layout, block, "cuda")
        scale = 1.0 / math.sqrt(D)
        before = _bs_counts(bs)
        o, lse = bs.blocksparse_attention_fwd(q, k, v, layout, block, causal, tables=tables)
        o2, lse2 = bs.blocksparse_attention_fwd(q, k, v, layout, block, causal, tables=tables)
        first = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal,
                                             tables=tables)
        again = bs.blocksparse_attention_bwd(q, k, v, o, lse, do, layout, block, causal,
                                             tables=tables)
        torch.cuda.synchronize()
        counted = {c: n - before[c] for c, n in _bs_counts(bs).items()}
        expected = {c: 0 for c in counted}
        expected.update({f"fwd_{route[0]}": 2, f"dq_{route[1]}": 2, f"dkv_{route[1]}": 2})
        fwd_bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
        bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
        del o2, lse2
        o_ref, lse_ref = bs.blocksparse_attention_fwd_ref(q, k, v, layout, block, causal)
        dq_ref, delta = bs.blocksparse_attention_bwd_dq_ref(q, k, v, o, do, lse, layout, block,
                                                            causal, scale)
        ref = (dq_ref, *bs.blocksparse_attention_bwd_dkv_ref(q, k, v, do, lse, delta, layout,
                                                            block, causal, scale))
        o_err = (o.float() - o_ref.float()).abs().max().item()
        o_rel = o_err / o_ref.float().abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        rel = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(first, ref)]
        absd = [(a.float() - b.float()).abs().max().item() for a, b in zip(first, ref)]
        ulps = split_ulps = cast_ulps = o_cast_ulps = model_rel = None
        fwd_model_rel = fwd_model_lse_err = None
        if dt == "float32":  # the CPU models of the 3xTF32 arithmetic
            o_model, lse_model = bs.blocksparse_attention_fwd_tf32_ref(q, k, v, layout, block,
                                                                       causal)
            fwd_model_rel = ((o - o_model).abs().max() / o_model.abs().max()).item()
            fwd_model_lse_err = (lse - lse_model).abs().max().item()
            del o_model, lse_model
            model = bs.blocksparse_attention_bwd_tf32_ref(q, k, v, o, lse, do, layout, block,
                                                          causal)
            model_rel = [((a - b).abs().max() / b.abs().max()).item()
                         for a, b in zip(first, model)]
            del model
        else:  # the fp32 function, the split models and a single cast of P
            ulps = [ulp_err(torch, o, o_ref, dtype)] + [ulp_err(torch, a, b, dtype)
                                                        for a, b in zip(first, ref)]
            p_cast = bs._probs(q, k, lse, layout, block, causal, scale).to(dtype).float()
            o_cast = torch.einsum("bhts,bshd->bthd", p_cast, v.float()).to(dtype)
            o_cast_ulps = ulp_err(torch, o_cast, o_ref, dtype)
            dv_cast = torch.einsum("bhts,bthd->bshd", p_cast, do.float()).to(dtype)
            cast_ulps = ulp_err(torch, dv_cast, ref[2], dtype)
            del p_cast, o_cast, dv_cast
            if T <= 2048:
                split = bs.blocksparse_attention_bwd_split_ref(q, k, v, o, lse, do, layout,
                                                               block, causal)
                o_split, _ = bs.blocksparse_attention_split_ref(q, k, v, layout, block, causal)
                split_ulps = [ulp_err(torch, o, o_split, dtype)] + [
                    ulp_err(torch, a, b, dtype) for a, b in zip(first, split)]
                del o_split, split
        keys = BS_ROWS.get((label, dt), {})
        small = "_small" if block < 64 and route[1] == "tc" else ""  # the mask instances
        for n, e in (("fwd", o_err), ("dq", absd[0]), ("dkv", max(absd[1], absd[2]))):
            key = f"bs_{route[0] if n == 'fwd' else route[1]}{small}_{n}"
            if key in errs:
                errs[key] = max(errs[key], e)
        empty_ok = True
        if label.startswith("empty"):  # the empty block row of head 1 and column of head 0
            lay = np.asarray(layout)
            row = int(np.nonzero(lay[1].sum(1) == 0)[0][0])
            col = int(np.nonzero(lay[0].sum(0) == 0)[0][0])
            rows = slice(row * block, (row + 1) * block)
            cols = slice(col * block, (col + 1) * block)
            empty_ok = bool((o[:, rows, 1] == 0).all() and (lse.view(B, H, T)[:, 1, rows]
                                                             == -1e30).all()
                            and (first[0][:, rows, 1] == 0).all()
                            and (first[1][:, cols, 0] == 0).all()
                            and (first[2][:, cols, 0] == 0).all())
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
        tiles = bs_visited_tiles(layout, block, causal) * B
        bounds = bs_bounds(B, T, H, D, pairs, dt, q.element_size())
        cuda_core_fwd = bounds["fwd"]
        if dt == "float32":  # every pass as three TF32 passes on the tensor cores
            bounds = bs_bounds(B, T, H, D, pairs, "tf32x3", q.element_size())
        log(f"phase2 blocksparse_attention {label} B{B} T{T} H{H} D{D} block{block} "
            f"causal={causal} {dt} " + (f"dO_scale={do_scale} " if do_scale != 1.0 else "")
            + f"route fwd/bwd={route[0]}/{route[1]} launches={counted}: "
            f"active_blocks={int(np.asarray(layout).sum())} "
            f"visible_pairs={pairs} visited_tiles={tiles} "
            f"visited_share={pairs / (tiles * 64 * 64):.4f} o_err={o_err:.3e} "
            f"o_rel_err={o_rel:.3e} lse_err={lse_err:.3e} fwd_bitwise_rerun={fwd_bitwise} "
            + (f"fwd_tf32_model_rel_err={fwd_model_rel:.3e} "
               f"fwd_tf32_model_lse_err={fwd_model_lse_err:.3e} "
               f"cuda_core_fwd_bound_ms={cuda_core_fwd[0]:.4f} ({cuda_core_fwd[1]}) "
               if fwd_model_rel is not None else "")
            + f"rel_err dq/dk/dv={rel[0]:.3e}/{rel[1]:.3e}/{rel[2]:.3e} "
            f"max_abs_err dq/dk/dv={absd[0]:.3e}/{absd[1]:.3e}/{absd[2]:.3e} "
            + (f"tf32_model_rel_err dq/dk/dv={'/'.join(f'{u:.3e}' for u in model_rel)} "
               if model_rel else "")
            + (f"max_ulp_err o/dq/dk/dv={'/'.join(f'{u:.2f}' for u in ulps)} "
               f"single_cast_o/dv_ulp_err={o_cast_ulps:.2f}/{cast_ulps:.2f} " if ulps else "")
            + (f"split_model_ulp_err o/dq/dk/dv="
               f"{'/'.join(f'{u:.2f}' for u in split_ulps)} " if split_ulps else "")
            + f"bitwise_rerun={bitwise} "
            + " ".join(f"{n}: kernel_ms={kernel_ms[n]:.4f} plain_ms={plain_ms[n]:.4f} "
                       f"bound_ms={bounds[n][0]:.4f} ({bounds[n][1]})" for n in BS_KERNELS)
            + f" sum_bwd_kernel_ms={kernel_ms['dq'] + kernel_ms['dkv']:.4f} "
            f"bwd_bound_ms={bounds['bwd_total'][0]:.4f} ({bounds['bwd_total'][1]}) "
            f"sdpa_masked_ms={sdpa_ms:.4f} sdpa_masked_backward_ms={sdpa_bwd_ms:.4f} "
            f"bwd/sdpa_bwd={(kernel_ms['dq'] + kernel_ms['dkv']) / sdpa_bwd_ms:.3f} "
            f"b1_dense_causal_ms={flash_ms:.4f} b2_dense_causal_ms={flash_bwd_ms:.4f}")
        tag = f"blocksparse {label} {dt}"
        check(counted == expected, f"{tag}: routes {route}, launches {counted}")
        check(o_err <= ATOL[dt], f"{tag}: o error {o_err} > {ATOL[dt]}")
        check(lse_err <= LSE_ATOL, f"{tag}: lse error {lse_err}")
        check(fwd_bitwise, f"{tag}: two forward runs differ")
        check(bitwise, f"{tag}: two backward runs differ")
        check(fwd_model_rel is None or (o_rel <= BWD_RTOL[dt] and fwd_model_rel <= BWD_RTOL[dt]
                                        and fwd_model_lse_err <= LSE_ATOL),
              f"{tag}: o {o_rel} from the plain version, {fwd_model_rel} (lse "
              f"{fwd_model_lse_err}) from the 3xTF32 model")
        check(max(rel) <= BWD_RTOL[dt], f"{tag}: rel error {rel}")
        check(model_rel is None or max(model_rel) <= BWD_RTOL[dt],
              f"{tag}: {model_rel} from the 3xTF32 model")
        check(ulps is None or max(ulps) <= BWD_MAX_ULP, f"{tag}: {ulps} ulps of the fp32 function")
        check(split_ulps is None or max(split_ulps) <= BWD_MAX_ULP,
              f"{tag}: {split_ulps} ulps of the split model")
        check(ulps is None or (cast_ulps > BWD_MAX_ULP and o_cast_ulps > BWD_MAX_ULP),
              f"{tag}: a single cast of P is within {o_cast_ulps} / {cast_ulps} ulps (o / dV), "
              "the ulp check cannot tell it from the hi/lo split")
        check(empty_ok, f"{tag}: an empty block row or column is not zero")
        for n, key in keys.items():
            ctx[key] = dict(ms=kernel_ms[n], plain_ms=plain_ms[n],
                            library_ms=sdpa_ms if n == "fwd" else sdpa_bwd_ms,
                            bound_ms=bounds[n][0], bound_by=bounds[n][1])
        del q, k, v, qkv, do, o, lse, first, again, delta
        torch.cuda.empty_cache()
    for key, err in errs.items():
        ctx[key]["max_abs_err"] = err


def _reset_counts():
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im

    fa.fwd_tf32_launches = fa.fwd_tc_launches = fa.fwd_tc_stochastic_launches = 0
    fa.bwd_delta_launches = fa.bwd_dq_tf32_launches = fa.bwd_dkv_tf32_launches = 0
    fa.bwd_dq_tc_launches = fa.bwd_dkv_tc_launches = 0
    fa.bwd_dq_tc_stochastic_launches = fa.bwd_dkv_tc_stochastic_launches = 0
    da.launches = 0
    da.paged_launches = da.paged_kv8_launches = da.paged_kv4_launches = 0
    da.verify_launches = da.verify_kv8_launches = da.verify_kv4_launches = 0
    for counter in QMM_COUNTERS.values():
        setattr(im, counter, 0)
    dqm.tc_launches = 0
    for counter in BS_COUNTERS.values():
        setattr(bs, counter, 0)
    return fa, da


def _fwd_launches(fa):
    return {"fwd_tf32": fa.fwd_tf32_launches, "fwd_tc": fa.fwd_tc_launches,
            "fwd_tc_stochastic": fa.fwd_tc_stochastic_launches}


def _bwd_launches(fa):
    return {"delta": fa.bwd_delta_launches, "dq_tf32": fa.bwd_dq_tf32_launches,
            "dkv_tf32": fa.bwd_dkv_tf32_launches, "dq_tc": fa.bwd_dq_tc_launches,
            "dkv_tc": fa.bwd_dkv_tc_launches, "dq_tc_stochastic": fa.bwd_dq_tc_stochastic_launches,
            "dkv_tc_stochastic": fa.bwd_dkv_tc_stochastic_launches}


def _flash_launches(fa):
    return {**_fwd_launches(fa), **_bwd_launches(fa)}


def _flash_path(dtype):
    """The flash kernels a path of ``dtype`` (or "stochastic") launches."""
    return (*FWD_PATH[dtype], *BWD_PATH[dtype])


def path_launches(launches, n, path):
    """The exact launch counts of a run: ``n`` for each counter in ``path``,
    0 for every other (the other dtype's backward kernels among them)."""
    return {name: n if name in path else 0 for name in launches}


def flash_profile(kernels, busy_ms: float) -> str:
    """B1's forward and B2's kernels (delta, dq, dk/dv) in one step's
    profile: their device ms, each and together, and their shares of the
    device-busy time."""
    parts = []
    for tag, key in (("b1", "flash_fwd"), ("b2", "flash_bwd")):
        rows = [(name, ms) for name, _, ms in kernels if key in name]
        total = sum(ms for _, ms in rows)
        each = "; ".join(f"{name.replace('(anonymous namespace)::', '')[:32]} {ms:.3f} ms"
                         for name, ms in rows)
        share = f"{total / busy_ms:.3f}" if busy_ms else "not measured"
        parts.append(f"{tag}_ms={total:.3f} {tag}_share_of_busy={share} ({each})")
    return " ".join(parts)


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
        flash_launches, decode_launches = _fwd_launches(fa), da.launches
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
    want = path_launches(flash_launches, cfg.n_layer, FWD_PATH["float32"])
    check(flash_launches == want, f"flash launches {flash_launches}, expected {want}")
    check(not any(bwd_launches.values()), f"no_grad scoring ran the backward: {bwd_launches}")
    ctx["flash"]["launches"] = flash_launches["fwd_tf32"]


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
        decode_launches, flash_launches = da.launches, sum(_fwd_launches(fa).values())
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
            ctx["greedy4"] = (prompt, out)  # phase 14's degenerate samplers return these
        else:
            ctx["decode"]["launches"] = decode_launches


def _decode_profile(torch, engine, prompt, steps: int, sink=None, name=None,
                    counter=None) -> str:
    """Device breakdown of ``steps`` cached single-token forwards after a
    prefill of ``prompt``, as generate runs them (the profiler's kernel rows
    also appended to ``sink``; with ``name`` and ``counter``, from a trace
    that holds every counted launch of those kernels, ``complete_trace``)."""
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
        if counter is None:
            kernels = device_kernels(torch, decode)
        else:
            kernels = complete_trace(torch, decode, name, counter)[0]
        if sink is not None:
            sink.extend(kernels)
        return device_breakdown(torch, decode, float(np.median(walls[1:])) * 1e3,
                                kernels=kernels)


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
        launches = _flash_launches(fa)
        runs[use_flash] = ([m["loss"].item() for m in metrics],
                           [m["grad_norm"].item() for m in metrics], launches)
        del engine
    (loss_k, norm_k, launches), (loss_p, norm_p, plain_launches) = runs[None], runs[False]
    ctx["train5a"] = (batches, loss_k, norm_k, launches)  # phase 13c's unchunked run
    log(f"phase5a train fp32 gpt2-125m B4xT512 AdamW clip1.0: losses={loss_k} "
        f"plain_losses={loss_p} grad_norms={norm_k} plain_grad_norms={norm_p} "
        f"launches over 5 micro-steps={launches} plain-path launches={plain_launches}")
    check(np.allclose(loss_k, loss_p, rtol=1e-4, atol=0), f"fp32 losses differ: {loss_k} vs {loss_p}")
    check(np.allclose(norm_k, norm_p, rtol=1e-3, atol=0), f"fp32 grad norms differ: {norm_k} vs {norm_p}")
    expected = path_launches(launches, 5 * cfg.n_layer, _flash_path("float32"))
    check(launches == expected, f"launches over 5 fp32 micro-steps {launches}, expected {expected}")
    check(not any(plain_launches.values()), f"plain path launched kernels: {plain_launches}")
    for n in BWD_TF32_KERNELS:  # the 3xTF32 kernels' main path
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
    launches = _flash_launches(fa)
    tokens_per_s = engine.tokens_per_sec()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady_ms = float(np.median(step_ms[1:]))
    ctx["train5b"] = dict(step_ms=steady_ms, host_ms=float(np.median(host_ms[1:])),
                          tokens_per_s=tokens_per_s, peak_gb=peak_gb)
    kernels = device_kernels(torch, lambda: engine.train_batch(batch))
    attn_ms = sum(ms for name, _, ms in kernels if "flash_" in name)
    busy_ms = sum(ms for _, _, ms in kernels)
    ctx["train5b"]["flash"] = flash_profile(kernels, busy_ms)
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
        + f" {ctx['train5b']['flash']}")
    check(abs(losses[0] - math.log(V)) < 0.5, f"bf16 step-1 loss {losses[0]} far from ln(V)")
    check(losses[-1] < losses[0], f"bf16 loss did not fall: {losses}")
    check(all(math.isfinite(x) for x in losses + norms), "bf16 loss or grad norm not finite")
    expected = path_launches(launches, 10 * cfg.n_layer, _flash_path("bfloat16"))
    check(launches == expected, f"launches over 10 bf16 steps {launches}, expected {expected}")
    for n in BWD_PATH["bfloat16"]:  # delta and the tensor-core kernels' main path
        ctx[f"bwd_{n}"]["launches"] = launches[n]
    ctx["flash_tc"]["launches"] = launches["fwd_tc"]
    del engine
    torch.cuda.empty_cache()
    train5b_batch = ctx["train5b_batch"] = batch

    # (c) gas 2 x micro 4 and gas 1 x micro 8 over the same 8 rows (fp32):
    # three micro-steps, each through the 3xTF32 flash kernels
    rows = rng.integers(0, V, (8, 512)).astype(np.int32)
    e_gas = _engine(_train_config(4, gas=2), cfg)
    fa, _ = _reset_counts()  # the fp32 accumulation main path
    n_gas = e_gas.train_batch({"input_ids": rows.reshape(2, 4, 512)})["grad_norm"].item()
    del e_gas
    e_one = _engine(_train_config(8), cfg)
    n_one = e_one.train_batch({"input_ids": rows})["grad_norm"].item()
    torch.cuda.synchronize()
    launches = _flash_launches(fa)
    del e_one
    torch.cuda.empty_cache()
    log(f"phase5c grad_norm gas2 x micro4={n_gas:.6f} gas1 x micro8={n_one:.6f} "
        f"rel_diff={abs(n_gas - n_one) / n_one:.3e} launches over 3 micro-steps={launches}")
    check(abs(n_gas - n_one) <= 1e-3 * n_one, f"gas grad norms differ: {n_gas} vs {n_one}")
    expected = path_launches(launches, 3 * cfg.n_layer, _flash_path("float32"))
    check(launches == expected, f"5c launches {launches}, expected {expected}")

    # (d) stochastic_mode: 5b's configuration and batch with
    # GPTConfig.stochastic_mode, 5 steps through the single-cast instances
    engine = _engine(_train_config(8, bf16={"enabled": True}, zero_optimization={"stage": 2}),
                     dataclasses.replace(cfg, stochastic_mode=True))
    torch.cuda.synchronize()
    fa, _ = _reset_counts()  # the stochastic_mode training main path
    losses, norms, step_ms, host_ms = _timed_steps(torch, engine, train5b_batch, 5)
    launches = _flash_launches(fa)
    del engine
    torch.cuda.empty_cache()
    steady_ms = float(np.median(step_ms[1:]))
    log(f"phase5d train bf16 master zero2 stochastic_mode gpt2-125m B8xT512: losses={losses} "
        f"grad_norms={norms} launches over 5 steps={launches} step_ms (CUDA events, median "
        f"of steps 2-5)={steady_ms:.3f} step_ms_all={[round(x, 3) for x in step_ms]} "
        f"host_issue_ms={float(np.median(host_ms[1:])):.3f}; phase5b in this run: "
        f"step_ms={ctx['train5b']['step_ms']:.3f}")
    check(abs(losses[0] - math.log(V)) < 0.5, f"5d step-1 loss {losses[0]} far from ln(V)")
    check(losses[-1] < losses[0], f"5d loss did not fall: {losses}")
    check(all(math.isfinite(x) for x in losses + norms), "5d loss or grad norm not finite")
    expected = path_launches(launches, 5 * cfg.n_layer, _flash_path("stochastic"))
    check(launches == expected, f"launches over 5 stochastic steps {launches}, expected {expected}")


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
           system_prompt=None, fail_blocks=(), monitor=None, **over):
    """One ``run_continuous`` of an open-loop workload (seed 0; by default
    the bench's: 24 requests at 8 rps, prompts 32-128, generations 16-96,
    each prompt behind ``system_prompt`` where one is given) after
    ``warmup``, with the launch counts set to 0 just before and read just
    after. A decode block of a size in ``fail_blocks`` raises before it
    launches anything (an injected dispatch fault); otherwise the run must
    record no ``dispatch_error`` and no ``dispatch_failed``, so no retry hides
    a failed launch. Checks what the path must launch: B4 12 times a decode step,
    B5 12 times a verify window (by pool kind; neither on the gather path),
    B3 12 times a single-token draft-model forward and never otherwise, B1
    never, and over a quantized tree, in every prefill forward, decode step,
    verify window and draft forward, B6/B7 4 times a layer by the route of
    its rows (``_qmm_expected``). Returns the report, the requests' tokens,
    the requests, the launches (B6/B7 by route and path, and the prefill
    forwards by rows) and the engine."""
    from deepspeed_tpu_torch.inference.serving import (ServingConfig, ServingEngine,
                                                       make_open_loop_workload, run_continuous)

    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im

    eng = ServingEngine(cfg, params, ServingConfig(**{**serve_cfg, "dtype": dtype, **over}),
                        draft=draft, monitor=monitor)
    eng.warmup()
    decode, verify, forward_with_cache = eng.decode, eng.verify, gpt.forward_with_cache
    count = {"steps": 0, "windows": 0, "draft_tokens": 0, "borrowed_preemptions": 0}
    blocks = {}  # decode block size -> launched blocks
    qmm = {f"{k}_in_{where}": 0 for k in QMM_COUNTERS
           for where in ("prefill", "decode", "verify", "draft")}
    prefill_rows = {}  # rows of a prefill forward -> forwards
    wrong = []  # calls whose B6/B7 launches differ from their route's

    def qmm_counted(fn, where, params_, rows, n, *args, **kw):
        """Run fn; add its B6/B7 launches to ``where`` and check them against
        ``n`` forwards of ``rows`` rows over ``params_``."""
        before = {k: getattr(im, c) for k, c in QMM_COUNTERS.items()}
        out = fn(*args, **kw)
        moved = {k: getattr(im, c) - before[k] for k, c in QMM_COUNTERS.items()}
        for k, v in moved.items():
            qmm[f"{k}_in_{where}"] += v
        want = _qmm_expected(torch, cfg, params_, rows, eng.dtype, n)
        if moved != want and len(wrong) < 5:
            wrong.append(f"{where} rows={rows} x{n}: {moved}, expected {want}")
        return out

    def counted(fn, where, n, rows):
        def call(*args, **kw):
            count[where] += n(*args, **kw)
            path = "decode" if where == "steps" else "verify"
            return qmm_counted(fn, path, eng.params, rows(*args, **kw), n(*args, **kw),
                               *args, **kw)
        return call

    def counted_forward(cfg_, params_, ids, cache):
        rows = int(np.prod(ids.shape))
        draft_token = int(np.asarray(ids.shape)[-1] == 1)
        count["draft_tokens"] += draft_token
        if not draft_token:
            prefill_rows[rows] = prefill_rows.get(rows, 0) + 1
        return qmm_counted(forward_with_cache, "draft" if draft_token else "prefill", params_,
                           rows, 1, cfg_, params_, ids, cache)

    counted_decode = counted(decode, "steps", lambda *a, steps=1: steps,
                             lambda *a, **k: eng.num_slots)

    def decode_block(*args, steps=1, **kw):
        if steps in fail_blocks:
            raise RuntimeError(f"injected fault: a decode block of {steps} steps")
        blocks[steps] = blocks.get(steps, 0) + 1
        return counted_decode(*args, steps=steps, **kw)

    make_scheduler = eng.make_scheduler

    def make_counted_scheduler(*args, **kw):
        """The engine's scheduler, counting preemptions of slots that hold
        pages borrowed from the prefix index."""
        sched = make_scheduler(*args, **kw)
        preempt = sched._preempt

        def counted_preempt(slot, *a, **k):
            count["borrowed_preemptions"] += sched._slot_shared[slot] > 0
            return preempt(slot, *a, **k)

        sched._preempt = counted_preempt
        return sched

    eng.decode, eng.make_scheduler = decode_block, make_counted_scheduler
    eng.verify = counted(verify, "windows", lambda *a: 1,
                         lambda tokens, *a: eng.num_slots * int(np.asarray(tokens).shape[1]))
    n_req, rps, prompts, gens = workload
    wl = make_open_loop_workload(n_req, rps, prompts, gens, cfg.vocab_size, seed=0)
    if system_prompt is not None:
        for r in wl:
            r.prompt = np.concatenate([system_prompt, r.prompt]).astype(np.int32)
    gpt.forward_with_cache = counted_forward
    try:
        fa, da = _reset_counts()  # a paged serving main path
        rep = run_continuous(eng, wl)
        torch.cuda.synchronize()
    finally:
        gpt.forward_with_cache = forward_with_cache
    launches = {"flash": sum(_fwd_launches(fa).values()), "decode": da.launches,
                "dense": da.paged_launches,
                "kv8": da.paged_kv8_launches, "kv4": da.paged_kv4_launches,
                "verify_dense": da.verify_launches, "verify_kv8": da.verify_kv8_launches,
                "verify_kv4": da.verify_kv4_launches,
                **{f"{k}_matmul": getattr(im, c) for k, c in QMM_COUNTERS.items()}, **qmm,
                "prefill_rows": dict(sorted(prefill_rows.items()))}
    tag = " ".join([dtype] + [f"{k}={v}" for k, v in over.items()])
    spec = rep.get("spec", {})
    faults = {k: rep["recovery_counters"].get(k, 0)
              for k in ("dispatch_error", "dispatch_failed", "block_quarantined")}
    rep["borrowed_preemptions"] = count["borrowed_preemptions"]
    rep["decode_blocks"] = dict(sorted(blocks.items()))
    if system_prompt is not None:
        tag += f" system_prompt={len(system_prompt)}"
    log(f"phase run {tag}: finished={rep['finished']}/{len(wl)} audit_ok={rep['pool_audit_ok']} "
        f"scheduler_steps={rep['decode_steps']} decode_steps={count['steps']} "
        f"decode_blocks={rep['decode_blocks']} dispatch_faults={faults} "
        f"page_stats={rep['page_stats']} "
        f"physical_logical={rep['physical_logical_page_ratio']} "
        f"borrowed_preemptions={count['borrowed_preemptions']} "
        f"verify_windows={count['windows']} draft_single_token_forwards={count['draft_tokens']} "
        f"preemptions={rep['preemptions']} launches={launches} "
        f"ttft_p50_ms={rep['ttft_p50_ms']} ttft_p99_ms={rep['ttft_p99_ms']} "
        f"per_token_p50_ms={rep['per_token_p50_ms']} tokens_per_sec={rep['tokens_per_sec']} "
        f"wall_s={rep['wall_s']} kv_bytes_per_token={eng.kv_bytes_per_token()}"
        + (f" spec={spec}" if spec else ""))
    check(rep["finished"] == len(wl), f"{tag}: {rep['finished']} of {len(wl)} finished")
    check(rep["pool_audit_ok"], f"{tag}: the page audit failed")
    if not fail_blocks:
        check(not any(faults.values()), f"{tag}: a dispatch failed or was retried: {faults}")
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
    # quantized weights: each call launched B6/B7 as its rows' route says
    # (checked per call above); and nothing launched them outside the calls
    check(not wrong, f"{tag}: B6/B7 launches by route: {wrong}")
    total = {k: sum(qmm[f"{k}_in_{w}"] for w in ("prefill", "decode", "verify", "draft"))
             for k in QMM_COUNTERS}
    check(total == {k: launches[f"{k}_matmul"] for k in QMM_COUNTERS},
          f"{tag}: B6/B7 launched outside a counted call: {launches}")
    return rep, [r.tokens[:r.max_new_tokens] for r in wl], wl, launches, eng


def _qmm_expected(torch, cfg, params, rows, dtype, n=1):
    """The B6/B7 launches of ``n`` forwards of ``rows`` rows over ``params``:
    none for dense weights; else one a layer for each projection (qkv,
    attn_out, mlp_up, mlp_down) on the kernel its ``qmm_route`` names: none
    past 256 rows (the dequantize route), the tensor cores past the
    crossover (every GPT-2 projection layout at group 128 qualifies, in
    every dtype), the decode kernel at 1-8 rows (every GPT-2 projection
    layout at groups 64 and 128), the CUDA cores otherwise."""
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im

    want = {k: 0 for k in QMM_COUNTERS}
    if not gpt._is_qleaf(params["blocks"]["qkv_w"]):
        return want
    for leaf in ("qkv_w", "attn_out_w", "mlp_up_w", "mlp_down_w"):
        node = params["blocks"][leaf]
        bits = 4 if "q4" in node else 8
        q = node["q4" if bits == 4 else "q"]
        D, F = q.shape[1], q.shape[-1] * (2 if bits == 4 else 1)
        route = im.qmm_route(rows, dtype, D, F, D * F // node["s"].shape[-1], bits)
        if route != "dequantize":
            want[QMM_ROUTE_KEY[route].format(bits=bits)] += cfg.n_layer * n
    return want


def _first_flip(torch, cfg, qparams, toks_q, toks_d, wl, names=("quantized", "dense")) -> str:
    """The first request whose served tokens differ between the quantized
    tree and its dequantized dense tree (or two runs over one dense tree,
    ``names`` saying which): the position, both tokens, and the gap between
    the two largest logits of the dense tree's forward over the shared
    prefix there (a near tie flips under another rounding)."""
    from deepspeed_tpu_torch.models import gpt

    for i, (a, b) in enumerate(zip(toks_q, toks_d)):
        if a == b:
            continue
        j = next(k for k, (u, v) in enumerate(zip(a, b)) if u != v)
        ids = np.concatenate([wl[i].prompt, np.asarray(b[:j], np.int32)])[None]
        logits = gpt.forward(cfg, gpt.dequantize_params(qparams),
                             torch.as_tensor(ids, device="cuda"), train=False)[0, -1].float()
        top2 = torch.topk(logits, 2).values
        return (f"request {i} token {j}: {names[0]} {a[j]} {names[1]} {b[j]} "
                f"dense top-2 logit gap {float(top2[0] - top2[1]):.3e}")
    return "none"


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


def _marginal_decode_ms(engine, prompt, short=16, long_=64, reps=3):
    """The reference bench's per-token decode latency: generate ``short`` and
    ``long_`` new tokens back to back, ``reps`` times (after one warm
    ``short`` call); the difference of the two times over ``long_ - short``
    tokens, p50 (host clock; generate returns host numpy, so each call ends
    synchronized)."""
    engine.generate(prompt, max_new_tokens=short)
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
        launches = {**{k: getattr(im, c) for k, c in QMM_COUNTERS.items()},
                    "decode": da.launches, "flash": sum(_fwd_launches(fa).values())}
        ref = plain.generate(prompt, max_new_tokens=new)
        match = float(np.mean(out[:, 512:] == ref[:, 512:]))
        log(f"phase7a generate gpt2-125m B4 prompt512 new{new} fp32 {kind} group{QUANT_GROUP}: "
            f"greedy_match_rate vs dequantized dense={match:.4f} launches={launches} "
            f"block_weight_bytes={_block_weight_bytes(engine.params)} "
            f"(dense fp32 {_block_weight_bytes(plain.params)})")
        check(match == 1.0, f"{kind} fp32 generate differs from the dequantized dense path")
        want = {**{k: 0 for k in QMM_COUNTERS}, "decode": cfg.n_layer * (new - 1), "flash": 0}
        want[f"{kind}_dec"] = 4 * cfg.n_layer * (new - 1)  # decode steps of 4 rows
        check(launches == want, f"{kind}: launches {launches}, expected {want}")
        del engine, plain
    torch.cuda.empty_cache()

    # (e) a user's finer groups: int8 / int4 at group 32, fp32, B4, prompt 64,
    # +16: the layout neither tensor-core kernel takes in fp32, so prefill (256
    # rows) and every decode step run the CUDA-core kernel; tokens equal the
    # dequantized dense tree's
    short = prompt[:, :64]
    for bits in (8, 4):
        kind = f"int{bits}"
        quant = {"enabled": True, "bits": bits, "group_size": 32}
        engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype="float32",
                                                    quant=quant)
        plain = deepspeed_tpu_torch.init_inference(
            for_gpt(cfg, gpt.dequantize_params(engine.params)), dtype="float32")
        engine.generate(short, max_new_tokens=2)  # warm-up
        _reset_counts()  # the quantized generate main path at group 32
        out = engine.generate(short, max_new_tokens=16)
        launches = {k: getattr(im, c) for k, c in QMM_COUNTERS.items()}
        ref = plain.generate(short, max_new_tokens=16)
        match = float(np.mean(out[:, 64:] == ref[:, 64:]))
        log(f"phase7e generate gpt2-125m B4 prompt64 new16 fp32 {kind} group32: "
            f"greedy_match_rate vs dequantized dense={match:.4f} launches={launches}")
        check(match == 1.0, f"{kind} group 32 generate differs from the dequantized dense path")
        want = {k: 0 for k in QMM_COUNTERS}
        want[kind] = 4 * cfg.n_layer * 16  # the prefill (256 rows) and 15 decode steps
        check(launches == want, f"7e {kind}: launches {launches}, expected {want}")
        ctx[f"qmm_{kind}"]["launches"] = launches[kind]
        del engine, plain
    torch.cuda.empty_cache()

    # (b) the reference's gpt2-350m-decode-b8-int4 bench row, with int8 and
    # dense bf16 beside it
    cfg350 = gpt.PRESETS["gpt2-350m"]
    p350 = gpt.init_params(cfg350, 0, device="cuda")
    prompt = np.random.default_rng(0).integers(0, cfg350.vocab_size, (8, 128)).astype(np.int32)
    toks, rows, busy = {}, {}, {}
    for kind, bits in (("bf16", None), ("int8", 8), ("int4", 4)):
        quant = {"enabled": True, "bits": bits, "group_size": QUANT_GROUP} if bits else {}
        engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg350, p350), dtype="bfloat16",
                                                    quant=quant)
        p50, lat = _marginal_decode_ms(engine, prompt)
        _reset_counts()
        toks[kind] = engine.generate(prompt, max_new_tokens=new)[:, 128:]
        launches = {k: getattr(im, c) for k, c in QMM_COUNTERS.items()}
        nbytes = _block_weight_bytes(engine.params)
        rows[kind] = nbytes
        log(f"phase7b gpt2-350m-decode-b8 {kind} bf16 B8 prompt128 +{new}: "
            f"decode_p50_ms={p50:.3f} decode_ms_all={[round(x, 3) for x in lat]} "
            f"tokens_per_s={1e3 / p50 * 8:.1f} block_weight_bytes={nbytes} "
            f"launches over one generate={launches}")
        kernels = []
        log(f"phase7b {kind} profile of 8 decode steps at position 128: "
            + _decode_profile(torch, engine, prompt, steps=8, sink=kernels, name="qmatmul",
                              counter=lambda: sum(getattr(im, c) for c in QMM_COUNTERS.values())))
        qmm_ms = sum(r[2] for r in kernels if "qmatmul" in r[0])
        busy[kind] = (sum(r[2] for r in kernels), qmm_ms,
                      sum(r[1] for r in kernels if "qmatmul" in r[0]))
        # the busy time and share come from a trace that holds every launch:
        # 8 steps x 4 projections x 24 layers
        want_records = 8 * 4 * cfg350.n_layer if bits else 0
        check(busy[kind][2] == want_records,
              f"7b {kind}: {busy[kind][2]} B6/B7 records in the trace, expected {want_records}")
        if bits:  # decode steps of 8 rows: the decode kernel; prefill (1024 rows): dequantize
            want = {k: 0 for k in QMM_COUNTERS}
            want[f"{kind}_dec"] = 4 * cfg350.n_layer * (new - 1)
            check(launches == want, f"350m {kind}: launches {launches}, expected {want}")
            ctx[f"qmm_dec_{kind}"]["launches"] = launches[f"{kind}_dec"]
        del engine
        torch.cuda.empty_cache()
    log("phase7b device busy of 8 decode steps (profiler): " + "; ".join(
        f"{k}={b:.3f} ms (B6/B7 {q:.3f} ms x{n}, share {q / b if b else 0:.3f})"
        for k, (b, q, n) in busy.items()))
    log(f"phase7b greedy match vs dense bf16 (reported only: quantization changes the "
        f"function): int8={float(np.mean(toks['int8'] == toks['bf16'])):.4f} "
        f"int4={float(np.mean(toks['int4'] == toks['bf16'])):.4f}; weight bytes vs bf16: "
        f"int8={rows['int8'] / rows['bf16']:.4f} int4={rows['int4'] / rows['bf16']:.4f}")
    # a byte per weight (half for int4) plus a 4-byte scale per 128
    check(abs(rows["int4"] / rows["bf16"] - (0.5 + 4 / QUANT_GROUP) / 2) < 1e-3,
          f"int4 block bytes {rows['int4']} vs bf16 {rows['bf16']}")
    del p350
    torch.cuda.empty_cache()

    # (c) paged serving over int8 and int4 weights (fp32, dense pools):
    # tokens equal serving over the dequantized dense tree; each prefill
    # forward of 9-256 rows on B6/B7's fp32 tensor-core route, each decode
    # step on the CUDA cores (checked per call in _serve)
    for bits in (8, 4):
        kind = f"int{bits}"
        qparams = gpt.quantize_for_inference(cfg, params, bits=bits, group_size=QUANT_GROUP)
        rep, toks_q, wl, launches, eng_q = _serve(torch, cfg, qparams, "float32")
        _, toks_d, _, _, _ = _serve(torch, cfg, gpt.dequantize_params(qparams), "float32")
        tc = launches[f"{kind}_tc_in_prefill"]
        log(f"phase7c serving {kind} weights fp32: finished={rep['finished']}/{len(wl)} "
            f"audit_ok={rep['pool_audit_ok']} match vs dequantized dense="
            f"{_match(toks_q, toks_d):.4f} tpot_p50_ms={rep['per_token_p50_ms']} "
            f"tokens_per_sec={rep['tokens_per_sec']} prefill_forwards_by_rows="
            f"{launches['prefill_rows']} tc_launches_in_prefill={tc} "
            f"decode_kernel_launches_in_decode={launches[f'{kind}_dec_in_decode']} "
            f"cuda_core_launches={launches[f'{kind}_matmul']}")
        if toks_q != toks_d:  # where the greedy paths part, and by how much
            log("phase7c first differing request: " + _first_flip(torch, cfg, qparams,
                                                                  toks_q, toks_d, wl))
        check(toks_q == toks_d,
              f"{kind}-weight served tokens differ from the dequantized dense run")
        check(tc > 0 and tc % (4 * cfg.n_layer) == 0,
              f"7c {kind}: {tc} tensor-core launches in prefill")
        check(launches[f"{kind}_dec_in_decode"] > 0 and launches[f"{kind}_matmul"] == 0,
              f"7c {kind}: decode steps off the decode kernel: {launches}")
        ctx[f"qmm_tc_f32_{kind}"]["launches"] = tc
        del eng_q
        torch.cuda.empty_cache()
    phase_quantized_prefill(torch, ctx)


def phase_quantized_prefill(torch, ctx):
    """(d) phase 6's serving run in bf16 over int8 and over int4 weights
    (``quantize_for_inference``, group 128): every request finishes, the
    audit is clean, and every forward launches B6/B7 by its rows' route
    (checked per call in ``_serve``): 4 x 12 tensor-core launches per
    prefill forward of more than the crossover's rows and at most 256 (the
    fused prefill buckets 32-128), 48 CUDA-core launches per decode step
    (8 rows), none past 256 rows (a batched admission of 8 x 64 or 8 x 128
    takes the dequantize route). Reports TTFT, TPOT, tokens/s, the greedy
    match against the dequantized dense tree served in bf16 (reported only:
    bf16 rounds the two differently), and a profile of one 128-row prefill
    forward with B6/B7's device time and share."""
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as im

    cfg = gpt.PRESETS["gpt2-125m"]
    params = ctx["params"]
    for bits in (8, 4):
        kind = f"int{bits}"
        qparams = gpt.quantize_for_inference(cfg, params, bits=bits, group_size=QUANT_GROUP)
        for leaf in ("qkv_w", "attn_out_w", "mlp_up_w", "mlp_down_w"):
            q = qparams["blocks"][leaf]["q4" if bits == 4 else "q"]
            F = q.shape[-1] * (2 if bits == 4 else 1)
            check(im.tc_layout(q.shape[1], F, QUANT_GROUP, bits),
                  f"7d: the tensor-core kernel does not take {leaf} [{q.shape[1]}, {F}]")
        rep, toks_q, wl, launches, eng = _serve(torch, cfg, qparams, "bfloat16")
        _, toks_d, _, _, _ = _serve(torch, cfg, gpt.dequantize_params(qparams), "bfloat16")
        tc = launches[f"{kind}_tc_in_prefill"]
        check(tc > 0 and tc % (4 * cfg.n_layer) == 0,
              f"7d {kind}: {tc} tensor-core launches in prefill")
        check(launches[f"{kind}_dec_in_decode"] > 0 and launches[f"{kind}_matmul"] == 0,
              f"7d {kind}: decode steps off the decode kernel: {launches}")

        ids = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 128)),
                              device="cuda")

        def prefill_128():  # one fused prefill forward at the 128-row bucket
            cache = gpt.init_cache(cfg, 1, 128, torch.bfloat16, "cuda")
            return gpt.forward_with_cache(cfg, eng.params, ids, cache)

        wall_ms = ctx["timer"].ms(prefill_128, iters=5, warmup=2, device_only=False)
        counter = f"int{bits}_tc_launches"
        kernels, profiled, qmm_n = complete_trace(torch, prefill_128, "qmatmul_tc",
                                                  lambda: getattr(im, counter))
        busy = sum(r[2] for r in kernels)
        qmm_ms = sum(r[2] for r in kernels if "qmatmul_tc" in r[0])
        share = f"{qmm_ms / busy:.3f}" if busy else "not measured"
        log(f"phase7d serving bf16 {kind} weights group{QUANT_GROUP}: finished={rep['finished']}/"
            f"{len(wl)} audit_ok={rep['pool_audit_ok']} ttft_p50_ms={rep['ttft_p50_ms']} "
            f"ttft_p99_ms={rep['ttft_p99_ms']} tpot_p50_ms={rep['per_token_p50_ms']} "
            f"tokens_per_sec={rep['tokens_per_sec']} greedy_match_vs_dequantized_dense_bf16="
            f"{_match(toks_q, toks_d):.4f} (reported only) prefill_forwards_by_rows="
            f"{launches['prefill_rows']} tc_launches_in_prefill={tc} "
            f"tc_launches_in_verify={launches[f'{kind}_tc_in_verify']} "
            f"decode_kernel_launches_in_decode={launches[f'{kind}_dec_in_decode']} "
            f"cuda_core_launches={launches[f'{kind}_matmul']}")
        log(f"phase7d {kind} profile of one 128-row prefill forward: b6b7_tc_ms={qmm_ms:.3f} "
            f"launches={profiled} (in the trace: {qmm_n}) share_of_busy={share} "
            + device_breakdown(torch, prefill_128, wall_ms, top=5, kernels=kernels))
        # the counter says what launched; the share comes from a trace that
        # holds a record of every launch
        check(profiled == 4 * cfg.n_layer,
              f"7d {kind}: {profiled} tensor-core launches in the profiled forward")
        check(qmm_n == profiled, f"7d {kind}: {qmm_n} of {profiled} tensor-core launches in "
              f"the trace after {TRACE_TRIES} tries")
        ctx[f"qmm_tc_{kind}"]["launches"] = tc
        del eng
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
    # tree; 48 B6 launches per verify window of 40 rows, on the fp32
    # tensor-core route (checked in _serve)
    qparams = gpt.quantize_for_inference(cfg, params, bits=8, group_size=QUANT_GROUP)
    wl12 = (12,) + SERVE_WORKLOAD[1:]
    rep_e, toks_e, _, launches_e, _ = _serve(torch, cfg, qparams, "float32", workload=wl12, **SPEC)
    _, toks_eo, _, _, _ = _serve(torch, cfg, qparams, "float32", workload=wl12, decode_block=1)
    log(f"phase8e fp32 int8 weights spec: {_spec_line(rep_e)} match vs spec-off="
        f"{_match(toks_e, toks_eo):.4f} B6 launches in verify: tensor cores="
        f"{launches_e['int8_tc_in_verify']} CUDA cores={launches_e['int8_in_verify']}; "
        f"decode kernel in decode steps={launches_e['int8_dec_in_decode']}; CUDA cores over "
        f"the run={launches_e['int8_matmul']}")
    check(toks_e == toks_eo, "int8-weight spec tokens differ from spec-off")
    check(launches_e["int8_matmul"] == 0, f"8e: the CUDA-core B6 launched: {launches_e}")
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
                       {"b8": dqm.tc_launches, **_flash_launches(fa)})
        del engine
    (loss_k, norm_k, launches), (loss_p, norm_p, plain_launches) = runs["kernel"], runs["plain"]
    log(f"phase9a train fp32 zero3 quantized weights+head gpt2-125m B4xT512: losses={loss_k} "
        f"plain_b8_losses={loss_p} grad_norms={norm_k} plain_b8_grad_norms={norm_p} "
        f"launches over 5 micro-steps={launches} plain-B8 launches={plain_launches}")
    check(np.allclose(loss_k, loss_p, rtol=1e-4, atol=0), f"9a losses differ: {loss_k} vs {loss_p}")
    check(np.allclose(norm_k, norm_p, rtol=1e-3, atol=0), f"9a grad norms differ: {norm_k} vs {norm_p}")
    check(launches["b8"] == 5 and plain_launches["b8"] == 0,
          f"9a B8 tensor-core launches {launches['b8']} / plain {plain_launches['b8']}, "
          "expected 5 / 0")
    flash = {n: c for n, c in launches.items() if not n.startswith("b8")}
    expected = path_launches(flash, 5 * cfg.n_layer, _flash_path("float32"))
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
    launches = {"b8": dqm.tc_launches, **_flash_launches(fa)}
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
    flash = {n: c for n, c in launches.items() if not n.startswith("b8")}
    expected = path_launches(flash, 10 * cfg.n_layer, _flash_path("bfloat16"))
    check(flash == expected, f"9b flash launches {flash}, expected {expected}")
    check(any(n.startswith("qgather[zero3]") for n in ledger)
          and any(n.startswith("qmatmul[lm_head]") for n in ledger), f"9b ledger {ledger}")
    ctx["dqm_tc"]["launches"] = launches["b8"]
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

    # (d) fp32 at B1 x T32, 2 steps: the head's product has 32 rows and
    # takes the tensor-core kernel's 64-row tiling; then the same with
    # zero_quantize_block_size 96, a block off 64-column panels, which the
    # tensor-core kernel takes padded to 128 columns
    for block in (256, 96):
        engine = _engine(_train_config(1, zero_optimization={
            **ZERO3Q, "zero_quantize_block_size": block}), cfg)
        batches = [{"input_ids": rng.integers(0, V, (1, 32)).astype(np.int32)} for _ in range(2)]
        _reset_counts()  # the short-batch fp32 stage-3 training main path
        losses = [engine.train_batch(b)["loss"].item() for b in batches]
        torch.cuda.synchronize()
        launches = {"b8": dqm.tc_launches}
        log(f"phase9d train fp32 zero3 quantized weights+head gpt2-125m B1xT32 block{block}: "
            f"losses={losses} launches over 2 steps={launches}")
        check(all(math.isfinite(x) for x in losses), f"9d block {block}: losses {losses}")
        check(launches == {"b8": 2}, f"9d block {block}: B8 launches {launches}, expected 2")
        ctx["dqm_tc_few_rows" if block == 256 else "dqm_tc_block96"]["launches"] = launches["b8"]
        del engine
        torch.cuda.empty_cache()
    # (e) (b)'s configuration with zero_quantize_block_size 128 (a user's
    # block to cut quantization error), 3 steps: the head's product on the
    # tensor cores' 128-column tiles, its step beside (b)'s
    engine = _engine(_train_config(8, bf16={"enabled": True}, zero_optimization={
        **ZERO3Q, "zero_quantize_block_size": 128}), cfg)
    _reset_counts()  # the bf16 stage-3 training main path at a block of 128
    losses, norms, step_ms, host_ms = _timed_steps(torch, engine, batch, 3)
    launches = {"b8": dqm.tc_launches}
    log(f"phase9e train bf16 master zero3 quantized weights+head block128 gpt2-125m B8xT512: "
        f"losses={losses} grad_norms={norms} launches over 3 steps={launches} "
        f"step_ms (CUDA events, median of steps 2-3)={float(np.median(step_ms[1:])):.3f} "
        f"step_ms_all={[round(x, 3) for x in step_ms]} host_issue_ms (median of steps 2-3)="
        f"{float(np.median(host_ms[1:])):.3f}; phase9b (block 256) in this run: "
        f"step_ms={steady_ms:.3f}")
    check(abs(losses[0] - math.log(V)) < 0.5, f"9e step-1 loss {losses[0]} far from ln(V)")
    check(all(math.isfinite(x) for x in losses + norms), "9e loss or grad norm not finite")
    check(launches == {"b8": 3}, f"9e B8 launches {launches}, expected 3")
    ctx["dqm_tc_block128"]["launches"] = launches["b8"]
    del engine
    torch.cuda.empty_cache()


def _bs_launches(fa):
    from deepspeed_tpu_torch.ops.cuda import blocksparse_attention as bs

    return {**{f"b9_{n}": getattr(bs, c) for n, c in BS_COUNTERS.items()},
            **{f"b1_{n}": c for n, c in _fwd_launches(fa).items()},
            **{f"b2_{n}": c for n, c in _bwd_launches(fa).items()}}


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
    check(score_launches == path_launches(score_launches, L, ("b9_fwd_tf32",)),
          f"10a scoring launches {score_launches}")

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
    path = tuple(f"b9_{n}" for n in BS_PATH["float32"])
    check(launches == path_launches(launches, 5 * L, path),
          f"10a launches {launches}, expected {5 * L} of each of {path} and no other")
    check(not any(plain_launches.values()), f"10a plain run launched kernels: {plain_launches}")
    for n in BS_PATH["float32"]:
        kind, route = n.split("_")
        ctx[f"bs_{route}_{kind}"]["launches"] = launches[f"b9_{n}"]
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
            + (f" {flash_profile(kernels_run, busy_ms)}" if name == "dense" else ""))
        check(abs(losses[0] - math.log(V)) < 0.5, f"10b {name} step-1 loss {losses[0]} far from ln(V)")
        check(losses[-1] < losses[0], f"10b {name} loss did not fall: {losses}")
        check(all(math.isfinite(x) for x in losses + norms), f"10b {name} loss or norm not finite")
        del engine
        torch.cuda.empty_cache()
    sparse, dense = rows["sparse"]["launches"], rows["dense"]["launches"]
    log(f"phase10b sparse/dense step ratio={rows['sparse']['step_ms'] / rows['dense']['step_ms']:.4f} "
        f"(below 1: the sparse step is faster than the dense one)")
    path = tuple(f"b9_{n}" for n in BS_PATH["bfloat16"])
    check(sparse == path_launches(sparse, 10 * L, path),
          f"10b sparse launches {sparse}, expected {10 * L} of each of {path} and no other")
    expected = path_launches(dense, 10 * L, (*(f"b1_{n}" for n in FWD_PATH["bfloat16"]),
                                            *(f"b2_{n}" for n in BWD_PATH["bfloat16"])))
    check(dense == expected, f"10b dense launches {dense}, expected {expected}")
    for n in BS_KERNELS:
        ctx[f"bs_tc_{n}"]["launches"] = sparse[f"b9_{n}_tc"]

    # (c) bf16 + ZeRO-2, B2 x T1024, the fixed pattern at blocks of 32: the
    # forward, dq and dk/dv on the tensor cores' sub-block mask instances
    small_cfg = dataclasses.replace(cfg, sparse_attention=FixedSparsityConfig(
        **SMALL_BLOCK_LAYOUT))
    engine = _engine(_train_config(2, bf16={"enabled": True}, zero_optimization={"stage": 2}),
                     small_cfg)
    batch = {"input_ids": rng.integers(0, V, (2, 1024)).astype(np.int32)}
    fa, _ = _reset_counts()  # the small-block sparse training main path
    losses, norms, step_ms, _ = _timed_steps(torch, engine, batch, 3)
    launches = _bs_launches(fa)
    log(f"phase10c train bf16 master zero2 sparse gpt2-125m block 32 B2xT1024: "
        f"losses={losses} grad_norms={norms} step_ms={[round(x, 3) for x in step_ms]} "
        f"launches over 3 steps={launches}")
    check(abs(losses[0] - math.log(V)) < 0.5, f"10c step-1 loss {losses[0]} far from ln(V)")
    check(all(math.isfinite(x) for x in losses + norms), "10c loss or grad norm not finite")
    path = tuple(f"b9_{n}" for n in BS_PATH["bfloat16"])
    check(launches == path_launches(launches, 3 * L, path),
          f"10c launches {launches}, expected {3 * L} of each of {path} and no other")
    for n in BS_KERNELS:
        ctx[f"bs_tc_small_{n}"]["launches"] = launches[f"b9_{n}_tc"]
    del engine
    torch.cuda.empty_cache()


# phase 11: gpt2-760m (d 1536, H16: head dim 96) at full width, its 24
# layers cut to D96_DEPTH to keep the script within its time limit (every
# layer runs the same kernels at the same shapes); the serving workload is
# phase 6's configuration with 8 requests and generations of 8-32
D96_PRESET = "gpt2-760m"
D96_DEPTH = 4
D96_WORKLOAD = (8, 8.0, (32, 128), (8, 32))


def phase_head_dim_96(torch, ctx):
    """Phase 11: ``PRESETS["gpt2-760m"]`` at full width (d 1536, 16 heads of
    96), depth cut to 4 of its 24 layers, random weights from seed 0. (a)
    fp32 scoring at B4 x T512 through B1 on the CUDA cores, equal to plain
    attention; (b) bf16 + fp32 master + ZeRO-2 training at B4 x T512, 3
    steps, through B1 / B2 on the tensor cores (the padded second panel);
    (c) greedy ``generate`` (B2, prompt 256, +32), fp32, through B3,
    token-identical to the plain path; (d) paged serving (phase 6's
    configuration, 8 requests), fp32, through B4, each request's tokens
    equal to ``generate``'s; (e) n-gram speculative serving (spec_k 4,
    decode_block 1) of (d)'s workload through B5, equal to (d)'s tokens.
    Every path's launch counts are exact and printed."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import for_gpt
    from deepspeed_tpu_torch.models import gpt

    cfg = dataclasses.replace(gpt.PRESETS[D96_PRESET], n_layer=D96_DEPTH)
    check(cfg.head_dim == 96, f"{D96_PRESET}: head dim {cfg.head_dim}")
    L, V = cfg.n_layer, cfg.vocab_size
    params = gpt.init_params(cfg, 0, device="cuda")
    rng = np.random.default_rng(11)
    tag = f"{D96_PRESET} (d{cfg.d_model} H{cfg.n_head} Dh96, {L} of 24 layers)"

    # (a) fp32 scoring, B4 x T512
    batch = {"input_ids": rng.integers(0, V, (4, 512)).astype(np.int32)}
    with torch.no_grad():
        fa, da = _reset_counts()  # the scoring main path
        loss = gpt.loss_fn(cfg, params, batch, train=False)[0].item()
        torch.cuda.synchronize()
        launches = _flash_launches(fa)
        plain = gpt.loss_fn(dataclasses.replace(cfg, use_flash=False), params, batch,
                            train=False)[0].item()
    log(f"phase11a scoring {tag} B4xT512 fp32: loss={loss:.6f} plain_loss={plain:.6f} "
        f"|diff|={abs(loss - plain):.3e} launches={launches}")
    check(math.isfinite(loss) and abs(loss - math.log(V)) < 0.5, f"D96 scoring loss {loss}")
    check(abs(loss - plain) <= 1e-4, f"D96 flash loss {loss} vs plain {plain}")
    check(launches == path_launches(launches, L, FWD_PATH["float32"]),
          f"D96 scoring launches {launches}")

    # (b) bf16 + fp32 master + ZeRO-2, B4 x T512, 3 steps on one batch
    engine = _engine(_train_config(4, bf16={"enabled": True}, zero_optimization={"stage": 2}),
                     cfg)
    fa, _ = _reset_counts()  # the bf16 training main path
    losses, norms, step_ms, _ = _timed_steps(torch, engine, batch, 3)
    launches = _flash_launches(fa)
    log(f"phase11b train bf16 master zero2 {tag} B4xT512: losses={losses} grad_norms={norms} "
        f"step_ms={[round(x, 3) for x in step_ms]} launches over 3 steps={launches}")
    check(abs(losses[0] - math.log(V)) < 0.5, f"D96 bf16 step-1 loss {losses[0]}")
    check(losses[-1] < losses[0], f"D96 bf16 loss did not fall: {losses}")
    check(all(math.isfinite(x) for x in losses + norms), "D96 bf16 loss or norm not finite")
    want = path_launches(launches, 3 * L, _flash_path("bfloat16"))
    check(launches == want, f"D96 bf16 launches {launches}, expected {want}")
    del engine
    torch.cuda.empty_cache()

    # (c) greedy generate, fp32, B2 prompt 256 +32: the plain path's tokens
    prompt = rng.integers(0, V, (2, 256)).astype(np.int32)
    new = 32
    engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype="float32")
    plain_engine = deepspeed_tpu_torch.init_inference(
        for_gpt(dataclasses.replace(cfg, use_flash=False), params), dtype="float32")
    engine.generate(prompt, max_new_tokens=2)  # warm-up
    fa, da = _reset_counts()  # the generate main path
    out = engine.generate(prompt, max_new_tokens=new)
    decode_launches = da.launches
    ref = plain_engine.generate(prompt, max_new_tokens=new)
    log(f"phase11c generate {tag} B2 prompt256 new{new} fp32: decode_launches="
        f"{decode_launches} greedy_match_rate={float(np.mean(out == ref)):.4f}")
    check(decode_launches == L * (new - 1), f"D96 B3 launches {decode_launches}")
    check(np.array_equal(out, ref), "D96 generate differs from the plain path")
    del plain_engine

    # (d) paged serving, fp32 dense pools: each request's tokens = generate's
    _, toks_d, wl, launches_d, _ = _serve(torch, cfg, params, "float32", workload=D96_WORKLOAD)
    gen = [engine.generate(r.prompt[None], max_new_tokens=r.max_new_tokens)[0, len(r.prompt):]
           .tolist() for r in wl]
    log(f"phase11d paged serving {tag} fp32: B4 launches={launches_d['dense']} "
        f"match vs generate={_match(toks_d, gen):.4f}")
    check(toks_d == gen, "D96 served tokens differ from generate")
    del engine

    # (e) n-gram speculative serving: (d)'s tokens, B5 in every window
    rep_e, toks_e, _, launches_e, _ = _serve(torch, cfg, params, "float32",
                                             workload=D96_WORKLOAD, **SPEC)
    log(f"phase11e spec serving {tag} fp32: {_spec_line(rep_e)} B5 launches="
        f"{launches_e['verify_dense']} B4 launches={launches_e['dense']} "
        f"match vs spec-off (d)={_match(toks_e, toks_d):.4f}")
    check(toks_e == toks_d, "D96 spec-on tokens differ from spec-off")
    check(rep_e["spec"]["windows"] > 0, "D96: no verify window ran")
    torch.cuda.empty_cache()


def _state_diff(torch, a, b):
    """Keys of the train-state leaves of engines ``a`` and ``b`` that are not
    bitwise equal (``torch.equal`` on the card)."""
    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths

    fa, fb = flatten_with_paths(a.state), flatten_with_paths(b.state)
    if [k for k, _ in fa] != [k for k, _ in fb]:
        return ["<structure>"]
    return [k for (k, x), (_, y) in zip(fa, fb) if not torch.equal(x, y)]


def _tag_bytes(tag_dir: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(tag_dir) for f in files)


def _timed(torch, fn):
    """(fn's result, wall ms), the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _resume_run(torch, name, conf, cfg, batches, split, root, retag=None):
    """Phase 12's resume check. An uninterrupted run of ``batches`` from
    seed 0; a second engine takes the first ``split`` steps and saves (and,
    with ``retag``, saves again under that tag); a third, built from seed 1
    so that the load must replace everything, loads the newest tag and takes
    the rest. Checks the loaded state bitwise against the saver's, and the
    resumed steps' losses and grad norms against the uninterrupted run's to
    rtol 1e-6 (the reference's bar, ``tests/test_checkpoint.py``). Returns
    (saver, loader, launches of the resumed steps, the report dict)."""
    import os

    from deepspeed_tpu_torch.ops.cuda import dequant_matmul as dqm

    ref = _engine(conf, cfg)
    metrics = [ref.train_batch(b) for b in batches]
    ref_curve = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
    del ref, metrics
    saver = _engine(conf, cfg)
    for b in batches[:split]:
        saver.train_batch(b)
    tag_dir, save_ms = _timed(torch, lambda: saver.save_checkpoint(root))
    if retag:
        saver.save_checkpoint(root, tag=retag)
    loader = _engine(conf, cfg, seed=1)
    (path, _), load_ms = _timed(torch, lambda: loader.load_checkpoint(root))
    check(path.endswith(retag or tag_dir.rsplit("/", 1)[-1]), f"12{name}: loaded {path}")
    diff = _state_diff(torch, saver, loader)
    fa, _ = _reset_counts()  # the resumed training main path
    metrics = [loader.train_batch(b) for b in batches[split:]]
    torch.cuda.synchronize()
    launches = {"b8": dqm.tc_launches, **_flash_launches(fa)}
    curve = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
    nbytes = _tag_bytes(tag_dir)
    with open(os.path.join(tag_dir, "MANIFEST.json")) as f:
        algo = json.load(f)["checksum"]
    rep = dict(save_ms=save_ms, load_ms=load_ms, bytes=nbytes, algo=algo,
               save_gb_s=nbytes / save_ms / 1e6, load_gb_s=nbytes / load_ms / 1e6)
    log(f"phase12{name} resume after step {split}: resumed (loss, grad_norm)={curve} "
        f"uninterrupted={ref_curve[split:]} bitwise={curve == ref_curve[split:]} "
        f"state leaves differing after load={diff} launches={launches} tag_bytes={nbytes} "
        f"checksum={algo} save_ms={save_ms:.1f} ({rep['save_gb_s']:.3f} GB/s) "
        f"verified_load_ms={load_ms:.1f} ({rep['load_gb_s']:.3f} GB/s)")
    check(not diff, f"12{name}: loaded leaves differ from the saver's: {diff}")
    check(np.allclose(curve, ref_curve[split:], rtol=1e-6, atol=0),
          f"12{name}: resumed {curve} vs uninterrupted {ref_curve[split:]}")
    return saver, loader, launches, rep


def phase_checkpoint(torch, ctx):
    """Phase 12: checkpointing on GPT-2-125M at full width and depth, the tags
    under a ``tempfile.mkdtemp()`` directory, each part's removed when it ends.
    (a) bf16 + ZeRO-2, B8 x T512 (5b's configuration): 5 uninterrupted steps;
    3 steps, a save, a second save at step 3 under another tag; an engine
    from another seed loads and takes steps 4-5. (b) ZeRO-3 with the
    quantized wire and head, fp32 B4 x T512 (9a's): a save at step 2, a
    load, step 3, B8 once. Both: the loaded state bitwise the saver's, the
    resumed losses and grad norms within rtol 1e-6 of the uninterrupted run
    (whether bitwise is printed), save and verified-load ms, the tag's bytes
    and GB/s, the checksum. (c) mid-accumulation at 5c's gas 2 x 4 (fp32)
    through ``forward`` / ``backward`` / ``step``: a save after the first
    micro-step, a load, the window finished: the params bitwise those of the
    uninterrupted window. (d) ``save_16bit_model`` after (a): every array
    bitwise the params. (e) a byte of one array of (a)'s newer tag flipped:
    ``load_checkpoint(tag=None)`` falls back to the older tag and logs the
    rejection; the newer tag by name raises ``CheckpointCorruptionError``."""
    import logging
    import os
    import shutil
    import tempfile

    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.resilience import CheckpointCorruptionError
    from deepspeed_tpu_torch.utils.logging import logger
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    cfg = gpt.PRESETS["gpt2-125m"]
    V, L = cfg.vocab_size, cfg.n_layer
    rng = np.random.default_rng(12)
    root = tempfile.mkdtemp(prefix="ckpt12_")
    log(f"phase12 tags under {root}: free disk {shutil.disk_usage(root).free / 1e9:.1f} GB")
    try:
        # (a) bf16 + ZeRO-2, 3 + 2 steps around a save
        dir_a = os.path.join(root, "a")
        conf = _train_config(8, bf16={"enabled": True}, zero_optimization={"stage": 2})
        batches = [{"input_ids": rng.integers(0, V, (8, 512)).astype(np.int32)}
                   for _ in range(5)]
        saver, loader, launches, rep = _resume_run(torch, "a", conf, cfg, batches, 3, dir_a,
                                                   retag="resave_global_step3")
        want = path_launches({k: v for k, v in launches.items() if k != "b8"}, 2 * L,
                             _flash_path("bfloat16"))
        check(launches == {"b8": 0, **want}, f"12a launches {launches}, expected {want}")
        ctx["ckpt12"] = {"a": rep}

        # (d) save_16bit_model of the resumed engine
        path, ms16 = _timed(torch, lambda: loader.save_16bit_model(os.path.join(root, "m16")))
        with np.load(path) as npz:
            stored = {k: npz[k] for k in npz.files}
        bad = []
        for key, p in flatten_with_paths(loader.state["params"]):
            arr = stored.pop(f"{key}::bfloat16", None)
            t = None if arr is None else torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).to(p.device)
            if t is None or not torch.equal(t, p.detach()):
                bad.append(key)
        log(f"phase12d save_16bit_model: {os.path.getsize(path)} bytes in {ms16:.1f} ms, "
            f"arrays not bitwise the params={bad} extra keys={sorted(stored)}")
        check(not bad and not stored, f"12d: {bad} / {sorted(stored)}")

        # (e) one flipped byte in the newer tag
        victim = os.path.join(dir_a, "resave_global_step3", "state", "arrays", "0.npy")
        with open(victim, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0x01]))
        records = []
        handler = logging.Handler(level=logging.ERROR)
        handler.emit = records.append
        logger.addHandler(handler)
        try:
            fallback, _ = loader.load_checkpoint(dir_a)
        finally:
            logger.removeHandler(handler)
        rejected = [r.getMessage() for r in records if "resave_global_step3" in r.getMessage()]
        diff = _state_diff(torch, saver, loader)
        try:
            loader.load_checkpoint(dir_a, tag="resave_global_step3")
            strict = "loaded"
        except CheckpointCorruptionError as e:
            strict = f"CheckpointCorruptionError: {e.reason}"
        log(f"phase12e flipped a byte of resave_global_step3/state/arrays/0.npy: tag=None "
            f"loaded {fallback} (rejections logged: {rejected}); leaves differing from the "
            f"saver's={diff}; tag=resave_global_step3 -> {strict}")
        check(fallback.endswith("/global_step3") and rejected and not diff,
              f"12e: fallback {fallback}, rejections {rejected}, diff {diff}")
        check(strict.startswith("CheckpointCorruptionError"), f"12e: strict load {strict}")
        del saver, loader
        shutil.rmtree(dir_a)
        torch.cuda.empty_cache()

        # (b) ZeRO-3, quantized wire and head, fp32 B4 x T512, 2 + 1 steps
        dir_b = os.path.join(root, "b")
        batches = [{"input_ids": rng.integers(0, V, (4, 512)).astype(np.int32)}
                   for _ in range(3)]
        saver, loader, launches, rep = _resume_run(
            torch, "b", _train_config(4, zero_optimization=ZERO3Q), cfg, batches, 2, dir_b)
        want = path_launches({k: v for k, v in launches.items() if k != "b8"}, L,
                             _flash_path("float32"))
        check(launches == {"b8": 1, **want}, f"12b launches {launches}, expected B8 1 and {want}")
        ctx["ckpt12"]["b"] = rep
        del saver, loader
        shutil.rmtree(dir_b)
        torch.cuda.empty_cache()

        # (c) mid-accumulation: gas 2 x micro 4, fp32, a save after micro-step 1
        dir_c = os.path.join(root, "c")
        conf = _train_config(4, gas=2)
        rows = rng.integers(0, V, (2, 4, 512)).astype(np.int32)

        def micro(engine, i):
            engine.backward(engine.forward({"input_ids": rows[i]}))
            engine.step()

        ref = _engine(conf, cfg)
        micro(ref, 0)
        micro(ref, 1)
        want_params = [t.detach().clone() for t in tree_leaves(ref.state["params"])]
        del ref
        saver = _engine(conf, cfg)
        micro(saver, 0)
        _, save_ms = _timed(torch, lambda: saver.save_checkpoint(dir_c))
        loader = _engine(conf, cfg, seed=1)
        _, load_ms = _timed(torch, lambda: loader.load_checkpoint(dir_c))
        acc_equal = all(torch.equal(a, b) for a, b in zip(saver._grad_acc, loader._grad_acc))
        diff = _state_diff(torch, saver, loader)
        fa, _ = _reset_counts()  # the resumed accumulation window
        micro(loader, 1)
        torch.cuda.synchronize()
        launches = _flash_launches(fa)
        params_equal = all(torch.equal(a, b) for a, b in
                           zip(tree_leaves(loader.state["params"]), want_params))
        log(f"phase12c mid-accumulation gas 2 x micro 4 fp32: saved after micro-step 1 "
            f"({save_ms:.1f} ms), loaded ({load_ms:.1f} ms): grad_acc bitwise={acc_equal} "
            f"state leaves differing={diff}; after step(): global_steps={loader.global_steps} "
            f"params bitwise the uninterrupted window's={params_equal} launches={launches}")
        check(acc_equal and not diff, f"12c: grad_acc {acc_equal}, leaves {diff}")
        check(params_equal and loader.global_steps == 1, "12c: params differ after the window")
        want = path_launches(launches, L, _flash_path("float32"))
        check(launches == want, f"12c launches {launches}, expected {want}")
        del saver, loader
        shutil.rmtree(dir_c)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def _cached_vs_uncached(torch, cfg, params, prompt, new):
    """``generate``'s greedy fp32 tokens (the cached path, the user's entry
    point), then the cached path's logits at every generated position (the
    prefill's last, then ``new`` - 1 single-token steps fed generate's tokens)
    against the uncached ``forward``'s over the same sequence. Returns
    (tokens, error relative to the uncached logits' largest magnitude,
    greedy match of the uncached argmax against the tokens, B3 launches,
    flash forward launches, generate s)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import for_gpt
    from deepspeed_tpu_torch.models import gpt

    B, T = prompt.shape
    engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype="float32")
    with torch.no_grad():
        fa, da = _reset_counts()  # the biased model's decode path
        t0 = time.perf_counter()
        out = engine.generate(prompt, max_new_tokens=new)
        gen_s = time.perf_counter() - t0
        seq = torch.as_tensor(out, device="cuda").long()
        cache = gpt.init_cache(cfg, B, -(-(T + new) // 128) * 128, torch.float32, "cuda")
        logits, cache = gpt.forward_with_cache(cfg, params, seq[:, :T], cache)
        cached = [logits[:, -1]]
        for j in range(new - 1):
            logits, cache = gpt.forward_with_cache(cfg, params, seq[:, T + j:T + j + 1], cache)
            cached.append(logits[:, -1])
        del cache, logits
        cached = torch.stack(cached, dim=1)  # [B, new, V]
        uncached = gpt.forward(cfg, params, seq[:, :T + new - 1], train=False)[:, T - 1:]
        torch.cuda.synchronize()
        decode_launches, flash = da.launches, sum(_fwd_launches(fa).values())
        err = ((cached - uncached).abs().max() / uncached.abs().max()).item()
        match = (uncached.argmax(-1) == seq[:, T:]).float().mean().item()
    return out, err, match, decode_launches, flash, gen_s


def _generate_rate(engine, prompt, new, reps=3, **kw):
    """(prefill ms, generate ms, decode tokens/s) of ``generate``: medians of
    ``reps`` runs of 1 and of ``new`` tokens after a warm-up, on the host
    clock (generate returns host numpy, so each run ends synchronised)."""
    def run(n):
        t0 = time.perf_counter()
        engine.generate(prompt, max_new_tokens=n, **kw)
        return time.perf_counter() - t0

    run(2)
    prefill_s = float(np.median([run(1) for _ in range(reps)]))
    total_s = float(np.median([run(new) for _ in range(reps)]))
    return prefill_s * 1e3, total_s * 1e3, prompt.shape[0] * (new - 1) / (total_s - prefill_s)


# the cached path against the uncached forward, relative to the largest logit
CACHED_TOL = 1e-4


def phase_gpt_variants(torch, ctx):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import for_gpt
    from deepspeed_tpu_torch.models import gpt

    # (a) bloom-7b1 at full width and depth, random weights from a seed drawn
    # on the card, fp32 and then bf16: every layer ALiBi-biased, so every
    # attention (prefill, decode, the uncached forward) takes the plain path
    cfg = gpt.PRESETS["bloom-7b1"]
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    torch.cuda.synchronize()
    log(f"phase13a bloom-7b1 init on the card: {n_params / 1e9:.3f} G params, "
        f"{n_params * 4 / 1e9:.2f} GB fp32, {time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(13).integers(0, cfg.vocab_size, (4, 512)).astype(np.int32)
    out, err, match, decode_launches, flash, gen_s = _cached_vs_uncached(
        torch, cfg, params, prompt, 64)
    log(f"phase13a bloom-7b1 fp32 B4 prompt512 new64: cached vs uncached logits max err "
        f"{err:.3e} of the largest (limit {CACHED_TOL:.0e}), greedy match {match:.4f}, "
        f"decode_launches={decode_launches} flash_fwd_launches={flash} "
        f"generate_s={gen_s:.2f}")
    check(out.shape == (4, 576), f"bloom generate shape {out.shape}")
    check(err <= CACHED_TOL, f"bloom fp32 cached logits differ from the uncached: {err:.3e}")
    check(decode_launches == 0, f"a biased decode step reached B3: {decode_launches} launches")
    check(flash == 0, f"a biased forward reached B1: {flash} launches")
    params = gpt.cast_params(params, torch.device("cuda"), torch.bfloat16)  # fp32 freed
    torch.cuda.empty_cache()
    bf16 = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype="bfloat16")
    del params
    torch.cuda.reset_peak_memory_stats()
    fa, da = _reset_counts()  # the bf16 bloom decode path
    prefill_ms, gen_ms, tok_s = _generate_rate(bf16, prompt, 64)
    torch.cuda.synchronize()
    log(f"phase13a bloom-7b1 bf16 B4 prompt512 new64: prefill_ms={prefill_ms:.2f} "
        f"generate_ms={gen_ms:.2f} decode_tokens_per_s={tok_s:.1f} "
        f"decode_launches={da.launches} flash_fwd_launches={sum(_fwd_launches(fa).values())} "
        f"peak_memory_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    check(da.launches == 0, f"a bf16 biased decode step reached B3: {da.launches} launches")
    log("phase13a bloom-7b1 bf16 profile of 8 decode steps at position 512: "
        + _decode_profile(torch, bf16, prompt, steps=8))
    del bf16
    torch.cuda.empty_cache()

    # (b) bloom's geometry at 2 of 30 layers, bf16 + ZeRO-2, B2 x T2048, 3
    # steps with loss_chunk 256 against 0: the chunked loss's peak memory
    cfg_b = dataclasses.replace(cfg, n_layer=2)
    V = cfg.vocab_size
    batch = {"input_ids": np.random.default_rng(14).integers(0, V, (2, 2048)).astype(np.int32)}
    runs = {}
    for chunk in (256, 0):
        engine = _engine(_train_config(2, bf16={"enabled": True},
                                       zero_optimization={"stage": 2}),
                         dataclasses.replace(cfg_b, loss_chunk=chunk))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa, _ = _reset_counts()  # the bloom training path
        losses, norms, step_ms, host_ms = _timed_steps(torch, engine, batch, 3)
        runs[chunk] = dict(losses=losses, norms=norms, step_ms=step_ms, base=base,
                           peak=torch.cuda.max_memory_allocated(),
                           flash=sum(_flash_launches(fa).values()))
        del engine
        torch.cuda.empty_cache()
    logits_bytes = 2 * 2048 * V * 4
    saved = runs[0]["peak"] - runs[256]["peak"]
    diff = max(abs(a - b) for a, b in zip(runs[256]["losses"], runs[0]["losses"]))
    for chunk, r in runs.items():
        log(f"phase13b bloom-7b1 2 layers bf16 zero2 B2xT2048 loss_chunk={chunk}: "
            f"losses={r['losses']} grad_norms={r['norms']} "
            f"step_ms={[round(x, 3) for x in r['step_ms']]} "
            f"state_gb={r['base'] / 1e9:.3f} peak_memory_gb={r['peak'] / 1e9:.3f} "
            f"flash_launches={r['flash']}")
    log(f"phase13b chunked peak below the unchunked by {saved / 1e9:.3f} GB (one fp32 "
        f"[2, 2048, {V}] tensor is {logits_bytes / 1e9:.3f} GB; limit 3/4 of it); "
        f"largest loss difference {diff:.3e}; ln(V)={math.log(V):.4f}, the input token's "
        f"own logit at init ~ d_model * 0.02 = {cfg.d_model * 0.02:.1f}")
    # the step-1 loss is not near ln(V) at Bloom's width: under the embedding
    # LayerNorm and the tied head the init's hidden state carries the input
    # token's embedding / 0.02, so that token's logit is ~ d_model * 0.02 (the
    # JAX package's init gives the same); both runs start from the same state
    first = [r["losses"][0] for r in runs.values()]
    check(abs(first[0] - first[1]) <= 1e-4 * abs(first[1]), f"bloom step-1 losses {first}")
    for r in runs.values():
        check(all(math.isfinite(x) for x in r["losses"] + r["norms"]), "bloom loss not finite")
        check(r["losses"][-1] < r["losses"][0], f"bloom loss did not fall: {r['losses']}")
        check(r["flash"] == 0, f"a biased training step reached B1/B2: {r['flash']} launches")
    check(all(abs(a - b) <= 2e-2 * abs(b) for a, b in zip(runs[256]["losses"], runs[0]["losses"])),
          f"chunked and unchunked losses differ by up to {diff}")
    check(saved >= 0.75 * logits_bytes, f"the chunked loss saved {saved / 1e9:.3f} GB")

    # (c) GPT-2-125M fp32, phase 5a's batches and 5 steps with loss_chunk 128:
    # 5a's unchunked losses and grad norms, and its B1 / B2 launches
    batches, loss_5a, norm_5a, launches_5a = ctx["train5a"]
    engine = _engine(_train_config(4), dataclasses.replace(gpt.PRESETS["gpt2-125m"],
                                                           loss_chunk=128))
    fa, _ = _reset_counts()  # the chunked fp32 training path
    metrics = [engine.train_batch(b) for b in batches]
    torch.cuda.synchronize()
    launches = _flash_launches(fa)
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    del engine
    torch.cuda.empty_cache()
    log(f"phase13c train fp32 gpt2-125m B4xT512 loss_chunk=128: losses={losses} "
        f"grad_norms={norms}; 5a unchunked losses={loss_5a} grad_norms={norm_5a}; "
        f"largest rel diff loss {max(abs(a / b - 1) for a, b in zip(losses, loss_5a)):.3e} "
        f"grad norm {max(abs(a / b - 1) for a, b in zip(norms, norm_5a)):.3e}; "
        f"launches={launches}")
    check(np.allclose(losses, loss_5a, rtol=1e-5, atol=0), "chunked losses differ from 5a's")
    check(np.allclose(norms, norm_5a, rtol=1e-5, atol=0), "chunked grad norms differ from 5a's")
    check(launches == launches_5a, f"chunked launches {launches}, 5a's {launches_5a}")

    # (d) GPT-2-125M with GPT-Neo's alternation, window 128, fp32 B4 prompt
    # 512 + 16: every layer biased (zero on the global ones), plain path
    local = dataclasses.replace(gpt.PRESETS["gpt2-125m"], local_attention_period=2,
                                window_size=128)
    prompt = np.random.default_rng(1).integers(0, local.vocab_size, (4, 512)).astype(np.int32)
    out, err, match, decode_launches, flash, gen_s = _cached_vs_uncached(
        torch, local, ctx["params"], prompt, 16)
    log(f"phase13d gpt2-125m local period 2 window 128 fp32 B4 prompt512 new16: cached vs "
        f"uncached max err {err:.3e} of the largest, greedy match {match:.4f}, "
        f"decode_launches={decode_launches} flash_fwd_launches={flash}")
    check(err <= CACHED_TOL, f"local-window cached logits differ from the uncached: {err:.3e}")
    check(decode_launches == 0 and flash == 0,
          f"a windowed layer reached a kernel: B3 {decode_launches}, B1 {flash}")


def phase_decoding_modes(torch, ctx):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import for_gpt
    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    params = ctx["params"]
    prompt, greedy = ctx["greedy4"]  # phase 4's fp32 prompt and greedy tokens
    new = 64
    expected = cfg.n_layer * (new - 1)
    engine = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype="float32")
    for kw in ({"top_k": 1}, {"top_p": 1e-6}):
        fa, da = _reset_counts()  # the sampled decode path
        out = engine.generate(prompt, max_new_tokens=new, temperature=1.0, seed=3, **kw)
        log(f"phase14 fp32 temperature=1 {kw}: greedy match "
            f"{float(np.mean(out == greedy)):.4f} decode_launches={da.launches}")
        check(np.array_equal(out, greedy), f"{kw} is not phase 4's greedy decoding")
        check(da.launches == expected, f"{kw}: {da.launches} B3 launches, expected {expected}")
    kw = dict(max_new_tokens=new, temperature=1.0, top_k=50, seed=7)
    a, b = engine.generate(prompt, **kw), engine.generate(prompt, **kw)
    log(f"phase14 fp32 temperature=1 top_k=50 seed=7 twice: identical={np.array_equal(a, b)}, "
        f"match to greedy {float(np.mean(a[:, 512:] == greedy[:, 512:])):.4f}")
    check(np.array_equal(a, b), "seeded sampling is not reproducible")

    # beam search, 4 beams: every step's decode through B3 over the B*K rows
    rows = []
    decode_attention = gpt.decode_attention

    def recording(q, *args, **kw):
        rows.append(q.shape[0])
        return decode_attention(q, *args, **kw)

    plain = deepspeed_tpu_torch.init_inference(
        for_gpt(dataclasses.replace(cfg, use_flash=False), params), dtype="float32")
    gpt.decode_attention = recording
    try:
        fa, da = _reset_counts()  # the beam-search decode path
        t0 = time.perf_counter()
        beam = engine.generate(prompt, max_new_tokens=new, num_beams=4)
        beam_s = time.perf_counter() - t0
        beam_launches = da.launches
    finally:
        gpt.decode_attention = decode_attention
    ref = plain.generate(prompt, max_new_tokens=new, num_beams=4)
    log(f"phase14 fp32 beam search K=4: tokens equal to the plain path's "
        f"{np.array_equal(beam, ref)} (match {float(np.mean(beam == ref)):.4f}), match to "
        f"greedy {float(np.mean(beam[:, 512:] == greedy[:, 512:])):.4f}, "
        f"decode_launches={beam_launches} rows per launch {sorted(set(rows))} "
        f"generate_s={beam_s:.2f}")
    check(np.array_equal(beam, ref), "fp32 beam search differs from the plain path's")
    check(beam_launches == expected, f"beam: {beam_launches} B3 launches, expected {expected}")
    check(set(rows) == {16}, f"beam decode rows {sorted(set(rows))}, expected 16")
    del engine, plain
    torch.cuda.empty_cache()

    bf16 = deepspeed_tpu_torch.init_inference(for_gpt(cfg, params), dtype="bfloat16")
    for name, kw in (("greedy", {}), ("sampled t1 top_k50", dict(temperature=1.0, top_k=50)),
                     ("beam K4", dict(num_beams=4))):
        prefill_ms, gen_ms, tok_s = _generate_rate(bf16, prompt, new, **kw)
        log(f"phase14 bf16 {name} B4 prompt512 new64: prefill_ms={prefill_ms:.2f} "
            f"generate_ms={gen_ms:.2f} tokens_per_s={tok_s:.1f}")


# phase 15: the serving levers on phase 6's cell. The chat-style workload of
# the reference bench's prefix lever row: every prompt opens with the system
# prompt (arange(prefix_len) * 7 + 3) % V, prefix_len = 2 pages = 128 tokens,
# exactly one prefill chunk. 15b is the reference's overload worker at full
# width: 2x the saturation rate, 24 requests, seed 5, SLO 2 s.
LEVER_PREFIX_PAGES = 2
OVERLOAD = dict(factor=2.0, requests=24, seed=5, slo_s=2.0, max_wall_s=120.0)


def phase_serving_levers(torch, ctx):
    from deepspeed_tpu_torch.inference.serving import (ContinuousBatchingScheduler, RequestState,
                                                       ServingConfig, ServingEngine,
                                                       estimate_saturation_rps,
                                                       make_open_loop_workload, run_continuous)
    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    params = ctx["params"]
    ps = SERVE_CFG["page_size"]

    # (a) the copy-on-write prefix cache, fp32: off, on, on with n-gram
    # speculation, on at pool 9 (preemption of borrowers)
    sysp = ((np.arange(LEVER_PREFIX_PAGES * ps) * 7 + 3) % cfg.vocab_size).astype(np.int32)
    rep_off, toks_off, _, _, _ = _serve(torch, cfg, params, "float32", system_prompt=sysp)
    ctx["toks_15a_off"] = toks_off  # phase 19d's bar
    log(f"phase15a fp32 prefix cache off: physical/logical="
        f"{rep_off['physical_logical_page_ratio']} page_stats={rep_off['page_stats']}")
    for name, over in (("on", {}), ("on spec_k4", SPEC), ("on pool9", {"num_pages": 9})):
        rep, toks, wl, _, eng = _serve(torch, cfg, params, "float32", system_prompt=sysp,
                                       enable_prefix_cache=True, **over)
        sched = eng.last_scheduler
        stats, ratio = rep["page_stats"], rep["physical_logical_page_ratio"]
        index = sched.prefix_cache
        log(f"phase15a fp32 prefix cache {name}: match vs cache off={_match(toks, toks_off):.4f} "
            f"shared_pages={stats['shared']} physical/logical={ratio} (cache off "
            f"{rep_off['physical_logical_page_ratio']}) index hits={index.hits} "
            f"misses={index.misses} preemptions={rep['preemptions']} "
            f"borrowed_preemptions={rep['borrowed_preemptions']} at the end: audit_ok="
            f"{sched.audit()['ok']} allocated={sched.allocator.allocated_pages} "
            f"indexed={len(index)} ttft_p50_ms={rep['ttft_p50_ms']} "
            f"tokens_per_sec={rep['tokens_per_sec']}")
        if toks != toks_off:
            log("phase15a first differing request: " + _first_flip(
                torch, cfg, params, toks, toks_off, wl, names=(f"cache {name}", "cache off")))
        check(toks == toks_off, f"prefix cache {name}: tokens differ from the cache-off run")
        check(stats["shared"] > 0 and ratio < 1,
              f"prefix cache {name}: nothing shared ({stats}, ratio {ratio})")
        check(sched.audit()["ok"] and sched.allocator.allocated_pages == 0 and not len(index),
              f"prefix cache {name}: pages or index entries left at the end")
        if "num_pages" in over:
            check(rep["borrowed_preemptions"] >= 1,
                  "pool 9 preempted no slot holding borrowed pages")
        del eng, sched
    torch.cuda.empty_cache()

    # (b) overload control, bf16: the reference's overload worker at full width
    eng = ServingEngine(cfg, params, ServingConfig(**SERVE_CFG, dtype="bfloat16"))
    eng.warmup()
    _, _, prompts, gens = SERVE_WORKLOAD
    sat = estimate_saturation_rps(eng, prompts, gens, cfg.vocab_size)
    calib = dict(eng.last_scheduler.counters)
    check(not any(k.startswith("dispatch_") for k in calib), f"15b calibration: {calib}")
    rate = OVERLOAD["factor"] * sat
    slo = OVERLOAD["slo_s"]
    decoded = {"steps": 0}
    decode = eng.decode

    def counted_decode(*args, steps=1, **kw):
        decoded["steps"] += steps
        return decode(*args, steps=steps, **kw)

    eng.decode = counted_decode
    reps = {}
    for side in ("controlled", "uncontrolled"):
        kw = (dict(max_queue=eng.num_slots, max_queued_tokens=eng.hbm_token_slots(),
                   ttft_deadline_s=slo / 2, deadline_s=slo) if side == "controlled" else {})
        sched = ContinuousBatchingScheduler(
            executor=eng, num_slots=eng.num_slots, num_pages=eng.num_pages, page_size=ps,
            pages_per_seq=eng.serving.pages_per_seq, decode_block=eng.serving.decode_block,
            max_context=eng.serving.max_model_len, **kw)
        wl = make_open_loop_workload(OVERLOAD["requests"], rate, prompts, gens, cfg.vocab_size,
                                     seed=OVERLOAD["seed"])
        decoded["steps"] = 0
        fa, da = _reset_counts()  # the overload-controlled (or not) serving path
        rep = run_continuous(eng, wl, max_wall_s=OVERLOAD["max_wall_s"], slo_s=slo,
                             scheduler=sched)
        torch.cuda.synchronize()
        reps[side] = rep
        states = {st.value: sum(r.state is st for r in wl) for st in RequestState}
        c = rep["recovery_counters"]
        log(f"phase15b bf16 overload {side}: saturation_rps={sat:.3f} offered_rps={rate:.3f} "
            f"slo_s={slo} goodput_tokens_per_sec={rep['goodput_tokens_per_sec']} "
            f"shed_rate={rep['shed_rate']} deadline_miss_rate={rep['deadline_miss_rate']} "
            f"accepted_ttft_p99_ms={rep['ttft_p99_ms']} ttft_p50_ms={rep['ttft_p50_ms']} "
            f"tokens_per_sec={rep['tokens_per_sec']} unfinished={rep['unfinished']} "
            f"states={states} counters={c} preemptions={rep['preemptions']} "
            f"decode_steps={decoded['steps']} B4_launches={da.paged_launches} "
            f"audit_ok={rep['pool_audit_ok']} allocated={sched.allocator.allocated_pages} "
            f"wall_s={rep['wall_s']}")
        check(rep["pool_audit_ok"] and sched.allocator.allocated_pages == 0,
              f"15b {side}: the audit failed or pages are left")
        check(not any(k.startswith("dispatch_") for k in c), f"15b {side}: {c}")
        check(da.paged_launches == cfg.n_layer * decoded["steps"] and decoded["steps"] > 0,
              f"15b {side}: B4 launches {da.paged_launches}, steps {decoded['steps']}")
        if side == "controlled":
            check(rep["unfinished"] == 0 and states["queued"] == states["running"] == 0,
                  f"15b: controlled requests left unfinished: {states}")
    del eng
    torch.cuda.empty_cache()

    # (c) dispatch-fault recovery on the device executor, fp32: every decode
    # block of 4 steps raises; one retry, quarantine after 2 failed episodes
    rep, toks, _, _, eng = _serve(torch, cfg, params, "float32", fail_blocks=(4,),
                                  dispatch_retries=1, quarantine_after=2)
    c, sched = rep["recovery_counters"], eng.last_scheduler
    log(f"phase15c fp32 decode blocks of 4 fail: match vs 6a={_match(toks, ctx['toks_6a']):.4f} "
        f"counters={c} quarantined={sorted(sched._quarantined_blocks)} "
        f"decode_blocks={rep['decode_blocks']} preemptions={rep['preemptions']} "
        f"audit_ok={sched.audit()['ok']}")
    check(toks == ctx["toks_6a"], "15c: healed tokens differ from 6a's")
    check(c.get("block_quarantined") == 1 and c.get("dispatch_failed") == 2
          and c.get("dispatch_error") == 4, f"15c: recovery counters {c}")
    check(sched._quarantined_blocks == {4} and set(rep["decode_blocks"]) <= {1, 2},
          f"15c: blocks {rep['decode_blocks']}, quarantined {sched._quarantined_blocks}")
    check(sched.audit()["ok"] and sched.allocator.allocated_pages == 0, "15c: audit")


# phase 16: the quantized gradient exchange (int8 / int4, block 256, error
# feedback) and data parallelism at two ranks on the one card
QGRAD_EF = {"stage": 2, "zero_quantized_gradients": True, "zero_quantize_error_feedback": True}
DP_WORLD = 2
DP_STEPS = 2
# the dp2 runs of 16c: each stage dense, then stage 2 with the quantized exchange
DP_CASES = (("stage0", {"stage": 0}), ("stage1", {"stage": 1}), ("stage2", {"stage": 2}),
            ("qgrad", QGRAD_EF))
DP_JOIN_S = 420.0  # a rank that has not finished by then has hung: the phase fails
# the bytes of a rank's master copy and optimizer state at stages 1-2 against world 1's:
# half, and the 1-D and [L, n] leaves whole (about 0.1% of GPT-2-125M)
DP_OPT_SHARE = 0.502
# 16c's final params against world 1's. The two runs sum each gradient in
# another order; AdamW's normalized update (m / (sqrt(v) + eps), about +-1
# where a gradient's terms nearly cancel) turns a last-bit difference of
# such an entry into up to 2 lr a step. So: within 2e-5 but for at most a
# millionth of the entries, and none past 2 lr a step (lr 6e-4, 3 steps)
DP_PARAM_ATOL = 2e-5
DP_PARAM_OUTLIERS = 1e-6
DP_PARAM_MAX = 2 * 6e-4 * DP_STEPS


def _dp_batches(V):
    """16c's global batches (B4 x T512, 2 rows a rank) and 16d's next step."""
    rng = np.random.default_rng(16)
    return [{"input_ids": rng.integers(0, V, (4, 512)).astype(np.int32)}
            for _ in range(DP_STEPS + 1)]


def _param_checksum(torch, engine):
    """Per leaf, the int64 sum of the fp32 params' bits (host list): two
    ranks' lists are equal where their params are bitwise equal."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    return torch.stack([p.detach().view(torch.int32).long().sum()
                        for p in tree_leaves(engine.state["params"])]).tolist()


def _state_bytes(engine):
    """The bytes of the master copy and the optimizer state this rank keeps."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    st = engine.state
    return sum(t.numel() * t.element_size() for t in tree_leaves(
        {"master": st["master"], "mu": st["opt"].mu, "nu": st["opt"].nu}))


def _stored_slices_differ(torch, engine, tag_dir):
    """Keys of ``engine``'s state whose leaf is not bitwise this rank's slice
    of the stored full leaf (the params by param_spec, the master copy and
    the moments by opt_spec; the counters whole). The residuals are left
    out: a load at another world size resets them."""
    import os

    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths, read_meta

    def walk(tree, prefix, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/", out)
            else:
                out[f"{prefix}{k}"] = v
        return out

    dims = {f"params/{k}": d for k, d in walk(engine.param_specs, "", {}).items()}
    for tree in ("master", "opt/mu", "opt/nu"):
        dims.update({f"{tree}/{k}": d for k, d in walk(engine.opt_specs, "", {}).items()})
    directory = os.path.join(tag_dir, "state")
    index = {m["key"]: m["index"] for m in read_meta(directory)["leaves"]}
    bad = []
    for key, leaf in flatten_with_paths(engine.state):
        if key.startswith("qgrad"):
            continue
        arr = np.load(os.path.join(directory, "arrays", f"{index[key]}.npy"))
        want = torch.from_numpy(engine.zero_policy.shard(arr, dims.get(key)).copy())
        if not torch.equal(leaf.detach().cpu(), want):
            bad.append(key)
    return bad


def _dp_rank_main(rank, world, store, out_dir, part):
    """One of 16c / 16d's two rank processes on the one card (gloo, the
    collectives through host memory). ``part`` "train": DP_CASES' DP_STEPS
    steps each (losses, grad norms, params checksums after every step, step
    ms, launches, the state's bytes, the wire ledger; rank 0 saves each
    case's final params), the qgrad run saving a tag after its last step;
    "load": the world-1 tag saved after the next step loads, each leaf checked against its
    slice of the stored one. Writes ``rank<r>_<part>.json``."""
    import os

    import torch

    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
    from deepspeed_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False  # phase 1's setting, in this process too
    torch.backends.cudnn.allow_tf32 = False
    comm.init_distributed(init_method=f"file://{store}", world_size=world, rank=rank,
                          backend="gloo", device="cuda")
    cfg = gpt.PRESETS["gpt2-125m"]
    batches = _dp_batches(cfg.vocab_size)
    out = {"backend": torch.distributed.get_backend(), "world": comm.get_world_size()}
    if part == "train":
        for name, zero in DP_CASES:
            engine = _engine(_train_config(4 // world, zero_optimization=zero), cfg)
            wire_ledger.reset()
            fa, _ = _reset_counts()  # this rank's fp32 data-parallel training path
            rec = {"losses": [], "norms": [], "sums": [], "step_ms": []}
            for b in batches[:DP_STEPS]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = engine.train_batch(b)
                rec["losses"].append(m["loss"].item())
                rec["norms"].append(m["grad_norm"].item())
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["sums"].append(_param_checksum(torch, engine))
            rec["launches"] = _flash_launches(fa)
            rec["state_bytes"] = _state_bytes(engine)
            rec["ledger"] = wire_ledger.summary_dict()
            for key in ("qgrad_residual", "qgrad_bucket_residual"):
                if key in engine.state:
                    r = engine.state[key]
                    rec[key] = {"shape": list(r.shape), "finite": bool(torch.isfinite(r).all()),
                                "nonzero": bool(r.any())}
            if rank == 0:
                torch.save({k: v.detach().cpu() for k, v in
                            flatten_with_paths(engine.state["params"])},
                           os.path.join(out_dir, f"dp2_{name}.pt"))
            if name == "qgrad":
                engine.save_checkpoint(os.path.join(out_dir, "tags_dp2"))
            out[name] = rec
            del engine
            torch.cuda.empty_cache()
    else:
        engine = _engine(_train_config(4 // world, zero_optimization=QGRAD_EF), cfg, seed=1)
        engine.load_checkpoint(os.path.join(out_dir, "tags_w1"))
        tag = os.path.join(out_dir, "tags_w1", f"global_step{DP_STEPS + 1}")
        out["load"] = {"differ": _stored_slices_differ(torch, engine, tag),
                       "global_steps": engine.global_steps, "cursor": engine.data_cursor,
                       "resid_zero": not any(bool(engine.state[k].any()) for k in
                                             ("qgrad_residual", "qgrad_bucket_residual"))}
    comm.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}_{part}.json"), "w") as f:
        json.dump(out, f)


def _dp_spawn(torch, out_dir, part):
    """DP_WORLD rank processes of ``_dp_rank_main`` on the one card, joined
    with a deadline (a hung rank is killed and fails the phase); returns
    each rank's results."""
    import os

    import torch.multiprocessing as mp

    store = os.path.join(out_dir, f"store_{part}")
    ctx = mp.start_processes(_dp_rank_main, args=(DP_WORLD, store, out_dir, part),
                             nprocs=DP_WORLD, join=False, start_method="spawn")
    end = time.monotonic() + DP_JOIN_S
    while not ctx.join(timeout=max(0.1, end - time.monotonic())):
        if time.monotonic() >= end:
            for proc in ctx.processes:
                proc.kill()
            raise Failed(f"16 {part}: the {DP_WORLD} rank processes did not finish within "
                         f"{DP_JOIN_S} s")
    out = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}_{part}.json")) as f:
            out.append(json.load(f))
    return out


def phase_data_parallel(torch, ctx):
    """Phase 16: the quantized gradient exchange and data parallelism below
    stage 3 on GPT-2-125M at full width and depth, from seed 0. (a) 5b's
    configuration with ``zero_quantized_gradients`` (int8, block 256),
    error feedback and the per-layer buckets, 10 steps on 5b's batch,
    beside a dense ZeRO-2 step 1 and 5b's numbers; int4, 3 steps. (b) fp16
    with a NaN residual: the step overflows, the residuals are zeroed, the
    next step is finite. (c) two rank processes on the one card over gloo,
    fp32 B4 x T512, stages 0, 1, 2 and stage 2 with the quantized exchange,
    DP_STEPS steps each, against the same runs at world size 1. (d) the dp2
    qgrad run's tag loads at world size 1; one more step; that engine's tag
    loads back
    into two ranks, each getting its slices bitwise."""
    import os
    import shutil
    import tempfile

    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths, read_meta
    from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    cfg = gpt.PRESETS["gpt2-125m"]
    V, L = cfg.vocab_size, cfg.n_layer
    batch = ctx["train5b_batch"]

    # (a) the quantized exchange at one rank, bf16 + fp32 master, B8 x T512
    dense = _engine(_train_config(8, bf16={"enabled": True}, zero_optimization={"stage": 2}),
                    cfg)
    m = dense.train_batch(batch)
    loss_d, norm_d = m["loss"].item(), m["grad_norm"].item()
    dense_kernels = device_kernels(torch, lambda: dense.train_batch(batch))
    del dense
    torch.cuda.empty_cache()
    engine = _engine(_train_config(8, bf16={"enabled": True}, zero_optimization=QGRAD_EF), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wire_ledger.reset()
    fa, _ = _reset_counts()  # the bf16 quantized-exchange training main path
    losses, norms, step_ms, host_ms = _timed_steps(torch, engine, batch, 10)
    launches = _flash_launches(fa)
    ledger = wire_ledger.summary_dict()
    tokens_per_s = engine.tokens_per_sec()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady_ms = float(np.median(step_ms[1:]))
    resid = {k: (bool(torch.isfinite(engine.state[k]).all()), bool(engine.state[k].any()),
                 list(engine.state[k].shape))
             for k in ("qgrad_residual", "qgrad_bucket_residual")}
    kernels = device_kernels(torch, lambda: engine.train_batch(batch))
    busy_q = sum(r[2] for r in kernels)
    busy_d = sum(r[2] for r in dense_kernels)
    share = f"{(busy_q - busy_d) / busy_q:.3f}" if busy_q else "not measured"
    z2 = ctx["train5b"]
    log(f"phase16a train bf16 master zero2 qgrad int8 block256 EF buckets gpt2-125m B8xT512: "
        f"losses={losses} grad_norms={norms} dense zero2 step 1: loss={loss_d} "
        f"grad_norm={norm_d} step-1 loss bitwise={losses[0] == loss_d} grad-norm rel diff="
        f"{abs(norms[0] - norm_d) / norm_d:.4e} launches over 10 steps={launches} "
        f"residuals (finite, nonzero, shape)={resid}")
    log(f"phase16a step_ms (CUDA events, median of steps 2-10)={steady_ms:.3f} "
        f"step_ms_all={[round(x, 3) for x in step_ms]} host_issue_ms (median of steps 2-10)="
        f"{float(np.median(host_ms[1:])):.3f} tokens_per_s={tokens_per_s:.1f} "
        f"peak_memory_gb={peak_gb:.3f}; phase5b in this run: step_ms={z2['step_ms']:.3f} "
        f"host_issue_ms={z2['host_ms']:.3f} tokens_per_s={z2['tokens_per_s']:.1f} "
        f"peak_memory_gb={z2['peak_gb']:.3f}")
    log(f"phase16a profile of one step: " + device_breakdown(torch, None, steady_ms, top=6,
                                                              kernels=kernels)
        + f"; dense zero2 step device_busy_ms={busy_d:.3f}; the exchange's share of the busy "
        f"time (qgrad busy - dense busy) / qgrad busy={share}")
    log("phase16a wire ledger over 10 steps: " + "; ".join(
        f"{n} count={r['count']} logical={r['logical_bytes']} wire={r['wire_bytes']} "
        f"ratio={r['ratio']}" for n, r in ledger.items()))
    check(abs(losses[0] - loss_d) <= 1e-6 * abs(loss_d),
          f"16a step-1 loss {losses[0]} differs from the dense step's {loss_d}")
    check(abs(norms[0] - norm_d) <= 0.1 * norm_d, f"16a step-1 grad norm {norms[0]} vs {norm_d}")
    check(abs(losses[0] - math.log(V)) < 0.5, f"16a step-1 loss {losses[0]} far from ln(V)")
    check(losses[-1] < losses[0], f"16a loss did not fall: {losses}")
    check(all(math.isfinite(x) for x in losses + norms), "16a loss or grad norm not finite")
    check(all(f and nz for f, nz, _ in resid.values()), f"16a residuals: {resid}")
    want = {"qgrad_bucket_rs[dp]": 10 * L, "qgrad_bucket_ag[dp]": 10 * L,
            "qgrad_reduce_scatter[dp]": 10, "qgrad_all_gather[dp]": 10}
    check({n: r["count"] for n, r in ledger.items()} == want, f"16a ledger counts {ledger}")
    check(all(r["ratio"] >= 3.5 for r in ledger.values()), f"16a ledger ratios {ledger}")
    expected = path_launches(launches, 10 * L, _flash_path("bfloat16"))
    check(launches == expected, f"16a launches {launches}, expected {expected}")
    del engine
    torch.cuda.empty_cache()
    engine = _engine(_train_config(8, bf16={"enabled": True}, zero_optimization={
        **QGRAD_EF, "zero_quantize_bits": 4}), cfg)
    wire_ledger.reset()
    _reset_counts()  # the int4 exchange's training path
    losses4 = [engine.train_batch(batch)["loss"].item() for _ in range(3)]
    ledger4 = wire_ledger.summary_dict()
    log(f"phase16a int4: losses={losses4} ledger ratios="
        f"{ {n: r['ratio'] for n, r in ledger4.items()} }")
    check(all(math.isfinite(x) for x in losses4), f"16a int4 losses {losses4}")
    check(all(r["ratio"] >= 7 for r in ledger4.values()), f"16a int4 ledger {ledger4}")
    del engine
    torch.cuda.empty_cache()

    # (b) the overflow reset: fp16 with the fp32 master, a NaN residual
    engine = _engine(_train_config(8, fp16={"enabled": True}, zero_optimization=QGRAD_EF), cfg)
    engine.state["qgrad_residual"].fill_(float("nan"))
    m1 = engine.train_batch(batch)
    after = {k: (bool(torch.isfinite(engine.state[k]).all()), bool(engine.state[k].any()))
             for k in ("qgrad_residual", "qgrad_bucket_residual")}
    m2 = engine.train_batch(batch)
    log(f"phase16b fp16 master qgrad EF B8xT512, NaN residual: step 1 overflow="
        f"{bool(m1['overflow'])} skipped_steps={engine.skipped_steps} residuals after (finite, "
        f"nonzero)={after}; step 2 overflow={bool(m2['overflow'])} loss={m2['loss'].item()} "
        f"loss_scale={m2['loss_scale'].item()}")
    check(bool(m1["overflow"]) and engine.skipped_steps == 1, "16b: the NaN step did not skip")
    check(all(f and not nz for f, nz in after.values()), f"16b residuals after: {after}")
    check(not bool(m2["overflow"]) and math.isfinite(m2["loss"].item()), "16b: no recovery")
    del engine
    torch.cuda.empty_cache()

    # (c) two ranks on the one card over gloo, against world size 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"phase16c compute_mode={smi.stdout.strip() or smi.stderr.strip()} (two rank processes "
        "share the card; a card that refuses a second process fails this phase)")
    out_dir = tempfile.mkdtemp(prefix="dp16_")
    try:
        free_gb = shutil.disk_usage(out_dir).free / 1e9
        log(f"phase16c files under {out_dir}: {free_gb:.1f} GB free")
        batches = _dp_batches(V)
        world1, finals = {}, {}
        for name, zero in DP_CASES:
            e = _engine(_train_config(4, zero_optimization=zero), cfg)
            ms = [e.train_batch(b) for b in batches[:DP_STEPS]]
            world1[name] = dict(losses=[x["loss"].item() for x in ms],
                                norms=[x["grad_norm"].item() for x in ms],
                                state_bytes=_state_bytes(e))
            finals[name] = {k: v.detach().clone() for k, v in
                            flatten_with_paths(e.state["params"])}
            del e, ms
        torch.cuda.empty_cache()
        ranks = _dp_spawn(torch, out_dir, "train")
        for r, rank in enumerate(ranks):
            log(f"phase16c rank {r}: backend={rank['backend']} world={rank['world']} "
                + " ".join(f"{n}: step_ms={[round(x, 1) for x in rank[n]['step_ms']]}"
                           for n, _ in DP_CASES)
                + " (gloo: every collective crosses host memory, no figure for NCCL)")
            check(rank["backend"] == "gloo" and rank["world"] == DP_WORLD, f"16c rank {r}")
        for name, _ in DP_CASES:
            w1 = world1[name]
            full = torch.load(os.path.join(out_dir, f"dp2_{name}.pt"))
            diffs = {k: (full[k].to(v.device) - v).abs() for k, v in finals[name].items()}
            err = max(float(d.max()) for d in diffs.values())
            worst = max(diffs, key=lambda k: float(diffs[k].max()))
            n_over = sum(int((d > DP_PARAM_ATOL).sum()) for d in diffs.values())
            numel = sum(d.numel() for d in diffs.values())
            del full, diffs
            os.remove(os.path.join(out_dir, f"dp2_{name}.pt"))
            recs = [rank[name] for rank in ranks]
            share = recs[0]["state_bytes"] / w1["state_bytes"]
            log(f"phase16c {name} dp2 fp32 gpt2-125m B4xT512 (2 rows a rank): "
                f"losses={[x['losses'] for x in recs]} world1={w1['losses']} "
                f"grad_norms={[x['norms'] for x in recs]} world1={w1['norms']} ranks' params "
                f"equal after every step={recs[0]['sums'] == recs[1]['sums']} final params "
                f"max_abs_err vs world1={err:.3e} (in {worst}; {n_over} of {numel} entries "
                f"past {DP_PARAM_ATOL}) state bytes a rank / world1={share:.5f} "
                f"launches={[x['launches'] for x in recs]} "
                + (f"ledger={[x['ledger'] for x in recs]} residuals="
                   f"{[{k: x[k] for k in ('qgrad_residual', 'qgrad_bucket_residual')} for x in recs]}"
                   if name == "qgrad" else ""))
            check(recs[0]["sums"] == recs[1]["sums"], f"16c {name}: the ranks' params differ")
            for r, rec in enumerate(recs):
                expected = path_launches(rec["launches"], DP_STEPS * L, _flash_path("float32"))
                check(rec["launches"] == expected,
                      f"16c {name} rank {r}: launches {rec['launches']}, expected {expected}")
                if name != "qgrad":
                    check(np.allclose(rec["losses"], w1["losses"], rtol=1e-5, atol=0),
                          f"16c {name} rank {r}: losses {rec['losses']} vs {w1['losses']}")
                    check(np.allclose(rec["norms"], w1["norms"], rtol=1e-4, atol=0),
                          f"16c {name} rank {r}: grad norms {rec['norms']} vs {w1['norms']}")
            if name == "qgrad":
                dense2 = ranks[0]["stage2"]
                check(abs(recs[0]["losses"][0] - dense2["losses"][0])
                      <= 1e-6 * abs(dense2["losses"][0]),
                      f"16c qgrad step-1 loss {recs[0]['losses'][0]} vs {dense2['losses'][0]}")
                check(abs(recs[0]["norms"][0] - dense2["norms"][0]) <= 0.1 * dense2["norms"][0],
                      f"16c qgrad step-1 grad norm {recs[0]['norms'][0]} vs dense "
                      f"{dense2['norms'][0]}")
                check(all(math.isfinite(x) for rec in recs for x in rec["losses"]),
                      "16c qgrad losses not finite")
                for r, rec in enumerate(recs):
                    check(all(v["finite"] and v["nonzero"] for v in (
                        rec["qgrad_residual"], rec["qgrad_bucket_residual"])),
                          f"16c qgrad rank {r}: residual rows {rec['qgrad_residual']}")
                    check(all(x["ratio"] >= 3.5 for x in rec["ledger"].values()),
                          f"16c qgrad rank {r}: ledger {rec['ledger']}")
            else:
                check(n_over <= DP_PARAM_OUTLIERS * numel and err <= DP_PARAM_MAX,
                      f"16c {name}: final params {err} from world 1's, {n_over} entries past "
                      f"{DP_PARAM_ATOL}")
                if name == "stage0":
                    check(share == 1.0, f"16c stage0: a rank keeps {share} of the state")
                else:
                    check(share <= DP_OPT_SHARE, f"16c {name}: a rank keeps {share} of the state")
        del finals

        # (d) reshard on the card: the dp2 qgrad tag at world 1, then back at dp2
        tag = os.path.join(out_dir, "tags_dp2", f"global_step{DP_STEPS}")
        e = _engine(_train_config(4, zero_optimization=QGRAD_EF), cfg, seed=1)
        e.load_checkpoint(os.path.join(out_dir, "tags_dp2"))
        directory = os.path.join(tag, "state")
        index = {mm["key"]: mm["index"] for mm in read_meta(directory)["leaves"]}
        differ, resid_zero = [], True
        for key, leaf in flatten_with_paths(e.state):
            if key.startswith("qgrad"):
                resid_zero = resid_zero and not bool(leaf.any())
                continue
            arr = np.load(os.path.join(directory, "arrays", f"{index[key]}.npy"))
            if not torch.equal(leaf.detach().cpu(), torch.from_numpy(arr)):
                differ.append(key)
        shapes = {k: list(e.state[k].shape) for k in ("qgrad_residual", "qgrad_bucket_residual")}
        loaded = (e.global_steps, e.data_cursor)
        fa, _ = _reset_counts()  # the resumed world-1 step
        m4 = e.train_batch(batches[DP_STEPS])
        torch.cuda.synchronize()
        launches = _flash_launches(fa)
        log(f"phase16d the dp2 tag at world 1: leaves differing from the stored ones={differ} "
            f"residuals zero={resid_zero} at {shapes} (global_steps, data_cursor)={loaded} "
            f"step {DP_STEPS + 1} loss={m4['loss'].item()} launches={launches}")
        check(not differ, f"16d: loaded leaves differ: {differ}")
        check(resid_zero and shapes["qgrad_residual"][0] == 1, f"16d residuals {shapes}")
        check(loaded == (DP_STEPS, DP_STEPS), f"16d counters after the load {loaded}")
        check(math.isfinite(m4["loss"].item()), f"16d step {DP_STEPS + 1} not finite")
        expected = path_launches(launches, L, _flash_path("float32"))
        check(launches == expected, f"16d launches {launches}, expected {expected}")
        e.save_checkpoint(os.path.join(out_dir, "tags_w1"))
        del e
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(out_dir, "tags_dp2"))
        ranks = _dp_spawn(torch, out_dir, "load")
        for r, rank in enumerate(ranks):
            got = rank["load"]
            log(f"phase16d the world-1 tag at dp2, rank {r}: leaves not bitwise its slice="
                f"{got['differ']} global_steps={got['global_steps']} cursor={got['cursor']} "
                f"residuals zero={got['resid_zero']}")
            check(not got["differ"], f"16d rank {r}: slices differ: {got['differ']}")
            check(got["global_steps"] == got["cursor"] == DP_STEPS + 1 and got["resid_zero"],
                  f"16d rank {r}: {got}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


PHASE17_STEPS = {"loader": 20, "remat": 3, "curriculum": 5, "ltd": 6, "pld": 6}
REMAT_POLICIES = ("nothing_saveable", "save_attn_mlp_out", "dots_with_no_batch_dims_saveable",
                  "dots_saveable")
CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 128,
              "max_difficulty": 512, "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 128}}
RANDOM_LTD = {"enabled": True, "data_routing": {"enabled": True, "random_ltd": {
    "enabled": True, "total_layer_num": 12, "random_ltd_layer_num": 10,
    "random_ltd_schedule": {"min_value": 128, "max_value": 512, "schedule_type": "fixed_linear",
                            "schedule_config": {"seq_per_step": 128, "require_steps": 4}}}}}
PLD = {"enabled": True, "theta": 0.5, "gamma": 0.5}
BF16_ZERO2 = dict(bf16={"enabled": True}, zero_optimization={"stage": 2})


def _smi_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _clone_tree(torch, x):
    """A copy of a train state (dicts, named tuples, tensors)."""
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone_tree(torch, v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_clone_tree(torch, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _lockstep(torch, kern, plain, batches, before_step=None):
    """Each batch through the kernel-path engine, then through the
    plain-attention engine (``use_flash=False``) started from the state the
    kernel path had before that step: from one state the two must agree to
    phase 5a's bars. (In bf16 the plain path rounds the logits to bf16 where
    the kernels keep them in fp32, so two free-running bf16 trajectories part
    after the first update: about 1.6e-3 in step 2's grad norm on an H100,
    which 17b prints.)
    The engines' micro-step counts move together, so both draw the same
    dropout, PLD and random-LTD seeds. Per step: (loss, grad norm, plain
    loss, plain grad norm, the kernel path's launches in that step)."""
    fa, _ = _reset_counts()  # the part's training main path
    rows = []
    for s, b in enumerate(batches):
        if before_step is not None:
            before_step(s, kern, fa)
        snap = _clone_tree(torch, kern.state)
        before = _flash_launches(fa)
        m = kern.train_batch(b)
        torch.cuda.synchronize()
        after = _flash_launches(fa)
        plain.load_state(snap)
        mp = plain.train_batch(b)
        torch.cuda.synchronize()
        check(_flash_launches(fa) == after, "the plain path launched kernels")
        rows.append((m["loss"].item(), m["grad_norm"].item(), mp["loss"].item(),
                     mp["grad_norm"].item(), {k: after[k] - before[k] for k in after}))
    return rows


def _close(name, rows):
    """Phase 5a's bars, step by step, between the kernel and the plain path."""
    for s, (loss, norm, p_loss, p_norm, _) in enumerate(rows):
        check(abs(loss - p_loss) <= 1e-4 * abs(p_loss) and abs(norm - p_norm) <= 1e-3 * p_norm,
              f"{name} step {s + 1}: loss {loss} / grad norm {norm} vs plain {p_loss} / "
              f"{p_norm}")


def _rows_text(rows):
    return (f"losses={[r[0] for r in rows]} plain_losses={[r[2] for r in rows]} "
            f"grad_norms={[r[1] for r in rows]} plain_grad_norms={[r[3] for r in rows]}")


def _pair(conf, cfg):
    """(kernel-path engine, plain-attention engine), both from seed 0."""
    return _engine(conf, cfg), _engine(conf, dataclasses.replace(cfg, use_flash=False))


def _log_capture():
    """A handler on the port's logger and the list of messages it collects."""
    import logging

    from deepspeed_tpu_torch.utils.logging import logger

    lines = []

    class _H(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    h = _H()
    logger.addHandler(h)
    return h, lines


def _csv_rows(path):
    import csv

    with open(path) as f:
        return [(int(r[0]), float(r[1])) for r in list(csv.reader(f))[1:]]


def phase_engine_features(torch, ctx):
    """Phase 17: the engine features of the training path on GPT-2-125M at
    full width and depth, from seed 0, through ``initialize``: (a) the data
    loader, monitors and ``wall_clock_breakdown``; (b) every recomputing
    remat policy in bf16; (c) the seqlen curriculum; (d) random-LTD; (e)
    progressive layer drop; (f) the flops profiler. Each part's kernel path
    against the plain-attention path from the same seed and draws (phase
    5a's bars), launches counted exactly."""
    import os
    import shutil
    import tempfile

    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    card = _smi_line()
    root = tempfile.mkdtemp(prefix="features17_")
    try:
        _phase17_loader(torch, ctx, cfg, card, root)
        _phase17_remat(torch, ctx, cfg, card)
        _phase17_curriculum(torch, cfg, card)
        _phase17_random_ltd(torch, ctx, cfg, card)
        _phase17_pld(torch, ctx, cfg, card)
        _phase17_flops(torch, ctx, cfg, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase17_loader(torch, ctx, cfg, card, root):
    """(a) initialize(training_data=64 samples of 512 tokens), fp32 B4xT512,
    20 steps through a RepeatingLoader (the epoch of 16 batches wraps), CSV
    and JSONL monitors and wall_clock_breakdown on, the plain path in
    lockstep; the same batches by hand to a second kernel-path engine."""
    import json
    import os

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
    from deepspeed_tpu_torch.utils.logging import logger

    V, L, n = cfg.vocab_size, cfg.n_layer, PHASE17_STEPS["loader"]
    rng = np.random.default_rng(17)
    data = [{"input_ids": rng.integers(0, V, 512).astype(np.int32)} for _ in range(64)]
    mon = {"csv_monitor": {"enabled": True, "output_path": root, "job_name": "a"},
           "monitor_config": {"jsonl": {"enabled": True, "output_path": root, "job_name": "a"}}}
    conf = _train_config(4, steps_per_print=10, wall_clock_breakdown=True, **mon)
    model, _ = gpt.build(cfg)
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(model=model, config=conf,
                                                          training_data=data, seed=0)
    plain = _engine(_train_config(4), dataclasses.replace(cfg, use_flash=False))
    it = RepeatingLoader(loader)
    batches = [next(it) for _ in range(n)]
    handler, lines = _log_capture()
    try:
        rows = _lockstep(torch, engine, plain, batches)
    finally:
        logger.removeHandler(handler)
    losses = [r[0] for r in rows]
    del engine, plain
    torch.cuda.empty_cache()
    # the sampler replayed in numpy: epoch e's order is default_rng(0 + e)
    replay = []
    for s in range(n):
        order = np.random.default_rng(s // 16).permutation(64)
        replay.append(np.stack([data[j]["input_ids"] for j in order[4 * (s % 16):
                                                                    4 * (s % 16) + 4]]))
    same_batches = all(np.array_equal(b["input_ids"], r) for b, r in zip(batches, replay))
    by_hand = _engine(_train_config(4), cfg)
    hand = [by_hand.train_batch(b)["loss"].item() for b in batches]
    del by_hand
    torch.cuda.empty_cache()
    csv_dir = os.path.join(root, "a")
    rows_csv = {name: _csv_rows(os.path.join(csv_dir, name.replace("/", "_") + ".csv"))
                for name in ("Train/loss", "Train/lr", "Train/grad_norm",
                             "Train/samples_per_sec")}
    with open(os.path.join(csv_dir, "events.jsonl")) as f:
        jsonl = [json.loads(x) for x in f]
    jl_loss = [e["value"] for e in jsonl if e["name"] == "Train/loss"]
    timer_lines = [x for x in lines if x.startswith("time (ms) | ")]
    launches = {k: sum(r[4][k] for r in rows) for k in rows[0][4]}
    log(f"phase17a loader fp32 gpt2-125m B4xT512 {n} steps over 64 samples (an epoch of 16 "
        f"batches wraps): batches = numpy replay {same_batches}; {_rows_text(rows)}; by hand "
        f"bitwise={losses == hand}; launches over {n} micro-steps={launches}; csv rows "
        f"{ {k: len(v) for k, v in rows_csv.items()} } jsonl events={len(jsonl)}; "
        f"timer lines={timer_lines}; card={card}")
    check(same_batches, "17a: the loader's batches differ from the numpy replay")
    check(losses == hand, f"17a: loader losses {losses} != by-hand losses {hand}")
    _close("17a", rows)
    expected = path_launches(launches, n * L, _flash_path("float32"))
    check(launches == expected, f"17a launches {launches}, expected {expected}")
    for name in ("Train/loss", "Train/lr", "Train/grad_norm"):
        check([s for s, _ in rows_csv[name]] == list(range(1, n + 1)),
              f"17a: {name} rows at steps {[s for s, _ in rows_csv[name]]}")
    check([s for s, _ in rows_csv["Train/samples_per_sec"]] == list(range(3, n + 1)),
          "17a: samples_per_sec from step 3 (two warm-up steps), as in the reference")
    check([v for _, v in rows_csv["Train/loss"]] == losses and jl_loss == losses,
          "17a: the monitors' Train/loss is not the metrics' bitwise")
    check(len(timer_lines) == 2 and all("batch_input: " in x and "train_batch: " in x
                                        for x in timer_lines),
          f"17a: wall_clock_breakdown lines {timer_lines}")
    check(all(math.isfinite(x) for x in losses) and abs(losses[0] - math.log(V)) < 0.5,
          f"17a: losses {losses}")


def _phase17_remat(torch, ctx, cfg, card):
    """(b) 5b's configuration and batch, 3 steps under no remat and each
    recomputing policy: losses, launches, step ms and peak memory."""
    L, n = cfg.n_layer, PHASE17_STEPS["remat"]
    batch = ctx["train5b_batch"]
    runs = {}
    for policy in (None,) + REMAT_POLICIES:
        over = {} if policy is None else {"remat": True, "remat_policy": policy}
        engine = _engine(_train_config(8, **BF16_ZERO2), dataclasses.replace(cfg, **over))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa, _ = _reset_counts()  # the bf16 remat training main path
        losses, norms, step_ms, host_ms = _timed_steps(torch, engine, batch, n)
        runs[policy] = (losses, norms, float(np.median(step_ms[1:])),
                        torch.cuda.max_memory_allocated() / 1e9, _flash_launches(fa))
        del engine
        torch.cuda.empty_cache()
    kern, plain = _pair(_train_config(8, **BF16_ZERO2), cfg)
    rows = _lockstep(torch, kern, plain, [batch] * n)
    del kern, plain
    # the plain path free-running beside them, reported: why the parts compare in lockstep
    plain = _engine(_train_config(8, **BF16_ZERO2), dataclasses.replace(cfg, use_flash=False))
    free = [plain.train_batch(batch) for _ in range(n)]
    free = ([m["loss"].item() for m in free], [m["grad_norm"].item() for m in free])
    del plain
    torch.cuda.empty_cache()
    base = runs[None]
    for policy, (losses, norms, ms, peak, launches) in runs.items():
        log(f"phase17b remat {policy or 'none'} bf16 zero2 B8xT512 {n} steps: losses={losses} "
            f"bitwise_no_remat={losses == base[0]} grad_norms={norms} step_ms(CUDA events, "
            f"median of steps 2-{n})={ms:.3f} peak_gb={peak:.3f} launches={launches} "
            f"card={card}")
        check(np.allclose(losses, base[0], rtol=1e-4, atol=0) and
              np.allclose(norms, base[1], rtol=1e-3, atol=0),
              f"17b {policy}: {losses} / {norms} vs no remat {base[0]} / {base[1]}")
        fwd = n * L * (2 if policy is not None else 1)
        expected = {k: (fwd if k == "fwd_tc" else n * L if k in BWD_PATH["bfloat16"] else 0)
                    for k in launches}
        check(launches == expected, f"17b {policy}: launches {launches}, expected {expected}")
    log(f"phase17b no remat, the plain path in lockstep: {_rows_text(rows)}; the plain path "
        f"free-running: losses={free[0]} grad_norms={free[1]}, largest relative gap to the "
        f"kernel path {max(abs(a - b) / b for a, b in zip(free[0], base[0])):.3e} / "
        f"{max(abs(a - b) / b for a, b in zip(free[1], base[1])):.3e} (reported only)")
    check([r[0] for r in rows] == base[0], "17b: the lockstep run's losses are not no remat's")
    _close("17b", rows)
    peaks = [runs[p][3] for p in REMAT_POLICIES] + [base[3]]
    check(peaks[0] < peaks[1] < peaks[2] <= peaks[3] < peaks[4],
          f"17b: peak GB by policy {dict(zip(REMAT_POLICIES + ('none',), peaks))} out of order")


def _phase17_curriculum(torch, cfg, card):
    """(c) fixed_linear 128 -> 512 in steps of 128 over 3 steps, fp32
    B4xT512, 5 steps: T per step and 12 launches a micro-step at each T."""
    L, n = cfg.n_layer, PHASE17_STEPS["curriculum"]
    rng = np.random.default_rng(173)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (4, 512)).astype(np.int32)}
               for _ in range(n)]
    kern, plain = _pair(_train_config(4, curriculum_learning=CURRICULUM), cfg)
    seen = {}
    for name, engine in (("kernel", kern), ("plain", plain)):
        apply, seen[name] = engine.model.apply, []

        def rec(params, b, _apply=apply, _seen=seen[name], **kw):
            _seen.append(int(b["input_ids"].shape[-1]))
            return _apply(params, b, **kw)

        engine.model = dataclasses.replace(engine.model, apply=rec)
    rows = _lockstep(torch, kern, plain, batches)
    del kern, plain
    torch.cuda.empty_cache()
    per_step = [r[4] for r in rows]
    log(f"phase17c curriculum fp32 B4xT512 {n} steps: T per step={seen['kernel']} "
        f"{_rows_text(rows)} launches per step={per_step} card={card}")
    check(seen["kernel"] == seen["plain"] == [256, 384, 512, 512, 512],
          f"17c: T per step {seen}")
    _close("17c", rows)
    expected = path_launches(per_step[0], L, _flash_path("float32"))
    check(all(p == expected for p in per_step), f"17c: launches {per_step}, each {expected}")


def _record_T(fa, calls):
    """Wrap B1's and B2's launchers so that each call records (kernel, T);
    returns the originals, to put back."""
    orig = {n: getattr(fa, n) for n in ("flash_attention_fwd", "flash_attention_bwd_delta",
                                        "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}

    def wrap(name, fn):
        def call(t, *a, **kw):
            calls.append((name, int(t.shape[1])))
            return fn(t, *a, **kw)
        return call

    for name, fn in orig.items():
        setattr(fa, name, wrap(name, fn))
    return orig


def _phase17_random_ltd(torch, ctx, cfg, card):
    """(d) random-LTD in layers 1-10, keep 128 -> 512 in steps of 128 over 4
    steps, bf16 B8xT512, 6 steps; one micro-step traced; one forward's
    dropped positions held through each LTD layer."""
    from deepspeed_tpu_torch.models import gpt

    n = PHASE17_STEPS["ltd"]
    batch = ctx["train5b_batch"]
    kern, plain = _pair(_train_config(8, data_efficiency=RANDOM_LTD, **BF16_ZERO2), cfg)
    calls, orig = [], {}

    def before_step(s, engine, fa):
        for name, fn in orig.items():  # the trace covers step 3 only
            setattr(fa, name, fn)
        orig.clear()
        if s == 2:
            orig.update(_record_T(fa, calls))

    try:
        rows = _lockstep(torch, kern, plain, [batch] * n, before_step)
    finally:
        from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

        for name, fn in orig.items():
            setattr(fa, name, fn)
    keeps = [kern.model.gpt_config.random_ltd_keep, plain.model.gpt_config.random_ltd_keep]
    # one forward at keep 128, its scatters held: dropped positions pass bitwise
    passes, scatter = [], gpt.random_ltd_scatter
    model = kern.model.with_ltd_keep(128, tuple(range(1, 11)))

    def rec(out, idx, x_full):
        y = scatter(out, idx, x_full)
        dropped = torch.ones(x_full.shape[:2], dtype=torch.bool, device=x_full.device)
        dropped.scatter_(1, idx, False)
        passes.append(bool(torch.equal(y[dropped], x_full[dropped])))
        return y

    gpt.random_ltd_scatter = rec
    try:
        with torch.no_grad():
            model.apply(kern.state["params"], kern._place_batch(batch), rngs={"dropout": 5},
                        train=True)
    finally:
        gpt.random_ltd_scatter = scatter
    sched = kern._random_ltd
    del kern, plain
    torch.cuda.empty_cache()
    by_kernel = {}
    for name, T in calls:
        by_kernel.setdefault(name, []).append(T)
    keep_per_step = [sched.get_value(s) for s in range(n)]
    log(f"phase17d random-LTD bf16 B8xT512 layers {sched.layer_ids} {n} steps: keep per step="
        f"{keep_per_step} (last: kernel {keeps[0]}, plain {keeps[1]}) {_rows_text(rows)}; "
        f"launches per step={[r[4] for r in rows]}; step 3 traced, T per launch={by_kernel}; "
        f"dropped positions bitwise through the 10 LTD layers={passes} card={card}")
    check(sched.layer_ids == list(range(1, 11)), f"17d: LTD layers {sched.layer_ids}")
    check(keep_per_step == [128, 128, 256, 384, 512, 512] and keeps == [512, 512],
          f"17d: keep per step {keep_per_step}, last {keeps}")
    _close("17d", rows)
    want = sorted([256] * 10 + [512] * 2)
    check(set(by_kernel) == {"flash_attention_fwd", "flash_attention_bwd_delta",
                             "flash_attention_bwd_dq", "flash_attention_bwd_dkv"}
          and all(sorted(v) == want for v in by_kernel.values()),
          f"17d: T per launch {by_kernel}, each kernel {want}")
    expected = path_launches(rows[0][4], cfg.n_layer, _flash_path("bfloat16"))
    check(all(r[4] == expected for r in rows), f"17d: launches {[r[4] for r in rows]}")
    check(len(passes) == 10 and all(passes), f"17d: pass-through {passes}")


def _phase17_pld(torch, ctx, cfg, card):
    """(e) progressive layer drop, theta 0.5, gamma 0.5, bf16 B8xT512, 6
    steps: B1 and each B2 kernel once per kept layer, the count the host
    draw gives."""
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.runtime.progressive_layer_drop import pld_theta

    L, n = cfg.n_layer, PHASE17_STEPS["pld"]
    batch = ctx["train5b_batch"]
    kern, plain = _pair(_train_config(8, progressive_layer_drop=PLD, **BF16_ZERO2), cfg)
    kept = []

    def before_step(s, engine, fa):
        theta = pld_theta(PLD["theta"], PLD["gamma"], engine.global_steps)
        draw = gpt.pld_kept_layers(L, theta, engine._micro_seed())
        kept.append([i for i, k in enumerate(draw) if k])

    rows = _lockstep(torch, kern, plain, [batch] * n, before_step)
    del kern, plain
    torch.cuda.empty_cache()
    per_step = [r[4] for r in rows]
    log(f"phase17e PLD theta 0.5 gamma 0.5 bf16 B8xT512 {n} steps: kept layers per step="
        f"{kept} {_rows_text(rows)} launches per step={per_step} card={card}")
    check(any(len(k) < L for k in kept), f"17e: no layer dropped in {n} steps: {kept}")
    _close("17e", rows)
    for k, p in zip(kept, per_step):
        expected = path_launches(p, len(k), _flash_path("bfloat16"))
        check(p == expected, f"17e: launches {p}, expected {expected} for kept {k}")


def _phase17_flops(torch, ctx, cfg, card):
    """(f) the flops profiler at profile_step 2 on 5b's configuration: the
    kernel path's total against the plain path's (the count depends on the
    shapes only), the step ms and the achieved TFLOPS."""
    batch = ctx["train5b_batch"]
    conf = _train_config(8, flops_profiler={"enabled": True, "profile_step": 2},
                         **BF16_ZERO2)
    out = {}
    for use_flash in (None, False):
        engine = _engine(conf, dataclasses.replace(cfg, use_flash=use_flash))
        fa, _ = _reset_counts()  # the profiled step's main path
        for _ in range(2):
            engine.train_batch(batch)
        torch.cuda.synchronize()
        p = engine._flops_profiler.profile
        out[use_flash] = (p["flops"], p["aten_flops"], p["kernel_flops"], p["latency_s"],
                          p.get("modules", {}).get("totals"), _flash_launches(fa))
        del engine
        torch.cuda.empty_cache()
    (flops, aten, kern, lat, mods, launches), plain = out[None], out[False]
    rel = abs(flops - plain[0]) / plain[0]
    log(f"phase17f flops profiler bf16 zero2 B8xT512 at profile_step 2: kernel path "
        f"total={flops:.6e} (aten {aten:.6e}, kernels {kern}) plain path total={plain[0]:.6e} "
        f"rel_diff={rel:.3e}; profiled fwd+bwd ms (CUDA events, mean of 3)={lat * 1e3:.3f} "
        f"plain={plain[3] * 1e3:.3f}; achieved TFLOPS={flops / lat / 1e12:.2f} plain="
        f"{plain[0] / plain[3] / 1e12:.2f}; module tree totals={mods}; launches over the two "
        f"steps and the profile={launches} card={card}")
    check(rel <= 1e-3, f"17f: kernel-path flops {flops} vs plain {plain[0]}")
    check(set(kern) == {"flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv"} and not plain[2],
          f"17f: kernel flops {kern}, plain {plain[2]}")
    check(not any(plain[5].values()), f"17f: the plain path launched {plain[5]}")


# --------------------------------------------------------------------------- phase 18
ONEBIT_VARIANTS = (("OneBitAdam", "Adam"), ("OneBitLamb", "Lamb"), ("ZeroOneAdam", "Adam"))
ONEBIT_STEPS = 5
ONEBIT_FREEZE = 2
ONEBIT_SAVE_AT = 4  # the tag written after step 4 resumes to step 5
ONEBIT_MIN_RATIO = 31.0  # fp32 reduce-scatter + all-gather bytes over the signs and scales
# 18b: bits 8 -> 4 from step 1 (period 1: 8, 7, 6, 6, 5, 5, 5, 5, 4), L1
# pruning to half density from step 3, every matmul weight
MOQ18 = {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 1},
    "different_groups": {"g": {"params": {"start_bits": 8, "target_bits": 4,
                                          "quantization_period": 1}}}},
    "sparse_pruning": {"shared_parameters": {"enabled": True, "schedule_offset": 3},
                       "different_groups": {"s": {"params": {"dense_ratio": 0.5}}}}}
MOQ18_STEPS = 10
# 18c: the probe, and the MoQ onset it stretches (offset 2: onsets 2-10 by layer)
EV18 = {"enabled": True, "max_iter": 6, "tol": 1e-2}
EV18_MOQ = {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 2},
    "different_groups": {"g": {"params": {"start_bits": 8}}}}}
FD_EPS = 1e-4  # the central difference's step along v (fp64)
FD_RTOL = 1e-3  # its truncation is O(eps^2); the probe's fp32 theta rounds at 1e-7


def _onebit_config(opt, onebit=True):
    params = {"lr": 6e-4, "weight_decay": 0.01}
    if onebit:
        params.update(freeze_step=ONEBIT_FREEZE, var_freeze_step=ONEBIT_FREEZE + 1)
    return _train_config(4 // DP_WORLD, bf16={"enabled": True},
                         optimizer={"type": opt, "params": params})


def _bits_checksum(torch, t):
    """The int64 sum of a float tensor's bits: equal where the tensors are
    bitwise equal."""
    return int(t.detach().float().contiguous().view(torch.int32).long().sum())


def _onebit_rank_main(rank, world, store, out_dir):
    """One of 18a's two rank processes on the one card (gloo): each 1-bit
    variant's dense counterpart for the warmup steps, then the variant for
    ONEBIT_STEPS steps (losses, grad norms, params checksums, step ms, the
    wire ledger per step, launches, the residual rows' checksums); 1-bit
    Adam saves a tag after step ONEBIT_SAVE_AT, which a fresh engine loads
    and resumes to the last step. Writes ``rank<r>_onebit.json``."""
    import os

    import torch

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False  # phase 1's setting, in this process too
    torch.backends.cudnn.allow_tf32 = False
    comm.init_distributed(init_method=f"file://{store}", world_size=world, rank=rank,
                          backend="gloo", device="cuda")
    cfg = gpt.PRESETS["gpt2-125m"]
    rng = np.random.default_rng(18)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (4, 512)).astype(np.int32)}
               for _ in range(ONEBIT_STEPS)]

    def resid(engine):
        ob = engine.state["onebit"]
        return {k: [_bits_checksum(torch, v), bool(torch.isfinite(v).all()), bool(v.any())]
                for k, v in ob.items()}

    out = {"backend": torch.distributed.get_backend(), "world": comm.get_world_size()}
    dense_sums = {}  # the dense runs' checksums, one run per dense optimizer
    for opt, dense in ONEBIT_VARIANTS:
        rec = {"losses": [], "norms": [], "sums": [], "step_ms": [], "wire": []}
        if dense not in dense_sums:
            engine = _engine(_onebit_config(dense, onebit=False), cfg)
            dense_sums[dense] = []
            for b in batches[:ONEBIT_FREEZE]:
                engine.train_batch(b)
                dense_sums[dense].append(_param_checksum(torch, engine))
            del engine
            torch.cuda.empty_cache()
        rec["dense_sums"] = dense_sums[dense]
        engine = _engine(_onebit_config(opt), cfg)
        rec["fp32_allreduce_bytes"] = 4 * sum(p.numel() for p in
                                              tree_leaves(engine.state["params"]))
        wire_ledger.reset()
        fa, _ = _reset_counts()  # this rank's 1-bit training path
        for s, b in enumerate(batches):
            if opt == "OneBitAdam" and s == ONEBIT_SAVE_AT:
                engine.save_checkpoint(os.path.join(out_dir, "tag18"))
                rec["saved_resid"] = resid(engine)
            before = wire_ledger.summary_dict().get("compressed_allreduce[dp]", {})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = engine.train_batch(b)
            rec["losses"].append(m["loss"].item())
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["norms"].append(m["grad_norm"].item())
            rec["sums"].append(_param_checksum(torch, engine))
            after = wire_ledger.summary_dict().get("compressed_allreduce[dp]", {})
            rec["wire"].append([after.get(k, 0) - before.get(k, 0)
                                for k in ("logical_bytes", "wire_bytes")])
        rec["launches"] = _flash_launches(fa)
        rec["resid"] = resid(engine)
        if opt == "OneBitAdam":
            again = _engine(_onebit_config(opt), cfg, seed=1)
            again.load_checkpoint(os.path.join(out_dir, "tag18"))
            rec["loaded_resid"] = resid(again)
            m = again.train_batch(batches[ONEBIT_SAVE_AT])
            rec["resumed"] = {"loss": m["loss"].item(), "norm": m["grad_norm"].item(),
                              "sums": _param_checksum(torch, again), "resid": resid(again)}
            del again
        out[opt] = rec
        del engine
        torch.cuda.empty_cache()
    comm.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}_onebit.json"), "w") as f:
        json.dump(out, f)


def phase_a3c(torch, ctx):
    """Phase 18: the 1-bit optimizers, ``compression_training`` and the
    eigenvalue probe on GPT-2-125M at full width and depth, from seed 0,
    through ``initialize``: (a) 1-bit Adam, 1-bit LAMB and 0/1 Adam at dp2
    (two rank processes on the card over gloo), bf16, freeze_step 2, 5
    steps; (b) MoQ bits 8 -> 4 and L1 pruning, the kernel path in lockstep
    with the plain-attention path; (c) the probe on the kernels (disabled)
    and on the plain path at full depth, and one layer's fp64 HVP against a
    central difference."""
    import os
    import shutil
    import tempfile

    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    card = _smi_line()
    root = tempfile.mkdtemp(prefix="a3c18_")
    try:
        _phase18_onebit(torch, cfg, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _phase18_compression(torch, ctx, cfg, card)
    _phase18_eigenvalue(torch, ctx, cfg, card)
    # the bf16 paths of 18b and 18c (this process) in the kernels line
    launches = ctx["a3c_launches"]
    ctx["flash_tc"]["launches"] += launches["fwd_tc"]
    for n in BWD_PATH["bfloat16"]:
        ctx[f"bwd_{n}"]["launches"] += launches[n]


def _phase18_onebit(torch, cfg, card, root):
    import os

    import torch.multiprocessing as mp

    store = os.path.join(root, "store")
    procs = mp.start_processes(_onebit_rank_main, args=(DP_WORLD, store, root),
                               nprocs=DP_WORLD, join=False, start_method="spawn")
    end = time.monotonic() + DP_JOIN_S
    while not procs.join(timeout=max(0.1, end - time.monotonic())):
        if time.monotonic() >= end:
            for proc in procs.processes:
                proc.kill()
            raise Failed(f"18a: the {DP_WORLD} rank processes did not finish within "
                         f"{DP_JOIN_S} s")
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(root, f"rank{r}_onebit.json")) as f:
            ranks.append(json.load(f))
    L = cfg.n_layer
    for opt, dense in ONEBIT_VARIANTS:
        recs = [rank[opt] for rank in ranks]
        rec = recs[0]
        wire = rec["wire"][ONEBIT_FREEZE]
        log(f"phase18a {opt} dp2 bf16 gpt2-125m B4xT512 (2 rows a rank) freeze_step "
            f"{ONEBIT_FREEZE}: losses={rec['losses']} grad_norms={rec['norms']} warmup bitwise "
            f"{dense}={[x['sums'][:ONEBIT_FREEZE] == x['dense_sums'] for x in recs]} ranks' "
            f"params equal after every step={recs[0]['sums'] == recs[1]['sums']} step_ms "
            f"(host clock)={[[round(x, 1) for x in y['step_ms']] for y in recs]} compressed "
            f"wire bytes a step={wire[1]} (logical {wire[0]}: the fp32 reduce-scatter + "
            f"all-gather; one fp32 all-reduce of the gradients {rec['fp32_allreduce_bytes']}) "
            f"ratio={wire[0] / max(1, wire[1]):.2f} launches={[x['launches'] for x in recs]} "
            f"residuals={[x['resid'] for x in recs]} card={card}")
        for r, x in enumerate(recs):
            check(x["sums"][:ONEBIT_FREEZE] == x["dense_sums"],
                  f"18a {opt} rank {r}: the warmup is not bitwise dense {dense}")
            check(all(math.isfinite(v) for v in x["losses"] + x["norms"]),
                  f"18a {opt} rank {r}: losses {x['losses']}")
            expected = path_launches(x["launches"], ONEBIT_STEPS * L, _flash_path("bfloat16"))
            check(x["launches"] == expected,
                  f"18a {opt} rank {r}: launches {x['launches']}, expected {expected}")
            check(all(w == [0, 0] for w in x["wire"][:ONEBIT_FREEZE]) and all(
                w[1] > 0 and w[0] / w[1] >= ONEBIT_MIN_RATIO for w in x["wire"][ONEBIT_FREEZE:]),
                f"18a {opt} rank {r}: wire per step {x['wire']}")
            check(all(f and nz for _, f, nz in x["resid"].values()),
                  f"18a {opt} rank {r}: residuals {x['resid']}")
        check(recs[0]["sums"] == recs[1]["sums"], f"18a {opt}: the ranks' params differ")
        check(recs[0]["losses"] == recs[1]["losses"], f"18a {opt}: the ranks' losses differ")
        if opt == "OneBitAdam":
            for r, x in enumerate(recs):
                got = x["resumed"]
                log(f"phase18a {opt} rank {r}: the tag after step {ONEBIT_SAVE_AT} resumed to "
                    f"step {ONEBIT_STEPS}: loss={got['loss']} (uninterrupted "
                    f"{x['losses'][-1]}) params bitwise={got['sums'] == x['sums'][-1]} "
                    f"residuals loaded bitwise={x['loaded_resid'] == x['saved_resid']} and "
                    f"after the step={got['resid'] == x['resid']}")
                check(got["loss"] == x["losses"][-1] and got["norm"] == x["norms"][-1]
                      and got["sums"] == x["sums"][-1],
                      f"18a rank {r}: the resumed step 5 is not the uninterrupted one")
                check(x["loaded_resid"] == x["saved_resid"] and got["resid"] == x["resid"],
                      f"18a rank {r}: residuals {x['loaded_resid']} / {got['resid']}")


def _moq_bits(step):
    """The host schedule of MOQ18: None before the onset, then 8 bits less
    one at t = 1, 2, 4, 8 (t = step - 1), never below 4."""
    t = step - 1
    return None if t < 0 else float(max(4, 8 - (t.bit_length() if t >= 1 else 0)))


def _phase18_compression(torch, ctx, cfg, card):
    """(b) 5b's configuration and batch with MOQ18, MOQ18_STEPS steps in
    lockstep with the plain path: the bits each step against the host
    schedule, launches, each pruned weight's density; step ms with and
    without compression."""
    from deepspeed_tpu_torch.compression import compress

    L, n = cfg.n_layer, MOQ18_STEPS
    batch = ctx["train5b_batch"]
    conf = _train_config(8, compression_training=MOQ18, **BF16_ZERO2)
    kern, plain = _pair(conf, cfg)
    seen, step = {}, [0]
    real = compress.fake_quant_dynamic

    def spy(x, bits, groups=1):
        seen.setdefault(step[0], set()).add(float(bits))
        return real(x, bits, groups)

    compress.fake_quant_dynamic = spy
    try:
        rows = _lockstep(torch, kern, plain, [batch] * n,
                         before_step=lambda s, engine, fa: step.__setitem__(0, s))
    finally:
        compress.fake_quant_dynamic = real
    want = {s: _moq_bits(s) for s in range(n)}
    got = {s: (sorted(seen[s]) if s in seen else None) for s in range(n)}
    plan = kern._compression.plan
    ratio = MOQ18["sparse_pruning"]["different_groups"]["s"]["params"]["dense_ratio"]
    densities, ties_only = {}, {}
    with torch.no_grad():
        for key in plan:
            leaf = kern.state["params"]
            for part in key.split("/"):
                leaf = leaf[part]
            mag, kept = leaf.abs(), compress._prune_l1(leaf, ratio) != 0
            k = max(1, round(leaf.numel() * ratio))
            floor = mag[kept].min()
            densities[key] = float(kept.float().mean())
            # the configured density: every entry at or above the k-th
            # largest magnitude kept and no other, so past k only ties at the
            # threshold (bf16 values tie often), as in the reference
            ties_only[key] = (int((mag > floor).sum()) < k <= int(kept.sum())
                              and bool(kept[mag >= floor].all()))
    launches = {k: sum(r[4][k] for r in rows) for k in rows[0][4]}
    del plain
    torch.cuda.empty_cache()
    _, _, ms_moq, _ = _timed_steps(torch, kern, batch, 4)
    del kern
    torch.cuda.empty_cache()
    dense = _engine(_train_config(8, **BF16_ZERO2), cfg)
    _, _, ms_dense, _ = _timed_steps(torch, dense, batch, 4)
    del dense
    torch.cuda.empty_cache()
    log(f"phase18b compression bf16 zero2 gpt2-125m B8xT512 {n} steps (bits 8 -> 4 from step "
        f"1, period 1; L1 pruning to 0.5 from step 3; {len(plan)} weights): {_rows_text(rows)}; "
        f"bits per step={[got[s] for s in range(n)]} host schedule={[want[s] for s in range(n)]}"
        f" densities={densities} (past 0.5 only ties at the threshold: {ties_only}) "
        f"launches over {n} steps={launches} step_ms (CUDA events, "
        f"median of steps 2-4) with compression={float(np.median(ms_moq[1:])):.3f} without="
        f"{float(np.median(ms_dense[1:])):.3f} card={card}")
    _close("18b", rows)
    for s in range(n):
        check(got[s] == (None if want[s] is None else [want[s]]),
              f"18b step {s + 1}: bits {got[s]}, host schedule {want[s]}")
    check(all(ties_only.values()), f"18b densities {densities}: {ties_only}")
    expected = path_launches(launches, n * L, _flash_path("bfloat16"))
    check(launches == expected, f"18b launches {launches}, expected {expected}")
    ctx["a3c_launches"] = launches


def _phase18_eigenvalue(torch, ctx, cfg, card):
    """(c) the probe: on the kernels it disables itself with the log and
    training goes on; on the plain path at full depth it gives a curvature
    in [0, 1] with a maximum of 1 that stretches the MoQ onset per layer;
    one layer's HVP at full width and depth 2 in fp64 against a central
    difference of two gradients."""
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue
    from deepspeed_tpu_torch.utils.logging import logger
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    L, V = cfg.n_layer, cfg.vocab_size
    rng = np.random.default_rng(181)
    batch = {"input_ids": rng.integers(0, V, (2, 512)).astype(np.int32)}
    # on the kernels, bf16: the probe's first create_graph backward reaches
    # FlashAttention's refusal after one forward (12 B1 launches)
    engine = _engine(_train_config(2, eigenvalue=EV18, **BF16_ZERO2), cfg)
    handler, lines = _log_capture()
    fa, _ = _reset_counts()  # the probed bf16 training path on the kernels
    try:
        losses = [engine.train_batch(batch)["loss"].item() for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
    launches = _flash_launches(fa)
    disabled = [x for x in lines if "disabling probe" in x]
    log(f"phase18c probe on the kernels bf16 B2xT512 2 steps: losses={losses} probe disabled="
        f"{engine._eigenvalue is None} log lines={disabled} launches={launches}")
    check(engine._eigenvalue is None and len(disabled) == 1
          and "FlashAttention is not twice differentiable" in disabled[0],
          f"18c: the probe on the kernels: {disabled}")
    check(all(math.isfinite(x) for x in losses), f"18c losses {losses}")
    expected = path_launches(launches, 2 * L, _flash_path("bfloat16"))
    expected["fwd_tc"] += L  # the probe's one forward before the refusal
    check(launches == expected, f"18c launches {launches}, expected {expected}")
    ctx["a3c_launches"] = {k: v + launches[k] for k, v in ctx["a3c_launches"].items()}
    del engine
    torch.cuda.empty_cache()

    # the plain path at full depth, fp32, with MoQ on the probed curvature
    engine = _engine(_train_config(2, eigenvalue=EV18, compression_training=EV18_MOQ),
                     dataclasses.replace(cfg, use_flash=False))
    probe, times = engine._eigenvalue, []
    compute = probe.compute

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = compute(*a, **kw)
        times.append(time.perf_counter() - t0)
        return out

    probe.compute = timed
    fa, _ = _reset_counts()  # the plain path launches nothing
    m = engine.train_batch(batch)
    curv = engine.state["curvature"].cpu().numpy()
    offset = EV18_MOQ["weight_quantization"]["shared_parameters"]["schedule_offset"]
    onsets = [int(offset * (1 + math.floor(4 * float(c)))) for c in curv]
    mid = (min(onsets) + max(onsets)) // 2
    with torch.no_grad():
        params = engine.state["params"]
        moq = engine._compression.transform(params, mid, curvature=curv)
        quantized = [not torch.equal(moq["blocks"]["mlp_up_w"][i], params["blocks"]["mlp_up_w"][i])
                     for i in range(L)]
    log(f"phase18c probe on the plain path fp32 B2xT512 {L} layers (max_iter "
        f"{EV18['max_iter']}, tol {EV18['tol']}): loss={m['loss'].item()} curvature="
        f"{[round(float(c), 4) for c in curv]} MoQ onsets by layer={onsets} quantized at step "
        f"{mid}={quantized} probe s={times[0]:.3f} ({times[0] / L * 1e3:.1f} ms a layer) "
        f"launches={_flash_launches(fa)} card={card}")
    check(len(times) == 1 and engine._eigenvalue is not None, "18c: the plain probe did not run")
    check(bool(np.isfinite(curv).all()) and curv.min() >= 0 and curv.max() == 1.0,
          f"18c curvature {curv}")
    check(max(onsets) > min(onsets), f"18c: the onsets {onsets} do not stretch")
    check(quantized == [o <= mid for o in onsets], f"18c: quantized {quantized} at {mid}")
    check(not any(_flash_launches(fa).values()), "18c: the plain path launched kernels")
    del engine, params, moq
    torch.cuda.empty_cache()

    # one layer's HVP in fp64 at full width and depth 2 against a central difference
    small = dataclasses.replace(cfg, n_layer=2, use_flash=False)
    model, _ = gpt.build(small)
    params = tree_map(lambda t: t.double(), model.init(0, device="cuda"))
    b = {"input_ids": torch.from_numpy(rng.integers(0, V, (1, 128)).astype(np.int64)).cuda()}
    loss = lambda q, bb: model.apply(q, bb, train=False)[0]  # noqa: E731
    blocks = tree_leaves(params["blocks"])
    gen = torch.Generator(device="cuda").manual_seed(18)
    v = [torch.randn(a[1].shape, generator=gen, device="cuda") for a in blocks]
    hv = Eigenvalue().hvp(loss, params, b, 1, v)

    def grad_at(eps):
        theta = [(a[1] + eps * w.double()).requires_grad_(True) for a, w in zip(blocks, v)]
        stacked = [torch.cat([a[:1], t[None], a[2:]]) for a, t in zip(blocks, theta)]
        q = {**params, "blocks": tree_unflatten(params["blocks"], stacked)}
        return torch.autograd.grad(loss(q, b), theta)

    fd = [(p - m_) / (2 * FD_EPS) for p, m_ in zip(grad_at(FD_EPS), grad_at(-FD_EPS))]
    num = math.sqrt(sum(float(((h.double() - f) ** 2).sum()) for h, f in zip(hv, fd)))
    den = math.sqrt(sum(float((f ** 2).sum()) for f in fd))
    log(f"phase18c fp64 HVP of layer 1, gpt2-125m width at depth 2, B1xT128, against the "
        f"central difference at eps {FD_EPS}: relative error={num / den:.3e} |Hv|={den:.4e}")
    check(num <= FD_RTOL * den, f"18c: the HVP is {num / den:.3e} from the central difference")


# --------------------------------------------------------------------------- phase 19
# 19a: 5b's cell armed (save_dir, the sentinel with an anchor every 2 steps,
# the watchdog, integrity scanning every step and a spot check every 2), the
# chaos plan a NaN at data cursor 5, then a flip in the master domain at 8
RES_CHAOS = {"nan_at_step": 5, "flip_bit_at": 8, "flip_bit_domain": "master"}
RES_STEPS = 7  # the armed run's last step
RES_BATCHES = 10  # the data cursors the armed run can reach
# the recovery-event trail the plan must leave, in order: (event, step, cursor
# or skipped cursors). The NaN batch (cursor 5) is step 6: the rollback lands
# on global_step4 and skips every batch consumed since it (cursors 4 and 5,
# the reference's window); the flip is found before cursor 8's step and rolls
# back to global_step6, replaying (not skipping) from cursor 8
RES_TRAIL = ([("integrity_scan", s, None) for s in (1, 2, 3, 4, 5)]
             + [("divergence_rollback", 4, [4, 5]), ("integrity_scan", 4, None),
                ("poison_skip", 4, 4), ("poison_skip", 4, 5), ("integrity_scan", 5, None),
                ("integrity_scan", 6, None), ("sdc_detected", 0, None),
                ("divergence_rollback", 6, []), ("sdc_rollback", 6, None),
                ("integrity_scan", 7, None)])
# 19b / 19c: fp32 B4 x T512 children of this script
RES_CHILD_STEPS = 6
RES_JOIN_S = 300.0  # a child or the agent not done by then has hung: the phase fails
ELASTIC19 = {"enabled": True, "max_train_batch_size": 4, "micro_batch_sizes": [2],
             "min_world_size": 1, "max_world_size": 2}
ELASTIC19_STEPS = 4
ELASTIC19_LOSE_AT = 2  # the data cursor at which rank 1 is lost
# 19d: the serving watchdog's deadline and the injected stall
RES_SERVE_DEADLINE_S = 0.5
RES_SERVE_STALL_S = 1.5


def _state_prints(engine):
    """Per leaf, the crc32 of the params' and the optimizer state's bytes
    (and the master copy's): equal dicts are bitwise-equal states."""
    from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths
    from deepspeed_tpu_torch.resilience import fingerprint_array

    st = engine.state
    tree = {"params": st["params"], "master": st["master"] or {},
            "mu": st["opt"].mu, "nu": st["opt"].nu}
    return {k: fingerprint_array(v, "crc32") for k, v in flatten_with_paths(tree)}


def _res_child_conf(save_dir, **res):
    return _train_config(4, resilience={"enabled": True, "save_dir": save_dir, **res})


def _res_child_batches(V):
    rng = np.random.default_rng(191)
    return [{"input_ids": rng.integers(0, V, (4, 512)).astype(np.int32)}
            for _ in range(RES_CHILD_STEPS)]


def _res_child(mode, save_dir):
    """19b's child (``--phase19-child MODE DIR``): fp32 B4 x T512 under
    ``resilience`` in DIR. ``term``: prints a ready line after step 3 and
    waits for the drain a SIGTERM requests; the next step drains (an
    emergency tag, exit 83). ``kill``: saves after steps 2 and 4, the plan in
    ``DS_FAULT_PLAN`` SIGKILLs the second save. ``resume``: auto-resumes and
    trains to the last step, then writes the state's prints."""
    import os

    import torch

    from deepspeed_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False  # phase 1's setting, in this process too
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.PRESETS["gpt2-125m"]
    batches = _res_child_batches(cfg.vocab_size)
    engine = _engine(_res_child_conf(save_dir, install_signal_handlers=(mode == "term")), cfg)
    start = engine.global_steps
    while engine.global_steps < RES_CHILD_STEPS:
        engine.train_batch(batches[engine.global_steps])
        if mode == "kill" and engine.global_steps in (2, 4):
            engine.save_checkpoint(save_dir)
        if mode == "term" and engine.global_steps == 3:
            print("PHASE19 READY", flush=True)
            end = time.monotonic() + 60
            while not engine._preemption_guard.drain_requested and time.monotonic() < end:
                time.sleep(0.02)
    torch.cuda.synchronize()
    with open(os.path.join(save_dir, "final.json"), "w") as f:
        json.dump({"start": start, "steps": engine.global_steps,
                   "preemptions_survived": engine._preemptions_survived,
                   "prints": _state_prints(engine)}, f)
    return 0


def _elastic19_conf(save_dir=None):
    """19c's config: the elastic ladder sets the batch; with ``save_dir``,
    ``resilience`` with an anchor every 2 steps."""
    conf = {"optimizer": {"type": "AdamW", "params": {"lr": 6e-4}}, "gradient_clipping": 1.0,
            "steps_per_print": 0, "elasticity": dict(ELASTIC19)}
    if save_dir:
        conf["resilience"] = {"enabled": True, "save_dir": save_dir,
                              "install_signal_handlers": False,
                              "sentinel": {"enabled": True, "warmup_steps": 1,
                                           "checkpoint_interval": 2}}
    return conf


def _elastic19_train(engine, batches, log_path=None):
    """The cursor-driven loop at the engine's decomposition: the cursor's
    global batch as [gas, micro x world, T]. Returns {step: (loss, grad norm)}."""
    out = {}
    gas = engine.gradient_accumulation_steps()
    while engine.global_steps < ELASTIC19_STEPS:
        ids = batches[engine.data_cursor]["input_ids"]
        m = engine.train_batch({"input_ids": ids.reshape(gas, -1, ids.shape[-1])
                                if gas > 1 else ids})
        out[engine.global_steps] = (m["loss"].item(), m["grad_norm"].item())
        if log_path:
            with open(log_path, "a") as f:
                f.write(json.dumps({"step": engine.global_steps, "world": engine.world_size,
                                    "gas": gas, "loss": out[engine.global_steps][0],
                                    "grad_norm": out[engine.global_steps][1]}) + "\n")
    return out


def _elastic19_worker(save_dir, world, world_file, plan=None, rank=0, store=None):
    """19c's worker (``--phase19-elastic DIR WORLD WORLD_FILE [PLAN]``):
    ``world`` gloo ranks sharing the card (this process is rank 0 and starts
    the others; PLAN, a fault plan's JSON, arms rank 1 only). A rank killed
    by a signal is a lost device: rank 0 writes ``world - 1`` to WORLD_FILE,
    the count the agent probes, and exits 1. Rank 0 leads a process group of
    its own, recorded in DIR/groups ("start" on entry, "end" once its peers
    are gone), so the phase can stop exactly the ranks it started."""
    import os
    import subprocess

    groups = os.path.join(save_dir, "groups")
    if rank == 0:
        os.setpgid(0, 0)  # the peers started below join this group
        with open(groups, "a") as f:
            f.write(f"start {os.getpid()}\n")
    import torch

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.resilience import FAULT_PLAN_ENV

    store = store or os.path.join(save_dir, f"store_w{world}_{os.getpid()}")
    peers = []
    for r in range(1, world if rank == 0 else 1):
        env = dict(os.environ, **({FAULT_PLAN_ENV: plan} if plan else {}))
        peers.append(subprocess.Popen([sys.executable, __file__, "--phase19-elastic-rank",
                                       save_dir, str(world), world_file, str(r), store],
                                      env=env))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if world > 1:
        comm.init_distributed(init_method=f"file://{store}", world_size=world, rank=rank,
                              backend="gloo", device="cuda", timeout_s=120)
    cfg = gpt.PRESETS["gpt2-125m"]
    rc = 0
    try:
        engine = _engine(_elastic19_conf(save_dir), cfg)
        _elastic19_train(engine, _res_child_batches(cfg.vocab_size),
                         os.path.join(save_dir, "log.jsonl") if rank == 0 else None)
    except Exception as e:  # a lost peer breaks the collectives
        print(f"phase19c rank {rank}: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        rc = 1
    for peer in peers:
        try:
            code = peer.wait(timeout=120)
        except subprocess.TimeoutExpired:
            peer.kill()
            code = peer.wait()
        if code < 0:
            with open(world_file, "w") as f:
                f.write(str(world - 1))
        rc = rc or int(code != 0)
    if rank == 0:
        with open(groups, "a") as f:
            f.write(f"end {os.getpid()}\n")
    return rc


def _res_children_main(argv):
    """The child modes of phase 19, or None for the smoke run itself."""
    if len(argv) > 1 and argv[1] == "--phase19-child":
        return _res_child(argv[2], argv[3])
    if len(argv) > 1 and argv[1] == "--phase19-elastic":
        return _elastic19_worker(argv[2], int(argv[3]), argv[4], *argv[5:6])
    if len(argv) > 1 and argv[1] == "--phase19-elastic-rank":
        return _elastic19_worker(argv[2], int(argv[3]), argv[4], rank=int(argv[5]),
                                 store=argv[6])
    return None


def phase_resilience(torch, ctx):
    """Phase 19: resilience and elasticity (A11) on GPT-2-125M at full width
    and depth, from seeds, the tags under a scratch directory removed at the
    end. (a) 5b's cell (bf16 ZeRO-2, B8 x T512) armed: the sentinel with an
    anchor every 2 steps, the watchdog, integrity scanning 4 blocks of 1 MiB
    every step and a spot check every 2; a NaN at data cursor 5 rolls back
    to global_step4 and skips cursors 4-5; a bit flipped in the master
    domain at cursor 8 is found before the step, named, and rolled back to
    global_step6. The steps after the rejoin are bitwise a clean run's from
    global_step4 that skips the same cursors; every spot check is quiet; the
    event trail is exact; B1/B2 launch 12 a forward / backward, spot checks
    included; the in-memory anchor restores bitwise. (b) children of this
    script, fp32 B4 x T512: a SIGTERM after step 3 drains (an emergency tag,
    exit 83) and the relaunch finishes bitwise the uninterrupted run; a
    SIGKILL at the second save's pre-commit leaves a torn tag, rejected, and
    the resume from the older tag is bitwise too. (c) the elastic agent over
    two gloo ranks sharing the card; rank 1 is lost at cursor 2; the agent
    relaunches at world 1 from global_step2 (resharded) and every step's loss
    and grad norm is within 16c's bars of an uninterrupted world-1 run; a
    preempted exit spends no restart budget. (d) 15a's cell with n-gram
    speculation, page fingerprints (a scan of 2 pages a step), the serving
    watchdog and three faults (a bit in a shared KV page, an allocation
    failure in a claim that borrows prefix pages, a stalled dispatch): the
    tokens are the cache-off run's, the flip detected and healed, the claim
    unwound and its request queued, the stall flagged, B4 12 a decode step
    and B5 12 a window; a run without faults detects nothing. (a) runs alone (its
    step times are compared); (d) runs while (b)'s and (c)'s processes start
    and train; (b)'s first children are checked and their resumes started,
    and phase 20 runs while the resumes and (c)'s agent train
    (:func:`phase_resilience_join` checks them after it)."""
    import os
    import shutil
    import tempfile

    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    root = tempfile.mkdtemp(prefix="res19_")
    st = None
    try:
        t0 = time.perf_counter()
        _phase19a(torch, ctx, cfg, os.path.join(root, "a"))
        log(f"phase19a took {time.perf_counter() - t0:.1f} s")
        st = _phase19bc_start(cfg, root)
        _phase19d(torch, ctx, cfg)  # while 19b's and 19c's processes start up
        log(f"phase19d took {time.perf_counter() - st['t0']:.1f} s (beside 19b / 19c)")
        _phase19bc_relaunch(torch, cfg, st)
        ctx["res19"] = {"root": root, "st": st}  # joined by phase_resilience_join
    finally:
        if "res19" not in ctx:  # nothing is left running, whatever failed
            if st is not None:
                _phase19bc_abort(st)
            shutil.rmtree(root, ignore_errors=True)


def phase_resilience_join(torch, ctx):
    """Phase 19's end, after phase 20 (which ran beside 19b's resumes and
    19c's agent): those processes joined and checked, every process 19b /
    19c started stopped, the tags removed. Nothing to do when phase 19 did
    not leave them running."""
    import shutil

    pending = ctx.pop("res19", None)
    if pending is None:
        return
    st = pending["st"]
    try:
        _phase19bc_check(st)
        log(f"phase19b+c+d took {time.perf_counter() - st['t0']:.1f} s (phase 20 beside the "
            "resumes and the agent)")
    finally:
        _phase19bc_abort(st)
        shutil.rmtree(pending["root"], ignore_errors=True)


def _phase19a(torch, ctx, cfg, save_dir):
    from deepspeed_tpu_torch.resilience import install_plan, read_events
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    V = cfg.vocab_size
    rng = np.random.default_rng(19)
    batches = [rng.integers(0, V, (8, 512)).astype(np.int32) for _ in range(RES_BATCHES)]
    cell = dict(bf16={"enabled": True}, zero_optimization={"stage": 2})
    res = {"enabled": True, "save_dir": save_dir, "install_signal_handlers": False,
           # every anchor the trail needs is on disk: no host copy of the
           # 1.74 GB state after each save (the in-memory anchor is checked
           # by hand below)
           "sentinel": {"enabled": True, "warmup_steps": 1, "checkpoint_interval": 2,
                        "memory_fallback": False},
           "watchdog": {"enabled": True},
           "integrity": {"enabled": True, "scan_interval": 1, "blocks_per_scan": 4,
                         "spot_check_interval": 2},
           "chaos": dict(RES_CHAOS)}
    engine = _engine(_train_config(8, **cell, resilience=res), cfg)
    fa, _ = _reset_counts()  # the armed bf16 training path, spot checks included
    rows = []  # (global_steps after the call, cursor of the call, what, wall ms, loss)
    try:
        while engine.global_steps < RES_STEPS:
            cursor = engine.data_cursor
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = engine.train_batch({"input_ids": batches[cursor]})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rb = m.get("health", {}).get("rolled_back")
            what = ("skip" if m.get("skipped_batch") else "sdc" if m.get("sdc") else
                    "rollback" if rb else "step")
            loss = float(m["loss"]) if what == "step" else None
            rows.append((engine.global_steps, cursor, what, ms, loss))
        launches = _flash_launches(fa)
        rep = engine._integrity.report()
        events = read_events(save_dir)
        # the in-memory anchor: a host copy, restored bitwise over a state
        # overwritten on the card
        before = _state_prints(engine)
        engine._health._take_memory_snapshot()
        with torch.no_grad():
            st = engine.state
            for t in tree_leaves({"p": st["params"], "m": st["master"], "o": st["opt"].mu}):
                t.add_(1.0)
        moved = _state_prints(engine) != before
        engine._health._restore_memory_snapshot()
        restored = _state_prints(engine) == before
    finally:
        engine._watchdog.stop()
        install_plan(None)
    trail = [(e["event"], e["step"],
              e.get("cursor", e.get("skip_cursors"))) for e in events]
    sdc = [e for e in events if e["event"] == "sdc_detected"]
    executed = sum(w in ("step", "rollback") for _, _, w, _, _ in rows)
    armed_ms = float(np.median([ms for gs, _, w, ms, _ in rows if w == "step" and gs % 2]))
    calls = [(g, c, w, round(ms, 1), loss) for g, c, w, ms, loss in rows]
    log(f"phase19a armed bf16 zero2 gpt2-125m B8xT512: calls (global_steps, cursor, what, ms, "
        f"loss)={calls} trail={trail} "
        f"sdc={[(e['unit'], e['block']) for e in sdc]} integrity={rep} launches={launches} "
        f"anchor moved by a step={moved} restored bitwise={restored}")
    check(trail == RES_TRAIL, f"19a: the recovery-event trail {trail}, expected {RES_TRAIL}")
    check(len(sdc) == 1 and sdc[0]["domain"] == "master" and "unit" in sdc[0],
          f"19a: the flip was not named: {sdc}")
    sdc_calls = [c for _, c, w, _, _ in rows if w == "sdc"]
    check(sdc_calls == [RES_CHAOS["flip_bit_at"]],
          f"19a: the flip was not caught before cursor 8's step: {calls}")
    check(rep["spot_checks"] >= 4 and rep["spot_mismatches"] == 0 and rep["mismatches"] == 1,
          f"19a: spot checks {rep}")
    want = path_launches(launches, cfg.n_layer * (executed + 2 * rep["spot_checks"]),
                         _flash_path("bfloat16"))
    check(launches == want, f"19a: launches {launches}, expected {want}")
    check(moved and restored, "19a: the in-memory anchor did not restore bitwise")
    # the clean run from global_step4 that skips cursors 4 and 5
    clean = _engine(_train_config(8, **cell), cfg, seed=1)
    clean.load_checkpoint(save_dir, tag="global_step4")
    # the executed steps after the rejoin, by step (the step replayed after
    # the flip's rollback counts once)
    after = {gs: (c, loss) for gs, c, w, _, loss in rows
             if w == "step" and c > RES_CHAOS["nan_at_step"]}
    clean_rows = []
    for gs in sorted(after):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = clean.train_batch({"input_ids": batches[after[gs][0]]})
        loss = float(m["loss"])
        torch.cuda.synchronize()
        clean_rows.append((gs, (time.perf_counter() - t0) * 1e3, loss))
    # the armed engine's state after step 7 (before the anchor check's step)
    # was restored above: it is the clean run's state after the same batches
    same_state = _state_prints(clean) == before
    plain_ms = float(np.median([ms for _, ms, _ in clean_rows]))
    scan_ms = rep["scan_s"] * 1e3 / max(1, executed)
    scan_mb = rep["bytes_fingerprinted"] / max(1, executed) / 2**20
    clean_losses = [loss for _, _, loss in clean_rows]
    armed_losses = [after[g][1] for g in sorted(after)]
    log(f"phase19a clean run from global_step4 skipping cursors 4-5: (step, ms, loss)="
        f"{[(g, round(ms, 1), loss) for g, ms, loss in clean_rows]} armed losses="
        f"{armed_losses} bitwise={clean_losses == armed_losses} final state bitwise={same_state}")
    log(f"phase19a step_ms (host clock, synchronized, steps with no save or spot check): "
        f"armed={armed_ms:.3f} unarmed={plain_ms:.3f} (phase5b CUDA events "
        f"{ctx.get('train5b', {}).get('step_ms', float('nan')):.3f}); integrity scan: "
        f"{scan_mb:.2f} MiB and {scan_ms:.3f} ms a step ({rep['blocks_stamped']} blocks "
        f"stamped, {rep['blocks_verified']} verified, {rep['algo']}); spot check "
        f"{(rep['overhead_s'] - rep['scan_s']) * 1e3 / max(1, rep['spot_checks']):.1f} ms each")
    check(clean_losses == armed_losses,
          f"19a: the rejoined steps are not bitwise the clean run's: {clean_rows} vs {after}")
    check(same_state, "19a: the final state is not bitwise the clean run's")
    del engine, clean
    torch.cuda.empty_cache()


def _reader(proc, lines, on_line=None):
    """A thread that keeps ``proc``'s stdout drained into ``lines``."""
    import threading

    def run():
        for line in proc.stdout:
            lines.append(line)
            if on_line is not None:
                on_line(line)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _phase19bc_start(cfg, root):
    """Start 19b's first two children and 19c's agent (in a thread); the
    SIGTERM goes out as soon as the term child says it is ready."""
    import os
    import signal
    import subprocess
    import threading

    from deepspeed_tpu_torch.elasticity.elastic_agent import DSElasticAgent
    from deepspeed_tpu_torch.resilience import FAULT_PLAN_ENV

    script = os.path.abspath(__file__)
    st = {"script": script, "t0": time.perf_counter(), "ready_s": None, "procs": [],
          "dirs": {k: os.path.join(root, k) for k in ("term", "kill", "elastic", "agent")}}
    for d in st["dirs"].values():
        os.makedirs(d)

    def child(mode, directory, env=None):
        p = subprocess.Popen([sys.executable, script, "--phase19-child", mode, directory],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=dict(os.environ, **(env or {})))
        st["procs"].append(p)
        return p

    st["child"] = child

    def on_term_line(line):
        if "PHASE19 READY" in line and st["ready_s"] is None:
            st["ready_s"] = time.perf_counter() - st["t0"]
            st["term"].send_signal(signal.SIGTERM)

    st["term"] = child("term", st["dirs"]["term"])
    st["term_out"] = []
    st["term_reader"] = _reader(st["term"], st["term_out"], on_term_line)
    st["kill"] = child("kill", st["dirs"]["kill"], {FAULT_PLAN_ENV: json.dumps(
        {"kill_at_phase": "pre-commit", "kill_at_save": 1})})
    st["kill_out"] = []
    st["kill_reader"] = _reader(st["kill"], st["kill_out"])
    # (c): the lost-worker plan rides on the world-2 launch's command line
    # (rank 0 hands it to rank 1 alone); once the phase stops, the agent's
    # launches run nothing
    world_file = os.path.join(st["dirs"]["elastic"], "world")
    with open(world_file, "w") as f:
        f.write("2")
    st["agent_out"] = {}
    st["stopped"] = False
    lose = json.dumps({"lose_worker_at_step": ELASTIC19_LOSE_AT})

    def make_cmd(spec):
        if st["stopped"]:
            return [sys.executable, "-c", "pass"]
        return [sys.executable, script, "--phase19-elastic", st["dirs"]["elastic"],
                str(spec.world_size), world_file] + ([lose] if spec.world_size == 2 else [])

    def run_agent():
        agent = DSElasticAgent(make_cmd, {"elasticity": ELASTIC19},
                               device_count_fn=lambda: int(open(world_file).read()),
                               max_restarts=1, poll_interval=0.5,
                               checkpoint_dir=st["dirs"]["elastic"], backoff_base=0.1)
        try:
            st["agent_out"]["result"] = agent.run()
        except Exception as e:
            st["agent_out"]["error"] = e

    st["agent"] = threading.Thread(target=run_agent, daemon=True)
    st["agent"].start()
    return st


def _phase19bc_abort(st):
    """Stop every process 19b / 19c started, and nothing else: the children
    here by their handles, the agent's workers by the process groups their
    rank 0 recorded under this run's directory (a group is killed until
    the agent, which launches nothing more, has returned)."""
    import os
    import signal

    st["stopped"] = True
    for p in st["procs"]:
        if p.poll() is None:
            p.kill()

    def kill_groups():
        path = os.path.join(st["dirs"]["elastic"], "groups")
        lines = open(path).read().split() if os.path.exists(path) else []
        marks = list(zip(lines[::2], map(int, lines[1::2])))
        for pgid in {g for m, g in marks if m == "start"} - {g for m, g in marks if m == "end"}:
            try:
                os.killpg(pgid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    end = time.monotonic() + 60
    while st["agent"].is_alive() and time.monotonic() < end:
        kill_groups()
        st["agent"].join(timeout=0.5)
    kill_groups()  # a rank 1 whose rank 0 the agent stopped


def _phase19bc_relaunch(torch, cfg, st):
    """19b's first two children joined and checked, their resumes started;
    the uninterrupted runs (19b's and 19c's world 1) here meanwhile."""
    import os
    import signal

    from deepspeed_tpu_torch.resilience import (PREEMPTED_EXIT_CODE, resolve_tag_for_load,
                                                verify_tag)

    dirs = st["dirs"]
    end = st["end"] = time.monotonic() + RES_JOIN_S
    term, kill = st["term"], st["kill"]
    term.wait(timeout=max(1.0, end - time.monotonic()))
    kill.wait(timeout=max(1.0, end - time.monotonic()))
    st["term_reader"].join(timeout=10)
    st["kill_reader"].join(timeout=10)
    children_s = time.perf_counter() - st["t0"]
    term_out, kill_out = "".join(st["term_out"]), "".join(st["kill_out"])
    check(st["ready_s"] is not None, "19b: the SIGTERM child never reached step 3:\n"
          + term_out[-3000:])
    check(term.returncode == PREEMPTED_EXIT_CODE,
          f"19b: the SIGTERM child exited {term.returncode}:\n" + term_out[-3000:])
    check(kill.returncode == -signal.SIGKILL,
          f"19b: the kill child exited {kill.returncode}:\n" + kill_out[-3000:])
    meta = json.load(open(os.path.join(dirs["term"], "global_step4", "meta.json")))
    torn = os.path.join(dirs["kill"], "global_step4")
    try:
        verify_tag(torn)
        torn_rejected = None
    except Exception as e:
        torn_rejected = f"{type(e).__name__}: {e}"
    resolved = resolve_tag_for_load(dirs["kill"])[0]
    resumes = {mode: st["child"]("resume", dirs[mode]) for mode in ("term", "kill")}
    outs = {mode: [] for mode in resumes}
    readers = [_reader(p, outs[mode]) for mode, p in resumes.items()]
    # the uninterrupted runs, here, while the resumes and the agent run
    ref = _engine(_train_config(4), cfg)
    for b in _res_child_batches(cfg.vocab_size):
        ref.train_batch(b)
    torch.cuda.synchronize()
    ref_prints = _state_prints(ref)
    del ref
    world1 = _engine(_elastic19_conf(), cfg)
    w1 = _elastic19_train(world1, _res_child_batches(cfg.vocab_size))
    del world1
    torch.cuda.empty_cache()
    st["b"] = (children_s, meta, torn, torn_rejected, resolved, resumes, outs, readers,
               ref_prints, w1)


def _phase19bc_check(st):
    """19b's resumes and 19c's agent joined; both parts checked."""
    import os

    from deepspeed_tpu_torch.elasticity.elastic_agent import DSElasticAgent
    from deepspeed_tpu_torch.resilience import PREEMPTED_EXIT_CODE, is_committed, read_events

    dirs, end, term, kill = st["dirs"], st["end"], st["term"], st["kill"]
    children_s, meta, torn, torn_rejected, resolved, resumes, outs, readers, ref_prints, w1 = (
        st["b"])
    for p in resumes.values():
        p.wait(timeout=max(1.0, end - time.monotonic()))
    for t in readers:
        t.join(timeout=10)
    st["agent"].join(timeout=max(1.0, end - time.monotonic()))
    for mode, p in resumes.items():
        check(p.returncode == 0, f"19b: the {mode} resume exited {p.returncode}:\n"
              + "".join(outs[mode])[-3000:])
    finals = {m: json.load(open(os.path.join(dirs[m], "final.json"))) for m in resumes}
    log(f"phase19b fp32 gpt2-125m B4xT512, children of this script: SIGTERM after step 3 "
        f"(ready at {st['ready_s']:.1f} s) -> exit {term.returncode}, tag global_step4 "
        f"emergency={meta['emergency']} cursor={meta['data_cursor']}; the relaunch resumed at "
        f"step {finals['term']['start']} "
        f"preemptions_survived={finals['term']['preemptions_survived']} bitwise the "
        f"uninterrupted run={finals['term']['prints'] == ref_prints}; SIGKILL at the second "
        f"save's pre-commit -> exit {kill.returncode}, global_step4 committed="
        f"{is_committed(torn)} rejected: {torn_rejected}; resolved to {resolved}; the resume "
        f"started at step {finals['kill']['start']} "
        f"bitwise={finals['kill']['prints'] == ref_prints}; the first two children took "
        f"{children_s:.1f} s")
    check(meta["emergency"] is True and meta["data_cursor"] == 4, f"19b: emergency meta {meta}")
    check(finals["term"]["start"] == 4 and finals["term"]["preemptions_survived"] == 1,
          f"19b: the relaunch did not resume the emergency tag: {finals['term']['start']}")
    check(finals["term"]["prints"] == ref_prints, "19b: the SIGTERM resume is not bitwise")
    check(torn_rejected is not None and not is_committed(torn) and resolved == "global_step2",
          f"19b: the torn tag: rejected={torn_rejected} resolved={resolved}")
    check(finals["kill"]["start"] == 2 and finals["kill"]["prints"] == ref_prints,
          "19b: the resume after the torn save is not bitwise")
    # (c)
    agent_out = st["agent_out"]
    check("error" not in agent_out and not st["agent"].is_alive(),
          f"19c: the agent failed or hung: {agent_out}")
    result = agent_out["result"]
    recs = [json.loads(ln) for ln in open(os.path.join(dirs["elastic"], "log.jsonl"))]
    events = [e["event"] for e in read_events(dirs["elastic"])]
    launched = [(s.world_size, s.micro_batch, s.gas) for s in result.history]
    steps = [(r["step"], r["world"], r["loss"], r["grad_norm"]) for r in recs]
    log(f"phase19c elastic agent, fp32 gpt2-125m, global batch 4 (micro 2): result="
        f"{result.state} restarts={result.restarts} membership_changes="
        f"{result.membership_changes} launches (world, micro, gas)={launched} steps (step, "
        f"world, loss, grad norm)={steps} uninterrupted world 1={w1} events={events}; "
        f"19b and 19c took {time.perf_counter() - st['t0']:.1f} s")
    check(result.state == "SUCCEEDED" and result.restarts == 0
          and result.membership_changes == 1, f"19c: agent result {result}")
    check([(s.world_size, s.gas) for s in result.history] == [(2, 1), (1, 2)],
          f"19c: launches {result.history}")
    check([(r["step"], r["world"]) for r in recs] == [(1, 2), (2, 2), (3, 1), (4, 1)],
          f"19c: steps {recs}")
    check({"membership_change", "reshard_applied"} <= set(events), f"19c: events {events}")
    for r in recs:
        loss, norm = w1[r["step"]]
        check(abs(r["loss"] - loss) <= 1e-5 * abs(loss)
              and abs(r["grad_norm"] - norm) <= 1e-4 * abs(norm),
              f"19c step {r['step']}: ({r['loss']}, {r['grad_norm']}) vs world 1 ({loss}, {norm})")
    marker = os.path.join(dirs["agent"], "first")
    code = (f"import os, sys\np = {marker!r}\nif not os.path.exists(p):\n"
            f"    open(p, 'w').write('x'); sys.exit({PREEMPTED_EXIT_CODE})\nsys.exit(0)\n")
    pre = DSElasticAgent(lambda s: [sys.executable, "-c", code], {"elasticity": ELASTIC19},
                         device_count_fn=lambda: 1, max_restarts=0, poll_interval=0.05,
                         checkpoint_dir=dirs["agent"]).run()
    log(f"phase19c a preempted exit at max_restarts=0: {pre.state} restarts={pre.restarts} "
        f"preemptions={pre.preemptions}")
    check((pre.state, pre.restarts, pre.preemptions) == ("SUCCEEDED", 0, 1),
          f"19c: the preempted exit spent budget: {pre}")


def _phase19d(torch, ctx, cfg):
    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler, prefix_chain_hashes
    from deepspeed_tpu_torch.resilience import FaultPlan, install_plan

    params = ctx["params"]
    ps = SERVE_CFG["page_size"]
    sysp = ((np.arange(LEVER_PREFIX_PAGES * ps) * 7 + 3) % cfg.vocab_size).astype(np.int32)
    knobs = dict(enable_prefix_cache=True, page_fingerprints=True, pages_scan_per_step=2,
                 prefill_deadline_s=RES_SERVE_DEADLINE_S, decode_deadline_s=RES_SERVE_DEADLINE_S,
                 watchdog_poll_s=0.05, **SPEC)
    claim_pages = ContinuousBatchingScheduler._claim_pages
    runs = {}
    for name, plan in (("faults", FaultPlan(flip_bit_at=6, flip_bit_domain="kv_page",
                                            dispatch_stall_at=40,
                                            dispatch_stall_seconds=RES_SERVE_STALL_S)),
                       ("clean", None)):
        events = []
        mon = type("Monitor", (), {"write_events": lambda self, ev: events.extend(ev)})()
        claims = []  # the claims the plan's alloc_fail_at failed

        def claim(sched, req, need, plan=plan, claims=claims):
            """The plan's one alloc_fail_at, armed at the run's first claim
            that borrows prefix pages (the next alloc call is that claim's);
            a failed claim's trace: borrowed pages, the request still
            queued, every refcount as before, the audit."""
            hashes = prefix_chain_hashes(np.asarray(req.prompt), sched.page_size)
            borrowed = len(sched.prefix_cache.lookup_chain(hashes)[:need])
            if plan is not None and plan.alloc_fail_at is None and borrowed:
                plan.alloc_fail_at = sched.allocator._alloc_calls
            alloc = sched.allocator
            refs, faults = {p: alloc.refcount(p) for p in alloc.allocated_ids}, alloc._alloc_faults
            out = claim_pages(sched, req, need)
            if alloc._alloc_faults > faults:
                claims.append({"rid": req.rid, "step": sched.steps, "borrowed": borrowed,
                               "claimed": out is not None, "queued": req in sched.queue,
                               "unwound": refs == {p: alloc.refcount(p)
                                                   for p in alloc.allocated_ids},
                               "audit_ok": sched.audit()["ok"]})
            return out

        ContinuousBatchingScheduler._claim_pages = claim
        if plan:
            install_plan(plan)
        try:
            rep, toks, wl, _, eng = _serve(torch, cfg, params, "float32", system_prompt=sysp,
                                           monitor=mon, **knobs)
        finally:
            install_plan(None)
            ContinuousBatchingScheduler._claim_pages = claim_pages
        names = [n.split("/", 1)[1] for n, _, _ in events]
        stalls = [(n, v) for n, v, _ in events if n == "Serving/watchdog_stall"]
        alloc = eng.last_scheduler.allocator
        runs[name] = (toks, names)
        log(f"phase19d fp32 15a cell + n-gram spec, page fingerprints (scan 2 a step), "
            f"{name}: events={sorted(set(names))} sdc_detected={names.count('sdc_detected')} "
            f"sdc_healed={names.count('sdc_healed')} preemptions={rep['preemptions']} "
            f"stalls={stalls} alloc_calls={alloc._alloc_calls} alloc_fail_at="
            f"{plan.alloc_fail_at if plan else None} failed claims={claims} "
            f"match vs cache off (15a)={_match(toks, ctx['toks_15a_off']):.4f} "
            f"audit_ok={rep['pool_audit_ok']} recovery_counters={rep['recovery_counters']}")
        check(toks == ctx["toks_15a_off"], f"19d {name}: tokens differ from the cache-off run")
        if plan:
            check(names.count("sdc_detected") >= 1 and "sdc_healed" in names
                  and names.index("chaos_injected") < names.index("sdc_detected")
                  < names.index("sdc_healed"), f"19d: the flip was not healed: {names}")
            check(any(v >= RES_SERVE_DEADLINE_S for _, v in stalls),
                  f"19d: the stall was not flagged: {stalls}")
            # the failed claim degraded to queueing: its borrowed references
            # unwound, the request queued, the audit clean, and the request
            # admitted later and finished (its tokens are checked above)
            rid = claims[0]["rid"] if len(claims) == 1 else None
            check(alloc._alloc_faults == 1 and len(claims) == 1 and claims[0]["borrowed"] > 0
                  and not claims[0]["claimed"] and claims[0]["queued"]
                  and claims[0]["unwound"] and claims[0]["audit_ok"]
                  and any(r.rid == rid and r.state.name == "FINISHED" for r in wl),
                  f"19d: the allocation fault: {alloc._alloc_faults} fired, claims {claims}")
        else:
            check("sdc_detected" not in names and "chaos_injected" not in names
                  and alloc._alloc_faults == 0 and not claims, f"19d clean: {names}")
        del eng
    torch.cuda.empty_cache()


# phase 20: ZeRO-Offload / ZeRO-Infinity on GPT-2-125M at full width and depth
OFF20_STEPS = 3
OFF20_Q_STEPS = 2  # the int8 fetch's steps (numpy quantizes ~135M weights a step)
OFF20_DEPTHS = (0, 1, 2)
OFF20_STALL_S = 1.0  # the injected offload-fetch hang, against a 0.3 s deadline


def _host_prints(runner):
    """The crc32 of every host master of an offload runner, in RAM or on
    NVMe (equal lists: bitwise-equal masters)."""
    import zlib

    d = runner.host_state_dict()
    n = sum(k.startswith("master_") for k in d)
    return [zlib.crc32(np.ascontiguousarray(d[f"master_{i}"]).view(np.uint8)) for i in range(n)]


def _timed_host_steps(torch, engine, batches):
    """Steps with the host clock around a synchronised call each: (losses,
    grad norms, ms)."""
    losses, norms, ms = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = engine.train_batch(b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, norms, ms


def _stream_launch_want(launches, n_layer, steps):
    """The param stream's exact counts: B1 twice a layer (the forward and
    the backward's recompute), each B2 kernel once a layer, per step."""
    path = _flash_path("bfloat16")
    return {name: (2 if name in FWD_PATH["bfloat16"] else 1) * n_layer * steps
            if name in path else 0 for name in launches}


def phase_offload(torch, ctx):
    """Phase 20: ZeRO-Offload and ZeRO-Infinity (A12) on GPT-2-125M at full
    width and depth, from seed 0, through ``initialize``; tags and NVMe stores
    under a temporary directory removed at the end. (a) ``offload_optimizer``
    cpu (through the legacy ``cpu_offload`` key), fp32 B4 x T512, 3 steps,
    against the in-device AdamW run from the same weights: losses rtol 2e-4,
    the host masters rtol 1e-3 / atol 2e-5 of the device's, exact launches;
    step ms, host-step ms and peak memory beside the in-device step's; the
    optimizer state on NVMe (the ``aio`` block's threads) for one step,
    bitwise the RAM run's. (b) ``offload_param`` cpu, bf16 B8 x T512 (5b's
    batch), 3 steps at prefetch depths 0, 1 and 2: losses, grad norms and
    every host master bitwise equal across depths; step 1 within 0.5 of
    ln V, the loss falls; B1 2 x 12 and each B2 kernel 12 launches a step;
    peak memory beside 5b's in-device step and the fp32 model's bytes, the
    ``host_dma`` row at each depth. (c) one more step at depth 2 with every
    drained gradient held bitwise against a synchronous ``.cpu()`` of the
    same device tensor, and every bf16 push buffer bitwise
    ``master.to(torch.bfloat16)``. (d) ``quantized_fetch`` int8, 2 steps:
    losses within rel 0.05 of (b)'s, wire ratio at least 1.9. (e) + (f) a
    save after step 2 with host shards under the MANIFEST; a fresh engine
    whose masters live on NVMe loads it and takes step 3 bitwise the
    uninterrupted RAM run's; then an injected ``stall_offload_at`` hang is
    named ``offload_fetch`` by the watchdog."""
    import os
    import shutil
    import tempfile

    from deepspeed_tpu_torch.models import gpt

    cfg = gpt.PRESETS["gpt2-125m"]
    root = tempfile.mkdtemp(prefix="off20_")
    try:
        t0 = time.perf_counter()
        _phase20a(torch, ctx, cfg, root)
        log(f"phase20a took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _phase20bf(torch, ctx, cfg, root)
        log(f"phase20b-f took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase20a(torch, ctx, cfg, root):
    import os

    from deepspeed_tpu_torch.utils.tree import tree_leaves

    V, L = cfg.vocab_size, cfg.n_layer
    rng = np.random.default_rng(20)
    batches = [{"input_ids": rng.integers(0, V, (4, 512)).astype(np.int32)}
               for _ in range(OFF20_STEPS)]
    runs = {}
    step1 = None
    # the RAM run through the legacy key (migrated to offload_optimizer cpu)
    for name, over in (("device", {}),
                       ("offload", {"zero_optimization": {"cpu_offload": True}})):
        engine = _engine(_train_config(4, **over), cfg, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa, _ = _reset_counts()  # each run's fp32 path
        losses, norms, ms = [], [], []
        for b in batches:
            lo, no, t = _timed_host_steps(torch, engine, [b])
            losses, norms, ms = losses + lo, norms + no, ms + t
            if name == "offload" and step1 is None:
                step1 = _host_prints(engine._offload)
        launches = _flash_launches(fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if name == "device":
            final = [p.detach().float().cpu().numpy() for p in tree_leaves(engine.state["params"])]
            host = {}
        else:
            check(engine._offload is not None, "20a: cpu_offload did not build the runner")
            final = engine._offload.master
            host = dict(engine._offload.last_stats)
        runs[name] = (losses, norms, ms, launches, peak_gb, final, host)
        del engine
        torch.cuda.empty_cache()
    (dl, dn, dms, _, dpeak, dfinal, _), (ol, on, oms, launches, opeak, ofinal, host) = (
        runs["device"], runs["offload"])
    err = max(float(np.max(np.abs(a - b) / (2e-5 + 1e-3 * np.abs(b))))
              for a, b in zip(ofinal, dfinal))
    log(f"phase20a offload_optimizer cpu (legacy cpu_offload) fp32 gpt2-125m B4xT512: losses={ol} "
        f"device losses={dl} grad_norms={on} device grad_norms={dn} launches over "
        f"{OFF20_STEPS} steps={launches} masters' worst |diff| / (2e-5 + 1e-3 |device|)={err:.4f}")
    log(f"phase20a step_ms (host clock, synchronized)={[round(x, 1) for x in oms]} device step "
        f"ms={[round(x, 1) for x in dms]} last host step ms={host['host_step_s'] * 1e3:.1f} "
        f"fetch ms={host['fetch_s'] * 1e3:.1f} host cores={os.cpu_count()} peak memory GB: "
        f"offload={opeak:.3f} device={dpeak:.3f}")
    check(np.allclose(ol, dl, rtol=2e-4, atol=0), f"20a losses {ol} vs the device's {dl}")
    check(err <= 1.0, f"20a host masters off the device's (rtol 1e-3 / atol 2e-5): {err}")
    want = path_launches(launches, OFF20_STEPS * L, _flash_path("float32"))
    check(launches == want, f"20a launches {launches}, expected {want}")
    check(opeak < dpeak, f"20a offload peak {opeak} GB not below the device run's {dpeak}")
    # the optimizer state on NVMe, through the aio block's threads: step 1
    # bitwise the RAM run's
    engine = _engine(_train_config(4, aio={"thread_count": 4}, zero_optimization={
        "offload_optimizer": {"device": "nvme", "nvme_path": os.path.join(root, "nvme20a")}}),
        cfg, seed=0)
    nl, nn, nms = _timed_host_steps(torch, engine, batches[:1])
    nprints = _host_prints(engine._offload)
    log(f"phase20a offload_optimizer nvme (aio thread_count 4): step 1 loss={nl[0]} "
        f"grad_norm={nn[0]} ms={nms[0]:.1f} (RAM {ol[0]} {on[0]} {oms[0]:.1f}); "
        f"{engine._offload.store.aio.num_threads} aio threads")
    check(nl[0] == ol[0] and nn[0] == on[0] and nprints == step1,
          "20a: the NVMe optimizer step is not bitwise the RAM run's")
    del engine
    torch.cuda.empty_cache()


def _stream_conf(**op):
    return _train_config(8, bf16={"enabled": True},
                         zero_optimization={"offload_param": {"device": "cpu", **op}})


def _phase20bf(torch, ctx, cfg, root):
    import os

    from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
    from deepspeed_tpu_torch.resilience import FaultPlan, install_plan, read_events
    from deepspeed_tpu_torch.runtime.zero import stream as offload_stream

    V, L = cfg.vocab_size, cfg.n_layer
    check("train5b_batch" in ctx, "phase 20 reads phase 5b's batch and peak: run phase_kernels "
          "and phase_training before it")
    batch, peak5b = ctx["train5b_batch"], ctx["train5b"]["peak_gb"]
    model_gb = cfg.num_params() * 4 / 1e9
    runs = {}
    for depth in OFF20_DEPTHS:
        engine = _engine(_stream_conf(prefetch_depth=depth), cfg, seed=0)
        runner = engine._param_stream
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa, _ = _reset_counts()  # the param stream's bf16 path at this depth
        losses, norms, ms, dma = [], [], [], []
        for step in range(OFF20_STEPS):
            lo, no, t = _timed_host_steps(torch, engine, [batch])
            losses += lo
            norms += no
            ms += t
            dma.append(runner.last_stats["host_dma"])
            if depth == 2 and step == 1:
                # (f) the save after step 2, host shards under the manifest
                t0 = time.perf_counter()
                tag = engine.save_checkpoint(os.path.join(root, "ckpt"))
                save_s = time.perf_counter() - t0
        launches = _flash_launches(fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        runs[depth] = dict(losses=losses, norms=norms, ms=ms, dma=dma, launches=launches,
                           peak_gb=peak_gb, prints=_host_prints(runner),
                           host_step_ms=runner.last_stats["host_step_s"] * 1e3)
        r = runs[depth]
        log(f"phase20b offload_param cpu bf16 gpt2-125m B8xT512 prefetch_depth={depth}: "
            f"losses={losses} grad_norms={norms} step_ms (host clock, synchronized)="
            f"{[round(x, 1) for x in ms]} host step ms={r['host_step_ms']:.1f} launches over "
            f"{OFF20_STEPS} steps={launches} peak memory GB={peak_gb:.3f} (5b in-device "
            f"{peak5b:.3f}, fp32 model "
            f"{model_gb:.3f}) host_dma (last step)={dma[-1]}")
        if depth == 2:
            # (c) the copy checks: the bf16 push buffers against the masters'
            # casts, then one step with every drained gradient held against a
            # synchronous copy of its device tensor
            masters = runner.host_units()
            pushed_ok = all(torch.equal(buf.view(torch.int16), torch.from_numpy(
                masters[f"master_{i}"]).to(torch.bfloat16).view(torch.int16))
                for i, buf in enumerate(runner._push_bufs))
            runner.verify_copies = True
            engine.train_batch(batch)
            cc = dict(runner.copy_check)
            log(f"phase20c copy checks: push buffers bitwise the masters' bf16 casts="
                f"{pushed_ok}; drained gradients against synchronous copies={cc}")
            check(pushed_ok, "20c: a bf16 push buffer differs from its master's cast")
            check(cc["drains"] == L + 3 and cc["tensors"] > 0 and cc["mismatches"] == 0,
                  f"20c: drained gradients differ from synchronous copies: {cc}")
        del engine, runner
        torch.cuda.empty_cache()
    base = runs[0]
    for depth in OFF20_DEPTHS[1:]:
        r = runs[depth]
        check(r["losses"] == base["losses"] and r["norms"] == base["norms"],
              f"20b depth {depth}: losses / norms {r['losses']} {r['norms']} not bitwise "
              f"depth 0's {base['losses']} {base['norms']}")
        check(r["prints"] == base["prints"], f"20b depth {depth}: host masters not bitwise "
              "depth 0's")
    for depth, r in runs.items():
        want = _stream_launch_want(r["launches"], L, OFF20_STEPS)
        check(r["launches"] == want, f"20b depth {depth}: launches {r['launches']}, "
              f"expected {want}")
    check(abs(base["losses"][0] - math.log(V)) < 0.5,
          f"20b step-1 loss {base['losses'][0]} far from ln(V)")
    check(base["losses"][-1] < base["losses"][0], f"20b loss did not fall: {base['losses']}")
    check(all(math.isfinite(x) for x in base["losses"] + base["norms"]), "20b not finite")

    # (d) the quantized fetch, int8 blocks of 256
    wire_ledger.reset()
    engine = _engine(_stream_conf(prefetch_depth=2, quantized_fetch=True), cfg, seed=0)
    fa, _ = _reset_counts()
    ql, qn, qms = _timed_host_steps(torch, engine, [batch] * OFF20_Q_STEPS)
    qlaunches = _flash_launches(fa)
    qdma = engine._param_stream.last_stats["host_dma"]
    ratio = wire_ledger.ratio("qpush")
    rel = max(abs(a - b) / abs(b) for a, b in zip(ql, base["losses"]))
    log(f"phase20d quantized_fetch int8 bf16: losses={ql} (exact {base['losses']}, worst rel "
        f"{rel:.4f}) grad_norms={qn} step_ms={[round(x, 1) for x in qms]} wire ratio "
        f"(ledger qpush)={ratio:.3f} host_dma={qdma} launches={qlaunches}")
    check(rel <= 0.05, f"20d losses off the exact run's by {rel}")
    check(ratio >= 1.9 and qdma["ratio"] >= 1.9, f"20d wire ratio {ratio} / {qdma['ratio']}")
    want = _stream_launch_want(qlaunches, L, OFF20_Q_STEPS)
    check(qlaunches == want, f"20d launches {qlaunches}, expected {want}")
    wire_ledger.reset()
    del engine
    torch.cuda.empty_cache()

    # (e) + (f) the step-2 tag (RAM host shards) resumed by an engine whose
    # masters live on NVMe: its step 3 bitwise the uninterrupted RAM run's;
    # then the injected stall
    manifest = json.load(open(os.path.join(tag, "MANIFEST.json")))
    shards = [f for f in manifest["files"] if f.startswith("host_state/shard_")]
    res_dir = os.path.join(root, "res")
    nvme = os.path.join(root, "nvme")
    res = {"enabled": True, "save_dir": res_dir, "install_signal_handlers": False,
           "watchdog": {"enabled": True, "poll_interval_s": 0.05,
                        "offload_fetch_deadline_s": 0.3, "escalate": False}}
    engine = _engine(_stream_conf(prefetch_depth=2, device="nvme", nvme_path=nvme)
                     | {"resilience": res}, cfg, seed=1)
    try:
        t0 = time.perf_counter()
        engine.load_checkpoint(os.path.join(root, "ckpt"))
        load_s = time.perf_counter() - t0
        rl, rn, rms = _timed_host_steps(torch, engine, [batch])
        same = (rl[0] == runs[2]["losses"][2] and rn[0] == runs[2]["norms"][2]
                and _host_prints(engine._param_stream) == runs[2]["prints"])
        files = len(os.listdir(os.path.join(nvme, "param_stream")))
        install_plan(FaultPlan(stall_offload_at=offload_stream._fetch_wait_index,
                               stall_offload_seconds=OFF20_STALL_S))
        engine.train_batch(batch)
        torch.cuda.synchronize()
        deadline = time.monotonic() + 3.0
        while engine._watchdog.stall_count == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        stalls = [e for e in read_events(res_dir) if e["event"] == "watchdog_stall"]
        last = engine._watchdog.last_stall
    finally:
        install_plan(None)
        engine._watchdog.stop()
    log(f"phase20e+f save after step 2: {len(shards)} host shards under the manifest, "
        f"COMMIT={os.path.exists(os.path.join(tag, 'COMMIT'))}, saved in {save_s:.2f} s, "
        f"loaded verified into NVMe masters ({files} leaf files) in {load_s:.2f} s; resumed "
        f"step 3 loss={rl[0]} grad_norm={rn[0]} ms={rms[0]:.1f} (RAM {runs[2]['ms'][2]:.1f}) "
        f"bitwise the uninterrupted RAM run={same}; injected {OFF20_STALL_S} s fetch stall: "
        f"watchdog last stall={last} events={[(e['phase'], round(e['value'], 3)) for e in stalls]}")
    check(len(shards) == L + 2 and os.path.exists(os.path.join(tag, "COMMIT")),
          f"20f: host shards {shards} not all under the manifest")
    check(same, "20e/f: the resumed NVMe step 3 is not bitwise the uninterrupted RAM run's")
    check(last is not None and last[0] == "offload_fetch" and stalls
          and stalls[-1]["phase"] == "offload_fetch", f"20f: the stall was not named: {last}")
    del engine
    torch.cuda.empty_cache()


def main() -> int:
    child = _res_children_main(sys.argv)  # phase 19's child processes
    if child is not None:
        return child
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch  # noqa: F401  (fails where the repo is absent)

    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    ctx = {"timer": Timer(torch)}
    failures = []
    # --only phase_a,phase_b: those phases alone, without the result lines
    only = set(sys.argv[sys.argv.index("--only") + 1].split(",")) if "--only" in sys.argv else None
    for phase in (phase_build, phase_kernels, phase_scoring, phase_serving, phase_training,
                  phase_paged_serving, phase_quantized, phase_spec_serving, phase_zero3,
                  phase_sparse, phase_head_dim_96, phase_checkpoint, phase_gpt_variants,
                  phase_decoding_modes, phase_serving_levers, phase_data_parallel,
                  phase_engine_features, phase_a3c, phase_resilience, phase_offload,
                  phase_resilience_join):
        if only and phase.__name__ not in only and phase is not phase_resilience_join:
            continue
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
    if only:
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    kernels = [
        {"name": "flash_attention_fwd_tf32", "route": "cuda", "source": FLASH_TF32_SRC,
         "replaces": FLASH_TPU, **ctx["flash"]},
        {"name": "flash_attention_fwd_tc", "route": "cuda", "source": FLASH_TC_SRC,
         "replaces": FLASH_TPU, **ctx["flash_tc"]},
        {"name": "decode_attention", "route": "cuda", "source": DECODE_SRC,
         "replaces": DECODE_TPU, **ctx["decode"]},
        {"name": "flash_attention_bwd_delta", "route": "cuda", "source": FLASH_BWD_SRC,
         "replaces": BWD_TPU["delta"], **ctx["bwd_delta"]},
    ] + [{"name": f"flash_attention_bwd_{n}", "route": "cuda", "source": FLASH_BWD_TF32_SRC,
          "replaces": BWD_TPU[n.split("_")[0]], **ctx[f"bwd_{n}"]} for n in BWD_TF32_KERNELS] + [
        {"name": f"flash_attention_bwd_{n}", "route": "cuda", "source": FLASH_BWD_TC_SRC,
         "replaces": BWD_TPU[n.split("_")[0]], **ctx[f"bwd_{n}"]} for n in BWD_TC_KERNELS] + [
        {"name": "paged_decode_attention" + ("" if kind == "dense" else f"_{kind}"),
         "route": "cuda", "source": PAGED_SRC, "replaces": PAGED_TPU[kind],
         **ctx[f"paged_{kind}"]} for kind in PAGED_KINDS] + [
        {"name": f"int{bits}_matmul", "route": "cuda", "source": QMM_SRC,
         "replaces": QMM_TPU[f"int{bits}"], **ctx[f"qmm_int{bits}"]} for bits in (8, 4)] + [
        {"name": f"int{bits}_matmul_tc", "route": "cuda", "source": QMM_TC_SRC,
         "replaces": QMM_TPU[f"int{bits}"], **ctx[f"qmm_tc_int{bits}"]} for bits in (8, 4)] + [
        {"name": f"int{bits}_matmul_tc_fp32", "route": "cuda", "source": QMM_TC_SRC,
         "replaces": QMM_TPU[f"int{bits}"], **ctx[f"qmm_tc_f32_int{bits}"]}
        for bits in (8, 4)] + [
        {"name": f"int{bits}_matmul_decode", "route": "cuda", "source": QMM_DEC_SRC,
         "replaces": QMM_TPU[f"int{bits}"], **ctx[f"qmm_dec_int{bits}"]}
        for bits in (8, 4)] + [
        {"name": "paged_verify_attention" + ("" if kind == "dense" else f"_{kind}"),
         "route": "cuda", "source": VERIFY_SRC, "replaces": VERIFY_TPU,
         **ctx[f"verify_{kind}"]} for kind in PAGED_KINDS] + [
        {"name": "dequant_matmul_tc", "route": "cuda", "source": DQM_TC_SRC,
         "replaces": DQM_TPU, **ctx["dqm_tc"]},
        {"name": "dequant_matmul_tc_few_rows", "route": "cuda", "source": DQM_TC_SRC,
         "replaces": DQM_TPU, **ctx["dqm_tc_few_rows"]},
        {"name": "dequant_matmul_tc_block128", "route": "cuda", "source": DQM_TC_SRC,
         "replaces": DQM_TPU, **ctx["dqm_tc_block128"]},
        {"name": "dequant_matmul_tc_block96", "route": "cuda", "source": DQM_TC_SRC,
         "replaces": DQM_TPU, **ctx["dqm_tc_block96"]}] + [
        {"name": "blocksparse_attention_" + ("fwd" if n == "fwd" else f"bwd_{n}") + "_tf32",
         "route": "cuda", "source": BS_FWD_TF32_SRC if n == "fwd" else BS_BWD_TF32_SRC,
         "replaces": BS_TPU[n], **ctx[f"bs_tf32_{n}"]} for n in BS_KERNELS] + [
        {"name": "blocksparse_attention_" + ("fwd" if n == "fwd" else f"bwd_{n}") + "_tc",
         "route": "cuda", "source": BS_FWD_TC_SRC if n == "fwd" else BS_BWD_TC_SRC,
         "replaces": BS_TPU[n], **ctx[f"bs_tc_{n}"]} for n in BS_KERNELS] + [
        {"name": "blocksparse_attention_" + ("fwd" if n == "fwd" else f"bwd_{n}")
         + "_tc_small_blocks", "route": "cuda",
         "source": BS_FWD_TC_SRC if n == "fwd" else BS_BWD_TC_SRC, "replaces": BS_TPU[n],
         **ctx[f"bs_tc_small_{n}"]} for n in BS_KERNELS]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    log(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
