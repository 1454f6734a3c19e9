"""Serving engine: bucketed chunked prefill + fixed-slot paged decode.

Counterpart of ``deepspeed_tpu/inference/serving/engine.py``: the device half
of the continuous-batching stack (the host half is
``scheduler.ContinuousBatchingScheduler``). It keeps the reference's program
families and their shapes, so the padded shapes, and with them the numerics,
are the reference's:

- **decode**: ``models/gpt.paged_decode_step`` over the fixed slot array
  ``[num_slots]``, greedy-sampled on the device. A block of K steps is a
  loop of K steps in which each step's argmax feeds the next without
  leaving the device; the block reads the host once (``[K, num_slots]``).
  Its attention is the B4 paged kernel on CUDA; over a quantized weight
  tree (``models.gpt.quantize_for_inference``) its projections are the
  int8 / int4 weight kernels.
- **verify** (speculative decoding, ``spec_drafter`` set): one
  ``models/gpt.paged_verify_step`` over a ``[num_slots, k + 1]`` window per
  ladder entry k (``spec_k_set``), its attention the B5 kernel on CUDA;
  greedy longest-prefix acceptance, truncated at eos and at the remaining
  budget, runs on the device, then ``commit_window_kv`` appends the
  accepted prefix; the host reads the outputs and counts once per window.
  The drafter is ``speculate.make_drafter``'s.
- **prefill**: one shape per chunk bucket (powers of two up to
  ``prefill_chunk``): a prompt of at most one chunk runs in one padded
  forward (fused), an admission cycle of several such prompts as one
  ``[num_slots, chunk]`` forward (batched), and a longer prompt streams
  through the contiguous-cache forward chunk by chunk, then is scattered
  into its pages (``write_prompt_kv``). The prefill forward attends with the
  plain masked softmax, as the reference's does.

PyTorch runs eagerly, so nothing is compiled: ``compile_log`` records the
first dispatch of each program shape, the events the reference logs at each
compile. CUDA graphs over the decode step are ROADMAP.md A5b.

Every ``ServingConfig`` knob outside this slice keeps the reference's
default; any other value raises ``NotImplementedError`` naming its
ROADMAP.md item (:func:`check_serving_config`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ...accelerator import resolve_device, to_device
from ...models import gpt as gpt_mod
from ...utils.errors import unported
from .buckets import bucket_for, default_buckets
from .paging import pages_for
from .scheduler import ContinuousBatchingScheduler
from .speculate import make_drafter, spec_k_ladder


@dataclasses.dataclass
class ServingConfig:
    """Knobs of the serving path, with the reference's fields and defaults.
    The port honours ``num_slots`` (an int), ``page_size``,
    ``max_model_len``, ``num_pages``, ``prefill_chunk``, ``kv_bits``
    (None or 0 for dense pools, 8 or 4), ``decode_block``, the speculation
    knobs ``spec_drafter`` (None | "ngram" | "draft_model"), ``spec_k`` (1 to
    16), ``spec_adaptive``, ``spec_ngram`` and ``spec_draft_model``, ``dtype``
    and ``kernel_impl`` (None = the kernel on CUDA | "kernel" | "gather").
    ``spec_equivalence_harness`` is accepted and does nothing: its only
    reader is the reference's dslint rule ``analysis/rules_serving.py``
    (ROADMAP.md A14). The rest must keep their defaults (see
    :func:`check_serving_config`)."""

    num_slots: Union[int, str] = 4
    page_size: int = 64
    max_model_len: int = 1024           # prompt + generation bound
    num_pages: Optional[int] = None     # default: every slot can max out
    prefill_chunk: int = 128
    kv_bits: Optional[int] = None       # 8 / 4: quantized pools with per-page scales
    enable_prefix_cache: bool = False
    page_fingerprints: bool = False
    pages_scan_per_step: int = 1
    # decode block: up to K decode steps run back to back on the device when
    # no scheduling event can occur within them; at most page_size (an
    # inactive slot parks on the sink page for at most one page of steps)
    decode_block: int = 4
    spec_drafter: Optional[str] = None
    spec_k: int = 4
    spec_adaptive: bool = True
    spec_ngram: int = 3
    spec_draft_model: Optional[str] = None
    spec_equivalence_harness: bool = False
    sampling_temperature: float = 0.0
    dtype: str = "bfloat16"
    kernel_impl: Optional[str] = None
    tp: int = 1
    role: str = "both"
    # kept for the reference's schema and read by nothing, as there:
    # Request.eos_token_id stops a request
    eos_token_id: Optional[int] = None
    model_name: Optional[str] = None
    max_queue: Optional[int] = None
    max_queued_tokens: Optional[int] = None
    shed_policy: str = "reject_newest"
    ttft_deadline_s: Optional[float] = None
    request_deadline_s: Optional[float] = None
    tiers: Union[None, bool, str, dict] = None
    tenants: Optional[dict] = None
    brownout_window_s: float = 5.0
    brownout_enter_shed_rate: float = 0.25
    brownout_enter_misses: int = 2
    brownout_exit_shed_rate: float = 0.05
    brownout_min_dwell_s: float = 1.0
    dispatch_retries: int = 2
    quarantine_after: int = 2
    dispatch_failure_budget: int = 8
    prefill_deadline_s: Optional[float] = None
    decode_deadline_s: Optional[float] = None
    watchdog_poll_s: float = 0.25
    stacks_dir: Optional[str] = None

    @property
    def pages_per_seq(self) -> int:
        return pages_for(self.max_model_len, self.page_size)

    @property
    def spec_k_set(self) -> tuple:
        """The draft-length ladder, one verify window shape per entry (empty
        when no drafter is configured)."""
        return spec_k_ladder(self.spec_k) if self.spec_drafter else ()


# the knobs outside this slice, by the ROADMAP.md item that ports them
_UNPORTED_KNOBS = {
    "A7": ("enable_prefix_cache", "max_queue", "max_queued_tokens", "shed_policy",
           "ttft_deadline_s", "request_deadline_s", "dispatch_retries", "quarantine_after",
           "dispatch_failure_budget"),
    "A10": ("tp", "role", "tiers", "tenants", "brownout_window_s",
            "brownout_enter_shed_rate", "brownout_enter_misses", "brownout_exit_shed_rate",
            "brownout_min_dwell_s"),
    "A11": ("page_fingerprints", "pages_scan_per_step", "prefill_deadline_s",
            "decode_deadline_s", "watchdog_poll_s", "stacks_dir"),
    "A14": ("model_name",),
}


def check_serving_config(s: ServingConfig) -> None:
    """Raise for every knob this slice does not honour: a value other than
    the reference's default raises ``NotImplementedError`` naming the
    ROADMAP.md item that ports it, so no knob is ignored without a word."""
    defaults = ServingConfig()
    for item, names in _UNPORTED_KNOBS.items():
        for name in names:
            if getattr(s, name) != getattr(defaults, name):
                raise unported(f"ServingConfig.{name}={getattr(s, name)!r}", item)
    if s.num_slots == "auto":
        raise unported("ServingConfig.num_slots='auto' (the fit ladder)", "A14")
    if s.sampling_temperature:
        raise NotImplementedError(
            "serving samples greedily (temperature 0), as the reference does; "
            f"sampling_temperature={s.sampling_temperature} is not implemented")
    if s.kv_bits not in (None, 0, 8, 4):
        raise ValueError(f"kv_bits must be 8 or 4 (None or 0: dense), got {s.kv_bits}")
    if s.kernel_impl not in (None, "kernel", "gather"):
        raise ValueError(f"kernel_impl must be None, 'kernel' or 'gather': {s.kernel_impl!r}")
    if s.spec_drafter and not (1 <= s.spec_k <= 16):
        raise ValueError(f"spec_k {s.spec_k} outside [1, 16]")


class ServingEngine:
    """Executor over a GPT config + params (see the module docstring).
    ``device`` (default: the CUDA device, raising where there is none) is
    where the params, the page pool and every program live. ``draft``, a
    ``(GPTConfig, params)`` pair, is the model the ``"draft_model"`` drafter
    proposes tokens with."""

    def __init__(self, cfg: gpt_mod.GPTConfig, params, serving: Optional[ServingConfig] = None,
                 monitor=None, draft=None, device=None):
        self.cfg = cfg
        self.serving = serving or ServingConfig()
        self.draft = draft
        s = self.serving
        if monitor is not None:
            raise unported("ServingEngine(monitor=...) (serving telemetry)", "A3b")
        check_serving_config(s)
        gpt_mod.check_config(cfg)
        if s.max_model_len > cfg.max_seq_len and not (cfg.rotary or cfg.alibi):
            raise ValueError(f"max_model_len {s.max_model_len} exceeds the model's learned "
                             f"position table ({cfg.max_seq_len})")
        if not (1 <= s.decode_block <= s.page_size):
            raise ValueError(f"decode_block {s.decode_block} must be in "
                             f"[1, page_size={s.page_size}]")
        self.device = resolve_device(device)
        self.compile_log: List[dict] = []
        self.num_slots = int(s.num_slots)
        self.num_pages = (s.num_pages if s.num_pages is not None
                          else self.num_slots * s.pages_per_seq + 1)
        self.dtype = getattr(torch, {"bf16": "bfloat16", "fp32": "float32",
                                     "fp16": "float16"}.get(s.dtype, s.dtype))
        # quantized {"q"|"q4", "s"} leaves pass whole (fp32 scales)
        self.params = gpt_mod.cast_params(params, self.device, self.dtype)
        self.paged_cache = gpt_mod.init_paged_cache(cfg, self.num_pages, s.page_size,
                                                    self.dtype, kv_bits=s.kv_bits,
                                                    device=self.device)
        self.last_scheduler: Optional[ContinuousBatchingScheduler] = None
        # prefill's contiguous scratch: chunks append at chunk-aligned
        # positions, so it covers the bucket-padded context
        self._dense_S = -(-s.max_model_len // s.prefill_chunk) * s.prefill_chunk
        self._chunk_buckets = default_buckets(min(32, s.prefill_chunk), s.prefill_chunk)
        self._seen_shapes = set()

    # -------------------------------------------------------------- helpers
    def _log_shape(self, kind: str, shape: Tuple[int, ...]) -> None:
        """Record the first dispatch of a program shape (the reference logs
        a compile there)."""
        key = (kind, tuple(int(x) for x in shape))
        if key not in self._seen_shapes:
            self._seen_shapes.add(key)
            self.compile_log.append({"kind": kind, "shape": key[1], "time": time.time()})

    def _to_device(self, a, dtype=np.int64) -> torch.Tensor:
        """A host array on the engine's device, copied without draining the
        stream (pinned, non-blocking)."""
        return to_device(np.asarray(a, dtype), self.device)

    def _forward(self, ids: np.ndarray, cache):
        return gpt_mod.forward_with_cache(self.cfg, self.params, self._to_device(ids), cache)

    # -------------------------------------------------------------- executor
    @torch.no_grad()
    def prefill(self, slot: int, tokens: np.ndarray, table_row: np.ndarray,
                start: int = 0) -> int:
        """Chunked prefill of one request's context; writes its KV into the
        pages ``table_row`` names (positions from ``start`` on) and returns
        the greedy next token."""
        del slot  # pages are named by table_row; the slot id is host-side
        s = self.serving
        tokens = np.asarray(tokens, np.int32)
        T = int(tokens.shape[0])
        if T < 1 or T > s.max_model_len:
            raise ValueError(f"context length {T} outside (0, {s.max_model_len}]")
        if T <= s.prefill_chunk:  # fused short-prompt path: one padded forward
            chunk = bucket_for(T, self._chunk_buckets)
            self._log_shape("serving_prefill_fused", (1, chunk))
            ids = np.zeros((1, chunk), np.int32)
            ids[0, :T] = tokens
            cache = gpt_mod.init_cache(self.cfg, 1, chunk, self.dtype, self.device)
            logits, cache = self._forward(ids, cache)
            gpt_mod.write_prompt_kv(self.paged_cache, cache, table_row, T, start=start)
            return int(logits[0, T - 1].argmax())
        cache = gpt_mod.init_cache(self.cfg, 1, self._dense_S, self.dtype, self.device)
        pos = 0
        while pos < T:
            rem = T - pos
            chunk = (s.prefill_chunk if rem >= s.prefill_chunk
                     else bucket_for(rem, self._chunk_buckets))
            self._log_shape("serving_prefill", (1, chunk))
            ids = np.zeros((1, chunk), np.int32)
            ids[0, :min(rem, chunk)] = tokens[pos:pos + chunk]
            logits, cache = self._forward(ids, cache)
            last_idx = min(rem, chunk) - 1
            pos += chunk
        self._log_shape("serving_scatter", (self._dense_S,))
        gpt_mod.write_prompt_kv(self.paged_cache, cache, table_row, T, start=start)
        return int(logits[0, last_idx].argmax())

    @torch.no_grad()
    def prefill_many(self, items) -> dict:
        """Prefill one admission cycle: prompts of at most one chunk batch
        into a single ``[num_slots, chunk]`` forward, longer prompts take the
        chunked path. ``items``: [(slot, tokens, table_row)] or [(slot,
        tokens, table_row, start)]; returns {slot: first_token}."""
        s = self.serving
        out = {}
        items = [(it[0], np.asarray(it[1], np.int32), it[2], int(it[3]) if len(it) > 3 else 0)
                 for it in items]
        short = [it for it in items if len(it[1]) <= s.prefill_chunk]
        for slot, t, row, start in items:
            if len(t) > s.prefill_chunk:
                out[slot] = self.prefill(slot, t, row, start)
        if not short:
            return out
        if len(short) == 1:  # no batching win: the fused single path
            slot, t, row, start = short[0]
            out[slot] = self.prefill(slot, t, row, start)
            return out
        chunk = bucket_for(max(len(t) for _, t, _, _ in short), self._chunk_buckets)
        self._log_shape("serving_prefill_batch", (self.num_slots, chunk))
        ids = np.zeros((self.num_slots, chunk), np.int32)
        tables = np.zeros((self.num_slots, s.pages_per_seq), np.int32)
        lengths = np.zeros(self.num_slots, np.int32)
        starts = np.zeros(self.num_slots, np.int32)
        for j, (slot, t, row, start) in enumerate(short):
            ids[j, :len(t)] = t
            tables[j] = row
            lengths[j] = len(t)
            starts[j] = start
        cache = gpt_mod.init_cache(self.cfg, self.num_slots, chunk, self.dtype, self.device)
        logits, cache = self._forward(ids, cache)
        gpt_mod.write_prompt_kv_batch(self.paged_cache, cache, tables, lengths, starts)
        last = self._to_device(np.maximum(lengths - 1, 0))
        toks = logits[torch.arange(self.num_slots, device=self.device), last].argmax(-1)
        toks = toks.cpu().numpy()
        for j, (slot, _, _, _) in enumerate(short):
            out[slot] = int(toks[j])
        return out

    @torch.no_grad()
    def decode(self, tokens: np.ndarray, tables: np.ndarray, lengths: np.ndarray,
               active: np.ndarray, steps: int = 1) -> np.ndarray:
        """``steps`` decode steps over every slot; returns [steps, num_slots]
        greedy tokens (inactive slots write to the sink page and their
        outputs are ignored). The inputs cross to the device once, each
        step's tokens feed the next on the device, and the block reads the
        host once."""
        del active  # every slot runs; masking is host-side
        self._log_shape("serving_decode", (steps, self.num_slots))
        toks = self._to_device(tokens)
        tbl = self._to_device(tables, np.int32)
        lens = self._to_device(lengths, np.int32)
        out = []
        for _ in range(steps):
            logits, _ = gpt_mod.paged_decode_step(self.cfg, self.params, toks,
                                                  self.paged_cache, tbl, lens,
                                                  impl=self.serving.kernel_impl)
            toks = logits.argmax(-1)
            out.append(toks)
            lens = lens + 1
        return torch.stack(out).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def verify(self, tokens: np.ndarray, tables: np.ndarray, lengths: np.ndarray,
               active: np.ndarray, eos: np.ndarray, budget: np.ndarray):
        """One speculation window over every slot: ``tokens`` [num_slots, W]
        (the verified input token, then the drafts), per-slot ``eos`` (-1 =
        none) and remaining ``budget``. Returns (outputs [num_slots, W],
        n_accept [num_slots]); the accepted prefix's K/V is already
        committed. Draft i survives iff it equals the target's output at
        position i and every earlier draft survived; an accepted eos ends the
        window at that token; nothing commits past the budget (0 for an
        inactive slot, which writes only to the sink page). Acceptance runs
        on the device; the host reads the outputs and counts once."""
        del active  # every slot runs; inactive ones ride budget 0
        W = int(np.asarray(tokens).shape[1])
        self._log_shape("serving_verify", (W, self.num_slots))
        toks = self._to_device(tokens)
        tbl = self._to_device(tables, np.int32)
        lens = self._to_device(lengths, np.int32)
        eos_t = self._to_device(eos)[:, None]
        # a draft outside the vocabulary (a draft model with a larger one) is
        # looked up clamped; it never equals an output, so it is never accepted
        logits, win_k, win_v = gpt_mod.paged_verify_step(
            self.cfg, self.params, toks.clamp(0, self.cfg.vocab_size - 1), self.paged_cache,
            tbl, lens, impl=self.serving.kernel_impl)
        outs = logits.argmax(-1)                                    # [S, W]
        agree = (toks[:, 1:] == outs[:, :-1]).long()
        n = 1 + agree.cumprod(dim=1).sum(dim=1)
        is_eos = (outs == eos_t) & (eos_t >= 0)
        eos_pos = is_eos.long().argmax(dim=1)                       # the first eos
        n = torch.where(is_eos.any(dim=1), torch.minimum(n, eos_pos + 1), n)
        n = torch.minimum(n, self._to_device(budget).clamp(min=0)).clamp(min=0)
        gpt_mod.commit_window_kv(self.paged_cache, win_k, win_v, tbl, lens, n)
        host = torch.cat([outs, n[:, None]], dim=1).to(torch.int32).cpu().numpy()
        return host[:, :W], host[:, W]

    def warmup(self) -> int:
        """Run every program shape once before traffic arrives: the fused
        prefill per chunk bucket (and the admission-batch one), the chunked
        long-prompt path when configured, each decode block size and each
        verify window of the spec ladder (zero budget: nothing commits).
        Every write lands on the reserved sink page (all-zero tables, zero
        lengths), so live state is safe. Returns the number of shapes seen."""
        s = self.serving
        sink_row = np.zeros(s.pages_per_seq, np.int32)
        for chunk in self._chunk_buckets:
            t = np.zeros(min(chunk, s.prefill_chunk, s.max_model_len), np.int32)
            self.prefill(0, t, sink_row)
            if self.num_slots >= 2:
                self.prefill_many([(0, t, sink_row), (1, t, sink_row)])
        if s.max_model_len > s.prefill_chunk:
            # each bucket a legal remainder of a long prompt can land on
            max_rem = s.max_model_len - s.prefill_chunk
            prev = 0
            for b in self._chunk_buckets:
                if max_rem > prev:
                    self.prefill(0, np.zeros(s.prefill_chunk + min(b, max_rem), np.int32),
                                 sink_row)
                prev = b
        zeros = np.zeros(self.num_slots, np.int32)
        tables = np.zeros((self.num_slots, s.pages_per_seq), np.int32)
        mask = np.zeros(self.num_slots, bool)
        k = 1
        self.decode(zeros, tables, zeros, mask, steps=1)
        while k * 2 <= s.decode_block:  # the scheduler's power-of-two blocks
            k *= 2
            self.decode(zeros, tables, zeros, mask, steps=k)
        for k in s.spec_k_set:
            self.verify(np.zeros((self.num_slots, k + 1), np.int32), tables, zeros, mask,
                        np.full(self.num_slots, -1, np.int32), zeros)
        return len(self.compile_log)

    # -------------------------------------------------------------- assembly
    def make_scheduler(self, clock=time.monotonic,
                       recovery_log=None) -> ContinuousBatchingScheduler:
        """The scheduler over this engine, sized by its config."""
        if recovery_log is not None:
            raise unported("make_scheduler(recovery_log=...) (the serving recovery trail)",
                           "A11")
        s = self.serving
        sched = ContinuousBatchingScheduler(
            executor=self, num_slots=self.num_slots, num_pages=self.num_pages,
            page_size=s.page_size, pages_per_seq=s.pages_per_seq,
            decode_block=s.decode_block, max_context=s.max_model_len, clock=clock,
            drafter=make_drafter(self, s), spec_k=s.spec_k, spec_adaptive=s.spec_adaptive)
        self.last_scheduler = sched
        return sched

    def hbm_token_slots(self) -> int:
        """Token capacity of the pool (page 0 excluded)."""
        return (self.num_pages - 1) * self.serving.page_size

    def kv_bytes_per_token(self) -> float:
        """Device bytes one cached token costs in this config's pools
        (payload + amortized per-page scales)."""
        s = self.serving
        return gpt_mod.paged_kv_bytes_per_token(self.cfg, s.kv_bits, s.page_size, self.dtype)
