"""Speculative-decoding drafters (counterpart of
``deepspeed_tpu/inference/serving/speculate.py``).

A verify pass scores k + 1 window positions in one call
(``models/gpt.paged_verify_step``), reading every weight matrix once where
k + 1 decode steps read it k + 1 times; if a cheap drafter guesses the next
greedy tokens, the accepted guesses cost little. This module is the host
half of that bet:

- :class:`NGramDrafter`: self-drafting by suffix match over the request's own
  prompt and generated tokens; no device work.
- :class:`DraftModelDrafter`: a small GPT proposing k greedy tokens from its
  own contiguous KV cache, outside the target's page pool; rejected drafts
  roll back by rewinding the cache position.

Both sit behind the :class:`Drafter` protocol the scheduler consumes. Drafters
propose and the target decides: acceptance is longest-prefix greedy agreement
computed on the device in the verify call, so a wrong draft never changes an
output, it only wastes window positions, which :class:`AdaptiveSpecK` bounds
by shrinking k when the accept rate is low.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models import gpt as gpt_mod
from .buckets import default_buckets


class Drafter(Protocol):
    """The scheduler-facing drafter protocol (host level; a drafter may own
    device state, the scheduler never sees it)."""

    kind: str

    def draft(self, slot: int, rid: int, prompt: np.ndarray,
              tokens: Sequence[int], k: int) -> np.ndarray:
        """Up to ``k`` proposed next tokens for the request in ``slot`` whose
        verified context is ``prompt + tokens``. Fewer (or none) are fine:
        unfilled window positions are padded and fail verification."""
        ...

    def release(self, slot: int) -> None:
        """The slot was finished, preempted or evicted: drop its state."""
        ...


def spec_k_ladder(max_k: int) -> Tuple[int, ...]:
    """The bounded draft-length set: powers of two up to ``max_k``, so the
    verify windows W = k + 1 are 2, 3, 5, 9, 17."""
    if max_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {max_k}")
    out = []
    k = 1
    while k <= max_k:
        out.append(k)
        k *= 2
    return tuple(out)


class AdaptiveSpecK:
    """Accept-rate-driven draft length: k steps down the ladder while drafts
    stop being accepted and back up when they land. EMA-smoothed; the EMA
    resets at every level change so a stale regime cannot echo."""

    def __init__(self, ladder: Sequence[int], adaptive: bool = True,
                 low: float = 0.35, high: float = 0.75, decay: float = 0.8):
        if not ladder:
            raise ValueError("empty spec-k ladder")
        self.ladder = tuple(int(k) for k in ladder)
        self.adaptive = bool(adaptive)
        self.low = float(low)
        self.high = float(high)
        self.decay = float(decay)
        self.level = len(self.ladder) - 1   # start optimistic, back off fast
        self.ema: Optional[float] = None

    @property
    def k(self) -> int:
        return self.ladder[self.level]

    def observe(self, offered: int, accepted: int) -> None:
        """One verify window's outcome: ``offered`` draft positions, of which
        ``accepted`` were confirmed."""
        rate = accepted / max(offered, 1)
        self.ema = (rate if self.ema is None
                    else self.decay * self.ema + (1.0 - self.decay) * rate)
        if not self.adaptive or len(self.ladder) == 1:
            return
        if self.ema < self.low and self.level > 0:
            self.level -= 1
            self.ema = None
        elif self.ema > self.high and self.level < len(self.ladder) - 1:
            self.level += 1
            self.ema = None


# ------------------------------------------------------------------- n-gram
class NGramDrafter:
    """Suffix-match self-drafting (prompt-lookup decoding): find the most
    recent earlier occurrence of the context's trailing n-gram and propose
    the tokens that followed it. Tries the longest order first (``max_n`` ..
    ``min_n``); among matches prefers the most recent one with a full ``k``
    tokens of continuation, else the most recent match's shorter tail."""

    kind = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not (1 <= min_n <= max_n):
            raise ValueError(f"bad n-gram order range [{min_n}, {max_n}]")
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def draft(self, slot: int, rid: int, prompt: np.ndarray,
              tokens: Sequence[int], k: int) -> np.ndarray:
        del slot, rid
        ctx = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(list(tokens), np.int64)])
        L = len(ctx)
        if k < 1 or L < 2:
            return np.empty(0, np.int32)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            pat = ctx[L - n:]
            # window s holds ctx[s:s+n], a match ending at j = s + n; j == L
            # is the query suffix itself, excluded
            wins = np.lib.stride_tricks.sliding_window_view(ctx, n)[:L - n]
            hit = np.flatnonzero((wins == pat).all(axis=1))
            if hit.size == 0:
                continue
            js = hit + n
            full = js[js + k <= L]
            j = int(full[-1]) if full.size else int(js[-1])
            return ctx[j:min(j + k, L)].astype(np.int32)
        return np.empty(0, np.int32)

    def release(self, slot: int) -> None:
        pass


# -------------------------------------------------------------- draft model
class DraftModelDrafter:
    """A small GPT proposing ``k`` greedy tokens from its own contiguous KV
    cache (``models.gpt.init_cache``, one per slot).

    Per slot: the cache and the exact token list it has consumed. On every
    call the verified context is diffed against that list: accepted drafts
    are already cached (their K/V was written when they were proposed), and
    rejected ones are rewound by truncating the list and setting
    ``cache["pos"]``; ``attn_with_cache`` masks by position, so entries past
    ``pos`` are never read and are overwritten in place. The context delta is
    then fed in exact power-of-two pieces up to ``max_chunk`` (the
    persistent cache cannot absorb padding), and ``k - 1`` single-token
    steps (``forward_with_cache``, the B3 decode kernel on CUDA) propose the
    rest of the window. The drafts stay on the device until the window is
    complete: one host read per call.

    PyTorch runs eagerly: ``log_shape`` (the serving engine's ``_log_shape``)
    records the first ``draft_feed`` / ``draft_step`` dispatch of each shape,
    where the reference logs its compiles."""

    kind = "draft_model"

    def __init__(self, cfg, params, max_len: int, dtype: torch.dtype = torch.float32,
                 max_chunk: int = 64, log_shape: Optional[Callable[[str, tuple], None]] = None,
                 device=None):
        self.cfg = cfg
        self.max_len = int(max_len)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params = gpt_mod.cast_params(params, self.device, dtype)
        self._buckets = default_buckets(1, max(int(max_chunk), 1))
        self._slots: Dict[int, Dict[str, Any]] = {}
        self._log_shape = log_shape or (lambda kind, shape: None)

    def _forward(self, ids: torch.Tensor, cache: Dict[str, Any], kind: str):
        self._log_shape(kind, tuple(ids.shape))
        # a context token outside a smaller draft vocabulary is fed clamped:
        # it changes the drafts, never an output
        ids = ids.clamp(max=self.cfg.vocab_size - 1)
        logits, cache = gpt_mod.forward_with_cache(self.cfg, self.params, ids, cache)
        return logits[0, -1].argmax(), cache

    @torch.no_grad()
    def draft(self, slot: int, rid: int, prompt: np.ndarray,
              tokens: Sequence[int], k: int) -> np.ndarray:
        ctx = [int(t) for t in np.asarray(prompt).tolist()] + [int(t) for t in tokens]
        if k < 1 or len(ctx) + k > self.max_len:
            return np.empty(0, np.int32)   # the window would outgrow the cache
        st = self._slots.get(slot)
        if st is None or st["rid"] != rid:
            st = {"rid": rid, "fed": [],
                  "cache": gpt_mod.init_cache(self.cfg, 1, self.max_len, self.dtype,
                                              self.device)}
            self._slots[slot] = st
        fed: List[int] = st["fed"]
        p = 0
        limit = min(len(fed), len(ctx) - 1)   # re-feed at least one token, for
        while p < limit and fed[p] == ctx[p]:  # fresh logits
            p += 1
        cache = st["cache"]
        if p < len(fed):
            fed = fed[:p]   # rejected drafts or a preemption replay: rewind
            cache["pos"] = p
        delta = ctx[p:]
        while delta:
            piece = max(b for b in self._buckets if b <= len(delta))
            ids = torch.tensor([delta[:piece]], dtype=torch.long, device=self.device)
            nxt, cache = self._forward(ids, cache, "draft_feed")
            delta = delta[piece:]
        drafts = [nxt]
        for _ in range(k - 1):
            nxt, cache = self._forward(nxt.view(1, 1), cache, "draft_step")
            drafts.append(nxt)
        out = torch.stack(drafts).to(torch.int32).cpu().numpy()
        # the k-th draft was never fed: its K/V is not in the cache
        st["fed"] = fed + ctx[p:] + out[:-1].tolist()
        st["cache"] = cache
        return out

    def release(self, slot: int) -> None:
        self._slots.pop(slot, None)


def make_drafter(engine, serving) -> Optional[Drafter]:
    """The configured drafter for a :class:`~.engine.ServingEngine`
    (``ServingConfig.spec_drafter``: None | "ngram" | "draft_model").

    ``"draft_model"`` takes ``ServingEngine(draft=(cfg, params))``, or else
    builds the ``spec_draft_model`` preset with :func:`models.gpt.init_params`
    at seed 0. Those weights differ from the JAX package's seed-0 init (the
    two random streams differ); a draft never changes an output, only the
    accept rate, and tests that compare with the reference pass explicit
    draft params through ``bridge``."""
    kind = serving.spec_drafter
    if not kind:
        return None
    if kind == "ngram":
        return NGramDrafter(max_n=serving.spec_ngram)
    if kind == "draft_model":
        draft = engine.draft
        if draft is None:
            if not serving.spec_draft_model:
                raise ValueError(
                    "spec_drafter='draft_model' needs either ServingEngine(draft=(cfg, "
                    "params)) or ServingConfig.spec_draft_model (a PRESETS name; seed-0 "
                    "init -- pass real params for real acceptance)")
            dcfg = gpt_mod.PRESETS[serving.spec_draft_model]
            draft = (dcfg, gpt_mod.init_params(dcfg, 0, device=engine.device))
        dcfg, dparams = draft
        return DraftModelDrafter(dcfg, dparams, max_len=serving.max_model_len,
                                 dtype=engine.dtype, max_chunk=serving.prefill_chunk,
                                 log_shape=engine._log_shape, device=engine.device)
    raise ValueError(f"unknown spec_drafter {kind!r} (None | 'ngram' | 'draft_model')")


__all__ = ["Drafter", "NGramDrafter", "DraftModelDrafter", "AdaptiveSpecK",
           "spec_k_ladder", "make_drafter"]
