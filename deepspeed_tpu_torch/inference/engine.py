"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``).

``InferenceEngine`` casts the model's parameters to the configured dtype on
its device and runs KV-cache generation: one prefill over the prompt, then
one cached forward per new token, each reaching the decode-attention kernel
on CUDA (a model with an attention bias, ALiBi or a local window, decodes on
the plain masked path). Decoding is greedy, sampled (temperature, top-k,
nucleus) or a beam search. The reference compiles the whole loop into one
program; here it runs eagerly, as a Python loop, until CUDA-graph capture is
ported (ROADMAP.md A5b).

With ``quant.enabled`` (or a tree that arrives quantized) the layer stacks
hold int8 or packed int4 weights with fp32 group scales, and every
projection of a decode step runs the int8 / int4 weight kernels.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..models import gpt as gpt_mod
from ..utils.errors import unported
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig
from .serving.buckets import bucket_for


class InferenceEngine:
    """Autoregressive inference on one device.

    ``model`` is an adapter object exposing:
      - ``params``: parameter dict (any float dtype; converted per config)
      - ``prefill(params, input_ids, cache) -> (logits, cache)``
      - ``init_cache(batch, max_len, dtype, device) -> cache``
    Use :func:`for_gpt` to wrap a GPT config + params.
    """

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 device=None):
        self.config = config or DeepSpeedInferenceConfig()
        if self.config.tensor_parallel.tp_size > 1:
            raise unported("tensor-parallel inference (tp_size > 1)", "A10")
        if self.config.moe.ep_size > 1:
            raise unported("expert-parallel (MoE) inference", "A13")
        self.device = resolve_device(device)
        self.dtype = self.config.torch_dtype()
        self.model = model
        # the dtype cast passes quantized {"q"|"q4", "s"} leaves whole: int
        # payloads are not float-cast and the scales stay fp32
        params = gpt_mod.cast_params(model.params, self.device, self.dtype)
        # weight-only quantization (the reference's GroupQuantizer route): a
        # tree that arrives quantized (init_quantized_decode_params) is used
        # as it is; quant.enabled quantizes the layer stacks after the cast,
        # so bf16 weights quantize from their bf16 values
        quant = self.config.quant
        if gpt_mod.has_quantized_leaves(params):
            log_dist("inference engine: pre-quantized layer-stack weights")
        elif quant.enabled:
            if not hasattr(model, "quantize_params"):
                raise unported("quant.enabled for a model adapter without quantize_params "
                               "(compression.quantize_params_for_inference)", "A13")
            params = model.quantize_params(params, bits=quant.bits, group_size=quant.group_size)
            log_dist(f"inference engine: int{quant.bits} layer-stack weights "
                     f"(group {quant.group_size})")
        self.params = params
        log_dist(f"inference engine: dtype {self.dtype}, device {self.device}, "
                 f"max_out_tokens={self.config.max_out_tokens}")

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, device=self.device).long()

    @torch.no_grad()
    def forward(self, input_ids) -> torch.Tensor:
        """One full forward (prefill shapes); returns logits."""
        ids = self._ids(input_ids)
        B, T = ids.shape
        cache = self.model.init_cache(B, T, self.dtype, self.device)
        logits, _ = self.model.prefill(self.params, ids, cache)
        return logits

    __call__ = forward

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 num_beams: int = 1, repetition_penalty: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0) -> np.ndarray:
        """Autoregressive generation with a KV cache; returns the prompt
        followed by the new tokens, [B, T + max_new_tokens] int32.

        Greedy when ``temperature`` is 0, else a categorical draw from the
        logits :func:`filter_logits` leaves (``top_k``, nucleus ``top_p``),
        from a ``torch.Generator`` on the engine's device seeded with
        ``seed``, one draw a step. ``num_beams > 1`` runs deterministic beam
        search (:meth:`_beam_search`). Rows that emit ``eos_token_id`` freeze
        (repeat their last token); ``repetition_penalty`` shrinks the logits
        of tokens already seen."""
        ids = self._ids(input_ids)
        B, T = ids.shape
        if self.config.max_batch_size and B > self.config.max_batch_size:
            raise ValueError(
                f"batch {B} exceeds max_batch_size {self.config.max_batch_size} "
                f"(the workspace bound the engine was configured for)")
        max_new = self.config.max_out_tokens if max_new_tokens is None else max_new_tokens
        if max_new < self.config.min_out_tokens:
            raise ValueError(f"max_new_tokens {max_new} < min_out_tokens "
                             f"{self.config.min_out_tokens}")
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        requested = max_new
        if self.config.decode_buckets:
            max_new = bucket_for(max_new, self.config.decode_buckets)
        eos = -1 if eos_token_id is None else eos_token_id
        if num_beams > 1:
            if temperature != 0.0 or top_k or top_p or repetition_penalty != 1.0:
                raise ValueError("beam search is deterministic; sampling knobs cannot "
                                 "combine with num_beams > 1")
            gen = self._beam_search(ids, max_new, num_beams, eos)
        else:
            gen = self._sample_loop(ids, max_new, temperature, top_k, top_p,
                                    repetition_penalty, eos, seed)
        gen = gen[:, :requested]  # bucket padding: slice back
        return torch.cat([ids, gen], dim=1).cpu().numpy().astype(np.int32)

    def _cache_len(self, T: int, max_new: int) -> int:
        # padded to a 128-multiple, as the reference sizes it; the validity
        # mask makes the padding inert
        return -(-(T + max_new) // 128) * 128

    def _sample_loop(self, ids: torch.Tensor, max_new: int, temperature: float, top_k: int,
                     top_p: float, repetition_penalty: float, eos: int,
                     seed: int) -> torch.Tensor:
        """Greedy or sampled decoding: [B, max_new] new tokens."""
        B, T = ids.shape
        rows = torch.arange(B, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def penalize(logits, seen):
            # CTRL-style repetition penalty: seen tokens' logits shrink
            # toward improbability (divide if positive, multiply if negative)
            if repetition_penalty == 1.0:
                return logits
            p = repetition_penalty
            pen = torch.where(logits > 0, logits / p, logits * p)
            return torch.where(seen, pen, logits)

        def sample(logits):
            if temperature == 0.0:
                return logits.argmax(dim=-1)
            return categorical(filter_logits(logits, temperature, top_k, top_p), gen)

        cache = self.model.init_cache(B, self._cache_len(T, max_new), self.dtype, self.device)
        logits, cache = self.model.prefill(self.params, ids, cache)
        seen = torch.zeros((B, logits.shape[-1]), dtype=torch.bool, device=self.device)
        if repetition_penalty != 1.0:
            seen[rows[:, None], ids] = True
        tok = sample(penalize(logits[:, -1, :], seen))
        seen[rows, tok] = True
        done = tok == eos
        out = [tok]
        for _ in range(max_new - 1):
            logits, cache = self.model.prefill(self.params, tok[:, None], cache)
            nxt = sample(penalize(logits[:, -1, :], seen))
            nxt = torch.where(done, tok, nxt)  # freeze finished rows
            seen[rows, nxt] = True
            done = done | (nxt == eos)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1)

    def _beam_search(self, ids: torch.Tensor, max_new: int, K: int, eos: int) -> torch.Tensor:
        """Deterministic beam search: K beams per row share one [B*K]-row KV
        cache, whose rows follow their beams (``index_select`` on the batch
        axis) every step; finished beams continue on a zero-cost eos lane.
        Returns the highest-scoring beam per row, [B, max_new]."""
        B, T = ids.shape
        dev = self.device
        cache = self.model.init_cache(B * K, self._cache_len(T, max_new), self.dtype, dev)
        logits, cache = self.model.prefill(self.params, ids.repeat_interleave(K, dim=0), cache)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1).reshape(B, K, V)
        # the beams are identical after the prefill: the first step takes
        # the row's top K tokens
        scores, toks = top_k_stable(logp[:, 0, :], K)  # [B, K]
        done = toks == eos
        out = torch.zeros((B, K, max_new), dtype=torch.long, device=dev)
        out[:, :, 0] = toks
        eos_lane = torch.full((V,), -math.inf, device=dev)
        eos_lane[eos] = 0.0
        base = (torch.arange(B, device=dev) * K)[:, None]
        for t in range(1, max_new):
            logits, cache = self.model.prefill(self.params, toks.reshape(B * K, 1), cache)
            logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1).reshape(B, K, V)
            logp = torch.where(done[:, :, None], eos_lane, logp)
            scores, idx = top_k_stable((scores[:, :, None] + logp).reshape(B, K * V), K)
            src = idx // V  # the beam each winner extends
            toks = idx % V
            beam_rows = (base + src).reshape(-1)
            cache = {k: (v.index_select(1, beam_rows)
                         if torch.is_tensor(v) and v.dim() >= 2 and v.shape[1] == B * K else v)
                     for k, v in cache.items()}
            out = out.gather(1, src[:, :, None].expand(B, K, max_new))
            out[:, :, t] = toks
            done = done.gather(1, src) | (toks == eos)
        best = scores.argmax(dim=1)
        return out[torch.arange(B, device=dev), best]


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """The logits a sampled step draws from, in the reference's ``sample``:
    divided by ``temperature``; with ``top_k`` > 0, every logit below the
    k-th largest set to -inf (ties at it kept); with ``0 < top_p < 1``, the
    nucleus: every logit below the smallest one of the shortest sorted
    prefix whose exclusive cumulative probability stays below ``top_p``
    (which always holds the top token) set to -inf. The nucleus's
    probabilities are summed in fp32 whatever the logits' dtype."""
    logits = logits / temperature
    if top_k > 0:
        kth = logits.sort(dim=-1).values[..., -min(top_k, logits.shape[-1]), None]
        logits = torch.where(logits < kth, -math.inf, logits)
    if 0.0 < top_p < 1.0:
        desc = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(desc.float(), dim=-1)
        exclusive_cum = torch.cumsum(probs, dim=-1) - probs
        kept = torch.where(exclusive_cum >= top_p, math.inf, desc)
        thr = kept.min(dim=-1, keepdim=True).values
        logits = torch.where(logits < thr, -math.inf, logits)
    return logits


def categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(``logits``) by the Gumbel-max trick
    (the reference's ``jax.random.categorical``), its uniforms from ``gen``."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    return (logits.float() - torch.log(-torch.log(u))).argmax(dim=-1)


def top_k_stable(x: torch.Tensor, k: int):
    """The ``k`` largest entries of each row and their indices, ties in index
    order (as ``jax.lax.top_k`` breaks them)."""
    values, idx = x.sort(dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class _GPTInferenceAdapter:
    def __init__(self, cfg: gpt_mod.GPTConfig, params: Any):
        self.cfg = cfg
        self.params = params

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype, device):
        return gpt_mod.init_cache(self.cfg, batch, max_len, dtype, device)

    def prefill(self, params, input_ids, cache):
        return gpt_mod.forward_with_cache(self.cfg, params, input_ids, cache)

    def quantize_params(self, params, bits: int, group_size: int):
        return gpt_mod.quantize_for_inference(self.cfg, params, bits=bits,
                                              group_size=group_size)


def for_gpt(cfg: gpt_mod.GPTConfig, params: Any) -> _GPTInferenceAdapter:
    """Adapter: GPT config + params (a dict of tensors) -> InferenceEngine model."""
    gpt_mod.check_config(cfg)
    return _GPTInferenceAdapter(cfg, params)
