"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``).

``InferenceEngine`` casts the model's parameters to the configured dtype on
its device and runs KV-cache generation: one prefill over the prompt, then
one cached forward per new token, each reaching the decode-attention kernel
on CUDA. The reference compiles the whole loop into one program; here it runs
eagerly, as a Python loop, until CUDA-graph capture is ported (ROADMAP.md
A5b). Greedy decoding only: sampling and beam search raise (A5b).

With ``quant.enabled`` (or a tree that arrives quantized) the layer stacks
hold int8 or packed int4 weights with fp32 group scales, and every
projection of a decode step runs the int8 / int4 weight kernels.
"""

from __future__ import annotations

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
        """Greedy autoregressive generation with a KV cache; returns the prompt
        followed by the new tokens, [B, T + max_new_tokens] int32.

        Rows that emit ``eos_token_id`` freeze (repeat their last token);
        ``repetition_penalty`` shrinks the logits of tokens already seen. The
        sampling knobs and ``num_beams > 1`` are not ported and raise; ``seed``
        is accepted for the reference's signature and unused by greedy decoding."""
        if temperature != 0.0 or top_k or top_p:
            raise unported("sampled generation (temperature / top_k / top_p)", "A5b")
        if num_beams > 1:
            raise unported("beam search (num_beams > 1)", "A5b")
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
        # cache length padded to a 128-multiple, as the reference sizes it;
        # the validity mask makes the padding inert
        total = -(-(T + max_new) // 128) * 128
        rows = torch.arange(B, device=self.device)

        def penalize(logits, seen):
            # CTRL-style repetition penalty: seen tokens' logits shrink
            # toward improbability (divide if positive, multiply if negative)
            if repetition_penalty == 1.0:
                return logits
            p = repetition_penalty
            pen = torch.where(logits > 0, logits / p, logits * p)
            return torch.where(seen, pen, logits)

        cache = self.model.init_cache(B, total, self.dtype, self.device)
        logits, cache = self.model.prefill(self.params, ids, cache)
        seen = torch.zeros((B, logits.shape[-1]), dtype=torch.bool, device=self.device)
        if repetition_penalty != 1.0:
            seen[rows[:, None], ids] = True
        tok = penalize(logits[:, -1, :], seen).argmax(dim=-1)
        seen[rows, tok] = True
        done = tok == eos
        out = [tok]
        for _ in range(max_new - 1):
            logits, cache = self.model.prefill(self.params, tok[:, None], cache)
            nxt = penalize(logits[:, -1, :], seen).argmax(dim=-1)
            nxt = torch.where(done, tok, nxt)  # freeze finished rows
            seen[rows, nxt] = True
            done = done | (nxt == eos)
            out.append(nxt)
            tok = nxt
        gen = torch.stack(out, dim=1)[:, :requested]  # bucket padding: slice back
        return torch.cat([ids, gen], dim=1).cpu().numpy().astype(np.int32)


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
