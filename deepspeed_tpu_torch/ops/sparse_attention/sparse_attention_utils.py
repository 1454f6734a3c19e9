"""Grafting utilities (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``).

Models here are (config, params) pairs, so grafting is a config transform
(:func:`replace_self_attention_with_sparse`) plus a parameter transform
(:func:`extend_position_embedding`, which tiles the learned position table
to a longer sequence); :func:`pad_to_block_size` and
:func:`unpad_sequence_output` bring a sequence to a multiple of the block
and back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...utils.logging import log_dist
from .sparsity_config import SparsityConfig

_POSITION_KEYS = ("wpe",)  # learned-position tables across model families


def replace_self_attention_with_sparse(cfg, sparsity_config: SparsityConfig):
    """Return a config whose every attention layer runs the blocksparse
    kernels; any model config with a ``sparse_attention`` field."""
    if not hasattr(cfg, "sparse_attention"):
        raise TypeError(
            f"{type(cfg).__name__} has no sparse_attention field — model "
            f"family not graftable")
    if sparsity_config.num_heads != cfg.n_head:
        raise ValueError(
            f"sparsity config declares {sparsity_config.num_heads} heads, "
            f"model has {cfg.n_head}")
    new = dataclasses.replace(cfg, sparse_attention=sparsity_config)
    log_dist(f"grafted {type(sparsity_config).__name__} onto "
             f"{type(cfg).__name__} ({cfg.n_layer} layers)")
    return new


def extend_position_embedding(params: Dict[str, Any], new_max_seq: int,
                              key: Optional[str] = None) -> Dict[str, Any]:
    """Stretch a learned position table to ``new_max_seq`` rows by tiling the
    original rows (the trained table is replicated, not re-initialized).
    Returns a new params dict with the table on its device and in its dtype;
    pair with ``dataclasses.replace(cfg, max_seq_len=...)``."""
    if key is None:
        key = next((k for k in _POSITION_KEYS if k in params), None)
        if key is None:
            raise ValueError(
                f"no learned position table among {_POSITION_KEYS} — rotary/"
                f"ALiBi models extend for free (no table to stretch)")
    table = torch.as_tensor(params[key])
    old = table.shape[0]
    if new_max_seq <= old:
        raise ValueError(f"new_max_seq {new_max_seq} <= current {old}")
    reps = -(-new_max_seq // old)  # ceil
    out = dict(params)
    out[key] = table.repeat(reps, 1)[:new_max_seq].clone()
    log_dist(f"extended position embedding {old} -> {new_max_seq} "
             f"(tiled x{reps})")
    return out


def pad_to_block_size(input_ids: torch.Tensor, block: int, pad_token_id: int = 0,
                      attention_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """Right-pad ``[B, T]`` token ids (and mask) so T is a multiple of the
    block. Returns (ids, mask, pad_len)."""
    input_ids = torch.as_tensor(input_ids)
    pad = (-input_ids.shape[-1]) % block
    if pad == 0:
        return input_ids, attention_mask, 0
    ids = F.pad(input_ids, (0, pad), value=pad_token_id)
    mask = None
    if attention_mask is not None:
        mask = F.pad(torch.as_tensor(attention_mask), (0, pad), value=0)
    return ids, mask, pad


def unpad_sequence_output(output: torch.Tensor, pad_len: int) -> torch.Tensor:
    """Drop the rows ``pad_to_block_size`` appended ([B, T+pad, ...] -> [B, T, ...])."""
    if pad_len == 0:
        return output
    return output[:, :-pad_len]
