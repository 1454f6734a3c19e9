"""Sparse self-attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

Computes softmax(q k^T * scale + mask) v restricted to a
:class:`~.sparsity_config.SparsityConfig` block layout, through the
blocksparse kernels (:func:`deepspeed_tpu_torch.ops.cuda.blocksparse_attention.
blocksparse_attention`, B9) on a CUDA device and their plain versions on the
CPU.

Layouts are cached per (config, sequence length), and the kernels' index
tables per (config, sequence length, device), on the device: an eager model
calls the functional :func:`sparse_attention` once per layer per step, and
building the tables at each call would cost a host loop over the layout and
four host-to-device copies in every layer of every step. The reference
builds them once per trace.
"""

from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..cuda.blocksparse_attention import Tables, blocksparse_attention, device_tables
from .sparsity_config import FixedSparsityConfig, SparsityConfig

# config -> {seq_len: layout, (seq_len, device): tables}; an entry goes with its config
_CACHE: "weakref.WeakKeyDictionary[SparsityConfig, dict]" = weakref.WeakKeyDictionary()


def _layout(config: SparsityConfig, seq_len: int) -> np.ndarray:
    cache = _CACHE.setdefault(config, {})
    if seq_len not in cache:
        cache[seq_len] = config.make_layout(seq_len)
    return cache[seq_len]


def _tables(config: SparsityConfig, seq_len: int, device: torch.device) -> Tables:
    cache = _CACHE.setdefault(config, {})
    key = (seq_len, str(device))
    if key not in cache:
        cache[key] = device_tables(_layout(config, seq_len), config.block, device)
    return cache[key]


def _causal(config: SparsityConfig, causal: Optional[bool]) -> bool:
    if causal is not None:
        return causal
    return getattr(config, "attention", "bidirectional") == "unidirectional"


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     config: SparsityConfig, causal: Optional[bool] = None,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Functional form on q/k/v [B, T, H, D]; ``causal`` defaults to the
    config's ``attention == "unidirectional"``. The layout and the device
    tables are built at the first call for a (config, T, device) and kept."""
    B, T, H, D = q.shape
    if H != config.num_heads:
        raise ValueError(
            f"q has {H} heads but the sparsity config declares {config.num_heads}")
    return blocksparse_attention(q, k, v, _layout(config, T), config.block,
                                 causal=_causal(config, causal), softmax_scale=softmax_scale,
                                 tables=_tables(config, T, q.device))


class SparseSelfAttention(nn.Module):
    """Holds a sparsity config (no parameters); ``forward(q, k, v)`` on
    [B, T, H, D] q/k/v."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 causal: Optional[bool] = None):
        super().__init__()
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        self.causal = _causal(self.sparsity_config, causal)

    def get_layout(self, seq_len: int) -> np.ndarray:
        return _layout(self.sparsity_config, seq_len)

    def density(self, seq_len: int) -> float:
        return float(self.get_layout(seq_len).mean())

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                softmax_scale: Optional[float] = None) -> torch.Tensor:
        return sparse_attention(q, k, v, self.sparsity_config, causal=self.causal,
                                softmax_scale=softmax_scale)
