"""Blocksparse attention layout builders (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``; the port's own
copy, pure numpy).

Each config maps a sequence length to a **block-level layout**
``[num_heads, T/block, T/block]`` of int64 0/1 entries, bit for bit the
reference's: ``SparsityConfig`` (the base), ``Dense``, ``Fixed`` (Sparse
Transformers' fixed pattern), ``Variable``, ``BigBird`` (window + global +
seeded random), ``BSLongformer`` (window + global) and ``LocalSlidingWindow``.
Only the active blocks are computed by the blocksparse kernels
(:mod:`deepspeed_tpu_torch.ops.cuda.blocksparse_attention`), which are
built for blocks of 16, 32, 64 and 128; the plain version takes any block.
The default ``block=128`` is the reference's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base. Parity: ``sparsity_config.py:9``."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} must be a multiple of block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=np.int64)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def _check_attention(attention: str) -> str:
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention type {attention!r}")
        return attention

    def _global_cols_mask(self, n: int, global_block_indices,
                          global_block_end_indices) -> np.ndarray:
        """Boolean column mask from explicit global block indices (optionally
        start/end ranges)."""
        cols = np.zeros(n, dtype=bool)
        if global_block_end_indices is None:
            for i in global_block_indices:
                if 0 <= i < n:
                    cols[i] = True
        else:
            for s, e in zip(global_block_indices, global_block_end_indices):
                cols[max(0, s):min(e, n)] = True
        return cols

    def _finalize(self, layout: np.ndarray, causal: bool) -> np.ndarray:
        if causal:
            n = layout.shape[1]
            tril = np.tril(np.ones((n, n), dtype=np.int64))
            layout = layout * tril
        # every query block must see at least its own diagonal block, or its
        # softmax rows would be empty
        idx = np.arange(layout.shape[1])
        layout[:, idx, idx] = 1
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks active. Parity: ``sparsity_config.py:94``."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers 'fixed' pattern. Parity: ``sparsity_config.py:243``.

    Queries attend within their local window of ``num_local_blocks`` blocks, plus
    to the trailing ``num_global_blocks`` blocks of every preceding window (the
    'summary' columns). ``num_different_global_patterns`` rotates which slice of
    the window acts as the summary across heads (requires
    ``different_layout_per_head``).
    """

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must divide by num_global_blocks")
        attention = self._check_attention(attention)
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "num_different_global_patterns > 1 requires different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError("too many global patterns for the window size")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        L, G = self.num_local_blocks, self.num_global_blocks
        causal = self.attention == "unidirectional"
        for h in range(self.num_heads):
            pattern = (h % self.num_different_global_patterns
                       if self.different_layout_per_head else 0)
            # global columns sit at the (last - pattern*G) slice of each window
            first = L - (pattern + 1) * G
            for i in range(n):
                w0 = (i // L) * L
                # local window
                layout[h, i, w0:min(w0 + L, n)] = 1
                # global columns of every window
                for w in range(0, n, L):
                    g0 = w + first
                    layout[h, i, g0:min(g0 + G, n)] = 1
                if self.horizontal_global_attention and (i - w0) >= first \
                        and (i - w0) < first + G:
                    layout[h, i, :] = 1  # global row
        return self._finalize(layout, causal)


class VariableSparsityConfig(SparsityConfig):
    """Variable local windows + explicit global blocks + random blocks.
    Parity: ``sparsity_config.py:421``."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        attention = self._check_attention(attention)
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed
        if self.global_block_end_indices is not None and \
                len(self.global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global start/end index lists must have equal length")

    def _global_cols(self, n: int) -> np.ndarray:
        return self._global_cols_mask(
            n, self.global_block_indices, self.global_block_end_indices)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        causal = self.attention == "unidirectional"
        rng = np.random.default_rng(self.seed)
        gcols = self._global_cols(n)
        for h in range(self.num_heads):
            # variable local windows: consecutive windows take sizes from the
            # list; the last size repeats
            i = 0
            wi = 0
            while i < n:
                size = self.local_window_blocks[min(wi, len(self.local_window_blocks) - 1)]
                hi = min(i + size, n)
                layout[h, i:hi, i:hi] = 1
                i = hi
                wi += 1
            layout[h, :, gcols] = 1
            if self.horizontal_global_attention:
                layout[h, gcols, :] = 1
            for _ in range(self.num_random_blocks):
                cols = rng.integers(0, n, size=n)
                layout[h, np.arange(n), cols] = 1
            if not self.different_layout_per_head:
                layout[1:] = layout[0]
                break
        return self._finalize(layout, causal)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: sliding window + global first/last + random. Parity:
    ``sparsity_config.py:559``."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = self._check_attention(attention)
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        causal = self.attention == "unidirectional"
        w = self.num_sliding_window_blocks // 2
        G = min(self.num_global_blocks, n)
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads):
            for i in range(n):
                layout[h, i, max(0, i - w):min(n, i + w + 1)] = 1  # window
            layout[h, :, :G] = 1  # global cols (first blocks)
            layout[h, :G, :] = 1  # global rows
            if not causal:
                layout[h, :, n - G:] = 1
                layout[h, n - G:, :] = 1
            for i in range(n):
                lo, hi = (0, max(1, i - w)) if causal else (0, n)
                k = min(self.num_random_blocks, hi - lo)
                if k > 0:
                    cols = rng.choice(np.arange(lo, hi), size=k, replace=False)
                    layout[h, i, cols] = 1
            if not self.different_layout_per_head:
                layout[1:] = layout[0]
                break
        return self._finalize(layout, causal)


class BSLongformerSparsityConfig(SparsityConfig):
    """Blocksparse Longformer: sliding window + designated global blocks.
    Parity: ``sparsity_config.py:686``."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = self._check_attention(attention)
        if self.global_block_end_indices is not None and \
                len(self.global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global start/end index lists must have equal length")

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        causal = self.attention == "unidirectional"
        w = self.num_sliding_window_blocks // 2
        gcols = self._global_cols_mask(
            n, self.global_block_indices, self.global_block_end_indices)
        for h in range(self.num_heads):
            for i in range(n):
                layout[h, i, max(0, i - w):min(n, i + w + 1)] = 1
            layout[h, :, gcols] = 1
            layout[h, gcols, :] = 1
        return self._finalize(layout, causal)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding window (the reference's sliding-window structure)."""

    def __init__(self, num_heads: int, block: int = 128,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = self._check_attention(attention)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        causal = self.attention == "unidirectional"
        w = self.num_sliding_window_blocks // 2 if not causal \
            else self.num_sliding_window_blocks - 1
        for i in range(n):
            lo = max(0, i - w)
            hi = i + 1 if causal else min(n, i + w + 1)
            layout[:, i, lo:hi] = 1
        return self._finalize(layout, causal)
