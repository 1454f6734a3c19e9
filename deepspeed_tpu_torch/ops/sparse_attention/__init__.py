"""Blocksparse attention (counterpart of ``deepspeed_tpu/ops/sparse_attention``):
layout builders, the sparse self-attention module and the grafting utilities."""

from .sparsity_config import (  # noqa: F401
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    LocalSlidingWindowSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)
from .sparse_self_attention import SparseSelfAttention, sparse_attention  # noqa: F401
from .sparse_attention_utils import (  # noqa: F401
    extend_position_embedding,
    pad_to_block_size,
    replace_self_attention_with_sparse,
    unpad_sequence_output,
)
