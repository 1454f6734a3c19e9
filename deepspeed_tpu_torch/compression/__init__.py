"""Compression in training (counterpart of ``deepspeed_tpu/compression``):
MoQ quantization-aware training with annealed bits, pruning, layer
reduction and post-training weight quantization."""

from .compress import (  # noqa: F401
    CompressionScheduler,
    init_compression,
    layer_reduction_map,
    quantize_params_for_inference,
    redundancy_clean,
)
from .config import get_compression_config  # noqa: F401
