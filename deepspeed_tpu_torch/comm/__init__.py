"""Collectives (counterpart of ``deepspeed_tpu/comm``): the facade over
``torch.distributed`` (NCCL, or gloo with CUDA tensors staged through host
memory), the quantized wire (the stage-3 gathers, the ZeRO++ gradient
exchange ``grad_bucket_reduce``) and its byte ledger. The trace-side
accounting (``profile_collectives``, ``verify_comms``) is ROADMAP.md A9c."""

from .comm import (
    CommsLogger,
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    comms_logger,
    configure,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    reduce_scatter,
)
from .quantized import (
    QuantizedCommConfig,
    dequantize_blockwise,
    grad_bucket_reduce,
    qall_gather,
    qall_to_all,
    qreduce_scatter,
    quantize_blockwise,
    quantized_reshard,
)
from .runtime_accounting import WireLedger, wire_ledger

__all__ = [
    "CommsLogger",
    "WireLedger",
    "wire_ledger",
    "QuantizedCommConfig",
    "quantize_blockwise",
    "dequantize_blockwise",
    "qall_gather",
    "qreduce_scatter",
    "qall_to_all",
    "grad_bucket_reduce",
    "quantized_reshard",
    "comms_logger",
    "configure",
    "init_distributed",
    "is_initialized",
    "get_world_size",
    "get_rank",
    "get_local_rank",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "all_to_all",
    "broadcast",
    "barrier",
]
