"""The runtime's collectives (counterpart of ``deepspeed_tpu/runtime/comm``):
the 1-bit compressed allreduce of the 1-bit optimizers."""

from .compressed import compressed_allreduce, compression_error_shapes  # noqa: F401
