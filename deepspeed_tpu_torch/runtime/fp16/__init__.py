"""Reduced-precision optimizers (counterpart of ``deepspeed_tpu/runtime/fp16``):
the 1-bit optimizers' compressed stage."""

from .onebit import ONEBIT_TYPES, OnebitParams, OnebitRunner  # noqa: F401
