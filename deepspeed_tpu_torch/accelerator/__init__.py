from .abstract_accelerator import Accelerator
from .real_accelerator import (
    CPUAccelerator,
    CUDAAccelerator,
    get_accelerator,
    resolve_device,
)

__all__ = [
    "Accelerator",
    "CUDAAccelerator",
    "CPUAccelerator",
    "get_accelerator",
    "resolve_device",
]
