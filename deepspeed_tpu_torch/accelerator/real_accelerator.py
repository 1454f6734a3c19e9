"""Accelerator selection (counterpart of
``deepspeed_tpu/accelerator/real_accelerator.py``).

The port runs on the CUDA card unless the caller asks for the CPU: ``device``
is ``None`` (meaning ``"cuda"``), ``"cuda"``, ``"cuda:N"`` or ``"cpu"``. A CUDA
request on a machine without a CUDA device raises; nothing falls back to the
CPU quietly.
"""

from __future__ import annotations

from typing import Union

import torch

from .abstract_accelerator import Accelerator

DeviceLike = Union[None, str, torch.device]


class CUDAAccelerator(Accelerator):
    _name = "cuda"

    def platform(self) -> str:
        return "cuda"

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def current_device(self) -> torch.device:
        return torch.device("cuda", torch.cuda.current_device())

    def synchronize(self) -> None:
        torch.cuda.synchronize()


class CPUAccelerator(Accelerator):
    _name = "cpu"

    def platform(self) -> str:
        return "cpu"

    def is_available(self) -> bool:
        return True

    def device_count(self) -> int:
        return 1

    def preferred_dtype(self) -> torch.dtype:
        return torch.float32


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises when a CUDA device is asked for and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch path "
                "on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected 'cuda' or 'cpu')")
    return dev


def get_accelerator(device: DeviceLike = None) -> Accelerator:
    """The CUDA accelerator, or the CPU one only when ``device`` asks for it."""
    if resolve_device(device).type == "cuda":
        return CUDAAccelerator()
    return CPUAccelerator()
