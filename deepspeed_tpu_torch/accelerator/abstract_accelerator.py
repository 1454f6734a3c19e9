"""Accelerator abstraction (counterpart of
``deepspeed_tpu/accelerator/abstract_accelerator.py``).

One seam through which the port's device queries go: which device, how many,
synchronisation and the preferred compute dtype.
"""

from __future__ import annotations

import abc

import torch


class Accelerator(abc.ABC):
    """Platform abstraction: device enumeration, synchronisation, dtypes."""

    _name: str = "abstract"

    @property
    def name(self) -> str:
        return self._name

    @abc.abstractmethod
    def platform(self) -> str:
        """PyTorch device type: 'cuda' | 'cpu'."""

    @abc.abstractmethod
    def is_available(self) -> bool:
        ...

    @abc.abstractmethod
    def device_count(self) -> int:
        ...

    def current_device(self) -> torch.device:
        return torch.device(self.platform())

    def synchronize(self) -> None:
        """Block until queued device work has finished."""

    def preferred_dtype(self) -> torch.dtype:
        return torch.bfloat16
