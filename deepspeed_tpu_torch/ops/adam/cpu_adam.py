"""The host SIMD Adam / AdamW and Adagrad of ZeRO-Offload (counterpart of
``deepspeed_tpu/ops/adam/cpu_adam.py``).

The step runs on the host CPU over flat fp32 numpy arrays, in place, in the
C++ of ``csrc/host/cpu_adam.cpp`` (AVX2 + FMA and OpenMP where the host has
them), loaded through ctypes by :func:`..._build.load_host`. ``bf16_out``
(a uint16 array of the same length, such as the numpy view of a pinned
``torch.bfloat16`` push buffer) receives the updated master rounded to bf16
in the same pass: round to nearest even, bitwise ``master.to(torch.bfloat16)``
for every finite value (an fp32 past bf16's largest finite rounds to an
infinity in both). A NaN master is not carried as torch carries it: the
rounding adds to the raw bits, so the quiet NaN 0x7fc00000 stays a NaN
(0x7fc0) while a NaN with the upper half of its payload all ones carries out
of it, 0x7fffffff into -0.0 (0x8000) and 0xffffffff into +0.0; torch gives a
NaN in every case. A NaN master means the step was already lost.

There is no fallback: a build or load failure raises
:class:`~.._build.KernelBuildError` with the compiler's output.
:func:`adam_step_numpy` and :func:`adagrad_step_numpy` are the same
arithmetic in numpy, the tests' reference.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from .. import _build

_F32 = ctypes.POINTER(ctypes.c_float)
_U16 = ctypes.POINTER(ctypes.c_uint16)


@functools.lru_cache(maxsize=None)
def cpu_ops() -> ctypes.CDLL:
    """The loaded host optimizer library, built at its first use."""
    lib = _build.load_host("cpu_adam")
    if lib.ds_cpu_ops_version() < 1:
        raise _build.KernelBuildError("cpu_adam: library version below 1")
    lib.ds_adam_step.restype = None
    lib.ds_adam_step.argtypes = [_F32, _F32, _F32, _F32, ctypes.c_int64, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                 ctypes.c_int, _U16]
    lib.ds_adagrad_step.restype = None
    lib.ds_adagrad_step.argtypes = [_F32, _F32, _F32, ctypes.c_int64, ctypes.c_float,
                                    ctypes.c_float, ctypes.c_float, _U16]
    return lib


def _f32(x: np.ndarray, n: Optional[int] = None):
    if x.dtype != np.float32 or not x.flags["C_CONTIGUOUS"] or not x.flags["WRITEABLE"]:
        raise ValueError("host optimizer arrays must be writable C-contiguous float32")
    if n is not None and x.size != n:
        raise ValueError(f"host optimizer arrays differ in size: {x.size} vs {n}")
    return x.ctypes.data_as(_F32)


def _out16(x: Optional[np.ndarray], n: int):
    if x is None:
        return ctypes.cast(None, _U16)
    if x.dtype != np.uint16 or not x.flags["C_CONTIGUOUS"] or x.size != n:
        raise ValueError("bf16_out must be a C-contiguous uint16 array of the master's size")
    return x.ctypes.data_as(_U16)


class DeepSpeedCPUAdam:
    """Fused host Adam / AdamW over flat fp32 arrays, in place; the offload
    runners drive one array per leaf."""

    def __init__(self, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, adamw_mode: bool = True,
                 bias_correction: bool = True):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self._lib = cpu_ops()  # raises here, not at the first step

    @property
    def simd(self) -> bool:
        """Whether the library was built with the AVX2 + FMA loop."""
        return self._lib.ds_cpu_ops_simd() == 2

    def step(self, p: np.ndarray, m: np.ndarray, v: np.ndarray, g: np.ndarray,
             step_count: int, lr: Optional[float] = None,
             bf16_out: Optional[np.ndarray] = None) -> None:
        """One Adam step; ``step_count`` counts from 1."""
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        bc1, bc2 = ((1.0 - b1 ** step_count, 1.0 - b2 ** step_count)
                    if self.bias_correction else (1.0, 1.0))
        n = p.size
        self._lib.ds_adam_step(_f32(p), _f32(m, n), _f32(v, n), _f32(g, n), n, lr, b1, b2,
                               self.eps, self.weight_decay, bc1, bc2,
                               1 if self.adamw_mode else 0, _out16(bf16_out, n))


class DeepSpeedCPUAdagrad:
    """Host Adagrad over flat fp32 arrays, in place."""

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self._lib = cpu_ops()

    def step(self, p: np.ndarray, a: np.ndarray, g: np.ndarray, lr: Optional[float] = None,
             bf16_out: Optional[np.ndarray] = None) -> None:
        lr = self.lr if lr is None else lr
        n = p.size
        self._lib.ds_adagrad_step(_f32(p), _f32(a, n), _f32(g, n), n, lr, self.eps,
                                  self.weight_decay, _out16(bf16_out, n))


def adam_step_numpy(p, m, v, g, step_count: int, lr: float, betas=(0.9, 0.999),
                    eps: float = 1e-8, weight_decay: float = 0.0, adamw_mode: bool = True,
                    bias_correction: bool = True) -> None:
    """The host Adam's arithmetic in numpy, in place (the tests' reference)."""
    b1, b2 = betas
    bc1, bc2 = ((1.0 - b1 ** step_count, 1.0 - b2 ** step_count)
                if bias_correction else (1.0, 1.0))
    gi = g + weight_decay * p if (weight_decay and not adamw_mode) else g
    m *= b1
    m += (1.0 - b1) * gi
    v *= b2
    v += (1.0 - b2) * gi * gi
    upd = (m / bc1) / (np.sqrt(v / bc2) + eps)
    if weight_decay and adamw_mode:
        upd += weight_decay * p
    p -= lr * upd


def adagrad_step_numpy(p, a, g, lr: float, eps: float = 1e-10,
                       weight_decay: float = 0.0) -> None:
    """The host Adagrad's arithmetic in numpy, in place (the tests' reference)."""
    gi = g + weight_decay * p
    a += gi * gi
    p -= lr * gi / (np.sqrt(a) + eps)
