"""The dequant-fused product over the quantized wire format (kernel B8): the
hand-written CUDA kernel and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/dequant_matmul.py``:

    out[M, F] = x[M, D] @ (q * scale + zero_point)[:, :orig_size]

with ``q`` the uint8 ``[D, Fp]`` payload of ``comm.quantized.quantize_blockwise``
and ``scale`` / ``zero_point`` fp32 ``[D, Fp / block]``, the block extent
``Fp // nb`` taken from the shapes (any even block that ``effective_block``
gives). The kernel (``deepspeed_tpu_torch/csrc/dequant_matmul.cu``; its
header says how it is tiled and what bounds it) reads x as fp32 whatever its
dtype, dequantizes each weight tile as it stages it, accumulates in fp32 and
writes x's dtype. The reference's ``_eligible`` tile rule is a Mosaic limit
and does not carry over: every 8-bit payload takes the kernel, ragged tiles
masked. Packed int4 payloads take the plain route on every device, as the
reference's do. On a CUDA tensor an 8-bit payload launches the kernel or
raises; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .flash_attention import DTYPE_CODE

# kernel launches since import or the last reset to 0 (chip_smoke.py reads it
# to show that a main path went through the kernel)
launches = 0


def _dequantize(q, scale, zero_point, bits, orig_size):
    # comm.quantized imports this module; the import here runs at call time
    from ...comm.quantized import dequantize_blockwise

    return dequantize_blockwise(q, scale, zero_point, bits=bits, orig_size=orig_size)


def dequant_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                       zero_point: torch.Tensor, orig_size: int, bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of B8: ``dequantize_blockwise`` trimmed to
    ``orig_size``, an fp32 product, one cast to x's dtype."""
    return (x.float() @ _dequantize(q, scale, zero_point, bits, orig_size)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dequant_matmul")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_dequant_matmul.argtypes = [ptr, i64] + [ptr] * 4 + [i32] * 6 + [ptr]
    lib.ds_dequant_matmul.restype = i32
    return lib


def _launch(x, q, scale, zero_point, orig_size: int) -> torch.Tensor:
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"dequant_matmul kernel: x dtype {x.dtype}; expected float32, "
                        "bfloat16 or float16")
    if scale.dtype != torch.float32 or zero_point.dtype != torch.float32:
        raise TypeError("dequant_matmul kernel: scale and zero_point must be float32")
    if not (x.device == q.device == scale.device == zero_point.device):
        raise ValueError("dequant_matmul: x, q, scale and zero_point on different devices")
    if x.stride(-1) != 1:
        x = x.contiguous()
    q, scale, zero_point = q.contiguous(), scale.contiguous(), zero_point.contiguous()
    M, D = x.shape
    Fp, nb = q.shape[1], scale.shape[1]
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = torch.empty((M, orig_size), dtype=x.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(index):
        status = lib.ds_dequant_matmul(
            x.data_ptr(), x.stride(0), q.data_ptr(), scale.data_ptr(), zero_point.data_ptr(),
            out.data_ptr(), M, D, Fp, nb, orig_size, DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(index).cuda_stream)
    _build.check(lib, status, "dequant_matmul")
    return out


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   zero_point: torch.Tensor, orig_size: int, bits: int = 8) -> torch.Tensor:
    """``x @ dequantize_blockwise(q, scale, zero_point)[:, :orig_size]``
    without a dequantized weight. x [M, D] float; q uint8 [D, Fp] (8-bit; a
    packed 4-bit payload takes the plain route); scale / zero_point fp32
    [D, nb]. Returns [M, orig_size] in x's dtype. It has no autograd rule of
    its own: ``comm.quantized.quantized_matmul_reshard`` carries it."""
    global launches
    if bits not in (4, 8):
        raise ValueError(f"dequant_matmul: bits must be 8 or 4, got {bits}")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"dequant_matmul: x {tuple(x.shape)} and q {tuple(q.shape)} do not "
                         "make [M, D] @ [D, Fp]")
    if q.dtype != torch.uint8:
        raise TypeError(f"dequant_matmul: q must be uint8, got {q.dtype}")
    nb = scale.shape[-1]
    width = q.shape[1] * (2 if bits == 4 else 1)
    if (scale.shape != (q.shape[0], nb) or zero_point.shape != scale.shape or nb < 1
            or width % nb or not 0 < orig_size <= width):
        raise ValueError(f"dequant_matmul: scale {tuple(scale.shape)}, zero_point "
                         f"{tuple(zero_point.shape)} and orig_size {orig_size} do not fit q "
                         f"{tuple(q.shape)} of {bits} bits")
    if bits == 4 or x.device.type == "cpu":
        return dequant_matmul_ref(x, q, scale, zero_point, orig_size, bits)
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul: unsupported device {x.device}")
    out = _launch(x, q, scale, zero_point, orig_size)
    launches += 1
    return out
