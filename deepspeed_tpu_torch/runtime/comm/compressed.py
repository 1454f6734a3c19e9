"""The error-compensated 1-bit compressed allreduce (counterpart of
``deepspeed_tpu/runtime/comm/compressed.py``), which 1-bit Adam, 1-bit LAMB
and 0/1 Adam exchange in their compressed stage (``runtime/fp16/onebit.py``).

The wire format (packed signs and one fp32 scale) and the error-feedback
step live in :mod:`deepspeed_tpu_torch.comm.quantized`; this module owns the
exchange over the :mod:`~deepspeed_tpu_torch.comm.comm` facade:

1. worker: ``buf = x + worker_error``, 1-bit quantized; what the signs lose
   stays on the rank as the new ``worker_error``;
2. exchange: an ``all_to_all`` of the packed sign chunks (rank c receives
   every rank's chunk c) and an ``all_gather`` of the scales;
3. server: each rank averages its chunk, compresses the average with its
   ``server_error``, and an ``all_gather`` of the server chunks gives every
   rank the same result.

At world size 1 (no process group) the collectives are the identity and the
whole exchange runs in the process, as the reference's body does on a
1-device axis. Each call records its bytes in the wire ledger
(``comm/runtime_accounting.py``) as ``compressed_allreduce[dp]``: logical
``2 * n * 4`` (an fp32 allreduce as a reduce-scatter plus an all-gather), wire
the two sign exchanges of ``n / 8`` bytes each plus the 2 W fp32 scales.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...comm import comm
from ...comm.quantized import (  # noqa: F401  (re-exported, as the reference does)
    _record,
    dequantize_1bit,
    error_feedback_step,
    pack_signs,
    quantize_1bit,
    unpack_signs,
)


def compression_error_shapes(n: int, world: int) -> Tuple[int, int]:
    """(worker_error size, server_error size) for a flat buffer of ``n``
    elements, which the caller pads to a multiple of ``world * 8``."""
    if n % (world * 8) != 0:
        raise ValueError(f"buffer size {n} must be a multiple of world*8={world * 8}")
    return n, n // world


def _compress_1bit(buf: torch.Tensor):
    """((packed signs, scale), new residual) of a flat fp32 buffer."""
    n = buf.shape[-1]
    return error_feedback_step(buf, quantize_1bit,
                               lambda payload: dequantize_1bit(payload[0], payload[1], n))


def compressed_allreduce(x: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor, group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One error-compensated compressed allreduce step over ``group``.

    ``x`` [n] is this rank's vector, ``worker_error`` [n] and
    ``server_error`` [n / W] this rank's residuals (fp32). Returns
    ``(result, new_worker_error, new_server_error)``: ``result`` approximates
    the mean of ``x`` over the ranks and is the same on every rank."""
    n = x.shape[0]
    world = comm.get_world_size(group)
    chunk = n // world
    buf = x.float() + worker_error
    (packed, scale_w), new_worker_error = _compress_1bit(buf)
    # chunk c of every rank's signs goes to rank c
    recv = comm.all_to_all(packed.reshape(world, -1), group)  # [W, n/8W]
    scales = comm.all_gather(scale_w.reshape(1), group)  # [W]
    chunk_avg = (scales[:, None] * unpack_signs(recv, chunk)).mean(dim=0)
    (s_packed, scale_s), new_server_error = _compress_1bit(chunk_avg + server_error)
    all_packed = comm.all_gather(s_packed, group, axis=0, tiled=False)  # [W, chunk/8]
    all_scales = comm.all_gather(scale_s.reshape(1), group)  # [W]
    result = (all_scales[:, None] * unpack_signs(all_packed, chunk)).reshape(n)
    _record(f"compressed_allreduce[{comm._name(group)}]", 2 * n * 4,
            packed.numel() + world * s_packed.numel() + 2 * 4 * world)
    return result, new_worker_error, new_server_error
