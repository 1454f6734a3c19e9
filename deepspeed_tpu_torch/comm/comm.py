"""Collective-communication facade over ``torch.distributed`` (counterpart of
``deepspeed_tpu/comm/comm.py``).

Every collective of the port goes through here, for the reference's two
reasons: one choke point where :class:`CommsLogger` counts ops and bytes, and
call sites that read like the reference's (``comm.all_reduce(x)``).

The reference's ``axis_name`` (a mesh axis inside ``shard_map``) becomes a
process group; ``group=None`` is the default group, named ``dp`` in the
logs, as the data-parallel axis is in the reference. The collectives are
functional, as the reference's are: they return a new tensor and leave the
input as it is. At world size 1, or before :func:`init_distributed`, every
collective is the identity and none is issued.

:func:`init_distributed` picks NCCL for a CUDA device (the default, as every
entry point of the port) and gloo for the CPU, so that the multi-rank paths
run in CPU processes where there is one card or none.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..accelerator import resolve_device
from ..utils.logging import log_dist, logger

# --------------------------------------------------------------------------- logger
@dataclass
class _OpRecord:
    count: int = 0
    bytes: int = 0       # logical bytes (full-precision payload)
    wire_bytes: int = 0  # bytes on the wire (== bytes unless quantized)


@dataclass
class CommsLogger:
    """Per-op count and byte accounting, one record per executed call (the
    reference counts per trace). Quantized collectives record their wire
    bytes beside the logical ones."""

    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    prof_ops: List[str] = field(default_factory=list)
    records: Dict[str, _OpRecord] = field(default_factory=dict)

    def record(self, op_name: str, nbytes: int, wire_bytes: Optional[int] = None) -> None:
        if not self.enabled:
            return
        if not self.prof_all and self.prof_ops and not any(
                op_name.startswith(p) for p in self.prof_ops):
            return
        rec = self.records.setdefault(op_name, _OpRecord())
        rec.count += 1
        rec.bytes += int(nbytes)
        rec.wire_bytes += int(wire_bytes if wire_bytes is not None else nbytes)
        if self.verbose:
            wire = (f" wire {wire_bytes}" if wire_bytes is not None and wire_bytes != nbytes
                    else "")
            logger.info(f"comm: {op_name} {nbytes} bytes{wire}")

    def log_summary(self) -> str:
        lines = ["comm op summary (per executed call):"]
        for name, rec in sorted(self.records.items()):
            line = f"  {name:<24} count={rec.count:<8} bytes={rec.bytes}"
            if rec.wire_bytes != rec.bytes:
                line += (f" wire={rec.wire_bytes} "
                         f"({rec.bytes / max(1, rec.wire_bytes):.2f}x)")
            lines.append(line)
        out = "\n".join(lines)
        log_dist(out)
        return out

    def reset(self) -> None:
        self.records.clear()


comms_logger = CommsLogger()


def configure(enabled: bool = True, verbose: bool = False, prof_all: bool = True,
              prof_ops: Optional[Sequence[str]] = None) -> None:
    """Set the logger from the ``comms_logger`` config block's fields."""
    comms_logger.enabled = enabled
    comms_logger.verbose = verbose
    comms_logger.prof_all = prof_all
    comms_logger.prof_ops = list(prof_ops or [])


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _name(group) -> str:
    return "dp" if group is None else str(getattr(group, "group_name", "group"))


# --------------------------------------------------------------------------- init
def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     device=None, timeout_s: float = 1800.0) -> None:
    """Join the process group (counterpart of the reference's
    ``init_distributed``). ``init_method`` defaults to ``env://`` and
    ``world_size`` / ``rank`` to ``WORLD_SIZE`` / ``RANK`` (1 / 0). The
    backend is NCCL when ``device`` is a CUDA device (the default; the
    rank's card is then ``LOCAL_RANK``'s) and gloo for ``device="cpu"``. A
    second call is a no-op."""
    if is_initialized():
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", "1"))
    rank = int(rank if rank is not None else os.environ.get("RANK", "0"))
    if backend == "nccl":
        # one card per rank of a host: "cuda" then means this rank's card
        torch.cuda.set_device(get_local_rank())
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    log_dist(f"init_distributed: {backend}, world size {world_size}")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def _issued(group) -> bool:
    """Whether a collective over ``group`` moves anything: more than one rank."""
    return get_world_size(group) > 1


# --------------------------------------------------------------------------- collectives
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over the group: ``sum``, ``mean``, ``max`` or ``min``."""
    if op not in (*_OPS, "mean"):
        raise ValueError(f"unknown reduction {op!r}")
    comms_logger.record(f"all_reduce[{_name(group)}]", _nbytes(x))
    if not _issued(group):
        return x
    y = x.detach().clone()  # collectives carry no autograd history
    dist.all_reduce(y, op=_OPS["sum" if op == "mean" else op], group=group)
    return y / get_world_size(group) if op == "mean" else y


def all_gather(x: torch.Tensor, group=None, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x``, in rank order: concatenated along ``axis``
    (``tiled``) or stacked on a new ``axis``."""
    comms_logger.record(f"all_gather[{_name(group)}]", _nbytes(x))
    if not _issued(group):
        return x if tiled else x.unsqueeze(axis)
    W = get_world_size(group)
    # flat buffers: the one layout every backend takes
    out = torch.empty(W * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    out = out.view((W,) + tuple(x.shape))
    if not tiled:
        return out.movedim(0, axis)
    axis = axis % max(1, x.dim())
    return torch.cat(out.unbind(0), dim=axis)


def reduce_scatter(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """Sum over the group, rank i keeping the i-th of W equal chunks along ``axis``."""
    comms_logger.record(f"reduce_scatter[{_name(group)}]", _nbytes(x))
    if not _issued(group):
        return x
    W = get_world_size(group)
    xm = x.movedim(axis, 0)
    if xm.shape[0] % W:
        raise ValueError(f"reduce_scatter: dim {axis} extent {xm.shape[0]} not divisible "
                         f"by the world size {W}")
    out = torch.empty(xm.numel() // W, dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xm.contiguous().view(-1), group=group)
    return out.view((xm.shape[0] // W,) + tuple(xm.shape[1:])).movedim(0, axis)


def all_to_all(x: torch.Tensor, group=None, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """Split ``x`` into W chunks along ``split_axis``, send chunk j to rank j,
    and concatenate the received chunks along ``concat_axis`` in rank order."""
    comms_logger.record(f"all_to_all[{_name(group)}]", _nbytes(x))
    if not _issued(group):
        return x
    W = get_world_size(group)
    xm = x.movedim(split_axis, 0)
    if xm.shape[0] % W:
        raise ValueError(f"all_to_all: dim {split_axis} extent {xm.shape[0]} not divisible "
                         f"by the world size {W}")
    send = xm.reshape((W, xm.shape[0] // W) + tuple(xm.shape[1:])).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    chunks = [c.movedim(0, split_axis) for c in recv.unbind(0)]
    return torch.cat(chunks, dim=concat_axis)


def broadcast(x: torch.Tensor, group=None, src_index: int = 0) -> torch.Tensor:
    """Rank ``src_index``'s ``x`` on every rank."""
    comms_logger.record(f"broadcast[{_name(group)}]", _nbytes(x))
    if not _issued(group):
        return x
    y = x.clone()
    src = src_index if group is None else dist.get_global_rank(group, src_index)
    dist.broadcast(y, src=src, group=group)
    return y


def barrier(group=None) -> None:
    if _issued(group):
        dist.barrier(group=group)

