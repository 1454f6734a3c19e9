"""The offload stream: host<->device copies over pinned memory and CUDA
streams, pipelined against the layer units (counterpart of
``deepspeed_tpu/runtime/zero/stream.py``).

- :class:`PinnedHostStage` issues host->device copies from page-locked host
  memory on a copy stream of its own. A unit's copies end with an event;
  :class:`DeviceTransfer` holds the device tensors and that event;
  :meth:`~DeviceTransfer.consume` makes the compute stream wait on it and
  hands each tensor to the compute stream
  (``record_stream``), so that the caching allocator does not give its memory
  away while a kernel of the compute stream may still read it.
- :class:`UnitFetchStream` runs the reference's prologue / steady / drain
  schedule (``gather.prefetch_schedule``): taking unit i first issues unit
  i + d's copy, then waits for unit i only. Units are consumed in the
  declared order at every depth, and the copies change no value, so a
  streamed step computes bitwise what fetch-on-demand (depth 0) computes.
- :class:`GradDrain` copies device tensors into pinned host buffers on a
  second stream after the compute stream's event, so that the host reads a
  gradient only after synchronising the drain's own event.
- :func:`quantized_push`: the quantized host->device wire. The host
  quantizes blockwise (``comm/quantized.np_quantize_blockwise``), the int
  payload and the per-block scales and zero points cross, and the device
  dequantizes on the copy stream, in plain torch. Each push records its
  logical and wire bytes in the wire ledger (``qpush[host-dma]``).
- :func:`flush_host_shards` / :func:`load_host_shards`: host master and
  optimizer state as atomic ``host_state/shard_<k>.npz`` files (the
  reference's layout, ``host_meta.json`` beside them), a ``host-shard``
  fault point after each, under the tag's MANIFEST and COMMIT.

On the CPU (``device="cpu"``) no stream exists: a push is a copy (the host
buffer changes in place at the next optimizer step, so the "device" tensor
must not alias it) and a wait returns at once.

Every blocking wait of the runners is :func:`fetch_wait`: the chaos hook
(:func:`fetch_fault_point`) and the event's synchronisation inside the
``offload_fetch`` watchdog bracket. The host optimizer pass and the shard
flush run under ``offload_flush``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ...comm.runtime_accounting import HostDmaStats, wire_ledger
from ...resilience.chaos import fault_point, offload_fetch_fault
from .gather import prefetch_schedule

HOST_STATE_DIRNAME = "host_state"
_HOST_META = "host_meta.json"

# the process-wide count of blocking offload waits: stall_offload_at's index
_fetch_wait_index = 0


def fetch_fault_point() -> None:
    """The chaos hook of one blocking host<->device wait: advance the
    process-wide wait index and fire an armed ``stall_offload_at``. Every
    blocking wait (a unit's push, a gradient drain, the optimizer offload's
    gradient fetch) calls it inside its ``offload_fetch`` bracket."""
    global _fetch_wait_index
    i = _fetch_wait_index
    _fetch_wait_index += 1
    offload_fetch_fault(i)


def _unwatched(phase: str):
    return contextlib.nullcontext()


def fetch_wait(event: Optional["torch.cuda.Event"],
               watch: Optional[Callable[[str], Any]] = None) -> float:
    """One blocking host<->device wait: inside ``watch``'s ``offload_fetch``
    bracket, the chaos hook, then ``event``'s synchronisation (None: the
    copies were synchronous), so a wedged copy holds the bracket open.
    Returns the seconds waited."""
    with (watch or _unwatched)("offload_fetch"):
        fetch_fault_point()
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        return time.perf_counter() - t0


def fill_push_buffer(buf: torch.Tensor, master: np.ndarray) -> None:
    """A push buffer from its fp32 master, in the buffer's dtype (a bf16
    buffer rounds to nearest even)."""
    buf.copy_(torch.from_numpy(np.ascontiguousarray(master, np.float32)).reshape(buf.shape))


class DeviceTransfer:
    """Copies in flight: ``value`` (a tensor or a dict of tensors) and the
    event recorded after the last copy (None on the CPU)."""

    __slots__ = ("value", "event")

    def __init__(self, value: Any, event: Optional["torch.cuda.Event"]):
        self.value = value
        self.event = event

    def _tensors(self) -> List[torch.Tensor]:
        return list(self.value.values()) if isinstance(self.value, dict) else [self.value]

    def consume(self) -> Any:
        """The value, ordered after the copies on the current stream."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self._tensors()[0].device)
            stream.wait_event(self.event)
            for t in self._tensors():
                t.record_stream(stream)
        return self.value


class PinnedHostStage:
    """Host->device copies from page-locked memory on a copy stream (on a
    CUDA device), or plain copies on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.pinned else None

    def issuing(self):
        """The context in which :meth:`put` and the device work of a push
        (the quantized fetch's dequantize) run: the copy stream. A push
        reads only pinned host memory and writes memory it allocates there,
        so it waits for no compute; the compute stream waits for it
        (:meth:`DeviceTransfer.consume`)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def put(self, host: torch.Tensor) -> torch.Tensor:
        """Issue the copy of ``host`` (inside :meth:`issuing`)."""
        if not self.pinned:
            return host.clone()
        if not host.is_pinned():
            host = host.pin_memory()  # from the caching host allocator
        return host.to(self.device, non_blocking=True)

    def fence(self) -> Optional["torch.cuda.Event"]:
        """An event after every copy issued so far."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def synchronize(self) -> None:
        """Wait until every copy issued has read its host buffer."""
        if self.stream is not None:
            self.stream.synchronize()


class GradDrain:
    """Device->host copies into pinned buffers on a stream of their own."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def issue(self, pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]]
              ) -> Optional["torch.cuda.Event"]:
        """Copy each (device, host) pair after the compute stream's work so
        far; the returned event ends them (None on the CPU, copied already)."""
        if self.stream is None:
            for dev, host in pairs:
                host.copy_(dev)
            return None
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for dev, host in pairs:
                host.copy_(dev, non_blocking=True)
                dev.record_stream(self.stream)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev


def pinned_empty(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host buffer, page-locked when the device is a CUDA one."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def uint16_view(t: torch.Tensor) -> np.ndarray:
    """The numpy uint16 view of a bf16 host tensor's memory (the host
    optimizer's ``bf16_out``)."""
    return t.view(torch.int16).numpy().view(np.uint16)


class UnitFetchStream:
    """The pipelined host->device unit fetcher (the reference's).

    ``fetch_fn(name)`` issues one unit's copies and returns a
    :class:`DeviceTransfer`; :meth:`take` blocks (inside ``watch``'s
    ``offload_fetch`` bracket, chaos-injectable) only on the unit consumed.
    ``depth`` 0 is fetch-on-demand."""

    def __init__(self, fetch_fn: Callable[[str], DeviceTransfer], order: Iterable[str],
                 depth: int, stats: Optional[HostDmaStats] = None,
                 watch: Optional[Callable[[str], Any]] = None):
        self._fetch = fetch_fn
        self.order: List[str] = list(order)
        self.depth = max(0, int(depth))
        self.stats = stats
        self._watch = watch or _unwatched
        self._staged: Dict[str, DeviceTransfer] = {}
        self._events = prefetch_schedule(len(self.order), self.depth)
        self._consumed = 0
        self._primed = False

    def prime(self) -> None:
        """Issue the prologue's ``depth`` fetches now, ahead of the first
        :meth:`take`. Idempotent; nothing at depth 0."""
        if self._primed:
            return
        self._primed = True
        for _ in range(min(self.depth, len(self.order))):
            kind, idx = next(self._events)
            assert kind == "issue", kind
            self._issue(idx)

    def _issue(self, idx: int) -> None:
        t0 = time.perf_counter()
        self._staged[self.order[idx]] = self._fetch(self.order[idx])
        if self.stats is not None:
            self.stats.issue_s += time.perf_counter() - t0

    def take(self, name: str) -> Any:
        """Consume ``name``, which must be next in the declared order."""
        if self._consumed >= len(self.order) or self.order[self._consumed] != name:
            expect = (self.order[self._consumed] if self._consumed < len(self.order)
                      else "<drained>")
            raise ValueError(f"UnitFetchStream: out-of-order take({name!r}); the schedule "
                             f"expects {expect!r} next")
        self._primed = True  # a late prime() must not eat steady-state events
        for kind, idx in self._events:
            if kind == "issue":
                self._issue(idx)
            else:
                assert idx == self._consumed, (idx, self._consumed)
                break
        self._consumed += 1
        transfer = self._staged.pop(name)
        wait = fetch_wait(transfer.event, self._watch)
        if self.stats is not None:
            self.stats.record_wait(wait)
        return transfer.consume()


def quantized_push(host: torch.Tensor, stage: PinnedHostStage, bits: int, block_size: int,
                   compute_dtype: torch.dtype, stats: Optional[HostDmaStats] = None,
                   op_name: str = "qpush[host-dma]") -> torch.Tensor:
    """Push one host leaf (its compute-dtype value, ``host``) over the
    quantized wire, inside ``stage.issuing()``: quantized on the host, the
    payload and its per-block scales and zero points copied, dequantized to
    ``compute_dtype`` on the copy stream. Rows too short to shrink cross at
    the compute dtype (the veto of the quantized gathers)."""
    from ...comm.quantized import (
        dequantize_blockwise,
        np_quantize_blockwise,
        quantization_shrinks,
    )

    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    logical = host.numel() * itemsize
    if host.dim() == 0 or not quantization_shrinks(host.shape[-1], bits, block_size, itemsize):
        if stats is not None:
            stats.record_push(logical, logical)
        return stage.put(host.to(compute_dtype))
    q, s, z = np_quantize_blockwise(host.float().numpy(), bits=bits, block_size=block_size)
    wire = q.nbytes + s.nbytes + z.nbytes
    wire_ledger.record(op_name, logical, wire)
    if stats is not None:
        stats.record_push(logical, wire)
    qd, sd, zd = (stage.put(torch.from_numpy(a)) for a in (q, s, z))
    return dequantize_blockwise(qd, sd, zd, bits=bits,
                                orig_size=int(host.shape[-1])).to(compute_dtype)


def flush_host_shards(dir_path: str, shards: Iterable[Tuple[str, Dict[str, np.ndarray]]],
                      meta: Optional[Dict[str, Any]] = None, writer=None) -> None:
    """Host master / optimizer state as per-shard ``shard_<k>.npz`` files in
    ``dir_path`` (inside a tag directory), each written atomically, with
    ``fault_point("host-shard", k)`` after shard k lands; then
    ``host_meta.json``. The enclosing save writes MANIFEST and COMMIT only
    after every shard, so a kill mid-flush leaves the tag uncommitted."""
    from ...resilience.retry import RetryingWriter

    writer = writer or RetryingWriter()
    os.makedirs(dir_path, exist_ok=True)
    names = []
    for k, (shard_name, arrays) in enumerate(shards):
        fname = f"shard_{k:05d}.npz"
        writer.atomic_write(os.path.join(dir_path, fname),
                            lambda f, arrs=arrays: np.savez(f, **arrs),
                            fsync=False,  # the commit's durability pass fsyncs
                            describe=f"host shard {shard_name}")
        names.append({"file": fname, "name": shard_name, "keys": sorted(arrays)})
        fault_point("host-shard", index=k)
    meta_doc = {"format_version": 1, "shards": names, **(meta or {})}
    writer.atomic_write(os.path.join(dir_path, _HOST_META),
                        lambda f: f.write(json.dumps(meta_doc, indent=1).encode()),
                        fsync=False, describe="host shard meta")


def load_host_shards(dir_path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """The shards merged into one flat state dict, and the meta (the
    manifest verified the bytes already)."""
    with open(os.path.join(dir_path, _HOST_META)) as f:
        meta = json.load(f)
    out: Dict[str, np.ndarray] = {}
    for shard in meta["shards"]:
        with np.load(os.path.join(dir_path, shard["file"])) as d:
            for key in d.files:
                out[key] = d[key]
    return out, meta


__all__ = ["UnitFetchStream", "PinnedHostStage", "DeviceTransfer", "GradDrain",
           "HostDmaStats", "quantized_push", "flush_host_shards", "load_host_shards",
           "fetch_fault_point", "fetch_wait", "fill_push_buffer", "pinned_empty",
           "uint16_view", "HOST_STATE_DIRNAME"]
