"""The quantized wire's byte ledger (counterpart of the ``WireLedger`` part of
``deepspeed_tpu/comm/runtime_accounting.py``).

Each quantized op (``comm/quantized.py``) records, per call, the bytes the
full-precision collective would have moved (logical) beside the int payload
plus per-block scales and zero-points it moves (wire). The reference records
once per trace; the eager port records once per executed call, so counts
differ between the two while each op's wire/logical ratio does not.

The gradient exchange's ops (``qgrad_bucket_rs`` / ``qgrad_bucket_ag`` per
layer bucket, ``qgrad_reduce_scatter`` / ``qgrad_all_gather`` for the rest)
record here like the stage-3 gathers, and so does the offload stream's
quantized host push (``qpush[host-dma]``). :class:`HostDmaStats` is the
offload stream's per-step host<->device copy accounting, attached to the
ledger's summary with :meth:`WireLedger.set_host_dma`. The profiler-trace
parsers and the overlap column are not ported yet (ROADMAP.md A9c).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..utils.logging import log_dist


@dataclass
class WireRecord:
    count: int = 0
    logical_bytes: int = 0  # what full precision would have moved
    wire_bytes: int = 0     # what the quantized format moves


@dataclass
class WireLedger:
    """Logical-vs-wire byte ledger for quantized collectives, per op name."""

    records: Dict[str, WireRecord] = field(default_factory=dict)
    # ops the health controller demoted to the full-precision wire
    # (resilience/rollback.py), so the summary shows the wire's real state
    demotions: list = field(default_factory=list)
    # the offload stream's host<->device copy column (HostDmaStats.to_dict)
    host_dma: Optional[Dict[str, float]] = None

    def record(self, op_name: str, logical_bytes: int, wire_bytes: int) -> None:
        rec = self.records.setdefault(op_name, WireRecord())
        rec.count += 1
        rec.logical_bytes += int(logical_bytes)
        rec.wire_bytes += int(wire_bytes)

    def record_demotion(self, op: str, step: int, reason: str) -> None:
        """A quantized op fell back to the full-precision wire at ``step``."""
        self.demotions.append({"op": op, "step": int(step), "reason": reason,
                               "repromoted_step": None})

    def record_repromotion(self, op: str, step: int) -> None:
        """The newest open demotion of ``op`` ended at ``step``."""
        for d in reversed(self.demotions):
            if d["op"] == op and d["repromoted_step"] is None:
                d["repromoted_step"] = int(step)
                return

    def demoted_ops(self) -> list:
        """Ops on the full-precision wire now (open demotions)."""
        return [d["op"] for d in self.demotions if d["repromoted_step"] is None]

    def ratio(self, prefix: Optional[str] = None) -> float:
        """Aggregate logical/wire compression ratio over ops matching
        ``prefix`` (all quantized ops when None); 1.0 when nothing matched."""
        logical = wire = 0
        for name, rec in self.records.items():
            if prefix is None or name.startswith(prefix):
                logical += rec.logical_bytes
                wire += rec.wire_bytes
        return logical / wire if wire else 1.0

    def summary_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"count": rec.count, "logical_bytes": rec.logical_bytes,
                       "wire_bytes": rec.wire_bytes,
                       "ratio": round(rec.logical_bytes / max(1, rec.wire_bytes), 3)}
                for name, rec in sorted(self.records.items())}

    def set_host_dma(self, dma: Optional[Dict[str, float]]) -> None:
        """Attach the host-DMA column (:meth:`HostDmaStats.to_dict`)."""
        self.host_dma = dict(dma) if dma else None

    def summary(self) -> str:
        lines = ["quantized wire accounting (per executed call):"]
        for name, row in self.summary_dict().items():
            lines.append(f"  {name:<32} count={row['count']:<5} "
                         f"logical={row['logical_bytes']} wire={row['wire_bytes']} "
                         f"({row['ratio']}x)")
        if not self.records:
            lines.append("  (no quantized collectives ran)")
        if self.host_dma:
            h = self.host_dma
            lines.append(f"  host DMA (offload stream, last step): pushed={h.get('push_bytes', 0)}B "
                         f"wire={h.get('wire_bytes', 0)}B grads={h.get('grad_bytes', 0)}B "
                         f"depth={h.get('prefetch_depth', 0)} "
                         f"exposed_wait={h.get('exposed_wait_s', 0.0):.3f}s "
                         f"({h.get('overlapped_frac', 0.0):.0%} of waits overlapped)")
        for d in self.demotions:
            end = (f"re-promoted at step {d['repromoted_step']}"
                   if d["repromoted_step"] is not None else "STILL DEMOTED")
            lines.append(f"  degraded wire: {d['op']} -> full-precision at step {d['step']} "
                         f"({d['reason']}); {end}")
        out = "\n".join(lines)
        log_dist(out)
        return out

    def snapshot(self) -> Dict[str, int]:
        """Per-op counts right now; :meth:`delta` against it attributes the
        records of a stretch of work."""
        return {name: rec.count for name, rec in self.records.items()}

    def delta(self, before: Dict[str, int]) -> Dict[str, int]:
        """Ops recorded since ``before`` (a :meth:`snapshot` result)."""
        return {name: rec.count - before.get(name, 0)
                for name, rec in self.records.items()
                if rec.count > before.get(name, 0)}

    def reset(self) -> None:
        self.records.clear()
        self.demotions.clear()
        self.host_dma = None


wire_ledger = WireLedger()


@dataclass
class HostDmaStats:
    """One step's host<->device copy accounting of the offload stream
    (``runtime/zero/stream.py``), the reference's fields.

    ``push_bytes`` is the compute-dtype volume pushed host->device,
    ``wire_bytes`` what moved (less under the quantized fetch), ``grad_bytes``
    the device->host gradient volume. ``exposed_wait_s`` is the time the host
    spent blocked on a copy at a consume point; a wait under ``READY_EPS_S``
    counts as overlapped (the copy had landed under compute), and
    ``overlapped_frac`` is the share of waits that did."""

    READY_EPS_S = 1e-3

    pushes: int = 0
    push_bytes: int = 0
    wire_bytes: int = 0
    grad_fetches: int = 0
    grad_bytes: int = 0
    waits: int = 0
    overlapped_waits: int = 0
    exposed_wait_s: float = 0.0
    issue_s: float = 0.0
    step_s: float = 0.0
    prefetch_depth: int = 0
    quantized: bool = False

    def record_push(self, logical_bytes: int, wire_bytes: int) -> None:
        self.pushes += 1
        self.push_bytes += int(logical_bytes)
        self.wire_bytes += int(wire_bytes)

    def record_wait(self, seconds: float) -> None:
        self.waits += 1
        if seconds < self.READY_EPS_S:
            self.overlapped_waits += 1
        self.exposed_wait_s += float(seconds)

    def record_grad_fetch(self, nbytes: int, seconds: float) -> None:
        self.grad_fetches += 1
        self.grad_bytes += int(nbytes)
        self.record_wait(seconds)

    @property
    def overlapped_frac(self) -> float:
        return self.overlapped_waits / self.waits if self.waits else 0.0

    @property
    def ratio(self) -> float:
        """Logical / wire compression of the host->device push."""
        return self.push_bytes / self.wire_bytes if self.wire_bytes else 1.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "pushes": self.pushes, "push_bytes": self.push_bytes,
            "wire_bytes": self.wire_bytes, "grad_fetches": self.grad_fetches,
            "grad_bytes": self.grad_bytes, "waits": self.waits,
            "overlapped_waits": self.overlapped_waits,
            "overlapped_frac": round(self.overlapped_frac, 4),
            "exposed_wait_s": round(self.exposed_wait_s, 4),
            "issue_s": round(self.issue_s, 4), "step_s": round(self.step_s, 4),
            "prefetch_depth": self.prefetch_depth, "quantized": self.quantized,
            "ratio": round(self.ratio, 3),
        }
