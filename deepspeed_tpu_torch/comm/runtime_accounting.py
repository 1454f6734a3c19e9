"""The quantized wire's byte ledger (counterpart of the ``WireLedger`` part of
``deepspeed_tpu/comm/runtime_accounting.py``).

Each quantized op (``comm/quantized.py``) records, per call, the bytes the
full-precision collective would have moved (logical) beside the int payload
plus per-block scales and zero-points it moves (wire). The reference records
once per trace; the eager port records once per executed call, so counts
differ between the two while each op's wire/logical ratio does not.

The gradient exchange's ops (``qgrad_bucket_rs`` / ``qgrad_bucket_ag`` per
layer bucket, ``qgrad_reduce_scatter`` / ``qgrad_all_gather`` for the rest)
record here like the stage-3 gathers. The profiler-trace parsers, the
overlap column and the host-DMA column are not ported yet (ROADMAP.md A9c).
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

    def summary(self) -> str:
        lines = ["quantized wire accounting (per executed call):"]
        for name, row in self.summary_dict().items():
            lines.append(f"  {name:<32} count={row['count']:<5} "
                         f"logical={row['logical_bytes']} wire={row['wire_bytes']} "
                         f"({row['ratio']}x)")
        if not self.records:
            lines.append("  (no quantized collectives ran)")
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


wire_ledger = WireLedger()
