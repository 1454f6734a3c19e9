"""Silent-data-corruption defense: detect, contain, heal (counterpart of
``deepspeed_tpu/resilience/integrity.py``).

1. **Fingerprinted state domains** (:class:`IntegrityMonitor`). Long-lived
   state registers as a domain: named units (tensors on the card, or host
   arrays) reached through a reader. Every ``scan_interval`` steps the
   monitor stamps the next ``blocks_per_scan`` blocks of ``block_bytes``
   after the step mutates state, and verifies exactly those blocks before
   the next step mutates it again: the quiet window between steps, where a
   clean run can never mismatch. A block is sliced on its device and only
   its bytes cross to the host, so a scan moves ``blocks_per_scan x
   block_bytes`` and no more (:meth:`IntegrityMonitor.report` counts the
   bytes and the seconds).
2. **Redundant-compute spot checks**: the engine reruns one micro-batch and
   compares the loss and gradient fingerprint bitwise; across ranks
   :func:`fingerprint_vote` names a rank whose boundary fingerprint leaves
   the strict majority.
3. **Containment and healing**: a failed training check rolls back through
   the health controller (anchors verified before trust); serving's page
   fingerprints live in the scheduler; a handoff payload's fingerprints
   (:func:`payload_fingerprints`) are consumed by the import of the
   disaggregated roles (ROADMAP.md A10).

A chaos flip (:meth:`IntegrityMonitor.inject_flip`) flips one real bit of
the unit in place: of a tensor on its device through a ``uint8`` view and
an XOR, of a host array in RAM.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils.logging import logger
from .checksum import CHECKSUMS, preferred_checksum
from .fingerprint import DEFAULT_BLOCK_BYTES, byte_view, host_bytes, nbytes_of

__all__ = [
    "SDCError",
    "IntegrityMonitor",
    "fingerprint_vote",
    "payload_fingerprints",
    "verify_payload_fingerprints",
]


class SDCError(RuntimeError):
    """A fingerprinted block changed inside its quiescent window. The
    message names the exact domain, unit, and block."""

    def __init__(self, mismatches: List[dict]):
        self.mismatches = mismatches
        first = mismatches[0] if mismatches else {}
        super().__init__(
            f"silent data corruption: {len(mismatches)} block(s) failed "
            f"verification (first: domain={first.get('domain')!r} "
            f"unit={first.get('unit')!r} block={first.get('block')})")


class _Domain:
    __slots__ = ("name", "reader", "writer")

    def __init__(self, name: str, reader: Callable[[], Dict[Any, Any]],
                 writer: Optional[Callable[[Any, Any], None]]):
        self.name = name
        self.reader = reader
        self.writer = writer


class IntegrityMonitor:
    """Budgeted blockwise fingerprinting over registered state domains.

    A *domain* is registered with a ``reader`` returning ``{unit_key:
    tensor or array}`` (the engine's: the master and optimizer leaves, a
    rank's slices at stages 1-2). Units are fingerprinted over their raw
    bytes in ``block_bytes`` blocks.

    Protocol (driven by the engine):

    - post-step, every ``scan_interval`` steps: :meth:`stamp_next` stamps
      the next ``blocks_per_scan`` blocks in round-robin rotation;
    - pre-step (before the optimizer mutates state again):
      :meth:`verify_pending` recomputes exactly the stamped blocks and
      reports any mismatch;
    - any state replacement (rollback, checkpoint load, reshard) calls
      :meth:`invalidate` — stamps over replaced state are void, not stale.

    Cost: ``2 * blocks_per_scan`` block fingerprints per ``scan_interval``
    steps, amortized and measured (:meth:`report` → ``overhead_frac``).
    """

    def __init__(self, *, scan_interval: int = 16, blocks_per_scan: int = 4,
                 block_bytes: int = DEFAULT_BLOCK_BYTES,
                 algo: Optional[str] = None,
                 recovery_log=None, clock: Callable[[], float] = time.monotonic):
        self.scan_interval = max(1, int(scan_interval))
        self.blocks_per_scan = max(1, int(blocks_per_scan))
        self.block_bytes = max(1, int(block_bytes))
        self.algo = algo or preferred_checksum()
        if self.algo not in CHECKSUMS:
            raise ValueError(
                f"unknown fingerprint algo {self.algo!r}; "
                f"known: {sorted(CHECKSUMS)}")
        self._fp = CHECKSUMS[self.algo]
        self.recovery_log = recovery_log
        self._clock = clock
        self._domains: Dict[str, _Domain] = {}
        # pending stamps: (domain, unit_key, block_idx) -> fingerprint
        self._pending: Dict[Tuple[str, Any, int], int] = {}
        # rotation state: index into the flattened (domain, unit) list and
        # the block offset inside the current unit
        self._rr_unit = 0
        self._rr_block = 0
        self.counters: Dict[str, int] = {
            "scans": 0, "blocks_stamped": 0, "blocks_verified": 0,
            "mismatches": 0, "spot_checks": 0, "spot_mismatches": 0,
            "invalidations": 0,
        }
        self.detected: List[dict] = []
        self.overhead_s = 0.0
        self.step_time_s = 0.0
        self.bytes_fingerprinted = 0  # bytes copied to the host by stamps and verifies
        self.scan_s = 0.0  # the stamps' and verifies' share of overhead_s

    # ------------------------------------------------------------- domains
    def register_domain(self, name: str,
                        reader: Callable[[], Dict[Any, Any]],
                        writer: Optional[Callable[[Any, Any], None]] = None
                        ) -> None:
        """``reader() -> {unit_key: tensor or array}``. ``writer(unit_key,
        array)`` replaces a unit wholesale, for a unit that cannot be written
        in place (a read-only host array); a contiguous tensor or writable
        array is flipped in place."""
        self._domains[name] = _Domain(name, reader, writer)

    @property
    def domains(self) -> List[str]:
        return list(self._domains)

    # ------------------------------------------------------------- helpers
    def _block_count(self, arr) -> int:
        return max(1, math.ceil(nbytes_of(arr) / self.block_bytes))

    def _block_fp(self, arr, block: int) -> int:
        s = block * self.block_bytes
        data = host_bytes(byte_view(arr), s, s + self.block_bytes)
        self.bytes_fingerprinted += len(data)
        return self._fp(data)

    def _unit_list(self) -> List[Tuple[str, Any]]:
        out = []
        for dom in self._domains.values():
            try:
                units = dom.reader()
            except Exception as e:  # a domain mid-rebuild is not corruption
                logger.warning(f"integrity: domain {dom.name!r} unreadable "
                               f"({e}); skipping this rotation")
                continue
            for key in units:
                out.append((dom.name, key))
        return out

    # ------------------------------------------------------------ rotation
    def stamp_next(self, k: Optional[int] = None) -> int:
        """Stamp the next ``k`` blocks (default ``blocks_per_scan``) in
        round-robin across all domains. Returns blocks stamped."""
        k = self.blocks_per_scan if k is None else max(1, int(k))
        t0 = self._clock()
        units = self._unit_list()
        stamped = 0
        if not units:
            return 0
        guard = 0
        while stamped < k and guard <= len(units):
            if self._rr_unit >= len(units):
                self._rr_unit = 0
            dom_name, key = units[self._rr_unit]
            try:
                arr = self._domains[dom_name].reader()[key]
            except Exception:
                self._rr_unit += 1
                self._rr_block = 0
                guard += 1
                continue
            nblocks = self._block_count(arr)
            if self._rr_block >= nblocks:
                self._rr_unit += 1
                self._rr_block = 0
                guard += 1
                continue
            while stamped < k and self._rr_block < nblocks:
                b = self._rr_block
                self._pending[(dom_name, key, b)] = self._block_fp(arr, b)
                self._rr_block += 1
                stamped += 1
            if self._rr_block >= nblocks:
                self._rr_unit += 1
                self._rr_block = 0
            guard = 0
        self.counters["scans"] += 1
        self.counters["blocks_stamped"] += stamped
        self.overhead_s += self._clock() - t0
        self.scan_s += self._clock() - t0
        return stamped

    def verify_pending(self) -> List[dict]:
        """Recompute every pending block and compare. Clears the pending
        set (mismatching stamps included — the healing path replaces the
        state they covered). Returns the mismatches, each naming the exact
        domain/unit/block, and records ``sdc_detected`` events."""
        if not self._pending:
            return []
        t0 = self._clock()
        mismatches: List[dict] = []
        for (dom_name, key, block), expected in self._pending.items():
            dom = self._domains.get(dom_name)
            if dom is None:
                continue
            try:
                arr = dom.reader()[key]
            except Exception:
                continue  # unit replaced/rebuilt: stamp is void, not stale
            if block >= self._block_count(arr):
                continue
            actual = self._block_fp(arr, block)
            self.counters["blocks_verified"] += 1
            if actual != expected:
                mismatches.append({
                    "domain": dom_name, "unit": key, "block": int(block),
                    "expected": int(expected), "actual": int(actual),
                })
        self._pending.clear()
        self.overhead_s += self._clock() - t0
        self.scan_s += self._clock() - t0
        if mismatches:
            self.counters["mismatches"] += len(mismatches)
            self.detected.extend(mismatches)
            for m in mismatches:
                logger.error(
                    f"integrity: SDC in domain {m['domain']!r} unit "
                    f"{m['unit']!r} block {m['block']} "
                    f"({m['expected']:#010x} -> {m['actual']:#010x})")
                if self.recovery_log is not None:
                    self.recovery_log.record(
                        "sdc_detected", domain=m["domain"],
                        unit=str(m["unit"]), block=m["block"])
        return mismatches

    @property
    def pending_blocks(self) -> int:
        return len(self._pending)

    def invalidate(self, reason: str = "") -> None:
        """Void all pending stamps (state was legitimately replaced:
        rollback, checkpoint load, reshard)."""
        if self._pending:
            self.counters["invalidations"] += 1
            self._pending.clear()
        # the rotation cursor survives: coverage resumes where it left off

    # ------------------------------------------------------------ schedule
    def scan_due(self, step: int) -> bool:
        return step > 0 and step % self.scan_interval == 0

    # ---------------------------------------------------------- spot check
    def record_spot_check(self, ok: bool, step: int,
                          detail: Optional[dict] = None) -> None:
        self.counters["spot_checks"] += 1
        if not ok:
            self.counters["spot_mismatches"] += 1
            logger.error(f"integrity: redundant-compute spot check diverged "
                         f"at step {step}: {detail}")
            if self.recovery_log is not None:
                self.recovery_log.record("sdc_detected", step=step,
                                         domain="compute",
                                         **(detail or {}))

    # --------------------------------------------------------------- chaos
    def inject_flip(self, domain: Optional[str] = None) -> dict:
        """Flip one real bit inside a *stamped* block of ``domain`` (first
        registered domain when None) — modelling rot landing in the
        quiescent window the stamps cover. If the domain has no pending
        stamp yet, block 0 of its first unit is stamped first so the flip
        is provably inside a covered window. Returns
        ``{domain, unit, block, byte}``."""
        if not self._domains:
            raise RuntimeError("integrity: no domains registered")
        name = domain or next(iter(self._domains))
        dom = self._domains.get(name)
        if dom is None:
            raise KeyError(f"integrity: unknown domain {name!r}; "
                           f"registered: {self.domains}")
        target = next(((d, k, b) for (d, k, b) in self._pending
                       if d == name), None)
        if target is None:
            units = dom.reader()
            key = next(iter(units))
            self._pending[(name, key, 0)] = self._block_fp(units[key], 0)
            target = (name, key, 0)
        _, key, block = target
        arr = dom.reader()[key]
        # flip the middle byte of the block (never a pad byte)
        nbytes = nbytes_of(arr)
        start = block * self.block_bytes
        span = min(self.block_bytes, max(1, nbytes - start))
        pos = start + span // 2
        if hasattr(arr, "untyped_storage") and arr.is_contiguous():
            # in place on the tensor's own device: a real bit of live state
            byte_view(arr)[pos:pos + 1].bitwise_xor_(1)
        elif isinstance(arr, np.ndarray) and arr.flags.writeable and arr.flags.c_contiguous:
            arr.reshape(-1).view(np.uint8)[pos] ^= 0x01  # in place: real RAM
        else:
            if dom.writer is None:
                raise RuntimeError(f"integrity: domain {name!r} unit {key!r} cannot be "
                                   "written in place and registered no writer; cannot "
                                   "inject a flip")
            flipped = np.array(np.asarray(arr), copy=True)
            flipped.reshape(-1).view(np.uint8)[pos] ^= 0x01
            dom.writer(key, flipped)
        logger.warning(f"integrity: CHAOS bit flip injected in domain "
                       f"{name!r} unit {key!r} byte {pos}")
        return {"domain": name, "unit": key, "block": int(block),
                "byte": int(pos)}

    # ---------------------------------------------------------- accounting
    def note_step_time(self, dt: float) -> None:
        self.step_time_s += max(0.0, float(dt))

    def add_overhead(self, dt: float) -> None:
        self.overhead_s += max(0.0, float(dt))

    def overhead_frac(self) -> float:
        if self.step_time_s <= 0:
            return 0.0
        return self.overhead_s / self.step_time_s

    def report(self) -> dict:
        return {
            "algo": self.algo,
            "domains": self.domains,
            "pending_blocks": self.pending_blocks,
            "overhead_s": round(self.overhead_s, 6),
            "overhead_frac": round(self.overhead_frac(), 6),
            "bytes_fingerprinted": int(self.bytes_fingerprinted),
            "scan_s": round(self.scan_s, 6),
            **self.counters,
        }


# ----------------------------------------------------------------- dp vote
def fingerprint_vote(rows: List[dict]) -> Tuple[Optional[int], List[dict]]:
    """Majority vote over per-host boundary fingerprints.

    ``rows`` come from :func:`~.watchdog.allgather_host_stats` with the
    ``fingerprint`` field populated. Returns ``(majority_fp, deviants)``
    where deviants are the rows disagreeing with the strict majority. With
    no strict majority (e.g. 1-vs-1), *nobody* is named — a suspect needs
    a quorum against it, not a coin flip.
    """
    votes: Dict[int, int] = {}
    for r in rows:
        fp = int(r.get("fingerprint", 0))
        votes[fp] = votes.get(fp, 0) + 1
    if not votes:
        return None, []
    best_fp, best_n = max(votes.items(), key=lambda kv: kv[1])
    if best_n * 2 <= len(rows):
        return None, []  # no strict majority: inconclusive, name nobody
    deviants = [r for r in rows if int(r.get("fingerprint", 0)) != best_fp]
    return best_fp, deviants


# ----------------------------------------------------- payload fingerprints
def payload_fingerprints(tensors: Dict[str, dict],
                         algo: Optional[str] = None) -> dict:
    """Fingerprint a serialized page-payload ``tensors`` dict (the
    ``export_pages`` wire form: ``{key: {..., "data": bytes}}``). Returns
    ``{"algo": ..., "tensors": {key: fp}}`` — JSON-safe, so it survives the
    fleet wire codec."""
    algo = algo or preferred_checksum()
    fn = CHECKSUMS[algo]
    return {"algo": algo,
            "tensors": {key: int(fn(bytes(t["data"])))
                        for key, t in tensors.items()}}


def verify_payload_fingerprints(tensors: Dict[str, dict],
                                stamp: dict) -> List[str]:
    """Re-fingerprint ``tensors`` against a :func:`payload_fingerprints`
    stamp. Returns the keys that mismatch (empty == clean). Unknown algo
    or missing keys count as mismatches — an unverifiable transfer is a
    refused transfer."""
    algo = stamp.get("algo")
    fn = CHECKSUMS.get(algo)
    expected = stamp.get("tensors", {})
    if fn is None or set(expected) != set(tensors):
        return sorted(set(expected) ^ set(tensors)) or ["<algo>"]
    return [key for key, t in tensors.items()
            if int(fn(bytes(t["data"]))) != int(expected[key])]
