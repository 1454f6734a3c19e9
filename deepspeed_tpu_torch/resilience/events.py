"""Recovery-event export (counterpart of ``deepspeed_tpu/resilience/events.py``):
what the resilience machinery did, in the reference's JSONL schema.

Two optional sinks: a JSONL file (``recovery_events.jsonl`` beside the
checkpoints; the elastic agent and the engine both append there, so one
file tells a preemption story across process generations), and a monitor
(:class:`~deepspeed_tpu_torch.monitor.monitor.MonitorMaster` or anything
with ``write_events``) as ``<prefix>/<event>`` scalars: ``Resilience/*``
for training, ``Serving/*`` for the scheduler. The file rotates by size
(:func:`rotate_jsonl`) and :func:`read_events` reads the rotated
generations oldest first, tolerating a torn last line. Each package reads
the other's logs.

Imports neither torch nor the rest of the package: the elastic agent, a
supervisor that never touches the card, writes here too.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from ..utils.logging import logger

EVENTS_FILENAME = "recovery_events.jsonl"

#: the rotation threshold (~150k events of ~200 bytes) and generations kept
DEFAULT_ROTATE_BYTES = 32 << 20
DEFAULT_ROTATE_KEEP = 3


def rotate_jsonl(path: str, max_bytes: Optional[int], keep: int = DEFAULT_ROTATE_KEEP) -> bool:
    """Size-based rotation for an append-only JSONL file: when ``path`` is at
    or past ``max_bytes``, shift ``path`` -> ``path.1`` -> ... -> ``path.keep``
    (the oldest generation drops). Returns True when it rotated. ``max_bytes``
    None or <= 0 disables it. A failure is logged, never raised."""
    if not max_bytes or max_bytes <= 0 or keep < 1:
        return False
    try:
        if not os.path.exists(path) or os.path.getsize(path) < max_bytes:
            return False
        for i in range(keep - 1, 0, -1):
            src = f"{path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{path}.{i + 1}")
        os.replace(path, f"{path}.1")
        return True
    except OSError as e:
        logger.warning(f"jsonl rotation failed for {path}: {e}")
        return False


class RecoveryLog:
    """Append-only recovery event log with counter rollups. ``prefix`` names
    the monitor's scalar family; ``max_bytes`` / ``keep`` bound the file
    (None: the default cap, 0: no rotation); ``replica_id`` stamps every
    event (an explicit ``replica_id=`` field wins)."""

    def __init__(self, path: Optional[str] = None, monitor: Any = None, role: str = "engine",
                 prefix: str = "Resilience", max_bytes: Optional[int] = None,
                 keep: int = DEFAULT_ROTATE_KEEP, replica_id: Optional[str] = None):
        self.path = path
        self.monitor = monitor
        self.role = role
        self.prefix = prefix
        self.replica_id = replica_id
        self.max_bytes = DEFAULT_ROTATE_BYTES if max_bytes is None else int(max_bytes)
        self.keep = int(keep)
        self.counters: Dict[str, int] = {}

    @classmethod
    def for_dir(cls, save_dir: str, monitor: Any = None, role: str = "engine",
                **kw: Any) -> "RecoveryLog":
        os.makedirs(save_dir, exist_ok=True)
        return cls(os.path.join(save_dir, EVENTS_FILENAME), monitor=monitor, role=role, **kw)

    def record(self, event: str, value: float = 1.0, step: int = 0, **fields: Any) -> None:
        """One event (``preemption_survived``, ``emergency_save``,
        ``divergence_rollback``, ``sdc_detected``, ``request_shed`` ...):
        counted, appended to the file and written to the monitor. A failing
        sink is logged, never raised."""
        self.counters[event] = self.counters.get(event, 0) + 1
        entry = {"unix_time": time.time(), "role": self.role, "event": event,
                 "value": float(value), "step": int(step), **fields}
        if self.replica_id is not None:
            entry.setdefault("replica_id", self.replica_id)
        if self.path is not None:
            try:
                rotate_jsonl(self.path, self.max_bytes, self.keep)
                with open(self.path, "a") as f:
                    f.write(json.dumps(entry, sort_keys=True, default=str) + "\n")
            except OSError as e:  # event export must never fail the run
                logger.warning(f"recovery event not persisted: {e}")
        if self.monitor is not None:
            try:
                self.monitor.write_events([(f"{self.prefix}/{event}", float(value), int(step))])
            except Exception as e:
                logger.warning(f"recovery event not exported to monitor: {e}")

    def count(self, event: str) -> int:
        return self.counters.get(event, 0)


def _fallback_replica_id(path: str, index: int) -> str:
    """The stamp of an unstamped log's events: its directory's name, else
    its merge position."""
    parent = os.path.basename(os.path.dirname(os.path.abspath(path)))
    return parent or f"replica{index}"


def read_events(save_dir_or_path, keep: int = DEFAULT_ROTATE_KEEP,
                replica_id: Optional[str] = None) -> list:
    """Parse a recovery log (a directory holding the default file, or a
    path), the rotated generations oldest first; a torn last line is
    skipped. A sequence of paths, or of ``(replica_id, path)`` pairs, merges
    several logs in ``unix_time`` order, each event stamped with its
    replica (the producer's stamp wins)."""
    if isinstance(save_dir_or_path, (list, tuple)):
        merged = []
        for i, item in enumerate(save_dir_or_path):
            rid, p = item if isinstance(item, (list, tuple)) else (None, item)
            if rid is None:
                rid = _fallback_replica_id(
                    p if not os.path.isdir(p) else os.path.join(p, EVENTS_FILENAME), i)
            merged.extend(read_events(p, keep=keep, replica_id=str(rid)))
        merged.sort(key=lambda e: e.get("unix_time", 0.0))
        return merged
    path = save_dir_or_path
    if os.path.isdir(path):
        path = os.path.join(path, EVENTS_FILENAME)
    out = []
    for p in [f"{path}.{i}" for i in range(keep, 0, -1)] + [path]:
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # torn tail
                if replica_id is not None and isinstance(ev, dict):
                    ev.setdefault("replica_id", replica_id)
                out.append(ev)
    return out


__all__ = ["RecoveryLog", "read_events", "rotate_jsonl", "EVENTS_FILENAME",
           "DEFAULT_ROTATE_BYTES", "DEFAULT_ROTATE_KEEP"]
