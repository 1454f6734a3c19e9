"""Metrics monitor fan-out (counterpart of ``deepspeed_tpu/monitor/monitor.py``).

Events are ``(name, value, step)`` tuples. :class:`MonitorMaster` writes
them to every enabled backend (TensorBoard, wandb, CSV, JSONL, or a
callback), and only on rank 0 of the process group. TensorBoard goes through
``tensorboardX`` or ``torch.utils.tensorboard`` and wandb is imported when
its backend starts; a backend whose package is missing or fails to start is
left out with a warning, and training goes on, as in the reference. Each
backend writes through :class:`_SafeBackend`: a sink that raises keeps its
events in a bounded buffer and flushes them, in order, once it writes
again.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

from ..comm import comm
from ..resilience.events import DEFAULT_ROTATE_BYTES, rotate_jsonl
from ..utils.logging import logger

Event = Tuple[str, float, int]


class TensorBoardMonitor:
    def __init__(self, output_path: str, job_name: str = "DeepSpeedJobName"):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            from torch.utils.tensorboard import SummaryWriter

        path = os.path.join(output_path or "runs", job_name)
        os.makedirs(path, exist_ok=True)
        self.writer = SummaryWriter(path)

    def write_events(self, events: Sequence[Event]) -> None:
        for name, value, step in events:
            self.writer.add_scalar(name, value, step)
        self.writer.flush()


class CSVMonitor:
    """One ``<name with / as _>.csv`` per event name, rows ``step,value``."""

    def __init__(self, output_path: str, job_name: str = "DeepSpeedJobName"):
        self.dir = os.path.join(output_path or "csv_out", job_name)
        os.makedirs(self.dir, exist_ok=True)

    def write_events(self, events: Sequence[Event]) -> None:
        for name, value, step in events:
            fname = os.path.join(self.dir, name.replace("/", "_") + ".csv")
            new = not os.path.exists(fname)
            with open(fname, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["step", name])
                w.writerow([step, value])


class WandbMonitor:
    def __init__(self, team: Optional[str] = None, group: Optional[str] = None,
                 project: str = "deepspeed"):
        import wandb

        self.wandb = wandb
        wandb.init(entity=team, group=group, project=project)

    def write_events(self, events: Sequence[Event]) -> None:
        for name, value, step in events:
            self.wandb.log({name: value}, step=step)


class CallbackMonitor:
    def __init__(self, fn: Callable[[Sequence[Event]], None]):
        self.fn = fn

    def write_events(self, events: Sequence[Event]) -> None:
        self.fn(events)


class JSONLMonitor:
    """Append-only ``events.jsonl``: one ``{"name", "value", "step",
    "unix_time"}`` object a line. A torn last line is skipped by readers, so
    the file survives a crash; it rotates by size (``max_bytes`` / ``keep``)."""

    def __init__(self, output_path: str, job_name: str = "DeepSpeedJobName",
                 max_bytes: Optional[int] = None, keep: int = 3):
        d = os.path.join(output_path or "jsonl_out", job_name)
        os.makedirs(d, exist_ok=True)
        self.path = os.path.join(d, "events.jsonl")
        self.max_bytes = DEFAULT_ROTATE_BYTES if max_bytes is None else int(max_bytes)
        self.keep = int(keep)

    def write_events(self, events: Sequence[Event]) -> None:
        rotate_jsonl(self.path, self.max_bytes, self.keep)
        with open(self.path, "a") as f:
            for name, value, step in events:
                f.write(json.dumps({"name": name, "value": float(value), "step": int(step),
                                    "unix_time": time.time()}) + "\n")


class _SafeBackend:
    """A backend whose sink fails (full disk, a sick remote file system, a
    wandb outage) buffers its events in memory instead of failing the
    training step, and writes the buffer, in order, once the sink recovers.
    The buffer is bounded (the oldest events drop first); entering and
    leaving the degraded mode each log once."""

    def __init__(self, backend, buffer_limit: int = 4096):
        self.backend = backend
        self.buffer_limit = int(buffer_limit)
        self._buffer: List[Event] = []
        self.degraded = False
        self.dropped = 0

    @property
    def name(self) -> str:
        return type(self.backend).__name__

    def write_events(self, events: Sequence[Event]) -> None:
        pending = self._buffer + list(events)
        try:
            self.backend.write_events(pending)
        except Exception as e:  # a sink's failure must not end the training step
            if len(pending) > self.buffer_limit:
                self.dropped += len(pending) - self.buffer_limit
                pending = pending[-self.buffer_limit:]
            self._buffer = pending
            if not self.degraded:
                self.degraded = True
                logger.warning(f"monitor backend {self.name} failed ({e}); degrading to "
                               f"in-memory buffering (limit {self.buffer_limit} events): "
                               "training continues")
            return
        if self.degraded:
            logger.warning(f"monitor backend {self.name} recovered; {len(self._buffer)} "
                           "buffered events flushed"
                           + (f", {self.dropped} dropped" if self.dropped else ""))
            self.degraded = False
        self._buffer = []


class MonitorMaster:
    """Fan-out to every enabled backend of ``monitor_config`` (a
    ``runtime.config.MonitorConfig``) and to ``extra_backends``; only rank 0
    writes."""

    def __init__(self, monitor_config, extra_backends: Optional[List] = None):
        self.backends: List[_SafeBackend] = [_SafeBackend(b) for b in (extra_backends or [])]
        self.enabled = comm.get_rank() == 0
        if not self.enabled:
            return
        tb = monitor_config.tensorboard
        if tb.enabled:
            try:
                self.backends.append(_SafeBackend(TensorBoardMonitor(tb.output_path,
                                                                     tb.job_name)))
            except Exception as e:  # no tensorboard package: the backend is left out
                logger.warning(f"tensorboard monitor disabled: {e}")
        wb = monitor_config.wandb
        if wb.enabled:
            try:
                self.backends.append(_SafeBackend(WandbMonitor(wb.team, wb.group, wb.project)))
            except Exception as e:  # no wandb package, or its init failed
                logger.warning(f"wandb monitor disabled: {e}")
        cs = monitor_config.csv_monitor
        if cs.enabled:
            self.backends.append(_SafeBackend(CSVMonitor(cs.output_path, cs.job_name)))
        jl = monitor_config.jsonl
        if jl.enabled:
            self.backends.append(_SafeBackend(JSONLMonitor(
                jl.output_path, jl.job_name,
                max_bytes=int(jl.rotate_mb * 2 ** 20) if jl.rotate_mb > 0 else None,
                keep=int(jl.rotate_keep))))

    @property
    def degraded(self) -> bool:
        """Whether any backend is buffering."""
        return any(b.degraded for b in self.backends)

    def write_events(self, events: Sequence[Event]) -> None:
        if not self.enabled:
            return
        for b in self.backends:
            b.write_events(events)
