"""Rank-filtered logging (counterpart of ``deepspeed_tpu/utils/logging.py``).

A process-wide logger plus helpers that emit only on selected ranks, so a
multi-process job does not print world_size copies of every line.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Iterable, Optional

_LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


def _create_logger(name: str = "deepspeed_tpu_torch",
                   level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    if not lg.handlers:
        lg.setLevel(level)
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(_LOG_FORMAT))
        lg.addHandler(handler)
        lg.propagate = False
    return lg


logger = _create_logger()


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` only on the given process ranks (default: rank 0 only).

    ``ranks=[-1]`` logs on every process.
    """
    ranks = list(ranks) if ranks is not None else [0]
    if -1 in ranks or _process_index() in ranks:
        logger.log(level, message)


def warning_once(message: str, _seen=set()) -> None:  # noqa: B006 - intentional cache
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)
