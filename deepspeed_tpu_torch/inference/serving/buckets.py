"""Shape buckets (a copy of ``bucket_for``, ``default_buckets`` and
``record_compile`` from
``deepspeed_tpu/inference/serving/buckets.py``; the port imports nothing of the
JAX package).

Rounding request lengths up to a small geometric bucket set bounds the number
of distinct shapes a decode loop sees at ``log2(max/min)``; ``generate``
rounds ``max_new_tokens`` up to a bucket and slices the output back.
"""

from __future__ import annotations

import time
from typing import Sequence, Tuple


def default_buckets(lo: int = 32, hi: int = 1024) -> Tuple[int, ...]:
    """Powers of two from ``lo`` up to AND covering ``hi``."""
    if lo < 1 or hi < lo:
        raise ValueError(f"bad bucket range [{lo}, {hi}]")
    out = []
    b = 1
    while b < lo:
        b *= 2
    while b < hi:
        out.append(b)
        b *= 2
    out.append(b)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n. Raises when nothing covers ``n``."""
    if n < 0:
        raise ValueError(f"bucket_for({n})")
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    raise ValueError(f"length {n} exceeds the largest bucket "
                     f"{max(buckets)} — raise the bucket set or reject the "
                     f"request at admission")


def record_compile(compile_log: list, monitor, channel: str, kind: str,
                   shape: Tuple[int, ...]) -> None:
    """Append one program-shape record ``{"kind", "shape", "time"}`` (the
    reference's schema) and write the running count to ``monitor`` as
    ``channel`` (``Serving/compile_events``)."""
    compile_log.append({"kind": kind, "shape": tuple(int(x) for x in shape),
                        "time": time.time()})
    if monitor is not None:
        n = len(compile_log)
        monitor.write_events([(channel, n, n)])
