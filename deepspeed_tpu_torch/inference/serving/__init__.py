"""Continuous-batching serving: paged KV cache + per-step scheduler
(counterpart of ``deepspeed_tpu/inference/serving``).

- :mod:`.paging`: host-side page allocator (free list; page 0 reserved).
- :mod:`.buckets`: the shape buckets the serving engine and
  ``InferenceEngine`` share.
- :mod:`.scheduler`: host-only admit/evict/preempt over decode slots.
- :mod:`.speculate`: the speculative-decoding drafters (n-gram, draft
  model) and the adaptive draft length.
- :mod:`.engine`: the prefill, paged-decode and verify programs (the
  executor).
- :mod:`.bench`: open-loop workload, TTFT/tokens-per-second reports, and the
  static-batch baseline.

Not ported yet: the prefix index and overload control (ROADMAP.md A7), tenancy,
tensor parallelism and the fleet (A10), and the resilience hooks (A11).
"""

from .bench import (estimate_saturation_rps, make_open_loop_workload, percentile,
                    run_continuous, run_static_baseline)
from .buckets import bucket_for, default_buckets
from .engine import ServingConfig, ServingEngine
from .paging import RESERVED_PAGE, PageAllocator, pages_for
from .scheduler import AdmissionVerdict, ContinuousBatchingScheduler, Request, RequestState
from .speculate import (AdaptiveSpecK, DraftModelDrafter, Drafter, NGramDrafter, make_drafter,
                        spec_k_ladder)

__all__ = [
    "PageAllocator", "RESERVED_PAGE", "pages_for",
    "bucket_for", "default_buckets",
    "AdmissionVerdict", "ContinuousBatchingScheduler", "Request", "RequestState",
    "ServingConfig", "ServingEngine",
    "AdaptiveSpecK", "DraftModelDrafter", "Drafter", "NGramDrafter", "make_drafter",
    "spec_k_ladder",
    "estimate_saturation_rps", "make_open_loop_workload", "percentile",
    "run_continuous", "run_static_baseline",
]
