"""Continuous-batching serving: paged KV cache + per-step scheduler
(counterpart of ``deepspeed_tpu/inference/serving``).

- :mod:`.paging`: host-side page allocator (free list; page 0 reserved;
  copy-on-write refcounts) and the prefix index behind the prefix cache.
- :mod:`.buckets`: the shape buckets the serving engine and
  ``InferenceEngine`` share.
- :mod:`.scheduler`: host-only admit/evict/preempt over decode slots, with
  the copy-on-write prefix cache, overload control (queue and token bounds,
  two shed policies), request deadlines and dispatch-fault recovery
  (retries, block-shape quarantine, a failure budget).
- :mod:`.speculate`: the speculative-decoding drafters (n-gram, draft
  model) and the adaptive draft length.
- :mod:`.engine`: the prefill, paged-decode and verify programs (the
  executor).
- :mod:`.bench`: open-loop workload, TTFT/tokens-per-second reports, and the
  static-batch baseline.

The resilience hooks (the recovery log, the serving watchdog, page
fingerprints, the chaos plan's dispatch and allocation faults) are the
reference's. Not ported yet: SLO tiers, tenancy, the brownout ladder, tensor
parallelism, the disaggregated handoff and the fleet (ROADMAP.md A10).
"""

from .bench import (estimate_saturation_rps, make_open_loop_workload, percentile,
                    run_continuous, run_static_baseline)
from .buckets import bucket_for, default_buckets
from .engine import ServingConfig, ServingEngine
from .paging import RESERVED_PAGE, PageAllocator, PrefixIndex, pages_for, prefix_chain_hashes
from .scheduler import (SHED_POLICIES, AdmissionVerdict, ContinuousBatchingScheduler, Request,
                        RequestState, ServingFaultError)
from .speculate import (AdaptiveSpecK, DraftModelDrafter, Drafter, NGramDrafter, make_drafter,
                        spec_k_ladder)

__all__ = [
    "PageAllocator", "PrefixIndex", "RESERVED_PAGE", "pages_for", "prefix_chain_hashes",
    "bucket_for", "default_buckets",
    "AdmissionVerdict", "ContinuousBatchingScheduler", "Request", "RequestState",
    "SHED_POLICIES", "ServingFaultError",
    "ServingConfig", "ServingEngine",
    "AdaptiveSpecK", "DraftModelDrafter", "Drafter", "NGramDrafter", "make_drafter",
    "spec_k_ladder",
    "estimate_saturation_rps", "make_open_loop_workload", "percentile",
    "run_continuous", "run_static_baseline",
]
