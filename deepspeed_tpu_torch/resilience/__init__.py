"""Preemption-safe, self-healing training and serving (counterpart of
``deepspeed_tpu/resilience``):

- :mod:`.manifest`: the commit protocol (per-file checksums in
  ``MANIFEST.json``, a fsync'd ``COMMIT`` written last, an atomic
  ``latest``, verification with a precise reason, the fallback to the
  newest committed tag, quarantine), over :mod:`.checksum`'s registry;
- :mod:`.retry`: bounded exponential backoff around every durable write;
- :mod:`.chaos`: :class:`FaultPlan`, the fault injection the real code
  paths call (``DS_FAULT_PLAN``, the ``resilience.chaos`` block, or code);
- :mod:`.preemption`: SIGTERM / SIGINT -> a drain flag -> an emergency
  checkpoint -> exit :data:`PREEMPTED_EXIT_CODE`;
- :mod:`.events`: the recovery-event log (JSONL and the monitors);
- :mod:`.watchdog`: per-phase deadlines, stack dumps, stragglers;
- :mod:`.fingerprint` and :mod:`.integrity`: blockwise fingerprints of live
  state, spot checks, the majority vote, chaos bit flips;
- :mod:`.rollback`: the spike detector, rollback with a deterministic skip
  of the poisoned data, the in-memory anchor, the quantized wire's demotion.

Nothing here imports torch at module scope: the elastic agent, a supervisor
that must never initialise CUDA, uses the same machinery.
"""

from .chaos import (  # noqa: F401
    FAULT_PLAN_ENV,
    FaultPlan,
    InjectedDispatchError,
    ServingFault,
    TrainingFaults,
    fault_point,
    get_fault_plan,
    install_plan,
    sdc_flip_fault,
    serving_alloc_fault,
    serving_dispatch_fault,
    training_faults,
)
from .checksum import CHECKSUMS, checksum_file, crc32c, preferred_checksum  # noqa: F401
from .events import EVENTS_FILENAME, RecoveryLog, read_events, rotate_jsonl  # noqa: F401
from .fingerprint import (  # noqa: F401
    DEFAULT_BLOCK_BYTES,
    blockwise_fingerprints,
    fingerprint_array,
    fingerprint_bytes,
)
from .integrity import (  # noqa: F401
    IntegrityMonitor,
    SDCError,
    fingerprint_vote,
    payload_fingerprints,
    verify_payload_fingerprints,
)
from .manifest import (  # noqa: F401
    COMMIT_NAME,
    LATEST_FILE,
    MANIFEST_NAME,
    QUARANTINE_NAME,
    CheckpointCorruptionError,
    UncommittedTagError,
    commit_tag,
    committed_tags,
    invalidate_tag,
    is_committed,
    quarantine_tag,
    read_latest,
    resolve_tag_for_load,
    verify_tag,
    write_latest,
)
from .preemption import PREEMPTED_EXIT_CODE, PreemptionGuard  # noqa: F401
from .retry import RetryBudgetExceeded, RetryingWriter  # noqa: F401
from .rollback import (  # noqa: F401
    DivergenceError,
    HealthController,
    SpikeDetector,
    WireDemotionController,
)
from .watchdog import (  # noqa: F401
    SERVING_PHASES,
    STACKS_FILENAME,
    HealthWatchdog,
    allgather_host_stats,
    identify_stragglers,
)
