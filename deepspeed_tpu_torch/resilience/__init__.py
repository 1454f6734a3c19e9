"""Crash-consistent checkpoints (counterpart of ``deepspeed_tpu/resilience``):
the commit protocol (:mod:`.manifest`), its checksums (:mod:`.checksum`)
and bounded-retry file I/O (:mod:`.retry`). Fault injection, preemption,
the watchdog, live-state integrity and rollback are ROADMAP.md A11.
"""

from .checksum import CHECKSUMS, checksum_file, crc32c, preferred_checksum  # noqa: F401
from .manifest import (  # noqa: F401
    COMMIT_NAME,
    LATEST_FILE,
    MANIFEST_NAME,
    CheckpointCorruptionError,
    UncommittedTagError,
    commit_tag,
    committed_tags,
    invalidate_tag,
    is_committed,
    read_latest,
    resolve_tag_for_load,
    verify_tag,
    write_latest,
)
from .retry import RetryBudgetExceeded, RetryingWriter  # noqa: F401
