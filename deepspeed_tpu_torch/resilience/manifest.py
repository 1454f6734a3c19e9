"""The crash-consistent checkpoint commit protocol (counterpart of
``deepspeed_tpu/resilience/manifest.py``; the file names, JSON layouts and
``MANIFEST_VERSION`` are the reference's, so each package verifies the
other's tags).

A tag directory is **committed** by writing, in order:

1. the content files (``state/arrays/<i>.npy``, ``state.msgpack``,
   ``meta.json``, ...), each atomically (tmp + ``os.replace``), then
   fsync'd;
2. ``MANIFEST.json``: the relative path, byte size and checksum of every
   content file (fsync'd);
3. ``COMMIT``: the manifest's own size and checksum, written last and
   fsync'd, then the directory fsync'd.

``latest`` in the parent directory is repointed after the commit,
atomically. So a tag without ``COMMIT`` never finished writing and is
rejected; a tag with it can be byte-verified file by file, and a mismatch
names the file and the reason; and ``latest`` points at the previous
committed tag or at the new one. A kill anywhere in a save loses at most
one save interval: :func:`resolve_tag_for_load` walks the committed tags
newest first and returns the first that verifies.

A tag the reference quarantined (a ``QUARANTINED`` marker) is rejected
here too; writing the marker (``quarantine_tag``) and the fault points of
the reference's chaos tests are ROADMAP.md A11.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

from ..utils.logging import logger
from .checksum import CHECKSUMS, checksum_file, preferred_checksum
from .retry import RetryingWriter

MANIFEST_NAME = "MANIFEST.json"
COMMIT_NAME = "COMMIT"
QUARANTINE_NAME = "QUARANTINED"
LATEST_FILE = "latest"
MANIFEST_VERSION = 1

# protocol metadata, not checkpoint content
_NON_CONTENT = {MANIFEST_NAME, COMMIT_NAME, QUARANTINE_NAME}


class CheckpointCorruptionError(RuntimeError):
    """A tag failed verification; the message names the file and the reason."""

    def __init__(self, tag_dir: str, reason: str):
        self.tag_dir = tag_dir
        self.reason = reason
        super().__init__(f"checkpoint {tag_dir}: {reason}")


class UncommittedTagError(CheckpointCorruptionError):
    """The tag has no ``COMMIT`` marker (the save never finished) or is
    quarantined."""


# ------------------------------------------------------------- manifest build
def _content_files(tag_dir: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(tag_dir):
        for name in files:
            if name in _NON_CONTENT or name.endswith(".tmp"):
                continue
            out.append(os.path.relpath(os.path.join(root, name), tag_dir))
    return sorted(out)


def build_manifest(tag_dir: str, tag: Optional[str] = None,
                   algo: Optional[str] = None) -> Dict:
    algo = algo or preferred_checksum()
    files: Dict[str, Dict] = {}
    for rel in _content_files(tag_dir):
        crc, n = checksum_file(os.path.join(tag_dir, rel), algo)
        files[rel] = {"bytes": n, "checksum": f"{crc:08x}"}
    return {
        "manifest_version": MANIFEST_VERSION,
        "tag": tag or os.path.basename(os.path.normpath(tag_dir)),
        "checksum": algo,
        "created_unix_time": time.time(),
        "files": files,
    }


def commit_tag(tag_dir: str, writer: Optional[RetryingWriter] = None,
               tag: Optional[str] = None) -> Dict:
    """Phases 2-3 over an already-written tag directory: fsync the content,
    write the manifest, write ``COMMIT``. Returns the manifest."""
    writer = writer or RetryingWriter()
    # the content was written atomically with the fsync deferred: flush it
    # (and its directories) before the manifest promises anything about it
    dirs = {tag_dir}
    for rel in _content_files(tag_dir):
        writer.fsync_file(os.path.join(tag_dir, rel))
        dirs.add(os.path.dirname(os.path.join(tag_dir, rel)))
    for d in dirs:
        writer.fsync_dir(d)
    manifest = build_manifest(tag_dir, tag=tag)
    manifest_bytes = json.dumps(manifest, indent=1, sort_keys=True).encode()
    writer.write_bytes(os.path.join(tag_dir, MANIFEST_NAME), manifest_bytes)
    algo = manifest["checksum"]
    commit = {
        "tag": manifest["tag"],
        "checksum": algo,
        "manifest_bytes": len(manifest_bytes),
        "manifest_checksum": f"{CHECKSUMS[algo](manifest_bytes):08x}",
        "committed_unix_time": time.time(),
    }
    writer.write_bytes(os.path.join(tag_dir, COMMIT_NAME),
                       json.dumps(commit, sort_keys=True).encode())
    return manifest


def invalidate_tag(tag_dir: str, writer: Optional[RetryingWriter] = None) -> None:
    """Revoke a tag's commit before it is rewritten in place (a second save
    at the same step), so that a kill during the rewrite cannot leave the
    old ``COMMIT`` blessing a mix of old and new files."""
    writer = writer or RetryingWriter()
    removed = False
    for name in (COMMIT_NAME, MANIFEST_NAME, QUARANTINE_NAME):
        path = os.path.join(tag_dir, name)
        if os.path.exists(path):
            writer.call(os.remove, path, describe=f"remove {name}")
            removed = True
    if removed:
        writer.fsync_dir(tag_dir)


# ------------------------------------------------------------------ verify
def is_committed(tag_dir: str) -> bool:
    return (os.path.exists(os.path.join(tag_dir, COMMIT_NAME))
            and not os.path.exists(os.path.join(tag_dir, QUARANTINE_NAME)))


def verify_tag(tag_dir: str, deep: bool = True) -> Dict:
    """Verify a tag against its manifest and return the manifest; raise
    :class:`CheckpointCorruptionError` with the reason otherwise.
    ``deep=False`` checks existence and byte sizes only; ``deep=True`` also
    the checksum of every content file."""
    if not os.path.isdir(tag_dir):
        raise CheckpointCorruptionError(tag_dir, "tag directory does not exist")
    if os.path.exists(os.path.join(tag_dir, QUARANTINE_NAME)):
        try:
            with open(os.path.join(tag_dir, QUARANTINE_NAME)) as f:
                why = json.load(f).get("reason", "unknown")
        except (ValueError, OSError):
            why = "unknown"
        raise UncommittedTagError(tag_dir, f"tag is quarantined (reason: {why})")
    commit_path = os.path.join(tag_dir, COMMIT_NAME)
    if not os.path.exists(commit_path):
        raise UncommittedTagError(
            tag_dir, "no COMMIT marker: the save never completed "
            "(crash/preemption mid-checkpoint); this tag must not be loaded")
    try:
        with open(commit_path, "rb") as f:
            commit = json.loads(f.read().decode())
    except (ValueError, OSError) as e:
        raise CheckpointCorruptionError(tag_dir, f"COMMIT marker unreadable: {e}")
    manifest_path = os.path.join(tag_dir, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        raise CheckpointCorruptionError(tag_dir, "COMMIT present but MANIFEST.json missing")
    with open(manifest_path, "rb") as f:
        raw = f.read()
    algo = commit.get("checksum", "crc32c")
    if algo not in CHECKSUMS:
        raise CheckpointCorruptionError(
            tag_dir, f"COMMIT records unknown checksum algorithm {algo!r}; "
            f"this build knows {sorted(CHECKSUMS)}")
    if len(raw) != int(commit.get("manifest_bytes", -1)):
        raise CheckpointCorruptionError(
            tag_dir, f"MANIFEST.json is {len(raw)} bytes but COMMIT recorded "
            f"{commit.get('manifest_bytes')} (truncated or rewritten manifest)")
    actual_crc = f"{CHECKSUMS[algo](raw):08x}"
    if actual_crc != commit.get("manifest_checksum"):
        raise CheckpointCorruptionError(
            tag_dir, f"MANIFEST.json {algo} {actual_crc} != committed "
            f"{commit.get('manifest_checksum')}")
    manifest = json.loads(raw.decode())
    for rel, entry in manifest["files"].items():
        path = os.path.join(tag_dir, rel)
        if not os.path.exists(path):
            raise CheckpointCorruptionError(tag_dir, f"content file {rel!r} missing")
        size = os.path.getsize(path)
        if size != int(entry["bytes"]):
            raise CheckpointCorruptionError(
                tag_dir, f"content file {rel!r} is {size} bytes, manifest "
                f"says {entry['bytes']} (truncated/torn write)")
        if deep:
            crc, _ = checksum_file(path, algo)
            if f"{crc:08x}" != entry["checksum"]:
                raise CheckpointCorruptionError(
                    tag_dir, f"content file {rel!r} {algo} {crc:08x} != "
                    f"manifest {entry['checksum']} (corrupted shard)")
    return manifest


# ------------------------------------------------------------- tag resolution
_STEP_RE = re.compile(r"(\d+)$")


def _tag_sort_key(save_dir: str, tag: str) -> Tuple[int, float]:
    m = _STEP_RE.search(tag)
    step = int(m.group(1)) if m else -1
    try:
        mtime = os.path.getmtime(os.path.join(save_dir, tag, COMMIT_NAME))
    except OSError:
        mtime = 0.0
    return (step, mtime)


def committed_tags(save_dir: str) -> List[str]:
    """Committed, unquarantined tags, oldest first."""
    if not os.path.isdir(save_dir):
        return []
    tags = [t for t in os.listdir(save_dir) if is_committed(os.path.join(save_dir, t))]
    return sorted(tags, key=lambda t: _tag_sort_key(save_dir, t))


def read_latest(save_dir: str) -> Optional[str]:
    path = os.path.join(save_dir, LATEST_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip() or None


def write_latest(save_dir: str, tag: str, writer: Optional[RetryingWriter] = None) -> None:
    """Atomically repoint ``latest`` (tmp + fsync + rename + directory fsync)."""
    (writer or RetryingWriter()).write_bytes(os.path.join(save_dir, LATEST_FILE), tag.encode())


def resolve_tag_for_load(save_dir: str, tag: Optional[str] = None, deep: bool = True
                         ) -> Tuple[Optional[str], List[Tuple[str, str]]]:
    """The tag to load. An explicit ``tag`` is verified, with no fallback:
    the caller asked for that state. ``tag=None`` tries ``latest``, then
    every other committed tag newest first, and returns the first that
    verifies with the ``(tag, reason)`` list of those rejected; ``(None,
    [])`` where the directory holds no checkpoint."""
    if tag is not None:
        verify_tag(os.path.join(save_dir, tag), deep=deep)
        return tag, []
    rejected: List[Tuple[str, str]] = []
    candidates: List[str] = []
    latest = read_latest(save_dir)
    if latest is not None:
        candidates.append(latest)
    for t in reversed(committed_tags(save_dir)):
        if t not in candidates:
            candidates.append(t)
    if not candidates:
        return None, []
    for t in candidates:
        try:
            verify_tag(os.path.join(save_dir, t), deep=deep)
            return t, rejected
        except CheckpointCorruptionError as e:
            logger.error(f"checkpoint tag {t!r} rejected: {e.reason}")
            rejected.append((t, e.reason))
    raise CheckpointCorruptionError(
        save_dir, "no loadable checkpoint: every candidate tag failed verification: "
        + "; ".join(f"{t}: {r}" for t, r in rejected))


__all__ = [
    "CheckpointCorruptionError", "UncommittedTagError",
    "build_manifest", "commit_tag", "verify_tag", "is_committed", "invalidate_tag",
    "committed_tags", "read_latest", "write_latest", "resolve_tag_for_load",
    "MANIFEST_NAME", "COMMIT_NAME", "QUARANTINE_NAME", "LATEST_FILE", "MANIFEST_VERSION",
]
