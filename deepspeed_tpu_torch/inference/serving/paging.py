"""Fixed-size KV page allocator (host side), with copy-on-write refcounts.

A copy of ``RESERVED_PAGE``, ``pages_for`` and ``PageAllocator`` from
``deepspeed_tpu/inference/serving/paging.py`` (the port imports nothing of the
JAX package). The device holds one page pool per layer
(``models/gpt.init_paged_cache``); this allocator hands out pool page ids.
Page 0 is reserved as the sink that inactive decode slots and dropped
scatter lanes write into, so a block-table entry of 0 always names a valid
(garbage) page, which the paged kernel may be pointed at past a row's
length.

Allocation is all-or-nothing, frees are checked (over-free and foreign pages
raise), the free list is LIFO, and every allocated page carries a refcount
(``share`` takes a reference, ``free`` drops one, ``materialize`` is the
copy-on-write trigger). :meth:`PageAllocator.audit` checks the conservation
invariant.

:class:`PrefixIndex` is the host-side lookup behind the copy-on-write
prefix cache: a hash chain over page-sized prompt token blocks
(:func:`prefix_chain_hashes`; block j's key commits to blocks 0..j) mapping
each chain hash to the physical page that holds that block's KV, so requests
that open with the same page-aligned tokens (a system prompt) share pages.

An armed chaos plan's ``alloc_fail_at`` makes the Nth ``alloc`` call report
exhaustion (:func:`_alloc_fault_armed`), so admission and growth degrade as
they do under real pool pressure; :meth:`PageAllocator.audit` re-fingerprints
every stamped shared page when it is handed the stamps and the executor's
fingerprint function.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence

import numpy as np

from ...resilience.chaos import serving_alloc_fault

RESERVED_PAGE = 0


def _alloc_fault_armed(index: int) -> bool:
    """Whether an armed fault plan fails alloc call ``index``."""
    return serving_alloc_fault(index)


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV entries."""
    if tokens <= 0:
        return 0
    return -(-tokens // page_size)


class PageAllocator:
    """Refcounted free-list allocator over a pool of ``num_pages`` pages
    (ids ``1 .. num_pages-1``; page 0 reserved)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved sink), got {num_pages}")
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}  # page id -> live references
        self._alloc_calls = 0  # the chaos plan's alloc index
        self._alloc_faults = 0  # calls the chaos plan failed

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        """UNIQUE physical pages outstanding (a shared page counts once)."""
        return len(self._ref)

    @property
    def allocated_ids(self) -> FrozenSet[int]:
        return frozenset(self._ref)

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 if not allocated)."""
        return self._ref.get(int(page), 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages (each at refcount 1), or None (and allocate
        nothing) if the pool cannot cover the request."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        idx = self._alloc_calls
        self._alloc_calls += 1
        if _alloc_fault_armed(idx):
            self._alloc_faults += 1
            return None  # chaos: exhaustion through the normal path
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Take one extra reference on each page. Sharing an unallocated or
        reserved page raises."""
        pages = [int(p) for p in pages]
        for p in pages:
            if p == RESERVED_PAGE:
                raise ValueError("sharing the reserved sink page 0")
            if p not in self._ref:
                raise ValueError(f"sharing unallocated page {p}")
        for p in pages:
            self._ref[p] += 1

    def materialize(self, page: int) -> Optional[int]:
        """Copy-on-write trigger: make ``page`` privately writable. With one
        reference the page is returned as it is; shared, the caller's
        reference is traded for a fresh page (the caller copies the device
        bytes). Returns None, keeping the reference, when the pool is empty."""
        page = int(page)
        if self._ref.get(page, 0) == 0:
            raise ValueError(f"materializing unallocated page {page}")
        if self._ref[page] == 1:
            return page
        fresh = self.alloc(1)
        if fresh is None:
            return None
        self._ref[page] -= 1
        return fresh[0]

    def audit(self, expected_fingerprints: Optional[Dict[int, int]] = None,
              fingerprint_fn: Optional[Callable[[Sequence[int]], List[int]]] = None
              ) -> Dict[str, object]:
        """Conservation invariant over the pool: every page id 1..N-1 is in
        exactly one of {free list, allocated set}, with no duplicates, no
        reserved-page escapes, and every allocated page holding >= 1 live
        reference. Given ``expected_fingerprints`` (page -> its stamp) and
        ``fingerprint_fn`` (pages -> their fingerprints now), every stamped
        page with more than one reference is re-fingerprinted and a mismatch
        fails the audit by name. Returns ``{"ok", "free", "allocated",
        "total", "refs", "errors", "fingerprinted", "mismatches"}``."""
        errors: List[str] = []
        fingerprinted = 0
        fp_mismatches: List[int] = []
        if expected_fingerprints and fingerprint_fn is not None:
            shared = sorted(p for p, c in self._ref.items()
                            if c > 1 and p in expected_fingerprints)
            if shared:
                fingerprinted = len(shared)
                fp_mismatches = [p for p, fp in zip(shared, fingerprint_fn(shared))
                                 if int(fp) != int(expected_fingerprints[p])]
                if fp_mismatches:
                    errors.append(f"shared-page fingerprint mismatch (silent corruption of "
                                  f"immutable pages): {fp_mismatches}")
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            errors.append("duplicate ids in the free list")
        overlap = free_set & set(self._ref)
        if overlap:
            errors.append(f"pages both free and allocated: {sorted(overlap)}")
        if RESERVED_PAGE in free_set or RESERVED_PAGE in self._ref:
            errors.append("reserved sink page 0 escaped into the pool")
        bad = [p for p in free_set | set(self._ref) if not (1 <= p < self.num_pages)]
        if bad:
            errors.append(f"page ids outside the pool: {sorted(bad)}")
        leaked_refs = sorted(p for p, c in self._ref.items() if c < 1)
        if leaked_refs:
            errors.append(f"allocated pages with refcount < 1 (leaked reference "
                          f"accounting): {leaked_refs}")
        total = self.num_pages - 1
        if len(free_set) + len(self._ref) != total:
            errors.append(f"conservation broken: free {len(free_set)} + unique "
                          f"allocated {len(self._ref)} != total {total}")
        return {"ok": not errors, "free": len(free_set), "allocated": len(self._ref),
                "total": total, "refs": sum(self._ref.values()), "errors": errors,
                "fingerprinted": fingerprinted, "mismatches": fp_mismatches}

    def free(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; pages whose last reference died go
        back to the free list and are returned. Over-freeing raises."""
        released: List[int] = []
        for p in pages:
            p = int(p)
            if p == RESERVED_PAGE:
                raise ValueError("freeing the reserved sink page 0")
            if p not in self._ref:
                raise ValueError(f"double-free or foreign page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)
                released.append(p)
        return released


# ---------------------------------------------------------------- prefix index
def prefix_chain_hashes(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Hash chain over page-sized token blocks (blake2b, 16-byte digests of
    the int64 tokens): entry j commits to blocks 0..j, so equal hashes mean
    equal page-aligned prefixes. Only full blocks take part: a partial tail
    page would be written at different offsets by different requests."""
    toks = np.asarray(tokens, np.int64)
    out: List[bytes] = []
    h = hashlib.blake2b(digest_size=16)
    for j in range(len(toks) // page_size):
        h.update(toks[j * page_size:(j + 1) * page_size].tobytes())
        out.append(h.digest())
    return out


class PrefixIndex:
    """Map from prompt-prefix hash chains to the physical pages holding their
    KV. Entries are registered after a prefill wrote the page (the first
    writer wins) and forgotten when the page's last reference dies
    (``PageAllocator.free`` returns the released pages), so a recycled page
    never serves a stale prefix."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._by_hash: Dict[bytes, int] = {}
        self._by_page: Dict[int, bytes] = {}
        self.hits = 0      # pages served from the index
        self.misses = 0    # lookups that stopped short of their full blocks

    def __len__(self) -> int:
        return len(self._by_hash)

    def lookup(self, tokens: Sequence[int]) -> List[int]:
        """Pages of the longest indexed page-aligned prefix of ``tokens``
        (the chain stops at its first miss), counted in the statistics."""
        hashes = prefix_chain_hashes(tokens, self.page_size)
        pages = self.lookup_chain(hashes)
        self.count(hashes, pages)
        return pages

    def count(self, hashes: Sequence[bytes], pages: Sequence[int]) -> None:
        """Record one lookup's outcome; the scheduler calls it only at the
        admission that proceeds, so retries under head-of-line blocking
        count once."""
        self.hits += len(pages)
        if len(pages) < len(hashes):
            self.misses += 1

    def lookup_chain(self, hashes: Sequence[bytes]) -> List[int]:
        """:meth:`lookup` over a precomputed chain, without counting."""
        pages: List[int] = []
        for h in hashes:
            page = self._by_hash.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def register(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index the full blocks of ``tokens`` against ``pages`` (the owning
        request's table pages, in order). An existing entry wins, and a page
        already indexed under another chain is skipped. Returns the number
        of new entries."""
        added = 0
        for j, h in enumerate(prefix_chain_hashes(tokens, self.page_size)):
            if j >= len(pages):
                break
            page = int(pages[j])
            if page == RESERVED_PAGE or h in self._by_hash or page in self._by_page:
                continue
            self._by_hash[h] = page
            self._by_page[page] = h
            added += 1
        return added

    def forget(self, released_pages: Sequence[int]) -> None:
        """Drop the entries of pages whose storage was just recycled."""
        for p in released_pages:
            h = self._by_page.pop(int(p), None)
            if h is not None:
                self._by_hash.pop(h, None)
