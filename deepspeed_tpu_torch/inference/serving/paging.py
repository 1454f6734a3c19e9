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

Not ported here: the reference's chaos hook (``_alloc_fault_armed``, an
injected allocation failure) goes with the chaos harness (ROADMAP.md A11);
``PrefixIndex`` and ``prefix_chain_hashes`` go with the prefix cache (A7).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence

RESERVED_PAGE = 0


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

    def audit(self) -> Dict[str, object]:
        """Conservation invariant over the pool: every page id 1..N-1 is in
        exactly one of {free list, allocated set}, with no duplicates, no
        reserved-page escapes, and every allocated page holding >= 1 live
        reference. Returns ``{"ok", "free", "allocated", "total", "refs",
        "errors"}``; ``errors`` names each violated invariant."""
        errors: List[str] = []
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
                "total": total, "refs": sum(self._ref.values()), "errors": errors}

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
