"""Page-granular KV-cache bookkeeping: the refcounted page pool.

The port's own copy of `PagePool` from the reference package's
`serve/paging.py`. Pure-python/numpy state (no torch): the engine asks the
pool for page ids and keeps the device-side pools (`models/decoding.py`
paged leaves) in sync. A *page* is `page_size` consecutive token rows of
every paged KV leaf; a request's logical page i lives at physical page
`page_table[i]` in every layer's pool.

Refcount discipline:

- a live request holds one reference per page in its table;
- a page with refcount 0 is on the free list. `decref` below zero raises —
  double-frees are bugs, not warnings.

Copy-on-write: writing token rows into a page with refcount > 1 must first
`cow_split` it — allocate a fresh exclusive page, drop one reference on the
shared one — and copy the device rows. Without prefix sharing (the only
mode the port serves so far) no page is ever shared, so no split happens;
the contract stays for the prefix caches (`RadixPrefixCache`,
`ChainPrefixCache`, `SpillTier`), which come with ROADMAP queue A item 13.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PagePool"]


class PagePool:
    """Fixed set of `num_pages` refcounted pages of `page_size` token rows.

    `chaos` (the reference's fault injection) is refused until the chaos
    slice (ROADMAP queue A item 13)."""

    def __init__(self, num_pages: int, page_size: int, chaos=None):
        assert num_pages >= 1 and page_size >= 1
        if chaos is not None:
            raise NotImplementedError(
                "PagePool(chaos=...): fault injection comes with the chaos "
                "slice, ROADMAP queue A item 13")
        self.num_pages = num_pages
        self.page_size = page_size
        self.ref = np.zeros((num_pages,), np.int32)
        # LIFO free list: reuse the hottest page first
        self._free = list(range(num_pages - 1, -1, -1))
        self.peak_in_use = 0
        self.cow_splits = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self) -> int:
        """Take a free page (refcount 1). Raises when exhausted — callers
        gate allocations on reservations, so running dry here is a
        bookkeeping bug."""
        if not self._free:
            raise RuntimeError("page pool exhausted (reservation bug)")
        pid = self._free.pop()
        assert self.ref[pid] == 0
        self.ref[pid] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pid

    def incref(self, pid: int) -> None:
        assert self.ref[pid] > 0, f"incref of free page {pid}"
        self.ref[pid] += 1

    def decref(self, pid: int) -> None:
        if self.ref[pid] <= 0:
            raise RuntimeError(f"double-free of page {pid}")
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self._free.append(pid)

    def cow_split(self, pid: int) -> int:
        """Resolve a write to shared page `pid`: allocate an exclusive
        replacement and release one reference on the original. The caller
        must copy the device rows pid -> new before writing."""
        assert self.ref[pid] >= 2, f"cow_split of exclusive page {pid}"
        new = self.alloc()
        self.decref(pid)
        self.cow_splits += 1
        return new

    def check(self) -> None:
        """Invariant audit (used by the property tests): every page is
        either free with refcount 0 or in use with refcount > 0, and the
        free list holds no duplicates."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page on free list"
        for pid in range(self.num_pages):
            if pid in free:
                assert self.ref[pid] == 0, f"freed page {pid} still referenced"
            else:
                assert self.ref[pid] > 0, f"leaked page {pid} (ref 0, not free)"
