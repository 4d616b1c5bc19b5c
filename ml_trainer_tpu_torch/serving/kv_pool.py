"""Paged KV memory: fixed-size pages, per-slot page tables, refcounts.

A copy of the JAX package's ``serving/kv_pool.py`` (plain numpy, host
side), kept in the port so that the port never imports that package.

The contiguous slot cache reserves ``max_len`` positions per slot
whether a request uses 12 tokens or 500 — concurrency is capped at
``max_batch × max_len`` memory and nothing can be shared.  This module
is the HOST side of the paged replacement (the device side is the
page-table gather/scatter path in ``models/layers.py``):

* **Pages.**  K/V live in one pool of ``num_pages`` fixed-size pages
  per attention layer (``[N, H, page_size, D]`` on device).  Page 0 is
  the TRASH page: no live slot ever maps to it, so inactive rows and
  out-of-range writes land there harmlessly (the device path clips into
  the table; the all-zero table of a freed slot resolves to trash).
* **Page tables.**  Each slot owns a row of ``page_table``
  ``[max_batch, pages_per_slot]`` mapping logical position ``i`` to
  page ``table[slot, i // page_size]``.  The table is HOST-owned (numpy)
  and uploaded to the device cache only when it changes (``dirty``) —
  page allocation is a host decision, and the decode step just reads
  the table.
* **Refcounts.**  A page's count is the number of slots referencing it
  plus one if the prefix cache (prefix_cache.py) holds it.  ``release``
  returns a page to the free list only at zero, which is what lets N
  requests attend one shared system-prompt page safely.

Single-threaded by design, like the engine that owns it: the serving
loop is the only caller (thread-safe admission lives in the scheduler).
"""

from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np

# Refcount sentinel pinning the trash page: never allocated, never freed.
_TRASH_PIN = 1 << 30


class KVPagePool:
    """Host-side page allocator + per-slot page tables.

    ``num_pages`` counts the whole pool INCLUDING the trash page, so the
    allocatable capacity is ``num_pages - 1``.
    """

    def __init__(self, num_pages: int, page_size: int, max_len: int,
                 max_batch: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({page_size})"
            )
        self.pages_per_slot = max_len // page_size
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is reserved as trash), "
                f"got {num_pages}"
            )
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.page_table = np.zeros(
            (max_batch, self.pages_per_slot), np.int32
        )
        # Pages referenced per slot, logical order (shared prefix pages
        # first, then the slot's own) — the release list on slot free.
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.refcount = np.zeros(self.num_pages, np.int64)
        self.refcount[0] = _TRASH_PIN
        self._free: collections.deque = collections.deque(
            range(1, self.num_pages)
        )
        # Host table changed since the last device upload (slot freed /
        # pages appended mid-decode): the engine re-uploads before the
        # next dispatch so a recycled page can never be written through a
        # stale device table.
        self.dirty = True

    # -- capacity --------------------------------------------------------

    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` positions."""
        return -(-int(tokens) // self.page_size)

    # -- refcounted page lifecycle ---------------------------------------

    def allocate(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` fresh pages (refcount 1 each), or None — all or
        nothing, so a half-allocated request never wedges the pool."""
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self.refcount[p] = 1
        return pages

    def retain(self, pages) -> None:
        for p in pages:
            if p == 0:
                raise ValueError("page 0 is the trash page; never retained")
            if self.refcount[p] <= 0:
                raise ValueError(f"retain of dead page {p}")
            self.refcount[p] += 1

    def release(self, pages) -> int:
        """Drop one reference per page; zero-count pages return to the
        free list.  Returns how many pages were actually freed."""
        freed = 0
        for p in pages:
            if p == 0 or self.refcount[p] >= _TRASH_PIN:
                raise ValueError(f"release of reserved page {p}")
            if self.refcount[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    # -- slot binding ----------------------------------------------------

    def bind_slot(self, slot: int, pages: List[int]) -> None:
        """Point ``slot`` at ``pages`` (logical order, already counted —
        fresh from ``allocate`` or pinned via ``retain``).  Entries past
        the chain stay 0 (trash)."""
        if self.slot_pages[slot]:
            raise ValueError(f"slot {slot} already bound")
        if len(pages) > self.pages_per_slot:
            raise ValueError(
                f"{len(pages)} pages exceed pages_per_slot "
                f"({self.pages_per_slot})"
            )
        self.slot_pages[slot] = list(pages)
        self.page_table[slot] = 0
        self.page_table[slot, : len(pages)] = pages
        self.dirty = True

    def extend_slot(self, slot: int, pages: List[int]) -> None:
        """Append freshly allocated pages to a slot's chain (decode grew
        past a page boundary)."""
        have = len(self.slot_pages[slot])
        if have + len(pages) > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {have}+{len(pages)} pages exceed "
                f"pages_per_slot ({self.pages_per_slot})"
            )
        self.slot_pages[slot].extend(pages)
        self.page_table[slot, have: have + len(pages)] = pages
        self.dirty = True

    def slot_page_count(self, slot: int) -> int:
        return len(self.slot_pages[slot])

    def reset_slot(self, slot: int) -> int:
        """Unbind ``slot`` (finished / expired / preempted / errored):
        release every page it referenced, zero its table row.  Idempotent
        — a second reset of a free slot is a no-op.  Returns pages
        freed (refcount reached zero)."""
        pages, self.slot_pages[slot] = self.slot_pages[slot], []
        if not pages:
            return 0
        self.page_table[slot] = 0
        self.dirty = True
        return self.release(pages)
