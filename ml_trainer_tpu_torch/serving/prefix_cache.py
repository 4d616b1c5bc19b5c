"""Radix cache of KV pages keyed on token-block prefixes.

A copy of the JAX package's ``serving/prefix_cache.py`` (plain Python,
host side), kept in the port so that the port never imports that
package.

Production traffic is prefix-heavy: the same system prompt, the same
few-shot preamble, the same retrieval header lead thousands of requests.
The contiguous engine re-prefills those tokens for every user.  This
cache maps PAGE-SIZE token blocks to already-filled KV pages, so a new
request walks the radix tree, pins the longest matching chain of pages,
and prefills only its unshared suffix (engine: the paged continuation
window).

Design (the vLLM/SGLang block-hash arrangement, as a radix trie):

* **Block granularity.**  A node keys on a tuple of exactly
  ``page_size`` tokens; its page holds those positions' K/V, valid only
  under the node's full root path (causal attention makes a position's
  K/V a function of its entire prefix — the trie path IS that prefix).
  Sharing below block granularity would require copying partial pages;
  at block granularity a divergent request simply stops matching at the
  last full block and writes its own fresh pages from there —
  copy-on-write by construction, since shared pages are never written
  (appends start on the first un-shared page boundary).
* **Namespaces (tenant isolation).**  Each ``namespace`` gets its own
  trie root; lookups never cross namespaces.  Whether a cached block
  exists is observable to a caller (TTFT, hit-rate metrics), so a
  globally shared trie is a cross-tenant side channel: any tenant could
  probe block-by-block whether another tenant's exact prompt — or
  generated output, since completed requests donate those blocks too —
  is resident.  The engine passes the request's tenant as the namespace
  by default (``prefix_scope="tenant"``); explicitly trusted
  deployments can opt back into one shared namespace
  (``prefix_scope="global"``).
* **Refcount-tied eviction.**  Cache residency holds one pool refcount
  per page.  ``evict`` drops LRU leaves (across ALL namespaces — page
  pressure is global) and only frees pages with no other holder
  (refcount 1), so a page some slot is actively attending can never be
  reclaimed out from under it.
* **Donation.**  Completed and PREEMPTED requests insert their written
  full blocks (prompt and generated tokens alike) before their slot
  releases, so a preempt-and-requeue victim resumes by re-pinning its
  own pages — resume prefill shrinks to the last partial block.

Single-threaded like the pool: only the engine loop touches it.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ml_trainer_tpu_torch.serving.kv_pool import KVPagePool


class _Node:
    __slots__ = ("block", "page", "children", "parent", "last_used")

    def __init__(self, block: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.block = block
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    """Radix trie over page-size token blocks -> refcounted KV pages,
    one root per namespace (tenant)."""

    def __init__(self, pool: KVPagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._roots: Dict[str, _Node] = {}
        self._clock = itertools.count(1)
        self._nodes = 0
        # Stats feeding serving metrics: hit rate is hit_tokens over
        # lookup_tokens (token-weighted — one long hit matters more than
        # three empty ones).
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0

    def __len__(self) -> int:
        return self._nodes

    def _root(self, namespace: str) -> _Node:
        root = self._roots.get(namespace)
        if root is None:
            root = self._roots[namespace] = _Node((), 0, None)
        return root

    # -- read ------------------------------------------------------------

    def lookup(self, tokens: np.ndarray, max_blocks: int,
               namespace: str = "",
               record: bool = True) -> Tuple[List[int], int]:
        """Longest chain cached under ``namespace`` for ``tokens`` (at
        most ``max_blocks`` full blocks).  Returns
        ``(pages, matched_tokens)`` with every returned page ALREADY
        retained for the caller (one pool count each) — the slot owns
        those references until its reset.

        ``record=False`` runs the walk without touching stats OR the
        matched nodes' LRU stamps: the engine's retry of a blocked
        ("no_memory") admission must not inflate the hit rate or re-heat
        the blocked request's own prefix pages while eviction is trying
        to relieve the very pressure blocking it."""
        toks = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        limit = min(int(max_blocks), len(toks) // ps)
        node = self._root(namespace)
        pages: List[int] = []
        now = next(self._clock) if record else 0
        for i in range(limit):
            key = tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            if record:
                child.last_used = now
            pages.append(child.page)
            node = child
        self.pool.retain(pages)
        matched = len(pages) * ps
        if record:
            self.lookup_tokens += limit * ps
            self.hit_tokens += matched
            if pages:
                self.hits += 1
            else:
                self.misses += 1
        return pages, matched

    def hit_rate(self) -> float:
        return (
            self.hit_tokens / self.lookup_tokens
            if self.lookup_tokens else 0.0
        )

    # -- write -----------------------------------------------------------

    def insert(self, tokens: np.ndarray, pages: List[int],
               namespace: str = "") -> int:
        """Register a slot's filled chain under ``namespace``: block
        ``i`` of ``tokens`` is held by ``pages[i]``.  Blocks already
        cached are skipped (the first writer wins; the duplicate page
        stays slot-owned and frees with the slot); new nodes retain
        their page for cache residency.  Returns the number of newly
        registered blocks."""
        toks = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        n_blocks = min(len(pages), len(toks) // ps)
        node = self._root(namespace)
        added = 0
        now = next(self._clock)
        for i in range(n_blocks):
            key = tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                page = pages[i]
                if page == 0:
                    break  # trash can never carry cacheable K/V
                self.pool.retain([page])
                child = _Node(key, page, node)
                node.children[key] = child
                self._nodes += 1
                added += 1
            child.last_used = now
            node = child
        return added

    # -- eviction --------------------------------------------------------

    def evict(self, want_pages: int) -> int:
        """Free up to ``want_pages`` pool pages by dropping LRU leaves
        (across every namespace) whose pages have no other holder
        (refcount 1 — cache residency only).  One heapify over the
        current leaves, then each freed node is O(log n): a dropped
        node's parent is pushed as it becomes a leaf, so a deep chain
        drains in a single pass instead of one full leaf rescan per
        tree level.  Returns pages actually freed."""
        freed = 0
        # Refcounts of surviving nodes cannot change mid-evict (single
        # threaded; every node holds a distinct page), so filtering
        # pinned leaves up front is safe — they stay pinned all call.
        heap = [
            (n.last_used, n.page, n)
            for n in self._leaves()
            if self.pool.refcount[n.page] == 1
        ]
        heapq.heapify(heap)
        while heap and freed < want_pages:
            _, _, node = heapq.heappop(heap)
            parent = node.parent
            self._drop(node)
            freed += self.pool.release([node.page])
            if (
                parent.parent is not None
                and not parent.children
                and self.pool.refcount[parent.page] == 1
            ):
                heapq.heappush(
                    heap, (parent.last_used, parent.page, parent)
                )
        return freed

    def _leaves(self):
        stack = [
            n for root in self._roots.values()
            for n in root.children.values()
        ]
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    def _drop(self, node: _Node) -> None:
        del node.parent.children[node.block]
        self._nodes -= 1
