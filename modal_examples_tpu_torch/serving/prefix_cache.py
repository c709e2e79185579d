"""Prefix cache: page-granular prompt KV reuse (the radix-cache analog).

A copy of ``modal_examples_tpu/serving/prefix_cache.py`` with its metrics
series (``mtpu_prefix_cached_pages``, ``mtpu_prefix_cache_evictions_total``;
the counters ``hits``, ``misses``, ``evictions`` and ``stats()`` beside them)
and the spill hook of the tiered cache (``serving/disagg/tiered_cache.py``).
Prompts sharing a page-aligned token prefix share the physical KV pages of
that prefix.

Mechanics:
- a trie keyed by full-page token tuples; each node owns one physical page
  with a refcount of active users;
- ``acquire(tokens)`` walks the trie: matched nodes are shared (incref) and
  the caller allocates only the remaining pages; the caller then ``insert``s
  its own full prompt pages so later requests can share them;
- prefill recomputes K/V for shared positions and rewrites them into the
  shared pages. On the card the rewrite is bitwise identical (``chip_smoke``
  phase 6b holds one prefix's pages equal when written at prefill buckets 128
  and 512, from batch rows 0 and 3, and as the first chunk of a chunked
  prefill; in bf16 and in int8 pages, whose per token-head quantization is
  deterministic), so a request decoding over a shared page never sees it
  change;
- zero-ref pages stay cached until ``evict()`` reclaims them LRU-first under
  allocator pressure. Decode never writes shared pages: a sequence's writes
  start at its first non-shared page.

int8 KV: sharing is by physical page id, and the scales are indexed by the
same page ids as their int8 data, so a shared page travels with its scales.
"""

from __future__ import annotations

import threading
import time

from ..observability import metrics as _obs


class _Node:
    __slots__ = ("page_id", "refcount", "children", "last_used")

    def __init__(self, page_id: int):
        self.page_id = page_id
        self.refcount = 0
        self.children: dict[tuple, _Node] = {}
        self.last_used = time.monotonic()


class PrefixCache:
    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self._root: dict[tuple, _Node] = {}
        self._by_page: dict[int, _Node] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0  # monotonic: pages reclaimed by evict()
        #: optional spill hook (set by the engine when a TieredPrefixCache
        #: wraps this trie): called with the page ids of each eviction wave
        #: before their pages return to the allocator, so the lower tier can
        #: read the device pages while they still hold valid KV. Runs under
        #: this cache's lock and on the cache-owning thread (evict is only
        #: reached from the engine's claim path): it must not call back in.
        self.spill = None

    def _page_keys(self, tokens: list[int]) -> list[tuple]:
        n_full = len(tokens) // self.page_size
        return [
            tuple(tokens[i * self.page_size : (i + 1) * self.page_size])
            for i in range(n_full)
        ]

    # -- request lifecycle ---------------------------------------------------

    def acquire(self, tokens: list[int]) -> tuple[list[int], int]:
        """Longest shared page-aligned prefix: returns (shared page ids,
        n_shared_tokens); increfs every returned page."""
        shared: list[int] = []
        with self._lock:
            level = self._root
            for key in self._page_keys(tokens):
                node = level.get(key)
                if node is None:
                    break
                node.refcount += 1
                node.last_used = time.monotonic()
                shared.append(node.page_id)
                level = node.children
        # hit/miss accounting is the ENGINE's job at admission (acquire can
        # run multiple times for one request under OutOfPages retries)
        return shared, len(shared) * self.page_size

    def insert(
        self, tokens: list[int], page_ids: list[int], n_shared_pages: int
    ) -> tuple[list[int], list[int]]:
        """Register this request's full prompt pages beyond the shared prefix.

        ``page_ids``: the request's pages for the full prompt pages, in order
        (indices < n_shared_pages came from acquire()). Returns
        ``(final_pages, displaced)``: final_pages[i] is the canonical page for
        prompt page i (use these in the page table; release() them on
        finish); ``displaced`` are the caller's own pages superseded by a
        concurrent insert of the same content (free them immediately)."""
        keys = self._page_keys(tokens)
        final: list[int] = []
        displaced: list[int] = []
        with self._lock:
            level = self._root
            for i, key in enumerate(keys):
                node = level.get(key)
                if node is None:
                    node = _Node(page_ids[i])
                    node.refcount = 1
                    level[key] = node
                    self._by_page[node.page_id] = node
                elif i >= n_shared_pages:
                    # someone inserted this content first: adopt their page
                    node.refcount += 1
                    node.last_used = time.monotonic()
                    if page_ids[i] != node.page_id:
                        displaced.append(page_ids[i])
                else:
                    node.last_used = time.monotonic()  # our acquire()d prefix
                final.append(node.page_id)
                level = node.children
            _obs.set_prefix_cache_pages(len(self._by_page))
        return final, displaced

    def release(self, page_ids: list[int]) -> None:
        """Decref trie pages a finished request held (zero-ref pages stay
        cached until eviction)."""
        with self._lock:
            for pid in page_ids:
                node = self._by_page.get(pid)
                if node is not None and node.refcount > 0:
                    node.refcount -= 1

    def invalidate(self, page_ids: list[int]) -> None:
        """Decref AND drop these pages from the trie where possible — used
        when a prefill failed so the pages never got valid KV. (A shared node
        another live request holds stays: their own prefill rewrites it with
        correct values before any read.) Pages are NOT freed here; the caller
        owns them."""
        with self._lock:
            for pid in page_ids:
                node = self._by_page.get(pid)
                if node is not None and node.refcount > 0:
                    node.refcount -= 1
            # drop zero-ref childless nodes among them, deepest first
            for pid in reversed(page_ids):
                node = self._by_page.get(pid)
                if node is None or node.refcount > 0 or node.children:
                    continue
                parent = self._find_parent(node)
                if parent is not None:
                    children, key = parent
                    del children[key]
                    del self._by_page[pid]
            _obs.set_prefix_cache_pages(len(self._by_page))

    def _find_parent(self, target: _Node):
        def walk(children):
            for key, node in children.items():
                if node is target:
                    return children, key
                found = walk(node.children)
                if found:
                    return found
            return None

        return walk(self._root)

    # -- eviction ------------------------------------------------------------

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` zero-ref cached pages back to the
        allocator, oldest first, leaves before parents. Returns # freed.
        One trie walk collects a whole wave of evictable leaves; waves repeat
        only when removing leaves exposes evictable parents."""
        freed = 0
        with self._lock:
            while freed < n_pages:
                wave: list[tuple[dict, tuple, _Node]] = []

                def walk(children):
                    for key, node in children.items():
                        if not node.children and node.refcount == 0:
                            wave.append((children, key, node))
                        else:
                            walk(node.children)

                walk(self._root)
                if not wave:
                    break
                wave.sort(key=lambda t: t[2].last_used)
                batch: list[int] = []
                for children, key, node in wave[: n_pages - freed]:
                    del children[key]
                    del self._by_page[node.page_id]
                    batch.append(node.page_id)
                    freed += 1
                # one allocator call per wave, not one per page
                if self.spill is not None:
                    # the evicted pages' KV is still resident: the lower
                    # tier serializes it before the pages are reused
                    self.spill(batch)
                self.allocator.free(batch)
            self.evictions += freed
            _obs.set_prefix_cache_pages(len(self._by_page))
        _obs.record_prefix_evictions(freed)
        return freed

    @property
    def cached_pages(self) -> int:
        with self._lock:
            return len(self._by_page)

    def stats(self) -> dict:
        """Occupancy/effectiveness snapshot for /metrics and `tpurun top`."""
        with self._lock:
            total = self.hits + self.misses
            return {
                "cached_pages": len(self._by_page),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_ratio": self.hits / total if total else 0.0,
            }
