"""The tiered prefix cache: HBM -> host RAM -> ``Volume`` spill and
promote, a copy of ``modal_examples_tpu/serving/disagg/tiered_cache.py``.

The trie (:class:`~..prefix_cache.PrefixCache`) keeps shared prompt-prefix
KV on the card until allocator pressure evicts it. This tier stack catches
the evictions:

- **host tier**: evicted prefix pages are serialized with the disagg wire's
  machinery (:func:`~.transport.extract_pages`, one gather and one
  device-to-host copy per eviction wave, then
  :func:`~.transport.serialize_block` per page, crc32s included) into a
  bounded host-RAM LRU (``MTPU_TIER_HOST_BYTES``, 64 MiB by default). int8
  pages spill at about half the bf16 bytes, so the budget holds about twice
  the blocks.
- **volume tier**: host-LRU overflow demotes to the fleet-wide
  :class:`~..prefix_store.SharedPrefixStore` (content-addressed block files
  on a :class:`~...storage.volume.Volume`), so warm prefixes survive replica
  churn and cross replicas. With ``shared=True`` the store adds rendezvous
  spill ownership and dedup; without it, the store is this replica's
  private single-writer tier.

Keys are chained content hashes (:func:`~.transport.chain_hashes`), so a
page's identity encodes its whole prefix.

Promotion happens inside the engine's claim path: after the trie's
longest-prefix hit, consecutive lower-tier blocks each get a fresh page,
their bytes are adopted (:func:`~.transport.adopt_pages`: ``index_copy_``
along the page axis, bit-exact for bf16 and int8), and the page joins the
trie as a normal insert. Correctness never depends on promotion: prefill
recomputes and rewrites the promoted pages, as it does trie-shared pages
(on the card the rewrite is bitwise identical, bf16 and int8 pages, which
``chip_smoke.py`` phase 16a checks). So the tiers save pages, not prefill
time.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from ...faults import inject as _inject
from ...observability import metrics as _obs
from ...observability import reqtrace as _rt
from ...utils.log import get_logger
from .transport import (
    PageBlock,
    TransportError,
    adopt_pages,
    chain_hashes,
    deserialize_block,
    extract_pages,
    serialize_block,
)

_log = get_logger("tiered_cache")

#: default host-RAM budget for spilled blocks (MTPU_TIER_HOST_BYTES env)
DEFAULT_HOST_BYTES = 64 * 1024 * 1024


class TieredPrefixCache:
    """Spill/promote tiers below one engine's prefix trie.

    Wired by the engine (``tiered_prefix=`` kwarg): ``prefix_cache.spill``
    points at :meth:`spill_pages`, and the claim path calls
    :meth:`register` (after trie insert) and :meth:`promote` (after trie
    acquire). All entry points run on the cache-owning thread (the engine's
    scheduler thread, on its stream), so the device reads and writes here
    are ordered against the decode block in flight.
    """

    def __init__(
        self,
        cache,
        prefix_cache,
        *,
        host_bytes: int | None = None,
        volume=None,
        volume_prefix: str = "kv-tier",
        store=None,
        replica: str | None = None,
        shared: bool = False,
    ):
        self.cache = cache
        self.prefix_cache = prefix_cache
        if host_bytes is None:
            try:
                host_bytes = int(
                    os.environ.get("MTPU_TIER_HOST_BYTES", "")
                    or DEFAULT_HOST_BYTES
                )
            except ValueError:
                host_bytes = DEFAULT_HOST_BYTES
        self.host_bytes_budget = int(host_bytes)
        # the volume tier IS a prefix store: pass a
        # SharedPrefixStore directly (the fleet-shared tier), or a Volume
        # (a store is built over it — shared=True joins the fleet-wide
        # store, default is this replica's private single-writer tier)
        if store is not None:
            self.store = store
        elif volume is not None:
            from ..prefix_store import SharedPrefixStore

            self.store = SharedPrefixStore(
                volume,
                replica=replica or f"replica-{os.getpid()}",
                root=volume_prefix,
                shared=shared,
            )
        else:
            self.store = None
        self.volume = self.store.volume if self.store is not None else None
        self._lock = threading.Lock()
        #: trie-resident page id -> chained block hash (spill key material)
        self._by_page: dict[int, str] = {}
        #: block hash -> its chain's HEAD hash (spill-ownership key: the
        #: store assigns whole chains, not single blocks, to owners).
        #: Bounded LRU — demotes can happen long after register
        self._chain_of: OrderedDict[str, str] = OrderedDict()
        #: host tier: hash -> serialized single-block bytes, LRU order
        self._host: OrderedDict[str, bytes] = OrderedDict()
        self._host_used = 0
        self.tier_hits = {"host": 0, "volume": 0}
        self.spilled = 0
        self.promoted = 0

    #: bound on the block -> chain-head map (LRU; ~64 bytes/entry of hex)
    CHAIN_MAP_CAP = 65536

    # -- bookkeeping ---------------------------------------------------------

    def _emit_gauges_locked(self) -> None:
        _obs.set_tier_occupancy(
            "host", pages=len(self._host), total_bytes=self._host_used
        )
        if self.store is not None:
            _obs.set_tier_occupancy(
                "volume",
                pages=self.store.n_blocks,
                total_bytes=self.store.total_bytes,
            )

    def register(self, key_tokens: list, trie_pages: list) -> None:
        """Record the chained hash of every trie-resident full-prompt page
        (called after ``PrefixCache.insert``), so a later eviction knows
        what content each physical page holds — and pin the chain in the
        shared store (this replica's refcount: GC keeps blocks any live
        replica may still promote)."""
        hashes = chain_hashes(key_tokens, self.cache.page_size)
        if not hashes:
            return
        with self._lock:
            for pid, h in zip(trie_pages, hashes):
                self._by_page[pid] = h
            for h in hashes:
                self._chain_of.pop(h, None)
                self._chain_of[h] = hashes[0]
            while len(self._chain_of) > self.CHAIN_MAP_CAP:
                self._chain_of.popitem(last=False)
        if self.store is not None:
            self.store.pin(hashes)

    # -- spill (HBM -> host -> volume) ---------------------------------------

    def spill_pages(self, page_ids: list) -> None:
        """Serialize evicted trie pages into the host tier before their HBM
        pages return to the allocator (the ``PrefixCache.spill`` hook).
        Unregistered pages (never inserted through a claim this tier saw)
        are skipped."""
        with self._lock:
            work = [
                (pid, self._by_page.pop(pid))
                for pid in page_ids
                if pid in self._by_page
            ]
        work = [
            (pid, h) for pid, h in work
            if self._lookup_host(h, touch=False) is None  # already spilled
        ]
        if not work:
            return
        # ONE device->host transfer for the whole eviction wave (this runs
        # on the allocator-pressure path): per-page blocks are sliced out
        # of the batched copy on the host
        batch = extract_pages(self.cache, [pid for pid, _ in work])
        for i, (_pid, block_hash) in enumerate(work):
            block = PageBlock(
                leaves={
                    name: arr[:, i : i + 1] for name, arr in batch.leaves.items()
                },
                page_size=batch.page_size,
                kv_dtype=batch.kv_dtype,
            )
            self._host_put(block_hash, serialize_block(block))
            self.spilled += 1
        with self._lock:
            self._emit_gauges_locked()

    def _host_put(self, block_hash: str, data: bytes) -> None:
        with self._lock:
            if block_hash in self._host:
                return
            self._host[block_hash] = data
            self._host_used += len(data)
            # bounded LRU: overflow demotes oldest blocks to the volume
            # tier (or drops them when no volume is configured)
            demote: list[tuple[str, bytes]] = []
            while self._host_used > self.host_bytes_budget and len(self._host) > 1:
                old_hash, old_data = self._host.popitem(last=False)
                self._host_used -= len(old_data)
                demote.append((old_hash, old_data))
        for old_hash, old_data in demote:
            self._demote_to_volume(old_hash, old_data)

    def _demote_to_volume(self, block_hash: str, data: bytes) -> None:
        if self.store is None:
            return
        with self._lock:
            chain = self._chain_of.get(block_hash)
        try:
            self.store.put(block_hash, data, chain=chain)
        except Exception as e:
            # includes the injected owner-death crash: the spill is simply
            # lost here (atomic writes: no torn block lands), and either a
            # surviving replica's spill or a later recompute rewrites it
            _log.warning("volume demote of %s failed: %s", block_hash, e)

    # -- promote (volume -> host -> HBM) -------------------------------------

    def _lookup_host(self, block_hash: str, *, touch: bool = True):
        with self._lock:
            data = self._host.get(block_hash)
            if data is not None and touch:
                self._host.move_to_end(block_hash)
            return data

    def _lookup_volume(self, block_hash: str):
        if self.store is None:
            return None
        data = self.store.get(block_hash)
        if data is None:
            return None
        # fault point: the volume's bytes rot IN FLIGHT —
        # promote's crc check drops the block and prefill recomputes it;
        # the stored file is untouched (store.drop_if_corrupt proves that
        # before ever deleting), so a later promote can still succeed
        return _inject.corrupt("tiered.volume_corrupt", data)

    def promote(self, key_tokens: list, *, n_have: int) -> list:
        """Restore consecutive full-prompt pages past the trie's
        ``n_have``-page hit from the lower tiers. Each hit allocates one
        fresh page, adopts the stored bytes into it, and returns it — the
        engine's claim inserts these into the trie like freshly prefilled
        pages (refcount 1), so the block is shared again from here on.
        Stops at the first miss, corrupt block, or allocator exhaustion."""
        hashes = chain_hashes(key_tokens, self.cache.page_size)
        out: list[int] = []
        by_tier = {"host": 0, "volume": 0}
        for block_hash in hashes[n_have:]:
            tier = "host"
            data = self._lookup_host(block_hash)
            if data is None:
                tier = "volume"
                data = self._lookup_volume(block_hash)
            if data is None:
                break
            try:
                block = deserialize_block(data)
            except TransportError as e:
                _log.warning(
                    "dropping corrupt tier block %s: %s", block_hash, e
                )
                with self._lock:
                    stale = self._host.pop(block_hash, None)
                    if stale is not None:
                        self._host_used -= len(stale)
                if tier == "volume" and self.store is not None:
                    # torn/rotten ON DISK -> removed so the recompute's
                    # spill rewrites it; corrupted in flight -> kept
                    self.store.drop_if_corrupt(block_hash)
                break
            if block.kv_dtype != self.cache.kv_dtype:
                break  # cache was rebuilt at a different dtype: stale tier
            n_pages = block.n_pages
            try:
                pages = self.cache.allocator.alloc(n_pages)
            except Exception:
                break  # no room to promote into; callers alloc what's left
            adopt_pages(self.cache, block, pages)
            out.extend(pages)
            # PAGE units, like every other tier counter (a block is one
            # page today, but hit-rate/dedup math must not silently break
            # the day multi-page blocks ship over the same codec)
            self.tier_hits[tier] += n_pages
            by_tier[tier] += n_pages
            _obs.record_tier_hit(tier, n=n_pages)
            if tier == "volume":
                # promote the bytes up a tier too: next hit is RAM-speed
                self._host_put(block_hash, data)
        if out:
            self.promoted += len(out)
            # the claim path scopes the request's ambient trace frame
            # around promotion: the restore shows up on its timeline
            for tier, n in by_tier.items():
                if n:
                    _rt.ambient_event("tier_promote", tier=tier, pages=n)
            with self._lock:
                self._emit_gauges_locked()
        return out

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = {
                "host": {
                    "blocks": len(self._host),
                    "bytes": self._host_used,
                    "budget_bytes": self.host_bytes_budget,
                },
                "volume": {
                    "blocks": (
                        self.store.n_blocks if self.store is not None else 0
                    ),
                    "bytes": (
                        self.store.total_bytes
                        if self.store is not None else 0
                    ),
                    "enabled": self.store is not None,
                },
                "hits": dict(self.tier_hits),
                "spilled": self.spilled,
                "promoted": self.promoted,
                "registered_pages": len(self._by_page),
            }
        if self.store is not None:
            out["store"] = self.store.stats()
        return out
