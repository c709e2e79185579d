"""The fleet-wide shared prefix block store, a copy of
``modal_examples_tpu/serving/prefix_store/store.py``: the deduplicated
cross-replica Volume tier below every replica's tiered prefix cache.

- **dedup by content address**: blocks are keyed by
  :func:`~..disagg.transport.chain_hashes` (position-dependent) and stored
  once under ``blocks/block-<hash>.kv``; a second writer of the same chain
  finds the block present and skips the write.
- **rendezvous ownership** (:mod:`.ownership`): each chain has one owner
  replica responsible for spilling it; non-owners defer, and owner death
  remaps the chain with a journaled lease takeover.
- **any replica promotes any replica's spills**: blocks are MTKV1 envelopes
  (:func:`~..disagg.transport.serialize_block`, a crc32 per leaf), the same
  bytes the JAX package writes, so a block written by either package reads
  back bitwise in the other.
- **torn or corrupt blocks are dropped, never adopted**: writes are atomic
  (:meth:`~...storage.volume.Volume.write_file`), reads are checked against
  the MTKV1 header's declared sizes, and a block whose stored bytes fail the
  full crc check is removed so the next recompute's spill rewrites it.
- **bounded GC**: LRU by last hit (the block file's mtime, refreshed on every
  hit) with cross-replica refcounts: a block pinned by any live replica's
  ``refs/<replica>.json`` survives; a sweep removes at most ``max_remove``
  blocks.

Series: ``mtpu_prefix_store_hits_total{origin=self|peer}``,
``mtpu_prefix_store_misses_total``, ``mtpu_prefix_store_dedup_ratio``,
``mtpu_prefix_store_bytes``, ``mtpu_prefix_store_owner_takeovers_total``.
Surfaces: ``python -m modal_examples_tpu_torch prefixstore`` and the
gateway's ``/prefixstore``. This module is the only writer of the store's
Volume directory.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time

from ...faults import inject as _inject
from ...observability import metrics as _obs
from ...observability.journal import named_journal
from ...utils.log import get_logger
from ..disagg.transport import _MAGIC, TransportError, deserialize_block
from .ownership import LeaseBoard

_log = get_logger("prefix_store")

#: store layout under the root: content-addressed blocks and per-replica
#: refcount manifests (membership/leases live in :mod:`.ownership`)
BLOCKS_DIR = "blocks"
REFS_DIR = "refs"

#: default store root on the shared volume
DEFAULT_ROOT = "prefix-store"

#: per-replica pin cap: the refs manifest is a refcount, not an archive —
#: the oldest pins age out once a replica references more than this many
#: blocks (GC may then collect them if no other replica pins them either)
PIN_CAP = 8192


def block_file(block_hash: str) -> str:
    """Root-relative path of a content-addressed block: the one place the
    block layout is spelled."""
    return f"{BLOCKS_DIR}/block-{block_hash}.kv"


def _structurally_sound(data: bytes) -> bool:
    """Cheap torn-block check: the MTKV1 magic plus the header's declared
    leaf sizes must account for EXACTLY the file's length. Catches
    truncation (a non-atomic writer's torn spill) without paying the full
    per-leaf crc — that runs at deserialize time in the promote path."""
    if data[: len(_MAGIC)] != _MAGIC:
        return False
    off = len(_MAGIC)
    if len(data) < off + 4:
        return False
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    try:
        header = json.loads(data[off : off + hlen])
    except (ValueError, UnicodeDecodeError):
        return False
    off += hlen
    try:
        total = sum(int(spec["nbytes"]) for spec in header["leaves"])
    except (KeyError, TypeError, ValueError):
        return False
    return len(data) == off + total


class SharedPrefixStore:
    """One replica's handle on the fleet-shared prefix block store.

    Instances on different replicas coordinate purely through the shared
    volume's files: content-addressed blocks, membership heartbeats,
    leases, and refcount manifests. ``shared=False`` degrades to a
    single-writer private tier (no membership, no leases — every chain is
    self-owned), which is how a solo engine's Volume tier runs.
    """

    def __init__(
        self,
        volume,
        *,
        replica: str = "replica-0",
        root: str = DEFAULT_ROOT,
        shared: bool = True,
        lease_ttl_s: float | None = None,
        replica_ttl_s: float | None = None,
        clock=time.time,
    ):
        self.volume = volume
        self.root = root.strip("/")
        self.replica = replica
        self.shared = bool(shared)
        self._clock = clock
        board_kw = {}
        if lease_ttl_s is not None:
            board_kw["lease_ttl_s"] = lease_ttl_s
        if replica_ttl_s is not None:
            board_kw["replica_ttl_s"] = replica_ttl_s
        self.board = LeaseBoard(
            volume, self.root, replica, clock=clock, **board_kw
        )
        self._lock = threading.Lock()
        #: block hash -> stored size (this process's view of the index,
        #: seeded from the directory, grown on put/get)
        self._index: dict[str, int] = {}
        #: hashes found in the LEGACY flat ``<root>/block-<h>.kv`` layout
        #: (pre-store private tiers): readable, never written
        self._legacy: set[str] = set()
        #: blocks THIS instance wrote (hit-origin attribution: a hit on a
        #: block someone else wrote is the cross-replica win)
        self._written: set[str] = set()
        #: blocks this replica references (its refcount contribution)
        self._pins: dict[str, None] = {}
        self.puts = 0
        self.writes = 0
        self.dedup_skips = 0
        self.deferred = 0
        self.hits = {"self": 0, "peer": 0}
        self.misses = 0
        self.invalidated = 0
        self._journal = named_journal("prefix_store")
        self._seed_index()
        if self.shared:
            self.board.register()

    # -- index ---------------------------------------------------------------

    def _seed_index(self) -> None:
        """Discover blocks already in the store (a previous fleet's warmth
        — the whole point). Sizes start 0 and fill lazily on first touch;
        reading every block at boot would make registration proportional
        to the store's size. Also adopts a legacy private tier's flat
        layout read-only, so upgrading a volume keeps it warm."""
        for sub, legacy in ((f"{self.root}/{BLOCKS_DIR}", False),
                            (self.root, True)):
            try:
                entries = list(self.volume.listdir(sub))
            except OSError:
                continue
            for name in entries:
                base = str(name).rsplit("/", 1)[-1]
                if base.startswith("block-") and base.endswith(".kv"):
                    h = base[len("block-"):-len(".kv")]
                    self._index.setdefault(h, 0)
                    if legacy:
                        self._legacy.add(h)

    def _rel(self, block_hash: str) -> str:
        if block_hash in self._legacy:
            return f"{self.root}/block-{block_hash}.kv"
        return f"{self.root}/{block_file(block_hash)}"

    def exists(self, block_hash: str) -> bool:
        # the index is a size cache, NOT presence truth: another replica
        # may have written the block since our last look — or INVALIDATED
        # it (torn/corrupt drop), and a stale index entry here would make
        # put() dedup-skip the respill fleet-wide. Always confirm against
        # the volume.
        if (self.volume.local_path / self._rel(block_hash)).exists():
            with self._lock:
                self._index.setdefault(block_hash, 0)
            return True
        with self._lock:
            self._index.pop(block_hash, None)
            self._legacy.discard(block_hash)
        return False

    @property
    def n_blocks(self) -> int:
        with self._lock:
            return len(self._index)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._index.values())

    # -- write path ----------------------------------------------------------

    def put(self, block_hash: str, data: bytes, *, chain: str | None = None) -> str:
        """Spill one serialized block. Returns what happened:

        - ``"dedup"`` — already stored fleet-wide (the write N-1 replicas
          no longer pay);
        - ``"deferred"`` — another LIVE replica owns this chain's spills
          (rendezvous said so, or it holds a live lease);
        - ``"written"`` — this replica owned the chain (or runs private)
          and the block is durably, atomically on the volume.
        """
        with self._lock:
            self.puts += 1
        if self.exists(block_hash):
            with self._lock:
                self.dedup_skips += 1
            self._emit_gauges()
            return "dedup"
        if self.shared and chain is not None:
            owner = self.board.owner_for(chain)
            if owner is not None and owner != self.replica:
                with self._lock:
                    self.deferred += 1
                self._emit_gauges()
                return "deferred"
            if not self.board.acquire(chain):
                with self._lock:
                    self.deferred += 1
                self._emit_gauges()
                return "deferred"
        # fault point: the chain's owner dies mid-spill —
        # it drops out of the membership and the write below never happens.
        # The atomic temp+rename write discipline means a REAL crash at any
        # point of the write leaves no torn block either; the survivor's
        # next spill of this chain takes the lease over and rewrites it.
        if _inject.fire("prefix_store.owner_death"):
            self.board.deregister()
            raise _inject.FaultError(
                "injected fault: prefix_store.owner_death"
            )
        self.volume.write_file(self._rel(block_hash), data)
        with self._lock:
            self._index[block_hash] = len(data)
            self._written.add(block_hash)
            self.writes += 1
        self.pin([block_hash])
        self._emit_gauges()
        return "written"

    # -- read path -----------------------------------------------------------

    def get(self, block_hash: str) -> bytes | None:
        """Read one block, whoever wrote it. Structurally-unsound (torn)
        bytes are dropped from the store and reported as a miss — the
        caller recomputes; the full per-leaf crc runs downstream at
        deserialize time."""
        try:
            data = self.volume.read_file(self._rel(block_hash))
        except OSError:
            with self._lock:
                self.misses += 1
            _obs.record_prefix_store_miss()
            return None
        if not _structurally_sound(data):
            _log.warning(
                "dropping torn prefix-store block %s (%d bytes)",
                block_hash[:12], len(data),
            )
            self.invalidate(block_hash)
            with self._lock:
                self.misses += 1
            _obs.record_prefix_store_miss()
            return None
        self.touch(block_hash)
        with self._lock:
            self._index[block_hash] = len(data)
            origin = "self" if block_hash in self._written else "peer"
            self.hits[origin] += 1
        _obs.record_prefix_store_hit(origin)
        return data

    def touch(self, block_hash: str) -> None:
        """Refresh the block's last-hit time (the GC's LRU axis)."""
        try:
            os.utime(self.volume.local_path / self._rel(block_hash))
        except OSError:
            pass

    def invalidate(self, block_hash: str) -> None:
        """Remove a block (torn/corrupt): the next recompute respills it."""
        try:
            self.volume.remove_file(self._rel(block_hash))
        except OSError:
            pass
        with self._lock:
            self._index.pop(block_hash, None)
            self._legacy.discard(block_hash)
            self.invalidated += 1

    def drop_if_corrupt(self, block_hash: str) -> bool:
        """A reader's deserialize failed: decide whether the STORED bytes
        are rotten (re-read + full crc). In-flight corruption (the chaos
        ``tiered.volume_corrupt`` injection, a bad DMA) leaves the stored
        block intact — dropping it would throw away a good spill — so
        only a block whose bytes fail the crc ON DISK is removed."""
        try:
            data = self.volume.read_file(self._rel(block_hash))
        except OSError:
            return True
        try:
            deserialize_block(data)
        except (TransportError, ValueError, KeyError, struct.error):
            self.invalidate(block_hash)
            _log.warning(
                "dropped corrupt-on-disk prefix-store block %s",
                block_hash[:12],
            )
            return True
        return False

    # -- refcounts + GC ------------------------------------------------------

    def _refs_path(self, name: str) -> str:
        return f"{self.root}/{REFS_DIR}/{name}.json"

    def pin(self, hashes) -> None:
        """Add blocks to this replica's refcount manifest: while the
        replica is alive, GC keeps them. Bounded (``PIN_CAP``): oldest
        pins age out — the manifest is a refcount, not an archive."""
        with self._lock:
            before = len(self._pins)
            changed = False
            for h in hashes:
                if h in self._pins:
                    self._pins.pop(h)  # re-pin refreshes recency
                else:
                    changed = True
                self._pins[h] = None
            while len(self._pins) > PIN_CAP:
                self._pins.pop(next(iter(self._pins)))
                changed = True
            changed = changed or len(self._pins) != before
            pins = list(self._pins) if changed else None
        if pins is not None:
            self._write_refs(pins)

    def unpin(self, hashes) -> None:
        with self._lock:
            for h in hashes:
                self._pins.pop(h, None)
            pins = list(self._pins)
        self._write_refs(pins)

    def _write_refs(self, pins: list) -> None:
        try:
            self.volume.write_file(
                self._refs_path(self.replica),
                json.dumps({"at": self._clock(), "blocks": pins}).encode(),
            )
        except OSError as e:
            _log.warning("prefix store refs write failed: %s", e)

    def _pinned_fleetwide(self) -> set:
        """Union of every LIVE replica's pins (plus our own, even when
        running private — a dead replica's pins hold nothing)."""
        pinned: set = set()
        with self._lock:
            pinned.update(self._pins)
        alive = set(self.board.alive_replicas()) if self.shared else set()
        try:
            entries = list(self.volume.listdir(f"{self.root}/{REFS_DIR}"))
        except OSError:
            return pinned
        for entry in entries:
            base = str(entry).rsplit("/", 1)[-1]
            if not base.endswith(".json"):
                continue
            name = base[: -len(".json")]
            if name == self.replica or name not in alive:
                continue
            try:
                rec = json.loads(self.volume.read_file(str(entry)).decode())
                pinned.update(rec.get("blocks", ()))
            except (OSError, ValueError):
                continue
        return pinned

    def gc(
        self,
        *,
        max_bytes: int | None = None,
        max_blocks: int | None = None,
        max_remove: int = 64,
    ) -> dict:
        """One bounded LRU sweep: refresh sizes/ages from the directory,
        then remove the oldest-hit UNPINNED blocks until the store fits
        the budgets — at most ``max_remove`` removals per sweep, so the
        sweep's cost is bounded no matter how far over budget churn got."""
        ages: dict[str, float] = {}
        with self._lock:
            known = list(self._index)
        for h in known:
            try:
                st = (self.volume.local_path / self._rel(h)).stat()
            except OSError:
                with self._lock:
                    self._index.pop(h, None)
                continue
            ages[h] = st.st_mtime
            with self._lock:
                self._index[h] = st.st_size
        pinned = self._pinned_fleetwide()
        order = sorted(
            (h for h in ages if h not in pinned), key=ages.__getitem__
        )
        removed, freed = 0, 0
        for h in order:
            if removed >= max_remove:
                break
            with self._lock:
                blocks = len(self._index)
                total = sum(self._index.values())
            over = (
                (max_bytes is not None and total > max_bytes)
                or (max_blocks is not None and blocks > max_blocks)
            )
            if not over:
                break
            with self._lock:
                freed += self._index.get(h, 0)
            self.invalidate(h)
            removed += 1
        self._emit_gauges()
        if removed:
            self._journal.record({
                "at": time.time(),
                "action": "gc_sweep",
                "replica": self.replica,
                "removed": removed,
                "freed_bytes": freed,
                "blocks": self.n_blocks,
                "bytes": self.total_bytes,
                "pinned": len(pinned),
            })
        return {
            "removed": removed,
            "freed_bytes": freed,
            "blocks": self.n_blocks,
            "bytes": self.total_bytes,
            "pinned": len(pinned),
        }

    # -- membership passthrough (the store is the subsystem's one handle) ----

    def register_replica(self, *, boot: str | None = None) -> None:
        self.board.register(boot=boot)

    def heartbeat(self) -> None:
        self.board.heartbeat()

    def deregister_replica(self) -> None:
        self.board.deregister()
        try:
            self.volume.remove_file(self._refs_path(self.replica))
        except OSError:
            pass

    def alive_replicas(self) -> list[str]:
        return self.board.alive_replicas()

    def owner_for(self, chain: str, candidates=None) -> str | None:
        return self.board.owner_for(chain, candidates)

    # -- introspection -------------------------------------------------------

    def dedup_ratio(self) -> float:
        """Logical spill attempts per physical write, this instance's
        view: > 1.0 means the fleet stopped paying N copies."""
        with self._lock:
            return self.puts / max(1, self.writes)

    def _emit_gauges(self) -> None:
        _obs.set_prefix_store_occupancy(
            total_bytes=self.total_bytes, dedup_ratio=self.dedup_ratio()
        )

    def stats(self) -> dict:
        with self._lock:
            out = {
                "replica": self.replica,
                "shared": self.shared,
                "root": self.root,
                "blocks": len(self._index),
                "bytes": sum(self._index.values()),
                "puts": self.puts,
                "writes": self.writes,
                "dedup_skips": self.dedup_skips,
                "deferred": self.deferred,
                "hits": dict(self.hits),
                "misses": self.misses,
                "invalidated": self.invalidated,
                "pins": len(self._pins),
            }
        out["dedup_ratio"] = round(self.dedup_ratio(), 4)
        out["takeovers"] = self.board.takeovers
        if self.shared:
            out["alive_replicas"] = self.alive_replicas()
            out["leases"] = self.board.n_leases()
        return out
