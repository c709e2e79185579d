"""The ownership and lease layer of the shared prefix store, a copy of
``modal_examples_tpu/serving/prefix_store/ownership.py``.

Every prefix chain (named by its HEAD chain hash, the first full page's
chained content hash) has one **owner** replica at any moment: the
rendezvous winner (:func:`~...scheduling.router.rendezvous_score`, the hash
the router places requests with) over the replicas registered against the
store. The owner spills that chain's blocks to the shared Volume, so N
replicas serving one tenant population write one copy.

Two kinds of small JSON files on the shared volume back it:

- ``replicas/<name>.json``: a membership heartbeat. A replica registers at
  boot (``SnapshotWarmFactory`` scale-outs included), refreshes on demand,
  and deregisters on scale-in, quarantine or crash handling. A heartbeat
  older than ``replica_ttl_s`` is a dead replica: rendezvous stops seeing it
  and its chains remap.
- ``leases/<chain>.json``: the spill lease the owner holds while writing a
  chain. Acquiring a lease held by a dead or expired owner is a
  **takeover**: counted (``mtpu_prefix_store_owner_takeovers_total``) and
  journaled (``prefix_store.jsonl``).

Every file goes through :meth:`~...storage.volume.Volume.write_file`'s
atomic write (fsync and rename): a crash mid-write leaves the previous value.
"""

from __future__ import annotations

import json
import time

from ...observability import metrics as _obs
from ...observability.journal import named_journal
from ...scheduling.router import rendezvous_score
from ...utils.log import get_logger

_log = get_logger("prefix_store")

#: sub-directories of the store root these files live under (the store's
#: blocks/ sibling); path strings are built here and in store.py only
REPLICAS_DIR = "replicas"
LEASES_DIR = "leases"

#: a heartbeat older than this is a dead replica (ownership remaps)
DEFAULT_REPLICA_TTL_S = 60.0
#: a spill lease auto-expires after this long (a wedged owner cannot
#: block a chain's spills forever)
DEFAULT_LEASE_TTL_S = 60.0


def rendezvous_owner(chain: str, names) -> str | None:
    """The rendezvous winner for ``chain`` among replica ``names`` — the
    router's placement hash reused for spill ownership, so the replica a
    shared prefix routes to is (membership permitting) also the replica
    that owns spilling it."""
    names = list(names)
    if not names:
        return None
    key = chain.encode()
    return max(names, key=lambda n: rendezvous_score(key, n))


class LeaseBoard:
    """Membership + per-chain spill leases over one shared volume root.

    One instance per (replica, store); instances on different replicas
    coordinate purely through the volume files, the same way the replicas
    coordinate block contents through the content-addressed block files.
    """

    def __init__(
        self,
        volume,
        root: str,
        replica: str,
        *,
        lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
        replica_ttl_s: float = DEFAULT_REPLICA_TTL_S,
        clock=time.time,
    ):
        self.volume = volume
        self.root = root.strip("/")
        self.replica = replica
        self.lease_ttl_s = float(lease_ttl_s)
        self.replica_ttl_s = float(replica_ttl_s)
        self._clock = clock
        self._journal = named_journal("prefix_store")
        self.takeovers = 0

    # -- paths (the only place these strings are built) ----------------------

    def _replica_path(self, name: str) -> str:
        return f"{self.root}/{REPLICAS_DIR}/{name}.json"

    def _lease_path(self, chain: str) -> str:
        return f"{self.root}/{LEASES_DIR}/{chain}.json"

    def _read_json(self, path: str) -> dict | None:
        try:
            return json.loads(self.volume.read_file(path).decode())
        except (OSError, ValueError):
            return None

    # -- membership ----------------------------------------------------------

    def register(self, *, boot: str | None = None) -> None:
        """Join (or refresh) this replica's membership heartbeat."""
        rec = {"at": self._clock()}
        if boot is not None:
            rec["boot"] = boot
        self.volume.write_file(
            self._replica_path(self.replica), json.dumps(rec).encode()
        )

    heartbeat = register

    def deregister(self) -> None:
        """Leave the membership: this replica's chains remap immediately
        (scale-in, watchdog quarantine, or the owner-death fault path)."""
        try:
            self.volume.remove_file(self._replica_path(self.replica))
        except OSError:
            pass

    def alive_replicas(self) -> list[str]:
        """Members with a fresh heartbeat, sorted (deterministic owner
        math). A stale heartbeat is a crashed replica: not an error, just
        no longer an owner candidate."""
        now = self._clock()
        out = []
        try:
            entries = list(self.volume.listdir(f"{self.root}/{REPLICAS_DIR}"))
        except OSError:
            return []
        for entry in entries:
            base = str(entry).rsplit("/", 1)[-1]
            if not base.endswith(".json"):
                continue
            rec = self._read_json(str(entry))
            if rec is None:
                continue
            if now - float(rec.get("at", 0.0)) <= self.replica_ttl_s:
                out.append(base[: -len(".json")])
        return sorted(out)

    def owner_for(self, chain: str, candidates=None) -> str | None:
        """The chain's current owner: rendezvous over the live membership
        (or an explicit candidate list). ``None`` with no live members —
        callers then spill solo rather than drop the block."""
        return rendezvous_owner(
            chain,
            candidates if candidates is not None else self.alive_replicas(),
        )

    # -- leases --------------------------------------------------------------

    def acquire(self, chain: str) -> bool:
        """Take (or refresh) the spill lease on ``chain``.

        Refused only while a DIFFERENT, LIVE owner holds an unexpired
        lease. Acquiring over a dead or expired owner is a takeover:
        counted and journaled, then the lease is rewritten to this
        replica."""
        now = self._clock()
        rec = self._read_json(self._lease_path(chain))
        if rec is not None and rec.get("owner") != self.replica:
            owner_alive = rec.get("owner") in self.alive_replicas()
            if owner_alive and float(rec.get("expires", 0.0)) > now:
                return False
            self.takeovers += 1
            _obs.record_prefix_store_takeover()
            self._journal.record({
                "at": time.time(),
                "action": "owner_takeover",
                "chain": chain,
                "from": rec.get("owner"),
                "to": self.replica,
                "reason": "owner_dead" if not owner_alive else "lease_expired",
            })
            _log.warning(
                "prefix store lease takeover on chain %s: %s -> %s",
                chain[:12], rec.get("owner"), self.replica,
            )
        self.volume.write_file(
            self._lease_path(chain),
            json.dumps({
                "owner": self.replica,
                "expires": now + self.lease_ttl_s,
                "seq": int(rec.get("seq", 0)) + 1 if rec else 1,
            }).encode(),
        )
        return True

    def release(self, chain: str) -> None:
        """Drop this replica's lease on ``chain`` (no-op on another
        owner's lease — releasing what you don't hold must not steal)."""
        rec = self._read_json(self._lease_path(chain))
        if rec is not None and rec.get("owner") == self.replica:
            try:
                self.volume.remove_file(self._lease_path(chain))
            except OSError:
                pass

    def lease_of(self, chain: str) -> dict | None:
        return self._read_json(self._lease_path(chain))

    def n_leases(self) -> int:
        try:
            return sum(
                1 for e in self.volume.listdir(f"{self.root}/{LEASES_DIR}")
                if str(e).endswith(".json")
            )
        except OSError:
            return 0
