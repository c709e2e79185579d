"""The closed-loop fleet autoscaler, a copy of
``modal_examples_tpu/fleet/autoscaler.py``: it grows and shrinks serving
replicas behind a :class:`~..scheduling.router.PrefixAffinityRouter` from
load.

The executor autoscaler (``core/executor.py``) scales *containers* for
remote functions; this controller scales *serving replicas*. Once per tick
it reads three pressure signals:

- **SLO burn rate** (``observability/slo.py``): the TTFT/TPOT p95 targets
  evaluated against the live registry; burn > 1 means the latency budget is
  being spent faster than it accrues;
- **queue depth**: requests waiting for admission per decode-capable
  replica, plus the admission layer's shed counter delta (a shed is queue
  pressure already turned into a 429);
- **KV-page pressure**: the paged cache's occupancy less the prefix cache's
  reclaimable warmth, plus queued reservations;

and decides per ROLE GROUP (prefill-role replicas on their own backlog,
decode-capable ones on the signals above), damped by hysteresis
(``up_ticks``/``down_ticks`` consecutive ticks) and a ``cooldown_s`` window
after any action.

Scale-out builds a replica through the ``factory`` callable, typically a
:class:`SnapshotWarmFactory`, which restores the model's parameters from the
memory-snapshot store (``snapshot/``: the torch codec keeps every tensor as
host bytes and restores it onto the device it came from) instead of
initializing them: a "warm" boot against a "cold" one. A scale-out joins the
shared prefix store (``serving/prefix_store/``) at boot. Scale-in is
drain-safe: the victim leaves placement first (``router.remove_replica``),
its live requests are checkpoint-migrated onto the remaining fleet
(``serving/failover.drain_replica``), and its engine stops only once
``outstanding() == 0``.

Every decision appends a record to ``<state_dir>/fleet.jsonl`` and counts in
``mtpu_fleet_decisions_total{action,trigger}``; the fleet's size by role is
``mtpu_fleet_replicas{role}`` and boot latency by kind
``mtpu_fleet_boot_seconds{boot}``, surfaced by ``python -m
modal_examples_tpu_torch fleet`` and the gateway's ``/fleet``.
"""

from __future__ import annotations

import threading
import time

from ..observability import catalog as C
from ..observability import metrics as _obs
from ..observability import slo as _slo
from ..observability.journal import named_journal
from ..utils.log import get_logger
from ..utils.prometheus import default_registry

logger = get_logger("fleet")

#: the SLO names whose burn rate feeds the scale-up signal (latency only:
#: error-budget SLOs say something is broken, not that the fleet is small)
_LATENCY_SLO_NAMES = ("ttft_p95", "tpot_p95")


def _role_group(replica) -> str:
    """prefill-role replicas scale as their own group; decode and unified
    replicas both own requests end to end and scale together."""
    return "prefill" if getattr(replica, "role", "unified") == "prefill" else "decode"


def shared_prefix_store(replica):
    """The replica engine's SHARED prefix store handle, or None. A private
    (``shared=False``) tier has no fleet membership to manage, so the
    autoscaler leaves it alone."""
    tiered = getattr(getattr(replica, "engine", None), "tiered", None)
    store = getattr(tiered, "store", None)
    if store is not None and getattr(store, "shared", False):
        return store
    return None


def _deregister_prefix_store(replica) -> None:
    """Drop a stopped replica out of the store's membership so its leases
    expire as dead (survivors take chains over) and its pins stop holding
    blocks against GC. Best-effort: a failed deregister just means the
    membership TTL does the same thing later."""
    store = shared_prefix_store(replica)
    if store is None:
        return
    try:
        store.deregister_replica()
    except Exception:
        logger.warning(
            "fleet: prefix-store deregister failed for %s",
            getattr(replica, "name", "?"),
        )


class SnapshotWarmFactory:
    """Replica factory with snapshot-restored warm boots.

    Wraps a ``build(name, role, params=None)`` callable (which constructs
    and returns a routable replica, typically an ``EngineReplica`` over a
    fresh ``LLMEngine``). The first build is cold; its engine's params are
    then captured into the :class:`~..snapshot.SnapshotStore` (every tensor
    as host bytes through the snapshot codec, restored onto the device it
    came from), and every later build passes the restored tree back as
    ``params=``: the init/quantize step is skipped. :meth:`prime` captures
    from an already-running engine so the very first scale-out is warm.

    Calling the factory returns ``(replica, boot)`` with ``boot`` in
    ``{"warm", "cold"}``; a store/codec failure degrades to a cold build,
    never a scale-out outage.
    """

    def __init__(self, build, *, snapshot_key: str, store=None):
        from ..snapshot import SnapshotStore

        self._build = build
        self.snapshot_key = snapshot_key
        self.store = store if store is not None else SnapshotStore()
        self._lock = threading.Lock()

    def prime(self, engine) -> bool:
        """Capture ``engine.params`` into the store (idempotent); returns
        whether a snapshot is now available for warm boots."""
        with self._lock:
            if self.store.has(self.snapshot_key):
                return True
            return self._capture(engine.params)

    def _capture(self, params) -> bool:
        from ..snapshot.codec import CodecError, encode_attr
        from ..utils.metrics import record_snapshot_boot

        try:
            payload = encode_attr(params)
        except CodecError as e:
            logger.warning("fleet snapshot capture failed: %s", e)
            return False
        ok = self.store.put(
            self.snapshot_key, payload, manifest={"kind": "fleet-params"}
        )
        if ok:
            # the capturing replica itself booted cold: one miss + capture
            record_snapshot_boot("fleet", "miss", captured=True)
        return ok

    def _restore(self):
        from ..snapshot.codec import decode_attr

        got = self.store.get(self.snapshot_key)
        if got is None:
            return None
        payload, _meta = got
        try:
            return decode_attr(payload)
        except Exception as e:  # poison entry: drop it, boot cold
            logger.warning("fleet snapshot restore failed: %s", e)
            self.store.delete(self.snapshot_key)
            return None

    def __call__(self, name: str, role: str):
        from ..utils.metrics import record_snapshot_boot

        with self._lock:
            params = self._restore()
        boot = "warm" if params is not None else "cold"
        if params is not None:
            record_snapshot_boot("fleet", "hit")
        replica = self._build(name, role, params=params)
        if params is None:
            with self._lock:
                if not self.store.has(self.snapshot_key):
                    self._capture(replica.engine.params)
        # a scale-out joins the SHARED prefix store at boot: membership
        # makes it a rendezvous owner candidate immediately, and the tier
        # it promotes from is the fleet's — so a warm-weights boot also
        # serves its first traffic with a warm prefix hit rate instead of
        # recomputing prefixes the fleet already paid for
        pstore = shared_prefix_store(replica)
        if pstore is not None:
            try:
                pstore.register_replica(boot=boot)
            except Exception:
                logger.warning("fleet: prefix-store register failed for %s", name)
        return replica, boot


class FleetAutoscaler:
    """Closed-loop controller over a router's replica fleet."""

    def __init__(
        self,
        router,
        factory,
        *,
        min_replicas: dict | None = None,  # per role group; decode >= 1
        max_replicas: dict | None = None,
        queue_high: float = 4.0,  # queued requests per replica -> scale up
        kv_high: float = 0.85,  # max cache occupancy fraction -> scale up
        burn_high: float = 1.0,  # latency-SLO burn rate -> scale up
        shed_high: int = 1,  # sheds observed since last tick -> scale up
        idle_low: float = 0.25,  # fleet outstanding/capacity below -> down
        up_ticks: int = 2,  # consecutive pressured ticks before scale-up
        down_ticks: int = 6,  # consecutive idle ticks before scale-down
        cooldown_s: float = 5.0,  # no further action after any action
        tick_s: float = 0.5,
        drain_timeout_s: float = 60.0,
        # drain-by-migration (serving/failover.py): a
        # scale-in victim's live requests are checkpoint-migrated onto the
        # remaining fleet instead of waited out — drain time is bounded by
        # one migration per request, and the old forced reap (which killed
        # live streams at drain_timeout) becomes migrate-then-reap. False
        # restores the idle-wait behavior.
        migrate_on_drain: bool = True,
        journal_path=None,
        registry=None,
        slos=None,  # SLO tuple for the burn signal; () disables it
        clock=None,  # injectable monotonic clock (deterministic tests)
    ):
        self.router = router
        self.factory = factory
        self.min_replicas = {"decode": 1, "prefill": 0, **(min_replicas or {})}
        self.max_replicas = {"decode": 4, "prefill": 2, **(max_replicas or {})}
        self.queue_high = float(queue_high)
        self.kv_high = float(kv_high)
        self.burn_high = float(burn_high)
        self.shed_high = int(shed_high)
        self.idle_low = float(idle_low)
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.cooldown_s = float(cooldown_s)
        self.tick_s = float(tick_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.migrate_on_drain = bool(migrate_on_drain)
        #: per-victim decode tokens carried off by drain migrations (what
        #: fleet.jsonl records instead of requests killed)
        self._drained_tokens: dict[str, int] = {}
        #: per-victim (last_attempt_at, consecutive_failures): a victim
        #: whose requests cannot move yet (targets shedding) is retried
        #: with a growing backoff instead of every tick — without this a
        #: stuck 60 s drain window would spam ~120 journal records,
        #: fallback metrics, and failover spans per request
        self._drain_attempts: dict[str, tuple[float, int]] = {}
        #: last shared-prefix-store heartbeat round (the controller is the
        #: fleet's one periodic loop, so it keeps every replica's store
        #: membership alive; throttled — TTL is tens of seconds)
        self._last_store_heartbeat = 0.0
        self.journal = named_journal("fleet", path=journal_path)
        self._registry = registry if registry is not None else default_registry
        self._slos = (
            slos
            if slos is not None
            else tuple(s for s in _slo.DEFAULT_SLOS if s.name in _LATENCY_SLO_NAMES)
        )
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._seq = 0
        self._up_streak = {"decode": 0, "prefill": 0}
        self._down_streak = {"decode": 0, "prefill": 0}
        self._cooldown_until = {"decode": 0.0, "prefill": 0.0}
        #: quarantined replicas a "quarantine" scale-up already replaced —
        #: the trigger is per-BENCHING (edge), not per-tick (level): one
        #: replacement per quarantined replica, re-armed when its
        #: quarantine lifts (pruned against the live quarantined set)
        self._quarantine_handled: dict[str, set[str]] = {
            "decode": set(), "prefill": set(),
        }
        #: names this controller created (only these are scale-in victims:
        #: the operator's seed replicas are never reaped)
        self._owned: dict[str, list[str]] = {"decode": [], "prefill": []}
        #: (replica, removed_at) — out of placement, waiting to drain
        self._draining: list[tuple[object, float]] = []
        self._last_sheds = self._registry.total(C.SHEDS_TOTAL)
        self.events: list[dict] = []  # every action taken, newest last
        self._running = False
        self._stopping = False  # stop() requested: discard in-flight builds
        self._thread: threading.Thread | None = None
        self._publish_sizes()

    # -- signals -------------------------------------------------------------

    def _replicas(self, group: str) -> list:
        return [r for r in self.router.replicas if _role_group(r) == group]

    def _burn_rate(self) -> float:
        if not self._slos:
            return 0.0
        reports = _slo.evaluate(
            self._registry, tuple(self._slos),
            burn_rate_registry=self._registry,
        )
        burns = [
            r["burn_rate"] for r in reports
            if r["kind"] == "latency" and r["burn_rate"] is not None
        ]
        return max(burns, default=0.0)

    def signals(self, *, consume_sheds: bool = True) -> dict:
        """One tick's pressure snapshot, per role group (also the
        ``/fleet`` payload's ``signals`` block). ``consume_sheds=False``
        reads the shed delta without resetting the tick baseline — the
        read-only path for :meth:`stats`, so an observer polling ``/fleet``
        cannot eat the controller's shed-pressure signal."""
        # canary probes (observability/canary.py) are synthetic: a shed or
        # queued probe is the canary observing pressure, not pressure worth
        # buying a replica for — subtract the canary class from both signals
        sheds = self._registry.total(C.SHEDS_TOTAL) - self._registry.total(
            C.SHEDS_TOTAL, {"class": "canary"}
        )
        shed_delta = sheds - self._last_sheds
        if consume_sheds:
            self._last_sheds = sheds
        out: dict = {"sheds_delta": shed_delta, "burn_rate": self._burn_rate()}
        for group in ("decode", "prefill"):
            everyone = self._replicas(group)
            # a watchdog-quarantined replica (serving/health.py) is benched
            # capacity: it serves nothing, so
            # counting it would mask the exact pressure its absence
            # creates. The flag read is cheap and side-effect-free
            # (healthy() would consume fault-plan hits).
            quarantined = [
                r for r in everyone if getattr(r, "quarantined", False)
            ]
            replicas = [
                r for r in everyone if not getattr(r, "quarantined", False)
            ]
            if not replicas:
                out[group] = None
                continue
            # synthetic canary probes (observability/canary.py) are not
            # demand: a queued probe must never scale the fleet. depths()
            # is guarded — test fakes stub only total_depth()
            queued = sum(
                r.engine.policy.total_depth()
                - getattr(r.engine.policy, "depths", dict)().get("canary", 0)
                for r in replicas
            )
            outstanding = sum(r.outstanding() for r in replicas)
            capacity = sum(max(1, r.capacity()) for r in replicas)
            kv = max(self._kv_pressure(r.engine) for r in replicas)
            out[group] = {
                "replicas": len(replicas),
                "quarantined": len(quarantined),
                "quarantined_names": sorted(r.name for r in quarantined),
                "queued": queued,
                "queued_per_replica": queued / len(replicas),
                "outstanding": outstanding,
                "capacity": capacity,
                "utilization": outstanding / capacity,
                "kv_occupancy": kv,
            }
        return out

    @staticmethod
    def _kv_pressure(engine) -> float:
        """Occupancy that actually pins pages: allocated MINUS the prefix
        cache's reclaimable warmth, PLUS queued admissions' reservations.
        Raw ``occupancy()`` would read ~1.0 forever on a warm engine whose
        trie has absorbed the free pool — warmth is evictable on demand,
        and scaling out on it is pure flap."""
        occ = engine.cache.occupancy()
        cached = (
            engine.prefix_cache.cached_pages
            if engine.prefix_cache is not None
            else 0
        )
        pinned = max(0, occ["pages_used"] - cached) + getattr(
            engine.admission, "reserved_pages", 0
        )
        return min(1.0, pinned / max(1, occ["pages_total"]))

    def _pressure_trigger(self, group: str, sig: dict, fleet: dict) -> str | None:
        """The scale-up trigger for this group, or None. Prefill replicas
        have no decode latency to defend: only their own backlog counts."""
        q_names = set(sig.get("quarantined_names", ()))
        handled = self._quarantine_handled[group]
        handled &= q_names  # quarantine lifted: re-arm for a later re-bench
        if q_names - handled:
            # the watchdog benched a replica for repeated wedges: replace
            # its capacity via a snapshot warm boot NOW rather than waiting
            # for the queues the hole will back up. Edge-
            # triggered per benched replica — the scale-up marks it handled,
            # so a 30s quarantine does not buy a build every cooldown
            return "quarantine"
        if sig["queued_per_replica"] > self.queue_high or (
            group == "prefill"
            and sig["outstanding"] / max(1, sig["replicas"]) > self.queue_high
        ):
            return "queue_pressure"
        if sig["kv_occupancy"] > self.kv_high:
            return "kv_pressure"
        if group == "decode" and fleet["sheds_delta"] >= self.shed_high > 0:
            return "shed_pressure"
        if group == "decode" and fleet["burn_rate"] > self.burn_high:
            return "slo_burn"
        return None

    # -- the control loop ----------------------------------------------------

    def tick(self) -> list[dict]:
        """One control-loop pass; returns the actions taken (also appended
        to :attr:`events`). Safe to call directly in tests instead of
        running the background thread.

        Scale-up BUILDS run outside the controller lock: restoring a
        multi-GB param tree and building an engine can take seconds,
        and an operator polling :meth:`stats` (or :meth:`stop`) must not
        block behind it. Only one caller drives ticks (the background
        thread, or a test), so deferring the build past the lock cannot
        interleave two decisions."""
        with self._lock:
            actions, deferred = self._tick_locked()
        for group, trigger, sig in deferred:
            rec = self._scale_up(group, trigger, sig)
            with self._lock:
                self._cooldown_until[group] = self._clock() + self.cooldown_s
                self.events.append(rec)
                del self.events[:-512]
                self._publish_sizes()
            actions.append(rec)
        return actions

    def _tick_locked(self) -> tuple[list[dict], list[tuple]]:
        now = self._clock()
        actions: list[dict] = []
        deferred: list[tuple] = []  # (group, trigger, sig) builds to run
        self._reap_drained(now)
        if now - self._last_store_heartbeat >= 15.0:
            self._last_store_heartbeat = now
            for r in self.router.replicas:
                store = shared_prefix_store(r)
                if store is not None:
                    try:
                        store.heartbeat()
                    except Exception:
                        pass
        fleet = self.signals()
        for group in ("decode", "prefill"):
            sig = fleet.get(group)
            if sig is None:
                # a group with no replicas yet only scales up if the
                # operator declared a floor for it
                if self.min_replicas.get(group, 0) > 0:
                    deferred.append((group, "min_replicas", {}))
                continue
            if sig["replicas"] < self.min_replicas.get(group, 0):
                # below the declared floor: fill unconditionally (no
                # hysteresis/cooldown — the floor is a hard promise)
                deferred.append((group, "min_replicas", sig))
                continue
            trigger = self._pressure_trigger(group, sig, fleet)
            if trigger is not None:
                self._down_streak[group] = 0
                self._up_streak[group] += 1
                if (
                    self._up_streak[group] >= self.up_ticks
                    and now >= self._cooldown_until[group]
                    and sig["replicas"] < self.max_replicas.get(group, 0)
                ):
                    deferred.append((group, trigger, sig))
                    self._up_streak[group] = 0
                    self._cooldown_until[group] = self._clock() + self.cooldown_s
                    if trigger == "quarantine":
                        # one replacement per benched replica: mark exactly
                        # one unhandled name; any further quarantined
                        # replicas keep the trigger armed for the next tick
                        new = (
                            set(sig["quarantined_names"])
                            - self._quarantine_handled[group]
                        )
                        if new:
                            self._quarantine_handled[group].add(min(new))
                continue
            self._up_streak[group] = 0
            n = sig["replicas"]
            idle = (
                sig["queued"] == 0
                and n > self.min_replicas.get(group, 0)
                and sig["outstanding"]
                <= self.idle_low * (sig["capacity"] - sig["capacity"] / n)
            )
            if idle:
                self._down_streak[group] += 1
                if (
                    self._down_streak[group] >= self.down_ticks
                    and now >= self._cooldown_until[group]
                ):
                    act = self._scale_down(group, sig)
                    if act is not None:
                        actions.append(act)
                        self._down_streak[group] = 0
                        self._cooldown_until[group] = (
                            self._clock() + self.cooldown_s
                        )
            else:
                self._down_streak[group] = 0
        self._publish_sizes()
        self.events.extend(actions)
        del self.events[:-512]  # bounded like the journal ring
        return actions, deferred

    def _scale_up(self, group: str, trigger: str, sig: dict) -> dict:
        """Build, start, warm, and register one replica. Runs OUTSIDE the
        controller lock (see :meth:`tick`); only ``_owned`` is touched
        under it."""
        with self._lock:
            self._seq += 1
            name = f"{group}-as{self._seq}"
        role = "prefill" if group == "prefill" else "decode"
        t0 = time.perf_counter()
        out = self.factory(name, role)
        replica, boot = out if isinstance(out, tuple) else (out, "cold")
        if getattr(replica, "serves_requests", True):
            replica.engine.start()
        with self._lock:
            stopping = self._stopping
        if stopping:
            # stop() arrived while this build was in flight (its thread
            # join timed out): registering now would hand a running engine
            # to a fleet nobody owns — discard the build instead
            try:
                replica.engine.stop()
            except Exception:
                logger.warning("fleet: engine stop failed for %s", name)
            _deregister_prefix_store(replica)
            rec = {
                "at": time.time(), "action": "scale_up", "trigger": trigger,
                "role": group, "replica": name, "boot": boot,
                "aborted": "controller_stopping",
            }
            self.journal.record(rec)
            logger.info("fleet: discarded in-flight build of %s (stopping)", name)
            return rec
        try:
            self.router.add_replica(replica)
        except Exception:
            # registration refused (e.g. a name collision with a replica a
            # previous controller left behind): the engine is already
            # running — stop it rather than leak a scheduler thread plus a
            # full weight set with no owner
            try:
                replica.engine.stop()
            except Exception:
                logger.warning("fleet: engine stop failed for %s", name)
            _deregister_prefix_store(replica)
            raise
        boot_s = time.perf_counter() - t0
        with self._lock:
            self._owned[group].append(name)
        _obs.record_fleet_decision("scale_up", trigger, registry=self._registry)
        _obs.record_fleet_boot(boot_s, boot, registry=self._registry)
        rec = {
            "at": time.time(),
            "action": "scale_up",
            "trigger": trigger,
            "role": group,
            "replica": name,
            "boot": boot,
            "boot_s": round(boot_s, 4),
            "queued": sig.get("queued", 0),
            "kv_occupancy": round(sig.get("kv_occupancy", 0.0), 4),
            "replicas_before": sig.get("replicas", 0),
            "replicas_after": sig.get("replicas", 0) + 1,
        }
        self.journal.record(rec)
        logger.info(
            "fleet scale_up %s (%s, %s boot %.3fs)", name, trigger, boot, boot_s
        )
        return rec

    def _scale_down(self, group: str, sig: dict) -> dict | None:
        # newest owned replica that is healthy — idle preferred, but with
        # drain-by-migration a BUSY victim is eligible too: its live
        # requests move to the remaining fleet in one migration each
        # (serving/failover.py), so scale-in no longer waits for request
        # completion. The seed fleet is never reaped, and a replica on the
        # router's down list is the health re-admission cycle's business,
        # not ours (anti-flap).
        victim = None
        busy = None
        for name in reversed(self._owned[group]):
            r = next(
                (x for x in self.router.replicas if x.name == name), None
            )
            if r is None or not r.healthy():
                continue
            if r.outstanding() == 0:
                victim = r
                break
            if (
                busy is None
                and self.migrate_on_drain
                # only engines with the live-migration surface: a busy
                # victim that cannot migrate would fall straight into the
                # drain_timeout forced reap (_reap_drained's duck-typing)
                and hasattr(r.engine, "migrate_out")
            ):
                busy = r
        if victim is None:
            victim = busy
        if victim is None:
            return None
        self.router.remove_replica(victim.name)
        self._owned[group].remove(victim.name)
        self._draining.append((victim, self._clock()))
        _obs.record_fleet_decision("scale_down", "idle", registry=self._registry)
        rec = {
            "at": time.time(),
            "action": "scale_down",
            "trigger": "idle",
            "role": group,
            "replica": victim.name,
            "queued": sig.get("queued", 0),
            "outstanding": sig.get("outstanding", 0),
            "replicas_before": sig.get("replicas", 0),
            "replicas_after": sig.get("replicas", 0) - 1,
        }
        self.journal.record(rec)
        logger.info("fleet scale_down %s (idle, draining)", victim.name)
        return rec

    def _reap_drained(self, now: float) -> None:
        """Stop the engines of removed replicas once their last requests
        are gone. With ``migrate_on_drain`` a victim's live requests are
        checkpoint-migrated onto the remaining fleet RIGHT HERE
        (serving/failover.py) — drain time is bounded by one migration per
        request, not request completion, and ``fleet.jsonl`` records the
        ``tokens_migrated`` carried off instead of requests killed. A
        replica that still will not drain within ``drain_timeout_s`` is
        stopped anyway (its engine releases any caller loudly; the
        router-level stream failover then resumes them reactively) — a
        leak bounded in time beats a zombie engine held forever."""
        still: list[tuple[object, float]] = []
        for replica, removed_at in self._draining:
            timed_out = now - removed_at > self.drain_timeout_s
            last_at, fails = self._drain_attempts.get(replica.name, (0.0, 0))
            if (
                self.migrate_on_drain
                and replica.outstanding() > 0
                and getattr(replica, "serves_requests", True)
                # duck-typed: only engines with the live-migration surface
                # (a remote/fake replica without it keeps the idle-wait +
                # timeout behavior)
                and hasattr(replica.engine, "migrate_out")
                # backoff: after N consecutive no-progress attempts, wait
                # tick_s * 2^N (capped) before trying again
                and now - last_at >= min(self.tick_s * (2 ** fails), 10.0)
            ):
                try:
                    from ..serving import failover as _failover

                    moved = _failover.drain_replica(replica, self.router)
                except Exception:
                    logger.exception(
                        "fleet: drain migration failed for %s", replica.name
                    )
                    moved = None
                progressed = bool(
                    moved and (moved["migrated"] or moved["resumed"])
                )
                self._drain_attempts[replica.name] = (
                    now, 0 if progressed else fails + 1
                )
                # journal progress always; pure-failure attempts only once
                # per stuck victim (the retry spam the backoff bounds)
                if moved and (
                    progressed or (moved["failed"] and fails == 0)
                ):
                    self._drained_tokens[replica.name] = (
                        self._drained_tokens.get(replica.name, 0)
                        + moved["tokens_migrated"]
                    )
                    rec = {
                        "at": time.time(),
                        "action": "drain_migrate",
                        "role": _role_group(replica),
                        "replica": replica.name,
                        **moved,
                    }
                    self.journal.record(rec)
                    self.events.append(rec)
                    logger.info(
                        "fleet drain_migrate %s: %s", replica.name, moved
                    )
            if replica.outstanding() == 0 or timed_out:
                try:
                    if timed_out and replica.outstanding() > 0:
                        # forced reap with live streams: release them as
                        # ERRORS so the router-level reactive failover
                        # resumes them — a "stop" release would end them
                        # as silently truncated successes
                        try:
                            replica.engine.stop(reason="error")
                        except TypeError:  # engine without the kwarg
                            replica.engine.stop()
                    else:
                        replica.engine.stop()
                except Exception:
                    logger.warning(
                        "fleet: engine stop failed for %s", replica.name
                    )
                _deregister_prefix_store(replica)
                if timed_out:
                    _obs.record_fleet_decision(
                        "scale_down", "drain_timeout",
                        registry=self._registry,
                    )
                    self.journal.record({
                        "at": time.time(),
                        "action": "scale_down",
                        "trigger": "drain_timeout",
                        "role": _role_group(replica),
                        "replica": replica.name,
                        "tokens_migrated": self._drained_tokens.get(
                            replica.name, 0
                        ),
                    })
                self._drained_tokens.pop(replica.name, None)
                self._drain_attempts.pop(replica.name, None)
            else:
                still.append((replica, removed_at))
        self._draining = still

    def _publish_sizes(self) -> None:
        counts = {"prefill": 0, "decode": 0, "unified": 0}
        for r in self.router.replicas:
            counts[getattr(r, "role", "unified")] += 1
        for role, n in counts.items():
            _obs.set_fleet_replicas(role, n, registry=self._registry)

    # -- lifecycle / surfaces ------------------------------------------------

    def start(self) -> "FleetAutoscaler":
        if self._running:
            return self
        # re-baseline the shed delta at loop start: sheds recorded between
        # construction and start (e.g. a pinned-fleet A/B arm run first)
        # are history, not pressure — without this the first tick would
        # scale out on traffic this controller never saw
        self._last_sheds = self._registry.total(C.SHEDS_TOTAL)
        self._stopping = False
        self._running = True

        def loop():
            while self._running:
                try:
                    self.tick()
                except Exception:
                    logger.exception("fleet autoscaler tick failed")
                time.sleep(self.tick_s)

        self._thread = threading.Thread(
            target=loop, name="fleet-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        with self._lock:
            self._stopping = True
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if drain:
            with self._lock:
                # REAL time here, even under an injected fake clock: the
                # wait advances via sleep, and a fake clock that never
                # moves would spin this loop forever
                deadline = time.monotonic() + self.drain_timeout_s
                while self._draining and time.monotonic() < deadline:
                    self._reap_drained(self._clock())
                    if self._draining:
                        time.sleep(0.02)
                # anything still draining at the deadline is force-reaped
                self._reap_drained(self._clock() + self.drain_timeout_s + 1)

    def stats(self) -> dict:
        """Live controller snapshot (the ``/fleet`` route's payload half
        that cannot be reconstructed from pushed metrics)."""
        with self._lock:
            counts: dict[str, int] = {}
            for r in self.router.replicas:
                role = getattr(r, "role", "unified")
                counts[role] = counts.get(role, 0) + 1
            return {
                "replicas": counts,
                "owned": {k: list(v) for k, v in self._owned.items()},
                "draining": [r.name for r, _t in self._draining],
                "events": list(self.events[-50:]),
                "signals": self.signals(consume_sheds=False),
            }
