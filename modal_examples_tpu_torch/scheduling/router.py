"""Prefix-affinity multi-replica routing, a copy of
``modal_examples_tpu/scheduling/router.py``.

N replicas behind one front: a random front wastes the paged-KV prefix
cache, since two requests sharing a system prompt land on different
replicas and each pays the full prefill. This router keys every request by
its first ``prefix_tokens`` prompt tokens and sends equal keys to the same
replica by rendezvous hashing (:func:`rendezvous_score`), so prefix reuse
hits.

Fallbacks keep affinity from becoming a hotspot: a **saturated** replica
(outstanding work >= ``saturation_factor`` x its slots) diverts new prompts
to the least-loaded healthy replica; an **unhealthy** one is marked down
for ``reprobe_s`` seconds, then re-probed (``EngineReplica.probe`` revives a
stopped-on-error engine) and re-admitted on success
(``mtpu_router_readmissions_total``). The gray-failure watchdog's graded
signal is :meth:`PrefixAffinityRouter.set_health_weight`: a down-weighted
replica loses affinity preference and competes as if busier.
:meth:`PrefixAffinityRouter.plan` is the disaggregated placement (a prefill
replica by prefix affinity and its decode peer), and
:meth:`PrefixAffinityRouter.failover_target` the resume target of a failed
request. ``mtpu_router_requests_total{route=affinity|fallback}`` counts
placements and ``mtpu_router_affinity_hits_total`` the repeated keys that
landed where their prefix KV is.

Replicas are duck-typed (``name``/``encode``/``submit``/``stream``/
``abort``/``outstanding``/``capacity``/``healthy``): :class:`EngineReplica`
adapts an in-process ``LLMEngine``; an ``image=`` rides through to an
engine built with ``vision=``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict

from ..faults import inject as _inject
from ..observability import metrics as _obs
from ..observability import reqtrace as _rt


#: disaggregated-serving roles (docs/disagg.md): a ``prefill`` replica only
#: computes prompt KV and ships pages (its engine never starts a scheduler
#: loop); a ``decode`` replica adopts shipped pages and continues decoding
#: (and can re-prefill as the unified fallback); ``unified`` does both.
ROLES = ("prefill", "decode", "unified")


def rendezvous_score(key: bytes, name: str) -> bytes:
    """THE fleet's rendezvous (highest-random-weight) score: ``max`` of
    this over member names picks the owner of ``key``. One function on
    purpose — request placement (:meth:`PrefixAffinityRouter._preferred`)
    and prefix-chain spill ownership (:mod:`..serving.prefix_store`) must
    agree on the hash, so the replica a shared prefix routes to is also
    the replica that owns spilling it."""
    return hashlib.sha1(key + name.encode()).digest()


class EngineReplica:
    """Adapter: one in-process ``LLMEngine`` as a routable replica."""

    def __init__(
        self,
        engine,
        name: str,
        *,
        saturation_factor: float = 2.0,
        role: str = "unified",
    ):
        if role not in ROLES:
            raise ValueError(f"unknown replica role {role!r}; one of {ROLES}")
        self.engine = engine
        self.name = name
        self.role = role
        # gray-failure watchdog surface (serving/health.py, docs/health.md):
        # the watchdog writes the graded classification here and benches a
        # repeatedly-wedging replica via the quarantine flag — healthy()
        # and probe() both honor it, so neither placement nor the router's
        # revival probe can resurrect a quarantined replica early
        self.health_state = "healthy"
        self.quarantined = False
        if role == "prefill" and hasattr(engine, "prefill_budget"):
            # prefill replicas have no decode to protect: the per-tick
            # prefill token budget (docs/scheduling.md, stall-free
            # admission) defaults to unlimited here even when
            # MTPU_PREFILL_BUDGET is set process-wide for the decode side
            engine.prefill_budget = 0
        self.saturation_factor = float(saturation_factor)
        # request-trace spans carry the FLEET name of the replica that
        # recorded them (track assignment in the Perfetto export); adopt
        # the engine unless something already named it
        if getattr(engine, "trace_name", "engine") == "engine":
            engine.trace_name = name

    @property
    def serves_requests(self) -> bool:
        """Whether this replica can own a full request end to end (prefill-
        only replicas cannot: they hold no decode loop)."""
        return self.role != "prefill"

    def encode(self, prompt: str) -> list[int]:
        return self.engine.tokenizer.encode(prompt)

    def submit(self, prompt: str, params=None, **kw):
        return self.engine.submit(prompt, params, **kw)

    def stream(self, req):
        return self.engine.stream(req)

    def abort(self, req) -> None:
        self.engine.abort(req)

    def outstanding(self) -> int:
        """Waiting + decoding requests (the router's load signal); for a
        prefill-role replica, slot-free prefills in flight count too."""
        active = sum(1 for s in self.engine.slots if not s.free)
        pending = getattr(self.engine, "_prefill_sync_pending", 0)
        return self.engine.policy.total_depth() + active + pending

    def capacity(self) -> int:
        return self.engine.max_slots

    def healthy(self) -> bool:
        if self.quarantined:
            return False
        # fault point (docs/faults.md): one flapped health observation —
        # the router evicts, re-probes, and re-admits this replica
        if _inject.fire("router.health_flap"):
            return False
        return not self.engine._stopped_on_error

    def probe(self) -> bool:
        """Re-admission probe (router, after ``reprobe_s`` down): a replica
        whose engine stopped on a scheduler error is revived and restarted
        — every caller it owed was already released with
        finish_reason="error", so it comes back empty. Prefill-role
        replicas never start a scheduler loop, so they only re-check
        health. A QUARANTINED replica refuses the probe outright: the
        watchdog benched it for repeated wedges and owns lifting the flag
        (docs/health.md) — reviving it early would put a known-bad replica
        back in placement. Returns post-probe health."""
        if self.quarantined:
            return False
        eng = self.engine
        if eng._stopped_on_error and self.serves_requests:
            try:
                eng.revive().start()
            except Exception:
                return False
        return self.healthy()

    def saturated(self) -> bool:
        return self.outstanding() >= self.saturation_factor * max(
            1, self.capacity()
        )

    def stats(self) -> dict:
        """Per-replica snapshot for router/gateway/CLI surfaces, including
        the last-progress watermark ages (read through the health API —
        docs/health.md; ``tpurun top`` and ``/health`` render these)."""
        from ..serving.health import replica_snapshot

        return {
            "role": self.role,
            "outstanding": self.outstanding(),
            "healthy": self.healthy(),
            "saturated": self.saturated(),
            "state": self.health_state,
            "quarantined": self.quarantined,
            "progress": replica_snapshot(self),
        }


class PrefixAffinityRouter:
    """Route requests to replicas by shared-prefix affinity."""

    #: remembered key -> replica-name placements (bounded LRU): an affinity
    #: *hit* requires the key to have been routed there before — the first
    #: occurrence builds the prefix KV, repeats reuse it
    SEEN_KEYS_MAX = 4096

    #: seconds a replica observed unhealthy stays out of the candidate set
    #: before the router re-probes it (ctor-overridable; short enough that
    #: a transient flap costs one probe interval, long enough that a truly
    #: dead replica isn't probed on every request)
    REPROBE_S = 5.0

    def __init__(
        self,
        replicas: list,
        *,
        prefix_tokens: int = 16,
        reprobe_s: float | None = None,
        clock=None,  # injectable monotonic clock (fake-clock flap tests)
    ):
        if not replicas:
            raise ValueError("router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        self.replicas = list(replicas)
        self.prefix_tokens = max(1, int(prefix_tokens))
        self.reprobe_s = float(
            reprobe_s if reprobe_s is not None else self.REPROBE_S
        )
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._seen: OrderedDict[bytes, str] = OrderedDict()
        #: replica name -> next re-probe time (monotonic): the down list.
        #: Present = excluded from candidates until probed healthy again.
        self._down: dict[str, float] = {}
        #: replica name -> placement weight in (0, 1]: the GRADED health
        #: signal next to the binary healthy()/down cycle. The gray-failure
        #: watchdog down-weights a degraded replica (docs/health.md); a
        #: weight below 1.0 loses affinity preference and costs
        #: proportionally more in every least-loaded comparison, so new
        #: work drains away without cutting the replica off entirely.
        self._weights: dict[str, float] = {}
        self.affinity_hits = 0
        self.fallbacks = 0
        self.readmissions = 0
        # role-aware split (replicas without a .role are unified): route()
        # only ever places full requests on serving-capable replicas;
        # prefill-only ones are plan()'s business
        self._serving = [
            r for r in self.replicas
            if getattr(r, "role", "unified") != "prefill"
        ]
        if not self._serving:
            raise ValueError(
                "router needs at least one decode-capable (non-prefill) "
                "replica to own requests"
            )

    # -- fleet membership (modal_examples_tpu/fleet, docs/fleet.md) ----------

    def add_replica(self, replica) -> None:
        """Register a replica under live traffic. Rendezvous hashing means
        only the keys the newcomer now wins remap to it — every other
        prompt keeps its affinity replica, so a scale-out never stampedes
        the prefix caches. Lists are rebuilt copy-on-write under the lock;
        in-flight ``route()`` calls finish against the snapshot they read."""
        if getattr(replica, "role", "unified") not in ROLES:
            raise ValueError(f"unknown replica role {replica.role!r}")
        with self._lock:
            if any(r.name == replica.name for r in self.replicas):
                raise ValueError(f"replica name {replica.name!r} already registered")
            replicas = self.replicas + [replica]
            self.replicas = replicas
            self._serving = [
                r for r in replicas
                if getattr(r, "role", "unified") != "prefill"
            ]

    def remove_replica(self, name: str):
        """Deregister a replica from placement; returns it. The replica
        stops receiving NEW requests immediately, but requests it already
        owns keep streaming (ownership rides on the request, not on the
        router), so the caller drains ``outstanding()`` to zero before
        stopping the engine — see ``FleetAutoscaler._scale_down``."""
        with self._lock:
            victim = next((r for r in self.replicas if r.name == name), None)
            if victim is None:
                raise KeyError(f"no replica named {name!r}")
            replicas = [r for r in self.replicas if r.name != name]
            serving = [
                r for r in replicas
                if getattr(r, "role", "unified") != "prefill"
            ]
            if getattr(victim, "role", "unified") != "prefill" and not serving:
                raise ValueError(
                    "cannot remove the last decode-capable replica"
                )
            self.replicas = replicas
            self._serving = serving
            self._down.pop(name, None)
        return victim

    # -- placement -----------------------------------------------------------

    def _key(self, tokens: list[int]) -> bytes:
        head = tokens[: self.prefix_tokens]
        return hashlib.sha1(
            b",".join(str(int(t)).encode() for t in head)
        ).digest()

    def _preferred(self, key: bytes, candidates: list | None = None):
        """Rendezvous (highest-random-weight) hashing: stable per key, and
        removing a replica only remaps that replica's keys."""
        def score(replica) -> bytes:
            return rendezvous_score(key, replica.name)

        return max(
            candidates if candidates is not None else self.replicas, key=score
        )

    def _candidates(self, pool: list) -> list:
        """The healthy members of ``pool``, with down-tracking + re-probe.

        An unhealthy observation marks the replica down. While down it
        still gets the CHEAP ``healthy()`` recheck every placement —
        ``healthy()`` flipping back true re-admits it on the spot — but
        the EXPENSIVE ``probe()`` (which may revive and restart a
        stopped-on-error engine, ``EngineReplica.probe``) only runs once
        ``reprobe_s`` has passed, and a failed probe pushes the next one
        out by another interval. So a transient flap costs at most one
        placement, while a truly dead replica is revival-attempted at a
        bounded rate."""
        now = self._clock()
        out = []
        for r in pool:
            with self._lock:
                due = self._down.get(r.name)
            if due is None:
                if r.healthy():
                    out.append(r)
                else:
                    with self._lock:
                        self._down[r.name] = now + self.reprobe_s
                continue
            if r.healthy():
                self._readmit(r.name)
                out.append(r)
                continue
            if now < due:
                continue  # still down; not revival-probe time yet
            probe = getattr(r, "probe", None)
            if probe is not None and probe():
                self._readmit(r.name)
                out.append(r)
            else:
                with self._lock:
                    self._down[r.name] = now + self.reprobe_s
        return out

    # -- graded health (serving/health.py watchdog, docs/health.md) ----------

    def set_health_weight(self, name: str, weight: float) -> None:
        """Down-weight (or restore) one replica's placement. ``weight`` in
        (0, 1]; 1.0 clears the entry. In-flight requests are untouched —
        this only shapes where NEW work lands."""
        w = float(weight)
        if not (0.0 < w <= 1.0):
            raise ValueError(f"health weight must be in (0, 1], got {w}")
        with self._lock:
            if w >= 1.0:
                self._weights.pop(name, None)
            else:
                self._weights[name] = w

    def health_weight(self, name: str) -> float:
        with self._lock:
            return self._weights.get(name, 1.0)

    def reprobe(self) -> list:
        """One down-tracking/probe pass with no placement: the same
        ``_candidates`` walk a submit runs, minus the request. Returns
        the currently healthy replicas. Re-admission (and the revival
        probe of a stopped-on-error engine) otherwise only advances when
        a placement lands — with traffic stopped, a replica that died at
        the end of a load window would stay down forever. Operators and
        the chaos invariants (``faults.chaos.settle_recovered``) call
        this to settle recovery without synthesizing traffic."""
        return self._candidates(self.replicas)

    def _effective_load(self, replica) -> float:
        """Outstanding work scaled by the inverse health weight: a
        degraded replica at weight 0.25 competes as if 4x busier, plus a
        constant bias so an idle degraded replica still loses to an idle
        healthy one."""
        w = self.health_weight(replica.name)
        load = replica.outstanding() / w
        if w < 1.0:
            load += 1.0 / w
        return load

    def _readmit(self, name: str) -> None:
        with self._lock:
            self._down.pop(name, None)
            self.readmissions += 1
        _obs.record_router_readmission()

    def _prompt_key(self, prompt: str) -> bytes:
        # tokenize only enough text to cover the key's token prefix (the
        # engine re-encodes the full prompt at submit anyway — hashing the
        # whole thing here would pay full tokenization twice per request)
        head = prompt[: max(64, 8 * self.prefix_tokens)]
        return self._key(self.replicas[0].encode(head))

    def route(self, prompt: str):
        """Pick the serving replica for ``prompt``; records routing metrics.
        Prefill-only replicas are never chosen here — they cannot own a
        request (see :meth:`plan` for disaggregated placement)."""
        return self._route_ex(prompt)[0]

    def _route_ex(self, prompt: str):
        """:meth:`route` plus the placement kind — ``(replica,
        "affinity"|"fallback")`` — for the submit path's placement span."""
        key = self._prompt_key(prompt)
        preferred = self._preferred(key, self._serving)
        healthy = self._candidates(self._serving)
        if not healthy:
            raise RuntimeError("no healthy replicas")
        if (
            preferred in healthy
            and not preferred.saturated()
            # a down-weighted (degraded) replica loses affinity preference:
            # prefix warmth is not worth placing onto a replica the
            # watchdog says is limping (docs/health.md)
            and self.health_weight(preferred.name) >= 1.0
        ):
            chosen, route = preferred, "affinity"
        else:
            chosen = min(
                healthy, key=lambda r: (self._effective_load(r), r.name)
            )
            route = "fallback"
        with self._lock:
            hit = route == "affinity" and self._seen.get(key) == chosen.name
            self._seen[key] = chosen.name
            self._seen.move_to_end(key)
            while len(self._seen) > self.SEEN_KEYS_MAX:
                self._seen.popitem(last=False)
            if hit:
                self.affinity_hits += 1
            if route == "fallback":
                self.fallbacks += 1
        _obs.record_router_route(route, affinity_hit=hit)
        return chosen, route

    def plan(self, prompt: str):
        """Disaggregated placement: ``(prefill_replica | None,
        decode_replica)``.

        The prefill replica is chosen by PREFIX-BLOCK affinity among
        healthy, unsaturated prefill-role replicas — its prefix trie holds
        the shared-prefix KV, so a repeated system prompt prefills once and
        ships from cache-warm pages. Its decode target is a stable
        rendezvous pairing over decode-capable replicas (each prefill
        replica streams to "its" decode peer, keeping transfer fan-in
        bounded), diverted to the least-outstanding healthy one when the
        pair is saturated. ``None`` prefill means no healthy prefill peer:
        the caller serves unified on the returned decode replica."""
        key = self._prompt_key(prompt)
        decoders = self._candidates(self._serving)
        if not decoders:
            raise RuntimeError("no healthy decode-capable replicas")
        prefillers = [
            r for r in self._candidates([
                r for r in self.replicas
                if getattr(r, "role", "unified") == "prefill"
            ])
            if not r.saturated()
        ]
        if not prefillers:
            chosen = min(
                decoders, key=lambda r: (self._effective_load(r), r.name)
            )
            with self._lock:
                self.fallbacks += 1
            _obs.record_router_route("fallback")
            return None, chosen
        pre = self._preferred(key, prefillers)
        pair = self._preferred(
            hashlib.sha1(pre.name.encode()).digest(), decoders
        )
        if pair.saturated() or self.health_weight(pair.name) < 1.0:
            pair = min(
                decoders, key=lambda r: (self._effective_load(r), r.name)
            )
        with self._lock:
            hit = self._seen.get(key) == pre.name
            self._seen[key] = pre.name
            self._seen.move_to_end(key)
            while len(self._seen) > self.SEEN_KEYS_MAX:
                self._seen.popitem(last=False)
            if hit:
                self.affinity_hits += 1
        _obs.record_router_route("affinity", affinity_hit=hit)
        return pre, pair

    # -- request lifecycle (delegates to the owning replica) -----------------

    def submit(self, prompt: str, params=None, *, trace=_rt.UNSET, **kw):
        # distributed tracing: mint the request's context HERE when no
        # entry point upstream did (trace id becomes the request id; an
        # upstream None means SAMPLED OUT and passes through); the routing
        # decision itself is a `placement` span, and a health flap
        # observed during it lands as a fault event via the ambient frame
        ctx = _rt.resolve_entry_trace(trace, "router")
        t0 = time.time()
        with _rt.active(ctx, replica="router"):
            replica, route = self._route_ex(prompt)
        _rt.record_span(
            ctx, "placement", start=t0, replica="router", route=route,
            decode_replica=replica.name,
        )
        req = replica.submit(prompt, params, trace=ctx, **kw)
        # ownership rides ON the request (not a router-side map that would
        # grow one entry per request forever): the request's lifetime IS
        # the mapping's lifetime
        req._router_replica = replica
        return req

    def replica_for(self, req):
        replica = getattr(req, "_router_replica", None)
        if replica is None:
            raise KeyError(f"request {req.request_id} not routed here")
        return replica

    def failover_target(self, exclude: str | None = None):
        """A healthy decode-capable replica to resume a failed request on
        (serving/failover.py, docs/failover.md): least-outstanding among
        healthy serving replicas, preferring any replica other than
        ``exclude`` — but allowing ``exclude`` itself when it is the only
        healthy one left (an injected transient crash leaves the engine
        alive and able to take its own requests back). None = no healthy
        replica; the caller surfaces the error honestly."""
        healthy = self._candidates(self._serving)
        pool = [r for r in healthy if r.name != exclude] or healthy
        if not pool:
            return None
        return min(pool, key=lambda r: (self._effective_load(r), r.name))

    def stream(self, req):
        """Stream ``req``'s pieces with in-flight failover: a replica
        dying mid-stream (terminal ``error``) is checkpoint-resumed on a
        healthy peer and the stream continues token-identically — the
        consumer never sees the seam (serving/failover.py)."""
        from ..serving import failover as _failover

        yield from _failover.stream_with_failover(self, req)

    def abort(self, req) -> None:
        self.replica_for(req).abort(req)

    def stats(self) -> dict:
        with self._lock:
            hits, fallbacks, keys, readmissions = (
                self.affinity_hits, self.fallbacks, len(self._seen),
                self.readmissions,
            )
            down = dict(self._down)
            weights = dict(self._weights)

        def one(r) -> dict:
            # EngineReplica grows a stats() with watermark last-progress
            # fields (docs/health.md); bare duck-typed replicas keep the
            # legacy shape
            base = (
                r.stats()
                if hasattr(r, "stats")
                else {
                    "role": getattr(r, "role", "unified"),
                    "outstanding": r.outstanding(),
                    "healthy": r.healthy(),
                    "saturated": r.saturated(),
                }
            )
            base["down"] = r.name in down
            base["weight"] = weights.get(r.name, 1.0)
            return base

        return {
            "replicas": {r.name: one(r) for r in self.replicas},
            "affinity_hits": hits,
            "fallbacks": fallbacks,
            "readmissions": readmissions,
            "keys_tracked": keys,
        }
