"""The seeded chaos runner, a copy of ``modal_examples_tpu/faults/chaos.py``:
drive a mixed-class replica fleet through fault episodes and assert fleet
invariants after every one.

:func:`run_chaos` builds a real fleet (a unified replica plus a
disaggregated prefill/decode pair of ``LlamaConfig.tiny`` engines behind a
:class:`~..serving.disagg.DisaggCoordinator`, the unified and prefill
replicas over one shared prefix store, the gray-failure watchdog over all)
on the card, or on the CPU when the caller asks for it, and runs a fixed
schedule of **episodes**: each arms one small seeded
:class:`~.inject.FaultPlan`, drives traffic through the coordinator, and
then checks the **fleet invariants**:

- **terminal**: every submitted request reached a terminal
  ``finish_reason`` within a timeout: no wedged streams.
- **drained**: on every replica, queues are empty, all slots are free,
  admission page reservations are back to zero, and every allocated KV page
  is accounted for by the prefix cache.
- **conservation**: ``submitted == finished + shed``.
- **router recovered**: no replica is stuck on the down list and every
  replica is healthy.
- **token identity**: any request that finished normally (``stop`` or
  ``length``) produced output identical to a fault-free reference run.

Episode results append to ``<state_dir>/chaos.jsonl`` and the registry is
pushed as job ``chaos``, so ``python -m modal_examples_tpu_torch chaos`` and
the gateway's ``/chaos`` render the run afterwards. Reproduction is
``(seed, episode schedule)``.

This module is a driver: tests and operators import it; no module of the
port does (production code imports :mod:`.inject` only).
"""

from __future__ import annotations

import queue as _queue
import time

from .inject import ALL_FAULT_POINTS, FaultPlan, active

#: per-request drain timeout: generous for CPU-compile stalls, small enough
#: that a genuinely wedged stream fails the run, not the CI timeout
DRAIN_TIMEOUT_S = 120.0

#: the chaos traffic prompt palette: shared prefixes (affinity + tiered
#: promotion) with distinct tails (distinct requests)
_BASE = "the quick brown fox jumps over the lazy dog "
_PROMPTS = [
    _BASE + "and then some more",
    _BASE + "and naps in the sun",
    _BASE + "and then some more",  # repeat: prefix-cache / tier hit
    "completely different prompt about thundering herds",
]


class ChaosInvariantError(AssertionError):
    """A fleet invariant failed after an episode (the report carries the
    violations; the episode name says which plan was armed)."""


# -- invariant checkers -------------------------------------------------------
#
# Standalone, side-effect-free, and duck-typed so tests can hand them
# violating states directly (tests/test_torch_chaos.py).


def check_terminal(results: list) -> list[str]:
    """Every result must carry a terminal finish_reason (no wedges)."""
    out = []
    for r in results:
        if r.get("wedged"):
            out.append(f"request {r.get('id')} wedged (no terminal marker)")
        elif not r.get("finish_reason"):
            out.append(f"request {r.get('id')} has no finish_reason")
    return out


def check_conservation(submitted: int, finished: int, shed: int) -> list[str]:
    """``submitted == finished + shed``: every request either terminated a
    stream or was honestly rejected at admission — nothing vanished."""
    if submitted != finished + shed:
        return [
            f"conservation violated: submitted={submitted} != "
            f"finished={finished} + shed={shed}"
        ]
    return []


def check_drained(engines: dict) -> list[str]:
    """Queues empty, slots free, reservations zero, and every allocated KV
    page accounted for by the prefix cache (non-destructive: cached
    zero-ref pages are warmth, not leaks)."""
    out = []
    for name, eng in engines.items():
        depth = eng.policy.total_depth()
        if depth:
            out.append(f"{name}: {depth} requests still queued")
        busy = sum(1 for s in eng.slots if not s.free)
        if busy:
            out.append(f"{name}: {busy} slots still occupied")
        reserved = eng.admission.reserved_pages
        if reserved:
            out.append(f"{name}: {reserved} KV pages still reserved")
        used = (eng.cache.n_pages - 1) - eng.cache.allocator.available
        cached = (
            eng.prefix_cache.cached_pages
            if eng.prefix_cache is not None
            else 0
        )
        if used != cached:
            out.append(
                f"{name}: {used} pages allocated but only {cached} "
                "prefix-cached — orphaned pages"
            )
    return out


def settle_drained(engines: dict, timeout: float = 10.0,
                   poll_s: float = 0.02) -> list[str]:
    """Poll :func:`check_drained` until clean or ``timeout``; returns the
    final violation list (empty on success). The finish marker is
    delivered to the client queue BEFORE the scheduler thread frees the
    slot and releases its pages, so an *instant* drain check right after
    the last stream joins is racy by construction — and on a starved CI
    box the scheduler thread may lag the client by whole ticks. Settling
    is the honest way to assert drain; a genuinely leaked slot or page
    still fails, just ``timeout`` seconds later."""
    deadline = time.monotonic() + timeout
    while True:
        violations = check_drained(engines)
        if not violations or time.monotonic() >= deadline:
            return violations
        time.sleep(poll_s)


def check_router_recovered(router) -> list[str]:
    """No replica stuck on the down list, and every replica healthy."""
    out = []
    stats = router.stats()
    for name, info in stats["replicas"].items():
        if info.get("down"):
            out.append(f"replica {name} still marked down")
        if not info.get("healthy"):
            out.append(f"replica {name} still unhealthy")
    return out


def settle_recovered(router, timeout: float = 10.0,
                     poll_s: float = 0.05) -> list[str]:
    """Poll :func:`check_router_recovered` until clean or ``timeout``,
    driving the router's re-probe pass (``router.reprobe()``) each round;
    returns the final violation list (empty on success). Re-admission —
    and the revival probe that restarts a stopped-on-error engine — only
    advances on a placement walk, so a replica that died near the END of
    a load window stays marked down once traffic stops, and an instant
    recovery check is racy by construction: the :func:`settle_drained`
    lesson applied to router health. A genuinely unrecoverable replica
    still fails, just ``timeout`` seconds later."""
    deadline = time.monotonic() + timeout
    while True:
        reprobe = getattr(router, "reprobe", None)
        if reprobe is not None:
            reprobe()
        violations = check_router_recovered(router)
        if not violations or time.monotonic() >= deadline:
            return violations
        time.sleep(poll_s)


def check_token_identity(results: list, reference: dict) -> list[str]:
    """Requests that finished normally must match the fault-free reference
    byte for byte — faults may kill requests, never corrupt survivors."""
    out = []
    for r in results:
        if r.get("finish_reason") in ("stop", "length") and not r.get("aborted"):
            ref = reference.get(r["prompt"])
            if ref is not None and r["output"] != ref:
                out.append(
                    f"request {r.get('id')} diverged from the fault-free "
                    f"run: {r['output']!r} != {ref!r}"
                )
    return out


# -- the runner ---------------------------------------------------------------


def _drain(req, timeout: float = DRAIN_TIMEOUT_S) -> dict:
    """Collect one request's stream with a wedge watchdog (the engine's
    ``stream()`` would block forever on a wedged queue — detecting exactly
    that is this harness's job)."""
    from ..serving.engine import _Finish

    out: list[str] = []
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return {
                "id": req.request_id,
                "prompt": req.prompt,
                "output": "".join(out),
                "finish_reason": None,
                "wedged": True,
            }
        try:
            item = req.out_queue.get(timeout=min(remaining, 1.0))
        except _queue.Empty:
            continue
        if isinstance(item, _Finish):
            req.finish_reason = item.reason
            return {
                "id": req.request_id,
                "prompt": req.prompt,
                "output": "".join(out),
                "finish_reason": item.reason,
                "wedged": False,
            }
        out.append(item)


class _Fleet:
    """One unified + one disagg prefill/decode pair behind a coordinator,
    plus a fault-free reference engine — all tiny, all greedy."""

    def __init__(self, seed: int, device=None):
        from ..models import llama
        from ..scheduling import EngineReplica
        from ..serving.engine import LLMEngine
        from ..serving.sampling import SamplingParams
        from ..serving.disagg import DisaggCoordinator
        from ..serving.health import FleetWatchdog, WatchdogPolicy
        from ..storage.volume import Volume

        self.seed = seed
        self.params = SamplingParams(max_tokens=8, temperature=0.0)
        cfg = llama.LlamaConfig.tiny()

        def engine(**kw):
            kw.setdefault("max_slots", 2)
            kw.setdefault("max_model_len", 64)
            kw.setdefault("page_size", 8)
            kw.setdefault("prefill_buckets", (32,))
            return LLMEngine(cfg, seed=0, device=device, **kw)

        # fault-free reference outputs first (greedy: deterministic per
        # prompt, independent of which replica serves it)
        ref_engine = engine()
        try:
            self.reference = {
                p: ref_engine.generate(p, self.params)
                for p in set(_PROMPTS)
            }
        finally:
            ref_engine.stop()

        self.volume_cm = Volume.ephemeral()
        vol = self.volume_cm.__enter__()
        # pre and uni share ONE fleet-wide prefix store over the same
        # volume: rendezvous spill ownership and
        # cross-replica promotion are live in every episode, and the
        # prefix-store-owner-death episode kills whichever of the two the
        # rendezvous made the warm chain's owner
        self.pre = engine(
            tiered_prefix={
                "host_bytes": 1 << 20, "volume": vol,
                "shared": True, "replica": "pre-0",
            }
        )
        self.dec = engine()
        self.uni = engine(
            tiered_prefix={
                "host_bytes": 1 << 20, "volume": vol,
                "shared": True, "replica": "uni-0",
            }
        )
        self.engines = {"pre-0": self.pre, "dec-0": self.dec,
                        "uni-0": self.uni}
        self.coord = DisaggCoordinator(
            [
                EngineReplica(self.pre, "pre-0", role="prefill"),
                EngineReplica(self.dec, "dec-0", role="decode"),
                EngineReplica(self.uni, "uni-0", role="unified"),
            ],
            chunk_bytes=256,
            reprobe_s=0.2,
        )
        # decode-capable loops run for the whole chaos run (the prefill
        # replica's engine must never start)
        for eng in self.coord.serving_engines():
            eng.start()
        # the gray-failure watchdog supervises the whole run: the
        # silent-freeze and transfer-stall episodes
        # are only recoverable because it turns stale watermarks into the
        # error-stop / transfer-abort ladder. Thresholds are generous
        # enough that a slow CI tick never false-positives, small enough that
        # detection + recovery fit well inside DRAIN_TIMEOUT_S; quarantine
        # is effectively off — one freeze episode must take the
        # stop -> revive -> re-probe leg, not the quarantine bench.
        self.watchdog = FleetWatchdog(
            self.coord.router,
            policy=WatchdogPolicy(
                degraded_after_s=2.0,
                wedged_after_s=5.0,
                transfer_stall_s=1.5,
                quarantine_after=99,
            ),
            poll_s=0.1,
        ).start()

    def close(self) -> None:
        self.watchdog.stop()
        self.dec.stop()
        self.uni.stop()
        self.volume_cm.__exit__(None, None, None)


def _traffic(fleet: _Fleet, *, n: int, via: str = "coord",
             abort_index: int | None = None) -> tuple[list, int, int]:
    """Submit ``n`` seeded requests and drain them all. Returns
    ``(results, shed, attempted)`` — ``attempted`` is counted
    independently of the result/shed bookkeeping, so the conservation
    invariant (attempted == finished + shed) can actually catch a request
    that vanishes between submit and drain. ``via="uni"`` targets the
    unified replica directly (mixed-class traffic); ``abort_index`` aborts
    that submission right after submit (a client disconnect)."""
    from ..scheduling.admission import ShedError

    results, shed, attempted = [], 0, 0
    for i in range(n):
        attempted += 1
        prompt = _PROMPTS[i % len(_PROMPTS)]
        try:
            if via == "uni":
                req = fleet.uni.submit(prompt, fleet.params)
            else:
                req = fleet.coord.submit(prompt, fleet.params)
        except ShedError:
            shed += 1
            continue
        aborted = abort_index == i
        if aborted:
            (fleet.coord if via == "coord" else fleet.uni).abort(req)
        result = _drain(req)
        # runner-initiated aborts legitimately truncate output (partial or
        # empty text under finish_reason="stop"): exempt from the
        # token-identity invariant, which is about UNTOUCHED requests
        result["aborted"] = aborted
        results.append(result)
    return results, shed, attempted


def _force_spill(engine, *, rewrite: bool = False, only_chain=None) -> None:
    """Evict an idle engine's whole trie (spills into the host tier) and
    demote host blocks to the shared volume store — the chaos lever that
    makes spill ownership (and the armed owner-death fault) fire
    deterministically instead of waiting for host-LRU overflow.
    ``rewrite=True`` first invalidates the blocks from the store, so the
    demotes are real writes even when earlier episodes already spilled
    the same chains (a dedup skip never reaches the fault point).
    ``only_chain`` restricts the demotes to one chain's blocks — the
    owner-death episode needs the lease to land on a chain BOTH replicas
    hold, not whatever an earlier episode left oldest in the host LRU."""
    t = engine.tiered
    engine.prefix_cache.evict(10_000)
    with t._lock:
        items = [
            (h, d) for h, d in t._host.items()
            if only_chain is None or t._chain_of.get(h) == only_chain
        ]
    if rewrite:
        for h, _ in items:
            t.store.invalidate(h)
    for h, data in items:
        t._demote_to_volume(h, data)
        with t._lock:
            t._host.pop(h, None)
            t._host_used -= len(data)


def _owner_death_spill(fleet: _Fleet):
    """The controlled middle of the ``prefix-store-owner-death`` episode
    (both replicas already warm on the shared chain, the fault armed):
    force-spill the chain's rendezvous OWNER first — the injected crash
    fires mid-put, after the spill lease is taken but before the write
    lands, and deregisters the owner from the membership — then
    force-spill the survivor, whose put takes the dead owner's lease over
    (journaled ``owner_takeover``) and lands the block. Returns the
    surviving engine plus any episode-specific violations."""
    violations: list[str] = []
    pre_s, uni_s = fleet.pre.tiered.store, fleet.uni.tiered.store
    # earlier episodes may have outlived the membership TTL: refresh both
    # heartbeats so ownership math sees two live candidates
    pre_s.heartbeat()
    uni_s.heartbeat()
    # the episode must exercise ONE chain both replicas hold (the freshly
    # warmed shared prompt), or the dead owner's lease lands on a stale
    # chain the survivor never spills and no takeover can be observed
    with fleet.uni.tiered._lock:
        uni_heads = list(dict.fromkeys(fleet.uni.tiered._chain_of.values()))
    with fleet.pre.tiered._lock:
        pre_heads = set(fleet.pre.tiered._chain_of.values())
    shared_heads = [h for h in uni_heads if h in pre_heads]
    head = (shared_heads or uni_heads or [None])[-1]
    owner = pre_s.owner_for(head) if head is not None else None
    dead, survivor = (
        (fleet.uni, fleet.pre) if owner == "uni-0" else (fleet.pre, fleet.uni)
    )
    base_takeovers = survivor.tiered.store.board.takeovers
    # armed fault: the owner dies mid-spill of the shared chain
    _force_spill(dead, rewrite=True, only_chain=head)
    # lease takeover + the write that lands
    _force_spill(survivor, only_chain=head)
    if survivor.tiered.store.board.takeovers <= base_takeovers:
        violations.append(
            "owner died mid-spill but the survivor recorded no lease "
            "takeover"
        )
    # the dead replica's ENGINE kept serving (only its store membership
    # died): rejoin so later traffic sees a full membership again
    dead.tiered.store.register_replica()
    return survivor, violations


#: the fixed episode schedule: (name, fault spec, traffic kwargs). One
#: small plan per episode keeps every injection deterministic — the nth
#: hit of a point is the nth time THIS episode's traffic reaches it —
#: and invariants are asserted after each.
EPISODES: list[tuple[str, dict, dict]] = [
    ("transport-corrupt", {"disagg.chunk_corrupt": {"on_hit": 1}},
     {"n": 2}),
    ("transport-drop", {"disagg.chunk_drop": {"on_hit": 1}}, {"n": 2}),
    ("transport-death", {"disagg.replica_death": {"on_hit": 1}}, {"n": 2}),
    ("adopt-corrupt", {"disagg.adopt_corrupt": {"on_hit": 1}}, {"n": 2}),
    ("reserve-shed", {"disagg.reserve_shed": {"on_hit": 1}}, {"n": 2}),
    # out_of_pages hit 1 lands on the unified replica's slot-claim path
    # (the traffic drains request-by-request, so the claim order is fixed):
    # the preemption-safe requeue, then normal admission on a later tick
    ("engine-pressure",
     {"engine.out_of_pages": {"on_hit": 1},
      "engine.slow_decode": {"on_hit": 3}},
     {"n": 2, "via": "uni"}),
    # a client abort mid-fleet plus a decode stall: the abort path must
    # release reservations
    ("client-abort", {"engine.slow_decode": {"on_hit": 2}},
     {"n": 3, "abort_index": 1}),
    ("router-flap", {"router.health_flap": {"on_hit": 1}}, {"n": 2}),
    ("tiered-corrupt", {"tiered.volume_corrupt": {"on_hit": 1}}, {"n": 2}),
    # scheduler crash: fires on whichever running engine's loop reaches the
    # hit first; its callers finish LOUDLY with "error", the loop survives
    ("scheduler-crash", {"engine.scheduler_crash": {"on_hit": 30}},
     {"n": 4}),
    # SILENT scheduler freeze: p=1.0 x max_fires=1 freezes
    # whichever decode-capable loop hits step() first — no exception,
    # healthy() stays true, the gray failure only progress watermarks can
    # see. Requests that land on the frozen replica queue against a dead
    # scheduler; the fleet watchdog classifies it wedged once it holds
    # outstanding work, error-stops it (streams finish loudly, zero
    # wedges), and the router's re-probe cycle revives it. Freezing BOTH
    # loops would honestly leave no healthy replica to place on — a
    # different (shed-everything) contract than the recovery this episode
    # pins down.
    ("silent-freeze",
     {"engine.scheduler_freeze": {"p": 1.0, "max_fires": 1}},
     {"n": 3}),
    # mid-transfer chunk stall without an error: the
    # sender goes quiet; the watchdog's stalled-seq-watermark abort turns
    # it into a TransportError and the coordinator's unified fallback
    # completes the request token-identically on the decode side
    ("transfer-stall", {"disagg.transfer_stall": {"on_hit": 1}}, {"n": 2}),
    # the shared prefix store's chain OWNER dies mid-spill:
    # membership drops, the write never lands
    # (atomic temp+rename: no torn block), and the survivor's next spill
    # of the chain takes the lease over — journaled owner_takeover — then
    # re-promotes the churned chain warm from the store. The post-traffic
    # leg lives in :func:`_owner_death_leg`.
    ("prefix-store-owner-death",
     {"prefix_store.owner_death": {"on_hit": 1}},
     {"n": 2}),
    # numeric drift (observability/canary.py): ONE
    # accepted decode token flipped on a canary probe — tenant-gated, so
    # the concurrent user traffic (and its token-identity invariant) is
    # untouched. The golden is recorded OUTSIDE the armed plan; the
    # corrupted round must be detected as drift, capture a canary_drift
    # incident, and down-weight the drifting replica while the other
    # serving replica's probes keep passing.
    ("canary-numeric-drift",
     {"engine.canary_token_corrupt": {"on_hit": 1}},
     {"n": 2}),
]


def _run_episode(fleet: _Fleet, name: str, spec: dict, seed: int,
                 traffic_kw: dict) -> dict:
    plan = FaultPlan(spec, seed=seed)
    extra_violations: list[str] = []
    pre_results: list = []
    pre_shed = pre_attempted = 0
    survivor = None
    base_vol_hits = 0
    prober = None
    if name == "canary-numeric-drift":
        # pre-condition (the prefix-store-owner-death hazard, below): the
        # silent-freeze episode can leave a loop frozen-but-IDLE, and the
        # canary is the first thing since to hand dec-0 work directly —
        # probing a frozen loop wedges the probe requests and drags the
        # watchdog into the episode. Play the operator: restart any
        # serving loop that stopped ticking before probing it.
        from ..serving.health import replica_snapshot

        for eng in (fleet.dec, fleet.uni):
            rep = next(
                r for r in fleet.coord.replicas if r.engine is eng
            )
            seq0 = replica_snapshot(rep).get("tick_seq")
            deadline = time.monotonic() + 1.0
            while (
                replica_snapshot(rep).get("tick_seq") == seq0
                and time.monotonic() < deadline
            ):
                time.sleep(0.02)
            if replica_snapshot(rep).get("tick_seq") == seq0:
                eng.stop()
                eng.start()
        # the clean round runs OUTSIDE the armed plan: the first serving
        # replica records the golden, the second compares against it —
        # the store must hold uncorrupted transcripts before the armed
        # round can be judged as drift rather than a fresh recording
        from ..observability.canary import CanaryProber

        prober = CanaryProber(
            fleet.coord.router, fail_threshold=1, interval_s=3600.0
        )
        prober.probe_once()
    if name == "prefix-store-owner-death":
        # pre-condition: the silent-freeze episode can leave a loop
        # frozen-but-IDLE (healthy() true, zero outstanding — the
        # watchdog ladder only fires once the engine holds work,
        # serving/health.py), and this episode direct-submits to uni-0,
        # bypassing the router probes that would otherwise revive it.
        # The harness plays the operator: restart a loop that stopped
        # ticking before building on it.
        from ..serving.health import replica_snapshot

        uni_rep = next(
            r for r in fleet.coord.replicas if r.name == "uni-0"
        )

        def _uni_tick_seq():
            return replica_snapshot(uni_rep).get("tick_seq")

        seq0 = _uni_tick_seq()
        deadline = time.monotonic() + 1.0
        while _uni_tick_seq() == seq0 and time.monotonic() < deadline:
            time.sleep(0.02)
        if _uni_tick_seq() == seq0:
            fleet.uni.stop()
            fleet.uni.start()
        # warm BOTH store members on the shared chain OUTSIDE the armed
        # plan: an organic host-overflow demote must not consume the
        # single owner-death charge before the controlled owner spill
        pre_results, pre_shed, pre_attempted = _traffic(fleet, **traffic_kw)
        more, more_shed, more_att = _traffic(fleet, n=2, via="uni")
        pre_results += more
        pre_shed += more_shed
        pre_attempted += more_att
    with active(plan):
        if name == "prefix-store-owner-death":
            survivor, extra_violations = _owner_death_spill(fleet)
            # re-drive the shared prefix at the SURVIVOR: its churned
            # fast tiers must promote the chain warm from the store
            base_vol_hits = survivor.tiered.tier_hits["volume"]
            traffic_kw = {
                "n": 2, "via": "uni" if survivor is fleet.uni else "coord"
            }
        if name == "tiered-corrupt":
            # chaos pressure: evict the prefill trie and demote the host
            # tier so the NEXT shared-prefix prompt promotes from the
            # Volume — where the corruption fires
            tiered = fleet.pre.tiered
            fleet.pre.prefix_cache.evict(10_000)
            for h, data in list(tiered._host.items()):
                # chain=None: chaos applies pressure as a driver — the
                # block must LAND for the promote-path corruption to fire,
                # so rendezvous spill ownership is deliberately bypassed
                tiered.store.put(h, data)
                with tiered._lock:
                    tiered._host.pop(h, None)
                    tiered._host_used -= len(data)
        results, shed, attempted = _traffic(fleet, **traffic_kw)
        if name == "prefix-store-owner-death":
            results = pre_results + results
            shed += pre_shed
            attempted += pre_attempted
            if survivor.tiered.tier_hits["volume"] <= base_vol_hits:
                extra_violations.append(
                    "churned chain did not re-promote from the shared "
                    "store on the surviving replica"
                )
        if name == "canary-numeric-drift":
            # armed round: the first canary token accepted fleet-wide is
            # flipped (+1 mod vocab) — the prober must see bit-exact drift
            # on that replica, down-weight it (fail_threshold=1 here; the
            # production default demands consecutive failing rounds), and
            # keep passing on the other serving replica. Probe requests
            # never enter ``results``: the token-identity invariant is
            # about user traffic, and the probe's whole job is to diverge.
            round2 = prober.probe_once()
            snap = prober.snapshot()
            if snap["drifts"] < 1:
                extra_violations.append(
                    "injected canary token corruption was never detected "
                    "as drift"
                )
            drifted = [
                rep for rep, probes in round2.items()
                if any(p["result"] == "drift" for p in probes)
            ]
            if drifted and sorted(drifted) != snap["downweighted"]:
                extra_violations.append(
                    f"drifting replica(s) {drifted} were not down-weighted "
                    f"(downweighted={snap['downweighted']})"
                )
            healthy = [rep for rep in round2 if rep not in drifted]
            for rep in healthy:
                if not all(p["result"] == "pass" for p in round2[rep]):
                    extra_violations.append(
                        f"non-drifting replica {rep} stopped passing its "
                        "canaries during the drift episode"
                    )
            # hand traffic back at full weight: the canary proved its
            # point; later invariants expect an evenly-weighted fleet
            for rep in snap["downweighted"]:
                fleet.coord.router.set_health_weight(rep, 1.0)
        if name in ("router-flap", "silent-freeze"):
            # let the down timer lapse, then place again: the re-probe
            # re-admission path (mtpu_router_readmissions_total). For the
            # freeze episode this is the ladder's last leg — the watchdog
            # error-stopped the wedged engines, and these placements
            # probe, revive, and restart them
            time.sleep(fleet.coord.router.reprobe_s + 0.3)
            more, more_shed, more_attempted = _traffic(fleet, n=2)
            results += more
            shed += more_shed
            attempted += more_attempted
    # recovery drive: the watchdog may have error-stopped a replica the
    # episode never scripted a recovery for (on a starved CI box a slow
    # tick can read as a wedge — a false positive the ladder still
    # handles). Re-probe + readmission only complete when a placement
    # actually lands on the revived replica, so play the operator for ANY
    # episode that ends with a replica down, not just router-flap /
    # silent-freeze: wait out the down timer and place fresh traffic.
    for _ in range(2):
        if not check_router_recovered(fleet.coord.router):
            break
        time.sleep(fleet.coord.router.reprobe_s + 0.3)
        more, more_shed, more_attempted = _traffic(fleet, n=2)
        results += more
        shed += more_shed
        attempted += more_attempted
    # settle: the finish marker reaches the client BEFORE the scheduler
    # frees the slot; the decode/unified loops run continuously so this
    # is bounded and short
    settle_drained(fleet.engines)

    violations = (
        check_terminal(results)
        + check_conservation(attempted, len(results), shed)
        + check_drained(fleet.engines)
        + check_router_recovered(fleet.coord.router)
        + check_token_identity(results, fleet.reference)
        + extra_violations
    )
    reasons: dict[str, int] = {}
    for r in results:
        key = r["finish_reason"] or "WEDGED"
        reasons[key] = reasons.get(key, 0) + 1
    fired = plan.fired()
    return {
        "at": time.time(),
        "episode": name,
        "seed": seed,
        "injected": fired,
        "hits": plan.hits(),
        "finished": reasons,
        "shed": shed,
        "wedged": sum(1 for r in results if r.get("wedged")),
        "recovered": sum(
            1 for r in results
            if r["finish_reason"] in ("stop", "length")
        ) if fired else 0,
        "invariants": violations or "ok",
    }


def _ping(x: int) -> int:
    """The executor episode's function: module-level, so a container
    resolves it by reference (a closure would need ``cloudpickle``)."""
    return x + 1


def _run_executor_episode(seed: int) -> dict:
    """Executor-layer chaos: a process-backend function pool, with one
    injected container death and one injected timeout — both recovered by
    the (now jittered) retry path."""
    from ..core.app import App
    from ..core.retries import Retries

    app = App("chaos-exec")
    ping = app.function(
        timeout=30,
        retries=Retries(max_retries=2, initial_delay=0.0),
    )(_ping)

    plan = FaultPlan(
        {
            "executor.container_death": {"on_hit": 1},
            "executor.timeout": {"on_hit": 2},
        },
        seed=seed,
    )
    finished = 0
    violations: list[str] = []
    # failures RECORD, never raise: run_chaos(strict=False) promises the
    # caller a structured report, not a traceback
    with active(plan):
        try:
            with app.run():
                for i in range(3):
                    got = ping.remote(i)
                    if got != i + 1:
                        violations.append(
                            f"call {i} returned {got!r}, wanted {i + 1}"
                        )
                    finished += 1
        except Exception as e:
            violations.append(
                f"executor episode raised {type(e).__name__}: {e} — the "
                "retry path did not recover the injected failures"
            )
    fired = plan.fired()
    if len(fired) < 2:
        violations.append(f"executor faults did not all fire: {fired}")
    return {
        "at": time.time(),
        "episode": "executor-retry",
        "seed": seed,
        "injected": fired,
        "hits": plan.hits(),
        "finished": {"ok": finished},
        "shed": 0,
        "wedged": 0,
        "recovered": finished if fired else 0,
        "invariants": violations or "ok",
    }


def run_chaos(
    seed: int = 0,
    *,
    device=None,
    include_executor: bool = True,
    journal_path=None,
    strict: bool = True,
    push: bool = True,
) -> dict:
    """Run the full episode schedule against a fresh fleet; return the
    aggregated report. The fleet's engines run on the card unless
    ``device="cpu"`` asks for the CPU.

    ``strict=True`` raises :class:`ChaosInvariantError` on the first
    episode whose invariants fail; ``strict=False`` records the violations
    in the report instead (the CLI path — the ``wedged``/
    ``invariants`` fields stay honest either way). Episode records append
    to ``<state_dir>/chaos.jsonl`` and the registry pushes as job
    ``chaos`` so the ``chaos`` subcommand and ``/chaos`` render the run
    afterwards.
    """
    from ..observability import incident as _incident
    from ..observability.journal import named_journal

    journal = named_journal("chaos", path=journal_path)

    def _note_violation(rec: dict) -> None:
        # a failed fleet invariant IS the incident: capture the bundle
        # before the strict raise tears the run down (strict=False records
        # it too — the report and the bundle stay paired)
        _incident.capture(
            "chaos_invariant",
            reason=f"episode {rec['episode']}: {rec['invariants']}",
        )

    fleet = _Fleet(seed, device)
    episodes: list[dict] = []
    try:
        for name, spec, traffic_kw in EPISODES:
            rec = _run_episode(fleet, name, spec, seed, traffic_kw)
            journal.record(rec)
            episodes.append(rec)
            if rec["invariants"] != "ok":
                _note_violation(rec)
                if strict:
                    raise ChaosInvariantError(
                        f"episode {name!r}: {rec['invariants']}"
                    )
    finally:
        fleet.close()
    if include_executor:
        rec = _run_executor_episode(seed)
        journal.record(rec)
        episodes.append(rec)
        if rec["invariants"] != "ok":
            _note_violation(rec)
            if strict:
                raise ChaosInvariantError(
                    f"episode executor-retry: {rec['invariants']}"
                )

    injected: dict[str, int] = {}
    for rec in episodes:
        for point, n in rec["injected"].items():
            injected[point] = injected.get(point, 0) + n
    report = {
        "seed": seed,
        "episodes": episodes,
        "injected": injected,
        "injected_total": sum(injected.values()),
        "points_fired": sorted(injected),
        "points_missed": sorted(
            ALL_FAULT_POINTS - set(injected)
            - (set() if include_executor else
               {"executor.container_death", "executor.timeout"})
        ),
        "recovered": sum(rec["recovered"] for rec in episodes),
        "wedged": sum(rec["wedged"] for rec in episodes),
        "invariants": (
            "ok"
            if all(rec["invariants"] == "ok" for rec in episodes)
            else [
                {"episode": rec["episode"], "violations": rec["invariants"]}
                for rec in episodes
                if rec["invariants"] != "ok"
            ]
        ),
    }
    if push:
        from ..observability.export import push_metrics_file

        push_metrics_file("chaos")
    return report
