"""Copy of ``modal_examples_tpu/faults/inject.py``: named fault points,
seeded plans, and a zero-cost activation gate.

The port keeps the executor's two points (``executor.container_death``,
``executor.timeout``, hit in ``core/executor.py``), the engine's (the
canary's token corrupt, the scheduler crash and freeze, page exhaustion, a
slow decode tick; ``serving/engine.py``), the disaggregation wire's
(``serving/disagg/``) and the router's health flap
(``scheduling/router.py``), the tiered prefix cache's volume corruption
(``serving/disagg/tiered_cache.py``) and the shared prefix store's owner
death (``serving/prefix_store/store.py``): every point of the JAX package's
catalog. The seeded chaos runner (``faults/chaos.py``) fires each of them
end to end. A fired fault leaves a ``fault``
event on the request trace of the thread's ambient frame
(``reqtrace.note_fault``).

- :data:`POINTS` is the one catalog of named fault points.
- :class:`FaultPlan` decides, deterministically, WHICH hits of a point
  fail: ``{"on_hit": n}`` fires exactly on the nth time execution reaches
  the point (or each n in a list), ``{"p": x}`` flips a per-point
  seeded coin per hit (optionally capped with ``max_fires``). Two runs with
  the same seed and the same hit sequence make identical decisions.
- The gate is **zero-cost when disabled**: with no active plan,
  :func:`fire` is one global read and a ``return False``.

Activation is explicit (:func:`activate` / :func:`deactivate` / the
:func:`active` context manager) or environment-driven for child processes:
``MTPU_FAULT_PLAN`` (JSON spec) + ``MTPU_FAULT_SEED``. Every fired fault
counts in ``mtpu_faults_injected_total{point}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading

from ..utils.determinism import unit_float as _hash_unit_float

#: the one catalog of fault points. name -> {component, effect, recovery}.
#: Names are ``<component>.<failure>``.
POINTS: dict[str, dict] = {
    "executor.container_death": {
        "component": "core/executor.py",
        "effect": "the dispatched container dies while processing",
        "recovery": "retry with jittered backoff (mtpu_retries_total)",
    },
    "executor.timeout": {
        "component": "core/executor.py",
        "effect": "the dispatched input exceeds its timeout",
        "recovery": "retry with jittered backoff (mtpu_retries_total)",
    },
    "engine.canary_token_corrupt": {
        "component": "serving/engine.py",
        "effect": "one accepted decode token is deterministically flipped "
                  "(+1 mod vocab) — ONLY on __canary__ probe requests, so "
                  "user-visible streams are never corrupted",
        "recovery": "the canary prober detects bit-exact drift against the "
                    "golden store -> a canary_drift incident bundle and the "
                    "failing streak (mtpu_canary_failing)",
    },
    "disagg.chunk_corrupt": {
        "component": "serving/disagg/transport.py",
        "effect": "one wire chunk's payload is flipped (stale crc)",
        "recovery": "crc mismatch -> resumable retry re-sends that chunk",
    },
    "disagg.chunk_drop": {
        "component": "serving/disagg/transport.py",
        "effect": "one wire chunk silently vanishes",
        "recovery": "gap detected -> next round re-sends the missing seq",
    },
    "disagg.replica_death": {
        "component": "serving/disagg/transport.py",
        "effect": "ConnectionError mid-transfer (peer died)",
        "recovery": "coordinator unified fallback: re-prefill on decode",
    },
    "disagg.transfer_stall": {
        "component": "serving/disagg/transport.py",
        "effect": "the sender goes quiet between chunks — no error, the "
                  "peer just never sees the next seq",
        "recovery": "watchdog aborts the stalled transfer (stale seq "
                    "watermark) -> TransportError -> unified fallback",
    },
    "disagg.adopt_corrupt": {
        "component": "serving/disagg/roles.py",
        "effect": "the reassembled block corrupts before adoption",
        "recovery": "loud TransportError -> unified fallback",
    },
    "disagg.reserve_shed": {
        "component": "serving/disagg/roles.py",
        "effect": "decode-side admission sheds the migration reservation",
        "recovery": "honest 429 before any byte moves (ShedError)",
    },
    "router.health_flap": {
        "component": "scheduling/router.py",
        "effect": "a replica's health probe reports unhealthy once",
        "recovery": "evicted from candidates, re-probed, re-admitted",
    },
    "engine.scheduler_crash": {
        "component": "serving/engine.py",
        "effect": "the scheduler thread's step() raises",
        "recovery": "inflight/queued requests fail LOUDLY with "
                    "finish_reason='error'; the loop survives",
    },
    "engine.scheduler_freeze": {
        "component": "serving/engine.py",
        "effect": "the scheduler thread silently stops making progress "
                  "(no exception, healthy() stays true) until stop()",
        "recovery": "watchdog classifies wedged from stale watermarks -> "
                    "stop(reason='error') -> streams failover (health.py)",
    },
    "engine.out_of_pages": {
        "component": "serving/engine.py",
        "effect": "a page claim reports allocator exhaustion",
        "recovery": "preemption-safe requeue; admitted on a later tick",
    },
    "engine.slow_decode": {
        "component": "serving/engine.py",
        "effect": "one decode tick stalls (~50 ms)",
        "recovery": "latency only; requests still terminate",
    },
    "tiered.volume_corrupt": {
        "component": "serving/disagg/tiered_cache.py",
        "effect": "bytes read from the Volume tier are corrupted",
        "recovery": "corrupt block dropped; prefix KV recomputed",
    },
    "prefix_store.owner_death": {
        "component": "serving/prefix_store/store.py",
        "effect": "the chain's owner replica dies mid-spill: it drops out "
                  "of the store membership and the write never lands",
        "recovery": "atomic temp+rename leaves no torn block; rendezvous "
                    "remaps the chain and the survivor's next spill takes "
                    "the lease over (journaled owner_takeover)",
    },
}

#: every declared fault-point name
ALL_FAULT_POINTS = frozenset(POINTS)


class FaultError(RuntimeError):
    """An injected failure (never raised by real fault paths — catching it
    is how handlers distinguish chaos from genuine scheduler-logic bugs)."""


def _unit_float(seed: int, point: str, hit: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, point, hit) — stable
    across processes and python hash randomization (the same hashing
    scheme retry jitter uses: utils.determinism)."""
    return _hash_unit_float(seed, point, hit)


class FaultPlan:
    """A seeded, deterministic decision table over :data:`POINTS`.

    ``spec`` maps point name -> one of:

    - ``{"on_hit": n}`` — fire exactly when the point is reached the nth
      time (1-based); ``n`` may be a list of hit numbers.
    - ``{"p": x}`` — fire each hit with probability ``x``, decided by a
      per-(seed, point, hit) hash — deterministic, order-independent
      across points. Optional ``"max_fires": k`` caps total fires.

    Unknown point names are rejected up front (the plan is checked against
    the catalog, like metric names are). Hits are counted for EVERY
    declared point the plan is active over — ``hits()`` is the
    reachability record even for points the plan never fires.
    """

    def __init__(self, spec: dict, *, seed: int = 0):
        unknown = set(spec) - ALL_FAULT_POINTS
        if unknown:
            raise ValueError(
                f"unknown fault points {sorted(unknown)}; declared points: "
                f"{sorted(ALL_FAULT_POINTS)}"
            )
        self.seed = int(seed)
        self._spec: dict[str, dict] = {}
        for point, cfg in spec.items():
            cfg = dict(cfg)
            if "on_hit" in cfg:
                n = cfg["on_hit"]
                cfg["on_hit"] = frozenset(
                    int(x) for x in (n if isinstance(n, (list, tuple)) else [n])
                )
            elif "p" not in cfg:
                raise ValueError(
                    f"fault spec for {point!r} needs 'on_hit' or 'p': {cfg}"
                )
            self._spec[point] = cfg
        self._lock = threading.Lock()
        self._hits: dict[str, int] = {}
        self._fired: dict[str, int] = {}

    def should_fire(self, point: str) -> bool:
        """Count one hit of ``point`` and decide whether it fails."""
        with self._lock:
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            cfg = self._spec.get(point)
            if cfg is None:
                return False
            on_hit = cfg.get("on_hit")
            if on_hit is not None:
                fire = hit in on_hit
            else:
                fired = self._fired.get(point, 0)
                if fired >= cfg.get("max_fires", float("inf")):
                    return False
                fire = _unit_float(self.seed, point, hit) < cfg["p"]
            if fire:
                self._fired[point] = self._fired.get(point, 0) + 1
            return fire

    def hits(self) -> dict[str, int]:
        """Times each point was REACHED while this plan was active."""
        with self._lock:
            return dict(self._hits)

    def fired(self) -> dict[str, int]:
        """Times each point actually FIRED."""
        with self._lock:
            return dict(self._fired)


#: the active plan. A plain module global (not a contextvar): fault points
#: are hit from the engine's scheduler thread, server threads, and executor
#: workers — none of which inherit the activator's context.
_active_plan: FaultPlan | None = None


def activate(plan: FaultPlan) -> FaultPlan:
    """Arm ``plan`` process-wide. Returns it (chaining convenience)."""
    global _active_plan
    _active_plan = plan
    return plan


def deactivate() -> None:
    global _active_plan
    _active_plan = None


def active_plan() -> FaultPlan | None:
    return _active_plan


@contextlib.contextmanager
def active(plan: FaultPlan):
    """``with active(FaultPlan({...}, seed=7)) as plan:`` — scoped arming;
    always disarms, even when the driven code raises."""
    activate(plan)
    try:
        yield plan
    finally:
        deactivate()


def fire(point: str) -> bool:
    """True when the active plan says this hit of ``point`` should fail.

    THE gate: with no plan active this is one global read + return — the
    zero-cost-when-disabled contract.
    """
    if _active_plan is None:
        return False
    # snapshot: deactivate() may race from another thread between the
    # None-check above and the call below (the engine's scheduler threads
    # keep ticking while the chaos runner disarms plans) — a torn read
    # must mean "disarmed", never an AttributeError inside a scheduler loop
    plan = _active_plan
    if plan is not None and plan.should_fire(point):
        from ..observability import metrics as _obs
        from ..observability import reqtrace as _reqtrace

        _obs.record_fault_injected(point)
        # a fired fault becomes a span event on the request whose operation
        # this thread is running (no-op without an ambient frame)
        _reqtrace.note_fault(point)
        return True
    return False


def check(point: str, exc: type = FaultError, message: str | None = None) -> None:
    """Raise ``exc`` when this hit of ``point`` fires (one-line call sites
    for raise-style faults)."""
    if fire(point):
        raise exc(message or f"injected fault: {point}")


def corrupt(point: str, data: bytes) -> bytes:
    """Return ``data`` with its last byte flipped when ``point`` fires
    (one-line call sites for corruption-style faults); unchanged otherwise.
    Empty payloads pass through — there is nothing to corrupt."""
    if data and fire(point):
        return data[:-1] + bytes([data[-1] ^ 0xFF])
    return data


def _activate_from_env() -> None:
    """Child-process activation: ``MTPU_FAULT_PLAN`` (JSON spec) +
    ``MTPU_FAULT_SEED``. A malformed plan is a loud error — a chaos run
    that silently injected nothing would 'pass' every invariant."""
    raw = os.environ.get("MTPU_FAULT_PLAN", "")
    if not raw:
        return
    seed = int(os.environ.get("MTPU_FAULT_SEED", "0") or 0)
    activate(FaultPlan(json.loads(raw), seed=seed))


_activate_from_env()
