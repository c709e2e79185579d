"""Progress-watermark health: gray-failure detection for the serving fleet,
a copy of ``modal_examples_tpu/serving/health.py``.

A replica that silently wedges or merely goes slow (a stuck decode tick, a
stalled mid-transfer chunk) is invisible to the binary ``healthy()`` probe,
and its streams hang until a per-request deadline fires, if one was set.
This module detects failure from **progress**, not from errors:

- :class:`EngineWatermarks`: the scheduler thread's tick counter, last
  decode-block dispatch and last accepted token, one attribute store per
  event (no locks, nothing on the hot path). In the port's pipelined loop a
  token is accepted when its block is read, not when the next one is
  dispatched.
- :class:`TransferWatermarks`: the in-flight chunked KV transfers
  (``disagg/transport.py``) by transfer id, advanced per chunk, so a
  transfer that stops between chunks without an error shows as a stale
  sequence watermark.
- :func:`classify`: a watermark snapshot to ``healthy | degraded |
  wedged``. With outstanding work, a mandatory signal stale past
  ``degraded_after_s`` is degraded and past ``wedged_after_s`` wedged; an
  idle replica is always healthy.
- :class:`ReplicaMonitor`: the per-replica state machine with hysteresis
  (downgrades at once, upgrades after ``clear_ticks`` healthy observations).
- :class:`FleetWatchdog`: the supervisor thread that walks the recovery
  ladder: (1) **degraded**: the router down-weights placement
  (``PrefixAffinityRouter.set_health_weight``); (2) **wedged transfer**:
  abort it through the transfer registry, so the coordinator takes the
  unified fallback; (3) **wedged scheduler**: ``engine.stop(reason="error")``,
  every live stream ends in "error" and ``stream_with_failover`` resumes it
  on a peer, and the router's re-probe revives the engine after
  ``reprobe_s``; (4) **repeated wedges**: quarantine for ``quarantine_s``.

Every ladder decision appends to ``<state_dir>/watchdog.jsonl`` and counts
in the watchdog series (``mtpu_watchdog_replica_state``,
``mtpu_watchdog_progress_age_seconds``, ``mtpu_watchdog_transitions_total``,
``mtpu_watchdog_recoveries_total``), which ``python -m
modal_examples_tpu_torch health`` and the gateway's ``/health`` route show.
Consumers read watermarks only through :func:`replica_snapshot`.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from ..observability import incident as _incident
from ..observability import metrics as _obs
from ..observability import reqtrace as _rt
from ..observability.journal import named_journal
from ..utils.log import get_logger

_log = get_logger("health")

#: the classifier's output states, in severity order (gauge label values)
STATES = ("healthy", "degraded", "wedged", "quarantined")

#: ladder actions recorded in ``mtpu_watchdog_recoveries_total{action}``
ACTIONS = (
    "down_weight", "restore_weight", "abort_transfer", "stop_revive",
    "quarantine", "unquarantine",
)


class EngineWatermarks:
    """Monotonic progress watermarks published by the scheduler thread.

    Writes are single attribute stores on threads that already exist — the
    scheduler notes a tick, a decode-block dispatch, an accepted token —
    so publishing costs nothing measurable. Reads go through
    :meth:`snapshot`, which converts the raw timestamps into AGES against
    the same (injectable) clock, the only form consumers see.
    """

    __slots__ = ("_clock", "tick_seq", "last_tick_at", "last_dispatch_at",
                 "last_accept_at")

    def __init__(self, clock=None):
        self._clock = clock or time.monotonic
        self.tick_seq = 0
        self.last_tick_at = self._clock()
        self.last_dispatch_at: float | None = None
        self.last_accept_at: float | None = None

    def note_start(self) -> None:
        """The scheduler (re)started: reset every watermark to fresh.
        Without this, a revived engine carries the stale ages of its
        PREVIOUS life into the window between ``start()`` and its first
        tick — and with resumed work already queued, the watchdog would
        read seconds-stale watermarks against outstanding>0 and falsely
        wedge (and poison) the engine it just finished recovering."""
        self.last_tick_at = self._clock()
        self.last_dispatch_at = None
        self.last_accept_at = None

    def note_tick(self) -> None:
        """One scheduler tick completed its top-of-loop service point."""
        self.tick_seq += 1
        self.last_tick_at = self._clock()

    def note_dispatch(self) -> None:
        """One decode block was dispatched to the device."""
        self.last_dispatch_at = self._clock()

    def note_accept(self) -> None:
        """One generated token was accepted (host-visible progress)."""
        self.last_accept_at = self._clock()

    def snapshot(self, now: float | None = None) -> dict:
        """Ages of every watermark against ``now`` (default: the same
        clock the notes used — watchdog and engine must share a clock
        domain for the ages to mean anything)."""
        now = self._clock() if now is None else now
        return {
            "tick_seq": self.tick_seq,
            "tick_age": max(0.0, now - self.last_tick_at),
            "dispatch_age": (
                max(0.0, now - self.last_dispatch_at)
                if self.last_dispatch_at is not None
                else None
            ),
            "accept_age": (
                max(0.0, now - self.last_accept_at)
                if self.last_accept_at is not None
                else None
            ),
        }


class TransferWatermarks:
    """In-flight chunked-transfer progress registry (one per process).

    ``disagg/transport.transfer`` registers each transfer, advances the
    sequence watermark per chunk sent, and checks :meth:`abort_requested`
    between chunks — so a transfer that silently stops (a stalled pipe, a
    peer that went quiet without an error) is visible as a stale watermark,
    and the watchdog can break it into the coordinator's unified fallback
    instead of letting the request hang to its deadline.
    """

    def __init__(self, clock=None):
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        #: transfer id -> {seq, at, abort}
        self._active: dict[str, dict] = {}

    def begin(self, transfer_id: str) -> None:
        with self._lock:
            self._active[transfer_id] = {
                "seq": -1, "at": self._clock(), "abort": False,
            }

    def progress(self, transfer_id: str, seq: int) -> None:
        with self._lock:
            entry = self._active.get(transfer_id)
            if entry is not None:
                entry["seq"] = int(seq)
                entry["at"] = self._clock()

    def end(self, transfer_id: str) -> None:
        with self._lock:
            self._active.pop(transfer_id, None)

    def request_abort(self, transfer_id: str) -> bool:
        """Ask the sending loop to abort (idempotent). Returns True when
        this call newly armed the abort — the watchdog journals once."""
        with self._lock:
            entry = self._active.get(transfer_id)
            if entry is None or entry["abort"]:
                return False
            entry["abort"] = True
            return True

    def abort_requested(self, transfer_id: str) -> bool:
        with self._lock:
            entry = self._active.get(transfer_id)
            return bool(entry and entry["abort"])

    def stalled(self, older_than_s: float, now: float | None = None) -> list:
        """Transfer ids with no chunk progress for ``older_than_s`` and no
        abort armed yet — the watchdog's wedged-transfer candidates."""
        now = self._clock() if now is None else now
        with self._lock:
            return [
                tid
                for tid, e in self._active.items()
                if not e["abort"] and now - e["at"] >= older_than_s
            ]

    def snapshot(self, now: float | None = None) -> list:
        now = self._clock() if now is None else now
        with self._lock:
            return [
                {
                    "transfer_id": tid,
                    "seq": e["seq"],
                    "age_s": round(max(0.0, now - e["at"]), 6),
                    "abort": e["abort"],
                }
                for tid, e in self._active.items()
            ]


#: THE process-wide transfer registry: the transport layer writes it, the
#: watchdog reads it (tests build private instances with fake clocks)
transfers = TransferWatermarks()


@dataclasses.dataclass
class WatchdogPolicy:
    """Classification thresholds + ladder tuning (docs/health.md)."""

    #: stale mandatory progress signal past this -> degraded
    degraded_after_s: float = 2.0
    #: stale mandatory progress signal past this -> wedged
    wedged_after_s: float = 10.0
    #: a queued request older than this (while the engine ticks) -> degraded
    queue_age_degraded_s: float = 10.0
    #: chunked transfer with no sequence progress past this -> abort it
    transfer_stall_s: float = 5.0
    #: consecutive healthy observations before an upgrade (flap damping)
    clear_ticks: int = 2
    #: wedge episodes within ``wedge_window_s`` before quarantine
    quarantine_after: int = 2
    wedge_window_s: float = 120.0
    #: how long a quarantined replica is held out of placement
    quarantine_s: float = 30.0
    #: router placement weight while degraded (1.0 = normal)
    degraded_weight: float = 0.25

    def __post_init__(self):
        if not (0.0 < self.degraded_after_s <= self.wedged_after_s):
            raise ValueError(
                "need 0 < degraded_after_s <= wedged_after_s, got "
                f"{self.degraded_after_s} / {self.wedged_after_s}"
            )
        if not (0.0 < self.degraded_weight <= 1.0):
            raise ValueError(
                f"degraded_weight must be in (0, 1], got {self.degraded_weight}"
            )


def replica_snapshot(replica, now: float | None = None) -> dict:
    """One replica's progress snapshot — THE read surface for watermarks.

    Consumers (watchdog, ``EngineReplica.stats``, CLI/gateway renderers)
    come through here rather than poking engine timestamps directly, so
    the watermark model stays swappable (guarded in tests/test_static.py).
    Slot rows read the per-request last-accepted-token time — the request
    object already records it for TPOT telemetry.
    """
    eng = replica.engine
    wm = getattr(eng, "watermarks", None)
    snap = wm.snapshot(now) if wm is not None else {}
    snap["running"] = bool(getattr(eng, "_running", False))
    snap["outstanding"] = int(replica.outstanding())
    decodable = 0
    slots = []
    clock = getattr(eng, "_clock", time.monotonic)
    t = clock() if now is None else now
    for i, s in enumerate(getattr(eng, "slots", ())):
        req = s.request
        if req is None:
            continue
        if s.decodable:
            decodable += 1
        slots.append({
            "slot": i,
            "request_id": req.request_id,
            "accept_age": (
                round(max(0.0, t - req.last_token_at), 6)
                if req.last_token_at is not None
                else None
            ),
            "generated": len(req.generated_tokens),
        })
    snap["decodable"] = decodable
    snap["slots"] = slots
    oldest = None
    policy = getattr(eng, "policy", None)
    if policy is not None:
        oldest = policy.oldest_enqueued_at()
    snap["queue_head_age"] = (
        max(0.0, t - oldest) if oldest is not None else None
    )
    return snap


def progress_age(snap: dict) -> float | None:
    """The WORST stale age among the snapshot's mandatory progress signals
    (what ``mtpu_watchdog_progress_age_seconds`` reports), or None while
    idle — staleness only means anything against outstanding work."""
    if snap.get("outstanding", 0) <= 0:
        return None
    ages = [snap.get("tick_age", 0.0)]
    if snap.get("decodable", 0) > 0:
        for key in ("dispatch_age", "accept_age"):
            if snap.get(key) is not None:
                ages.append(snap[key])
    return max(ages)


def classify(snap: dict, policy: WatchdogPolicy) -> str:
    """Pure classification of one snapshot: ``healthy | degraded |
    wedged``. Idle replicas are healthy by definition; with outstanding
    work, the mandatory signals are the scheduler tick always, plus
    dispatch and accept while decodable slots exist. A queued head older
    than ``queue_age_degraded_s`` while the engine still ticks is degraded
    only — it may be a legitimate pages-full wait, which the wedge of the
    replica HOLDING the pages will surface instead."""
    age = progress_age(snap)
    if age is None:
        return "healthy"
    if age >= policy.wedged_after_s:
        return "wedged"
    if age >= policy.degraded_after_s:
        return "degraded"
    qh = snap.get("queue_head_age")
    if qh is not None and qh >= policy.queue_age_degraded_s:
        return "degraded"
    return "healthy"


class ReplicaMonitor:
    """Per-replica classification state machine with hysteresis.

    Downgrades apply immediately — detection speed is the point — while
    upgrades require ``clear_ticks`` consecutive healthy raw observations,
    so a replica oscillating around a threshold holds its degraded state
    instead of flapping the router's placement weight every poll.
    """

    def __init__(self, name: str, policy: WatchdogPolicy):
        self.name = name
        self.policy = policy
        self.state = "healthy"
        self._healthy_streak = 0
        #: monotonic times of wedge transitions (quarantine trigger window)
        self.wedge_times: list[float] = []
        #: the watchdog saw this replica's engine stopped (our own stop, a
        #: fleet reap, an operator): the next running observation resets
        #: the state machine — a revived engine is a FRESH engine, and a
        #: re-wedge must be a new transition that fires the ladder again,
        #: not a continuation of the old wedge that nothing acts on
        self.saw_stopped = False

    def reset(self) -> None:
        """Back to healthy with no streak; the quarantine window's wedge
        history is deliberately KEPT — repeated wedges across revivals are
        exactly what quarantine exists to catch."""
        self.state = "healthy"
        self._healthy_streak = 0
        self.saw_stopped = False

    def observe(self, raw: str, now: float) -> tuple[str, bool]:
        """Fold one raw classification in; returns ``(state, changed)``."""
        prev = self.state
        if raw == "healthy":
            self._healthy_streak += 1
            if (
                self.state != "healthy"
                and self._healthy_streak >= self.policy.clear_ticks
            ):
                self.state = "healthy"
        else:
            self._healthy_streak = 0
            order = {"healthy": 0, "degraded": 1, "wedged": 2}
            # downgrades are immediate; a degraded observation while wedged
            # does not soften the state (only the healthy streak upgrades)
            if order[raw] > order.get(self.state, 0):
                self.state = raw
        if self.state == "wedged" and prev != "wedged":
            self.wedge_times.append(now)
            lo = now - self.policy.wedge_window_s
            self.wedge_times = [t for t in self.wedge_times if t >= lo]
        return self.state, self.state != prev

    def wedges_in_window(self, now: float) -> int:
        lo = now - self.policy.wedge_window_s
        return sum(1 for t in self.wedge_times if t >= lo)


class FleetWatchdog:
    """The fleet-level supervisor: poll replica watermarks, classify, and
    walk the escalating recovery ladder (module docstring; docs/health.md).

    ``router`` is duck-typed (``replicas`` / ``set_health_weight``);
    ``clock`` must share a domain with the engines' injectable clocks for
    the ages to be meaningful (production: ``time.monotonic`` everywhere).
    ``poll_once`` is the whole control loop — tests drive it directly with
    a fake clock; :meth:`start` runs it on a daemon thread.
    """

    def __init__(
        self,
        router,
        *,
        policy: WatchdogPolicy | None = None,
        poll_s: float = 0.5,
        clock=None,
        journal_path=None,
        transfer_watermarks: TransferWatermarks | None = None,
        registry=None,
    ):
        self.router = router
        self.policy = policy or WatchdogPolicy()
        self.poll_s = float(poll_s)
        self._clock = clock or time.monotonic
        self.journal = named_journal("watchdog", path=journal_path)
        self._transfers = (
            transfer_watermarks if transfer_watermarks is not None else transfers
        )
        self._registry = registry
        self._monitors: dict[str, ReplicaMonitor] = {}
        #: replica name -> quarantine expiry (this watchdog's clock)
        self._quarantined_until: dict[str, float] = {}
        self.events: list[dict] = []  # every ladder decision, newest last
        self._lock = threading.Lock()
        self._running = False
        self._thread: threading.Thread | None = None

    # -- journal/metrics plumbing -------------------------------------------

    def _record(self, rec: dict) -> None:
        rec = {"at": time.time(), **rec}
        self.journal.record(rec)
        with self._lock:
            self.events.append(rec)
            del self.events[:-512]

    def _publish_state(self, name: str, state: str) -> None:
        for s in STATES:
            _obs.set_watchdog_state(
                name, s, s == state, registry=self._registry
            )

    # -- the control loop ----------------------------------------------------

    def poll_once(self) -> list[dict]:
        """One watchdog pass over transfers + replicas; returns the ladder
        actions taken (also journaled and appended to :attr:`events`)."""
        now = self._clock()
        actions: list[dict] = []
        actions += self._poll_transfers(now)
        live: set[str] = set()
        for replica in list(self.router.replicas):
            live.add(replica.name)
            if not getattr(replica, "serves_requests", True):
                # prefill-role replicas run no scheduler loop: their gray
                # failures surface as stalled transfers, handled above
                continue
            actions += self._poll_replica(replica, now)
        self._forget_removed(live)
        return actions

    def _forget_removed(self, live: set[str]) -> None:
        """Drop the monitor, quarantine entry, and gauge cells of every
        replica the fleet removed (scale-down, forced reap). Without this,
        ``tpurun health`` / ``/health`` / ``stats()`` report the ghost at
        its last state forever, and a replica removed mid-quarantine leaks
        its ``_quarantined_until`` entry."""
        with self._lock:
            stale = [n for n in self._monitors if n not in live]
            for name in stale:
                del self._monitors[name]
        for name in stale:
            self._quarantined_until.pop(name, None)
            # zero every cell (no Registry remove API): the surfaces keep
            # only replicas whose one-hot state reads >= 1
            for s in STATES:
                _obs.set_watchdog_state(name, s, False, registry=self._registry)
            _obs.set_watchdog_progress_age(name, 0.0, registry=self._registry)

    def _poll_transfers(self, now: float) -> list[dict]:
        out = []
        for tid in self._transfers.stalled(self.policy.transfer_stall_s, now):
            if not self._transfers.request_abort(tid):
                continue
            _obs.record_watchdog_recovery(
                "abort_transfer", registry=self._registry
            )
            rec = {
                "action": "abort_transfer",
                "transfer_id": tid,
                "stall_s": round(self.policy.transfer_stall_s, 3),
            }
            self._record(rec)
            _log.warning(
                "watchdog: aborting stalled transfer %s (no chunk progress "
                "for %.1fs); coordinator takes the unified fallback",
                tid, self.policy.transfer_stall_s,
            )
            out.append(rec)
        return out

    def _poll_replica(self, replica, now: float) -> list[dict]:
        name = replica.name
        out: list[dict] = []
        until = self._quarantined_until.get(name)
        if until is not None:
            if now >= until:
                self._quarantined_until.pop(name, None)
                replica.quarantined = False
                _obs.record_watchdog_recovery(
                    "unquarantine", registry=self._registry
                )
                rec = {"action": "unquarantine", "replica": name}
                self._record(rec)
                out.append(rec)
                # state stays wedged until real healthy observations clear
                # it through the normal streak — no shortcut
            else:
                self._publish_state(name, "quarantined")
                return out
        with self._lock:
            mon = self._monitors.get(name)
            if mon is None:
                mon = self._monitors[name] = ReplicaMonitor(
                    name, self.policy
                )
        if not getattr(replica.engine, "_running", False):
            # stopped engine (by us, by the fleet, or never started): the
            # router's health/probe cycle owns it — observing a stopped
            # scheduler as "wedged" would double-fire the ladder
            mon.saw_stopped = True
            self._publish_state(name, mon.state)
            return out
        if mon.saw_stopped:
            # the engine was stopped and is running again (probe revival):
            # reset the state machine so a RE-wedge of the fresh engine is
            # a new transition that fires the ladder — a monitor stuck
            # "wedged" across the revival would mask it (changed=False)
            # and hang the revived replica's streams forever
            was_degraded = mon.state == "degraded"
            mon.reset()
            if was_degraded:
                # the degraded rung's down-weight would otherwise outlive
                # the restart: reset() forces state healthy, so the next
                # healthy observation is changed=False and _act_recovered
                # never fires — the revived replica would compete at
                # degraded_weight forever
                out += self._act_recovered(replica)
        snap = replica_snapshot(replica, now)
        raw = classify(snap, self.policy)
        age = progress_age(snap)
        _obs.set_watchdog_progress_age(
            name, 0.0 if age is None else age, registry=self._registry
        )
        state, changed = mon.observe(raw, now)
        replica.health_state = state
        self._publish_state(name, state)
        if not changed:
            return out
        _obs.record_watchdog_transition(state, registry=self._registry)
        rec = {
            "action": "transition",
            "replica": name,
            "state": state,
            "raw": raw,
            "progress_age_s": round(age, 6) if age is not None else None,
            "tick_seq": snap.get("tick_seq"),
            "outstanding": snap.get("outstanding"),
            "decodable": snap.get("decodable"),
        }
        self._record(rec)
        out.append(rec)
        if state == "degraded":
            out += self._act_degraded(replica)
        elif state == "wedged":
            out += self._act_wedged(replica, mon, now, snap)
        elif state == "healthy":
            out += self._act_recovered(replica)
        return out

    # -- the ladder ----------------------------------------------------------

    def _set_weight(self, name: str, weight: float) -> bool:
        setter = getattr(self.router, "set_health_weight", None)
        if setter is None:
            return False
        setter(name, weight)
        return True

    def _act_degraded(self, replica) -> list[dict]:
        if not self._set_weight(replica.name, self.policy.degraded_weight):
            return []
        _obs.record_watchdog_recovery("down_weight", registry=self._registry)
        rec = {
            "action": "down_weight",
            "replica": replica.name,
            "weight": self.policy.degraded_weight,
        }
        self._record(rec)
        return [rec]

    def _act_recovered(self, replica) -> list[dict]:
        if not self._set_weight(replica.name, 1.0):
            return []
        _obs.record_watchdog_recovery(
            "restore_weight", registry=self._registry
        )
        rec = {"action": "restore_weight", "replica": replica.name}
        self._record(rec)
        return [rec]

    def _act_wedged(self, replica, mon, now: float, snap: dict) -> list[dict]:
        out: list[dict] = []
        # placement weight is moot once the ladder stops the engine; the
        # router's down/probe cycle takes over from here
        self._set_weight(replica.name, 1.0)
        quarantine = (
            mon.wedges_in_window(now) >= self.policy.quarantine_after
        )
        if quarantine:
            replica.quarantined = True
            self._quarantined_until[replica.name] = (
                now + self.policy.quarantine_s
            )
            self._publish_state(replica.name, "quarantined")
        action = "quarantine" if quarantine else "stop_revive"
        # mark live traced requests BEFORE the stop sweeps their spans:
        # the stitched timeline then shows the watchdog's intervention
        # between the hang and the failover seam
        eng = replica.engine
        for s in list(getattr(eng, "slots", ())):
            req = s.request
            if req is not None and req.trace is not None:
                _rt.event(
                    req.trace, "watchdog",
                    store=getattr(eng, "_trace_store", None),
                    replica=replica.name, state="wedged", action=action,
                )
        _log.warning(
            "watchdog: replica %s wedged (progress age %.2fs, tick_seq %s); "
            "%s — live streams take the reactive failover",
            replica.name, progress_age(snap) or -1.0,
            snap.get("tick_seq"), action,
        )
        # incident bundle BEFORE the error-stop sweeps the victim's slots:
        # the bundle's open-request traces (and the watchdog events just
        # marked on them) are the evidence of what was mid-flight when the
        # chip wedged (docs/observability.md#incident-bundles)
        _incident.capture(
            "watchdog_quarantine" if quarantine else "watchdog_wedge",
            reason=(
                f"progress age {progress_age(snap) or -1.0:.2f}s, "
                f"tick_seq {snap.get('tick_seq')}, "
                f"wedges_in_window {mon.wedges_in_window(now)}"
            ),
            replica=replica.name,
            registry=self._registry,
        )
        try:
            # error-stop: every live stream gets a terminal error (the
            # PR-12 reactive failover resumes it on a healthy peer) and
            # the engine is poisoned until the router's re-probe revives
            # and restarts it — or until quarantine lifts
            eng.stop(reason="error")
        except Exception:
            _log.exception(
                "watchdog: stop of wedged replica %s failed", replica.name
            )
        _obs.record_watchdog_recovery(action, registry=self._registry)
        rec = {
            "action": action,
            "replica": replica.name,
            "wedges_in_window": mon.wedges_in_window(now),
            **(
                {"quarantine_s": round(self.policy.quarantine_s, 3)}
                if quarantine
                else {}
            ),
        }
        self._record(rec)
        out.append(rec)
        return out

    # -- lifecycle / surfaces ------------------------------------------------

    def start(self) -> "FleetWatchdog":
        if self._running:
            return self
        self._running = True

        def loop():
            while self._running:
                try:
                    self.poll_once()
                except Exception:
                    _log.exception("watchdog poll failed")
                time.sleep(self.poll_s)

        self._thread = threading.Thread(
            target=loop, name="fleet-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def stats(self) -> dict:
        """Live snapshot (the half of ``/health`` that cannot be rebuilt
        from pushed metrics when the watchdog runs in-process)."""
        now = self._clock()
        with self._lock:
            events = list(self.events[-50:])
            monitors = dict(self._monitors)
        return {
            "replicas": {
                name: {
                    "state": mon.state,
                    "wedges_in_window": mon.wedges_in_window(now),
                    "quarantined_until": self._quarantined_until.get(name),
                }
                for name, mon in monitors.items()
            },
            "transfers": self._transfers.snapshot(now),
            "events": events,
        }


def decode_watchdog_series(registry) -> dict:
    """Decode the watchdog metric series back into plain dicts — the ONE
    decoder shared by every surface (``tpurun health``/``top``, the
    gateway ``/health`` view), so the series shape (one-hot state labels,
    per-replica age) can evolve without the renderers drifting apart.

    ``registry`` duck-types ``.series(name)``: the live default registry
    in-process, or a merged parsed exposition for pushed metrics. Returns
    ``{"states", "ages", "transitions", "recoveries"}``; ``states`` keeps
    only replicas whose one-hot cell reads active (zeroed ghosts drop out).
    """
    from ..observability import catalog as C

    return {
        "states": {
            lbls.get("replica", "?"): lbls.get("state", "?")
            for lbls, v in registry.series(C.WATCHDOG_REPLICA_STATE)
            if v >= 1
        },
        "ages": {
            lbls.get("replica", "?"): v
            for lbls, v in registry.series(C.WATCHDOG_PROGRESS_AGE_SECONDS)
        },
        "transitions": {
            lbls.get("state", "?"): v
            for lbls, v in registry.series(C.WATCHDOG_TRANSITIONS_TOTAL)
        },
        "recoveries": {
            lbls.get("action", "?"): v
            for lbls, v in registry.series(C.WATCHDOG_RECOVERIES_TOTAL)
        },
    }
