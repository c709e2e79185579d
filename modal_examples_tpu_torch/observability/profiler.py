"""Hot-path time attribution for the serving engine: per-tick host/device
phase accounting. A copy of ``modal_examples_tpu/observability/profiler.py``
without its compile telemetry (the port compiles no program at dispatch: its
kernels build once, at first use). The process-wide registry of profilers
(:func:`active_profilers`) is the gateway's ``/profile`` source.

**Tick anatomy** — the scheduler thread accounts each ``step()`` into named
phases (:data:`~.catalog.TICK_PHASES`) via monotonic deltas on the engine's
injectable clock: :meth:`HotPathProfiler.begin_tick` hands the tick a
:class:`TickProfile`, the engine's ``_tm(tick, "phase")`` helper closes
intervals into phases, and :meth:`~HotPathProfiler.end_tick` aggregates
busy ticks into a ring buffer plus the ``mtpu_tick_phase_seconds{phase}``
histograms. Blocking device reads mark with ``device=True``, so the ring
carries a host-vs-device split and the ``mtpu_host_overhead_ratio`` gauge
falls out: 1 - device-blocked over total.
:meth:`~HotPathProfiler.overhead_summary` and
:meth:`~HotPathProfiler.perfetto_snapshot` read it.

**Zero-cost when disabled**: ``LLMEngine.__init__`` resolves
``MTPU_PROFILE`` ONCE (explicit arg beats env beats off) and keeps
``self.profiler = None`` when off — every hot-path touch point is then a
``tick is None`` branch with no timestamp, no allocation, no dict write.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque

from ..utils.stats import percentile_nearest_rank as _pct
from . import catalog as C
from . import metrics as _obs

#: the one env switch (resolved once in ``LLMEngine.__init__``, the
#: MTPU_KV_DTYPE rule): unset/0 = off — bench configs opt in explicitly
PROFILE_ENV = "MTPU_PROFILE"

#: busy ticks retained in the in-memory ring (per profiler)
RING_TICKS = 512
#: refresh the host-overhead gauge every N busy ticks (a gauge write per
#: tick would be pure lock traffic for a value that moves slowly)
_GAUGE_EVERY = 32

def profiling_enabled(explicit=None) -> bool:
    """Resolve the profile switch ONCE: explicit arg beats
    :data:`PROFILE_ENV` beats off (the MTPU_KV_DTYPE rule — the env is
    never re-read on the hot path)."""
    import os

    if explicit is not None:
        return bool(explicit)
    return os.environ.get(PROFILE_ENV, "") not in ("", "0")


class TickProfile:
    """One scheduler tick's phase accumulator.

    Interval semantics: :meth:`mark` closes the time since the PREVIOUS
    mark (or the tick's start) into the named phase — the scheduler runs
    one thread, so sequential marks partition the tick exactly and the
    per-phase sums can never exceed the tick total. ``device=True``
    additionally counts the interval as device-blocked time (the host
    waiting on a device array), feeding the host-vs-device split.
    """

    __slots__ = ("_clock", "t0", "_last", "phases", "device_s")

    def __init__(self, clock):
        self._clock = clock
        self.t0 = self._last = clock()
        self.phases: dict[str, float] = {}
        self.device_s = 0.0

    def mark(self, phase: str, device: bool = False) -> None:
        now = self._clock()
        dt = now - self._last
        self._last = now
        if dt > 0:
            self.phases[phase] = self.phases.get(phase, 0.0) + dt
            if device:
                self.device_s += dt


class HotPathProfiler:
    """Per-engine hot-path profiler: the tick ring.

    ``clock`` is the engine's injectable monotonic clock (fake-clock tests
    see real phase deltas); ``name`` is the replica name, or a zero-arg
    callable resolving it lazily (the engine's ``trace_name`` is assigned
    by the fleet AFTER construction). All methods are safe from the
    scheduler thread plus concurrent ``prefill_sync`` server threads.
    """

    def __init__(
        self,
        *,
        clock=None,
        name="engine",
        registry=None,
        ring: int = RING_TICKS,
    ):
        self._clock = clock or time.monotonic
        self._name = name
        self._registry = registry
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=ring)
        self._busy_ticks = 0
        self._dispatches = 0
        self._dispatch_tokens = 0
        self._decode_steps = 1
        register(self)

    @property
    def replica(self) -> str:
        return str(self._name() if callable(self._name) else self._name)

    # -- tick anatomy --------------------------------------------------------

    def begin_tick(self) -> TickProfile:
        return TickProfile(self._clock)

    def end_tick(self, tick: TickProfile, worked: bool) -> None:
        """Close one tick. Idle ticks (``worked=False``, or nothing marked)
        record NOTHING — the ring and histograms carry only ticks that did
        work, so an idle engine's profile stays empty instead of drowning
        the signal in sub-millisecond no-op loops."""
        if not worked or not tick.phases:
            return
        total = max(0.0, self._clock() - tick.t0)
        entry = {
            "at": time.time(),  # wall clock: aligns with trace span starts
            "total": total,
            "device": tick.device_s,
            "phases": dict(tick.phases),
        }
        with self._lock:
            self._ring.append(entry)
            self._busy_ticks += 1
            refresh = self._busy_ticks % _GAUGE_EVERY == 0
        for phase, seconds in tick.phases.items():
            _obs.record_tick_phase(phase, seconds, registry=self._registry)
        _obs.record_tick_phase(
            C.TICK_TOTAL_PHASE, total, registry=self._registry
        )
        if refresh:
            self._refresh_ratio()

    def note_dispatch_tokens(self, n: int, steps: int | None = None) -> None:
        """One harvested decode dispatch accepted ``n`` tokens (both the
        classic block path and the macro-step path report here, so the
        BENCH ``multistep`` section's tokens-per-dispatch compares across
        arms); ``steps`` is the configured ``decode_steps`` at dispatch
        time."""
        with self._lock:
            self._dispatches += 1
            self._dispatch_tokens += int(n)
            if steps is not None:
                self._decode_steps = max(1, int(steps))

    def flush(self) -> None:
        """Force the host-overhead gauge current (engine stop / push time:
        a short run may never cross the every-N-ticks refresh)."""
        self._refresh_ratio()

    def _refresh_ratio(self) -> None:
        with self._lock:
            total = sum(e["total"] for e in self._ring)
            device = sum(e["device"] for e in self._ring)
        if total > 0:
            _obs.set_host_overhead_ratio(
                max(0.0, min(1.0, 1.0 - device / total)),
                registry=self._registry,
            )

    # -- read surfaces -------------------------------------------------------

    def overhead_summary(self) -> dict:
        """The BENCH ``overhead`` section / ``/profile`` payload: per-phase
        tick p50/p95 over the ring, the host fraction, the detokenize
        share and attribution coverage (attributed/total — structurally
        ≤ 1)."""
        with self._lock:
            ring = list(self._ring)
            dispatches = self._dispatches
            dispatch_tokens = self._dispatch_tokens
            decode_steps = self._decode_steps
        tokens_per_dispatch = (
            round(dispatch_tokens / dispatches, 3) if dispatches else None
        )
        if not ring:
            return {
                "ticks": 0,
                "host_fraction": None,
                "tick_p50": None,
                "tick_p95": None,
                "detok_share": None,
                "attribution_cover": None,
                "phases": {},
                "decode_steps": decode_steps,
                "dispatches": dispatches,
                "tokens_per_dispatch": tokens_per_dispatch,
            }
        totals = sorted(e["total"] for e in ring)
        sum_total = sum(totals)
        sum_device = sum(e["device"] for e in ring)
        sum_detok = sum(e["phases"].get("detokenize", 0.0) for e in ring)
        sum_attr = sum(sum(e["phases"].values()) for e in ring)
        phases: dict[str, dict] = {}
        for phase in C.TICK_PHASES:
            vals = sorted(
                e["phases"][phase] for e in ring if phase in e["phases"]
            )
            if vals:
                phases[phase] = {
                    "p50": round(_pct(vals, 0.50), 6),
                    "p95": round(_pct(vals, 0.95), 6),
                    "count": len(vals),
                }
        return {
            "ticks": len(ring),
            "host_fraction": round(
                max(0.0, min(1.0, 1.0 - sum_device / sum_total)), 6
            ) if sum_total > 0 else None,
            "tick_p50": round(_pct(totals, 0.50), 6),
            "tick_p95": round(_pct(totals, 0.95), 6),
            "detok_share": round(sum_detok / sum_total, 6)
            if sum_total > 0 else None,
            "attribution_cover": round(sum_attr / sum_total, 6)
            if sum_total > 0 else None,
            "phases": phases,
            "decode_steps": decode_steps,
            "dispatches": dispatches,
            "tokens_per_dispatch": tokens_per_dispatch,
        }

    def perfetto_snapshot(self) -> dict:
        """The ring in the shape the JAX package's Perfetto export takes as
        its ``profile=`` parameter (wall-clock ``at`` fields align with
        request-span timestamps)."""
        with self._lock:
            return {"ticks": [dict(e) for e in self._ring]}


# -- process registry (the gateway's /profile source) ------------------------

_registry_lock = threading.Lock()
#: weak refs so the registry never pins a dead engine's profiler (the
#: profiler's lazy-name callable holds the engine)
_profilers: list = []


def register(profiler: HotPathProfiler) -> None:
    with _registry_lock:
        _profilers.append(weakref.ref(profiler))
        # drop dead refs opportunistically; cap the list
        _profilers[:] = [r for r in _profilers if r() is not None][-64:]


def active_profilers() -> list[HotPathProfiler]:
    with _registry_lock:
        return [p for p in (r() for r in _profilers) if p is not None]
