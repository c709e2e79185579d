"""Admission control: bounded per-class queues, cost-aware shedding,
deadlines.

A copy of ``modal_examples_tpu/scheduling/admission.py`` (``ShedError``,
``AdmissionConfig`` with ``from_env``, ``AdmissionController``), with its
metrics series (``mtpu_sheds_total``, ``mtpu_requests_admitted_total``,
``mtpu_kv_pages_reserved``) and its usage hook; the counters are attributes
too (``reserved_pages``, ``sheds``, ``admitted``, ``shed_rate()``). The
OpenAI server answers a :class:`ShedError` with HTTP 429 and
``Retry-After``.

Three shedding rules, checked at submit time:

- ``queue_full`` — the request's priority class already has
  ``max_queue[class]`` entries waiting (bounds are per class, so a batch
  flood fills only the batch queue);
- ``too_large`` — the request's estimated KV footprint exceeds the whole
  page pool; it could never be scheduled;
- ``kv_pressure`` — optional (off by default): live page occupancy plus the
  pages already promised to queued work plus this request would exceed the
  class's occupancy ceiling, so batch work sheds first as the cache fills.

Reservation accounting: an admitted-but-not-yet-scheduled request reserves
its estimated pages. The engine releases the reservation when the real claim
happens at prefill admission, or when the request is aborted or its deadline
expires while still queued.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable

from ..observability import metrics as _obs
from .policy import PRIORITY_CLASSES, ScheduledRequest, validate_class


class ShedError(RuntimeError):
    """Request rejected by admission control. API layers translate this to
    HTTP 429 with ``Retry-After: ceil(retry_after_s)``."""

    def __init__(self, reason: str, retry_after_s: float, message: str):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = max(1.0, float(retry_after_s))


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _env_float(name: str) -> float | None:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else None
    except ValueError:
        return None


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Per-class queue bounds + optional occupancy ceilings.

    ``max_queue`` maps class -> bound. ``kv_ceiling`` maps class -> max
    (occupancy + reserved + this request) fraction; a missing class never
    sheds on pressure. ``retry_after_s`` is the base back-off hint, scaled
    up with queue depth.
    """

    max_queue: dict = dataclasses.field(
        default_factory=lambda: {c: 4096 for c in PRIORITY_CLASSES}
    )
    kv_ceiling: dict = dataclasses.field(default_factory=dict)
    retry_after_s: float = 1.0

    @classmethod
    def from_env(cls) -> "AdmissionConfig":
        """Production defaults, env-overridable:

        - ``MTPU_SCHED_MAX_QUEUE`` (all classes) and per-class
          ``MTPU_SCHED_MAX_QUEUE_INTERACTIVE/_DEFAULT/_BATCH``;
        - ``MTPU_SCHED_KV_HEADROOM`` — the *batch* occupancy ceiling;
          ``default`` gets +0.10 (capped at 1.0) and ``interactive`` never
          sheds on pressure. Unset = pressure shedding off.
        """
        base = _env_int("MTPU_SCHED_MAX_QUEUE", 4096)
        max_queue = {
            c: _env_int(f"MTPU_SCHED_MAX_QUEUE_{c.upper()}", base)
            for c in PRIORITY_CLASSES
        }
        kv_ceiling: dict = {}
        headroom = _env_float("MTPU_SCHED_KV_HEADROOM")
        if headroom is not None:
            kv_ceiling = {
                "batch": headroom,
                "default": min(1.0, headroom + 0.10),
            }
        return cls(max_queue=max_queue, kv_ceiling=kv_ceiling)


class AdmissionController:
    """Stateful admission gate: bounds, pressure shedding, reservations."""

    def __init__(
        self,
        config: AdmissionConfig | None = None,
        *,
        clock: Callable[[], float] | None = None,
    ):
        self.config = config or AdmissionConfig.from_env()
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self.reserved_pages = 0
        self.sheds = 0  # monotonic, all classes/reasons
        self.admitted = 0
        # the owning engine's EngineUsage (observability/usage.py): sheds
        # are charged to the tenant and class that were turned away
        self.usage = None

    def _shed(self, entry: ScheduledRequest, reason: str, depth: int,
              message: str) -> ShedError:
        with self._lock:
            self.sheds += 1
        _obs.record_shed(entry.priority, reason)
        if self.usage is not None:
            self.usage.note_shed(entry.tenant, entry.priority)
        bound = max(1, self.config.max_queue.get(entry.priority, 1))
        retry = self.config.retry_after_s * (1.0 + depth / bound)
        return ShedError(reason, retry, message)

    def admit(
        self,
        entry: ScheduledRequest,
        *,
        depths: dict,
        pages_used: int,
        pages_total: int,
    ) -> None:
        """Admit ``entry`` (reserving its cost) or raise :class:`ShedError`.

        ``depths`` is the policy's current per-class queue depth;
        ``pages_used``/``pages_total`` come from the live KV allocator
        (``PagedKVCache.occupancy()``).
        """
        validate_class(entry.priority)
        cfg = self.config
        depth = int(depths.get(entry.priority, 0))
        bound = cfg.max_queue.get(entry.priority)
        if bound is not None and depth >= bound:
            raise self._shed(
                entry, "queue_full", depth,
                f"{entry.priority} queue is full ({depth}/{bound})",
            )
        if pages_total > 0 and entry.cost > pages_total:
            raise self._shed(
                entry, "too_large", depth,
                f"request needs {entry.cost} KV pages; the pool has "
                f"{pages_total}",
            )
        ceiling = cfg.kv_ceiling.get(entry.priority)
        if ceiling is not None and pages_total > 0:
            with self._lock:
                projected = (
                    pages_used + self.reserved_pages + entry.cost
                ) / pages_total
            if projected > ceiling:
                raise self._shed(
                    entry, "kv_pressure", depth,
                    f"projected KV occupancy {projected:.2f} exceeds the "
                    f"{entry.priority} ceiling {ceiling:.2f}",
                )
        with self._lock:
            self.reserved_pages += entry.cost
            self.admitted += 1
            reserved = self.reserved_pages
        _obs.set_kv_pages_reserved(reserved)
        _obs.record_admitted(entry.priority)

    def release(self, entry: ScheduledRequest) -> None:
        """Return a queued entry's page reservation (popped for prefill,
        aborted, or deadline-expired)."""
        with self._lock:
            self.reserved_pages = max(0, self.reserved_pages - entry.cost)
            reserved = self.reserved_pages
        _obs.set_kv_pages_reserved(reserved)

    def reserve(self, entry: ScheduledRequest) -> None:
        """Re-take a reservation (claim failed; the entry was requeued)."""
        with self._lock:
            self.reserved_pages += entry.cost
            reserved = self.reserved_pages
        _obs.set_kv_pages_reserved(reserved)

    def shed_rate(self) -> float:
        """Lifetime shed fraction (sheds / offered load)."""
        with self._lock:
            offered = self.sheds + self.admitted
            return self.sheds / offered if offered else 0.0
