"""Scheduler policies: the pluggable queue behind the engine's admission.

A copy of ``modal_examples_tpu/scheduling/policy.py``: the priority classes
(``PRIORITY_CLASSES``, ``DEFAULT_CLASS``, ``CLASS_RANK``,
``validate_class``), ``ScheduledRequest``, the ``SchedulerPolicy`` contract
and its two policies. The engine asks its policy for the next admission
batch instead of popping one FIFO. ``oldest_enqueued_at`` is the queue-age
watermark that ``serving/health.py`` reads.

Two levels of differentiation (:class:`FairSharePolicy`, the engine's
default):

- **priority classes**: ``interactive`` > ``default`` > ``batch``, strict: a
  class is only served when every higher class is empty (admission bounds
  each class's queue, so starved batch work sees fast 429s, not unbounded
  waits);
- **tenant fair share**: within a class, tenants are served by weighted
  deficit round robin (DRR) over their cost (estimated KV pages), so one
  tenant's flood cannot crowd out another tenant of the same class.

:class:`FIFOPolicy` is one global FIFO (classes tracked for depths only).
Policies are synchronized internally (client threads submit, the scheduler
thread pops) and take an injectable ``clock``, so deadlines are testable
with a fake clock.
"""

from __future__ import annotations

import abc
import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Callable

#: priority classes, highest first — the order IS the strict service order.
#: "canary" is the synthetic golden-set probe class: lowest rank so probes
#: never starve real traffic.
PRIORITY_CLASSES = ("interactive", "default", "batch", "canary")
DEFAULT_CLASS = "default"
#: class -> rank (lower serves first)
CLASS_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}


def validate_class(name: str) -> str:
    """Return ``name`` if it is a known priority class, else raise — servers
    call this up front so a typo'd class is a 400, not silent ``default``."""
    if name not in CLASS_RANK:
        raise ValueError(
            f"unknown priority class {name!r}; known: {PRIORITY_CLASSES}"
        )
    return name


@dataclasses.dataclass
class ScheduledRequest:
    """One queued unit of work: the engine's ``Request`` (or any payload)
    plus everything the policy and admission layers decide on."""

    payload: object
    priority: str = DEFAULT_CLASS
    tenant: str = "default"
    #: estimated cost in KV pages (admission fills it in); DRR charges it
    cost: int = 1
    #: absolute deadline in the policy's clock domain; None = no deadline
    deadline: float | None = None
    enqueued_at: float = 0.0


class SchedulerPolicy(abc.ABC):
    """The full waiting-set contract the engine schedules against.

    Every method is required — a policy that can't remove or expire entries
    would silently leak aborted/deadline-expired requests, so partial
    implementations are rejected by the ABC machinery.
    """

    def __init__(self, *, clock: Callable[[], float] | None = None):
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()

    @abc.abstractmethod
    def submit(self, entry: ScheduledRequest) -> None:
        """Enqueue one entry (stamps ``enqueued_at`` if unset)."""

    @abc.abstractmethod
    def next_batch(self, max_n: int) -> list[ScheduledRequest]:
        """Pop up to ``max_n`` entries in service order."""

    @abc.abstractmethod
    def requeue(self, entries: list[ScheduledRequest]) -> None:
        """Preemption-safe return: put popped-but-unscheduled entries back
        at the FRONT of their queues, original order preserved, without
        re-charging their fair-share cost."""

    @abc.abstractmethod
    def remove(self, entry: ScheduledRequest) -> bool:
        """Remove one queued entry (abort path). False = already popped."""

    @abc.abstractmethod
    def expired(self, now: float | None = None) -> list[ScheduledRequest]:
        """Remove and return every queued entry whose deadline has passed."""

    @abc.abstractmethod
    def depths(self) -> dict[str, int]:
        """Queued entries per priority class (every class always present)."""

    # -- shared conveniences (concrete; built on the ABC surface) -----------

    def total_depth(self) -> int:
        return sum(self.depths().values())

    def oldest_enqueued_at(self) -> float | None:
        """``enqueued_at`` of the oldest queued entry, or None when empty:
        the queue-age-head progress watermark (``serving/health.py``). A head
        that only gets older while the scheduler keeps ticking is a gray
        failure the depth gauges cannot see. The concrete policies override
        this with an O(depth) scan; the default None opts a custom policy
        out of the signal."""
        return None

    def drain(self) -> list[ScheduledRequest]:
        """Pop everything (engine stop/release path)."""
        out: list[ScheduledRequest] = []
        while True:
            batch = self.next_batch(1024)
            if not batch:
                return out
            out.extend(batch)


class FIFOPolicy(SchedulerPolicy):
    """The pre-scheduler behavior: one global FIFO, classes ignored for
    ordering (still tracked for depth gauges). The baseline policy for
    A/B-ing fairness changes."""

    def __init__(self, *, clock: Callable[[], float] | None = None):
        super().__init__(clock=clock)
        self._queue: deque[ScheduledRequest] = deque()

    def submit(self, entry: ScheduledRequest) -> None:
        with self._lock:
            if not entry.enqueued_at:
                entry.enqueued_at = self._clock()
            self._queue.append(entry)

    def next_batch(self, max_n: int) -> list[ScheduledRequest]:
        out: list[ScheduledRequest] = []
        with self._lock:
            while self._queue and len(out) < max_n:
                out.append(self._queue.popleft())
        return out

    def requeue(self, entries: list[ScheduledRequest]) -> None:
        with self._lock:
            for e in reversed(entries):
                self._queue.appendleft(e)

    def remove(self, entry: ScheduledRequest) -> bool:
        with self._lock:
            try:
                self._queue.remove(entry)
                return True
            except ValueError:
                return False

    def expired(self, now: float | None = None) -> list[ScheduledRequest]:
        now = self._clock() if now is None else now
        with self._lock:
            out = [
                e for e in self._queue
                if e.deadline is not None and now >= e.deadline
            ]
            for e in out:
                self._queue.remove(e)
        return out

    def depths(self) -> dict[str, int]:
        with self._lock:
            d = {c: 0 for c in PRIORITY_CLASSES}
            for e in self._queue:
                d[e.priority] = d.get(e.priority, 0) + 1
            return d

    def oldest_enqueued_at(self) -> float | None:
        with self._lock:
            return min((e.enqueued_at for e in self._queue if e.enqueued_at), default=None)


class FairSharePolicy(SchedulerPolicy):
    """Strict class priority + weighted deficit round robin across tenants.

    Per (class, tenant) FIFO queues. ``next_batch`` serves classes in
    :data:`PRIORITY_CLASSES` order; within a class it cycles tenants in
    first-seen order, crediting each visit ``quantum * weight`` cost units
    of deficit and popping entries while the head's cost fits — the
    classic DRR guarantee that long-run service is proportional to weight
    regardless of per-request cost. A tenant's deficit resets when its
    queue empties (no hoarding credit while idle).
    """

    def __init__(
        self,
        *,
        clock: Callable[[], float] | None = None,
        tenant_weights: dict[str, float] | None = None,
        quantum: int = 4,
    ):
        super().__init__(clock=clock)
        #: class -> tenant -> deque (OrderedDict keeps tenant visit order
        #: deterministic: first submission order)
        self._queues: dict[str, OrderedDict[str, deque]] = {
            c: OrderedDict() for c in PRIORITY_CLASSES
        }
        self._deficit: dict[tuple[str, str], float] = {}
        self.tenant_weights = dict(tenant_weights or {})
        self.quantum = max(1, int(quantum))

    def _weight(self, tenant: str) -> float:
        return max(0.01, float(self.tenant_weights.get(tenant, 1.0)))

    def submit(self, entry: ScheduledRequest) -> None:
        validate_class(entry.priority)
        with self._lock:
            if not entry.enqueued_at:
                entry.enqueued_at = self._clock()
            q = self._queues[entry.priority].setdefault(entry.tenant, deque())
            q.append(entry)

    def next_batch(self, max_n: int) -> list[ScheduledRequest]:
        out: list[ScheduledRequest] = []
        with self._lock:
            for cls in PRIORITY_CLASSES:
                tenants = self._queues[cls]
                while len(out) < max_n and any(tenants.values()):
                    for tenant in list(tenants):
                        q = tenants[tenant]
                        if not q:
                            del tenants[tenant]
                            continue
                        key = (cls, tenant)
                        self._deficit[key] = self._deficit.get(key, 0.0) + (
                            self.quantum * self._weight(tenant)
                        )
                        while (
                            q
                            and len(out) < max_n
                            and q[0].cost <= self._deficit[key]
                        ):
                            e = q.popleft()
                            self._deficit[key] -= e.cost
                            out.append(e)
                        if not q:
                            # idle tenants don't hoard credit
                            self._deficit.pop(key, None)
                            del tenants[tenant]
                        if len(out) >= max_n:
                            break
                if len(out) >= max_n:
                    break
        return out

    def requeue(self, entries: list[ScheduledRequest]) -> None:
        with self._lock:
            for e in reversed(entries):
                tenants = self._queues[e.priority]
                q = tenants.get(e.tenant)
                if q is None:
                    q = deque()
                    tenants[e.tenant] = q
                    tenants.move_to_end(e.tenant, last=False)
                q.appendleft(e)
                # refund the DRR charge: the entry was never actually served
                key = (e.priority, e.tenant)
                self._deficit[key] = self._deficit.get(key, 0.0) + e.cost

    def remove(self, entry: ScheduledRequest) -> bool:
        with self._lock:
            q = self._queues[entry.priority].get(entry.tenant)
            if q is None:
                return False
            try:
                q.remove(entry)
                return True
            except ValueError:
                return False

    def expired(self, now: float | None = None) -> list[ScheduledRequest]:
        now = self._clock() if now is None else now
        out: list[ScheduledRequest] = []
        with self._lock:
            for tenants in self._queues.values():
                for q in tenants.values():
                    dead = [
                        e for e in q
                        if e.deadline is not None and now >= e.deadline
                    ]
                    for e in dead:
                        q.remove(e)
                    out.extend(dead)
        return out

    def depths(self) -> dict[str, int]:
        with self._lock:
            return {
                c: sum(len(q) for q in tenants.values())
                for c, tenants in self._queues.items()
            }

    def oldest_enqueued_at(self) -> float | None:
        with self._lock:
            oldest = None
            for tenants in self._queues.values():
                for q in tenants.values():
                    for e in q:
                        if e.enqueued_at and (oldest is None or e.enqueued_at < oldest):
                            oldest = e.enqueued_at
            return oldest
