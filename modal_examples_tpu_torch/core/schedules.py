"""Copy of ``modal_examples_tpu/core/schedules.py``: cron/periodic schedules for deployed functions.

Reference spec: ``schedule=modal.Period(seconds=5)`` and
``modal.Cron("* * * * *")`` (05_scheduling/schedule_simple.py:27,34); daily
jobs like hackernews_alerts.py:97 use ``modal.Cron("0 9 * * *")``. Schedules
fire on *deployed* apps; ``python -m modal_examples_tpu_torch serve|deploy`` starts the scheduler loop.

The cron parser supports the standard 5-field syntax with ``*``, lists,
ranges, and ``*/step``.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt


class InvalidSchedule(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Period:
    days: float = 0
    hours: float = 0
    minutes: float = 0
    seconds: float = 0

    @property
    def total_seconds(self) -> float:
        return (
            self.days * 86400 + self.hours * 3600 + self.minutes * 60 + self.seconds
        )

    def __post_init__(self):
        if self.total_seconds <= 0:
            raise InvalidSchedule("Period must be positive")

    def next_fire(self, now: _dt.datetime) -> _dt.datetime:
        return now + _dt.timedelta(seconds=self.total_seconds)


_FIELD_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]  # min hr dom mon dow


def _parse_field(field: str, lo: int, hi: int) -> frozenset[int]:
    values: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step < 1:
                raise InvalidSchedule(f"bad step in cron field {field!r}")
        if part == "*":
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = int(a), int(b)
        else:
            start = end = int(part)
        if not (lo <= start <= hi and lo <= end <= hi and start <= end):
            raise InvalidSchedule(f"cron field {field!r} out of range [{lo},{hi}]")
        values.update(range(start, end + 1, step))
    return frozenset(values)


@dataclasses.dataclass(frozen=True)
class Cron:
    expression: str

    def __post_init__(self):
        fields = self.expression.split()
        if len(fields) != 5:
            raise InvalidSchedule(
                f"cron expression needs 5 fields, got {len(fields)}: {self.expression!r}"
            )
        parsed = tuple(
            _parse_field(f, lo, hi) for f, (lo, hi) in zip(fields, _FIELD_RANGES)
        )
        object.__setattr__(self, "_fields", parsed)

    def matches(self, t: _dt.datetime) -> bool:
        minute, hour, dom, month, dow = self._fields  # type: ignore[attr-defined]
        return (
            t.minute in minute
            and t.hour in hour
            and t.day in dom
            and t.month in month
            and t.weekday() in _cron_dow(dow)
        )

    def next_fire(self, now: _dt.datetime) -> _dt.datetime:
        """Next minute boundary strictly after ``now`` matching the expression."""
        t = now.replace(second=0, microsecond=0) + _dt.timedelta(minutes=1)
        # 4 years of minutes bounds the scan for any valid expression.
        for _ in range(4 * 366 * 24 * 60):
            if self.matches(t):
                return t
            t += _dt.timedelta(minutes=1)
        raise InvalidSchedule(f"cron expression never fires: {self.expression!r}")


def _cron_dow(dow: frozenset[int]) -> frozenset[int]:
    # cron: 0=Sunday..6=Saturday; datetime.weekday(): 0=Monday..6=Sunday.
    return frozenset((d - 1) % 7 for d in dow)


Schedule = Period | Cron
