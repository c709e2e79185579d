"""Declarative alert rules evaluated over tsdb windows

After ``modal_examples_tpu/observability/alerts.py``.
(docs/observability.md#alert-rules).

The SLO layer answers "is the target violated *right now*"; dashboards
answer "what does the operator see when they look". Neither pages anyone,
and neither captures the evidence. An :class:`AlertRule` is a declarative
condition over a :mod:`.timeseries` window — threshold (a sustained level),
rate (a burn-window: per-second increase of a counter), or absence (a
counter that stopped moving while a guard series says there is work) —
with fire/clear hysteresis, so a single noisy scrape cannot flap a page.

Discipline, same as every other schema in the package: every series an
:class:`AlertRule` references must be declared in :mod:`.catalog`
(``tests/test_static.py`` closes the loop), transitions emit the cataloged
``mtpu_alerts_active{rule}`` / ``mtpu_alerts_fired_total{rule}`` series,
and every fire/clear appends to the ``alerts`` journal
(:func:`~.journal.named_journal`) so the CLI's ``alerts`` and the gateway's
``/alerts`` can replay the history after the process is gone. A rule with
``capture=True`` snapshots an incident bundle (:mod:`.incident`) at the
fire transition — the alert IS the trigger that preserves its own
evidence.

The evaluator normally rides the :class:`~.timeseries.TsdbSampler` (one
scrape, one evaluation, no second thread); tests drive
:meth:`AlertEvaluator.evaluate_once` directly with a fake clock and a
hand-built record window.
"""

from __future__ import annotations

import dataclasses
import time

from . import catalog as C
from . import metrics as _obs
from . import timeseries as _ts
from .journal import named_journal

#: rule kinds (the evaluation semantics, below)
KINDS = ("threshold", "rate", "absence")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative alert.

    - ``kind="threshold"`` — the newest point inside ``window_s`` satisfies
      ``value <op> threshold``; the evaluator's state machine then holds
      the condition for ``for_s`` before firing (``for_s=0`` fires on the
      first true evaluation).
    - ``kind="rate"`` — the per-second increase of the series over
      ``window_s`` (:func:`~.timeseries.rate`; ``field="sum"`` reads a
      histogram's cumulative seconds) satisfies ``<op> threshold``.
    - ``kind="absence"`` — the series did not increase over ``window_s``
      while the guard condition held at the newest scrape (absence of
      progress only means anything against outstanding work — the
      watchdog's idle-is-healthy rule).

    Clearing is hysteretic: the condition must stay false for ``clear_s``
    before a firing rule clears.
    """

    name: str
    series: str
    kind: str = "threshold"
    op: str = ">="  # ">=" | "<="
    threshold: float = 1.0
    labels: dict | None = None
    #: fold across matching label sets: "max" for 0..1 gauges (a fraction
    #: must never sum across replicas), "sum" for counters/counts
    agg: str = "max"
    field: str = "value"  # "value" | "sum" (histogram cumulative seconds)
    window_s: float = 60.0
    for_s: float = 0.0
    clear_s: float = 0.0
    #: absence-kind guard: only alert while guard_series (latest point,
    #: same agg rules) is > guard_threshold
    guard_series: str | None = None
    guard_labels: dict | None = None
    guard_threshold: float = 0.0
    #: capture an incident bundle at the fire transition (opt-in per rule)
    capture: bool = False
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown alert kind {self.kind!r}; one of {KINDS}")
        if self.op not in (">=", "<="):
            raise ValueError(f"unknown alert op {self.op!r}; one of >=, <=")


def rule_series(rule: AlertRule) -> tuple[str, ...]:
    """Every catalog series the rule reads — the static guard's closure
    surface (``tests/test_static.py``)."""
    out = [rule.series]
    if rule.guard_series:
        out.append(rule.guard_series)
    return tuple(out)


#: the starter rule set: SLO burn, host-overhead regression, decode-stall
#: burn, a wedged replica, KV-page pressure, and absence-of-token-progress.
#: Thresholds are deliberately conservative — a rule that cries wolf
#: teaches operators to ignore the recorder.
DEFAULT_RULES: tuple[AlertRule, ...] = (
    AlertRule(
        name="slo_burn",
        series=C.SLO_BURN_RATE,
        threshold=1.0,
        for_s=10.0,
        clear_s=10.0,
        description="any declared SLO burning above 1.0 sustained",
    ),
    AlertRule(
        name="host_overhead",
        series=C.HOST_OVERHEAD_RATIO,
        threshold=0.97,
        for_s=30.0,
        clear_s=15.0,
        description="scheduler ticks ~entirely host-bound (device starved)",
    ),
    AlertRule(
        name="decode_stall_burn",
        series=C.DECODE_STALL_SECONDS,
        kind="rate",
        field="sum",
        agg="sum",
        threshold=0.5,
        window_s=30.0,
        clear_s=15.0,
        description="decode dispatch gaps burning >0.5 stall-seconds/s",
    ),
    AlertRule(
        name="replica_wedged",
        series=C.WATCHDOG_REPLICA_STATE,
        labels={"state": "wedged"},
        threshold=1.0,
        clear_s=5.0,
        # the watchdog's own ladder already captures the wedge bundle;
        # a second capture here would only duplicate it
        description="a replica classified wedged by the progress watchdog",
    ),
    AlertRule(
        name="kv_pressure",
        series=C.KV_PAGE_OCCUPANCY,
        threshold=0.98,
        for_s=10.0,
        clear_s=10.0,
        description="KV page pool ~exhausted sustained (sheds imminent)",
    ),
    AlertRule(
        name="mbu_collapse",
        series=C.HBM_BW_UTIL,
        labels={"phase": "decode"},
        op="<=",
        threshold=0.01,
        for_s=20.0,
        clear_s=10.0,
        guard_series=C.ACTIVE_SLOTS,
        guard_threshold=0.0,
        description=(
            "decode bandwidth utilization collapsed while decodable slots "
            "exist — the wedge precursor (work admitted, HBM idle)"
        ),
    ),
    AlertRule(
        name="spec_acceptance_collapse",
        series=C.SPEC_ACCEPTANCE_RATE,
        op="<=",
        threshold=0.3,
        for_s=20.0,
        clear_s=10.0,
        # guard on dispatched depth: acceptance is only meaningful while
        # the engine is actually speculating — once the adaptive controller
        # drives gamma to 0 the rate freezes and must not keep paging
        guard_series=C.SPEC_GAMMA,
        guard_threshold=0.0,
        description=(
            "draft acceptance collapsed while speculation is still being "
            "dispatched — the draft stopped predicting the target "
            "(docs/speculative.md#gamma-schedule); expect the adaptive "
            "controller to drive gamma down, else spec is a latency tax"
        ),
    ),
    AlertRule(
        name="no_token_progress",
        series=C.GENERATED_TOKENS_TOTAL,
        kind="absence",
        agg="sum",
        window_s=30.0,
        clear_s=5.0,
        guard_series=C.ACTIVE_SLOTS,
        guard_threshold=0.0,
        capture=True,
        description="active slots but zero tokens generated over the window",
    ),
    AlertRule(
        name="canary_drift",
        series=C.CANARY_DRIFT_TOTAL,
        kind="rate",
        agg="sum",
        threshold=0.001,
        window_s=60.0,
        clear_s=30.0,
        # the prober already captures a canary_drift incident per drifted
        # probe (with the mismatching request id in the reason); capturing
        # here too would duplicate the bundle
        description=(
            "a replica's golden-set probe diverged bit-exact from its "
            "golden transcript (numeric drift sentinel)"
        ),
    ),
    AlertRule(
        name="canary_latency_burn",
        series=C.CANARY_E2E_SECONDS,
        kind="rate",
        field="sum",
        agg="sum",
        threshold=2.0,
        window_s=60.0,
        clear_s=30.0,
        description=(
            "canary probes burning >2 probe-seconds/s — the fleet is slow "
            "from the client's seat even if no tenant is complaining yet"
        ),
    ),
)


def _cmp(value: float, op: str, threshold: float) -> bool:
    return value >= threshold if op == ">=" else value <= threshold


class AlertEvaluator:
    """Fire/clear state machine over a record window.

    ``source`` is a :class:`~.timeseries.TsdbSampler` (its in-memory ring)
    or any object with ``recent(window_s) -> [records]``; tests pass a
    stub. Transitions journal to ``alerts`` (``path``/``root`` override for
    tests) and emit the cataloged gauge/counter into ``registry``.
    """

    def __init__(
        self,
        rules: tuple[AlertRule, ...] | None = None,
        *,
        source=None,
        registry=None,
        root=None,
        journal_path=None,
        clock=None,
    ):
        self.rules = tuple(rules) if rules is not None else DEFAULT_RULES
        self._source = source
        self._registry = registry
        self._root = root
        self._journal = named_journal("alerts", root, path=journal_path)
        self._clock = clock or time.time
        #: rule name -> {"firing", "since", "clear_since"}
        self._state: dict[str, dict] = {
            r.name: {"firing": False, "since": None, "clear_since": None}
            for r in self.rules
        }

    # -- condition evaluation ------------------------------------------------

    def _condition(
        self, rule: AlertRule, records: list[dict], now: float
    ) -> tuple[bool, float | None]:
        """(condition holds, the value that decided it)."""
        pts = _ts.series_points(
            rule.series, records,
            labels=rule.labels, agg=rule.agg, field=rule.field,
        )
        if rule.kind == "rate":
            window = [p for p in pts if p[0] >= now - rule.window_s]
            r = _ts.rate(window)
            return (r is not None and _cmp(r, rule.op, rule.threshold)), r
        if rule.kind == "absence":
            guard_pts = _ts.series_points(
                rule.guard_series or rule.series, records,
                labels=rule.guard_labels, agg=rule.agg,
            )
            if not guard_pts or guard_pts[-1][1] <= rule.guard_threshold:
                return False, None  # no outstanding work: silence is healthy
            window = [p for p in pts if p[0] >= now - rule.window_s]
            if len(window) < 2:
                return False, None  # not enough history to claim stagnation
            # counter-reset aware (rate() convention): a window spanning a
            # process restart shows last < first while tokens ARE flowing —
            # endpoint comparison would falsely page the capture rule
            increase = _ts.rate(window)
            if increase is None:
                return False, None  # zero elapsed: cannot claim stagnation
            return (increase <= 0.0), window[-1][1]
        # threshold: the NEWEST point inside window_s decides; sustainment
        # is the state machine's job (evaluate_once holds for_s before the
        # fire) — requiring the data window to ALSO hold for_s would double
        # the fire latency. window_s here only bounds staleness: a series
        # that stopped reporting cannot keep deciding the condition.
        if rule.guard_series:
            # guarded threshold (same semantics as absence): the condition
            # only holds while the guard's latest point shows outstanding
            # work — a "<=" rule over a utilization gauge must not page an
            # idle engine whose meters legitimately read zero
            guard_pts = _ts.series_points(
                rule.guard_series, records,
                labels=rule.guard_labels, agg=rule.agg,
            )
            if not guard_pts or guard_pts[-1][1] <= rule.guard_threshold:
                return False, None
        window = [p for p in pts if p[0] >= now - rule.window_s]
        if not window:
            return False, None
        value = window[-1][1]
        return _cmp(value, rule.op, rule.threshold), value

    def condition_now(
        self, rule: AlertRule, records: list[dict], now: float | None = None
    ) -> tuple[bool, float | None]:
        """One-shot condition check over an offline window (the CLI's
        ``alerts`` rendering the on-disk tsdb without evaluator state)."""
        now = self._clock() if now is None else now
        return self._condition(rule, records, now)

    # -- the state machine ---------------------------------------------------

    def evaluate_once(self, now: float | None = None) -> list[dict]:
        """Fold one window into every rule's state; returns the transitions
        (also journaled and counted). Safe to call from the sampler thread."""
        now = self._clock() if now is None else now
        horizon = max(
            (max(r.window_s, r.for_s) for r in self.rules), default=60.0
        )
        records = (
            self._source.recent(horizon + 5.0) if self._source is not None
            else _ts.read_window(start=now - horizon - 5.0, root=self._root)
        )
        out: list[dict] = []
        for rule in self.rules:
            st = self._state[rule.name]
            try:
                cond, value = self._condition(rule, records, now)
            except Exception:
                continue  # a malformed window must not kill the sampler
            if cond:
                st["clear_since"] = None
                if st["since"] is None:
                    st["since"] = now
                held = now - st["since"]
                if not st["firing"] and held >= rule.for_s:
                    st["firing"] = True
                    out.append(self._transition(rule, "fire", value, now))
            else:
                st["since"] = None
                if st["firing"]:
                    if st["clear_since"] is None:
                        st["clear_since"] = now
                    if now - st["clear_since"] >= rule.clear_s:
                        st["firing"] = False
                        st["clear_since"] = None
                        out.append(self._transition(rule, "clear", value, now))
            _obs.set_alert_active(
                rule.name, st["firing"], registry=self._registry
            )
        return out

    def _transition(
        self, rule: AlertRule, event: str, value, now: float
    ) -> dict:
        rec = {
            "at": now,
            "event": event,
            "rule": rule.name,
            "series": rule.series,
            "kind": rule.kind,
            "threshold": rule.threshold,
            "value": round(value, 6) if isinstance(value, float) else value,
        }
        self._journal.record(rec)
        if event == "fire":
            _obs.record_alert_fired(rule.name, registry=self._registry)
            if rule.capture:
                from . import incident as _incident

                _incident.capture(
                    "alert",
                    reason=f"rule {rule.name}: {rule.description}",
                    root=self._root,
                    registry=self._registry,
                )
        return rec

    def active(self) -> list[str]:
        """Names of currently-firing rules."""
        return [n for n, st in self._state.items() if st["firing"]]

    def snapshot(self) -> list[dict]:
        """Per-rule state for the gateway's ``/alerts`` payload."""
        return [
            {
                "rule": r.name,
                "kind": r.kind,
                "series": r.series,
                "threshold": r.threshold,
                "firing": self._state[r.name]["firing"],
                "capture": r.capture,
                "description": r.description,
            }
            for r in self.rules
        ]


def evaluate_offline(
    records: list[dict],
    now: float | None = None,
    rules: tuple[AlertRule, ...] | None = None,
) -> list[dict]:
    """One-shot per-rule condition rows over an offline record window —
    the ONE read shared by the CLI's ``alerts`` and the gateway's ``/alerts``
    when no live evaluator runs in-process (schema matches
    :meth:`AlertEvaluator.snapshot` plus the deciding ``value``)."""
    ev = AlertEvaluator(rules)
    if now is None and records:
        now = records[-1]["at"]
    out: list[dict] = []
    for rule in ev.rules:
        cond, value = (
            ev.condition_now(rule, records, now=now)
            if records
            else (False, None)
        )
        out.append({
            "rule": rule.name,
            "kind": rule.kind,
            "series": rule.series,
            "threshold": rule.threshold,
            "firing": cond,
            "value": value,
            "capture": rule.capture,
            "description": rule.description,
        })
    return out


def read_alert_journal(n: int = 50, root=None) -> list[dict]:
    """Newest-last fire/clear history (torch-free — the CLI/gateway read)."""
    return named_journal("alerts", root).tail(n)
