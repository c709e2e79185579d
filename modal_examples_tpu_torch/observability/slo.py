"""SLO evaluator: declared latency/error targets vs the live histograms.

After ``modal_examples_tpu/observability/slo.py``.

The latency histograms give real distributions; this layer turns them
into a pass/fail answer. An :class:`SLO` declares a target over one catalog
series — a quantile bound on a histogram (``p95 TTFT <= 2 s``) or a ratio
bound between two counters (``scheduler errors / decode steps <= 1%``) —
and :func:`evaluate` compares each against the registry, computing a **burn
rate** (observed / target; > 1.0 means the target is being violated, 0.5
means half the budget is consumed). Surfaced three ways:

- gateway ``GET /healthz`` returns ``{"status": ok|degraded, "slos": [...]}``
  (degraded = any SLO violating with data present);
- the CLI's ``top`` renders the same reports from pushed metrics;
- each evaluation writes ``mtpu_slo_burn_rate{slo=...}`` back into the
  registry so burn rates are themselves scrapeable.

Targets are overridable per-process via ``MTPU_SLO_<NAME>`` env vars (e.g.
``MTPU_SLO_TTFT_P95_S=0.5``); a series with no observations reports
``observed=None`` and passes (no data is not an outage).
"""

from __future__ import annotations

import dataclasses
import os

from ..utils.prometheus import Registry, default_registry
from . import catalog as C


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declared objective.

    ``kind="latency"``: ``quantile`` of histogram ``series`` must stay
    <= ``target`` (seconds). ``kind="ratio"``: ``total(series)`` over
    ``total(denom_series)`` must stay <= ``target`` (a fraction).
    ``aggregate`` sums the histogram across label sets containing the given
    items ({} = all of them) before taking the quantile.
    """

    name: str
    series: str
    target: float
    kind: str = "latency"  # "latency" | "ratio"
    quantile: float = 0.95
    aggregate: dict | None = dataclasses.field(default_factory=dict)
    denom_series: str | None = None
    #: label filter applied to the denominator sum (ratio kind) — e.g.
    #: {"phase": "total"} so a per-phase histogram counts calls, not phases
    denom_match: dict | None = None
    env: str | None = None  # override env var name

    def resolved_target(self) -> float:
        if self.env:
            raw = os.environ.get(self.env, "")
            if raw:
                try:
                    return float(raw)
                except ValueError:
                    pass
        return self.target


#: default objectives: serving TTFT, end-to-end call latency, engine error
#: budget, and call retry budget — the ROADMAP's "fast as the hardware
#: allows" scorecard
DEFAULT_SLOS: tuple[SLO, ...] = (
    SLO(
        name="ttft_p95",
        series=C.TTFT_SECONDS,
        target=2.0,
        env="MTPU_SLO_TTFT_P95_S",
    ),
    SLO(
        name="tpot_p95",
        series=C.TPOT_SECONDS,
        target=0.25,
        env="MTPU_SLO_TPOT_P95_S",
    ),
    SLO(
        name="call_total_p95",
        series=C.CALL_DURATION_SECONDS,
        target=30.0,
        aggregate={"phase": "total"},
        env="MTPU_SLO_CALL_P95_S",
    ),
    SLO(
        name="scheduler_error_rate",
        series=C.SCHEDULER_ERRORS_TOTAL,
        denom_series=C.DECODE_STEPS_TOTAL,
        target=0.01,
        kind="ratio",
        env="MTPU_SLO_ERROR_RATE",
    ),
    SLO(
        name="call_retry_rate",
        series=C.RETRIES_TOTAL,
        denom_series=C.CALL_DURATION_SECONDS,
        # phase=total only: the histogram holds ~6 phase observations per
        # call, and dividing by all of them would dilute the rate ~6x
        denom_match={"phase": "total"},
        target=0.2,
        kind="ratio",
        env="MTPU_SLO_RETRY_RATE",
    ),
    SLO(
        # scheduling: deadline-armed requests that blew their budget
        # (queued-cancelled + inflight-aborted) over admitted load — the
        # scheduler's own SLO: shedding and priority exist to keep this low
        name="deadline_miss_rate",
        series=C.DEADLINE_MISSES_TOTAL,
        denom_series=C.REQUESTS_ADMITTED_TOTAL,
        target=0.05,
        kind="ratio",
        env="MTPU_SLO_DEADLINE_MISS_RATE",
    ),
)


def evaluate(
    registry: Registry | None = None,
    slos: tuple[SLO, ...] | None = None,
    *,
    burn_rate_registry: Registry | None = None,
) -> list[dict]:
    """Evaluate each SLO against ``registry``; returns one report dict per
    SLO: ``{"name", "kind", "target", "observed", "ok", "burn_rate"}``.

    ``burn_rate_registry`` (default: the evaluated registry) receives the
    ``mtpu_slo_burn_rate`` gauge writes — pass ``None``-able here matters
    when evaluating a *parsed* registry (the CLI's top) where writing back
    would be pointless.
    """
    reg = registry if registry is not None else default_registry
    sink = burn_rate_registry if burn_rate_registry is not None else reg
    reports = []
    for slo in slos or DEFAULT_SLOS:
        target = slo.resolved_target()
        observed: float | None
        if slo.kind == "ratio":
            num = reg.total(slo.series)
            den = (
                reg.total(slo.denom_series, slo.denom_match)
                if slo.denom_series
                else 0.0
            )
            observed = (num / den) if den > 0 else None
        else:
            q = reg.histogram_quantiles(
                slo.series,
                quantiles=(slo.quantile,),
                aggregate=slo.aggregate,
            )
            observed = (
                q[f"p{int(slo.quantile * 100)}"] if q is not None else None
            )
        burn = (
            observed / target if (observed is not None and target > 0) else None
        )
        ok = burn is None or burn <= 1.0
        reports.append(
            {
                "name": slo.name,
                "kind": slo.kind,
                "target": target,
                "observed": observed,
                "ok": ok,
                "burn_rate": round(burn, 4) if burn is not None else None,
            }
        )
        if burn is not None:
            sink.gauge_set(
                C.SLO_BURN_RATE,
                burn,
                labels={"slo": slo.name},
                help=C.CATALOG[C.SLO_BURN_RATE]["help"],
            )
    return reports


def healthz(registry: Registry | None = None) -> dict:
    """The gateway ``/healthz`` payload: overall status + per-SLO reports.
    ``degraded`` only when an SLO with actual observations is violating.

    With no explicit ``registry``, evaluation runs over this process's live
    registry MERGED with every pushed job file (the same view ``/metrics``
    serves) — in the deployed shape the serving engine's TTFT/TPOT
    histograms live in a container process and arrive via the pushgateway,
    and a health check blind to them would report "ok" forever. Burn-rate
    gauges still land in the live default registry.
    """
    if registry is None:
        from ..utils.prometheus import parse_exposition
        from .export import live_and_pushed_metrics

        merged = parse_exposition(live_and_pushed_metrics())
        reports = evaluate(merged, burn_rate_registry=default_registry)
    else:
        reports = evaluate(registry)
    status = "ok" if all(r["ok"] for r in reports) else "degraded"
    return {"status": status, "slos": reports}
