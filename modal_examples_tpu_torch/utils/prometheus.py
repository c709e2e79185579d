"""Copy of ``modal_examples_tpu/utils/prometheus.py``: the port keeps its own instance.

Metrics: counters/gauges/histograms with Prometheus text exposition and a
push-style aggregator.

Reference pattern (SURVEY.md §5.5): scrape-based Prometheus doesn't fit
ephemeral containers, so the reference runs a Pushgateway *as an app*
(10_integrations/pushgateway.py:8-12,62-69) and functions push counters to
it. Here the registry + exposition format are implemented directly (no Go
binary needed), and the aggregator pattern is a Dict-backed push sink any
app can serve via a web endpoint.

Exposition follows the Prometheus text format rules: label values are
escaped (``\\``, ``"``, newline), each metric name carries exactly one
``# HELP``/``# TYPE`` header, and histograms emit cumulative ``_bucket``
series ending in ``le="+Inf"`` plus ``_sum``/``_count``.
"""

from __future__ import annotations

import math
import re
import threading
from collections import defaultdict

#: default latency buckets (seconds) — sub-ms dispatch up to multi-minute
#: cold boots, roughly log-spaced like prometheus client defaults
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def escape_label_value(value) -> str:
    """Escape a label value per the Prometheus text exposition format."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_le(le: float) -> str:
    if math.isinf(le):
        return "+Inf"
    return f"{le:.10g}"


def _label_str(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels
    )
    return "{" + inner + "}"


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = defaultdict(float)
        self._gauges: dict[tuple, float] = {}
        # key -> {"buckets": (le,...), "counts": [per-bucket + overflow],
        #         "sum": float, "count": int}
        self._histograms: dict[tuple, dict] = {}
        self._help: dict[str, str] = {}
        self._types: dict[str, str] = {}

    def _key(self, name: str, labels: dict | None):
        return (name, tuple(sorted((labels or {}).items())))

    def counter_inc(self, name: str, value: float = 1.0, labels: dict | None = None,
                    help: str = ""):
        with self._lock:
            self._counters[self._key(name, labels)] += value
            self._types[name] = "counter"
            if help:
                self._help[name] = help

    def gauge_set(self, name: str, value: float, labels: dict | None = None,
                  help: str = ""):
        with self._lock:
            self._gauges[self._key(name, labels)] = value
            self._types[name] = "gauge"
            if help:
                self._help[name] = help

    def histogram_observe(self, name: str, value: float,
                          labels: dict | None = None,
                          buckets: tuple | None = None, help: str = ""):
        """Observe one value into a histogram series.

        ``buckets`` are upper bounds (``le``); the ``+Inf`` bucket is
        implicit. The bucket layout is fixed by the first observation of a
        series — later ``buckets=`` arguments are ignored for it.
        """
        key = self._key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                bs = tuple(sorted(buckets or DEFAULT_TIME_BUCKETS))
                h = {"buckets": bs, "counts": [0] * (len(bs) + 1),
                     "sum": 0.0, "count": 0}
                self._histograms[key] = h
            for i, le in enumerate(h["buckets"]):
                if value <= le:
                    h["counts"][i] += 1
                    break
            else:
                h["counts"][-1] += 1  # +Inf overflow
            h["sum"] += value
            h["count"] += 1
            self._types[name] = "histogram"
            if help:
                self._help[name] = help

    def histogram_quantiles(
        self, name: str, labels: dict | None = None,
        quantiles: tuple = (0.5, 0.95, 0.99),
        aggregate: dict | None = None,
    ) -> dict | None:
        """Estimate quantiles from a histogram series (linear interpolation
        within the winning bucket, like PromQL ``histogram_quantile``).
        Returns ``{"p50": ..., ..., "count": n, "sum": s}`` or None when the
        series was never observed (empty histograms never fabricate a 0.0).

        ``aggregate`` sums every series of ``name`` whose label dict contains
        the given items (``{}`` = all of them) before computing — the PromQL
        ``sum by ()`` analog used by SLO evaluation. Series whose bucket
        layout differs from the first matching one are skipped.

        Edge cases (rather than extrapolating nonsense): a quantile landing
        in the ``+Inf`` overflow bucket clamps to the largest finite bound;
        interpolation fractions are clamped to [0, 1] so zero-count buckets
        skipped along the way can never push a value outside its bucket.
        """
        with self._lock:
            if aggregate is not None:
                want = aggregate.items()
                h = None
                for (n, lbls), series in self._histograms.items():
                    if n != name or not (set(want) <= set(lbls)):
                        continue
                    if h is None:
                        h = {
                            "buckets": series["buckets"],
                            "counts": list(series["counts"]),
                            "sum": series["sum"],
                            "count": series["count"],
                        }
                    elif series["buckets"] == h["buckets"]:
                        h["counts"] = [
                            a + b for a, b in zip(h["counts"], series["counts"])
                        ]
                        h["sum"] += series["sum"]
                        h["count"] += series["count"]
            else:
                h = self._histograms.get(self._key(name, labels))
            if h is None or h["count"] == 0:
                return None
            bounds = h["buckets"]
            counts = list(h["counts"])
            total = h["count"]
            out = {"count": total, "sum": h["sum"]}
            for q in quantiles:
                rank = q * total
                cum = 0.0
                value = float(bounds[-1]) if bounds else 0.0
                for i, c in enumerate(counts):
                    prev_cum = cum
                    cum += c
                    if cum >= rank and c > 0:
                        if i >= len(bounds):  # +Inf bucket: clamp to last bound
                            value = float(bounds[-1])
                        else:
                            hi = bounds[i]
                            lo = bounds[i - 1] if i > 0 else 0.0
                            frac = min(1.0, max(0.0, (rank - prev_cum) / c))
                            value = lo + (hi - lo) * frac
                        break
                out[f"p{int(q * 100)}"] = value
            return out

    def total(self, name: str, match: dict | None = None) -> float:
        """Sum a series across label sets (counters/gauges: values sum;
        histograms: observation counts sum). ``match`` filters to label sets
        containing the given items. The PromQL ``sum(name)`` analog for SLO
        ratio targets."""
        want = (match or {}).items()
        out = 0.0
        with self._lock:
            for store in (self._counters, self._gauges):
                for (n, lbls), v in store.items():
                    if n == name and set(want) <= set(lbls):
                        out += v
            for (n, lbls), h in self._histograms.items():
                if n == name and set(want) <= set(lbls):
                    out += h["count"]
        return out

    def peak(self, name: str, match: dict | None = None) -> float:
        """Max of a counter/gauge series across label sets (0.0 when none
        match). For ratio gauges like occupancy fractions, where summing
        per-job series would produce a nonsense >1 value — show the worst."""
        want = (match or {}).items()
        out = 0.0
        with self._lock:
            for store in (self._counters, self._gauges):
                for (n, lbls), v in store.items():
                    if n == name and set(want) <= set(lbls):
                        out = max(out, v)
        return out

    def expose(self) -> str:
        """Prometheus text exposition format."""
        with self._lock:
            lines: list[str] = []
            seen_header = set()

            def header(name: str) -> None:
                if name in seen_header:
                    return
                if name in self._help:
                    lines.append(
                        f"# HELP {name} {_escape_help(self._help[name])}"
                    )
                lines.append(f"# TYPE {name} {self._types.get(name, 'untyped')}")
                seen_header.add(name)

            for store in (self._counters, self._gauges):
                for (name, labels), value in sorted(store.items()):
                    header(name)
                    lines.append(f"{name}{_label_str(labels)} {value}")
            for (name, labels), h in sorted(self._histograms.items()):
                header(name)
                cum = 0
                for le, c in zip(
                    tuple(h["buckets"]) + (math.inf,), h["counts"]
                ):
                    cum += c
                    ls = _label_str(tuple(labels) + (("le", _fmt_le(le)),))
                    lines.append(f"{name}_bucket{ls} {cum}")
                lines.append(f"{name}_sum{_label_str(labels)} {h['sum']}")
                lines.append(f"{name}_count{_label_str(labels)} {h['count']}")
            return "\n".join(lines) + "\n"

    def series(self, name: str) -> list[tuple[dict, float]]:
        """Every label set recorded for ``name`` with its value (counters/
        gauges: the value; histograms: the observation count) — lets the CLI
        enumerate e.g. shed reasons without parsing the exposition."""
        out: list[tuple[dict, float]] = []
        with self._lock:
            for store in (self._counters, self._gauges):
                for (n, lbls), v in store.items():
                    if n == name:
                        out.append((dict(lbls), v))
            for (n, lbls), h in self._histograms.items():
                if n == name:
                    out.append((dict(lbls), float(h["count"])))
        return out

    def value(self, name: str, labels: dict | None = None) -> float:
        """Current value of one series; 0.0 when never written. Counters and
        gauges return their value, histograms their observation count. Lets
        tests and the CLI read series back without parsing the exposition."""
        key = self._key(name, labels)
        with self._lock:
            if key in self._gauges:
                return self._gauges[key]
            if key in self._histograms:
                return float(self._histograms[key]["count"])
            return self._counters.get(key, 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {str(k): v for k, v in self._counters.items()},
                "gauges": {str(k): v for k, v in self._gauges.items()},
                "histograms": {
                    str(k): {"sum": h["sum"], "count": h["count"]}
                    for k, h in self._histograms.items()
                },
            }


#: process-wide default registry
default_registry = Registry()


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<rest>.+)$"
)

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPE_MAP = {"n": "\n", '"': '"', "\\": "\\"}


