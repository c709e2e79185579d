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
import time
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

    def all_series(self) -> list[tuple]:
        """Every series in the registry as ``(name, labels, kind, value,
        hsum)`` tuples: counters/gauges carry their value (``hsum`` 0.0),
        histograms their cumulative observation count with ``hsum`` = the
        cumulative sum — one locked pass, no exposition round trip. The
        time-series sampler's scrape surface (observability/timeseries.py)."""
        out: list[tuple] = []
        with self._lock:
            for (name, lbls), v in self._counters.items():
                out.append((name, dict(lbls), "counter", float(v), 0.0))
            for (name, lbls), v in self._gauges.items():
                out.append((name, dict(lbls), "gauge", float(v), 0.0))
            for (name, lbls), h in self._histograms.items():
                out.append(
                    (name, dict(lbls), "histogram",
                     float(h["count"]), float(h["sum"]))
                )
        return out

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


def push_to_dict(metrics_dict, job: str, registry: Registry | None = None) -> None:
    """Push this process's metrics into a shared Dict — the pushgateway
    pattern for ephemeral containers (each push overwrites the job's slot,
    tagged with a timestamp)."""
    reg = registry or default_registry
    metrics_dict[job] = {"at": time.time(), "metrics": reg.snapshot(),
                         "text": reg.expose()}


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<rest>.+)$"
)

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPE_MAP = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape_label_value(v: str) -> str:
    # one left-to-right pass: sequential .replace() calls corrupt values
    # where an escaped backslash precedes 'n' ('a\\nb' must round-trip to
    # a backslash + 'n', not a newline)
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPE_MAP.get(m.group(1), "\\" + m.group(1)), v
    )


def parse_exposition(text: str) -> Registry:
    """Reconstruct a :class:`Registry` from Prometheus text exposition.

    The inverse of :meth:`Registry.expose` — counters/gauges land as values,
    histogram ``_bucket``/``_sum``/``_count`` child series are de-cumulated
    back into per-bucket counts, so ``histogram_quantiles``/``value``/
    ``total`` work on a *pushed* ``.prom`` file exactly as on the live
    registry (what the CLI's ``top`` and SLO evaluation over pushed jobs need).
    Unparseable lines are skipped; untyped samples read as gauges.
    """
    reg = Registry()
    types: dict[str, str] = {}
    helps: dict[str, str] = {}
    # (name, labels_tuple) -> {"buckets": [(le, cum)], "sum": s, "count": n}
    hists: dict[tuple, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            name, _, t = line[len("# TYPE "):].partition(" ")
            types[name] = t.strip()
            continue
        if line.startswith("# HELP "):
            name, _, h = line[len("# HELP "):].partition(" ")
            helps[name] = h
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name = m.group("name")
        try:
            value = float(m.group("rest").split()[0])
        except (ValueError, IndexError):
            continue
        labels = {
            k: _unescape_label_value(v)
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        }
        base, part = name, None
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[: -len(suffix)]
            if name.endswith(suffix) and types.get(stem) == "histogram":
                base, part = stem, suffix
                break
        if part is not None:
            le = labels.pop("le", None)
            key = (base, tuple(sorted(labels.items())))
            h = hists.setdefault(key, {"buckets": [], "sum": 0.0, "count": 0})
            if part == "_bucket" and le is not None:
                bound = math.inf if le == "+Inf" else float(le)
                h["buckets"].append((bound, value))
            elif part == "_sum":
                h["sum"] = value
            elif part == "_count":
                h["count"] = int(value)
            continue
        if types.get(name) == "counter":
            reg.counter_inc(name, value, labels=labels or None,
                            help=helps.get(name, ""))
        else:
            reg.gauge_set(name, value, labels=labels or None,
                          help=helps.get(name, ""))
    for (name, lbl_t), h in hists.items():
        pairs = sorted(h["buckets"])
        finite = tuple(le for le, _ in pairs if not math.isinf(le))
        counts, prev = [], 0.0
        for _, cum in pairs:
            counts.append(int(cum - prev))
            prev = cum
        if not any(math.isinf(le) for le, _ in pairs):
            counts.append(max(0, h["count"] - int(prev)))  # missing +Inf
        with reg._lock:
            reg._histograms[(name, lbl_t)] = {
                "buckets": finite,
                "counts": counts,
                "sum": h["sum"],
                "count": h["count"] or int(prev),
            }
            reg._types[name] = "histogram"
            if name in helps:
                reg._help[name] = helps[name]
    return reg


def merge_expositions(jobs: dict[str, str]) -> str:
    """Merge per-job exposition texts into ONE valid exposition.

    Each sample gains a ``job`` label (the pushgateway convention), every
    metric name keeps exactly one ``# HELP``/``# TYPE`` header, and no
    non-format comment lines are emitted — duplicate headers and ``# job:``
    banners both violate the text format and break scrapers.
    """
    helps: dict[str, str] = {}
    types: dict[str, str] = {}
    samples: dict[str, list[str]] = {}
    order: list[str] = []

    def base_name(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[: -len(suffix)]
            if name.endswith(suffix) and types.get(stem) in (
                "histogram", "summary"
            ):
                return stem
        return name

    for job, text in sorted(jobs.items()):
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("# HELP "):
                _, _, rest = line.partition("# HELP ")
                name, _, help_text = rest.partition(" ")
                helps.setdefault(name, help_text)
                continue
            if line.startswith("# TYPE "):
                _, _, rest = line.partition("# TYPE ")
                name, _, type_text = rest.partition(" ")
                types.setdefault(name, type_text)
                continue
            if line.startswith("#"):
                continue  # drop free-form comments: not part of the format
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue
            name = m.group("name")
            labels = m.group("labels") or ""
            job_label = f'job="{escape_label_value(job)}"'
            labels = f"{labels},{job_label}" if labels else job_label
            group = base_name(name)
            if group not in samples:
                samples[group] = []
                order.append(group)
            samples[group].append(f"{name}{{{labels}}} {m.group('rest')}")

    lines: list[str] = []
    for group in order:
        if group in helps:
            lines.append(f"# HELP {group} {helps[group]}")
        if group in types:
            lines.append(f"# TYPE {group} {types[group]}")
        lines.extend(samples[group])
    return "\n".join(lines) + ("\n" if lines else "")


def aggregate_exposition(metrics_dict) -> str:
    """Merge all jobs' pushed text expositions (the gateway's /metrics).

    Series from different jobs are distinguished by an added ``job`` label;
    headers are deduplicated so the output is itself a valid exposition.
    """
    jobs = {
        job: payload["text"] for job, payload in sorted(metrics_dict.items())
    }
    return merge_expositions(jobs)
