"""Metrics history: the flight recorder's time-series leg

After ``modal_examples_tpu/observability/timeseries.py``.
(docs/observability.md#metrics-history).

Every observability surface before this PR was point-in-time: the registry
holds the CURRENT gauge/histogram state, journals hold per-subsystem
decisions, and the event that matters most — a chip wedging mid-run — left
no artifact of the minutes leading up to it. This module is the black box:
a background :class:`TsdbSampler` scrapes the in-process
:class:`~..utils.prometheus.Registry` every ``MTPU_TS_INTERVAL`` seconds
(default 1 s) into a bounded on-disk segment ring under
``<state_dir>/tsdb/`` — append-only JSONL segments plus a tiny
``index.json`` — so latency-vs-load *trajectories* survive the process
that produced them and a later the CLI's ``tsdb`` / incident bundle can
replay them offline.

**Zero-cost when off** (the ``MTPU_PROFILE`` rule): ``LLMEngine.__init__``
resolves ``MTPU_TSDB`` ONCE and only then starts the process-wide sampler
thread — nothing on the scheduler hot path either way; the sampler's whole
cost is one locked registry pass per interval, and that cost is itself
recorded (``mtpu_tsdb_scrape_seconds``) so "does the flight recorder cost
anything?" is answerable from the recorder.

On-disk shape: one JSON object per scrape, ``{"at": wall_seconds,
"series": [[name, labels, kind, value, hsum], ...]}`` — counters/gauges
carry their value, histograms their cumulative count with ``hsum`` the
cumulative sum, so ``rate()`` over the window recovers both event rates
and per-second time spent. Segments rotate at
:data:`SEGMENT_MAX_RECORDS` records and the ring keeps the newest
:data:`MAX_SEGMENTS` (LRU prune, the TraceStore discipline).

torch-free and import-light: the read side (the CLI's ``tsdb``, incident
bundles, the alert evaluator) never touches an engine.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path

from .._internal import config as _config
from . import metrics as _obs

#: the one env switch (resolved once per process, like MTPU_PROFILE):
#: unset/0 = off — bench children and the chaos harness opt in
TSDB_ENV = "MTPU_TSDB"
#: scrape interval in seconds (float); default 1.0
INTERVAL_ENV = "MTPU_TS_INTERVAL"
#: the tsdb directory name under ``<state_dir>``
DIR_NAME = "tsdb"

#: records per segment before rotation (at the 1 s default interval one
#: segment is ~8.5 minutes of history)
SEGMENT_MAX_RECORDS = int(os.environ.get("MTPU_TSDB_SEGMENT_RECORDS", 512))
#: segments kept on disk; the oldest is LRU-pruned past this
MAX_SEGMENTS = int(os.environ.get("MTPU_TSDB_MAX_SEGMENTS", 16))
#: scrape records kept in memory (the alert evaluator's window source —
#: rule evaluation must not re-read disk every second)
RING_RECORDS = 600
#: a segment this recently written that THIS sampler did not create is a
#: concurrent writer's active segment (two MTPU_TSDB=1 processes sharing
#: one state dir) — unlinking it would silently drop its newest samples
SEGMENT_PRUNE_GRACE_S = 60.0


def sampling_enabled(explicit=None) -> bool:
    """Resolve the tsdb switch ONCE: explicit arg beats :data:`TSDB_ENV`
    beats off (the MTPU_PROFILE rule — the env is never re-read on a hot
    path)."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(TSDB_ENV, "") not in ("", "0")


def default_interval() -> float:
    raw = os.environ.get(INTERVAL_ENV, "")
    try:
        return max(0.05, float(raw)) if raw else 1.0
    except ValueError:
        return 1.0


def tsdb_dir(root=None) -> Path:
    """The segment directory — ``<root or state_dir>/tsdb``."""
    return Path(root or _config.state_dir()) / DIR_NAME


class TsdbSampler:
    """Background registry scraper writing the on-disk segment ring.

    ``clock`` is an injectable monotonic clock (fake-clock tests drive
    :meth:`sample_once` directly); record timestamps are wall-clock
    (``time.time()``) so windows align with journal records and trace
    spans. ``evaluate_alerts=True`` lazily attaches an
    :class:`~.alerts.AlertEvaluator` over the in-memory ring, so any
    process running the sampler also evaluates the starter rule set — no
    second thread, no second scrape.
    """

    def __init__(
        self,
        *,
        registry=None,
        root=None,
        interval: float | None = None,
        clock=None,
        evaluate_alerts: bool = True,
        segment_records: int = SEGMENT_MAX_RECORDS,
        max_segments: int = MAX_SEGMENTS,
    ):
        from ..utils.prometheus import default_registry

        self._registry = registry if registry is not None else default_registry
        self._root = root
        self._resolved: Path | None = None
        self.interval = interval if interval is not None else default_interval()
        self._clock = clock or time.monotonic
        self._segment_records = max(1, int(segment_records))
        self._max_segments = max(1, int(max_segments))
        self._lock = threading.Lock()
        self.ring: deque[dict] = deque(maxlen=RING_RECORDS)
        self._seg_path: Path | None = None
        self._seg_count = 0
        self._seg_seq = 0
        self._own_segs: list[Path] = []
        self._samples = 0
        self._evaluator = None
        if evaluate_alerts:
            from .alerts import AlertEvaluator

            self._evaluator = AlertEvaluator(
                source=self, registry=self._registry, root=root
            )
        self._running = False
        self._thread: threading.Thread | None = None

    @property
    def root(self) -> Path:
        if self._resolved is None:
            d = tsdb_dir(self._root)
            d.mkdir(parents=True, exist_ok=True)
            self._resolved = d
        return self._resolved

    @property
    def evaluator(self):
        return self._evaluator

    # -- one scrape ----------------------------------------------------------

    def sample_once(self) -> dict:
        """Scrape the registry into one record: append it to the current
        segment (rotating/pruning as needed), the in-memory ring, and the
        sampler's own telemetry; then evaluate the attached alert rules.
        Never raises — the sampler thread must survive a read-only disk."""
        t0 = self._clock()
        series = self._registry.all_series()
        rec = {
            "at": time.time(),
            "series": [
                [name, labels, kind, value, hsum]
                for name, labels, kind, value, hsum in series
            ],
        }
        with self._lock:
            self.ring.append(rec)
            self._samples += 1
            try:
                self._append_locked(rec)
            except OSError:
                pass
        _obs.record_tsdb_sample(
            len(series), max(0.0, self._clock() - t0), registry=self._registry
        )
        if self._evaluator is not None:
            self._evaluator.evaluate_once()
        return rec

    def _append_locked(self, rec: dict) -> None:
        rotated = (
            self._seg_path is None or self._seg_count >= self._segment_records
        )
        if rotated:
            self._rotate_locked()
        with open(self._seg_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._seg_count += 1
        # index writes ride rotations (plus stop()), AFTER the new
        # segment's first append so the glob sees it — rewriting the index
        # on every 1 s scrape was a glob+write+replace under the sampler
        # lock that recent()/the gateway block on, for a file whose
        # segment list only changes on rotation
        if rotated:
            self._write_index_locked(rec["at"])

    def _rotate_locked(self) -> None:
        """Open a fresh segment and prune the oldest past the ring bound.
        Segment names are ``seg-<epoch_ms>-<seq>.jsonl`` — lexicographic
        sort IS chronological sort, and the per-process seq disambiguates
        two rotations inside one millisecond."""
        first = self._seg_path is None
        self._seg_seq += 1
        self._seg_path = (
            self.root / f"seg-{int(time.time() * 1000):013d}-{self._seg_seq:04d}.jsonl"
        )
        self._seg_count = 0
        self._own_segs.append(self._seg_path)
        self._own_segs = self._own_segs[-(self._max_segments + 4):]
        segs = sorted(self.root.glob("seg-*.jsonl"))
        own = set(self._own_segs)
        for p in segs[: max(0, len(segs) + 1 - self._max_segments)]:
            try:
                # own segments prune unconditionally (the hard ring bound);
                # a foreign segment gets a recency grace — it may be a
                # concurrent writer's ACTIVE segment
                if (
                    p not in own
                    and time.time() - p.stat().st_mtime < SEGMENT_PRUNE_GRACE_S
                ):
                    continue
                p.unlink()
            except OSError:
                pass
        if not first:
            _obs.record_tsdb_rotation(registry=self._registry)

    def _write_index_locked(self, last_at: float) -> None:
        """A tiny index next to the segments: enough for a reader to know
        the window on disk without parsing every line, accurate as of the
        last rotation (or :meth:`stop`). Best-effort and rewritten in
        place — a torn index never corrupts the segments."""
        try:
            segs = sorted(p.name for p in self.root.glob("seg-*.jsonl"))
            tmp = self.root / f".index.tmp.{os.getpid()}"
            tmp.write_text(json.dumps({
                "segments": segs,
                "last_at": last_at,
                "samples": self._samples,
            }))
            os.replace(tmp, self.root / "index.json")
        except OSError:
            pass

    # -- read surfaces -------------------------------------------------------

    def recent(self, window_s: float | None = None) -> list[dict]:
        """Newest-last ring slice covering the trailing ``window_s``
        wall-clock seconds (None = the whole ring) — the alert evaluator's
        source: no disk read on the evaluation path."""
        with self._lock:
            recs = list(self.ring)
        if window_s is None or not recs:
            return recs
        lo = recs[-1]["at"] - window_s
        return [r for r in recs if r["at"] >= lo]

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "TsdbSampler":
        if self._running:
            return self

        self._running = True

        def loop():
            while self._running:
                try:
                    self.sample_once()
                except Exception:  # never kill the recorder
                    pass
                time.sleep(self.interval)

        self._thread = threading.Thread(
            target=loop, name="tsdb-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            if self.ring:  # final index: last_at/samples exact at shutdown
                self._write_index_locked(self.ring[-1]["at"])


# -- the process-wide sampler (the MTPU_TSDB=1 singleton) ---------------------

_sampler_lock = threading.Lock()
_sampler: TsdbSampler | None = None


def ensure_sampler(
    registry=None, *, interval: float | None = None
) -> TsdbSampler | None:
    """Start the process-wide sampler once (idempotent); returns None when
    :func:`sampling_enabled` says off. ``LLMEngine.__init__`` calls this
    under its resolved-once gate, so any process that builds an engine with
    ``MTPU_TSDB=1`` records history without further wiring."""
    global _sampler
    if not sampling_enabled():
        return None
    with _sampler_lock:
        if _sampler is None:
            _sampler = TsdbSampler(registry=registry, interval=interval).start()
        return _sampler


def global_sampler() -> TsdbSampler | None:
    return _sampler


def stop_sampler() -> None:
    """Stop and forget the process-wide sampler (test isolation)."""
    global _sampler
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


# -- offline reads (torch-free: the CLI's `tsdb`, incident bundles) ----------------


def read_window(
    start: float | None = None,
    end: float | None = None,
    *,
    root=None,
    limit: int | None = None,
) -> list[dict]:
    """Scrape records with ``start <= at <= end`` merged across segments,
    oldest first. ``limit`` keeps the NEWEST n records (an incident bundle
    wants the minutes before the event, not the whole ring)."""
    d = tsdb_dir(root)
    out: list[dict] = []
    try:
        segs = sorted(d.glob("seg-*.jsonl"))
    except OSError:
        return out
    for p in segs:
        try:
            text = p.read_text()
        except OSError:
            continue
        for line in text.splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line from the live writer
            at = rec.get("at")
            if not isinstance(at, (int, float)):
                continue
            if start is not None and at < start:
                continue
            if end is not None and at > end:
                continue
            out.append(rec)
    out.sort(key=lambda r: r["at"])
    return out[-limit:] if limit else out


def read_latest(root=None) -> dict | None:
    """The newest scrape record, reading only the newest segment
    (segment names sort chronologically) — the CLI's ``metrics --watch``
    refresh; re-parsing the whole ring every second to display one sample
    would burn a core on the operator's box mid-incident."""
    d = tsdb_dir(root)
    try:
        segs = sorted(d.glob("seg-*.jsonl"), reverse=True)
    except OSError:
        return None
    for p in segs:
        try:
            lines = p.read_text().splitlines()
        except OSError:
            continue
        for line in reversed(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line from the live writer
            if isinstance(rec.get("at"), (int, float)):
                return rec
    return None


def series_names(records: list[dict]) -> list[str]:
    """Distinct series names across the records, sorted."""
    names = set()
    for rec in records:
        for entry in rec.get("series", ()):
            names.add(entry[0])
    return sorted(names)


def _labels_match(stored: dict, want: dict | None) -> bool:
    if not want:
        return True
    return all(stored.get(k) == v for k, v in want.items())


def series_points(
    name: str,
    records: list[dict],
    *,
    labels: dict | None = None,
    agg: str | None = None,
    field: str = "value",
) -> list[tuple[float, float]]:
    """``(at, value)`` points for one series over the records. ``labels``
    is a subset match; multiple matching label sets fold per record by
    ``agg`` (``sum`` for counters/counts, ``max`` for 0..1 gauges — a
    fraction must never sum across replicas, the CLI's ``top`` rule).
    ``agg=None`` picks by the stored series kind: gauges fold by max,
    everything else sums. ``field="sum"`` reads a histogram's cumulative
    sum instead of its count (seconds spent, not events seen)."""
    idx = 4 if field == "sum" else 3
    out: list[tuple[float, float]] = []
    for rec in records:
        vals = []
        fold_max = agg == "max"
        for entry in rec.get("series", ()):
            if entry[0] == name and _labels_match(entry[1], labels):
                vals.append(entry[idx])
                if agg is None and entry[2] == "gauge":
                    fold_max = True
        if vals:
            out.append(
                (rec["at"], max(vals) if fold_max else sum(vals))
            )
    return out


def rate(points: list[tuple[float, float]]) -> float | None:
    """Per-second increase over the points, counter-reset aware: negative
    deltas (a process restart zeroed the counter) contribute the new
    absolute value, the prometheus ``rate()`` convention. None with fewer
    than two points or zero elapsed time."""
    if len(points) < 2:
        return None
    elapsed = points[-1][0] - points[0][0]
    if elapsed <= 0:
        return None
    total = 0.0
    for (_, prev), (_, cur) in zip(points, points[1:]):
        total += (cur - prev) if cur >= prev else cur
    return total / elapsed
