"""File-backed metrics push gateway for ephemeral processes.

After ``modal_examples_tpu/observability/export.py``.

A scraper can hit a live ``/metrics`` endpoint, but the processes that emit
most series here — app runs, bench children, short CLI invocations — are
gone before any scrape interval fires. The reference solves this with a
Pushgateway app (10_integrations/pushgateway.py); the local analog is a
directory of per-job exposition files under ``<state_dir>/metrics/``:

- each process *pushes* its registry on shutdown (``push_metrics_file``,
  called from ``AppRun.close``), atomically (write + rename);
- the CLI's ``metrics`` *merges* every pushed file into one valid exposition
  (job label per source, deduplicated headers) via
  :func:`modal_examples_tpu_torch.utils.prometheus.merge_expositions`.

Stale jobs age out after ``_PUSH_RETENTION_S``.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

from .._internal import config as _config
from ..utils.prometheus import Registry, default_registry, merge_expositions

_PUSH_RETENTION_S = 7 * 86400


def _metrics_dir(root: str | Path | None = None) -> Path:
    p = Path(root) if root else (_config.state_dir() / "metrics")
    p.mkdir(parents=True, exist_ok=True)
    return p


def _safe_job(job: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_.") else "-" for c in job)


def push_metrics_file(
    job: str,
    registry: Registry | None = None,
    *,
    root: str | Path | None = None,
) -> Path | None:
    """Write this process's exposition to ``<state_dir>/metrics/<job>.prom``
    (atomic replace; each push overwrites the job's slot). Returns the path,
    or None when the registry holds no series (nothing to push — an empty
    file would only add noise to the merge)."""
    reg = registry if registry is not None else default_registry
    text = reg.expose()
    if text.strip() == "":
        return None
    d = _metrics_dir(root)
    path = d / f"{_safe_job(job)}.prom"
    tmp = path.with_suffix(f".tmp.{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, path)
    _gc(d)
    return path


def pushed_jobs(root: str | Path | None = None) -> dict[str, str]:
    """job name -> raw exposition text, one entry per pushed ``.prom`` file."""
    d = _metrics_dir(root)
    jobs: dict[str, str] = {}
    for p in sorted(d.glob("*.prom")):
        try:
            jobs[p.stem] = p.read_text()
        except OSError:
            continue
    return jobs


def read_pushed_metrics(root: str | Path | None = None) -> str:
    """Merge every pushed job file into one exposition (the gateway's
    /metrics view). Empty string when nothing was ever pushed."""
    jobs = pushed_jobs(root)
    if not jobs:
        return ""
    return merge_expositions(jobs)


def live_and_pushed_metrics(
    registry: Registry | None = None,
    *,
    job: str = "live",
    root: str | Path | None = None,
) -> str:
    """One exposition covering this process's live registry (under ``job``)
    plus every previously pushed job file — what a scraper hitting the
    gateway's ``/metrics`` should see."""
    reg = registry if registry is not None else default_registry
    jobs = pushed_jobs(root)
    live = reg.expose()
    if live.strip():
        jobs[job] = live
    if not jobs:
        return ""
    return merge_expositions(jobs)


def _gc(d: Path) -> None:
    cutoff = time.time() - _PUSH_RETENTION_S
    for p in d.glob("*.prom"):
        try:
            if p.stat().st_mtime < cutoff:
                p.unlink()
        except OSError:
            pass


# --------------------------------------------------------------------------
# Perfetto / chrome://tracing export
# --------------------------------------------------------------------------

#: span names recorded by the container worker process (everything nested
#: under them — user spans — is container-side too)
_CONTAINER_SPAN_NAMES = ("execute", "serialize")


#: the counter tracks a tsdb ride-along renders by default — the serving
#: trajectory an incident reader wants next to the spans (a full window
#: export would be hundreds of tracks; pass ``names=`` for more)
TSDB_COUNTER_SERIES = (
    "mtpu_tokens_per_second",
    "mtpu_active_slots",
    "mtpu_waiting_requests",
    "mtpu_kv_page_occupancy",
    "mtpu_host_overhead_ratio",
    "mtpu_generated_tokens_total",
    "mtpu_decode_stall_seconds",
    "mtpu_alerts_active",
)


def tsdb_counter_events(
    records: list[dict],
    names: tuple[str, ...] | None = None,
    *,
    t0: float = 0.0,
    pid: int = 1,
    tid: int = 0,
) -> list[dict]:
    """Chrome-trace counter ("C") events from a tsdb window
    (:func:`~.timeseries.read_window` records): one counter track per
    series name, values folded across label sets per the CLI's ``top``
    rule (gauges take the max — a 0..1 fraction must never sum across
    replicas; counters and histogram counts sum). Timestamps are
    microseconds relative to ``t0`` (wall-clock seconds)."""
    names = TSDB_COUNTER_SERIES if names is None else tuple(names)
    events: list[dict] = []
    for rec in records:
        at = rec.get("at")
        if not isinstance(at, (int, float)):
            continue
        folded: dict[str, float] = {}
        kinds: dict[str, str] = {}
        for entry in rec.get("series", ()):
            try:
                name, _labels, kind, value, _hsum = entry
            except (ValueError, TypeError):
                continue
            if name not in names:
                continue
            kinds[name] = kind
            if name in folded and kind == "gauge":
                folded[name] = max(folded[name], float(value))
            else:
                folded[name] = folded.get(name, 0.0) + float(value)
        for name, value in sorted(folded.items()):
            events.append({
                "ph": "C", "pid": pid, "tid": tid, "cat": "mtpu",
                "name": name,
                "ts": round((at - t0) * 1e6, 3),
                "args": {kinds.get(name, "value"): round(value, 6)},
            })
    return events


def spans_to_chrome_trace(
    spans: list[dict],
    trace_id: str = "",
    profile: dict | None = None,
    tsdb: list[dict] | None = None,
) -> dict:
    """Convert one trace's JSONL spans to Chrome-trace / Perfetto JSON.

    Output is the Trace Event Format object (``{"traceEvents": [...]}``)
    that loads directly in ``chrome://tracing`` and ui.perfetto.dev.
    Complete ("X") events nest by timestamp within a track, instantaneous
    spans (retry markers, fault events) become instant ("i") events.
    Timestamps are microseconds relative to the earliest span.

    Track assignment is REPLICA-AWARE and deterministic: request-scoped
    spans (observability/reqtrace.py) carry a ``replica`` attribute, and
    each distinct replica gets its own named track — tids assigned in
    sorted replica order, so a merged FLEET trace (gateway + prefill
    replica + decode replica stores) renders one track per replica
    instead of interleaving every event onto one. Executor call traces
    (no replica attrs) keep the legacy two-track layout: supervisor-side
    phases (queue/boot/dispatch/retry) on tid 1, container-worker phases
    (execute/serialize + user spans) on tid 2. Migrations additionally get
    span LINKS: a flow arrow from the transfer (or prefill) span on the
    source replica's track to the adopt span on the destination's.

    ``profile`` (hot-path profiler ride-along, docs/observability.md):
    ``{replica: {"ticks": [...], "compiles": [...]}}`` snapshots from
    :meth:`~.profiler.HotPathProfiler.perfetto_snapshot` — tick-phase
    COUNTER tracks ("C" events, one series per phase in milliseconds) and
    compile SLICES ("X" events named ``compile:<program>``) render on the
    owning replica's track; replicas appearing only in the profile get
    their own track after the span replicas, in the same deterministic
    sorted order.

    ``tsdb`` (flight-recorder ride-along, docs/observability.md
    #metrics-history): a :func:`~.timeseries.read_window` record list —
    the window's :data:`TSDB_COUNTER_SERIES` render as counter tracks on
    one dedicated "tsdb" track next to the tick-phase tracks, so the
    serving trajectory (tokens/s, occupancy, overhead ratio) lines up
    under the spans of the request that died inside it.
    """
    import zlib as _zlib

    # tolerate hand-saved --profile files: a record without a numeric
    # wall-clock "at" cannot be placed on the timeline, so it is dropped
    # here instead of KeyError-ing the whole export (every other field is
    # already optional via .get)
    profile = {
        name: {
            "ticks": [
                t for t in (snap or {}).get("ticks", ())
                if isinstance(t, dict)
                and isinstance(t.get("at"), (int, float))
            ],
            "compiles": [
                c for c in (snap or {}).get("compiles", ())
                if isinstance(c, dict)
                and isinstance(c.get("at"), (int, float))
            ],
        }
        for name, snap in (profile or {}).items()
    }
    tsdb = [
        r for r in (tsdb or ())
        if isinstance(r, dict) and isinstance(r.get("at"), (int, float))
    ]
    if not spans and not profile and not tsdb:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    by_id = {s.get("span_id"): s for s in spans}

    def is_container_side(span: dict) -> bool:
        seen = set()
        cur: dict | None = span
        while cur is not None and id(cur) not in seen:
            seen.add(id(cur))
            if cur.get("name") in _CONTAINER_SPAN_NAMES:
                return True
            cur = by_id.get(cur.get("parent_id"))
        return False

    starts = [s.get("start") or 0.0 for s in spans]
    for snap in profile.values():
        starts += [
            t["at"] - (t.get("total") or 0.0) for t in snap.get("ticks", [])
        ]
        starts += [
            c["at"] - (c.get("seconds") or 0.0)
            for c in snap.get("compiles", [])
        ]
    starts += [r["at"] for r in tsdb]
    t0 = min(starts) if starts else 0.0
    replicas = sorted(
        {
            (s.get("attrs") or {}).get("replica")
            for s in spans
            if (s.get("attrs") or {}).get("replica")
        }
        | set(profile)
    )
    events: list[dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": f"mtpu trace {trace_id}".strip()}},
    ]
    if replicas:
        # one track per replica, deterministic: sorted name order
        tid_of_replica = {name: i + 1 for i, name in enumerate(replicas)}
        other_tid = len(replicas) + 1
        for name, tid in tid_of_replica.items():
            events.append(
                {"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                 "args": {"name": name}}
            )

        def tid_for(span: dict) -> int:
            return tid_of_replica.get(
                (span.get("attrs") or {}).get("replica"), other_tid
            )

        if any(tid_for(s) == other_tid for s in spans):
            events.append(
                {"ph": "M", "pid": 1, "tid": other_tid,
                 "name": "thread_name", "args": {"name": "other"}}
            )
    else:
        events += [
            {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
             "args": {"name": "supervisor"}},
            {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name",
             "args": {"name": "container"}},
        ]

        def tid_for(span: dict) -> int:
            return 2 if is_container_side(span) else 1

    for s in sorted(spans, key=lambda s: s.get("start") or 0.0):
        start = s.get("start") or t0
        end = s.get("end")
        args = dict(s.get("attrs") or {})
        args["span_id"] = s.get("span_id")
        if s.get("status") and s["status"] != "ok":
            args["status"] = s["status"]
        ev = {
            "name": s.get("name", "?"),
            "cat": "mtpu",
            "pid": 1,
            "tid": tid_for(s),
            "ts": round((start - t0) * 1e6, 3),
            "args": args,
        }
        dur_us = round(((end if end is not None else start) - start) * 1e6, 3)
        if dur_us <= 0:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant
        else:
            ev["ph"] = "X"
            ev["dur"] = dur_us
        events.append(ev)

    if replicas:
        # span links for migrations: flow arrows source -> destination,
        # binding the k-th transfer (falling back to the k-th prefill) to
        # the k-th adopt — perfetto draws the cross-track arrow
        def of_name(name):
            return sorted(
                (s for s in spans if s.get("name") == name),
                key=lambda s: s.get("start") or 0.0,
            )

        transfers, prefills, adopts = (
            of_name("transfer"), of_name("prefill"), of_name("adopt")
        )
        for k, adopt in enumerate(adopts):
            src = (
                transfers[k]
                if k < len(transfers)
                else (prefills[k] if k < len(prefills) else None)
            )
            if src is None:
                continue
            fid = _zlib.crc32(f"{trace_id}:migration:{k}".encode())
            src_end = src.get("end") or src.get("start") or t0
            events.append(
                {"ph": "s", "id": fid, "pid": 1, "tid": tid_for(src),
                 "ts": round((src_end - t0) * 1e6, 3), "name": "migration",
                 "cat": "mtpu"}
            )
            events.append(
                {"ph": "f", "bp": "e", "id": fid, "pid": 1,
                 "tid": tid_for(adopt),
                 "ts": round(((adopt.get("start") or t0) - t0) * 1e6, 3),
                 "name": "migration", "cat": "mtpu"}
            )

    # hot-path profiler ride-along: tick-phase counter tracks + compile
    # slices on each owning replica's track, deterministic ordering (sorted
    # replicas; ticks/compiles sorted by wall timestamp)
    for replica in sorted(profile):
        snap = profile[replica] or {}
        tid = tid_of_replica.get(replica, other_tid)
        for t in sorted(
            snap.get("ticks", ()), key=lambda t: t.get("at") or 0.0
        ):
            total = t.get("total") or 0.0
            args = {
                phase: round(seconds * 1e3, 6)
                for phase, seconds in sorted(
                    (t.get("phases") or {}).items()
                )
            }
            events.append({
                "ph": "C", "pid": 1, "tid": tid, "cat": "mtpu",
                "name": "tick_phase_ms",
                "ts": round((t["at"] - total - t0) * 1e6, 3),
                "args": args,
            })
        for c in sorted(
            snap.get("compiles", ()), key=lambda c: c.get("at") or 0.0
        ):
            seconds = c.get("seconds") or 0.0
            events.append({
                "ph": "X", "pid": 1, "tid": tid, "cat": "mtpu",
                "name": f"compile:{c.get('program', '?')}",
                "ts": round((c["at"] - seconds - t0) * 1e6, 3),
                "dur": round(seconds * 1e6, 3),
                "args": {"shape_key": c.get("shape_key")},
            })
    if tsdb:
        # the flight-recorder trajectory on its own dedicated track,
        # after every replica track (legacy layout uses tids 1/2)
        tsdb_tid = (len(replicas) + 2) if replicas else 3
        events.append(
            {"ph": "M", "pid": 1, "tid": tsdb_tid, "name": "thread_name",
             "args": {"name": "tsdb"}}
        )
        events += tsdb_counter_events(tsdb, t0=t0, pid=1, tid=tsdb_tid)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": trace_id, "epoch_start_s": t0},
    }


def export_chrome_trace(
    trace_id: str,
    out_path: str | Path | None = None,
    *,
    store=None,
) -> dict | None:
    """Read one trace from the (default) TraceStore and convert it; when
    ``out_path`` is given the JSON is also written there. Returns the trace
    dict, or None when no such trace exists."""
    import json

    if store is None:
        from .trace import default_store as store  # noqa: F811
    spans = store.read(trace_id)
    if not spans:
        return None
    doc = spans_to_chrome_trace(spans, trace_id)
    if out_path is not None:
        Path(out_path).write_text(json.dumps(doc, indent=1))
    return doc
