"""Incident bundles: the flight recorder's capture leg

After ``modal_examples_tpu/observability/incident.py``.
(docs/observability.md#incident-bundles).

When the chip wedges mid-revalidation, the scheduler crash-poisons, a
chaos invariant fails, or an alert rule fires, the evidence is spread
across a dozen live surfaces that die with the process: the tsdb ring,
the journals, the open request traces, the profiler ring, the engine's
watermarks. :func:`capture` snapshots all of them into one
content-addressed directory under ``<state_dir>/incidents/<id>/`` with a
``MANIFEST.json`` naming every file and its sha256 — the bundle IS the
bug report, replayable offline by the CLI's ``incidents show`` long after
the chip was power-cycled.

Triggers (the ``mtpu_incidents_captured_total{trigger}`` label set):

- ``watchdog_wedge`` / ``watchdog_quarantine`` — the gray-failure ladder
  (serving/health.py) captures BEFORE it error-stops the victim, so the
  bundle holds the victim's still-open request traces.
- ``scheduler_crash`` — a strict-mode scheduler-loop exception or a dying
  scheduler thread (serving/engine.py) poisons the engine AND preserves
  the minutes that led up to it.
- ``chaos_invariant`` — a failed fleet invariant (faults/chaos.py).
- ``alert`` — an :class:`~.alerts.AlertRule` with ``capture=True`` at its
  fire transition.
- ``canary_drift`` — the correctness canary (observability/canary.py)
  caught a replica generating tokens that diverge bit-exact from its
  golden transcript; the bundle's reason names the mismatching probe
  request so its trace is findable in the open-trace section.
- ``stage_failure`` — ``benchmarks/revalidate_chip.sh``'s stage wrapper on
  any nonzero exit (the next chip wedge ships a bundle, not a shrug).
- ``manual`` — the CLI's ``incidents capture``.

Bundles are LRU-bounded like the TraceStore (:data:`MAX_INCIDENTS`,
oldest-mtime pruned) and per-(trigger, replica) debounced
(:data:`COOLDOWN_S`) so a wedge storm cannot fill the disk while a
correlated wedge still bundles every victim. Capture never raises — it runs inside
failure paths that must stay on their own recovery ladder.

torch-free and import-light: the read side (the CLI's ``incidents``, the
gateway's ``/incidents``) never touches an engine.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import shutil
import sys
import threading
import time
import weakref
from pathlib import Path

from .._internal import config as _config
from . import metrics as _obs
from . import timeseries as _ts
from .journal import JOURNALS, named_journal

#: the incidents directory name under ``<state_dir>``
DIR_NAME = "incidents"

#: every capture trigger (closed set — the catalog's
#: ``mtpu_incidents_captured_total{trigger}`` labels enumerate it)
TRIGGERS = (
    "watchdog_wedge", "watchdog_quarantine", "scheduler_crash",
    "chaos_invariant", "alert", "canary_drift", "stage_failure", "manual",
)

#: tsdb window a bundle snapshots (the last N minutes before the event)
WINDOW_S = float(os.environ.get("MTPU_INCIDENT_WINDOW_S", 300.0))
#: bundles kept on disk; the oldest is LRU-pruned past this (the
#: TraceStore discipline)
MAX_INCIDENTS = int(os.environ.get("MTPU_INCIDENT_MAX", 16))
#: per-trigger debounce: a wedge storm (every poll re-fires the ladder)
#: must not write a bundle per poll
COOLDOWN_S = 10.0
#: journal records per bundled tail
JOURNAL_TAIL_N = 200
#: open request traces per bundle (a 64-slot engine's full slot sweep
#: would dominate the bundle)
MAX_OPEN_TRACES = 32

_lock = threading.Lock()
#: trigger -> monotonic time of the last capture (the debounce state)
_last_capture: dict[str, float] = {}

# -- live-engine registry (the watermark / impl_plan / open-trace source) ----

#: weak refs so the registry never pins a dead engine (the profiler's
#: registry discipline)
_engines: list = []
_engines_lock = threading.Lock()


def register_engine(engine) -> None:
    """Called by ``LLMEngine.__init__`` — bundles then snapshot every live
    engine's watermarks, impl plan, and open requests without any global
    fleet object existing."""
    with _engines_lock:
        _engines.append(weakref.ref(engine))
        _engines[:] = [r for r in _engines if r() is not None][-64:]


def live_engines() -> list:
    with _engines_lock:
        return [e for e in (r() for r in _engines) if e is not None]


def incidents_dir(root=None) -> Path:
    return Path(root or _config.state_dir()) / DIR_NAME


# -- the section gatherers (each best-effort: a broken surface costs its
#    section, never the bundle) ----------------------------------------------


def _tsdb_section(now: float, window_s: float, root) -> list[dict]:
    records = _ts.read_window(start=now - window_s, end=now + 1.0, root=root)
    if not records:
        # disk writes failing (read-only state dir) or a capture from a
        # process whose sampler never rotated a segment out: the live
        # ring is all there is
        sampler = _ts.global_sampler()
        if sampler is not None:
            records = sampler.recent(window_s)
    return records


def _journal_sections(root) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for name in JOURNALS:
        try:
            recs = named_journal(name, root).tail(JOURNAL_TAIL_N)
        except OSError:
            recs = []
        if recs:
            out[name] = recs
    return out


def _engine_section() -> list[dict]:
    out = []
    for eng in live_engines():
        try:
            snap = {
                "replica": getattr(eng, "trace_name", "engine"),
                "running": bool(getattr(eng, "_running", False)),
                "stopped_on_error": bool(
                    getattr(eng, "_stopped_on_error", False)
                ),
                "impl_plan": _jsonable(getattr(eng, "impl_plan", None)),
                "paged_impl": getattr(eng, "paged_impl", None),
                "scatter_impl": getattr(eng, "scatter_impl", None),
                "decode_block": getattr(eng, "decode_block", None),
                "error_count": getattr(eng, "error_count", 0),
                "error_log_tail": list(getattr(eng, "error_log", ()))[-3:],
            }
            wm = getattr(eng, "watermarks", None)
            if wm is not None:
                snap["watermarks"] = wm.snapshot()
            slots = []
            for i, s in enumerate(getattr(eng, "slots", ())):
                req = s.request
                if req is None:
                    continue
                slots.append({
                    "slot": i,
                    "request_id": getattr(req, "request_id", None),
                    "trace_id": getattr(
                        getattr(req, "trace", None), "trace_id", None
                    ),
                })
            snap["occupied_slots"] = slots
            out.append(snap)
        except Exception:
            continue
    return out


def _open_traces_section(engines: list[dict]) -> dict:
    """The victim's open request traces: every occupied slot's trace id
    across the live engines, with the spans recorded so far (finished
    spans + events — an open span shows up once its parent store flushed
    it; the watchdog marks live traces before the stop sweep exactly so
    this snapshot carries its intervention)."""
    from . import reqtrace as _rt

    ids: list[str] = []
    for snap in engines:
        for slot in snap.get("occupied_slots", ()):
            tid = slot.get("trace_id")
            if tid and tid not in ids:
                ids.append(tid)
    ids = ids[:MAX_OPEN_TRACES]
    traces = {}
    for tid in ids:
        try:
            traces[tid] = _rt.read_trace(tid)
        except Exception:
            traces[tid] = []
    try:
        recent = _rt.list_traces(limit=20)
    except Exception:
        recent = []
    return {"open": traces, "recent": recent}


def _profiler_section() -> list[dict]:
    from . import profiler as _profiler

    out = []
    for p in _profiler.active_profilers():
        try:
            out.append({
                "replica": p.replica,
                "overhead": p.overhead_summary(),
                **p.perfetto_snapshot(),
            })
        except Exception:
            continue
    return out


def _env_section(now: float) -> dict:
    keep = ("MTPU_", "CUDA_", "TORCH_", "PYTORCH_", "NVIDIA_")
    return {
        "at": now,
        "pid": os.getpid(),
        "argv": sys.argv,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "env": {
            k: v
            for k, v in sorted(os.environ.items())
            if k.startswith(keep)
        },
    }


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return repr(obj)


# -- capture ------------------------------------------------------------------


def capture(
    trigger: str,
    *,
    reason: str = "",
    replica: str | None = None,
    root=None,
    registry=None,
    window_s: float | None = None,
    extra: dict | None = None,
    force: bool = False,
) -> Path | None:
    """Snapshot everything into ``<state_dir>/incidents/<id>/``; returns
    the bundle directory, or None (debounced, or the disk refused).

    ``trigger`` must be a :data:`TRIGGERS` member (the catalog closes the
    label set). ``force=True`` skips the debounce (the manual CLI path).
    Never raises — capture runs inside failure paths.
    """
    if trigger not in TRIGGERS:
        raise ValueError(
            f"unknown incident trigger {trigger!r}; one of {TRIGGERS}"
        )
    # debounce per (trigger, replica): a correlated wedge hitting two
    # replicas inside COOLDOWN_S must bundle BOTH victims' open traces —
    # the second error-stop sweeps its slots either way
    key = (trigger, replica)
    now_mono = time.monotonic()
    with _lock:
        last = _last_capture.get(key)
        if not force and last is not None and now_mono - last < COOLDOWN_S:
            return None
        _last_capture[key] = now_mono
    try:
        bundle = _capture_locked(
            trigger, reason, replica, root, registry,
            window_s if window_s is not None else WINDOW_S, extra,
        )
    except Exception:
        bundle = None
    if bundle is None:
        with _lock:  # a failed capture must not consume the debounce slot
            if _last_capture.get(key) == now_mono:
                if last is None:
                    _last_capture.pop(key, None)
                else:
                    _last_capture[key] = last
    return bundle


def _capture_locked(
    trigger, reason, replica, root, registry, window_s, extra
) -> Path | None:
    now = time.time()
    tsdb = _tsdb_section(now, window_s, root)
    journals = _journal_sections(root)
    engines = _engine_section()
    traces = _open_traces_section(engines)
    files: dict[str, str] = {}
    files["tsdb.jsonl"] = "".join(json.dumps(r) + "\n" for r in tsdb)
    for name, recs in journals.items():
        files[f"journal_{name}.jsonl"] = "".join(
            json.dumps(r) + "\n" for r in recs
        )
    files["traces.json"] = json.dumps(traces, indent=1)
    files["engines.json"] = json.dumps(engines, indent=1)
    files["profiler.json"] = json.dumps(_profiler_section(), indent=1)
    files["env.json"] = json.dumps(_env_section(now), indent=1)

    digests = {
        name: {
            "bytes": len(body.encode()),
            "sha256": hashlib.sha256(body.encode()).hexdigest(),
        }
        for name, body in files.items()
    }
    # content address: the id carries a digest over every file's digest,
    # so two bundles with identical evidence collide into the same id
    # instead of duplicating, and a tampered bundle no longer matches
    content = hashlib.sha256(
        json.dumps(digests, sort_keys=True).encode()
    ).hexdigest()[:12]
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(now))
    incident_id = f"inc-{stamp}-{content}"

    manifest = {
        "id": incident_id,
        "at": now,
        "trigger": trigger,
        "reason": reason,
        "replica": replica,
        "window_s": window_s,
        "tsdb_records": len(tsdb),
        "journals": {name: len(recs) for name, recs in journals.items()},
        "open_traces": sorted(traces.get("open", ())),
        "engines": [e.get("replica") for e in engines],
        "files": digests,
        **({"extra": _jsonable(extra)} if extra else {}),
    }

    d = incidents_dir(root)
    bundle = d / incident_id
    try:
        tmp = d / f".{incident_id}.tmp.{os.getpid()}"
        tmp.mkdir(parents=True, exist_ok=True)
        for name, body in files.items():
            (tmp / name).write_text(body)
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
        if bundle.exists():
            shutil.rmtree(tmp, ignore_errors=True)  # identical evidence
        else:
            os.replace(tmp, bundle)
    except OSError:
        return None
    _prune(d)
    _obs.record_incident_captured(trigger, registry=registry)
    return bundle


#: a tmp dir younger than this is a CONCURRENT capture mid-write (two
#: triggers firing together, or revalidate_chip.sh capturing from another
#: process), not an orphan — sweeping it would silently lose that bundle
_TMP_GRACE_S = 120.0


def _prune(d: Path) -> None:
    """LRU-bound the incidents directory (oldest mtime first), and sweep
    orphaned tmp dirs from a capture that died mid-write."""
    try:
        for tmp in d.glob(".inc-*.tmp.*"):
            try:
                if time.time() - tmp.stat().st_mtime < _TMP_GRACE_S:
                    continue
            except OSError:
                continue  # racing its own os.replace/rmtree: leave it
            shutil.rmtree(tmp, ignore_errors=True)
        bundles = sorted(
            (p for p in d.glob("inc-*") if p.is_dir()),
            key=lambda p: p.stat().st_mtime,
        )
        for p in bundles[: max(0, len(bundles) - MAX_INCIDENTS)]:
            shutil.rmtree(p, ignore_errors=True)
    except OSError:
        pass


# -- read surfaces (torch-free: the CLI's `incidents`, the gateway) ----------------


def list_incidents(root=None) -> list[dict]:
    """Every bundle's manifest, newest first."""
    out = []
    try:
        dirs = sorted(incidents_dir(root).glob("inc-*"), reverse=True)
    except OSError:
        return out
    for p in dirs:
        m = _read_json(p / "MANIFEST.json")
        if m is not None:
            out.append(m)
    return out


def read_manifest(incident_id: str, root=None) -> dict | None:
    p = _resolve(incident_id, root)
    return _read_json(p / "MANIFEST.json") if p is not None else None


def read_bundle_file(incident_id: str, name: str, root=None) -> str | None:
    """One bundle file's content. ``name`` must appear in the manifest —
    the manifest whitelists exactly what :func:`capture` wrote, so a
    crafted name can never traverse out of the bundle."""
    p = _resolve(incident_id, root)
    if p is None:
        return None
    manifest = _read_json(p / "MANIFEST.json")
    if manifest is None or name not in manifest.get("files", {}):
        return None
    try:
        return (p / name).read_text()
    except OSError:
        return None


def _resolve(incident_id: str, root=None) -> Path | None:
    """Exact id first, then a unique prefix (the TraceStore.resolve rule);
    rejects anything that isn't a plain ``inc-…`` token."""
    if (
        not incident_id
        or not incident_id.replace("-", "").replace("_", "").isalnum()
    ):
        return None
    d = incidents_dir(root)
    p = d / incident_id
    if p.is_dir():
        return p
    try:
        matches = sorted(x for x in d.glob(f"{incident_id}*") if x.is_dir())
    except OSError:
        return None
    return matches[0] if len(matches) == 1 else None


def _read_json(path: Path) -> dict | None:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
