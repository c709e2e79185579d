"""The bounded JSONL journal, after ``modal_examples_tpu/observability/journal.py``.

The port writes the JAX package's nine journals under the state directory:
the executor autoscaler's decisions (``scaler.jsonl``), the kernel builds
(``compiles.jsonl``), alert fire/clear transitions (``alerts.jsonl``), the
usage meter's per-request billing lines (``usage.jsonl``), the canary's
probe results (``canary.jsonl``), the watchdog's ladder decisions
(``watchdog.jsonl``), the fleet autoscaler's decisions (``fleet.jsonl``),
the chaos runner's episodes (``chaos.jsonl``) and the shared prefix store's
lease takeovers and GC sweeps (``prefix_store.jsonl``). :data:`JOURNALS`
owns the name -> file mapping and :func:`named_journal` resolves it.

Records are plain dicts, one JSON object per line, kept in a bounded
in-memory ring and appended to the file. The file is bounded: past
``_MAX_FILE_RECORDS`` lines it is rewritten atomically keeping the newest
half.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path

from .._internal import config as _config

#: in-memory ring-buffer capacity (per journal instance)
RING_CAPACITY = 512
#: JSONL file bound: rewrite keeping the newest half past this many lines
_MAX_FILE_RECORDS = 4096

#: every journal the port writes: name -> file under ``<state_dir>``
JOURNALS: dict[str, str] = {
    "scaler": "scaler.jsonl",  # executor autoscaler (core/executor.py)
    "compiles": "compiles.jsonl",  # kernel builds (ops/_build.py)
    "alerts": "alerts.jsonl",  # alert fire/clear (observability/alerts.py)
    "usage": "usage.jsonl",  # per-request usage records (observability/usage.py)
    "canary": "canary.jsonl",  # golden-set probe results (observability/canary.py)
    "watchdog": "watchdog.jsonl",  # gray-failure ladder (serving/health.py)
    "fleet": "fleet.jsonl",  # fleet autoscaler (fleet/autoscaler.py)
    "chaos": "chaos.jsonl",  # chaos episodes (faults/chaos.py)
    # shared prefix store: lease takeovers and GC sweeps (serving/prefix_store/)
    "prefix_store": "prefix_store.jsonl",
}


def journal_path(name: str, root=None) -> Path:
    """The JSONL path for a named journal — ``<root or state_dir>/<file>``.
    ``name`` must be a :data:`JOURNALS` key."""
    return Path(root or _config.state_dir()) / JOURNALS[name]


def named_journal(name: str, root=None, *, path=None) -> "DecisionJournal":
    """Resolve a named journal. ``path`` (an explicit file) wins over
    ``root`` (an alternate state dir); with neither, the state dir resolves
    at first use, so a journal built early still honors a later
    ``MTPU_STATE_DIR``."""
    if name not in JOURNALS:
        raise KeyError(f"unknown journal {name!r}; one of {sorted(JOURNALS)}")
    if path is not None:
        return DecisionJournal(path, name=name)
    if root is not None:
        return DecisionJournal(journal_path(name, root), name=name)
    return DecisionJournal(name=name)


def make_record(
    *,
    function: str,
    action: str,
    trigger: str,
    queue_depth: int = 0,
    inflight: int = 0,
    free_slots: int = 0,
    containers_before: int = 0,
    containers_after: int = 0,
    idle_ages: list[float] | None = None,
    **extra,
) -> dict:
    """One autoscaler record. ``action`` is what the autoscaler did
    (``scale_up`` | ``scale_down`` | ``kill``), ``trigger`` why
    (``queue_pressure`` | ``min_containers`` | ``idle`` | ``single_use_spent``
    | ``timeout``)."""
    rec = {
        "at": time.time(),
        "function": function,
        "action": action,
        "trigger": trigger,
        "queue_depth": queue_depth,
        "inflight": inflight,
        "free_slots": free_slots,
        "containers_before": containers_before,
        "containers_after": containers_after,
    }
    if idle_ages:
        rec["idle_ages_s"] = [round(a, 3) for a in idle_ages]
    rec.update(extra)
    return rec


class DecisionJournal:
    """Ring buffer + JSONL sink for one named journal's records; built
    through :func:`named_journal`."""

    def __init__(self, path: str | Path | None = None, *, name: str):
        self._path = Path(path) if path else None
        self._name = name
        self._resolved: Path | None = None
        self._ring: deque[dict] = deque(maxlen=RING_CAPACITY)
        self._lock = threading.Lock()
        self._appended = 0

    @property
    def path(self) -> Path:
        if self._resolved is None:
            p = self._path or journal_path(self._name)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._resolved = p
        return self._resolved

    def record(self, rec: dict) -> None:
        """Append one record (never raises — the journal runs inside the
        scheduler tick)."""
        line = json.dumps(rec)
        with self._lock:
            self._ring.append(rec)
            try:
                with open(self.path, "a") as f:
                    f.write(line + "\n")
                self._appended += 1
                if self._appended >= 256:
                    self._appended = 0
                    self._compact_locked()
            except OSError:
                pass

    def _compact_locked(self) -> None:
        """Bound the JSONL file: keep the newest half once past the cap."""
        try:
            lines = self.path.read_text().splitlines()
        except OSError:
            return
        if len(lines) <= _MAX_FILE_RECORDS:
            return
        keep = lines[-_MAX_FILE_RECORDS // 2 :]
        tmp = self.path.with_suffix(f".tmp.{os.getpid()}")
        try:
            tmp.write_text("\n".join(keep) + "\n")
            os.replace(tmp, self.path)
        except OSError:
            pass

    def tail(
        self, n: int = 50, *, function: str | None = None
    ) -> list[dict]:
        """Newest-last slice of the journal. The JSONL file holds every
        record, so it is the primary source; the ring covers a state dir
        whose file writes fail."""
        recs = self._read_file()
        with self._lock:
            ring = list(self._ring)
        if len(recs) < len(ring):
            recs = ring  # file writes failing: the ring is all we have
        if function is not None:
            recs = [r for r in recs if r.get("function") == function]
        return recs[-n:]

    def _read_file(self) -> list[dict]:
        try:
            text = self.path.read_text()
        except OSError:
            return []
        out = []
        for line in text.splitlines():
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return out


#: process-wide journal of the executor autoscaler's decisions (state-dir
#: backed), read back by the gateway's ``/autoscaler`` route
default_journal = named_journal("scaler")
