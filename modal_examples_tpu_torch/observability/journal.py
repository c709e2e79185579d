"""The bounded JSONL journal, after ``modal_examples_tpu/observability/journal.py``.

The port writes one journal, the usage meter's per-request billing lines
(``usage.jsonl`` under the state directory). :data:`JOURNALS` owns the
name -> file mapping and :func:`named_journal` resolves it; the JAX
package's other journals (autoscaler, fleet, watchdog, chaos, compiles,
alerts, prefix store, canary) come with the subsystems that write them.

Records are plain dicts, one JSON object per line, kept in a bounded
in-memory ring and appended to the file. The file is bounded: past
``_MAX_FILE_RECORDS`` lines it is rewritten atomically keeping the newest
half.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from pathlib import Path

from .._internal import config as _config

#: in-memory ring-buffer capacity (per journal instance)
RING_CAPACITY = 512
#: JSONL file bound: rewrite keeping the newest half past this many lines
_MAX_FILE_RECORDS = 4096

#: every journal the port writes: name -> file under ``<state_dir>``
JOURNALS: dict[str, str] = {
    "usage": "usage.jsonl",  # per-request usage records (observability/usage.py)
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
