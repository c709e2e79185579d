"""Spans and the JSONL trace store, after ``modal_examples_tpu/observability/trace.py``.

The request tracer (:mod:`.reqtrace`) records its spans here: one JSONL
file per trace under ``<state_dir>/traces/`` (or a ``TraceStore``'s own
root), one JSON object per span. Span timestamps are wall-clock
(``time.time()``). ``MTPU_TRACE=0`` disables tracing entirely. The JAX
package's call-lifecycle context (the executor's ambient trace) comes with
the executor.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
import uuid
from pathlib import Path

from .._internal import config as _config

#: traces are retained this long (mirrors the spawned-call record retention)
_TRACE_RETENTION_S = 7 * 86400


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


#: hard bounds on the traces directory — age alone is not enough on a
#: long-running gateway (a week of traffic is unbounded files); LRU-deleted
#: oldest-first past either cap
_MAX_TRACE_FILES = _env_int("MTPU_TRACE_MAX_FILES", 2000)
_MAX_TRACE_BYTES = _env_int("MTPU_TRACE_MAX_BYTES", 256 * 1024 * 1024)


def tracing_enabled() -> bool:
    return os.environ.get("MTPU_TRACE", "1") not in ("0", "false", "off")


def _new_span_id() -> str:
    return f"sp-{uuid.uuid4().hex[:12]}"


@dataclasses.dataclass
class Span:
    """One timed phase of a call. ``finish()`` stamps the end and returns the
    duration; recording (JSONL write or cross-process shipping) is the
    caller's job via :class:`TraceStore` or a child-side buffer."""

    trace_id: str
    name: str
    span_id: str = dataclasses.field(default_factory=_new_span_id)
    parent_id: str | None = None
    start: float = dataclasses.field(default_factory=time.time)
    end: float | None = None
    status: str = "ok"
    attrs: dict = dataclasses.field(default_factory=dict)

    def finish(self, status: str = "ok", **attrs) -> float:
        if self.end is None:
            self.end = time.time()
        self.status = status
        if attrs:
            self.attrs.update(attrs)
        return self.duration

    @property
    def duration(self) -> float:
        return max(0.0, (self.end or time.time()) - self.start)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "status": self.status,
            "attrs": self.attrs,
        }


class TraceStore:
    """Per-trace JSONL files under ``<state_dir>/traces/``.

    Only *finished* spans are recorded; an abandoned span (e.g. a dispatch
    span whose container vanished without a death notification) simply never
    appears, it can't corrupt the file. Writes are append-only and
    line-atomic, so a concurrent ``tpurun trace`` reader sees a valid prefix.
    """

    def __init__(self, root: str | Path | None = None):
        self._root = Path(root) if root else None
        self._resolved: Path | None = None  # root after its one-time mkdir
        self._lock = threading.Lock()
        self._last_gc = 0.0

    @property
    def root(self) -> Path:
        if self._resolved is None:
            root = self._root or (_config.state_dir() / "traces")
            root.mkdir(parents=True, exist_ok=True)
            self._resolved = root
        return self._resolved

    def record(self, span: "Span | dict") -> None:
        d = span.to_dict() if isinstance(span, Span) else dict(span)
        if d.get("end") is None:
            d["end"] = time.time()
        path = self.root / f"{d['trace_id']}.jsonl"
        line = json.dumps(d) + "\n"
        with self._lock:
            try:
                with open(path, "a") as f:
                    f.write(line)
            except FileNotFoundError:
                # traces dir deleted out from under us: re-create and retry
                # (record runs in the result-delivery path — never raise)
                self._resolved = None
                try:
                    with open(self.root / path.name, "a") as f:
                        f.write(line)
                except OSError:
                    pass
        self._maybe_gc()

    def read(self, trace_id: str) -> list[dict]:
        path = self.root / f"{trace_id}.jsonl"
        if not path.exists():
            return []
        spans = []
        for line in path.read_text().splitlines():
            if not line.strip():
                continue
            try:
                spans.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line from a concurrent writer
        return spans

    #: the only shape a trace id can have (both namespaces); resolve()
    #: rejects anything else up front — the token reaches Path/glob, so a
    #: separator or glob metachar must mean "no such trace", not a
    #: traversal or an unhandled pattern error
    _ID_TOKEN_RE = re.compile(r"^[A-Za-z0-9._-]+$")

    def resolve(self, token: str) -> str | None:
        """Resolve ``token`` to a stored trace id: exact match first, then
        a UNIQUE prefix. Both id namespaces live in one store — executor
        calls (``in-…``) and serving requests (``req-…``) — so ``tpurun
        trace``/``explain`` take either kind, abbreviated."""
        if not token or not self._ID_TOKEN_RE.match(token):
            return None
        if (self.root / f"{token}.jsonl").exists():
            return token
        matches = sorted(p.stem for p in self.root.glob(f"{token}*.jsonl"))
        return matches[0] if len(matches) == 1 else None

    def _maybe_gc(self) -> None:
        now = time.monotonic()
        with self._lock:
            if now - self._last_gc < 300:
                return
            self._last_gc = now
        # the sweep globs+stats the whole trace dir — run it off-thread so a
        # recording thread (often the container reader delivering a result)
        # never stalls on it
        threading.Thread(target=self._gc_sweep, daemon=True).start()

    def _gc_sweep(self) -> None:
        """Age out old traces, then enforce the count/byte caps LRU-first
        (oldest mtime deleted first) so a long-running gateway's traces
        directory stays bounded no matter the traffic rate."""
        cutoff = time.time() - _TRACE_RETENTION_S
        survivors: list[tuple[float, int, Path]] = []  # (mtime, size, path)
        for p in self.root.glob("*.jsonl"):
            try:
                st = p.stat()
                if st.st_mtime < cutoff:
                    p.unlink()
                else:
                    survivors.append((st.st_mtime, st.st_size, p))
            except OSError:
                pass
        survivors.sort()  # oldest first
        total = sum(size for _, size, _ in survivors)
        excess = len(survivors) - _MAX_TRACE_FILES
        for mtime, size, p in survivors:
            if excess <= 0 and total <= _MAX_TRACE_BYTES:
                break
            try:
                p.unlink()
            except OSError:
                continue
            excess -= 1
            total -= size


#: process-wide default store (state-dir backed)
default_store = TraceStore()
