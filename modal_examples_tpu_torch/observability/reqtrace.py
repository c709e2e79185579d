"""Request-scoped tracing, after ``modal_examples_tpu/observability/reqtrace.py``.

A :class:`RequestTraceContext` is minted ONCE at the entry point (the
OpenAI server, or a bare ``engine.make_request``) and rides ON the request
object: explicit propagation, because a request's spans are opened and
closed from the submitting thread and the engine's scheduler thread. The
trace id IS the request id (``req-…``), the same rule the executor tracer
uses for calls (``in-…``): the CLI's ``trace`` and ``explain`` resolve
either namespace from the same :class:`~.trace.TraceStore`. Span names and
attribute keys are cataloged (:data:`~.catalog.SPAN_CATALOG`). Sampling
(``MTPU_TRACE_SAMPLE``, deterministic per request id) and the
``MTPU_TRACE=0`` switch keep the hot path near zero cost when tracing is
off: an unsampled request carries ``trace=None`` and every helper here is a
None-safe no-op.

Fault firings (:mod:`...faults.inject`) become span events on the affected
request through the thread-ambient frame (:func:`active` /
:func:`note_fault`). Reads merge one trace id across every registered
store (:func:`read_trace`, :func:`list_traces`, :func:`resolve`), and
:func:`explain_lines` renders a merged trace as a lifecycle narrative.

A context that never records a span leaves no file behind. One that did
is closed by :func:`finish_request`, which sweeps any still-open spans
with the terminal status before recording the root, so an abort or a
scheduler error never leaks a dangling span. :func:`wire` and
:func:`from_wire` carry a context across the disaggregated-serving hop in
the MTKV1 envelope's meta (``serving/disagg/``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid

from ..utils.determinism import unit_float
from . import catalog as _C
from .trace import Span, TraceStore, default_store, tracing_enabled

#: the root span every request trace starts with (catalog-declared)
ROOT_SPAN = "request"

#: default for ``trace=`` kwargs down the submit chain: distinguishes "no
#: entry point minted yet — mint here" (UNSET) from "the entry point
#: already DECIDED and this request is untraced" (None). Without the
#: sentinel every layer would re-roll the sampling decision on a fresh id,
#: inflating the effective sample rate and splitting attribution.
UNSET = object()


def resolve_entry_trace(trace, entry: str, store=None):
    """The one rule every submit layer applies to its ``trace=`` kwarg:
    pass an upstream value through verbatim (including an explicit None —
    the upstream mint sampled the request OUT), mint only when no
    upstream entry point ran (``UNSET``)."""
    if trace is not UNSET:
        return trace
    return start_request_trace(entry=entry, store=store)

#: id-namespace prefixes: serving requests vs executor calls
REQUEST_PREFIX = "req-"
CALL_PREFIX = "in-"


def new_request_id() -> str:
    return f"{REQUEST_PREFIX}{uuid.uuid4().hex[:12]}"


def trace_kind(trace_id: str) -> str:
    """Which id namespace a trace id belongs to: ``request`` (serving,
    ``req-…``), ``call`` (executor, ``in-…``), or ``unknown``."""
    tid = str(trace_id)
    if tid.startswith(REQUEST_PREFIX):
        return "request"
    if tid.startswith(CALL_PREFIX):
        return "call"
    return "unknown"


def sample_rate() -> float:
    """``MTPU_TRACE_SAMPLE`` as a clamped fraction (default 1.0 — every
    request traced; 0 disables request tracing without touching the
    executor call tracer)."""
    raw = os.environ.get("MTPU_TRACE_SAMPLE", "")
    if not raw:
        return 1.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 1.0


def sampled(request_id: str) -> bool:
    """Deterministic per-request sampling decision: hashed from the request
    id alone, so every replica/process that sees this id — including one
    that reconstructs the context :func:`from_wire` — agrees without
    coordination."""
    rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return unit_float("mtpu-trace-sample", request_id) < rate


class RequestTraceContext:
    """Identity + open-span registry for one traced request.

    The context itself is tiny: the trace id, the (still-open) root span,
    the minting store, and the set of spans currently open. Recording is
    done by the module helpers, which take the RECORDER's store — each
    replica writes its own spans to its own :class:`TraceStore`, and
    :func:`read_trace` stitches them back by trace id.
    """

    __slots__ = ("trace_id", "root", "store", "owns_root", "_lock", "_open",
                 "_done")

    def __init__(
        self,
        trace_id: str,
        root: Span,
        store: TraceStore,
        *,
        owns_root: bool = True,
    ):
        self.trace_id = trace_id
        self.root = root
        self.store = store
        #: False for wire-reconstructed contexts: the minting process owns
        #: (and records) the root span; this side only parents under it
        self.owns_root = owns_root
        self._lock = threading.Lock()
        self._open: dict[str, Span] = {}
        self._done = False

    @property
    def done(self) -> bool:
        return self._done

    def open_spans(self) -> list[str]:
        """Names of spans begun but not yet finished (test surface: the
        no-dangling-span invariant asserts this drains to [])."""
        with self._lock:
            return [sp.name for sp in self._open.values()]


def start_request_trace(
    request_id: str | None = None,
    *,
    entry: str = "api",
    store: TraceStore | None = None,
    **attrs,
) -> RequestTraceContext | None:
    """Mint the trace for one serving request at its entry point.

    Returns None when tracing is disabled (``MTPU_TRACE=0``) or the id is
    sampled out — callers thread the None through and every helper no-ops.
    When ``request_id`` is None a fresh ``req-…`` id is generated; the
    engine's ``make_request`` then ADOPTS it as the request id, so trace
    id == request id holds fleet-wide.
    """
    if not tracing_enabled():
        return None
    rid = request_id or new_request_id()
    if not sampled(rid):
        return None
    root = Span(
        trace_id=rid,
        name=ROOT_SPAN,
        attrs={"request_id": rid, "replica": entry, **attrs},
    )
    return RequestTraceContext(rid, root, store or default_store)


# --------------------------------------------------------------------------
# span helpers — all None-safe so untraced requests cost one `is None`
# --------------------------------------------------------------------------


def begin(
    ctx: RequestTraceContext | None,
    name: str,
    *,
    parent: str | None = None,
    **attrs,
) -> Span | None:
    """Open a span (recorded only when :func:`finish` closes it). The span
    registers as OPEN on the context so a crash path's sweep can close it."""
    if ctx is None:
        return None
    sp = Span(
        trace_id=ctx.trace_id,
        name=name,
        parent_id=parent or ctx.root.span_id,
        attrs=attrs,
    )
    with ctx._lock:
        # _done re-checked UNDER the lock: a span registered after the
        # terminal sweep cleared _open would dangle forever (the race is
        # real — the scheduler thread closes roots while the migration
        # thread opens spans)
        if ctx._done:
            return None
        ctx._open[sp.span_id] = sp
    return sp


def finish(
    ctx: RequestTraceContext | None,
    span: Span | None,
    status: str = "ok",
    *,
    store: TraceStore | None = None,
    **attrs,
) -> None:
    """Close + record a :func:`begin`-opened span. Idempotent: a span that
    was already closed (e.g. by the terminal sweep) is left alone, so
    failure paths may finish defensively."""
    if ctx is None or span is None:
        return
    with ctx._lock:
        if ctx._open.pop(span.span_id, None) is None:
            return
    span.finish(status, **attrs)
    (store or ctx.store).record(span)


def record_span(
    ctx: RequestTraceContext | None,
    name: str,
    *,
    start: float,
    end: float | None = None,
    status: str = "ok",
    parent: str | None = None,
    store: TraceStore | None = None,
    **attrs,
) -> Span | None:
    """Record a completed span post-hoc (wall-clock ``start``/``end``) —
    for phases whose boundaries are known only after the fact."""
    if ctx is None or ctx._done:
        return None
    sp = Span(
        trace_id=ctx.trace_id,
        name=name,
        parent_id=parent or ctx.root.span_id,
        start=start,
        attrs=attrs,
    )
    sp.end = end if end is not None else time.time()
    sp.status = status
    (store or ctx.store).record(sp)
    return sp


def event(
    ctx: RequestTraceContext | None,
    name: str,
    *,
    parent: str | None = None,
    store: TraceStore | None = None,
    **attrs,
) -> None:
    """Record an instantaneous span (start == end): fault firings, retry
    waits, sheds — the Perfetto export renders these as instant events."""
    if ctx is None or ctx._done:
        return
    now = time.time()
    record_span(
        ctx, name, start=now, end=now, parent=parent, store=store, **attrs
    )


def finish_root(
    ctx: RequestTraceContext | None,
    status: str = "ok",
    *,
    store: TraceStore | None = None,
    **attrs,
) -> None:
    """Terminal close: sweep every still-open span with ``status``, then
    finish + record the root (when this side owns it). Idempotent — the
    first terminal path wins, later ones no-op — which is what makes 'no
    dangling span, no double root' structural rather than per-call-site."""
    if ctx is None:
        return
    with ctx._lock:
        if ctx._done:
            return
        ctx._done = True
        leftovers = list(ctx._open.values())
        ctx._open.clear()
    st = store or ctx.store
    for sp in leftovers:
        sp.finish(status)
        st.record(sp)
    if ctx.owns_root:
        ctx.root.finish(status, **attrs)
        st.record(ctx.root)


def finish_request(req, reason: str, *, store: TraceStore | None = None) -> None:
    """Close a request's trace from its terminal stream marker: normal
    finishes (``stop``/``length``) close ok, everything else
    (``error``/``deadline``/…) closes with that status. Safe to call on
    untraced requests and to call twice."""
    ctx = getattr(req, "trace", None)
    if ctx is None:
        return
    status = "ok" if reason in ("stop", "length") else reason
    finish_root(
        ctx,
        status,
        store=store,
        finish_reason=reason,
        n_generated=int(getattr(req, "n_generated", 0) or 0),
    )


# --------------------------------------------------------------------------
# the disagg hop: trace context on the MTKV1 wire
# --------------------------------------------------------------------------


def wire(ctx: RequestTraceContext | None, *, parent: str | None = None) -> dict | None:
    """The trace context as a JSON-safe dict for the MTKV1 envelope's
    ``meta``: the trace id and the span a decode replica in another process
    parents under."""
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "parent_id": parent or ctx.root.span_id}


def from_wire(d: dict | None, *, store: TraceStore | None = None) -> RequestTraceContext | None:
    """Reconstruct a context from :func:`wire` on the receiving replica. It
    does not own the root (the minting process records it); its spans parent
    under the wire's ``parent_id`` and land in this side's store, and
    :func:`read_trace` merges the stores back into one tree."""
    if not d or not tracing_enabled():
        return None
    tid = str(d.get("trace_id") or "")
    # the wire is untrusted input and the trace id becomes a file name under
    # the store root: it must look like a request id
    if not tid.startswith(REQUEST_PREFIX) or not TraceStore._ID_TOKEN_RE.match(tid):
        return None
    root = Span(trace_id=tid, name=ROOT_SPAN)
    if d.get("parent_id"):
        root.span_id = d["parent_id"]
    return RequestTraceContext(tid, root, store or default_store, owns_root=False)


# --------------------------------------------------------------------------
# thread-ambient frame: fault firings / retry waits attach to the request
# whose operation is running on this thread
# --------------------------------------------------------------------------

_tl = threading.local()


@contextlib.contextmanager
def active(
    ctx: RequestTraceContext | None,
    *,
    parent: str | None = None,
    replica: str | None = None,
):
    """Scope ``ctx`` as this THREAD's ambient request: code that has no
    request in hand (the fault gate, the transfer loop) records events
    through :func:`note_fault` / :func:`ambient_event` onto whatever
    request the thread is currently working for. ``ctx=None`` scopes an
    EMPTY frame — an unsampled request must not inherit an outer one."""
    prev = getattr(_tl, "frame", None)
    _tl.frame = (ctx, parent, replica) if ctx is not None else None
    try:
        yield
    finally:
        _tl.frame = prev


def _frame():
    return getattr(_tl, "frame", None)


def current() -> RequestTraceContext | None:
    fr = _frame()
    return fr[0] if fr is not None else None


def begin_ambient(name: str, **attrs) -> Span | None:
    fr = _frame()
    if fr is None:
        return None
    ctx, parent, replica = fr
    if replica is not None:
        attrs.setdefault("replica", replica)
    return begin(ctx, name, parent=parent, **attrs)


def finish_ambient(span: Span | None, status: str = "ok", **attrs) -> None:
    fr = _frame()
    if fr is None or span is None:
        return
    finish(fr[0], span, status, **attrs)


def ambient_event(name: str, **attrs) -> None:
    fr = _frame()
    if fr is None:
        return
    ctx, parent, replica = fr
    if replica is not None:
        attrs.setdefault("replica", replica)
    event(ctx, name, parent=parent, **attrs)


def note_fault(point: str) -> None:
    """Called by :func:`...faults.inject.fire` ONLY when a fault actually
    fires (the disabled gate never reaches here): the firing becomes a
    ``fault`` event on the ambient request's trace, so a chaos episode's
    injections are visible per-request on the fleet timeline."""
    fr = _frame()
    if fr is None:
        return
    ctx, parent, replica = fr
    kw = {"replica": replica} if replica is not None else {}
    event(ctx, "fault", parent=parent, point=point, **kw)


# --------------------------------------------------------------------------
# multi-store reads: one trace id, N replica stores
# --------------------------------------------------------------------------

_MAX_EXTRA_STORES = 16
_extra_stores: list[TraceStore] = []
_extra_lock = threading.Lock()


def register_store(store: TraceStore | None) -> None:
    """Make a per-replica store visible to merged reads in THIS process
    (the gateway's ``/traces/<id>`` and the CLI's ``explain`` run over every
    registered store plus the default). Bounded; duplicates ignored."""
    if store is None or store is default_store:
        return
    with _extra_lock:
        if any(s is store for s in _extra_stores):
            return
        _extra_stores.append(store)
        del _extra_stores[:-_MAX_EXTRA_STORES]


def known_stores() -> list[TraceStore]:
    with _extra_lock:
        return [default_store, *_extra_stores]


def read_trace(
    trace_id: str, stores: list[TraceStore] | None = None
) -> list[dict]:
    """One trace id's spans merged across stores (deduped by span id,
    sorted by start) — prefill-replica, transfer, and decode-replica spans
    stitch back into the single tree the trace id names."""
    seen: set = set()
    out: list[dict] = []
    for st in stores if stores is not None else known_stores():
        for s in st.read(trace_id):
            sid = s.get("span_id")
            if sid in seen:
                continue
            seen.add(sid)
            out.append(s)
    out.sort(key=lambda s: (s.get("start") or 0.0))
    return out


def list_traces(
    limit: int = 50, stores: list[TraceStore] | None = None
) -> list[str]:
    """Most recently active trace ids merged across stores (newest first,
    deduped) — the index view matching what :func:`read_trace` can serve:
    a request whose spans live only in a per-replica store must still
    appear in the gateway's ``/traces`` listing."""
    entries: list[tuple[float, str]] = []
    for st in stores if stores is not None else known_stores():
        try:
            for p in st.root.glob("*.jsonl"):
                entries.append((p.stat().st_mtime, p.stem))
        except OSError:
            continue
    entries.sort(reverse=True)
    seen: set = set()
    out: list[str] = []
    for _, tid in entries:
        if tid in seen:
            continue
        seen.add(tid)
        out.append(tid)
        if len(out) >= limit:
            break
    return out


def resolve(
    token: str, stores: list[TraceStore] | None = None
) -> str | None:
    """Resolve a full or unique-prefix trace id across stores — either id
    namespace (``in-…`` executor calls, ``req-…`` serving requests)."""
    for st in stores if stores is not None else known_stores():
        hit = st.resolve(token)
        if hit is not None:
            return hit
    return None


# --------------------------------------------------------------------------
# the CLI's `explain`: merged span tree -> lifecycle narrative
# --------------------------------------------------------------------------


def _ms(x: float) -> float:
    return (x or 0.0) * 1000.0


def _dur_ms(s: dict) -> float:
    start = s.get("start") or 0.0
    return _ms(max(0.0, (s.get("end") or start) - start))


def explain_lines(spans: list[dict], trace_id: str) -> list[str]:
    """Render a merged request trace as a human-readable lifecycle
    narrative (the CLI's ``explain``); executor call traces get a one-line
    summary pointing at the phase-tree renderer instead."""
    if not spans:
        return [f"no spans recorded for {trace_id}"]
    kind = trace_kind(trace_id)
    by_name: dict[str, list[dict]] = {}
    for s in spans:
        by_name.setdefault(s.get("name", "?"), []).append(s)
    t0 = min(s.get("start") or 0.0 for s in spans)

    def attr(s, key, default="-"):
        return (s.get("attrs") or {}).get(key, default)

    if kind == "call" or (
        # no request root and the span names look like the executor
        # tracer's (catalog.CALL_SPAN_NAMES): an unprefixed/legacy id
        # still renders as a call trace ("queue" exists in both
        # namespaces, so a req-… id never takes this branch)
        kind != "request"
        and ROOT_SPAN not in by_name
        and set(by_name) & _C.CALL_SPAN_NAMES
    ):
        lines = [
            f"{trace_id}: executor call trace ({len(spans)} spans) — "
            f"`python -m modal_examples_tpu_torch trace {trace_id}` renders the phase tree"
        ]
        for s in sorted(spans, key=lambda s: s.get("start") or 0.0):
            mark = "" if s.get("status") == "ok" else f" [{s.get('status')}]"
            lines.append(
                f"  +{_ms((s.get('start') or 0.0) - t0):>8.1f}ms  "
                f"{s.get('name', '?'):<12} {_dur_ms(s):>9.1f}ms{mark}"
            )
        return lines

    root = (by_name.get(ROOT_SPAN) or [None])[0]
    rattrs = (root or {}).get("attrs") or {}
    reason = rattrs.get("finish_reason", "?")
    header = f"request {trace_id}: serving request trace"
    if root is not None:
        header += (
            f" — {reason} in {_dur_ms(root):.1f}ms"
            f" (entry {rattrs.get('replica', '?')}"
        )
        if "priority" in rattrs:
            header += f", class={rattrs['priority']}"
        if "tenant" in rattrs:
            header += f", tenant={rattrs['tenant']}"
        header += ")"
    lines = [header]

    chunks = by_name.get("chunk", [])
    spec_events = by_name.get("spec_verify", [])
    for s in sorted(spans, key=lambda s: (s.get("start") or 0.0)):
        name = s.get("name", "?")
        if name in (ROOT_SPAN, "chunk", "spec_verify"):
            continue
        if name == "queue":
            text = (
                f"queued {_dur_ms(s):.1f}ms "
                f"(class={attr(s, 'priority')}, replica {attr(s, 'replica')})"
            )
        elif name == "placement":
            pre = attr(s, "prefill_replica")
            if pre != "-":
                text = (
                    f"placed: prefill={pre} "
                    f"decode={attr(s, 'decode_replica')}"
                )
            else:
                text = (
                    f"placed on {attr(s, 'decode_replica', attr(s, 'replica'))}"
                    f" (route={attr(s, 'route')})"
                )
        elif name == "prefill":
            chunked = attr(s, "chunked", False) is True
            sliced = attr(s, "sliced", False) is True
            detail = ""
            if chunked:
                detail = f", chunked x{attr(s, 'chunks', '?')}"
                if sliced:
                    detail += f" sliced (budget {attr(s, 'budget', '?')})"
            text = (
                f"prefill on {attr(s, 'replica')} {_dur_ms(s):.1f}ms "
                f"({attr(s, 'n_prompt', '?')} prompt tokens{detail})"
            )
        elif name == "prefill_wait":
            text = (
                f"prefill sliced over {attr(s, 'ticks', '?')} ticks "
                f"({attr(s, 'chunks', '?')} chunks interleaved with decode, "
                f"{_dur_ms(s):.1f}ms residency)"
            )
        elif name == "migrate":
            text = (
                f"migrated {attr(s, 'pages', '?')} pages "
                f"{attr(s, 'source')} -> {attr(s, 'target')} "
                f"{_dur_ms(s):.1f}ms ({attr(s, 'result', s.get('status'))})"
            )
        elif name == "transfer":
            n_chunks = attr(s, "chunks", None) or len(
                [c for c in chunks if c.get("parent_id") == s.get("span_id")]
            )
            text = (
                f"transfer {attr(s, 'wire_bytes', '?')} bytes in "
                f"{n_chunks} chunks {_dur_ms(s):.1f}ms"
            )
        elif name == "adopt":
            text = (
                f"adopted {attr(s, 'pages', '?')} pages on "
                f"{attr(s, 'replica')} {_dur_ms(s):.2f}ms"
            )
        elif name == "decode":
            ttft = rattrs.get("ttft_s")
            text = f"decode on {attr(s, 'replica')} {_dur_ms(s):.1f}ms"
            if ttft is not None:
                text += f": TTFT {_ms(ttft):.1f}ms"
            text += (
                f", {rattrs.get('n_generated', '?')} tokens, finish={reason}"
            )
        elif name == "fault":
            text = (
                f"fault injected: {attr(s, 'point')} "
                f"(replica {attr(s, 'replica')})"
            )
        elif name == "retry_wait":
            text = (
                f"transfer retry round {attr(s, 'round')}: "
                f"{attr(s, 'pending')} chunks pending, "
                f"{attr(s, 'delay_s')}s backoff"
            )
        elif name == "shed":
            text = f"shed by admission ({attr(s, 'reason')})"
        elif name == "tier_promote":
            text = (
                f"prefix tier promote: {attr(s, 'pages')} pages from "
                f"{attr(s, 'tier')}"
            )
        else:
            extras = " ".join(
                f"{k}={v}" for k, v in (s.get("attrs") or {}).items()
            )
            text = f"{name} {_dur_ms(s):.1f}ms {extras}".rstrip()
        mark = "" if s.get("status") in ("ok", None) else f" [{s.get('status')}]"
        lines.append(
            f"  +{_ms((s.get('start') or 0.0) - t0):>8.1f}ms  {text}{mark}"
        )
    if spec_events:
        proposed = sum(int(attr(s, "proposed", 0) or 0) for s in spec_events)
        accepted = sum(int(attr(s, "accepted", 0) or 0) for s in spec_events)
        lines.append(
            f"  spec verify: {len(spec_events)} ticks, "
            f"{accepted}/{proposed} draft tokens accepted"
        )
    return lines


#: catalog cross-check convenience (the static guard imports the catalog
#: directly; this keeps the two modules' views trivially identical)
ALL_SPAN_NAMES = _C.ALL_SPAN_NAMES
