"""Request-scoped tracing, after ``modal_examples_tpu/observability/reqtrace.py``.

A :class:`RequestTraceContext` is minted ONCE at the entry point (the
OpenAI server, or a bare ``engine.make_request``) and rides ON the request
object: explicit propagation, because a request's spans are opened and
closed from the submitting thread and the engine's scheduler thread. The
trace id IS the request id (``req-…``). Span names and attribute keys are
cataloged (:data:`~.catalog.SPAN_CATALOG`). Sampling (``MTPU_TRACE_SAMPLE``,
deterministic per request id) and the ``MTPU_TRACE=0`` switch keep the hot
path near zero cost when tracing is off: an unsampled request carries
``trace=None`` and every helper here is a None-safe no-op.

A context that never records a span leaves no file behind. One that did
is closed by :func:`finish_request`, which sweeps any still-open spans
with the terminal status before recording the root, so an abort or a
scheduler error never leaks a dangling span.

The JAX package's fleet paths (the disaggregated-serving wire, the ambient
frame that fault injection records into, merged reads over several
replicas' stores, ``tpurun explain``) come with those subsystems.
"""

from __future__ import annotations

import os
import threading
import time
import uuid

from ..utils.determinism import unit_float
from .trace import Span, TraceStore, default_store, tracing_enabled

#: the root span every request trace starts with (catalog-declared)
ROOT_SPAN = "request"

#: default for ``trace=`` kwargs down the submit chain: distinguishes "no
#: entry point minted yet — mint here" (UNSET) from "the entry point
#: already DECIDED and this request is untraced" (None). Without the
#: sentinel every layer would re-roll the sampling decision on a fresh id,
#: inflating the effective sample rate and splitting attribution.
UNSET = object()


#: the id namespace of serving requests
REQUEST_PREFIX = "req-"


def new_request_id() -> str:
    return f"{REQUEST_PREFIX}{uuid.uuid4().hex[:12]}"


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
