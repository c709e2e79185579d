"""In-flight request failover: decode checkpoints, live KV migration and
token-identical stream resumption, a copy of
``modal_examples_tpu/serving/failover.py``.

A :class:`DecodeCheckpoint` holds everything needed to resume a running
request; two paths use it:

- **proactive live migration** (:func:`migrate_request` /
  :func:`drain_replica`): the source engine extracts the request's KV pages
  mid-decode on its scheduler thread (``LLMEngine.migrate_out``) and ships
  them through the MTKV1 chunked codec with a **decode-state leg**
  (``meta["resume"]``: accepted tokens and the emitted-text cursor); the
  target reserves admission headroom before any byte moves, then adopts
  mid-decode through ``submit_adopted``.
- **reactive failover** (:func:`resume_request` /
  :func:`stream_with_failover`): when a replica dies (a health flip, a
  scheduler crash, a mid-transfer ``TransportError``) the checkpoint alone
  is enough: the target re-prefills the ORIGINAL prompt, replays the
  generated prefix teacher-forced through the decode block body
  (``LLMEngine.submit_resumed``), and feeds the last accepted token at its
  original position.

**The exactness contract.** Sampling is keyed ``(seed, position)``; the
engine-assigned ``auto_seed`` rides the checkpoint, the next token is
sampled at the position the uninterrupted run would have used, and the
rebuilt prefix KV is the decode-written KV bit for bit (the prompt through
the prefill, the generated prefix through the same decode body at the same
batch width), so the resumed stream is token-identical. Emission resumes at
the checkpoint's text cursor and :func:`stream_with_failover` clips any
overlap: zero duplicated characters. Both paths keep the SAME request object
(same id, same out_queue, same trace id), so a blocked ``stream()``
consumer continues across the takeover.
"""

from __future__ import annotations

import time

from ..observability import metrics as _obs
from ..observability import reqtrace as _rt
from ..scheduling.admission import ShedError
from ..scheduling.policy import ScheduledRequest
from ..utils.log import get_logger
from .disagg.transport import (
    DEFAULT_CHUNK_BYTES,
    LoopbackChannel,
    TransferAborted,
    deserialize_block,
    serialize_block,
    transfer,
)

_log = get_logger("failover")

#: reactive takeovers per request before the error is surfaced honestly
DEFAULT_MAX_FAILOVERS = 2


class DecodeCheckpoint:
    """Everything needed to resume one running request on another replica.

    Built from the request object alone (:func:`checkpoint_request`) — the
    request carries its own accepted-token history and emitted-text cursor
    (``Request.generated_tokens`` / ``.emitted_len``), so a checkpoint can
    be taken *after* the owning replica died and its slot was recycled.
    ``prompt_tokens`` is always the ORIGINAL prompt (a resumed request's
    working ``prompt_tokens`` include the replayed prefix)."""

    __slots__ = (
        "request_id", "prompt", "prompt_tokens", "generated", "params",
        "auto_seed", "priority", "tenant", "deadline", "emitted_len",
    )

    def __init__(
        self, *, request_id, prompt, prompt_tokens, generated, params,
        auto_seed, priority, tenant, deadline, emitted_len,
    ):
        self.request_id = request_id
        self.prompt = prompt
        self.prompt_tokens = [int(t) for t in prompt_tokens]
        self.generated = [int(t) for t in generated]
        self.params = params
        self.auto_seed = auto_seed
        self.priority = priority
        self.tenant = tenant
        self.deadline = deadline
        self.emitted_len = int(emitted_len)

    @property
    def position(self) -> int:
        """Sequence position of the last accepted token (-1 + prompt len
        when nothing was generated yet)."""
        return len(self.prompt_tokens) + len(self.generated) - 1

    @property
    def tokens_replayed(self) -> int:
        """Generated-prefix tokens a reactive resume must re-prefill."""
        return max(0, len(self.generated) - 1)


def checkpoint_request(req) -> DecodeCheckpoint:
    """Snapshot ``req``'s resumable state. Safe after the owning replica
    died (the request object is the source of truth); on a live replica
    the scheduler may still be appending — use ``LLMEngine.migrate_out``
    for a consistent mid-decode extraction instead.

    Under the macro-step decode runtime (docs/multistep.md) this stays
    exact while a slot holds an in-flight N-step dispatch: the harvest
    plane appends only device-validated tokens to
    ``req.generated_tokens``, so a checkpoint taken mid-macro-step
    contains exactly the committed prefix — the un-harvested tail is
    discarded with the in-flight block and re-decoded on resume, and
    sampling's (seed, position) keying makes the re-decode identical."""
    base = getattr(req, "_orig_prompt_tokens", None)
    if base is None:
        base = req.prompt_tokens or []
    return DecodeCheckpoint(
        request_id=req.request_id,
        prompt=req.prompt,
        prompt_tokens=base,
        generated=list(req.generated_tokens),
        params=req.params,
        auto_seed=req.auto_seed,
        priority=req.priority,
        tenant=req.tenant,
        deadline=req.deadline,
        emitted_len=req.emitted_len,
    )


def checkpoint_from_block(block, req) -> DecodeCheckpoint:
    """Checkpoint recovered from an extracted MTKV1 block's decode-state
    leg — the reactive fallback when a live migration fails after
    extraction (the block's meta is the scheduler-thread-consistent record;
    the request object may not have been updated since)."""
    resume = block.meta.get("resume") or {}
    return DecodeCheckpoint(
        request_id=block.meta.get("request_id", req.request_id),
        prompt=req.prompt,
        prompt_tokens=block.meta.get("prompt_tokens") or req.prompt_tokens,
        generated=resume.get("generated", []),
        params=req.params,
        auto_seed=block.meta.get("auto_seed", req.auto_seed),
        priority=req.priority,
        tenant=req.tenant,
        deadline=req.deadline,
        emitted_len=resume.get("emitted_len", 0),
    )


def _reopen_trace(req):
    """A terminally-closed trace context (the dead replica's release path
    recorded the root with status=error) reopened as a NON-owning context
    on the same trace id: the resumed legs keep stitching onto the same
    timeline without minting a second root (the PR-9 no-dup-root rule)."""
    ctx = req.trace
    if ctx is None or not getattr(ctx, "done", False):
        return ctx
    reopened = _rt.from_wire(
        {"trace_id": ctx.trace_id, "parent_id": ctx.root.span_id},
        store=ctx.store,
    )
    return reopened if reopened is not None else ctx


def _finish_marker(reason: str):
    from .engine import _Finish

    return _Finish(reason)


def resume_request(
    req,
    target,
    *,
    checkpoint: DecodeCheckpoint | None = None,
    source: str = "?",
    t_detect: float | None = None,
) -> bool:
    """Reactive failover: resubmit ``req`` from its decode checkpoint onto
    ``target`` (an ``EngineReplica``). Returns True when the resumed
    request was accepted — the caller keeps draining the SAME out_queue.
    False (target shed it / refused) leaves the request terminal; the
    caller surfaces the original error honestly."""
    t0 = t_detect if t_detect is not None else time.monotonic()
    ckpt = checkpoint if checkpoint is not None else checkpoint_request(req)
    req.trace = _reopen_trace(req)
    # opened BEFORE the resubmission: a resume with nothing left to decode
    # terminates inside submit_resumed, and the terminal sweep then closes
    # this span WITH the takeover on record (a post-hoc record would no-op
    # against the already-closed context)
    sp = _rt.begin(
        req.trace, "failover", replica="fleet", mode="reactive",
        source=source, target=target.name, position=ckpt.position,
        tokens_replayed=ckpt.tokens_replayed,
    )
    try:
        target.engine.submit_resumed(
            req,
            prompt_tokens=ckpt.prompt_tokens,
            generated=ckpt.generated,
            emitted_len=ckpt.emitted_len,
        )
    except (ShedError, ValueError, RuntimeError) as e:
        _log.warning(
            "failover of %s -> %s refused (%s: %s)",
            req.request_id, target.name, type(e).__name__, e,
        )
        _obs.record_failover("reactive", "failed")
        _rt.finish(req.trace, sp, status="error", result="failed")
        return False
    req._router_replica = target
    _obs.record_failover(
        "reactive", "ok", tokens_replayed=ckpt.tokens_replayed
    )
    _obs.record_failover_takeover(time.monotonic() - t0)
    _rt.finish(req.trace, sp, result="ok")
    return True


def migrate_request(
    source,
    target,
    req,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    max_rounds: int = 3,
    channel_factory=None,
) -> str:
    """Proactive live migration of one request from ``source`` to
    ``target`` (both ``EngineReplica``): reserve-then-extract-then-adopt.
    Returns ``"ok"`` (adopted mid-decode), ``"resumed"`` (reactive resume
    after a requeue/wire failure — still zero client-visible errors),
    ``"aborted"`` (client abort / deadline during the migration; honest
    terminal marker delivered), ``"gone"`` (nothing to move), or
    ``"failed"`` (target shed the reservation AND the resume; the request
    stays wherever it was).

    Admission pages are reserved on the target BEFORE any byte moves (the
    PR-6 rule: a shed is an honest refusal, never a half-migrated
    request); abort/deadline trips between chunks release the reservation
    and the victim's pages on both sides."""
    eng_t = target.engine
    t0 = time.monotonic()
    t_wall = time.time()
    entry = ScheduledRequest(
        payload=req,
        priority=req.priority,
        tenant=req.tenant,
        cost=eng_t.request_cost(req),
        deadline=req.deadline,
        enqueued_at=eng_t._clock(),
    )
    occ = eng_t.cache.occupancy()
    try:
        eng_t.admission.admit(
            entry,
            depths=eng_t.policy.depths(),
            pages_used=occ["pages_used"],
            pages_total=occ["pages_total"],
        )
    except ShedError:
        _obs.record_live_migration("failed")
        _rt.record_span(
            req.trace, "failover", start=t_wall, status="error",
            replica="fleet", mode="migrate", source=source.name,
            target=target.name, result="failed",
        )
        return "failed"
    try:
        kind, block = source.engine.migrate_out(req)
    except Exception as e:
        # the victim's scheduler is dead or unresponsive: its release path
        # (or the stream-level reactive failover) owns this request now —
        # a second resubmission here would double-deliver the stream
        eng_t.admission.release(entry)
        _log.warning(
            "migrate_out of %s from %s failed (%s: %s); leaving it to the "
            "reactive path", req.request_id, source.name,
            type(e).__name__, e,
        )
        _obs.record_live_migration("failed")
        return "failed"
    if kind == "gone":
        eng_t.admission.release(entry)
        return "gone"
    if kind == "requeue":
        # queued or mid-prefill: nothing decoded, nothing to ship — a
        # fresh resubmission on the target is token-identical
        eng_t.admission.release(entry)
        ok = resume_request(
            req, target, source=source.name, t_detect=t0
        )
        return "resumed" if ok else "failed"

    def should_abort() -> bool:
        if req.aborted:
            return True
        if req.deadline is not None and eng_t._clock() >= req.deadline:
            req.deadline_expired = True
            return True
        return False

    sp = _rt.begin(
        req.trace, "failover", replica="fleet", mode="migrate",
        source=source.name, target=target.name,
    )
    try:
        with _rt.active(
            req.trace,
            parent=sp.span_id if sp is not None else None,
            replica="fleet",
        ):
            payload = serialize_block(block)
            wire = transfer(
                payload,
                (channel_factory or LoopbackChannel)(),
                transfer_id=req.request_id,
                chunk_bytes=chunk_bytes,
                max_rounds=max_rounds,
                should_abort=should_abort,
            )
            if should_abort():
                raise TransferAborted(req.request_id)
            eng_t.submit_adopted(req, entry, deserialize_block(wire))
        req._router_replica = target
        tokens = len(block.meta.get("resume", {}).get("generated", []))
        _obs.record_live_migration("ok", tokens=tokens)
        _obs.record_live_migration_seconds(time.monotonic() - t0)
        _obs.record_failover_takeover(time.monotonic() - t0)
        _rt.finish(
            req.trace, sp,
            position=int(block.meta.get("position", -1)),
            tokens_replayed=0, result="ok",
        )
        return "ok"
    except TransferAborted:
        eng_t.admission.release(entry)
        _obs.record_live_migration("aborted")
        if req.deadline_expired:
            _obs.record_deadline_miss("migrating")
        reason = "deadline" if req.deadline_expired else "stop"
        _rt.finish(req.trace, sp, status="aborted", result="aborted")
        _rt.finish_request(req, reason)
        req.out_queue.put(_finish_marker(reason))
        return "aborted"
    except Exception as e:
        # wire corruption beyond retry, adopt failure: the victim already
        # released its pages, but the block's decode-state leg is a full
        # checkpoint — fall back to the reactive re-prefill resume
        eng_t.admission.release(entry)
        _log.warning(
            "live migration of %s (%s -> %s) failed (%s: %s); reactive "
            "resume", req.request_id, source.name, target.name,
            type(e).__name__, e,
        )
        _rt.finish(req.trace, sp, status="error", result="fallback")
        ok = resume_request(
            req, target, checkpoint=checkpoint_from_block(block, req),
            source=source.name, t_detect=t0,
        )
        # recorded AFTER the resume attempt so the label is the truth:
        # "fallback" = the reactive resume carried it, "failed" = it did
        # not and the caller got an honest error
        _obs.record_live_migration("fallback" if ok else "failed")
        if not ok:
            _rt.finish_request(req, "error")
            req.out_queue.put(_finish_marker("error"))
        return "resumed" if ok else "failed"


def drain_replica(
    victim,
    router,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    channel_factory=None,
) -> dict:
    """Move every request ``victim`` still owns onto the rest of the fleet
    (the autoscaler's drain-by-migration step, docs/failover.md). The
    victim must already be OUT of placement (``router.remove_replica``),
    so no new work arrives while this runs. Returns counts:
    ``{"migrated", "resumed", "failed", "tokens_migrated"}`` —
    ``tokens_migrated`` is what ``fleet.jsonl`` records instead of
    requests killed."""
    eng = victim.engine
    out = {"migrated": 0, "resumed": 0, "failed": 0, "tokens_migrated": 0}
    # queued entries first: nothing decoded, a fresh resubmission is exact
    for entry in eng.policy.drain():
        req = entry.payload
        eng.admission.release(entry)
        eng._close_queue_span(req)
        if req.aborted:
            eng._finish_stream(
                req,
                _finish_marker(
                    "deadline" if req.deadline_expired else "stop"
                ),
            )
            continue
        target = router.failover_target(exclude=victim.name)
        if target is None or not resume_request(
            req, target, source=victim.name
        ):
            out["failed"] += 1
            eng._finish_stream(req, _finish_marker("error"))
        else:
            out["resumed"] += 1
    # then live slots: checkpoint + KV extraction on the scheduler thread
    for slot in list(eng.slots):
        req = slot.request
        if req is None:
            continue
        target = router.failover_target(exclude=victim.name)
        if target is None:
            out["failed"] += 1
            continue
        n_before = len(req.generated_tokens)
        result = migrate_request(
            victim, target, req,
            chunk_bytes=chunk_bytes, channel_factory=channel_factory,
        )
        if result == "ok":
            out["migrated"] += 1
            out["tokens_migrated"] += n_before
        elif result == "resumed":
            out["resumed"] += 1
            out["tokens_migrated"] += n_before
        elif result in ("failed",):
            out["failed"] += 1
    return out


def stream_with_failover(front, req, *, max_failovers: int | None = None):
    """Yield ``req``'s text pieces, transparently resuming on another
    replica when the owning one fails — the stream splice. ``front`` is a
    router-like object (``replica_for`` / ``failover_target``). An
    ``"error"`` terminal marker triggers a checkpoint resume instead of
    surfacing; the resumed engine continues emission from the checkpoint's
    text cursor, and any overlap with what was already delivered (the
    cursor can trail the queue by one piece when the crash landed between
    the put and the cursor update) is clipped here — zero duplicated
    chars, zero visible errors. After ``max_failovers`` takeovers (or with
    no healthy target) the error surfaces honestly."""
    budget = (
        max_failovers if max_failovers is not None else DEFAULT_MAX_FAILOVERS
    )
    delivered = 0
    skip = 0
    failovers = 0
    while True:
        replica = front.replica_for(req)
        for piece in replica.stream(req):
            if skip:
                cut = min(skip, len(piece))
                piece = piece[cut:]
                skip -= cut
                if not piece:
                    continue
            delivered += len(piece)
            yield piece
        if req.finish_reason != "error" or req.aborted:
            return
        if failovers >= budget:
            return
        failovers += 1
        t_detect = time.monotonic()
        ckpt = checkpoint_request(req)
        target = front.failover_target(exclude=replica.name)
        if target is None:
            _obs.record_failover("reactive", "failed")
            return
        if not resume_request(
            req, target, checkpoint=ckpt, source=replica.name,
            t_detect=t_detect,
        ):
            return
        skip = max(0, delivered - ckpt.emitted_len)
