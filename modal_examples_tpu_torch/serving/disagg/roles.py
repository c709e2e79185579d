"""Role-aware replica coordination, the control plane of disaggregated
prefill/decode serving: a copy of ``modal_examples_tpu/serving/disagg/roles.py``.

:class:`DisaggCoordinator` fronts :class:`~...scheduling.router.EngineReplica`
objects with roles (``prefill`` / ``decode`` / ``unified``) and drives one
request through the migration pipeline:

1. **plan**: the role-aware router picks a prefill replica by prefix-block
   affinity and its paired decode target;
2. **reserve**: the request's whole KV-page cost is admitted on the DECODE
   replica before any byte moves (a shed here is an honest 429);
3. **prefill**: the prefill replica runs a slot-free
   :meth:`~..engine.LLMEngine.prefill_sync` (its engine never starts a
   decode loop); the pages are extracted and freed, trie pages staying
   cached;
4. **transfer**: the serialized block streams in checksummed chunks with
   resumable retry, abortable between chunks (client abort or deadline);
5. **adopt**: the decode engine adopts the block on its scheduler thread
   at admission and decodes on from the migrated position.

Every failure ends in one of two states: the request completes through the
**unified fallback** (a re-prefill on the decode side), or it ends with an
honest finish_reason (``deadline`` / client abort), with page claims and
admission reservations released on both replicas either way.
:meth:`DisaggCoordinator.migrate_live` moves a running request between
decode replicas (``serving/failover.py``).
"""

from __future__ import annotations

import threading
import time

from ...faults import inject as _inject
from ...observability import metrics as _obs
from ...observability import reqtrace as _rt
from ...scheduling.admission import ShedError
from ...scheduling.policy import DEFAULT_CLASS, ScheduledRequest
from ...utils.log import get_logger
from .transport import (
    DEFAULT_CHUNK_BYTES,
    LoopbackChannel,
    TransferAborted,
    deserialize_block,
    serialize_block,
    transfer,
)

_log = get_logger("disagg")


class Migration:
    """One in-flight page migration (observability / test handle)."""

    __slots__ = ("request", "source", "target", "started_at")

    def __init__(self, request, source: str, target: str):
        self.request = request
        self.source = source
        self.target = target
        self.started_at = time.monotonic()


def _finish_marker(reason: str):
    """The engine's own terminal stream marker class, so a request that
    dies mid-migration (before ever reaching an engine queue) terminates
    its caller's ``stream()`` exactly like an engine-finished one."""
    from ..engine import _Finish

    return _Finish(reason)


class DisaggCoordinator:
    """Front a role-tagged replica fleet with prefill/decode migration.

    Duck-type compatible with :class:`~...scheduling.router.
    PrefixAffinityRouter` where the OpenAI server cares (``replicas`` /
    ``submit`` / ``stream`` / ``abort`` / ``replica_for`` / ``stats``), plus
    ``serving_engines()`` so servers only ever start decode-capable
    engines — a prefill replica's scheduler loop must never run.

    ``channel_factory`` builds the chunk channel per migration (default:
    in-process :class:`LoopbackChannel`; tests inject corrupt/dying
    channels; a cross-process deployment hands the executor's worker
    pipe endpoints here).
    """

    def __init__(
        self,
        replicas: list,
        *,
        prefix_tokens: int = 16,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        max_rounds: int = 3,
        channel_factory=None,
        reprobe_s: float | None = None,  # router unhealthy re-probe interval
        trace_store=None,  # where gateway-side migration spans land
    ):
        from ...scheduling.router import PrefixAffinityRouter

        self.replicas = list(replicas)
        self.router = PrefixAffinityRouter(
            replicas, prefix_tokens=prefix_tokens, reprobe_s=reprobe_s
        )
        self.chunk_bytes = int(chunk_bytes)
        self.max_rounds = int(max_rounds)
        self._channel_factory = channel_factory or LoopbackChannel
        self._trace_store = (
            trace_store if trace_store is not None else _rt.default_store
        )
        if trace_store is not None:
            _rt.register_store(self._trace_store)
        self._lock = threading.Lock()
        self._inflight: dict[str, Migration] = {}
        self.migrations_ok = 0
        self.migrations_fallback = 0
        self.migrations_aborted = 0
        self.pages_migrated = 0
        self.bytes_migrated = 0
        # one model, one cache geometry: peers must agree on the page unit
        # and dtype or adopted blocks would be garbage
        shapes = {
            (r.engine.cache.page_size, r.engine.cache.kv_dtype)
            for r in self.replicas
        }
        if len(shapes) > 1:
            raise ValueError(
                f"replicas disagree on (page_size, kv_dtype): {sorted(shapes)}"
                " — disagg peers must share the cache geometry"
            )
        for r in self.replicas:
            _obs.set_replica_role(r.name, getattr(r, "role", "unified"))

    # -- submission ----------------------------------------------------------

    def submit(
        self,
        prompt: str,
        params=None,
        *,
        priority: str = DEFAULT_CLASS,
        tenant: str = "default",
        trace=_rt.UNSET,
    ):
        """Place one request: disaggregated when a healthy prefill/decode
        pair exists, unified otherwise. Raises ``ShedError`` when the owning
        replica's admission rejects it."""
        # the fleet entry point mints the request's distributed trace (the
        # trace id becomes the request id; an upstream None = sampled out
        # and passes through); the disagg plan is a `placement` span, the
        # migration pipeline below opens migrate/transfer/chunk spans, and
        # the prefill/decode replicas parent their own spans under it
        ctx = _rt.resolve_entry_trace(trace, "gateway", store=self._trace_store)
        t0_place = time.time()
        with _rt.active(ctx, replica="gateway"):
            prefill_r, decode_r = self.router.plan(prompt)
        _rt.record_span(
            ctx, "placement", start=t0_place, store=self._trace_store,
            replica="gateway",
            prefill_replica=prefill_r.name if prefill_r else "-",
            decode_replica=decode_r.name,
        )
        if prefill_r is None:
            req = decode_r.submit(
                prompt, params, priority=priority, tenant=tenant, trace=ctx
            )
            req._router_replica = decode_r
            return req
        return self._submit_disagg(
            prompt, params, prefill_r, decode_r,
            priority=priority, tenant=tenant, trace=ctx,
        )

    def _submit_disagg(
        self, prompt, params, prefill_r, decode_r, *, priority, tenant,
        trace=None,
    ):
        engine_d = decode_r.engine
        req = engine_d.make_request(
            prompt, params, priority=priority, tenant=tenant, trace=trace
        )
        req._router_replica = decode_r
        ctx = req.trace
        # fault point (docs/faults.md): the decode side sheds the migration
        # reservation — an honest 429 BEFORE any byte moves, the same
        # surface a real kv_pressure shed takes (nothing to unwind: no
        # reservation exists yet, the request never queued anywhere)
        if _inject.fire("disagg.reserve_shed"):
            _obs.record_shed(req.priority, "injected")
            _rt.event(
                ctx, "shed", store=self._trace_store, replica="gateway",
                reason="injected",
            )
            _rt.finish_root(
                ctx, "shed", store=self._trace_store, finish_reason="shed"
            )
            raise ShedError(
                "injected", 1.0,
                f"injected: decode replica {decode_r.name} shed the "
                f"migration reservation for {req.request_id}",
            )
        # migration cost reserved on the DECODE side before any byte moves:
        # the admission controller counts these pages exactly like queued
        # local work, so a decode replica can't be over-committed by
        # migrations it never saw coming
        entry = ScheduledRequest(
            payload=req,
            priority=req.priority,
            tenant=req.tenant,
            cost=engine_d.request_cost(req),
            deadline=req.deadline,
            enqueued_at=engine_d._clock(),
        )
        occ = engine_d.cache.occupancy()
        try:
            engine_d.admission.admit(  # ShedError propagates: honest 429
                entry,
                depths=engine_d.policy.depths(),
                pages_used=occ["pages_used"],
                pages_total=occ["pages_total"],
            )
        except ShedError as e:
            # ONLY real sheds close the trace as "shed" (anything else
            # here is a bug reaching the client as a 500 — the trace must
            # not claim an admission decision that never happened)
            _rt.event(
                ctx, "shed", store=self._trace_store, replica="gateway",
                reason=e.reason,
            )
            _rt.finish_root(
                ctx, "shed", store=self._trace_store, finish_reason="shed"
            )
            raise
        migration = Migration(req, prefill_r.name, decode_r.name)
        with self._lock:
            self._inflight[req.request_id] = migration
            _obs.set_migrations_inflight(len(self._inflight))
        t0 = time.monotonic()
        # the migrate span: prefill + transfer + adopt nest under it —
        # prefill-replica spans parent through req._trace_parent, and the
        # wire context in the block meta carries the same parent across
        # the hop. The ambient frame attaches injected transport faults
        # (chunk corrupt/drop, replica death) to THIS request.
        mig_sp = _rt.begin(
            ctx, "migrate", replica="gateway",
            source=prefill_r.name, target=decode_r.name,
        )
        req._trace_parent = mig_sp.span_id if mig_sp is not None else None
        tr_sp = None
        try:
            with _rt.active(ctx, parent=req._trace_parent, replica="gateway"):
                block, payload = self._prefill_and_pack(prefill_r, req)

                def should_abort() -> bool:
                    if req.aborted:
                        return True
                    if (
                        req.deadline is not None
                        and engine_d._clock() >= req.deadline
                    ):
                        req.deadline_expired = True
                        return True
                    return False

                tr_sp = _rt.begin(
                    ctx, "transfer", parent=req._trace_parent,
                    replica="gateway", wire_bytes=len(payload),
                )
                with _rt.active(
                    ctx,
                    parent=tr_sp.span_id if tr_sp is not None else None,
                    replica="gateway",
                ):
                    wire = transfer(
                        payload,
                        self._channel_factory(),
                        transfer_id=req.request_id,
                        chunk_bytes=self.chunk_bytes,
                        max_rounds=self.max_rounds,
                        should_abort=should_abort,
                    )
                _rt.finish(
                    ctx, tr_sp, store=self._trace_store,
                    chunks=-(-len(payload) // max(1, self.chunk_bytes)),
                )
                if should_abort():
                    raise TransferAborted(req.request_id)
                # fault point: the reassembled block corrupts between wire
                # and adoption (bad DMA, bit rot) — deserialize_block's crc
                # check turns it into a loud TransportError -> unified
                # fallback below
                wire = _inject.corrupt("disagg.adopt_corrupt", wire)
                engine_d.submit_adopted(req, entry, deserialize_block(wire))
            with self._lock:
                self.migrations_ok += 1
                self.pages_migrated += block.n_pages
                self.bytes_migrated += len(payload)
            _obs.record_migration(
                "ok", pages=block.n_pages, wire_bytes=len(payload)
            )
            _rt.finish(
                ctx, mig_sp, store=self._trace_store, result="ok",
                pages=block.n_pages, wire_bytes=len(payload),
            )
            return req
        except TransferAborted:
            engine_d.admission.release(entry)
            with self._lock:
                self.migrations_aborted += 1
            _obs.record_migration("aborted")
            if req.deadline_expired:
                _obs.record_deadline_miss("migrating")
            reason = "deadline" if req.deadline_expired else "stop"
            _rt.finish(ctx, tr_sp, status="aborted", store=self._trace_store)
            _rt.finish(
                ctx, mig_sp, status="aborted", store=self._trace_store,
                result="aborted",
            )
            _rt.finish_request(req, reason, store=self._trace_store)
            req.out_queue.put(_finish_marker(reason))
            return req
        except Exception as e:
            # replica death, wire corruption beyond retry, OutOfPages on the
            # prefill side: unified fallback — the decode-capable replica
            # re-prefills the request from scratch. Reservations/claims are
            # already unwound (prefill_sync releases its claim on failure;
            # the decode reservation releases here).
            engine_d.admission.release(entry)
            with self._lock:
                self.migrations_fallback += 1
            _obs.record_migration("fallback")
            _rt.finish(ctx, tr_sp, status="error", store=self._trace_store)
            _rt.finish(
                ctx, mig_sp, status="error", store=self._trace_store,
                result="fallback",
            )
            if req.aborted:
                _rt.finish_request(req, "stop", store=self._trace_store)
                req.out_queue.put(_finish_marker("stop"))
                return req
            _log.warning(
                "migration %s (%s -> %s) failed (%s: %s); unified re-prefill "
                "on %s",
                req.request_id, prefill_r.name, decode_r.name,
                type(e).__name__, e, decode_r.name,
            )
            req._trace_parent = None  # fallback spans parent at the root
            return engine_d.submit_request(req)  # ShedError propagates
        finally:
            with self._lock:
                self._inflight.pop(req.request_id, None)
                _obs.set_migrations_inflight(len(self._inflight))
            _obs.record_migration_seconds(time.monotonic() - t0)

    def _prefill_and_pack(self, prefill_r, req):
        """Prefill on the source replica, extract the wire block, and free
        the source pages (trie pages stay cached: the prefill replica's
        prefix cache survives the request)."""
        engine_p = prefill_r.engine
        state = engine_p.prefill_sync(req)
        try:
            block = engine_p.extract_request_pages(req, state)
        finally:
            engine_p.release_claim(state["claim"], valid=True)
        return block, serialize_block(block)

    # -- request lifecycle ---------------------------------------------------

    def replica_for(self, req):
        replica = getattr(req, "_router_replica", None)
        if replica is None:
            raise KeyError(f"request {req.request_id} not routed here")
        return replica

    def failover_target(self, exclude: str | None = None):
        """Resume target for a failed in-flight request: delegate to the
        role-aware router (healthy decode-capable replicas only)."""
        return self.router.failover_target(exclude=exclude)

    def stream(self, req):
        """Stream with in-flight failover (serving/failover.py): a decode
        replica dying mid-stream is checkpoint-resumed on a healthy peer
        — the client stream continues token-identically, no visible
        error (docs/failover.md)."""
        from ..failover import stream_with_failover

        yield from stream_with_failover(self, req)

    def migrate_live(self, req, target_name: str | None = None) -> str:
        """Coordinator-planned rebalancing: proactively move one in-flight
        request off its current replica — KV pages and decode state ride
        the same chunked MTKV1 wire the prefill migration uses, and the
        target adopts mid-decode. Returns the
        :func:`~..failover.migrate_request` result string."""
        from ..failover import migrate_request

        source = self.replica_for(req)
        if target_name is not None:
            target = next(
                (r for r in self.replicas if r.name == target_name), None
            )
            if target is None or not target.serves_requests:
                raise KeyError(
                    f"no decode-capable replica named {target_name!r}"
                )
        else:
            target = self.failover_target(exclude=source.name)
            if target is None or target.name == source.name:
                return "gone"  # nowhere better to move it
        return migrate_request(
            source, target, req,
            chunk_bytes=self.chunk_bytes, max_rounds=self.max_rounds,
            channel_factory=self._channel_factory,
        )

    def abort(self, req) -> None:
        """Abort a request wherever it is: still migrating (the transfer
        loop trips between chunks), queued, or decoding."""
        req.aborted = True
        self.replica_for(req).abort(req)

    def migrations(self) -> list:
        """Snapshot of in-flight migrations (observability/tests)."""
        with self._lock:
            return list(self._inflight.values())

    def serving_engines(self) -> list:
        """Engines whose scheduler loop may run: decode-capable replicas
        only. A prefill replica's engine must NEVER be started — its cache
        buffers are owned by the synchronous prefill path."""
        return [r.engine for r in self.replicas if r.serves_requests]

    def stats(self) -> dict:
        with self._lock:
            mig = {
                "ok": self.migrations_ok,
                "fallback": self.migrations_fallback,
                "aborted": self.migrations_aborted,
                "inflight": len(self._inflight),
                "pages": self.pages_migrated,
                "bytes": self.bytes_migrated,
            }
        return {"migrations": mig, "router": self.router.stats()}
