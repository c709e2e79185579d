"""Continuous-batching LLM engine over the paged KV cache (slice 1 of the port).

Counterpart of ``modal_examples_tpu/serving/engine.py``, with the same method
names: ``make_request``, ``submit_request``, ``submit``, ``generate``,
``stream``, ``abort``, ``start``/``stop``/``_loop``, ``_expire_deadlines``,
``_admit``, ``_claim_pages``, ``_prefill_group``, ``_prefill_long``,
``_advance_pending_prefills``, the decode tick and ``_accept_token``; and
``MODEL_PRESETS`` with ``build_engine``. ``model_dir=`` without ``params=``
loads the checkpoint (``llama.load_hf_weights``, quantized on the host under
``quantization=``).

Scheduler tick: expire deadlines, admit, decode. Admission pops the
``SchedulerPolicy`` (``FairSharePolicy`` by default: strict priority classes,
tenant fair share), behind an ``AdmissionController`` that sheds at submit
(``ShedError``, a 429 upstream) and reserves each queued request's pages. A
popped request claims its whole page budget: with the prefix cache on (the
default) its full prompt pages come from, or go into, the ``PrefixCache``
trie, and only the rest is allocated (zero-ref cached pages are evicted under
pressure). Prompts prefill in bucketed batches; longer ones take
``prefill_chunk`` chunk by chunk through a resumable per-slot state machine.
``max_prefill_tokens_per_tick`` (argument, then ``MTPU_PREFILL_BUDGET``, then
unlimited; 0 means unlimited) caps the prompt tokens turned into prefill work
a tick: in-flight sliced prefills resume first, the first chunk of an
otherwise idle tick always dispatches, and entries past the budget go back to
the front of their queues with their reservations. Deadlines (``deadline_s``)
cancel queued requests and abort in-flight ones, which finish with
"deadline"; a slot aborted mid-prefill unwinds its claim, invalidating trie
pages that were never fully written.

The decode loop is the JAX engine's pipelined one (``_decode_tick``):
``_dispatch_block`` queues one decode block on ``_inflight`` (``decode_block``
decode+sample steps, or at ``decode_steps`` N > 1 one macro-step program,
either cut to the largest number of tokens its slots would still accept;
the JAX engine runs the steps past it too) and returns before it runs;
``_harvest_prefills`` then reads the first tokens that prefills parked on
``_pending_harvest``, so those reads overlap the block just queued; and
``_process_block`` reads and accepts the oldest block only when two are in
flight or no slot is decodable. Each block feeds the
next one its last tokens on the device; a freshly prefilled slot feeds its
host-known first token through the override lane, and the host tracks each
slot's optimistic position (``_opt_positions``) ahead of its accepted one.
A block's snapshot pins (slot, request, tenancy), so rows of a slot that
finished or was recycled while the block ran are dropped. Every launch of
the engine goes to one CUDA stream: a slot that finishes while a block still
decodes it only writes its own pages (or, past its claimed pages, the trash
page), and a prefill that reuses those pages is queued after that block.
The host arrays of a dispatch go to the card in one non-blocking copy from
pinned memory, and a block's tokens (and a prefill's first tokens) come back
by a non-blocking copy queued where they are produced, read later behind a
CUDA event: reading one block never waits for the block queued after it.

Sampling is keyed by (request seed, position) exactly as in the JAX engine
(every request carries a seed: the caller's, or one assigned at submit), so
tokens do not depend on batch composition or on how steps are grouped into
blocks.

Quantized serving (``quantization="int8"`` or ``"int4"``: int8 weights
through the int8 matmul kernel, packed int4 through the int4 one;
``kv_dtype="int8"``: the int8 paged cache with its decode and
scatter kernels) follows the JAX engine's arguments.

The decode structure (``paged_impl``, ``scatter_impl``; argument, then
``MTPU_PAGED_IMPL``/``MTPU_SCATTER_IMPL``, then "xla") is resolved once and
passed to every ``decode_step``: "xla"/"pallas" attend over read-only pages
with the ragged decode kernel, the writeback impls with the write-then-attend
kernel. ``decode_steps`` (argument, then ``MTPU_DECODE_STEPS``, then 1; read
once per dispatch, so it may change at runtime) above 1 replaces the decode
block with the macro-step program (``serving/multistep``): N steps with
on-device stop and budget masks, and detokenization on a
:class:`~.multistep.DetokWorker` thread.

Instruments, as the JAX engine's: the metrics series of
``observability/metrics.py`` (phase, batch, stall, TTFT/TPOT, queue, page and
prefix-cache gauges, token counters, flushed by ``_refresh_gauges`` at most
every 0.25 s), request traces (``observability/reqtrace.py``: the root span
opened at ``make_request``, then queue, prefill and decode spans; ``trace_store=``
picks the store), the hot-path profiler (``profile=``, then
``MTPU_PROFILE``: each tick's host time split into ``catalog.TICK_PHASES``,
the blocking reads counted as device time; off, ``self.profiler`` is None and
a tick takes no timestamp), and the usage meter (``self.usage``: tokens,
FLOPs and bytes per tenant, utilization shares against the card's peaks).
``EngineStats`` keeps the JAX engine's counters and ``decode_seconds`` /
``decode_tokens``. The profiler keeps no compile ledger: the port compiles
no programs at dispatch (its kernels build once, at first use).

Speculative decoding (``speculative=(draft config or preset, γ)`` with
``draft_params=`` or ``draft_model_dir=``, or ``speculative=("ngram", γ)``
for prompt lookup) is the JAX engine's: the draft keeps its own paged cache
over the target allocator's page ids (filled by every prefill), and each
tick runs one round of ``serving/spec_runtime`` (draft propose, one verify
pass over every chain position, the accept cut) harvested at once through
``_process_block`` (no round is pipelined: the next one starts from this
one's accepted tokens). Each slot's γ comes from ``_slot_gamma`` (sampled
requests never speculate; ``spec_adaptive`` switches on the per-request
acceptance controller; ``spec_depth`` caps γ at runtime); a round in which
no slot speculates falls back to one decode block, read at once.

The flight recorder rides the engine as in the reference: the constructor
starts the process-wide tsdb sampler when ``MTPU_TSDB`` is on and registers
the engine with the incident collector, a scheduler crash captures a
``scheduler_crash`` bundle before the callers are released, and the
canary's probes (tenant ``__canary__``) stay out of the TTFT/TPOT
histograms; the ``engine.canary_token_corrupt`` fault point flips one of
their tokens.

The fleet's claim paths (``serving/disagg``, ``serving/failover.py``), as
in the reference: :meth:`LLMEngine.prefill_sync` prefills one request
without a slot on an engine whose loop never runs (a prefill replica; on a
started engine it raises), :meth:`~LLMEngine.extract_request_pages` and
:meth:`~LLMEngine.release_claim` ship and free its pages;
:meth:`~LLMEngine.submit_adopted` queues a request whose KV arrives as a
wire block, adopted on the scheduler thread at admission (``index_copy_`` on
the engine's stream, ordered behind the block in flight);
:meth:`~LLMEngine.submit_resumed` resumes a request from a decode
checkpoint: the original prompt is prefilled again and the generated prefix
replayed teacher-forced through the decode block body, one token a dispatch
at the block's batch width, so the rebuilt KV is the decode-written KV bit
for bit, at most ``decode_block`` tokens a tick (the slot decodes once the
replay ends); :meth:`~LLMEngine.migrate_out` detaches a running request on the
scheduler thread (``_run_on_scheduler``) as a block with its decode state.
An adopted, migrated or replayed tenancy rebuilds its prompt-lookup index,
and in draft mode holds γ at 0 (``_Slot.spec_hold``: its draft cache has a
hole). The progress watermarks (``self.watermarks``,
``serving/health.py``) note each start, tick, dispatch and accepted token;
the fault points ``engine.scheduler_crash`` (the loop releases every caller
with "error" and lives on), ``engine.scheduler_freeze``,
``engine.out_of_pages`` and ``engine.slow_decode`` are the reference's.
``stop(reason="error")`` poisons the engine until :meth:`~LLMEngine.revive`.

``tiered_prefix=`` wraps the prefix trie with the host-RAM and ``Volume``
spill tiers (``serving/disagg/tiered_cache.py``): evicted prefix pages spill
on the eviction wave and promote back inside ``_claim_pages``.

Every device call (a batched prefill and its first tokens, a chunk, a
sliced prompt's first token, a replay step, a decode block) goes through
``self.runner`` (``serving/runner.py``). ``mesh=`` (a mesh with a
``tensor`` axis, ``parallel.make_mesh``) is tensor-parallel serving, the
JAX engine's one flag: this process is the axis's rank 0, holds its shards
(``_model_state``) and decides everything as on one card; its runner ships
each call to the other ranks, which run :func:`follow`. Speculation, the
macro-step, the tiered cache, the vision tower and the page moves of
disaggregated serving and migration under a mesh raise (ROADMAP A10b).

Multimodal serving (``vision=(models.vlm.VLMConfig, vision params)``, the
JAX engine's): ``submit(prompt, params, image)`` puts the image's
``n_image_tokens`` placeholder ids ahead of the text (cut to the largest
bucket less the image tokens: image prompts never chunk), and an image
request's prompt is charged to the prefill budget up front. With the prefix
cache on, its image positions key the trie (``cache_key_tokens``) by the
image's SHA-256 above the vocabulary, so requests with equal images share
those pages and different images never do. Image prompts prefill in groups
of their own: the tower's projected patch states enter ``llama.prefill`` as
``input_embeds``, one step with the prefill (``runner.prefill_mm``).
``vision=`` with ``speculative=`` raises, and image requests refuse the
slot-free prefill of disaggregated serving and the failover resume, as in
the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import queue
import threading
import time
import traceback
import uuid

import numpy as np
import torch

from ..faults import inject as _inject
from ..models import llama
from ..models.quantize import SUPPORTED as _QUANT_MODES
from ..models.quantize import (
    LLAMA_TARGETS, QuantizedWeight, bits_of, param_bytes, quantize_layer, quantize_llama, quantize_weight,
)
from ..observability import incident as _incident
from ..observability import metrics as _obs
from ..observability import profiler as _profiler
from ..observability import reqtrace as _rt
from ..observability import timeseries as _ts
from ..observability import usage as _usage
from ..ops.kv_quant import resolve_kv_dtype
from ..ops.sharded import mesh_tp_degree
from ..scheduling.admission import AdmissionController, ShedError
from ..scheduling.policy import DEFAULT_CLASS, FairSharePolicy, ScheduledRequest, SchedulerPolicy, validate_class
from ..utils.device import resolve_device
from ..utils.tokenizer import load_tokenizer
from .kv_cache import OutOfPages, PagedKVCache
from .multistep import DetokWorker, build_multistep_fn, resolve_decode_steps
from .prefix_cache import PrefixCache
from .health import EngineWatermarks
from .runner import ModelRunner, control_group, share_settings
from .sampling import SamplingParams, sample
from .spec_runtime import AdaptiveGammaController, build_ngram_round_fn, build_spec_round_fn, resolve_spec_adaptive

_CANARY_TENANT = _usage.CANARY_TENANT


class _Turns:
    """First-come turns at the interpreter for the host work of the
    process's engines: a scheduler tick, and a prefill on a caller's thread
    (:meth:`LLMEngine.prefill_sync`), each run in one turn. The host work is
    a run of small launches, each of which releases and retakes the
    interpreter lock; two such runs side by side hand the lock back and
    forth at every launch and each takes several times its own length, so a
    decode replica's tick beside a caller's prefill reads as stale progress
    to the watchdog. A waiter that does not get a turn within ``wait_s``
    runs without one, so an engine stuck inside its turn slows the others
    and stops none."""

    def __init__(self, wait_s: float):
        self.wait_s = wait_s
        self._cv = threading.Condition()
        self._holder: int | None = None
        self._queue: collections.deque = collections.deque()

    def acquire(self) -> bool:
        me = threading.get_ident()
        deadline = time.monotonic() + self.wait_s
        with self._cv:
            self._queue.append(me)
            while self._holder is not None or self._queue[0] != me:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._queue.remove(me)
                    self._cv.notify_all()
                    return False
                self._cv.wait(left)
            self._queue.popleft()
            self._holder = me
            return True

    def release(self) -> None:
        with self._cv:
            self._holder = None
            self._cv.notify_all()


#: the process's turns (the interpreter is one per process); a turn waits
#: at most about a 7B decode tick's host work
_TURNS = _Turns(wait_s=0.5)


def _tm(tick, phase: str) -> None:
    """Close the interval since the tick's last mark into ``phase``. ``tick``
    is None whenever profiling is off, so the disabled path is one branch."""
    if tick is not None:
        tick.mark(phase)


def _tm_device(tick, phase: str) -> None:
    """:func:`_tm`, also counting the interval as device-blocked time (a
    blocking read of a device tensor)."""
    if tick is not None:
        tick.mark(phase, device=True)


@dataclasses.dataclass(eq=False)
class Request:
    prompt: str
    params: SamplingParams
    request_id: str = dataclasses.field(default_factory=lambda: f"req-{uuid.uuid4().hex[:12]}")
    prompt_tokens: list[int] | None = None
    out_queue: queue.Queue = dataclasses.field(default_factory=queue.Queue)
    created: float = dataclasses.field(default_factory=time.monotonic)
    aborted: bool = False
    finish_reason: str | None = None  # set when the terminal marker arrives
    # token telemetry (monotonic clock): TTFT = first_token_at - created;
    # the gaps between tokens feed the TPOT histogram
    first_token_at: float | None = None
    last_token_at: float | None = None
    n_generated: int = 0  # accepted tokens, eos included
    generated_tokens: list = dataclasses.field(default_factory=list)  # eos excluded
    # engine-assigned when params.seed is None: sampling is derived from
    # (auto_seed, position), never from scheduler timing
    auto_seed: int | None = None
    emitted_len: int = 0  # characters emitted so far (inline path or detokenization worker)
    # scheduling: the class and tenant drive the fair-share policy; deadline
    # is absolute in the engine's clock (params.deadline_s armed at
    # make_request); deadline_expired makes an abort finish with "deadline"
    priority: str = DEFAULT_CLASS
    tenant: str = "default"
    deadline: float | None = None
    deadline_expired: bool = False
    # prompt tokens whose KV came from pages already in the prefix cache
    # (OpenAI usage.prompt_tokens_details.cached_tokens), set at page claim
    cached_prompt_tokens: int = 0
    sched_entry: ScheduledRequest | None = dataclasses.field(default=None, repr=False)  # while queued
    # the request trace (observability/reqtrace.py), None when tracing is
    # off or sampled out; its open queue and decode spans
    trace: object | None = dataclasses.field(default=None, repr=False)
    queue_span: object | None = dataclasses.field(default=None, repr=False)
    decode_span: object | None = dataclasses.field(default=None, repr=False)
    # the fleet's claim paths: the replica that owns the request behind a
    # router; the span a prefill replica's spans parent under; an adopted
    # block's state and a resumed request's replay, read at admission; the
    # original prompt of a resumed request (checkpoints never compound)
    _router_replica: object | None = dataclasses.field(default=None, repr=False)
    _trace_parent: str | None = dataclasses.field(default=None, repr=False)
    _adopted_state: dict | None = dataclasses.field(default=None, repr=False)
    _resume_state: dict | None = dataclasses.field(default=None, repr=False)
    _orig_prompt_tokens: list | None = dataclasses.field(default=None, repr=False)
    # multimodal: the preprocessed [S, S, 3] f32 image (models.vlm), whose
    # n_image_tokens placeholder ids lead prompt_tokens
    image: object | None = dataclasses.field(default=None, repr=False)
    # the prefix cache's key when it must differ from prompt_tokens: an
    # image's positions key by a content hash above the vocabulary, so equal
    # images share KV pages and different ones never do
    cache_key_tokens: list | None = None


@dataclasses.dataclass
class _PendingPrefill:
    """A slot's resumable chunked prefill: ``_admit`` advances at most a
    budget's worth of chunks a tick, so a decode block runs between chunks."""

    req: Request
    table: np.ndarray  # the slot's page-table row
    offset: int = 0  # token offset of the next chunk
    ticks: int = 0  # ticks that dispatched at least one chunk
    suspensions: int = 0  # times the budget paused this prefill mid-prompt
    t_start: float = 0.0  # monotonic, for the phase histogram
    t_wall: float = 0.0  # wall clock, for the trace spans
    spans: list = dataclasses.field(default_factory=list)  # each chunk's (start, end) CUDA events


class _NgramIndex:
    """A slot's n-gram index for prompt-lookup speculation (a copy of the JAX
    engine's): built once from the prompt and pushed one accepted token at a
    time, so a proposal costs O(γ). The proposal continues the most recent
    occurrence of the trailing n-gram strictly before the tail itself, the
    match starting within the last ``lookback`` tokens."""

    __slots__ = ("n", "lookback", "hist", "occ")

    def __init__(self, n: int, prompt: list[int], lookback: int):
        self.n = n
        self.lookback = lookback
        self.hist: list[int] = []
        self.occ: dict[tuple, list[int]] = {}  # n-gram -> ascending start positions
        for tok in prompt:
            self.push(tok)

    def push(self, token: int) -> None:
        """Append one accepted token; record the n-gram it completes."""
        self.hist.append(token)
        start = len(self.hist) - self.n
        if start >= 0:
            self.occ.setdefault(tuple(self.hist[start:]), []).append(start)

    def propose(self, gamma: int) -> list[int]:
        """Up to ``gamma`` tokens that followed the most recent earlier
        occurrence of the tail n-gram ([]: no proposal)."""
        hist, n = self.hist, self.n
        if len(hist) <= n:
            return []
        tail_start = len(hist) - n
        occs = self.occ.get(tuple(hist[tail_start:]))
        if not occs:
            return []
        lo = max(0, len(hist) - self.lookback)
        # the last start is the tail itself: the first one before it counts,
        # if it lies inside the lookback window
        for j in reversed(occs):
            if j < tail_start:
                return [] if j < lo else hist[j + n : j + n + gamma]
        return []


@dataclasses.dataclass
class _Slot:
    request: Request | None = None
    pages: list[int] = dataclasses.field(default_factory=list)
    trie_pages: list[int] = dataclasses.field(default_factory=list)  # PrefixCache.release()d
    private_pages: list[int] = dataclasses.field(default_factory=list)  # freed
    position: int = 0  # position of the NEXT token to decode (accepted, not optimistic)
    last_token: int = 0
    fresh: bool = False  # just prefilled: the next dispatch feeds last_token through the override lane
    generated: list[int] = dataclasses.field(default_factory=list)
    emitted_text_len: int = 0
    prefill: _PendingPrefill | None = None  # set while the prompt fills chunk by chunk
    pending_first: bool = False  # prefill dispatched, its first token not yet harvested
    tenancy: int = 0  # per-install id: block and harvest snapshots pin (request, tenancy)
    claimed_at: float = 0.0  # engine clock at install: the usage meter's occupancy interval
    ngram: _NgramIndex | None = None  # prompt-lookup speculation only
    # draft mode: an adopted or replayed tenancy never proposes (its draft
    # cache has a hole where the shipped or replayed KV is)
    spec_hold: bool = False
    # a failover resume: the generated tokens still to feed through the
    # decode body (``_replay_tick``) before the slot decodes
    replay: list[int] | None = None

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def decodable(self) -> bool:
        """Admitted and holding a first token on the host: a slot mid-prefill,
        with its first token unharvested or mid-replay is not."""
        return (self.request is not None and self.prefill is None and not self.pending_first
                and self.replay is None)


@dataclasses.dataclass
class EngineStats:
    prompt_tokens: int = 0  # prompt tokens whose first token was harvested
    generated_tokens: int = 0  # accepted tokens (first tokens included)
    steps: int = 0  # decode steps that ran: a block's dispatched rows, a macro-step's rows with a valid lane
    started: float = dataclasses.field(default_factory=time.monotonic)
    decode_seconds: float = 0.0  # host wall time of decode dispatches and block reads (accepts included)
    decode_tokens: int = 0  # tokens accepted from decode blocks
    prefill_suspensions: int = 0  # chunked prefills paused mid-prompt by the budget
    spec_proposed: int = 0  # draft tokens proposed (speculative mode)
    spec_accepted: int = 0  # draft tokens accepted by the target

    def tokens_per_second(self) -> float:
        dt = time.monotonic() - self.started
        return self.generated_tokens / dt if dt > 0 else 0.0

    def acceptance_rate(self) -> float:
        return self.spec_accepted / self.spec_proposed if self.spec_proposed else 0.0


class _Finish:
    """Terminal stream marker carrying the OpenAI finish_reason."""

    __slots__ = ("reason",)

    def __init__(self, reason: str = "stop"):
        self.reason = reason


_FINISH = _Finish("stop")


def _mark(device: torch.device):
    """A timing event recorded on the card's stream now (None on the CPU):
    where a unit of device work starts, for the usage meter's device
    seconds."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class _Landing:
    """A device tensor's copy to the host, queued right after the work that
    produces it: on the card a non-blocking copy into pinned memory and a
    CUDA event behind it, so :meth:`numpy` waits for that work only, not for
    what was queued on the stream later (a later decode block). On the CPU
    the tensor is already there. ``spans`` are the (start, end) events around
    the work behind the tensor (``start``: the one that ends at this
    landing), which :meth:`device_seconds` sums."""

    __slots__ = ("host", "event", "spans")

    def __init__(self, t: torch.Tensor, start=None, spans=()):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
            self.spans = [*spans, (start, self.event)] if start is not None else list(spans)
        else:
            self.host, self.event, self.spans = t, None, []

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    def device_seconds(self) -> float | None:
        """Seconds of the card's stream between each span's events, summed,
        once landed; None on the CPU. Spans of one engine never overlap (one
        stream), and the time between launches counts: while the host
        launches slower than the card runs, a span is the launching time."""
        if self.event is None:
            return None
        return sum(a.elapsed_time(b) for a, b in self.spans) / 1e3


def _unstable_tail(text: str) -> bool:
    """True when the last char may still change with the next token: a
    replacement char or a surrogate-escaped byte (mid-codepoint)."""
    if not text:
        return False
    c = ord(text[-1])
    return c == 0xFFFD or 0xDC80 <= c <= 0xDCFF


def _stop_safe_len(text: str, stop: tuple[str, ...]) -> int:
    """Longest prefix of ``text`` that cannot be the start of a pending stop
    match; the rest is withheld until the match completes or fails."""
    safe = len(text)
    for stop_s in stop:
        for start in range(max(0, len(text) - len(stop_s) + 1), len(text)):
            if stop_s.startswith(text[start:]):
                safe = min(safe, start)
                break
    return safe


def _req_seed(req: Request) -> int:
    if req.params.seed is not None:
        return req.params.seed
    return req.auto_seed if req.auto_seed is not None else -1


#: the model names ``build_engine`` takes, as the JAX engine's
MODEL_PRESETS = {
    "llama2-7b": llama.LlamaConfig.llama2_7b,
    "llama3-8b": llama.LlamaConfig.llama3_8b,
    "llama3.1-8b": llama.LlamaConfig.llama31_8b,
    "llama3.2-1b": llama.LlamaConfig.llama32_1b,
    "mistral-7b": llama.LlamaConfig.mistral_7b,
    "mixtral-8x7b": llama.LlamaConfig.mixtral_8x7b,
    "tiny": llama.LlamaConfig.tiny,
    "tiny-moe": llama.LlamaConfig.tiny_moe,
}


def _check_tp_engine(cfg, tp: int, *, speculative, decode_steps, tiered_prefix) -> None:
    """What a tensor-parallel engine takes, checked before a byte is
    allocated: a process group (the mesh is one), whole heads a rank (the
    cache shards on the kv-head axis), rank 0 of the axis, and none of the
    options whose tensor-parallel form waits."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a tensor-parallel engine needs a process group: parallel.cluster.init_distributed()")
    if tp > 1 and (cfg.n_kv_heads % tp or cfg.n_heads % tp):
        raise ValueError(
            f"n_kv_heads={cfg.n_kv_heads} / n_heads={cfg.n_heads} must be divisible by the tensor axis size {tp} "
            "for kv-head-sharded TP serving"
        )
    if dist.get_rank() != 0:
        raise RuntimeError("the engine runs on rank 0; every other rank of the mesh runs serving.engine.follow()")
    if speculative is not None:
        raise NotImplementedError("speculative decoding under tensor parallelism waits (ROADMAP A10b)")
    if resolve_decode_steps(decode_steps) > 1:
        raise NotImplementedError("the macro-step (decode_steps > 1) under tensor parallelism waits (ROADMAP A10b)")
    if tiered_prefix:
        raise NotImplementedError("the tiered prefix cache under tensor parallelism is not ported (ROADMAP A10b)")


def _model_state(cfg, params, *, model_dir, quantization, seed: int, kv_dtype, device, mesh, n_pages: int,
                 page_size: int):
    """The weights (this rank's shards under a mesh) and the paged cache
    (this rank's kv heads) of an engine, made the same way on every rank
    from rank 0's settings. Given or loaded weights are quantized, then cut;
    drawn ones are drawn, quantized and cut a layer at a time, so no rank
    holds the whole tree."""
    tp = mesh_tp_degree(mesh)
    if params is None and model_dir is None:
        bits = bits_of(quantization) if quantization is not None else None

        def per_layer(layer):
            # drawn and quantized layer by layer: no resident bf16 tree
            if bits is not None:
                layer = quantize_layer(layer, LLAMA_TARGETS, bits)
            return layer if mesh is None else llama.shard_layer(layer, cfg, mesh)

        params = llama.init_params(cfg, seed=seed, device=device, map_layer=per_layer)
        if bits is not None and "lm_head" in params:
            params["lm_head"] = quantize_weight(params["lm_head"], bits)
        if mesh is not None:
            params = llama.shard_params(params, cfg, mesh, layers=False)
    else:
        if params is None:
            # int8 and int4 are quantized on the host: the bf16 weights never reach the card
            params = llama.load_hf_weights(model_dir, cfg, quantization=quantization, device=device)
        elif quantization is not None:
            params = quantize_llama(params, bits=bits_of(quantization))
        if mesh is not None:
            params = llama.shard_params(params, cfg, mesh)
    cache = PagedKVCache.create(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads // tp, head_dim=cfg.head_dim,
        n_pages=n_pages, page_size=page_size, kv_dtype=resolve_kv_dtype(kv_dtype), device=device,
    )
    return params, cache


#: the settings rank 0's engine resolves and its followers build from
_STATE_SETTINGS = ("model_dir", "quantization", "seed", "kv_dtype", "n_pages", "page_size")


def _weights_source(params, model_dir) -> str:
    return "given" if params is not None else ("loaded" if model_dir is not None else "drawn")


class LLMEngine:
    #: every scheduler-loop traceback from any engine in this process (capped)
    _error_reports: list = []

    def __init__(
        self,
        cfg: llama.LlamaConfig,
        params: dict | None = None,
        *,
        model_dir: str | None = None,
        max_slots: int = 16,
        page_size: int = 16,
        max_model_len: int = 1024,
        n_pages: int | None = None,
        prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048),
        prefill_batch: int = 4,
        enable_prefix_cache: bool = True,
        quantization: str | None = None,  # "int8"/"int4": weight-only quantized serving
        seed: int = 0,
        kv_dtype=None,  # "int8": the quantized paged cache; None: MTPU_KV_DTYPE, then bf16
        speculative: tuple | None = None,  # (draft preset | LlamaConfig | "ngram", gamma)
        draft_params: dict | None = None,
        draft_model_dir: str | None = None,
        # the per-request adaptive-γ controller; None: MTPU_SPEC_ADAPTIVE, then
        # off. Runtime-mutable (self.spec_adaptive, like self.spec_depth)
        spec_adaptive: bool | None = None,
        decode_block: int = 8,
        decode_steps: int | None = None,  # macro-step N; None: env, then 1
        # prompt tokens turned into prefill work a tick; None: the
        # MTPU_PREFILL_BUDGET env (empty: unlimited); an explicit 0 is
        # unlimited and ignores the env. Read once per _admit, so it may
        # change at runtime
        max_prefill_tokens_per_tick: int | None = None,
        device=None,
        paged_impl: str | None = None,  # decode structure; None: env, then "xla"
        scatter_impl: str | None = None,  # KV scatter; None: env, then "xla"
        policy: SchedulerPolicy | None = None,  # waiting-set order; None: FairSharePolicy
        admission: AdmissionController | None = None,  # shed gate; None: AdmissionConfig.from_env()
        clock=None,  # monotonic clock of deadlines, the policy, the profiler and the usage meter
        profile=None,  # the hot-path profiler; None: MTPU_PROFILE, then off
        trace_store=None,  # where this engine's request spans land; None: the process-wide store
        # the tiered prefix cache: True for the env-default sizing, or a dict
        # of TieredPrefixCache kwargs (host_bytes=, volume=, shared=,
        # replica=); evicted prefix pages spill HBM -> host RAM -> Volume
        # and promote back on the next shared-prefix prompt
        tiered_prefix=None,
        # tensor parallelism (a mesh with a "tensor" axis, parallel.make_mesh):
        # this process is the axis's rank 0; every other rank runs follow()
        mesh=None,
        # multimodal serving: (models.vlm.VLMConfig, vision params); image
        # requests prefill with the tower's projected patch states as their
        # first n_image_tokens positions
        vision: tuple | None = None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.tp = mesh_tp_degree(mesh)
        if vision is not None and mesh is not None:
            raise NotImplementedError("vision= under tensor parallelism (the tower replicated on every rank) is "
                                      "ROADMAP A10b")
        if mesh is not None:
            _check_tp_engine(cfg, self.tp, speculative=speculative, decode_steps=decode_steps,
                             tiered_prefix=tiered_prefix)
        if max_prefill_tokens_per_tick is None:
            raw = os.environ.get("MTPU_PREFILL_BUDGET", "")
            max_prefill_tokens_per_tick = int(raw) if raw else 0
        self.prefill_budget = max(0, int(max_prefill_tokens_per_tick))
        # explicit arg, then MTPU_KV_DTYPE, then bf16, as the reference resolves it
        if kv_dtype is None:
            kv_dtype = os.environ.get("MTPU_KV_DTYPE") or "bfloat16"
        kv_dtype = resolve_kv_dtype(kv_dtype)
        self.kv_dtype = "int8" if kv_dtype == "int8" else str(kv_dtype).removeprefix("torch.")
        self.cfg = cfg
        self.tokenizer = load_tokenizer(model_dir)
        if quantization not in _QUANT_MODES:
            raise ValueError(f"unknown quantization {quantization!r}; supported: {_QUANT_MODES}")
        # resolved once and passed to every decode_step
        self.paged_impl = paged_impl or os.environ.get("MTPU_PAGED_IMPL", "xla")
        self.scatter_impl = scatter_impl or os.environ.get("MTPU_SCATTER_IMPL", "xla")
        given = params["layers"][0]["wq"] if params is not None else None
        weights = quantization or (f"int{given.bits}" if isinstance(given, QuantizedWeight) else None)
        # validates both impl names before a byte is allocated
        self.impl_plan = llama.paged_impl_plan(
            cfg, self.device, self.kv_dtype, weights, impl=self.paged_impl, scatter_impl=self.scatter_impl,
            mesh=mesh,
        )
        _obs.set_decode_impl(self.impl_plan)
        # speculation is validated before a byte of weights is allocated
        self.spec_gamma, self.spec_mode, self.draft_cfg = 0, None, None
        if speculative is not None:
            self._resolve_speculative(cfg, speculative, draft_params, draft_model_dir)
        self.max_slots = max_slots
        self.max_model_len = max_model_len
        self.pages_per_slot = (max_model_len + page_size - 1) // page_size
        if n_pages is None:
            n_pages = 1 + max_slots * self.pages_per_slot
        self.decode_block = max(1, int(decode_block))
        # under a mesh, the followers build from these settings, as resolved here
        settings = dict(cfg=cfg, weights=_weights_source(params, model_dir), model_dir=model_dir,
                        quantization=quantization, seed=seed, kv_dtype=self.kv_dtype, n_pages=n_pages,
                        page_size=page_size, decode_block=self.decode_block, paged_impl=self.paged_impl,
                        scatter_impl=self.scatter_impl)
        control = control_group(mesh)
        if control[0] is not None:
            share_settings(settings, control)
        self.params, self.cache = _model_state(cfg, params, device=self.device, mesh=mesh,
                                               **{k: settings[k] for k in _STATE_SETTINGS})
        self.prefill_buckets = tuple(b for b in sorted(prefill_buckets) if b <= max_model_len) or (max_model_len,)
        self.prefill_batch = max(1, min(prefill_batch, max_slots))
        self.prefix_cache = PrefixCache(self.cache.allocator, page_size) if enable_prefix_cache else None
        # the tiered prefix cache wraps the trie with host-RAM and Volume
        # spill tiers over the disagg page (de)serialization
        self.tiered = None
        if tiered_prefix and self.prefix_cache is not None:
            from .disagg.tiered_cache import TieredPrefixCache

            kw = dict(tiered_prefix) if isinstance(tiered_prefix, dict) else {}
            self.tiered = TieredPrefixCache(self.cache, self.prefix_cache, **kw)
            self.prefix_cache.spill = self.tiered.spill_pages
        # multimodal serving (models.vlm): checked as the JAX engine checks it
        self.vision_cfg = self.vision_params = None
        if vision is not None:
            self.vision_cfg, self.vision_params = vision
            if self.vision_cfg.llm_dim != cfg.dim:
                raise ValueError(f"vision projector dim {self.vision_cfg.llm_dim} != model dim {cfg.dim}")
            if self.vision_cfg.n_image_tokens >= self.prefill_buckets[-1]:
                raise ValueError(
                    f"n_image_tokens {self.vision_cfg.n_image_tokens} must be < the largest prefill bucket "
                    f"{self.prefill_buckets[-1]} (multimodal prompts do not chunk)"
                )
            if speculative is not None:
                raise ValueError("vision= with speculative= is not supported: the draft model's cache would miss "
                                 "the image-token KV")
        self.decode_steps = resolve_decode_steps(decode_steps)  # read once per dispatch
        self._detok: DetokWorker | None = None  # created at the first routed token
        self.slots = [_Slot() for _ in range(max_slots)]
        self._tenancy_seq = 0  # bumped at every install (scheduler thread only)
        self._clock = clock or time.monotonic
        # progress watermarks (serving/health.py): the watchdog reads them
        # through replica_snapshot
        self.watermarks = EngineWatermarks(clock=self._clock)
        self.trace_name = "engine"  # the replica name on spans, journals and the profiler
        self.profiler = (
            _profiler.HotPathProfiler(clock=self._clock, name=lambda: self.trace_name)
            if _profiler.profiling_enabled(profile) else None
        )
        self._tick = None  # the in-flight TickProfile (None: profiling off, or between ticks)
        # flight recorder: MTPU_TSDB=1 starts the process-wide tsdb sampler
        # once (off the hot path either way), and the incident collector
        # learns about this engine so a capture can snapshot its impl plan
        # and open requests
        _ts.ensure_sampler()
        _incident.register_engine(self)
        self.policy: SchedulerPolicy = policy or FairSharePolicy(clock=self._clock)
        self.admission = admission or AdmissionController(clock=self._clock)
        self._trace_store = trace_store if trace_store is not None else _rt.default_store
        self.stats = EngineStats()
        # the analytic work model is frozen here; the meter shares the
        # engine's clock and takes the card's peaks (none on the CPU)
        self.usage = _usage.EngineUsage(
            _usage.WorkModel.from_engine(cfg, cache=self.cache, weight_bytes=param_bytes(self.params)),
            clock=self._clock, name=lambda: self.trace_name, device=self.device,
        )
        self.admission.usage = self.usage  # sheds are charged to their tenant
        self.error_log: list[str] = []
        self.error_count = 0
        self._stopped_on_error = False
        self._metrics_wall = 0.0  # last gauge refresh (throttled)
        self._counter_flush = {"prompt": 0, "generated": 0, "steps": 0}  # stats flushed into the counters
        # the device calls (prefills, chunks, decode blocks) and the key
        # chain; under a mesh it ships each call to the follower ranks
        self.runner = ModelRunner(
            cfg, self.params, self.cache, device=self.device, seed=seed, decode_block=self.decode_block,
            paged_impl=self.paged_impl, scatter_impl=self.scatter_impl, mesh=mesh, control=control,
        )
        if vision is not None:
            self.runner.vision = vision
        self._seed_base = int(seed)
        self._submit_seq = 0
        self._lock = threading.Lock()
        self._running = False
        self._thread: threading.Thread | None = None
        # the slot-free prefill of a prefill replica (prefill_sync): callers
        # serialize on the lock; the pending count is the router's load signal
        self._prefill_sync_lock = threading.Lock()
        self._prefill_sync_pending = 0
        # control commands run on the scheduler thread (migrate_out)
        self._ctrl: collections.deque = collections.deque()
        self._page_tables = np.zeros((max_slots, self.pages_per_slot), np.int32)

        # the pipelined decode loop: one block in flight ahead of the one
        # being read; each block's last tokens stay on the device and feed
        # the next; the host keeps every slot's optimistic position
        self._device_tokens: torch.Tensor | None = None  # [max_slots] int32, the last block's
        self._opt_positions = np.zeros((max_slots,), np.int32)
        self._override = np.zeros((max_slots,), np.int32)
        self._inflight: collections.deque = collections.deque()  # (landing, macro-step?, snapshot)
        # prefills whose first tokens are still on their way to the host:
        # (landing, rows, meta); read after the next decode dispatch
        self._pending_harvest: collections.deque = collections.deque()
        self._last_dispatch_at: float | None = None  # feeds mtpu_decode_stall_seconds
        # tokens-per-dispatch accounting (the multistep gauges)
        self._ms_dispatches = 0
        self._ms_tokens = 0
        self._ms_flush = {"dispatches": 0, "tokens": 0}
        self._ms_tpd = 0.0

        # speculative decoding: the draft shares the target allocator's page
        # ids and tables, so allocation, prefix sharing and recycling happen
        # once; its weights are the caller's, a checkpoint's or drawn from
        # seed + 1
        if self.spec_mode == "ngram":
            self.ngram_n = 2  # trailing-bigram lookup
            self._ngram_round = build_ngram_round_fn(cfg, gamma=self.spec_gamma)
        elif self.spec_mode == "draft":
            draft = self.draft_cfg
            if draft_params is None:
                if draft_model_dir is not None:
                    draft_params = llama.load_hf_weights(draft_model_dir, draft, device=self.device)
                else:
                    draft_params = llama.init_params(draft, seed=seed + 1, device=self.device)
            self.draft_params = draft_params
            self.draft_cache = dataclasses.replace(
                PagedKVCache.create(
                    n_layers=draft.n_layers, n_kv_heads=draft.n_kv_heads, head_dim=draft.head_dim,
                    n_pages=n_pages, page_size=page_size, kv_dtype=kv_dtype, device=self.device,
                ),
                allocator=self.cache.allocator,
            )
            self.runner.draft = (self.draft_params, self.draft_cache, draft)
            self._spec_round_fn = build_spec_round_fn(
                cfg, draft, paged_impl=self.paged_impl, scatter_impl=self.scatter_impl, gamma=self.spec_gamma,
            )
            # the draft's work, priced as the target's is (the usage meter)
            self._draft_work = _usage.WorkModel.from_engine(
                draft, cache=self.draft_cache, weight_bytes=param_bytes(draft_params))
        # both knobs are runtime-mutable: spec_depth caps each round's γ (0:
        # every round falls back to the decode block), spec_adaptive switches
        # the per-request controller
        self.spec_depth = self.spec_gamma
        self.spec_adaptive = resolve_spec_adaptive(spec_adaptive)
        self._spec_ctrl = AdaptiveGammaController(self.spec_gamma) if self.spec_gamma else None
        # spec round accounting, read by the gauges at the refresh throttle
        self._spec_rounds = 0
        self._spec_round_tokens = 0
        self._spec_fallbacks = 0
        self._spec_flush = {"rounds": 0, "tokens": 0, "fallbacks": 0}
        self._spec_tpd = 0.0
        self._spec_gamma_window: list[int] = []  # dispatched per-slot γs
        self._spec_gamma_p50 = 0.0

    def _resolve_speculative(self, cfg, speculative: tuple, draft_params, draft_model_dir) -> None:
        """``speculative=(draft, γ)`` checked as the JAX engine checks it
        (γ >= 1; "ngram" takes no draft arguments; a draft preset must be
        known; the draft's vocabulary must be the target's), setting
        ``spec_gamma``, ``spec_mode`` and ``draft_cfg``."""
        draft, gamma = speculative
        self.spec_gamma = int(gamma)
        if self.spec_gamma < 1:
            raise ValueError("speculative gamma must be >= 1")
        if draft == "ngram":
            if draft_model_dir is not None or draft_params is not None:
                raise ValueError(
                    "draft_model_dir/draft_params are incompatible with speculative=('ngram', ...): prompt "
                    "lookup uses no draft model; drop them or pick a draft preset"
                )
            self.spec_mode = "ngram"
            return
        if isinstance(draft, str):
            if draft not in MODEL_PRESETS:
                raise ValueError(f"unknown draft preset {draft!r}; known: {sorted(MODEL_PRESETS)} (or 'ngram')")
            draft = MODEL_PRESETS[draft]()
        if draft_model_dir is not None:
            # the checkpoint's own config describes its weights
            draft = llama.LlamaConfig.from_hf_config(f"{draft_model_dir}/config.json")
        if draft.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size {draft.vocab_size} != target {cfg.vocab_size}: speculative accept/reject "
                "compares token distributions and requires a shared vocabulary"
            )
        self.spec_mode, self.draft_cfg = "draft", draft

    # -- helpers ------------------------------------------------------------

    #: how far back a prompt lookup's match may start (prompt_lookup_max's analog)
    NGRAM_LOOKBACK = 1024

    def _ngram_proposals(self, gammas: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Prompt lookup on the host: each slot's trailing n-gram matched
        against its own prompt and generation through its ``_NgramIndex``,
        at most ``gammas[i]`` tokens. Returns (proposals [S, γ], n_prop [S])."""
        gamma = self.spec_gamma
        props = np.zeros((self.max_slots, gamma), np.int32)
        n_prop = np.zeros((self.max_slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s.free or s.ngram is None:
                continue
            budget = min(int(gammas[i]), gamma)
            if budget <= 0:
                continue
            cont = s.ngram.propose(budget)
            if cont:
                props[i, : len(cont)] = cont
                n_prop[i] = len(cont)
        return props, n_prop

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _next_key(self):
        return self.runner.next_key()

    def _stage(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        return self.runner.stage(*arrays)

    def _no_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(f"{what} under tensor parallelism is not ported (ROADMAP A10b)")

    # -- public API ---------------------------------------------------------

    def validate_params(self, params: SamplingParams) -> None:
        """Raise ValueError for parameters the engine rejects (a 400
        upstream). Like the JAX engine it serves every sampling value
        (negative temperatures and top_p <= 0 sample greedily, a top_p above
        1 filters nothing, max_tokens below 1 yields one token, a negative
        seed samples unseeded). The one refusal is a seed outside int32: the
        JAX engine fails such a request while it prefills (an "error", a 500
        upstream)."""
        if params.seed is not None and not -(2**31) <= params.seed < 2**31:
            raise ValueError(f"seed must be in [-2**31, 2**31); got {params.seed}")

    def make_request(
        self, prompt: str, params: SamplingParams | None = None, image=None, *, priority: str = DEFAULT_CLASS,
        tenant: str = "default", trace=_rt.UNSET,
    ) -> Request:
        """Build (but do not enqueue) one validated, tokenized request; its
        deadline arms here. ``trace``: a context an entry point opened (the
        request takes its id), None when the entry point sampled it out, or
        unset to open one here. ``image`` (a PIL image or an [H, W, 3]
        array) makes a multimodal request: its ``n_image_tokens`` placeholder
        ids lead the prompt, the text keeps what is left of the largest
        bucket, and with the prefix cache on its image positions key by the
        image's SHA-256 above the vocabulary (``cache_key_tokens``)."""
        if image is not None and self.vision_cfg is None:
            raise ValueError("engine was built without vision=; cannot take images")
        req = Request(prompt=prompt, params=params or SamplingParams(), priority=validate_class(priority),
                      tenant=tenant)
        self.validate_params(req.params)
        if trace is _rt.UNSET:
            req.trace = _rt.start_request_trace(
                req.request_id, entry=self.trace_name, store=self._trace_store,
                priority=req.priority, tenant=req.tenant,
            )
        elif trace is not None:
            req.request_id = trace.trace_id  # trace id == request id
            req.trace = trace
        if req.params.seed is None:
            with self._lock:
                self._submit_seq += 1
                req.auto_seed = (self._seed_base * 1_000_003 + self._submit_seq) % (2**31 - 1)
        if image is not None:
            self._image_prompt(req, image)
        else:
            # prompts past the largest bucket prefill in chunks; the hard cap
            # is the model length minus one decode position
            req.prompt_tokens = self.tokenizer.encode(prompt)[: self.max_model_len - 1]
        if req.params.deadline_s is not None:
            req.deadline = self._clock() + float(req.params.deadline_s)
        return req

    def _image_prompt(self, req: Request, image) -> None:
        """A multimodal request's prompt: the image preprocessed, its
        placeholder ids first, the text cut to the largest bucket (and the
        model length) less the image tokens (image prompts never chunk)."""
        from ..models import vlm

        req.image = vlm.preprocess_image(image, self.vision_cfg.vision.image_size)
        n_img = self.vision_cfg.n_image_tokens
        budget = min(self.prefill_buckets[-1] - n_img, self.max_model_len - 1 - n_img)
        text = self.tokenizer.encode(req.prompt)[:budget]
        req.prompt_tokens = [self.tokenizer.pad_id % self.cfg.vocab_size] * n_img + text
        if self.prefix_cache is not None:
            # one content id repeated (the trie's depth already encodes the
            # position), above the vocabulary so it never meets a text key
            digest = hashlib.sha256(np.asarray(req.image).tobytes()).digest()
            req.cache_key_tokens = [self.cfg.vocab_size + int.from_bytes(digest[:8], "little")] * n_img + text

    def request_cost(self, req: Request) -> int:
        """KV pages ``req`` claims (admission's reservation unit): its prompt
        and generation budget."""
        return self.cache.pages_for(min(len(req.prompt_tokens) + req.params.max_tokens, self.max_model_len))

    def submit_request(self, req: Request) -> Request:
        """Enqueue a :meth:`make_request`-built request through admission
        control, which raises ``ShedError`` (HTTP 429 upstream) or reserves
        its pages."""
        entry = ScheduledRequest(
            payload=req, priority=req.priority, tenant=req.tenant, cost=self.request_cost(req),
            deadline=req.deadline, enqueued_at=self._clock(),
        )
        occ = self.cache.occupancy()
        try:
            self.admission.admit(entry, depths=self.policy.depths(), pages_used=occ["pages_used"],
                                 pages_total=occ["pages_total"])
        except ShedError as e:
            _rt.event(req.trace, "shed", store=self._trace_store, replica=self.trace_name, reason=e.reason)
            _rt.finish_root(req.trace, "shed", store=self._trace_store, finish_reason="shed")
            raise
        req.sched_entry = entry
        req.queue_span = _rt.begin(req.trace, "queue", replica=self.trace_name, priority=req.priority,
                                   tenant=req.tenant)
        self.policy.submit(entry)
        return req

    def submit(
        self, prompt: str, params: SamplingParams | None = None, image=None, *, priority: str = DEFAULT_CLASS,
        tenant: str = "default", trace=_rt.UNSET,
    ) -> Request:
        """Enqueue one request: ``priority`` (interactive, default, batch) and
        ``tenant`` drive the fair-share policy, ``params.deadline_s`` arms a
        deadline, ``image`` makes it multimodal (:meth:`make_request`).
        Raises ``ShedError`` when admission rejects it."""
        return self.submit_request(
            self.make_request(prompt, params, image, priority=priority, tenant=tenant, trace=trace))

    def generate(self, prompt: str, params: SamplingParams | None = None) -> str:
        """Blocking convenience: submit and collect the full completion."""
        return "".join(self.stream(self.submit(prompt, params)))

    def stream(self, req: Request):
        """Yield text pieces as they decode; sets ``req.finish_reason`` at the end."""
        if not self._running:
            self.start()
        while True:
            item = req.out_queue.get()
            if isinstance(item, _Finish):
                req.finish_reason = item.reason
                return
            yield item

    def abort(self, request: Request) -> None:
        """Cancel a request: a queued one leaves the policy now (its page
        reservation released, its stream finished), an active one at the
        next scheduler tick (its slot and pages are freed there)."""
        request.aborted = True
        entry = request.sched_entry
        if entry is not None and self.policy.remove(entry):
            self.admission.release(entry)
            _obs.set_sched_queue_depths(self.policy.depths())
            self._finish_stream(request, _FINISH)

    # -- disaggregated prefill/decode (serving/disagg) -------------------------

    def prefill_sync(self, req: Request) -> dict:
        """Prefill ``req`` without a decode slot: claim its pages, fill their
        KV (bucketed or chunked), sample the first token, and return the
        claim and sampler state for :meth:`extract_request_pages`, the
        prefill replica's half of disaggregated serving. Only legal while the
        scheduler loop is not running (a prefill replica never starts its
        loop); concurrent callers serialize on a lock."""
        self._no_mesh("a slot-free prefill (disaggregated serving)")
        if req.image is not None:
            raise ValueError("multimodal requests do not take the disagg prefill path (image-token KV keys by "
                             "content hash, not position)")
        self._prefill_sync_pending += 1
        turn = _TURNS.acquire()
        try:
            return self._prefill_sync_locked(req)
        finally:
            if turn:
                _TURNS.release()
            self._prefill_sync_pending -= 1

    def _prefill_sync_locked(self, req: Request) -> dict:
        with self._prefill_sync_lock:
            if self._running:
                raise RuntimeError(
                    "prefill_sync requires a stopped engine: prefill-role replicas never start their scheduler loop"
                )
            claim = self._claim_pages(req)
            if claim is None:
                raise OutOfPages(f"prefill replica out of KV pages for {req.request_id}")
            t_start, t_wall = time.monotonic(), time.time()
            u_start = self._clock()
            try:
                first = self._prefill_pages(req, claim)
            except Exception:
                # a failed prefill must not leak the claim or leave unwritten pages in the trie
                self.release_claim(claim, valid=False)
                raise
            self.stats.prompt_tokens += claim["n_prompt"]
            self.usage.note_prompt(req, claim["n_prompt"])
            self.usage.note_phase_seconds("prefill", self._clock() - u_start)
            _obs.record_engine_phase("prefill", time.monotonic() - t_start)
            _rt.record_span(req.trace, "prefill", start=t_wall, parent=req._trace_parent, store=self._trace_store,
                            replica=self.trace_name, n_prompt=claim["n_prompt"])
            return {
                "claim": claim,
                "position": claim["n_prompt"],
                "first_token": first,
                # only pages holding prompt KV ship; the decode side
                # allocates its growth pages empty
                "n_kv_pages": self.cache.pages_for(claim["n_prompt"]),
            }

    def _prefill_pages(self, req: Request, claim: dict) -> int:
        """Fill ``claim``'s pages with ``req``'s prompt KV and sample the
        first token, touching no slot: a bucketed prompt rides row 0 of the
        ``(prefill_batch, bucket)`` prefill the slot path runs, a longer one
        its chunks. Returns the first token (read at once)."""
        pages, n_prompt = claim["pages"], claim["n_prompt"]
        table = np.zeros((self.pages_per_slot,), np.int32)
        table[: len(pages)] = pages
        if n_prompt > self.prefill_buckets[-1]:
            for offset in range(0, n_prompt, self.prefill_buckets[-1]):
                self._dispatch_prefill_chunk(-1, req.prompt_tokens, table, offset)
            first = self._sample_first(-1, req)
        else:
            first = self._prefill_rows(self._bucket_for(n_prompt), [(req, table)])
        return int(first.cpu()[0])

    def release_claim(self, claim: dict, *, valid: bool = True) -> None:
        """Free a slot-free page claim. ``valid=True``: the pages hold real
        KV, so trie pages stay cached (the prefill replica's prefix cache
        keeps warming) and private pages are freed. ``valid=False``: the
        prefill never completed, and the claim unwinds."""
        if not valid:
            self._unwind_claim(claim)
        elif self.prefix_cache is not None:
            self.prefix_cache.release(claim["trie_pages"])
            self.cache.allocator.free(claim["private_pages"])
        else:
            self.cache.allocator.free(claim["pages"])

    def extract_request_pages(self, req: Request, state: dict):
        """The prefilled pages of a :meth:`prefill_sync` result as a
        wire-ready :class:`~.disagg.transport.PageBlock` (every cache leaf,
        the prompt's chained block hashes, the sampler meta)."""
        from .disagg.transport import chain_hashes, extract_pages

        self._no_mesh("extracting a request's pages")
        used = state["claim"]["pages"][: state["n_kv_pages"]]
        return extract_pages(
            self.cache, used,
            block_hashes=chain_hashes(req.cache_key_tokens or req.prompt_tokens, self.cache.page_size),
            meta={
                "request_id": req.request_id,
                "prompt_tokens": [int(t) for t in req.prompt_tokens],
                "position": int(state["position"]),
                "first_token": int(state["first_token"]),
                "auto_seed": req.auto_seed,
                # the trace context rides the envelope: a decode replica in
                # another process keeps stitching the same trace
                "trace": _rt.wire(req.trace, parent=req._trace_parent),
            },
        )

    def submit_adopted(self, req: Request, entry, block) -> Request:
        """Queue a request whose prompt KV was prefilled elsewhere.
        ``block`` (a deserialized ``PageBlock``) is adopted at admission on
        the scheduler thread and decode continues from the migrated
        position. ``entry`` is the admission reservation the coordinator
        took on this engine before any byte moved."""
        self._no_mesh("adopting another engine's pages")
        if block.kv_dtype != self.cache.kv_dtype:
            raise ValueError(
                f"migrated block is {block.kv_dtype}, this cache is {self.cache.kv_dtype}: "
                "disagg peers must share a kv_dtype"
            )
        req._adopted_state = {
            "block": block,
            "position": int(block.meta["position"]),
            "first_token": int(block.meta["first_token"]),
            # the decode-state leg of a live-migrated mid-decode block
            "resume": block.meta.get("resume"),
        }
        req.sched_entry = entry
        req.queue_span = _rt.begin(req.trace, "queue", replica=self.trace_name, priority=req.priority,
                                   tenant=req.tenant)
        self.policy.submit(entry)
        return req

    # -- in-flight request failover (serving/failover.py) ----------------------

    def submit_resumed(self, req: Request, *, prompt_tokens, generated, emitted_len: int = 0) -> Request:
        """Queue a request resumed from a decode checkpoint; its stream
        continues here, token-identical to the uninterrupted run.
        ``prompt_tokens`` is the ORIGINAL prompt, ``generated`` the tokens
        accepted before the failure. The prompt is prefilled again, the
        generated prefix but its last token replayed through the decode body
        (:meth:`_replay_decode_prefix`), and the last token fed at its
        original position through the override lane. Sampling is keyed by
        (seed, position) and the request keeps its seed, so every later
        token is the uninterrupted stream's; emission resumes at
        ``emitted_len``. The same request object (id, out_queue, trace) rides
        through, so a blocked ``stream()`` consumer continues."""
        if req.image is not None:
            raise ValueError("multimodal requests do not take the failover resume path")
        if req.aborted:
            # a client abort landed in the failover window: honor it
            self._finish_stream(req, _Finish("deadline" if req.deadline_expired else "stop"))
            return req
        req.finish_reason = None
        base = [int(t) for t in prompt_tokens]
        gen = [int(t) for t in generated]
        req._orig_prompt_tokens = base
        req.generated_tokens = gen
        req.emitted_len = int(emitted_len)
        req.n_generated = max(req.n_generated, len(gen))
        req.cache_key_tokens = None
        req.created = time.monotonic()
        if gen and (len(gen) >= req.params.max_tokens or len(base) + len(gen) >= self.max_model_len):
            # the failure landed on the last token: nothing left to decode
            self._finish_stream(req, _Finish("length"))
            return req
        req.prompt_tokens = list(base)
        req._resume_state = {"replay": gen} if gen else None
        return self.submit_request(req)

    def migrate_out(self, req: Request, *, timeout: float = 30.0):
        """Detach ``req`` for a live migration, on the scheduler thread.
        Returns ``("block", PageBlock)`` for a request mid-decode (its KV
        pages for [0, position) with the decode-state leg in the meta; the
        slot is released, trie pages staying cached), ``("requeue", None)``
        for one still queued or mid-prefill (nothing to ship: the caller
        resubmits the prompt), or ``("gone", None)``. Raises when the loop
        is stopped or unresponsive: the caller falls back to the reactive
        resume."""
        self._no_mesh("a live migration")
        return self._run_on_scheduler(lambda: self._migrate_out_on_sched(req), timeout)

    def _migrate_out_on_sched(self, req: Request):
        from .disagg.transport import chain_hashes, extract_pages

        entry = req.sched_entry
        if entry is not None and self.policy.remove(entry):
            # still queued: the reservation goes back, the caller resubmits elsewhere
            self.admission.release(entry)
            req.sched_entry = None
            _obs.set_sched_queue_depths(self.policy.depths())
            self._close_queue_span(req)
            return ("requeue", None)
        for i, s in enumerate(self.slots):
            if s.request is not req:
                continue
            if req.aborted:
                return ("gone", None)
            if s.prefill is not None or s.pending_first:
                # mid-prefill: partial KV must neither ship nor stay cached;
                # nothing was emitted, so a fresh submission is token-identical
                self._unwind_slot(s)
                return ("requeue", None)
            if s.replay is not None:
                # mid-replay: the rest of the generated prefix first, so the
                # KV covers every accepted token but the last
                self._replay_decode_prefix(i, len(s.replay))
            # mid-decode: KV for [0, position) is complete (each accepted
            # token's predecessor was fed by a block already read); blocks
            # still in flight write positions >= position only, which the
            # target overwrites as it decodes. The gather queues behind them
            # on the stream.
            if self._detok is not None and self._detok.owns(req):
                # the emitted cursor must be final before it ships
                self._detok.flush(timeout=5.0)
            n_kv = self.cache.pages_for(s.position)
            base = req._orig_prompt_tokens if req._orig_prompt_tokens is not None else req.prompt_tokens
            covered = list(base) + [int(t) for t in req.generated_tokens[:-1]]
            block = extract_pages(
                self.cache, s.pages[:n_kv],
                block_hashes=chain_hashes(covered, self.cache.page_size),
                meta={
                    "request_id": req.request_id,
                    "prompt_tokens": [int(t) for t in base],
                    "position": int(s.position),
                    "first_token": int(s.last_token),
                    "auto_seed": req.auto_seed,
                    "resume": {
                        "generated": [int(t) for t in req.generated_tokens],
                        "emitted_len": int(req.emitted_len),
                    },
                    "trace": _rt.wire(req.trace),
                },
            )
            sp = req.decode_span
            if sp is not None:
                req.decode_span = None
                _rt.finish(req.trace, sp, store=self._trace_store)
            # valid KV: trie pages stay cached, private pages are freed
            self._release_slot_pages(s)
            return ("block", block)
        return ("gone", None)

    # -- lifecycle ----------------------------------------------------------------

    def start(self) -> "LLMEngine":
        with self._lock:
            if self.runner.closed:
                raise RuntimeError("a stopped tensor-parallel engine has released its followers")
            if self._stopped_on_error:
                raise RuntimeError(
                    "engine stopped after a scheduler error; last traceback:\n"
                    + (self.error_log or ["?"])[-1]
                )
            if not self._running:
                # starting is progress: a revived engine must not show the
                # watchdog its previous life's stale watermarks
                self.watermarks.note_start()
                self._running = True
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()
        return self

    def revive(self) -> "LLMEngine":
        """Clear the stopped-on-error poison so :meth:`start` may run again
        (the router's re-probe, ``EngineReplica.probe``). Stopping on error
        already released every caller and freed every slot, so a revived
        engine starts empty; ``error_log`` stays for diagnosis."""
        self._no_mesh("reviving an engine")
        with self._lock:
            self._stopped_on_error = False
        return self

    def stop(self, *, reason: str = "stop") -> None:
        """Stop the scheduler and release every caller (partial output for
        in-flight requests, finish_reason ``reason``), then flush the
        counters, the usage meter and the profiler's gauge.
        ``reason="error"`` (the watchdog's wedged-scheduler rung, a fleet
        reap) also poisons the engine until :meth:`revive`, and live streams
        take the reactive failover instead of ending as a truncated "stop"."""
        if reason == "error":
            self._stopped_on_error = True
        self._running = False
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=60)
        if self._detok is not None:
            # drain held text BEFORE the release sweep: its direct markers
            # must land behind every chunk the worker still owes
            self._detok.stop()
        self._release_all(_FINISH if reason == "stop" else _Finish(reason))
        self._flush_token_counters()
        self.usage.flush()
        if self.profiler is not None:
            self.profiler.flush()
        # a tensor-parallel engine's stop releases its followers: it is final
        self.runner.close()

    # -- scheduler loop -------------------------------------------------------

    def _loop(self) -> None:
        try:
            while self._running:
                try:
                    worked = self.step()
                except _inject.FaultError:
                    # an injected scheduler crash: every caller, in flight
                    # and queued, ends with "error" and the loop lives on
                    # (a fault is not a scheduler-logic error: no poison)
                    for s in self.slots:
                        if s.request is not None:
                            _rt.event(s.request.trace, "fault", store=self._trace_store, replica=self.trace_name,
                                      point="engine.scheduler_crash")
                    self._release_all(_Finish("error"))
                    worked = False
                except Exception:
                    # a scheduler-logic error: record it, poison the engine
                    # and release every caller with finish_reason="error"
                    # (loud, never swallowed)
                    tb = traceback.format_exc()
                    self.error_log.append(tb)
                    self.error_count += 1
                    del self.error_log[:-20]
                    LLMEngine._error_reports.append(tb[-800:])
                    del LLMEngine._error_reports[:-50]
                    _obs.record_scheduler_error()
                    self._stopped_on_error = True
                    self._running = False
                    # capture BEFORE the release sweep frees the slots: the
                    # bundle's open-request traces are the victims
                    _incident.capture(
                        "scheduler_crash",
                        reason=tb.strip().splitlines()[-1] if tb else "",
                        replica=self.trace_name,
                    )
                    self._release_all(_Finish("error"))
                    return
                if not worked:
                    time.sleep(0.002)
        finally:
            if self._running:
                # the thread is dying without stop() (a BaseException): the
                # callers get finish_reason="error" instead of a stream that
                # nothing feeds, and the engine is poisoned
                self._running = False
                self._stopped_on_error = True
                _incident.capture(
                    "scheduler_crash",
                    reason="scheduler thread died without stop()",
                    replica=self.trace_name,
                )
                self._release_all(_Finish("error"))

    def _release_all(self, marker: _Finish) -> None:
        while self._ctrl:
            # a stopping or crashed engine must not leave a migration caller waiting
            _fn, out_q = self._ctrl.popleft()
            out_q.put(("err", RuntimeError("engine released all requests")))
        self._inflight.clear()
        self._pending_harvest.clear()
        self._device_tokens = None
        self._last_dispatch_at = None
        for entry in self.policy.drain():
            self.admission.release(entry)
            self._finish_stream(entry.payload, marker)
        for slot in self.slots:
            if not slot.free:
                req = slot.request
                if slot.prefill is not None or slot.pending_first:
                    self._unwind_slot(slot)  # partial KV: never shared
                else:
                    self._release_slot_pages(slot)
                self._finish_stream(req, marker)

    def _release_slot_pages(self, slot: _Slot) -> None:
        """Return a finished slot's pages (its occupancy charged to its
        tenant first): trie pages keep their valid KV cached, the rest go
        back to the allocator; the slot is free after."""
        self._charge_slot_usage(slot)
        if self.prefix_cache is not None:
            self.prefix_cache.release(slot.trie_pages)
            self.cache.allocator.free(slot.private_pages)
        else:
            self.cache.allocator.free(slot.pages)
        self._clear_slot(slot)

    def _unwind_slot(self, slot: _Slot) -> None:
        """:meth:`_release_slot_pages` for a slot whose pages never received
        valid KV (abort, deadline or failure mid-prefill or before its first
        token was harvested): its trie pages are invalidated, so no later
        request shares them, unless another live request holds them; what
        the slot owns alone is freed."""
        self._charge_slot_usage(slot)
        self._unwind_claim({"pages": slot.pages, "trie_pages": slot.trie_pages, "private_pages": slot.private_pages})
        self._clear_slot(slot)

    def _unwind_claim(self, claim: dict) -> None:
        """Invalidate and free a claim whose pages never received valid KV,
        the one ownership rule of the slot paths and the slot-free one: trie
        pages another live request holds stay theirs; what the claim owns
        alone goes back to the allocator."""
        pc = self.prefix_cache
        if pc is not None:
            pc.invalidate(claim["trie_pages"])
            self.cache.allocator.free(
                list(claim["private_pages"]) + [p for p in claim["trie_pages"] if p not in pc._by_page])
        else:
            self.cache.allocator.free(claim["pages"])

    def _clear_slot(self, slot: _Slot) -> None:
        if self._spec_ctrl is not None and slot.request is not None:
            # the controller's acceptance state is per request: it goes with the tenancy
            self._spec_ctrl.forget(slot.request.request_id)
        slot.pages, slot.trie_pages, slot.private_pages = [], [], []
        slot.prefill = None
        slot.pending_first = False
        slot.fresh = False
        slot.spec_hold = False
        slot.replay = None
        slot.ngram = None
        slot.request = None

    def _charge_slot_usage(self, slot: _Slot) -> None:
        """Charge the ending tenancy's occupancy interval (device-seconds and
        KV page-seconds) to its tenant, once."""
        req = slot.request
        if req is not None and slot.claimed_at > 0:
            self.usage.note_slot_release(req, pages=len(slot.pages), held_s=self._clock() - slot.claimed_at)
        slot.claimed_at = 0.0

    def _fail_slot(self, slot: _Slot, req: Request) -> None:
        """A prefill that failed after its dispatch: unwind the slot's claim
        and finish the caller with "error"."""
        self._unwind_slot(slot)
        self._finish_stream(req, _Finish("error"))

    def _fail_claims(self, chunk: list) -> None:
        """:meth:`_fail_slot` for each ``(slot, request, claim)`` of a failed
        prefill group, its slot installed or not."""
        for slot_idx, req, claim in chunk:
            slot = self.slots[slot_idx]
            slot.request = req
            slot.claimed_at = 0.0  # as the JAX engine: a failed group charges no occupancy
            slot.pages, slot.trie_pages, slot.private_pages = claim["pages"], claim["trie_pages"], claim["private_pages"]
            self._fail_slot(slot, req)

    def _finish_stream(self, req: Request, marker: _Finish) -> None:
        """Every terminal marker goes through here: a stream the detok worker
        owns gets its marker queued behind its pending text; the rest are
        delivered at once. Callers free the slot and pages first, so a client
        woken by the marker finds them freed."""
        w = self._detok
        if w is not None and w.alive and w.owns(req):
            w.finish(req, marker)
        else:
            self._deliver_finish(req, marker)

    def _deliver_finish(self, req: Request, marker: _Finish) -> None:
        """The terminal delivery: close the request's trace (sweeping its
        open spans), journal its usage record, then release the caller."""
        _rt.finish_request(req, marker.reason, store=self._trace_store)
        self.usage.note_finish(req, marker.reason)
        req.out_queue.put(marker)

    def _close_queue_span(self, req: Request) -> None:
        """Close the admission-queue span when the scheduler pops the request
        for a slot (terminal paths sweep it instead)."""
        sp = req.queue_span
        if sp is not None:
            req.queue_span = None
            _rt.finish(req.trace, sp, store=self._trace_store, wait_s=round(max(0.0, time.time() - sp.start), 6))

    def _ensure_detok(self) -> DetokWorker:
        """The detokenization worker, created (or replaced, if it died) on
        demand; owned streams re-register from ``req.emitted_len``. It
        detokenizes only: it launches nothing on the card."""
        w = self._detok
        if w is None or not w.alive:
            w = self._detok = DetokWorker(
                tokenizer=self.tokenizer, deliver=self._deliver_finish,
                safe_len=_stop_safe_len, unstable_tail=_unstable_tail, name=self.trace_name,
            )
        return w

    def step(self) -> bool:
        """One scheduler tick: expire deadlines -> admit + prefill -> reap
        aborts, dispatch a decode block, harvest parked first tokens, read
        the oldest block. With the profiler on, the tick's host time is
        partitioned into ``catalog.TICK_PHASES``; idle ticks record nothing."""
        # fault point: a scheduler-thread crash (_loop releases every caller)
        _inject.check("engine.scheduler_crash")
        prof = self.profiler
        tick = None if prof is None else prof.begin_tick()
        self._tick = tick
        if _inject.fire("engine.scheduler_freeze"):
            # fault point: a silent freeze. The thread stays alive and
            # healthy() true, but no tick, dispatch or accept lands again
            # until stop() (the watchdog's wedged rung) ends the hold
            for s in self.slots:
                if s.request is not None:
                    _rt.event(s.request.trace, "fault", store=self._trace_store, replica=self.trace_name,
                              point="engine.scheduler_freeze")
            while self._running:
                time.sleep(0.005)
            self._tick = None
            return False
        turn = _TURNS.acquire()
        try:
            self.watermarks.note_tick()
            self._drain_ctrl()
            _tm(tick, "ctrl")
            self._expire_deadlines()
            _tm(tick, "policy")
            admitted = self._admit()
            decoded = self._decode_tick()
            self._refresh_gauges()
            _tm(tick, "policy")
        finally:
            if turn:
                _TURNS.release()
        if tick is not None:
            self._tick = None
            prof.end_tick(tick, worked=admitted or decoded)
        return admitted or decoded

    def _drain_ctrl(self) -> None:
        """Run the control commands queued for the scheduler thread
        (``migrate_out``); each result or exception goes back to its caller."""
        while self._ctrl:
            fn, out_q = self._ctrl.popleft()
            try:
                out_q.put(("ok", fn()))
            except Exception as e:  # the caller re-raises; the loop lives
                out_q.put(("err", e))

    def _run_on_scheduler(self, fn, timeout: float = 30.0):
        """Run ``fn`` on the scheduler thread (the one that owns the cache
        and the stream order of its writes) and return its result. Raises
        RuntimeError when the loop is not running and TimeoutError when it
        stops serving commands: callers fall back to the reactive path."""
        if not self._running:
            raise RuntimeError("engine scheduler is not running")
        out_q: queue.Queue = queue.Queue()
        self._ctrl.append((fn, out_q))
        try:
            status, val = out_q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"scheduler did not service the control command in {timeout}s") from None
        if status == "err":
            raise val
        return val

    def _expire_deadlines(self) -> None:
        """Queued work past its deadline is cancelled before it takes a slot
        (its page reservation released); in-flight work is aborted, so this
        tick's decode reaps the slot and frees its pages."""
        now = self._clock()
        for entry in self.policy.expired(now):
            self.admission.release(entry)
            entry.payload.deadline_expired = True
            _obs.record_deadline_miss("queued")
            self._finish_stream(entry.payload, _Finish("deadline"))
        for s in self.slots:
            req = s.request
            if req is not None and req.deadline is not None and not req.aborted and now >= req.deadline:
                req.deadline_expired = True
                req.aborted = True
                _obs.record_deadline_miss("prefill" if s.prefill is not None or s.pending_first else "inflight")

    def _refresh_gauges(self) -> None:
        """Engine-load, queue, page and prefix-cache gauges, the macro-step
        gauges, and the token-counter and usage deltas, at most every 0.25 s
        of wall time."""
        now = time.monotonic()
        if now - self._metrics_wall < 0.25:
            return
        self._metrics_wall = now
        depths = self.policy.depths()
        _obs.set_engine_gauges(
            waiting=sum(depths.values()), active_slots=sum(1 for s in self.slots if not s.free),
            tokens_per_second=self.stats.tokens_per_second(),
        )
        _obs.set_sched_queue_depths(depths)
        occ = self.cache.occupancy()
        _obs.set_kv_occupancy(used=occ["pages_used"], free=occ["pages_free"], total_usable=occ["pages_total"])
        _obs.set_kv_cache_bytes(occ["bytes_total"], self.cache.kv_dtype)
        if self.prefix_cache is not None:
            _obs.set_prefix_cache_pages(self.prefix_cache.cached_pages)
        _obs.set_prefill_backlog(sum(
            max(0, len(s.request.prompt_tokens) - s.prefill.offset)
            for s in self.slots if s.prefill is not None and s.request is not None
        ))
        d = self._ms_dispatches - self._ms_flush["dispatches"]
        if d > 0:
            self._ms_tpd = (self._ms_tokens - self._ms_flush["tokens"]) / d
            self._ms_flush = {"dispatches": self._ms_dispatches, "tokens": self._ms_tokens}
        _obs.set_multistep_gauges(
            decode_steps=max(1, int(self.decode_steps)), tokens_per_dispatch=self._ms_tpd,
            detok_queue_depth=self._detok.queue_depth() if self._detok is not None else 0,
        )
        if self.spec_gamma:
            # the dispatched γs' p50 over the window, tokens per spec round
            # (held when idle), lifetime acceptance, the fallback delta
            d = self._spec_rounds - self._spec_flush["rounds"]
            if d > 0:
                self._spec_tpd = (self._spec_round_tokens - self._spec_flush["tokens"]) / d
            fb = self._spec_fallbacks - self._spec_flush["fallbacks"]
            if d > 0 or fb > 0:
                self._spec_flush = {"rounds": self._spec_rounds, "tokens": self._spec_round_tokens,
                                    "fallbacks": self._spec_fallbacks}
            gw = self._spec_gamma_window
            if gw:
                self._spec_gamma_p50 = float(np.median(gw))
                del gw[:]
            _obs.set_spec_gauges(gamma=self._spec_gamma_p50, tokens_per_dispatch=self._spec_tpd,
                                 acceptance_rate=self.stats.acceptance_rate())
            if fb > 0:
                _obs.record_spec_fallback(fb)
        self._flush_token_counters()
        self.usage.flush()

    def _flush_token_counters(self) -> None:
        """Push the stats deltas since the last flush into the token counters
        (also from ``stop()``, so the last window reaches the registry)."""
        s, last = self.stats, self._counter_flush
        _obs.record_token_totals(
            prompt=s.prompt_tokens - last["prompt"], generated=s.generated_tokens - last["generated"],
            steps=s.steps - last["steps"],
        )
        self._counter_flush = {"prompt": s.prompt_tokens, "generated": s.generated_tokens, "steps": s.steps}

    # -- admission and prefill ------------------------------------------------

    def _admit(self) -> bool:
        """Claim slots and pages for policy-ordered requests, then dispatch
        their prefills: bucketed prompts in batches of ``prefill_batch``,
        longer ones as sliced prefills. Under ``prefill_budget`` sliced
        prefills in flight resume first, then entries convert while budget
        remains (a short prompt charges its length up front, a long one per
        chunk); the rest go back to the front of their queues, reservations
        kept. Every first token is parked for ``_harvest_prefills``."""
        tick = self._tick
        budget = self.prefill_budget or None  # None: unlimited
        spent = self._advance_pending_prefills(budget, 0)
        _tm(tick, "prefill_resume")
        free = [i for i, s in enumerate(self.slots) if s.free]
        entries = self.policy.next_batch(len(free)) if free and (budget is None or spent < budget) else []
        now = self._clock()
        assigned: list[tuple[int, Request, dict]] = []
        taken = 0  # free slots used (prefills and adoptions)
        adopted_any = False
        for pos, entry in enumerate(entries):
            req = entry.payload
            if budget is not None and spent >= budget and not req.aborted and req._adopted_state is None:
                # budget spent: this entry and the rest still hold their
                # reservations; aborted ones still drain (they cost nothing)
                # and adopted blocks ship ready-made KV (no prefill tokens)
                self.policy.requeue(entries[pos:])
                break
            self.admission.release(entry)  # the reservation becomes a claim, or goes with the request
            req.sched_entry = None
            if req.aborted:
                self._finish_stream(req, _Finish("deadline") if req.deadline_expired else _FINISH)
                continue
            if req._adopted_state is not None:
                # migrated KV arrives as a wire block: adopted here, on the
                # scheduler thread, so its writes queue behind the block in flight
                status = self._admit_adopted(free[taken], req, entry, now)
                if status == "retry":
                    self.admission.reserve(entry)
                    req.sched_entry = entry
                    self.policy.requeue(entries[pos:])
                    break
                if status == "ok":
                    taken += 1
                    adopted_any = True
                continue
            claim = self._claim_pages(req)
            if claim is None:
                # no KV room: this entry and the rest back to the front, in
                # order, with their reservations, until a finish frees pages
                self.admission.reserve(entry)
                req.sched_entry = entry
                self.policy.requeue(entries[pos:])
                break
            _obs.record_sched_queue_wait(entry.priority, max(0.0, now - entry.enqueued_at))
            self._close_queue_span(req)
            assigned.append((free[taken], req, claim))
            taken += 1
            if claim["n_prompt"] <= self.prefill_buckets[-1] or req.image is not None:
                spent += claim["n_prompt"]  # bucketed (and image) prompts prefill at once
        _tm(tick, "admit")
        by_bucket: dict[tuple, list] = {}  # (bucket, multimodal?) -> assignments
        long_ones = []
        for a in assigned:
            if a[2]["n_prompt"] > self.prefill_buckets[-1] and a[1].image is None:  # image prompts are capped
                long_ones.append(a)
            else:
                key = (self._bucket_for(a[2]["n_prompt"]), a[1].image is not None)
                by_bucket.setdefault(key, []).append(a)
        for (bucket, is_mm), group in by_bucket.items():
            for i in range(0, len(group), self.prefill_batch):
                chunk = group[i : i + self.prefill_batch]
                try:
                    self._prefill_group(bucket, chunk, is_mm=is_mm)
                except Exception:
                    # a failed prefill must not leak its claims, hang its
                    # callers or leave never-written pages in the trie
                    traceback.print_exc()
                    self._fail_claims(chunk)
        for a in long_ones:
            try:
                self._prefill_long(*a)
            except Exception:
                traceback.print_exc()
                self._fail_claims([a])
        _tm(tick, "prefill_dispatch")
        if long_ones:
            # new long prompts advance with what is left of the budget
            spent = self._advance_pending_prefills(budget, spent)
            _tm(tick, "prefill_resume")
        return bool(assigned) or adopted_any or spent > 0

    def _admit_adopted(self, slot_idx: int, req: Request, entry, now: float) -> str:
        """Install a migrated request: allocate its whole page budget, adopt
        the shipped block into the leading pages and decode on from the
        migrated position, the migrated token riding the override lane as a
        prefill's first token does. Returns "ok", "retry" (no pages: the
        caller requeues) or "failed" (a corrupt or incompatible block: the
        stream ends with "error" and no slot is used)."""
        from .disagg.transport import TransportError, adopt_pages

        state = req._adopted_state
        block = state["block"]
        n_pages = self.request_cost(req)
        try:
            pages = self.cache.allocator.alloc(n_pages)
        except OutOfPages:
            if self.prefix_cache is None:
                return "retry"
            self.prefix_cache.evict(n_pages)
            try:
                pages = self.cache.allocator.alloc(n_pages)
            except OutOfPages:
                return "retry"
        req._adopted_state = None
        if req.trace is None:
            # a migration from another process: the context rides the block's meta
            req.trace = _rt.from_wire(block.meta.get("trace"), store=self._trace_store)
        t_wall = time.time()
        try:
            adopt_pages(self.cache, block, pages[: block.n_pages])
        except TransportError:
            traceback.print_exc()
            self.cache.allocator.free(pages)
            _rt.record_span(req.trace, "adopt", start=t_wall, status="error", parent=req._trace_parent,
                            store=self._trace_store, replica=self.trace_name)
            self._finish_stream(req, _Finish("error"))
            return "failed"
        _rt.record_span(req.trace, "adopt", start=t_wall, parent=req._trace_parent, store=self._trace_store,
                        replica=self.trace_name, pages=block.n_pages)
        # adopted pages are all private: this replica's trie never saw them
        claim = {"pages": list(pages), "trie_pages": [], "private_pages": list(pages)}
        resume = state.get("resume")
        if resume:
            # a live-migrated request arrives with its accepted history and
            # emitted-text cursor: detokenization, stop strings and
            # max_tokens continue where the source replica left off
            req.generated_tokens = [int(t) for t in resume["generated"]]
            req.emitted_len = int(resume.get("emitted_len", 0))
            req.n_generated = max(req.n_generated, len(req.generated_tokens))
        self._install(slot_idx, req, claim)  # also rebuilds the prompt-lookup index from the history
        slot = self.slots[slot_idx]
        slot.position = state["position"]
        slot.last_token = state["first_token"]
        slot.fresh = True  # the migrated token rides the override lane
        # draft mode: the draft cache's KV never crossed the wire
        slot.spec_hold = self.spec_mode == "draft"
        _obs.record_sched_queue_wait(entry.priority, max(0.0, now - entry.enqueued_at))
        self._close_queue_span(req)
        req.decode_span = _rt.begin(req.trace, "decode", replica=self.trace_name, spec_mode=self.spec_mode or "-")
        if not resume:
            # a first-token block: the token is accepted here, as a local
            # prefill's is at harvest; a mid-decode block's last token was
            # accepted (and its text emitted) on the source replica
            self._accept_token(slot_idx, state["first_token"])
        return "ok"

    def _claim_pages(self, req: Request) -> dict | None:
        """Claim ``req``'s page budget: the longest cached prefix of full
        prompt pages is shared from the trie, the next ones promoted from the
        lower tiers (a tiered engine), the rest allocated (evicting zero-ref
        cached pages under pressure), and the full prompt pages inserted into
        the trie. None when the pages are not there. Runs under the request's
        ambient trace frame, so a fault fired in here (allocator exhaustion,
        tier corruption) and a promotion land on the request's timeline."""
        with _rt.active(req.trace, replica=self.trace_name):
            return self._claim_pages_traced(req)

    def _claim_pages_traced(self, req: Request) -> dict | None:
        # fault point: allocator exhaustion (the slot path requeues;
        # prefill_sync raises OutOfPages and the coordinator falls back)
        if _inject.fire("engine.out_of_pages"):
            return None
        n_prompt = len(req.prompt_tokens)
        n_pages = self.request_cost(req)
        pc = self.prefix_cache
        # an image request keys the trie by its image's content ids
        key_tokens = req.cache_key_tokens or req.prompt_tokens
        shared: list[int] = []
        promoted: list[int] = []
        if pc is not None:
            shared = pc.acquire(key_tokens)[0]
            if self.tiered is not None and shared:
                # page units, as the host and volume counts promote records
                _obs.record_tier_hit("hbm", n=len(shared))
            if self.tiered is not None:
                # consecutive full prompt pages past the trie hit, restored
                # from host RAM or the Volume with their KV written; they
                # join the trie as fresh inserts below
                promoted = self.tiered.promote(key_tokens, n_have=len(shared))
        need = n_pages - len(shared) - len(promoted)
        try:
            fresh = self.cache.allocator.alloc(need)
        except OutOfPages:
            if pc is None:
                return None
            pc.evict(need)  # reclaim zero-ref cached pages and retry
            try:
                fresh = self.cache.allocator.alloc(need)
            except OutOfPages:
                pc.release(shared)
                self.cache.allocator.free(promoted)
                return None
        pages = shared + promoted + fresh
        # trie hits and tier promotions, clamped to the prompt: the last
        # shared page may hold growth positions
        req.cached_prompt_tokens = min(n_prompt, (len(shared) + len(promoted)) * self.cache.page_size)
        trie_pages, private_pages = list(shared), list(promoted) + list(fresh)
        if pc is not None:
            pc.hits += bool(shared)
            pc.misses += not shared
            n_full = n_prompt // self.cache.page_size
            final, displaced = pc.insert(key_tokens, pages[:n_full], len(shared))
            self.cache.allocator.free(displaced)
            trie_pages, private_pages = list(final), pages[n_full:]
            pages = final + private_pages
            if self.tiered is not None:
                self.tiered.register(key_tokens, final)
        return {"pages": pages, "trie_pages": trie_pages, "private_pages": private_pages, "n_prompt": n_prompt}

    def _install(self, slot_idx: int, req: Request, claim: dict) -> np.ndarray:
        """Put ``req`` in a slot under a new tenancy; returns its page-table row."""
        slot = self.slots[slot_idx]
        slot.request = req
        self._tenancy_seq += 1
        slot.tenancy = self._tenancy_seq
        slot.claimed_at = self._clock()
        slot.pages = claim["pages"]
        slot.trie_pages = claim["trie_pages"]
        slot.private_pages = claim["private_pages"]
        slot.generated = req.generated_tokens  # the request's own history
        slot.emitted_text_len = req.emitted_len
        slot.prefill = None
        slot.pending_first = False
        slot.fresh = False
        slot.spec_hold = False
        if self.spec_mode == "ngram":
            slot.ngram = _NgramIndex(self.ngram_n, list(req.prompt_tokens) + list(req.generated_tokens),
                                     self.NGRAM_LOOKBACK)
        table = np.zeros((self.pages_per_slot,), np.int32)  # past the claim: trash page 0
        table[: len(slot.pages)] = slot.pages
        self._page_tables[slot_idx] = table
        return table

    def _prefill_group(self, bucket: int, group: list, is_mm: bool = False) -> None:
        """One batched prefill of up to ``prefill_batch`` prompts padded to
        ``bucket`` (pad rows target the trash page) and its first tokens'
        sampling, dispatched; the first tokens are parked for the harvest.
        ``is_mm``: image prompts, the vision tower and the prefill one step."""
        t_start, t_wall = time.monotonic(), time.time()
        for _slot_idx, req, _claim in group:
            _obs.record_engine_queue_wait(t_start - req.created)
        start = _mark(self.device)
        tables = [(req, self._install(slot_idx, req, claim)) for slot_idx, req, claim in group]
        first = self._prefill_rows(bucket, tables, is_mm=is_mm)
        rows = []
        for i, (slot_idx, req, claim) in enumerate(group):
            self.slots[slot_idx].pending_first = True
            rows.append((slot_idx, req, i, claim["n_prompt"], self.slots[slot_idx].tenancy))
        self._pending_harvest.append(
            (_Landing(first, start), rows,
             {"phase": "prefill", "t_start": t_start, "t_wall": t_wall, "bucket": bucket}))

    def _prefill_rows(self, bucket: int, rows: list, is_mm: bool = False) -> torch.Tensor:
        """Dispatch one batched prefill of up to ``prefill_batch`` prompts,
        each ``(request, page-table row)``, padded to ``bucket`` (pad rows
        target the trash page), and its first tokens' sampling; returns the
        sampled tokens ``[prefill_batch]`` on the device. ``is_mm``: every
        row an image request, its image encoded in the same step (pad rows
        encode a black image)."""
        B = self.prefill_batch
        tokens = np.full((B, bucket), self.tokenizer.pad_id % self.cfg.vocab_size, np.int32)
        tables = np.zeros((B, self.pages_per_slot), np.int32)
        seq_lens = np.ones((B,), np.int32)
        temps = np.ones((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        seeds = np.full((B,), -1, np.int32)
        for i, (req, table) in enumerate(rows):
            tables[i] = table
            n = len(req.prompt_tokens)
            tokens[i, :n] = req.prompt_tokens
            seq_lens[i] = n
            p = req.params
            temps[i], top_ps[i], top_ks[i] = p.temperature, p.top_p, p.top_k
            seeds[i] = _req_seed(req)
        if is_mm:
            S = self.vision_cfg.vision.image_size
            images = np.zeros((B, S, S, 3), np.float32)
            for i, (req, _table) in enumerate(rows):
                images[i] = req.image
            return self.runner.prefill_mm(images, tokens, tables, seq_lens, temps, top_ps, top_ks, seeds)
        return self.runner.prefill(tokens, tables, seq_lens, temps, top_ps, top_ks, seeds)

    def _sample_first(self, slot_idx: int, req: Request) -> torch.Tensor:
        """Sample a chunked prompt's first token from its last chunk's logits
        (keyed by seed and position, so slicing cannot change it)."""
        p = req.params
        return self.runner.sample_first(
            slot_idx, np.array([p.temperature], np.float32), np.array([p.top_p], np.float32),
            np.array([p.top_k], np.int32), np.array([_req_seed(req)], np.int32),
            np.array([len(req.prompt_tokens)], np.int32),
        )

    def _prefill_long(self, slot_idx: int, req: Request, claim: dict) -> None:
        """Install a prompt longer than the largest bucket as a sliced
        prefill: :meth:`_advance_pending_prefills` runs its bucket-sized
        chunks through ``prefill_chunk``, each attending to the pages written
        before it."""
        t_start = time.monotonic()
        _obs.record_engine_queue_wait(t_start - req.created)
        table = self._install(slot_idx, req, claim)
        self.slots[slot_idx].prefill = _PendingPrefill(req=req, table=table, t_start=t_start, t_wall=time.time())

    def _advance_pending_prefills(self, budget: int | None, spent: int) -> int:
        """Dispatch sliced prefills' chunks, slots in index order, until
        ``budget`` prompt tokens went out this tick (None: unlimited). The
        first chunk of an otherwise idle tick always dispatches, so a budget
        below one chunk still progresses. Returns the updated spend."""
        C = self.prefill_buckets[-1]
        for i, s in enumerate(self.slots):
            pp = s.prefill
            if pp is None or s.request is None or s.request.aborted:
                continue  # aborted mid-prefill: the decode tick's reap unwinds it
            n_prompt = len(pp.req.prompt_tokens)
            advanced = False
            try:
                while pp.offset < n_prompt and (budget is None or spent == 0 or spent < budget):
                    start = _mark(self.device)
                    self._dispatch_prefill_chunk(i, pp.req.prompt_tokens, pp.table, pp.offset)
                    if start is not None:
                        pp.spans.append((start, _mark(self.device)))
                    step = min(C, n_prompt - pp.offset)
                    pp.offset += step
                    spent += step
                    advanced = True
                if advanced:
                    pp.ticks += 1
                if pp.offset >= n_prompt:
                    self._finish_sliced_prefill(i, pp)
                elif advanced:
                    # paused mid-prompt: the next decode block runs between its chunks
                    pp.suspensions += 1
                    self.stats.prefill_suspensions += 1
                    _obs.record_prefill_sliced()
            except Exception:
                traceback.print_exc()
                self._fail_slot(s, s.request)
        return spent

    def _dispatch_prefill_chunk(self, slot_idx: int, prompt_tokens: list, table: np.ndarray, offset: int) -> None:
        """One bucket-sized chunk at ``offset``, dispatched; the runner keeps
        its last-token logits (on the device) for the slot's first token."""
        C = self.prefill_buckets[-1]
        chunk = prompt_tokens[offset : offset + C]
        toks = np.full((1, C), self.tokenizer.pad_id % self.cfg.vocab_size, np.int32)
        toks[0, : len(chunk)] = chunk
        self.runner.prefill_chunk(slot_idx, toks, table[None, :], np.array([len(chunk)], np.int32), offset)

    def _finish_sliced_prefill(self, slot_idx: int, pp: _PendingPrefill) -> None:
        """Every chunk dispatched: sample the first token (keyed by seed and
        position, so slicing cannot change it) and park it for the harvest."""
        req = pp.req
        n_prompt = len(req.prompt_tokens)
        start = _mark(self.device)
        first = self._sample_first(slot_idx, req)
        slot = self.slots[slot_idx]
        slot.prefill = None
        slot.pending_first = True
        self._pending_harvest.append((
            _Landing(first, start, pp.spans),
            [(slot_idx, req, 0, n_prompt, slot.tenancy)],
            {"phase": "prefill_chunked", "t_start": pp.t_start, "t_wall": pp.t_wall,
             "chunks": -(-n_prompt // self.prefill_buckets[-1]), "ticks": pp.ticks},
        ))

    def _harvest_prefills(self) -> bool:
        """Read the parked first tokens (after the decode dispatch, so the
        reads overlap the block just queued) and light their slots up through
        the override lane. Slots recycled or aborted while the prefill was in
        flight are skipped by (request, tenancy); a prefill that failed on the
        device unwinds every slot it still owns."""
        tick = self._tick
        worked = False
        while self._pending_harvest:
            landing, rows, meta = self._pending_harvest.popleft()
            u_start = self._clock()
            try:
                first = landing.numpy()  # the prefill's one blocking read
                _tm_device(tick, "harvest")
            except Exception:
                traceback.print_exc()
                for slot_idx, req, _row, _n, tenancy in rows:
                    s = self.slots[slot_idx]
                    if s.request is req and s.tenancy == tenancy:
                        self._fail_slot(s, req)
                continue
            _obs.record_engine_phase(meta["phase"], time.monotonic() - meta["t_start"])
            # the card's span of the prefill; on the CPU the read on the engine's clock
            secs = landing.device_seconds()
            self.usage.note_phase_seconds("prefill", self._clock() - u_start if secs is None else secs)
            u_calls = 1  # batched admissions share one weight stream
            for slot_idx, req, row, n_prompt, tenancy in rows:
                s = self.slots[slot_idx]
                if s.request is not req or s.tenancy != tenancy or req.aborted:
                    continue  # recycled or aborted in flight: the reap owns the unwind
                s.pending_first = False
                self.stats.prompt_tokens += n_prompt
                self.usage.note_prompt(req, n_prompt, calls=u_calls)
                u_calls = 0
                s.position = n_prompt
                rs = req._resume_state
                if rs is not None:
                    # a failover resume: replay the accepted generated prefix
                    # through the decode block body, a slice a tick
                    # (``_replay_tick``), then feed the last accepted token
                    # (the client has it) through the override lane in place
                    # of the prefill's sample, so the next token carries the
                    # uninterrupted run's (seed, position) key
                    replay = rs["replay"]
                    s.replay = [int(t) for t in replay[:-1]] or None
                    s.last_token = int(replay[-1])
                    # draft mode: the replay rebuilt the target's KV only
                    s.spec_hold = self.spec_mode == "draft"
                else:
                    s.last_token = int(first[row])
                s.fresh = True
                worked = True
                if meta["phase"] == "prefill_chunked":
                    sliced = meta["ticks"] > 1
                    _rt.record_span(
                        req.trace, "prefill", start=meta["t_wall"], store=self._trace_store,
                        replica=self.trace_name, n_prompt=n_prompt, chunked=True, chunks=meta["chunks"],
                        sliced=sliced, budget=self.prefill_budget,
                    )
                    if sliced:
                        _rt.record_span(
                            req.trace, "prefill_wait", start=meta["t_wall"], store=self._trace_store,
                            replica=self.trace_name, ticks=meta["ticks"], chunks=meta["chunks"],
                        )
                else:
                    _rt.record_span(
                        req.trace, "prefill", start=meta["t_wall"], store=self._trace_store,
                        replica=self.trace_name, n_prompt=n_prompt, bucket=meta["bucket"],
                    )
                req.decode_span = _rt.begin(req.trace, "decode", replica=self.trace_name,
                                            spec_mode=self.spec_mode or "-")
                if rs is not None:
                    # the fed token was accepted (and its text emitted) before the failure
                    req._resume_state = None
                else:
                    self._accept_token(slot_idx, s.last_token)
            _tm(tick, "accept")
        return worked

    def _replay_tick(self) -> bool:
        """Feed the replaying slots the next slice of their generated
        prefixes, at most ``decode_block`` steps a tick in all, so a long
        replay neither holds the other slots' streams nor stops the
        scheduler's ticks (the watchdog's progress signal) for its whole
        length."""
        budget = self.decode_block
        for i, s in enumerate(self.slots):
            if s.replay is not None and budget > 0:
                budget -= self._replay_decode_prefix(i, budget)
        return budget < self.decode_block

    def _replay_decode_prefix(self, slot_idx: int, n: int) -> int:
        """Rebuild up to ``n`` more positions of a resumed request's
        generated-prefix KV: feed the slot's next replay tokens through the
        decode block's step body (``llama.decode_step`` over all
        ``max_slots`` rows, this one active, the token through the override
        lane), one token a dispatch, advancing its position. The same body
        at the same batch width over the same inputs writes the KV the lost
        replica's decode wrote, bit for bit (a prefill of those positions
        differs by a bf16 rounding and flips greedy near-ties); how the
        replay is sliced over ticks changes no input. The dispatches queue
        on the engine's stream; nothing is read. Returns the steps fed; the
        slot decodes once its replay is empty."""
        s = self.slots[slot_idx]
        S = self.max_slots
        active = np.zeros((S,), bool)
        active[slot_idx] = True
        tokens = np.zeros((S,), np.int32)
        positions = np.zeros((S,), np.int32)
        fed = s.replay[:n]
        for tok in fed:
            tokens[slot_idx] = tok
            positions[slot_idx] = s.position
            self.runner.replay_step(tokens, positions, self._page_tables, active)
            s.position += 1
        s.replay = s.replay[n:] or None
        return len(fed)

    # -- decode -----------------------------------------------------------------

    def _decode_tick(self) -> bool:
        """Reap aborted slots, dispatch a decode block over the decodable
        ones, harvest the parked first tokens, and read the oldest block when
        two are in flight or none is decodable."""
        tick = self._tick
        if _inject.fire("engine.slow_decode"):
            # fault point: one stalled decode tick (latency only)
            for s in self.slots:
                if s.request is not None:
                    _rt.event(s.request.trace, "fault", store=self._trace_store, replica=self.trace_name,
                              point="engine.slow_decode")
            time.sleep(0.05)
        for s in self.slots:
            if not s.free and s.request.aborted:
                req = s.request
                if s.prefill is not None or s.pending_first:
                    self._unwind_slot(s)  # partial KV, or never harvested
                else:
                    self._release_slot_pages(s)
                self._finish_stream(req, _Finish("deadline") if req.deadline_expired else _FINISH)
        _tm(tick, "policy")
        replayed = self._replay_tick()
        if self.spec_gamma:
            return self._spec_tick() or replayed
        live = [i for i, s in enumerate(self.slots) if s.decodable]
        worked = replayed
        if live:
            self._dispatch_block(live)
            worked = True
        else:
            # no decodable slot: a dispatch gap from here on is idleness or
            # prefill, not a stall of running streams
            self._last_dispatch_at = None
            self._idle_watermarks()
        worked = self._harvest_prefills() or worked
        if self._inflight and (len(self._inflight) >= 2 or not live):
            worked = self._process_block() or worked
        return worked

    def _idle_watermarks(self) -> None:
        """No slot is decodable: no dispatch or accept is owed, so both
        watermarks restart here. The watchdog reads them only while a slot
        is decodable; without this, the first look after a slot lights up on
        an idle engine (a resumed request mid-replay) would read the age of
        the last dispatch before the engine went idle."""
        self.watermarks.note_dispatch()
        self.watermarks.note_accept()

    def _dispatch_block(self, live: list[int]) -> None:
        """Queue one decode block over ``live`` at the slots' optimistic
        positions and return before it runs: ``decode_block`` steps, or at
        ``decode_steps`` N > 1 the macro-step program with per-slot budgets
        counted from the optimistic positions (the tokens each slot would
        still accept). Either runs no more steps than the largest budget:
        the JAX engine runs the rows past it too, which the host drops. A
        slot that finishes while the block still decodes it writes only its
        own pages (past its claim, the trash page); a prefill that reuses
        those pages is queued behind the block on the same stream. The snapshot pins (slot, request,
        tenancy), so the host drops the rows of a recycled slot."""
        tick = self._tick
        t0 = time.monotonic()
        if self._last_dispatch_at is not None:
            # dispatch-to-dispatch gap while decodable slots existed
            _obs.record_decode_stall(t0 - self._last_dispatch_at)
        self._last_dispatch_at = t0
        self.watermarks.note_dispatch()
        _obs.record_engine_batch(len(live))
        S = self.max_slots
        active = np.zeros((S,), bool)
        override_mask = np.zeros((S,), bool)
        temps = np.ones((S,), np.float32)  # dead slots: the no-filter defaults
        top_ps = np.ones((S,), np.float32)
        top_ks = np.zeros((S,), np.int32)
        seeds = np.full((S,), -1, np.int32)
        budgets = np.ones((S,), np.int32)
        for i in live:
            s = self.slots[i]
            active[i] = True
            if s.fresh:
                # the first token is host-known; continuing slots feed the
                # previous block's device-resident token
                self._override[i] = s.last_token
                override_mask[i] = True
                self._opt_positions[i] = s.position
                s.fresh = False
            p = s.request.params
            temps[i], top_ps[i], top_ks[i] = p.temperature, p.top_p, p.top_k
            seeds[i] = _req_seed(s.request)
            # remaining max_tokens (counting tokens still in flight) and
            # remaining context, from the optimistic position
            g_opt = len(s.generated) + (int(self._opt_positions[i]) - s.position)
            budgets[i] = max(1, min(s.request.params.max_tokens - g_opt,
                                    (self.max_model_len - 1) - int(self._opt_positions[i])))
        needs_filter = bool(((top_ps < 1.0) | (top_ks > 0)).any())
        n = max(1, int(self.decode_steps))  # runtime-mutable: read once
        nominal = self.decode_block if n <= 1 else n
        # the rows past every slot's budget would all be dropped by the host:
        # they are not dispatched (the JAX engine runs them)
        n_run = min(nominal, int(budgets[live].max()))
        start = _mark(self.device)
        if n <= 1:
            toks, last = self.runner.decode_block(
                self._device_tokens is None, self._override, override_mask, self._opt_positions, self._page_tables,
                active, temps, top_ps, top_ks, seeds, n_run, needs_filter,
            )
            landing, macro = _Landing(toks, start), False
        else:
            self._no_mesh("the macro-step (decode_steps > 1)")
            prev = self._device_tokens
            if prev is None:
                prev = torch.zeros((S,), dtype=torch.int32, device=self.device)
            key = self._next_key()
            override, mask_d, pos_d, tables_d, active_d, temps_d, top_ps_d, top_ks_d, seeds_d, budgets_d = (
                self._stage(self._override, override_mask, self._opt_positions, self._page_tables, active,
                            temps, top_ps, top_ks, seeds, budgets))
            multistep = build_multistep_fn(
                self.cfg, paged_impl=self.paged_impl, scatter_impl=self.scatter_impl,
                eos_id=self.tokenizer.eos_id, n_steps=n,
            )
            toks, valid, last = multistep(
                self.params, self.cache.k_pages, self.cache.v_pages, prev, override, mask_d, pos_d, tables_d,
                active_d, key, temps_d, top_ps_d, top_ks_d, seeds_d, budgets_d, n_run=n_run,
                needs_filter=needs_filter,
            )
            landing, macro = _Landing(torch.stack([toks, valid.to(toks.dtype)]), start), True
            self.runner.last = last
        self._device_tokens = last
        snapshot = [(i, self.slots[i].request, self.slots[i].tenancy) for i in live]
        self._inflight.append((landing, macro, snapshot, (n_run, nominal), None))
        for i in live:
            self._opt_positions[i] += n_run
        self.stats.decode_seconds += time.monotonic() - t0
        _tm(tick, "decode_dispatch")

    def _spec_tick(self) -> bool:
        """The decode tick of a speculating engine: harvest the parked first
        tokens first (nothing is pipelined in spec mode, so slots prefilled
        this tick join the round), give each decodable slot its γ
        (``_slot_gamma``; prompt lookup also cuts it to the lookup's length:
        an empty lookup is not evidence against the request), then run one
        round, or, when no slot speculates, fall back to one decode block
        dispatched and read at once."""
        tick = self._tick
        worked = self._harvest_prefills()
        live = [i for i, s in enumerate(self.slots) if s.decodable]
        if not live:
            self._idle_watermarks()
            return worked
        gammas = np.zeros((self.max_slots,), np.int32)
        batch_fill = len(live) / max(1, self.max_slots)
        # chunked prefills mid-slice or first tokens parked: admission is
        # live, and long rounds would stretch the tick it rides on
        prefill_pressure = bool(self._pending_harvest) or any(s.prefill is not None for s in self.slots)
        for i in live:
            s = self.slots[i]
            s.fresh = False  # rounds feed host tokens directly
            gammas[i] = self._slot_gamma(s, batch_fill, prefill_pressure)
        ngram_props = None
        if self.spec_mode == "ngram":
            ngram_props = self._ngram_proposals(gammas)
            gammas = np.minimum(gammas, ngram_props[1])
        _tm(tick, "admit")  # the round's staging: slot-state bookkeeping
        if not gammas[live].any():
            # nobody speculates: the decode block is cheaper than a γ-shaped
            # verify, so speculation never costs latency. Slots re-enter it
            # through the override lane (a round ends on host-known tokens)
            self._spec_fallbacks += 1
            for i in live:
                self.slots[i].fresh = True
            self._dispatch_block(live)
            worked = self._harvest_prefills() or True
            return self._process_block() or worked
        return self._spec_round(live, gammas, ngram_props) or worked

    def _slot_gamma(self, s: _Slot, batch_fill: float, prefill_pressure: bool) -> int:
        """A slot's proposal budget for the next round (0: the classic lane
        of the same round). Sampled requests never speculate (the accept
        path is not (seed, position)-keyed; the classic lane keeps them
        token-identical to a non-speculative engine), neither does a
        ``spec_hold`` tenancy, and no proposal goes past the request's own
        end."""
        p = s.request.params
        if p.temperature > 0 or s.spec_hold:
            return 0
        cap = max(0, min(int(self.spec_depth), self.spec_gamma))
        if self.spec_adaptive and self._spec_ctrl is not None:
            g = self._spec_ctrl.gamma_for(s.request.request_id, gamma_cap=cap, batch_fill=batch_fill,
                                          prefill_pressure=prefill_pressure)
        else:
            g = cap
        room = min(p.max_tokens - len(s.generated) - 1, (self.max_model_len - 1) - s.position - 1)
        return max(0, min(g, room))

    def _spec_round(self, live: list[int], gammas: np.ndarray, ngram_props=None) -> bool:
        """One speculative round over ``live``: propose (the draft model on
        the card, or the host's lookups), verify and accept in one dispatch,
        queued on ``_inflight`` with its ``spec_meta`` and read at once by
        ``_process_block`` (the next round depends on this one's acceptance).
        The host arrays go to the card in one staged copy."""
        tick = self._tick
        t0 = time.monotonic()
        if self._last_dispatch_at is not None:
            _obs.record_decode_stall(t0 - self._last_dispatch_at)
        self._last_dispatch_at = t0
        self.watermarks.note_dispatch()
        _obs.record_engine_batch(len(live))
        S = self.max_slots
        tokens = np.zeros((S,), np.int32)
        positions = np.zeros((S,), np.int32)
        active = np.zeros((S,), bool)
        temps = np.ones((S,), np.float32)  # dead slots: the no-filter defaults
        top_ps = np.ones((S,), np.float32)
        top_ks = np.zeros((S,), np.int32)
        seeds = np.full((S,), -1, np.int32)
        for i in live:
            s = self.slots[i]
            tokens[i], positions[i], active[i] = s.last_token, s.position, True
            p = s.request.params
            temps[i], top_ps[i], top_ks[i] = p.temperature, p.top_p, p.top_k
            seeds[i] = _req_seed(s.request)
        needs_filter = bool(((top_ps < 1.0) | (top_ks > 0)).any())
        key = self._next_key()
        start = _mark(self.device)
        if self.spec_mode == "ngram":
            props, n_prop = ngram_props
            staged = self._stage(props, n_prop, gammas, tokens, positions, self._page_tables, active, temps, top_ps,
                                 top_ks, seeds)
            toks, valid, _ = self._ngram_round(
                self.params, self.cache.k_pages, self.cache.v_pages, *staged[:7], key, *staged[7:],
                needs_filter=needs_filter,
            )
            proposed = n_prop
        else:
            staged = self._stage(tokens, positions, self._page_tables, active, gammas, temps, top_ps, top_ks, seeds)
            toks, valid, _ = self._spec_round_fn(
                self.params, self.draft_params, self.cache.k_pages, self.cache.v_pages, self.draft_cache.k_pages,
                self.draft_cache.v_pages, *staged[:5], key, *staged[5:], needs_filter=needs_filter,
            )
            # the draft proposes its whole budget (lanes that died at the
            # table's capacity were still paid for)
            proposed = gammas
        self._device_tokens = None  # a round ends on host-known tokens
        landing = _Landing(torch.stack([toks, valid.to(toks.dtype)]), start)
        snapshot = [(i, self.slots[i].request, self.slots[i].tenancy) for i in live]
        rows = self.spec_gamma + 1
        self._inflight.append((landing, True, snapshot, (rows, rows),
                               {"gammas": gammas, "proposed": proposed, "positions": positions}))
        self.stats.decode_seconds += time.monotonic() - t0
        _tm(tick, "decode_dispatch")
        return self._process_block()

    def _note_spec_work(self, meta: dict, taken: dict) -> None:
        """A round's work for the usage meter beyond its accepted tokens: the
        target's weights once (the verify), the verify's chain positions no
        token was accepted from, and the draft's steps (its γ proposals and
        the completion step a lane, its weights once a step with a live
        lane), priced by the decode formulas."""
        self.usage.note_decode_steps(1)
        m = self.usage.model
        flops = nbytes = 0
        d_lanes = d_ctx = 0
        for i, n_taken in taken.items():
            g, pos = int(meta["gammas"][i]), int(meta["positions"][i])
            rejected = range(pos + n_taken, pos + g + 1)  # chain positions past the accepted ones
            flops += m.decode_flops(len(rejected), sum(rejected))
            nbytes += m.decode_bytes(0, sum(rejected))
            if self.spec_mode == "draft" and g:
                d_lanes += g + 1
                d_ctx += sum(range(pos, pos + g + 1))
        if d_lanes:
            dm = self._draft_work
            steps = int(max(meta["gammas"][i] for i in taken)) + 1
            flops += dm.decode_flops(d_lanes, d_ctx)
            nbytes += dm.decode_bytes(steps, d_ctx)
        self.usage.note_spec_work(flops, nbytes)

    def _process_block(self) -> bool:
        """Read the oldest block in flight (its one blocking read) and accept
        each slot's rows: all of a block's, a macro-step's or a speculative
        round's valid prefix, up to the slot's finish. Rows of slots
        finished, recycled or aborted since the dispatch are dropped. A round
        (``spec_meta`` set) counts one step, its proposals and acceptances,
        feeds the controller and ends each slot on a host-known token."""
        tick = self._tick
        landing, macro, snapshot, (n_steps, nominal), spec_meta = self._inflight.popleft()
        t_wait = time.monotonic()
        u_start = self._clock()
        out = landing.numpy()
        _obs.record_engine_phase("decode_wait", time.monotonic() - t_wait)
        # the card's span of the block; on the CPU the read on the engine's clock
        secs = landing.device_seconds()
        self.usage.note_phase_seconds("decode", self._clock() - u_start if secs is None else secs)
        _tm_device(tick, "harvest")
        toks, valid = (out[0], out[1].astype(bool)) if macro else (out, None)
        # a macro-step's rows with no valid lane ran no live step: count the
        # truth; a speculative round is one verify pass
        executed = n_steps if valid is None else int(valid.any(axis=1).sum())
        self.stats.steps += 1 if spec_meta is not None else executed
        if spec_meta is None:
            self.usage.note_decode_steps(executed)
        worked = False
        accepted = 0
        taken_by_slot = {}
        for i, req, tenancy in snapshot:
            s = self.slots[i]
            if s.request is not req or s.tenancy != tenancy or req.aborted:
                continue  # finished or recycled while the block was in flight
            taken = 0
            for k in range(n_steps):
                if s.request is not req or s.tenancy != tenancy:
                    break  # finished mid-block
                if valid is not None and not valid[k, i]:
                    break  # the lane died on the device: the tail rows are holds
                s.position += 1
                s.last_token = int(toks[k, i])
                self._accept_token(i, s.last_token)
                taken += 1
                worked = True
            accepted += taken
            taken_by_slot[i] = taken
            if spec_meta is not None:
                n_p, acc = int(spec_meta["proposed"][i]), max(0, taken - 1)
                self.stats.spec_proposed += n_p
                self.stats.spec_accepted += acc
                _rt.event(req.trace, "spec_verify", store=self._trace_store, replica=self.trace_name,
                          proposed=n_p, accepted=acc, gamma=int(spec_meta["gammas"][i]))
                if s.request is req and s.tenancy == tenancy:
                    if self._spec_ctrl is not None and n_p > 0:
                        # the controller sees what the host accepted (stop
                        # and length cuts included)
                        self._spec_ctrl.observe(req.request_id, n_p, acc)
                    # the next dispatch re-feeds the last accepted token
                    s.fresh = True
            elif valid is not None and taken < n_steps and s.request is req and s.tenancy == tenancy:
                # the device retired the lane but the host did not finish the
                # request: resync through the override lane
                s.fresh = True
        if spec_meta is None:
            self._ms_dispatches += 1
            self._ms_tokens += accepted
            # steps saved against the nominal block: the rows not dispatched
            # and, at N > 1, those whose lanes had all died on the device
            _obs.record_multistep_dispatch(tokens=accepted, steps_saved=nominal - executed)
            if self.profiler is not None:
                self.profiler.note_dispatch_tokens(accepted, steps=int(self.decode_steps))
        else:
            # spec rounds keep their own tokens-per-dispatch series; fallback
            # rounds are counted at their dispatch
            self._spec_rounds += 1
            self._spec_round_tokens += accepted
            gw = self._spec_gamma_window
            gw.extend(int(spec_meta["gammas"][i]) for i, _req, _tenancy in snapshot)
            del gw[:-4096]
            self._note_spec_work(spec_meta, taken_by_slot)
            if self.profiler is not None:
                self.profiler.note_dispatch_tokens(accepted, steps=1)
        self.stats.decode_tokens += accepted
        self.stats.decode_seconds += time.monotonic() - t_wait
        _tm(tick, "accept")
        return worked

    def _accept_token(self, slot_idx: int, token: int) -> None:
        """Book one sampled token: the counters, TTFT/TPOT, eos / max_tokens /
        model-length finish, then the text: on the detok worker while
        ``decode_steps > 1`` or the engine speculates (or for a stream it
        already owns), else inline
        (incremental detokenization with stop strings and hold-back). The
        slot and pages are released before the finish marker."""
        slot = self.slots[slot_idx]
        req = slot.request
        # canary drift injection: flip one accepted token, only on the
        # synthetic probe tenant, so only the golden comparison sees it
        if req.tenant == _CANARY_TENANT and _inject.fire("engine.canary_token_corrupt"):
            token = (token + 1) % self.cfg.vocab_size
        self.stats.generated_tokens += 1
        self.usage.note_token(req, slot.position)
        self.watermarks.note_accept()
        now = time.monotonic()
        if req.first_token_at is None:
            req.first_token_at = now
            if req.tenant != _CANARY_TENANT:
                _obs.record_ttft(now - req.created)
            if req.trace is not None:
                req.trace.root.attrs["ttft_s"] = round(now - req.created, 6)
        elif req.tenant != _CANARY_TENANT:
            _obs.record_tpot(now - req.last_token_at)
        req.last_token_at = now
        req.n_generated += 1
        finished, reason = False, None
        appended = token != self.tokenizer.eos_id
        if not appended:
            finished, reason = True, "stop"
        else:
            slot.generated.append(token)
            if slot.ngram is not None:
                slot.ngram.push(token)  # the prompt-lookup index, O(1)
            if len(slot.generated) >= req.params.max_tokens or slot.position + 1 >= self.max_model_len:
                finished, reason = True, "length"
        w = self._detok
        tick = self._tick
        if self.decode_steps > 1 or self.spec_gamma > 0 or (w is not None and w.owns(req)):
            if w is None or not w.alive:
                w = self._ensure_detok()
            if w.alive:  # else the inline path below
                _tm(tick, "accept")
                if not w.owns(req):
                    prior = slot.generated[:-1] if appended else list(slot.generated)
                    w.register(req, prior, max(slot.emitted_text_len, req.emitted_len))
                if appended:
                    w.feed(req, token)
                _tm(tick, "detokenize")  # the enqueue: the decode runs off-thread
                if finished:
                    # release BEFORE the marker is queued: the worker may
                    # deliver it, and wake the client, at once
                    self._release_slot_pages(slot)
                    self._finish_stream(req, _Finish(reason))
                return
        _tm(tick, "accept")
        text = self.tokenizer.decode(slot.generated)
        _tm(tick, "detokenize")
        for stop_s in req.params.stop:
            idx = text.find(stop_s)
            if idx >= 0:
                text = text[:idx]
                finished, reason = True, "stop"
                break
        safe_len = len(text) if finished else _stop_safe_len(text, req.params.stop)
        new = text[slot.emitted_text_len : safe_len]
        if new and (finished or not _unstable_tail(new)):
            req.out_queue.put(new)
            slot.emitted_text_len += len(new)
            req.emitted_len = slot.emitted_text_len
        if finished:
            # a client woken by the marker must find the slot and pages freed
            self._release_slot_pages(slot)
            self._finish_stream(req, _Finish(reason))


def follow(cfg, params: dict | None = None, *, mesh, device=None, journal: list | None = None) -> dict:
    """A follower rank of a tensor-parallel engine: receive rank 0's
    resolved settings (``LLMEngine``'s cache size and dtype, decode
    structure, seed and weights' source), make this rank's shards and cache
    from them, then run each device call rank 0 ships until rank 0's engine
    stops. It reads no clock, no environment variable and decides nothing
    (``serving.runner``). ``params`` are the weights rank 0 was given, if it
    was given any; ``device`` is this rank's card. ``journal`` collects the
    calls run. Returns the settings received."""
    import torch.distributed as dist

    tp = mesh_tp_degree(mesh)
    if dist.get_rank() == 0 or tp <= 1:
        raise RuntimeError("follow() runs on the ranks after 0 of a tensor axis wider than 1")
    control = control_group(mesh)
    s = share_settings(None, control)
    if s["cfg"] != cfg:
        raise ValueError(f"this rank's model config differs from rank 0's: {cfg} != {s['cfg']}")
    if _weights_source(params, s["model_dir"]) != s["weights"]:
        raise ValueError(f"rank 0's weights are {s['weights']}; this rank's are {_weights_source(params, s['model_dir'])}")
    device = resolve_device(device)
    params, cache = _model_state(cfg, params, device=device, mesh=mesh, **{k: s[k] for k in _STATE_SETTINGS})
    runner = ModelRunner(
        cfg, params, cache, device=device, seed=s["seed"], decode_block=s["decode_block"],
        paged_impl=s["paged_impl"], scatter_impl=s["scatter_impl"], mesh=mesh, control=control, journal=journal,
    )
    runner.serve_calls()
    return s


def build_engine(model: str = "llama2-7b", model_dir: str | None = None, **engine_kw) -> LLMEngine | None:
    """An engine by preset name, or for the checkpoint in ``model_dir`` (its
    ``config.json``, its weights and, where it has one, its tokenizer).
    With ``mesh=`` every rank of the mesh calls it: rank 0 gets the engine,
    every other rank follows (:func:`follow`) until that engine stops, and
    then gets None."""
    if model_dir is not None:
        cfg = llama.LlamaConfig.from_hf_config(f"{model_dir}/config.json")
    elif model not in MODEL_PRESETS:
        raise ValueError(f"unknown model preset {model!r}; known: {sorted(MODEL_PRESETS)}")
    else:
        cfg = MODEL_PRESETS[model]()
    mesh = engine_kw.get("mesh")
    if mesh is not None and mesh_tp_degree(mesh) > 1:
        import torch.distributed as dist

        if dist.get_rank() != 0:
            follow(cfg, engine_kw.get("params"), mesh=mesh, device=engine_kw.get("device"))
            return None
    return LLMEngine(cfg, model_dir=model_dir, **engine_kw)
