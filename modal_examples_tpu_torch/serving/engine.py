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
the front of their queues with their reservations. A decode block then runs
between a long prompt's chunks. A prefill's first token is read as soon as
its last chunk lands (the JAX engine defers that read behind the next decode
dispatch; tokens are the same either way). Deadlines (``deadline_s``) cancel
queued requests and abort in-flight ones, which finish with "deadline"; a
slot aborted mid-prefill unwinds its claim, invalidating trie pages that were
never fully written.

The decode block: ``decode_block`` decode+sample steps in a Python loop, one
host read of the block's tokens at the end. Each slot's step budget (tokens
left before ``max_tokens`` or the model length) is known on the host, so a
slot stops decoding exactly where it would finish by length.

Sampling is keyed by (request seed, position) exactly as in the JAX engine
(every request carries a seed: the caller's, or one assigned at submit), so
tokens do not depend on batch composition or on how steps are grouped into
blocks.

Quantized serving (``quantization="int8"``: int8 weights through the int8
matmul kernel; ``kv_dtype="int8"``: the int8 paged cache with its decode and
scatter kernels) follows the JAX engine's arguments.

The decode structure (``paged_impl``, ``scatter_impl``; argument, then
``MTPU_PAGED_IMPL``/``MTPU_SCATTER_IMPL``, then "xla") is resolved once and
passed to every ``decode_step``: "xla"/"pallas" attend over read-only pages
with the ragged decode kernel, the writeback impls with the write-then-attend
kernel. ``decode_steps`` (argument, then ``MTPU_DECODE_STEPS``, then 1; read
once per dispatch, so it may change at runtime) above 1 replaces the decode
block with the macro-step program (``serving/multistep``): N steps with
on-device stop and budget masks, one host read of tokens and validity, and
detokenization on a :class:`~.multistep.DetokWorker` thread.

Not in this slice: int4 weights, the pipelined dispatch and the deferred
first-token harvest, the tiered prefix cache, speculative decoding, metrics
and tracing.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import traceback
import uuid

import numpy as np
import torch

from ..models import llama
from ..models.quantize import SUPPORTED as _QUANT_MODES
from ..models.quantize import QuantizedWeight, bits_of, init_quantized_llama, quantize_llama
from ..ops.kv_quant import resolve_kv_dtype
from ..scheduling.admission import AdmissionController
from ..scheduling.policy import DEFAULT_CLASS, FairSharePolicy, ScheduledRequest, SchedulerPolicy, validate_class
from ..utils.device import resolve_device
from ..utils.tokenizer import load_tokenizer
from .kv_cache import OutOfPages, PagedKVCache
from .multistep import DetokWorker, build_multistep_fn, resolve_decode_steps
from .prefix_cache import PrefixCache
from .sampling import SamplingParams, prng_key, sample, split


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
    first_token_at: float | None = None
    n_generated: int = 0  # accepted tokens, eos included
    generated_tokens: list = dataclasses.field(default_factory=list)  # eos excluded
    # engine-assigned when params.seed is None: sampling is derived from
    # (auto_seed, position), never from scheduler timing
    auto_seed: int | None = None
    emitted_len: int = 0  # characters the detokenization worker has sent
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


@dataclasses.dataclass
class _PendingPrefill:
    """A slot's resumable chunked prefill: ``_admit`` advances at most a
    budget's worth of chunks a tick, so a decode block runs between chunks."""

    req: Request
    table: np.ndarray  # the slot's page-table row
    offset: int = 0  # token offset of the next chunk
    ticks: int = 0  # ticks that dispatched at least one chunk
    suspensions: int = 0  # times the budget paused this prefill mid-prompt
    logits: torch.Tensor | None = None  # the last dispatched chunk's logits


@dataclasses.dataclass
class _Slot:
    request: Request | None = None
    pages: list[int] = dataclasses.field(default_factory=list)
    trie_pages: list[int] = dataclasses.field(default_factory=list)  # PrefixCache.release()d
    private_pages: list[int] = dataclasses.field(default_factory=list)  # freed
    position: int = 0  # position of the NEXT token to decode
    last_token: int = 0
    generated: list[int] = dataclasses.field(default_factory=list)
    emitted_text_len: int = 0
    prefill: _PendingPrefill | None = None  # set while the prompt fills chunk by chunk

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def decodable(self) -> bool:
        """Admitted and holding a first token: a slot mid-prefill is not."""
        return self.request is not None and self.prefill is None


@dataclasses.dataclass
class EngineStats:
    steps: int = 0  # decode steps run (each a decode_step over all slots; macro-steps count executed ones)
    decode_seconds: float = 0.0  # host wall time of decode blocks, read included
    decode_tokens: int = 0  # tokens accepted from decode blocks
    prefill_suspensions: int = 0  # chunked prefills paused mid-prompt by the budget


class _Finish:
    """Terminal stream marker carrying the OpenAI finish_reason."""

    __slots__ = ("reason",)

    def __init__(self, reason: str = "stop"):
        self.reason = reason


_FINISH = _Finish("stop")


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


#: the model names ``build_engine`` takes, as the JAX engine's; its MoE
#: presets ("mixtral-8x7b", "tiny-moe") wait for ROADMAP A3
MODEL_PRESETS = {
    "llama2-7b": llama.LlamaConfig.llama2_7b,
    "llama3-8b": llama.LlamaConfig.llama3_8b,
    "llama3.1-8b": llama.LlamaConfig.llama31_8b,
    "llama3.2-1b": llama.LlamaConfig.llama32_1b,
    "mistral-7b": llama.LlamaConfig.mistral_7b,
    "tiny": llama.LlamaConfig.tiny,
}
_MOE_PRESETS = ("mixtral-8x7b", "tiny-moe")


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
        quantization: str | None = None,  # "int8": weight-only int8 serving
        seed: int = 0,
        kv_dtype=None,  # "int8": the quantized paged cache; None: MTPU_KV_DTYPE, then bf16
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
        clock=None,  # monotonic clock of deadlines and the policy (fake clocks in tests)
    ):
        self.device = resolve_device(device)
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
        given_int8 = params is not None and isinstance(params["layers"][0]["wq"], QuantizedWeight)
        # validates both impl names before a byte is allocated
        self.impl_plan = llama.paged_impl_plan(
            cfg, self.device, self.kv_dtype,
            "int8" if quantization == "int8" or given_int8 else None,
            impl=self.paged_impl, scatter_impl=self.scatter_impl,
        )
        if params is None:
            if model_dir is not None:
                # int8 is quantized on the host: the bf16 weights never reach the card
                params = llama.load_hf_weights(model_dir, cfg, quantization=quantization, device=self.device)
            elif quantization is not None:
                # drawn and quantized layer by layer: no resident bf16 tree
                params = init_quantized_llama(cfg, seed=seed, bits=bits_of(quantization), device=self.device)
            else:
                params = llama.init_params(cfg, seed=seed, device=self.device)
        elif quantization is not None:
            params = quantize_llama(params, bits=bits_of(quantization))
        self.params = params
        self.max_slots = max_slots
        self.max_model_len = max_model_len
        self.pages_per_slot = (max_model_len + page_size - 1) // page_size
        if n_pages is None:
            n_pages = 1 + max_slots * self.pages_per_slot
        self.cache = PagedKVCache.create(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            n_pages=n_pages, page_size=page_size, kv_dtype=kv_dtype, device=self.device,
        )
        self.prefill_buckets = tuple(b for b in sorted(prefill_buckets) if b <= max_model_len) or (max_model_len,)
        self.prefill_batch = max(1, min(prefill_batch, max_slots))
        self.prefix_cache = PrefixCache(self.cache.allocator, page_size) if enable_prefix_cache else None
        self.decode_block = max(1, int(decode_block))
        self.decode_steps = resolve_decode_steps(decode_steps)  # read once per dispatch
        self._detok: DetokWorker | None = None  # created at the first routed token
        self.slots = [_Slot() for _ in range(max_slots)]
        self._clock = clock or time.monotonic
        self.policy: SchedulerPolicy = policy or FairSharePolicy(clock=self._clock)
        self.admission = admission or AdmissionController(clock=self._clock)
        self.stats = EngineStats()
        self.error_log: list[str] = []
        self._stopped_on_error = False
        self._key = prng_key(seed, self.device)
        self._seed_base = int(seed)
        self._submit_seq = 0
        self._lock = threading.Lock()
        self._running = False
        self._thread: threading.Thread | None = None
        self._page_tables = np.zeros((max_slots, self.pages_per_slot), np.int32)

    # -- helpers ------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _next_key(self):
        keys = split(self._key, 2)
        self._key = keys[0]
        return keys[1]

    def _dev(self, array, dtype=None):
        return torch.as_tensor(array, dtype=dtype).to(self.device)

    # -- public API ---------------------------------------------------------

    def validate_params(self, params: SamplingParams) -> None:
        """Raise ValueError for parameters the engine rejects (a 400 upstream)."""
        if not params.temperature >= 0.0:
            raise ValueError(f"temperature must be >= 0; got {params.temperature}")
        if not 0.0 < params.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]; got {params.top_p}")
        if params.top_k < 0:
            raise ValueError(f"top_k must be >= 0; got {params.top_k}")
        if params.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1; got {params.max_tokens}")
        if params.seed is not None and not 0 <= params.seed < 2**31:
            raise ValueError(f"seed must be in [0, 2**31); got {params.seed}")

    def make_request(
        self, prompt: str, params: SamplingParams | None = None, *, priority: str = DEFAULT_CLASS,
        tenant: str = "default",
    ) -> Request:
        """Build (but do not enqueue) one validated, tokenized request; its
        deadline arms here."""
        req = Request(prompt=prompt, params=params or SamplingParams(), priority=validate_class(priority),
                      tenant=tenant)
        self.validate_params(req.params)
        if req.params.seed is None:
            with self._lock:
                self._submit_seq += 1
                req.auto_seed = (self._seed_base * 1_000_003 + self._submit_seq) % (2**31 - 1)
        # prompts past the largest bucket prefill in chunks; the hard cap is
        # the model length minus one decode position
        req.prompt_tokens = self.tokenizer.encode(prompt)[: self.max_model_len - 1]
        if req.params.deadline_s is not None:
            req.deadline = self._clock() + float(req.params.deadline_s)
        return req

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
        self.admission.admit(entry, depths=self.policy.depths(), pages_used=occ["pages_used"],
                             pages_total=occ["pages_total"])
        req.sched_entry = entry
        self.policy.submit(entry)
        return req

    def submit(
        self, prompt: str, params: SamplingParams | None = None, *, priority: str = DEFAULT_CLASS,
        tenant: str = "default",
    ) -> Request:
        """Enqueue one request: ``priority`` (interactive, default, batch) and
        ``tenant`` drive the fair-share policy, ``params.deadline_s`` arms a
        deadline. Raises ``ShedError`` when admission rejects it."""
        return self.submit_request(self.make_request(prompt, params, priority=priority, tenant=tenant))

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
            self._finish_stream(request, _FINISH)

    def start(self) -> "LLMEngine":
        with self._lock:
            if self._stopped_on_error:
                raise RuntimeError(
                    "engine stopped after a scheduler error; last traceback:\n"
                    + (self.error_log or ["?"])[-1]
                )
            if not self._running:
                self._running = True
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the scheduler and release every caller (partial output for
        in-flight requests, finish_reason "stop")."""
        self._running = False
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=60)
        if self._detok is not None:
            # drain held text BEFORE the release sweep: its direct markers
            # must land behind every chunk the worker still owes
            self._detok.stop()
        self._release_all(_FINISH)

    # -- scheduler loop -------------------------------------------------------

    def _loop(self) -> None:
        while self._running:
            try:
                worked = self.step()
            except Exception:
                # a scheduler-logic error: record it, poison the engine and
                # release every caller with finish_reason="error" (loud, never
                # swallowed)
                tb = traceback.format_exc()
                self.error_log.append(tb)
                LLMEngine._error_reports.append(tb[-800:])
                del LLMEngine._error_reports[:-50]
                self._stopped_on_error = True
                self._running = False
                self._release_all(_Finish("error"))
                return
            if not worked:
                time.sleep(0.002)

    def _release_all(self, marker: _Finish) -> None:
        for entry in self.policy.drain():
            self.admission.release(entry)
            self._finish_stream(entry.payload, marker)
        for slot in self.slots:
            if not slot.free:
                req = slot.request
                if slot.prefill is not None:
                    self._unwind_slot(slot)  # partial KV: never shared
                else:
                    self._release_slot(slot)
                self._finish_stream(req, marker)

    def _release_slot(self, slot: _Slot) -> None:
        """Return a finished slot's pages: trie pages keep their (valid) KV
        cached, the rest go back to the allocator."""
        if self.prefix_cache is not None:
            self.prefix_cache.release(slot.trie_pages)
            self.cache.allocator.free(slot.private_pages)
        else:
            self.cache.allocator.free(slot.pages)
        slot.pages, slot.trie_pages, slot.private_pages = [], [], []
        slot.prefill = None
        slot.request = None

    def _unwind_slot(self, slot: _Slot) -> None:
        """:meth:`_release_slot` for a slot whose pages never received valid
        KV (abort, deadline or failure mid-prefill): its trie pages are
        invalidated, so no later request shares them, unless another live
        request holds them; what the slot owns alone is freed."""
        pc = self.prefix_cache
        if pc is not None:
            pc.invalidate(slot.trie_pages)
            self.cache.allocator.free(slot.private_pages + [p for p in slot.trie_pages if p not in pc._by_page])
        else:
            self.cache.allocator.free(slot.pages)
        slot.pages, slot.trie_pages, slot.private_pages = [], [], []
        slot.prefill = None
        slot.request = None

    def _fail_slot(self, slot: _Slot, req: Request) -> None:
        """A prefill that failed: unwind the slot's claim and finish the
        caller with "error"."""
        self._unwind_slot(slot)
        self._finish_stream(req, _Finish("error"))

    def _fail_claims(self, chunk: list) -> None:
        """:meth:`_fail_slot` for each ``(slot, request, claim)`` of a failed
        prefill group, its slot installed or not."""
        for slot_idx, req, claim in chunk:
            slot = self.slots[slot_idx]
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
        req.out_queue.put(marker)

    def _ensure_detok(self) -> DetokWorker:
        """The detokenization worker, created (or replaced, if it died) on
        demand; owned streams re-register from ``req.emitted_len``."""
        w = self._detok
        if w is None or not w.alive:
            w = self._detok = DetokWorker(
                tokenizer=self.tokenizer, deliver=self._deliver_finish,
                safe_len=_stop_safe_len, unstable_tail=_unstable_tail,
            )
        return w

    def step(self) -> bool:
        """One scheduler tick: expire deadlines -> admit + prefill -> reap
        aborts and run one decode block."""
        self._expire_deadlines()
        admitted = self._admit()
        decoded = self._decode_tick()
        return admitted or decoded

    def _expire_deadlines(self) -> None:
        """Queued work past its deadline is cancelled before it takes a slot
        (its page reservation released); in-flight work is aborted, so this
        tick's decode reaps the slot and frees its pages."""
        now = self._clock()
        for entry in self.policy.expired(now):
            self.admission.release(entry)
            entry.payload.deadline_expired = True
            self._finish_stream(entry.payload, _Finish("deadline"))
        for s in self.slots:
            req = s.request
            if req is not None and req.deadline is not None and not req.aborted and now >= req.deadline:
                req.deadline_expired = True
                req.aborted = True

    # -- admission and prefill ------------------------------------------------

    def _admit(self) -> bool:
        """Claim slots and pages for policy-ordered requests, then prefill:
        bucketed prompts in batches of ``prefill_batch``, longer ones as
        sliced prefills. Under ``prefill_budget`` sliced prefills in flight
        resume first, then entries convert while budget remains (a short
        prompt charges its length up front, a long one per chunk); the rest
        go back to the front of their queues, reservations kept."""
        budget = self.prefill_budget or None  # None: unlimited
        spent = self._advance_pending_prefills(budget, 0)
        free = [i for i, s in enumerate(self.slots) if s.free]
        entries = self.policy.next_batch(len(free)) if free and (budget is None or spent < budget) else []
        assigned: list[tuple[int, Request, dict]] = []
        for pos, entry in enumerate(entries):
            req = entry.payload
            if budget is not None and spent >= budget and not req.aborted:
                # budget spent: this entry and the rest still hold their
                # reservations; aborted ones still drain (they cost nothing)
                self.policy.requeue(entries[pos:])
                break
            self.admission.release(entry)  # the reservation becomes a claim, or goes with the request
            req.sched_entry = None
            if req.aborted:
                self._finish_stream(req, _Finish("deadline") if req.deadline_expired else _FINISH)
                continue
            claim = self._claim_pages(req)
            if claim is None:
                # no KV room: this entry and the rest back to the front, in
                # order, with their reservations, until a finish frees pages
                self.admission.reserve(entry)
                req.sched_entry = entry
                self.policy.requeue(entries[pos:])
                break
            assigned.append((free[len(assigned)], req, claim))
            if claim["n_prompt"] <= self.prefill_buckets[-1]:
                spent += claim["n_prompt"]  # bucketed prompts prefill at once
        by_bucket: dict[int, list] = {}
        long_ones = []
        for a in assigned:
            if a[2]["n_prompt"] > self.prefill_buckets[-1]:
                long_ones.append(a)
            else:
                by_bucket.setdefault(self._bucket_for(a[2]["n_prompt"]), []).append(a)
        for bucket, group in by_bucket.items():
            for i in range(0, len(group), self.prefill_batch):
                chunk = group[i : i + self.prefill_batch]
                try:
                    self._prefill_group(bucket, chunk)
                except Exception:
                    # a failed prefill must not leak its claims, hang its
                    # callers or leave never-written pages in the trie
                    traceback.print_exc()
                    self._fail_claims(chunk)
        for a in long_ones:
            self._prefill_long(*a)
        if long_ones:
            # new long prompts advance with what is left of the budget
            spent = self._advance_pending_prefills(budget, spent)
        return bool(assigned) or spent > 0

    def _claim_pages(self, req: Request) -> dict | None:
        """Claim ``req``'s page budget: the longest cached prefix of full
        prompt pages is shared from the trie, the rest allocated (evicting
        zero-ref cached pages under pressure), and the full prompt pages
        inserted into the trie. None when the pages are not there."""
        n_prompt = len(req.prompt_tokens)
        n_pages = self.request_cost(req)
        pc = self.prefix_cache
        shared = pc.acquire(req.prompt_tokens)[0] if pc is not None else []
        need = n_pages - len(shared)
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
                return None
        pages = shared + fresh
        # clamped to the prompt: the last shared page may hold growth positions
        req.cached_prompt_tokens = min(n_prompt, len(shared) * self.cache.page_size)
        trie_pages, private_pages = list(shared), list(fresh)
        if pc is not None:
            pc.hits += bool(shared)
            pc.misses += not shared
            n_full = n_prompt // self.cache.page_size
            final, displaced = pc.insert(req.prompt_tokens, pages[:n_full], len(shared))
            self.cache.allocator.free(displaced)
            trie_pages, private_pages = list(final), pages[n_full:]
            pages = final + private_pages
        return {"pages": pages, "trie_pages": trie_pages, "private_pages": private_pages, "n_prompt": n_prompt}

    def _install(self, slot_idx: int, req: Request, claim: dict) -> np.ndarray:
        slot = self.slots[slot_idx]
        slot.request = req
        slot.pages = claim["pages"]
        slot.trie_pages = claim["trie_pages"]
        slot.private_pages = claim["private_pages"]
        slot.generated = req.generated_tokens  # the request's own history
        slot.emitted_text_len = 0
        slot.prefill = None
        table = np.zeros((self.pages_per_slot,), np.int32)
        table[: len(slot.pages)] = slot.pages
        self._page_tables[slot_idx] = table
        return table

    def _start_decoding(self, slot_idx: int, first_token: int) -> None:
        slot = self.slots[slot_idx]
        slot.position = len(slot.request.prompt_tokens)
        slot.last_token = first_token
        self._accept_token(slot_idx, first_token)

    def _prefill_group(self, bucket: int, group: list) -> None:
        """One batched prefill of up to ``prefill_batch`` prompts padded to
        ``bucket`` (pad rows target the trash page), then the first tokens."""
        B = self.prefill_batch
        pad_tok = self.tokenizer.pad_id % self.cfg.vocab_size
        tokens = np.full((B, bucket), pad_tok, np.int32)
        tables = np.zeros((B, self.pages_per_slot), np.int32)
        seq_lens = np.ones((B,), np.int32)
        temps = np.ones((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        seeds = np.full((B,), -1, np.int32)
        for i, (slot_idx, req, claim) in enumerate(group):
            tables[i] = self._install(slot_idx, req, claim)
            n = len(req.prompt_tokens)
            tokens[i, :n] = req.prompt_tokens
            seq_lens[i] = n
            p = req.params
            temps[i], top_ps[i], top_ks[i] = p.temperature, p.top_p, p.top_k
            seeds[i] = _req_seed(req)
        logits, _, _ = llama.prefill(
            self.params, self._dev(tokens), self.cache.k_pages, self.cache.v_pages,
            self._dev(tables), self._dev(seq_lens), self.cfg,
        )
        first = sample(
            logits, self._next_key(), self._dev(temps), self._dev(top_ps), self._dev(top_ks),
            seeds=self._dev(seeds), step_ids=self._dev(seq_lens),
            needs_filter=bool(((top_ps < 1.0) | (top_ks > 0)).any()),
        ).cpu().numpy()
        for i, (slot_idx, _req, _claim) in enumerate(group):
            self._start_decoding(slot_idx, int(first[i]))

    def _prefill_long(self, slot_idx: int, req: Request, claim: dict) -> None:
        """Install a prompt longer than the largest bucket as a sliced
        prefill: :meth:`_advance_pending_prefills` runs its bucket-sized
        chunks through ``prefill_chunk``, each attending to the pages written
        before it."""
        table = self._install(slot_idx, req, claim)
        self.slots[slot_idx].prefill = _PendingPrefill(req=req, table=table)

    def _advance_pending_prefills(self, budget: int | None, spent: int) -> int:
        """Dispatch sliced prefills' chunks, slots in index order, until
        ``budget`` prompt tokens went out this tick (None: unlimited). The
        first chunk of an otherwise idle tick always dispatches, so a budget
        below one chunk still progresses. Returns the updated spend."""
        C = self.prefill_buckets[-1]
        for i, s in enumerate(self.slots):
            pp = s.prefill
            if pp is None or s.request.aborted:
                continue  # aborted mid-prefill: the decode tick's reap unwinds it
            n_prompt = len(pp.req.prompt_tokens)
            advanced = False
            try:
                while pp.offset < n_prompt and (budget is None or spent == 0 or spent < budget):
                    pp.logits = self._dispatch_prefill_chunk(pp.req.prompt_tokens, pp.table, pp.offset)
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
            except Exception:
                traceback.print_exc()
                self._fail_slot(s, s.request)
        return spent

    def _dispatch_prefill_chunk(self, prompt_tokens: list, table: np.ndarray, offset: int) -> torch.Tensor:
        """One bucket-sized chunk at ``offset``; returns its last-token logits."""
        C = self.prefill_buckets[-1]
        chunk = prompt_tokens[offset : offset + C]
        toks = np.full((1, C), self.tokenizer.pad_id % self.cfg.vocab_size, np.int32)
        toks[0, : len(chunk)] = chunk
        logits, _, _ = llama.prefill_chunk(
            self.params, self._dev(toks), self.cache.k_pages, self.cache.v_pages,
            self._dev(table[None, :]), self._dev([len(chunk)], torch.int32), self.cfg, q_offset=offset,
        )
        return logits

    def _finish_sliced_prefill(self, slot_idx: int, pp: _PendingPrefill) -> None:
        """Every chunk landed: sample the first token (keyed by seed and
        position, so slicing cannot change it), read it and start decoding."""
        req, p = pp.req, pp.req.params
        n_prompt = len(req.prompt_tokens)
        first = sample(
            pp.logits, self._next_key(), self._dev([p.temperature], torch.float32),
            self._dev([p.top_p], torch.float32), self._dev([p.top_k], torch.int32),
            seeds=self._dev([_req_seed(req)], torch.int32), step_ids=self._dev([n_prompt], torch.int32),
            needs_filter=p.top_p < 1.0 or p.top_k > 0,
        )
        self.slots[slot_idx].prefill = None
        self._start_decoding(slot_idx, int(first.cpu()[0]))

    # -- decode -----------------------------------------------------------------

    def _reap_aborted(self) -> None:
        """Free the slots of aborted requests (deadline-expired ones finish
        with "deadline"); a slot aborted mid-prefill unwinds its claim."""
        for slot in self.slots:
            if not slot.free and slot.request.aborted:
                req = slot.request
                if slot.prefill is not None:
                    self._unwind_slot(slot)
                else:
                    self._release_slot(slot)
                self._finish_stream(req, _Finish("deadline") if req.deadline_expired else _FINISH)

    def _decode_tick(self) -> bool:
        """One decode block over the live slots: up to ``decode_block`` steps,
        each slot stopping at its host-known step budget, then one read of the
        block's tokens and their acceptance. With ``decode_steps`` N > 1 the
        macro-step program runs instead (lanes also die at their stop token
        on the device) and :meth:`_harvest` accepts its valid rows."""
        self._reap_aborted()
        live = [i for i, s in enumerate(self.slots) if s.decodable]
        if not live:
            return False
        t0 = time.monotonic()
        S = self.max_slots
        tokens = np.zeros((S,), np.int32)
        positions = np.zeros((S,), np.int64)
        budgets = np.zeros((S,), np.int64)
        temps = np.ones((S,), np.float32)
        top_ps = np.ones((S,), np.float32)
        top_ks = np.zeros((S,), np.int32)
        seeds = np.full((S,), -1, np.int32)
        snapshot = []
        for i in live:
            s = self.slots[i]
            p = s.request.params
            tokens[i] = s.last_token
            positions[i] = s.position
            budgets[i] = max(1, min(p.max_tokens - len(s.generated), self.max_model_len - 1 - s.position))
            temps[i], top_ps[i], top_ks[i] = p.temperature, p.top_p, p.top_k
            seeds[i] = _req_seed(s.request)
            snapshot.append((i, s.request))
        key = self._next_key()
        tok = self._dev(tokens)
        pos = self._dev(positions)
        tables = self._dev(self._page_tables)
        temps_d, top_ps_d, top_ks_d, seeds_d = (self._dev(a) for a in (temps, top_ps, top_ks, seeds))
        needs_filter = bool(((top_ps < 1.0) | (top_ks > 0)).any())
        n = max(1, int(self.decode_steps))  # runtime-mutable: read once
        if n > 1:
            live_mask = np.zeros((S,), bool)
            live_mask[live] = True
            multistep = build_multistep_fn(
                self.cfg, paged_impl=self.paged_impl, scatter_impl=self.scatter_impl,
                eos_id=self.tokenizer.eos_id, n_steps=n,
            )
            toks, valid, _last = multistep(
                self.params, self.cache.k_pages, self.cache.v_pages, tok, pos, tables, self._dev(live_mask), key,
                temps_d, top_ps_d, top_ks_d, seeds_d, self._dev(budgets), needs_filter=needs_filter,
            )
            self._harvest(torch.stack([toks, valid.to(toks.dtype)]).cpu().numpy(), snapshot)  # the one host read
            self.stats.decode_seconds += time.monotonic() - t0
            return True
        n_steps = int(min(self.decode_block, budgets.max()))
        step_keys = split(key, self.decode_block)
        steps_out = []
        for k in range(n_steps):
            active = self._dev(budgets > k)
            logits, _, _ = llama.decode_step(
                self.params, tok, pos, self.cache.k_pages, self.cache.v_pages, tables, active, self.cfg,
                impl=self.paged_impl, scatter_impl=self.scatter_impl,
            )
            nxt = sample(
                logits, step_keys[k], temps_d, top_ps_d, top_ks_d, seeds=seeds_d, step_ids=pos,
                needs_filter=needs_filter,
            )
            tok = torch.where(active, nxt, tok)  # inactive slots hold their token
            steps_out.append(tok)
            pos = pos + 1
        toks = torch.stack(steps_out).cpu().numpy()  # the block's one host read
        self.stats.steps += n_steps
        accepted = 0
        for i, req in snapshot:
            s = self.slots[i]
            for k in range(min(n_steps, int(budgets[i]))):
                if s.request is not req:
                    break  # finished mid-block
                s.position += 1
                s.last_token = int(toks[k, i])
                self._accept_token(i, s.last_token)
                accepted += 1
        self.stats.decode_tokens += accepted
        self.stats.decode_seconds += time.monotonic() - t0
        return True

    def _harvest(self, toks_valid: np.ndarray, snapshot: list) -> None:
        """Accept a macro-step's tokens: ``toks_valid`` [2, N, B] holds the
        tokens and their validity. Each slot takes its valid prefix and stops
        at the first invalid row (its lane died on the device at its stop
        token or budget); only steps with a valid row ran."""
        toks, valid = toks_valid[0], toks_valid[1].astype(bool)
        self.stats.steps += int(valid.any(axis=1).sum())
        accepted = 0
        for i, req in snapshot:
            s = self.slots[i]
            if s.request is not req or req.aborted:
                continue  # finished or aborted while the macro-step ran
            for k in range(toks.shape[0]):
                if s.request is not req or not valid[k, i]:
                    break
                s.position += 1
                s.last_token = int(toks[k, i])
                self._accept_token(i, s.last_token)
                accepted += 1
        self.stats.decode_tokens += accepted

    def _accept_token(self, slot_idx: int, token: int) -> None:
        """Book one sampled token: eos / max_tokens / model-length finish,
        then the text: on the detok worker while ``decode_steps > 1`` (or for
        a stream it already owns), else inline (incremental detokenization
        with stop strings and hold-back). The slot and pages are released
        before the finish marker."""
        slot = self.slots[slot_idx]
        req = slot.request
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
        req.n_generated += 1
        finished, reason = False, None
        appended = token != self.tokenizer.eos_id
        if not appended:
            finished, reason = True, "stop"
        else:
            slot.generated.append(token)
            if len(slot.generated) >= req.params.max_tokens or slot.position + 1 >= self.max_model_len:
                finished, reason = True, "length"
        w = self._detok
        if self.decode_steps > 1 or (w is not None and w.owns(req)):
            if w is None or not w.alive:
                w = self._ensure_detok()
            if w.alive:  # else the inline path below
                if not w.owns(req):
                    prior = slot.generated[:-1] if appended else list(slot.generated)
                    w.register(req, prior, max(slot.emitted_text_len, req.emitted_len))
                if appended:
                    w.feed(req, token)
                if finished:
                    # release BEFORE the marker is queued: the worker may
                    # deliver it, and wake the client, at once
                    self._release_slot(slot)
                    self._finish_stream(req, _Finish(reason))
                return
        text = self.tokenizer.decode(slot.generated)
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
        if finished:
            # a client woken by the marker must find the slot and pages freed
            self._release_slot(slot)
            self._finish_stream(req, _Finish(reason))


def build_engine(model: str = "llama2-7b", model_dir: str | None = None, **engine_kw) -> LLMEngine:
    """An engine by preset name, or for the checkpoint in ``model_dir`` (its
    ``config.json``, its weights and, where it has one, its tokenizer)."""
    if model_dir is not None:
        cfg = llama.LlamaConfig.from_hf_config(f"{model_dir}/config.json")
    elif model in _MOE_PRESETS:
        raise NotImplementedError(f"model preset {model!r} is a mixture of experts, not ported yet (ROADMAP A3)")
    elif model not in MODEL_PRESETS:
        raise ValueError(f"unknown model preset {model!r}; known: {sorted(MODEL_PRESETS)}")
    else:
        cfg = MODEL_PRESETS[model]()
    return LLMEngine(cfg, model_dir=model_dir, **engine_kw)
