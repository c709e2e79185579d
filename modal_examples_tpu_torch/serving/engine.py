"""Continuous-batching LLM engine over the paged KV cache (slice 1 of the port).

Counterpart of ``modal_examples_tpu/serving/engine.py``, with the same method
names: ``make_request``, ``submit``, ``generate``, ``stream``, ``abort``,
``start``/``stop``/``_loop``, ``_admit``, ``_prefill_group``, ``_prefill_long``,
the decode tick and ``_accept_token``.

Scheduler tick: admit waiting requests into free slots (claiming each one's
whole page budget), prefill them in bucketed batches (prompts longer than
the largest bucket take ``prefill_chunk`` chunk by chunk), accept their first
tokens, then run one decode block: ``decode_block`` decode+sample steps in a
Python loop, one host read of the block's tokens at the end. Each slot's step
budget (tokens left before ``max_tokens`` or the model length) is known on
the host, so a slot stops decoding exactly where it would finish by length.

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

Not in this slice: int4 weights, the prefix cache, the prefill budget,
policies and deadlines, the pipelined dispatch, speculative decoding,
metrics and tracing.
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
from ..scheduling.admission import WaitingQueue
from ..utils.device import resolve_device
from ..utils.tokenizer import load_tokenizer
from .kv_cache import OutOfPages, PagedKVCache
from .multistep import DetokWorker, build_multistep_fn, resolve_decode_steps
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


@dataclasses.dataclass
class _Slot:
    request: Request | None = None
    pages: list[int] = dataclasses.field(default_factory=list)
    position: int = 0  # position of the NEXT token to decode
    last_token: int = 0
    generated: list[int] = dataclasses.field(default_factory=list)
    emitted_text_len: int = 0

    @property
    def free(self) -> bool:
        return self.request is None


@dataclasses.dataclass
class EngineStats:
    steps: int = 0  # decode steps run (each a decode_step over all slots; macro-steps count executed ones)
    decode_seconds: float = 0.0  # host wall time of decode blocks, read included
    decode_tokens: int = 0  # tokens accepted from decode blocks


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
        quantization: str | None = None,  # "int8": weight-only int8 serving
        seed: int = 0,
        kv_dtype=None,  # "int8": the quantized paged cache; None: MTPU_KV_DTYPE, then bf16
        decode_block: int = 8,
        max_queue: int = 4096,
        device=None,
        paged_impl: str | None = None,  # decode structure; None: env, then "xla"
        scatter_impl: str | None = None,  # KV scatter; None: env, then "xla"
        decode_steps: int | None = None,  # macro-step N; None: env, then 1
    ):
        if model_dir is not None and params is None:
            # the reference loads the checkpoint (llama.load_hf_weights); a
            # real tokenizer over random weights would serve without an error
            raise NotImplementedError(
                f"LLMEngine(model_dir={model_dir!r}) without params=: loading "
                "checkpoint weights is not ported yet (ROADMAP A3)"
            )
        self.device = resolve_device(device)
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
            if quantization is not None:
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
        self.decode_block = max(1, int(decode_block))
        self.decode_steps = resolve_decode_steps(decode_steps)  # read once per dispatch
        self._detok: DetokWorker | None = None  # created at the first routed token
        self.slots = [_Slot() for _ in range(max_slots)]
        self.waiting = WaitingQueue(max_queue)
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

    def make_request(self, prompt: str, params: SamplingParams | None = None) -> Request:
        """Build (but do not enqueue) one validated, tokenized request."""
        req = Request(prompt=prompt, params=params or SamplingParams())
        self.validate_params(req.params)
        if req.params.seed is None:
            with self._lock:
                self._submit_seq += 1
                req.auto_seed = (self._seed_base * 1_000_003 + self._submit_seq) % (2**31 - 1)
        # prompts past the largest bucket prefill in chunks; the hard cap is
        # the model length minus one decode position
        req.prompt_tokens = self.tokenizer.encode(prompt)[: self.max_model_len - 1]
        return req

    def submit(self, prompt: str, params: SamplingParams | None = None) -> Request:
        """Enqueue one request. Raises ``ShedError`` when the waiting queue is
        full (HTTP 429 upstream)."""
        req = self.make_request(prompt, params)
        self.waiting.submit(req)
        return req

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
        """Cancel a request: a queued one finishes now, an active one at the
        next scheduler tick (its slot and pages are freed there)."""
        request.aborted = True
        if self.waiting.remove(request):
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
        for req in self.waiting.drain():
            self._finish_stream(req, marker)
        for slot in self.slots:
            if not slot.free:
                req = slot.request
                self._release_slot(slot)
                self._finish_stream(req, marker)

    def _release_slot(self, slot: _Slot) -> None:
        self.cache.allocator.free(slot.pages)
        slot.pages = []
        slot.request = None

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
        """One scheduler tick: reap aborts -> admit + prefill -> one decode block."""
        for slot in self.slots:
            if not slot.free and slot.request.aborted:
                req = slot.request
                self._release_slot(slot)
                self._finish_stream(req, _FINISH)
        admitted = self._admit()
        decoded = self._decode_tick()
        return admitted or decoded

    # -- admission and prefill ------------------------------------------------

    def _admit(self) -> bool:
        """Claim free slots and page budgets for waiting requests (FIFO), then
        prefill: bucketed prompts in batches of ``prefill_batch``, longer ones
        chunk by chunk."""
        free = [i for i, s in enumerate(self.slots) if s.free]
        entries = self.waiting.pop(len(free)) if free else []
        assigned: list[tuple[int, Request, list[int]]] = []
        for pos, req in enumerate(entries):
            if req.aborted:
                self._finish_stream(req, _FINISH)
                continue
            n_total = min(len(req.prompt_tokens) + req.params.max_tokens, self.max_model_len)
            try:
                pages = self.cache.allocator.alloc(self.cache.pages_for(n_total))
            except OutOfPages:
                # no KV room: this entry and the rest go back to the front,
                # in order, until a finish frees pages
                self.waiting.requeue_front(entries[pos:])
                break
            assigned.append((free[len(assigned)], req, pages))
        by_bucket: dict[int, list] = {}
        long_ones = []
        for a in assigned:
            n_prompt = len(a[1].prompt_tokens)
            if n_prompt > self.prefill_buckets[-1]:
                long_ones.append(a)
            else:
                by_bucket.setdefault(self._bucket_for(n_prompt), []).append(a)
        for bucket, group in by_bucket.items():
            for i in range(0, len(group), self.prefill_batch):
                self._prefill_group(bucket, group[i : i + self.prefill_batch])
        for a in long_ones:
            self._prefill_long(*a)
        return bool(assigned)

    def _install(self, slot_idx: int, req: Request, pages: list[int]) -> np.ndarray:
        slot = self.slots[slot_idx]
        slot.request = req
        slot.pages = pages
        slot.generated = req.generated_tokens  # the request's own history
        slot.emitted_text_len = 0
        table = np.zeros((self.pages_per_slot,), np.int32)
        table[: len(pages)] = pages
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
        for i, (slot_idx, req, pages) in enumerate(group):
            tables[i] = self._install(slot_idx, req, pages)
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
        for i, (slot_idx, _req, _pages) in enumerate(group):
            self._start_decoding(slot_idx, int(first[i]))

    def _prefill_long(self, slot_idx: int, req: Request, pages: list[int]) -> None:
        """A prompt longer than the largest bucket: bucket-sized chunks through
        ``prefill_chunk``, each attending to the pages written before it."""
        table = self._install(slot_idx, req, pages)
        C = self.prefill_buckets[-1]
        pad_tok = self.tokenizer.pad_id % self.cfg.vocab_size
        n_prompt = len(req.prompt_tokens)
        tables = self._dev(table[None, :])
        logits = None
        for offset in range(0, n_prompt, C):
            chunk = req.prompt_tokens[offset : offset + C]
            toks = np.full((1, C), pad_tok, np.int32)
            toks[0, : len(chunk)] = chunk
            logits, _, _ = llama.prefill_chunk(
                self.params, self._dev(toks), self.cache.k_pages, self.cache.v_pages,
                tables, self._dev([len(chunk)], torch.int32), self.cfg, q_offset=offset,
            )
        p = req.params
        first = sample(
            logits, self._next_key(), self._dev([p.temperature], torch.float32),
            self._dev([p.top_p], torch.float32), self._dev([p.top_k], torch.int32),
            seeds=self._dev([_req_seed(req)], torch.int32),
            step_ids=self._dev([n_prompt], torch.int32),
            needs_filter=p.top_p < 1.0 or p.top_k > 0,
        )
        self._start_decoding(slot_idx, int(first.cpu()[0]))

    # -- decode -----------------------------------------------------------------

    def _decode_tick(self) -> bool:
        """One decode block over the live slots: up to ``decode_block`` steps,
        each slot stopping at its host-known step budget, then one read of the
        block's tokens and their acceptance. With ``decode_steps`` N > 1 the
        macro-step program runs instead (lanes also die at their stop token
        on the device) and :meth:`_harvest` accepts its valid rows."""
        live = [i for i, s in enumerate(self.slots) if not s.free]
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
