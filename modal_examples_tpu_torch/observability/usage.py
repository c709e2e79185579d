"""Hardware-utilization accounting: roofline MFU/MBU meters and
per-tenant usage metering.

Copy of ``modal_examples_tpu/observability/usage.py`` (``WorkModel``,
``EngineUsage``, the usage journal) with three changes:

- the peaks are the card's. :func:`resolve_peaks` keys them by
  ``torch.cuda.get_device_name()`` (:data:`GPU_PEAKS`); a card it does not
  know, or the CPU, gets no peaks, and then the meter reports no
  utilization share (``mfu``/``mbu`` None) instead of dividing by another
  chip's figures. Callers that know their peaks (a CPU test) pass them as
  ``peaks=``;
- on the card the engine feeds it device seconds from CUDA events around
  each unit of work (the JAX engine times its blocking reads, which the
  pipelined loop makes close to zero);
- decode bytes count the weight stream once per decode step that ran, not
  once per token: the slots of a step share it, and counting it per token
  would put the byte share above 1 at a batch of 8;
- a speculative round adds the work its accepted tokens do not count
  (:meth:`EngineUsage.note_spec_work`): the draft's steps and the verify's
  rejected chain positions, priced by the same decode formulas, with the
  target's weight stream once a round (the verify) and the draft's once a
  draft step.

The pieces:

- :class:`WorkModel` — the analytic per-request cost model, derived once
  per engine from the model config and cache geometry: prefill FLOPs ≈
  2·N_params·T plus the causal-attention term, decode bytes ≈ weight
  bytes per step + kv_dtype-aware KV-read bytes per token.
- the **roofline meter** — integer accumulators fed from the engine's
  token-accounting sites (device seconds from the card's events, on the
  CPU the two blocking reads on the engine's injectable clock), joined with
  the work model into MFU / MBU / achieved-TFLOP/s gauges per phase.
- the **usage meter** — per-(tenant, class) buckets (prompt + generated
  tokens, slot device-seconds, KV page-seconds, sheds) updated at the
  same sites that update ``EngineStats``, so Σ tenants == engine totals by
  structure; per-request records land in the ``usage.jsonl`` journal at
  stream finish.
"""

from __future__ import annotations

import threading
import time
import weakref

from . import metrics as _obs
from .journal import DecisionJournal, named_journal

#: the synthetic probe tenant (the reference's ``observability/canary.py``):
#: excluded from usage billing
CANARY_TENANT = "__canary__"

#: dense bf16 peak TFLOP/s and HBM GB/s of one card, by
#: ``torch.cuda.get_device_name()``: the H100 SXM's data-sheet figures, the
#: same ones the kernel bounds in PERF.md use
GPU_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
}


def resolve_peaks(device=None, chips: int = 1, peaks: dict | None = None) -> dict:
    """Peak FLOP/s and HBM bandwidth for the accounting denominator.

    ``peaks`` (``{"device", "tflops_per_chip", "hbm_gbps_per_chip"}``) is
    taken as given. Otherwise ``device`` (a torch device or name; None: the
    current CUDA device, if any) is looked up in :data:`GPU_PEAKS` by its
    name; an unknown card or a CPU gets None for both peaks, and the meter
    then reports no share. ``chips`` scales both peaks."""
    if peaks is not None:
        return {"chips": max(1, int(chips)), **peaks}
    name = _device_name(device)
    tflops, gbps = GPU_PEAKS.get(name, (None, None))
    return {"device": name, "chips": max(1, int(chips)), "tflops_per_chip": tflops, "hbm_gbps_per_chip": gbps}


def _device_name(device) -> str:
    import torch

    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device  # a card's name
    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is None or dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev)


class WorkModel:
    """Analytic per-request work model, frozen at engine build.

    FLOPs follow the standard transformer accounting (2 multiply-adds per
    weight per token) plus the attention terms the weight count misses —
    the same formulation as the kernel-level ``flops=`` estimates on
    ``ops/flash_attention.py`` (causal: half the S×S score matrix) and
    ``ops/paged_attention.py`` (decode: one query row over the context):

    - prefill:  ``2·N·T  +  2·L·D·T²``   per request of T prompt tokens
    - decode:   ``2·N    +  4·L·D·ctx``  per generated token at context ctx

    Bytes model the two HBM streams decode actually pays: the full weight
    read per decode step and the KV history read per token, where
    ``kv_bytes_per_token`` comes from the cache's own dtype-aware byte count
    divided by its token capacity — int8 KV (payload + f32 scale rows) prices itself. Prefill
    bytes are one weight stream per dispatched program plus the KV written.
    """

    __slots__ = (
        "n_params", "n_layers", "dim", "weight_bytes", "kv_bytes_per_token",
    )

    def __init__(
        self, *, n_params: int, n_layers: int, dim: int,
        weight_bytes: int, kv_bytes_per_token: float,
    ):
        self.n_params = int(n_params)
        self.n_layers = int(n_layers)
        self.dim = int(dim)
        self.weight_bytes = int(weight_bytes)
        self.kv_bytes_per_token = float(kv_bytes_per_token)

    @classmethod
    def from_engine(cls, cfg, *, cache, weight_bytes: int) -> "WorkModel":
        """Derive the model from a built engine's pieces: the llama config
        (parameter count, layer geometry) and the paged cache (dtype-aware
        total bytes over ``n_pages × page_size`` token capacity)."""
        return cls(
            n_params=int(cfg.param_count),
            n_layers=int(cfg.n_layers),
            dim=int(cfg.dim),
            weight_bytes=int(weight_bytes),
            kv_bytes_per_token=(
                cache.bytes() / float(cache.n_pages * cache.page_size)
            ),
        )

    # -- FLOPs ---------------------------------------------------------------

    def prefill_flops(self, n_tokens: int, sq_tokens: int = 0) -> int:
        """FLOPs to prefill prompts totalling ``n_tokens`` whose per-request
        squared lengths sum to ``sq_tokens`` (the causal-attention term is
        quadratic per request, so Σ T² must be accumulated, not (Σ T)²)."""
        return int(
            2 * self.n_params * n_tokens
            + 2 * self.n_layers * self.dim * sq_tokens
        )

    def decode_flops(self, n_tokens: int, ctx_sum: int = 0) -> int:
        """FLOPs to decode ``n_tokens`` whose context lengths at decode
        time sum to ``ctx_sum`` (QK over the history + AV back: 4·ctx·D
        per layer per token)."""
        return int(
            2 * self.n_params * n_tokens
            + 4 * self.n_layers * self.dim * ctx_sum
        )

    # -- bytes ---------------------------------------------------------------

    def prefill_bytes(self, n_tokens: int, n_calls: int = 0) -> int:
        """HBM bytes for prefill: one weight stream per dispatched prefill
        program (batched admissions share the read) plus the KV written."""
        return int(
            n_calls * self.weight_bytes
            + self.kv_bytes_per_token * n_tokens
        )

    def decode_bytes(self, n_steps: int, ctx_sum: int = 0) -> int:
        """HBM bytes for decode: one weight stream per decode step (the
        slots of a step share it) plus the kv_dtype-aware KV history read
        of the tokens, whose contexts sum to ``ctx_sum``."""
        return int(
            n_steps * self.weight_bytes
            + self.kv_bytes_per_token * ctx_sum
        )


def _bucket() -> dict:
    return {
        "prompt_tokens": 0,
        "generated_tokens": 0,
        "device_seconds": 0.0,
        "kv_page_seconds": 0.0,
        "sheds": 0,
        "requests": 0,
    }


class EngineUsage:
    """Per-engine accountant: roofline accumulators + per-tenant meters.

    Every hook is a few integer adds under one lock — safe from the
    scheduler thread plus concurrent ``prefill_sync`` server threads, and
    cheap enough to run unconditionally (no zero-cost-off gate: unlike the
    profiler there are no extra timestamps on the per-token path)."""

    def __init__(
        self,
        model: WorkModel,
        *,
        clock=None,
        name="engine",
        chips: int = 1,
        device=None,
        peaks: dict | None = None,
        registry=None,
        journal_path=None,
    ):
        self.model = model
        self.peaks = resolve_peaks(device, chips=chips, peaks=peaks)
        self._clock = clock or time.monotonic
        self._name = name
        self._registry = registry
        self._journal_path = journal_path
        self._journal: DecisionJournal | None = None
        self._lock = threading.Lock()
        # roofline work accumulators (plain ints: deterministic, no floats
        # on the token path except phase seconds from the injectable clock)
        self._prefill_tokens = 0
        self._prefill_sq_tokens = 0
        self._prefill_calls = 0
        self._decode_tokens = 0
        self._decode_steps = 0
        self._decode_ctx_sum = 0
        self._spec_flops = 0  # speculative rounds' work beyond their accepted tokens
        self._spec_bytes = 0
        self._phase_seconds = {"prefill": 0.0, "decode": 0.0}
        # per-(tenant, class) buckets + the last-flushed mirror (counters
        # take deltas; the buckets hold the running totals)
        self._buckets: dict[tuple[str, str], dict] = {}
        self._flushed: dict[tuple[str, str], dict] = {}
        # synthetic canary probes (observability/canary.py): excluded from
        # the tenant buckets and the usage journal — nobody is billed for
        # the fleet probing itself — but the tokens are REAL device work, so
        # they keep feeding the roofline accumulators and land in their own
        # mtpu_canary_tokens_total series; conservation stays closed as
        # Σ tenant buckets + canary == the engine's stats counters
        self._canary = {"prompt_tokens": 0, "generated_tokens": 0}
        self._canary_flushed = {"prompt_tokens": 0, "generated_tokens": 0}
        register(self)

    @property
    def replica(self) -> str:
        return str(self._name() if callable(self._name) else self._name)

    def _b(self, tenant: str, klass: str) -> dict:
        key = (str(tenant), str(klass))
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = _bucket()
        return b

    # -- hot-path hooks (mirror the EngineStats sites exactly) ---------------

    def note_prompt(self, req, n_tokens: int, *, calls: int = 1) -> None:
        """Prompt tokens accepted into KV — called at BOTH engine sites
        that bump ``stats.prompt_tokens`` (slot harvest and the slot-free
        disagg prefill), so Σ tenants == the engine counter."""
        n = int(n_tokens)
        with self._lock:
            if req.tenant == CANARY_TENANT:
                self._canary["prompt_tokens"] += n
            else:
                b = self._b(req.tenant, req.priority)
                b["prompt_tokens"] += n
                b["requests"] += 1
            self._prefill_tokens += n
            self._prefill_sq_tokens += n * n
            self._prefill_calls += int(calls)
        # the journal records what was ACCOUNTED, not what was submitted —
        # a request shed before prefill must journal 0 prompt tokens or
        # the Σ-journal == engine-counter conservation breaks
        req._usage_prompt = getattr(req, "_usage_prompt", 0) + n

    def note_token(self, req, ctx: int) -> None:
        """One generated token accepted at context length ``ctx`` — called
        from the ONE site that bumps ``stats.generated_tokens``."""
        with self._lock:
            if req.tenant == CANARY_TENANT:
                self._canary["generated_tokens"] += 1
            else:
                self._b(req.tenant, req.priority)["generated_tokens"] += 1
            self._decode_tokens += 1
            self._decode_ctx_sum += int(ctx)

    def note_decode_steps(self, n: int) -> None:
        """``n`` decode steps ran (each streams the weights once)."""
        with self._lock:
            self._decode_steps += int(n)

    def note_spec_work(self, flops: int, nbytes: int) -> None:
        """Decode work of a speculative round beyond its accepted tokens
        (which :meth:`note_token` counts): the draft's steps and the verify's
        rejected chain positions."""
        with self._lock:
            self._spec_flops += int(flops)
            self._spec_bytes += int(nbytes)

    def note_phase_seconds(self, phase: str, seconds: float) -> None:
        """Device-attributed seconds for ``phase`` ("prefill" | "decode"):
        on the card the span of the work between CUDA events, on the CPU
        the blocking read on the injectable clock — the denominator under
        MFU/MBU."""
        if seconds > 0:
            with self._lock:
                self._phase_seconds[phase] = (
                    self._phase_seconds.get(phase, 0.0) + float(seconds)
                )

    def note_slot_release(self, req, *, pages: int, held_s: float) -> None:
        """A decode slot released its pages: charge the occupancy interval
        (device-seconds) and its KV-residency integral (page-seconds)."""
        if req.tenant == CANARY_TENANT:
            return  # probe residency bills nobody
        held = max(0.0, float(held_s))
        with self._lock:
            b = self._b(req.tenant, req.priority)
            b["device_seconds"] += held
            b["kv_page_seconds"] += held * int(pages)

    def note_shed(self, tenant: str, klass: str) -> None:
        """Admission rejected a request: charge the tenant. Sheds are rare,
        so the cataloged counter increments immediately (no delta flush)."""
        with self._lock:
            self._b(tenant, klass)["sheds"] += 1
        _obs.record_usage_shed(tenant, klass, registry=self._registry)

    def note_finish(self, req, reason: str) -> None:
        """Terminal delivery: one ``usage.jsonl`` record per request (the
        billing line). Guarded so a request that finishes through more than
        one path journals exactly once."""
        if getattr(req, "_usage_journaled", False):
            return
        req._usage_journaled = True
        if req.tenant == CANARY_TENANT:
            return  # probes never land a billing line; see canary.jsonl
        self._journal_record({
            "at": time.time(),
            "replica": self.replica,
            "request_id": req.request_id,
            "tenant": req.tenant,
            "class": req.priority,
            "prompt_tokens": int(getattr(req, "_usage_prompt", 0)),
            "generated_tokens": int(req.n_generated),
            "cached_prompt_tokens": int(
                getattr(req, "cached_prompt_tokens", 0)
            ),
            "finish_reason": reason,
        })

    def _journal_record(self, rec: dict) -> None:
        if self._journal is None:
            self._journal = named_journal("usage", path=self._journal_path)
        self._journal.record(rec)

    # -- read surfaces -------------------------------------------------------

    def summary(self) -> dict:
        """The roofline position: per-phase analytic FLOPs/bytes joined
        with the accounted device seconds against the resolved peaks. A
        pure function of the accumulators — fake-clock runs are exactly
        reproducible."""
        with self._lock:
            pt, psq, pcalls = (
                self._prefill_tokens, self._prefill_sq_tokens,
                self._prefill_calls,
            )
            dt, dsteps, dctx = self._decode_tokens, self._decode_steps, self._decode_ctx_sum
            spec_flops, spec_bytes = self._spec_flops, self._spec_bytes
            secs = dict(self._phase_seconds)
        m = self.model
        chips = self.peaks["chips"]
        known = self.peaks["tflops_per_chip"] is not None and self.peaks["hbm_gbps_per_chip"] is not None
        peak_flops = self.peaks["tflops_per_chip"] * 1e12 * chips if known else None
        peak_bps = self.peaks["hbm_gbps_per_chip"] * 1e9 * chips if known else None
        work = {
            "prefill": (
                m.prefill_flops(pt, psq), m.prefill_bytes(pt, pcalls),
                secs.get("prefill", 0.0),
            ),
            "decode": (
                m.decode_flops(dt, dctx) + spec_flops,
                m.decode_bytes(dsteps, dctx) + spec_bytes,
                secs.get("decode", 0.0),
            ),
        }
        work["total"] = tuple(
            sum(w[i] for w in work.values()) for i in range(3)
        )
        phases = {}
        for phase, (flops, nbytes, s) in work.items():
            mfu = mbu = bound = None
            if s > 0:
                tflops = flops / s / 1e12
                gbps = nbytes / s / 1e9
                if known:
                    mfu = round(flops / (s * peak_flops), 6)
                    mbu = round(nbytes / (s * peak_bps), 6)
                    bound = "compute" if mfu >= mbu else "bandwidth"
            else:
                tflops = gbps = 0.0
                if known:
                    mfu = mbu = 0.0
            phases[phase] = {
                "flops": int(flops),
                "bytes": int(nbytes),
                "device_seconds": round(s, 6),
                "achieved_tflops": round(tflops, 6),
                "achieved_gbps": round(gbps, 6),
                "mfu": mfu,
                "mbu": mbu,
                "bound": bound,
            }
        return {
            "device": self.peaks.get("device"),
            "chips": chips,
            "phases": phases,
        }

    def tenants(self) -> dict:
        """Per-(tenant, class) running totals plus the conservation sums —
        the gateway's ``/usage`` payload and the CLI's table source."""
        with self._lock:
            rows = [
                {"tenant": t, "class": k, **{
                    f: (round(v, 6) if isinstance(v, float) else v)
                    for f, v in b.items()
                }}
                for (t, k), b in sorted(self._buckets.items())
            ]
            totals = _bucket()
            for b in self._buckets.values():
                for f in totals:
                    totals[f] += b[f]
        totals = {
            f: (round(v, 6) if isinstance(v, float) else v)
            for f, v in totals.items()
        }
        with self._lock:
            canary = dict(self._canary)
        return {"tenants": rows, "totals": totals, "canary": canary}

    def flush(self, registry=None) -> None:
        """Push accumulated deltas into the cataloged per-tenant counters
        and refresh the roofline gauges — called from the engine's
        throttled gauge refresh and unthrottled from ``stop()`` (the
        ``_flush_token_counters`` contract: the final sub-throttle window
        is never lost from a pushed exposition)."""
        reg = registry if registry is not None else self._registry
        with self._lock:
            deltas = []
            for key, b in self._buckets.items():
                last = self._flushed.setdefault(key, _bucket())
                d = {f: b[f] - last[f] for f in b}
                if any(d[f] for f in (
                    "prompt_tokens", "generated_tokens",
                    "device_seconds", "kv_page_seconds",
                )):
                    deltas.append((key, d))
                self._flushed[key] = dict(b)
            canary_d = {
                f: self._canary[f] - self._canary_flushed[f]
                for f in self._canary
            }
            self._canary_flushed = dict(self._canary)
        if any(canary_d.values()):
            _obs.record_canary_tokens(
                self.replica,
                prompt=canary_d["prompt_tokens"],
                generated=canary_d["generated_tokens"],
                registry=reg,
            )
        for (tenant, klass), d in deltas:
            _obs.record_usage_tokens(
                tenant, klass,
                prompt=d["prompt_tokens"], generated=d["generated_tokens"],
                registry=reg,
            )
            _obs.record_usage_seconds(
                tenant, klass,
                device_seconds=d["device_seconds"],
                kv_page_seconds=d["kv_page_seconds"],
                registry=reg,
            )
        s = self.summary()
        for phase, p in s["phases"].items():
            if p["mfu"] is None:
                continue  # no peaks for this device: no share to report
            _obs.set_roofline(
                phase, mfu=p["mfu"], mbu=p["mbu"],
                tflops=p["achieved_tflops"], registry=reg,
            )


def journal_tenant_totals(records: list[dict]) -> dict:
    """Fold per-request journal records into per-tenant token totals — the
    offline half of the conservation contract (Σ journal == the engine's
    prefill+decode counters for the same run)."""
    out: dict[str, dict] = {}
    for rec in records:
        t = str(rec.get("tenant", "default"))
        b = out.setdefault(
            t, {"prompt_tokens": 0, "generated_tokens": 0, "requests": 0}
        )
        b["prompt_tokens"] += int(rec.get("prompt_tokens", 0) or 0)
        b["generated_tokens"] += int(rec.get("generated_tokens", 0) or 0)
        b["requests"] += 1
    return out


# -- process registry (the gateway's /usage source) --------------------------

_registry_lock = threading.Lock()
#: weak refs, so the registry never pins a dead engine's meter
_meters: list = []


def register(meter: EngineUsage) -> None:
    with _registry_lock:
        _meters.append(weakref.ref(meter))
        _meters[:] = [r for r in _meters if r() is not None][-64:]


def active_meters() -> list[EngineUsage]:
    with _registry_lock:
        return [m for m in (r() for r in _meters) if m is not None]
