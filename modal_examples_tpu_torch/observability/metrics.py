"""Copy of ``modal_examples_tpu/observability/metrics.py``: the port keeps its own instance.

Recorders: the narrow API the executor, the fault gate, the serving
engine, the scheduler, the prefix cache, the profiler and the usage meter
call to emit metric series from
:mod:`.catalog` into the port's process-wide prometheus registry
(:mod:`..utils.prometheus`). Only the recorders of those paths are copied;
a later slice copies the rest with the subsystem that calls them.

Keeping every write behind a named function means call sites stay one line,
label sets can't drift between emitters, and tests can read series back via
``default_registry.value(...)`` with the same constants.
"""

from __future__ import annotations

from ..utils.prometheus import Registry, default_registry
from . import catalog as C


def _reg(registry: Registry | None) -> Registry:
    return registry if registry is not None else default_registry


# -- call lifecycle (executor) ----------------------------------------------


def record_phase(
    function: str, phase: str, seconds: float, *, registry: Registry | None = None
) -> None:
    _reg(registry).histogram_observe(
        C.CALL_DURATION_SECONDS,
        seconds,
        labels={"function": function, "phase": phase},
        help=C.CATALOG[C.CALL_DURATION_SECONDS]["help"],
    )


def record_queue_wait(
    function: str, seconds: float, *, registry: Registry | None = None
) -> None:
    _reg(registry).histogram_observe(
        C.QUEUE_WAIT_SECONDS,
        seconds,
        labels={"function": function},
        help=C.CATALOG[C.QUEUE_WAIT_SECONDS]["help"],
    )
    record_phase(function, "queue", seconds, registry=registry)


def set_inflight(
    function: str, n: int, *, registry: Registry | None = None
) -> None:
    _reg(registry).gauge_set(
        C.INFLIGHT_INPUTS,
        float(n),
        labels={"function": function},
        help=C.CATALOG[C.INFLIGHT_INPUTS]["help"],
    )


def record_retry(
    function: str, reason: str, *, registry: Registry | None = None
) -> None:
    _reg(registry).counter_inc(
        C.RETRIES_TOTAL,
        1.0,
        labels={"function": function, "reason": reason},
        help=C.CATALOG[C.RETRIES_TOTAL]["help"],
    )


def record_container_kill(
    function: str, reason: str, *, registry: Registry | None = None
) -> None:
    _reg(registry).counter_inc(
        C.CONTAINER_KILLS_TOTAL,
        1.0,
        labels={"function": function, "reason": reason},
        help=C.CATALOG[C.CONTAINER_KILLS_TOTAL]["help"],
    )


def sample_host_rss(*, registry: Registry | None = None) -> float | None:
    """Current process RSS in bytes into the gauge (Linux: /proc/self/statm;
    silently a no-op elsewhere). Returns the sampled value."""
    import os as _os

    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        rss = rss_pages * _os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None
    _reg(registry).gauge_set(
        C.HOST_RSS_BYTES, float(rss),
        help=C.CATALOG[C.HOST_RSS_BYTES]["help"],
    )
    return float(rss)


def record_scaler_decision(
    function: str, action: str, *, registry: Registry | None = None
) -> None:
    _reg(registry).counter_inc(
        C.SCALER_DECISIONS_TOTAL, 1.0,
        labels={"function": function, "action": action},
        help=C.CATALOG[C.SCALER_DECISIONS_TOTAL]["help"],
    )


def record_fault_injected(
    point: str, *, registry: Registry | None = None
) -> None:
    """One fired fault point (faults/inject.py). Only FIRES count — a
    reached-but-passing point is free, preserving the zero-cost gate."""
    _reg(registry).counter_inc(
        C.FAULTS_INJECTED_TOTAL, 1.0,
        labels={"point": point},
        help=C.CATALOG[C.FAULTS_INJECTED_TOTAL]["help"],
    )


# -- serving engine ---------------------------------------------------------


def record_engine_phase(
    phase: str, seconds: float, *, registry: Registry | None = None
) -> None:
    _reg(registry).histogram_observe(
        C.ENGINE_PHASE_SECONDS,
        seconds,
        labels={"phase": phase},
        help=C.CATALOG[C.ENGINE_PHASE_SECONDS]["help"],
    )


def record_engine_batch(n: int, *, registry: Registry | None = None) -> None:
    _reg(registry).histogram_observe(
        C.ENGINE_BATCH_SIZE,
        float(n),
        buckets=C.COUNT_BUCKETS,
        help=C.CATALOG[C.ENGINE_BATCH_SIZE]["help"],
    )


def record_engine_queue_wait(
    seconds: float, *, registry: Registry | None = None
) -> None:
    _reg(registry).histogram_observe(
        C.ENGINE_QUEUE_WAIT_SECONDS,
        seconds,
        help=C.CATALOG[C.ENGINE_QUEUE_WAIT_SECONDS]["help"],
    )


def set_engine_gauges(
    *,
    waiting: int,
    active_slots: int,
    tokens_per_second: float,
    registry: Registry | None = None,
) -> None:
    reg = _reg(registry)
    reg.gauge_set(
        C.WAITING_REQUESTS, float(waiting),
        help=C.CATALOG[C.WAITING_REQUESTS]["help"],
    )
    reg.gauge_set(
        C.ACTIVE_SLOTS, float(active_slots),
        help=C.CATALOG[C.ACTIVE_SLOTS]["help"],
    )
    reg.gauge_set(
        C.TOKENS_PER_SECOND, tokens_per_second,
        help=C.CATALOG[C.TOKENS_PER_SECOND]["help"],
    )


def set_decode_impl(plan: dict, *, registry: Registry | None = None) -> None:
    """Info gauge for the engine's resolved decode plan: the attention /
    scatter impls, cache dtype, tensor-parallel degree, and the PER-SHARD
    ragged variant (``paged_impl_plan(mesh=...)``) — so dashboards and
    benches report the sharded plan actually run, not the requested one."""
    _reg(registry).gauge_set(
        C.DECODE_IMPL,
        1.0,
        labels={
            "attention": str(plan["attention"]),
            "scatter": str(plan["scatter"]),
            "kv_dtype": str(plan["kv_dtype"]),
            "tp": str(plan.get("tp", 1)),
            "variant": str(plan.get("ragged_variant") or "-"),
        },
        help=C.CATALOG[C.DECODE_IMPL]["help"],
    )


def record_decode_stall(
    seconds: float, *, registry: Registry | None = None
) -> None:
    """One gap between consecutive decode-block dispatches while decodable
    slots existed — the stall-free admission contract's measurement: under
    a prefill budget this stays bounded by ~one prefill chunk."""
    _reg(registry).histogram_observe(
        C.DECODE_STALL_SECONDS,
        seconds,
        buckets=C.TOKEN_TIME_BUCKETS,
        help=C.CATALOG[C.DECODE_STALL_SECONDS]["help"],
    )


def set_prefill_backlog(tokens: int, *, registry: Registry | None = None) -> None:
    _reg(registry).gauge_set(
        C.PREFILL_BACKLOG_TOKENS, float(tokens),
        help=C.CATALOG[C.PREFILL_BACKLOG_TOKENS]["help"],
    )


def record_prefill_sliced(*, registry: Registry | None = None) -> None:
    _reg(registry).counter_inc(
        C.PREFILL_SLICED_TOTAL, 1.0,
        help=C.CATALOG[C.PREFILL_SLICED_TOTAL]["help"],
    )


def record_scheduler_error(*, registry: Registry | None = None) -> None:
    _reg(registry).counter_inc(
        C.SCHEDULER_ERRORS_TOTAL,
        1.0,
        help=C.CATALOG[C.SCHEDULER_ERRORS_TOTAL]["help"],
    )


# -- token-level serving telemetry ------------------------------------------


def record_ttft(seconds: float, *, registry: Registry | None = None) -> None:
    _reg(registry).histogram_observe(
        C.TTFT_SECONDS,
        seconds,
        buckets=C.TOKEN_TIME_BUCKETS,
        help=C.CATALOG[C.TTFT_SECONDS]["help"],
    )


def record_tpot(seconds: float, *, registry: Registry | None = None) -> None:
    _reg(registry).histogram_observe(
        C.TPOT_SECONDS,
        seconds,
        buckets=C.TOKEN_TIME_BUCKETS,
        help=C.CATALOG[C.TPOT_SECONDS]["help"],
    )


def record_token_totals(
    *, prompt: int = 0, generated: int = 0, steps: int = 0,
    registry: Registry | None = None,
) -> None:
    """Increment the prefill-vs-decode token counters (deltas, not totals —
    the engine accumulates and flushes from its gauge-refresh throttle)."""
    reg = _reg(registry)
    if prompt:
        reg.counter_inc(
            C.PROMPT_TOKENS_TOTAL, float(prompt),
            help=C.CATALOG[C.PROMPT_TOKENS_TOTAL]["help"],
        )
    if generated:
        reg.counter_inc(
            C.GENERATED_TOKENS_TOTAL, float(generated),
            help=C.CATALOG[C.GENERATED_TOKENS_TOTAL]["help"],
        )
    if steps:
        reg.counter_inc(
            C.DECODE_STEPS_TOTAL, float(steps),
            help=C.CATALOG[C.DECODE_STEPS_TOTAL]["help"],
        )


# -- request scheduler (modal_examples_tpu/scheduling) -----------------------


def record_shed(
    klass: str, reason: str, *, registry: Registry | None = None
) -> None:
    _reg(registry).counter_inc(
        C.SHEDS_TOTAL, 1.0,
        labels={"class": klass, "reason": reason},
        help=C.CATALOG[C.SHEDS_TOTAL]["help"],
    )


def record_admitted(klass: str, *, registry: Registry | None = None) -> None:
    _reg(registry).counter_inc(
        C.REQUESTS_ADMITTED_TOTAL, 1.0,
        labels={"class": klass},
        help=C.CATALOG[C.REQUESTS_ADMITTED_TOTAL]["help"],
    )


def set_sched_queue_depths(
    depths: dict, *, registry: Registry | None = None
) -> None:
    reg = _reg(registry)
    for klass, depth in depths.items():
        reg.gauge_set(
            C.SCHED_QUEUE_DEPTH, float(depth),
            labels={"class": klass},
            help=C.CATALOG[C.SCHED_QUEUE_DEPTH]["help"],
        )


def record_sched_queue_wait(
    klass: str, seconds: float, *, registry: Registry | None = None
) -> None:
    _reg(registry).histogram_observe(
        C.SCHED_QUEUE_WAIT_SECONDS, seconds,
        labels={"class": klass},
        help=C.CATALOG[C.SCHED_QUEUE_WAIT_SECONDS]["help"],
    )


def set_kv_pages_reserved(n: int, *, registry: Registry | None = None) -> None:
    _reg(registry).gauge_set(
        C.KV_PAGES_RESERVED, float(n),
        help=C.CATALOG[C.KV_PAGES_RESERVED]["help"],
    )


def record_deadline_miss(
    stage: str, *, registry: Registry | None = None
) -> None:
    _reg(registry).counter_inc(
        C.DEADLINE_MISSES_TOTAL, 1.0,
        labels={"stage": stage},
        help=C.CATALOG[C.DEADLINE_MISSES_TOTAL]["help"],
    )


# -- hot-path profiler (observability/profiler.py) ----------------------------


def record_tick_phase(
    phase: str, seconds: float, *, registry: Registry | None = None
) -> None:
    """One scheduler tick's host time attributed to ``phase`` (a
    ``catalog.TICK_PHASES`` member, or ``"total"`` for the whole tick).
    Called only by the hot-path profiler — with MTPU_PROFILE unset nothing
    reaches here (the zero-cost gate)."""
    _reg(registry).histogram_observe(
        C.TICK_PHASE_SECONDS,
        seconds,
        labels={"phase": phase},
        buckets=C.TICK_PHASE_BUCKETS,
        help=C.CATALOG[C.TICK_PHASE_SECONDS]["help"],
    )


def set_host_overhead_ratio(
    ratio: float, *, registry: Registry | None = None
) -> None:
    _reg(registry).gauge_set(
        C.HOST_OVERHEAD_RATIO, float(ratio),
        help=C.CATALOG[C.HOST_OVERHEAD_RATIO]["help"],
    )


# -- resource occupancy ------------------------------------------------------


def set_kv_occupancy(
    *, used: int, free: int, total_usable: int,
    registry: Registry | None = None,
) -> None:
    """KV page-allocator occupancy (``total_usable`` excludes the reserved
    trash page). Emitted by the allocator on alloc/free — per-request, not
    per-token, frequency."""
    reg = _reg(registry)
    reg.gauge_set(
        C.KV_PAGES_USED, float(used),
        help=C.CATALOG[C.KV_PAGES_USED]["help"],
    )
    reg.gauge_set(
        C.KV_PAGES_FREE, float(free),
        help=C.CATALOG[C.KV_PAGES_FREE]["help"],
    )
    reg.gauge_set(
        C.KV_PAGE_OCCUPANCY,
        used / total_usable if total_usable else 0.0,
        help=C.CATALOG[C.KV_PAGE_OCCUPANCY]["help"],
    )


def set_kv_cache_bytes(
    total_bytes: int, dtype: str, *, registry: Registry | None = None
) -> None:
    """Total HBM bytes of the paged KV cache arrays, labeled by the page
    dtype ("bfloat16" | "int8" | ...). Dtype-aware (int8 counts the int8
    payload + f32 scale rows), so the gauge shows the ~2x footprint
    headroom the quantized cache buys (docs/kv_cache.md)."""
    _reg(registry).gauge_set(
        C.KV_CACHE_BYTES, float(total_bytes), labels={"dtype": dtype},
        help=C.CATALOG[C.KV_CACHE_BYTES]["help"],
    )


def set_prefix_cache_pages(
    cached_pages: int, *, registry: Registry | None = None
) -> None:
    _reg(registry).gauge_set(
        C.PREFIX_CACHED_PAGES, float(cached_pages),
        help=C.CATALOG[C.PREFIX_CACHED_PAGES]["help"],
    )


def record_prefix_evictions(
    n: int, *, registry: Registry | None = None
) -> None:
    if n > 0:
        _reg(registry).counter_inc(
            C.PREFIX_CACHE_EVICTIONS_TOTAL, float(n),
            help=C.CATALOG[C.PREFIX_CACHE_EVICTIONS_TOTAL]["help"],
        )


# -- roofline / usage accounting (observability/usage.py) ---------------------


def set_roofline(
    phase: str, *, mfu: float, mbu: float, tflops: float,
    registry: Registry | None = None,
) -> None:
    """One phase's roofline position (``catalog.ROOFLINE_PHASES``): MFU and
    MBU as 0..1 fractions of the resolved generation's peaks, plus the
    absolute achieved TFLOP/s. Called from the usage meter's throttled
    flush — never per token."""
    reg = _reg(registry)
    reg.gauge_set(
        C.MFU, float(mfu),
        labels={"phase": phase},
        help=C.CATALOG[C.MFU]["help"],
    )
    reg.gauge_set(
        C.HBM_BW_UTIL, float(mbu),
        labels={"phase": phase},
        help=C.CATALOG[C.HBM_BW_UTIL]["help"],
    )
    reg.gauge_set(
        C.ACHIEVED_TFLOPS, float(tflops),
        labels={"phase": phase},
        help=C.CATALOG[C.ACHIEVED_TFLOPS]["help"],
    )


def record_usage_tokens(
    tenant: str, klass: str, *, prompt: int = 0, generated: int = 0,
    registry: Registry | None = None,
) -> None:
    """Per-tenant/class token counters (deltas, not totals — the usage
    meter accumulates and flushes from the engine's gauge-refresh
    throttle, the ``record_token_totals`` pattern)."""
    reg = _reg(registry)
    if prompt:
        reg.counter_inc(
            C.USAGE_PROMPT_TOKENS_TOTAL, float(prompt),
            labels={"tenant": tenant, "class": klass},
            help=C.CATALOG[C.USAGE_PROMPT_TOKENS_TOTAL]["help"],
        )
    if generated:
        reg.counter_inc(
            C.USAGE_GENERATED_TOKENS_TOTAL, float(generated),
            labels={"tenant": tenant, "class": klass},
            help=C.CATALOG[C.USAGE_GENERATED_TOKENS_TOTAL]["help"],
        )


def record_usage_seconds(
    tenant: str, klass: str, *, device_seconds: float = 0.0,
    kv_page_seconds: float = 0.0, registry: Registry | None = None,
) -> None:
    """Per-tenant residency deltas: slot-occupancy seconds and KV
    page-seconds (pages held x hold time), flushed with the token deltas."""
    reg = _reg(registry)
    if device_seconds > 0:
        reg.counter_inc(
            C.USAGE_DEVICE_SECONDS_TOTAL, float(device_seconds),
            labels={"tenant": tenant, "class": klass},
            help=C.CATALOG[C.USAGE_DEVICE_SECONDS_TOTAL]["help"],
        )
    if kv_page_seconds > 0:
        reg.counter_inc(
            C.USAGE_KV_PAGE_SECONDS_TOTAL, float(kv_page_seconds),
            labels={"tenant": tenant, "class": klass},
            help=C.CATALOG[C.USAGE_KV_PAGE_SECONDS_TOTAL]["help"],
        )


def record_usage_shed(
    tenant: str, klass: str, *, registry: Registry | None = None
) -> None:
    """One admission shed charged to the rejected tenant (the per-tenant
    split of ``record_shed`` — sheds are rare, so this one is immediate,
    not delta-flushed)."""
    _reg(registry).counter_inc(
        C.USAGE_SHEDS_TOTAL, 1.0,
        labels={"tenant": tenant, "class": klass},
        help=C.CATALOG[C.USAGE_SHEDS_TOTAL]["help"],
    )


def record_canary_tokens(
    replica: str, *, prompt: int = 0, generated: int = 0,
    registry: Registry | None = None,
) -> None:
    """Synthetic canary token deltas — the conservation-closing partner of
    the per-tenant usage counters the canary tenant is excluded from."""
    reg = _reg(registry)
    if prompt:
        reg.counter_inc(
            C.CANARY_TOKENS_TOTAL, float(prompt),
            labels={"replica": replica, "kind": "prompt"},
            help=C.CATALOG[C.CANARY_TOKENS_TOTAL]["help"],
        )
    if generated:
        reg.counter_inc(
            C.CANARY_TOKENS_TOTAL, float(generated),
            labels={"replica": replica, "kind": "generated"},
            help=C.CATALOG[C.CANARY_TOKENS_TOTAL]["help"],
        )


def record_multistep_dispatch(
    *, tokens: int, steps_saved: int = 0, registry: Registry | None = None
) -> None:
    """One harvested decode dispatch: ``tokens`` accepted across its
    slots, ``steps_saved`` whole macro-steps the on-device early-exit
    skipped (0 on the classic one-block path — both paths report here so
    tokens-per-dispatch is one series across the A/B bench arms)."""
    reg = _reg(registry)
    reg.counter_inc(
        C.MULTISTEP_DISPATCHES_TOTAL, 1.0,
        help=C.CATALOG[C.MULTISTEP_DISPATCHES_TOTAL]["help"],
    )
    if tokens:
        reg.counter_inc(
            C.MULTISTEP_TOKENS_TOTAL, float(tokens),
            help=C.CATALOG[C.MULTISTEP_TOKENS_TOTAL]["help"],
        )
    if steps_saved:
        reg.counter_inc(
            C.MULTISTEP_EARLY_EXIT_STEPS_TOTAL, float(steps_saved),
            help=C.CATALOG[C.MULTISTEP_EARLY_EXIT_STEPS_TOTAL]["help"],
        )


def set_multistep_gauges(
    *, decode_steps: int, tokens_per_dispatch: float,
    detok_queue_depth: int, registry: Registry | None = None,
) -> None:
    """Macro-step runtime gauges, refreshed with the engine's gauge sweep."""
    reg = _reg(registry)
    reg.gauge_set(
        C.MULTISTEP_DECODE_STEPS, float(decode_steps),
        help=C.CATALOG[C.MULTISTEP_DECODE_STEPS]["help"],
    )
    reg.gauge_set(
        C.MULTISTEP_TOKENS_PER_DISPATCH, float(tokens_per_dispatch),
        help=C.CATALOG[C.MULTISTEP_TOKENS_PER_DISPATCH]["help"],
    )
    reg.gauge_set(
        C.MULTISTEP_DETOK_QUEUE_DEPTH, float(detok_queue_depth),
        help=C.CATALOG[C.MULTISTEP_DETOK_QUEUE_DEPTH]["help"],
    )


def set_spec_gauges(
    *, gamma: float, tokens_per_dispatch: float, acceptance_rate: float,
    registry: Registry | None = None,
) -> None:
    """Speculative-round gauges, refreshed with the engine's gauge sweep.
    ``gamma`` is the p50 of the per-slot depths actually dispatched over the
    window (the adaptive controller's output, not the configured cap)."""
    reg = _reg(registry)
    reg.gauge_set(
        C.SPEC_GAMMA, float(gamma),
        help=C.CATALOG[C.SPEC_GAMMA]["help"],
    )
    reg.gauge_set(
        C.SPEC_TOKENS_PER_DISPATCH, float(tokens_per_dispatch),
        help=C.CATALOG[C.SPEC_TOKENS_PER_DISPATCH]["help"],
    )
    reg.gauge_set(
        C.SPEC_ACCEPTANCE_RATE, float(acceptance_rate),
        help=C.CATALOG[C.SPEC_ACCEPTANCE_RATE]["help"],
    )


def record_spec_fallback(
    n: int = 1, *, registry: Registry | None = None
) -> None:
    """Whole spec rounds that fell through to the classic block program
    (every live lane at γ=0: collapse, pressure, or sampled lanes)."""
    if n <= 0:
        return
    _reg(registry).counter_inc(
        C.SPEC_FALLBACK_TOTAL, float(n),
        help=C.CATALOG[C.SPEC_FALLBACK_TOTAL]["help"],
    )
