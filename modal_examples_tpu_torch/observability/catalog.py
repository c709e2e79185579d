"""The port's metric catalog, after ``modal_examples_tpu/observability/catalog.py``:
the series, span names and tick phases of the paths the port has, the
flight recorder's (tsdb, alerts, incidents, SLO burn), the correctness
canary's, the kernel builds' and the memory snapshots', and those of the
router, disaggregated serving, failover, the gray-failure watchdog, the
tiered prefix cache, the shared prefix store and the fleet autoscaler.

ONE module owns every metric name: code imports the constant, and no
``mtpu_*`` metric-name literal stands anywhere else in the package.
Conventions (Prometheus): ``_total`` counters, ``_seconds`` histograms,
unsuffixed gauges. Labels are listed per series in :data:`CATALOG`.
"""

from __future__ import annotations

# -- call lifecycle (core/executor.py) --------------------------------------

#: histogram {function, phase}: per-phase call latency; phases are
#: queue | boot | dispatch | execute | serialize | total
CALL_DURATION_SECONDS = "mtpu_call_duration_seconds"
#: histogram {function}: submit -> dispatch wait (the queue phase, dedicated
#: series so queue-wait distributions can be scraped without a phase filter)
QUEUE_WAIT_SECONDS = "mtpu_queue_wait_seconds"
#: gauge {function}: inputs submitted but not yet completed
INFLIGHT_INPUTS = "mtpu_inflight_inputs"
#: counter {function, reason}: retry attempts scheduled;
#: reason = timeout | container_death | user_error
RETRIES_TOTAL = "mtpu_retries_total"
#: counter {function, reason}: containers killed by the supervisor
#: (reason = timeout is the only kill the scheduler makes today)
CONTAINER_KILLS_TOTAL = "mtpu_container_kills_total"
#: gauge: supervisor-process resident set size, sampled by the executor
HOST_RSS_BYTES = "mtpu_host_rss_bytes"
#: counter {function, action}: autoscaler decisions recorded to the journal;
#: action = scale_up | scale_down | kill
SCALER_DECISIONS_TOTAL = "mtpu_scaler_decisions_total"

# -- memory snapshots (snapshot/) --------------------------------------------

#: counter {function, result}: snapshot-enabled container boots;
#: result = hit | miss | fallback
SNAPSHOT_BOOTS_METRIC = "mtpu_snapshot_boots_total"
#: counter {function}: snapshots captured and published to the store
SNAPSHOT_CAPTURES_METRIC = "mtpu_snapshot_captures_total"
#: counter {point}: injected faults that FIRED, by catalog point name
#: (faults/inject.py POINTS)
FAULTS_INJECTED_TOTAL = "mtpu_faults_injected_total"

# -- serving engine (serving/engine.py batch loop) --------------------------

#: histogram {phase}: engine hot-loop phase latency;
#: phase = prefill | prefill_chunked | decode_wait
ENGINE_PHASE_SECONDS = "mtpu_engine_phase_seconds"
#: histogram: slots active per dispatched decode block (batch composition)
ENGINE_BATCH_SIZE = "mtpu_engine_batch_size"
#: histogram: request submit -> prefill admission wait
ENGINE_QUEUE_WAIT_SECONDS = "mtpu_engine_queue_wait_seconds"
#: gauge: requests waiting for admission (engine queue depth)
WAITING_REQUESTS = "mtpu_waiting_requests"
#: gauge: slots currently decoding
ACTIVE_SLOTS = "mtpu_active_slots"
#: gauge: generated tokens per second since engine start
TOKENS_PER_SECOND = "mtpu_tokens_per_second"
#: counter: scheduler-loop exceptions (engine.error_count mirror)
SCHEDULER_ERRORS_TOTAL = "mtpu_scheduler_errors_total"

# -- stall-free admission (serving/engine.py prefill budget) ---------------

#: histogram: gap between consecutive decode-block dispatches while
#: decodable slots exist (the stall-free admission contract: bounded by
#: ~one prefill chunk under a budget)
DECODE_STALL_SECONDS = "mtpu_decode_stall_seconds"
#: gauge: prompt tokens admitted to a slot whose chunked prefill has not
#: finished yet (the sliced-prefill remainder summed over slots)
PREFILL_BACKLOG_TOKENS = "mtpu_prefill_backlog_tokens"
#: counter: sliced-prefill suspensions — a chunked prefill paused
#: mid-prompt because the per-tick token budget was spent
PREFILL_SLICED_TOTAL = "mtpu_prefill_sliced_total"

# -- token-level serving telemetry (serving/engine.py) ----------------------

#: histogram: request submit -> first generated token emitted (TTFT)
TTFT_SECONDS = "mtpu_ttft_seconds"
#: histogram: inter-token interval between consecutive generated tokens
#: of one request (TPOT / time-per-output-token)
TPOT_SECONDS = "mtpu_tpot_seconds"

# -- resource occupancy (kv cache / prefix cache / snapshot store / host) ---

#: gauge: pages currently allocated out of the paged KV cache
KV_PAGES_USED = "mtpu_kv_pages_used"
#: gauge: allocated fraction of the usable KV page pool (0..1)
KV_PAGE_OCCUPANCY = "mtpu_kv_page_occupancy"
#: gauge {dtype}: total HBM bytes of the paged KV cache arrays (dtype-aware:
#: int8 caches report ~half the bf16 footprint — docs/kv_cache.md)
KV_CACHE_BYTES = "mtpu_kv_cache_bytes"
#: counter: zero-ref prefix-cache pages reclaimed under allocator pressure
PREFIX_CACHE_EVICTIONS_TOTAL = "mtpu_prefix_cache_evictions_total"
#: gauge: total payload bytes resident in the memory-snapshot store
SNAPSHOT_STORE_BYTES = "mtpu_snapshot_store_bytes"
#: gauge: entries resident in the memory-snapshot store
SNAPSHOT_STORE_ENTRIES = "mtpu_snapshot_store_entries"
#: counter {result}: snapshot-store lookups (result = hit | miss)
SNAPSHOT_STORE_GETS_TOTAL = "mtpu_snapshot_store_gets_total"

# -- request scheduler (scheduling/) ---------------------------------------

#: counter {class, reason}: requests shed by admission control;
#: reason = queue_full | kv_pressure | too_large | injected (chaos)
SHEDS_TOTAL = "mtpu_sheds_total"
#: counter {class}: requests accepted by admission control
REQUESTS_ADMITTED_TOTAL = "mtpu_requests_admitted_total"
#: gauge {class}: requests queued per priority class (policy depth)
SCHED_QUEUE_DEPTH = "mtpu_sched_queue_depth"
#: histogram {class}: per-class submit -> prefill-admission wait
SCHED_QUEUE_WAIT_SECONDS = "mtpu_sched_queue_wait_seconds"
#: gauge: KV pages reserved by queued (not-yet-claimed) admissions
KV_PAGES_RESERVED = "mtpu_kv_pages_reserved"
#: counter {stage}: requests that blew their deadline;
#: stage = queued (cancelled before a slot) | prefill (aborted while the
#: sliced prefill was still filling KV) | inflight (aborted mid-decode) |
#: migrating (aborted during a disagg page migration)
DEADLINE_MISSES_TOTAL = "mtpu_deadline_misses_total"

# -- hot-path profiler (observability/profiler.py) -------------------------

#: the scheduler-tick phase taxonomy the hot-path profiler attributes —
#: THE phase vocabulary: ``serving/engine.py`` marks phases only through
#: these names and ``tests/test_static.py`` enforces the closure in both
#: directions, so a phase the scheduler stops marking (or marks under a
#: new ad-hoc spelling) fails the suite instead of rotting in dashboards.
#: Rendering order is anatomical: control -> admission -> prefill ->
#: decode -> harvest -> emit.
TICK_PHASES = (
    "ctrl",              # scheduler control commands (migration extraction)
    "policy",            # deadline expiry, abort reaps, gauge refresh
    "admit",             # policy pops, page claims, slot installs
    "prefill_resume",    # budgeted sliced-prefill chunk advance
    "prefill_dispatch",  # batched/chunked prefill program dispatch
    "decode_dispatch",   # decode-block program dispatch (async)
    "harvest",           # blocking device reads (tokens ready on host)
    "detokenize",        # incremental tokenizer.decode per accepted token
    "accept",            # token bookkeeping, stop handling, stream emit
)
#: extra ``{phase}`` label value carrying the WHOLE-tick duration, so
#: ``overhead.tick_p95`` is one histogram read (not declared in
#: TICK_PHASES: it is the denominator, not an attribution)
TICK_TOTAL_PHASE = "total"

#: histogram {phase}: per-tick host time attributed to one scheduler phase
#: (phase = TICK_PHASES, plus "total" for the whole-tick duration).
#: Emitted ONLY under MTPU_PROFILE — the disabled hot path takes zero new
#: timestamps (the faults-gate zero-cost contract)
TICK_PHASE_SECONDS = "mtpu_tick_phase_seconds"
#: gauge: host share of busy-tick time over the profiler ring —
#: 1 - (device-blocked seconds / total tick seconds); the per-token host
#: overhead the multi-step decode loop exists to amortize
HOST_OVERHEAD_RATIO = "mtpu_host_overhead_ratio"

# -- macro-step decode runtime (serving/multistep/) ------------------------

#: gauge: the configured decode steps per dispatch (the runtime-mutable
#: ``decode_steps`` knob / MTPU_DECODE_STEPS; 1 = classic block path)
MULTISTEP_DECODE_STEPS = "mtpu_multistep_decode_steps"
#: gauge: accepted tokens per decode dispatch over the last gauge window —
#: the headline amortization number (classic path reports it too, so the
#: A/B bench reads one series across both arms)
MULTISTEP_TOKENS_PER_DISPATCH = "mtpu_multistep_tokens_per_dispatch"
#: counter: decode dispatches harvested (one per blocking device read)
MULTISTEP_DISPATCHES_TOTAL = "mtpu_multistep_dispatches_total"
#: counter: tokens accepted from harvested decode dispatches
MULTISTEP_TOKENS_TOTAL = "mtpu_multistep_tokens_total"
#: counter: whole macro-steps the on-device early-exit skipped (every lane
#: dead — the ``masked_scan`` hold branch ran instead of the transformer)
MULTISTEP_EARLY_EXIT_STEPS_TOTAL = "mtpu_multistep_early_exit_steps_total"
#: gauge: events pending on the detokenization worker's queue (a growing
#: depth means text emission is falling behind the scheduler)
MULTISTEP_DETOK_QUEUE_DEPTH = "mtpu_multistep_detok_queue_depth"

# -- speculative decoding (serving/spec_runtime/) --------------------------

#: gauge: dispatched per-slot speculation depth, p50 over the last gauge
#: window (the adaptive controller's output; 0 means lanes ride the classic
#: γ=0 path inside the round)
SPEC_GAMMA = "mtpu_spec_gamma"
#: gauge: harvested tokens per speculative round over the last gauge window
#: (held when idle)
SPEC_TOKENS_PER_DISPATCH = "mtpu_spec_tokens_per_dispatch"
#: gauge: lifetime draft-token acceptance rate (accepted / proposed)
SPEC_ACCEPTANCE_RATE = "mtpu_spec_acceptance_rate"
#: counter: whole decode rounds where no slot speculated and the engine fell
#: through to the classic block program
SPEC_FALLBACK_TOTAL = "mtpu_spec_fallback_total"

# -- OpenAI-compatible server /metrics (serving/openai_api.py) --------------

GENERATED_TOKENS_TOTAL = "mtpu_generated_tokens_total"
PROMPT_TOKENS_TOTAL = "mtpu_prompt_tokens_total"
DECODE_STEPS_TOTAL = "mtpu_decode_steps_total"
KV_PAGES_FREE = "mtpu_kv_pages_free"
DECODE_IMPL = "mtpu_decode_impl"
SPEC_PROPOSED_TOTAL = "mtpu_spec_proposed_total"
SPEC_ACCEPTED_TOTAL = "mtpu_spec_accepted_total"
# (SPEC_ACCEPTANCE_RATE lives in the fused-speculative section above — the
# /metrics hand-built exposition and the gauge sweep share one name)
PREFIX_CACHE_HITS_TOTAL = "mtpu_prefix_cache_hits_total"
PREFIX_CACHE_MISSES_TOTAL = "mtpu_prefix_cache_misses_total"
PREFIX_CACHED_PAGES = "mtpu_prefix_cached_pages"

# -- roofline / usage accounting (observability/usage.py) ------------------

#: the work-model phase vocabulary the roofline gauges label by: prefill
#: and decode are attributed separately (their roofline positions differ —
#: prefill is compute-rich, decode streams weights+KV), "total" is the
#: flops/bytes-weighted combination the BENCH `utilization` headline uses
ROOFLINE_PHASES = ("prefill", "decode", "total")

#: gauge {phase}: model FLOPs utilization — analytic FLOPs accounted to
#: the phase over (device seconds x peak TFLOP/s x chips), against the
#: core/resources.py bf16 peak for the resolved generation (MTPU_TPU_GEN)
MFU = "mtpu_mfu"
#: gauge {phase}: HBM bandwidth utilization (MBU) — analytic bytes moved
#: (weight stream + kv_dtype-aware KV reads) over (device seconds x peak
#: HBM GB/s x chips); sustained collapse while decodable slots exist is
#: the wedge-precursor signature the mbu_collapse alert rule watches
HBM_BW_UTIL = "mtpu_hbm_bw_util"
#: gauge {phase}: achieved TFLOP/s over the phase's accounted device time
#: (the numerator MFU normalizes — kept as its own series so dashboards
#: can plot absolute roofline position, not just the ratio)
ACHIEVED_TFLOPS = "mtpu_achieved_tflops"

#: counter {tenant, class}: prompt tokens prefilled, attributed to the
#: submitting tenant and priority class (Σ tenants == engine totals —
#: the conservation contract tests/test_usage.py asserts)
USAGE_PROMPT_TOKENS_TOTAL = "mtpu_usage_prompt_tokens_total"
#: counter {tenant, class}: generated tokens accepted per tenant/class
USAGE_GENERATED_TOKENS_TOTAL = "mtpu_usage_generated_tokens_total"
#: counter {tenant, class}: decode-slot occupancy seconds (install ->
#: release on the engine clock) — the device-seconds a tenant held
USAGE_DEVICE_SECONDS_TOTAL = "mtpu_usage_device_seconds_total"
#: counter {tenant, class}: KV page-seconds (pages held x hold seconds)
#: — the HBM-residency integral behind per-tenant memory billing
USAGE_KV_PAGE_SECONDS_TOTAL = "mtpu_usage_kv_page_seconds_total"
#: counter {tenant, class}: admission sheds charged to the tenant whose
#: request was rejected (the per-tenant split of mtpu_sheds_total)
USAGE_SHEDS_TOTAL = "mtpu_usage_sheds_total"

# -- correctness canary (observability/canary.py) ---------------------------

#: counter {replica, result}: golden-set probes completed per replica;
#: result = pass (bit-exact vs golden) | drift (token mismatch) | error
#: (probe died before finishing) | recorded (golden captured on first
#: contact with this model+fingerprint — never compared, never gated)
CANARY_PROBES_TOTAL = "mtpu_canary_probes_total"
#: counter {replica}: probes whose generated tokens diverged bit-exact
#: from the pinned golden transcript — the numeric-drift sentinel the
#: canary_drift alert rule keys on
CANARY_DRIFT_TOTAL = "mtpu_canary_drift_total"
#: histogram {replica}: client-observed TTFT of canary probes (submit ->
#: first streamed piece) — active latency probing on the real serving path
CANARY_TTFT_SECONDS = "mtpu_canary_ttft_seconds"
#: histogram {replica}: client-observed inter-piece latency of canary
#: probes (the probe-side TPOT proxy)
CANARY_TPOT_SECONDS = "mtpu_canary_tpot_seconds"
#: histogram {replica}: end-to-end canary probe latency (submit -> stream
#: drained) — the canary_latency_burn alert rule's input
CANARY_E2E_SECONDS = "mtpu_canary_e2e_seconds"
#: counter {replica, kind}: synthetic canary tokens (kind=prompt|generated)
#: — excluded from per-tenant usage billing and the usage journal, counted
#: here instead so conservation stays closed: Σ usage tenants + canary ==
#: engine totals
CANARY_TOKENS_TOTAL = "mtpu_canary_tokens_total"
#: gauge {replica}: consecutive failing canary rounds (0 = passing)
CANARY_FAILING = "mtpu_canary_failing"

# -- flight recorder: metrics history, alerts, incidents ---------------------

#: counter: sampler scrape cycles appended to the on-disk tsdb
#: (emitted only while MTPU_TSDB is on — the zero-cost-when-off gate)
TSDB_SAMPLES_TOTAL = "mtpu_tsdb_samples_total"
#: histogram: wall seconds one scrape cycle spent snapshotting the registry
#: and appending its record (the sampler's own overhead)
TSDB_SCRAPE_SECONDS = "mtpu_tsdb_scrape_seconds"
#: counter: tsdb segment rotations (a new JSONL segment opened; old
#: segments LRU-pruned past the ring bound)
TSDB_ROTATIONS_TOTAL = "mtpu_tsdb_rotations_total"
#: gauge: distinct (series, label set) pairs captured by the last scrape
TSDB_SERIES = "mtpu_tsdb_series"
#: gauge {rule}: 1 while the named alert rule is firing, 0 otherwise
ALERTS_ACTIVE = "mtpu_alerts_active"
#: counter {rule}: fire transitions of the named alert rule (clears don't
#: count — the journal carries the full fire/clear history)
ALERTS_FIRED_TOTAL = "mtpu_alerts_fired_total"
#: counter {trigger}: incident bundles captured; trigger = watchdog_wedge |
#: watchdog_quarantine | scheduler_crash | chaos_invariant | alert |
#: canary_drift | stage_failure | manual
INCIDENTS_CAPTURED_TOTAL = "mtpu_incidents_captured_total"
#: gauge {slo}: observed/target burn rate per declared SLO (>1 = violating)
SLO_BURN_RATE = "mtpu_slo_burn_rate"
# -- gray-failure watchdog (serving/health.py) ------------------------------

#: gauge {replica, state}: one-hot replica classification by the progress
#: watchdog (state = healthy | degraded | wedged | quarantined; exactly one
#: state reads 1 per replica)
WATCHDOG_REPLICA_STATE = "mtpu_watchdog_replica_state"
#: gauge {replica}: worst stale age (seconds) among the replica's mandatory
#: progress watermarks — 0 while idle (staleness only counts against
#: outstanding work)
WATCHDOG_PROGRESS_AGE_SECONDS = "mtpu_watchdog_progress_age_seconds"
#: counter {state}: classification transitions (entering the labeled state)
WATCHDOG_TRANSITIONS_TOTAL = "mtpu_watchdog_transitions_total"
#: counter {action}: recovery-ladder actions taken; action = down_weight |
#: restore_weight | abort_transfer | stop_revive | quarantine | unquarantine
WATCHDOG_RECOVERIES_TOTAL = "mtpu_watchdog_recoveries_total"

# -- multi-replica routing (scheduling/router.py) ---------------------------

#: counter {route}: router placements; route = affinity | fallback
ROUTER_REQUESTS_TOTAL = "mtpu_router_requests_total"
#: counter: repeated shared-prefix prompts landed on their affinity replica
ROUTER_AFFINITY_HITS_TOTAL = "mtpu_router_affinity_hits_total"
#: counter: unhealthy replicas re-admitted to the candidate set after a
#: successful health re-probe (docs/faults.md: unhealthy is not a one-way
#: door — flapped replicas rejoin route()/plan() once they probe healthy)
ROUTER_READMISSIONS_TOTAL = "mtpu_router_readmissions_total"

# -- disaggregated serving (serving/disagg) ----------------------------------

#: counter {result}: page migrations between replicas;
#: result = ok | fallback (unified re-prefill) | aborted (client/deadline)
DISAGG_MIGRATIONS_TOTAL = "mtpu_disagg_migrations_total"
#: counter: KV pages successfully migrated prefill -> decode
DISAGG_PAGES_MIGRATED_TOTAL = "mtpu_disagg_pages_migrated_total"
#: counter: serialized wire bytes of successful migrations (int8 caches
#: ship ~half the bf16 bytes — the PR 5 residency win on the wire)
DISAGG_MIGRATION_BYTES_TOTAL = "mtpu_disagg_migration_bytes_total"
#: histogram: end-to-end migration latency (prefill start -> adopt/fail)
DISAGG_MIGRATION_SECONDS = "mtpu_disagg_migration_seconds"
#: gauge: migrations currently in flight (prefilling or on the wire)
DISAGG_MIGRATIONS_INFLIGHT = "mtpu_disagg_migrations_inflight"
#: counter: transfer chunks re-sent after loss/corruption (resumable retry)
DISAGG_CHUNK_RETRIES_TOTAL = "mtpu_disagg_chunk_retries_total"
#: gauge {replica, role}: info metric (value 1) — each replica's serving
#: role (prefill | decode | unified)
REPLICA_ROLE = "mtpu_replica_role"

# -- in-flight request failover (serving/failover.py) ------------------------

#: counter {mode, result}: in-flight request takeovers; mode = reactive
#: (replica died — re-prefill prompt+generated-prefix from the decode
#: checkpoint) | migrate (proactive live KV migration on drain/rebalance);
#: result = ok | failed (no healthy target / resubmission shed)
FAILOVER_TOTAL = "mtpu_failover_total"
#: counter: generated-prefix tokens replayed (teacher-forced through the
#: decode program) on reactive failover — the work redone because the dead
#: replica's KV was lost; the prompt half re-prefills from the (often
#: warm) prefix cache — docs/failover.md
FAILOVER_TOKENS_REPLAYED_TOTAL = "mtpu_failover_tokens_replayed_total"
#: histogram: client-observed takeover latency — stream error detected (or
#: migration started) to the resumed request accepted on the new replica
FAILOVER_TAKEOVER_SECONDS = "mtpu_failover_takeover_seconds"
#: counter {result}: proactive live migrations of MID-DECODE requests
#: (result = ok | fallback (reactive resume carried it after a wire/adopt
#: failure) | aborted (client abort / deadline during the migration) |
#: failed (reservation shed, victim unresponsive, or the fallback resume
#: itself refused — the request was NOT moved))
MIGRATION_LIVE_TOTAL = "mtpu_migration_live_total"
#: counter: decode tokens carried across live migrations (each migrated
#: request contributes its generated-so-far count — the work scale-in no
#: longer throws away; ``fleet.jsonl``'s ``tokens_migrated`` source)
MIGRATION_LIVE_TOKENS_TOTAL = "mtpu_migration_live_tokens_total"
#: histogram: live-migration latency, checkpoint extraction -> adopted on
#: the target (the bound on drain time per request)
MIGRATION_LIVE_SECONDS = "mtpu_migration_live_seconds"

# -- tiered prefix cache (serving/disagg/tiered_cache.py) -------------------

#: counter {tier}: prefix PAGES served per tier (page units on every tier,
#: so rates are comparable); tier = hbm (trie-shared pages) | host (RAM
#: promotes) | volume (spill promotes). Only tiered engines emit it.
PREFIX_TIER_HITS_TOTAL = "mtpu_prefix_tier_hits_total"
#: gauge {tier}: prefix blocks resident per spill tier (host | volume)
PREFIX_TIER_PAGES = "mtpu_prefix_tier_pages"
#: gauge {tier}: serialized bytes resident per spill tier (host | volume)
PREFIX_TIER_BYTES = "mtpu_prefix_tier_bytes"

# -- shared prefix store (serving/prefix_store/) ----------------------------

#: counter {origin}: blocks served by the fleet-shared store; origin =
#: self (this replica wrote it) | peer (another replica's spill — the
#: cross-replica warmth the store exists for)
PREFIX_STORE_HITS_TOTAL = "mtpu_prefix_store_hits_total"
#: counter: store lookups that found nothing (or a torn block, dropped)
PREFIX_STORE_MISSES_TOTAL = "mtpu_prefix_store_misses_total"
#: gauge: logical spill attempts per physical write (> 1.0 = the fleet
#: stopped paying N copies of shared chains)
PREFIX_STORE_DEDUP_RATIO = "mtpu_prefix_store_dedup_ratio"
#: gauge: serialized bytes resident in the shared store
PREFIX_STORE_BYTES = "mtpu_prefix_store_bytes"
#: counter: spill leases taken over from a dead/expired owner replica
#: (journaled in prefix_store.jsonl; the chaos owner-death episode's proof)
PREFIX_STORE_OWNER_TAKEOVERS_TOTAL = "mtpu_prefix_store_owner_takeovers_total"

# -- fleet autoscaler (fleet/) ---------------------------------------------

#: gauge {role}: replicas currently registered in the fleet, by serving
#: role (prefill | decode | unified) — the closed-loop autoscaler's output
FLEET_REPLICAS = "mtpu_fleet_replicas"
#: counter {action, trigger}: fleet autoscaler decisions journaled to
#: <state_dir>/fleet.jsonl; action = scale_up | scale_down, trigger =
#: slo_burn | queue_pressure | kv_pressure | shed_pressure | idle |
#: min_replicas (floor fill) | drain_timeout (forced reap) | quarantine
#: (the watchdog benched a replica: replace its capacity)
FLEET_DECISIONS_TOTAL = "mtpu_fleet_decisions_total"
#: histogram {boot}: replica build+start seconds at scale-out;
#: boot = warm (snapshot-restored params) | cold (full init)
FLEET_BOOT_SECONDS = "mtpu_fleet_boot_seconds"

# -- kernel builds (ops/_build.py): the port's compile ledger ----------------

#: counter {program, cache}: kernel-library lookups at first use; cache =
#: miss (an nvcc build, timed and appended to <state_dir>/compiles.jsonl)
#: | hit (a library already built under build/kernels)
COMPILES_TOTAL = "mtpu_compiles_total"
#: histogram {program}: seconds one kernel build took (program = the csrc
#: kernel's name)
COMPILE_SECONDS = "mtpu_compile_seconds"


#: machine-readable catalog: name -> {type, labels, help}; the recorders
#: take each series' help text from here.
CATALOG: dict[str, dict] = {
    CANARY_PROBES_TOTAL: {
        "type": "counter", "labels": ["replica", "result"],
        "help": "golden-set canary probes per replica "
                "(result=pass|drift|error|recorded)",
    },
    CANARY_DRIFT_TOTAL: {
        "type": "counter", "labels": ["replica"],
        "help": "canary probes whose generated tokens diverged from the "
                "pinned golden transcript",
    },
    CANARY_TTFT_SECONDS: {
        "type": "histogram", "labels": ["replica"],
        "help": "client-observed TTFT of canary probes",
    },
    CANARY_TPOT_SECONDS: {
        "type": "histogram", "labels": ["replica"],
        "help": "client-observed inter-piece latency of canary probes",
    },
    CANARY_E2E_SECONDS: {
        "type": "histogram", "labels": ["replica"],
        "help": "end-to-end canary probe latency (submit -> stream drained)",
    },
    CANARY_FAILING: {
        "type": "gauge", "labels": ["replica"],
        "help": "consecutive failing canary rounds per replica (0=passing)",
    },
    TSDB_SAMPLES_TOTAL: {
        "type": "counter", "labels": [],
        "help": "sampler scrape cycles appended to the on-disk tsdb",
    },
    TSDB_SCRAPE_SECONDS: {
        "type": "histogram", "labels": [],
        "help": "wall seconds per tsdb scrape cycle (sampler overhead)",
    },
    TSDB_ROTATIONS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "tsdb segment rotations (ring-bounded JSONL segments)",
    },
    TSDB_SERIES: {
        "type": "gauge", "labels": [],
        "help": "distinct series captured by the last tsdb scrape",
    },
    ALERTS_ACTIVE: {
        "type": "gauge", "labels": ["rule"],
        "help": "1 while the named alert rule is firing, 0 otherwise",
    },
    ALERTS_FIRED_TOTAL: {
        "type": "counter", "labels": ["rule"],
        "help": "fire transitions of the named alert rule",
    },
    INCIDENTS_CAPTURED_TOTAL: {
        "type": "counter", "labels": ["trigger"],
        "help": "incident bundles captured (trigger=watchdog_wedge|"
                "watchdog_quarantine|scheduler_crash|chaos_invariant|"
                "alert|canary_drift|stage_failure|manual)",
    },
    SLO_BURN_RATE: {
        "type": "gauge", "labels": ["slo"],
        "help": "observed/target burn rate per declared SLO (>1 violating)",
    },
    WATCHDOG_REPLICA_STATE: {
        "type": "gauge", "labels": ["replica", "state"],
        "help": "one-hot watchdog classification per replica "
                "(state=healthy|degraded|wedged|quarantined)",
    },
    WATCHDOG_PROGRESS_AGE_SECONDS: {
        "type": "gauge", "labels": ["replica"],
        "help": "worst stale age among a replica's mandatory progress "
                "watermarks (0 while idle)",
    },
    WATCHDOG_TRANSITIONS_TOTAL: {
        "type": "counter", "labels": ["state"],
        "help": "watchdog classification transitions (entering the state)",
    },
    WATCHDOG_RECOVERIES_TOTAL: {
        "type": "counter", "labels": ["action"],
        "help": "watchdog recovery-ladder actions (action=down_weight|"
                "restore_weight|abort_transfer|stop_revive|quarantine|"
                "unquarantine)",
    },
    ROUTER_REQUESTS_TOTAL: {
        "type": "counter", "labels": ["route"],
        "help": "router placements (route=affinity|fallback)",
    },
    ROUTER_AFFINITY_HITS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "repeated shared-prefix prompts landed on their affinity "
                "replica",
    },
    ROUTER_READMISSIONS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "unhealthy replicas re-admitted after a health re-probe",
    },
    DISAGG_MIGRATIONS_TOTAL: {
        "type": "counter", "labels": ["result"],
        "help": "page migrations between replicas "
                "(result=ok|fallback|aborted)",
    },
    DISAGG_PAGES_MIGRATED_TOTAL: {
        "type": "counter", "labels": [],
        "help": "KV pages successfully migrated prefill -> decode",
    },
    DISAGG_MIGRATION_BYTES_TOTAL: {
        "type": "counter", "labels": [],
        "help": "serialized wire bytes of successful page migrations",
    },
    DISAGG_MIGRATION_SECONDS: {
        "type": "histogram", "labels": [],
        "help": "end-to-end migration latency (prefill start to adopt/fail)",
    },
    DISAGG_MIGRATIONS_INFLIGHT: {
        "type": "gauge", "labels": [],
        "help": "migrations currently in flight",
    },
    DISAGG_CHUNK_RETRIES_TOTAL: {
        "type": "counter", "labels": [],
        "help": "transfer chunks re-sent after loss/corruption",
    },
    REPLICA_ROLE: {
        "type": "gauge", "labels": ["replica", "role"],
        "help": "replica serving role, info metric "
                "(role=prefill|decode|unified, value 1)",
    },
    FAILOVER_TOTAL: {
        "type": "counter", "labels": ["mode", "result"],
        "help": "in-flight request takeovers "
                "(mode=reactive|migrate, result=ok|failed)",
    },
    FAILOVER_TOKENS_REPLAYED_TOTAL: {
        "type": "counter", "labels": [],
        "help": "generated-prefix tokens replayed through the decode "
                "program on reactive failover",
    },
    FAILOVER_TAKEOVER_SECONDS: {
        "type": "histogram", "labels": [],
        "help": "takeover latency: failure detected to resumed request "
                "accepted on the new replica",
    },
    MIGRATION_LIVE_TOTAL: {
        "type": "counter", "labels": ["result"],
        "help": "proactive live migrations of mid-decode requests "
                "(result=ok|fallback|aborted|failed)",
    },
    MIGRATION_LIVE_TOKENS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "decode tokens carried across live migrations",
    },
    MIGRATION_LIVE_SECONDS: {
        "type": "histogram", "labels": [],
        "help": "live-migration latency: checkpoint extraction to adopted "
                "on the target",
    },
    PREFIX_TIER_HITS_TOTAL: {
        "type": "counter", "labels": ["tier"],
        "help": "prefix pages served per tier (tier=hbm|host|volume)",
    },
    PREFIX_TIER_PAGES: {
        "type": "gauge", "labels": ["tier"],
        "help": "prefix blocks resident per spill tier",
    },
    PREFIX_TIER_BYTES: {
        "type": "gauge", "labels": ["tier"],
        "help": "serialized bytes resident per spill tier",
    },
    PREFIX_STORE_HITS_TOTAL: {
        "type": "counter", "labels": ["origin"],
        "help": "shared prefix-store blocks served (origin=self|peer; "
                "peer = another replica's spill promoted here)",
    },
    PREFIX_STORE_MISSES_TOTAL: {
        "type": "counter", "labels": [],
        "help": "shared prefix-store lookups that found nothing "
                "(torn blocks dropped count here too)",
    },
    PREFIX_STORE_DEDUP_RATIO: {
        "type": "gauge", "labels": [],
        "help": "logical spill attempts per physical store write "
                "(> 1.0 = cross-replica dedup is paying)",
    },
    PREFIX_STORE_BYTES: {
        "type": "gauge", "labels": [],
        "help": "serialized bytes resident in the shared prefix store",
    },
    PREFIX_STORE_OWNER_TAKEOVERS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "spill leases taken over from dead/expired owner replicas",
    },
    FLEET_REPLICAS: {
        "type": "gauge", "labels": ["role"],
        "help": "replicas registered in the fleet, by serving role",
    },
    FLEET_DECISIONS_TOTAL: {
        "type": "counter", "labels": ["action", "trigger"],
        "help": "fleet autoscaler decisions journaled "
                "(action=scale_up|scale_down, trigger=slo_burn|"
                "queue_pressure|kv_pressure|shed_pressure|idle|"
                "min_replicas|drain_timeout|quarantine)",
    },
    FLEET_BOOT_SECONDS: {
        "type": "histogram", "labels": ["boot"],
        "help": "replica build+start seconds at scale-out "
                "(boot=warm snapshot-restored | cold full init)",
    },
    COMPILES_TOTAL: {
        "type": "counter", "labels": ["program", "cache"],
        "help": "kernel-library lookups at first use "
                "(cache=miss nvcc build, ledgered | hit already built)",
    },
    COMPILE_SECONDS: {
        "type": "histogram", "labels": ["program"],
        "help": "kernel build seconds (program=the csrc kernel)",
    },
    CALL_DURATION_SECONDS: {
        "type": "histogram",
        "labels": ["function", "phase"],
        "help": "per-phase call latency "
                "(queue|boot|dispatch|execute|serialize|total)",
    },
    QUEUE_WAIT_SECONDS: {
        "type": "histogram",
        "labels": ["function"],
        "help": "submit-to-dispatch queue wait",
    },
    INFLIGHT_INPUTS: {
        "type": "gauge",
        "labels": ["function"],
        "help": "inputs submitted but not yet completed",
    },
    RETRIES_TOTAL: {
        "type": "counter",
        "labels": ["function", "reason"],
        "help": "retry attempts scheduled "
                "(reason=timeout|container_death|user_error)",
    },
    CONTAINER_KILLS_TOTAL: {
        "type": "counter",
        "labels": ["function", "reason"],
        "help": "containers killed by the supervisor",
    },
    SNAPSHOT_BOOTS_METRIC: {
        "type": "counter",
        "labels": ["function", "result"],
        "help": "snapshot-enabled container boots (result=hit|miss|fallback)",
    },
    SNAPSHOT_CAPTURES_METRIC: {
        "type": "counter",
        "labels": ["function"],
        "help": "memory snapshots captured and published to the store",
    },
    HOST_RSS_BYTES: {
        "type": "gauge", "labels": [],
        "help": "supervisor-process resident set size (bytes)",
    },
    SCALER_DECISIONS_TOTAL: {
        "type": "counter", "labels": ["function", "action"],
        "help": "autoscaler decisions journaled "
                "(action=scale_up|scale_down|kill)",
    },
    FAULTS_INJECTED_TOTAL: {
        "type": "counter", "labels": ["point"],
        "help": "injected faults fired, by faults/inject.py catalog point",
    },
    ENGINE_PHASE_SECONDS: {
        "type": "histogram",
        "labels": ["phase"],
        "help": "engine hot-loop phase latency "
                "(prefill|prefill_chunked|decode_wait)",
    },
    ENGINE_BATCH_SIZE: {
        "type": "histogram",
        "labels": [],
        "help": "active slots per dispatched decode block",
    },
    ENGINE_QUEUE_WAIT_SECONDS: {
        "type": "histogram",
        "labels": [],
        "help": "request submit-to-admission wait",
    },
    WAITING_REQUESTS: {
        "type": "gauge",
        "labels": [],
        "help": "requests waiting for admission",
    },
    ACTIVE_SLOTS: {
        "type": "gauge",
        "labels": [],
        "help": "slots currently decoding",
    },
    TOKENS_PER_SECOND: {
        "type": "gauge",
        "labels": [],
        "help": "generated tokens per second since engine start",
    },
    SCHEDULER_ERRORS_TOTAL: {
        "type": "counter",
        "labels": [],
        "help": "engine scheduler-loop exceptions",
    },
    DECODE_STALL_SECONDS: {
        "type": "histogram",
        "labels": [],
        "help": "gap between consecutive decode-block dispatches while "
                "decodable slots exist (stall-free admission contract)",
    },
    PREFILL_BACKLOG_TOKENS: {
        "type": "gauge",
        "labels": [],
        "help": "prompt tokens admitted to slots but not yet prefilled "
                "(sliced-prefill remainder)",
    },
    PREFILL_SLICED_TOTAL: {
        "type": "counter",
        "labels": [],
        "help": "chunked prefills suspended mid-prompt by the per-tick "
                "token budget",
    },
    TTFT_SECONDS: {
        "type": "histogram",
        "labels": [],
        "help": "request submit to first generated token (TTFT)",
    },
    TPOT_SECONDS: {
        "type": "histogram",
        "labels": [],
        "help": "inter-token interval between generated tokens (TPOT)",
    },
    KV_PAGES_USED: {
        "type": "gauge", "labels": [],
        "help": "pages currently allocated out of the paged KV cache",
    },
    KV_PAGE_OCCUPANCY: {
        "type": "gauge", "labels": [],
        "help": "allocated fraction of the usable KV page pool (0..1)",
    },
    KV_CACHE_BYTES: {
        "type": "gauge", "labels": ["dtype"],
        "help": "total HBM bytes of the paged KV cache (dtype-aware)",
    },
    PREFIX_CACHE_EVICTIONS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "zero-ref prefix-cache pages reclaimed under pressure",
    },
    SNAPSHOT_STORE_BYTES: {
        "type": "gauge", "labels": [],
        "help": "total payload bytes resident in the snapshot store",
    },
    SNAPSHOT_STORE_ENTRIES: {
        "type": "gauge", "labels": [],
        "help": "entries resident in the snapshot store",
    },
    SNAPSHOT_STORE_GETS_TOTAL: {
        "type": "counter", "labels": ["result"],
        "help": "snapshot-store lookups (result=hit|miss)",
    },
    SHEDS_TOTAL: {
        "type": "counter", "labels": ["class", "reason"],
        "help": "requests shed by admission control "
                "(reason=queue_full|kv_pressure|too_large|injected)",
    },
    REQUESTS_ADMITTED_TOTAL: {
        "type": "counter", "labels": ["class"],
        "help": "requests accepted by admission control",
    },
    SCHED_QUEUE_DEPTH: {
        "type": "gauge", "labels": ["class"],
        "help": "requests queued per priority class",
    },
    SCHED_QUEUE_WAIT_SECONDS: {
        "type": "histogram", "labels": ["class"],
        "help": "per-class request submit-to-admission wait",
    },
    KV_PAGES_RESERVED: {
        "type": "gauge", "labels": [],
        "help": "KV pages reserved by queued (not-yet-claimed) admissions",
    },
    DEADLINE_MISSES_TOTAL: {
        "type": "counter", "labels": ["stage"],
        "help": "requests past their deadline "
                "(stage=queued|prefill|inflight|migrating)",
    },
    TICK_PHASE_SECONDS: {
        "type": "histogram", "labels": ["phase"],
        "help": "scheduler-tick host time per phase (phase=ctrl|policy|"
                "admit|prefill_resume|prefill_dispatch|decode_dispatch|"
                "harvest|detokenize|accept, plus total); emitted only "
                "under MTPU_PROFILE",
    },
    HOST_OVERHEAD_RATIO: {
        "type": "gauge", "labels": [],
        "help": "host share of busy-tick time over the profiler ring "
                "(1 - device-blocked/total)",
    },
    GENERATED_TOKENS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "tokens generated by the engine",
    },
    PROMPT_TOKENS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "prompt tokens prefilled by the engine",
    },
    DECODE_STEPS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "decode steps executed",
    },
    KV_PAGES_FREE: {
        "type": "gauge", "labels": [],
        "help": "free pages in the paged KV cache",
    },
    DECODE_IMPL: {
        "type": "gauge",
        "labels": ["attention", "scatter", "kv_dtype", "tp", "variant"],
        "help": (
            "resolved decode implementation plan (info metric, value 1); "
            "tp = tensor-parallel degree, variant = the PER-SHARD ragged "
            "kernel formulation actually run"
        ),
    },
    PREFIX_CACHE_HITS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "prefix-cache admission hits",
    },
    PREFIX_CACHE_MISSES_TOTAL: {
        "type": "counter", "labels": [],
        "help": "prefix-cache admission misses",
    },
    PREFIX_CACHED_PAGES: {
        "type": "gauge", "labels": [],
        "help": "pages currently held by the prefix cache",
    },
    MFU: {
        "type": "gauge", "labels": ["phase"],
        "help": "model FLOPs utilization vs the resolved generation's bf16 "
                "peak (phase=prefill|decode|total)",
    },
    HBM_BW_UTIL: {
        "type": "gauge", "labels": ["phase"],
        "help": "HBM bandwidth utilization (MBU): analytic bytes streamed "
                "over device-seconds x peak GB/s (phase=prefill|decode|total)",
    },
    ACHIEVED_TFLOPS: {
        "type": "gauge", "labels": ["phase"],
        "help": "achieved TFLOP/s over the phase's accounted device time",
    },
    USAGE_PROMPT_TOKENS_TOTAL: {
        "type": "counter", "labels": ["tenant", "class"],
        "help": "prompt tokens prefilled per tenant/class (conserved: "
                "sums to the engine's prefill counter)",
    },
    USAGE_GENERATED_TOKENS_TOTAL: {
        "type": "counter", "labels": ["tenant", "class"],
        "help": "generated tokens accepted per tenant/class (conserved: "
                "sums to the engine's decode counter)",
    },
    USAGE_DEVICE_SECONDS_TOTAL: {
        "type": "counter", "labels": ["tenant", "class"],
        "help": "decode-slot occupancy seconds per tenant/class "
                "(install -> release on the engine clock)",
    },
    USAGE_KV_PAGE_SECONDS_TOTAL: {
        "type": "counter", "labels": ["tenant", "class"],
        "help": "KV page-seconds held per tenant/class (pages x seconds)",
    },
    USAGE_SHEDS_TOTAL: {
        "type": "counter", "labels": ["tenant", "class"],
        "help": "admission sheds charged to the rejected tenant/class",
    },
    CANARY_TOKENS_TOTAL: {
        "type": "counter", "labels": ["replica", "kind"],
        "help": "synthetic canary tokens, excluded from tenant billing "
                "(kind=prompt|generated; closes usage conservation)",
    },
    MULTISTEP_DECODE_STEPS: {
        "type": "gauge", "labels": [],
        "help": "configured decode steps fused per dispatch "
                "(decode_steps / MTPU_DECODE_STEPS; 1=classic block path)",
    },
    MULTISTEP_TOKENS_PER_DISPATCH: {
        "type": "gauge", "labels": [],
        "help": "accepted tokens per decode dispatch over the last gauge "
                "window (the macro-step amortization headline)",
    },
    MULTISTEP_DISPATCHES_TOTAL: {
        "type": "counter", "labels": [],
        "help": "decode dispatches harvested (one blocking device read "
                "each)",
    },
    MULTISTEP_TOKENS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "tokens accepted from harvested decode dispatches",
    },
    MULTISTEP_EARLY_EXIT_STEPS_TOTAL: {
        "type": "counter", "labels": [],
        "help": "whole macro-steps skipped by on-device early-exit "
                "(all lanes dead; masked_scan hold branch)",
    },
    MULTISTEP_DETOK_QUEUE_DEPTH: {
        "type": "gauge", "labels": [],
        "help": "events pending on the detokenization worker queue",
    },
    SPEC_PROPOSED_TOTAL: {
        "type": "counter", "labels": [],
        "help": "draft tokens proposed (speculative mode)",
    },
    SPEC_ACCEPTED_TOTAL: {
        "type": "counter", "labels": [],
        "help": "draft tokens accepted by the target",
    },
    SPEC_GAMMA: {
        "type": "gauge", "labels": [],
        "help": "dispatched per-slot speculation depth, p50 over the last "
                "gauge window (adaptive controller output; 0=classic lane)",
    },
    SPEC_TOKENS_PER_DISPATCH: {
        "type": "gauge", "labels": [],
        "help": "harvested tokens per speculative round over the last "
                "gauge window",
    },
    SPEC_ACCEPTANCE_RATE: {
        "type": "gauge", "labels": [],
        "help": "lifetime draft-token acceptance rate (accepted/proposed)",
    },
    SPEC_FALLBACK_TOTAL: {
        "type": "counter", "labels": [],
        "help": "whole rounds where no slot speculated and the engine fell "
                "through to the classic block program",
    },
}

#: every declared metric name
ALL_METRIC_NAMES = frozenset(CATALOG)


# -- request-trace span schema (observability/reqtrace.py) -----------------
#
# The metric-catalog discipline applied to the request tracer: one table
# owns every span NAME the engine and the server mint and the ATTRIBUTE
# KEYS each span may carry.

SPAN_CATALOG: dict[str, dict] = {
    "request": {
        "attrs": ["request_id", "priority", "tenant", "replica",
                  "finish_reason", "n_generated", "ttft_s"],
        "help": "root: one serving request end to end (trace id == request "
                "id); finish_reason lands at close",
    },
    "queue": {
        "attrs": ["priority", "tenant", "replica", "wait_s"],
        "help": "admission queue residency on one replica (opened at "
                "submit, closed when the scheduler pops the entry)",
    },
    "prefill": {
        "attrs": ["replica", "n_prompt", "bucket", "chunked", "chunks",
                  "budget", "sliced"],
        "help": "prompt KV fill on the owning replica (slot or chunked); "
                "sliced=True when the per-tick budget spread the chunks "
                "over several scheduler ticks",
    },
    "prefill_wait": {
        "attrs": ["replica", "ticks", "chunks"],
        "help": "a sliced (budgeted) chunked prefill's multi-tick "
                "residency: admission to last chunk, spanning the decode "
                "ticks interleaved between its chunks",
    },
    "decode": {
        "attrs": ["replica", "spec_mode"],
        "help": "first token to finish on the decoding replica",
    },
    "shed": {
        "attrs": ["replica", "reason"],
        "help": "admission rejected the request (the 429 path; event)",
    },
    "spec_verify": {
        "attrs": ["replica", "proposed", "accepted", "gamma"],
        "help": "one speculative round's outcome for this request (event; "
                "gamma = the depth the controller dispatched)",
    },
    "fault": {
        "attrs": ["replica", "point"],
        "help": "an injected fault (faults/inject.py POINTS) fired on this "
                "request's path (event)",
    },
    "retry_wait": {
        "attrs": ["replica", "round", "pending", "delay_s"],
        "help": "jittered backoff before a transfer chunk-retry round "
                "(event)",
    },
    "watchdog": {
        "attrs": ["replica", "state", "action"],
        "help": "the gray-failure watchdog intervened on this request's "
                "replica (serving/health.py ladder: state=wedged, "
                "action=stop_revive|quarantine) — shows between the hang "
                "and the failover seam on the stitched timeline (event)",
    },
    "failover": {
        "attrs": ["replica", "source", "target", "mode", "position",
                  "tokens_replayed", "result"],
        "help": "an in-flight request's takeover by another replica "
                "(mode=reactive re-prefill | migrate live KV move); "
                "extends the SAME trace id past the failed replica's root "
                "close, so `tpurun explain` shows death and resumption on "
                "one timeline",
    },
    "adopt": {
        "attrs": ["replica", "pages"],
        "help": "migrated block scattered into the decode replica's cache "
                "(on its scheduler thread)",
    },
    "chunk": {
        "attrs": ["replica", "seq", "nbytes", "round"],
        "help": "one wire chunk send (child of transfer)",
    },
    "transfer": {
        "attrs": ["replica", "chunks", "rounds", "wire_bytes"],
        "help": "chunked wire transfer of a serialized page block",
    },
    "migrate": {
        "attrs": ["replica", "source", "target", "pages", "wire_bytes",
                  "result"],
        "help": "one disagg page migration end to end "
                "(result=ok|fallback|aborted)",
    },
    "placement": {
        "attrs": ["replica", "route", "prefill_replica", "decode_replica"],
        "help": "router placement decision (route() or disagg plan())",
    },
    "tier_promote": {
        "attrs": ["replica", "tier", "pages"],
        "help": "prefix pages promoted from a lower cache tier during the "
                "claim (event)",
    },
}

#: every declared request-span name
ALL_SPAN_NAMES = frozenset(SPAN_CATALOG)

#: span names the executor call tracer mints (core/executor.py + the
#: container worker): a separate namespace from the request spans above
#: (trace id ``in-…`` vs ``req-…``), listed so renderers and exporters can
#: tell the two trace kinds apart
CALL_SPAN_NAMES = frozenset(
    {"call", "queue", "boot", "dispatch", "execute", "serialize", "retry"}
)

#: buckets for batch-size-style histograms (counts, not seconds)
COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

#: buckets for token-level latency (TTFT/TPOT): finer sub-ms resolution at
#: the low end than the boot-scale default buckets, topping out at 30 s
TOKEN_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

#: buckets for mtpu_tick_phase_seconds: most scheduler-tick phases are
#: tens of MICROseconds (ctrl/policy/harvest bookkeeping) while dispatch
#: phases reach tens of milliseconds — TOKEN_TIME_BUCKETS' 0.5 ms floor
#: would collapse every cheap phase into its first bucket
TICK_PHASE_BUCKETS = (
    0.000005, 0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0,
)
