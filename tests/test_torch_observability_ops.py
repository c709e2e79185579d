"""The port's operations layer (``observability/{timeseries,slo,alerts,
incident,export,canary}.py``, the merged trace reads, the compile ledger,
the gateway's ``/healthz``, ``/alerts``, ``/incidents`` and ``/canary`` and
the twelve observability subcommands of the CLI) held against the JAX
package's on the same inputs and the same state directory.

Every test has its own ``MTPU_STATE_DIR`` under ``tmp_path``. Modules are
compared value for value (SLO reports, alert snapshots and journals, tsdb
windows, points and rates, incident manifests, pushed expositions); the CLI
by its standard output, the JAX CLI's and the port's on one state directory
that the port wrote (a served burst's traces and usage journal, pushed
metrics, a tsdb, alert transitions, an incident bundle, canary rounds, a
kernel build ledger, autoscaler decisions). The canary runs on the tiny
engine (f32 compute, bf16 pages, on the CPU): it records a golden, passes a
second round bit-exact, reports drift where the JAX canary does under the
``engine.canary_token_corrupt`` fault, and refuses a golden of another
numeric identity.
"""

import contextlib
import dataclasses
import io
import json
import shutil
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax

from modal_examples_tpu.core import cli as jcli
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.observability import alerts as jalerts
from modal_examples_tpu.observability import canary as jcanary
from modal_examples_tpu.observability import export as jexport
from modal_examples_tpu.observability import incident as jincident
from modal_examples_tpu.observability import reqtrace as jrt
from modal_examples_tpu.observability import slo as jslo
from modal_examples_tpu.observability import timeseries as jts
from modal_examples_tpu.utils import prometheus as jprom
from modal_examples_tpu_torch import LLMEngine
from modal_examples_tpu_torch.core import cli as pcli
from modal_examples_tpu_torch.faults import inject as pinject
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.observability import alerts as palerts
from modal_examples_tpu_torch.observability import canary as pcanary
from modal_examples_tpu_torch.observability import catalog as C
from modal_examples_tpu_torch.observability import export as pexport
from modal_examples_tpu_torch.observability import incident as pincident
from modal_examples_tpu_torch.observability import reqtrace as prt
from modal_examples_tpu_torch.observability import slo as pslo
from modal_examples_tpu_torch.observability import timeseries as pts
from modal_examples_tpu_torch.observability.journal import named_journal
from modal_examples_tpu_torch.observability.trace import Span, TraceStore
from modal_examples_tpu_torch.ops import _build
from modal_examples_tpu_torch.serving.sampling import SamplingParams
from modal_examples_tpu_torch.utils import prometheus as pprom
from test_torch_time_limit import share_cores, time_limits

share_cores()

#: the CLI tests spawn one child per package; the engine tests run a few
#: seconds on the CPU
_limit_module, _limit_test = time_limits(test_s=120, module_s=180)

ENGINE_KW = dict(max_slots=2, max_model_len=64, page_size=8, prefill_buckets=(16, 32), decode_block=4, seed=0)
PROG = "python -m modal_examples_tpu_torch"


@pytest.fixture()
def state(tmp_path, monkeypatch):
    """This test's own state directory, for both packages."""
    root = tmp_path / "state"
    root.mkdir()
    monkeypatch.setenv("MTPU_STATE_DIR", str(root))
    return root


def _fill(reg, pkg_catalog) -> None:
    """The same observations into a registry of either package."""
    help_of = lambda name: pkg_catalog.CATALOG[name]["help"]  # noqa: E731
    for v in (0.05, 0.2, 0.4, 1.5, 3.0):
        reg.histogram_observe(C.TTFT_SECONDS, v, help=help_of(C.TTFT_SECONDS))
    for v in (0.01, 0.02, 0.3):
        reg.histogram_observe(C.TPOT_SECONDS, v, help=help_of(C.TPOT_SECONDS))
    reg.counter_inc(C.REQUESTS_ADMITTED_TOTAL, 20.0, help=help_of(C.REQUESTS_ADMITTED_TOTAL))
    reg.counter_inc(C.DEADLINE_MISSES_TOTAL, 3.0, help=help_of(C.DEADLINE_MISSES_TOTAL))
    reg.counter_inc(C.SCHEDULER_ERRORS_TOTAL, 1.0, help=help_of(C.SCHEDULER_ERRORS_TOTAL))
    reg.counter_inc(C.DECODE_STEPS_TOTAL, 50.0, help=help_of(C.DECODE_STEPS_TOTAL))
    reg.gauge_set(C.ACTIVE_SLOTS, 2.0, help=help_of(C.ACTIVE_SLOTS))
    reg.gauge_set(C.KV_PAGE_OCCUPANCY, 0.99, help=help_of(C.KV_PAGE_OCCUPANCY))


def _registries():
    from modal_examples_tpu.observability import catalog as JC

    j, p = jprom.Registry(), pprom.Registry()
    _fill(j, JC)
    _fill(p, C)
    return j, p


def _rules(pkg_alerts) -> list[dict]:
    return [dataclasses.asdict(r) for r in pkg_alerts.DEFAULT_RULES]


def _drop_at(recs: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "at"} for r in recs]


# -- slo, alerts, tsdb, export -------------------------------------------------------


def test_the_rules_and_slos_are_the_reference_set():
    assert _rules(palerts) == _rules(jalerts)
    assert [dataclasses.asdict(s) for s in pslo.DEFAULT_SLOS] == [dataclasses.asdict(s) for s in jslo.DEFAULT_SLOS]


@pytest.mark.parametrize("override", [{}, {"MTPU_SLO_TTFT_P95_S": "5.0", "MTPU_SLO_ERROR_RATE": "0.5"}],
                         ids=["default", "env-targets"])
def test_slo_evaluate_and_healthz_match_the_reference(state, monkeypatch, override):
    for k, v in override.items():
        monkeypatch.setenv(k, v)
    j, p = _registries()
    assert pslo.evaluate(p) == jslo.evaluate(j)
    assert p.expose() == j.expose()  # the burn-rate gauges written back
    assert pslo.healthz(p) == jslo.healthz(j)
    empty = pslo.healthz(pprom.Registry())
    assert empty == jslo.healthz(jprom.Registry()) and empty["status"] == "ok"


def _window(n=40, t0=1000.0):
    """A hand-built tsdb window: the token counter moves, then stops while
    slots stay active; the page pool fills; stalls burn; a canary drift
    lands."""
    recs = []
    for i in range(n):
        toks = float(min(i, n // 2) * 10)
        series = [
            [C.GENERATED_TOKENS_TOTAL, {}, "counter", toks, 0.0],
            [C.ACTIVE_SLOTS, {}, "gauge", 2.0, 0.0],
            [C.KV_PAGE_OCCUPANCY, {}, "gauge", 0.5 if i < 10 else 0.99, 0.0],
            [C.DECODE_STALL_SECONDS, {}, "histogram", float(i), 0.9 * i],
            [C.CANARY_DRIFT_TOTAL, {"replica": "engine"}, "counter", 0.0 if i < 30 else 1.0, 0.0],
        ]
        recs.append({"at": t0 + i, "series": series})
    return recs


class _Source:
    def __init__(self, recs):
        self.recs = recs

    def recent(self, window_s=None):
        return self.recs


def test_alert_evaluator_and_offline_evaluation_match_the_reference(state, tmp_path):
    recs = _window()
    out = {}
    for name, mod, prom in (("jax", jalerts, jprom), ("port", palerts, pprom)):
        reg = prom.Registry()
        shown = []
        ev = mod.AlertEvaluator(source=None, registry=reg, journal_path=tmp_path / f"{name}-alerts.jsonl",
                                clock=lambda: 0.0)
        for k in range(5, len(recs) + 1, 5):
            ev._source = _Source(recs[:k])
            shown.append(ev.evaluate_once(now=recs[k - 1]["at"]))
        out[name] = (shown, ev.snapshot(), ev.active(), _drop_at(ev._journal.tail(100)), reg.expose(),
                     mod.evaluate_offline(recs))
    assert out["port"] == out["jax"]
    shown, snap, active, journal, _, offline = out["port"]
    assert {"kv_pressure", "decode_stall_burn", "canary_drift"} <= set(active)
    assert {r["rule"] for r in journal} == set(active) and journal


def test_tsdb_written_by_the_port_reads_as_the_reference(state):
    reg = pprom.Registry()
    clock = {"t": 0.0}
    sampler = pts.TsdbSampler(registry=reg, interval=1.0, clock=lambda: clock["t"], evaluate_alerts=False,
                              segment_records=4)
    for i in range(10):
        reg.counter_inc(C.GENERATED_TOKENS_TOTAL, 7.0 * (i + 1), help="tokens")
        reg.gauge_set(C.ACTIVE_SLOTS, float(i % 3), help="slots")
        reg.histogram_observe(C.TTFT_SECONDS, 0.1 * (i + 1), help="ttft")
        sampler.sample_once()
        clock["t"] += 1.0
        time.sleep(0.002)  # distinct wall stamps
    pw, jw = pts.read_window(), jts.read_window()
    assert pw == jw and len(pw) >= 8
    assert pts.read_latest() == jts.read_latest()
    for name, field in ((C.GENERATED_TOKENS_TOTAL, "value"), (C.ACTIVE_SLOTS, "value"), (C.TTFT_SECONDS, "sum")):
        pp, jp = pts.series_points(name, pw, field=field), jts.series_points(name, jw, field=field)
        assert pp == jp and pp
        assert pts.rate(pp) == jts.rate(jp)
    assert pts.series_names(pw) == jts.series_names(jw)
    # the sampler's own series, as the reference's sampler emits them
    assert reg.value(C.TSDB_SAMPLES_TOTAL) == 10 and reg.value(C.TSDB_ROTATIONS_TOTAL) >= 2


def test_pushed_expositions_merge_as_the_reference(state):
    j, p = _registries()
    pexport.push_metrics_file("port-job", registry=p)
    jexport.push_metrics_file("jax-job", registry=j)
    assert sorted(pexport.pushed_jobs()) == sorted(jexport.pushed_jobs()) == ["jax-job", "port-job"]
    assert pexport.read_pushed_metrics() == jexport.read_pushed_metrics()
    merged = pprom.parse_exposition(pexport.read_pushed_metrics())
    assert merged.total(C.REQUESTS_ADMITTED_TOTAL) == 40.0  # both jobs summed
    live = pexport.live_and_pushed_metrics(job="live", registry=pprom.Registry())
    assert live == jexport.live_and_pushed_metrics(job="live", registry=jprom.Registry())


def test_exposition_merge_and_parse_match_the_reference():
    """The port's copy of the exposition tools: the merged text of the same
    jobs, and a parsed registry's reads, equal the reference's."""
    out = []
    for prom in (jprom, pprom):
        r1, r2 = prom.Registry(), prom.Registry()
        r1.counter_inc(C.RETRIES_TOTAL, 2, labels={"reason": "timeout"}, help="retries")
        r1.histogram_observe(C.QUEUE_WAIT_SECONDS, 0.1)
        r1.gauge_set(C.ACTIVE_SLOTS, 5.0)
        r2.counter_inc(C.RETRIES_TOTAL, 5, labels={"reason": "a\\nb"})
        for v in (0.004, 0.2, 2.0, 700.0):
            r2.histogram_observe(C.QUEUE_WAIT_SECONDS, v, labels={"function": "f"})
        merged = prom.merge_expositions({"job-a": r1.expose(), "job-b": r2.expose()})
        parsed = prom.parse_exposition(merged)
        out.append((merged, parsed.expose(), parsed.total(C.RETRIES_TOTAL), parsed.peak(C.ACTIVE_SLOTS),
                    parsed.histogram_quantiles(C.QUEUE_WAIT_SECONDS, aggregate={}), parsed.all_series()))
    assert out[1] == out[0]
    assert out[1][0].count(f"# TYPE {C.RETRIES_TOTAL} counter") == 1 and out[1][2] == 7.0


def test_merged_trace_reads_and_the_ambient_frame_match_the_reference(tmp_path):
    """One request's spans split over two stores (as two replicas would
    write them) read back as one tree by ``read_trace``, ``resolve`` and
    ``list_traces`` over both; a fault fired on a thread scoped to the
    request by ``active`` lands as its ``fault`` event; ``explain_lines``
    narrates the merged trace as the reference's does."""
    from modal_examples_tpu.observability.trace import TraceStore as JaxTraceStore

    out = {}
    for name, rt, Store, inject in (("jax", jrt, JaxTraceStore, None), ("port", prt, TraceStore, pinject)):
        a, b = Store(tmp_path / name / "a"), Store(tmp_path / name / "b")
        ctx = rt.start_request_trace("req-0123456789ab", entry="engine", store=a, priority="default")
        rt.finish(ctx, rt.begin(ctx, "queue", replica="r0", priority="default"), store=a)
        other = rt.RequestTraceContext(ctx.trace_id, ctx.root, b, owns_root=False)
        rt.finish(other, rt.begin(other, "prefill", replica="r1", prompt_tokens=12), store=b)
        if inject is not None:  # the port's gate records fired faults into the ambient frame
            with rt.active(ctx, replica="r0"), inject.active(inject.FaultPlan(
                    {"engine.canary_token_corrupt": {"on_hit": 1}}, seed=0)):
                assert inject.fire("engine.canary_token_corrupt")
        else:
            with rt.active(ctx, replica="r0"):
                rt.note_fault("engine.canary_token_corrupt")
        with rt.active(None):
            rt.note_fault("engine.canary_token_corrupt")  # an unsampled frame records nothing
        rt.finish_root(ctx, "ok", store=a, finish_reason="length", n_generated=4)
        spans = rt.read_trace(ctx.trace_id, stores=[a, b])
        out[name] = (
            sorted((sp["name"], sp["status"], sp["attrs"].get("replica")) for sp in spans),
            rt.resolve("req-0123", stores=[a, b]), rt.list_traces(stores=[a, b]),
            rt.trace_kind(ctx.trace_id), rt.trace_kind("in-00"),
            len(rt.explain_lines(spans, ctx.trace_id)),
        )
    assert out["port"] == out["jax"]
    names = [n for n, _, _ in out["port"][0]]
    assert names == ["fault", "prefill", "queue", "request"] and out["port"][1] == "req-0123456789ab"


# -- incidents ---------------------------------------------------------------------------


def test_incident_capture_and_list_match_the_reference(state):
    bundle = pincident.capture("manual", reason="a test", replica="r0", force=True, extra={"k": 1})
    assert bundle is not None and bundle.parent == state / "incidents"
    listed = pincident.list_incidents()
    assert listed == jincident.list_incidents() and len(listed) == 1
    m = listed[0]
    assert (m["trigger"], m["reason"], m["replica"], m["extra"]) == ("manual", "a test", "r0", {"k": 1})
    assert set(m["files"]) == {"tsdb.jsonl", "traces.json", "engines.json", "profiler.json", "env.json"} | {
        f"journal_{n}.jsonl" for n in m["journals"]}
    for name in m["files"]:
        assert pincident.read_bundle_file(m["id"], name) == jincident.read_bundle_file(m["id"], name)
    assert pincident.read_manifest(m["id"][:12]) == jincident.read_manifest(m["id"][:12]) == m
    assert pincident.read_bundle_file(m["id"], "../../etc/passwd") is None
    with pytest.raises(ValueError):
        pincident.capture("no-such-trigger")
    # the per-(trigger, replica) debounce, as the reference's
    assert pincident.capture("manual", replica="r0") is None


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_a_scheduler_crash_in_the_port_engine_captures_a_bundle(state, weights, tmp_path):
    _, tcfg, _, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", trace_store=TraceStore(tmp_path / "traces"), **ENGINE_KW)
    eng.trace_name = "crashing"
    assert eng in pincident.live_engines()

    def boom():
        raise RuntimeError("scheduler logic fault")

    req = eng.submit("hello there", SamplingParams(max_tokens=40, temperature=0.0))
    eng.step()  # admitted and seated: the crash has a victim
    eng.step = boom
    try:
        list(eng.stream(req))
    finally:
        eng.stop()
    assert req.finish_reason == "error" and eng._stopped_on_error
    bundles = [m for m in pincident.list_incidents() if m["trigger"] == "scheduler_crash"]
    assert len(bundles) == 1, bundles
    m = bundles[0]
    assert m["replica"] == "crashing" and m["reason"] == "RuntimeError: scheduler logic fault"
    assert "crashing" in m["engines"]
    engines = json.loads(pincident.read_bundle_file(m["id"], "engines.json"))
    snap = next(e for e in engines if e["replica"] == "crashing")
    # the capture ran before the release sweep: the victim is still seated
    assert [s["request_id"] for s in snap["occupied_slots"]] == [req.request_id]
    assert snap["impl_plan"] == eng.impl_plan and snap["stopped_on_error"]
    assert jincident.list_incidents() == pincident.list_incidents()


# -- the canary --------------------------------------------------------------------------


def test_the_fingerprint_names_the_backend_card_and_decode_plan(weights):
    _, tcfg, _, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", kv_dtype="int8", paged_impl="pallas-writeback", **ENGINE_KW)
    fp = pcanary.fingerprint(eng)
    assert fp == {
        "backend": "cpu", "device": "cpu", "paged_impl": "pallas-writeback", "attention": "writeback",
        "ragged_variant": None, "scatter": "kernel",
        "kernels": ["flash_fwd", "kv_scatter_int8", "paged_decode_writeback_int8"], "kernel_impl": "plain",
        "weights": "float32", "kv_dtype": "int8", "tp": 1,
    }
    # a golden recorded on the CPU never gates a card run
    card = dict(fp, backend="cuda", device="NVIDIA H100 80GB HBM3", kernel_impl="cuda")
    assert pcanary.fingerprint_hash(card) != pcanary.fingerprint_hash(fp)
    with pytest.raises(pcanary.CanaryIdentityError, match="CANARY IDENTITY REFUSED"):
        pcanary.verify_identity(fp, card)
    assert pcanary.GOLDEN_SET == jcanary.GOLDEN_SET
    assert pcanary.model_id(tcfg) == jcanary.model_id(weights[0])


def test_the_golden_store_refuses_as_the_reference(tmp_path):
    fp = {"backend": "cpu", "device": "cpu", "kv_dtype": "bfloat16", "tp": 1}
    for mod in (pcanary, jcanary):
        store = mod.GoldenStore(root=tmp_path / mod.__name__)
        assert store.load("m", fp) is None
        path = store.record("m", fp, {"g0": {"tokens": [1, 2]}})
        assert mod.fingerprint_hash(fp) in path.name and store.load("m", fp)["probes"] == {"g0": {"tokens": [1, 2]}}
        foreign = dict(fp, backend="cuda")
        path.replace(store.path_for("m", foreign))  # a hand-copied golden
        with pytest.raises(mod.CanaryIdentityError) as e:
            store.load("m", foreign)
        assert "backend: golden='cpu' live='cuda'" in str(e.value)
        store.path_for("m", fp).write_text("{not json")
        with pytest.raises(mod.CanaryIdentityError):
            store.load("m", fp)


def test_canary_record_pass_drift_and_identity_on_the_tiny_engine(state, weights, tmp_path):
    """The port's prober over its engine, beside ``probe_engine`` on the JAX
    engine with the same weights and the same fault plan: the same verdicts
    per round, drift at the same probe and token."""
    from modal_examples_tpu.faults import inject as jinject
    from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine

    jcfg, tcfg, jparams, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", trace_store=TraceStore(tmp_path / "traces"), **ENGINE_KW)
    jeng = JaxEngine(jcfg, jparams, **ENGINE_KW)
    reg = pprom.Registry()
    prober = pcanary.CanaryProber(eng, interval_s=3600.0, registry=reg)
    try:
        rounds, jrounds = [], []
        for armed in (False, False, True):
            plan, jplan = ((pinject.FaultPlan({"engine.canary_token_corrupt": {"on_hit": 1}}, seed=0),
                            jinject.FaultPlan({"engine.canary_token_corrupt": {"on_hit": 1}}, seed=0))
                           if armed else (None, None))
            with (pinject.active(plan) if armed else contextlib.nullcontext()):
                rounds.append(prober.probe_once()["engine"])
            jgolden = None if not jrounds else {"probes": {r["probe"]: {"tokens": r["tokens"]} for r in jrounds[0]}}
            with (jinject.active(jplan) if armed else contextlib.nullcontext()):
                jrounds.append(jcanary.probe_engine(jeng, golden=jgolden, registry=jprom.Registry()))
        verdicts = [[r["result"] for r in rnd] for rnd in rounds]
        assert verdicts == [[r["result"] for r in rnd] for rnd in jrounds]
        assert verdicts == [["recorded"] * 3, ["pass"] * 3, ["drift", "pass", "pass"]]
        drift, jdrift = rounds[2][0], jrounds[2][0]
        assert (drift["probe"], drift["mismatch_at"]) == (jdrift["probe"], jdrift["mismatch_at"]) == ("g0", 0)
        assert drift["tokens"][0] == (drift["expected"][0] + 1) % tcfg.vocab_size
        assert rounds[1][0]["tokens"] == rounds[0][0]["tokens"]  # bit-exact against the golden
        # the golden is stored under this engine's identity
        model, fp = pcanary.model_id(tcfg), pcanary.fingerprint(eng)
        assert prober.store.path_for(model, fp).parent == state / "canary"
        # the drift: counted, the streak, an incident naming the probe request
        assert reg.value(C.CANARY_DRIFT_TOTAL, {"replica": "engine"}) == 1
        assert reg.value(C.CANARY_FAILING, {"replica": "engine"}) == 1
        assert reg.value(C.CANARY_PROBES_TOTAL, {"replica": "engine", "result": "pass"}) == 5
        bundles = [m for m in pincident.list_incidents() if m["trigger"] == "canary_drift"]
        assert len(bundles) == 1 and drift["request_id"] in bundles[0]["reason"]
        actions = [r["action"] for r in named_journal("canary").tail(20)]
        assert actions == ["recorded", "round", "round", "round"]
        snap = prober.snapshot()
        assert (snap["rounds"], snap["drifts"], snap["streaks"]) == (3, 1, {"engine": 1})
        # probes stay out of the SLO histograms and out of billing
        usage = eng.usage.tenants()
        assert usage["canary"]["generated_tokens"] > 0
        assert not any(row["tenant"] == pcanary.CANARY_TENANT for row in usage["tenants"])
        assert reg.total(C.CANARY_E2E_SECONDS) == 9
        # a golden of a foreign identity refuses instead of gating
        foreign = dict(fp, backend="cuda", device="NVIDIA H100 80GB HBM3")
        prober.store.path_for(model, fp).replace(prober.store.path_for(model, foreign))
        with pytest.raises(pcanary.CanaryIdentityError):
            prober.store.load(model, foreign)
        prober.store.record(model, foreign, {})
        prober.store.path_for(model, foreign).replace(prober.store.path_for(model, fp))
        assert prober.probe_once() == {}
        assert named_journal("canary").tail(1)[0]["action"] == "identity_refused"
    finally:
        eng.stop()
        jeng.stop()


def test_a_router_prober_waits_with_a9():
    """The router prober landed with ``scheduling/router.py`` (ROADMAP A9a):
    over a router it walks ``router.replicas`` (none here: a round probes
    nothing) instead of refusing."""

    class Router:
        replicas = []

    prober = pcanary.CanaryProber(Router(), interval_s=3600.0)
    assert prober.router is not None and prober.replica is None
    assert prober.probe_once() == {} and prober.rounds == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_router_prober_down_weights_a_drifting_replica(pkg, state, monkeypatch):
    """Rounds over a router's replica, fed to ``_note_round``: two drifting
    rounds down-weight it to 0.25 (``fail_threshold`` 2), a passing round
    restores 1.0, as the JAX prober does."""
    mod = jcanary if pkg == "jax" else pcanary
    calls = []

    class Replica:
        name, role = "r0", "unified"

        def healthy(self):
            return True

    class Router:
        replicas = [Replica()]

        def set_health_weight(self, name, w):
            calls.append((name, w))

    prober = mod.CanaryProber(Router(), interval_s=3600.0)
    drift = [{"probe": "g0", "result": "drift", "request_id": "req-x", "mismatch_at": 0}]
    passing = [{"probe": "g0", "result": "pass", "request_id": "req-y"}]
    mock_capture = []
    monkeypatch.setattr(
        (jincident if pkg == "jax" else pincident), "capture", lambda *a, **k: mock_capture.append(k))
    for results in (drift, drift, passing, passing):
        prober._note_round(Router.replicas[0], results)
    assert calls == [("r0", 0.25), ("r0", 1.0)]
    assert len(mock_capture) == 2


# -- the compile ledger -----------------------------------------------------------------


def test_kernel_builds_are_ledgered_and_read_as_the_reference(state, tmp_path, monkeypatch):
    """A stand-in ``nvcc`` (it writes its ``-o`` file) builds two kernels:
    each build is one begin/end pair in the ``compiles`` journal, a library
    already built is a hit, and the ledger reads as the reference's."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    reg = pprom.Registry()
    monkeypatch.setattr(pprom, "default_registry", reg)
    from modal_examples_tpu_torch.observability import metrics as pmetrics

    monkeypatch.setattr(pmetrics, "default_registry", reg, raising=False)
    _build.build(["kv_scatter", "flash_fwd"])
    _build.build(["kv_scatter"])
    from modal_examples_tpu.observability import profiler as jprof
    from modal_examples_tpu_torch.observability import profiler as pprof

    ledger = pprof.read_ledger()
    assert ledger == jprof.read_ledger()
    assert [(r["event"], r["program"]) for r in ledger] == [
        ("begin", "kv_scatter"), ("begin", "flash_fwd"), ("end", "kv_scatter"), ("end", "flash_fwd")]
    assert pprof.unfinished_builds(ledger) == jprof.unfinished_builds(ledger) == []
    assert pprof.unfinished_builds(ledger[:3]) == [ledger[1]]
    assert all(r["seconds"] >= 0 and r["cache"] == "miss" for r in ledger if r["event"] == "end")


# -- the gateway ----------------------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_the_four_routes_answer_as_the_reference(state, monkeypatch):
    import modal_examples_tpu as jm
    import modal_examples_tpu_torch as pm
    from modal_examples_tpu.web import gateway as jgw
    from modal_examples_tpu_torch.web import gateway as pgw

    bundle = pincident.capture("manual", reason="gateway", force=True)
    named_journal("alerts").record({"at": 1.0, "rule": "kv_pressure", "action": "fire", "value": 0.99})
    named_journal("canary").record({"at": 2.0, "action": "round", "replica": "engine", "streak": 0,
                                    "results": {"g0": "pass"}})
    # generous targets: the process registries carry earlier tests' series
    for var in ("MTPU_SLO_TTFT_P95_S", "MTPU_SLO_TPOT_P95_S", "MTPU_SLO_CALL_P95_S"):
        monkeypatch.setenv(var, "1000000")
    monkeypatch.setenv("MTPU_SLO_ERROR_RATE", "1.0")
    monkeypatch.setenv("MTPU_SLO_RETRY_RATE", "1.0")
    monkeypatch.setenv("MTPU_SLO_DEADLINE_MISS_RATE", "1.0")
    paths = ["/alerts?n=5", "/incidents", f"/incidents/{bundle.name}", f"/incidents/{bundle.name}?file=env.json",
             f"/incidents/{bundle.name}?file=../x", "/incidents/inc-nope"]
    answers = {}
    for name, pkg, gw in (("jax", jm, jgw), ("port", pm, pgw)):
        server = gw.Gateway(pkg.App(f"ops-{name}")).start()
        try:
            answers[name] = [_get(server.base_url + p) for p in paths]
            code, health = _get(server.base_url + "/healthz")
            assert code == 200 and health["status"] == "ok", health
            answers[name].append([(r["name"], r["target"]) for r in health["slos"]])
            code, canary = _get(server.base_url + "/canary")
            assert code == 200 and set(canary) == {"probes", "drift", "failing", "prober", "journal"}
            answers[name].append(canary["journal"])
            index = _get(server.base_url + "/")[1]
            assert set(index["routes"]) == {f"/{label}" for label in gw.BUILTIN_ROUTES}
        finally:
            server.stop()
    assert answers["port"] == answers["jax"]
    assert answers["port"][2][1]["trigger"] == "manual"
    assert [a[0] for a in answers["port"][:6]] == [200, 200, 200, 200, 404, 404]


# -- the CLI ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def populated(tmp_path_factory, weights):
    """A state directory the port wrote: a served burst (traces, the usage
    journal), an executor call trace, pushed metrics, a tsdb, alert
    transitions, an incident bundle, canary rounds, a kernel build ledger
    and autoscaler decisions."""
    root = tmp_path_factory.mktemp("ops-state")
    _, tcfg, _, tparams = weights
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MTPU_STATE_DIR", str(root))
        mp.setenv("MTPU_TRACE_SAMPLE", "1")
        reg = pprom.Registry()
        store = TraceStore(root / "traces")
        eng = LLMEngine(tcfg, tparams, device="cpu", trace_store=store, **ENGINE_KW)
        try:
            reqs = [eng.submit(p, SamplingParams(max_tokens=n, temperature=0.0), tenant=t)
                    for p, n, t in (("hello there", 5, "alice"), ("the quick brown fox", 7, "bob"))]
            for r in reqs:
                list(eng.stream(r))
            prober = pcanary.CanaryProber(eng, interval_s=3600.0, registry=reg)
            prober.probe_once()
            prober.probe_once()
            eng.usage.flush(registry=reg)  # before stop() flushes into the process registry
        finally:
            eng.stop()
        call = Span(trace_id="in-0123456789ab", name="call", attrs={"function": "app.fn"})
        for name in ("queue", "boot", "dispatch", "execute"):
            sp = Span(trace_id=call.trace_id, name=name, parent_id=call.span_id)
            sp.finish("ok")
            store.record(sp)
        call.finish("ok")
        store.record(call)
        for v in (0.05, 0.2, 0.4):
            reg.histogram_observe(C.TTFT_SECONDS, v, help="ttft")
        reg.counter_inc(C.GENERATED_TOKENS_TOTAL, 12.0, help="tokens")
        reg.gauge_set(C.ACTIVE_SLOTS, 2.0, help="slots")
        for t, n in (("alice", 5.0), ("bob", 7.0)):  # the usage table's series, as a meter pushes them
            labels = {"tenant": t, "class": "default"}
            reg.counter_inc(C.USAGE_GENERATED_TOKENS_TOTAL, n, labels=labels, help="usage")
            reg.counter_inc(C.USAGE_DEVICE_SECONDS_TOTAL, n / 100, labels=labels, help="usage")
        for phase in ("decode", "total"):
            reg.gauge_set(C.MFU, 0.0123, labels={"phase": phase}, help="mfu")
            reg.gauge_set(C.HBM_BW_UTIL, 0.456, labels={"phase": phase}, help="mbu")
        sampler = pts.TsdbSampler(registry=reg, interval=1.0, evaluate_alerts=False)
        for _ in range(3):
            sampler.sample_once()
            time.sleep(0.002)
        ev = palerts.AlertEvaluator(source=_Source(_window()), registry=reg, clock=lambda: 0.0)
        ev.evaluate_once(now=_window()[-1]["at"])
        pincident.capture("manual", reason="cli parity", force=True)
        named_journal("compiles").record({"at": 1.0, "event": "begin", "replica": "pid-1", "program": "flash_fwd",
                                          "shape_key": "abc"})
        named_journal("compiles").record({"at": 2.0, "event": "end", "replica": "pid-1", "program": "flash_fwd",
                                          "shape_key": "abc", "seconds": 6.5, "cache": "miss"})
        named_journal("scaler").record({"at": 3.0, "function": "app.fn", "action": "scale_up",
                                        "trigger": "queue_pressure", "queue_depth": 2, "inflight": 0,
                                        "containers_before": 0, "containers_after": 1})
        pexport.push_metrics_file("port-burst", registry=reg)
    return root, [r.request_id for r in reqs], call.trace_id


def _run_main(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = main(list(argv))
        except SystemExit as e:  # a refusal: its message is the output
            rc, buf = 2, io.StringIO(str(e.code))
    return rc, buf.getvalue()


CLI_CASES = {
    "trace-list": ["trace", "list"],
    "trace-request": ["trace", "@REQ"],
    "trace-call": ["trace", "@CALL"],
    "trace-perfetto": ["trace", "@REQ", "--perfetto"],
    "explain-request": ["explain", "@REQ", "--dir", "@TRACES"],
    "explain-call": ["explain", "@CALL", "--dir", "@TRACES"],
    "explain-missing": ["explain", "req-nope", "--dir", "@TRACES"],
    "metrics": ["metrics"],
    "metrics-json": ["metrics", "--json"],
    "profile": ["profile"],
    "profile-json": ["profile", "--json"],
    "usage": ["usage"],
    "usage-json": ["usage", "5", "--json"],
    "canary": ["canary"],
    "canary-json": ["canary", "--json"],
    "tsdb": ["tsdb"],
    "tsdb-series": ["tsdb", "--series", C.GENERATED_TOKENS_TOTAL],
    "tsdb-rate": ["tsdb", "--series", C.GENERATED_TOKENS_TOTAL, "--rate"],
    "alerts": ["alerts"],
    "incidents": ["incidents"],
    "incident-show": ["incident", "show", "@INC"],
    "scaler": ["scaler"],
    "top": ["top"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_each_subcommand_prints_what_the_reference_cli_prints(populated, tmp_path, monkeypatch, case):
    root, req_ids, call_id = populated
    state = tmp_path / "state"
    shutil.copytree(root, state)
    monkeypatch.setenv("MTPU_STATE_DIR", str(state))
    inc = pincident.list_incidents()[0]["id"]
    subst = {"@REQ": req_ids[0], "@CALL": call_id, "@TRACES": str(state / "traces"), "@INC": inc}
    argv = [subst.get(a, a) for a in CLI_CASES[case]]
    j_rc, j_out = _run_main(jcli.main, argv)
    p_rc, p_out = _run_main(pcli.main, argv)
    assert (p_rc, p_out.replace(PROG, "tpurun")) == (j_rc, j_out)
    assert p_out.strip()
    if case == "explain-missing":
        assert p_rc == 2 and "no trace" in p_out
    else:
        assert p_rc == 0


def test_every_observability_subcommand_is_served(populated):
    served = {"trace", "explain", "metrics", "profile", "usage", "canary", "tsdb", "alerts", "incidents",
              "incident", "scaler", "top"}
    assert served <= set(pcli.COMMANDS)
    assert not served & set(pcli.WAITING_COMMANDS)
    # A13's examples, docs and snapshot subcommands are served too
    assert {"examples", "docs", "snapshot"} <= set(pcli.COMMANDS)
    # the fleet layers' prefixstore, fleet and chaos are served; only A8 waits
    assert {"prefixstore", "fleet", "chaos"} <= set(pcli.COMMANDS)
    assert {v.split()[0] for v in pcli.WAITING_COMMANDS.values()} == {"A8"}


def test_the_cli_runs_as_a_module(populated, tmp_path):
    """``python -m`` of each package on the state directory: the entry point,
    not only ``main``."""
    import os
    import subprocess
    import sys

    root, _, _ = populated
    state = tmp_path / "state"
    shutil.copytree(root, state)
    env = {**os.environ, "MTPU_STATE_DIR": str(state), "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}
    outs = [subprocess.run([sys.executable, "-m", pkg, "incidents"], capture_output=True, text=True, timeout=60,
                           env=env) for pkg in ("modal_examples_tpu", "modal_examples_tpu_torch")]
    assert [o.returncode for o in outs] == [0, 0], [o.stderr[-2000:] for o in outs]
    assert outs[0].stdout == outs[1].stdout and "cli parity" in outs[1].stdout
