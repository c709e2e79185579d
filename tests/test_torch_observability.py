"""The port's instruments against the JAX engine's, on one burst.

Both engines serve the same burst (the tiny llama, f32 compute, bf16 pages;
tenants, classes, a chunked prompt, a deadline, a shed) stepped by hand with
fake clocks, each into its own package's registry (cleared first) and its
own trace store under ``tmp_path``. Counts must be equal, never timings: the
token and step counters, TTFT/TPOT observations, the batch-size histogram,
the engine-phase and queue-wait observation counts, the queue, page and
prefix gauges, the shed, admission and deadline counters; the span names,
parents and prefill attributes of every request's trace; the usage meter's
per-tenant tokens and its FLOPs and bytes per phase. The port dispatches no
decode step past every slot's budget, which the JAX engine runs and, at
N = 1, counts: there the decode steps plus the steps saved against the
nominal block agree; and its meter streams the weights once per decode step,
the JAX meter once per token. Then the profiler (its
phases partition each tick; off, the engine holds no profiler and the tick
helpers are one branch), the peaks (the card's, by name; none for a device
the table does not know, never a TPU's), and ``/metrics`` (the same
hand-built lines as the JAX server's, no name twice).
"""

import ast
import dataclasses
import re
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax

import modal_examples_tpu.scheduling.admission as jadm
import modal_examples_tpu_torch.scheduling.admission as tadm
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.observability.trace import TraceStore as JaxTraceStore
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.openai_api import OpenAIServer as JaxServer
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu.utils.prometheus import default_registry as jax_registry
from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.observability import catalog as C
from modal_examples_tpu_torch.observability import usage as tusage
from modal_examples_tpu_torch.observability.trace import TraceStore
from modal_examples_tpu_torch.scheduling.admission import ShedError
from modal_examples_tpu_torch.utils.prometheus import default_registry as port_registry
from test_torch_time_limit import share_cores

share_cores()

ROOT = Path(__file__).resolve().parent.parent
ENGINE_KW = dict(max_slots=3, max_model_len=96, page_size=8, prefill_buckets=(16, 32), decode_block=4, seed=0,
                 kv_dtype="bfloat16")
BURST = [  # (prompt, params, scheduling)
    ("hello there", dict(max_tokens=5, temperature=0.0), dict(tenant="alice")),
    ("a" * 40, dict(max_tokens=9, temperature=0.8, seed=11), dict(tenant="bob")),  # chunked
    ("the quick brown fox", dict(max_tokens=3, temperature=0.0), dict(tenant="alice", priority="interactive")),
    ("zz", dict(max_tokens=12, temperature=0.9), dict(tenant="bob", priority="batch")),
    ("hello there again", dict(max_tokens=6, temperature=0.0), dict(tenant="alice")),
    ("late", dict(max_tokens=4, deadline_s=0.05), dict(tenant="carol", priority="batch")),  # expires queued
]
#: counters and non-timing series compared value for value
EXACT = ("mtpu_prompt_tokens_total", "mtpu_generated_tokens_total", "mtpu_decode_steps_total",
         "mtpu_engine_batch_size", "mtpu_sched_queue_depth", "mtpu_kv_pages_used", "mtpu_kv_pages_free",
         "mtpu_kv_page_occupancy", "mtpu_prefix_cached_pages", "mtpu_kv_pages_reserved", "mtpu_sheds_total",
         "mtpu_requests_admitted_total", "mtpu_deadline_misses_total", "mtpu_multistep_dispatches_total",
         "mtpu_multistep_tokens_total", "mtpu_multistep_early_exit_steps_total", "mtpu_active_slots",
         "mtpu_waiting_requests", "mtpu_prefill_sliced_total", "mtpu_usage_tokens_total",
         "mtpu_prefill_backlog_tokens", "mtpu_decode_steps_configured")
#: timing histograms: only their observation counts are compared
COUNTED = ("mtpu_ttft_seconds", "mtpu_tpot_seconds", "mtpu_engine_phase_seconds", "mtpu_sched_queue_wait_seconds",
           "mtpu_engine_queue_wait_seconds", "mtpu_decode_stall_seconds")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _finish_of(req):
    """The request's finish reason, its stream drained."""
    while req.finish_reason is None:
        item = req.out_queue.get(timeout=30)
        if hasattr(item, "reason"):
            req.finish_reason = item.reason
    return req.finish_reason


def _clear(reg) -> None:
    """Empty a registry: the burst's series alone, in both packages."""
    with reg._lock:
        reg._counters.clear()
        reg._gauges.clear()
        reg._histograms.clear()


def _series(reg) -> dict:
    """{(name, labels): value} over the exposition: EXACT series whole,
    COUNTED histograms by their ``_count`` lines only."""
    out = {}
    for line in reg.expose().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        key, value = line.rsplit(" ", 1)
        name = key.split("{", 1)[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if base in EXACT or (base in COUNTED and name.endswith("_count")):
            out[key] = float(value)
    return out


def _spans(store, request_id) -> list:
    """(name, parent's name, prefill attributes) of each span of a trace."""
    spans = store.read(request_id)
    by_id = {s["span_id"]: s["name"] for s in spans}
    keep = ("n_prompt", "bucket", "chunked", "chunks", "sliced", "budget", "finish_reason", "n_generated")
    return sorted(
        (s["name"], by_id.get(s.get("parent_id")), tuple(sorted((k, v) for k, v in s["attrs"].items() if k in keep)))
        for s in spans
    )


def _burst(weights, tmp_path, **kw):
    """The burst through both engines; returns their observations."""
    jcfg, tcfg, jparams, tparams = weights
    out = {}
    for name in ("jax", "port"):
        clock = FakeClock()
        kwargs = {**ENGINE_KW, "clock": clock, **kw}
        if name == "jax":
            reg, store = jax_registry, JaxTraceStore(tmp_path / "jax")
            adm = jadm.AdmissionController(jadm.AdmissionConfig(max_queue={c: 6 for c in ("interactive", "default",
                                                                                            "batch", "canary")}),
                                           clock=clock)
            eng, P = JaxEngine(jcfg, jparams, trace_store=store, admission=adm, **kwargs), JaxParams
            shed_error = jadm.ShedError
        else:
            reg, store = port_registry, TraceStore(tmp_path / "port")
            adm = tadm.AdmissionController(tadm.AdmissionConfig(max_queue={c: 6 for c in ("interactive", "default",
                                                                                            "batch", "canary")}),
                                           clock=clock)
            eng, P = LLMEngine(tcfg, tparams, device="cpu", trace_store=store, admission=adm, **kwargs), SamplingParams
            shed_error = ShedError
        _clear(reg)
        try:
            reqs = [eng.submit(p, P(**params), **sched) for p, params, sched in BURST]
            for i in range(5):  # the batch queue's bound is 6: the fifth bulk request is shed
                try:
                    reqs.append(eng.submit(f"bulk {i}", P(max_tokens=2, temperature=0.0), priority="batch",
                                           tenant="dave"))
                except shed_error:
                    pass
            for t in range(50):
                clock.t = 0.1 * t
                eng.step()
            eng._metrics_wall = 0.0  # force the throttled refresh of every gauge
            eng._refresh_gauges()
        finally:
            eng.stop()
        usage = eng.usage.summary()["phases"]
        out[name] = {
            "series": _series(reg),
            "spans": [_spans(store, r.request_id) for r in reqs],
            "tenants": eng.usage.tenants(),
            "work": {p: (usage[p]["flops"], usage[p]["bytes"]) for p in ("prefill", "decode", "total")},
            "stats": (eng.stats.prompt_tokens, eng.stats.generated_tokens, eng.stats.steps),
            "weight_bytes": eng.usage.model.weight_bytes,
            "reasons": [_finish_of(r) for r in reqs],
        }
    return out["jax"], out["port"]


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_burst_counts_match_the_jax_engine(weights, tmp_path, decode_steps):
    jax_obs, port_obs = _burst(weights, tmp_path, decode_steps=decode_steps)
    assert port_obs["reasons"] == jax_obs["reasons"]
    assert "deadline" in port_obs["reasons"]
    js, ps = dict(jax_obs["series"]), dict(port_obs["series"])
    if decode_steps == 1:
        # steps and steps saved against the nominal block, added up
        for series in (js, ps):
            series["mtpu_decode_steps_total"] += series.pop("mtpu_multistep_early_exit_steps_total", 0.0)
        assert port_obs["stats"][:2] == jax_obs["stats"][:2]
        assert port_obs["stats"][2] < jax_obs["stats"][2]  # the burst's tails ran short blocks
    else:
        assert port_obs["stats"] == jax_obs["stats"]
    assert ps == js, {k: (ps.get(k), js.get(k)) for k in set(ps) | set(js) if ps.get(k) != js.get(k)}
    ps = port_obs["series"]
    # the burst reached every counted series
    names = {k.split("{", 1)[0] for k in ps}
    for want in ("mtpu_ttft_seconds_count", "mtpu_tpot_seconds_count", "mtpu_engine_batch_size_count",
                 "mtpu_sheds_total", "mtpu_deadline_misses_total", "mtpu_decode_steps_total"):
        assert want in names, want
    prompt, generated, steps = port_obs["stats"]
    assert ps["mtpu_prompt_tokens_total"] == prompt and ps["mtpu_generated_tokens_total"] == generated
    assert ps["mtpu_decode_steps_total"] == steps


def test_spans_and_usage_match_the_jax_engine(weights, tmp_path):
    jax_obs, port_obs = _burst(weights, tmp_path)
    assert port_obs["spans"] == jax_obs["spans"]
    names = {name for spans in port_obs["spans"] for name, _, _ in spans}
    assert {"request", "queue", "prefill", "decode"} <= names
    assert port_obs["tenants"] == jax_obs["tenants"]
    t = port_obs["tenants"]["totals"]
    assert t["prompt_tokens"] == port_obs["stats"][0] and t["generated_tokens"] == port_obs["stats"][1]
    assert t["sheds"] == 1
    # decode bytes: the port's meter streams the weights once per decode step
    # that ran, the JAX meter once per token
    _, generated, steps = port_obs["stats"]
    fewer = (generated - steps) * port_obs["weight_bytes"]
    want = {p: (flops, nbytes - (0 if p == "prefill" else fewer)) for p, (flops, nbytes) in jax_obs["work"].items()}
    assert port_obs["work"] == want and port_obs["work"]["total"][0] > 0


def _profiled_burst(weights, profile):
    _, tcfg, _, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", profile=profile, **ENGINE_KW)
    try:
        reqs = [eng.submit(p, SamplingParams(**params)) for p, params, _ in BURST[:5]]
        for _ in range(30):
            eng.step()
        assert all(not s.request for s in eng.slots) and all(r.n_generated for r in reqs)
    finally:
        eng.stop()
    return eng


def test_profiler_phases_partition_the_tick(weights):
    eng = _profiled_burst(weights, True)
    ring = eng.profiler.perfetto_snapshot()["ticks"]
    assert ring
    for entry in ring:
        assert set(entry["phases"]) <= set(C.TICK_PHASES)
        attributed = sum(entry["phases"].values())
        # the marks partition the tick: only the moment between the last
        # mark and the tick's end is left out
        assert attributed <= entry["total"] + 1e-9 and attributed >= 0.95 * entry["total"]
        assert 0.0 <= entry["device"] <= attributed
    phases = {p for e in ring for p in e["phases"]}
    assert {"admit", "prefill_dispatch", "decode_dispatch", "harvest", "accept", "detokenize"} <= phases
    summary = eng.profiler.overhead_summary()
    assert 0.95 <= summary["attribution_cover"] <= 1.0 and summary["dispatches"] > 0


def test_disabled_profiler_is_none_and_the_helpers_are_one_branch(weights, monkeypatch):
    monkeypatch.delenv("MTPU_PROFILE", raising=False)
    assert _profiled_burst(weights, None).profiler is None
    assert _profiled_burst(weights, False).profiler is None
    tree = ast.parse((ROOT / "modal_examples_tpu_torch" / "serving" / "engine.py").read_text())
    for name in ("_tm", "_tm_device"):
        fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)
        body = [n for n in fn.body if not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
        assert len(body) == 1 and isinstance(body[0], ast.If) and not body[0].orelse
        test = body[0].test
        assert isinstance(test, ast.Compare) and test.left.id == "tick" and isinstance(test.ops[0], ast.IsNot)


def test_peaks_are_the_cards_and_an_unknown_device_reports_no_share():
    from modal_examples_tpu.core.resources import TPU_GENERATIONS, TPU_HBM_GBPS

    h100 = tusage.resolve_peaks("NVIDIA H100 80GB HBM3")
    assert (h100["tflops_per_chip"], h100["hbm_gbps_per_chip"]) == (989.0, 3350.0)
    tpu_figures = {g[2] for g in TPU_GENERATIONS.values()} | set(TPU_HBM_GBPS.values())
    for name in ("cpu", "NVIDIA A100-SXM4-80GB", "v5e", "TPU v5 lite"):
        p = tusage.resolve_peaks(name)
        assert p["tflops_per_chip"] is None and p["hbm_gbps_per_chip"] is None, name
    for tflops, gbps in tusage.GPU_PEAKS.values():
        assert tflops not in tpu_figures and gbps not in tpu_figures
    model = tusage.WorkModel(n_params=1000, n_layers=2, dim=8, weight_bytes=2000, kv_bytes_per_token=4.0)

    class Req:
        tenant, priority, request_id, n_generated = "t", "default", "req-x", 1

    ticks = iter(range(100))
    blind = tusage.EngineUsage(model, clock=lambda: float(next(ticks)), device="cpu")
    blind.note_prompt(Req(), 10)
    blind.note_phase_seconds("prefill", 2.0)
    assert all(p["mfu"] is None and p["mbu"] is None for p in blind.summary()["phases"].values())
    known = tusage.EngineUsage(model, peaks={"device": "test", "tflops_per_chip": 1e-9, "hbm_gbps_per_chip": 1e-6})
    known.note_prompt(Req(), 10)
    known.note_phase_seconds("prefill", 2.0)
    p = known.summary()["phases"]["prefill"]
    assert p["mfu"] == round(model.prefill_flops(10, 100) / (2.0 * 1e3), 6)
    assert p["mbu"] == round(model.prefill_bytes(10, 1) / (2.0 * 1e3), 6)


def _get(url) -> str:
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def _hand_built(text) -> list:
    """The lines ahead of the registry's exposition."""
    lines = []
    for line in text.splitlines():
        if line.startswith("#"):
            break
        if line.strip():
            lines.append(line)
    return lines


def test_metrics_has_the_reference_lines_and_no_name_twice(weights):
    jcfg, tcfg, jparams, tparams = weights
    pages = {}
    for name in ("jax", "port"):
        reg = jax_registry if name == "jax" else port_registry
        _clear(reg)
        if name == "jax":
            eng, P = JaxEngine(jcfg, jparams, **ENGINE_KW), JaxParams
        else:
            eng, P = LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW), SamplingParams
        for p, params, sched in BURST[:5]:
            eng.submit(p, P(**params), **sched)
        for _ in range(30):  # served by hand; the server's loop then runs idle ticks only
            eng.step()
        assert not eng._inflight
        eng._metrics_wall = 0.0  # flush the counters now
        eng._refresh_gauges()
        srv = (JaxServer(eng, host="127.0.0.1", port=0) if name == "jax" else OpenAIServer(eng, port=0)).start()
        try:
            text = _get(f"http://127.0.0.1:{srv.port}/metrics")
        finally:
            srv.stop()
        pages[name] = (text, eng.stats, reg.total(C.MULTISTEP_EARLY_EXIT_STEPS_TOTAL))
    (jtext, jstats, jsaved), (ptext, pstats, psaved) = pages["jax"], pages["port"]
    assert sorted(_hand_built(ptext)) == sorted(_hand_built(jtext))
    assert any(line.startswith(C.PREFIX_CACHE_HITS_TOTAL) for line in _hand_built(ptext))
    names = [line.split("{")[0].split(" ")[0] for line in _hand_built(ptext)]
    names += re.findall(r"^# TYPE (\S+)", ptext, re.M)
    assert len(names) == len(set(names)), "a metric name appears twice"
    for series, value in ((C.GENERATED_TOKENS_TOTAL, pstats.generated_tokens),
                          (C.PROMPT_TOKENS_TOTAL, pstats.prompt_tokens), (C.DECODE_STEPS_TOTAL, pstats.steps)):
        got = re.search(rf"^{series} (\S+)$", ptext, re.M)
        assert got and float(got.group(1)) == value, series
    # steps and steps saved against the nominal block, added up: the port
    # dispatches no step past every slot's budget, the JAX engine runs them
    assert (pstats.prompt_tokens, pstats.generated_tokens, pstats.steps + psaved) == (
        jstats.prompt_tokens, jstats.generated_tokens, jstats.steps + jsaved)
