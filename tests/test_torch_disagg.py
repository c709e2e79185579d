"""Disaggregated prefill/decode in the port (``serving/disagg``, the engine's
claim paths) against the JAX package, over the same tiny f32 weights:

- the port's prefill replica and decode replicas behind a
  ``DisaggCoordinator`` give the JAX unified engine's token ids and finish
  reasons, bf16 and int8 pages, greedy and seeded;
- across the frameworks: a block prefilled by the JAX engine, shipped as
  MTKV1 bytes, is adopted by the port's decode engine and decodes to the JAX
  unified tokens;
- the fault points ``disagg.reserve_shed``, ``disagg.replica_death`` and
  ``disagg.adopt_corrupt`` end as in the JAX package (a 429, or the unified
  fallback with the same tokens), and every page comes back on every engine;
- ``prefill_sync`` refuses a started engine, ``engine.out_of_pages`` fails it
  without leaking a page, ``tiered_prefix=True`` spills into a default host
  tier;
- ``OpenAIServer(router=coordinator)`` serves the same tokens over HTTP;
  the gateway's ``/disagg`` route reads the migrations.

Token ids are compared, never text (random tiny weights may decode to no
printable text). Each test stops every engine it starts; no thread outlives
the module.
"""

import dataclasses
import json
import threading
import urllib.request

import numpy as np
import pytest

import jax

import modal_examples_tpu.serving.disagg.transport as jtr
from modal_examples_tpu.faults import inject as jinject
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.scheduling.admission import ShedError as JShedError
from modal_examples_tpu.scheduling.router import EngineReplica as JReplica
from modal_examples_tpu.serving.disagg import DisaggCoordinator as JCoordinator
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams
from modal_examples_tpu_torch.faults import inject as tinject
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.scheduling.admission import ShedError
from modal_examples_tpu_torch.scheduling.policy import ScheduledRequest
from modal_examples_tpu_torch.scheduling.router import EngineReplica
from modal_examples_tpu_torch.serving.disagg import DisaggCoordinator, deserialize_block
from modal_examples_tpu_torch.serving.kv_cache import OutOfPages
from test_torch_time_limit import share_cores, thread_guard, time_limits

share_cores()

_limit_module, _limit_test = time_limits(test_s=120, module_s=180)
_threads = thread_guard()

ENGINE_KW = dict(max_slots=3, max_model_len=96, page_size=8, prefill_buckets=(16, 32), decode_block=4, seed=0)
#: prompt lengths 12, 41 (chunked past the 32 bucket), 20, 9
PROMPTS = ["hello there", "a" * 40, "the quick brown fox", "short q"]
SAMPLING = {"greedy": dict(max_tokens=7, temperature=0.0), "seeded": dict(max_tokens=7, temperature=0.8, seed=11)}


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _params(cls, sampling: str, i: int):
    kw = dict(SAMPLING[sampling])
    if "seed" in kw:
        kw["seed"] += i
    return cls(**kw)


@pytest.fixture(scope="module")
def unified(weights):
    """The JAX unified engine's (tokens, finish) per (kv, sampling), each
    request served alone (as a prefill replica prefills it)."""
    jcfg, _, jparams, _ = weights
    out = {}
    for kv in ("bfloat16", "int8"):
        eng = JaxEngine(jcfg, jparams, kv_dtype=kv, **ENGINE_KW)
        try:
            for sampling in SAMPLING:
                rows = []
                for i, p in enumerate(PROMPTS):
                    r = eng.submit(p, _params(JaxParams, sampling, i))
                    "".join(eng.stream(r))
                    rows.append((list(r.generated_tokens), r.finish_reason))
                out[kv, sampling] = rows
        finally:
            eng.stop()
    return out


def _fleet(tcfg, tparams, kv, *, n_decode=2, **kw):
    engines = [LLMEngine(tcfg, tparams, device="cpu", kv_dtype=kv, **ENGINE_KW, **kw) for _ in range(1 + n_decode)]
    reps = [EngineReplica(engines[0], "p0", role="prefill")]
    reps += [EngineReplica(e, f"d{i}", role="decode") for i, e in enumerate(engines[1:])]
    return DisaggCoordinator(reps, chunk_bytes=4096), engines


def _pages_back(eng) -> bool:
    pc = eng.prefix_cache
    held = [n for n in pc._by_page.values() if n.refcount]
    return eng.cache.allocator.available + pc.cached_pages == eng.cache.n_pages - 1 and not held


def _stop(engines):
    for e in engines:
        e.stop()


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_prefill_then_decode_equals_the_jax_unified_engine(weights, unified, kv, sampling):
    _, tcfg, _, tparams = weights
    co, engines = _fleet(tcfg, tparams, kv)
    try:
        reqs = [co.submit(p, _params(SamplingParams, sampling, i)) for i, p in enumerate(PROMPTS)]
        for r in reqs:
            "".join(co.stream(r))
        got = [(list(r.generated_tokens), r.finish_reason) for r in reqs]
        stats = co.stats()["migrations"]
    finally:
        _stop(engines)
    assert got == unified[kv, sampling]
    assert (stats["ok"], stats["fallback"], stats["aborted"], stats["inflight"]) == (len(PROMPTS), 0, 0, 0)
    # only prompt pages ship: pages_for(n_prompt) each
    assert stats["pages"] == sum(-(-len(engines[0].tokenizer.encode(p)) // 8) for p in PROMPTS)
    assert all(r._router_replica.role == "decode" for r in reqs)
    assert engines[0]._thread is None  # the prefill replica's loop never ran
    assert all(_pages_back(e) for e in engines)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_a_jax_prefilled_block_decodes_on_the_port(weights, unified, kv):
    """The JAX engine prefills (``prefill_sync``), extracts and serializes;
    the port deserializes the bytes and its decode engine adopts them."""
    jcfg, tcfg, jparams, tparams = weights
    jeng = JaxEngine(jcfg, jparams, kv_dtype=kv, **ENGINE_KW)
    teng = LLMEngine(tcfg, tparams, device="cpu", kv_dtype=kv, **ENGINE_KW)
    got = []
    try:
        for i, p in enumerate(PROMPTS):
            jreq = jeng.make_request(p, _params(JaxParams, "seeded", i))
            state = jeng.prefill_sync(jreq)
            wire = jtr.serialize_block(jeng.extract_request_pages(jreq, state))
            jeng.release_claim(state["claim"], valid=True)
            req = teng.make_request(p, _params(SamplingParams, "seeded", i))
            assert req.prompt_tokens == jreq.prompt_tokens
            entry = ScheduledRequest(payload=req, priority=req.priority, tenant=req.tenant,
                                     cost=teng.request_cost(req), enqueued_at=teng._clock())
            occ = teng.cache.occupancy()
            teng.admission.admit(entry, depths=teng.policy.depths(), pages_used=occ["pages_used"],
                                 pages_total=occ["pages_total"])
            teng.submit_adopted(req, entry, deserialize_block(wire))
            "".join(teng.stream(req))
            got.append((list(req.generated_tokens), req.finish_reason))
    finally:
        jeng.stop()
        teng.stop()
    assert got == unified[kv, "seeded"]
    assert _pages_back(teng)


FAULTS = {
    "disagg.reserve_shed": {"on_hit": 1},
    "disagg.replica_death": {"on_hit": 2},
    "disagg.adopt_corrupt": {"on_hit": 1},
}


def _faulted_run(co, engines, point, submit, stream, shed_error, inject) -> tuple:
    plan = inject.FaultPlan({point: FAULTS[point]}, seed=0)
    with inject.active(plan):
        try:
            req = submit(co)
        except shed_error as e:
            outcome = ("shed", e.reason)
            req = None
    rows = None
    if req is not None:
        "".join(stream(co, req))
        outcome = ("served", req.finish_reason)
        rows = list(req.generated_tokens)
    stats = {k: v for k, v in co.stats()["migrations"].items() if k not in ("bytes",)}
    return outcome, rows, stats, plan.fired()


@pytest.mark.parametrize("point", list(FAULTS))
def test_fault_points_end_as_in_the_jax_package(weights, unified, point):
    jcfg, tcfg, jparams, tparams = weights
    prompt, params = PROMPTS[1], dict(SAMPLING["greedy"])
    jengines = [JaxEngine(jcfg, jparams, **ENGINE_KW) for _ in range(2)]
    jco = JCoordinator([JReplica(jengines[0], "p0", role="prefill"), JReplica(jengines[1], "d0", role="decode")],
                       chunk_bytes=4096)
    co, engines = _fleet(tcfg, tparams, "bfloat16", n_decode=1)
    try:
        jax_run = _faulted_run(jco, jengines, point, lambda c: c.submit(prompt, JaxParams(**params)),
                               lambda c, r: c.stream(r), JShedError, jinject)
        port_run = _faulted_run(co, engines, point, lambda c: c.submit(prompt, SamplingParams(**params)),
                                lambda c, r: c.stream(r), ShedError, tinject)
    finally:
        _stop(jengines)
        _stop(engines)
    assert port_run == jax_run
    outcome, rows, stats, fired = port_run
    assert fired == {point: 1}
    if point == "disagg.reserve_shed":
        assert outcome == ("shed", "injected") and stats["ok"] == stats["fallback"] == 0
    else:
        # the unified fallback: the decode replica prefilled it again
        assert outcome[0] == "served" and stats["fallback"] == 1 and rows == unified["bfloat16", "greedy"][1][0]
    assert all(_pages_back(e) for e in engines)


def test_prefill_sync_refuses_a_started_engine_and_fails_without_leaking(weights):
    _, tcfg, _, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    try:
        free = eng.cache.allocator.available
        plan = tinject.FaultPlan({"engine.out_of_pages": {"on_hit": 1}})
        with tinject.active(plan), pytest.raises(OutOfPages):
            eng.prefill_sync(eng.make_request(PROMPTS[0]))
        assert eng.cache.allocator.available == free and eng._prefill_sync_pending == 0
        eng.start()
        with pytest.raises(RuntimeError, match="stopped engine"):
            eng.prefill_sync(eng.make_request(PROMPTS[0]))
    finally:
        eng.stop()
    # tiered_prefix=True: the trie's evictions spill into a host tier of
    # the default budget (MTPU_TIER_HOST_BYTES unset: 64 MiB), no volume
    eng = LLMEngine(tcfg, tparams, device="cpu", tiered_prefix=True, **ENGINE_KW)
    try:
        assert eng.prefix_cache.spill == eng.tiered.spill_pages
        st = eng.tiered.stats()
        assert st["host"] == {"blocks": 0, "bytes": 0, "budget_bytes": 64 * 1024 * 1024}
        assert st["volume"]["enabled"] is False
        req = eng.submit(PROMPTS[1], SamplingParams(max_tokens=2, temperature=0.0))  # 41 tokens: 5 full pages
        "".join(eng.stream(req))
        eng.stop()  # the finished claim's pages are back in the trie at zero refs
        eng.prefix_cache.evict(10_000)
        assert eng.tiered.stats()["host"]["blocks"] == eng.tiered.spilled == 5
    finally:
        eng.stop()


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_the_openai_server_fronts_a_coordinator(weights, unified):
    _, tcfg, _, tparams = weights
    with pytest.raises(ValueError, match="exactly one"):
        OpenAIServer()
    co, engines = _fleet(tcfg, tparams, "bfloat16")
    placed = []
    real = co.submit
    co.submit = lambda *a, **kw: placed.append(real(*a, **kw)) or placed[-1]
    srv = OpenAIServer(router=co, port=0)
    assert srv.engine is engines[1]  # the first replica that serves requests
    srv.start()
    try:
        base = f"http://{srv.host}:{srv.port}"
        out = _post(base + "/v1/completions", {"prompt": PROMPTS[2], **SAMPLING["greedy"]})
        assert out["choices"][0]["finish_reason"] == unified["bfloat16", "greedy"][2][1]
        assert [(list(r.generated_tokens), r.finish_reason) for r in placed] == [unified["bfloat16", "greedy"][2]]
        assert engines[0]._thread is None  # the server started the decode replicas only
        from modal_examples_tpu_torch.web.gateway import _disagg_snapshot

        snap = _disagg_snapshot()
        assert {"p0": "prefill", "d0": "decode", "d1": "decode"}.items() <= snap["replicas"].items()
        assert snap["migrations"]["by_result"].get("ok", 0) >= 1
    finally:
        srv.stop()
        _stop(engines)


def test_no_thread_of_a_stopped_fleet_survives(weights):
    """The coordinator starts none; the engines' loops end at stop()."""
    _, tcfg, _, tparams = weights
    before = set(threading.enumerate())
    co, engines = _fleet(tcfg, tparams, "bfloat16")
    for e in co.serving_engines():
        e.start()
    r = co.submit(PROMPTS[0], SamplingParams(max_tokens=3, temperature=0.0))
    "".join(co.stream(r))
    _stop(engines)
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]
