"""In-flight failover in the port (``serving/failover.py`` and the engine's
``submit_resumed``, ``migrate_out``, ``submit_adopted``), over tiny f32
weights shared with the JAX package:

- a request resumed from a decode checkpoint after its first, a middle and
  its last token, a live migration mid-decode, and a reactive resume after
  an injected scheduler crash all give the uninterrupted run's tokens, which
  are the JAX engine's, bf16 and int8 pages, greedy and seeded; the streamed
  text equals the uninterrupted text: no duplicated character;
- ``drain_replica`` moves a queued and a running request off a replica;
- a draft-mode speculating engine holds γ at 0 for an adopted or a replayed
  tenancy (``spec_hold``); a prompt-lookup one rebuilds its n-gram index
  from the shipped history;
- the checkpoints equal the JAX package's for the same request and block.
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

import jax

import modal_examples_tpu.serving.failover as jfo
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.faults import inject
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.scheduling.policy import ScheduledRequest
from modal_examples_tpu_torch.scheduling.router import EngineReplica, PrefixAffinityRouter
from modal_examples_tpu_torch.serving import failover as fo
from modal_examples_tpu_torch.serving.disagg import deserialize_block, serialize_block
from test_torch_time_limit import share_cores, thread_guard, time_limits

share_cores()

_limit_module, _limit_test = time_limits(test_s=120, module_s=180)
_threads = thread_guard()

ENGINE_KW = dict(max_slots=2, max_model_len=128, page_size=8, prefill_buckets=(16, 32), decode_block=4, seed=0)
PROMPT = "the quick brown fox jumps over the lazy dog and naps in the sun"  # 65 tokens: chunked
SAMPLING = {"greedy": dict(max_tokens=40, temperature=0.0), "seeded": dict(max_tokens=40, temperature=0.9, seed=7)}
CASES = [(kv, s) for kv in ("bfloat16", "int8") for s in SAMPLING]


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def uninterrupted(weights):
    """Per (kv, sampling): the port's uninterrupted (tokens, finish, text),
    held to the JAX engine's tokens and finish."""
    jcfg, tcfg, jparams, tparams = weights
    out = {}
    for kv, sampling in CASES:
        jeng = JaxEngine(jcfg, jparams, kv_dtype=kv, **ENGINE_KW)
        teng = LLMEngine(tcfg, tparams, device="cpu", kv_dtype=kv, **ENGINE_KW)
        try:
            jr = jeng.submit(PROMPT, JaxParams(**SAMPLING[sampling]))
            "".join(jeng.stream(jr))
            tr = teng.submit(PROMPT, SamplingParams(**SAMPLING[sampling]))
            text = "".join(teng.stream(tr))
        finally:
            jeng.stop()
            teng.stop()
        assert (tr.generated_tokens, tr.finish_reason) == (jr.generated_tokens, jr.finish_reason)
        out[kv, sampling] = (list(tr.generated_tokens), tr.finish_reason, text, list(tr.prompt_tokens))
    return out


def _engine(weights, kv="bfloat16", **kw):
    _, tcfg, _, tparams = weights
    return LLMEngine(tcfg, tparams, device="cpu", kv_dtype=kv, **{**ENGINE_KW, **kw})


def _wait_tokens(req, n: int, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while len(req.generated_tokens) < n:
        assert time.monotonic() < deadline, "no tokens"
        time.sleep(0.002)


def _pages_back(eng) -> bool:
    pc = eng.prefix_cache
    return eng.cache.allocator.available + pc.cached_pages == eng.cache.n_pages - 1 and not [
        n for n in pc._by_page.values() if n.refcount]


@pytest.mark.parametrize("kv,sampling", CASES)
def test_resume_from_a_checkpoint_is_token_identical(weights, uninterrupted, kv, sampling):
    toks, finish, text, prompt_tokens = uninterrupted[kv, sampling]
    eng = _engine(weights, kv)
    try:
        for k in (1, len(toks) // 2, len(toks) - 1):
            req = eng.make_request(PROMPT, SamplingParams(**SAMPLING[sampling]))
            eng.submit_resumed(req, prompt_tokens=prompt_tokens, generated=toks[:k], emitted_len=0)
            out = "".join(eng.stream(req))
            assert (req.generated_tokens, req.finish_reason) == (toks, finish), k
            assert out == text  # emitted_len 0: the whole text again, byte for byte
        # the emission cursor: a resume at E emits exactly text[E:]
        req = eng.make_request(PROMPT, SamplingParams(**SAMPLING[sampling]))
        cut = len(eng.tokenizer.decode(toks[:10]))
        eng.submit_resumed(req, prompt_tokens=prompt_tokens, generated=toks[:10], emitted_len=cut)
        assert "".join(eng.stream(req)) == text[cut:]
        # the failure landed on the last token: finished without a slot
        req = eng.make_request(PROMPT, SamplingParams(**SAMPLING[sampling]))
        eng.submit_resumed(req, prompt_tokens=prompt_tokens, generated=toks, emitted_len=len(text))
        assert "".join(eng.stream(req)) == "" and req.finish_reason == "length"
    finally:
        eng.stop()
    assert _pages_back(eng)


@pytest.mark.parametrize("kv,sampling", CASES)
def test_live_migration_is_token_identical(weights, uninterrupted, kv, sampling):
    toks, finish, text, _ = uninterrupted[kv, sampling]
    a, b = _engine(weights, kv), _engine(weights, kv)
    ra, rb = EngineReplica(a, "mig-a"), EngineReplica(b, "mig-b")
    b.start()
    # each tick stalls 50 ms (latency only): the request is still decoding
    # when its migration is served
    slow = inject.FaultPlan({"engine.slow_decode": {"p": 1.0}})
    try:
        with inject.active(slow):
            req = ra.submit(PROMPT, SamplingParams(**SAMPLING[sampling]))
            pieces = []
            reader = threading.Thread(target=lambda: pieces.extend(a.stream(req)))
            reader.start()
            _wait_tokens(req, 5)
            result = fo.migrate_request(ra, rb, req, chunk_bytes=512)
        reader.join(timeout=60)
    finally:
        a.stop()
        b.stop()
    assert result == "ok" and req._router_replica is rb
    assert (req.generated_tokens, req.finish_reason) == (toks, finish)
    assert "".join(pieces) == text
    assert _pages_back(a) and _pages_back(b)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_reactive_failover_streams_without_a_duplicated_character(weights, uninterrupted, kv):
    toks, finish, text, _ = uninterrupted[kv, "seeded"]
    a, b = _engine(weights, kv), _engine(weights, kv)
    ra, rb = EngineReplica(a, "re-a"), EngineReplica(b, "re-b")
    router = PrefixAffinityRouter([ra, rb], reprobe_s=0.2)
    slow = inject.FaultPlan({"engine.slow_decode": {"p": 1.0}})
    try:
        with inject.active(slow):
            req = ra.submit(PROMPT, SamplingParams(**SAMPLING["seeded"]))
            req._router_replica = ra
            pieces = []
            reader = threading.Thread(target=lambda: pieces.extend(router.stream(req)))
            reader.start()
            _wait_tokens(req, 4)
        # only A's loop runs: the crash lands on the request's owner
        crash = inject.FaultPlan({"engine.scheduler_crash": {"on_hit": 1}})
        with inject.active(crash):
            deadline = time.monotonic() + 30
            while not crash.fired() and time.monotonic() < deadline:
                time.sleep(0.002)
        reader.join(timeout=60)
    finally:
        a.stop()
        b.stop()
    assert crash.fired() == {"engine.scheduler_crash": 1} and req._router_replica is rb
    assert (req.generated_tokens, req.finish_reason) == (toks, finish)
    assert "".join(pieces) == text  # no duplicated (and no missing) character
    assert _pages_back(a) and _pages_back(b)


def test_drain_replica_moves_queued_and_running_requests(weights, uninterrupted):
    toks, finish, _, _ = uninterrupted["bfloat16", "greedy"]
    a, b = _engine(weights, max_slots=1), _engine(weights)
    ra, rb = EngineReplica(a, "dr-a"), EngineReplica(b, "dr-b")
    router = PrefixAffinityRouter([ra, rb])
    b.start()
    slow = inject.FaultPlan({"engine.slow_decode": {"p": 1.0}})
    try:
        with inject.active(slow):
            running = ra.submit(PROMPT, SamplingParams(**SAMPLING["greedy"]))
            queued = ra.submit(PROMPT, SamplingParams(**SAMPLING["greedy"]))
            readers = [threading.Thread(target=lambda r=r: "".join(a.stream(r))) for r in (running, queued)]
            for t in readers:
                t.start()
            _wait_tokens(running, 3)
            router.remove_replica("dr-a")
            counts = fo.drain_replica(ra, router, chunk_bytes=1024)
        for t in readers:
            t.join(timeout=60)
    finally:
        a.stop()
        b.stop()
    assert counts["migrated"] == 1 and counts["resumed"] == 1 and counts["failed"] == 0
    assert counts["tokens_migrated"] >= 3
    for r in (running, queued):
        assert (r.generated_tokens, r.finish_reason) == (toks, finish)
    assert _pages_back(a) and _pages_back(b)


def _installed(eng, req, ticks: int = 50):
    """Step ``eng`` by hand until ``req`` holds a slot and is decodable."""
    for _ in range(ticks):
        eng.step()
        for s in eng.slots:
            if s.request is req and s.decodable:
                return s
    raise AssertionError("the request never took a slot")


def _adopt(eng, block, prompt=PROMPT, params=None):
    req = eng.make_request(prompt, params or SamplingParams(max_tokens=40, temperature=0.0))
    entry = ScheduledRequest(payload=req, priority=req.priority, tenant=req.tenant, cost=eng.request_cost(req),
                             enqueued_at=eng._clock())
    occ = eng.cache.occupancy()
    eng.admission.admit(entry, depths=eng.policy.depths(), pages_used=occ["pages_used"],
                        pages_total=occ["pages_total"])
    eng.submit_adopted(req, entry, block)
    return req


@pytest.mark.parametrize("mode", ["draft", "ngram"])
def test_a_speculating_tenancy_that_was_adopted_or_replayed(weights, uninterrupted, mode):
    """Draft mode: an adopted or replayed tenancy has a hole in the draft's
    cache, so it holds γ at 0 (``spec_hold``) while a local one does not;
    prompt lookup rebuilds the index from the prompt and the history."""
    _, tcfg, _, tparams = weights
    toks, _, _, prompt_tokens = uninterrupted["bfloat16", "greedy"]
    spec = dict(speculative=(tcfg, 2), draft_params=tparams) if mode == "draft" else dict(speculative=("ngram", 2))
    src = _engine(weights)
    eng = _engine(weights, **spec)
    try:
        state = src.prefill_sync(src.make_request(PROMPT))
        mid_req = src.make_request(PROMPT)
        block = src.extract_request_pages(mid_req, state)
        src.release_claim(state["claim"])
        # a mid-decode block: the decode-state leg of a live migration
        moved = dataclasses.replace(block, meta={**block.meta, "position": len(prompt_tokens) + 5,
                                                 "first_token": toks[5],
                                                 "resume": {"generated": toks[:6], "emitted_len": 0}})
        adopted = _adopt(eng, deserialize_block(serialize_block(moved)))
        slot = _installed(eng, adopted)
        local = eng.submit(PROMPT, SamplingParams(max_tokens=40, temperature=0.0))
        local_slot = _installed(eng, local)
        if mode == "draft":
            assert slot.spec_hold and not local_slot.spec_hold
            assert eng._slot_gamma(slot, 0.5, False) == 0 and eng._slot_gamma(local_slot, 0.5, False) > 0
        else:
            assert not slot.spec_hold
            assert slot.ngram.hist[: len(prompt_tokens) + 6] == prompt_tokens + toks[:6]
        eng.abort(adopted)
        eng.abort(local)
        for _ in range(5):
            eng.step()
        resumed = eng.make_request(PROMPT, SamplingParams(max_tokens=40, temperature=0.0))
        eng.submit_resumed(resumed, prompt_tokens=prompt_tokens, generated=toks[:8])
        rslot = _installed(eng, resumed)
        assert rslot.spec_hold == (mode == "draft")
        # the replayed history feeds on: the tokens after it are the uninterrupted run's
        gen = resumed.generated_tokens
        assert len(gen) >= 8 and gen == toks[: len(gen)] and rslot.position == len(prompt_tokens) + len(gen) - 1
        eng.abort(resumed)
        for _ in range(5):
            eng.step()
    finally:
        src.stop()
        eng.stop()
    assert _pages_back(eng)


def test_checkpoints_as_the_jax_package():
    params = types.SimpleNamespace(max_tokens=9)
    req = types.SimpleNamespace(request_id="req-abc", prompt="p", prompt_tokens=[5, 6, 7, 8], generated_tokens=[1, 2],
                                params=params, auto_seed=3, priority="default", tenant="t", deadline=None,
                                emitted_len=4, _orig_prompt_tokens=[5, 6])
    block = types.SimpleNamespace(meta={"request_id": "req-abc", "prompt_tokens": [5, 6], "auto_seed": 3,
                                        "resume": {"generated": [1, 2, 3], "emitted_len": 2}})
    for make in ("checkpoint_request", "checkpoint_from_block"):
        args = (req,) if make == "checkpoint_request" else (block, req)
        j, t = getattr(jfo, make)(*args), getattr(fo, make)(*args)
        assert {k: getattr(t, k) for k in t.__slots__} == {k: getattr(j, k) for k in j.__slots__}
        assert (t.position, t.tokens_replayed) == (j.position, j.tokens_replayed)
