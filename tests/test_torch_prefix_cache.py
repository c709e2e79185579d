"""The port's prefix cache against the JAX package's.

The trie's unit cases of ``tests/test_prefix_cache.py::TestPrefixCacheUnit``
over both packages' ``PrefixCache`` and ``PageAllocator``; then the engines
over the same tiny f32 weights: a burst sharing a system prompt (tokens,
``cached_tokens``, free and cached pages), a chunked prompt over a cached
prefix, the same burst with the cache off (token-identical), and eviction
under page pressure, counted exactly against the JAX engine.
"""

import dataclasses
import types

import numpy as np
import pytest

import jax

import modal_examples_tpu.serving.kv_cache as jkv
import modal_examples_tpu.serving.prefix_cache as jpc
import modal_examples_tpu_torch.serving.kv_cache as tkv
import modal_examples_tpu_torch.serving.prefix_cache as tpc
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from test_torch_time_limit import share_cores

share_cores()

PACKAGES = {"jax": types.SimpleNamespace(kv=jkv, pc=jpc), "torch": types.SimpleNamespace(kv=tkv, pc=tpc)}


@pytest.fixture(params=sorted(PACKAGES))
def mk(request):
    pkg = PACKAGES[request.param]

    def make(n_pages=32, page_size=4):
        alloc = pkg.kv.PageAllocator(n_pages)
        return pkg.pc.PrefixCache(alloc, page_size), alloc

    return make


class TestPrefixCacheUnit:
    def test_acquire_miss_insert_then_hit(self, mk):
        pc, alloc = mk()
        tokens = list(range(10))
        assert pc.acquire(tokens) == ([], 0)
        pages = alloc.alloc(3)
        assert pc.insert(tokens, pages[:2], 0) == (pages[:2], [])
        assert pc.acquire(tokens) == (pages[:2], 8)
        assert pc.acquire(list(range(4)) + [99, 98, 97, 96]) == (pages[:1], 4)

    def test_concurrent_insert_displaces_duplicate(self, mk):
        pc, alloc = mk()
        tokens = list(range(8))
        a_pages, b_pages = alloc.alloc(2), alloc.alloc(2)
        assert pc.insert(tokens, a_pages, 0) == (a_pages, [])
        assert pc.insert(tokens, b_pages, 0) == (a_pages, b_pages)

    def test_release_and_evict(self, mk):
        pc, alloc = mk(n_pages=8)
        tokens = list(range(8))
        final, _ = pc.insert(tokens, alloc.alloc(2), 0)
        before = alloc.available
        assert pc.evict(2) == 0
        pc.release(final)
        assert pc.evict(2) == 2
        assert alloc.available == before + 2
        assert pc.acquire(tokens) == ([], 0)
        assert pc.stats() == {"cached_pages": 0, "hits": 0, "misses": 0, "evictions": 2, "hit_ratio": 0.0}

    def test_evict_leaves_before_parents(self, mk):
        pc, alloc = mk()
        tokens = list(range(12))
        final, _ = pc.insert(tokens, alloc.alloc(3), 0)
        pc.release(final)
        assert pc.evict(1) == 1
        shared, n = pc.acquire(tokens)
        assert len(shared) == 2 and n == 8

    def test_invalidate_drops_unshared_pages(self, mk):
        pc, alloc = mk()
        a = list(range(12))
        final, _ = pc.insert(a, alloc.alloc(3), 0)
        shared, _ = pc.acquire(a[:8] + [50, 51, 52, 53])  # a second holder of the first two pages
        pc.invalidate(final)
        assert pc.cached_pages == 2  # the third page is gone, the two still held stay
        assert pc.acquire(a)[0] == shared == final[:2]


# -- the engines -------------------------------------------------------------------

ENGINE_KW = dict(max_slots=4, max_model_len=128, page_size=16, prefill_buckets=(32, 64), seed=0, kv_dtype="float32",
                 decode_block=4)
SYSTEM = "You are a terse assistant. Answer in one word only, please."  # 60 bytes + BOS: 3 full pages
QUESTIONS = ["Sky colour?", "Capital of France?", "Two plus two?", "Opposite of up?"]


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _serve(eng, params_cls, prompts, **kw):
    reqs = [eng.submit(p, params_cls(**kw)) for p in prompts]
    texts = ["".join(eng.stream(r)) for r in reqs]
    return [(r.generated_tokens, r.finish_reason, r.cached_prompt_tokens, t) for r, t in zip(reqs, texts)]


def _pages(eng) -> tuple:
    pc = eng.prefix_cache
    return eng.cache.allocator.available, pc.cached_pages, pc.hits, pc.misses, pc.evictions


def test_shared_system_prompt_burst_as_the_jax_engine(weights):
    jcfg, tcfg, jparams, tparams = weights
    prompts = [SYSTEM + " " + q for q in QUESTIONS]
    long_prompt = SYSTEM + " " + "and a long follow-up question " * 3  # past the 64 bucket: chunked
    jeng = JaxEngine(jcfg, jparams, **ENGINE_KW)
    teng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    off = LLMEngine(tcfg, tparams, device="cpu", enable_prefix_cache=False, **ENGINE_KW)
    try:
        runs = {}
        for name, eng, P in (("jax", jeng, JaxParams), ("port", teng, SamplingParams), ("off", off, SamplingParams)):
            first = _serve(eng, P, prompts, max_tokens=5, temperature=0.0)
            seeded = _serve(eng, P, prompts, max_tokens=5, temperature=0.9, seed=11)
            chunked = _serve(eng, P, [long_prompt], max_tokens=4, temperature=0.0)
            runs[name] = (first, seeded, chunked, _pages(eng) if eng.prefix_cache is not None else None)
    finally:
        jeng.stop()
        teng.stop()
        off.stop()
    assert runs["port"] == runs["jax"]
    first, seeded, chunked, pages = runs["port"]
    n_sys = len(SYSTEM) + 1
    # the burst is admitted in one tick: the first claim inserts the shared
    # pages, the other three find them (the reference's page arithmetic)
    assert [r[2] for r in first] == [0] + [(n_sys // 16) * 16] * 3
    # the second round finds each prompt's own full pages too
    assert [r[2] for r in seeded] == [(len(p) + 1) // 16 * 16 for p in prompts]
    assert chunked[0][2] == (n_sys // 16) * 16
    assert pages[0] + pages[1] == teng.cache.n_pages - 1  # every page free or cached at zero refs
    for on, cache_off in zip(runs["port"][:3], runs["off"][:3]):  # sharing changes no token
        assert [r[:2] for r in on] == [r[:2] for r in cache_off]
        assert all(r[2] == 0 for r in cache_off)


def test_eviction_under_page_pressure_as_the_jax_engine(weights):
    """13 usable pages, 4-page claims, each prompt 2 full pages: cached pages
    pile up until claims evict them, LRU-first; hits, misses, evictions and
    page counts match the JAX engine after every request."""
    jcfg, tcfg, jparams, tparams = weights
    kw = dict(ENGINE_KW, n_pages=14, max_slots=2)
    prompts = [f"{i}{i} prompt variant " * 2 for i in range(6)] + ["00 prompt variant " * 2]  # 2 full pages each
    books = []
    for eng, P in ((JaxEngine(jcfg, jparams, **kw), JaxParams), (LLMEngine(tcfg, tparams, device="cpu", **kw),
                                                                  SamplingParams)):
        trace = []
        try:
            for p in prompts:
                r = eng.submit(p, P(max_tokens=20, temperature=0.0))
                "".join(eng.stream(r))
                trace.append((r.finish_reason, r.cached_prompt_tokens, _pages(eng)))
        finally:
            eng.stop()
        books.append(trace)
    assert books[1] == books[0]
    assert books[1][-1][2][4] > 0  # evictions happened
    assert all(avail + cached == kw["n_pages"] - 1 for _, _, (avail, cached, *_) in books[1])


@pytest.mark.parametrize("fn", ["prefill", "prefill_chunk"])
def test_failed_prefill_unwinds_its_claim(weights, monkeypatch, fn):
    """A prefill that raises (bucketed, or a chunk of a sliced prefill)
    finishes its request with "error", leaves none of its never-written pages
    in the trie or allocated, and the engine serves on (the reference's
    ``_fail_claims`` contract)."""
    from modal_examples_tpu_torch.serving import engine as engine_mod

    _, tcfg, _, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    prompt = SYSTEM + (" and a long follow-up question " * 3 if fn == "prefill_chunk" else " q")
    real = getattr(engine_mod.llama, fn)
    calls = []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected prefill failure")
        return real(*args, **kw)

    monkeypatch.setattr(engine_mod.llama, fn, failing)
    try:
        bad = eng.submit(prompt, SamplingParams(max_tokens=3, temperature=0.0))
        assert "".join(eng.stream(bad)) == "" and bad.finish_reason == "error"
        assert eng.prefix_cache.cached_pages == 0 and eng.cache.allocator.available == eng.cache.n_pages - 1
        good = eng.submit(prompt, SamplingParams(max_tokens=3, temperature=0.0))
        "".join(eng.stream(good))
        assert good.finish_reason == "length" and good.cached_prompt_tokens == 0
        assert not eng.error_log
    finally:
        eng.stop()
