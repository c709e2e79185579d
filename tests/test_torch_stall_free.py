"""The port's stall-free prefill budget against the JAX engine's.

The cases of ``tests/test_stall_free.py`` that do not need the deferred
first-token harvest (which the port leaves out: it reads a prefill's first
token when its last chunk lands): budget resolution, the sliced chunked
prefill stepped tick by tick beside the JAX engine (chunk offsets, ticks and
suspensions), the budget stopping the conversion of queued entries,
token identity across budgets, and aborts and deadlines that land
mid-prefill (the claim unwound, the trie unpoisoned); and a long prompt
arriving while streams decode, its chunks interleaved with decode blocks.
"""

import dataclasses
import queue

import numpy as np
import pytest

import jax

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.observability import catalog as C
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu.utils.prometheus import default_registry
from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from test_torch_time_limit import share_cores

share_cores()

ENGINE_KW = dict(max_slots=4, max_model_len=256, page_size=16, prefill_buckets=(16, 32), kv_dtype="float32",
                 decode_block=4)
#: past the largest bucket (32): 121 tokens in chunks of 32/32/32/25
LONG_PROMPT = "x" * 120


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engine(weights, which: str, budget, **kw):
    jcfg, tcfg, jparams, tparams = weights
    kw = {**ENGINE_KW, "seed": 0, **kw}
    if which == "jax":
        return JaxEngine(jcfg, jparams, max_prefill_tokens_per_tick=budget, **kw), JaxParams
    return LLMEngine(tcfg, tparams, device="cpu", max_prefill_tokens_per_tick=budget, **kw), SamplingParams


def _drain(req):
    """A hand-stepped request's finish reason, or None while it runs."""
    while True:
        try:
            item = req.out_queue.get_nowait()
        except queue.Empty:
            return None
        if hasattr(item, "reason"):
            req.finish_reason = item.reason
            return item.reason


def _pending(eng, req):
    slot = next((s for s in eng.slots if s.request is req), None)
    if slot is None or slot.prefill is None:
        return None
    return slot.prefill.offset, slot.prefill.ticks, slot.prefill.suspensions


def _leftover(eng) -> int:
    """Pages neither free nor cached at zero refs (0 once every claim is back)."""
    return eng.cache.occupancy()["pages_used"] - eng.prefix_cache.cached_pages


class TestBudgetResolution:
    @pytest.mark.parametrize("env,arg,want", [("7", 3, 3), ("48", None, 48), (None, None, 0), ("48", 0, 0)])
    def test_argument_then_env_then_unlimited(self, weights, monkeypatch, env, arg, want):
        if env is None:
            monkeypatch.delenv("MTPU_PREFILL_BUDGET", raising=False)
        else:
            monkeypatch.setenv("MTPU_PREFILL_BUDGET", env)
        engines = [_engine(weights, which, arg)[0] for which in ("jax", "torch")]
        try:
            assert [e.prefill_budget for e in engines] == [want, want]
        finally:
            for e in engines:
                e.stop()


class TestSlicedPrefill:
    def test_budget_slices_chunked_prefill_across_ticks(self, weights):
        """budget < one chunk: one chunk a tick (the progress guarantee),
        offsets, ticks and suspensions equal to the JAX engine's tick by tick."""
        sliced_before = default_registry.value(C.PREFILL_SLICED_TOTAL) or 0
        traces = []
        for which in ("jax", "torch"):
            eng, P = _engine(weights, which, 1)
            try:
                req = eng.submit(LONG_PROMPT, P(max_tokens=4, temperature=0.0))
                trace = []
                for _ in range(40):
                    eng.step()
                    trace.append(_pending(eng, req))
                    if _drain(req) is not None:
                        break
                # the JAX engine reads the first token a tick later (its deferred harvest)
                traces.append((trace[:4], req.finish_reason, req.generated_tokens, _leftover(eng)))
                if which == "torch":
                    assert eng.stats.prefill_suspensions == 3
                else:
                    assert (default_registry.value(C.PREFILL_SLICED_TOTAL) or 0) == sliced_before + 3
            finally:
                eng.stop()
        assert traces[1] == traces[0]
        assert traces[1][0][:3] == [(32, 1, 1), (64, 2, 2), (96, 3, 3)] and traces[1][0][3] is None

    def test_budget_stops_converting_queue_entries(self, weights):
        """Short prompts past the budget stay queued (front requeue,
        reservations kept) and are admitted on later ticks, never dropped."""
        books = []
        for which in ("jax", "torch"):
            eng, P = _engine(weights, which, 8)
            try:
                reqs = [eng.submit(f"prompt {i}", P(max_tokens=2, temperature=0.0)) for i in range(4)]
                eng.step()
                # one prompt (9 tokens) spends the budget; the port may already
                # have finished it (it reads the first token in the same tick)
                first = (eng.policy.total_depth(), eng.admission.reserved_pages)
                for _ in range(60):
                    eng.step()
                    for r in reqs:
                        if r.finish_reason is None:
                            _drain(r)
                    if all(r.finish_reason for r in reqs):
                        break
                books.append((first, [r.finish_reason for r in reqs], eng.policy.total_depth(),
                              eng.admission.reserved_pages, _leftover(eng)))
            finally:
                eng.stop()
        assert books[1] == books[0]
        (depth, reserved), reasons = books[1][0], books[1][1]
        assert depth == 3 and reserved == 3 * 1
        assert set(reasons) <= {"stop", "length"} and books[1][2:] == (0, 0, 0)


class TestSchedulingInvariance:
    """Sampling is keyed by (seed, position): budget on or off, sliced or
    atomic, the tokens are the same, and the JAX engine's."""

    PROMPTS = [LONG_PROMPT, "short a", "short b", "y" * 100, "zz"]

    def _run(self, weights, which, budget, **params):
        eng, P = _engine(weights, which, budget)
        try:
            reqs = [eng.submit(p, P(**params)) for p in self.PROMPTS]
            outs = ["".join(eng.stream(r)) for r in reqs]
            return outs, [r.finish_reason for r in reqs], [r.generated_tokens for r in reqs]
        finally:
            eng.stop()

    @pytest.mark.parametrize("params", [
        dict(max_tokens=6, temperature=0.0),
        dict(max_tokens=6, temperature=1.0, seed=77),
        dict(max_tokens=6, temperature=1.0),  # engine-assigned seeds
    ], ids=["greedy", "seeded", "auto-seeded"])
    def test_token_identical_across_budgets_and_to_jax(self, weights, params):
        unbudgeted = self._run(weights, "torch", 0, **params)
        assert self._run(weights, "torch", 16, **params) == unbudgeted
        assert self._run(weights, "torch", 1, **params) == unbudgeted
        assert self._run(weights, "jax", 16, **params) == unbudgeted

    def test_budget_flip_on_one_engine_token_identical(self, weights):
        eng, P = _engine(weights, "torch", 0)
        try:
            for params in (P(max_tokens=6, temperature=0.0), P(max_tokens=6, temperature=1.0, seed=123)):
                rounds = []
                for budget in (0, 16):
                    eng.prefill_budget = budget
                    reqs = [eng.submit(p, params) for p in (LONG_PROMPT, "short", "y" * 90)]
                    rounds.append(["".join(eng.stream(r)) for r in reqs])
                assert rounds[0] == rounds[1], params
        finally:
            eng.stop()


class TestMidPrefillAbortAndDeadline:
    def test_abort_mid_chunk_unwinds_claim(self, weights):
        books = []
        for which in ("jax", "torch"):
            eng, P = _engine(weights, which, 1)
            try:
                req = eng.submit(LONG_PROMPT, P(max_tokens=4, temperature=0.0))
                eng.step()
                slot = next(s for s in eng.slots if s.request is req)
                assert slot.prefill is not None and slot.prefill.offset < 121
                eng.abort(req)
                eng.step()
                # the trie is not poisoned: the same prompt prefills again
                # from scratch and serves a clean engine's tokens
                again = eng.generate(LONG_PROMPT, P(max_tokens=4, temperature=0.0))
                books.append((_drain(req), slot.free, slot.prefill, _leftover(eng), eng.prefix_cache.cached_pages,
                              again))
            finally:
                eng.stop()
        clean, P = _engine(weights, "torch", 0, enable_prefix_cache=False)
        try:
            want = clean.generate(LONG_PROMPT, P(max_tokens=4, temperature=0.0))
        finally:
            clean.stop()
        assert books[1] == books[0]
        assert books[1][:4] == ("stop", True, None, 0) and books[1][5] == want

    def test_deadline_mid_prefill(self, weights):
        books = []
        for which in ("jax", "torch"):
            t = [0.0]
            eng, P = _engine(weights, which, 1, clock=lambda: t[0])
            try:
                req = eng.submit(LONG_PROMPT, P(max_tokens=4, temperature=0.0, deadline_s=5.0))
                eng.step()
                slot = next(s for s in eng.slots if s.request is req)
                assert slot.prefill is not None
                t[0] = 10.0  # past the deadline while chunks are pending
                eng.step()
                books.append((_drain(req), slot.free, _leftover(eng), eng.prefix_cache.cached_pages,
                              eng.cache.allocator.available))
            finally:
                eng.stop()
        assert books[1] == books[0]
        assert books[1][:3] == ("deadline", True, 0) and books[1][3] == 0  # its unwritten pages left the trie


def test_long_prompt_interleaves_with_decoding_streams(weights):
    """Seven streams decode when a long prompt arrives under a 32-token
    budget: its chunks go out one a tick, with a decode block between each
    two; its offsets match the JAX engine's tick by tick, and every token
    matches the unbudgeted run."""
    runs = {}
    for which, budget in (("torch", 32), ("jax", 32), ("torch", 0)):
        eng, P = _engine(weights, which, budget, max_slots=8)
        try:
            streams = [eng.submit(f"stream {i}", P(max_tokens=40, temperature=0.0)) for i in range(7)]
            for _ in range(3):
                eng.step()
            long = eng.submit("q" * 150, P(max_tokens=5, temperature=0.0))
            offsets, steps_between = [], []
            for _ in range(12):
                steps0 = eng.stats.steps
                eng.step()
                offsets.append(_pending(eng, long))
                steps_between.append(eng.stats.steps - steps0)
            reqs = streams + [long]
            for r in reqs:
                "".join(eng.stream(r))
            runs[(which, budget)] = (offsets, steps_between, [(r.generated_tokens, r.finish_reason) for r in reqs])
        finally:
            eng.stop()
    port, jax_run, unbudgeted = runs[("torch", 32)], runs[("jax", 32)], runs[("torch", 0)]
    assert [o and o[0] for o in port[0]] == [o and o[0] for o in jax_run[0]]
    assert [o[0] for o in port[0] if o] == [32, 64, 96, 128]  # 151 tokens: 5 chunks, one a tick
    assert port[0][4] is None and port[0][3][2] == 4  # four suspensions, then the first token
    assert all(n > 0 for n in port[1][:5])  # a decode block ran in every one of those ticks
    assert port[2] == unbudgeted[2] == jax_run[2]
