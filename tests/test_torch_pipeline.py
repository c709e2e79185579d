"""The port's pipelined decode loop against the JAX engine's, tick by tick.

Both engines serve the tiny llama (the JAX ``init_params`` weights through
``params_from_jax``, f32 compute) over bf16 and int8 pages, at
``decode_steps`` 1 (the decode block) and 4 (the macro-step), stepped by hand
(``eng.step()``, a fake clock). After every tick they must agree on the
blocks in flight, the parked first tokens, which slots are decodable and
which wait on their first token, the tokens accepted by each request, the
finish reasons, the free pages and the step and token counters. The port
dispatches no step past every slot's budget, which the JAX engine runs and,
at N = 1, counts: there the decode steps plus the steps saved against the
nominal block agree, at N > 1 the steps themselves. The bursts
hold more requests than slots with short ``max_tokens``, so slots finish and
are recycled while a block that still decodes them is in flight; others are
aborted or pass their deadline with a block in flight.

Then the JAX ``tests/test_stall_free.py::TestDeferredHarvest`` cases as
port tests, and the page targets of optimistic positions past a slot's
claim (the trash page, never another slot's page).
"""

import dataclasses
import queue

import numpy as np
import pytest
import torch

import jax

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu.utils.prometheus import default_registry as jax_registry
from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.observability import catalog as C
from modal_examples_tpu_torch.utils.prometheus import default_registry
from test_torch_time_limit import share_cores

share_cores()

ENGINE_KW = dict(max_slots=3, max_model_len=96, page_size=8, prefill_buckets=(16, 32), decode_block=4, seed=0)
#: prompt lengths 12, 41 (chunked: past the 32 bucket), 20, 3, 71 (chunked), 16, 9, 28
BURST = [
    ("hello there", dict(max_tokens=5, temperature=0.0)),
    ("a" * 40, dict(max_tokens=9, temperature=0.8, seed=11)),
    ("the quick brown fox", dict(max_tokens=3, temperature=0.0)),
    ("zz", dict(max_tokens=12, temperature=0.9)),  # an engine-assigned seed
    ("x" * 70, dict(max_tokens=6, temperature=0.0)),
    ("more words here", dict(max_tokens=2, temperature=0.7, seed=5)),
    ("short q", dict(max_tokens=7, temperature=0.0)),
    ("the last one in the queue", dict(max_tokens=4, temperature=0.6, seed=3)),
]
GRID = [(1, "bfloat16"), (1, "int8"), (4, "bfloat16"), (4, "int8")]
GRID_IDS = [f"N{n}-{kv}" for n, kv in GRID]


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


def _engines(weights, **kw):
    """(name, engine, SamplingParams, clock) for the JAX engine and the port's."""
    jcfg, tcfg, jparams, tparams = weights
    kw = {**ENGINE_KW, **kw}
    jclock, tclock = FakeClock(), FakeClock()
    engines = [
        ("jax", JaxEngine(jcfg, jparams, clock=jclock, **kw), JaxParams, jclock),
        ("port", LLMEngine(tcfg, tparams, device="cpu", clock=tclock, **kw), SamplingParams, tclock),
    ]
    for _, eng, _, _ in engines:
        eng.saved_before = _steps_saved(eng)
    return engines


def _steps_saved(eng) -> float:
    """Decode steps saved against the nominal block, so far in this process,
    by the engine's package's count."""
    reg = default_registry if isinstance(eng, LLMEngine) else jax_registry
    return reg.total(C.MULTISTEP_EARLY_EXIT_STEPS_TOTAL)


def _finish_of(req):
    """The finish reason once the terminal marker is queued (text drained)."""
    while req.finish_reason is None:
        try:
            item = req.out_queue.get_nowait()
        except queue.Empty:
            return None
        if hasattr(item, "reason"):
            req.finish_reason = item.reason
    return req.finish_reason


def _state(eng, reqs) -> tuple:
    """One tick's observation. A request's finish is read as its slot
    going free: at N > 1 the detokenization thread delivers the marker, at a
    moment of its own; the reasons are compared once the engine stopped."""
    held = {id(s.request): i for i, s in enumerate(eng.slots) if s.request is not None}
    return (
        len(eng._inflight), len(eng._pending_harvest),
        tuple(i for i, s in enumerate(eng.slots) if s.decodable),
        tuple(i for i, s in enumerate(eng.slots) if s.pending_first),
        tuple(tuple(r.generated_tokens) for r in reqs),
        tuple(held.get(id(r)) for r in reqs),
        eng.cache.allocator.available,
        (eng.stats.steps + _steps_saved(eng) - eng.saved_before, eng.stats.steps if eng.decode_steps > 1 else None,
         eng.stats.prompt_tokens, eng.stats.generated_tokens),
    )


def _instrument(eng) -> dict:
    """Count, on the instance, the blocks in flight whenever a block is read
    (``peak``), the rows of a block being read whose slot another request
    took while the block was in flight (``recycled``), and the harvests of
    parked first tokens that came after a decode dispatch in the same tick
    (``harvest_after_dispatch``)."""
    seen = {"peak": 0, "recycled": 0, "harvest_after_dispatch": 0, "dispatched": False}
    process, dispatch, harvest, step = eng._process_block, eng._dispatch_block, eng._harvest_prefills, eng.step

    def process_block():
        seen["peak"] = max(seen["peak"], len(eng._inflight))
        snapshot = eng._inflight[0][2]  # (tokens, ..., snapshot, ...)
        seen["recycled"] += sum(
            1 for i, req, tenancy in snapshot
            if eng.slots[i].request is not None and eng.slots[i].tenancy != tenancy
        )
        return process()

    def dispatch_block(live):
        seen["dispatched"] = True
        return dispatch(live)

    def harvest_prefills():
        if eng._pending_harvest and seen["dispatched"]:
            seen["harvest_after_dispatch"] += 1
        return harvest()

    def tick():
        seen["dispatched"] = False
        return step()

    eng._process_block, eng._dispatch_block, eng._harvest_prefills, eng.step = (
        process_block, dispatch_block, harvest_prefills, tick)
    return seen


def _leftover(eng) -> int:
    """Pages neither free nor cached at zero refs (0 once every claim is back)."""
    return eng.cache.occupancy()["pages_used"] - eng.prefix_cache.cached_pages


def _drive(weights, n, kv, scenario, ticks=36, **kw):
    """Run ``scenario(eng, P, clock, tick)`` before every tick of a hand-stepped
    burst on both engines; returns both lists of per-tick states and the
    recycled-in-flight counts."""
    runs = {}
    for name, eng, P, clock in _engines(weights, kv_dtype=kv, decode_steps=n, **kw):
        try:
            reqs = [eng.submit(p, P(**params)) for p, params in BURST]
            seen = _instrument(eng)
            states = []
            for t in range(ticks):
                scenario(eng, reqs, clock, t)
                eng.step()
                states.append(_state(eng, reqs))
        finally:
            eng.stop()
        runs[name] = (states, seen, reqs, _leftover(eng), [_finish_of(r) for r in reqs])
    return runs


def _assert_same_ticks(runs):
    jax_states, port_states = runs["jax"][0], runs["port"][0]
    for t, (j, p) in enumerate(zip(jax_states, port_states)):
        assert p == j, f"tick {t}: port {p} != jax {j}"
    assert runs["port"][4] == runs["jax"][4]  # finish reasons


def _no_event(eng, reqs, clock, t):
    pass


@pytest.mark.parametrize("n,kv", GRID, ids=GRID_IDS)
def test_burst_matches_the_jax_engine_tick_by_tick(weights, n, kv):
    runs = _drive(weights, n, kv, _no_event)
    _assert_same_ticks(runs)
    states, seen, reqs, leftover, reasons = runs["port"]
    jseen = runs["jax"][1]
    assert seen["peak"] == jseen["peak"] == 2  # a block was read with the next one in flight
    # first tokens parked by a prefill were read after that tick's decode dispatch
    assert seen["harvest_after_dispatch"] == jseen["harvest_after_dispatch"] > 0
    assert seen["recycled"] == jseen["recycled"] > 0  # slots recycled under a block in flight
    assert all(r in ("stop", "length") for r in reasons)
    assert states[-1][0] == 0 and leftover == runs["jax"][3] == 0  # every page back


@pytest.mark.parametrize("n,kv", GRID, ids=GRID_IDS)
def test_abort_with_a_block_in_flight(weights, n, kv):
    """Requests aborted while blocks that decode them are in flight (and one
    before its first token is harvested) finish "stop" on both engines, at
    the same tick, with the same pages back."""
    aborted = set()

    def scenario(eng, reqs, clock, t):
        for i, r in enumerate(reqs):
            s = next((s for s in eng.slots if s.request is r), None)
            if s is None or (eng.__class__.__module__, i) in aborted:
                continue
            if (i == 3 and eng._inflight) or (i == 4 and s.pending_first) or (i == 6 and s.decodable
                                                                             and eng._inflight):
                aborted.add((eng.__class__.__module__, i))
                eng.abort(r)

    runs = _drive(weights, n, kv, scenario)
    _assert_same_ticks(runs)
    reqs, reasons = runs["port"][2], runs["port"][4]
    assert {i for _, i in aborted} >= {3, 6}
    assert reasons[3] == reasons[6] == "stop" and len(reqs[3].generated_tokens) < 12
    assert runs["port"][3] == runs["jax"][3] == 0  # every page back


@pytest.mark.parametrize("n,kv", [GRID[0], GRID[3]], ids=[GRID_IDS[0], GRID_IDS[3]])
def test_deadline_with_a_block_in_flight(weights, n, kv):
    """A deadline that passes while a block decodes the request (and queued
    work that expires) finishes "deadline" at the same tick on both engines."""
    runs = {}
    for name, eng, P, clock in _engines(weights, kv_dtype=kv, decode_steps=n):
        try:
            reqs = [eng.submit("never ends", P(max_tokens=60, temperature=0.0, deadline_s=5.0))]
            reqs += [eng.submit(p, P(**params)) for p, params in BURST[:4]]
            reqs.append(eng.submit("queued and late", P(max_tokens=4, deadline_s=1.0)))
            states = []
            for t in range(30):
                if t == 4:
                    assert eng._inflight  # the doomed request is decoding in a block in flight
                    clock.t = 10.0
                eng.step()
                states.append(_state(eng, reqs))
        finally:
            eng.stop()
        runs[name] = (states, None, reqs, _leftover(eng), [_finish_of(r) for r in reqs])
    _assert_same_ticks(runs)
    reqs, reasons = runs["port"][2], runs["port"][4]
    assert reasons[0] == reasons[-1] == "deadline"
    assert 0 < len(reqs[0].generated_tokens) < 60


class TestDeferredHarvest:
    """The JAX ``tests/test_stall_free.py::TestDeferredHarvest`` cases."""

    def test_group_first_tokens_harvest_after_decode_dispatch(self, weights):
        """A batch of short prompts admitted in one tick parks its first
        tokens and still lights every slot up within that tick."""
        _, tcfg, _, tparams = weights
        eng = LLMEngine(tcfg, tparams, device="cpu", max_slots=4, max_model_len=256, page_size=16,
                        prefill_buckets=(16, 32), max_prefill_tokens_per_tick=0)
        try:
            p = SamplingParams(max_tokens=3, temperature=0.0)
            reqs = [eng.submit(f"group {i}", p) for i in range(3)]
            eng.step()
            assert not eng._pending_harvest  # harvested inside the tick
            assert sum(1 for s in eng.slots if s.decodable) == 3
            for _ in range(40):
                eng.step()
                if all(_finish_of(r) for r in reqs):
                    break
            assert all(r.finish_reason in ("stop", "length") for r in reqs)
        finally:
            eng.stop()

    def test_decode_stall_histogram_records(self, weights):
        """The dispatch-gap histogram records under concurrent traffic."""
        _, tcfg, _, tparams = weights
        before = (default_registry.histogram_quantiles(C.DECODE_STALL_SECONDS) or {}).get("count", 0)
        eng = LLMEngine(tcfg, tparams, device="cpu", max_slots=4, max_model_len=256, page_size=16,
                        prefill_buckets=(16, 32), max_prefill_tokens_per_tick=16)
        try:
            p = SamplingParams(max_tokens=8, temperature=1.0)
            reqs = [eng.submit("x" * 120, p)] + [eng.submit(f"r{i}", p) for i in range(3)]
            for r in reqs:
                "".join(eng.stream(r))
        finally:
            eng.stop()
        q = default_registry.histogram_quantiles(C.DECODE_STALL_SECONDS)
        assert q is not None and q["count"] >= before + 1


def test_optimistic_positions_past_the_claim_write_the_trash_page():
    """A lane decoding past its claimed pages (a block queued beyond the
    slot's finish) targets page 0, and a position past the table's width
    stays in the slot's own row: never a page another slot owns."""
    tables = torch.tensor([[5, 6, 0, 0], [7, 8, 9, 10]], dtype=torch.int32)  # slot 0 claimed 2 of 4 pages
    ps = 8
    positions = torch.tensor([[3, 15, 16, 31, 40, 200], [3, 15, 16, 31, 40, 200]])
    page_idx, slot = tllama._page_targets(tables, positions, torch.ones_like(positions, dtype=torch.bool), ps)
    assert page_idx[0].tolist() == [5, 6, 0, 0, 0, 0]
    assert page_idx[1].tolist() == [7, 8, 9, 10, 10, 10]  # its own last page, past the table
    dead, _ = tllama._page_targets(tables, positions, torch.zeros_like(positions, dtype=torch.bool), ps)
    assert (dead == 0).all()
