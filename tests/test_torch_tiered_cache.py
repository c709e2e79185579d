"""The port's tiered prefix cache (``serving/disagg/tiered_cache.py``, the
engine's ``tiered_prefix=``) against the JAX package's, over the same tiny
f32 weights:

- a shared-prompt burst on bf16 and int8 pages, stepped by hand
  (``eng.step()``, a fake clock) on a JAX engine and a port engine, each
  with a host tier small enough to demote to its own Volume; the trie is
  evicted between rounds (the spill), and the second round promotes from
  both tiers. After every tick the two engines agree on the tokens, the
  slots, the free and cached pages, ``cached_tokens``, the spilled,
  promoted and registered counts, the tier hits and each tier's blocks and
  payload bytes. A block's bytes are its MTKV1 header plus the pages: the
  header holds each leaf's crc32 as a decimal number, whose width follows
  the pages' last bits (the frameworks' f32 K/V rows may differ there), so
  the payloads are compared, and each tier's byte total is held to its
  blocks' lengths;
- within the port, a promoted page holds the bytes its page held before the
  spill, bitwise, bf16 and int8;
- ``tiered.volume_corrupt`` drops the block in flight, keeps the stored file
  and recomputes, as in the JAX package; ``prefix_store.owner_death`` makes
  the survivor take the lease over and promote warm;
- a second replica over the same store promotes the chain the first one
  demoted (volume hits from a peer), with the tokens of the JAX engine;
- the JAX package's host-tier acceptance (``tests/test_disagg.py``): a
  prefill replica's evicted prefix promotes from its host tier behind a
  ``DisaggCoordinator`` and the output stays the unified engine's.

Token ids are compared, never text. Each test stops every engine it starts.
"""

import dataclasses
import queue
import struct

import numpy as np
import pytest
import torch

import jax

from modal_examples_tpu.faults import inject as jinject
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu.storage.volume import Volume as JVolume
from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.faults import inject as tinject
from modal_examples_tpu_torch.faults.chaos import _force_spill
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.scheduling.router import EngineReplica
from modal_examples_tpu_torch.serving.disagg import DisaggCoordinator, extract_pages
from modal_examples_tpu_torch.storage.volume import Volume as TVolume
from test_torch_time_limit import share_cores, thread_guard, time_limits

share_cores()

_limit_module, _limit_test = time_limits(test_s=120, module_s=180)
_threads = thread_guard()

ENGINE_KW = dict(max_slots=3, max_model_len=96, page_size=8, prefill_buckets=(16, 32, 64), decode_block=4, seed=0)
SYSTEM = "You are a terse assistant; answer in one word."  # 47 bytes + BOS: 6 full pages of 8
QUESTIONS = [" Sky colour?", " Capital of France?", " Two plus two?"]
SAMPLING = [dict(max_tokens=5, temperature=0.0), dict(max_tokens=4, temperature=0.8, seed=11),
            dict(max_tokens=6, temperature=0.0)]
#: host budgets that hold three blocks, so the rest of a spill demotes
HOST_BYTES = {"bfloat16": 15_000, "int8": 10_000}
TICKS = 24


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


def _engine(side, weights, kv, vol, replica="a", host_bytes=0, **kw):
    """A tiered engine of one package over ``vol`` (``host_bytes`` 0: the
    module's three-block budget; None: the default 64 MiB)."""
    jcfg, tcfg, jparams, tparams = weights
    tier = {"host_bytes": HOST_BYTES[kv] if host_bytes == 0 else host_bytes, "volume": vol, "shared": True,
            "replica": replica}
    kw = {**ENGINE_KW, "kv_dtype": kv, "clock": FakeClock(), **kw}
    if side == "jax":
        return JaxEngine(jcfg, jparams, tiered_prefix=tier, **kw), JaxParams
    return LLMEngine(tcfg, tparams, device="cpu", tiered_prefix=tier, **kw), SamplingParams


def _payload(data: bytes) -> int:
    """A block's page bytes: its length less the MTKV1 magic, the header
    length word and the JSON header."""
    (hlen,) = struct.unpack_from("<I", data, 6)
    return len(data) - 10 - hlen


def _tier_state(eng) -> tuple:
    t = eng.tiered
    st = t.stats()
    with t._lock:
        host = {h: _payload(d) for h, d in t._host.items()}
        assert st["host"]["bytes"] == sum(len(d) for d in t._host.values())
    vol = {}
    for h in sorted(t.store._index):
        path = t.store.volume.local_path / t.store._rel(h)
        if path.exists():
            data = path.read_bytes()
            vol[h] = _payload(data)
    counts = {k: st[k] for k in ("hits", "spilled", "promoted", "registered_pages")}
    store = {k: st["store"][k] for k in ("blocks", "puts", "writes", "dedup_skips", "deferred", "hits", "misses",
                                          "invalidated", "pins", "takeovers")}
    return (st["host"]["blocks"], host, st["volume"]["blocks"], vol, counts, store)


def _state(eng, reqs) -> tuple:
    held = {id(s.request): i for i, s in enumerate(eng.slots) if s.request is not None}
    return (
        tuple(tuple(r.generated_tokens) for r in reqs),
        tuple(held.get(id(r)) for r in reqs),
        tuple(r.cached_prompt_tokens for r in reqs),
        eng.cache.allocator.available,
        eng.prefix_cache.cached_pages,
        _tier_state(eng),
    )


def _round(eng, P, states):
    reqs = [eng.submit(SYSTEM + q, P(**kw)) for q, kw in zip(QUESTIONS, SAMPLING)]
    for _ in range(TICKS):
        eng.step()
        states.append(_state(eng, reqs))
    return reqs


def _finish(req):
    while req.finish_reason is None:
        try:
            item = req.out_queue.get_nowait()
        except queue.Empty:
            return None
        if hasattr(item, "reason"):
            req.finish_reason = item.reason
    return req.finish_reason


def _first_registered(eng) -> list:
    """Record the trie pages of the first prompt the tier registers (read
    later without touching the trie's recency, so eviction order stays the
    JAX engine's)."""
    seen, register = [], eng.tiered.register

    def watch(key_tokens, trie_pages):
        if not seen:
            seen.append(list(trie_pages))
        return register(key_tokens, trie_pages)

    eng.tiered.register = watch
    return seen


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def runs(request, weights):
    """Round 1, the spill, round 2 on a JAX and a port engine: per-tick
    states and the port's page bytes around the spill."""
    kv = request.param
    out = {}
    for side, Vol in (("jax", JVolume), ("port", TVolume)):
        with Vol.ephemeral() as vol:
            eng, P = _engine(side, weights, kv, vol)
            try:
                states = []
                registered = _first_registered(eng) if side == "port" else None
                first = _round(eng, P, states)
                before = None
                if side == "port":
                    before = {name: t.clone() for name, t in extract_pages(eng.cache, registered[0]).leaves.items()}
                eng.prefix_cache.evict(10_000)
                states.append(("spilled", _tier_state(eng), eng.cache.allocator.available))
                promoted = []
                if side == "port":
                    adopt = eng.tiered.promote

                    def watch(key_tokens, *, n_have):
                        got = adopt(key_tokens, n_have=n_have)
                        if got and not promoted:
                            promoted.append({n: t.clone() for n, t in extract_pages(eng.cache, got).leaves.items()})
                        return got

                    eng.tiered.promote = watch
                second = _round(eng, P, states)
                reasons = [_finish(r) for r in first + second]
            finally:
                eng.stop()
            out[side] = {"states": states, "reasons": reasons, "before": before, "promoted": promoted,
                         "second": second, "kv": kv}
    return out


def test_tiered_burst_matches_the_jax_engine_tick_by_tick(runs):
    j, p = runs["jax"]["states"], runs["port"]["states"]
    assert len(p) == len(j) == 2 * TICKS + 1
    for t, (a, b) in enumerate(zip(p, j)):
        assert a == b, f"tick {t}: port {a} != jax {b}"
    assert runs["port"]["reasons"] == runs["jax"]["reasons"]
    assert all(r in ("stop", "length") for r in runs["port"]["reasons"])


def test_the_spill_fills_both_tiers_and_the_second_round_promotes_from_both(runs):
    spilled = next(s for s in runs["port"]["states"] if s[0] == "spilled")
    host_blocks, _, vol_blocks, _, counts, store = spilled[1]
    assert host_blocks == 3 and vol_blocks >= 3 and counts["spilled"] == host_blocks + vol_blocks
    assert store["writes"] == vol_blocks
    final = runs["port"]["states"][-1][5][4]
    assert final["hits"]["host"] > 0 and final["hits"]["volume"] > 0
    # cached_tokens counts the promoted pages: the whole shared prompt
    n_full = len(runs["port"]["second"][0].prompt_tokens) // ENGINE_KW["page_size"]
    assert runs["port"]["second"][0].cached_prompt_tokens == n_full * ENGINE_KW["page_size"]


def test_promoted_pages_hold_the_spilled_bytes_bitwise(runs):
    before, promoted = runs["port"]["before"], runs["port"]["promoted"]
    assert promoted, "the second round promoted nothing"
    got = promoted[0]
    n = next(iter(got.values())).shape[1]
    for name, t in before.items():
        a, b = t[:, :n].contiguous(), got[name].contiguous()
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), name


def _serve(eng, P, prompts, **kw):
    reqs = [eng.submit(p, P(**kw)) for p in prompts]
    for r in reqs:
        "".join(eng.stream(r))
    return [(list(r.generated_tokens), r.finish_reason, r.cached_prompt_tokens) for r in reqs]


def _fault_run(side, weights, kv, point):
    """``tiered.volume_corrupt``: serve, spill to the volume, serve again
    with the point armed. ``prefix_store.owner_death``: two replicas warm
    on one chain, the owner's spill dies mid-put, the survivor's spill takes
    the lease over, and the survivor serves again from the store."""
    inject = jinject if side == "jax" else tinject
    Vol = JVolume if side == "jax" else TVolume
    prompts = [SYSTEM + q for q in QUESTIONS]
    with Vol.ephemeral() as vol:
        engines = [_engine(side, weights, kv, vol, replica=name, host_bytes=None)[0]
                   for name in (("a", "b") if point == "prefix_store.owner_death" else ("a",))]
        P = JaxParams if side == "jax" else SamplingParams
        try:
            first = [_serve(eng, P, prompts, max_tokens=4, temperature=0.0) for eng in engines]
            plan = inject.FaultPlan({point: {"on_hit": 1}})
            serving = engines[0]
            if point == "tiered.volume_corrupt":
                _force_spill(serving)
                with inject.active(plan):
                    second = _serve(serving, P, prompts, max_tokens=4, temperature=0.0)
            else:
                for eng in engines:
                    eng.prefix_cache.evict(10_000)
                head = serving.tiered._chain_of[next(iter(serving.tiered._host))]
                owner = serving.tiered.store.owner_for(head)
                dead, serving = (engines[0], engines[1]) if owner == "a" else (engines[1], engines[0])
                with inject.active(plan):
                    _force_spill(dead)
                    _force_spill(serving)
                    dead.tiered.store.register_replica()
                    second = _serve(serving, P, prompts, max_tokens=4, temperature=0.0)
            store = serving.tiered.store
            return {
                "first": first, "second": second, "fired": plan.fired(), "stats": _tier_state(serving),
                "stored": sorted(h for h in list(store._index) if store.exists(h)),
                "takeovers": [e.tiered.store.board.takeovers for e in engines],
            }
        finally:
            for eng in engines:
                eng.stop()


@pytest.mark.parametrize("point", ["tiered.volume_corrupt", "prefix_store.owner_death"])
def test_tier_fault_points_end_as_in_the_jax_package(weights, point):
    got = {side: _fault_run(side, weights, "int8", point) for side in ("jax", "port")}
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["fired"] == {point: 1}
    assert [r[:2] for r in port["second"]] == [r[:2] for r in port["first"][0]]
    if point == "tiered.volume_corrupt":
        # the block corrupted in flight was dropped from the promote, not
        # from the store; prefill recomputed it
        assert port["stats"][5]["invalidated"] == 0 and port["stored"]
        assert port["second"][0][2] == 0  # the first block broke the promote
    else:
        # the survivor took the dead owner's lease over and promoted warm
        assert sum(port["takeovers"]) == 1 and port["stats"][4]["hits"]["volume"] > 0


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_a_second_replica_promotes_what_the_first_demoted(weights, kv):
    """Replica "b", booted over the store after "a" spilled to it (a
    scale-out): volume hits from a peer's blocks, and the JAX engine's
    tokens."""
    jcfg, _, jparams, _ = weights
    prompts = [SYSTEM + q for q in QUESTIONS]
    ref = JaxEngine(jcfg, jparams, kv_dtype=kv, enable_prefix_cache=False, **ENGINE_KW)
    try:
        want = [r[:2] for r in _serve(ref, JaxParams, prompts, max_tokens=5, temperature=0.0)]
    finally:
        ref.stop()
    with TVolume.ephemeral() as vol:
        a, P = _engine("port", weights, kv, vol, host_bytes=1)
        b = None
        try:
            assert [r[:2] for r in _serve(a, P, prompts, max_tokens=5, temperature=0.0)] == want
            _force_spill(a)  # everything a cached lands on the shared volume
            b, _ = _engine("port", weights, kv, vol, replica="b", host_bytes=1)
            got = _serve(b, P, prompts, max_tokens=5, temperature=0.0)
            st = b.tiered.stats()
        finally:
            a.stop()
            if b is not None:
                b.stop()
    assert [r[:2] for r in got] == want
    assert st["hits"]["volume"] > 0 and st["store"]["hits"]["peer"] > 0
    n_full = len(b.make_request(prompts[0], trace=None).prompt_tokens) // ENGINE_KW["page_size"]
    assert got[0][2] == n_full * ENGINE_KW["page_size"]  # b's first prompt promoted whole


def test_host_tier_prefix_hit_behind_a_coordinator_stays_token_identical(weights):
    """The JAX package's host-tier acceptance: the prefill replica's trie is
    evicted into its host tier, the next request promotes it back."""
    jcfg, tcfg, jparams, tparams = weights
    prompt = "the quick brown fox jumps over the lazy dog and then some more"
    ref = JaxEngine(jcfg, jparams, kv_dtype="int8", **ENGINE_KW)
    try:
        want = _serve(ref, JaxParams, [prompt], max_tokens=10, temperature=0.0)[0][:2]
    finally:
        ref.stop()
    kw = {**ENGINE_KW, "kv_dtype": "int8"}
    ep = LLMEngine(tcfg, tparams, device="cpu", tiered_prefix={"host_bytes": 1 << 20}, **kw)
    ed = LLMEngine(tcfg, tparams, device="cpu", **kw)
    co = DisaggCoordinator([EngineReplica(ep, "pre-0", role="prefill"), EngineReplica(ed, "dec-0", role="decode")],
                           chunk_bytes=512)
    try:
        first = co.submit(prompt, SamplingParams(max_tokens=10, temperature=0.0))
        "".join(co.stream(first))
        ep.prefix_cache.evict(10_000)
        assert ep.tiered.stats()["host"]["blocks"] > 0
        again = co.submit(prompt, SamplingParams(max_tokens=10, temperature=0.0))
        "".join(co.stream(again))
        assert ep.tiered.stats()["hits"]["host"] > 0
        assert (list(first.generated_tokens), first.finish_reason) == want
        assert (list(again.generated_tokens), again.finish_reason) == want
        assert co.migrations_ok == 2
    finally:
        ed.stop()
