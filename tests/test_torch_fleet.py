"""The port's fleet layer (``fleet/autoscaler.py``, ``fleet/loadgen.py``)
against the JAX package's:

- the same signal script (queue depth, KV pressure, sheds, quarantines,
  idle ticks, a prefill backlog) under the same fake clock gives the JAX
  ``FleetAutoscaler``'s decisions, ``fleet.jsonl`` records, router
  membership and fleet series, over fake replicas;
- a drain-safe scale-in of a real tiny engine: the victim's live streams
  migrate through ``serving/failover.drain_replica`` to the seed replica and
  end with the uninterrupted run's tokens, and its engine stops only at
  ``outstanding() == 0``;
- ``SnapshotWarmFactory``: the first build is cold and captures, later ones
  are warm with bitwise-equal parameters, a scale-out joins the shared
  prefix store, a poisoned snapshot boots cold;
- the load generator's arrivals, prompts, knee and ``fleet_section`` equal
  the JAX package's, and one Poisson step against the port's OpenAI server
  completes every request.
"""

import dataclasses
import json
import random
import threading
import time

import numpy as np
import pytest
import torch

import jax

import modal_examples_tpu.fleet.loadgen as jlg
from modal_examples_tpu.fleet import FleetAutoscaler as JAutoscaler
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.observability import catalog as JC
from modal_examples_tpu.scheduling import PrefixAffinityRouter as JRouter
from modal_examples_tpu.utils.prometheus import Registry as JRegistry
from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams
from modal_examples_tpu_torch.faults import inject
from modal_examples_tpu_torch.fleet import FleetAutoscaler, SnapshotWarmFactory
from modal_examples_tpu_torch.fleet import loadgen as tlg
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.observability import catalog as C
from modal_examples_tpu_torch.scheduling.router import EngineReplica, PrefixAffinityRouter
from modal_examples_tpu_torch.snapshot import SnapshotStore
from modal_examples_tpu_torch.storage.volume import Volume
from modal_examples_tpu_torch.utils.prometheus import Registry
from test_fleet import _Clock, _FakeReplica
from test_torch_time_limit import share_cores, thread_guard, time_limits

share_cores()

_limit_module, _limit_test = time_limits(test_s=120, module_s=180)
_threads = thread_guard()

SIDES = {"jax": (JAutoscaler, JRouter, JRegistry, JC), "port": (FleetAutoscaler, PrefixAffinityRouter, Registry, C)}


# -- the controller over fake replicas, script by script ---------------------------


def _queue(reps, clock, reg, C):
    reps[0].engine.queued = 10  # > queue_high per replica
    yield
    yield
    yield
    yield
    clock.now += 6.0  # the cooldown lapses; the streak fires again
    yield
    reps[0].engine.queued = 0
    for _ in range(8):
        clock.now += 1.0
        yield


def _floor(reps, clock, reg, C):
    for _ in range(3):
        yield


def _kv(reps, clock, reg, C):
    reps[0].engine.pages_used = 30
    reps[0].engine.prefix_cache.cached_pages = 30  # warmth is not pressure
    yield
    reps[0].engine.admission.reserved_pages = 20  # reservations are
    yield
    yield


def _sheds(reps, clock, reg, C):
    yield
    reg.counter_inc(C.SHEDS_TOTAL, 3.0, labels={"class": "default", "reason": "queue_full"})
    yield
    reg.counter_inc(C.SHEDS_TOTAL, 5.0, labels={"class": "canary", "reason": "queue_full"})  # probes: not demand
    clock.now += 10.0
    yield


def _quarantine(reps, clock, reg, C):
    reps[0].quarantined = True
    yield
    clock.now += 10.0
    yield  # edge-triggered: one replacement per benched replica
    reps[0].quarantined = False
    clock.now += 10.0
    yield


def _prefill(reps, clock, reg, C):
    reps[1]._outstanding = 30  # a prefill backlog; the decode side is idle
    yield
    reps[1]._outstanding = 0
    for _ in range(8):
        clock.now += 1.0
        yield


def _drain_race(reps, clock, reg, C):
    reps[0].engine.queued = 50
    yield
    reps[0].engine.queued = 0
    yield
    yield  # scale_down of the grown replica
    grown = reps[-1]
    grown._outstanding = 1  # placed between the idle check and the removal
    yield
    grown._outstanding = 0
    yield
    for _ in range(4):
        clock.now += 1.0
        yield


SCRIPTS = {
    "queue-hysteresis-cooldown": (_queue, dict(up_ticks=2, down_ticks=3, cooldown_s=5.0, max_replicas={"decode": 4})),
    "min-floor": (_floor, dict(up_ticks=3, cooldown_s=60.0, min_replicas={"decode": 3},
                               max_replicas={"decode": 4})),
    "kv-warmth": (_kv, dict(up_ticks=1, cooldown_s=0.0, kv_high=0.5, max_replicas={"decode": 3})),
    "sheds": (_sheds, dict(up_ticks=1, cooldown_s=5.0, max_replicas={"decode": 3})),
    "quarantine": (_quarantine, dict(up_ticks=1, cooldown_s=5.0, max_replicas={"decode": 3})),
    "prefill-role": (_prefill, dict(up_ticks=1, down_ticks=2, cooldown_s=0.0,
                                    max_replicas={"decode": 2, "prefill": 2})),
    "drain-race": (_drain_race, dict(up_ticks=1, down_ticks=2, cooldown_s=0.0, max_replicas={"decode": 2})),
}

_WALL = ("at", "boot_s")


def _run_script(side: str, name: str, tmp_path) -> dict:
    Auto, Router, Reg, CC = SIDES[side]
    script, kw = SCRIPTS[name]
    reps = [_FakeReplica("seed-0")]
    if name == "prefill-role":
        reps.append(_FakeReplica("pre-0", role="prefill"))
    router = Router(list(reps))
    reg, clock = Reg(), _Clock()

    def factory(rname, role):
        rep = _FakeReplica(rname, role=role)
        reps.append(rep)
        return rep, "warm"

    journal = tmp_path / f"{side}-fleet.jsonl"
    auto = Auto(router, factory, registry=reg, slos=(), clock=clock, journal_path=journal, **kw)
    ticks = []
    for _ in script(reps, clock, reg, CC):
        acts = auto.tick()
        ticks.append((
            [{k: v for k, v in a.items() if k not in _WALL} for a in acts],
            [r.name for r in router.replicas],
            [r.name for r, _t in auto._draining],
            sorted(r.name for r in reps[1:] if r.engine.stopped),
        ))
    records = [{k: v for k, v in json.loads(line).items() if k not in _WALL}
               for line in journal.read_text().splitlines()] if journal.exists() else []
    series = {
        "replicas": sorted((lbl.get("role"), v) for lbl, v in reg.series(CC.FLEET_REPLICAS)),
        "decisions": sorted((lbl.get("action"), lbl.get("trigger"), v)
                            for lbl, v in reg.series(CC.FLEET_DECISIONS_TOTAL)),
        "boots": reg.histogram_quantiles(CC.FLEET_BOOT_SECONDS, aggregate={"boot": "warm"}) is not None,
    }
    stats = auto.stats()
    stats["events"] = [{k: v for k, v in e.items() if k not in _WALL} for e in stats["events"]]
    return {"ticks": ticks, "journal": records, "series": series, "stats": stats}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_the_same_signals_give_the_reference_decisions_and_journal(name, tmp_path):
    got = {side: _run_script(side, name, tmp_path) for side in SIDES}
    assert got["port"] == got["jax"]
    actions = [a for tick in got["port"]["ticks"] for a in tick[0]]
    assert actions, "the script took no decision"
    assert got["port"]["journal"] == [a for a in actions if a["action"] in ("scale_up", "scale_down")]


def test_each_trigger_is_exercised(tmp_path):
    triggers = set()
    for name in SCRIPTS:
        (tmp_path / name).mkdir()
        for tick in _run_script("port", name, tmp_path / name)["ticks"]:
            triggers |= {(a["action"], a["trigger"]) for a in tick[0]}
    assert triggers >= {("scale_up", "queue_pressure"), ("scale_up", "min_replicas"), ("scale_up", "kv_pressure"),
                        ("scale_up", "shed_pressure"), ("scale_up", "quarantine"), ("scale_down", "idle")}


# -- real engines: drain by migration, warm boots ------------------------------------

ENGINE_KW = dict(max_slots=2, max_model_len=96, page_size=8, prefill_buckets=(16, 32), decode_block=4, seed=0)
PROMPT = "the quick brown fox jumps over the lazy dog"
GREEDY = dict(max_tokens=40, temperature=0.0)  # long enough to still decode when the drain runs


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return tcfg, tparams


@pytest.fixture(scope="module")
def uninterrupted(weights):
    tcfg, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    try:
        req = eng.submit(PROMPT, SamplingParams(**GREEDY))
        "".join(eng.stream(req))
    finally:
        eng.stop()
    return list(req.generated_tokens), req.finish_reason


def _wait_tokens(req, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while len(req.generated_tokens) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(req.generated_tokens) >= n


def test_scale_in_migrates_live_streams_and_reaps_at_zero_outstanding(weights, uninterrupted, tmp_path):
    tcfg, tparams = weights
    seed = EngineReplica(LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW), "seed-0")
    router = PrefixAffinityRouter([seed])
    built = []

    def factory(name, role):
        rep = EngineReplica(LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW), name, role=role)
        built.append(rep)
        return rep, "cold"

    clock = _Clock()
    # idle_low=1.0: two live streams on one of two 2-slot replicas read as
    # idle, so the busy owned replica is the scale-in victim
    auto = FleetAutoscaler(router, factory, registry=Registry(), slos=(), clock=clock, up_ticks=1, down_ticks=1,
                           idle_low=1.0, cooldown_s=0.0, max_replicas={"decode": 2},
                           journal_path=tmp_path / "fleet.jsonl")
    readers = []
    try:
        seed.engine.start()
        auto.min_replicas["decode"] = 2  # one forced scale-out
        assert [a["trigger"] for a in auto.tick()] == ["min_replicas"]
        auto.min_replicas["decode"] = 1
        victim = built[0]
        slow = inject.FaultPlan({"engine.slow_decode": {"p": 1.0}})
        with inject.active(slow):
            reqs = [victim.submit(PROMPT, SamplingParams(**GREEDY)) for _ in range(2)]
            readers = [threading.Thread(target=lambda r=r: "".join(victim.engine.stream(r))) for r in reqs]
            for t in readers:
                t.start()
            for r in reqs:
                _wait_tokens(r, 2)
            acts = auto.tick()  # idle by the load signals: scale_down of the owned replica
            assert [(a["action"], a["replica"]) for a in acts] == [("scale_down", victim.name)]
            assert victim.name not in [r.name for r in router.replicas]
            assert not victim.engine._stopped_on_error
            auto.tick()  # the drain: both live streams migrate to the seed
        for t in readers:
            t.join(timeout=60)
        deadline = time.monotonic() + 30
        while auto._draining and time.monotonic() < deadline:
            clock.now += 1.0
            auto.tick()
            time.sleep(0.02)
    finally:
        for t in readers:
            t.join(timeout=60)
        auto.stop(drain=True)
        seed.engine.stop()
        for rep in built:
            rep.engine.stop()
    assert not auto._draining and victim.outstanding() == 0 and not victim.engine._running
    for r in reqs:
        assert (list(r.generated_tokens), r.finish_reason) == uninterrupted
    records = [json.loads(line) for line in (tmp_path / "fleet.jsonl").read_text().splitlines()]
    migrate = [r for r in records if r["action"] == "drain_migrate"]
    assert migrate and sum(r["migrated"] for r in migrate) == 2 and not any(r["failed"] for r in migrate)
    assert sum(r["tokens_migrated"] for r in migrate) >= 4


def test_snapshot_warm_factory_boots_warm_with_the_same_weights(weights, tmp_path):
    tcfg, tparams = weights
    built = []
    store = SnapshotStore(root=tmp_path / "snap")

    def build(name, role, params=None):
        eng = LLMEngine(tcfg, params if params is not None else tparams, device="cpu", **ENGINE_KW)
        built.append((eng, params is not None))
        return EngineReplica(eng, name, role=role)

    factory = SnapshotWarmFactory(build, snapshot_key="tiny-fleet", store=store)
    try:
        first, boot1 = factory("d-1", "decode")
        second, boot2 = factory("d-2", "decode")
        assert (boot1, boot2) == ("cold", "warm") and [w for _, w in built] == [False, True]
        a, b = first.engine.params, second.engine.params
        for key in a:
            for x, y in zip(jax.tree_util.tree_leaves(a[key]), jax.tree_util.tree_leaves(b[key])):
                assert torch.equal(x, y) and x.device == y.device
        outs = []
        for eng in (first.engine, second.engine):
            req = eng.submit(PROMPT, SamplingParams(**GREEDY))
            "".join(eng.stream(req))
            outs.append(list(req.generated_tokens))
        assert outs[0] == outs[1]
        # a poisoned entry is dropped and the boot degrades to cold, loudly
        store.delete("tiny-fleet")
        assert store.put("tiny-fleet", b"not a snapshot", manifest={"kind": "fleet-params"})
        third, boot3 = factory("d-3", "decode")
        assert boot3 == "cold" and store.has("tiny-fleet")
    finally:
        for eng, _ in built:
            eng.stop()


def test_a_scale_out_joins_the_shared_prefix_store(weights, tmp_path):
    tcfg, tparams = weights
    built = []
    with Volume.ephemeral() as vol:
        def build(name, role, params=None):
            eng = LLMEngine(tcfg, tparams, device="cpu", tiered_prefix={"volume": vol, "shared": True, "replica": name},
                            **ENGINE_KW)
            built.append(eng)
            return EngineReplica(eng, name, role=role)

        factory = SnapshotWarmFactory(build, snapshot_key="tiny-store", store=SnapshotStore(root=tmp_path / "s"))
        try:
            rep, boot = factory("d-1", "decode")
            store = rep.engine.tiered.store
            assert boot == "cold" and store.alive_replicas() == ["d-1"]
            assert json.loads(vol.read_file(f"{store.root}/replicas/d-1.json"))["boot"] == "cold"
            from modal_examples_tpu_torch.fleet.autoscaler import _deregister_prefix_store

            _deregister_prefix_store(rep)
            assert store.alive_replicas() == []
        finally:
            for eng in built:
                eng.stop()


# -- the load generator ----------------------------------------------------------------


@pytest.mark.parametrize("arrival", ["poisson", "heavy_tail"])
def test_arrivals_and_prompts_equal_the_reference(arrival):
    gens = [m.LoadGenerator("http://localhost:1", arrival=arrival, seed=3, tenants=3) for m in (jlg, tlg)]
    seqs = []
    for g in gens:
        rng = random.Random(f"{g.seed}|{g.arrival}|2.000000")
        seqs.append(([g._interarrival(rng, 2.0) for _ in range(50)],
                     [(c.name, t, p) for c, t, p in (g._pick(rng) for _ in range(20))]))
    assert seqs[0] == seqs[1]
    gaps = seqs[1][0]
    assert 0.2 < float(np.mean(gaps)) < 1.2  # mean-preserving around 1 / rate
    with pytest.raises(ValueError):
        tlg.LoadGenerator("http://localhost:1", arrival="uniform")


def test_knee_and_fleet_section_equal_the_reference():
    def step(rate, good, shed, ttft, tpot):
        return {"offered_rps": rate, "offered": int(rate * 10), "duration_s": 10.0, "goodput_rps": good,
                "achieved_rps": good, "shed_rate": shed, "ttft": {"p50": ttft / 2, "p99": ttft},
                "tpot": {"p50": tpot / 2, "p99": tpot}, "wedged": 0}

    pinned = {"arrival": "poisson", "rates": [1.0, 2.0, 4.0],
              "steps": [step(1, 1.0, 0, 0.1, 0.01), step(2, 1.9, 0, 0.2, 0.02), step(4, 2.0, 0.3, 1.5, 0.05)]}
    auto = {"arrival": "poisson", "rates": [1.0, 2.0, 4.0],
            "steps": [step(1, 1.0, 0, 0.1, 0.01), step(2, 2.0, 0, 0.15, 0.02), step(4, 3.8, 0.01, 0.3, 0.03)]}
    for sweep in (pinned, auto):
        sweep["knee_index"] = next((i for i, s in enumerate(sweep["steps"])
                                    if s["goodput_rps"] < 0.8 * s["offered"] / s["duration_s"]), 2)
        sweep["knee_rps"] = sweep["steps"][sweep["knee_index"]]["offered_rps"]
    events = [{"action": "scale_up", "boot": "warm"}, {"action": "scale_up", "boot": "cold"},
              {"action": "scale_down"}]
    for kw in ({}, {"scaled_step": auto["steps"][2]}):
        got = [m.fleet_section(pinned, auto, scale_events=events, capacity_rps=2.5, **kw) for m in (jlg, tlg)]
        assert got[0] == got[1]
    assert tlg.ab_index(pinned) == jlg.ab_index(pinned) == 1


def test_one_poisson_step_against_the_port_server(weights):
    tcfg, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", **{**ENGINE_KW, "max_slots": 4})
    srv = OpenAIServer(eng, port=0).start()
    try:
        classes = (tlg.RequestClass("interactive", "interactive", 0.7, (0, 1), 4, 60.0, 10.0),
                   tlg.RequestClass("batch", "batch", 0.3, (0, 1), 4, 60.0, 10.0, stream=False))
        gen = tlg.LoadGenerator(f"http://127.0.0.1:{srv.port}", classes=classes, seed=1, tenants=2, request_timeout_s=60.0)
        report = gen.run_step(4.0, 1.5, label="4rps")
    finally:
        srv.stop()
        eng.stop()
    assert report["offered"] > 0 and report["wedged"] == 0 and report["errors"] == 0
    assert report["completed"] + report["shed"] == report["offered"]
    assert sum(c["offered"] for c in report["per_class"].values()) == report["offered"]
    assert report["ttft"]["p99"] > 0
