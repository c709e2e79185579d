"""The port's prefix-affinity router (``scheduling/router.py``) against the
JAX package's, on the same fake clock and the same duck-typed replicas:
``rendezvous_score`` bytes, placements (affinity, saturation and
health-weight fallbacks), the down list and its re-probe, the disaggregated
``plan``, ``failover_target``, membership changes and ``stats``; and
``EngineReplica`` over the same fake engine (roles, probe and revival,
quarantine, the ``router.health_flap`` fault point).
"""

import pytest

import modal_examples_tpu.scheduling.router as jr
import modal_examples_tpu_torch.scheduling.router as tr
from modal_examples_tpu.faults import inject as jinject
from modal_examples_tpu_torch.faults import inject as tinject
from test_torch_time_limit import share_cores, time_limits

share_cores()

_limit_module, _limit_test = time_limits(test_s=60, module_s=120)

PKGS = {"jax": (jr, jinject), "torch": (tr, tinject)}


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class Req:
    def __init__(self, rid):
        self.request_id = rid


class Fake:
    """A duck-typed replica whose load, health and probe result a test sets."""

    def __init__(self, name, role="unified", capacity=4):
        self.name, self.role, self.cap = name, role, capacity
        self.load = 0
        self.up = True
        self.probe_ok = False
        self.probes = 0
        self.submitted = []

    @property
    def serves_requests(self):
        return self.role != "prefill"

    def encode(self, prompt):
        return [ord(c) for c in prompt]

    def outstanding(self):
        return self.load

    def capacity(self):
        return self.cap

    def healthy(self):
        return self.up

    def saturated(self):
        return self.load >= 2 * self.cap

    def probe(self):
        self.probes += 1
        if self.probe_ok:
            self.up = True
        return self.up

    def submit(self, prompt, params=None, **kw):
        self.submitted.append(prompt)
        return Req(f"req-{self.name}-{len(self.submitted)}")


PROMPTS = [f"system prompt {k % 5} " + "x" * 10 + f" question {k}" for k in range(30)]


def test_rendezvous_score_bytes_equal():
    for key in (b"", b"abc", bytes(range(20)), "kéy".encode()):
        for name in ("r0", "decode-a", "prefill-0", "ünïcode"):
            assert tr.rendezvous_score(key, name) == jr.rendezvous_score(key, name)


def _scenario(r) -> dict:
    clock = Clock()
    reps = [Fake("u0"), Fake("u1"), Fake("u2")]
    router = r.PrefixAffinityRouter(reps, prefix_tokens=8, reprobe_s=5.0, clock=clock)
    out = {"affinity": [router._route_ex(p)[0].name + ":" + router._route_ex(p)[1] for p in PROMPTS]}
    reps[0].load = 8  # saturated: its keys fall back to the least loaded
    reps[2].load = 1
    out["saturated"] = [router.route(p).name for p in PROMPTS[:10]]
    reps[0].load = 0
    router.set_health_weight("u1", 0.25)
    out["weighted"] = [router.route(p).name for p in PROMPTS[:10]]
    out["weight"] = (router.health_weight("u1"), router.health_weight("u0"))
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            router.set_health_weight("u1", bad)
    router.set_health_weight("u1", 1.0)
    reps[1].up = False  # down: out of the candidates until the re-probe
    out["down"] = [router.route(p).name for p in PROMPTS[:6]]
    clock.t += 2.0
    out["before_reprobe"] = ([r.name for r in router.reprobe()], reps[1].probes)
    clock.t += 4.0
    reps[1].probe_ok = True
    out["after_reprobe"] = ([r.name for r in router.reprobe()], reps[1].probes, router.readmissions)
    out["failover"] = [getattr(router.failover_target(exclude=x), "name", None) for x in ("u0", "u1", "u2", None)]
    req = router.submit(PROMPTS[3], None, trace=None)
    out["submit"] = (router.replica_for(req).name, req.request_id)
    with pytest.raises(KeyError):
        router.replica_for(Req("req-x"))
    router.add_replica(Fake("u3"))
    with pytest.raises(ValueError):
        router.add_replica(Fake("u3"))
    out["after_add"] = [router.route(p).name for p in PROMPTS[:10]]
    router.remove_replica("u0")
    with pytest.raises(KeyError):
        router.remove_replica("nope")
    out["after_remove"] = [router.route(p).name for p in PROMPTS[:10]]
    out["stats"] = router.stats()
    return out


def test_placements_as_the_jax_router():
    runs = [_scenario(r) for r, _ in PKGS.values()]
    assert runs[1] == runs[0]
    assert "affinity" in runs[1]["affinity"][0] and runs[1]["stats"]["affinity_hits"] > 0


def _plan_scenario(r) -> list:
    reps = [Fake("p0", "prefill"), Fake("p1", "prefill"), Fake("d0", "decode"), Fake("d1", "decode")]
    router = r.PrefixAffinityRouter(reps, clock=Clock())
    out = [tuple(getattr(x, "name", None) for x in router.plan(p)) for p in PROMPTS[:12]]
    reps[2].load = reps[3].load = 3
    router.set_health_weight("d0", 0.25)
    out += [tuple(getattr(x, "name", None) for x in router.plan(p)) for p in PROMPTS[:6]]
    reps[0].up = reps[1].up = False  # no healthy prefill peer: unified on a decoder
    out += [tuple(getattr(x, "name", None) for x in router.plan(p)) for p in PROMPTS[:4]]
    out.append(router.stats())
    return out


def test_disaggregated_plan_as_the_jax_router():
    runs = [_plan_scenario(r) for r, _ in PKGS.values()]
    assert runs[1] == runs[0]
    assert runs[1][-2][0] is None  # the last plans had no prefill peer


def test_a_router_needs_a_decode_capable_replica():
    for r, _ in PKGS.values():
        with pytest.raises(ValueError, match="decode-capable"):
            r.PrefixAffinityRouter([Fake("p0", "prefill")])
        with pytest.raises(ValueError, match="unique"):
            r.PrefixAffinityRouter([Fake("a"), Fake("a")])
        with pytest.raises(ValueError, match="at least one"):
            r.PrefixAffinityRouter([])


# -- EngineReplica over a fake engine ---------------------------------------------------


class FakePolicy:
    def __init__(self):
        self.depth = 0

    def total_depth(self):
        return self.depth


class FakeEngine:
    class tokenizer:
        @staticmethod
        def encode(text):
            return [ord(c) for c in text]

    def __init__(self):
        self.slots = []
        self.policy = FakePolicy()
        self.max_slots = 4
        self._stopped_on_error = False
        self._prefill_sync_pending = 0
        self.prefill_budget = 512
        self.trace_name = "engine"
        self.calls = []

    def revive(self):
        self.calls.append("revive")
        self._stopped_on_error = False
        return self

    def start(self):
        self.calls.append("start")
        return self


def _replica_scenario(r, inject) -> list:
    eng = FakeEngine()
    rep = r.EngineReplica(eng, "pre-0", role="prefill")
    out = [eng.prefill_budget, eng.trace_name, rep.serves_requests, rep.outstanding()]
    eng._prefill_sync_pending = 2
    eng.policy.depth = 5
    out += [rep.outstanding(), rep.saturated(), rep.capacity()]
    eng._stopped_on_error = True
    out += [rep.healthy(), rep.probe(), list(eng.calls)]  # a prefill replica only re-checks
    dec_eng = FakeEngine()
    dec = r.EngineReplica(dec_eng, "dec-0", role="decode")
    dec_eng._stopped_on_error = True
    out += [dec.healthy(), dec.probe(), list(dec_eng.calls), dec.healthy()]
    dec.quarantined = True
    out += [dec.healthy(), dec.probe()]
    dec.quarantined = False
    plan = inject.FaultPlan({"router.health_flap": {"on_hit": 2}})
    with inject.active(plan):
        out += [[dec.healthy() for _ in range(4)], plan.fired()]
    with pytest.raises(ValueError, match="role"):
        r.EngineReplica(FakeEngine(), "x", role="sideways")
    return out


def test_engine_replica_as_the_jax_package():
    runs = [_replica_scenario(r, inject) for r, inject in PKGS.values()]
    assert runs[1] == runs[0]
    assert runs[1][0] == 0 and runs[1][-2] == [True, False, True, True]
