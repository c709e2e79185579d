"""The port's scheduling against the JAX package's.

The unit cases of ``tests/test_scheduling.py`` (``FairSharePolicy``,
``FIFOPolicy``, ``AdmissionController``), run over both packages' classes;
the engines with fake clocks, exactly: deadlines of queued and in-flight
requests, priority classes and tenant fair share under a full engine, with
page and reservation accounting; and the OpenAI servers: 429 bodies and
``Retry-After``, deadlines and ``cached_tokens``.
"""

import dataclasses
import json
import queue
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

import modal_examples_tpu.scheduling.admission as jadm
import modal_examples_tpu.scheduling.policy as jpol
import modal_examples_tpu_torch.scheduling.admission as tadm
import modal_examples_tpu_torch.scheduling.policy as tpol
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.openai_api import OpenAIServer as JaxServer
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from test_torch_time_limit import share_cores

share_cores()

PACKAGES = {
    "jax": types.SimpleNamespace(pol=jpol, adm=jadm),
    "torch": types.SimpleNamespace(pol=tpol, adm=tadm),
}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _entry(pkg, payload=None, priority="default", tenant="default", cost=1, deadline=None):
    return pkg.pol.ScheduledRequest(payload=payload, priority=priority, tenant=tenant, cost=cost, deadline=deadline)


class TestFairSharePolicy:
    def test_strict_class_priority(self, pkg):
        p = pkg.pol.FairSharePolicy(clock=FakeClock())
        for i in range(3):
            p.submit(_entry(pkg, payload=f"b{i}", priority="batch"))
        p.submit(_entry(pkg, payload="d0", priority="default"))
        p.submit(_entry(pkg, payload="i0", priority="interactive"))
        assert [e.payload for e in p.next_batch(3)] == ["i0", "d0", "b0"]
        assert [e.payload for e in p.next_batch(10)] == ["b1", "b2"]

    def test_tenant_fair_share_interleaves_a_flood(self, pkg):
        p = pkg.pol.FairSharePolicy(clock=FakeClock(), quantum=1)
        for i in range(8):
            p.submit(_entry(pkg, payload=f"flood{i}", tenant="flooder"))
        p.submit(_entry(pkg, payload="t0", tenant="trickle"))
        p.submit(_entry(pkg, payload="t1", tenant="trickle"))
        out = [e.payload for e in p.next_batch(4)]
        assert "t0" in out and "t1" in out, out

    def test_tenant_weights_skew_service(self, pkg):
        p = pkg.pol.FairSharePolicy(clock=FakeClock(), quantum=1, tenant_weights={"heavy": 3.0})
        for i in range(6):
            p.submit(_entry(pkg, payload=("heavy", i), tenant="heavy"))
            p.submit(_entry(pkg, payload=("light", i), tenant="light"))
        out = p.next_batch(8)
        heavy = sum(1 for e in out if e.payload[0] == "heavy")
        assert heavy > 8 - heavy

    def test_requeue_goes_back_to_the_front_in_order(self, pkg):
        p = pkg.pol.FairSharePolicy(clock=FakeClock())
        for name in ("a", "b", "c"):
            p.submit(_entry(pkg, payload=name))
        batch = p.next_batch(2)
        assert [e.payload for e in batch] == ["a", "b"]
        p.requeue(batch)
        assert [e.payload for e in p.next_batch(3)] == ["a", "b", "c"]

    def test_expired_removes_past_deadline_entries(self, pkg):
        clock = FakeClock()
        p = pkg.pol.FairSharePolicy(clock=clock)
        p.submit(_entry(pkg, payload="no-deadline"))
        p.submit(_entry(pkg, payload="soon", deadline=1.0))
        p.submit(_entry(pkg, payload="later", deadline=10.0))
        assert p.expired() == []
        clock.advance(5.0)
        assert [e.payload for e in p.expired()] == ["soon"]
        assert p.total_depth() == 2

    def test_remove_queued_entry(self, pkg):
        p = pkg.pol.FairSharePolicy(clock=FakeClock())
        e = _entry(pkg, payload="x", priority="interactive", tenant="t")
        p.submit(e)
        assert p.depths()["interactive"] == 1
        assert p.remove(e) is True
        assert p.remove(e) is False
        assert p.total_depth() == 0

    def test_unknown_class_is_refused(self, pkg):
        with pytest.raises(ValueError, match="unknown priority class"):
            pkg.pol.FairSharePolicy(clock=FakeClock()).submit(_entry(pkg, priority="urgent"))


class TestFIFOPolicy:
    def test_fifo_ignores_class_for_ordering(self, pkg):
        p = pkg.pol.FIFOPolicy(clock=FakeClock())
        p.submit(_entry(pkg, payload="b", priority="batch"))
        p.submit(_entry(pkg, payload="i", priority="interactive"))
        assert [e.payload for e in p.next_batch(2)] == ["b", "i"]

    def test_depths_and_expiry(self, pkg):
        clock = FakeClock()
        p = pkg.pol.FIFOPolicy(clock=clock)
        p.submit(_entry(pkg, payload="x", priority="batch", deadline=1.0))
        assert p.depths()["batch"] == 1
        clock.advance(2.0)
        assert [e.payload for e in p.expired()] == ["x"]

    def test_requeue_remove_and_drain(self, pkg):
        p = pkg.pol.FIFOPolicy(clock=FakeClock())
        es = [_entry(pkg, payload=n) for n in "abc"]
        for e in es:
            p.submit(e)
        p.requeue(p.next_batch(2))
        assert p.remove(es[1]) and not p.remove(es[1])
        assert [e.payload for e in p.drain()] == ["a", "c"] and p.total_depth() == 0


class TestAdmission:
    def _ctl(self, pkg, **cfg_kw):
        return pkg.adm.AdmissionController(pkg.adm.AdmissionConfig(**cfg_kw), clock=FakeClock())

    def test_queue_full_sheds_with_retry_after(self, pkg):
        ctl = self._ctl(pkg, max_queue={"interactive": 8, "default": 2, "batch": 8})
        with pytest.raises(pkg.adm.ShedError) as exc:
            ctl.admit(_entry(pkg), depths={"default": 2}, pages_used=0, pages_total=64)
        assert exc.value.reason == "queue_full"
        assert exc.value.retry_after_s == 2.0 and str(exc.value) == "default queue is full (2/2)"
        assert ctl.sheds == 1 and ctl.admitted == 0

    def test_too_large_sheds(self, pkg):
        with pytest.raises(pkg.adm.ShedError) as exc:
            self._ctl(pkg).admit(_entry(pkg, cost=100), depths={}, pages_used=0, pages_total=64)
        assert exc.value.reason == "too_large"

    def test_kv_pressure_sheds_batch_before_interactive(self, pkg):
        ctl = self._ctl(pkg, kv_ceiling={"batch": 0.5, "default": 0.8})
        with pytest.raises(pkg.adm.ShedError) as exc:
            ctl.admit(_entry(pkg, priority="batch"), depths={}, pages_used=40, pages_total=64)
        assert exc.value.reason == "kv_pressure"
        ctl.admit(_entry(pkg), depths={}, pages_used=40, pages_total=64)
        ctl.admit(_entry(pkg, priority="interactive"), depths={}, pages_used=40, pages_total=64)
        assert ctl.admitted == 2

    def test_reservations_count_toward_pressure(self, pkg):
        ctl = self._ctl(pkg, kv_ceiling={"batch": 0.5})
        e1 = _entry(pkg, priority="batch", cost=20)
        ctl.admit(e1, depths={}, pages_used=0, pages_total=64)
        assert ctl.reserved_pages == 20
        with pytest.raises(pkg.adm.ShedError):
            ctl.admit(_entry(pkg, priority="batch", cost=20), depths={}, pages_used=0, pages_total=64)
        ctl.release(e1)
        assert ctl.reserved_pages == 0
        ctl.admit(_entry(pkg, priority="batch", cost=20), depths={}, pages_used=0, pages_total=64)
        ctl.reserve(e1)
        assert ctl.reserved_pages == 40

    def test_shed_counters(self, pkg):
        ctl = self._ctl(pkg, max_queue={"interactive": 1, "default": 1, "batch": 0})
        with pytest.raises(pkg.adm.ShedError):
            ctl.admit(_entry(pkg, priority="batch"), depths={}, pages_used=0, pages_total=8)
        assert ctl.sheds == 1 and ctl.shed_rate() == 1.0

    def test_config_from_env(self, pkg, monkeypatch):
        monkeypatch.setenv("MTPU_SCHED_MAX_QUEUE", "9")
        monkeypatch.setenv("MTPU_SCHED_MAX_QUEUE_BATCH", "3")
        monkeypatch.setenv("MTPU_SCHED_KV_HEADROOM", "0.7")
        cfg = pkg.adm.AdmissionConfig.from_env()
        assert cfg.max_queue == {"interactive": 9, "default": 9, "batch": 3, "canary": 9}
        assert cfg.kv_ceiling["batch"] == 0.7 and abs(cfg.kv_ceiling["default"] - 0.8) < 1e-12


# -- the engines -------------------------------------------------------------------

ENGINE_KW = dict(max_slots=2, max_model_len=64, page_size=16, prefill_buckets=(32,), kv_dtype="float32",
                 decode_block=4)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _finish_of(req) -> str | None:
    """The request's finish reason once its marker is queued (text drained)."""
    while True:
        try:
            item = req.out_queue.get_nowait()
        except queue.Empty:
            return None
        if hasattr(item, "reason"):
            req.finish_reason = item.reason
            return item.reason


def _books(eng) -> tuple:
    """(queued, reserved pages, free pages, cached pages, busy slots)."""
    pc = eng.prefix_cache
    return (eng.policy.total_depth(), eng.admission.reserved_pages, eng.cache.allocator.available,
            pc.cached_pages if pc is not None else 0, sum(1 for s in eng.slots if not s.free))


def _both(weights, scenario, **kw):
    """``scenario(engine, SamplingParams, clock)`` on the JAX engine and on
    the port's, each with its own fake clock and stepped by hand (the
    scheduler threads never run); returns both observation lists."""
    jcfg, tcfg, jparams, tparams = weights
    kw = {**ENGINE_KW, **kw}
    out = []
    for make, params in (
        (lambda clock: JaxEngine(jcfg, jparams, clock=clock, **kw), JaxParams),
        (lambda clock: LLMEngine(tcfg, tparams, device="cpu", clock=clock, **kw), SamplingParams),
    ):
        clock = FakeClock()
        eng = make(clock)
        try:
            out.append(scenario(eng, params, clock))
        finally:
            eng.stop()
    return out


def test_queued_deadline_expires_with_fake_clock(weights):
    def scenario(eng, P, clock):
        hogs = [eng.submit("hog", P(max_tokens=32, temperature=0.0)) for _ in range(2)]
        doomed = eng.submit("doomed", P(max_tokens=4, deadline_s=1.0))
        eng.step()  # the hogs take both slots; doomed stays queued
        obs = [_books(eng)]
        clock.advance(2.0)
        eng.step()
        obs += [_books(eng), _finish_of(doomed), doomed.n_generated]
        for r in hogs:
            eng.abort(r)
        eng.step()
        return obs + [_books(eng), [_finish_of(r) for r in hogs]]

    jax_obs, port_obs = _both(weights, scenario)
    assert port_obs == jax_obs
    assert port_obs[0][:2] == (1, 1) and port_obs[1][:2] == (0, 0) and port_obs[2] == "deadline"
    assert port_obs[-1] == ["stop", "stop"] and port_obs[-2][4] == 0


def test_inflight_deadline_aborts_decode(weights):
    def scenario(eng, P, clock):
        req = eng.submit("never ends", P(max_tokens=10_000, deadline_s=5.0))
        eng.step()
        obs = [_books(eng)]
        clock.advance(10.0)
        eng.step()  # expired, aborted and reaped in one tick
        return obs + [_books(eng), _finish_of(req)]

    jax_obs, port_obs = _both(weights, scenario)
    assert port_obs == jax_obs
    assert port_obs[0][4] == 1 and port_obs[1][4] == 0 and port_obs[2] == "deadline"
    assert port_obs[1][2] == ENGINE_KW["max_slots"] * 4  # every page back (no full prompt page cached)


def test_classes_and_tenants_order_admission_under_a_full_engine(weights):
    """Two slots: an interactive request is admitted before earlier batch
    work, and a second tenant's requests before the rest of a first tenant's
    flood (deficit round robin over page costs)."""

    def scenario(eng, P, clock):
        p = P(max_tokens=40, temperature=0.0)
        reqs = [eng.submit(f"bulk {i}", p, priority="batch") for i in range(3)]
        reqs += [eng.submit(f"flood {i}", p, tenant="flooder") for i in range(4)]
        reqs += [eng.submit(f"trickle {i}", p, tenant="trickle") for i in range(2)]
        reqs.append(eng.submit("chat", p, priority="interactive"))
        order = []
        for _ in range(12):  # an aborted slot is reaped after the next admission
            eng.step()
            for s in eng.slots:
                if s.request is not None and s.request.prompt not in order:
                    order.append(s.request.prompt)
            for s in eng.slots:  # free both slots for the next pair
                if s.request is not None:
                    eng.abort(s.request)
        return [order, _books(eng)]

    jax_obs, port_obs = _both(weights, scenario)
    assert port_obs == jax_obs
    order = port_obs[0]
    assert len(order) == 10 and order[0] == "chat", order
    # the second tenant interleaves with the flood; batch work comes last
    assert order.index("trickle 0") < order.index("flood 2") and order[-3:] == ["bulk 0", "bulk 1", "bulk 2"], order


# -- the OpenAI servers ------------------------------------------------------------


def _post(base, body, headers=None):
    req = urllib.request.Request(base + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


@pytest.fixture(scope="module")
def servers(weights):
    """The two servers over the same weights, batch always over its (zero)
    queue bound."""
    jcfg, tcfg, jparams, tparams = weights
    kw = dict(ENGINE_KW, max_slots=4, max_model_len=128, prefill_buckets=(16, 32))
    bound = {"interactive": 64, "default": 64, "batch": 0, "canary": 64}
    jsrv = JaxServer(JaxEngine(jcfg, jparams, admission=jadm.AdmissionController(jadm.AdmissionConfig(
        max_queue=bound)), **kw), host="127.0.0.1", port=0).start()
    tsrv = OpenAIServer(LLMEngine(tcfg, tparams, device="cpu", admission=tadm.AdmissionController(
        tadm.AdmissionConfig(max_queue=bound)), **kw), port=0).start()
    yield f"http://127.0.0.1:{jsrv.port}", f"http://127.0.0.1:{tsrv.port}"
    jsrv.stop()
    tsrv.stop()


def test_overload_answers_429_as_the_reference(servers):
    got = [_post(base, {"messages": [{"role": "user", "content": "bulk"}], "max_tokens": 4},
                 {"x-mtpu-priority": "batch"}) for base in servers]
    (js, jh, jb), (ts, th, tb) = got
    assert ts == js == 429 and th["retry-after"] == jh["retry-after"] == "1"
    assert json.loads(tb) == json.loads(jb)
    assert json.loads(tb)["error"] == {"message": "batch queue is full (0/0)", "type": "rate_limit_error",
                                       "code": "queue_full"}


def test_deadlines_and_cached_tokens_as_the_reference(servers):
    """An interactive request with a 30 s deadline completes; an expired
    deadline ends with "deadline"; a repeated long prompt reports the prefix
    cache's tokens in ``usage`` (non-stream and the stream's usage chunk)."""
    base_msgs = [{"role": "user", "content": "a long shared question about paged attention " * 2}]
    results = []
    for base in servers:
        out = []
        status, _, body = _post(base, {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
                                       "temperature": 0}, {"x-mtpu-priority": "interactive",
                                                           "x-mtpu-deadline-ms": "30000"})
        out.append((status, json.loads(body)["choices"][0]["finish_reason"]))
        status, _, body = _post(base, {"messages": [{"role": "user", "content": "late"}], "max_tokens": 4,
                                       "deadline_ms": 0})
        out.append((status, json.loads(body)["choices"][0]["finish_reason"]))
        for _ in range(2):
            status, _, body = _post(base, {"messages": base_msgs, "max_tokens": 3, "temperature": 0})
            usage = json.loads(body)["usage"]
            out.append((status, usage["prompt_tokens"], usage["prompt_tokens_details"]))
        status, _, body = _post(base, {"messages": base_msgs, "max_tokens": 3, "temperature": 0, "stream": True,
                                       "stream_options": {"include_usage": True}})
        usage = json.loads([e for e in body.split("\n\n") if e][-2][len("data: "):])["usage"]
        out.append((status, usage["prompt_tokens"], usage["prompt_tokens_details"]))
        results.append(out)
    assert results[1] == results[0]
    out = results[1]
    assert out[0] == (200, "length") and out[1] == (200, "deadline")
    n_prompt = out[2][1]
    cached = (n_prompt // ENGINE_KW["page_size"]) * ENGINE_KW["page_size"]
    assert out[2][2] == {"cached_tokens": 0} and out[3][2] == out[4][2] == {"cached_tokens": cached} and cached > 0
