"""The port's chaos runner (``faults/chaos.py``) against the JAX package's:

- the invariant checkers give the reference's verdicts on handed violating
  (and clean) states;
- the episode schedule is the reference's: names, fault specs and traffic;
- one seeded ``run_chaos(seed=0, device="cpu")`` over the port's fleet (a
  unified replica and a prefill/decode pair of tiny engines behind a
  ``DisaggCoordinator``, the unified and prefill replicas over one shared
  prefix store, the gray-failure watchdog over all, and the executor
  episode's containers) fires every point of the port's fault catalog, and
  every fleet invariant holds after every episode: zero wedged requests,
  queues, slots, reservations and pages drained, conservation, the router
  recovered, and fault-free outputs token-identical. The run is strict: a
  violated invariant raises inside the fixture. Its journal, metrics, the
  ``chaos`` subcommand and the gateway's ``/chaos`` render it afterwards.
"""

import json
from types import SimpleNamespace

import pytest

import modal_examples_tpu.faults.chaos as jchaos
import modal_examples_tpu_torch.faults.chaos as tchaos
from modal_examples_tpu.faults.inject import ALL_FAULT_POINTS as JAX_POINTS
from modal_examples_tpu_torch.faults.inject import ALL_FAULT_POINTS
from modal_examples_tpu_torch.observability import catalog as C
from modal_examples_tpu_torch.utils.prometheus import default_registry
from test_torch_time_limit import share_cores, thread_guard, time_limits

share_cores()

_limit_module, _limit_test = time_limits(test_s=120, module_s=300)
_threads = thread_guard(grace_s=30.0)


# -- the checkers -----------------------------------------------------------------

RESULTS = {
    "clean": [{"id": "a", "prompt": "p", "output": "xy", "finish_reason": "stop", "wedged": False}],
    "wedged": [{"id": "a", "prompt": "p", "output": "", "finish_reason": None, "wedged": True}],
    "no-reason": [{"id": "b", "prompt": "p", "output": "x", "finish_reason": None, "wedged": False}],
    "diverged": [{"id": "c", "prompt": "p", "output": "zz", "finish_reason": "length", "wedged": False}],
    "aborted": [{"id": "d", "prompt": "p", "output": "z", "finish_reason": "stop", "wedged": False,
                 "aborted": True}],
    "error-exempt": [{"id": "e", "prompt": "p", "output": "", "finish_reason": "error", "wedged": False}],
}


@pytest.mark.parametrize("case", list(RESULTS))
def test_terminal_and_token_identity_verdicts_equal_the_reference(case):
    results, reference = RESULTS[case], {"p": "xy"}
    assert tchaos.check_terminal(results) == jchaos.check_terminal(results)
    assert tchaos.check_token_identity(results, reference) == jchaos.check_token_identity(results, reference)
    bad = tchaos.check_terminal(results) + tchaos.check_token_identity(results, reference)
    assert bool(bad) == (case in ("wedged", "no-reason", "diverged"))


@pytest.mark.parametrize("counts", [(3, 2, 1), (3, 2, 0), (0, 0, 0), (2, 3, 0)])
def test_conservation_verdicts_equal_the_reference(counts):
    assert tchaos.check_conservation(*counts) == jchaos.check_conservation(*counts)
    assert bool(tchaos.check_conservation(*counts)) == (counts[0] != counts[1] + counts[2])


def _engine(*, depth=0, busy=0, reserved=0, available=7, cached=0, prefix=True):
    return SimpleNamespace(
        policy=SimpleNamespace(total_depth=lambda: depth),
        slots=[SimpleNamespace(free=i >= busy) for i in range(2)],
        admission=SimpleNamespace(reserved_pages=reserved),
        cache=SimpleNamespace(n_pages=8, allocator=SimpleNamespace(available=available)),
        prefix_cache=SimpleNamespace(cached_pages=cached) if prefix else None,
    )


ENGINES = {
    "drained": {"e": _engine()},
    "warm-trie": {"e": _engine(available=4, cached=3)},
    "queued": {"e": _engine(depth=2)},
    "busy-slot": {"e": _engine(busy=1)},
    "reserved": {"e": _engine(reserved=5)},
    "orphaned": {"e": _engine(available=5, cached=1)},
    "no-trie-leak": {"e": _engine(available=6, prefix=False)},
    "several": {"a": _engine(depth=1, busy=2), "b": _engine(reserved=1, available=3)},
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_drain_verdicts_equal_the_reference(case):
    engines = ENGINES[case]
    assert tchaos.check_drained(engines) == jchaos.check_drained(engines)
    assert bool(tchaos.check_drained(engines)) == (case not in ("drained", "warm-trie"))


@pytest.mark.parametrize("replicas", [
    {"a": {"down": False, "healthy": True}},
    {"a": {"down": True, "healthy": True}, "b": {"down": False, "healthy": False}},
    {"a": {"down": False, "healthy": True}, "b": {"down": True, "healthy": False}},
])
def test_router_verdicts_equal_the_reference(replicas):
    router = SimpleNamespace(stats=lambda: {"replicas": replicas})
    assert tchaos.check_router_recovered(router) == jchaos.check_router_recovered(router)
    assert tchaos.settle_recovered(router, timeout=0.0) == jchaos.settle_recovered(router, timeout=0.0)


def test_the_episode_schedule_is_the_reference():
    assert [e[0] for e in tchaos.EPISODES] == [e[0] for e in jchaos.EPISODES]
    assert tchaos.EPISODES == jchaos.EPISODES
    assert tchaos._PROMPTS == jchaos._PROMPTS and tchaos.DRAIN_TIMEOUT_S == jchaos.DRAIN_TIMEOUT_S
    armed = {p for _, spec, _ in tchaos.EPISODES for p in spec}
    assert armed | {"executor.container_death", "executor.timeout"} == ALL_FAULT_POINTS == JAX_POINTS


# -- one seeded run ------------------------------------------------------------------


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """The seeded run, over a state directory of its own: the tests' shared
    one takes the JAX chaos run's journal when another worker runs it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MTPU_STATE_DIR", str(tmp_path_factory.mktemp("chaos-state")))
        # strict: any invariant violation raises here and fails every test below
        yield tchaos.run_chaos(seed=0, device="cpu", strict=True)


def test_every_fault_point_of_the_catalog_fires(report):
    assert report["points_missed"] == []
    assert set(report["points_fired"]) == set(ALL_FAULT_POINTS)
    assert report["injected_total"] >= len(ALL_FAULT_POINTS)


def test_zero_wedged_and_every_invariant_holds(report):
    assert report["wedged"] == 0 and report["invariants"] == "ok"
    names = [ep["episode"] for ep in report["episodes"]]
    assert names == [e[0] for e in tchaos.EPISODES] + ["executor-retry"]
    for ep in report["episodes"]:
        assert ep["invariants"] == "ok" and ep["wedged"] == 0, ep
        assert sum(ep["finished"].values()) + ep["shed"] > 0, ep


def test_faults_are_recovered_not_just_survived(report):
    assert report["recovered"] >= len(report["episodes"])
    for ep in report["episodes"]:
        assert ep["injected"], ep["episode"]


def test_router_readmission_and_the_injected_metric(report):
    assert default_registry.total(C.ROUTER_READMISSIONS_TOTAL) >= 1
    counted = {lbl.get("point"): v for lbl, v in default_registry.series(C.FAULTS_INJECTED_TOTAL)}
    for point, n in report["injected"].items():
        assert counted.get(point, 0) >= n, (point, counted)


def test_the_journal_the_cli_and_the_gateway_render_the_run(report, tmp_path):
    from modal_examples_tpu_torch.core import cli
    from modal_examples_tpu_torch.observability.journal import named_journal
    from modal_examples_tpu_torch.web.gateway import _chaos_snapshot

    episodes = named_journal("chaos").tail(len(report["episodes"]))
    assert [e["episode"] for e in episodes] == [e["episode"] for e in report["episodes"]]
    assert all(json.dumps(e) for e in episodes)
    snap = _chaos_snapshot(last=len(report["episodes"]))
    assert snap["wedged"] == 0 and snap["injected_total"] >= report["injected_total"]
    assert [e["episode"] for e in snap["episodes"]] == [e["episode"] for e in report["episodes"]]
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["chaos", "--last", str(len(report["episodes"]))]) == 0
    text = out.getvalue()
    assert "prefix-store-owner-death" in text and "VIOLATED" not in text
    for point in ALL_FAULT_POINTS:
        assert point in text


def test_a_probe_of_an_engine_stopped_on_error_leaves_nothing_queued():
    """The departure behind the JAX chaos run's canary-episode flake (ROADMAP
    §C): under CPU load the watchdog error-stops a replica while the clean
    canary round probes it; each probe's submit queues a request before its
    stream finds the engine poisoned, and the JAX package leaves those
    requests queued. At revival they decode unread, and the first one takes
    the armed token corruption meant for the next round, which then passes.
    The port's probe aborts a request whose stream failed after its submit."""
    from modal_examples_tpu.models import llama as jllama
    from modal_examples_tpu.observability import canary as jcanary
    from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
    from modal_examples_tpu_torch import LLMEngine
    from modal_examples_tpu_torch.models import llama as tllama
    from modal_examples_tpu_torch.observability import canary as tcanary

    kw = dict(max_slots=2, max_model_len=64, page_size=8, prefill_buckets=(32,), seed=0)
    jeng = JaxEngine(jllama.LlamaConfig.tiny(), **kw)
    teng = LLMEngine(tllama.LlamaConfig.tiny(), device="cpu", **kw)
    try:
        for eng in (jeng, teng):
            eng.stop(reason="error")
        jres = jcanary.probe_engine(jeng, golden=None)
        tres = tcanary.probe_engine(teng, golden=None)
        assert [r["result"] for r in tres] == [r["result"] for r in jres] == ["error"] * len(tcanary.GOLDEN_SET)
        assert jeng.policy.total_depth() == len(jcanary.GOLDEN_SET)  # the reference's orphans
        assert teng.policy.total_depth() == 0 and teng.admission.reserved_pages == 0
        teng.revive().start()
        assert teng.generate("after revival", None) is not None
        assert teng.stats.prompt_tokens == len(teng.make_request("after revival", trace=None).prompt_tokens)
    finally:
        jeng.stop()
        teng.stop()
