"""The port's serverless runtime held against the JAX package's: one app
program, written once per package into a temporary directory (a module-level
file that imports only that package), driven through both runtimes' real
container processes. Results, exception types and messages, retries,
timeouts, batching, concurrency, Cls lifecycle, the executor's metric series
and the autoscaler journal must match. Mirrors ``tests/test_runtime.py``.
"""

import asyncio
import contextlib
import os
import time
from pathlib import Path

import pytest

from modal_examples_tpu.core import app as japp
from modal_examples_tpu.core.executor import FunctionTimeoutError as JTimeout
from modal_examples_tpu.core.serialization import RemoteError as JRemoteError
from modal_examples_tpu.observability import catalog as JC
from modal_examples_tpu.observability.journal import default_journal as jjournal
from modal_examples_tpu.utils.prometheus import default_registry as jreg
from modal_examples_tpu_torch.core import app as papp
from modal_examples_tpu_torch.core.executor import FunctionTimeoutError as PTimeout
from modal_examples_tpu_torch.core.serialization import RemoteError as PRemoteError
from modal_examples_tpu_torch.observability import catalog as PC
from modal_examples_tpu_torch.observability.journal import default_journal as pjournal
from modal_examples_tpu_torch.utils.prometheus import default_registry as preg

PROGRAM = '''
import os
import time

import @PKG@ as mtpu

app = mtpu.App("@NAME@")
#: a second app for the lifecycle test: its run context opens and closes
#: inside one test
life = mtpu.App("@NAME@-life")


@app.function(timeout=30)
def square(x: int) -> int:
    return x * x


@app.function(timeout=30)
def fail_always(msg: str):
    raise ValueError(msg)


class TwoArgError(Exception):
    """Pickles but does not unpickle: the container sends a RemoteError."""

    def __init__(self, msg, code):
        super().__init__(msg)
        self.code = code


@app.function(timeout=30)
def fail_unpicklable():
    raise TwoArgError("odd", 2)


@app.function(timeout=30)
def countdown(n: int):
    for i in range(n, 0, -1):
        yield i


@app.function(timeout=30)
def add(a, b):
    return a + b


@app.function(timeout=30)
def maybe_fail(x):
    if x == 1:
        raise RuntimeError("nope")
    return x


@app.function(timeout=30, retries=mtpu.Retries(max_retries=3, initial_delay=0.0))
def flaky(path: str):
    with open(path, "a") as f:
        f.write("x")
    if os.path.getsize(path) < 2:
        raise RuntimeError("transient")
    return "recovered"


@app.function(timeout=30, retries=mtpu.Retries(max_retries=2, initial_delay=0.0))
def always_bad():
    raise ValueError("permanent")


@app.function(timeout=30, retries=mtpu.Retries(max_retries=2, initial_delay=0.0))
def steady(x: int) -> int:
    return x


@app.function(timeout=2)
def sleeper(seconds: float):
    time.sleep(seconds)
    return "done"


@app.function(timeout=30)
@mtpu.batched(max_batch_size=4, wait_ms=100)
def batch_sizes(xs: list) -> list:
    return [(x * 2, len(xs)) for x in xs]


@app.function(timeout=30)
@mtpu.concurrent(max_inputs=4)
def slow_echo(x):
    start = time.monotonic()
    time.sleep(0.4)
    return x, start, time.monotonic()


@app.function(timeout=30)
def whoami() -> str:
    return os.environ.get("MTPU_TASK_ID", "")


@app.function(timeout=30)
def counted(x: int) -> int:
    return x + 1


@app.function(timeout=60, max_containers=3)
def slow_id(x):
    time.sleep(0.2)
    return x


@app.function(timeout=30, scaledown_window=0.4)
def ping() -> str:
    return "pong"


@app.function(timeout=60, single_use_containers=True, max_containers=4)
def task_of(_x) -> str:
    return os.environ["MTPU_TASK_ID"]


@app.function(timeout=30)
def where() -> str:
    return os.environ.get("MTPU_TASK_ID", "the caller")


@app.cls(timeout=30)
class CrashAtBoot:
    @mtpu.enter()
    def setup(self):
        os._exit(3)  # the container dies before it is ready, every boot

    @mtpu.method()
    def f(self):
        return 1


@app.cls(timeout=30)
class Counter:
    base: int = mtpu.parameter(default=100)

    @mtpu.enter()
    def setup(self):
        self.loaded = True
        self.count = 0

    @mtpu.method()
    def add(self, x: int) -> int:
        assert self.loaded
        self.count += x
        return self.base + self.count

    @mtpu.method()
    def stream(self, n: int):
        for i in range(n):
            yield i


@life.cls(timeout=30)
class Lifecycle:
    mark: str = mtpu.parameter(default="")

    @mtpu.enter()
    def setup(self):
        self.entered = time.time()

    @mtpu.method()
    def entered_at(self) -> float:
        return self.entered

    @mtpu.exit()
    def teardown(self):
        with open(self.mark, "w") as f:
            f.write("exited")
'''


def write_program(root: Path, pkg: str, name: str) -> Path:
    path = root / f"{name.replace('-', '_')}_app.py"
    path.write_text(PROGRAM.replace("@PKG@", pkg).replace("@NAME@", name))
    return path


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(jax module, port module), each app's run context open."""
    root = tmp_path_factory.mktemp("platform-apps")
    jmod = japp.load_module_from_path(str(write_program(root, "modal_examples_tpu", "jax-parity")))
    pmod = papp.load_module_from_path(str(write_program(root, "modal_examples_tpu_torch", "port-parity")))
    with contextlib.ExitStack() as stack:
        stack.enter_context(jmod.app.run())
        stack.enter_context(pmod.app.run())
        yield jmod, pmod


def same(both, fn):
    """``fn(module)`` through both packages; the two results, equal."""
    j, p = (fn(m) for m in both)
    assert j == p
    return p


def raised(fn, mod):
    with pytest.raises(BaseException) as info:
        fn(mod)
    return info.value


class TestInvocationModes:
    def test_local(self, both):
        assert same(both, lambda m: m.square.local(7)) == 49

    def test_remote(self, both):
        assert same(both, lambda m: m.square.remote(9)) == 81

    def test_remote_runs_in_container(self, both):
        for m in both:
            task_id = m.whoami.remote()
            assert task_id.startswith("ta-") and task_id != os.environ.get("MTPU_TASK_ID", "")

    def test_map_ordered(self, both):
        assert same(both, lambda m: list(m.square.map(range(6)))) == [0, 1, 4, 9, 16, 25]

    def test_map_unordered_same_set(self, both):
        assert same(both, lambda m: sorted(m.square.map(range(6), order_outputs=False))) == [0, 1, 4, 9, 16, 25]

    def test_starmap(self, both):
        assert same(both, lambda m: list(m.add.starmap([(1, 2), (3, 4)]))) == [3, 7]

    def test_spawn_get_and_gather(self, both):
        def go(m):
            c1, c2 = m.square.spawn(3), m.square.spawn(4)
            return c1.get(timeout=20), m.mtpu.gather(c1, c2)

        assert same(both, go) == (9, [9, 16])

    def test_functioncall_from_id(self, both):
        def go(m):
            call = m.square.spawn(5)
            return m.mtpu.FunctionCall.from_id(call.object_id).get(timeout=20)

        assert same(both, go) == 25

    def test_remote_gen(self, both):
        assert same(both, lambda m: list(m.countdown.remote_gen(3))) == [3, 2, 1]

    def test_for_each(self, both):
        assert same(both, lambda m: m.square.for_each(range(3))) is None

    def test_aio_remote(self, both):
        async def go(m):
            return await m.square.remote.aio(6)

        assert same(both, lambda m: asyncio.run(go(m))) == 36

    def test_aio_map(self, both):
        async def go(m):
            return [x async for x in m.square.map.aio(range(4))]

        assert same(both, lambda m: asyncio.run(go(m))) == [0, 1, 4, 9]


class TestErrors:
    def test_exceptions_propagate_with_traceback(self, both):
        j, p = (raised(lambda m: m.fail_always.remote("boom"), m) for m in both)
        assert type(j) is type(p) is ValueError and str(j) == str(p) == "boom"

    def test_unpicklable_exception_is_a_remote_error(self, both):
        j, p = (raised(lambda m: m.fail_unpicklable.remote(), m) for m in both)
        assert isinstance(j, JRemoteError) and isinstance(p, PRemoteError)
        assert j.args == p.args == ("TwoArgError: odd",)
        assert "TwoArgError: odd" in j.remote_traceback and "TwoArgError: odd" in p.remote_traceback

    def test_map_return_exceptions(self, both):
        j, p = (list(m.maybe_fail.map([0, 1, 2], return_exceptions=True)) for m in both)
        assert [j[0], j[2]] == [p[0], p[2]] == [0, 2]
        assert type(j[1]) is type(p[1]) is RuntimeError and str(j[1]) == str(p[1]) == "nope"


class TestFaultTolerance:
    def test_retries_recover(self, both, tmp_path):
        def go(m):
            path = tmp_path / f"{m.app.name}-attempts"
            return m.flaky.remote(str(path)), os.path.getsize(path)

        assert same(both, go) == ("recovered", 2)

    def test_retry_exhaustion_counts_every_attempt(self, both):
        def go(m, reg, C):
            tag = m.always_bad.spec.tag
            r0 = reg.value(C.RETRIES_TOTAL, labels={"function": tag, "reason": "user_error"})
            err = raised(lambda mod: mod.always_bad.remote(), m)
            return type(err), str(err), reg.value(C.RETRIES_TOTAL, labels={"function": tag, "reason": "user_error"}) - r0

        j, p = go(both[0], jreg, JC), go(both[1], preg, PC)
        assert j == p == (ValueError, "permanent", 2.0)

    @pytest.mark.parametrize("point,reason", [("executor.container_death", "container_death"),
                                              ("executor.timeout", "timeout")])
    def test_injected_fault_is_retried(self, both, point, reason):
        from modal_examples_tpu.faults import inject as jinject
        from modal_examples_tpu_torch.faults import inject as pinject

        def go(m, inject, reg, C):
            tag = m.steady.spec.tag
            r0 = reg.value(C.RETRIES_TOTAL, labels={"function": tag, "reason": reason})
            f0 = reg.value(C.FAULTS_INJECTED_TOTAL, labels={"point": point})
            with inject.active(inject.FaultPlan({point: {"on_hit": 1}}, seed=0)) as plan:
                out = m.steady.remote(7)
                # the point is reached on every dispatch pass, also while no
                # container is ready yet: the count follows boot time
                assert plan.hits()[point] >= 2
            return (out, reg.value(C.RETRIES_TOTAL, labels={"function": tag, "reason": reason}) - r0,
                    reg.value(C.FAULTS_INJECTED_TOTAL, labels={"point": point}) - f0)

        j = go(both[0], jinject, jreg, JC)
        p = go(both[1], pinject, preg, PC)
        assert j == p == (7, 1.0, 1.0)

    def test_timeout_kills_input(self, both):
        j, p = (raised(lambda m: m.sleeper.remote(10), m) for m in both)
        assert isinstance(j, JTimeout) and isinstance(p, PTimeout)
        assert str(j).replace("jax-parity", "") == str(p).replace("port-parity", "")

    def test_fast_input_within_timeout(self, both):
        assert same(both, lambda m: m.sleeper.remote(0.01)) == "done"


class TestContainers:
    def test_single_use_containers_fresh_each_input(self, both):
        for m in both:
            assert len(set(m.task_of.map(range(3)))) == 3

    def test_inline_backend_runs_in_the_caller(self, both, monkeypatch):
        monkeypatch.setenv("MTPU_BACKEND", "inline")  # read when the pool is made
        assert same(both, lambda m: m.where.remote()) == "the caller"

    def test_crash_loop_breaker(self, both):
        j, p = (raised(lambda m: m.CrashAtBoot().f.remote(), m) for m in both)
        assert type(j) is type(p) is RuntimeError
        assert str(j).replace("jax-parity", "") == str(p).replace("port-parity", "")
        assert "crash-looping at boot (3 consecutive failures)" in str(p)


class TestBatching:
    def test_batched_groups_inputs(self, both):
        for m in both:
            out = list(m.batch_sizes.map(range(8)))
            assert [x for x, _ in out] == [2 * i for i in range(8)]
            assert all(1 <= n <= 4 for _, n in out) and max(n for _, n in out) > 1


class TestConcurrency:
    def test_concurrent_inputs_overlap(self, both):
        for m in both:
            out = list(m.slow_echo.map(range(4)))
            assert sorted(x for x, _, _ in out) == [0, 1, 2, 3]
            intervals = [(s, e) for _, s, e in out]
            assert any(
                a_s < b_e and b_s < a_e
                for i, (a_s, a_e) in enumerate(intervals) for b_s, b_e in intervals[i + 1:]
            ), intervals


class TestCls:
    def test_lifecycle_and_state(self, both):
        def go(m):
            c = m.Counter()
            return c.add.remote(5), c.add.remote(5)

        assert same(both, go) == (105, 110)

    def test_parameters(self, both):
        assert same(both, lambda m: m.Counter(base=1000).add.remote(1)) == 1001

    def test_unknown_parameter_rejected(self, both):
        j, p = (raised(lambda m: m.Counter(nope=1), m) for m in both)
        assert type(j) is type(p) is TypeError and str(j) == str(p)

    def test_local_instance_runs_enter(self, both):
        assert same(both, lambda m: m.Counter().add.local(2)) == 102

    def test_method_generator(self, both):
        assert same(both, lambda m: list(m.Counter().stream.remote(4))) == [0, 1, 2, 3]

    def test_with_options(self, both):
        assert same(both, lambda m: m.Counter.with_options(max_containers=2)._spec.max_containers) == 2

    def test_cls_from_name(self, both):
        for m in both:
            assert m.mtpu.Cls.from_name(m.app.name, "Counter") is m.Counter

    def test_enter_once_and_exit_at_close(self, both, tmp_path):
        def go(m):
            mark = tmp_path / f"{m.app.name}-exit"
            with m.life.run():
                obj = m.Lifecycle(mark=str(mark))
                first, again = obj.entered_at.remote(), obj.entered_at.remote()
                assert not mark.exists()
            return first == again, mark.read_text()

        assert same(both, go) == (True, "exited")


class TestObservability:
    @staticmethod
    def _series(reg, names, prefix):
        """{(name, labels with the app prefix cut): value} of ``names``."""
        out = {}
        for name in names:
            for labels, v in reg.series(name):
                if labels.get("function", "").startswith(prefix):
                    labels = {**labels, "function": labels["function"][len(prefix):]}
                    out[(name, tuple(sorted(labels.items())))] = v
        return out

    def test_series_after_the_same_program(self, both):
        """Three sequential calls of one function: the same call-lifecycle
        series, with the same values, in both registries."""
        for m in both:
            assert [m.counted.remote(i) for i in range(3)] == [1, 2, 3]
        names = ("CALL_DURATION_SECONDS", "QUEUE_WAIT_SECONDS", "INFLIGHT_INPUTS", "SCALER_DECISIONS_TOTAL")
        j = self._series(jreg, [getattr(JC, n) for n in names], "jax-parity.counted")
        p = self._series(preg, [getattr(PC, n) for n in names], "port-parity.counted")
        assert j == p
        assert p[(PC.CALL_DURATION_SECONDS, (("function", ""), ("phase", "total")))] == 3
        assert p[(PC.INFLIGHT_INPUTS, (("function", ""),))] == 0

    def test_catalog_entries_are_the_references(self):
        for name in ("CALL_DURATION_SECONDS", "QUEUE_WAIT_SECONDS", "INFLIGHT_INPUTS", "RETRIES_TOTAL",
                     "CONTAINER_KILLS_TOTAL", "HOST_RSS_BYTES", "SCALER_DECISIONS_TOTAL", "FAULTS_INJECTED_TOTAL"):
            assert getattr(PC, name) == getattr(JC, name)
            assert PC.CATALOG[getattr(PC, name)] == JC.CATALOG[getattr(JC, name)]

    def test_call_trace_spans(self, both):
        """A spawned call's trace: the same span names, parents and statuses."""
        from modal_examples_tpu.observability.trace import default_store as jstore
        from modal_examples_tpu_torch.observability.trace import default_store as pstore

        def shape(m, store):
            call = m.square.spawn(2)
            assert call.get(timeout=20) == 4
            spans = store.read(call.call_id)
            names = {s["span_id"]: s["name"] for s in spans}
            return sorted((s["name"], names.get(s.get("parent_id")), s["status"]) for s in spans)

        assert shape(both[0], jstore) == shape(both[1], pstore)


class TestAutoscalerJournal:
    @staticmethod
    def _kinds(journal, tag, wait_for=None):
        deadline = time.monotonic() + 20
        while True:
            recs = journal.tail(500, function=tag)
            kinds = sorted({(r["action"], r["trigger"]) for r in recs})
            if wait_for is None or wait_for in kinds or time.monotonic() > deadline:
                return kinds, recs
            time.sleep(0.1)

    def test_queue_pressure_scale_up_is_journaled(self, both):
        out = []
        for m, journal in zip(both, (jjournal, pjournal)):
            assert sorted(m.slow_id.map(range(6))) == list(range(6))
            kinds, recs = self._kinds(journal, m.slow_id.spec.tag)
            first = [r for r in recs if r["action"] == "scale_up"][0]
            assert first["containers_after"] > first["containers_before"] and first["spawned"] >= 1
            out.append([k for k in kinds if k[0] == "scale_up"])
        assert out[0] == out[1] == [("scale_up", "queue_pressure")]

    def test_scaledown_window_reap_is_journaled(self, both):
        out = []
        for m, journal in zip(both, (jjournal, pjournal)):
            assert m.ping.remote() == "pong"
            kinds, recs = self._kinds(journal, m.ping.spec.tag, wait_for=("scale_down", "idle"))
            down = [r for r in recs if r["action"] == "scale_down"][0]
            assert down["idle_ages_s"][0] >= 0.4 and down["scaledown_window_s"] == pytest.approx(0.4)
            out.append(kinds)
        assert out[0] == out[1] == [("scale_down", "idle"), ("scale_up", "queue_pressure")]


class TestAppRegistry:
    def test_registered_functions(self, both):
        for m in both:
            assert "square" in m.app.registered_functions

    def test_lookup_in_process(self, both):
        for m in both:
            assert m.mtpu.App.lookup(m.app.name) is m.app
