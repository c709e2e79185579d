"""The port's gray-failure health layer (``serving/health.py``) against the
JAX package's, on the same fake-clock sequences and the same duck-typed
replicas: watermark snapshots, the transfer registry, the policy's
validation, ``progress_age``/``classify`` over a grid of snapshots, the
monitor's hysteresis and quarantine window, and the watchdog's whole ladder
(degraded, restore, wedged stop, quarantine, unquarantine, a stalled
transfer's abort, a removed replica forgotten) with its journal, its metric
series (``decode_watchdog_series``) and its router-weight calls; then the
port engine's own watermarks and the queue-age watermark of its policies.
"""

import itertools

import pytest

import modal_examples_tpu.serving.health as jh
import modal_examples_tpu_torch.serving.health as th
from modal_examples_tpu.scheduling import policy as jpolicy
from modal_examples_tpu.utils import prometheus as jprom
from modal_examples_tpu_torch.scheduling import policy as tpolicy
from modal_examples_tpu_torch.utils import prometheus as tprom
from test_torch_time_limit import share_cores, time_limits

share_cores()

_limit_module, _limit_test = time_limits(test_s=60, module_s=120)

MODULES = {"jax": (jh, jprom, jpolicy), "torch": (th, tprom, tpolicy)}


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def state(tmp_path, monkeypatch):
    root = tmp_path / "state"
    root.mkdir()
    monkeypatch.setenv("MTPU_STATE_DIR", str(root))
    return root


def test_engine_watermarks_as_the_jax_package():
    runs = []
    for h, _, _ in MODULES.values():
        clock = Clock()
        wm = h.EngineWatermarks(clock=clock)
        out = [wm.snapshot()]
        for step, note in enumerate(["note_tick", "note_dispatch", "note_accept", "note_tick", "note_start",
                                     "note_dispatch", "note_tick"]):
            clock.t += 0.25 * (step + 1)
            getattr(wm, note)()
            clock.t += 0.1
            out.append(wm.snapshot())
        out.append(wm.snapshot(now=clock.t + 5))
        runs.append(out)
    assert runs[1] == runs[0]
    assert runs[1][5]["dispatch_age"] is None and runs[1][-1]["tick_seq"] == 3


def test_transfer_registry_as_the_jax_package():
    runs = []
    for h, _, _ in MODULES.values():
        clock = Clock()
        reg = h.TransferWatermarks(clock=clock)
        reg.begin("a")
        reg.begin("b")
        clock.t += 3
        reg.progress("a", 4)
        clock.t += 3
        out = [reg.stalled(5.0), reg.request_abort("b"), reg.request_abort("b"), reg.abort_requested("b"),
               reg.stalled(1.0), reg.snapshot()]
        reg.end("b")
        reg.progress("b", 9)  # ended: ignored
        out += [reg.snapshot(), reg.request_abort("zz")]
        runs.append(out)
    assert runs[1] == runs[0]


@pytest.mark.parametrize("kw", [{}, {"degraded_after_s": 3.0, "wedged_after_s": 2.0}, {"degraded_after_s": 0.0},
                                {"degraded_weight": 0.0}, {"degraded_weight": 1.5}])
def test_policy_defaults_and_validation_as_the_jax_package(kw):
    got = []
    for h, _, _ in MODULES.values():
        try:
            got.append(vars(h.WatchdogPolicy(**kw)))
        except ValueError as e:
            got.append(str(e))
    assert got[1] == got[0]


def _snapshots():
    for outstanding, decodable, tick, dispatch, accept, qh in itertools.product(
        (0, 3), (0, 2), (0.5, 2.5, 12.0), (None, 1.0, 3.0, 11.0), (None, 0.2, 2.1), (None, 4.0, 10.5)
    ):
        yield {"outstanding": outstanding, "decodable": decodable, "tick_age": tick, "dispatch_age": dispatch,
               "accept_age": accept, "queue_head_age": qh}


def test_progress_age_and_classify_as_the_jax_package():
    jp, tp = jh.WatchdogPolicy(), th.WatchdogPolicy()
    seen = set()
    for snap in _snapshots():
        assert th.progress_age(snap) == jh.progress_age(snap)
        assert th.classify(snap, tp) == jh.classify(snap, jp)
        seen.add(th.classify(snap, tp))
    assert seen == {"healthy", "degraded", "wedged"}


def test_monitor_hysteresis_and_quarantine_window_as_the_jax_package():
    raws = ["healthy", "degraded", "healthy", "degraded", "healthy", "healthy", "wedged", "degraded", "healthy",
            "healthy", "healthy", "wedged", "healthy", "healthy"]
    runs = []
    for h, _, _ in MODULES.values():
        mon = h.ReplicaMonitor("r0", h.WatchdogPolicy(wedge_window_s=50.0))
        out = []
        for i, raw in enumerate(raws):
            out.append((mon.observe(raw, now=10.0 * i), mon.wedges_in_window(10.0 * i)))
        mon.reset()
        out.append((mon.state, list(mon.wedge_times)))
        runs.append(out)
    assert runs[1] == runs[0]
    assert ("wedged", True) in [o[0] for o in runs[1]]


# -- the watchdog over duck-typed replicas ------------------------------------------


class Req:
    def __init__(self, rid: str, clock: Clock):
        self.request_id = rid
        self.last_token_at = clock.t
        self.generated_tokens = [1, 2]
        self.trace = None


class Slot:
    def __init__(self, req=None, decodable=True):
        self.request = req
        self.decodable = decodable


class Engine:
    def __init__(self, h, clock: Clock, polmod):
        self._clock = clock
        self.watermarks = h.EngineWatermarks(clock=clock)
        self._running = True
        self.slots = [Slot(), Slot()]
        self.policy = polmod.FIFOPolicy(clock=clock)
        self._trace_store = None
        self.stops = []

    def stop(self, *, reason="stop"):
        self.stops.append(reason)
        self._running = False


class Replica:
    serves_requests = True

    def __init__(self, name, engine):
        self.name = name
        self.engine = engine
        self.health_state = "healthy"
        self.quarantined = False

    def outstanding(self) -> int:
        return sum(1 for s in self.engine.slots if s.request is not None) + self.engine.policy.total_depth()


class Router:
    def __init__(self, replicas):
        self.replicas = replicas
        self.weights = []

    def set_health_weight(self, name, w):
        self.weights.append((name, w))


def _drive(h, prom, polmod, tmp_path, tag: str) -> dict:
    """One scripted timeline: r0 busy and progressing, then stalled (degraded,
    wedged: stopped), revived and wedged again (quarantined), unquarantined;
    r1 idle throughout; a transfer that stalls; r1 removed at the end."""
    clock = Clock()
    engines = [Engine(h, clock, polmod) for _ in range(2)]
    reps = [Replica(f"r{i}", e) for i, e in enumerate(engines)]
    router = Router(list(reps))
    reg = prom.Registry()
    transfers = h.TransferWatermarks(clock=clock)
    wd = h.FleetWatchdog(router, clock=clock, journal_path=tmp_path / f"{tag}.jsonl", transfer_watermarks=transfers,
                         registry=reg, policy=h.WatchdogPolicy(quarantine_s=20.0))
    e0 = engines[0]
    e0.slots[0].request = Req("req-a", clock)
    actions = []

    def poll(dt: float, progress: bool) -> None:
        clock.t += dt
        if progress:
            e0.watermarks.note_tick()
            e0.watermarks.note_dispatch()
            e0.watermarks.note_accept()
        actions.append([{k: v for k, v in a.items() if k != "at"} for a in wd.poll_once()])

    poll(0.5, True)
    transfers.begin("req-t")
    for _ in range(5):
        poll(1.0, False)  # degraded at 2 s, the transfer aborted at 5 s
    poll(0.5, True)
    poll(0.5, True)  # two healthy observations: restored
    for _ in range(11):
        poll(1.0, False)  # wedged: error-stopped
    e0._running = True  # the router's probe revived it
    e0.watermarks.note_start()
    poll(0.5, True)
    for _ in range(11):
        poll(1.0, False)  # wedged again inside the window: quarantined
    e0._running = True
    e0.watermarks.note_start()
    poll(5.0, True)  # still quarantined
    poll(20.0, True)  # unquarantined
    router.replicas = [reps[0]]
    poll(0.5, True)  # r1 forgotten
    return {
        "actions": actions,
        "weights": router.weights,
        "stops": e0.stops,
        "quarantined": reps[0].quarantined,
        "series": h.decode_watchdog_series(reg),
        "journal": [{k: v for k, v in r.items() if k != "at"} for r in wd.journal.tail(100)],
        "stats": {k: v for k, v in wd.stats().items() if k != "events"},
    }


def test_the_watchdog_ladder_as_the_jax_package(state, tmp_path):
    runs = {name: _drive(*mods, tmp_path, name) for name, mods in MODULES.items()}
    assert runs["torch"] == runs["jax"]
    flat = [a["action"] for acts in runs["torch"]["actions"] for a in acts]
    assert {"down_weight", "restore_weight", "abort_transfer", "stop_revive", "quarantine", "unquarantine"} <= set(flat)
    assert runs["torch"]["stops"] == ["error", "error"]
    assert list(runs["torch"]["stats"]["replicas"]) == ["r0"]


def test_replica_snapshot_as_the_jax_package():
    snaps = []
    for h, _, polmod in MODULES.values():
        clock = Clock()
        e = Engine(h, clock, polmod)
        e.slots[1].request = Req("req-b", clock)
        e.slots[1].decodable = False
        e.policy.submit(polmod.ScheduledRequest(payload=None, priority="default", tenant="t", cost=1,
                                                enqueued_at=clock.t - 3.0))
        clock.t += 1.5
        e.watermarks.note_tick()
        clock.t += 0.5
        snaps.append(h.replica_snapshot(Replica("r", e)))
    assert snaps[1] == snaps[0]
    assert snaps[1]["queue_head_age"] == 5.0 and snaps[1]["decodable"] == 0


@pytest.mark.parametrize("policy", ["FIFOPolicy", "FairSharePolicy"])
def test_oldest_enqueued_at_as_the_jax_package(policy):
    got = []
    for _, _, polmod in MODULES.values():
        pol = getattr(polmod, policy)(clock=Clock())
        out = [pol.oldest_enqueued_at()]
        entries = [polmod.ScheduledRequest(payload=i, priority=c, tenant=t, cost=1, enqueued_at=at)
                   for i, (c, t, at) in enumerate([("batch", "a", 7.0), ("interactive", "b", 3.0),
                                                   ("default", "a", 5.0), ("default", "c", 0.0)])]
        for e in entries:
            pol.submit(e)
            out.append(pol.oldest_enqueued_at())
        pol.remove(entries[1])
        out.append(pol.oldest_enqueued_at())
        pol.next_batch(10)
        out.append(pol.oldest_enqueued_at())
        got.append(out)
    assert got[1] == got[0] == [None, 7.0, 3.0, 3.0, 3.0, 5.0, None]


def test_the_health_and_sched_subcommands_print_as_the_jax_cli(state, tmp_path):
    """``health`` over the journal the scripted ladder wrote, ``sched`` and
    ``health`` over an empty state directory: each package's CLI prints the
    same (the port's program name read as ``tpurun``)."""
    import contextlib
    import io

    from modal_examples_tpu.core import cli as jcli
    from modal_examples_tpu_torch.core import cli as pcli

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue().replace(pcli.PROG, "tpurun")

    empty = tmp_path / "empty"
    empty.mkdir()
    argv = ["sched", "--dir", str(empty)]
    assert run(pcli.main, argv) == run(jcli.main, argv)
    # nothing recorded: the same line, each naming its own way to record some
    (prc, pout), (jrc, jout) = (run(m, ["health", "--dir", str(empty)]) for m in (pcli.main, jcli.main))
    assert prc == jrc == 0 and pout.split("(")[0] == jout.split("(")[0] == "no watchdog activity recorded yet "
    runs = {}
    for name, (h, prom, polmod) in MODULES.items():
        root = tmp_path / name
        root.mkdir()
        _drive(h, prom, polmod, root, "x")
        (root / "x.jsonl").rename(root / "watchdog.jsonl")
        runs[name] = run(jcli.main if name == "jax" else pcli.main, ["health", "--dir", str(root)])
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][0] == 0 and "quarantine" in runs["torch"][1]
