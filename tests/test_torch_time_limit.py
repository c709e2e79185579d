"""Time limits and process accounting for the port's tests that spawn
processes (containers, CLI children, ``serve``).

A test file that spawns processes imports :func:`time_limits` and binds its
two fixtures at module level::

    from test_torch_time_limit import time_limits
    _limit_module, _limit_test = time_limits(test_s=60, module_s=120)

Each test then runs under ``signal.alarm``: past ``test_s`` seconds every
thread's stack is dumped to stderr and the test fails with
:class:`TimeLimitExceeded`, instead of holding its xdist worker until the
whole run's clock runs out. Module fixtures (an app's run context, its
containers) set up and tear down under ``module_s``. When the module ends,
no ``container_worker`` process that this process started during it may be
alive.
:func:`share_cores`, which every ``test_torch_*`` module calls, gives each
pytest-xdist worker's torch its share of the cores. The tests below hold
the limit itself and that call.
"""

import faulthandler
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

WORKER = "container_worker"


def share_cores() -> None:
    """Under pytest-xdist, give this worker's torch its share of the cores.

    Each worker would otherwise run torch with one intra-op thread per core:
    six workers on eight cores run 48 threads, and the load starves the
    timing-sensitive tests of the other workers. Every ``test_torch_*``
    module calls this when it is imported, so the share holds in whichever
    worker runs it, whatever subset of files a run collects."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))


share_cores()


class TimeLimitExceeded(Exception):
    """A test (or a module's fixtures) ran past its limit."""


def _on_alarm(signum, frame):
    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    raise TimeLimitExceeded(_armed.get("what", "the time limit"))


_armed: dict = {}


def arm(seconds: float, what: str) -> None:
    """Arm the alarm for ``seconds`` (whole seconds, at least 1); only the
    main thread can take a signal, so elsewhere this does nothing."""
    if threading.current_thread() is not threading.main_thread():
        return
    _armed["what"] = f"{what} ran past its limit of {seconds:g} s"
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(max(1, int(round(seconds))))


def disarm() -> None:
    if threading.current_thread() is threading.main_thread():
        signal.alarm(0)


def _cmdline(pid: str) -> bytes:
    try:
        return Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return b""


def _stat(pid: str) -> tuple[str, int]:
    """(state, parent pid) from ``/proc/<pid>/stat``."""
    try:
        text = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return "X", -1
    fields = text[text.rindex(")") + 2:].split()
    return fields[0], int(fields[1])


def live_workers(*, parent: int | None = None, env_marker: str | None = None) -> list[int]:
    """Pids of live (not zombie) container workers: children of ``parent``,
    or processes whose environment holds ``env_marker`` (a test's own
    ``MTPU_STATE_DIR=...``, which reaches the children of a CLI child)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or WORKER.encode() not in _cmdline(pid):
            continue
        state, ppid = _stat(pid)
        if state in ("Z", "X"):
            continue
        if parent is not None and ppid == parent:
            out.append(int(pid))
        elif env_marker is not None:
            try:
                if env_marker.encode() in Path(f"/proc/{pid}/environ").read_bytes():
                    out.append(int(pid))
            except OSError:
                pass
    return out


def assert_no_workers(*, grace_s: float = 15.0, before=(), **match) -> None:
    """Wait up to ``grace_s`` for matching workers (other than the pids in
    ``before``) to exit, then fail naming any that remain (a graceful
    shutdown gives a container 5 s)."""
    deadline = time.monotonic() + grace_s
    while (left := sorted(set(live_workers(**match)) - set(before))) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not left, f"container workers outlived their test: {left}"


def time_limits(*, test_s: float, module_s: float):
    """The (module, test) autouse fixtures of a spawning test file."""

    @pytest.fixture(scope="module", autouse=True)
    def _limit_module():
        arm(module_s, "the module's fixtures")
        # workers another file left behind are not this module's to answer for
        before = live_workers(parent=os.getpid())
        yield
        arm(module_s, "the module's teardown")
        try:
            assert_no_workers(parent=os.getpid(), before=before)
        finally:
            disarm()

    @pytest.fixture(autouse=True)
    def _limit_test(request):
        arm(test_s, request.node.nodeid)
        yield
        # the next test's module fixtures, or this module's teardown
        arm(module_s, "the module's fixtures")

    return _limit_module, _limit_test


def thread_guard(grace_s: float = 15.0):
    """The autouse module fixture of a file whose tests start threads (an
    engine's scheduler loop, a watchdog, a detokenization worker): when the
    module ends, no thread it started may be alive (``grace_s`` for the last
    ones to exit)."""

    @pytest.fixture(scope="module", autouse=True)
    def _no_thread_outlives_the_module():
        before = set(threading.enumerate())
        yield
        deadline = time.monotonic() + grace_s
        while (left := [t for t in threading.enumerate() if t not in before and t.is_alive()]) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert not left, f"threads outlived the module: {[t.name for t in left]}"

    return _no_thread_outlives_the_module


def read_line(stream, timeout_s: float) -> str:
    """The next line of a child's text ``stream``, or TimeoutError after
    ``timeout_s`` (a thread reads, so the caller's wait is bounded)."""
    got: list = []
    reader = threading.Thread(target=lambda: got.append(stream.readline()), daemon=True)
    reader.start()
    reader.join(timeout_s)
    if not got:
        raise TimeoutError(f"no line from the child within {timeout_s:g} s")
    return got[0]


def stop_child(proc: subprocess.Popen, grace_s: float = 15.0) -> None:
    """Interrupt a CLI child as Ctrl-C would (its run context closes and
    shuts its containers down), then kill it past ``grace_s``; reaped."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(grace_s)


# -- the limit itself ---------------------------------------------------------------

#: these tests spawn processes too (a few seconds at most)
_limit_module, _limit_test = time_limits(test_s=60, module_s=120)



def test_a_test_past_its_limit_fails_with_every_stack(tmp_path):
    """A blocked wait past the limit fails the test with a stack dump."""
    code = (
        "import sys, threading; sys.path.insert(0, sys.argv[1]); import test_torch_time_limit as t\n"
        "t.arm(1, 'the blocked test')\n"
        "try:\n"
        "    threading.Event().wait()\n"
        "except t.TimeLimitExceeded as e:\n"
        "    print('limit:', e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(Path(__file__).parent)], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "limit: the blocked test ran past its limit of 1 s"
    assert "most recent call first" in out.stderr and "in wait" in out.stderr  # the dumped stack names the wait


def test_read_line_is_bounded():
    proc = subprocess.Popen([sys.executable, "-c", "import time; print('first', flush=True); time.sleep(60)"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        assert read_line(proc.stdout, 30).strip() == "first"
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            read_line(proc.stdout, 0.5)
        assert time.monotonic() - t0 < 5
    finally:
        stop_child(proc, grace_s=2)
    assert proc.returncode is not None


def test_live_workers_sees_a_child_by_parent_and_by_marker(tmp_path):
    marker = f"MTPU_STATE_DIR={tmp_path}"
    fake = tmp_path / WORKER
    fake.write_text("import time; time.sleep(60)\n")
    proc = subprocess.Popen([sys.executable, str(fake)], env={**os.environ, "MTPU_STATE_DIR": str(tmp_path)})
    try:
        deadline = time.monotonic() + 10
        while proc.pid not in live_workers(parent=os.getpid()) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert proc.pid in live_workers(parent=os.getpid())
        assert live_workers(env_marker=marker) == [proc.pid]
        with pytest.raises(AssertionError, match="outlived"):
            assert_no_workers(grace_s=0.2, env_marker=marker)
    finally:
        proc.kill()
        proc.wait(10)
    assert_no_workers(grace_s=5, env_marker=marker)


def test_every_port_test_module_takes_its_share_of_the_cores():
    """A module that runs torch without the share loads its worker's cores
    with one thread per core, whichever files a run collects."""
    missing = [
        path.name for path in sorted(Path(__file__).parent.glob("test_torch_*.py"))
        if "\nshare_cores()\n" not in path.read_text()
    ]
    assert not missing, missing


def test_share_cores_divides_the_cores_among_the_workers(monkeypatch):
    import torch

    before = torch.get_num_threads()
    try:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(2 * (os.cpu_count() or 1)))
        share_cores()
        assert torch.get_num_threads() == 1
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "1")
        share_cores()
        assert torch.get_num_threads() == (os.cpu_count() or 1)
    finally:
        torch.set_num_threads(before)
