"""Container executor: the local control plane for serverless functions;
after ``modal_examples_tpu/core/executor.py``, for containers on NVIDIA GPUs.

The reference platform schedules containers for every ``.remote/.map/.spawn``
call — autoscaling a pool per Function, streaming logs, enforcing timeouts,
retrying on failure, and scaling to zero after an idle window (SURVEY.md L3;
vllm_inference.py:139-152 sets scaledown_window/target_concurrency;
long-training.py:109-137 sets retries/timeout/single_use_containers).

This module implements those semantics with supervised worker **processes**
("containers"): spawned as fresh interpreters (``subprocess``, never a
forked copy — a forked child of a process that holds a CUDA context cannot
use CUDA), fed over pipes with pickled inputs, scaled between
``min_containers`` and ``max_containers``, reaped after ``scaledown_window``
idle seconds, and killed on per-input ``timeout`` with the input retried per
its :class:`~modal_examples_tpu_torch.core.retries.Retries` policy.

Container model:
- one process per container; inside it, up to ``max_concurrent_inputs``
  (``@concurrent``, text_to_image.py:238) threads execute inputs;
- ``@batched`` functions receive grouped inputs: the scheduler coalesces up
  to ``max_batch_size`` queued inputs per dispatch after waiting ``wait_ms``
  (dynamic_batching.py:29,57);
- Cls containers instantiate the user class and run ``@enter`` hooks once
  before serving inputs, and ``@exit`` hooks at shutdown (text_to_image.py:
  92-137) — load-once-serve-many; with ``enable_memory_snapshot=True`` a
  boot restores the state its ``snap=True`` hooks left (``snapshot/``,
  tensors back onto the container's card) instead of running them, once a
  first boot captured it;
- a container of a function without ``gpu=`` sees no card
  (``CUDA_VISIBLE_DEVICES=""``) and creates no CUDA context; one with
  ``gpu=`` checks at boot that its cards satisfy the request
  (``core/resources.py`` ``select_gpu_spec``) and fails the boot, naming the
  request, when they do not: it never runs on the CPU instead;
- every container imports the package from the same checkout, so it loads
  the kernels that ``ops/_build.py`` built under that checkout's
  ``build/kernels`` (the counterpart of the JAX package's shared XLA compile
  cache) and builds only what is missing.

A container's ready message carries its boot split (:func:`boot_info`):
spawn, interpreter, ``import torch``, the app file, and the snapshot layer's
restore or ``snap=True`` hooks, capture and other hooks.

``@clustered(size=n, chips_per_host=k)`` functions go to :class:`ClusterPool`
(the JAX package's gang scheduler): one call boots ``n`` containers with the
rank and coordinator env (``parallel.cluster``), and a container whose
``chips_per_host`` is above 1 runs the function in that many rank processes
(``parallel.cluster.spawn_ranks``, the reference's ``torchrun
--nproc-per-node``), which join one process group across the containers.
A rank or a container that fails fails the call.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import queue as _queue
import socket
import threading
import time
import traceback
import uuid
from collections import deque
from typing import Any, Callable

import inspect
import subprocess
import sys
import tempfile
from multiprocessing.connection import Client, Listener
from pathlib import Path

from .._internal import config as _config
from ..faults import inject as _inject
from ..observability import journal as _journal
from ..observability import metrics as _obs
from ..observability import trace as _tr
from ..scheduling.policy import CLASS_RANK
from ..utils.log import get_logger
from . import serialization as ser
from .resources import GPU_SPEC_ENV, select_gpu_spec
from .retries import Retries

_log = get_logger("executor")

#: seconds a container may take from spawn to ready before it is killed and
#: its queued inputs fail: a container that hangs at boot surfaces as an
#: error, never as a wait without end
BOOT_TIMEOUT_S = 600.0

#: host-RSS sampling throttle (process-wide; every pool's tick shares it)
_RSS_SAMPLE_EVERY_S = 2.0
_rss_wall = 0.0
_rss_lock = threading.Lock()


def _maybe_sample_rss() -> None:
    """Sample the supervisor process's RSS into ``mtpu_host_rss_bytes``,
    throttled — scheduler ticks run at 20 Hz per pool."""
    global _rss_wall
    now = time.monotonic()
    with _rss_lock:
        if now - _rss_wall < _RSS_SAMPLE_EVERY_S:
            return
        _rss_wall = now
    _obs.sample_host_rss()


import contextvars

#: the input id being processed by the current container thread
#: (modal.current_input_id parity)
_current_input_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "mtpu-input-id", default=None
)


def current_input_id() -> str | None:
    return _current_input_id.get()


class FunctionTimeoutError(TimeoutError):
    pass


class _ContainerDead(RuntimeError):
    """Raised by dispatch() when racing a container's death.

    ``still_owned`` lists the inputs the dispatcher removed from the
    container's active set itself — only those may be requeued by the caller
    (anything already taken by the reader thread's death path is the death
    path's responsibility; requeueing it too would run the input twice).
    """

    def __init__(self, msg: str, still_owned: list | None = None):
        super().__init__(msg)
        self.still_owned = still_owned or []


class InputCancelled(Exception):
    pass


# --------------------------------------------------------------------------
# Container-side (child process)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ContainerConfig:
    """Everything a container needs to boot, pickled across the spawn."""

    function_tag: str
    fn_bytes: bytes  # cloudpickled callable OR (cls, lifecycle meta) bundle
    is_cls: bool
    cls_params: bytes | None  # pickled dict of modal.parameter overrides
    env: dict[str, str]
    sys_paths: list[str]
    max_concurrent_inputs: int
    volumes: list[tuple[str, str]]  # (mount path, host path)
    # memory snapshots (enable_memory_snapshot=True on a Cls): resolved
    # client-side so supervisor and container agree on the store entry
    snapshot_key: str | None = None
    snapshot_dir: str | None = None


#: the env var a supervisor sets to the wall time of a container's spawn
SPAWNED_AT_ENV = "MTPU_SPAWNED_AT"
#: this container's boot info (the ready message), for :func:`boot_info`
_boot: dict = {}


def boot_info() -> dict:
    """Inside a container: the boot info its ready message carried. ``gpu``
    and ``cards`` (a ``gpu=`` container's boot check), ``snapshot`` (``off``,
    ``miss``, ``hit`` or ``fallback``) and ``captured``, and ``boot_s``: the
    seconds of ``spawn`` (the supervisor's spawn call to the process's
    start), ``interpreter`` (to the worker's first line), ``handshake`` (the
    config received), ``import_torch``, ``app_file`` (the function or class
    imported) and the snapshot layer's ``restore``, ``snap_hooks``,
    ``capture`` and ``enter_hooks``."""
    return dict(_boot)


def _process_start_wall() -> float | None:
    """Wall time this process started (``/proc``; 1/CLK_TCK resolution)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        for line in Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime "):
                return int(line.split()[1]) + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return None


def _mount_volumes(volumes: list[tuple[str, str]]) -> None:
    """Materialize volume mounts as symlinks (local-backend bind mount)."""
    for mount_path, host_path in volumes:
        try:
            if os.path.islink(mount_path):
                if os.readlink(mount_path) == host_path:
                    continue
                os.unlink(mount_path)
            elif os.path.exists(mount_path):
                continue  # a real dir already there; leave it alone
            os.makedirs(os.path.dirname(mount_path) or "/", exist_ok=True)
            os.symlink(host_path, mount_path)
        except OSError as e:
            _log.warning("cannot mount volume at %s: %s", mount_path, e)


def _check_gpus(timings: dict | None = None) -> dict:
    """Boot check of a ``gpu=`` container: the visible cards must satisfy
    the request in ``MTPU_GPU_SPEC`` (the first spec they do is kept there).
    Raises naming the request otherwise. Returns the boot info it adds;
    ``timings`` receives the seconds of ``import_torch``."""
    request = os.environ.get(GPU_SPEC_ENV)
    if not request:
        return {}
    t0 = time.perf_counter()
    import torch

    if timings is not None:
        timings["import_torch"] = time.perf_counter() - t0

    names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    spec = select_gpu_spec(request, names)
    os.environ[GPU_SPEC_ENV] = str(spec)
    return {"gpu": str(spec), "cards": names[: spec.count]}


def _container_main(conn, cfg_bytes: bytes, timings: dict) -> None:
    """Entry point of a container process; ``timings`` holds the boot's
    parts so far and receives the rest."""
    cfg: ContainerConfig = ser.deserialize(cfg_bytes)
    os.environ.update(cfg.env)
    os.environ[_config.TASK_ID_ENV] = f"ta-{uuid.uuid4().hex[:12]}"
    import sys

    for p in cfg.sys_paths:
        if p not in sys.path:
            sys.path.insert(0, p)
    _mount_volumes(cfg.volumes)

    send_lock = threading.Lock()

    def send(msg) -> None:
        with send_lock:
            try:
                conn.send(msg)
            except (BrokenPipeError, OSError):
                os._exit(1)

    exit_hooks: list[Callable] = []
    try:
        boot_info = _check_gpus(timings)
        t0 = time.perf_counter()
        target = ser.function_from_bytes(cfg.fn_bytes)
        timings["app_file"] = time.perf_counter() - t0
        if cfg.is_cls:
            cls, meta = target  # (user class, lifecycle metadata dict)
            params = ser.deserialize(cfg.cls_params) if cfg.cls_params else {}
            # snapshot-aware boot: restore past snap=True @enter hooks when
            # the store has an entry for this spec, else run them and capture
            from ..snapshot import build_and_enter

            obj, snap_info = build_and_enter(
                cls,
                params,
                meta,
                snapshot_key=cfg.snapshot_key,
                snapshot_dir=cfg.snapshot_dir,
                tag=cfg.function_tag,
                timings=timings,
            )
            boot_info.update(snap_info)
            exit_hooks = [getattr(obj, n) for n in meta.get("exit", [])]

            def call_fn(method_name, args, kwargs):
                return getattr(obj, method_name)(*args, **kwargs)

        else:
            chips = int(os.environ.get(CLUSTER_CHIPS_ENV, "1")) if CLUSTER_RANK_ENV in os.environ else 1
            if chips > 1:
                from ..parallel.cluster import spawn_ranks

                def call_fn(method_name, args, kwargs):
                    # one rank process a card of this host; rank 0's value is the container's
                    return spawn_ranks(_call_by_ref, chips, args=(cfg.fn_bytes, args, kwargs), init=False)[0]

            else:

                def call_fn(method_name, args, kwargs):
                    return target(*args, **kwargs)

        boot_info["boot_s"] = timings
        _boot.update(boot_info)
        send(("ready", boot_info))
    except BaseException as e:  # boot failure
        send(("boot_error", ser.serialize_exception(e)))
        return

    inflight = threading.Semaphore(cfg.max_concurrent_inputs)

    def run_one(
        input_id: str, method_name: str, payload: bytes, trace: dict | None = None
    ) -> None:
        """Execute one input, emitting execute/serialize spans that ship back
        over the pipe and stitch into the caller's trace (the supervisor
        records them before delivering the result, so a trace read right
        after ``.result()`` already sees the child's spans)."""
        _current_input_id.set(input_id)
        spans: list[dict] = []

        def begin(name: str) -> "_tr.Span | None":
            if trace is None:
                return None
            return _tr.Span(
                trace_id=trace["trace_id"],
                name=name,
                parent_id=trace.get("parent_id"),
            )

        def done(sp, status: str = "ok", **attrs) -> None:
            if sp is not None:
                sp.finish(status, **attrs)
                spans.append(sp.to_dict())

        try:
            ex = begin("execute")
            if ex is not None:
                # nested user spans (observability.span) ride the same buffer
                _tr.set_context(
                    _tr.TraceContext(trace["trace_id"], ex.span_id, spans.append)
                )
            try:
                args, kwargs = ser.deserialize(payload)
                result = call_fn(method_name, args, kwargs)
            except BaseException:
                done(ex, "error")
                raise
            if inspect.isgenerator(result):
                ser_s = 0.0
                n_items = 0
                try:
                    while True:
                        try:
                            item = next(result)
                        except StopIteration:
                            break
                        t0 = time.monotonic()
                        out = ser.serialize(item)
                        ser_s += time.monotonic() - t0
                        send(("yield", input_id, out))
                        n_items += 1
                except BaseException:
                    done(ex, "error", items=n_items)
                    raise
                done(ex, "ok", items=n_items)
                sz = begin("serialize")
                if sz is not None:
                    # per-item serialize time accumulated across the stream
                    sz.start = time.time() - ser_s
                    done(sz, "ok", items=n_items, streamed=True)
                if spans:
                    send(("spans", spans))
                send(("gen_done", input_id))
            else:
                done(ex, "ok")
                sz = begin("serialize")
                out = ser.serialize(result)
                done(sz, "ok", bytes=len(out))
                if spans:
                    send(("spans", spans))
                send(("result", input_id, True, out))
        except BaseException as e:
            if spans:
                send(("spans", spans))
            send(("result", input_id, False, ser.serialize_exception(e)))
        finally:
            inflight.release()

    def run_batch(
        input_ids: list[str],
        method_name: str,
        payloads: list[bytes],
        traces: list | None = None,
    ) -> None:
        """Dynamic batching: unzip single-item args, call once with lists."""
        traces = traces or [None] * len(input_ids)
        spans: list[dict] = []

        def phase(name: str, start: float, end: float, status: str) -> None:
            # the batch ran once, but each input's trace gets its own copy of
            # the shared phase span (tagged with the batch size)
            for tr in traces:
                if tr is None:
                    continue
                sp = _tr.Span(
                    trace_id=tr["trace_id"],
                    name=name,
                    parent_id=tr.get("parent_id"),
                    start=start,
                    attrs={"batch_size": len(input_ids)},
                )
                sp.end = end
                sp.status = status
                spans.append(sp.to_dict())

        t_exec = time.time()
        try:
            calls = [ser.deserialize(p) for p in payloads]
            n_args = len(calls[0][0])
            batched_args = [[c[0][i] for c in calls] for i in range(n_args)]
            kw_keys = sorted(calls[0][1])
            batched_kwargs = {k: [c[1][k] for c in calls] for k in kw_keys}
            results = call_fn(method_name, batched_args, batched_kwargs)
            results = list(results)
            if len(results) != len(input_ids):
                raise ValueError(
                    f"@batched function returned {len(results)} outputs for "
                    f"{len(input_ids)} inputs"
                )
            t_ser = time.time()
            phase("execute", t_exec, t_ser, "ok")
            outs = [ser.serialize(r) for r in results]
            phase("serialize", t_ser, time.time(), "ok")
            if spans:
                send(("spans", spans))
            for iid, out in zip(input_ids, outs):
                send(("result", iid, True, out))
        except BaseException as e:
            phase("execute", t_exec, time.time(), "error")
            err = ser.serialize_exception(e)
            if spans:
                send(("spans", spans))
            for iid in input_ids:
                send(("result", iid, False, err))
        finally:
            inflight.release()

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg[0] == "shutdown":
            break
        elif msg[0] == "input":
            _, input_id, method_name, payload, trace = msg
            inflight.acquire()
            threading.Thread(
                target=run_one,
                args=(input_id, method_name, payload, trace),
                daemon=True,
            ).start()
        elif msg[0] == "batch":
            _, input_ids, method_name, payloads, traces = msg
            inflight.acquire()
            threading.Thread(
                target=run_batch,
                args=(input_ids, method_name, payloads, traces),
                daemon=True,
            ).start()

    for hook in exit_hooks:
        try:
            hook()
        except Exception:
            traceback.print_exc()
    try:
        # this container's registry (e.g. a served engine's histograms)
        # outlives it through the file push gateway
        from ..observability.export import push_metrics_file

        push_metrics_file(f"container-{cfg.function_tag}-{os.getpid()}")
    except Exception:
        pass  # metrics must never break container shutdown
    try:
        send(("bye",))
    except Exception:
        pass


# --------------------------------------------------------------------------
# Supervisor-side (client process)
# --------------------------------------------------------------------------


class _Call:
    """Client-side handle for one dispatched input (future + stream)."""

    def __init__(self, input_id: str, deadline: float | None, retries: Retries | None):
        self.input_id = input_id
        self.deadline = deadline
        self.retries = retries
        self.attempt = 0
        self.done = threading.Event()
        self.ok: bool | None = None
        self.value: Any = None
        self.exc: BaseException | None = None
        self.gen_queue: _queue.Queue = _queue.Queue()
        self.cancelled = False
        # observability: trace id == input id; the pool opens the root span
        # at submit and registers a finalizer that closes it
        self.trace_id: str | None = None
        self.root_span: "_tr.Span | None" = None
        self._done_callbacks: list[Callable] = []
        self._finalized = False

    def add_done_callback(self, fn: Callable) -> None:
        self._done_callbacks.append(fn)

    def _run_done_callbacks(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        for fn in self._done_callbacks:
            try:
                fn()
            except Exception:
                _log.exception("call done-callback failed")

    def set_result(self, value) -> None:
        self.ok, self.value = True, value
        # finalizers run BEFORE done.set(): a caller unblocked by .result()
        # must find the completed trace on disk
        self._run_done_callbacks()
        self.done.set()

    def set_exception(self, exc: BaseException) -> None:
        self.ok, self.exc = False, exc
        self.gen_queue.put(("error", exc))
        self._run_done_callbacks()
        self.done.set()

    def result(self, timeout: float | None = None):
        if not self.done.wait(timeout):
            raise TimeoutError(f"input {self.input_id} not done after {timeout}s")
        if self.ok:
            return self.value
        raise self.exc


@dataclasses.dataclass
class _QueuedInput:
    call: _Call
    method_name: str
    payload: bytes
    ready_at: float = 0.0  # for retry backoff
    started_at: float | None = None
    # scheduling class (scheduling/policy.py): interactive inputs
    # dispatch before default before batch when contending for containers
    priority: str = "default"
    # open phase spans; each is finished + recorded at its phase boundary
    queue_span: "_tr.Span | None" = None
    dispatch_span: "_tr.Span | None" = None

    def trace_ctx(self) -> dict | None:
        """Propagation payload for the container-worker protocol: the child's
        execute/serialize spans parent under this input's dispatch span."""
        if self.dispatch_span is None:
            return None
        return {
            "trace_id": self.call.trace_id,
            "parent_id": self.dispatch_span.span_id,
        }


#: the cluster env protocol's names (``parallel.cluster``, which imports no torch)
CLUSTER_RANK_ENV = "MTPU_CLUSTER_RANK"
CLUSTER_CHIPS_ENV = "MTPU_CLUSTER_CHIPS_PER_HOST"


def _call_by_ref(local_rank: int, fn_bytes: bytes, args: tuple, kwargs: dict):
    """A clustered function's body in one of its container's rank
    processes."""
    return ser.function_from_bytes(fn_bytes)(*args, **kwargs)


def _end_dispatch_span(pool, qi: _QueuedInput, status: str, **attrs) -> None:
    """Finish + record an input's dispatch span (shared by the container
    reader's success path and the pool's failure paths)."""
    sp = qi.dispatch_span
    if sp is None:
        return
    qi.dispatch_span = None
    dur = sp.finish(status, **attrs)
    _tr.default_store.record(sp)
    _obs.record_phase(pool.spec.tag, "dispatch", dur)


def worker_entry() -> None:
    """Child-process entry (``python -m modal_examples_tpu_torch.core.container_worker``).

    Containers are plain subprocesses — NOT multiprocessing spawn children —
    so the parent's ``__main__`` is never re-executed in the child (spawn's
    main-module fixup re-runs scripts and re-imports pytest; a real container
    boots from its own entrypoint). The config arrives over an authenticated
    AF_UNIX connection, the same channel used for inputs/results.
    """
    entered = time.time()
    timings: dict = {}
    started = _process_start_wall()
    spawned = os.environ.pop(SPAWNED_AT_ENV, "")
    if started is not None:
        timings["interpreter"] = max(0.0, entered - started)
        if spawned:
            timings["spawn"] = max(0.0, started - float(spawned))
    sock = os.environ.pop("MTPU_WORKER_SOCKET")
    authkey = bytes.fromhex(os.environ.pop("MTPU_WORKER_AUTHKEY"))
    conn = Client(sock, family="AF_UNIX", authkey=authkey)
    cfg_bytes = conn.recv()
    timings["handshake"] = time.time() - entered
    _container_main(conn, cfg_bytes, timings)


class _Container:
    _counter = itertools.count()

    def __init__(self, pool, extra_env: dict[str, str] | None = None):
        self.pool = pool
        self.idx = next(self._counter)
        self.extra_env = extra_env or {}
        sock_dir = Path(tempfile.gettempdir()) / "mtpu-socks"
        sock_dir.mkdir(exist_ok=True)
        self._sock_path = str(sock_dir / f"c-{uuid.uuid4().hex[:12]}.sock")
        authkey = os.urandom(16)
        self._listener = Listener(self._sock_path, family="AF_UNIX", authkey=authkey)
        env = dict(os.environ)
        env["MTPU_WORKER_SOCKET"] = self._sock_path
        env["MTPU_WORKER_AUTHKEY"] = authkey.hex()
        pkg_root = str(Path(__file__).resolve().parents[2])
        py_paths = [pkg_root] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p
        ]
        if not pool.spec.gpu:
            # CPU container: no card is visible, so nothing in it can
            # create a CUDA context on one
            env["CUDA_VISIBLE_DEVICES"] = ""
        # the package comes from this checkout (first on the path), and with
        # it the kernel libraries built under its build/kernels
        env["PYTHONPATH"] = os.pathsep.join(py_paths)
        env.update(self.extra_env)
        env[SPAWNED_AT_ENV] = repr(time.time())
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "modal_examples_tpu_torch.core.container_worker"],
            env=env,
        )
        self.conn = None
        self.kill_reason: str | None = None
        self.ready = threading.Event()
        self.ever_ready = False
        # observability: boot wall-clock window + boot info, consumed by the
        # first dispatched input's "boot" span
        self.boot_wall_start = time.time()
        self.boot_timeout_s = BOOT_TIMEOUT_S
        self.boot_deadline = time.monotonic() + self.boot_timeout_s
        self.ready_wall: float | None = None
        self.boot_info: dict = {}
        self._boot_span_pending = True
        self.retired = False  # single-use containers retire after one dispatch
        self.reaped = False  # autoscaler made (and journaled) a scale-down
        self.boot_error: BaseException | None = None
        self.active: dict[str, _QueuedInput] = {}
        self.lock = threading.Lock()
        self.last_active = time.monotonic()
        self.dead = False
        self.inputs_served = 0
        self.reader = threading.Thread(target=self._read_loop, daemon=True)
        self.reader.start()
        self.watchdog = threading.Thread(target=self._watch_proc, daemon=True)
        self.watchdog.start()

    def _watch_proc(self) -> None:
        self.proc.wait()
        # If the child died before connecting, wake the reader's accept() by
        # connecting and hanging up: its handshake then fails and the reader
        # marks the container dead. Closing the listening socket would not
        # do: on Linux that does not wake a thread blocked in its accept(),
        # and the container would count as booting for ever.
        if self.conn is None:
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                    s.settimeout(5.0)
                    s.connect(self._sock_path)
            except OSError:
                pass  # the reader has accepted already and closed the socket

    # -- dispatch -----------------------------------------------------------

    def capacity(self) -> int:
        with self.lock:
            if self.dead or self.retired or not self.ready.is_set():
                return 0
            return self.pool.spec_max_concurrent - len(self.active)

    def _trace_dispatch(self, qi: _QueuedInput) -> None:
        """Phase-span bookkeeping at dispatch: close the queue span (observe
        queue wait), emit the boot-or-warm span (cold boots carry the
        cards the boot check chose), open the dispatch span."""
        call = qi.call
        if call.root_span is None:
            return
        tag = self.pool.spec.tag
        if qi.queue_span is not None:
            wait = qi.queue_span.finish("ok")
            _tr.default_store.record(qi.queue_span)
            qi.queue_span = None
            _obs.record_queue_wait(tag, wait)
        root_id = call.root_span.span_id
        if self._boot_span_pending:
            self._boot_span_pending = False
            sp = _tr.Span(
                trace_id=call.trace_id,
                name="boot",
                parent_id=root_id,
                start=self.boot_wall_start,
                attrs={
                    "mode": "cold",
                    "container": self.idx,
                    "gpu": (self.boot_info or {}).get("gpu", ""),
                    "snapshot": (self.boot_info or {}).get("snapshot", "off"),
                },
            )
            sp.end = self.ready_wall or time.time()
            _tr.default_store.record(sp)
            _obs.record_phase(tag, "boot", sp.duration)
        else:
            sp = _tr.Span(
                trace_id=call.trace_id,
                name="boot",
                parent_id=root_id,
                attrs={"mode": "warm", "container": self.idx},
            )
            sp.end = sp.start
            _tr.default_store.record(sp)
        qi.dispatch_span = _tr.Span(
            trace_id=call.trace_id,
            name="dispatch",
            parent_id=root_id,
            attrs={"container": self.idx, "attempt": call.attempt},
        )

    def dispatch(self, qi: _QueuedInput) -> None:
        qi.started_at = time.monotonic()
        # timeout= is per-attempt: the clock starts at dispatch, so a retried
        # input gets a fresh budget rather than inheriting an expired deadline
        if self.pool.spec.timeout:
            qi.call.deadline = qi.started_at + self.pool.spec.timeout
        with self.lock:
            if self.dead:
                raise _ContainerDead(f"container {self.idx} is dead")
            self.active[qi.call.input_id] = qi
            self.last_active = time.monotonic()
        self._trace_dispatch(qi)
        try:
            self.conn.send(
                ("input", qi.call.input_id, qi.method_name, qi.payload,
                 qi.trace_ctx())
            )
        except (BrokenPipeError, OSError) as e:
            _end_dispatch_span(self.pool, qi, "error", reason="container_death")
            with self.lock:
                owned = self.active.pop(qi.call.input_id, None)
            raise _ContainerDead(str(e), [qi] if owned else []) from e

    def dispatch_batch(self, qis: list[_QueuedInput]) -> None:
        now = time.monotonic()
        with self.lock:
            if self.dead:
                raise _ContainerDead(f"container {self.idx} is dead")
            for qi in qis:
                qi.started_at = now
                if self.pool.spec.timeout:
                    qi.call.deadline = now + self.pool.spec.timeout
                self.active[qi.call.input_id] = qi
            self.last_active = now
        for qi in qis:
            self._trace_dispatch(qi)
        try:
            self.conn.send(
                (
                    "batch",
                    [qi.call.input_id for qi in qis],
                    qis[0].method_name,
                    [qi.payload for qi in qis],
                    [qi.trace_ctx() for qi in qis],
                )
            )
        except (BrokenPipeError, OSError) as e:
            for qi in qis:
                _end_dispatch_span(
                    self.pool, qi, "error", reason="container_death"
                )
            with self.lock:
                owned = [
                    qi for qi in qis
                    if self.active.pop(qi.call.input_id, None) is not None
                ]
            raise _ContainerDead(str(e), owned) from e

    # -- reading ------------------------------------------------------------

    def _read_loop(self) -> None:
        try:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                return  # child died before connecting (the watchdog woke us)
            finally:
                try:
                    self._listener.close()
                    os.unlink(self._sock_path)
                except OSError:
                    pass
            conn.send(ser.serialize(self.pool.container_config))
            self.conn = conn
            while True:
                msg = conn.recv()
                kind = msg[0]
                if kind == "ready":
                    self.ever_ready = True
                    self.ready_wall = time.time()
                    with self.lock:  # idle time starts when it can serve
                        self.last_active = time.monotonic()
                    info = msg[1] if len(msg) > 1 else {}
                    self.boot_info = info or {}
                    if info:
                        try:
                            self.pool.on_container_ready(self, info)
                        except Exception:
                            traceback.print_exc()
                    self.ready.set()
                elif kind == "boot_error":
                    exc, _tb = ser.deserialize_exception(msg[1])
                    self.boot_error = exc
                    self.ready.set()
                    break
                elif kind == "yield":
                    _, input_id, payload = msg
                    with self.lock:
                        qi = self.active.get(input_id)
                    if qi:
                        qi.call.gen_queue.put(("item", ser.deserialize(payload)))
                elif kind == "gen_done":
                    _, input_id = msg
                    with self.lock:
                        qi = self.active.pop(input_id, None)
                        self.last_active = time.monotonic()
                        self.inputs_served += 1
                    if qi is not None:
                        _end_dispatch_span(self.pool, qi, "ok")
                        qi.call.gen_queue.put(("done", None))
                        qi.call.set_result(None)
                elif kind == "spans":
                    # child-process phase spans (execute/serialize + any user
                    # spans): record into the owning traces and feed the
                    # per-phase latency histograms
                    _, child_spans = msg
                    for sp in child_spans:
                        _tr.default_store.record(sp)
                        if sp.get("name") in ("execute", "serialize") and sp.get(
                            "end"
                        ) is not None:
                            _obs.record_phase(
                                self.pool.spec.tag,
                                sp["name"],
                                max(0.0, sp["end"] - sp["start"]),
                            )
                elif kind == "result":
                    _, input_id, ok, payload = msg
                    with self.lock:
                        qi = self.active.pop(input_id, None)
                        self.last_active = time.monotonic()
                        self.inputs_served += 1
                    if qi is None:
                        continue
                    if ok:
                        _end_dispatch_span(self.pool, qi, "ok")
                        qi.call.set_result(ser.deserialize(payload))
                    else:
                        exc, _tb = ser.deserialize_exception(payload)
                        self.pool.handle_failure(qi, exc)
                elif kind == "bye":
                    break
        except (EOFError, OSError):
            pass
        finally:
            self._on_death()

    def _on_death(self) -> None:
        with self.lock:
            self.dead = True
            orphans = list(self.active.values())
            self.active.clear()
        self.pool.on_container_dead(self, orphans)

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self, graceful: bool = True) -> None:
        with self.lock:
            if self.dead:
                return
        if graceful and self.conn is not None:
            try:
                self.conn.send(("shutdown",))
                return  # reader sees "bye"/EOF and finalizes
            except (BrokenPipeError, OSError):
                pass
        self.kill()

    def kill(self) -> None:
        try:
            self.proc.terminate()
        except Exception:
            pass


class FunctionPool:
    """Autoscaling container pool for one Function (the L3 scheduler unit)."""

    def __init__(self, spec, runner):
        # ``spec`` is a FunctionSpec (function.py); runner is the AppRun owner.
        self.spec = spec
        self.runner = runner
        self.container_config = spec.container_config()
        self.spec_max_concurrent = spec.max_concurrent_inputs
        self.pending: deque[_QueuedInput] = deque()
        self.calls: dict[str, _Call] = {}
        self.containers: list[_Container] = []
        self.boot_crashes = 0
        self.boot_error: BaseException | None = None
        self._inflight_n = 0  # submitted minus completed (the gauge's source)
        # while True, scale-up is capped at one container so the first warm
        # boot can capture a snapshot every later boot restores from
        self._snapshot_gate = bool(self.container_config.snapshot_key)
        self.lock = threading.Lock()
        self.wake = threading.Condition(self.lock)
        self.closed = False
        self.scheduler = threading.Thread(target=self._schedule_loop, daemon=True)
        self.scheduler.start()

    # -- public API ---------------------------------------------------------

    def submit(
        self, method_name: str, args: tuple, kwargs: dict,
        *, priority: str | None = None,
    ) -> _Call:
        # bounded admission (scheduling/admission.py): a spec with
        # max_pending_inputs sheds instead of queueing without limit —
        # the gateway surfaces the ShedError as HTTP 429 + Retry-After
        limit = self.spec.max_pending_inputs
        if limit is not None:
            with self.lock:
                depth = len(self.pending)
            if depth >= limit:
                from ..scheduling.admission import ShedError
                from ..scheduling.policy import DEFAULT_CLASS

                _obs.record_shed(
                    priority or self.spec.priority or DEFAULT_CLASS,
                    "queue_full",
                )
                raise ShedError(
                    "queue_full",
                    1.0 + depth / max(1, limit),
                    f"{self.spec.tag} queue is full ({depth}/{limit})",
                )
        payload = ser.serialize((args, kwargs))
        input_id = f"in-{uuid.uuid4().hex[:16]}"
        call = _Call(input_id, None, self.spec.retries)  # deadline set at dispatch
        qi = _QueuedInput(
            call, method_name, payload, ready_at=time.monotonic(),
            priority=priority or self.spec.priority,
        )
        if _tr.tracing_enabled():
            call.trace_id = input_id
            call.root_span = _tr.Span(
                trace_id=input_id,
                name="call",
                attrs={"function": self.spec.tag, "method": method_name or ""},
            )
            qi.queue_span = _tr.Span(
                trace_id=input_id,
                name="queue",
                parent_id=call.root_span.span_id,
            )
        # register BEFORE queueing: once the input is visible to the
        # scheduler it can complete at any moment, and a finalizer added
        # after completion would never run
        call.add_done_callback(lambda: self._on_call_done(call))
        with self.lock:
            if self.closed:
                raise RuntimeError("app run context is closed")
            self.calls[input_id] = call
            self.pending.append(qi)
            self._inflight_n += 1
            # gauge write under the pool lock: serialized with the
            # completion-side decrement, so the last write always reflects
            # the true count
            _obs.set_inflight(self.spec.tag, self._inflight_n)
            self.wake.notify()
        return call

    def _on_call_done(self, call: _Call) -> None:
        """Completion finalizer (runs inside set_result/set_exception, before
        the caller unblocks): close the root span, observe total latency,
        drop the inflight gauge."""
        with self.lock:
            self._inflight_n = max(0, self._inflight_n - 1)
            _obs.set_inflight(self.spec.tag, self._inflight_n)
        root = call.root_span
        if root is not None:
            call.root_span = None  # idempotence: finalizers never double-record
            dur = root.finish(
                "ok" if call.ok else "error", attempts=call.attempt
            )
            _tr.default_store.record(root)
            _obs.record_phase(self.spec.tag, "total", dur)

    def shutdown(self) -> None:
        with self.lock:
            self.closed = True
            self.wake.notify()
        for c in list(self.containers):
            c.shutdown(graceful=True)
        deadline = time.monotonic() + 5.0
        for c in list(self.containers):
            try:
                c.proc.wait(max(0.05, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                c.kill()
                try:
                    c.proc.wait(2.0)
                except subprocess.TimeoutExpired:
                    c.proc.kill()  # past SIGTERM's grace: no container outlives its pool

    def on_container_ready(self, container: "_Container", info: dict) -> None:
        """Boot telemetry from the container's ``ready`` message: cold-start
        snapshot hit/miss accounting (utils/metrics.py -> prometheus)."""
        result = info.get("snapshot")
        if result and result != "off":
            from ..utils.metrics import record_snapshot_boot

            record_snapshot_boot(
                self.spec.tag, result, captured=info.get("captured", False)
            )

    # -- failure/retry ------------------------------------------------------

    def handle_failure(
        self, qi: _QueuedInput, exc: BaseException, reason: str | None = None
    ) -> None:
        """One failed attempt: requeue per the retry policy or surface the
        exception. ``reason`` labels the retry counter/spans —
        timeout | container_death | user_error (inferred when omitted)."""
        if reason is None:
            reason = (
                "timeout"
                if isinstance(exc, FunctionTimeoutError)
                else "user_error"
            )
        _end_dispatch_span(
            self, qi, "error", reason=reason, error=type(exc).__name__
        )
        retries = qi.call.retries
        qi.call.attempt += 1
        if retries is not None and qi.call.attempt <= retries.max_retries:
            # jittered per input id: replicas that failed together must not
            # retry together (thundering herd — docs/faults.md)
            delay = retries.delay_for_attempt(
                qi.call.attempt, key=qi.call.input_id
            )
            _obs.record_retry(self.spec.tag, reason)
            self._trace_requeue(qi, reason, delay, charged=True)
            qi.started_at = None
            qi.ready_at = time.monotonic() + delay
            with self.lock:
                self.pending.append(qi)
                self.wake.notify()
        else:
            qi.call.set_exception(exc)

    def _trace_requeue(
        self, qi: _QueuedInput, reason: str, delay: float, *, charged: bool
    ) -> None:
        """Record an instantaneous retry marker and reopen the queue span —
        the requeued input's wait (backoff included) is queue time again.
        ``charged=False`` marks a free requeue (collateral victim of another
        input's timeout kill) that isn't counted against the retry budget."""
        call = qi.call
        if call.root_span is None:
            return
        sp = _tr.Span(
            trace_id=call.trace_id,
            name="retry",
            parent_id=call.root_span.span_id,
            attrs={
                "reason": reason,
                "attempt": call.attempt,
                "delay_s": round(delay, 4),
                "charged": charged,
            },
        )
        sp.end = sp.start
        _tr.default_store.record(sp)
        qi.queue_span = _tr.Span(
            trace_id=call.trace_id,
            name="queue",
            parent_id=call.root_span.span_id,
            attrs={"requeue": True},
        )

    def on_container_dead(self, container: _Container, orphans: list[_QueuedInput]) -> None:
        with self.lock:
            if container in self.containers:
                self.containers.remove(container)
            self.wake.notify()
        if not container.ever_ready and container.boot_error is None:
            # Crashed before serving anything (e.g. segfault at import).
            self.boot_crashes += 1
            if self.boot_crashes >= 3:
                err = RuntimeError(
                    f"containers for {self.spec.tag} are crash-looping at boot "
                    f"({self.boot_crashes} consecutive failures)"
                )
                with self.lock:
                    doomed = list(self.pending)
                    self.pending.clear()
                for qi in doomed + orphans:
                    _end_dispatch_span(self, qi, "error", reason="crash_loop")
                    qi.call.set_exception(err)
                return
        elif container.ever_ready:
            self.boot_crashes = 0
        if container.boot_error is not None:
            # Boot failures fail every queued input — nothing will ever run.
            # The pool keeps the error for callers with no input to fail
            # (ServerHandle.serve waiting on a warm replica).
            self.boot_error = container.boot_error
            with self.lock:
                doomed = list(self.pending)
                self.pending.clear()
            for qi in doomed + orphans:
                _end_dispatch_span(self, qi, "error", reason="boot_error")
                qi.call.set_exception(container.boot_error)
            return
        for qi in orphans:
            timed_out = qi.call.deadline and time.monotonic() >= qi.call.deadline
            if timed_out:
                self.handle_failure(
                    qi,
                    FunctionTimeoutError(
                        f"{self.spec.tag} input exceeded timeout={self.spec.timeout}s"
                    ),
                    reason="timeout",
                )
            elif container.kill_reason == "timeout":
                # Collateral victim of a timeout kill: another input on this
                # @concurrent container blew its deadline. Requeue for free —
                # this input did nothing wrong, so it isn't charged an attempt.
                _end_dispatch_span(
                    self, qi, "error", reason="collateral_timeout"
                )
                self._trace_requeue(qi, "collateral_timeout", 0.0, charged=False)
                qi.started_at = None
                qi.call.deadline = None
                qi.ready_at = time.monotonic()
                with self.lock:
                    self.pending.append(qi)
                    self.wake.notify()
            else:
                self.handle_failure(
                    qi,
                    RuntimeError(
                        f"container for {self.spec.tag} died while processing input"
                    ),
                    reason="container_death",
                )

    # -- scheduling loop ----------------------------------------------------

    def _schedule_loop(self) -> None:
        while True:
            with self.lock:
                if self.closed:
                    return
                self.wake.wait(timeout=0.05)
                if self.closed:
                    return
            try:
                self._tick()
            except Exception:
                traceback.print_exc()

    def _tick(self) -> None:
        now = time.monotonic()
        self._enforce_timeouts(now)
        self._dispatch_ready(now)
        self._autoscale(now)
        _maybe_sample_rss()

    def _journal_decision(
        self, action: str, trigger: str, *, containers_before: int,
        containers_after: int, **extra,
    ) -> None:
        """One autoscaler decision into the journal + the decisions counter
        (never raises; runs inside the scheduler tick)."""
        try:
            with self.lock:
                queue_depth = len(self.pending)
                inflight = self._inflight_n
            _journal.default_journal.record(
                _journal.make_record(
                    function=self.spec.tag,
                    action=action,
                    trigger=trigger,
                    queue_depth=queue_depth,
                    inflight=inflight,
                    containers_before=containers_before,
                    containers_after=containers_after,
                    **extra,
                )
            )
            _obs.record_scaler_decision(self.spec.tag, action)
        except Exception:
            _log.warning("journal write failed", exc_info=True)

    def _enforce_timeouts(self, now: float) -> None:
        for c in list(self.containers):
            if (not c.ready.is_set() and not c.dead and c.kill_reason is None
                    and now >= c.boot_deadline):
                # a boot that hangs fails the queued inputs as a boot error
                c.boot_error = TimeoutError(
                    f"container {c.idx} for {self.spec.tag} did not boot within "
                    f"{c.boot_timeout_s:g} s"
                )
                n_live = len([
                    x for x in self.containers
                    if not x.dead and x.kill_reason is None and not x.reaped
                ])
                self._journal_decision(
                    "kill", "boot_timeout",
                    containers_before=n_live,
                    containers_after=n_live - 1,
                    container=c.idx,
                    boot_timeout_s=c.boot_timeout_s,
                )
                c.kill_reason = "boot_timeout"
                c.kill()
                continue
            with c.lock:
                expired = [
                    qi
                    for qi in c.active.values()
                    if qi.call.deadline is not None and now >= qi.call.deadline
                ]
            if expired:
                # The input holds the container's thread; only a kill frees it.
                # on_container_dead() routes actives through timeout handling.
                # A slow-dying child is re-found by later ticks: count the
                # kill only on the tick that initiates it.
                if c.kill_reason is None:
                    _obs.record_container_kill(self.spec.tag, "timeout")
                    # exclude containers already doomed (kill/reap is
                    # async; dead lands later), so two same-tick kills
                    # journal 3->2 then 2->1, not twice 3->2
                    n_live = len([
                        x for x in self.containers
                        if not x.dead and x.kill_reason is None
                        and not x.reaped
                    ])
                    self._journal_decision(
                        "kill", "timeout",
                        containers_before=n_live,
                        containers_after=n_live - 1,
                        container=c.idx,
                        expired_inputs=len(expired),
                    )
                c.kill_reason = "timeout"
                c.kill()

    def _ready_inputs(self, now: float) -> list[_QueuedInput]:
        ready, cancelled = [], []
        with self.lock:
            n = len(self.pending)
            for _ in range(n):
                qi = self.pending.popleft()
                if qi.call.cancelled:
                    cancelled.append(qi)
                elif qi.ready_at <= now:
                    ready.append(qi)
                else:
                    self.pending.append(qi)
        # completion OUTSIDE the lock: set_exception runs the call's done
        # callbacks (trace finalizer, inflight gauge), which re-take it
        for qi in cancelled:
            qi.call.set_exception(InputCancelled(qi.call.input_id))
        # priority classes: interactive dispatches before default before
        # batch when contending for containers (stable sort keeps FIFO
        # within a class — the engine-side fair-share analog for .remote)
        ready.sort(key=lambda qi: CLASS_RANK.get(qi.priority, 1))
        return ready

    def _dispatch_ready(self, now: float) -> None:
        all_ready = self._ready_inputs(now)
        if not all_ready:
            return
        # split by dispatch target: @batched methods coalesce, others go solo
        batch_groups: dict[str, list[_QueuedInput]] = {}
        ready = []
        for qi in all_ready:
            if self.spec.batched_for(qi.method_name) is not None:
                batch_groups.setdefault(qi.method_name, []).append(qi)
            else:
                ready.append(qi)
        for method_name, group in batch_groups.items():
            self._dispatch_batched(group, now, self.spec.batched_for(method_name))
        for i, qi in enumerate(ready):
            # fault points (docs/faults.md): a container dying mid-input or
            # an input blowing its timeout, routed through the SAME retry
            # path real failures take — handle_failure requeues with
            # jittered backoff or surfaces the exception
            if _inject.fire("executor.container_death"):
                self.handle_failure(
                    qi,
                    RuntimeError(
                        f"injected: container for {self.spec.tag} died "
                        "while processing input"
                    ),
                    reason="container_death",
                )
                continue
            if _inject.fire("executor.timeout"):
                self.handle_failure(
                    qi,
                    FunctionTimeoutError(
                        f"injected: {self.spec.tag} input exceeded its "
                        "timeout"
                    ),
                    reason="timeout",
                )
                continue
            target = next((c for c in self.containers if c.capacity() > 0), None)
            if target is None:
                with self.lock:
                    self.pending.extendleft(reversed(ready[i:]))
                return
            if self.spec.single_use_containers:
                # one input per container: retire from rotation at dispatch
                target.retired = True
            try:
                target.dispatch(qi)
            except _ContainerDead as e:
                with self.lock:
                    self.pending.extendleft(reversed(e.still_owned))

    def _dispatch_batched(self, ready: list[_QueuedInput], now: float, cfg) -> None:
        oldest_wait = max((now - qi.ready_at) for qi in ready) if ready else 0
        full = len(ready) >= cfg.max_batch_size
        waited = oldest_wait * 1000.0 >= cfg.wait_ms
        if not (full or waited):
            with self.lock:
                self.pending.extendleft(reversed(ready))
            return
        while ready:
            batch, ready = ready[: cfg.max_batch_size], ready[cfg.max_batch_size :]
            target = next((c for c in self.containers if c.capacity() > 0), None)
            if target is None:
                with self.lock:
                    self.pending.extendleft(reversed(batch + ready))
                return
            try:
                target.dispatch_batch(batch)
            except _ContainerDead as e:
                with self.lock:
                    self.pending.extendleft(reversed(e.still_owned))

    def _snapshot_pending_first_capture(self) -> bool:
        """True while boots should serialize behind the first warm boot: the
        spec wants memory snapshots but the store has no entry yet, so a
        thundering herd of cold boots would all pay the full @enter cost.
        Once a snapshot exists (or the first boot came up without producing
        one — capture failed or state isn't capturable) the gate opens for
        good."""
        if not self._snapshot_gate:
            return False
        from ..snapshot.store import SnapshotStore

        store = SnapshotStore(root=self.container_config.snapshot_dir)
        if store.has(self.container_config.snapshot_key):
            self._snapshot_gate = False
            return False
        if any(c.ever_ready for c in self.containers):
            self._snapshot_gate = False
            return False
        return True

    def _autoscale(self, now: float) -> None:
        with self.lock:
            pending_n = len(self.pending)
        live = [c for c in self.containers if not c.dead and not c.retired]
        booting = [c for c in live if not c.ready.is_set()]
        free_slots = sum(c.capacity() for c in live) + len(booting) * self.spec_max_concurrent
        # scale up
        want = 0
        if pending_n > free_slots:
            want = min(
                self.spec.max_containers - len(live),
                (pending_n - free_slots + self.spec_max_concurrent - 1)
                // self.spec_max_concurrent,
            )
        if want > 0 and self._snapshot_pending_first_capture():
            want = min(want, max(0, 1 - len(live)))
        if want > 0:
            for _ in range(want):
                self._spawn_container()
            self._journal_decision(
                "scale_up", "queue_pressure",
                containers_before=len(live),
                containers_after=len(live) + want,
                free_slots=free_slots,
                spawned=want,
            )
        # keep min_containers warm (snapshot gate: warm one first, the rest
        # boot as restores once the capture lands)
        warm_spawned = 0
        while len([c for c in self.containers if not c.dead]) < self.spec.min_containers:
            if (
                self._snapshot_pending_first_capture()
                and len([c for c in self.containers if not c.dead]) >= 1
            ):
                break
            self._spawn_container()
            warm_spawned += 1
        if warm_spawned:
            n_live = len([c for c in self.containers if not c.dead])
            self._journal_decision(
                "scale_up", "min_containers",
                containers_before=n_live - warm_spawned,
                containers_after=n_live,
                spawned=warm_spawned,
            )
        # scale down
        idle_cut = now - self.spec.scaledown_window
        for c in list(self.containers):
            if c.dead:
                continue
            with c.lock:
                # a container still booting is not idle: reaping it would
                # kill every boot slower than the scaledown window
                idle = c.ready.is_set() and not c.active and c.last_active < idle_cut
                spent = c.retired and not c.active and c.inputs_served > 0
                idle_age = now - c.last_active
            # count only containers not already doomed: shutdown is async
            # (dead lands when the reader sees EOF), so an already-reaped
            # container must neither satisfy min_containers nor inflate the
            # journaled pool trajectory when several reap in one tick
            live_n = len([
                x for x in self.containers
                if not x.dead and not x.reaped and x.kill_reason is None
            ])
            if (idle or spent) and (spent or live_n > self.spec.min_containers):
                if not c.reaped:
                    # journal once per container: later ticks re-send the
                    # graceful shutdown but record no new decision
                    c.reaped = True
                    self._journal_decision(
                        "scale_down",
                        "single_use_spent" if spent else "idle",
                        containers_before=live_n,
                        containers_after=live_n - 1,
                        container=c.idx,
                        idle_ages=[idle_age],
                        scaledown_window_s=self.spec.scaledown_window,
                    )
                c.shutdown(graceful=True)

    def _spawn_container(self) -> None:
        c = _Container(self)
        self.containers.append(c)


# --------------------------------------------------------------------------
# Inline backend — caller-process execution with serialization round-trip
# --------------------------------------------------------------------------


class InlinePool:
    """Runs inputs in the caller process (``MTPU_BACKEND=inline``).

    Preserves the serialization boundary (args/results round-trip through
    pickle) and retry semantics, but shares the caller's interpreter — the
    mode for a caller that keeps the card itself, matching how the
    reference's ``.local()`` behaves but for every invocation kind. A
    ``gpu=`` function runs the container's boot check here too.
    """

    def __init__(self, spec, runner):
        self.spec = spec
        self.runner = runner
        self._obj = None
        self._exit_hooks: list[Callable] = []
        self._lock = threading.Lock()
        self._fn = None

    def _ensure_target(self):
        with self._lock:
            if self._fn is not None:
                return self._fn
            cfg = self.spec.container_config()
            _mount_volumes(cfg.volumes)
            os.environ.update(cfg.env)
            _check_gpus()
            target = ser.function_from_bytes(cfg.fn_bytes)
            if cfg.is_cls:
                from ..snapshot import build_and_enter

                cls, meta = target
                params = ser.deserialize(cfg.cls_params) if cfg.cls_params else {}
                obj, boot = build_and_enter(
                    cls,
                    params,
                    meta,
                    snapshot_key=cfg.snapshot_key,
                    snapshot_dir=cfg.snapshot_dir,
                    tag=cfg.function_tag,
                )
                if boot.get("snapshot", "off") != "off":
                    from ..utils.metrics import record_snapshot_boot

                    record_snapshot_boot(
                        self.spec.tag,
                        boot["snapshot"],
                        captured=boot.get("captured", False),
                    )
                self._obj = obj
                self._exit_hooks = [getattr(obj, n) for n in meta.get("exit", [])]

                def call_fn(method_name, args, kwargs):
                    return getattr(obj, method_name)(*args, **kwargs)

            else:

                def call_fn(method_name, args, kwargs):
                    return target(*args, **kwargs)

            self._fn = call_fn
            return call_fn

    def submit(
        self, method_name: str, args: tuple, kwargs: dict,
        *, priority: str | None = None,
    ) -> _Call:
        del priority  # inline backend runs the call in-process, immediately
        call = _Call(f"in-{uuid.uuid4().hex[:16]}", None, self.spec.retries)
        if _tr.tracing_enabled():
            call.trace_id = call.input_id
            call.root_span = _tr.Span(
                trace_id=call.input_id,
                name="call",
                attrs={
                    "function": self.spec.tag,
                    "method": method_name or "",
                    "backend": "inline",
                },
            )
            call.add_done_callback(lambda: self._finalize_trace(call))

        def phase_span(name: str, start: float, status: str = "ok", **attrs):
            if call.root_span is None:
                return
            sp = _tr.Span(
                trace_id=call.trace_id,
                name=name,
                parent_id=call.root_span.span_id,
                start=start,
                attrs=attrs,
            )
            sp.finish(status)
            _tr.default_store.record(sp)
            _obs.record_phase(self.spec.tag, name, sp.duration)

        def run():
            payload = ser.serialize((args, kwargs))
            attempt = 0
            while True:
                try:
                    a, kw = ser.deserialize(payload)
                    boot_needed = self._fn is None
                    t0 = time.time()
                    fn = self._ensure_target()
                    if boot_needed:
                        phase_span("boot", t0, mode="inline")
                    t0 = time.time()
                    try:
                        result = fn(method_name, a, kw)
                        if inspect.isgenerator(result):
                            n_items = 0
                            for item in result:
                                call.gen_queue.put(
                                    ("item", ser.deserialize(ser.serialize(item)))
                                )
                                n_items += 1
                            phase_span("execute", t0, items=n_items)
                            call.gen_queue.put(("done", None))
                            call.set_result(None)
                        else:
                            phase_span("execute", t0)
                            t0 = time.time()
                            value = ser.deserialize(ser.serialize(result))
                            phase_span("serialize", t0)
                            call.set_result(value)
                    except BaseException:
                        phase_span("execute", t0, status="error")
                        raise
                    return
                except BaseException as e:
                    attempt += 1
                    call.attempt = attempt
                    r = self.spec.retries
                    if r is not None and attempt <= r.max_retries:
                        _obs.record_retry(self.spec.tag, "user_error")
                        time.sleep(
                            min(
                                r.delay_for_attempt(
                                    attempt, key=call.input_id
                                ),
                                0.1,
                            )
                        )
                        continue
                    exc, _tb = ser.deserialize_exception(ser.serialize_exception(e))
                    call.set_exception(exc)
                    return

        threading.Thread(target=run, daemon=True).start()
        return call

    def _finalize_trace(self, call: _Call) -> None:
        root = call.root_span
        if root is None:
            return
        call.root_span = None
        dur = root.finish("ok" if call.ok else "error", attempts=call.attempt)
        _tr.default_store.record(root)
        _obs.record_phase(self.spec.tag, "total", dur)

    def shutdown(self) -> None:
        for hook in self._exit_hooks:
            try:
                hook()
            except Exception:
                traceback.print_exc()


class ClusterPool:
    """Gang scheduling for ``@clustered(size=n)`` functions.

    One ``.remote()`` boots n containers, injects the rank and coordinator
    env (the cluster-info analog of simple_torch_cluster.py:101-111),
    dispatches the same input to all, and resolves with rank 0's return
    value once every rank finishes. Any rank failing fails the call and
    tears the gang down. A container with ``chips_per_host`` above 1 runs
    the function in that many rank processes (module docstring); the
    coordinator is a ``tcp://`` port on this host, rank 0's container."""

    def __init__(self, spec, runner):
        self.spec = spec
        self.runner = runner
        self.container_config = spec.container_config()
        self.spec_max_concurrent = 1
        self.size = spec.cluster_size
        self.chips_per_host = spec.cluster_chips_per_host or (spec.gpu[0].count if spec.gpu else 1)
        self.closed = False
        self._lock = threading.Lock()
        self._active_containers: list[_Container] = []

    def submit(self, method_name: str, args: tuple, kwargs: dict, *, priority: str | None = None) -> _Call:
        del priority  # a gang runs one call at a time; nothing to order
        if self.closed:
            raise RuntimeError("app run context is closed")
        call = _Call(f"in-{uuid.uuid4().hex[:16]}", None, self.spec.retries)
        threading.Thread(target=self._run_gang, args=(call, method_name, args, kwargs), daemon=True).start()
        return call

    # _Container callbacks ---------------------------------------------------

    def handle_failure(self, qi: _QueuedInput, exc: BaseException, reason: str | None = None) -> None:
        qi.call.set_exception(exc)

    def on_container_ready(self, container, info: dict) -> None:
        pass  # gang containers are plain functions; no snapshot boots to record

    def on_container_dead(self, container, orphans: list[_QueuedInput]) -> None:
        err = container.boot_error or RuntimeError(
            f"cluster container rank={container.extra_env.get(CLUSTER_RANK_ENV)} died"
        )
        for qi in orphans:
            qi.call.set_exception(err)

    # gang logic -------------------------------------------------------------

    def _run_gang(self, call: _Call, method_name, args, kwargs) -> None:
        while True:
            try:
                self._run_gang_once(call, method_name, args, kwargs)
                return
            except BaseException as e:
                call.attempt += 1
                r = self.spec.retries
                if (
                    r is not None
                    and call.attempt <= r.max_retries
                    and not call.cancelled
                    and not self.closed
                    # generators stream through the caller's queue as they
                    # run; a retry would duplicate already-delivered items
                    and not self.spec.is_generator
                ):
                    time.sleep(r.delay_for_attempt(call.attempt, key=call.input_id))
                    continue
                call.set_exception(e)
                return

    def _run_gang_once(self, call: _Call, method_name, args, kwargs) -> None:
        from ..parallel import cluster as _cluster

        containers: list[_Container] = []
        try:
            coord = f"127.0.0.1:{_cluster.free_port()}"
            ips = ",".join(["127.0.0.1"] * self.size)
            payload = ser.serialize((args, kwargs))
            for rank in range(self.size):
                if self.closed:
                    raise RuntimeError("app run context is closed")
                extra = {
                    _cluster.RANK_ENV: str(rank),
                    _cluster.SIZE_ENV: str(self.size),
                    _cluster.COORD_ENV: coord,
                    _cluster.IPS_ENV: ips,
                    _cluster.CHIPS_ENV: str(self.chips_per_host),
                }
                c = _Container(self, extra_env=extra)
                containers.append(c)
                with self._lock:
                    self._active_containers.append(c)

            boot_deadline = time.monotonic() + BOOT_TIMEOUT_S
            while True:
                if call.cancelled:
                    raise InputCancelled(call.input_id)
                dead = next((c for c in containers if c.dead or c.boot_error is not None), None)
                if dead is not None:
                    raise dead.boot_error or RuntimeError("cluster container died during boot")
                if all(c.ready.is_set() for c in containers):
                    break
                if time.monotonic() > boot_deadline:
                    raise TimeoutError(f"cluster containers failed to boot within {BOOT_TIMEOUT_S:g}s")
                time.sleep(0.05)

            rank_calls = []
            deadline = time.monotonic() + self.spec.timeout if self.spec.timeout else None
            for rank, c in enumerate(containers):
                sub = _Call(f"{call.input_id}-r{rank}", deadline, None)
                if rank == 0:
                    # rank 0's yields stream straight through to the caller,
                    # so @clustered generator functions work like plain ones
                    sub.gen_queue = call.gen_queue
                c.dispatch(_QueuedInput(sub, method_name, payload))
                rank_calls.append(sub)
            # fail fast: any rank failing (or dying) fails the whole gang;
            # don't block on rank 0 while another rank deadlocks a collective
            pending = set(rank_calls)
            while pending:
                if call.cancelled:
                    raise InputCancelled(call.input_id)
                if deadline is not None and time.monotonic() > deadline:
                    raise FunctionTimeoutError(f"{self.spec.tag} gang exceeded timeout={self.spec.timeout}s")
                for sub in list(pending):
                    if sub.done.wait(0.02):
                        pending.discard(sub)
                        if not sub.ok:
                            raise sub.exc
            call.set_result(rank_calls[0].value)
        finally:
            for c in containers:
                c.shutdown(graceful=True)
            deadline = time.monotonic() + 5.0
            for c in containers:
                try:
                    c.proc.wait(max(0.05, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    c.kill()
            with self._lock:
                for c in containers:
                    if c in self._active_containers:
                        self._active_containers.remove(c)

    def shutdown(self) -> None:
        self.closed = True
        with self._lock:
            containers = list(self._active_containers)
        for c in containers:
            c.kill()
        deadline = time.monotonic() + 5.0
        for c in containers:
            try:
                c.proc.wait(max(0.05, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass


def make_pool(spec, runner):
    if spec.cluster_size > 0:  # any @clustered function, including size=1
        return ClusterPool(spec, runner)
    if _config.backend() == "inline" or spec.force_inline:
        return InlinePool(spec, runner)
    return FunctionPool(spec, runner)
