"""Function — the serverless unit, with every reference invocation mode;
after ``modal_examples_tpu/core/function.py``, with ``gpu=`` in place of
``tpu=``.

Reference spec (SURVEY.md §2.1 "Invocation modes"):
``.local`` / ``.remote`` / ``.map`` (hello_world.py:56-69), ``.remote_gen``
(generators.py:21), ``.starmap`` (hp_sweep_gpt.py:320), ``.spawn`` + ``.get``
(parallel_execution.py:33-48, long-training.py:153), ``.for_each``
(inference_map.py:39), ``FunctionCall.from_id`` / ``gather``
(poll_delayed_result.py, parallel_execution.py), and async ``.aio`` variants
(08_advanced/dynamic_batching.py:81-93).

Resource/scheduling options mirror ``@app.function(...)``
(unsloth_finetune.py:276-289): ``gpu=`` (core/resources.py), image, volumes,
secrets, timeout, retries, max/min_containers, scaledown_window,
single_use_containers, schedule, and the ``@concurrent`` / ``@batched``
markers.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import inspect
import os
import pickle
import queue as _queue
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

from .._internal import config as _config
from . import executor as _exec
from . import serialization as ser
from .image import DEFAULT_IMAGE, Image
from .resources import GPU_SPEC_ENV, GPUSpec, format_gpu_request
from .retries import Retries
from .schedules import Schedule


@dataclasses.dataclass
class BatchedConfig:
    max_batch_size: int
    wait_ms: int


def batched(*, max_batch_size: int, wait_ms: int = 10) -> Callable:
    """``@batched`` — server-side dynamic batching (dynamic_batching.py:29)."""

    def deco(fn):
        fn.__mtpu_batched__ = BatchedConfig(max_batch_size, wait_ms)
        return fn

    return deco


def concurrent(*, max_inputs: int, target_inputs: int | None = None) -> Callable:
    """``@concurrent`` — input concurrency per container (text_to_image.py:238).

    Works on functions and on ``@app.cls`` classes (applied under the app
    decorator, like the reference stacks them).
    """

    def deco(fn_or_cls):
        fn_or_cls.__mtpu_concurrent__ = max_inputs
        fn_or_cls.__mtpu_target_concurrent__ = target_inputs or max_inputs
        return fn_or_cls

    return deco


@dataclasses.dataclass
class FunctionSpec:
    """Fully-resolved execution spec for one Function (or one Cls)."""

    tag: str
    app_name: str
    raw_target: Any  # callable, or (cls, lifecycle meta) for Cls pools
    is_cls_method: bool = False
    cls_params_bytes: bytes | None = None
    gpu: list[GPUSpec] = dataclasses.field(default_factory=list)
    cpu: float | None = None
    memory: int | None = None
    image: Image = dataclasses.field(default_factory=lambda: DEFAULT_IMAGE)
    volumes: dict[str, Any] = dataclasses.field(default_factory=dict)
    secrets: list[Any] = dataclasses.field(default_factory=list)
    timeout: float | None = 300.0
    retries: Retries | None = None
    max_containers: int = 8
    min_containers: int = 0
    scaledown_window: float = 60.0
    single_use_containers: bool = False
    max_concurrent_inputs: int = 1
    batched: BatchedConfig | None = None
    schedule: Schedule | None = None
    methods_meta: dict | None = None  # Cls: per-method {batched, is_generator}
    is_generator: bool = False
    web: dict | None = None
    #: the region the function is pinned to, carried on the spec as the
    #: JAX package carries it (placement reads no region on one host)
    region: str | None = None
    force_inline: bool = False
    #: scheduling class for this function's inputs (interactive|default|
    #: batch); per-call override via .remote(..., priority=)
    priority: str = "default"
    #: bound on queued (undispatched) inputs; None = unbounded. Exceeding it
    #: sheds: pool.submit raises ShedError, the gateway answers 429.
    max_pending_inputs: int | None = None
    enable_memory_snapshot: bool = False
    serialized: bool = False  # ship-by-value parity flag (reference: serialized=True)
    experimental_options: dict = dataclasses.field(default_factory=dict)
    cluster_size: int = 0  # >0: gang-scheduled containers (@clustered)
    cluster_chips_per_host: int | None = None  # rank processes a container (the cards of a host)

    def container_config(self) -> _exec.ContainerConfig:
        env: dict[str, str] = {}
        env.update(self.image.env_vars())
        for s in self.secrets:
            env.update(s.env_vars())
        if self.gpu:
            # the container checks its cards against this list at boot
            env[GPU_SPEC_ENV] = format_gpu_request(self.gpu)
        volumes = []
        for mount_path, vol in self.volumes.items():
            volumes.append((mount_path, str(vol.local_path)))
        sys_paths = self.image.sys_path_additions() + self._source_dirs()
        fn_bytes = ser.function_to_bytes(self.raw_target)
        snapshot_key = snapshot_dir = None
        if self.enable_memory_snapshot and self.is_cls_method:
            # key + store root are resolved client-side so the supervisor (the
            # autoscaler's first-warm-boot gate) and the container agree on
            # exactly which entry a boot will hit; the gpu= request is in
            # env, so a gpu= container never shares an entry with one
            # without gpu=
            from ..snapshot.store import (
                compute_snapshot_key,
                default_root,
                source_hash_for,
            )

            snapshot_key = compute_snapshot_key(
                image_digest=self.image.digest(),
                source_hash=source_hash_for(self.raw_target, fn_bytes),
                env=env,
                cls_params=self.cls_params_bytes,
            )
            snapshot_dir = str(default_root())
        return _exec.ContainerConfig(
            function_tag=self.tag,
            fn_bytes=fn_bytes,
            is_cls=self.is_cls_method,
            cls_params=self.cls_params_bytes,
            env=env,
            sys_paths=sys_paths,
            max_concurrent_inputs=self.max_concurrent_inputs,
            volumes=volumes,
            snapshot_key=snapshot_key,
            snapshot_dir=snapshot_dir,
        )

    def batched_for(self, method_name: str) -> "BatchedConfig | None":
        """Batching config for one dispatch target (per-method on a Cls)."""
        if self.is_cls_method and self.methods_meta is not None:
            return (self.methods_meta.get(method_name) or {}).get("batched")
        return self.batched

    def _source_dirs(self) -> list[str]:
        """Dir of the module defining the function/class, so the container
        imports it (the function goes by reference, core/serialization.py) —
        the local analog of the platform mounting the user's source into the
        container (SURVEY.md §3.1: container imports module).
        """
        target = self.raw_target[0] if self.is_cls_method else self.raw_target
        try:
            src = inspect.getsourcefile(target)
        except TypeError:
            src = None
        if not src:
            return []
        # walk up past package __init__.py files so 'import pkg.sub' resolves
        # (and so we never put a package's own dir on sys.path, which would
        # let sibling modules shadow stdlib names)
        d = os.path.dirname(os.path.abspath(src))
        while os.path.exists(os.path.join(d, "__init__.py")):
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
        return [d]

    def pool_key(self) -> str:
        import hashlib

        params = self.cls_params_bytes or b""
        return f"{self.tag}:{hashlib.sha1(params).hexdigest()[:8]}"


# --------------------------------------------------------------------------
# FunctionCall — spawned-call handle
# --------------------------------------------------------------------------

_local_calls: dict[str, _exec._Call] = {}
_local_calls_lock = threading.Lock()


#: Spawned-call results are retained this long (reference: 7-day retention of
#: spawned results, amazon_embeddings.py:18).
_CALL_RETENTION_S = 7 * 86400
_last_gc = [0.0]


def _calls_dir() -> Path:
    p = _config.state_dir() / "calls"
    p.mkdir(parents=True, exist_ok=True)
    now = time.monotonic()
    if now - _last_gc[0] > 300:  # opportunistic sweep, at most every 5 min
        _last_gc[0] = now
        cutoff = time.time() - _CALL_RETENTION_S
        for f in p.glob("fc-*.pkl"):
            try:
                if f.stat().st_mtime < cutoff:
                    f.unlink()
            except OSError:
                pass
    return p


class FunctionCall:
    """Handle to a spawned input; survives across processes via the state dir.

    Reference: ``call = f.spawn(x)``; later ``call.get(timeout=...)`` or
    ``FunctionCall.from_id(call_id)`` from a *different* process
    (08_advanced/poll_delayed_result.py). Spawned results persist (reference:
    up to 7 days, amazon_embeddings.py:18); ours persist in the state dir
    until garbage-collected.
    """

    def __init__(self, object_id: str):
        self.object_id = object_id
        #: the underlying input id == trace id (the gateway's ``/traces/<id>``);
        #: None on handles rehydrated via from_id in another process
        self.call_id: str | None = None

    @classmethod
    def _register(cls, call: _exec._Call) -> "FunctionCall":
        object_id = f"fc-{uuid.uuid4().hex[:16]}"
        with _local_calls_lock:
            _local_calls[object_id] = call
        record = _calls_dir() / f"{object_id}.pkl"

        def persist():
            call.done.wait()
            try:
                if call.ok:
                    payload = ("ok", ser.serialize(call.value))
                else:
                    payload = ("err", ser.serialize_exception(call.exc))
                # atomic publish: cross-process readers poll exists()+read
                tmp = record.with_suffix(f".tmp.{os.getpid()}")
                tmp.write_bytes(pickle.dumps(payload))
                os.replace(tmp, record)
            except Exception:
                pass
            finally:
                # result is durable on disk; drop the in-memory handle so
                # long-lived spawn loops don't accumulate _Call objects
                with _local_calls_lock:
                    _local_calls.pop(object_id, None)

        threading.Thread(target=persist, daemon=True).start()
        fc = cls(object_id)
        fc.call_id = call.input_id
        return fc

    @classmethod
    def from_id(cls, object_id: str) -> "FunctionCall":
        return cls(object_id)

    def get(self, timeout: float | None = None):
        with _local_calls_lock:
            call = _local_calls.get(self.object_id)
        if call is not None:
            return call.result(timeout)
        # cross-process: poll the persisted record
        record = _calls_dir() / f"{self.object_id}.pkl"
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if record.exists():
                kind, payload = pickle.loads(record.read_bytes())
                if kind == "ok":
                    return ser.deserialize(payload)
                exc, _tb = ser.deserialize_exception(payload)
                raise exc
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"function call {self.object_id} still running")
            time.sleep(0.05)

    def cancel(self) -> None:
        with _local_calls_lock:
            call = _local_calls.get(self.object_id)
        if call is not None:
            call.cancelled = True

    async def get_async(self, timeout: float | None = None):
        return await asyncio.to_thread(self.get, timeout)


class _FCGather:
    def __call__(self, *calls: FunctionCall):
        return [c.get() for c in calls]

    async def aio(self, *calls: FunctionCall):
        return await asyncio.gather(*(c.get_async() for c in calls))


gather = _FCGather()


# --------------------------------------------------------------------------
# Invoker descriptors: f.remote(...) callable with f.remote.aio(...)
# --------------------------------------------------------------------------


class _Invoker:
    def __init__(self, sync_fn: Callable, aio_fn: Callable | None = None):
        self._sync = sync_fn
        self._aio = aio_fn

    def __call__(self, *args, **kwargs):
        return self._sync(*args, **kwargs)

    def aio(self, *args, **kwargs):
        if self._aio is not None:
            return self._aio(*args, **kwargs)
        return asyncio.to_thread(self._sync, *args, **kwargs)


class _GenInvoker(_Invoker):
    def aio(self, *args, **kwargs):
        sync_gen = self._sync(*args, **kwargs)

        async def agen():
            loop = asyncio.get_running_loop()
            it = iter(sync_gen)
            sentinel = object()
            while True:
                item = await loop.run_in_executor(None, next, it, sentinel)
                if item is sentinel:
                    return
                yield item

        return agen()


# --------------------------------------------------------------------------
# Function
# --------------------------------------------------------------------------


def split_priority(target: Callable, kwargs: dict) -> tuple[str | None, dict]:
    """Pop the reserved ``priority=`` scheduling kwarg from a ``.remote``
    call — UNLESS the user function declares its own ``priority`` parameter
    (or ``**kwargs``), in which case the name belongs to the function and
    scheduling falls back to the spec default."""
    if "priority" not in kwargs:
        return None, kwargs
    try:
        params = inspect.signature(target).parameters
    except (TypeError, ValueError):
        return None, kwargs
    if "priority" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    ):
        return None, kwargs
    from ..scheduling.policy import validate_class

    rest = dict(kwargs)
    # a typo'd class must fail HERE at the call site, not silently degrade
    # to default rank inside the pool
    return validate_class(rest.pop("priority")), rest


class Function:
    """A registered serverless function bound to an App."""

    def __init__(self, app, raw_f: Callable, spec: FunctionSpec):
        self.app = app
        self.raw_f = raw_f
        self.spec = spec
        functools.update_wrapper(self, raw_f)
        self.remote = _Invoker(self._remote)
        self.remote_gen = _GenInvoker(self._remote_gen)
        self.map = _GenInvoker(self._map)
        self.starmap = _GenInvoker(self._starmap)
        self.spawn = _Invoker(self._spawn)
        self.for_each = _Invoker(self._for_each)

    # direct call == local call (matching reference ergonomics for plain fns)
    def __call__(self, *args, **kwargs):
        return self.raw_f(*args, **kwargs)

    def local(self, *args, **kwargs):
        return self.raw_f(*args, **kwargs)

    @property
    def is_generator(self) -> bool:
        return self.spec.is_generator

    def _pool(self):
        from .app import current_run

        return current_run(self.app).pool_for(self.spec)

    def _submit(self, args, kwargs) -> _exec._Call:
        # .remote(..., priority="interactive"): reserved scheduling kwarg
        # (skipped when the user function declares its own `priority`)
        priority, kwargs = split_priority(self.raw_f, kwargs)
        return self._pool().submit("", args, kwargs, priority=priority)

    def _remote(self, *args, **kwargs):
        call = self._submit(args, kwargs)
        if self.spec.is_generator:
            # .remote on a generator function: drain and return list-like
            return list(_drain_gen(call))
        return call.result()

    def _remote_gen(self, *args, **kwargs) -> Iterator:
        call = self._submit(args, kwargs)
        return _drain_gen(call)

    def _spawn(self, *args, **kwargs) -> FunctionCall:
        return FunctionCall._register(self._submit(args, kwargs))

    def _map(
        self,
        *input_iterators: Iterable,
        order_outputs: bool = True,
        return_exceptions: bool = False,
        wrap_returned_exceptions: bool = False,
    ) -> Iterator:
        inputs = zip(*input_iterators) if len(input_iterators) > 1 else (
            (x,) for x in input_iterators[0]
        )
        return self._run_many(
            list(inputs), order_outputs, return_exceptions
        )

    def _starmap(
        self,
        input_iterator: Iterable[tuple],
        *,
        order_outputs: bool = True,
        return_exceptions: bool = False,
    ) -> Iterator:
        return self._run_many(
            [tuple(t) for t in input_iterator], order_outputs, return_exceptions
        )

    def _for_each(self, *input_iterators: Iterable, ignore_exceptions: bool = False):
        for _ in self._map(
            *input_iterators,
            order_outputs=False,
            return_exceptions=ignore_exceptions,
        ):
            pass

    def _run_many(
        self, arg_tuples: list[tuple], order_outputs: bool, return_exceptions: bool
    ) -> Iterator:
        pool = self._pool()
        return run_many(
            lambda args: pool.submit("", args, {}),
            arg_tuples,
            order_outputs,
            return_exceptions,
        )

    # -- web ----------------------------------------------------------------

    def get_web_url(self) -> str | None:
        if self.spec.web is None:
            return None
        from ..web.registry import web_url_for

        return web_url_for(self.spec)

    @property
    def web_url(self) -> str | None:
        return self.get_web_url()

    @staticmethod
    def from_name(app_name: str, name: str, environment_name: str | None = None) -> "Function":
        from .app import App

        return App.lookup(app_name).registered_functions[name]

    def __repr__(self) -> str:
        return f"Function({self.spec.tag!r})"


def run_many(
    submit: Callable[[tuple], _exec._Call],
    arg_tuples: list[tuple],
    order_outputs: bool,
    return_exceptions: bool,
) -> Iterator:
    """Shared fan-out loop for .map/.starmap/.for_each (Function and Cls)."""
    calls = [submit(args) for args in arg_tuples]
    if order_outputs:
        ordered: Iterable[_exec._Call] = calls
    else:
        done_q: _queue.Queue = _queue.Queue()
        for c in calls:
            threading.Thread(
                target=lambda c=c: (c.done.wait(), done_q.put(c)), daemon=True
            ).start()
        ordered = (done_q.get() for _ in range(len(calls)))
    for c in ordered:
        try:
            yield c.result()
        except BaseException as e:
            if return_exceptions:
                yield e
            else:
                raise


def _drain_gen(call: _exec._Call) -> Iterator:
    while True:
        kind, item = call.gen_queue.get()
        if kind == "item":
            yield item
        elif kind == "done":
            return
        else:  # ("error", exc)
            raise item
