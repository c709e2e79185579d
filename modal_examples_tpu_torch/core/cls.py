"""Cls — stateful load-once-serve-many services with lifecycle hooks; after
``modal_examples_tpu/core/cls.py``.

Reference spec: ``@app.cls`` + ``@modal.enter`` / ``@modal.method`` /
``@modal.exit`` (stable_diffusion/text_to_image.py:92-137);
``@modal.enter(snap=True)`` for snapshot-eligible setup (gpu_snapshot.py:47);
typed instance parameters via ``modal.parameter()`` (9 uses);
``Cls.with_options(gpu=...)`` (cls_with_options.py:57); ``Cls.from_name``
(gpu_snapshot.py:64).

``@enter`` is where weights go to the card and the kernels load (the
port's are built once per checkout, ``ops/_build.py``) — the reference's
pipeline load and CUDA warmup. The container then serves many inputs against
the resident state. With ``enable_memory_snapshot=True``, the ``snap=True``
hooks run only until a boot has captured their state (``snapshot/``): later
boots restore it, tensors back onto the container's card, and run the other
hooks.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
from typing import Any, Callable

from . import serialization as ser
from .function import FunctionSpec, _Invoker, _GenInvoker, FunctionCall, _drain_gen

_LIFECYCLE_ATTR = "__mtpu_lifecycle__"


def method(*, is_generator: bool | None = None) -> Callable:
    def deco(fn):
        fn.__mtpu_method__ = {
            "is_generator": (
                inspect.isgeneratorfunction(fn) if is_generator is None else is_generator
            )
        }
        return fn

    return deco


def enter(*, snap: bool = False) -> Callable:
    """Lifecycle hook run once at container start (before any input).

    ``snap=True`` marks the hook as snapshot-eligible: its effects (weights on
    the card) are captured after the first warm boot (``enable_memory_snapshot
    =True``) by the memory-snapshot layer so later cold starts resume past it
    (gpu_snapshot.py:41-47 analog). Such hooks run first.
    """

    def deco(fn):
        fn.__mtpu_enter__ = {"snap": snap}
        return fn

    return deco


def exit() -> Callable:
    def deco(fn):
        fn.__mtpu_exit__ = True
        return fn

    return deco


@dataclasses.dataclass
class _Parameter:
    default: Any = None
    init: bool = True


def parameter(*, default: Any = None, init: bool = True) -> Any:
    return _Parameter(default=default, init=init)


def _collect_lifecycle(user_cls: type) -> dict:
    meta = {"enter": [], "exit": [], "methods": {}, "parameters": {}}
    for name, member in inspect.getmembers(user_cls):
        if hasattr(member, "__mtpu_enter__"):
            meta["enter"].append(name)
        if hasattr(member, "__mtpu_exit__"):
            meta["exit"].append(name)
        if hasattr(member, "__mtpu_method__"):
            meta["methods"][name] = dict(member.__mtpu_method__)
            if hasattr(member, "__mtpu_batched__"):
                meta["methods"][name]["batched"] = member.__mtpu_batched__
        if getattr(member, "__mtpu_web__", None):
            meta["methods"].setdefault(name, {"is_generator": False})
    for name, val in list(vars(user_cls).items()):
        if isinstance(val, _Parameter):
            meta["parameters"][name] = val
            setattr(user_cls, name, val.default)
    # run snap=True enters first, matching snapshot-restore ordering
    meta["enter"].sort(
        key=lambda n: not getattr(getattr(user_cls, n), "__mtpu_enter__", {}).get(
            "snap", False
        )
    )
    # snapshot-eligible hooks, in run order (the memory-snapshot layer skips
    # these on a restored boot; see modal_examples_tpu_torch.snapshot)
    meta["snap_enter"] = [
        n
        for n in meta["enter"]
        if getattr(getattr(user_cls, n), "__mtpu_enter__", {}).get("snap", False)
    ]
    return meta


class _BoundMethod:
    """``obj.generate`` — carries .remote/.local/.spawn/.map for one method."""

    def __init__(self, obj: "Obj", name: str, is_generator: bool):
        self._obj = obj
        self._name = name
        self.is_generator = is_generator
        self.remote = (_GenInvoker if is_generator else _Invoker)(self._remote)
        self.remote_gen = _GenInvoker(self._remote_gen)
        self.map = _GenInvoker(self._map)
        self.starmap = _GenInvoker(self._starmap)
        self.spawn = _Invoker(self._spawn)
        self.for_each = _Invoker(self._for_each)

    def local(self, *args, **kwargs):
        return getattr(self._obj._local_instance(), self._name)(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        return self.local(*args, **kwargs)

    def _submit(self, args, kwargs):
        from .function import split_priority

        target = getattr(self._obj._cls._user_cls, self._name, None)
        priority, kwargs = split_priority(target, kwargs)
        return self._obj._pool().submit(
            self._name, args, kwargs, priority=priority
        )

    def _remote(self, *args, **kwargs):
        call = self._submit(args, kwargs)
        if self.is_generator:
            return _drain_gen(call)
        return call.result()

    def _remote_gen(self, *args, **kwargs):
        return _drain_gen(self._submit(args, kwargs))

    def _spawn(self, *args, **kwargs) -> FunctionCall:
        return FunctionCall._register(self._submit(args, kwargs))

    def _map(self, *iters, order_outputs=True, return_exceptions=False):
        inputs = zip(*iters) if len(iters) > 1 else ((x,) for x in iters[0])
        yield from self._run_many(list(inputs), order_outputs, return_exceptions)

    def _starmap(self, it, *, order_outputs=True, return_exceptions=False):
        yield from self._run_many(
            [tuple(t) for t in it], order_outputs, return_exceptions
        )

    def _for_each(self, *iters, ignore_exceptions=False):
        for _ in self._map(
            *iters, order_outputs=False, return_exceptions=ignore_exceptions
        ):
            pass

    def _run_many(self, arg_tuples, order_outputs, return_exceptions):
        from .function import run_many

        yield from run_many(
            lambda args: self._submit(args, {}),
            arg_tuples,
            order_outputs,
            return_exceptions,
        )


class Obj:
    """A parameterized instance handle of a Cls (client side)."""

    def __init__(self, cls: "Cls", params: dict[str, Any]):
        self._cls = cls
        self._params = params
        self._local_obj = None
        self._local_lock = threading.Lock()

    def _spec(self) -> FunctionSpec:
        spec = dataclasses.replace(
            self._cls._spec,
            cls_params_bytes=ser.serialize(self._params) if self._params else None,
        )
        return spec

    def _pool(self):
        from .app import current_run

        return current_run(self._cls._app).pool_for(self._spec())

    def _local_instance(self):
        with self._local_lock:
            if self._local_obj is None:
                obj = self._cls._user_cls()
                for k, v in self._params.items():
                    setattr(obj, k, v)
                for name in self._cls._meta["enter"]:
                    getattr(obj, name)()
                self._local_obj = obj
            return self._local_obj

    def __getattr__(self, name: str):
        meta = self._cls._meta
        if name in meta["methods"]:
            return _BoundMethod(self, name, meta["methods"][name]["is_generator"])
        raise AttributeError(
            f"{self._cls._user_cls.__name__}.{name} is not a @method"
        )


class Cls:
    """Client-side handle for an ``@app.cls``-decorated class."""

    def __init__(self, app, user_cls: type, spec: FunctionSpec, meta: dict):
        self._app = app
        self._user_cls = user_cls
        self._spec = spec
        self._meta = meta

    def __call__(self, **params) -> Obj:
        known = self._meta["parameters"]
        unknown = set(params) - set(known)
        if unknown:
            raise TypeError(
                f"{self._user_cls.__name__}() got unexpected parameters {sorted(unknown)}; "
                f"declare them with modal.parameter()"
            )
        resolved = {k: p.default for k, p in known.items()}
        resolved.update(params)
        return Obj(self, resolved)

    def with_options(self, *, gpu=None, retries=None, **kw) -> "Cls":
        """Override resource/scheduling options (cls_with_options.py:57).

        Any FunctionSpec scheduling field can be overridden; unknown options
        raise rather than being silently dropped, and so do ``tpu=`` and the
        options whose subsystems the port lacks (``core/app.py``).
        """
        from .app import refuse_waiting_options
        from .resources import parse_gpu_request
        from .retries import normalize_retries

        refuse_waiting_options(kw)
        spec = dataclasses.replace(self._spec)
        if gpu is not None:
            spec.gpu = parse_gpu_request(gpu)
        if retries is not None:
            spec.retries = normalize_retries(retries)
        valid = {f.name for f in dataclasses.fields(spec)} - {
            "tag", "app_name", "raw_target", "is_cls_method", "cls_params_bytes",
        }
        for key, value in kw.items():
            if key not in valid:
                raise TypeError(
                    f"with_options got unknown option {key!r}; valid: {sorted(valid)}"
                )
            setattr(spec, key, value)
        return Cls(self._app, self._user_cls, spec, self._meta)

    @staticmethod
    def from_name(app_name: str, name: str, environment_name: str | None = None) -> "Cls":
        from .app import App

        app = App.lookup(app_name)
        try:
            return app.registered_classes[name]
        except KeyError:
            raise KeyError(
                f"class {name!r} not found in app {app_name!r}; "
                f"registered: {sorted(app.registered_classes)}"
            ) from None

    # lifecycle-free attribute passthrough for introspection
    @property
    def user_cls(self) -> type:
        return self._user_cls

    def __repr__(self) -> str:
        return f"Cls({self._spec.tag!r})"
