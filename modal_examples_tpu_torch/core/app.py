"""App — unit of deployment; registry of functions, classes, entrypoints;
after ``modal_examples_tpu/core/app.py``, with ``gpu=`` in place of ``tpu=``.

Reference spec: ``app = modal.App("name", image=..., secrets=...)``
(hello_world.py:18); ``@app.function`` / ``@app.cls`` /
``@app.local_entrypoint`` decorators; ``with app.run():`` for script-driven
ephemeral apps (import_sklearn.py:51); ``App.lookup(name,
create_if_missing=True)`` for programmatic apps (safe_code_execution.py:21);
``app.registered_functions`` used by the generic profiler wrapper
(torch_profiling.py:131-135); ``modal run/deploy/serve`` CLI (README.md:17-21),
here ``python -m modal_examples_tpu_torch run|deploy|serve``.

A *run context* owns the container pools; entering one (explicitly via
``app.run()`` or implicitly on the first ``.remote``) is the local analog of
starting an ephemeral app on the platform. ``app.deploy()`` records the app in
the state-dir registry so other processes can ``lookup``/``from_name`` it and
the scheduler daemon can fire its cron/period functions.

Options whose subsystems the port lacks raise, naming their ROADMAP item
(:data:`WAITING_OPTIONS`); ``tpu=`` raises naming ``gpu=``.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime as _dt
import inspect
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable

from .._internal import config as _config
from . import executor as _exec
from .cls import Cls, _collect_lifecycle
from .function import Function, FunctionSpec
from .image import DEFAULT_IMAGE, Image
from .resources import parse_gpu_request
from .retries import normalize_retries
from .schedules import Schedule


def _registry_path() -> Path:
    return _config.state_dir() / "apps.json"


def _validate_priority(priority: str) -> None:
    from ..scheduling.policy import validate_class

    validate_class(priority)


#: options the port refuses until their subsystem lands: name -> what waits
#: (empty since ``@clustered`` landed with ROADMAP A10)
WAITING_OPTIONS: dict[str, str] = {}


def refuse_waiting_options(options: dict) -> None:
    """Raise for ``tpu=`` and for a set option of :data:`WAITING_OPTIONS`."""
    if options.get("tpu") is not None:
        raise ValueError(
            "this port runs on NVIDIA GPUs: use gpu='H100' (see "
            "modal_examples_tpu_torch.core.resources), not tpu=..."
        )
    for key, why in WAITING_OPTIONS.items():
        if options.get(key):
            raise NotImplementedError(f"{key}=: {why}")


#: All App objects instantiated in this process, by name (for App.lookup).
_app_instances: dict[str, "App"] = {}


class AppRun:
    """Holds the live container pools for one app run."""

    def __init__(self, app: "App", detach: bool = False):
        self.app = app
        self.detach = detach
        self._pools: dict[str, Any] = {}
        self._lock = threading.Lock()
        self.closed = False

    def pool_for(self, spec: FunctionSpec):
        key = spec.pool_key()
        with self._lock:
            if self.closed:
                raise RuntimeError("app run context is closed")
            pool = self._pools.get(key)
            if pool is None:
                pool = _exec.make_pool(spec, self)
                self._pools[key] = pool
            return pool

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            pools = list(self._pools.values())
        for p in pools:
            p.shutdown()
        # this run's series outlive the process through the file push
        # gateway (observability/export.py): the CLI's ``metrics`` and a
        # gateway's ``/metrics`` read the pushed exposition later
        try:
            from ..observability.export import push_metrics_file

            push_metrics_file(f"app-{self.app.name}-{os.getpid()}")
        except Exception:
            pass  # metrics must never break shutdown


class _LocalEntrypoint:
    def __init__(self, app: "App", fn: Callable):
        self.app = app
        self.raw_f = fn
        self.__name__ = fn.__name__
        self.__doc__ = fn.__doc__

    def __call__(self, *args, **kwargs):
        with self.app.run():
            return self.raw_f(*args, **kwargs)


class App:
    def __init__(
        self,
        name: str | None = None,
        *,
        image: Image | None = None,
        secrets: list | None = None,
        volumes: dict | None = None,
        include_source: bool = True,
    ):
        self.name = name or "anonymous-app"
        self.image = image or DEFAULT_IMAGE
        self.secrets = list(secrets or [])
        self.volumes = dict(volumes or {})
        self.registered_functions: dict[str, Function] = {}
        self.registered_classes: dict[str, Cls] = {}
        self.registered_entrypoints: dict[str, _LocalEntrypoint] = {}
        self.registered_web_endpoints: list[str] = []
        self._current_run: AppRun | None = None
        self._implicit_run: AppRun | None = None
        _app_instances[self.name] = self

    def __getstate__(self):
        """Serialize the app DEFINITION, not its runtime: live runs hold
        container pools, threads, and locks (unpicklable, and meaningless in
        another process). A Function handle captured in a spawned function's
        globals (launcher patterns: amazon_embeddings.py:108-112) rehydrates
        against the receiving process's own run context."""
        d = self.__dict__.copy()
        d["_current_run"] = None
        d["_implicit_run"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        _app_instances.setdefault(self.name, self)

    # -- decorators ---------------------------------------------------------

    def function(
        self,
        *,
        gpu: str | list[str] | None = None,
        tpu: Any = None,  # explicit error below: the port runs on GPUs
        cpu: float | None = None,
        memory: int | None = None,
        image: Image | None = None,
        volumes: dict | None = None,
        secrets: list | None = None,
        timeout: float | None = 300.0,
        retries=None,
        max_containers: int = 8,
        min_containers: int = 0,
        scaledown_window: float = 60.0,
        single_use_containers: bool = False,
        schedule: Schedule | None = None,
        region: str | None = None,
        name: str | None = None,
        serialized: bool = False,
        priority: str = "default",
        max_pending_inputs: int | None = None,
        enable_memory_snapshot: bool = False,
        experimental_options: dict | None = None,
    ) -> Callable[[Callable], Function]:
        refuse_waiting_options({"tpu": tpu})
        _validate_priority(priority)

        def deco(fn: Callable) -> Function:
            fn_name = name or fn.__name__
            cluster_cfg = getattr(fn, "__mtpu_cluster__", None) or {}
            spec = FunctionSpec(
                tag=f"{self.name}.{fn_name}",
                app_name=self.name,
                raw_target=fn,
                gpu=parse_gpu_request(gpu),
                cpu=cpu,
                memory=memory,
                image=image or self.image,
                volumes={**self.volumes, **(volumes or {})},
                secrets=self.secrets + list(secrets or []),
                timeout=timeout,
                retries=normalize_retries(retries),
                max_containers=max_containers,
                min_containers=min_containers,
                scaledown_window=scaledown_window,
                single_use_containers=single_use_containers,
                max_concurrent_inputs=getattr(fn, "__mtpu_concurrent__", 1),
                batched=getattr(fn, "__mtpu_batched__", None),
                schedule=schedule,
                is_generator=inspect.isgeneratorfunction(fn),
                web=getattr(fn, "__mtpu_web__", None),
                region=region,
                priority=priority,
                max_pending_inputs=max_pending_inputs,
                enable_memory_snapshot=enable_memory_snapshot,
                serialized=serialized,
                experimental_options=dict(experimental_options or {}),
                cluster_size=cluster_cfg.get("size", 0),
                cluster_chips_per_host=cluster_cfg.get("chips_per_host"),
            )
            f = Function(self, fn, spec)
            self.registered_functions[fn_name] = f
            if spec.web is not None:
                self.registered_web_endpoints.append(fn_name)
            return f

        return deco

    def cls(
        self,
        *,
        gpu: str | list[str] | None = None,
        tpu: Any = None,
        cpu: float | None = None,
        memory: int | None = None,
        image: Image | None = None,
        volumes: dict | None = None,
        secrets: list | None = None,
        timeout: float | None = 300.0,
        retries=None,
        max_containers: int = 8,
        min_containers: int = 0,
        scaledown_window: float = 60.0,
        priority: str = "default",
        max_pending_inputs: int | None = None,
        enable_memory_snapshot: bool = False,
        experimental_options: dict | None = None,
        region: str | None = None,
    ) -> Callable[[type], Cls]:
        refuse_waiting_options({"tpu": tpu})
        _validate_priority(priority)

        def deco(user_cls: type) -> Cls:
            meta = _collect_lifecycle(user_cls)
            spec = FunctionSpec(
                tag=f"{self.name}.{user_cls.__name__}",
                app_name=self.name,
                raw_target=(user_cls, meta),
                is_cls_method=True,
                gpu=parse_gpu_request(gpu),
                cpu=cpu,
                memory=memory,
                image=image or self.image,
                volumes={**self.volumes, **(volumes or {})},
                secrets=self.secrets + list(secrets or []),
                timeout=timeout,
                retries=normalize_retries(retries),
                max_containers=max_containers,
                min_containers=min_containers,
                scaledown_window=scaledown_window,
                max_concurrent_inputs=getattr(user_cls, "__mtpu_concurrent__", 1),
                methods_meta=meta["methods"],
                region=region,
                priority=priority,
                max_pending_inputs=max_pending_inputs,
                enable_memory_snapshot=enable_memory_snapshot,
                experimental_options=dict(experimental_options or {}),
            )
            c = Cls(self, user_cls, spec, meta)
            self.registered_classes[user_cls.__name__] = c
            return c

        return deco

    def local_entrypoint(self, name: str | None = None) -> Callable:
        def deco(fn: Callable) -> _LocalEntrypoint:
            ep = _LocalEntrypoint(self, fn)
            self.registered_entrypoints[name or fn.__name__] = ep
            return ep

        return deco

    def server(self, **kwargs) -> Callable:
        """``@app.server`` — raw-port low-latency serving (vllm_inference.py:139).

        Implemented in the web layer; see modal_examples_tpu_torch.web.server.
        """
        from ..web.server import make_server_decorator

        return make_server_decorator(self, **kwargs)

    # -- run context --------------------------------------------------------

    @contextlib.contextmanager
    def run(self, detach: bool = False):
        if self._current_run is not None:
            yield self._current_run  # reentrant: reuse the outer context
            return
        run = AppRun(self, detach=detach)
        self._current_run = run
        try:
            yield run
        finally:
            self._current_run = None
            if not detach:
                run.close()

    def _get_or_create_implicit_run(self) -> AppRun:
        if self._implicit_run is None or self._implicit_run.closed:
            self._implicit_run = AppRun(self)
            atexit.register(self._implicit_run.close)
        return self._implicit_run

    # -- deploy / lookup ----------------------------------------------------

    def deploy(self, source_file: str | None = None) -> None:
        """Record this app in the state-dir registry (local control plane)."""
        src = source_file
        if src is None:
            for ep in list(self.registered_entrypoints.values()):
                src = inspect.getsourcefile(ep.raw_f)
                break
            if src is None:
                for f in list(self.registered_functions.values()):
                    src = inspect.getsourcefile(f.raw_f)
                    break
        reg_path = _registry_path()
        try:
            registry = json.loads(reg_path.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            registry = {}
        registry[self.name] = {
            "source_file": str(src) if src else None,
            "deployed_at": time.time(),
            "functions": sorted(self.registered_functions),
            "classes": sorted(self.registered_classes),
        }
        reg_path.write_text(json.dumps(registry, indent=2))

    @staticmethod
    def lookup(name: str, create_if_missing: bool = False) -> "App":
        # In-process apps first
        app = _app_instances.get(name)
        if app is not None:
            return app
        try:
            registry = json.loads(_registry_path().read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            registry = {}
        entry = registry.get(name)
        if entry and entry.get("source_file"):
            module = load_module_from_path(entry["source_file"])
            for obj in vars(module).values():
                if isinstance(obj, App) and obj.name == name:
                    return obj
        if create_if_missing:
            return App(name)
        raise KeyError(
            f"app {name!r} not found (deploy it with "
            "`python -m modal_examples_tpu_torch deploy`)"
        )

    # -- schedules ----------------------------------------------------------

    def scheduled_functions(self) -> dict[str, Function]:
        return {
            n: f
            for n, f in self.registered_functions.items()
            if f.spec.schedule is not None
        }

    def run_scheduler(self, duration: float | None = None, poll: float = 1.0) -> int:
        """Fire schedules (Period/Cron) until ``duration`` elapses.

        Returns the number of invocations fired. ``deploy`` keeps this
        loop alive for deployed apps (reference: schedules fire on deployed
        apps, 05_scheduling/schedule_simple.py).
        """
        fired = 0
        next_fire: dict[str, _dt.datetime] = {}
        now = _dt.datetime.now()
        for tag, f in self.scheduled_functions().items():
            next_fire[tag] = f.spec.schedule.next_fire(now)
        start = time.monotonic()
        with self.run():
            while duration is None or time.monotonic() - start < duration:
                now = _dt.datetime.now()
                for tag, f in self.scheduled_functions().items():
                    if now >= next_fire[tag]:
                        f.spawn()
                        fired += 1
                        next_fire[tag] = f.spec.schedule.next_fire(now)
                time.sleep(poll)
        return fired

    def __repr__(self) -> str:
        return f"App({self.name!r})"


def current_run(app: App) -> AppRun:
    if app._current_run is not None:
        return app._current_run
    return app._get_or_create_implicit_run()


def load_module_from_path(path: str, name: str | None = None):
    """Import the file at ``path`` as module ``name`` (default: its stem), as
    the CLI loads an app file; a container resolving a by-reference callable
    (core/serialization.py) loads it under the same name."""
    import importlib.util

    p = Path(path)
    mod_name = name or p.stem.replace("-", "_")
    if mod_name in sys.modules and getattr(
        sys.modules[mod_name], "__file__", None
    ) == str(p):
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, p)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    parent = str(p.parent)
    if parent not in sys.path:
        sys.path.insert(0, parent)
    spec.loader.exec_module(module)
    return module
