"""``@app.server`` — raw-port, low-latency serving; a copy of
``modal_examples_tpu/web/server.py`` with ``gpu=`` in place of ``tpu=``.

Reference spec: ``@app.server(port=8000, routing_region=..., compute_region=...,
target_concurrency=100, startup_timeout=..., exit_grace_period=...,
unauthenticated=True)`` decorating a class whose ``@modal.enter`` starts an
HTTP server on ``port`` (vllm_inference.py:139-209, 07_web/server.py:49-60);
the replica is advertised only once the port accepts connections
(vllm_inference.py:127-128). Sticky routing via rendezvous hashing
(server_sticky.py:16-27) is modeled by the ``sticky_header`` option.

Locally the decorated class becomes a Cls whose single container runs the
user's server; ``serve()`` boots it, waits for port readiness, and publishes
the URL.
"""

from __future__ import annotations

import time
from typing import Callable

from . import registry
from .gateway import wait_for_port


class ServerHandle:
    """Deployed-server handle: boot, readiness, URL."""

    def __init__(self, cls_handle, cfg: dict):
        self._cls = cls_handle
        self.cfg = cfg
        self._obj = None

    @property
    def port(self) -> int:
        return self.cfg["port"]

    def serve(self, wait_ready: bool = True) -> str:
        """Boot one replica (runs @enter hooks, which start the server)."""
        if self._obj is None:
            self._obj = self._cls()
            # Booting = creating the pool with a warm container. Submitting a
            # no-op readiness method forces container boot + enter hooks.
            pool = self._obj._pool()
            if hasattr(pool, "_ensure_target"):  # inline backend
                pool._ensure_target()
            else:
                pool.spec.min_containers = max(1, pool.spec.min_containers)
                pool._autoscale(time.monotonic())
        url = f"http://127.0.0.1:{self.port}"
        if wait_ready:
            timeout = self.cfg.get("startup_timeout", 60.0)
            deadline = time.monotonic() + timeout
            while not wait_for_port("127.0.0.1", self.port, 0.5):
                # a replica whose boot failed (its cards, its @enter) never
                # opens the port: raise its error instead of waiting it out
                err = getattr(self._obj._pool(), "boot_error", None)
                if err is not None:
                    raise err
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"server on port {self.port} not ready after {timeout}s"
                    )
        registry.publish(self._cls._spec.tag, url)
        return url

    def stop(self) -> None:
        if self._obj is not None:
            self._obj._pool().shutdown()
            self._obj = None

    def get_web_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"


def make_server_decorator(
    app,
    *,
    port: int,
    gpu=None,
    tpu=None,
    image=None,
    volumes=None,
    secrets=None,
    startup_timeout: float = 60.0,
    target_concurrency: int | None = None,
    routing_region: str | None = None,
    compute_region: str | None = None,
    exit_grace_period: float | None = None,
    unauthenticated: bool = False,
    scaledown_window: float = 300.0,
    max_containers: int = 1,
    timeout: float | None = None,
    sticky_header: str | None = None,
    **kw,
) -> Callable:
    cfg = {
        "port": port,
        "startup_timeout": startup_timeout,
        "target_concurrency": target_concurrency,
        "routing_region": routing_region,
        "compute_region": compute_region,
        "exit_grace_period": exit_grace_period,
        "unauthenticated": unauthenticated,
        "sticky_header": sticky_header,
    }

    def deco(user_cls: type) -> ServerHandle:
        cls_handle = app.cls(
            gpu=gpu,
            tpu=tpu,
            image=image,
            volumes=volumes,
            secrets=secrets,
            scaledown_window=scaledown_window,
            max_containers=max_containers,
            timeout=timeout,
        )(user_cls)
        cls_handle._spec.web = {"type": "server", **cfg}
        handle = ServerHandle(cls_handle, cfg)
        if not hasattr(app, "registered_servers"):
            app.registered_servers = {}
        app.registered_servers[user_cls.__name__] = handle
        return handle

    return deco
