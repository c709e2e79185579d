"""Copy of ``modal_examples_tpu/web/endpoints.py``: web endpoint decorators, HTTP/ASGI/WSGI wrappers over Functions.

Reference spec: ``@modal.fastapi_endpoint(docs=True)`` (basic_web.py:43-46),
``@modal.asgi_app`` (text_to_image.py:239), ``@modal.wsgi_app``
(torch_profiling.py:301), ``@modal.web_server(port)`` (pushgateway.py:66),
``f.get_web_url()`` (text_to_image.py:254).

These decorators attach web metadata under the ``@app.function`` / ``@app.cls``
decorator; ``python -m modal_examples_tpu_torch serve`` turns the registrations into live servers:

- ``fastapi_endpoint`` — if fastapi is installed, the function becomes a
  FastAPI route; otherwise our stdlib JSON gateway (web.gateway) serves it.
- ``asgi_app`` / ``wsgi_app`` — the function *returns* an ASGI/WSGI app which
  is hosted in-container.
- ``web_server(port)`` — the function starts its own server on ``port``
  (subprocess or thread); the gateway proxies/publishes that port.
"""

from __future__ import annotations

from typing import Callable


def _mark(kind: str, **cfg) -> Callable:
    def deco(fn):
        fn.__mtpu_web__ = {"type": kind, **cfg}
        return fn

    return deco


def fastapi_endpoint(
    *,
    method: str = "GET",
    label: str | None = None,
    docs: bool = False,
    custom_domains: list[str] | None = None,
    requires_proxy_auth: bool = False,
) -> Callable:
    return _mark("fastapi_endpoint", method=method.upper(), label=label, docs=docs)


# modal's deprecated spelling, still used by some reference examples
web_endpoint = fastapi_endpoint


def asgi_app(*, label: str | None = None, custom_domains: list[str] | None = None) -> Callable:
    return _mark("asgi_app", label=label)


def wsgi_app(*, label: str | None = None, custom_domains: list[str] | None = None) -> Callable:
    return _mark("wsgi_app", label=label)


def web_server(
    port: int, *, startup_timeout: float = 30.0, label: str | None = None
) -> Callable:
    return _mark("web_server", port=port, startup_timeout=startup_timeout, label=label)


def websocket_endpoint(*, label: str | None = None) -> Callable:
    """Websocket handlers wait with ``web/websocket.py`` (ROADMAP A13)."""
    raise NotImplementedError(
        "websocket_endpoint: the port has no web/websocket.py yet (ROADMAP A13)"
    )
