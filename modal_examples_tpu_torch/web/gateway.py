"""Local web gateway: hosts an app's web endpoints over HTTP; after
``modal_examples_tpu/web/gateway.py``.

This is the local analog of the reference platform's web proxy in front of
``@modal.fastapi_endpoint`` / ``@modal.asgi_app`` / ``@modal.wsgi_app`` /
``@modal.web_server`` functions (07_web/*, SURVEY.md L6). fastapi/uvicorn are
optional: the gateway is stdlib ``http.server`` and dispatches requests into
the same container pools as ``.remote`` calls, so web traffic exercises the
exact same scheduling path (autoscaling, @concurrent, @batched) as RPC
traffic. Generator functions stream as ``text/event-stream`` (SSE), matching
07_web/streaming.py:38-45.

The port serves the built-in routes whose modules it has: ``/metrics`` (the
port's process registry), ``/traces`` (call and request traces),
``/profile`` (the engines' hot-path profilers), ``/usage`` (their usage
meters) and ``/autoscaler`` (the executor's journal). The others answer 501
naming the ROADMAP item they wait on (:data:`WAITING_ROUTES`). The websocket
endpoint decorator raises: ``web/websocket.py`` waits (ROADMAP A13).
"""

from __future__ import annotations

import inspect
import json
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import registry
from ..scheduling.admission import ShedError as _ShedError
from ..utils.log import get_logger

_log = get_logger("gateway")

#: every built-in observability surface of the JAX package's gateway: route
#: label -> one-line description. One table shared by the dispatch check and
#: the ``/`` index payload. ``/metrics`` is prometheus text; every other
#: route answers JSON.
BUILTIN_ROUTES: dict[str, str] = {
    "healthz": "SLO pass/fail gate + burn rates",
    "health": "gray-failure watchdog: per-replica progress classification",
    "metrics": "prometheus exposition (the process registry)",
    "alerts": "alert-rule firing state + fire/clear history",
    "incidents": "incident-bundle index (/incidents/<id>[?file=NAME])",
    "usage": "per-tenant usage meters + roofline MFU/MBU",
    "prefixstore": "shared prefix-store dedup/hit-origin/takeover counters",
    "profile": "hot-path profiler: tick phases, host fraction",
    "traces": "request/call trace index (/traces/<id>)",
    "fleet": "fleet autoscaler: replicas, decisions, boot latencies",
    "disagg": "disaggregated serving: roles, migrations, prefix tiers",
    "chaos": "injected-fault counters + chaos episode journal",
    "canary": "correctness canary: golden-set probe results + drift",
    "autoscaler": "executor autoscaler decision journal",
}

#: built-in routes over modules the port does not have yet: label -> what
#: they wait on. They answer 501 with that text.
WAITING_ROUTES: dict[str, str] = {
    "healthz": "observability/slo.py (ROADMAP A6)",
    "alerts": "observability/alerts.py and timeseries.py (ROADMAP A6)",
    "incidents": "observability/incident.py (ROADMAP A6)",
    "canary": "observability/canary.py (ROADMAP A6)",
    "health": "serving/health.py (ROADMAP A9)",
    "fleet": "fleet/ (ROADMAP A9)",
    "disagg": "serving/disagg/ (ROADMAP A9)",
    "chaos": "faults/chaos.py (ROADMAP A9)",
    "prefixstore": "serving/prefix_store/ (ROADMAP A9)",
}


def _coerce_kwargs(fn, raw: dict) -> dict:
    """Coerce string query params to the entrypoint's annotated types."""
    sig = inspect.signature(fn)
    out = {}
    for name, value in raw.items():
        param = sig.parameters.get(name)
        if param is None:
            out[name] = value
            continue
        ann = param.annotation
        try:
            if ann is int:
                value = int(value)
            elif ann is float:
                value = float(value)
            elif ann is bool:
                value = str(value).lower() in ("1", "true", "yes", "on")
        except (TypeError, ValueError):
            pass
        out[name] = value
    return out


def _profile_snapshot() -> dict:
    """Hot-path profiler snapshot: per-replica overhead summaries and
    Perfetto-ready ring snapshots from every live profiler in the process
    (the ``/profile`` route's payload). Empty ``replicas`` means no engine
    in this process runs with ``MTPU_PROFILE`` on. The port compiles no
    program at dispatch, so there is no compile ledger."""
    from ..observability import profiler as _prof

    replicas = {}
    for p in _prof.active_profilers():
        replicas[p.replica] = {
            "summary": p.overhead_summary(),
            "perfetto": p.perfetto_snapshot(),
        }
    return {"replicas": replicas}


def _usage_snapshot(last: int = 10) -> dict:
    """Usage-accounting snapshot: every live engine's per-tenant meters and
    roofline position, plus the newest per-request records from the
    ``usage`` journal (the ``/usage`` route's payload)."""
    from ..observability import usage as _usage
    from ..observability.journal import named_journal

    engines = {
        u.replica: {"roofline": u.summary(), **u.tenants()}
        for u in _usage.active_meters()
    }
    records = named_journal("usage").tail(last)
    return {
        "engines": engines,
        "journal_totals": _usage.journal_tenant_totals(records),
        "records": records,
    }


def _root_index() -> dict:
    """The ``/`` discovery payload: every built-in observability surface,
    straight from :data:`BUILTIN_ROUTES` so index and dispatch can't drift."""
    return {
        "service": "modal_examples_tpu_torch gateway",
        "routes": {f"/{label}": desc for label, desc in BUILTIN_ROUTES.items()},
    }


class _Handler(BaseHTTPRequestHandler):
    gateway: "Gateway"

    def log_message(self, fmt, *args):  # quiet by default; logs go to stdout
        pass

    def _route(self):
        path = urllib.parse.urlparse(self.path)
        label = path.path.strip("/").split("/")[0]
        return self.gateway.routes.get(label), path

    # -- WSGI/ASGI hosting (the function RETURNS the app; we serve it) ------

    def _read_request(self, parsed) -> tuple[bytes, str]:
        """(body, decoded subpath below the route label)."""
        length = int(self.headers.get("content-length") or 0)
        body = self.rfile.read(length) if length else b""
        raw = "/" + "/".join(parsed.path.strip("/").split("/")[1:])
        return body, urllib.parse.unquote(raw)

    def _send_payload(self, status: int, headers, payload: bytes) -> None:
        self._started_response = True
        self.send_response(status)
        for k, v in headers:
            k = k.decode() if isinstance(k, bytes) else k
            v = v.decode() if isinstance(v, bytes) else v
            if k.lower() != "content-length":
                self.send_header(k, v)
        self.send_header("content-length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _serve_wsgi(self, wsgi_app, parsed, method: str) -> None:
        import io

        body, subpath = self._read_request(parsed)
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": subpath,
            "QUERY_STRING": parsed.query or "",
            "CONTENT_LENGTH": str(len(body)),
            "CONTENT_TYPE": self.headers.get("content-type", ""),
            "SERVER_NAME": self.gateway.host,
            "SERVER_PORT": str(self.gateway.port),
            "SERVER_PROTOCOL": "HTTP/1.1",
            "wsgi.version": (1, 0),
            "wsgi.url_scheme": "http",
            "wsgi.input": io.BytesIO(body),
            "wsgi.errors": io.StringIO(),
            "wsgi.multithread": True,
            "wsgi.multiprocess": False,
            "wsgi.run_once": False,
        }
        for k, v in self.headers.items():
            environ["HTTP_" + k.upper().replace("-", "_")] = v
        status_headers = {}

        def start_response(status, headers, exc_info=None):
            status_headers["status"] = status
            status_headers["headers"] = headers

        result = wsgi_app(environ, start_response)
        try:
            payload = b"".join(result)
        finally:
            if hasattr(result, "close"):  # PEP 3333: server must call close()
                result.close()
        code = int(status_headers["status"].split()[0])
        self._send_payload(code, status_headers["headers"], payload)

    def _serve_asgi(self, asgi_app, parsed, method: str) -> None:
        import asyncio

        body, subpath = self._read_request(parsed)
        scope = {
            "type": "http",
            "asgi": {"version": "3.0"},
            "http_version": "1.1",
            "method": method,
            "path": subpath,
            "raw_path": subpath.encode(),
            "query_string": (parsed.query or "").encode(),
            "headers": [
                (k.lower().encode(), v.encode()) for k, v in self.headers.items()
            ],
            "server": (self.gateway.host, self.gateway.port),
            "client": self.client_address,
        }
        received = {"sent": False}

        async def receive():
            if received["sent"]:
                await asyncio.sleep(3600)
            received["sent"] = True
            return {"type": "http.request", "body": body, "more_body": False}

        messages: list[dict] = []

        async def send(message):
            messages.append(message)

        asyncio.run(asgi_app(scope, receive, send))
        status = next(
            (m for m in messages if m["type"] == "http.response.start"),
            {"status": 500, "headers": []},
        )
        payload = b"".join(
            m.get("body", b"") for m in messages if m["type"] == "http.response.body"
        )
        self._send_payload(status["status"], status.get("headers", []), payload)

    def _respond_json(
        self, code: int, obj, extra_headers: dict | None = None
    ) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    # -- built-in observability routes --------------------------------------

    def _query_int(self, parsed, default: int) -> int:
        q = {k: v[-1] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        try:
            return int(q.get("n", default))
        except ValueError:
            return default

    def _serve_builtin(self, parsed, method: str) -> bool:
        """Built-in routes: ``/metrics`` (prometheus exposition of the
        port's registry), ``/traces[/<id>]`` (call and request span JSON), ``/profile``, ``/usage[?n=N]``,
        ``/autoscaler[?function=tag&n=N]``, ``/`` (the
        :data:`BUILTIN_ROUTES` index), and 501 for :data:`WAITING_ROUTES`.
        User endpoints with the same label win — these only answer when no
        route claimed the path."""
        parts = parsed.path.strip("/").split("/")
        label = parts[0] if parts else ""
        if method != "GET" or (label and label not in BUILTIN_ROUTES):
            return False
        if not label:
            self._respond_json(200, _root_index())
        elif label in WAITING_ROUTES:
            self._respond_json(
                501, {"error": f"/{label} waits on {WAITING_ROUTES[label]}"}
            )
        elif label == "usage":
            self._respond_json(200, _usage_snapshot(last=self._query_int(parsed, 10)))
        elif label == "profile":
            self._respond_json(200, _profile_snapshot())
        elif label == "autoscaler":
            from ..observability.journal import default_journal

            q = {k: v[-1] for k, v in urllib.parse.parse_qs(parsed.query).items()}
            self._respond_json(
                200,
                {
                    "decisions": default_journal.tail(
                        self._query_int(parsed, 50), function=q.get("function")
                    )
                },
            )
        elif label == "metrics":
            from ..utils.prometheus import default_registry

            body = default_registry.expose().encode()
            self.send_response(200)
            self.send_header("content-type", "text/plain; version=0.0.4")
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif len(parts) > 1 and parts[1]:  # /traces/<id>
            from ..observability.trace import default_store

            # resolve() whitelists the token shape: an unresolvable token is
            # a 404, never a raw-path read
            token = urllib.parse.unquote(parts[1])
            trace_id = default_store.resolve(token)
            spans = default_store.read(trace_id) if trace_id else []
            if not spans:
                self._respond_json(404, {"error": f"no trace {token!r}"})
            else:
                self._respond_json(200, {"trace_id": trace_id, "spans": spans})
        else:
            from ..observability.trace import default_store

            self._respond_json(200, {"traces": default_store.list_traces()})
        return True

    def _handle(self, method: str) -> None:
        route, parsed = self._route()
        if route is None:
            if self._serve_builtin(parsed, method):
                return
            self._respond_json(404, {"error": f"no endpoint at {parsed.path}"})
            return
        fn = route["function"]
        web = fn.spec.web
        if web["type"] in ("wsgi_app", "asgi_app"):
            # the function returns an app object, built once (under the
            # route lock: concurrent first requests must not double-build)
            with self.gateway.app_build_lock:
                if "app_instance" not in route:
                    route["app_instance"] = fn.raw_f()
            self._started_response = False
            try:
                if web["type"] == "wsgi_app":
                    self._serve_wsgi(route["app_instance"], parsed, method)
                else:
                    self._serve_asgi(route["app_instance"], parsed, method)
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True
            except BaseException as e:
                if getattr(self, "_started_response", False):
                    # response underway: a second status line would corrupt it
                    self.close_connection = True
                else:
                    self._respond_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if web["type"] == "fastapi_endpoint" and web.get("method", "GET") != method:
            self._respond_json(405, {"error": f"method {method} not allowed"})
            return
        kwargs = {
            k: v[-1] for k, v in urllib.parse.parse_qs(parsed.query).items()
        }
        if method == "POST":
            length = int(self.headers.get("content-length") or 0)
            if length:
                try:
                    body = json.loads(self.rfile.read(length))
                    if isinstance(body, dict):
                        kwargs.update(body)
                except json.JSONDecodeError:
                    self._respond_json(400, {"error": "invalid JSON body"})
                    return
        kwargs = _coerce_kwargs(fn.raw_f, kwargs)  # POST merges the body first
        headers_sent = False
        try:
            if fn.spec.is_generator:
                # submit BEFORE the SSE headers: a shed (bounded queue)
                # must still be able to answer 429
                gen = fn.remote_gen(**kwargs)
                self.send_response(200)
                self.send_header("content-type", "text/event-stream")
                self.send_header("cache-control", "no-cache")
                self.end_headers()
                headers_sent = True
                for item in gen:
                    data = item if isinstance(item, str) else json.dumps(item)
                    self.wfile.write(f"data: {data}\n\n".encode())
                    self.wfile.flush()
                return
            result = fn.remote(**kwargs)
            if isinstance(result, (bytes, bytearray)):
                self.send_response(200)
                self.send_header("content-type", "application/octet-stream")
                self.send_header("content-length", str(len(result)))
                self.end_headers()
                headers_sent = True
                self.wfile.write(result)
            else:
                self._respond_json(200, result)
        except BrokenPipeError:
            pass
        except _ShedError as e:
            # bounded pool queue (max_pending_inputs=) rejected the input:
            # overload surfaces as a fast 429 + Retry-After, the same
            # contract the OpenAI layer keeps — never unbounded queueing
            if headers_sent:
                self.close_connection = True
            else:
                import math

                self._respond_json(
                    429,
                    {"error": str(e), "reason": e.reason},
                    extra_headers={
                        "retry-after": str(math.ceil(e.retry_after_s))
                    },
                )
        except BaseException as e:
            if headers_sent:
                # Response already started: a second status line would corrupt
                # the stream. Drop the connection so the client sees EOF.
                _log.warning(
                    "error mid-response: %s: %s", type(e).__name__, e
                )
                self.close_connection = True
            else:
                self._respond_json(500, {"error": f"{type(e).__name__}: {e}"})

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")


class Gateway:
    """One HTTP server hosting all web endpoints of an app."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 0):
        self.app = app
        self.app_build_lock = threading.Lock()
        self.routes: dict[str, dict] = {}
        for name in app.registered_web_endpoints:
            fn = app.registered_functions[name]
            label = (fn.spec.web or {}).get("label") or name
            self.routes[label] = {"function": fn}
        handler = type("BoundHandler", (_Handler,), {"gateway": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> "Gateway":
        for label, route in self.routes.items():
            url = f"http://{self.host}:{self.port}/{label}"
            registry.publish(route["function"].spec.tag, url)
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"


def wait_for_port(host: str, port: int, timeout: float) -> bool:
    """Poll until a TCP port accepts — the readiness gate the reference uses
    before advertising a replica (vllm_inference.py:127-128)."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with socket.create_connection((host, port), timeout=1.0):
                return True
        except OSError:
            time.sleep(0.1)
    return False
