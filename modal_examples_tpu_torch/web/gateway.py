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

The port serves the built-in routes whose modules it has: ``/healthz`` (the
SLO gate), ``/metrics`` (the process registry merged with the pushed
expositions), ``/alerts``, ``/incidents[/<id>[?file=NAME]]``, ``/canary``,
``/traces`` (call and request traces, merged across the registered
stores), ``/profile`` (the engines' hot-path profilers and the kernel
build ledger), ``/usage`` (their usage meters), ``/autoscaler`` (the
executor's journal), ``/health`` (the gray-failure watchdog's per-replica
classification), ``/disagg`` (replica roles, migrations and the prefix
tiers), ``/prefixstore`` (the shared prefix store's counters and ownership
journal), ``/fleet`` (the fleet autoscaler's replicas, decisions and boot
latencies) and ``/chaos`` (injected faults and the chaos episode journal).
A route over a module the port does not have answers 501 naming the ROADMAP
item it waits on (:data:`WAITING_ROUTES`, empty now). A ``@websocket_endpoint`` route
upgrades the connection (``web/websocket.py``) and runs its handler in the
gateway's process, as the reference's does: a live socket cannot cross into
a container.
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
WAITING_ROUTES: dict[str, str] = {}


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


def _disagg_snapshot() -> dict:
    """Disaggregated-serving snapshot from the process registry: replica
    roles, the migration counters and latency, and the prefix tiers'
    occupancy and hits (the ``/disagg`` route's payload; ``python -m
    modal_examples_tpu_torch disagg`` renders the same series)."""
    from ..observability import catalog as C
    from ..utils.prometheus import default_registry as reg

    roles = {labels.get("replica", "?"): labels.get("role", "?") for labels, _v in reg.series(C.REPLICA_ROLE)}
    by_result = {labels.get("result", "?"): v for labels, v in reg.series(C.DISAGG_MIGRATIONS_TOTAL)}
    tiers: dict = {}
    for labels, v in reg.series(C.PREFIX_TIER_PAGES):
        tiers.setdefault(labels.get("tier", "?"), {})["pages"] = v
    for labels, v in reg.series(C.PREFIX_TIER_BYTES):
        tiers.setdefault(labels.get("tier", "?"), {})["bytes"] = v
    hits = {labels.get("tier", "?"): v for labels, v in reg.series(C.PREFIX_TIER_HITS_TOTAL)}
    return {
        "replicas": roles,
        "migrations": {
            "by_result": by_result,
            "inflight": reg.value(C.DISAGG_MIGRATIONS_INFLIGHT),
            "pages": reg.total(C.DISAGG_PAGES_MIGRATED_TOTAL),
            "bytes": reg.total(C.DISAGG_MIGRATION_BYTES_TOTAL),
            "latency": reg.histogram_quantiles(C.DISAGG_MIGRATION_SECONDS),
        },
        "tiers": {"occupancy": tiers, "hits": hits},
    }


def _fleet_snapshot(last: int = 20) -> dict:
    """Fleet-autoscaler snapshot: replica counts by role and decision
    counters from the process registry, boot-latency quantiles by kind
    (warm snapshot-restore vs cold init), plus the newest records from the
    fleet decision journal: the ``/fleet`` route's payload (``python -m
    modal_examples_tpu_torch fleet`` renders the same data from pushed
    metrics)."""
    from ..observability import catalog as C
    from ..observability.journal import named_journal
    from ..utils.prometheus import default_registry as reg

    replicas = {
        labels.get("role", "?"): v
        for labels, v in reg.series(C.FLEET_REPLICAS)
    }
    decisions: dict = {}
    for labels, v in reg.series(C.FLEET_DECISIONS_TOTAL):
        action = labels.get("action", "?")
        decisions.setdefault(action, {})[labels.get("trigger", "?")] = v
    boots = {
        boot: reg.histogram_quantiles(
            C.FLEET_BOOT_SECONDS, aggregate={"boot": boot}
        )
        for boot in ("warm", "cold")
    }
    journal = named_journal("fleet").tail(last)
    return {
        "replicas": replicas,
        "decisions": decisions,
        "boot_seconds": {k: v for k, v in boots.items() if v},
        "journal": journal,
    }


def _chaos_snapshot(last: int = 10) -> dict:
    """Chaos-harness snapshot: injected-fault counters per catalog point
    (live registry) plus the newest episode records from the chaos journal
    (the ``/chaos`` route's payload; ``python -m modal_examples_tpu_torch
    chaos`` renders the same data from pushed metrics and the journal)."""
    from ..observability import catalog as C
    from ..observability.journal import named_journal
    from ..utils.prometheus import default_registry as reg

    injected = {
        labels.get("point", "?"): v
        for labels, v in reg.series(C.FAULTS_INJECTED_TOTAL)
    }
    episodes = named_journal("chaos").tail(last)
    return {
        "injected": injected,
        "injected_total": sum(injected.values()),
        "router_readmissions": reg.total(C.ROUTER_READMISSIONS_TOTAL),
        "episodes": episodes,
        "wedged": sum(int(e.get("wedged", 0)) for e in episodes),
    }


def _prefixstore_snapshot(last: int = 10) -> dict:
    """Shared prefix-store snapshot: fleet-wide dedup/hit/takeover
    counters (live registry) plus the newest ownership records from the
    ``prefix_store`` journal (the ``/prefixstore`` route's payload;
    ``python -m modal_examples_tpu_torch prefixstore`` renders the same data
    from pushed metrics and the journal)."""
    from ..observability import catalog as C
    from ..observability.journal import named_journal
    from ..utils.prometheus import default_registry as reg

    hits = {
        labels.get("origin", "?"): v
        for labels, v in reg.series(C.PREFIX_STORE_HITS_TOTAL)
    }
    return {
        "hits": hits,
        "hits_total": sum(hits.values()),
        "misses": reg.total(C.PREFIX_STORE_MISSES_TOTAL),
        "dedup_ratio": reg.total(C.PREFIX_STORE_DEDUP_RATIO),
        "bytes": reg.total(C.PREFIX_STORE_BYTES),
        "owner_takeovers": reg.total(C.PREFIX_STORE_OWNER_TAKEOVERS_TOTAL),
        "journal": named_journal("prefix_store").tail(last),
    }


def _health_snapshot(last: int = 20) -> dict:
    """Gray-failure watchdog snapshot: per-replica classification and
    progress age (``mtpu_watchdog_replica_state`` /
    ``mtpu_watchdog_progress_age_seconds`` from the live registry), the
    transition and recovery counters, and the newest ladder decisions of
    ``<state_dir>/watchdog.jsonl`` (the ``/health`` route's payload).
    ``/healthz`` is the SLO gate; this is the per-replica progress view."""
    from ..observability.journal import named_journal
    from ..serving.health import decode_watchdog_series
    from ..utils.prometheus import default_registry as reg

    wd = decode_watchdog_series(reg)
    return {
        "replicas": {
            name: {"state": state, "progress_age_s": wd["ages"].get(name)} for name, state in wd["states"].items()
        },
        "transitions": wd["transitions"],
        "recoveries": wd["recoveries"],
        "journal": named_journal("watchdog").tail(last),
    }


def _profile_snapshot(last: int = 20) -> dict:
    """Hot-path profiler snapshot: per-replica overhead summaries and
    Perfetto-ready ring snapshots from every live profiler in the process,
    plus the newest records of the kernel build ledger (the ``/profile``
    route's payload). Empty ``replicas`` means no engine in this process
    runs with ``MTPU_PROFILE`` on."""
    from ..observability import profiler as _prof

    replicas = {}
    for p in _prof.active_profilers():
        replicas[p.replica] = {
            "summary": p.overhead_summary(),
            "perfetto": p.perfetto_snapshot(),
        }
    # the unfinished scan reads a deep tail whatever the display size
    deep = _prof.read_ledger(n=2000)
    return {
        "replicas": replicas,
        "ledger": deep[-last:] if last else [],
        "unfinished_builds": _prof.unfinished_builds(deep),
    }


def _alerts_snapshot(last: int = 20) -> dict:
    """Alert-rule snapshot: per-rule firing state (from the live evaluator
    when this process runs the tsdb sampler, else a one-shot evaluation
    over the on-disk window) and the newest fire/clear transitions of the
    ``alerts`` journal: the ``/alerts`` route's payload."""
    from ..observability import alerts as _alerts
    from ..observability import timeseries as _ts

    sampler = _ts.global_sampler()
    ev = sampler.evaluator if sampler is not None else None
    if ev is not None:
        rules = ev.snapshot()
        active = ev.active()
    else:
        rules = _alerts.evaluate_offline(_ts.read_window())
        active = [r["rule"] for r in rules if r["firing"]]
    return {
        "rules": rules,
        "active": active,
        "live_evaluator": ev is not None,
        "history": _alerts.read_alert_journal(last),
    }


def _incidents_snapshot() -> dict:
    """The incident-bundle index: the ``/incidents`` route's payload."""
    from ..observability import incident as _incident

    return {"incidents": _incident.list_incidents()}


def _canary_snapshot(last: int = 20) -> dict:
    """Correctness-canary snapshot: the live prober's state (when this
    process runs one), per-replica probe, drift and failing-streak values
    from the registry, and the newest records of the ``canary`` journal:
    the ``/canary`` route's payload."""
    from ..observability import canary as _canary
    from ..observability import catalog as C
    from ..observability.journal import named_journal
    from ..utils.prometheus import default_registry as reg

    probes: dict = {}
    for labels, v in reg.series(C.CANARY_PROBES_TOTAL):
        rep = labels.get("replica", "?")
        probes.setdefault(rep, {})[labels.get("result", "?")] = int(v)
    drift = {labels.get("replica", "?"): int(v) for labels, v in reg.series(C.CANARY_DRIFT_TOTAL)}
    failing = {labels.get("replica", "?"): int(v) for labels, v in reg.series(C.CANARY_FAILING)}
    prober = _canary.live_prober()
    return {
        "probes": probes,
        "drift": drift,
        "failing": failing,
        "prober": prober.snapshot() if prober is not None else None,
        "journal": named_journal("canary").tail(last),
    }


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
        """Built-in routes: ``/healthz`` (200 or 503 with the SLO report),
        ``/metrics`` (prometheus exposition: the registry merged with the
        pushed files), ``/alerts[?n=N]``, ``/incidents[/<id>[?file=NAME]]``,
        ``/canary[?n=N]``, ``/traces[/<id>[?explain=1]]`` (call and request
        span JSON), ``/profile[?n=N]``, ``/usage[?n=N]``,
        ``/autoscaler[?function=tag&n=N]``, ``/health[?n=N]``, ``/disagg``,
        ``/fleet[?n=N]``, ``/chaos[?n=N]``, ``/prefixstore[?n=N]``,
        ``/`` (the :data:`BUILTIN_ROUTES` index), and 501 for
        :data:`WAITING_ROUTES`.
        User endpoints with the same label win — these only answer when no
        route claimed the path."""
        parts = parsed.path.strip("/").split("/")
        label = parts[0] if parts else ""
        if method != "GET" or (label and label not in BUILTIN_ROUTES):
            return False
        q = {k: v[-1] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        if not label:
            self._respond_json(200, _root_index())
        elif label in WAITING_ROUTES:
            self._respond_json(
                501, {"error": f"/{label} waits on {WAITING_ROUTES[label]}"}
            )
        elif label == "healthz":
            from ..observability.slo import healthz

            payload = healthz()
            self._respond_json(200 if payload["status"] == "ok" else 503, payload)
        elif label == "alerts":
            self._respond_json(200, _alerts_snapshot(last=self._query_int(parsed, 20)))
        elif label == "incidents":
            self._serve_incident(parts, q)
        elif label == "canary":
            self._respond_json(200, _canary_snapshot(last=self._query_int(parsed, 20)))
        elif label == "usage":
            self._respond_json(200, _usage_snapshot(last=self._query_int(parsed, 10)))
        elif label == "profile":
            self._respond_json(200, _profile_snapshot(last=self._query_int(parsed, 20)))
        elif label == "health":
            self._respond_json(200, _health_snapshot(last=self._query_int(parsed, 20)))
        elif label == "disagg":
            self._respond_json(200, _disagg_snapshot())
        elif label == "fleet":
            self._respond_json(200, _fleet_snapshot(last=self._query_int(parsed, 20)))
        elif label == "chaos":
            self._respond_json(200, _chaos_snapshot(last=self._query_int(parsed, 10)))
        elif label == "prefixstore":
            self._respond_json(200, _prefixstore_snapshot(last=self._query_int(parsed, 10)))
        elif label == "autoscaler":
            from ..observability.journal import default_journal

            self._respond_json(
                200,
                {
                    "decisions": default_journal.tail(
                        self._query_int(parsed, 50), function=q.get("function")
                    )
                },
            )
        elif label == "metrics":
            from ..observability.export import live_and_pushed_metrics

            body = live_and_pushed_metrics(job=f"gateway-{self.gateway.app.name}").encode()
            self.send_response(200)
            self.send_header("content-type", "text/plain; version=0.0.4")
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif len(parts) > 1 and parts[1]:  # /traces/<id>
            from ..observability import reqtrace as _reqtrace

            # either id namespace, merged across the registered stores;
            # resolve() whitelists the token shape: an unresolvable token is
            # a 404, never a raw-path read
            token = urllib.parse.unquote(parts[1])
            trace_id = _reqtrace.resolve(token)
            spans = _reqtrace.read_trace(trace_id) if trace_id else []
            if not spans:
                self._respond_json(404, {"error": f"no trace {token!r}"})
            else:
                payload = {"trace_id": trace_id, "kind": _reqtrace.trace_kind(trace_id), "spans": spans}
                if q.get("explain"):
                    payload["narrative"] = _reqtrace.explain_lines(spans, trace_id)
                self._respond_json(200, payload)
        else:
            from ..observability import reqtrace as _reqtrace

            self._respond_json(200, {"traces": _reqtrace.list_traces()})
        return True

    def _serve_websocket(self, fn, parsed) -> None:
        """Upgrade to a websocket (426 without ``Upgrade: websocket``) and
        run the handler ``fn(ws, **query)`` here: the live socket cannot
        cross the container boundary (``endpoints.websocket_endpoint``)."""
        if (self.headers.get("Upgrade") or "").lower() != "websocket":
            self._respond_json(426, {"error": "websocket endpoint: upgrade required"})
            return
        from .websocket import ConnectionClosed, perform_handshake

        ws = perform_handshake(self)
        if ws is None:
            return
        raw = {k: v[-1] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        try:
            fn.raw_f(ws, **_coerce_kwargs(fn.raw_f, raw))
        except ConnectionClosed:
            pass
        except BaseException as e:
            _log.warning("websocket handler error: %s: %s", type(e).__name__, e)
        finally:
            ws.close()
            self.close_connection = True

    def _serve_incident(self, parts: list[str], q: dict) -> None:
        """``/incidents``: the index; ``/incidents/<id>``: the manifest;
        ``?file=NAME``: one bundled file (the manifest whitelists the names
        a capture wrote)."""
        from ..observability import incident as _incident

        if not (len(parts) > 1 and parts[1]):
            self._respond_json(200, _incidents_snapshot())
            return
        token = urllib.parse.unquote(parts[1])
        manifest = _incident.read_manifest(token)
        if manifest is None:
            self._respond_json(404, {"error": f"no incident {token!r}"})
            return
        name = q.get("file")
        if not name:
            self._respond_json(200, manifest)
            return
        body = _incident.read_bundle_file(manifest["id"], name)
        if body is None:
            self._respond_json(404, {"error": f"no file {name!r} in {manifest['id']}"})
        else:
            self._respond_json(200, {"id": manifest["id"], "file": name, "content": body})

    def _handle(self, method: str) -> None:
        route, parsed = self._route()
        if route is None:
            if self._serve_builtin(parsed, method):
                return
            self._respond_json(404, {"error": f"no endpoint at {parsed.path}"})
            return
        fn = route["function"]
        web = fn.spec.web
        if web["type"] == "websocket_endpoint":
            self._serve_websocket(fn, parsed)
            return
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
