"""OpenAI-compatible HTTP server over one LLM engine or a router's replicas.

Counterpart of ``modal_examples_tpu/serving/openai_api.py``: ``/health``, ``/v1/models``, ``/v1/completions`` and
``/v1/chat/completions``, JSON or SSE streaming (with the
``stream_options.include_usage`` usage chunk), 400 on bad parameters and 429
with ``Retry-After`` when admission sheds. A request's deadline is
``deadline_ms`` or the ``x-mtpu-deadline-ms`` header (the header wins), its
priority class ``priority`` or ``x-mtpu-priority``, its tenant ``user`` or
``x-mtpu-tenant``; ``usage.prompt_tokens_details.cached_tokens`` counts the
prompt tokens served from the prefix cache. ``n > 1`` fans out one engine
request per choice (seeded ``seed + i`` when a seed is given); a partial shed
aborts the admitted siblings and answers 429, and ``n > 1`` with ``stream``
is a 400. The request's trace opens at submit, and its id comes back as
``x-mtpu-request-id`` on the 200, the stream and the 500. ``/metrics`` serves
the catalog's hand-built lines from the engine's stats (with the speculation
counters on a speculating engine), then the port's
registry exposition, never a name twice. Stdlib HTTP, a thread per
connection; the engine's continuous batching does the multiplexing. With
``router=`` (a ``PrefixAffinityRouter`` or a ``DisaggCoordinator``) every
request is placed by the router and streamed through its failover path
(``serving/failover.py``): a replica dying mid-stream is resumed on a peer
and the stream goes on with no duplicated characters.

Images (the JAX server's ``_extract_images``): a chat message's content may
be a list of parts, ``{"type": "text"}`` and ``{"type": "image_url",
"image_url": {"url": "data:image/...;base64,..."}}``; the text parts are
joined and the one image goes to the engine with the request (an engine built
with ``vision=``). Only ``data:`` URIs are accepted (nothing is fetched), a
second image is a 400, and an image sent to an engine without a vision tower
is a 400. PNG is decoded by the port's own ``utils/images.py``; other formats
(and PNGs it does not read) go through PIL where it is installed, else they
are a 400 that names the format.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import math
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..observability import catalog as _C
from ..observability import reqtrace as _rt
from ..scheduling.admission import ShedError
from ..scheduling.policy import DEFAULT_CLASS, validate_class
from ..utils import images as _images
from ..utils.prometheus import default_registry
from .engine import LLMEngine
from .sampling import SamplingParams

_SERVER_ERROR = {"error": {"message": "engine error while processing the request", "type": "server_error"}}


_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
            (b"MM\x00*", "TIFF"))


def _image_format(raw: bytes, url: str) -> str:
    """The image's format by its leading bytes, else by the data URI's MIME type."""
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        return "WEBP"
    for magic, name in _FORMATS:
        if raw.startswith(magic):
            return name
    mime = url[5:].split(";", 1)[0].split(",", 1)[0]
    return mime or "unknown"


def _decode_image(raw: bytes, url: str):
    """A data URI's bytes as an image: a PNG through ``utils/images.py`` (an
    [H, W, 3] uint8 array), anything else (and a PNG that reader does not
    take) through PIL where it is installed. ValueError (a 400) otherwise."""
    if raw.startswith(_images.PNG_SIGNATURE):
        try:
            return _images.from_png(raw)
        except ValueError as e:
            reason, fmt = f"{e}", "PNG"
    else:
        reason, fmt = "", _image_format(raw, url)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"cannot decode a {fmt} image here: the server reads 8-bit RGB PNG itself and other images through PIL, "
            f"which is not installed" + (f" ({reason})" if reason else "")
        ) from None
    try:
        image = Image.open(io.BytesIO(raw))
        image.load()
    except Exception as e:
        raise ValueError(f"could not decode image: {e}") from e
    return image


def _extract_images(messages: list) -> tuple[list, object]:
    """OpenAI multimodal content parts -> (text-flattened messages, image or
    None): text parts joined by newlines, at most one ``image_url`` part over
    all messages, given as a ``data:`` URI."""
    image = None
    flat = []
    for m in messages:
        content = m.get("content")
        if not isinstance(content, list):
            flat.append(m)
            continue
        texts = []
        for part in content:
            ptype = part.get("type")
            if ptype == "text":
                texts.append(part.get("text", ""))
            elif ptype == "image_url":
                url = (part.get("image_url") or {}).get("url", "")
                if not url.startswith("data:"):
                    raise ValueError("only data: URIs are supported for image_url (inline base64; this server does "
                                     "not fetch URLs)")
                if image is not None:
                    # answering about the first image only would be confidently wrong
                    raise ValueError("multiple images per request are not supported")
                try:
                    raw = base64.b64decode(url.split(",", 1)[1] if "," in url else "")
                except ValueError as e:
                    raise ValueError(f"could not decode image: {e}") from e
                image = _decode_image(raw, url)
            else:
                raise ValueError(f"unsupported content part type {ptype!r}")
        flat.append({**m, "content": "\n".join(t for t in texts if t)})
    return flat, image


def _params_from_body(body: dict, headers=None) -> SamplingParams:
    stop = body.get("stop")
    deadline_ms = body.get("deadline_ms")
    if headers is not None and headers.get("x-mtpu-deadline-ms"):
        deadline_ms = headers.get("x-mtpu-deadline-ms")  # a proxy's budget wins over the body's
    return SamplingParams(
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        max_tokens=int(body.get("max_tokens", 128)),
        stop=tuple([stop] if isinstance(stop, str) else stop or []),
        seed=int(body["seed"]) if body.get("seed") is not None else None,
        deadline_s=float(deadline_ms) / 1000.0 if deadline_ms is not None else None,
    )


def _sched_kwargs(body: dict, headers) -> dict:
    """A request's priority class (``x-mtpu-priority``, else ``priority``;
    an unknown class is a 400) and tenant (``x-mtpu-tenant``, else OpenAI's
    ``user``)."""
    priority = body.get("priority") or DEFAULT_CLASS
    tenant = body.get("user") or "default"
    if headers is not None:
        priority = headers.get("x-mtpu-priority") or priority
        tenant = headers.get("x-mtpu-tenant") or tenant
    return {"priority": validate_class(str(priority)), "tenant": str(tenant)}


def _usage(req, n_prompt: int, n_out: int) -> dict:
    return {
        "prompt_tokens": n_prompt,
        "completion_tokens": n_out,
        "total_tokens": n_prompt + n_out,
        # prompt tokens served from the prefix cache (the page claim)
        "prompt_tokens_details": {"cached_tokens": req.cached_prompt_tokens},
    }


def _metrics_text(eng) -> str:
    """The ``/metrics`` body: the catalog's hand-built lines from the
    engine's stats and page pool, each skipped when the registry already
    owns the series, then the registry's exposition."""
    s = eng.stats
    reg_text = default_registry.expose()
    reg_names = set(re.findall(r"^# TYPE (\S+)", reg_text, re.M))
    occ = eng.cache.occupancy()
    hand_built = [
        (_C.GENERATED_TOKENS_TOTAL, f"{s.generated_tokens}"),
        (_C.PROMPT_TOKENS_TOTAL, f"{s.prompt_tokens}"),
        (_C.DECODE_STEPS_TOTAL, f"{s.steps}"),
        (_C.TOKENS_PER_SECOND, f"{s.tokens_per_second():.3f}"),
        (_C.ACTIVE_SLOTS, f"{sum(1 for sl in eng.slots if not sl.free)}"),
        (_C.WAITING_REQUESTS, f"{eng.policy.total_depth()}"),
        (_C.KV_PAGES_FREE, f"{occ['pages_free']}"),
        (_C.KV_PAGES_USED, f"{occ['pages_used']}"),
        (_C.KV_PAGE_OCCUPANCY, f"{occ['occupancy']:.4f}"),
        (_C.SCHEDULER_ERRORS_TOTAL, f"{eng.error_count}"),
    ]
    if eng.spec_gamma:
        hand_built += [
            (_C.SPEC_PROPOSED_TOTAL, f"{s.spec_proposed}"),
            (_C.SPEC_ACCEPTED_TOTAL, f"{s.spec_accepted}"),
            (_C.SPEC_ACCEPTANCE_RATE, f"{s.acceptance_rate():.4f}"),
        ]
    pc = eng.prefix_cache
    if pc is not None:
        hand_built += [
            (_C.PREFIX_CACHE_HITS_TOTAL, f"{pc.hits}"),
            (_C.PREFIX_CACHE_MISSES_TOTAL, f"{pc.misses}"),
            (_C.PREFIX_CACHED_PAGES, f"{pc.cached_pages}"),
            (_C.PREFIX_CACHE_EVICTIONS_TOTAL, f"{pc.evictions}"),
        ]
    lines = [f"{name} {value}" for name, value in hand_built if name not in reg_names]
    if _C.DECODE_IMPL not in reg_names:
        plan = eng.impl_plan
        lines.append(
            f'{_C.DECODE_IMPL}{{attention="{plan["attention"]}",scatter="{plan["scatter"]}",'
            f'kv_dtype="{plan["kv_dtype"]}",tp="{plan.get("tp", 1)}",variant="{plan.get("ragged_variant") or "-"}"}} 1'
        )
    return "\n".join(lines) + "\n" + reg_text


class _Handler(BaseHTTPRequestHandler):
    server_ref: "OpenAIServer"

    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, obj, extra_headers: dict | None = None) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _bad_request(self, message: str) -> None:
        self._json(400, {"error": {"message": message, "type": "invalid_request_error"}})

    def _shed_response(self, e: ShedError) -> None:
        """Admission refused: 429 with ``Retry-After``, OpenAI's rate-limit shape."""
        self._json(
            429,
            {"error": {"message": str(e), "type": "rate_limit_error", "code": e.reason}},
            extra_headers={"retry-after": str(math.ceil(e.retry_after_s))},
        )

    def do_GET(self):
        srv = self.server_ref
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/v1/models":
            self._json(200, {
                "object": "list",
                "data": [{"id": srv.model_name, "object": "model", "owned_by": "modal-examples-tpu"}],
            })
        elif self.path == "/metrics":
            body = _metrics_text(srv.engine).encode()
            self.send_response(200)
            self.send_header("content-type", "text/plain; version=0.0.4")
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        length = int(self.headers.get("content-length") or 0)
        try:
            body = json.loads(self.rfile.read(length)) if length else {}
        except json.JSONDecodeError:
            self._json(400, {"error": "invalid JSON"})
            return
        if self.path == "/v1/chat/completions":
            self._completions(body, chat=True)
        elif self.path == "/v1/completions":
            self._completions(body, chat=False)
        else:
            self._json(404, {"error": "not found"})

    def _completions(self, body: dict, chat: bool) -> None:
        srv = self.server_ref
        eng = srv.engine
        image = None
        try:
            if chat:
                messages, image = _extract_images(body.get("messages") or [])
                prompt = eng.tokenizer.apply_chat_template(messages)
            else:
                prompt = body.get("prompt") or ""
            if image is not None and eng.vision_cfg is None:
                raise ValueError("this model does not accept images (engine has no vision tower)")
            params = _params_from_body(body, self.headers)
            sched = _sched_kwargs(body, self.headers)
            eng.validate_params(params)
            n = max(1, int(body.get("n", 1)))  # n <= 0 serves one choice
            if n > 1 and params.seed is not None:  # the last choice's seed, seed + n - 1
                eng.validate_params(dataclasses.replace(params, seed=params.seed + n - 1))
        except (ValueError, TypeError, KeyError) as e:
            self._bad_request(str(e))
            return
        stream = bool(body.get("stream"))
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        created = int(time.time())
        kind = "chat.completion" if chat else "text_completion"
        if n > 1 and stream:
            self._bad_request("n > 1 with stream=true is not supported")
            return
        if n > 1:
            self._fan_out(eng, prompt, params, sched, n, rid, created, kind, chat, image)
            return
        try:
            req = srv.submit(prompt, params, image=image, **sched)
        except ShedError as e:
            self._shed_response(e)
            return
        n_prompt = len(req.prompt_tokens or [])
        if stream:
            include_usage = bool((body.get("stream_options") or {}).get("include_usage"))
            self._stream(eng, req, rid, created, kind, chat, include_usage, n_prompt)
            return
        text = "".join(srv.stream_request(req))
        if req.finish_reason == "error":
            self._json(500, _SERVER_ERROR, extra_headers={"x-mtpu-request-id": req.request_id})
            return
        n_out = len(eng.tokenizer.encode(text, add_bos=False))
        content = {"message": {"role": "assistant", "content": text}} if chat else {"text": text}
        self._json(200, {
            "id": rid, "object": kind, "created": created, "model": srv.model_name,
            "choices": [{"index": 0, **content, "finish_reason": req.finish_reason or "stop"}],
            "usage": _usage(req, n_prompt, n_out),
        }, extra_headers={"x-mtpu-request-id": req.request_id})

    def _fan_out(self, eng, prompt, params, sched, n, rid, created, kind, chat, image=None) -> None:
        """OpenAI's ``n``: one engine request per choice, batched by the
        engine. A given seed becomes ``seed + i`` for choice i (else every
        choice would be the same); without one each request draws its own.
        A shed part way aborts the admitted siblings and answers 429."""
        srv = self.server_ref
        reqs = []
        try:
            for i in range(n):
                p = dataclasses.replace(params, seed=params.seed + i) if params.seed is not None else params
                reqs.append(srv.submit(prompt, p, image=image, **sched))
        except ShedError as e:
            for r in reqs:
                srv.abort_request(r)
                for _ in srv.stream_request(r):
                    pass
            self._shed_response(e)
            return
        texts = ["".join(srv.stream_request(r)) for r in reqs]
        if any(r.finish_reason == "error" for r in reqs):
            self._json(500, _SERVER_ERROR)
            return
        choices = []
        for i, (r, text) in enumerate(zip(reqs, texts)):
            content = {"message": {"role": "assistant", "content": text}} if chat else {"text": text}
            choices.append({"index": i, **content, "finish_reason": r.finish_reason or "stop"})
        n_prompt = len(reqs[0].prompt_tokens or [])
        n_out = sum(len(eng.tokenizer.encode(t, add_bos=False)) for t in texts)
        self._json(200, {
            "id": rid, "object": kind, "created": created, "model": srv.model_name, "choices": choices,
            "usage": _usage(reqs[0], n_prompt, n_out),  # the choices share one prompt
        })

    def _stream(self, eng, req, rid, created, kind, chat, include_usage, n_prompt) -> None:
        self.send_response(200)
        self.send_header("content-type", "text/event-stream")
        self.send_header("cache-control", "no-cache")
        self.send_header("x-mtpu-request-id", req.request_id)
        self.end_headers()

        def send(obj) -> None:
            self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
            self.wfile.flush()

        def chunk_of(**fields) -> dict:
            chunk = {"id": rid, "object": kind + ".chunk", "created": created, "model": self.server_ref.model_name, **fields}
            if include_usage and "usage" not in chunk:
                chunk["usage"] = None  # content chunks carry null; the last one the totals
            return chunk

        srv = self.server_ref
        try:
            for piece in srv.stream_request(req):
                delta = {"delta": {"content": piece}} if chat else {"text": piece}
                send(chunk_of(choices=[{"index": 0, **delta, "finish_reason": None}]))
            if req.finish_reason == "error":
                send(_SERVER_ERROR)
            else:
                final = {"delta": {}} if chat else {"text": ""}
                send(chunk_of(choices=[{"index": 0, **final, "finish_reason": req.finish_reason or "stop"}]))
            if include_usage:
                send(chunk_of(choices=[], usage=_usage(req, n_prompt, req.n_generated)))
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except BrokenPipeError:
            # client went away: free the slot, drain to the terminal marker
            if req.finish_reason is None:
                srv.abort_request(req)
                for _ in srv.stream_request(req):
                    pass


class OpenAIServer:
    """HTTP front end; ``start()`` binds and serves in a background thread
    (``port=0`` picks a free port).

    Fronts ONE engine (``engine=``) or a router's replicas (``router=``):
    exactly one of the two. With a router, ``self.engine`` is the first
    replica that serves requests end to end (its tokenizer, ``/metrics`` and
    parameter checks stand for the fleet: the replicas serve one model)."""

    def __init__(self, engine: LLMEngine | None = None, model_name: str = "mtpu-llm", host: str = "127.0.0.1",
                 port: int = 8000, *, router=None):
        if (engine is None) == (router is None):
            raise ValueError("pass exactly one of engine= or router=")
        self.router = router
        if engine is None:
            # prefill-role replicas under a coordinator never own a request
            serving = [r for r in router.replicas if getattr(r, "serves_requests", True)]
            engine = (serving or router.replicas)[0].engine
        self.engine = engine
        self.model_name = model_name
        handler = type("BoundHandler", (_Handler,), {"server_ref": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: threading.Thread | None = None
        self._canary = None

    def submit(self, prompt, params, image=None, **sched):
        """Submit one request (``image``: a multimodal one) with its trace
        opened here, at the entry point (the request takes the trace's id),
        through the router when there is one. Raises ``ShedError``."""
        trace = _rt.start_request_trace(entry="api")
        if image is not None:
            sched = {**sched, "image": image}
        if self.router is not None:
            return self.router.submit(prompt, params, trace=trace, **sched)
        return self.engine.submit(prompt, params, trace=trace, **sched)

    def stream_request(self, req):
        """One submitted request's text pieces: through the router's
        failover path when there is one (a dead replica's streams resume on
        a peer, the overlap clipped), else the engine's stream."""
        if self.router is not None:
            return self.router.stream(req)
        return self.engine.stream(req)

    def abort_request(self, req) -> None:
        """Abort wherever the request lives now (after a failover, not
        necessarily the replica that first took it)."""
        if self.router is not None:
            self.router.abort(req)
        else:
            self.engine.abort(req)

    def _engines(self) -> list:
        """Engines whose scheduler loop this server owns: a coordinator's
        ``serving_engines()`` (a prefill replica's loop never runs), else
        every replica's, else the one engine."""
        if self.router is None:
            return [self.engine]
        serving = getattr(self.router, "serving_engines", None)
        return serving() if serving is not None else [r.engine for r in self.router.replicas]

    def _maybe_start_canary(self) -> None:
        """``MTPU_CANARY_INTERVAL`` arms the golden-set prober over a router
        front's replicas (a coordinator's weight-bearing router underneath)."""
        import os

        from ..observability.canary import INTERVAL_ENV, CanaryProber

        if self.router is None or not os.environ.get(INTERVAL_ENV):
            return
        self._canary = CanaryProber(getattr(self.router, "router", self.router)).start()

    def start(self) -> "OpenAIServer":
        for eng in self._engines():
            eng.start()
        self._maybe_start_canary()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._canary is not None:
            self._canary.stop()
            self._canary = None
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for eng in self._engines():
            eng.stop()
