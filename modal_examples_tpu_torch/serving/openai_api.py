"""OpenAI-compatible HTTP server over one LLM engine.

Counterpart of ``modal_examples_tpu/serving/openai_api.py`` for a single
engine: ``/health``, ``/v1/models``, ``/v1/completions`` and
``/v1/chat/completions``, JSON or SSE streaming (with the
``stream_options.include_usage`` usage chunk), 400 on bad parameters and 429
with ``Retry-After`` when admission sheds. Stdlib HTTP, a thread per
connection; the engine's continuous batching does the multiplexing. Not in
this slice: the router front, ``n > 1``, images, ``/metrics``, deadlines and
priority classes other than ``default`` (each a 400).
"""

from __future__ import annotations

import json
import math
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..scheduling.admission import ShedError
from ..scheduling.policy import DEFAULT_CLASS, validate_class
from .engine import LLMEngine
from .sampling import SamplingParams


def _check_scheduling(body: dict, headers=None) -> None:
    """The reference's scheduling fields, refused until the engine has them
    (ROADMAP A6): a deadline (``deadline_ms`` or the ``x-mtpu-deadline-ms``
    header) and a priority class other than ``default`` (``priority`` or
    ``x-mtpu-priority``) are a 400; an unknown class is the reference's 400."""
    deadline_ms = body.get("deadline_ms")
    priority = body.get("priority") or DEFAULT_CLASS
    if headers is not None:
        deadline_ms = headers.get("x-mtpu-deadline-ms") or deadline_ms
        priority = headers.get("x-mtpu-priority") or priority
    priority = validate_class(str(priority))
    if deadline_ms is not None:
        raise ValueError("request deadlines (deadline_ms, x-mtpu-deadline-ms) are not supported yet (ROADMAP A6)")
    if priority != DEFAULT_CLASS:
        raise ValueError(f"priority class {priority!r} is not supported yet: this engine serves one FIFO (ROADMAP A6)")


def _params_from_body(body: dict) -> SamplingParams:
    stop = body.get("stop")
    return SamplingParams(
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        max_tokens=int(body.get("max_tokens", 128)),
        stop=tuple([stop] if isinstance(stop, str) else stop or []),
        seed=int(body["seed"]) if body.get("seed") is not None else None,
    )


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

    def do_GET(self):
        srv = self.server_ref
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/v1/models":
            self._json(200, {
                "object": "list",
                "data": [{"id": srv.model_name, "object": "model", "owned_by": "modal-examples-tpu"}],
            })
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        length = int(self.headers.get("content-length") or 0)
        try:
            body = json.loads(self.rfile.read(length)) if length else {}
        except json.JSONDecodeError:
            self._bad_request("invalid JSON")
            return
        if self.path == "/v1/chat/completions":
            self._completions(body, chat=True)
        elif self.path == "/v1/completions":
            self._completions(body, chat=False)
        else:
            self._json(404, {"error": "not found"})

    def _completions(self, body: dict, chat: bool) -> None:
        eng = self.server_ref.engine
        try:
            if int(body.get("n", 1)) != 1:
                raise ValueError("n != 1 is not supported")
            if chat:
                prompt = eng.tokenizer.apply_chat_template(body.get("messages") or [])
            else:
                prompt = body.get("prompt") or ""
            params = _params_from_body(body)
            _check_scheduling(body, self.headers)
            eng.validate_params(params)
        except (ValueError, TypeError, KeyError) as e:
            self._bad_request(str(e))
            return
        try:
            req = eng.submit(prompt, params)
        except ShedError as e:
            self._json(
                429,
                {"error": {"message": str(e), "type": "rate_limit_error", "code": e.reason}},
                extra_headers={"retry-after": str(math.ceil(e.retry_after_s))},
            )
            return
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        created = int(time.time())
        kind = "chat.completion" if chat else "text_completion"
        n_prompt = len(req.prompt_tokens or [])
        if body.get("stream"):
            include_usage = bool((body.get("stream_options") or {}).get("include_usage"))
            self._stream(eng, req, rid, created, kind, chat, include_usage, n_prompt)
            return
        text = "".join(eng.stream(req))
        if req.finish_reason == "error":
            self._json(500, {"error": {"message": "engine error while processing the request", "type": "server_error"}})
            return
        n_out = len(eng.tokenizer.encode(text, add_bos=False))
        content = {"message": {"role": "assistant", "content": text}} if chat else {"text": text}
        self._json(200, {
            "id": rid, "object": kind, "created": created, "model": self.server_ref.model_name,
            "choices": [{"index": 0, **content, "finish_reason": req.finish_reason or "stop"}],
            "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_out, "total_tokens": n_prompt + n_out},
        }, extra_headers={"x-request-id": req.request_id})

    def _stream(self, eng, req, rid, created, kind, chat, include_usage, n_prompt) -> None:
        self.send_response(200)
        self.send_header("content-type", "text/event-stream")
        self.send_header("cache-control", "no-cache")
        self.send_header("x-request-id", req.request_id)
        self.end_headers()

        def send(obj) -> None:
            self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
            self.wfile.flush()

        def chunk_of(**fields) -> dict:
            chunk = {"id": rid, "object": kind + ".chunk", "created": created, "model": self.server_ref.model_name, **fields}
            if include_usage and "usage" not in chunk:
                chunk["usage"] = None  # content chunks carry null; the last one the totals
            return chunk

        try:
            for piece in eng.stream(req):
                delta = {"delta": {"content": piece}} if chat else {"text": piece}
                send(chunk_of(choices=[{"index": 0, **delta, "finish_reason": None}]))
            if req.finish_reason == "error":
                send({"error": {"message": "engine error while processing the request", "type": "server_error"}})
            else:
                final = {"delta": {}} if chat else {"text": ""}
                send(chunk_of(choices=[{"index": 0, **final, "finish_reason": req.finish_reason or "stop"}]))
            if include_usage:
                send(chunk_of(choices=[], usage={
                    "prompt_tokens": n_prompt,
                    "completion_tokens": req.n_generated,
                    "total_tokens": n_prompt + req.n_generated,
                }))
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except BrokenPipeError:
            # client went away: free the slot, drain to the terminal marker
            if req.finish_reason is None:
                eng.abort(req)
                for _ in eng.stream(req):
                    pass


class OpenAIServer:
    """HTTP front end for one engine; ``start()`` binds and serves in a
    background thread (``port=0`` picks a free port)."""

    def __init__(self, engine: LLMEngine, model_name: str = "mtpu-llm", host: str = "127.0.0.1", port: int = 8000):
        self.engine = engine
        self.model_name = model_name
        handler = type("BoundHandler", (_Handler,), {"server_ref": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> "OpenAIServer":
        self.engine.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.engine.stop()
