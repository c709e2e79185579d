"""Detokenization worker: incremental decode and stream emission off the
scheduler thread.

Copied from ``modal_examples_tpu/serving/multistep/detok.py``
(``DetokWorker``), with the standard library's logger. With N decode steps
per dispatch the scheduler would pay ``tokenizer.decode`` N times per
harvest; this worker moves it off-thread. The scheduler feeds ACCEPTED token
ids (already booked: counts, first-token time and length checks stay on the
scheduler, where the harvest-boundary invariants live) and the worker owns
everything text: incremental decode, stop-string scan and truncation, the
stop-safe and unstable-tail holdback, emission to ``req.out_queue``, and the
``req.emitted_len`` mirror (put, then update: ``emitted_len`` never exceeds
what the client was sent).

Ordering contract: one FIFO queue. Text chunks and the terminal marker of a
request are delivered in feed order because the engine routes the finish
marker through :meth:`finish` for every request the worker owns, so a marker
never overtakes held text. Stop-string hits are seen only here, so the worker
requests teardown by setting ``req.aborted``; the scheduler's next-tick reap
frees the slot and routes the "stop" marker back through the queue.

:meth:`flush` is a barrier: it waits until everything enqueued so far is
processed. A worker that dies leaves the engine serving: it falls back to
inline detokenization and direct marker delivery (``alive`` gates every
route).
"""

from __future__ import annotations

import logging
import queue
import threading

_log = logging.getLogger(__name__)


class DetokWorker:
    """One daemon thread per engine, created at the first routed token (the
    engine routes only while ``decode_steps > 1`` or for requests this worker
    already owns, so a knob flip mid-stream never reorders a stream)."""

    def __init__(self, *, tokenizer, deliver, safe_len, unstable_tail,
                 name: str = "engine"):
        self._tokenizer = tokenizer
        self._deliver = deliver  # engine._deliver_finish(req, marker)
        self._safe_len = safe_len
        self._unstable_tail = unstable_tail
        self._states: dict = {}  # request_id -> per-stream text state
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._stopping = False
        self._thread = threading.Thread(
            target=self._run, name=f"mtpu-detok-{name}", daemon=True
        )
        self._thread.start()

    # -- scheduler-thread API ------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._stopping

    def owns(self, req) -> bool:
        with self._lock:
            return req.request_id in self._states

    def register(self, req, prior_tokens: list, emitted_len: int) -> None:
        """Adopt a stream. ``prior_tokens``/``emitted_len`` seed the text
        state: the tokens accepted before this one and the text already
        emitted for them."""
        with self._lock:
            self._states[req.request_id] = {
                "req": req,
                "tokens": list(prior_tokens),
                "emitted": int(emitted_len),
                "stopped": False,
            }

    def feed(self, req, token: int) -> None:
        """Enqueue one ACCEPTED (appended) token for decode and emission."""
        self._q.put(("tok", req, token))

    def finish(self, req, marker) -> None:
        """Enqueue the terminal marker behind any pending text."""
        self._q.put(("fin", req, marker))

    def flush(self, timeout: float = 5.0) -> bool:
        """Barrier: wait until everything enqueued so far is processed."""
        if not self.alive:
            return True
        done = threading.Event()
        self._q.put(("flush", done, None))
        return done.wait(timeout)

    def queue_depth(self) -> int:
        return self._q.qsize()

    def stop(self, timeout: float = 5.0) -> None:
        """Drain every pending event, then stop the thread (the engine's
        ``stop()`` calls this BEFORE releasing callers, so held text lands
        ahead of the release sweep's direct markers)."""
        self._stopping = True
        self._q.put(("end", None, None))
        self._thread.join(timeout)

    # -- worker thread -------------------------------------------------------

    def _run(self) -> None:
        while True:
            kind, a, b = self._q.get()
            if kind == "end":
                return
            try:
                if kind == "flush":
                    a.set()
                elif kind == "tok":
                    self._on_token(a, b)
                else:
                    self._on_finish(a, b)
            except Exception:
                # a text-path bug must not wedge streams: keep draining (the
                # engine's alive-gate handles a dead worker; a throwing event
                # just loses its chunk)
                _log.exception("detok worker event failed")

    def _on_token(self, req, token: int) -> None:
        with self._lock:
            st = self._states.get(req.request_id)
        if st is None or st["stopped"]:
            return
        st["tokens"].append(int(token))
        text = self._tokenizer.decode(st["tokens"])
        stop = req.params.stop
        if stop:
            for stop_s in stop:
                idx = text.find(stop_s)
                if idx >= 0:
                    # truncate, emit the remainder, and hand teardown to the
                    # scheduler: only it may free the slot
                    st["stopped"] = True
                    self._emit(req, st, text[:idx], final=True)
                    req.aborted = True
                    return
        self._emit(req, st, text, final=False)

    def _on_finish(self, req, marker) -> None:
        with self._lock:
            st = self._states.pop(req.request_id, None)
        if st is not None:
            if st["stopped"] and marker.reason == "length":
                # the stop match landed before a length finish in the same
                # harvest: the stream was truncated at the stop, report it
                marker = type(marker)("stop")
            elif not st["stopped"] and marker.reason in ("stop", "length"):
                # normal finish: flush the holdback tail
                text = self._tokenizer.decode(st["tokens"])
                self._emit(req, st, text, final=True)
            # abort or error: held text drops, like the inline path
        self._deliver(req, marker)

    def _emit(self, req, st: dict, text: str, *, final: bool) -> None:
        safe = len(text) if final else self._safe_len(text, req.params.stop)
        new = text[st["emitted"]:safe]
        if new and (final or not self._unstable_tail(new)):
            req.out_queue.put(new)
            st["emitted"] += len(new)
            req.emitted_len = st["emitted"]
