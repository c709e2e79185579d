"""Admission for the port's engine: a bounded FIFO waiting queue that sheds.

The minimum of ``modal_examples_tpu/scheduling/admission.py`` the engine and
the OpenAI server need: :class:`ShedError` (HTTP 429 upstream) and a waiting
queue with a depth bound. Priority classes, fair share and deadlines are not
ported yet.
"""

from __future__ import annotations

import collections
import threading


class ShedError(RuntimeError):
    """Request rejected by admission control. API layers translate this to
    HTTP 429 with ``Retry-After: ceil(retry_after_s)``."""

    def __init__(self, reason: str, retry_after_s: float, message: str):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = max(1.0, float(retry_after_s))


#: base back-off hint for a shed request, scaled up with queue depth
RETRY_AFTER_S = 1.0


class WaitingQueue:
    """Thread-safe FIFO of submitted requests, at most ``max_depth`` deep."""

    def __init__(self, max_depth: int = 4096):
        self.max_depth = max_depth
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def submit(self, item) -> None:
        """Enqueue, or raise :class:`ShedError` when the queue is full."""
        with self._lock:
            depth = len(self._q)
            if depth >= self.max_depth:
                raise ShedError(
                    "queue_full",
                    RETRY_AFTER_S * (1.0 + depth / max(1, self.max_depth)),
                    f"waiting queue full ({depth}/{self.max_depth})",
                )
            self._q.append(item)

    def pop(self, n: int) -> list:
        """Up to ``n`` items, oldest first."""
        with self._lock:
            return [self._q.popleft() for _ in range(min(n, len(self._q)))]

    def requeue_front(self, items: list) -> None:
        """Put popped items back at the front, in their original order."""
        with self._lock:
            self._q.extendleft(reversed(items))

    def remove(self, item) -> bool:
        with self._lock:
            try:
                self._q.remove(item)
            except ValueError:
                return False
            return True

    def drain(self) -> list:
        with self._lock:
            items = list(self._q)
            self._q.clear()
            return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)
