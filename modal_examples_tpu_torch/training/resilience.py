"""Failure detection & elastic recovery (SURVEY.md §5.3).

Counterpart of ``modal_examples_tpu/training/resilience.py``:
``PreemptionGuard`` and ``run_resilient`` are copies (pure Python);
``device_health`` probes each visible CUDA device.

The reference's interruption tolerance is retry+resume plumbing
(long-training.py:109-137 deliberately times out to exercise it; preemption
handling is "same checkpoint/retry pattern", unsloth_finetune.py:99-101).
The TPU additions SURVEY calls for:

- :class:`PreemptionGuard` — SIGTERM/SIGINT => emergency checkpoint before
  the container dies (TPU spot/preemption notices arrive as SIGTERM);
- :func:`run_resilient` — the checkpoint-every-N + resume-from-latest loop
  as one function, with the guard installed, so every training example gets
  the full story in one call;
- :func:`device_health` — slice-health probe (a tiny collective/computation
  per device; a sick chip raises here rather than mid-step).
"""

from __future__ import annotations

import signal
import threading
from typing import Any, Callable, Iterable


class PreemptionGuard:
    """Install once around a training loop; ``should_stop`` flips on
    SIGTERM/SIGINT and ``on_preempt`` (e.g. emergency checkpoint save) runs
    exactly once, synchronously with the loop (not in the signal handler)."""

    def __init__(self, on_preempt: Callable[[], None] | None = None):
        self._stop = threading.Event()
        self._on_preempt = on_preempt
        self._ran_hook = False
        self._prev_handlers: dict[int, Any] = {}

    def __enter__(self) -> "PreemptionGuard":
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread: polling still works
                pass
        return self

    def __exit__(self, *exc) -> bool:
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        return False

    def _handler(self, signum, frame) -> None:
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def checkpoint_now_if_preempted(self) -> bool:
        """Call between steps: runs the emergency hook once after a signal."""
        if self._stop.is_set() and not self._ran_hook:
            self._ran_hook = True
            if self._on_preempt is not None:
                self._on_preempt()
            return True
        return False


def run_resilient(
    trainer,
    state,
    batches: Iterable,
    ckpt_manager,
    *,
    start_step: int = 0,
    total_steps: int,
    save_every: int = 50,
    on_metrics: Callable[[int, dict], None] | None = None,
):
    """Train with periodic checkpoints + emergency save on preemption.

    Resume pattern: restore ``state`` + ``start_step`` from
    ``ckpt_manager.latest_step()`` BEFORE calling (see
    examples/06_gpu_and_ml/llm-finetuning/lora_finetune.py). Returns
    (state, last_step, preempted)."""
    step = start_step
    it = iter(batches)

    def emergency_save():
        ckpt_manager.save(step, {"state": state})

    with PreemptionGuard(emergency_save) as guard:
        while step < total_steps:
            if guard.checkpoint_now_if_preempted():
                return state, step, True
            try:
                batch = next(it)
            except StopIteration:
                break
            state, metrics = trainer.train_step(state, batch)
            step += 1
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % save_every == 0 or step == total_steps:
                ckpt_manager.save(step, {"state": state})
    return state, step, False


def device_health() -> dict:
    """Probe every visible CUDA device with a tiny computation; raises on a
    sick card, or when no card is visible (run before long jobs and on a
    schedule)."""
    import torch

    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible to probe")
    report = {}
    for i in range(n):
        d = torch.device("cuda", i)
        x = torch.ones((8, 8), device=d)
        y = float((x @ x).sum())  # (ones@ones)[i,j] = 8; 64 elements
        ok = y == 8.0**3
        report[str(d)] = "ok" if ok else f"BAD result {y}"
        if not ok:
            raise RuntimeError(f"device {d} failed health check: {y}")
    return report
