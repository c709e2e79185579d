"""Copy of ``modal_examples_tpu/core/retries.py``: retry policies for serverless functions.

Reference spec: ``retries=modal.Retries(initial_delay=0.0, max_retries=10)``
plus ``timeout=`` and ``single_use_containers=True`` drive the
interruption-tolerant training loop in 06_gpu_and_ml/long-training.py:109-137;
a bare integer (``retries=3``) is also accepted (train.py:38-39).

Backoff is exponential with **deterministic, seedable jitter**: a fixed
exponential schedule synchronizes retry storms — N replicas that fail
together retry together, forever (the thundering-herd failure the chaos
harness exercises, docs/faults.md). Passing a per-caller ``key`` (the
executor uses the input id, the disagg transport its transfer id)
decorrelates the waits while keeping every delay reproducible from
``(key, attempt)`` alone — no RNG state, no flaky tests.
"""

from __future__ import annotations

import dataclasses

from ..utils.determinism import unit_float as _unit_float


@dataclasses.dataclass(frozen=True)
class Retries:
    max_retries: int = 2
    backoff_coefficient: float = 2.0
    initial_delay: float = 1.0
    max_delay: float = 60.0
    #: fraction of each delay that jitters DOWNWARD (0 = fixed schedule,
    #: 0.5 = "equal jitter": delay in [d/2, d]). Jitter only ever shortens
    #: a wait, so the exponential schedule stays the worst-case retry
    #: budget: total wait <= sum of the un-jittered delays.
    jitter: float = 0.5

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_coefficient < 1.0:
            raise ValueError("backoff_coefficient must be >= 1.0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def delay_for_attempt(self, attempt: int, *, key: str | None = None) -> float:
        """Delay before retry number ``attempt`` (1-based).

        Without ``key`` the delay is the bare exponential schedule (exact,
        test-friendly). With ``key`` (callers pass their input/transfer
        id), the delay is deterministically jittered into
        ``[d * (1 - jitter), d]`` so concurrent retriers spread out instead
        of stampeding in lockstep."""
        d = self.initial_delay * (self.backoff_coefficient ** max(0, attempt - 1))
        d = min(d, self.max_delay)
        if key is None or not self.jitter:
            return d
        return d * (1.0 - self.jitter * _unit_float(key, attempt))


def normalize_retries(retries: "Retries | int | None") -> Retries | None:
    if retries is None:
        return None
    if isinstance(retries, Retries):
        return retries
    if isinstance(retries, int):
        return Retries(max_retries=retries, initial_delay=1.0)
    raise TypeError(f"retries must be an int or Retries, got {type(retries)!r}")
