"""Copy of ``modal_examples_tpu/utils/stats.py``: the port keeps its own instance.

Tiny shared statistics helpers (pure stdlib, jax-free).

One nearest-rank percentile for the whole repo: bench.py's latency
sections, the fleet load generator, and the hot-path profiler's
``overhead`` section all quantize through THIS function, so
``tpurun benchdiff`` never compares sections computed under two drifted
rank conventions.
"""

from __future__ import annotations


def percentile_nearest_rank(values, q: float) -> float:
    """Nearest-rank percentile over a small sample (no numpy on purpose:
    callers must emit even when the episode count is tiny). ``values``
    need not be sorted; empty input returns 0.0."""
    vals = sorted(values)
    if not vals:
        return 0.0
    idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
    return vals[idx]
