"""Copy of ``modal_examples_tpu/utils/determinism.py``: the port keeps its own instance.

Deterministic pseudo-randomness derived from hashing, not RNG state.

The framework never wants *surprising* randomness in its control paths —
retry jitter must not make tests flaky, fault plans must replay from a
seed — but it does want *decorrelation*: N replicas keyed differently must
not act in lockstep. Hashing the inputs gives both: stable across
processes, platforms, and python hash randomization, with no state to
carry. jax-free by construction (the ``core/`` layer imports this).
"""

from __future__ import annotations

import hashlib


def unit_float(*parts) -> float:
    """Deterministic uniform in [0, 1) from the ``:``-joined ``parts``
    (each stringified) — e.g. ``unit_float(key, attempt)`` for retry
    jitter, ``unit_float(seed, point, hit)`` for fault-plan coins."""
    digest = hashlib.sha256(
        ":".join(str(p) for p in parts).encode()
    ).digest()
    return int.from_bytes(digest[:8], "little") / 2**64
