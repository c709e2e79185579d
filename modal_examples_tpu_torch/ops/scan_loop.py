"""Masked early-exit scan: the macro-step decode loop's control-flow core.

Counterpart of ``modal_examples_tpu/ops/scan_loop.py`` (``masked_scan``).
:func:`masked_scan` runs a per-step body over the leading axis of its inputs
while any lane of a boolean ``live`` mask is still set, and runs ``hold``
(no transformer math) for every step after the last lane died.

The contract mirrors ``lax.scan`` with a mask threaded through:

- ``step(live, state, x) -> (live', state', out)`` runs when any lane is
  live. It must keep dead lanes inert itself (``torch.where(live, ...)``):
  the mask only short-circuits whole steps, not single lanes.
- ``hold(live, state, x) -> out`` produces the output of a skipped step
  (typically the held tokens plus an all-false validity row), with the same
  shapes and dtypes as ``step``'s ``out``, a tuple of tensors.

The JAX version tests ``any(live)`` inside its program (``lax.cond``). Here
PyTorch runs eagerly, so the test happens on the host before each step: one
small device-to-host read of the live mask per step, which waits for the
previous step's work to finish before the next step is launched.
"""

from __future__ import annotations

import torch


def masked_scan(step, hold, live0, state0, xs):
    """Loop ``step`` over ``xs`` (its leading axis) carrying ``(live, state)``;
    once no lane is live, ``hold`` gives each remaining step's output and the
    carry passes through. Returns ``(live, state, outs)``, ``outs`` the tuple
    of each output stacked along the leading axis like ``lax.scan``."""
    live, state = live0, state0
    outs = []
    for x in xs:
        if bool(live.any()):  # the step's one host read
            live, state, out = step(live, state, x)
        else:
            out = hold(live, state, x)
        outs.append(out)
    return live, state, tuple(torch.stack(col) for col in zip(*outs))
