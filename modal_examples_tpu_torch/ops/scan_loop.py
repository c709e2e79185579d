"""Masked early-exit scan: the macro-step decode loop's control-flow core.

Counterpart of ``modal_examples_tpu/ops/scan_loop.py`` (``masked_scan``).
:func:`masked_scan` runs a per-step body over the leading axis of its inputs
while any lane of a boolean ``live`` mask is still set; a step after the
last lane died yields ``hold``'s output and passes the carry through.

The contract mirrors ``lax.scan`` with a mask threaded through:

- ``step(live, state, x) -> (live', state', out)``. It must keep dead lanes
  inert itself (``torch.where(live, ...)``): the mask only decides whole
  steps, not single lanes.
- ``hold(live, state, x) -> out`` produces the output of a skipped step
  (typically the held tokens plus an all-false validity row), with the same
  shapes and dtypes as ``step``'s ``out``, a tuple of tensors.

The JAX version decides each step with ``lax.cond(any(live), ...)`` inside
its program. Reading the mask on the host here would wait for the previous
step's work before the next step could be launched, and so serialize the
whole dispatch against the device. So the test stays on the device: every
step runs ``step`` and ``hold`` and selects, with ``any(live)`` as a device
tensor, between their outputs and between the new carry and the old one. A
dead lane writes nothing ``step`` does not already allow it to write (its
own pages or the trash page), so running the body on an all-dead step gives
the same outputs and carry as skipping it. The loop never waits on the card.
"""

from __future__ import annotations

import torch


def _select(flag, a, b):
    """``a`` where the 0-d bool tensor ``flag`` holds, else ``b``, over tuples."""
    if isinstance(a, tuple):
        return tuple(_select(flag, x, y) for x, y in zip(a, b))
    return torch.where(flag, a, b)


def masked_scan(step, hold, live0, state0, xs):
    """Loop ``step`` over ``xs`` (its leading axis) carrying ``(live, state)``;
    once no lane is live, ``hold`` gives each remaining step's output and the
    carry passes through, decided on the device. Returns ``(live, state,
    outs)``, ``outs`` the tuple of each output stacked along the leading axis
    like ``lax.scan``."""
    live, state = live0, state0
    outs = []
    for x in xs:
        running = live.any()  # a device tensor: no host read
        new_live, new_state, out = step(live, state, x)
        out = _select(running, out, hold(live, state, x))
        live = torch.where(running, new_live, live)
        state = _select(running, new_state, state)
        outs.append(out)
    return live, state, tuple(torch.stack(col) for col in zip(*outs))
