"""Fault injection, after ``modal_examples_tpu/faults/``.

Two halves with a layering rule between them:

- :mod:`.inject`: the fault-point catalog, seeded plans, and the zero-cost
  activation gate. Production code wires its injection points through it.
- :mod:`.chaos`: the seeded chaos runner that drives a multi-replica fleet
  through fault episodes and asserts fleet invariants. It is a driver:
  tests and operators import it; no module of the port does.

Only the inject surface is re-exported here, so importing
``modal_examples_tpu_torch.faults`` never drags the chaos driver (and its
serving imports) into a production module.
"""

from .inject import (  # noqa: F401
    ALL_FAULT_POINTS,
    POINTS,
    FaultError,
    FaultPlan,
    activate,
    active,
    active_plan,
    check,
    corrupt,
    deactivate,
    fire,
)
