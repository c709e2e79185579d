"""Fault injection, after ``modal_examples_tpu/faults/``: the port has
:mod:`.inject` (the fault-point catalog, seeded plans, the gate). The chaos
runner ``faults/chaos.py`` waits with the fleet (ROADMAP A9)."""

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
