"""Request scheduling for the port, after ``modal_examples_tpu/scheduling``:
the queue policies (:mod:`.policy`), admission control with shedding and
deadlines (:mod:`.admission`), and the prefix-affinity multi-replica router
(:mod:`.router`). Torch-free: it runs on the control path."""

from .admission import AdmissionConfig, AdmissionController, ShedError
from .policy import (
    CLASS_RANK,
    DEFAULT_CLASS,
    PRIORITY_CLASSES,
    FairSharePolicy,
    FIFOPolicy,
    ScheduledRequest,
    SchedulerPolicy,
    validate_class,
)
from .router import EngineReplica, PrefixAffinityRouter

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "CLASS_RANK",
    "DEFAULT_CLASS",
    "EngineReplica",
    "FIFOPolicy",
    "FairSharePolicy",
    "PRIORITY_CLASSES",
    "PrefixAffinityRouter",
    "ScheduledRequest",
    "SchedulerPolicy",
    "ShedError",
    "validate_class",
]
