"""Training: the train step, optimizer, checkpoint/resume and preemption
handling of the port (counterpart of ``modal_examples_tpu/training``)."""

from .checkpoints import CheckpointManager
from .resilience import PreemptionGuard, device_health, run_resilient
from .trainer import (
    TrainState,
    Trainer,
    cross_entropy_loss,
    make_optimizer,
    warmup_cosine,
)

__all__ = [
    "CheckpointManager",
    "PreemptionGuard",
    "TrainState",
    "Trainer",
    "cross_entropy_loss",
    "device_health",
    "make_optimizer",
    "run_resilient",
    "warmup_cosine",
]
