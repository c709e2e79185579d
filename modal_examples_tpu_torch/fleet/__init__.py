"""The fleet layer, after ``modal_examples_tpu/fleet/``: closed-loop replica
autoscaling and the production load harness.

- :mod:`.autoscaler`: :class:`FleetAutoscaler`, a closed-loop controller
  that grows and shrinks prefill and decode replicas behind a
  ``PrefixAffinityRouter`` from SLO burn rate, per-class queue depth and
  KV-page pressure, with hysteresis, cooldown and snapshot-restored warm
  boots (:class:`SnapshotWarmFactory`). Every decision is journaled to
  ``<state_dir>/fleet.jsonl`` and counted in the fleet series
  (``python -m modal_examples_tpu_torch fleet``, the gateway's ``/fleet``).
- :mod:`.loadgen`: an open-loop load generator (Poisson or heavy-tail
  arrivals, mixed request classes with per-class SLOs, multi-tenant
  shared-prefix populations) driving the OpenAI endpoint. It is a driver,
  like ``faults.chaos``: no module of the port imports it.
"""

from __future__ import annotations

from .autoscaler import FleetAutoscaler, SnapshotWarmFactory

__all__ = ["FleetAutoscaler", "SnapshotWarmFactory"]
