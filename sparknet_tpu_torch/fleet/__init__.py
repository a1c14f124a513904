"""`sparknet_tpu_torch.fleet` — the serve control plane of the port:
signal-driven replica autoscaling, priority-aware admission pressure,
SLO-burn shedding, and the staggered rollout duty.

The counterpart of `sparknet_tpu.fleet`, with its `__all__`. It closes
the loop from the signals the obs stack exports (windowed p99 against
the SLO, queue depth, shed rate, replica heartbeat health, the burn-rate
alerter's pages) to actions on a `ModelRouter` fleet:

  - `FleetController` (controller.py): the fixed-cadence loop — SLO burn
    per model, admission pressure (the fast lever, into
    `serve.admission.PriorityAdmission`, floored at `page_pressure`
    while a page fires), replica grow/retire and shared-pool resize
    (the slow levers) under hysteresis, cooldowns and per-model min/max
    bounds; dead-replica replacement; the rollout duty; the scale-event
    audit trail behind `/fleet/status`.
  - `FleetPolicy` / `ModelSignals` (policy.py): the pure decision logic.
  - `ReplicaProvider` (provider.py): where capacity comes from —
    `SubprocessReplicaProvider` spawns the port's serve CLI over
    spkn:// (on the card by default); `PodReplicaProvider` is the
    `tpu_pod_launch.sh`-protocol stub.
  - `RolloutManager` (rollout.py): staggered checkpoint adoption
    (canary -> health-gated waves -> fleet-wide) through an atomically
    replaced ROLLOUT.json gate the serving ModelManagers obey, with
    halt-and-rollback on a rejected canary step.

Enable from the CLI with `python -m sparknet_tpu_torch.serve.app
--models ... --autoscale` (+ `--rollout-gate` for staggered adoption).
"""
from .controller import FleetConfig, FleetController
from .policy import FleetPolicy, ModelSignals, slo_burn
from .provider import (PodReplicaProvider, ReplicaHandle,
                       ReplicaProvider, SubprocessReplicaProvider)
from .rollout import ReplicaView, RolloutManager, read_gate, write_gate

__all__ = [
    "FleetController", "FleetConfig",
    "FleetPolicy", "ModelSignals", "slo_burn",
    "ReplicaProvider", "ReplicaHandle",
    "SubprocessReplicaProvider", "PodReplicaProvider",
    "RolloutManager", "ReplicaView", "read_gate", "write_gate",
]
