"""apex_tpu_torch.fleetctl — the fleet control plane (docs/serving.md).

Counterpart of ``apex_tpu/fleetctl/``.

Multi-replica serving that survives replica death, preemption storms,
and rolling deploys: in-process :class:`EngineReplica`\\ s (each its
own engine/scheduler/pool/registry) behind one :class:`Router`, with
burn-rate :class:`Autoscaler` capacity control and a deterministic
:class:`Fleet` tick loop drillable on a virtual clock
(``apex_tpu_torch.tools.fleet_drill``).  Rolling deploys can be canary-gated
(``start_rolling_update(..., canary=CanaryConfig(...))``): golden-probe
fingerprints + statistical drift verdicts with auto-halt and rollback
(:mod:`apex_tpu_torch.observability.canary`, ``apex_tpu_torch.tools.canary_drill``).
"""

from apex_tpu_torch.observability.canary import CanaryConfig  # noqa: F401

from apex_tpu_torch.fleetctl.autoscale import Autoscaler, AutoscalerConfig
from apex_tpu_torch.fleetctl.fleet import Fleet, declare_fleet_metrics
from apex_tpu_torch.fleetctl.replica import (
    DEAD,
    DRAINING,
    EJECTED,
    LIVE,
    EngineReplica,
)
from apex_tpu_torch.fleetctl.router import Router, aggregate_expositions

__all__ = [
    "LIVE",
    "DRAINING",
    "EJECTED",
    "DEAD",
    "EngineReplica",
    "Router",
    "aggregate_expositions",
    "Autoscaler",
    "AutoscalerConfig",
    "Fleet",
    "declare_fleet_metrics",
    "CanaryConfig",
]
