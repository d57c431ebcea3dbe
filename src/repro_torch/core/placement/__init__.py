"""The cluster control plane (docs/planner.md).

``repro_torch.core.placement`` is the one home for every cluster-level
dispatch decision, shared byte-for-byte by the threaded
``ClusterRuntime`` and the virtual-time ``Simulator``:

* :mod:`.scoring` — per-request policies (``random``/``locality``/
  ``least_loaded``): :class:`NodeSnapshot` + :func:`choose_node`,
  refactored here from the old ``repro_torch.core.dispatch`` module (which
  remains as a re-export shim).
* :mod:`.planner` — ``dispatch="planned"``: the
  :class:`PlacementPlanner` function→node residency map (greedy
  bin-packing by bytes × arrival rate, incremental repair on churn).
* :mod:`.autoscaler` — the ``autoscale=`` knob: per-function EWMA
  arrival forecast → target node count with hysteresis.
* :mod:`.control` — :class:`PlacementControl`, the facade the drivers
  call (routing, work stealing, control ticks, node-seconds timeline).
"""
from repro_torch.core.placement.autoscaler import (  # noqa: F401
    AutoscaleConfig, Autoscaler, RateForecast, resolve_autoscale,
)
from repro_torch.core.placement.control import PlacementControl  # noqa: F401
from repro_torch.core.placement.planner import (  # noqa: F401
    PlacementPlanner, PlannerConfig,
)
from repro_torch.core.placement.scoring import (  # noqa: F401
    DISPATCH_POLICIES, TIER_SCORE, TIERS, NodeSnapshot, choose_node,
    locality_score,
)
