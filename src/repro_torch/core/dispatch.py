"""Back-compat shim: dispatch scoring moved to ``repro_torch.core.placement``.

The per-request scoring (``NodeSnapshot``/``choose_node``/
``locality_score``) now lives in :mod:`repro_torch.core.placement.scoring`,
next to the planner/autoscaler control plane that builds on it
(docs/planner.md). Import from ``repro_torch.core.placement``; this module
stays so existing imports keep working.
"""
from repro_torch.core.placement.scoring import (  # noqa: F401
    DISPATCH_POLICIES, TIER_SCORE, TIERS, NodeSnapshot, choose_node,
    locality_score,
)
from repro_torch.core.slowness import (  # noqa: F401
    EwmaDetector, HedgeConfig, QuarantineConfig, SlownessDetector,
)

__all__ = ["DISPATCH_POLICIES", "TIERS", "TIER_SCORE", "NodeSnapshot",
           "choose_node", "locality_score", "EwmaDetector", "HedgeConfig",
           "QuarantineConfig", "SlownessDetector"]
