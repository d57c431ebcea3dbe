"""Sharing-aware dispatch scoring (docs/cluster.md, docs/planner.md).

SAGE's throughput win is read-only/context sharing *within* a node
(paper §5); random cluster dispatch throws most of it away — invocations
of one function scatter across nodes and every node redoes the db→host→
device data preparation. The dispatch policies here route an invocation
to the node where its function is already resident, falling back to the
least-pressured cold node when the hot node is saturated
(**spill-and-warm**: hot nodes absorb repeat traffic until pressure pushes
overflow to a cold node, which then warms up — residency is a preference,
never a pin).

Both cluster drivers consume this module: `ClusterRuntime.select_node`
builds one :class:`NodeSnapshot` per `SageRuntime` (from
`MemoryDaemon.residency()`/`pressure()`) and the `Simulator` twin builds
the same snapshot per `GPUNode`, so the scoring below is shared verbatim
and the runtime/sim parity test can compare per-node assignments 1:1.

``"planned"`` routes through the :class:`~repro_torch.core.placement.planner
.PlacementPlanner` residency map instead of per-request scoring; it is
listed here so every knob-validation site accepts it, but
:func:`choose_node` itself only scores the per-request policies — the
planner calls back into it for its spill path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

DISPATCH_POLICIES = ("random", "locality", "least_loaded", "planned")

# residency tiers a snapshot can report for a function's read-only data.
# "loading" means an in-flight shareable load: an arrival routed there
# attaches to the stream already running (a shared hit), which is worth as
# much as device residency — it skips the db and host legs entirely.
TIERS = ("none", "host", "loading", "device")
TIER_SCORE = {"none": 0.0, "host": 1.0, "loading": 2.0, "device": 2.0}


@dataclass(frozen=True)
class NodeSnapshot:
    """One node's residency + pressure at dispatch time.

    Produced under the owning daemon's lock (O(per-function), never
    blocking on in-flight loads — docs/cluster.md has the contract);
    consumed by :func:`choose_node` and the placement planner.
    """

    node_id: str
    ro_tier: str            # best tier of the function's read-only data
    ro_bytes: int           # resident read-only bytes for the function
    device_free: int        # capacity - device_used
    device_capacity: int
    pending_admissions: int  # parked device-memory waiters
    loader_queue: int        # queued + in-flight loads on the loader pool
    loader_threads: int
    healthy: bool = True     # False once fault injection crashed the node
    # graded health from the SlownessDetector (docs/resilience.md, "Gray
    # failures"): 1.0 = no drift evidence, < 1.0 = the node's worst stage
    # EWMA runs hotter than the fleet median by that ratio. Stays 1.0
    # when slowness detection is off, so default scoring is bit-identical
    # to the binary-health seed.
    health_score: float = 1.0
    # idle fraction of the node's SM budget (docs/compute.md): < 1.0 only
    # when a shared compute plane is attached and busy. Stays 1.0 under
    # compute="exclusive", so default scoring is bit-identical to the seed.
    compute_free_frac: float = 1.0

    @property
    def queue_pressure(self) -> float:
        """Outstanding data-plane work per loader worker."""
        return (self.loader_queue + self.pending_admissions) / max(
            1, self.loader_threads)

    @property
    def mem_pressure(self) -> float:
        """Device-memory fullness in [0, 1]."""
        return 1.0 - self.device_free / max(1, self.device_capacity)


def locality_score(snap: NodeSnapshot) -> float:
    """Higher is better. Residency tier dominates (device/loading = 2,
    host = 1, cold = 0) so repeat traffic sticks to its warm node; the
    pressure terms make a saturated hot node lose to an idle cold one
    (~4 queued loads per worker, or a full device, erase a device-tier
    advantage) — that crossover point is the spill in spill-and-warm.
    A degraded ``health_score`` (slowness detection on) penalizes the
    node continuously: a 2x-slow node (score 0.5) loses a full residency
    tier, a suspect loses more — with the default score of 1.0 the term
    is exactly 0.0, so seed scoring is unchanged. The compute term
    (docs/compute.md) packs density-aware: a node whose SM budget is
    fully busy loses one residency tier, so small-function traffic
    spreads once a hot node's slices saturate — at the default
    ``compute_free_frac`` of 1.0 the term is exactly 0.0."""
    return (TIER_SCORE[snap.ro_tier]
            - 0.5 * snap.queue_pressure
            - snap.mem_pressure
            - 2.0 * (1.0 - snap.health_score)
            - 1.0 * (1.0 - snap.compute_free_frac))


def choose_node(policy: str, snapshots: List[NodeSnapshot]) -> int:
    """Index of the node ``policy`` dispatches to.

    Ties break EDF-compatibly: of equally-scored nodes, the one with the
    fewest parked admission waiters wins (the request joins the shortest
    EDF waiter heap, so a tight deadline queues behind the least work),
    then the shortest loader queue, then the lowest index (deterministic).
    """
    if policy == "least_loaded":
        return min(
            range(len(snapshots)),
            key=lambda i: (snapshots[i].queue_pressure,
                           snapshots[i].mem_pressure,
                           snapshots[i].pending_admissions, i),
        )
    if policy == "locality":
        return min(
            range(len(snapshots)),
            key=lambda i: (-locality_score(snapshots[i]),
                           snapshots[i].pending_admissions,
                           snapshots[i].loader_queue, i),
        )
    raise ValueError(
        f"unknown dispatch policy {policy!r}; use one of {DISPATCH_POLICIES}")
