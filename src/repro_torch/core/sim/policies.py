"""Policy layer: scheduler / dispatch knobs as plugin strategy objects.

The *scoring and key code itself* is shared byte-for-byte with the threaded
daemon — admission keys use the same ``(-priority, deadline, seq)`` formula
as ``daemon._admission_key`` and cluster dispatch calls the same
:func:`repro_torch.core.dispatch.choose_node` the cluster runtime uses. These
objects only bind that shared code to the simulator's call sites, so a new
policy is one registry entry, not a simulator edit.

(The transfer knob is already a plugin: :class:`repro_torch.core.transfer
.LinkArbiter` carries the ``run_to_completion``/``preemptive`` modes.)
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.core.daemon import SCHEDULERS, AdmissionKey
from repro_torch.core.placement import DISPATCH_POLICIES, choose_node
from repro_torch.core.telemetry import InvocationRecord

__all__ = [
    "AdmissionPolicy", "FifoAdmission", "EdfAdmission", "admission_policy",
    "DispatchStrategy", "RandomDispatch", "SnapshotDispatch",
    "PlannedDispatch", "dispatch_strategy",
]


# ---------------------------------------------------------------------------
# admission (loader/memory ordering) — twin of daemon._admission_key
# ---------------------------------------------------------------------------
class AdmissionPolicy:
    """Orders a node's loader gate and memory-admission heap."""

    name = "?"

    def key(self, node, rec: Optional[InvocationRecord] = None) -> AdmissionKey:
        raise NotImplementedError


class FifoAdmission(AdmissionPolicy):
    """Pure arrival order (the node's monotonic key sequence)."""

    name = "fifo"

    def key(self, node, rec: Optional[InvocationRecord] = None) -> AdmissionKey:
        return (0, 0.0, next(node._key_seq))


class EdfAdmission(AdmissionPolicy):
    """Priority class first, then earliest absolute deadline (requests
    without a deadline sort last within their class)."""

    name = "edf"

    def key(self, node, rec: Optional[InvocationRecord] = None) -> AdmissionKey:
        seq = next(node._key_seq)
        if rec is not None:
            dl = (math.inf if rec.deadline_s is None
                  else rec.arrival_t + rec.deadline_s)
            return (-rec.priority, dl, seq)
        return (0, 0.0, seq)


_ADMISSION = {p.name: p for p in (FifoAdmission(), EdfAdmission())}
assert set(_ADMISSION) == set(SCHEDULERS)


def admission_policy(name: str) -> AdmissionPolicy:
    try:
        return _ADMISSION[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; use one of {SCHEDULERS}") from None


# ---------------------------------------------------------------------------
# cluster dispatch — twin of ClusterRuntime's node choice
# ---------------------------------------------------------------------------
class DispatchStrategy:
    """Picks the node an arrival runs on. ``pick`` returns ``(node, tier)``
    where ``tier`` is the function's residency tier on the chosen node AT
    DISPATCH time (recorded as ``InvocationRecord.dispatch_tier``)."""

    name = "?"

    def pick(self, sim, fn_name: str) -> Tuple[object, Optional[str]]:
        raise NotImplementedError


class RandomDispatch(DispatchStrategy):
    """Uniform choice from the simulator's root RNG — the same seeded
    ``rng.choice`` stream as the pre-dispatch simulator, so seeded §7.8
    replays are unchanged."""

    name = "random"

    def pick(self, sim, fn_name: str):
        # dispatchable_nodes() IS sim.nodes unless eviction is draining a
        # dead node, so the seeded choice stream is normally untouched
        node = sim._rng.choice(sim.dispatchable_nodes())
        return node, node.residency(fn_name)[0]


class SnapshotDispatch(DispatchStrategy):
    """Snapshot-scoring dispatch (``locality`` / ``least_loaded``): builds
    one :class:`~repro_torch.core.dispatch.NodeSnapshot` per node and defers to
    the SAME :func:`~repro_torch.core.dispatch.choose_node` the cluster runtime
    calls — byte-for-byte shared scoring."""

    def __init__(self, name: str):
        self.name = name

    def pick(self, sim, fn_name: str):
        nodes = sim.dispatchable_nodes()
        snaps = [sim.node_snapshot(n, fn_name) for n in nodes]
        idx = choose_node(self.name, snaps)
        return nodes[idx], snaps[idx].ro_tier


class PlannedDispatch(DispatchStrategy):
    """Planner-backed dispatch (docs/planner.md): routes to the
    function's planned home via the simulator's
    :class:`~repro_torch.core.placement.control.PlacementControl` — the SAME
    ``PlacementPlanner.pick`` the cluster runtime calls. This strategy
    object serves the re-dispatch path (crash recovery); fresh arrivals
    go through ``Simulator._planned_arrive``, which adds the
    work-stealing board on top of the same pick."""

    name = "planned"

    def pick(self, sim, fn_name: str):
        nodes = sim.dispatchable_nodes()
        snaps = [sim.node_snapshot(n, fn_name) for n in nodes]
        idx, _hit = sim._control.planner.pick(fn_name, snaps)
        return nodes[idx], snaps[idx].ro_tier


_DISPATCH = {"random": RandomDispatch(), "planned": PlannedDispatch()}
_DISPATCH.update({name: SnapshotDispatch(name) for name in DISPATCH_POLICIES
                  if name not in _DISPATCH})


def dispatch_strategy(name: str) -> DispatchStrategy:
    try:
        return _DISPATCH[name]
    except KeyError:
        raise ValueError(
            f"unknown dispatch {name!r}; use one of {DISPATCH_POLICIES}"
        ) from None
