"""PlacementPlanner: the function→node residency map (docs/planner.md).

``dispatch="locality"`` is per-request greedy: each arrival scores every
node and the residency map *emerges* from wherever traffic happened to
spill. Under function churn that map fragments — one function ends up
warm on many nodes (paying the cold load on each) while other nodes sit
idle. The planner inverts this: it *computes* the residency map up front
— greedy bin-packing of function working sets by ``bytes × arrival
rate`` onto the active nodes, deterministic tie-breaks — and dispatch
routes to the planned home, spilling through the shared
:func:`~repro_torch.core.placement.scoring.choose_node` scoring only when the
home set is saturated or gone.

The plan is repaired incrementally on churn signals: function
register/retire, node membership changes (autoscaler add/drain, health
eviction of a crashed node), and a sustained planned-miss rate over the
recent dispatch window. All decisions are pure functions of
:class:`~repro_torch.core.placement.scoring.NodeSnapshot` lists plus planner
state, so both drivers share this code byte-for-byte.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.placement.scoring import NodeSnapshot, choose_node


@dataclass(frozen=True)
class PlannerConfig:
    """Knobs for the residency map and its repair triggers."""

    rate_floor: float = 0.05      # arrivals/s assumed for a never-seen fn
    replica_rate: float = 8.0     # extra home per this many arrivals/s
    spill_pressure: float = 4.0   # home queue_pressure where the pick spills
    steal_watermark: float = 6.0  # queue_pressure that boards new arrivals
    board_delay_s: float = 0.05   # how long boarded work parks before re-route
    replan_miss_rate: float = 0.5  # sustained miss fraction forcing a replan
    miss_window: int = 64         # dispatches per miss-rate evaluation window


class PlacementPlanner:
    """Owns the plan (``function -> tuple(home node ids)``) and the churn
    counters that decide when to recompute it. Arrival-rate estimates are
    fed by the control loop's EWMA forecast (`set_rate`)."""

    def __init__(self, cfg: Optional[PlannerConfig] = None):
        self.cfg = cfg or PlannerConfig()
        self._weight_bytes: Dict[str, int] = {}
        self._rates: Dict[str, float] = {}
        self._node_ids: List[str] = []
        self.plan: Dict[str, Tuple[str, ...]] = {}
        # telemetry (docs/planner.md "Observability")
        self.planned_hits = 0
        self.planned_misses = 0
        self.replans = 0
        self._window: deque = deque(maxlen=self.cfg.miss_window)

    # ------------------------------------------------------------------
    # churn signals
    # ------------------------------------------------------------------
    def register_function(self, name: str, weight_bytes: int) -> None:
        """Function registered: give it a home immediately."""
        self._weight_bytes[name] = int(weight_bytes)
        self.replan()

    def retire_function(self, name: str) -> None:
        """Function retired: free its planned share."""
        self._weight_bytes.pop(name, None)
        self._rates.pop(name, None)
        self.replan()

    def set_nodes(self, node_ids: Sequence[str]) -> None:
        """Membership change (add/drain/evict): repair the plan onto the
        surviving placement-active nodes."""
        ids = list(node_ids)
        if ids != self._node_ids:
            self._node_ids = ids
            self.replan()

    def set_rate(self, name: str, rate_per_s: float) -> None:
        """Forecast update from the control loop's EWMA (no replan here —
        the tick decides when the drift is worth repairing)."""
        self._rates[name] = rate_per_s

    # ------------------------------------------------------------------
    # the plan
    # ------------------------------------------------------------------
    def _weight(self, name: str) -> float:
        """Bin-packing weight: working-set bytes × forecast arrival rate.
        The rate floor keeps a cold function mapped (it still needs a
        home for its first arrival)."""
        rate = max(self._rates.get(name, 0.0), self.cfg.rate_floor)
        return self._weight_bytes.get(name, 0) * rate

    def _replicas(self, name: str, n_nodes: int) -> int:
        """Hot functions get extra homes so one node's loader pool is not
        the throughput ceiling: one replica per ``replica_rate`` arrivals/s,
        capped at the active node count."""
        rate = self._rates.get(name, 0.0)
        return max(1, min(n_nodes, 1 + int(rate / self.cfg.replica_rate)))

    def replan(self) -> None:
        """Greedy bin-packing, heaviest function first. Deterministic:
        functions sort by (-weight, name); each replica lands on the
        least-loaded node, ties broken by node id. Incremental in spirit —
        the full recompute is O(F·N log N) over dicts the planner already
        holds, so 'repair' and 'recompute' coincide at this scale."""
        self.replans += 1
        self._window.clear()
        nodes = list(self._node_ids)
        if not nodes:
            self.plan = {}
            return
        load = {nid: 0.0 for nid in nodes}
        plan: Dict[str, Tuple[str, ...]] = {}
        for name in sorted(self._weight_bytes,
                           key=lambda n: (-self._weight(n), n)):
            k = self._replicas(name, len(nodes))
            homes = sorted(nodes, key=lambda nid: (load[nid], nid))[:k]
            share = self._weight(name) / k
            for nid in homes:
                load[nid] += share
            plan[name] = tuple(homes)
        self.plan = plan

    # ------------------------------------------------------------------
    # the pick (shared byte-for-byte by both drivers)
    # ------------------------------------------------------------------
    def pick(self, fn_name: str,
             snapshots: List[NodeSnapshot]) -> Tuple[int, bool]:
        """Index into ``snapshots`` for one arrival of ``fn_name`` plus
        whether the pick was a *planned hit* (landed on a home node).

        The least-pressured healthy home below ``spill_pressure`` wins
        (ties: home order, which the replan sorted by load). A saturated
        or missing home set spills through the shared locality scoring —
        a miss. Sustained misses (> ``replan_miss_rate`` over the last
        ``miss_window`` dispatches) mean the plan no longer matches the
        traffic, so the planner repairs it."""
        by_id = {s.node_id: i for i, s in enumerate(snapshots)}
        best: Optional[Tuple[float, int]] = None
        homes = self.plan.get(fn_name, ())
        for rank, nid in enumerate(homes):
            i = by_id.get(nid)
            if i is None or not snapshots[i].healthy:
                continue
            s = snapshots[i]
            if s.queue_pressure >= self.cfg.spill_pressure:
                continue
            if best is None or (s.queue_pressure, rank) < best:
                best = (s.queue_pressure, rank)
                best_idx = i
        if best is not None:
            self._note(hit=True)
            return best_idx, True
        idx = choose_node("locality", snapshots)
        self._note(hit=False)
        return idx, False

    def _note(self, hit: bool) -> None:
        if hit:
            self.planned_hits += 1
        else:
            self.planned_misses += 1
        self._window.append(hit)
        if (len(self._window) == self.cfg.miss_window
                and self._window.count(False)
                > self.cfg.replan_miss_rate * self.cfg.miss_window):
            self.replan()  # clears the window

    def hit_rate(self) -> float:
        total = self.planned_hits + self.planned_misses
        return self.planned_hits / total if total else 0.0

    def drain_candidate(self) -> Optional[str]:
        """The node the autoscaler should drain: the one carrying the
        least planned weight (deterministic tie-break by id)."""
        if not self._node_ids:
            return None
        load = {nid: 0.0 for nid in self._node_ids}
        for name, homes in self.plan.items():
            if not homes:
                continue
            share = self._weight(name) / len(homes)
            for nid in homes:
                if nid in load:
                    load[nid] += share
        return min(self._node_ids, key=lambda nid: (load[nid], nid))

    def total_rate(self) -> float:
        return math.fsum(self._rates.values())
