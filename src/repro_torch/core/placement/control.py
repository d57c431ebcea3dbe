"""PlacementControl: the control-plane facade both drivers drive.

One object owns the three cooperating components of docs/planner.md —
the :class:`~repro_torch.core.placement.planner.PlacementPlanner` residency
map, the work-stealing decisions (board/reroute below), and the
:class:`~repro_torch.core.placement.autoscaler.Autoscaler` over the dynamic
node pool — plus the node-count timeline that prices the pool in
node-seconds. Every method is a pure decision over
:class:`~repro_torch.core.placement.scoring.NodeSnapshot` lists and driver
timestamps, so `ClusterRuntime` and the `Simulator` share it
byte-for-byte; the drivers only *apply* the decisions (start an
invocation, park it, add a node, drain one).

Work stealing rides this split: `route()` boards an arrival whose
planned home is above the ``steal_watermark`` (queued-but-unstarted — no
bytes reserved, no machine started), and `reroute()` re-picks it after
``board_delay_s`` with fresh snapshots. Landing on a different node than
the original home is a *steal* and charges the request's
``max_retries``/``redispatches`` budget, exactly like a crash
re-dispatch (docs/resilience.md).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.placement.autoscaler import (
    AutoscaleConfig, Autoscaler, RateForecast, resolve_autoscale,
)
from repro_torch.core.placement.planner import PlacementPlanner, PlannerConfig
from repro_torch.core.placement.scoring import NodeSnapshot

DEFAULT_TICK_S = 1.0  # forecast cadence when autoscaling is off


class PlacementControl:
    def __init__(self, node_ids: Sequence[str], *,
                 autoscale: Optional[AutoscaleConfig] = None,
                 planner_cfg: Optional[PlannerConfig] = None,
                 now: float = 0.0):
        self.autoscale = resolve_autoscale(autoscale)
        self.planner = PlacementPlanner(planner_cfg)
        alpha = self.autoscale.ewma_alpha if self.autoscale else 0.3
        self.forecast = RateForecast(alpha)
        self.scaler = Autoscaler(self.autoscale) if self.autoscale else None
        self.tick_s = self.autoscale.tick_s if self.autoscale else DEFAULT_TICK_S
        # pool state: provisioned ⊇ active; draining nodes stay provisioned
        # (they still hold slots/bytes) but leave the placement-active set
        self._provisioned: List[str] = list(node_ids)
        self._draining: set = set()
        self._last_tick: Optional[float] = None
        # node-seconds integral + (t, provisioned_count) timeline
        self._timeline: List[Tuple[float, int]] = [(now, len(self._provisioned))]
        self._ns_accum = 0.0
        self._ns_t = now
        # work-stealer telemetry
        self.boards = 0
        self.steals = 0
        self.planner.set_nodes(self.active_nodes())

    def set_autoscale(self, autoscale) -> None:
        """Attach (or swap) the autoscaling policy mid-run — the spec
        adoption path. The forecast keeps its observed history; only the
        smoothing, tick cadence, and scaler change."""
        self.autoscale = resolve_autoscale(autoscale)
        if self.autoscale is None:
            self.scaler = None
            self.tick_s = DEFAULT_TICK_S
            return
        self.forecast.alpha = self.autoscale.ewma_alpha
        self.scaler = Autoscaler(self.autoscale)
        self.tick_s = self.autoscale.tick_s

    # ------------------------------------------------------------------
    # pool membership + node-seconds
    # ------------------------------------------------------------------
    def active_nodes(self) -> List[str]:
        return [nid for nid in self._provisioned if nid not in self._draining]

    def _mark(self, now: float) -> None:
        self._ns_accum += (now - self._ns_t) * len(self._provisioned)
        self._ns_t = now

    def node_provisioned(self, node_id: str, now: float) -> None:
        self._mark(now)
        if node_id not in self._provisioned:
            self._provisioned.append(node_id)
        self._draining.discard(node_id)
        self._timeline.append((now, len(self._provisioned)))
        self.planner.set_nodes(self.active_nodes())

    def node_draining(self, node_id: str) -> None:
        """The node stops taking placements immediately; it keeps costing
        node-seconds until the teardown retires it."""
        self._draining.add(node_id)
        self.planner.set_nodes(self.active_nodes())

    def node_retired(self, node_id: str, now: float) -> None:
        self._mark(now)
        if node_id in self._provisioned:
            self._provisioned.remove(node_id)
        self._draining.discard(node_id)
        self._timeline.append((now, len(self._provisioned)))
        self.planner.set_nodes(self.active_nodes())

    def node_seconds(self, now: float) -> float:
        return self._ns_accum + (now - self._ns_t) * len(self._provisioned)

    # ------------------------------------------------------------------
    # function lifecycle (planner churn signals)
    # ------------------------------------------------------------------
    def register_function(self, name: str, weight_bytes: int) -> None:
        self.planner.register_function(name, weight_bytes)

    def retire_function(self, name: str) -> None:
        self.planner.retire_function(name)

    # ------------------------------------------------------------------
    # routing + work stealing
    # ------------------------------------------------------------------
    def note_arrival(self, fn_name: str) -> None:
        self.forecast.note_arrival(fn_name)

    def route(self, fn_name: str, snapshots: List[NodeSnapshot],
              allow_board: bool = True):
        """``("start", idx, planned_hit)`` or ``("board", idx)`` — board
        means the planned target (and every alternative the pick
        considered) is above the steal watermark, so the arrival parks as
        queued-but-unstarted work for the stealer to re-route."""
        idx, hit = self.planner.pick(fn_name, snapshots)
        if (allow_board and snapshots[idx].queue_pressure
                >= self.planner.cfg.steal_watermark):
            self.boards += 1
            return ("board", idx)
        return ("start", idx, hit)

    def reroute(self, fn_name: str, snapshots: List[NodeSnapshot],
                home_id: str) -> Tuple[int, bool]:
        """Re-pick a boarded arrival with fresh snapshots; a landing away
        from the original home is a steal."""
        idx, _hit = self.planner.pick(fn_name, snapshots)
        stole = snapshots[idx].node_id != home_id
        if stole:
            self.steals += 1
        return idx, stole

    # ------------------------------------------------------------------
    # the control tick (piggybacked on arrivals by both drivers)
    # ------------------------------------------------------------------
    def maybe_tick(self, now: float) -> Tuple[int, List[str]]:
        """Run the control loop if a tick elapsed: fold arrival counts
        into the EWMA forecast, push rates to the planner (repairing the
        plan when replica targets drift), and — when autoscaling is on —
        return ``(nodes_to_add, [node_ids_to_drain])`` for the driver to
        apply. Ticks ride arrivals, so an idle system schedules nothing
        and virtual-time runs still terminate."""
        if self._last_tick is None:
            self._last_tick = now
            return 0, []
        dt = now - self._last_tick
        if dt < self.tick_s:
            return 0, []
        self._last_tick = now
        rates = self.forecast.tick(dt)
        drift = False
        for name, rate in rates.items():
            self.planner.set_rate(name, rate)
            homes = self.planner.plan.get(name)
            if homes is not None and len(homes) != self.planner._replicas(
                    name, max(1, len(self.planner._node_ids))):
                drift = True
        if drift:
            self.planner.replan()
        if self.scaler is None:
            return 0, []
        add, drains = self.scaler.decide(self.forecast.total(),
                                         len(self.active_nodes()))
        drain_ids: List[str] = []
        for _ in drains:
            cand = self.planner.drain_candidate()
            if cand is not None:
                drain_ids.append(cand)
                self.node_draining(cand)
        return add, drain_ids

    # ------------------------------------------------------------------
    # observability (docs/planner.md)
    # ------------------------------------------------------------------
    def stats(self, now: float) -> Dict:
        return {
            "planned_hits": self.planner.planned_hits,
            "planned_misses": self.planner.planned_misses,
            "hit_rate": round(self.planner.hit_rate(), 4),
            "replans": self.planner.replans,
            "boards": self.boards,
            "steals": self.steals,
            "scale_ups": self.scaler.scale_ups if self.scaler else 0,
            "scale_downs": self.scaler.scale_downs if self.scaler else 0,
            "target_nodes": (self.scaler.last_target if self.scaler
                             else len(self.active_nodes())),
            "active_nodes": len(self.active_nodes()),
            "provisioned_nodes": len(self._provisioned),
            "node_seconds": round(self.node_seconds(now), 6),
            "node_timeline": list(self._timeline),
        }
