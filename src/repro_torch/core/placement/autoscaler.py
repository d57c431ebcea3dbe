"""Predictive autoscaler: EWMA arrival forecast → node count (docs/planner.md).

HAS-GPU-style (PAPERS.md) hybrid scaling, reduced to the piece this
control plane needs: a per-function EWMA of observed arrival rates feeds
a cluster-wide capacity target, and hysteresis (consecutive-tick streaks
in each direction) keeps the pool from thrashing on diurnal noise. The
autoscaler only *decides*; the drivers own the mechanics of adding and
draining nodes (`ClusterRuntime.add_node`/`drain_node` and the simulator
twins), so the decision code is shared byte-for-byte.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class AutoscaleConfig:
    """The ``autoscale=`` knob (Gateway/Simulator/ClusterRuntime/
    FunctionSpec). Frozen so spec adopt-or-refuse can compare by value."""

    min_nodes: int = 1
    max_nodes: int = 8
    node_rate_per_s: float = 8.0  # forecast arrivals/s one node absorbs
    tick_s: float = 1.0           # control-loop cadence (driver clock)
    ewma_alpha: float = 0.3       # forecast smoothing per tick
    headroom: float = 1.2         # capacity margin above the forecast
    up_ticks: int = 1             # streak before scaling up
    down_ticks: int = 3           # streak before draining (hysteresis)

    def __post_init__(self):
        if self.min_nodes < 1 or self.max_nodes < self.min_nodes:
            raise ValueError(
                f"autoscale bounds invalid: min={self.min_nodes} "
                f"max={self.max_nodes}")
        if self.node_rate_per_s <= 0 or self.tick_s <= 0:
            raise ValueError("node_rate_per_s and tick_s must be positive")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")


class RateForecast:
    """Per-function EWMA over per-tick arrival counts."""

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.rates: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def note_arrival(self, fn_name: str) -> None:
        self._counts[fn_name] = self._counts.get(fn_name, 0) + 1

    def tick(self, dt_s: float) -> Dict[str, float]:
        """Fold the counts since the last tick into the EWMA; returns the
        updated per-function rates (arrivals/s)."""
        if dt_s <= 0:
            return self.rates
        a = self.alpha
        for name in set(self.rates) | set(self._counts):
            inst = self._counts.get(name, 0) / dt_s
            prev = self.rates.get(name)
            self.rates[name] = inst if prev is None else a * inst + (1 - a) * prev
        self._counts.clear()
        return self.rates

    def total(self) -> float:
        return math.fsum(self.rates.values())


class Autoscaler:
    """Hysteresis loop over the forecast: target = ceil(total_rate ×
    headroom / node_rate_per_s) clamped to [min_nodes, max_nodes]; the
    pool only moves after ``up_ticks``/``down_ticks`` consecutive ticks
    agree on the direction, and drains go one node per tick (gentle —
    each drain must finish its teardown before the next)."""

    def __init__(self, cfg: AutoscaleConfig):
        self.cfg = cfg
        self._up_streak = 0
        self._down_streak = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_target = cfg.min_nodes

    def decide(self, total_rate: float,
               active_nodes: int) -> Tuple[int, List[str]]:
        """``(nodes_to_add, ['drain'])`` for this tick. ``active_nodes``
        counts placement-active nodes (provisioned and not draining)."""
        cfg = self.cfg
        target = max(cfg.min_nodes, min(cfg.max_nodes, math.ceil(
            total_rate * cfg.headroom / cfg.node_rate_per_s)))
        self.last_target = target
        if target > active_nodes:
            self._down_streak = 0
            self._up_streak += 1
            if self._up_streak >= cfg.up_ticks:
                self._up_streak = 0
                self.scale_ups += 1
                return target - active_nodes, []
            return 0, []
        self._up_streak = 0
        if target < active_nodes and active_nodes > cfg.min_nodes:
            self._down_streak += 1
            if self._down_streak >= cfg.down_ticks:
                self._down_streak = 0
                self.scale_downs += 1
                return 0, ["drain"]
            return 0, []
        self._down_streak = 0
        return 0, []


def resolve_autoscale(autoscale) -> Optional[AutoscaleConfig]:
    """Normalize the knob: None (off), an AutoscaleConfig, or a mapping of
    AutoscaleConfig fields (the ergonomic literal form)."""
    if autoscale is None or isinstance(autoscale, AutoscaleConfig):
        return autoscale
    if isinstance(autoscale, dict):
        return AutoscaleConfig(**autoscale)
    raise ValueError(
        f"autoscale must be None, an AutoscaleConfig, or a dict of its "
        f"fields; got {type(autoscale).__name__}")
