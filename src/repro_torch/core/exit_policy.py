"""Multi-stage resource exit (paper §6.3, Fig 9).

After an invocation completes, an instance's resources are released in
stages, each holding for a TTL (paper: 30 s per stage; each stage's interval
equals the previous one):

  stage 1: GPU context + read-only device data held   (warmest)
  stage 2: GPU context held; read-only data cached to host RAM
  stage 3: GPU context dropped; host data + CPU context held
  stage 4: host data dropped; container held
  stage 5: destroyed (cold)

Stages are evaluated *lazily* from (now - completion time), which makes the
ladder identical under the real clock and the virtual clock; side-effecting
transitions (freeing device memory, dropping the executable) are applied by
``advance`` exactly once per crossed boundary.

A warm hit at stage k skips every setup stage the paper's Table 4 shows
hidden at that stage; ``stage_skips`` maps stage -> skipped setup stages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_TTL = 30.0  # seconds per stage (paper §6.3)

# setup stages skipped on a warm hit at each ladder stage (Table 4 semantics)
stage_skips: Dict[int, Tuple[str, ...]] = {
    1: ("container_create", "cpu_ctx", "cpu_data", "gpu_ctx", "gpu_data"),
    2: ("container_create", "cpu_ctx", "cpu_data", "gpu_ctx"),  # re-PCIe gpu_data
    3: ("container_create", "cpu_ctx", "cpu_data"),  # re-create ctx, re-PCIe
    4: ("container_create", "cpu_ctx"),  # re-read db, re-create ctx
}


@dataclass
class ExitLadder:
    """Per function-instance ladder state."""

    ttls: Tuple[float, float, float, float] = (DEFAULT_TTL,) * 4
    completion_t: Optional[float] = None  # None while running / before first run
    applied_stage: int = 0  # last stage whose exit actions ran (0 = active)
    # actions[stage] runs when the ladder *leaves* the previous stage
    on_enter: Dict[int, Callable[[], None]] = field(default_factory=dict)
    # absolute time the NEXT stage boundary is crossed — ``advance`` is a
    # no-op before it. inf while running (stage pinned at 0) and once
    # destroyed. Cache safety: ``ttls`` is only reassigned at instance
    # creation, before the first ``on_complete``, so a cached boundary can
    # never be computed from superseded TTLs.
    _next_t: float = field(default=float("inf"), repr=False)

    def stage_at(self, now: float) -> int:
        """1..4 = warm ladder stage; 5 = destroyed; 0 = currently running."""
        if self.completion_t is None:
            return 0
        dt = now - self.completion_t
        acc = 0.0
        for i, ttl in enumerate(self.ttls, start=1):
            acc += ttl
            if dt < acc:
                return i
        return 5

    def advance(self, now: float) -> int:
        """Apply any exit actions for newly-entered stages; return stage.

        Fast path: nodes re-scan every idle ladder on each completion
        (``_advance_ladders``), so the overwhelmingly common call finds no
        boundary crossed — it returns the memoized stage without touching
        ``stage_at``. Time is monotone under both clocks, so the applied
        stage can only grow between calls.
        """
        if now < self._next_t:
            return self.applied_stage
        s = self.stage_at(now)
        if s == 0:
            return 0
        for k in range(max(self.applied_stage + 1, 2), s + 1):
            cb = self.on_enter.get(k)
            if cb:
                cb()
        self.applied_stage = max(self.applied_stage, s)
        if s >= 5:
            self._next_t = float("inf")
        else:
            self._next_t = self.completion_t + sum(self.ttls[:s])
        return s

    def on_complete(self, now: float) -> None:
        self.completion_t = now
        self.applied_stage = 1  # stage 1 holds everything: no action needed
        self._next_t = now + self.ttls[0]

    def on_reuse(self, now: float) -> int:
        """A new invocation arrived: stop the exit, report the stage it hit
        (after applying any pending transitions)."""
        s = self.advance(now)
        self.completion_t = None
        self.applied_stage = 0
        self._next_t = float("inf")
        return s
