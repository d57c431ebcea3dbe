"""Gray-failure tolerance primitives (docs/resilience.md, "Gray failures").

The crash-resilience layer is binary — a node is crashed or healthy — but the
sharing-aware dispatch concentrates a function's traffic on the node where
its read-only data is resident, so one slow-but-alive node (degraded PCIe,
jittery loader, leaking memory) silently drags the tail of every function
homed there. This module is the shared tail-tolerance layer both drivers
consume byte-for-byte:

* :class:`EwmaDetector` — the single EWMA slowness primitive (the training
  loop's ``StragglerWatchdog`` is a thin wrapper over it);
* :class:`SlownessDetector` — per-node per-stage EWMA + P² p95 profiles,
  scoring nodes *suspect* when a stage drifts past ``factor x`` the fleet
  median for ``min_samples`` consecutive observations, and grading
  ``NodeSnapshot.health_score`` for dispatch;
* :class:`HedgeConfig` / :class:`QuarantineConfig` — the knob surfaces
  (``hedging=`` / ``quarantine=`` accept a config, a kwargs dict, or
  ``True``), normalized via :func:`resolve_hedging` /
  :func:`resolve_quarantine`;
* :class:`QuarantineController` — the drain -> cooldown -> canary-probation
  -> readmit-or-retire state machine (breaker-style half-open probing,
  applied to nodes instead of functions).

Everything here is passive bookkeeping: the drivers own time, scheduling,
and the drain/readmit mechanics, so virtual-time and wall-time replays run
the identical decision logic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.sim.metrics import P2Quantile

__all__ = [
    "EwmaDetector",
    "SlownessDetector",
    "HedgeConfig",
    "QuarantineConfig",
    "HedgedError",
    "resolve_hedging",
    "resolve_quarantine",
    "QuarantineController",
    "HEDGE_STAT_KEYS",
]

# resilience_stats() keys this layer contributes on BOTH drivers
# (tests/test_faults.py::test_resilience_stats_backend_key_parity)
HEDGE_STAT_KEYS = ("hedges_launched", "hedges_won", "hedges_wasted",
                   "quarantines", "readmits")


class HedgedError(RuntimeError):
    """A hedge loser: the invocation was superseded by its faster twin.

    Never surfaces from ``Invocation.wait()`` — the winning twin's result
    is the request's outcome; the loser's record is marked ``dropped`` with
    ``error_class == "hedged"``.
    """


class EwmaDetector:
    """One EWMA stream with a multiplicative straggler threshold.

    ``observe(value)`` returns True when ``value > factor * ewma`` (the
    ewma *before* this observation — a straggler must not drag the
    baseline it is judged against). This is the shared primitive behind
    both the serving-side :class:`SlownessDetector` streams and the
    training loop's ``StragglerWatchdog``.
    """

    __slots__ = ("factor", "alpha", "ewma", "count")

    def __init__(self, factor: float = 2.5, alpha: float = 0.2):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.factor = factor
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.count = 0

    def observe(self, value: float) -> bool:
        """Feed one observation; True if it is a straggler vs the EWMA."""
        self.count += 1
        flagged = self.ewma is not None and value > self.factor * self.ewma
        if self.ewma is None:
            self.ewma = value
        else:
            self.ewma = self.alpha * value + (1.0 - self.alpha) * self.ewma
        return flagged


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class _Stage:
    __slots__ = ("ewma", "count", "p95")

    def __init__(self, quantile: float):
        self.ewma: Optional[float] = None
        self.count = 0
        self.p95 = P2Quantile(quantile)


class _DurationWindow:
    """Exact quantile over the last ``window`` samples.

    The hedge estimate cannot use a streaming P² sketch: the first samples
    a function ever sees are its cold loads, and P² markers seeded seconds
    high stay high for hundreds of warm samples (the parabolic update
    moves marker *positions* one step per sample, not marker heights), so
    the hedge timer would never fire. A bounded ring forgets the cold
    start once warm traffic displaces it.
    """

    __slots__ = ("window", "count", "_buf", "_idx")

    def __init__(self, window: int = 128):
        self.window = window
        self.count = 0
        self._buf: List[float] = []
        self._idx = 0

    def add(self, value: float) -> None:
        self.count += 1
        if len(self._buf) < self.window:
            self._buf.append(value)
        else:
            self._buf[self._idx] = value
            self._idx = (self._idx + 1) % self.window

    def quantile(self, q: float) -> float:
        s = sorted(self._buf)
        return s[min(int(q * len(s)), len(s) - 1)]


class SlownessDetector:
    """Per-node per-stage latency profiles + fleet-relative suspicion.

    Rides the existing telemetry flow: each finalized record feeds
    ``observe(node, stage, value)`` per stage (both drivers call
    :meth:`observe_record`). A node is **suspect** when some stage's EWMA
    exceeds ``factor x`` the fleet median of that stage's per-node EWMAs
    for ``min_samples`` consecutive observations (both the node's stream
    and at least one peer must have ``min_samples`` observations first —
    a one-node fleet has no median to drift from).

    ``health_score(node)`` grades the same signal continuously in
    ``(0, 1]`` for dispatch scoring: 1.0 with no evidence of drift,
    ``median / ewma`` (clamped to 1.0) once the node's worst stage runs
    hotter than the fleet.
    """

    # stages fed from records; "load" is cpu_data + gpu_data (+ gpu_ctx)
    STAGES = ("load", "compute")

    def __init__(self, factor: float = 2.5, alpha: float = 0.2,
                 min_samples: int = 8, quantile: float = 0.95):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        self.factor = factor
        self.alpha = alpha
        self.min_samples = min_samples
        self.quantile = quantile
        self._stages: Dict[Tuple[str, str], _Stage] = {}
        self._streak: Dict[Tuple[str, str], int] = {}
        # per-function total-duration window (hedge launch estimates)
        self._durations: Dict[str, _DurationWindow] = {}
        self.observations = 0

    # -- feeding -------------------------------------------------------
    def _stage(self, node_id: str, stage: str) -> _Stage:
        st = self._stages.get((node_id, stage))
        if st is None:
            st = self._stages[(node_id, stage)] = _Stage(self.quantile)
        return st

    def _peer_median(self, node_id: str, stage: str) -> Optional[float]:
        """Fleet median of the stage EWMA over *mature* streams (>=
        min_samples), excluding ``node_id`` so a slow node cannot drag its
        own baseline. None until at least one mature peer exists."""
        peers = [s.ewma for (n, sg), s in self._stages.items()
                 if sg == stage and n != node_id
                 and s.count >= self.min_samples and s.ewma is not None]
        if not peers:
            return None
        return _median(peers)

    def observe(self, node_id: str, stage: str, value: float) -> bool:
        """Feed one stage observation; True if it breaches the fleet
        threshold (the breach streak, not one flag, makes a suspect)."""
        self.observations += 1
        st = self._stage(node_id, stage)
        st.count += 1
        st.p95.add(value)
        if st.ewma is None:
            st.ewma = value
        else:
            st.ewma = self.alpha * value + (1.0 - self.alpha) * st.ewma
        med = self._peer_median(node_id, stage)
        key = (node_id, stage)
        if (med is not None and med > 0.0
                and st.count >= self.min_samples
                and st.ewma > self.factor * med):
            self._streak[key] = self._streak.get(key, 0) + 1
            return True
        self._streak[key] = 0
        return False

    def observe_record(self, node_id: str, function: str,
                       stages: Dict[str, float], duration: float) -> None:
        """Feed one finalized successful record (both drivers' call site).

        The per-function duration sketch describes what a *healthy* node
        delivers, so a currently-suspect node's samples are excluded —
        otherwise a slow node's stragglers drag the hedge quantile up
        until the timer always fires just after the straggler finishes
        and no hedge ever launches."""
        self.observe(node_id, "compute", stages.get("compute", 0.0))
        load = (stages.get("cpu_data", 0.0) + stages.get("gpu_data", 0.0)
                + stages.get("gpu_ctx", 0.0))
        if load > 0.0:
            self.observe(node_id, "load", load)
        if self.is_suspect(node_id):
            return
        d = self._durations.get(function)
        if d is None:
            d = self._durations[function] = _DurationWindow()
        d.add(duration)

    def is_slow_sample(self, node_id: str, stage: str, value: float) -> bool:
        """One-shot straggler check for a canary: is this raw sample past
        ``factor x`` the fleet median? (No streak — a probation node has a
        freshly reset stream and cannot wait ``min_samples``.)"""
        med = self._peer_median(node_id, stage)
        return med is not None and med > 0.0 and value > self.factor * med

    def reset_node(self, node_id: str) -> None:
        """Forget a node's streams (quarantine wipes the evidence — a
        readmitted node is judged on post-readmission behavior only)."""
        for key in [k for k in self._stages if k[0] == node_id]:
            del self._stages[key]
        for key in [k for k in self._streak if k[0] == node_id]:
            del self._streak[key]

    # -- verdicts ------------------------------------------------------
    def is_suspect(self, node_id: str) -> bool:
        """Sustained drift: some stage breached for >= min_samples
        consecutive observations."""
        return any(n == node_id and streak >= self.min_samples
                   for (n, _sg), streak in self._streak.items())

    def suspects(self) -> List[str]:
        return sorted({n for (n, _sg), streak in self._streak.items()
                       if streak >= self.min_samples})

    def health_score(self, node_id: str) -> float:
        """Graded health in (0, 1]; 1.0 absent evidence of drift."""
        score = 1.0
        for stage in self.STAGES:
            st = self._stages.get((node_id, stage))
            if st is None or st.ewma is None or st.ewma <= 0.0 \
                    or st.count < self.min_samples:
                continue
            med = self._peer_median(node_id, stage)
            if med is None or med <= 0.0:
                continue
            score = min(score, med / st.ewma)
        return score

    def estimate(self, function: str,
                 min_samples: Optional[int] = None) -> Optional[float]:
        """Hedge-launch latency estimate: the function's duration quantile
        once enough observations back it (``HedgeConfig.min_samples`` at
        the hedging call sites); None before that."""
        need = self.min_samples if min_samples is None else min_samples
        d = self._durations.get(function)
        if d is None or d.count < need:
            return None
        return d.quantile(self.quantile)


# ---------------------------------------------------------------------------
# knob surfaces
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HedgeConfig:
    """Deadline-aware hedged redispatch (docs/resilience.md).

    An invocation still unfinished ``hedge_quantile`` into its learned
    latency distribution launches ONE speculative duplicate on the best
    non-suspect node; first completion wins, the loser is cancelled
    byte-exactly and its record marked ``dropped``/``hedged``. The
    duplicate is charged to the request's ``max_retries`` budget.
    """

    hedge_quantile: float = 0.95  # launch when p_q estimate elapses
    min_samples: int = 10         # per-function observations before hedging
    delay_factor: float = 1.0     # multiplier on the estimate

    def __post_init__(self):
        if not 0.0 < self.hedge_quantile < 1.0:
            raise ValueError(
                f"hedge_quantile must be in (0, 1), got {self.hedge_quantile}")
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}")
        if self.delay_factor <= 0.0:
            raise ValueError(
                f"delay_factor must be > 0, got {self.delay_factor}")


@dataclass(frozen=True)
class QuarantineConfig:
    """Suspect-node quarantine (docs/resilience.md).

    Detector thresholds (``factor``/``min_samples``/``alpha``) define a
    sustained suspect; a suspect is drained (the graceful ``drain_node`` path),
    held out for ``cooldown_s``, then readmitted **cold in probation**:
    its first ``canary_count`` completions are judged one-shot against the
    fleet median — any slow canary retires the node, all-clean readmits
    it fully (breaker-style half-open, per node).
    """

    factor: float = 2.5      # stage EWMA vs fleet-median threshold
    alpha: float = 0.2       # EWMA smoothing
    min_samples: int = 8     # consecutive breaches to declare a suspect
    cooldown_s: float = 5.0  # drain -> probe wait (workload seconds)
    canary_count: int = 3    # probation completions that must come back clean

    def __post_init__(self):
        if self.factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {self.factor}")
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}")
        if self.cooldown_s <= 0.0:
            raise ValueError(
                f"cooldown_s must be > 0, got {self.cooldown_s}")
        if self.canary_count < 1:
            raise ValueError(
                f"canary_count must be >= 1, got {self.canary_count}")


def resolve_hedging(value) -> Optional[HedgeConfig]:
    """Normalize ``hedging=True|dict|HedgeConfig|None`` to a config."""
    if value is None or value is False:
        return None
    if value is True:
        return HedgeConfig()
    if isinstance(value, HedgeConfig):
        return value
    if isinstance(value, dict):
        return HedgeConfig(**value)
    raise TypeError(
        f"hedging must be True, a dict, or a HedgeConfig, "
        f"got {type(value).__name__}")


def resolve_quarantine(value) -> Optional[QuarantineConfig]:
    """Normalize ``quarantine=True|dict|QuarantineConfig|None``."""
    if value is None or value is False:
        return None
    if value is True:
        return QuarantineConfig()
    if isinstance(value, QuarantineConfig):
        return value
    if isinstance(value, dict):
        return QuarantineConfig(**value)
    raise TypeError(
        f"quarantine must be True, a dict, or a QuarantineConfig, "
        f"got {type(value).__name__}")


def make_detector(hedging: Optional[HedgeConfig],
                  quarantine: Optional[QuarantineConfig]) -> SlownessDetector:
    """One shared detector per driver, parameterized by whichever knob is
    on (quarantine owns the suspicion thresholds, hedging the estimate
    quantile)."""
    q = quarantine or QuarantineConfig()
    quantile = hedging.hedge_quantile if hedging is not None else 0.95
    return SlownessDetector(factor=q.factor, alpha=q.alpha,
                            min_samples=q.min_samples, quantile=quantile)


class QuarantineController:
    """Per-node drain -> cooldown -> probation -> readmit/retire machine.

    Passive: the driver feeds completions (:meth:`note_completion`) and
    asks for due probes (:meth:`due_probes`); the returned actions
    ("quarantine" / "probe" / "readmit" / "retire") are executed by the
    driver through its own drain/restore machinery, so virtual-time and
    wall-time replays share the decision logic exactly.
    """

    ACTIVE, QUARANTINED, PROBATION, RETIRED = (
        "active", "quarantined", "probation", "retired")

    def __init__(self, cfg: QuarantineConfig, detector: SlownessDetector):
        self.cfg = cfg
        self.detector = detector
        self.quarantines = 0
        self.readmits = 0
        self._state: Dict[str, str] = {}
        self._probe_at: Dict[str, float] = {}
        self._canaries: Dict[str, int] = {}

    def state(self, node_id: str) -> str:
        return self._state.get(node_id, self.ACTIVE)

    def note_completion(self, node_id: str, now: float,
                        compute_s: float) -> Optional[str]:
        """Feed one successful completion *after* the detector was fed.
        Returns the action the driver must take: ``"quarantine"`` (drain
        the node now), ``"readmit"`` (probation passed — fully readmit),
        ``"retire"`` (a canary came back slow — retire for good), or None.
        """
        st = self.state(node_id)
        if st == self.ACTIVE:
            if self.detector.is_suspect(node_id):
                self._state[node_id] = self.QUARANTINED
                self._probe_at[node_id] = now + self.cfg.cooldown_s
                self.quarantines += 1
                # wipe the evidence: probation judges post-readmit behavior
                self.detector.reset_node(node_id)
                return "quarantine"
            return None
        if st == self.PROBATION:
            if self.detector.is_slow_sample(node_id, "compute", compute_s):
                self._state[node_id] = self.RETIRED
                return "retire"
            left = self._canaries.get(node_id, self.cfg.canary_count) - 1
            if left <= 0:
                self._state[node_id] = self.ACTIVE
                self._canaries.pop(node_id, None)
                self.readmits += 1
                return "readmit"
            self._canaries[node_id] = left
            return None
        return None

    def due_probes(self, now: float) -> List[str]:
        """Quarantined nodes whose cooldown elapsed: the driver readmits
        each cold and the node enters probation (canary half-open)."""
        due = [n for n, t in self._probe_at.items()
               if now >= t and self.state(n) == self.QUARANTINED]
        for n in due:
            self._state[n] = self.PROBATION
            self._canaries[n] = self.cfg.canary_count
            del self._probe_at[n]
        return due

    def next_probe_at(self) -> Optional[float]:
        """Earliest pending cooldown expiry (drivers schedule a timer)."""
        pending = [t for n, t in self._probe_at.items()
                   if self.state(n) == self.QUARANTINED]
        return min(pending) if pending else None

    def stats(self) -> Dict[str, int]:
        return {"quarantines": self.quarantines, "readmits": self.readmits}
