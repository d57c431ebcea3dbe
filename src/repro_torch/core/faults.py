"""Seeded fault-injection plane + resilience control primitives.

Shared by the threaded runtime (``repro_torch.core.runtime``) and the
discrete-event simulator (``repro_torch.core.simulator``): a :class:`FaultPlan`
is a *pure description* — typed, frozen specs plus a seed — and each
backend materialises it independently:

* the simulator turns :meth:`FaultPlan.events` into ``EventKind.FAULT``
  heap entries on the virtual clock;
* the runtime gateway arms wall-clock timers at ``t0 + at_s * pace``
  against the same event list.

Per-function loader faults are *drawn*, not scheduled: both backends call
:meth:`FaultPlan.make_draws` once and then draw exactly once per arrival
(before any breaker/shed gate, so the stream position is identical on
both drivers even when the control layer rejects the request). The draw
streams are named ``{seed}:loader:{fn}`` — independent of the §7.8 root
``RngStreams`` stream, so enabling faults never perturbs seeded arrival
or dispatch sequences.

The control side lives here too: :class:`CircuitBreaker`
(closed→open→half-open, docs/resilience.md has the state machine) and
:class:`SheddingConfig` (priority-aware watermark shedding). Both are
clock-agnostic — the sim passes its virtual ``clock.now``, the runtime
``time.monotonic`` — so one implementation serves both drivers.

Defaults everywhere are *off*: with ``faults=None`` no stream is created,
no draw is made, and both drivers are bit-identical to the seeded golden
traces (tests/test_torch_sim.py guards this).
"""
from __future__ import annotations

import math
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.daemon import NodeLostError  # re-export: typed crash error
from repro_torch.core.telemetry import ERROR_CLASSES, classify_error  # re-export

__all__ = [
    "NodeCrash",
    "LinkDegradation",
    "LoaderFault",
    "DbFlap",
    "SlowNode",
    "LoaderJitter",
    "MemoryLeak",
    "FaultPlan",
    "FaultDraws",
    "BreakerConfig",
    "CircuitBreaker",
    "SheddingConfig",
    "ShedError",
    "BreakerOpenError",
    "NodeLostError",
    "ERROR_CLASSES",
    "classify_error",
]


# ----------------------------------------------------------------------
# fault specs (frozen descriptions; no behavior)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class NodeCrash:
    """Node ``node`` dies at ``at_s`` (workload time). Everything in
    flight on it fails with :class:`NodeLostError`; accounting resets to
    empty. With ``restart_after_s`` the node rejoins (cold) that many
    seconds later."""
    node: str
    at_s: float
    restart_after_s: Optional[float] = None

    def __post_init__(self):
        if self.at_s < 0:
            raise ValueError("NodeCrash.at_s must be >= 0")
        if self.restart_after_s is not None and self.restart_after_s <= 0:
            raise ValueError("NodeCrash.restart_after_s must be > 0")


@dataclass(frozen=True)
class LinkDegradation:
    """Multiply link bandwidth by ``factor`` over ``[at_s, at_s +
    duration_s)``. ``link`` is ``"db"`` or ``"pcie"``; ``node=None``
    degrades that link on every node (a shared-storage brownout)."""
    at_s: float
    duration_s: float
    factor: float
    link: str = "db"
    node: Optional[str] = None

    def __post_init__(self):
        if self.link not in ("db", "pcie"):
            raise ValueError(f"LinkDegradation.link must be db|pcie, got {self.link!r}")
        if not (0.0 < self.factor < 1.0):
            raise ValueError("LinkDegradation.factor must be in (0, 1)")
        if self.duration_s <= 0:
            raise ValueError("LinkDegradation.duration_s must be > 0")


@dataclass(frozen=True)
class LoaderFault:
    """Each arrival of ``function`` inside ``[start_s, end_s)`` fails its
    db load leg with probability ``probability`` (a poisoned datum /
    flaky object store). Drawn per-arrival from the plan's dedicated
    stream — deterministic given the seed."""
    function: str
    probability: float
    start_s: float = 0.0
    end_s: float = math.inf

    def __post_init__(self):
        if not (0.0 <= self.probability <= 1.0):
            raise ValueError("LoaderFault.probability must be in [0, 1]")


@dataclass(frozen=True)
class DbFlap:
    """The db link on ``node`` (or every node) goes hard-down over
    ``[at_s, at_s + duration_s)``: loads needing the db leg fail fast
    with a typed error instead of degrading."""
    at_s: float
    duration_s: float
    node: Optional[str] = None

    def __post_init__(self):
        if self.duration_s <= 0:
            raise ValueError("DbFlap.duration_s must be > 0")


# ----------------------------------------------------------------------
# gray-failure specs (docs/resilience.md, "Gray failures"): the node is
# alive and passing health checks but slow — the tail-tolerance layer
# (repro_torch.core.slowness) is what detects and mitigates these.
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class SlowNode:
    """Node ``node`` runs ``factor``x slower over ``[at_s, at_s +
    duration_s)`` (``duration_s=None`` = until the end of the run): its
    kernel service time is multiplied by ``factor`` and its db/pcie
    loader bandwidth divided by it. The node stays *healthy* — binary
    eviction never fires; only slowness detection sees it."""
    node: str
    at_s: float
    factor: float
    duration_s: Optional[float] = None

    def __post_init__(self):
        if self.at_s < 0:
            raise ValueError("SlowNode.at_s must be >= 0")
        if self.factor <= 1.0:
            raise ValueError("SlowNode.factor must be > 1")
        if self.duration_s is not None and self.duration_s <= 0:
            raise ValueError("SlowNode.duration_s must be > 0")


@dataclass(frozen=True)
class LoaderJitter:
    """Each arrival of ``function`` inside ``[start_s, end_s)`` pays an
    extra heavy-tailed delay on its private load leg: ``scale_s *
    (U^(-1/alpha) - 1)`` with U drawn per-arrival from the plan's
    dedicated ``{seed}:jitter:{fn}`` stream (Pareto tail; smaller
    ``alpha`` = heavier tail). Deterministic given the seed, identical on
    both drivers."""
    function: str
    scale_s: float
    alpha: float = 2.0
    start_s: float = 0.0
    end_s: float = math.inf

    def __post_init__(self):
        if self.scale_s <= 0:
            raise ValueError("LoaderJitter.scale_s must be > 0")
        if self.alpha <= 0:
            raise ValueError("LoaderJitter.alpha must be > 0")


@dataclass(frozen=True)
class MemoryLeak:
    """Device memory on ``node`` leaks at ``rate_bps`` bytes/second over
    ``[at_s, at_s + duration_s)`` (``duration_s=None`` = forever):
    ``device_used`` creeps up, shrinking admission headroom and pushing
    the node toward OOM backpressure without any crash. The leak is
    reclaimed exactly when the window closes or the node is torn down."""
    node: str
    at_s: float
    rate_bps: float
    duration_s: Optional[float] = None

    def __post_init__(self):
        if self.at_s < 0:
            raise ValueError("MemoryLeak.at_s must be >= 0")
        if self.rate_bps <= 0:
            raise ValueError("MemoryLeak.rate_bps must be > 0")
        if self.duration_s is not None and self.duration_s <= 0:
            raise ValueError("MemoryLeak.duration_s must be > 0")


class FaultDraws:
    """Stateful per-function loader-fault draw streams. Each backend gets
    its OWN instance (``plan.make_draws()``) so runtime and sim consume
    identical sequences independently. ``draw(fn, t)`` advances the
    stream exactly once per call regardless of ``t`` (stream positions
    must track *arrival counts*, which match across drivers, not window
    membership, which could drift with float timing). Jitter draws
    (:class:`LoaderJitter`) follow the same contract on independent
    ``{seed}:jitter:{fn}`` streams."""

    def __init__(self, seed: int, specs: Tuple[LoaderFault, ...],
                 jitter_specs: Tuple["LoaderJitter", ...] = ()):
        self._specs: Dict[str, List[LoaderFault]] = {}
        for s in specs:
            self._specs.setdefault(s.function, []).append(s)
        self._streams = {
            fn: random.Random(f"{seed}:loader:{fn}") for fn in self._specs
        }
        self._jitter_specs: Dict[str, List[LoaderJitter]] = {}
        for j in jitter_specs:
            self._jitter_specs.setdefault(j.function, []).append(j)
        self._jitter_streams = {
            fn: random.Random(f"{seed}:jitter:{fn}")
            for fn in self._jitter_specs
        }

    def draw(self, function: str, t: float) -> bool:
        """True iff this arrival's db load leg should fail. Always draws
        when the function has any LoaderFault spec."""
        specs = self._specs.get(function)
        if not specs:
            return False
        u = self._streams[function].random()
        return any(s.start_s <= t < s.end_s and u < s.probability
                   for s in specs)

    def jitter(self, function: str, t: float) -> float:
        """Extra load-leg seconds for this arrival (0.0 outside every
        window). Always draws when the function has any LoaderJitter spec
        — window membership must not drift the stream position."""
        specs = self._jitter_specs.get(function)
        if not specs:
            return 0.0
        u = self._jitter_streams[function].random()
        extra = 0.0
        for s in specs:
            if s.start_s <= t < s.end_s:
                # inverse-CDF Pareto tail from the single uniform draw
                extra += s.scale_s * (max(u, 1e-12) ** (-1.0 / s.alpha) - 1.0)
        return extra


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, seeded fault schedule. ``events()`` returns the
    scheduled (non-draw) faults as sorted ``(t, kind, payload)`` tuples
    with kinds ``crash | restart | degrade_on | degrade_off | db_down |
    db_up | slow_on | slow_off | leak_on | leak_off``; ``make_draws()``
    returns a fresh :class:`FaultDraws` for the per-arrival loader-fault
    and jitter streams."""
    specs: Tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))
        for s in self.specs:
            if not isinstance(s, (NodeCrash, LinkDegradation, LoaderFault,
                                  DbFlap, SlowNode, LoaderJitter, MemoryLeak)):
                raise TypeError(f"unknown fault spec {type(s).__name__}")

    @property
    def loader_faults(self) -> Tuple[LoaderFault, ...]:
        return tuple(s for s in self.specs if isinstance(s, LoaderFault))

    @property
    def loader_jitters(self) -> Tuple[LoaderJitter, ...]:
        return tuple(s for s in self.specs if isinstance(s, LoaderJitter))

    def events(self) -> List[Tuple[float, str, object]]:
        ev: List[Tuple[float, str, object]] = []
        for s in self.specs:
            if isinstance(s, NodeCrash):
                ev.append((s.at_s, "crash", s))
                if s.restart_after_s is not None:
                    ev.append((s.at_s + s.restart_after_s, "restart", s))
            elif isinstance(s, LinkDegradation):
                ev.append((s.at_s, "degrade_on", s))
                ev.append((s.at_s + s.duration_s, "degrade_off", s))
            elif isinstance(s, DbFlap):
                ev.append((s.at_s, "db_down", s))
                ev.append((s.at_s + s.duration_s, "db_up", s))
            elif isinstance(s, SlowNode):
                ev.append((s.at_s, "slow_on", s))
                if s.duration_s is not None:
                    ev.append((s.at_s + s.duration_s, "slow_off", s))
            elif isinstance(s, MemoryLeak):
                ev.append((s.at_s, "leak_on", s))
                if s.duration_s is not None:
                    ev.append((s.at_s + s.duration_s, "leak_off", s))
        ev.sort(key=lambda e: (e[0], e[1]))
        return ev

    def make_draws(self) -> FaultDraws:
        return FaultDraws(self.seed, self.loader_faults, self.loader_jitters)


class ShedError(RuntimeError):
    """Request rejected by the load shedder (strict-mode runtime raise;
    the record carries ``error_class == "shed"``)."""


class BreakerOpenError(RuntimeError):
    """Request rejected by an open circuit breaker (strict-mode runtime
    raise; the record carries ``error_class == "breaker"``)."""


# ----------------------------------------------------------------------
# circuit breaker (per-function, closed -> open -> half-open)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class BreakerConfig:
    """Per-function circuit-breaker policy. The breaker opens when, over
    the last ``window`` outcomes (and at least ``min_requests`` of them),
    the failure fraction reaches ``failure_threshold``; it stays open for
    ``cooldown_s``, then admits ``half_open_probes`` probe requests — one
    probe failure reopens it, all probes succeeding closes it."""
    failure_threshold: float = 0.5
    window: int = 20
    min_requests: int = 5
    cooldown_s: float = 5.0
    half_open_probes: int = 2

    def __post_init__(self):
        if not (0.0 < self.failure_threshold <= 1.0):
            raise ValueError("failure_threshold must be in (0, 1]")
        if self.window < 1 or self.min_requests < 1:
            raise ValueError("window and min_requests must be >= 1")
        if self.cooldown_s <= 0 or self.half_open_probes < 1:
            raise ValueError("cooldown_s must be > 0, half_open_probes >= 1")


class CircuitBreaker:
    """One function's breaker. ``clock`` is any ``() -> float`` — virtual
    time in the sim, ``time.monotonic`` in the runtime — so the state
    machine is identical on both drivers. Thread-safe (the runtime feeds
    outcomes from worker done-callbacks)."""

    __slots__ = ("cfg", "_clock", "_lock", "_state", "_outcomes",
                 "_opened_at", "_probes_inflight", "_probes_ok",
                 "transitions")

    def __init__(self, cfg: BreakerConfig, clock):
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._outcomes: List[bool] = []  # sliding window, True = failure
        self._opened_at = 0.0
        self._probes_inflight = 0
        self._probes_ok = 0
        self.transitions: List[Tuple[float, str]] = []

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, state: str) -> None:
        self._state = state
        self.transitions.append((self._clock(), state))

    def allow(self) -> bool:
        """Gate one request. In half-open state this *claims* a probe
        slot, so callers must report the outcome via record()."""
        with self._lock:
            if self._state == "closed":
                return True
            now = self._clock()
            if self._state == "open":
                if now - self._opened_at < self.cfg.cooldown_s:
                    return False
                self._transition("half_open")
                self._probes_inflight = 0
                self._probes_ok = 0
            # half-open: admit up to half_open_probes concurrent probes
            if self._probes_inflight >= self.cfg.half_open_probes:
                return False
            self._probes_inflight += 1
            return True

    def record(self, ok: bool) -> None:
        """Feed one admitted request's outcome."""
        with self._lock:
            if self._state == "half_open":
                self._probes_inflight = max(0, self._probes_inflight - 1)
                if not ok:
                    self._opened_at = self._clock()
                    self._transition("open")
                    return
                self._probes_ok += 1
                if self._probes_ok >= self.cfg.half_open_probes:
                    self._transition("closed")
                    self._outcomes.clear()
                return
            if self._state == "open":
                return  # stale outcome from before the trip
            self._outcomes.append(not ok)
            if len(self._outcomes) > self.cfg.window:
                del self._outcomes[:len(self._outcomes) - self.cfg.window]
            n = len(self._outcomes)
            if n >= self.cfg.min_requests:
                fails = sum(self._outcomes)
                if fails / n >= self.cfg.failure_threshold:
                    self._opened_at = self._clock()
                    self._transition("open")


# ----------------------------------------------------------------------
# priority-aware load shedding
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class SheddingConfig:
    """Watermark shedding over normalized loader pressure. Pressure is
    the mean over *healthy* nodes of ``min(1, (pending admissions +
    loader queue) / (saturation * loader_threads))``. At or above
    ``watermark`` requests with ``priority <= loose_priority_max`` are
    shed; at or above ``hard_watermark`` everything is shed. Loose
    classes are sacrificed first — the tight-class SLO under overload is
    the benchmark headline (benchmarks/chaos.py)."""
    watermark: float = 0.7
    hard_watermark: float = 0.95
    loose_priority_max: int = 0
    saturation: float = 8.0

    def __post_init__(self):
        if not (0.0 < self.watermark <= self.hard_watermark <= 1.0):
            raise ValueError("need 0 < watermark <= hard_watermark <= 1")
        if self.saturation <= 0:
            raise ValueError("saturation must be > 0")

    def should_shed(self, pressure: float, priority: int) -> bool:
        if pressure >= self.hard_watermark:
            return True
        return pressure >= self.watermark and priority <= self.loose_priority_max


def node_pressure(pending_admissions: int, loader_queue: int,
                  loader_threads: int, saturation: float) -> float:
    """One node's normalized shed pressure in [0, 1] (shared by both
    drivers so the shed decision sequence matches)."""
    cap = max(1.0, saturation * max(1, loader_threads))
    return min(1.0, (pending_admissions + loader_queue) / cap)
