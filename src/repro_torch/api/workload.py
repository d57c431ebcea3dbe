"""Workload: backend-agnostic load descriptions.

A workload is a deterministic (seeded) list of timed :class:`Arrival`s with
optional per-request SLO metadata. ``Gateway.replay`` drives the same
object through either backend — virtual time on the simulator, paced
wall-clock time on the real runtime — so one trace can check that both
drivers agree.

Shapes provided here subsume the repo's previous ad-hoc generators:
open-loop Poisson (``poisson_arrivals`` loops), the MAF-like trace
(``core.simulator.maf_like_trace``), bursty load, and multi-function mixes.
"""
from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class Arrival:
    """One timed request. ``deadline_s``/``priority`` of ``None`` fall back
    to the registered FunctionSpec's defaults at replay time."""

    t: float
    function: str
    deadline_s: Optional[float] = None
    priority: Optional[int] = None


DeadlineLike = Union[None, float, Dict[str, float]]
PriorityLike = Union[None, int, Dict[str, int]]


# ---------------------------------------------------------------------------
# canonical trace generators (moved here from ``repro_torch.core.simulator``,
# which keeps thin deprecated aliases)
# ---------------------------------------------------------------------------
def poisson_arrivals(rate_per_s: float, duration_s: float,
                     rng: random.Random) -> List[float]:
    """Open-loop Poisson arrival times in ``[0, duration_s)``."""
    t, out = 0.0, []
    while True:
        t += rng.expovariate(rate_per_s)
        if t >= duration_s:
            return out
        out.append(t)


def maf_like_trace(
    functions: List[str], duration_s: float, seed: int = 0,
    mean_rpm: float = 12.0,
) -> List[Tuple[float, str]]:
    """Azure-Functions-like trace: per-function Poisson with log-normal rate
    spread and hour-scale bursts (Shahrad et al.: most functions see a few
    to dozens of requests/minute)."""
    rng = random.Random(seed)
    events: List[Tuple[float, str]] = []
    for f in functions:
        rate = (mean_rpm / 60.0) * math.exp(rng.gauss(0.0, 0.8))
        burst_phase = rng.random() * duration_s
        t = 0.0
        while True:
            # burst modulation: 2x rate inside a 10% duty window
            mult = 2.0 if ((t + burst_phase) % 600.0) < 60.0 else 1.0
            t += rng.expovariate(rate * mult)
            if t >= duration_s:
                break
            events.append((t, f))
    events.sort()
    return events


class Workload:
    """Base class. Subclasses implement ``_generate()``; events are
    generated once, cached, and returned sorted by arrival time.

    ``deadline_s``/``priority`` accept a scalar (every arrival) or a
    ``{function: value}`` dict (mixed-SLO traces — the shape the EDF-vs-FIFO
    scheduling benchmark replays)."""

    duration_s: float = 0.0

    def __init__(self, *, deadline_s: DeadlineLike = None,
                 priority: PriorityLike = None):
        self._deadline_s = deadline_s
        self._priority = priority
        self._cached: Optional[List[Arrival]] = None

    # -- SLO metadata ----------------------------------------------------
    def _deadline_for(self, function: str) -> Optional[float]:
        if isinstance(self._deadline_s, dict):
            return self._deadline_s.get(function)
        return self._deadline_s

    def _priority_for(self, function: str) -> Optional[int]:
        if isinstance(self._priority, dict):
            return self._priority.get(function)
        return self._priority

    def _arrival(self, t: float, function: str) -> Arrival:
        return Arrival(t, function, self._deadline_for(function),
                       self._priority_for(function))

    # -- events ----------------------------------------------------------
    def _generate(self) -> List[Arrival]:
        raise NotImplementedError

    def events(self) -> List[Arrival]:
        if self._cached is None:
            self._cached = sorted(self._generate(), key=lambda a: a.t)
        return self._cached

    def stream(self) -> Iterator[Arrival]:
        """Arrivals in time order, lazily where the shape allows it.

        The base implementation falls back to the materialized ``events()``
        list; per-function workloads override ``_function_streams`` and get
        a true lazy merge (``heapq.merge`` over per-function generators —
        the million-invocation replay path, which never holds the whole
        trace in memory). The merge is stable, so the ordering of
        simultaneous arrivals matches ``events()``' stable sort."""
        streams = self._function_streams()
        if streams is None:
            return iter(self.events())
        return heapq.merge(*streams, key=lambda a: a.t)

    def _function_streams(self) -> Optional[List[Iterator[Arrival]]]:
        """Per-function lazy arrival generators (each already time-sorted),
        or ``None`` when the shape only exists materialized."""
        return None

    def __iter__(self):
        return iter(self.events())

    def __len__(self) -> int:
        return len(self.events())

    def functions(self) -> List[str]:
        return sorted({a.function for a in self.events()})

    def end_t(self) -> float:
        ev = self.events()
        return ev[-1].t if ev else 0.0


def _as_list(functions: Union[str, Sequence[str]]) -> List[str]:
    return [functions] if isinstance(functions, str) else list(functions)


class TraceWorkload(Workload):
    """Explicit events: ``Arrival``s or ``(t, function)`` tuples."""

    def __init__(self, events: Iterable[Union[Arrival, Tuple[float, str]]],
                 **kw):
        super().__init__(**kw)
        self._raw = list(events)
        self.duration_s = max(
            (e.t if isinstance(e, Arrival) else e[0] for e in self._raw),
            default=0.0,
        )

    def _generate(self) -> List[Arrival]:
        return [e if isinstance(e, Arrival) else self._arrival(e[0], e[1])
                for e in self._raw]


class PoissonWorkload(Workload):
    """Open-loop Poisson at ``rate_per_s``; with several functions each
    arrival picks one uniformly. ``max_events`` truncates the stream (for
    count-bounded drivers like examples/serve_workload.py)."""

    def __init__(self, functions: Union[str, Sequence[str]],
                 rate_per_s: float, duration_s: float, *, seed: int = 0,
                 max_events: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.function_names = _as_list(functions)
        self.rate_per_s = float(rate_per_s)
        self.duration_s = float(duration_s)
        self.seed = seed
        self.max_events = max_events

    def _generate(self) -> List[Arrival]:
        return list(self._lazy())

    def _lazy(self) -> Iterator[Arrival]:
        rng = random.Random(self.seed)
        n = 0
        t = 0.0
        while True:
            t += rng.expovariate(self.rate_per_s)
            if t >= self.duration_s:
                return
            fn = self.function_names[rng.randrange(len(self.function_names))]
            yield self._arrival(t, fn)
            n += 1
            if self.max_events is not None and n >= self.max_events:
                return

    def _function_streams(self) -> Optional[List[Iterator[Arrival]]]:
        # one shared rng drives rate and function choice, so the lazy form
        # is a single already-sorted stream
        return [self._lazy()]


class MixWorkload(Workload):
    """Multi-function mix: an independent Poisson process per function,
    ``{function: rate_per_s}`` (the contention-benchmark shape)."""

    def __init__(self, rates: Dict[str, float], duration_s: float, *,
                 seed: int = 0, **kw):
        super().__init__(**kw)
        self.rates = dict(rates)
        self.duration_s = float(duration_s)
        self.seed = seed

    def _generate(self) -> List[Arrival]:
        out: List[Arrival] = []
        for s in self._function_streams():
            out.extend(s)
        return out

    def _one(self, fn: str, rate: float) -> Iterator[Arrival]:
        # str seeds hash via sha512 (stable across processes), so each
        # function gets its own deterministic stream
        rng = random.Random(f"{self.seed}:{fn}")
        t = 0.0
        while True:
            t += rng.expovariate(rate)
            if t >= self.duration_s:
                return
            yield self._arrival(t, fn)

    def _function_streams(self) -> List[Iterator[Arrival]]:
        return [self._one(fn, self.rates[fn])
                for fn in sorted(self.rates) if self.rates[fn] > 0]


class BurstWorkload(Workload):
    """Base-rate Poisson with periodic bursts: every ``period_s`` each
    function runs at ``burst_rate_per_s`` for ``burst_len_s`` (random phase
    per function), modeling flash-crowd traffic."""

    def __init__(self, functions: Union[str, Sequence[str]],
                 base_rate_per_s: float, burst_rate_per_s: float,
                 duration_s: float, *, period_s: float = 600.0,
                 burst_len_s: float = 60.0, seed: int = 0, **kw):
        super().__init__(**kw)
        self.function_names = _as_list(functions)
        self.base_rate = float(base_rate_per_s)
        self.burst_rate = float(burst_rate_per_s)
        self.duration_s = float(duration_s)
        self.period_s = float(period_s)
        self.burst_len_s = float(burst_len_s)
        self.seed = seed

    def _generate(self) -> List[Arrival]:
        out: List[Arrival] = []
        for s in self._function_streams():
            out.extend(s)
        return out

    def _one(self, fn: str) -> Iterator[Arrival]:
        # thinning against the max rate: candidates are drawn at the peak
        # rate and kept with probability rate(t)/peak, so the rate is
        # evaluated at the CANDIDATE time — stepping gaps at the previous
        # event's rate would jump clean over burst windows shorter than a
        # base-rate interarrival gap
        peak = max(self.base_rate, self.burst_rate)
        rng = random.Random(f"{self.seed}:{fn}")
        phase = rng.random() * self.period_s
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= self.duration_s:
                return
            in_burst = ((t + phase) % self.period_s) < self.burst_len_s
            rate = self.burst_rate if in_burst else self.base_rate
            if rng.random() < rate / peak:
                yield self._arrival(t, fn)

    def _function_streams(self) -> List[Iterator[Arrival]]:
        return [self._one(fn) for fn in self.function_names]


class DiurnalWorkload(Workload):
    """Day-scale sinusoidal load: per-function Poisson whose rate swings
    ``base_rate_per_s * (1 ± amplitude)`` over ``period_s`` (default 24 h,
    compressed periods make quick experiments). Generated by thinning
    against the peak rate, like :class:`BurstWorkload`, so short periods
    are never stepped over."""

    def __init__(self, functions: Union[str, Sequence[str]],
                 base_rate_per_s: float, duration_s: float, *,
                 amplitude: float = 0.8, period_s: float = 86400.0,
                 phase_s: float = 0.0, seed: int = 0, **kw):
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
        super().__init__(**kw)
        self.function_names = _as_list(functions)
        self.base_rate = float(base_rate_per_s)
        self.duration_s = float(duration_s)
        self.amplitude = float(amplitude)
        self.period_s = float(period_s)
        self.phase_s = float(phase_s)
        self.seed = seed

    def rate_at(self, t: float) -> float:
        return self.base_rate * (1.0 + self.amplitude * math.sin(
            2.0 * math.pi * (t + self.phase_s) / self.period_s))

    def _one(self, fn: str) -> Iterator[Arrival]:
        peak = self.base_rate * (1.0 + self.amplitude)
        rng = random.Random(f"{self.seed}:{fn}")
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= self.duration_s:
                return
            if rng.random() < self.rate_at(t) / peak:
                yield self._arrival(t, fn)

    def _function_streams(self) -> List[Iterator[Arrival]]:
        return [self._one(fn) for fn in self.function_names]

    def _generate(self) -> List[Arrival]:
        out: List[Arrival] = []
        for s in self._function_streams():
            out.extend(s)
        return out


class FlashCrowdWorkload(Workload):
    """Baseline Poisson with sudden crowd spikes: at each time in
    ``spike_times_s`` the rate jumps to ``spike_factor * base`` and decays
    back exponentially with time constant ``decay_s`` — the
    cold-start-stampede shape GPU serverless platforms fear most (every
    spike lands on functions whose instances have exited)."""

    def __init__(self, functions: Union[str, Sequence[str]],
                 base_rate_per_s: float, duration_s: float, *,
                 spike_times_s: Sequence[float] = (),
                 spike_factor: float = 10.0, decay_s: float = 30.0,
                 seed: int = 0, **kw):
        if spike_factor < 1.0:
            raise ValueError(f"spike_factor must be >= 1, got {spike_factor}")
        super().__init__(**kw)
        self.function_names = _as_list(functions)
        self.base_rate = float(base_rate_per_s)
        self.duration_s = float(duration_s)
        self.spike_times_s = sorted(float(t) for t in spike_times_s)
        self.spike_factor = float(spike_factor)
        self.decay_s = float(decay_s)
        self.seed = seed

    def rate_at(self, t: float) -> float:
        boost = 0.0
        for ts in self.spike_times_s:
            if ts > t:
                break  # spikes are sorted; later ones have not hit yet
            boost += (self.spike_factor - 1.0) * math.exp(
                -(t - ts) / self.decay_s)
        return self.base_rate * (1.0 + boost)

    def _one(self, fn: str) -> Iterator[Arrival]:
        peak = self.base_rate * (
            1.0 + (self.spike_factor - 1.0) * max(1, len(self.spike_times_s))
            if self.spike_times_s else 1.0)
        rng = random.Random(f"{self.seed}:{fn}")
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= self.duration_s:
                return
            if rng.random() < self.rate_at(t) / peak:
                yield self._arrival(t, fn)

    def _function_streams(self) -> List[Iterator[Arrival]]:
        return [self._one(fn) for fn in self.function_names]

    def _generate(self) -> List[Arrival]:
        out: List[Arrival] = []
        for s in self._function_streams():
            out.extend(s)
        return out


class MultiRegionWorkload(Workload):
    """Composition of per-region workloads, each shifted by a per-region
    time offset (timezone skew): ``{"us": wl_a, "eu": wl_b}`` with
    ``offsets_s={"eu": 3600.0}`` replays ``wl_b`` an hour later. The
    shifted union models follow-the-sun load on one shared cluster —
    regions peak at different times, so sharing-aware dispatch can pack
    them (docs/cluster.md)."""

    def __init__(self, regions: Dict[str, Workload], *,
                 offsets_s: Optional[Dict[str, float]] = None, **kw):
        super().__init__(**kw)
        if not regions:
            raise ValueError("regions must not be empty")
        self.regions = dict(regions)
        self.offsets_s = dict(offsets_s or {})
        unknown = set(self.offsets_s) - set(self.regions)
        if unknown:
            raise ValueError(f"offsets for unknown regions: {sorted(unknown)}")
        self.duration_s = max(
            wl.duration_s + self.offsets_s.get(name, 0.0)
            for name, wl in self.regions.items())

    def _shift(self, name: str) -> Iterator[Arrival]:
        dt = self.offsets_s.get(name, 0.0)
        for a in self.regions[name].stream():
            yield Arrival(a.t + dt, a.function, a.deadline_s, a.priority)

    def _function_streams(self) -> List[Iterator[Arrival]]:
        return [self._shift(name) for name in sorted(self.regions)]

    def _generate(self) -> List[Arrival]:
        out: List[Arrival] = []
        for s in self._function_streams():
            out.extend(s)
        return out


class MAFWorkload(Workload):
    """Azure-Functions-like replay (Shahrad et al.): per-function Poisson
    with log-normal rate spread and hour-scale bursts. Wraps the generator
    the trace benchmarks have always used, so replays are bit-identical to
    the pre-gateway ``maf_like_trace`` calls with the same arguments."""

    def __init__(self, functions: Union[str, Sequence[str]],
                 duration_s: float, *, seed: int = 0, mean_rpm: float = 12.0,
                 **kw):
        super().__init__(**kw)
        self.function_names = _as_list(functions)
        self.duration_s = float(duration_s)
        self.seed = seed
        self.mean_rpm = mean_rpm

    def _generate(self) -> List[Arrival]:
        return [self._arrival(t, f) for t, f in maf_like_trace(
            self.function_names, self.duration_s, seed=self.seed,
            mean_rpm=self.mean_rpm)]


class ChaosWorkload(Workload):
    """Mixed-priority Poisson mix for the resilience benchmarks
    (benchmarks/chaos.py, docs/resilience.md): each function carries a
    (rate, deadline, priority) triple, so one trace holds both the tight
    high-priority class the shedder protects and the loose low-priority
    class it sacrifices first. Arrival streams are per-function seeded,
    identical on both drivers."""

    def __init__(self, classes: Dict[str, Tuple[float, float, int]],
                 duration_s: float, *, seed: int = 0):
        # classes: {function: (rate_per_s, deadline_s, priority)}
        super().__init__(
            deadline_s={f: c[1] for f, c in classes.items()},
            priority={f: c[2] for f, c in classes.items()})
        self.classes = dict(classes)
        self.duration_s = float(duration_s)
        self.seed = seed

    def _generate(self) -> List[Arrival]:
        out: List[Arrival] = []
        for fn in sorted(self.classes):
            rate = self.classes[fn][0]
            if rate <= 0:
                continue
            rng = random.Random(f"{self.seed}:{fn}")
            t = 0.0
            while True:
                t += rng.expovariate(rate)
                if t >= self.duration_s:
                    break
                out.append(self._arrival(t, fn))
        return out
