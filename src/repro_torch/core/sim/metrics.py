"""Streaming telemetry aggregates for trace-scale replays.

A million-invocation replay cannot afford one retained
:class:`~repro_torch.core.telemetry.InvocationRecord` per arrival (~1 KB each ->
gigabytes). :class:`AggregateTelemetry` is a drop-in *sink* for the
``telemetry.add(rec)`` call sites that keeps O(1) memory:

* running count / failure / SLO / warm-hit tallies,
* a P² (Jain & Chlamtac 1985) sketch per tracked quantile — online,
  five-marker, no sample retention,
* a fixed-size reservoir (Vitter's algorithm R) of latencies for exact
  post-hoc quantiles over a uniform sample.

The simulator selects it with ``Simulator(record_mode="aggregate")``;
the default ``"full"`` mode keeps the classic record-retaining
:class:`~repro_torch.core.telemetry.Telemetry` unchanged.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

from repro_torch.core.telemetry import InvocationRecord, classify_error

__all__ = ["P2Quantile", "Reservoir", "AggregateTelemetry"]


class P2Quantile:
    """P² single-quantile estimator: five markers tracked online, heights
    adjusted by a piecewise-parabolic fit. Exact for the first five
    observations, O(1) per observation after."""

    __slots__ = ("p", "_n", "_q", "_pos", "_count")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = p
        self._q: List[float] = []       # marker heights
        self._pos: List[float] = []     # marker positions (1-based)
        self._n: List[int] = []         # actual marker positions
        self._count = 0

    def add(self, x: float) -> None:
        self._count += 1
        q = self._q
        if len(q) < 5:
            q.append(x)
            q.sort()
            if len(q) == 5:
                self._n = [1, 2, 3, 4, 5]
                p = self.p
                self._pos = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p,
                             3.0 + 2.0 * p, 5.0]
            return
        n = self._n
        # locate the cell x falls into, updating extremes
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1
        p = self.p
        self._pos[1] += p / 2.0
        self._pos[2] += p
        self._pos[3] += (1.0 + p) / 2.0
        self._pos[4] += 1.0
        # adjust the three middle markers toward their desired positions
        for i in (1, 2, 3):
            d = self._pos[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1) or \
                    (d <= -1.0 and n[i - 1] - n[i] < -1):
                d = 1 if d > 0 else -1
                # piecewise-parabolic (P²) height update
                qn = q[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (q[i + 1] - q[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1])
                    / (n[i] - n[i - 1]))
                if q[i - 1] < qn < q[i + 1]:
                    q[i] = qn
                else:  # parabola left the bracket: fall back to linear
                    q[i] = q[i] + d * (q[i + d] - q[i]) / (n[i + d] - n[i])
                n[i] += d

    def value(self) -> float:
        """Current estimate (exact while fewer than 5 observations)."""
        q = self._q
        if not q:
            return 0.0
        if len(q) < 5:
            s = sorted(q)
            return s[min(int(self.p * len(s)), len(s) - 1)]
        return q[2]

    @property
    def count(self) -> int:
        return self._count


class Reservoir:
    """Fixed-size uniform sample of a stream (Vitter's algorithm R)."""

    __slots__ = ("k", "n", "sample", "_rng")

    def __init__(self, k: int = 4096, rng: Optional[random.Random] = None):
        self.k = k
        self.n = 0
        self.sample: List[float] = []
        self._rng = rng or random.Random(0)

    def add(self, x: float) -> None:
        self.n += 1
        if len(self.sample) < self.k:
            self.sample.append(x)
        else:
            j = self._rng.randrange(self.n)
            if j < self.k:
                self.sample[j] = x

    def quantile(self, q: float) -> float:
        """Sorted-index quantile over the retained sample (same index rule
        as ``Telemetry._quantile``)."""
        if not self.sample:
            return 0.0
        vals = sorted(self.sample)
        return vals[min(int(q * len(vals)), len(vals) - 1)]


class AggregateTelemetry:
    """Streaming sink for ``telemetry.add(rec)``: aggregates, then drops
    the record. Tracks the end-to-end latency distribution (P² p50/p99 +
    reservoir), duration, goodput (completions that met their deadline),
    warm-hit and preemption tallies — the fields BENCH_*.json reports."""

    __slots__ = ("count", "completed", "failures", "warm_hits",
                 "preemptions", "stalled_s", "deadline_total",
                 "deadline_met", "first_arrival_t", "last_end_t",
                 "e2e_p50", "e2e_p99", "duration_p50", "duration_p99",
                 "e2e_sample", "e2e_sum", "error_classes")

    def __init__(self, *, reservoir_k: int = 4096, seed: int = 0):
        self.count = 0
        self.completed = 0
        self.failures = 0
        # failure tally by error class (docs/resilience.md taxonomy) —
        # the streaming twin of Telemetry.error_counts()
        self.error_classes: Dict[str, int] = {}
        self.warm_hits = 0
        self.preemptions = 0
        self.stalled_s = 0.0
        self.deadline_total = 0
        self.deadline_met = 0
        self.first_arrival_t: Optional[float] = None
        self.last_end_t = 0.0
        self.e2e_p50 = P2Quantile(0.5)
        self.e2e_p99 = P2Quantile(0.99)
        self.duration_p50 = P2Quantile(0.5)
        self.duration_p99 = P2Quantile(0.99)
        self.e2e_sample = Reservoir(reservoir_k,
                                    random.Random(f"{seed}:telemetry"))
        self.e2e_sum = 0.0

    # -- Telemetry-compatible sink ------------------------------------
    def add(self, rec: InvocationRecord) -> None:
        if rec.dropped:
            return  # superseded re-dispatch attempt, not an outcome
        self.count += 1
        if self.first_arrival_t is None or rec.arrival_t < self.first_arrival_t:
            self.first_arrival_t = rec.arrival_t
        if rec.end_t > self.last_end_t:
            self.last_end_t = rec.end_t
        self.preemptions += rec.preemptions
        self.stalled_s += rec.stalled_s
        if rec.error is not None:
            self.failures += 1
            cls = rec.error_class or classify_error(rec.error) or "other"
            self.error_classes[cls] = self.error_classes.get(cls, 0) + 1
            if rec.deadline_s is not None:
                self.deadline_total += 1  # a failed request missed its SLO
            return
        self.completed += 1
        if rec.warm_stage is not None:
            self.warm_hits += 1
        e2e = rec.e2e
        self.e2e_sum += e2e
        self.e2e_p50.add(e2e)
        self.e2e_p99.add(e2e)
        self.e2e_sample.add(e2e)
        dur = rec.duration
        self.duration_p50.add(dur)
        self.duration_p99.add(dur)
        if rec.deadline_s is not None:
            self.deadline_total += 1
            if e2e <= rec.deadline_s:
                self.deadline_met += 1

    # -- views ---------------------------------------------------------
    def mean_e2e(self) -> float:
        return self.e2e_sum / self.completed if self.completed else 0.0

    def warm_fraction(self) -> float:
        return self.warm_hits / self.completed if self.completed else 0.0

    def error_counts(self) -> Dict[str, int]:
        """Failure tally by error class (Telemetry.error_counts twin)."""
        return dict(self.error_classes)

    def goodput(self) -> float:
        """Fraction of deadline-carrying requests that completed in time
        (1.0 when no request carried a deadline — goodput degenerates to
        completion then)."""
        if not self.deadline_total:
            return 1.0 if not self.failures else (
                self.completed / (self.completed + self.failures))
        return self.deadline_met / self.deadline_total

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "completed": self.completed,
            "failures": self.failures,
            "mean_e2e_s": self.mean_e2e(),
            "p50_e2e_s": self.e2e_p50.value(),
            "p99_e2e_s": self.e2e_p99.value(),
            "p50_duration_s": self.duration_p50.value(),
            "p99_duration_s": self.duration_p99.value(),
            "reservoir_p50_e2e_s": self.e2e_sample.quantile(0.5),
            "reservoir_p99_e2e_s": self.e2e_sample.quantile(0.99),
            "warm_fraction": self.warm_fraction(),
            "goodput": self.goodput(),
            "preemptions": self.preemptions,
            "stalled_s": self.stalled_s,
            "error_counts": dict(self.error_classes),
        }
