"""Per-invocation stage telemetry (Fig 2 / Fig 15 / Table 4 breakdowns)."""
from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# canonical stage order (paper Fig 2)
STAGES = (
    "container_create",
    "cpu_ctx",
    "cpu_data",
    "gpu_ctx",
    "gpu_data",
    "compute",
    "return_result",
)
SETUP_STAGES = STAGES[:5]

# canonical failure taxonomy (docs/resilience.md): every failed record
# carries one of these in ``error_class`` so reports and the chaos
# benchmark never re-parse ``error`` message strings.
ERROR_CLASSES = ("data_load", "timeout", "shed", "breaker", "node_lost",
                 "hedged", "other")

# ``error`` strings are "Type: message"; map the type prefix to a class.
# NodeLostError subclasses DataLoadError, so it is matched first.
# "hedged" marks a cancelled hedge loser — such records are always
# ``dropped`` (the winning twin is the request's one outcome), so the
# class never shows up in error_counts()/slo_by_priority().
_ERROR_PREFIXES = (
    ("NodeLostError", "node_lost"),
    ("ShedError", "shed"),
    ("BreakerOpenError", "breaker"),
    ("HedgedError", "hedged"),
    ("DataLoadError", "data_load"),
    ("TimeoutError", "timeout"),
)


def classify_error(error: Optional[str]) -> Optional[str]:
    """Error class for an ``InvocationRecord.error`` string (None for
    records that did not fail). Fallback for records produced before the
    writer stamped ``error_class`` directly."""
    if error is None:
        return None
    for prefix, cls in _ERROR_PREFIXES:
        if error.startswith(prefix):
            return cls
    return "other"


@dataclass
class InvocationRecord:
    request_id: str
    function: str
    system: str
    arrival_t: float = 0.0
    start_t: float = 0.0
    end_t: float = 0.0
    warm_stage: Optional[int] = None  # exit-policy stage reused (None = cold)
    stages: Dict[str, float] = field(default_factory=dict)  # stage -> seconds
    dropped: bool = False
    error: Optional[str] = None  # "Type: message" when the invocation failed
    deadline_s: Optional[float] = None  # per-request SLO (recorded, not enforced)
    priority: int = 0
    max_retries: Optional[int] = None  # OOM-admission retry budget (None = flat deadline)
    node_id: str = ""        # node that served the invocation ("gpu0", ...)
    # residency tier of the function on the chosen node AT DISPATCH time
    # ("device"|"loading"|"host"|"none"); None = not cluster-dispatched
    dispatch_tier: Optional[str] = None
    # transfer-scheduling attribution (docs/dataplane.md): how many times
    # this invocation's transfer streams were paused to yield the link,
    # and the total seconds they sat paused. Attributed to the invocation
    # whose window the pause happened in (the loading record in the sim;
    # the delta over the invocation's in-flight span in the runtime).
    preemptions: int = 0
    stalled_s: float = 0.0
    setup_wall: float = 0.0  # wall time of the (possibly parallel) setup span
    result: Any = None       # handler return value (real runtime only)
    # resilience attribution (docs/resilience.md): failure taxonomy class
    # (one of ERROR_CLASSES when error is set) and how many times the
    # request was re-dispatched after losing its node
    error_class: Optional[str] = None
    redispatches: int = 0
    # compute-plane attribution (docs/compute.md): how many same-function
    # invocations shared this record's stacked kernel launch (1 = solo),
    # and the request_ids it was batched with. Each member still gets its
    # own record; the compute stage holds the amortized shared span.
    batch_size: int = 1
    batched_with: tuple = ()

    @property
    def e2e(self) -> float:
        return self.end_t - self.arrival_t

    @property
    def slo_miss(self) -> bool:
        return self.deadline_s is not None and self.e2e > self.deadline_s

    @property
    def duration(self) -> float:
        return self.end_t - self.start_t

    @property
    def setup_time(self) -> float:
        return sum(self.stages.get(s, 0.0) for s in SETUP_STAGES)

    @property
    def queueing(self) -> float:
        return max(self.start_t - self.arrival_t, 0.0)


class Telemetry:
    def __init__(self):
        self._lock = threading.Lock()
        self.records: List[InvocationRecord] = []
        self._by_id: Dict[str, InvocationRecord] = {}
        # sorted-view cache for the pXX quantile family: (attr, function)
        # -> (version, sorted values). ``add`` bumps the version, so every
        # append invalidates; repeated quantile calls between appends reuse
        # the sorted list instead of re-sorting the whole record set.
        # (Records are final by the time they are added — both drivers set
        # end_t/stages before calling add() — so a cached view never goes
        # stale without the version changing.)
        self._version = 0
        self._sorted_cache: Dict[tuple, tuple] = {}

    def add(self, rec: InvocationRecord) -> None:
        with self._lock:
            self.records.append(rec)
            # one logical outcome per request id: a superseded (dropped)
            # attempt never shadows the request's real record — a hedge
            # loser's cancellation can land AFTER its winner on both
            # drivers, so last-add-wins would point find() at the corpse
            cur = self._by_id.get(rec.request_id)
            if cur is None or not rec.dropped:
                self._by_id[rec.request_id] = rec
            self._version += 1

    def find(self, request_id: str) -> Optional[InvocationRecord]:
        """O(1) lookup by request id (records added via ``add``)."""
        with self._lock:
            return self._by_id.get(request_id)

    def snapshot(self) -> List[InvocationRecord]:
        """Consistent copy of the record list (public: the cluster merge
        and gateway report paths consume it). Every read path goes through
        this: runtime pool threads ``add()`` concurrently with readers, and
        iterating ``self.records`` unlocked races the append (a list can be
        observed mid-resize)."""
        with self._lock:
            return list(self.records)

    # ------------------------------------------------------------------
    def by_function(self) -> Dict[str, List[InvocationRecord]]:
        out = defaultdict(list)
        for r in self.snapshot():
            if not r.dropped:
                out[r.function].append(r)
        return dict(out)

    def mean_stage_breakdown(self, function: Optional[str] = None) -> Dict[str, float]:
        recs = [
            r for r in self.snapshot()
            if not r.dropped and (function is None or r.function == function)
        ]
        if not recs:
            return {s: 0.0 for s in STAGES}
        return {
            s: sum(r.stages.get(s, 0.0) for r in recs) / len(recs) for s in STAGES
        }

    def mean_e2e(self, function: Optional[str] = None) -> float:
        recs = [
            r for r in self.snapshot()
            if not r.dropped and (function is None or r.function == function)
        ]
        return sum(r.e2e for r in recs) / len(recs) if recs else 0.0

    def _quantile(self, q: float, key, function: Optional[str] = None) -> float:
        """Sorted-index quantile of ``key(record)`` over non-dropped
        records (one implementation for every pXX view). Arbitrary ``key``
        callables cannot be cached; the pXX family below routes through
        the attribute-cached :meth:`_quantile_attr` instead."""
        vals = sorted(
            key(r) for r in self.snapshot()
            if not r.dropped and (function is None or r.function == function)
        )
        if not vals:
            return 0.0
        return vals[min(int(q * len(vals)), len(vals) - 1)]

    def _sorted_vals(self, attr: str, function: Optional[str]) -> list:
        """Sorted ``getattr(record, attr)`` view, cached until the next
        ``add``. The version is read BEFORE the snapshot: a concurrent add
        can only make the stored entry look stale (recomputed next call),
        never let stale data be served as fresh."""
        cache_key = (attr, function)
        cached = self._sorted_cache.get(cache_key)
        if cached is not None and cached[0] == self._version:
            return cached[1]
        version = self._version
        vals = sorted(
            getattr(r, attr) for r in self.snapshot()
            if not r.dropped and (function is None or r.function == function)
        )
        self._sorted_cache[cache_key] = (version, vals)
        return vals

    def _quantile_attr(self, q: float, attr: str,
                       function: Optional[str] = None) -> float:
        vals = self._sorted_vals(attr, function)
        if not vals:
            return 0.0
        return vals[min(int(q * len(vals)), len(vals) - 1)]

    def p50_duration(self, function: Optional[str] = None) -> float:
        """Median start->end duration (the dispatch benchmark's headline:
        warm routing removes setup stages from the middle of the
        distribution, not just the tail)."""
        return self._quantile_attr(0.5, "duration", function)

    def p95_duration(self, function: Optional[str] = None) -> float:
        """95th-percentile start->end duration (tail view: preemptive
        transfer is a tail-latency feature, docs/dataplane.md)."""
        return self._quantile_attr(0.95, "duration", function)

    def p99_duration(self, function: Optional[str] = None) -> float:
        """99th-percentile start->end duration — the headline the
        preemption benchmark compares per deadline class."""
        return self._quantile_attr(0.99, "duration", function)

    def transfer_wait(self, function: Optional[str] = None) -> float:
        """Total seconds invocation transfer streams spent paused on a
        yielded link (sum of ``stalled_s`` over records; 0.0 under
        ``transfer="run_to_completion"``)."""
        return sum(
            r.stalled_s for r in self.snapshot()
            if not r.dropped and (function is None or r.function == function)
        )

    def preemption_count(self, function: Optional[str] = None) -> int:
        """Total stream pauses attributed to records (see
        ``InvocationRecord.preemptions``)."""
        return sum(
            r.preemptions for r in self.snapshot()
            if not r.dropped and (function is None or r.function == function)
        )

    def p99_e2e(self, function: Optional[str] = None) -> float:
        return self._quantile_attr(0.99, "e2e", function)

    def throughput(self, t_window: float) -> float:
        done = [r for r in self.snapshot() if not r.dropped]
        return len(done) / t_window if t_window > 0 else 0.0

    def warm_fraction(self) -> float:
        recs = [r for r in self.snapshot() if not r.dropped]
        if not recs:
            return 0.0
        return sum(1 for r in recs if r.warm_stage is not None) / len(recs)

    def errors(self) -> List[InvocationRecord]:
        """Invocations that failed (data-plane or handler faults)."""
        return [r for r in self.snapshot() if r.error is not None]

    def error_count(self) -> int:
        return len(self.errors())

    def error_counts(self) -> Dict[str, int]:
        """Failed records tallied by error class (``ERROR_CLASSES``):
        ``data_load``, ``timeout``, ``shed``, ``breaker``, ``node_lost``,
        ``other``. Reads the stamped ``error_class`` and falls back to
        parsing the ``error`` type prefix — callers never re-parse
        message strings (docs/resilience.md)."""
        out: Dict[str, int] = {}
        for r in self.snapshot():
            if r.dropped or r.error is None:
                continue
            cls = r.error_class or classify_error(r.error) or "other"
            out[cls] = out.get(cls, 0) + 1
        return out

    @staticmethod
    def _is_miss(r: InvocationRecord) -> bool:
        return r.error is not None or r.slo_miss

    def slo_misses(self) -> List[InvocationRecord]:
        """Records that violated their deadline: completed too late, or
        failed outright (a failed request never met its SLO)."""
        return [r for r in self.snapshot()
                if not r.dropped and r.deadline_s is not None
                and self._is_miss(r)]

    def slo_miss_rate(self) -> float:
        """Misses over records that carried a deadline (0.0 if none did —
        deadlines are opt-in request metadata). Computed from ONE snapshot
        so a concurrent ``add()`` cannot skew numerator vs denominator."""
        with_slo = [r for r in self.snapshot()
                    if not r.dropped and r.deadline_s is not None]
        if not with_slo:
            return 0.0
        return sum(1 for r in with_slo if self._is_miss(r)) / len(with_slo)

    # ------------------------------------------------------------------
    # per-node attribution (cluster dispatch, docs/cluster.md)
    # ------------------------------------------------------------------
    def by_node(self) -> Dict[str, List[InvocationRecord]]:
        """Records grouped by the node that served them."""
        out = defaultdict(list)
        for r in self.snapshot():
            if not r.dropped:
                out[r.node_id].append(r)
        return dict(out)

    def node_counts(self) -> Dict[str, int]:
        """Invocations per node — the dispatch-skew view the runtime/sim
        parity test compares."""
        return {n: len(rs) for n, rs in self.by_node().items()}

    def dispatch_hit_rate(self) -> float:
        """Fraction of cluster-dispatched records routed to a node where
        the function was already resident (device/loading/host) at
        dispatch time. Records with ``dispatch_tier is None`` (single-node
        drivers) are excluded; 0.0 when nothing was cluster-dispatched."""
        routed = [r for r in self.snapshot()
                  if not r.dropped and r.dispatch_tier is not None]
        if not routed:
            return 0.0
        return sum(1 for r in routed if r.dispatch_tier != "none") / len(routed)

    def dispatch_by_node(self) -> Dict[str, Dict[str, float]]:
        """Per-node dispatch breakdown: ``{node_id: {requests, hits,
        hit_rate}}`` over cluster-dispatched records."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.snapshot():
            if r.dropped or r.dispatch_tier is None:
                continue
            c = out.setdefault(r.node_id, {"requests": 0, "hits": 0})
            c["requests"] += 1
            if r.dispatch_tier != "none":
                c["hits"] += 1
        for c in out.values():
            c["hit_rate"] = c["hits"] / c["requests"]
        return out

    def slo_by_priority(self) -> Dict[int, Dict[str, float]]:
        """Per-priority-class SLO attainment over deadline-carrying records:
        ``{priority: {requests, misses, miss_rate, attainment}}``. This is
        the report the EDF-vs-FIFO scheduling benchmark compares class by
        class (docs/api.md)."""
        classes: Dict[int, Dict[str, float]] = {}
        for r in self.snapshot():
            if r.dropped or r.deadline_s is None:
                continue
            c = classes.setdefault(r.priority, {"requests": 0, "misses": 0})
            c["requests"] += 1
            if self._is_miss(r):
                c["misses"] += 1
        for c in classes.values():
            c["miss_rate"] = c["misses"] / c["requests"]
            c["attainment"] = 1.0 - c["miss_rate"]
        return classes
