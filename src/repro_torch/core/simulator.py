"""Virtual-time discrete-event twin of the runtime, for trace-scale
experiments (Figs 3, 10-14, 16, 17).

Runs the SAME policy decisions (SystemPolicy flags, ExitLadder stages,
read-only sharing, slot accounting, FCFS context pools) as the threaded
runtime, but with modeled durations (paper Table 2/4 profiles + fair-share
brokers) under a VirtualClock — two hours of MAF trace replay complete in
milliseconds, deterministically.

This module is the FACADE over the layered simulator package
(docs/simulator.md):

* engine — :mod:`repro_torch.core.sim.kernel` (event heap) and
  :mod:`repro_torch.core.sim.rng` (seeded streams);
* domain — :mod:`repro_torch.core.sim.domain` (:class:`GPUNode`,
  :class:`SimInstance`, transfer-leg machines) and
  :mod:`repro_torch.core.sim.invocations` (per-policy invocation lifecycles);
* policy — :mod:`repro_torch.core.sim.policies` (admission + dispatch plugins,
  sharing the daemon's key formula and ``choose_node`` byte-for-byte).

Modeling choices (documented in DESIGN.md §2):
* GPU compute is FIFO (one kernel at a time) — consistent with the paper's
  Throughput_theo = T_period / T_comp definition;
* gpu_ctx creation = 285.1 ms (Table 4) and does not contend (paper §6.1:
  'context creation for function invocations does not interfere');
* db / PCIe paths are progressive-filling fair-share links (Fig 4's 34.9x
  contention emerges from these, not from a hard-coded factor).
"""
from __future__ import annotations

import random
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.baselines import SystemPolicy, get_system
from repro_torch.core.clock import VirtualClock
from repro_torch.core.compute import (
    ComputePlane, empty_compute_stats, resolve_compute,
)
from repro_torch.core.daemon import SCHEDULERS
from repro_torch.core.faults import (
    BreakerConfig, CircuitBreaker, FaultPlan, SheddingConfig, node_pressure,
)
from repro_torch.core.placement import (
    DISPATCH_POLICIES, PlacementControl, choose_node, resolve_autoscale,
)
from repro_torch.core.sim.domain import (  # noqa: F401  (re-exported API)
    CONTAINER_S, CPU_CTX_S, GPU_CTX_S, RETURN_S, GPUNode, PendingReservation,
    SimFunction, SimInstance,
)
from repro_torch.core.sim.invocations import (
    CallbackCompletion, Completion, DgsfInvocation, FixedInvocation,
    SageInvocation,
)
from repro_torch.core.sim.kernel import EventKind
from repro_torch.core.sim.metrics import AggregateTelemetry
from repro_torch.core.sim.policies import dispatch_strategy
from repro_torch.core.sim.rng import RngStreams
from repro_torch.core.slowness import (
    QuarantineController, make_detector, resolve_hedging, resolve_quarantine,
)
from repro_torch.core.telemetry import STAGES, InvocationRecord, Telemetry
from repro_torch.core.transfer import DEFAULT_CHUNK_BYTES

# back-compat: pre-refactor code imported the private name
_PendingReservation = PendingReservation

# prototype stage dict copied into every fresh record (stages are empty at
# that point, so the bulk update equals the old per-key setdefault loop)
_STAGE_ZEROS = {s: 0.0 for s in STAGES}

# error-record prefix per failure class (docs/resilience.md); the prefixes
# are what telemetry.classify_error parses back out
_ERROR_PREFIX = {
    "data_load": "DataLoadError",
    "node_lost": "NodeLostError",
    "shed": "ShedError",
    "breaker": "BreakerOpenError",
    "timeout": "TimeoutError",
    "hedged": "HedgedError",
}

# MemoryLeak creep granularity (workload seconds between leak ticks)
_LEAK_TICK_S = 0.5


def _rec_done(rec: InvocationRecord) -> bool:
    """A record is resolved once ``end_t`` is stamped (records are born
    with ``end_t == 0.0``; completion and every failure path stamp it)."""
    return rec.end_t > 0.0


class _HedgePair:
    """One speculative duplicate in flight: the primary record, its hedge
    clone, and their invocation machines. The first twin to COMPLETE
    resolves the pair and cancels the other; a twin that *fails* while its
    sibling is still live is dropped silently (the logical request is
    still in flight — only the last-standing twin's failure counts)."""

    __slots__ = ("primary", "hedge", "machines", "resolved")

    def __init__(self, primary: InvocationRecord, hedge: InvocationRecord):
        self.primary = primary
        self.hedge = hedge
        self.machines: Dict[int, object] = {}
        self.resolved = False

    def twin(self, rec: InvocationRecord) -> InvocationRecord:
        return self.hedge if rec is self.primary else self.primary


class Simulator:
    """Drives a cluster of :class:`GPUNode`s through a submitted trace.

    ``record_mode`` selects the telemetry sink: ``"full"`` (default)
    retains every :class:`InvocationRecord` in a classic
    :class:`Telemetry`; ``"aggregate"`` streams records through
    :class:`~repro_torch.core.sim.metrics.AggregateTelemetry` (O(1) memory —
    the million-invocation replay mode, where broker transfer history is
    also disabled)."""

    def __init__(self, system: str | SystemPolicy = "sage", *, n_nodes: int = 1,
                 capacity: int = 40 << 30, host_capacity: int = 125 << 30,
                 exit_ttl: float = 30.0, seed: int = 0,
                 loader_threads: int = 4, load_timeout_s: float = 600.0,
                 scheduler: str = "fifo", dispatch: str = "random",
                 transfer: str = "run_to_completion",
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 record_mode: str = "full",
                 faults: Optional[FaultPlan] = None,
                 breaker: Optional[BreakerConfig] = None,
                 shedding: Optional[SheddingConfig] = None,
                 eviction: bool = False,
                 autoscale=None,
                 hedging=None, quarantine=None, compute=None):
        if dispatch not in DISPATCH_POLICIES:
            raise ValueError(
                f"unknown dispatch {dispatch!r}; use one of {DISPATCH_POLICIES}")
        if record_mode not in ("full", "aggregate"):
            raise ValueError(
                f"unknown record_mode {record_mode!r}; use 'full' or 'aggregate'")
        self.policy = get_system(system) if isinstance(system, str) else system
        self.dispatch = dispatch
        self._dispatcher = dispatch_strategy(dispatch)
        self.clock = VirtualClock()
        # static node-construction kwargs, kept for the dynamic pool's
        # add_node (scheduler/transfer are re-read from a live node so a
        # later set_scheduler/set_transfer carries over to joiners)
        self._node_kwargs = dict(
            capacity=capacity, host_capacity=host_capacity,
            exit_ttl=exit_ttl, loader_threads=loader_threads,
            load_timeout_s=load_timeout_s, chunk_bytes=chunk_bytes)
        self.nodes = [
            GPUNode(self.policy, self.clock, name=f"gpu{i}",
                    scheduler=scheduler, transfer=transfer,
                    **self._node_kwargs)
            for i in range(n_nodes)
        ]
        self._node_seq = n_nodes  # next gpu<i> id for add_node
        self.record_mode = record_mode
        if record_mode == "aggregate":
            self.telemetry = AggregateTelemetry(seed=seed)
            for node in self.nodes:  # no per-transfer history either
                node.db.keep_history = False
                node.pcie.keep_history = False
        else:
            self.telemetry = Telemetry()
        self.functions: Dict[str, SimFunction] = {}
        self.rng = RngStreams(seed)
        # root stream = random.Random(seed): bit-compatible with the
        # pre-kernel Simulator._rng that seeded §7.8 replays consume
        self._rng = self.rng.root
        self.completed = 0
        self.failed = 0
        # launched-but-unresolved invocations (the twin of the threaded
        # node's ``_inflight``): lets a manual drain on a sim WITHOUT
        # fault tracking (no faults/control plane — the active set is
        # never maintained there) prove whole-sim quiescence before the
        # teardown, instead of retiring over an invisible live invocation
        self.inflight = 0
        # resilience layer (docs/resilience.md). With every knob at its
        # default the whole layer is inert: no draw stream exists, no FAULT
        # event is scheduled, nodes skip active-set tracking, and the
        # seeded golden traces are bit-identical to the pre-fault kernel.
        self.faults = faults
        self.eviction = bool(eviction)
        self.shedding = shedding
        self._breaker_cfg = breaker
        self._breaker_overrides: Dict[str, BreakerConfig] = {}
        self.breakers: Dict[str, CircuitBreaker] = {}
        self._fault_draws = faults.make_draws() if faults is not None else None
        self.shed_count = 0
        self.breaker_rejections = 0
        self.node_lost_count = 0
        self.redispatches = 0
        # tail-tolerance layer (docs/resilience.md, "Gray failures"):
        # hedged redispatch + suspect-node quarantine over one shared
        # SlownessDetector. Both knobs default off — _slowness stays None,
        # the invocation machines skip their completion hook, and no timer
        # is ever scheduled, so seeded golden traces are bit-identical.
        self._hedging = resolve_hedging(hedging)
        self._quarantine_cfg = resolve_quarantine(quarantine)
        self._slowness = None
        self._quarantine: Optional[QuarantineController] = None
        self.hedges_launched = 0
        self.hedges_won = 0
        self.hedges_wasted = 0
        if self._hedging is not None or self._quarantine_cfg is not None:
            self._init_slowness()
        if faults is not None:
            for node in self.nodes:
                node.fault_tracking = True
            for t, action, spec in faults.events():
                self.clock.schedule_at(t, self._apply_fault, action, spec,
                                       kind=EventKind.FAULT)
        # placement control plane (docs/planner.md): planner + work
        # stealer + predictive autoscaler over a dynamic node pool. With
        # dispatch != "planned" and autoscale=None the whole layer is
        # inert (no control object, no extra events) — golden-trace safe.
        # shared compute plane (docs/compute.md): fractional SM slicing +
        # same-function batching. With compute=None the attribute stays
        # None, no plane is attached, and the FIFO compute arithmetic in
        # sim.invocations is byte-identical to the seed (golden-trace safe).
        self._compute = resolve_compute(compute)
        if self._compute is not None:
            for node in self.nodes:
                node.compute_plane = ComputePlane(self._compute)
        self.autoscale = resolve_autoscale(autoscale)
        self._control: Optional[PlacementControl] = None
        self._has_drains = False  # fast-path guard for dispatchable_nodes
        if dispatch == "planned" or self.autoscale is not None:
            self._ensure_control()

    @property
    def scheduler(self) -> str:
        return self.nodes[0].scheduler

    def set_scheduler(self, scheduler: str) -> None:
        """Switch loader/admission ordering ("fifo"|"edf"); applies to
        events queued after the call."""
        if scheduler not in SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {scheduler!r}; use one of {SCHEDULERS}")
        for node in self.nodes:
            node.scheduler = scheduler

    def set_dispatch(self, dispatch: str) -> None:
        """Switch the cluster dispatch policy; applies to arrivals
        dispatched after the call."""
        if dispatch not in DISPATCH_POLICIES:
            raise ValueError(
                f"unknown dispatch {dispatch!r}; use one of {DISPATCH_POLICIES}")
        self.dispatch = dispatch
        self._dispatcher = dispatch_strategy(dispatch)
        if dispatch == "planned":
            self._ensure_control()

    def set_autoscale(self, autoscale) -> None:
        """Enable (or swap) predictive autoscaling mid-run — the spec
        adoption path (docs/planner.md). Creates the placement control
        plane on first use."""
        self.autoscale = resolve_autoscale(autoscale)
        if self.autoscale is None:
            if self._control is not None:
                self._control.set_autoscale(None)
            return
        self._ensure_control()
        self._control.set_autoscale(self.autoscale)

    def set_compute(self, compute) -> None:
        """Enable (or swap) the shared compute plane mid-run — the spec
        adoption path (docs/compute.md). Applies to compute stages entered
        after the call; ``"exclusive"``/None detaches the plane and
        restores the seed FIFO arithmetic."""
        self._compute = resolve_compute(compute)
        for node in self.nodes:
            node.compute_plane = (ComputePlane(self._compute)
                                  if self._compute is not None else None)
            node.compute_batches.clear()

    def compute_stats(self) -> Dict[str, object]:
        """Compute-plane counters aggregated over nodes (key set shared
        with the runtime gateway's ``compute_stats`` — docs/compute.md)."""
        if self._compute is None:
            return empty_compute_stats("exclusive", 0)
        out = empty_compute_stats("shared", self._compute.slices)
        for node in self.nodes:
            plane = node.compute_plane
            if plane is None:
                continue
            out["grants"] += plane.grants
            out["contended_grants"] += plane.contended_grants
            out["batches"] += plane.batches
            out["batched"] += plane.batched
        return out

    def set_hedging(self, hedging) -> None:
        """Enable (or swap) hedged redispatch mid-run — the spec adoption
        path (docs/resilience.md). Applies to arrivals launched after the
        call."""
        self._hedging = resolve_hedging(hedging)
        if self._hedging is not None:
            self._init_slowness()

    def set_quarantine(self, quarantine) -> None:
        """Enable (or swap) suspect-node quarantine mid-run — the spec
        adoption path (docs/resilience.md)."""
        self._quarantine_cfg = resolve_quarantine(quarantine)
        if self._quarantine_cfg is not None:
            self._init_slowness()
            if self._quarantine is None \
                    or self._quarantine.cfg != self._quarantine_cfg:
                self._quarantine = QuarantineController(
                    self._quarantine_cfg, self._slowness)
        else:
            self._quarantine = None

    def _init_slowness(self) -> None:
        """Build the shared detector (+ quarantine controller) once either
        tail-tolerance knob turns on; nodes get active-set tracking so a
        quarantine drain's idle check can see live invocations."""
        if self._slowness is None:
            self._slowness = make_detector(self._hedging,
                                           self._quarantine_cfg)
        if self._quarantine_cfg is not None and self._quarantine is None:
            self._quarantine = QuarantineController(
                self._quarantine_cfg, self._slowness)
        for node in self.nodes:
            node.fault_tracking = True

    def node_snapshot(self, node, fn_name: str):
        """One dispatch snapshot, health-graded when slowness detection is
        on (every snapshot-scoring call site routes through here so
        dispatch, the planner, and hedge targeting see the same grade)."""
        if self._slowness is None:
            return node.dispatch_snapshot(fn_name)
        return node.dispatch_snapshot(
            fn_name, health_score=self._slowness.health_score(node.name))

    @property
    def transfer(self) -> str:
        return self.nodes[0].arbiter.mode

    def set_transfer(self, transfer: str) -> None:
        """Switch the transfer mode ("run_to_completion"|"preemptive");
        applies to chunks advanced after the call."""
        for node in self.nodes:
            node.arbiter.set_mode(transfer)

    def preemption_count(self) -> int:
        """Total link preemptions across nodes (the twin of the daemon's
        ``stats["preemptions"]``)."""
        return sum(n.arbiter.preemptions for n in self.nodes)

    # ------------------------------------------------------------------
    def register(self, fn: SimFunction) -> None:
        self.functions[fn.name] = fn
        for node in self.nodes:
            self._register_on_node(node, fn)
        if self._control is not None:
            self._control.register_function(fn.name,
                                            fn.ro_bytes + fn.ctx_bytes)

    def _register_on_node(self, node, fn: SimFunction) -> None:
        node.instances[fn.name] = []
        node.ro_state[fn.name] = "none"
        node.ro_ready_cbs[fn.name] = []
        if self.policy.pre_created_contexts:
            # DGSF pins contexts permanently; with many functions the
            # pool must shrink to fit (4 x 414 MB x 30 fns > 40 GB)
            n = self.policy.pre_created_contexts
            while n > 1 and node.used + n * fn.ctx_bytes > 0.85 * node.capacity:
                n -= 1
            node.dgsf_free[fn.name] = n
            node.dgsf_queue[fn.name] = []
            node.used += n * fn.ctx_bytes  # permanent DGSF overhead

    def retire(self, fn_name: str) -> None:
        """Unregister a function: new arrivals for it raise KeyError and
        the planner frees its planned share (a churn signal —
        docs/planner.md). Resident state ages out via the exit ladder."""
        self.functions.pop(fn_name, None)
        if self._control is not None:
            self._control.retire_function(fn_name)

    def submit(self, fn_name: str, t: float, *,
               deadline_s: Optional[float] = None, priority: int = 0,
               request_id: Optional[str] = None,
               max_retries: Optional[int] = None) -> None:
        self.clock.schedule_at(
            t, self._arrive, fn_name, t, deadline_s, priority,
            request_id, max_retries, kind=EventKind.ARRIVAL)

    def replay_stream(self, events: Iterable) -> None:
        """Feed a (possibly huge / lazy) time-ordered arrival stream with
        at most ONE feeder event on the heap at a time — the
        million-invocation replay path, which never pre-schedules the whole
        trace. ``events`` yields :class:`~repro_torch.api.workload.Arrival`-likes
        (``t``/``function``/``deadline_s``/``priority`` attributes) or
        ``(t, function)`` tuples; times must be non-decreasing."""
        self._feed_next(iter(events))

    def _feed_next(self, it) -> None:
        nxt = next(it, None)
        if nxt is None:
            return
        if isinstance(nxt, tuple):
            t, fn_name = nxt[0], nxt[1]
            deadline_s = nxt[2] if len(nxt) > 2 else None
            priority = nxt[3] if len(nxt) > 3 else 0
        else:
            t, fn_name = nxt.t, nxt.function
            deadline_s = getattr(nxt, "deadline_s", None)
            priority = getattr(nxt, "priority", None)
        self.clock.schedule_at(t, self._feed_fire, it, t, fn_name,
                               deadline_s, 0 if priority is None else priority,
                               kind=EventKind.FEED)

    def _feed_fire(self, it, t: float, fn_name: str,
                   deadline_s: Optional[float], priority: int) -> None:
        self._arrive(fn_name, t, deadline_s, priority, None, None)
        self._feed_next(it)

    def run(self, until: float = float("inf")) -> None:
        self.clock.run_until(until)

    # ------------------------------------------------------------------
    def _dispatch_node(self, fn_name: str):
        """(node, residency tier at dispatch) for one arrival. Single-node
        sims have no dispatch decision (tier None keeps their records
        identical to the single-node runtime's). ``"random"`` consumes the
        same seeded ``rng.choice`` stream as the pre-dispatch simulator, so
        seeded §7.8 replays are unchanged."""
        if len(self.nodes) == 1:
            return self.nodes[0], None
        return self._dispatcher.pick(self, fn_name)

    def _arrive(self, fn_name: str, arrival_t: float,
                deadline_s: Optional[float] = None, priority: int = 0,
                request_id: Optional[str] = None,
                max_retries: Optional[int] = None) -> None:
        fn = self.functions[fn_name]
        injected = False
        jitter_s = 0.0
        if self._fault_draws is not None:
            # draw FIRST, unconditionally: the stream position tracks
            # arrival counts (identical across drivers) — a shed/breaker
            # rejection must not shift later arrivals' draws. The jitter
            # draw rides its own {seed}:jitter:{fn} streams, so it never
            # perturbs the poison stream either way.
            injected = self._fault_draws.draw(fn_name, arrival_t)
            jitter_s = self._fault_draws.jitter(fn_name, arrival_t)
        if self.shedding is not None:
            p = self._shed_pressure()
            if self.shedding.should_shed(p, priority):
                self.shed_count += 1
                self._reject(fn, arrival_t, deadline_s, priority,
                             request_id, max_retries, "shed",
                             f"shed at pressure {p:.2f}")
                return
        # shed runs BEFORE the breaker: allow() claims half-open probe
        # slots, and a later rejection would leak the claimed slot
        if self._breaker_cfg is not None or self._breaker_overrides:
            br = self._breaker_for(fn_name)
            if br is not None and not br.allow():
                self.breaker_rejections += 1
                self._reject(fn, arrival_t, deadline_s, priority,
                             request_id, max_retries, "breaker",
                             "circuit open")
                return
        if self._control is not None:
            # control-plane arrivals: forecast accounting + the control
            # tick (autoscale/replan/drain-finalize) ride every arrival,
            # so an idle sim schedules no extra events and still halts
            self._control.note_arrival(fn_name)
            self._control_tick(arrival_t)
            if self.dispatch == "planned" and len(self.nodes) > 1:
                self._planned_arrive(fn, arrival_t, deadline_s, priority,
                                     request_id, max_retries, injected,
                                     jitter_s)
                return
        node, tier = self._dispatch_node(fn_name)
        rec = self._make_record(fn_name, arrival_t, deadline_s, priority,
                                request_id, max_retries, node, tier)
        self._launch(node, fn, rec, injected, jitter_s)

    def _make_record(self, fn_name: str, arrival_t: float,
                     deadline_s: Optional[float], priority: int,
                     request_id: Optional[str], max_retries: Optional[int],
                     node, tier) -> InvocationRecord:
        rec = InvocationRecord(
            request_id=request_id or f"{fn_name}@{arrival_t:.4f}",
            function=fn_name,
            system=self.policy.name, arrival_t=arrival_t,
            start_t=self.clock.now(),
            deadline_s=deadline_s, priority=priority,
            max_retries=max_retries,
            node_id=node.name, dispatch_tier=tier,
        )
        # canonical stage keys up front (stages a policy path skips read as
        # 0.0) — keeps the record structure identical to the threaded
        # runtime's, which the parity test in tests/test_torch_api.py guards
        rec.stages.update(_STAGE_ZEROS)
        return rec

    def _launch(self, node, fn: SimFunction, rec: InvocationRecord,
                injected: bool, jitter_s: float = 0.0) -> None:
        self.inflight += 1
        if not node.healthy:
            # dispatch landed on a dead node (eviction off, or nothing
            # healthy left to evict onto): fail typed, never enqueue
            self.node_lost_count += 1
            self._fail_record(fn, rec, f"node {node.name} is down",
                              cls="node_lost")
            return
        machine = self._start_invocation(node, fn, rec, injected, jitter_s)
        if (self._hedging is not None
                and getattr(rec, "_hedge_pair", None) is None
                and self.policy.name.startswith("sage")):
            est = self._slowness.estimate(fn.name,
                                          self._hedging.min_samples)
            if est is not None:
                self.clock.schedule(est * self._hedging.delay_factor,
                                    self._hedge_fire, fn, rec, machine,
                                    kind=EventKind.TIMER)

    # ------------------------------------------------------------------
    # planned dispatch + work stealing (docs/planner.md)
    # ------------------------------------------------------------------
    def _planned_arrive(self, fn: SimFunction, arrival_t: float,
                        deadline_s: Optional[float], priority: int,
                        request_id: Optional[str],
                        max_retries: Optional[int], injected: bool,
                        jitter_s: float = 0.0) -> None:
        nodes = self.dispatchable_nodes()
        snaps = [self.node_snapshot(n, fn.name) for n in nodes]
        decision = self._control.route(fn.name, snaps)
        if decision[0] == "board":
            # queued-but-unstarted: the planned home (and every pick
            # alternative) is above the steal watermark, so the arrival
            # parks on the steal board; after board_delay_s the stealer
            # re-routes it with fresh snapshots (a landing away from the
            # home is a steal and charges the redispatch budget)
            home = nodes[decision[1]]
            self.clock.schedule_at(
                self.clock.now() + self._control.planner.cfg.board_delay_s,
                self._board_fire, fn, arrival_t, deadline_s, priority,
                request_id, max_retries, injected, home.name, jitter_s,
                kind=EventKind.TIMER)
            return
        _, idx, _hit = decision
        rec = self._make_record(fn.name, arrival_t, deadline_s, priority,
                                request_id, max_retries, nodes[idx],
                                snaps[idx].ro_tier)
        self._launch(nodes[idx], fn, rec, injected, jitter_s)

    def _board_fire(self, fn: SimFunction, arrival_t: float,
                    deadline_s: Optional[float], priority: int,
                    request_id: Optional[str], max_retries: Optional[int],
                    injected: bool, home_id: str,
                    jitter_s: float = 0.0) -> None:
        nodes = self.dispatchable_nodes()
        snaps = [self.node_snapshot(n, fn.name) for n in nodes]
        stole = False
        if max_retries is None or max_retries > 0:
            idx, stole = self._control.reroute(fn.name, snaps, home_id)
        else:
            # no redispatch budget: the boarded work must start on its
            # original home (same rule as crash re-dispatch fail-fast)
            idx = next((i for i, s in enumerate(snaps)
                        if s.node_id == home_id), None)
            if idx is None:  # home drained/evicted while boarded
                idx, _ = self._control.reroute(fn.name, snaps, home_id)
        rec = self._make_record(fn.name, arrival_t, deadline_s, priority,
                                request_id, max_retries, nodes[idx],
                                snaps[idx].ro_tier)
        if stole:
            rec.redispatches += 1
            self.redispatches += 1
        self._launch(nodes[idx], fn, rec, injected, jitter_s)

    def _control_tick(self, now: float) -> None:
        add, drain_ids = self._control.maybe_tick(now)
        for _ in range(add):
            self.add_node()
        for nid in drain_ids:
            self.drain_node(nid)
        if self._has_drains:
            self._try_finalize_drains()

    def _start_invocation(self, node, fn: SimFunction,
                          rec: InvocationRecord,
                          injected: bool = False, jitter_s: float = 0.0):
        """Instantiate the policy's invocation machine (fresh arrival or
        post-crash re-dispatch — the latter reuses the record, so latency
        spans the whole arrival-to-final-finish window). Returns the
        machine so the hedging layer can cancel a losing twin."""
        if self.policy.name.startswith("sage"):
            return SageInvocation(self, node, fn, rec, injected,
                                  jitter_s=jitter_s)
        if self.policy.pre_created_contexts:
            return DgsfInvocation(self, node, fn, rec, injected,
                                  jitter_s=jitter_s)
        return FixedInvocation(self, node, fn, rec, injected,
                               jitter_s=jitter_s)

    # ------------------------------------------------------------------
    # dynamic node pool (docs/planner.md)
    # ------------------------------------------------------------------
    def _ensure_control(self) -> None:
        if self._control is not None:
            return
        self._control = PlacementControl(
            [n.name for n in self.nodes], autoscale=self.autoscale,
            now=self.clock.now())
        for node in self.nodes:
            # active-invocation tracking feeds the drain idle check (the
            # same set crash re-dispatch uses)
            node.fault_tracking = True
        for fn in self.functions.values():
            self._control.register_function(fn.name,
                                            fn.ro_bytes + fn.ctx_bytes)

    def add_node(self) -> GPUNode:
        """Provision one cold node into the pool; every registered
        function is registered on it and dispatch may target it from the
        next arrival."""
        name = f"gpu{self._node_seq}"
        self._node_seq += 1
        live = next((n for n in self.nodes if not n.retired), None)
        node = GPUNode(
            self.policy, self.clock, name=name,
            scheduler=live.scheduler if live else "fifo",
            transfer=live.arbiter.mode if live else "run_to_completion",
            **self._node_kwargs)
        if self.record_mode == "aggregate":
            node.db.keep_history = False
            node.pcie.keep_history = False
        if self._compute is not None:
            node.compute_plane = ComputePlane(self._compute)
        if self.faults is not None or self._control is not None \
                or self._slowness is not None:
            node.fault_tracking = True
        for fn in self.functions.values():
            self._register_on_node(node, fn)
        self.nodes.append(node)
        if self._control is not None:
            self._control.node_provisioned(name, self.clock.now())
        return node

    def drain_node(self, name: str) -> None:
        """Start a graceful drain: the node takes no new placements and
        retires (exact teardown, node-seconds stop accruing) once its
        in-flight work completes."""
        node = self._node_by_name(name)
        if node.draining or node.retired:
            return
        node.draining = True
        self._has_drains = True
        if self._control is not None:
            self._control.node_draining(name)
        self._try_finalize_drains()

    def _try_finalize_drains(self) -> None:
        for node in self.nodes:
            if not (node.draining and not node.retired and node.is_idle()):
                continue
            if not node.fault_tracking and self.inflight:
                # the active set was never maintained on this node (manual
                # drain, no faults/control plane), so per-node idleness
                # cannot see a live invocation mid-setup or mid-compute —
                # only whole-sim quiescence proves the node is quiet
                continue
            node.finalize_drain()
            if self._control is not None:
                self._control.node_retired(node.name, self.clock.now())

    def placement_stats(self) -> Optional[Dict]:
        """Planner/stealer/autoscaler counters + the node-count timeline
        (None unless the control plane is on — docs/planner.md)."""
        if self._control is None:
            return None
        if self._has_drains:
            self._try_finalize_drains()
        return self._control.stats(self.clock.now())

    # ------------------------------------------------------------------
    # resilience control layer (docs/resilience.md)
    # ------------------------------------------------------------------
    def dispatchable_nodes(self) -> List[GPUNode]:
        """Nodes dispatch may target. Draining/retired nodes leave the
        candidate set (docs/planner.md); with ``eviction`` on, dead nodes
        are drained out while any healthy node remains. When nothing is
        draining and eviction is off this returns the SAME list object,
        so the seeded ``rng.choice`` stream is untouched."""
        nodes = self.nodes
        if self._has_drains:
            up = [n for n in nodes if not (n.draining or n.retired)]
            nodes = up or nodes
        if not self.eviction:
            return nodes
        healthy = [n for n in nodes if n.healthy]
        return healthy or nodes

    def set_function_breaker(self, fn_name: str, cfg: BreakerConfig) -> None:
        """Per-function breaker override (wins over the constructor-wide
        config); applies from the next arrival."""
        self._breaker_overrides[fn_name] = cfg
        self.breakers.pop(fn_name, None)

    def _breaker_for(self, fn_name: str) -> Optional[CircuitBreaker]:
        br = self.breakers.get(fn_name)
        if br is None:
            cfg = self._breaker_overrides.get(fn_name, self._breaker_cfg)
            if cfg is None:
                return None
            br = self.breakers[fn_name] = CircuitBreaker(cfg, self.clock.now)
        return br

    def _note_result(self, fn_name: str, ok: bool) -> None:
        br = self.breakers.get(fn_name)
        if br is not None:
            br.record(ok)

    def _shed_pressure(self) -> float:
        """Mean normalized loader pressure over healthy nodes (the shared
        :func:`~repro_torch.core.faults.node_pressure` formula)."""
        nodes = [n for n in self.nodes
                 if n.healthy and not (n.draining or n.retired)] or self.nodes
        sat = self.shedding.saturation
        total = 0.0
        for n in nodes:
            total += node_pressure(n.pending_admission_count(),
                                   n.loader_queue_depth(),
                                   n.loader_threads, sat)
        return total / len(nodes)

    def _reject(self, fn: SimFunction, arrival_t: float,
                deadline_s: Optional[float], priority: int,
                request_id: Optional[str], max_retries: Optional[int],
                cls: str, reason: str) -> None:
        """Admission-gate rejection (shed / breaker): resolves immediately
        with a typed error record; never reaches a node and never feeds
        the breaker window (a breaker chewing on its own rejections would
        latch open forever)."""
        rec = InvocationRecord(
            request_id=request_id or f"{fn.name}@{arrival_t:.4f}",
            function=fn.name,
            system=self.policy.name, arrival_t=arrival_t,
            start_t=self.clock.now(),
            deadline_s=deadline_s, priority=priority,
            max_retries=max_retries,
        )
        rec.stages.update(_STAGE_ZEROS)
        self._fail_record(fn, rec, reason, cls=cls)

    def _node_lost(self, inv) -> None:
        """A live invocation's node crashed under it. With eviction on and
        a healthy node available, re-dispatch the SAME record through the
        normal dispatch path while budget remains (``max_retries=None`` =
        unlimited, matching the daemon's OOM-retry semantics; ``0`` =
        fail-fast); otherwise fail typed ``node_lost``."""
        fn, rec = inv.fn, inv.rec
        self.node_lost_count += 1
        pair = getattr(rec, "_hedge_pair", None)
        if pair is not None and not _rec_done(pair.twin(rec)):
            # the hedge twin is still live elsewhere: don't burn budget
            # re-dispatching this copy — drop it (the twin carries the
            # logical request; _fail_record does the dropped marking)
            self._fail_record(fn, rec, f"node {inv.node.name} crashed",
                              cls="node_lost")
            return
        if self.eviction and any(n.healthy for n in self.nodes) \
                and (rec.max_retries is None
                     or rec.redispatches < rec.max_retries):
            rec.redispatches += 1
            self.redispatches += 1
            node2, tier = self._dispatch_node(fn.name)
            rec.node_id = node2.name
            rec.dispatch_tier = tier
            # the injected-fault draw was consumed by the first attempt
            self._start_invocation(node2, fn, rec, False)
            return
        self._fail_record(fn, rec, f"node {inv.node.name} crashed",
                          cls="node_lost")

    # ------------------------------------------------------------------
    # tail tolerance: hedged redispatch + quarantine (docs/resilience.md)
    # ------------------------------------------------------------------
    def _hedge_fire(self, fn: SimFunction, rec: InvocationRecord,
                    machine) -> None:
        """The hedge timer elapsed: the invocation ran past its learned
        latency quantile. Launch ONE speculative duplicate on the best
        non-suspect node (first completion wins), charging the duplicate
        to the request's ``max_retries`` budget."""
        if _rec_done(rec) or getattr(rec, "_hedge_pair", None) is not None:
            return
        if rec.max_retries is not None \
                and rec.redispatches >= rec.max_retries:
            return
        cands = [n for n in self.dispatchable_nodes()
                 if n.healthy and n.name != rec.node_id
                 and not self._slowness.is_suspect(n.name)]
        if not cands:
            return
        snaps = [self.node_snapshot(n, fn.name) for n in cands]
        node2 = cands[choose_node("locality", snaps)]
        rec.redispatches += 1
        self.redispatches += 1
        clone = self._make_record(
            fn.name, rec.arrival_t, rec.deadline_s, rec.priority,
            rec.request_id, rec.max_retries, node2,
            node2.residency(fn.name)[0])
        clone.redispatches = rec.redispatches
        pair = _HedgePair(rec, clone)
        rec._hedge_pair = pair
        clone._hedge_pair = pair
        pair.machines[id(rec)] = machine
        self.hedges_launched += 1
        self.inflight += 1
        # the injected-fault/jitter draws were consumed by the primary
        pair.machines[id(clone)] = self._start_invocation(
            node2, fn, clone, False)

    def _tail_complete(self, node, fn: SimFunction,
                       rec: InvocationRecord) -> None:
        """Success hook from the invocation machines (only wired when the
        detector exists): feed the latency profiles, resolve a hedge pair
        (cancel the losing twin), and drive the quarantine machine."""
        self._slowness.observe_record(node.name, fn.name, rec.stages,
                                      rec.duration)
        pair = getattr(rec, "_hedge_pair", None)
        if pair is not None and not pair.resolved:
            pair.resolved = True
            if rec is pair.hedge:
                self.hedges_won += 1      # the duplicate beat the primary
            else:
                self.hedges_wasted += 1   # primary finished first anyway
            twin = pair.twin(rec)
            if not _rec_done(twin):
                # censored straggler evidence: the loser held its node at
                # least this long without finishing. Cancelled records
                # never complete, so once hedging starts winning the
                # suspicion signal would otherwise starve and quarantine
                # could never trigger on the node being hedged around.
                elapsed = self.clock.now() - twin.start_t
                self._slowness.observe(twin.node_id, "compute", elapsed)
                m = pair.machines.get(id(twin))
                if m is not None:
                    m.hedge_cancel()
                # the loser's node is judged on the censored sample too —
                # it never completes anything once hedging wins, so the
                # quarantine machine would otherwise never see it
                self._quarantine_note(twin.node_id, elapsed)
        self._quarantine_note(node.name, rec.stages.get("compute", 0.0))

    def _quarantine_note(self, node_name: str, compute_s: float) -> None:
        """Feed one node observation into the quarantine state machine and
        execute whatever action it returns through the drain/probe
        machinery."""
        if self._quarantine is None:
            return
        node = self._node_by_name(node_name)
        if node.retired or node.draining:
            return
        action = self._quarantine.note_completion(
            node_name, self.clock.now(), compute_s)
        if action == "quarantine":
            self.drain_node(node_name)
            probe_at = self._quarantine.next_probe_at()
            if probe_at is not None:
                self.clock.schedule_at(probe_at, self._probe_fire,
                                       kind=EventKind.TIMER)
        # "readmit" is resolved inside the controller; a node retired on
        # a slow canary is drained again, this time for good
        elif action == "retire":
            self.drain_node(node_name)

    def _probe_fire(self) -> None:
        """A quarantine cooldown elapsed: readmit each due node cold, in
        probation — its next ``canary_count`` completions are the canary
        set (half-open probing on live traffic)."""
        if self._quarantine is None:
            return
        for nid in self._quarantine.due_probes(self.clock.now()):
            self._readmit_node(nid)

    def _readmit_node(self, name: str) -> None:
        """Bring a drained/retired node back into the pool, cold — the
        same restore + DGSF re-pin path a post-crash restart runs."""
        node = self._node_by_name(name)
        if node.draining and not node.retired and node.is_idle():
            node.finalize_drain()  # still mid-drain: finish it first
        node.draining = False
        node.retired = False
        self._has_drains = any(n.draining or n.retired for n in self.nodes)
        node.restore()
        if self.policy.pre_created_contexts:
            for fn in self.functions.values():
                n = self.policy.pre_created_contexts
                while n > 1 and node.used + n * fn.ctx_bytes \
                        > 0.85 * node.capacity:
                    n -= 1
                node.dgsf_free[fn.name] = n
                node.dgsf_queue[fn.name] = []
                node.used += n * fn.ctx_bytes
        if self._control is not None:
            self._control.node_provisioned(node.name, self.clock.now())

    def _node_by_name(self, name: str) -> GPUNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise ValueError(f"unknown node {name!r} in fault plan")

    def _fault_nodes(self, name: Optional[str]) -> List[GPUNode]:
        return self.nodes if name is None else [self._node_by_name(name)]

    def _apply_fault(self, action: str, spec) -> None:
        """One scheduled fault event (EventKind.FAULT) firing."""
        if action == "crash":
            self._node_by_name(spec.node).crash()
        elif action == "restart":
            node = self._node_by_name(spec.node)
            node.restore()
            if self.policy.pre_created_contexts:
                # re-pin DGSF's permanent context pools, replaying the
                # same shrink-to-fit loop register() ran on the cold node
                for fn in self.functions.values():
                    n = self.policy.pre_created_contexts
                    while n > 1 and node.used + n * fn.ctx_bytes \
                            > 0.85 * node.capacity:
                        n -= 1
                    node.dgsf_free[fn.name] = n
                    node.dgsf_queue[fn.name] = []
                    node.used += n * fn.ctx_bytes
        elif action in ("degrade_on", "degrade_off"):
            for node in self._fault_nodes(spec.node):
                broker = node.db if spec.link == "db" else node.pcie
                if action == "degrade_on":
                    broker.apply_degradation(spec.factor)
                else:
                    broker.clear_degradation(spec.factor)
        elif action == "db_down":
            for node in self._fault_nodes(spec.node):
                node.db_down = True
        elif action == "db_up":
            for node in self._fault_nodes(spec.node):
                node.db_down = False
        elif action in ("slow_on", "slow_off"):
            # gray failure: the node stays healthy but everything on it
            # runs ``factor`` slower — kernels via slow_factor, transfers
            # via a symmetric degradation on both of its links
            node = self._node_by_name(spec.node)
            if action == "slow_on":
                node.slow_factor *= spec.factor
                node.db.apply_degradation(spec.factor)
                node.pcie.apply_degradation(spec.factor)
            else:
                node.slow_factor /= spec.factor
                node.db.clear_degradation(spec.factor)
                node.pcie.clear_degradation(spec.factor)
        elif action == "leak_on":
            node = self._node_by_name(spec.node)
            until = (spec.at_s + spec.duration_s
                     if spec.duration_s is not None else float("inf"))
            self._leak_tick(node, spec, until)
        elif action == "leak_off":
            self._node_by_name(spec.node).reclaim_leak()

    def _leak_tick(self, node, spec, until: float) -> None:
        """One MemoryLeak creep step: ``device_used`` rises with no owner
        every ``_LEAK_TICK_S`` while the window is open (a crash/teardown
        zeroes the leak and the healthy-check stops the chain)."""
        now = self.clock.now()
        if now >= until or not node.healthy or node.retired:
            return
        node.leak(int(spec.rate_bps * _LEAK_TICK_S))
        self.clock.schedule(_LEAK_TICK_S, self._leak_tick, node, spec,
                            until, kind=EventKind.FAULT)

    def resilience_stats(self) -> Dict[str, object]:
        """Control-layer counters (the sim twin of the runtime gateway's
        ``resilience_stats``)."""
        q = self._quarantine.stats() if self._quarantine is not None \
            else {"quarantines": 0, "readmits": 0}
        return {
            "shed": self.shed_count,
            "breaker_rejected": self.breaker_rejections,
            "node_lost": self.node_lost_count,
            "redispatches": self.redispatches,
            "node_crashes": sum(n.crashes for n in self.nodes),
            "node_drains": sum(1 for n in self.nodes
                               if n.draining or n.retired),
            "breaker_states": {f: b.state for f, b in self.breakers.items()},
            "hedges_launched": self.hedges_launched,
            "hedges_won": self.hedges_won,
            "hedges_wasted": self.hedges_wasted,
            "quarantines": q["quarantines"],
            "readmits": q["readmits"],
        }

    # ------------------------------------------------------------------
    def _fail_record(self, fn: SimFunction, rec: InvocationRecord,
                     reason: str, cls: str = "data_load") -> None:
        """Shared failure bookkeeping (the twin of ``Handle.wait()`` raising
        ``DataLoadError``): the invocation resolves with a typed error
        record instead of waiting forever. All policy paths go through
        here so the error-record format stays uniform. ``cls`` picks the
        error class/prefix (docs/resilience.md); admission-gate classes
        (shed/breaker) never feed the breaker window.

        Hedge-aware: a cancelled hedge loser (``cls == "hedged"``), or a
        twin that genuinely failed while its sibling is still live, is
        marked ``dropped`` — it never counts as a failure, never feeds the
        breaker, and ``slo_by_priority()``/``error_counts()`` skip it, so
        one logical request yields exactly one counted outcome."""
        dropped = cls == "hedged"
        if not dropped:
            pair = getattr(rec, "_hedge_pair", None)
            if pair is not None and not _rec_done(pair.twin(rec)):
                dropped = True  # the twin still carries the request
        if not dropped:
            self.failed += 1
        if rec.node_id:  # launched (a gate rejection never reached a node)
            self.inflight -= 1
        rec.dropped = dropped
        rec.error = f"{_ERROR_PREFIX.get(cls, 'DataLoadError')}: {fn.name}: {reason}"
        rec.error_class = cls
        rec.end_t = self.clock.now()
        self.telemetry.add(rec)
        if not dropped and self.breakers and cls not in ("shed", "breaker"):
            self._note_result(fn.name, False)

    # ------------------------------------------------------------------
    # thin wrappers kept for pre-refactor callers
    # ------------------------------------------------------------------
    def _finish(self, node, fn, rec, inst, release_bytes, extra_done=None):
        Completion(self, node, fn, rec, inst, release_bytes, extra_done)

    def _finish_with_cb(self, node, fn, rec, cb):
        CallbackCompletion(self, node, fn, rec, cb)

    # exit-ladder stage hooks shared by every SAGE instance on a node
    # (installed by sim.invocations.sage_instance)
    def _sage_demote(self, node, inst):
        if inst.has_ro_device:
            inst.has_ro_device = False
            inst.has_ro_host = True
            node.ro_state[inst.fn.name] = "host"
            node.touch_host(inst.fn.name)
            node.release(inst.fn.ro_bytes)

    def _sage_drop_ctx(self, node, inst):
        if inst.has_ctx:
            inst.has_ctx = False
            node.release(inst.fn.ctx_bytes)

    def _sage_drop_host(self, node, inst):
        inst.has_ro_host = False
        if node.ro_state[inst.fn.name] == "host":
            node.ro_state[inst.fn.name] = "none"
        if node.ro_state[inst.fn.name] == "none":
            node.drop_host_resident(inst.fn.name)

    # ------------------------------------------------------------------
    def mean_memory_bytes(self) -> float:
        """Cluster-total time-weighted mean device occupancy (streaming
        accumulators on each node — no sample list is retained)."""
        t_end = self.clock.now()
        total = 0.0
        for node in self.nodes:
            m = node.mean_memory_bytes(t_end)
            if m is not None:
                total += m
        return total


# ---------------------------------------------------------------------------
# deprecated aliases: the canonical trace generators moved to
# repro_torch.api.workload (imported lazily — repro_torch.api imports this module)
# ---------------------------------------------------------------------------


def poisson_arrivals(rate_per_s: float, duration_s: float,
                     rng: random.Random) -> List[float]:
    """Deprecated alias for :func:`repro_torch.api.workload.poisson_arrivals`."""
    warnings.warn(
        "repro_torch.core.simulator.poisson_arrivals moved to "
        "repro_torch.api.workload.poisson_arrivals",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api.workload import poisson_arrivals as _impl
    return _impl(rate_per_s, duration_s, rng)


def maf_like_trace(
    functions: List[str], duration_s: float, seed: int = 0,
    mean_rpm: float = 12.0,
) -> List[Tuple[float, str]]:
    """Deprecated alias for :func:`repro_torch.api.workload.maf_like_trace`."""
    warnings.warn(
        "repro_torch.core.simulator.maf_like_trace moved to "
        "repro_torch.api.workload.maf_like_trace",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api.workload import maf_like_trace as _impl
    return _impl(functions, duration_s, seed=seed, mean_rpm=mean_rpm)
