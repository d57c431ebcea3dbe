"""SageRuntime: the node-level serverless runtime (paper Fig 5).

``SageInit`` wires the four modules — per-function engines, taxon shim,
unified memory daemon, kernel executor — over a device; ``SageRun``
processes one invocation end-to-end. The same runtime object runs any
``SystemPolicy`` (SAGE or the baselines), which is how every benchmark
compares systems on identical mechanism code.

This is the *real* threaded runtime: context creation builds (once per
process) and loads the hand-written CUDA kernels, data movement is an
actual ``Tensor.to(device)`` (with the fair-share brokers modeling
A100-scale transfer times), compute is the actual model forward. The
virtual-time twin for trace-scale experiments is ``core.simulator``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from repro_torch.core.baselines import SystemPolicy, get_system
from repro_torch.core.clock import RealClock
from repro_torch.core.compute import (
    ThreadedComputePlane, empty_compute_stats, resolve_compute,
)
from repro_torch.core.daemon import SCHEDULERS, MemoryDaemon
from repro_torch.core.datapath import DataPaths
from repro_torch.core.placement import (
    DISPATCH_POLICIES, NodeSnapshot, PlacementControl, choose_node,
    resolve_autoscale,
)
from repro_torch.core.engine import FunctionEngine, GPUFunction
from repro_torch.core.executor import KernelExecutor
from repro_torch.core.request import Request
from repro_torch.core.telemetry import InvocationRecord, Telemetry, span
from repro_torch.data.database import Database


class SageRuntime:
    def __init__(
        self,
        policy: SystemPolicy | str = "sage",
        *,
        database: Optional[Database] = None,
        device_capacity: int = 40 << 30,
        host_capacity: int = 125 << 30,
        time_scale: float = 1.0,
        exit_ttl: float = 30.0,
        max_workers: int = 32,
        serialize_compute: bool = True,
        loader_threads: int = 4,
        load_timeout_s: float = 30.0,
        scheduler: str = "fifo",
        transfer: str = "run_to_completion",
        chunk_bytes: Optional[int] = None,
        node_id: str = "gpu0",
        compute=None,
        device: str = "cuda",
    ):
        self.policy = get_system(policy) if isinstance(policy, str) else policy
        self.node_id = node_id  # telemetry attribution (ClusterRuntime names)
        self.clock = RealClock()
        # the database owns the device: the daemon's loaders copy every
        # payload onto it (``Database.to_device``); "cuda" unless the caller
        # asks for the CPU, and never a silent fallback
        self.db = database or Database(device=device)
        self.paths = DataPaths.make(self.clock)
        self.daemon = MemoryDaemon(
            self.paths, self.db, device_capacity=device_capacity,
            host_capacity=host_capacity,
            clock=self.clock, time_scale=time_scale,
            loader_threads=loader_threads, load_timeout_s=load_timeout_s,
            # deadline-aware ("edf") or arrival-order ("fifo") load/admission
            # scheduling — consumed by the daemon's loader queue and OOM
            # admission wait (docs/dataplane.md)
            scheduler=scheduler,
            # chunked-stream transfer mode: "preemptive" lets an in-flight
            # loose load yield the link to a tighter queued one between
            # chunks; the default reproduces atomic run-to-completion
            # transfers (docs/dataplane.md, "Transfer scheduling")
            transfer=transfer,
            **({} if chunk_bytes is None else {"chunk_bytes": chunk_bytes}),
            # the bounded pool is SAGE's unified-daemon machinery; baseline
            # platforms load per-invocation (ungated), same as the sim twin
            pooled=self.policy.name.startswith("sage"),
        )
        self.executor = KernelExecutor(self.clock)
        self.telemetry = Telemetry()
        self.engines: Dict[str, FunctionEngine] = {}
        self.time_scale = time_scale
        self.exit_ttl = exit_ttl
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._compute_lock = threading.Lock() if serialize_compute else None
        # shared compute plane (docs/compute.md): when on, the whole-node
        # handler lock is replaced by the fractional slice budget (+
        # optional same-function batching). The handler wrapper consults
        # ``self._plane`` at CALL time, so set_compute() applies to
        # functions registered before it.
        self._compute = resolve_compute(compute)
        self._plane = (ThreadedComputePlane(self._compute, self.clock)
                       if self._compute is not None else None)
        self.daemon.set_evictable_provider(self._evictable)
        self._initialized = False
        # fault-injection health (docs/resilience.md): a crashed node
        # fast-fails everything with NodeLostError until restore()
        self.healthy = True
        self.crashes = 0
        # gray failure (docs/resilience.md, "Gray failures"): a SlowNode
        # window multiplies this node's service time — the engine leg is
        # stretched by a measured-dt sleep in sage_run, the transfer legs
        # by the gateway degrading both of this node's links. 1.0 (the
        # default) multiplies by exactly 1 and sleeps exactly 0.
        self.slow_factor = 1.0
        # dynamic node pool (docs/planner.md): a draining node takes no
        # new placements; once its in-flight work finishes it is retired
        # via the same teardown path a crash uses. ``_inflight`` counts
        # submitted-but-unfinished invocations (the drain idle check).
        self.draining = False
        self.retired = False
        self._inflight = 0

    # ------------------------------------------------------------------
    def _evictable(self):
        out = []
        for e in self.engines.values():
            out.extend(e.evictable_entries())
        return out

    # ------------------------------------------------------------------
    # public API (paper §4.2)
    # ------------------------------------------------------------------
    def sage_init(self) -> None:
        """Initialize the runtime (API parity with the paper's SageInit)."""
        self._initialized = True

    def register_function(self, fn: GPUFunction) -> None:
        fn = self._wrap_compute(fn)
        self.engines[fn.name] = FunctionEngine(
            fn, self.policy, self.daemon, self.executor, self.clock,
            time_scale=self.time_scale, exit_ttl=self.exit_ttl,
        )

    def _wrap_compute(self, fn: GPUFunction) -> GPUFunction:
        """One GPU: by default kernel executions serialize under the
        whole-node lock (matches Throughput_theo = 1/T_comp). With a
        shared compute plane attached (docs/compute.md) the handler runs
        under a fractional slice grant instead, optionally batched with
        concurrent same-function arrivals. The wrapper reads
        ``self._plane`` per call, so ``set_compute`` applies to functions
        registered before it; it wraps only the handler's compute. The
        wait for the lock (or the plane's grant) is the invocation's
        ``lock_wait`` span; the ``compute`` stage holds it, as the
        reference's does."""
        inner = fn.handler
        runtime = self

        def handler(shim, request):
            plane = runtime._plane
            if plane is not None:
                return plane.run(wrapped, inner, shim, request)
            lock = runtime._compute_lock
            if lock is not None:
                with span("lock_wait"):
                    lock.acquire()
                try:
                    return inner(shim, request)
                finally:
                    lock.release()
            return inner(shim, request)

        import dataclasses

        wrapped = dataclasses.replace(fn, handler=handler)
        return wrapped

    def sage_run(self, request: Request) -> Any:
        """Blocking invocation (the paper's SageRun)."""
        assert self._initialized, "call sage_init() first"
        if request.arrival_t is None:
            # stamp the request too (not only the record): EDF admission
            # derives the absolute deadline from arrival_t + deadline_s,
            # and an unstamped request would re-base it at every stage
            request.arrival_t = self.clock.now()
        eng = self.engines[request.function_name]
        rec = InvocationRecord(
            request_id=request.uuid, function=request.function_name,
            system=self.policy.name,
            # None-sentinel: an explicit arrival_t of 0.0 is a real arrival
            # time and must not be clobbered by the clock
            arrival_t=self.clock.now() if request.arrival_t is None
            else request.arrival_t,
            start_t=self.clock.now(),
            deadline_s=request.deadline_s, priority=request.priority,
            max_retries=request.max_retries,
            node_id=self.node_id, dispatch_tier=request.dispatch_tier,
            redispatches=request.redispatches,
        )
        try:
            # the spans the invocation takes go to its request id's list
            with self.telemetry.recording(request.uuid):
                result = eng.invoke(request, rec)
            if self.slow_factor > 1.0:
                # SlowNode gray failure: stretch the measured COMPUTE leg
                # (the load legs are already slowed by the fault's link
                # degradations; stretching wall elapsed instead would
                # multiply slot/admission queue waits too and feed back
                # into an unbounded backlog)
                extra = (rec.stages.get("compute", 0.0)
                         * (self.slow_factor - 1.0))
                self.clock.sleep(extra)
                # account the stretch where it was served — the per-node
                # latency profiler reads stage timings, not durations
                rec.stages["compute"] = rec.stages.get("compute", 0.0) + extra
            rec.result = result
            return result
        except Exception as exc:
            # data-plane/handler failure: record it (telemetry `error` field)
            # and re-raise so the caller's Future carries the exception —
            # the runtime pool thread is freed either way, never deadlocked
            rec.error = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            rec.end_t = self.clock.now()
            self.telemetry.add(rec)

    def submit(self, request: Request) -> Future:
        if request.arrival_t is None:
            request.arrival_t = self.clock.now()
        self._inflight += 1
        fut = self._pool.submit(self.sage_run, request)
        fut.add_done_callback(self._submit_done)
        return fut

    def _submit_done(self, _fut) -> None:
        self._inflight -= 1

    # ------------------------------------------------------------------
    # fault injection (docs/resilience.md)
    # ------------------------------------------------------------------
    def crash(self, reason: str = "node crashed") -> None:
        """Kill this node: every in-flight and future invocation fails
        with a typed :class:`~repro_torch.core.daemon.NodeLostError`, all
        instances are torn down, and device/host accounting rolls back to
        zero (the data-plane invariant tests assert the exact rollback).
        Idempotent; :meth:`restore` brings the node back cold."""
        if not self.healthy:
            return
        self.healthy = False
        self.crashes += 1
        # order matters: the daemon flips dead first so loads blocked in
        # admission/loader waits fail typed, then instance teardown
        # releases the exact context/slot/private bytes each engine holds
        self.daemon.crash(reason)
        for eng in self.engines.values():
            for inst in list(eng.instances):
                eng._destroy(inst)

    def restore(self) -> None:
        """Rejoin after a crash — cold: nothing resident, empty pool."""
        if self.healthy:
            return
        self.daemon.restore()
        self.healthy = True

    # ------------------------------------------------------------------
    # dynamic node pool: graceful drain (docs/planner.md)
    # ------------------------------------------------------------------
    def is_idle(self) -> bool:
        return self._inflight == 0

    def drain(self, timeout: float = 60.0) -> Dict[str, int]:
        """Retire this node gracefully: wait up to ``timeout`` seconds for
        its in-flight invocations to finish (their bookkeeping settles
        after the caller's futures resolve), then :meth:`drain_teardown`.
        Returns :meth:`memory_usage` after the teardown (all zeros). A node
        still busy after ``timeout`` raises ``TimeoutError`` and is left
        serving, untouched."""
        deadline = time.monotonic() + timeout
        while not self.is_idle() and time.monotonic() < deadline:
            time.sleep(0.01)
        if not self.is_idle():
            raise TimeoutError(f"drain: {self.node_id} still busy after {timeout} s")
        self.drain_teardown()
        return self.memory_usage()

    def drain_teardown(self) -> None:
        """Retire a drained node once idle: the SAME teardown a crash
        runs (daemon teardown + engine instance destroy — exact
        context/slot/byte release, docs/resilience.md), but graceful:
        nothing is in flight, so no invocation fails and the crash
        counters stay untouched."""
        if self.retired:
            return
        assert self.is_idle(), f"drain_teardown on busy node {self.node_id}"
        self.retired = True
        self.daemon.crash("node drained")
        for eng in self.engines.values():
            for inst in list(eng.instances):
                eng._destroy(inst)

    # ------------------------------------------------------------------
    @property
    def scheduler(self) -> str:
        return self.daemon.scheduler

    def set_scheduler(self, scheduler: str) -> None:
        """Switch loader/admission ordering ("fifo"|"edf"); applies to jobs
        and waiters enqueued after the call."""
        if scheduler not in SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {scheduler!r}; use one of {SCHEDULERS}")
        self.daemon.scheduler = scheduler

    @property
    def transfer(self) -> str:
        return self.daemon.transfer

    def set_transfer(self, transfer: str) -> None:
        """Switch the transfer mode ("run_to_completion"|"preemptive");
        applies to chunks advanced after the call."""
        self.daemon.set_transfer(transfer)

    def set_compute(self, compute) -> None:
        """Enable (or swap) the shared compute plane — the spec adoption
        path (docs/compute.md). Applies to handler calls entered after
        the call; ``"exclusive"``/None restores the whole-node lock."""
        self._compute = resolve_compute(compute)
        self._plane = (ThreadedComputePlane(self._compute, self.clock)
                       if self._compute is not None else None)

    def compute_stats(self) -> Dict[str, object]:
        """Compute-plane counters (key parity with the sim twin's
        ``compute_stats`` — docs/compute.md)."""
        if self._plane is None:
            return empty_compute_stats("exclusive", 0)
        return self._plane.stats()

    def dispatch_snapshot(self, function: str,
                          health_score: float = 1.0) -> NodeSnapshot:
        """This node's residency/pressure for ``function`` at dispatch
        time (docs/cluster.md): one cheap read per counter group, never
        blocking on in-flight loads. ``health_score`` carries the
        SlownessDetector's grade when slowness detection is on
        (docs/resilience.md) — the default 1.0 scores identically to the
        binary-health seed."""
        tier, ro_bytes = self.daemon.residency(function)
        return NodeSnapshot(node_id=self.node_id, ro_tier=tier,
                            ro_bytes=ro_bytes, healthy=self.healthy,
                            health_score=health_score,
                            compute_free_frac=(
                                self._plane.free_fraction()
                                if self._plane is not None else 1.0),
                            **self.daemon.pressure())

    def memory_usage(self) -> Dict[str, int]:
        return {
            "device_used": self.daemon.device_used,
            "context_bytes": self.daemon.context_bytes_used,
            "host_used": self.daemon.host_used,
        }

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
        self.daemon.shutdown()


# ---------------------------------------------------------------------------
# Cluster runtime: N nodes + pluggable dispatch (paper §7.8 ran "random";
# "locality"/"least_loaded" are the sharing-aware policies of docs/cluster.md)
# ---------------------------------------------------------------------------


class ClusterRuntime:
    """SAGE's node-level optimizations are orthogonal to cluster scheduling;
    ``dispatch="random"`` mirrors the paper's 4-node experiment bit-for-bit
    (same seeded stream as the seed repo), while ``"locality"`` routes each
    invocation to the node where its function's read-only data is already
    resident — spilling to the least-pressured cold node under load."""

    def __init__(self, n_nodes: int = 4, seed: int = 0,
                 dispatch: str = "random", eviction: bool = False,
                 autoscale=None, **node_kwargs):
        import random

        if dispatch not in DISPATCH_POLICIES:
            raise ValueError(
                f"unknown dispatch {dispatch!r}; use one of {DISPATCH_POLICIES}")
        self._node_kwargs = dict(node_kwargs)
        self.nodes = [SageRuntime(node_id=f"gpu{i}", **node_kwargs)
                      for i in range(n_nodes)]
        self._node_seq = n_nodes
        self._rng = random.Random(seed)
        self.dispatch = dispatch
        # health-checked eviction (docs/resilience.md): when on, dispatch
        # drains crashed nodes — off keeps the seeded stream bit-identical
        self.eviction = eviction
        # placement control plane (docs/planner.md); inert by default
        self.autoscale = resolve_autoscale(autoscale)
        self._control: Optional[PlacementControl] = None
        self._control_lock = threading.Lock()
        self._has_drains = False
        self._initialized = False
        self._make_fns: List = []  # for registering on autoscaled joiners
        self._fn_weights: Dict[str, int] = {}  # planner working-set bytes
        # gateway hook: called with the new node after add_node wires it
        # (the gateway lowers its registered specs onto the joiner there)
        self.on_node_added = None
        # gateway hook (docs/resilience.md): ``node_id -> float`` grading
        # from the gateway's SlownessDetector; None keeps the seed's
        # binary-health snapshots (health_score=1.0 scores identically)
        self.health_score = None
        if dispatch == "planned" or self.autoscale is not None:
            self._ensure_control()

    def sage_init(self):
        self._initialized = True
        for n in self.nodes:
            n.sage_init()

    def register_function(self, make_fn) -> None:
        """``make_fn(node_idx)`` builds a per-node GPUFunction (each node
        needs its own compiled context). Kept for the dynamic pool: a
        node added later replays every registered builder."""
        self._make_fns.append(make_fn)
        fns = [make_fn(i) for i in range(len(self.nodes))]
        for n, fn in zip(self.nodes, fns):
            n.register_function(fn)
        if fns:
            self.note_function(fns[0].name, fns[0].total_bytes())

    def note_function(self, name: str, weight_bytes: int) -> None:
        """Planner churn signal for a function registered directly on the
        nodes (the gateway's spec-lowering path bypasses
        :meth:`register_function`): the planner gives it a home using
        ``weight_bytes`` as its working-set size."""
        self._fn_weights[name] = int(weight_bytes)
        if self._control is not None:
            self._control.register_function(name, weight_bytes)

    def retire_function(self, fn_name: str) -> None:
        """Churn signal (docs/planner.md): the planner frees the
        function's planned share; resident state ages out via the exit
        ladders. The engines stay registered so in-flight work finishes."""
        self._fn_weights.pop(fn_name, None)
        if self._control is not None:
            self._control.retire_function(fn_name)

    def set_autoscale(self, autoscale) -> None:
        """Enable (or swap) predictive autoscaling mid-run — the spec
        adoption path (docs/planner.md)."""
        self.autoscale = resolve_autoscale(autoscale)
        with self._control_lock:
            if self.autoscale is None:
                if self._control is not None:
                    self._control.set_autoscale(None)
                return
            self._ensure_control()
            self._control.set_autoscale(self.autoscale)

    # ------------------------------------------------------------------
    # dynamic node pool (docs/planner.md)
    # ------------------------------------------------------------------
    def _now(self) -> float:
        return self.nodes[0].clock.now() if self.nodes else 0.0

    def _ensure_control(self) -> None:
        if self._control is not None:
            return
        self._control = PlacementControl(
            [n.node_id for n in self.nodes], autoscale=self.autoscale,
            now=self._now())
        for name, wb in self._fn_weights.items():
            self._control.register_function(name, wb)

    def add_node(self) -> SageRuntime:
        """Provision one cold node: every registered function builder is
        replayed onto it and dispatch may target it immediately."""
        node = SageRuntime(node_id=f"gpu{self._node_seq}",
                           **self._node_kwargs)
        self._node_seq += 1
        # a later set_compute carries over to joiners (same contract as
        # the sim's add_node re-reading scheduler/transfer from a live node)
        live = next((n for n in self.nodes if not n.retired), None)
        if live is not None and live._compute is not node._compute \
                and (live._compute is not None or node._compute is not None):
            node.set_compute(live._compute)
        idx = len(self.nodes)
        if self._initialized:
            node.sage_init()
        for make_fn in self._make_fns:
            node.register_function(make_fn(idx))
        self.nodes.append(node)
        if self._control is not None:
            self._control.node_provisioned(node.node_id, self._now())
        if self.on_node_added is not None:
            self.on_node_added(idx, node)
        return node

    def drain_node(self, node_id) -> None:
        """Start a graceful drain (``node_id``: name or index): no new
        placements; the node retires — exact teardown, same path as a
        crash — once its in-flight invocations finish."""
        node = (self.nodes[node_id] if isinstance(node_id, int)
                else next(n for n in self.nodes if n.node_id == node_id))
        if node.draining or node.retired:
            return
        node.draining = True
        self._has_drains = True
        if self._control is not None:
            self._control.node_draining(node.node_id)
        self._try_finalize_drains()

    def _try_finalize_drains(self) -> None:
        for node in self.nodes:
            if node.draining and not node.retired and node.is_idle():
                node.drain_teardown()
                if self._control is not None:
                    self._control.node_retired(node.node_id, self._now())

    def _maybe_tick(self) -> None:
        """The control tick, piggybacked on dispatch (same contract as
        the sim twin: ticks ride arrivals, so an idle cluster runs no
        control thread)."""
        add, drain_ids = self._control.maybe_tick(self._now())
        for _ in range(add):
            self.add_node()
        for nid in drain_ids:
            self.drain_node(nid)
        if self._has_drains:
            self._try_finalize_drains()

    def placement_stats(self) -> Optional[Dict]:
        """Planner/stealer/autoscaler counters + the node-count timeline
        (None unless the control plane is on — docs/planner.md)."""
        if self._control is None:
            return None
        with self._control_lock:
            if self._has_drains:
                self._try_finalize_drains()
            return self._control.stats(self._now())

    # ------------------------------------------------------------------
    def dispatchable_indices(self):
        """Node indices dispatch may target. Draining/retired nodes
        leave the candidate set; otherwise the full range unless eviction
        is on AND some node is down — so with everything at defaults the
        seeded random stream consumes the exact same
        ``randrange(len(nodes))`` call as the seed repo."""
        if self._has_drains:
            idxs = [i for i, n in enumerate(self.nodes)
                    if not (n.draining or n.retired)
                    and (n.healthy or not self.eviction)]
            return idxs if idxs else range(len(self.nodes))
        if not self.eviction:
            return range(len(self.nodes))
        idxs = [i for i, n in enumerate(self.nodes) if n.healthy]
        return idxs if idxs else range(len(self.nodes))

    def _snap(self, node: SageRuntime, function_name: str) -> NodeSnapshot:
        """One dispatch snapshot, graded by the gateway's slowness
        detector when attached (docs/resilience.md)."""
        hs = self.health_score
        if hs is None:
            return node.dispatch_snapshot(function_name)
        return node.dispatch_snapshot(function_name,
                                      health_score=hs(node.node_id))

    def _planned_pick(self, function_name: str):
        """Shared planner pick: ``(idx, tier, snaps_by_idx)`` — the SAME
        ``PlacementPlanner.pick`` the simulator calls."""
        idxs = list(self.dispatchable_indices())
        snaps = [self._snap(self.nodes[i], function_name)
                 for i in idxs]
        pick, _hit = self._control.planner.pick(function_name, snaps)
        return idxs[pick], snaps[pick].ro_tier, (idxs, snaps)

    def select_node(self, function_name: str):
        """Pick the target node for one invocation of ``function_name``;
        returns ``(node_idx, residency_tier_at_dispatch)``. ``"random"``
        consumes the same seeded stream as the original ``rng.choice``
        dispatch, so seeded §7.8 replays are unchanged."""
        if self.dispatch == "planned" or self._control is not None:
            with self._control_lock:
                self._ensure_control()
                self._control.note_arrival(function_name)
                self._maybe_tick()
                if self.dispatch == "planned":
                    idx, tier, _ = self._planned_pick(function_name)
                    return idx, tier
        idxs = self.dispatchable_indices()
        if self.dispatch == "random":
            if len(idxs) == len(self.nodes):
                idx = self._rng.randrange(len(self.nodes))
            else:
                idx = idxs[self._rng.randrange(len(idxs))]
            return idx, self.nodes[idx].daemon.residency(function_name)[0]
        snaps = {i: self._snap(self.nodes[i], function_name)
                 for i in idxs}
        order = list(snaps)
        pick = choose_node(self.dispatch, [snaps[i] for i in order])
        idx = order[pick]
        return idx, snaps[idx].ro_tier

    def submit(self, request: Request) -> Future:
        """Dispatch + submit. With ``dispatch="planned"`` this is also
        the work-stealer's runtime entry: an arrival whose planned home
        is above the steal watermark parks (queued-but-unstarted) and is
        re-routed with fresh snapshots after ``board_delay_s`` — landing
        away from the home is a steal and charges the request's
        ``max_retries`` redispatch budget, like a crash re-dispatch."""
        if self.dispatch == "planned" and self._control is not None:
            with self._control_lock:
                self._control.note_arrival(request.function_name)
                self._maybe_tick()
                idxs = list(self.dispatchable_indices())
                snaps = [self._snap(self.nodes[i], request.function_name)
                         for i in idxs]
                decision = self._control.route(request.function_name, snaps)
                if decision[0] == "board":
                    home_id = self.nodes[idxs[decision[1]]].node_id
                    outer: Future = Future()
                    timer = threading.Timer(
                        self._control.planner.cfg.board_delay_s,
                        self._board_fire, args=(request, home_id, outer))
                    timer.daemon = True
                    timer.start()
                    return outer
                idx = idxs[decision[1]]
                request.dispatch_tier = snaps[decision[1]].ro_tier
                return self.nodes[idx].submit(request)
        idx, tier = self.select_node(request.function_name)
        request.dispatch_tier = tier
        return self.nodes[idx].submit(request)

    def _board_fire(self, request: Request, home_id: str,
                    outer: Future) -> None:
        """Drain one boarded request: re-route with fresh snapshots and
        chain the inner future into the one the submitter already holds."""
        with self._control_lock:
            idxs = list(self.dispatchable_indices())
            snaps = [self._snap(self.nodes[i], request.function_name)
                     for i in idxs]
            budget = request.max_retries is None or request.max_retries > 0
            if budget:
                pick, stole = self._control.reroute(
                    request.function_name, snaps, home_id)
            else:
                pick = next((k for k, s in enumerate(snaps)
                             if s.node_id == home_id), None)
                stole = False
                if pick is None:  # home drained/evicted while boarded
                    pick, _ = self._control.reroute(
                        request.function_name, snaps, home_id)
            if stole:
                request.redispatches += 1
            request.dispatch_tier = snaps[pick].ro_tier
            inner = self.nodes[idxs[pick]].submit(request)

        def _chain(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                outer.set_exception(exc)
            else:
                outer.set_result(f.result())

        inner.add_done_callback(_chain)

    @property
    def scheduler(self) -> str:
        return self.nodes[0].scheduler

    def set_scheduler(self, scheduler: str) -> None:
        for n in self.nodes:
            n.set_scheduler(scheduler)

    def set_dispatch(self, dispatch: str) -> None:
        """Switch the dispatch policy; applies to subsequent submits."""
        if dispatch not in DISPATCH_POLICIES:
            raise ValueError(
                f"unknown dispatch {dispatch!r}; use one of {DISPATCH_POLICIES}")
        self.dispatch = dispatch

    @property
    def transfer(self) -> str:
        return self.nodes[0].transfer

    def set_transfer(self, transfer: str) -> None:
        for n in self.nodes:
            n.set_transfer(transfer)

    def set_compute(self, compute) -> None:
        for n in self.nodes:
            n.set_compute(compute)

    def compute_stats(self) -> Dict[str, object]:
        """Compute-plane counters aggregated over nodes (key parity with
        the sim's ``compute_stats`` — docs/compute.md)."""
        per_node = [n.compute_stats() for n in self.nodes]
        if not per_node or all(s["mode"] == "exclusive" for s in per_node):
            return empty_compute_stats("exclusive", 0)
        out = next(s for s in per_node if s["mode"] == "shared")
        out = dict(mode="shared", slices=out["slices"], grants=0,
                   contended_grants=0, batches=0, batched=0)
        for s in per_node:
            if s["mode"] != "shared":
                continue
            out["grants"] += s["grants"]
            out["contended_grants"] += s["contended_grants"]
            out["batches"] += s["batches"]
            out["batched"] += s["batched"]
        return out

    @property
    def telemetry(self) -> Telemetry:
        t = Telemetry()
        for n in self.nodes:
            # public snapshot(): consistent copy under the node's lock —
            # pool threads may still be add()ing while a caller merges
            for rec in n.telemetry.snapshot():
                t.add(rec)  # keeps the merged view's find() index populated
        return t

    def shutdown(self):
        for n in self.nodes:
            n.shutdown()
