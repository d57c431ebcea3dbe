"""Gateway: the single serving entry point over both drivers.

``Gateway(backend="runtime")`` wraps the real threaded ``SageRuntime``
(or a ``ClusterRuntime`` when ``n_nodes > 1``); ``backend="sim"`` wraps the
virtual-time ``Simulator`` twin. Registration takes a
:class:`~repro_torch.api.spec.FunctionSpec`, load comes from
``invoke``/``invoke_async``/``replay(workload)``, and ``report()`` returns
the one shared :class:`~repro_torch.core.telemetry.Telemetry` — so any workload
can be replayed against both backends and their records compared 1:1
(tests/test_torch_api.py holds that parity contract).

The mechanism layer stays importable and unchanged: ``gateway.runtime`` /
``gateway.sim`` expose the wrapped driver for tooling that needs to peek at
daemons, engines, or brokers.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.api.spec import FunctionSpec
from repro_torch.api.workload import Arrival, Workload
from repro_torch.core.dispatch import DISPATCH_POLICIES, choose_node
from repro_torch.core.faults import (
    BreakerConfig,
    BreakerOpenError,
    CircuitBreaker,
    DbFlap,
    FaultPlan,
    LinkDegradation,
    MemoryLeak,
    NodeCrash,
    NodeLostError,
    ShedError,
    SlowNode,
    classify_error,
    SheddingConfig,
    node_pressure,
)
from repro_torch.core.profiles import MB
from repro_torch.core.slowness import (
    QuarantineController,
    make_detector,
    resolve_hedging,
    resolve_quarantine,
)
from repro_torch.core.telemetry import InvocationRecord, Telemetry
from repro_torch.core.transfer import TRANSFER_MODES

DEFAULT_INPUT_BYTES = 4 * MB
# MemoryLeak tick granularity in workload seconds (sim twin parity:
# simulator._LEAK_TICK_S) — each tick injects rate_bps * tick bytes
_LEAK_TICK_S = 0.5
# per-invocation completion deadline for runtime-backend replay (the
# wall-clock analogue of the old hand-rolled future.result(timeout=...))
DEFAULT_REPLAY_TIMEOUT_S = 300.0

_BACKENDS = ("runtime", "sim")


class Invocation:
    """Handle for one in-flight invocation.

    ``wait()`` blocks (real time or virtual time) and returns the
    invocation's :class:`InvocationRecord`. With ``strict=True`` (default)
    a failed invocation raises instead; with ``strict=False`` the failure
    stays in ``record.error`` / ``Telemetry.errors()`` and the record is
    returned.
    """

    def wait(self, timeout: Optional[float] = None, *,
             strict: bool = True) -> InvocationRecord:
        raise NotImplementedError

    def result(self, timeout: Optional[float] = None, *,
               strict: bool = True) -> InvocationRecord:
        return self.wait(timeout, strict=strict)


class _RuntimeInvocation(Invocation):
    def __init__(self, node, future, request_uuid: str):
        self._node = node
        self._future = future
        self._uuid = request_uuid

    def wait(self, timeout=None, *, strict=True):
        exc: Optional[BaseException] = None
        try:
            self._future.result(timeout=timeout)
        except BaseException as e:  # recorded in telemetry either way
            exc = e
        rec = self._node.telemetry.find(self._uuid)
        if exc is not None and strict:
            raise exc
        if rec is None:
            # non-strict only swallows failures that produced a record
            # (a wait timeout has nothing to return)
            if exc is not None:
                raise exc
            raise RuntimeError(f"no record for invocation {self._uuid}")
        return rec


class _RejectedInvocation(Invocation):
    """Handle for a request the control layer refused before submission
    (shed or breaker-open). The rejection is already recorded; ``wait``
    returns instantly — strict mode raises the matching typed error."""

    def __init__(self, rec: InvocationRecord):
        self._rec = rec

    def wait(self, timeout=None, *, strict=True):
        if strict:
            exc = (ShedError if self._rec.error_class == "shed"
                   else BreakerOpenError)
            raise exc(self._rec.error)
        return self._rec


class _ResilientInvocation(Invocation):
    """Runtime handle with the resilience control loop attached: feeds the
    function's circuit breaker with the final outcome and — when eviction
    is on — re-dispatches a :class:`NodeLostError` failure to a healthy
    node within the request's ``max_retries`` budget (None = unlimited
    while healthy nodes remain, 0 = fail fast). Superseded attempts'
    records are marked ``dropped`` so merged telemetry counts ONE outcome
    per request with exact accounting (docs/resilience.md)."""

    def __init__(self, gw: "Gateway", name: str, node_idx: int, req,
                 future, *, seed: int, input_bytes: int):
        self._gw = gw
        self._name = name
        self._node_idx = node_idx
        self._req = req
        self._seed = seed
        self._input_bytes = input_bytes
        self._redispatches = 0
        self._done = threading.Event()
        self._rec: Optional[InvocationRecord] = None
        self._exc: Optional[BaseException] = None
        # hedged redispatch state (docs/resilience.md): at most one
        # speculative twin per logical request; first completion wins
        self._hlock = threading.Lock()
        self._settled = False
        self._pending = {req.uuid}
        self._hedge: Optional[Tuple[int, object, float]] = None
        self._hedge_timer: Optional[threading.Timer] = None
        self._t_start = time.monotonic()
        future.add_done_callback(
            lambda f: self._on_done(f, node_idx, req, False))
        self._arm_hedge()

    # -- hedged redispatch ---------------------------------------------
    def _arm_hedge(self) -> None:
        """Start the hedge timer at the function's learned latency
        quantile; no-op until the detector has enough samples."""
        gw = self._gw
        if gw._hedging is None or gw._slowness is None \
                or not gw.policy.startswith("sage"):
            return
        with gw._tail_lock:
            est = gw._slowness.estimate(self._name, gw._hedging.min_samples)
        if est is None:
            return
        tm = threading.Timer(est * gw._hedging.delay_factor,
                             self._hedge_fire)
        tm.daemon = True
        self._hedge_timer = tm
        tm.start()

    def _hedge_fire(self) -> None:
        """The invocation outlived its latency estimate: launch ONE
        speculative duplicate on the best non-suspect node (charged to
        the request's ``max_retries`` budget, like a crash re-dispatch)."""
        gw = self._gw
        with self._hlock:
            if self._settled or self._hedge is not None:
                return
            budget = self._req.max_retries
            if budget is not None and self._redispatches >= budget:
                return
        with gw._tail_lock:
            suspects = set(gw._slowness.suspects())
            scores = {n.node_id: gw._slowness.health_score(n.node_id)
                      for n in gw._nodes}
        primary_id = gw._nodes[self._node_idx].node_id
        cands = [i for i, n in enumerate(gw._nodes)
                 if n.healthy and not (n.draining or n.retired)
                 and n.node_id != primary_id
                 and n.node_id not in suspects]
        if not cands:
            return
        snaps = [gw._nodes[i].dispatch_snapshot(
            self._name, health_score=scores[gw._nodes[i].node_id])
            for i in cands]
        pick = choose_node("locality", snaps)
        idx = cands[pick]
        req2 = gw._build_request(
            self._name, idx, seed=self._seed, input_bytes=self._input_bytes,
            deadline_s=self._req.deadline_s, priority=self._req.priority,
            max_retries=self._req.max_retries,
            dispatch_tier=snaps[pick].ro_tier)
        req2.arrival_t = self._req.arrival_t  # same logical arrival
        with self._hlock:
            if self._settled:
                return
            self._redispatches += 1
            req2.redispatches = self._redispatches
            # cooperative cancel tokens for BOTH twins: whichever loses
            # aborts at its next engine checkpoint and unwinds byte-exactly
            self._req.hedge_cancel = threading.Event()
            req2.hedge_cancel = threading.Event()
            self._hedge = (idx, req2, time.monotonic())
            self._pending.add(req2.uuid)
        try:
            fut = gw._nodes[idx].submit(req2)
        except RuntimeError:
            # the timer raced a pool shutdown: unwind — the primary
            # remains the request's only attempt
            with self._hlock:
                self._pending.discard(req2.uuid)
                self._hedge = None
                self._redispatches -= 1
            return
        gw._redispatches += 1
        with gw._tail_lock:
            gw._hedges_launched += 1
        fut.add_done_callback(
            lambda f: self._on_done(f, idx, req2, True))

    # -- control loop (runs on the pool thread that finished the attempt)
    def _on_done(self, future, node_idx: int, req, is_hedge: bool) -> None:
        gw = self._gw
        exc = future.exception()
        rec = gw._nodes[node_idx].telemetry.find(req.uuid)
        with self._hlock:
            self._pending.discard(req.uuid)
            paired = self._hedge is not None
            if paired:
                if self._settled:
                    win = False          # the race was already decided
                elif exc is None or not self._pending:
                    # success — or the last twin standing (even a failure
                    # is the request's one outcome once its twin is gone)
                    self._settled = True
                    win = True
                else:
                    win = False          # failed while the twin still runs
        if paired:
            if win:
                self._win(rec, exc, node_idx, req, is_hedge)
            else:
                self._drop_loser(rec, exc)
            return
        # -- unpaired: the seed crash-re-dispatch control loop ----------
        if isinstance(exc, NodeLostError) and gw._evict:
            budget = self._req.max_retries
            healthy = [i for i, n in enumerate(gw._nodes)
                       if n.healthy and not (n.draining or n.retired)]
            if healthy and (budget is None or self._redispatches < budget):
                # supersede this attempt's record — the re-dispatch is the
                # same logical request, not a second outcome
                if rec is not None:
                    rec.dropped = True
                self._redispatches += 1
                gw._redispatches += 1
                try:
                    self._resubmit(healthy)
                    return
                except Exception as e:  # re-dispatch itself failed
                    exc, rec = e, rec if rec is not None else None
        self._finalize(rec, exc)

    def _win(self, rec, exc, node_idx: int, req, is_hedge: bool) -> None:
        """This attempt decides the request: cancel the loser twin, feed
        its censored elapsed time to the detector (a cancelled straggler
        never completes — without this the evidence starves), count the
        hedge outcome, and finalize."""
        gw = self._gw
        if self._hedge_timer is not None:
            self._hedge_timer.cancel()
        with self._hlock:
            loser_alive = bool(self._pending)
        if loser_alive:
            if is_hedge:
                lidx, lreq, lt0 = self._node_idx, self._req, self._t_start
            else:
                lidx, lreq, lt0 = self._hedge
            if lreq.hedge_cancel is not None:
                lreq.hedge_cancel.set()
            loser_node = gw._nodes[lidx]
            elapsed = time.monotonic() - lt0
            with gw._tail_lock:
                gw._slowness.observe(loser_node.node_id, "compute", elapsed)
            gw._quarantine_note(loser_node.node_id, elapsed)
        if exc is None:
            with gw._tail_lock:
                if is_hedge:
                    gw._hedges_won += 1
                else:
                    gw._hedges_wasted += 1
        self._node_idx, self._req = node_idx, req
        self._finalize(rec, exc)

    def _drop_loser(self, rec, exc) -> None:
        """A superseded twin landed (cancelled at a checkpoint, failed,
        or finished late): mark its record dropped/"hedged" — never a
        second outcome, never a breaker feed (sim parity)."""
        if rec is not None:
            rec.dropped = True
            rec.redispatches = self._redispatches
            if rec.error is None:
                rec.error = (f"HedgedError: {self._name}: "
                             "superseded by hedged twin")
            if rec.error_class is None:
                rec.error_class = (
                    "hedged" if rec.error.startswith("HedgedError")
                    else classify_error(rec.error))
        if isinstance(exc, NodeLostError):
            self._gw._node_lost += 1

    def _resubmit(self, healthy: List[int]) -> None:
        gw, name = self._gw, self._name
        if len(healthy) == len(gw._nodes):
            idx, tier = gw._pick_node(name)
        elif gw.runtime is not None and hasattr(gw.runtime, "select_node"):
            idx, tier = gw.runtime.select_node(name)
        else:
            idx, tier = healthy[0], None
        req = gw._build_request(
            name, idx, seed=self._seed, input_bytes=self._input_bytes,
            deadline_s=self._req.deadline_s, priority=self._req.priority,
            max_retries=self._req.max_retries, dispatch_tier=tier)
        # the logical arrival time spans attempts: latency is measured
        # arrival-to-final-finish, like the simulator's re-dispatch path
        req.arrival_t = self._req.arrival_t
        req.fault_injected = False  # the draw was consumed by attempt #1
        self._node_idx, self._req = idx, req
        with self._hlock:
            self._pending.add(req.uuid)
        gw._nodes[idx].submit(req).add_done_callback(
            lambda f: self._on_done(f, idx, req, False))

    def _finalize(self, rec, exc) -> None:
        with self._hlock:
            # the race is decided on EVERY path (an unpaired completion
            # included) — a hedge timer that fires later must see settled
            # and stand down instead of hedging a finished request
            self._settled = True
        if self._hedge_timer is not None:
            self._hedge_timer.cancel()
        if rec is not None:
            rec.redispatches = self._redispatches
            if rec.error_class is None and rec.error is not None:
                # stamp the class like the sim driver does, so per-record
                # consumers need no classify_error fallback
                rec.error_class = classify_error(rec.error)
        if exc is None and rec is not None and self._gw._slowness is not None:
            # detector feed (the sim's _tail_complete call site): one
            # successful outcome per request grades its node
            self._gw._tail_observe(
                self._gw._nodes[self._node_idx].node_id, rec)
        self._gw._note_result(self._name, exc is None)
        if isinstance(exc, NodeLostError):
            self._gw._node_lost += 1
        self._rec, self._exc = rec, exc
        self._done.set()

    # -- Invocation interface ------------------------------------------
    def wait(self, timeout=None, *, strict=True):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"invocation {self._req.uuid} still in flight")
        if self._exc is not None and strict:
            raise self._exc
        if self._rec is None:
            if self._exc is not None:
                raise self._exc
            raise RuntimeError(f"no record for invocation {self._req.uuid}")
        return self._rec


class _SimInvocation(Invocation):
    def __init__(self, sim, request_id: str):
        self._sim = sim
        self._rid = request_id

    def wait(self, timeout=None, *, strict=True):
        # ``timeout`` is accepted for interface parity; virtual time drains
        # instantly, so there is nothing wall-clock to bound here
        rec = self._sim.telemetry.find(self._rid)
        if rec is None:
            self._sim.run()  # drain virtual time
            rec = self._sim.telemetry.find(self._rid)
        if rec is None:
            raise RuntimeError(
                f"simulated invocation {self._rid} never completed")
        if strict and rec.error is not None:
            # control-layer rejections raise the same typed errors the
            # runtime backend raises (tests assert on the type)
            exc = {"shed": ShedError,
                   "breaker": BreakerOpenError}.get(rec.error_class,
                                                    RuntimeError)
            raise exc(rec.error)
        return rec


class Gateway:
    """One serving API over the real runtime and the simulator twin.

    ``device`` is where the runtime backend's nodes keep their data and run
    their forwards: ``"cuda"`` unless the caller asks for the CPU, and
    without CUDA a runtime gateway raises rather than fall back. Autoscaled
    joiners get the same device. The sim backend ignores it."""

    def __init__(self, backend: str = "sim", policy: str = "sage", *,
                 n_nodes: int = 1, device_capacity: int = 40 << 30,
                 host_capacity: int = 125 << 30,
                 exit_ttl: float = 30.0, seed: int = 0,
                 time_scale: float = 1.0, loader_threads: int = 4,
                 load_timeout_s: Optional[float] = None,
                 max_workers: int = 32, serialize_compute: bool = True,
                 scheduler: Optional[str] = None,
                 dispatch: Optional[str] = None,
                 transfer: Optional[str] = None,
                 chunk_bytes: Optional[int] = None,
                 faults: Optional[FaultPlan] = None,
                 breaker: Optional[BreakerConfig] = None,
                 shedding: Optional[SheddingConfig] = None,
                 eviction: bool = False,
                 autoscale=None,
                 hedging=None,
                 quarantine=None,
                 compute=None,
                 device: str = "cuda"):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use one of {_BACKENDS}")
        self.backend = backend
        self.policy = policy
        self.specs: Dict[str, FunctionSpec] = {}
        self._seq = itertools.count()
        self.sim = None
        self.runtime = None
        # resilience layer (docs/resilience.md): the sim backend owns its
        # own copy of these knobs; the runtime backend gates at the gateway
        # so the control decisions sit in front of node dispatch on BOTH
        # drivers, in the same order (draw -> shed -> breaker -> dispatch)
        self.faults = faults
        self._fault_draws = faults.make_draws() if faults is not None else None
        self.shedding = shedding
        self._evict = eviction
        self._breaker_cfg = breaker
        self._breaker_overrides: Dict[str, BreakerConfig] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._rejected: List[InvocationRecord] = []
        self._reject_lock = threading.Lock()
        self._shed = 0
        self._breaker_rejected = 0
        self._node_lost = 0
        self._redispatches = 0
        self._t0 = time.monotonic()  # loader-fault draw clock for invoke()
        # gray-failure tail tolerance (docs/resilience.md): the sim backend
        # owns its own detector; the runtime backend's lives here, fed by
        # the resilient handles' completion callbacks
        self._hedging_source = None if hedging is None else "constructor"
        self.hedging = resolve_hedging(hedging)
        self._quarantine_source = None if quarantine is None else "constructor"
        self.quarantine = resolve_quarantine(quarantine)
        self._hedging = None        # applied runtime-backend configs
        self._quarantine_cfg = None
        self._slowness = None
        self._quarantine: Optional[QuarantineController] = None
        self._hedges_launched = 0
        self._hedges_won = 0
        self._hedges_wasted = 0
        self._tail_lock = threading.Lock()
        self._fault_pace = 1.0      # replay() pace, for leak/probe timers
        self._leak_stops: Dict[str, threading.Event] = {}
        # loader/admission scheduling ("fifo"|"edf"). None = default "fifo"
        # but adoptable: the first registered spec that declares a scheduler
        # switches the gateway (an explicit constructor choice is not
        # overridable — a conflicting spec raises at register()).
        self._scheduler_source = None if scheduler is None else "constructor"
        self.scheduler = scheduler or "fifo"
        # cluster dispatch ("random"|"locality"|"least_loaded"), same
        # adopt/conflict semantics as the scheduler knob (docs/cluster.md).
        # Stored even for single-node backends so a later spec conflict is
        # still surfaced consistently.
        self._dispatch_source = None if dispatch is None else "constructor"
        self.dispatch = dispatch or "random"
        if self.dispatch not in DISPATCH_POLICIES:
            raise ValueError(
                f"unknown dispatch {self.dispatch!r}; "
                f"use one of {DISPATCH_POLICIES}")
        # transfer scheduling ("run_to_completion"|"preemptive"), same
        # adopt/conflict semantics as the scheduler knob (docs/dataplane.md)
        self._transfer_source = None if transfer is None else "constructor"
        self.transfer = transfer or "run_to_completion"
        if self.transfer not in TRANSFER_MODES:
            raise ValueError(
                f"unknown transfer mode {self.transfer!r}; "
                f"use one of {TRANSFER_MODES}")
        # predictive autoscaling over a dynamic node pool (docs/planner.md);
        # None keeps the pool static. Same adopt/conflict semantics as the
        # other knobs (an AutoscaleConfig is frozen, so equality is exact).
        from repro_torch.core.placement import resolve_autoscale

        self._autoscale_source = None if autoscale is None else "constructor"
        self.autoscale = resolve_autoscale(autoscale)
        # shared GPU compute plane (docs/compute.md): fractional SM slicing
        # + same-function batching. None keeps the seed's exclusive compute
        # FIFO on both backends; same adopt/conflict semantics as the
        # other knobs (a ComputeConfig is frozen, so equality is exact).
        from repro_torch.core.compute import resolve_compute

        self._compute_source = None if compute is None else "constructor"
        self.compute = resolve_compute(compute)
        if backend == "sim":
            from repro_torch.core.simulator import Simulator

            self.sim = Simulator(
                policy, n_nodes=n_nodes, capacity=device_capacity,
                host_capacity=host_capacity,
                exit_ttl=exit_ttl, seed=seed, loader_threads=loader_threads,
                # backend-native deadline defaults: 600 virtual s (sim)
                load_timeout_s=600.0 if load_timeout_s is None else load_timeout_s,
                scheduler=self.scheduler, dispatch=self.dispatch,
                transfer=self.transfer,
                faults=faults, breaker=breaker, shedding=shedding,
                eviction=eviction, autoscale=self.autoscale,
                hedging=self.hedging, quarantine=self.quarantine,
                compute=self.compute,
                **({} if chunk_bytes is None else {"chunk_bytes": chunk_bytes}),
            )
            self._nodes: List = []
        else:
            from repro_torch.core.runtime import ClusterRuntime, SageRuntime

            kw = dict(
                policy=policy, device_capacity=device_capacity,
                host_capacity=host_capacity,
                time_scale=time_scale, exit_ttl=exit_ttl,
                loader_threads=loader_threads,
                load_timeout_s=30.0 if load_timeout_s is None else load_timeout_s,
                max_workers=max_workers, serialize_compute=serialize_compute,
                scheduler=self.scheduler, transfer=self.transfer,
                chunk_bytes=chunk_bytes, compute=self.compute,
                device=device,
            )
            if n_nodes == 1 and self.autoscale is None:
                self.runtime = SageRuntime(**kw)
                self._nodes = [self.runtime]
            else:
                self.runtime = ClusterRuntime(n_nodes=n_nodes, seed=seed,
                                              dispatch=self.dispatch,
                                              eviction=eviction,
                                              autoscale=self.autoscale, **kw)
                self._nodes = list(self.runtime.nodes)
                # dynamic pool: lower every registered spec onto a joiner
                # before dispatch can target it (docs/planner.md)
                self.runtime.on_node_added = self._on_node_added
            self.runtime.sage_init()
            self._fns: Dict[str, List] = {}  # name -> GPUFunction per node
            self._sync_tail_layer()

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    # knobs a spec may declare and a gateway adopts/refuses uniformly
    # ("scheduler": loader/admission ordering; "dispatch": cluster routing;
    # "transfer": run-to-completion vs preemptible chunked streams;
    # "autoscale": predictive node-pool scaling — docs/planner.md;
    # "hedging"/"quarantine": gray-failure tail tolerance —
    # docs/resilience.md)
    # "compute": shared SM slicing + same-function batching —
    # docs/compute.md
    _SPEC_KNOBS = ("scheduler", "dispatch", "transfer", "autoscale",
                   "hedging", "quarantine", "compute")

    def _on_node_added(self, idx: int, node) -> None:
        """ClusterRuntime hook: a node joined the pool (autoscaler or
        explicit ``add_node``). Lower every registered spec onto it —
        each node compiles its own context — before it enters
        ``_nodes``/``_fns`` indexing."""
        for name, spec in self.specs.items():
            fn = spec.to_gpu_function(node.db)
            node.register_function(fn)
            self._fns[name].append(fn)
        self._nodes.append(node)

    def _check_knob(self, spec: FunctionSpec, knob: str) -> None:
        """Raise if the spec's declared ``knob`` value conflicts with a
        pinned gateway (constructor choice or an earlier registered spec)."""
        declared = getattr(spec, knob)
        if (declared is not None and declared != getattr(self, knob)
                and getattr(self, f"_{knob}_source") is not None):
            raise ValueError(
                f"spec {spec.name!r} declares {knob}={declared!r} "
                f"but this gateway runs {getattr(self, knob)!r} "
                f"(set by {getattr(self, f'_{knob}_source')})")

    def _adopt_knob(self, spec: FunctionSpec, knob: str) -> None:
        """A spec may declare the configuration it was validated under. An
        undecided gateway adopts it; conflicts were rejected by
        :meth:`_check_knob` before the backend registration ran. The value
        is applied through the backend's ``set_<knob>`` when it has one (a
        single-node runtime has no dispatch to switch — the knob is still
        recorded so later conflicting specs are refused)."""
        declared = getattr(spec, knob)
        if declared is None:
            return
        if declared == getattr(self, knob):
            if getattr(self, f"_{knob}_source") is None:
                setattr(self, f"_{knob}_source", f"spec {spec.name!r}")
            return
        setattr(self, knob, declared)
        setattr(self, f"_{knob}_source", f"spec {spec.name!r}")
        target = self.sim if self.sim is not None else self.runtime
        setter = getattr(target, f"set_{knob}", None)
        if setter is not None:
            setter(declared)

    def register(self, spec: FunctionSpec) -> None:
        if spec.name in self.specs:
            raise ValueError(f"function {spec.name!r} already registered")
        # knob conflicts must surface before any backend state changes
        for knob in self._SPEC_KNOBS:
            self._check_knob(spec, knob)
        if self.sim is not None:
            self.sim.register(spec.to_sim_function())
        else:
            fns = []
            for node in self._nodes:  # each node compiles its own context
                fn = spec.to_gpu_function(node.db)
                node.register_function(fn)
                fns.append(fn)
            self._fns[spec.name] = fns
            # planner churn signal (docs/planner.md): the cluster's control
            # plane needs the function's working-set bytes to give it a home
            nf = getattr(self.runtime, "note_function", None)
            if nf is not None:
                nf(spec.name, fns[0].total_bytes())
        # adopt/record only once the backend registration succeeded: a spec
        # that failed to lower must not pin the gateway's knobs
        for knob in self._SPEC_KNOBS:
            self._adopt_knob(spec, knob)
        if self.sim is None:
            # a spec-adopted hedging/quarantine knob lands on the gateway's
            # own layer (the sim twin applied it through set_hedging/
            # set_quarantine inside _adopt_knob)
            self._sync_tail_layer()
        if spec.breaker is not None:
            # per-function breaker override beats the gateway-wide config
            if self.sim is not None:
                self.sim.set_function_breaker(spec.name, spec.breaker)
            else:
                self._breaker_overrides[spec.name] = spec.breaker
        self.specs[spec.name] = spec

    # ------------------------------------------------------------------
    # resilience control (runtime backend; the sim gates inside Simulator)
    # ------------------------------------------------------------------
    def _breaker_for(self, name: str) -> Optional[CircuitBreaker]:
        br = self._breakers.get(name)
        if br is None:
            cfg = self._breaker_overrides.get(name, self._breaker_cfg)
            if cfg is None:
                return None
            br = self._breakers[name] = CircuitBreaker(cfg, time.monotonic)
        return br

    def _note_result(self, name: str, ok: bool) -> None:
        br = self._breakers.get(name)
        if br is not None:
            br.record(ok)

    def _shed_pressure(self) -> float:
        """Mean normalized loader pressure over healthy nodes (the same
        :func:`~repro_torch.core.faults.node_pressure` formula the sim uses)."""
        vals = []
        for n in self._nodes:
            if not n.healthy or n.retired:
                continue
            p = n.daemon.pressure()
            vals.append(node_pressure(
                p["pending_admissions"], p["loader_queue"],
                p["loader_threads"], self.shedding.saturation))
        return sum(vals) / len(vals) if vals else 1.0

    def _reject(self, name: str, t: float, deadline_s, priority,
                cls: str, reason: str) -> InvocationRecord:
        """Record a pre-dispatch rejection (shed / breaker-open). The
        record joins ``report()`` so goodput and error_counts() see one
        outcome per request on both drivers."""
        prefix = "ShedError" if cls == "shed" else "BreakerOpenError"
        rec = InvocationRecord(
            request_id=f"gw-{next(self._seq)}-{name}", function=name,
            system=self.policy, arrival_t=t, start_t=t, end_t=t,
            deadline_s=deadline_s, priority=priority,
            error=f"{prefix}: {name}: {reason}", error_class=cls)
        with self._reject_lock:
            self._rejected.append(rec)
            if cls == "shed":
                self._shed += 1
            else:
                self._breaker_rejected += 1
        return rec

    def _gate(self, name: str, t: float, deadline_s, priority):
        """Run the admission gates for one runtime-backend arrival in the
        cross-driver order: loader-fault draw first (the stream advances
        even for rejected requests), then the LoaderJitter draw (its own
        seeded stream — sim ``_arrive`` parity), then shedding, then the
        breaker (last among the gates — ``allow()`` claims a half-open
        probe slot, and a later rejection would leak it). Returns
        ``(injected, jitter_s, rejection)`` where ``rejection`` is a
        record when a gate refused the request."""
        injected = (self._fault_draws.draw(name, t)
                    if self._fault_draws is not None else False)
        jitter_s = (self._fault_draws.jitter(name, t)
                    if self._fault_draws is not None else 0.0)
        if self.shedding is not None:
            p = self._shed_pressure()
            if self.shedding.should_shed(p, priority):
                return injected, jitter_s, self._reject(
                    name, t, deadline_s, priority,
                    "shed", f"shed at pressure {p:.2f}")
        br = self._breaker_for(name)
        if br is not None and not br.allow():
            return injected, jitter_s, self._reject(
                name, t, deadline_s, priority, "breaker", "circuit open")
        return injected, jitter_s, None

    def _resilience_on(self) -> bool:
        """True when runtime invocations need the control-loop handle
        (breaker outcome feed, crash re-dispatch, node-lost counters,
        slowness-detector feed / hedge timers)."""
        return (self._evict or self.faults is not None
                or self._breaker_cfg is not None
                or bool(self._breaker_overrides)
                or self._slowness is not None)

    # -- gray-failure tail tolerance (docs/resilience.md) --------------
    def _sync_tail_layer(self) -> None:
        """(Re)build the runtime backend's slowness layer from the current
        ``hedging``/``quarantine`` knobs (constructor or spec-adopted).
        No-op when nothing changed; the sim backend owns its own copy."""
        if self.sim is not None:
            return
        if (self.hedging == self._hedging
                and self.quarantine == self._quarantine_cfg
                and (self._slowness is not None
                     or (self.hedging is None and self.quarantine is None))):
            return
        self._hedging = self.hedging
        self._quarantine_cfg = self.quarantine
        if self.hedging is None and self.quarantine is None:
            self._slowness = None
            self._quarantine = None
            if hasattr(self.runtime, "health_score"):
                self.runtime.health_score = None
            return
        self._slowness = make_detector(self.hedging, self.quarantine)
        self._quarantine = (
            QuarantineController(self.quarantine, self._slowness)
            if self.quarantine is not None else None)
        if hasattr(self.runtime, "health_score"):
            det, lock = self._slowness, self._tail_lock

            def _score(node_id: str) -> float:
                with lock:
                    return det.health_score(node_id)

            self.runtime.health_score = _score

    def _wl_now(self) -> float:
        """Workload-time clock for the quarantine controller: wall seconds
        since the gateway started, un-scaled by the replay pace, so the
        controller's cooldowns mean the same seconds on both drivers."""
        return (time.monotonic() - self._t0) / self._fault_pace

    def _tail_observe(self, node_id: str, rec: InvocationRecord) -> None:
        """Feed one successful completion to the detector + quarantine
        machine (the runtime image of the sim's ``_tail_complete``)."""
        sl = self._slowness
        if sl is None or rec is None:
            return
        with self._tail_lock:
            sl.observe_record(node_id, rec.function, rec.stages,
                              rec.duration)
        self._quarantine_note(node_id, rec.stages.get("compute", 0.0))

    def _quarantine_note(self, node_id: str, compute_s: float) -> None:
        q = self._quarantine
        if q is None:
            return
        node = next((n for n in self._nodes if n.node_id == node_id), None)
        if node is None or node.draining or node.retired:
            return
        with self._tail_lock:
            action = q.note_completion(node_id, self._wl_now(), compute_s)
        if action in ("quarantine", "retire") \
                and hasattr(self.runtime, "drain_node"):
            self.runtime.drain_node(node_id)
        if action == "quarantine":
            self._schedule_probe()

    def _schedule_probe(self) -> None:
        with self._tail_lock:
            at = self._quarantine.next_probe_at()
        if at is None:
            return
        delay = max(0.0, (at - self._wl_now()) * self._fault_pace)
        tm = threading.Timer(delay, self._probe_fire)
        tm.daemon = True
        tm.start()

    def _probe_fire(self) -> None:
        q = self._quarantine
        if q is None:
            return
        with self._tail_lock:
            due = q.due_probes(self._wl_now())
        for node_id in due:
            self._readmit_node(node_id)
        self._schedule_probe()

    def _readmit_node(self, node_id: str) -> None:
        """Half-open readmission: bring a quarantined node back into the
        dispatch set cold (probation — its next completions are the
        canaries the controller judges)."""
        node = next((n for n in self._nodes if n.node_id == node_id), None)
        if node is None:
            return
        rt = self.runtime
        if node.draining and not node.retired and node.is_idle():
            # finalize the pending drain so readmission starts from the
            # same cold, byte-exact state a finished drain leaves
            node.drain_teardown()
            if getattr(rt, "_control", None) is not None:
                rt._control.node_retired(node.node_id, rt._now())
        if node.daemon.dead:
            node.daemon.restore()
        node.healthy = True
        node.draining = False
        node.retired = False
        if hasattr(rt, "nodes"):
            rt._has_drains = any(n.draining or n.retired for n in rt.nodes)
            if rt._control is not None:
                rt._control.node_provisioned(node.node_id, rt._now())

    # -- MemoryLeak gray failure (runtime image of sim._leak_tick) -----
    def _start_leak(self, node, spec) -> None:
        stop = threading.Event()
        self._leak_stops[node.node_id] = stop
        self._leak_tick(node, spec, stop)

    def _leak_tick(self, node, spec, stop: threading.Event) -> None:
        if stop.is_set() or not node.healthy or node.retired:
            return
        node.daemon.inject_leak(int(spec.rate_bps * _LEAK_TICK_S))
        tm = threading.Timer(_LEAK_TICK_S * self._fault_pace,
                             self._leak_tick, (node, spec, stop))
        tm.daemon = True
        tm.start()

    def _stop_leak(self, node) -> None:
        stop = self._leak_stops.pop(node.node_id, None)
        if stop is not None:
            stop.set()
        node.daemon.reclaim_leak()

    # -- scheduled fault application (replay timers / direct calls) ----
    def _fault_nodes(self, node_name: Optional[str]) -> List:
        nodes = self._nodes
        if node_name is None:
            return list(nodes)
        hit = [n for n in nodes if n.node_id == node_name]
        if not hit:
            raise ValueError(f"fault names unknown node {node_name!r}")
        return hit

    def _apply_fault(self, action: str, spec) -> None:
        """Apply one scheduled fault to the runtime backend (the sim twin
        applies the same plan through ``EventKind.FAULT`` events)."""
        if isinstance(spec, NodeCrash):
            for n in self._fault_nodes(spec.node):
                if action == "crash":
                    n.crash(f"injected crash of {n.node_id}")
                else:
                    n.restore()
        elif isinstance(spec, LinkDegradation):
            for n in self._fault_nodes(spec.node):
                broker = n.paths.db if spec.link == "db" else n.paths.pcie
                if action == "degrade_on":
                    broker.apply_degradation(spec.factor)
                else:
                    broker.clear_degradation(spec.factor)
        elif isinstance(spec, DbFlap):
            for n in self._fault_nodes(spec.node):
                n.daemon.db_down = action == "db_down"
        elif isinstance(spec, SlowNode):
            # gray failure: the node stays up but everything on it runs
            # ``factor`` slower — engine leg via the node's slow_factor
            # (measured-dt stretch in sage_run), transfer legs via both
            # of the node's links (sim _apply_fault parity)
            for n in self._fault_nodes(spec.node):
                if action == "slow_on":
                    n.slow_factor *= spec.factor
                    n.paths.db.apply_degradation(spec.factor)
                    n.paths.pcie.apply_degradation(spec.factor)
                else:
                    n.slow_factor /= spec.factor
                    n.paths.db.clear_degradation(spec.factor)
                    n.paths.pcie.clear_degradation(spec.factor)
        elif isinstance(spec, MemoryLeak):
            for n in self._fault_nodes(spec.node):
                if action == "leak_on":
                    self._start_leak(n, spec)
                else:
                    self._stop_leak(n)

    def resilience_stats(self) -> Dict[str, object]:
        """Control-layer counters, same keys on both backends."""
        if self.sim is not None:
            return self.sim.resilience_stats()
        q = (self._quarantine.stats() if self._quarantine is not None
             else {"quarantines": 0, "readmits": 0})
        return {
            "shed": self._shed,
            "breaker_rejected": self._breaker_rejected,
            "node_lost": self._node_lost,
            "redispatches": self._redispatches,
            "node_crashes": sum(n.crashes for n in self._nodes),
            "node_drains": sum(1 for n in self._nodes
                               if n.draining or n.retired),
            "breaker_states": {name: br.state
                               for name, br in self._breakers.items()},
            "hedges_launched": self._hedges_launched,
            "hedges_won": self._hedges_won,
            "hedges_wasted": self._hedges_wasted,
            "quarantines": q["quarantines"],
            "readmits": q["readmits"],
        }

    def compute_stats(self) -> Dict[str, object]:
        """Shared-compute-plane counters, same keys on both backends
        (docs/compute.md); all-zero "exclusive" when the plane is off."""
        if self.sim is not None:
            return self.sim.compute_stats()
        return self.runtime.compute_stats()

    # ------------------------------------------------------------------
    # placement control plane (docs/planner.md)
    # ------------------------------------------------------------------
    def placement_stats(self) -> Optional[Dict]:
        """Planner/stealer/autoscaler counters + the node-count timeline;
        ``None`` unless the control plane is on (same keys on both
        backends)."""
        if self.sim is not None:
            return self.sim.placement_stats()
        ps = getattr(self.runtime, "placement_stats", None)
        return ps() if ps is not None else None

    def add_node(self):
        """Provision one cold node into the backend's pool (the manual
        form of the autoscaler's scale-up); returns the new node."""
        if self.sim is not None:
            return self.sim.add_node()
        if not hasattr(self.runtime, "add_node"):
            raise RuntimeError(
                "single-node runtime gateway has no node pool; construct "
                "with n_nodes > 1 or autoscale=")
        return self.runtime.add_node()

    def drain_node(self, node) -> None:
        """Gracefully drain one node (name, or index on the runtime
        backend): no new placements; exact teardown once idle."""
        if self.sim is not None:
            self.sim.drain_node(node)
            return
        if not hasattr(self.runtime, "drain_node"):
            raise RuntimeError(
                "single-node runtime gateway has no node pool; construct "
                "with n_nodes > 1 or autoscale=")
        self.runtime.drain_node(node)

    def retire(self, name: str) -> None:
        """Unregister a function (planner churn signal): new invokes
        raise KeyError; resident state ages out via the exit ladders."""
        if name not in self.specs:
            raise KeyError(f"unregistered function {name!r}")
        if self.sim is not None:
            self.sim.retire(name)
        else:
            rf = getattr(self.runtime, "retire_function", None)
            if rf is not None:
                rf(name)
        del self.specs[name]

    # ------------------------------------------------------------------
    # invocation
    # ------------------------------------------------------------------
    def _effective_slo(self, name: str, deadline_s, priority):
        spec = self.specs[name]
        return (spec.deadline_s if deadline_s is None else deadline_s,
                spec.priority if priority is None else priority)

    def _pick_node(self, name: str) -> Tuple[int, Optional[str]]:
        """(node index, residency tier at dispatch) for the runtime
        backend. Multi-node gateways delegate to the cluster's dispatch
        policy (the request must be BUILT for the chosen node — each node
        has its own database and compiled functions — so selection happens
        here, not inside ``ClusterRuntime.submit``)."""
        if len(self._nodes) == 1:
            return 0, None
        return self.runtime.select_node(name)

    def _build_request(self, name: str, node_idx: int, *, seed: int,
                       input_bytes: int, deadline_s, priority,
                       max_retries=None, dispatch_tier=None):
        from repro_torch.core.functions import make_request

        spec = self.specs[name]
        req = make_request(
            self._nodes[node_idx].db, self._fns[name][node_idx],
            batch=spec.batch, seq=spec.seq, input_bytes=input_bytes, seed=seed,
        )
        req.deadline_s, req.priority = self._effective_slo(name, deadline_s, priority)
        req.max_retries = max_retries
        req.dispatch_tier = dispatch_tier
        return req

    def invoke_async(self, name: str, *, seed: int = 0,
                     at: Optional[float] = None,
                     deadline_s: Optional[float] = None,
                     priority: Optional[int] = None,
                     max_retries: Optional[int] = None,
                     input_bytes: int = DEFAULT_INPUT_BYTES) -> Invocation:
        """Submit one invocation; returns an :class:`Invocation` handle.
        ``at`` is a virtual arrival time (sim backend only — the real
        runtime always arrives now). ``max_retries`` is the per-request
        OOM-admission retry budget (None = the flat ``load_timeout_s``)."""
        if name not in self.specs:
            raise KeyError(f"unregistered function {name!r}")
        if self.sim is not None:
            t = self.sim.clock.now() if at is None else at
            dl, pr = self._effective_slo(name, deadline_s, priority)
            rid = f"gw-{next(self._seq)}-{name}"
            self.sim.submit(name, t, deadline_s=dl, priority=pr,
                            request_id=rid, max_retries=max_retries)
            return _SimInvocation(self.sim, rid)
        dl, pr = self._effective_slo(name, deadline_s, priority)
        injected, jitter_s = False, 0.0
        if (self._fault_draws is not None or self.shedding is not None
                or self._breaker_cfg is not None or self._breaker_overrides):
            # ad-hoc invokes draw on wall time since gateway creation;
            # replay() draws on workload time so seeded sequences match
            # the sim's (the draw count per function is what must align)
            injected, jitter_s, rejection = self._gate(
                name, time.monotonic() - self._t0, dl, pr)
            if rejection is not None:
                return _RejectedInvocation(rejection)
        node_idx, tier = self._pick_node(name)
        req = self._build_request(name, node_idx, seed=seed,
                                  input_bytes=input_bytes,
                                  deadline_s=dl, priority=pr,
                                  max_retries=max_retries, dispatch_tier=tier)
        req.fault_injected = injected
        req.jitter_s = jitter_s
        node = self._nodes[node_idx]
        fut = node.submit(req)
        if self._resilience_on():
            return _ResilientInvocation(self, name, node_idx, req, fut,
                                        seed=seed, input_bytes=input_bytes)
        return _RuntimeInvocation(node, fut, req.uuid)

    def invoke(self, name: str, **kw) -> InvocationRecord:
        """Blocking invocation; returns the finished record (the handler's
        return value rides on ``record.result`` for the real backend)."""
        return self.invoke_async(name, **kw).wait()

    # ------------------------------------------------------------------
    # workload replay
    # ------------------------------------------------------------------
    def replay(self, workload: Union[Workload, List[Arrival]], *,
               until: Optional[float] = None, until_pad: float = 300.0,
               pace: float = 1.0, seed: int = 0,
               timeout: Optional[float] = DEFAULT_REPLAY_TIMEOUT_S,
               input_bytes: int = DEFAULT_INPUT_BYTES) -> Telemetry:
        """Drive every arrival of ``workload`` through the backend.

        Simulator: arrivals land at their virtual times and the clock runs
        to ``until`` (default: last arrival + ``until_pad``); ``pace``/
        ``seed``/``input_bytes``/``timeout`` don't apply (no wall clock, no
        real payloads). Real runtime: arrivals are paced open-loop in
        wall-clock time (``pace`` seconds of wall time per workload second)
        and every completion is awaited up to ``timeout`` wall seconds;
        failures stay in ``Telemetry.errors()``. ``until`` cannot cut a
        wall clock short, so passing it on this backend raises rather than
        silently skewing a windowed measurement. Returns ``report()``.
        """
        events = workload.events() if isinstance(workload, Workload) \
            else sorted(workload, key=lambda a: a.t)
        if self.sim is not None:
            for a in events:
                dl, pr = self._effective_slo(a.function, a.deadline_s, a.priority)
                # unique ids: simultaneous arrivals of one function would
                # otherwise collide on the simulator's default "name@t" id
                self.sim.submit(a.function, a.t, deadline_s=dl, priority=pr,
                                request_id=f"gw-{next(self._seq)}-{a.function}")
            horizon = until if until is not None else \
                ((events[-1].t if events else 0.0) + until_pad)
            self.sim.run(until=horizon)
            return self.report()
        if until is not None:
            raise ValueError("replay(until=...) is a virtual-time cutoff; "
                             "the runtime backend always drains — filter "
                             "records by end_t instead")
        handles = []
        # scheduled faults land at t0 + at_s * pace — the wall-clock image
        # of the sim twin's EventKind.FAULT heap entries for the same plan
        timers: List[threading.Timer] = []
        gates_on = (self._fault_draws is not None or self.shedding is not None
                    or self._breaker_cfg is not None or self._breaker_overrides)
        self._fault_pace = pace  # leak/probe timers tick in workload time
        t0 = time.monotonic()
        if self.faults is not None:
            for ft, action, spec in self.faults.events():
                tm = threading.Timer(ft * pace, self._apply_fault,
                                     (action, spec))
                tm.daemon = True
                timers.append(tm)
                tm.start()
        try:
            for i, a in enumerate(events):
                lag = t0 + a.t * pace - time.monotonic()
                if lag > 0:
                    time.sleep(lag)
                dl, pr = self._effective_slo(a.function, a.deadline_s,
                                             a.priority)
                injected, jitter_s = False, 0.0
                if gates_on:
                    # draws use workload time (a.t) so the per-function
                    # draw sequence matches the sim's for the same plan
                    injected, jitter_s, rejection = self._gate(
                        a.function, a.t, dl, pr)
                    if rejection is not None:
                        continue  # recorded; nothing to submit or await
                node_idx, tier = self._pick_node(a.function)
                req = self._build_request(a.function, node_idx, seed=seed + i,
                                          input_bytes=input_bytes,
                                          deadline_s=dl, priority=pr,
                                          dispatch_tier=tier)
                req.fault_injected = injected
                req.jitter_s = jitter_s
                node = self._nodes[node_idx]
                fut = node.submit(req)
                if self._resilience_on():
                    handles.append(_ResilientInvocation(
                        self, a.function, node_idx, req, fut,
                        seed=seed + i, input_bytes=input_bytes))
                else:
                    handles.append(_RuntimeInvocation(node, fut, req.uuid))
            for h in handles:
                h.wait(timeout, strict=False)
            if self._hedging is not None:
                # a hedge winner settles its handle while the cancelled
                # loser is still unwinding on the slow node — drain so
                # every loser's dropped record lands before report()
                self._drain_losers(timeout)
        finally:
            for tm in timers:  # events past the drain are dropped, not leaked
                tm.cancel()
            for stop in self._leak_stops.values():
                stop.set()  # stop ticking past the drain (bytes stay until
                #             a leak_off/crash reclaims them — sim parity)
        return self.report()

    def _drain_losers(self, timeout: Optional[float]) -> None:
        """Block until every node is idle (bounded by ``timeout``).

        Hedge losers cancel cooperatively at engine checkpoints, so a
        loser stuck mid-kernel on a degraded node finishes well after its
        winner; its dropped record only exists once it unwinds.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(not n.is_idle() for n in self._nodes):
            if deadline is not None and time.monotonic() >= deadline:
                return
            time.sleep(0.01)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def report(self) -> Telemetry:
        """The unified per-invocation telemetry for this gateway."""
        if self.sim is not None:
            return self.sim.telemetry
        t = self.runtime.telemetry  # ClusterRuntime merges its nodes
        with self._reject_lock:
            rejected = list(self._rejected)
        if rejected:
            if t is self.runtime.telemetry and self._nodes == [self.runtime]:
                # single-node runtime hands out its LIVE telemetry — merge
                # into a copy so rejections never mutate node-local state
                merged = Telemetry()
                for rec in t.snapshot():
                    merged.add(rec)
                t = merged
            for rec in rejected:
                t.add(rec)
        return t

    @property
    def telemetry(self) -> Telemetry:
        return self.report()

    def memory_usage(self) -> Dict[str, int]:
        """Current memory footprint, same keys on both backends (the sim's
        context/host numbers are modeled from live instance state)."""
        if self.sim is not None:
            ctx = 0
            for node in self.sim.nodes:
                for insts in node.instances.values():
                    ctx += sum(i.fn.ctx_bytes for i in insts
                               if i.has_ctx and not i.dead)
            return {"device_used": sum(n.used for n in self.sim.nodes),
                    "context_bytes": ctx,
                    # the node's host-tier admission accounting (resident
                    # shared-RO copies + in-flight private bytes) — the
                    # same definition daemon.host_used reports
                    "host_used": sum(n.host_used for n in self.sim.nodes)}
        usages = [n.memory_usage() for n in self._nodes]
        return {k: sum(u[k] for u in usages) for k in usages[0]}

    def mean_memory_bytes(self) -> float:
        if self.sim is None:
            raise RuntimeError("time-weighted memory traces exist only on "
                               "the sim backend; use memory_usage() instead")
        return self.sim.mean_memory_bytes()

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        if self.runtime is not None:
            self.runtime.shutdown()

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
