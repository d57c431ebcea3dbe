"""Domain layer: simulated GPU nodes, instances, and transfer-leg state
machines (docs/simulator.md).

Everything here is an explicit event handler over plain slotted classes —
the engine fires events, these objects mutate node state and post the next
event. No per-event closures: a multi-leg load is a :class:`_LoadChain`,
a chunked stream drive is a :class:`_StreamDrive`, a queued reservation is
a :class:`PendingReservation` whose expiry rides the event's ``args``.

The modeling contract is unchanged from the pre-kernel simulator (module
docstring of :mod:`repro_torch.core.simulator`): same loader gate, admission
heap, host tier, exit ladders, and fair-share links as the threaded
daemon, golden-trace-guarded in tests/test_torch_sim.py.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.baselines import SystemPolicy
from repro_torch.core.clock import VirtualClock
from repro_torch.core.daemon import SCHEDULERS, AdmissionKey
from repro_torch.core.datapath import DB_BANDWIDTH, PCIE_BANDWIDTH, BandwidthBroker
from repro_torch.core.dispatch import NodeSnapshot
from repro_torch.core.exit_policy import ExitLadder
from repro_torch.core.profiles import MB, FunctionProfile
from repro_torch.core.sim.kernel import EventKind
from repro_torch.core.sim.policies import admission_policy
from repro_torch.core.telemetry import InvocationRecord
from repro_torch.core.transfer import DEFAULT_CHUNK_BYTES, TRANSFER_MODES, LinkArbiter

# invocation-model constants (paper Table 4; shared by every policy path)
GPU_CTX_S = 0.2851
CPU_CTX_S = 0.001
RETURN_S = 0.0001
CONTAINER_S = 2.0


@dataclass
class SimFunction:
    profile: FunctionProfile
    name: str = ""
    # declared SM fraction in (0, 1] for the shared compute plane
    # (docs/compute.md); None = auto, derived from the profiled compute
    # stage. Ignored entirely under compute="exclusive".
    sm_fraction: Optional[float] = None

    def __post_init__(self):
        self.name = self.name or self.profile.name

    @property
    def ro_bytes(self) -> int:
        return int(self.profile.read_only_mb * MB)

    @property
    def w_bytes(self) -> int:
        return int(self.profile.writable_mb * MB)

    @property
    def ctx_bytes(self) -> int:
        return int(self.profile.context_mb * MB)

    @property
    def compute_s(self) -> float:
        return self.profile.compute_ms / 1e3

    def slot_bytes(self, granularity: int) -> int:
        need = self.ctx_bytes + self.ro_bytes + self.w_bytes
        if granularity:
            need = ((need + granularity - 1) // granularity) * granularity
        return need


@dataclass
class SimInstance:
    fn: SimFunction
    ladder: ExitLadder = field(default_factory=ExitLadder)
    busy: bool = False
    dead: bool = False
    has_ctx: bool = False
    ctx_building: bool = False
    # (on_ready, on_fail) pairs: failure of the building invocation's ctx
    # reservation propagates to everyone latched onto it
    ctx_waiters: List[Tuple[Callable, Callable]] = field(default_factory=list)
    has_ro_device: bool = False
    has_ro_host: bool = False
    slot: int = 0


class PendingReservation:
    """One queued device-memory reservation (may carry a failure deadline).
    ``key`` is the :data:`~repro_torch.core.daemon.AdmissionKey` that orders the
    pending heap — the twin of the threaded daemon's waiter heap."""

    __slots__ = ("nbytes", "cont", "on_fail", "expired", "granted", "key",
                 "attempts", "max_retries")

    def __init__(self, nbytes: int, cont: Callable, on_fail: Optional[Callable],
                 key: AdmissionKey, max_retries: Optional[int] = None):
        self.nbytes = nbytes
        self.cont = cont
        self.on_fail = on_fail
        self.expired = False
        self.granted = False
        self.key = key
        # per-request OOM retry budget (twin of the daemon's): the failed
        # reserve() attempt that queued us counts as attempt #1; each failed
        # head admission in kick() is one retry
        self.attempts = 1
        self.max_retries = max_retries


class _StreamDrive:
    """Drives one :class:`~repro_torch.core.transfer.TransferStream` chunk by
    chunk (one full-size advance under ``run_to_completion``). Between
    chunks, if a strictly tighter ``(priority, deadline)`` class waits on
    the loader gate, the stream pauses (completed bytes kept), its resume
    re-queues under its own key, and the freed slot goes to the queue head
    — identical yield semantics to the threaded daemon's ``_drive_stream``.
    """

    __slots__ = ("node", "st", "key", "phase_done")

    def __init__(self, node: "GPUNode", st, key: AdmissionKey,
                 phase_done: Callable):
        self.node = node
        self.st = st
        self.key = key
        self.phase_done = phase_done

    def step(self) -> None:
        node, st = self.node, self.st
        if st.done or st.cancelled:
            self.phase_done()
            return
        if node.daemon_pooled and node.arbiter.should_yield(self.key):
            st.pause(node.clock.now())
            node.arbiter.note_preemption()
            # fresh seq: behind the tighter head, ahead of looser work
            resume_key = (self.key[0], self.key[1], next(node._key_seq))
            heapq.heappush(node._loader_queue, (resume_key, self.resume))
            node.release_loader()
            return
        # ungated (baseline) loads can never yield — the demand signal
        # is the loader gate they do not use — so chunking them would
        # only add events; advance full-size instead
        # per-advance hint: degradation-scaled chunks keep the preemption
        # latency bound when a fault window slows this stream's link
        st.sim_advance(node.arbiter.chunk_hint(st.broker)
                       if node.daemon_pooled else None, self.step)

    def resume(self) -> None:
        self.st.resume(self.node.clock.now())
        self.step()


class _LoadChain:
    """One db->host->device load: the two transfer legs as an explicit
    state machine (``start`` → ``host_loaded`` → ``dev_loaded``).

    Fault hooks (docs/resilience.md): a flapping db (``node.db_down``)
    fails the chain before the db leg moves any bytes; a poisoned load
    fails AFTER the db leg completes — the corrupt fetch consumed its
    full bandwidth share, the same point the threaded daemon poisons.
    Either way ``on_fail(reason)`` runs instead of ``done`` and the
    loader gate is released. A per-arrival ``jitter_s`` (LoaderJitter
    gray failure) delays the db leg while HOLDING the loader slot — a
    jittery loader wedges loader workers, which is exactly the tail
    pathology the slowness detector has to see."""

    __slots__ = ("node", "nbytes", "done", "via_db", "key", "rec",
                 "db_st", "pcie_st", "t_pcie", "gated", "on_fail", "poison",
                 "jitter_s")

    def __init__(self, node: "GPUNode", nbytes: int, done: Callable,
                 via_db: bool, key: AdmissionKey,
                 rec: Optional[InvocationRecord],
                 on_fail: Optional[Callable] = None, poison: bool = False,
                 jitter_s: float = 0.0):
        self.node = node
        self.nbytes = nbytes
        self.done = done
        self.via_db = via_db
        self.key = key
        self.rec = rec
        self.gated = node.daemon_pooled
        self.db_st = node.db.open_stream(nbytes) if via_db else None
        self.pcie_st = node.pcie.open_stream(nbytes)
        self.t_pcie = 0.0
        self.on_fail = on_fail
        self.poison = poison
        self.jitter_s = jitter_s

    def start(self) -> None:
        if self.jitter_s > 0.0 and self.via_db:
            j, self.jitter_s = self.jitter_s, 0.0
            self.node.clock.schedule(j, self.start, kind=EventKind.TRANSFER)
            return
        if self.via_db:
            if self.node.db_down:
                self._fail_leg("db link down")
                return
            self.node._drive(self.db_st, self.key, self.host_loaded)
        else:  # host promotion: PCIe only
            self.host_loaded()

    def host_loaded(self) -> None:
        if self.poison and self.via_db:
            self._fail_leg("injected loader fault")
            return
        self.t_pcie = self.node.clock.now()
        self.node._drive(self.pcie_st, self.key, self.dev_loaded)

    def _fail_leg(self, reason: str) -> None:
        node = self.node
        if self.gated:
            node.release_loader()
        node.load_failures += 1
        if self.on_fail is not None:
            self.on_fail(reason)

    def dev_loaded(self) -> None:
        node, rec = self.node, self.rec
        if rec is not None:
            # actual span, accumulated per record (parallel private
            # legs overlap in time, same additive convention as before)
            rec.stages["gpu_data"] = (rec.stages.get("gpu_data", 0.0)
                                      + node.clock.now() - self.t_pcie)
            for st in (self.db_st, self.pcie_st):
                if st is not None:
                    rec.preemptions += st.preemptions
                    rec.stalled_s += st.stalled_s
        if self.gated:
            node.release_loader()
        if self.via_db:  # completion-counted, like the daemon's stats
            node.loads += 1
            node.bytes_loaded += self.nbytes
        self.done()


class GPUNode:
    """One simulated GPU node (device memory + compute FIFO + data paths).

    Mirrors the threaded daemon's data-plane contract (docs/dataplane.md):
    loads run through a **bounded loader gate** (``loader_threads`` concurrent
    db->PCIe streams, high-water mark in ``max_inflight_loads``), and memory
    reservations given a deadline *fail* past ``load_timeout_s`` instead of
    queueing forever — the failed invocation's record carries ``error``."""

    def __init__(self, policy: SystemPolicy, clock: VirtualClock, *,
                 capacity: int = 40 << 30, host_capacity: int = 125 << 30,
                 exit_ttl: float = 30.0, name: str = "gpu0",
                 loader_threads: int = 4, load_timeout_s: float = 600.0,
                 scheduler: str = "fifo",
                 transfer: str = "run_to_completion",
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; use one of {SCHEDULERS}")
        if transfer not in TRANSFER_MODES:
            raise ValueError(
                f"unknown transfer mode {transfer!r}; use one of {TRANSFER_MODES}")
        self.policy = policy
        self.clock = clock
        self.capacity = capacity
        self.host_capacity = host_capacity
        self.exit_ttl = exit_ttl
        self.name = name
        self.scheduler = scheduler
        self.used = 0
        # host-tier accounting (twin of the daemon's host admission): bytes
        # resident on host, plus which function's shared-RO host copy is
        # evictable (the refcount-0 HOST entries of the threaded daemon)
        self.host_used = 0
        self.host_resident: Dict[str, int] = {}
        self.host_touch: Dict[str, float] = {}  # last use, for LRU eviction
        self.host_evictions = 0
        self.db = BandwidthBroker(DB_BANDWIDTH, clock, "db", concurrency_penalty=0.06)
        self.pcie = BandwidthBroker(PCIE_BANDWIDTH, clock, "pcie")
        self.compute_free_at = 0.0
        # shared compute plane (docs/compute.md): None = the seed's
        # exclusive compute FIFO above; attached by Simulator.set_compute.
        # ``compute_batches`` holds the per-function OPEN BatchCollector.
        self.compute_plane = None
        self.compute_batches: Dict[str, object] = {}
        self.instances: Dict[str, List[SimInstance]] = {}
        # SAGE shared read-only state per function: tier + waiters
        self.ro_state: Dict[str, str] = {}  # function -> none|loading|device|host
        self.ro_ready_cbs: Dict[str, List[Tuple[Callable, Callable]]] = {}
        self.dgsf_free: Dict[str, int] = {}
        self.dgsf_queue: Dict[str, List[Callable]] = {}
        # memory occupancy: streaming time-weighted accumulator (the
        # pre-kernel list of (t, used) samples held one tuple per memory
        # event — a million-invocation replay would pin millions)
        self._mem_first_t: Optional[float] = None
        self._mem_last_t = 0.0
        self._mem_last_v = 0
        self._mem_acc = 0.0
        # pending device reservations, heap-ordered by AdmissionKey (the
        # twin of the daemon's ordered waiter heap)
        self.pending_mem: List[Tuple[AdmissionKey, PendingReservation]] = []
        self._key_seq = itertools.count()
        # bounded loader gate (twin of daemon.LoaderPool). Only SAGE has the
        # unified memory daemon; baseline platforms (FixedGSL/DGSF) load in
        # per-invocation containers with no shared pool — gating them would
        # cap the very db-path contention Fig 4 measures (paper: 34.9x).
        self.daemon_pooled = policy.name.startswith("sage")
        self.loader_threads = max(1, int(loader_threads))
        self.load_timeout_s = load_timeout_s
        self.inflight_loads = 0
        self.max_inflight_loads = 0
        self._loader_queue: List[Tuple[AdmissionKey, Callable]] = []
        self._kicking = False
        # link arbiter (twin of the daemon's): demand = the tightest job
        # waiting on the loader gate; only the gated (SAGE) path ever
        # yields, exactly like the threaded pool (docs/dataplane.md)
        self.arbiter = LinkArbiter(
            transfer, chunk_bytes,
            demand=lambda: self._loader_queue[0][0] if self._loader_queue
            else None)
        self.load_failures = 0
        # data actually delivered over the db path (twin of the daemon's
        # stats["loads"]/["bytes_loaded"]: counted on completion, host
        # promotions not re-counted — they never touch the db leg)
        self.loads = 0
        self.bytes_loaded = 0
        # fault-injection state (docs/resilience.md) — all defaults keep
        # the no-fault replay bit-identical. ``epoch`` retires deferred
        # completions scheduled before a crash; ``active`` tracks live
        # invocations ONLY when ``fault_tracking`` is set (the set is
        # per-arrival overhead the million-invocation replay must not pay).
        self.healthy = True
        self.epoch = 0
        self.fault_tracking = False
        self.active: set = set()
        self.db_down = False
        self.crashes = 0
        # gray-failure state (docs/resilience.md, "Gray failures"): a
        # SlowNode window multiplies kernel time by ``slow_factor`` (1.0 =
        # exact seed arithmetic — x * 1.0 is bit-identical); a MemoryLeak
        # window creeps ``used`` by ``leaked`` bytes, reclaimed exactly
        # when the window closes or the node tears down.
        self.slow_factor = 1.0
        self.leaked = 0
        # dynamic node pool (docs/planner.md): a draining node takes no
        # new placements; once idle it is retired via the same teardown
        # path a crash uses (exact context/slot/byte release).
        self.draining = False
        self.retired = False

    # ------------------------------------------------------------------
    # fault injection: node crash / restore (docs/resilience.md)
    # ------------------------------------------------------------------
    def _teardown(self) -> list:
        """Release every accounting tier to empty (the PR-7 eviction
        teardown): epoch bump retires every deferred completion/grant
        scheduled before this point (Completion guards on it; the
        brokers' reset retires their stream events), and the returned
        victims are the live invocations the caller must resolve —
        WITHOUT touching this node's (already-zeroed) accounting."""
        self.epoch += 1
        victims = list(self.active)
        self.active.clear()
        self.used = 0
        self._sample_mem()
        self.host_used = 0
        self.host_resident.clear()
        self.host_touch.clear()
        self.instances = {f: [] for f in self.instances}
        self.ro_state = {f: "none" for f in self.ro_state}
        self.ro_ready_cbs = {f: [] for f in self.ro_ready_cbs}
        for _, p in self.pending_mem:
            p.expired = True  # a pending expiry event finds it dead
        self.pending_mem.clear()
        self._loader_queue.clear()
        self.inflight_loads = 0
        self.compute_free_at = 0.0
        if self.compute_plane is not None:
            # every in-flight grant died with the epoch; parked batches
            # are orphaned (their flush events no-op on the epoch guard)
            self.compute_plane.reset()
        self.compute_batches.clear()
        self.dgsf_free = {f: 0 for f in self.dgsf_free}
        self.dgsf_queue = {f: [] for f in self.dgsf_queue}
        self.leaked = 0  # the zeroed accounting reclaims the leak
        self.db.reset()
        self.pcie.reset()
        return victims

    def crash(self) -> None:
        """Kill the node: full teardown, and each live invocation's
        ``on_node_lost`` runs so the control layer can re-dispatch or
        fail it typed."""
        if not self.healthy:
            return
        self.healthy = False
        self.crashes += 1
        for inv in self._teardown():
            inv.on_node_lost()

    def restore(self) -> None:
        """Node rejoins, cold (the crash emptied every tier). DGSF's
        pre-created context pools are re-initialized by the simulator,
        which knows the registered functions."""
        self.healthy = True

    # ------------------------------------------------------------------
    # gray failures: memory leak accounting (docs/resilience.md)
    # ------------------------------------------------------------------
    def leak(self, nbytes: int) -> None:
        """One MemoryLeak tick: ``used`` creeps up with no owner. No
        kick — pressure only ever rises from a leak."""
        self.leaked += nbytes
        self.used += nbytes
        self._sample_mem()

    def reclaim_leak(self) -> None:
        """Window closed (or injector torn down): give the bytes back
        exactly and re-admit whatever the creep was blocking."""
        if not self.leaked:
            return
        freed, self.leaked = self.leaked, 0
        self.release(freed)

    # ------------------------------------------------------------------
    # dynamic node pool: graceful drain (docs/planner.md)
    # ------------------------------------------------------------------
    def is_idle(self) -> bool:
        """No live invocations, parked reservations, or loader work —
        safe to retire. (``active`` is maintained when ``fault_tracking``
        is on; the planner/autoscaler turns it on for every node.)"""
        return (not self.active and not self.pending_mem
                and not self._loader_queue and self.inflight_loads == 0)

    def finalize_drain(self) -> None:
        """Retire a drained node once idle: the SAME teardown a crash
        runs — exact context/slot/byte release, broker reset, epoch bump
        — but graceful: there are no victims to fail."""
        if self.retired:
            return
        assert self.is_idle(), f"finalize_drain on busy node {self.name}"
        victims = self._teardown()
        assert not victims
        self.retired = True

    # ------------------------------------------------------------------
    # SLO-aware admission keys (same formula as daemon._admission_key),
    # via the policy-layer plugin registry (sim/policies.py)
    # ------------------------------------------------------------------
    def admission_key(self, rec: Optional[InvocationRecord] = None) -> AdmissionKey:
        return admission_policy(self.scheduler).key(self, rec)

    # ------------------------------------------------------------------
    # dispatch snapshot (twin of MemoryDaemon.residency/pressure)
    # ------------------------------------------------------------------
    def residency(self, function: str) -> Tuple[str, int]:
        """(best tier, resident bytes) of ``function``'s shared read-only
        data — "device" > "loading" (an in-flight load new arrivals latch
        onto) > "host" > "none", same ranking as the threaded daemon's."""
        st = self.ro_state.get(function, "none")
        if st not in ("device", "loading", "host"):
            return "none", 0
        nbytes = next(
            (i.fn.ro_bytes for i in self.instances.get(function, [])
             if not i.dead),
            self.host_resident.get(function, 0),
        )
        return st, nbytes

    def pending_admission_count(self) -> int:
        """Parked (not yet granted/expired) device-memory waiters — the
        ``pending_admissions`` field of the dispatch snapshot."""
        return sum(1 for _, p in self.pending_mem
                   if not p.expired and not p.granted)

    def loader_queue_depth(self) -> int:
        """Queued + in-flight loads on the loader gate (0 for ungated
        baseline platforms) — the ``loader_queue`` snapshot field."""
        return (len(self._loader_queue) + self.inflight_loads
                if self.daemon_pooled else 0)

    def pressure(self) -> Dict[str, int]:
        return {
            "device_free": max(self.capacity - self.used, 0),
            "device_capacity": self.capacity,
            "pending_admissions": self.pending_admission_count(),
            "loader_queue": self.loader_queue_depth(),
            "loader_threads": self.loader_threads,
        }

    def dispatch_snapshot(self, function: str,
                          health_score: float = 1.0) -> NodeSnapshot:
        tier, ro_bytes = self.residency(function)
        return NodeSnapshot(node_id=self.name, ro_tier=tier,
                            ro_bytes=ro_bytes, healthy=self.healthy,
                            health_score=health_score,
                            compute_free_frac=(
                                self.compute_plane.free_fraction(
                                    self.clock.now())
                                if self.compute_plane is not None else 1.0),
                            **self.pressure())

    # ------------------------------------------------------------------
    # loader gate
    # ------------------------------------------------------------------
    def acquire_loader(self, start: Callable,
                       key: Optional[AdmissionKey] = None) -> None:
        """Run ``start`` when a loader slot frees up (AdmissionKey order
        past the bound — arrival order under "fifo", tightest slack first
        under "edf")."""
        if self.inflight_loads < self.loader_threads:
            self.inflight_loads += 1
            self.max_inflight_loads = max(self.max_inflight_loads, self.inflight_loads)
            start()
        else:
            heapq.heappush(self._loader_queue, (key or self.admission_key(), start))

    def release_loader(self) -> None:
        self.inflight_loads -= 1
        if self._loader_queue:
            _, nxt = heapq.heappop(self._loader_queue)
            self.inflight_loads += 1
            self.max_inflight_loads = max(self.max_inflight_loads, self.inflight_loads)
            nxt()

    def _drive(self, st, key: AdmissionKey, phase_done: Callable) -> None:
        _StreamDrive(self, st, key, phase_done).step()

    def load(self, nbytes: int, done: Callable, *, via_db: bool = True,
             key: Optional[AdmissionKey] = None,
             rec: Optional[InvocationRecord] = None,
             on_fail: Optional[Callable] = None,
             poison: bool = False, jitter_s: float = 0.0) -> None:
        """One db->host->device stream. Under a SAGE daemon it runs on the
        bounded gate and the slot is held across the whole chain, exactly
        like a real loader-pool worker; baseline platforms stream ungated.

        Each leg is a chunked :class:`~repro_torch.core.transfer.TransferStream`;
        with ``rec`` the PCIe leg's **actual** contended (+ preempted) span
        lands in ``rec.stages["gpu_data"]`` and the streams' preemption /
        stall counters roll into ``rec.preemptions`` / ``rec.stalled_s``.

        ``on_fail(reason)`` runs instead of ``done`` when the chain hits
        an injected fault (db flap / ``poison``, docs/resilience.md);
        with ``on_fail=None`` faults cannot reach this load."""
        key = key if key is not None else self.admission_key()
        chain = _LoadChain(self, nbytes, done, via_db, key, rec,
                           on_fail=on_fail, poison=poison, jitter_s=jitter_s)
        if chain.gated:
            self.acquire_loader(chain.start, key)
        else:
            chain.start()

    # ------------------------------------------------------------------
    # host-tier admission (twin of MemoryDaemon._admit_host)
    # ------------------------------------------------------------------
    def reserve_host(self, nbytes: int) -> bool:
        """Admit ``nbytes`` to the host tier; past the ceiling, evict
        idle host-state shared-RO copies (the refcount-0 HOST entries of
        the threaded daemon) LRU-first — same victim order as the
        daemon's ``_admit_host`` — before giving up."""
        if self.host_used + nbytes > self.host_capacity:
            victims = sorted(self.host_resident,
                             key=lambda f: self.host_touch.get(f, 0.0))
            for fname in victims:
                if self.host_used + nbytes <= self.host_capacity:
                    break
                if self.ro_state.get(fname) != "host":
                    continue  # in use on device / mid-promotion: not evictable
                self.host_used -= self.host_resident.pop(fname)
                self.host_touch.pop(fname, None)
                self.ro_state[fname] = "none"
                for inst in self.instances.get(fname, []):
                    inst.has_ro_host = False
                self.host_evictions += 1
        if self.host_used + nbytes > self.host_capacity:
            return False
        self.host_used += nbytes
        return True

    def release_host(self, nbytes: int) -> None:
        self.host_used -= nbytes

    def touch_host(self, fname: str) -> None:
        if fname in self.host_resident:
            self.host_touch[fname] = self.clock.now()

    def drop_host_resident(self, fname: str) -> None:
        """Release the shared-RO host copy accounting for ``fname``."""
        self.release_host(self.host_resident.pop(fname, 0))
        self.host_touch.pop(fname, None)

    # ------------------------------------------------------------------
    def _sample_mem(self):
        """Fold the occupancy level held since the last memory event into
        the streaming time-weighted accumulator (same arithmetic, in the
        same order, as the pre-kernel batch pass over ``mem_samples``)."""
        now = self.clock.now()
        if self._mem_first_t is None:
            self._mem_first_t = now
        else:
            self._mem_acc += self._mem_last_v * (now - self._mem_last_t)
        self._mem_last_t = now
        self._mem_last_v = self.used

    def mean_memory_bytes(self, t_end: float) -> Optional[float]:
        """Time-weighted mean device occupancy over [first sample, t_end];
        ``None`` when no memory event ever fired on this node."""
        if self._mem_first_t is None:
            return None
        acc = self._mem_acc + self._mem_last_v * (t_end - self._mem_last_t)
        return acc / max(t_end - self._mem_first_t, 1e-9)

    def reserve(self, nbytes: int, cont: Callable, *,
                on_fail: Optional[Callable] = None,
                timeout: Optional[float] = None,
                key: Optional[AdmissionKey] = None,
                max_retries: Optional[int] = None) -> None:
        """Reserve device memory; queue (with lazy eviction) if full.

        Queued reservations are served in ``key`` order (:data:`AdmissionKey`
        — arrival order under "fifo", tightest remaining slack first under
        "edf"), mirroring the threaded daemon's ordered waiter heap. With
        ``on_fail``, the queued reservation expires after ``timeout``
        (default ``load_timeout_s``) — the twin of the daemon's OOM-retry
        deadline — and ``on_fail`` runs instead of ``cont``.

        ``max_retries`` is the per-request OOM retry budget (twin of the
        daemon's): ``0`` fails here on the first OOM instead of queueing,
        ``N`` allows N failed head re-admissions in :meth:`kick`, ``None``
        waits out the flat deadline."""
        self._advance_ladders()
        if self.used + nbytes <= self.capacity or self._evict(nbytes - (self.capacity - self.used)):
            self.used += nbytes
            self._sample_mem()
            cont()
            return
        if nbytes > self.capacity and on_fail is not None:
            # impossible request (bigger than the whole device): fail now
            # rather than head-of-line-block the queue until the deadline
            # (twin of the daemon's fast-fail in _reserve_device_blocking)
            self.load_failures += 1
            on_fail()
            return
        if max_retries is not None and max_retries <= 0 and on_fail is not None:
            # retry budget 0: the failed attempt above was the only one
            # allowed — fail-fast typed, exactly like the daemon's head
            # attempt raising with an exhausted budget
            self.load_failures += 1
            on_fail()
            return
        p = PendingReservation(nbytes, cont, on_fail, key or self.admission_key(),
                               max_retries=max_retries)
        heapq.heappush(self.pending_mem, (p.key, p))
        if on_fail is not None:
            t = self.load_timeout_s if timeout is None else timeout
            self.clock.schedule(t, self._expire_pending, p,
                                kind=EventKind.ADMISSION)

    def _expire_pending(self, p: PendingReservation) -> None:
        """Deadline event for a queued reservation (popped lazily by
        :meth:`kick` once expired)."""
        if p.granted or p.expired:
            return
        p.expired = True
        self.load_failures += 1
        p.on_fail()
        self.kick()  # the queue head may have been behind this one

    def release(self, nbytes: int) -> None:
        self.used -= nbytes
        self._sample_mem()
        self.kick()

    def _grant(self, p: PendingReservation) -> None:
        p.granted = True
        self.used += p.nbytes
        self._sample_mem()
        p.cont()

    def kick(self) -> None:
        """Admit pending reservations in AdmissionKey order, evicting idle
        warm instances (Lesson-3) when plain headroom is not enough. A
        blocked head parks; later waiters may only BACKFILL free bytes no
        earlier waiter could use — same semantics as the daemon's ordered
        admission wait."""
        if self._kicking:
            return
        self._kicking = True
        charged = set()  # reservations already charged a retry this kick
        try:
            while self.pending_mem:
                _, p = self.pending_mem[0]
                if p.expired:
                    heapq.heappop(self.pending_mem)
                    continue
                self._advance_ladders()
                if self.used + p.nbytes > self.capacity:
                    self._evict(p.nbytes - (self.capacity - self.used))
                if self.used + p.nbytes <= self.capacity:
                    heapq.heappop(self.pending_mem)
                    self._grant(p)
                    continue
                # failed head admission: ONE retry against the request's
                # budget per kick (= per memory event), however many
                # backfill iterations re-examine the same blocked head —
                # parity with the daemon's counted-wake accounting
                if id(p) not in charged:
                    charged.add(id(p))
                    p.attempts += 1
                    if (p.max_retries is not None and p.on_fail is not None
                            and p.attempts > p.max_retries):
                        heapq.heappop(self.pending_mem)
                        p.expired = True
                        self.load_failures += 1
                        p.on_fail()
                        continue
                # head blocked: backfill the best-keyed waiter that fits
                # WITHOUT eviction (walking in key order, every waiter
                # skipped could not use the free bytes anyway)
                backfilled = None
                for entry in sorted(self.pending_mem)[1:]:
                    q = entry[1]
                    if q.expired:
                        continue
                    if self.used + q.nbytes <= self.capacity:
                        backfilled = entry
                        break
                if backfilled is None:
                    break
                self.pending_mem.remove(backfilled)
                heapq.heapify(self.pending_mem)
                self._grant(backfilled[1])
        finally:
            self._kicking = False

    def _evict(self, need: int) -> bool:
        """Lesson-3: drop idle warm instances (oldest first) to fit."""
        if need <= 0:
            return True
        freed = 0
        for fname, insts in self.instances.items():
            for inst in sorted(insts, key=lambda i: i.ladder.completion_t or 0):
                if inst.busy or inst.dead:
                    continue
                freed += self._destroy(inst)
                if freed >= need:
                    return True
        return freed >= need

    def _destroy(self, inst: SimInstance) -> int:
        freed = 0
        if inst.dead:
            return 0
        inst.dead = True
        if inst.has_ctx:
            freed += inst.fn.ctx_bytes
            inst.has_ctx = False
        if inst.has_ro_device:
            freed += inst.fn.ro_bytes
            inst.has_ro_device = False
            self.ro_state[inst.fn.name] = "none"
        if inst.slot:
            freed += inst.slot
            inst.slot = 0
        # the shared-RO host copy dies with its function's instance
        # (device-resident entries keep a host copy too, like the daemon)
        if inst.has_ro_host and self.ro_state.get(inst.fn.name) == "host":
            self.ro_state[inst.fn.name] = "none"
        if self.ro_state.get(inst.fn.name) == "none":
            self.drop_host_resident(inst.fn.name)
        inst.has_ro_host = False
        self.instances[inst.fn.name].remove(inst)
        if freed:
            self.release(freed)
        return freed

    def _advance_ladders(self) -> None:
        now = self.clock.now()
        for insts in self.instances.values():
            for inst in list(insts):
                if inst.busy or inst.dead:
                    continue
                s = inst.ladder.advance(now)
                if s >= 5:
                    self._destroy(inst)
