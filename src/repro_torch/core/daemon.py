"""Unified memory daemon (paper §4.1, §5, §6).

One daemon per device. It owns all device memory, performs *proactive* data
loading (the parallelized-setup half of SAGE), and implements read-only
memory sharing (the throughput half):

* ``prepare(request)`` starts async loads for every ``Data`` the request
  declares (knowability) — database -> host over the db path, host -> device
  over the PCIe path, both fair-share brokered;
* read-only entries are content-addressed by (function, key): the first
  invocation loads, the rest attach (refcount) — this is what removes the
  34.9x data-path contention;
* the multi-stage exit ladder calls ``demote_to_host`` / ``drop_host`` to
  walk cached entries down the tiers (device -> host -> gone).

Loading runs on a **bounded loader pool** sized by ``loader_threads`` (the
db/PCIe paths never see more concurrent streams than workers), and every
loader failure is **propagated**, not swallowed: an exception inside a load
is captured on the entry and re-raised as :class:`DataLoadError` from every
``Handle.wait()``. Device admission inside a load retries with backpressure
(waiting for releases/evictions) up to ``load_timeout_s`` before failing.
``release()`` of a still-loading writable entry cancels the load; the loader
rolls back its own accounting, so ``device_used``/``host_used`` never leak.
The host tier is admission-controlled too: past ``host_capacity`` the daemon
evicts refcount-0 HOST entries, then fails the load with a typed error.

Scheduling is SLO-aware when ``scheduler="edf"``: both the loader queue and
the OOM-admission wait are ordered by ``(priority desc, absolute deadline,
arrival)`` — under backpressure the waiter with the tightest remaining slack
is admitted first instead of whoever wakes first (HAS-GPU/FaaSTube-style
deadline-driven transfer scheduling). The default ``"fifo"`` keeps strict
arrival order. See docs/dataplane.md for the full contract.

With ``transfer="preemptive"`` the transfer legs themselves become
preemptible: every load leg is a chunked :class:`~repro_torch.core.transfer.
TransferStream`, and between chunks the :class:`~repro_torch.core.transfer.
LinkArbiter` checks whether a strictly tighter ``(priority, deadline)``
class is waiting on the loader queue. If so, the in-flight stream pauses
(completed bytes kept), its continuation re-queues under its own key, and
the worker it held picks up the tighter job — an in-flight loose 8 GB load
yields the link to a 50 MB tight-deadline load mid-transfer instead of
holding it run-to-completion. The default ``"run_to_completion"`` drives
each leg as one full-size advance, reproducing the pre-stream behavior
bit-for-bit.

Sharing note (DESIGN.md §2): CUDA-IPC cross-process sharing becomes
single-broker buffer-handle sharing — the daemon owns ``torch.Tensor``s on
the database's device and invocations hold references. Capacity accounting
uses the declared A100-scale sizes (``Data.size``) while payloads are real
tensors, so the admission/eviction logic is exercised truthfully on CPU and
on the card alike.
"""
from __future__ import annotations

import enum
import heapq
import itertools
import math
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.clock import RealClock
from repro_torch.core.datapath import DataPaths
from repro_torch.core.request import Data, DataType, Request
from repro_torch.core.transfer import (
    DEFAULT_CHUNK_BYTES, TRANSFER_MODES, LinkArbiter, TransferStream,
)

GPU_CONTEXT_BYTES = 414 * 1024 * 1024  # paper §1/§3: 414 MB per GPU context

SCHEDULERS = ("fifo", "edf")

# Admission key: (-priority, absolute deadline, arrival seq). Comparing two
# keys at the same instant orders by remaining slack (EDF); the seq makes
# every key unique so heaps never compare payloads.
AdmissionKey = Tuple[int, float, int]


class Tier(enum.Enum):
    LOADING_HOST = "loading_host"
    HOST = "host"
    LOADING_DEV = "loading_dev"
    DEVICE = "device"
    DROPPED = "dropped"
    FAILED = "failed"


@dataclass
class Entry:
    """One shared (or private) datum tracked by the daemon."""

    function: str
    key: str
    size: int
    read_only: bool
    tier: Tier = Tier.LOADING_HOST
    refcount: int = 0
    host_obj: Any = None
    dev_obj: Any = None
    ready = None  # threading.Event, set when on device OR failed/cancelled
    last_used: float = 0.0
    error: Optional[BaseException] = None
    cancelled: bool = False
    # exact accounting flags: which counters this entry currently holds.
    # Rollback (failure/cancel/release) consults these instead of inferring
    # from tier, which is what used to race the loader into leaking bytes.
    host_accounted: bool = False
    dev_reserved: bool = False
    # SLO metadata for deadline-aware scheduling: tightest requester wins
    # (shared entries tighten on every attach). ``deadline_at`` is absolute,
    # on the daemon clock's timeline; None means no deadline.
    priority: int = 0
    deadline_at: Optional[float] = None
    # OOM-admission retry budget (Request.max_retries). None = retry until
    # load_timeout_s (the flat-deadline behavior); shared entries keep the
    # most generous requester's budget.
    max_retries: Optional[int] = None
    # the daemon map key this entry is registered under, so terminal
    # transitions (DROPPED/FAILED) can drop it from _entries/_fn_index
    ekey: Optional[Tuple[str, str, Optional[str]]] = None
    # bytes_loaded/loads are counted when the load COMPLETES (a failed or
    # cancelled load moved nothing the caller can use); this flag keeps a
    # host->device re-promotion from double-counting the entry.
    stats_counted: bool = False
    # fault injection (docs/resilience.md): a poisoned entry's db leg
    # fails AFTER consuming its db bandwidth (the fault costs the link
    # what a real corrupt fetch would)
    poisoned: bool = False
    # gray-failure injection: extra seconds the db leg stalls while
    # HOLDING its loader slot (Request.jitter_s — the LoaderJitter draw);
    # consumed once, so a preempted leg's continuation never re-stalls
    jitter_s: float = 0.0
    # resumable loader state machine: "db" (db->host leg, incl. host
    # admission) or "pcie" (host->device leg, incl. device admission). A
    # preempted leg re-queues _load_full, which dispatches on this phase so
    # the continuation resumes mid-chain without re-running finished legs.
    load_phase: str = "db"
    # the chunked streams driving each leg; progress (moved bytes) survives
    # pause/resume, and cancel freezes it (byte-exact link accounting)
    db_stream: Optional[TransferStream] = None
    pcie_stream: Optional[TransferStream] = None

    # how much of the streams' preemption/stall totals has already been
    # attributed to SOME record (claim-once: concurrent sharers of one
    # entry must not each report the same pause — parity with the sim
    # twin, which attributes a pause to the loading record only)
    attributed_preemptions: int = 0
    attributed_stalled_s: float = 0.0

    def __post_init__(self):
        self.ready = threading.Event()

    # transfer telemetry (per-record preemptions/stalled_s attribution)
    def transfer_preemptions(self) -> int:
        return sum(s.preemptions for s in (self.db_stream, self.pcie_stream)
                   if s is not None)

    def transfer_stalled_s(self) -> float:
        return sum(s.stalled_s for s in (self.db_stream, self.pcie_stream)
                   if s is not None)


class OutOfDeviceMemory(RuntimeError):
    pass


class DataLoadError(RuntimeError):
    """A declared datum could not be brought to device: database fault,
    device admission past the deadline, or cancellation. Raised from
    ``Handle.wait()`` (and therefore ``KernelExecutor.launch``) so callers
    fail fast instead of blocking forever on a dead loader."""

    def __init__(self, key: str, reason: str, cause: Optional[BaseException] = None):
        super().__init__(f"load of {key!r} failed: {reason}")
        self.key = key
        self.reason = reason
        self.cause = cause


class NodeLostError(DataLoadError):
    """The node serving this entry crashed (fault injection or health
    eviction, docs/resilience.md). Subclasses :class:`DataLoadError` so
    every existing typed-error path handles it; carries its own type name
    so telemetry classifies it ``node_lost`` and the gateway's eviction
    layer knows the failure is re-dispatchable."""


class _LoadCancelled(Exception):
    """Internal: the entry was released while its load was in flight."""


class Handle:
    """What the taxon shim hands the function for a memory call — resolved
    by the kernel executor right before launch (§5.2.2)."""

    def __init__(self, entry: Entry, daemon: "MemoryDaemon"):
        self.entry = entry
        self.daemon = daemon

    def is_ready(self) -> bool:
        return self.entry.ready.is_set() and self.entry.error is None

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self.entry.ready.wait(timeout):
            raise TimeoutError(f"data {self.entry.key} not ready")
        err = self.entry.error
        if err is not None:
            if isinstance(err, DataLoadError):
                raise err
            raise DataLoadError(self.entry.key, str(err), err)
        return self.entry.dev_obj

    @property
    def size(self) -> int:
        return self.entry.size


class LoaderPool:
    """Fixed-size pool of loader workers over a **priority queue**. Bounds
    db/PCIe concurrency to ``size`` and exposes the observed high-water mark
    so tests (and the virtual-time twin) can assert the bound holds.

    Jobs are popped in :data:`AdmissionKey` order — with FIFO keys this is
    exactly the old arrival-order queue; with EDF keys the queued job with
    the highest priority / tightest deadline runs next. Ordering applies to
    *queued* jobs only: a job already running on a worker is never
    preempted."""

    def __init__(self, size: int):
        self.size = max(1, int(size))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._heap: List[Tuple[AdmissionKey, Callable[[], None]]] = []
        self._threads: List[threading.Thread] = []
        self._started = False
        self._shutdown = False
        self.in_flight = 0
        self.max_in_flight = 0

    @property
    def depth(self) -> int:
        """Queued + running jobs (the dispatch-pressure signal)."""
        with self._lock:
            return len(self._heap) + self.in_flight

    def head_key(self) -> Optional[AdmissionKey]:
        """The tightest QUEUED job's key (the link arbiter's demand signal;
        ``None`` when no job waits for a worker)."""
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def submit(self, job: Callable[[], None], key: AdmissionKey) -> None:
        with self._cv:
            if not self._shutdown and not self._started:
                self._started = True
                for i in range(self.size):
                    t = threading.Thread(
                        target=self._worker, name=f"sage-loader-{i}", daemon=True
                    )
                    t.start()
                    self._threads.append(t)
            down = self._shutdown
            if not down:
                # enqueue while still holding the lock: a concurrent
                # shutdown() would otherwise wake every worker into exit
                # first and park this job forever
                heapq.heappush(self._heap, (key, job))
                self._cv.notify()
        if down:
            # pool already shut down: degrade to a synchronous load so the
            # waiter still resolves — never park a job no worker will run
            job()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._shutdown:
                    self._cv.wait()
                if not self._heap:
                    return  # shutdown and fully drained
                _, job = heapq.heappop(self._heap)
                self.in_flight += 1
                self.max_in_flight = max(self.max_in_flight, self.in_flight)
            try:
                job()
            finally:
                with self._lock:
                    self.in_flight -= 1

    def shutdown(self) -> None:
        with self._cv:
            if self._shutdown:
                return
            self._shutdown = True
            self._cv.notify_all()


class _IdleThreads:
    """Runs each job at once, as a thread of its own would (no job waits
    for another), on a daemon thread that is idle where one is, else on a
    new one; a thread stays for later jobs. The unpooled (baseline)
    daemons' loads run here: a new thread a load ended right beside the
    request's forward, whose host issue it at times slowed by up to 16 %
    on an H100 80GB HBM3 at 700 W (PERF.md §6)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._jobs: "queue.SimpleQueue[Callable[[], None]]" = queue.SimpleQueue()
        self._idle = 0

    def submit(self, job: Callable[[], None]) -> None:
        with self._lock:
            spawn = self._idle == 0
            if not spawn:
                self._idle -= 1  # that thread takes this job
        if spawn:
            threading.Thread(target=self._work, name="sage-unpooled-loader",
                             daemon=True).start()
        self._jobs.put(job)

    def _work(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                job()
            except BaseException:  # reported as a thread's death is, the thread kept
                threading.excepthook(threading.ExceptHookArgs(
                    (*sys.exc_info(), threading.current_thread())))
            with self._lock:
                self._idle += 1


_unpooled_loads = _IdleThreads()


class MemoryDaemon:
    """Threaded real-mode daemon (virtual-time policy twin lives in
    ``core.simulator``; both share this module's accounting semantics)."""

    def __init__(
        self,
        paths: DataPaths,
        database,
        *,
        device_capacity: int = 40 << 30,  # A100-40GB (v5e would be 16 GiB)
        host_capacity: int = 125 << 30,
        clock=None,
        loader_threads: int = 4,
        load_timeout_s: float = 30.0,
        pooled: bool = True,
        time_scale: float = 1.0,
        scheduler: str = "fifo",
        transfer: str = "run_to_completion",
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    ):
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; use one of {SCHEDULERS}")
        if transfer not in TRANSFER_MODES:
            raise ValueError(
                f"unknown transfer mode {transfer!r}; use one of {TRANSFER_MODES}")
        self.paths = paths
        self.db = database
        self.clock = clock or RealClock()
        self.capacity = device_capacity
        self.host_capacity = host_capacity
        self.time_scale = time_scale
        self.loader_threads = loader_threads
        self.load_timeout_s = load_timeout_s
        self.scheduler = scheduler
        # SAGE's unified daemon bounds loading on the worker pool; baseline
        # platforms (FixedGSL/DGSF) have no such daemon — each invocation
        # streams in its own container — so the runtime constructs their
        # daemon with pooled=False (matching the simulator twin and keeping
        # the Fig-4 contention regime reproducible).
        self.pooled = pooled
        self._lock = threading.RLock()
        self._mem_free = threading.Condition(self._lock)
        self._pool = LoaderPool(loader_threads)
        # link arbiter: demand = the tightest job waiting for a loader
        # worker. Preemption only ever fires for pooled (SAGE) daemons —
        # thread-per-load baselines keep the pool queue empty, so the
        # demand signal is always None there. (docs/dataplane.md)
        self.arbiter = LinkArbiter(transfer, chunk_bytes,
                                   demand=self._pool.head_key)
        self._entries: Dict[Tuple[str, str, Optional[str]], Entry] = {}
        # per-function index over _entries, maintained on every insert —
        # function_entries/demote/drop/evictable and the dispatch residency
        # snapshot are O(that function's entries), not O(all entries)
        self._fn_index: Dict[str, Dict[Tuple[str, str, Optional[str]], Entry]] = {}
        self.device_used = 0
        self.host_used = 0
        self.context_bytes_used = 0
        self._evictable_cb: Optional[Callable[[], List["Entry"]]] = None
        self._key_seq = itertools.count()
        # device-admission waiters, (AdmissionKey, nbytes), ordered by key:
        # under OOM backpressure the head waiter is served first (tightest
        # slack under "edf", arrival order under "fifo") instead of whoever
        # wakes first; later waiters may only BACKFILL free bytes no waiter
        # ahead of them could use
        self._waiters: List[Tuple[AdmissionKey, int]] = []
        self.stats = {"shared_hits": 0, "loads": 0, "bytes_loaded": 0,
                      "host_promotions": 0, "evictions": 0,
                      "host_evictions": 0, "load_failures": 0,
                      "load_cancellations": 0, "oom_retries": 0,
                      "preemptions": 0, "node_crashes": 0}
        # fault-injection state (docs/resilience.md): ``dead`` fails every
        # new prepare/admission with a typed NodeLostError and aborts
        # in-flight loads; ``db_down`` fails db-leg loads fast. Both are
        # driven by the resilience plane (repro_torch.core.faults) — never set
        # on the default path.
        self.dead = False
        self.dead_reason = ""
        self.db_down = False
        # MemoryLeak injection (docs/resilience.md, "Gray failures"):
        # ownerless device bytes creeping up under the injector's timer.
        # Always 0 on the default path; reclaim gives them back exactly.
        self.leaked_bytes = 0

    @property
    def max_inflight_loads(self) -> int:
        return self._pool.max_in_flight

    @property
    def transfer(self) -> str:
        return self.arbiter.mode

    def set_transfer(self, transfer: str) -> None:
        """Switch the transfer mode ("run_to_completion"|"preemptive");
        applies to chunks advanced after the call (an in-flight stream
        simply stops/starts observing yield points)."""
        self.arbiter.set_mode(transfer)

    def claim_transfer_attribution(self, handles: Dict[str, "Handle"]
                                   ) -> Tuple[int, float]:
        """(preemptions, stalled_s) of ``handles``'s entries not yet
        attributed to any record. Each pause/stall is claimed exactly
        once across concurrent sharers of an entry (whoever finishes
        first), so Telemetry totals match ``stats["preemptions"]`` and
        the sim twin's loading-record-only convention."""
        p_total, s_total = 0, 0.0
        with self._lock:
            for h in handles.values():
                e = h.entry
                p, s = e.transfer_preemptions(), e.transfer_stalled_s()
                dp = p - e.attributed_preemptions
                ds = s - e.attributed_stalled_s
                if dp > 0:
                    p_total += dp
                    e.attributed_preemptions = p
                if ds > 0:
                    s_total += ds
                    e.attributed_stalled_s = s
        return p_total, s_total

    def shutdown(self) -> None:
        self._pool.shutdown()

    # ------------------------------------------------------------------
    # fault injection: node crash / restore (docs/resilience.md)
    # ------------------------------------------------------------------
    def crash(self, reason: str = "node crashed") -> None:
        """Kill the node: every tracked entry fails with a typed
        :class:`NodeLostError` and its accounting rolls back exactly.
        In-flight loaders are *cancelled* (their next checkpoint aborts
        and rolls back their own bytes — the same no-leak path release()
        uses); terminal entries are failed in place. Contexts/slots held
        by engines are NOT touched here — ``SageRuntime.crash`` destroys
        the instances through the engine's own release paths."""
        with self._lock:
            if self.dead:
                return
            self.dead = True
            self.dead_reason = reason
            self.stats["node_crashes"] += 1
            for e in list(self._entries.values()):
                if e.tier in (Tier.LOADING_HOST, Tier.LOADING_DEV):
                    # pre-set the typed error, THEN cancel: _abort only
                    # fills error when it is None, so the loader's
                    # rollback keeps NodeLostError (not "cancelled")
                    if e.error is None:
                        e.error = NodeLostError(e.key, reason)
                    e.cancelled = True
                else:
                    self._rollback_accounting(e)
                    e.tier = Tier.FAILED
                    self._unindex_entry(e)
                    if e.error is None:
                        e.error = NodeLostError(e.key, reason)
                    e.ready.set()
            # leaked bytes have no owning entry — the teardown reclaims
            # them here (the sim twin's _teardown zeroes them the same way)
            self.device_used -= self.leaked_bytes
            self.leaked_bytes = 0
            self._mem_free.notify_all()

    def restore(self) -> None:
        """Node rejoins (cold: the crash already emptied every tier)."""
        with self._lock:
            self.dead = False
            self.dead_reason = ""

    # ------------------------------------------------------------------
    # fault injection: memory-leak creep (docs/resilience.md)
    # ------------------------------------------------------------------
    def inject_leak(self, nbytes: int) -> None:
        """One MemoryLeak tick: ``device_used`` creeps up with no owning
        entry, squeezing admission headroom (no notify — pressure only
        rises from a leak)."""
        with self._lock:
            if self.dead:
                return
            self.leaked_bytes += nbytes
            self.device_used += nbytes

    def reclaim_leak(self) -> None:
        """Leak window closed (or injector torn down): give the bytes
        back exactly and wake parked admission waiters."""
        with self._lock:
            freed, self.leaked_bytes = self.leaked_bytes, 0
            if freed:
                self.device_used -= freed
                self._mem_free.notify_all()

    # ------------------------------------------------------------------
    # per-function entry index (function_entries, exit ladder, residency)
    # ------------------------------------------------------------------
    def _index_entry(self, ekey: Tuple[str, str, Optional[str]],
                     e: Entry) -> None:
        """Insert into _entries AND the per-function index (call with the
        lock held). A re-prepare of a DROPPED/FAILED key replaces the old
        entry in both maps, so the two views never diverge."""
        e.ekey = ekey
        self._entries[ekey] = e
        self._fn_index.setdefault(ekey[0], {})[ekey] = e

    def _unindex_entry(self, e: Entry) -> None:
        """Remove a terminally DROPPED/FAILED entry from both maps (call
        with the lock held) so the per-function index stays bounded by the
        LIVE entries — dispatch calls ``residency()`` on every node per
        arrival, and dead uuid-keyed writable entries would otherwise
        accumulate one per request forever. Identity-guarded: a key
        re-prepared since never deletes its replacement. Outstanding
        ``Handle``s keep their direct reference to the dead entry."""
        k = e.ekey
        if k is None or self._entries.get(k) is not e:
            return
        del self._entries[k]
        per_fn = self._fn_index.get(k[0])
        if per_fn is not None:
            per_fn.pop(k, None)
            if not per_fn:
                del self._fn_index[k[0]]

    # ------------------------------------------------------------------
    # dispatch snapshot (docs/cluster.md): cheap residency/pressure reads
    # ------------------------------------------------------------------
    def residency(self, function: str) -> Tuple[str, int]:
        """(best tier, resident bytes) of ``function``'s read-only data:
        ``"device"`` > ``"loading"`` (an in-flight load a new invocation
        can attach to) > ``"host"`` > ``"none"``. Takes the daemon lock,
        walks only the per-function index, and never blocks on in-flight
        loads (loaders hold the lock only at accounting checkpoints)."""
        best, nbytes = 0, 0
        rank = {Tier.HOST: 1, Tier.LOADING_HOST: 2, Tier.LOADING_DEV: 2,
                Tier.DEVICE: 3}
        with self._lock:
            for e in self._fn_index.get(function, {}).values():
                r = rank.get(e.tier, 0)
                if not e.read_only or r == 0:
                    continue
                nbytes += e.size
                best = max(best, r)
        return ("none", "host", "loading", "device")[best], nbytes

    def pressure(self) -> Dict[str, int]:
        """Dispatch-pressure counters (NodeSnapshot fields minus identity/
        residency); one lock acquisition, O(1)."""
        with self._lock:
            return {
                "device_free": max(self.capacity - self.device_used, 0),
                "device_capacity": self.capacity,
                "pending_admissions": len(self._waiters),
                "loader_queue": self._pool.depth if self.pooled else 0,
                "loader_threads": self.loader_threads,
            }

    # ------------------------------------------------------------------
    # SLO-aware admission keys
    # ------------------------------------------------------------------
    def request_slo(self, request: Request) -> Tuple[int, Optional[float]]:
        """(priority, absolute deadline) of a request on this daemon's clock
        timeline (``arrival_t + deadline_s``; arrival falls back to now)."""
        if request.deadline_s is None:
            return request.priority, None
        base = request.arrival_t if request.arrival_t is not None \
            else self.clock.now()
        return request.priority, base + request.deadline_s

    def _admission_key(self, priority: int = 0,
                       deadline_at: Optional[float] = None) -> AdmissionKey:
        seq = next(self._key_seq)
        if self.scheduler == "edf":
            return (-int(priority),
                    math.inf if deadline_at is None else float(deadline_at),
                    seq)
        return (0, 0.0, seq)  # fifo: pure arrival order

    def _entry_key(self, e: Entry) -> AdmissionKey:
        return self._admission_key(e.priority, e.deadline_at)

    def _submit_load(self, job: Callable[[], None],
                     key: AdmissionKey) -> None:
        if self.pooled:
            self._pool.submit(job, key)
        else:
            _unpooled_loads.submit(job)

    # ------------------------------------------------------------------
    # device memory accounting (contexts + data)
    # ------------------------------------------------------------------
    def _reserve_device(self, nbytes: int) -> None:
        with self._lock:
            if self.device_used + nbytes > self.capacity:
                freed = self._evict(nbytes - (self.capacity - self.device_used))
                if self.device_used + nbytes > self.capacity:
                    raise OutOfDeviceMemory(
                        f"need {nbytes}, used {self.device_used}/{self.capacity} "
                        f"(freed {freed})"
                    )
            self.device_used += nbytes

    def _release_device(self, nbytes: int) -> None:
        with self._lock:
            self.device_used -= nbytes
            self._mem_free.notify_all()

    def _reserve_device_blocking(
        self, nbytes: int, deadline: float, entry: Optional[Entry] = None,
        key: Optional[AdmissionKey] = None,
        max_retries: Optional[int] = None,
    ) -> None:
        """Admission with backpressure: on OOM, wait for releases/evictions
        (``_mem_free`` is notified by every release) and retry until the
        deadline, then re-raise :class:`OutOfDeviceMemory`. Aborts promptly
        with :class:`_LoadCancelled` if ``entry`` gets cancelled meanwhile.

        Waiters are ordered by ``key`` (:data:`AdmissionKey`): the head of
        the waiter heap is served first, so freed memory goes to the
        tightest-slack waiter under ``scheduler="edf"`` (and to strict
        arrival order under ``"fifo"``) instead of whichever thread happens
        to wake first. A non-head waiter may only **backfill**: it admits
        itself (without eviction) when the currently free bytes are of no
        use to anyone ahead of it, so a huge parked head never makes a
        small request time out while memory sits idle. No starvation
        either way: every wait is bounded by ``load_timeout_s``.

        ``deadline`` is on ``time.monotonic()`` — Condition.wait sleeps in
        wall-clock time, so the deadline must too (an injected virtual
        clock would otherwise never advance and the loop would spin
        forever).

        ``max_retries`` (or ``entry.max_retries``, re-read every attempt so
        a sharer attaching mid-wait can widen it) bounds the **failed head
        admission attempts that follow a memory event**: ``0`` fails typed
        on the first OOM (fail-fast), ``N`` allows N re-admissions after
        releases/evictions (pure poll-slice wakes don't consume the
        budget — parity with the sim twin's per-kick accounting), ``None``
        retries until the deadline (the flat ``load_timeout_s`` behavior)."""
        if key is None:
            key = (self._entry_key(entry) if entry is not None
                   else self._admission_key())
        failed_attempts = 0
        # budget accounting mirrors the sim twin exactly: the INITIAL
        # attempt counts whether or not this waiter starts at the head
        # (GPUNode.reserve charges its inline attempt before queueing), and
        # afterwards only HEAD attempts that follow a NOTIFIED wake (a
        # release/eviction — an actual memory event) consume it, the twin
        # of one charge per kick(). Pure 50 ms poll slices never burn it.
        counted_wake = True
        initial_attempt = True
        waiter = (key, nbytes)
        with self._mem_free:
            heapq.heappush(self._waiters, waiter)
            try:
                while True:
                    if self.dead:
                        raise NodeLostError(
                            entry.key if entry is not None else "device",
                            self.dead_reason or "node crashed")
                    if entry is not None and entry.cancelled:
                        raise _LoadCancelled()
                    if self._waiters[0] == waiter:  # we are the head waiter
                        try:
                            self._reserve_device(nbytes)
                            if entry is not None:
                                entry.dev_reserved = True
                            return
                        except OutOfDeviceMemory:
                            # an impossible request (bigger than the whole
                            # device) can never be admitted: fail it now
                            # instead of squatting at the head of the queue
                            # until its deadline starves everyone behind it
                            if nbytes > self.capacity:
                                raise
                            if deadline - time.monotonic() <= 0:
                                raise
                            if counted_wake:
                                failed_attempts += 1
                                # re-read the budget every attempt: a later
                                # sharer attaching to the entry may have
                                # widened it (prepare() under this lock),
                                # and a stale snapshot would fail a shared
                                # load its most generous requester allows
                                budget = (entry.max_retries
                                          if entry is not None else max_retries)
                                if budget is not None and failed_attempts > budget:
                                    # per-request retry budget exhausted:
                                    # fail typed now instead of burning the
                                    # rest of the flat deadline
                                    raise
                            # only a failed head ATTEMPT is an OOM retry;
                            # non-head waiters below are just queued behind
                            # the scheduler's ordering, not behind memory
                            self.stats["oom_retries"] += 1
                    else:
                        free = self.capacity - self.device_used
                        if nbytes <= free and all(
                                w_bytes > free
                                for w_key, w_bytes in self._waiters
                                if w_key < key):
                            # backfill (no eviction): nobody ahead can use
                            # these free bytes RIGHT NOW. Tradeoff, same as
                            # the seed's racing admission: under a steady
                            # small-request stream a big head may never see
                            # bytes accumulate — but the head keeps
                            # exclusive eviction rights, and every wait is
                            # deadline-bounded either way.
                            self._reserve_device(nbytes)
                            if entry is not None:
                                entry.dev_reserved = True
                            return
                        if deadline - time.monotonic() <= 0:
                            raise OutOfDeviceMemory(
                                f"need {nbytes}, used {self.device_used}/"
                                f"{self.capacity} (queued behind "
                                f"{len(self._waiters) - 1} waiters)"
                            )
                        if initial_attempt:
                            # the first failed opportunity charges the
                            # budget even when queued behind other waiters
                            # — a budget of 0 must fail-fast here exactly
                            # like the sim's inline reserve() attempt, not
                            # wait to reach the head of the queue
                            failed_attempts += 1
                            budget = (entry.max_retries
                                      if entry is not None else max_retries)
                            if budget is not None and failed_attempts > budget:
                                raise OutOfDeviceMemory(
                                    f"need {nbytes}, used {self.device_used}/"
                                    f"{self.capacity} (retry budget "
                                    f"{budget} exhausted behind "
                                    f"{len(self._waiters) - 1} waiters)"
                                )
                    # short slices so deadlines and cancellation are
                    # observed even if a notify is missed; wait() returns
                    # True only when notified (a memory event) — a plain
                    # timeout slice must not consume the retry budget
                    initial_attempt = False
                    remaining = deadline - time.monotonic()
                    counted_wake = self._mem_free.wait(
                        timeout=min(max(remaining, 0.001), 0.05))
            finally:
                self._waiters.remove(waiter)
                heapq.heapify(self._waiters)
                self._mem_free.notify_all()  # a new head may now proceed

    # public admission API (the engine's slot/context accounting goes
    # through these — no more reaching into _release_device)
    def reserve_slot(self, nbytes: int, *, timeout: Optional[float] = None,
                     priority: int = 0,
                     deadline_at: Optional[float] = None,
                     max_retries: Optional[int] = None) -> None:
        """Blocking slot reservation with eviction + backpressure; raises
        OutOfDeviceMemory once the deadline passes OR the per-request
        ``max_retries`` budget is exhausted (None = deadline only).
        ``priority``/``deadline_at`` order the wait under ``scheduler="edf"``."""
        t = self.load_timeout_s if timeout is None else timeout
        self._reserve_device_blocking(
            nbytes, time.monotonic() + t,
            key=self._admission_key(priority, deadline_at),
            max_retries=max_retries)

    def release_slot(self, nbytes: int) -> None:
        self._release_device(nbytes)

    def reserve_context(self, nbytes: int = GPU_CONTEXT_BYTES, *,
                        priority: int = 0,
                        deadline_at: Optional[float] = None,
                        max_retries: Optional[int] = None) -> None:
        self.reserve_slot(nbytes, priority=priority, deadline_at=deadline_at,
                          max_retries=max_retries)
        with self._lock:
            self.context_bytes_used += nbytes

    def try_reserve_context(self, nbytes: int) -> bool:
        """Reserve ``nbytes`` of context memory only if they are free now:
        no eviction and no wait, and nothing on a crashed node. Returns
        whether they were reserved (``release_context`` gives them back)."""
        with self._lock:
            if self.dead or self.device_used + nbytes > self.capacity:
                return False
            self.device_used += nbytes
            self.context_bytes_used += nbytes
            return True

    def release_context(self, nbytes: int = GPU_CONTEXT_BYTES) -> None:
        self._release_device(nbytes)
        with self._lock:
            self.context_bytes_used -= nbytes

    # ------------------------------------------------------------------
    # host-tier admission (the host ceiling is enforced, not advisory)
    # ------------------------------------------------------------------
    def _admit_host(self, nbytes: int) -> bool:
        """Account ``nbytes`` against ``host_capacity`` (call with the lock
        held). Past the ceiling, evict refcount-0 HOST-tier entries (LRU)
        first; returns False when the bytes still do not fit."""
        if self.host_used + nbytes > self.host_capacity:
            victims = sorted(
                (e for e in self._entries.values()
                 if e.tier is Tier.HOST and e.refcount == 0
                 and e.host_accounted),
                key=lambda e: e.last_used,
            )
            for v in victims:
                if self.host_used + nbytes <= self.host_capacity:
                    break
                v.tier = Tier.DROPPED
                self._unindex_entry(v)
                v.ready.clear()
                self.host_used -= v.size
                v.host_accounted = False
                v.host_obj = None
                self.stats["host_evictions"] += 1
        if self.host_used + nbytes > self.host_capacity:
            return False
        self.host_used += nbytes
        return True

    def set_evictable_provider(self, cb: Callable[[], List[Entry]]) -> None:
        """Lesson-3 cache policy: the runtime tells the daemon which cached
        (stage-1/2, refcount-0) entries may be evicted for new arrivals."""
        self._evictable_cb = cb

    def _evict(self, need: int) -> int:
        freed = 0
        if not self._evictable_cb:
            return 0
        victims = sorted(self._evictable_cb(), key=lambda e: e.last_used)
        for e in victims:
            if freed >= need:
                break
            if e.refcount == 0 and e.tier is Tier.DEVICE:
                e.tier = Tier.DROPPED
                self._unindex_entry(e)
                e.ready.clear()
                e.dev_obj = None
                if e.dev_reserved:
                    self.device_used -= e.size
                    e.dev_reserved = False
                if e.host_accounted:
                    self.host_used -= e.size
                    e.host_accounted = False
                e.host_obj = None
                freed += e.size
                self.stats["evictions"] += 1
        if freed:
            self._mem_free.notify_all()
        return freed

    # ------------------------------------------------------------------
    # prepare / attach (the proactive, parallel half)
    # ------------------------------------------------------------------
    def prepare(self, request: Request, *, system_shares_ro: bool = True) -> Dict[str, Handle]:
        """Start async loads for every declared datum; return handles now.

        Read-only data is deduplicated across invocations of the same
        function iff ``system_shares_ro`` (SAGE yes; baselines no). The
        request's SLO metadata rides on every load job: under
        ``scheduler="edf"`` the loader queue and the OOM-admission wait both
        serve the tightest-slack job first, and attaching to an in-flight
        shared entry tightens that entry's key for its *future* admission
        waits (the already-queued pool job keeps its enqueue-time key)."""
        prio, deadline_at = self.request_slo(request)
        handles: Dict[str, Handle] = {}
        if self.dead:
            # dead node: hand back already-failed typed handles so the
            # caller's wait() fails fast instead of parking on a daemon
            # that will never load (the eviction layer re-dispatches)
            for d in request.loadable():
                e = Entry(function=request.function_name, key=d.key,
                          size=d.size, read_only=False, tier=Tier.FAILED,
                          error=NodeLostError(
                              d.key, self.dead_reason or "node crashed"))
                e.ready.set()
                handles[d.key] = Handle(e, self)
            return handles
        for d in request.loadable():
            shared = d.read_only and system_shares_ro
            ekey = (request.function_name, d.key, None if shared else request.uuid)
            with self._lock:
                e = self._entries.get(ekey)
                if e is not None and e.tier not in (Tier.DROPPED, Tier.FAILED):
                    e.refcount += 1
                    e.last_used = self.clock.now()
                    e.priority = max(e.priority, prio)
                    if deadline_at is not None:
                        e.deadline_at = (deadline_at if e.deadline_at is None
                                         else min(e.deadline_at, deadline_at))
                    if e.max_retries is not None:
                        # most generous requester wins: a budget-less
                        # attacher must not fail a shared load early
                        e.max_retries = (
                            None if request.max_retries is None
                            else max(e.max_retries, request.max_retries))
                    self.stats["shared_hits"] += 1
                    handles[d.key] = Handle(e, self)
                    if e.tier is Tier.HOST:
                        # promote host -> device (PCIe only; no db re-read):
                        # stage-2 warm hit of the exit ladder. The chain
                        # restarts at the "pcie" phase with a FRESH stream —
                        # the previous promotion's stream already ran to
                        # done and must not satisfy this leg for free.
                        # Dropping it also retires its share of the
                        # attributed counters, or the fresh stream's
                        # pauses would hide behind the stale claim level.
                        e.tier = Tier.LOADING_DEV
                        e.load_phase = "pcie"
                        if e.pcie_stream is not None:
                            e.attributed_preemptions = max(
                                e.attributed_preemptions
                                - e.pcie_stream.preemptions, 0)
                            e.attributed_stalled_s = max(
                                e.attributed_stalled_s
                                - e.pcie_stream.stalled_s, 0.0)
                        e.pcie_stream = None
                        self.stats["host_promotions"] += 1
                        self._submit_load(lambda e=e: self._load_full(e),
                                          self._entry_key(e))
                    continue
                e = Entry(
                    function=request.function_name, key=d.key, size=d.size,
                    read_only=shared, refcount=1,
                    priority=prio, deadline_at=deadline_at,
                    max_retries=request.max_retries,
                    poisoned=request.fault_injected,
                    jitter_s=request.jitter_s,
                )
                e.last_used = self.clock.now()
                self._index_entry(ekey, e)
                handles[d.key] = Handle(e, self)
            self._submit_load(lambda e=e: self._load_full(e),
                              self._entry_key(e))
        return handles

    # ------------------------------------------------------------------
    # loader jobs (run on the bounded pool; never raise)
    # ------------------------------------------------------------------
    def _fail(self, e: Entry, reason: str, cause: Optional[BaseException]) -> None:
        with self._lock:
            self._rollback_accounting(e)
            e.tier = Tier.FAILED
            self._unindex_entry(e)
            if e.error is None:
                e.error = (cause if isinstance(cause, DataLoadError)
                           else DataLoadError(e.key, reason, cause))
            self.stats["load_failures"] += 1
            e.ready.set()
            self._mem_free.notify_all()

    def _abort(self, e: Entry) -> None:
        with self._lock:
            self._rollback_accounting(e)
            e.tier = Tier.DROPPED
            self._unindex_entry(e)
            if e.error is None:
                e.error = DataLoadError(e.key, "cancelled: released while loading")
            self.stats["load_cancellations"] += 1
            e.ready.set()
            self._mem_free.notify_all()

    def _rollback_accounting(self, e: Entry) -> None:
        if e.dev_reserved:
            self.device_used -= e.size
            e.dev_reserved = False
        if e.host_accounted:
            self.host_used -= e.size
            e.host_accounted = False
        e.host_obj = e.dev_obj = None
        # freeze the legs' byte accounting: a cancelled/failed stream
        # charges the link only for the chunks it actually moved
        for st in (e.db_stream, e.pcie_stream):
            if st is not None:
                st.cancel()

    def _entry_prefix(self, e: Entry) -> Tuple[int, float]:
        """The entry's urgency prefix under the ACTIVE scheduler — built
        the same way the pool's queued keys are, so the arbiter compares
        like with like. Under "fifo" every prefix is (0, 0.0): nothing is
        ever strictly tighter and preemption never fires."""
        if self.scheduler == "edf":
            return (-int(e.priority),
                    math.inf if e.deadline_at is None else float(e.deadline_at))
        return (0, 0.0)

    def _drive_stream(self, e: Entry, attr: str, broker) -> bool:
        """Advance the leg's stream to completion in arbiter-sized chunks.

        Returns ``True`` when the leg finished; ``False`` when the stream
        **yielded** — a strictly tighter queued load preempted it, the
        stream paused (completed bytes kept), and the continuation was
        re-submitted to the pool under this entry's current key, freeing
        the worker for the tighter job. Raises :class:`_LoadCancelled`
        promptly when the entry is released mid-transfer."""
        st = getattr(e, attr)
        if st is None:
            st = broker.open_stream(e.size, scale=self.time_scale)
            setattr(e, attr, st)
        if st.paused_at is not None:  # continuation of a preempted leg
            st.resume(self.clock.now())
        # chunk only where a yield is possible: an unpooled (baseline)
        # daemon has no loader queue, so its demand signal is always None
        # and chunking would be ~250 pointless fair-share transactions
        # per 8 GB load
        while True:
            if e.cancelled:
                raise _LoadCancelled()
            # re-read per chunk: a degradation window opening (or closing)
            # mid-stream re-paces the remaining chunks so the preemption
            # latency bound holds on the slowed link
            chunk = self.arbiter.chunk_hint(st.broker) if self.pooled else None
            st.advance(chunk)
            if st.done:
                return True
            if e.cancelled:
                raise _LoadCancelled()
            if self.arbiter.should_yield(self._entry_prefix(e)):
                st.pause(self.clock.now())
                # stats (not arbiter.preemptions) is the threaded driver's
                # authoritative counter: it increments under the daemon
                # lock, while the arbiter's is for the single-threaded sim
                with self._lock:
                    self.stats["preemptions"] += 1
                self._submit_load(lambda e=e: self._load_full(e),
                                  self._entry_key(e))
                return False

    def _load_full(self, e: Entry) -> None:
        """Resumable db->host->device chain: dispatches on ``e.load_phase``
        so a preempted leg's continuation (or a host->device promotion,
        which starts at phase "pcie") resumes exactly where it left off."""
        if e.load_phase == "db":
            if e.jitter_s > 0.0:
                # injected loader jitter (docs/resilience.md, "Gray
                # failures"): stall the db leg while HOLDING the loader
                # slot — the pathology is the wedged worker, same as the
                # sim twin's jitter delay. The db_down check runs after
                # the stall elapses, mirroring the sim's event order.
                j, e.jitter_s = e.jitter_s, 0.0
                self.clock.sleep(j * self.time_scale)
                with self._lock:
                    if e.cancelled:
                        self._abort(e)
                        return
            if self.db_down:
                # flapping db (fault injection): fail the leg fast and
                # typed — no bandwidth was moved, so nothing to roll back
                # beyond the standard accounting path
                self._fail(e, "db link down", None)
                return
            # database -> host (db path contention): the transfer is a
            # chunked stream over the db broker; the payload lookup itself
            # is un-brokered (its timing is the stream)
            try:
                if not self._drive_stream(e, "db_stream", self.paths.db):
                    return  # yielded; continuation re-queued
                payload = self.db.fetch(e.key, None)
            except _LoadCancelled:
                self._abort(e)
                return
            except Exception as exc:  # noqa: BLE001 — propagated via the entry
                self._fail(e, "database fetch failed", exc)
                return
            if e.poisoned:
                # injected loader fault: the db leg ran to completion (the
                # corrupt fetch cost the link its full bandwidth share)
                # and THEN fails — parity with the sim twin's poison point
                self._fail(e, "injected loader fault", None)
                return
            with self._lock:
                if e.cancelled:
                    self._abort(e)
                    return
                # host admission: the host ceiling is enforced — evict
                # refcount-0 HOST entries, then fail typed (the seed
                # incremented host_used unconditionally and overcommitted
                # the host tier without bound)
                if not self._admit_host(e.size):
                    self._fail(
                        e,
                        f"host admission failed: need {e.size}, used "
                        f"{self.host_used}/{self.host_capacity}",
                        None,
                    )
                    return
                e.host_obj = payload
                e.host_accounted = True
                # stay in a LOADING tier for the PCIe/admission leg: a tier
                # of HOST here would let release() take the rollback path
                # (instead of cancelling) while this loader still runs — it
                # would then reserve device bytes for a DROPPED entry and
                # leak them — and would let a concurrent shared hit
                # schedule a second PCIe leg
                e.tier = Tier.LOADING_DEV
                e.load_phase = "pcie"
        self._load_dev(e)

    def _load_dev(self, e: Entry) -> None:
        # host -> device (PCIe path contention), then admission with
        # backpressure: an OutOfDeviceMemory here used to kill the thread
        # and hang every waiter; now it retries until load_timeout_s and
        # then fails the entry with a typed error.
        try:
            if not self._drive_stream(e, "pcie_stream", self.paths.pcie):
                return  # yielded; continuation re-queued
            if e.cancelled:
                raise _LoadCancelled()
            self._reserve_device_blocking(
                e.size, time.monotonic() + self.load_timeout_s, entry=e
            )
            dev = self.db.to_device(e.host_obj)
        except _LoadCancelled:
            self._abort(e)
            return
        except Exception as exc:  # noqa: BLE001 — propagated via the entry
            self._fail(e, "device admission/materialization failed", exc)
            return
        with self._lock:
            if e.cancelled:
                self._abort(e)
                return
            e.dev_obj = dev
            e.tier = Tier.DEVICE
            # bytes moved are accounted on COMPLETION: a failed or
            # cancelled load rolls through _fail/_abort and never lands
            # here, so stats["loads"]/["bytes_loaded"] no longer overstate
            # the data actually delivered. The flag keeps a host->device
            # re-promotion from double-counting the entry.
            if not e.stats_counted:
                e.stats_counted = True
                self.stats["loads"] += 1
                self.stats["bytes_loaded"] += e.size
            e.ready.set()

    # ------------------------------------------------------------------
    # explicit allocation (cudaMalloc-style via the shim)
    # ------------------------------------------------------------------
    def alloc(self, request: Request, key: str, nbytes: int) -> Handle:
        """Shim ``cudaMalloc``: blocking admission with the same
        backpressure/deadline as every other reservation (it used to call
        the non-blocking path and raise on any transient pressure); raises
        :class:`OutOfDeviceMemory` only once ``load_timeout_s`` passes."""
        prio, deadline_at = self.request_slo(request)
        self._reserve_device_blocking(
            nbytes, time.monotonic() + self.load_timeout_s,
            key=self._admission_key(prio, deadline_at),
            max_retries=request.max_retries)
        e = Entry(function=request.function_name, key=key, size=nbytes,
                  read_only=False, tier=Tier.DEVICE, refcount=1,
                  priority=prio, deadline_at=deadline_at,
                  max_retries=request.max_retries)
        e.dev_reserved = True
        e.last_used = self.clock.now()
        e.ready.set()
        with self._lock:
            self._index_entry((request.function_name, key, request.uuid), e)
        return Handle(e, self)

    # ------------------------------------------------------------------
    # release / exit-ladder actions
    # ------------------------------------------------------------------
    def release(self, request: Request, handles: Dict[str, Handle]) -> None:
        """Invocation finished: writable data freed; read-only refcount--
        (entries stay cached on device for the exit ladder to manage).

        A writable entry still in a LOADING tier is *cancelled* instead of
        freed here — its loader owns the accounting and rolls it back at the
        next checkpoint, so the release/loader race cannot leak bytes."""
        with self._lock:
            for h in handles.values():
                e = h.entry
                e.refcount -= 1
                e.last_used = self.clock.now()
                if not e.read_only and e.refcount <= 0:
                    if e.tier in (Tier.LOADING_HOST, Tier.LOADING_DEV):
                        e.cancelled = True
                        continue
                    self._rollback_accounting(e)
                    if e.tier is not Tier.FAILED:
                        e.tier = Tier.DROPPED
                    self._unindex_entry(e)
            self._mem_free.notify_all()

    def function_entries(self, function: str) -> List[Entry]:
        """The LIVE entries tracked for ``function`` (terminal
        DROPPED/FAILED entries are unindexed at their transition) — O(that
        function's live entries) via the per-function index, not a scan of
        every entry on the daemon."""
        with self._lock:
            return list(self._fn_index.get(function, {}).values())

    def demote_to_host(self, function: str) -> int:
        """Exit stage 2: cached read-only device copies -> host RAM."""
        n = 0
        with self._lock:
            for e in self.function_entries(function):
                if e.read_only and e.refcount == 0 and e.tier is Tier.DEVICE:
                    e.tier = Tier.HOST
                    e.dev_obj = None
                    e.ready.clear()
                    if e.dev_reserved:
                        self.device_used -= e.size
                        e.dev_reserved = False
                    n += e.size
            if n:
                self._mem_free.notify_all()
        return n

    def drop_host(self, function: str) -> int:
        """Exit stage 4: host copies dropped."""
        n = 0
        with self._lock:
            for e in self.function_entries(function):
                if e.read_only and e.refcount == 0 and e.tier in (Tier.HOST, Tier.DEVICE):
                    self._rollback_accounting(e)
                    e.tier = Tier.DROPPED
                    self._unindex_entry(e)
                    e.ready.clear()
                    n += e.size
            if n:
                self._mem_free.notify_all()
        return n

    def evictable_entries(self, function: str) -> List[Entry]:
        return [
            e for e in self.function_entries(function)
            if e.read_only and e.refcount == 0 and e.tier is Tier.DEVICE
        ]
