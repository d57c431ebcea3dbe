"""The port's data plane (``repro_torch.core.{daemon,datapath,transfer}``,
``data.database``) held against the JAX package's, case by case: the cases
of tests/test_core.py (daemon sharing and refcounts, the policy table, the
bandwidth broker; the exit ladder's are in tests/test_torch_runtime.py),
tests/test_dataplane.py (failure propagation, OOM backpressure,
cancellation, host admission, EDF, retry budgets under a crash, hedge and
batch cancellation) and tests/test_transfer.py (chunked streams, the link
arbiter, preemption on both drivers, byte-exact cancels).

Virtual-time cases run the same scenario through both packages and assert
that every record and every counter is equal, then make the reference's
assertions on the port's run. Threaded cases (real time) make the
reference's assertions on the port with the same inputs, and hold the
port's stats key sets to the reference runtime's. Every runtime, database
and gateway here is on the CPU (``device="cpu"``)."""
import dataclasses
import functools
import importlib
import threading
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro_torch.api import FunctionSpec, Gateway  # noqa: E402
from repro_torch.core import daemon as daemon_mod  # noqa: E402
from repro_torch.core.baselines import SYSTEMS, get_system  # noqa: E402
from repro_torch.core.daemon import (  # noqa: E402
    DataLoadError, MemoryDaemon, OutOfDeviceMemory, Tier,
)
from repro_torch.core.datapath import BandwidthBroker, DataPaths  # noqa: E402
from repro_torch.core.request import Data, DataType, Request  # noqa: E402
from repro_torch.core.telemetry import InvocationRecord, Telemetry  # noqa: E402
from repro_torch.core.transfer import (  # noqa: E402
    TRANSFER_MODES, LinkArbiter, key_prefix,
)
from repro_torch.data.database import Database  # noqa: E402

MB = 1 << 20
CPU = dict(device="cpu")


# ---------------------------------------------------------------------------
# both packages
# ---------------------------------------------------------------------------

def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    sim, prof, faults = mod("core.simulator"), mod("core.profiles"), mod("core.faults")
    return SimpleNamespace(
        Simulator=sim.Simulator, SimFunction=sim.SimFunction,
        PROFILES=prof.PROFILES, FunctionProfile=prof.FunctionProfile,
        FaultPlan=faults.FaultPlan, NodeCrash=faults.NodeCrash,
        SlowNode=faults.SlowNode, VirtualClock=mod("core.clock").VirtualClock,
        BandwidthBroker=mod("core.datapath").BandwidthBroker,
        SYSTEMS=mod("core.baselines").SYSTEMS)


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def on_both(run):
    """``run(pkg)`` on the JAX package's control plane and the port's;
    returns (reference, port)."""
    return run(REF), run(PORT)


NODE_FIELDS = ("name", "capacity", "used", "host_used", "host_evictions",
               "inflight_loads", "max_inflight_loads", "load_failures",
               "loads", "bytes_loaded", "crashes", "healthy")


def sim_state(sim) -> dict:
    """Every record field by field, the run's counters and stats, and each
    node's books: equal between the packages for a deterministic run."""
    return {
        "records": [dataclasses.asdict(r) for r in sim.telemetry.snapshot()],
        "completed": sim.completed, "failed": sim.failed,
        "resilience": sim.resilience_stats(), "compute": sim.compute_stats(),
        "placement": sim.placement_stats(),
        "preemptions": sim.preemption_count(),
        "nodes": [{f: getattr(n, f) for f in NODE_FIELDS} for n in sim.nodes],
    }


def assert_same_sims(ref, sim):
    assert sim_state(sim) == sim_state(ref)


@functools.lru_cache(maxsize=None)
def ref_runtime_keys() -> dict:
    """The stats key sets of the reference's threaded runtime."""
    from repro.api import Gateway as RefGateway

    gw = RefGateway(backend="runtime", n_nodes=2, seed=0)
    try:
        node = gw._nodes[0]
        return {"daemon": frozenset(node.daemon.stats),
                "memory": frozenset(node.memory_usage()),
                "resilience": frozenset(gw.resilience_stats()),
                "compute": frozenset(gw.compute_stats())}
    finally:
        gw.shutdown()


def assert_runtime_keys(daemon=None, node=None, gw=None):
    keys = ref_runtime_keys()
    if daemon is not None:
        assert set(daemon.stats) == keys["daemon"]
    if node is not None:
        assert set(node.daemon.stats) == keys["daemon"]
        assert set(node.memory_usage()) == keys["memory"]
    if gw is not None:
        assert set(gw.resilience_stats()) == keys["resilience"]
        assert set(gw.compute_stats()) == keys["compute"]


# ---------------------------------------------------------------------------
# tests/test_core.py: daemon, policy table, broker
# ---------------------------------------------------------------------------

def _daemon(cap_mb=1024, db=None, **kw):
    db = db or Database(**CPU)
    paths = DataPaths.make(db_bw=1e12, pcie_bw=1e12)  # near-instant for tests
    return MemoryDaemon(paths, db, device_capacity=cap_mb * MB, **kw), db


def _req(fn="f", ro_mb=10, w_mb=2, db=None):
    req = Request(function_name=fn)
    if db is not None:
        db.put(f"{fn}/w", b"W", size=ro_mb * MB)
        db.put(f"{fn}/in/{req.uuid}", b"X", size=w_mb * MB)
    req.in_data = [
        Data(key=f"{fn}/w", size=ro_mb * MB, dtype=DataType.READ_ONLY),
        Data(key=f"{fn}/in/{req.uuid}", size=w_mb * MB, dtype=DataType.WRITABLE),
    ]
    return req


class TestDaemon:
    def test_read_only_shared_loaded_once(self):
        d, db = _daemon()
        r1, r2 = _req(db=db), _req(db=db)
        h1 = d.prepare(r1)
        h2 = d.prepare(r2)
        for h in (*h1.values(), *h2.values()):
            h.wait(5)
        # 1 shared weights entry + 2 private inputs = 3 loads; 1 shared hit
        assert d.stats["loads"] == 3
        assert d.stats["shared_hits"] == 1
        assert h1["f/w"].entry is h2["f/w"].entry
        assert_runtime_keys(daemon=d)

    def test_no_sharing_when_disabled(self):
        d, db = _daemon()
        r1, r2 = _req(db=db), _req(db=db)
        h1 = d.prepare(r1, system_shares_ro=False)
        h2 = d.prepare(r2, system_shares_ro=False)
        for h in (*h1.values(), *h2.values()):
            h.wait(5)
        assert d.stats["shared_hits"] == 0
        assert d.stats["loads"] == 4

    def test_release_refcounts_and_writable_freed(self):
        d, db = _daemon()
        r1 = _req(db=db)
        h1 = d.prepare(r1)
        for h in h1.values():
            h.wait(5)
        used_before = d.device_used
        d.release(r1, h1)
        # writable freed; read-only cached (refcount 0, still on device)
        assert d.device_used == used_before - 2 * MB
        e = h1["f/w"].entry
        assert e.refcount == 0 and e.tier is Tier.DEVICE

    def test_demote_and_host_promotion(self):
        d, db = _daemon()
        r1 = _req(db=db)
        h1 = d.prepare(r1)
        for h in h1.values():
            h.wait(5)
        d.release(r1, h1)
        moved = d.demote_to_host("f")
        assert moved == 10 * MB
        assert h1["f/w"].entry.tier is Tier.HOST
        # next invocation promotes host -> device (PCIe only, no db load)
        r2 = _req(db=db)
        h2 = d.prepare(r2)
        for h in h2.values():
            h.wait(5)
        assert d.stats["host_promotions"] == 1
        assert h2["f/w"].entry.tier is Tier.DEVICE

    def test_oom_and_eviction(self):
        d, db = _daemon(cap_mb=32)
        r1 = _req(fn="a", ro_mb=20, w_mb=1, db=db)
        h1 = d.prepare(r1)
        for h in h1.values():
            h.wait(5)
        d.release(r1, h1)  # 20MB cached RO
        d.set_evictable_provider(lambda: d.evictable_entries("a"))
        # new function needs 20MB -> must evict a's cached weights
        db.put("b/w", b"W", size=20 * MB)
        r2 = Request(function_name="b",
                     in_data=[Data(key="b/w", size=20 * MB)])
        h2 = d.prepare(r2)
        for h in h2.values():
            h.wait(5)
        assert d.stats["evictions"] == 1
        assert h1["a/w"].entry.tier is Tier.DROPPED

    def test_hard_oom_raises(self):
        d, db = _daemon(cap_mb=8)
        with pytest.raises(OutOfDeviceMemory):
            d._reserve_device(16 * MB)


class TestPolicies:
    def test_policy_table(self):
        sage = get_system("sage")
        assert sage.parallel_setup and sage.share_read_only and sage.multi_stage_exit
        fixed = get_system("fixedgsl")
        assert not fixed.parallel_setup and fixed.slot_granularity == 1 << 30
        flex = get_system("fixedgsl-f")
        assert flex.slot_granularity == 0
        dgsf = get_system("dgsf")
        assert dgsf.pre_created_contexts == 4 and not dgsf.share_read_only
        nr = get_system("sage-nr")
        assert nr.parallel_setup and not nr.share_read_only
        # and the whole table equals the reference's, field by field
        ref, port = on_both(lambda m: {k: dataclasses.asdict(v) for k, v in m.SYSTEMS.items()})
        assert port == ref and set(port) == set(SYSTEMS)

    def test_unknown_system_raises(self):
        with pytest.raises(KeyError):
            get_system("nope")


class TestBroker:
    def test_solo_transfer_time(self):
        b = BandwidthBroker(100 * MB)  # 100 MB/s
        t = b.transfer(10 * MB)
        assert 0.08 < t < 0.5

    def test_fair_share_contention(self):
        b = BandwidthBroker(100 * MB)
        results = []

        def go():
            results.append(b.transfer(5 * MB))

        ts = [threading.Thread(target=go) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        solo = 5 * MB / b.bw
        assert min(results) > 1.2 * solo  # contended: visibly slower than solo
        assert b.max_concurrency >= 3

    def test_virtual_transfer(self):
        def run(m):
            clock = m.VirtualClock()
            b = m.BandwidthBroker(100 * MB, clock)
            done = []
            b.sim_transfer(10 * MB, lambda: done.append(clock.now()))
            b.sim_transfer(10 * MB, lambda: done.append(clock.now()))
            clock.run_until(10.0)
            return done, b.total_bytes

        want, (done, total) = on_both(run)
        assert (done, total) == want
        assert len(done) == 2
        # two equal transfers sharing the link both finish at ~2x solo
        assert abs(done[0] - 0.2) < 0.02


# ---------------------------------------------------------------------------
# tests/test_dataplane.py: failure propagation, backpressure, cancellation
# ---------------------------------------------------------------------------

def _wreq(fn="f", w_mb=8, db=None):
    """Request with one writable datum (freed fully on release)."""
    req = Request(function_name=fn)
    key = f"{fn}/in/{req.uuid}"
    if db is not None:
        db.put(key, b"X", size=w_mb * MB)
    req.in_data = [Data(key=key, size=w_mb * MB, dtype=DataType.WRITABLE)]
    return req


class FaultyDB(Database):
    """Database whose fetch always faults."""

    def __init__(self):
        super().__init__(**CPU)

    def fetch(self, key, broker=None, *, scale: float = 1.0):
        raise IOError(f"simulated database fault for {key}")


class SlowCountingDB(Database):
    """Database that tracks concurrent fetches (the db-path instrumentation
    for the loader-concurrency bound)."""

    def __init__(self, delay: float = 0.05):
        super().__init__(**CPU)
        self.delay = delay
        self._c = threading.Lock()
        self.cur = 0
        self.max_concurrent = 0

    def fetch(self, key, broker=None, *, scale: float = 1.0):
        with self._c:
            self.cur += 1
            self.max_concurrent = max(self.max_concurrent, self.cur)
        try:
            time.sleep(self.delay)
            return super().fetch(key, broker, scale=scale)
        finally:
            with self._c:
                self.cur -= 1


def test_db_fault_propagates_as_dataloaderror():
    d, _ = _daemon(db=FaultyDB())
    req = _wreq(db=None)
    h = d.prepare(req)[req.in_data[0].key]
    with pytest.raises(DataLoadError) as ei:
        h.wait(5)
    assert isinstance(ei.value.cause, IOError)
    assert d.stats["load_failures"] == 1
    assert d.device_used == 0 and d.host_used == 0
    assert_runtime_keys(daemon=d)


def test_oom_past_deadline_fails_instead_of_hanging():
    d, db = _daemon(cap_mb=4, load_timeout_s=0.3)
    req = _wreq(w_mb=8, db=db)  # 8 MB datum can never fit in 4 MB
    h = d.prepare(req)[req.in_data[0].key]
    t0 = time.monotonic()
    with pytest.raises(DataLoadError):
        h.wait(10)
    assert time.monotonic() - t0 < 5.0
    assert d.stats["load_failures"] == 1
    assert d.device_used == 0 and d.host_used == 0
    # the failed entry is not resurrected as a shared hit
    assert h.entry.tier is Tier.FAILED


def test_failed_handle_is_not_ready():
    d, _ = _daemon(db=FaultyDB())
    req = _wreq()
    h = d.prepare(req)[req.in_data[0].key]
    h.entry.ready.wait(5)
    assert not h.is_ready()


def test_load_blocked_on_oom_admitted_after_release():
    d, db = _daemon(cap_mb=10, load_timeout_s=5.0)
    ra = _wreq(fn="a", w_mb=8, db=db)
    ha = d.prepare(ra)[ra.in_data[0].key]
    ha.wait(5)
    assert d.device_used == 8 * MB

    rb = _wreq(fn="b", w_mb=8, db=db)
    hb = d.prepare(rb)[rb.in_data[0].key]
    # b cannot be admitted while a holds the device
    threading.Timer(0.25, lambda: d.release(ra, {ra.in_data[0].key: ha})).start()
    assert hb.wait(10) is not None  # admitted after a's release
    assert d.stats["oom_retries"] >= 1
    d.release(rb, {rb.in_data[0].key: hb})
    assert d.device_used == 0 and d.host_used == 0


def test_try_reserve_context_neither_evicts_nor_waits():
    """The non-blocking context reservation (a CUDA graph's pool): granted
    while the bytes are free, refused beyond them without evicting an idle
    entry, and refused on a crashed node; ``release_context`` gives the
    bytes back."""
    d, db = _daemon(cap_mb=10)
    req = _req(fn="a", ro_mb=6, w_mb=1, db=db)
    handles = d.prepare(req)
    for h in handles.values():
        h.wait(5)
    d.release(req, handles)  # the weights stay on the device, idle
    d.set_evictable_provider(lambda: d.evictable_entries("a"))
    assert d.device_used == 6 * MB
    assert d.try_reserve_context(3 * MB)
    assert not d.try_reserve_context(2 * MB)  # only by evicting the weights
    assert d.device_used == 9 * MB and d.context_bytes_used == 3 * MB
    assert d.stats["evictions"] == 0
    d.release_context(3 * MB)
    assert d.device_used == 6 * MB and d.context_bytes_used == 0
    d.crash()
    assert not d.try_reserve_context(1) and d.context_bytes_used == 0


def test_release_while_loading_cancels_without_leak():
    db = SlowCountingDB(delay=0.2)
    d, _ = _daemon(db=db)
    req = _wreq(db=db)
    handles = d.prepare(req)
    # release immediately: the loader is still in the db fetch
    d.release(req, handles)
    h = handles[req.in_data[0].key]
    with pytest.raises(DataLoadError):
        h.wait(5)
    deadline = time.monotonic() + 5
    while (d.device_used or d.host_used) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert d.device_used == 0 and d.host_used == 0
    assert d.stats["load_cancellations"] == 1


def test_prepare_after_shutdown_resolves_synchronously():
    d, db = _daemon()
    d.shutdown()
    req = _wreq(db=db)
    h = d.prepare(req)[req.in_data[0].key]
    assert h.wait(5) is not None  # degraded to inline load, never parked


def test_unpooled_daemon_still_propagates_failures():
    # baseline platforms run with pooled=False (per-load threads); the
    # failure/cancellation contract is identical
    d, _ = _daemon(db=FaultyDB(), pooled=False)
    req = _wreq()
    h = d.prepare(req)[req.in_data[0].key]
    with pytest.raises(DataLoadError):
        h.wait(5)
    assert d.device_used == 0 and d.host_used == 0


class ThreadLoggingDB(SlowCountingDB):
    """``SlowCountingDB`` that also logs the thread each fetch runs on."""

    def __init__(self, delay: float = 0.05):
        super().__init__(delay)
        self.threads = []

    def fetch(self, key, broker=None, *, scale: float = 1.0):
        self.threads.append(threading.get_ident())
        return super().fetch(key, broker, scale=scale)


def test_unpooled_loads_run_at_once_on_threads_that_stay(monkeypatch):
    """A baseline (unpooled) daemon's loads are ungated, each running at
    once beside the others, and they run on threads that stay: a second
    round of loads takes the first round's idle threads, so no load's
    thread ends beside the request it served (its end slowed the next
    forward's host issue on the card)."""
    runner = daemon_mod._IdleThreads()
    monkeypatch.setattr(daemon_mod, "_unpooled_loads", runner)
    db = ThreadLoggingDB(delay=0.1)
    d, _ = _daemon(db=db, pooled=False)
    first = [_wreq(fn=f"a{i}", w_mb=1, db=db) for i in range(6)]
    for h in [d.prepare(r)[r.in_data[0].key] for r in first]:
        h.wait(10)
    assert db.max_concurrent == 6 and len(set(db.threads)) == 6
    deadline = time.monotonic() + 10
    while runner._idle < 6 and time.monotonic() < deadline:
        time.sleep(0.01)
    threads = threading.active_count()
    second = [_wreq(fn=f"b{i}", w_mb=1, db=db) for i in range(3)]
    for h in [d.prepare(r)[r.in_data[0].key] for r in second]:
        h.wait(10)
    assert set(db.threads[6:]) <= set(db.threads[:6])
    assert threading.active_count() == threads


def test_unpooled_load_that_raises_keeps_its_thread(monkeypatch):
    """A job that raises on the unpooled loads' threads is reported as a
    thread's death would be (``threading.excepthook``), and its thread
    runs the next job."""
    runner = daemon_mod._IdleThreads()
    seen, ran = [], []
    monkeypatch.setattr(threading, "excepthook", lambda args: seen.append(
        (args.exc_type, args.thread.ident)))
    runner.submit(lambda: 1 / 0)
    deadline = time.monotonic() + 10
    while runner._idle < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    done = threading.Event()
    runner.submit(lambda: (ran.append(threading.get_ident()), done.set()))
    assert done.wait(10)
    assert seen == [(ZeroDivisionError, ran[0])]


def test_loader_concurrency_never_exceeds_pool_size():
    db = SlowCountingDB(delay=0.05)
    d, _ = _daemon(db=db, loader_threads=3)
    reqs = [_wreq(fn=f"f{i}", w_mb=1, db=db) for i in range(10)]
    handles = [d.prepare(r)[r.in_data[0].key] for r in reqs]
    for h in handles:
        h.wait(10)
    assert db.max_concurrent <= 3
    assert d.max_inflight_loads <= 3
    assert d.max_inflight_loads >= 2  # the pool actually ran concurrently


def test_burst_under_capacity_no_hang_no_leak():
    db = Database(**CPU)
    d, _ = _daemon(cap_mb=20, db=db, loader_threads=4, load_timeout_s=3.0)
    base_dev, base_host = d.device_used, d.host_used
    n = 12
    reqs = [_wreq(fn=f"f{i}", w_mb=8, db=db) for i in range(n)]  # 96 MB >> 20
    results = [None] * n

    def run(i):
        req = reqs[i]
        handles = d.prepare(req)
        try:
            handles[req.in_data[0].key].wait(15)
            results[i] = "ok"
        except DataLoadError:
            results[i] = "failed"
        finally:
            d.release(req, handles)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "a Handle.wait() hung past its timeout"
    assert all(r in ("ok", "failed") for r in results)
    assert results.count("ok") >= 2  # backpressure admitted at least the 2 that fit
    # cancellation/rollback may lag release by one loader checkpoint
    deadline = time.monotonic() + 10
    while (d.device_used != base_dev or d.host_used != base_host) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert d.device_used == base_dev
    assert d.host_used == base_host


def test_runtime_burst_errors_surface_in_telemetry():
    """Engine layer: loader failures land in InvocationRecord.error and the
    future raises — the runtime pool never deadlocks on a dead loader."""
    from repro_torch.core.functions import make_model_function, make_request
    from repro_torch.core.runtime import SageRuntime

    rt = SageRuntime("sage", time_scale=0.0, exit_ttl=30.0,
                     device_capacity=2048 * MB, load_timeout_s=2.0, **CPU)
    rt.sage_init()
    # declared working set far above device capacity -> admission can never
    # succeed; the invocation must FAIL (typed), not hang
    fn = make_model_function(rt.db, "big", arch="qwen2.5-3b",
                             declared_ro_bytes=8192 * MB)
    rt.register_function(fn)
    fut = rt.submit(make_request(rt.db, fn))
    with pytest.raises(DataLoadError):
        fut.result(timeout=60)
    assert rt.telemetry.error_count() == 1
    assert "DataLoadError" in rt.telemetry.errors()[0].error
    assert_runtime_keys(node=rt)
    rt.shutdown()


# virtual-time twin: same bound, same failure semantics

def test_simulator_loader_bound_enforced():
    def run(m):
        sim = m.Simulator("sage-nr", loader_threads=2)  # NR: every load is private
        f = m.SimFunction(m.PROFILES["resnet50"])
        sim.register(f)
        for i in range(12):
            sim.submit(f.name, 0.001 * i)
        sim.run(until=600.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    node = sim.nodes[0]
    assert sim.completed == 12
    assert node.max_inflight_loads <= 2
    assert node.max_inflight_loads >= 2  # the gate actually saturated


def test_simulator_failure_semantics_mirror_daemon():
    # capacity below one invocation's working set: the twin must resolve
    # every arrival as completed-or-failed (error recorded), never stuck
    def run(m):
        sim = m.Simulator("fixedgsl", capacity=256 << 20, load_timeout_s=1.0)
        f = m.SimFunction(m.PROFILES["bert"])  # ~1.7 GB slot >> 256 MB
        sim.register(f)
        for i in range(4):
            sim.submit(f.name, 0.001 * i)
        sim.run(until=600.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    assert sim.failed == 4 and sim.completed == 0
    errs = sim.telemetry.errors()
    assert len(errs) == 4
    assert all("DataLoadError" in r.error for r in errs)
    assert all(r.end_t is not None for r in errs)
    assert sim.nodes[0].used == 0  # failed reservations hold nothing


def test_simulator_backpressure_admits_when_memory_frees():
    # two invocations with PRIVATE working sets (NR mode), device fits one:
    # the second waits for the first's release, then completes — no failure
    def run(m):
        sim = m.Simulator("sage-nr", capacity=2 << 30, exit_ttl=0.5, load_timeout_s=300.0)
        f = m.SimFunction(m.PROFILES["bert"])
        sim.register(f)
        sim.submit(f.name, 0.0)
        sim.submit(f.name, 0.01)
        sim.run(until=900.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    assert sim.completed == 2 and sim.failed == 0


# host-tier admission: host_capacity is enforced, not advisory

def test_host_overcommit_fails_typed_no_leak():
    d, db = _daemon(host_capacity=4 * MB)
    req = _wreq(w_mb=8, db=db)  # 8 MB can never fit the 4 MB host tier
    h = d.prepare(req)[req.in_data[0].key]
    with pytest.raises(DataLoadError, match="host admission"):
        h.wait(5)
    assert d.stats["load_failures"] == 1
    assert d.host_used == 0 and d.device_used == 0
    assert h.entry.tier is Tier.FAILED


def test_host_admission_evicts_refcount0_host_entries():
    db = Database(**CPU)
    d, _ = _daemon(db=db, host_capacity=12 * MB)
    # fn a: 8 MB read-only entry, demoted to the HOST tier (refcount 0)
    ra = Request(function_name="a")
    db.put("a/w", b"W", size=8 * MB)
    ra.in_data = [Data(key="a/w", size=8 * MB, dtype=DataType.READ_ONLY)]
    ha = d.prepare(ra)["a/w"]
    ha.wait(5)
    d.release(ra, {"a/w": ha})
    d.demote_to_host("a")
    assert ha.entry.tier is Tier.HOST and d.host_used == 8 * MB
    # fn b needs 8 MB of host: a's idle host copy must be evicted
    rb = _wreq(fn="b", w_mb=8, db=db)
    hb = d.prepare(rb)[rb.in_data[0].key]
    assert hb.wait(5) is not None
    assert d.stats["host_evictions"] == 1
    assert ha.entry.tier is Tier.DROPPED
    assert d.host_used == 8 * MB  # only b's bytes remain
    d.release(rb, {rb.in_data[0].key: hb})
    assert d.host_used == 0 and d.device_used == 0


def test_simulator_host_admission_mirrors_daemon():
    # the twin enforces the same host ceiling on the db->host leg: a
    # working set above host_capacity fails typed, and an idle host-state
    # shared-RO copy is evicted to make room for a new load
    def too_big(m):
        sim = m.Simulator("sage", host_capacity=1 << 30, load_timeout_s=5.0)
        f = m.SimFunction(m.PROFILES["bert"])  # 1282 MB RO > 1 GiB host tier
        sim.register(f)
        sim.submit(f.name, 0.0)
        sim.run(until=600.0)
        return sim

    ref, sim = on_both(too_big)
    assert_same_sims(ref, sim)
    assert sim.failed == 1
    assert "DataLoadError" in sim.telemetry.errors()[0].error
    assert sim.nodes[0].host_used == 0
    for s in (ref, sim):
        s.nodes[0]._advance_ladders()  # walk the warm ctx off the exit ladder
    assert sim.nodes[0].used == ref.nodes[0].used == 0

    # eviction: resnet50's host copy (demoted at stage 2) is dropped when
    # bert needs the room (bert peak host ~1343 MB + resnet's 98 MB > 1400)
    def evicts(m):
        sim2 = m.Simulator("sage", host_capacity=1400 << 20, load_timeout_s=60.0)
        small = m.SimFunction(m.PROFILES["resnet50"])  # ~98 MB RO
        big = m.SimFunction(m.PROFILES["bert"])        # ~1282 MB RO
        sim2.register(small)
        sim2.register(big)
        sim2.submit(small.name, 0.0)
        sim2.submit(big.name, 40.0)  # small's RO is host-demoted (stage 2) by then
        sim2.run(until=700.0)
        return sim2

    ref2, sim2 = on_both(evicts)
    assert_same_sims(ref2, sim2)
    node = sim2.nodes[0]
    assert sim2.completed == 2 and sim2.failed == 0
    assert node.host_evictions == 1
    assert node.ro_state["resnet50"] == "none"  # host copy was evicted


# alloc(): shim cudaMalloc rides the same backpressure admission path

def test_alloc_waits_with_backpressure_instead_of_raising():
    d, db = _daemon(cap_mb=10, load_timeout_s=5.0)
    ra = _wreq(fn="a", w_mb=8, db=db)
    ha = d.prepare(ra)[ra.in_data[0].key]
    ha.wait(5)
    # device full: a shim cudaMalloc under transient pressure must WAIT for
    # the release (not an immediate OutOfDeviceMemory)
    threading.Timer(0.25, lambda: d.release(ra, {ra.in_data[0].key: ha})).start()
    rb = Request(function_name="b")
    hb = d.alloc(rb, "b/scratch", 8 * MB)
    assert hb.is_ready() and d.device_used == 8 * MB
    assert d.stats["oom_retries"] >= 1
    d.release(rb, {"b/scratch": hb})
    assert d.device_used == 0

    # past the deadline it still fails typed (OutOfDeviceMemory), promptly
    d2, _ = _daemon(cap_mb=4, load_timeout_s=0.3)
    t0 = time.monotonic()
    with pytest.raises(OutOfDeviceMemory):
        d2.alloc(Request(function_name="c"), "c/scratch", 8 * MB)
    assert time.monotonic() - t0 < 5.0
    assert d2.device_used == 0


# stats: loads/bytes_loaded are counted on COMPLETION, not at submit

def test_bytes_loaded_counted_on_completion_only():
    # failed load: nothing counted
    d, _ = _daemon(db=FaultyDB())
    req = _wreq()
    with pytest.raises(DataLoadError):
        d.prepare(req)[req.in_data[0].key].wait(5)
    assert d.stats["loads"] == 0 and d.stats["bytes_loaded"] == 0

    # cancelled load: nothing counted
    db = SlowCountingDB(delay=0.2)
    d2, _ = _daemon(db=db)
    req2 = _wreq(db=db)
    handles = d2.prepare(req2)
    d2.release(req2, handles)  # cancel while the loader is mid-fetch
    with pytest.raises(DataLoadError):
        handles[req2.in_data[0].key].wait(5)
    deadline = time.monotonic() + 5
    while d2.stats["load_cancellations"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert d2.stats["loads"] == 0 and d2.stats["bytes_loaded"] == 0

    # successful load: counted exactly once, even across host re-promotion
    db3 = Database(**CPU)
    d3, _ = _daemon(db=db3)
    r3 = Request(function_name="f")
    db3.put("f/w", b"W", size=8 * MB)
    r3.in_data = [Data(key="f/w", size=8 * MB, dtype=DataType.READ_ONLY)]
    h3 = d3.prepare(r3)["f/w"]
    h3.wait(5)
    assert d3.stats["loads"] == 1 and d3.stats["bytes_loaded"] == 8 * MB
    d3.release(r3, {"f/w": h3})
    d3.demote_to_host("f")
    r4 = Request(function_name="f")
    r4.in_data = list(r3.in_data)
    h4 = d3.prepare(r4)["f/w"]
    h4.wait(5)  # host -> device promotion: no second count
    assert d3.stats["loads"] == 1 and d3.stats["bytes_loaded"] == 8 * MB
    assert d3.stats["host_promotions"] == 1


# SLO-aware scheduling: EDF orders the loader queue and the OOM-admission
# wait by (priority, deadline slack, arrival) — on BOTH drivers

def _slo_req(fn, w_mb, db, deadline_s=None, priority=0):
    req = _wreq(fn=fn, w_mb=w_mb, db=db)
    req.deadline_s = deadline_s
    req.priority = priority
    return req


def test_edf_admission_prefers_tightest_slack_waiter():
    for sched, expect in (("fifo", ["loose", "tight"]),
                          ("edf", ["tight", "loose"])):
        d, db = _daemon(cap_mb=10, load_timeout_s=10.0, scheduler=sched)
        hold = _wreq(fn="hold", w_mb=8, db=db)
        hh = d.prepare(hold)[hold.in_data[0].key]
        hh.wait(5)
        order = []

        def waiter(name, deadline_at, delay):
            def run():
                d.reserve_slot(8 * MB, deadline_at=deadline_at)
                order.append(name)
                d.release_slot(8 * MB)
            t = threading.Thread(target=run)
            threading.Timer(delay, t.start).start()
            return t

        now = time.monotonic()
        # loose-deadline waiter arrives FIRST, tight-deadline second
        threads = [waiter("loose", now + 60.0, 0.0),
                   waiter("tight", now + 1.0, 0.15)]
        time.sleep(0.4)  # both parked on the admission wait
        d.release(hold, {hold.in_data[0].key: hh})
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        assert order == expect, f"{sched}: admitted in {order}"
        assert d.device_used == 0


def test_small_waiter_backfills_behind_blocked_big_head():
    # a huge parked head must not make a small request time out while the
    # memory it cannot use sits free: the small waiter backfills (without
    # eviction) under BOTH schedulers
    for sched in ("fifo", "edf"):
        d, db = _daemon(cap_mb=20, load_timeout_s=1.0, scheduler=sched)
        hold = _wreq(fn="hold", w_mb=10, db=db)
        hh = d.prepare(hold)[hold.in_data[0].key]
        hh.wait(5)  # 10 MB free remain
        # big head: needs 16 MB, can only ever fit after hold releases
        big_done = threading.Event()

        def big():
            try:
                d.reserve_slot(16 * MB, timeout=5.0)
                d.release_slot(16 * MB)
            finally:
                big_done.set()

        threading.Thread(target=big).start()
        time.sleep(0.15)  # big is parked at the head of the waiter heap
        t0 = time.monotonic()
        d.reserve_slot(8 * MB)  # fits in the free 10 MB: backfills now
        assert time.monotonic() - t0 < 0.5, f"{sched}: backfill was blocked"
        d.release_slot(8 * MB)
        d.release(hold, {hold.in_data[0].key: hh})
        assert big_done.wait(10)
        assert d.device_used == 0


def test_edf_loader_queue_orders_by_deadline():
    class OrderDB(Database):
        def __init__(self):
            super().__init__(**CPU)
            self.order = []

        def fetch(self, key, broker=None, *, scale: float = 1.0):
            self.order.append(key.split("/")[0])
            time.sleep(0.15)
            return super().fetch(key, broker, scale=scale)

    for sched, expect in (("fifo", ["loose", "tight"]),
                          ("edf", ["tight", "loose"])):
        db = OrderDB()
        d, _ = _daemon(db=db, loader_threads=1, scheduler=sched)
        first = _slo_req("first", 1, db)  # occupies the single worker
        d.prepare(first)
        time.sleep(0.05)
        loose = _slo_req("loose", 1, db, deadline_s=60.0)
        tight = _slo_req("tight", 1, db, deadline_s=1.0)
        hl = d.prepare(loose)[loose.in_data[0].key]  # queued first
        ht = d.prepare(tight)[tight.in_data[0].key]  # queued second
        hl.wait(10)
        ht.wait(10)
        assert db.order[0] == "first"
        assert db.order[1:] == expect, f"{sched}: ran in {db.order}"
        d.shutdown()


def data_plane_function(name: str, *, wait_s: float = 30.0,
                        context_bytes: int = 1 << 20):
    """Synthetic ``GPUFunction`` whose handler only waits on the
    daemon-prepared handles (the port's copy of the reference benchmarks'
    ``data_plane_function``): the comparison is the data plane, not
    compute."""
    from repro_torch.core.engine import GPUFunction

    def handler(shim, request):
        for dd in request.in_data:
            shim.sage_load_to_gpu(dd.key).wait(wait_s)

    return GPUFunction(name=name, handler=handler,
                       context_builder=lambda: object(),
                       context_bytes=context_bytes, container_s=0.0,
                       cpu_ctx_s=0.0)


def _runtime_slo_replay(scheduler):
    """Contended mixed-deadline trace on the REAL runtime: one loader
    thread, four loose-deadline 500 MB loads queued ahead of one
    tight-deadline 16 MB load."""
    from repro_torch.core.runtime import SageRuntime

    rt = SageRuntime("sage", loader_threads=1, scheduler=scheduler,
                     serialize_compute=False, **CPU)
    rt.sage_init()
    for i in range(4):
        rt.register_function(data_plane_function(f"batch{i}"))
    rt.register_function(data_plane_function("crit"))
    futs = [rt.submit(_slo_req(f"batch{i}", 500, rt.db, deadline_s=30.0))
            for i in range(4)]
    time.sleep(0.1)  # batches are queued on the single loader worker
    futs.append(rt.submit(_slo_req("crit", 16, rt.db,
                                   deadline_s=1.2, priority=1)))
    for f in futs:
        f.result(timeout=60)
    rate = rt.telemetry.slo_miss_rate()
    assert rt.daemon.max_inflight_loads <= 1  # pool bound holds under EDF too
    # zero leakage after drain: writable bytes all returned; only the live
    # instances' contexts remain on device
    deadline = time.monotonic() + 5
    while (rt.daemon.device_used != rt.daemon.context_bytes_used
           or rt.daemon.host_used != 0) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert rt.daemon.device_used == rt.daemon.context_bytes_used
    assert rt.daemon.host_used == 0
    assert_runtime_keys(node=rt)
    rt.shutdown()
    return rate


def test_runtime_edf_strictly_beats_fifo_on_mixed_deadlines():
    fifo = _runtime_slo_replay("fifo")
    edf = _runtime_slo_replay("edf")
    assert fifo > 0.0   # FIFO makes the tight request wait out its deadline
    assert edf < fifo   # EDF admits it first: strictly fewer misses


def _sim_slo_replay(m, scheduler):
    """The same contended mixed-deadline shape on the virtual-time twin."""
    sim = m.Simulator("sage", loader_threads=1, scheduler=scheduler)
    names = []
    for i in range(4):
        p = m.FunctionProfile(f"batch{i}", "custom", 1.0, 0.0, 500.0, 5.0)
        sim.register(m.SimFunction(p))
        names.append(p.name)
    sim.register(m.SimFunction(m.FunctionProfile("crit", "custom", 1.0, 0.0, 16.0, 5.0)))
    for i, n in enumerate(names):
        sim.submit(n, 0.001 * i, deadline_s=30.0, priority=0)
    sim.submit("crit", 0.05, deadline_s=1.2, priority=1)
    sim.run(until=600.0)
    node = sim.nodes[0]
    assert sim.completed == 5 and sim.failed == 0
    assert node.max_inflight_loads <= 1
    assert node.host_used == 0  # private bytes left the host tier at finish
    node._advance_ladders()  # walk idle instances off the exit ladder
    return sim


def test_simulator_edf_strictly_beats_fifo_on_mixed_deadlines():
    rates = {}
    for sched in ("fifo", "edf"):
        ref, sim = on_both(lambda m: _sim_slo_replay(m, sched))
        assert_same_sims(ref, sim)
        rates[sched] = sim.telemetry.slo_miss_rate()
    assert rates["fifo"] > 0.0
    assert rates["edf"] < rates["fifo"]


# retry budget under node eviction: a request whose node dies mid-load
# either lands on a healthy node within its remaining budget or fails
# with the typed error — with exact device/host accounting either way,
# on BOTH drivers

def _sim_crash_mid_load(m, max_retries):
    """Single cold request, 2 nodes; the node it lands on (determined by
    a fault-free probe run with the same seed) crashes 0.1s in — squarely
    inside the ~0.6s db leg of the 1 GB read-only load."""
    def build(faults=None):
        sim = m.Simulator("sage", n_nodes=2, seed=11, faults=faults,
                          eviction=faults is not None)
        sim.register(m.SimFunction(
            m.FunctionProfile("f", "custom", 16.0, 1024.0, 8.0, 50.0)))
        sim.submit("f", 0.0, request_id="r0", max_retries=max_retries)
        return sim

    probe = build()
    probe.run(120.0)
    victim = next(r.node_id for r in probe.telemetry.snapshot()
                  if r.request_id == "r0")
    sim = build(m.FaultPlan([m.NodeCrash(victim, at_s=0.1)], seed=11))
    sim.run(120.0)
    return sim, victim


def _crash_mid_load_checked(max_retries):
    (ref, _), (sim, victim) = on_both(lambda m: _sim_crash_mid_load(m, max_retries))
    assert_same_sims(ref, sim)
    rec = next(r for r in sim.telemetry.snapshot()
               if r.request_id == "r0" and not r.dropped)
    dead = next(n for n in sim.nodes if n.name == victim)
    healthy = next(n for n in sim.nodes if n.name != victim)
    assert not dead.healthy
    assert dead.used == 0 and dead.host_used == 0  # exact: nothing leaks
    assert dead.inflight_loads == 0
    return rec, victim, healthy


def test_sim_retry_budget_lands_on_healthy_node():
    rec, victim, healthy = _crash_mid_load_checked(max_retries=1)
    assert rec.error is None
    assert rec.redispatches == 1
    assert rec.node_id != victim
    # exact accounting on the rescuer: ctx + ro on device, the ro host
    # copy retained, the 8 MB writable payload fully drained
    assert healthy.used == (16 + 1024) * MB
    assert healthy.host_used == 1024 * MB


def test_sim_retry_budget_exhausted_fails_typed():
    rec, _, healthy = _crash_mid_load_checked(max_retries=0)
    assert rec.error_class == "node_lost"
    assert "NodeLostError" in rec.error
    assert rec.redispatches == 0
    # fail-fast: the request never reached the healthy node
    assert healthy.used == 0 and healthy.host_used == 0


def _runtime_crash_mid_load(max_retries):
    """The same shape on the threaded runtime: crash the node the gateway
    picked while its 512 MB read-only load is on the db leg (~0.3s)."""
    from repro_torch.core.daemon import NodeLostError

    gw = Gateway(backend="runtime", n_nodes=2, seed=0, eviction=True, **CPU)
    try:
        gw.register(FunctionSpec(
            name="f", read_only_bytes=512 * MB, writable_bytes=8 * MB,
            context_bytes=16 * MB, compute_ms=20.0))
        h = gw.invoke_async("f", max_retries=max_retries)
        victim = gw._nodes[h._node_idx]
        time.sleep(0.1)  # let the load reach the db leg
        assert not h._done.is_set()  # still in flight when the node dies
        victim.crash()
        if max_retries == 0:
            with pytest.raises(NodeLostError):
                h.wait(timeout=60)
            rec = h.wait(timeout=60, strict=False)
            assert rec.error_class == "node_lost"
            assert "NodeLostError" in rec.error
            assert rec.redispatches == 0
            assert gw.resilience_stats()["redispatches"] == 0
        else:
            rec = h.wait(timeout=60)
            assert rec.error is None
            assert rec.redispatches == 1
            assert rec.node_id != victim.node_id
        # exact accounting: the dead node holds nothing; on success the
        # rescuer holds ctx + ro on device and the ro host copy, with the
        # writable payload fully drained — on fail-fast it holds nothing
        mu = victim.memory_usage()
        assert mu["device_used"] == 0 and mu["host_used"] == 0
        other = next(n for n in gw._nodes if n is not victim)
        want_dev = 0 if max_retries == 0 else (
            other.daemon.context_bytes_used + 512 * MB)
        want_host = 0 if max_retries == 0 else 512 * MB
        deadline = time.monotonic() + 5
        while (other.daemon.device_used != want_dev
               or other.daemon.host_used != want_host) \
                and time.monotonic() < deadline:
            want_dev = 0 if max_retries == 0 else (
                other.daemon.context_bytes_used + 512 * MB)
            time.sleep(0.02)
        assert other.daemon.device_used == want_dev
        assert other.daemon.host_used == want_host
        assert_runtime_keys(node=other, gw=gw)
    finally:
        gw.shutdown()


@pytest.mark.parametrize("max_retries", [1, 0], ids=["lands_on_healthy_node",
                                                      "exhausted_fails_typed"])
def test_runtime_retry_budget(max_retries):
    _runtime_crash_mid_load(max_retries=max_retries)


# hedge-loser cancellation: the cancelled twin unwinds byte-exactly through
# the same release chain a failed load uses — nothing held, nothing
# double-counted on the link

def _hedge_cancel_gateway():
    gw = Gateway(backend="runtime", n_nodes=1, seed=0, **CPU)
    # context ~0.3s and writable ~0.45s on the default link: the pre-kernel
    # cancel checkpoint fires while the writable leg is still streaming
    gw.register(FunctionSpec(
        name="f", read_only_bytes=64 * MB, writable_bytes=768 * MB,
        context_bytes=512 * MB, compute_ms=20.0))
    return gw


def test_runtime_hedge_cancel_mid_load_byte_exact():
    """Cancelled mid-load, the loser leaves EXACTLY the residency a
    successful invocation leaves (zero delta on device/host), holds no
    loader slot, and the link counted only the loads that completed."""
    from repro_torch.api.gateway import DEFAULT_INPUT_BYTES
    from repro_torch.core.slowness import HedgedError

    ctl = _hedge_cancel_gateway()  # control: same spec run to completion
    try:
        ctl.invoke("f", seed=0)
        want = ctl._nodes[0].memory_usage()
        ctl_bytes = ctl._nodes[0].daemon.stats["bytes_loaded"]
    finally:
        ctl.shutdown()
    assert want["device_used"] > 0

    gw = _hedge_cancel_gateway()
    try:
        node = gw._nodes[0]
        req = gw._build_request("f", 0, seed=0,
                                input_bytes=DEFAULT_INPUT_BYTES,
                                deadline_s=None, priority=0)
        req.hedge_cancel = threading.Event()
        # the reference's context build is a 0.4 s jit compile, inside which
        # the cancel lands; the port's is empty on the CPU (it loads the
        # kernels only on the card), so the build is held open until the
        # cancel is set: the same window, without the timing
        eng = node.engines["f"]
        build = eng.fn.context_builder

        def compile_in_flight():
            req.hedge_cancel.wait(10)
            return build()

        eng.fn = dataclasses.replace(eng.fn, context_builder=compile_in_flight)
        fut = node.submit(req)
        time.sleep(0.1)  # context load in flight (~0.3s)
        req.hedge_cancel.set()
        with pytest.raises(HedgedError):
            fut.result(timeout=60)
        rec = node.telemetry.find(req.uuid)
        assert rec is not None and rec.error.startswith("HedgedError")
        assert rec.end_t > 0.0  # finalized, never left half-open
        # zero delta vs the success path: ctx + ro resident, writable and
        # input fully drained, loader slots free
        deadline = time.monotonic() + 5
        while (node.memory_usage() != want
               or node.daemon._pool.in_flight != 0) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert node.memory_usage() == want
        assert node.daemon._pool.in_flight == 0
        # exact link accounting: the db legs that completed (read-only
        # share + input payload) are counted once, the cancelled context
        # leg never lands in the books (completion-only contract), and
        # the totals match the success path byte for byte
        assert node.daemon.stats["bytes_loaded"] == ctl_bytes
        assert ctl_bytes == 64 * MB + DEFAULT_INPUT_BYTES
    finally:
        gw.shutdown()


def test_runtime_hedge_cancel_before_load_loads_nothing():
    """A cancel token already set before the engine starts aborts ahead
    of the instance claim: no slot, no load, no context — every book on
    the node reads exactly zero and the link moved no bytes."""
    from repro_torch.core.slowness import HedgedError

    gw = _hedge_cancel_gateway()
    try:
        node = gw._nodes[0]
        req = gw._build_request("f", 0, seed=0, input_bytes=MB,
                                deadline_s=None, priority=0)
        req.hedge_cancel = threading.Event()
        req.hedge_cancel.set()  # loser before it even started
        fut = node.submit(req)
        with pytest.raises(HedgedError):
            fut.result(timeout=60)
        deadline = time.monotonic() + 5
        while node.daemon._pool.in_flight != 0 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        mu = node.memory_usage()
        assert mu["device_used"] == 0 and mu["host_used"] == 0
        assert mu["context_bytes"] == 0  # the ensure never ran
        assert node.daemon._pool.in_flight == 0
        assert node.daemon.stats["bytes_loaded"] == 0
    finally:
        gw.shutdown()


# release during batching: a member cancelled while parked in the batch
# collector unwinds through the SAME release chain a hedge loser uses — the
# surviving member launches, nothing leaks

def test_runtime_hedge_cancel_while_parked_in_batch_no_leak():
    from repro_torch.api.gateway import DEFAULT_INPUT_BYTES
    from repro_torch.core.slowness import HedgedError

    def make_gw():
        gw = Gateway(backend="runtime", n_nodes=1, seed=0,
                     compute={"max_batch": 4, "batch_window_s": 1.0}, **CPU)
        gw.register(FunctionSpec(
            name="f", read_only_bytes=8 * MB, writable_bytes=8 * MB,
            context_bytes=8 * MB, compute_ms=20.0))
        return gw

    def pair(gw, cancel_second):
        """Two concurrent members; optionally cancel the second while it
        is parked in the open batch. Returns (results, memory, node)."""
        node = gw._nodes[0]
        reqs, futs = [], []
        for _ in range(2):
            req = gw._build_request("f", 0, seed=0,
                                    input_bytes=DEFAULT_INPUT_BYTES,
                                    deadline_s=None, priority=0)
            req.hedge_cancel = threading.Event()
            reqs.append(req)
            futs.append(node.submit(req))
        if cancel_second:
            # wait until both are parked in the collector (batch open
            # with 2 members), then cancel one mid-park
            plane = node._plane
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                with plane._cond:
                    b = plane._open.get("f")
                    if b is not None and len(b.requests) == 2:
                        break
                time.sleep(0.005)
            reqs[1].hedge_cancel.set()
        outcomes = []
        for fut in futs:
            try:
                fut.result(timeout=60)
                outcomes.append("ok")
            except HedgedError:
                outcomes.append("hedged")
        return outcomes, node.memory_usage(), node

    ctl = make_gw()  # control: the same pair, both run to completion
    try:
        outcomes, want, _ = pair(ctl, cancel_second=False)
        assert outcomes == ["ok", "ok"]
    finally:
        ctl.shutdown()
    assert want["device_used"] > 0

    gw = make_gw()
    try:
        outcomes, mem, node = pair(gw, cancel_second=True)
        assert outcomes == ["ok", "hedged"]
        # the survivor launched solo: its record carries no batch peers
        recs = [r for r in node.telemetry.snapshot() if r.error is None]
        assert len(recs) == 1 and recs[0].batch_size == 1
        # zero delta vs the success path: the cancelled member's claim
        # unwound byte-exactly (no leaked device_used), and the plane
        # holds no slices and no open batch
        deadline = time.monotonic() + 5
        while (node.memory_usage() != want
               or node.daemon._pool.in_flight != 0) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert node.memory_usage() == want
        assert node.daemon._pool.in_flight == 0
        plane = node._plane
        with plane._cond:
            assert plane._free == plane.cfg.slices
            assert not plane._open
        assert_runtime_keys(node=node, gw=gw)
    finally:
        gw.shutdown()


# ---------------------------------------------------------------------------
# tests/test_transfer.py: chunked streams, arbiter, preemption on both drivers
# ---------------------------------------------------------------------------

def test_stream_chunked_progress_and_cancel_freeze_bytes():
    broker = BandwidthBroker(1e12, name="test")
    st = broker.open_stream(10 * MB)
    st.advance(4 * MB)
    assert st.moved == 4 * MB and st.remaining == 6 * MB and not st.done
    st.cancel()
    assert st.advance(4 * MB) == 0.0  # cancelled: advances are no-ops
    assert st.moved == 4 * MB and not st.done
    # the link was charged ONLY for the bytes actually moved
    assert broker.total_bytes == 4 * MB

    st2 = broker.open_stream(3 * MB)
    st2.advance()  # full-size advance == one blocking transfer
    assert st2.done and st2.remaining == 0.0
    assert broker.total_bytes == 7 * MB


def test_stream_pause_resume_accounting():
    broker = BandwidthBroker(1e12, name="test")
    st = broker.open_stream(8 * MB)
    st.advance(2 * MB)
    st.pause(10.0)
    st.pause(11.0)  # idempotent: one pause, one preemption
    assert st.preemptions == 1
    st.resume(12.5)
    assert st.stalled_s == pytest.approx(2.5)
    st.advance()
    assert st.done and st.moved == 8 * MB


def test_arbiter_yields_only_to_strictly_tighter_prefix():
    demand = {"head": None}
    arb = LinkArbiter("preemptive", demand=lambda: demand["head"])
    mine = (0, 50.0)  # prio 0, deadline 50
    assert not arb.should_yield(mine)          # no demand
    demand["head"] = (0, 50.0, 99)             # same class, later arrival
    assert not arb.should_yield(mine)          # seq must NOT preempt
    demand["head"] = (0, 10.0, 99)             # tighter deadline
    assert arb.should_yield(mine)
    demand["head"] = (-1, float("inf"), 99)    # higher priority
    assert arb.should_yield(mine)
    demand["head"] = (0, 0.0, 1)               # fifo keys: degenerate prefix
    assert not arb.should_yield((0, 0.0))
    arb.set_mode("run_to_completion")
    demand["head"] = (-5, 0.0, 0)
    assert not arb.should_yield(mine)          # mode gates everything
    with pytest.raises(ValueError):
        LinkArbiter("bogus")
    assert key_prefix(None) is None
    assert key_prefix((1, 2.0, 3)) == (1, 2.0)


# golden guard: the default run_to_completion is bit-identical to the
# pre-stream simulator (the reference's captured end times)
_GOLDEN = {
    ("sage", "fifo"): [0.3105, 1.919762113, 1.171215559, 1.199215586,
                       1.863762113, 1.344072957, 1.372072984, 1.891762113,
                       1.516930356],
    ("sage", "edf"): [0.3105, 1.919762113, 1.171215559, 1.199215586,
                      1.863762113, 1.24962996, 1.466515981, 1.891762113,
                      1.516930356],
    ("fixedgsl", "fifo"): [0.403762692, 4.567450713, 2.641303739,
                           1.055328784, 5.318721576, 3.56865155, 1.79106986,
                           5.408869439, 3.923614329],
    ("dgsf", "fifo"): [0.117662692, 4.281350713, 2.355203739, 0.769228784,
                       5.032621576, 3.28255155, 1.50496986, 5.122769439,
                       3.637514329],
}


@pytest.mark.parametrize("policy,scheduler", list(_GOLDEN))
def test_run_to_completion_bit_identical_to_seed(policy, scheduler):
    def run(m):
        sim = m.Simulator(policy, loader_threads=2, scheduler=scheduler)
        assert sim.transfer == "run_to_completion"  # the default knob
        fns = []
        for p in ("resnet50", "bert", "vgg11"):
            f = m.SimFunction(m.PROFILES[p])
            sim.register(f)
            fns.append(f.name)
        for i in range(9):
            sim.submit(fns[i % 3], 0.15 * i, deadline_s=5.0 + i, priority=i % 2)
        sim.run(until=900.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    got = [round(r.end_t, 9) for r in
           sorted(sim.telemetry.records, key=lambda r: (r.arrival_t,
                                                        r.request_id))]
    assert got == _GOLDEN[(policy, scheduler)]
    # and nothing was preempted or stalled under the default mode
    assert sim.preemption_count() == 0
    assert sim.telemetry.transfer_wait() == 0.0


def _sim_two_class(m, transfer):
    sim = m.Simulator("sage", loader_threads=1, scheduler="edf",
                      transfer=transfer)
    sim.register(m.SimFunction(
        m.FunctionProfile("loose", "custom", 1.0, 0.0, 800.0, 5.0)))
    sim.register(m.SimFunction(
        m.FunctionProfile("tight", "custom", 1.0, 0.0, 24.0, 5.0)))
    sim.submit("loose", 0.0, deadline_s=60.0, priority=0)
    sim.submit("tight", 0.05, deadline_s=1.0, priority=1)  # mid-loose-stream
    sim.run(until=600.0)
    assert sim.completed == 2 and sim.failed == 0
    return sim


def _two_class_both(transfer):
    ref, sim = on_both(lambda m: _sim_two_class(m, transfer))
    assert_same_sims(ref, sim)
    return sim, {r.function: r for r in sim.telemetry.records}


def test_sim_preemptive_tight_load_completes_sooner():
    _, rtc = _two_class_both("run_to_completion")
    sim, pre = _two_class_both("preemptive")
    # the tight load no longer waits out the loose 800 MB stream
    assert pre["tight"].e2e < rtc["tight"].e2e
    # under run_to_completion the tight load finishes AFTER the loose one;
    # preemption flips the completion order
    assert rtc["tight"].end_t > rtc["loose"].end_t
    assert pre["tight"].end_t < pre["loose"].end_t
    # exactly the loose in-flight stream was paused, then resumed to run
    # to completion without losing bytes
    assert pre["loose"].preemptions >= 1
    assert pre["tight"].preemptions == 0
    assert pre["loose"].stalled_s > 0.0
    assert sim.preemption_count() == pre["loose"].preemptions
    assert sim.nodes[0].bytes_loaded == (800 + 24) * MB
    assert sim.telemetry.transfer_wait() == pytest.approx(
        pre["loose"].stalled_s)


def test_sim_gpu_data_records_actual_contended_span():
    # two identical private loads in lockstep share the PCIe link: the
    # recorded gpu_data must be the ACTUAL ~2x-solo contended span, not the
    # solo estimate nbytes/pcie.bw
    def run(m, n):
        sim = m.Simulator("sage-nr", loader_threads=4)
        f = m.SimFunction(m.FunctionProfile("f", "custom", 1.0, 0.0, 512.0, 5.0))
        sim.register(f)
        for _ in range(n):
            sim.submit("f", 0.0)
        sim.run(until=600.0)
        return sim, f.w_bytes / sim.nodes[0].pcie.bw

    (ref, _), (sim, solo) = on_both(lambda m: run(m, 2))
    assert_same_sims(ref, sim)
    assert sim.completed == 2
    for r in sim.telemetry.records:
        assert r.stages["gpu_data"] > 1.5 * solo
        assert r.stages["gpu_data"] == pytest.approx(2 * solo, rel=0.1)

    # an uncontended load still records ~the solo time
    (ref2, _), (sim2, _) = on_both(lambda m: run(m, 1))
    assert_same_sims(ref2, sim2)
    r = sim2.telemetry.records[0]
    assert r.stages["gpu_data"] == pytest.approx(solo, rel=0.05)


# threaded daemon: preemption + parity with the sim + byte-exact cancel

def _twreq(fn, mb, db, deadline_s=None, priority=0):
    req = Request(function_name=fn)
    key = f"{fn}/in/{req.uuid}"
    db.put(key, b"X", size=mb * MB)
    req.in_data = [Data(key=key, size=mb * MB, dtype=DataType.WRITABLE)]
    req.deadline_s, req.priority = deadline_s, priority
    return req


def _preempt_daemon(transfer, db=None, **kw):
    db = db or Database(**CPU)
    paths = DataPaths.make(db_bw=2e9, pcie_bw=4e9)  # legs take real but
    # test-sized wall time (160 MB ~ 0.08 s db + 0.04 s pcie)
    kw.setdefault("chunk_bytes", 8 * MB)
    d = MemoryDaemon(paths, db, loader_threads=1, scheduler="edf",
                     transfer=transfer, **kw)
    return d, db


def _run_two_class_daemon(transfer):
    d, db = _preempt_daemon(transfer)
    ends = {}

    def waiter(name, h):
        h.wait(30)
        ends[name] = time.monotonic()

    loose = _twreq("loose", 160, db, deadline_s=60.0, priority=0)
    hl = d.prepare(loose)[loose.in_data[0].key]
    tl = threading.Thread(target=waiter, args=("loose", hl))
    tl.start()
    time.sleep(0.03)  # the loose stream is mid-db-leg
    tight = _twreq("tight", 8, db, deadline_s=0.5, priority=1)
    t0 = time.monotonic()
    ht = d.prepare(tight)[tight.in_data[0].key]
    tt = threading.Thread(target=waiter, args=("tight", ht))
    tt.start()
    for t in (tl, tt):
        t.join(timeout=30)
        assert not t.is_alive()
    tight_s = ends["tight"] - t0
    stats = dict(d.stats)
    out = {
        "tight_s": tight_s,
        "tight_first": ends["tight"] < ends["loose"],
        "loose_preempt": hl.entry.transfer_preemptions(),
        "tight_preempt": ht.entry.transfer_preemptions(),
        "loose_stall": hl.entry.transfer_stalled_s(),
        "preemptions": stats["preemptions"],
        "db_bytes": d.paths.db.total_bytes,
    }
    d.release(loose, {loose.in_data[0].key: hl})
    d.release(tight, {tight.in_data[0].key: ht})
    assert d.device_used == 0 and d.host_used == 0
    assert_runtime_keys(daemon=d)
    d.shutdown()
    return out


def test_runtime_preemptive_tight_load_completes_sooner():
    rtc = _run_two_class_daemon("run_to_completion")
    pre = _run_two_class_daemon("preemptive")
    assert rtc["preemptions"] == 0 and rtc["loose_preempt"] == 0
    assert pre["preemptions"] >= 1
    assert pre["tight_s"] < rtc["tight_s"]
    # full byte accounting: both streams moved everything they declared
    assert rtc["db_bytes"] == (160 + 8) * MB
    assert pre["db_bytes"] == (160 + 8) * MB


def test_runtime_sim_preemption_parity():
    """Same arrival pattern (tight small load arriving mid-way through a
    loose large stream, one loader worker, EDF keys) => the same stream is
    paused then resumed on BOTH drivers, and only under "preemptive"."""
    sim_pre = _two_class_both("preemptive")[1]
    sim_rtc = _two_class_both("run_to_completion")[1]
    rt_pre = _run_two_class_daemon("preemptive")
    rt_rtc = _run_two_class_daemon("run_to_completion")
    # loose paused >=1 then resumed to completion; tight never paused
    assert sim_pre["loose"].preemptions >= 1 and rt_pre["loose_preempt"] >= 1
    assert sim_pre["tight"].preemptions == 0 and rt_pre["tight_preempt"] == 0
    assert sim_pre["loose"].stalled_s > 0.0 and rt_pre["loose_stall"] > 0.0
    # the tight load overtakes the loose one only under "preemptive"
    assert sim_pre["tight"].end_t < sim_pre["loose"].end_t
    assert rt_pre["tight_first"]
    assert sim_rtc["tight"].end_t > sim_rtc["loose"].end_t
    assert not rt_rtc["tight_first"]
    assert sim_rtc["loose"].preemptions == 0 and rt_rtc["loose_preempt"] == 0


def test_release_of_paused_stream_cancels_byte_exact():
    """release() of a writable entry whose stream is PAUSED (preempted)
    cancels it at the next loader checkpoint; accounting is byte-exact:
    no device/host leak, and the links are charged only for chunks that
    actually moved."""
    d, db = _preempt_daemon("preemptive", chunk_bytes=4 * MB)
    loose = _twreq("loose", 80, db, deadline_s=60.0, priority=0)
    handles = d.prepare(loose)
    hl = handles[loose.in_data[0].key]
    time.sleep(0.01)  # loose mid-db-leg
    tight = _twreq("tight", 64, db, deadline_s=0.5, priority=1)
    ht = d.prepare(tight)[tight.in_data[0].key]
    # wait for the preemption, then cancel the paused loose stream while
    # the tight load still owns the single worker
    deadline = time.monotonic() + 5
    while d.stats["preemptions"] == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert d.stats["preemptions"] >= 1
    d.release(loose, handles)
    with pytest.raises(DataLoadError):
        hl.wait(10)
    ht.wait(10)
    deadline = time.monotonic() + 5
    while d.stats["load_cancellations"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert d.stats["load_cancellations"] == 1
    assert d.device_used == 64 * MB  # only the tight entry remains
    assert d.host_used == 64 * MB
    # link accounting is exact: tight's full size + exactly the loose
    # chunks that moved before the cancel — never the full loose stream
    loose_db = hl.entry.db_stream.moved
    loose_pcie = hl.entry.pcie_stream.moved if hl.entry.pcie_stream else 0.0
    assert d.paths.db.total_bytes == 64 * MB + loose_db
    assert d.paths.pcie.total_bytes == 64 * MB + loose_pcie
    assert loose_db + loose_pcie < 2 * 80 * MB  # the tail was never moved
    d.release(tight, {tight.in_data[0].key: ht})
    assert d.device_used == 0 and d.host_used == 0
    d.shutdown()


def test_transfer_attribution_claimed_once_across_sharers():
    """A pause on an entry is attributed to exactly ONE record: the claim
    API returns the not-yet-attributed delta and zero afterwards, so
    concurrent sharers cannot each report the same stall."""
    d, db = _preempt_daemon("preemptive")
    loose = _twreq("loose", 160, db, deadline_s=60.0, priority=0)
    hl = d.prepare(loose)[loose.in_data[0].key]
    time.sleep(0.03)
    tight = _twreq("tight", 8, db, deadline_s=0.5, priority=1)
    ht = d.prepare(tight)[tight.in_data[0].key]
    hl.wait(30)
    ht.wait(30)
    assert d.stats["preemptions"] >= 1
    handles = {loose.in_data[0].key: hl}
    p1, s1 = d.claim_transfer_attribution(handles)
    assert p1 >= 1 and s1 > 0.0
    p2, s2 = d.claim_transfer_attribution(handles)
    assert p2 == 0 and s2 == 0.0
    d.release(loose, handles)
    d.release(tight, {tight.in_data[0].key: ht})
    d.shutdown()


# knob plumbing: validation, gateway adoption/conflict, runtime switch

def test_transfer_knob_validation():
    from repro_torch.core.simulator import Simulator

    with pytest.raises(ValueError):
        FunctionSpec(name="f", transfer="bogus")
    with pytest.raises(ValueError):
        Simulator("sage", transfer="bogus")
    with pytest.raises(ValueError):
        MemoryDaemon(DataPaths.make(), Database(**CPU), transfer="bogus")
    with pytest.raises(ValueError):
        Gateway(backend="sim", transfer="bogus")
    assert set(TRANSFER_MODES) == {"run_to_completion", "preemptive"}


def test_gateway_adopts_spec_transfer_and_refuses_conflicts():
    gw = Gateway(backend="sim", policy="sage")
    assert gw.transfer == "run_to_completion"
    gw.register(FunctionSpec.from_profile("resnet50", name="a",
                                          transfer="preemptive"))
    assert gw.transfer == "preemptive"
    assert gw.sim.transfer == "preemptive"
    # a later spec declaring a DIFFERENT mode is refused
    with pytest.raises(ValueError, match="transfer"):
        gw.register(FunctionSpec.from_profile("resnet50", name="b",
                                              transfer="run_to_completion"))
    # a pinned gateway refuses a conflicting spec up front
    gw2 = Gateway(backend="sim", policy="sage", transfer="run_to_completion")
    with pytest.raises(ValueError, match="transfer"):
        gw2.register(FunctionSpec.from_profile("resnet50", name="a",
                                               transfer="preemptive"))


def test_set_transfer_switches_both_drivers():
    from repro_torch.core.runtime import ClusterRuntime
    from repro_torch.core.simulator import Simulator

    sim = Simulator("sage", n_nodes=2)
    sim.set_transfer("preemptive")
    assert all(n.arbiter.mode == "preemptive" for n in sim.nodes)
    with pytest.raises(ValueError):
        sim.set_transfer("bogus")

    cluster = ClusterRuntime(n_nodes=2, database=Database(**CPU),
                             serialize_compute=False)
    assert cluster.transfer == "run_to_completion"
    cluster.set_transfer("preemptive")
    assert all(n.daemon.transfer == "preemptive" for n in cluster.nodes)
    cluster.shutdown()


def test_telemetry_tail_percentiles_and_transfer_wait():
    tel = Telemetry()
    for i in range(100):
        r = InvocationRecord(request_id=f"r{i}", function="f", system="sage",
                             start_t=0.0, end_t=float(i + 1))
        r.stalled_s = 0.25
        r.preemptions = 2
        tel.add(r)
    assert tel.p50_duration() == 51.0
    assert tel.p95_duration() == 96.0
    assert tel.p99_duration() == 100.0
    assert tel.p99_duration("other") == 0.0
    assert tel.transfer_wait() == pytest.approx(25.0)
    assert tel.preemption_count() == 200
    assert tel.transfer_wait("other") == 0.0


# hedged redispatch: loser cancellation stays byte-exact on the sim driver

def test_sim_hedge_loser_cancel_byte_exact():
    """Gray-failure hedging on the virtual-time driver: a SlowNode drags
    one node, the straggling invocations launch speculative twins, and
    every cancelled loser unwinds byte-exactly — no node leaks device or
    host bytes, no loader slot stays claimed, and each request produces
    exactly one outcome (the loser's record is ``dropped``/``hedged``,
    never a second completion)."""
    duration = 30.0

    def run(m):
        sim = m.Simulator(
            "sage", n_nodes=3, seed=7,
            faults=m.FaultPlan([m.SlowNode("gpu1", at_s=3.0, factor=12.0)], seed=7),
            eviction=True, dispatch="random",
            hedging=dict(min_samples=6, hedge_quantile=0.9), quarantine=False,
        )
        sim.register(m.SimFunction(m.FunctionProfile(
            "f", "tail", context_mb=64.0, read_only_mb=24.0, writable_mb=4.0,
            compute_ms=15.0)))
        rng_t = 0.0
        for i in range(240):
            rng_t += duration / 240.0
            sim.submit("f", rng_t, deadline_s=0.5, request_id=f"h{i}")
        sim.run(duration + 120.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    recs = sim.telemetry.snapshot()
    losers = [r for r in recs if r.dropped and r.error_class == "hedged"]
    stats = sim.resilience_stats()
    assert stats["hedges_launched"] > 0, "the fault never provoked a hedge"
    # a launched hedge resolves exactly one way: the loser is dropped
    # (win) or the hedge itself was wasted — and every loser is a drop
    assert len(losers) == stats["hedges_won"] + stats["hedges_wasted"] \
        == stats["hedges_launched"]
    for r in losers:
        assert r.error and "Hedged" in r.error
        assert r.end_t > 0.0  # the loser finalized, not abandoned
    # exactly one outcome per submitted request id
    kept = [r for r in recs if not r.dropped]
    assert len({r.request_id for r in kept}) == len(kept) == 240
    # byte-exact books after every loser unwound
    for n in sim.nodes:
        assert 0 <= n.used <= n.capacity, f"{n.name}: used={n.used}"
        assert n.host_used >= 0, f"{n.name}: host_used={n.host_used}"
        assert n.inflight_loads == 0, f"{n.name} leaked loader slots"


# ---------------------------------------------------------------------------
# repairs: where the port departed from the reference
# ---------------------------------------------------------------------------

def test_to_device_keeps_nested_payloads_as_device_put_does():
    """The daemon's host -> device leg keeps a payload's structure as the
    reference's ``jax.device_put`` does: namedtuples (whose constructor
    takes fields, not an iterable), lists, tuples and dicts, tensors moved
    and other leaves untouched."""
    import collections

    import jax
    import numpy as np
    import torch

    Pair = collections.namedtuple("Pair", "w meta")
    host = {"p": Pair(torch.ones(2), [torch.zeros(3), (7, 8)]), "x": torch.arange(4)}
    got = Database(**CPU).to_device(host)
    want = jax.device_put({"p": Pair(np.ones(2, np.float32), [np.zeros(3, np.float32),
                                                              (7, 8)]),
                           "x": np.arange(4)})
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert type(got["p"]) is Pair and got["p"].meta[1] == (7, 8)
    assert torch.equal(got["p"].w, host["p"].w) and got["x"].device.type == "cpu"


def test_drain_of_a_busy_node_times_out_untouched():
    """``SageRuntime.drain`` (the port's graceful retire) never tears down
    under in-flight work: past its timeout it raises ``TimeoutError`` and
    the node keeps serving; once idle it retires with exact books."""
    from repro_torch.core.engine import GPUFunction
    from repro_torch.core.runtime import SageRuntime

    rt = SageRuntime("sage", serialize_compute=False, **CPU)
    rt.sage_init()
    gate = threading.Event()
    rt.register_function(GPUFunction(
        name="f", handler=lambda shim, req: gate.wait(10),
        context_builder=lambda: object(), context_bytes=MB,
        container_s=0.0, cpu_ctx_s=0.0))
    try:
        fut = rt.submit(Request(function_name="f"))
        with pytest.raises(TimeoutError):
            rt.drain(timeout=0.2)
        assert not rt.retired and rt.memory_usage()["context_bytes"] == MB
        gate.set()
        fut.result(timeout=10)
        assert rt.drain(timeout=10) == {"device_used": 0, "context_bytes": 0,
                                        "host_used": 0}
        assert rt.retired
    finally:
        gate.set()
        rt.shutdown()
