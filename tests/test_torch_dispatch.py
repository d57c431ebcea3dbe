"""The port's cluster dispatch and placement plane (``repro_torch.core.
{dispatch,placement}``, ``ClusterRuntime``, the simulator's pool) held
against the JAX package's, case by case: the cases of tests/test_dispatch.py
(policy scoring, the residency/pressure snapshot, the seeded random stream,
runtime<->sim locality parity, retry budgets, join/drain churn, and the
locality-strictly-beats-random gate on both drivers) and
tests/test_planner.py (the planner, forecast and autoscaler, node-seconds,
work stealing, exact add/drain teardown, degradation pacing, and the
planned-beats-the-locality-pool gate on both drivers).

Virtual-time cases run the same scenario through both packages and assert
that every record and every counter is equal, then make the reference's
assertions on the port's run. Threaded cases make the reference's
assertions on the port. The gates' scenarios are copied word for word from
the reference's benchmarks/scaleout.py and benchmarks/planner.py (which
import the JAX package). Everything runs on the CPU (``device="cpu"``)."""
import dataclasses
import importlib
import random
import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Tuple

import pytest

pytest.importorskip("torch")

from repro_torch.api import FunctionSpec, Gateway  # noqa: E402
from repro_torch.core.daemon import (  # noqa: E402
    DataLoadError, MemoryDaemon, OutOfDeviceMemory,
)
from repro_torch.core.datapath import BandwidthBroker, DataPaths  # noqa: E402
from repro_torch.core.dispatch import choose_node, locality_score  # noqa: E402
from repro_torch.core.engine import GPUFunction  # noqa: E402
from repro_torch.core.placement import (  # noqa: E402
    AutoscaleConfig, Autoscaler, NodeSnapshot, PlacementControl,
    PlacementPlanner, PlannerConfig, RateForecast, resolve_autoscale,
)
from repro_torch.core.request import Data, DataType, Request  # noqa: E402
from repro_torch.core.runtime import ClusterRuntime, SageRuntime  # noqa: E402
from repro_torch.core.telemetry import STAGES, InvocationRecord, Telemetry  # noqa: E402
from repro_torch.core.transfer import (  # noqa: E402
    DEFAULT_CHUNK_BYTES, MIN_CHUNK_BYTES, LinkArbiter,
)
from repro_torch.data.database import Database  # noqa: E402

MB = 1 << 20
GB = 1 << 30
CPU = dict(device="cpu")


# ---------------------------------------------------------------------------
# both packages
# ---------------------------------------------------------------------------

def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    sim, prof, api = mod("core.simulator"), mod("core.profiles"), mod("api")
    placement, faults = mod("core.placement"), mod("core.faults")
    return SimpleNamespace(
        root=root, Simulator=sim.Simulator, SimFunction=sim.SimFunction,
        GPUNode=sim.GPUNode, PROFILES=prof.PROFILES,
        FunctionProfile=prof.FunctionProfile, Gateway=api.Gateway,
        FunctionSpec=api.FunctionSpec, TraceWorkload=api.TraceWorkload,
        DiurnalWorkload=api.DiurnalWorkload,
        AutoscaleConfig=placement.AutoscaleConfig,
        PlacementPlanner=placement.PlacementPlanner,
        PlacementControl=placement.PlacementControl,
        NodeSnapshot=placement.NodeSnapshot,
        FaultPlan=faults.FaultPlan, LinkDegradation=faults.LinkDegradation,
        EventKind=mod("core.sim.kernel").EventKind,
        VirtualClock=mod("core.clock").VirtualClock,
        get_system=mod("core.baselines").get_system,
        choose_node=mod("core.dispatch").choose_node)


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def on_both(run):
    """``run(pkg)`` on the JAX package's control plane and the port's;
    returns (reference, port)."""
    return run(REF), run(PORT)


NODE_FIELDS = ("name", "capacity", "used", "host_used", "host_evictions",
               "inflight_loads", "max_inflight_loads", "load_failures",
               "loads", "bytes_loaded", "crashes", "healthy", "draining",
               "retired")


def sim_state(sim) -> dict:
    """Every record field by field, the run's counters and stats, and each
    node's books: equal between the packages for a deterministic run."""
    return {
        "records": [dataclasses.asdict(r) for r in sim.telemetry.snapshot()],
        "completed": sim.completed, "failed": sim.failed,
        "resilience": sim.resilience_stats(), "compute": sim.compute_stats(),
        "placement": sim.placement_stats(),
        "nodes": [{f: getattr(n, f) for f in NODE_FIELDS} for n in sim.nodes],
    }


def assert_same_sims(ref, sim):
    assert sim_state(sim) == sim_state(ref)


def ref_cluster_keys() -> dict:
    """The stats key sets of the reference's threaded cluster (planned)."""
    from repro.core.runtime import ClusterRuntime as RefCluster
    from repro.data.database import Database as RefDatabase

    c = RefCluster(n_nodes=2, seed=0, database=RefDatabase(),
                   dispatch="planned", serialize_compute=False)
    try:
        return {"daemon": set(c.nodes[0].daemon.stats),
                "placement": set(c.placement_stats()),
                "compute": set(c.compute_stats())}
    finally:
        c.shutdown()


def assert_cluster_keys(cluster):
    want = ref_cluster_keys()
    assert set(cluster.nodes[0].daemon.stats) == want["daemon"]
    assert set(cluster.compute_stats()) == want["compute"]
    if cluster.placement_stats() is not None:
        assert set(cluster.placement_stats()) == want["placement"]


def _snap(node_id="gpu0", tier="none", free=40 * GB, cap=40 * GB,
          pending=0, queue=0, workers=4, healthy=True, m=None):
    cls = NodeSnapshot if m is None else m.NodeSnapshot
    return cls(node_id=node_id, ro_tier=tier, ro_bytes=0,
               device_free=free, device_capacity=cap,
               pending_admissions=pending, loader_queue=queue,
               loader_threads=workers, healthy=healthy)


def _wreq(fn="f", w_mb=8, db=None, **kw):
    req = Request(function_name=fn, **kw)
    key = f"{fn}/in/{req.uuid}"
    if db is not None:
        db.put(key, b"X", size=w_mb * MB)
    req.in_data = [Data(key=key, size=w_mb * MB, dtype=DataType.WRITABLE)]
    return req


def _daemon(cap_mb=1024, db=None, **kw):
    db = db or Database(**CPU)
    paths = DataPaths.make(db_bw=1e12, pcie_bw=1e12)
    return MemoryDaemon(paths, db, device_capacity=cap_mb * MB, **kw), db


def _gpu_fn(name):
    return GPUFunction(name=name, handler=lambda s, r: None,
                       context_builder=lambda: object(),
                       context_bytes=1 * MB, container_s=0.0, cpu_ctx_s=0.0)


def data_plane_function(name: str, *, wait_s: float = 30.0,
                        context_bytes: int = 1 << 20):
    """Synthetic ``GPUFunction`` whose handler only waits on the
    daemon-prepared handles: the port's copy of benchmarks/common.py's
    ``data_plane_function`` (the comparison is the data plane, not
    compute)."""
    def handler(shim, request):
        for dd in request.in_data:
            shim.sage_load_to_gpu(dd.key).wait(wait_s)

    return GPUFunction(name=name, handler=handler,
                       context_builder=lambda: object(),
                       context_bytes=context_bytes, container_s=0.0,
                       cpu_ctx_s=0.0)


# ---------------------------------------------------------------------------
# tests/test_dispatch.py: policy scoring (pure units, on both packages)
# ---------------------------------------------------------------------------

def test_locality_prefers_residency_tier_order():
    snaps = [_snap("gpu0", "none"), _snap("gpu1", "host"),
             _snap("gpu2", "device"), _snap("gpu3", "loading")]
    assert choose_node("locality", snaps) == 2  # device wins, index breaks
    # loading counts as much as device (attach to the in-flight stream)
    assert locality_score(snaps[2]) == locality_score(snaps[3])
    assert choose_node("locality", snaps[:2]) == 1  # host beats cold
    ref, port = on_both(lambda m: [m.choose_node("locality", [
        _snap(f"gpu{i}", t, m=m) for i, t in enumerate(tiers)])
        for tiers in (("none", "host", "device", "loading"), ("none", "host"))])
    assert port == ref == [2, 1]


def test_locality_spills_off_a_saturated_hot_node():
    hot = _snap("gpu0", "device", free=2 * GB, pending=6, queue=12, workers=2)
    cold = _snap("gpu1", "none")
    assert choose_node("locality", [hot, cold]) == 1  # spill-and-warm
    warm_ok = _snap("gpu0", "device", free=30 * GB, queue=1, workers=2)
    assert choose_node("locality", [warm_ok, cold]) == 0  # mild load sticks


def test_locality_cold_functions_spread_by_memory_pressure():
    # no residency anywhere: the emptier node wins, so cold functions
    # spread instead of piling onto node 0
    a = _snap("gpu0", "none", free=20 * GB)
    b = _snap("gpu1", "none", free=39 * GB)
    assert choose_node("locality", [a, b]) == 1


def test_least_loaded_and_tie_breaks_deterministic():
    assert choose_node("least_loaded",
                       [_snap(queue=4), _snap(queue=1), _snap(queue=2)]) == 1
    # full tie: lowest index (stable across both drivers)
    assert choose_node("locality", [_snap(), _snap(), _snap()]) == 0
    assert choose_node("least_loaded", [_snap(), _snap()]) == 0
    # EDF-compatible tie-break: equal score, fewer parked waiters wins
    assert choose_node("locality",
                       [_snap("a", pending=3), _snap("b", pending=0)]) == 1
    with pytest.raises(ValueError):
        choose_node("round_robin", [_snap()])


# residency/pressure snapshot contract (daemon + sim twin)

class SlowDB(Database):
    def __init__(self, delay=0.4):
        super().__init__(**CPU)
        self.delay = delay

    def fetch(self, key, broker=None, *, scale: float = 1.0):
        time.sleep(self.delay)
        return super().fetch(key, broker, scale=scale)


def test_daemon_residency_walks_tiers_and_never_blocks_on_inflight_loads():
    db = SlowDB(delay=0.4)
    d, _ = _daemon(db=db)
    req = Request(function_name="f")
    db.put("f/w", b"W", size=8 * MB)
    req.in_data = [Data(key="f/w", size=8 * MB, dtype=DataType.READ_ONLY)]
    assert d.residency("f") == ("none", 0)
    h = d.prepare(req)["f/w"]
    # the loader is parked inside the slow fetch: the snapshot must return
    # immediately (lock is only held at loader checkpoints)
    t0 = time.monotonic()
    tier, nbytes = d.residency("f")
    p = d.pressure()
    assert time.monotonic() - t0 < 0.2
    assert tier == "loading" and nbytes == 8 * MB
    assert p["loader_queue"] >= 1
    assert p["device_capacity"] == 1024 * MB
    h.wait(5)
    assert d.residency("f")[0] == "device"
    assert d.pressure()["device_free"] == (1024 - 8) * MB
    d.release(req, {"f/w": h})
    d.demote_to_host("f")
    assert d.residency("f") == ("host", 8 * MB)
    d.drop_host("f")
    assert d.residency("f") == ("none", 0)
    d.shutdown()


def test_daemon_function_entries_rides_per_function_index():
    db = Database(**CPU)
    d, _ = _daemon(db=db)
    reqs = {}
    for fn in ("a", "b"):
        db.put(f"{fn}/w", b"W", size=4 * MB)
        req = Request(function_name=fn)
        req.in_data = [Data(key=f"{fn}/w", size=4 * MB,
                            dtype=DataType.READ_ONLY)]
        d.prepare(req)[f"{fn}/w"].wait(5)
        reqs[fn] = req
    assert {e.key for e in d.function_entries("a")} == {"a/w"}
    assert {e.key for e in d.function_entries("b")} == {"b/w"}
    assert d.function_entries("nope") == []
    # exit-ladder actions ride the index (same semantics as the old scan)
    d.release(reqs["a"], {})
    d.demote_to_host("a")
    assert len(d.evictable_entries("a")) == 0  # host tier, not device
    d.drop_host("a")
    # re-preparing a dropped key REPLACES the entry in both maps
    req2 = Request(function_name="a")
    req2.in_data = [Data(key="a/w", size=4 * MB, dtype=DataType.READ_ONLY)]
    d.prepare(req2)["a/w"].wait(5)
    assert len(d.function_entries("a")) == 1
    assert d.function_entries("a")[0].tier.value == "device"
    d.shutdown()


def test_sim_node_snapshot_mirrors_daemon_contract():
    def run(m):
        sim = m.Simulator("sage")
        f = m.SimFunction(m.PROFILES["resnet50"])
        sim.register(f)
        node = sim.nodes[0]
        seen = [node.residency("resnet50")]
        sim.submit("resnet50", 0.0)
        sim.run(until=0.05)  # mid-load: db/pcie legs still in flight
        seen.append(node.residency("resnet50"))
        sim.run(until=600.0)
        return sim, f, seen

    (ref, _, want), (sim, f, seen) = on_both(run)
    assert_same_sims(ref, sim)
    assert seen == want
    node = sim.nodes[0]
    assert seen[0] == ("none", 0)
    assert seen[1][0] == "loading"
    tier, nbytes = node.residency("resnet50")
    assert tier == "device" and nbytes == f.ro_bytes
    snap = node.dispatch_snapshot("resnet50")
    assert snap.node_id == "gpu0" and snap.ro_tier == "device"
    assert snap.device_free == node.capacity - node.used


# random dispatch: the seeded paper §7.8 behavior is bit-identical

def test_sim_random_dispatch_reproduces_seeded_stream():
    def run(m):
        sim = m.Simulator("sage", n_nodes=4, seed=3)  # dispatch defaults to random
        assert sim.dispatch == "random"
        sim.register(m.SimFunction(m.PROFILES["resnet50"]))
        for i in range(12):
            sim.submit("resnet50", 0.5 * i)
        sim.run(until=600.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    got = [r.node_id for r in
           sorted(sim.telemetry.records, key=lambda r: r.arrival_t)]
    rng = random.Random(3)  # the seed's rng.choice(nodes) stream
    assert got == [f"gpu{rng.randrange(4)}" for _ in range(12)]


def test_cluster_random_dispatch_reproduces_seeded_stream():
    cluster = ClusterRuntime(n_nodes=4, seed=7, database=Database(**CPU),
                             serialize_compute=False)
    assert cluster.dispatch == "random"
    cluster.sage_init()
    cluster.register_function(lambda i: _gpu_fn("f"))
    reqs = [Request(function_name="f") for _ in range(12)]
    futs = [cluster.submit(r) for r in reqs]
    for f in futs:
        f.result(timeout=60)
    tel = cluster.telemetry
    rng = random.Random(7)
    expect = [f"gpu{rng.randrange(4)}" for _ in range(12)]
    got = [tel.find(r.uuid).node_id for r in reqs]
    assert got == expect
    assert_cluster_keys(cluster)
    cluster.shutdown()


# runtime/sim parity: locality yields the same per-node assignments

def _assignment_counts(tel):
    out = {}
    for r in tel.snapshot():
        out.setdefault(r.function, {}).setdefault(r.node_id, 0)
        out[r.function][r.node_id] += 1
    return out


def _locality_parity_sim(m, specs, trace):
    gw = m.Gateway(backend="sim", policy="sage", n_nodes=2, dispatch="locality")
    for s in specs:
        gw.register(s)
    gw.replay(trace, until_pad=60.0)
    return gw


def test_locality_parity_runtime_vs_sim():
    """One trace + dispatch="locality" on both backends: same per-node
    assignment counts (within tolerance) and identical record schema."""
    def spec_trace(m):
        specs = [m.FunctionSpec(name="a", arch="qwen2.5-3b", profile="seq2seq"),
                 m.FunctionSpec(name="b", arch="qwen2.5-3b", profile="seq2seq")]
        trace = m.TraceWorkload([(0.0, "a"), (0.8, "b"), (1.6, "a"),
                                 (2.4, "b"), (3.2, "a"), (4.0, "b")])
        return specs, trace

    ref_gw, gw_sim = on_both(lambda m: _locality_parity_sim(m, *spec_trace(m)))
    assert_same_sims(ref_gw.sim, gw_sim.sim)
    tel_sim = gw_sim.report()
    specs, trace = spec_trace(PORT)
    with Gateway(backend="runtime", policy="sage", n_nodes=2,
                 dispatch="locality", time_scale=0.05, **CPU) as gw_rt:
        for s in specs:
            gw_rt.register(s)
        tel_rt = gw_rt.replay(trace)

    for tel in (tel_sim, tel_rt):
        recs = tel.snapshot()
        assert len(recs) == 6 and all(r.error is None for r in recs)
        # record schema: canonical stages + per-node attribution on every
        # record of BOTH backends
        assert all(set(r.stages) == set(STAGES) for r in recs)
        assert all(r.node_id in ("gpu0", "gpu1") for r in recs)
        assert all(r.dispatch_tier in ("none", "host", "loading", "device")
                   for r in recs)
    counts_sim = _assignment_counts(tel_sim)
    counts_rt = _assignment_counts(tel_rt)
    # same assignments within tolerance: the drivers differ in timing, so
    # allow one invocation per (function, node) cell to disagree
    for fn in ("a", "b"):
        for node in ("gpu0", "gpu1"):
            assert abs(counts_sim[fn].get(node, 0)
                       - counts_rt[fn].get(node, 0)) <= 1, (counts_sim,
                                                            counts_rt)
    # and each function concentrates on ONE node (the locality win)
    for counts in (counts_sim, counts_rt):
        for fn in ("a", "b"):
            assert max(counts[fn].values()) >= 2
    assert tel_sim.dispatch_hit_rate() > 0.5
    assert tel_rt.dispatch_hit_rate() > 0.5


# per-request retry budget (Request.max_retries)

def test_daemon_retry_budget_zero_fails_fast():
    d, db = _daemon(cap_mb=10, load_timeout_s=10.0)
    hold = _wreq(fn="hold", w_mb=8, db=db)
    hh = d.prepare(hold)[hold.in_data[0].key]
    hh.wait(5)
    req = _wreq(fn="ff", w_mb=8, db=db, max_retries=0)
    t0 = time.monotonic()
    with pytest.raises(DataLoadError):
        d.prepare(req)[req.in_data[0].key].wait(10)
    # failed typed on the FIRST OOM, long before the 10 s flat deadline
    assert time.monotonic() - t0 < 2.0
    assert d.stats["load_failures"] == 1
    # the holder is untouched and accounting is exact
    d.release(hold, {hold.in_data[0].key: hh})
    assert d.device_used == 0 and d.host_used == 0
    d.shutdown()


def test_daemon_retry_budget_generous_still_admits_after_release():
    d, db = _daemon(cap_mb=10, load_timeout_s=10.0)
    hold = _wreq(fn="hold", w_mb=8, db=db)
    hh = d.prepare(hold)[hold.in_data[0].key]
    hh.wait(5)
    threading.Timer(
        0.25, lambda: d.release(hold, {hold.in_data[0].key: hh})).start()
    req = _wreq(fn="ok", w_mb=8, db=db, max_retries=1000)
    assert d.prepare(req)[req.in_data[0].key].wait(10) is not None
    assert d.stats["oom_retries"] >= 1
    d.release(req, {req.in_data[0].key: hh})
    d.shutdown()


def test_reserve_slot_honors_retry_budget():
    d, db = _daemon(cap_mb=10, load_timeout_s=10.0)
    hold = _wreq(fn="hold", w_mb=8, db=db)
    hh = d.prepare(hold)[hold.in_data[0].key]
    hh.wait(5)
    t0 = time.monotonic()
    with pytest.raises(OutOfDeviceMemory):
        d.reserve_slot(8 * MB, max_retries=0)
    assert time.monotonic() - t0 < 2.0
    d.release(hold, {hold.in_data[0].key: hh})
    assert d.device_used == 0
    d.shutdown()


def test_sim_retry_budget_mirrors_daemon():
    # capacity fits one working set; the default (None) waits out the
    # backpressure and completes — budget 0 fails typed instead
    def run(m, max_retries):
        sim = m.Simulator("sage-nr", capacity=2 << 30, exit_ttl=0.5,
                          load_timeout_s=300.0)
        sim.register(m.SimFunction(m.PROFILES["bert"]))
        sim.submit("bert", 0.0)
        sim.submit("bert", 0.01, max_retries=max_retries)
        sim.run(until=900.0)
        return sim

    sims = {}
    for budget in (None, 0, 500):
        ref, sims[budget] = on_both(lambda m: run(m, budget))
        assert_same_sims(ref, sims[budget])
    flat = sims[None]  # default: unchanged flat-deadline behavior
    assert flat.completed == 2 and flat.failed == 0
    fast = sims[0]
    assert fast.completed == 1 and fast.failed == 1
    err = fast.telemetry.errors()[0]
    assert "DataLoadError" in err.error and err.max_retries == 0
    generous = sims[500]
    assert generous.completed == 2 and generous.failed == 0


def test_runtime_request_retry_budget_end_to_end():
    """Engine layer: Request.max_retries rides prepare() into the daemon
    and the typed failure lands in telemetry."""
    rt = SageRuntime("sage", device_capacity=10 * MB, load_timeout_s=10.0,
                     serialize_compute=False, **CPU)
    rt.sage_init()

    def handler(shim, request):
        for dd in request.in_data:
            shim.sage_load_to_gpu(dd.key).wait(30)

    fn = GPUFunction(name="f", handler=handler,
                     context_builder=lambda: object(),
                     context_bytes=1 * MB, container_s=0.0, cpu_ctx_s=0.0)
    rt.register_function(fn)
    block = threading.Event()

    def slow_handler(shim, request):
        for dd in request.in_data:
            shim.sage_load_to_gpu(dd.key).wait(30)
        block.wait(20)

    hold_fn = GPUFunction(name="hold", handler=slow_handler,
                          context_builder=lambda: object(),
                          context_bytes=1 * MB, container_s=0.0,
                          cpu_ctx_s=0.0)
    rt.register_function(hold_fn)
    hold = _wreq(fn="hold", w_mb=7, db=rt.db)
    fut_hold = rt.submit(hold)
    deadline = time.monotonic() + 5
    while rt.daemon.device_used < 7 * MB and time.monotonic() < deadline:
        time.sleep(0.01)  # holder's bytes are on device, handler parked
    req = _wreq(fn="f", w_mb=7, db=rt.db, max_retries=0)
    t0 = time.monotonic()
    fut = rt.submit(req)
    with pytest.raises(DataLoadError):
        fut.result(timeout=30)
    assert time.monotonic() - t0 < 5.0
    rec = rt.telemetry.find(req.uuid)
    assert rec.max_retries == 0 and "DataLoadError" in rec.error
    block.set()
    fut_hold.result(timeout=30)
    rt.shutdown()


def test_retry_budget_zero_fails_fast_even_behind_other_waiters():
    """Budget 0 charges the FIRST failed opportunity even when the request
    is queued behind an earlier waiter (non-head) — parity with the sim,
    which fails a budget-0 reservation at its inline reserve() attempt."""
    d, db = _daemon(cap_mb=10, load_timeout_s=10.0)
    hold = _wreq(fn="hold", w_mb=8, db=db)
    hh = d.prepare(hold)[hold.in_data[0].key]
    hh.wait(5)
    head_done = threading.Event()

    def head():  # parks at the head of the waiter heap, budget-less
        try:
            d.reserve_slot(8 * MB, timeout=10.0)
            d.release_slot(8 * MB)
        finally:
            head_done.set()

    threading.Thread(target=head).start()
    time.sleep(0.15)
    t0 = time.monotonic()
    with pytest.raises(OutOfDeviceMemory):
        d.reserve_slot(8 * MB, max_retries=0)  # non-head: still fail-fast
    assert time.monotonic() - t0 < 2.0
    d.release(hold, {hold.in_data[0].key: hh})
    assert head_done.wait(10)
    assert d.device_used == 0
    d.shutdown()


def test_daemon_retry_budget_counts_memory_events_not_poll_slices():
    """A small budget must survive a holder that releases later: only
    admission attempts that follow a memory event consume the budget, not
    the daemon's 50 ms poll wakes (parity with the sim's per-kick count)."""
    d, db = _daemon(cap_mb=10, load_timeout_s=10.0)
    hold = _wreq(fn="hold", w_mb=8, db=db)
    hh = d.prepare(hold)[hold.in_data[0].key]
    hh.wait(5)
    # ~0.6 s of waiting = ~12 poll slices; budget 2 must NOT be consumed
    threading.Timer(
        0.6, lambda: d.release(hold, {hold.in_data[0].key: hh})).start()
    req = _wreq(fn="ok", w_mb=8, db=db, max_retries=2)
    assert d.prepare(req)[req.in_data[0].key].wait(10) is not None
    d.release(req, {req.in_data[0].key: hh})
    d.shutdown()


def test_shared_entry_budget_widened_by_late_attacher():
    """A sharer attaching mid-wait widens the entry's budget and the
    in-flight admission wait must honor it (re-read, not a stale copy)."""
    db = Database(**CPU)
    d, _ = _daemon(cap_mb=10, db=db, load_timeout_s=10.0)
    hold = _wreq(fn="hold", w_mb=8, db=db)
    hh = d.prepare(hold)[hold.in_data[0].key]
    hh.wait(5)
    db.put("f/w", b"W", size=8 * MB)

    def ro_req(budget):
        r = Request(function_name="f", max_retries=budget)
        r.in_data = [Data(key="f/w", size=8 * MB, dtype=DataType.READ_ONLY)]
        return r

    tight = ro_req(1)  # one post-memory-event re-admission allowed
    ht = d.prepare(tight)["f/w"]
    time.sleep(0.2)  # loader is parked on the admission wait
    generous = ro_req(None)  # attaches: entry budget widens to None
    hg = d.prepare(generous)["f/w"]
    assert ht.entry is hg.entry and ht.entry.max_retries is None
    time.sleep(0.3)
    d.release(hold, {hold.in_data[0].key: hh})
    # with a stale budget=1 snapshot this would fail typed; widened it admits
    assert hg.wait(10) is not None
    d.shutdown()


def test_sim_kick_charges_blocked_head_once_per_memory_event():
    """Backfilling several small waiters in ONE kick must charge the
    blocked head's retry budget once, not once per loop iteration."""
    def run(m):
        node = m.GPUNode(m.get_system("sage"), m.VirtualClock(), capacity=100 * MB)
        node.used = 100 * MB  # full: everything below queues
        state = {"head": None, "smalls": 0, "log": []}
        node.reserve(50 * MB, lambda: state.__setitem__("head", "ok"),
                     on_fail=lambda: state.__setitem__("head", "failed"),
                     max_retries=2)
        for _ in range(3):
            node.reserve(2 * MB,
                         lambda: state.__setitem__("smalls", state["smalls"] + 1),
                         on_fail=lambda: None)
        head = node.pending_mem[0][1]
        state["log"].append((head.nbytes, head.attempts))
        node.release(10 * MB)  # one memory event: kick backfills all 3 smalls
        state["log"].append((state["smalls"], state["head"], head.attempts))
        node.release(60 * MB)  # now the head fits and is granted
        state["log"].append((state["head"], node.used))
        return state["log"]

    want, log = on_both(run)
    assert log == want
    assert log[0] == (50 * MB, 1)
    assert log[1] == (3, None, 2)  # charged ONCE
    assert log[2][0] == "ok"


# gateway knob plumbing + spec adoption/conflict (same rules as scheduler)

def test_gateway_dispatch_knob_plumbs_to_both_backends():
    gw = Gateway(backend="sim", policy="sage", n_nodes=2, dispatch="locality")
    assert gw.dispatch == "locality" and gw.sim.dispatch == "locality"
    with pytest.raises(ValueError):
        Gateway(backend="sim", dispatch="round_robin")
    with Gateway(backend="runtime", policy="sage", n_nodes=2,
                 dispatch="least_loaded", time_scale=0.02, **CPU) as gw_rt:
        assert gw_rt.runtime.dispatch == "least_loaded"


def test_spec_dispatch_adoption_and_conflict():
    with pytest.raises(ValueError):
        FunctionSpec(name="x", dispatch="everywhere")
    # an undecided gateway adopts the first spec's declared dispatch
    gw = Gateway(backend="sim", policy="sage", n_nodes=2)
    gw.register(FunctionSpec.from_profile("resnet50", dispatch="locality"))
    assert gw.dispatch == "locality" and gw.sim.dispatch == "locality"
    with pytest.raises(ValueError, match="dispatch"):
        gw.register(FunctionSpec.from_profile("bert", dispatch="random"))
    # an explicit constructor choice is not overridable by a spec
    gw2 = Gateway(backend="sim", policy="sage", n_nodes=2, dispatch="random")
    with pytest.raises(ValueError, match="dispatch"):
        gw2.register(FunctionSpec.from_profile("resnet50", dispatch="locality"))
    # agreement is fine and pins the knob
    gw2.register(FunctionSpec.from_profile("resnet50", dispatch="random"))


# dynamic node pool: deterministic dispatch across join/drain churn,
# identical on both drivers; draining nodes leave every policy's candidates

def _churn_sequence(gw):
    """One blocking invoke sequence across a node join and a drain; every
    dispatch decision happens on an idle pool, so the chosen node ids are
    a pure function of the shared scoring + residency state."""
    seq = [gw.invoke("a").node_id, gw.invoke("b").node_id,
           gw.invoke("a").node_id]
    gw.add_node()  # cold joiner enters the candidate set immediately
    seq.append(gw.invoke("c").node_id)
    gw.drain_node(seq[0])  # a's warm home leaves the pool mid-trace
    seq.append(gw.invoke("a").node_id)
    seq.append(gw.invoke("b").node_id)
    return seq


def _churn_specs(m):
    return [
        m.FunctionSpec(name="a", read_only_bytes=64 * MB,
                       writable_bytes=8 * MB, context_bytes=16 * MB),
        m.FunctionSpec(name="b", read_only_bytes=64 * MB,
                       writable_bytes=8 * MB, context_bytes=16 * MB),
        m.FunctionSpec(name="c", read_only_bytes=8 * MB,
                       writable_bytes=8 * MB, context_bytes=16 * MB),
    ]


def test_dynamic_pool_dispatch_identical_runtime_vs_sim():
    def run_sim(m):
        gw = m.Gateway(backend="sim", policy="sage", n_nodes=2, dispatch="locality")
        for s in _churn_specs(m):
            gw.register(s)
        return gw, _churn_sequence(gw)

    (ref_gw, ref_seq), (gw_sim, seq_sim) = on_both(run_sim)
    assert seq_sim == ref_seq
    assert_same_sims(ref_gw.sim, gw_sim.sim)
    with Gateway(backend="runtime", policy="sage", n_nodes=2,
                 dispatch="locality", time_scale=0.02, **CPU) as gw_rt:
        for s in _churn_specs(PORT):
            gw_rt.register(s)
        seq_rt = _churn_sequence(gw_rt)
    # record-for-record identical dispatch across join + drain churn
    assert seq_sim == seq_rt, (seq_sim, seq_rt)
    drained = seq_sim[0]
    # the drained node never serves again; its warm function re-homed
    assert drained not in seq_sim[4:]
    assert seq_sim[3] == "gpu2"  # the cold joiner won the cold function


def test_sim_policies_never_select_a_draining_node():
    # least_loaded: gpu0 wins the all-idle tie — unless it is draining
    def least(m):
        sim = m.Simulator("sage", n_nodes=2, seed=0, dispatch="least_loaded")
        sim.register(m.SimFunction(m.PROFILES["resnet50"]))
        sim.drain_node("gpu0")
        sim.submit("resnet50", 0.0)
        sim.run(until=300.0)
        return sim

    ref, sim = on_both(least)
    assert_same_sims(ref, sim)
    assert [r.node_id for r in sim.telemetry.snapshot()] == ["gpu1"]

    # locality: the residency holder drains mid-trace; device-tier
    # residency must not pull traffic back onto it
    def local(m):
        sim2 = m.Simulator("sage", n_nodes=2, seed=0, dispatch="locality")
        sim2.register(m.SimFunction(m.PROFILES["resnet50"]))
        sim2.submit("resnet50", 0.0)
        sim2.run(until=300.0)
        warm = sim2.telemetry.snapshot()[0].node_id
        tier = sim2.nodes[0].residency("resnet50")[0]
        sim2.drain_node(warm)
        sim2.submit("resnet50", sim2.clock.now() + 1.0)
        sim2.run(until=sim2.clock.now() + 300.0)
        return sim2, warm, tier

    (ref2, _, _), (sim2, warm, tier) = on_both(local)
    assert_same_sims(ref2, sim2)
    assert tier == "device"
    recs = sorted(sim2.telemetry.snapshot(), key=lambda r: r.arrival_t)
    assert recs[-1].node_id != warm and recs[-1].error is None


def test_runtime_policies_never_select_a_draining_node():
    for policy in ("least_loaded", "locality"):
        cluster = ClusterRuntime(n_nodes=2, seed=0, database=Database(**CPU),
                                 dispatch=policy, serialize_compute=False)
        cluster.sage_init()
        cluster.register_function(lambda i: _gpu_fn("f"))
        cluster.drain_node("gpu0")  # idle: retires immediately
        assert cluster.nodes[0].retired
        for _ in range(3):
            idx, _tier = cluster.select_node("f")
            assert idx == 1
        cluster.shutdown()


def test_telemetry_per_node_attribution_and_public_snapshot():
    tel = Telemetry()
    for i, (node, tier) in enumerate([("gpu0", "device"), ("gpu0", "none"),
                                      ("gpu1", "host"), ("gpu1", None)]):
        tel.add(InvocationRecord(request_id=f"r{i}", function="f",
                                 system="sage", node_id=node,
                                 dispatch_tier=tier))
    assert isinstance(tel.snapshot(), list) and len(tel.snapshot()) == 4
    assert tel.node_counts() == {"gpu0": 2, "gpu1": 2}
    assert set(tel.by_node()) == {"gpu0", "gpu1"}
    # hit rate over cluster-dispatched records only (tier None excluded)
    assert tel.dispatch_hit_rate() == pytest.approx(2 / 3)
    by_node = tel.dispatch_by_node()
    assert by_node["gpu0"] == {"requests": 2, "hits": 1, "hit_rate": 0.5}
    assert by_node["gpu1"] == {"requests": 1, "hits": 1, "hit_rate": 1.0}
    assert Telemetry().dispatch_hit_rate() == 0.0


# ---------------------------------------------------------------------------
# the gate: locality strictly beats random on p50 AND bytes_loaded, on
# BOTH backends. The scenarios are benchmarks/scaleout.py's
# (``_dispatch_trace``, ``dispatch_comparison_sim``/``_runtime``, :45-127),
# with their parameters word for word.
# ---------------------------------------------------------------------------

def _dispatch_trace(m, n_fns: int, repeats: int, *, gap_s: float = 4.0,
                    stagger_s: float = 0.05):
    """``repeats`` rounds of all ``n_fns`` functions, rounds close enough
    that warm state survives between them."""
    return m.TraceWorkload([
        (r * gap_s + i * stagger_s, f"fn{i}")
        for r in range(repeats) for i in range(n_fns)
    ])


def dispatch_comparison_sim(m, policy: str, *, n_fns: int = 8, repeats: int = 6,
                            n_nodes: int = 4, seed: int = 5):
    gw = m.Gateway(backend="sim", policy="sage", n_nodes=n_nodes,
                   dispatch=policy, loader_threads=2, seed=seed)
    for i in range(n_fns):
        gw.register(m.FunctionSpec(
            name=f"fn{i}", read_only_bytes=96 * MB, writable_bytes=8 * MB,
            context_bytes=64 * MB, compute_ms=20.0))
    tel = gw.replay(_dispatch_trace(m, n_fns, repeats), until_pad=600.0)
    assert tel.error_count() == 0, tel.errors()[0].error
    return gw, {
        "p50_duration": tel.p50_duration(),
        "bytes_loaded": float(sum(n.bytes_loaded for n in gw.sim.nodes)),
        "hit_rate": tel.dispatch_hit_rate(),
        "n": float(len(tel.records)),
    }


def dispatch_comparison_runtime(policy: str, *, n_fns: int = 6,
                                repeats: int = 5, n_nodes: int = 4,
                                seed: int = 5, ro_mb: int = 24,
                                stagger_s: float = 0.02) -> Dict[str, float]:
    """The same shape on the threaded cluster: synthetic functions whose
    handler waits on the daemon-prepared handles, one shared database."""
    db = Database(**CPU)
    cluster = ClusterRuntime(n_nodes=n_nodes, seed=seed, dispatch=policy,
                             database=db, loader_threads=2,
                             serialize_compute=False)
    cluster.sage_init()
    names = [f"fn{i}" for i in range(n_fns)]
    for name in names:
        db.put(f"{name}/weights", b"W", size=ro_mb * MB)
        cluster.register_function(
            lambda i, name=name: data_plane_function(name))

    try:
        futs = []
        for r in range(repeats):
            for name in names:
                req = Request(function_name=name)
                wkey = f"{name}/in/{r}"
                db.put(wkey, b"X", size=2 * MB)
                req.in_data = [
                    Data(key=f"{name}/weights", size=ro_mb * MB,
                         dtype=DataType.READ_ONLY),
                    Data(key=wkey, size=2 * MB, dtype=DataType.WRITABLE),
                ]
                futs.append(cluster.submit(req))
                # small stagger so residency from the previous submits is
                # visible to the next dispatch decision
                time.sleep(stagger_s)
        for f in futs:
            f.result(timeout=120)
        tel = cluster.telemetry
        out = {
            "p50_duration": tel.p50_duration(),
            "bytes_loaded": float(sum(n.daemon.stats["bytes_loaded"]
                                      for n in cluster.nodes)),
            "hit_rate": tel.dispatch_hit_rate(),
            "n": float(len(tel.records)),
        }
        assert tel.error_count() == 0, tel.errors()[0].error
        assert_cluster_keys(cluster)
        return out
    finally:
        cluster.shutdown()


def test_locality_strictly_beats_random_sim():
    out = {}
    for policy in ("random", "locality"):
        (ref_gw, want), (gw, out[policy]) = on_both(
            lambda m: dispatch_comparison_sim(m, policy))
        assert out[policy] == want
        assert_same_sims(ref_gw.sim, gw.sim)
    rnd, loc = out["random"], out["locality"]
    assert loc["p50_duration"] < rnd["p50_duration"]
    assert loc["bytes_loaded"] < rnd["bytes_loaded"]
    assert loc["hit_rate"] > rnd["hit_rate"]


def test_locality_strictly_beats_random_runtime():
    rnd = dispatch_comparison_runtime("random")
    loc = dispatch_comparison_runtime("locality")
    assert loc["p50_duration"] < rnd["p50_duration"]
    assert loc["bytes_loaded"] < rnd["bytes_loaded"]
    assert loc["hit_rate"] > rnd["hit_rate"]


# ---------------------------------------------------------------------------
# tests/test_planner.py: planner, forecast, autoscaler (pure units)
# ---------------------------------------------------------------------------

def _fn(m, name="f", ro_mb=64.0, w_mb=8.0, ctx_mb=414.0, compute_ms=10.0):
    return m.SimFunction(m.FunctionProfile(name, "test", context_mb=ctx_mb,
                                           read_only_mb=ro_mb, writable_mb=w_mb,
                                           compute_ms=compute_ms))


def test_planner_bin_packing_deterministic_heaviest_first():
    def build(m):
        p = m.PlacementPlanner()
        p.set_nodes(["gpu0", "gpu1"])
        p.register_function("big", 100 * MB)
        p.register_function("mid", 60 * MB)
        p.register_function("small", 10 * MB)
        return p

    ref, p = on_both(build)
    # heaviest lands first on the least-loaded node (ties by id): big
    # takes gpu0, mid the emptier gpu1, small joins the lighter bin
    assert p.plan == {"big": ("gpu0",), "mid": ("gpu1",),
                      "small": ("gpu1",)}
    # byte-identical across rebuilds and across the packages
    assert build(PORT).plan == p.plan == ref.plan


def test_planner_replicas_scale_with_forecast_rate():
    p = PlacementPlanner()  # replica_rate = 8 arrivals/s per extra home
    p.set_nodes(["gpu0", "gpu1", "gpu2"])
    p.register_function("hot", 64 * MB)
    assert p.plan["hot"] == ("gpu0",)
    p.set_rate("hot", 20.0)  # 1 + int(20/8) = 3 homes
    p.replan()
    assert len(p.plan["hot"]) == 3
    p.set_rate("hot", 100.0)  # capped at the node count
    p.replan()
    assert len(p.plan["hot"]) == 3


def test_planner_pick_home_hit_spill_and_health():
    p = PlacementPlanner()
    p.set_nodes(["gpu0", "gpu1"])
    p.register_function("f", MB)
    assert p.plan["f"] == ("gpu0",)
    idx, hit = p.pick("f", [_snap("gpu0"), _snap("gpu1")])
    assert (idx, hit) == (0, True)
    # saturated home (queue_pressure >= spill_pressure 4): spill = miss
    busy = _snap("gpu0", queue=20, workers=4)
    idx, hit = p.pick("f", [busy, _snap("gpu1")])
    assert (idx, hit) == (1, False)
    # a crashed home is never a planned hit: the pick spills
    dead = _snap("gpu0", healthy=False)
    _, hit = p.pick("f", [dead, _snap("gpu1")])
    assert hit is False
    assert p.planned_hits == 1 and p.planned_misses == 2
    assert p.hit_rate() == pytest.approx(1 / 3)


def test_planner_sustained_misses_force_replan():
    p = PlacementPlanner(PlannerConfig(miss_window=8, replan_miss_rate=0.5))
    p.set_nodes(["gpu0", "gpu1"])
    p.register_function("f", MB)
    r0 = p.replans
    busy = _snap("gpu0", queue=40, workers=4)
    for _ in range(8):  # 8 straight misses > 0.5 * 8 -> repair
        p.pick("f", [busy, _snap("gpu1")])
    assert p.replans == r0 + 1
    assert len(p._window) == 0  # replan clears the evaluation window


def test_planner_drain_candidate_carries_least_weight():
    p = PlacementPlanner()
    p.set_nodes(["gpu0", "gpu1"])
    p.register_function("big", 100 * MB)
    p.register_function("small", MB)
    # big homes on gpu0, small on gpu1: gpu1 is the cheap node to drain
    assert p.drain_candidate() == "gpu1"
    p.retire_function("small")
    assert "small" not in p.plan
    assert p.drain_candidate() == "gpu1"  # now carries nothing


def test_rate_forecast_ewma_folds_per_tick_counts():
    f = RateForecast(alpha=0.5)
    for _ in range(10):
        f.note_arrival("a")
    assert f.tick(5.0)["a"] == 2.0  # first observation seeds the EWMA
    f.note_arrival("a")
    assert f.tick(1.0)["a"] == pytest.approx(1.5)  # 0.5*1 + 0.5*2
    assert f.tick(1.0)["a"] == pytest.approx(0.75)  # silence decays it
    assert f.total() == pytest.approx(0.75)
    assert f.tick(0.0)["a"] == pytest.approx(0.75)  # dt<=0 is a no-op


def test_autoscaler_hysteresis_streaks_and_clamps():
    scaler = Autoscaler(AutoscaleConfig(
        min_nodes=1, max_nodes=4, node_rate_per_s=10.0, tick_s=1.0,
        ewma_alpha=0.5, headroom=1.0, up_ticks=2, down_ticks=2))
    # up needs a 2-tick streak
    assert scaler.decide(35.0, 1) == (0, [])
    assert scaler.decide(35.0, 1) == (3, []) and scaler.scale_ups == 1
    # target clamps at max_nodes
    assert scaler.decide(1000.0, 4) == (0, []) and scaler.last_target == 4
    # down needs its own streak, then drains ONE node per decision
    assert scaler.decide(0.0, 4) == (0, [])
    assert scaler.decide(0.0, 4) == (0, ["drain"])
    assert scaler.scale_downs == 1
    # never drains below min_nodes
    assert scaler.decide(0.0, 1) == (0, [])
    # an up-tick resets the down streak
    scaler.decide(0.0, 4)
    scaler.decide(50.0, 4)
    assert scaler.decide(0.0, 4) == (0, [])  # streak restarted


def test_autoscale_config_validation_and_resolve_forms():
    with pytest.raises(ValueError):
        AutoscaleConfig(min_nodes=0)
    with pytest.raises(ValueError):
        AutoscaleConfig(min_nodes=4, max_nodes=2)
    with pytest.raises(ValueError):
        AutoscaleConfig(tick_s=0.0)
    with pytest.raises(ValueError):
        AutoscaleConfig(ewma_alpha=0.0)
    assert resolve_autoscale(None) is None
    cfg = AutoscaleConfig(min_nodes=2, max_nodes=4)
    assert resolve_autoscale(cfg) is cfg
    assert resolve_autoscale({"min_nodes": 2, "max_nodes": 4}) == cfg
    with pytest.raises(ValueError, match="autoscale"):
        resolve_autoscale(5)


def test_control_node_seconds_integral_and_timeline():
    c = PlacementControl(["gpu0", "gpu1"], now=0.0)
    assert c.node_seconds(10.0) == pytest.approx(20.0)
    c.node_provisioned("gpu2", 10.0)
    assert c.node_seconds(20.0) == pytest.approx(50.0)
    c.node_draining("gpu2")  # off the placement set, still costing
    assert c.active_nodes() == ["gpu0", "gpu1"]
    assert c.node_seconds(30.0) == pytest.approx(80.0)
    c.node_retired("gpu2", 30.0)
    assert c.node_seconds(40.0) == pytest.approx(100.0)
    st = c.stats(40.0)
    assert st["node_timeline"] == [(0.0, 2), (10.0, 3), (30.0, 2)]
    assert st["provisioned_nodes"] == 2 and st["active_nodes"] == 2
    assert st["node_seconds"] == pytest.approx(100.0)


def test_control_route_boards_above_watermark_and_reroute_steals():
    def run(m):
        c = m.PlacementControl(["gpu0", "gpu1"], now=0.0)
        c.register_function("f", MB)
        calm = [_snap("gpu0", m=m), _snap("gpu1", m=m)]
        storm = [_snap("gpu0", queue=28, workers=4, m=m),
                 _snap("gpu1", queue=28, workers=4, m=m)]
        out = [c.route("f", calm), c.route("f", storm), c.boards,
               c.route("f", storm, allow_board=False)[0],
               c.reroute("f", calm, "gpu0"),
               c.reroute("f", [_snap("gpu0", queue=40, workers=4, m=m),
                               _snap("gpu1", m=m)], "gpu0"),
               c.steals]
        return out

    want, got = on_both(run)
    assert got == want
    calm_route, storm_route, boards, no_board, home, away, steals = got
    assert calm_route == ("start", 0, True)
    # every candidate above steal_watermark 6: the arrival boards
    assert storm_route[0] == "board" and boards == 1
    # the stealer can be told not to board (the re-route itself)
    assert no_board == "start"
    # landing back home is not a steal; landing elsewhere is
    assert home == (0, False)
    assert away == (1, True) and steals == 1


# sim driver: dynamic pool, exact drain teardown, stealing under pressure

def test_sim_add_node_then_drain_releases_exactly():
    def run(m):
        sim = m.Simulator("sage", n_nodes=2, seed=1, dispatch="planned")
        sim.register(_fn(m, "a"))
        node = sim.add_node()
        seen = {"joiner": (node.name, len(sim.nodes), "a" in node.instances)}
        sim.submit("a", 0.0)
        sim.run(until=60.0)
        seen["completed"] = sim.completed
        home = sim.telemetry.snapshot()[0].node_id
        sim.drain_node(home)
        drained = next(n for n in sim.nodes if n.name == home)
        # idle at drain time: teardown is immediate and byte-exact
        seen["drained"] = (drained.draining, drained.retired, drained.used,
                           drained.host_used)
        sim.drain_node(home)  # idempotent
        # post-drain arrivals never target the retired node
        sim.submit("a", sim.clock.now() + 1.0)
        sim.run(until=sim.clock.now() + 120.0)
        return sim, home, seen

    (ref, _, want), (sim, home, seen) = on_both(run)
    assert seen == want
    assert_same_sims(ref, sim)
    # the joiner got every registered function
    assert seen["joiner"] == ("gpu2", 3, True)
    assert seen["completed"] == 1
    assert seen["drained"] == (True, True, 0, 0)
    assert sim.completed == 2
    assert sim.telemetry.snapshot()[-1].node_id != home
    st = sim.placement_stats()
    assert st["provisioned_nodes"] == 2 and st["active_nodes"] == 2
    assert sim.resilience_stats()["node_drains"] == 1


def test_sim_manual_drain_waits_for_untracked_inflight_work():
    """Without faults/control the sim never maintains per-node active
    sets — a zero-payload invocation mid-context-build is invisible to
    ``is_idle()``. A manual drain must still never tear the node down
    under it: finalize waits for whole-sim quiescence (``inflight``)."""
    def run(m):
        sim = m.Simulator("sage", n_nodes=1)
        sim.register(_fn(m, "a", ro_mb=0.0, w_mb=0.0, compute_ms=50.0))
        sim.submit("a", 0.0)
        # drain fires mid ctx build (CPU+GPU ctx ~= 0.33 virtual s)
        sim.clock.schedule_at(0.1, sim.drain_node, "gpu0", kind=m.EventKind.TIMER)
        sim.run(until=0.2)
        node = sim.nodes[0]
        mid = (node.draining, node.retired, sim.inflight)
        sim.run(until=60.0)
        return sim, mid

    (ref, want), (sim, mid) = on_both(run)
    assert mid == want
    assert_same_sims(ref, sim)
    assert mid == (True, False, 1)  # deferred, not torn down
    node = sim.nodes[0]
    # the invocation completed and the drain finalized at that boundary
    assert sim.completed == 1 and sim.failed == 0
    assert sim.inflight == 0
    assert node.retired and node.used == 0


def test_sim_planned_boarding_under_loader_pressure():
    def run(m):
        sim = m.Simulator("sage", n_nodes=2, seed=0, dispatch="planned",
                          loader_threads=1)
        sim.register(_fn(m, "hot", ro_mb=256.0, w_mb=32.0, compute_ms=50.0))
        for i in range(40):
            sim.submit("hot", 0.001 * i)
        sim.run(until=900.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    assert sim.completed == 40 and sim.failed == 0
    st = sim.placement_stats()
    # the burst drove every candidate above the steal watermark: arrivals
    # parked on the board, and each boarded arrival still completed
    assert st["boards"] > 0
    assert st["planned_hits"] + st["planned_misses"] + st["boards"] >= 40


def test_runtime_add_node_then_drain_releases_exactly():
    cluster = ClusterRuntime(n_nodes=2, seed=0, database=Database(**CPU),
                             dispatch="planned", serialize_compute=False)
    cluster.sage_init()
    cluster.register_function(lambda i: _gpu_fn("f"))
    node = cluster.add_node()
    assert node.node_id == "gpu2" and len(cluster.nodes) == 3
    req = Request(function_name="f")
    cluster.submit(req).result(timeout=30)
    home = cluster.telemetry.find(req.uuid).node_id
    cluster.drain_node(home)
    drained = next(n for n in cluster.nodes if n.node_id == home)
    deadline = time.monotonic() + 10
    while not drained.retired and time.monotonic() < deadline:
        cluster.placement_stats()  # finalize rides the stats poll too
        time.sleep(0.02)
    assert drained.retired and drained.daemon.device_used == 0
    assert drained.daemon.host_used == 0
    # the drained node's engines were destroyed by the exact teardown
    assert all(not e.instances for e in drained.engines.values())
    req2 = Request(function_name="f")
    cluster.submit(req2).result(timeout=30)
    assert cluster.telemetry.find(req2.uuid).node_id != home
    st = cluster.placement_stats()
    assert st["provisioned_nodes"] == 2 and st["active_nodes"] == 2
    assert_cluster_keys(cluster)
    cluster.shutdown()


# degradation-adaptive transfer pacing

def test_broker_degradation_composes_and_restores_exactly():
    b = BandwidthBroker(8e9)
    b.apply_degradation(0.5)
    b.apply_degradation(0.5)  # overlapping fault windows compose
    assert b.degradation == pytest.approx(0.25)
    assert b.bw == pytest.approx(2e9)
    b.clear_degradation(0.5)
    b.clear_degradation(0.5)
    assert b.degradation == 1.0 and b.bw == 8e9  # exact snap, no drift
    with pytest.raises(ValueError):
        b.apply_degradation(0.0)
    b.apply_degradation(0.3)
    b.clear_degradation()  # factor=None: unconditional full restore
    assert b.degradation == 1.0 and b.bw == 8e9


def test_chunk_hint_scales_with_link_degradation():
    arb = LinkArbiter("preemptive")
    b = BandwidthBroker(8e9)
    assert arb.chunk_hint(b) == DEFAULT_CHUNK_BYTES
    b.apply_degradation(0.25)  # 4x slower link -> 4x smaller chunks
    assert arb.chunk_hint(b) == DEFAULT_CHUNK_BYTES // 4
    b.apply_degradation(1e-9)  # floor: bookkeeping must not dominate
    assert arb.chunk_hint(b) == MIN_CHUNK_BYTES
    assert arb.chunk_hint(None) == DEFAULT_CHUNK_BYTES
    assert LinkArbiter("run_to_completion").chunk_hint(b) is None


def test_sim_degradation_window_restores_bandwidth_exactly():
    def run(m):
        plan = m.FaultPlan([m.LinkDegradation(at_s=0.5, duration_s=5.0,
                                              factor=0.25, link="pcie")])
        sim = m.Simulator("sage", faults=plan)
        sim.register(_fn(m, "a"))
        sim.submit("a", 1.0)  # loads inside the degraded window
        sim.run(until=120.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    node = sim.nodes[0]
    assert sim.completed == 1
    assert node.pcie.degradation == 1.0
    assert node.pcie.bw == node.pcie.base_bw


# gateway knob: autoscale spec adoption / conflict (same rules as dispatch)

def test_gateway_autoscale_spec_adoption_and_conflict():
    with pytest.raises(ValueError, match="autoscale"):
        FunctionSpec(name="x", autoscale=5)
    cfg = AutoscaleConfig(min_nodes=1, max_nodes=4)
    # the ergonomic dict literal normalizes to the frozen config
    spec = FunctionSpec.from_profile(
        "resnet50", autoscale={"min_nodes": 1, "max_nodes": 4})
    assert spec.autoscale == cfg
    gw = Gateway(backend="sim", policy="sage", n_nodes=2)
    gw.register(spec)
    assert gw.autoscale == cfg and gw.sim.autoscale == cfg
    with pytest.raises(ValueError, match="autoscale"):
        gw.register(FunctionSpec.from_profile(
            "bert", autoscale=AutoscaleConfig(min_nodes=2, max_nodes=8)))
    gw.register(FunctionSpec.from_profile("vgg11", autoscale=cfg))  # agrees
    # an explicit constructor choice is not overridable by a spec
    gw2 = Gateway(backend="sim", policy="sage", n_nodes=2, autoscale=cfg)
    with pytest.raises(ValueError, match="autoscale"):
        gw2.register(FunctionSpec.from_profile(
            "resnet50", autoscale=AutoscaleConfig(min_nodes=2, max_nodes=8)))


def test_gateway_sim_autoscaler_follows_load_end_to_end():
    def run(m):
        gw = m.Gateway(backend="sim", policy="sage", n_nodes=2, dispatch="planned",
                       autoscale=m.AutoscaleConfig(
                           min_nodes=2, max_nodes=6, node_rate_per_s=2.0,
                           tick_s=2.0, ewma_alpha=0.5, headroom=1.2,
                           up_ticks=1, down_ticks=2))
        gw.register(m.FunctionSpec.from_profile("resnet50", name="a"))
        # a sustained 10/s burst then silence: the pool grows, then drains
        for i in range(200):
            gw.invoke_async("a", at=0.1 * i)
        for i in range(20):
            gw.invoke_async("a", at=30.0 + 2.5 * i)
        gw.sim.run()  # drain virtual time
        return gw

    ref, gw = on_both(run)
    assert_same_sims(ref.sim, gw.sim)
    st = gw.placement_stats()
    assert st == ref.placement_stats()
    assert st["scale_ups"] >= 1 and st["scale_downs"] >= 1
    peak = max(n for _, n in st["node_timeline"])
    assert peak > 2  # grew past the floor...
    assert st["provisioned_nodes"] < peak  # ...and shrank back down
    assert gw.report().error_count() == 0


# ---------------------------------------------------------------------------
# the gate: planned+autoscale strictly beats the locality pool, on BOTH
# drivers. The scenarios are benchmarks/planner.py's quick runs
# (DEFAULT_SEED, N_MAX, N_MIN, CLASSES, AUTOSCALE_SIM, _diurnal_arrivals,
# run_sim, run_runtime; :32-198), with their parameters word for word.
# ---------------------------------------------------------------------------

PLANNER_SEED = 11
N_MAX = 8   # the static pool locality gets; the autoscaler's cap (sim)
N_MIN = 2   # autoscaler floor = the planned run's starting pool (sim)
PLANNER_CLASSES: Dict[str, Tuple[float, float, int]] = {
    "fn0": (1.5, 5.0, 2),
    "fn1": (1.5, 5.0, 2),
    "fn2": (1.5, 30.0, 0),
    "fn3": (1.5, 30.0, 0),
    "fn4": (1.5, 30.0, 0),
    "fn5": (1.5, 30.0, 0),
}


def _autoscale_sim(m):
    return m.AutoscaleConfig(
        min_nodes=N_MIN, max_nodes=N_MAX, node_rate_per_s=2.5, tick_s=5.0,
        ewma_alpha=0.35, headroom=1.3, up_ticks=1, down_ticks=3)


def _diurnal_arrivals(m, classes, duration_s: float, period_s: float,
                      seed: int) -> List:
    """Phase-staggered per-function diurnal traces, merged and sorted."""
    events = []
    for i, (fn, (rate, dl, pr)) in enumerate(sorted(classes.items())):
        wl = m.DiurnalWorkload(fn, rate, duration_s, amplitude=0.9,
                               period_s=period_s, phase_s=i * period_s / 8.0,
                               seed=seed, deadline_s=dl, priority=pr)
        events.extend(wl.events())
    events.sort(key=lambda a: a.t)
    return events


def _slo(t) -> Dict[int, float]:
    return {p: round(c["attainment"], 4)
            for p, c in sorted(t.slo_by_priority().items())}


def planner_run_sim(m, planned: bool, seed: int = PLANNER_SEED):
    duration = 240.0  # quick
    period = duration / 2.0
    horizon = duration + 60.0
    kw = dict(backend="sim", policy="sage", seed=seed, loader_threads=2)
    if planned:
        gw = m.Gateway(n_nodes=N_MIN, dispatch="planned",
                       autoscale=_autoscale_sim(m), **kw)
    else:
        gw = m.Gateway(n_nodes=N_MAX, dispatch="locality", **kw)
    for fn, (rate, dl, pr) in sorted(PLANNER_CLASSES.items()):
        gw.register(m.FunctionSpec(
            name=fn, read_only_bytes=96 * MB, writable_bytes=8 * MB,
            context_bytes=64 * MB, compute_ms=20.0,
            deadline_s=dl, priority=pr))
    t = gw.replay(_diurnal_arrivals(m, PLANNER_CLASSES, duration, period, seed),
                  until=horizon)
    assert t.error_count() == 0, t.errors()[0].error
    ps = gw.placement_stats()
    node_seconds = (ps["node_seconds"] if ps is not None
                    else N_MAX * horizon)
    out = {
        "arrivals": len(t.snapshot()),
        "slo": _slo(t),
        "node_seconds": round(float(node_seconds), 3),
        "p99_e2e_s": round(t.p99_e2e(), 4),
    }
    if ps is not None:
        out["placement"] = {k: ps[k] for k in (
            "planned_hits", "planned_misses", "hit_rate", "replans",
            "boards", "steals", "scale_ups", "scale_downs")}
    return gw, out


def planner_run_runtime(planned: bool, seed: int = PLANNER_SEED):
    duration = 10.0  # quick
    n_max, n_min, ro_mb = 4, 2, 24
    names = [f"fn{i}" for i in range(4)]
    classes = {fn: (2.5, 3.0 if i < 2 else 10.0, 2 if i < 2 else 0)
               for i, fn in enumerate(names)}
    db = Database(**CPU)
    kw = dict(database=db, loader_threads=2, serialize_compute=False)
    if planned:
        auto = AutoscaleConfig(
            min_nodes=n_min, max_nodes=n_max, node_rate_per_s=4.0,
            tick_s=0.5, ewma_alpha=0.4, headroom=1.3,
            up_ticks=1, down_ticks=2)
        cluster = ClusterRuntime(n_nodes=n_min, seed=seed,
                                 dispatch="planned", autoscale=auto, **kw)
    else:
        cluster = ClusterRuntime(n_nodes=n_max, seed=seed,
                                 dispatch="locality", **kw)
    cluster.sage_init()
    clk = cluster.nodes[0].clock
    t0 = clk.now()
    for name in names:
        db.put(f"{name}/weights", b"W", size=ro_mb * MB)
        cluster.register_function(
            lambda i, name=name: data_plane_function(name))
    events = _diurnal_arrivals(PORT, classes, duration, duration, seed)
    try:
        futs = []
        start = time.monotonic()
        for k, a in enumerate(events):
            lag = start + a.t - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            wkey = f"{a.function}/in/{k}"
            db.put(wkey, b"X", size=2 * MB)
            req = Request(function_name=a.function)
            req.in_data = [
                Data(key=f"{a.function}/weights", size=ro_mb * MB,
                     dtype=DataType.READ_ONLY),
                Data(key=wkey, size=2 * MB, dtype=DataType.WRITABLE),
            ]
            req.deadline_s, req.priority = a.deadline_s, a.priority
            futs.append(cluster.submit(req))
        for f in futs:
            f.result(timeout=120)
        t1 = clk.now()
        tel = cluster.telemetry
        assert tel.error_count() == 0, tel.errors()[0].error
        ps = cluster.placement_stats()
        node_seconds = (ps["node_seconds"] if ps is not None
                        else n_max * (t1 - t0))
        out = {
            "arrivals": len(tel.snapshot()),
            "slo": _slo(tel),
            "node_seconds": round(float(node_seconds), 3),
            "p99_e2e_s": round(tel.p99_e2e(), 4),
        }
        if ps is not None:
            out["placement"] = {k: ps[k] for k in (
                "planned_hits", "hit_rate", "scale_ups", "scale_downs")}
            assert_cluster_keys(cluster)
        return out
    finally:
        cluster.shutdown()


def test_planned_strictly_beats_locality_pool_sim():
    out = {}
    for planned in (False, True):
        (ref_gw, want), (gw, out[planned]) = on_both(
            lambda m: planner_run_sim(m, planned))
        assert out[planned] == want
        assert_same_sims(ref_gw.sim, gw.sim)
    baseline, planned = out[False], out[True]
    # equal-or-better per-class SLO attainment at strictly lower
    # node-seconds
    assert planned["node_seconds"] < baseline["node_seconds"]
    for pri, att in baseline["slo"].items():
        assert planned["slo"][pri] >= att
    assert planned["placement"]["hit_rate"] > 0.8
    assert planned["placement"]["scale_ups"] >= 1


def test_planned_strictly_beats_locality_pool_runtime():
    baseline = planner_run_runtime(False)
    planned = planner_run_runtime(True)
    assert planned["node_seconds"] < baseline["node_seconds"]
    for pri, att in baseline["slo"].items():
        assert planned["slo"][pri] >= att
    assert planned["placement"]["hit_rate"] > 0.8


def test_arrival_rows_equal_reference():
    """The planner gate's diurnal arrivals, drawn by the port's workload
    generators, equal the reference's event for event."""
    ref, port = on_both(lambda m: [(a.t, a.function, a.deadline_s, a.priority)
                                   for a in _diurnal_arrivals(
                                       m, PLANNER_CLASSES, 240.0, 120.0, PLANNER_SEED)])
    assert port == ref and len(port) > 0
