"""The port's resilience and compute planes (``repro_torch.core.
{faults,slowness,compute}``) held against the JAX package's, case by case:
the cases of tests/test_faults.py (the fault plan and its draws, the
circuit breaker, shedding, crash/evict/re-dispatch on both drivers, typed
rejections, and the chaos gate: hardened goodput >= 2x naive on both
drivers under the same seeded fault schedule), tests/test_slowness.py (the
straggler primitives, the slowness detector, the hedge estimate, the knob
surfaces and the quarantine state machine) and tests/test_compute.py
(slicing, packing, the EDF-slack batching guard, knob plumbing and the
runtime<->sim batch parity).

Virtual-time and pure-unit cases run the same scenario through both
packages and assert that every record and counter is equal, then make the
reference's assertions on the port's run. Threaded cases make the
reference's assertions on the port and hold its stats key sets to the
reference runtime's. The chaos scenario is copied word for word from the
reference's benchmarks/chaos.py (which imports the JAX package).
Everything runs on the CPU (``device="cpu"``)."""
import dataclasses
import importlib
import time
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import pytest

pytest.importorskip("torch")

from repro_torch.api.gateway import Gateway  # noqa: E402
from repro_torch.api.spec import FunctionSpec  # noqa: E402
from repro_torch.api.workload import ChaosWorkload  # noqa: E402
from repro_torch.core.compute import (  # noqa: E402
    ComputeConfig, ComputePlane, batch_hold_s, batched_span,
    empty_compute_stats, resolve_compute, slices_for,
)
from repro_torch.core.faults import (  # noqa: E402
    BreakerConfig, CircuitBreaker, FaultPlan, LinkDegradation, LoaderFault,
    NodeCrash, ShedError, SheddingConfig, node_pressure,
)
from repro_torch.core.profiles import MB  # noqa: E402
from repro_torch.core.slowness import (  # noqa: E402
    HEDGE_STAT_KEYS, EwmaDetector, HedgeConfig, QuarantineConfig,
    QuarantineController, SlownessDetector, _DurationWindow, make_detector,
    resolve_hedging, resolve_quarantine,
)

CPU = dict(device="cpu")


# ---------------------------------------------------------------------------
# both packages
# ---------------------------------------------------------------------------

def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    sim, prof, faults, api = (mod("core.simulator"), mod("core.profiles"),
                              mod("core.faults"), mod("api"))
    return SimpleNamespace(
        root=root, Simulator=sim.Simulator, SimFunction=sim.SimFunction,
        FunctionProfile=prof.FunctionProfile, Gateway=api.Gateway,
        FunctionSpec=api.FunctionSpec, Arrival=api.Arrival,
        TraceWorkload=api.TraceWorkload, ChaosWorkload=api.ChaosWorkload,
        FaultPlan=faults.FaultPlan, NodeCrash=faults.NodeCrash,
        LoaderFault=faults.LoaderFault, LinkDegradation=faults.LinkDegradation,
        DbFlap=faults.DbFlap, BreakerConfig=faults.BreakerConfig,
        SheddingConfig=faults.SheddingConfig,
        CircuitBreaker=faults.CircuitBreaker,
        ShedError=faults.ShedError, BreakerOpenError=faults.BreakerOpenError,
        ComputePlane=mod("core.compute").ComputePlane,
        ComputeConfig=mod("core.compute").ComputeConfig,
        SlownessDetector=mod("core.slowness").SlownessDetector,
        QuarantineController=mod("core.slowness").QuarantineController,
        QuarantineConfig=mod("core.slowness").QuarantineConfig)


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def on_both(run):
    """``run(pkg)`` on the JAX package's control plane and the port's;
    returns (reference, port)."""
    return run(REF), run(PORT)


NODE_FIELDS = ("name", "capacity", "used", "host_used", "host_evictions",
               "inflight_loads", "max_inflight_loads", "load_failures",
               "loads", "bytes_loaded", "crashes", "healthy", "active")


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


def ref_gateway_keys() -> dict:
    """The stats key sets of the reference's runtime gateway, with the
    control layer on (eviction, breaker, shedding) and shared compute."""
    gw = REF.Gateway(backend="runtime", n_nodes=2, seed=0, eviction=True,
                     compute="shared", dispatch="planned")
    try:
        return {"resilience": set(gw.resilience_stats()),
                "compute": set(gw.compute_stats()),
                "placement": set(gw.placement_stats()),
                "daemon": set(gw._nodes[0].daemon.stats),
                "memory": set(gw.memory_usage())}
    finally:
        gw.shutdown()


def assert_gateway_keys(gw):
    want = ref_gateway_keys()
    assert set(gw.resilience_stats()) == want["resilience"]
    assert set(gw.compute_stats()) == want["compute"]
    assert set(gw._nodes[0].daemon.stats) == want["daemon"]
    assert set(gw.memory_usage()) == want["memory"]
    if gw.placement_stats() is not None:
        assert set(gw.placement_stats()) == want["placement"]


def _fn(m, name="f", ro_mb=64.0, w_mb=8.0, ctx_mb=414.0, compute_ms=10.0):
    return m.SimFunction(m.FunctionProfile(name, "test", context_mb=ctx_mb,
                                           read_only_mb=ro_mb, writable_mb=w_mb,
                                           compute_ms=compute_ms))


# ---------------------------------------------------------------------------
# tests/test_faults.py: plan + draws
# ---------------------------------------------------------------------------

def test_fault_plan_events_sorted_and_paired():
    def run(m):
        return m.FaultPlan([
            m.NodeCrash("gpu1", at_s=5.0, restart_after_s=10.0),
            m.LinkDegradation(at_s=2.0, duration_s=3.0, factor=0.5),
            m.DbFlap(at_s=1.0, duration_s=2.0),
        ]).events()

    want, ev = on_both(run)
    assert [(t, k) for t, k, _ in ev] == [(t, k) for t, k, _ in want]
    assert [t for t, _, _ in ev] == sorted(t for t, _, _ in ev)
    kinds = [k for _, k, _ in ev]
    assert kinds.count("crash") == 1 and kinds.count("restart") == 1
    assert kinds.count("degrade_on") == kinds.count("degrade_off") == 1
    assert kinds.count("db_down") == kinds.count("db_up") == 1


def test_fault_plan_validation():
    with pytest.raises(ValueError):
        NodeCrash("gpu0", at_s=-1.0)
    with pytest.raises(ValueError):
        LinkDegradation(at_s=0.0, duration_s=1.0, factor=1.5)
    with pytest.raises(ValueError):
        LoaderFault("f", probability=2.0)
    with pytest.raises(TypeError):
        FaultPlan(["not a spec"])


def test_draws_deterministic_and_independent():
    def run(m):
        plan = m.FaultPlan([m.LoaderFault("a", 0.5), m.LoaderFault("b", 0.5)], seed=9)
        d1, d2 = plan.make_draws(), plan.make_draws()
        seq1 = [(d1.draw("a", t), d1.draw("b", t)) for t in range(50)]
        seq2 = [(d2.draw("a", t), d2.draw("b", t)) for t in range(50)]
        return seq1, seq2, d1.draw("other", 0.0)

    want, (seq1, seq2, other) = on_both(run)
    assert (seq1, seq2, other) == want  # the same stream on both packages
    assert seq1 == seq2  # same seed -> identical stream on both backends
    assert any(a for a, _ in seq1) and any(not a for a, _ in seq1)
    # functions without specs never draw (no stream perturbation)
    assert other is False


def test_draw_advances_outside_window():
    """The stream advances once per arrival regardless of the fault
    window, so window membership can't drift the draw sequence."""
    windowed = FaultPlan([LoaderFault("f", 1.0, start_s=10.0, end_s=20.0)],
                         seed=4).make_draws()
    always = FaultPlan([LoaderFault("f", 1.0)], seed=4).make_draws()
    assert windowed.draw("f", 0.0) is False   # outside window: no fault...
    assert always.draw("f", 0.0) is True
    assert windowed.draw("f", 15.0) is True   # ...but the stream advanced


# circuit breaker state machine

def test_breaker_trips_cools_and_recloses():
    def run(m):
        now = [0.0]
        cfg = m.BreakerConfig(failure_threshold=0.5, window=10, min_requests=4,
                              cooldown_s=5.0, half_open_probes=2)
        br = m.CircuitBreaker(cfg, lambda: now[0])
        log = [br.state]
        for _ in range(4):
            log.append(br.allow())
            br.record(False)
        log += [br.state, br.allow()]  # still cooling
        now[0] = 6.0
        log += [br.allow(), br.allow(), br.allow()]  # two probes, then none
        br.record(True)
        br.record(True)
        log.append(br.state)
        return log

    want, log = on_both(run)
    assert log == want
    assert log == ["closed", True, True, True, True, "open", False,
                   True, True, False, "closed"]


def test_breaker_probe_failure_reopens():
    now = [0.0]
    cfg = BreakerConfig(window=4, min_requests=2, cooldown_s=1.0,
                        half_open_probes=1)
    br = CircuitBreaker(cfg, lambda: now[0])
    br.record(False)
    br.record(False)
    assert br.state == "open"
    now[0] = 2.0
    assert br.allow()
    br.record(False)
    assert br.state == "open"  # failed probe -> straight back to open
    assert not br.allow()


def test_breaker_below_min_requests_stays_closed():
    br = CircuitBreaker(BreakerConfig(min_requests=5, window=10),
                        lambda: 0.0)
    for _ in range(4):
        br.record(False)
    assert br.state == "closed"


# shedding policy

def test_shedding_watermarks():
    cfg = SheddingConfig(watermark=0.5, hard_watermark=0.9,
                         loose_priority_max=0)
    assert not cfg.should_shed(0.4, priority=0)
    assert cfg.should_shed(0.5, priority=0)       # loose class at watermark
    assert not cfg.should_shed(0.5, priority=1)   # tight class passes
    assert cfg.should_shed(0.95, priority=5)      # hard watermark sheds all
    with pytest.raises(ValueError):
        SheddingConfig(watermark=0.9, hard_watermark=0.5)


def test_node_pressure_normalized():
    assert node_pressure(0, 0, 4, 8.0) == 0.0
    assert node_pressure(100, 100, 4, 8.0) == 1.0
    assert 0.0 < node_pressure(8, 8, 4, 8.0) < 1.0


# defaults off: bit-identical to the seed (golden tests hold the full
# trace contract; this is the cheap structural check)

def test_defaults_off_no_resilience_state():
    def run(m):
        sim = m.Simulator("sage", n_nodes=4, seed=0)
        sim.register(_fn(m))
        same_list = sim.dispatchable_nodes() is sim.nodes
        for i in range(20):
            sim.submit("f", 0.1 * i, request_id=f"r{i}")
        sim.run(60.0)
        return sim, same_list

    (ref, _), (sim, same_list) = on_both(run)
    assert_same_sims(ref, sim)
    # the same list object: the seeded rng.choice stream is untouched with
    # the control layer off
    assert same_list
    assert sim.telemetry.error_counts() == {}
    stats = sim.resilience_stats()
    assert stats["shed"] == stats["breaker_rejected"] == 0
    assert stats["node_lost"] == stats["redispatches"] == 0


def test_resilience_stats_backend_key_parity():
    """Both backends report the SAME counter key set, including the drain
    counter the placement plane added, and so does the reference."""
    expected = {"shed", "breaker_rejected", "node_lost", "redispatches",
                "node_crashes", "node_drains", "breaker_states",
                *HEDGE_STAT_KEYS}
    gw_sim = Gateway(backend="sim", policy="sage", n_nodes=2)
    with Gateway(backend="runtime", policy="sage", n_nodes=2,
                 time_scale=0.02, **CPU) as gw_rt:
        s, r = gw_sim.resilience_stats(), gw_rt.resilience_stats()
        assert set(s) == set(r) == expected == ref_gateway_keys()["resilience"]
        # the drain counter moves identically on both drivers
        gw_sim.drain_node("gpu0")
        gw_rt.drain_node("gpu0")
        assert gw_sim.resilience_stats()["node_drains"] == 1
        assert gw_rt.resilience_stats()["node_drains"] == 1


# sim driver: crash, eviction, re-dispatch, retry budget

def _crash_sim(m, eviction, max_retries=None, dispatch="random"):
    plan = m.FaultPlan([m.NodeCrash("gpu1", at_s=2.0)], seed=1)
    sim = m.Simulator("sage", n_nodes=2, seed=1, dispatch=dispatch,
                      faults=plan, eviction=eviction)
    sim.register(_fn(m, compute_ms=50.0))
    for i in range(100):
        sim.submit("f", 0.1 * i, deadline_s=60.0,
                   request_id=f"r{i}", max_retries=max_retries)
    sim.run(200.0)
    return sim


def _crash_both(eviction, **kw):
    ref, sim = on_both(lambda m: _crash_sim(m, eviction, **kw))
    assert_same_sims(ref, sim)
    return sim


@pytest.mark.parametrize("dispatch", ["random", "locality", "least_loaded"])
def test_sim_eviction_rescues_crash(dispatch):
    naive = _crash_both(False, dispatch=dispatch)
    hardened = _crash_both(True, dispatch=dispatch)
    n_ok = sum(1 for r in naive.telemetry.snapshot()
               if not r.dropped and r.error is None)
    h_ok = sum(1 for r in hardened.telemetry.snapshot()
               if not r.dropped and r.error is None)
    assert h_ok == 100  # every request lands on the healthy node
    if dispatch != "locality":
        # random keeps feeding the dead node; least_loaded actively
        # prefers it (a crashed node looks idle). locality dodges it by
        # accident — no residency survives the crash — so only the
        # hardened == 100 guarantee holds there.
        assert n_ok < 70
        assert naive.telemetry.error_counts().get("node_lost", 0) > 0
    assert hardened.telemetry.error_counts() == {}
    # accounting is exact after the crash on both configs
    for sim in (naive, hardened):
        for n in sim.nodes:
            assert 0 <= n.used <= n.capacity
            assert n.host_used >= 0
            assert n.inflight_loads == 0


def test_sim_retry_budget_zero_fails_fast():
    sim = _crash_both(True, max_retries=0)
    stats = sim.resilience_stats()
    assert stats["redispatches"] == 0
    lost = [r for r in sim.telemetry.snapshot()
            if not r.dropped and r.error_class == "node_lost"]
    # in-flight invocations on gpu1 at the crash fail typed, fast
    for r in lost:
        assert "NodeLostError" in r.error
        assert r.redispatches == 0


def test_sim_crash_zeroes_node_accounting():
    sim = _crash_both(False)
    dead = next(n for n in sim.nodes if n.name == "gpu1")
    assert not dead.healthy
    assert dead.used == 0 and dead.host_used == 0
    assert dead.inflight_loads == 0
    assert not dead.active


def test_sim_restart_rejoins_cold():
    def run(m):
        plan = m.FaultPlan([m.NodeCrash("gpu1", at_s=2.0, restart_after_s=3.0)],
                           seed=1)
        sim = m.Simulator("sage", n_nodes=2, seed=1, faults=plan, eviction=True)
        sim.register(_fn(m))
        for i in range(60):
            sim.submit("f", 0.2 * i, deadline_s=60.0, request_id=f"r{i}")
        sim.run(200.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    node = next(n for n in sim.nodes if n.name == "gpu1")
    assert node.healthy and node.crashes == 1
    ok = sum(1 for r in sim.telemetry.snapshot()
             if not r.dropped and r.error is None)
    assert ok == 60  # arrivals after the restart land on gpu1 again


# sim driver: breaker + shedding gates

def test_sim_breaker_opens_on_poisoned_function():
    def run(m):
        plan = m.FaultPlan([m.LoaderFault("f", probability=1.0)], seed=2)
        cfg = m.BreakerConfig(failure_threshold=0.5, window=8, min_requests=4,
                              cooldown_s=30.0, half_open_probes=1)
        sim = m.Simulator("sage", n_nodes=1, seed=2, faults=plan, breaker=cfg)
        sim.register(_fn(m))
        for i in range(30):
            sim.submit("f", 1.0 * i, request_id=f"r{i}")
        sim.run(120.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    stats = sim.resilience_stats()
    assert stats["breaker_states"]["f"] in ("open", "half_open")
    assert stats["breaker_rejected"] > 0
    counts = sim.telemetry.error_counts()
    assert counts["data_load"] >= 4      # the failures that tripped it
    assert counts["breaker"] == stats["breaker_rejected"]
    # breaker rejections resolve instantly and carry no node accounting
    rej = [r for r in sim.telemetry.snapshot()
           if not r.dropped and r.error_class == "breaker"]
    assert all(r.e2e == 0.0 and r.node_id == "" for r in rej)


def test_sim_shedding_protects_tight_class():
    # saturation sized so the soft watermark trips early but the queue of
    # protected tight-class loads never reaches the shed-everything hard
    # watermark (<= ~40 queued of 64 slots)
    def run(m):
        shed = m.SheddingConfig(watermark=0.1, hard_watermark=0.99,
                                loose_priority_max=0, saturation=64.0)
        sim = m.Simulator("sage", n_nodes=1, seed=3, loader_threads=1,
                          shedding=shed)
        for i in range(12):
            sim.register(_fn(m, f"f{i}", ro_mb=2048.0))  # slow cold loads
        rid = 0
        for wave in range(6):
            for i in range(12):
                pr = 1 if i % 2 == 0 else 0
                sim.submit(f"f{i}", 0.5 * wave + 0.01 * i, deadline_s=300.0,
                           priority=pr, request_id=f"r{rid}")
                rid += 1
        sim.run(2000.0)
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    stats = sim.resilience_stats()
    assert stats["shed"] > 0
    slo = sim.telemetry.slo_by_priority()
    # loose (priority 0) is sacrificed first: strictly worse attainment
    assert slo[1]["attainment"] > slo[0]["attainment"]
    shed_recs = [r for r in sim.telemetry.snapshot()
                 if not r.dropped and r.error_class == "shed"]
    assert shed_recs and all(r.priority == 0 for r in shed_recs)


# gateway API: typed errors + knob plumbing

def test_gateway_sim_breaker_raises_typed():
    def run(m):
        plan = m.FaultPlan([m.LoaderFault("f", probability=1.0)], seed=5)
        cfg = m.BreakerConfig(window=4, min_requests=2, cooldown_s=60.0)
        gw = m.Gateway(backend="sim", faults=plan, breaker=cfg)
        gw.register(m.FunctionSpec(name="f", profile="seq2seq"))
        seen = []
        for i in range(10):
            try:
                gw.invoke("f", at=float(i))
                seen.append("ok")
            except m.BreakerOpenError:
                seen.append("breaker")
            except RuntimeError:
                seen.append("load")
        return gw, seen

    (ref, want), (gw, seen) = on_both(run)
    assert seen == want
    assert_same_sims(ref.sim, gw.sim)
    assert set(seen) == {"load", "breaker"}


def test_gateway_sim_shed_raises_typed():
    shed = SheddingConfig(watermark=0.01, hard_watermark=0.02,
                          loose_priority_max=0, saturation=1.0)
    gw = Gateway(backend="sim", shedding=shed, loader_threads=1)
    gw.register(FunctionSpec(name="f", profile="bert"))
    gw.invoke_async("f", at=0.0)
    with pytest.raises(ShedError):
        # second arrival sees the first one's queued load -> pressure > 0
        gw.invoke("f", at=0.001)


def test_spec_breaker_override_validated():
    with pytest.raises(TypeError):
        FunctionSpec(name="f", breaker="not a config")
    cfg = BreakerConfig(window=4, min_requests=2)
    spec = FunctionSpec(name="f", profile="seq2seq", breaker=cfg)
    gw = Gateway(backend="sim")
    gw.register(spec)
    assert gw.sim._breaker_overrides["f"] is cfg


# ---------------------------------------------------------------------------
# the chaos gate: hardened >= 2x naive goodput under the same fault seed, on
# both drivers. The scenario is benchmarks/chaos.py's (DEFAULT_SEED,
# N_NODES, BREAKER, SHEDDING, CLASSES, chaos_plan, _summary, run_sim,
# run_runtime; :42-153) with its parameters word for word.
# ---------------------------------------------------------------------------

CHAOS_SEED = 29
N_NODES = 4
CLASSES: Dict[str, Tuple[float, Optional[float], int]] = {
    "tight": (6.0, 3.0, 2),
    "loose": (6.0, 20.0, 0),
    "flaky": (1.0, None, 0),
}


def _breaker(m):
    return m.BreakerConfig(failure_threshold=0.5, window=16, min_requests=8,
                           cooldown_s=5.0, half_open_probes=2)


def _shedding(m):
    return m.SheddingConfig(watermark=0.75, hard_watermark=0.97,
                            loose_priority_max=0, saturation=8.0)


def chaos_plan(m, duration_s: float, seed: int = CHAOS_SEED):
    """3 of 4 nodes crash early (gpu1 rejoins near the end), the db link
    browns out mid-window, gpu0's db flaps briefly at warmup, and the
    ``flaky`` function's db leg fails half the time."""
    d = duration_s
    return m.FaultPlan([
        m.NodeCrash("gpu1", at_s=0.08 * d, restart_after_s=0.87 * d),
        m.NodeCrash("gpu2", at_s=0.10 * d),
        m.NodeCrash("gpu3", at_s=0.12 * d),
        m.LoaderFault("flaky", probability=0.5),
        m.LinkDegradation(at_s=0.30 * d, duration_s=0.20 * d, factor=0.5,
                          link="db"),
        m.DbFlap(at_s=0.02 * d, duration_s=0.02 * d, node="gpu0"),
    ], seed=seed)


def _summary(t, stats) -> Dict[str, object]:
    recs = [r for r in t.snapshot() if not r.dropped]
    return {
        "arrivals": len(recs),
        "completed": sum(1 for r in recs if r.error is None),
        "goodput": round(1.0 - t.slo_miss_rate(), 4),
        "error_counts": t.error_counts(),
        "slo_by_priority": {p: round(c["attainment"], 4)
                            for p, c in sorted(t.slo_by_priority().items())},
        "resilience": stats,
    }


def chaos_run_sim(m, hardened: bool, seed: int = CHAOS_SEED):
    duration = 40.0  # quick
    kw = {"faults": chaos_plan(m, duration, seed)}
    if hardened:
        kw.update(eviction=True, breaker=_breaker(m), shedding=_shedding(m))
    sim = m.Simulator("sage", n_nodes=N_NODES, seed=seed, **kw)
    for name in sorted(CLASSES):
        sim.register(m.SimFunction(m.FunctionProfile(
            name, "chaos", context_mb=414.0, read_only_mb=96.0,
            writable_mb=8.0, compute_ms=15.0)))
    for i, a in enumerate(m.ChaosWorkload(CLASSES, duration, seed=seed).events()):
        sim.submit(a.function, a.t, deadline_s=a.deadline_s,
                   priority=a.priority, request_id=f"c{i}-{a.function}")
    sim.run(duration + 120.0)
    out = _summary(sim.telemetry, sim.resilience_stats())
    # accounting must be exact after every crash/evict/redispatch
    for n in sim.nodes:
        assert 0 <= n.used <= n.capacity and n.host_used >= 0, (
            f"{n.name}: used={n.used} host_used={n.host_used}")
        assert n.inflight_loads == 0, f"{n.name} leaked loader slots"
    return sim, out


def chaos_run_runtime(hardened: bool, seed: int = CHAOS_SEED):
    duration = 5.0  # quick
    kw = {"faults": chaos_plan(PORT, duration, seed)}
    if hardened:
        kw.update(eviction=True, breaker=_breaker(PORT), shedding=_shedding(PORT))
    gw = Gateway(backend="runtime", n_nodes=N_NODES, seed=seed, **CPU, **kw)
    try:
        for name in sorted(CLASSES):
            gw.register(FunctionSpec(
                name=name, read_only_bytes=24 << 20, writable_bytes=4 << 20,
                context_bytes=16 << 20, compute_ms=10.0))
        # rates scale up as the window scales down: same arrival count
        # intent as the sim scenario
        scale = 120.0 / duration / 10.0
        classes = {f: (r * scale, dl, pr)
                   for f, (r, dl, pr) in CLASSES.items()}
        wl = ChaosWorkload(classes, duration, seed=seed)
        t = gw.replay(wl, pace=1.0, timeout=120.0)
        out = _summary(t, gw.resilience_stats())
        for n in gw._nodes:
            mu = n.memory_usage()
            assert all(v >= 0 for v in mu.values()), f"{n.node_id}: {mu}"
            if not n.healthy:  # a dead node holds nothing
                assert mu["device_used"] == 0 and mu["host_used"] == 0, (
                    f"{n.node_id} leaked accounting after crash: {mu}")
        assert_gateway_keys(gw)
        return out
    finally:
        gw.shutdown()


def test_chaos_sim_hardened_2x_naive():
    out = {}
    for hardened in (False, True):
        (ref, want), (sim, out[hardened]) = on_both(
            lambda m: chaos_run_sim(m, hardened))
        assert out[hardened] == want
        assert_same_sims(ref, sim)
    naive, hardened = out[False], out[True]
    assert naive["goodput"] > 0
    assert hardened["goodput"] >= 2.0 * naive["goodput"]
    # the tight class never does worse than the loose class when hardened
    slo = hardened["slo_by_priority"]
    assert slo[2] >= slo[0]


def test_chaos_runtime_hardened_2x_naive():
    naive = chaos_run_runtime(False)
    hardened = chaos_run_runtime(True)
    assert naive["goodput"] > 0
    assert hardened["goodput"] >= 2.0 * naive["goodput"]
    assert hardened["resilience"]["node_crashes"] == 3


# ---------------------------------------------------------------------------
# tests/test_slowness.py: straggler primitives, detector, quarantine
# ---------------------------------------------------------------------------

def test_ewma_detector_flags_against_pre_update_baseline():
    det = EwmaDetector(factor=2.0, alpha=0.5)
    assert det.observe(1.0) is False  # first sample seeds, never flags
    assert det.ewma == 1.0
    # 2.5 > 2.0 * 1.0: flagged against the ewma BEFORE this observation —
    # the straggler must not drag the baseline it is judged against
    assert det.observe(2.5) is True
    assert det.ewma == pytest.approx(1.75)
    assert det.count == 2
    # exactly at the threshold is not a straggler (strict >)
    det2 = EwmaDetector(factor=2.0, alpha=0.5)
    det2.observe(1.0)
    assert det2.observe(2.0) is False


def test_ewma_detector_validates_parameters():
    with pytest.raises(ValueError):
        EwmaDetector(factor=1.0)
    with pytest.raises(ValueError):
        EwmaDetector(alpha=0.0)
    with pytest.raises(ValueError):
        EwmaDetector(alpha=1.5)


def test_duration_window_forgets_cold_start():
    """Seed the window with slow cold loads, then displace them with warm
    traffic — the p95 must converge to the warm latency instead of riding
    the cold seed forever."""
    w = _DurationWindow(window=32)
    for _ in range(10):
        w.add(1.0)       # cold starts arrive first
    for _ in range(64):
        w.add(0.005)     # warm steady state displaces the whole ring
    assert w.count == 74
    assert w.quantile(0.95) == 0.005


def test_duration_window_quantile_is_exact():
    w = _DurationWindow(window=128)
    for v in range(1, 101):
        w.add(float(v))
    assert w.quantile(0.5) == 51.0
    assert w.quantile(0.95) == 96.0
    assert w.quantile(0.99) == 100.0


def _warm_fleet(det, nodes=("a", "b", "c"), n=10, value=0.01):
    for _ in range(n):
        for node in nodes:
            det.observe(node, "compute", value)


def test_detector_needs_sustained_breach_to_suspect():
    def run(m):
        det = m.SlownessDetector(factor=2.5, alpha=0.2, min_samples=4)
        _warm_fleet(det, n=6)
        log = [det.suspects(), det.health_score("a")]
        for _ in range(3):
            det.observe("a", "compute", 0.2)
        log.append(det.is_suspect("a"))
        det.observe("a", "compute", 0.2)
        log += [det.is_suspect("a"), det.suspects(), det.health_score("a"),
                det.health_score("b")]
        return log

    want, log = on_both(run)
    assert log == want
    no_suspects, score0, short, suspect, suspects, score_a, score_b = log
    assert no_suspects == [] and score0 == 1.0
    # a breach streak shorter than min_samples never makes a suspect
    assert not short
    assert suspect and suspects == ["a"]
    # the graded score reflects the same drift continuously
    assert 0.0 < score_a < 1.0
    assert score_b == 1.0


def test_detector_streak_resets_on_clean_sample():
    det = SlownessDetector(factor=2.5, alpha=1.0, min_samples=4)
    _warm_fleet(det, n=6)
    for _ in range(3):
        det.observe("a", "compute", 0.2)
    det.observe("a", "compute", 0.01)  # one clean sample breaks the streak
    det.observe("a", "compute", 0.2)
    assert not det.is_suspect("a")


def test_detector_single_node_fleet_has_no_median():
    det = SlownessDetector(min_samples=2)
    for _ in range(20):
        assert det.observe("only", "compute", 5.0) is False
    assert not det.is_suspect("only")
    assert det.health_score("only") == 1.0


def test_detector_reset_node_wipes_evidence():
    det = SlownessDetector(factor=2.5, alpha=0.2, min_samples=3)
    _warm_fleet(det, n=5)
    for _ in range(3):
        det.observe("a", "compute", 0.5)
    assert det.is_suspect("a")
    det.reset_node("a")
    assert not det.is_suspect("a")
    assert det.health_score("a") == 1.0


def test_detector_is_slow_sample_one_shot():
    det = SlownessDetector(factor=2.0, min_samples=3)
    _warm_fleet(det, nodes=("b", "c"), n=4, value=0.1)
    # "a" has no stream at all — the canary check still judges it
    # one-shot against the mature peers' median
    assert det.is_slow_sample("a", "compute", 0.5) is True
    assert det.is_slow_sample("a", "compute", 0.1) is False


def test_detector_estimate_gated_on_samples_and_skips_suspects():
    det = SlownessDetector(factor=2.5, alpha=0.2, min_samples=3)
    assert det.estimate("f") is None
    for _ in range(5):
        det.observe_record("a", "f", {"compute": 0.01}, duration=0.02)
    assert det.estimate("f", min_samples=5) == pytest.approx(0.02)
    assert det.estimate("f", min_samples=6) is None
    # a suspect node's stragglers must not drag the hedge estimate up
    _warm_fleet(det, nodes=("b", "c"), n=4)
    for _ in range(3):
        det.observe("a", "compute", 0.5)
    assert det.is_suspect("a")
    before = det.estimate("f", min_samples=1)
    det.observe_record("a", "f", {"compute": 0.5}, duration=9.9)
    assert det.estimate("f", min_samples=1) == before


def test_hedge_config_validation():
    with pytest.raises(ValueError):
        HedgeConfig(hedge_quantile=1.0)
    with pytest.raises(ValueError):
        HedgeConfig(min_samples=0)
    with pytest.raises(ValueError):
        HedgeConfig(delay_factor=0.0)


def test_quarantine_config_validation():
    with pytest.raises(ValueError):
        QuarantineConfig(factor=1.0)
    with pytest.raises(ValueError):
        QuarantineConfig(min_samples=0)
    with pytest.raises(ValueError):
        QuarantineConfig(cooldown_s=0.0)
    with pytest.raises(ValueError):
        QuarantineConfig(canary_count=0)


def test_resolvers_normalize_all_knob_shapes():
    assert resolve_hedging(None) is None
    assert resolve_hedging(False) is None
    assert resolve_hedging(True) == HedgeConfig()
    cfg = HedgeConfig(min_samples=5)
    assert resolve_hedging(cfg) is cfg
    assert resolve_hedging({"min_samples": 5}) == cfg
    with pytest.raises(TypeError):
        resolve_hedging("yes")

    assert resolve_quarantine(None) is None
    assert resolve_quarantine(True) == QuarantineConfig()
    qc = QuarantineConfig(cooldown_s=2.0)
    assert resolve_quarantine(qc) is qc
    assert resolve_quarantine({"cooldown_s": 2.0}) == qc
    with pytest.raises(TypeError):
        resolve_quarantine(42)


def test_make_detector_splits_knob_ownership():
    det = make_detector(HedgeConfig(hedge_quantile=0.9),
                        QuarantineConfig(factor=3.0, min_samples=4))
    assert det.quantile == 0.9       # hedging owns the estimate quantile
    assert det.factor == 3.0         # quarantine owns suspicion thresholds
    assert det.min_samples == 4
    det2 = make_detector(None, None)
    assert det2.factor == QuarantineConfig().factor
    assert det2.quantile == 0.95


def test_hedge_stat_keys_frozen_contract():
    from repro.core.slowness import HEDGE_STAT_KEYS as REF_KEYS

    assert HEDGE_STAT_KEYS == REF_KEYS == (
        "hedges_launched", "hedges_won", "hedges_wasted", "quarantines",
        "readmits")


def _suspect_detector(m, node="a", min_samples=3):
    det = m.SlownessDetector(factor=2.5, alpha=0.2, min_samples=min_samples)
    _warm_fleet(det, nodes=(node, "b", "c"), n=min_samples + 1)
    for _ in range(min_samples):
        det.observe(node, "compute", 0.5)
    assert det.is_suspect(node)
    return det


def test_quarantine_readmit_after_clean_canaries():
    def run(m):
        cfg = m.QuarantineConfig(min_samples=3, cooldown_s=5.0, canary_count=2)
        det = _suspect_detector(m, min_samples=3)
        qc = m.QuarantineController(cfg, det)
        Q = m.QuarantineController
        log = [qc.note_completion("a", now=10.0, compute_s=0.5),
               qc.state("a") == Q.QUARANTINED, det.is_suspect("a"),
               qc.next_probe_at(), qc.due_probes(14.9), qc.due_probes(15.0),
               qc.state("a") == Q.PROBATION, qc.next_probe_at(),
               qc.note_completion("a", now=16.0, compute_s=0.01),
               qc.note_completion("a", now=17.0, compute_s=0.01),
               qc.state("a") == Q.ACTIVE, qc.stats()]
        return log

    want, log = on_both(run)
    assert log == want
    assert log == ["quarantine", True,
                   False,  # evidence wiped at quarantine
                   15.0, [], ["a"], True, None,
                   # two clean canaries: judged one-shot vs the fleet
                   None, "readmit", True, {"quarantines": 1, "readmits": 1}]


def test_quarantine_retires_on_slow_canary():
    cfg = QuarantineConfig(min_samples=3, cooldown_s=1.0, canary_count=3)
    det = _suspect_detector(PORT, min_samples=3)
    qc = QuarantineController(cfg, det)
    assert qc.note_completion("a", now=0.0, compute_s=0.5) == "quarantine"
    assert qc.due_probes(1.0) == ["a"]
    # the first canary comes back slow: the node is retired for good
    assert qc.note_completion("a", now=2.0, compute_s=0.5) == "retire"
    assert qc.state("a") == QuarantineController.RETIRED
    # a retired node never acts again
    assert qc.note_completion("a", now=3.0, compute_s=0.01) is None
    assert qc.stats() == {"quarantines": 1, "readmits": 0}


def test_quarantine_healthy_node_never_acts():
    cfg = QuarantineConfig(min_samples=3)
    det = SlownessDetector(factor=2.5, min_samples=3)
    _warm_fleet(det, n=5)
    qc = QuarantineController(cfg, det)
    for t in range(10):
        assert qc.note_completion("a", now=float(t), compute_s=0.01) is None
    assert qc.state("a") == QuarantineController.ACTIVE
    assert qc.next_probe_at() is None


# ---------------------------------------------------------------------------
# tests/test_compute.py: the shared compute plane
# ---------------------------------------------------------------------------

SMALL = dict(context_mb=1.0, read_only_mb=1.0, writable_mb=0.5)


def _cfn(m, name="f", compute_ms=10.0, sm_fraction=None):
    return m.SimFunction(m.FunctionProfile(name, "t", compute_ms=compute_ms,
                                           **SMALL), sm_fraction=sm_fraction)


def test_resolve_compute_forms():
    assert resolve_compute(None) is None
    assert resolve_compute("exclusive") is None
    # the explicit off-config resolves to the SAME off-state as None, so
    # every consumer has exactly one exclusive path to keep bit-identical
    assert resolve_compute(ComputeConfig(mode="exclusive")) is None
    assert resolve_compute("shared") == ComputeConfig()
    assert resolve_compute(True) == ComputeConfig()
    cfg = resolve_compute({"max_batch": 4, "slices": 4})
    assert cfg == ComputeConfig(max_batch=4, slices=4)
    with pytest.raises(ValueError, match="compute"):
        resolve_compute(7)


def test_compute_config_validation():
    for bad in (dict(mode="mps"), dict(slices=0), dict(max_batch=0),
                dict(batch_window_s=-0.1), dict(batch_marginal=1.5),
                dict(auto_full_ms=0.0)):
        with pytest.raises(ValueError):
            ComputeConfig(**bad)


def test_slices_for_declared_and_auto():
    cfg = ComputeConfig()
    # declared fractions quantize UP onto the 8-slice grid
    assert slices_for(cfg, 1.0, 0.0) == 8
    assert slices_for(cfg, 0.5, 0.0) == 4
    assert slices_for(cfg, 0.3, 0.0) == 3
    assert slices_for(cfg, 0.01, 0.0) == 1
    # auto mode scales the profiled compute stage against auto_full_ms
    assert slices_for(cfg, None, 0.005) == 1    # 5 ms / 40 ms -> 1/8
    assert slices_for(cfg, None, 0.015) == 3
    assert slices_for(cfg, None, 0.040) == 8
    assert slices_for(cfg, None, 9.0) == 8      # clamped to the budget


def test_batched_span_model():
    assert batched_span(0.01, 1, 0.3) == 0.01
    assert batched_span(0.01, 4, 0.3) == pytest.approx(0.019)
    assert batched_span(0.01, 4, 0.0) == pytest.approx(0.01)  # free stacking


def test_batch_hold_never_exceeds_edf_slack():
    cfg = ComputeConfig(batch_window_s=0.5)
    # no deadline: the full window
    assert batch_hold_s(cfg, 1.0, 1.0, None, 0.01) == 0.5
    # slack below the window caps the hold
    assert batch_hold_s(cfg, 1.0, 1.0, 0.1, 0.01) == pytest.approx(0.09)
    # already out of slack: zero hold, never negative
    assert batch_hold_s(cfg, 1.0, 0.0, 0.5, 0.01) == 0.0
    # with batching on, the slack is charged the worst-case stacked span
    cfg4 = ComputeConfig(batch_window_s=0.5, max_batch=4)
    assert batch_hold_s(cfg4, 1.0, 1.0, 0.1, 0.01) == pytest.approx(
        0.1 - batched_span(0.01, 4, cfg4.batch_marginal))


def test_plane_packing_deterministic_and_contended():
    ops = [(0.0, 4, 1.0), (0.0, 4, 1.0), (0.0, 4, 1.0), (0.5, 2, 1.0)]

    def run(m):
        cfg = m.ComputeConfig(slices=8)
        a = m.ComputePlane(cfg)
        p = m.ComputePlane(cfg)
        log = [[a.acquire(*op) for op in ops]]
        log.append([p.acquire(0.0, 4, 1.0), p.acquire(0.0, 4, 1.0),
                    p.acquire(0.0, 4, 1.0), p.grants, p.contended_grants,
                    p.acquire(1.0, 8, 1.0), p.contended_grants])
        p2 = m.ComputePlane(cfg)
        p2.acquire(0.0, 6, 1.0)
        log.append([p2.acquire(0.0, 4, 1.0), p2.contended_grants])
        return log

    want, log = on_both(run)
    assert log == want
    # deterministic: a second plane packs the same ops the same way
    cfg = ComputeConfig(slices=8)
    b = ComputePlane(cfg)
    assert [b.acquire(*op) for op in ops] == log[0]
    # 4 of 8: co-runs; the budget exactly full; fully busy: the grant
    # queues for the earliest free instant
    assert log[1][:5] == [(0.0, 1.0), (0.0, 1.0), (1.0, 1.0), 3, 0]
    # only 4 slices idle at 1.0 (the queued grant holds the rest): a k=8
    # ask is granted short and its span stretches by k/g = 2x
    assert log[1][5:] == [(1.0, 2.0), 1]
    assert log[2] == [(0.0, 2.0), 1]  # only 2 idle at start


def test_plane_free_fraction_and_reset():
    p = ComputePlane(ComputeConfig(slices=8))
    assert p.free_fraction(0.0) == 1.0
    p.acquire(0.0, 4, 1.0)
    assert p.free_fraction(0.5) == 0.5
    assert p.free_fraction(1.5) == 1.0  # grant expired
    p.acquire(2.0, 8, 5.0)
    p.reset()  # crash teardown: in-flight grants die with the epoch
    assert p.free_fraction(2.0) == 1.0


def _shared_sim(m, compute, seed=5):
    sim = m.Simulator("sage", n_nodes=2, seed=seed, scheduler="edf",
                      dispatch="locality", compute=compute)
    for name in ("a", "b"):
        sim.register(_cfn(m, name))
    for i in range(40):
        sim.submit("a" if i % 2 else "b", 0.01 * i, deadline_s=2.0,
                   priority=1, request_id=f"r{i}")
    sim.run()
    return sim


def test_sim_shared_replay_deterministic():
    cfg = {"max_batch": 4, "batch_window_s": 0.02}
    ref, sim = on_both(lambda m: _shared_sim(m, cfg))
    assert_same_sims(ref, sim)
    key = lambda t: [(r.request_id, r.node_id, r.start_t, r.end_t,  # noqa: E731
                      r.batch_size, r.batched_with)
                     for r in t.snapshot()]
    assert key(sim.telemetry) == key(_shared_sim(PORT, cfg).telemetry)


def test_sim_batch_window_never_creates_slo_miss():
    """A huge collection window must not hold a tight member past its EDF
    slack: the hold is capped at arrival + deadline - now - est."""
    def run(m):
        sim = m.Simulator("sage", n_nodes=1, seed=1,
                          compute={"max_batch": 8, "batch_window_s": 10.0})
        sim.register(_cfn(m, compute_ms=10.0))
        sim.submit("f", 0.0, request_id="warm")  # absorb the cold start
        sim.submit("f", 5.0, deadline_s=0.2, request_id="tight")
        sim.run()
        return sim

    ref, sim = on_both(run)
    assert_same_sims(ref, sim)
    rec = sim.telemetry.find("tight")
    assert rec.error is None and not rec.slo_miss
    assert rec.end_t <= 5.2 + 1e-9
    assert rec.end_t > 5.1   # ...but it DID wait out its real slack
    # and the wait paid off: it coalesced with the parked no-deadline member
    assert rec.batch_size == 2 and rec.batched_with == ("warm",)


def test_sim_defaults_identical_to_explicit_exclusive():
    ref_base, base = on_both(lambda m: _shared_sim(m, None))
    ref_excl, excl = on_both(lambda m: _shared_sim(m, {"mode": "exclusive"}))
    assert_same_sims(ref_base, base)
    assert_same_sims(ref_excl, excl)
    key = lambda t: [(r.request_id, r.node_id, r.start_t, r.end_t)  # noqa: E731
                     for r in t.snapshot()]
    assert key(base.telemetry) == key(excl.telemetry)
    assert all(n.compute_plane is None for n in excl.nodes)
    assert excl.compute_stats() == empty_compute_stats("exclusive", 0)


def test_sim_shared_beats_exclusive_on_contended_smalls():
    """Three 1/8-GPU functions serialize on the FIFO but co-run on the
    shared plane."""
    def run(m, compute):
        sim = m.Simulator("sage", n_nodes=1, seed=2, compute=compute)
        for name in ("a", "b", "c"):
            sim.register(_cfn(m, name, compute_ms=5.0))
        for i in range(30):
            sim.submit("abc"[i % 3], 0.0, request_id=f"r{i}")
        sim.run()
        return sim

    ends = {}
    for compute in ("shared", None):
        ref, sim = on_both(lambda m: run(m, compute))
        assert_same_sims(ref, sim)
        ends[compute] = max(r.end_t for r in sim.telemetry.snapshot())
    assert ends["shared"] < ends[None]


def test_gateway_compute_spec_adoption_and_conflict():
    cfg = ComputeConfig(max_batch=4)
    spec = FunctionSpec.from_profile("resnet50", compute={"max_batch": 4})
    assert spec.compute == cfg  # dict literal normalized at construction
    gw = Gateway(backend="sim", policy="sage", n_nodes=2)
    gw.register(spec)
    assert gw.compute == cfg
    assert all(n.compute_plane is not None for n in gw.sim.nodes)
    with pytest.raises(ValueError, match="compute"):
        gw.register(FunctionSpec.from_profile("bert", compute="shared"))
    gw.register(FunctionSpec.from_profile("vgg11", compute=cfg))  # agrees
    # an explicit constructor choice is not overridable by a spec
    gw2 = Gateway(backend="sim", policy="sage", compute="shared")
    with pytest.raises(ValueError, match="compute"):
        gw2.register(FunctionSpec.from_profile(
            "resnet50", compute={"max_batch": 2}))
    with pytest.raises(ValueError):
        FunctionSpec(name="x", sm_fraction=1.5)


def test_gateway_compute_stats_backend_key_parity():
    """Both backends report the SAME compute_stats key set, off and on,
    and the off-state is the exclusive zero row."""
    expected = set(empty_compute_stats("exclusive", 0))
    assert expected == ref_gateway_keys()["compute"]
    gw_sim = Gateway(backend="sim", policy="sage", n_nodes=2)
    with Gateway(backend="runtime", policy="sage", n_nodes=2,
                 time_scale=0.02, **CPU) as gw_rt:
        s, r = gw_sim.compute_stats(), gw_rt.compute_stats()
        assert set(s) == set(r) == expected
        assert s == r == empty_compute_stats("exclusive", 0)
    gw_on = Gateway(backend="sim", policy="sage", n_nodes=2,
                    compute="shared")
    with Gateway(backend="runtime", policy="sage", n_nodes=2,
                 time_scale=0.02, compute="shared", **CPU) as gw_rt_on:
        s, r = gw_on.compute_stats(), gw_rt_on.compute_stats()
        assert set(s) == set(r) == expected
        assert s["mode"] == r["mode"] == "shared"
        assert s["slices"] == r["slices"] == 8


def test_placement_resilience_stats_parity_with_fractional_slots():
    """The fractional-slot plane must not skew the other stats planes:
    placement_stats and resilience_stats keep their exact backend key
    parity with compute sharing on."""
    kw = dict(policy="sage", n_nodes=2, dispatch="planned",
              compute="shared")
    gw_sim = Gateway(backend="sim", **kw)
    with Gateway(backend="runtime", time_scale=0.02, **CPU, **kw) as gw_rt:
        ps, pr = gw_sim.placement_stats(), gw_rt.placement_stats()
        assert ps is not None and set(ps) == set(pr)
        rs, rr = gw_sim.resilience_stats(), gw_rt.resilience_stats()
        assert set(rs) == set(rr)
        assert_gateway_keys(gw_rt)


# runtime<->sim batch parity: one simultaneous burst coalesces into ONE
# stacked launch on both drivers, with identical batch assignments

def _burst_batches(m, backend):
    kw = dict(policy="sage", n_nodes=1, seed=3,
              compute={"max_batch": 4, "batch_window_s": 0.5})
    if backend == "runtime":
        kw.update(time_scale=0.02, **CPU)
    gw = m.Gateway(backend=backend, **kw)
    try:
        gw.register(m.FunctionSpec(name="f", read_only_bytes=MB,
                                   writable_bytes=MB, context_bytes=MB,
                                   compute_ms=20.0))
        wl = m.TraceWorkload([m.Arrival(0.0, "f") for _ in range(4)])
        tel = gw.replay(wl, timeout=60.0)
        recs = [r for r in tel.snapshot() if not r.dropped]
        assert all(r.error is None for r in recs)
        stats = gw.compute_stats()
        if backend == "runtime":
            assert_gateway_keys(gw)
        return gw, recs, stats
    finally:
        gw.shutdown()


@pytest.mark.parametrize("backend", ["sim", "runtime"])
def test_burst_coalesces_into_one_batch(backend):
    if backend == "sim":
        (ref, _, want), (gw, recs, stats) = on_both(lambda m: _burst_batches(m, "sim"))
        assert stats == want
        assert_same_sims(ref.sim, gw.sim)
    else:
        _, recs, stats = _burst_batches(PORT, "runtime")
    assert len(recs) == 4
    ids = {r.request_id for r in recs}
    for r in recs:
        assert r.batch_size == 4
        # every member names exactly the other three as peers
        assert set(r.batched_with) == ids - {r.request_id}
    assert stats["batches"] == 1 and stats["batched"] == 4
    assert stats["grants"] == 1  # the stacked launch is a single grant


def test_set_compute_after_registration_runtime():
    """The handler wrapper consults the plane at call time, so flipping
    the knob on a live runtime applies to already-registered functions."""
    from repro_torch.core.engine import GPUFunction
    from repro_torch.core.request import Request
    from repro_torch.core.runtime import SageRuntime

    rt = SageRuntime("sage", max_workers=8, **CPU)
    rt.sage_init()
    try:
        rt.register_function(GPUFunction(
            name="f", handler=lambda shim, req: time.sleep(0.002),
            context_builder=lambda: object(), context_bytes=MB,
            container_s=0.0, cpu_ctx_s=0.0, compute_s_hint=0.002))
        rt.submit(Request(function_name="f")).result(timeout=30.0)
        assert rt.compute_stats() == empty_compute_stats("exclusive", 0)
        rt.set_compute("shared")
        rt.submit(Request(function_name="f")).result(timeout=30.0)
        st = rt.compute_stats()
        assert st["mode"] == "shared" and st["grants"] == 1
        rt.set_compute(None)  # and back off again
        rt.submit(Request(function_name="f")).result(timeout=30.0)
        assert rt.compute_stats() == empty_compute_stats("exclusive", 0)
    finally:
        rt.shutdown()


def test_threaded_plane_contended_batches_no_leaked_slices():
    """When the budget is fully busy, a batch member parked on the
    free-slice wait must re-check its batch's grant on wake (a
    double-granted batch would leak its first grant and deadlock)."""
    from repro_torch.core.engine import GPUFunction
    from repro_torch.core.request import Request
    from repro_torch.core.runtime import SageRuntime

    rt = SageRuntime("sage", max_workers=32,
                     compute={"max_batch": 4, "batch_window_s": 0.005,
                              "slices": 4}, **CPU)
    rt.sage_init()
    try:
        for name in ("a", "b", "c"):
            rt.register_function(GPUFunction(
                name=name, handler=lambda shim, req: time.sleep(0.005),
                context_builder=lambda: object(), context_bytes=MB,
                container_s=0.0, cpu_ctx_s=0.0,
                compute_s_hint=0.020))  # k=4: each batch wants the budget
        futs = [rt.submit(Request(function_name="abc"[i % 3]))
                for i in range(24)]
        for f in futs:
            f.result(timeout=30.0)
        plane = rt._plane
        with plane._cond:
            assert plane._free == 4  # every grant released
            assert not plane._open
    finally:
        rt.shutdown()


def test_trace_workload_events_equal_reference():
    """The burst's and the chaos scenario's arrivals, drawn by the port's
    workload generators, equal the reference's."""
    def run(m):
        burst = m.TraceWorkload([m.Arrival(0.0, "f") for _ in range(4)]).events()
        chaos = m.ChaosWorkload(CLASSES, 40.0, seed=CHAOS_SEED).events()
        return [(a.t, a.function, a.deadline_s, a.priority) for a in (*burst, *chaos)]

    want, got = on_both(run)
    assert got == want and len(got) > 4
