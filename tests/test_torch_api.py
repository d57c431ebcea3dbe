"""The port's serving API (``repro_torch.api``) against the JAX package's
(``repro.api``): the cases of tests/test_api.py on the port, with the
workloads and the sim-backend gateway giving equal events and equal
Telemetry records on both packages, runtime<->sim parity on the port's two
backends, the first port test of ``ClusterRuntime``, served outputs equal
to the reference gateway's within 3e-5 (fp32), and equal stats key sets.

Every runtime-backend gateway here passes ``device="cpu"``; the default is
the card, and without CUDA it raises."""
import dataclasses
import itertools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as ref_api  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch.api import (  # noqa: E402
    BurstWorkload, FunctionSpec, Gateway, MAFWorkload, MixWorkload,
    PoissonWorkload, TraceWorkload,
)
from repro_torch.core.profiles import MB, PROFILES  # noqa: E402
from repro_torch.core.telemetry import STAGES  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SMALL = dict(arch="qwen2.5-3b", profile="seq2seq")  # fast in both backends
CPU = dict(device="cpu")
ATOL = 3e-5  # fp32 attention tolerance, tests/test_kernels.py


def _rows(tel):
    """Every field of every record, in arrival order (sim backend: the
    records are deterministic, so the two packages' rows are equal)."""
    return [dataclasses.asdict(r)
            for r in sorted(tel.snapshot(), key=lambda r: (r.arrival_t, r.request_id))]


def _on_both(run):
    """``run(pkg)`` on the JAX package's api and the port's; returns both
    results (reference first)."""
    return run(ref_api), run(api)


# ---------------------------------------------------------------------------
# FunctionSpec lowering
# ---------------------------------------------------------------------------

def test_spec_lowers_to_sim_function_with_profile_bytes():
    spec = FunctionSpec.from_profile("resnet50")
    sf = spec.to_sim_function()
    ref = ref_api.FunctionSpec.from_profile("resnet50").to_sim_function()
    assert sf.name == ref.name == "resnet50"
    assert sf.ro_bytes == ref.ro_bytes == int(PROFILES["resnet50"].read_only_mb * MB)
    assert sf.ctx_bytes == ref.ctx_bytes == int(PROFILES["resnet50"].context_mb * MB)
    assert sf.compute_s == ref.compute_s == PROFILES["resnet50"].compute_ms / 1e3


def test_spec_byte_overrides_flow_into_both_lowerings():
    kw = dict(name="big", profile="resnet50", read_only_bytes=2 << 30,
              writable_bytes=8 * MB, compute_ms=50.0)
    spec = FunctionSpec(**kw)
    prof = spec.resolved_profile()
    assert dataclasses.asdict(prof) == dataclasses.asdict(
        ref_api.FunctionSpec(**kw).resolved_profile())
    assert prof.name == "big"
    assert int(prof.read_only_mb * MB) == 2 << 30
    assert int(prof.writable_mb * MB) == 8 * MB
    assert prof.compute_ms == 50.0
    assert spec.to_sim_function().ro_bytes == 2 << 30


def test_spec_clone_names_for_many_functions():
    a = FunctionSpec.from_profile("bert", name="bert1")
    b = FunctionSpec.from_profile("bert", name="bert2")
    assert a.to_sim_function().name == "bert1"
    assert b.to_sim_function().name == "bert2"
    assert a.to_sim_function().ro_bytes == b.to_sim_function().ro_bytes


def test_spec_gpu_lowering_matches_reference():
    """``to_gpu_function`` serves the reduced arch with the reference's
    declared sizes and hints."""
    from repro.data.database import Database as RefDatabase
    from repro_torch.data.database import Database

    kw = dict(name="f", writable_bytes=8 * MB, compute_ms=5.0, sm_fraction=0.5, **SMALL)
    got = FunctionSpec(**kw).to_gpu_function(Database(device="cpu"))
    want = ref_api.FunctionSpec(**kw).to_gpu_function(RefDatabase())
    for field in ("name", "read_only", "writable_hint", "context_bytes",
                  "compute_s_hint", "sm_fraction"):
        assert getattr(got, field) == getattr(want, field), field


# ---------------------------------------------------------------------------
# Workloads: the same arguments give equal events on both packages
# ---------------------------------------------------------------------------

WORKLOADS = {
    "poisson": lambda m: m.PoissonWorkload("f", 10.0, 100.0, seed=0),
    "poisson_capped": lambda m: m.PoissonWorkload("f", 10.0, 100.0, seed=0, max_events=17),
    "maf": lambda m: m.MAFWorkload(list(PROFILES), 300.0, seed=3, mean_rpm=20),
    "mix": lambda m: m.MixWorkload({"a": 5.0, "b": 1.0}, 200.0, seed=1),
    "mix_slo": lambda m: m.MixWorkload({"a": 5.0, "b": 1.0}, 50.0, seed=1,
                                       deadline_s={"a": 0.5}, priority={"a": 2, "b": 0}),
    "burst": lambda m: m.BurstWorkload("f", 1.0, 20.0, 600.0, period_s=100.0,
                                       burst_len_s=10.0, seed=2),
    "trace": lambda m: m.TraceWorkload([m.Arrival(0.0, "a", deadline_s=0.5, priority=3),
                                        (1.0, "b")]),
    "diurnal": lambda m: m.DiurnalWorkload("f", 2.0, 600.0, seed=4),
    "diurnal_short": lambda m: m.DiurnalWorkload(["a", "b"], 3.0, 400.0, period_s=100.0,
                                                 amplitude=0.5, seed=6),
    "flash_crowd": lambda m: m.FlashCrowdWorkload("f", 1.0, 300.0, spike_times_s=(50.0,),
                                                  seed=5),
    "multi_region": lambda m: m.MultiRegionWorkload(
        {"us": m.PoissonWorkload("a", 2.0, 100.0, seed=1),
         "eu": m.MixWorkload({"b": 1.0, "c": 0.5}, 100.0, seed=2)},
        offsets_s={"eu": 30.0}),
    "chaos": lambda m: m.ChaosWorkload({"hi": (2.0, 0.5, 1), "lo": (6.0, 5.0, 0)},
                                       120.0, seed=7),
}


def _events(wl):
    return [dataclasses.astuple(a) for a in wl.events()]


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_events_equal_reference(name):
    want, got = _on_both(lambda m: _events(WORKLOADS[name](m)))
    assert got == want
    assert len(got) > 0


def test_poisson_workload_rate_determinism_and_truncation():
    wl = PoissonWorkload("f", 10.0, 100.0, seed=0)
    assert 800 < len(wl) < 1200
    assert wl.events() == PoissonWorkload("f", 10.0, 100.0, seed=0).events()
    assert all(0.0 < a.t < 100.0 for a in wl)
    capped = PoissonWorkload("f", 10.0, 100.0, seed=0, max_events=17)
    assert len(capped) == 17


def test_maf_workload_subsumes_maf_like_trace():
    from repro_torch.core.simulator import maf_like_trace

    names = list(PROFILES)
    wl = MAFWorkload(names, 300.0, seed=3, mean_rpm=20)
    with pytest.warns(DeprecationWarning):
        want = maf_like_trace(names, duration_s=300.0, seed=3, mean_rpm=20)
    assert [(a.t, a.function) for a in wl] == want


def test_mix_workload_per_function_rates():
    wl = MixWorkload({"a": 5.0, "b": 1.0}, 200.0, seed=1)
    counts = {"a": 0, "b": 0}
    for ev in wl:
        counts[ev.function] += 1
    assert counts["a"] > 3 * counts["b"] > 0
    assert wl.events() == MixWorkload({"a": 5.0, "b": 1.0}, 200.0, seed=1).events()


def test_burst_workload_rates_between_base_and_burst():
    wl = BurstWorkload("f", 1.0, 20.0, 600.0, period_s=100.0,
                       burst_len_s=10.0, seed=2)
    assert 600 * 2.0 < len(wl) < 600 * 4.0
    assert sorted(a.t for a in wl) == [a.t for a in wl]


def test_workload_priority_dict_per_function():
    wl = MixWorkload({"a": 5.0, "b": 1.0}, 50.0, seed=1,
                     deadline_s={"a": 0.5}, priority={"a": 2, "b": 0})
    for ev in wl:
        if ev.function == "a":
            assert ev.deadline_s == 0.5 and ev.priority == 2
        else:
            assert ev.deadline_s is None and ev.priority == 0


# ---------------------------------------------------------------------------
# Gateway (sim backend): the same calls give equal records on both packages
# ---------------------------------------------------------------------------

def test_replay_gives_simultaneous_arrivals_unique_record_ids():
    def run(m):
        gw = m.Gateway(backend="sim", policy="sage")
        gw.register(m.FunctionSpec.from_profile("resnet50", name="f"))
        return gw.replay(m.TraceWorkload([(0.0, "f"), (0.0, "f")]), until_pad=600.0)

    want, tel = _on_both(run)
    assert _rows(tel) == _rows(want)
    ids = [r.request_id for r in tel.records]
    assert len(ids) == 2 and len(set(ids)) == 2
    assert all(tel.find(i) is r for i, r in zip(ids, tel.records))


def test_workload_slo_metadata_and_spec_defaults():
    def run(m):
        wl = m.TraceWorkload([m.Arrival(0.0, "a", deadline_s=0.5, priority=3), (1.0, "b")])
        gw = m.Gateway(backend="sim", policy="sage")
        gw.register(m.FunctionSpec.from_profile("resnet50", name="a"))
        gw.register(m.FunctionSpec.from_profile("resnet50", name="b",
                                                deadline_s=9.0, priority=1))
        return gw.replay(wl, until_pad=600.0)

    want, tel = _on_both(run)
    assert _rows(tel) == _rows(want)
    recs = {r.function: r for r in tel.records}
    assert recs["a"].deadline_s == 0.5 and recs["a"].priority == 3
    assert recs["b"].deadline_s == 9.0 and recs["b"].priority == 1


def test_gateway_sim_invoke_and_slo_recording():
    def run(m):
        kw = {"device": "cuda"} if m is api else {}  # the sim ignores ``device``
        gw = m.Gateway(backend="sim", policy="sage", **kw)
        gw.register(m.FunctionSpec.from_profile("resnet50", deadline_s=1e-4))
        cold = gw.invoke("resnet50", at=0.0)
        warm = gw.invoke("resnet50")
        return gw, cold, warm

    (ref_gw, _, _), (gw, cold, warm) = _on_both(run)
    assert _rows(gw.report()) == _rows(ref_gw.report())
    assert cold.warm_stage is None and warm.warm_stage == 1
    assert cold.deadline_s == 1e-4 and cold.slo_miss
    assert gw.report().slo_miss_rate() > 0.0
    assert set(gw.memory_usage()) == {"device_used", "context_bytes", "host_used"}
    assert gw.memory_usage() == ref_gw.memory_usage()


def test_gateway_sim_invoke_async_strict_raises_on_failure():
    def run(m):
        gw = m.Gateway(backend="sim", policy="sage",
                       device_capacity=600 * MB, load_timeout_s=5.0)
        gw.register(m.FunctionSpec.from_profile("bert"))  # 1282 MB RO never fits
        inv = gw.invoke_async("bert", at=0.0)
        with pytest.raises(RuntimeError, match="DataLoadError"):
            inv.wait()
        return gw, inv.wait(strict=False)

    (ref_gw, _), (gw, rec) = _on_both(run)
    assert "DataLoadError" in rec.error
    assert _rows(gw.report()) == _rows(ref_gw.report())


def test_gateway_rejects_unknown_backend_and_duplicate_register():
    with pytest.raises(ValueError):
        Gateway(backend="magic")
    gw = Gateway(backend="sim")
    gw.register(FunctionSpec.from_profile("resnet50"))
    with pytest.raises(ValueError):
        gw.register(FunctionSpec.from_profile("resnet50"))
    with pytest.raises(KeyError):
        gw.invoke("nope")


def test_runtime_gateway_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Gateway(backend="runtime")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Gateway(backend="runtime", n_nodes=2)


def test_gateway_scheduler_knob_plumbs_to_both_backends():
    gw = Gateway(backend="sim", policy="sage", scheduler="edf")
    assert gw.scheduler == "edf"
    assert all(n.scheduler == "edf" for n in gw.sim.nodes)
    with pytest.raises(ValueError):
        Gateway(backend="sim", scheduler="lifo")
    with Gateway(backend="runtime", policy="sage", scheduler="edf",
                 time_scale=0.02, **CPU) as gw_rt:
        assert gw_rt.runtime.scheduler == "edf"
        assert gw_rt.runtime.daemon.scheduler == "edf"
        assert gw_rt.runtime.db.device.type == "cpu"


def test_spec_scheduler_adoption_and_conflict():
    with pytest.raises(ValueError):
        FunctionSpec(name="x", scheduler="lifo")
    gw = Gateway(backend="sim", policy="sage")
    gw.register(FunctionSpec.from_profile("resnet50", scheduler="edf"))
    assert gw.scheduler == "edf" and gw.sim.nodes[0].scheduler == "edf"
    with pytest.raises(ValueError, match="scheduler"):
        gw.register(FunctionSpec.from_profile("bert", scheduler="fifo"))
    gw2 = Gateway(backend="sim", policy="sage", scheduler="fifo")
    with pytest.raises(ValueError, match="scheduler"):
        gw2.register(FunctionSpec.from_profile("resnet50", scheduler="edf"))
    gw3 = Gateway(backend="sim", policy="sage")
    with pytest.raises(KeyError):
        gw3.register(FunctionSpec(name="bad", profile="nope", scheduler="edf"))
    assert gw3.scheduler == "fifo" and "bad" not in gw3.specs
    gw3.register(FunctionSpec.from_profile("resnet50", scheduler="fifo"))


def _gateway_slo_replay(m, scheduler):
    """One contended mixed-deadline trace: four loose 500 MB loads queued
    on a single loader thread ahead of one tight 16 MB load."""
    gw = m.Gateway(backend="sim", policy="sage", scheduler=scheduler, loader_threads=1)
    for i in range(4):
        gw.register(m.FunctionSpec(name=f"batch{i}", read_only_bytes=0,
                                   writable_bytes=500 * MB, context_bytes=MB,
                                   compute_ms=5.0, deadline_s=30.0, priority=0))
    gw.register(m.FunctionSpec(name="crit", read_only_bytes=0,
                               writable_bytes=16 * MB, context_bytes=MB,
                               compute_ms=5.0, deadline_s=1.2, priority=1))
    wl = m.TraceWorkload([m.Arrival(0.001 * i, f"batch{i}") for i in range(4)]
                         + [m.Arrival(0.05, "crit")])
    tel = gw.replay(wl, until_pad=600.0)
    node = gw.sim.nodes[0]
    assert tel.error_count() == 0
    assert node.max_inflight_loads <= 1
    assert node.host_used == 0
    return tel


def test_gateway_edf_strictly_beats_fifo_and_reports_by_class():
    want_fifo, tel_fifo = _on_both(lambda m: _gateway_slo_replay(m, "fifo"))
    want_edf, tel_edf = _on_both(lambda m: _gateway_slo_replay(m, "edf"))
    assert _rows(tel_fifo) == _rows(want_fifo)
    assert _rows(tel_edf) == _rows(want_edf)
    assert tel_fifo.slo_miss_rate() > 0.0
    assert tel_edf.slo_miss_rate() < tel_fifo.slo_miss_rate()
    assert tel_fifo.slo_by_priority()[1]["attainment"] == 0.0
    by_prio = tel_edf.slo_by_priority()
    assert by_prio[1] == {"requests": 1, "misses": 0, "miss_rate": 0.0, "attainment": 1.0}
    assert by_prio[0]["attainment"] == 1.0


# ---------------------------------------------------------------------------
# Runtime/simulator parity on the port's two backends
# ---------------------------------------------------------------------------

def _sorted_records(tel):
    return sorted(tel.records, key=lambda r: r.arrival_t)


def test_parity_stage_keys_and_warm_classification():
    spec = FunctionSpec(name="par", deadline_s=30.0, **SMALL)
    workload = TraceWorkload([(0.0, "par"), (2.5, "par"), (5.0, "par")])

    gw_sim = Gateway(backend="sim", policy="sage")
    gw_sim.register(spec)
    tel_sim = gw_sim.replay(workload, until_pad=60.0)
    with Gateway(backend="runtime", policy="sage", time_scale=0.05, **CPU) as gw_rt:
        gw_rt.register(spec)
        tel_rt = gw_rt.replay(workload)

    for tel in (tel_sim, tel_rt):
        recs = _sorted_records(tel)
        assert len(recs) == 3
        assert all(r.error is None for r in recs)
        assert all(set(r.stages) == set(STAGES) for r in recs)
        assert all(r.deadline_s == 30.0 for r in recs)
    warm_sim = [r.warm_stage is None for r in _sorted_records(tel_sim)]
    warm_rt = [r.warm_stage is None for r in _sorted_records(tel_rt)]
    assert warm_sim == warm_rt == [True, False, False]


def test_parity_errors_surface_in_record_error_on_both_backends():
    spec = FunctionSpec(name="big", arch="qwen2.5-3b", profile="bert")
    workload = TraceWorkload([(0.0, "big")])
    cap = 600 * MB  # fits the 414 MB context, never the 1282 MB weights

    gw_sim = Gateway(backend="sim", policy="sage", device_capacity=cap, load_timeout_s=5.0)
    gw_sim.register(spec)
    tel_sim = gw_sim.replay(workload, until_pad=60.0)
    with Gateway(backend="runtime", policy="sage", device_capacity=cap,
                 time_scale=0.02, load_timeout_s=0.5, **CPU) as gw_rt:
        gw_rt.register(spec)
        tel_rt = gw_rt.replay(workload)

    for tel in (tel_sim, tel_rt):
        assert tel.error_count() == 1
        assert "DataLoadError" in tel.errors()[0].error


def test_gateway_cluster_runtime_dispatches_across_nodes():
    with Gateway(backend="runtime", policy="sage", n_nodes=2,
                 time_scale=0.02, seed=0, **CPU) as gw:
        gw.register(FunctionSpec(name="f", **SMALL))
        assert all(n.db.device.type == "cpu" for n in gw.runtime.nodes)
        tel = gw.replay(TraceWorkload([(0.02 * i, "f") for i in range(4)]))
        assert len(tel.records) == 4
        assert tel.error_count() == 0
        rec = tel.records[0]
        assert gw.report().find(rec.request_id) is rec


def test_autoscaled_joiner_gets_the_gateways_device():
    """A node added to a runtime cluster lowers every registered spec onto
    its own database, on the gateway's device."""
    with Gateway(backend="runtime", policy="sage", n_nodes=2, time_scale=0.02, **CPU) as gw:
        gw.register(FunctionSpec(name="f", **SMALL))
        node = gw.runtime.add_node()
        assert node.db.device.type == "cpu"
        assert node in gw._nodes and len(gw._fns["f"]) == 3
        assert node.db.fetch("f/weights") is not None


# ---------------------------------------------------------------------------
# Served outputs and stats keys against the reference gateway
# ---------------------------------------------------------------------------

def _served(m, seeds, weights=None, arch="qwen2.5-3b", **kw):
    """Cold + warm invocations of one reduced-``arch`` function; returns the
    served outputs, records and stats key sets. ``weights`` (port only)
    replaces the function's weights after registration."""
    with m.Gateway(backend="runtime", policy="sage", time_scale=0.02, **kw) as gw:
        gw.register(m.FunctionSpec(name="demo", seed=3, **{**SMALL, "arch": arch}))
        db = gw.runtime.db
        if weights is not None:
            db.put("demo/weights", weights, size=db.size_of("demo/weights"))
        recs = [gw.invoke("demo", seed=s) for s in seeds]
        outs = [np.asarray(db.fetch(r.result), np.float32) for r in recs]
        keys = {k: set(getattr(gw, k)()) for k in
                ("resilience_stats", "compute_stats", "memory_usage")}
        params = db.fetch("demo/weights")
    return outs, recs, keys, params


def test_served_outputs_match_reference_gateway():
    _served_outputs_match_reference("qwen2.5-3b")


# the other families the JAX package's runtime gateway serves (whisper needs
# encoder embeddings, which its runtime forward does not pass)
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b", "qwen2-vl-72b"])
def test_served_zoo_outputs_match_reference_gateway(arch):
    _served_outputs_match_reference(arch)


def _served_outputs_match_reference(arch):
    seeds = (0, 1, 2)
    want, ref_recs, ref_keys, jparams = _served(ref_api, seeds, arch=arch)
    weights = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    got, recs, keys, _ = _served(api, seeds, weights=weights, arch=arch, **CPU)
    assert [r.warm_stage for r in recs] == [r.warm_stage for r in ref_recs] == [None, 1, 1]
    assert [sorted(r.stages) for r in recs] == [sorted(r.stages) for r in ref_recs]
    assert keys == ref_keys
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 8)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    assert not np.array_equal(got[0], got[1])  # different seeds, different tokens


@pytest.mark.parametrize("n_nodes", [1, 2])
def test_stats_key_sets_equal_reference_on_both_backends(n_nodes):
    def keys(gw):
        return {k: set(getattr(gw, k)()) for k in
                ("resilience_stats", "compute_stats", "memory_usage")}

    sim = keys(Gateway(backend="sim", n_nodes=n_nodes))
    ref_sim = keys(ref_api.Gateway(backend="sim", n_nodes=n_nodes))
    with Gateway(backend="runtime", n_nodes=n_nodes, time_scale=0.02, **CPU) as gw:
        rt = keys(gw)
    with ref_api.Gateway(backend="runtime", n_nodes=n_nodes, time_scale=0.02) as gw:
        ref_rt = keys(gw)
    assert sim == ref_sim
    assert rt == ref_rt
    assert sim == rt  # the backend-parity contract


# ---------------------------------------------------------------------------
# satellite regressions
# ---------------------------------------------------------------------------

def test_telemetry_reads_are_safe_against_concurrent_adds():
    from repro_torch.core.telemetry import InvocationRecord, Telemetry

    tel = Telemetry()
    n = 5000

    def writer():
        for i in range(n):
            tel.add(InvocationRecord(
                request_id=f"r{i}", function=f"f{i % 3}", system="sage",
                arrival_t=0.0, end_t=10.0, deadline_s=1.0, priority=i % 2))

    t = threading.Thread(target=writer)
    t.start()
    try:
        while t.is_alive():
            tel.by_function()
            tel.mean_e2e()
            tel.p99_e2e()
            tel.warm_fraction()
            if tel.records:
                assert tel.slo_miss_rate() == 1.0
            for c in tel.slo_by_priority().values():
                assert c["misses"] == c["requests"]
    finally:
        t.join(timeout=30)
    assert not t.is_alive()
    assert len(tel.records) == n


def test_instance_ids_come_from_unbounded_counter():
    from repro_torch.core.engine import GPUFunction, Instance

    assert isinstance(Instance._ids, itertools.count)
    fn = GPUFunction(name="x", handler=lambda s, r: None, context_builder=lambda: None)
    a, b = Instance(fn), Instance(fn)
    assert b.id == a.id + 1


def test_request_arrival_zero_is_preserved():
    from repro_torch.core import SageRuntime
    from repro_torch.core.functions import make_model_function, make_request

    rt = SageRuntime("sage", time_scale=0.02, **CPU)
    rt.sage_init()
    fn = make_model_function(rt.db, "f", arch="qwen2.5-3b", profile=PROFILES["seq2seq"])
    rt.register_function(fn)
    req = make_request(rt.db, fn, seed=0)
    assert req.arrival_t is None
    req.arrival_t = 0.0
    rt.sage_run(req)
    assert rt.telemetry.records[-1].arrival_t == 0.0
    fut = rt.submit(make_request(rt.db, fn, seed=1))
    fut.result(timeout=60)
    assert rt.telemetry.records[-1].arrival_t > 0.0
    rt.shutdown()
