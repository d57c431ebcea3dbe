"""The port's virtual-time twin (``repro_torch.core.simulator`` and
``core/sim/``) against the JAX package's: the golden traces of
tests/golden/sim_golden.json replay record for record through the port, and
the cases of tests/test_simulator.py run the same calls on both simulators
and agree exactly (completed, failed and every record row)."""
import json
import random
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core import simulator as ref_sim  # noqa: E402
from repro.core.profiles import PROFILES as REF_PROFILES  # noqa: E402
from repro_torch.api.workload import maf_like_trace  # noqa: E402
from repro_torch.core import simulator as port_sim  # noqa: E402
from repro_torch.core.profiles import PROFILES  # noqa: E402

GOLDEN_PATH = Path(__file__).parent / "golden" / "sim_golden.json"
NAMES = list(PROFILES)

# the row layout and rounding of scripts/capture_sim_golden.py, which
# imports the JAX package; these are the port's copies of its builders
R = 9
STAGE_KEYS = ("container_create", "cpu_ctx", "cpu_data", "gpu_ctx",
              "gpu_data", "compute", "return_result")


def record_rows(sim) -> list:
    rows = []
    for r in sorted(sim.telemetry.snapshot(),
                    key=lambda r: (r.arrival_t, r.request_id)):
        rows.append([
            r.request_id,
            r.node_id,
            r.warm_stage,
            round(r.arrival_t, R),
            round(r.end_t, R),
            [round(r.stages.get(s, 0.0), R) for s in STAGE_KEYS],
            r.error is not None,
            r.preemptions,
            round(r.stalled_s, R),
            r.dispatch_tier,
        ])
    return rows


def maf_trace():
    return maf_like_trace(sorted(PROFILES), duration_s=150.0, seed=3, mean_rpm=15)


def run_system(system: str):
    trace = maf_trace()
    sim = port_sim.Simulator(system, seed=1)
    for n in sorted(PROFILES):
        sim.register(port_sim.SimFunction(PROFILES[n]))
    for t, f in trace:
        sim.submit(f, t)
    sim.run(until=10 * trace[-1][0] + 100.0)
    return sim


def run_knobs():
    """EDF scheduler + locality dispatch + preemptive transfer, 4 nodes,
    contended mixed-SLO trace."""
    sim = port_sim.Simulator("sage", n_nodes=4, seed=5, loader_threads=1,
                             scheduler="edf", dispatch="locality",
                             transfer="preemptive")
    names = ["lbm", "seq2seq", "vgg11", "mrif"]
    for n in names:
        sim.register(port_sim.SimFunction(PROFILES[n]))
    prio = {"lbm": 0, "vgg11": 0, "mrif": 0, "seq2seq": 2}
    dl = {"lbm": 60.0, "vgg11": 30.0, "mrif": 30.0, "seq2seq": 1.0}
    for i in range(400):
        f = names[i % 4]
        sim.submit(f, 0.02 * i, deadline_s=dl[f], priority=prio[f])
    sim.run(until=3600.0)
    return sim


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def _assert_rows_equal(got, want, trace_name):
    assert len(got) == len(want), f"{trace_name}: {len(got)} records vs {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{trace_name}: first divergence at record {i}:\n  want: {w}\n  port: {g}"


def test_golden_layout_is_the_one_replayed(golden):
    assert golden["resolution"] == R
    assert tuple(golden["stage_keys"]) == STAGE_KEYS


@pytest.mark.parametrize("system", ["sage", "sage-nr", "fixedgsl", "dgsf"])
def test_maf_golden_trace_replays_identically(golden, system):
    want = golden["traces"][f"maf:{system}"]
    sim = run_system(system)
    assert sim.completed == want["completed"]
    assert sim.failed == want["failed"]
    _assert_rows_equal(record_rows(sim), want["records"], f"maf:{system}")


def test_knob_golden_trace_replays_identically(golden):
    want = golden["traces"]["knobs:edf+locality+preemptive"]
    sim = run_knobs()
    assert want["preemptions"] > 0
    assert sim.completed == want["completed"]
    assert sim.failed == want["failed"]
    assert sim.preemption_count() == want["preemptions"]
    _assert_rows_equal(record_rows(sim), want["records"], "knobs")


# ---------------------------------------------------------------------------
# tests/test_simulator.py, each on both simulators
# ---------------------------------------------------------------------------

def _run(mod, profiles, system, trace, seed=1, **kw):
    sim = mod.Simulator(system, seed=seed, **kw)
    for n in NAMES:
        sim.register(mod.SimFunction(profiles[n]))
    for t, f in trace:
        sim.submit(f, t)
    sim.run(until=10 * (trace[-1][0] if trace else 1.0) + 100.0)
    return sim


def _both(system, trace, **kw):
    """The same run on the JAX package's simulator and the port's; they
    agree on completed, failed and every record row."""
    ref = _run(ref_sim, REF_PROFILES, system, trace, **kw)
    got = _run(port_sim, PROFILES, system, trace, **kw)
    assert got.completed == ref.completed
    assert got.failed == ref.failed
    _assert_rows_equal(record_rows(got), record_rows(ref), system)
    return got, ref


@pytest.fixture(scope="module")
def trace():
    got = maf_like_trace(NAMES, duration_s=300.0, seed=3, mean_rpm=20)
    from repro.api.workload import maf_like_trace as ref_maf_like_trace

    assert got == ref_maf_like_trace(NAMES, duration_s=300.0, seed=3, mean_rpm=20)
    return got


def test_deterministic(trace):
    a, ref = _both("sage", trace)
    b = _run(port_sim, PROFILES, "sage", trace)
    assert a.completed == b.completed
    assert abs(a.telemetry.mean_e2e() - b.telemetry.mean_e2e()) < 1e-12
    assert a.telemetry.mean_e2e() == ref.telemetry.mean_e2e()


def test_all_requests_complete(trace):
    for system in ("sage", "fixedgsl", "dgsf", "sage-nr"):
        sim, _ = _both(system, trace)
        assert sim.completed == len(trace), system


def test_sage_latency_beats_baselines(trace):
    e2e = {}
    for s in ("sage", "fixedgsl", "dgsf", "sage-nr"):
        got, ref = _both(s, trace)
        e2e[s] = got.telemetry.mean_e2e()
        assert e2e[s] == ref.telemetry.mean_e2e()
    assert e2e["sage"] < e2e["dgsf"] < e2e["fixedgsl"]
    assert e2e["sage"] < e2e["sage-nr"]


def test_sage_uses_least_memory(trace):
    mem = {}
    for s in ("sage", "fixedgsl", "dgsf"):
        got, ref = _both(s, trace)
        mem[s] = got.mean_memory_bytes()
        assert mem[s] == ref.mean_memory_bytes()
    assert mem["sage"] < mem["fixedgsl"]
    assert mem["sage"] < mem["dgsf"]


def test_sage_warm_hits_dominate(trace):
    sim, ref = _both("sage", trace)
    assert sim.telemetry.warm_fraction() == ref.telemetry.warm_fraction() > 0.8


def test_parallel_setup_hides_a_stage():
    """Cold SAGE-PS end-to-end ~= max(ctx, data) + compute, not their sum,
    and the same number on both simulators."""
    assert (port_sim.CPU_CTX_S, port_sim.GPU_CTX_S) == (ref_sim.CPU_CTX_S, ref_sim.GPU_CTX_S)
    e2e = []
    for mod, profiles in ((ref_sim, REF_PROFILES), (port_sim, PROFILES)):
        f = mod.SimFunction(profiles["resnet50"])
        sim = mod.Simulator("sage-ps", seed=0)
        sim.register(f)
        sim.submit("resnet50", 0.0)
        sim.run(until=100.0)
        e2e.append(sim.telemetry.records[0].e2e)
    assert e2e[0] == e2e[1]
    f = port_sim.SimFunction(PROFILES["resnet50"])
    solo_data = f.ro_bytes / 1.63e9 + f.ro_bytes / 5.05e9 + \
        f.w_bytes / 1.63e9 + f.w_bytes / 5.05e9
    serial = port_sim.CPU_CTX_S + port_sim.GPU_CTX_S + solo_data + f.compute_s
    parallel_bound = max(port_sim.GPU_CTX_S + port_sim.CPU_CTX_S, solo_data) + f.compute_s
    assert e2e[1] < 0.9 * serial
    assert e2e[1] < parallel_bound * 1.35


def test_fixed_slot_granularity_caps_density():
    burst = [(0.0 + i * 1e-3, "bert") for i in range(40)]
    gsl, gsl_ref = _both("fixedgsl", burst, capacity=8 << 30)
    flex, flex_ref = _both("fixedgsl-f", burst, capacity=8 << 30)
    assert gsl.completed == flex.completed == 40
    assert gsl.mean_memory_bytes() == gsl_ref.mean_memory_bytes()
    assert flex.mean_memory_bytes() == flex_ref.mean_memory_bytes()
    assert gsl.mean_memory_bytes() > flex.mean_memory_bytes()


def test_poisson_arrivals_rate():
    with pytest.warns(DeprecationWarning, match="repro_torch.api.workload"):
        arr = port_sim.poisson_arrivals(10.0, 100.0, random.Random(0))
    with pytest.warns(DeprecationWarning):
        want = ref_sim.poisson_arrivals(10.0, 100.0, random.Random(0))
    assert arr == want
    assert 800 < len(arr) < 1200
