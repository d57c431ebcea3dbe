"""The port's discrete-event engine and streaming telemetry
(``repro_torch.core.sim.{kernel,metrics}``, ``core.telemetry``, the
workload generators) held against the JAX package's, case by case: the
cases of tests/test_sim_kernel.py and tests/test_sim_metrics.py, and the
exit-ladder and bandwidth-broker properties of tests/test_properties.py.

Deterministic cases run the same calls through both packages and assert
equal results, then make the reference's assertions on the port's."""
import importlib
import random
import warnings
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro_torch.api.workload import (  # noqa: E402
    DiurnalWorkload, FlashCrowdWorkload, PoissonWorkload,
)
from repro_torch.core.clock import RealClock, VirtualClock  # noqa: E402
from repro_torch.core.sim import Event, EventKernel, EventKind, RngStreams  # noqa: E402
from repro_torch.core.sim.metrics import (  # noqa: E402
    AggregateTelemetry, P2Quantile, Reservoir,
)
from repro_torch.core.telemetry import InvocationRecord, Telemetry  # noqa: E402


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    sim, metrics, wl = mod("core.sim"), mod("core.sim.metrics"), mod("api.workload")
    return SimpleNamespace(
        EventKernel=sim.EventKernel, EventKind=sim.EventKind,
        RngStreams=sim.RngStreams, P2Quantile=metrics.P2Quantile,
        Reservoir=metrics.Reservoir,
        AggregateTelemetry=metrics.AggregateTelemetry,
        InvocationRecord=mod("core.telemetry").InvocationRecord,
        Telemetry=mod("core.telemetry").Telemetry,
        VirtualClock=mod("core.clock").VirtualClock,
        BandwidthBroker=mod("core.datapath").BandwidthBroker,
        ExitLadder=mod("core.exit_policy").ExitLadder,
        MixWorkload=wl.MixWorkload, PoissonWorkload=wl.PoissonWorkload,
        DiurnalWorkload=wl.DiurnalWorkload,
        FlashCrowdWorkload=wl.FlashCrowdWorkload,
        MultiRegionWorkload=wl.MultiRegionWorkload)


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def on_both(run):
    """``run(pkg)`` on the JAX package and the port; (reference, port)."""
    return run(REF), run(PORT)


# ---------------------------------------------------------------------------
# tests/test_sim_kernel.py: the discrete-event kernel
# ---------------------------------------------------------------------------

def test_events_fire_in_time_then_seq_order():
    def run(m):
        k = m.EventKernel()
        fired = []
        k.schedule(2.0, fired.append, "late")
        k.schedule(1.0, fired.append, "early")
        k.schedule(1.0, fired.append, "early2")  # same t: insertion order wins
        k.schedule(0.0, fired.append, "now")
        k.run_until(10.0)
        return fired, k.now(), k.events_processed

    want, (fired, now, n) = on_both(run)
    assert (fired, now, n) == want
    assert fired == ["now", "early", "early2", "late"]
    assert now == 10.0  # finite horizon: clock lands on t_end
    assert n == 4


def test_event_record_fields_and_heap_comparability():
    e1 = Event(1.0, 1, EventKind.COMPUTE, print, ("x",))
    e2 = Event(1.0, 2, EventKind.CALL, print)
    assert (e1.t, e1.seq, e1.kind, e1.fn, e1.args) == \
        (1.0, 1, EventKind.COMPUTE, print, ("x",))
    # same timestamp, non-comparable fn: seq must decide before fn is reached
    assert e1 < e2
    assert "COMPUTE" in repr(e1)
    # the same taxonomy, bucket for bucket, as the reference
    assert [k.name for k in EventKind] == [k.name for k in REF.EventKind]


def test_kind_counts_tally_per_taxonomy_bucket():
    def run(m):
        k = m.EventKernel()
        k.schedule(0.1, lambda: None, kind=m.EventKind.TRANSFER)
        k.schedule(0.2, lambda: None, kind=m.EventKind.TRANSFER)
        k.schedule(0.3, lambda: None)  # CALL
        k.run_until(1.0)
        return list(k.kind_counts), k.kind_counts[m.EventKind.TRANSFER], \
            k.kind_counts[m.EventKind.CALL]

    want, (counts, transfers, calls) = on_both(run)
    assert counts == want[0]
    assert transfers == 2
    assert calls == 1


def test_negative_delay_clamps_to_now():
    k = EventKernel()
    out = []
    k.schedule(5.0, lambda: (out.append(k.now()),
                             k.schedule(-3.0, lambda: out.append(k.now()))))
    k.run_until(10.0)
    assert out == [5.0, 5.0]


def test_schedule_at_past_time_warns_once_and_counts():
    k = EventKernel()
    k.schedule(5.0, lambda: None)
    k.run_until(10.0)
    assert k.now() == 10.0
    fired = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        k.schedule_at(3.0, fired.append, 1)   # past: warns
        k.schedule_at(2.0, fired.append, 2)   # past again: counted, silent
        k.schedule_at(12.0, fired.append, 3)  # future: untouched
    assert [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning) and
            "past" in str(w.message)] != []
    assert sum(1 for w in caught if issubclass(w.category, RuntimeWarning)) == 1
    assert k.past_events == 2
    k.run_until(20.0)
    assert fired == [1, 2, 3]  # clamped events fire at now, in call order


def test_empty_kernel_is_truthy_for_clock_defaulting():
    # BandwidthBroker does `clock or RealClock()`: an empty VirtualClock
    # must not be falsy, or every sim broker silently runs on real time
    clock = VirtualClock()
    assert clock.queued == 0
    assert (clock or RealClock()) is clock


def test_virtual_clock_is_a_kernel_facade():
    clock = VirtualClock()
    assert isinstance(clock, EventKernel)
    seen = []
    clock.schedule(1.5, seen.append, "a")
    clock.run_until(2.0)
    assert seen == ["a"] and clock.now() == 2.0


def test_run_until_returns_fired_count_and_drains_cascades():
    k = EventKernel()

    def cascade(depth):
        if depth:
            k.schedule(0.5, cascade, depth - 1)

    k.schedule(0.0, cascade, 3)
    assert k.run_until(10.0) == 4


def test_rng_streams_root_matches_seeded_random_and_named_are_stable():
    streams = RngStreams(42)
    assert streams.root.random() == random.Random(42).random()
    a = streams.get("telemetry")
    assert streams.get("telemetry") is a  # cached
    assert a.random() == random.Random("42:telemetry").random()
    want, got = on_both(lambda m: [m.RngStreams(7).get(n).random()
                                   for n in ("root", "telemetry", "faults")])
    assert got == want


# ---------------------------------------------------------------------------
# tests/test_sim_metrics.py: P² quantile, reservoir, aggregates
# ---------------------------------------------------------------------------

def test_p2_exact_below_five_observations():
    sk = P2Quantile(0.5)
    assert sk.value() == 0.0
    for x in (5.0, 1.0, 3.0):
        sk.add(x)
    assert sk.value() == 3.0  # exact median of {1,3,5}


@pytest.mark.parametrize("p", [0.5, 0.99])
def test_p2_tracks_sorted_quantile_on_random_streams(p):
    rng = random.Random(7)
    xs = [rng.expovariate(1.0) for _ in range(20000)]

    def run(m):
        sk = m.P2Quantile(p)
        for x in xs:
            sk.add(x)
        return sk.count, sk.value()

    want, (count, value) = on_both(run)
    assert (count, value) == want  # the same estimate, bit for bit
    xs.sort()
    exact = xs[min(int(p * len(xs)), len(xs) - 1)]
    assert count == len(xs)
    # P² is an estimate: accept 5% relative error on a smooth distribution
    assert abs(value - exact) <= 0.05 * exact


def test_p2_rejects_degenerate_quantiles():
    for bad in (0.0, 1.0, -0.1):
        with pytest.raises(ValueError):
            P2Quantile(bad)


def test_reservoir_keeps_everything_until_capacity():
    r = Reservoir(k=10, rng=random.Random(0))
    for i in range(10):
        r.add(float(i))
    assert sorted(r.sample) == [float(i) for i in range(10)]
    assert r.quantile(0.5) == 5.0


def test_reservoir_is_bounded_and_deterministic():
    def fill(seed, m=PORT):
        r = m.Reservoir(k=64, rng=random.Random(seed))
        for i in range(5000):
            r.add(float(i))
        return list(r.sample)

    assert len(fill(3)) == 64
    assert fill(3) == fill(3) == fill(3, REF)  # same seed -> same sample
    assert fill(3) != fill(4)          # stream position actually used
    # a uniform sample of 0..4999 should not be the first 64 items
    assert max(fill(3)) > 1000


def _records(m, n=400, seed=5):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        t0 = i * 0.01
        dur = rng.expovariate(20.0)
        rec = m.InvocationRecord(
            request_id=f"r{i}", function="f", system="sage",
            arrival_t=t0, start_t=t0, end_t=t0 + dur,
            warm_stage=1 if rng.random() < 0.7 else None,
            deadline_s=0.15, priority=0)
        if rng.random() < 0.05:
            rec.error = "DataLoadError: f: boom"
        out.append(rec)
    return out


def test_aggregate_matches_full_telemetry_tallies():
    def run(m):
        recs = _records(m)
        agg = m.AggregateTelemetry(seed=0)
        full = m.Telemetry()
        for r in recs:
            agg.add(r)
            full.add(r)
        return recs, agg, full

    (_, ref_agg, _), (recs, agg, full) = on_both(run)
    assert agg.snapshot() == ref_agg.snapshot()
    ok = [r for r in recs if r.error is None]
    assert agg.count == len(recs)
    assert agg.failures == len(recs) - len(ok)
    assert agg.completed == len(ok)
    assert agg.warm_fraction() == pytest.approx(
        sum(1 for r in ok if r.warm_stage is not None) / len(ok))
    assert agg.mean_e2e() == pytest.approx(
        sum(r.e2e for r in ok) / len(ok))
    # goodput counts failed deadline-carrying requests as misses
    met = sum(1 for r in ok if r.e2e <= r.deadline_s)
    assert agg.goodput() == pytest.approx(met / len(recs))
    # sketch percentiles land near the exact full-record ones
    assert agg.e2e_p50.value() == pytest.approx(
        full._quantile_attr(0.5, "e2e"), rel=0.15)
    snap = agg.snapshot()
    for key in ("count", "p50_e2e_s", "p99_e2e_s", "goodput",
                "warm_fraction", "preemptions"):
        assert key in snap


def test_aggregate_goodput_defaults_without_deadlines():
    agg = AggregateTelemetry()
    assert agg.goodput() == 1.0
    rec = InvocationRecord(request_id="x", function="f", system="sage",
                           arrival_t=0.0, start_t=0.0, end_t=1.0)
    agg.add(rec)
    bad = InvocationRecord(request_id="y", function="f", system="sage",
                           arrival_t=0.0, start_t=0.0, end_t=1.0)
    bad.error = "DataLoadError: f: boom"
    agg.add(bad)
    assert agg.goodput() == pytest.approx(0.5)  # completion ratio fallback


def test_quantile_cache_reuses_sorted_view_until_append():
    tel = Telemetry()
    for r in _records(PORT, 200):
        tel.add(r)

    p99_first = tel.p99_duration()
    # repeated calls between appends hit the cache: the cached entry for
    # ("duration", None) must be identical object across calls
    cached = tel._sorted_cache[("duration", None)]
    assert tel.p99_duration() == p99_first
    assert tel._sorted_cache[("duration", None)] is cached
    assert cached[1] == sorted(cached[1])

    # an append invalidates: the next call recomputes and sees the new row
    late = InvocationRecord(request_id="slow", function="f", system="sage",
                            arrival_t=0.0, start_t=0.0, end_t=999.0)
    tel.add(late)
    tel.p99_duration()  # recomputes: cache entry must be a fresh object
    assert tel._sorted_vals("duration", None)[-1] == 999.0
    assert tel._sorted_cache[("duration", None)] is not cached
    assert tel.p50_duration() <= tel.p95_duration() <= tel.p99_duration()


def test_quantile_cache_is_per_function_and_attr():
    tel = Telemetry()
    for i, fn in enumerate(["a", "b", "a", "b"]):
        tel.add(InvocationRecord(request_id=f"r{i}", function=fn,
                                 system="sage", arrival_t=0.0, start_t=0.0,
                                 end_t=float(i + 1)))
    assert tel.p99_duration("a") == 3.0
    assert tel.p99_duration("b") == 4.0
    assert tel.p99_e2e() == 4.0
    assert ("duration", "a") in tel._sorted_cache
    assert ("e2e", None) in tel._sorted_cache


# workloads: lazy streams + generators

def _rows(events):
    return [(a.t, a.function, a.deadline_s, a.priority) for a in events]


def test_stream_equals_events_for_mix_workload():
    want, (streamed, batch) = on_both(lambda m: (
        [(a.t, a.function) for a in m.MixWorkload({"a": 5.0, "b": 2.0}, 50.0, seed=9).stream()],
        sorted((a.t, a.function) for a in m.MixWorkload({"a": 5.0, "b": 2.0}, 50.0,
                                                       seed=9).events())))
    assert (streamed, batch) == want
    assert streamed == batch
    ts = [t for t, _ in streamed]
    assert ts == sorted(ts)  # merged stream is time-ordered


def test_stream_is_lazy_for_huge_workloads():
    wl = PoissonWorkload("f", 1000.0, 1e6, seed=1)  # ~1e9 events if realized
    it = wl.stream()
    first = [next(it) for _ in range(5)]
    assert all(a.function == "f" for a in first)
    assert [a.t for a in first] == sorted(a.t for a in first)
    ref_it = REF.PoissonWorkload("f", 1000.0, 1e6, seed=1).stream()
    assert _rows(first) == _rows(next(ref_it) for _ in range(5))


def test_diurnal_rate_swings_with_phase():
    wl = DiurnalWorkload("f", 10.0, 400.0, amplitude=0.8, period_s=400.0,
                         seed=2)
    assert wl.rate_at(100.0) == pytest.approx(18.0)   # sin peak
    assert wl.rate_at(300.0) == pytest.approx(2.0)    # sin trough
    events = wl.events()
    assert _rows(events) == _rows(REF.DiurnalWorkload(
        "f", 10.0, 400.0, amplitude=0.8, period_s=400.0, seed=2).events())
    peak = sum(1 for a in events if 50 <= a.t < 150)
    trough = sum(1 for a in events if 250 <= a.t < 350)
    assert peak > 2.5 * trough
    with pytest.raises(ValueError):
        DiurnalWorkload("f", 10.0, 10.0, amplitude=1.5)


def test_flash_crowd_spikes_then_decays():
    wl = FlashCrowdWorkload("f", 5.0, 300.0, spike_times_s=(100.0,),
                            spike_factor=10.0, decay_s=10.0, seed=3)
    assert wl.rate_at(50.0) == pytest.approx(5.0)
    assert wl.rate_at(100.0) == pytest.approx(50.0)
    assert wl.rate_at(110.0) < wl.rate_at(101.0)  # exponential decay
    events = wl.events()
    assert _rows(events) == _rows(REF.FlashCrowdWorkload(
        "f", 5.0, 300.0, spike_times_s=(100.0,), spike_factor=10.0,
        decay_s=10.0, seed=3).events())
    spike = sum(1 for a in events if 100 <= a.t < 120)
    calm = sum(1 for a in events if 60 <= a.t < 80)
    assert spike > 2 * calm


def test_multi_region_offsets_and_merge_order():
    def run(m):
        base = {
            "us": m.PoissonWorkload("f", 4.0, 60.0, seed=4),
            "eu": m.PoissonWorkload("g", 4.0, 60.0, seed=5),
        }
        wl = m.MultiRegionWorkload(base, offsets_s={"us": 0.0, "eu": 30.0})
        return list(wl.stream()), wl.duration_s

    (ref_events, ref_dur), (events, duration) = on_both(run)
    assert (_rows(events), duration) == (_rows(ref_events), ref_dur)
    assert [a.t for a in events] == sorted(a.t for a in events)
    assert min(a.t for a in events if a.function == "g") >= 30.0
    assert duration >= 90.0  # eu shifted past its 60 s duration


def test_simulator_trace_aliases_warn_and_match_canonical():
    from repro_torch.api import workload as W
    from repro_torch.core import simulator as S

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        old = S.poisson_arrivals(10.0, 20.0, random.Random(0))
        old_maf = S.maf_like_trace(["a", "b"], duration_s=60.0, seed=1)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert old == W.poisson_arrivals(10.0, 20.0, random.Random(0))
    assert old_maf == W.maf_like_trace(["a", "b"], duration_s=60.0, seed=1)
    from repro.api import workload as RW
    assert old_maf == RW.maf_like_trace(["a", "b"], duration_s=60.0, seed=1)


# ---------------------------------------------------------------------------
# tests/test_properties.py: the exit-ladder and broker properties
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

SETTINGS = dict(max_examples=40, deadline=None)


@settings(**SETTINGS)
@given(
    ttls=st.tuples(*[st.floats(0.01, 100.0) for _ in range(4)]),
    t_complete=st.floats(0.0, 1e6),
    dt=st.floats(0.0, 1e7),
)
def test_ladder_stage_monotonic_nondecreasing(ttls, t_complete, dt):
    """Stages only move forward in time; stage is within [1, 5]; the
    port's ladder gives the reference's stages."""
    def run(m):
        lad = m.ExitLadder(ttls=ttls)
        lad.on_complete(t_complete)
        return lad.stage_at(t_complete + dt / 2), lad.stage_at(t_complete + dt)

    want, (s1, s2) = on_both(run)
    assert (s1, s2) == want
    assert 1 <= s1 <= s2 <= 5


@settings(**SETTINGS)
@given(
    ttls=st.tuples(*[st.floats(0.01, 50.0) for _ in range(4)]),
    checks=st.lists(st.floats(0.0, 300.0), min_size=1, max_size=8),
)
def test_ladder_actions_fire_exactly_once_each(ttls, checks):
    def run(m):
        fired = []
        lad = m.ExitLadder(ttls=ttls)
        lad.on_enter = {k: (lambda k=k: fired.append(k)) for k in (2, 3, 4)}
        lad.on_complete(0.0)
        for t in sorted(checks):
            lad.advance(t)
        return fired

    want, fired = on_both(run)
    assert fired == want
    assert fired == sorted(set(fired))  # in order, no duplicates


@settings(**SETTINGS)
@given(
    sizes=st.lists(st.integers(1, 200), min_size=1, max_size=10),
    bw=st.floats(10.0, 1e4),
)
def test_broker_conservation_and_fairness(sizes, bw):
    """All virtual transfers complete; total busy time >= total_bytes / bw
    (a shared link can never beat its own bandwidth); the same finish
    times as the reference's broker."""
    def run(m):
        clock = m.VirtualClock()
        b = m.BandwidthBroker(bw, clock)
        done = []
        for s in sizes:
            b.sim_transfer(float(s), lambda s=s: done.append((s, clock.now())))
        clock.run_until(1e9)
        return done

    want, done = on_both(run)
    assert done == want
    assert len(done) == len(sizes)
    t_end = max(t for _, t in done)
    assert t_end >= 0.99 * sum(sizes) / bw  # conservation bound
    # no transfer finished faster than its solo time
    for s, t in done:
        assert t >= 0.99 * s / bw
