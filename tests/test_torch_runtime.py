"""The port's threaded ``SageRuntime`` on the CPU: the same cold -> warm ->
warm sequence through both packages gives the same lifecycle, daemon
statistics, teardown accounting and served outputs; and the runtime cases
of tests/test_runtime.py hold for the port."""
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SageRuntime as RefRuntime  # noqa: E402
from repro.core.functions import make_model_function as ref_make_fn  # noqa: E402
from repro.core.functions import make_request as ref_make_request  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import SageRuntime, functions  # noqa: E402
from repro_torch.core.functions import make_model_function, make_request  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

STATS = ("loads", "shared_hits", "bytes_loaded")


def _runtime(system="sage", **kw):
    kw.setdefault("exit_ttl", 1.0)
    rt = SageRuntime(system, time_scale=0.02, device="cpu", **kw)
    rt.sage_init()
    return rt


def _teardown(rt):
    """Graceful retire (the crash path's exact release, nothing in flight),
    on either package's runtime (the JAX one has no ``drain``)."""
    deadline = time.monotonic() + 10
    while not rt.is_idle() and time.monotonic() < deadline:
        time.sleep(0.01)
    rt.drain_teardown()
    usage = rt.memory_usage()
    rt.shutdown()
    return usage


def _cold_warm_warm(rt, make_fn, make_req, arch, weights=None):
    fn = make_fn(rt.db, "f", arch=arch, seed=3)
    if weights is not None:
        rt.db.put("f/weights", weights, size=rt.db.size_of("f/weights"))
    rt.register_function(fn)
    outs = []
    for seed in (0, 1, 2):
        out_key = rt.sage_run(make_req(rt.db, fn, seed=seed))
        outs.append(np.asarray(rt.db.fetch(out_key), np.float32))
    recs = rt.telemetry.records
    return dict(
        warm=[r.warm_stage for r in recs],
        stage_keys=[sorted(r.stages) for r in recs],
        stats={k: rt.daemon.stats[k] for k in STATS},
        ro_bytes=rt.db.size_of("f/weights"),
        outs=outs,
        usage=_teardown(rt),
    )


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m"])
def test_cold_warm_warm_matches_reference_runtime(arch):
    """Besides the lifecycle and outputs: on the CPU the context never
    captures a CUDA graph, so its forwards are counted nowhere."""
    graph_counts = (functions.graph_captures, functions.graph_replays,
                    functions.eager_forwards)
    before = [dict(c) for c in graph_counts]
    ref_rt = RefRuntime("sage", time_scale=0.02, exit_ttl=5.0)
    ref_rt.sage_init()
    want = _cold_warm_warm(ref_rt, ref_make_fn, ref_make_request, arch)
    jax_weights = ref_rt.db.fetch("f/weights")
    weights = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_weights), "cpu")
    got = _cold_warm_warm(_runtime(exit_ttl=5.0), make_model_function, make_request, arch,
                          weights=weights)
    assert [dict(c) for c in graph_counts] == before
    assert got["warm"] == want["warm"] == [None, 1, 1]
    assert got["stage_keys"] == want["stage_keys"]
    assert got["stats"] == want["stats"]
    assert got["ro_bytes"] == want["ro_bytes"]
    assert got["usage"]["device_used"] == got["usage"]["host_used"] == 0
    assert want["usage"]["device_used"] == want["usage"]["host_used"] == 0
    for g, w in zip(got["outs"], want["outs"]):
        assert g.shape == w.shape == (1, 8)
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_served_result_matches_direct_forward():
    rt = _runtime()
    fn = make_model_function(rt.db, "f", arch="qwen2.5-3b", seed=3)
    rt.register_function(fn)
    req = make_request(rt.db, fn, seed=11)
    before = fa.launches
    served = rt.db.fetch(rt.sage_run(req))
    cfg = ARCHS["qwen2.5-3b"].reduced()
    toks = rt.db.fetch(req.in_data[1].key)
    assert toks.dtype == torch.int32
    direct, _ = forward(cfg, rt.db.fetch("f/weights"), {"tokens": toks})
    np.testing.assert_allclose(served, direct[:, -1, :8].numpy(), atol=1e-4)
    assert fa.launches == before  # the CPU database never reaches the kernel
    rt.shutdown()


def test_sage_shares_read_only_across_concurrent():
    rt = _runtime()
    fn = make_model_function(rt.db, "f", arch="qwen2.5-3b")
    rt.register_function(fn)
    futs = [rt.submit(make_request(rt.db, fn, seed=i)) for i in range(6)]
    for f in futs:
        f.result(timeout=120)
    assert rt.daemon.stats["shared_hits"] >= 5
    assert rt.daemon.stats["loads"] <= 1 + 6  # 1 weights + <=6 inputs
    rt.shutdown()


def test_drain_waits_for_inflight_then_retires():
    """``drain`` lets the submitted requests finish, then retires the node
    with the exact release: every request served, nothing left declared."""
    rt = _runtime()
    fn = make_model_function(rt.db, "f", arch="qwen2.5-3b")
    rt.register_function(fn)
    futs = [rt.submit(make_request(rt.db, fn, seed=i)) for i in range(3)]
    usage = rt.drain(timeout=120.0)
    rt.shutdown()
    assert all(f.done() and f.exception() is None for f in futs)
    assert rt.retired and rt.is_idle()
    assert [r.error for r in rt.telemetry.records] == [None] * 3
    assert usage == {"device_used": 0, "context_bytes": 0, "host_used": 0}


def test_drain_releases_the_context(monkeypatch):
    """The node's teardown lets the function's context free what it holds
    on the device beyond the forward (on the card, its CUDA graph), once,
    though the engine keeps the context."""
    released = []
    monkeypatch.setattr(functions.ModelContext, "release", lambda ctx: released.append(ctx))
    rt = _runtime()
    fn = make_model_function(rt.db, "f", arch="qwen2.5-3b")
    rt.register_function(fn)
    rt.sage_run(make_request(rt.db, fn, seed=0))
    assert released == [] and rt.engines["f"]._shared_ctx.budget is rt.daemon
    rt.drain(timeout=120.0)
    rt.shutdown()
    assert released == [rt.engines["f"]._shared_ctx]


def test_exit_ladder_releases_the_contexts_graph_at_stages_2_and_3(monkeypatch):
    """The ladder lets the context drop its CUDA graph as the weights leave
    the card (stage 2: the graph is keyed on their addresses) and again as
    the context's memory goes (stage 3)."""
    released = []
    monkeypatch.setattr(functions.ModelContext, "release", lambda ctx: released.append(ctx))
    rt = _runtime(exit_ttl=10.0)
    fn = make_model_function(rt.db, "f", arch="qwen2.5-3b")
    rt.register_function(fn)
    rt.sage_run(make_request(rt.db, fn, seed=0))
    eng = rt.engines["f"]
    t0, ctx = eng.instances[0].ladder.completion_t, eng._shared_ctx
    seen = []
    for dt in (15.0, 25.0):  # the middle of stages 2 and 3
        eng.clock = FakeClock(t0 + dt)
        eng._advance_ladders()
        seen.append(list(released))
    rt.shutdown()
    assert seen == [[ctx], [ctx, ctx]]


class _StubGraph:
    """A captured forward's stand-in on the CPU: a replay doubles the
    static tokens into the static logits."""

    def __init__(self, tokens, logits):
        self.tokens, self.logits = tokens, logits

    def replay(self):
        self.logits.copy_(self.tokens * 2)


class _Budget:
    """A memory daemon's context admission over ``free`` bytes."""

    def __init__(self, free):
        self.free = free

    def try_reserve_context(self, nbytes):
        granted = nbytes <= self.free
        self.free -= nbytes if granted else 0
        return granted

    def release_context(self, nbytes):
        self.free += nbytes


def test_context_keeps_a_graph_only_where_its_budget_grants_the_pool(monkeypatch):
    """``ModelContext``'s graph bookkeeping, with the capture stubbed (the
    CPU cannot capture): the first call of a key is eager and the second
    captures, if the budget grants the pool at once; a refused key stays
    eager without capturing again until ``release``; another key gives the
    pool back; a release made during a capture leaves the call eager and
    the bytes returned; each replay counts the captured K1 calls."""
    pool, name = 100, "stubbed-graph"
    captures = []

    def capture(ctx, key, p, t):
        captures.append(key)
        tokens, logits = torch.empty_like(t), torch.empty_like(t)
        g = functions._Graph(key, _StubGraph(tokens, logits), tokens, logits, {fa.NAME: 3},
                             pool)
        if key == "released meanwhile":
            ctx.release()
        return g

    monkeypatch.setattr(functions.ModelContext, "_capture", capture)
    ctx = functions.ModelContext(None, 0.0, {}, 7, name=name)
    budget = _Budget(150)
    ctx.bind(budget)
    t = torch.arange(4.0)
    counts = lambda: (functions.graph_captures[name], functions.graph_replays[name])  # noqa: E731
    k1 = fa.launches

    def call(key):
        out = ctx._replayed(key, None, t)
        assert out is None or torch.equal(out, t * 2)
        return out is not None

    assert [call("a") for _ in range(3)] == [False, True, True]
    assert counts() == (1, 1) and fa.launches - k1 == 6
    assert budget.free == 50 and ctx.reserved_bytes == 7 + pool
    assert not call("b")  # the weights moved: the pool goes back
    assert budget.free == 150 and ctx.reserved_bytes == 7
    budget.free = 50
    assert [call("b") for _ in range(3)] == [False] * 3
    assert captures == ["a", "b"] and budget.free == 50 and ctx.reserved_bytes == 7
    ctx.release()
    budget.free = 150
    assert [call("b") for _ in range(3)] == [False, True, True]
    assert counts() == (2, 2) and captures == ["a", "b", "b"]
    ctx.release()
    assert budget.free == 150 and ctx.reserved_bytes == 7
    assert [call("released meanwhile") for _ in range(3)] == [False, False, False]
    assert budget.free == 150 and ctx.reserved_bytes == 7 and counts() == (2, 2)


def test_fixedgsl_never_shares():
    rt = _runtime("fixedgsl")
    fn = make_model_function(rt.db, "f", arch="qwen2.5-3b")
    rt.register_function(fn)
    futs = [rt.submit(make_request(rt.db, fn, seed=i)) for i in range(3)]
    for f in futs:
        f.result(timeout=120)
    assert rt.daemon.stats["shared_hits"] == 0
    rt.shutdown()


def test_warm_stage_recorded():
    rt = _runtime(exit_ttl=5.0)
    # on the CPU the context build is ~free (no kernel to build), so the
    # cold request's extra cost is the declared weight load: 8 GiB makes it
    # ~140 ms of modelled transfer at time_scale=0.02, well above the tens
    # of ms a CPU forward can jitter by when test workers share the cores
    fn = make_model_function(rt.db, "f", arch="qwen2.5-3b",
                             declared_ro_bytes=8 << 30)
    rt.register_function(fn)
    rt.sage_run(make_request(rt.db, fn, seed=0))
    rt.sage_run(make_request(rt.db, fn, seed=1))
    recs = rt.telemetry.records
    assert recs[0].warm_stage is None      # cold
    assert recs[1].warm_stage == 1         # stage-1 warm hit
    assert recs[1].e2e < recs[0].e2e
    rt.shutdown()


# ---------------------------------------------------------------------------
# the multi-stage exit ladder (tests/test_core.py's TestExitLadder and
# tests/test_runtime.py's ladder case, on the port)
# ---------------------------------------------------------------------------

class FakeClock:
    """The engine's clock pinned at ``t``; its sleeps do not wait."""

    def __init__(self, t):
        self.t = t

    def now(self):
        return self.t

    def sleep(self, dt):
        pass


class TestExitLadder:
    def test_stage_progression(self):
        from repro_torch.core.exit_policy import ExitLadder

        lad = ExitLadder(ttls=(1.0, 1.0, 1.0, 1.0))
        lad.on_complete(100.0)
        assert lad.stage_at(100.5) == 1
        assert lad.stage_at(101.5) == 2
        assert lad.stage_at(102.5) == 3
        assert lad.stage_at(103.5) == 4
        assert lad.stage_at(104.5) == 5

    def test_actions_fire_once_in_order(self):
        from repro_torch.core.exit_policy import ExitLadder

        fired = []
        lad = ExitLadder(ttls=(1.0,) * 4)
        lad.on_enter = {k: (lambda k=k: fired.append(k)) for k in (2, 3, 4)}
        lad.on_complete(0.0)
        lad.advance(1.5)
        assert fired == [2]
        lad.advance(3.5)  # skipped ahead two stages -> both fire, in order
        assert fired == [2, 3, 4]
        lad.advance(3.6)
        assert fired == [2, 3, 4]  # idempotent

    def test_reuse_stops_exit_and_reports_stage(self):
        from repro_torch.core.exit_policy import ExitLadder

        lad = ExitLadder(ttls=(1.0,) * 4)
        lad.on_complete(0.0)
        s = lad.on_reuse(1.5)
        assert s == 2
        assert lad.stage_at(99.0) == 0  # running again

    def test_warmer_stage_skips_more(self):
        from repro.core.exit_policy import stage_skips as ref_skips
        from repro_torch.core.exit_policy import stage_skips

        assert stage_skips == ref_skips
        assert len(stage_skips[1]) > len(stage_skips[2]) > len(stage_skips[3]) \
            > len(stage_skips[4])
        assert "gpu_data" in stage_skips[1] and "gpu_data" not in stage_skips[2]
        assert "gpu_ctx" in stage_skips[2] and "gpu_ctx" not in stage_skips[3]


def _ladder_usage(rt, make_fn, make_req, profile):
    """tests/test_runtime.py's ladder walk: one cold request, then the
    engine's clock at the middle of stages 2 and 3 and past stage 5;
    returns memory_usage() hot and at each of the three."""
    fn = make_fn(rt.db, "f", arch="qwen2.5-3b", profile=profile)
    rt.register_function(fn)
    rt.sage_run(make_req(rt.db, fn, seed=0))
    eng = rt.engines["f"]
    t0 = eng.instances[0].ladder.completion_t
    usage = [rt.memory_usage()]
    for dt in (15.0, 25.0, 45.0):
        eng.clock = FakeClock(t0 + dt)
        eng._advance_ladders()
        usage.append(rt.memory_usage())
    rt.shutdown()
    return usage


def test_multi_stage_exit_frees_memory_over_time():
    """The ladder demotes and frees as the JAX runtime's does, byte for
    byte: read-only weights to the host at stage 2, the context at stage
    3, everything past stage 5."""
    from repro.core.profiles import PROFILES as REF_PROFILES
    from repro_torch.core.profiles import PROFILES

    ref_rt = RefRuntime("sage", time_scale=0.02, exit_ttl=10.0)
    ref_rt.sage_init()
    want = _ladder_usage(ref_rt, ref_make_fn, ref_make_request, REF_PROFILES["resnet50"])
    got = _ladder_usage(_runtime(exit_ttl=10.0), make_model_function, make_request,
                        PROFILES["resnet50"])
    assert got == want
    hot, stage2, stage3, gone = got
    assert stage2["device_used"] < hot["device_used"]
    assert stage3["device_used"] < stage2["device_used"]
    assert stage3["host_used"] > 0  # RO parked in host RAM
    assert gone["device_used"] <= stage3["device_used"]


def test_demoted_entry_holds_no_device_tensor():
    """Stage 2 drops the daemon's device copy of the weights, and nothing
    else of the port (the executor, the shim, the telemetry, the context
    closure) keeps it alive. The CPU stands in for the card: the database's
    host -> device leg clones, so the 'device' copy is an object of its own."""
    import gc
    import weakref

    rt = _runtime(exit_ttl=10.0)
    rt.db.to_device = lambda obj: torch.utils._pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, obj)
    fn = make_model_function(rt.db, "f", arch="qwen2.5-3b")
    rt.register_function(fn)
    rt.sage_run(make_request(rt.db, fn, seed=0))
    entry = next(e for e in rt.daemon.function_entries("f") if e.read_only)
    leaves = torch.utils._pytree.tree_leaves
    host_leaf = leaves(entry.host_obj)[0]
    dev_leaf = weakref.ref(leaves(entry.dev_obj)[0])
    assert dev_leaf() is not None and dev_leaf() is not host_leaf
    eng = rt.engines["f"]
    eng.clock = FakeClock(eng.instances[0].ladder.completion_t + 15.0)  # mid stage 2
    eng._advance_ladders()
    gc.collect()
    assert entry.dev_obj is None and entry.host_obj is not None
    assert dev_leaf() is None, gc.get_referrers(dev_leaf())
    rt.shutdown()
