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
from repro_torch.core import SageRuntime  # noqa: E402
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
    """Graceful retire (the crash path's exact release, nothing in flight)."""
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
    ref_rt = RefRuntime("sage", time_scale=0.02, exit_ttl=5.0)
    ref_rt.sage_init()
    want = _cold_warm_warm(ref_rt, ref_make_fn, ref_make_request, arch)
    jax_weights = ref_rt.db.fetch("f/weights")
    weights = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_weights), "cpu")
    got = _cold_warm_warm(_runtime(exit_ttl=5.0), make_model_function, make_request, arch,
                          weights=weights)
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
