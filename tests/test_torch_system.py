"""The port's counterpart of tests/test_system.py's cold-latency test, and
its GPU context build.

The reference's context build is a real AOT compile at the request's
shapes (``jax.jit(fwd).lower(...).compile()``, 0.37-0.56 s on a CPU), and
its test asks SAGE's cold e2e to be under 0.9 x FixedGSL's. The port's
build is a warm-up forward of one period of layers on zero weights at the
request's shapes (``core.functions.warm_up``). On the CPU that takes 3 ms
to 0.2 s (the first forward on a thread pays the most), too little against
the reference scenario's 1.2 s modelled load for the 0.9 to hold honestly,
so here the test asserts the mechanism: the build does real work that
reads no weights, SAGE's cold e2e is shorter than its stages paid in
series by most of min(gpu_ctx, gpu_data), and FixedGSL's is not shorter
than its stages' sum. The 0.9 itself is measured on the card
(``chip_smoke.py``'s ``cold_setup``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import FunctionSpec, Gateway  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import functions  # noqa: E402
from repro_torch.core.functions import ModelContext, make_model_function, warmup_config  # noqa: E402
from repro_torch.data.database import Database  # noqa: E402
from repro_torch.models import forward  # noqa: E402

SERIAL = ("container_create", "cpu_ctx", "gpu_ctx", "gpu_data", "compute")
# the modelled load's spread from run to run on a shared CPU (up to 12 ms
# seen between runs), with margin: the slack of the overlap's bound
LOAD_JITTER_S = 0.03


def test_context_build_is_a_warm_up_that_reads_no_weights(monkeypatch):
    """The context build runs a forward of one period of layers at the request's
    shapes, from ``cfg`` alone: with every database read refused it still
    builds, and the context it returns computes the forward."""
    db = Database(device="cpu")
    fn = make_model_function(db, "f", arch="qwen2.5-3b", batch=2, seq=8, seed=0)
    cfg = ARCHS["qwen2.5-3b"].reduced()
    assert warmup_config(cfg).num_layers == cfg.period_len < cfg.num_layers
    weights = db.fetch("f/weights")

    def refused(*a, **k):
        raise AssertionError("the context build read the database")

    monkeypatch.setattr(Database, "fetch", refused)
    monkeypatch.setattr(Database, "to_device", refused)
    before = functions.context_builds["f"]
    ctx = fn.context_builder()
    monkeypatch.undo()
    assert isinstance(ctx, ModelContext) and ctx.build_s > 0
    assert functions.context_builds["f"] == before + 1
    assert ctx.launches == {} and ctx.reserved_bytes == 0  # the CPU: plain versions, no card
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8),
                                                              dtype=np.int32))
    with torch.inference_mode():
        want = forward(cfg, weights, {"tokens": toks})[0]
    assert torch.equal(ctx(weights, toks), want)


def test_end_to_end_sage_overlaps_the_context_build_with_the_cold_load():
    """tests/test_system.py's scenario on the port (the reduced qwen2.5-3b,
    2 GiB declared, time_scale 1.0, one cold invoke under each policy), on
    the CPU: both contexts do work (gpu_ctx > 0); FixedGSL pays its stages
    in series (e2e >= their sum, less 1 ms); SAGE's cold e2e is shorter
    than its own stages with FixedGSL's serial load in place of its data
    wait by at least half of min(gpu_ctx, that load), less
    ``LOAD_JITTER_S``."""
    recs = {}
    for system in ("sage", "fixedgsl"):
        with Gateway(backend="runtime", policy=system, time_scale=1.0,
                     exit_ttl=30.0, device="cpu") as gw:
            gw.register(FunctionSpec(name="f", arch="qwen2.5-3b", read_only_bytes=2 << 30))
            recs[system] = gw.invoke("f", seed=0, input_bytes=1 << 20)
    sage, fixed = recs["sage"], recs["fixedgsl"]
    for r in (sage, fixed):
        assert r.error is None and r.warm_stage is None, r
        assert r.stages["gpu_ctx"] > 0, r.stages
    assert fixed.e2e >= sum(fixed.stages[k] for k in SERIAL) - 1e-3, fixed.stages
    load = fixed.stages["gpu_data"]  # FixedGSL waits for the whole load, after its context
    assert load > 1.0, fixed.stages
    ctx = sage.stages["gpu_ctx"]
    serial = sum(sage.stages[k] for k in SERIAL if k != "gpu_data") + load
    assert serial - sage.e2e >= 0.5 * min(ctx, load) - LOAD_JITTER_S, (sage.stages, load)
