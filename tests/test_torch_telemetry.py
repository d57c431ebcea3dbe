"""The spans of the threaded runtime's invocations (``core/telemetry.py``):
where each is taken, that they stay with their invocation across the
pool's threads, the stages read from them, and the database's copy
counters. CPU only; no JAX."""
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import functions  # noqa: E402
from repro_torch.core.engine import GPUFunction  # noqa: E402
from repro_torch.core.request import Data, DataType, Request  # noqa: E402
from repro_torch.core.runtime import SageRuntime  # noqa: E402
from repro_torch.core.telemetry import (  # noqa: E402
    Telemetry, current_spans, span, span_seconds,
)
from repro_torch.data.database import Database  # noqa: E402

MB = 1 << 20


def _names(spans):
    return [n for n, _, _ in spans]


def _runtime(**kw):
    rt = SageRuntime("sage", time_scale=0.0, device="cpu", **kw)
    rt.sage_init()
    return rt


def _launching(name, *, compute_s=0.0, **kw):
    """A ``GPUFunction`` whose handler launches one kernel on every datum
    of its request (the executor resolves the handles: ``data_wait``),
    then sleeps ``compute_s``."""
    def handler(shim, request):
        handles = [shim.sage_load_to_gpu(d.key) for d in request.in_data]
        shim.launch_kernel(lambda *xs: len(xs), *handles)
        time.sleep(compute_s)

    return GPUFunction(name=name, handler=handler, context_builder=lambda: object(),
                       context_bytes=MB, container_s=0.0, cpu_ctx_s=0.0, **kw)


def _request(db, fn_name, key, value):
    db.put(key, value, size=MB)
    req = Request(function_name=fn_name)
    req.in_data = [Data(key=key, size=MB, dtype=DataType.WRITABLE)]
    return req


def test_span_outside_an_invocation_records_nothing():
    tel = Telemetry()
    assert current_spans() is None
    with span("data_wait"):
        pass
    assert current_spans() is None and tel.spans_of("r") == []
    with tel.recording("r") as spans:
        assert current_spans() is spans
        with span("forward"):
            time.sleep(0.002)
        with pytest.raises(ValueError):
            with span("ctx_build"):
                raise ValueError("a failed build keeps its span")
    assert current_spans() is None
    got = tel.spans_of("r")
    assert _names(got) == ["forward", "ctx_build"]
    assert all(t0 <= t1 for _, t0, t1 in got) and got[0][2] - got[0][1] >= 0.002
    assert span_seconds(got, "forward") == got[0][2] - got[0][1]
    assert span_seconds(got, "forward", 1) == 0.0 and span_seconds(None, "forward") == 0.0
    got.clear()  # a copy: the store keeps its own
    assert len(tel.spans_of("r")) == 2


def test_lock_wait_is_its_own_span_and_compute_still_holds_it():
    rt = _runtime()
    rt.register_function(_launching("f"))
    try:
        rt.sage_run(_request(rt.db, "f", "in/0", torch.ones(4)))  # cold: builds
        with rt._compute_lock:
            req = _request(rt.db, "f", "in/1", torch.ones(4))
            fut = rt.submit(req)
            time.sleep(0.1)
        fut.result(timeout=10)
        spans = rt.telemetry.spans_of(req.uuid)
        rec = rt.telemetry.find(req.uuid)
        assert _names(spans) == ["lock_wait", "data_wait"]
        assert span_seconds(spans, "lock_wait") >= 0.05
        assert rec.stages["compute"] >= span_seconds(spans, "lock_wait")
        assert rec.stages["gpu_data"] == span_seconds(spans, "data_wait")
    finally:
        rt.shutdown()


def test_spans_stay_with_their_request_across_the_pool_threads():
    rt = _runtime()
    rt.register_function(_launching("f", compute_s=0.01))
    try:
        reqs = [_request(rt.db, "f", f"in/{i}", torch.ones(4)) for i in range(8)]
        for fut in [rt.submit(r) for r in reqs]:
            fut.result(timeout=30)
        waits = []
        for req in reqs:
            spans = rt.telemetry.spans_of(req.uuid)
            rec = rt.telemetry.find(req.uuid)
            assert _names(spans).count("lock_wait") == 1, spans
            assert _names(spans).count("data_wait") == 1, spans
            assert all(rec.start_t <= t0 <= t1 <= rec.end_t for _, t0, t1 in spans)
            waits.append(next(s for s in spans if s[0] == "lock_wait"))
        # one lock: the handlers' runs, each after its own wait, never overlap
        ends = sorted(t1 for _, _, t1 in waits)
        assert all(b - a >= 0.01 for a, b in zip(ends, ends[1:]))
        built = [r.uuid for r in reqs if "ctx_build" in _names(rt.telemetry.spans_of(r.uuid))]
        assert len(built) == 1
    finally:
        rt.shutdown()


class _SlowDatabase(Database):
    """A CPU database whose ``to_device`` of ``{"delay": s}`` takes ``s``."""

    def to_device(self, obj):
        if isinstance(obj, dict) and "delay" in obj:
            time.sleep(obj["delay"])
        return super().to_device(obj)


def test_gpu_data_holds_only_the_invocations_own_wait_under_the_shared_plane():
    """Two invocations in flight together under ``compute="shared"``: the
    slow one's load (0.3 s) ends while the fast one (load 0.02 s, then a
    0.5 s handler) is in its handler, yet each one's ``gpu_data`` is its
    own wait."""
    rt = _runtime(database=_SlowDatabase(device="cpu"), compute="shared")
    rt.register_function(_launching("f", compute_s=0.5))
    rt.register_function(_launching("g"))
    try:
        rt.sage_run(_request(rt.db, "f", "warm/f", {"delay": 0.0}))
        rt.sage_run(_request(rt.db, "g", "warm/g", {"delay": 0.0}))
        fast = _request(rt.db, "f", "in/fast", {"delay": 0.02})
        slow = _request(rt.db, "g", "in/slow", {"delay": 0.3})
        futs = [rt.submit(fast), rt.submit(slow)]
        for fut in futs:
            fut.result(timeout=30)
        f, s = rt.telemetry.find(fast.uuid), rt.telemetry.find(slow.uuid)
        assert 0.25 <= s.stages["gpu_data"] < 0.45
        assert 0.0 < f.stages["gpu_data"] < 0.2
        assert f.end_t > s.start_t + s.stages["gpu_data"]  # the slow wait ended inside
        for rec in (f, s):
            assert rec.stages["gpu_data"] == span_seconds(rt.telemetry.spans_of(rec.request_id),
                                                          "data_wait")
    finally:
        rt.shutdown()


class _Gate:
    """A stand-in for the node's compute lock that counts the handlers
    that reached it and holds them until ``open`` is set."""

    def __init__(self):
        self.reached = threading.Semaphore(0)
        self.open = threading.Event()
        self._lock = threading.Lock()

    def acquire(self):
        self.reached.release()
        self.open.wait(10)
        self._lock.acquire()

    def release(self):
        self._lock.release()


def test_a_concurrent_warm_has_no_warm_stage_and_no_ctx_build():
    """After one cold, two invocations of the function in flight together:
    one reads ``warm_stage`` None (the reference's own), neither built the
    context (no ``ctx_build`` span), and the function's context was built
    once. The cold alone has the span."""
    name = "cold_marker"
    rt = _runtime()
    fn = functions.make_model_function(rt.db, name, arch="qwen2.5-3b", seq=8)
    rt.register_function(fn)
    try:
        builds = functions.context_builds[name]
        cold = functions.make_request(rt.db, fn, seq=8, seed=0)
        rt.sage_run(cold)
        assert "ctx_build" in _names(rt.telemetry.spans_of(cold.uuid))
        gate = _Gate()
        rt._compute_lock = gate
        reqs = [functions.make_request(rt.db, fn, seq=8, seed=s) for s in (1, 2)]
        futs = [rt.submit(r) for r in reqs]
        for _ in reqs:
            assert gate.reached.acquire(timeout=10)
        gate.open.set()
        for fut in futs:
            fut.result(timeout=30)
        recs = [rt.telemetry.find(r.uuid) for r in reqs]
        assert sorted(r.warm_stage is None for r in recs) == [False, True]
        assert not any("ctx_build" in _names(rt.telemetry.spans_of(r.uuid)) for r in reqs)
        assert functions.context_builds[name] - builds == 1
    finally:
        rt.shutdown()


def test_database_counts_what_to_device_moved():
    db = Database(device="cpu")
    payload = {"w": torch.ones(10), "p": [torch.zeros(3, dtype=torch.int64), (7, 8)], "s": 2}
    assert (db.h2d_bytes, db.h2d_s) == (0, 0.0)
    db.to_device(payload)
    assert db.h2d_bytes == 40 + 24 and db.h2d_s > 0.0
    db.to_device({"none": 1})
    assert db.h2d_bytes == 64
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [db.to_device(payload) for _ in range(50)])
                   for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert db.h2d_bytes == 64 * (1 + 16 * 50)


def test_the_runtime_counts_each_load_on_its_database():
    rt = _runtime()
    rt.register_function(_launching("f"))
    try:
        for i in range(3):
            rt.sage_run(_request(rt.db, "f", f"in/{i}", torch.ones(8)))
        assert rt.db.h2d_bytes == 3 * 32
    finally:
        rt.shutdown()
