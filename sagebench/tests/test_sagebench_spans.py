"""The program's spans and counters kept over a run and put on the window's
clock, by the runner (``harness/spans.py`` and the metrics that read them)
and by ``tools/spans.py``, and the arithmetic of their readings."""
import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

import spans as tool  # noqa: E402
from harness import manifest, runner, spans, trace  # noqa: E402

TINY = dict(num_layers=2, d_model=64, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
            vocab_size=96)
OPEN = {"loop": "open", "rate_per_s": 20.0, "schedule_seed": 1, "batch": 4, "seq": 32,
        "prompts": 3, "warm_invocations": 1}
COLD = {"loop": "closed", "clients": 1, "fresh_node": True, "batch": 4, "seq": 32,
        "prompts": 3}


def test_intervals_merge_and_their_gaps():
    assert spans.merged([(3, 4), (0, 1), (0.5, 2), (4, 5)]) == [(0, 2), (3, 5)]
    assert spans.gaps([(1, 2), (1.5, 3), (5, 12)], 0, 10) == [(0, 1), (3, 5)]
    assert spans.gaps([], 0, 2) == [(0, 2)]
    got = spans.covered_before([(0, 1), (2, 4)], [0, 0.5, 1.5, 3, 9])
    assert got.tolist() == [0, 0.5, 1, 2, 3]
    assert spans.covered_before([], [1.0]).tolist() == [0.0]


def test_idle_goes_to_the_innermost_open_span():
    idle = [(0, 1), (2, 4), (6, 10)]
    own = [("lock_wait", 0.5, 2.5), ("forward", 2.5, 3.0), ("data_wait", 2.8, 3.5),
           ("forward", 11, 12)]  # outside the window: ignored
    by = spans.idle_by_span(idle, own, [(0.5, 5)], 10.0)
    want = {"no_invocation": 4.5, "lock_wait": 1.0, "data_wait": 0.7, spans.IN_FLIGHT: 0.5,
            "forward": 0.3}
    assert by.keys() == want.keys()
    for k, v in want.items():
        assert by[k] == pytest.approx(v), k
    assert sum(by.values()) == pytest.approx(7.0)
    # two invocations' spans overlapping: the later to start takes the idle,
    # but a wait for the lock only where nothing else is open
    by = spans.idle_by_span([(0, 4)], [("forward", 0, 2), ("data_wait", 1, 1.5),
                                       ("lock_wait", 0.5, 3)], [(0, 3)], 4.0)
    assert by == pytest.approx({"forward": 1.5, "data_wait": 0.5, "lock_wait": 1.0,
                                "no_invocation": 1.0})


def _kept_run():
    """A hand-made run of two invocations on the window's clock (the host's
    window start at 100 s), the card idle [0, 1] and [2, 4] of 5 s."""
    def rec(arrival, warm):
        return SimpleNamespace(arrival_t=100 + arrival, warm_stage=warm)

    kept = tool.Kept()
    kept.records = {
        "a": (rec(0.5, None), [("ctx_build", 100.6, 100.9), ("data_wait", 100.9, 101.2),
                               ("lock_wait", 101.2, 101.3), ("forward", 101.3, 101.5)]),
        "b": (rec(1.0, 1), [("lock_wait", 101.1, 101.6), ("forward", 101.6, 101.8)]),
    }
    kept.counters0 = {"h2d_bytes": 1_000_000_000, "h2d_s": 0.5}
    kept.counters1 = {"h2d_bytes": 3_000_000_000, "h2d_s": 1.5}
    kept.idle = ([(0, 1), (2, 4)], 5.0)
    invs = [SimpleNamespace(uuid="a"), SimpleNamespace(uuid="b"), SimpleNamespace(uuid="c")]
    seen = [{"arrival": 0.5, "end": 1.6}, {"arrival": 1.0, "end": 2.5}, {"failed": True}]
    return {"seconds": 5.0, "invocations": seen}, invs, kept


def test_readings_of_a_hand_made_run():
    ctx, invs, kept = _kept_run()
    got = tool.readings(ctx, invs, kept)
    assert got["invocations_with_spans"] == 2 and got["spans_per_invocation"] == 3
    assert got["ctx_builds"] == 1 and got["warm_stage_none"] == 1
    assert got["lock_wait_ms"] == pytest.approx((0.1 + 0.5) / 2 * 1e3)
    assert got["issue_ms"] == pytest.approx(0.2e3)
    assert got["h2d_gbps"] == pytest.approx(2.0) and got["h2d_bytes"] == 2_000_000_000
    # idle [0, 0.5] before any arrival; [0.5, 0.6] in flight; [0.6, 0.9]
    # ctx_build; [0.9, 1] data_wait; [2, 2.5] in flight; [2.5, 4] none
    assert got["idle_by_span"] == pytest.approx(
        {"no_invocation": 2.0, "ctx_build": 0.3, spans.IN_FLIGHT: 0.6, "data_wait": 0.1})
    assert got["inflight_idle_pct"] == pytest.approx(100 * 1.0 / 5.0)


def test_a_program_without_spans_reads_nothing():
    ctx, invs, kept = _kept_run()
    kept.records = {k: (rec, None) for k, (rec, _) in kept.records.items()}
    kept.counters0 = kept.counters1 = {}
    got = tool.readings(ctx, invs, kept)
    assert got["lock_wait_ms"] is None and got["issue_ms"] is None
    assert got["h2d_gbps"] is None and got["idle_by_span"] is None


@pytest.mark.parametrize("mix", [OPEN, COLD], ids=["open", "fresh_nodes"])
def test_a_run_keeps_every_invocation_s_spans(mix):
    doc = copy.deepcopy(manifest.config("mamba2-780m"))
    doc["model"].update(TINY)
    got = tool.collect(doc, mix, seed=5, seconds=0.4, trace=False, device="cpu",
                       reference=manifest.reference("mamba2-780m"))
    r, ctx = got["readings"], got["context"]
    assert r["invocations_with_spans"] == len(ctx["invocations"]) > 0
    assert r["issue_ms"] > 0 and r["lock_wait_ms"] >= 0 and r["h2d_gbps"] > 0
    assert r["idle_by_span"] is None  # untraced
    if mix is COLD:  # every invocation on a new node builds its context
        assert r["ctx_builds"] == r["invocations_with_spans"] == r["warm_stage_none"]
    # what the tool kept reads as what the runner kept, on the same run
    for name in ("lock_wait_ms", "issue_ms", "h2d_gbps"):
        assert manifest.reader(name).read(ctx) == pytest.approx(r[name], rel=1e-9), name
    # the hooks are off again
    assert runner.Program.keep_records.__name__ == "keep_records"
    assert runner.setup.__name__ == "setup" and trace.summarize.__name__ == "summarize"


@pytest.mark.parametrize("mix", [OPEN, COLD], ids=["open", "fresh_nodes"])
def test_the_runner_keeps_every_invocation_s_spans_and_the_counters(mix):
    doc = copy.deepcopy(manifest.config("mamba2-780m"))
    doc["model"].update(TINY)
    ctx = runner.run_cell(doc, mix, seed=6, seconds=0.4, trace=False, device="cpu",
                          log=lambda obj: None,
                          reference=manifest.reference("mamba2-780m"))["context"]
    invs = ctx["invocations"]
    assert invs and all("spans" in v for v in invs)
    for v in invs:
        names = [n for n, _, _ in v["spans"]]
        assert "forward" in names and "lock_wait" in names
        for _, a, b in v["spans"]:  # on the window's clock, inside the invocation
            assert v["arrival"] <= a <= b <= v["end"] + 1e-9
        if mix is COLD:  # a fresh node's spans survive its retirement
            assert "ctx_build" in names
    c = ctx["counters"]
    assert c["h2d_bytes"] > 0 and c["h2d_s"] > 0
    # the CPU never replays or captures a graph nor counts an eager forward
    assert {k: c[k] for k in spans.FORWARDS} == dict.fromkeys(spans.FORWARDS, 0)
    assert manifest.reader("graph_replay_pct.warm").read(ctx) is None
    assert manifest.reader("issue_ms.warm").read(ctx) > 0
    assert manifest.reader("h2d_gbps.cold").read(ctx) > 0


def _context():
    """A hand-made context of two invocations on the window's clock (and a
    third with no record), the card idle [0, 1] and [2, 4] of 5 s."""
    invs = [
        {"arrival": 0.5, "end": 1.6, "spans": [
            ("ctx_build", 0.6, 0.9), ("data_wait", 0.9, 1.2), ("lock_wait", 1.2, 1.3),
            ("forward", 1.3, 1.5)]},
        {"arrival": 1.0, "end": 2.5, "spans": [("lock_wait", 1.1, 1.6), ("forward", 1.6, 1.8)]},
        {"failed": True},
    ]
    return {"seconds": 5.0, "invocations": invs,
            "counters": {"h2d_bytes": 2_000_000_000, "h2d_s": 1.0, "graph_replays": 457,
                         "graph_captures": 2, "eager_forwards": 0},
            "trace": {"window_s": 5.0, "busy_s": 2.0, "idle": [(0, 1), (2, 4)]}}


NEW = ["lock_wait_ms.warm", "issue_ms.warm", "issue_ms.saturate", "h2d_gbps.cold",
       "inflight_idle_pct.warm", "graph_replay_pct.warm", "graph_replay_pct.saturate"]


def test_the_program_s_readers_on_a_hand_made_context():
    ctx = _context()
    want = {"lock_wait_ms": (0.1 + 0.5) / 2 * 1e3, "issue_ms": 0.2e3, "h2d_gbps": 2.0,
            "inflight_idle_pct": 100 * 1.0 / 5.0, "graph_replay_pct": 100 * 457 / 459}
    for name in NEW:
        got = manifest.reader(name).read(ctx)
        assert got == pytest.approx(want[name.split(".")[0]]), name
    assert spans.idle_by_span_of(ctx) == pytest.approx(
        {"no_invocation": 2.0, "ctx_build": 0.3, spans.IN_FLIGHT: 0.6, "data_wait": 0.1})


@pytest.mark.parametrize("missing", ["spans", "counters", "trace", "all"])
def test_the_program_s_readers_read_nothing_where_there_is_nothing(missing):
    ctx = _context()
    if missing in ("spans", "all"):
        for v in ctx["invocations"]:
            v.pop("spans", None)
    if missing in ("counters", "all"):
        ctx["counters"] = {}
    if missing in ("trace", "all"):
        ctx["trace"] = None
    reads = {name: manifest.reader(name).read(ctx) for name in NEW}
    stem = {"spans": ("lock_wait_ms", "issue_ms", "inflight_idle_pct"),
            "counters": ("h2d_gbps", "graph_replay_pct"),
            "trace": ("inflight_idle_pct",)}
    for name, value in reads.items():
        gone = missing == "all" or name.split(".")[0] in stem[missing]
        assert (value is None) == gone, (missing, name, value)
    # forwards counted but none made, or copies without seconds: nothing to read
    ctx = _context()
    ctx["counters"].update(graph_replays=0, graph_captures=0, h2d_s=0.0)
    assert spans.graph_replay_pct(ctx) is None and spans.h2d_gbps(ctx) is None


class _Event:
    def __init__(self, name, start_s, end_s, card):
        self._name, self._s, self._t = name, int(start_s * 1e9), int(end_s * 1e9)
        self._card = card

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t - self._s

    def device_type(self):
        return "DeviceType.CUDA" if self._card else "DeviceType.CPU"

    def is_user_annotation(self):
        return False


def test_the_trace_s_idle_intervals_are_on_the_window_s_clock():
    """The window opens 100 s into the trace and lasts 10 s; the card runs
    [101, 102], [101.5, 103] and [105, 112] (clipped to the window's end)."""
    events = [_Event(trace.WINDOW, 100, 110, False), _Event("host_op", 103, 106, False),
              _Event("k_a", 101, 102, True), _Event("k_b", 101.5, 103, True),
              _Event("k_a", 105, 112, True), _Event("k_c", 90, 95, True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    got = trace.summarize(prof)
    assert got["window_s"] == pytest.approx(10.0) and got["busy_s"] == pytest.approx(7.0)
    assert got["idle"] == pytest.approx([(0.0, 1.0), (3.0, 5.0)])
    assert got["kernels"]["k_a"] == {"seconds": pytest.approx(6.0), "count": 2}
    assert dict(got["idle_gaps"]) == pytest.approx({"host: none": 1.0, "host_op": 2.0})


def test_a_span_costs_little_on_the_host():
    cost = tool.span_cost(2000)
    assert 0 < cost["ns_per_span"] and 0 < cost["ns_outside_an_invocation"]
