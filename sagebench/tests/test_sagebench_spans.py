"""``tools/spans.py``: the program's spans and copy counters kept over a
run, put on the window's clock, and the arithmetic of its readings."""
import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

import spans as tool  # noqa: E402
from harness import manifest, runner, trace  # noqa: E402

TINY = dict(num_layers=2, d_model=64, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
            vocab_size=96)
OPEN = {"loop": "open", "rate_per_s": 20.0, "schedule_seed": 1, "batch": 4, "seq": 32,
        "prompts": 3, "warm_invocations": 1}
COLD = {"loop": "closed", "clients": 1, "fresh_node": True, "batch": 4, "seq": 32,
        "prompts": 3}


def test_intervals_merge_and_their_gaps():
    assert tool.merged([(3, 4), (0, 1), (0.5, 2), (4, 5)]) == [(0, 2), (3, 5)]
    assert tool.gaps([(1, 2), (1.5, 3), (5, 12)], 0, 10) == [(0, 1), (3, 5)]
    assert tool.gaps([], 0, 2) == [(0, 2)]
    got = tool.covered_before([(0, 1), (2, 4)], [0, 0.5, 1.5, 3, 9])
    assert got.tolist() == [0, 0.5, 1, 2, 3]
    assert tool.covered_before([], [1.0]).tolist() == [0.0]


def test_idle_goes_to_the_innermost_open_span():
    idle = [(0, 1), (2, 4), (6, 10)]
    spans = [("lock_wait", 0.5, 2.5), ("forward", 2.5, 3.0), ("data_wait", 2.8, 3.5),
             ("forward", 11, 12)]  # outside the window: ignored
    by = tool.idle_by_span(idle, spans, [(0.5, 5)], 10.0)
    want = {"no_invocation": 4.5, "lock_wait": 1.0, "data_wait": 0.7, tool.IN_FLIGHT: 0.5,
            "forward": 0.3}
    assert by.keys() == want.keys()
    for k, v in want.items():
        assert by[k] == pytest.approx(v), k
    assert sum(by.values()) == pytest.approx(7.0)
    # two invocations' spans overlapping: the later to start takes the idle,
    # but a wait for the lock only where nothing else is open
    by = tool.idle_by_span([(0, 4)], [("forward", 0, 2), ("data_wait", 1, 1.5),
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
    kept.db = SimpleNamespace(h2d_bytes=3_000_000_000, h2d_s=1.5)
    kept.h2d0 = (1_000_000_000, 0.5)
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
        {"no_invocation": 2.0, "ctx_build": 0.3, tool.IN_FLIGHT: 0.6, "data_wait": 0.1})
    assert got["inflight_idle_pct"] == pytest.approx(100 * 1.0 / 5.0)


def test_a_program_without_spans_reads_nothing():
    ctx, invs, kept = _kept_run()
    kept.records = {k: (rec, None) for k, (rec, _) in kept.records.items()}
    kept.db = SimpleNamespace()
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
    # the hooks are off again
    assert runner.Program.keep_records.__name__ == "keep_records"
    assert runner.setup.__name__ == "setup" and trace.summarize.__name__ == "summarize"


def test_a_span_costs_little_on_the_host():
    cost = tool.span_cost(2000)
    assert 0 < cost["ns_per_span"] and 0 < cost["ns_outside_an_invocation"]
