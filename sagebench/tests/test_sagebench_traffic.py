"""The seeded generators repeat exactly, and the metrics are taken over
every invocation of a window."""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from harness import manifest, readers, stats, traffic, weights  # noqa: E402

BIG = 2**31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_schedules_prompts_and_weights_repeat(seed):
    assert traffic.open_schedule(9.5, 30, seed) == traffic.open_schedule(9.5, 30, seed)
    assert traffic.prompt_order(8, seed) == traffic.prompt_order(8, seed)
    mix = {"batch": 2, "seq": 16, "prompts": 3}
    a, b = traffic.prompts(mix, 100, seed, "cpu"), traffic.prompts(mix, 100, seed, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.int32 and int(a.max()) < 100
    layout = manifest.reference("mamba2-780m").layout(
        dict(manifest.config("mamba2-780m")["model"], num_layers=1, d_model=32, vocab_size=50,
             ssm_state=16, ssm_headdim=16))
    w1, w2 = weights.make(layout, seed, "cpu"), weights.make(layout, seed, "cpu")
    for path, shape, dtype, _ in layout:
        x, y = w1, w2
        for k in path:
            x, y = x[k], y[k]
        assert x.shape == shape and x.dtype == weights.DTYPES[dtype] and torch.equal(x, y)


def test_seeds_differ_only_in_order():
    a, b = traffic.open_schedule(10.0, 30, 1), traffic.open_schedule(10.0, 30, 2)
    assert len(a) == len(b) == 300 and a != b
    assert a[0] == 0.0 and max(a) < 30

    def gaps(due):  # every gap, the last one to the window's end included
        return sorted([y - x for x, y in zip(due, due[1:])] + [30.0 - due[-1]])

    assert gaps(a) == pytest.approx(gaps(b), abs=1e-9)
    assert traffic.prompt_order(8, 1) != traffic.prompt_order(8, 2)


def test_weight_rules():
    layout = [(("a",), (1000,), "float32", ("log_uniform_a", 1.0, 16.0)),
              (("b",), (1000,), "float32", ("dt_bias", 1e-3, 1e-1)),
              (("c",), (1000,), "bfloat16", ("near_one", 0.1))]
    w = weights.make(layout, 3, "cpu")
    A = torch.exp(w["a"])
    assert float(A.min()) >= 1.0 and float(A.max()) <= 16.0
    dt = torch.nn.functional.softplus(w["b"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert float(w["c"].min()) >= 0.9 - 1e-2 and float(w["c"].max()) <= 1.1 + 1e-2


def _ctx(lat, seconds=10.0, failed=()):
    invs = []
    for i, x in enumerate(lat):
        bad = i in failed
        invs.append({"index": i, "due": float(i) / 10, "sent": float(i) / 10,
                     "done": None if bad else float(i) / 10 + x, "failed": bad})
    return {"invocations": invs, "seconds": seconds, "flops_per_invocation": 1e12}


def test_tails_are_over_every_invocation_and_failures_miss():
    lat = [0.1] * 95 + [1.0] * 5
    ctx = _ctx(lat)
    assert manifest.reader("e2e_p50_ms").read(ctx) == pytest.approx(100.0)
    # the 95th percentile lies between the 95th and 96th of 100 sorted values
    assert manifest.reader("e2e_p95_ms").read(ctx) == pytest.approx(100.0 + 0.05 * 900.0)
    failed = _ctx([0.1] * 100, failed=set(range(6)))
    assert math.isinf(manifest.reader("e2e_p95_ms").read(failed))
    assert stats.quantile([3.0, 1.0, 2.0], 0.5) == 2.0


def test_rates_count_answers_inside_the_window_only():
    ctx = _ctx([0.05] * 100, seconds=9.99)  # the last answer comes at 9.95 s
    assert manifest.reader("invocations_per_s").read(ctx) == pytest.approx(100 / 9.99)
    late = _ctx([0.05] * 100, seconds=9.9)
    assert len(readers.completed_in_window(late)) == 99
    assert manifest.reader("mfu_pct.warm").read(late) == pytest.approx(
        100 * 99 * 1e12 / (9.9 * 989e12))


def test_cold_median_counts_answers_in_the_window_and_failures():
    ctx = _ctx([0.4, 0.5, 0.6, 9.0], seconds=5.0)
    assert manifest.reader("cold_e2e_ms").read(ctx) == pytest.approx(500.0)
    bad = _ctx([0.4, 0.5, 0.6], seconds=5.0, failed={0, 1})
    assert math.isinf(manifest.reader("cold_e2e_ms").read(bad))


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def test_function_order_follows_zipf_and_is_the_mix_s_alone():
    mix = {"functions": 4, "zipf_s": 1.0, "schedule_seed": 1001}
    order = traffic.function_order(mix)
    assert order == traffic.function_order(dict(mix)) and len(order) == traffic.ORDER_LEN
    share = [1.0, 1 / 2, 1 / 3, 1 / 4]
    for f in range(4):
        assert abs(order.count(f) - traffic.ORDER_LEN * share[f] / sum(share)) < 1
    assert order != traffic.function_order(dict(mix, schedule_seed=1002))
    assert traffic.function_order({"functions": 1}) == [0]
    flat = traffic.function_order({"functions": 8, "zipf_s": 0.0, "schedule_seed": 3})
    assert [flat.count(f) for f in range(8)] == [125] * 8


@pytest.mark.parametrize("bad", [{"functions": 0}, {"functions": 101}, {"zipf_s": -1.0},
                                 {"functions": 2, "fresh_node": True}])
def test_mixes_of_functions_out_of_range_are_refused(bad):
    mix = {"loop": "closed", "clients": 1, "batch": 1, "seq": 8, "prompts": 1, **bad}
    with pytest.raises(ValueError):
        traffic.validate(mix)


def test_each_function_draws_weights_of_its_own():
    layout = [(("a",), (64,), "bfloat16", ("uniform", 1.0))]
    w0, w1 = weights.make(layout, 9, "cpu"), weights.make(layout, 9, "cpu", function=1)
    assert not torch.equal(w0["a"], w1["a"])
    assert torch.equal(w1["a"], weights.make(layout, 9, "cpu", function=1)["a"])


def test_the_check_samples_every_function_before_a_second_pair():
    from harness import check

    few = [(f, p) for f in range(4) for p in range(8)]
    assert check.sample_pairs(few, 5) == sorted(few)
    many = [(f, p) for f in range(32) for p in range(8)]
    got = check.sample_pairs(many, 5)
    assert len(got) == check.MAX_PAIRS and {f for f, _ in got} == set(range(32))
    assert got == check.sample_pairs(many, 5) and got != check.sample_pairs(many, 6)


def test_a_metric_without_a_reader_of_its_own_takes_its_stem_s():
    assert manifest.reader("compute_ms.train").__file__.endswith("metrics/compute_ms.py")
    assert manifest.reader("queue_ms.warm").__file__.endswith("metrics/queue_ms.warm.py")


def _before(rate, seconds, seed):
    """The open schedule as the generator drew it before bursts were added."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)])
    gaps = gaps[traffic.rng(seed, 1).permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return list(due * (seconds / gaps.sum()))


@pytest.mark.parametrize("name", sorted(p.stem for p in (HERE / "traffic").glob("*.json")))
def test_the_committed_mixes_give_the_schedules_they_gave(name):
    mix = traffic.validate(manifest.mix(name))
    assert "burst" not in mix and "compute" not in mix
    if mix["loop"] == "open":
        got = traffic.open_schedule(float(mix["rate_per_s"]), 51, int(mix["schedule_seed"]),
                                    mix.get("burst"))
        assert got == _before(float(mix["rate_per_s"]), 51, int(mix["schedule_seed"]))


@pytest.mark.parametrize("seconds,on_s,period_s", [(51, 5.1, 51), (51, 1.0, 10.0),
                                                   (30, 2.0, 7.0), (20, 5.0, 5.0)])
def test_bursts_fall_in_their_on_windows_at_the_mix_s_rate(seconds, on_s, period_s):
    rate = 18.0
    due = traffic.open_schedule(rate, seconds, 1001, {"on_s": on_s, "period_s": period_s})
    whole = math.floor(seconds / period_s)
    on = whole * on_s + min(on_s, seconds - whole * period_s)
    assert len(due) == round(rate * on)
    assert due == sorted(due) and 0 <= due[0] and due[-1] < seconds
    for t in due:  # every arrival inside the first on_s of its period
        assert t - math.floor(t / period_s) * period_s <= on_s + 1e-9, t
    assert len(due) / on == pytest.approx(rate, rel=0.02)
    # the same gaps as an unbroken schedule of the on-windows laid end to end
    assert due == traffic.open_schedule(rate, seconds, 1001,
                                        {"on_s": on_s, "period_s": period_s})
    if on_s == period_s:
        assert due == pytest.approx(traffic.open_schedule(rate, seconds, 1001))


@pytest.mark.parametrize("bad", [{"burst": {"on_s": 2.0}},
                                 {"burst": {"on_s": 3.0, "period_s": 2.0}},
                                 {"burst": {"on_s": 0.0, "period_s": 2.0}},
                                 {"loop": "closed", "clients": 1,
                                  "burst": {"on_s": 1.0, "period_s": 2.0}},
                                 {"compute": "shared"}])
def test_bursts_and_compute_planes_out_of_form_are_refused(bad):
    mix = {"loop": "open", "rate_per_s": 9.0, "schedule_seed": 1, "batch": 1, "seq": 8,
           "prompts": 1, **bad}
    with pytest.raises(ValueError):
        traffic.validate(mix)


def test_the_mix_s_compute_plane_reaches_the_node():
    from harness import runner

    compute = {"mode": "shared", "max_batch": 4}
    mix = traffic.validate({"loop": "open", "rate_per_s": 20.0, "schedule_seed": 1,
                            "batch": 2, "seq": 16, "prompts": 1, "compute": compute,
                            "burst": {"on_s": 0.1, "period_s": 0.2}})
    m = dict(manifest.config("mamba2-780m")["model"], **manifest.config("mamba2-780m")["small"])
    ref = manifest.reference("mamba2-780m")
    prog = runner.Program(m, [weights.make(ref.layout(m), 1, "cpu")], 2, 16, "cpu",
                          compute=mix["compute"])
    rt = prog.node()
    try:
        assert rt.compute_stats()["mode"] == "shared"
        assert rt._compute.max_batch == 4
    finally:
        rt.shutdown()
    plain = runner.Program(m, [weights.make(ref.layout(m), 1, "cpu")], 2, 16, "cpu").node()
    try:
        assert plain.compute_stats()["mode"] == "exclusive"
    finally:
        plain.shutdown()
