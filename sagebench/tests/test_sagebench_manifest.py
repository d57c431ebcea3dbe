"""The benchmark's manifest (``BENCHMARK.json``) against its contract, and
every file a cell finds by name."""
import json
import math
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from harness import counts, manifest, traffic  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "sagebench/run.py"]
    assert BENCH["paths"] == ["sagebench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_what_it_must():
    for cell in CELLS:
        e2e = [m["name"] for m in manifest.metrics_of(BENCH, cell, "end_to_end")]
        layer = manifest.metrics_of(BENCH, cell, "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert layer, cell
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])


def test_layer_metrics_name_their_cells_and_shares_their_names():
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        if m["unit"] == "%" and ("mfu" in m["name"] or "roofline" in m["name"]):
            assert m["better"] == "higher"
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_name_finds_its_files():
    for c in BENCH["configs"]:
        doc = manifest.config(c["name"])
        assert c["file"] == f"sagebench/configs/{c['name']}.json"
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
        assert hasattr(manifest.reference(c["name"]), "forward_last")
        assert doc["check"]["logit_gap"] > 0
    for w in BENCH["workloads"]:
        traffic.validate(manifest.mix(w["traffic"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]).read), m["name"]


CONFIGS = [c["name"] for c in BENCH["configs"]]
# what a cell may hold of a layer as one chip's share of it, or of the stack as one
# stage of a pipeline; every other published width is kept
CUTTABLE = {"num_layers", "num_experts", "num_heads", "num_kv_heads", "vocab_size"}


@pytest.mark.parametrize("name", CONFIGS)
def test_configurations_keep_published_widths(name):
    """The file's ``published`` gives each width the model-configs guide
    names, under the program's key, at its published value: the model
    holds it, unless ``reduced`` lists the key (a share or a cut in depth),
    and then it differs."""
    doc = manifest.config(name)
    m, published = doc["model"], doc["published"]
    assert published, name
    for k, v in published.items():
        if k in doc["reduced"]:
            assert k in CUTTABLE and m[k] != v, k
        else:
            assert m[k] == v, k
    assert m["param_dtype"] == m["compute_dtype"] == "bfloat16"


@pytest.mark.parametrize("name", CONFIGS)
def test_every_configuration_is_counted_layer_by_layer(name):
    m = manifest.config(name)["model"]
    kinds = counts.layer_kinds(m)
    assert len(kinds) == m["num_layers"]
    assert {mx for mx, _ in kinds} <= {"attn", "mamba"}
    assert {f for _, f in kinds} <= {"none", "dense", "moe"}
    flops = counts.model_flops(m, 4, 1024)
    parts = ("dense", "attention", "ssd", "unembed")
    assert flops["total"] == pytest.approx(sum(flops[k] for k in parts), rel=1e-12)
    assert flops["dense"] > 0 and flops["unembed"] > 0
    assert (flops["attention"] > 0) == ("attn" in counts.mixers(m))
    assert (flops["ssd"] > 0) == ("mamba" in counts.mixers(m))


K1 = ["void tc::flash_fwd_bf16_kernel<128>"]
K3 = ["void tc::ssd_chunk_cb_kernel<float>", "void tc::ssd_chunk_state_kernel<float>",
      "void tc::ssd_state_pass_kernel<float>", "void tc::ssd_chunk_scan_kernel<float>"]


def traced_context(config: dict, mix: dict, seconds: float = 10.0, n: int = 20) -> dict:
    """A hand-made context of a traced run of ``n`` invocations, with every
    reading a run can give: the records' stages and the program's spans,
    the daemon's stats, the counters, and a trace whose hand kernels run at
    a quarter of their bound for each layer that holds them."""
    m = config["model"]
    batch, seq = int(mix["batch"]), int(mix["seq"])
    invs = []
    for i in range(n):
        t = i * seconds / (n + 1)
        h = (t + 0.05, t + 0.15)
        invs.append({"index": i, "prompt": 0, "function": 0, "due": t, "sent": t,
                     "done": t + 0.17, "failed": False, "error": None, "node": None,
                     "arrival": t + 0.01, "start": t + 0.02, "end": t + 0.16, "warm_stage": 1,
                     "stages": {"gpu_ctx": 0.03, "gpu_data": 0.01, "compute": 0.1},
                     "setup_wall": 0.04, "handler": h,
                     "spans": [("lock_wait", t + 0.02, h[0]), ("data_wait", h[0], h[0] + 0.01),
                               ("forward", h[0] + 0.01, h[1])]})
    kinds = counts.layer_kinds(m)
    kernels = {}
    for names, mixer, bound, shape in (
            (K1, "attn", counts.attention_call, counts.attention_shape),
            (K3, "mamba", counts.ssd_call, counts.ssd_shape)):
        calls = n * sum(1 for mx, _ in kinds if mx == mixer)
        if not calls:
            continue
        least = bound(*shape(m, batch, seq))["bound_s"]
        for k in names:  # together four times the bound
            kernels[k] = {"seconds": 4 * calls * least / len(names), "count": calls}
    return {"invocations": invs, "seconds": seconds, "setup_s": 12.0, "model": m, "mix": mix,
            "batch": batch, "seq": seq, "stats": {"shared_hits": n},
            "counters": {"h2d_bytes": 10**10, "h2d_s": 0.25, "graph_replays": n - 1,
                         "graph_captures": 1, "eager_forwards": 0},
            "trace": {"window_s": seconds, "busy_s": seconds - 2.0, "kernels": kernels,
                      "idle": [(0.0, 1.0), (5.0, 6.0)]},
            "flops_per_invocation": counts.model_flops(m, batch, seq)["total"],
            "memory_peak_bytes": 1}


@pytest.mark.parametrize("cell", CELLS)
def test_every_metric_of_a_cell_reads_its_context(cell):
    """Each end-to-end and per-layer metric of the cell reads a number from
    a traced context of its configuration and mix; no share passes 100 %."""
    w = manifest.cell(BENCH, cell)
    ctx = traced_context(manifest.config(w["config"]), manifest.mix(w["traffic"]))
    for kind in ("end_to_end", "per_layer"):
        specs = manifest.metrics_of(BENCH, cell, kind)
        got = manifest.read_all(specs, ctx)
        assert set(got) == {m["name"] for m in specs}, (cell, kind)
        for name, v in got.items():
            assert math.isfinite(v["value"]) and v["value"] >= 0, name
            if v["unit"] == "%":
                assert v["value"] <= 100, name
