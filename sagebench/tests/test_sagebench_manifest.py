"""The benchmark's manifest (``BENCHMARK.json``) against its contract, and
every file a cell finds by name."""
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from harness import manifest, traffic  # noqa: E402

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


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configurations_keep_published_widths(name):
    doc = manifest.config(name)
    m = doc["model"]
    if name == "olmoe-1b-7b":
        assert (m["d_model"], m["num_layers"], m["num_heads"], m["head_dim"]) == (2048, 16, 16, 128)
        assert (m["num_experts"], m["experts_per_token"], m["expert_d_ff"]) == (64, 8, 1024)
        assert m["vocab_size"] == doc["vocab_size"] == 50304
    else:
        assert (m["d_model"], m["num_layers"], m["ssm_state"], m["ssm_headdim"]) == (1536, 48, 128, 64)
        assert m["ssm_expand"] * m["d_model"] // m["ssm_headdim"] == 48
    assert m["param_dtype"] == m["compute_dtype"] == "bfloat16"
