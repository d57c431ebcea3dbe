"""What a run finds by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json`` and the reference beside it,
``configs/<config>.py``), its traffic mix (``traffic/<traffic>.json``) and
each metric's reader (``metrics/<metric>.py``, or its stem's, a function
``read(context)`` that gives a number or None)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]   # sagebench/
ROOT = HERE.parent                           # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {BENCHMARK.name}")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(name: str) -> ModuleType:
    return _module(HERE / "configs" / f"{name}.py", f"sagebench_reference_{name}")


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``; for a name with a suffix after its first dot
    (``compute_ms.warm``) that has no file of its own, the reader of its
    stem (``metrics/compute_ms.py``), which reads the cell's context alike."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return _module(path, f"sagebench_metric_{path.stem}")


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell_name``
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def read_all(specs: List[dict], context: dict) -> Dict[str, dict]:
    """Each metric's reading, with its unit; a reader that finds nothing
    to read gives None, and that metric is left out."""
    out = {}
    for spec in specs:
        value = reader(spec["name"]).read(context)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out
