"""The benchmark loads neither JAX nor the JAX package, its references
import nothing of the program, and a checkout without the program gives no
result."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)
FOREIGN = ("jax", "jaxlib", "flax", "repro")
PLAIN = [HERE / "harness" / "plain.py"] + sorted((HERE / "configs").glob("*.py"))


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    for mod in imported(path):
        assert mod.split(".")[0] not in FOREIGN, f"{path.name} imports {mod}"


@pytest.mark.parametrize("path", PLAIN, ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    for mod in imported(path):
        assert mod.split(".")[0] in ("__future__", "math", "contextlib", "torch", "harness"), mod
        if mod.startswith("harness"):
            assert mod in ("harness", "harness.plain"), mod


def test_what_a_run_loads_holds_no_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = ['sagebench', 'src']\n"
        "from harness import check, counts, manifest, readers, runner, trace, traffic\n"
        "import repro_torch.core.functions, repro_torch.core.runtime\n"
        "import repro_torch.data.database, repro_torch.core.request\n"
        "b = manifest.benchmark()\n"
        "for c in b['configs']: manifest.reference(c['name'])\n"
        "for m in b['end_to_end'] + b['per_layer']: manifest.reader(m['name'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={"PATH": os.environ.get("PATH", "/usr/bin:/bin")}, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "sagebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    res = subprocess.run([sys.executable, "sagebench/run.py", "--workload", "olmoe-1b-7b.cold",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": os.environ.get("PATH", "/usr/bin:/bin")})
    assert res.returncode != 0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert not any("correct" in json.loads(ln) for ln in lines)
