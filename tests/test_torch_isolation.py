"""Guards for the port: it imports neither JAX nor the JAX package, and its
entry points never carry on on the CPU when CUDA was asked for."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_sources_exist():
    assert (PORT / "core" / "runtime.py").exists()
    for path in ("launch/specs.py", "launch/serve.py", "analysis/roofline.py",
                 "analysis/op_analysis.py", "distributed/__init__.py",
                 "distributed/act_sharding.py", "distributed/compat.py", "distributed/rules.py",
                 "distributed/local.py", "launch/mesh.py", "launch/cells.py",
                 "launch/dryrun.py"):
        assert (PORT / path).exists()
    for name in ("torch_serve_workload", "torch_multistage_demo"):
        assert (ROOT / "examples" / f"{name}.py").exists()
    assert (ROOT / "chip_smoke.py").exists()
    for name in ("flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
                 "ssd_scan_bwd"):
        assert (PORT / "kernels" / "csrc" / f"{name}.cu").exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.core, repro_torch.core.functions, "
            "repro_torch.kernels.ops, repro_torch.models.convert, "
            "repro_torch.models.mamba2, repro_torch.serving, repro_torch.api, "
            "repro_torch.core.simulator, repro_torch.core.faults, "
            "repro_torch.training, repro_torch.training.compression, "
            "repro_torch.checkpoint, repro_torch.data.pipeline, repro_torch.launch.train, "
            "repro_torch.launch.serve, repro_torch.launch.specs, "
            "repro_torch.analysis.roofline, repro_torch.analysis.op_analysis, "
            "repro_torch.distributed, repro_torch.distributed.local, "
            "repro_torch.launch.mesh, repro_torch.launch.cells, repro_torch.launch.dryrun; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_is_cuda_and_never_falls_back():
    from repro_torch.configs import ARCHS
    from repro_torch.core import SageRuntime
    from repro_torch.data.database import Database
    from repro_torch.models import init_cache

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SageRuntime()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Database()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(ARCHS["mamba2-780m"].reduced(), 1, 8)
    rt = SageRuntime(device="cpu")
    assert rt.db.device.type == "cpu"
    rt.shutdown()
