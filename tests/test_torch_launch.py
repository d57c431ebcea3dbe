"""The port's launchers and serving examples against the JAX package's:
``launch.specs.input_specs`` against the JAX ``input_specs`` for every
arch and shape, ``launch.serve`` against the JAX ``serve`` on the same
workload, and the two new examples in a short run on the CPU."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.serve as ref_serve  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch.specs import input_specs as ref_input_specs  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, shape_applicable  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_jax(arch):
    """Every (arch, shape) cell that runs: the same keys, shapes and dtypes,
    as meta tensors (nothing allocated)."""
    cfg = ARCHS[arch]
    cells = 0
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        cells += 1
        got = input_specs(cfg, shape)
        want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[name])
        assert list(got) == list(want), name
        for key, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[key].shape), (name, key)
            assert str(spec.dtype).split(".")[1] == str(want[key].dtype), (name, key)
    assert cells >= 3


class _Recorded:
    """Records every Gateway the JAX launcher makes (to read it after the run)."""

    def __init__(self, monkeypatch, module):
        self.made = []
        base = module.Gateway
        made = self.made

        class Gateway(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        monkeypatch.setattr(module, "Gateway", Gateway)


def test_serve_matches_jax_serve(monkeypatch, capsys):
    """Four requests of the same Poisson workload through both launchers:
    every request served, the same record and daemon-statistics keys and
    the same printed line's fields; the port's launcher leaves no device
    bytes behind."""
    ref_gws = _Recorded(monkeypatch, ref_serve)
    want = ref_serve.serve(requests=4, time_scale=0.05)
    served = port_serve.serve(requests=4, time_scale=0.05, device="cpu")
    got = served.telemetry
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[serve:")]
    assert len(lines) == 2
    fields = [[f.split("=")[0] for f in ln.split() if "=" in f] for ln in lines]
    assert fields[0] == fields[1] == ["mean", "p99", "warm%", "shared_hits"]
    assert lines[0].split()[:3] == lines[1].split()[:3] == ["[serve:sage]", "4", "requests"]
    assert len(got.records) == len(want.records) == 4
    assert got.error_count() == want.error_count() == 0
    assert [sorted(r.stages) for r in got.records] == [sorted(r.stages) for r in want.records]
    assert set(served.stats) == set(ref_gws.made[0].runtime.daemon.stats)
    assert served.stats["shared_hits"] >= 1
    assert served.usage == {"device_used": 0, "context_bytes": 0, "host_used": 0}
    assert served.device == "cpu"


def test_serve_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serve.main(["--requests", "1"])


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_workload_example_runs_on_the_cpu(capsys):
    """examples/torch_serve_workload.py with a few requests: both systems
    serve them all, and only SAGE shares read-only weights."""
    res = _example("torch_serve_workload").main(
        ["--requests", "4", "--rate", "20", "--device", "cpu"])
    assert set(res) == {"fixedgsl", "sage"} and all(np.isfinite(list(res.values())))
    out = capsys.readouterr().out
    assert "fixedgsl" in out and "shared=  0" in out and "SAGE speedup" in out
    assert out.count("errors=0") == 2


def test_multistage_demo_walks_the_ladder_on_the_cpu(monkeypatch):
    """examples/torch_multistage_demo.py with short stages: each hit lands in
    the stage it waited for."""
    mod = _example("torch_multistage_demo")
    monkeypatch.setattr(mod, "TTL", 0.4)
    records = mod.main("cpu")
    assert [r.warm_stage for r in records] == [None, 1, 2, 3, 4]
    assert all(r.error is None for r in records)
