"""The port's sharding rules (``repro_torch.distributed``) against the JAX
package's (``repro.distributed``): every parameter, optimizer, cache and
batch spec equal leaf by leaf on the production meshes, the ZeRO-decode
decision, the placements a spec becomes, the local shard shapes on a
256-rank fake-group mesh, and ``constrain`` with no policy."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.distributed import rules as jrules  # noqa: E402
from repro.distributed.compat import abstract_mesh as jax_abstract_mesh  # noqa: E402
from repro.launch.specs import batch_input_specs as jax_batch_specs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import cache_shapes as jax_cache_shapes  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import steps as jax_steps  # noqa: E402
from repro_torch.analysis.roofline import HBM_BYTES  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.distributed import rules  # noqa: E402
from repro_torch.distributed.act_sharding import activation_policy, constrain  # noqa: E402
from repro_torch.distributed.compat import abstract_mesh  # noqa: E402
from repro_torch.launch.specs import batch_input_specs  # noqa: E402
from repro_torch.models import param_shapes  # noqa: E402
from repro_torch.serving import cache_shapes  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_ARCHS = ["qwen3-8b", "jamba-1.5-large-398b", "whisper-small", "mamba2-780m"]


def _meshes(name):
    sizes, names = MESHES[name]
    return jax_abstract_mesh(sizes, names), abstract_mesh(sizes, names)


def _jax_flat(specs):
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jrules.path_str(p): tuple(s) for p, s in flat}


def _flat(tree, prefix=""):
    """The port's spec tree as {path: spec}; a spec is a tuple, a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree)}


def _same(got, want):
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.fixture(scope="module")
def jax_param_shapes():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = jax.eval_shape(
                lambda: jax_init_params(REF_ARCHS[arch], jax.random.PRNGKey(0)))
        return cache[arch]
    return get


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(arch, mesh_name, jax_param_shapes):
    """train, prefill and decode (with and without ZeRO over data): the same
    spec for every parameter, by path."""
    jmesh, mesh = _meshes(mesh_name)
    jshapes, shapes = jax_param_shapes(arch), param_shapes(ARCHS[arch])
    for mode, zero in (("train", False), ("prefill", False), ("decode", False),
                       ("decode", True)):
        want = _jax_flat(jrules.tree_param_specs(REF_ARCHS[arch], jmesh, jshapes, mode=mode,
                                                 zero_shard_decode=zero))
        got = _flat(rules.tree_param_specs(ARCHS[arch], mesh, shapes, mode=mode,
                                           zero_shard_decode=zero))
        _same(got, want)


@pytest.fixture(scope="module")
def jax_opt_shapes():
    cache = {}

    def get(arch, dt):
        if arch not in cache:
            cache[arch] = jax.eval_shape(lambda: jax_steps.init_train_state(
                REF_ARCHS[arch], jax_opt.OptimizerConfig(state_dtype=dt),
                jax.random.PRNGKey(0)))["opt"]
        return cache[arch]
    return get


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_specs_match_jax(arch, mesh_name, jax_opt_shapes):
    """The optimizer state (m, v mirror the parameters; step replicated),
    in the state dtype the cells give each arch."""
    jmesh, mesh = _meshes(mesh_name)
    dt = "bfloat16" if ARCHS[arch].param_count() > 1e11 else "float32"
    jstate = {"opt": jax_opt_shapes(arch, dt)}
    opt = optimizer.adamw_init(optimizer.OptimizerConfig(state_dtype=dt),
                               param_shapes(ARCHS[arch]))
    assert {p: tuple(t.shape) for p, t in _leaf_shapes(opt).items()} == {
        jrules.path_str(p): tuple(s.shape)
        for p, s in jax.tree_util.tree_flatten_with_path(jstate["opt"])[0]}
    _same(_flat(rules.tree_opt_specs(ARCHS[arch], mesh, opt)),
          _jax_flat(jrules.tree_opt_specs(REF_ARCHS[arch], jmesh, jstate["opt"])))


def _leaf_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_shapes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_jax(arch):
    """tests/test_sharding.py's four archs, a 128 x 32768 cache (whisper's
    cross cache 16384) on the 16x16 mesh."""
    jmesh, mesh = _meshes("16x16")
    enc = 16384 if ARCHS[arch].is_encoder_decoder else 0
    jcs = jax_cache_shapes(REF_ARCHS[arch], 128, 32768, enc_len=enc)
    cs = cache_shapes(ARCHS[arch], 128, 32768, enc)
    _same(_flat(rules.tree_cache_specs(ARCHS[arch], mesh, cs)),
          _jax_flat(jrules.tree_cache_specs(REF_ARCHS[arch], jmesh, jcs)))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_specs_match_jax(arch):
    """Every shape's inputs (long_500k: batch 1, which cannot shard) and a
    decode token batch, on both meshes."""
    for mesh_name in MESHES:
        jmesh, mesh = _meshes(mesh_name)
        for name, shape in SHAPES.items():
            if shape.kind == "decode":
                B = shape.global_batch
                jin = {"tokens": jax.ShapeDtypeStruct((B, 1), np.int32),
                       "positions": jax.ShapeDtypeStruct((B,), np.int32)}
                pin = {"tokens": torch.empty((B, 1), device="meta"),
                       "positions": torch.empty((B,), device="meta")}
            else:
                jin = jax_batch_specs(REF_ARCHS[arch], REF_SHAPES[name])
                pin = batch_input_specs(ARCHS[arch], shape)
            want = {k: tuple(v) for k, v in jrules.batch_specs(
                REF_ARCHS[arch], jmesh, jin, mode=shape.kind).items()}
            got = {k: tuple(v) for k, v in rules.batch_specs(
                ARCHS[arch], mesh, pin, mode=shape.kind).items()}
            assert got == want, (mesh_name, name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_needs_zero_decode(mesh_name):
    """At a TPU v5e's 16 GiB (the JAX default) the port decides as the JAX
    package does: the two ~400B archs only. At the port's default, one
    H100's 85.0 GB (roofline.HBM_BYTES), no arch needs it: their 49.71 GB
    of bf16 weights per card at TP 16 are under 0.6 x 85.0 = 51.0 GB
    (PERF.md)."""
    jmesh, mesh = _meshes(mesh_name)
    for arch in ARCHS:
        want = jrules.needs_zero_decode(REF_ARCHS[arch], jmesh)
        assert rules.needs_zero_decode(ARCHS[arch], mesh, hbm_bytes=16 << 30) == want, arch
        assert not rules.needs_zero_decode(ARCHS[arch], mesh), arch
    assert HBM_BYTES == 85_017_493_504
    giant = ARCHS["llama4-maverick-400b-a17b"].param_count() * 2 / 16
    assert 0.6 * 80e9 < giant < 0.6 * HBM_BYTES


def test_placements_of_a_spec():
    """A spec -> one placement per mesh dim, pod-major as in JAX."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert rules.placements(mesh, rules.P(("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert rules.placements(mesh, rules.P(None, None, "model")) == (
        Replicate(), Replicate(), Shard(2))
    assert rules.placements(mesh, rules.P()) == (Replicate(),) * 3
    assert rules.named(mesh, {"a": {"b": rules.P(None, ("data",))}}) == {
        "a": {"b": (Replicate(), Shard(1), Replicate())}}


def test_constrain_is_the_identity_without_a_policy():
    x = torch.randn(2, 3, 4)
    assert constrain(x, "residual") is x
    with activation_policy({"residual": rules.P(("data",), None, "model")}):
        assert constrain(x, "residual") is x  # a plain tensor
        assert constrain(x, "other") is x
    with activation_policy(None):
        assert constrain(x, "residual") is x


_LOCAL = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.compat import init_fake_group
    from repro_torch.launch.cells import place
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import param_shapes
    multi_pod = sys.argv[1] == "1"
    init_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    out = {}
    for arch in ("qwen2.5-3b", "jamba-1.5-large-398b"):
        for mode in ("train", "decode"):
            placed = place(ARCHS[arch], mesh, param_shapes(ARCHS[arch]), mode)
            def walk(t, prefix=""):
                if isinstance(t, dict):
                    for k, v in t.items():
                        walk(v, prefix + k + "/")
                else:
                    out[f"{arch}|{mode}|{prefix[:-1]}"] = list(t.to_local().shape)
            walk(placed)
    dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_local_shapes_on_a_fake_group_match_jax(mesh_name, jax_param_shapes):
    """On a fake process group of 256 (512) ranks, every qwen2.5-3b and
    jamba leaf placed by the train and decode rules has, on rank 0, the
    shard shape of the JAX spec (each dim cut by its axes' sizes)."""
    res = subprocess.run([sys.executable, "-c", _LOCAL, "1" if mesh_name == "2x16x16" else "0"],
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    sizes = dict(zip(MESHES[mesh_name][1], MESHES[mesh_name][0]))
    jmesh = _meshes(mesh_name)[0]
    n = 0
    for arch in ("qwen2.5-3b", "jamba-1.5-large-398b"):
        jshapes = jax_param_shapes(arch)
        for mode in ("train", "decode"):
            specs = jrules.tree_param_specs(REF_ARCHS[arch], jmesh, jshapes, mode=mode)
            flat = jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, JP))[0]
            shapes = dict((jrules.path_str(p), s.shape) for p, s in
                          jax.tree_util.tree_flatten_with_path(jshapes)[0])
            for path, spec in flat:
                key = jrules.path_str(path)
                want = list(shapes[key])
                for d, ax in enumerate(spec):
                    for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                        want[d] //= sizes[a]
                assert got[f"{arch}|{mode}|{key}"] == want, (arch, mode, key)
                n += 1
    assert n == len(got)


_COUNT = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.analysis.op_analysis import analyze_step
    from repro_torch.distributed.compat import init_fake_group, make_mesh
    init_fake_group(4)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    def dt(shape, pls):
        return DTensor.from_local(torch.empty(shape, device="meta"), mesh, pls, run_check=False)
    x = dt((4, 16), [Shard(0), Replicate()])          # global (8, 16)
    w = dt((16, 16), [Replicate(), Shard(1)])         # global (16, 32): no collective
    w2 = dt((8, 16), [Shard(0), Shard(1)])            # rows split over data: gathered
    out = {"plain": analyze_step(lambda: x @ w), "gather": analyze_step(lambda: x @ w2)}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_op_analysis_counts_one_rank_of_a_dtensor_step():
    """On a fake group, ``analyze_step`` counts a ``DTensor`` product as this
    rank runs it: the local shapes' FLOPs, not the global ones, not the
    product ``DTensor`` runs on fake tensors to find the global shape, and
    the all-gather its redistribution issues (the local shard's bytes)."""
    res = subprocess.run([sys.executable, "-c", _COUNT],
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    plain, gather = got["plain"], got["gather"]
    assert plain["by_op"]["aten.mm"]["count"] == 1
    assert plain["dot_flops"] == 2 * 4 * 16 * 16
    assert plain["collective_bytes"] == 0
    assert gather["dot_flops"] == 2 * 4 * 16 * 16
    assert gather["collective_counts"] == {"all-gather": 1}
    assert gather["collective_bytes"] == 8 * 16 * 4  # w2's local shard, fp32


_COLD_WARM = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.analysis.op_analysis import analyze_step
    from repro_torch.distributed.compat import init_fake_group, make_mesh
    init_fake_group(4)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    def dt(shape, pls):
        return DTensor.from_local(torch.empty(shape, device="meta"), mesh, pls, run_check=False)
    d = dt((2, 3, 4, 8), [Shard(0), Replicate()])     # global (4, 3, 4, 8)
    c = dt((2, 3, 2, 8), [Shard(0), Shard(2)])        # global (4, 3, 4, 8)
    w = dt((2, 8, 16), [Replicate(), Shard(0)])       # global (4, 8, 16)
    def step():
        return torch.einsum("ebcd,edf->ebcf", torch.einsum("bsec,bsed->ebcd", d, c), w)
    out = [analyze_step(step), analyze_step(step)]
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_op_analysis_skips_dtensor_layout_choices():
    """Two MoE-like einsums on a 2 x 2 fake-group mesh, counted twice: the
    first run, where ``DTensor`` prices every candidate layout and plans
    its redistributions (chunks, concatenations, index ranges on plain
    tensors), counts exactly what the second, served from its caches,
    counts: only the rank's own ops and collectives."""
    res = subprocess.run([sys.executable, "-c", _COLD_WARM],
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    cold, warm = json.loads(res.stdout.strip().splitlines()[-1])
    assert cold == warm
    assert warm["by_op"]["aten.bmm"]["count"] == 2 and "aten.cat" not in warm["by_op"]


_MOE = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.compat import init_fake_group, make_mesh
    from repro_torch.launch.cells import place
    from repro_torch.models import layers as L
    from repro_torch.models import param_shapes
    init_fake_group(8)
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    seen = []
    experts = L.moe_experts
    def spy(cfg, x, gate_vals, gate_idx, onehot, wg, wu, wd, C):
        seen.append([list(t.shape) for t in (x, onehot, wg, wu, wd)])
        return experts(cfg, x, gate_vals, gate_idx, onehot, wg, wu, wd, C)
    L.moe_experts = spy
    out = {}
    for E in (8, 3):
        cfg = ARCHS["olmoe-1b-7b"].reduced(num_experts=E)
        params = place(cfg, mesh, param_shapes(cfg), "train")
        ffn = {k: v[0] for k, v in params["layers"]["sub0"]["ffn"].items()}
        x = DTensor.from_local(torch.empty((1, 16, cfg.d_model), device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        y, aux = L.moe_forward(cfg, ffn, x)
        out[E] = {"local": {k: list(v.to_local().shape) for k, v in
                            params["layers"]["sub0"]["ffn"].items()},
                  "seen": seen.pop(), "y": [repr(p) for p in y.placements],
                  "y_shape": list(y.shape), "aux": [repr(p) for p in aux.placements]}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_moe_ffn_placements_on_a_fake_group():
    """``local.moe_ffn`` on a (data, model) = (2, 4) fake-group mesh, the
    reduced olmoe with 8 experts and with 3: the train rules' expert
    weights hold, on rank 0, the JAX spec's shard shapes (E over
    ``model`` when it divides, d_in over ``data``); each rank's experts
    see their weights gathered over ``data`` and cut over ``model`` (2 of
    8 experts, or all 3), its own rows (1 of 2) and its experts' one-hot
    columns; y is a partial sum over ``model`` before the residual's
    reduction (whole when E does not divide), still split by rows over
    ``data``; aux is whole."""
    res = subprocess.run([sys.executable, "-c", _MOE],
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    jmesh = jax_abstract_mesh((2, 4), ("data", "model"))
    sizes = {"data": 2, "model": 4}
    for E in (8, 3):
        cfg = REF_ARCHS["olmoe-1b-7b"].reduced(num_experts=E)
        jshapes = jax.eval_shape(lambda c=cfg: jax_init_params(c, jax.random.PRNGKey(0)))
        row = got[str(E)]
        for name, loc in row["local"].items():
            leaf = jshapes["layers"]["sub0"]["ffn"][name]
            want = list(leaf.shape)
            spec = jrules.param_spec(cfg, jmesh, f"layers/sub0/ffn/{name}", leaf.shape,
                                     mode="train")
            for d, ax in enumerate(spec):
                for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                    want[d] //= sizes[a]
            assert loc == want, (E, name, loc, want)
        el = E // 4 if E % 4 == 0 else E
        D, Fd = cfg.d_model, cfg.moe_d_ff
        assert row["seen"] == [[1, 16, D], [1, 16, 2, el], [el, D, Fd], [el, D, Fd],
                               [el, Fd, D]], (E, row["seen"])
        assert row["y_shape"] == [2, 16, D]
        assert row["y"] == ["Shard(dim=0)", "Partial(sum)" if E == 8 else "Replicate()"]
        assert row["aux"] == ["Replicate()", "Replicate()"]
