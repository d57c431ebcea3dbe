"""The port's cells (``repro_torch.launch.cells``) and dry-run
(``repro_torch.launch.dryrun``) against the JAX package's: every cell's
facts and skip reasons; the reduced qwen2.5-3b, mamba2-780m, olmoe-1b-7b
and jamba train, prefill and decode cells on a one-rank gloo mesh against
the JAX steps on the same weights; the same cells (olmoe's with E over
``model``, and with E that does not divide) on two gloo ranks, (data,
model) = (1, 2) and (2, 1), against the one-rank run; the reduced
phi4-mini on three gloo ranks (attention split by query rows) and the
reduced jamba on two (Mamba2 blocks split by heads); one production
cell's dry-run on a 256-rank fake group, a MoE prefill's on a 512-rank
one, one full-width layer's per-rank products on a 16-rank one, and a
skipped cell."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.distributed import rules as jrules  # noqa: E402
from repro.launch.cells import build_cell as jax_build_cell  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import steps as jax_steps  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS, attention_bound_ms,
)
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import greedy_sample  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
CELL_ARCHS = ["qwen2.5-3b", "mamba2-780m", "olmoe-1b-7b", "jamba-1.5-large-398b"]
# tests/test_kernels.py: attention 3e-5, the SSD scan 1e-3
TOL = {"qwen2.5-3b": 3e-5, "mamba2-780m": 1e-3, "olmoe-1b-7b": 3e-5,
       "jamba-1.5-large-398b": 1e-3}
# the train cells' bound, 1e-5 (tests/test_torch_training.py's); jamba's
# plain one-device step itself drifts from the JAX step by 1.6e-5 in the
# grad norm at step 2 and 2.4e-4 at step 3 (its SSD's fp32 sums through
# Adam), so it takes the SSD scan's 1e-3
TRAIN_RTOL = {"jamba-1.5-large-398b": 1e-3}
B, S, SP = 2, 12, 8  # batch, decode cache length, prompt


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A 1 x 1 (data, model) mesh over a one-rank gloo group."""
    path = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(cfg, seed, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq),
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cell_meta_and_skips_match_jax(arch, mesh):
    """Every shape: the same skip reason, or the same facts (mode, tokens a
    step, activation policy, optimizer state dtype, microbatches) as the
    JAX ``build_cell`` on its one-device host mesh; ZeRO decode by the JAX
    rule at the port's memory size (the JAX default is a TPU v5e's)."""
    jmesh = jax_host_mesh()
    for shape in SHAPES:
        try:
            jmeta, jerr = jax_build_cell(arch, shape, jmesh)[2], None
        except ValueError as e:
            jmeta, jerr = None, str(e)
        try:
            meta, err = cells.build_cell(arch, shape, mesh)[2], None
        except ValueError as e:
            meta, err = None, str(e)
        assert err == jerr, (arch, shape)
        if jerr:
            continue
        assert set(meta) == set(jmeta), (arch, shape)
        for k, want in jmeta.items():
            if k == "policy":
                assert {n: tuple(v) for n, v in meta[k].items()} == \
                    {n: tuple(v) for n, v in want.items()}, (arch, shape)
            elif k == "zero_shard_decode":
                # the JAX rule at the port's capacity (one H100, not a v5e)
                assert meta[k] == jrules.needs_zero_decode(
                    REF_ARCHS[arch], jmesh, hbm_bytes=HBM_BYTES), (arch, shape)
            else:
                assert meta[k] == want, (arch, shape, k)


def test_build_cell_places_meta_shards(mesh):
    """The cell's inputs are DTensors of meta tensors: nothing allocated."""
    step, (state, batch), meta = cells.build_cell("llama4-maverick-400b-a17b", "train_4k",
                                                  mesh)
    leaves = [*cells.T.leaves(state), *batch.values()]
    assert all(cells.is_dtensor(t) and t.to_local().is_meta for t in leaves)
    assert cells.local_bytes(state) > 1e12  # 400B params and bf16 moments, one rank
    assert meta["microbatches"] == 4 and meta["opt_state_dtype"] == "bfloat16"


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_reduced_train_cell_matches_jax(arch, mesh):
    """Three steps of the train cell from the JAX weights on the JAX
    batches: loss, grad norm, total loss (olmoe's and jamba's with the
    router's aux term) and tokens within 1e-5 (tests/test_torch_training.py's
    bound; jamba within 1e-3, ``TRAIN_RTOL``)."""
    ref_cfg, cfg = REF_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, min_lr_ratio=1.0)
    jcfg, pcfg = jax_opt.OptimizerConfig(**kw), optimizer.OptimizerConfig(**kw)
    jstate = jax_steps.init_train_state(ref_cfg, jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(_np(jstate["params"]), "cpu")
    state = {"params": params, "opt": optimizer.adamw_init(pcfg, params)}
    jstep = jax.jit(jax_steps.make_train_step(ref_cfg, jcfg))
    step, (cstate, _), meta = cells._build_train(
        cfg, ShapeConfig("t", "train", 16, 4), mesh, cells.CellTuning(), state=state,
        opt_cfg=pcfg)
    assert meta["mode"] == "train" and meta["tokens_per_step"] == 64
    for i in range(3):
        toks = _tokens(cfg, 10 + i, batch=4, seq=16)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        cstate, m = step(cstate, cells.place_batch(cfg, mesh, {"tokens": torch.from_numpy(toks)},
                                                   "train"))
        for k in ("loss", "grad_norm", "total_loss", "tokens"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=TRAIN_RTOL.get(arch, 1e-5), err_msg=k)


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_reduced_serving_cells_match_jax(arch, mesh):
    """The prefill cell's logits, then the decode cell (its cache filled by
    the prefill step) for S - SP greedy steps, against the JAX steps on the
    same weights: 3e-5 for attention, 1e-3 for the SSD path."""
    ref_cfg, cfg = REF_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    jparams = jax_init_params(ref_cfg, jax.random.PRNGKey(1))
    params = params_from_numpy(_np(jparams), "cpu")
    prompt = _tokens(cfg, 2)[:, :SP]
    jlg, jcache = jax_engine.make_prefill_step(ref_cfg)(
        jparams, {"tokens": jnp.asarray(prompt)}, jax_init_cache(ref_cfg, B, S))
    tune = cells.CellTuning()
    pstep, (pparams, _, pcache), _ = cells._build_prefill(
        cfg, ShapeConfig("p", "prefill", SP, B), mesh, tune, params=params)
    dstep, (dparams, _, _, dcache), dmeta = cells._build_decode(
        cfg, ShapeConfig("d", "decode", S, B), mesh, tune, params=params)
    assert dmeta["zero_shard_decode"] is False
    batch = cells.place_batch(cfg, mesh, {"tokens": torch.from_numpy(prompt)}, "prefill")
    with torch.no_grad():
        lg, _ = pstep(pparams, batch, pcache)
        np.testing.assert_allclose(lg.full_tensor().numpy(), np.asarray(jlg),
                                   atol=TOL[arch], rtol=TOL[arch])
        pstep(dparams, batch, dcache)
        jdec = jax_engine.make_decode_step(ref_cfg)
        for t in range(SP, S):
            nxt = greedy_sample(lg.full_tensor())
            jnxt = jax_engine.greedy_sample(jlg)
            np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
            ins = cells.place_batch(cfg, mesh, {
                "tokens": nxt[:, None], "positions": torch.full((B,), t, dtype=torch.int32)},
                "decode")
            lg, _ = dstep(dparams, ins["tokens"], ins["positions"], dcache)
            jlg, jcache = jdec(jparams, jnxt[:, None], jnp.full((B,), t, jnp.int32), jcache)
            np.testing.assert_allclose(lg.full_tensor().numpy(), np.asarray(jlg),
                                       atol=TOL[arch], rtol=TOL[arch])


_RANKS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.serving import greedy_sample
    from repro_torch.training import optimizer, steps
    rank, path, data, model = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + path, rank=rank, world_size=2)
    mesh = make_host_mesh(data, model, device_type="cpu")
    # a small clip, so that every step clips by the global norm
    ocfg = optimizer.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=0.5)
    out = {}

    def toks(cfg, seed, b, s):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (b, s), dtype=np.int32))

    def train(name, cfg):
        def state():
            p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            return {"params": p, "opt": optimizer.adamw_init(ocfg, p)}
        one, st = steps.make_train_step(cfg, ocfg), state()
        step, (cst, _), _ = cells._build_train(cfg, ShapeConfig("t", "train", 16, 4), mesh,
                                               cells.CellTuning(), state=state(), opt_cfg=ocfg)
        got, want = [], []
        for i in range(2):
            b = {"tokens": toks(cfg, 10 + i, 4, 16)}
            st, m = one(st, b)
            cst, cm = step(cst, cells.place_batch(cfg, mesh, b, "train"))
            want += [float(m["loss"]), float(m["grad_norm"])]
            got += [float(cm["loss"]), float(cm["grad_norm"])]
        out[name] = [got, want]

    def serve(name, cfg, L=12, SP=8, B=2):
        params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        prompt = toks(cfg, 2, B, SP)
        with torch.no_grad():
            cache = init_cache(cfg, B, L, device="cpu")
            lg, _, _ = prefill(cfg, params, {"tokens": prompt}, cache)
            want, fed = [lg], []
            for t in range(SP, L):
                fed.append(greedy_sample(want[-1])[:, None])
                want.append(decode_step(cfg, params, fed[-1], torch.full((B,), t, dtype=torch.int32),
                                        cache)[0])
            tune = cells.CellTuning()
            pstep, (pp, _, pc), _ = cells._build_prefill(
                cfg, ShapeConfig("p", "prefill", SP, B), mesh, tune, params=params)
            dstep, (dp, _, _, dc), _ = cells._build_decode(
                cfg, ShapeConfig("d", "decode", L, B), mesh, tune, params=params)
            batch = cells.place_batch(cfg, mesh, {"tokens": prompt}, "prefill")
            got = [pstep(pp, batch, pc)[0].full_tensor()]
            pstep(dp, batch, dc)
            for i, t in enumerate(range(SP, L)):
                ins = cells.place_batch(cfg, mesh, {
                    "tokens": fed[i], "positions": torch.full((B,), t, dtype=torch.int32)},
                    "decode")
                got.append(dstep(dp, ins["tokens"], ins["positions"], dc)[0].full_tensor())
        out[name] = [max(float((a - b).abs().max()) for a, b in zip(got, want)),
                     max(float(b.abs().max()) for b in want)]

    qwen = ARCHS["qwen2.5-3b"].reduced()
    # one KV head for 4 query heads: at model = 2 the k/v projections stay
    # whole on each rank and each rank's attention takes the KV head of its
    # own query heads
    train("qwen_mqa_train", qwen.reduced(num_kv_heads=1))
    # 3 heads at model = 2: the heads do not divide, so attention runs them
    # whole on each rank (the projection gathered, its gradient too)
    train("qwen_odd_heads_train", qwen.reduced(num_heads=3, num_kv_heads=1))
    serve("qwen_decode", qwen)
    train("mamba_train", ARCHS["mamba2-780m"].reduced())
    # the decode step on each rank's SSD heads; the conv state's channel
    # split (160 over 2) does not line up with the heads' x channels (64 a rank)
    serve("mamba_decode", ARCHS["mamba2-780m"].reduced())
    serve("jamba_decode", ARCHS["jamba-1.5-large-398b"].reduced())
    olmoe = ARCHS["olmoe-1b-7b"].reduced()
    # 4 experts: at model = 2 each rank runs 2 of them; 3 experts do not
    # divide, and every rank runs all 3
    train("olmoe_train", olmoe)
    train("olmoe_odd_experts_train", olmoe.reduced(num_experts=3))
    serve("olmoe_decode", olmoe)
    # one row: at data = 2 it leaves ``data`` idle, and the decode's query
    # heads and the experts' d_ff split over it
    serve("olmoe_one_row_decode", olmoe, B=1)
    # llama4: the shared expert's dense MLP beside the experts
    train("llama4_train", ARCHS["llama4-maverick-400b-a17b"].reduced())
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out))
""")


@pytest.mark.parametrize("layout", [(1, 2), (2, 1)], ids=["model2", "data2"])
def test_two_ranks_match_one_rank(layout, tmp_path):
    """Two gloo processes on (data, model) = layout: the reduced qwen2.5-3b
    train cell with one KV head (at model = 2, the GQA mapping under TP)
    and with 3 query heads (heads that do not divide by the model axis),
    the reduced qwen2.5-3b prefill and decode cells (a cache split along the sequence at model =
    2: K2's partials merged across ranks) and the reduced mamba2-780m train
    cell (SSD heads over model) and its prefill and decode cells (the
    decode step on each rank's heads, the conv state gathered and written
    back into its channel split), the reduced jamba-1.5-large's prefill
    and decode cells, and the reduced olmoe-1b-7b train cell with 4
    experts (2 a rank at model = 2) and with 3 (they do not divide: every
    rank runs all 3), its prefill and decode cells, with two rows and with
    one (at data = 2 the decode's query heads and the experts' d_ff split
    over the idle ``data``), and
    the reduced llama4 train cell (its shared expert beside the experts),
    each against the
    plain one-rank steps in the same process: losses (the router's aux
    term in them, a mean over the global batch) and grad norms (so the
    clip, 0.5, which every step hits) within 1e-5, the logits within 1e-5
    of their largest."""
    data, model = layout
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANKS, str(r), str(tmp_path / "pg"), str(data), str(model)],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, out[-2000:] + err[-4000:]
        outs.append(out)
    res = json.loads(outs[0].strip().splitlines()[-1])
    for name in ("qwen_mqa_train", "qwen_odd_heads_train", "mamba_train", "olmoe_train",
                 "olmoe_odd_experts_train", "llama4_train"):
        got, want = res[name]
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        assert want[1] > 0.5  # the first step's norm: the clip is hit
    for name in ("qwen_decode", "olmoe_decode", "olmoe_one_row_decode", "mamba_decode",
                 "jamba_decode"):
        err, scale = res[name]
        assert err <= 1e-5 * max(1.0, scale), (name, res[name])


_SPLITS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.training import optimizer, steps
    rank, path, world, what = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + path, rank=rank, world_size=world)
    mesh = make_host_mesh(1, world, device_type="cpu")
    ocfg = optimizer.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=0.5)
    out = {}

    def train(name, cfg):
        def state():
            p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            return {"params": p, "opt": optimizer.adamw_init(ocfg, p)}
        one, st = steps.make_train_step(cfg, ocfg), state()
        step, (cst, _), _ = cells._build_train(cfg, ShapeConfig("t", "train", 16, 4), mesh,
                                               cells.CellTuning(), state=state(), opt_cfg=ocfg)
        got, want = [], []
        for i in range(2):
            b = {"tokens": torch.from_numpy(np.random.default_rng(10 + i).integers(
                0, cfg.vocab_size, (4, 16), dtype=np.int32))}
            st, m = one(st, b)
            cst, cm = step(cst, cells.place_batch(cfg, mesh, b, "train"))
            want += [float(m["loss"]), float(m["grad_norm"])]
            got += [float(cm["loss"]), float(cm["grad_norm"])]
        out[name] = [got, want]

    if what == "phi4":
        cfg = ARCHS["phi4-mini-3.8b"].reduced()
        g = np.random.default_rng(0)
        for causal in (True, False):
            # 13 rows: no multiple of 2 x 3 (zigzag) nor of 3
            q, k, v = (torch.tensor(g.standard_normal((2, 13, h, cfg.head_dim)),
                                    dtype=torch.float32)
                       for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
            do = torch.tensor(g.standard_normal(q.shape), dtype=torch.float32)
            ref = [t.clone().requires_grad_() for t in (q, k, v)]
            o = ops.flash_attention(*ref, causal=causal)
            o.backward(do)
            dts = [distribute_tensor(t.clone(), mesh, [Replicate(), Replicate()]).requires_grad_()
                   for t in (q, k, v)]
            od = ops.flash_attention(*dts, causal=causal)
            od.backward(distribute_tensor(do, mesh, [Replicate(), Replicate()]))
            out["attention_causal" if causal else "attention"] = [
                [float((a - b).abs().max()) for a, b in zip(
                    [od.full_tensor(), *(t.grad.full_tensor() for t in dts)],
                    [o, *(t.grad for t in ref)])],
                [float(t.abs().max()) for t in (o, *(t.grad for t in ref))]]
        train("phi4_train", cfg)
    else:
        train("jamba_train", ARCHS["jamba-1.5-large-398b"].reduced())
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out))
""")


@pytest.mark.parametrize("what,world", [("phi4", 3), ("jamba", 2)])
def test_split_rows_and_heads_match_one_rank(what, world, tmp_path):
    """Gloo processes on (data, model) = (1, world) against the plain one-rank
    steps in the same process. phi4: the reduced phi4-mini (4 query heads,
    2 KV heads) at model = 3, where the heads do not divide and attention
    splits the query rows (zigzag when causal): the attention alone, causal
    and not, on 13 rows (no multiple of 6 or 3), its output and q, k, v
    gradients within 1e-5 of their largest (fp32); then two train steps
    (the vocab of 256 splits 86/86/84 over the ranks), losses and grad
    norms within 1e-5. jamba: the reduced jamba train cell at model = 2
    (its Mamba2 blocks' SSD heads over model, in_proj's product gathered
    and out_proj row-parallel), within ``TRAIN_RTOL``'s 1e-3."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SPLITS, str(r), str(tmp_path / "pg"), str(world), what],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, out[-2000:] + err[-4000:]
        outs.append(out)
    res = json.loads(outs[0].strip().splitlines()[-1])
    for name in ("attention_causal", "attention"):
        if name in res:
            errs, scale = res[name]
            assert all(e <= 1e-5 * max(1.0, m) for e, m in zip(errs, scale)), (name, res[name])
    train = {"phi4": ("phi4_train", 1e-5), "jamba": ("jamba_train",
                                                     TRAIN_RTOL["jamba-1.5-large-398b"])}[what]
    got, want = res[train[0]]
    np.testing.assert_allclose(got, want, rtol=train[1], err_msg=train[0])
    assert want[1] > 0.5  # the first step's norm: the clip is hit


_SMALL_DRYRUN = textwrap.dedent("""
    import dataclasses, json, sys
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.analysis.op_analysis import analyze_step
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.distributed.compat import init_fake_group
    from repro_torch.launch import cells
    arch, kind, B, S = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    data, model = int(sys.argv[5]), int(sys.argv[6])
    init_fake_group(data * model)
    mesh = init_device_mesh("cpu", (data, model), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(ARCHS[arch], num_layers=ARCHS[arch].period_len)
    build = {"prefill": cells._build_prefill, "train": cells._build_train,
             "decode": cells._build_decode}[kind]
    step, args, _ = build(cfg, ShapeConfig("s", kind, S, B), mesh, cells.CellTuning())
    rep = analyze_step(step, *args)
    dist.destroy_process_group()
    print(json.dumps(rep))
""")
# the count before the Mamba2 block ran each rank's heads through
# ``local.mamba_mixer`` and the unembedding split its uneven vocab: every
# rank formed in_proj's, out_proj's and the unembedding's products whole
MAMBA_SMALL_DOT_FLOPS_BEFORE = 510166695936.0


def _small_dryrun(arch, kind, B, S, data=1, model=16):
    res = subprocess.run([sys.executable, "-c", _SMALL_DRYRUN, arch, kind, str(B), str(S),
                          str(data), str(model)],
                         env={**ENV, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_rank_flops_on_a_small_fake_mesh():
    """One full-width layer as rank 0 of a (data, model) = (1, 16) fake mesh.
    phi4-mini's prefill (1 x 2048, 24 query heads: they do not divide by
    16): K1 once on the first zigzag chunk and twice on the last, exactly
    1/16 of the whole layer's causal attention, where every rank ran all
    24 heads before. mamba2-780m's train step (2 x 512): in_proj's products
    are the rank's 403 stored columns, out_proj's its 192 rows, the
    unembedding's its 3143 of the 50280 tokens (uneven), and no product
    spans a whole in_proj, out_proj or vocabulary; the rank's product FLOPs
    fall more than tenfold from ``MAMBA_SMALL_DOT_FLOPS_BEFORE``."""
    cfg = ARCHS["phi4-mini-3.8b"]
    rep = _small_dryrun("phi4-mini-3.8b", "prefill", 1, 2048)
    whole = attention_bound_ms((1, 2048, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                True), torch.bfloat16)[2]
    k1 = rep["by_kernel"]["flash_attention"]
    assert k1["calls"] == 3 and k1["flops"] * 16 == whole

    cfg = ARCHS["mamba2-780m"]
    rep = _small_dryrun("mamba2-780m", "train", 2, 512)
    cols = 2 * cfg.ssm_d_inner + 2 * cfg.ssm_state + cfg.ssm_nheads
    shapes = [k.split(" ", 1)[1] for k in rep["by_product"]]
    assert f"(1024, {cfg.d_model}) @ ({cfg.d_model}, {cols // 16})" in shapes
    assert f"(1024, {cfg.ssm_d_inner // 16}) @ ({cfg.ssm_d_inner // 16}, {cfg.d_model})" in shapes
    assert f"(1024, {cfg.d_model}) @ ({cfg.d_model}, {-(-cfg.vocab_size // 16)})" in shapes
    whole_dims = (cols, cfg.ssm_d_inner, cfg.vocab_size)
    assert not any(str(d) in s.replace("(", " ").replace(")", " ").replace(",", " ").split()
                   for s in shapes for d in whole_dims), shapes
    assert rep["dot_flops"] * 10 < MAMBA_SMALL_DOT_FLOPS_BEFORE


def test_rank_decode_products_on_a_small_fake_mesh():
    """One full-width mamba2-780m block's decode step (B 2, a cache of 256)
    as rank 0 of a (data, model) = (1, 16) fake mesh: the step runs the
    rank's 3 of the 48 SSD heads (``local.mamba_decode``): in_proj's
    product is the rank's 403 stored columns, out_proj's its 192 rows, and
    no product spans a whole in_proj or out_proj."""
    cfg = ARCHS["mamba2-780m"]
    rep = _small_dryrun("mamba2-780m", "decode", 2, 256)
    cols = 2 * cfg.ssm_d_inner + 2 * cfg.ssm_state + cfg.ssm_nheads
    dr = cfg.ssm_d_inner // 16
    shapes = [k.split(" ", 1)[1] for k in rep["by_product"]]
    assert f"(2, {cfg.d_model}) @ ({cfg.d_model}, {cols // 16})" in shapes
    assert f"(2, {dr}) @ ({dr}, {cfg.d_model})" in shapes
    assert not any(f"({cfg.d_model}, {cols})" in k or f"({cfg.ssm_d_inner}, {cfg.d_model})" in k
                   for k in shapes), shapes


@pytest.mark.parametrize("B,heads", [(1, 8), (2, 16)], ids=["one_row", "two_rows"])
def test_decode_heads_split_over_an_idle_data_axis(B, heads):
    """One full-width qwen2.5-3b layer's decode step (a cache of 256) as
    rank 0 of a (data, model) = (2, 8) fake mesh: K2 attends the rank's 32
    cache positions (the sequence over ``model``). With one row the batch
    leaves ``data`` idle and the 16 query heads split over it (8 a rank,
    against their one KV head), as XLA's partitioner splits jamba-1.5-large
    x long_500k's; with two rows each data rank takes its row and all 16
    heads. K2's count is 4 x heads x head_dim x positions."""
    cfg = ARCHS["qwen2.5-3b"]
    rep = _small_dryrun("qwen2.5-3b", "decode", B, 256, data=2, model=8)
    k2 = rep["by_kernel"]["decode_attention"]
    assert k2["calls"] == 1 and k2["flops"] == 4 * heads * cfg.head_dim * (256 // 8)


@pytest.mark.parametrize("kind,B,S,d_ff", [("decode", 2, 256, 512), ("prefill", 2, 16, 1024)])
def test_expert_products_split_over_an_idle_data_axis(kind, B, S, d_ff):
    """One full-width olmoe-1b-7b layer as rank 0 of a (data, model) = (2, 8)
    fake mesh: each rank's 8 of the 64 experts. The decode step routes its
    B tokens as one row, which leaves ``data`` idle, so the experts' d_ff
    (1024) is split over it, as XLA's partitioner splits jamba-1.5-large x
    long_500k's experts: the products are (8, 8, 2048) @ (8, 2048, 512) and
    (8, 8, 512) @ (8, 512, 2048) (K = 8 capacity slots). The prefill's two
    rows split over ``data``, and d_ff stays whole."""
    rep = _small_dryrun("olmoe-1b-7b", kind, B, S, data=2, model=8)
    shapes = [k.split(" ", 1)[1] for k in rep["by_product"]]
    assert any(k.endswith(f"@ (8, 2048, {d_ff})") for k in shapes), shapes
    assert any(k.endswith(f"@ (8, {d_ff}, 2048)") for k in shapes), shapes
    assert not any(k.endswith(f"@ (8, 2048, {1536 - d_ff})") for k in shapes), shapes


def test_no_train_cell_leaves_a_batch_axis_idle():
    """``local.moe_ffn`` splits the experts' d_ff over the axes a batch
    leaves idle only when no gradient is taken. No cell's training step
    reaches the other case: on both production meshes every train cell's
    microbatch has more than one row and its rows divide ``pod`` x
    ``data``, so ``place_batch`` splits them over both."""
    for multi_pod, dp in ((False, 16), (True, 2 * 16)):
        for arch in ARCHS:
            for shape in SHAPES.values():
                if shape.kind != "train":
                    continue
                rows = shape.global_batch // cells.get_tuning(arch, shape.name).microbatches
                assert rows > 1 and rows % dp == 0, (arch, shape.name, multi_pod, rows)


def test_dryrun_cell_on_a_fake_group():
    """qwen2.5-3b x decode_32k on the 16x16 production mesh, 256 fake ranks,
    no device, in a subprocess: the JAX record's keys (trace_s for lower_s
    and compile_s), per-rank work, nonzero collective bytes (K2's partials
    merged across the cache's sequence shards), the roofline at the H100's
    rates."""
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "qwen2.5-3b", "--shape", "decode_32k"],
                         env={**ENV, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
                         text=True, timeout=240, cwd=str(ROOT))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    rec = json.loads(res.stdout[res.stdout.index("{\n"):])
    assert set(rec) == {"arch", "shape", "mesh", "chips", "status", "mode", "tokens_per_step",
                        "trace_s", "analysis", "roofline"}
    assert rec["status"] == "OK" and rec["chips"] == 256 and rec["mode"] == "decode"
    an, rf = rec["analysis"], rec["roofline"]
    assert an["collective_bytes"] > 0 and an["collectives"]["all-gather"] > 0
    assert an["by_kernel"]["decode_attention"]["calls"] == 36
    mem = an["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] is None
    assert rf["compute_s"] == pytest.approx(an["flops"] / PEAK_FLOPS[torch.bfloat16])
    assert rf["memory_s"] == pytest.approx(an["hbm_bytes"] / HBM_BW)
    assert rf["collective_s"] == pytest.approx(an["collective_bytes"] / LINK_BW)


_MOE_DRYRUN = textwrap.dedent("""
    import dataclasses, json, sys
    import torch.distributed as dist
    from repro_torch.analysis.op_analysis import analyze_step
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.distributed.compat import init_fake_group
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_production_mesh
    B, S = int(sys.argv[1]), int(sys.argv[2])
    init_fake_group(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    cfg = dataclasses.replace(ARCHS["olmoe-1b-7b"], num_layers=1)
    step, args, _ = cells._build_prefill(cfg, ShapeConfig("p", "prefill", S, B), mesh,
                                         cells.get_tuning("olmoe-1b-7b", "prefill_32k"))
    rep = analyze_step(step, *args)
    dist.destroy_process_group()
    print(json.dumps(rep))
""")
MOE_DRYRUN_SHAPE = (32, 1024)  # (B, S): one row a data rank


def test_moe_prefill_dryrun_on_a_multi_pod_fake_group():
    """One full-width olmoe-1b-7b layer's prefill, B 32 x S 1024, traced
    as rank 0 of the 2 x 16 x 16 mesh (512 fake ranks) in a subprocess:
    it finishes within the timeout (the MoE FFN's einsums left to
    ``DTensor``'s per-op layout search took 136 s on one CPU core; through
    ``local.moe_ffn`` it takes under 10 s), and the rank's
    batched products are exactly its own 4 of the 64 experts' work on
    its one row: the dispatch and combine one-hots, the dispatch, the two
    up projections, the down projection and the combine."""
    B, S = MOE_DRYRUN_SHAPE
    res = subprocess.run([sys.executable, "-c", _MOE_DRYRUN, str(B), str(S)],
                         env={**ENV, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
                         text=True, timeout=60, cwd=str(ROOT))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    cfg = ARCHS["olmoe-1b-7b"]
    K, D, Fd = cfg.experts_per_token, cfg.d_model, cfg.moe_d_ff
    b, el = B // 32, cfg.num_experts // 16
    C = max(K, -(-K * S * 5 // (4 * cfg.num_experts)))  # capacity factor 1.25
    assert cfg.moe_capacity_factor == 1.25
    want = (2 * 2 * b * S * el * C * K + 2 * b * el * C * D * S + 2 * 2 * el * b * C * D * Fd
            + 2 * el * b * C * Fd * D + 2 * b * S * D * el * C)
    bmm = rep["by_op"]["aten.bmm"]
    assert (bmm["count"], bmm["flops"]) == (7, want)
    assert rep["by_kernel"]["flash_attention"]["calls"] == 1
    assert rep["collective_counts"]["all-reduce"] > 0  # the routed fractions


def test_dryrun_skips_long_context_on_full_attention():
    rec = dryrun.run_cell("qwen2.5-3b", "long_500k", multi_pod=False)
    assert rec == {"arch": "qwen2.5-3b", "shape": "long_500k", "mesh": "16x16", "chips": 256,
                   "status": "SKIP", "reason": "long_500k needs sub-quadratic attention; "
                                               "pure full-attention arch"}
