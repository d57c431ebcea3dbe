"""The port's FLOP and byte accounting (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``), case by case as tests/test_analysis.py
holds the HLO analyzer: a single matmul, a loop of layers, the roofline
terms at the H100's rates, MoE model FLOPs, parameter counts and a
collective's bytes. Then the hand kernels' units: the bounds that
chip_smoke.py prints, pinned at the training shapes, and a step's report
the same whichever plain version runs inside a unit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.hlo_analysis import analyze_hlo_text  # noqa: E402
from repro.analysis.roofline import model_flops as ref_model_flops  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.op_analysis import analyze_step  # noqa: E402
from repro_torch.analysis.roofline import model_flops, roofline_from_report  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill  # noqa: E402
from repro_torch.training.steps import _value_and_grad  # noqa: E402

TRAIN_SHAPE = (4, 1024, 1024, 16, 2, 128, True)      # K1 at qwen2.5-3b's train step
SSD_TRAIN_SHAPE = (4, 1024, 48, 64, 128, 128)        # K3 at mamba2-780m's


def _jax_dot_flops(f, *shapes):
    c = jax.jit(f).lower(*(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)).compile()
    return analyze_hlo_text(c.as_text()).dot_flops


def _randn(*shape):
    return torch.from_numpy(np.random.default_rng(0).standard_normal(shape, dtype=np.float32))


def test_single_matmul_flops():
    a, b = _randn(64, 128), _randn(128, 32)
    rep = analyze_step(lambda: a @ b)
    assert rep["dot_flops"] == 2 * 64 * 128 * 32
    assert rep["dot_flops"] == _jax_dot_flops(lambda x, y: x @ y, (64, 128), (128, 32))
    assert rep["by_op"]["aten.mm"]["count"] == 1
    assert rep["hbm_bytes"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)


def test_products_split_by_shape():
    """``by_product`` splits the products' ``by_op`` rows by op and operand
    shapes: two shapes of ``mm`` and an ``addmm`` (its bias is not an
    operand of the product), each row's flops 2 M K N, and the rows of an
    op sum to its ``by_op`` row."""
    a, b, c = _randn(8, 16), _randn(16, 4), _randn(4, 32)
    bias = _randn(32)

    def step():
        h = a @ b
        h = h @ c
        h = a @ b
        return torch.addmm(bias, h, c)

    rep = analyze_step(step)
    got = rep["by_product"]
    assert got == {
        "aten.mm (8, 16) @ (16, 4)": {"count": 2, "flops": 2 * 2.0 * 8 * 16 * 4,
                                      "bytes": 2 * 4.0 * (8 * 16 + 16 * 4 + 8 * 4)},
        "aten.mm (8, 4) @ (4, 32)": {"count": 1, "flops": 2.0 * 8 * 4 * 32,
                                     "bytes": 4.0 * (8 * 4 + 4 * 32 + 8 * 32)},
        "aten.addmm (8, 4) @ (4, 32)": {"count": 1, "flops": 2.0 * 8 * 4 * 32,
                                        "bytes": 4.0 * (32 + 8 * 4 + 4 * 32 + 8 * 32)},
    }
    for op in ("aten.mm", "aten.addmm"):
        rows = [v for k, v in got.items() if k.startswith(op + " ")]
        assert sum(r["flops"] for r in rows) == rep["by_op"][op]["flops"]
        assert sum(r["count"] for r in rows) == rep["by_op"][op]["count"]


def test_convolution_flops():
    """A convolution is a product: 2 prod(out) K, K = (Cin / groups) x the
    kernel's size (transposed: 2 prod(in) K)."""
    x, w = _randn(2, 3, 16, 16), _randn(4, 3, 3, 3)
    assert analyze_step(torch.nn.functional.conv2d, x, w)["dot_flops"] == \
        2 * (2 * 4 * 14 * 14) * (3 * 3 * 3)
    xt = _randn(2, 4, 8, 8)
    assert analyze_step(torch.nn.functional.conv_transpose2d, xt, w)["dot_flops"] == \
        2 * xt.numel() * (3 * 3 * 3)


def test_gathers_and_scatters_move_only_their_rows():
    """An embedding lookup moves 2 x its rows and a cache write 3 x its
    update (as hlo_analysis counts a dynamic slice and a scatter), not the
    whole table."""
    table, idx = _randn(100, 8), torch.tensor([[1, 2, 3], [4, 5, 6]])
    rep = analyze_step(torch.nn.functional.embedding, idx, table)
    assert rep["hbm_bytes"] == 2 * (2 * 3 * 8 * 4)
    cache, rows, vals = torch.zeros(4, 10, 8), torch.tensor([0, 1, 2, 3]), _randn(4, 8)
    pos = torch.tensor([2, 3, 4, 5])

    def write():
        cache[rows, pos] = vals

    rep = analyze_step(write)
    assert rep["by_op"]["aten.index_put_"]["bytes"] == 3 * (4 * 8 * 4)


def test_layer_loop_counts_each_layer():
    """Eager mode runs every layer: 7 layers count 7 times (the JAX analyzer
    multiplies the scan body by its trip count), and a loop of 3 inside a
    loop of 5 counts 15 times."""
    n = 7
    w, x = _randn(n, 32, 32), _randn(32, 32)

    def layers():
        h = x
        for i in range(n):
            h = h @ w[i]
        return h

    def scan(w, x):
        return jax.lax.scan(lambda h, wi: (h @ wi, None), x, w)[0]

    rep = analyze_step(layers)
    assert rep["dot_flops"] == n * 2 * 32 * 32 * 32
    assert rep["dot_flops"] == _jax_dot_flops(scan, (n, 32, 32), (32, 32))
    assert rep["by_op"]["aten.mm"]["count"] == n

    w2, x2 = _randn(5, 16, 16), _randn(16, 16)

    def nested():
        h = x2
        for i in range(5):
            for _ in range(3):
                h = h @ w2[i]
        return h

    assert analyze_step(nested)["dot_flops"] == 5 * 3 * 2 * 16 * 16 * 16


def test_roofline_terms_and_dominance():
    cfg = ARCHS["qwen3-8b"]
    report = {
        "flops": 1e12, "dot_flops": 1e12, "hbm_bytes": 1e12,
        "collective_bytes": 1e10, "collective_traffic_bytes": 1e10,
    }
    r = roofline_from_report(cfg, report, chips=256, mode="train", tokens=1_000_000)
    assert r["dominant"] == "memory_s"  # 1e12 / 3.35e12 > 1e12 / 989e12
    np.testing.assert_allclose(r["compute_s"], 1e12 / 989e12)
    np.testing.assert_allclose(r["memory_s"], 1e12 / 3.35e12)
    np.testing.assert_allclose(r["collective_s"], 1e10 / 450e9)
    assert 0 < r["roofline_fraction"] <= 1.5
    # fp32 configs take the fp32 peak (no TF32)
    r32 = roofline_from_report(cfg.reduced(), report, chips=1, mode="train", tokens=16)
    np.testing.assert_allclose(r32["compute_s"], 1e12 / 67e12)


def test_model_flops_moe_uses_active_params():
    dense = ARCHS["qwen3-32b"]
    moe = ARCHS["llama4-maverick-400b-a17b"]
    assert moe.active_param_count() < 0.1 * moe.param_count()
    assert model_flops(dense, "train", 1000) == 6.0 * dense.param_count() * 1000
    assert model_flops(moe, "decode", 10) == 2.0 * moe.active_param_count() * 10
    for name, cfg in ARCHS.items():
        for mode, tokens in (("train", 4096), ("prefill", 4096), ("decode", 128)):
            assert model_flops(cfg, mode, tokens) == ref_model_flops(REF_ARCHS[name], mode,
                                                                     tokens), (name, mode)


def test_param_counts_sane():
    """Analytic totals land near the published numbers, and equal the JAX
    package's."""
    assert 6.5e10 < ARCHS["qwen2-vl-72b"].param_count() < 8.2e10
    assert 6.0e8 < ARCHS["mamba2-780m"].param_count() < 9.5e8
    assert 5.5e9 < ARCHS["olmoe-1b-7b"].param_count() < 8.0e9
    assert 3.3e11 < ARCHS["llama4-maverick-400b-a17b"].param_count() < 4.7e11
    assert 3.2e11 < ARCHS["jamba-1.5-large-398b"].param_count() < 4.6e11
    assert 2.7e10 < ARCHS["qwen3-32b"].param_count() < 3.7e10
    assert 2.4e9 < ARCHS["qwen2.5-3b"].param_count() < 3.6e9
    assert 6.5e9 < ARCHS["qwen3-8b"].param_count() < 9.0e9
    assert 3.2e9 < ARCHS["phi4-mini-3.8b"].param_count() < 4.6e9
    assert 1.8e8 < ARCHS["whisper-small"].param_count() < 3.5e8
    assert 0.9e9 < ARCHS["olmoe-1b-7b"].active_param_count() < 1.6e9
    assert 1.2e10 < ARCHS["llama4-maverick-400b-a17b"].active_param_count() < 2.4e10
    for name, cfg in ARCHS.items():
        assert cfg.param_count() == REF_ARCHS[name].param_count(), name
        assert cfg.active_param_count() == REF_ARCHS[name].active_param_count(), name


def test_collective_bytes_all_reduce(tmp_path):
    """A one-rank gloo all_reduce: its operand's bytes, no ring traffic
    (2 (g - 1) / g of the operand with g = 1)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        t = torch.ones(1024)
        rep = analyze_step(dist.all_reduce, t)
    finally:
        dist.destroy_process_group()
    assert rep["collective_bytes"] == 4 * 1024
    assert rep["collective_traffic_bytes"] == 0.0
    assert rep["collective_counts"] == {"all-reduce": 1}
    assert rep["collectives"] == {"all-reduce": 4 * 1024}


# ---------------------------------------------------------------------------
# the hand kernels' bounds (moved out of chip_smoke.py; PERF.md's counts)
# ---------------------------------------------------------------------------

def test_kernel_counts_at_the_training_shapes():
    """The counts PERF.md states, and their exact values as chip_smoke.py
    computed them before they moved here."""
    bf16 = torch.bfloat16
    k1 = roofline.attention_bound_ms(TRAIN_SHAPE, bf16)
    k1b = roofline.attention_bwd_bound_ms(TRAIN_SHAPE, bf16)
    k3 = roofline.ssd_bound_ms(SSD_TRAIN_SHAPE, bf16)
    k3b = roofline.ssd_bwd_bound_ms(SSD_TRAIN_SHAPE, bf16)
    assert round(k1[2] / 1e9, 1) == 17.2
    assert round(k1b[2] / 1e9, 1) == 43.0
    assert round(k3[3] / 1e6, 1) == 59.5
    assert round(k3b[2] / 1e9, 1) == 25.9
    assert k1 == (0.0173879134479272, "operations", 17196646400.0, 37748736.0)
    assert k1b == (0.043469783619818, "operations", 42991616000.0, 75759616.0)
    assert k3 == (0.01776324776119403, "bytes", 8133279744.0, 59506880.0)
    assert k3b == (0.02620114701718908, "operations", 25912934400.0, 87556480.0)
    dec = roofline.decode_bound_ms((4, 1056, 16, 2, 128), [1025, 1035, 1046, 1056], bf16)
    assert dec == (0.0012819868656716417, "bytes", 34095104.0, 4294656.0)
    assert roofline.train_step_flops(ARCHS["qwen2.5-3b"], 4, 1024) == (
        75840029196288.0, 1857237811200.0, 0.0)
    assert roofline.train_step_flops(ARCHS["mamba2-780m"], 4, 1024) == (
        19170827698176.0, 0.0, 1634218278912.0)
    assert roofline.PEAK_FLOPS == {torch.bfloat16: 989e12, torch.float32: 67e12}
    assert (roofline.HBM_BW, roofline.LINK_BW) == (3.35e12, 450e9)


def _batch(cfg, B=2, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks)}


def _sequential_ssd(x, dt, A, Bm, Cm, *, chunk=128, initial_state=None):
    """Another plain SSD scan: the recurrence one position at a time."""
    B, S, H, P = x.shape
    h = (torch.zeros(B, H, P, Bm.shape[-1]) if initial_state is None
         else initial_state.float())
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A)                                    # (B, H)
        h = h * dA[..., None, None] + (dt[:, t, :, None] * x[:, t].float())[..., None] \
            * Bm[:, t, None, None, :].float()
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].float()))
    return torch.stack(ys, 1).to(x.dtype), h


def _sdpa_attention(q, k, v, *, causal, scale=None, **_):
    """Another plain attention: torch's SDPA, GQA expanded."""
    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k.repeat_interleave(G, 2),
                                               v.repeat_interleave(G, 2)))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                           scale=scale)
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m"])
def test_units_count_the_kernels_work_not_the_plain_versions_ops(arch, monkeypatch):
    """The forward and the train step (remat: each forward runs again in
    the backward) count each kernel call once at roofline's price, and the
    same report comes out with another plain version inside the units; the
    gradients are those of the step without analysis."""
    cfg = ARCHS[arch].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg)
    B, S = batch["tokens"].shape
    want_grads = _value_and_grad(cfg, params, batch)[1]
    got = {}

    def train():
        got["grads"] = _value_and_grad(cfg, params, batch)[1]

    with torch.inference_mode():
        fwd = analyze_step(forward, cfg, params, batch)
    step = analyze_step(train)
    for g, w in zip(got["grads"], want_grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)

    if cfg.num_attn_layers:
        kind, bwd = "flash_attention", "flash_attention_bwd"
        shape = (B, S, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, True)
        work, bwork = (roofline.attention_bound_ms(shape, torch.float32),
                       roofline.attention_bwd_bound_ms(shape, torch.float32))
        n = cfg.num_attn_layers
        monkeypatch.setattr(ref, "flash_attention", _sdpa_attention)
    else:
        kind, bwd = "ssd_scan", "ssd_scan_bwd"
        shape = (B, S, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
        work, bwork = (roofline.ssd_bound_ms(shape, torch.float32),
                       roofline.ssd_bwd_bound_ms(shape, torch.float32))
        n = cfg.num_mamba_layers
        monkeypatch.setattr(ref, "ssd_scan", _sequential_ssd)
    assert fwd["by_kernel"] == {kind: {"calls": n, "flops": n * work[2], "bytes": n * work[3]}}
    assert step["by_kernel"] == {
        kind: {"calls": 2 * n, "flops": 2 * n * work[2], "bytes": 2 * n * work[3]},
        bwd: {"calls": n, "flops": n * bwork[2], "bytes": n * bwork[3]}}
    assert fwd["dot_flops"] > n * work[2]  # the projections count too

    with torch.inference_mode():
        fwd_other = analyze_step(forward, cfg, params, batch)
    assert fwd_other == fwd
    assert analyze_step(train) == step
    assert ops.counter is None


def test_decode_unit_counts_this_calls_lengths():
    """One decode step: K2 once per attention layer, priced up to each
    sequence's length; prefill and decode leave the counter unset."""
    cfg = ARCHS["qwen2.5-3b"].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg, B=2, S=12)
    with torch.inference_mode():
        cache = init_cache(cfg, 2, 20, device="cpu")
        logits, cache, _ = prefill(cfg, params, batch, cache)
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        pos = torch.tensor([12, 12], dtype=torch.int32)
        rep = analyze_step(decode_step, cfg, params, nxt, pos, cache)
    B, L, Hkv, Dh = 2, 20, cfg.num_kv_heads, cfg.head_dim
    _, _, flops, nbytes = roofline.decode_bound_ms((B, L, cfg.num_heads, Hkv, Dh), [13, 13],
                                                   torch.float32)
    n = cfg.num_attn_layers
    assert rep["by_kernel"] == {"decode_attention": {"calls": n, "flops": n * flops,
                                                     "bytes": n * nbytes}}
    assert ops.counter is None


def test_roofline_from_an_analyzed_step():
    """A report from analyze_step feeds roofline_from_report; its dot
    FLOPs are the model's 2 N D (embedding gather aside) plus the attention
    products; a failing step leaves the counter unset."""
    cfg = dataclasses.replace(ARCHS["qwen2.5-3b"].reduced(), tie_embeddings=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg, B=2, S=16)
    with torch.inference_mode():
        rep = analyze_step(forward, cfg, params, batch)
    r = roofline_from_report(cfg, rep, chips=1, mode="prefill", tokens=32)
    assert set(r) >= {"compute_s", "memory_s", "memory_fused_s", "collective_s", "dominant",
                      "useful_flops_ratio", "roofline_fraction"}
    attn = rep["by_kernel"]["flash_attention"]["flops"]
    embed = cfg.vocab_size * cfg.d_model  # a gather, not a product
    want = 2.0 * (cfg.param_count() - embed) * 32 + attn
    assert abs(rep["dot_flops"] - want) <= 0.1 * want
    assert rep["hbm_bytes_fused"] < rep["hbm_bytes"]
    with pytest.raises(ZeroDivisionError):
        analyze_step(lambda: 1 / 0)
    assert ops.counter is None
