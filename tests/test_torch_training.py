"""The port's training (``repro_torch.training``) against the JAX package's
(``repro.training``): the schedule and AdamW on the same trees, the loss
and the gradient of every leaf for five families, train steps with and
without microbatches, the int8-compressed data-parallel step on a gloo
group, rematerialisation, and the plain attention backward. JAX weights
go over through numpy (``params_from_numpy``); inputs come from numpy
seeds."""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.distributed.compat import make_mesh  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.layers import flash_attention_ref as jax_attention  # noqa: E402
from repro.training import loss as jax_loss  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import steps as jax_steps  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import compression, optimizer, steps  # noqa: E402
from repro_torch.training.loss import lm_loss  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRAD_ARCHS = ["qwen2.5-3b", "olmoe-1b-7b", "qwen2-vl-72b", "mamba2-780m",
              "jamba-1.5-large-398b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, seed=0, **overrides):
    """(JAX cfg, port cfg, JAX params, the same params as CPU tensors)."""
    ref_cfg, cfg = REF_ARCHS[arch].reduced(**overrides), ARCHS[arch].reduced(**overrides)
    jp = jax_init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_cfg, cfg, jp, params_from_numpy(_np(jp), "cpu")


def _tokens(cfg, seed, batch=2, seq=16):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq),
                                                dtype=np.int32)


def _close_per_leaf(got_tree, want_tree, tol=1e-4):
    """Every leaf within tol * max(1, max|want|), same paths."""
    got, want = dict(T.items(got_tree)), dict(T.items(want_tree))
    assert sorted(got) == sorted(want)
    for key in want:
        g = got[key].detach().float().numpy() if torch.is_tensor(got[key]) else got[key]
        w = np.asarray(want[key], np.float32)
        bound = tol * max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{key}: {err} > {bound}"


# ---------------------------------------------------------------------------
# schedule and AdamW
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_jax():
    cfg = jax_opt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                                  min_lr_ratio=0.1)
    pcfg = optimizer.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                                     min_lr_ratio=0.1)
    for s in (0, 1, 5, 10, 37, 55, 99, 100, 130):
        want = float(jax_opt.lr_at(cfg, jnp.asarray(s, jnp.int32)))
        got = optimizer.lr_at(pcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def _opt_tree(rng):
    """Params with 2-D, 3-D (a period stack) and 1-D leaves, and grads."""
    shapes = {"w": (6, 5), "layers": {"wq": (2, 4, 3), "norm": (2, 4)}, "bias": (5,),
              "scale": (3,)}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple))
    return draw(1.0), [draw(3.0) for _ in range(3)]


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
def test_adamw_update_matches_jax(state_dtype, clip_norm):
    """Three updates on the same trees: params, moments (in their state
    dtype), step and the metrics within 1e-6 relative."""
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm, state_dtype=state_dtype,
              warmup_steps=1, total_steps=10)
    jcfg, pcfg = jax_opt.OptimizerConfig(**kw), optimizer.OptimizerConfig(**kw)
    params, grads = _opt_tree(np.random.default_rng(0))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_opt.adamw_init(jcfg, jp)
    tp = params_from_numpy(params, "cpu")
    tstate = optimizer.adamw_init(pcfg, tp)
    for g in grads:
        jp, jstate, jm = jax_opt.adamw_update(jcfg, jax.tree_util.tree_map(jnp.asarray, g),
                                              jstate, jp)
        tp, tstate, tm = optimizer.adamw_update(pcfg, params_from_numpy(g, "cpu"), tstate, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32
    for (key, got), (_, want) in zip(T.items(tp), T.items(_np(jp))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, err_msg=key)
    for name in ("m", "v"):
        for (key, got), (_, want) in zip(T.items(tstate[name]), T.items(_np(jstate[name]))):
            assert str(got.dtype).endswith(state_dtype)
            np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                       rtol=1e-6, atol=1e-12, err_msg=f"{name}/{key}")


def test_adamw_skips_decay_on_1d_leaves():
    """Zero gradients: only leaves with ndim >= 2 shrink by lr * wd."""
    cfg = optimizer.OptimizerConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                                    total_steps=10, min_lr_ratio=1.0, clip_norm=0.0)
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    state = optimizer.adamw_init(cfg, p)
    optimizer.adamw_update(cfg, {"w": torch.zeros(2, 2), "b": torch.zeros(2)}, state, p)
    np.testing.assert_allclose(p["w"].numpy(), 1 - 0.1 * 0.5, rtol=1e-6)
    np.testing.assert_array_equal(p["b"].numpy(), 1.0)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """lm_loss (with a loss mask) and the gradient of every leaf against
    jax.grad of repro.training.loss.lm_loss: loss and metrics within 1e-5,
    each leaf within 1e-4 * max(1, max|g|). Mamba2 and jamba take K3's
    plain version, differentiated by autograd."""
    ref_cfg, cfg, jp, tp = _pair(arch)
    toks = _tokens(cfg, 1)
    mask = np.ones(toks.shape, np.float32)
    mask[:, 12:] = 0.0
    batch = {"tokens": toks, "loss_mask": mask}
    (want, wmet), wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss.lm_loss(ref_cfg, p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = T.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    got, met = lm_loss(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert sorted(met) == sorted(wmet)
    for k in wmet:
        np.testing.assert_allclose(float(met[k]), float(wmet[k]), rtol=1e-5, atol=1e-7)
    assert float(met["tokens"]) == 2 * 11  # positions 1..11 of each row predict
    assert (float(met["aux_loss"]) > 0) == bool(cfg.num_experts)
    _close_per_leaf(T.unflatten(tp, grads), _np(wgrads))


def test_loss_equals_manual_cross_entropy():
    """No mask, no z-loss: the mean next-token CE of the forward's logits."""
    _, cfg, _, tp = _pair("qwen2.5-3b")
    toks = torch.from_numpy(_tokens(cfg, 3, seq=12))
    with torch.no_grad():
        _, met = lm_loss(cfg, tp, {"tokens": toks}, z_loss=0.0)
        logp = torch.log_softmax(forward(cfg, tp, {"tokens": toks})[0][:, :-1], -1)
    manual = -logp.gather(-1, toks[:, 1:, None].long()).mean()
    np.testing.assert_allclose(float(met["loss"]), float(manual), rtol=1e-5)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    """Three steps from the same weights on the same batches: loss and grad
    norm within 1e-5. (Parameters are not compared after Adam: its first
    steps normalise fp-accumulation noise on zero-gradient directions up to
    ~lr, see tests/test_training.py.) The state stays the same tensors."""
    ref_cfg, cfg, _, _ = _pair("qwen2.5-3b")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, min_lr_ratio=1.0)
    jcfg, pcfg = jax_opt.OptimizerConfig(**kw), optimizer.OptimizerConfig(**kw)
    jstate = jax_steps.init_train_state(ref_cfg, jcfg, jax.random.PRNGKey(0))
    state = {"params": params_from_numpy(_np(jstate["params"]), "cpu")}
    state["opt"] = optimizer.adamw_init(pcfg, state["params"])
    jstep = jax.jit(jax_steps.make_train_step(ref_cfg, jcfg, microbatches=microbatches))
    step = steps.make_train_step(cfg, pcfg, microbatches=microbatches)
    embedding = state["params"]["embed"]["embedding"]
    for i in range(3):
        toks = _tokens(cfg, 10 + i, batch=4)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        for k in ("loss", "grad_norm", "total_loss", "tokens"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert state["params"]["embed"]["embedding"] is embedding
    assert int(state["opt"]["step"]) == 3


def test_microbatches_split_mrope_positions_on_their_batch_axis():
    """qwen2-vl with (3, B, S) M-RoPE positions whose rows differ: the
    2-microbatch step cuts them on axis 1, as the JAX ``split`` does."""
    ref_cfg, cfg, _, _ = _pair("qwen2-vl-72b")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg, pcfg = jax_opt.OptimizerConfig(**kw), optimizer.OptimizerConfig(**kw)
    jstate = jax_steps.init_train_state(ref_cfg, jcfg, jax.random.PRNGKey(0))
    state = {"params": params_from_numpy(_np(jstate["params"]), "cpu")}
    state["opt"] = optimizer.adamw_init(pcfg, state["params"])
    toks = _tokens(cfg, 4, batch=4)
    pos = (np.arange(16)[None, None, :] + np.arange(4)[None, :, None]
           + np.arange(3)[:, None, None]).astype(np.int32)  # (3, 4, 16)
    _, jm = jax.jit(jax_steps.make_train_step(ref_cfg, jcfg, microbatches=2))(
        jstate, {"tokens": jnp.asarray(toks), "mrope_positions": jnp.asarray(pos)})
    _, m = steps.make_train_step(cfg, pcfg, microbatches=2)(
        state, {"tokens": torch.from_numpy(toks), "mrope_positions": torch.from_numpy(pos)})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)


@pytest.fixture
def gloo_group(tmp_path):
    """A one-process gloo group (the default group) for this test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_dp_compressed_step_matches_jax_one_device(gloo_group):
    """The int8-compressed DP step on a one-process gloo group against
    make_dp_compressed_step on a one-device mesh: loss and grad norm within
    1e-5 over three steps, and the loss falls over five (the assertion of
    tests/test_training.py)."""
    ref_cfg, cfg, _, _ = _pair("qwen2.5-3b")
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=20, min_lr_ratio=1.0)
    jcfg, pcfg = jax_opt.OptimizerConfig(**kw), optimizer.OptimizerConfig(**kw)
    jstate = jax_steps.init_dp_state(ref_cfg, jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(_np(jstate["params"]), "cpu")
    state = {"params": params, "opt": optimizer.adamw_init(pcfg, params),
             "residuals": compression.init_residuals(params)}
    jstep = jax.jit(jax_steps.make_dp_compressed_step(ref_cfg, jcfg,
                                                      make_mesh((1,), ("data",))))
    step = steps.make_dp_compressed_step(cfg, pcfg)
    toks = _tokens(cfg, 1)
    losses = []
    for i in range(5):
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        losses.append(float(m["loss"]))
        if i < 3:
            jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert losses[-1] < losses[0]


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.training.compression import compress_allreduce
    rank, path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + path, rank=rank, world_size=2)
    rng = np.random.default_rng(rank)
    grads = {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
             "b": {"c": torch.from_numpy((rng.standard_normal(9) * (rank + 1)).astype(np.float32))}}
    res = {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32) * 0.01),
           "b": {"c": torch.zeros(9)}}
    red, new_res = compress_allreduce(grads, res)
    np.savez(out, a=red["a"].numpy(), c=red["b"]["c"].numpy(),
             ra=new_res["a"].numpy(), rc=new_res["b"]["c"].numpy())
    dist.destroy_process_group()
""")


def test_compress_allreduce_two_ranks_matches_numpy(tmp_path):
    """Two gloo processes reduce their own gradients: the result on each is
    the numpy reduction of both (shared scale, int8 payloads summed, /2),
    and each keeps its own error-feedback residual."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "pg"), str(tmp_path / f"r{r}.npz")],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    got = [np.load(tmp_path / f"r{r}.npz") for r in (0, 1)]
    xs = []
    for r in (0, 1):
        rng = np.random.default_rng(r)
        a = rng.standard_normal((5, 7)).astype(np.float32)
        c = (rng.standard_normal(9) * (r + 1)).astype(np.float32)
        ra = rng.standard_normal((5, 7)).astype(np.float32) * np.float32(0.01)
        xs.append({"a": a + ra, "c": c})
    for leaf in ("a", "c"):
        amax = max(np.abs(x[leaf]).max() for x in xs)
        scale = np.maximum(amax / np.float32(127.0), np.float32(1e-12)).astype(np.float32)
        qs = [np.clip(np.round(x[leaf] / scale), -127, 127) for x in xs]
        want = ((qs[0] + qs[1]).astype(np.float32) * scale) / np.float32(2)
        for r in (0, 1):
            np.testing.assert_allclose(got[r][leaf], want, rtol=1e-6, atol=0)
            np.testing.assert_allclose(got[r]["r" + leaf], xs[r][leaf] - qs[r] * scale,
                                       rtol=1e-6, atol=1e-7)


def test_quantize_int8_matches_jax():
    from repro.training import compression as jax_compression

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 9)).astype(np.float32)
    r = (rng.standard_normal((4, 9)) * 0.1).astype(np.float32)
    wq, ws, wr = jax_compression.quantize_int8(jnp.asarray(x), jnp.asarray(r))
    q, s, nr = compression.quantize_int8(torch.from_numpy(x), torch.from_numpy(r))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_allclose(float(s), float(ws), rtol=1e-7)
    np.testing.assert_allclose(nr.numpy(), np.asarray(wr), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(compression.dequantize(q, s).numpy(),
                               np.asarray(jax_compression.dequantize(wq, ws)), rtol=1e-7)


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-1.5-large-398b"])
def test_remat_policies_give_the_same_gradients_and_outputs(arch):
    """none, nothing_saveable and dots_saveable: equal gradients for every
    leaf, and the forward's outputs without a gradient are the same as
    with one."""
    import dataclasses

    _, cfg0, _, tp = _pair(arch)
    toks = torch.from_numpy(_tokens(cfg0, 5))
    leaves = T.leaves(tp)
    results = {}
    for policy in ("none", "nothing_saveable", "dots_saveable"):
        cfg = dataclasses.replace(cfg0, remat_policy=policy)
        for p in leaves:
            p.requires_grad_(True)
        total, _ = lm_loss(cfg, tp, {"tokens": toks})
        results[policy] = torch.autograd.grad(total, leaves)
        with torch.inference_mode():
            served = forward(cfg, tp, {"tokens": toks})[0]
        with torch.no_grad():
            np.testing.assert_array_equal(served.numpy(),
                                          forward(cfg0, tp, {"tokens": toks})[0].numpy())
    for policy in ("nothing_saveable", "dots_saveable"):
        for (key, _), g, w in zip(T.items(tp), results[policy], results["none"]):
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{policy} {key}")


# ---------------------------------------------------------------------------
# the plain attention backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,causal", [
    (2, 16, 16, 4, 2, 16, True),     # reduced serving shape, G 2
    (1, 24, 24, 4, 4, 16, True),     # G 1
    (1, 20, 20, 8, 2, 128, True),    # G 4, Dh 128
    (2, 12, 30, 4, 1, 16, False),    # cross attention, Sq != Sk, G 4
    (1, 33, 17, 2, 2, 128, False),   # Sq > Sk, non-causal
])
def test_plain_attention_backward_matches_autograd_and_jax(B, Sq, Sk, Hq, Hkv, Dh, causal):
    """ref.flash_attention_bwd (from the output and the plain log-sum-exp)
    against torch.autograd.grad through ref.flash_attention and jax.grad of
    flash_attention_ref, fp32: within 1e-5 * max(1, max|g|)."""
    rng = np.random.default_rng(Sq * Sk + Dh)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh),
                             (B, Sq, Hq, Dh)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ref.flash_attention(tq, tk, tv, causal=causal, block_q=8, block_k=8)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    with torch.no_grad():
        lse = ref.attention_lse(tq, tk, causal=causal)
        plain = ref.flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(do),
                                        causal=causal)
    attn = lambda a, b, c: jax_attention(a, b, c, causal=causal, block_q=8, block_k=8)  # noqa: E731
    want = jax.jit(lambda a, b, c, g: jax.vjp(attn, a, b, c)[1](g))(q, k, v, do)
    for name, p, a, w in zip("qkv", plain, auto, want):
        w = np.asarray(w)
        bound = 1e-5 * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(p.numpy() - w).max()) <= bound, f"d{name} vs jax"
        assert float(np.abs(a.numpy() - w).max()) <= bound, f"autograd d{name} vs jax"


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,causal", [
    (2, 20, 20, 2, 2, 16, True),     # G 1, ragged causal
    (1, 33, 33, 4, 2, 128, True),    # G 2, Dh 128, ragged causal
    (1, 20, 20, 8, 2, 16, True),     # G 4
    (1, 33, 33, 16, 1, 16, True),    # G 16, ragged causal
    (2, 12, 30, 4, 1, 128, False),   # G 4, Sq < Sk
    (1, 33, 17, 2, 2, 16, False),    # G 1, Sq > Sk
    (1, 20, 40, 16, 1, 128, False),  # G 16, Dh 128, Sq < Sk
])
def test_bf16_attention_backward_meets_the_bf16_bound(B, Sq, Sk, Hq, Hkv, Dh, causal):
    """ref.flash_attention_bwd_bf16 (the bf16 kernels' roundings: bf16
    operands, P and dS rounded to bf16 before their products, bf16
    gradients) on bf16-valued inputs, within 2e-2 * max|g| per output of
    jax.vjp of flash_attention_ref on the same values in fp32 and of
    ref.flash_attention_bwd in fp32."""
    rng = np.random.default_rng(7 * Sq + Sk + Dh)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .bfloat16().float().numpy()
                   for s in ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh),
                             (B, Sq, Hq, Dh)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out = ref.flash_attention(tq, tk, tv, causal=causal, block_q=8, block_k=8)
    lse = ref.attention_lse(tq, tk, causal=causal)
    got = ref.flash_attention_bwd_bf16(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(),
                                       out.bfloat16(), lse, tdo.bfloat16(), causal=causal)
    plain = ref.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal)
    attn = lambda a, b, c: jax_attention(a, b, c, causal=causal, block_q=8, block_k=8)  # noqa: E731
    want = jax.jit(lambda a, b, c, g: jax.vjp(attn, a, b, c)[1](g))(q, k, v, do)
    for name, g, p, w in zip("qkv", got, plain, want):
        w = np.asarray(w)
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        bound = 2e-2 * float(np.abs(w).max())
        g = g.float().numpy()
        assert float(np.abs(g - w).max()) <= bound, f"d{name} vs jax"
        assert float(np.abs(g - p.numpy()).max()) <= bound, f"d{name} vs the fp32 backward"


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    """The backward kernel's wrapper raises on CPU tensors, before it builds
    anything: it never falls back to the plain version."""
    from repro_torch.kernels import flash_attention_bwd as fab

    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    before = fab.launches
    with pytest.raises(ValueError, match="CUDA"):
        fab.flash_attention_bwd(q, k, k, q, torch.zeros(1, 4, 8), q, causal=True)
    assert fab.launches == before


def test_backward_kernel_parts_refuse_cpu_tensors():
    """Launching the bf16 kernels one by one raises on CPU tensors too,
    before it builds anything."""
    from repro_torch.kernels import flash_attention_bwd as fab

    q = torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 8)
    assert tuple(fab.new_scratch(q).shape) == (2, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fab.launch_parts(sum(fab.PARTS.values()), q, k, k, q, lse, q, fab.new_scratch(q),
                         q, k, k, causal=True)
