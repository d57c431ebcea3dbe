"""The port's forward (every family of the zoo) against
``repro.models.forward``: the JAX package's seeded weights are carried over
through numpy (``params_from_numpy``) and the same tokens (and encoder
embeddings, M-RoPE positions) go through both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.mamba2 import init_mamba as jax_init_mamba  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.mamba2 import init_mamba  # noqa: E402

PORTED = sorted(ARCHS)  # all ten: dense, MoE, M-RoPE, SSM, hybrid, encoder-decoder
MOE = ["olmoe-1b-7b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b"]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _batch(cfg, seed, batch, seq, enc_len=8, mrope=None):
    """Tokens (and whisper's encoder embeddings, M-RoPE positions) as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)}
    if cfg.is_encoder_decoder:
        out["encoder_embeds"] = rng.standard_normal((batch, enc_len, cfg.d_model),
                                                    dtype=np.float32)
    if mrope is not None:
        out["mrope_positions"] = mrope
    return out


def _run_both(arch, seed=0, batch=2, seq=16, mrope=None, **overrides):
    """(port (logits, aux), JAX (logits, aux)) as float32 numpy, same
    weights and inputs."""
    ref_cfg = REF_ARCHS[arch].reduced(**overrides)
    cfg = ARCHS[arch].reduced(**overrides)
    jparams = jax_init_params(ref_cfg, jax.random.PRNGKey(seed))
    inputs = _batch(cfg, seed, batch, seq, mrope=mrope)
    want, want_aux = jax_forward(ref_cfg, jparams,
                                 {k: jnp.asarray(v) for k, v in inputs.items()})
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    got, aux = forward(cfg, params, {k: torch.from_numpy(v) for k, v in inputs.items()})
    assert got.dtype == aux.dtype == torch.float32 and aux.shape == ()
    return ((got.numpy(), float(aux)),
            (np.asarray(want, np.float32), float(want_aux)))


def _both(arch, **kw):
    """(port logits, JAX logits); the aux losses agree within 1e-5."""
    (got, aux), (want, want_aux) = _run_both(arch, **kw)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
    return got, want


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_jax_fp32(arch):
    before = (fa.launches, ssd.launches)
    (got, aux), (want, want_aux) = _run_both(arch)
    assert got.shape == want.shape == (2, 16, 256)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)  # tests/test_runtime.py:38
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)  # the MoE aux loss, else 0
    assert (aux > 0) == (arch in MOE)
    assert (fa.launches, ssd.launches) == before  # CPU tensors never reach a kernel


def test_mrope_forward_with_distinct_streams_matches_jax():
    """qwen2-vl with M-RoPE positions whose three streams differ (a 2 x 4
    image grid after 4 text tokens, as the vision frontend would give): the
    bands follow their own stream in both packages, and the result is not
    the text-only forward's."""
    B, S = 2, 16
    t = np.concatenate([np.arange(4), np.full(8, 4), np.arange(5, 9)])
    h = np.concatenate([np.arange(4), 4 + np.repeat(np.arange(2), 4), np.arange(5, 9)])
    w = np.concatenate([np.arange(4), 4 + np.tile(np.arange(4), 2), np.arange(5, 9)])
    pos = np.broadcast_to(np.stack([t, h, w])[:, None, :], (3, B, S)).astype(np.int32)
    pos = pos + np.array([0, 1], np.int32)[None, :, None]  # rows differ too
    got, want = _both("qwen2-vl-72b", mrope=pos)
    np.testing.assert_allclose(got, want, atol=1e-4)
    plain, _ = _both("qwen2-vl-72b")
    assert np.abs(got - plain).max() > 1e-3


def test_whisper_encoder_depth_follows_its_own_stack():
    """``encoder_layers`` = 3 against 2 decoder layers: the encoder loop runs
    over its stack's own leading size (the reduced config has 2 of each, so
    it cannot tell the two apart)."""
    cfg = ARCHS["whisper-small"].reduced(encoder_layers=3)
    assert (cfg.encoder_layers, cfg.num_periods) == (3, 2)
    got, want = _both("whisper-small", encoder_layers=3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["enc_layers"]["sub0"]["mixer"]["wq"].shape[0] == 3
    assert params["layers"]["sub0"]["cross"]["wq"].shape[0] == 2


def _moe_inputs(arch, seed=0, S=16, ties=False):
    """A reduced MoE layer's params (JAX init, both packages) and input x."""
    ref_cfg, cfg = REF_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    jp = jax_layers.init_moe(ref_cfg, jax.random.PRNGKey(seed))
    if ties:  # experts 1 and 2 get the same router column: equal probabilities
        jp["router"] = jp["router"].at[:, 2].set(jp["router"][:, 1])
    x = np.random.default_rng(seed).standard_normal((2, S, cfg.d_model), dtype=np.float32)
    return ref_cfg, cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"), x


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("ties", [False, True])
def test_moe_choices_match_jax(arch, ties):
    """The chosen experts equal ``lax.top_k``'s over the reference's router
    (ties toward the lower index), and both ``moe_forward``s give the same
    output and aux loss on the same input."""
    ref_cfg, cfg, jp, p, x = _moe_inputs(arch, ties=ties)
    K = cfg.experts_per_token
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["router"]), axis=-1)
    _, want_idx = jax.lax.top_k(probs, K)
    got_probs, _, got_idx = layers.moe_route(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got_probs.numpy(), np.asarray(probs), atol=1e-6)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    if ties:  # the tie is exact, and it was cut: expert 2 never goes before expert 1
        assert bool((got_probs[..., 1] == got_probs[..., 2]).all())
        chose1, chose2 = (got_idx == 1).any(-1), (got_idx == 2).any(-1)
        assert not bool((chose2 & ~chose1).any())
        assert bool((chose1 & ~chose2).any())
    y, aux = layers.moe_forward(cfg, p, torch.from_numpy(x))
    jy, jaux = jax_layers.moe_forward(ref_cfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("capacity_factor", [0.25, 1.0, 4.0])
def test_moe_capacity_drops_match_jax(capacity_factor):
    """Tight capacities drop choices (the dropped tokens get nothing from
    that expert); the port drops exactly the reference's. The output moves
    away from the drop-free one exactly when an expert of a row was chosen
    more than C times."""
    ref_cfg, cfg, jp, p, x = _moe_inputs("olmoe-1b-7b", seed=3, S=32)
    y, _ = layers.moe_forward(cfg, p, torch.from_numpy(x), capacity_factor=capacity_factor)
    jy, _ = jax_layers.moe_forward(ref_cfg, jp, jnp.asarray(x),
                                   capacity_factor=capacity_factor)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    free, _ = layers.moe_forward(cfg, p, torch.from_numpy(x), capacity_factor=8.0)
    K, E = cfg.experts_per_token, cfg.num_experts
    C = max(K, int(np.ceil(K * 32 * capacity_factor / E)))
    load = torch.nn.functional.one_hot(layers.moe_route(cfg, p, torch.from_numpy(x))[2],
                                       E).sum(dim=(1, 2))  # (B, E)
    dropped = bool((y - free).abs().max() > 1e-6)
    assert dropped == bool((load > C).any())
    assert dropped == (capacity_factor < 4.0)  # this input overflows at 0.25 and 1.0


def test_forward_matches_jax_bf16():
    # bf16 weights and compute; measured max |err| on this input: 2.4e-3
    # against logits up to 0.32 (bf16 rounds at other places in the two
    # frameworks' matmuls). fp32 archs measured 1.8e-7 to 1.2e-6.
    got, want = _both("qwen2.5-3b", param_dtype="bfloat16",
                      compute_dtype="bfloat16")
    np.testing.assert_allclose(got, want, atol=3e-2)


def test_moe_forward_matches_jax_bf16():
    # bf16 weights and compute, reduced olmoe (router fp32); measured max
    # |err| on this input: 2.0e-2 against logits up to 2.4, where one bf16
    # step of the unembedding's output is 1.6e-2 (bf16 rounds at other
    # places in the two frameworks' matmuls and einsums); fp32
    # measured 1.4e-6. The aux loss: 4.6e-5 relative, since the router's
    # input is the bf16 residual stream, which differs as the logits do.
    (got, aux), (want, want_aux) = _run_both("olmoe-1b-7b", param_dtype="bfloat16",
                                             compute_dtype="bfloat16")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=3e-2)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-3)


def test_mamba_forward_matches_jax_bf16():
    # bf16 weights and compute, reduced mamba2-780m over 40 tokens (3 SSD
    # chunks, the last ragged); measured max |err| on this input: 9.8e-4
    # against logits up to 0.43 (bf16 rounds at other places in the two
    # frameworks' matmuls and in the conv/SSD casts); fp32 measured 2.0e-7
    got, want = _both("mamba2-780m", seq=40, param_dtype="bfloat16",
                      compute_dtype="bfloat16")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-2)


@pytest.mark.parametrize("reduced", [True, False])
def test_mamba_constants_equal_the_jax_init(reduced):
    """D and dt_bias equal the JAX values bit for bit; A_log = log(linspace)
    uses JAX's linspace arithmetic and is within one fp32 ulp of XLA's log
    (XLA's fp32 log is not correctly rounded, torch's is closer)."""
    cfg, ref_cfg = ARCHS["mamba2-780m"], REF_ARCHS["mamba2-780m"]
    if reduced:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    jm = jax_init_mamba(ref_cfg, jax.random.PRNGKey(0))
    m = init_mamba(cfg, torch.Generator().manual_seed(0), "cpu")
    for name in ("D", "dt_bias"):
        np.testing.assert_array_equal(m[name].numpy(), np.asarray(jm[name]))
    np.testing.assert_array_max_ulp(m["A_log"].numpy(), np.asarray(jm["A_log"]), maxulp=1)
    assert m["A_log"].dtype == m["D"].dtype == m["dt_bias"].dtype == torch.float32


@pytest.mark.parametrize("arch", PORTED)
def test_init_params_keeps_the_jax_layout(arch):
    """Same keys, shapes and dtypes as the JAX init (numbers differ: a
    torch.Generator is not a JAX key)."""
    cfg = ARCHS[arch].reduced()
    jparams = jax_init_params(REF_ARCHS[arch].reduced(), jax.random.PRNGKey(0))
    params = _same_layout(cfg, jparams)
    emb = params["embed"]["embedding"]
    assert float(emb.abs().max()) <= 0.02
    mixer = params["layers"]["sub0"]["mixer"]
    w_in = mixer["wq"] if "wq" in mixer else mixer["in_proj"]
    assert float(w_in.abs().max()) <= 1 / np.sqrt(cfg.d_model)
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    path = ("ffn", "wd") if "ffn" in params["layers"]["sub0"] else ("mixer", "out_proj")
    assert torch.equal(again["layers"]["sub0"][path[0]][path[1]],
                       params["layers"]["sub0"][path[0]][path[1]])


@pytest.mark.parametrize("arch", MOE)
def test_init_params_keeps_the_jax_layout_bf16(arch):
    """The same in bf16: every leaf bf16 but the MoE router, fp32 in both."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = ARCHS[arch].reduced(**over)
    jparams = jax_init_params(REF_ARCHS[arch].reduced(**over), jax.random.PRNGKey(0))
    params = _same_layout(cfg, jparams)
    moe = [s for s in params["layers"].values() if "router" in s.get("ffn", {})]
    assert moe and all(s["ffn"]["router"].dtype == torch.float32 for s in moe)
    assert all(s["ffn"]["wg"].dtype == torch.bfloat16 for s in moe)


def _same_layout(cfg, jparams):
    """The port's init of ``cfg`` has the keys, shapes and dtypes of the JAX
    params ``jparams``; returns it."""
    want = _shapes(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(params) == want
    return params


def test_bf16_leaves_convert_bit_exact():
    a = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32)).astype(jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))


def test_init_params_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = ARCHS["qwen2.5-3b"].reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator().manual_seed(0))
