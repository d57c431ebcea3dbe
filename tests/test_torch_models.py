"""The port's forward (dense and Mamba2) against ``repro.models.forward``:
the JAX package's seeded weights are carried over through numpy
(``params_from_numpy``) and the same tokens go through both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.mamba2 import init_mamba as jax_init_mamba  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.mamba2 import init_mamba  # noqa: E402

DENSE = ["qwen2.5-3b", "qwen3-8b", "phi4-mini-3.8b"]  # qkv_bias, qk_norm, plain
PORTED = DENSE + ["mamba2-780m"]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _both(arch, seed=0, batch=2, seq=16, **overrides):
    """(port logits, JAX logits) as float32 numpy, same weights and tokens."""
    ref_cfg = REF_ARCHS[arch].reduced(**overrides)
    cfg = ARCHS[arch].reduced(**overrides)
    jparams = jax_init_params(ref_cfg, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    want, _ = jax_forward(ref_cfg, jparams, {"tokens": jnp.asarray(tokens)})
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    got, aux = forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    return got.numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_jax_fp32(arch):
    before = (fa.launches, ssd.launches)
    got, want = _both(arch)
    assert got.shape == want.shape == (2, 16, 256)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)  # tests/test_runtime.py:38
    assert (fa.launches, ssd.launches) == before  # CPU tensors never reach a kernel


def test_forward_matches_jax_bf16():
    # bf16 weights and compute; measured max |err| on this input: 2.4e-3
    # against logits up to 0.32 (bf16 rounds at other places in the two
    # frameworks' matmuls). fp32 archs measured 1.8e-7 to 1.2e-6.
    got, want = _both("qwen2.5-3b", param_dtype="bfloat16",
                      compute_dtype="bfloat16")
    np.testing.assert_allclose(got, want, atol=3e-2)


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
    want = _shapes(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(params) == want
    emb = params["embed"]["embedding"]
    assert float(emb.abs().max()) <= 0.02
    mixer = params["layers"]["sub0"]["mixer"]
    w_in = mixer["wq"] if "wq" in mixer else mixer["in_proj"]
    assert float(w_in.abs().max()) <= 1 / np.sqrt(cfg.d_model)
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    path = ("ffn", "wd") if "ffn" in params["layers"]["sub0"] else ("mixer", "out_proj")
    assert torch.equal(again["layers"]["sub0"][path[0]][path[1]],
                       params["layers"]["sub0"][path[0]][path[1]])


def test_bf16_leaves_convert_bit_exact():
    a = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32)).astype(jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-1.5-large-398b", "whisper-small",
                                  "qwen2-vl-72b"])
def test_unported_families_raise(arch):
    cfg = ARCHS[arch].reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        forward(cfg, {}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_init_params_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = ARCHS["qwen2.5-3b"].reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator().manual_seed(0))
