"""The port's dense forward against ``repro.models.forward``: the JAX
package's seeded weights are carried over through numpy
(``params_from_numpy``) and the same tokens go through both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

DENSE = ["qwen2.5-3b", "qwen3-8b", "phi4-mini-3.8b"]  # qkv_bias, qk_norm, plain


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


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax_fp32(arch):
    before = fa.launches
    got, want = _both(arch)
    assert got.shape == want.shape == (2, 16, 256)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)  # tests/test_runtime.py:38
    assert fa.launches == before  # CPU tensors never reach the CUDA kernel


def test_forward_matches_jax_bf16():
    # bf16 weights and compute; measured max |err| on this input: 2.4e-3
    # against logits up to 0.32 (bf16 rounds at other places in the two
    # frameworks' matmuls). fp32 archs measured 1.8e-7 to 1.2e-6.
    got, want = _both("qwen2.5-3b", param_dtype="bfloat16",
                      compute_dtype="bfloat16")
    np.testing.assert_allclose(got, want, atol=3e-2)


@pytest.mark.parametrize("arch", DENSE)
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
    wq = params["layers"]["sub0"]["mixer"]["wq"]
    assert float(wq.abs().max()) <= 1 / np.sqrt(cfg.d_model)
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["layers"]["sub0"]["ffn"]["wd"],
                       params["layers"]["sub0"]["ffn"]["wd"])


def test_bf16_leaves_convert_bit_exact():
    a = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32)).astype(jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m", "whisper-small",
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
