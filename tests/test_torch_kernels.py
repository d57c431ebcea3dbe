"""Flash attention in the port: the plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) and its oracle, the ``ops``
dispatch on the CPU, and the kernel wrapper's input checks. Inputs are
drawn once with numpy and handed to both packages. The CUDA kernel's own
tests are in test_torch_cuda.py, which imports no JAX so that it runs on a
machine with the card."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models.layers import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# tests/test_kernels.py's sweep: B, Sq, Sk, Hq, Hkv, Dh, causal, bq, bk
SHAPES = [
    (2, 128, 128, 4, 2, 64, True, 64, 64),
    (1, 256, 256, 8, 2, 32, True, 128, 64),
    (2, 96, 96, 4, 4, 64, True, 64, 64),      # padding path
    (1, 128, 128, 4, 1, 128, False, 64, 128),  # MQA, non-causal
    (1, 64, 192, 2, 2, 64, False, 64, 64),     # cross-attention shape
    (1, 512, 512, 8, 8, 64, True, 256, 256),   # MHA larger blocks
]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    # tests/test_kernels.py: 3e-5 fp32, 2e-2 bf16 (one bf16 output ulp)
    return 2e-2 if dtype == "bfloat16" else 3e-5


def _inputs(B, Sq, Sk, Hq, Hkv, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, Dh), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, Dh), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, Dh), dtype=np.float32))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,causal,bq,bk", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(dtype, B, Sq, Sk, Hq, Hkv, Dh,
                                             causal, bq, bk):
    arrays = _inputs(B, Sq, Sk, Hq, Hkv, Dh)
    jq, jk, jv = [jnp.asarray(a).astype(dtype) for a in arrays]
    kernel = jax_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                       interpret=True)
    oracle = jax_flash_ref(jq, jk, jv, causal=causal, block_q=bq, block_k=bk)
    q, k, v = _torch(arrays, dtype)
    out = ref.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = _tol(dtype)
    np.testing.assert_allclose(_f32(out), _f32(kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(out), _f32(oracle), atol=tol, rtol=tol)


def test_ops_on_cpu_takes_plain_version_and_launches_nothing():
    q, k, v = _torch(_inputs(2, 48, 48, 4, 2, 16), "float32")
    before = fa.launches
    out = ops.flash_attention(q, k, v, causal=True)
    assert fa.launches == before
    np.testing.assert_array_equal(
        out.numpy(), ref.flash_attention(q, k, v, causal=True).numpy())
    out = ops.flash_attention(q, k, v, causal=True, use_kernel=False)
    assert fa.launches == before


def test_use_kernel_true_on_cpu_raises():
    q, k, v = _torch(_inputs(1, 16, 16, 4, 2, 16), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, use_kernel=True)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, use_kernel="interpret")


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("head_dim", "head_dim"),
    ("dtype", "dtype"),
    ("group", "multiple"),
])
def test_kernel_wrapper_refuses_what_it_does_not_take(case, match):
    """The wrapper raises before any build or launch; never falls back."""
    q, k, v = _torch(_inputs(1, 16, 16, 4, 2, 16), "float32")
    if case == "head_dim":
        q, k, v = _torch(_inputs(1, 16, 16, 4, 2, 24), "float32")
    elif case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "group":
        q, k, v = _torch(_inputs(1, 16, 16, 3, 2, 16), "float32")
    before = fa.launches
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v)
    assert fa.launches == before
