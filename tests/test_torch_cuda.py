"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is ``requires_cuda`` and skips without a card.
The file imports no JAX, so that it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m requires_cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# tests/test_kernels.py's sweep plus the serving shapes of qwen2.5-3b:
# B, Sq, Sk, Hq, Hkv, Dh, causal
SHAPES = [
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 2, 32, True),
    (2, 96, 96, 4, 4, 64, True),
    (1, 128, 128, 4, 1, 128, False),
    (1, 64, 192, 2, 2, 64, False),
    (1, 512, 512, 8, 8, 64, True),
    (1, 16, 16, 4, 2, 16, True),          # reduced serving shape
    (4, 1024, 1024, 16, 2, 128, True),    # full-width serving shape
    (1, 100, 100, 24, 8, 128, True),      # G=3 (phi4-mini), ragged tiles
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,causal", SHAPES)
def test_flash_kernel_matches_plain(cuda, dtype, B, Sq, Sk, Hq, Hkv, Dh, causal):
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda, dt)
               for s in ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh)))
    before = fa.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    plain = ops.flash_attention(q, k, v, causal=causal, use_kernel=False)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5  # tests/test_kernels.py
    np.testing.assert_allclose(out.float().cpu().numpy(), plain.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.requires_cuda
def test_flash_kernel_refuses_non_contiguous(cuda):
    q = torch.zeros((1, 16, 4, 16), device=cuda).transpose(1, 2)
    k = torch.zeros((1, 16, 2, 16), device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)
