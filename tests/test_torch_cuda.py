"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is ``requires_cuda`` and skips without a card.
The file imports no JAX, so that it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m requires_cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import ssd_scan_bwd as ssd_bwd  # noqa: E402

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
    # the tensor-core path's GQA packing and ragged 64-key tiles: G = 1, 3,
    # 8, 16; causal Sq = Sk = 200, non-causal Sk = 333
    (2, 200, 200, 2, 2, 64, True),
    (1, 200, 200, 6, 2, 128, True),
    (2, 200, 200, 16, 2, 128, True),
    (1, 200, 200, 16, 1, 32, True),
    (1, 200, 333, 2, 2, 64, False),
    (1, 200, 333, 6, 2, 128, False),
    (2, 200, 333, 16, 2, 128, False),
    (1, 200, 333, 16, 1, 16, False),
    # the serving shapes of the rest of the zoo, all MHA (G = 1): olmoe's
    # prefill; whisper's encoder (1500 frames: a ragged last 64-key tile),
    # its decoder prompt and its cross attention (Sq != Sk)
    (4, 1024, 1024, 16, 16, 128, True),
    (4, 1500, 1500, 12, 12, 64, False),
    (4, 128, 128, 12, 12, 64, True),
    (4, 128, 1500, 12, 12, 64, False),
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


# tests/test_kernels.py's decode sweep plus the serving shapes: B, L, Hq, Hkv, Dh
DECODE_SHAPES = [
    (2, 256, 4, 2, 64),
    (3, 300, 8, 8, 32),
    (1, 1024, 16, 2, 128),
    (4, 128, 8, 1, 64),
    (2, 28, 4, 2, 16),       # reduced serving shape (qwen2.5-3b, qwen3-8b)
    (4, 1056, 16, 2, 128),   # full-width qwen2.5-3b decode
    (2, 70, 24, 8, 128),     # G=3 (phi4-mini)
    (4, 1056, 16, 16, 128),  # full-width olmoe decode (MHA)
    (4, 160, 12, 12, 64),    # full-width whisper self decode (MHA)
]


def _decode_inputs(device, dtype, B, L, Hq, Hkv, Dh, seed=0):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device, dt)
               for s in ((B, 1, Hq, Dh), (B, L, Hkv, Dh), (B, L, Hkv, Dh)))
    lengths = torch.from_numpy(rng.integers(1, L + 1, (B,)).astype(np.int32)).to(device)
    return q, k, v, lengths


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,Hq,Hkv,Dh", DECODE_SHAPES)
def test_decode_kernel_matches_plain(cuda, dtype, B, L, Hq, Hkv, Dh):
    q, k, v, lengths = _decode_inputs(cuda, dtype, B, L, Hq, Hkv, Dh)
    before = dec.launches
    out = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    plain = ops.decode_attention(q, k, v, lengths, use_kernel=False)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5  # tests/test_kernels.py
    np.testing.assert_allclose(out.float().cpu().numpy(), plain.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_the_whisper_cross_shape(cuda, dtype):
    """whisper's cross decode: every row attends over all 1500 encoder
    frames (every length is the cache's), MHA, Dh 64."""
    B, L, Hq, Hkv, Dh = 4, 1500, 12, 12, 64
    q, k, v, _ = _decode_inputs(cuda, dtype, B, L, Hq, Hkv, Dh)
    lengths = torch.full((B,), L, dtype=torch.int32, device=cuda)
    before = dec.launches
    out = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    plain = ops.decode_attention(q, k, v, lengths, use_kernel=False)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5  # tests/test_kernels.py
    np.testing.assert_allclose(out.float().cpu().numpy(), plain.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.requires_cuda
def test_decode_kernel_reads_a_period_view_and_gives_zero_at_length_zero(cuda):
    """The [period] view of a stacked cache is read in place; length 0
    gives 0 (the TPU kernel's answer), other rows are unaffected."""
    q, k, v, lengths = _decode_inputs(cuda, "float32", 3, 40, 4, 2, 32)
    stacked_k = torch.zeros((2, *k.shape), device=cuda)
    stacked_v = torch.zeros((2, *v.shape), device=cuda)
    stacked_k[1], stacked_v[1] = k, v
    lengths[1] = 0
    out = ops.decode_attention(q, stacked_k[1], stacked_v[1], lengths)
    plain = ops.decode_attention(q, k, v, lengths, use_kernel=False)
    assert float(out[1].abs().max()) == 0.0
    np.testing.assert_allclose(out[[0, 2]].cpu().numpy(), plain[[0, 2]].cpu().numpy(),
                               atol=3e-5, rtol=3e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split", [None, 1, 2, 5])
def test_decode_kernel_split_edges(cuda, dtype, n_split, monkeypatch):
    """Lengths 1, 64k, 64k + 1 and L, and 0 (output 0), with the card's
    number of splits and with fixed ones (1 = no split, 2 = runs of three
    tiles, 5 = one tile each): a split wholly past a length weighs nothing
    in the merge."""
    if n_split is not None:
        monkeypatch.setattr(dec, "num_splits", lambda *args: n_split)
    B, L, Hq, Hkv, Dh = 7, 300, 8, 2, 64
    q, k, v, _ = _decode_inputs(cuda, dtype, B, L, Hq, Hkv, Dh)
    lengths = torch.tensor([1, 64, 65, 128, 129, L, 0], dtype=torch.int32, device=cuda)
    before = dec.launches
    out = dec.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    assert float(out[-1].float().abs().max()) == 0.0
    plain = ops.decode_attention(q, k, v, lengths, use_kernel=False)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5  # tests/test_kernels.py
    np.testing.assert_allclose(out[:-1].float().cpu().numpy(),
                               plain[:-1].float().cpu().numpy(), atol=tol, rtol=tol)


# tests/test_kernels.py's SSD sweep plus the serving shapes: B, S, H, P, N, chunk
SSD_SHAPES = [
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 32, 64, 32),
    (2, 100, 3, 16, 32, 32),      # padding path
    (1, 256, 8, 64, 128, 64),
    (1, 16, 8, 16, 16, 16),       # reduced mamba2-780m serving shape
    (4, 1024, 48, 64, 128, 128),  # full-width mamba2-780m prefill
    (2, 10, 2, 16, 16, 16),       # S shorter than the chunk
    # the bf16 route's edges: a ragged last chunk of 72 rows, S < chunk with
    # jamba's P = 128, a chunk (10) that is not a multiple of 16
    (1, 200, 4, 64, 128, 128),
    (2, 40, 2, 128, 128, 64),
    (2, 45, 3, 32, 48, 10),
]


def _ssd_inputs(device, dtype, B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    dt_ = getattr(torch, dtype)
    t = lambda a, d=dt_: torch.from_numpy(a.astype(np.float32)).to(device, d)  # noqa: E731
    x = t(rng.standard_normal((B, S, H, P)))
    dt = t(np.log1p(np.exp(rng.standard_normal((B, S, H)))), torch.float32)
    A = t(-np.exp(rng.standard_normal(H) * 0.3), torch.float32)
    Bm, Cm = t(rng.standard_normal((B, S, N))), t(rng.standard_normal((B, S, N)))
    return x, dt, A, Bm, Cm


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, dtype, B, S, H, P, N, chunk):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, dtype, B, S, H, P, N)
    before = ssd.launches
    y, fs = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape and fs.dtype == torch.float32
    yp, fsp = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, use_kernel=False)
    tol = 3e-2 if dtype == "bfloat16" else 1e-3  # tests/test_kernels.py
    np.testing.assert_allclose(y.float().cpu().numpy(), yp.float().cpu().numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(fs.cpu().numpy(), fsp.cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_initial_state_and_strided_views(cuda, dtype):
    """initial_state continues a scan, and x/B/C may be slices of one fused
    tensor, as in the Mamba2 block (rows of 128 elements, B at 64: 16-byte
    aligned for the bf16 route)."""
    B, S, H, P, N = 2, 48, 4, 16, 32
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, dtype, B, S, H, P, N)
    fused = torch.cat([x.reshape(B, S, H * P), Bm, Cm], dim=-1)
    xv, Bv, Cv = torch.split(fused, [H * P, N, N], dim=-1)
    s0 = torch.randn((B, H, P, N), device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    before = ssd.launches
    y, fs = ops.ssd_scan(xv.reshape(B, S, H, P), dt, A, Bv, Cv, chunk=16, initial_state=s0)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    yp, fsp = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16, initial_state=s0, use_kernel=False)
    tol = 3e-2 if dtype == "bfloat16" else 1e-3  # tests/test_kernels.py
    np.testing.assert_allclose(y.float().cpu().numpy(), yp.float().cpu().numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(fs.cpu().numpy(), fsp.cpu().numpy(), atol=tol, rtol=tol)


# The bf16 route's four kernels, each against its plain piece on the same
# inputs (bf16 shapes of SSD_SHAPES: ragged chunks, S < chunk, chunk 10).
SSD_PIECE_SHAPES = [(2, 64, 4, 16, 16, 16), (2, 100, 3, 16, 32, 32), (1, 256, 8, 64, 128, 64),
                    (2, 10, 2, 16, 16, 16), (1, 200, 4, 64, 128, 128),
                    (2, 40, 2, 128, 128, 64), (2, 45, 3, 32, 48, 10)]


def _block_lower(T):
    """The (T, T) mask of the 16 x 16 blocks on or below the diagonal."""
    blk = torch.arange(T) // 16
    return blk[:, None] >= blk[None, :]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_PIECE_SHAPES)
def test_ssd_chunk_cb_kernel_matches_plain(cuda, B, S, H, P, N, chunk):
    """C B^T from exact bf16 operands with fp32 sums: only the order of the
    sums differs, so fp32's 1e-4 (|CB| is ~sqrt(N) <= 12) holds."""
    _, _, _, Bm, Cm = _ssd_inputs(cuda, "bfloat16", B, S, H, P, N)
    cb = ssd.chunk_cb(Bm, Cm, chunk=chunk)
    plain = ref.ssd_chunk_cb(Bm, Cm, chunk=chunk)
    T = plain.shape[-1]
    got = cb[..., :T, :T]
    mask = _block_lower(T).to(cuda)
    assert not cb[..., ~_block_lower(cb.shape[-1]).to(cuda)].any()  # never written
    np.testing.assert_allclose(got[..., mask].cpu().numpy(), plain[..., mask].cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_PIECE_SHAPES)
def test_ssd_chunk_state_kernel_matches_plain(cuda, B, S, H, P, N, chunk):
    """The chunk states with x exact and dt w B as hi + lo bf16 (each
    product within ~2^-16 of fp32's) and fp32 sums: fp32's 1e-3; the
    decays exp(cs_last) come from the same cumsum in another order."""
    x, dt, A, Bm, _ = _ssd_inputs(cuda, "bfloat16", B, S, H, P, N)
    states, decay = ssd.chunk_state(x, dt, A, Bm, chunk=chunk)
    ps, pd = ref.ssd_chunk_state(x, dt, A, Bm, chunk=chunk)
    np.testing.assert_allclose(states.cpu().numpy(), ps.cpu().numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(decay.cpu().numpy(), pd.permute(0, 2, 1).cpu().numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_PIECE_SHAPES)
def test_ssd_state_pass_kernel_matches_plain(cuda, B, S, H, P, N, chunk, with_init):
    """The recurrence in fp32 with the plain version's two roundings per
    chunk (s * decay, then + S_c): equal up to fp32 rounding."""
    x, dt, A, Bm, _ = _ssd_inputs(cuda, "bfloat16", B, S, H, P, N)
    ps, pd = ref.ssd_chunk_state(x, dt, A, Bm, chunk=chunk)
    s0 = (torch.randn((B, H, P, N), device=cuda,
                      generator=torch.Generator(cuda).manual_seed(0)) if with_init else None)
    entering, fs = ps.clone(), torch.empty((B, H, P, N), device=cuda)
    ssd.pass_states(entering, pd.permute(0, 2, 1).contiguous(), s0, fs)
    pe, pfs = ref.ssd_state_pass(ps, pd, s0)
    np.testing.assert_allclose(entering.cpu().numpy(), pe.cpu().numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(fs.cpu().numpy(), pfs.cpu().numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_PIECE_SHAPES)
def test_ssd_chunk_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk):
    """y from the plain C B^T and entering states, with C and x exact and
    the state and M as hi + lo bf16: the bf16 criterion of
    tests/test_kernels.py (y is rounded to bf16)."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, "bfloat16", B, S, H, P, N)
    cb = ref.ssd_chunk_cb(Bm, Cm, chunk=chunk)
    ps, pd = ref.ssd_chunk_state(x, dt, A, Bm, chunk=chunk)
    s0 = torch.randn((B, H, P, N), device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    entering, _ = ref.ssd_state_pass(ps, pd, s0)
    T = cb.shape[-1]
    pad = -T % 16
    y = ssd.chunk_scan(x, dt, A, Cm, torch.nn.functional.pad(cb, (0, pad, 0, pad)), entering,
                       chunk=chunk)
    plain = ref.ssd_chunk_scan(x, dt, A, Cm, cb, entering, chunk=chunk)
    np.testing.assert_allclose(y.float().cpu().numpy(), plain.float().cpu().numpy(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.requires_cuda
def test_new_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, lengths = _decode_inputs(cuda, "float32", 2, 32, 4, 2, 16)
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention(q, k, v, lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, lengths)
    shifted = torch.zeros(k.numel() + 1, device=cuda)[1:].reshape(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ops.decode_attention(q, shifted, v, lengths)
    shifted = torch.zeros(k.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q.bfloat16(), shifted.reshape(k.shape), v.bfloat16())
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, "float32", 1, 32, 2, 16, 16)
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_scan(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(ValueError, match="shared memory"):
        ops.ssd_scan(*_ssd_inputs(cuda, "float32", 1, 512, 1, 128, 256), chunk=512)
    # the bf16 route: P and N multiples of 16 up to 128, chunk up to 128,
    # x/B/C 16-byte aligned
    for shape, chunk in (((1, 32, 2, 24, 16), 16), ((1, 32, 2, 16, 256), 16),
                         ((1, 256, 2, 16, 16), 256)):
        with pytest.raises(ValueError, match="bf16 SSD scan"):
            ops.ssd_scan(*_ssd_inputs(cuda, "bfloat16", *shape), chunk=chunk)
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, "bfloat16", 1, 32, 2, 16, 16)
    shifted = torch.zeros(Bm.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        ops.ssd_scan(x, dt, A, shifted.reshape(Bm.shape), Cm, chunk=16)


def _reduced_qwen(device, seed=1):
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params

    cfg = ARCHS["qwen2.5-3b"].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, params, {k: _to(v, device) for k, v in params.items()}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.requires_cuda
def test_decode_past_the_cache_drops_the_write_on_the_card(cuda):
    """decode_step at position L (cache full) on the card: no device-side
    assert, the write is dropped (the cache is unchanged), the logits are
    the CPU path's within 3e-5 (fp32), and a normal step afterwards still
    runs and agrees, so the CUDA context is not poisoned."""
    from repro_torch.models import decode_step, init_cache, prefill

    cfg, params, cparams = _reduced_qwen(cuda)
    B, max_len = 2, 4
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, max_len), dtype=np.int32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32))
    caches = {}
    for dev, p in (("cpu", params), ("card", cparams)):
        d = cuda if dev == "card" else dev
        _, caches[dev], _ = prefill(cfg, p, {"tokens": prompt.to(d)},
                                    init_cache(cfg, B, max_len, device=d))
    before = {k: {n: t.clone() for n, t in e.items()} for k, e in caches["card"].items()}
    pos = torch.full((B,), max_len, dtype=torch.int32)
    want, _ = decode_step(cfg, params, nxt, pos, caches["cpu"])
    got, _ = decode_step(cfg, cparams, nxt.to(cuda), pos.to(cuda), caches["card"])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=3e-5, rtol=0)
    for key, entry in caches["card"].items():
        for name, leaf in entry.items():
            assert torch.equal(leaf, before[key][name]), (key, name)
    pos = torch.tensor([max_len - 1, 1], dtype=torch.int32)  # in range: written
    want, _ = decode_step(cfg, params, nxt, pos, caches["cpu"])
    got, _ = decode_step(cfg, cparams, nxt.to(cuda), pos.to(cuda), caches["card"])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=3e-5, rtol=0)
    np.testing.assert_allclose(caches["card"]["sub0"]["k"].cpu().numpy(),
                               caches["cpu"]["sub0"]["k"].numpy(), atol=3e-5, rtol=0)
    assert not torch.equal(caches["card"]["sub0"]["k"], before["sub0"]["k"])


@pytest.mark.requires_cuda
def test_gateway_serves_on_the_card(cuda):
    """Gateway(backend="runtime", device="cuda"): a cold and a warm invoke
    of the reduced qwen2.5-3b launch flash attention once per layer each,
    besides the one context build's warm-up forward (counted apart), and
    the served output equals the direct forward on the card."""
    from repro_torch.api import FunctionSpec, Gateway
    from repro_torch.configs import ARCHS
    from repro_torch.core import functions
    from repro_torch.models import forward

    cfg = ARCHS["qwen2.5-3b"].reduced()
    with Gateway(backend="runtime", policy="sage", time_scale=0.02, device="cuda") as gw:
        gw.register(FunctionSpec(name="demo", arch="qwen2.5-3b", profile="resnet50"))
        before, ctx = fa.launches, functions.context_launches[fa.NAME]
        cold, warm = gw.invoke("demo", seed=0), gw.invoke("demo", seed=1)
        ctx = functions.context_launches[fa.NAME] - ctx
        assert ctx == functions.warmup_launches(cfg)[fa.NAME]
        assert fa.launches - before - ctx == 2 * cfg.num_layers
        db = gw.runtime.db
        assert db.device.type == "cuda"
        assert cold.warm_stage is None and warm.warm_stage == 1
        assert gw.runtime.daemon.stats["shared_hits"] >= 1
        weights = db.to_device(db.fetch("demo/weights"))
        with torch.inference_mode():
            for rec in (cold, warm):
                toks = db.fetch(f"demo/in/{rec.request_id}").to(cuda)
                direct = forward(cfg, weights, {"tokens": toks})[0][:, -1, :8].float().cpu()
                np.testing.assert_array_equal(db.fetch(rec.result), direct.numpy())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b", "whisper-small", "qwen2-vl-72b"])
def test_zoo_reduced_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced MoE, hybrid, encoder-decoder and M-RoPE configs in fp32:
    the forward on the card (K1, and K3 for jamba) against the CPU's plain
    path within 1e-4, and for whisper prefill + 4 decode steps (K1, K2 on
    the self and the cross cache) within 3e-5 of the CPU's steps."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, forward, init_cache, init_params, prefill

    cfg = ARCHS[arch].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    cparams = _to(params, cuda)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16),
                                                     dtype=np.int32))}
    if cfg.is_encoder_decoder:
        batch["encoder_embeds"] = torch.from_numpy(
            rng.standard_normal((2, 12, cfg.d_model), dtype=np.float32))
    cbatch = _to(batch, cuda)
    before = fa.launches
    with torch.inference_mode():
        got, aux = forward(cfg, cparams, cbatch)
        want, want_aux = forward(cfg, params, batch)
    torch.cuda.synchronize()
    assert fa.launches - before == cfg.num_attn_layers + (
        cfg.encoder_layers + cfg.num_layers if cfg.is_encoder_decoder else 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    if not cfg.is_encoder_decoder:
        return
    with torch.inference_mode():
        caches = {d: init_cache(cfg, 2, 20, 12, device=d) for d in ("cpu", cuda)}
        lg = {"cpu": prefill(cfg, params, batch, caches["cpu"])[0],
              cuda: prefill(cfg, cparams, cbatch, caches[cuda])[0]}
        before = dec.launches
        for t in range(16, 20):
            nxt = lg["cpu"].argmax(-1).to(torch.int32)[:, None]
            pos = torch.full((2,), t, dtype=torch.int32)
            lg = {"cpu": decode_step(cfg, params, nxt, pos, caches["cpu"])[0],
                  cuda: decode_step(cfg, cparams, nxt.to(cuda), pos.to(cuda), caches[cuda])[0]}
            np.testing.assert_allclose(lg[cuda].cpu().numpy(), lg["cpu"].numpy(),
                                       atol=3e-5, rtol=0)
    assert dec.launches - before == 4 * 2 * cfg.num_layers  # self + cross per layer


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-small", "olmoe-1b-7b",
                                  "llama4-maverick-400b-a17b", "jamba-1.5-large-398b"])
def test_decode_step_never_waits_for_the_card(cuda, arch):
    """A decode step of the reduced M-RoPE, encoder-decoder, MoE and hybrid
    configs only queues work on the stream: under
    ``torch.cuda.set_sync_debug_mode("error")`` anything that makes the host
    wait for the card (a copy from pageable host memory, ``.item()``, a
    shape that depends on the data) raises. The first step, which builds
    and loads the kernels, runs before the mode is set."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    cfg = ARCHS[arch].reduced()
    params = _to(init_params(cfg, torch.Generator().manual_seed(1), "cpu"), cuda)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16),
                                                     dtype=np.int32))}
    enc_len = 12 if cfg.is_encoder_decoder else 0
    if enc_len:
        batch["encoder_embeds"] = torch.from_numpy(
            rng.standard_normal((2, enc_len, cfg.d_model), dtype=np.float32))
    batch = _to(batch, cuda)
    positions = [torch.full((2,), t, dtype=torch.int32, device=cuda) for t in range(16, 20)]
    with torch.inference_mode():
        cache = init_cache(cfg, 2, 20, enc_len, device=cuda)
        logits = prefill(cfg, params, batch, cache)[0]
        logits = decode_step(cfg, params, logits.argmax(-1, keepdim=True).to(torch.int32),
                             positions[0], cache)[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for pos in positions[1:]:
                tok = logits.argmax(-1, keepdim=True).to(torch.int32)
                logits = decode_step(cfg, params, tok, pos, cache)[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# training: K1's backward, K3's guard, train steps on the card
# ---------------------------------------------------------------------------


def _grad_tol(dtype, want):
    """1e-4 * max(1, max|g|) for fp32, 2e-2 * max|g| for bf16, per output."""
    m = want.float().abs().max().item()
    return 2e-2 * m if dtype == torch.bfloat16 else 1e-4 * max(1.0, m)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,causal", SHAPES)
def test_flash_backward_kernel_matches_plain(cuda, dtype, B, Sq, Sk, Hq, Hkv, Dh, causal):
    """K1 under autograd: the forward kernel's log-sum-exp against the plain
    one, and the backward kernel's dq, dk, dv against
    ``ref.flash_attention_bwd`` on the same q, k, v, output and dO."""
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda, dt)
                   for s in ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh),
                             (B, Sq, Hq, Dh)))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (fa.launches, fab.launches)
    out = ops.flash_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.launches, fab.launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        plain_out = ops.flash_attention(q, k, v, causal=causal, use_kernel=False)
        tol = 2e-2 if dtype == "bfloat16" else 3e-5
        assert (out.float() - plain_out.float()).abs().max().item() <= tol * (
            1 + plain_out.float().abs().max().item())
        lse = ref.attention_lse(q, k, causal=causal)
        _, got_lse = fa._forward(q, k, v, causal, 1.0 / Dh ** 0.5, with_lse=True)
        assert (got_lse - lse).abs().max().item() <= 1e-4 * (1 + lse.abs().max().item())
        want = ref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    for name, g, w in zip("qkv", grads, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _grad_tol(dt, w), f"d{name}: {err}"
        assert w.float().abs().max().item() > 0


def _bwd_inputs(device, dtype, B, Sq, Sk, Hq, Hkv, Dh, causal, seed=0):
    """q, k, v, dO from a seed; the forward kernel's output and lse."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device, dtype)
                   for s in ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh),
                             (B, Sq, Hq, Dh)))
    o, lse = fa._forward(q, k, v, causal, 1.0 / Dh ** 0.5, with_lse=True)
    return q, k, v, o, lse, do


#: the bf16 kernels against ref.flash_attention_bwd_bf16 (the same
#: roundings), per output: BF16_SAME_ROUNDING_TOL * max|g|
BF16_SAME_ROUNDING_TOL = 1e-2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,causal", SHAPES)
def test_flash_backward_bf16_kernel_matches_its_roundings(cuda, B, Sq, Sk, Hq, Hkv, Dh, causal):
    """The bf16 route against ``ref.flash_attention_bwd_bf16`` on the same
    q, k, v, output, lse and dO: the same roundings of P and dS, so a
    tighter bound than the 2e-2 against the fp32 backward."""
    args = _bwd_inputs(cuda, torch.bfloat16, B, Sq, Sk, Hq, Hkv, Dh, causal)
    grads = fab.flash_attention_bwd(*args, causal=causal)
    want = ref.flash_attention_bwd_bf16(*args, causal=causal)
    for name, g, w in zip("qkv", grads, want):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BF16_SAME_ROUNDING_TOL * w.float().abs().max().item(), f"d{name}: {err}"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,causal", SHAPES)
def test_flash_backward_bf16_is_deterministic_and_its_parts_compose(
        cuda, B, Sq, Sk, Hq, Hkv, Dh, causal):
    """Two bf16 backward calls give the same bits (no atomics), and the D,
    dK/dV and dQ kernels launched one by one give those bits too."""
    args = _bwd_inputs(cuda, torch.bfloat16, B, Sq, Sk, Hq, Hkv, Dh, causal)
    first = fab.flash_attention_bwd(*args, causal=causal)
    second = fab.flash_attention_bwd(*args, causal=causal)
    scratch = fab.new_scratch(args[0])
    parts = tuple(torch.empty_like(t) for t in first)
    before = fab.launches
    for bit in fab.PARTS.values():
        fab.launch_parts(bit, *args, scratch, *parts, causal=causal)
    torch.cuda.synchronize()
    assert fab.launches == before
    for name, a, b, c in zip("qkv", first, second, parts):
        assert torch.equal(a, b), f"d{name} differs between two calls"
        assert torch.equal(a, c), f"d{name} differs when the kernels run one by one"


# the edges of what the backward takes: G = 64 and 32, causal with Sq != Sk
# (top-left: keys past Sq see no row; rows past Sk see every key), one
# query, two keys (one key would make dq and dk zero but for rounding)
EDGE_SHAPES = [
    (1, 3, 70, 64, 1, 16, True),
    (1, 70, 3, 64, 1, 128, True),
    (2, 65, 130, 32, 1, 64, True),
    (1, 130, 65, 8, 1, 128, True),
    (2, 1, 2, 4, 2, 32, False),
    (1, 1, 77, 64, 1, 64, False),
    (3, 97, 2, 2, 1, 16, True),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,causal", EDGE_SHAPES)
def test_flash_backward_kernel_at_the_edges_of_what_it_takes(
        cuda, dtype, B, Sq, Sk, Hq, Hkv, Dh, causal):
    """Both routes against ``ref.flash_attention_bwd`` (the plain
    log-sum-exp) at the edge shapes, bf16 also against its own roundings."""
    dt = getattr(torch, dtype)
    args = _bwd_inputs(cuda, dt, B, Sq, Sk, Hq, Hkv, Dh, causal)
    q, k, v, o, _, do = args
    grads = fab.flash_attention_bwd(*args, causal=causal)
    lse = ref.attention_lse(q, k, causal=causal)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for name, g, w in zip("qkv", grads, want):
        assert bool(torch.isfinite(g).all()), f"d{name} not finite"
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _grad_tol(dt, w), f"d{name}: {err}"
    if dt == torch.bfloat16:
        for name, g, w in zip("qkv", grads, ref.flash_attention_bwd_bf16(*args, causal=causal)):
            err = (g.float() - w.float()).abs().max().item()
            assert err <= BF16_SAME_ROUNDING_TOL * w.float().abs().max().item(), f"d{name}"


@pytest.mark.requires_cuda
def test_flash_backward_parts_take_only_bf16(cuda):
    q = torch.zeros((1, 16, 4, 16), device=cuda)
    k = torch.zeros((1, 16, 2, 16), device=cuda)
    lse = torch.zeros((1, 4, 16), device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        fab.launch_parts(2, q, k, k, q, lse, q, fab.new_scratch(q), q, k, k, causal=True)


@pytest.mark.requires_cuda
def test_flash_backward_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 16, 4, 16), device=cuda)
    k = torch.zeros((1, 16, 2, 16), device=cuda)
    lse = torch.zeros((1, 4, 16), device=cuda)
    for bad in (dict(lse=torch.zeros((1, 16, 4), device=cuda)),
                dict(lse=lse.double()),
                dict(do=torch.zeros((1, 16, 4, 8), device=cuda)),
                dict(do=q.bfloat16()),
                dict(do=torch.zeros((1, 4, 16, 16), device=cuda).transpose(1, 2)),
                dict(q=q.cpu())):
        args = {**dict(q=q, k=k, v=k, o=q, lse=lse, do=q), **bad}
        with pytest.raises(ValueError):
            fab.flash_attention_bwd(**args, causal=True)


# K3's backward: the sweep of tests/test_torch_ssd_bwd.py plus the reduced
# and full-width mamba2-780m training shapes and the bf16 route's edges
SSD_BWD_SHAPES = [
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 32, 64, 32),
    (2, 100, 3, 16, 32, 32),      # a ragged last chunk
    (1, 256, 8, 64, 128, 64),
    (2, 10, 2, 16, 16, 16),       # S < chunk
    (2, 40, 2, 128, 128, 64),     # jamba's P = 128, S < chunk
    (2, 45, 3, 32, 48, 10),       # chunk 10
    (1, 200, 4, 64, 128, 128),    # a ragged last chunk of 72 rows
    (2, 16, 8, 16, 16, 16),       # reduced mamba2-780m
    (4, 1024, 48, 64, 128, 128),  # full-width mamba2-780m training
]
SSD_BWD_TOL = {"float32": 1e-3, "bfloat16": 3e-2}  # * max|g|, tests/test_kernels.py


def _ssd_bwd_args(device, dtype, B, S, H, P, N, with_init=True, seed=0):
    """The forward's inputs, an initial state (or None), dy and a nonzero
    dfinal_state, from a seed."""
    x, dt, A, Bm, Cm = _ssd_inputs(device, dtype, B, S, H, P, N, seed)
    rng = np.random.default_rng(seed + 1)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)  # noqa: E731
    s0 = f32(B, H, P, N) if with_init else None
    dy = f32(B, S, H, P).to(x.dtype)
    return x, dt, A, Bm, Cm, s0, dy, f32(B, H, P, N)


def _close_grads(got, want, tol):
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bound = tol * w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= bound and torch.isfinite(g.float()).all(), f"{name}: {err} > {bound}"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_BWD_SHAPES)
def test_ssd_backward_kernel_matches_plain(cuda, dtype, with_init, B, S, H, P, N, chunk):
    """csrc/ssd_scan_bwd.cu against ref.ssd_scan_bwd on the same inputs,
    per gradient within 1e-3 (fp32) or 3e-2 (bf16) * max|g|; one count."""
    args = _ssd_bwd_args(cuda, dtype, B, S, H, P, N, with_init)
    before = ssd_bwd.launches
    got = ssd_bwd.ssd_scan_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_bwd.launches == before + 1
    _close_grads(got, ref.ssd_scan_bwd(*args, chunk=chunk), SSD_BWD_TOL[dtype])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_kernel_reads_strided_views_and_is_deterministic(cuda, dtype):
    """x, B and C as slices of one fused tensor (the Mamba2 block's layout)
    give the gradients of contiguous inputs, and two calls give the same
    bits; a zero dfinal_state may be None."""
    B, S, H, P, N, chunk = 2, 100, 4, 16, 32, 32
    x, dt, A, Bm, Cm, s0, dy, dfs = _ssd_bwd_args(cuda, dtype, B, S, H, P, N)
    fused = torch.cat([x.reshape(B, S, H * P), Bm, Cm], dim=-1)
    xv, Bv, Cv = torch.split(fused, [H * P, N, N], dim=-1)
    got = ssd_bwd.ssd_scan_bwd(xv.reshape(B, S, H, P), dt, A, Bv, Cv, s0, dy, dfs, chunk=chunk)
    assert all(g.is_contiguous() for g in got)
    _close_grads(got, ref.ssd_scan_bwd(x, dt, A, Bm, Cm, s0, dy, dfs, chunk=chunk),
                 SSD_BWD_TOL[dtype])
    again = ssd_bwd.ssd_scan_bwd(xv.reshape(B, S, H, P), dt, A, Bv, Cv, s0, dy, dfs,
                                 chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    none = ssd_bwd.ssd_scan_bwd(x, dt, A, Bm, Cm, s0, dy, None, chunk=chunk)
    zero = ssd_bwd.ssd_scan_bwd(x, dt, A, Bm, Cm, s0, dy, torch.zeros_like(dfs), chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(none, zero))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_parts_compose(cuda, dtype):
    """Each route's kernels and its two state passes launched one at a time
    (``launch_parts`` over ``PARTS``, as chip_smoke.py times them) give the
    whole call's bits; buffers of another shape, and a kernel of the other
    route, are refused."""
    B, S, H, P, N, chunk = 2, 100, 3, 16, 32, 32
    x, dt, A, Bm, Cm, _, dy, _ = _ssd_bwd_args(cuda, dtype, B, S, H, P, N, with_init=False)
    whole = ssd_bwd.ssd_scan_bwd(x, dt, A, Bm, Cm, None, dy, None, chunk=chunk)
    bufs = ssd_bwd.new_buffers(x, Bm, chunk)
    for name in ssd_bwd.PARTS[x.dtype]:
        ssd_bwd.launch_parts(name, x, dt, A, Bm, Cm, dy, bufs, chunk=chunk)
    parts = [bufs[k] for k in ("dx", "ddt", "dA", "dB", "dC", "dinit")]
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))
    other = next(n for r in ssd_bwd.PARTS.values() for n in r if n not in ssd_bwd.PARTS[x.dtype])
    with pytest.raises(ValueError, match="not a part"):
        ssd_bwd.launch_parts(other, x, dt, A, Bm, Cm, dy, bufs, chunk=chunk)
    bufs["dBp"] = bufs["dBp"][:1]
    with pytest.raises(ValueError, match="dBp"):
        ssd_bwd.launch_parts("ssd_bwd_reduce_kernel", x, dt, A, Bm, Cm, dy, bufs, chunk=chunk)


#: the bf16 kernels against ref.ssd_scan_bwd_bf16 (the same operand
#: roundings; the sums run in another order, so a bf16 output may round the
#: other way, 2**-8 of the largest at most): SSD_BWD_SAME_ROUNDING_TOL * max|g|
SSD_BWD_SAME_ROUNDING_TOL = 1e-2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_BWD_SHAPES)
def test_ssd_backward_bf16_kernel_matches_its_roundings(cuda, with_init, B, S, H, P, N, chunk):
    """The bf16 route against ``ref.ssd_scan_bwd_bf16`` on the same inputs:
    the same roundings, so a tighter bound than the 3e-2 against the fp32
    backward."""
    args = _ssd_bwd_args(cuda, "bfloat16", B, S, H, P, N, with_init)
    got = ssd_bwd.ssd_scan_bwd(*args, chunk=chunk)
    _close_grads(got, ref.ssd_scan_bwd_bf16(*args, chunk=chunk), SSD_BWD_SAME_ROUNDING_TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_gradient_flows_through_the_kernel(cuda, dtype):
    """torch.autograd.grad through ops.ssd_scan on the card (the SSDScan
    Function, whose backward is the kernel: its count rises, the forward's
    once) against the same through use_kernel=False, for x, dt, A, B, C and
    the initial state, with both outputs carrying a gradient."""
    B, S, H, P, N, chunk = 2, 100, 3, 16, 32, 32
    x, dt, A, Bm, Cm, s0, dy, dfs = _ssd_bwd_args(cuda, dtype, B, S, H, P, N)
    grads = {}
    for use_kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, s0)]
        before = (ssd.launches, ssd_bwd.launches)
        y, fs = ops.ssd_scan(*leaves[:5], chunk=chunk, initial_state=leaves[5],
                             use_kernel=use_kernel)
        grads[use_kernel] = torch.autograd.grad((y, fs), leaves, (dy, dfs))
        torch.cuda.synchronize()
        n = int(use_kernel)
        assert (ssd.launches - before[0], ssd_bwd.launches - before[1]) == (n, n)
    _close_grads(grads[True], grads[False], SSD_BWD_TOL[dtype])


@pytest.mark.requires_cuda
def test_ssd_kernel_refuses_a_chunk_its_backward_does_not_take(cuda):
    """Under grad mode a chunk above 128 raises before the forward runs; the
    forward alone (fp32) takes it."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, "float32", 1, 160, 1, 16, 16)
    before = ssd.launches
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x.requires_grad_(), dt, A, Bm, Cm, chunk=160)
    assert ssd.launches == before
    with torch.no_grad():
        y, _ = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=160)
    assert torch.isfinite(y).all()


def _train_runs(device, steps, sync_check=False, arch="qwen2.5-3b"):
    """Reduced fp32 train steps of ``arch`` from the same CPU-drawn weights
    and batches; returns the (loss, grad_norm) of each."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.training import OptimizerConfig, init_train_state, make_train_step

    cfg = ARCHS[arch].reduced()
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0), device)
    data = TokenPipeline(DataConfig(cfg.vocab_size, 2, 16, seed=0))
    step = make_train_step(cfg, opt)
    out = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(i).items()}
        if sync_check and i > 0:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, met = step(state, batch)
        finally:
            if sync_check:
                torch.cuda.set_sync_debug_mode("default")
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


@pytest.mark.requires_cuda
def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Three reduced fp32 steps through K1's forward and backward kernels
    against the same steps on the CPU (plain versions): loss and grad norm
    within 1e-4 relative."""
    before = (fa.launches, fab.launches)
    got = _train_runs(cuda, 3)
    cfg_layers = 2
    # forward + remat recompute per layer, one backward per layer
    assert (fa.launches - before[0], fab.launches - before[1]) == (
        3 * 2 * cfg_layers, 3 * cfg_layers)
    want = _train_runs(torch.device("cpu"), 3)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)


@pytest.mark.requires_cuda
def test_train_step_never_waits_for_the_card(cuda):
    """Under ``set_sync_debug_mode("error")`` a train step only queues work:
    the host waits for the card only where it reads the loss back (after
    the step). The first step, which builds the kernels, runs before."""
    losses = _train_runs(cuda, 3, sync_check=True)
    assert all(np.isfinite(losses).ravel())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b"])
def test_ssm_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Three reduced fp32 steps of mamba2 (K3 forward and backward) and jamba
    (K1 and K3, forward and backward, and MoE) against the same steps on the
    CPU: loss and grad norm within 1e-4 relative. Per step and Mamba2
    layer, the forward kernel runs twice (forward and remat recompute) and
    the backward kernel once."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch].reduced()
    before = (ssd.launches, ssd_bwd.launches, fa.launches, fab.launches)
    got = _train_runs(cuda, 3, arch=arch)
    after = (ssd.launches, ssd_bwd.launches, fa.launches, fab.launches)
    m, a = cfg.num_mamba_layers, cfg.num_attn_layers
    assert m > 0
    assert tuple(x - y for x, y in zip(after, before)) == (6 * m, 3 * m, 6 * a, 3 * a)
    want = _train_runs(torch.device("cpu"), 3, arch=arch)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)


@pytest.mark.requires_cuda
def test_mamba_train_step_never_waits_for_the_card(cuda):
    """As test_train_step_never_waits_for_the_card, for the reduced mamba2:
    K3's forward and backward kernels (and their buffers and state passes)
    only queue work."""
    losses = _train_runs(cuda, 3, sync_check=True, arch="mamba2-780m")
    assert all(np.isfinite(losses).ravel())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable"])
def test_mamba_gradients_on_the_card_under_both_remat_policies(cuda, policy):
    """Every leaf's gradient of the reduced mamba2's loss, with K3's kernels
    and non-reentrant checkpointing under ``policy``, against the CPU's
    (plain scan, no remat): within 1e-4 * max(1, max|g|); the in_proj
    gradients (which reach x, B and C through the strided split of the
    fused projection) are not zero."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    from repro_torch.training.loss import lm_loss

    cfg0 = ARCHS["mamba2-780m"].reduced()
    params = init_params(cfg0, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg0.vocab_size, (2, 16), dtype=np.int32))
    grads = {}
    for device, cfg in ((cuda, dataclasses.replace(cfg0, remat_policy=policy)),
                        (torch.device("cpu"), dataclasses.replace(cfg0, remat_policy="none"))):
        p = _to(params, device)
        leaves = T.leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        before = ssd_bwd.launches
        total, _ = lm_loss(cfg, p, {"tokens": toks.to(device)})
        grads[device.type] = [g.cpu() for g in torch.autograd.grad(total, leaves)]
        assert ssd_bwd.launches - before == (cfg.num_mamba_layers if device.type == "cuda"
                                             else 0)
    for (key, _), g, w in zip(T.items(params), grads["cuda"], grads["cpu"]):
        bound = 1e-4 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= bound, key
        if key.split("/")[-1] == "in_proj":
            assert g.abs().max().item() > 0, key


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,t,causal", [(100, 3, True), (64, 16, True), (37, 5, False)])
def test_row_split_attention_on_the_card(cuda, dtype, S, t, causal):
    """``distributed.local``'s attention split by query rows, each of ``t``
    ranks' body one after another on the card (K1 with its log-sum-exp,
    merged; K1's backward per part): the rows put together against K1 run
    whole, the summed gradients against K1's backward run whole, at
    tests/test_kernels.py's tolerances (gradients: ``1e-4 * max(1, max|g|)``
    in fp32, ``2e-2 * max|g|`` in bf16)."""
    from repro_torch.distributed import local

    dt = getattr(torch, dtype)
    g = np.random.default_rng(S + t)
    q, k, v, do = (torch.tensor(g.standard_normal((2, S, h, 64)), dtype=dt, device=cuda)
                   for h in (6, 2, 2, 6))
    scale = 0.125
    out = torch.empty_like(q)
    grads = [torch.zeros(x.shape, dtype=torch.float32, device=cuda) for x in (q, k, v)]
    for r in range(t):
        mine = local.rank_rows(q, k, v, causal=causal, scale=scale, use_kernel=True, rank=r, t=t)
        for first, rows, o, _ in mine:
            out[:, first:first + rows] = o
        for acc, gr in zip(grads, local.rank_rows_bwd(q, k, v, mine, do, causal=causal,
                                                      scale=scale, use_kernel=True)):
            acc += gr.float()
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    whole = ops.flash_attention(*ins, causal=causal, scale=scale, use_kernel=True)
    whole.backward(do)
    tol = 3e-5 if dt == torch.float32 else 2e-2
    assert (out.float() - whole.float()).abs().max().item() <= tol * (
        1 + whole.float().abs().max().item())
    for acc, x in zip(grads, ins):
        m = x.grad.float().abs().max().item()
        bound = 1e-4 * max(1.0, m) if dt == torch.float32 else 2e-2 * m
        assert (acc - x.grad.float()).abs().max().item() <= bound


_COLD = """
import json, sys
from repro_torch.api import FunctionSpec, Gateway
with Gateway(backend="runtime", policy=sys.argv[1], time_scale=1.0, exit_ttl=30.0,
             device="cuda") as gw:
    gw.register(FunctionSpec(name="f", arch="qwen2.5-3b", read_only_bytes=2 << 30))
    rec = gw.invoke("f", seed=0, input_bytes=1 << 20)
print(json.dumps({"e2e": rec.e2e, "stages": rec.stages, "error": rec.error}))
"""


@pytest.mark.requires_cuda
def test_end_to_end_sage_beats_fixedgsl_cold_latency_on_the_card(cuda):
    """tests/test_system.py's test on the card, its scenario and its
    criterion (the reduced qwen2.5-3b, 2 GiB declared, time_scale 1.0, one
    cold invoke; SAGE's e2e under 0.9 x FixedGSL's), each invoke in a
    fresh process, as a new worker pays its first context: SAGE builds it
    under the load, FixedGSL before it. A fresh process's first build
    varies (1.4-2.5 s here), so each policy takes the median of three
    processes; the kernel libraries are built first, outside them."""
    import json
    import os
    import statistics
    import subprocess
    import sys
    from pathlib import Path

    fa.load()
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    recs = {"sage": [], "fixedgsl": []}
    for _ in range(3):
        for system in recs:
            res = subprocess.run([sys.executable, "-c", _COLD, system], env=env,
                                 cwd=str(root), capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, res.stderr[-4000:]
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            assert rec["error"] is None, rec
            recs[system].append(rec["e2e"])
    sage, fixed = (statistics.median(recs[s]) for s in ("sage", "fixedgsl"))
    assert sage < 0.9 * fixed, recs


@pytest.mark.requires_cuda
def test_database_copies_page_locked_leaves_bit_equal(cuda):
    """``page_locked`` keeps a payload's tensors in one page-locked host
    buffer (contiguous views; within 1.1 x their bytes plus a page a
    tensor, which ``Database.page_locked_bytes`` counts once the payload is
    stored), ``to_device`` copies them bit for bit and keeps the
    containers; each destination comes from the default stream's blocks
    (freed, the next allocation of its size there takes the same block).
    A pageable tensor (a request's tokens, a transposed one) is copied bit
    for bit through PyTorch's caching pinned allocator, and a hundred such
    copies allocate no new pinned block."""
    import collections
    import mmap

    from repro_torch.data.database import Database, page_locked, tensors

    Pair = collections.namedtuple("Pair", "w meta")
    g = torch.Generator(device=cuda).manual_seed(0)
    big = torch.randn((3, 70 << 20), generator=g, device=cuda).to(torch.bfloat16)
    payload = {"p": Pair(big, [torch.arange(7, dtype=torch.int32), (7, 8)]),
               "x": torch.randn((5, 3), generator=torch.Generator().manual_seed(1)).t(),
               "s": torch.tensor(2.5)}
    db = Database(device="cuda")
    host = page_locked(payload)
    db.put("k", host, size=1)
    leaves = tensors(host)
    assert all(t.device.type == "cpu" and t.is_pinned() and t.is_contiguous() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    assert nbytes <= db.page_locked_bytes <= 1.1 * nbytes + mmap.PAGESIZE * len(leaves)
    got = db.to_device(host)
    assert type(got["p"]) is Pair and got["p"].meta[1] == (7, 8)
    for want, out in zip(tensors(payload), tensors(got)):
        assert out.device.type == "cuda" and out.dtype == want.dtype
        assert torch.equal(out.cpu(), want.cpu())
    ptr, shape = got["p"].w.data_ptr(), got["p"].w.shape
    del got, out
    assert torch.empty(shape, dtype=torch.bfloat16, device=cuda).data_ptr() == ptr

    tokens = torch.arange(4 * 1024, dtype=torch.int32).view(4, 1024)
    pageable = {"tokens": tokens, "t": payload["x"]}
    db.put("in", pageable, size=1)
    assert not tokens.is_pinned() and not payload["x"].is_contiguous()
    db.to_device(db.fetch("in"))
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    for _ in range(100):
        got = db.to_device(db.fetch("in"))
        assert torch.equal(got["tokens"].cpu(), tokens) and torch.equal(got["t"].cpu(),
                                                                        payload["x"])
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    assert db.page_locked_bytes <= 1.1 * nbytes + mmap.PAGESIZE * len(leaves)


def _copy_beside(db, key, started):
    """``db.to_device(db.fetch(key))`` on a thread of its own: the thread and
    the host clock's (start, end) of the copy."""
    import threading
    import time

    span = {}

    def run():
        span["start"] = time.monotonic()
        started.set()
        span["out"] = db.to_device(db.fetch(key))
        torch.cuda.synchronize()
        span["end"] = time.monotonic()

    th = threading.Thread(target=run)
    th.start()
    return th, span


@pytest.mark.requires_cuda
def test_database_copy_is_not_queued_on_the_current_stream(cuda):
    """While ``to_device`` of 4 GiB runs on another thread, a small kernel
    on the default stream and ``current_stream().synchronize()`` return
    before the copy ends: the copy runs on the database's own stream."""
    import threading
    import time

    from repro_torch.data.database import Database, page_locked

    db = Database(device="cuda")
    db.put("big", page_locked(torch.ones(1 << 30, dtype=torch.float32, device=cuda)), size=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    started = threading.Event()
    th, span = _copy_beside(db, "big", started)
    started.wait(10)
    while torch.cuda.memory_allocated() < base + (1 << 32) and th.is_alive():
        time.sleep(0.0005)  # the destination is allocated: the copy is under way
    y = torch.ones(16, device=cuda) * 2
    torch.cuda.current_stream().synchronize()
    returned = time.monotonic()
    th.join(60)
    assert not th.is_alive() and "end" in span
    assert float(y.sum()) == 32.0
    assert returned < span["end"], (returned - span["start"], span["end"] - span["start"])
    assert torch.equal(span["out"][-4:].cpu(), torch.ones(4))


@pytest.mark.requires_cuda
def test_database_counters_read_the_links_copy_rate(cuda):
    """``Database.h2d_bytes`` over ``h2d_s`` of a 2 GiB page-locked
    ``to_device`` reads 0.8–1.05 of the rate of one plain ``copy_`` of the
    same bytes timed with CUDA events (the median of three each)."""
    import statistics

    from repro_torch.data.database import Database, page_locked

    db = Database(device="cuda")
    host = page_locked(torch.ones(1 << 29, dtype=torch.float32, device=cuda))
    nbytes = host.numel() * host.element_size()
    db.to_device(host)  # dropped: its destination's block is then reused
    rates = []
    for _ in range(3):
        b0, s0 = db.h2d_bytes, db.h2d_s
        out = db.to_device(host)
        assert db.h2d_bytes - b0 == nbytes
        rates.append(nbytes / (db.h2d_s - s0))
        del out
    dst = torch.empty_like(host, device=cuda)
    plain = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        plain.append(nbytes / (start.elapsed_time(end) / 1e3))
    ratio = statistics.median(rates) / statistics.median(plain)
    assert 0.8 <= ratio <= 1.05, (rates, plain)


_BUILD_BESIDE = """
import json, sys, threading, time
import torch
from repro_torch.configs import ARCHS
from repro_torch.core.functions import _model_function
from repro_torch.data.database import Database
db = Database(device="cuda")
fn = _model_function(db, "f", ARCHS["qwen2.5-3b"], batch=4, seq=1024, seed=0)
torch.cuda.synchronize()
copy = {}
if sys.argv[1] == "beside":
    def run():
        copy["out"] = db.to_device(db.fetch("f/weights"))
    th = threading.Thread(target=run)
    th.start()
t0 = time.monotonic()
fn.context_builder()
build = time.monotonic() - t0
if sys.argv[1] == "beside":
    th.join()
print(json.dumps({"build_s": build}))
"""


@pytest.mark.requires_cuda
def test_context_build_beside_the_weights_copy_takes_about_the_build_alone(cuda):
    """A fresh process's first context build of the full-width qwen2.5-3b
    (4 x 1024) while another thread copies its 6.17 GB of weights to the
    card takes at most 1.25 x the build alone plus 50 ms (medians of two
    fresh processes each, in turns): the build waits for its own work,
    not for the copy. The kernel libraries are built first."""
    import json
    import os
    import statistics
    import subprocess
    import sys
    from pathlib import Path

    fa.load()
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    got = {"alone": [], "beside": []}
    for _ in range(2):
        for mode in ("alone", "beside"):
            res = subprocess.run([sys.executable, "-c", _BUILD_BESIDE, mode], env=env,
                                 cwd=str(root), capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, res.stderr[-4000:]
            got[mode].append(json.loads(res.stdout.strip().splitlines()[-1])["build_s"])
    alone, beside = (statistics.median(got[m]) for m in ("alone", "beside"))
    assert beside <= 1.25 * alone + 0.05, got


@pytest.mark.requires_cuda
def test_first_forward_after_the_weights_copy_allocates_no_segment(cuda):
    """FixedGSL's order on one thread: the context build (its warm-up at
    the request's shapes), then the weights' copy, then the first forward.
    The copy must not take the blocks the warm-up left for the forward:
    the forward allocates no new device segment (on the default stream
    the copy split them and a fresh process's first cold FixedGSL forward
    called cudaMalloc for a 2.49 GB segment for its logits inside its
    compute stage on an H100 80GB HBM3 at 700 W). The full-width
    qwen2.5-3b at 4 x 1024 in this process, from an emptied cache, the
    served logits against the plain forward of the same weights."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.functions import _model_function
    from repro_torch.data.database import Database
    from repro_torch.models import forward

    fa.load()
    cfg = ARCHS["qwen2.5-3b"]
    db = Database(device="cuda")
    fn = _model_function(db, "seg", cfg, batch=4, seq=1024, seed=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx = fn.context_builder()
    weights = db.to_device(db.fetch("seg/weights"))
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), dtype=torch.int32, device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["segment.all.allocated"]
    got = ctx(weights, tokens)[:, -1]
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["segment.all.allocated"] == before
    with torch.inference_mode():
        want = forward(cfg, weights, {"tokens": tokens})[0][:, -1]
    assert torch.equal(got, want)


def _graph_counts(name):
    from repro_torch.core import functions

    return (functions.eager_forwards[name], functions.graph_captures[name],
            functions.graph_replays[name])


def _kernel_launches():
    from repro_torch.core import functions

    return {m.NAME: m.launches - functions.context_launches[m.NAME] for m in (fa, ssd)}


def _forward_launches(cfg):
    """A forward's K1 and K3 calls: one a layer of each mixer."""
    return {fa.NAME: cfg.num_attn_layers, ssd.NAME: cfg.num_mamba_layers}


def _traced_calls(fn):
    """Run ``fn`` under torch.profiler; the K1 and K3 calls whose kernels
    ran on the card, by the kernels' names in the trace (a CUDA graph's
    nodes included): K1's forward kernel, and the kernel that ends each K3
    call (fp32 ``ssd_kernel``, bf16 ``ssd_chunk_scan_kernel``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    calls = {fa.NAME: 0, ssd.NAME: 0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if "flash_fwd" in e.key:
                calls[fa.NAME] += e.count
            elif "ssd_kernel" in e.key or "ssd_chunk_scan_kernel" in e.key:
                calls[ssd.NAME] += e.count
    return out, calls


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m"])
def test_served_forward_replays_the_contexts_cuda_graph(cuda, arch):
    """The reduced olmoe-1b-7b (K1 and the MoE) and mamba2-780m (K3) served
    by ``SageRuntime``: the cold call runs eagerly, the second captures the
    context's CUDA graph and the later ones replay it. Every answer equals
    the eager forward's on the same weights and tokens bit for bit, and each
    call adds one forward's launches to the kernels' counters (besides the
    context build's). The graph's pool is reserved through the node's
    memory daemon as context memory, and the node's teardown gives it back
    and takes it out of the context's ``reserved_bytes``, as the engine
    keeps the context itself."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import SageRuntime, functions
    from repro_torch.core.functions import _model_function, make_request
    from repro_torch.models import forward

    cfg = ARCHS[arch].reduced()
    name = f"served-graph-{arch}"
    rt = SageRuntime("sage", time_scale=0.0, exit_ttl=60.0, device="cuda")
    rt.sage_init()
    fn = _model_function(rt.db, name, cfg, batch=2, seq=16, seed=0)
    rt.register_function(fn)
    reqs = [make_request(rt.db, fn, batch=2, seq=16, vocab=cfg.vocab_size, seed=s)
            for s in range(5)]
    counts, launched, out_keys = [], [], []
    for req in reqs:
        before = _kernel_launches()
        out_keys.append(rt.sage_run(req))
        after = _kernel_launches()
        launched.append({k: after[k] - before[k] for k in after})
        counts.append(_graph_counts(name))
        if len(counts) == 1:
            ctx = rt.engines[name]._shared_ctx
            built = ctx.reserved_bytes
    assert counts == [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 1, 3)]
    assert launched == [_forward_launches(cfg)] * 5
    pool = ctx.reserved_bytes - built
    assert pool > 0 and rt.daemon.context_bytes_used == fn.context_bytes + pool
    db = rt.db
    weights = db.to_device(db.fetch(f"{name}/weights"))
    with torch.inference_mode():
        for req, key in zip(reqs, out_keys):
            toks = db.fetch(req.in_data[1].key).to(cuda)
            direct = forward(cfg, weights, {"tokens": toks})[0][:, -1, :8].float().cpu()
            np.testing.assert_array_equal(db.fetch(key), direct.numpy())
    usage = rt.drain()
    rt.shutdown()
    assert usage["device_used"] == 0 and ctx.reserved_bytes == built


@pytest.mark.requires_cuda
def test_served_forward_stays_eager_where_the_daemon_cannot_grant_the_graphs_pool(cuda):
    """The reduced olmoe-1b-7b served by ``SageRuntime`` on a node whose
    memory daemon has no room beyond the weights, the context and a
    request's tokens: the second call captures the graph, the daemon does
    not grant its pool, so it and every later call run eagerly, capturing
    no more, with the answers of the eager forward; nothing is left
    reserved for a graph."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import SageRuntime
    from repro_torch.core.functions import _model_function, make_request
    from repro_torch.core.profiles import MB
    from repro_torch.models import forward

    cfg = ARCHS["olmoe-1b-7b"].reduced()
    name = "graph-refused"
    rt = SageRuntime("sage", time_scale=0.0, exit_ttl=60.0, device="cuda")
    rt.sage_init()
    fn = _model_function(rt.db, name, cfg, batch=2, seq=16, seed=0)
    rt.register_function(fn)
    reqs = [make_request(rt.db, fn, batch=2, seq=16, vocab=cfg.vocab_size, seed=s)
            for s in range(4)]
    out_keys = [rt.sage_run(reqs[0])]
    # a request's 4 MB of tokens and 1 MB more: a graph's pool takes at
    # least one 2 MB segment of the caching allocator
    rt.daemon.capacity = rt.daemon.device_used + 5 * MB
    out_keys += [rt.sage_run(r) for r in reqs[1:]]
    assert _graph_counts(name) == (4, 0, 0)
    assert rt.daemon.context_bytes_used == fn.context_bytes
    assert rt.engines[name]._shared_ctx._graph is None
    weights = rt.db.to_device(rt.db.fetch(f"{name}/weights"))
    with torch.inference_mode():
        for req, key in zip(reqs, out_keys):
            toks = rt.db.fetch(req.in_data[1].key).to(cuda)
            direct = forward(cfg, weights, {"tokens": toks})[0][:, -1, :8].float().cpu()
            np.testing.assert_array_equal(rt.db.fetch(key), direct.numpy())
    usage = rt.drain()
    rt.shutdown()
    assert usage["device_used"] == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m"])
def test_context_graph_follows_the_weights_and_the_tokens_shape(cuda, arch):
    """A built context called directly. Calls that alternate between two
    weight trees run eagerly; the second call in a row with one tree
    captures, and later ones replay, each answer bit-equal to the eager
    forward's. The replay reads new values written at the captured
    addresses; tokens of another shape run eagerly and keep the graph;
    weights at other addresses run eagerly (never the old graph), drop the
    graph and its pool from ``reserved_bytes``, and are captured on the
    next call. A replay's host time is under a tenth of the eager issue's
    (medians of six), and the K1 and K3 calls a replay adds to the
    kernels' counters are the calls whose kernels the profiler's trace
    shows running on the card in that replay. The reduced widths, eight layers deep, so that the
    issue is long enough to time against a replay's fixed cost."""
    import dataclasses
    import statistics
    import time

    from repro_torch.configs import ARCHS
    from repro_torch.core.functions import _model_function
    from repro_torch.data.database import Database
    from repro_torch.models import forward, init_params
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(ARCHS[arch].reduced(), num_layers=8)
    name = f"direct-graph-{arch}"
    db = Database(device="cuda")
    fn = _model_function(db, name, cfg, batch=2, seq=16, seed=0)
    ctx = fn.context_builder()
    built = ctx.reserved_bytes
    wa = db.to_device(db.fetch(f"{name}/weights"))
    wb = init_params(cfg, torch.Generator(device=cuda).manual_seed(7), cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32, device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))

    def eager(w, t):
        with torch.inference_mode():
            return forward(cfg, w, {"tokens": t})[0]

    def timed(w, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ctx(w, t)
        return out, time.perf_counter() - t0

    host = {"eager": [], "replay": []}
    for w in (wa, wb) * 3:
        out, s = timed(w, toks)
        host["eager"].append(s)
        assert torch.equal(out, eager(w, toks))
    assert _graph_counts(name) == (6, 0, 0) and ctx.reserved_bytes == built
    out = ctx(wb, toks)  # the second call in a row with wb: captures
    assert torch.equal(out, eager(wb, toks))
    assert _graph_counts(name) == (6, 1, 0) and ctx.reserved_bytes > built
    for _ in range(6):
        before = _kernel_launches()
        out, s = timed(wb, toks)
        after = _kernel_launches()
        host["replay"].append(s)
        assert torch.equal(out, eager(wb, toks))
        assert {k: after[k] - before[k] for k in after} == _forward_launches(cfg)
    assert _graph_counts(name) == (6, 1, 6)
    before = _kernel_launches()
    _, traced = _traced_calls(lambda: ctx(wb, toks))
    after = _kernel_launches()
    assert traced == {k: after[k] - before[k] for k in after} == _forward_launches(cfg)
    assert _graph_counts(name) == (6, 1, 7)
    held = out.clone()
    for leaf in leaves(wb):
        leaf.mul_(0.5)
    out = ctx(wb, toks)
    assert _graph_counts(name) == (6, 1, 8)
    assert torch.equal(out, eager(wb, toks)) and not torch.equal(out, held)
    short = toks[:, :8].contiguous()
    assert torch.equal(ctx(wb, short), eager(wb, short))
    assert _graph_counts(name) == (7, 1, 8)
    assert torch.equal(ctx(wb, toks), eager(wb, toks))  # the graph was kept
    assert _graph_counts(name) == (7, 1, 9)
    assert torch.equal(ctx(wa, toks), eager(wa, toks))
    assert _graph_counts(name) == (8, 1, 9) and ctx.reserved_bytes == built
    assert torch.equal(ctx(wa, toks), eager(wa, toks))
    assert _graph_counts(name) == (8, 2, 9)
    ctx.release()  # as the engine releases the context's memory
    assert ctx.reserved_bytes == built
    assert torch.equal(ctx(wa, toks), eager(wa, toks))
    assert _graph_counts(name) == (9, 2, 9)
    assert statistics.median(host["replay"]) < 0.1 * statistics.median(host["eager"]), host


@pytest.mark.requires_cuda
def test_context_whose_forward_cannot_be_captured_stays_eager(cuda):
    """A forward that makes the host wait for the card (``.item()``) cannot
    be captured: the call that tries answers eagerly, the context never
    tries again, and the collector, off during the capture, is back on."""
    import gc

    from repro_torch.core.functions import ModelContext, compute_stream

    def fwd(p, t):
        return p["w"] * t.float() * float(p["w"].sum())

    name = "uncapturable"
    ctx = ModelContext(fwd, 0.0, {}, 0, compute_stream(cuda), name=name, shape=(2, 4))
    p = {"w": torch.full((2, 4), 0.5, device=cuda)}
    t = torch.arange(8, dtype=torch.int32, device=cuda).reshape(2, 4)
    for _ in range(4):
        assert torch.equal(ctx(p, t), fwd(p, t))
    assert _graph_counts(name) == (4, 0, 0) and ctx.shape is None and gc.isenabled()
