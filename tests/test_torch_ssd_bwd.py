"""The plain SSD-scan backwards against ``jax.vjp`` of the JAX package's
``repro.models.mamba2.ssd_chunked_ref`` on the same numpy inputs from a
seed: ``repro_torch.kernels.ref.ssd_scan_bwd`` (the arithmetic of K3's
fp32 backward kernels, also against autograd of the port's plain scan)
and ``ref.ssd_scan_bwd_bf16`` (the operand roundings of the bf16 kernels,
on bf16-valued inputs); and the kernels' wrappers refuse CPU tensors. The
kernels themselves are held against both on the card
(tests/test_torch_cuda.py)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.mamba2 import ssd_chunked_ref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import ssd_scan_bwd as ssd_bwd  # noqa: E402

GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinitial_state")
# B, S, H, P, N, chunk: tests/test_kernels.py's SSD sweep, then S < chunk,
# jamba's P = 128 (with S < chunk) and a chunk (10) that is not a multiple
# of 16 with a ragged last chunk
SWEEP = [
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 32, 64, 32),
    (2, 100, 3, 16, 32, 32),     # a ragged last chunk of 4 rows
    (1, 256, 8, 64, 128, 64),
    (2, 10, 2, 16, 16, 16),      # S < chunk
    (2, 40, 2, 128, 128, 64),    # P = 128, S < chunk
    (2, 45, 3, 32, 48, 10),      # chunk 10, a ragged last chunk of 5 rows
]


def _inputs(B, S, H, P, N, seed=0):
    """x, dt, A, B, C, initial_state, dy, dfinal_state as fp32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(B, S, H, P)
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)  # softplus
    A = (-np.exp(f(H) * 0.3)).astype(np.float32)
    return x, dt, A, f(B, S, N), f(B, S, N), f(B, H, P, N), f(B, S, H, P), f(B, H, P, N)


def _jax_vjp(x, dt, A, Bm, Cm, s0, dy, dfs, chunk):
    """jax.vjp of ssd_chunked_ref at the cotangents (dy, dfs): the gradients
    of x, dt, A, B, C (and s0 when it is given)."""
    def scan(*args):
        return ssd_chunked_ref(*args[:5], chunk=chunk,
                               initial_state=args[5] if len(args) > 5 else None)

    args = (x, dt, A, Bm, Cm) + ((s0,) if s0 is not None else ())
    grads = jax.jit(lambda a, g: jax.vjp(scan, *a)[1](g))(args, (dy, dfs))
    return [np.asarray(g) for g in grads]


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("dfinal", ["zero", "nonzero"])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_plain_ssd_backward_matches_jax_vjp(B, S, H, P, N, chunk, with_init, dfinal):
    """Every gradient within 1e-4 * max(1, max|g|) of jax.vjp, fp32. A zero
    dfinal_state goes to the port as None (its zeros) and to JAX as zeros;
    without an initial state JAX has no dinitial_state to compare."""
    x, dt, A, Bm, Cm, s0, dy, dfs = _inputs(B, S, H, P, N, seed=S * H + P + chunk)
    s0 = s0 if with_init else None
    if dfinal == "zero":
        dfs = np.zeros_like(dfs)
    want = _jax_vjp(x, dt, A, Bm, Cm, s0, dy, dfs, chunk)
    got = ref.ssd_scan_bwd(*map(_t, (x, dt, A, Bm, Cm, s0, dy)),
                           None if dfinal == "zero" else _t(dfs), chunk=chunk)
    assert len(want) == (6 if with_init else 5)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        bound = 1e-4 * max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max())
        assert err <= bound, f"{name}: {err} > {bound}"
    assert tuple(got[5].shape) == (B, H, P, N)


def test_plain_ssd_backward_matches_autograd_of_the_plain_scan():
    """Against torch.autograd.grad through ref.ssd_scan (the CPU's training
    path), a ragged last chunk, an initial state and a nonzero dfinal_state:
    within 1e-5 * max(1, max|g|)."""
    B, S, H, P, N, chunk = 2, 100, 3, 16, 32, 32
    arrays = [torch.from_numpy(a) for a in _inputs(B, S, H, P, N, seed=11)]
    x, dt, A, Bm, Cm, s0, dy, dfs = arrays
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, s0)]
    y, fs = ref.ssd_scan(*leaves[:5], chunk=chunk, initial_state=leaves[5])
    want = torch.autograd.grad((y, fs), leaves, (dy, dfs))
    got = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, s0, dy, dfs, chunk=chunk)
    for name, g, w in zip(GRADS, got, want):
        bound = 1e-5 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= bound, name


def test_plain_ssd_backward_keeps_the_input_dtype():
    """bf16 x, B, C, dy: dx, dB and dC come back in bf16, the rest in fp32,
    as the kernel returns them; each within 3e-2 * max|g| of the fp32
    backward of the same values (the SSD tolerance of
    tests/test_kernels.py)."""
    B, S, H, P, N, chunk = 1, 48, 2, 16, 16, 16
    x, dt, A, Bm, Cm, s0, dy, dfs = map(torch.from_numpy, _inputs(B, S, H, P, N, seed=3))
    xb, Bb, Cb, dyb = (t.bfloat16() for t in (x, Bm, Cm, dy))
    got = ref.ssd_scan_bwd(xb, dt, A, Bb, Cb, s0, dyb, dfs, chunk=chunk)
    want = ref.ssd_scan_bwd(xb.float(), dt, A, Bb.float(), Cb.float(), s0, dyb.float(), dfs,
                            chunk=chunk)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == (torch.bfloat16 if name in ("dx", "dB", "dC") else torch.float32)
        assert (g.float() - w).abs().max().item() <= 3e-2 * w.abs().max().item(), name


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    """``ssd_scan_bwd``, the ``SSDScan`` Function, the state pass and the
    kernels launched one at a time raise ValueError on CPU tensors before
    they build anything; a chunk above 128 is refused too. None of them
    falls back to the plain version."""
    x, dt, A, Bm, Cm, s0, dy, dfs = map(torch.from_numpy, _inputs(1, 16, 2, 16, 16))
    before = (ssd.launches, ssd_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_bwd.ssd_scan_bwd(x, dt, A, Bm, Cm, s0, dy, dfs, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.SSDScan.apply(x.requires_grad_(), dt, A, Bm, Cm, s0, 16)
    states = torch.zeros((1, 1, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd.pass_states(states, torch.ones((1, 2, 1)), None, torch.zeros((1, 2, 16, 16)))
    bufs = ssd_bwd.new_buffers(x, Bm, 16)
    assert tuple(bufs["dBp"].shape) == (2, 1, 16, 16) and bufs["dx"].dtype == x.dtype
    for name in ssd_bwd.PARTS[x.dtype]:
        with pytest.raises(ValueError, match="CUDA"):
            ssd_bwd.launch_parts(name, x, dt, A, Bm, Cm, dy, bufs, chunk=16)
    for chunk in (0, 129):
        with pytest.raises(ValueError, match="chunk"):
            ssd_bwd.check_chunk(chunk)
    assert (ssd.launches, ssd_bwd.launches) == before



def _bf16_valued(*arrays):
    """The arrays rounded to bf16 and back to fp32 numpy: the values the
    bf16 kernels take."""
    return [torch.from_numpy(a).bfloat16().float().numpy() for a in arrays]


def _check_bf16_mirror(B, S, H, P, N, chunk, tol, seed, **kw):
    """ref.ssd_scan_bwd_bf16 on bf16-valued x, B, C, dy (with an initial
    state and a nonzero dfinal_state) against jax.vjp of the same values:
    every gradient within tol * max|g|."""
    x, dt, A, Bm, Cm, s0, dy, dfs = _inputs(B, S, H, P, N, seed=seed)
    x, Bm, Cm, dy = _bf16_valued(x, Bm, Cm, dy)
    want = _jax_vjp(x, dt, A, Bm, Cm, s0, dy, dfs, chunk)
    got = ref.ssd_scan_bwd_bf16(*map(_t, (x, dt, A, Bm, Cm, s0, dy, dfs)), chunk=chunk, **kw)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == (torch.bfloat16 if name in ("dx", "dB", "dC") else torch.float32)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= tol * float(np.abs(w).max()), f"{name}: {err}"


# the SSD sweep, and mamba2-780m's chunk, state and head widths at B 1, H 2
BF16_SWEEP = SWEEP + [(1, 256, 2, 64, 128, 128)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", BF16_SWEEP)
def test_bf16_mirror_matches_jax_vjp(B, S, H, P, N, chunk):
    """The bf16 kernels' roundings (hi + lo where ``BWD_BF16_OPERANDS``
    says so, bf16 outputs) keep every gradient within the bf16 SSD
    tolerance, 3e-2 * max|g|, of the exact gradient of the same values."""
    _check_bf16_mirror(B, S, H, P, N, chunk, 3e-2, seed=S + P + chunk)


@pytest.mark.parametrize("once", [(name,) for name in ref.BWD_BF16_ONCE] + [ref.BWD_BF16_ONCE],
                         ids=lambda once: "+".join(once))
def test_bf16_mirror_rounds_once_with_margin(once):
    """Each operand the kernels round to bf16 once (the rest hi + lo), and
    all of them together as the kernels do, at mamba2-780m's widths over
    two chunks: every gradient within a quarter of the tolerance, 7.5e-3 *
    max|g| (about 3e-3 measured, most of it the bf16 outputs' rounding)."""
    _check_bf16_mirror(1, 256, 2, 64, 128, 128, 7.5e-3, seed=7, once=once)


def test_bf16_mirror_splits_to_the_fp32_backward():
    """With every operand as hi + lo and bf16-valued inputs, the mirror is
    the fp32 backward but for the bf16 outputs' rounding: dx, dB, dC within
    1 bf16 ulp of the largest (2**-7 * max|g|), ddt, dA and dinit within
    1e-4 * max|g|. An unknown operand name is refused."""
    x, dt, A, Bm, Cm, s0, dy, dfs = _inputs(2, 100, 3, 16, 32, seed=4)
    x, Bm, Cm, dy = _bf16_valued(x, Bm, Cm, dy)
    args = list(map(_t, (x, dt, A, Bm, Cm, s0, dy, dfs)))
    got = ref.ssd_scan_bwd_bf16(*args, chunk=32, once=())
    want = ref.ssd_scan_bwd(*args, chunk=32)
    for name, g, w in zip(GRADS, got, want):
        tol = 2.0 ** -7 if name in ("dx", "dB", "dC") else 1e-4
        assert (g.float() - w).abs().max().item() <= tol * w.abs().max().item(), name
    with pytest.raises(ValueError, match="unknown"):
        ref.ssd_scan_bwd_bf16(*args, chunk=32, once=("dy",))


def test_bf16_buffers_and_head_groups():
    """The bf16 route's buffers: C B^T (B, n_c, Tp, Tp) with Tp the chunk
    rounded up to 16, and dB/dC partials per group of heads: 2 heads a block
    at mamba2-780m's training shape (768 blocks; 4 do not fit a block's
    shared memory), 1 at jamba's P = 128, and fewer where the grid would
    not fill the card's 132 SMs or H does not divide."""
    assert ssd_bwd.grad_smem(128, 64, 128, 2) <= ssd_bwd.SMEM_LIMIT
    assert ssd_bwd.grad_smem(128, 64, 128, 4) > ssd_bwd.SMEM_LIMIT
    assert ssd_bwd.grad_smem(128, 128, 128, 1) <= ssd_bwd.SMEM_LIMIT
    assert ssd_bwd.heads_per_block(4, 8, 48, 128, 64, 128) == 2
    assert ssd_bwd.heads_per_block(4, 8, 128, 128, 128, 128) == 1
    assert ssd_bwd.heads_per_block(64, 8, 48, 16, 16, 16) == 4
    assert ssd_bwd.heads_per_block(2, 1, 8, 16, 16, 16) == 1
    assert ssd_bwd.heads_per_block(64, 8, 3, 16, 16, 16) == 1
    x = torch.zeros((4, 1024, 48, 64), dtype=torch.bfloat16)
    bufs = ssd_bwd._buffer_specs(x, torch.zeros((4, 1024, 128), dtype=torch.bfloat16), 128)
    assert bufs["dBp"][0] == (24, 4, 1024, 128) and bufs["cb"][0] == (4, 8, 128, 128)
    x = torch.zeros((2, 45, 3, 32), dtype=torch.bfloat16)
    bufs = ssd_bwd._buffer_specs(x, torch.zeros((2, 45, 48), dtype=torch.bfloat16), 10)
    assert bufs["dCp"][0] == (3, 2, 45, 48) and bufs["cb"][0] == (2, 5, 16, 16)
    assert set(ssd_bwd.KERNELS) <= {n for route in ssd_bwd.PARTS.values() for n in route}
