"""Mamba2's chunked SSD scan: the hand-written CUDA kernels for Hopper and
their wrapper.

Replaces ``repro/kernels/ssd_scan.py::_ssd_kernel`` (+ ``_segsum``), the
Pallas TPU kernel. The kernels are in ``csrc/ssd_scan.cu``; its note says
what bounds them on the H100 and what the design does about that. Two
routes, by dtype:

* fp32 (``ssd_kernel``): one CTA per (head, sequence) runs the chunks in
  order with the (P, N) state in fp32 in shared memory, in fp32 FMA on the
  CUDA cores (it must meet 1e-3).
* bf16: chunk-parallel on the tensor cores, four launches per call:
  ``ssd_chunk_cb_kernel`` (C B^T once per (sequence, chunk)),
  ``ssd_chunk_state_kernel`` (each chunk's local state),
  ``ssd_state_pass_kernel`` (the recurrence over chunks) and
  ``ssd_chunk_scan_kernel`` (y), mirroring ``ref.ssd_chunk_cb``,
  ``ref.ssd_chunk_state``, ``ref.ssd_state_pass`` and ``ref.ssd_chunk_scan``.
  P and N must be multiples of 16 and at most 128, the chunk at most 128;
  x, B and C must start on a 16-byte boundary with positions a multiple of
  16 bytes apart. Its scratch (C B^T, the chunk states, the decays) is
  allocated per call, since the runtime's executor threads launch at once.
  ``chunk_cb``, ``chunk_state``, ``pass_states`` and ``chunk_scan`` launch
  one of the four alone, for the tests.

Unlike the TPU kernel it takes ``initial_state``, so ``ops.ssd_scan`` never
needs the plain version for a CUDA tensor. The wrapper keeps the JAX
signature: x (B, S, H, P) and B/C (B, S, N) in fp32 or bf16 (one dtype for
the three), dt (B, S, H) and A (H,) in fp32, initial_state (B, H, P, N)
fp32 or None. x, B and C may be views whose positions are a fixed number of
elements apart with the inner dims contiguous (the slices of the Mamba2
block's fused projection are); the rest must be contiguous. It raises
ValueError on anything else and never falls back to the plain version or
to the other route. Returns (y (B, S, H, P) in x's dtype, final_state
(B, H, P, N) fp32), both allocated here; the kernels run on the current
stream and nothing synchronises. ``launches`` counts one per call of
``ssd_scan`` that launched its kernels (and nothing else): a call inside a
CUDA graph's capture launches nothing and goes to ``capture.tally``
instead, and whoever replays the graph adds the captured calls
(``add_launches``).

Under grad mode, an input that requires grad sends the call through
``SSDScan``, an autograd Function whose backward is the hand-written
kernels of ``ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``: fp32 FMA for fp32,
the tensor cores for bf16); it saves only the inputs. The bf16 backward
launches this file's C B^T and chunk-state kernels too (``launch_bf16``),
and both routes the state pass, which ``pass_states`` launches alone, in
place, for any P and N: forwards, and on reversed chunks.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, capture

NAME = "ssd_scan"
DTYPES = (torch.float32, torch.bfloat16)
#: bf16 route: P and N multiples of 16 and at most this, the chunk at most this
MAX_DIM = 128
#: the bf16 route's kernels, by the bit that launches each
STAGES = {"ssd_chunk_cb_kernel": 1, "ssd_chunk_state_kernel": 2,
          "ssd_state_pass_kernel": 4, "ssd_chunk_scan_kernel": 8}

#: kernel launches made by ``ssd_scan`` in this process
launches = 0

_lib = None
_count_lock = threading.Lock()


def _kernel():
    """Build (once per process) and bind the C entry points."""
    global _lib
    if _lib is None:
        lib = _build.load(NAME)
        lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_bf16_fwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
            ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        lib.ssd_scan_bf16_fwd.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_scan_smem_limit.argtypes = []
        lib.ssd_scan_smem_limit.restype = ctypes.c_longlong
        lib.ssd_state_pass.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.ssd_state_pass.restype = ctypes.c_int
        _lib = lib
    return _lib


def load() -> None:
    """Build and load the kernel library without launching anything."""
    _kernel()


def add_launches(n: int) -> None:
    """Count ``n`` calls captured into a CUDA graph, as the graph is
    replayed."""
    global launches
    with _count_lock:
        launches += n


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """Elements between consecutive positions of a (B, S, *inner) tensor
    whose inner dims are contiguous and whose sequences are S positions
    apart; None when it is not laid out so."""
    expect = 1
    for dim in range(t.dim() - 1, 1, -1):
        if t.size(dim) > 1 and t.stride(dim) != expect:
            return None
        expect *= t.size(dim)
    rs = t.stride(1) if t.size(1) > 1 else expect
    if rs < expect or (t.size(0) > 1 and t.stride(0) != t.size(1) * rs):
        return None
    return rs


def check_inputs(x, dt, A, Bm, Cm, initial_state) -> Tuple[int, int, int]:
    """Raise ValueError for anything the kernel does not take; return the
    row strides of x, B and C."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError("need x (B,S,H,P), dt (B,S,H), A (H,), B and C (B,S,N)")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (Bsz, S, N) or tuple(Cm.shape) != (Bsz, S, N)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if min(Bsz, S, H, P, N) == 0:
        raise ValueError("empty scan")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, B, C dtypes {x.dtype}/{Bm.dtype}/{Cm.dtype}: need one of "
                         f"{tuple(DTYPES)} for all three")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, not {dt.dtype}/{A.dtype}")
    tensors = [x, dt, A, Bm, Cm]
    if initial_state is not None:
        if tuple(initial_state.shape) != (Bsz, H, P, N) or initial_state.dtype != torch.float32:
            raise ValueError(f"initial_state must be ({Bsz}, {H}, {P}, {N}) float32")
        tensors.append(initial_state)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be CUDA tensors on one device")
    if not (dt.is_contiguous() and A.is_contiguous()
            and (initial_state is None or initial_state.is_contiguous())):
        raise ValueError("dt, A and initial_state must be contiguous")
    strides = (_row_stride(x), _row_stride(Bm), _row_stride(Cm))
    if None in strides:
        raise ValueError("x, B and C need contiguous inner dims and a fixed distance "
                         "between positions")
    return strides


def check_bf16(P: int, N: int, chunk: int, tensors, strides) -> None:
    """Raise ValueError for what the bf16 route does not take: P or N not a
    multiple of 16 or above MAX_DIM, a chunk above MAX_DIM, or x/B/C not on
    a 16-byte boundary with positions a multiple of 16 bytes apart."""
    if P % 16 or N % 16 or P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"bf16 SSD scan needs P and N multiples of 16 and at most "
                         f"{MAX_DIM}, not P={P}, N={N}")
    if chunk > MAX_DIM:
        raise ValueError(f"bf16 SSD scan needs chunk <= {MAX_DIM}, not {chunk}")
    if any(t.data_ptr() % 16 for t in tensors) or any(rs % 8 for rs in strides):
        raise ValueError("bf16 SSD scan needs x, B and C on a 16-byte boundary with "
                         "positions a multiple of 16 bytes apart")


def _padded_chunk(chunk: int) -> int:
    return -(-chunk // 16) * 16


def launch_bf16(stages, dims, strides=(0, 0, 0), *, x=None, dt=None, A=None, Bm=None,
                 Cm=None, init=None, y=None, fs=None, cb=None, states=None, decay=None):
    """Launch the bf16 kernels in ``stages`` (a sum of STAGES' bits) on the
    current stream; None stands for a tensor those stages do not touch."""
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    device = next(t.device for t in (x, Bm, states) if t is not None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel().ssd_scan_bf16_fwd(
            ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm), ptr(init), ptr(y), ptr(fs),
            ptr(cb), ptr(states), ptr(decay), *dims, *strides, stages, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan bf16 kernel launch failed: CUDA error {err}")


def bf16_scratch(Bsz, S, H, P, N, chunk, device):
    """(cb, states, decay) for one call, fp32, uninitialised."""
    nc, Tp = -(-S // chunk), _padded_chunk(chunk)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((Bsz, nc, Tp, Tp), **f32), torch.empty((Bsz, nc, H, P, N), **f32),
            torch.empty((Bsz, H, nc), **f32))


def _forward(x, dt, A, Bm, Cm, initial_state, chunk: int, strides):
    """Launch the forward kernels; (y, final_state). ``chunk`` is already
    min(chunk, S)."""
    global launches
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    dims = (Bsz, S, H, P, N, chunk)
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    fs = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if x.dtype == torch.bfloat16:
        cb, states, decay = bf16_scratch(*dims, x.device)
        launch_bf16(sum(STAGES.values()), dims, strides, x=x, dt=dt, A=A, Bm=Bm, Cm=Cm,
                    init=initial_state, y=y, fs=fs, cb=cb, states=states, decay=decay)
    else:
        init_ptr = initial_state.data_ptr() if initial_state is not None else None
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _kernel().ssd_scan_fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                         Bm.data_ptr(), Cm.data_ptr(), init_ptr, y.data_ptr(),
                                         fs.data_ptr(), *dims, *strides, stream)
        if err != 0:
            raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        capture.captured(NAME)
    else:
        with _count_lock:  # the runtime's executor threads may launch concurrently
            launches += 1
    return y, fs


def _checked(x, dt, A, Bm, Cm, initial_state, chunk: int):
    """Raise ValueError for anything the forward kernels do not take;
    return (min(chunk, S), the row strides of x, B and C)."""
    strides = check_inputs(x, dt, A, Bm, Cm, initial_state)
    _, S, _, P = x.shape
    N = Bm.shape[-1]
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, not {chunk}")
    chunk = min(chunk, S)
    if x.dtype == torch.bfloat16:
        check_bf16(P, N, chunk, (x, Bm, Cm), strides)
    else:
        lib = _kernel()
        need, limit = lib.ssd_scan_smem_bytes(chunk, P, N), lib.ssd_scan_smem_limit()
        if need > limit:
            raise ValueError(f"chunk={chunk}, P={P}, N={N} needs {need} bytes of shared "
                             f"memory; a block has {limit}")
    return chunk, strides


class SSDScan(torch.autograd.Function):
    """K3 with a gradient: the forward kernels, and the hand-written
    backward kernels (``ssd_scan_bwd``), which recompute the chunk states
    from the saved inputs. Both raise ValueError for what they do not take
    (a CPU tensor, a chunk above ``ssd_scan_bwd.MAX_CHUNK``) before
    anything runs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state, chunk: int):
        from repro_torch.kernels import ssd_scan_bwd as _bwd  # imports this module

        chunk, strides = _checked(x, dt, A, Bm, Cm, initial_state, chunk)
        _bwd.check_chunk(chunk)
        y, fs = _forward(x, dt, A, Bm, Cm, initial_state, chunk, strides)
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, fs

    @staticmethod
    def backward(ctx, dy, dfinal_state):
        from repro_torch.kernels import ssd_scan_bwd as _bwd

        x, dt, A, Bm, Cm, initial_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dfinal_state is not None:
            dfinal_state = dfinal_state.contiguous()
        grads = _bwd.ssd_scan_bwd(x, dt, A, Bm, Cm, initial_state, dy, dfinal_state,
                                  chunk=ctx.chunk)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None)


def ssd_scan(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) (softplus'd)
    A: torch.Tensor,   # (H,) negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan on the card. Returns (y, final_state).

    Differentiable when a gradient is being taken: an input that requires
    grad sends the call through ``SSDScan``, whose backward is the
    hand-written kernels of ``ssd_scan_bwd`` (chunk at most 128)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, initial_state)):
        return SSDScan.apply(x, dt, A, Bm, Cm, initial_state, chunk)
    chunk, strides = _checked(x, dt, A, Bm, Cm, initial_state, chunk)
    return _forward(x, dt, A, Bm, Cm, initial_state, chunk, strides)


# ---- the bf16 route's four kernels one at a time, for the tests: the
# counterparts of ref.ssd_chunk_cb, ref.ssd_chunk_state, ref.ssd_state_pass
# and ref.ssd_chunk_scan. None of them counts in ``launches``.

def _bf16_inputs(x, dt, A, Bm, chunk):
    """Check x/dt/A/B (B doubling for C) for the bf16 route; returns (dims,
    strides) with the chunk cut to S."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the bf16 route takes bf16 x, B, C, not {x.dtype}")
    strides = check_inputs(x, dt, A, Bm, Bm, None)
    Bsz, S, H, P = x.shape
    chunk = min(chunk, S)
    check_bf16(P, Bm.shape[-1], chunk, (x, Bm), strides)
    return (Bsz, S, H, P, Bm.shape[-1], chunk), strides


def chunk_cb(Bm, Cm, *, chunk: int = 128) -> torch.Tensor:
    """``ssd_chunk_cb_kernel`` alone: CB (B, n_c, Tp, Tp) fp32 with Tp the
    chunk rounded up to 16; blocks above the diagonal stay 0."""
    if Bm.dtype != torch.bfloat16 or Cm.dtype != Bm.dtype or Bm.shape != Cm.shape:
        raise ValueError("need B and C (B, S, N) in bf16")
    if not (Bm.is_cuda and Cm.is_cuda):
        raise ValueError("B and C must be CUDA tensors")
    Bsz, S, N = Bm.shape
    T = min(chunk, S)
    strides = (_row_stride(Bm), _row_stride(Cm))
    if None in strides:
        raise ValueError("B and C need a contiguous inner dim and a fixed distance "
                         "between positions")
    check_bf16(16, N, T, (Bm, Cm), strides)
    cb = torch.zeros((Bsz, -(-S // T), _padded_chunk(T), _padded_chunk(T)),
                     dtype=torch.float32, device=Bm.device)
    launch_bf16(STAGES["ssd_chunk_cb_kernel"], (Bsz, S, 1, 16, N, T), (0, *strides),
                Bm=Bm, Cm=Cm, cb=cb)
    return cb


def chunk_state(x, dt, A, Bm, *, chunk: int = 128):
    """``ssd_chunk_state_kernel`` alone: (states (B, n_c, H, P, N), decay
    (B, H, n_c) = exp(cs_last)), fp32."""
    dims, strides = _bf16_inputs(x, dt, A, Bm, chunk)
    _, states, decay = bf16_scratch(*dims, x.device)
    launch_bf16(STAGES["ssd_chunk_state_kernel"], dims, strides, x=x, dt=dt, A=A, Bm=Bm,
                states=states, decay=decay)
    return states, decay


def pass_states(states, decay, initial_state, fs) -> None:
    """``ssd_state_pass_kernel`` in place, through the ``ssd_state_pass``
    entry point (any P and N): ``states`` (B, n_c, H, P, N) become the
    state entering each chunk and ``fs`` (B, H, P, N) gets the final
    state; ``decay`` (B, H, n_c); ``initial_state`` None is zeros. All
    contiguous fp32 CUDA tensors on one device; raises ValueError
    otherwise. The backward runs it on chunks in reversed order too. Not
    counted in ``launches``."""
    Bsz, nc, H, P, N = states.shape
    want = {"states": (states, (Bsz, nc, H, P, N)), "decay": (decay, (Bsz, H, nc)),
            "fs": (fs, (Bsz, H, P, N))}
    if initial_state is not None:
        want["initial_state"] = (initial_state, (Bsz, H, P, N))
    for name, (t, shape) in want.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or not t.is_cuda or t.device != states.device):
            raise ValueError(f"{name} must be a contiguous fp32 {shape} CUDA tensor on "
                             f"{states.device}")
    init_ptr = initial_state.data_ptr() if initial_state is not None else None
    with torch.cuda.device(states.device):
        err = _kernel().ssd_state_pass(states.data_ptr(), decay.data_ptr(), init_ptr,
                                       fs.data_ptr(), Bsz, H, P, N, nc,
                                       torch.cuda.current_stream(states.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_state_pass launch failed: CUDA error {err}")


def chunk_scan(x, dt, A, Cm, cb, states_in, *, chunk: int = 128) -> torch.Tensor:
    """``ssd_chunk_scan_kernel`` alone: y (B, S, H, P) bf16 from CB (B, n_c,
    Tp, Tp) and the entering states (B, n_c, H, P, N), both fp32."""
    dims, (x_rs, c_rs, _) = _bf16_inputs(x, dt, A, Cm, chunk)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    launch_bf16(STAGES["ssd_chunk_scan_kernel"], dims, (x_rs, 0, c_rs), x=x, dt=dt, A=A,
                Cm=Cm, y=y, cb=cb.contiguous(), states=states_in.contiguous())
    return y
