"""The chunked SSD scan's backward (K3's gradient): the hand-written CUDA
kernels for Hopper and their wrapper.

The JAX package has no backward kernel to port: it differentiates its
reference scan (``repro/models/mamba2.py::ssd_chunked_ref``) with XLA. The
port's model calls K3's forward kernel, whose outputs are written through
ctypes, so ``kernels.ssd_scan`` wraps it in a ``torch.autograd.Function``
whose backward is this kernel: ``csrc/ssd_scan_bwd.cu`` (its note says
what it computes, what bounds it and how it is laid out). Both routes run
on one stream with no atomics, so two calls give the same bits, and both
use the state pass of ``csrc/ssd_scan.cu`` twice: forwards over the chunk
states (the states entering each chunk) and over the chunk adjoints in
reversed order (their gradients). ``PARTS`` lists each route's launches:

* fp32, fp32 FMA on the CUDA cores (the reduced configs; within 1e-3):
  a chunk kernel (the chunk states and adjoints), the passes, a grad
  kernel per (sequence, chunk, head), and the sums over heads;
  ``ref.ssd_scan_bwd`` is its arithmetic step by step.
* bf16, every chunk product on the tensor cores (``mma.sync``):
  ``csrc/ssd_scan.cu``'s C B^T (once per (sequence, chunk)) and
  chunk-state kernels, this file's adjoint kernel, the passes, a grad
  kernel per (sequence, chunk, group of ``heads_per_block`` heads) that
  sums the group's dB and dC, and the sums over groups;
  ``ref.ssd_scan_bwd_bf16`` rounds exactly what its kernels round.

The wrapper takes the forward's inputs as ``ssd_scan.check_inputs`` takes
them (x, B and C may be strided views of one fused tensor; bf16 also as
``ssd_scan.check_bf16`` takes them), dy of x's shape and dtype
(contiguous) and dfinal_state (B, H, P, N) fp32 or None (zeros), with a
chunk of at most ``MAX_CHUNK``. It returns (dx, ddt, dA, dB, dC,
dinitial_state): dx, dB and dC contiguous in x's dtype, the rest fp32;
dinitial_state is the gradient of a zero initial state when initial_state
is None. It raises ValueError on anything else and never falls back to the
plain version or to the other route. ``launches`` counts calls that
launched the kernels (one per backward); ``launch_parts`` runs one of
them alone, for timing, and does not count.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as ssd

NAME = "ssd_scan_bwd"
#: the chunk: at most this (a chunk x chunk block of the grad kernels)
MAX_CHUNK = 128
#: stands in ``PARTS`` for ``ssd.pass_states`` run twice: forwards over the
#: chunk states, then over the adjoints in reversed chunk order
PASS = "ssd_state_pass_kernel"
#: each route's launches in order, by kernel name
PARTS = {
    torch.float32: ("ssd_bwd_chunk_kernel", PASS, "ssd_bwd_grad_kernel",
                    "ssd_bwd_reduce_kernel"),
    torch.bfloat16: ("ssd_chunk_cb_kernel", "ssd_chunk_state_kernel", "ssd_bwd_adj_kernel", PASS,
                     "ssd_bwd_grad_bf16_kernel", "ssd_bwd_reduce_kernel"),
}
# the kernels of csrc/ssd_scan_bwd.cu (PARTS' others are csrc/ssd_scan.cu's),
# by the bit of their route's C entry point that launches each
_BITS = {"ssd_bwd_chunk_kernel": 1, "ssd_bwd_grad_kernel": 2, "ssd_bwd_adj_kernel": 1,
         "ssd_bwd_grad_bf16_kernel": 2, "ssd_bwd_reduce_kernel": 4}
#: the kernels of csrc/ssd_scan_bwd.cu
KERNELS = tuple(_BITS)
#: blocks the bf16 grad kernel's grid should have at least: the H100's SMs
#: (a constant, so that the sums' order, and so the bits, do not depend on
#: the card)
FILL_BLOCKS = 132
#: shared memory one block may use on the H100, in bytes
SMEM_LIMIT = 232448

#: backward calls that launched the kernels in this process
launches = 0

_lib = None
_count_lock = threading.Lock()


def _kernel():
    """Build (once per process) and bind the C entry points."""
    global _lib
    if _lib is None:
        lib = _build.load(NAME)
        lib.ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [
            ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        lib.ssd_scan_bwd.restype = ctypes.c_int
        lib.ssd_scan_bwd_bf16.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + [
            ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        lib.ssd_scan_bwd_bf16.restype = ctypes.c_int
        _lib = lib
    return _lib


def load() -> None:
    """Build and load the kernel library without launching anything."""
    _kernel()


def grad_smem(Tp: int, P: int, N: int, G: int) -> int:
    """Bytes of shared memory of the bf16 grad kernel for a group of G heads
    (csrc/ssd_scan_bwd.cu's GradSmem): B and C [Tp][N], and per head x and
    dy [Tp][P], Ŝ and S_in [P][N] (bf16 rows padded by 8), 9 fp32 vectors
    [Tp] and 396 fp32 of reduction scratch."""
    def tile(rows, d):
        return 2 * rows * (d + 8)

    return 2 * tile(Tp, N) + G * (2 * tile(Tp, P) + 2 * tile(P, N) + 4 * 9 * Tp + 4 * 396)


def heads_per_block(Bsz: int, nc: int, H: int, Tp: int, P: int, N: int) -> int:
    """Heads per block of the bf16 grad kernel, which sums their dB and dC
    before writing partials: the largest of 4 and 2 that divides H, fits
    the block's shared memory and leaves at least ``FILL_BLOCKS`` blocks,
    else 1."""
    for g in (4, 2):
        if (H % g == 0 and grad_smem(Tp, P, N, g) <= SMEM_LIMIT
                and Bsz * nc * (H // g) >= FILL_BLOCKS):
            return g
    return 1


def check_chunk(chunk: int) -> None:
    """Raise ValueError for a chunk (already min(chunk, S)) the kernel does
    not take."""
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"the SSD scan's backward needs 0 < chunk <= {MAX_CHUNK}, "
                         f"not {chunk}")


def check_inputs(x, dt, A, Bm, Cm, initial_state, dy, dfinal_state,
                 chunk: int) -> Tuple[int, int, int]:
    """Raise ValueError for anything the kernel does not take; return the
    row strides of x, B and C."""
    strides = ssd.check_inputs(x, dt, A, Bm, Cm, initial_state)
    chunk = min(chunk, x.shape[1])
    check_chunk(chunk)
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"dy must be x's shape {tuple(x.shape)} and dtype {x.dtype}, "
                         f"not {tuple(dy.shape)} {dy.dtype}")
    rest = [dy]
    if dfinal_state is not None:
        want = (x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1])
        if tuple(dfinal_state.shape) != want or dfinal_state.dtype != torch.float32:
            raise ValueError(f"dfinal_state must be {want} float32")
        rest.append(dfinal_state)
    if not all(t.is_contiguous() for t in rest):
        raise ValueError("dy and dfinal_state must be contiguous")
    if not all(t.is_cuda and t.device == x.device for t in rest):
        raise ValueError("dy and dfinal_state must be CUDA tensors on x's device")
    if x.dtype == torch.bfloat16:
        ssd.check_bf16(x.shape[3], Bm.shape[-1], chunk, (x, Bm, Cm, dy), strides)
    return strides


def _buffer_specs(x, Bm, chunk: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """(shape, dtype) of each buffer of one call, by name; ``chunk`` is
    already min(chunk, S)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc, Tp = -(-S // chunk), -(-chunk // 16) * 16
    f32 = torch.float32
    # the partials of dB and dC: one per head (fp32) or per group of heads (bf16)
    parts = H // heads_per_block(Bsz, nc, H, Tp, P, N) if x.dtype == torch.bfloat16 else H
    specs = {"states": ((Bsz, nc, H, P, N), f32), "adj": ((Bsz, nc, H, P, N), f32),
             "decay": ((Bsz, H, nc), f32), "decay_rev": ((Bsz, H, nc), f32),
             "dBp": ((parts, Bsz, S, N), f32), "dCp": ((parts, Bsz, S, N), f32),
             "dAp": ((H, Bsz * nc), f32), "fs": ((Bsz, H, P, N), f32),
             "dx": ((Bsz, S, H, P), x.dtype), "ddt": ((Bsz, S, H), f32), "dA": ((H,), f32),
             "dB": ((Bsz, S, N), x.dtype), "dC": ((Bsz, S, N), x.dtype),
             "dinit": ((Bsz, H, P, N), f32)}
    if x.dtype == torch.bfloat16:
        specs["cb"] = ((Bsz, nc, Tp, Tp), f32)
    return specs


def new_buffers(x, Bm, chunk: int) -> Dict[str, torch.Tensor]:
    """The kernels' fp32 scratch and the outputs for one call,
    uninitialised: chunk states and adjoints (B, n_c, H, P, N), decays in
    chunk order and reversed (B, H, n_c), the partials of dB and dC (per
    head for fp32, per group of heads for bf16; (parts, B, S, N)) and of dA
    (H, B * n_c), the forward pass's final state (unused), for bf16 C B^T
    (B, n_c, Tp, Tp) with Tp the chunk rounded up to 16; dx, ddt, dA, dB,
    dC, dinitial_state. ``chunk`` is already min(chunk, S)."""
    return {name: torch.empty(shape, dtype=dtype, device=x.device)
            for name, (shape, dtype) in _buffer_specs(x, Bm, chunk).items()}


def _launch(name: str, x, dt, A, Bm, Cm, dy, bufs, chunk: int, strides,
            initial_state=None, dfinal_state=None) -> None:
    """Launch the part ``name`` of PARTS on the current stream, unchecked."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if name == PASS:
        ssd.pass_states(bufs["states"], bufs["decay"], initial_state, bufs["fs"])
        ssd.pass_states(bufs["adj"], bufs["decay_rev"], dfinal_state, bufs["dinit"])
        return
    if name in ssd.STAGES:
        ssd.launch_bf16(ssd.STAGES[name], (Bsz, S, H, P, N, chunk), strides, x=x, dt=dt, A=A,
                        Bm=Bm, Cm=Cm, cb=bufs["cb"], states=bufs["states"],
                        decay=bufs["decay"])
        return
    ptrs = [t.data_ptr() for t in (x, dt, A, Bm, Cm, dy)]
    out = [bufs[k].data_ptr() for k in ("dBp", "dCp", "dAp", "dx", "ddt", "dA", "dB", "dC")]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.bfloat16:
            G = H // bufs["dBp"].shape[0]
            err = _kernel().ssd_scan_bwd_bf16(
                *ptrs, *(bufs[k].data_ptr() for k in ("cb", "states", "adj", "decay_rev")),
                *out, Bsz, S, H, P, N, chunk, G, *strides, _BITS[name], stream)
        else:
            err = _kernel().ssd_scan_bwd(
                *ptrs, *(bufs[k].data_ptr() for k in ("states", "adj", "decay", "decay_rev")),
                *out, Bsz, S, H, P, N, chunk, *strides, _BITS[name], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel {name} launch failed: CUDA error {err}")


def launch_parts(name: str, x, dt, A, Bm, Cm, dy, bufs, *, chunk: int = 128) -> None:
    """Launch the part ``name`` of ``PARTS[x.dtype]`` alone on the current
    stream, on ``bufs`` (``new_buffers``), with no initial state and no
    final state's gradient; each part reads what the parts before it left
    in ``bufs``. For timing each kernel; not counted in ``launches``.
    Raises ValueError for inputs ``check_inputs`` refuses, for a name that
    is not a part of x's route, and for buffers of another shape, dtype or
    device."""
    strides = check_inputs(x, dt, A, Bm, Cm, None, dy, None, chunk)
    chunk = min(chunk, x.shape[1])
    if name not in PARTS[x.dtype]:
        raise ValueError(f"{name} is not a part of the {x.dtype} route: {PARTS[x.dtype]}")
    for key, (shape, dtype) in _buffer_specs(x, Bm, chunk).items():
        t = bufs.get(key)
        if (t is None or tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"buffer {key} must be a contiguous {dtype} {shape} on "
                             f"{x.device}")
    _launch(name, x, dt, A, Bm, Cm, dy, bufs, chunk, strides)


def ssd_scan_bwd(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H) fp32
    A: torch.Tensor,    # (H,) fp32
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
    initial_state: Optional[torch.Tensor],  # (B, H, P, N) fp32
    dy: torch.Tensor,   # (B, S, H, P), x's dtype
    dfinal_state: Optional[torch.Tensor],   # (B, H, P, N) fp32
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC, dinitial_state) on the card."""
    global launches
    strides = check_inputs(x, dt, A, Bm, Cm, initial_state, dy, dfinal_state, chunk)
    chunk = min(chunk, x.shape[1])
    bufs = new_buffers(x, Bm, chunk)
    for name in PARTS[x.dtype]:
        _launch(name, x, dt, A, Bm, Cm, dy, bufs, chunk, strides, initial_state, dfinal_state)
    with _count_lock:
        launches += 1
    return tuple(bufs[k] for k in ("dx", "ddt", "dA", "dB", "dC", "dinit"))
