"""The chunked SSD scan's backward (K3's gradient): the hand-written CUDA
kernel for Hopper and its wrapper.

The JAX package has no backward kernel to port: it differentiates its
reference scan (``repro/models/mamba2.py::ssd_chunked_ref``) with XLA. The
port's model calls K3's forward kernel, whose outputs are written through
ctypes, so ``kernels.ssd_scan`` wraps it in a ``torch.autograd.Function``
whose backward is this kernel: ``csrc/ssd_scan_bwd.cu`` (its note says
what it computes, what bounds it and how it is laid out). One call is five
launches on one stream with no atomics, so two calls give the same bits:
the chunk states and adjoints, the state pass of ``csrc/ssd_scan.cu``
forwards (the states entering each chunk) and on reversed chunks (their
gradients), the per-chunk gradients, and the sums over heads. All of it in
fp32 FMA on the CUDA cores, for fp32 and bf16 inputs alike;
``ref.ssd_scan_bwd`` is its arithmetic step by step.

The wrapper takes the forward's inputs as ``ssd_scan.check_inputs`` takes
them (x, B and C may be strided views of one fused tensor), dy of x's
shape and dtype (contiguous) and dfinal_state (B, H, P, N) fp32 or None
(zeros), with a chunk of at most ``MAX_CHUNK``. It returns (dx, ddt, dA,
dB, dC, dinitial_state): dx, dB and dC contiguous in x's dtype, the rest
fp32; dinitial_state is the gradient of a zero initial state when
initial_state is None. It raises ValueError on anything else and never
falls back to the plain version. ``launches`` counts calls that launched
the kernels (one per backward); ``launch_parts`` runs some of the kernels
alone, for timing, and does not count.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as ssd

NAME = "ssd_scan_bwd"
#: the chunk: at most this (the grad kernel keeps two chunk x chunk matrices)
MAX_CHUNK = 128
#: the kernels of this source, by the bit of ``launch`` that launches each;
#: the wrapper runs ``ssd.pass_states`` twice between the first two
PARTS = {"ssd_bwd_chunk_kernel": 1, "ssd_bwd_grad_kernel": 2, "ssd_bwd_reduce_kernel": 4}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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
            ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ssd_scan_bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def load() -> None:
    """Build and load the kernel library without launching anything."""
    _kernel()


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
    check_chunk(min(chunk, x.shape[1]))
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
    return strides


def _buffer_specs(x, Bm, chunk: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """(shape, dtype) of each buffer of one call, by name; ``chunk`` is
    already min(chunk, S)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    f32 = torch.float32
    return {"states": ((Bsz, nc, H, P, N), f32), "adj": ((Bsz, nc, H, P, N), f32),
            "decay": ((Bsz, H, nc), f32), "decay_rev": ((Bsz, H, nc), f32),
            "dBp": ((H, Bsz, S, N), f32), "dCp": ((H, Bsz, S, N), f32),
            "dAp": ((H, Bsz * nc), f32), "fs": ((Bsz, H, P, N), f32),
            "dx": ((Bsz, S, H, P), x.dtype), "ddt": ((Bsz, S, H), f32), "dA": ((H,), f32),
            "dB": ((Bsz, S, N), x.dtype), "dC": ((Bsz, S, N), x.dtype),
            "dinit": ((Bsz, H, P, N), f32)}


def new_buffers(x, Bm, chunk: int) -> Dict[str, torch.Tensor]:
    """The kernels' fp32 scratch and the outputs for one call,
    uninitialised: chunk states and adjoints (B, n_c, H, P, N), decays in
    chunk order and reversed (B, H, n_c), the per-head partials of dB and
    dC (H, B, S, N) and of dA (H, B * n_c), the forward pass's final state
    (unused); dx, ddt, dA, dB, dC, dinitial_state. ``chunk`` is already
    min(chunk, S)."""
    return {name: torch.empty(shape, dtype=dtype, device=x.device)
            for name, (shape, dtype) in _buffer_specs(x, Bm, chunk).items()}


def _launch(parts: int, x, dt, A, Bm, Cm, dy, bufs, chunk: int, strides) -> None:
    """Launch the kernels in ``parts`` on the current stream, unchecked."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    with torch.cuda.device(x.device):
        err = _kernel().ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dy.data_ptr(), *(bufs[k].data_ptr() for k in (
                "states", "adj", "decay", "decay_rev", "dBp", "dCp", "dAp", "dx", "ddt", "dA",
                "dB", "dC")),
            Bsz, S, H, P, N, chunk, *strides, DTYPES[x.dtype], int(parts),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: CUDA error {err}")


def launch_parts(parts: int, x, dt, A, Bm, Cm, dy, bufs, *, chunk: int = 128) -> None:
    """Launch the kernels in ``parts`` (a sum of PARTS' bits) alone on the
    current stream, on ``bufs`` (``new_buffers``); the grad kernel reads
    the states and adjoints as their passes (``ssd_scan.pass_states``)
    left them. For timing each kernel; not counted in ``launches``. Raises
    ValueError for inputs ``check_inputs`` refuses and for buffers of
    another shape, dtype or device."""
    strides = check_inputs(x, dt, A, Bm, Cm, None, dy, None, chunk)
    chunk = min(chunk, x.shape[1])
    for name, (shape, dtype) in _buffer_specs(x, Bm, chunk).items():
        t = bufs.get(name)
        if (t is None or tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"buffer {name} must be a contiguous {dtype} {shape} on "
                             f"{x.device}")
    _launch(parts, x, dt, A, Bm, Cm, dy, bufs, chunk, strides)


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
    first = PARTS["ssd_bwd_chunk_kernel"]
    _launch(first, x, dt, A, Bm, Cm, dy, bufs, chunk, strides)
    ssd.pass_states(bufs["states"], bufs["decay"], initial_state, bufs["fs"])
    ssd.pass_states(bufs["adj"], bufs["decay_rev"], dfinal_state, bufs["dinit"])
    _launch(sum(PARTS.values()) - first, x, dt, A, Bm, Cm, dy, bufs, chunk, strides)
    with _count_lock:
        launches += 1
    return tuple(bufs[k] for k in ("dx", "ddt", "dA", "dB", "dC", "dinit"))
