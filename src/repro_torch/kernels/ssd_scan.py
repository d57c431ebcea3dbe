"""Mamba2's chunked SSD scan: the hand-written CUDA kernel for Hopper and
its wrapper.

Replaces ``repro/kernels/ssd_scan.py::_ssd_kernel`` (+ ``_segsum``), the
Pallas TPU kernel. The kernel is ``csrc/ssd_scan.cu``; its note says what
bounds it on the H100 and what the design does about that. In short: one
CTA per (head, sequence) runs the chunks in order with the (P, N) state in
fp32 in shared memory, reads B/C by (sequence, position) for every head,
treats a ragged last chunk as dt = 0 padding, and computes in fp32 FMA.

Unlike the TPU kernel it takes ``initial_state``, so ``ops.ssd_scan`` never
needs the plain version for a CUDA tensor. The wrapper keeps the JAX
signature: x (B, S, H, P) and B/C (B, S, N) in fp32 or bf16 (one dtype for
the three), dt (B, S, H) and A (H,) in fp32, initial_state (B, H, P, N)
fp32 or None. x, B and C may be views whose positions are a fixed number of
elements apart with the inner dims contiguous (the slices of the Mamba2
block's fused projection are); the rest must be contiguous. It raises on
anything else and never falls back to the plain version. Returns
(y (B, S, H, P) in x's dtype, final_state (B, H, P, N) fp32), both
allocated here; the kernel runs on the current stream and nothing
synchronises. ``launches`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NAME = "ssd_scan"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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
            ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_scan_smem_limit.argtypes = []
        lib.ssd_scan_smem_limit.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def load() -> None:
    """Build and load the kernel library without launching anything."""
    _kernel()


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
    """The chunked SSD scan on the card. Returns (y, final_state)."""
    global launches
    x_rs, b_rs, c_rs = check_inputs(x, dt, A, Bm, Cm, initial_state)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, not {chunk}")
    chunk = min(chunk, S)
    lib = _kernel()
    dtype = DTYPES[x.dtype]
    need, limit = lib.ssd_scan_smem_bytes(dtype, chunk, P, N), lib.ssd_scan_smem_limit()
    if need > limit:
        raise ValueError(f"chunk={chunk}, P={P}, N={N} needs {need} bytes of shared "
                         f"memory; a block has {limit}")
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    fs = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    init_ptr = initial_state.data_ptr() if initial_state is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                               Cm.data_ptr(), init_ptr, y.data_ptr(), fs.data_ptr(),
                               Bsz, S, H, P, N, chunk, x_rs, b_rs, c_rs, dtype, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    with _count_lock:  # the runtime's executor threads may launch concurrently
        launches += 1
    return y, fs
