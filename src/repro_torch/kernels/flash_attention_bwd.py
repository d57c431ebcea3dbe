"""Flash attention backward (K1's gradient): the hand-written CUDA kernel for
Hopper and its wrapper.

The JAX package has no backward kernel to port: it differentiates its
reference attention (``repro/models/layers.py::flash_attention_ref``) with
XLA. The port's model calls K1's forward kernel, whose output is written
through ctypes, so ``kernels.flash_attention`` wraps it in a
``torch.autograd.Function`` whose backward is this kernel:
``csrc/flash_attention_bwd.cu`` (FlashAttention-2's equations from the
forward's output and log-sum-exp; three kernels on one stream, no
atomics, so two calls give the same bits; its note says what bounds it).
fp32 inputs take fp32 FMA kernels on the CUDA cores; bf16 inputs take
FlashAttention-2's backward on the tensor cores (``mma.sync``, P and dS
rounded to bf16 in registers, fp32 sums: ``ref.flash_attention_bwd_bf16``
is its arithmetic step by step).

The wrapper takes the forward's q, k, v, o (contiguous CUDA tensors of one
dtype, fp32 or bf16, Dh in {16, 32, 64, 128}, 16-byte aligned), its fp32
(B, Hq, Sq) log-sum-exp and the output's gradient, and returns (dq, dk, dv)
in the inputs' dtype. It raises on anything else and never falls back to
the plain version (``ref.flash_attention_bwd``). ``launches`` counts calls
that launched the kernels (one per backward, three CUDA kernels each).
``launch_parts`` launches some of the bf16 kernels alone, for timing; it
does not count.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

NAME = "flash_attention_bwd"

#: the bf16 route's kernels, by the bit of ``launch_parts`` that launches each
PARTS = {"flash_bwd_dot_bf16_kernel": 1, "flash_bwd_dkdv_bf16_kernel": 2,
         "flash_bwd_dq_bf16_kernel": 4}

#: backward calls that launched the kernels in this process
launches = 0

_lib = None
_count_lock = threading.Lock()


def _kernel():
    """Build (once per process) and bind the C entry points."""
    global _lib
    if _lib is None:
        lib = _build.load(NAME)
        lib.flash_attention_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_bf16_parts.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_bwd_bf16_parts.restype = ctypes.c_int
        _lib = lib
    return _lib


def load() -> None:
    """Build and load the kernel library without launching anything."""
    _kernel()


def check_inputs(q, k, v, o, lse, do) -> None:
    """Raise ValueError for anything the kernel does not take: q, k, v as
    the forward kernel takes them, o and do of q's shape and dtype, lse
    fp32 (B, Hq, Sq); all contiguous, 16-byte aligned, on q's device."""
    fa.check_inputs(q, k, v)
    B, Sq, Hq, _ = q.shape
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must be q's shape")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and do must be {q.dtype}, got {o.dtype} and {do.dtype}")
    if tuple(lse.shape) != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {(B, Hq, Sq)}, got {lse.dtype} {tuple(lse.shape)}")
    rest = (o, do, lse)
    if not all(t.is_contiguous() for t in rest):
        raise ValueError("o, do and lse must be contiguous")
    if any(t.data_ptr() % 16 for t in rest):
        raise ValueError("o, do and lse must start on a 16-byte boundary")
    if not all(t.is_cuda and t.device == q.device for t in rest):
        raise ValueError("o, do and lse must be CUDA tensors on q's device")


def flash_attention_bwd(
    q: torch.Tensor,    # (B, Sq, Hq, Dh)
    k: torch.Tensor,    # (B, Sk, Hkv, Dh)
    v: torch.Tensor,
    o: torch.Tensor,    # the forward's output, (B, Sq, Hq, Dh)
    lse: torch.Tensor,  # the forward's log-sum-exp, fp32 (B, Hq, Sq)
    do: torch.Tensor,   # the output's gradient, (B, Sq, Hq, Dh)
    *,
    causal: bool,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) on the card, in the inputs' dtype."""
    global launches
    check_inputs(q, k, v, o, lse, do)
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    lib = _kernel()
    scratch = new_scratch(q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Sk, Hq, Hkv, Dh, fa.DTYPES[q.dtype], float(scale), int(bool(causal)),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return dq, dk, dv


def new_scratch(q: torch.Tensor) -> torch.Tensor:
    """The kernels' fp32 scratch for q's shape, uninitialised: D =
    rowsum(dO * O) (fp32 route), or D and lse * log2 e in the tiles' packed
    row order (bf16 route)."""
    B, Sq, Hq, _ = q.shape
    return torch.empty((2, B, Hq, Sq), dtype=torch.float32, device=q.device)


def launch_parts(parts: int, q, k, v, o, lse, do, scratch, dq, dk, dv, *, causal: bool,
                 scale: Optional[float] = None) -> None:
    """Launch the bf16 kernels in ``parts`` (a sum of PARTS' bits) alone on
    the current stream, on ``scratch`` (``new_scratch``) and the given
    outputs; the dK/dV and dQ kernels read the scratch an earlier D pass
    wrote. For timing and testing each kernel; not counted
    in ``launches``."""
    check_inputs(q, k, v, o, lse, do)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"launch_parts takes bf16 tensors, got {q.dtype}")
    B, Sq, Hq, Dh = q.shape
    for name, t, shape, dtype in (("scratch", scratch, (2, B, Hq, Sq), torch.float32),
                                  ("dq", dq, q.shape, q.dtype), ("dk", dk, k.shape, k.dtype),
                                  ("dv", dv, v.shape, v.dtype)):
        if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned {dtype} "
                             f"{tuple(shape)} on {q.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    with torch.cuda.device(q.device):
        err = _kernel().flash_attention_bwd_bf16_parts(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, k.shape[1], Hq, k.shape[2], Dh, float(scale), int(bool(causal)), int(parts),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_bf16_parts launch failed: CUDA error {err}")
