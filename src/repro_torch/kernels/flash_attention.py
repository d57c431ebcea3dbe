"""Flash attention (causal or not, GQA): the hand-written CUDA kernel for
Hopper and its wrapper.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel``, the Pallas
TPU kernel. The kernel is ``csrc/flash_attention.cu``; its note says what
bounds it on the H100 and what the design does about that. In short: one
CTA owns one KV head and all G query heads of it for a tile of query
positions, loops over k tiles with m/l/acc in fp32 registers, skips the
tiles above the causal diagonal, and computes in fp32 FMA (no TF32).

The wrapper keeps the JAX signature and the (B, S, H, Dh) layout. It takes
contiguous fp32 or bf16 CUDA tensors with Dh in {16, 32, 64, 128} and
raises on anything else; it never falls back to the plain version. Outputs
are allocated here; the kernel runs on the current stream and nothing
synchronises. ``launches`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 64  # query heads per KV head: one CTA holds 64 (position, head) rows

#: kernel launches made by ``flash_attention`` in this process
launches = 0

_fn = None
_count_lock = threading.Lock()


def _kernel():
    """Build (once per process) and bind the C entry point."""
    global _fn
    if _fn is None:
        fn = _build.load(NAME).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def load() -> None:
    """Build and load the kernel library without launching anything."""
    _kernel()


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError for anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, Dh)")
    B, Sq, Hq, Dh = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != Dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError("empty attention")
    if Hkv == 0 or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}, "
                         f"with at most {MAX_GROUP} query heads per KV head")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                         f"{tuple(DTYPES)} for all three")
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (
            q.device == k.device == v.device):
        raise ValueError("q, k, v must be CUDA tensors on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Sk, Hkv, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention forward on the card. ``block_q``/``block_k`` are accepted
    for the JAX signature; the kernel picks its own tiles."""
    global launches
    del block_q, block_k
    check_inputs(q, k, v)
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    fn = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, Hq, Hkv, Dh, DTYPES[q.dtype], float(scale),
                 int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    with _count_lock:  # the runtime's executor threads may launch concurrently
        launches += 1
    return out
