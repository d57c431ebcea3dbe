"""Flash attention (causal or not, GQA): the hand-written CUDA kernel for
Hopper and its wrapper.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel``, the Pallas
TPU kernel. The kernel is ``csrc/flash_attention.cu``; its note says what
bounds it on the H100 and what the design does about that. In short: one
CTA owns one KV head and all G query heads of it for a tile of query
positions, loops over 64-key tiles with m/l/acc in fp32 registers and skips
the tiles above the causal diagonal. It has two paths: fp32 inputs run on
the CUDA cores in fp32 FMA (no TF32, so fp32 meets 3e-5); bf16 inputs run
on the tensor cores (``mma.sync`` m16n8k16 with fp32 sums, FlashAttention-2's
forward: 4 warps of 16 rows, a 2-stage ``cp.async`` ring of swizzled K/V
tiles, P reused from registers as the A operand of P.V).

The wrapper keeps the JAX signature and the (B, S, H, Dh) layout. It takes
contiguous fp32 or bf16 CUDA tensors with Dh in {16, 32, 64, 128} that
start on a 16-byte boundary, and raises on anything else; it never falls
back to the plain version. Outputs
are allocated here; the kernel runs on the current stream and nothing
synchronises. ``launches`` counts kernel launches (and nothing else): a
call inside a CUDA graph's capture launches nothing and goes to
``capture.tally`` instead, and whoever replays the graph adds the
captured calls (``add_launches``).

Gradients: when grad mode is on and q, k or v requires grad, the call goes
through ``FlashAttention``, a ``torch.autograd.Function``: its forward
launches the same kernel, which then also writes each row's log-sum-exp,
and saves q, k, v, the output and the log-sum-exp; its backward is the
hand-written backward kernel (``kernels.flash_attention_bwd``). Otherwise
(serving) the kernel is launched as it was, with no log-sum-exp.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build, capture

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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def load() -> None:
    """Build and load the kernel library without launching anything."""
    _kernel()


def add_launches(n: int) -> None:
    """Count ``n`` launches of calls captured into a CUDA graph, as the
    graph is replayed."""
    global launches
    with _count_lock:
        launches += n


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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary "
                         "(the bf16 kernel copies 16 bytes at a time)")
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (
            q.device == k.device == v.device):
        raise ValueError("q, k, v must be CUDA tensors on one device")


def _forward(q, k, v, causal: bool, scale: float, with_lse: bool):
    """Launch the forward kernel: (out, the fp32 (B, Hq, Sq) log-sum-exp or
    None)."""
    global launches
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    fn = _kernel()
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None,
                 B, Sq, Sk, Hq, Hkv, Dh, DTYPES[q.dtype], float(scale),
                 int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        capture.captured(NAME)
    else:
        with _count_lock:  # the runtime's executor threads may launch concurrently
            launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """K1 with a gradient: the forward kernel (with its log-sum-exp) and the
    hand-written backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = _forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import flash_attention_bwd as _bwd  # imports this module

        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd.flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                              causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_lse(q, k, v, *, causal: bool = True, scale: Optional[float] = None):
    """The forward kernel with each row's log-sum-exp, no gradient: (out,
    fp32 (B, Hq, Sq) log-sum-exp)."""
    check_inputs(q, k, v)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    return _forward(q, k, v, causal, scale, with_lse=True)


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
    """Attention forward on the card, differentiable when a gradient is
    being taken. ``block_q``/``block_k`` are accepted for the JAX
    signature; the kernel picks its own tiles."""
    del block_q, block_k
    check_inputs(q, k, v)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), scale)
    return _forward(q, k, v, causal, scale, with_lse=False)[0]
