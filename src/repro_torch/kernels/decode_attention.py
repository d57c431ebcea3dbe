"""Decode attention (one new token per sequence against a KV cache, GQA,
per-sequence lengths): the hand-written CUDA kernel for Hopper and its
wrapper.

Replaces ``repro/kernels/decode_attention.py::_decode_kernel``, the Pallas
TPU kernel. The kernel is ``csrc/decode_attention.cu``; its note says what
bounds it on the H100 and what the design does about that. In short:
split-K (flash-decoding). The cache of each (sequence, KV head) is cut into
``n_split`` runs of 64-key tiles, one CTA each, holding the G query rows of
that head, with m/l/acc in fp32 FMA (no TF32); positions ``>= length`` are
masked and tiles wholly past the length are not loaded. A second small
kernel merges the per-split partials as ``ref._combine_partials`` does. At
length 0 it returns 0, as the TPU kernel does (the plain version returns
the mean of V there).

``n_split`` is ``num_splits(B, Hkv, L, sm_count)``: about one wave of CTAs,
computed from the cache capacity ``L`` and never from ``lengths``, so the
call never syncs the host.

The wrapper keeps the JAX signature and layouts: q (B, 1, Hq, Dh), caches
(B, L, Hkv, Dh) read in place (the contiguous ``[period]`` view of a
stacked cache is fine), ``lengths`` (B,) int32 on the card, read by the
kernel. It takes fp32 or bf16 with Dh in {16, 32, 64, 128}, at most 16
query heads per KV head, contiguous tensors that start on a 16-byte
boundary, and raises on anything else; it never falls back to the plain
version. The output and the fp32 scratch of the partials are allocated here
on every call (the runtime's executor threads launch concurrently, so
nothing is shared); both kernels run on the current stream and nothing
synchronises. ``launches`` counts calls that launched the kernel pair: one
per call, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "decode_attention"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 16  # query heads per KV head (kMaxGroup in the kernel)
BLOCK_K = 64    # keys per tile (kBlockK in the kernel)

#: calls of ``decode_attention`` that launched the kernel pair in this process
launches = 0

_fn = None
_count_lock = threading.Lock()


def _kernel():
    """Build (once per process) and bind the C entry point."""
    global _fn
    if _fn is None:
        fn = _build.load(NAME).decode_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def load() -> None:
    """Build and load the kernel library without launching anything."""
    _kernel()


def num_splits(B: int, Hkv: int, L: int, sm_count: int) -> int:
    """Splits of the cache per (sequence, KV head): about one wave of
    ``B * Hkv * n_split`` CTAs on ``sm_count`` SMs, each split a run of
    whole 64-key tiles, none of them empty at full length. Depends on the
    capacity ``L`` only, never on the lengths."""
    tiles = -(-L // BLOCK_K)
    want = max(1, -(-sm_count // (B * Hkv)))
    per = -(-tiles // min(tiles, want))  # tiles per split
    return -(-tiles // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_inputs(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lengths: torch.Tensor) -> None:
    """Raise ValueError for anything the kernel does not take."""
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("q must be (B, 1, Hq, Dh) and the caches (B, L, Hkv, Dh)")
    B, Sq, Hq, Dh = q.shape
    Bk, L, Hkv, Dk = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or Bk != B or Dk != Dh or Sq != 1:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache {tuple(v_cache.shape)}")
    if B == 0 or L == 0:
        raise ValueError("empty decode attention")
    if Hkv == 0 or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}, "
                         f"with at most {MAX_GROUP} query heads per KV head")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: need one "
                         f"of {tuple(DTYPES)} for all three")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({B},) int32, not {tuple(lengths.shape)} "
                         f"{lengths.dtype}")
    tensors = (q, k_cache, v_cache, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, the caches and lengths must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q and the caches must start on a 16-byte boundary "
                         "(the kernel copies 16 bytes at a time)")
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("q, the caches and lengths must be CUDA tensors on one device")


def decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, Dh)
    k_cache: torch.Tensor,  # (B, L, Hkv, Dh)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32 valid lengths
    *,
    block_k: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention on the card. ``block_k`` is accepted for the JAX
    signature; the kernel picks its own tiles and splits."""
    del block_k
    return _launch(q, k_cache, v_cache, lengths, scale)[0]


def decode_attention_partials(q, k_cache, v_cache, lengths, *, block_k: int = 1024,
                              scale: Optional[float] = None):
    """The same launch, returning the per-split partials the combine kernel
    merged: acc (B, Hq, n_split, Dh), unnormalised, and (m, l) (B, Hq,
    n_split, 2), fp32; a split past a length holds m = -1e30 (the
    kernel's kNegInf), l = 0, acc = 0. A cache split over ranks along the
    sequence merges these across ranks (``distributed.local``)."""
    del block_k
    return _launch(q, k_cache, v_cache, lengths, scale)[1:]


def _launch(q, k_cache, v_cache, lengths, scale):
    global launches
    check_inputs(q, k_cache, v_cache, lengths)
    B, _, Hq, Dh = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    n_split = num_splits(B, Hkv, L, _sm_count(q.device.index))
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    fn = _kernel()
    out = torch.empty_like(q)
    part_acc = torch.empty((B, Hq, n_split, Dh), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, Hq, n_split, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, L, Hq, Hkv, Dh,
                 DTYPES[q.dtype], n_split, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    with _count_lock:  # the runtime's executor threads may launch concurrently
        launches += 1
    return out, part_acc, part_ml
