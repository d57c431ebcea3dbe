"""Backend dispatch for the hand-written kernels (the JAX package's
``use_pallas`` becomes ``use_kernel``).

* ``use_kernel="auto"``: a CUDA tensor goes to the CUDA kernel, a CPU tensor
  to the plain PyTorch version. The choice follows the tensor's device only:
  a CUDA tensor that the kernel refuses raises, it never falls back.
* ``use_kernel=True``: the kernel; a CPU tensor raises.
* ``use_kernel=False``: the plain version on whatever device the tensors are
  (``chip_smoke.py`` compares the kernel with it on the card).

``decode_attention`` and ``ssd_scan`` are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref


def _resolve(use_kernel, x: torch.Tensor) -> bool:
    if use_kernel == "auto":
        return x.is_cuda
    if use_kernel is True:
        if not x.is_cuda:
            raise ValueError("use_kernel=True needs CUDA tensors; the kernels "
                             "run only on the card")
        return True
    if use_kernel is False:
        return False
    raise ValueError(f"use_kernel must be 'auto', True or False, not {use_kernel!r}")


def flash_attention(q, k, v, *, causal=True, block_q=512, block_k=512,
                    scale=None, use_kernel="auto"):
    if _resolve(use_kernel, q):
        return _fa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                   block_k=block_k, scale=scale)
    return _ref.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, scale=scale)
