"""Backend dispatch for the hand-written kernels (the JAX package's
``use_pallas`` becomes ``use_kernel``).

* ``use_kernel="auto"``: a CUDA tensor goes to the CUDA kernel, a CPU tensor
  to the plain PyTorch version. The choice follows the tensor's device only:
  a CUDA tensor that the kernel refuses raises, it never falls back.
* ``use_kernel=True``: the kernel; a CPU tensor raises.
* ``use_kernel=False``: the plain version on whatever device the tensors are
  (``chip_smoke.py`` compares the kernel with it on the card).

Unlike the JAX ``ops.ssd_scan``, which takes its oracle whenever
``initial_state`` is given, the CUDA SSD kernel takes an initial state, so
here too the choice follows the device alone.

Gradients: on the card ``flash_attention`` and ``ssd_scan`` are
differentiable: each wrapper goes through an autograd Function whose
backward is a hand-written kernel (K1's backward, and K3's in
``ssd_scan_bwd``). The plain versions are differentiable by autograd, so
every family trains on the CPU and on the card.

Sharded tensors: a ``DTensor`` (a cell's step on a mesh) goes to
``distributed.local``, which runs the entry point below on each rank's
shards through ``local_map`` with stated placements (heads over
``model`` for K1 and K3, or K1's query rows where its heads do not
divide, merged by ``flash_attention_lse`` and differentiated by
``flash_attention_bwd``; the cache's sequence over ``model`` for K2, whose
per-shard partials are merged across ranks). The kernels never see a
``DTensor``, and no weight is gathered whole for them.

Accounting: while ``analysis.op_analysis.analyze_step`` runs, ``counter``
is its counter, and each call below (with its backward) counts there as
one unit of work, whichever route runs; otherwise it is None and a call
pays that one check.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.compat import is_dtensor
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd

#: ``analyze_step``'s counter while it runs, else None
counter = None


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
    if is_dtensor(q):
        from repro_torch.distributed import local
        return local.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                     block_k=block_k, scale=scale, use_kernel=use_kernel)
    if counter is not None and counter.outside():
        return counter.unit(_fa.NAME, flash_attention, q, k, v, causal=causal,
                            block_q=block_q, block_k=block_k, scale=scale,
                            use_kernel=use_kernel)
    if _resolve(use_kernel, q):
        return _fa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                   block_k=block_k, scale=scale)
    return _ref.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, scale=scale)


def flash_attention_lse(q, k, v, *, causal=True, scale=None, use_kernel="auto"):
    """K1's forward with each row's log-sum-exp, and no gradient: (out, lse
    fp32 (B, Hq, Sq)). For a caller that merges several calls by their
    log-sum-exps and differentiates the merge with ``flash_attention_bwd``
    (``distributed.local``'s attention split by query rows)."""
    with torch.no_grad():
        if counter is not None and counter.outside():
            return counter.unit(_fa.NAME, flash_attention_lse, q, k, v, causal=causal,
                                scale=scale, use_kernel=use_kernel)
        if _resolve(use_kernel, q):
            return _fa.flash_attention_lse(q, k, v, causal=causal, scale=scale)
        return (_ref.flash_attention(q, k, v, causal=causal, scale=scale),
                _ref.attention_lse(q, k, causal=causal, scale=scale))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, scale=None, use_kernel="auto"):
    """K1's backward from the forward's (possibly merged) output and
    log-sum-exp: (dq, dk, dv)."""
    if counter is not None and counter.outside():
        return counter.unit(_fab.NAME, flash_attention_bwd, q, k, v, o, lse, do,
                            causal=causal, scale=scale, use_kernel=use_kernel)
    if _resolve(use_kernel, q):
        return _fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    return _ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *, block_k=1024, scale=None,
                     use_kernel="auto", partials=False):
    """With ``partials`` the unnormalised per-split partials (acc (B, Hq, n,
    Dh), (m, l) (B, Hq, n, 2), fp32) in place of the output, for a merge
    with other shards' (``distributed.local.merge_partials``)."""
    if is_dtensor(k_cache):
        from repro_torch.distributed import local
        return local.decode_attention(q, k_cache, v_cache, lengths, block_k=block_k,
                                      scale=scale, use_kernel=use_kernel)
    if counter is not None and counter.outside():
        return counter.unit(_dec.NAME, decode_attention, q, k_cache, v_cache, lengths,
                            block_k=block_k, scale=scale, use_kernel=use_kernel,
                            partials=partials)
    if _resolve(use_kernel, q):
        fn = _dec.decode_attention_partials if partials else _dec.decode_attention
        return fn(q, k_cache, v_cache, lengths, block_k=block_k, scale=scale)
    fn = _ref.decode_attention_partials if partials else _ref.decode_attention
    return fn(q, k_cache, v_cache, lengths, block_k=block_k, scale=scale)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=128, initial_state=None, use_kernel="auto"):
    if is_dtensor(x):
        from repro_torch.distributed import local
        return local.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state,
                              use_kernel=use_kernel)
    if counter is not None and counter.outside():
        return counter.unit(_ssd.NAME, ssd_scan, x, dt, A, Bm, Cm, chunk=chunk,
                            initial_state=initial_state, use_kernel=use_kernel)
    if _resolve(use_kernel, x):
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    return _ref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
