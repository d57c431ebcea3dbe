"""Plain PyTorch versions of the hand-written kernels.

``flash_attention`` is the blockwise online-softmax attention of the JAX
package's ``repro.models.layers.flash_attention_ref``: causal mode splits
each query block into a mask-free prefix rectangle plus a masked diagonal
block merged by one online-softmax combine; non-causal mode scans fixed-size
kv blocks. It lives here (not in ``models.layers``) so that ``kernels`` never
imports ``models``; ``models.layers`` re-exports it as
``flash_attention_ref``.

It is what the CPU tests run, what ``ops`` takes for a CPU tensor, and what
``chip_smoke.py`` holds the CUDA kernel against on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _softmax_partial(qg, kj, vj, *, scale, mask=None):
    """Dense softmax partial over one kv span. qg:(B,cq,H,G,Dh),
    kj/vj:(B,ck,H,Dh) -> (m, l, acc) fp32."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), kj.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bqhgk,bkhd->bqhgd", p.to(vj.dtype).float(), vj.float())
    return m, l, acc


def _combine_partials(parts):
    """Merge online-softmax partials [(m,l,acc), ...] -> output fp32."""
    m = parts[0][0]
    for mp_, _, _ in parts[1:]:
        m = torch.maximum(m, mp_)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        c = torch.exp(mi - m)
        l = l + li * c
        acc = acc + ai * c[..., None]
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _attention_scan_kv(qg, k, v, *, scale, block_k):
    """Non-causal: fixed-length scan over kv blocks with online softmax."""
    B, Sq, Hkv, G, Dh = qg.shape
    Sk = k.shape[1]
    block_k = min(block_k, Sk)
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, Sq, Hkv, G, Dh), dtype=torch.float32, device=qg.device)
    qf = qg.float()
    for k0 in range(0, Sk, block_k):
        # a ragged last block is sliced short, which is the same as the
        # reference's zero padding masked by ``k_pos < Sk``
        kj, vj = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kj.float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(vj.dtype).float(), vj.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Sk, Hkv, Dh)
    v: torch.Tensor,  # (B, Sk, Hkv, Dh)
    *,
    causal: bool,
    q_offset: int = 0,
    block_q: int = 512,
    block_k: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise attention with online softmax; GQA folded into a group dim.
    fp32 softmax and accumulation; P is rounded to V's dtype before P·V; the
    output is in q's dtype. The causal mask is top-left aligned
    (``q_pos + q_offset >= k_pos``)."""
    B, Sq, Hq, Dh = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Sq, Hkv, G, Dh)

    if not causal:
        out = _attention_scan_kv(qg, k, v, scale=scale, block_k=block_k)
        return out.reshape(B, Sq, Hq, Dh).to(q.dtype)

    block_q = min(block_q, Sq)
    outs = []
    for lo_q in range(0, Sq, block_q):  # exact causal prefix per q block
        qi = qg[:, lo_q:lo_q + block_q]
        # the reference pads the last q block to block_q; padded rows are
        # cut off at the end, so a short last block gives the same rows
        lo = q_offset + lo_q                  # first q position of the block
        hi = lo + block_q                     # one past last q position
        parts = []
        if lo > 0:  # prefix rectangle: fully visible, no mask needed
            parts.append(_softmax_partial(qi, k[:, :lo], v[:, :lo], scale=scale))
        d_hi = min(hi, Sk)
        if d_hi > lo:  # diagonal block: causal mask within [lo, min(hi, Sk))
            kd, vd = k[:, lo:d_hi], v[:, lo:d_hi]
            q_pos = lo + torch.arange(qi.shape[1], device=q.device)
            kv_pos = lo + torch.arange(d_hi - lo, device=q.device)
            mask = q_pos[None, :, None, None, None] >= kv_pos[None, None, None, None, :]
            parts.append(_softmax_partial(qi, kd, vd, scale=scale, mask=mask))
        outs.append(_combine_partials(parts))
    out = torch.cat(outs, dim=1)
    return out.reshape(B, Sq, Hq, Dh).to(q.dtype)
