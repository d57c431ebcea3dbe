"""Plain PyTorch versions of the hand-written kernels.

* ``flash_attention`` is the blockwise online-softmax attention of the JAX
  package's ``repro.models.layers.flash_attention_ref``: causal mode splits
  each query block into a mask-free prefix rectangle plus a masked diagonal
  block merged by one online-softmax combine; non-causal mode scans
  fixed-size kv blocks.
* ``decode_attention`` is ``repro.models.layers.decode_attention_ref``: one
  query token per sequence against a KV cache in one dense masked pass.
  ``decode_attention_split`` computes the same in the CUDA kernel's split-K
  order (per-split partials, then one merge); only the tests use it.
  ``decode_attention_partials`` returns the one pass's unnormalised
  partial, as the kernel's ``decode_attention_partials`` returns its
  splits', for a merge across the shards of a cache split over ranks.
* ``flash_attention_bwd`` is FlashAttention-2's backward from the
  forward's output and log-sum-exp (``attention_lse``), the plain version
  of K1's backward kernel; ``flash_attention_bwd_bf16`` is the same with
  the bf16 kernels' roundings. Only the tests and ``chip_smoke.py`` use
  them.
* ``ssd_scan`` is ``repro.models.mamba2.ssd_chunked_ref`` (with
  ``_segsum``): Mamba2's chunked SSD scan with an optional initial state.
  ``ssd_scan_bwd`` is its gradient in the steps of K3's backward kernel
  (the JAX package lets XLA differentiate the scan); only the tests and
  ``chip_smoke.py`` use it.

They live here (not in ``models``) so that ``kernels`` never imports
``models``; ``models.layers`` re-exports the first two as
``flash_attention_ref`` / ``decode_attention_ref`` and ``models.mamba2``
the third as ``ssd_chunked_ref``.

It is what the CPU tests run, what ``ops`` takes for a CPU tensor, and what
``chip_smoke.py`` holds the CUDA kernel against on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


def _scores(q, k, *, causal, scale):
    """Scaled scores (B, Sq, Hkv, G, Sk) fp32, masked entries -inf (the
    top-left causal mask), and q reshaped to (B, Sq, Hkv, G, Dh)."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, Dh)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) * scale
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None, :, None, None, :], s, float("-inf"))
    return s, qg


def attention_lse(q, k, *, causal, scale=None) -> torch.Tensor:
    """Each row's log-sum-exp of the scaled, masked scores, fp32 (B, Hq, Sq):
    what the K1 forward kernel writes for the backward."""
    B, Sq, Hq, Dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    s, _ = _scores(q, k, causal=causal, scale=scale)
    return torch.logsumexp(s, dim=-1).reshape(B, Sq, Hq).permute(0, 2, 1).contiguous()


def flash_attention_bwd(q, k, v, o, lse, do, *, causal, scale=None):
    """FlashAttention-2's backward, step by step, in fp32: D = rowsum(dO o O);
    P = exp(S * scale - lse); dV = P^T dO; dP = dO V^T; dS = P o (dP - D);
    dQ = scale * dS K; dK = scale * dS^T Q, GQA's group summed into dK, dV.
    ``lse`` is fp32 (B, Hq, Sq). Returns (dq, dk, dv) in the inputs'
    dtypes. The backward kernel computes the same; nothing on the card's
    path calls this."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    s, qg = _scores(q, k, causal=causal, scale=scale)
    rows = lse.float().permute(0, 2, 1).reshape(B, Sq, Hkv, G)
    p = torch.exp(s - rows[..., None])  # exp(-inf) = 0 where masked
    dog = do.float().reshape(B, Sq, Hkv, G, Dh)
    dot = (dog * o.float().reshape(B, Sq, Hkv, G, Dh)).sum(-1)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, v.float())
    ds = p * (dp - dot[..., None])
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qg) * scale
    return dq.reshape(B, Sq, Hq, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_bf16(q, k, v, o, lse, do, *, causal, scale=None):
    """The bf16 backward kernels' arithmetic, step by step: bf16 operands
    (q, k, v, o, do rounded to bf16), fp32 sums; D = rowsum(dO o O);
    P = exp(S * scale - lse) in fp32, rounded to bf16 before dV = P^T dO;
    dS = P o (dP - D) from the fp32 P, rounded to bf16 before dQ =
    scale * dS K and dK = scale * dS^T Q; the gradients rounded to bf16.
    Nothing on the card's path calls this."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    q, k, v, o, do = (t.to(torch.bfloat16).float() for t in (q, k, v, o, do))
    s, qg = _scores(q, k, causal=causal, scale=scale)
    rows = lse.float().permute(0, 2, 1).reshape(B, Sq, Hkv, G)
    p = torch.exp(s - rows[..., None])  # exp(-inf) = 0 where masked
    dog = do.reshape(B, Sq, Hkv, G, Dh)
    dot = (dog * o.reshape(B, Sq, Hkv, G, Dh)).sum(-1)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p.to(torch.bfloat16).float(), dog)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, v)
    ds = (p * (dp - dot[..., None])).to(torch.bfloat16).float()
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, k) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qg) * scale
    return tuple(t.to(torch.bfloat16) for t in (dq.reshape(B, Sq, Hq, Dh), dk, dv))


def decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, Dh)
    k_cache: torch.Tensor,  # (B, L, Hkv, Dh)
    v_cache: torch.Tensor,  # (B, L, Hkv, Dh)
    lengths: torch.Tensor,  # (B,) valid cache length per sequence (incl. new token)
    *,
    scale: Optional[float] = None,
    block_k: int = 1024,
) -> torch.Tensor:
    """Single-token attention against the cache, positions ``>= lengths``
    masked; one dense pass with fp32 scores and accumulation, P rounded to
    V's dtype before P·V. ``block_k`` is kept for the JAX signature. At
    length 0 every score is masked and the result is the mean of V (the
    CUDA kernel returns 0 there, as the TPU kernel does). Returns
    (B, 1, Hq, Dh) in q's dtype."""
    del block_k
    B, _, Hq, Dh = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, 1, Hkv, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k_cache.float()) * scale
    mask = (torch.arange(L, device=q.device)[None, None, None, None, :]
            < lengths.to(q.device)[:, None, None, None, None])
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, Hq, Dh).to(q.dtype)


def decode_attention_partials(q, k_cache, v_cache, lengths, *, scale=None, block_k=1024):
    """``decode_attention``'s one pass as K2's partials, one split: acc
    (B, Hq, 1, Dh) unnormalised and (m, l) (B, Hq, 1, 2), fp32, masked
    positions weighing nothing (at length 0: m = NEG_INF, l = 0, acc = 0,
    as the kernel writes a split past the length)."""
    del block_k
    B, _, Hq, Dh = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, 1, Hkv, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k_cache.float()) * scale
    mask = (torch.arange(L, device=q.device)[None, None, None, None, :]
            < lengths.to(q.device)[:, None, None, None, None])
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v_cache.dtype).float(), v_cache.float())
    ml = torch.stack([m[..., 0], l], dim=-1)  # (B, 1, Hkv, G, 2)
    return (acc.reshape(B, Hq, 1, Dh), ml.reshape(B, Hq, 1, 2))


def decode_attention_split(
    q: torch.Tensor,        # (B, 1, Hq, Dh)
    k_cache: torch.Tensor,  # (B, L, Hkv, Dh)
    v_cache: torch.Tensor,  # (B, L, Hkv, Dh)
    lengths: torch.Tensor,  # (B,)
    n_split: int,
    *,
    scale: Optional[float] = None,
    block_k: int = 64,
) -> torch.Tensor:
    """``decode_attention`` in split-K order, as the CUDA kernel cuts the
    cache: ``ceil(L / block_k)`` tiles, ``ceil(tiles / n_split)`` of them per
    split. Each split's masked partial (m, l, acc) comes from
    ``_softmax_partial`` and ``_combine_partials`` merges them; a split
    that lies past the cache adds nothing. A split wholly past a length has
    m = -1e30 there and weighs 0 in the merge, unless every split does
    (length 0: the mean of V, like ``decode_attention``)."""
    B, _, Hq, Dh = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, 1, Hkv, G, Dh)
    tiles = -(-L // block_k)
    per = -(-tiles // n_split) * block_k  # keys per split
    valid = (torch.arange(L, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, None, :]
    parts = [_softmax_partial(qg, k_cache[:, lo:lo + per], v_cache[:, lo:lo + per],
                              scale=scale, mask=valid[..., lo:lo + per])
             for lo in range(0, L, per)]
    return _combine_partials(parts).reshape(B, 1, Hq, Dh).to(q.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j < k <= i} x[..., k].

    x: (..., T) -> (..., T, T), -inf above the diagonal.
    """
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum_(j, i] = cs[i] - cs[j]
    ii = torch.arange(T, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, -math.inf)


def _chunked(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, *rest) in any dtype -> (B, n_c, chunk, *rest) fp32, zero-padded
    to whole chunks: dt = 0 padding, which leaves the state unchanged (decay
    exp(0) = 1, update 0)."""
    t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, -t.shape[1] % chunk)).to(torch.float32)
    return t.reshape(t.shape[0], t.shape[1] // chunk, chunk, *t.shape[2:])


def _chunk_cumsum(dt: torch.Tensor, A: torch.Tensor, chunk: int):
    """(dA, cs): dt * A and its inclusive cumsum within each chunk, (B, c, l, H)."""
    dA = _chunked(dt.to(torch.float32) * A.to(torch.float32), chunk)
    return dA, torch.cumsum(dA, dim=2)


def _chunk_xdt(x: torch.Tensor, dt: torch.Tensor, chunk: int) -> torch.Tensor:
    """x * dt in fp32, (B, c, l, H, P)."""
    return _chunked(x.to(torch.float32) * dt.to(torch.float32)[..., None], chunk)


# The chunked SSD scan in four pieces, the decomposition of Mamba2's GPU
# kernels and of the bf16 CUDA route (csrc/ssd_scan.cu): C B^T per chunk, the
# chunk-local states, the pass of the states across chunks, and each chunk's
# output from its entering state and its own positions. T = min(chunk, S);
# each piece pads a ragged last chunk with zeros itself.

def ssd_chunk_cb(Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """CB[b, c, l, s] = C_l . B_s within chunk c: (B, n_c, T, T) fp32. B and C
    are shared by all heads, so this is once per (sequence, chunk)."""
    T = min(chunk, Bm.shape[1])
    return torch.einsum("bcln,bcsn->bcls", _chunked(Cm, T), _chunked(Bm, T))


def ssd_chunk_state(x, dt, A, Bm, *, chunk: int = 128):
    """The chunk-local states and decays: (states (B, n_c, H, P, N) with
    states[c] = sum_l x_l dt_l exp(cs_last - cs_l) B_l, chunk_decay (B, n_c, H)
    = exp(cs_last)), both fp32."""
    T = min(chunk, x.shape[1])
    xb = _chunk_xdt(x, dt, T)
    _, dA_cs = _chunk_cumsum(dt, A, T)
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (B,c,l,H)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", _chunked(Bm, T), decay_states, xb)
    return states, torch.exp(dA_cs[:, :, -1, :])


def ssd_state_pass(states, chunk_decay, initial_state=None):
    """The recurrence over chunks (the JAX lax.scan): returns (the state
    entering each chunk (B, n_c, H, P, N), the final state (B, H, P, N))."""
    Bsz, nc, H, P, N = states.shape
    s = (initial_state.to(torch.float32) if initial_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=states.device))
    prev = []
    for c in range(nc):
        prev.append(s)  # the state entering chunk c
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    return torch.stack(prev, dim=1), s


def ssd_chunk_scan(x, dt, A, Cm, cb, prev_states, *, chunk: int = 128) -> torch.Tensor:
    """y (B, S, H, P) in x's dtype: the masked intra-chunk product
    (C B^T * L) . (x dt) plus the entering state's part exp(cs_l) C_l . state."""
    Bsz, S, H, P = x.shape
    T = min(chunk, S)
    xb = _chunk_xdt(x, dt, T)
    dA, dA_cs = _chunk_cumsum(dt, A, T)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (B,c,H,l,l)
    M = cb[:, :, None] * Lmat  # (B,c,H,l,s)
    y_diag = torch.einsum("bchls,bcshp->bclhp", M, xb)
    state_decay = torch.exp(dA_cs)  # (B,c,l,H)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", _chunked(Cm, T), prev_states, state_decay)
    y = (y_diag + y_off).reshape(Bsz, -1, H, P)[:, :S]
    return y.to(x.dtype)


def ssd_scan(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)  (already softplus'd, > 0)
    A: torch.Tensor,   # (H,)       (negative)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, all in fp32, composed of the four pieces above.
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32). A ragged
    last chunk is padded with dt = 0, which leaves the state unchanged."""
    cb = ssd_chunk_cb(Bm, Cm, chunk=chunk)
    states, chunk_decay = ssd_chunk_state(x, dt, A, Bm, chunk=chunk)
    prev_states, final = ssd_state_pass(states, chunk_decay, initial_state)
    return ssd_chunk_scan(x, dt, A, Cm, cb, prev_states, chunk=chunk), final


def ssd_scan_bwd(x, dt, A, Bm, Cm, initial_state, dy, dfinal_state, *, chunk: int = 128):
    """The gradient of ``ssd_scan``: (dx, ddt, dA, dB, dC, dinitial_state)
    from the output's and the final state's gradients (``dfinal_state``
    None is zeros), in fp32, chunk by chunk, in the CUDA kernel's steps
    (csrc/ssd_scan_bwd.cu). dx, dB and dC come back in x's dtype, the rest
    in fp32; dinitial_state is the gradient of a zero initial state when
    ``initial_state`` is None.

    Per (sequence, chunk, head), with u_s = x_s dt_s, cs the chunk's
    inclusive cumsum of dt A, E[l, s] = exp(cs_l - cs_s) for s <= l (0
    above), S_in the state entering the chunk and Ŝ the gradient of the
    state leaving it:

    * the states entering each chunk, recomputed by the forward pass;
    * the reverse pass: dS_in = exp(cs_T) Ŝ + sum_l exp(cs_l) dy_l C_l^T,
      Ŝ of the last chunk is dfinal_state, Ŝ(c - 1) = dS_in(c), and
      dinitial_state = dS_in(0);
    * du_s = sum_{l >= s} (C_l.B_s) E[l, s] dy_l + exp(cs_T - cs_s) Ŝ B_s,
      dx = du dt and ddt's direct part <du_s, x_s>;
    * dC_l = exp(cs_l) S_in^T dy_l + sum_{s <= l} E[l, s] <dy_l, u_s> B_s,
      dB_s = sum_{l >= s} E[l, s] <dy_l, u_s> C_l + exp(cs_T - cs_s) Ŝ^T u_s,
      both summed over heads;
    * dcs from W[l, s] = (C_l.B_s) E[l, s] <dy_l, u_s> and V_s = exp(cs_T -
      cs_s) u_s^T Ŝ B_s: dcs_l = sum_s W[l, s] - sum_l' W[l', l] +
      exp(cs_l) <dy_l, S_in C_l> - V_l, and the last position adds
      exp(cs_T) <Ŝ, S_in> + sum_s V_s; then da = the reverse cumsum of dcs
      in the chunk, ddt += A da and dA = sum dt da.

    A ragged last chunk is dt = 0 padding, as in the forward: its padded
    rows add nothing and their gradients are dropped."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    T = min(chunk, S)
    f32 = torch.float32
    u = _chunk_xdt(x, dt, T)                      # (B,c,l,H,P)
    xc, dtc, dyc = _chunked(x, T), _chunked(dt, T), _chunked(dy, T)
    Bc, Cc = _chunked(Bm, T), _chunked(Cm, T)     # (B,c,l,N)
    _, cs = _chunk_cumsum(dt, A, T)               # (B,c,l,H)
    nc = cs.shape[1]
    e_cs = torch.exp(cs)                          # exp(cs_l)
    w = torch.exp(cs[:, :, -1:] - cs)             # exp(cs_T - cs_s)
    decay = torch.exp(cs[:, :, -1])               # (B,c,H)

    # the states entering each chunk, and the reverse pass of their gradients
    states, _ = ssd_chunk_state(x, dt, A, Bm, chunk=T)
    s_in, _ = ssd_state_pass(states, decay, initial_state)  # (B,c,H,P,N)
    adj = torch.einsum("bclh,bclhp,bcln->bchpn", e_cs, dyc, Cc)
    s = (dfinal_state.to(f32) if dfinal_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device))
    hat = [None] * nc
    for c in reversed(range(nc)):
        hat[c] = s
        s = s * decay[:, c, :, None, None] + adj[:, c]
    hat, dinit = torch.stack(hat, dim=1), s      # (B,c,H,P,N), (B,H,P,N)

    csh = cs.permute(0, 1, 3, 2)                  # (B,c,H,l)
    ii = torch.arange(T, device=x.device)
    E = torch.where(ii[:, None] >= ii[None, :],
                    torch.exp(csh[..., :, None] - csh[..., None, :]), 0.0)  # (B,c,H,l,s)
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    dyu = torch.einsum("bclhp,bcshp->bchls", dyc, u)
    M1 = cb[:, :, None] * E                       # (C_l.B_s) E[l, s]
    M2 = E * dyu                                  # E[l, s] <dy_l, u_s>
    du_state = w[..., None] * torch.einsum("bchpn,bcsn->bcshp", hat, Bc)
    du = torch.einsum("bchls,bclhp->bcshp", M1, dyc) + du_state
    dC_state = e_cs[..., None] * torch.einsum("bclhp,bchpn->bclhn", dyc, s_in)
    dC = dC_state.sum(3) + torch.einsum("bchls,bcsn->bcln", M2, Bc)
    dB_state = w[..., None] * torch.einsum("bcshp,bchpn->bcshn", u, hat)
    dB = torch.einsum("bchls,bcln->bcsn", M2, Cc) + dB_state.sum(3)

    W = M1 * dyu                                  # (B,c,H,l,s)
    V = (u * du_state).sum(-1)                    # (B,c,s,H)
    dcs = (W.sum(-1) - W.sum(-2)).permute(0, 1, 3, 2)
    dcs = dcs + torch.einsum("bclhn,bcln->bclh", dC_state, Cc) - V
    last = decay * (hat * s_in).sum((-2, -1)) + V.sum(2)  # (B,c,H)
    dcs = torch.cat([dcs[:, :, :-1], dcs[:, :, -1:] + last[:, :, None]], dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dcs, (2,)), dim=2), (2,))
    ddt = (du * xc).sum(-1) + A.to(f32) * da
    dA = (dtc * da).sum((0, 1, 2))

    def unchunk(t):
        return t.reshape(Bsz, nc * T, *t.shape[3:])[:, :S]

    dx = unchunk(du * dtc[..., None])
    return (dx.to(x.dtype), unchunk(ddt), dA, unchunk(dB).to(Bm.dtype),
            unchunk(dC).to(Cm.dtype), dinit)


def _bf16_operand(v: torch.Tensor, split: bool) -> torch.Tensor:
    """v as the tensor cores take it: rounded to bf16, or (split) as a bf16
    high part plus a bf16 low part, v - hi rounded, in two products."""
    hi = v.to(torch.bfloat16).to(torch.float32)
    return hi + (v - hi).to(torch.bfloat16).to(torch.float32) if split else hi


def ssd_scan_bf16_split(x, dt, A, Bm, Cm, *, chunk: int = 128, initial_state=None,
                        split: bool = True):
    """``ssd_scan`` with exactly the operands rounded that the bf16 CUDA route
    gives the tensor cores: x, B and C go in as they are (bf16 already);
    M = C B^T * exp(cs_l - cs_s) * dt_s, dt w B and the entering state are
    fp32 and go in as hi + lo bf16 (``split``) or rounded once. Sums stay
    fp32. Only the tests use it: with ``split=False`` some outputs miss
    the bf16 criterion, which is why the kernels split."""
    Bsz, S, H, P = x.shape
    T = min(chunk, S)
    xc = _chunked(x, T)  # (B,c,l,H,P), exact
    Bc, Cc = _chunked(Bm, T), _chunked(Cm, T)
    dtc = _chunked(dt, T)  # (B,c,l,H)
    _, cs = _chunk_cumsum(dt, A, T)
    # the chunk states: x . R(dt w B)
    f = dtc * torch.exp(cs[:, :, -1:, :] - cs)  # (B,c,l,H)
    dwb = _bf16_operand(f[..., None] * Bc[:, :, :, None, :], split)  # (B,c,l,H,N)
    states = torch.einsum("bclhp,bclhn->bchpn", xc, dwb)
    prev_states, final = ssd_state_pass(states, torch.exp(cs[:, :, -1, :]), initial_state)
    # y = exp(cs_l) C_l . R(state_in) + R(M) . x
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, _bf16_operand(prev_states, split))
    y_off = y_off * torch.exp(cs)[..., None]
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    csh = cs.permute(0, 1, 3, 2)  # (B,c,H,l)
    decay = torch.exp(csh[..., :, None] - csh[..., None, :])
    ii = torch.arange(T, device=x.device)
    M = torch.where(ii[:, None] >= ii[None, :],
                    cb[:, :, None] * decay * dtc.permute(0, 1, 3, 2)[..., None, :], 0.0)
    y_diag = torch.einsum("bchls,bcshp->bclhp", _bf16_operand(M, split), xc)
    y = (y_off + y_diag).reshape(Bsz, -1, H, P)[:, :S]
    return y.to(x.dtype), final


#: the fp32 operands that K3's bf16 backward kernels give the tensor cores:
#: the weighted rows of the chunk-state sum (dt w B) and of the adjoint sum
#: (exp(cs) C), M1 = (C B^T) o E, M2 = E o (dy u^T), the gradient of the
#: state leaving each chunk (Ŝ) and the state entering it (S_in)
BWD_BF16_OPERANDS = ("state", "adjoint", "m1", "m2", "s_hat", "s_in")
#: the operands that the kernels round to bf16 once; the others go in as
#: hi + lo
BWD_BF16_ONCE = ("s_hat", "s_in")


def ssd_scan_bwd_bf16(x, dt, A, Bm, Cm, initial_state, dy, dfinal_state, *,
                      chunk: int = 128, once=BWD_BF16_ONCE):
    """``ssd_scan_bwd`` with exactly the operand roundings of the bf16
    backward kernels (csrc/ssd_scan_bwd.cu): x, B, C and dy go in as they
    are (bf16 already; rounded here if they are not); every operand named
    in ``BWD_BF16_OPERANDS`` is fp32 and goes in as a bf16 high part plus
    a bf16 low part, or rounded once if it is in ``once`` (by default
    ``BWD_BF16_ONCE``, the kernels' choice). Scalings that
    factor out of a sum are applied in fp32 after it: <dy_l, u_s> =
    dt_s <dy_l, x_s>, exp(cs_l) S_in^T dy_l, w_s dt_s Ŝ^T x_s and w_s Ŝ B_s.
    Sums, the passes over chunks and the decay's gradient stay fp32; dx,
    dB and dC are rounded to bf16 at the end. Only the tests and
    ``chip_smoke.py`` use it."""
    unknown = set(once) - set(BWD_BF16_OPERANDS)
    if unknown:
        raise ValueError(f"unknown operands {sorted(unknown)}; "
                         f"the kernels' are {BWD_BF16_OPERANDS}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    T = min(chunk, S)
    f32, bf16 = torch.float32, torch.bfloat16
    R = {name: (lambda v, split=name not in once: _bf16_operand(v, split))
         for name in BWD_BF16_OPERANDS}
    x, Bm, Cm, dy = (t.to(bf16) for t in (x, Bm, Cm, dy))
    xc, dtc, dyc = _chunked(x, T), _chunked(dt, T), _chunked(dy, T)  # (B,c,l,H[,P])
    Bc, Cc = _chunked(Bm, T), _chunked(Cm, T)     # (B,c,l,N)
    _, cs = _chunk_cumsum(dt, A, T)               # (B,c,l,H)
    nc = cs.shape[1]
    e_cs = torch.exp(cs)
    w = torch.exp(cs[:, :, -1:] - cs)
    decay = torch.exp(cs[:, :, -1])               # (B,c,H)

    # the chunk states x^T R(dt w B) and the adjoints dy^T R(exp(cs) C)
    states = torch.einsum("bclhp,bclhn->bchpn", xc,
                          R["state"]((dtc * w)[..., None] * Bc[:, :, :, None, :]))
    s_in, _ = ssd_state_pass(states, decay, initial_state)
    adj = torch.einsum("bclhp,bclhn->bchpn", dyc,
                       R["adjoint"](e_cs[..., None] * Cc[:, :, :, None, :]))
    s = (dfinal_state.to(f32) if dfinal_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device))
    hat = [None] * nc
    for c in reversed(range(nc)):
        hat[c] = s
        s = s * decay[:, c, :, None, None] + adj[:, c]
    hat, dinit = torch.stack(hat, dim=1), s      # (B,c,H,P,N), (B,H,P,N)

    csh = cs.permute(0, 1, 3, 2)                  # (B,c,H,l)
    ii = torch.arange(T, device=x.device)
    E = torch.where(ii[:, None] >= ii[None, :],
                    torch.exp(csh[..., :, None] - csh[..., None, :]), 0.0)  # (B,c,H,l,s)
    dts = dtc.permute(0, 1, 3, 2)[..., None, :]   # dt_s (B,c,H,1,s)
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    dyx = torch.einsum("bclhp,bcshp->bchls", dyc, xc)  # exact products, fp32 sums
    M1 = cb[:, :, None] * E
    M2 = E * dts * dyx
    sb = w[..., None] * torch.einsum("bchpn,bcsn->bcshp", R["s_hat"](hat), Bc)
    du = torch.einsum("bchls,bclhp->bcshp", R["m1"](M1), dyc) + sb
    dC_state = e_cs[..., None] * torch.einsum("bclhp,bchpn->bclhn", dyc, R["s_in"](s_in))
    dC = dC_state.sum(3) + torch.einsum("bchls,bcsn->bcln", R["m2"](M2), Bc)
    dB_state = (w * dtc)[..., None] * torch.einsum("bcshp,bchpn->bcshn", xc, R["s_hat"](hat))
    dB = torch.einsum("bchls,bcln->bcsn", R["m2"](M2), Cc) + dB_state.sum(3)

    W = M1 * dts * dyx                            # (B,c,H,l,s), fp32
    V = dtc * (xc * sb).sum(-1)                   # (B,c,s,H)
    dcs = (W.sum(-1) - W.sum(-2)).permute(0, 1, 3, 2)
    dcs = dcs + torch.einsum("bclhn,bcln->bclh", dC_state, Cc) - V
    last = decay * (hat * s_in).sum((-2, -1)) + V.sum(2)  # (B,c,H)
    dcs = torch.cat([dcs[:, :, :-1], dcs[:, :, -1:] + last[:, :, None]], dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dcs, (2,)), dim=2), (2,))
    ddt = (du * xc).sum(-1) + A.to(f32) * da
    dA = (dtc * da).sum((0, 1, 2))

    def unchunk(t):
        return t.reshape(Bsz, nc * T, *t.shape[3:])[:, :S]

    dx = unchunk(du * dtc[..., None])
    return (dx.to(bf16), unchunk(ddt), dA, unchunk(dB).to(bf16), unchunk(dC).to(bf16), dinit)
