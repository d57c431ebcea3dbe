"""Shared model layers: attention (RoPE or M-RoPE; full sequence, cross
attention and one-token decode against a cache), SwiGLU MLP, the MoE FFN,
embedding (plain functions on tensors).

Conventions (as in the JAX package's ``repro.models.layers``)
-----------------------------------------------------------
* params are nested dicts of tensors with the JAX key layout; layer stacks
  carry a leading ``num_periods`` axis (``models.model`` loops over it).
* weights live in ``cfg.param_dtype``; matmuls run in ``cfg.compute_dtype``
  with fp32 softmax/norm/accumulation. The fp32 islands are kept exactly
  where the reference has them: ``rms_norm``, the rope math, ``silu`` and
  the unembedding's output.
* attention goes through ``repro_torch.kernels.ops``: the hand-written CUDA
  kernels for a CUDA tensor, the plain versions for a CPU one. (The JAX
  layers call their pure-jnp oracles directly; this is the one deliberate
  difference.)

Every ``init_*`` takes an explicit ``torch.Generator`` (on ``device``) and a
``lead`` shape prepended to every leaf, so a whole period stack is drawn in
one call. The numbers differ from JAX's for the same seed; the tests carry
the JAX weights over instead (``models.convert``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compat import (
    gather_fsdp, is_dtensor, reduce_partials, whole, whole_unless_divides,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_attention as decode_attention_ref  # noqa: F401
from repro_torch.kernels.ref import flash_attention as flash_attention_ref  # noqa: F401

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# ---------------------------------------------------------------------------
# small utilities
# ---------------------------------------------------------------------------


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    # a ``DTensor`` residual with its features split over ranks (between
    # periods) or still a partial sum (a row-parallel product added in) is
    # made whole first, as sequence parallelism gathers before the
    # column-parallel projections that read the norm's output
    x = whole(reduce_partials(x), -1)
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def _uniform(gen: Optional[torch.Generator], shape: Sequence[int], scale: float, dtype,
             device) -> torch.Tensor:
    """Uniform in [-scale, scale) drawn from ``gen``; on ``meta`` nothing is
    drawn (and ``gen`` may be None)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return x.uniform_(-scale, scale, generator=gen).to(dtype)


def weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight at its use, in ``dtype``. A ``DTensor`` weight split over
    the data axes (FSDP) is gathered over them here, and stays split over
    ``model`` (TP): the matmul then needs no other collective, and the
    gather's backward reduce-scatters the gradient over the data axes."""
    return gather_fsdp(w).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, lead=()) -> torch.Tensor:
    return _uniform(gen, (*lead, d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, fp32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of x (..., S, H, Dh) by ``angles`` (..., S,
    Dh/2), in fp32."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    return _rotate(x, positions.float()[..., None] * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): ``positions`` is (3, ..., S); the half-dim
    frequency bands are split into ``sections`` (t, h, w), each rotated by its
    own position stream."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to head_dim/2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    # stream i drives the i-th band of frequencies; the bands are slices, so
    # no index tensor is copied to the card
    pos = positions.float()  # (3, ..., S)
    angles = torch.cat([pos[i, ..., None] * band
                        for i, band in enumerate(freqs.split(list(sections)))], dim=-1)
    return _rotate(x, angles)  # angles (..., S, half)


# ---------------------------------------------------------------------------
# Attention layer (projections + rope)
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, gen, device, lead=()) -> dict:
    dt = pdtype(cfg)
    d, dh = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, d, nq * dh, dt, device, lead),
        "wk": dense_init(gen, d, nkv * dh, dt, device, lead),
        "wv": dense_init(gen, d, nkv * dh, dt, device, lead),
        "wo": dense_init(gen, nq * dh, d, dt, device, lead),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, nq * dh), dtype=dt, device=device)
        p["bk"] = torch.zeros((*lead, nkv * dh), dtype=dt, device=device)
        p["bv"] = torch.zeros((*lead, nkv * dh), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, dh), dtype=dt, device=device)
        p["k_norm"] = torch.ones((*lead, dh), dtype=dt, device=device)
    return p


def _project(cfg: ModelConfig, p: dict, x: torch.Tensor, name: str, heads: int):
    """One of the q/k/v projections: (B, S, D) -> (B, S, heads, Dh), with the
    bias and (q and k only) the qk-norm where the config has them."""
    ct = cdtype(cfg)
    w = weight(p[f"w{name}"], ct)
    if is_dtensor(w):  # a projection the rules keep whole over ``model``: each rank its columns
        from repro_torch.distributed import local
        w = local.split_over_model(w, 1)
    y = x.to(ct) @ w
    if cfg.qkv_bias:
        y = y + p[f"b{name}"].to(ct)
    # sharded over more ranks than it has heads: the projection is gathered
    y = whole_unless_divides(y, -1, heads).reshape(x.shape[0], x.shape[1], heads, cfg.head_dim)
    if cfg.qk_norm and name != "v":
        y = rms_norm(y, p[f"{name}_norm"], cfg.rmsnorm_eps)
    return y


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, kv_x: torch.Tensor):
    return (_project(cfg, p, x, "q", cfg.num_heads),
            _project(cfg, p, kv_x, "k", cfg.num_kv_heads),
            _project(cfg, p, kv_x, "v", cfg.num_kv_heads))


def _rope_qk(cfg: ModelConfig, q, k, positions):
    if cfg.mrope_sections:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)


def attention_forward(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    return_kv: bool = False,
):
    """Full-sequence attention (forward / prefill). positions: (B, S), or
    (3, B, S) for M-RoPE. With ``return_kv`` also returns the roped (k, v),
    (B, S, Hkv, Dh) in the compute dtype, for the prefill's cache."""
    q, k, v = _project_qkv(cfg, p, x, x)
    q, k = _rope_qk(cfg, q, k, positions)
    out = ops.flash_attention(q, k, v, causal=causal)
    y = _out_proj(cfg, p, out)
    if return_kv:
        return y, (k, v)
    return y


def _out_proj(cfg: ModelConfig, p: dict, out: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    ct = cdtype(cfg)
    flat = _merge_heads(out, (B, S, cfg.num_heads * cfg.head_dim)).to(ct)
    w = weight(p["wo"], ct)
    if is_dtensor(flat):  # whole heads (split by rows): each rank its rows of wo
        from repro_torch.distributed import local
        flat = local.rows_of(flat, w)
    return flat @ w


def _merge_heads(out: torch.Tensor, shape) -> torch.Tensor:
    """(B, S, H, Dh) -> (B, S, H * Dh). A ``DTensor`` whose heads are
    whole on every rank (they do not divide by the model axis) is
    reshaped rank by rank, so that the gradient coming back, split over
    ``model`` by the output projection, is gathered whole before it is cut
    into heads again (``DTensor`` cannot split a sharded dim into heads
    that do not divide)."""
    if is_dtensor(out) and not any(pl.is_shard(2) for pl in out.placements):
        from repro_torch.distributed import local
        return local.reshape_rows(out, shape)
    return out.reshape(shape)


def cross_attention_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, enc: torch.Tensor,
                            *, return_kv: bool = False):
    """Cross attention (whisper decoder): queries from x, k/v from the
    encoder output, no RoPE, non-causal. With ``return_kv`` also returns
    (k, v), (B, S_enc, Hkv, Dh), for the prefill's cross cache."""
    q, k, v = _project_qkv(cfg, p, x, enc)
    out = ops.flash_attention(q, k, v, causal=False)
    y = _out_proj(cfg, p, out)
    if return_kv:
        return y, (k, v)
    return y


def cross_attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """One-token cross attention against the prefill's cross cache
    (B, S_enc, Hkv, Dh): every row attends over the whole encoder output.
    Only q is projected (the JAX step projects k and v too and drops them);
    the lengths are made on the device, so nothing waits for the card."""
    q = _project(cfg, p, x, "q", cfg.num_heads)
    lengths = torch.full((x.shape[0],), ck.shape[1], dtype=torch.int32, device=x.device)
    return _out_proj(cfg, p, ops.decode_attention(q, ck, cv, lengths))


def attention_decode(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,          # (B, 1, D)
    positions: torch.Tensor,  # (B,) int32 absolute position, or (3, B) for M-RoPE
    k_cache: torch.Tensor,    # (B, L, Hkv, Dh)
    v_cache: torch.Tensor,
):
    """One-token decode: rope at ``positions`` (M-RoPE: its three streams;
    the cache row and the length follow the first), write the new token's
    k/v into the cache at ``positions``, attend against the cache through
    ``ops.decode_attention`` with ``lengths = positions + 1``.

    The JAX version scatters into a new cache (``.at[bidx, pos].set``); here
    the write goes into ``k_cache``/``v_cache`` IN PLACE (advanced-index
    assignment) and the same tensors are returned. A position at or past
    the cache's length L drops its write, as the JAX scatter does: the row
    at L-1 is written back with its own value, so no index leaves the cache
    (on the card an out-of-range index would be a device-side assert).
    ``positions`` stays on the device: nothing here waits for the card."""
    B = x.shape[0]
    if cfg.mrope_sections:
        pos_rope, positions = positions[..., None], positions[0]  # (3, B, 1), (B,)
    else:
        pos_rope = positions[:, None]
    q, k, v = _project_qkv(cfg, p, x, x)
    q, k = _rope_qk(cfg, q, k, pos_rope)
    if is_dtensor(k_cache):  # each rank writes the rows of its shard
        from repro_torch.distributed import local
        local.write_positions(k_cache, positions, k[:, 0])
        local.write_positions(v_cache, positions, v[:, 0])
    else:
        bidx = torch.arange(B, device=x.device)
        L = k_cache.shape[1]
        pos = positions.long()
        keep = (pos < L)[:, None, None]
        pos = pos.clamp(max=L - 1)
        k_cache[bidx, pos] = torch.where(keep, k[:, 0].to(k_cache.dtype), k_cache[bidx, pos])
        v_cache[bidx, pos] = torch.where(keep, v[:, 0].to(v_cache.dtype), v_cache[bidx, pos])
    lengths = (positions + 1).to(torch.int32)
    out = ops.decode_attention(q, k_cache, v_cache, lengths)
    return _out_proj(cfg, p, out), k_cache, v_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(cfg: ModelConfig, gen, device, d_ff: Optional[int] = None, lead=()) -> dict:
    dt = pdtype(cfg)
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "wg": dense_init(gen, d, f, dt, device, lead),
        "wu": dense_init(gen, d, f, dt, device, lead),
        "wd": dense_init(gen, f, d, dt, device, lead),
    }


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    ct = cdtype(cfg)
    x = x.to(ct)
    g = x @ weight(p["wg"], ct)
    u = x @ weight(p["wu"], ct)
    h = F.silu(g.float()).to(ct) * u
    return h @ weight(p["wd"], ct)


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style capacity-bounded einsum dispatch)
# ---------------------------------------------------------------------------


def init_moe(cfg: ModelConfig, gen, device, lead=()) -> dict:
    dt = pdtype(cfg)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, d, e, torch.float32, device, lead),  # router kept fp32
        "wg": _uniform(gen, (*lead, e, d, f), 1.0 / math.sqrt(d), dt, device),
        "wu": _uniform(gen, (*lead, e, d, f), 1.0 / math.sqrt(d), dt, device),
        "wd": _uniform(gen, (*lead, e, f, d), 1.0 / math.sqrt(f), dt, device),
    }
    if cfg.moe_shared_expert:
        p["shared"] = init_mlp(cfg, gen, device, cfg.moe_d_ff, lead)
    return p


def moe_route(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The router, in fp32 whatever the compute dtype: (probs (B,S,E),
    renormalised gates (B,S,K), chosen experts (B,S,K) int64). Ties go to
    the lower expert index, as ``lax.top_k`` breaks them (``torch.topk``
    does not promise an order): a stable descending sort, cut at K."""
    probs = torch.softmax(x.float() @ weight(p["router"], torch.float32), dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    gate_vals, gate_idx = gate_vals[..., :K], gate_idx[..., :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def moe_capacity(cfg: ModelConfig, S: int, capacity_factor: Optional[float] = None) -> int:
    """Each expert's slots C per batch row of S tokens."""
    E, K = cfg.num_experts, cfg.experts_per_token
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity_factor
    return max(K, int(math.ceil(K * S * cf / E)))


def moe_experts(cfg: ModelConfig, x: torch.Tensor, gate_vals: torch.Tensor,
                gate_idx: torch.Tensor, onehot: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor, wd: torch.Tensor, C: int) -> torch.Tensor:
    """The experts of ``onehot`` (B,S,K,E'): every choice's slot is
    counted over all E experts (``gate_idx``), then the tokens are
    dispatched to, computed by and combined from the E' experts whose
    one-hot columns and weights ``wg``/``wu``/``wd`` (E', d_in, d_out, in
    the compute dtype) are given. All E on one device; a rank's own under
    expert parallelism (``distributed.local.moe_ffn``), where the result is
    its share of the sum over experts. (B,S,D) in the compute dtype."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    ct = cdtype(cfg)
    # each (token, choice)'s slot in its expert's buffer: the choices before
    # it of its expert, counting over the flattened (s, k) in order per
    # batch row. The running count is taken along the innermost axis of an
    # (B, E, S*K) layout, where the card scans each row in parallel (along
    # an outer axis each column is one thread's serial loop)
    flat_idx = gate_idx.reshape(B, 1, S * K)
    mine = flat_idx == torch.arange(E, device=x.device)[None, :, None]  # (B,E,S*K)
    running = torch.cumsum(mine, dim=-1, dtype=torch.int32)
    pos_c = (running.gather(1, flat_idx) - 1).reshape(B, S, K)
    kept = (pos_c < C)[..., None]
    slots = torch.arange(C, device=x.device)
    cap_onehot = ((pos_c[..., None] == slots) & kept).to(ct)  # (B,S,K,C)
    onehot_ct = onehot.to(ct)
    dispatch = torch.einsum("bske,bskc->bsec", onehot_ct, cap_onehot)
    # each token's K experts differ, so one k feeds each (s, e): the gate
    # folded into the one-hot first is the reference's three-way einsum
    combine = torch.einsum("bske,bskc->bsec", onehot_ct * gate_vals.to(ct)[..., None],
                           cap_onehot)

    xin = torch.einsum("bsec,bsd->ebcd", dispatch, x.to(ct))
    g = torch.einsum("ebcd,edf->ebcf", xin, wg)
    u = torch.einsum("ebcd,edf->ebcf", xin, wu)
    h = F.silu(g.float()).to(ct) * u
    eout = torch.einsum("ebcf,efd->ebcd", h, wd)
    return torch.einsum("bsec,ebcd->bsd", combine, eout)


def moe_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                capacity_factor: Optional[float] = None):
    """Token-choice top-k routing with per-(batch-row) expert capacity C;
    x (B, S, D). Returns (y, aux_loss).

    The JAX package's one-hot einsum dispatch, ported as it is: a choice
    whose slot in its expert's buffer is >= C is dropped (its token gets
    nothing from that expert), and the drops are part of the result.
    ``jax.nn.one_hot`` gives a zero row for an index out of range where
    ``F.one_hot`` raises, so the capacity one-hot is a comparison with
    ``arange(C)`` and ``kept``. The slots are counted in integers (the
    reference counts exact integers in fp32). Dispatch, combine and the
    gates are cast to the compute dtype before the einsums, as there.

    A ``DTensor`` ``x`` (a cell's step on a mesh) runs the experts over
    ``model`` through ``distributed.local.moe_ffn``."""
    if is_dtensor(x):
        from repro_torch.distributed import local
        return local.moe_ffn(cfg, p, x, capacity_factor=capacity_factor)
    E, K = cfg.num_experts, cfg.experts_per_token
    C = moe_capacity(cfg, x.shape[1], capacity_factor)
    ct = cdtype(cfg)

    probs, gate_vals, gate_idx = moe_route(cfg, p, x)
    onehot = F.one_hot(gate_idx, E)  # (B,S,K,E) int64; the indices are < E
    y = moe_experts(cfg, x, gate_vals, gate_idx, onehot, weight(p["wg"], ct),
                    weight(p["wu"], ct), weight(p["wd"], ct), C)

    if cfg.moe_shared_expert:
        y = y + mlp_forward(cfg, p["shared"], x)

    # load-balancing aux loss (Switch-style)
    frac_tokens = onehot.sum(2).float().mean(dim=(0, 1))  # (E,) fraction routed
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs) / K
    return y.to(x.dtype), aux.float()


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(cfg: ModelConfig, gen, device) -> dict:
    dt = pdtype(cfg)
    p = {"embedding": _uniform(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device)
    return p


def embed(cfg: ModelConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int32 or int64."""
    table = p["embedding"]
    if is_dtensor(table):  # each rank looks up the rows it holds
        from repro_torch.distributed import local
        return local.embedding(tokens, table).to(cdtype(cfg))
    return F.embedding(tokens, table).to(cdtype(cfg))


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    ct = cdtype(cfg)
    if cfg.tie_embeddings:
        w = weight(p["embedding"], ct).T
    else:
        w = weight(p["lm_head"], ct)
    if is_dtensor(w):  # the logits split over ``model`` by vocab, even where it does not divide
        from repro_torch.distributed import local
        w = local.split_over_model(w, 1)
    return (x.to(ct) @ w).float()
