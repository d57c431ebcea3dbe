"""Shared model layers, dense subset (plain functions on tensors).

Conventions (as in the JAX package's ``repro.models.layers``)
-----------------------------------------------------------
* params are nested dicts of tensors with the JAX key layout; layer stacks
  carry a leading ``num_periods`` axis (``models.model`` loops over it).
* weights live in ``cfg.param_dtype``; matmuls run in ``cfg.compute_dtype``
  with fp32 softmax/norm/accumulation. The fp32 islands are kept exactly
  where the reference has them: ``rms_norm``, the rope math, ``silu`` and
  the unembedding's output.
* attention goes through ``repro_torch.kernels.ops``: the hand-written CUDA
  kernel for a CUDA tensor, the plain blockwise version for a CPU one. (The
  JAX layers call their pure-jnp oracle directly; this is the one
  deliberate difference.)

Every ``init_*`` takes an explicit ``torch.Generator`` (on ``device``) and a
``lead`` shape prepended to every leaf, so a whole period stack is drawn in
one call. The numbers differ from JAX's for the same seed; the tests carry
the JAX weights over instead (``models.convert``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
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
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def _uniform(gen: torch.Generator, shape: Sequence[int], scale: float, dtype,
             device) -> torch.Tensor:
    x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return x.uniform_(-scale, scale, generator=gen).to(dtype)


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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    angles = positions.float()[..., None] * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


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


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, kv_x: torch.Tensor):
    B, S, _ = x.shape
    Skv = kv_x.shape[1]
    nq, nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ct = cdtype(cfg)
    q = x.to(ct) @ p["wq"].to(ct)
    k = kv_x.to(ct) @ p["wk"].to(ct)
    v = kv_x.to(ct) @ p["wv"].to(ct)
    if cfg.qkv_bias:
        q = q + p["bq"].to(ct)
        k = k + p["bk"].to(ct)
        v = v + p["bv"].to(ct)
    q = q.reshape(B, S, nq, dh)
    k = k.reshape(B, Skv, nkv, dh)
    v = v.reshape(B, Skv, nkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rmsnorm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rmsnorm_eps)
    return q, k, v


def _rope_qk(cfg: ModelConfig, q, k, positions):
    if cfg.mrope_sections:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet: ROADMAP.md Queue 1 item 7")
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)


def attention_forward(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence attention. positions: (B, S)."""
    q, k, v = _project_qkv(cfg, p, x, x)
    q, k = _rope_qk(cfg, q, k, positions)
    out = ops.flash_attention(q, k, v, causal=causal)
    return _out_proj(cfg, p, out)


def _out_proj(cfg: ModelConfig, p: dict, out: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    ct = cdtype(cfg)
    flat = out.reshape(B, S, cfg.num_heads * cfg.head_dim).to(ct)
    return flat @ p["wo"].to(ct)


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
    g = x @ p["wg"].to(ct)
    u = x @ p["wu"].to(ct)
    h = F.silu(g.float()).to(ct) * u
    return h @ p["wd"].to(ct)


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
    return F.embedding(tokens, p["embedding"]).to(cdtype(cfg))


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    ct = cdtype(cfg)
    if cfg.tie_embeddings:
        w = p["embedding"].to(ct).T
    else:
        w = p["lm_head"].to(ct)
    return (x.to(ct) @ w).float()
