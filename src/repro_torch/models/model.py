"""Model facade: init / forward / prefill / decode for the dense and SSM
families.

Params and the period stack keep the JAX layout: ``params["layers"]`` holds
``{"sub{i}": subtree}`` whose every leaf has a leading ``num_periods`` axis,
and so does every leaf of a decode cache. The JAX package scans over that
axis with ``lax.scan``; here a Python loop indexes the stacked leaves with
``[i]``. Rematerialisation and activation sharding (``_maybe_remat``,
``constrain``) do nothing when serving on one device and are not carried
over.

The JAX cache is immutable and every step returns a new one; here
``prefill`` and ``decode_step`` write into the ``[period]`` views of the
stacked cache IN PLACE and return the same dict.

MoE, M-RoPE and encoder-decoder paths are not ported yet; they raise
``NotImplementedError`` naming their ROADMAP.md item (hybrid jamba for its
MoE FFN).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, SublayerSpec
from repro_torch.data.database import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

Params = Dict[str, Any]
Cache = Dict[str, Any]


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for the families this port does not serve yet."""
    missing = None
    if cfg.is_encoder_decoder:
        missing = "encoder-decoder (whisper)"
    elif cfg.mrope_sections:
        missing = "M-RoPE (qwen2-vl)"
    elif any(s.ffn == "moe" for s in cfg.period_spec()):
        missing = "the MoE FFN (olmoe, llama4, jamba)"
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {missing} is not ported yet (ROADMAP.md Queue 1 item 7)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sublayer(cfg: ModelConfig, spec: SublayerSpec, gen, device, lead) -> dict:
    dt = L.pdtype(cfg)
    p: dict = {"norm1": torch.ones((*lead, cfg.d_model), dtype=dt, device=device)}
    if spec.mixer == "attn":
        p["mixer"] = L.init_attention(cfg, gen, device, lead)
    else:
        p["mixer"] = M.init_mamba(cfg, gen, device, lead)
    if spec.ffn == "dense":
        p["norm2"] = torch.ones((*lead, cfg.d_model), dtype=dt, device=device)
        p["ffn"] = L.init_mlp(cfg, gen, device, lead=lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Params:
    """Uniform ±1/√d_in weights, ±0.02 embedding, zero biases, unit norms,
    the Mamba2 constants (the JAX init scheme), drawn from ``generator`` on
    ``device``."""
    _check_ported(cfg)
    device = resolve_device(device)
    dt = L.pdtype(cfg)
    lead = (cfg.num_periods,)
    params: Params = {"embed": L.init_embed(cfg, generator, device)}
    params["layers"] = {
        f"sub{i}": _init_sublayer(cfg, spec, generator, device, lead)
        for i, spec in enumerate(cfg.period_spec())
    }
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    return params


# ---------------------------------------------------------------------------
# sublayer application
# ---------------------------------------------------------------------------


def _index(tree, i: int):
    """The ``i``-th period of a stacked subtree (views of the same storage)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_sublayer_full(cfg: ModelConfig, spec: SublayerSpec, p: dict,
                         h: torch.Tensor, *, positions, causal: bool,
                         cache: Optional[dict] = None) -> torch.Tensor:
    """Full-sequence sublayer. With ``cache`` (prefill: this sublayer's
    ``[period]`` views) the mixer's state is written into it in place."""
    x = L.rms_norm(h, p["norm1"], cfg.rmsnorm_eps)
    if spec.mixer == "attn":
        if cache is not None:
            y, (k, v) = L.attention_forward(cfg, p["mixer"], x, positions,
                                            causal=causal, return_kv=True)
            S = k.shape[1]
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
        else:
            y = L.attention_forward(cfg, p["mixer"], x, positions, causal=causal)
    else:
        if cache is not None:
            y, fs, conv_tail = M.mamba_forward(cfg, p["mixer"], x, return_state=True)
            cache["ssm"].copy_(fs)
            cache["conv"].copy_(conv_tail)
        else:
            y = M.mamba_forward(cfg, p["mixer"], x)
    h = h + y.to(h.dtype)
    if spec.ffn == "dense":
        x2 = L.rms_norm(h, p["norm2"], cfg.rmsnorm_eps)
        h = h + L.mlp_forward(cfg, p["ffn"], x2).to(h.dtype)
    return h


def _apply_sublayer_step(cfg: ModelConfig, spec: SublayerSpec, p: dict,
                         h: torch.Tensor, cache: dict, *,
                         positions: torch.Tensor) -> torch.Tensor:
    """One-token decode sublayer, h (B, 1, D); updates ``cache`` (this
    sublayer's ``[period]`` views) in place."""
    x = L.rms_norm(h, p["norm1"], cfg.rmsnorm_eps)
    if spec.mixer == "attn":
        y, _, _ = L.attention_decode(cfg, p["mixer"], x, positions, cache["k"], cache["v"])
    else:
        y, ns, ncv = M.mamba_decode(cfg, p["mixer"], x, cache["ssm"], cache["conv"])
        cache["ssm"].copy_(ns)
        cache["conv"].copy_(ncv)
    h = h + y.to(h.dtype)
    if spec.ffn == "dense":
        x2 = L.rms_norm(h, p["norm2"], cfg.rmsnorm_eps)
        h = h + L.mlp_forward(cfg, p["ffn"], x2).to(h.dtype)
    return h


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------


def _run_stack_full(cfg: ModelConfig, stack_params: dict, specs, h, *,
                    positions, causal: bool,
                    cache_stack: Optional[dict] = None) -> torch.Tensor:
    for period in range(cfg.num_periods):
        pp = _index(stack_params, period)
        cc = _index(cache_stack, period) if cache_stack is not None else None
        for i, spec in enumerate(specs):
            h = _apply_sublayer_full(cfg, spec, pp[f"sub{i}"], h, positions=positions,
                                     causal=causal,
                                     cache=cc[f"sub{i}"] if cc is not None else None)
    return h


def _run_stack_step(cfg: ModelConfig, stack_params: dict, specs, h, cache_stack, *,
                    positions) -> torch.Tensor:
    for period in range(cfg.num_periods):
        pp = _index(stack_params, period)
        cc = _index(cache_stack, period)
        for i, spec in enumerate(specs):
            h = _apply_sublayer_step(cfg, spec, pp[f"sub{i}"], h, cc[f"sub{i}"],
                                     positions=positions)
    return h


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Eval forward. Returns (logits (B,S,V) fp32, aux_loss)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]
    h = L.embed(cfg, params["embed"], tokens)
    h = _run_stack_full(cfg, params["layers"], cfg.period_spec(), h,
                        positions=positions, causal=cfg.causal)
    h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
    logits = L.unembed(cfg, params["embed"], h)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device="cuda") -> Cache:
    """Zero-filled decode cache (leading num_periods axis per leaf): k/v
    (P, B, max_len, Hkv, Dh) in the compute dtype for attention, ssm
    (P, B, H, P, N) fp32 and conv (P, B, W-1, conv_dim) for Mamba2.
    ``enc_len`` is kept for the JAX signature (encoder-decoder raises).
    ``device="meta"`` allocates nothing (``serving.cache_shapes``)."""
    _check_ported(cfg)
    del enc_len
    device = resolve_device(device)
    P = cfg.num_periods
    dt = L.cdtype(cfg)
    cache: Cache = {}
    for i, spec in enumerate(cfg.period_spec()):
        entry: dict = {}
        if spec.mixer == "attn":
            kv = (P, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            entry["k"] = torch.zeros(kv, dtype=dt, device=device)
            entry["v"] = torch.zeros(kv, dtype=dt, device=device)
        else:
            entry["ssm"] = torch.zeros(
                (P, batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
                dtype=torch.float32, device=device)
            entry["conv"] = torch.zeros((P, batch, cfg.ssm_conv - 1, cfg.ssm_conv_dim),
                                        dtype=dt, device=device)
        cache[f"sub{i}"] = entry
    return cache


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], cache: Cache):
    """Run the prompt through the model, filling ``cache`` in place.

    Returns (last-position logits (B,V) fp32, cache, aux)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]
    h = L.embed(cfg, params["embed"], tokens)
    h = _run_stack_full(cfg, params["layers"], cfg.period_spec(), h,
                        positions=positions, causal=cfg.causal, cache_stack=cache)
    h = L.rms_norm(h[:, -1:], params["final_norm"], cfg.rmsnorm_eps)
    logits = L.unembed(cfg, params["embed"], h)[:, 0]
    return logits, cache, torch.zeros((), dtype=torch.float32, device=logits.device)


def decode_step(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,     # (B, 1)
    positions: torch.Tensor,  # (B,) int32 absolute position of the new token
    cache: Cache,
):
    """One decode step; updates ``cache`` in place. Returns (logits (B,V)
    fp32, cache)."""
    h = L.embed(cfg, params["embed"], tokens)
    h = _run_stack_step(cfg, params["layers"], cfg.period_spec(), h, cache,
                        positions=positions)
    h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
    logits = L.unembed(cfg, params["embed"], h)[:, 0]
    return logits, cache
