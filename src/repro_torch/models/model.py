"""Model facade, dense family: init / forward.

Params and the period stack keep the JAX layout: ``params["layers"]`` holds
``{"sub{i}": subtree}`` whose every leaf has a leading ``num_periods`` axis.
The JAX package scans over that axis with ``lax.scan``; here a Python loop
indexes the stacked leaves with ``[i]``. Rematerialisation and activation
sharding (``_maybe_remat``, ``constrain``) do nothing when serving on one
device and are not carried over.

MoE, Mamba2, cross-attention and encoder paths are not ported yet; they raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, SublayerSpec
from repro_torch.data.database import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _check_dense(cfg: ModelConfig) -> None:
    """Raise for the families this slice does not serve yet."""
    missing = None
    if cfg.is_encoder_decoder:
        missing = "encoder-decoder (whisper)"
    elif cfg.mrope_sections:
        missing = "M-RoPE (qwen2-vl)"
    elif any(s.mixer != "attn" for s in cfg.period_spec()):
        missing = "the Mamba2 mixer (mamba2, jamba; with K3)"
    elif any(s.ffn == "moe" for s in cfg.period_spec()):
        missing = "the MoE FFN (olmoe, llama4)"
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {missing} is not ported yet (ROADMAP.md Queue 1 item 7)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sublayer(cfg: ModelConfig, spec: SublayerSpec, gen, device, lead) -> dict:
    dt = L.pdtype(cfg)
    p: dict = {"norm1": torch.ones((*lead, cfg.d_model), dtype=dt, device=device)}
    p["mixer"] = L.init_attention(cfg, gen, device, lead)
    if spec.ffn == "dense":
        p["norm2"] = torch.ones((*lead, cfg.d_model), dtype=dt, device=device)
        p["ffn"] = L.init_mlp(cfg, gen, device, lead=lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Params:
    """Uniform ±1/√d_in weights, ±0.02 embedding, zero biases, unit norms
    (the JAX init scheme), drawn from ``generator`` on ``device``."""
    _check_dense(cfg)
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
# forward
# ---------------------------------------------------------------------------


def _index(tree, i: int):
    """The ``i``-th period of a stacked subtree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_sublayer_full(cfg: ModelConfig, spec: SublayerSpec, p: dict,
                         h: torch.Tensor, *, positions, causal: bool) -> torch.Tensor:
    x = L.rms_norm(h, p["norm1"], cfg.rmsnorm_eps)
    y = L.attention_forward(cfg, p["mixer"], x, positions, causal=causal)
    h = h + y.to(h.dtype)
    if spec.ffn == "dense":
        x2 = L.rms_norm(h, p["norm2"], cfg.rmsnorm_eps)
        h = h + L.mlp_forward(cfg, p["ffn"], x2).to(h.dtype)
    return h


def _run_stack_full(cfg: ModelConfig, stack_params: dict, specs, h, *,
                    positions, causal: bool) -> torch.Tensor:
    for period in range(cfg.num_periods):
        pp = _index(stack_params, period)
        for i, spec in enumerate(specs):
            h = _apply_sublayer_full(cfg, spec, pp[f"sub{i}"], h,
                                     positions=positions, causal=causal)
    return h


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Eval forward. Returns (logits (B,S,V) fp32, aux_loss)."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]
    h = L.embed(cfg, params["embed"], tokens)
    h = _run_stack_full(cfg, params["layers"], cfg.period_spec(), h,
                        positions=positions, causal=cfg.causal)
    h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
    logits = L.unembed(cfg, params["embed"], h)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
