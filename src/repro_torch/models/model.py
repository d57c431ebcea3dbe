"""Model facade: init / forward / prefill / decode for every family of the
zoo: dense, MoE, M-RoPE, Mamba2, hybrid and encoder-decoder.

Params and the period stack keep the JAX layout: ``params["layers"]`` holds
``{"sub{i}": subtree}`` whose every leaf has a leading ``num_periods`` axis,
and so does every leaf of a decode cache; the encoder's stack
(``params["enc_layers"]``) leads with ``encoder_layers`` instead. The JAX
package scans over that axis with ``lax.scan``; here a Python loop indexes
the stacked leaves, as many times as the stack's own leading size: each
stacked leaf is split once with ``torch.unbind`` (views), so autograd
stacks its gradient in one allocation. Rematerialisation follows
``cfg.remat_policy`` as ``_maybe_remat`` does there, through
``torch.utils.checkpoint`` (non-reentrant) around each period, and only
while a gradient is being taken: ``nothing_saveable`` keeps each period's
input alone and recomputes the rest in the backward, ``dots_saveable``
also keeps the matrix products' outputs, ``none`` keeps everything.
Serving (no gradient) runs the plain loop. As the JAX model does, the
residual is constrained after every period (``constrain(h, "residual")``,
under remat too): on ``DTensor``s it is redistributed to the cell's
activation policy (``distributed.act_sharding``); with no policy, or on a
plain tensor, it is the identity.

The JAX cache is immutable and every step returns a new one; here
``prefill`` and ``decode_step`` write into the ``[period]`` views of the
stacked cache IN PLACE and return the same dict. So the cross cache
(encoder-decoder) must be allocated at the encoder's length: the JAX
prefill replaces it with whatever length the encoder gives.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, SublayerSpec
from repro_torch.data.database import resolve_device
from repro_torch.distributed.act_sharding import constrain, placed_like
from repro_torch.distributed.compat import is_dtensor
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

Params = Dict[str, Any]
Cache = Dict[str, Any]

ENC_SPEC = (SublayerSpec(mixer="attn", ffn="dense"),)  # the whisper encoder's sublayer
# the decode step routes B tokens as one row of B with the JAX ``model.py``
# decode factor: C = max(K, ceil(K * B * 4 / E)). Where C < B an expert can
# still overflow and drop a choice, as in the reference (llama4: K 1, E 128;
# jamba: K 2, E 16, at B 4); olmoe (K 8, E 64) gets C = 8 >= B up to B 8
DECODE_CAPACITY_FACTOR = 4.0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sublayer(cfg: ModelConfig, spec: SublayerSpec, gen, device, lead, *,
                   cross: bool) -> dict:
    dt = L.pdtype(cfg)
    ones = lambda: torch.ones((*lead, cfg.d_model), dtype=dt, device=device)  # noqa: E731
    p: dict = {"norm1": ones()}
    if spec.mixer == "attn":
        p["mixer"] = L.init_attention(cfg, gen, device, lead)
    else:
        p["mixer"] = M.init_mamba(cfg, gen, device, lead)
    if cross:
        p["cross"] = L.init_attention(cfg, gen, device, lead)
        p["norm_cross"] = ones()
    if spec.ffn == "dense":
        p["norm2"] = ones()
        p["ffn"] = L.init_mlp(cfg, gen, device, lead=lead)
    elif spec.ffn == "moe":
        p["norm2"] = ones()
        p["ffn"] = L.init_moe(cfg, gen, device, lead)
    return p


def _init_stack(cfg: ModelConfig, gen, device, depth: int, specs, *, cross: bool) -> dict:
    """Stacked params: {'sub{i}': subtree with a leading ``depth`` axis}."""
    return {f"sub{i}": _init_sublayer(cfg, spec, gen, device, (depth,), cross=cross)
            for i, spec in enumerate(specs)}


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Params:
    """Uniform ±1/√d_in weights, ±0.02 embedding, zero biases, unit norms,
    the Mamba2 constants, an fp32 router (the JAX init scheme), drawn from
    ``generator`` on ``device`` (on ``meta``: shapes only, see
    ``param_shapes``)."""
    device = resolve_device(device)
    dt = L.pdtype(cfg)
    params: Params = {"embed": L.init_embed(cfg, generator, device)}
    params["layers"] = _init_stack(cfg, generator, device, cfg.num_periods, cfg.period_spec(),
                                   cross=cfg.is_encoder_decoder)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    if cfg.is_encoder_decoder:
        params["enc_layers"] = _init_stack(cfg, generator, device, cfg.encoder_layers,
                                           ENC_SPEC, cross=False)
        params["enc_final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    return params


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree on the ``meta`` device: every leaf's shape and
    dtype, nothing drawn and nothing allocated (the JAX package's
    ``jax.eval_shape(init_params)``). A 400B model's tree is laid out on a
    mesh this way (``launch.cells``)."""
    return init_params(cfg, None, "meta")


# ---------------------------------------------------------------------------
# sublayer application
# ---------------------------------------------------------------------------


def _unstack(tree, n: int) -> List[Any]:
    """The ``n`` periods of a stacked subtree, each a tree of views of the
    same storage. One ``unbind`` per leaf: its backward stacks the
    periods' gradients in one allocation, where ``leaf[i]`` per period
    would give each period a full-size zero gradient of the whole stack."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return torch.unbind(tree, 0)


def _depth(tree) -> int:
    """The leading size of a stacked subtree (periods or encoder layers)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _add(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The residual sum h + y in h's dtype; a sharded ``y`` is placed as
    ``h`` first (``act_sharding.placed_like``)."""
    return h + placed_like(y, h).to(h.dtype)


def _ffn(cfg: ModelConfig, spec: SublayerSpec, p: dict, h: torch.Tensor, *,
         capacity_factor: Optional[float] = None):
    """The FFN half of a sublayer: (h, its MoE aux loss or 0.0)."""
    if spec.ffn == "none":
        return h, 0.0
    x2 = L.rms_norm(h, p["norm2"], cfg.rmsnorm_eps)
    if spec.ffn == "dense":
        return _add(h, L.mlp_forward(cfg, p["ffn"], x2)), 0.0
    f, aux = L.moe_forward(cfg, p["ffn"], x2, capacity_factor=capacity_factor)
    return _add(h, f), aux


def _apply_sublayer_full(cfg: ModelConfig, spec: SublayerSpec, p: dict,
                         h: torch.Tensor, *, positions, causal: bool,
                         enc: Optional[torch.Tensor] = None,
                         cache: Optional[dict] = None):
    """Full-sequence sublayer; returns (h, aux). With ``cache`` (prefill:
    this sublayer's ``[period]`` views) the mixer's state and the cross k/v
    are written into it in place."""
    x = L.rms_norm(h, p["norm1"], cfg.rmsnorm_eps)
    if spec.mixer == "attn":
        if cache is not None:
            y, (k, v) = L.attention_forward(cfg, p["mixer"], x, positions,
                                            causal=causal, return_kv=True)
            if is_dtensor(cache["k"]):  # each rank writes the rows of its shard
                from repro_torch.distributed import local
                local.write_rows(cache["k"], k)
                local.write_rows(cache["v"], v)
            else:
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
    h = _add(h, y)
    if "cross" in p and enc is not None:
        xc = L.rms_norm(h, p["norm_cross"], cfg.rmsnorm_eps)
        if cache is not None:
            yc, (ck, cv) = L.cross_attention_forward(cfg, p["cross"], xc, enc, return_kv=True)
            cache["ck"].copy_(ck)
            cache["cv"].copy_(cv)
        else:
            yc = L.cross_attention_forward(cfg, p["cross"], xc, enc)
        h = _add(h, yc)
    return _ffn(cfg, spec, p, h)


def _apply_sublayer_step(cfg: ModelConfig, spec: SublayerSpec, p: dict,
                         h: torch.Tensor, cache: dict, *,
                         positions: torch.Tensor) -> torch.Tensor:
    """One-token decode sublayer, h (B, 1, D); updates ``cache`` (this
    sublayer's ``[period]`` views) in place."""
    x = L.rms_norm(h, p["norm1"], cfg.rmsnorm_eps)
    if spec.mixer == "attn":
        pos = positions.expand(3, *positions.shape) if cfg.mrope_sections else positions
        y, _, _ = L.attention_decode(cfg, p["mixer"], x, pos, cache["k"], cache["v"])
    else:
        y, ns, ncv = M.mamba_decode(cfg, p["mixer"], x, cache["ssm"], cache["conv"])
        cache["ssm"].copy_(ns)
        cache["conv"].copy_(ncv)
    h = _add(h, y)
    if "cross" in p:
        xc = L.rms_norm(h, p["norm_cross"], cfg.rmsnorm_eps)
        h = _add(h, L.cross_attention_decode(cfg, p["cross"], xc, cache["ck"], cache["cv"]))
    if spec.ffn == "moe":  # the B new tokens are routed as one row of B
        B = h.shape[0]
        out, _ = _ffn(cfg, spec, p, h.reshape(1, B, -1),
                      capacity_factor=DECODE_CAPACITY_FACTOR)
        return out.reshape(B, 1, -1)
    return _ffn(cfg, spec, p, h)[0]


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------


def _apply_period_full(cfg: ModelConfig, specs, pp: dict, h: torch.Tensor, *,
                       positions, causal: bool, enc: Optional[torch.Tensor] = None,
                       cc: Optional[dict] = None):
    """One period's sublayers over a full sequence; returns (h, aux summed
    over them: 0.0 for a period without MoE)."""
    aux = 0.0  # a tensor from the first MoE sublayer on: no launch per dense one
    for i, spec in enumerate(specs):
        h, a = _apply_sublayer_full(cfg, spec, pp[f"sub{i}"], h, positions=positions,
                                    causal=causal, enc=enc,
                                    cache=cc[f"sub{i}"] if cc is not None else None)
        aux = aux + a
    return h, aux


# the matrix products whose outputs ``dots_saveable`` keeps (``@`` and
# ``einsum`` reach these), as JAX's ``checkpoint_policies.dots_saveable``
# keeps dot_general's
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, h: torch.Tensor, stack_params: dict):
    """``checkpoint`` for each period under ``cfg.remat_policy``, or None
    (policy ``none``, or no gradient is being taken)."""
    if cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return None
    if not (h.requires_grad or any(t.requires_grad for t in T.leaves(stack_params))):
        return None
    if cfg.remat_policy == "dots_saveable":
        keep_dots = functools.partial(ckpt.create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(ckpt.checkpoint, use_reentrant=False, context_fn=keep_dots)
    return functools.partial(ckpt.checkpoint, use_reentrant=False)


def _run_stack_full(cfg: ModelConfig, stack_params: dict, specs, h, *,
                    positions, causal: bool, enc: Optional[torch.Tensor] = None,
                    cache_stack: Optional[dict] = None):
    """Every period of the stack over a full sequence; returns (h, the aux
    losses summed over sublayers, a 0-d fp32 tensor)."""
    depth = _depth(stack_params)
    periods = _unstack(stack_params, depth)
    caches = _unstack(cache_stack, depth) if cache_stack is not None else [None] * depth
    remat = _remat(cfg, h, stack_params) if cache_stack is None else None
    aux = 0.0
    for pp, cc in zip(periods, caches):
        kw = dict(positions=positions, causal=causal, enc=enc, cc=cc)
        if remat is None:
            h, a = _apply_period_full(cfg, specs, pp, h, **kw)
        else:
            h, a = remat(_apply_period_full, cfg, specs, pp, h, **kw)
        h = constrain(h, "residual")
        aux = aux + a
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def _run_stack_step(cfg: ModelConfig, stack_params: dict, specs, h, cache_stack, *,
                    positions) -> torch.Tensor:
    depth = _depth(stack_params)
    for pp, cc in zip(_unstack(stack_params, depth), _unstack(cache_stack, depth)):
        for i, spec in enumerate(specs):
            h = _apply_sublayer_step(cfg, spec, pp[f"sub{i}"], h, cc[f"sub{i}"],
                                     positions=positions)
    return h


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _positions(cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(1, S) positions, or M-RoPE's (3, B, S): the batch's
    ``mrope_positions``, else ``arange`` in all three streams."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    if not cfg.mrope_sections:
        return pos[None, :]
    given = batch.get("mrope_positions")
    return given if given is not None else pos.expand(3, B, S)


def _encode(cfg: ModelConfig, params: Params, enc_embeds: torch.Tensor) -> torch.Tensor:
    """Whisper encoder: non-causal self-attention over frame embeddings."""
    pos = torch.arange(enc_embeds.shape[1], device=enc_embeds.device)[None, :]
    h = enc_embeds.to(L.cdtype(cfg))
    h, _ = _run_stack_full(cfg, params["enc_layers"], ENC_SPEC, h, positions=pos,
                           causal=cfg.encoder_causal)
    return L.rms_norm(h, params["enc_final_norm"], cfg.rmsnorm_eps)


def _run(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
         cache: Optional[Cache] = None):
    """Embed, encode (encoder-decoder), run the decoder stack; (h, aux)."""
    enc = None
    if cfg.is_encoder_decoder:
        enc = _encode(cfg, params, batch["encoder_embeds"])
    h = L.embed(cfg, params["embed"], batch["tokens"])
    return _run_stack_full(cfg, params["layers"], cfg.period_spec(), h,
                           positions=_positions(cfg, batch), causal=cfg.causal, enc=enc,
                           cache_stack=cache)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Eval forward. ``batch`` holds ``tokens`` (B, S), and
    ``encoder_embeds`` (B, S_enc, D) for encoder-decoder models; M-RoPE
    models may add ``mrope_positions`` (3, B, S). Returns (logits (B,S,V)
    fp32, the MoE aux loss summed over sublayers)."""
    h, aux = _run(cfg, params, batch)
    h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
    return L.unembed(cfg, params["embed"], h), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device="cuda") -> Cache:
    """Zero-filled decode cache (leading num_periods axis per leaf): k/v
    (P, B, max_len, Hkv, Dh) in the compute dtype for attention, ssm
    (P, B, H, P, N) fp32 and conv (P, B, W-1, conv_dim) for Mamba2, and for
    encoder-decoder models the cross k/v ck/cv (P, B, enc_len, Hkv, Dh).
    ``device="meta"`` allocates nothing (``serving.cache_shapes``)."""
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
        if cfg.is_encoder_decoder:
            ckv = (P, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
            entry["ck"] = torch.zeros(ckv, dtype=dt, device=device)
            entry["cv"] = torch.zeros(ckv, dtype=dt, device=device)
        cache[f"sub{i}"] = entry
    return cache


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], cache: Cache):
    """Run the prompt through the model, filling ``cache`` in place
    (``batch`` as for ``forward``).

    Returns (last-position logits (B,V) fp32, cache, aux)."""
    if cfg.is_encoder_decoder:
        enc_len, have = batch["encoder_embeds"].shape[1], cache["sub0"]["ck"].shape[2]
        if enc_len != have:
            raise ValueError(f"the cross cache holds {have} encoder positions, the "
                             f"encoder gives {enc_len}: init_cache(..., enc_len={enc_len})")
    h, aux = _run(cfg, params, batch, cache)
    h = L.rms_norm(h[:, -1:], params["final_norm"], cfg.rmsnorm_eps)
    logits = L.unembed(cfg, params["embed"], h)[:, 0]
    return logits, cache, aux


def decode_step(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,     # (B, 1)
    positions: torch.Tensor,  # (B,) int32 absolute position of the new token
    cache: Cache,
):
    """One decode step (M-RoPE: all three streams at ``positions``);
    updates ``cache`` in place. Returns (logits (B,V) fp32, cache)."""
    h = L.embed(cfg, params["embed"], tokens)
    h = _run_stack_step(cfg, params["layers"], cfg.period_spec(), h, cache,
                        positions=positions)
    h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
    logits = L.unembed(cfg, params["embed"], h)[:, 0]
    return logits, cache
