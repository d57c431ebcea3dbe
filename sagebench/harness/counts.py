"""The yardstick's arithmetic: the card's peaks, the model FLOPs an
invocation needs, and the least time of each hand kernel's call.

The peaks are NVIDIA's H100 SXM data sheet's, dense, at the full 700 W:
989e12 FLOP/s in bf16 on the tensor cores, 3.35e12 B/s of HBM3. The
kernel bounds copy the arithmetic of the port's ``analysis/roofline.py``
as it stood when this benchmark was written, so a later change there does
not move the yardstick: max(operations / peak, bytes / bandwidth), each
input read once and each output written once, the causal mask's pairs only.
Everything takes a configuration's ``model`` dict; nothing here imports
the program."""
from __future__ import annotations

import math

PEAK_BF16 = 989e12
HBM_BW = 3.35e12
BF16 = 2


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def attention_call(B: int, S: int, Hq: int, Hkv: int, Dh: int) -> dict:
    """One causal self-attention call (K1) on bf16 (B, S, H, Dh) tensors."""
    flops = 4.0 * B * Hq * Dh * causal_pairs(S)
    nbytes = float((2 * B * S * Hq * Dh + 2 * B * S * Hkv * Dh) * BF16)
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(flops / PEAK_BF16, nbytes / HBM_BW)}


def chunk_lengths(S: int, T: int) -> list:
    return [min(T, S - c) for c in range(0, S, T)]


def ssd_call(B: int, S: int, H: int, P: int, N: int, T: int) -> dict:
    """One chunked SSD scan (K3) on bf16 x, B, C and fp32 dt: C B^T once per
    (sequence, chunk), and per head the masked product with x dt, C times
    the entering state and the state update. Bytes: x, dt, B, C read; y and
    the fp32 final state written."""
    flops = 0.0
    for t in chunk_lengths(S, T):
        pairs = t * (t + 1) / 2
        flops += 2.0 * B * (pairs * N + H * (pairs * P + 2 * t * N * P))
    nbytes = float(BF16 * (2 * B * S * H * P + 2 * B * S * N)
                   + 4 * (B * S * H + H + B * H * P * N))
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(flops / PEAK_BF16, nbytes / HBM_BW)}


def attention_shape(m: dict, batch: int, seq: int) -> tuple:
    return (batch, seq, m["num_heads"], m["num_kv_heads"], m["head_dim"])


def ssd_shape(m: dict, batch: int, seq: int) -> tuple:
    di = m["ssm_expand"] * m["d_model"]
    return (batch, seq, di // m["ssm_headdim"], m["ssm_headdim"], m["ssm_state"],
            m["ssm_chunk"])


def layer_kinds(m: dict) -> list:
    """Every layer's (mixer, FFN): mixer ``"mamba"`` or ``"attn"``, FFN
    ``"none"``, ``"dense"`` or ``"moe"``. The period arithmetic of the
    port's ``ModelConfig.period_len`` and ``period_spec`` as they stood
    when this was written: an SSM stack is Mamba2 mixers with no FFN; with
    ``attn_every`` over 1, attention where ``i % attn_every == 0`` and
    Mamba2 elsewhere, else attention throughout; with experts, a MoE FFN
    where ``i % moe_every == moe_every - 1`` and a dense one elsewhere.
    The FLOPs do not depend on where attention sits in a period."""
    family, L = m["family"], m["num_layers"]
    attn_every, moe_every = m.get("attn_every", 0), m.get("moe_every", 1)
    experts = m.get("num_experts", 0)
    period = 1
    if attn_every > 1:
        period = math.lcm(period, attn_every)
    if experts and moe_every > 1:
        period = math.lcm(period, moe_every)
    if L % period:
        raise ValueError(f"{L} layers are not whole periods of {period}")
    spec = []
    for i in range(period):
        if family == "ssm":
            mixer = "mamba"
        elif attn_every > 1:
            mixer = "attn" if i % attn_every == 0 else "mamba"
        else:
            mixer = "attn"
        if family == "ssm":
            ffn = "none"
        elif experts:
            ffn = "moe" if i % moe_every == moe_every - 1 else "dense"
        else:
            ffn = "dense"
        spec.append((mixer, ffn))
    return spec * (L // period)


def mixers(m: dict) -> set:
    """The kinds of mixer the model's layers hold."""
    return {mixer for mixer, _ in layer_kinds(m)}


def model_flops(m: dict, batch: int, seq: int) -> dict:
    """The FLOPs one forward of (batch, seq) tokens needs, by part, summed
    over ``layer_kinds``: the dense products (a Mamba2 mixer's in- and
    out-projections; an attention mixer's q, k, v and o projections; a
    dense SwiGLU; a MoE FFN's router, the experts each token is routed to
    and, with ``moe_shared_expert``, the shared SwiGLU of width
    ``shared_expert_d_ff``, else the experts' width), the causal attention
    products, the SSD chunk products, and the unembedding of every position
    (the forward computes all of them). Elementwise work, norms and the
    depthwise convolution are not counted."""
    T = batch * seq
    D = m["d_model"]
    kinds = layer_kinds(m)
    held = {mixer for mixer, _ in kinds}
    by_mixer = {}  # a mixer's multiply-adds a token in its projections, its kernel's FLOPs
    if "mamba" in held:
        di = m["ssm_expand"] * D
        H = di // m["ssm_headdim"]
        by_mixer["mamba"] = (D * (2 * di + 2 * m["ssm_state"] + H) + di * D,
                             ssd_call(*ssd_shape(m, batch, seq))["flops"])
    if "attn" in held:
        Hq, Hkv, Dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        by_mixer["attn"] = (D * Hq * Dh * 2 + D * Hkv * Dh * 2,
                            attention_call(*attention_shape(m, batch, seq))["flops"])
    ffns = {"none": 0, "dense": 3 * D * m.get("d_ff", 0)}  # multiply-adds a token
    if m.get("num_experts"):
        expert_ff = m.get("expert_d_ff") or m["d_ff"]
        ffns["moe"] = 3 * D * expert_ff * m["experts_per_token"] + D * m["num_experts"]
        if m.get("moe_shared_expert"):
            ffns["moe"] += 3 * D * (m.get("shared_expert_d_ff") or expert_ff)
    dense = attn = ssm = 0.0
    for mixer, ffn in kinds:
        proj, call = by_mixer[mixer]
        dense += 2.0 * T * (proj + ffns[ffn])
        if mixer == "mamba":
            ssm += call
        else:
            attn += call
    unembed = 2.0 * T * D * m["vocab_size"]
    return {"dense": dense, "attention": attn, "ssd": ssm, "unembed": unembed,
            "total": dense + attn + ssm + unembed}
