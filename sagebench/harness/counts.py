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


def model_flops(m: dict, batch: int, seq: int) -> dict:
    """The FLOPs one forward of (batch, seq) tokens needs, by part: the
    dense products (attention projections, the router, the experts each
    token is routed to, the Mamba2 projections), the causal attention
    products, the SSD chunk products, and the unembedding of every
    position (the forward computes all of them). Elementwise work, norms
    and the depthwise convolution are not counted."""
    T = batch * seq
    D, L = m["d_model"], m["num_layers"]
    dense = attn = ssm = 0.0
    if m["family"] == "ssm":
        di = m["ssm_expand"] * D
        H = di // m["ssm_headdim"]
        dense = 2.0 * T * (D * (2 * di + 2 * m["ssm_state"] + H) + di * D) * L
        ssm = ssd_call(*ssd_shape(m, batch, seq))["flops"] * L
    else:
        Hq, Hkv, Dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        proj = D * Hq * Dh * 2 + D * Hkv * Dh * 2
        ffn = 3 * D * m["expert_d_ff"] * m["experts_per_token"] + D * m["num_experts"]
        dense = 2.0 * T * (proj + ffn) * L
        attn = attention_call(*attention_shape(m, batch, seq))["flops"] * L
    unembed = 2.0 * T * D * m["vocab_size"]
    return {"dense": dense, "attention": attn, "ssd": ssm, "unembed": unembed,
            "total": dense + attn + ssm + unembed}
