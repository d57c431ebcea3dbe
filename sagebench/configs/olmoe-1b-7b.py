"""Plain reference of olmoe-1b-7b as ``olmoe-1b-7b.json`` states it: the
weights' layout and the last position's logits of a forward, in float32
(or with its products in fp8, the control).

Per layer: RMSNorm, multi-head attention (q, k and v projections, an
RMSNorm over each head of q and of k, rotary embedding, causal softmax
attention, the output projection), a residual sum; RMSNorm, the router
(float32 softmax over 64 experts, the top 8 by a stable sort, their
weights renormalised to sum to 1), each expert a SwiGLU of width 1024, a
residual sum. Each batch row gives every expert C = max(8, ceil(8 S 1.25 /
64)) slots, taken by the choices in order of position and then of rank;
a choice past its expert's C is dropped. Then the final RMSNorm and the
untied unembedding. What this configuration changes from the published
model is listed in its file under ``changed_from_source``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from harness import plain


def layout(m: dict) -> list:
    """(path, shape, dtype, rule) of every weight, in the layout the
    program's parameter tree has (layers stacked on a leading axis)."""
    L, D, H, Dh = m["num_layers"], m["d_model"], m["num_heads"], m["head_dim"]
    Hkv, E, Fe, V = m["num_kv_heads"], m["num_experts"], m["expert_d_ff"], m["vocab_size"]
    bf, f32 = "bfloat16", "float32"
    u = lambda fan_in: ("uniform", 1.0 / math.sqrt(fan_in))  # noqa: E731
    near1 = ("near_one", 0.1)
    mix = ("layers", "sub0", "mixer")
    ffn = ("layers", "sub0", "ffn")
    return [
        (("embed", "embedding"), (V, D), bf, ("uniform", 0.02)),
        (("embed", "lm_head"), (D, V), bf, u(D)),
        (("layers", "sub0", "norm1"), (L, D), bf, near1),
        (mix + ("wq",), (L, D, H * Dh), bf, u(D)),
        (mix + ("wk",), (L, D, Hkv * Dh), bf, u(D)),
        (mix + ("wv",), (L, D, Hkv * Dh), bf, u(D)),
        (mix + ("wo",), (L, H * Dh, D), bf, u(H * Dh)),
        (mix + ("q_norm",), (L, Dh), bf, near1),
        (mix + ("k_norm",), (L, Dh), bf, near1),
        (("layers", "sub0", "norm2"), (L, D), bf, near1),
        (ffn + ("router",), (L, D, E), f32, u(D)),
        (ffn + ("wg",), (L, E, D, Fe), bf, u(D)),
        (ffn + ("wu",), (L, E, D, Fe), bf, u(D)),
        (ffn + ("wd",), (L, E, Fe, D), bf, u(Fe)),
        (("final_norm",), (D,), bf, near1),
    ]


def capacity(m: dict, S: int) -> int:
    E, K = m["num_experts"], m["experts_per_token"]
    return max(K, int(math.ceil(K * S * m["moe_capacity_factor"] / E)))


def moe(x: torch.Tensor, router, wg, wu, wd, m: dict, mm, probe=None,
        round_router: bool = False) -> torch.Tensor:
    """The expert layer on x (B, S, D), float32. ``router`` stays float32
    in both precisions: the configuration keeps it so. ``probe``, a list,
    gets each token's margin between its K-th and (K+1)-th probability.
    ``round_router`` rounds the router's input to bf16, as the served
    residual stream is, and nothing else: a witness of how far routing
    flips alone move the answer."""
    B, S, D = x.shape
    E, K = m["num_experts"], m["experts_per_token"]
    xr = x.bfloat16().float() if round_router else x
    probs = torch.softmax(xr @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    if probe is not None:
        probe.append((vals[..., K - 1] - vals[..., K]).flatten().cpu())
    vals, idx = vals[..., :K], idx[..., :K]
    gates = (vals / vals.sum(-1, keepdim=True)).reshape(B, S * K)
    flat = idx.reshape(B, S * K)
    hot = F.one_hot(flat, E)
    slot = (torch.cumsum(hot, dim=1) * hot).sum(-1) - 1  # rank of the choice in its expert
    kept = slot < capacity(m, S)
    xs = x.reshape(B * S, D)
    token = (torch.arange(B, device=x.device)[:, None] * S
             + torch.arange(S * K, device=x.device)[None, :] // K)
    y = torch.zeros_like(xs)
    for e in range(E):
        sel = (flat == e) & kept
        if not bool(sel.any()):
            continue
        t, g = token[sel], gates[sel]
        xe = xs[t]
        h = F.silu(mm(xe, wg[e])) * mm(xe, wu[e])
        y.index_add_(0, t, mm(h, wd[e]) * g[:, None])
    return y.reshape(B, S, D)


def forward_last(W: dict, tokens: torch.Tensor, m: dict, precision: str = "fp32", probe=None,
                 round_router: bool = False):
    """The logits (B, V) of the last position of ``tokens`` (B, S);
    ``probe`` and ``round_router`` as ``moe`` takes them."""
    mm = plain.Products(precision)
    B, S = tokens.shape
    H, Dh, eps = m["num_heads"], m["head_dim"], m["rmsnorm_eps"]
    lay, mix, ffn = W["layers"]["sub0"], W["layers"]["sub0"]["mixer"], W["layers"]["sub0"]["ffn"]
    with torch.no_grad(), plain.exact_fp32():
        h = W["embed"]["embedding"][tokens.long()].float()
        for i in range(m["num_layers"]):
            x = plain.rms_norm(h, lay["norm1"][i], eps)
            q = mm(x, mix["wq"][i]).reshape(B, S, H, Dh)
            k = mm(x, mix["wk"][i]).reshape(B, S, m["num_kv_heads"], Dh)
            v = mm(x, mix["wv"][i]).reshape(B, S, m["num_kv_heads"], Dh)
            q = plain.rope(plain.rms_norm(q, mix["q_norm"][i], eps), m["rope_theta"])
            k = plain.rope(plain.rms_norm(k, mix["k_norm"][i], eps), m["rope_theta"])
            o = plain.causal_attention(q, k, v).reshape(B, S, H * Dh)
            h = h + mm(o, mix["wo"][i])
            x = plain.rms_norm(h, lay["norm2"][i], eps)
            h = h + moe(x, ffn["router"][i], ffn["wg"][i], ffn["wu"][i], ffn["wd"][i], m, mm,
                        probe, round_router)
        last = plain.rms_norm(h[:, -1], W["final_norm"], eps)
        return mm(last, W["embed"]["lm_head"])
