"""Plain reference of mamba2-780m as ``mamba2-780m.json`` states it: the
weights' layout and the last position's logits of a forward, in float32
(or with its products in fp8, the control).

Per layer: RMSNorm, then the Mamba2 block: the in-projection to z, x, B,
C and dt; a depthwise causal convolution of width 4 over [x, B, C] and
SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD recurrence
over heads of 64 channels with a state of 128 (one group: B and C shared
by the heads), plus D x; the gate y * SiLU(z); an RMSNorm over the inner
width; the out-projection; a residual sum. Then the final RMSNorm and the
unembedding tied to the embedding."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from harness import plain


def dims(m: dict) -> dict:
    di = m["ssm_expand"] * m["d_model"]
    return {"di": di, "N": m["ssm_state"], "P": m["ssm_headdim"], "H": di // m["ssm_headdim"],
            "W": m["ssm_conv"], "conv": di + 2 * m["ssm_state"]}


def layout(m: dict) -> list:
    """(path, shape, dtype, rule) of every weight, in the layout the
    program's parameter tree has (layers stacked on a leading axis)."""
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    d = dims(m)
    bf, f32 = "bfloat16", "float32"
    mix = ("layers", "sub0", "mixer")
    return [
        (("embed", "embedding"), (V, D), bf, ("uniform", 0.02)),
        (("layers", "sub0", "norm1"), (L, D), bf, ("near_one", 0.1)),
        (mix + ("in_proj",), (L, D, 2 * d["di"] + 2 * d["N"] + d["H"]), bf,
         ("uniform", 1.0 / math.sqrt(D))),
        (mix + ("conv_w",), (L, d["W"], d["conv"]), bf, ("uniform", 1.0 / math.sqrt(d["W"]))),
        (mix + ("conv_b",), (L, d["conv"]), bf, ("uniform", 0.1)),
        (mix + ("A_log",), (L, d["H"]), f32, ("log_uniform_a", 1.0, 16.0)),
        (mix + ("D",), (L, d["H"]), f32, ("near_one", 0.5)),
        (mix + ("dt_bias",), (L, d["H"]), f32, ("dt_bias", 1e-3, 1e-1)),
        (mix + ("norm",), (L, d["di"]), bf, ("near_one", 0.1)),
        (mix + ("out_proj",), (L, d["di"], D), bf, ("uniform", 1.0 / math.sqrt(d["di"]))),
        (("final_norm",), (D,), bf, ("near_one", 0.1)),
    ]


def forward_last(W: dict, tokens: torch.Tensor, m: dict, precision: str = "fp32"):
    """The logits (B, V) of the last position of ``tokens`` (B, S)."""
    mm = plain.Products(precision)
    B, S = tokens.shape
    d, eps = dims(m), m["rmsnorm_eps"]
    lay, mix = W["layers"]["sub0"], W["layers"]["sub0"]["mixer"]
    with torch.no_grad(), plain.exact_fp32():
        h = W["embed"]["embedding"][tokens.long()].float()
        for i in range(m["num_layers"]):
            x = plain.rms_norm(h, lay["norm1"][i], eps)
            z, xbc, dt = torch.split(mm(x, mix["in_proj"][i]),
                                     [d["di"], d["di"] + 2 * d["N"], d["H"]], dim=-1)
            xbc = plain.causal_conv(xbc, mix["conv_w"][i], mix["conv_b"][i])
            xs, Bm, Cm = torch.split(xbc, [d["di"], d["N"], d["N"]], dim=-1)
            dt = F.softplus(dt + mix["dt_bias"][i].float())
            A = -torch.exp(mix["A_log"][i].float())
            xh = xs.reshape(B, S, d["H"], d["P"])
            y = plain.ssd(xh, dt, A, Bm, Cm, m["ssm_chunk"])
            y = (y + xh * mix["D"][i].float()[:, None]).reshape(B, S, d["di"])
            g = plain.rms_norm(y * F.silu(z), mix["norm"][i], eps)
            h = h + mm(g, mix["out_proj"][i])
        last = plain.rms_norm(h[:, -1], W["final_norm"], eps)
        return mm(last, W["embed"]["embedding"].T)
