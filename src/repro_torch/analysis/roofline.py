"""Roofline terms on one NVIDIA H100 SXM, and the work the hand kernels and
the model do.

Counterpart of the JAX package's ``analysis/roofline.py``, whose constants
are a TPU v5e's. Here the rates are the H100 SXM's published peaks (dense,
without sparsity, at the full 700 W power limit; a card set below it runs
slower under load, so a roofline share names the card's limit beside it):

  compute_s    = flops / PEAK_FLOPS[compute dtype]
  memory_s     = hbm_bytes / HBM_BW
  collective_s = collective_bytes / LINK_BW   (operand-size sum, as there)

``model_flops`` keeps the JAX package's rule: 6 N_active D for training,
2 N_active D for inference (N = active parameters, MoE-aware; D = tokens).

The bounds of the hand kernels are here too: each returns (the least time
in ms, what bounds it, its operations, its bytes) for one call at a shape,
the larger of operations over the peak of the input type and bytes (each
input read once, each output written once) over the memory rate.
``chip_smoke.py`` prints them beside the kernels' times, and
``op_analysis`` counts each kernel call by them.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.configs.base import ModelConfig

# NVIDIA H100 Tensor Core GPU datasheet (SXM5 column), dense rates:
#   bf16 tensor cores 989 TFLOP/s (1,979 with 2:4 sparsity); fp32 outside
#   the tensor cores (no TF32) 67 TFLOP/s; HBM3 3.35 TB/s.
# NVLink 4: 900 GB/s total a card (datasheet), 18 links of 25 GB/s each
#   way (NVIDIA H100 Tensor Core GPU Architecture whitepaper), so 450 GB/s
#   each way.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BW = 3.35e12
LINK_BW = 450e9
# one card's device memory in bytes, as torch.cuda.get_device_properties(0)
# .total_memory reports it on an H100 80GB HBM3 (chip_smoke.py checks it on
# the card). The rules' ZeRO-decode threshold is 60 % of it.
HBM_BYTES = 85_017_493_504


def model_flops(cfg: ModelConfig, mode: str, tokens: int) -> float:
    """6*N_active*D for training, 2*N_active*D for inference (global)."""
    n = cfg.active_param_count()
    mult = 6.0 if mode == "train" else 2.0
    return mult * n * tokens


def roofline_from_report(
    cfg: ModelConfig, report: Dict, *, chips: int, mode: str, tokens: int
) -> Dict:
    """The JAX package's roofline terms for an ``op_analysis`` report (per
    card), at the H100's rates; the compute term takes the peak of
    ``cfg``'s compute dtype."""
    peak = PEAK_FLOPS[getattr(torch, cfg.compute_dtype)]
    flops = report["flops"]
    hbm = report["hbm_bytes"]
    coll = report["collective_bytes"]
    coll_traffic = report["collective_traffic_bytes"]
    compute_s = flops / peak
    memory_s = hbm / HBM_BW
    collective_s = coll / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    # the traffic left if every elementwise op fused into its neighbours
    memory_fused_s = report.get("hbm_bytes_fused", hbm) / HBM_BW
    mf = model_flops(cfg, mode, tokens)
    global_flops = flops * chips
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "memory_fused_s": memory_fused_s,
        "collective_s": collective_s,
        "collective_traffic_s": coll_traffic / LINK_BW,
        "dominant": dominant,
        "model_flops_global": mf,
        "hlo_flops_global": global_flops,
        "useful_flops_ratio": mf / global_flops if global_flops else 0.0,
        "step_time_bound_s": max(terms.values()),
        # fraction of the compute roofline achieved if the dominant term
        # were the wall clock (MODEL_FLOPS / (chips * peak) / bound)
        "roofline_fraction": (
            (mf / (chips * peak)) / max(max(terms.values()), 1e-30)
        ),
    }


# ---------------------------------------------------------------------------
# the hand kernels' bounds
# ---------------------------------------------------------------------------

def bound(flops, nbytes, dtype):
    """Least time for the work: max(operations / peak, bytes / bandwidth)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BW * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound_ms(shape, dtype):
    """Operations: 2 matmuls x 2 flops per (query, visible key) pair per head
    dim; with the causal mask only keys k <= q are visible. Bytes: q, k, v
    read once and o written once."""
    B, Sq, Sk, Hq, Hkv, Dh, causal = shape
    pairs = sum(min(Sk, qp + 1) for qp in range(Sq)) if causal else Sq * Sk
    flops = 4.0 * B * Hq * Dh * pairs
    nbytes = (2 * B * Sq * Hq * Dh + 2 * B * Sk * Hkv * Dh) * torch.finfo(dtype).bits / 8
    return (*bound(flops, nbytes, dtype), flops, nbytes)


def attention_bwd_bound_ms(shape, dtype):
    """K1's backward: five (query, key) products against the forward's two,
    so 2.5 x ``attention_bound_ms``'s operations (the useful ones: the
    kernels recompute P, 3.5 x in all). Bytes: q, o, dO read and dq
    written; k, v read and dk, dv written; the fp32 log-sum-exp read."""
    B, Sq, Sk, Hq, Hkv, Dh, _ = shape
    flops = 2.5 * attention_bound_ms(shape, dtype)[2]
    elt = torch.finfo(dtype).bits / 8
    nbytes = elt * (4 * B * Sq * Hq * Dh + 4 * B * Sk * Hkv * Dh) + 4 * B * Hq * Sq
    return (*bound(flops, nbytes, dtype), flops, nbytes)


def decode_bound_ms(shape, lengths: Sequence[int], dtype):
    """As ``attention_bound_ms`` for one query per sequence, counted up to
    this run's lengths: 4 flops per (query head, cache position, head dim);
    bytes: q read, K and V up to each length read, o written."""
    B, L, Hq, Hkv, Dh = shape
    visible = float(sum(lengths))
    flops = 4.0 * Hq * Dh * visible
    nbytes = (2 * B * Hq * Dh + 2 * Hkv * Dh * visible) * torch.finfo(dtype).bits / 8
    return (*bound(flops, nbytes, dtype), flops, nbytes)


def ssd_chunk_lengths(S, T):
    """The chunks' lengths: T each, the last one ragged."""
    return [min(T, S - c) for c in range(0, S, T)]


def ssd_bound_ms(shape, dtype):
    """Operations the function needs, with the causal mask's pairs s <= l
    of each chunk of length t (t (t + 1) / 2 of them): C B^T once per
    (sequence, chunk), since it does not depend on the head (2 pairs N);
    per (sequence, chunk, head) the masked product with x*dt (2 pairs P),
    C times the entering state (2 t N P) and the state update (2 t P N).
    Bytes: x, dt, B, C read once, y and the fp32 final state written once."""
    B, S, H, P, N, T = shape
    flops = 0.0
    for t in ssd_chunk_lengths(S, T):
        pairs = t * (t + 1) / 2
        flops += 2.0 * B * (pairs * N + H * (pairs * P + 2 * t * N * P))
    elt = torch.finfo(dtype).bits / 8
    nbytes = elt * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + H + B * H * P * N)
    return (*bound(flops, nbytes, dtype), flops, nbytes)


def ssd_bwd_bound_ms(shape, dtype):
    """Operations the backward needs, counted as ``ssd_bound_ms`` counts the
    forward's: C B^T once per (sequence, chunk) (2 pairs N); per (sequence,
    chunk, head) the causal products dy u^T and du's sum over l >= s (each
    2 pairs P), dC's sum over s <= l and dB's over l >= s (each 2 pairs N),
    and five (P, N) state products of 2 t P N each: the chunk's local
    state, its adjoint, S-hat B (for du and the decay's gradient), S_in^T
    dy (for dC and the decay's gradient) and S-hat^T u (for dB). Bytes, for
    a call without an initial state or a final state's gradient (the train
    step's): x, dt, A, B, C, dy read once; dx, ddt, dA, dB, dC and the
    initial state's gradient written once."""
    B, S, H, P, N, T = shape
    flops = 0.0
    for t in ssd_chunk_lengths(S, T):
        pairs = t * (t + 1) / 2
        flops += 2.0 * B * (pairs * N + H * (2 * pairs * (P + N) + 5 * t * P * N))
    elt = torch.finfo(dtype).bits / 8
    nbytes = (elt * (3 * B * S * H * P + 4 * B * S * N) + 4 * 2 * (B * S * H + H)
              + 4 * B * H * P * N)
    return (*bound(flops, nbytes, dtype), flops, nbytes)


def train_step_flops(cfg: ModelConfig, batch: int, seq: int):
    """(dense, attention, SSD) FLOPs of one train step's useful work: 6 per
    parameter per token; 3 x the causal attention forward's products per
    attention layer; the SSD scan's forward and backward products as
    ``ssd_bound_ms`` and ``ssd_bwd_bound_ms`` count them (causal pairs only)
    per Mamba2 layer (no recompute counted)."""
    dense = 6.0 * cfg.param_count() * batch * seq
    shape = (batch, seq, seq, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, True)
    attn = 3.0 * attention_bound_ms(shape, torch.bfloat16)[2] * cfg.num_attn_layers
    ssd_shape = (batch, seq, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
    ssm = ((ssd_bound_ms(ssd_shape, torch.bfloat16)[2]
            + ssd_bwd_bound_ms(ssd_shape, torch.bfloat16)[2]) * cfg.num_mamba_layers
           if cfg.num_mamba_layers else 0.0)
    return dense, attn, ssm
