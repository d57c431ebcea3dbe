"""Mamba2 (SSD — state-space duality) blocks, as ``repro.models.mamba2``.

Forward and prefill run the chunked SSD scan through ``kernels.ops``: the
hand-written CUDA kernel for a CUDA tensor, the plain chunked version
(``ssd_chunked_ref``) for a CPU one. Decode is the O(1) recurrent step
``ssd_step_ref``, plain PyTorch (the JAX package has no kernel for it).

Shapes (ngroups = 1, i.e. B/C shared across heads, MQA-style):
  x:  (B, S, H, P)      dt: (B, S, H)      A: (H,)
  Bm: (B, S, N)         Cm: (B, S, N)      state: (B, H, P, N)
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compat import is_dtensor
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan as ssd_chunked_ref  # noqa: F401
from repro_torch.models.layers import _uniform, cdtype, dense_init, pdtype, rms_norm, weight


def ssd_step_ref(
    state: torch.Tensor,  # (B, H, P, N)
    x: torch.Tensor,      # (B, H, P)
    dt: torch.Tensor,     # (B, H)
    A: torch.Tensor,      # (H,)
    Bm: torch.Tensor,     # (B, N)
    Cm: torch.Tensor,     # (B, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recurrent decode step. Returns (y (B,H,P) in x's dtype, new_state fp32)."""
    f32 = torch.float32
    dtf = dt.to(f32)
    decay = torch.exp(dtf * A.to(f32))  # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", x.to(f32) * dtf[..., None], Bm.to(f32))
    new_state = state.to(f32) * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.to(f32))
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """fp32 ``jnp.linspace(start, stop, num)``, bit for bit: JAX computes
    ``start * (1 - t) + stop * t`` with ``t = iota / (num - 1)`` and appends
    ``stop`` (``torch.linspace`` rounds differently)."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def init_mamba(cfg: ModelConfig, gen, device, lead=()) -> dict:
    """The JAX init: uniform ±1/√d_in projections, uniform ±1/√W conv
    weights, zero conv bias, unit norm, and the constants A_log =
    log(linspace(1, 16, H)), D = 1, dt_bias = log(expm1(0.01)) (fp32). The
    linspace is JAX's bit for bit; torch's fp32 log may differ from XLA's in
    the last bit."""
    dt = pdtype(cfg)
    d, di, ns, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    proj_out = 2 * di + 2 * ns + nh  # z, x, B, C, dt
    f32 = torch.float32

    def const(v: torch.Tensor) -> torch.Tensor:
        return v.expand(*lead, nh).clone()

    return {
        "in_proj": dense_init(gen, d, proj_out, dt, device, lead),
        "conv_w": _conv_init(gen, cfg.ssm_conv, cfg.ssm_conv_dim, dt, device, lead),
        "conv_b": torch.zeros((*lead, cfg.ssm_conv_dim), dtype=dt, device=device),
        "A_log": const(torch.log(_linspace(1.0, 16.0, nh, device))),
        "D": torch.ones((*lead, nh), dtype=f32, device=device),
        "dt_bias": const(torch.log(torch.expm1(torch.full((nh,), 0.01, dtype=f32,
                                                          device=device)))),
        "norm": torch.ones((*lead, di), dtype=dt, device=device),
        "out_proj": dense_init(gen, di, d, dt, device, lead),
    }


def _conv_init(gen, width: int, dim: int, dtype, device, lead=()) -> torch.Tensor:
    return _uniform(gen, (*lead, width, dim), 1.0 / math.sqrt(width), dtype, device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x: (B, S, C), w: (W, C). The same unrolled
    fp32 accumulation as the JAX version."""
    W = w.shape[0]
    S = x.shape[1]
    # x behind W - 1 zero rows (F.pad's values; torch 2.11's DTensor gives
    # constant_pad_nd a one-dim placement, which breaks on a 2-D mesh)
    xp = torch.cat([torch.zeros_like(x[:, :1]).expand(-1, W - 1, -1), x], dim=1)
    out = torch.zeros_like(x, dtype=torch.float32, memory_format=torch.contiguous_format)
    for i in range(W):  # W = 4: tiny static unroll
        out = out + xp[:, i:i + S].float() * w[i].float()
    return F.silu(out + b.float()).to(x.dtype)


def mamba_forward(
    cfg: ModelConfig,
    p: dict,
    xin: torch.Tensor,  # (B, S, D)
    *,
    initial_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Full-sequence Mamba2 block (forward / prefill). With ``return_state``
    also returns the final SSM state (B, H, P, N) fp32 and the pre-conv
    tail (B, W-1, conv_dim), the decode conv state; that needs at least
    W-1 tokens, and a shorter sequence raises ``ValueError`` (the JAX
    package stores the short tail and its next decode step raises). A
    ``DTensor`` input (a cell on a mesh) runs each rank's share of the SSD
    heads through ``distributed.local.mamba_mixer``."""
    S = xin.shape[1]
    if return_state and S < cfg.ssm_conv - 1:
        raise ValueError(
            f"a Mamba2 prefill of {S} tokens is shorter than the conv state's "
            f"{cfg.ssm_conv - 1} rows (ssm_conv - 1)")
    if is_dtensor(xin):
        from repro_torch.distributed import local
        return local.mamba_mixer(cfg, p, xin, initial_state=initial_state,
                                 return_state=return_state)
    return mixer(cfg, p, xin, initial_state=initial_state, return_state=return_state)


def own_columns(cfg: ModelConfig, rank: int, ranks: int):
    """The in_proj columns that rank ``rank`` of ``ranks`` reads, as (first,
    count) ranges in order: its share of z, then of x, B and C whole, its
    share of dt (its SSD heads, contiguous). One range per block when
    ``ranks`` is 1."""
    di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    dr, hr = di // ranks, nh // ranks
    return [(rank * dr, dr), (di + rank * dr, dr), (2 * di, 2 * ns),
            (2 * di + 2 * ns + rank * hr, hr)]


def _take(t: torch.Tensor, ranges, dim: int) -> torch.Tensor:
    return torch.cat([t.narrow(dim, a, n) for a, n in ranges], dim=dim)


def mixer(
    cfg: ModelConfig,
    p: dict,
    xin: torch.Tensor,  # (B, S, D)
    *,
    initial_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
    rank: int = 0,
    ranks: int = 1,
    sum_ranks=None,
    proj=None,
):
    """The Mamba2 block on rank ``rank`` of ``ranks``' share of the SSD
    heads (all of them when ``ranks`` is 1; plain tensors): ``gated``, the
    gated RMSNorm over all of d_inner (``sum_ranks`` sums a tensor over the
    ranks: the sum of squares), then ``norm_out``. The output is the
    rank's partial sum of out_proj, the final state its heads', and the
    conv tail its own channels: [x share, B, C]."""
    g, final_state, conv_tail = gated(cfg, p, xin, initial_state=initial_state, rank=rank,
                                      ranks=ranks, proj=proj)
    if ranks == 1:
        ct = cdtype(cfg)
        out = rms_norm(g, p["norm"], cfg.rmsnorm_eps).to(ct) @ weight(p["out_proj"], ct)
    else:
        out = norm_out(cfg, p, g, sum_ranks(sum_squares(g)), rank=rank, ranks=ranks)
    if return_state:
        return out, final_state, conv_tail
    return out


def _rank_proj(cfg: ModelConfig, p: dict, xin: torch.Tensor, rank: int, ranks: int, proj):
    """The z/x/B/C/dt of rank ``rank`` of ``ranks``: ``proj`` where it is
    given (its columns of in_proj's product, already computed), else
    ``xin`` times its columns of ``p["in_proj"]`` (all of them when
    ``ranks`` is 1). Split as (z, x B C, dt)."""
    ct = cdtype(cfg)
    if proj is not None:
        zxbcdt = proj
    elif ranks == 1:
        zxbcdt = xin.to(ct) @ weight(p["in_proj"], ct)
    else:
        zxbcdt = xin.to(ct) @ _take(weight(p["in_proj"], ct), own_columns(cfg, rank, ranks), 1)
    dr, hr = cfg.ssm_d_inner // ranks, cfg.ssm_nheads // ranks
    return torch.split(zxbcdt, [dr, dr + 2 * cfg.ssm_state, hr], dim=-1)


def _rank_params(cfg: ModelConfig, p: dict, rank: int, ranks: int):
    """The conv weights of rank ``rank``'s channels (its x share, then B and
    C; all of them when ``ranks`` is 1) and the dt bias, A_log and D of its
    SSD heads."""
    di, ns = cfg.ssm_d_inner, cfg.ssm_state
    dr, hr = di // ranks, cfg.ssm_nheads // ranks
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if ranks > 1:
        chans = [(rank * dr, dr), (di, 2 * ns)]
        conv_w, conv_b = _take(conv_w, chans, 1), _take(conv_b, chans, 0)
    heads = slice(rank * hr, (rank + 1) * hr)
    return conv_w, conv_b, p["dt_bias"][heads], p["A_log"][heads], p["D"][heads]


def gated(cfg: ModelConfig, p: dict, xin: torch.Tensor, *,
          initial_state: Optional[torch.Tensor] = None, rank: int = 0, ranks: int = 1,
          proj=None):
    """in_proj -> conv -> SSD -> y * silu(z) on rank ``rank`` of ``ranks``'
    heads: (g (B, S, d_inner / ranks) fp32, the final state, the pre-conv
    tail). With ``ranks`` > 1: ``p["in_proj"]`` whole (or ``proj``, the
    rank's z/x/B/C/dt columns of its product, already computed),
    ``initial_state`` the rank's heads."""
    B, S, _ = xin.shape
    ns, hp = cfg.ssm_state, cfg.ssm_headdim
    dr, hr = cfg.ssm_d_inner // ranks, cfg.ssm_nheads // ranks
    z, xbc, dt_raw = _rank_proj(cfg, p, xin, rank, ranks, proj)
    conv_tail = xbc[:, S - (cfg.ssm_conv - 1):]  # pre-conv tail -> decode conv state
    conv_w, conv_b, dt_bias, A_log, Dp = _rank_params(cfg, p, rank, ranks)
    xbc = _causal_conv(xbc, conv_w, conv_b)
    x, Bm, Cm = torch.split(xbc, [dr, ns, ns], dim=-1)
    dt = F.softplus(dt_raw.float() + dt_bias)  # (B,S,H)
    A = -torch.exp(A_log)  # (H,) negative
    xh = x.reshape(B, S, hr, hp)
    y, final_state = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                                  initial_state=initial_state)
    y = y + xh * Dp[:, None].float()
    y = y.reshape(B, S, dr)
    # gated RMSNorm (mamba2): norm(y * silu(z)); here the gate
    return y * F.silu(z.float()).to(y.dtype), final_state, conv_tail


def sum_squares(g: torch.Tensor) -> torch.Tensor:
    """The rank's share of the gated norm's sum of squares, (B, S, 1) fp32."""
    gf = g.float()
    return (gf * gf).sum(-1, keepdim=True)


def norm_out(cfg: ModelConfig, p: dict, g: torch.Tensor, sumsq: torch.Tensor, *,
             rank: int, ranks: int) -> torch.Tensor:
    """The gated RMSNorm of the rank's channels ``g``, ``sumsq`` the sum of
    squares over all of d_inner, then out_proj (``p["out_proj"]`` the
    rank's rows): the rank's partial sum of the block's output."""
    di, ct = cfg.ssm_d_inner, cdtype(cfg)
    dr = di // ranks
    y = (g.float() * torch.rsqrt(sumsq / di + cfg.rmsnorm_eps)
         * p["norm"][rank * dr:(rank + 1) * dr].float()).to(g.dtype)
    return y.to(ct) @ weight(p["out_proj"], ct)


def mamba_decode(
    cfg: ModelConfig,
    p: dict,
    xin: torch.Tensor,         # (B, 1, D)
    ssm_state: torch.Tensor,   # (B, H, P, N)
    conv_state: torch.Tensor,  # (B, W-1, conv_dim)
    *,
    rank: int = 0,
    ranks: int = 1,
    sum_ranks=None,
    proj=None,
):
    """One-token recurrent step; returns (out (B,1,D), ssm_state, conv_state),
    new tensors (the caller writes them into its cache). On rank ``rank`` of
    ``ranks``' share of the SSD heads (all of them when ``ranks`` is 1;
    plain tensors), as ``mixer``: ``ssm_state`` the rank's heads',
    ``conv_state`` its channels [x share, B, C], ``proj`` its z/x/B/C/dt
    columns of in_proj's product (or ``p["in_proj"]`` whole), ``sum_ranks``
    the gated norm's sum over the ranks, and the output the rank's partial
    sum of out_proj. A ``DTensor`` input (a cell on a mesh) runs each rank's
    share through ``distributed.local.mamba_decode``."""
    if is_dtensor(xin):
        from repro_torch.distributed import local
        return local.mamba_decode(cfg, p, xin, ssm_state, conv_state)
    B = xin.shape[0]
    ns, hp = cfg.ssm_state, cfg.ssm_headdim
    dr, hr = cfg.ssm_d_inner // ranks, cfg.ssm_nheads // ranks
    z, xbc, dt_raw = _rank_proj(cfg, p, xin[:, 0], rank, ranks, proj)
    # roll conv state, apply conv at last position
    full = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # (B, W, C)
    new_conv_state = full[:, 1:]
    conv_w, conv_b, dt_bias, A_log, Dp = _rank_params(cfg, p, rank, ranks)
    conv_out = torch.einsum("bwc,wc->bc", full.float(), conv_w.float())
    xbc = F.silu(conv_out + conv_b.float()).to(xbc.dtype)
    x, Bm, Cm = torch.split(xbc, [dr, ns, ns], dim=-1)
    dt = F.softplus(dt_raw.float() + dt_bias)  # (B,H)
    A = -torch.exp(A_log)
    xh = x.reshape(B, hr, hp)
    y, new_ssm = ssd_step_ref(ssm_state, xh, dt, A, Bm, Cm)
    y = y + xh * Dp[:, None].float()
    g = y.reshape(B, dr) * F.silu(z.float()).to(y.dtype)
    if ranks == 1:
        ct = cdtype(cfg)
        out = rms_norm(g, p["norm"], cfg.rmsnorm_eps).to(ct) @ weight(p["out_proj"], ct)
    else:
        out = norm_out(cfg, p, g, sum_ranks(sum_squares(g)), rank=rank, ranks=ranks)
    return out[:, None, :], new_ssm, new_conv_state
