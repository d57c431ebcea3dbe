"""Plain PyTorch pieces of the references: RMSNorm, rotary embedding,
causal attention, the chunked SSD scan, and the product in the reference's
precision. Everything is float32 with TF32 off, unless a lower-precision
control is asked for. Nothing here imports the program under test."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn with one scale for the whole tensor
    (its absolute maximum maps to 448), returned in float32."""
    t = t.float()
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Products:
    """The matrix products of a reference: float32 (``precision="fp32"``),
    or both operands rounded to fp8 first (``"fp8"``, the control: one
    precision below the bf16 the configurations serve in)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return fp8(a) @ fp8(b)
        return a.float() @ b.float()


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, Dh) at positions 0..S-1: the two
    halves of each head rotated by the angle position / theta^(i / half)."""
    S, Dh = x.shape[1], x.shape[-1]
    half = Dh // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh), keys up to the query's position) v, one
    batch row at a time; (B, S, H, Dh) in, (B, S, H, Dh) out, float32."""
    B, S, H, Dh = q.shape
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty(B, S, H, Dh, dtype=torch.float32, device=q.device)
    for b in range(B):
        qb, kb, vb = (t[b].float().transpose(0, 1) for t in (q, k, v))  # (H, S, Dh)
        s = (qb @ kb.transpose(1, 2)) / math.sqrt(Dh)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[b] = (p @ vb).transpose(0, 1)
    return out


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over time: x (B, S, C), w (W, C), the
    last tap on the current step; then SiLU."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, W - 1, 0))
    out = b.float().expand_as(x).clone()
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i].float()
    return F.silu(out)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = x[..., j+1] + ... + x[..., i] for i >= j, -inf above."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """The SSD recurrence state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_t^T,
    y_t = state_t C_t, from a zero state, computed in chunks as the Mamba2
    paper's minimal listing does (one group: B and C shared by the heads).
    x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N); y float32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    c = (S + pad) // chunk
    X = (x.float() * dt.float()[..., None]).reshape(Bsz, c, chunk, H, P)
    Adt = (dt.float() * A.float()).reshape(Bsz, c, chunk, H).permute(0, 3, 1, 2)  # b h c l
    Bc = Bm.float().reshape(Bsz, c, chunk, N)
    Cc = Cm.float().reshape(Bsz, c, chunk, N)
    A_cs = torch.cumsum(Adt, dim=-1)
    Lmat = torch.exp(_segsum(Adt))  # b h c l s
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * Lmat, X)
    decay = torch.exp(A_cs[..., -1:] - A_cs)  # b h c l
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(A_cs[..., -1], (1, 0))))  # b h c+1 c+1
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states, torch.exp(A_cs))
    return (y_diag + y_off).reshape(Bsz, c * chunk, H, P)[:, :S]
