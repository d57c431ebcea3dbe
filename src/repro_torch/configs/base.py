"""Model configuration system.

Every assigned architecture is expressed as a ``ModelConfig``. Layer stacks
are described as *periods*: the smallest repeating pattern of sublayers
(mixer + ffn choices). Homogeneous models have period length 1; jamba has
period length 8 (1 attention + 7 mamba, MoE on every 2nd layer); llama4 has
period length 2 (dense / MoE alternation). The model code scans over periods
so the HLO stays compact regardless of depth.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sublayer descriptors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SublayerSpec:
    """One sublayer inside a period."""

    mixer: str  # 'attn' | 'mamba'
    ffn: str  # 'dense' | 'moe' | 'none'


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    # core dims
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, ...] = ()  # vlm M-RoPE (t, h, w) half-dim split
    causal: bool = True
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # MoE ffn on layers where (i % moe_every == moe_every-1)
    moe_shared_expert: bool = False
    expert_d_ff: int = 0  # 0 -> d_ff
    moe_capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0  # hybrid: attn mixer on layers where (i % attn_every == 0)
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_causal: bool = False
    # norm / embeddings
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # training-time layout knobs (hillclimbed per arch; see EXPERIMENTS.md §Perf)
    remat_policy: str = "nothing_saveable"  # 'none'|'nothing_saveable'|'dots_saveable'
    # sub-quadratic? (controls long_500k applicability)
    subquadratic: bool = False
    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            f"{self.name}: num_heads {self.num_heads} not divisible by "
            f"kv heads {self.num_kv_heads}"
        )

    # ------------------------------------------------------------------
    # Period structure
    # ------------------------------------------------------------------
    @property
    def period_len(self) -> int:
        p = 1
        if self.attn_every > 1:
            p = math.lcm(p, self.attn_every)
        if self.num_experts and self.moe_every > 1:
            p = math.lcm(p, self.moe_every)
        return p

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.period_len == 0, (
            f"{self.name}: num_layers {self.num_layers} not divisible by "
            f"period {self.period_len}"
        )
        return self.num_layers // self.period_len

    def period_spec(self) -> Tuple[SublayerSpec, ...]:
        """The repeating sublayer pattern."""
        out = []
        for i in range(self.period_len):
            if self.family == "ssm":
                mixer = "mamba"
            elif self.attn_every > 1:
                mixer = "attn" if i % self.attn_every == 0 else "mamba"
            else:
                mixer = "attn"
            if self.family == "ssm":
                ffn = "none"  # mamba2-780m is a pure SSM stack (d_ff = 0)
            elif self.num_experts:
                ffn = "moe" if i % self.moe_every == self.moe_every - 1 else "dense"
            else:
                ffn = "dense"
            out.append(SublayerSpec(mixer=mixer, ffn=ffn))
        return tuple(out)

    @property
    def num_attn_layers(self) -> int:
        return sum(1 for s in self.period_spec() if s.mixer == "attn") * self.num_periods

    @property
    def num_mamba_layers(self) -> int:
        return sum(1 for s in self.period_spec() if s.mixer == "mamba") * self.num_periods

    # ------------------------------------------------------------------
    # Derived SSM dims
    # ------------------------------------------------------------------
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def ssm_conv_dim(self) -> int:
        # conv runs over [x, B, C] (ngroups = 1)
        return self.ssm_d_inner + 2 * self.ssm_state

    @property
    def moe_d_ff(self) -> int:
        return self.expert_d_ff or self.d_ff

    # ------------------------------------------------------------------
    # Parameter counting (analytic; used for roofline MODEL_FLOPS and the
    # serverless memory daemon's read-only size accounting)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        d, dh = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        counts = {"embed": self.vocab_size * d}
        if not self.tie_embeddings:
            counts["lm_head"] = d * self.vocab_size
        attn = d * nq * dh + 2 * d * nkv * dh + nq * dh * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * dh
        dense_ffn = 3 * d * self.d_ff  # SwiGLU: gate, up, down
        moe_ffn = 0
        if self.num_experts:
            moe_ffn = self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
            if self.moe_shared_expert:
                moe_ffn += 3 * d * self.moe_d_ff
        di, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_nheads
        mamba = (
            d * (2 * di + 2 * ns + nh)  # in_proj -> z,x,B,C,dt
            + self.ssm_conv * self.ssm_conv_dim  # conv1d
            + nh * 2  # A_log, D
            + nh  # dt_bias
            + di  # gated norm
            + di * d  # out_proj
        )
        n_attn, n_mamba = 0, 0
        n_dense_ffn, n_moe_ffn = 0, 0
        for s in self.period_spec():
            if s.mixer == "attn":
                n_attn += 1
            else:
                n_mamba += 1
            if s.ffn == "dense":
                n_dense_ffn += 1
            elif s.ffn == "moe":
                n_moe_ffn += 1
        P = self.num_periods
        counts["attn"] = P * n_attn * attn
        counts["mamba"] = P * n_mamba * mamba
        counts["dense_ffn"] = P * n_dense_ffn * dense_ffn
        counts["moe_ffn"] = P * n_moe_ffn * moe_ffn
        counts["norms"] = self.num_layers * 2 * d + d
        if self.is_encoder_decoder:
            # encoder stack (self-attn MHA + dense ffn) + decoder cross-attn
            enc = self.encoder_layers * (attn + dense_ffn + 2 * d)
            cross = self.num_layers * (attn + d)  # cross-attn per decoder layer
            counts["encoder"] = enc
            counts["cross_attn"] = cross
        return counts

    def param_count(self) -> int:
        return sum(self.param_counts().values())

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.num_experts:
            return self.param_count()
        c = self.param_counts()
        total = sum(v for k, v in c.items() if k != "moe_ffn")
        n_moe_ffn = sum(1 for s in self.period_spec() if s.ffn == "moe") * self.num_periods
        active_moe = n_moe_ffn * (
            self.experts_per_token * 3 * self.d_model * self.moe_d_ff
            + self.d_model * self.num_experts
            + (3 * self.d_model * self.moe_d_ff if self.moe_shared_expert else 0)
        )
        return total + active_moe

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=self.period_len * 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            param_dtype="float32",
            compute_dtype="float32",
            name=self.name + "-smoke",
        )
        if self.num_experts:
            small.update(num_experts=4, experts_per_token=min(self.experts_per_token, 2), expert_d_ff=64)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
        if self.mrope_sections:
            small.update(mrope_sections=(2, 3, 3))
        if self.is_encoder_decoder:
            small.update(encoder_layers=2)
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Shape suite (assigned input shapes; identical across LM archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, per the assignment rules."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; pure full-attention arch"
    return True, ""
