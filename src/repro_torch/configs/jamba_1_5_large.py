"""jamba-1.5-large-398b — hybrid Mamba+attention (72L, d=8192, 64H kv=8).

Jamba period: 8 layers = 1 attention + 7 mamba (attn_every=8), MoE (16
experts, top-2) on every 2nd layer (moe_every=2). KV cache exists only on the
9 attention layers, so long-context decode is sub-quadratic in memory and
compute -> long_500k RUNS. [arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    expert_d_ff=24576,
    attn_every=8,  # 1 attn : 7 mamba
    ssm_state=128,
    ssm_headdim=128,  # d_inner = 16384 -> 128 SSD heads
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    subquadratic=True,  # hybrid -> long_500k runs
    source="arXiv:2403.19887; hf:ai21labs/AI21-Jamba-1.5-Large",
)
