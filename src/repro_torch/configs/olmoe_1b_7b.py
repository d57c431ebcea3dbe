"""olmoe-1b-7b — MoE (16L, d=2048, 16H MHA, 64 experts top-8, d_ff=1024/expert).

Every layer is MoE (moe_every=1); 1B active / 7B total. [arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MHA
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    moe_every=1,
    expert_d_ff=1024,
    qk_norm=True,  # OLMoE uses QK-norm
    rope_theta=10_000.0,
    subquadratic=False,
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
)
