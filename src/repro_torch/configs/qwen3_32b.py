"""qwen3-32b — dense (64L, d=5120, 64H GQA kv=8, d_ff=25600, qk_norm).

Note head_dim=128 is explicit: 64 heads x 128 = 8192 != d_model (matches the
HF config's decoupled head_dim). [hf:Qwen/Qwen3-32B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    qkv_bias=False,  # qwen3 dropped QKV bias in favour of qk_norm
    rope_theta=1_000_000.0,
    subquadratic=False,
    source="hf:Qwen/Qwen3-32B",
)
