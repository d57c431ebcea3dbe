"""qwen3-8b — dense (36L, d=4096, 32H GQA kv=8, d_ff=12288, qk_norm).

[hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1_000_000.0,
    subquadratic=False,
    source="hf:Qwen/Qwen3-8B",
)
