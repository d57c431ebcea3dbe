"""qwen2.5-3b — dense (36L, d=2048, 16H GQA kv=2, d_ff=11008, QKV bias).

[hf:Qwen/Qwen2.5-3B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,  # qwen2.5 <7B ties embeddings
    subquadratic=False,
    source="hf:Qwen/Qwen2.5-3B",
)
