"""qwen2-vl-72b — VLM backbone (80L, d=8192, 64H GQA kv=8, d_ff=29568).

M-RoPE (3-section rotary over temporal/height/width position ids), dynamic
resolution handled by the (stubbed) vision frontend: ``input_specs`` feeds
token ids plus precomputed M-RoPE position ids ``(3, B, S)``. The backbone is
a standard pre-norm GQA transformer. [arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,  # qwen2 family uses QKV bias
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # halves of head_dim: t/h/w
    tie_embeddings=False,
    subquadratic=False,  # full attention -> long_500k skipped
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B-Instruct",
)
