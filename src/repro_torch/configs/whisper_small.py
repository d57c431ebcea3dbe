"""whisper-small — encoder-decoder audio (12L enc + 12L dec, d=768, 12H MHA).

The conv mel frontend is a STUB per the assignment: ``input_specs`` provides
precomputed frame embeddings ``(B, S_enc, d)`` (post-conv, stride-2, so
S_enc = seq_len // 2). Decoder: causal self-attn + cross-attn with KV cache
-> decode shapes RUN; full attention -> long_500k SKIPPED.
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,  # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,  # MHA
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=12,
    rope_theta=10_000.0,  # we use RoPE in place of learned abs pos (noted in DESIGN.md)
    causal=True,
    subquadratic=False,
    source="arXiv:2212.04356; hf:openai/whisper-small",
)
