"""mamba2-780m — pure SSM (48L, d=1536, attn-free, SSD state=128).

State-space duality (SSD): chunked quadratic-intra / recurrent-inter scan for
train+prefill, O(1) recurrent state update for decode. No MLP (d_ff=0), no
attention — the long_500k shape RUNS for this arch. [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,  # unused (attn-free); kept for dataclass invariants
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,   # d_inner = 2*1536 = 3072 -> 48 SSD heads
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,  # mamba2 ties embeddings
    subquadratic=True,  # SSD -> long_500k runs
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m",
)
