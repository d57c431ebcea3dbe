"""llama4-maverick-400b-a17b — MoE (48L, d=5120, 40H GQA kv=8, 128e top-1).

Maverick alternates dense and MoE FFN layers (interleave step 2) and adds a
shared expert alongside the single routed expert — that is what makes 400B
total / 17B active parameters with top-1 routing. Early-fusion multimodality
is out of scope for the LM backbone (text path only). [hf; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_every=2,  # MoE on every 2nd layer (interleave_moe_layer_step=2)
    moe_shared_expert=True,
    expert_d_ff=8192,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    subquadratic=False,
    source="hf:meta-llama/Llama-4-Maverick-17B-128E; unverified",
)
