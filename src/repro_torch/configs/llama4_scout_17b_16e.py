"""llama4-scout-17b-a16e — MoE, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1
plus one shared expert (Llama-4 style).
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    block_pattern=(ATTN,),
    mlp_act="silu",
    rope_theta=500000.0,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192, num_shared_experts=1),
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
