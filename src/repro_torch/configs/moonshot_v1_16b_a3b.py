"""moonshot-v1-16b-a3b — kimi/moonlight, 64e top-6 [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64 experts top-6
with 2 shared experts (DeepSeek-V3-style fine-grained experts).
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    head_dim=128,
    block_pattern=(ATTN,),
    mlp_act="silu",
    rope_theta=50000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared_experts=2),
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
)
