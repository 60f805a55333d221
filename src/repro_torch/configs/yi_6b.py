"""yi-6b — llama-arch GQA [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    block_pattern=(ATTN,),
    mlp_act="silu",
    rope_theta=5000000.0,
    source="[arXiv:2403.04652; hf]",
)
