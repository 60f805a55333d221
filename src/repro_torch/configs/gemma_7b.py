"""gemma-7b — GeGLU, head_dim=256 [arXiv:2403.08295; hf].

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    block_pattern=(ATTN,),
    mlp_act="geglu",
    tie_embeddings=True,
    source="[arXiv:2403.08295; hf]",
)
