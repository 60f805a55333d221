"""recurrentgemma-2b — RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680 vocab=256000.  Griffin
pattern: (recurrent, recurrent, local-attention) repeated; window 2048.
"""
from repro_torch.configs.base import LOCAL_ATTN, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    mlp_act="geglu",
    sliding_window=2048,
    lru_dim=2560,
    tie_embeddings=True,
    source="[arXiv:2402.19427; hf]",
)
