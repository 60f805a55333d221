"""starcoder2-15b — GQA, RoPE [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    block_pattern=(ATTN,),
    mlp_act="gelu",
    qkv_bias=True,
    rope_theta=100000.0,
    source="[arXiv:2402.19173; hf]",
)
