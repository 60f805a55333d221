"""llama-3.2-vision-11b — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.  Every 5th layer is a
cross-attention layer attending to (stubbed) precomputed image patch
embeddings; the vision tower itself is out of scope per the assignment.
"""
from repro_torch.configs.base import ATTN, CROSS_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=(ATTN, ATTN, ATTN, ATTN, CROSS_ATTN),
    mlp_act="silu",
    rope_theta=500000.0,
    cross_attn_context_len=1601,  # 1 tile x (40x40 patches + 1 cls)
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)
