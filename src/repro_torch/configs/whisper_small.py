"""whisper-small — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.  The decoder interleaves
self-attention and cross-attention to the encoder output; the conv frontend is
a STUB: input_specs() provides precomputed frame embeddings (1500, d_model).
"""
from repro_torch.configs.base import ATTN, CROSS_ATTN, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    block_pattern=(CROSS_ATTN,),  # decoder block = self-attn + cross-attn + FFN
    mlp_act="gelu",
    rope_theta=10000.0,
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
    cross_attn_context_len=1500,
    source="[arXiv:2212.04356; unverified]",
)
