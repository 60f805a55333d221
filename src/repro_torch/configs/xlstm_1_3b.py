"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.  xLSTM[7:1]: one sLSTM
block per 7 mLSTM blocks; d_ff=0 means the blocks carry their own up/down
projections (no separate FFN).
"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(MLSTM,) * 7 + (SLSTM,),
    mlp_act="gelu",
    source="[arXiv:2405.04517; unverified]",
)
