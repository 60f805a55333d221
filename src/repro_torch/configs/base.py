"""Model configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``.  The config is a
*pure description*: models/registry.py turns it into init/apply functions, and
core/opgraph.py turns it into the PM2Lat op graph.  Block heterogeneity
(RG-LRU:local-attn 1:2, xLSTM mLSTM:sLSTM 7:1, vision cross-attn every 5th
layer) is expressed as a repeating ``block_pattern`` so the model stack can be
lowered as ``lax.scan`` over super-blocks (keeps HLO size O(1) in depth).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds understood by models/transformer.py
ATTN = "attn"              # global causal self-attention (GQA)
LOCAL_ATTN = "local_attn"  # sliding-window causal self-attention
CROSS_ATTN = "cross_attn"  # cross-attention to a stub modality context
RGLRU = "rglru"            # RG-LRU recurrent block (Griffin / RecurrentGemma)
MLSTM = "mlstm"            # xLSTM matrix-memory block
SLSTM = "slstm"            # xLSTM scalar-memory block
ENC_ATTN = "enc_attn"      # bidirectional encoder self-attention


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    @property
    def active_experts(self) -> int:
        return self.top_k + self.num_shared_experts


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). Frontend is a stub:
    input_specs() provides precomputed frame embeddings (n_frames, d_model)."""
    n_layers: int
    n_frames: int  # encoder sequence length after the (stubbed) conv frontend


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    block_pattern: Tuple[str, ...] = (ATTN,)   # repeated/truncated to n_layers
    mlp_act: str = "silu"            # silu | gelu | geglu (geglu/silu are gated)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sliding_window: int = 4096       # for local_attn blocks
    moe: Optional[MoEConfig] = None
    encoder: Optional[EncoderConfig] = None
    cross_attn_context_len: int = 0  # stub modality context length (vlm)
    # recurrent-block hyperparams
    rglru_conv_width: int = 4
    lru_dim: Optional[int] = None    # RG-LRU recurrence width (default d_model)
    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # source provenance, e.g. "[arXiv:2403.08295; hf]"
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, (self.n_heads, self.n_kv_heads)

    # ----- derived -----
    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, pattern repeated to n_layers."""
        pat = self.block_pattern
        reps = (self.n_layers + len(pat) - 1) // len(pat)
        return (pat * reps)[: self.n_layers]

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder is not None

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Total parameter count (analytic, matches models/ init)."""
        d, h, kv, hd, ff, v = (self.d_model, self.n_heads, self.n_kv_heads,
                               self.head_dim, self.d_ff, self.vocab_size)
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # unembed
        total += d  # final norm

        def attn_params(bias: bool) -> int:
            p = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            if bias:
                p += h * hd + 2 * kv * hd
            return p

        def mlp_params(dff: int) -> int:
            gated = self.mlp_act in ("silu", "geglu")
            return (3 if gated else 2) * d * dff

        for kind in self.layer_kinds:
            total += 2 * d  # two pre-norms (approximation for recurrent blocks too)
            if kind in (ATTN, LOCAL_ATTN, ENC_ATTN):
                total += attn_params(self.qkv_bias)
            elif kind == CROSS_ATTN:
                total += attn_params(False) + attn_params(self.qkv_bias)  # self + cross
            elif kind == RGLRU:
                dl = self.lru_dim or d
                total += 2 * d * dl + dl * d + self.rglru_conv_width * dl + 2 * dl * dl + 2 * dl
            elif kind == MLSTM:
                dm = 2 * d  # up-projected inner dim (expansion factor 2)
                total += d * 2 * dm + dm * d + 3 * dm * self.head_dim * h + dm
            elif kind == SLSTM:
                total += 4 * d * d + 4 * d * d + 4 * d  # recurrent + input gates + biases
                total += d * (4 * d) // 3 * 2            # post up/down proj (~4/3)
            if kind in (ATTN, LOCAL_ATTN, CROSS_ATTN, ENC_ATTN) or kind in (RGLRU,):
                if self.d_ff > 0:
                    if self.moe is not None:
                        m = self.moe
                        total += d * m.num_experts  # router
                        total += m.num_experts * mlp_params(m.d_ff_expert) // 1
                        total += m.num_shared_experts * mlp_params(m.d_ff_expert)
                    else:
                        total += mlp_params(ff)
        if self.encoder is not None:
            for _ in range(self.encoder.n_layers):
                total += 2 * d + attn_params(False) + mlp_params(ff)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        gated = self.mlp_act in ("silu", "geglu")
        per_expert = (3 if gated else 2) * self.d_model * m.d_ff_expert
        n_moe_layers = sum(1 for k in self.layer_kinds
                           if k in (ATTN, LOCAL_ATTN, CROSS_ATTN, ENC_ATTN, RGLRU))
        inactive = (m.num_experts - m.top_k) * per_expert * n_moe_layers
        return self.param_count() - inactive
