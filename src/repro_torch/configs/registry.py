"""Architecture registry: canonical ids -> ModelConfig, plus reduced configs.

``get(name)`` returns the FULL assigned config (never allocated outside the
dry-run).  ``reduced(name)`` returns a small same-family config for CPU smoke
tests and for the paper-reproduction benchmarks (profile + predict + measure).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (gemma_7b, llama4_scout_17b_16e, llama32_vision_11b,
                           moonshot_v1_16b_a3b, qwen2_0_5b, recurrentgemma_2b,
                           starcoder2_15b, whisper_small, xlstm_1_3b, yi_6b)
from repro_torch.configs.base import EncoderConfig, ModelConfig, MoEConfig

_MODULES = (xlstm_1_3b, llama4_scout_17b_16e, moonshot_v1_16b_a3b, gemma_7b,
            qwen2_0_5b, starcoder2_15b, yi_6b, whisper_small,
            recurrentgemma_2b, llama32_vision_11b)

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_NAMES = tuple(ARCHS)


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(name: str, *, n_layers: int | None = None) -> ModelConfig:
    """Shrink a full config to a CPU-runnable config of the same family.

    Keeps the block pattern, activation, GQA ratio, bias/tie settings; shrinks
    width, depth, vocab, experts.  Depth default: one full block-pattern
    period (so every block kind is exercised).
    """
    cfg = get(name)
    period = len(cfg.block_pattern)
    depth = n_layers if n_layers is not None else max(period, 2)
    ratio = cfg.q_per_kv
    n_heads = min(cfg.n_heads, 4 * ratio)
    n_heads = max(ratio, (n_heads // ratio) * ratio)
    head_dim = 16
    d_model = n_heads * head_dim
    moe = None
    if cfg.moe is not None:
        E = min(8, cfg.moe.num_experts)
        top_k = min(cfg.moe.top_k, 2)
        # capacity >= tokens-per-group: no token dropping in reduced configs,
        # so decode == forward exactly (full configs keep the realistic 1.25)
        moe = MoEConfig(num_experts=E, top_k=top_k, d_ff_expert=32,
                        num_shared_experts=min(cfg.moe.num_shared_experts, 1),
                        capacity_factor=float(E) / top_k + 1.0)
    enc = None
    if cfg.encoder is not None:
        enc = EncoderConfig(n_layers=2, n_frames=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=depth,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads // ratio,
        head_dim=head_dim,
        d_ff=0 if cfg.d_ff == 0 else 4 * d_model,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 64),
        lru_dim=d_model if cfg.lru_dim else None,
        moe=moe,
        encoder=enc,
        cross_attn_context_len=min(cfg.cross_attn_context_len, 16),
    )


# ---------------------------------------------------------------------------
# Paper-evaluation models (Table III/IV/V): reduced-width stand-ins with the
# real models' structural proportions, runnable on this host so we can
# profile-predict-measure like the paper does on its five GPUs.
# ---------------------------------------------------------------------------

def _paper_model(name, n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab,
                 act="gelu", bias=False):
    return ModelConfig(name=name, family="dense", n_layers=n_layers,
                       d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
                       d_ff=d_ff, vocab_size=vocab, mlp_act=act, qkv_bias=bias)

PAPER_MODELS = {
    # structural miniatures of the paper's Table III models
    "gpt2-mini": _paper_model("gpt2-mini", 6, 256, 4, 4, 1024, 1024, act="gelu"),
    "flan-t5-mini": _paper_model("flan-t5-mini", 4, 192, 3, 3, 768, 1024, act="gelu"),
    "qwen3-mini": _paper_model("qwen3-mini", 6, 256, 8, 4, 768, 2048, act="silu"),
    "deepseek-r1-mini": _paper_model("deepseek-r1-mini", 8, 320, 5, 5, 1280, 2048, act="silu"),
}


def get_any(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    if name.endswith("-reduced") and name[: -len("-reduced")] in ARCHS:
        return reduced(name[: -len("-reduced")])
    raise KeyError(name)
