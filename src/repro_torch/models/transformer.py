"""Decoder stack: the dense ``ATTN`` forward pass over a full sequence.

The JAX package stacks per-period parameters and runs them under
``lax.scan``; PyTorch runs eagerly, so here the layers are a plain
``ModuleList`` walked by a Python loop (layer ``i`` is the JAX package's
period ``i // len(block_pattern)``, sub-block ``i % len(block_pattern)``).
Other block kinds, MoE and encoders raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import base as C
from repro_torch.models import attention as A
from repro_torch.models import layers as L

_LATER = {C.LOCAL_ATTN: "the sliding-window and hybrid models",
          C.CROSS_ATTN: "the vision model", C.ENC_ATTN: "the audio model",
          C.RGLRU: "the recurrent models", C.MLSTM: "the recurrent models",
          C.SLSTM: "the recurrent models"}


def check_supported(cfg: C.ModelConfig):
    for kind in set(cfg.layer_kinds):
        if kind != C.ATTN:
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} blocks are ported with the slice for "
                f"{_LATER.get(kind, 'their model kind')}")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE FFNs are ported with the "
                                  f"MoE slice")
    if cfg.encoder is not None:
        raise NotImplementedError(f"{cfg.name}: encoders are ported with the "
                                  f"audio model's slice")


class Block(nn.Module):
    """Pre-norm attention + (optional) gated MLP, each with a residual."""

    def __init__(self, cfg: C.ModelConfig, *, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device)
        self.attn = A.Attention(cfg, device=device)
        if cfg.d_ff > 0:
            self.ln2 = L.RMSNorm(cfg.d_model, device=device)
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, device=device)
        else:
            self.ln2 = self.mlp = None

    def reset(self, gen: torch.Generator):
        self.attn.reset(gen)
        if self.mlp is not None:
            self.mlp.reset(gen)

    def forward(self, x, cfg: C.ModelConfig, cdt, rope=None):
        x = x + self.attn(self.ln1(x, cfg.norm_eps), causal=True,
                          compute_dtype=cdt, rope=rope)
        if self.mlp is not None:
            x = x + self.mlp(self.ln2(x, cfg.norm_eps), cdt)
        return x


class Transformer(nn.Module):
    """tokens (B, S) -> logits (B, S, padded_vocab) in the compute dtype.

    Built through ``models.registry.build`` (seeded weights) or
    ``models.convert.from_jax_params``; both resolve ``device`` first, so it
    has no default here."""

    def __init__(self, cfg: C.ModelConfig, *, device: torch.device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = L.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.final_norm = L.RMSNorm(cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = L.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        else:
            self.unembed = None
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.n_layers))

    def reset(self, gen: torch.Generator):
        """Random weights in the JAX package's distributions (normal /
        sqrt(fan_in), embeddings / sqrt(d), zero biases, unit norms)."""
        self.embed.reset(gen)
        if self.unembed is not None:
            self.unembed.reset(gen)
        for blk in self.blocks:
            blk.reset(gen)

    def cast_weights_(self, dtype: torch.dtype) -> "Transformer":
        """Store matmul and embedding weights (and biases) in ``dtype`` once,
        in place, instead of casting them on every call; norm scales stay
        f32.  The values are those the per-call cast produces."""
        for mod in self.modules():
            if isinstance(mod, (L.Linear, L.Embedding)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(dtype)
        return self

    @property
    def padded_vocab(self) -> int:
        return L.pad_vocab(self.cfg.vocab_size)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.is_cuda and torch.is_grad_enabled():
            raise RuntimeError("the forward pass takes no gradients on the "
                               "card in this slice (the flash backward kernel "
                               "comes with the training slice); run it under "
                               "torch.no_grad()")
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        x = self.embed(tokens, cdt)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        rope = A.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        for blk in self.blocks:
            x = blk(x, cfg, cdt, rope)
        x = self.final_norm(x, cfg.norm_eps)
        head = self.unembed if self.unembed is not None else self.embed
        return head.unembed(x, cdt)
