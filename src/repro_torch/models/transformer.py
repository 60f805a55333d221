"""Decoder stack: the dense ``ATTN`` model in the JAX package's three
modes, ``forward`` over a full sequence, ``prefill`` (forward, KV caches
and last-token logits) and ``decode_step`` (one token against the caches).

The JAX package stacks per-period parameters and runs them under
``lax.scan``; PyTorch runs eagerly, so here the layers are a plain
``ModuleList`` walked by a Python loop (layer ``i`` is the JAX package's
period ``i // len(block_pattern)``, sub-block ``i % len(block_pattern)``).
Other block kinds, MoE and encoders raise ``NotImplementedError``.

``decode_step`` updates its ``KVCache`` in place (the JAX step returns a
new cache; XLA donates the old one's buffers) and reads the position from
a device tensor, so the step can be captured once as a CUDA graph and
replayed (``serving/engine.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List

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
        """Returns (x, (k, v)), the attention's post-RoPE k and v for the
        cache."""
        y, kv = self.attn(self.ln1(x, cfg.norm_eps), causal=True,
                          compute_dtype=cdt, rope=rope)
        return self._ffn(x + y, cfg, cdt), kv

    def decode(self, x, k_cache, v_cache, pos, slot_positions,
               cfg: C.ModelConfig, cdt, rope):
        """One token (the ATTN branch of ``apply_block_decode``)."""
        x = x + self.attn.decode(self.ln1(x, cfg.norm_eps), k_cache, v_cache,
                                 pos, slot_positions, compute_dtype=cdt,
                                 rope=rope)
        return self._ffn(x, cfg, cdt)

    def _ffn(self, x, cfg: C.ModelConfig, cdt):
        if self.mlp is not None:
            x = x + self.mlp(self.ln2(x, cfg.norm_eps), cdt)
        return x


@dataclasses.dataclass
class KVCache:
    """Decode state of the whole stack: per layer a K and a V tensor
    (B, Hkv, W, hd), and ``pos``, the slot the next token is written to, as
    a one-element int64 tensor on the caches' device."""
    k: List[torch.Tensor]
    v: List[torch.Tensor]
    pos: torch.Tensor

    @property
    def batch(self) -> int:
        return self.k[0].shape[0]

    @property
    def capacity(self) -> int:
        return self.k[0].shape[2]

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.k + self.v)

    def copy_(self, other: "KVCache") -> "KVCache":
        """Take ``other``'s contents into these tensors (same shapes)."""
        for dst, src in zip(self.k + self.v + [self.pos],
                            other.k + other.v + [other.pos]):
            dst.copy_(src)
        return self

    def clone(self) -> "KVCache":
        return KVCache([t.clone() for t in self.k],
                       [t.clone() for t in self.v], self.pos.clone())


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

    def make_ctx(self, batch: int):
        """The stub modality context of the JAX package's ``Model.make_ctx``:
        None, since every model the port builds is ATTN-only
        (``check_supported``)."""
        return None

    def _head(self):
        return self.unembed if self.unembed is not None else self.embed

    @staticmethod
    def _no_grad_on_card(tokens):
        if tokens.is_cuda and torch.is_grad_enabled():
            raise RuntimeError("the model takes no gradients on the card in "
                               "this slice (the flash backward kernel comes "
                               "with the training slice); run it under "
                               "torch.no_grad()")

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        self._no_grad_on_card(tokens)
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        x = self.embed(tokens, cdt)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        rope = A.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        for blk in self.blocks:
            x, _ = blk(x, cfg, cdt, rope)
        x = self.final_norm(x, cfg.norm_eps)
        return self._head().unembed(x, cdt)

    def prefill(self, tokens: torch.Tensor, *, max_len: int = None):
        """tokens (B, S) -> (last-token logits (B, Vp), KVCache).  The caches
        hold the prompt's post-RoPE K/V in the compute dtype, zero-padded to
        the decode capacity ``max_len`` (default S + 64; never below S), and
        ``pos`` = S.  Only the last position is normed and unembedded.  No
        context embedding: the port builds ATTN-only models."""
        self._no_grad_on_card(tokens)
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        B, S = tokens.shape
        W = max(max_len or S + 64, S)
        x = self.embed(tokens, cdt)
        positions = torch.arange(S, device=tokens.device)[None, :]
        rope = A.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        ks, vs = [], []
        for blk in self.blocks:
            x, (k, v) = blk(x, cfg, cdt, rope)
            kc, vc = A.init_kv_cache(cfg, B, W, dtype=k.dtype,
                                     device=tokens.device)
            kc[:, :, :S] = k.transpose(1, 2)
            vc[:, :, :S] = v.transpose(1, 2)
            ks.append(kc)
            vs.append(vc)
        x = self.final_norm(x[:, -1:], cfg.norm_eps)
        logits = self._head().unembed(x, cdt)[:, 0]
        pos = torch.full((1,), S, dtype=torch.int64, device=tokens.device)
        return logits, KVCache(ks, vs, pos)

    def decode_step(self, token: torch.Tensor, cache: KVCache):
        """token (B,) int -> (logits (B, Vp), cache): writes the token's K/V
        at slot ``cache.pos`` of every layer, attends over all W slots (those
        past ``pos`` masked), and advances ``pos``, all in place and on the
        device (no host read of ``pos``: the step is graph-capturable).  The
        caller keeps ``pos`` < W."""
        self._no_grad_on_card(token)
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        pos = cache.pos
        x = self.embed(token[:, None], cdt)
        rope = A.rope_tables(pos.view(1, 1), cfg.head_dim, cfg.rope_theta)
        slots = torch.arange(cache.capacity, device=pos.device)
        for blk, kc, vc in zip(self.blocks, cache.k, cache.v):
            x = blk.decode(x, kc, vc, pos, slots, cfg, cdt, rope)
        pos.add_(1)
        x = self.final_norm(x, cfg.norm_eps)
        return self._head().unembed(x, cdt)[:, 0], cache

    def init_cache(self, batch: int, seq_len: int, *, pos: int = None,
                   dtype=torch.bfloat16) -> KVCache:
        """Zeroed caches of capacity ``seq_len`` on the model's device,
        positioned at ``pos`` (default seq_len - 1: 'a KV cache of
        seq_len')."""
        dev = self.embed.w.device
        ks, vs = zip(*(A.init_kv_cache(self.cfg, batch, seq_len, dtype=dtype,
                                       device=dev)
                       for _ in range(self.cfg.n_layers)))
        p = seq_len - 1 if pos is None else pos
        return KVCache(list(ks), list(vs),
                       torch.full((1,), p, dtype=torch.int64, device=dev))
