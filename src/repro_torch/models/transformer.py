"""Decoder stack: the dense ``ATTN`` models, the hybrid ones (``RGLRU``
and sliding-window ``LOCAL_ATTN`` blocks, recurrentgemma-2b), the xLSTM
ones (``MLSTM`` and ``SLSTM`` blocks, xlstm-1.3b) and the
encoder–decoder ones (``CROSS_ATTN`` blocks over a context: whisper-small,
whose context is its encoder's output over stub frame embeddings, and
llama-3.2-vision, whose context is stub patch embeddings) in the JAX
package's three modes, ``forward`` over a full sequence, ``prefill``
(forward, decode caches and last-token logits) and ``decode_step`` (one
token against the caches).

The JAX package stacks per-period parameters and runs them under
``lax.scan``; PyTorch runs eagerly, so here the layers are a plain
``ModuleList`` walked by a Python loop (layer ``i`` is the JAX package's
period ``i // len(block_pattern)``, sub-block ``i % len(block_pattern)``,
of kind ``cfg.layer_kinds[i]``; the encoder's layer ``i`` is period ``i``
of ``encoder.blocks``).  A config with ``moe`` routes every decoder
block's FFN through capacity-dispatch experts (``models/moe.py``; the
forward returns logits only, ``moe_ffn`` gives the aux losses).  A
block kind outside ``PORTED`` raises ``NotImplementedError``.

``decode_step`` updates its ``KVCache`` in place (the JAX step returns a
new cache; XLA donates the old one's buffers) and reads the position from
a device tensor, so the step can be captured once as a CUDA graph and
replayed (``serving/engine.py``).

``train_forward`` is the training forward (the JAX package's ``forward``
with its aux losses, ``return_hidden`` and ``block_skip``, and per-block
``torch.utils.checkpoint`` where the JAX package remats its scan body).
Parameters require no gradient unless a caller turns them on
(``requires_grad_(True)``, as ``training.step.build_train_step`` does).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import base as C
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import flash_attention_bwd as fkb
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R

PORTED = (C.ATTN, C.LOCAL_ATTN, C.RGLRU, C.CROSS_ATTN, C.ENC_ATTN,
          C.MLSTM, C.SLSTM)
_ATTENTION = (C.ATTN, C.LOCAL_ATTN, C.CROSS_ATTN, C.ENC_ATTN)
_XLSTM = (C.MLSTM, C.SLSTM)
# the ``KVCache`` lists of a recurrent layer's state, in ``Block.forward``'s
# and ``KVCache.layer``'s order
_STATE_FIELDS = {C.RGLRU: ("h", "conv"), C.MLSTM: ("C", "n", "m", "conv"),
                 C.SLSTM: ("c", "n", "h", "m")}


def check_supported(cfg: C.ModelConfig):
    for kind in set(cfg.layer_kinds):
        if kind not in PORTED:
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} blocks have no port")


class Block(nn.Module):
    """Pre-norm mixer, global, sliding-window or encoder (non-causal, no
    RoPE) attention (``attn``) or the RG-LRU block (``rec``); in a
    ``CROSS_ATTN`` block then cross attention over the context (``ln_x``,
    ``xattn``); then the (optional) MLP, or under ``cfg.moe`` the MoE FFN
    (``moe``) outside the encoder; each with a residual (the JAX package's
    ``apply_block``).  An xLSTM block is ``ln1``, the mLSTM (``mlstm``) or
    sLSTM (``slstm_blk``) block and the residual: no ``ln2``, no FFN."""

    def __init__(self, cfg: C.ModelConfig, kind: str, *, device=None):
        super().__init__()
        self.kind = kind
        self.window = cfg.sliding_window if kind == C.LOCAL_ATTN else None
        self.causal = kind != C.ENC_ATTN
        self.ln1 = L.RMSNorm(cfg.d_model, device=device)
        self.ln2 = self.mlp = self.moe = None
        if kind == C.MLSTM:
            self.mlstm = R.MLSTMBlock(cfg, device=device)
            return
        if kind == C.SLSTM:
            self.slstm_blk = R.SLSTMBlock(cfg, device=device)
            return
        if kind == C.RGLRU:
            self.rec = R.RGLRUBlock(cfg, device=device)
        else:
            self.attn = A.Attention(cfg, device=device)
        if kind == C.CROSS_ATTN:
            self.ln_x = L.RMSNorm(cfg.d_model, device=device)
            self.xattn = A.Attention(cfg, cross=True, device=device)
        if cfg.d_ff > 0:
            self.ln2 = L.RMSNorm(cfg.d_model, device=device)
            if cfg.moe is not None and kind != C.ENC_ATTN:
                self.moe = M.MoE(cfg.d_model, cfg.moe, cfg.mlp_act,
                                 device=device)
            else:
                self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                 device=device)

    def _mixer(self):
        return {C.RGLRU: "rec", C.MLSTM: "mlstm",
                C.SLSTM: "slstm_blk"}.get(self.kind, "attn")

    def reset(self, gen: torch.Generator):
        getattr(self, self._mixer()).reset(gen)
        if self.kind == C.CROSS_ATTN:
            self.xattn.reset(gen)
        if self.mlp is not None:
            self.mlp.reset(gen)
        if self.moe is not None:
            self.moe.reset(gen)

    def forward(self, x, cfg: C.ModelConfig, cdt, rope=None, ctx=None):
        """Returns (x, state): the attention's post-RoPE (k, v), followed in
        a ``CROSS_ATTN`` block by the context's (k, v), or the RG-LRU's (h,
        conv), the mLSTM's (C, n, m, conv) or the sLSTM's (c, n, h, m)
        after the sequence, for the decode cache.  ``ctx``: the context (B,
        Lx, d) of a ``CROSS_ATTN`` block."""
        x, state, _ = self.forward_aux(x, cfg, cdt, rope, ctx)
        return x, state

    def forward_aux(self, x, cfg: C.ModelConfig, cdt, rope=None, ctx=None):
        """``forward``'s (x, state) and the MoE FFN's aux losses
        ({"lb_loss", "z_loss"}, or None for a block without MoE): the JAX
        package's ``apply_block``."""
        h = self.ln1(x, cfg.norm_eps)
        if self.kind in _XLSTM:
            y, state = getattr(self, self._mixer())(h, cdt)
            return sh.constrain_hidden(x + y), state, None
        if self.kind == C.RGLRU:
            y, state = self.rec(h, cdt)
        else:
            y, state = self.attn(h, causal=self.causal, window=self.window,
                                 compute_dtype=cdt,
                                 rope=rope if self.causal else False)
        x = x + y
        if self.kind == C.CROSS_ATTN:
            y, cross = self.xattn(self.ln_x(x, cfg.norm_eps), ctx,
                                  causal=False, compute_dtype=cdt)
            x, state = x + y, state + cross
        x, aux = self._ffn(sh.constrain_hidden(x), cfg, cdt)
        return x, state, aux

    def decode(self, x, state, pos, slots, cfg: C.ModelConfig, cdt, rope):
        """One token (``apply_block_decode``).  ``state``: this layer's
        (k, v) caches, and a ``CROSS_ATTN`` block's context (k, v) after
        them, or its recurrent state (``KVCache.layer``); ``slots``: (write
        slot, slot positions) of an attention layer's cache."""
        h = self.ln1(x, cfg.norm_eps)
        if self.kind in _XLSTM:
            return sh.constrain_hidden(
                x + getattr(self, self._mixer()).step(h, *state, cdt))
        if self.kind == C.RGLRU:
            y = self.rec.step(h, *state, cdt)
        else:
            y = self.attn.decode(h, *state[:2], pos, *slots,
                                 window=self.window, compute_dtype=cdt,
                                 rope=rope)
        x = x + y
        if self.kind == C.CROSS_ATTN:
            # on a mesh whose 'model' extent does not divide the heads, the
            # attention's output projection leaves x a partial sum over
            # 'model', which the norm cannot take in place: reduce it first
            x = sh.constrain_hidden(x)
            x = x + self.xattn.decode_cross(self.ln_x(x, cfg.norm_eps),
                                            *state[2:], compute_dtype=cdt)
        return self._ffn(sh.constrain_hidden(x), cfg, cdt)[0]

    def _ffn(self, x, cfg: C.ModelConfig, cdt):
        """(x, aux): the MoE's aux losses, None without MoE."""
        aux = None
        if self.mlp is not None:
            x = x + self.mlp(self.ln2(x, cfg.norm_eps), cdt)
        elif self.moe is not None:
            y, aux = self.moe(self.ln2(x, cfg.norm_eps), cfg.moe,
                              cfg.mlp_act, cdt)
            x = x + y
        return sh.constrain_hidden(x), aux


def _train_block(blk: Block, x, cfg: C.ModelConfig, cdt, rope, ctx):
    """One block of ``Transformer.train_forward``: (x, lb_loss, z_loss),
    tensors only, so that ``checkpoint`` can run it again."""
    x, _, aux = blk.forward_aux(x, cfg, cdt, rope, ctx)
    if aux is None:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, zero, zero
    return x, aux["lb_loss"], aux["z_loss"]


def cast_weights_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store ``module``'s matmul and embedding weights (and biases) and its
    MoE experts in ``dtype`` once, in place, instead of casting them on
    every call; norm scales, the recurrent blocks' conv taps and Λ, and
    the weights used in f32 (``keep_f32``: the RG-LRU's gates, the mLSTM's
    ``w_if``, the sLSTM's ``wx`` and ``rh``, the MoE router) stay f32.
    The values are those the per-call cast produces."""
    for mod in module.modules():
        if (isinstance(mod, (L.Linear, L.Embedding, M.Experts))
                and not getattr(mod, "keep_f32", False)):
            for p in mod.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return module


@dataclasses.dataclass
class KVCache:
    """Decode state of the whole stack, per layer: an attention layer's K
    and V (B, Hkv, W, hd), W = ``capacity`` for global attention and a
    ring of min(window, capacity) slots for sliding-window attention; an
    RG-LRU layer's h (B, dl) f32 and conv window (B, width - 1, dl); a
    ``CROSS_ATTN`` layer's context K and V besides (``xk``, ``xv``: (B,
    Hkv, Lx, hd), written at the prefill, read by every step); an mLSTM
    layer's matrix memory C (B, H, hd, hd), normaliser n (B, H, hd) and
    stabiliser m (B, H), all f32, and its conv window (B, width - 1, di);
    an sLSTM layer's c, n, h and m, each (B, d) f32.  The lists hold None
    where a layer has no such tensor (``n`` and ``m`` serve both xLSTM
    kinds).  ``pos``, the position of the next token, is a one-element
    int64 tensor on the caches' device; ``capacity``, the positions a
    decode may reach, is fixed when the cache is made."""
    k: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]
    h: List[Optional[torch.Tensor]]
    conv: List[Optional[torch.Tensor]]
    xk: List[Optional[torch.Tensor]]
    xv: List[Optional[torch.Tensor]]
    C: List[Optional[torch.Tensor]]
    c: List[Optional[torch.Tensor]]
    n: List[Optional[torch.Tensor]]
    m: List[Optional[torch.Tensor]]
    pos: torch.Tensor
    capacity: int

    def _lists(self):
        return (self.k, self.v, self.h, self.conv, self.xk, self.xv, self.C,
                self.c, self.n, self.m)

    def tensors(self) -> List[torch.Tensor]:
        """Every state tensor, ``pos`` last."""
        return [t for ts in self._lists() for t in ts
                if t is not None] + [self.pos]

    def layer(self, i: int):
        """Layer ``i``'s state: (k, v), (k, v, xk, xv) for a cross-attention
        layer, (h, conv) for an RG-LRU layer, (C, n, m, conv) for an mLSTM
        layer or (c, n, h, m) for an sLSTM layer."""
        if self.C[i] is not None:
            return self.C[i], self.n[i], self.m[i], self.conv[i]
        if self.c[i] is not None:
            return self.c[i], self.n[i], self.h[i], self.m[i]
        if self.h[i] is not None:
            return self.h[i], self.conv[i]
        if self.xk[i] is not None:
            return self.k[i], self.v[i], self.xk[i], self.xv[i]
        return self.k[i], self.v[i]

    @property
    def batch(self) -> int:
        return self.tensors()[0].shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors()[:-1])

    def copy_(self, other: "KVCache") -> "KVCache":
        """Take ``other``'s contents into these tensors (same shapes)."""
        for dst, src in zip(self.tensors(), other.tensors()):
            dst.copy_(src)
        return self

    def put(self, i: int, fields, tensors):
        """Set layer ``i``'s entry of each list named in ``fields``."""
        for name, t in zip(fields, tensors):
            getattr(self, name)[i] = t

    def clone(self) -> "KVCache":
        return KVCache(*([None if t is None else t.clone() for t in ts]
                         for ts in self._lists()),
                       self.pos.clone(), self.capacity)


class Transformer(nn.Module):
    """tokens (B, S) -> logits (B, S, padded_vocab) in the compute dtype.

    Built through ``models.registry.build`` (seeded weights) or
    ``models.convert.from_jax_params``; both resolve ``device`` first, so it
    has no default here."""

    def __init__(self, cfg: C.ModelConfig, *, device: torch.device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.blocks = nn.ModuleList()
        self.encoder = None
        if cfg.encoder is not None:
            self.encoder = nn.Module()
            self.encoder.blocks = nn.ModuleList()
        for owner, name, make in self.parts():
            owner.add_module(name, make(device))
        if cfg.tie_embeddings:
            self.unembed = None

    def parts(self):
        """``(owner, name, make)`` of each part of the model, in ``reset``'s
        order of draws: the embedding, the unembedding, each block, each
        encoder block, then the final norms; ``make(device)`` builds the
        part anew in f32 (``models.registry.build`` draws and casts one
        part at a time)."""
        cfg = self.cfg
        embed = lambda dev: L.Embedding(cfg.vocab_size, cfg.d_model,
                                        device=dev)
        norm = lambda dev: L.RMSNorm(cfg.d_model, device=dev)
        out = [(self, "embed", embed)]
        if not cfg.tie_embeddings:
            out.append((self, "unembed", embed))
        out += [(self.blocks, str(i),
                 lambda dev, kind=kind: Block(cfg, kind, device=dev))
                for i, kind in enumerate(cfg.layer_kinds)]
        if cfg.encoder is not None:
            out += [(self.encoder.blocks, str(i),
                     lambda dev: Block(cfg, C.ENC_ATTN, device=dev))
                    for i in range(cfg.encoder.n_layers)]
        out.append((self, "final_norm", norm))
        if cfg.encoder is not None:
            out.append((self.encoder, "final_norm", norm))
        return out

    def reset(self, gen: torch.Generator):
        """Random weights in the JAX package's distributions (normal /
        sqrt(fan_in), embeddings / sqrt(d), zero biases, unit norms)."""
        with torch.no_grad():
            for owner, name, _ in self.parts():
                getattr(owner, name).reset(gen)

    @property
    def padded_vocab(self) -> int:
        return L.pad_vocab(self.cfg.vocab_size)

    def needs_ctx(self) -> bool:
        """Whether the model takes a context: an encoder's frames or
        cross-attention layers (``Model.needs_ctx``)."""
        return self.encoder is not None or C.CROSS_ATTN in self.cfg.layer_kinds

    def ctx_len(self) -> int:
        """Positions of the context: the encoder's frames, else
        ``cross_attn_context_len`` (``Model.ctx_len``)."""
        cfg = self.cfg
        return cfg.encoder.n_frames if cfg.encoder is not None else \
            cfg.cross_attn_context_len

    def make_ctx(self, batch: int, generator: torch.Generator = None):
        """The stub modality context of the JAX package's ``Model.make_ctx``:
        (batch, ``ctx_len()``, d) standard normal, drawn in f32 and cast to
        the compute dtype, on the model's device, from ``generator`` (by
        default one seeded 0, as the JAX engine draws every wave's from
        ``key(0)``; the bits differ); None for a model that takes none."""
        if not self.needs_ctx():
            return None
        dev = self.embed.w.device
        gen = generator or torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((batch, self.ctx_len(), self.cfg.d_model),
                        generator=gen, device=dev)
        return x.to(getattr(torch, self.cfg.compute_dtype))

    def encode(self, ctx_embed: torch.Tensor, *,
               remat: bool = False) -> torch.Tensor:
        """The encoder stack over frame embeddings (B, n_frames, d):
        non-causal attention without RoPE, then the encoder's final norm
        (``encode``).  ``remat``: each block checkpointed as
        ``train_forward``'s decoder blocks are."""
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        x = ctx_embed
        for blk in self.encoder.blocks:
            if remat:
                x, _, _ = checkpoint(
                    _train_block, blk, x, cfg, cdt, None, None,
                    use_reentrant=False, context_fn=sh.checkpoint_contexts)
            else:
                x, _ = blk(x, cfg, cdt)
        return self.encoder.final_norm(x, cfg.norm_eps)

    def context_for(self, ctx_embed, *, remat: bool = False):
        """What the cross-attention layers attend to (``context_for``): the
        encoder's output over ``ctx_embed`` (``encode``, with ``remat``),
        or ``ctx_embed`` itself (patch embeddings); None for a model that
        takes no context.  A model that needs one and gets none raises
        ``ValueError``; one that takes none and gets one raises
        ``TypeError`` (the JAX package ignores it)."""
        if not self.needs_ctx():
            if ctx_embed is not None:
                raise TypeError(f"{self.cfg.name} takes no context embedding")
            return None
        if ctx_embed is None:
            raise ValueError(f"{self.cfg.name} needs a context embedding "
                             f"(make_ctx)")
        return self.encode(ctx_embed, remat=remat) \
            if self.encoder is not None else ctx_embed

    def _head(self):
        return self.unembed if self.unembed is not None else self.embed

    def unembed_weight(self) -> torch.Tensor:
        """The unembedding's (padded_vocab, d) weight: the embedding's where
        they are tied (``Model.unembed_params``)."""
        return self._head().w

    def _check_grad_on_card(self, tokens):
        """Raise where a gradient taken on the card would reach a layer
        with no backward there: attention at a head dim that
        ``flash_attention_bwd`` has no instance of."""
        cfg = self.cfg
        if (tokens.is_cuda and torch.is_grad_enabled()
                and cfg.head_dim not in fkb.HEAD_DIMS
                and any(k in _ATTENTION for k in cfg.layer_kinds)
                and any(p.requires_grad for p in self.parameters())):
            raise RuntimeError(
                f"{cfg.name}: attention at hd={cfg.head_dim} has no backward "
                f"kernel on the card (flash_attention_bwd has hd "
                f"{', '.join(map(str, fkb.HEAD_DIMS))}); run it under "
                f"torch.no_grad()")

    def _inputs(self, tokens, ctx_embed, remat: bool = False):
        """(compute dtype, context, embedded tokens, rope tables over
        positions 0..S-1) of a forward over the whole sequence."""
        self._check_grad_on_card(tokens)
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        ctx = self.context_for(ctx_embed, remat=remat)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        return (cdt, ctx, self.embed(tokens, cdt),
                A.rope_tables(positions, cfg.head_dim, cfg.rope_theta))

    def forward(self, tokens: torch.Tensor, ctx_embed=None) -> torch.Tensor:
        """``ctx_embed``: the context of a model that ``needs_ctx``, (B,
        ``ctx_len()``, d) (``make_ctx``)."""
        cfg = self.cfg
        cdt, ctx, x, rope = self._inputs(tokens, ctx_embed)
        for blk in self.blocks:
            x, _ = blk(x, cfg, cdt, rope, ctx)
        x = self.final_norm(x, cfg.norm_eps)
        return self._head().unembed(x, cdt)

    def train_forward(self, tokens: torch.Tensor, ctx_embed=None, *,
                      block_skip: bool = False, return_hidden: bool = False,
                      remat: bool = False):
        """The training forward (the JAX package's ``forward``): (logits
        (B, S, Vp), aux), or with ``return_hidden`` the final-norm hidden
        states in place of the logits (the fused cross entropy unembeds
        them itself).  aux = {"lb_loss", "z_loss"}, f32 scalars summed over
        the layers (zero without MoE).  ``remat``: each block, the
        encoder's too, under non-reentrant ``torch.utils.checkpoint``, so
        the backward runs the block's forward again (its flash kernels
        included) in place of keeping its activations.  ``block_skip``
        (the JAX package's causal block skip) is accepted and changes
        nothing: the kernels visit every tile, which gives the same
        loss."""
        del block_skip
        cfg = self.cfg
        cdt, ctx, x, rope = self._inputs(tokens, ctx_embed, remat)
        lb = torch.zeros((), dtype=torch.float32, device=tokens.device)
        zl = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for blk in self.blocks:
            if remat:
                x, lb_i, zl_i = checkpoint(
                    _train_block, blk, x, cfg, cdt, rope, ctx,
                    use_reentrant=False, context_fn=sh.checkpoint_contexts)
            else:
                x, lb_i, zl_i = _train_block(blk, x, cfg, cdt, rope, ctx)
            lb, zl = lb + lb_i, zl + zl_i
        x = self.final_norm(x, cfg.norm_eps)
        aux = {"lb_loss": lb, "z_loss": zl}
        return (x if return_hidden else self._head().unembed(x, cdt)), aux

    def _ring(self, capacity: int) -> int:
        """Slots of a sliding-window layer's ring at decode capacity
        ``capacity``."""
        return min(self.cfg.sliding_window, capacity)

    def prefill(self, tokens: torch.Tensor, *, ctx_embed=None,
                max_len: int = None):
        """tokens (B, S) -> (last-token logits (B, Vp), KVCache) of capacity
        ``max_len`` (default S + 64; never below S), ``pos`` = S.  Global
        attention layers hold the prompt's post-RoPE K/V in the compute
        dtype, zero-padded to the capacity; sliding-window layers the last
        min(W, S) positions of their ring of W = min(window, capacity)
        slots, each at slot position mod W (``_seed_cache``); RG-LRU, mLSTM
        and sLSTM layers their state after the prompt; cross-attention
        layers besides the context's K/V, unpadded.  Only the last position
        is normed and unembedded.  ``ctx_embed`` as in ``forward``."""
        self._check_grad_on_card(tokens)
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        B, S = tokens.shape
        cap = max(max_len or S + 64, S)
        dev = tokens.device
        ctx = self.context_for(ctx_embed)
        x = self.embed(tokens, cdt)
        positions = torch.arange(S, device=dev)[None, :]
        rope = A.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        cache = self._empty_cache(cap, torch.full((1,), S, dtype=torch.int64,
                                                  device=dev))
        for i, blk in enumerate(self.blocks):
            x, state = blk(x, cfg, cdt, rope, ctx)
            if blk.kind in _STATE_FIELDS:
                cache.put(i, _STATE_FIELDS[blk.kind], state)
                continue
            W = cap if blk.window is None else self._ring(cap)
            cache.put(i, ("k", "v"), A.seed_kv_cache(*state[:2], W))
            if blk.kind == C.CROSS_ATTN:
                cache.put(i, ("xk", "xv"), (t.transpose(1, 2).contiguous()
                                            for t in state[2:]))
        x = self.final_norm(x[:, -1:], cfg.norm_eps)
        return self._head().unembed(x, cdt)[:, 0], cache

    def _empty_cache(self, capacity: int, pos: torch.Tensor) -> KVCache:
        n = len(self.blocks)
        return KVCache(*([None] * n for _ in range(10)), pos, capacity)

    def decode_step(self, token: torch.Tensor, cache: KVCache):
        """token (B,) int -> (logits (B, Vp), cache): writes the token's K/V
        at slot ``pos`` of every global attention layer (attending over all
        its slots, those past ``pos`` masked) and at slot ``pos`` mod W of
        every ring (``A.ring_slots``), attends over every cross-attention
        layer's context K/V, advances every recurrent state and ``pos``, all
        in place and on the device (no host read of ``pos``: the step is
        graph-capturable).  The caller keeps ``pos`` below the capacity."""
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        pos = cache.pos
        x = self.embed(token[:, None], cdt)
        rope = A.rope_tables(pos.view(1, 1), cfg.head_dim, cfg.rope_theta)
        full = (pos, torch.arange(cache.capacity, device=pos.device))
        ring = A.ring_slots(pos, self._ring(cache.capacity)) \
            if C.LOCAL_ATTN in cfg.layer_kinds else None
        for i, blk in enumerate(self.blocks):
            slots = full if blk.window is None else ring
            x = blk.decode(x, cache.layer(i), pos, slots, cfg, cdt, rope)
        pos.add_(1)
        x = self.final_norm(x, cfg.norm_eps)
        return self._head().unembed(x, cdt)[:, 0], cache

    def init_cache(self, batch: int, seq_len: int, *, pos: int = None,
                   dtype=torch.bfloat16) -> KVCache:
        """Zeroed caches of capacity ``seq_len`` on the model's device
        (``init_layer_cache``: rings of min(window, seq_len) slots, RG-LRU
        states with h in f32, mLSTM and sLSTM states as before a first
        token with the mLSTM's conv window in ``dtype``, cross-attention
        layers' context K/V of ``cross_attn_context_len`` slots),
        positioned at ``pos`` (default seq_len - 1: 'a KV cache of
        seq_len')."""
        cfg = self.cfg
        dev = self.embed.w.device
        p = seq_len - 1 if pos is None else pos
        cache = self._empty_cache(seq_len, torch.full(
            (1,), p, dtype=torch.int64, device=dev))
        for i, blk in enumerate(self.blocks):
            if blk.kind == C.RGLRU:
                state = R.init_rglru_cache(cfg, batch, dtype=dtype, device=dev)
            elif blk.kind == C.MLSTM:
                state = R.init_mlstm_cache(cfg, batch, dtype=dtype, device=dev)
            elif blk.kind == C.SLSTM:
                state = R.init_slstm_cache(cfg, batch, device=dev)
            else:
                cache.put(i, ("k", "v"), A.init_kv_cache(
                    cfg, batch, seq_len, window=blk.window, dtype=dtype,
                    device=dev))
                if blk.kind == C.CROSS_ATTN:
                    cache.put(i, ("xk", "xv"), A.init_kv_cache(
                        cfg, batch, cfg.cross_attn_context_len, dtype=dtype,
                        device=dev))
                continue
            cache.put(i, _STATE_FIELDS[blk.kind], state)
        return cache
