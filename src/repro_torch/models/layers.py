"""Core parameterized layers as ``nn.Module``s.

Attribute names mirror the JAX package's parameter keys (``w``, ``b``,
``scale``, ``w_in`` ...), so a JAX parameter tree maps onto a module's
``state_dict`` by joining keys with dots (``models/convert.py``).  Weights
keep the JAX ``(d_in, d_out)`` layout: a linear computes ``x @ w``.
Parameters are created with ``requires_grad=False``, so that inference
records no graph; training turns gradients on
(``training.step.build_train_step``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import sharding as sh


def pad_vocab(vocab_size: int, multiple: int = 256) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple


def is_gated(name: str) -> bool:
    return name in ("silu", "geglu")


def act_fn(name: str):
    gelu = lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    return {"silu": F.silu, "gelu": gelu, "geglu": gelu, "relu": F.relu}[name]


def _param(*shape, device, fill=None):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 device=None):
        super().__init__()
        self.w = _param(d_in, d_out, device=device)
        self.b = _param(d_out, device=device, fill=0.0) if bias else None

    def reset(self, gen: torch.Generator, scale: float = None):
        scale = scale if scale is not None else 1.0 / math.sqrt(self.w.shape[0])
        self.w.normal_(0.0, 1.0, generator=gen).mul_(scale)

    def forward(self, x, compute_dtype=None):
        w = self.w
        if compute_dtype is not None:
            w = w.to(compute_dtype)
            x = x.to(compute_dtype)
        y = x @ w
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return y


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = _param(d, device=device, fill=1.0)

    def reset(self, gen: torch.Generator):
        """Unit scale (nothing is drawn)."""
        self.scale.fill_(1.0)

    def forward(self, x, eps: float = 1e-6):
        """x * rsqrt(mean(x^2) + eps) * scale in f32, cast back to x's type;
        one PyTorch call in place of six (the forward's host time)."""
        return F.rms_norm(x.float(), (x.shape[-1],), self.scale, eps).to(x.dtype)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str, *, device=None):
        super().__init__()
        self.act = act
        self.w_in = Linear(d_model, d_ff, device=device)
        self.w_out = Linear(d_ff, d_model, device=device)
        self.w_gate = Linear(d_model, d_ff, device=device) if is_gated(act) else None

    def reset(self, gen: torch.Generator):
        for lin in (self.w_in, self.w_out, self.w_gate):
            if lin is not None:
                lin.reset(gen)

    def forward(self, x, compute_dtype=None):
        h = self.w_in(x, compute_dtype)
        if self.w_gate is not None:
            h = act_fn(self.act)(self.w_gate(x, compute_dtype)) * h
        else:
            h = act_fn(self.act)(h)
        h = sh.constrain(h, *(["dp"] + [None] * (h.ndim - 2) + ["tp"]))
        return self.w_out(h, compute_dtype)


def _sharded_lookup(w, tokens):
    """``w[tokens]`` for a DTensor table: through ``local_map``, each rank
    looks its own tokens up in the whole table (gathered where the mesh
    splits it), and the table's gradient is a pending sum over the mesh
    dims that split the tokens (replicated over the rest)."""
    mesh = w.device_mesh
    tokens = sh.replicate_like(tokens, w)
    tok_pl = list(tokens.placements)
    grad_pl = [Partial() if p.is_shard() else Replicate() for p in tok_pl]
    fn = local_map(lambda w_, t_: w_[t_], out_placements=tok_pl,
                   in_placements=([Replicate()] * mesh.ndim, tok_pl),
                   in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(w, tokens)


class Embedding(nn.Module):
    """Token embedding over the padded vocab; also the tied unembedding."""

    def __init__(self, vocab_size: int, d_model: int, *, device=None):
        super().__init__()
        self.w = _param(pad_vocab(vocab_size), d_model, device=device)

    def reset(self, gen: torch.Generator):
        # 1/sqrt(d) so tied-unembedding logits are O(1) after the final norm
        self.w.normal_(0.0, 1.0, generator=gen).mul_(self.w.shape[1] ** -0.5)

    def forward(self, tokens, compute_dtype=None):
        y = _sharded_lookup(self.w, tokens) if sh.is_sharded(self.w) \
            else self.w[tokens]
        return sh.constrain_hidden(y if compute_dtype is None
                                   else y.to(compute_dtype))

    def unembed(self, x, compute_dtype=None):
        """x (..., d) -> logits (..., padded_vocab)."""
        w = self.w
        if compute_dtype is not None:
            w = w.to(compute_dtype)
            x = x.to(compute_dtype)
        logits = x @ w.T
        return sh.constrain(logits,
                            *(["dp"] + [None] * (logits.ndim - 2) + ["tp"]))
