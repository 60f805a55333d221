"""Attention: GQA + RoPE over a full sequence (the prefill forward pass).

Layouts as in the JAX package: activations (B, S, d); q (B, S, Hq, hd);
k/v (B, S, Hkv, hd).  The attention itself is ``kernels.ops.flash_attention``:
the hand-written flash kernel on CUDA tensors, its plain version on CPU
tensors.  Decode attention and KV caches come with the decode slice.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions, head_dim: int, theta: float):
    """The rotation's factors in f32, (..., S, 1, hd), for positions
    broadcastable to (..., S): cos(ang) on both halves, and -sin(ang) on
    the first half and sin(ang) on the second.  The model's forward
    computes them once and every layer reuses them."""
    freqs = rope_freqs(head_dim, theta, positions.device)    # (hd/2,)
    ang = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], -1)[..., None, :],
            torch.cat([-sin, sin], -1)[..., None, :])


def rotate(x, cos, sin):
    """Half-split rotation of x (..., S, H, hd) by ``rope_tables``, in f32,
    cast back to x's type: (x1 cos - x2 sin, x2 cos + x1 sin)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return (x * cos + torch.cat([x2, x1], -1) * sin).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


class Attention(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.wq = L.Linear(d, hq * hd, bias=cfg.qkv_bias, device=device)
        self.wk = L.Linear(d, hkv * hd, bias=cfg.qkv_bias, device=device)
        self.wv = L.Linear(d, hkv * hd, bias=cfg.qkv_bias, device=device)
        self.wo = L.Linear(hq * hd, d, device=device)

    def reset(self, gen: torch.Generator):
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.reset(gen)

    def forward(self, x, *, causal=True, window=None, compute_dtype=None,
                rope=None):
        """``rope``: (cos, sin) from ``rope_tables`` over positions 0..S-1,
        computed here when not given."""
        cfg = self.cfg
        B, S, _ = x.shape
        q = self.wq(x, compute_dtype).reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = self.wk(x, compute_dtype).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x, compute_dtype).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        if rope is None:
            rope = rope_tables(torch.arange(S, device=x.device)[None, :],
                               cfg.head_dim, cfg.rope_theta)
        q = rotate(q, *rope)
        k = rotate(k, *rope)
        o = ops.flash_attention(q, k, v, causal=causal, window=window)
        return self.wo(o.reshape(B, S, -1), compute_dtype)
