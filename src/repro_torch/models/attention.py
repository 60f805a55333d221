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


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Half-split
    rotation in f32, each half cast back to x's type."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (hd/2,)
    ang = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


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

    def forward(self, x, *, causal=True, window=None, compute_dtype=None):
        cfg = self.cfg
        B, S, _ = x.shape
        q = self.wq(x, compute_dtype).reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = self.wk(x, compute_dtype).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x, compute_dtype).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = ops.flash_attention(q, k, v, causal=causal, window=window)
        return self.wo(o.reshape(B, S, -1), compute_dtype)
