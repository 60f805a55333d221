"""Plain PyTorch oracle for the flash-attention kernel (the allclose
target): the dense formula, independent of the kernel's tiling.  The
matmul's plain version is ``kernels.matmul.matmul_plain``."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q (B,Sq,H,hd), k/v (B,Skv,H,hd) -> (B,Sq,H,hd). Materializes scores
    (oracle only)."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / hd ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qp = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        kp = torch.arange(Skv, device=q.device)[None, :]
        m = qp >= kp
        if window is not None:
            m &= (qp - kp) < window
        s = torch.where(m[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
