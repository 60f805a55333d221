"""Public wrappers around the hand-written kernels: config auto-selection,
GQA head folding.  On CUDA tensors they launch the kernels; on CPU tensors
the kernels' plain versions run (the decision is the tensors' device,
nothing else)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import matmul as mk


def matmul(a: torch.Tensor, b: torch.Tensor,
           config: Optional[mk.MatmulConfig] = None) -> torch.Tensor:
    """a (M,K) @ b (K,N) through the selected kernel config; ragged shapes
    are masked inside the kernel, so nothing is padded here."""
    M, K = a.shape
    N = b.shape[1]
    config = config or mk.select_config(M, N, K, a.dtype)
    return mk.matmul_kernel(a, b, config)


def flash_attention(q, k, v, config: Optional[fk.FlashConfig] = None, *,
                    causal=True, window=None):
    """q (B,Sq,Hq,hd), k/v (B,Skv,Hkv,hd) -> (B,Sq,Hq,hd).  (B,H) is the
    kernel grid's batch dimension; query head h reads KV head h // (Hq/Hkv)
    (the JAX package's ``jnp.repeat`` of KV heads, without the copy).  The
    causal mask is aligned bottom-right (``q_offset = Skv - Sq``)."""
    Sq, hd = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    config = config or fk.select_config(Sq, Skv, hd, q.dtype)
    return fk.flash_attention_kernel(q, k, v, config, causal=causal,
                                     window=window, q_offset=Skv - Sq)
