"""Public wrappers around the hand-written kernels: config auto-selection,
GQA head folding, and the attention's autograd.  On CUDA tensors they
launch the kernels; on CPU tensors the kernels' plain versions run (the
decision is the tensors' device, nothing else)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import sharding as sh
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import flash_attention_bwd as fkb
from repro_torch.kernels import matmul as mk


def matmul(a: torch.Tensor, b: torch.Tensor,
           config: Optional[mk.MatmulConfig] = None) -> torch.Tensor:
    """a (M,K) @ b (K,N) through the selected kernel config; ragged shapes
    are masked inside the kernel, so nothing is padded here."""
    M, K = a.shape
    N = b.shape[1]
    config = config or mk.select_config(M, N, K, a.dtype)
    return mk.matmul_kernel(a, b, config)


class FlashAttention(torch.autograd.Function):
    """The flash kernel's forward with its log-sum-exp saved, and the hand
    backward kernel (the JAX package's ``_flash_attn`` custom VJP: the
    residuals are q, k, v, o in the compute dtype and the f32 lse).
    Second-order gradients raise, as ``_fa_bwd_fused_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, config, causal, window, q_offset):
        o, lse = fk.flash_attention_kernel(q, k, v, config, causal=causal,
                                           window=window, q_offset=q_offset,
                                           return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, q_offset)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        causal, window, q_offset = ctx.mask
        dq, dk, dv = fkb.flash_attention_bwd_kernel(
            *ctx.saved_tensors, do, causal=causal, window=window,
            q_offset=q_offset)
        return dq, dk, dv, None, None, None, None


def attention_placements(mesh, batch: int, hq: int, hkv: int, *,
                         heads_at: int = 2) -> list:
    """The placements q, k, v and o take at the kernel boundary on
    ``mesh``: batch (dim 0) over the data-parallel dims whose extent
    divides it; heads (dim ``heads_at``: 2 in (B, S, H, hd), 1 in a
    head-major cache) over 'model' only where the extent divides both Hq
    and Hkv (the kernel maps query head h to KV head h // (Hq / Hkv), which
    holds on each rank's local heads only then), else replicated there."""
    ext = sh.mesh_extents(mesh)
    dp = tuple(a for a in sh.DP_AXIS_NAMES if a in ext)
    n_dp = 1
    for a in dp:
        n_dp *= ext[a]
    tp = ext.get(sh.TP_AXIS_NAME, 1)
    entries = [dp if dp and batch % n_dp == 0 else None, None, None, None]
    if sh.TP_AXIS_NAME in ext and hq % tp == 0 and hkv % tp == 0:
        entries[heads_at] = sh.TP_AXIS_NAME
    return sh.placements(entries, mesh)


def _local_flash(q, k, v, config, causal, window):
    """The kernel (or its plain version) on plain tensors."""
    Sq, hd = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    config = config or fk.select_config(Sq, Skv, hd, q.dtype)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, config, causal, window,
                                    Skv - Sq)
    return fk.flash_attention_kernel(q, k, v, config, causal=causal,
                                     window=window, q_offset=Skv - Sq)


def flash_attention(q, k, v, config: Optional[fk.FlashConfig] = None, *,
                    causal=True, window=None):
    """q (B,Sq,Hq,hd), k/v (B,Skv,Hkv,hd) -> (B,Sq,Hq,hd).  (B,H) is the
    kernel grid's batch dimension; query head h reads KV head h // (Hq/Hkv)
    (the JAX package's ``jnp.repeat`` of KV heads, without the copy).  The
    causal mask is aligned bottom-right (``q_offset = Skv - Sq``).  Where a
    gradient is wanted (grad mode on and an input that requires it) the
    call goes through ``FlashAttention``; otherwise the forward kernel runs
    alone and writes no lse.

    DTensor q, k, v (a sharded model) cross the kernel boundary through
    ``local_map``: they are laid out by ``attention_placements`` and the
    kernel runs on each rank's local batch and heads, its output and
    gradients DTensors again; nothing is gathered around it."""
    if not isinstance(q, DTensor):
        return _local_flash(q, k, v, config, causal, window)
    mesh = q.device_mesh
    pl = attention_placements(mesh, q.shape[0], q.shape[2], k.shape[2])
    fn = local_map(lambda q_, k_, v_: _local_flash(q_, k_, v_, config,
                                                    causal, window),
                   out_placements=pl, in_placements=(pl, pl, pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)
