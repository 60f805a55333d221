"""Flash-attention backward kernel for Hopper, written by hand in CUDA C++
(``csrc/flash_attention_bwd.cu``), with its plain PyTorch version.

Replaces the JAX package's backward ``src/repro/models/attention.py::
_fa_bwd_scan`` (jnp behind the fused-kernel boundary ``_fa_bwd_fused``;
the TPU kernel has no backward of its own): dQ, dK and dV from (q, k, v,
o, lse, dO), the scores recomputed tile by tile with the forward's
masks (causal with ``q_offset``, sliding window, non-causal, ragged Skv),
f32 arithmetic, gradients in the input type.  Three kernels, deterministic
(no atomics): D = rowsum(dO * O); dK and dV a block per (64 keys, batch,
KV head), which sums the G query heads of a GQA group inside the block;
dQ a block per (64 query rows, batch, query head).  Both types run FFMA
on the CUDA cores (bfloat16 is widened on its way into shared memory).
Head dims ``HEAD_DIMS``; any other raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNELS = ("dkdv", "dq")   # the two tile kernels, in the smem getter's order
TILE = 64                  # query rows and keys of a tile
NEG_INF = -1e30


def smem_bytes(hd: int, kernel: str) -> int:
    """Dynamic shared memory of one block of ``kernel`` at head dim ``hd``,
    as the C++ launches it: f32 tiles of 64 rows padded to hd + 4 (K, V,
    Q, dO), score tiles of 64 x 68 (P and dS for ``dkdv``, dSᵀ for
    ``dq``) and the tile's lse and D."""
    tiles = 4 * TILE * (hd + 4)
    scores = (2 if kernel == "dkdv" else 1) * TILE * (TILE + 4)
    return 4 * (tiles + scores + 2 * TILE)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True,
                              window: Optional[int] = None, q_offset: int = 0,
                              kv_block: int = 256):
    """The JAX package's ``_fa_bwd_scan`` on tensors: q, o, do (B, Sq, H,
    hd), k, v (B, Skv, Hkv, hd), lse (B, H, Sq) f32 -> (dq, dk, dv) in
    q's, k's and v's types.  KV blocks of ``kv_block`` (the reference's
    ``DEFAULT_KV_BLOCK``), a ragged tail zero-padded and masked; masks ADD
    ``NEG_INF``; f32 throughout."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    blk = min(kv_block, Skv)
    pad = (-Skv) % blk
    scale = 1.0 / math.sqrt(hd)
    grouped = lambda x: x.float().reshape(B, Sq, Hkv, G, hd)
    qf, dof = grouped(q), grouped(do)
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad))
    D = (dof * grouped(o)).sum(-1)                           # (B,Sq,Hkv,G)
    lse_g = lse.reshape(B, Hkv, G, Sq).permute(0, 3, 1, 2)   # (B,Sq,Hkv,G)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for k0 in range(0, Skv + pad, blk):
        kj, vj = kf[:, k0:k0 + blk], vf[:, k0:k0 + blk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf * scale, kj)
        kv_pos = k0 + torch.arange(blk, device=q.device)[None, :]
        keep = kv_pos < Skv
        if causal:
            keep = keep & (q_pos >= kv_pos)
            if window is not None:
                keep = keep & ((q_pos - kv_pos) < window)
        s = s + torch.where(keep, 0.0, NEG_INF)[None, :, None, None, :]
        p = torch.exp(s - lse_g[..., None])
        dvs.append(torch.einsum("bqhgk,bqhgd->bkhd", p, dof))
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vj)
        ds = p * (dp - D[..., None]) * scale
        dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", ds, kj)
        dks.append(torch.einsum("bqhgk,bqhgd->bkhd", ds, qf))
    dk = torch.cat(dks, 1)[:, :Skv]
    dv = torch.cat(dvs, 1)[:, :Skv]
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build.load("flash_attention_bwd")
    fn = lib.pm2lat_flash_attention_bwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + \
        [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def library_smem(hd: int, kernel: str) -> int:
    """The dynamic shared memory the built library launches ``kernel`` at
    head dim ``hd`` with (-1 if it has no such instance)."""
    lib = build.load("flash_attention_bwd")
    fn = lib.pm2lat_flash_attention_bwd_smem
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    return fn(hd, KERNELS.index(kernel))


def flash_attention_bwd_kernel(q, k, v, o, lse, do, *, causal=True,
                               window: Optional[int] = None,
                               q_offset: int = 0):
    """(dq, dk, dv) of ``kernels.flash_attention.flash_attention_kernel``
    at (q, k, v) with its output o and lse (``return_lse``) and the
    output's gradient do.  q, o, do (B, Sq, H, hd); k, v (B, Skv, Hkv, hd);
    lse (B, H, Sq) f32.  CUDA tensors launch the hand-written kernels (and
    count the launch); CPU tensors take the plain version."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd_kernel: bad shapes q "
                         f"{tuple(q.shape)}, k/v {tuple(k.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}")
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Hkv \
            or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd_kernel: q {tuple(q.shape)} "
                         f"does not match k/v {tuple(k.shape)} or lse "
                         f"{tuple(lse.shape)}")
    if not (q.dtype == k.dtype == v.dtype == o.dtype) \
            or q.dtype not in DTYPES or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd_kernel: q, k, v, o must share "
                        f"one of {list(DTYPES)} and lse be float32")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_bwd_kernel: window={window} must "
                         f"be positive or None")
    tensors = (q, k, v, o, lse, do)
    if all(t.is_cpu for t in tensors):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, q_offset=q_offset)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"flash_attention_bwd_kernel: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_kernel: no backward instance "
                         f"at hd={hd} (csrc/flash_attention_bwd.cu has hd "
                         f"{', '.join(map(str, HEAD_DIMS))})")
    q, k, v, o, lse = (t.contiguous() for t in (q, k, v, o, lse))
    do = do.to(q.dtype).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib, fn = _entry()
    err = fn(hd, DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), do.data_ptr(), lse.data_ptr(), D.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Sq, Skv,
             int(bool(causal)), int(window or 0), int(q_offset),
             1.0 / math.sqrt(hd),
             torch._C._cuda_getCurrentRawStream(q.get_device()))
    build.check(err, lib, "flash_attention_bwd")
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0
