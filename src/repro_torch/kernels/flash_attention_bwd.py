"""Flash-attention backward kernel for Hopper, written by hand in CUDA C++
(``csrc/flash_attention_bwd.cu``), with its plain PyTorch version.

Replaces the JAX package's backward ``src/repro/models/attention.py::
_fa_bwd_scan`` (jnp behind the fused-kernel boundary ``_fa_bwd_fused``;
the TPU kernel has no backward of its own): dQ, dK and dV from (q, k, v,
o, lse, dO), the scores recomputed tile by tile with the forward's
masks (causal with ``q_offset``, sliding window, non-causal, ragged Sq and
Skv), gradients in the input type.  Deterministic (no atomics): a pass
writes each row's (lse, D = rowsum(dO * O)); dK and dV a block per (64
keys, batch, query head), as f32 partials that a last pass sums over each
GQA group in head order; dQ a block per (64 query rows, batch, query
head).  Each block visits only the tiles that hold a pair the mask keeps
(``tile_range``).  bfloat16 runs on the tensor cores (``wgmma`` + TMA, P
and dS rounded to bf16 as the products' operands, f32 sums); float32 is
true f32 FFMA with ``cp.async``.  Head dims ``HEAD_DIMS``; any other
raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import priced

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNELS = ("dkdv", "dq")   # the two tile kernels, in the C getters' order
AXES = ("q", "kv")         # tile_range's axes, in the C function's order
TILE = 64                  # query rows and keys of a tile
NEG_INF = -1e30


def tile_range(t: int, axis: str, Sq: int, Skv: int, *, causal=True,
               window: Optional[int] = None, q_offset: int = 0):
    """[lo, hi) of the tiles that tile ``t`` visits along ``axis``, as the
    kernels' ``tile_span`` gives it: ``"q"``, the Q tiles of KV tile t (the
    dK/dV kernel); ``"kv"``, the KV tiles of Q tile t (the dQ kernel).
    Every (q, k) pair the mask keeps lies in a visited tile and every
    skipped tile holds none.  Under the causal mask a row that keeps no key
    (qp < 0, or past every key's window) has P = 1 on every key (the mask
    is additive), so a mask with such rows visits every tile."""
    n = -(-(Sq if axis == "q" else Skv) // TILE)
    o, w = q_offset, window or 0
    dead = o < 0 or (w > 0 and o + Sq - 1 > Skv - 2 + w)
    if not causal or dead:
        return 0, n
    clamp = lambda x: min(max(x, 0), n)
    if axis == "q":
        k0, k1 = t * TILE, min(t * TILE + TILE, Skv)
        lo = clamp((k0 - o) // TILE)
        if lo < n and o + min(lo * TILE + TILE, Sq) - 1 < k0:
            lo = n
        hi = clamp((k1 - 2 + w - o) // TILE + 1) if w > 0 else n
    else:
        q0, q1 = t * TILE, min(t * TILE + TILE, Sq)
        hi = clamp((o + q1 - 1) // TILE + 1)
        lo = 0
        if w > 0:
            first = o + q0 - w + 1
            lo = clamp(first // TILE)
            if lo < n and min(lo * TILE + TILE, Skv) - 1 < first:
                lo = n
    return lo, max(lo, hi)


def visited_work(B: int, H: int, Sq: int, Skv: int, hd: int, *, causal=True,
                 window: Optional[int] = None, q_offset: int = 0):
    """(flops, exponentials) of one call: the (64-row, 64-key) tiles the
    two tile kernels visit (``tile_range``) for each (batch, query head),
    four products of 2·64·64·hd a tile in the dK/dV kernel (Sᵀ, dPᵀ, dV,
    dK) and three in the dQ kernel (S, dP, dQ), and 64·64 exponentials a
    tile in each; ragged tails count as whole tiles.  The prep and sum
    passes do no product and are left out."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    span = lambda t, axis: (lambda lo, hi: hi - lo)(
        *tile_range(t, axis, Sq, Skv, **kw))
    dkdv = sum(span(t, "q") for t in range(-(-Skv // TILE)))
    dq = sum(span(t, "kv") for t in range(-(-Sq // TILE)))
    tile = float(TILE * TILE)
    return (B * H * tile * hd * (8.0 * dkdv + 6.0 * dq),
            B * H * tile * (dkdv + dq))


def smem_bytes(hd: int, kernel: str, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one block of ``kernel`` at head dim ``hd``
    in ``dtype``, as the C++ launches it.  bfloat16: 1,024 bytes of
    alignment slack, six swizzled [64][hd] bf16 tiles (K, V and two stages
    of Q and dO for ``dkdv``; Q, dO and two stages of K and V for ``dq``),
    ``dkdv``'s two stages of 64 rows' (lse, D) and 256 bytes of barriers.
    float32: five [64][hd + 4] f32 tiles (K, V, two Q stages and dO; Q,
    dO, two K stages and V), one 64 x 68 score tile and (lse, D) of two Q
    tiles (``dkdv``) or one (``dq``)."""
    if dtype == torch.bfloat16:
        return 1024 + 6 * TILE * hd * 2 \
            + (2 * TILE * 8 if kernel == "dkdv" else 0) + 256
    ld = (2 if kernel == "dkdv" else 1) * 2 * TILE
    return 4 * (5 * TILE * (hd + 4) + TILE * (TILE + 4) + ld)


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
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + \
        [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _getter(name: str):
    fn = getattr(build.load("flash_attention_bwd"),
                 f"pm2lat_flash_attention_bwd_{name}")
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn


def library_smem(hd: int, kernel: str, dtype=torch.bfloat16) -> int:
    """The dynamic shared memory the built library launches ``kernel`` at
    head dim ``hd`` in ``dtype`` with (-1 if it has no such instance)."""
    return _getter("smem")(hd, DTYPES[dtype], KERNELS.index(kernel))


def library_blocks_per_sm(hd: int, kernel: str, dtype=torch.bfloat16) -> int:
    """Resident blocks per SM of ``kernel`` at head dim ``hd`` in
    ``dtype``, from the card's occupancy calculator."""
    return _getter("blocks_per_sm")(hd, DTYPES[dtype], KERNELS.index(kernel))


def library_tile_range(t: int, axis: str, Sq: int, Skv: int, *, causal=True,
                       window: Optional[int] = None, q_offset: int = 0):
    """``tile_range`` as the built library's ``tile_span`` computes it."""
    fn = build.load("flash_attention_bwd").pm2lat_flash_attention_bwd_tile_span
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    span = (ctypes.c_int * 2)()
    fn(t, AXES.index(axis), Sq, Skv, int(bool(causal)), int(window or 0),
       int(q_offset), span)
    return span[0], span[1]


def flash_attention_bwd_kernel(q, k, v, o, lse, do, *, causal=True,
                               window: Optional[int] = None,
                               q_offset: int = 0):
    """(dq, dk, dv) of ``kernels.flash_attention.flash_attention_kernel``
    at (q, k, v) with its output o and lse (``return_lse``) and the
    output's gradient do.  q, o, do (B, Sq, H, hd); k, v (B, Skv, Hkv, hd);
    lse (B, H, Sq) f32.  CUDA tensors launch the hand-written kernels (and
    count the launch); CPU tensors take the plain version; meta tensors
    make meta gradients and report the call (``kernels.priced``); any other
    device raises."""
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
    if priced.all_meta(tensors):
        grads = tuple(torch.empty(t.shape, dtype=t.dtype, device="meta")
                      for t in (q, k, v))
        priced.report("flash_attention_bwd", *visited_work(
            B, H, Sq, Skv, hd, causal=causal, window=window,
            q_offset=q_offset), tensors, grads)
        return grads
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"flash_attention_bwd_kernel: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_kernel: no backward instance "
                         f"at hd={hd} (csrc/flash_attention_bwd.cu has hd "
                         f"{', '.join(map(str, HEAD_DIMS))})")
    q, k, v, o, lse = (build.aligned16(t.contiguous())
                       for t in (q, k, v, o, lse))
    do = build.aligned16(do.to(q.dtype).contiguous())
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    ld = torch.empty((B, H, -(-Sq // TILE) * TILE, 2), **f32)
    part = torch.empty((2, B, Skv, H, hd), **f32) if H != Hkv else None
    lib, fn = _entry()
    err = fn(hd, DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), do.data_ptr(), lse.data_ptr(), ld.data_ptr(),
             None if part is None else part.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Sq, Skv,
             int(bool(causal)), int(window or 0), int(q_offset),
             1.0 / math.sqrt(hd),
             torch._C._cuda_getCurrentRawStream(q.get_device()))
    build.check(err, lib, "flash_attention_bwd")
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0
