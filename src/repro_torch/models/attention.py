"""Attention: GQA + RoPE over a full sequence (prefill) and one token
against a KV cache (decode).

Layouts as in the JAX package: activations (B, S, d); q (B, S, Hq, hd);
k/v (B, S, Hkv, hd).  The prefill attention is ``kernels.ops.flash_attention``:
the hand-written flash kernel on CUDA tensors, its plain version on CPU
tensors.  Decode attention is the JAX package's plain path (no Pallas
kernel there, no hand kernel here).

KV caches are head-major, (B, Hkv, W, hd) a layer, where the JAX package
keeps (B, W, Hkv, hd): each (batch, KV head) pair is then one contiguous
(W, hd) matrix, so the decode step's two products are batched GEMMs over
B·Hkv that read the cache in place, with no copy and no repeat of KV heads.
A sliding-window layer's cache is a ring of min(window, capacity) slots
(``init_kv_cache(window=)``, ``ring_slots``).  Cross attention
(``Attention(cross=True)``) projects K and V from a context, rotates
nothing, attends over every context position, and decodes against K/V
computed once at the prefill (``decode_cross``).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -1e30


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
    cos, sin = sh.replicate_like(cos, x), sh.replicate_like(sin, x)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return (x * cos + torch.cat([x2, x1], -1) * sin).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


class Attention(nn.Module):
    """Self-attention, or with ``cross`` attention over a context: no
    biases there (``init_attn(cross=True)``)."""

    def __init__(self, cfg, *, cross=False, device=None):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        bias = cfg.qkv_bias and not cross
        self.cfg = cfg
        self.wq = L.Linear(d, hq * hd, bias=bias, device=device)
        self.wk = L.Linear(d, hkv * hd, bias=bias, device=device)
        self.wv = L.Linear(d, hkv * hd, bias=bias, device=device)
        self.wo = L.Linear(hq * hd, d, device=device)

    def reset(self, gen: torch.Generator):
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.reset(gen)

    def _project(self, x, compute_dtype, ctx=None):
        """q from x; k and v from ``ctx`` where given, else from x
        (``_project_qkv``)."""
        cfg = self.cfg
        src = x if ctx is None else ctx
        q = self._heads(self.wq(x, compute_dtype), cfg.n_heads)
        k = self._heads(self.wk(src, compute_dtype), cfg.n_kv_heads)
        v = self._heads(self.wv(src, compute_dtype), cfg.n_kv_heads)
        return (sh.constrain(q, "dp", None, "tp", None),
                sh.constrain(k, "dp", None, "tp", None),
                sh.constrain(v, "dp", None, "tp", None))

    def _heads(self, y, n: int):
        """(B, S, n * hd) -> (B, S, n, hd).  On a mesh whose 'model' extent
        does not divide the n heads, the projection is first replicated
        there (its features may be split mid-head)."""
        if n % sh.tp_size():
            y = sh.constrain(y, "dp", None, None)
        return y.reshape(y.shape[0], -1, n, self.cfg.head_dim)

    def _merge(self, o):
        """(B, S, n, hd) -> (B, S, n * hd).  Where the 'model' extent does
        not divide the heads, ``wo`` splits the merged features' gradient
        over 'model' mid-head: it is laid out as the (replicated) merged
        output before the backward splits it into heads."""
        y = o.reshape(o.shape[0], o.shape[1], -1)
        return sh.keep_grad_layout(y) if o.shape[2] % sh.tp_size() else y

    def forward(self, x, ctx=None, *, causal=True, window=None,
                compute_dtype=None, rope=None):
        """Returns (out, (k, v)), k and v (B, Skv, Hkv, hd) post-RoPE for
        cache seeding, as the JAX package's ``attn_forward``.  ``ctx`` (B,
        Lx, d): cross attention, K and V from it, never rotated.  ``rope``:
        (cos, sin) from ``rope_tables`` over positions 0..S-1, computed here
        when None; False rotates nothing (the encoder)."""
        q, k, v = self._project(x, compute_dtype, ctx)
        if rope is not False and ctx is None:
            if rope is None:
                rope = rope_tables(torch.arange(x.shape[1],
                                                device=x.device)[None, :],
                                   self.cfg.head_dim, self.cfg.rope_theta)
            q, k = rotate(q, *rope), rotate(k, *rope)
        o = ops.flash_attention(q, k, v, causal=causal, window=window)
        o = sh.constrain(o, "dp", None, "tp", None)
        return self.wo(self._merge(o), compute_dtype), (k, v)

    def decode(self, x, k_cache, v_cache, pos, slot, slot_positions, *,
               window=None, compute_dtype=None, rope):
        """One token a sequence (the self-attention branch of the JAX
        package's ``attn_decode``).  x (B, 1, d); caches (B, Hkv, W, hd),
        written in place at ``slot`` (``pos`` for a full cache, a ring's
        from ``ring_slots``); ``pos`` and ``slot`` are one-element int64
        tensors on the cache's device, so that a captured CUDA graph reads
        them at replay: nothing here reads them on the host.
        ``slot_positions`` (W,): each slot's position; ``window`` masks
        positions <= pos - window.  ``rope``: ``rope_tables`` at ``pos``.
        Returns (B, 1, d)."""
        B = x.shape[0]
        q, k, v = self._project(x, compute_dtype)
        q, k = rotate(q, *rope), rotate(k, *rope)
        write_slot_(k_cache, k.to(k_cache.dtype).transpose(1, 2), slot)
        write_slot_(v_cache, v.to(v_cache.dtype).transpose(1, 2), slot)
        o = decode_attention(q, constrain_kv_cache(k_cache),
                             constrain_kv_cache(v_cache), slot_positions, pos,
                             window=window)
        o = sh.constrain(o, "dp", None, "tp", None)
        return self.wo(o.reshape(B, 1, -1), compute_dtype)

    def decode_cross(self, x, k_cache, v_cache, *, compute_dtype=None):
        """One token a sequence against a context's K/V (the ``cross``
        branch of ``attn_decode``): x (B, 1, d), q only; the caches (B, Hkv,
        Lx, hd) hold K and V projected at the prefill and are only read,
        every slot valid (slot positions 0..Lx-1 at ``pos`` Lx).  Nothing
        is read on the host.  Returns (B, 1, d)."""
        cfg = self.cfg
        B, Lx = x.shape[0], k_cache.shape[2]
        q = sh.constrain(self._heads(self.wq(x, compute_dtype), cfg.n_heads),
                         "dp", None, "tp", None)
        o = decode_attention(q, k_cache, v_cache,
                             torch.arange(Lx, device=k_cache.device), Lx)
        o = sh.constrain(o, "dp", None, "tp", None)
        return self.wo(o.reshape(B, 1, -1), compute_dtype)


def constrain_kv_cache(kc):
    """A head-major cache (B, Hkv, W, hd): heads over 'model' where the
    extent divides them, else the cache's sequence (the JAX package's
    ``_constrain_kv_cache``); a cache laid out by ``specs.cache_specs`` is
    returned as it is."""
    if kc.shape[1] % sh.tp_size() == 0:
        return sh.constrain(kc, "dp", "tp", None, None)
    return sh.constrain(kc, "dp", None, "tp", None)


def write_slot_(cache, new, slot):
    """cache (B, Hkv, W, hd) <- new (B, Hkv, 1, hd) at ``slot`` (a
    one-element tensor), in place.  A DTensor cache, laid out by
    ``specs.cache_specs`` (batch and heads, or else its sequence, sharded),
    is written on each rank's shard: the token is laid out as the cache
    (its one position replicated), and a rank whose slots hold ``slot``
    writes it, found on the device by comparing ``slot`` with the shard's
    positions."""
    if not sh.is_sharded(cache):
        cache.index_copy_(2, slot, new)
        return
    mesh, pl = cache.device_mesh, cache.placements
    by_seq = [p.is_shard(2) for p in pl]
    new = new.redistribute(mesh, [Replicate() if s else p
                                  for p, s in zip(pl, by_seq)]).to_local()
    local = cache.to_local()
    if not any(by_seq):
        local.index_copy_(2, slot, new)
        return
    # the shard's first position: mesh dims that split the sequence, the
    # first the major split
    coord, size, first = mesh.get_coordinate(), cache.shape[2], 0
    for j, s in enumerate(by_seq):
        if s:
            size //= mesh.size(j)
            first += coord[j] * size
    sel = (torch.arange(first, first + size, device=local.device)
           == slot)[None, None, :, None]
    local.copy_(torch.where(sel, new, local))


def _bmm_f32(a, b):
    """a @ b (batched, one dtype) with float32 output and float32 sums, the
    counterpart of ``preferred_element_type=f32``, never casting ``b`` (the
    cache) to float32 on the card.  There a bf16 product is one cuBLAS GEMM
    with f32 accumulation and f32 output (``torch.bmm``'s ``out_dtype``).
    The CPU has no such GEMM: there both operands are cast, which gives the
    same function, since the product of two bf16 numbers is exact in f32
    and the sums are f32 either way (only their order differs)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def decode_attention(q, k_cache, v_cache, slot_positions, pos, window=None):
    """q (B, 1, Hq, hd); caches (B, Hkv, W, hd) head-major; slot_positions
    (W,) giving each slot's absolute position (-1 = empty); pos a scalar
    or a one-element tensor.  Returns (B, 1, Hq, hd).

    The JAX package's ``decode_attention``: query head h reads KV head
    h // G (q reshaped to (B, Hkv, G, hd), no repeat), slots valid where
    0 <= position <= pos (and > pos - window), invalid scores set to
    NEG_INF, softmax in f32.  Scores and the output accumulate in f32 by
    ``_bmm_f32``; q is cast to the cache's type and P to V's, as there.

    DTensor q and caches (a sharded model) cross into this function through
    ``local_map``: batch and heads laid out as at the flash kernel's
    boundary (``ops.attention_placements``), each rank attending with its
    own; a cache sharded over its sequence is gathered there."""
    if sh.is_sharded(q):
        return _sharded_decode_attention(q, k_cache, v_cache, slot_positions,
                                         pos, window)
    B, _, Hq, hd = q.shape
    Hkv, W = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B * Hkv, G, hd).to(k_cache.dtype)
    k = k_cache.reshape(B * Hkv, W, hd)
    s = _bmm_f32(qg, k.transpose(1, 2)) * (1.0 / math.sqrt(hd))
    valid = (slot_positions >= 0) & (slot_positions <= pos)
    if window is not None:
        valid &= slot_positions > pos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _bmm_f32(p.to(v_cache.dtype), v_cache.reshape(B * Hkv, W, hd))
    return o.reshape(B, 1, Hq, hd).to(q.dtype)


def _sharded_decode_attention(q, k_cache, v_cache, slot_positions, pos,
                              window):
    mesh = q.device_mesh
    B, _, Hq, _ = q.shape
    Hkv = k_cache.shape[1]
    pl_q = ops.attention_placements(mesh, B, Hq, Hkv)
    pl_c = ops.attention_placements(mesh, B, Hq, Hkv, heads_at=1)
    fn = local_map(lambda q_, k_, v_: decode_attention(
        q_, k_, v_, slot_positions, pos, window=window),
        out_placements=pl_q, in_placements=(pl_q, pl_c, pl_c),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k_cache, v_cache)


def ring_slots(pos, W: int):
    """A ring of W slots at position ``pos`` (a one-element int64 tensor):
    (the slot the token at ``pos`` is written to, pos mod W; each slot's
    position, pos - ((pos - j) mod W), negative for a slot not written
    yet), both computed on ``pos``'s device (the JAX package's
    ``attn_decode`` with a window)."""
    j = torch.arange(W, device=pos.device)
    return torch.remainder(pos, W), pos - torch.remainder(pos - j, W)


def seed_kv_cache(k, v, W: int):
    """k, v (B, S, Hkv, hd) post-RoPE -> head-major (k, v) caches of W
    slots, (B, Hkv, W, hd), holding the last min(W, S) positions, each at
    slot position mod W, zeros elsewhere: a full cache (W >= S, the prompt
    at slots 0..S-1) or a ring (the JAX package's ``_seed_cache``)."""
    B, S, Hkv, hd = k.shape
    n = min(W, S)
    slots = torch.arange(S - n, S, device=k.device) % W
    out = []
    for t in (k, v):
        c = torch.zeros((B, Hkv, W, hd), dtype=t.dtype, device=t.device)
        c[:, :, slots] = t[:, S - n:].transpose(1, 2)
        out.append(c)
    return tuple(out)


def init_kv_cache(cfg, batch: int, seq_len: int, *, window=None,
                  dtype=torch.bfloat16, device=None):
    """Zeroed (k, v) caches of one layer, each (B, Hkv, W, hd): W =
    seq_len, or with a ``window`` a ring of min(window, seq_len) slots."""
    W = seq_len if window is None else min(window, seq_len)
    shape = (batch, cfg.n_kv_heads, W, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
