"""Flash-attention forward kernel for Hopper, written by hand in CUDA C++
(``csrc/flash_attention.cu``), with its plain PyTorch version.

Replaces the TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention_kernel``: online
softmax over KV tiles, causal (bottom-right aligned through ``q_offset``)
and sliding-window masks that ADD ``NEG_INF = -1e30``, f32 m/l/acc, l
clamped at 1e-30, every KV tile visited.  Like the matmul kernel, the
(bq, bk) block configuration is a PM2Lat kernel identity (``fa_<bq>x<bk>``).

The TPU family was re-derived for the card: a 512x512 f32 score tile is
1 MiB, against 227 KB of shared memory a block.  Kept: ``fa_128x128``;
added: ``fa_64x64``.  Head dims 16 to 128 have both; hd 256
(recurrentgemma-2b, gemma-7b) has ``fa_64x64`` only, since
``fa_128x128``'s tiles pass 227 KB there in either type (``INSTANCES``).
float32 runs register-tiled FFMA on the CUDA cores: 2·bq threads, each
holding 8 query rows by bk/16 keys of S and the same rows by hd/16 columns
of O in registers (at hd 256, 4·bq threads of 4 rows each), with K and V
tiles copied by cp.async so that each copy overlaps a product; bfloat16
runs ``wgmma`` on the tensor cores, one warpgroup per 64 query rows, with
K and V tiles fed by TMA through a two-stage ring and a second load path
for tensors TMA cannot address (``load_path``).  Both have
``threads(hd, dtype)`` threads a block.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import priced

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True, order=True)
class FlashConfig:
    bq: int
    bk: int

    @property
    def name(self) -> str:
        return f"fa_{self.bq}x{self.bk}"

    def threads(self, hd: int, dtype: torch.dtype) -> int:
        """Threads of one block: 2·bq in bfloat16 (one warpgroup per 64
        query rows) and in float32 up to hd 128 (a (bq/8) x 16 grid of 8
        query rows each); 4·bq in float32 at hd 256 (4 rows each)."""
        return 4 * self.bq if dtype == torch.float32 and hd > 128 \
            else 2 * self.bq

    def smem_bytes(self, hd: int, dtype=torch.bfloat16) -> int:
        """Dynamic shared memory of one block, as the C++ launches it.
        float32 (``FaFfma::SMEM``): the scaled Q tile [bq, hd], K [bk, hd + 4],
        V [bk, hd] and Pᵀ [bk, bq + 4], all f32; where the four pass 227 KB,
        Pᵀ shares K's buffer.  bfloat16: the Q tile and two stages of K and
        V tiles, 1024 bytes to align them and 256 for the barriers
        (``FaWgmma::SMEM``)."""
        if dtype == torch.float32:
            q, kk, v = self.bq * hd, self.bk * (hd + 4), self.bk * hd
            p = self.bk * (self.bq + 4)
            if 4 * (q + kk + v + p) <= SMEM_BUDGET:
                return 4 * (q + kk + v + p)
            return 4 * (q + max(kk, p) + v)
        return 1024 + 2 * hd * (self.bq + 2 * RING_STAGES * self.bk) + 256


CONFIGS: Tuple[FlashConfig, ...] = (
    FlashConfig(64, 64),
    FlashConfig(128, 128),
)
HEAD_DIMS = (16, 32, 64, 128, 256)
SMEM_BUDGET = 232448  # 227 KB: what one H100 block can use
RING_STAGES = 2       # K/V stages of the bf16 kernel's ring
# The (config, head dim) pairs csrc/flash_attention.cu instantiates, in
# both types: each pair whose tiles fit the budget in both.
INSTANCES: Tuple[Tuple[FlashConfig, int], ...] = tuple(
    (c, hd) for c in CONFIGS for hd in HEAD_DIMS
    if max(c.smem_bytes(hd, dt) for dt in (torch.float32, torch.bfloat16))
    <= SMEM_BUDGET)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The ``path`` argument of the C entry: the bf16 kernel's two ways of
# filling its shared-memory tiles; float32 has one kernel, FFMA, which
# ignores it and takes dense tensors at 16-byte aligned addresses.
LOAD_PATHS = {"tma": 0, "sync": 1, "ffma": 0}


def load_path(q, k, v) -> str:
    """How ``flash_attention_kernel`` loads q, k and v, each
    (B, S, heads, hd) (``_operands``)."""
    return _operands(q, k, v)[3]


def _operands(q, k, v):
    """(q, k, v, path): the tensors as the kernel takes them and how it
    loads them.  The bf16 kernel takes strides, so only a strided head dim
    is copied; float32's kernel takes dense tensors at 16-byte aligned
    addresses, so any other is copied.  Path ``"ffma"`` for float32 (the
    CUDA-core kernel); for bfloat16 ``"tma"``
    when every base address and every batch, sequence and head stride is a
    positive multiple of 16 bytes (what a TMA tensor map takes), else
    ``"sync"`` (the consumers' own loads into the same shared-memory
    layout).  A ragged Sq or Skv does not matter: TMA zero-fills a box past
    the end and the row stride is heads * hd * 2 bytes whatever the
    length."""
    if q.dtype == torch.float32:
        q, k, v = (build.aligned16(t.contiguous()) for t in (q, k, v))
        return q, k, v, "ffma"
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    tma = _tma_ok((q.data_ptr(), k.data_ptr(), v.data_ptr()),
                  q.stride()[:3] + k.stride()[:3] + v.stride()[:3])
    return q, k, v, "tma" if tma else "sync"


def _tma_ok(ptrs, strides) -> bool:
    """bf16 tensors at ``ptrs`` with (batch, sequence, head) ``strides`` in
    elements: every address and stride a multiple of 16 bytes, every stride
    positive."""
    bits = 0
    for p in ptrs:
        bits |= p
    for st in strides:
        if st <= 0:
            return False
        bits |= st << 1
    return bits & 15 == 0


def select_config(Sq: int, Skv: int, hd: int,
                  dtype=torch.bfloat16) -> FlashConfig:
    """The largest config instantiated at ``hd`` (INSTANCES, which holds
    each pair in both types, so ``dtype`` does not change the pick) whose
    tiles divide both lengths, else the smallest one (the kernel masks
    ragged tails)."""
    feasible = [c for c, h in INSTANCES if h == hd]
    if not feasible:
        raise ValueError(f"select_config: no flash instance at hd={hd}")
    for c in sorted(feasible, key=lambda c: -(c.bq * c.bk)):
        if Sq % c.bq == 0 and Skv % c.bk == 0:
            return c
    return min(feasible, key=lambda c: c.bq * c.bk)


def flash_attention_plain(q, k, v, config: FlashConfig, *, causal=True,
                          window: Optional[int] = None, q_offset: int = 0,
                          return_lse: bool = False):
    """The kernel's function in plain PyTorch, KV tile by KV tile with the
    kernel's masking and online-softmax arithmetic.  q (B,Sq,H,hd), k/v
    (B,Skv,Hkv,hd) -> (B,Sq,H,hd); query head h reads KV head h // (H/Hkv).
    With ``return_lse``, (o, lse): lse (B, H, Sq) f32 = m + log(max(l,
    1e-30)) over the scaled scores, as the JAX package's ``_fa_fwd_scan``
    returns it."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    bk = config.bk
    pad = (-Skv) % bk
    heads = lambda x: x.float().repeat_interleave(G, dim=2).transpose(1, 2)
    qf = q.float().transpose(1, 2) * (1.0 / float(hd) ** 0.5)   # (B,H,Sq,hd)
    kf = torch.nn.functional.pad(heads(k), (0, 0, 0, pad))       # (B,H,Skv+pad,hd)
    vf = torch.nn.functional.pad(heads(v), (0, 0, 0, pad))
    qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, hd), device=q.device)
    for k0 in range(0, Skv + pad, bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)           # (B,H,Sq,bk)
        kp = k0 + torch.arange(bk, device=q.device)[None, :]
        keep = kp < Skv
        if causal:
            keep = keep & (qp >= kp)
            if window is not None:
                keep = keep & ((qp - kp) < window)
        s = s + torch.where(keep, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        acc = acc * corr + p @ vf[:, :, k0:k0 + bk]
    l = torch.clamp(l, min=1e-30)
    o = (acc / l).transpose(1, 2).to(q.dtype)
    return (o, (m + torch.log(l))[..., 0]) if return_lse else o


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build.load("flash_attention")
    fn = lib.pm2lat_flash_attention
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_longlong] * 9 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def library_smem(config: FlashConfig, hd: int, dtype) -> int:
    """The dynamic shared memory the built library launches ``config`` at
    head dim ``hd`` with in ``dtype`` (-1 if it has no such instance)."""
    lib = build.load("flash_attention")
    fn = lib.pm2lat_flash_attention_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(config.bq, config.bk, hd, DTYPES[dtype])


def library_blocks_per_sm(config: FlashConfig, hd: int) -> int:
    """Resident blocks per SM of the built float32 instance of ``config``
    at head dim ``hd``, from the card's occupancy calculator (negative if
    it has none)."""
    lib = build.load("flash_attention")
    fn = lib.pm2lat_flash_attention_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(config.bq, config.bk, hd)


def visited_work(config: FlashConfig, B: int, H: int, Sq: int, Skv: int,
                 hd: int):
    """(flops, exponentials) of one launch: every (bq, bk) tile of every
    (batch, head), whatever the mask (``csrc/flash_attention.cu`` visits
    every KV tile), each tile two products of 2·bq·bk·hd (S = Q Kᵀ and
    P V) and bq·bk exponentials; ragged tails count as whole tiles."""
    tiles = B * H * -(-Sq // config.bq) * -(-Skv // config.bk)
    return (tiles * 4.0 * config.bq * config.bk * hd,
            tiles * float(config.bq * config.bk))


def flash_attention_kernel(q, k, v, config: FlashConfig, *, causal=True,
                           window: Optional[int] = None, q_offset: int = 0,
                           return_lse: bool = False):
    """q (BH,Sq,hd), k/v (BH,Skv,hd) -> (BH,Sq,hd), as the TPU kernel; or
    q (B,Sq,H,hd), k/v (B,Skv,Hkv,hd) -> (B,Sq,H,hd) with H a multiple of
    Hkv (GQA read in place).  Any Sq, Skv: the kernel masks ragged tails.
    With ``return_lse`` (the backward's residual; 4-d tensors only), (o,
    lse) with lse (B, H, Sq) f32.  CUDA tensors launch the hand-written
    kernel (and count the launch); CPU tensors take the plain version;
    meta tensors make meta outputs and report the call (``kernels.priced``);
    any other device raises.  It has no autograd of its own:
    ``kernels.ops.flash_attention`` is the differentiable entry."""
    three_d = q.dim() == 3
    if three_d:
        q, k, v = q[:, :, None], k[:, :, None], v[:, :, None]
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention_kernel: bad shapes {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Hkv:
        raise ValueError(f"flash_attention_kernel: q {tuple(q.shape)} does "
                         f"not match k/v {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_kernel: dtypes must agree and be "
                        f"one of {list(DTYPES)}")
    if (config, hd) not in INSTANCES:
        raise ValueError(f"flash_attention_kernel: {config} at hd={hd} is not "
                         f"instantiated (INSTANCES)")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_kernel: window={window} must be "
                         f"positive or None")
    if return_lse and three_d:
        raise ValueError("flash_attention_kernel: return_lse takes 4-d "
                         "tensors")
    if q.is_cpu and k.is_cpu and v.is_cpu:
        out = flash_attention_plain(q, k, v, config, causal=causal,
                                    window=window, q_offset=q_offset,
                                    return_lse=return_lse)
        return out[:, :, 0] if three_d else out
    if priced.all_meta((q, k, v)):
        o, lse = _priced(q, k, v, config, return_lse)
    else:
        o, lse = _launch(q, k, v, config, causal, window, q_offset,
                         return_lse)
    if three_d:
        return o[:, :, 0]
    return (o, lse) if return_lse else o


def _no_autograd(q, k, v):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_kernel has no autograd; take "
                           "gradients through kernels.ops.flash_attention")


def _priced(q, k, v, config, return_lse):
    """``_launch`` on meta tensors: (o, lse) on meta, the call reported."""
    _no_autograd(q, k, v)
    B, Sq, H, hd = q.shape
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device="meta")
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="meta") \
        if return_lse else None
    flops, exps = visited_work(config, B, H, Sq, k.shape[1], hd)
    priced.report("flash_attention", flops, exps, (q, k, v), (o, lse))
    return o, lse


def _launch(q, k, v, config, causal, window, q_offset, return_lse):
    """(o, lse); lse is None (a null pointer to the kernel) unless
    ``return_lse``."""
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"flash_attention_kernel: tensors on {q.device}, "
                         f"{k.device}, {v.device}")
    _no_autograd(q, k, v)
    q, k, v, path = _operands(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    lib, fn = _entry()
    err = fn(config.bq, config.bk, hd, DTYPES[q.dtype], LOAD_PATHS[path],
             q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             0 if lse is None else lse.data_ptr(),
             B, H, Hkv, Sq, Skv, int(bool(causal)), int(window or 0),
             int(q_offset), 1.0 / float(hd) ** 0.5,
             *(q.stride()[:3] + k.stride()[:3] + v.stride()[:3]),
             torch._C._cuda_getCurrentRawStream(q.get_device()))
    build.check(err, lib, "flash_attention")
    flash_attention_kernel.launches += 1
    by_hd = flash_attention_kernel.launches_by_hd
    by_hd[hd] = by_hd.get(hd, 0) + 1
    by_mask = flash_attention_kernel.launches_by_causal
    by_mask[bool(causal)] = by_mask.get(bool(causal), 0) + 1
    return o, lse


flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by_hd = {}   # the same launches by head dim
flash_attention_kernel.launches_by_causal = {}   # and by the causal flag
