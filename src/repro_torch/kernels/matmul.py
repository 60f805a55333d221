"""Tiled matmul kernel for Hopper, written by hand in CUDA C++
(``csrc/matmul.cu``), with its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/matmul.py::matmul_kernel``.  The
(bm, bk, bn) block configuration IS the kernel identity in the PM2Lat sense
(``mm_<bm>x<bk>x<bn>``): the same GEMM runs as genuinely different kernels
with different shared-memory working sets, grid shapes and ragged-tail
behavior.  ``select_config`` is the ``cublasLtMatmulAlgoGetHeuristic``
analogue, scored against the card's shared memory instead of the TPU's VMEM.

The TPU family was re-derived for the card: a block has 227 KB of shared
memory and 255 registers a thread, so the TPU's 256- and 512-wide tiles are
gone (a 256x256 f32 output tile alone is the whole 256 KB register file).
Kept: ``mm_128x128x128`` (128 KB of f32 tiles, 64 accumulators a thread at
256 threads) and the skinny-M ``mm_8x128x128``; added: ``mm_128x32x128``
(short K steps, a quarter of the shared memory) and ``mm_64x64x64``.

Two kernels per identity: float32 runs register-tiled FFMA on the CUDA
cores (true f32, as the tables require): each thread keeps a micro-tile of
C in registers (``ffma_tile``), and cp.async copies A and B into a double
buffer of sub-chunks of K (``ffma_slot`` columns), so that the next
sub-chunk loads while the current one is multiplied.  bfloat16 runs ``wgmma`` on the tensor cores, fed by TMA
through a shared-memory ring (``stages`` deep), with a second load path
for operands TMA cannot address (``load_path``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build


@dataclasses.dataclass(frozen=True, order=True)
class MatmulConfig:
    bm: int
    bk: int
    bn: int

    @property
    def name(self) -> str:
        return f"mm_{self.bm}x{self.bk}x{self.bn}"

    @property
    def stages(self) -> int:
        """Depth of the bf16 kernel's shared-memory ring: as many A + B
        stages as 192 KB holds, at most 4 (``MmWgmma::ST``)."""
        return min(4, RING_BYTES // self._stage_bytes())

    def _stage_bytes(self) -> int:
        # wgmma takes 64 rows: a skinny A tile is padded to 64 zero rows
        return 2 * (max(self.bm, 64) * self.bk + self.bk * self.bn)

    @property
    def ffma_tile(self) -> Tuple[int, int]:
        """(rows, columns) of C each thread of the float32 kernel keeps in
        registers (``PM2LAT_MM_F32``'s TM, TN)."""
        return FFMA_TILES[(self.bm, self.bk, self.bn)]

    @property
    def ffma_slot(self) -> int:
        """K columns of one slot of the float32 kernel's double buffer:
        a bk step is walked in sub-chunks of at most 64 (``MmFfma::SK``)."""
        return min(self.bk, 64)

    @property
    def ffma_threads(self) -> int:
        """Threads of one float32 block: one per micro-tile of C."""
        tm, tn = self.ffma_tile
        return (self.bm // tm) * (self.bn // tn)

    def smem_bytes(self, dtype=torch.bfloat16) -> int:
        """Dynamic shared memory of one block, as the C++ launches it.
        float32: two slots of A [bm, sk] and B [sk, bn] in f32, sk =
        ``ffma_slot``, each A row padded by 4 floats (``MmFfma::SMEM``).
        That is two whole stages for bk <= 64 and one bk = 128 stage in
        two halves.  bfloat16: the ring of A and
        B stages, 1024 bytes to align it and 256 for its barriers
        (``MmWgmma::SMEM``)."""
        if dtype == torch.float32:
            sk = self.ffma_slot
            return 4 * 2 * (self.bm * (sk + 4) + sk * self.bn)
        return 1024 + self.stages * self._stage_bytes() + 256


# The kernel family; every entry is instantiated in csrc/matmul.cu.
CONFIGS: Tuple[MatmulConfig, ...] = (
    MatmulConfig(128, 128, 128),
    MatmulConfig(128, 32, 128),
    MatmulConfig(64, 64, 64),
    MatmulConfig(8, 128, 128),      # skinny-M (decode-style GEMV-ish)
)

# The float32 kernel's micro-tile (rows, columns of C a thread) per
# identity, as instantiated in csrc/matmul.cu: 8 x 8 at 256 threads for the
# 128-wide tiles, 4 x 4 at 256 for mm_64x64x64, 2 x 4 at 128 for the
# skinny mm_8x128x128.
FFMA_TILES = {(128, 128, 128): (8, 8), (128, 32, 128): (8, 8),
              (64, 64, 64): (4, 4), (8, 128, 128): (2, 4)}
SMEM_BUDGET = 232448  # 227 KB: what one H100 block can use
RING_BYTES = 196608   # 192 KB: what the bf16 ring may take of it
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The ``path`` argument of the C entry: the bf16 kernel's two ways of
# filling its shared-memory tiles (TMA, or the consumers' own copies), and
# the float32 kernel's two copy widths (16 bytes, or 4 where K or N is no
# multiple of 4 and the rows are not 16-byte aligned).
LOAD_PATHS = {"tma": 0, "sync": 1, "ffma": 0, "ffma_scalar": 1}


def load_path(a: torch.Tensor, b: torch.Tensor) -> str:
    """How ``matmul_kernel`` loads a and b (``_operands``)."""
    return _operands(a, b)[2]


def _operands(a, b):
    """(a, b, path): the operands as the kernel takes them and how it loads
    them.  The bf16 kernel takes row strides, so only a strided last dim is
    copied; float32's kernel takes dense operands at 16-byte aligned
    addresses, so any other is copied.  float32: ``"ffma"`` (16-byte
    copies) when K and N are multiples of 4, else ``"ffma_scalar"`` (4-byte
    copies).  bfloat16: ``"tma"`` when each operand's base address and row
    stride are multiples of 16 bytes and its rows do not overlap (what a
    TMA tensor map takes), else ``"sync"`` (the consumers' own loads into
    the same shared-memory layout)."""
    if a.dtype == torch.float32:
        a, b = (build.aligned16(t.contiguous()) for t in (a, b))
        return a, b, ("ffma" if (a.shape[1] | b.shape[1]) % 4 == 0
                      else "ffma_scalar")
    if a.stride(1) != 1:
        a = a.contiguous()
    if b.stride(1) != 1:
        b = b.contiguous()
    tma = _tma_ok(a.data_ptr(), a.stride(0), a.shape[1],
                  b.data_ptr(), b.stride(0), b.shape[1])
    return a, b, "tma" if tma else "sync"


def _tma_ok(pa, lda, k, pb, ldb, n) -> bool:
    """bf16 operands at pa, pb with row strides lda, ldb (elements) and
    rows of k, n elements: 16-byte aligned, non-overlapping rows."""
    return ((pa | pb | (lda << 1) | (ldb << 1)) & 15) == 0 and lda >= k \
        and ldb >= n


def select_config(M: int, N: int, K: int,
                  dtype=torch.bfloat16) -> MatmulConfig:
    """Deterministic config oracle (PM2Lat's heuristic-API analogue).

    Prefers the largest feasible tiles with the least padding waste,
    skinny tiles for small M (decode).
    """
    best, best_score = None, None
    for c in CONFIGS:
        if c.smem_bytes(dtype) > SMEM_BUDGET:
            continue
        pm, pn, pk = (-M % c.bm), (-N % c.bn), (-K % c.bk)
        waste = ((M + pm) * (N + pn) * (K + pk)) / max(M * N * K, 1) - 1.0
        # fewer grid steps (bigger tiles) good; padding waste bad
        grid = ((M + pm) // c.bm) * ((N + pn) // c.bn) * ((K + pk) // c.bk)
        score = (waste * 4.0, grid, -c.bm * c.bn)
        if best is None or score < best_score:
            best, best_score = c, score
    return best


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 products and sums,
    result in the input type."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build.load("matmul")
    fn = lib.pm2lat_matmul
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3 + \
        [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def library_smem(config: MatmulConfig, dtype) -> int:
    """The dynamic shared memory the built library launches ``config``
    with in ``dtype`` (-1 if it has no such instance)."""
    lib = build.load("matmul")
    fn = lib.pm2lat_matmul_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(config.bm, config.bk, config.bn, DTYPES[dtype])


def library_blocks_per_sm(config: MatmulConfig) -> int:
    """Resident blocks per SM of the built float32 instance of ``config``,
    from the card's occupancy calculator (negative if it has none)."""
    lib = build.load("matmul")
    fn = lib.pm2lat_matmul_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(config.bm, config.bk, config.bn)


def matmul_kernel(a: torch.Tensor, b: torch.Tensor,
                  config: MatmulConfig) -> torch.Tensor:
    """a (M,K) @ b (K,N) -> (M,N) in a's type, f32 accumulation.  Any M, N,
    K and, in bf16, any row strides and alignment (``load_path``): the
    kernel masks ragged edges.  CUDA tensors launch the hand-written kernel
    (and count the launch); CPU tensors take the plain version."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_kernel: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"matmul_kernel: dtypes {a.dtype}, {b.dtype}; both "
                        f"must be one of {list(DTYPES)}")
    if config not in CONFIGS:
        raise ValueError(f"matmul_kernel: {config} is not in CONFIGS")
    if not (a.is_cuda and b.is_cuda):
        if a.device.type == "cpu" and b.device.type == "cpu":
            return matmul_plain(a, b)
        raise ValueError(f"matmul_kernel: tensors on {a.device} and {b.device}")
    if a.get_device() != b.get_device():
        raise ValueError(f"matmul_kernel: tensors on {a.device} and {b.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError("matmul_kernel has no backward kernel")
    a, b, path = _operands(a, b)
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    lib, fn = _entry()
    err = fn(config.bm, config.bk, config.bn, DTYPES[a.dtype],
             LOAD_PATHS[path], a.data_ptr(), b.data_ptr(), c.data_ptr(),
             M, N, K, a.stride(0), b.stride(0),
             torch._C._cuda_getCurrentRawStream(a.get_device()))
    build.check(err, lib, "matmul")
    matmul_kernel.launches += 1
    return c


matmul_kernel.launches = 0
