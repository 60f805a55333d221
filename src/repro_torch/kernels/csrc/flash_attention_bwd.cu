// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of online-
// softmax attention over (B, S, H, hd) tensors with GQA, causal (bottom-
// right aligned through q_offset), sliding-window and non-causal masks and
// any Sq, Skv.
//
// Replaces the JAX package's backward, src/repro/models/attention.py::
// _fa_bwd_scan behind the fused-kernel boundary _fa_bwd_fused (jnp there,
// not Pallas: the TPU kernel flash_attention_kernel has no backward).  The
// function is that scan's: with the forward's log-sum-exp lse of each row's
// scaled scores, P = exp(s + mask - lse) where s = (q k^T) / sqrt(hd) and
// the mask ADDS -1e30, D = rowsum(dO * O), dV = P^T dO, dP = dO V^T,
// dS = P (dP - D) / sqrt(hd), dQ = dS K, dK = dS^T Q; gradients in the
// input type.  Query head h reads KV head h / (H / Hkv), so dK and dV of a
// KV head sum over its G = H / Hkv query heads.
//
// Four passes, deterministic (no atomics: two launches give bit-equal
// gradients):
//   fa_bwd_prep_kernel  (lse, D) of every row into a (B, H, Sq64, 2) f32
//                       scratch, Sq64 = Sq rounded up to 64 (zeros past Sq),
//                       so a 64-row tile's pairs are one aligned 512-byte run;
//   dK/dV kernel        one block a (64 keys, batch, QUERY head): K and V
//                       stay in shared memory while the block walks the Q
//                       tiles that hold a kept pair; dK and dV accumulate in
//                       registers and go out as f32 partials (B, Skv, H,
//                       hd), or straight to dk and dv where G = 1;
//   fa_bwd_sum_kernel   each KV head's G partials summed in head order and
//                       rounded once to the input type (G > 1 only);
//   dQ kernel           one block a (64 query rows, batch, query head): Q,
//                       dO, lse and D stay in shared memory while the block
//                       walks the KV tiles that hold a kept pair; it
//                       recomputes S and dP (two products more than a
//                       design that shares dS through atomics).
// A block per query head puts B H Skv / 64 blocks on the card (896 at the
// train shape below, against 128 when a block summed its GQA group), and
// the blocks with the most tiles are launched first (KV tile 0 of the dK/dV
// pass, the last Q tile of the dQ pass).  A cluster of the group's blocks
// summing dK and dV through distributed shared memory, in place of the
// partials and the sum pass, measured 11 % slower in float32 and no faster
// in bf16 (PERF.md §6).
//
// Tile skip: tile_span() gives the [lo, hi) of the tiles a tile visits
// along the other axis: under the causal mask the Q tiles from the first
// whose last row reaches the KV tile's first key, and under a window up to
// the last whose first row still reaches its last key (the dQ pass takes
// the mirror image); non-causal visits every tile.  A row no key is kept
// for (qp < 0, or past every key's window) has P = 1 on every key under
// the additive mask, in the reference too, so a mask with such rows visits
// everything.  Masks are applied per element only in tiles that
// tile_unmasked() does not clear; rows past Sq (zero Q, dO, lse and D)
// and keys past Skv (zero K, V and the additive -1e30) add nothing.
// flash_attention_bwd.py::tile_range mirrors tile_span.
//
// bfloat16 (fa_bwd_dkdv_wgmma_kernel, fa_bwd_dq_wgmma_kernel): the tensor
// cores, one warpgroup of 128 threads a block, thread 0 also issuing TMA
// (rank-4 tensor maps over (B, S, H, hd), 64-row boxes, the 32-, 64- or
// 128-byte swizzle as the forward's) through a two-stage ring: the dK/dV
// kernel streams Q and dO tiles with their (lse, D) run (a 1-D bulk copy)
// past K and V; the dQ kernel streams K and V past Q and dO.  Per tile:
//   dK/dV: S^T = K Q^T, dP^T = V dO^T (wgmma, both operands in shared
//          memory, K-major); P^T = exp(S^T scale + mask - lse) and
//          dS^T = P^T (dP^T - D) scale in registers, rounded to bf16 as the
//          A fragments of dV += P^T dO and dK += dS^T Q (wgmma with A from
//          registers, dO and Q MN-major: the accumulator layout of S^T is
//          the A layout, as the forward's P is);
//   dQ:    S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K (K MN-major).
// Sums are f32; only P and dS are rounded (to bf16), and each gradient
// once, at its store.
//
// float32 (fa_bwd_dkdv_ffma_kernel, fa_bwd_dq_ffma_kernel): true f32 FFMA
// on the CUDA cores (no TF32, no tensor-core op).  256 threads in a 16 x
// 16 grid; thread (ty, tx) owns rows ty*4 + {0..3} and key columns tx + 16 c
// (c < 4) of each 64 x 64 score tile, and the same rows by hd/16 columns of
// a [64, hd] gradient tile: OG groups of OV = min(hd/16, 4) neighbours,
// g (hd/OG) + tx OV + {0..OV-1}.  Rows of the [rows][hd] tiles are padded by
// 4 floats, so the 16 lanes of a half warp that read rows tx + 16 c hit 32
// banks.  Tiles come by cp.async: the dK/dV kernel keeps two Q stages (Q is
// read first and last in a tile) and one dO, whose next copy is issued once
// dP^T and dV are done; the dQ kernel two K stages and one V the same way.
// P and dS share one staging tile in turn.  Up to hd 64 a block fits
// 128 registers a thread and 106 KB of shared memory: two blocks an SM.
//
// hd 256 (recurrentgemma-2b's local attention): one warpgroup cannot hold
// dK and dV (256 f32 registers a thread before S^T and dP^T), and the
// float32 kernels' five [64][260] tiles are 351 KB.  So each tile kernel
// runs two blocks a tile (grid z), each owning half the gradient's columns
// and computing the scores over the whole head itself: the bf16 blocks keep
// hd 128's accumulators (64 + 64 registers) beside the full [64][256] tiles
// (199 KB at two stages, one block an SM) and run dV, dK and dQ as n128
// wgmmas on their half; the float32 blocks (dkdv_ffma_wide, dq_ffma_wide)
// sum the scores over 64-column chunks of K, V, Q and dO copied in turn and
// keep only their half of the gradient's other operand (155 and 121 KB).
// Each half's block recomputes S and dP: the dK/dV kernel does six
// products' worth a tile, the dQ kernel five (visited_work).
//
// What bounds it on the H100 (qwen2-0.5b at B 8, S 512, 14 query and 2 KV
// heads at hd 64, causal): the five products over the pairs the mask keeps
// are 10 hd flops a pair and head, 9.4 GFLOP: 0.0095 ms at 989 TFLOP/s of
// bf16 (under the bytes: q, k, v, o, dO, dQ, dK, dV and lse once, 33.8
// MB, 0.0101 ms) and 0.140 ms at 67 TFLOP/s of f32 FFMA.  The kernels do
// seven products over the visited tiles (36 of each head's 64 tile pairs),
// 14.8 GFLOP, and move the f32 partials (2 x 14.7 MB, written and read).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "simt.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int TILE = 64;

// ------------------------------------------------------------ tile bounds

struct Span {
  int lo, hi;
};

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ __forceinline__ int clamp_to(int x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

// The tiles that tile t visits along the other axis, [lo, hi): axis 0, t is
// a KV tile and the span is of Q tiles (the dK/dV pass); axis 1, t is a Q
// tile and the span is of KV tiles (the dQ pass).  Every pair the mask
// keeps lies in a visited tile, every skipped tile holds none.
__host__ __device__ __forceinline__ Span tile_span(int t, int axis, int Sq, int Skv,
                                                   int causal, int window,
                                                   int q_offset) {
  const int n = axis == 0 ? (Sq + TILE - 1) / TILE : (Skv + TILE - 1) / TILE;
  const int o = q_offset;
  // rows no key is kept for: qp < 0, or qp - (Skv - 1) >= window
  const bool dead = o < 0 || (window > 0 && o + Sq - 1 > Skv - 2 + window);
  if (!causal || dead) return {0, n};
  int lo, hi;
  if (axis == 0) {
    const int k0 = t * TILE, k1 = k0 + TILE < Skv ? k0 + TILE : Skv;
    // the first row that reaches key k0, and the last in reach of key k1 - 1
    lo = clamp_to(floor_div(k0 - o, TILE), 0, n);
    if (lo < n && o + (lo * TILE + TILE < Sq ? lo * TILE + TILE : Sq) - 1 < k0) lo = n;
    hi = window > 0 ? clamp_to(floor_div(k1 - 2 + window - o, TILE) + 1, 0, n) : n;
  } else {
    const int q0 = t * TILE, q1 = q0 + TILE < Sq ? q0 + TILE : Sq;
    // the last key row q1 - 1 keeps, and the first key row q0 reaches
    hi = clamp_to(floor_div(o + q1 - 1, TILE) + 1, 0, n);
    lo = 0;
    if (window > 0) {
      const int first = o + q0 - window + 1;
      lo = clamp_to(floor_div(first, TILE), 0, n);
      if (lo < n && (lo * TILE + TILE < Skv ? lo * TILE + TILE : Skv) - 1 < first) lo = n;
    }
  }
  return {lo, hi > lo ? hi : lo};
}

// Whether every pair of the tile (rows q0.., keys k0..) is kept, so that
// no element needs its mask.
__device__ __forceinline__ bool tile_unmasked(int q0, int k0, int Skv, int causal,
                                              int window, int q_offset) {
  if (k0 + TILE > Skv) return false;
  if (!causal) return true;
  return q_offset + q0 - (k0 + TILE - 1) >= 0 &&
         (window <= 0 || q_offset + q0 + TILE - 1 - k0 < window);
}

__device__ __forceinline__ bool keep(int qp, int kp, int Skv, int causal, int window) {
  bool k = kp < Skv;
  if (causal) {
    k = k && qp >= kp;
    if (window > 0) k = k && (qp - kp) < window;
  }
  return k;
}

// Eight consecutive elements at p (16- or 32-byte aligned) as f32.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = simt::ld4(p), b = simt::ld4(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Four f32 values into four consecutive elements at p.
__device__ __forceinline__ void store4(float* p, float4 v) { simt::st4(p, v); }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// ------------------------------------------------------- passes 1 and 3

constexpr int PASS_THREADS = 256;

// HD / 8 threads a row (b, q, h), eight elements each: D = sum dO * O in
// f32, written with the row's lse as LD[b, h, q] = (lse, D); rows q in
// [Sq, Sq64) get (0, 0).
template <typename T, int HD>
__global__ void __launch_bounds__(PASS_THREADS)
fa_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ LD, int B,
                   int H, int Sq, int Sq64) {
  constexpr int TPR = HD / 8;
  const long long idx = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
  const long long row = idx / TPR;
  const int part = (int)(idx % TPR);
  // no early exit: the shuffles below take every lane of the warp
  const bool live = row < (long long)B * Sq64 * H;
  const int h = (int)(row % H), q = (int)((row / H) % Sq64), b = (int)(row / ((long long)H * Sq64));
  float acc = 0.f;
  if (live && q < Sq) {
    const size_t off = (((size_t)b * Sq + q) * H + h) * HD + part * 8;
    float x[8], y[8];
    load8(dout + off, x);
    load8(o + off, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(x[i], y[i], acc);
  }
#pragma unroll
  for (int m = TPR / 2; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (live && part == 0) {
    const size_t bh = (size_t)b * H + h;
    const float l = q < Sq ? lse[bh * Sq + q] : 0.f;
    *reinterpret_cast<float2*>(LD + (bh * Sq64 + q) * 2) = make_float2(l, acc);
  }
}

// dk, dv (B, Skv, Hkv, HD) from the f32 partials (B, Skv, H, HD) of dK
// (part) and dV (part + n_part): each KV head's G query heads summed in
// head order, four elements a thread.
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
fa_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
                  long long n4, long long n_part, int Hkv, int G, int HD) {
  const long long idx = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (idx >= n4) return;
  const long long e = idx * 4;
  const int d = (int)(e % HD);
  const long long rest = e / HD;            // (b * Skv + key) * Hkv + hk
  const long long bk = rest / Hkv;
  const int hk = (int)(rest % Hkv);
  const float* src = part + ((size_t)bk * Hkv * G + (size_t)hk * G) * HD + d;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int g = 0; g < G; ++g) {
    const float4 a = simt::ld4(src + (size_t)g * HD);
    const float4 c = simt::ld4(src + n_part + (size_t)g * HD);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  store4(dk + e, sk);
  store4(dv + e, sv);
}

// ------------------------------------------------------------- bfloat16

template <int HD>
struct BwdWgmma {
  static constexpr int CH = HD < 64 ? HD : 64;     // column chunk (elements)
  static constexpr int SW = CH * 2;                // swizzle bytes
  static constexpr int TB = TILE * HD * 2;         // bytes of a [64][HD] tile
  static constexpr int LDB = TILE * 8;             // bytes of 64 rows' (lse, D)
  static constexpr int ST = 2;                     // ring stages
  static constexpr int THREADS = 128;
  // gradient columns a block owns: the whole head up to hd 128; at hd 256
  // half of it (NH = 2 blocks a tile, each with hd 128's 64 + 64 f32
  // accumulators a thread, each computing the scores over the whole head)
  static constexpr int NH = HD > 128 ? 2 : 1;
  static constexpr int N = HD / NH;
  // bytes from a [64][HD] tile's start to column N (whole chunks)
  static constexpr uint32_t HALF_BYTES = (N / CH) * TILE * CH * 2;
  // 1024 bytes of slack to align the tiles, 256 for the barriers.
  // dK/dV: K, V; per stage Q, dO and (lse, D).  dQ: Q, dO; per stage K, V.
  static constexpr size_t SMEM_DKDV = 1024 + (size_t)(2 + 2 * ST) * TB + ST * LDB + 256;
  static constexpr size_t SMEM_DQ = 1024 + (size_t)(2 + 2 * ST) * TB + 256;
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128 || HD == 256,
                "bad head dim");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~uintptr_t(1023));
}

// acc[64 x 64] = A B^T over HD for two [64][HD] K-major tiles at a and b
// (one of S^T = K Q^T, dP^T = V dO^T, S = Q K^T, dP = dO V^T).  Issued, not
// waited for.
template <int HD>
__device__ __forceinline__ void wgmma_scores(float* acc, uint32_t a, uint32_t b) {
  using S = BwdWgmma<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = (kk * 16) / S::CH, wo = (kk * 16) % S::CH;
    const uint32_t off = c * TILE * S::CH * 2 + wo * 2;
    hopper::wgmma_ss<64, 0>(acc, hopper::make_desc<S::SW>(a + off, 16, 8 * S::CH * 2),
                            hopper::make_desc<S::SW>(b + off, 16, 8 * S::CH * 2));
  }
}

// acc[64 x N] += A B over 64 rows: A the bf16 fragments a[4][4] (the
// accumulator layout of a 64 x 64 score tile), B the N columns of a
// [64][HD] tile at b (a column half's start, HALF_BYTES apart) read MN-major.
// Issued, not waited for.
template <int HD>
__device__ __forceinline__ void wgmma_grad(float* acc, const uint32_t (&a)[4][4],
                                           uint32_t b) {
  using S = BwdWgmma<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_rs<S::N, 1>(acc, a[kk],
                            hopper::make_desc<S::SW>(b + kk * 16 * S::CH * 2,
                                                     TILE * S::CH * 2, 8 * S::CH * 2));
}

// One K / V (or Q / dO) tile of 64 rows into the swizzled chunks at dst.
template <int HD>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int row0, int b) {
  using S = BwdWgmma<HD>;
#pragma unroll
  for (int c = 0; c < HD / S::CH; ++c)
    hopper::tma_load_4d(hopper::smem_u32(dst + c * TILE * S::CH * 2), map, bar, c * S::CH,
                        head, row0, b);
}

// dK and dV of 64 keys (KV tile blockIdx.y) of one (batch, query head
// blockIdx.x), columns [N blockIdx.z, N blockIdx.z + N), over the Q tiles
// tile_span gives: f32 partials into part (dK) and part + n_part (dV), or
// bf16 into dk, dv where part is null.
template <int HD>
__global__ void __launch_bounds__(BwdWgmma<HD>::THREADS)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ LD, float* __restrict__ part,
                         long long n_part, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
                         int causal, int window, int q_offset, float scale) {
  using S = BwdWgmma<HD>;
  using namespace hopper;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sk = smem;
  uint8_t* sv = smem + S::TB;
  auto sq = [&](int s) { return smem + (2 + 2 * s) * S::TB; };
  auto sdo = [&](int s) { return smem + (3 + 2 * s) * S::TB; };
  auto sld = [&](int s) {
    return reinterpret_cast<float*>(smem + (2 + 2 * S::ST) * S::TB + s * S::LDB);
  };
  const uint32_t bars = smem_u32(smem + (2 + 2 * S::ST) * S::TB + S::ST * S::LDB);
  const uint32_t kvfull = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S::ST + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int j = blockIdx.y, k0 = j * TILE;
  const int half = blockIdx.z, c0 = half * S::N;
  const int Sq64 = (Sq + TILE - 1) / TILE * TILE;
  const Span sp = tile_span(j, 0, Sq, Skv, causal, window, q_offset);
  const int n = sp.hi - sp.lo;

  if (tid == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < S::ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), S::THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Q tile sp.lo + it with its dO tile and (lse, D) run into stage it % ST.
  auto issue = [&](int it) {
    const int s = it % S::ST, q0 = (sp.lo + it) * TILE;
    mbar_expect_tx(full(s), 2 * S::TB + S::LDB);
    tma_tile<HD>(sq(s), &map_q, full(s), h, q0, b);
    tma_tile<HD>(sdo(s), &map_do, full(s), h, q0, b);
    bulk_load(smem_u32(sld(s)), LD + ((size_t)bh * Sq64 + q0) * 2, S::LDB, full(s));
  };
  if (tid == 0 && n > 0) {
    mbar_expect_tx(kvfull, 2 * S::TB);
    tma_tile<HD>(sk, &map_k, kvfull, hk, k0, b);
    tma_tile<HD>(sv, &map_v, kvfull, hk, k0, b);
    for (int it = 0; it < S::ST && it < n; ++it) issue(it);
  }

  const int w = (tid % 128) / 32, l = tid % 32;
  const int key0 = 16 * w + l / 4;         // this thread's keys key0, key0 + 8
  float dka[S::N / 2], dva[S::N / 2];
#pragma unroll
  for (int i = 0; i < S::N / 2; ++i) dka[i] = dva[i] = 0.f;
  if (n > 0) mbar_wait(kvfull, 0);
  const uint32_t k_base = smem_u32(sk), v_base = smem_u32(sv);

  for (int it = 0; it < n; ++it) {
    const int s = it % S::ST;
    const uint32_t parity = (it / S::ST) & 1;
    const int q0 = (sp.lo + it) * TILE;
    mbar_wait(full(s), parity);
    const uint32_t q_base = smem_u32(sq(s)), do_base = smem_u32(sdo(s));

    // S^T = K Q^T and dP^T = V dO^T (keys x queries).
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs<32>(st);
    fence_regs<32>(dpt);
    wgmma_fence();
    wgmma_scores<HD>(st, k_base, q_base);
    wgmma_scores<HD>(dpt, v_base, do_base);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(st);
    fence_regs<32>(dpt);

    // P^T and dS^T, column (query) by column, rounded to bf16 A fragments.
    // d[4jj + e]: key key0 + 8 (e / 2), query 8 jj + 2 (l % 4) + e % 2.
    const bool unmasked = tile_unmasked(q0, k0, Skv, causal, window, q_offset);
    const float* ld = sld(s);
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * jj + 2 * (l % 4);
      const float4 a = simt::ld4(ld + 2 * col);   // (lse, D) of queries col, col + 1
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse = (e & 1) ? a.z : a.x, dd = (e & 1) ? a.w : a.y;
        float x = st[4 * jj + e] * scale;
        if (!unmasked && !keep(q_offset + q0 + col + (e & 1), k0 + key0 + 8 * (e >> 1), Skv,
                               causal, window))
          x += kNegInf;
        p[e] = exp2f((x - lse) * kLog2e);
        ds[e] = p[e] * (dpt[4 * jj + e] - dd) * scale;
      }
      pa[jj / 2][(jj % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[jj / 2][(jj % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO, dK += dS^T Q (this block's columns of dO and Q).
    fence_regs<S::N / 2>(dva);
    fence_regs<S::N / 2>(dka);
    wgmma_fence();
    wgmma_grad<HD>(dva, pa, do_base + half * S::HALF_BYTES);
    wgmma_grad<HD>(dka, dsa, q_base + half * S::HALF_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<S::N / 2>(dva);
    fence_regs<S::N / 2>(dka);
    mbar_arrive(empty(s));
    // refill this stage once every thread is done with it
    if (tid == 0 && it + S::ST < n) {
      mbar_wait(empty(s), parity);
      issue(it + S::ST);
    }
  }

  // d[4jj + 2hh + {0, 1}]: key key0 + 8 hh, columns c0 + 8 jj + 2 (l % 4) + {0, 1}.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + key0 + 8 * hh;
    if (key >= Skv) continue;
    if (part != nullptr) {
      float* pk = part + (((size_t)b * Skv + key) * H + h) * HD;
#pragma unroll
      for (int jj = 0; jj < S::N / 8; ++jj) {
        const int col = c0 + 8 * jj + 2 * (l % 4);
        *reinterpret_cast<float2*>(pk + col) =
            make_float2(dka[4 * jj + 2 * hh], dka[4 * jj + 2 * hh + 1]);
        *reinterpret_cast<float2*>(pk + n_part + col) =
            make_float2(dva[4 * jj + 2 * hh], dva[4 * jj + 2 * hh + 1]);
      }
    } else {
      const size_t row = (((size_t)b * Skv + key) * Hkv + hk) * HD;
#pragma unroll
      for (int jj = 0; jj < S::N / 8; ++jj) {
        const int col = c0 + 8 * jj + 2 * (l % 4);
        *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
            __floats2bfloat162_rn(dka[4 * jj + 2 * hh], dka[4 * jj + 2 * hh + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
            __floats2bfloat162_rn(dva[4 * jj + 2 * hh], dva[4 * jj + 2 * hh + 1]);
      }
    }
  }
}

// dQ of 64 query rows (Q tile gridDim.y - 1 - blockIdx.y) of one (batch,
// query head blockIdx.x), columns [N blockIdx.z, N blockIdx.z + N), over
// the KV tiles tile_span gives.
template <int HD>
__global__ void __launch_bounds__(BwdWgmma<HD>::THREADS)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ LD, __nv_bfloat16* __restrict__ dq,
                       int H, int Hkv, int Sq, int Skv, int causal, int window,
                       int q_offset, float scale) {
  using S = BwdWgmma<HD>;
  using namespace hopper;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sq = smem;
  uint8_t* sdo = smem + S::TB;
  auto sk = [&](int s) { return smem + (2 + 2 * s) * S::TB; };
  auto sv = [&](int s) { return smem + (3 + 2 * s) * S::TB; };
  const uint32_t bars = smem_u32(smem + (2 + 2 * S::ST) * S::TB);
  const uint32_t qfull = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S::ST + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int i = gridDim.y - 1 - blockIdx.y, q0 = i * TILE;
  const int half = blockIdx.z, c0 = half * S::N;
  const int Sq64 = (Sq + TILE - 1) / TILE * TILE;
  const Span sp = tile_span(i, 1, Sq, Skv, causal, window, q_offset);
  const int n = sp.hi - sp.lo;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < S::ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), S::THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto issue = [&](int it) {
    const int s = it % S::ST, k0 = (sp.lo + it) * TILE;
    mbar_expect_tx(full(s), 2 * S::TB);
    tma_tile<HD>(sk(s), &map_k, full(s), hk, k0, b);
    tma_tile<HD>(sv(s), &map_v, full(s), hk, k0, b);
  };
  if (tid == 0 && n > 0) {
    mbar_expect_tx(qfull, 2 * S::TB);
    tma_tile<HD>(sq, &map_q, qfull, h, q0, b);
    tma_tile<HD>(sdo, &map_do, qfull, h, q0, b);
    for (int it = 0; it < S::ST && it < n; ++it) issue(it);
  }

  const int w = (tid % 128) / 32, l = tid % 32;
  const int row0 = 16 * w + l / 4;          // this thread's rows row0, row0 + 8
  const float* ld = LD + ((size_t)bh * Sq64 + q0 + row0) * 2;
  const float2 ld0 = *reinterpret_cast<const float2*>(ld);
  const float2 ld1 = *reinterpret_cast<const float2*>(ld + 16);
  float dqa[S::N / 2];
#pragma unroll
  for (int x = 0; x < S::N / 2; ++x) dqa[x] = 0.f;
  if (n > 0) mbar_wait(qfull, 0);
  const uint32_t q_base = smem_u32(sq), do_base = smem_u32(sdo);

  for (int it = 0; it < n; ++it) {
    const int s = it % S::ST;
    const uint32_t parity = (it / S::ST) & 1;
    const int k0 = (sp.lo + it) * TILE;
    mbar_wait(full(s), parity);
    const uint32_t k_base = smem_u32(sk(s)), v_base = smem_u32(sv(s));

    // S = Q K^T and dP = dO V^T (queries x keys).
    float sc[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
    fence_regs<32>(sc);
    fence_regs<32>(dp);
    wgmma_fence();
    wgmma_scores<HD>(sc, q_base, k_base);
    wgmma_scores<HD>(dp, do_base, v_base);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sc);
    fence_regs<32>(dp);

    // dS, rounded to bf16 A fragments.  d[4jj + e]: row row0 + 8 (e / 2),
    // key 8 jj + 2 (l % 4) + e % 2.
    const bool unmasked = tile_unmasked(q0, k0, Skv, causal, window, q_offset);
    uint32_t dsa[4][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 r = (e >> 1) ? ld1 : ld0;
        float x = sc[4 * jj + e] * scale;
        if (!unmasked && !keep(q_offset + q0 + row0 + 8 * (e >> 1),
                               k0 + 8 * jj + 2 * (l % 4) + (e & 1), Skv, causal, window))
          x += kNegInf;
        const float p = exp2f((x - r.x) * kLog2e);
        ds[e] = p * (dp[4 * jj + e] - r.y) * scale;
      }
      dsa[jj / 2][(jj % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K (this block's columns of K).
    fence_regs<S::N / 2>(dqa);
    wgmma_fence();
    wgmma_grad<HD>(dqa, dsa, k_base + half * S::HALF_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<S::N / 2>(dqa);
    mbar_arrive(empty(s));
    if (tid == 0 && it + S::ST < n) {
      mbar_wait(empty(s), parity);
      issue(it + S::ST);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qr = q0 + row0 + 8 * hh;
    if (qr >= Sq) continue;
    __nv_bfloat16* row = dq + (((size_t)b * Sq + qr) * H + h) * HD;
#pragma unroll
    for (int jj = 0; jj < S::N / 8; ++jj) {
      const int col = c0 + 8 * jj + 2 * (l % 4);
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(dqa[4 * jj + 2 * hh], dqa[4 * jj + 2 * hh + 1]);
    }
  }
}

// -------------------------------------------------------------- float32

template <int HD>
struct BwdFfma {
  static constexpr int THREADS = 256, TX = 16;
  static constexpr int LDT = HD + 4;           // padded row of a [64][HD] tile
  static constexpr int LP = TILE + 4;          // padded row of a score tile
  static constexpr int OC = HD / TX;           // gradient columns a thread owns
  static constexpr int OV = OC < 4 ? OC : 4;   // their vector width
  static constexpr int OG = OC / OV;           // and groups, HD / OG apart
  static constexpr int T = TILE * LDT;         // floats of a [64][HD] tile
  static constexpr int SC = TILE * LP;         // floats of a score tile
  // Past hd 128 (hd 256) five [64][HD] tiles pass 227 KB and the dK and dV
  // accumulators 128 registers a thread: the wide kernels.  A block owns
  // GD = HD / 2 gradient columns (two blocks a tile) and sums the scores
  // over the head in CW-column chunks of K, V, Q and dO copied in turn.
  static constexpr bool WIDE = HD > 128;
  static constexpr int NH = WIDE ? 2 : 1;
  static constexpr int GD = HD / NH;
  static constexpr int CW = 64;
  // floats of the four [64][CW + 4] chunk tiles and of a [64][GD + 4] tile
  static constexpr int CHUNKS = 4 * TILE * (CW + 4), TG = TILE * (GD + 4);
  // dK/dV: K, V, two Q stages, dO, the score tile (P, then dS), (lse, D)
  // of two Q tiles.  dQ: Q, dO, two K stages, V, dS^T, (lse, D).  Wide:
  // the chunks; dK/dV's GD columns of Q and dO, dQ's of K; the score
  // tile; (lse, D) of one Q tile.
  static constexpr size_t SMEM_DKDV = 4 * (size_t)(WIDE ? CHUNKS + 2 * TG + SC + 2 * TILE
                                                        : 5 * T + SC + 2 * 2 * TILE);
  static constexpr size_t SMEM_DQ = 4 * (size_t)(WIDE ? CHUNKS + TG + SC + 2 * TILE
                                                      : 5 * T + SC + 2 * TILE);
  // two blocks an SM where 128 registers a thread hold the accumulators
  static constexpr int MIN_BLOCKS = HD <= 64 ? 2 : 1;
  static_assert(HD % 16 == 0 && (OC == 1 || OC == 2 || OC % 4 == 0),
                "head dim 16, 32 or a multiple of 64");
};

// rows [r0, r0 + 64) of a (rows, heads, HD) f32 slab at src (row stride
// `stride` floats, head offset applied) into dst [64][LDT] by 16-byte
// cp.async, zeros past row n.
template <int HD>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, size_t stride,
                                          int r0, int n, int tid) {
  using S = BwdFfma<HD>;
  for (int e = tid; e < TILE * HD / 4; e += S::THREADS) {
    const int r = e / (HD / 4), c = 4 * (e % (HD / 4));
    const bool ok = r0 + r < n;
    simt::cp_async16(dst + r * S::LDT + c, ok ? src + (size_t)(r0 + r) * stride + c : src, ok);
  }
}

// the (lse, D) run of 64 rows (128 floats, 16-byte aligned) into dst
__device__ __forceinline__ void copy_ld(float* dst, const float* src, int tid) {
  if (tid < 2 * TILE / 4) simt::cp_async16(dst + 4 * tid, src + 4 * tid, true);
}

// acc[r][c] += sum_d A[ty*4 + r][d] * B[tx + 16 c][d] over the HD columns
// of two [64][LDT] tiles: one of the score products (S = Q K^T, dP = dO
// V^T), or a chunk of its columns.
template <int HD>
__device__ __forceinline__ void score_acc(float (&acc)[4][4], const float* A,
                                          const float* Bm, int ty, int tx) {
  constexpr int LDT = BwdFfma<HD>::LDT, TX = BwdFfma<HD>::TX;
  // unrolled twice from hd 64; once below, where ptxas spills at 128
  // registers otherwise (the dK/dV kernel at hd 32)
#pragma unroll (HD >= 64 ? 2 : 1)
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = simt::ld4(A + (ty * 4 + r) * LDT + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = simt::ld4(Bm + (tx + TX * c) * LDT + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
      }
  }
}

__device__ __forceinline__ void zero_tile(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// acc = the score product over the HD columns (score_acc from zero).
template <int HD>
__device__ __forceinline__ void score_tile(float (&acc)[4][4], const float* A,
                                           const float* Bm, int ty, int tx) {
  zero_tile(acc);
  score_acc<HD>(acc, A, Bm, ty, tx);
}

// P and dS of one 64 x 64 tile (rows ty*4 + r, keys tx + 16 c) from S, dP
// (unscaled) and the rows' (lse, D) at ld: p = exp(s scale + mask - lse),
// ds = p (dp - D) scale, in place.
__device__ __forceinline__ void softmax_grad(float (&s)[4][4], float (&dp)[4][4],
                                             const float* ld, int q0, int k0, int ty,
                                             int tx, int Skv, int causal, int window,
                                             int q_offset, float scale, bool unmasked) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = ty * 4 + r;
    const float2 a = *reinterpret_cast<const float2*>(ld + 2 * qi);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float x = s[r][c] * scale;
      if (!unmasked && !keep(q_offset + q0 + qi, k0 + tx + 16 * c, Skv, causal, window))
        x += kNegInf;
      const float p = expf(x - a.x);
      s[r][c] = p;
      dp[r][c] = p * (dp[r][c] - a.y) * scale;
    }
  }
}

// acc[r][j] += sum_i W[i][ty*4 + r] X[i][cols(j)] over the 64 rows i of a
// score tile W [64][LP] and a [64][LDT] tile X: dV += P^T dO, dK += dS^T Q
// and dQ += dS K.
template <int HD>
__device__ __forceinline__ void grad_tile(float (&acc)[4][BwdFfma<HD>::OC], const float* W,
                                          const float* X, int ty, int tx) {
  using S = BwdFfma<HD>;
  constexpr int OC = S::OC, OV = S::OV, OG = S::OG;
#pragma unroll 2
  for (int i = 0; i < TILE; ++i) {
    const float4 w4 = simt::ld4(W + i * S::LP + ty * 4);
    float xv[OC];
#pragma unroll
    for (int g = 0; g < OG; ++g)
      simt::ldv<OV>(X + i * S::LDT + g * (HD / OG) + tx * OV, xv + g * OV);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float wr = simt::lane(w4, r);
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[r][c] = fmaf(wr, xv[c], acc[r][c]);
    }
  }
}

// acc rows ty*4 + r (of 64 from row r0, fewer than n) into (rows, heads,
// HD) at dst (row stride `stride`, head offset applied).
template <int HD>
__device__ __forceinline__ void store_rows(float* dst, size_t stride,
                                           const float (&acc)[4][BwdFfma<HD>::OC], int r0,
                                           int n, int ty, int tx) {
  using S = BwdFfma<HD>;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= n) continue;
#pragma unroll
    for (int g = 0; g < S::OG; ++g)
      simt::stv<S::OV>(dst + (size_t)row * stride + g * (HD / S::OG) + tx * S::OV,
                       acc[r] + g * S::OV);
  }
}

// dK and dV of 64 keys (KV tile blockIdx.y) of one (batch, query head
// blockIdx.x) over the Q tiles tile_span gives, into (B, Skv, Hout, HD) at
// dk and dv (the f32 partials, Hout = H, or the outputs, Hout = Hkv).
template <int HD>
__device__ __forceinline__ void dkdv_ffma(const float* __restrict__ q,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const float* __restrict__ dout,
                                          const float* __restrict__ LD, float* __restrict__ dk,
                                          float* __restrict__ dv, int Hout, int H, int Hkv,
                                          int Sq, int Skv, int causal, int window,
                                          int q_offset, float scale) {
  using S = BwdFfma<HD>;
  constexpr int LP = S::LP, OC = S::OC;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + S::T;
  float* Qs = Vs + S::T;                     // two stages
  float* dOs = Qs + 2 * S::T;
  float* Ss = dOs + S::T;                    // P [query][key], then dS
  float* lds = Ss + S::SC;                   // two stages of (lse, D)

  const int tid = threadIdx.x, tx = tid % S::TX, ty = tid / S::TX;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int j = blockIdx.y, k0 = j * TILE;
  const int Sq64 = (Sq + TILE - 1) / TILE * TILE;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  const float* qh = q + (size_t)b * Sq * q_row + (size_t)h * HD;
  const float* doh = dout + (size_t)b * Sq * q_row + (size_t)h * HD;
  const size_t kv_off = (size_t)b * Skv * kv_row + (size_t)hk * HD;
  const float* ldh = LD + (size_t)bh * Sq64 * 2;
  const Span sp = tile_span(j, 0, Sq, Skv, causal, window, q_offset);
  const int n = sp.hi - sp.lo;

  float dka[4][OC], dva[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) dka[r][c] = dva[r][c] = 0.f;

  if (n > 0) {
    copy_tile<HD>(Ks, k + kv_off, kv_row, k0, Skv, tid);
    copy_tile<HD>(Vs, v + kv_off, kv_row, k0, Skv, tid);
    copy_tile<HD>(Qs, qh, q_row, sp.lo * TILE, Sq, tid);
    copy_tile<HD>(dOs, doh, q_row, sp.lo * TILE, Sq, tid);
    copy_ld(lds, ldh + (size_t)sp.lo * TILE * 2, tid);
  }
  simt::cp_async_commit();

  for (int it = 0; it < n; ++it) {
    const int cur = it & 1, q0 = (sp.lo + it) * TILE;
    float* Qc = Qs + cur * S::T;
    const float* ldc = lds + cur * 2 * TILE;
    simt::cp_async_wait<0>();
    __syncthreads();                 // tile it landed; every thread is done with it - 1
    if (it + 1 < n) {                // Q's next copy overlaps this whole tile
      copy_tile<HD>(Qs + (cur ^ 1) * S::T, qh, q_row, q0 + TILE, Sq, tid);
      copy_ld(lds + (cur ^ 1) * 2 * TILE, ldh + (size_t)(q0 + TILE) * 2, tid);
    }
    simt::cp_async_commit();

    float s[4][4], dp[4][4];
    score_tile<HD>(s, Qc, Ks, ty, tx);
    score_tile<HD>(dp, dOs, Vs, ty, tx);
    softmax_grad(s, dp, ldc, q0, k0, ty, tx, Skv, causal, window, q_offset, scale,
                 tile_unmasked(q0, k0, Skv, causal, window, q_offset));
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ss[(ty * 4 + r) * LP + tx + S::TX * c] = s[r][c];
    __syncthreads();
    grad_tile<HD>(dva, Ss, dOs, ty, tx);     // dV[key][d] += sum_q P[q][key] dO[q][d]
    __syncthreads();                         // every thread is done with P and dO
    if (it + 1 < n) copy_tile<HD>(dOs, doh, q_row, q0 + TILE, Sq, tid);
    simt::cp_async_commit();                 // dO's next copy overlaps dK
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ss[(ty * 4 + r) * LP + tx + S::TX * c] = dp[r][c];
    __syncthreads();
    grad_tile<HD>(dka, Ss, Qc, ty, tx);      // dK[key][d] += sum_q dS[q][key] Q[q][d]
  }
  simt::cp_async_wait<0>();                  // nothing in flight at exit

  const size_t out_row = (size_t)Hout * HD;
  const size_t out_off = (size_t)b * Skv * out_row + (size_t)(Hout == H ? h : hk) * HD;
  store_rows<HD>(dk + out_off, out_row, dka, k0, Skv, ty, tx);
  store_rows<HD>(dv + out_off, out_row, dva, k0, Skv, ty, tx);
}

// dQ of 64 query rows (Q tile gridDim.y - 1 - blockIdx.y) of one (batch,
// query head blockIdx.x) over the KV tiles tile_span gives.
template <int HD>
__device__ __forceinline__ void dq_ffma(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ LD, float* __restrict__ dq,
                                        int H, int Hkv, int Sq, int Skv, int causal,
                                        int window, int q_offset, float scale) {
  using S = BwdFfma<HD>;
  constexpr int LP = S::LP, OC = S::OC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + S::T;
  float* Ks = dOs + S::T;                    // two stages
  float* Vs = Ks + 2 * S::T;
  float* dST = Vs + S::T;                    // dS^T [key][query]
  float* lds = dST + S::SC;

  const int tid = threadIdx.x, tx = tid % S::TX, ty = tid / S::TX;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int i = gridDim.y - 1 - blockIdx.y, q0 = i * TILE;
  const int Sq64 = (Sq + TILE - 1) / TILE * TILE;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * HD;
  const float* kh = k + (size_t)b * Skv * kv_row + (size_t)hk * HD;
  const float* vh = v + (size_t)b * Skv * kv_row + (size_t)hk * HD;
  const Span sp = tile_span(i, 1, Sq, Skv, causal, window, q_offset);
  const int n = sp.hi - sp.lo;

  float dqa[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) dqa[r][c] = 0.f;

  if (n > 0) {
    copy_tile<HD>(Qs, q + q_off, q_row, q0, Sq, tid);
    copy_tile<HD>(dOs, dout + q_off, q_row, q0, Sq, tid);
    copy_ld(lds, LD + ((size_t)bh * Sq64 + q0) * 2, tid);
    copy_tile<HD>(Ks, kh, kv_row, sp.lo * TILE, Skv, tid);
    copy_tile<HD>(Vs, vh, kv_row, sp.lo * TILE, Skv, tid);
  }
  simt::cp_async_commit();

  for (int it = 0; it < n; ++it) {
    const int cur = it & 1, k0 = (sp.lo + it) * TILE;
    float* Kc = Ks + cur * S::T;
    simt::cp_async_wait<0>();
    __syncthreads();                 // tile it landed; every thread is done with it - 1
    if (it + 1 < n) copy_tile<HD>(Ks + (cur ^ 1) * S::T, kh, kv_row, k0 + TILE, Skv, tid);
    simt::cp_async_commit();         // K's next copy overlaps this whole tile

    float s[4][4], dp[4][4];
    score_tile<HD>(s, Qs, Kc, ty, tx);
    score_tile<HD>(dp, dOs, Vs, ty, tx);
    softmax_grad(s, dp, lds, q0, k0, ty, tx, Skv, causal, window, q_offset, scale,
                 tile_unmasked(q0, k0, Skv, causal, window, q_offset));
    __syncthreads();                 // every thread is done with V
    if (it + 1 < n) copy_tile<HD>(Vs, vh, kv_row, k0 + TILE, Skv, tid);
    simt::cp_async_commit();         // V's next copy overlaps dQ
#pragma unroll
    for (int c = 0; c < 4; ++c)
      simt::st4(dST + (tx + S::TX * c) * LP + ty * 4,
                make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]));
    __syncthreads();
    grad_tile<HD>(dqa, dST, Kc, ty, tx);     // dQ[q][d] += sum_key dS[q][key] K[key][d]
  }
  simt::cp_async_wait<0>();

  store_rows<HD>(dq + q_off, q_row, dqa, q0, Sq, ty, tx);
}

// The wide dK/dV kernel's block: as dkdv_ffma, for columns [c0, c0 + GD)
// of dK and dV (c0 = GD blockIdx.z).  Per Q tile: the scores over the head,
// CW columns at a time (K, V, Q and dO chunks copied, waited for, summed);
// with the first chunk, this block's GD columns of Q and dO and the tile's
// (lse, D); then P and dS as dkdv_ffma has them, dV += P^T dO and dK +=
// dS^T Q over those columns.  One copy in flight at a time.
template <int HD>
__device__ __forceinline__ void dkdv_ffma_wide(const float* __restrict__ q,
                                               const float* __restrict__ k,
                                               const float* __restrict__ v,
                                               const float* __restrict__ dout,
                                               const float* __restrict__ LD,
                                               float* __restrict__ dk, float* __restrict__ dv,
                                               int Hout, int H, int Hkv, int Sq, int Skv,
                                               int causal, int window, int q_offset,
                                               float scale) {
  using S = BwdFfma<HD>;
  using Gt = BwdFfma<S::GD>;                 // the GD-column tiles and accumulators
  constexpr int CW = S::CW, LP = S::LP, OC = Gt::OC, CT = TILE * (CW + 4);
  extern __shared__ __align__(16) float smem[];
  float* Kc = smem;
  float* Vc = Kc + CT;
  float* Qc = Vc + CT;
  float* dOc = Qc + CT;
  float* Qg = smem + S::CHUNKS;              // this block's columns of Q, dO
  float* dOg = Qg + S::TG;
  float* Ss = dOg + S::TG;                   // P [query][key], then dS
  float* lds = Ss + S::SC;

  const int tid = threadIdx.x, tx = tid % S::TX, ty = tid / S::TX;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int j = blockIdx.y, k0 = j * TILE, c0 = blockIdx.z * S::GD;
  const int Sq64 = (Sq + TILE - 1) / TILE * TILE;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  const float* qh = q + (size_t)b * Sq * q_row + (size_t)h * HD;
  const float* doh = dout + (size_t)b * Sq * q_row + (size_t)h * HD;
  const float* kh = k + (size_t)b * Skv * kv_row + (size_t)hk * HD;
  const float* vh = v + (size_t)b * Skv * kv_row + (size_t)hk * HD;
  const float* ldh = LD + (size_t)bh * Sq64 * 2;
  const Span sp = tile_span(j, 0, Sq, Skv, causal, window, q_offset);

  float dka[4][OC], dva[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) dka[r][c] = dva[r][c] = 0.f;

  for (int t = sp.lo; t < sp.hi; ++t) {
    const int q0 = t * TILE;
    float s[4][4], dp[4][4];
    zero_tile(s);
    zero_tile(dp);
    for (int c = 0; c < HD; c += CW) {
      __syncthreads();               // every thread is done with what is copied over
      copy_tile<CW>(Kc, kh + c, kv_row, k0, Skv, tid);
      copy_tile<CW>(Vc, vh + c, kv_row, k0, Skv, tid);
      copy_tile<CW>(Qc, qh + c, q_row, q0, Sq, tid);
      copy_tile<CW>(dOc, doh + c, q_row, q0, Sq, tid);
      if (c == 0) {
        copy_tile<S::GD>(Qg, qh + c0, q_row, q0, Sq, tid);
        copy_tile<S::GD>(dOg, doh + c0, q_row, q0, Sq, tid);
        copy_ld(lds, ldh + (size_t)q0 * 2, tid);
      }
      simt::cp_async_commit();
      simt::cp_async_wait<0>();
      __syncthreads();
      score_acc<CW>(s, Qc, Kc, ty, tx);
      score_acc<CW>(dp, dOc, Vc, ty, tx);
    }
    softmax_grad(s, dp, lds, q0, k0, ty, tx, Skv, causal, window, q_offset, scale,
                 tile_unmasked(q0, k0, Skv, causal, window, q_offset));
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ss[(ty * 4 + r) * LP + tx + S::TX * c] = s[r][c];
    __syncthreads();
    grad_tile<S::GD>(dva, Ss, dOg, ty, tx);  // dV[key][d] += sum_q P[q][key] dO[q][d]
    __syncthreads();                         // every thread is done with P
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ss[(ty * 4 + r) * LP + tx + S::TX * c] = dp[r][c];
    __syncthreads();
    grad_tile<S::GD>(dka, Ss, Qg, ty, tx);   // dK[key][d] += sum_q dS[q][key] Q[q][d]
  }

  const size_t out_row = (size_t)Hout * HD;
  const size_t out_off =
      (size_t)b * Skv * out_row + (size_t)(Hout == H ? h : hk) * HD + c0;
  store_rows<S::GD>(dk + out_off, out_row, dka, k0, Skv, ty, tx);
  store_rows<S::GD>(dv + out_off, out_row, dva, k0, Skv, ty, tx);
}

// The wide dQ kernel's block: as dq_ffma, for columns [c0, c0 + GD) of dQ.
// Per KV tile: the scores over the head in CW-column chunks of Q, dO, K
// and V; with the first chunk, this block's GD columns of K; then dS and
// dQ += dS K over those columns.
template <int HD>
__device__ __forceinline__ void dq_ffma_wide(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const float* __restrict__ dout,
                                             const float* __restrict__ LD,
                                             float* __restrict__ dq, int H, int Hkv, int Sq,
                                             int Skv, int causal, int window, int q_offset,
                                             float scale) {
  using S = BwdFfma<HD>;
  using Gt = BwdFfma<S::GD>;
  constexpr int CW = S::CW, LP = S::LP, OC = Gt::OC, CT = TILE * (CW + 4);
  extern __shared__ __align__(16) float smem[];
  float* Qc = smem;
  float* dOc = Qc + CT;
  float* Kc = dOc + CT;
  float* Vc = Kc + CT;
  float* Kg = smem + S::CHUNKS;              // this block's columns of K
  float* dST = Kg + S::TG;                   // dS^T [key][query]
  float* lds = dST + S::SC;

  const int tid = threadIdx.x, tx = tid % S::TX, ty = tid / S::TX;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int i = gridDim.y - 1 - blockIdx.y, q0 = i * TILE, c0 = blockIdx.z * S::GD;
  const int Sq64 = (Sq + TILE - 1) / TILE * TILE;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * HD;
  const float* kh = k + (size_t)b * Skv * kv_row + (size_t)hk * HD;
  const float* vh = v + (size_t)b * Skv * kv_row + (size_t)hk * HD;
  const Span sp = tile_span(i, 1, Sq, Skv, causal, window, q_offset);

  float dqa[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) dqa[r][c] = 0.f;

  copy_ld(lds, LD + ((size_t)bh * Sq64 + q0) * 2, tid);
  simt::cp_async_commit();                   // waited for with the first chunk
  for (int t = sp.lo; t < sp.hi; ++t) {
    const int k0 = t * TILE;
    float s[4][4], dp[4][4];
    zero_tile(s);
    zero_tile(dp);
    for (int c = 0; c < HD; c += CW) {
      __syncthreads();               // every thread is done with what is copied over
      copy_tile<CW>(Qc, q + q_off + c, q_row, q0, Sq, tid);
      copy_tile<CW>(dOc, dout + q_off + c, q_row, q0, Sq, tid);
      copy_tile<CW>(Kc, kh + c, kv_row, k0, Skv, tid);
      copy_tile<CW>(Vc, vh + c, kv_row, k0, Skv, tid);
      if (c == 0) copy_tile<S::GD>(Kg, kh + c0, kv_row, k0, Skv, tid);
      simt::cp_async_commit();
      simt::cp_async_wait<0>();
      __syncthreads();
      score_acc<CW>(s, Qc, Kc, ty, tx);
      score_acc<CW>(dp, dOc, Vc, ty, tx);
    }
    softmax_grad(s, dp, lds, q0, k0, ty, tx, Skv, causal, window, q_offset, scale,
                 tile_unmasked(q0, k0, Skv, causal, window, q_offset));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      simt::st4(dST + (tx + S::TX * c) * LP + ty * 4,
                make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]));
    __syncthreads();
    grad_tile<S::GD>(dqa, dST, Kg, ty, tx);  // dQ[q][d] += sum_key dS[q][key] K[key][d]
  }
  simt::cp_async_wait<0>();                  // nothing in flight at exit

  store_rows<S::GD>(dq + q_off + c0, q_row, dqa, q0, Sq, ty, tx);
}

// The float32 tile kernels: the blocks above, the wide ones past hd 128.
template <int HD>
__global__ void __launch_bounds__(BwdFfma<HD>::THREADS, BwdFfma<HD>::MIN_BLOCKS)
fa_bwd_dkdv_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ LD, float* __restrict__ dk,
                        float* __restrict__ dv, int Hout, int H, int Hkv, int Sq,
                        int Skv, int causal, int window, int q_offset, float scale) {
  if constexpr (BwdFfma<HD>::WIDE)
    dkdv_ffma_wide<HD>(q, k, v, dout, LD, dk, dv, Hout, H, Hkv, Sq, Skv, causal, window,
                       q_offset, scale);
  else
    dkdv_ffma<HD>(q, k, v, dout, LD, dk, dv, Hout, H, Hkv, Sq, Skv, causal, window,
                  q_offset, scale);
}

template <int HD>
__global__ void __launch_bounds__(BwdFfma<HD>::THREADS, BwdFfma<HD>::MIN_BLOCKS)
fa_bwd_dq_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ LD, float* __restrict__ dq, int H,
                      int Hkv, int Sq, int Skv, int causal, int window, int q_offset,
                      float scale) {
  if constexpr (BwdFfma<HD>::WIDE)
    dq_ffma_wide<HD>(q, k, v, dout, LD, dq, H, Hkv, Sq, Skv, causal, window, q_offset,
                     scale);
  else
    dq_ffma<HD>(q, k, v, dout, LD, dq, H, Hkv, Sq, Skv, causal, window, q_offset, scale);
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float *LD, *part;
  void *dq, *dk, *dv;
  int B, H, Hkv, Sq, Skv, causal, window, q_offset;
  float scale;
  cudaStream_t stream;
};

inline unsigned blocks_for(long long threads) {
  return (unsigned)((threads + PASS_THREADS - 1) / PASS_THREADS);
}

// The (lse, D) pass, the two tile kernels that `tiles` launches, and the
// GQA sum where G > 1.
template <typename T, int HD, typename Tiles>
cudaError_t run_passes(const Args& a, Tiles tiles) {
  const int Sq64 = (a.Sq + TILE - 1) / TILE * TILE;
  fa_bwd_prep_kernel<T, HD><<<blocks_for((long long)a.B * Sq64 * a.H * (HD / 8)),
                              PASS_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.LD, a.B, a.H,
      a.Sq, Sq64);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = tiles();
  if (err == cudaSuccess && a.part != nullptr) {
    const long long n4 = (long long)a.B * a.Skv * a.Hkv * HD / 4;
    fa_bwd_sum_kernel<T><<<blocks_for(n4), PASS_THREADS, 0, a.stream>>>(
        a.part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), n4,
        (long long)a.B * a.Skv * a.H * HD, a.Hkv, a.H / a.Hkv, HD);
    err = cudaGetLastError();
  }
  return err;
}

template <int HD>
cudaError_t prepare_wgmma() {
  using S = BwdWgmma<HD>;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkdv_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::SMEM_DKDV);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dq_wgmma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM_DQ);
    return e;
  }();
  return attr;
}

template <int HD>
cudaError_t prepare_ffma() {
  using S = BwdFfma<HD>;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkdv_ffma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::SMEM_DKDV);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dq_ffma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM_DQ);
    return e;
  }();
  return attr;
}

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  using S = BwdWgmma<HD>;
  cudaError_t err = prepare_wgmma<HD>();
  if (err != cudaSuccess) return err;
  CUtensorMap map_q{}, map_k{}, map_v{}, map_do{};
  // (hd, heads, S, B), innermost first; strides of heads, S, B; 64-row boxes
  const uint64_t dq[4] = {HD, (uint64_t)a.H, (uint64_t)a.Sq, (uint64_t)a.B};
  const uint64_t dk[4] = {HD, (uint64_t)a.Hkv, (uint64_t)a.Skv, (uint64_t)a.B};
  const int64_t sq[3] = {HD, (int64_t)a.H * HD, (int64_t)a.Sq * a.H * HD};
  const int64_t sk[3] = {HD, (int64_t)a.Hkv * HD, (int64_t)a.Skv * a.Hkv * HD};
  const uint32_t box[4] = {(uint32_t)S::CH, 1, TILE, 1};
  err = hopper::make_map(&map_q, a.q, 4, dq, sq, box, S::SW);
  if (err == cudaSuccess) err = hopper::make_map(&map_do, a.dout, 4, dq, sq, box, S::SW);
  if (err == cudaSuccess) err = hopper::make_map(&map_k, a.k, 4, dk, sk, box, S::SW);
  if (err == cudaSuccess) err = hopper::make_map(&map_v, a.v, 4, dk, sk, box, S::SW);
  if (err != cudaSuccess) return err;
  const int nq = (a.Sq + TILE - 1) / TILE, nk = (a.Skv + TILE - 1) / TILE;
  return run_passes<__nv_bfloat16, HD>(a, [&] {
    fa_bwd_dkdv_wgmma_kernel<HD><<<dim3(a.B * a.H, nk, S::NH), S::THREADS, S::SMEM_DKDV,
                                   a.stream>>>(
        map_q, map_k, map_v, map_do, a.LD, a.part, (long long)a.B * a.Skv * a.H * HD,
        static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.H, a.Hkv,
        a.Sq, a.Skv, a.causal, a.window, a.q_offset, a.scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    fa_bwd_dq_wgmma_kernel<HD><<<dim3(a.B * a.H, nq, S::NH), S::THREADS, S::SMEM_DQ,
                                 a.stream>>>(
        map_q, map_k, map_v, map_do, a.LD, static_cast<__nv_bfloat16*>(a.dq), a.H, a.Hkv,
        a.Sq, a.Skv, a.causal, a.window, a.q_offset, a.scale);
    return cudaGetLastError();
  });
}

template <int HD>
cudaError_t launch_f32(const Args& a) {
  using S = BwdFfma<HD>;
  cudaError_t err = prepare_ffma<HD>();
  if (err != cudaSuccess) return err;
  const int nq = (a.Sq + TILE - 1) / TILE, nk = (a.Skv + TILE - 1) / TILE;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* dout = static_cast<const float*>(a.dout);
  // the partials (Hout = H) where G > 1, else the outputs (Hout = Hkv)
  const bool grouped = a.part != nullptr;
  float* dk = grouped ? a.part : static_cast<float*>(a.dk);
  float* dv = grouped ? a.part + (size_t)a.B * a.Skv * a.H * HD : static_cast<float*>(a.dv);
  return run_passes<float, HD>(a, [&] {
    fa_bwd_dkdv_ffma_kernel<HD><<<dim3(a.B * a.H, nk, S::NH), S::THREADS, S::SMEM_DKDV,
                                  a.stream>>>(
        q, k, v, dout, a.LD, dk, dv, grouped ? a.H : a.Hkv, a.H, a.Hkv, a.Sq, a.Skv, a.causal,
        a.window, a.q_offset, a.scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    fa_bwd_dq_ffma_kernel<HD><<<dim3(a.B * a.H, nq, S::NH), S::THREADS, S::SMEM_DQ,
                                a.stream>>>(
        q, k, v, dout, a.LD, static_cast<float*>(a.dq), a.H, a.Hkv, a.Sq, a.Skv, a.causal,
        a.window, a.q_offset, a.scale);
    return cudaGetLastError();
  });
}

template <int HD>
long long occupancy(int dtype, int kernel) {
  if (dtype == 0) {
    using S = BwdFfma<HD>;
    const cudaError_t attr = prepare_ffma<HD>();
    if (attr != cudaSuccess) return -(long long)attr;
    return kernel == 0
               ? simt::blocks_per_sm(fa_bwd_dkdv_ffma_kernel<HD>, S::THREADS, S::SMEM_DKDV)
               : simt::blocks_per_sm(fa_bwd_dq_ffma_kernel<HD>, S::THREADS, S::SMEM_DQ);
  }
  using S = BwdWgmma<HD>;
  const cudaError_t attr = prepare_wgmma<HD>();
  if (attr != cudaSuccess) return -(long long)attr;
  return kernel == 0
             ? simt::blocks_per_sm(fa_bwd_dkdv_wgmma_kernel<HD>, S::THREADS, S::SMEM_DKDV)
             : simt::blocks_per_sm(fa_bwd_dq_wgmma_kernel<HD>, S::THREADS, S::SMEM_DQ);
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, Hkv, hd), all
// contiguous at 16-byte aligned addresses in the type `dtype` (0 = float32,
// 1 = bfloat16); lse: (B, H, Sq) float32.  Scratch, float32: LD (B, H,
// Sq64, 2), Sq64 = Sq rounded up to 64; part (2, B, Skv, H, hd) where
// H > Hkv, else null.  window <= 0 means none.  Returns a cudaError_t (0 =
// success); cudaErrorInvalidValue for a head dim that was not instantiated.
extern "C" int pm2lat_flash_attention_bwd(int hd, int dtype, const void* q, const void* k,
                                          const void* v, const void* o, const void* dout,
                                          const void* lse, void* LD, void* part, void* dq,
                                          void* dk, void* dv, int B, int H, int Hkv, int Sq,
                                          int Skv, int causal, int window, int q_offset,
                                          float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (part == nullptr) != (H == Hkv))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(LD),
               static_cast<float*>(part), dq, dk, dv, B, H, Hkv, Sq, Skv, causal, window,
               q_offset, scale, static_cast<cudaStream_t>(stream)};
#define PM2LAT_FA_BWD(LAUNCH, DT, HD) \
  if (dtype == DT && hd == HD) return (int)LAUNCH<HD>(a);
  PM2LAT_FA_BWD(launch_f32, 0, 16)
  PM2LAT_FA_BWD(launch_f32, 0, 32)
  PM2LAT_FA_BWD(launch_f32, 0, 64)
  PM2LAT_FA_BWD(launch_f32, 0, 128)
  PM2LAT_FA_BWD(launch_f32, 0, 256)
  PM2LAT_FA_BWD(launch_bf16, 1, 16)
  PM2LAT_FA_BWD(launch_bf16, 1, 32)
  PM2LAT_FA_BWD(launch_bf16, 1, 64)
  PM2LAT_FA_BWD(launch_bf16, 1, 128)
  PM2LAT_FA_BWD(launch_bf16, 1, 256)
#undef PM2LAT_FA_BWD
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of the dK/dV (kernel 0) or the dQ kernel
// (kernel 1) at head dim hd in `dtype`, in bytes; -1 for an instance that
// does not exist.
extern "C" long long pm2lat_flash_attention_bwd_smem(int hd, int dtype, int kernel) {
  if ((kernel != 0 && kernel != 1) || (dtype != 0 && dtype != 1)) return -1;
#define PM2LAT_FA_BWD_SMEM(HD)                                                        \
  if (hd == HD)                                                                       \
    return (long long)(dtype == 0                                                     \
                           ? (kernel == 0 ? BwdFfma<HD>::SMEM_DKDV : BwdFfma<HD>::SMEM_DQ) \
                           : (kernel == 0 ? BwdWgmma<HD>::SMEM_DKDV                   \
                                          : BwdWgmma<HD>::SMEM_DQ));
  PM2LAT_FA_BWD_SMEM(16)
  PM2LAT_FA_BWD_SMEM(32)
  PM2LAT_FA_BWD_SMEM(64)
  PM2LAT_FA_BWD_SMEM(128)
  PM2LAT_FA_BWD_SMEM(256)
#undef PM2LAT_FA_BWD_SMEM
  return -1;
}

// Resident blocks per SM of the dK/dV (kernel 0) or dQ kernel (kernel 1)
// at head dim hd in `dtype`, as the card's occupancy calculator gives them;
// -1 for an instance that does not exist, a negative cudaError_t if the
// query fails.
extern "C" long long pm2lat_flash_attention_bwd_blocks_per_sm(int hd, int dtype, int kernel) {
  if ((kernel != 0 && kernel != 1) || (dtype != 0 && dtype != 1)) return -1;
  if (hd == 16) return occupancy<16>(dtype, kernel);
  if (hd == 32) return occupancy<32>(dtype, kernel);
  if (hd == 64) return occupancy<64>(dtype, kernel);
  if (hd == 128) return occupancy<128>(dtype, kernel);
  if (hd == 256) return occupancy<256>(dtype, kernel);
  return -1;
}

// tile_span on the host: span[0], span[1] = [lo, hi) of the tiles tile t
// visits along axis 0 (Q tiles of KV tile t) or 1 (KV tiles of Q tile t).
extern "C" void pm2lat_flash_attention_bwd_tile_span(int t, int axis, int Sq, int Skv,
                                                     int causal, int window, int q_offset,
                                                     int* span) {
  const Span s = tile_span(t, axis, Sq, Skv, causal, window, q_offset);
  span[0] = s.lo;
  span[1] = s.hi;
}

extern "C" const char* pm2lat_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
