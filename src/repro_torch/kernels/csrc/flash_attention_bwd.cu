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
// dS = P (dP - D) / sqrt(hd), dQ = dS K, dK = dS^T Q; f32 throughout,
// gradients cast to the input type.  Query head h reads KV head
// h / (H / Hkv), so dK and dV of a KV head sum over its G = H / Hkv query
// heads, where the reference's repeat of KV heads sums them.
//
// FlashAttention-2's deterministic design, no atomics, three kernels:
//   fa_bwd_d_kernel     D = rowsum(dO * O), one warp a row, f32 (B, H, Sq);
//   fa_bwd_dkdv_kernel  one block a (BK keys, batch, KV head): K and V stay
//                       in shared memory while the block walks the G query
//                       heads of the group and every BQ-row Q tile of each,
//                       so dK and dV accumulate in registers and the group's
//                       sum happens inside the block;
//   fa_bwd_dq_kernel    one block a (BQ query rows, batch, query head): Q, dO,
//                       lse and D stay in shared memory while the block walks
//                       the KV tiles; it recomputes S and dP (two products
//                       more than a kernel that shares dS through atomics).
// Every tile is visited: no causal skip, as in the forward.
//
// Both types run FFMA on the CUDA cores in f32: bfloat16 inputs are widened
// as they are copied into shared memory, and gradients are rounded once, at
// the store.  So float32 is true f32 (no TF32) and bfloat16 does the
// reference's f32 arithmetic.  A tensor-core (wgmma) design is later work.
// 256 threads a block in a 16 x 16 grid; thread (ty, tx) owns rows ty*4 +
// {0..3} and key columns tx + 16 c (c < 4) of each 64 x 64 score tile, and
// the same rows by HD/16 columns of a [64, HD] gradient tile: OG groups of
// OV = min(HD/16, 4) neighbours, g (HD/OG) + tx OV + {0..OV-1}.  Rows of
// the [rows][HD] tiles are padded by 4 floats, so the 16 lanes of a half
// warp that read rows tx + 16 c hit 32 banks.  Head dims 16, 32, 64, 128
// (every forward instance's but 256).
//
// What bounds it on the H100 (qwen2-0.5b at B 8, S 512, 14 query and 2 KV
// heads at hd 64): the products.  Seven (B H) S^2 hd products of two flops
// (five, and S and dP again in the dQ kernel) are 26.3 GFLOP over the full
// square at 67 TFLOP/s of f32 FFMA: 0.39 ms (the causal half that the
// function needs is 9.4 GFLOP of its five products: 0.14 ms), against 67 MB
// of f32 tensors (q, k, v, o, dO, dQ, dK, dV and lse once: 0.020 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "simt.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64, BK = 64, THREADS = 256, TX = 16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory shape of the two tile kernels at head dim HD.
template <int HD>
struct Bwd {
  static constexpr int LD = HD + 4;            // padded row of a [rows][HD] tile
  static constexpr int LP = BK + 4;            // padded row of a score tile
  static constexpr int OC = HD / TX;           // gradient columns a thread owns
  static constexpr int OV = OC < 4 ? OC : 4;   // their vector width
  static constexpr int OG = OC / OV;           // and groups, HD / OG apart
  static constexpr int TILE = 64 * LD;         // floats of a [64][HD] tile
  static constexpr int SCORE = 64 * LP;        // floats of a 64 x 64 score tile
  // dK/dV: K, V, Q, dO tiles, P and dS, lse and D of the Q tile.
  static constexpr size_t SMEM_DKDV = 4 * (size_t)(4 * TILE + 2 * SCORE + 2 * BQ);
  // dQ: Q, dO, K, V tiles, dS^T, lse and D.
  static constexpr size_t SMEM_DQ = 4 * (size_t)(4 * TILE + SCORE + 2 * BQ);
  static_assert(HD % 16 == 0 && (OC == 1 || OC == 2 || OC % 4 == 0),
                "head dim 16, 32 or a multiple of 64");
};

// rows [r0, r0 + 64) of a (rows, heads, HD) slab at src (row stride `stride`
// elements, head offset applied) into dst [64][LD] as f32, zeros past `n`.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t stride,
                                          int r0, int n, int tid) {
  for (int e = tid; e < 64 * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    dst[r * Bwd<HD>::LD + c] = r0 + r < n ? widen(src[(size_t)(r0 + r) * stride + c]) : 0.f;
  }
}

__device__ __forceinline__ bool keep(int qp, int kp, int Skv, int causal, int window) {
  bool k = kp < Skv;
  if (causal) {
    k = k && qp >= kp;
    if (window > 0) k = k && (qp - kp) < window;
  }
  return k;
}

// acc[r][c] += sum_d A[ty*4 + r][d] * B[tx + 16 c][d] over the HD columns of
// two [64][LD] tiles: one of the score products (S = Q K^T, dP = dO V^T).
template <int HD>
__device__ __forceinline__ void score_tile(float (&acc)[4][4], const float* A,
                                           const float* Bm, int ty, int tx) {
  constexpr int LD = Bwd<HD>::LD;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = simt::ld4(A + (ty * 4 + r) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = simt::ld4(Bm + (tx + TX * c) * LD + d);
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

// P and dS of one 64 x 64 tile from S, dP (scores unscaled) and the rows'
// lse and D: p = exp(s scale + mask - lse), ds = p (dp - D) scale; zero for
// rows past Sq.
__device__ __forceinline__ void softmax_grad(float (&s)[4][4], float (&dp)[4][4],
                                             const float* lse_s, const float* d_s,
                                             int q0, int k0, int ty, int tx, int Sq,
                                             int Skv, int causal, int window,
                                             int q_offset, float scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = ty * 4 + r;
    const int qp = q_offset + q0 + qi;
    const float l = lse_s[qi], dd = d_s[qi];
    const bool row_ok = q0 + qi < Sq;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float x = s[r][c] * scale;
      if (!keep(qp, k0 + tx + TX * c, Skv, causal, window)) x += kNegInf;
      const float p = row_ok ? expf(x - l) : 0.f;
      s[r][c] = p;
      dp[r][c] = p * (dp[r][c] - dd) * scale;
    }
  }
}

// One warp a row: D[b, h, q] = sum_d dO[b, q, h, d] O[b, q, h, d] in f32.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_d_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ D, int B, int H, int Sq) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= B * Sq * H) return;
  const int h = row % H, q = (row / H) % Sq, b = row / (H * Sq);
  const T* orow = o + (size_t)row * HD;
  const T* drow = dout + (size_t)row * HD;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) acc = fmaf(widen(drow[d]), widen(orow[d]), acc);
#pragma unroll
  for (int x = 16; x > 0; x /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) D[((size_t)b * H + h) * Sq + q] = acc;
}

// dK and dV of BK keys of one (batch, KV head), summed over the G query
// heads that read it and every Q tile.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int Sq,
                   int Skv, int causal, int window, int q_offset, float scale) {
  using S = Bwd<HD>;
  constexpr int LD = S::LD, LP = S::LP, OC = S::OC, OV = S::OV, OG = S::OG;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + S::TILE;
  float* Qs = Vs + S::TILE;
  float* dOs = Qs + S::TILE;
  float* Ps = dOs + S::TILE;
  float* dSs = Ps + S::SCORE;
  float* lse_s = dSs + S::SCORE;
  float* d_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int G = H / Hkv;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  const size_t kv_off = (size_t)b * Skv * kv_row + (size_t)hk * HD;
  load_tile<T, HD>(Ks, k + kv_off, kv_row, k0, Skv, tid);
  load_tile<T, HD>(Vs, v + kv_off, kv_row, k0, Skv, tid);

  float dka[4][OC], dva[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < OC; ++j) dka[r][j] = dva[r][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * HD;
    const float* lse_h = lse + ((size_t)b * H + h) * Sq;
    const float* d_h = D + ((size_t)b * H + h) * Sq;
    for (int q0 = 0; q0 < Sq; q0 += BQ) {
      __syncthreads();                   // every thread is done with the last tile
      load_tile<T, HD>(Qs, q + q_off, q_row, q0, Sq, tid);
      load_tile<T, HD>(dOs, dout + q_off, q_row, q0, Sq, tid);
      if (tid < BQ) {
        const bool ok = q0 + tid < Sq;
        lse_s[tid] = ok ? lse_h[q0 + tid] : 0.f;
        d_s[tid] = ok ? d_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      score_tile<HD>(s, Qs, Ks, ty, tx);
      score_tile<HD>(dp, dOs, Vs, ty, tx);
      softmax_grad(s, dp, lse_s, d_s, q0, k0, ty, tx, Sq, Skv, causal, window,
                   q_offset, scale);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Ps[(ty * 4 + r) * LP + tx + TX * c] = s[r][c];
          dSs[(ty * 4 + r) * LP + tx + TX * c] = dp[r][c];
        }
      __syncthreads();

      // dV[key][d] += sum_q P[q][key] dO[q][d]; dK[key][d] += sum_q dS[q][key] Q[q][d]
      // for keys ty*4 + r and this thread's columns.
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        const float4 p4 = simt::ld4(Ps + qq * LP + ty * 4);
        const float4 ds4 = simt::ld4(dSs + qq * LP + ty * 4);
        float ov[OC], qv[OC];
#pragma unroll
        for (int gg = 0; gg < OG; ++gg) {
          simt::ldv<OV>(dOs + qq * LD + gg * (HD / OG) + tx * OV, ov + gg * OV);
          simt::ldv<OV>(Qs + qq * LD + gg * (HD / OG) + tx * OV, qv + gg * OV);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = simt::lane(p4, r), ds = simt::lane(ds4, r);
#pragma unroll
          for (int j = 0; j < OC; ++j) {
            dva[r][j] = fmaf(p, ov[j], dva[r][j]);
            dka[r][j] = fmaf(ds, qv[j], dka[r][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kr = k0 + ty * 4 + r;
    if (kr >= Skv) continue;
    T* dkrow = dk + kv_off + (size_t)kr * kv_row;
    T* dvrow = dv + kv_off + (size_t)kr * kv_row;
#pragma unroll
    for (int gg = 0; gg < OG; ++gg)
#pragma unroll
      for (int e = 0; e < OV; ++e) {
        const int col = gg * (HD / OG) + tx * OV + e;
        dkrow[col] = narrow<T>(dka[r][gg * OV + e]);
        dvrow[col] = narrow<T>(dva[r][gg * OV + e]);
      }
  }
}

// dQ of BQ query rows of one (batch, query head), over every KV tile.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 T* __restrict__ dq, int H, int Hkv, int Sq, int Skv, int causal,
                 int window, int q_offset, float scale) {
  using S = Bwd<HD>;
  constexpr int LD = S::LD, LP = S::LP, OC = S::OC, OV = S::OV, OG = S::OG;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + S::TILE;
  float* Ks = dOs + S::TILE;
  float* Vs = Ks + S::TILE;
  float* dST = Vs + S::TILE;                 // dS^T [key][query]
  float* lse_s = dST + S::SCORE;
  float* d_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * HD;
  const size_t kv_off = (size_t)b * Skv * kv_row + (size_t)hk * HD;
  load_tile<T, HD>(Qs, q + q_off, q_row, q0, Sq, tid);
  load_tile<T, HD>(dOs, dout + q_off, q_row, q0, Sq, tid);
  if (tid < BQ) {
    const bool ok = q0 + tid < Sq;
    lse_s[tid] = ok ? lse[((size_t)b * H + h) * Sq + q0 + tid] : 0.f;
    d_s[tid] = ok ? D[((size_t)b * H + h) * Sq + q0 + tid] : 0.f;
  }

  float dqa[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < OC; ++j) dqa[r][j] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    __syncthreads();                     // every thread is done with the last tile
    load_tile<T, HD>(Ks, k + kv_off, kv_row, k0, Skv, tid);
    load_tile<T, HD>(Vs, v + kv_off, kv_row, k0, Skv, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tile<HD>(s, Qs, Ks, ty, tx);
    score_tile<HD>(dp, dOs, Vs, ty, tx);
    softmax_grad(s, dp, lse_s, d_s, q0, k0, ty, tx, Sq, Skv, causal, window,
                 q_offset, scale);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      simt::st4(dST + (tx + TX * c) * LP + ty * 4,
                make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]));
    __syncthreads();

    // dQ[q][d] += sum_key dS[q][key] K[key][d] for rows ty*4 + r and this
    // thread's columns.
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float4 ds4 = simt::ld4(dST + kk * LP + ty * 4);
      float kv[OC];
#pragma unroll
      for (int gg = 0; gg < OG; ++gg)
        simt::ldv<OV>(Ks + kk * LD + gg * (HD / OG) + tx * OV, kv + gg * OV);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = simt::lane(ds4, r);
#pragma unroll
        for (int j = 0; j < OC; ++j) dqa[r][j] = fmaf(ds, kv[j], dqa[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qr = q0 + ty * 4 + r;
    if (qr >= Sq) continue;
    T* row = dq + q_off + (size_t)qr * q_row;
#pragma unroll
    for (int gg = 0; gg < OG; ++gg)
#pragma unroll
      for (int e = 0; e < OV; ++e)
        row[gg * (HD / OG) + tx * OV + e] = narrow<T>(dqa[r][gg * OV + e]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* D, void* dq, void* dk,
                   void* dv, int B, int H, int Hkv, int Sq, int Skv, int causal,
                   int window, int q_offset, float scale, cudaStream_t stream) {
  using S = Bwd<HD>;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::SMEM_DKDV);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)S::SMEM_DQ);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = B * Sq * H;
  fa_bwd_d_kernel<T, HD><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                           stream>>>(static_cast<const T*>(o), dot, D, B, H, Sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<T, HD><<<dim3((Skv + BK - 1) / BK, B * Hkv), THREADS,
                              S::SMEM_DKDV, stream>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Sq,
      Skv, causal, window, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq_kernel<T, HD><<<dim3((Sq + BQ - 1) / BQ, B * H), THREADS, S::SMEM_DQ,
                            stream>>>(qt, kt, vt, dot, lse, D, static_cast<T*>(dq), H,
                                      Hkv, Sq, Skv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, Hkv, hd), all
// contiguous in the type `dtype` (0 = float32, 1 = bfloat16); lse and D
// (scratch the D kernel fills): (B, H, Sq) float32.  window <= 0 means
// none.  Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a
// head dim that was not instantiated.
extern "C" int pm2lat_flash_attention_bwd(int hd, int dtype, const void* q,
                                          const void* k, const void* v,
                                          const void* o, const void* dout,
                                          const void* lse, void* D, void* dq,
                                          void* dk, void* dv, int B, int H,
                                          int Hkv, int Sq, int Skv, int causal,
                                          int window, int q_offset, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
#define PM2LAT_FA_BWD(T, DT, HD)                                                    \
  if (dtype == DT && hd == HD)                                                      \
    return (int)launch<T, HD>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, Hkv, Sq,    \
                              Skv, causal, window, q_offset, scale, s);
  PM2LAT_FA_BWD(float, 0, 16)
  PM2LAT_FA_BWD(float, 0, 32)
  PM2LAT_FA_BWD(float, 0, 64)
  PM2LAT_FA_BWD(float, 0, 128)
  PM2LAT_FA_BWD(__nv_bfloat16, 1, 16)
  PM2LAT_FA_BWD(__nv_bfloat16, 1, 32)
  PM2LAT_FA_BWD(__nv_bfloat16, 1, 64)
  PM2LAT_FA_BWD(__nv_bfloat16, 1, 128)
#undef PM2LAT_FA_BWD
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of the dK/dV (kernel 0) or the dQ kernel
// (kernel 1) at head dim hd, in bytes (the same in both types: tiles are
// f32); -1 for a head dim that was not instantiated.
extern "C" long long pm2lat_flash_attention_bwd_smem(int hd, int kernel) {
  if (kernel != 0 && kernel != 1) return -1;
#define PM2LAT_FA_BWD_SMEM(HD) \
  if (hd == HD) return (long long)(kernel == 0 ? Bwd<HD>::SMEM_DKDV : Bwd<HD>::SMEM_DQ);
  PM2LAT_FA_BWD_SMEM(16)
  PM2LAT_FA_BWD_SMEM(32)
  PM2LAT_FA_BWD_SMEM(64)
  PM2LAT_FA_BWD_SMEM(128)
#undef PM2LAT_FA_BWD_SMEM
  return -1;
}

extern "C" const char* pm2lat_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
