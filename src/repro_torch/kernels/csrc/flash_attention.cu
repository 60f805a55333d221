// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// over (B, S, H, hd) tensors with GQA, causal (bottom-right aligned) and
// sliding-window masks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_kernel (body _fa_kernel).  There, a sequential grid axis
// walks the KV blocks and carries m, l and acc in VMEM scratch.  Here one
// block owns one (batch*head, BQ query rows) tile for its whole life and a
// loop inside it walks the KV tiles of BK rows; thread t owns query row t,
// so m, l and the HD-wide f32 accumulator stay in its registers and never
// touch device memory.  The semantics are the TPU kernel's: q scaled by
// 1/sqrt(hd) in f32, causal mask qp >= kp with qp = q_offset + row, window
// (qp - kp) < window, masking ADDS -1e30 (never -inf), m/l/acc in f32, l
// clamped at 1e-30, every KV tile visited (no causal skip, so the work
// matches the fa_* tables' flops convention).  Query head h reads KV head
// h / (H / Hkv) in place of a materialised repeat.  Rows past Sq and keys
// past Skv are masked in the kernel (keys by the same additive -1e30).
//
// Shared memory per block: the KV tile [BK][HD] (K, then V in the same
// buffer), the scaled Q tile [BQ][HD + 1] and the score tile [BQ][BK + 1],
// all f32; the +1 paddings make each thread's private row conflict-free
// while the K/V rows are read as broadcasts.
//
// What bounds it on the H100: at qwen2-0.5b prefill (B=8, S=512, 14 query
// and 2 KV heads, hd 64, bf16) the bytes (q, o, k, v once: 16.8 MB, 5.0 us
// at 3.35 TB/s) outweigh the causal flops (3.8 GFLOP, 3.8 us at 989
// TFLOP/s).  This first version computes with FFMA on the CUDA cores, one
// query row per thread, so it is bound by the FFMA rate and by shared-memory
// issue, far from either bound; tensor-core (wgmma) tiles, TMA and a causal
// skip are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int BQ, int BK, int HD>
constexpr size_t smem_floats() {
  return (size_t)BK * HD + (size_t)BQ * (HD + 1) + (size_t)BQ * (BK + 1);
}

// Load rows [s0, s0 + ROWS) of one head into dst[ROWS][DST_STRIDE] as f32,
// zero past `len`.  Row s of the head starts at src + s * row_stride.
template <int ROWS, int HD, int DST_STRIDE, int NT, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          size_t row_stride, int s0, int len,
                                          float scale) {
  for (int e = threadIdx.x; e < ROWS * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int s = s0 + r;
    dst[r * DST_STRIDE + d] = s < len ? to_f32(src[(size_t)s * row_stride + d]) * scale : 0.f;
  }
}

template <int BQ, int BK, int HD, typename T>
__global__ void __launch_bounds__(BQ)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
              int Sq, int Skv, int causal, int window, int q_offset,
              float scale) {
  extern __shared__ __align__(16) float smem[];
  float* KV = smem;                    // [BK][HD]
  float* Qs = KV + BK * HD;            // [BQ][HD + 1]
  float* S = Qs + BQ * (HD + 1);       // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  const T* qh = q + (size_t)b * Sq * q_row + (size_t)h * HD;
  const T* kh = k + (size_t)b * Skv * kv_row + (size_t)hk * HD;
  const T* vh = v + (size_t)b * Skv * kv_row + (size_t)hk * HD;

  load_tile<BQ, HD, HD + 1, BQ>(Qs, qh, q_row, q0, Sq, scale);
  __syncthreads();
  // Up to hd 64 the thread's q row also fits in registers beside acc.
  constexpr bool kQInRegs = HD <= 64;
  const float* qs = Qs + tid * (HD + 1);
  float qreg[kQInRegs ? HD : 1];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int d = 0; d < HD; ++d) qreg[d] = qs[d];
  }
  auto qv = [&](int d) -> float {
    if constexpr (kQInRegs) return qreg[d];
    else return qs[d];
  };
  float* sr = S + tid * (BK + 1);
  const int qp = q_offset + q0 + tid;

  float m = kNegInf, l = 0.f;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    load_tile<BK, HD, HD, BQ>(KV, kh, kv_row, k0, Skv, 1.f);
    __syncthreads();
    float mt = kNegInf;
    for (int j = 0; j < BK; ++j) {
      const float4* kj = reinterpret_cast<const float4*>(KV + j * HD);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 kv4 = kj[d4];
        s = fmaf(qv(4 * d4 + 0), kv4.x, s);
        s = fmaf(qv(4 * d4 + 1), kv4.y, s);
        s = fmaf(qv(4 * d4 + 2), kv4.z, s);
        s = fmaf(qv(4 * d4 + 3), kv4.w, s);
      }
      const int kp = k0 + j;
      bool keep = kp < Skv;
      if (causal) {
        keep = keep && qp >= kp;
        if (window > 0) keep = keep && (qp - kp) < window;
      }
      if (!keep) s += kNegInf;
      sr[j] = s;
      mt = fmaxf(mt, s);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    for (int j = 0; j < BK; ++j) {
      const float p = expf(sr[j] - m_new);
      sr[j] = p;
      psum += p;
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
    __syncthreads();                   // every thread is done with K
    load_tile<BK, HD, HD, BQ>(KV, vh, kv_row, k0, Skv, 1.f);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      const float4* vj = reinterpret_cast<const float4*>(KV + j * HD);
      const float p = sr[j];
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 v4 = vj[d4];
        acc[4 * d4 + 0] = fmaf(p, v4.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, v4.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, v4.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, v4.w, acc[4 * d4 + 3]);
      }
    }
    __syncthreads();                   // every thread is done with V
  }

  if (q0 + tid < Sq) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + (size_t)b * Sq * q_row + (size_t)(q0 + tid) * q_row + (size_t)h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) orow[d] = from_f32<T>(acc[d] / lc);
  }
}

template <int BQ, int BK, int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int Hkv, int Sq, int Skv, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  static_assert(HD % 4 == 0 && BQ % 4 == 0, "float4 rows need 16-byte alignment");
  constexpr size_t smem = sizeof(float) * smem_floats<BQ, BK, HD>();
  auto kern = fa_fwd_kernel<BQ, BK, HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, BQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Skv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); all contiguous.  dtype: 0 =
// float32, 1 = bfloat16.  window <= 0 means none.  Returns a cudaError_t
// (0 = success); cudaErrorInvalidValue for a config or head dim that was
// not instantiated.
extern "C" int pm2lat_flash_attention(int bq, int bk, int hd, int dtype,
                                      const void* q, const void* k, const void* v,
                                      void* o, int B, int H, int Hkv, int Sq,
                                      int Skv, int causal, int window,
                                      int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
#define PM2LAT_FA(BQ, BK, HD)                                                   \
  if (bq == BQ && bk == BK && hd == HD)                                         \
    return dtype == 0                                                           \
               ? launch<BQ, BK, HD, float>(q, k, v, o, B, H, Hkv, Sq, Skv,      \
                                           causal, window, q_offset, scale, s)  \
               : launch<BQ, BK, HD, __nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq,   \
                                                   Skv, causal, window,         \
                                                   q_offset, scale, s);
  PM2LAT_FA(64, 64, 16)
  PM2LAT_FA(64, 64, 32)
  PM2LAT_FA(64, 64, 64)
  PM2LAT_FA(64, 64, 128)
  PM2LAT_FA(128, 128, 16)
  PM2LAT_FA(128, 128, 32)
  PM2LAT_FA(128, 128, 64)
  PM2LAT_FA(128, 128, 128)
#undef PM2LAT_FA
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pm2lat_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
