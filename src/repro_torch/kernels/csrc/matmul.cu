// Tiled matmul for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N], row-major,
// f32 accumulation, C in the input type.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py::matmul_kernel (body
// _mm_kernel).  There, a sequential grid axis walks K and carries an f32
// accumulator in VMEM scratch from one grid step to the next.  Hopper runs
// blocks in parallel and in no order, so here one block owns one BM x BN
// output tile for its whole life: a loop inside the block walks K in BK
// steps, staging an A tile and a B tile in shared memory, and the f32
// accumulators live in registers (TM x TN per thread).  Ragged edges are
// masked in the kernel: out-of-range loads read 0, out-of-range stores are
// skipped.  Each (BM, BK, BN) instantiation is its own kernel identity
// mm_<BM>x<BK>x<BN> in the PM2Lat tables.
//
// What bounds it on the H100: at the shapes the port profiles it is
// compute-bound in principle (989 TFLOP/s bf16 on the tensor cores, 67
// TFLOP/s f32 FFMA, against 3.35 TB/s of HBM).  This first version issues
// FFMA on the CUDA cores for both types (bf16 is widened on load), so bf16
// cannot exceed the f32 FFMA rate; the A tile is stored k-major with one
// column of padding so its transposing stores do not conflict on banks.
// The wgmma/TMA redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int BM, int BK, int BN, int TM, int TN, typename T>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
mm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
          int M, int N, int K) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;          // threads along N
  constexpr int AS = BM + 1;           // padded stride of the k-major A tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);   // [BK][BM + 1]
  T* Bs = As + BK * AS;                     // [BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const T zero = from_f32<T>(0.f);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {      // coalesced along K
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c * AS + r] = (gr < M && gc < K) ? A[(size_t)gr * K + gc] : zero;
    }
    for (int e = tid; e < BK * BN; e += NT) {      // coalesced along N
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r * BN + c] = (gr < K && gc < N) ? B[(size_t)gr * N + gc] : zero;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = to_f32(As[kk * AS + ty * TM + i]);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = to_f32(Bs[kk * BN + tx * TN + j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < N) C[(size_t)gr * N + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <int BM, int BK, int BN, int TM, int TN, typename T>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K,
                   cudaStream_t stream) {
  static_assert(BM % TM == 0 && BN % TN == 0, "tile must divide the block");
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr size_t smem = sizeof(T) * (size_t)(BK * (BM + 1) + BK * BN);
  auto kern = mm_kernel<BM, BK, BN, TM, TN, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a block config that was not instantiated.
extern "C" int pm2lat_matmul(int bm, int bk, int bn, int dtype, const void* a,
                             const void* b, void* c, int M, int N, int K,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PM2LAT_MM(BM, BK, BN, TM, TN)                                          \
  if (bm == BM && bk == BK && bn == BN)                                        \
    return dtype == 0 ? launch<BM, BK, BN, TM, TN, float>(a, b, c, M, N, K, s) \
                      : launch<BM, BK, BN, TM, TN, __nv_bfloat16>(a, b, c, M, N, K, s);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  PM2LAT_MM(128, 128, 128, 8, 8)
  PM2LAT_MM(128, 32, 128, 8, 8)
  PM2LAT_MM(64, 64, 64, 4, 4)
  PM2LAT_MM(8, 128, 128, 1, 4)
#undef PM2LAT_MM
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pm2lat_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
