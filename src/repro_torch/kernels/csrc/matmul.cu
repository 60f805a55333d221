// Tiled matmul for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N], row-major,
// f32 accumulation, C in the input type.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py::matmul_kernel (body
// _mm_kernel).  There, a sequential grid axis walks K and carries an f32
// accumulator in VMEM scratch from one grid step to the next.  Hopper runs
// blocks in parallel and in no order, so here one block owns one BM x BN
// output tile for its whole life: a loop inside the block walks K in BK
// steps and the f32 accumulators live in registers.  Ragged edges are
// masked in the kernel.  Each (BM, BK, BN) instantiation is its own kernel
// identity mm_<BM>x<BK>x<BN> in the PM2Lat tables, in both types.
//
// What bounds it on the H100: at the shapes the port profiles it is
// compute-bound in principle (989 TFLOP/s bf16 on the tensor cores, 67
// TFLOP/s f32 FFMA, against 3.35 TB/s of HBM); at the port's small
// calibration grids (2 x 2 output tiles) most SMs idle and the time is the
// latency of one tile's K loop.
//
// bfloat16 (mm_wgmma_kernel): the tensor cores.  A producer warp issues TMA
// loads of the A [BM, BK] tile (K-major) and the B [BK, BN] tile (N
// contiguous: MN-major, wgmma's transpose flag) into a ring of ST stages
// (as deep as 192 KB allows, at most 4), each completing on an mbarrier;
// BM / 64 consumer warpgroups run wgmma.m64n<BN>k16 from shared memory,
// keep one product group in flight and free a stage as soon as the group
// that read it has retired.  TMA zero-fills the ragged edge; the epilogue
// masks rows and columns past M and N.  An operand whose base address or
// row stride is no multiple of 16 bytes cannot go through TMA: then the
// consumers copy each tile themselves (hopper::load_tile_sync) into the
// same swizzled layout, one stage, and feed the same wgmma.  The wrapper
// chooses the path (matmul.py::load_path) and passes it in.
//
// mm_8x128x128 is the skinny-M (decode) identity and bound by bytes by
// nature: at M 8 it does 16 flops per 2 bytes of B.  It keeps the same
// design: TMA streams B in 16-byte-swizzled boxes through a 4-deep ring,
// and wgmma runs on a 64-row A tile whose rows 8..63 are zeroed once, so
// the tensor cores do 8x the needed work on zeros while the time is set
// by B's bytes.  One code path instead of a second (mma.sync) kernel.
//
// float32 (mm_kernel): register-tiled FFMA on the CUDA cores.  The
// tables' "float32" is true f32, and the tensor cores have no true-f32
// mode (TF32 keeps 10 mantissa bits; 3xTF32 rounds otherwise), so the
// bound is 67 TFLOP/s, 0.51 TFLOP/s an SM.  Each thread keeps a TM x TN
// micro-tile of C in registers (8 x 8 at 256 threads for the 128-wide
// tiles).  A warp is 4 x 8 threads: per 4 steps of K a thread reads TM
// float4 of A (rows along K; the warp's 4 rows sit 36 floats apart, in
// different banks) and 4 x TN/4 float4 of B from split column groups
// (tx*4 and tx*4 + BN/2: 8 lanes cover 32 banks) for 4 TM TN FFMAs.  A
// and B reach shared memory by cp.async, 16 bytes a thread (4 bytes where
// K or N is no multiple of 4), zero-filled past the ragged edge, into a
// double buffer of two slots of min(BK, 64) K columns: the next slot is
// copied while the current one is multiplied, one barrier a slot.  For
// BK <= 64 the two slots are two whole bm x bk + bk x bn stages
// (mm_128x32x128, mm_64x64x64); for BK = 128 they are one stage walked in
// two halves (mm_128x128x128: 132 KB; mm_8x128x128: 68 KB), so the
// working set of each identity stays what its name says.  At M 8,
// mm_8x128x128 (2 x 4 a thread, 128 threads) streams B's 128-column panel
// at full width: 16 flops per 4-byte element of B, bound by B's bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "simt.cuh"
#include "hopper.cuh"

namespace {

// ------------------------------------------------------------- float32

// One float32 instance: (BM/TM) x (BN/TN) threads own the BM x BN output
// tile; thread (ty, tx) accumulates rows ty + TY*i (i < TM) and, in TN/4
// groups of 4, columns g*(BN/CG) + tx*4 .. +3 in registers.  A warp is 4
// rows (ty) by 8 columns (tx) of threads.
template <int BM, int BK, int BN, int TM, int TN>
struct MmFfma {
  static constexpr int TX = BN / TN;               // threads along N
  static constexpr int TY = BM / TM;               // threads along M
  static constexpr int THREADS = TX * TY;
  static constexpr int CG = TN / 4;                // column groups a thread owns
  static constexpr int SK = BK < 64 ? BK : 64;     // K columns of one slot
  static constexpr int AS = SK + 4;                // padded row of A in a slot
  static constexpr int SLOT = BM * AS + SK * BN;   // floats: A [BM][AS], B [SK][BN]
  static constexpr size_t SMEM = 4 * 2 * (size_t)SLOT;   // a double buffer
  static_assert(TN % 4 == 0 && BM % TM == 0 && BN % TN == 0, "bad micro-tile");
  static_assert(TX % 8 == 0 && TY % 4 == 0, "a warp is 4 x 8 threads");
  static_assert(BK % SK == 0, "a stage is whole slots");
};

// minBlocks 1: without it ptxas caps a 128-thread block below what the
// kernel needs and spills.
template <int BM, int BK, int BN, int TM, int TN>
__global__ void __launch_bounds__(MmFfma<BM, BK, BN, TM, TN>::THREADS, 1)
mm_kernel(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ C, int M, int N, int K, int vec) {
  using S = MmFfma<BM, BK, BN, TM, TN>;
  using namespace simt;
  constexpr int SK = S::SK, AS = S::AS, NT = S::THREADS, CG = S::CG;
  constexpr int TY = S::TY;
  extern __shared__ __align__(16) float ring[];

  const int tid = threadIdx.x;
  const int lane_id = tid % 32, warp = tid / 32;
  const int tx = (warp % (S::TX / 8)) * 8 + lane_id % 8;
  const int ty = (warp / (S::TX / 8)) * 4 + lane_id / 8;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int nsub = (K + SK - 1) / SK;

  // Sub-chunk u (K columns u*SK ..) of A and B into ring slot `slot`:
  // 16-byte copies when K and N are multiples of 4 (rows 16-byte aligned),
  // else one float at a time.  Past M, N or K the copy writes zeros.
  auto load = [&](int u, int slot) {
    float* As = ring + slot * S::SLOT;
    float* Bs = As + BM * AS;
    const int k0 = u * SK;
    if (vec) {
      constexpr int CA = BM * SK / 4, CB = SK * BN / 4;
#pragma unroll
      for (int i = 0; i < (CA + NT - 1) / NT; ++i) {
        const int e = tid + i * NT, r = e / (SK / 4), c = 4 * (e % (SK / 4));
        const bool ok = row0 + r < M && k0 + c < K;
        if (CA % NT == 0 || e < CA)
          cp_async16(As + r * AS + c, ok ? A + (size_t)(row0 + r) * K + k0 + c : A, ok);
      }
#pragma unroll
      for (int i = 0; i < (CB + NT - 1) / NT; ++i) {
        const int e = tid + i * NT, r = e / (BN / 4), c = 4 * (e % (BN / 4));
        const bool ok = k0 + r < K && col0 + c < N;
        if (CB % NT == 0 || e < CB)
          cp_async16(Bs + r * BN + c, ok ? B + (size_t)(k0 + r) * N + col0 + c : B, ok);
      }
    } else {
      for (int e = tid; e < BM * SK; e += NT) {
        const int r = e / SK, c = e % SK;
        const bool ok = row0 + r < M && k0 + c < K;
        cp_async4(As + r * AS + c, ok ? A + (size_t)(row0 + r) * K + k0 + c : A, ok);
      }
      for (int e = tid; e < SK * BN; e += NT) {
        const int r = e / BN, c = e % BN;
        const bool ok = k0 + r < K && col0 + c < N;
        cp_async4(Bs + r * BN + c, ok ? B + (size_t)(k0 + r) * N + col0 + c : B, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // A double buffer: sub-chunk t is read from slot t % 2 while the copy of
  // sub-chunk t + 1 into the other slot is in flight.
  if (nsub > 0) load(0, 0);
  cp_async_commit();
  for (int t = 0; t < nsub; ++t) {
    cp_async_wait<0>();                // this thread's copies of sub-chunk t
    __syncthreads();                   // everyone's; and slot (t+1) % 2 is free
    if (t + 1 < nsub) load(t + 1, (t + 1) % 2);
    cp_async_commit();
    const float* As = ring + (t % 2) * S::SLOT + ty * AS;
    const float* Bs = ring + (t % 2) * S::SLOT + BM * AS + 4 * tx;
    // Per 4 steps of K: TM float4 of A (a warp's 4 rows in different
    // banks) and 4 x CG float4 of B (8 neighbouring lanes on 32 banks).
#pragma unroll
    for (int k = 0; k < SK; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ld4(As + i * TY * AS + k);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float b[TN];
#pragma unroll
        for (int g = 0; g < CG; ++g) ldv<4>(Bs + (k + e) * BN + g * (BN / CG), b + 4 * g);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(lane(a[i], e), b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + TY * i;
    if (gr >= M) continue;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int gc = col0 + g * (BN / CG) + 4 * tx;
      float* c = C + (size_t)gr * N + gc;
      if (vec && gc < N) {
        stv<4>(c, &acc[i][4 * g]);
      } else if (!vec) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < N) c[j] = acc[i][4 * g + j];
      }
    }
  }
}

template <int BM, int BK, int BN, int TM, int TN>
cudaError_t prepare_ffma() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      mm_kernel<BM, BK, BN, TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MmFfma<BM, BK, BN, TM, TN>::SMEM);
  return attr;
}

template <int BM, int BK, int BN, int TM, int TN>
cudaError_t launch_ffma(const void* a, const void* b, void* c, int M, int N, int K,
                        int path, cudaStream_t stream) {
  using S = MmFfma<BM, BK, BN, TM, TN>;
  const cudaError_t attr = prepare_ffma<BM, BK, BN, TM, TN>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  mm_kernel<BM, BK, BN, TM, TN><<<grid, S::THREADS, S::SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, N, K, path == 0);
  return cudaGetLastError();
}

template <int BM, int BK, int BN, int TM, int TN>
long long occupancy_ffma() {
  using S = MmFfma<BM, BK, BN, TM, TN>;
  const cudaError_t attr = prepare_ffma<BM, BK, BN, TM, TN>();
  if (attr != cudaSuccess) return -(long long)attr;
  return simt::blocks_per_sm(mm_kernel<BM, BK, BN, TM, TN>, S::THREADS, S::SMEM);
}

// ------------------------------------------------------------- bfloat16

template <int BM, int BK, int BN>
struct MmWgmma {
  static constexpr int ROWS = BM < 64 ? 64 : BM;   // A rows in shared memory
  static constexpr int NWG = ROWS / 64;            // consumer warpgroups
  static constexpr int NC = NWG * 128;             // consumer threads
  static constexpr int THREADS = NC + 32;          // + one producer warp
  static constexpr int ACH = BK < 64 ? BK : 64;    // A column chunk (elements)
  static constexpr int BCH = 64;                   // B column chunk (elements)
  static constexpr int A_BYTES = ROWS * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ST = (196608 / STAGE) < 4 ? (196608 / STAGE) : 4;
  static constexpr uint32_t TX_BYTES = (BM * BK + BK * BN) * 2;   // per stage
  // 1024 bytes of slack to align the ring, 256 for the barriers.
  static constexpr size_t SMEM = 1024 + (size_t)ST * STAGE + 256;
  static_assert(BN == 64 || BN == 128, "wgmma N is 64 or 128 here");
  static_assert(BK % 16 == 0 && (BK <= 64 || BK % 64 == 0), "bad BK");
  static_assert(ST >= 2, "the ring needs two stages");
};

template <int BM, int BK, int BN>
__global__ void __launch_bounds__(MmWgmma<BM, BK, BN>::THREADS)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __nv_bfloat16* __restrict__ A,
                const __nv_bfloat16* __restrict__ B,
                __nv_bfloat16* __restrict__ C, int M, int N, int K,
                long long lda, long long ldb, int tma) {
  using S = MmWgmma<BM, BK, BN>;
  using namespace hopper;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t bars = smem_u32(smem + S::ST * S::STAGE);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S::ST + s); };
  auto stage_a = [&](int s) { return smem + s * S::STAGE; };
  auto stage_b = [&](int s) { return smem + s * S::STAGE + S::A_BYTES; };

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < S::ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), S::NC);
    }
    mbar_init_fence();
  }
  if constexpr (BM < 64) {       // wgmma's rows past BM read zeros
    for (int i = tid; i < S::ST * S::STAGE / 16; i += S::THREADS)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= S::NC) {            // producer warp: one thread issues TMA
    if (tma && tid == S::NC) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % S::ST;
        if (kt >= S::ST) mbar_wait(empty(s), ((kt / S::ST) - 1) & 1);
        mbar_expect_tx(full(s), S::TX_BYTES);
        const int k0 = kt * BK;
#pragma unroll
        for (int c = 0; c < BK / S::ACH; ++c)
          tma_load_2d(smem_u32(stage_a(s) + c * S::ROWS * S::ACH * 2), &map_a,
                      full(s), k0 + c * S::ACH, m0);
#pragma unroll
        for (int c = 0; c < BN / S::BCH; ++c)
          tma_load_2d(smem_u32(stage_b(s) + c * BK * S::BCH * 2), &map_b,
                      full(s), n0 + c * S::BCH, k0);
      }
    }
    return;
  }

  const int wg = tid / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    int s = 0;
    if (tma) {
      s = kt % S::ST;
      mbar_wait(full(s), (kt / S::ST) & 1);
    } else {
      const int k0 = kt * BK;
      if (kt > 0) named_sync(1, S::NC);        // stage 0 is read by all
      load_tile_sync<BM, BK, S::ACH, S::NC, S::ROWS>(
          stage_a(0), A + (int64_t)m0 * lda + k0, lda, M - m0, K - k0, tid);
      load_tile_sync<BK, BN, S::BCH, S::NC>(
          stage_b(0), B + (int64_t)k0 * ldb + n0, ldb, K - k0, N - n0, tid);
      fence_proxy_async();
      named_sync(1, S::NC);
    }
    const uint32_t a_base = smem_u32(stage_a(s)) + wg * 64 * S::ACH * 2;
    const uint32_t b_base = smem_u32(stage_b(s));
    fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int c = (kk * 16) / S::ACH, w = (kk * 16) % S::ACH;
      const uint64_t da = make_desc<S::ACH * 2>(
          a_base + c * S::ROWS * S::ACH * 2 + w * 2, 16, 8 * S::ACH * 2);
      const uint64_t db = make_desc<128>(b_base + kk * 16 * S::BCH * 2,
                                         BK * S::BCH * 2, 1024);
      wgmma_ss<BN, 1>(acc, da, db);
    }
    wgmma_commit();
    if (tma) {
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(empty((kt - 1) % S::ST));
    } else {
      wgmma_wait<0>();
    }
    fence_regs<BN / 2>(acc);
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);

  const int w = (tid % 128) / 32, l = tid % 32;
  const bool even_n = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wg * 64 + 16 * w + l / 4 + 8 * h;
      const int gr = m0 + lr, gc = n0 + 8 * j + 2 * (l % 4);
      if (lr >= BM || gr >= M || gc >= N) continue;
      __nv_bfloat16* p = C + (int64_t)gr * N + gc;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (even_n) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        p[0] = __float2bfloat16(v0);
        if (gc + 1 < N) p[1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int BM, int BK, int BN>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K,
                         long long lda, long long ldb, int path,
                         cudaStream_t stream) {
  using S = MmWgmma<BM, BK, BN>;
  auto kern = mm_wgmma_kernel<BM, BK, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_a{}, map_b{};
  if (path == 0) {
    const uint64_t da[2] = {(uint64_t)K, (uint64_t)M};
    const int64_t sa[1] = {lda};
    const uint32_t ba[2] = {(uint32_t)S::ACH, (uint32_t)BM};
    cudaError_t err = hopper::make_map(&map_a, a, 2, da, sa, ba, S::ACH * 2);
    if (err != cudaSuccess) return err;
    const uint64_t db[2] = {(uint64_t)N, (uint64_t)K};
    const int64_t sb[1] = {ldb};
    const uint32_t bb[2] = {(uint32_t)S::BCH, (uint32_t)BK};
    err = hopper::make_map(&map_b, b, 2, db, sb, bb, 128);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kern<<<grid, S::THREADS, S::SMEM, stream>>>(
      map_a, map_b, static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c), M, N,
      K, lda, ldb, path == 0);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (contiguous operands, 16-byte aligned; lda/ldb
// unused), 1 = bfloat16.  lda, ldb: row strides of A and B in elements (C
// is contiguous).  path: bf16 0 = TMA, 1 = the consumers' own loads;
// float32 0 = 16-byte copies (K and N multiples of 4), 1 = 4-byte copies.
// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a block
// config that was not instantiated.
extern "C" int pm2lat_matmul(int bm, int bk, int bn, int dtype, int path,
                             const void* a, const void* b, void* c, int M, int N,
                             int K, long long lda, long long ldb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
#define PM2LAT_MM_F32(BM, BK, BN, TM, TN) \
    if (bm == BM && bk == BK && bn == BN) \
      return launch_ffma<BM, BK, BN, TM, TN>(a, b, c, M, N, K, path, s);
    PM2LAT_MM_F32(128, 128, 128, 8, 8)
    PM2LAT_MM_F32(128, 32, 128, 8, 8)
    PM2LAT_MM_F32(64, 64, 64, 4, 4)
    PM2LAT_MM_F32(8, 128, 128, 2, 4)
#undef PM2LAT_MM_F32
  } else if (dtype == 1) {
#define PM2LAT_MM_BF16(BM, BK, BN)        \
    if (bm == BM && bk == BK && bn == BN) \
      return launch_wgmma<BM, BK, BN>(a, b, c, M, N, K, lda, ldb, path, s);
    PM2LAT_MM_BF16(128, 128, 128)
    PM2LAT_MM_BF16(128, 32, 128)
    PM2LAT_MM_BF16(64, 64, 64)
    PM2LAT_MM_BF16(8, 128, 128)
#undef PM2LAT_MM_BF16
  }
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one block of an instance is launched with, in
// bytes; -1 for an instance that does not exist.
extern "C" long long pm2lat_matmul_smem(int bm, int bk, int bn, int dtype) {
#define PM2LAT_MM_SMEM(BM, BK, BN, TM, TN)                              \
  if (bm == BM && bk == BK && bn == BN)                                 \
    return dtype == 0 ? (long long)MmFfma<BM, BK, BN, TM, TN>::SMEM     \
                      : (long long)MmWgmma<BM, BK, BN>::SMEM;
  if (dtype != 0 && dtype != 1) return -1;
  PM2LAT_MM_SMEM(128, 128, 128, 8, 8)
  PM2LAT_MM_SMEM(128, 32, 128, 8, 8)
  PM2LAT_MM_SMEM(64, 64, 64, 4, 4)
  PM2LAT_MM_SMEM(8, 128, 128, 2, 4)
#undef PM2LAT_MM_SMEM
  return -1;
}

// Resident blocks per SM of a float32 instance, as the card's occupancy
// calculator gives them for its threads, registers and shared memory; -1
// for an instance that does not exist, a negative cudaError_t if the
// query fails.
extern "C" long long pm2lat_matmul_blocks_per_sm(int bm, int bk, int bn) {
#define PM2LAT_MM_OCC(BM, BK, BN, TM, TN) \
  if (bm == BM && bk == BK && bn == BN)   \
    return occupancy_ffma<BM, BK, BN, TM, TN>();
  PM2LAT_MM_OCC(128, 128, 128, 8, 8)
  PM2LAT_MM_OCC(128, 32, 128, 8, 8)
  PM2LAT_MM_OCC(64, 64, 64, 4, 4)
  PM2LAT_MM_OCC(8, 128, 128, 2, 4)
#undef PM2LAT_MM_OCC
  return -1;
}

extern "C" const char* pm2lat_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
