// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// over (B, S, H, hd) tensors with GQA, causal (bottom-right aligned) and
// sliding-window masks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_kernel (body _fa_kernel).  There, a sequential grid axis
// walks the KV blocks and carries m, l and acc in VMEM scratch.  Here one
// block owns one (batch*head, BQ query rows) tile for its whole life and a
// loop inside it walks the KV tiles of BK rows, so m, l and the f32
// accumulator stay in registers and never touch device memory.  The
// semantics are the TPU kernel's: causal mask qp >= kp with qp = q_offset +
// row, window (qp - kp) < window, masking ADDS -1e30 (never -inf), m/l/acc
// in f32, l clamped at 1e-30.  Query head h reads KV head h / (H / Hkv) in
// place of a materialised repeat.  Rows past Sq and keys past Skv are
// masked in the kernel (keys by the same additive -1e30).
//
// Every KV tile is visited, with no causal skip.  The fa_* and fa_model
// tables are profiled causal and turned into throughput with the
// full-square count 4 bh s^2 hd (core/calibrate.py), and the predictor
// prices causal and non-causal attention (encoder and cross attention)
// from them by that same count.  A skip would halve the causal tables'
// times and underprice every non-causal op by about 2x; it needs
// causal-keyed tables first.
//
// What bounds it on the H100: at qwen2-0.5b prefill (B=8, S=512, 14 query
// and 2 KV heads, hd 64, bf16) the bytes (q, o, k, v once: 16.8 MB, 5.0 us
// at 3.35 TB/s) outweigh the causal flops (3.8 GFLOP, 3.8 us at 989
// TFLOP/s); the full square the kernel computes is 7.5 GFLOP, 7.6 us.
//
// bfloat16 (fa_wgmma_kernel): the tensor cores.  BQ / 64 warpgroups, each
// owning 64 query rows; thread 0 also issues TMA: the Q tile once, then K
// and V tiles through a two-stage ring, refilling a stage as soon as every
// warpgroup is done with it (rank-4 tensor maps over (B, S, H, hd), so GQA reads the
// KV head in place), each tile completing on its own mbarrier.  S = Q K^T
// is wgmma.m64n<BK>k16 with both operands in shared memory (K stored
// [BK, hd] is K-major).  The online softmax runs on the accumulator
// fragments in registers: S is scaled by 1/sqrt(hd) after the product (the
// TPU scales q in f32 first; a bf16 operand cannot carry that), masked,
// row max comes from quad shuffles, the accumulator is rescaled by
// exp(m_old - m_new), and each thread sums l over its own columns until
// the epilogue.  P is split in registers into its bf16 rounding and the
// bf16 rounding of the rest, the A operands of two products O += P_hi V +
// P_lo V (wgmma from registers; V [BK, hd] is MN-major: the transpose
// flag), so P enters at ~2^-16 of itself.  One
// rounding of P to bf16 would move a row's output by up to 2^-8 sum_j p_j
// |v_j| / l, in a row of few keys as much as the output's own rounding,
// and with the two outputs' roundings pass the check against the plain
// version (f32 P); the second product costs a third more tensor-core work,
// the split a second bf16 conversion a pair.  On the TPU,
// jnp.dot(p, v) at JAX's default precision runs its f32 operands through
// one bf16 MXU pass.  The epilogue divides by l and stores bf16.  Rows
// of 128 bytes or more (hd 64, 128) use the 128-byte swizzle in 64-column
// boxes; hd 16 and 32 use the 32- and 64-byte
// swizzles.  An operand whose base address or strides are no multiple of
// 16 bytes cannot go through TMA: then the consumers copy each tile
// themselves (hopper::load_tile_sync) into the same layout, one stage, and
// feed the same wgmma.  The wrapper chooses the path
// (flash_attention.py::load_path) and passes it in.
//
// float32 (fa_fwd_kernel): register-tiled FFMA on the CUDA cores (the
// tables' "float32" is true f32; the tensor cores have no true-f32 mode),
// bound by 67 TFLOP/s: the full square at qwen2-0.5b prefill is 7.52
// GFLOP, 0.112 ms.  2 BQ threads a block in a (BQ/8) x 16 grid; each owns
// 8 query rows (two groups of 4, ty*4 and BQ/2 + ty*4) by BK/16 key columns
// (tx + 16 c) of S, and the same 8 rows by hd/16 columns of O.  At hd 256
// that would be 128 accumulators of O and 32 of S a thread, past what
// ptxas holds without spilling at hd 128's 64 + 32: there a thread owns 4
// query rows (ty*4, one group) and the block has 4 BQ threads in a (BQ/4)
// x 16 grid, so O and S take 64 + 16 registers and no product is done
// twice.  Shared
// memory: the scaled Q tile [BQ][hd], K [BK][hd + 4], V [BK][hd] and P^T
// [BK][BQ + 4], all f32.  S = Q K^T takes, per 4 steps of d, 8 float4 of Q
// (one address per warp half: a broadcast) and BK/16 float4 of K (the
// padded rows put 8 neighbouring lanes on 32 banks) for 32 BK/16 FMAs; the
// row max and, at the end, the row sum reduce over the 16 lanes that share
// a row by __shfl_xor.  P goes to shared memory once, transposed; O += P V
// reads 2 float4 of P (a broadcast) and hd/16 floats of V a key.  K and V
// tiles come by cp.async, 16 bytes a thread, zero-filled past Skv: V's copy
// is issued before S's product and K's next tile before O += P V, so each
// overlaps a product.  At hd <= 64 every instance holds 8 warps an SM or
// more (fa_128x128: one block of 8; fa_64x64: three blocks of 4).
// Where the four tiles pass 227 KB (fa_128x128 at hd 128), P is written
// over K, and K's next copy waits for O += P V.  At hd 256 only fa_64x64
// is built: its four tiles take 215,040 bytes, fa_128x128's would not fit
// even with P over K (395,264).
//
// hd 256 in bf16 (fa_64x64 only: fa_128x128's tiles would take 328,960
// bytes): one warpgroup of 128 threads, so ptxas may give a thread 255
// registers, and its 64 x 256 f32 O tile (128 a thread) with S (32) and P
// (16, and 16 of P's remainder) fit.  O += P V is two wgmma.m64n128k16 a
// k-step for each half of O's columns (V's 64-column chunks 0-1 and 2-3),
// one for P's bf16 head and one for its remainder.  TMA boxes stay 64
// columns wide.  These instances serve recurrentgemma-2b's local
// attention (10 query heads over 1 KV head, window 2048).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "simt.cuh"
#include "hopper.cuh"

namespace {

// ------------------------------------------------------------- float32

constexpr float kNegInf = -1e30f;

// One float32 instance.  THREADS = 16 BQ / TM threads in a TY x 16 grid;
// thread (ty, tx) owns TM query rows, ty*4 + {0..3} in each of NG = TM / 4
// groups BQ / NG rows apart (TM = 8 up to hd 128, 4 at hd 256), for both S
// and O; key columns tx + 16 c (c < TN) of S; and, in OG groups of OV,
// columns g * (HD / OG) + tx * OV + {0..OV-1} of O.
template <int BQ, int BK, int HD>
struct FaFfma {
  static constexpr int TX = 16;                    // threads along keys
  static constexpr int TM = HD > 128 ? 4 : 8;      // query rows a thread owns
  static constexpr int NG = TM / 4;                // in groups of 4, BQ/NG apart
  static constexpr int TY = BQ / TM;               // threads along queries
  static constexpr int THREADS = TX * TY;
  static constexpr int TN = BK / TX;               // key columns a thread owns
  static constexpr int OC = HD / TX;               // O columns a thread owns
  static constexpr int OV = OC < 4 ? OC : 4;       // their vector width
  static constexpr int OG = OC / OV;               // and groups
  static constexpr int KS = HD + 4;                // padded row of K
  static constexpr int PS = BQ + 4;                // padded row of P^T
  // floats of Q [BQ][HD] (scaled), K [BK][KS], V [BK][HD], P^T [BK][PS]
  static constexpr int QF = BQ * HD, KF = BK * KS, VF = BK * HD, PF = BK * PS;
  // Where the four do not fit in 227 KB (fa_128x128 at hd 128), P is
  // written over K once every thread is done with K; K's next tile is then
  // copied after O += P V instead of during it.
  static constexpr bool ALIAS = 4 * (QF + KF + VF + PF) > 232448;
  static constexpr int KPF = ALIAS ? (KF > PF ? KF : PF) : KF + PF;
  static constexpr size_t SMEM = 4 * (size_t)(QF + KPF + VF);
  static_assert(BQ % 32 == 0 && BK % TX == 0 && HD % TX == 0 && TM % 4 == 0,
                "bad tile");
  static_assert(OC == 1 || OC == 2 || OC % 4 == 0, "bad head dim");
};

// minBlocks 1: without it ptxas caps fa_64x64 at 168 registers and spills
// at hd 128.
template <int BQ, int BK, int HD>
__global__ void __launch_bounds__(FaFfma<BQ, BK, HD>::THREADS, 1)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int H, int Hkv, int Sq, int Skv, int causal,
              int window, int q_offset, float scale) {
  using S = FaFfma<BQ, BK, HD>;
  using namespace simt;
  constexpr int TM = S::TM, TN = S::TN, TX = S::TX, NT = S::THREADS, NG = S::NG;
  constexpr int OC = S::OC, OV = S::OV, OG = S::OG, KS = S::KS, PS = S::PS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + S::QF;
  float* Ps = Ks + (S::ALIAS ? 0 : S::KF);
  float* Vs = Qs + S::QF + S::KPF;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  const float* qh = q + (size_t)b * Sq * q_row + (size_t)h * HD;
  const float* kh = k + (size_t)b * Skv * kv_row + (size_t)hk * HD;
  const float* vh = v + (size_t)b * Skv * kv_row + (size_t)hk * HD;
  auto row = [&](int r) { return (r / 4) * (BQ / NG) + ty * 4 + r % 4; };

  // K or V rows [k0, k0 + BK) into dst (row stride ds) by 16-byte copies,
  // zeros past Skv.
  auto load_kv = [&](float* dst, int ds, const float* src, int k0) {
    for (int e = tid; e < BK * HD / 4; e += NT) {
      const int r = e / (HD / 4), c = 4 * (e % (HD / 4));
      const bool ok = k0 + r < Skv;
      cp_async16(dst + r * ds + c, ok ? src + (size_t)(k0 + r) * kv_row + c : src, ok);
    }
  };

  // Q once, scaled in f32 as the TPU kernel scales it; zeros past Sq.
  for (int e = tid; e < BQ * HD / 4; e += NT) {
    const int r = e / (HD / 4), c = 4 * (e % (HD / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = ld4(qh + (size_t)(q0 + r) * q_row + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    st4(Qs + r * HD + c, x);
  }
  load_kv(Ks, KS, kh, 0);
  cp_async_commit();

  float m[TM], l[TM], acc[TM][OC];     // l: this thread's columns only
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[r][c] = 0.f;
  }

  const int NKV = (Skv + BK - 1) / BK;
  for (int j = 0; j < NKV; ++j) {
    const int k0 = j * BK;
    load_kv(Vs, HD, vh, k0);           // V's copy overlaps S's product
    cp_async_commit();
    cp_async_wait<1>();                // K tile j (and Q, by the barrier)
    __syncthreads();

    // S = (scale q) K^T: per 4 steps of d, TM float4 of Q (a broadcast) and
    // TN float4 of K (rows tx + 16 c: 8 lanes on 32 banks) for 4 TM TN FFMAs.
    float s[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kf[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) kf[c] = ld4(Ks + (tx + TX * c) * KS + d);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 qf = ld4(Qs + row(r) * HD + d);
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          s[r][c] = fmaf(qf.x, kf[c].x, s[r][c]);
          s[r][c] = fmaf(qf.y, kf[c].y, s[r][c]);
          s[r][c] = fmaf(qf.z, kf[c].z, s[r][c]);
          s[r][c] = fmaf(qf.w, kf[c].w, s[r][c]);
        }
      }
    }

    // Mask (add -1e30), row max over the 16 lanes that share a row, P =
    // exp(S - m), rescale l and O by exp(m_old - m_new).
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int qp = q_offset + q0 + row(r);
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int kp = k0 + tx + TX * c;
        bool keep = kp < Skv;
        if (causal) {
          keep = keep && qp >= kp;
          if (window > 0) keep = keep && (qp - kp) < window;
        }
        if (!keep) s[r][c] += kNegInf;
        mt = fmaxf(mt, s[r][c]);
      }
#pragma unroll
      for (int x = 1; x < TX; x *= 2) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, x));
      const float m_new = fmaxf(m[r], mt);
      const float corr = expf(m[r] - m_new);
      m[r] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        ps += s[r][c];
      }
      l[r] = l[r] * corr + ps;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[r][c] *= corr;
    }

    // P^T [key][query] into shared memory once: rows tx + 16 c, 8 lanes on
    // 32 banks (PS = BQ + 4).
    if constexpr (S::ALIAS) __syncthreads();   // every thread is done with K
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      float* pr = Ps + (tx + TX * c) * PS + ty * 4;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        st4(pr + g * (BQ / NG), make_float4(s[4 * g][c], s[4 * g + 1][c],
                                            s[4 * g + 2][c], s[4 * g + 3][c]));
    }
    cp_async_wait<0>();                // V tile j
    __syncthreads();                   // P and V visible; K free
    if (!S::ALIAS && j + 1 < NKV) load_kv(Ks, KS, kh, k0 + BK);
    cp_async_commit();                 // K's next copy overlaps O += P V

    // O += P V: per key, NG float4 of P (a broadcast) and OG vectors of V.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float4 pg[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) pg[g] = ld4(Ps + kk * PS + g * (BQ / NG) + ty * 4);
      float vv[OC];
#pragma unroll
      for (int g = 0; g < OG; ++g) ldv<OV>(Vs + kk * HD + g * (HD / OG) + tx * OV, vv + g * OV);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float p = lane(pg[r / 4], r % 4);
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
    __syncthreads();                   // every thread is done with P and V
    if (S::ALIAS && j + 1 < NKV) {
      load_kv(Ks, KS, kh, k0 + BK);
      cp_async_commit();
    }
  }

  cp_async_wait<0>();                  // nothing left in flight at exit

  // l over the 16 lanes of a row, clamp, divide, store; lse = m + log l
  // (scaled scores, natural units) where the caller asks for it.
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    float lr = l[r];
#pragma unroll
    for (int x = 1; x < TX; x *= 2) lr += __shfl_xor_sync(0xffffffffu, lr, x);
    const int qr = q0 + row(r);
    if (qr >= Sq) continue;
    const float lc = fmaxf(lr, 1e-30f);
    if (lse != nullptr && tx == 0) lse[(size_t)bh * Sq + qr] = m[r] + logf(lc);
    float out[OC];
#pragma unroll
    for (int c = 0; c < OC; ++c) out[c] = acc[r][c] / lc;
    float* orow = o + (size_t)b * Sq * q_row + (size_t)qr * q_row + (size_t)h * HD;
#pragma unroll
    for (int g = 0; g < OG; ++g) stv<OV>(orow + g * (HD / OG) + tx * OV, out + g * OV);
  }
}

template <int BQ, int BK, int HD>
cudaError_t prepare_ffma() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_fwd_kernel<BQ, BK, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FaFfma<BQ, BK, HD>::SMEM);
  return attr;
}

template <int BQ, int BK, int HD>
cudaError_t launch_ffma(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int Hkv, int Sq, int Skv,
                        int causal, int window, int q_offset, float scale,
                        cudaStream_t stream) {
  using S = FaFfma<BQ, BK, HD>;
  const cudaError_t attr = prepare_ffma<BQ, BK, HD>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  fa_fwd_kernel<BQ, BK, HD><<<grid, S::THREADS, S::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hkv, Sq,
      Skv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <int BQ, int BK, int HD>
long long occupancy_ffma() {
  using S = FaFfma<BQ, BK, HD>;
  const cudaError_t attr = prepare_ffma<BQ, BK, HD>();
  if (attr != cudaSuccess) return -(long long)attr;
  return simt::blocks_per_sm(fa_fwd_kernel<BQ, BK, HD>, S::THREADS, S::SMEM);
}

// ------------------------------------------------------------- bfloat16

template <int BQ, int BK, int HD>
struct FaWgmma {
  static constexpr int NWG = BQ / 64;              // consumer warpgroups
  static constexpr int NC = NWG * 128;             // consumer threads
  // No producer warp: a 9th warp would make ptxas budget registers for
  // three warpgroups (168 a thread) and spill at hd 128.  Thread 0 issues
  // the TMA loads between its own products instead.
  static constexpr int THREADS = NC;
  static constexpr int CH = HD < 64 ? HD : 64;     // column chunk (elements)
  static constexpr int SW = CH * 2;                // swizzle bytes
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;     // one K or V tile
  static constexpr int ST = 2;                     // ring stages
  // 1024 bytes of slack to align the tiles, 256 for the barriers.
  static constexpr size_t SMEM = 1024 + (size_t)Q_BYTES + 2 * ST * KV_BYTES + 256;
  static constexpr int ON = HD < 128 ? HD : 128;   // O columns a P V wgmma covers
  static_assert(BQ % 64 == 0 && (BK == 64 || BK == 128), "bad tile");
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128 || HD == 256,
                "bad head dim");
};

template <int BQ, int BK, int HD>
__global__ void __launch_bounds__(FaWgmma<BQ, BK, HD>::THREADS)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
                int Hkv, int Sq, int Skv, int causal, int window, int q_offset,
                float scale,
                long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                long long v_sh, int tma) {
  using S = FaWgmma<BQ, BK, HD>;
  using namespace hopper;
  constexpr float kNeg = -1e30f;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;
  auto sk = [&](int s) { return smem + S::Q_BYTES + s * 2 * S::KV_BYTES; };
  auto sv = [&](int s) { return sk(s) + S::KV_BYTES; };
  const uint32_t bars = smem_u32(smem + S::Q_BYTES + 2 * S::ST * S::KV_BYTES);
  const uint32_t qfull = bars;
  auto kfull = [&](int s) { return bars + 8 * (1 + s); };
  auto vfull = [&](int s) { return bars + 8 * (1 + S::ST + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * S::ST + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int NT = (Skv + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < S::ST; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(vfull(s), 1);
      mbar_init(empty(s), S::NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 issues TMA: Q once, then K and V tile j into stage j % ST.
  auto issue_kv = [&](int j) {
    const int s = j % S::ST;
    mbar_expect_tx(kfull(s), S::KV_BYTES);
#pragma unroll
    for (int c = 0; c < HD / S::CH; ++c)
      tma_load_4d(smem_u32(sk(s) + c * BK * S::CH * 2), &map_k, kfull(s),
                  c * S::CH, hk, j * BK, b);
    mbar_expect_tx(vfull(s), S::KV_BYTES);
#pragma unroll
    for (int c = 0; c < HD / S::CH; ++c)
      tma_load_4d(smem_u32(sv(s) + c * BK * S::CH * 2), &map_v, vfull(s),
                  c * S::CH, hk, j * BK, b);
  };
  if (tma && tid == 0) {
    mbar_expect_tx(qfull, S::Q_BYTES);
#pragma unroll
    for (int c = 0; c < HD / S::CH; ++c)
      tma_load_4d(smem_u32(sq + c * BQ * S::CH * 2), &map_q, qfull, c * S::CH,
                  h, q0, b);
    for (int j = 0; j < S::ST && j < NT; ++j) issue_kv(j);
  }

  const int wg = tid / 128, w = (tid % 128) / 32, l = tid % 32;
  // This thread's two query rows (block-local) and their positions.
  const int row0 = wg * 64 + 16 * w + l / 4;
  const int qp0 = q_offset + q0 + row0, qp1 = qp0 + 8;
  const __nv_bfloat16* kh = k + (int64_t)b * k_sb + (int64_t)hk * k_sh;
  const __nv_bfloat16* vh = v + (int64_t)b * v_sb + (int64_t)hk * v_sh;
  if (!tma) {
    load_tile_sync<BQ, HD, S::CH, S::NC>(
        sq, q + (int64_t)b * q_sb + (int64_t)h * q_sh + (int64_t)q0 * q_ss, q_ss,
        Sq - q0, HD, tid);
  } else {
    mbar_wait(qfull, 0);
  }

  float sacc[BK / 2], oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // l: this thread's columns

  const uint32_t q_base = smem_u32(sq) + wg * 64 * S::CH * 2;
  for (int j = 0; j < NT; ++j) {
    const int k0 = j * BK;
    int s = 0;
    if (tma) {
      s = j % S::ST;
      mbar_wait(kfull(s), (j / S::ST) & 1);
    } else {
      if (j > 0) named_sync(1, S::NC);           // stage 0 is read by all
      load_tile_sync<BK, HD, S::CH, S::NC>(sk(0), kh + (int64_t)k0 * k_ss, k_ss,
                                            Skv - k0, HD, tid);
      load_tile_sync<BK, HD, S::CH, S::NC>(sv(0), vh + (int64_t)k0 * v_ss, v_ss,
                                            Skv - k0, HD, tid);
      fence_proxy_async();
      named_sync(1, S::NC);
    }

    // S = Q K^T, both from shared memory.
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
    const uint32_t k_base = smem_u32(sk(s));
    fence_regs<BK / 2>(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = (kk * 16) / S::CH, wo = (kk * 16) % S::CH;
      const uint64_t da = make_desc<S::SW>(q_base + c * BQ * S::CH * 2 + wo * 2, 16,
                                           8 * S::CH * 2);
      const uint64_t db = make_desc<S::SW>(k_base + c * BK * S::CH * 2 + wo * 2, 16,
                                           8 * S::CH * 2);
      wgmma_ss<BK, 0>(sacc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(sacc);

    // Scale, mask (additive -1e30), row max over the quad.
    float mt0 = kNeg, mt1 = kNeg;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * jj + 2 * (l % 4) + (e & 1);
        const int qp = (e < 2) ? qp0 : qp1;
        bool keep = kp < Skv;
        if (causal) {
          keep = keep && qp >= kp;
          if (window > 0) keep = keep && (qp - kp) < window;
        }
        float x = sacc[4 * jj + e] * scale;
        if (!keep) x += kNeg;
        sacc[4 * jj + e] = x;
        if (e < 2) mt0 = fmaxf(mt0, x);
        else mt1 = fmaxf(mt1, x);
      }
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float corr0 = exp2f((m0 - mn0) * kLog2e);
    const float corr1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;

    // P = exp(S - m) in f32 for l; the A fragments of P V are its bf16
    // rounding (pa) and the bf16 rounding of what that leaves (pr), so
    // that P reaches the product to ~2^-16 of itself, not 2^-8.
    uint32_t pa[BK / 16][4], pr[BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      const float p0 = exp2f((sacc[4 * jj + 0] - mn0) * kLog2e);
      const float p1 = exp2f((sacc[4 * jj + 1] - mn0) * kLog2e);
      const float p2 = exp2f((sacc[4 * jj + 2] - mn1) * kLog2e);
      const float p3 = exp2f((sacc[4 * jj + 3] - mn1) * kLog2e);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      split_bf16(p0, p1, pa[jj / 2][(jj % 2) * 2 + 0],
                 pr[jj / 2][(jj % 2) * 2 + 0]);
      split_bf16(p2, p3, pa[jj / 2][(jj % 2) * 2 + 1],
                 pr[jj / 2][(jj % 2) * 2 + 1]);
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      oacc[4 * jj + 0] *= corr0;
      oacc[4 * jj + 1] *= corr0;
      oacc[4 * jj + 2] *= corr1;
      oacc[4 * jj + 3] *= corr1;
    }

    // O += P V for P's bf16 head and its remainder, from registers, V
    // MN-major from shared memory; at hd 256 for each half of O's columns
    // (ON = 128).
    if (tma) mbar_wait(vfull(s), (j / S::ST) & 1);
    const uint32_t v_base = smem_u32(sv(s));
    fence_regs<HD / 2>(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < HD / S::ON; ++n) {
        const uint64_t db = make_desc<S::SW>(
            v_base + n * (S::ON / S::CH) * BK * S::CH * 2 + kk * 16 * S::CH * 2,
            BK * S::CH * 2, 8 * S::CH * 2);
        wgmma_rs<S::ON, 1>(oacc + n * (S::ON / 2), pa[kk], db);
        wgmma_rs<S::ON, 1>(oacc + n * (S::ON / 2), pr[kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<HD / 2>(oacc);
    if (tma) {
      mbar_arrive(empty(s));
      // refill this stage once every consumer is done with it
      if (tid == 0 && j + S::ST < NT) {
        mbar_wait(empty(s), (j / S::ST) & 1);
        issue_kv(j + S::ST);
      }
    }
  }

  // l over the quad, clamp, divide, store bf16.  m is in natural units (the
  // exponentials above take exp2f of (s - m) log2 e), so lse = m + log l
  // is the reference's, where the caller asks for it.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
  const int64_t o_row = (int64_t)H * HD;
  __nv_bfloat16* ob = o + (int64_t)b * Sq * o_row + (int64_t)h * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qr = q0 + row0 + 8 * hh;
    if (qr >= Sq) continue;
    const float inv = hh ? inv1 : inv0;
    if (lse != nullptr && l % 4 == 0)
      lse[(int64_t)bh * Sq + qr] = (hh ? m1 : m0) + logf(hh ? lc1 : lc0);
    __nv_bfloat16* orow = ob + (int64_t)qr * o_row;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      const int col = 8 * jj + 2 * (l % 4);
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
          oacc[4 * jj + 2 * hh] * inv, oacc[4 * jj + 2 * hh + 1] * inv);
    }
  }
}

template <int BQ, int BK, int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int Hkv, int Sq, int Skv,
                         int causal,
                         int window, int q_offset, float scale,
                         const long long* qs, const long long* ks,
                         const long long* vs, int path, cudaStream_t stream) {
  using S = FaWgmma<BQ, BK, HD>;
  auto kern = fa_wgmma_kernel<BQ, BK, HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_q{}, map_k{}, map_v{};
  if (path == 0) {
    // (hd, heads, S, B), innermost first; strides of heads, S, B.
    const uint64_t dq[4] = {HD, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
    const uint64_t dk[4] = {HD, (uint64_t)Hkv, (uint64_t)Skv, (uint64_t)B};
    const int64_t sq[3] = {qs[2], qs[1], qs[0]};
    const int64_t sk[3] = {ks[2], ks[1], ks[0]};
    const int64_t sv[3] = {vs[2], vs[1], vs[0]};
    const uint32_t bq[4] = {(uint32_t)S::CH, 1, BQ, 1};
    const uint32_t bk[4] = {(uint32_t)S::CH, 1, BK, 1};
    cudaError_t err = hopper::make_map(&map_q, q, 4, dq, sq, bq, S::SW);
    if (err == cudaSuccess) err = hopper::make_map(&map_k, k, 4, dk, sk, bk, S::SW);
    if (err == cudaSuccess) err = hopper::make_map(&map_v, v, 4, dk, sv, bk, S::SW);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, S::THREADS, S::SMEM, stream>>>(
      map_q, map_k, map_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), lse, H, Hkv, Sq, Skv, causal, window,
      q_offset, scale, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      path == 0);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); lse: null, or (B, H, Sq)
// float32 for the log-sum-exp of each row's scaled scores (the backward's
// input; every inference launch passes null).  dtype: 0 = float32
// (contiguous tensors at 16-byte aligned addresses; strides and path
// unused), 1 = bfloat16.  Strides
// of q, k, v, each (batch, sequence, head) in elements, the head dim
// contiguous; o is contiguous.  path (bf16): 0 = TMA, 1 = the consumers'
// own loads.  window <= 0 means none.  Returns a cudaError_t (0 =
// success); cudaErrorInvalidValue for a config or head dim that was not
// instantiated.
extern "C" int pm2lat_flash_attention(int bq, int bk, int hd, int dtype, int path,
                                      const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int H, int Hkv, int Sq,
                                      int Skv, int causal, int window,
                                      int q_offset, float scale, long long q_sb,
                                      long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss,
                                      long long k_sh, long long v_sb,
                                      long long v_ss, long long v_sh,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh},
                  vs[3] = {v_sb, v_ss, v_sh};
  if (dtype == 0) {
#define PM2LAT_FA_F32(BQ, BK, HD)                                             \
    if (bq == BQ && bk == BK && hd == HD)                                     \
      return launch_ffma<BQ, BK, HD>(q, k, v, o, lse_f, B, H, Hkv, Sq, Skv,   \
                                     causal, window, q_offset, scale, s);
    PM2LAT_FA_F32(64, 64, 16)
    PM2LAT_FA_F32(64, 64, 32)
    PM2LAT_FA_F32(64, 64, 64)
    PM2LAT_FA_F32(64, 64, 128)
    PM2LAT_FA_F32(64, 64, 256)
    PM2LAT_FA_F32(128, 128, 16)
    PM2LAT_FA_F32(128, 128, 32)
    PM2LAT_FA_F32(128, 128, 64)
    PM2LAT_FA_F32(128, 128, 128)
#undef PM2LAT_FA_F32
  } else if (dtype == 1) {
#define PM2LAT_FA_BF16(BQ, BK, HD)                                            \
    if (bq == BQ && bk == BK && hd == HD)                                     \
      return launch_wgmma<BQ, BK, HD>(q, k, v, o, lse_f, B, H, Hkv, Sq, Skv,  \
                                      causal, window, q_offset, scale, qs,    \
                                      ks, vs, path, s);
    PM2LAT_FA_BF16(64, 64, 16)
    PM2LAT_FA_BF16(64, 64, 32)
    PM2LAT_FA_BF16(64, 64, 64)
    PM2LAT_FA_BF16(64, 64, 128)
    PM2LAT_FA_BF16(64, 64, 256)
    PM2LAT_FA_BF16(128, 128, 16)
    PM2LAT_FA_BF16(128, 128, 32)
    PM2LAT_FA_BF16(128, 128, 64)
    PM2LAT_FA_BF16(128, 128, 128)
#undef PM2LAT_FA_BF16
  }
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one block of an instance is launched with, in
// bytes; -1 for an instance that does not exist.
extern "C" long long pm2lat_flash_attention_smem(int bq, int bk, int hd, int dtype) {
#define PM2LAT_FA_SMEM(BQ, BK, HD)                                 \
  if (bq == BQ && bk == BK && hd == HD)                            \
    return dtype == 0 ? (long long)FaFfma<BQ, BK, HD>::SMEM        \
                      : (long long)FaWgmma<BQ, BK, HD>::SMEM;
  if (dtype != 0 && dtype != 1) return -1;
  PM2LAT_FA_SMEM(64, 64, 16)
  PM2LAT_FA_SMEM(64, 64, 32)
  PM2LAT_FA_SMEM(64, 64, 64)
  PM2LAT_FA_SMEM(64, 64, 128)
  PM2LAT_FA_SMEM(64, 64, 256)
  PM2LAT_FA_SMEM(128, 128, 16)
  PM2LAT_FA_SMEM(128, 128, 32)
  PM2LAT_FA_SMEM(128, 128, 64)
  PM2LAT_FA_SMEM(128, 128, 128)
#undef PM2LAT_FA_SMEM
  return -1;
}

// Resident blocks per SM of a float32 instance, as the card's occupancy
// calculator gives them for its threads, registers and shared memory; -1
// for an instance that does not exist, a negative cudaError_t if the query
// fails.
extern "C" long long pm2lat_flash_attention_blocks_per_sm(int bq, int bk, int hd) {
#define PM2LAT_FA_OCC(BQ, BK, HD)                  \
  if (bq == BQ && bk == BK && hd == HD)            \
    return occupancy_ffma<BQ, BK, HD>();
  PM2LAT_FA_OCC(64, 64, 16)
  PM2LAT_FA_OCC(64, 64, 32)
  PM2LAT_FA_OCC(64, 64, 64)
  PM2LAT_FA_OCC(64, 64, 128)
  PM2LAT_FA_OCC(64, 64, 256)
  PM2LAT_FA_OCC(128, 128, 16)
  PM2LAT_FA_OCC(128, 128, 32)
  PM2LAT_FA_OCC(128, 128, 64)
  PM2LAT_FA_OCC(128, 128, 128)
#undef PM2LAT_FA_OCC
  return -1;
}

extern "C" const char* pm2lat_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
