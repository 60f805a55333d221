// Helpers of the float32 kernels, which run FFMA on the CUDA cores:
// asynchronous global-to-shared copies (cp.async, sm_80 and later) and
// short vector loads and stores of f32.
#pragma once

#include <cuda_runtime.h>

namespace simt {

// Copy 16 bytes (4 floats) from global memory at src into shared memory at
// dst without passing through registers; with pred false, write 16 zero
// bytes and read nothing.  Both addresses 16-byte aligned.  .cg: through L2
// only, as each tile is read from shared memory afterwards.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// The same for one float (4 bytes, any float's alignment).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// Close the group of copies this thread issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest groups are still in flight
// (groups complete in order).  Other threads' copies are visible only
// after a barrier that follows their own wait.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// N = 1, 2 or 4 consecutive floats at p (aligned to N floats) into out.
template <int N>
__device__ __forceinline__ void ldv(const float* p, float* out) {
  static_assert(N == 1 || N == 2 || N == 4, "vector of 1, 2 or 4 floats");
  if constexpr (N == 4) {
    const float4 v = ld4(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void stv(float* p, const float* in) {
  static_assert(N == 1 || N == 2 || N == 4, "vector of 1, 2 or 4 floats");
  if constexpr (N == 4) {
    st4(p, make_float4(in[0], in[1], in[2], in[3]));
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    *p = in[0];
  }
}

// Resident blocks of `kernel` on one SM at `threads` a block and `smem`
// bytes of dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// a negative cudaError_t if the query fails.
template <typename Kernel>
long long blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err == cudaSuccess ? n : -(long long)err;
}

}  // namespace simt
