// Shared pieces of the AdaLomo update kernels (Hopper, sm_90a).
//
// Tiling used by every kernel here: a block owns kRows consecutive rows of
// one [m, n] slice and walks the columns in chunks of kThreads, one column
// per thread.  Neighbouring threads read neighbouring addresses, each thread
// has kRows independent loads in flight, and the ragged edge is a bounds
// check: an element outside [m, n] is never read and contributes nothing.
//
// Every reduction runs in a fixed order (per-thread running sum, shuffle
// tree inside a warp, warps in index order, blocks in index order), so the
// same inputs give bit-identical outputs run to run.  No float atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace adalomo {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kWarps = kThreads / 32;

// dtype codes of the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T>
__device__ __forceinline__ float load_f32(const T* p, size_t i);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p, size_t i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// The one cast of the update: fp32 result to the parameter's type,
// round-to-nearest-even.
template <typename T>
__device__ __forceinline__ void store_f32(T* p, size_t i, float v);
template <>
__device__ __forceinline__ void store_f32<float>(float* p, size_t i, float v) {
  p[i] = v;
}
template <>
__device__ __forceinline__ void store_f32<__nv_bfloat16>(__nv_bfloat16* p,
                                                         size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // complete in lane 0
}

// Sum of v over the block, in a fixed order; every thread gets the result.
// `red` is kWarps floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // `red` may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

}  // namespace adalomo
