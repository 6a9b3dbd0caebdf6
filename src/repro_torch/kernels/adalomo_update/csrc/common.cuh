// Shared pieces of the AdaLomo update kernels (Hopper, sm_90a).
//
// Both kernels read 16 bytes a thread and load: a thread owns kVec = 8
// consecutive columns of a row (one 16-byte load of bf16, two of fp32), so
// neighbouring threads read neighbouring addresses.  Where n % 8 != 0 or a
// pointer is not 16-byte aligned the same columns are read element by
// element (the ragged path), and an element outside [m, n] is never read and
// contributes nothing.
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
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;  // consecutive columns a thread owns

// dtype codes of the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Eight consecutive elements of T, kept as raw 16-byte words until used.
template <typename T>
struct Pack8 {
  static constexpr int kWords = (int)sizeof(T) * kVec / 16;  // bf16 1, fp32 2
  uint4 w[kWords];
};

__device__ __forceinline__ float elem(const Pack8<float>& pk, int i) {
  return reinterpret_cast<const float*>(pk.w)[i];
}
__device__ __forceinline__ float elem(const Pack8<__nv_bfloat16>& pk, int i) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(pk.w)[i]);
}

// The first `cnt` (1..8) elements at src; with kVector all 8 as 16-byte
// loads (src 16-byte aligned), else one at a time (the slots past cnt repeat
// element 0 and are never used).
template <bool kVector, bool kReadOnly, typename T>
__device__ __forceinline__ void load8(Pack8<T>& pk, const T* src, int cnt) {
  if constexpr (kVector) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < Pack8<T>::kWords; ++i)
      pk.w[i] = kReadOnly ? __ldg(s + i) : s[i];
  } else {
    T* e = reinterpret_cast<T*>(pk.w);
#pragma unroll
    for (int i = 0; i < kVec; ++i) e[i] = src[i < cnt ? i : 0];
  }
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
