// K1 adalomo_stats: factored second-moment statistics of one gradient.
//
// Replaces the TPU kernel _stats_kernel / stats_pallas of
// src/repro/kernels/adalomo_update/adalomo_update.py.  Computes, for every
// slice l of g [L, m, n]:
//     r'[i] = beta * r[i] + (1 - beta) * sum_j (g[i,j]^2 + eps_stat)
//     c'[j] = beta * c[j] + (1 - beta) * sum_i (g[i,j]^2 + eps_stat)
// in fp32 whatever g's type, written in place into r and c.
//
// Bound: bytes.  One read of g and O(m + n) of state; about 3 operations
// per element.  The TPU version accumulates into resident output tiles over
// a sequential grid; Hopper's blocks run in no order, so row sums finish
// inside the block that owns the rows, and column sums go to per-block
// partials [L, n_row_blocks, n] that a second small kernel adds in block
// order.  g is read exactly once.
#include "common.cuh"

namespace adalomo {

template <typename G>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const G* __restrict__ g, float* __restrict__ r,
             float* __restrict__ col_part, const float* __restrict__ beta_p,
             float eps_stat, int m, int n) {
  const int rb = blockIdx.x, l = blockIdx.y, nrb = gridDim.x;
  const int row0 = rb * kRows;
  const G* gl = g + (size_t)l * m * n;
  float* cp = col_part + ((size_t)l * nrb + rb) * n;

  float row_acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) row_acc[i] = 0.f;

  for (int col = threadIdx.x; col < n; col += kThreads) {
    float col_acc = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = row0 + i;
      if (row < m) {
        const float x = load_f32(gl, (size_t)row * n + col);
        const float g2 = x * x + eps_stat;
        row_acc[i] += g2;
        col_acc += g2;
      }
    }
    cp[col] = col_acc;
  }

  __shared__ float red[kRows][kWarps];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float v = warp_sum(row_acc[i]);
    if ((threadIdx.x & 31) == 0) red[i][threadIdx.x >> 5] = v;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int row = row0 + threadIdx.x;
    if (row < m) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x][w];
      const float beta = *beta_p;
      const size_t idx = (size_t)l * m + row;
      r[idx] = beta * r[idx] + (1.f - beta) * s;
    }
  }
}

// Adds the per-block column partials in block order and folds them into c.
// A block is 32 columns by kWarps groups; group w adds blocks w, w+kWarps,
// ..., and the groups are added in index order.
__global__ void __launch_bounds__(kThreads)
stats_finalize_kernel(const float* __restrict__ col_part,
                      float* __restrict__ c,
                      const float* __restrict__ beta_p, int nrb, int n) {
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane, l = blockIdx.y;
  __shared__ float red[kWarps][32];
  float s = 0.f;
  if (col < n) {
    const float* cp = col_part + (size_t)l * nrb * n + col;
    for (int b = grp; b < nrb; b += kWarps) s += cp[(size_t)b * n];
  }
  red[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && col < n) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w][lane];
    const float beta = *beta_p;
    const size_t idx = (size_t)l * n + col;
    c[idx] = beta * c[idx] + (1.f - beta) * total;
  }
}

}  // namespace adalomo

extern "C" int adalomo_rows_per_block() { return adalomo::kRows; }

// g [L, m, n] (g_dtype 0 = float32, 1 = bfloat16); r [L, m], c [L, n] fp32,
// updated in place; col_part [L, ceil(m / rows_per_block), n] fp32 scratch;
// beta one fp32 value in device memory.  Returns cudaGetLastError().
extern "C" int adalomo_stats_launch(const void* g, int g_dtype, void* r,
                                    void* c, void* col_part, const void* beta,
                                    float eps_stat, int L, int m, int n,
                                    void* stream) {
  using namespace adalomo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nrb = (m + kRows - 1) / kRows;
  const dim3 grid(nrb, L);
  float* rp = static_cast<float*>(r);
  float* cpp = static_cast<float*>(col_part);
  const float* bp = static_cast<const float*>(beta);
  if (g_dtype == kFloat32) {
    stats_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), rp, cpp, bp, eps_stat, m, n);
  } else if (g_dtype == kBFloat16) {
    stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), rp, cpp, bp, eps_stat, m, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 fgrid((n + 31) / 32, L);
  stats_finalize_kernel<<<fgrid, kThreads, 0, s>>>(
      cpp, static_cast<float*>(c), bp, nrb, n);
  return static_cast<int>(cudaGetLastError());
}
