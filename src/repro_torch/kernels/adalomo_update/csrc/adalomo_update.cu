// K2 adalomo_update: grouped-normalized AdaLomo update, applied in place.
//
// Replaces the TPU kernel _update_kernel / update_pallas of
// src/repro/kernels/adalomo_update/adalomo_update.py.  For every slice l of
// theta, g [L, m, n], with r', c' from K1 and the per-slice scalars
// scal[l] = (inv_denom_corr, lr, decay, clip):
//     v_hat = r'[i] * c'[j] * inv_denom_corr
//     u     = g / (sqrt(v_hat) + eps_div)        (g / (v_hat + eps_div) if
//                                                  `literal`)
//     scale = max(eps_rms, RMS(theta)) / max(1, RMS(u) / clip)
//     theta = theta * decay - lr * u * scale
// RMS(theta) is of the un-decayed theta; both RMS values divide by m * n of
// the real tensor.  All arithmetic is fp32 with one cast, at the store.  u
// is recomputed, never stored.
//
// Bound: bytes.  The function must read g and theta and write theta; the
// design reads g and theta twice, because the write needs sum(u^2) over the
// whole slice first.  The TPU version carries that sum in scratch memory
// across a sequential grid; here it is two launches: per-block partials
// [L, n_row_blocks, 2], then the apply pass, whose every block adds the
// slice's partials in the same fixed order.  The scalars come from a small
// fp32 device buffer, so a changed learning rate rebuilds nothing and the
// host never waits.
#include "common.cuh"

namespace adalomo {

__device__ __forceinline__ float update_direction(float g, float ri, float cj,
                                                  float inv, float eps_div,
                                                  int literal) {
  const float v_hat = (ri * cj) * inv;
  return literal ? g / (v_hat + eps_div) : g / (sqrtf(v_hat) + eps_div);
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
update_partials_kernel(const P* __restrict__ p, const G* __restrict__ g,
                       const float* __restrict__ r,
                       const float* __restrict__ c,
                       const float* __restrict__ scal,
                       float* __restrict__ partials, float eps_div,
                       int literal, int m, int n) {
  const int rb = blockIdx.x, l = blockIdx.y, nrb = gridDim.x;
  const int row0 = rb * kRows;
  const size_t base = (size_t)l * m * n;
  __shared__ float r_s[kRows];
  __shared__ float red[kWarps];
  if (threadIdx.x < kRows) {
    const int row = row0 + threadIdx.x;
    r_s[threadIdx.x] = row < m ? r[(size_t)l * m + row] : 0.f;
  }
  __syncthreads();
  const float inv = scal[l * 4 + 0];

  float su2 = 0.f, sp2 = 0.f;
  for (int col = threadIdx.x; col < n; col += kThreads) {
    const float cj = c[(size_t)l * n + col];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = row0 + i;
      if (row < m) {
        const size_t idx = base + (size_t)row * n + col;
        const float pv = load_f32(p, idx);
        const float u = update_direction(load_f32(g, idx), r_s[i], cj, inv,
                                         eps_div, literal);
        su2 += u * u;
        sp2 += pv * pv;
      }
    }
  }
  su2 = block_sum(su2, red);
  sp2 = block_sum(sp2, red);
  if (threadIdx.x == 0) {
    float* out = partials + ((size_t)l * nrb + rb) * 2;
    out[0] = su2;
    out[1] = sp2;
  }
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
update_apply_kernel(P* p, const G* __restrict__ g,
                    const float* __restrict__ r, const float* __restrict__ c,
                    const float* __restrict__ scal,
                    const float* __restrict__ partials, float eps_div,
                    float eps_rms, int literal, int m, int n) {
  const int rb = blockIdx.x, l = blockIdx.y, nrb = gridDim.x;
  const int row0 = rb * kRows;
  const size_t base = (size_t)l * m * n;
  __shared__ float r_s[kRows];
  __shared__ float red[kWarps];
  if (threadIdx.x < kRows) {
    const int row = row0 + threadIdx.x;
    r_s[threadIdx.x] = row < m ? r[(size_t)l * m + row] : 0.f;
  }

  // The slice's two sums, added in the same order by every block.
  float su2 = 0.f, sp2 = 0.f;
  const float* part = partials + (size_t)l * nrb * 2;
  for (int k = threadIdx.x; k < nrb; k += kThreads) {
    su2 += part[2 * k];
    sp2 += part[2 * k + 1];
  }
  su2 = block_sum(su2, red);  // also orders the writes of r_s
  sp2 = block_sum(sp2, red);

  const float n_elems = (float)((long long)m * (long long)n);
  const float rms_u = sqrtf(su2 / n_elems);
  const float rms_p = sqrtf(sp2 / n_elems);
  const float inv = scal[l * 4 + 0];
  const float lr = scal[l * 4 + 1];
  const float decay = scal[l * 4 + 2];
  const float clip = scal[l * 4 + 3];
  const float scale = fmaxf(eps_rms, rms_p) / fmaxf(1.f, rms_u / clip);

  for (int col = threadIdx.x; col < n; col += kThreads) {
    const float cj = c[(size_t)l * n + col];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = row0 + i;
      if (row < m) {
        const size_t idx = base + (size_t)row * n + col;
        const float pv = load_f32(p, idx);
        const float u = update_direction(load_f32(g, idx), r_s[i], cj, inv,
                                         eps_div, literal);
        store_f32(p, idx, pv * decay - lr * u * scale);
      }
    }
  }
}

template <typename P, typename G>
int launch_update(void* p, const void* g, const float* r, const float* c,
                  const float* scal, float* partials, float eps_div,
                  float eps_rms, int literal, int L, int m, int n,
                  cudaStream_t s) {
  const int nrb = (m + kRows - 1) / kRows;
  const dim3 grid(nrb, L);
  update_partials_kernel<P, G><<<grid, kThreads, 0, s>>>(
      static_cast<const P*>(p), static_cast<const G*>(g), r, c, scal,
      partials, eps_div, literal, m, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  update_apply_kernel<P, G><<<grid, kThreads, 0, s>>>(
      static_cast<P*>(p), static_cast<const G*>(g), r, c, scal, partials,
      eps_div, eps_rms, literal, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace adalomo

// p, g [L, m, n] (dtype 0 = float32, 1 = bfloat16), p updated in place;
// r [L, m], c [L, n] fp32 from adalomo_stats_launch; scal [L, 4] fp32 =
// (inv_denom_corr, lr, decay, clip); partials [L, ceil(m / rows_per_block),
// 2] fp32 scratch.  Returns cudaGetLastError().
extern "C" int adalomo_update_launch(void* p, int p_dtype, const void* g,
                                     int g_dtype, const void* r,
                                     const void* c, const void* scal,
                                     void* partials, float eps_div,
                                     float eps_rms, int literal, int L, int m,
                                     int n, void* stream) {
  using namespace adalomo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const float* cp = static_cast<const float*>(c);
  const float* sp = static_cast<const float*>(scal);
  float* pp = static_cast<float*>(partials);
#define ADALOMO_LAUNCH(P, G)                                               \
  return launch_update<P, G>(p, g, rp, cp, sp, pp, eps_div, eps_rms,       \
                             literal, L, m, n, s)
  if (p_dtype == kFloat32 && g_dtype == kFloat32)
    ADALOMO_LAUNCH(float, float);
  if (p_dtype == kFloat32 && g_dtype == kBFloat16)
    ADALOMO_LAUNCH(float, __nv_bfloat16);
  if (p_dtype == kBFloat16 && g_dtype == kFloat32)
    ADALOMO_LAUNCH(__nv_bfloat16, float);
  if (p_dtype == kBFloat16 && g_dtype == kBFloat16)
    ADALOMO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef ADALOMO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
