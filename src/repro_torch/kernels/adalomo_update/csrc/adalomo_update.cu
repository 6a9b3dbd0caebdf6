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
// Bound: bytes.  The function must read g and theta and write theta (3
// passes over the slice); a few operations per element.  The write needs
// sum(u^2) over the whole slice first, so this design makes 5 passes: a
// partials launch reads g and theta, an apply launch reads them again and
// writes theta.  The TPU version carries that sum in scratch memory across a
// sequential grid; here the partials launch leaves one (sum u^2, sum
// theta^2) per block in [L, n_blocks, 2], and every apply block adds its
// slice's partials in the same fixed order.  The scalars come from a small
// fp32 device buffer, so a changed learning rate rebuilds nothing and the
// host never waits.
//
// Design for the H100's memory system:
// * 16-byte loads: a thread owns 8 consecutive columns of a tile row (one
//   16-byte load of bf16, two of fp32), 16 threads span a tile's 128
//   columns and 16 rows make the tile, so a half-warp reads 256 or 512
//   contiguous bytes.  Where n % 8 != 0 or a pointer is not 16-byte aligned
//   the same tiles are read element by element (the ragged path); both are
//   common.cuh's Pack8 / load8, shared with K1.
// * Enough blocks: tiles of 16 x 128 are small enough that every
//   h2o-danube-1.8b shape (down to 2560 x 640) has more tiles than the grid
//   of 4 blocks on each of the 132 SMs; block b walks tiles b, b + n_blocks,
//   ... (the wrapper's `update_tiling`), a few at once so several 16-byte
//   loads of each thread are in flight.
// * Re-reads from L2: the apply launch walks each block's tiles in the
//   reverse order, so it first re-reads what the partials launch read last,
//   while that is still in the 50 MB L2.
// Every sum runs in a fixed order (a thread's tiles in walk order, the block
// in warp order, the partials in block order) and there are no atomics: the
// same inputs give bit-identical outputs.
//
// Sharded entries (ZeRO-3: theta and g are one rank's row or column shard of
// the tensor).  RMS(u) and RMS(theta) are of the whole tensor, so the pair
// splits at the sums: adalomo_update_partials_launch runs the partials
// launch and adds each slice's block partials, in the apply launch's order,
// into sums [L, 2] = (sum u^2, sum theta^2) of the shard; the caller adds
// those over the ranks; adalomo_update_apply_launch then runs the apply
// launch from the global sums, dividing by the global element count it is
// given.  With one rank the two give the whole-tensor entry's bits.
#include <stdint.h>

#include "common.cuh"

namespace adalomo {

constexpr int kTileCols = 128;
constexpr int kColThreads = kTileCols / kVec;        // 16
constexpr int kTileRows = kThreads / kColThreads;    // 16
constexpr int kMinBlocksPerSM = 4;

template <bool kVector>
__device__ __forceinline__ void load_c(float* cj, const float* src, int cnt) {
  if constexpr (kVector) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    cj[0] = a.x, cj[1] = a.y, cj[2] = a.z, cj[3] = a.w;
    cj[4] = b.x, cj[5] = b.y, cj[6] = b.z, cj[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) cj[i] = __ldg(src + (i < cnt ? i : 0));
  }
}

template <bool kVector>
__device__ __forceinline__ void store8(float* dst, const float* v, int cnt) {
  if constexpr (kVector) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (i < cnt) dst[i] = v[i];
  }
}
template <bool kVector>
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v,
                                       int cnt) {
  if constexpr (kVector) {
    uint4 w;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = w;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (i < cnt) dst[i] = __float2bfloat16_rn(v[i]);
  }
}

__device__ __forceinline__ float update_direction(float g, float ri, float cj,
                                                  float inv, float eps_div,
                                                  int literal) {
  const float v_hat = (ri * cj) * inv;
  return literal ? g / (v_hat + eps_div) : g / (sqrtf(v_hat) + eps_div);
}

// Block (b, l) of either launch.  Without kApply: the partial sums of u^2
// and theta^2 over block b's tiles into partials[l, b].  With kApply: the
// slice's scale from all its partials, then theta updated over the same
// tiles, walked in the reverse order.
template <typename P, typename G, bool kVector, bool kApply>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
update_kernel(P* p, const G* __restrict__ g, const float* __restrict__ r,
              const float* __restrict__ c, const float* __restrict__ scal,
              float* partials, const float* __restrict__ sums,
              float eps_div, float eps_rms, int literal, int m, int n,
              long long n_total) {
  // tiles whose loads are in flight together (an unroll of 4 spilled at the
  // 64 registers a thread that four blocks a SM allow)
  constexpr int kUnroll = kVector ? 2 : 1;
  const int b = blockIdx.x, l = blockIdx.y, nblk = gridDim.x;
  const int col_tiles = (n + kTileCols - 1) / kTileCols;
  const int tiles = (m + kTileRows - 1) / kTileRows * col_tiles;
  const int mine = b < tiles ? (tiles - 1 - b) / nblk + 1 : 0;
  const int tr = threadIdx.x / kColThreads;
  const int tc = (threadIdx.x % kColThreads) * kVec;
  const size_t base = (size_t)l * m * n;
  const float* rl = r + (size_t)l * m;
  const float* cl = c + (size_t)l * n;
  const float inv = scal[l * 4 + 0];
  __shared__ float red[kWarps];

  float scale = 0.f, lr = 0.f, decay = 0.f;
  if constexpr (kApply) {
    // the slice's two sums, added in the same order by every block, or the
    // global sums of a shard as the caller gives them
    float su2 = 0.f, sp2 = 0.f;
    if (sums != nullptr) {
      su2 = sums[2 * l];
      sp2 = sums[2 * l + 1];
    } else {
      const float* part = partials + (size_t)l * nblk * 2;
      for (int k = threadIdx.x; k < nblk; k += kThreads) {
        su2 += part[2 * k];
        sp2 += part[2 * k + 1];
      }
      su2 = block_sum(su2, red);
      sp2 = block_sum(sp2, red);
    }
    const float n_elems = (float)(n_total > 0 ? n_total
                                              : (long long)m * (long long)n);
    const float rms_u = sqrtf(su2 / n_elems);
    const float rms_p = sqrtf(sp2 / n_elems);
    lr = scal[l * 4 + 1];
    decay = scal[l * 4 + 2];
    const float clip = scal[l * 4 + 3];
    scale = fmaxf(eps_rms, rms_p) / fmaxf(1.f, rms_u / clip);
  }

  float su2 = 0.f, sp2 = 0.f;
  for (int k0 = 0; k0 < mine; k0 += kUnroll) {
    Pack8<P> pv[kUnroll];
    Pack8<G> gv[kUnroll];
    int row[kUnroll], col[kUnroll], cnt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u;
      const int tile = b + (kApply ? mine - 1 - k : k) * nblk;
      row[u] = tile / col_tiles * kTileRows + tr;
      col[u] = tile % col_tiles * kTileCols + tc;
      cnt[u] = k < mine && row[u] < m ? min(kVec, n - col[u]) : 0;
      if (cnt[u] > 0) {
        const size_t idx = base + (size_t)row[u] * n + col[u];
        load8<kVector, !kApply>(pv[u], p + idx, cnt[u]);
        load8<kVector, true>(gv[u], g + idx, cnt[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cnt[u] <= 0) continue;
      const float ri = rl[row[u]];
      float cj[kVec], out[kVec];
      load_c<kVector>(cj, cl + col[u], cnt[u]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (!kVector && i >= cnt[u]) continue;
        const float pf = elem(pv[u], i);
        const float uu = update_direction(elem(gv[u], i), ri, cj[i], inv,
                                          eps_div, literal);
        if constexpr (kApply) {
          out[i] = pf * decay - lr * uu * scale;
        } else {
          su2 += uu * uu;
          sp2 += pf * pf;
        }
      }
      if constexpr (kApply)
        store8<kVector>(p + base + (size_t)row[u] * n + col[u], out, cnt[u]);
    }
  }
  if constexpr (!kApply) {
    su2 = block_sum(su2, red);
    sp2 = block_sum(sp2, red);
    if (threadIdx.x == 0) {
      float* out = partials + ((size_t)l * nblk + b) * 2;
      out[0] = su2;
      out[1] = sp2;
    }
  }
}

// sums[l] = the block partials of slice l added as the apply launch adds
// them (one block a slice).
__global__ void __launch_bounds__(kThreads)
partials_sum_kernel(const float* __restrict__ partials,
                    float* __restrict__ sums, int nblk) {
  __shared__ float red[kWarps];
  const int l = blockIdx.x;
  float su2 = 0.f, sp2 = 0.f;
  const float* part = partials + (size_t)l * nblk * 2;
  for (int k = threadIdx.x; k < nblk; k += kThreads) {
    su2 += part[2 * k];
    sp2 += part[2 * k + 1];
  }
  su2 = block_sum(su2, red);
  sp2 = block_sum(sp2, red);
  if (threadIdx.x == 0) {
    sums[2 * l] = su2;
    sums[2 * l + 1] = sp2;
  }
}

// Which launches of the pair run: both (the whole-tensor entry), the
// partials launch and their sum (a shard's first half), or the apply launch
// from the given sums (its second half).
enum Stage { kBoth = 0, kPartials = 1, kApplyFromSums = 2 };

template <typename P, typename G, bool kVector>
int launch_pair(void* p, const void* g, const float* r, const float* c,
                const float* scal, float* partials, float* sums,
                long long n_total, int stage, float eps_div, float eps_rms,
                int literal, int L, int m, int n, int nblk, cudaStream_t s) {
  const dim3 grid(nblk, L);
  if (stage != kApplyFromSums) {
    update_kernel<P, G, kVector, false><<<grid, kThreads, 0, s>>>(
        static_cast<P*>(p), static_cast<const G*>(g), r, c, scal, partials,
        nullptr, eps_div, eps_rms, literal, m, n, 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stage == kPartials) {
    partials_sum_kernel<<<L, kThreads, 0, s>>>(partials, sums, nblk);
    return static_cast<int>(cudaGetLastError());
  }
  update_kernel<P, G, kVector, true><<<grid, kThreads, 0, s>>>(
      static_cast<P*>(p), static_cast<const G*>(g), r, c, scal, partials,
      stage == kApplyFromSums ? sums : nullptr, eps_div, eps_rms, literal, m,
      n, stage == kApplyFromSums ? n_total : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int launch_update(void* p, const void* g, const float* r, const float* c,
                  const float* scal, float* partials, float* sums,
                  long long n_total, int stage, float eps_div, float eps_rms,
                  int literal, int L, int m, int n, int nblk,
                  cudaStream_t s) {
  const bool vector = n % kVec == 0 &&
                      (((uintptr_t)p | (uintptr_t)g | (uintptr_t)c) & 15) == 0;
  return vector ? launch_pair<P, G, true>(p, g, r, c, scal, partials, sums,
                                          n_total, stage, eps_div, eps_rms,
                                          literal, L, m, n, nblk, s)
                : launch_pair<P, G, false>(p, g, r, c, scal, partials, sums,
                                           n_total, stage, eps_div, eps_rms,
                                           literal, L, m, n, nblk, s);
}

int update_entry(void* p, int p_dtype, const void* g, int g_dtype,
                 const void* r, const void* c, const void* scal,
                 void* partials, void* sums, long long n_total, int stage,
                 float eps_div, float eps_rms, int literal, int L, int m,
                 int n, int n_blocks, void* stream) {
  if (L < 1 || L > 65535 || m < 1 || n < 1 || n_blocks < 1 ||
      (stage != kBoth && sums == nullptr) ||
      (stage == kApplyFromSums && n_total < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const float* cp = static_cast<const float*>(c);
  const float* sp = static_cast<const float*>(scal);
  float* pp = static_cast<float*>(partials);
  float* su = static_cast<float*>(sums);
#define ADALOMO_LAUNCH(P, G)                                               \
  return launch_update<P, G>(p, g, rp, cp, sp, pp, su, n_total, stage,     \
                             eps_div, eps_rms, literal, L, m, n, n_blocks, \
                             s)
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

}  // namespace adalomo

// The tile of K2, rows and columns; the wrapper's tiling must agree.
extern "C" int adalomo_update_tile_rows() { return adalomo::kTileRows; }
extern "C" int adalomo_update_tile_cols() { return adalomo::kTileCols; }

// p, g [L, m, n] (dtype 0 = float32, 1 = bfloat16), p updated in place;
// r [L, m], c [L, n] fp32 from adalomo_stats_launch; scal [L, 4] fp32 =
// (inv_denom_corr, lr, decay, clip); n_blocks blocks a slice walk its tiles;
// partials [L, n_blocks, 2] fp32 scratch.  Returns cudaGetLastError().
extern "C" int adalomo_update_launch(void* p, int p_dtype, const void* g,
                                     int g_dtype, const void* r,
                                     const void* c, const void* scal,
                                     void* partials, float eps_div,
                                     float eps_rms, int literal, int L, int m,
                                     int n, int n_blocks, void* stream) {
  using namespace adalomo;
  return update_entry(p, p_dtype, g, g_dtype, r, c, scal, partials, nullptr,
                      0, kBoth, eps_div, eps_rms, literal, L, m, n, n_blocks,
                      stream);
}

// A shard's first half: the partials launch over p, g [L, m, n] (the shard)
// and the sums of its partials into sums [L, 2] fp32 = (sum u^2,
// sum theta^2); p is not written.  The other arguments as above.
extern "C" int adalomo_update_partials_launch(
    const void* p, int p_dtype, const void* g, int g_dtype, const void* r,
    const void* c, const void* scal, void* partials, void* sums,
    float eps_div, float eps_rms, int literal, int L, int m, int n,
    int n_blocks, void* stream) {
  using namespace adalomo;
  return update_entry(const_cast<void*>(p), p_dtype, g, g_dtype, r, c, scal,
                      partials, sums, 0, kPartials, eps_div, eps_rms, literal,
                      L, m, n, n_blocks, stream);
}

// A shard's second half: the apply launch, p updated in place, from sums
// [L, 2] = the whole tensor's (sum u^2, sum theta^2) and n_total, the whole
// tensor's element count a slice, which the RMS values divide by.
extern "C" int adalomo_update_apply_launch(
    void* p, int p_dtype, const void* g, int g_dtype, const void* r,
    const void* c, const void* scal, const void* sums, long long n_total,
    float eps_div, float eps_rms, int literal, int L, int m, int n,
    int n_blocks, void* stream) {
  using namespace adalomo;
  return update_entry(p, p_dtype, g, g_dtype, r, c, scal, nullptr,
                      const_cast<void*>(sums), n_total, kApplyFromSums,
                      eps_div, eps_rms, literal, L, m, n, n_blocks, stream);
}
