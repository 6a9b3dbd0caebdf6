// K1 adalomo_stats: factored second-moment statistics of one gradient.
//
// Replaces the TPU kernel _stats_kernel / stats_pallas of
// src/repro/kernels/adalomo_update/adalomo_update.py.  Computes, for every
// slice l of g [L, m, n]:
//     r'[i] = beta * r[i] + (1 - beta) * sum_j (g[i,j]^2 + eps_stat)
//     c'[j] = beta * c[j] + (1 - beta) * sum_i (g[i,j]^2 + eps_stat)
// in fp32 whatever g's type, written in place into r and c.
//
// Bound: bytes.  The function must read g once and O(m + n) of state; about
// 3 operations per element.  The TPU version accumulates into resident
// output tiles over a sequential grid; Hopper's blocks run in no order, so
// each block leaves partial sums and the last block to finish a row band or
// a column strip adds them up, all in one launch.
//
// Design for the H100's memory system:
// * 2-D tiles: block (strip, band, l) owns R rows x kStatsCols = 256
//   columns of slice l (R = 64, 128 or 256, the wrapper's `stats_tiling`,
//   from the shapes only: the shortest that leaves at most 128 row bands,
//   so short matrices get many small blocks and tall ones no long column
//   folds).  A warp reads a tile row as 32 16-byte loads of bf16
//   (common.cuh's Pack8 / load8; two loads a thread in fp32; the ragged
//   path element by element) and walks rows w, w + 8, ... of the band,
//   a batch of rows' loads in flight at once (StatsShape).
// * Column sums stay in registers (8 a thread) over the warp's rows, then
//   are added over the 8 warps in warp order through shared memory; a row's
//   sum is one shuffle tree of the warp.
// * Small partials: the block writes its column sums to
//   col_part [L, bands, strips * 256] and its row sums to
//   row_part [L, strips, bands * R], about 2-6 % of g's bytes, most of
//   them read back from L2.
// * The fold, spread over the card: once its partials are written, the
//   block draws an integer ticket for its (l, band) and one for its
//   (l, strip), both at once, between two fences of one thread.  The block
//   that draws a band's last ticket adds the band's row partials in strip
//   order into r; the one that draws a strip's last adds the strip's
//   column partials in band order into c; each sets its ticket back to 0.
//   A fold reads its partials as 16-byte loads, several groups of threads
//   taking every k-th partial and the groups added in index order.  The
//   tickets decide only which block folds, never an order of float sums,
//   so a re-run is bit-identical; no float atomics.  The grid walks the
//   strips fastest, so row bands fold while the launch is still streaming.
// What holds it back at danube's smaller shapes is a fixed chain a launch
// (launch, loads, fence, tickets, fold), not bandwidth (PERF.md).
// eps_stat is added once per real element; beta is read from device memory
// by the folding blocks only.
//
// Sharded entry (ZeRO-3: g is one rank's row or column shard of the
// tensor).  The statistics of the axis the shard holds whole are folded as
// above; those of the sharded axis are only partial on this rank, so
// `raw_axis` = 1 (a row shard) writes the raw column sums, and 2 (a column
// shard) the raw row sums, to `raw` [L, raw_stride] in place of the fold.
// The caller sums them over the ranks and folds the sum with
// adalomo_stats_fold_launch, the same expression as the fold here.
// `raw_axis` = 3 (a block split by rows and by columns, the model axis'
// 2-D ZeRO-3 shard): neither vector is folded; the raw row sums go to
// raw[l * m + i] (an [L, m] block) and the raw column sums to
// raw[L * m + l * raw_stride + j] (an [L, raw_stride] block after it), so
// that each half is summed over its own group of ranks with no copy.
#include <stdint.h>

#include "common.cuh"

namespace adalomo {

constexpr int kStatsCols = 32 * kVec;    // 256: one warp's 16-byte loads
// Tuned on the H100 over danube's shapes (PERF.md): occupancy wins
// over deeper unrolling, so the main path's kernel (bf16, 16-byte loads, 64
// rows) is held to 64 registers, 4 blocks a SM, with 8 rows' loads in flight
// a thread; the others (taller tiles, fp32, the ragged path) get 2 blocks a
// SM and 4 rows, so that none spills.
constexpr int kFoldUnroll = 4;   // partials a fold thread has in flight
template <typename G, bool kVector, int R>
struct StatsShape {
  static constexpr bool kMain = kVector && sizeof(G) == 2 && R == 64;
  static constexpr int kMinBlocks = kMain ? 4 : 2;
  static constexpr int kRowsPerWarp = R / kWarps;
  static constexpr int kBatch = kVector && sizeof(G) == 2 ? 8 : 4;
  static_assert(kRowsPerWarp % kBatch == 0, "whole batches of rows");
};

// Sums `count` rows of `width` floats (row i at src + i * stride, 16-byte
// aligned; width 64, 128 or 256) in a fixed order and folds the first
// `valid` sums into dst as dst = beta * dst + (1 - beta) * sum.  Called by
// all threads of the block; `red` holds 4 * kThreads floats.
// With `raw` the sums are written to dst as they are, unfolded.
__device__ __forceinline__ void fold_partials(const float* src, size_t stride,
                                              int count, int width,
                                              float* dst, int valid,
                                              float beta, float* red,
                                              bool raw) {
  const int lanes = width / 4;              // threads a partial row
  const int groups = kThreads / lanes;
  const int t = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  const float4* s4 = reinterpret_cast<const float4*>(src) + t;
  const size_t st4 = stride / 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = grp; i < count; i += kFoldUnroll * groups) {
    float4 v[kFoldUnroll];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u)
      if (i + u * groups < count)
        v[u] = __ldcg(s4 + (size_t)(i + u * groups) * st4);
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) {
      if (i + u * groups >= count) break;
      s.x += v[u].x;
      s.y += v[u].y;
      s.z += v[u].z;
      s.w += v[u].w;
    }
  }
  __syncthreads();  // `red` may still be read from an earlier use
  reinterpret_cast<float4*>(red + grp * width)[t] = s;
  __syncthreads();
  for (int e = threadIdx.x; e < valid; e += kThreads) {
    float total = 0.f;
    for (int g = 0; g < groups; ++g) total += red[g * width + e];
    dst[e] = raw ? total : beta * dst[e] + (1.f - beta) * total;
  }
}

// dst[l, e] = beta * dst[l, e] + (1 - beta) * src[l * src_stride + e]: the
// fold of fold_partials, for statistics summed over the ranks.
__global__ void __launch_bounds__(kThreads)
fold_kernel(float* __restrict__ dst, const float* __restrict__ src,
            int src_stride, int count, const float* __restrict__ beta_p) {
  const int e = blockIdx.x * kThreads + threadIdx.x, l = blockIdx.y;
  if (e >= count) return;
  const float beta = __ldg(beta_p);
  const float total = src[(size_t)l * src_stride + e];
  float* d = dst + (size_t)l * count + e;
  *d = beta * *d + (1.f - beta) * total;
}

template <typename G, bool kVector, int R>
__global__ void __launch_bounds__(kThreads,
                                  (StatsShape<G, kVector, R>::kMinBlocks))
stats_kernel(const G* __restrict__ g, float* __restrict__ r,
             float* __restrict__ c, float* __restrict__ row_part,
             float* __restrict__ col_part, int* __restrict__ tickets,
             const float* __restrict__ beta_p, float eps_stat, int m,
             int n, float* __restrict__ raw, int raw_axis, int raw_stride) {
  using Sh = StatsShape<G, kVector, R>;
  constexpr int kRowsPerWarp = Sh::kRowsPerWarp;
  constexpr int kBatch = Sh::kBatch;    // rows whose loads are in flight
  const int strip = blockIdx.x, band = blockIdx.y, l = blockIdx.z;
  const int strips = gridDim.x, bands = gridDim.y, L = gridDim.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = band * R, col0 = strip * kStatsCols;
  const int col = col0 + lane * kVec;
  const int cnt = min(kVec, n - col);       // <= 0: past the last column
  const G* gl = g + (size_t)l * m * n;
  const int m_pad = bands * R;
  const int n_pad = strips * kStatsCols;
  float* rp = row_part + ((size_t)l * strips + strip) * m_pad;

  float csum[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) csum[i] = 0.f;

#pragma unroll 1
  for (int i0 = 0; i0 < kRowsPerWarp; i0 += kBatch) {
    Pack8<G> pk[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int row = row0 + warp + kWarps * (i0 + u);
      if (row < m && cnt > 0)
        load8<kVector, true>(pk[u], gl + (size_t)row * n + col, cnt);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int row = row0 + warp + kWarps * (i0 + u);
      if (row >= m) continue;                 // the same in the whole warp
      float rs = 0.f;
      if (cnt > 0) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          if (!kVector && i >= cnt) continue;
          const float x = elem(pk[u], i);
          const float g2 = x * x + eps_stat;
          csum[i] += g2;
          rs += g2;
        }
      }
      rs = warp_sum(rs);
      if (lane == 0) rp[row] = rs;
    }
  }

  // the tile's column sums, warps added in order
  __shared__ __align__(16) float red[kWarps * kStatsCols];
#pragma unroll
  for (int i = 0; i < kVec; ++i) red[warp * kStatsCols + lane * kVec + i] =
      csum[i];
  __syncthreads();
  {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * kStatsCols + threadIdx.x];
    col_part[((size_t)l * bands + band) * n_pad + col0 + threadIdx.x] = s;
  }

  // tickets: the last block of a band folds r, the last of a strip folds c.
  // Thread 0 publishes the block's partials (the barrier orders the other
  // threads' writes before its fence), draws both tickets at once, and
  // fences again before the block reads what the other blocks wrote.
  __shared__ int s_last_band, s_last_strip;
  __syncthreads();
  if (threadIdx.x == 0) {
    int* band_t = tickets + (size_t)l * bands + band;
    int* strip_t = tickets + (size_t)L * bands + (size_t)l * strips + strip;
    __threadfence();
    const int tb = atomicAdd(band_t, 1), ts = atomicAdd(strip_t, 1);
    s_last_band = tb == strips - 1;
    s_last_strip = ts == bands - 1;
    if (s_last_band) *band_t = 0;
    if (s_last_strip) *strip_t = 0;
    __threadfence();
  }
  __syncthreads();
  if (!s_last_band && !s_last_strip) return;
  const float beta = __ldg(beta_p);
  if (s_last_band) {
    const bool rw = raw_axis == 2 || raw_axis == 3;
    float* dst = raw_axis == 3   ? raw + (size_t)l * m
                 : raw_axis == 2 ? raw + (size_t)l * raw_stride
                                 : r + (size_t)l * m;
    fold_partials(row_part + (size_t)l * strips * m_pad + row0, m_pad, strips,
                  R, dst + row0, min(R, m - row0), beta, red, rw);
  }
  if (s_last_strip) {
    const bool rw = raw_axis == 1 || raw_axis == 3;
    float* dst = raw_axis == 3   ? raw + (size_t)L * m + (size_t)l * raw_stride
                 : raw_axis == 1 ? raw + (size_t)l * raw_stride
                                 : c + (size_t)l * n;
    fold_partials(col_part + (size_t)l * bands * n_pad + col0, n_pad, bands,
                  kStatsCols, dst + col0, min(kStatsCols, n - col0), beta,
                  red, rw);
  }
}

template <typename G, int R>
void launch_rows(dim3 grid, cudaStream_t s, const G* g, bool vector,
                 float* r, float* c, float* row_part, float* col_part,
                 int* tickets, const float* beta, float eps_stat, int m,
                 int n, float* raw, int raw_axis, int raw_stride) {
  if (vector)
    stats_kernel<G, true, R><<<grid, kThreads, 0, s>>>(
        g, r, c, row_part, col_part, tickets, beta, eps_stat, m, n, raw,
        raw_axis, raw_stride);
  else
    stats_kernel<G, false, R><<<grid, kThreads, 0, s>>>(
        g, r, c, row_part, col_part, tickets, beta, eps_stat, m, n, raw,
        raw_axis, raw_stride);
}

template <typename G>
int launch_stats(const void* g, float* r, float* c, float* row_part,
                 float* col_part, int* tickets, const float* beta,
                 float eps_stat, int L, int m, int n, int R, float* raw,
                 int raw_axis, int raw_stride, cudaStream_t s) {
  const dim3 grid((n + kStatsCols - 1) / kStatsCols, (m + R - 1) / R, L);
  const G* gp = static_cast<const G*>(g);
  const bool vector = n % kVec == 0 && ((uintptr_t)g & 15) == 0;
#define ADALOMO_ROWS(RR)                                                    \
  case RR:                                                                  \
    launch_rows<G, RR>(grid, s, gp, vector, r, c, row_part, col_part,       \
                       tickets, beta, eps_stat, m, n, raw, raw_axis,        \
                       raw_stride);                                         \
    break
  switch (R) {
    ADALOMO_ROWS(64);
    ADALOMO_ROWS(128);
    ADALOMO_ROWS(256);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ADALOMO_ROWS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace adalomo

// The columns of K1's tile; the wrapper's tiling must agree.
extern "C" int adalomo_stats_tile_cols() { return adalomo::kStatsCols; }

namespace adalomo {

int stats_entry(const void* g, int g_dtype, void* r, void* c, void* row_part,
                void* col_part, void* tickets, const void* beta,
                float eps_stat, int L, int m, int n, int rows_per_block,
                void* raw, int raw_axis, int raw_stride, void* stream) {
  const int R = rows_per_block;
  if (L < 1 || L > 65535 || m < 1 || n < 1 ||
      (R != 64 && R != 128 && R != 256) || (m + R - 1) / R > 65535 ||
      (((uintptr_t)row_part | (uintptr_t)col_part) & 15) != 0 ||
      raw_axis < 0 || raw_axis > 3 ||
      (raw_axis != 0 &&
       (raw == nullptr || raw_stride < (raw_axis == 2 ? m : n))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rp = static_cast<float*>(r);
  float* cp = static_cast<float*>(c);
  float* rpart = static_cast<float*>(row_part);
  float* cpart = static_cast<float*>(col_part);
  int* tk = static_cast<int*>(tickets);
  const float* bp = static_cast<const float*>(beta);
  float* rw = static_cast<float*>(raw);
  if (g_dtype == kFloat32)
    return launch_stats<float>(g, rp, cp, rpart, cpart, tk, bp, eps_stat, L,
                               m, n, R, rw, raw_axis, raw_stride, s);
  if (g_dtype == kBFloat16)
    return launch_stats<__nv_bfloat16>(g, rp, cp, rpart, cpart, tk, bp,
                                       eps_stat, L, m, n, R, rw, raw_axis,
                                       raw_stride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace adalomo

// g [L, m, n] (g_dtype 0 = float32, 1 = bfloat16); r [L, m], c [L, n] fp32,
// updated in place; tiles of rows_per_block (64, 128 or 256) rows x 256
// columns, strips = ceil(n / 256), bands = ceil(m / rows_per_block);
// row_part [L, strips, bands * rows_per_block] and col_part
// [L, bands, strips * 256] fp32 scratch, 16-byte aligned; tickets
// L * (bands + strips) int32, all 0 before the launch and left at 0 after it
// (one launch at a time may use them); beta one fp32 value in device memory.
// Returns cudaGetLastError().
extern "C" int adalomo_stats_launch(const void* g, int g_dtype, void* r,
                                    void* c, void* row_part, void* col_part,
                                    void* tickets, const void* beta,
                                    float eps_stat, int L, int m, int n,
                                    int rows_per_block, void* stream) {
  return adalomo::stats_entry(g, g_dtype, r, c, row_part, col_part, tickets,
                              beta, eps_stat, L, m, n, rows_per_block,
                              nullptr, 0, 0, stream);
}

// The sharded entry: as adalomo_stats_launch, but with raw_axis 1 (g a row
// shard) c is left as it is and the raw column sums go to raw[l, 0:n], and
// with raw_axis 2 (a column shard) r is left and the raw row sums go to
// raw[l, 0:m]; raw is [L, raw_stride] fp32.  With raw_axis 3 (a block split
// both ways) r and c are both left, the raw row sums go to raw[l * m + i]
// and the raw column sums to raw[L * m + l * raw_stride + j]: raw holds
// L * (m + raw_stride) fp32, raw_stride >= n.
extern "C" int adalomo_stats_partial_launch(
    const void* g, int g_dtype, void* r, void* c, void* row_part,
    void* col_part, void* tickets, const void* beta, float eps_stat, int L,
    int m, int n, int rows_per_block, void* raw, int raw_axis, int raw_stride,
    void* stream) {
  if (raw_axis < 1 || raw_axis > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  return adalomo::stats_entry(g, g_dtype, r, c, row_part, col_part, tickets,
                              beta, eps_stat, L, m, n, rows_per_block, raw,
                              raw_axis, raw_stride, stream);
}

// dst [L, count] = beta * dst + (1 - beta) * src[l * src_stride + e], fp32,
// beta one fp32 value in device memory: the fold of statistics summed over
// the ranks.  Returns cudaGetLastError().
extern "C" int adalomo_stats_fold_launch(void* dst, const void* src,
                                         int src_stride, int count, int L,
                                         const void* beta, void* stream) {
  using namespace adalomo;
  if (L < 1 || L > 65535 || count < 1 || src_stride < count)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((count + kThreads - 1) / kThreads, L);
  fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dst), static_cast<const float*>(src), src_stride,
      count, static_cast<const float*>(beta));
  return static_cast<int>(cudaGetLastError());
}
