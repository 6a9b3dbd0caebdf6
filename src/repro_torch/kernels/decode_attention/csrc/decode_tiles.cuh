// One-token GQA flash-decoding for one (sequence, KV head), fp32: the SIMT
// tile loop shared by the paged kernel K3 (paged_decode_attention.cu) and
// the ring-cache kernel K4 (decode_attention.cu).  Both take it for fp32
// inputs only, over one run of tokens; bf16 goes through the
// tensor-core warp loop of decode_mma.cuh, since mma.sync would round fp32
// to TF32.  The two kernels differ only in where token t's K/V row lies and
// whether t is attended to; a Rows object answers both:
//     bool rows.row(t, &off)   true when token t is valid; off is the offset,
//                              in elements, of its row for this KV head.
// For the G = H / K query heads g of the KV head:
//     s[g,t] = (q[g] . k[t]) * scale                          (fp32)
//     out[g] = sum_t softmax(s)[g,t] v[t]   (online softmax over t, fp32)
// stored as acc / max(l, 1e-30) in the inputs' type, so a head with no valid
// token gets 0 after the combine.
//
// Bound: bytes.  Each valid K/V row must be read once; the work is 4 * dh
// operations per token and head, far below the card's rate for that traffic.
// Design: one block of 128 threads walks the tokens in tiles of 32.  A tile's
// valid rows arrive as 16-byte loads into shared memory; an invalid token is never read and is stored as zeros, so garbage
// in an unused slot cannot reach the sums.  Scores: one thread per (g,
// token); softmax: one warp per head, shuffles; the weighted sum: one thread
// per (g, d) output element.  Every sum runs in a fixed order and there are
// no atomics, so the same inputs give bit-identical outputs.  Load and
// compute run in series (the fp32 path is the checking path, not the
// serving one).  The block leaves its run's state for the in-launch combine
// of decode_mma.cuh.  Its arrays live in dynamic shared memory
// (TilesShape<DH>::kSmemBytes, set once a kernel by size_smem_once): at
// head dim 256 they take 75,104 bytes, past the 48 KB a block may declare
// statically, and a tile of 32 tokens is kept, since the softmax gives each
// lane one token.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace dtiles {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // tokens a tile: one per lane in the softmax
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

// dtype codes of the C interfaces
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Four fp32 values as one 16-byte load.
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The tile loop's shared memory: q [kMaxG][DH], K [kTile][DH + 1] (padded:
// conflict-free k[t][d]), V [kTile][DH], scores [kMaxG][kTile], m, l and
// the correction [kMaxG] each (fp32), then the tile's valid flags [kTile].
template <int DH>
struct TilesShape {
  static constexpr size_t kFloats = (size_t)kMaxG * DH + kTile * (DH + 1) +
                                    kTile * DH + kMaxG * kTile + 3 * kMaxG;
  static constexpr size_t kSmemBytes =
      kFloats * sizeof(float) + kTile * sizeof(int);
  static_assert(kSmemBytes <= 227 * 1024,
                "the tiles exceed a block's shared memory");
};

// Tokens [t_lo, t_hi) of one (sequence, KV head); q_base is the offset of its
// first query head in q ([B, H, DH]).  Called by all kThreads threads of the
// block, with TilesShape<DH>::kSmemBytes of dynamic shared memory; the block
// writes its unnormalised softmax state for the combine: at part (its own
// slot of a workspace), acc[g][d] (G * DH floats), then m[g], then l[g].
template <int DH, class Rows>
__device__ __forceinline__ void decode_tiles(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, size_t q_base, int G, float scale, int t_lo,
    int t_hi, const Rows& rows, float* __restrict__ part) {
  constexpr int kVec = 4;                 // elements of one 16-byte load
  constexpr int kVpr = DH / kVec;         // 16-byte loads a row
  constexpr int kAcc = (kMaxG * DH + kThreads - 1) / kThreads;
  static_assert(DH % kVec == 0, "a row must be whole 16-byte loads");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);   // [kMaxG][DH]
  float* sk = sq + kMaxG * DH;                      // [kTile][DH + 1]
  float* sv = sk + kTile * (DH + 1);                // [kTile][DH]
  float* sp = sv + kTile * DH;      // [kMaxG][kTile]: scores, probabilities
  float* sm = sp + kMaxG * kTile;
  float* sl = sm + kMaxG;
  float* scorr = sl + kMaxG;
  int* svalid = reinterpret_cast<int*>(scorr + kMaxG);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < G * DH; e += kThreads)
    sq[e] = q[q_base + e];
  if (tid < G) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int t0 = t_lo; t0 < t_hi; t0 += kTile) {
    __syncthreads();  // the previous tile's shared memory is consumed
    // K and V rows of the tile; an invalid token, or one
    // past t_hi, is stored as zeros and masked.
    for (int e = tid; e < kTile * kVpr; e += kThreads) {
      const int t = e / kVpr, c = e - t * kVpr;
      const int pos = t0 + t;
      size_t off = 0;
      const bool live = pos < t_hi && rows.row(pos, &off);
      float kf[kVec], vf[kVec];
      if (live) {
        load4(k + off + (size_t)c * kVec, kf);
        load4(v + off + (size_t)c * kVec, vf);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sk[t * (DH + 1) + c * kVec + i] = kf[i];
        sv[t * DH + c * kVec + i] = vf[i];
      }
      if (c == 0) svalid[t] = live;
    }
    __syncthreads();
    // scores: one thread per (g, t), t fastest, so a warp shares g
    for (int e = tid; e < G * kTile; e += kThreads) {
      const int g = e / kTile, t = e - g * kTile;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s += sq[g * DH + d] * sk[t * (DH + 1) + d];
      sp[g * kTile + t] = s * scale;
    }
    __syncthreads();
    // online softmax: one warp per head, lane = token
    for (int g = warp; g < G; g += kWarps) {
      const bool valid = svalid[lane] != 0;
      const float s = valid ? sp[g * kTile + lane] : kNegInf;
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      sp[g * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        scorr[g] = corr;
        sl[g] = sl[g] * corr + psum;
        sm[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g, d] = acc * corr[g] + sum_t p[g, t] v[t, d]
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * DH) {
        const int g = e / DH, d = e - g * DH;
        float a = acc[i] * scorr[g];
#pragma unroll 8
        for (int t = 0; t < kTile; ++t)
          a += sp[g * kTile + t] * sv[t * DH + d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * DH) part[e] = acc[i];
  }
  if (tid < G) {
    part[G * DH + tid] = sm[tid];
    part[G * DH + G + tid] = sl[tid];
  }
}

// launch(std::integral_constant<int, DH>()) for a supported head dim; the
// launch's cudaError_t (cudaErrorInvalidValue for any other dim).
template <typename Launch>
inline cudaError_t with_head_dim(int dh, Launch launch) {
  switch (dh) {
    case 16:
      launch(std::integral_constant<int, 16>());
      break;
    case 24:
      launch(std::integral_constant<int, 24>());
      break;
    case 32:
      launch(std::integral_constant<int, 32>());
      break;
    case 64:
      launch(std::integral_constant<int, 64>());
      break;
    case 80:
      launch(std::integral_constant<int, 80>());
      break;
    case 120:
      launch(std::integral_constant<int, 120>());
      break;
    case 128:
      launch(std::integral_constant<int, 128>());
      break;
    case 160:
      launch(std::integral_constant<int, 160>());
      break;
    case 256:
      launch(std::integral_constant<int, 256>());
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace dtiles
