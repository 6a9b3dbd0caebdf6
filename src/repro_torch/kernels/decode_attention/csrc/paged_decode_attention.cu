// K3 paged_decode_attention: one-token GQA flash-decoding over a shared
// KV page pool (Hopper, sm_90a).
//
// Replaces the TPU kernel _paged_decode_kernel / paged_decode_attention_pallas
// of src/repro/kernels/decode_attention/decode_attention.py.  For sequence b
// and KV head kh, with the G = H / K query heads g that share it:
//     n      = seq_lens[b]                  (tokens cached, this one included)
//     s[g,t] = (q[b, kh*G+g] . k[t]) * scale                        (fp32)
//     valid  = t < n  and, when window > 0, (n - 1) - t < window
//     out    = sum_t softmax(s)[g,t] v[t]   (online softmax, fp32)
// where token t lives in page block_tables[b, t / ps], slot t % ps, of
// k_pages / v_pages [N, ps, K, dh]; out is acc / max(l, 1e-30) in q's type,
// so a row with no valid token gives 0.
//
// Bound: bytes.  The function must read the live K/V rows once
// (2 * n * dh * sizeof(T) per (b, kh)) plus q and out; it does 4 * dh
// operations per token and head, far below the card's rate for that
// traffic.  Design: one block per (b, kh) walks that sequence's tokens in
// tiles of 32, from the first token inside the window to n, so pages past
// the sequence end (the scratch page 0 of the block table's tail) are never
// read; the TPU grid walks all P pages and skips.  Each tile's page ids are
// read from global memory by the threads that load the rows (the TPU
// prefetched the table into SMEM), rows arrive as 16-byte loads (dh = 80 in
// bf16 is ten of them) and are widened to fp32 in shared memory.  Scores:
// one thread per (g, token); softmax: one warp per head, shuffles; the
// weighted sum: one thread per (g, d) output element.  Every sum runs in a
// fixed order and there are no atomics, so the same inputs give
// bit-identical outputs.
//
// Not yet done (later work, ROADMAP.md): split-KV across blocks for long
// sequences and small batches (B * K blocks fill only part of the card),
// TMA / cp.async double buffering, tensor-core products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace pda {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // tokens a tile: one per lane in the softmax
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

// dtype codes of the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int H, int K, int G, int N, int ps, int P, float scale,
                    int window) {
  constexpr int kVec = Vec16<T>::kN;      // elements of one 16-byte load
  constexpr int kVpr = DH / kVec;         // 16-byte loads a row
  constexpr int kAcc = (kMaxG * DH + kThreads - 1) / kThreads;
  static_assert(DH % kVec == 0, "a row must be whole 16-byte loads");

  __shared__ float sq[kMaxG][DH];
  __shared__ float sk[kTile][DH + 1];     // padded: conflict-free k[t][d]
  __shared__ float sv[kTile][DH];
  __shared__ float sp[kMaxG][kTile];      // scores, then probabilities
  __shared__ float sm[kMaxG], sl[kMaxG], scorr[kMaxG];
  __shared__ int svalid[kTile];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a length past the table's P * ps slots reads only those, as the plain
  // version's gather does; the window still counts back from the length
  const int n_all = max(seq_lens[b], 0);
  const int n = min(n_all, P * ps);
  const int lo = window > 0 ? max(0, n_all - window) : 0;
  const int* bt = block_tables + (size_t)b * P;
  const size_t tok_stride = (size_t)K * DH;  // between slots of a page
  const size_t q_base = ((size_t)b * H + (size_t)kh * G) * DH;

  for (int e = tid; e < G * DH; e += kThreads)
    sq[e / DH][e % DH] = to_f32(q[q_base + e]);
  if (tid < G) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int t0 = lo; t0 < n; t0 += kTile) {
    __syncthreads();  // the previous tile's shared memory is consumed
    // K and V rows of the tile, widened to fp32; a token past n is stored
    // as zeros and masked.  A page id outside the pool stops the kernel
    // (the launch then reports an error), as the plain version's gather
    // fails on it.
    for (int e = tid; e < kTile * kVpr; e += kThreads) {
      const int t = e / kVpr, c = e - t * kVpr;
      const int pos = t0 + t;
      const bool live = pos < n;
      int page = 0;
      if (live) {
        page = bt[pos / ps];
        if (page < 0 || page >= N) __trap();
      }
      float kf[kVec], vf[kVec];
      if (live) {
        const size_t off = ((size_t)page * ps + pos % ps) * tok_stride +
                           (size_t)kh * DH + (size_t)c * kVec;
        Vec16<T>::load(k_pages + off, kf);
        Vec16<T>::load(v_pages + off, vf);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sk[t][c * kVec + i] = kf[i];
        sv[t][c * kVec + i] = vf[i];
      }
      if (c == 0) svalid[t] = live;
    }
    __syncthreads();
    // scores: one thread per (g, t), t fastest, so a warp shares g
    for (int e = tid; e < G * kTile; e += kThreads) {
      const int g = e / kTile, t = e - g * kTile;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s += sq[g][d] * sk[t][d];
      sp[g][t] = s * scale;
    }
    __syncthreads();
    // online softmax: one warp per head, lane = token
    for (int g = warp; g < G; g += kWarps) {
      const bool valid = svalid[lane] != 0;
      const float s = valid ? sp[g][lane] : kNegInf;
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      sp[g][lane] = p;
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
        for (int t = 0; t < kTile; ++t) a += sp[g][t] * sv[t][d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * DH) {
      const int g = e / DH;
      out[q_base + e] = from_f32<T>(acc[i] / fmaxf(sl[g], 1e-30f));
    }
  }
}

template <typename T>
cudaError_t launch_dh(int dh, dim3 grid, cudaStream_t s, const void* q,
                      const void* kp, const void* vp, const int* bt,
                      const int* sl, void* out, int H, int K, int G, int N,
                      int ps, int P, float scale, int window) {
#define PDA_CASE(D)                                                        \
  case D:                                                                  \
    paged_decode_kernel<T, D><<<grid, kThreads, 0, s>>>(                   \
        static_cast<const T*>(q), static_cast<const T*>(kp),               \
        static_cast<const T*>(vp), bt, sl, static_cast<T*>(out), H, K, G,  \
        N, ps, P, scale, window);                                          \
    break;
  switch (dh) {
    PDA_CASE(32)
    PDA_CASE(64)
    PDA_CASE(80)
    PDA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PDA_CASE
  return cudaGetLastError();
}

}  // namespace pda

extern "C" int paged_decode_max_group() { return pda::kMaxG; }

// q [B, H, dh]; k_pages, v_pages [N, ps, K, dh]; out [B, H, dh], all of one
// dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte aligned;
// block_tables [B, P] int32; seq_lens [B] int32 (this token included);
// window <= 0 means none.  dh in {32, 64, 80, 128}, H / K <= 8.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, void* out, int dtype,
    int B, int H, int K, int dh, int N, int ps, int P, float scale,
    int window, void* stream) {
  using namespace pda;
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || H % K != 0 ||
      H / K > kMaxG || N < 1 || ps < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(K, B);
  const int G = H / K;
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = launch_dh<float>(dh, grid, s, q, k_pages, v_pages, bt, sl, out, H,
                           K, G, N, ps, P, scale, window);
  } else if (dtype == kBFloat16) {
    err = launch_dh<__nv_bfloat16>(dh, grid, s, q, k_pages, v_pages, bt, sl,
                                   out, H, K, G, N, ps, P, scale, window);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
