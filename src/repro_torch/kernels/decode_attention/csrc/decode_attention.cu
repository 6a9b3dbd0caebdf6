// K4 decode_attention: one-token GQA flash-decoding over a contiguous ring
// KV cache (Hopper, sm_90a).
//
// Replaces the TPU kernel _decode_kernel / decode_attention_pallas of
// src/repro/kernels/decode_attention/decode_attention.py.  For sequence b and
// KV head kh, with the G = H / K query heads g that share it, over the W slots
// t of k_cache / v_cache [B, W, K, dh]:
//     p      = kv_pos[t]            (absolute position of slot t, -1 = empty)
//     valid  = 0 <= p <= q_pos  and, when window > 0, q_pos - p < window
//     s[g,t] = (q[b, kh*G+g] . k[b, t, kh]) * scale                 (fp32)
//     out    = sum_t softmax(s)[g,t] v[b, t, kh]   (online softmax, fp32)
// kv_pos is shared by the batch and q_pos is one int32 in device memory (the
// serving engine's layout), compared as integers where the TPU kernel compared
// float32 copies (the same below 2**24).  out is acc / max(l, 1e-30) in q's
// type, so a row with no valid slot gives 0.
//
// Bound: bytes.  The function must read the valid K/V rows once
// (2 * n_valid * dh * sizeof(T) per (b, kh)) plus q, out and kv_pos.  Design:
// the tile loop of decode_tiles.cuh over the [B, W, K, dh] layout in place: a
// row is read at the stride K * dh, the ragged last tile is masked, nothing is
// copied (the TPU version padded W to a block multiple and transposed the
// cache to [B, K, W, dh] first).  An empty or masked slot is never read, so
// its contents do not matter.  One block per (b, kh) would give 32 blocks at
// danube's batch of 4 and 8 KV heads, each walking all 4096 slots in series;
// so the W slots are split into S runs of whole tiles, one block per
// (b, kh, run) (the wrapper picks S to put about eight blocks on each of the
// 132 SMs).  Each block leaves its (m, l, acc) in a workspace, and a second
// small kernel combines a (b, kh)'s S states in run order:
//     M = max_s m_s,  out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)
// Fixed orders everywhere, no atomics: a re-run is bit-identical.
//
// Not yet done (later work, ROADMAP.md): overlapped loads, tensor-core
// products, one launch instead of two.
#include "decode_tiles.cuh"

namespace rda {

using namespace dtiles;

struct RingRows {
  const int* kv_pos;
  int q_pos, window;
  size_t base, tok_stride;
  __device__ __forceinline__ bool row(int t, size_t* off) const {
    const int p = __ldg(kv_pos + t);
    if (p < 0 || p > q_pos || (window > 0 && q_pos - p >= window))
      return false;
    *off = base + (size_t)t * tok_stride;
    return true;
  }
};

// Block (kh, b, run): slots [run * span, min(W, (run + 1) * span)).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
ring_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                   const T* __restrict__ v_cache,
                   const int* __restrict__ kv_pos,
                   const int* __restrict__ q_pos, float* __restrict__ part,
                   int H, int K, int G, int W, int span, float scale,
                   int window) {
  const int kh = blockIdx.x, b = blockIdx.y, run = blockIdx.z;
  const size_t tok_stride = (size_t)K * DH;
  const RingRows rows{kv_pos, __ldg(q_pos), window,
                      (size_t)b * W * tok_stride + (size_t)kh * DH,
                      tok_stride};
  const int t_lo = run * span;
  const size_t slot = ((size_t)b * K + kh) * gridDim.z + run;
  decode_tiles<T, DH, RingRows, true>(
      q, k_cache, v_cache, nullptr, ((size_t)b * H + (size_t)kh * G) * DH, G,
      scale, t_lo, min(W, t_lo + span), rows,
      part + slot * (size_t)G * (DH + 2));
}

// Block (kh, b): the S run states of (b, kh), combined in run order; one
// thread per output element (G * dh <= 1024).  The runs' loads are
// independent, so the loops are unrolled to keep several in flight.
template <typename T>
__global__ void __launch_bounds__(kMaxG * 128)
ring_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                    int H, int K, int G, int dh, int S) {
  const int kh = blockIdx.x, b = blockIdx.y, e = threadIdx.x;
  if (e >= G * dh) return;
  const size_t stride = (size_t)G * (dh + 2);
  const float* p0 = part + ((size_t)b * K + kh) * S * stride;
  const float* pm = p0 + G * dh + e / dh;    // m of run s at pm[s * stride]
  float m = kNegInf;
#pragma unroll 8
  for (int s = 0; s < S; ++s) m = fmaxf(m, pm[s * stride]);
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const float w = expf(pm[s * stride] - m);
    l += pm[s * stride + G] * w;
    a += p0[s * stride + e] * w;
  }
  out[((size_t)b * H + (size_t)kh * G) * dh + e] =
      from_f32<T>(a / fmaxf(l, 1e-30f));
}

template <typename T>
cudaError_t launch(int dh, int B, int S, cudaStream_t s, const void* q,
                   const void* kc, const void* vc, const int* kv_pos,
                   const int* q_pos, float* part, void* out, int H, int K,
                   int G, int W, int span, float scale, int window) {
  const cudaError_t err = with_head_dim(dh, [&](auto d) {
    ring_decode_kernel<T, decltype(d)::value>
        <<<dim3(K, B, S), kThreads, 0, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(kc),
            static_cast<const T*>(vc), kv_pos, q_pos, part, H, K, G, W, span,
            scale, window);
  });
  if (err != cudaSuccess) return err;
  ring_combine_kernel<T><<<dim3(K, B), (G * dh + 31) / 32 * 32, 0, s>>>(
      part, static_cast<T*>(out), H, K, G, dh, S);
  return cudaGetLastError();
}

}  // namespace rda

// q [B, H, dh]; k_cache, v_cache [B, W, K, dh]; out [B, H, dh], all of one
// dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte aligned; kv_pos [W]
// int32; q_pos one int32; window <= 0 means none.  The slots are split into
// S runs of span slots (span a multiple of 32, S * span >= W > (S - 1) *
// span); part is an fp32 workspace of B * K * S * (H / K) * (dh + 2) floats.
// dh in {32, 64, 80, 128}, H / K <= 8.  Returns the launches' cudaError_t
// (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* kv_pos, const void* q_pos,
                                       void* part, void* out, int dtype,
                                       int B, int H, int K, int dh, int W,
                                       int S, int span, float scale,
                                       int window, void* stream) {
  using namespace rda;
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || H % K != 0 ||
      H / K > kMaxG || W < 1 || S < 1 || S > 65535 || span < 1 ||
      span % kTile != 0 || (long long)S * span < W ||
      (long long)(S - 1) * span >= W)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  const int* kp = static_cast<const int*>(kv_pos);
  const int* qp = static_cast<const int*>(q_pos);
  float* ws = static_cast<float*>(part);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = launch<float>(dh, B, S, s, q, k_cache, v_cache, kp, qp, ws, out, H,
                        K, G, W, span, scale, window);
  } else if (dtype == kBFloat16) {
    err = launch<__nv_bfloat16>(dh, B, S, s, q, k_cache, v_cache, kp, qp, ws,
                                out, H, K, G, W, span, scale, window);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
