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
// (2 * n_valid * dh * sizeof(T) per (b, kh)) plus q, out and kv_pos; its
// 4 * dh operations per slot and query head are far below the card's rate.
// Rows are read in place at the stride K * dh (the TPU version padded W to a
// block multiple and transposed the cache to [B, K, W, dh] first), and an
// empty or masked slot is never read, so its contents do not matter.
//
// Design: the W slots are split into S runs (the wrapper's `ring_split`, from
// the shapes and the blocks an SM the head dim's loop fits, so that about
// two blocks sit on each SM in one wave: fewer, longer runs measured faster
// than three or one at danube's shapes), one block of four warps per (kh, b,
// run), and everything happens in ONE launch:
// * bf16, the serving path: the warp loops of decode_mma.cuh (shared with
//   K3): cp.async stages, the slot mask from one __ballot_sync read a step
//   ahead, zero-filling copies for masked slots, scores and the weighted
//   sum on the tensor cores (mma.sync m16n8k16), the online softmax in the
//   quad's lanes; head dim 256 (paligemma-3b) takes the wide loop, all four
//   warps on each step, two blocks an SM.
// * fp32: the SIMT tile loop of decode_tiles.cuh (shared with K3) over the
//   run, in full fp32 arithmetic.
// Each block leaves its run's (m, l, acc) in an fp32 workspace, then draws a
// ticket from an integer counter per (b, kh) (after a __threadfence); the
// block that draws the last one combines the S states in run order (out =
// sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30), M = max_s
// m_s; at dh 256 the states and the weights taken once into shared memory)
// and sets the counter back to 0 for the next launch; at dh 256 past 8 runs
// the runs are combined in groups of 8 first, each group's last run
// combining it, on tickets of their own (decode_mma.cuh's finish_wide_run).
// The atomic decides only which block combines, never an order of float
// sums: a re-run is bit-identical.
//
// The partial entry (decode_attention_partial_launch) runs the same blocks
// over one rank's block of a ring split over ranks, and returns o in fp32
// and each head's log-sum-exp, for a merge over the ranks.
#include "decode_mma.cuh"

namespace rda {

using namespace dtiles;

struct RingRows {
  static constexpr bool kRowAhead = false;   // a slot's row is arithmetic
  const int* kv_pos;
  int q_pos, window;
  size_t base, tok_stride;
  // the wide loop reads a slot's word (its position) steps before it
  // decides on it
  __device__ __forceinline__ int word(int t) const {
    return __ldg(kv_pos + t);
  }
  __device__ __forceinline__ bool valid_word(int, int p) const {
    return p >= 0 && p <= q_pos && !(window > 0 && q_pos - p >= window);
  }
  __device__ __forceinline__ bool valid(int t) const {
    return valid_word(t, word(t));
  }
  __device__ __forceinline__ size_t off(int t) const {
    return base + (size_t)t * tok_stride;
  }
  __device__ __forceinline__ bool row(int t, size_t* o) const {
    if (!valid(t)) return false;
    *o = off(t);
    return true;
  }
};

__device__ __forceinline__ RingRows ring_rows(const int* kv_pos,
                                              const int* q_pos, int window,
                                              int b, int kh, int W, int K,
                                              int dh) {
  const size_t tok_stride = (size_t)K * dh;
  return RingRows{kv_pos, __ldg(q_pos), window,
                  (size_t)b * W * tok_stride + (size_t)kh * dh, tok_stride};
}

// Both entries launch the kernels below: K4's with lse null and out of q's
// type; the partial entry (decode_attention_partial_launch), over one rank's
// block of a ring split over ranks, with out o in fp32 and lse set, where the
// combining block writes each query head's log-sum-exp of its scores over
// the block's valid slots, lse = m + log l (-inf and o = 0 for a head with no
// valid slot).  The ranks holding the other blocks of the ring merge their
// (o, lse) in rank order outside the kernel.

// ---- fp32: the SIMT tile loop ----------------------------------------------

// Block (kh, b, run): slots [run * span, min(W, (run + 1) * span)).
template <int DH>
__global__ void __launch_bounds__(kThreads)
ring_decode_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_cache,
                   const float* __restrict__ v_cache,
                   const int* __restrict__ kv_pos,
                   const int* __restrict__ q_pos, float* __restrict__ part,
                   int* __restrict__ counters, float* __restrict__ out,
                   float* __restrict__ lse, int H, int K, int G, int W,
                   int span, float scale, int window) {
  const int kh = blockIdx.x, b = blockIdx.y, run = blockIdx.z, S = gridDim.z;
  const RingRows rows = ring_rows(kv_pos, q_pos, window, b, kh, W, K, DH);
  const int t_lo = run * span;
  const size_t h_base = (size_t)b * H + (size_t)kh * G;
  if constexpr (kWide<DH>) {
    decode_tiles<DH>(q, k_cache, v_cache, h_base * DH, G, scale, t_lo,
                     min(W, t_lo + span), rows,
                     run_state<DH>(part, K, S, b, kh, G, run));
    finish_wide_run<DH, TilesShape<DH>::kSmemBytes>(
        part, counters, gridDim.y, K, S, b, kh, G, run, out + h_base * DH,
        lse == nullptr ? nullptr : lse + h_base);
  } else {
    float* p0 = part + ((size_t)b * K + kh) * S * G * (DH + 2);
    decode_tiles<DH>(q, k_cache, v_cache, h_base * DH, G, scale, t_lo,
                     min(W, t_lo + span), rows,
                     p0 + (size_t)run * G * (DH + 2));
    if (last_run_done(counters + (size_t)b * K + kh, S))
      combine_runs<float>(p0, out + h_base * DH, G, DH, S,
                          lse == nullptr ? nullptr : lse + h_base);
  }
}

// ---- bf16: cp.async stages and tensor-core products ------------------------

// Block (kh, b, run): slots [run * span, min(W, (run + 1) * span)); out is
// bf16 (K4) or fp32 (the partial entry).
template <int DH, typename TOut>
__global__ void __launch_bounds__(kThreads)
ring_decode_kernel_mma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_cache,
                       const __nv_bfloat16* __restrict__ v_cache,
                       const int* __restrict__ kv_pos,
                       const int* __restrict__ q_pos,
                       float* __restrict__ part, int* __restrict__ counters,
                       TOut* __restrict__ out, float* __restrict__ lse, int H,
                       int K, int G, int W, int span, float scale,
                       int window) {
  const int kh = blockIdx.x, b = blockIdx.y, run = blockIdx.z, S = gridDim.z;
  const RingRows rows = ring_rows(kv_pos, q_pos, window, b, kh, W, K, DH);
  const int t_lo = run * span;
  const size_t h_base = (size_t)b * H + (size_t)kh * G;
  if constexpr (kWide<DH>) {
    decode_run_wide<DH>(q, k_cache, v_cache, rows, h_base * DH, G, scale,
                        t_lo, min(W, t_lo + span),
                        run_state<DH>(part, K, S, b, kh, G, run));
    finish_wide_run<DH, bf16_smem_bytes<DH>()>(
        part, counters, gridDim.y, K, S, b, kh, G, run, out + h_base * DH,
        lse == nullptr ? nullptr : lse + h_base);
  } else {
    float* p0 = part + ((size_t)b * K + kh) * S * G * (DH + 2);
    decode_run_mma<DH>(q, k_cache, v_cache, rows, h_base * DH, G, scale,
                       t_lo, min(W, t_lo + span),
                       p0 + (size_t)run * G * (DH + 2));
    if (last_run_done(counters + (size_t)b * K + kh, S))
      combine_runs<TOut>(p0, out + h_base * DH, G, DH, S,
                         lse == nullptr ? nullptr : lse + h_base);
  }
}

// static: the flags below must be this library's own (a function-local
// static of an inline template is one symbol for the whole process).
template <int DH>
static cudaError_t launch_f32(dim3 grid, cudaStream_t s, const void* q,
                              const void* kc, const void* vc,
                              const int* kv_pos, const int* q_pos,
                              float* part, int* counters, void* out,
                              float* lse, int H, int K, int G, int W,
                              int span, float scale, int window) {
  constexpr size_t smem = TilesShape<DH>::kSmemBytes;
  static bool sized = false;   // the attribute is set once a process
  const cudaError_t err = size_smem_once(sized, ring_decode_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  ring_decode_kernel<DH><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), kv_pos, q_pos, part, counters,
      static_cast<float*>(out), lse, H, K, G, W, span, scale, window);
  return cudaGetLastError();
}

template <int DH, typename TOut>
static cudaError_t launch_bf16(dim3 grid, cudaStream_t s, const void* q,
                               const void* kc, const void* vc,
                               const int* kv_pos, const int* q_pos,
                               float* part, int* counters, void* out,
                               float* lse, int H, int K, int G, int W,
                               int span, float scale, int window) {
  constexpr size_t smem = bf16_smem_bytes<DH>();
  static bool sized = false;   // the attribute is set once a process
  const cudaError_t err =
      size_smem_once(sized, ring_decode_kernel_mma<DH, TOut>, smem);
  if (err != cudaSuccess) return err;
  ring_decode_kernel_mma<DH, TOut><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), kv_pos, q_pos, part, counters,
      static_cast<TOut*>(out), lse, H, K, G, W, span, scale, window);
  return cudaGetLastError();
}

// Either entry (module comment): the arguments checked, the dtype and head
// dim dispatched; BOut is out's type for bf16 inputs.
template <typename BOut>
static int ring_launch(const void* q, const void* k_cache,
                       const void* v_cache, const void* kv_pos,
                       const void* q_pos, void* part, void* counters,
                       void* out, float* lse, int dtype, int B, int H, int K,
                       int dh, int W, int S, int span, float scale,
                       int window, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || H % K != 0 ||
      H / K > kMaxG || W < 1 || S < 1 || S > 65535 || span < 1 ||
      span % kBlockStep != 0 || (long long)S * span < W ||
      (long long)(S - 1) * span >= W ||
      (wide_head_dim(dh) && S > kMaxWideRuns))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  const dim3 grid(K, B, S);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* qp = static_cast<const int*>(q_pos);
  float* ws = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  cudaError_t launched = cudaSuccess;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    err = with_head_dim(dh, [&](auto d) {
      launched = launch_f32<decltype(d)::value>(
          grid, s, q, k_cache, v_cache, kp, qp, ws, cnt, out, lse, H, K, G,
          W, span, scale, window);
    });
  } else if (dtype == kBFloat16) {
    err = with_head_dim(dh, [&](auto d) {
      launched = launch_bf16<decltype(d)::value, BOut>(
          grid, s, q, k_cache, v_cache, kp, qp, ws, cnt, out, lse, H, K, G,
          W, span, scale, window);
    });
  }
  if (err == cudaSuccess) err = launched;
  return static_cast<int>(err);
}

}  // namespace rda

// The slots a block's four warps take in one round; a run is a whole
// multiple of it.
extern "C" int decode_attention_block_step() { return rda::kBlockStep; }

// The runs a first-level combine takes (decode_mma.cuh's kGroupRuns): the
// workspace and the counters grow with run_groups(S) at dh 256.
extern "C" int decode_attention_group_runs() { return rda::kGroupRuns; }

// The dynamic shared memory a block of the bf16 loop takes at head dim dh
// (decode_mma.cuh's bf16_smem_bytes: the wrapper sizes its split by its own
// copy, checked against this one), or -1 for a head dim the kernels do not
// take.
extern "C" int decode_attention_bf16_smem(int dh) {
  int bytes = -1;
  rda::with_head_dim(dh, [&](auto d) {
    bytes = static_cast<int>(rda::bf16_smem_bytes<decltype(d)::value>());
  });
  return bytes;
}

// What the kernel of one entry (0: K4, 1: its partial entry; for float32
// both launch the same kernel), dtype (0 = float32, 1 = bfloat16) and head
// dim takes on this card: out[0] its blocks an SM, out[1] its dynamic shared
// memory a block in bytes, out[2] its registers a thread, out[3] its local
// memory a thread in bytes (decode_mma.cuh's kernel_usage).  Returns a
// cudaError_t (0 = read).
extern "C" int decode_attention_usage(int entry, int dtype, int dh,
                                      int* out) {
  using namespace rda;
  if (entry < 0 || entry > 1 || (dtype != kFloat32 && dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t got = cudaSuccess;
  const cudaError_t err = with_head_dim(dh, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == kFloat32)
      got = kernel_usage(ring_decode_kernel<D>, TilesShape<D>::kSmemBytes,
                         out);
    else if (entry == 0)
      got = kernel_usage(ring_decode_kernel_mma<D, __nv_bfloat16>,
                         bf16_smem_bytes<D>(), out);
    else
      got = kernel_usage(ring_decode_kernel_mma<D, float>,
                         bf16_smem_bytes<D>(), out);
  });
  return static_cast<int>(err == cudaSuccess ? got : err);
}

// q [B, H, dh]; k_cache, v_cache [B, W, K, dh]; out [B, H, dh], all of one
// dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte aligned; kv_pos [W]
// int32; q_pos one int32; window <= 0 means none.  The slots are split into
// S runs of span slots (span a multiple of 64, S * span >= W > (S - 1) *
// span); part is an fp32 workspace of B * K * (S + NG) states of
// state_floats(H / K) = (H / K) * (dh + 2) floats (at dh 256 rounded up to
// a multiple of 4), NG = run_groups (ceil(S / 8) at dh 256 where S > 8,
// else 0; S <= 64 at dh 256);
// counters B * K * (1 + NG) int32, all 0 before the launch and left at 0
// after it (one launch at a time may use them).  dh in {16, 24, 32, 64, 80,
// 120, 128, 160, 256}, H / K <= 8.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* kv_pos, const void* q_pos,
                                       void* part, void* counters, void* out,
                                       int dtype, int B, int H, int K, int dh,
                                       int W, int S, int span, float scale,
                                       int window, void* stream) {
  return rda::ring_launch<__nv_bfloat16>(
      q, k_cache, v_cache, kv_pos, q_pos, part, counters, out, nullptr,
      dtype, B, H, K, dh, W, S, span, scale, window, stream);
}

// K4's partial entry, over one rank's block of W slots of a ring whose other
// blocks other ranks hold: as decode_attention_launch (the same arguments,
// checks, runs, workspace and tickets), but out is replaced by o [B, H, dh]
// float32 (the attention over the block's valid slots, 0 where there is
// none) and lse [B, H] float32 (the log-sum-exp of each head's scaled scores
// over them, -inf where there is none).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int decode_attention_partial_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* kv_pos, const void* q_pos, void* part, void* counters,
    void* o, void* lse, int dtype, int B, int H, int K, int dh, int W, int S,
    int span, float scale, int window, void* stream) {
  return rda::ring_launch<float>(
      q, k_cache, v_cache, kv_pos, q_pos, part, counters, o,
      static_cast<float*>(lse), dtype, B, H, K, dh, W, S, span, scale,
      window, stream);
}
