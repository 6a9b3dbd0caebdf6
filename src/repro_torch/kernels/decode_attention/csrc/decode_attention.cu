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
// the shapes only, so that about two blocks sit on each SM: fewer, longer
// runs measured faster than three or one at danube's shapes), one block of
// four warps per (kh, b, run), and everything happens in ONE launch:
// * bf16, the serving path: each warp walks its own steps of 16 slots
//   (warp w takes steps w, w + 4, ...) through a ring of kStages shared-memory
//   stages that it fills itself with 16-byte cp.async copies, kStages - 1
//   steps ahead; a masked or empty slot gets the zero-filling form
//   (src-size 0), so nothing of it is read and its zeros meet a probability
//   of 0.  K/V stay bf16 in shared memory (rows padded by 16 bytes, so
//   ldmatrix is free of bank conflicts).  Scores and the weighted sum are
//   tensor-core products (mma.sync m16n8k16, bf16 in, fp32 sums), the G
//   query heads padded to 16 rows; the scores' accumulator turns into the
//   probabilities' operand in registers, the online softmax runs in fp32 in
//   the four lanes that hold a head's row.  A warp waits once a step
//   (cp.async.wait_group + __syncwarp), the block once at the end.
// * fp32: the SIMT tile loop of decode_tiles.cuh (shared with K3) over the
//   run, in full fp32 arithmetic.
// Each block leaves its run's (m, l, acc) in an fp32 workspace, then draws a
// ticket from an integer counter per (b, kh) (after a __threadfence); the
// block that draws the last one combines the S states in run order (an
// online softmax over the runs: out = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-30), M = max_s m_s, in one pass) and sets
// the counter back to 0 for the next launch.  The atomic decides only
// which block combines, never an order of float sums: a re-run is
// bit-identical.
#include <stdint.h>

#include "decode_tiles.cuh"

namespace rda {

using namespace dtiles;

constexpr int kStep = 16;                    // slots a warp takes per step
constexpr int kBlockStep = kStep * kWarps;   // 64: runs are whole multiples
constexpr int kStages = 3;

struct RingRows {
  const int* kv_pos;
  int q_pos, window;
  size_t base, tok_stride;
  __device__ __forceinline__ bool valid(int t) const {
    const int p = __ldg(kv_pos + t);
    return p >= 0 && p <= q_pos && !(window > 0 && q_pos - p >= window);
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

// After every thread of the block has written its run's state: true in the
// one block of (b, kh) that finishes last, which then owns the combine.  The
// counter goes back to 0 as soon as the last ticket is drawn.
__device__ __forceinline__ bool last_run_done(int* counter, int S) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(counter, 1) == S - 1;
    if (s_last) *counter = 0;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// The S run states of (b, kh) at p0 (stride G * (dh + 2) floats), combined
// in run order into out_bh (the G heads' rows of out): for each output
// element one pass over the runs, the running maximum rescaling the sums as
// the online softmax does, eight runs' loads in flight.
template <typename T>
__device__ __forceinline__ void combine_runs(const float* p0, T* out_bh,
                                             int G, int dh, int S) {
  const size_t stride = (size_t)G * (dh + 2);
  for (int e = threadIdx.x; e < G * dh; e += blockDim.x) {
    const float* pm = p0 + G * dh + e / dh;    // m of run s at pm[s * stride]
    float m = kNegInf, l = 0.f, a = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const float ms = __ldcg(pm + s * stride);
      const float ls = __ldcg(pm + s * stride + G);
      const float as = __ldcg(p0 + s * stride + e);
      const float mn = fmaxf(m, ms);
      const float c_old = expf(m - mn), c_new = expf(ms - mn);
      l = l * c_old + ls * c_new;
      a = a * c_old + as * c_new;
      m = mn;
    }
    out_bh[e] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

// ---- fp32: the SIMT tile loop ----------------------------------------------

// Block (kh, b, run): slots [run * span, min(W, (run + 1) * span)).
template <int DH>
__global__ void __launch_bounds__(kThreads)
ring_decode_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_cache,
                   const float* __restrict__ v_cache,
                   const int* __restrict__ kv_pos,
                   const int* __restrict__ q_pos, float* __restrict__ part,
                   int* __restrict__ counters, float* __restrict__ out, int H,
                   int K, int G, int W, int span, float scale, int window) {
  const int kh = blockIdx.x, b = blockIdx.y, run = blockIdx.z, S = gridDim.z;
  const RingRows rows = ring_rows(kv_pos, q_pos, window, b, kh, W, K, DH);
  const int t_lo = run * span;
  const size_t q_base = ((size_t)b * H + (size_t)kh * G) * DH;
  float* p0 = part + ((size_t)b * K + kh) * S * G * (DH + 2);
  decode_tiles<float, DH, RingRows, true>(
      q, k_cache, v_cache, nullptr, q_base, G, scale, t_lo,
      min(W, t_lo + span), rows, p0 + (size_t)run * G * (DH + 2));
  if (last_run_done(counters + (size_t)b * K + kh, S))
    combine_runs<float>(p0, out + q_base, G, DH, S);
}

// ---- bf16: cp.async stages and tensor-core products ------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst; with live false nothing is read
// and dst is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A * B for one m16n8k16 tile, bf16 in, fp32 sums; A's rows 8..15 are
// the zero padding of the query heads (a1 = a3 = 0).
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int DH>
struct MmaShape {
  static constexpr int kRow = DH + 8;            // padded row, bf16 elements
  static constexpr int kChunks = DH / 8;         // 16-byte pieces a row
  static constexpr int kStageElems = 2 * kStep * kRow;   // K then V
  static constexpr size_t kSmemBytes =
      (size_t)kWarps * kStages * kStageElems * sizeof(__nv_bfloat16);
  static_assert(DH % 16 == 0, "head dim must be whole k-steps of 16");
  static_assert(kSmemBytes >= kWarps * kMaxG * (DH + 2) * sizeof(float),
                "the block's combine reuses the stages");
};

// Block (kh, b, run): slots [run * span, min(W, (run + 1) * span)).
//
// Lane layout of the m16n8k16 fragments (grp = lane / 4, tig = lane % 4):
// query head grp's row of scores for slots 8j + 2 tig + {0, 1} of a step sits
// in sc[j][0..1]; the same lane's output columns 8 nt + 2 tig + {0, 1} of
// head grp sit in acc[nt][0..1].  acc[nt][2..3] belong to the padding rows
// and stay 0.
template <int DH>
__global__ void __launch_bounds__(kThreads)
ring_decode_kernel_mma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_cache,
                       const __nv_bfloat16* __restrict__ v_cache,
                       const int* __restrict__ kv_pos,
                       const int* __restrict__ q_pos,
                       float* __restrict__ part, int* __restrict__ counters,
                       __nv_bfloat16* __restrict__ out, int H, int K, int G,
                       int W, int span, float scale, int window) {
  using Sh = MmaShape<DH>;
  constexpr int kKSteps = DH / 16;
  constexpr int kNTiles = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ unsigned smask[kWarps][kStages];

  const int kh = blockIdx.x, b = blockIdx.y, run = blockIdx.z, S = gridDim.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const RingRows rows = ring_rows(kv_pos, q_pos, window, b, kh, W, K, DH);
  const int t_lo = run * span, t_hi = min(W, t_lo + span);
  const int steps = (t_hi - t_lo + kStep - 1) / kStep;
  const int mine = steps > warp ? (steps - 1 - warp) / kWarps + 1 : 0;
  const size_t q_base = ((size_t)b * H + (size_t)kh * G) * DH;
  __nv_bfloat16* stages = smem + (size_t)warp * kStages * Sh::kStageElems;

  // this lane's A fragments of q: head grp, columns 16 ks + 2 tig (+8)
  uint32_t qa0[kKSteps], qa2[kKSteps];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const __nv_bfloat16* qr = q + q_base + (size_t)grp * DH + 16 * ks +
                              2 * tig;
    qa0[ks] = grp < G ? __ldg(reinterpret_cast<const unsigned*>(qr)) : 0u;
    qa2[ks] = grp < G ? __ldg(reinterpret_cast<const unsigned*>(qr + 8)) : 0u;
  }

  // whether slot lane of the warp's j-th step is attended to (lanes 0..15);
  // read one iteration before the step is fetched, so its latency overlaps
  auto slot_ok = [&](int j) {
    const int t = t_lo + (warp + kWarps * j) * kStep + lane;
    return j < mine && lane < kStep && t < t_hi && rows.valid(t);
  };
  // the warp's j-th step into stage j % kStages; its valid slots as a mask
  auto fetch = [&](int j, bool ok) {
    const int st = j % kStages;
    const int t0 = t_lo + (warp + kWarps * j) * kStep;
    const unsigned vm = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) smask[warp][st] = vm;
    __nv_bfloat16* sk = stages + st * Sh::kStageElems;
    __nv_bfloat16* sv = sk + kStep * Sh::kRow;
    for (int e = lane; e < kStep * Sh::kChunks; e += 32) {
      const int tok = e / Sh::kChunks, ch = e - tok * Sh::kChunks;
      const bool live = (vm >> tok) & 1u;
      const size_t off = live ? rows.off(t0 + tok) + (size_t)ch * 8 : 0;
      const int so = tok * Sh::kRow + ch * 8;
      cp_async16(smem_addr(sk + so), k_cache + off, live);
      cp_async16(smem_addr(sv + so), v_cache + off, live);
    }
  };

  float acc[kNTiles][4];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_run = kNegInf, l_run = 0.f;   // head grp's; l_run this lane's part

  bool ok[kStages];
#pragma unroll
  for (int j = 0; j < kStages; ++j) ok[j] = slot_ok(j);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < mine) fetch(j, ok[j]);
    cp_async_commit();
  }
  bool ok_next = ok[kStages - 1];            // step j + kStages - 1's
  for (int j = 0; j < mine; ++j) {
    if (j + kStages - 1 < mine) fetch(j + kStages - 1, ok_next);
    ok_next = slot_ok(j + kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int st = j % kStages;
    const __nv_bfloat16* sk = stages + st * Sh::kStageElems;
    const __nv_bfloat16* sv = sk + kStep * Sh::kRow;
    const unsigned vm = smask[warp][st];
    const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, its row

    // scores of the step's 16 slots: two n-tiles of 8
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t kb[4];
      ldsm_x4(kb, smem_addr(sk + ((mi >> 1) * 8 + mr) * Sh::kRow + 16 * ks +
                            (mi & 1) * 8));
      mma_16816(sc[0], qa0[ks], qa2[ks], kb[0], kb[1]);
      mma_16816(sc[1], qa0[ks], qa2[ks], kb[2], kb[3]);
    }

    // online softmax of head grp, over the quad's 16 slots
    float x[4];
    bool live[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      live[i] = (vm >> (8 * (i >> 1) + 2 * tig + (i & 1))) & 1u;
      x[i] = live[i] ? sc[i >> 1][i & 1] * scale : kNegInf;
    }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = live[i] ? expf(x[i] - m_new) : 0.f;
    l_run = l_run * corr + ((pr[0] + pr[1]) + (pr[2] + pr[3]));
    m_run = m_new;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      acc[nt][0] *= corr;
      acc[nt][1] *= corr;
    }

    // acc += P V: the probabilities as the A operand, V through ldmatrix.trans
    const uint32_t pa0 = pack_bf16(pr[0], pr[1]);
    const uint32_t pa2 = pack_bf16(pr[2], pr[3]);
#pragma unroll
    for (int jj = 0; jj < kKSteps; ++jj) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, smem_addr(sv + ((mi & 1) * 8 + mr) * Sh::kRow +
                                  16 * jj + (mi >> 1) * 8));
      mma_16816(acc[2 * jj], pa0, pa2, vb[0], vb[1]);
      mma_16816(acc[2 * jj + 1], pa0, pa2, vb[2], vb[3]);
    }
    __syncwarp();   // the stage is consumed before a later fetch refills it
  }
  cp_async_wait<0>();
  float l_row = l_run;
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 1);
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 2);

  // the four warps' states, combined in warp order into the run's state
  __syncthreads();   // every warp is done with its stages
  float* so = reinterpret_cast<float*>(smem_raw);    // [warp][g][DH]
  float* sm = so + kWarps * kMaxG * DH;              // [warp][g]
  float* sl = sm + kWarps * kMaxG;                   // [warp][g]
  if (grp < G) {
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      float* o = so + (warp * kMaxG + grp) * DH + 8 * nt + 2 * tig;
      o[0] = acc[nt][0];
      o[1] = acc[nt][1];
    }
    if (tig == 0) {
      sm[warp * kMaxG + grp] = m_run;
      sl[warp * kMaxG + grp] = l_row;
    }
  }
  __syncthreads();
  float* p0 = part + ((size_t)b * K + kh) * S * G * (DH + 2);
  float* mine_state = p0 + (size_t)run * G * (DH + 2);
  for (int e = threadIdx.x; e < G * DH; e += kThreads) {
    const int g = e / DH, d = e - g * DH;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sm[w * kMaxG + g]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm[w * kMaxG + g] - m);
      a += so[(w * kMaxG + g) * DH + d] * c;
      l += sl[w * kMaxG + g] * c;
    }
    mine_state[e] = a;
    if (d == 0) {
      mine_state[G * DH + g] = m;
      mine_state[G * DH + G + g] = l;
    }
  }
  if (last_run_done(counters + (size_t)b * K + kh, S))
    combine_runs<__nv_bfloat16>(p0, out + q_base, G, DH, S);
}

// static: the flag below must be this library's own (a function-local static
// of an inline template is one symbol for the whole process).
template <int DH>
static cudaError_t launch_bf16(dim3 grid, cudaStream_t s, const void* q,
                        const void* kc, const void* vc, const int* kv_pos,
                        const int* q_pos, float* part, int* counters,
                        void* out, int H, int K, int G, int W, int span,
                        float scale, int window) {
  constexpr size_t smem = MmaShape<DH>::kSmemBytes;
  static bool sized = false;   // the attribute is set once a process
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_decode_kernel_mma<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  ring_decode_kernel_mma<DH><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), kv_pos, q_pos, part, counters,
      static_cast<__nv_bfloat16*>(out), H, K, G, W, span, scale, window);
  return cudaGetLastError();
}

}  // namespace rda

// The slots a block's four warps take in one round; a run is a whole
// multiple of it.
extern "C" int decode_attention_block_step() { return rda::kBlockStep; }

// q [B, H, dh]; k_cache, v_cache [B, W, K, dh]; out [B, H, dh], all of one
// dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte aligned; kv_pos [W]
// int32; q_pos one int32; window <= 0 means none.  The slots are split into
// S runs of span slots (span a multiple of 64, S * span >= W > (S - 1) *
// span); part is an fp32 workspace of B * K * S * (H / K) * (dh + 2) floats;
// counters B * K int32, all 0 before the launch and left at 0 after it (one
// launch at a time may use them).  dh in {32, 64, 80, 128}, H / K <= 8.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* kv_pos, const void* q_pos,
                                       void* part, void* counters, void* out,
                                       int dtype, int B, int H, int K, int dh,
                                       int W, int S, int span, float scale,
                                       int window, void* stream) {
  using namespace rda;
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || H % K != 0 ||
      H / K > kMaxG || W < 1 || S < 1 || S > 65535 || span < 1 ||
      span % kBlockStep != 0 || (long long)S * span < W ||
      (long long)(S - 1) * span >= W)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  const dim3 grid(K, B, S);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* qp = static_cast<const int*>(q_pos);
  float* ws = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    err = with_head_dim(dh, [&](auto d) {
      ring_decode_kernel<decltype(d)::value><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k_cache),
          static_cast<const float*>(v_cache), kp, qp, ws, cnt,
          static_cast<float*>(out), H, K, G, W, span, scale, window);
    });
  } else if (dtype == kBFloat16) {
    cudaError_t launched = cudaSuccess;
    err = with_head_dim(dh, [&](auto d) {
      launched = launch_bf16<decltype(d)::value>(
          grid, s, q, k_cache, v_cache, kp, qp, ws, cnt, out, H, K, G, W,
          span, scale, window);
    });
    if (err == cudaSuccess) err = launched;
  }
  return static_cast<int>(err);
}
