// bf16 one-token GQA flash-decoding of one run of cache slots on the tensor
// cores, and the in-launch combine of the runs: shared by the ring-cache
// kernel K4 (decode_attention.cu) and the paged kernel K3
// (paged_decode_attention.cu), which replace the TPU kernels
// decode_attention_pallas / _decode_kernel and paged_decode_attention_pallas
// / _paged_decode_kernel of src/repro/kernels/decode_attention/
// decode_attention.py.  The two differ only in where slot t's K/V row lies
// and whether t is attended to; a Rows object answers both:
//     bool rows.valid(t)        slot t is attended to
//   with Rows::kRowAhead false (K4, ring slots: the row is arithmetic)
//     size_t rows.off(t)        offset, in elements, of slot t's row for
//                               this KV head
//   with Rows::kRowAhead true (K3, pages: the row needs a table load)
//     int rows.row_of(t)        slot t's row in the pool (loads its page id)
//     size_t rows.off_of(row)   offset of that row for this KV head
// and, for the wide loop, the same split into a load and a decision:
//     int rows.word(t)                 the word slot t's answers come from
//                                      (K4 its position, K3 its page id)
//     bool rows.valid_word(t, word)    slot t is attended to
//     int rows.row_word(t, word)       (K3) its row in the pool
// The lane that owns slot t of a step loads its word ahead (the narrow
// loop one step ahead, the wide loop WideShape::kAhead steps), so the
// load's latency overlaps the steps before; the slot mask is one
// __ballot_sync a step, and the lanes that copy a row get it by
// __shfl_sync.
//
// Bound: bytes.  Each valid K/V row is read once, 4 * dh bytes a slot in
// bf16; the 4 * dh operations a slot and query head are far below the
// tensor cores' rate.  At paligemma-3b's head dim 256 (8 query heads on 1
// KV head) the least time is 0.0016 ms for a ring of 4 x 1280 slots,
// 0.0050 for 4 x 4096 and 0.0107 for 8 x 4352.
//
// Two warp loops, chosen at compile time by the head dim (kWide):
// * The narrow loop (decode_run_mma; head dims up to 160, redesigned for
//   danube's dh 80 and G 4): each of the block's four warps walks its own
//   steps of 16 slots through its own kStages shared-memory stages, the G
//   query heads padded to m16's 16 rows; the four warps' states combined in
//   warp order at the end of the run.
// * The wide loop (decode_run_wide; head dim 256, paligemma-3b's 8 heads on
//   one KV head).  The narrow loop's private stages take 202,752 bytes a
//   block there (one block an SM), its accumulator 128 fp32 a lane, half of
//   it padding (239 registers), and each warp waits alone on its copies.
//   The wide loop puts all four warps on every step: one ring of
//   WideShape::kStages stages a block, filled by 16-byte cp.async copies
//   from all 128 threads kStages - 1 steps ahead (a masked slot gets the
//   zero-filling form, src-size 0: nothing of it is read and its zeros meet
//   a probability of 0), one __syncthreads a step.  The operands are
//   swapped so that no row is padding: the scores are S^T = K q^T (the 16
//   slots fill m16, the heads n8) and the weighted sum O^T = V^T P^T (16
//   head-dim columns fill m16, the heads n8).  Warp w owns head-dim columns
//   [64 w, 64 w + 64) of both products: its quarter of each slot's score
//   goes to shared memory, every warp sums the four quarters in warp order
//   and runs the same online softmax (so the four warps hold equal m and l
//   and need no combine at the end), and its accumulator is 4 m-tiles, 16
//   fp32 a lane.  72,720 bytes of shared memory a block: three blocks fit an
//   SM.
// K/V stay bf16 in shared memory, rows padded by 16 bytes (an odd number of
// 16-byte pieces: ldmatrix is free of bank conflicts); both products are
// mma.sync m16n8k16, bf16 in, fp32 sums; the online softmax runs in fp32.
// A run with no slot writes the neutral state (m = -1e30, l = 0, acc = 0).
//
// The combine (shared with the fp32 tile loop): after its state is written
// each block draws an integer ticket per (sequence, KV head) (after a
// __threadfence); the block that draws the last one combines the S states and
// sets the counter back to 0 for the next launch. At the narrow loop's head
// dims that is combine_runs, an online softmax over the runs for each output
// (cheap where the states are small). At dh 256 (combine_states,
// finish_wide_run) one block once took a chain of two dependent exponentials a
// run for each of 2,048 outputs: now the states go to shared memory in one
// round of cp.async copies, each head's maximum M and each run's weight
// e^(m_s - M) are taken once, and every output is a fixed-order sum of FMAs;
// past 8
// runs the runs are combined in groups of 8 first, each group's last run
// combining it on tickets of its own, so that no combine reads more than 8
// states of 8 KB, all in one round of copies (at most 8 groups: 64 runs). One
// combine of all the runs, chunk by chunk, took 1-5 us more at paligemma-3b's
// rings of 20-32 runs on an H100. The atomics decide only which block
// combines, never an order of float sums: a re-run is bit-identical.
#pragma once

#include <stdint.h>

#include "decode_tiles.cuh"

namespace dtiles {

constexpr int kStep = 16;                    // slots of one step
constexpr int kBlockStep = kStep * kWarps;   // 64: runs are whole multiples
constexpr int kStages = 3;                   // the narrow loop's, a warp

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

// The narrow loop's combine: the S run states of (b, kh) at p0 (stride
// G * (dh + 2) floats), combined in run order into out_bh (the G heads' rows
// of out): for each output element one pass over the runs, the running
// maximum rescaling the sums as the online softmax does, eight runs' loads
// in flight.  With lse_bh (K4's partial entry) each head's log-sum-exp of
// its scores over the runs' slots, m + log l, goes there too; a head with no
// valid slot gets 0 in out_bh and -inf in lse_bh.  Cheapest where the runs
// are few and small (a G * dh of 64 to 1,280 floats); the wide loop's
// states take combine_states.
template <typename T>
__device__ __forceinline__ void combine_runs(const float* p0, T* out_bh,
                                             int G, int dh, int S,
                                             float* lse_bh = nullptr) {
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
    if (lse_bh != nullptr && e % dh == 0)
      lse_bh[e / dh] = l > 0.f ? m + logf(l) : -__int_as_float(0x7f800000);
  }
}

// The head dims of the wide loop and its combine (see the head of this
// file); every other head dim keeps the narrow loop and combine_runs.
__host__ __device__ constexpr bool wide_head_dim(int dh) { return dh == 256; }
template <int DH>
constexpr bool kWide = wide_head_dim(DH);

// A state's floats: acc[g][d], then m[g], then l[g]; at the wide loop's head
// dim padded to whole 16-byte pieces, so that every state starts 16-byte
// aligned for combine_states' copies.
template <int DH>
__host__ __device__ constexpr int state_floats(int G) {
  return kWide<DH> ? (G * (DH + 2) + 3) / 4 * 4 : G * (DH + 2);
}

// The wide loop's runs of one (sequence, KV head) go to the combine in
// groups of kGroupRuns where there are more (paligemma-3b's 8 heads at dh
// 256 leave 8 KB a run): the last run of a group to finish combines the
// group's states into a group state, and the last group to finish combines
// the group states into out.  So no combine reads more than kGroupRuns
// states, and the groups' combines run side by side.  At most kGroupRuns
// groups: a (sequence, KV head) takes at most kMaxWideRuns runs.
constexpr int kGroupRuns = 8;
constexpr int kMaxWideRuns = kGroupRuns * kGroupRuns;

template <int DH>
__host__ __device__ constexpr int run_groups(int S) {
  return kWide<DH> && S > kGroupRuns ? (S + kGroupRuns - 1) / kGroupRuns
                                     : 0;
}

// The n <= kGroupRuns states at p0 (state s's at p0 + s *
// state_floats<DH>(G)) combined in order, by all kThreads threads of a
// block, in the kSmem bytes of dynamic shared memory its loop had.  The
// states go to shared memory first, every 16-byte copy of them in flight at
// once (cp.async, one round trip); then each head's maximum M (one warp a
// head; fmaxf does not depend on the order) and each state's weight w_s =
// e^(m_s - M); then A = sum_s acc_s w_s and L = sum_s l_s w_s: FMAs in state
// order, each thread owning pairs of neighbouring columns.  Writes either
// the combined state (A, M, L) to `state`, or out_bh = A / max(L, 1e-30)
// (the G heads' rows of out) and, with lse_bh (K4's partial entry), each
// head's log-sum-exp M + log L; a head with no valid slot gets 0 in out_bh
// and -inf in lse_bh.
template <int DH, size_t kSmem, typename T>
__device__ __forceinline__ void combine_states(const float* p0, int G, int n,
                                               T* out_bh, float* lse_bh,
                                               float* state) {
  constexpr int kPairs = (kMaxG * DH / 2 + kThreads - 1) / kThreads;
  constexpr int kHead = 2 * kMaxG + kMaxG * kGroupRuns;   // M, L, weights
  static_assert(kHead % 4 == 0, "the states start 16-byte aligned");
  static_assert(kSmem >= sizeof(float) *
                             (kHead + kGroupRuns * state_floats<DH>(kMaxG)),
                "kGroupRuns states fit the loop's shared memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sM = reinterpret_cast<float*>(smem_raw);   // [kMaxG]: M
  float* sL = sM + kMaxG;                           // [kMaxG]: L
  float* sW = sL + kMaxG;           // [kMaxG][kGroupRuns]: the weights
  float* sS = sM + kHead;           // [n][sf]: the states
  const int sf = state_floats<DH>(G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n * sf / 4; i += kThreads)
    cp_async16(smem_addr(sS + 4 * i), p0 + 4 * i, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    float m = kNegInf;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, sS[s * sf + G * DH + g]);
    m = warp_max(m);
    if (lane == 0) sM[g] = m;
  }
  __syncthreads();
  for (int i = tid; i < G * n; i += kThreads) {
    const int g = i / n, s = i - g * n;
    sW[g * kGroupRuns + s] = expf(sS[s * sf + G * DH + g] - sM[g]);
  }
  __syncthreads();
  if (tid < G) {
    float L = 0.f;
    for (int s = 0; s < n; ++s)
      L = fmaf(sS[s * sf + G * DH + G + tid], sW[tid * kGroupRuns + s], L);
    sL[tid] = L;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int e = 2 * (tid + i * kThreads);
    if (e < G * DH) {
      const int g = e / DH;
      float2 a = make_float2(0.f, 0.f);
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const float2 v = *reinterpret_cast<const float2*>(sS + s * sf + e);
        const float w = sW[g * kGroupRuns + s];
        a.x = fmaf(v.x, w, a.x);
        a.y = fmaf(v.y, w, a.y);
      }
      const float l = sL[g];
      if (state != nullptr) {
        state[e] = a.x;
        state[e + 1] = a.y;
        if (e % DH == 0) {
          state[G * DH + g] = sM[g];
          state[G * DH + G + g] = l;
        }
      } else {
        const float inv = fmaxf(l, 1e-30f);
        out_bh[e] = from_f32<T>(a.x / inv);
        out_bh[e + 1] = from_f32<T>(a.y / inv);
        if (lse_bh != nullptr && e % DH == 0)
          lse_bh[g] = l > 0.f ? sM[g] + logf(l)
                              : -__int_as_float(0x7f800000);
      }
    }
  }
}

// Where run `run` of the S runs of (b, kh) leaves its state, in a launch's
// fp32 workspace `part`: every (sequence, KV head) pair's S run states in
// turn, state_floats<DH>(G) floats each; at dh 256 the pairs' group states
// after them (finish_wide_run).
template <int DH>
__device__ __forceinline__ float* run_state(float* part, int K, int S, int b,
                                            int kh, int G, int run) {
  return part + (((size_t)b * K + kh) * S + run) * state_floats<DH>(G);
}

// At dh 256, after a block of a launch over B x K (sequence, KV head) pairs
// has written the state of run `run` of the S runs of (b, kh) (run_state):
// its tickets and combines.  combine_states, past kGroupRuns runs in NG =
// run_groups<DH>(S) groups, whose states lie after every pair's runs (B * K
// * (S + NG) states in all), on 1 + NG tickets a pair (the last combine's,
// then a group's each), 0 before and left at 0.  (At the narrow loop's head
// dims the kernels keep one ticket a pair, and the last run to finish calls
// combine_runs.)
template <int DH, size_t kSmem, typename T>
__device__ __forceinline__ void finish_wide_run(float* part, int* counters,
                                                int B, int K, int S, int b,
                                                int kh, int G, int run,
                                                T* out_bh, float* lse_bh) {
  static_assert(kWide<DH>, "the narrow loop's head dims take combine_runs");
  const size_t bk = (size_t)b * K + kh;
  const int sf = state_floats<DH>(G);
  const float* p0 = part + bk * S * sf;
  const int NG = run_groups<DH>(S);
  int* tickets = counters + bk * (1 + NG);
  if (NG == 0) {
    if (last_run_done(tickets, S))
      combine_states<DH, kSmem>(p0, G, S, out_bh, lse_bh, nullptr);
    return;
  }
  float* groups = part + ((size_t)B * K * S + bk * NG) * sf;
  const int g = run / kGroupRuns, lo = g * kGroupRuns;
  const int n = min(kGroupRuns, S - lo);
  if (!last_run_done(tickets + 1 + g, n)) return;
  combine_states<DH, kSmem, T>(p0 + (size_t)lo * sf, G, n, nullptr, nullptr,
                               groups + (size_t)g * sf);
  if (last_run_done(tickets, NG))
    combine_states<DH, kSmem>(groups, G, NG, out_bh, lse_bh, nullptr);
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

// d += A * B for one m16n8k16 tile with all 16 rows of A (ldmatrix's four
// 8 x 8 matrices in order: rows 0-7 and 8-15 of k 0-7, then of k 8-15).
__device__ __forceinline__ void mma_16816_full(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The narrow loop's shapes.  A head dim that is not a whole number of
// 16-wide k-steps (24, 120) is rounded up to one (kDHPad): the last
// k-step's upper half multiplies zeros, the q fragment's (never loaded) and
// the K rows' pad columns [DH, kDHPad) (zeroed once a block; no copy writes
// them).  Rows keep 8 more elements beyond kDHPad, so that a row is an odd
// number of 16-byte pieces and ldmatrix stays free of bank conflicts.
template <int DH>
struct MmaShape {
  static constexpr int kDHPad = (DH + 15) / 16 * 16;  // whole k-steps
  static constexpr int kRow = kDHPad + 8;        // padded row, bf16 elements
  static constexpr int kChunks = DH / 8;         // 16-byte pieces a row
  static constexpr int kStageElems = 2 * kStep * kRow;   // K then V
  static constexpr size_t kSmemBytes =
      (size_t)kWarps * kStages * kStageElems * sizeof(__nv_bfloat16);
  static_assert(DH % 8 == 0, "head dim must be whole n-tiles of 8");
  static_assert(kSmemBytes >= kWarps * kMaxG * (DH + 2) * sizeof(float),
                "the block's combine reuses the stages");
  static_assert(kSmemBytes <= 227 * 1024,
                "the stages exceed a block's shared memory");
};

// The wide loop's shapes: one ring of kStages stages of 16 K rows then 16 V
// rows (padded as the narrow loop's), then the warps' quarter scores of a
// step, [2 steps][kWarps][kMaxG heads][kSpRow] fp32 (kSpRow 20: the four
// lanes of a quad store to distinct banks), then a step's slot mask a stage.
template <int DH>
struct WideShape {
  static constexpr int kStages = 4;
  static constexpr int kAhead = 4;               // steps of slot words ahead
  static constexpr int kRow = DH + 8;
  static constexpr int kChunks = DH / 8;
  static constexpr int kCols = DH / kWarps;      // a warp's head-dim columns
  static constexpr int kTiles = kCols / 16;      // its k-steps and m-tiles
  static constexpr int kSpRow = 20;
  static constexpr int kStageElems = 2 * kStep * kRow;
  static constexpr size_t kStageBytes =
      (size_t)kStages * kStageElems * sizeof(__nv_bfloat16);
  static constexpr size_t kSpFloats = 2 * kWarps * kMaxG * kSpRow;
  static constexpr size_t kSmemBytes =
      kStageBytes + kSpFloats * sizeof(float) + kStages * sizeof(unsigned);
  static_assert(DH % (16 * kWarps) == 0, "whole m-tiles a warp");
  static_assert((2 * kStep * kChunks) % kThreads == 0,
                "whole rounds of copies a step");
  static_assert(kSmemBytes <= 113 * 1024, "two blocks an SM");
};

// The bf16 loop of a head dim (kWide above), and its dynamic shared memory
// a block.
template <int DH>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  if constexpr (kWide<DH>)
    return WideShape<DH>::kSmemBytes;
  else
    return MmaShape<DH>::kSmemBytes;
}

// A step's slot as its owning lane sees it a step ahead: attended to, and
// (with Rows::kRowAhead) its row in the pool.
struct SlotAhead {
  bool ok;
  int row;
};

// Slots [t_lo, t_hi) of one (sequence, KV head), q_base the offset of its
// first query head in q; the run's state (acc[g][d], then m[g], then l[g])
// to `state`.  Called by all kThreads threads of the block, with
// MmaShape<DH>::kSmemBytes of dynamic shared memory.
//
// Lane layout of the m16n8k16 fragments (grp = lane / 4, tig = lane % 4):
// query head grp's row of scores for slots 8j + 2 tig + {0, 1} of a step sits
// in sc[j][0..1]; the same lane's output columns 8 nt + 2 tig + {0, 1} of
// head grp sit in acc[nt][0..1].  acc[nt][2..3] belong to the padding rows
// and stay 0.
template <int DH, class Rows>
__device__ __forceinline__ void decode_run_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const Rows& rows, size_t q_base,
    int G, float scale, int t_lo, int t_hi, float* __restrict__ state) {
  using Sh = MmaShape<DH>;
  constexpr int kKSteps = Sh::kDHPad / 16;
  constexpr int kNTiles = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ unsigned smask[kWarps][kStages];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int steps = (t_hi - t_lo + kStep - 1) / kStep;
  const int mine = steps > warp ? (steps - 1 - warp) / kWarps + 1 : 0;
  __nv_bfloat16* stages = smem + (size_t)warp * kStages * Sh::kStageElems;

  // this lane's A fragments of q: head grp, columns 16 ks + 2 tig (+8)
  uint32_t qa0[kKSteps], qa2[kKSteps];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const __nv_bfloat16* qr = q + q_base + (size_t)grp * DH + 16 * ks +
                              2 * tig;
    qa0[ks] = grp < G ? __ldg(reinterpret_cast<const unsigned*>(qr)) : 0u;
    qa2[ks] = grp < G && 16 * ks + 8 < DH
                  ? __ldg(reinterpret_cast<const unsigned*>(qr + 8))
                  : 0u;
  }
  if constexpr (Sh::kDHPad != DH) {
    // the K rows' pad columns meet the zero half of q's last k-step: they
    // must hold finite values, zeros here
    static_assert(Sh::kDHPad - DH == 8, "one 16-byte piece of pad");
    for (int r = lane; r < kStages * kStep; r += 32)
      *reinterpret_cast<uint4*>(stages + (r / kStep) * Sh::kStageElems +
                                (r % kStep) * Sh::kRow + DH) =
          make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }

  // slot lane of the warp's j-th step (lanes 0..15): whether it is attended
  // to, and its row; read one iteration before the step is fetched, so the
  // latency overlaps
  auto slot_ahead = [&](int j) {
    const int t = t_lo + (warp + kWarps * j) * kStep + lane;
    SlotAhead a{j < mine && lane < kStep && t < t_hi && rows.valid(t), 0};
    if constexpr (Rows::kRowAhead)
      if (a.ok) a.row = rows.row_of(t);
    return a;
  };
  // the warp's j-th step into stage j % kStages; its valid slots as a mask
  auto fetch = [&](int j, SlotAhead a) {
    const int st = j % kStages;
    const int t0 = t_lo + (warp + kWarps * j) * kStep;
    const unsigned vm = __ballot_sync(0xffffffffu, a.ok);
    if (lane == 0) smask[warp][st] = vm;
    __nv_bfloat16* sk = stages + st * Sh::kStageElems;
    __nv_bfloat16* sv = sk + kStep * Sh::kRow;
    // kStep * kChunks 16-byte copies a step for K, as many for V, in whole
    // rounds of the warp: every lane reaches the __shfl_sync of every round
    // (dh 24 has 1.5 rounds of copies, dh 120 7.5; the last round's upper
    // lanes copy nothing)
    constexpr int kCopies = kStep * Sh::kChunks;
    for (int e0 = 0; e0 < kCopies; e0 += 32) {
      const int e = e0 + lane;
      const bool mine_copy = kCopies % 32 == 0 || e < kCopies;
      const int tok = mine_copy ? e / Sh::kChunks : 0;
      const int ch = e - tok * Sh::kChunks;
      const bool live = mine_copy && ((vm >> tok) & 1u);
      size_t off;
      if constexpr (Rows::kRowAhead) {
        const int row = __shfl_sync(0xffffffffu, a.row, tok);
        off = live ? rows.off_of(row) + (size_t)ch * 8 : 0;
      } else {
        off = live ? rows.off(t0 + tok) + (size_t)ch * 8 : 0;
      }
      if (mine_copy) {
        const int so = tok * Sh::kRow + ch * 8;
        cp_async16(smem_addr(sk + so), k + off, live);
        cp_async16(smem_addr(sv + so), v + off, live);
      }
    }
  };

  float acc[kNTiles][4];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_run = kNegInf, l_run = 0.f;   // head grp's; l_run this lane's part

  SlotAhead ok[kStages];
#pragma unroll
  for (int j = 0; j < kStages; ++j) ok[j] = slot_ahead(j);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < mine) fetch(j, ok[j]);
    cp_async_commit();
  }
  SlotAhead ok_next = ok[kStages - 1];       // step j + kStages - 1's
  for (int j = 0; j < mine; ++j) {
    if (j + kStages - 1 < mine) fetch(j + kStages - 1, ok_next);
    ok_next = slot_ahead(j + kStages);
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
    for (int jj = 0; jj < kNTiles / 2; ++jj) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, smem_addr(sv + ((mi & 1) * 8 + mr) * Sh::kRow +
                                  16 * jj + (mi >> 1) * 8));
      mma_16816(acc[2 * jj], pa0, pa2, vb[0], vb[1]);
      mma_16816(acc[2 * jj + 1], pa0, pa2, vb[2], vb[3]);
    }
    if constexpr (kNTiles % 2 != 0) {
      // dh 24, 120: the last n-tile alone; the load's upper two matrices
      // are pad columns of the padded row, read and unused
      uint32_t vb[4];
      ldsm_x4_trans(vb, smem_addr(sv + ((mi & 1) * 8 + mr) * Sh::kRow +
                                  16 * (kNTiles / 2) + (mi >> 1) * 8));
      mma_16816(acc[kNTiles - 1], pa0, pa2, vb[0], vb[1]);
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
    state[e] = a;
    if (d == 0) {
      state[G * DH + g] = m;
      state[G * DH + G + g] = l;
    }
  }
}

// The wide loop (see the head of this file): slots [t_lo, t_hi) of one
// (sequence, KV head), as decode_run_mma, with WideShape<DH>::kSmemBytes of
// dynamic shared memory.
//
// Fragments (grp = lane / 4, tig = lane % 4; warp w's columns c0 = w * kCols
// on): the scores' B operand is q^T, head grp's columns c0 + 16 ks + 2 tig
// (+8) in qb0[ks], qb1[ks]; the scores' accumulator sc holds slots grp and
// grp + 8 of heads 2 tig and 2 tig + 1; after the quarters are summed the
// lane holds head grp's slots 2 tig, 2 tig + 1, 2 tig + 8 and 2 tig + 9,
// exactly the weighted sum's B operand P^T; acc[mt] holds head-dim columns
// c0 + 16 mt + grp (+8) of heads 2 tig and 2 tig + 1.
template <int DH, class Rows>
__device__ __forceinline__ void decode_run_wide(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const Rows& rows, size_t q_base,
    int G, float scale, int t_lo, int t_hi, float* __restrict__ state) {
  using Sh = WideShape<DH>;
  constexpr int kS = Sh::kStages, kAhead = Sh::kAhead;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* sp = reinterpret_cast<float*>(smem_raw + Sh::kStageBytes);
  unsigned* smask = reinterpret_cast<unsigned*>(sp + Sh::kSpFloats);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, its row
  const int c0 = warp * Sh::kCols;
  const int steps = t_hi > t_lo ? (t_hi - t_lo + kStep - 1) / kStep : 0;

  // the word that says whether slot lane of step j is attended to, and
  // (K3) where its row lies (lanes 0..15, the same in every warp): loaded
  // kAhead steps before the step is fetched, read only when it is
  auto slot_word = [&](int j) {
    const int t = t_lo + j * kStep + lane;
    return lane < kStep && t < t_hi ? rows.word(t) : 0;
  };
  // step j into stage j % kS by all threads: row tok of K and of V in
  // 16-byte pieces, thread tid taking pieces tid, tid + kThreads, ...
  auto fetch = [&](int j, int word) {
    const int st = j % kS;
    const int t0 = t_lo + j * kStep;
    const bool ok = lane < kStep && t0 + lane < t_hi &&
                    rows.valid_word(t0 + lane, word);
    const unsigned vm = __ballot_sync(0xffffffffu, ok);
    if (tid == 0) smask[st] = vm;
    int row = 0;
    if constexpr (Rows::kRowAhead)
      row = ok ? rows.row_word(t0 + lane, word) : 0;
    __nv_bfloat16* sk = stages + st * Sh::kStageElems;
    __nv_bfloat16* sv = sk + kStep * Sh::kRow;
#pragma unroll
    for (int i = 0; i < kStep * Sh::kChunks / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int tok = e / Sh::kChunks, ch = e - tok * Sh::kChunks;
      const bool live = (vm >> tok) & 1u;
      size_t off;
      if constexpr (Rows::kRowAhead) {
        const int r = __shfl_sync(0xffffffffu, row, tok);
        off = live ? rows.off_of(r) + (size_t)ch * 8 : 0;
      } else {
        off = live ? rows.off(t0 + tok) + (size_t)ch * 8 : 0;
      }
      const int so = tok * Sh::kRow + ch * 8;
      cp_async16(smem_addr(sk + so), k + off, live);
      cp_async16(smem_addr(sv + so), v + off, live);
    }
  };

  // the first kS - 1 steps in flight before anything waits, their words
  // and the next kAhead steps' loaded together; words[d] holds the word of
  // the step that iteration j = d (mod kAhead) fetches
  int words[kAhead];
  {
    int first[kS - 1];
#pragma unroll
    for (int j = 0; j < kS - 1; ++j) first[j] = slot_word(j);
#pragma unroll
    for (int d = 0; d < kAhead; ++d) words[d] = slot_word(kS - 1 + d);
#pragma unroll
    for (int j = 0; j < kS - 1; ++j) {
      if (j < steps) fetch(j, first[j]);
      cp_async_commit();
    }
  }

  // the scores' B operand: head grp, this warp's columns
  uint32_t qb0[Sh::kTiles], qb1[Sh::kTiles];
#pragma unroll
  for (int ks = 0; ks < Sh::kTiles; ++ks) {
    const unsigned* qr = reinterpret_cast<const unsigned*>(
        q + q_base + (size_t)grp * DH + c0 + 16 * ks + 2 * tig);
    qb0[ks] = grp < G ? __ldg(qr) : 0u;
    qb1[ks] = grp < G ? __ldg(qr + 4) : 0u;
  }
  float acc[Sh::kTiles][4];
#pragma unroll
  for (int mt = 0; mt < Sh::kTiles; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m_run = kNegInf, l_run = 0.f;   // head grp's; l_run this lane's part

  cp_async_wait<kS - 2>();   // step 0's copies of this thread
  __syncthreads();
  // kAhead iterations a round, so that words[d] stays in a register
  for (int j0 = 0; j0 < steps; j0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int j = j0 + d;
      if (j >= steps) break;
      const int st = j % kS;
      const __nv_bfloat16* sk = stages + st * Sh::kStageElems;
      const __nv_bfloat16* sv = sk + kStep * Sh::kRow;

      // this warp's quarter of S^T = K q^T, to shared memory
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < Sh::kTiles; ++ks) {
        uint32_t ka[4];
        ldsm_x4(ka, smem_addr(sk + ((mi & 1) * 8 + mr) * Sh::kRow + c0 +
                              16 * ks + (mi >> 1) * 8));
        mma_16816_full(sc, ka, qb0[ks], qb1[ks]);
      }
      float* spj = sp + (size_t)(j & 1) * kWarps * kMaxG * Sh::kSpRow;
      float* spw = spj + warp * kMaxG * Sh::kSpRow;
      spw[(2 * tig) * Sh::kSpRow + grp] = sc[0];
      spw[(2 * tig + 1) * Sh::kSpRow + grp] = sc[1];
      spw[(2 * tig) * Sh::kSpRow + grp + 8] = sc[2];
      spw[(2 * tig + 1) * Sh::kSpRow + grp + 8] = sc[3];
      cp_async_wait<kS - 3>();   // step j + 1's copies of this thread
      // the quarters written; step j + 1's copies landed; every warp is
      // done with step j - 1, whose stage the next fetch refills
      __syncthreads();
      if (j + kS - 1 < steps) fetch(j + kS - 1, words[d]);
      cp_async_commit();
      words[d] = slot_word(j + kS - 1 + kAhead);

      // head grp's scores at slots 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9:
      // the four quarters summed in warp order
      const unsigned vm = smask[st];
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* r = spj + (w * kMaxG + grp) * Sh::kSpRow + 2 * tig;
        const float2 lo = *reinterpret_cast<const float2*>(r);
        const float2 hi = *reinterpret_cast<const float2*>(r + 8);
        s4[0] += lo.x;
        s4[1] += lo.y;
        s4[2] += hi.x;
        s4[3] += hi.y;
      }
      // online softmax of head grp, over the quad's 16 slots (every warp
      // computes the same)
      float x[4];
      bool live[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        live[i] = (vm >> (2 * tig + (i & 1) + 8 * (i >> 1))) & 1u;
        x[i] = live[i] ? s4[i] * scale : kNegInf;
      }
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float corr = __expf(m_run - m_new);
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = live[i] ? __expf(x[i] - m_new) : 0.f;
      l_run = l_run * corr + ((pr[0] + pr[1]) + (pr[2] + pr[3]));
      m_run = m_new;
      // acc's heads 2 tig and 2 tig + 1 take the corrections of the lanes
      // that own them
      const float c_a = __shfl_sync(0xffffffffu, corr, 8 * tig);
      const float c_b = __shfl_sync(0xffffffffu, corr, 8 * tig + 4);
#pragma unroll
      for (int mt = 0; mt < Sh::kTiles; ++mt) {
        acc[mt][0] *= c_a;
        acc[mt][1] *= c_b;
        acc[mt][2] *= c_a;
        acc[mt][3] *= c_b;
      }

      // acc += V^T P^T over this warp's columns, V through ldmatrix.trans
      const uint32_t pb0 = pack_bf16(pr[0], pr[1]);
      const uint32_t pb1 = pack_bf16(pr[2], pr[3]);
#pragma unroll
      for (int mt = 0; mt < Sh::kTiles; ++mt) {
        uint32_t va[4];
        ldsm_x4_trans(va, smem_addr(sv + ((mi >> 1) * 8 + mr) * Sh::kRow +
                                    c0 + 16 * mt + (mi & 1) * 8));
        mma_16816_full(acc[mt], va, pb0, pb1);
      }
    }
  }
  cp_async_wait<0>();
  float l_row = l_run;
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 1);
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 2);

  // this warp's columns of the run's state; m and l, equal in every warp,
  // from warp 0
#pragma unroll
  for (int mt = 0; mt < Sh::kTiles; ++mt) {
    const int d = c0 + 16 * mt + grp;
    if (2 * tig < G) {
      state[(2 * tig) * DH + d] = acc[mt][0];
      state[(2 * tig) * DH + d + 8] = acc[mt][2];
    }
    if (2 * tig + 1 < G) {
      state[(2 * tig + 1) * DH + d] = acc[mt][1];
      state[(2 * tig + 1) * DH + d + 8] = acc[mt][3];
    }
  }
  if (warp == 0 && tig == 0 && grp < G) {
    state[G * DH + grp] = m_run;
    state[G * DH + G + grp] = l_row;
  }
}

// Sets kernel's dynamic shared memory limit to `bytes` on the first call
// through `sized`, which the caller keeps per kernel (a static of a function
// with internal linkage, so that it is the library's own).
template <class Kernel>
inline cudaError_t size_smem_once(bool& sized, Kernel kernel, size_t bytes) {
  if (sized) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) sized = true;
  return err;
}

// What one kernel instance takes on this card, launched with kThreads
// threads and `smem` bytes of dynamic shared memory (its limit is set to
// that, as its launch sets it): out[0] its blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] smem, out[2] its
// registers a thread, out[3] its local memory a thread in bytes.
template <class Kernel>
inline cudaError_t kernel_usage(Kernel kernel, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                        kThreads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    out[1] = (int)smem;
    out[2] = attr.numRegs;
    out[3] = (int)attr.localSizeBytes;
  }
  return err;
}

}  // namespace dtiles
