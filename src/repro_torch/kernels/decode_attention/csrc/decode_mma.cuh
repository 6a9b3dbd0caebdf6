// bf16 one-token GQA flash-decoding of one run of cache slots on the tensor
// cores, and the in-launch combine of the runs: shared by the ring-cache
// kernel K4 (decode_attention.cu) and the paged kernel K3
// (paged_decode_attention.cu).  The two differ only in where slot t's K/V row
// lies and whether t is attended to; a Rows object answers both:
//     bool rows.valid(t)        slot t is attended to
//   with Rows::kRowAhead false (K4, ring slots: the row is arithmetic)
//     size_t rows.off(t)        offset, in elements, of slot t's row for
//                               this KV head
//   with Rows::kRowAhead true (K3, pages: the row needs a table load)
//     int rows.row_of(t)        slot t's row in the pool (loads its page id)
//     size_t rows.off_of(row)   offset of that row for this KV head
// With kRowAhead the lane that owns slot t of a step calls row_of(t) one
// step ahead, together with valid(t), so the table load's latency overlaps
// the current step; the lanes that copy the row get it by __shfl_sync.
//
// Design (K4's loop, lifted here unchanged): a block of four warps
// takes one run [t_lo, t_hi) of slots; each warp walks its own steps of 16
// slots (warp w takes steps w, w + 4, ...) through a ring of kStages
// shared-memory stages that it fills itself with 16-byte cp.async copies,
// kStages - 1 steps ahead; a masked slot gets the zero-filling form
// (src-size 0), so nothing of it is read and its zeros meet a probability of
// 0.  The slot mask is one __ballot_sync a step, computed a step ahead.  K/V
// stay bf16 in shared memory (rows padded by 16 bytes, so ldmatrix is free
// of bank conflicts).  Scores and the weighted sum are tensor-core products
// (mma.sync m16n8k16, bf16 in, fp32 sums), the G query heads padded to 16
// rows; the scores' accumulator turns into the probabilities' operand in
// registers, the online softmax runs in fp32 in the four lanes that hold a
// head's row.  A warp waits once a step (cp.async.wait_group + __syncwarp),
// the block once at the end, where the four warps' states are combined in
// warp order into the run's state (m, l, acc), written to a workspace.  A
// run with no slot writes the neutral state (m = -1e30, l = 0, acc = 0).
//
// The combine: after its state is written each block draws an integer
// ticket per (sequence, KV head) (after a __threadfence); the block that
// draws the last one combines the S states in run order (an online softmax
// over the runs, in one pass) and sets the counter back to 0 for the next
// launch.  The atomic decides only which block combines, never an order of
// float sums: a re-run is bit-identical.
#pragma once

#include <stdint.h>

#include "decode_tiles.cuh"

namespace dtiles {

constexpr int kStep = 16;                    // slots a warp takes per step
constexpr int kBlockStep = kStep * kWarps;   // 64: slots of one round
constexpr int kStages = 3;

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
// the online softmax does, eight runs' loads in flight.  With lse_bh (K4's
// partial entry) each head's log-sum-exp of its scores over the runs' slots,
// m + log l, goes there too; a head with no valid slot gets 0 in out_bh and
// -inf in lse_bh.
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

// A head dim that is not a whole number of 16-wide k-steps (24, 120) is
// rounded up to one (kDHPad): the last k-step's upper half multiplies zeros, the
// q fragment's (never loaded) and the K rows' pad columns [DH, kDHPad)
// (zeroed once a block; no copy writes them).  Rows keep 8 more elements
// beyond kDHPad, so that a row is an odd number of 16-byte pieces and
// ldmatrix stays free of bank conflicts.  At head dim 256 the stages take
// 202,752 bytes, so one block fits on an SM (the split aims at two).
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

}  // namespace dtiles
