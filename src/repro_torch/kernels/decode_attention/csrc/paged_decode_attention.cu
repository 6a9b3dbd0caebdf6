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
// so a row with no valid token gives 0.  A length past the table's P * ps
// slots reads only those, as the plain version's gather does; the window
// still counts back from the length.
//
// Bound: bytes.  The function must read the live K/V rows once
// (2 * n * dh * sizeof(T) per (b, kh)) plus q, out and the live block-table
// entries; its 4 * dh operations per token and query head are far below the
// card's rate.  Pages past the sequence's end (the scratch page 0 of the
// block table's tail) and tokens before the window are never read; the TPU
// grid walks all P pages and skips.
//
// Design: K4's, over pages, in ONE launch.  Each sequence's live range
// [lo, n), lo = max(0, n - window), is cut into S runs of whole 16-slot
// steps (aligned to multiples of 16, so with ps % 16 == 0 a step is one
// page), S from the shapes only (the wrapper's `paged_split`: about two
// blocks a SM over B * K * S blocks, or as many as the head dim's loop
// fits); block (kh, b, run) computes its own
// run from seq_lens[b] on the device (`paged_run`, mirrored by the
// wrapper's `paged_runs`), so a short sequence leaves no block idle and the
// host reads nothing back.
// * bf16, the serving path: the warp loops of decode_mma.cuh (shared with
//   K4; the wide one at head dim 256): cp.async stages, zero-filling copies
//   for masked slots, scores and weighted sums on the tensor cores.  The
//   lane that owns slot t of a step
//   loads the page id block_tables[b, t / ps] one step ahead, with the slot
//   mask, and the copying lanes get the row by __shfl_sync, so the table
//   load's latency overlaps the current step.
// * fp32: the SIMT tile loop of decode_tiles.cuh over the run (mma would
//   round fp32 to TF32).
// Each run's (m, l, acc) goes to an fp32 workspace; a run with no live slot
// writes the neutral state and still draws its ticket.  The block that draws
// the last ticket of (b, kh) (K3's own counters) combines the runs in run
// order and resets the ticket (at dh 256 past 8 runs in groups of 8 first,
// as K4: decode_mma.cuh's finish_wide_run).  A page id outside [0, N)
// stops the kernel (__trap: the launch then reports an error), as the plain
// version's gather fails on it.  No float atomics: a re-run is
// bit-identical.
#include "decode_mma.cuh"

namespace pda {

using namespace dtiles;

// Token t of one sequence: attended to for lo <= t < n; its row is
// block_tables[b, t / ps] * ps + t % ps of the pool.
struct PagedRows {
  static constexpr bool kRowAhead = true;    // a slot's row needs a load
  const int* bt;
  int lo, n, ps, N;
  size_t tok_stride, head_off;
  __device__ __forceinline__ bool valid(int t) const {
    return t >= lo && t < n;
  }
  // the wide loop reads a slot's word (its page id) steps before it
  // decides on it
  __device__ __forceinline__ int word(int t) const {
    return __ldg(bt + t / ps);
  }
  __device__ __forceinline__ bool valid_word(int t, int) const {
    return valid(t);
  }
  __device__ __forceinline__ int row_word(int t, int page) const {
    if (page < 0 || page >= N) __trap();
    return page * ps + t % ps;
  }
  __device__ __forceinline__ int row_of(int t) const {
    return row_word(t, word(t));
  }
  __device__ __forceinline__ size_t off_of(int row) const {
    return (size_t)row * tok_stride + head_off;
  }
  __device__ __forceinline__ bool row(int t, size_t* off) const {
    if (!valid(t)) return false;
    *off = off_of(row_of(t));
    return true;
  }
};

// Slots [t_lo, t_hi) of run `run` of S over the live range [lo, n) of a
// sequence of n_all tokens in a table of cap slots; lo and n as PagedRows
// takes them.  The range starts at lo rounded down to a multiple of kStep
// and is cut into S runs of per whole steps; a run past the end is empty.
struct PagedRun {
  int lo, n, t_lo, t_hi;
};
__device__ __forceinline__ PagedRun paged_run(int n_all, int window, int cap,
                                              int S, int run) {
  PagedRun r;
  n_all = max(n_all, 0);
  r.n = min(n_all, cap);
  r.lo = window > 0 ? max(0, n_all - window) : 0;
  r.t_lo = r.t_hi = 0;
  if (r.lo < r.n) {
    const int a = r.lo / kStep * kStep;
    const int steps = (r.n - a + kStep - 1) / kStep;
    const int per = (steps + S - 1) / S;
    r.t_lo = min(r.n, a + run * per * kStep);
    r.t_hi = min(r.n, r.t_lo + per * kStep);
  }
  return r;
}

template <typename T, int DH>
__host__ __device__ constexpr size_t paged_smem_bytes() {
  if constexpr (std::is_same<T, float>::value)
    return TilesShape<DH>::kSmemBytes;
  else
    return bf16_smem_bytes<DH>();
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens,
                    float* __restrict__ part, int* __restrict__ counters,
                    T* __restrict__ out, int H, int K, int G, int N, int ps,
                    int P, float scale, int window) {
  const int kh = blockIdx.x, b = blockIdx.y, run = blockIdx.z, S = gridDim.z;
  const PagedRun span = paged_run(__ldg(seq_lens + b), window, P * ps, S,
                                  run);
  const PagedRows rows{block_tables + (size_t)b * P, span.lo, span.n, ps, N,
                       (size_t)K * DH, (size_t)kh * DH};
  const size_t q_base = ((size_t)b * H + (size_t)kh * G) * DH;
  constexpr bool kWideDH = kWide<DH>;
  float* p0 = part + ((size_t)b * K + kh) * S * G * (DH + 2);
  float* state = kWideDH ? run_state<DH>(part, K, S, b, kh, G, run)
                         : p0 + (size_t)run * G * (DH + 2);
  if constexpr (std::is_same<T, float>::value)
    decode_tiles<DH>(q, k_pages, v_pages, q_base, G, scale, span.t_lo,
                     span.t_hi, rows, state);
  else if constexpr (kWideDH)
    decode_run_wide<DH>(q, k_pages, v_pages, rows, q_base, G, scale,
                        span.t_lo, span.t_hi, state);
  else
    decode_run_mma<DH>(q, k_pages, v_pages, rows, q_base, G, scale,
                       span.t_lo, span.t_hi, state);
  if constexpr (kWideDH)
    finish_wide_run<DH, paged_smem_bytes<T, DH>()>(
        part, counters, gridDim.y, K, S, b, kh, G, run, out + q_base,
        nullptr);
  else if (last_run_done(counters + (size_t)b * K + kh, S))
    combine_runs<T>(p0, out + q_base, G, DH, S);
}

// static: the flag below must be this library's own (a function-local static
// of an inline template is one symbol for the whole process).
template <typename T, int DH>
static cudaError_t launch_paged(dim3 grid, cudaStream_t s, const void* q,
                                const void* kp, const void* vp, const int* bt,
                                const int* sl, float* part, int* counters,
                                void* out, int H, int K, int G, int N, int ps,
                                int P, float scale, int window) {
  constexpr size_t smem = paged_smem_bytes<T, DH>();
  static bool sized = false;   // the attribute is set once a process
  const cudaError_t err =
      size_smem_once(sized, paged_decode_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, DH><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, sl, part, counters, static_cast<T*>(out),
      H, K, G, N, ps, P, scale, window);
  return cudaGetLastError();
}

}  // namespace pda

extern "C" int paged_decode_max_group() { return pda::kMaxG; }

// The slots of one step: runs are whole multiples of it.
extern "C" int paged_decode_step() { return pda::kStep; }

// What the kernel of one dtype (0 = float32, 1 = bfloat16) and head dim
// takes on this card, as decode_attention_usage reports it.  Returns a
// cudaError_t (0 = read).
extern "C" int paged_decode_attention_usage(int dtype, int dh, int* out) {
  using namespace pda;
  if (dtype != kFloat32 && dtype != kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t got = cudaSuccess;
  const cudaError_t err = with_head_dim(dh, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == kFloat32)
      got = kernel_usage(paged_decode_kernel<float, D>,
                         paged_smem_bytes<float, D>(), out);
    else
      got = kernel_usage(paged_decode_kernel<__nv_bfloat16, D>,
                         paged_smem_bytes<__nv_bfloat16, D>(), out);
  });
  return static_cast<int>(err == cudaSuccess ? got : err);
}

// q [B, H, dh]; k_pages, v_pages [N, ps, K, dh]; out [B, H, dh], all of one
// dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte aligned;
// block_tables [B, P] int32; seq_lens [B] int32 (this token included);
// window <= 0 means none.  Each sequence's live tokens are split into S runs
// on the device; part and counters as decode_attention_launch's (S runs
// over B * K pairs, S <= 64 at dh 256), left at 0 after the launch (one
// launch at a time may use them).  dh in {16, 24, 32, 64, 80, 120, 128,
// 160, 256}, H / K <= 8.  Returns the launch's cudaError_t (0 =
// launched).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, void* part,
    void* counters, void* out, int dtype, int B, int H, int K, int dh, int N,
    int ps, int P, int S, float scale, int window, void* stream) {
  using namespace pda;
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || H % K != 0 ||
      H / K > kMaxG || N < 1 || ps < 1 || P < 1 || S < 1 || S > 65535 ||
      (wide_head_dim(dh) && S > kMaxWideRuns) ||
      (long long)P * ps > (1 << 30) || (long long)N * ps > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(K, B, S);
  const int G = H / K;
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  float* ws = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  cudaError_t launched = cudaSuccess;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    err = with_head_dim(dh, [&](auto d) {
      launched = launch_paged<float, decltype(d)::value>(
          grid, s, q, k_pages, v_pages, bt, sl, ws, cnt, out, H, K, G, N, ps,
          P, scale, window);
    });
  } else if (dtype == kBFloat16) {
    err = with_head_dim(dh, [&](auto d) {
      launched = launch_paged<__nv_bfloat16, decltype(d)::value>(
          grid, s, q, k_pages, v_pages, bt, sl, ws, cnt, out, H, K, G, N, ps,
          P, scale, window);
    });
  }
  if (err == cudaSuccess) err = launched;
  return static_cast<int>(err);
}
