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
// (2 * n * dh * sizeof(T) per (b, kh)) plus q and out.  Design: the tile loop
// of decode_tiles.cuh, one block per (b, kh), over that sequence's tokens from
// the first one inside the window to n, so pages past the sequence end (the
// scratch page 0 of the block table's tail) are never read; the TPU grid walks
// all P pages and skips.  Each token's page id is read from global memory by
// the threads that load its row (the TPU prefetched the table into SMEM).
//
// Not yet done (later work, ROADMAP.md): split-KV across blocks for long
// sequences and small batches (B * K blocks fill only part of the card),
// TMA / cp.async double buffering, tensor-core products.
#include "decode_tiles.cuh"

namespace pda {

using namespace dtiles;

// Token t of one sequence: page block_tables[b, t / ps], slot t % ps.  A
// page id outside the pool stops the kernel (the launch then reports an
// error), as the plain version's gather fails on it.
struct PagedRows {
  const int* bt;
  int n, ps, N;
  size_t tok_stride, head_off;
  __device__ __forceinline__ bool row(int pos, size_t* off) const {
    if (pos >= n) return false;
    const int page = bt[pos / ps];
    if (page < 0 || page >= N) __trap();
    *off = ((size_t)page * ps + pos % ps) * tok_stride + head_off;
    return true;
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int H, int K, int G, int N, int ps, int P, float scale,
                    int window) {
  const int kh = blockIdx.x, b = blockIdx.y;
  // a length past the table's P * ps slots reads only those, as the plain
  // version's gather does; the window still counts back from the length
  const int n_all = max(seq_lens[b], 0);
  const int n = min(n_all, P * ps);
  const int lo = window > 0 ? max(0, n_all - window) : 0;
  const PagedRows rows{block_tables + (size_t)b * P, n, ps, N,
                       (size_t)K * DH, (size_t)kh * DH};
  decode_tiles<T, DH>(q, k_pages, v_pages, out,
                      ((size_t)b * H + (size_t)kh * G) * DH, G, scale, lo, n,
                      rows);
}

template <typename T>
cudaError_t launch_dh(int dh, dim3 grid, cudaStream_t s, const void* q,
                      const void* kp, const void* vp, const int* bt,
                      const int* sl, void* out, int H, int K, int G, int N,
                      int ps, int P, float scale, int window) {
  return with_head_dim(dh, [&](auto d) {
    paged_decode_kernel<T, decltype(d)::value><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), bt, sl, static_cast<T*>(out), H, K, G, N,
        ps, P, scale, window);
  });
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
