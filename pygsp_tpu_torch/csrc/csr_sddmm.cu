// CSR SDDMM for Hopper (sm_90a), the SpMM's gradient with respect to its
// stored values:
//   out[e]      += alpha * <u[rows[e], :], t[cols[e], :]>   for e < nnz
//   out_diag[i] += alpha * <u[i, :], t[i, :]>               (optional)
// with u (n_rows, S) and t (n_cols, S), row-major with one row stride ld
// (>= S), S from 1 to 512 (the wrapper takes wider ones 512 columns a
// launch), and alpha read from a 0-dim tensor on the card (the wrapper's).
//
// Replaces: what jax.grad makes of pygsp_tpu/core/sparse.py:spmm (lines
// 282-289, the gather + segment_sum) with respect to mat.vals: the
// transpose of the segment_sum gathers the cotangent's rows, the transpose
// of the gather is the row-wise product with x, summed over the columns
// (an XLA fusion, no Pallas kernel). The port's training path through the
// graph's weights (ops/chebyshev.py:_ChebyOp, core/sparse.py:_CSRSpmm)
// launches it once per Chebyshev step of the backward, with the diagonal
// fused (the Laplacian's diagonal takes the same cotangent on i == j).
// Padding entries (rows == n_rows, at the end of the edge arrays) are
// neither read nor written: the kernel skips an entry whose row is n_rows
// (it reads the padding's row index, nothing else).
//
// What bounds it on this card: device-memory bytes, and of those the
// gathers. Each stored edge reads one row of t (S values, 512 bytes at
// S = 128 in f32) from anywhere in t, which (0.5 GB at path A's graph)
// does not stay in the 50 MB L2 cache; u's rows are read in edge order,
// the edges being sorted by row. The least time is u, t, the two index
// arrays and out (read and written) once, about 1.34 GB at path A's
// 16,775,636 edges at S = 128 (0.40 ms at 3.35 TB/s), and the gather model,
// one t row per edge, about 8.6 GB (2.6 ms). The 2S flops an edge are far
// below the FP32 rate.
//
// Design (simple and right first). The edges are independent: nothing is
// summed across them, so the walk is cut into equal runs of edges, one
// warp each, whatever the rows' lengths (a hub row of 6616 edges is spread
// over many warps). A group of L = next_pow2(ceil(S / V)) lanes (at most
// 32) takes one edge, V values a lane (up to 16 bytes) and P passes of
// L * V columns, so a warp takes 32 / L edges a step: at S = 128 in f32 a
// whole warp an edge, one 16-byte load a lane of t's row; at S = 1 one
// edge a lane. A group keeps its u row in registers while its edges stay
// in that row (they are sorted by row, so a row is read once a run), and
// gathers t's row for each edge. Its L partial dot products are added by
// a butterfly of __shfl_xor_sync in a fixed order, every lane of the warp
// taking part (the trip count is the warp's, not the group's), and the
// group's lane 0 adds alpha times the sum into out[e]. Each edge is owned
// by one warp, so there are no atomics and two launches are bit-equal.
// Warps past the edge runs take the diagonal, a run of rows each, the same
// way with i == j. Making it fast (more gathers in flight a warp; the idle
// lanes at one column, where V = 1) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kStepsPerWarp = 32;  // steps of 32 / L edges a warp
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The lane's columns c0 .. c0 + V - 1 of row p (zero past s): one load of
// V values where rows are whole packs (vec), else scalars.
template <typename T, int V>
__device__ __forceinline__ void load_pack(const T* __restrict__ p, int c0,
                                          int s, bool vec, T (&v)[V]) {
  if (vec) {
    if (c0 < s) {
      const Pack<T, V> w = *reinterpret_cast<const Pack<T, V>*>(p + c0);
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = w.v[q];
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = T(0);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < V; ++q) v[q] = c0 + q < s ? p[c0 + q] : T(0);
}

// Warp w < edge_warps takes the edges [w * run, (w + 1) * run) below
// n_edges (the edge arrays' length, padding included); warp edge_warps + d
// the rows [d * run, (d + 1) * run) below n_rows, into out_diag.
// run = (32 / L) * kStepsPerWarp.
template <typename T, int V, int L, int P>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
csr_sddmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 const T* __restrict__ u, const T* __restrict__ t,
                 T* __restrict__ out, T* __restrict__ out_diag,
                 const T* __restrict__ alpha_p, int n_edges, int n_rows,
                 int s, int ld, int edge_warps, bool vec) {
  constexpr int G = 32 / L;  // edges a step
  constexpr int kRun = G * kStepsPerWarp;
  const int lane = threadIdx.x & 31;
  const int grp = lane / L, sub = lane % L;
  const int w = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const bool diag = w >= edge_warps;
  const long long b0 = static_cast<long long>(diag ? w - edge_warps : w) *
                       kRun;
  // the last block's spare warps, and every diagonal warp without out_diag,
  // have nothing to do
  const long long end = diag ? (out_diag ? n_rows : 0) : n_edges;
  if (b0 >= end) return;  // warp-uniform
  const long long b1 = b0 + kRun < end ? b0 + kRun : end;
  T* __restrict__ dst = diag ? out_diag : out;
  const T alpha = *alpha_p;

  T ur[P][V];
  int cached = -1;
  for (long long base = b0; base < b1; base += G) {
    const long long e = base + grp;
    int i = n_rows, j = 0;
    if (e < b1) {
      i = diag ? static_cast<int>(e) : rows[e];
      j = diag ? i : cols[e];
    }
    const bool live = i < n_rows;  // padding entries carry rows == n_rows
    T acc = T(0);
    if (live) {
      if (i != cached) {
        const T* __restrict__ urow = u + static_cast<size_t>(i) * ld;
#pragma unroll
        for (int p = 0; p < P; ++p)
          load_pack<T, V>(urow, (p * L + sub) * V, s, vec, ur[p]);
        cached = i;
      }
      const T* __restrict__ trow = t + static_cast<size_t>(j) * ld;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        T tv[V];
        load_pack<T, V>(trow, (p * L + sub) * V, s, vec, tv);
#pragma unroll
        for (int q = 0; q < V; ++q) acc = fma(ur[p][q], tv[q], acc);
      }
    }
    // every lane of the warp reaches the shuffles
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    // one rounding, as the fused entry of csr_spmm.cu adds its dots
    if (live && sub == 0) dst[e] = fma(alpha, acc, dst[e]);
  }
}

template <typename T, int V, int L, int P>
int launch_instance(const void* rows, const void* cols, const void* u,
                    const void* t, void* out, void* out_diag,
                    const void* alpha, int n_edges, int n_rows, int s,
                    int ld, bool vec, cudaStream_t st) {
  constexpr int kRun = (32 / L) * kStepsPerWarp;
  const long long edge_warps =
      (static_cast<long long>(n_edges) + kRun - 1) / kRun;
  const long long diag_warps =
      out_diag ? (static_cast<long long>(n_rows) + kRun - 1) / kRun : 0;
  const long long warps = edge_warps + diag_warps;
  if (warps == 0) return 0;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  csr_sddmm_kernel<T, V, L, P><<<static_cast<unsigned>(blocks),
                                 32 * kWarpsPerBlock, 0, st>>>(
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const T*>(u), static_cast<const T*>(t), static_cast<T*>(out),
      static_cast<T*>(out_diag), static_cast<const T*>(alpha), n_edges,
      n_rows, s, ld, static_cast<int>(edge_warps), vec);
  return static_cast<int>(cudaGetLastError());
}

// The instance for s columns: V = min(16 bytes, next_pow2(s)) values a
// lane, L = next_pow2(ceil(s / V)) lanes an edge (at most 32), and
// P = next_pow2(ceil(s / (L * V))) passes.
template <typename T>
int launch(const void* rows, const void* cols, const void* u, const void* t,
           void* out, void* out_diag, const void* alpha, int n_edges,
           int n_rows, int s, int ld, void* stream) {
  constexpr int kV = 16 / sizeof(T);
  if (s < 1 || s > 512 || ld < s || n_edges < 0 || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int v = s >= kV ? kV : (s > 2 ? 4 : s);
  int lanes = (s + v - 1) / v;
  int l = 1;
  while (l < lanes && l < 32) l *= 2;
  const int passes = (s + l * v - 1) / (l * v);
  const size_t pack = v * sizeof(T);
  const bool vec = s % v == 0 && ld % v == 0 &&
                   reinterpret_cast<size_t>(u) % pack == 0 &&
                   reinterpret_cast<size_t>(t) % pack == 0;
#define SDDMM_GO(V_, L_, P_)                                              \
  return launch_instance<T, V_, L_, P_>(rows, cols, u, t, out, out_diag,  \
                                        alpha, n_edges, n_rows, s, ld, vec, st)
  if (v == 1) SDDMM_GO(1, 1, 1);
  if (v < kV) SDDMM_GO(2, 1, 1);  // f32 at s = 2
  switch (l) {
    case 1: SDDMM_GO(kV, 1, 1);
    case 2: SDDMM_GO(kV, 2, 1);
    case 4: SDDMM_GO(kV, 4, 1);
    case 8: SDDMM_GO(kV, 8, 1);
    case 16: SDDMM_GO(kV, 16, 1);
    default: break;
  }
  if (passes <= 1) SDDMM_GO(kV, 32, 1);
  if (passes <= 2) SDDMM_GO(kV, 32, 2);
  if (passes <= 4) SDDMM_GO(kV, 32, 4);
  SDDMM_GO(kV, 32, 8);
#undef SDDMM_GO
}

}  // namespace

extern "C" int csr_sddmm_f32(const void* rows, const void* cols,
                             const void* u, const void* t, void* out,
                             void* out_diag, const void* alpha, int n_edges,
                             int n_rows, int s, int ld, void* stream) {
  return launch<float>(rows, cols, u, t, out, out_diag, alpha, n_edges,
                       n_rows, s, ld, stream);
}

extern "C" int csr_sddmm_f64(const void* rows, const void* cols,
                             const void* u, const void* t, void* out,
                             void* out_diag, const void* alpha, int n_edges,
                             int n_rows, int s, int ld, void* stream) {
  return launch<double>(rows, cols, u, t, out, out_diag, alpha, n_edges,
                        n_rows, s, ld, stream);
}
