// CSR SpMM for Hopper (sm_90a):
//   y[r, :] = sum_{e in [rowptr[r], rowptr[r+1])} vals[e] * x[cols[e], :]
// with x (n_cols, S) and y (n_rows, S), both row-major.
//
// Replaces: the XLA gather + segment_sum of pygsp_tpu/core/sparse.py:spmm
// (lines 282-289), the SpMM of every Chebyshev step on the default (COO/CSR)
// Laplacian format. Eager PyTorch would materialise that as an (E, S)
// product: 8.6 GB at the bench graph's 16.8M edges and S = 128.
//
// What bounds it on this card: device-memory bytes, and of those the
// gathers. Each stored edge pulls one row of x (S values, 512 bytes at
// S = 128 in f32) from anywhere in x, and x (0.5 GB at the bench graph)
// does not stay in the 50 MB L2 cache, so the least time is one row per
// edge at the memory rate (the gather model), far above x read once. The
// 2S flops per edge are far below the FP32 peak. So the kernel has to keep
// many rows in flight, on every SM, to the end of the launch.
//
// Design (merge path: balanced by edges and rows, not by rows alone). The
// walk over the matrix is the merge of its row ends and its edges, one
// step each, n_rows + nnz steps in all; it is cut into segments of
// kSegSteps steps, one warp each. The wrapper (core/csr_kernel.py:
// csr_segments) gives each segment's start, the row in progress and the
// edge, with one torch.searchsorted on rowptr[1:] + row index, so neither
// a host sync nor a per-matrix cache is needed. Counting row ends as steps
// keeps a run of empty rows (a million of them, in a matrix of hub rows
// alone) from falling to one warp, as it would with segments of edges
// alone. A warp walks its edges in order, 32 (col, val) pairs
// loaded at once and broadcast with __shfl_sync; row changes are
// warp-uniform, so nothing diverges. In f32 a lane owns 4 neighbouring
// columns and reads them as one 16-byte load (one warp instruction reads a
// whole 512-byte row of x at S = 128), and the loads of kInFlight edges are
// issued before their FMAs. S is walked in passes of 32 lanes * 16 bytes
// (128 columns in f32, 64 in f64) with the ragged edge masked; S that is
// not a whole number of 16-byte units takes scalar loads. A row that
// begins and ends inside its segment is written once, by that warp, rows
// with no edges as 0. A row that crosses segment boundaries, every hub row
// among them (path A's Barabasi-Albert graph has rows of up to 6616 edges),
// leaves one partial sum per segment in a scratch buffer that the wrapper
// allocates, and a second kernel adds them in segment order. So every row
// sums in a fixed order, no atomics, and two launches are bit-equal. At
// path A (S = 128): 2.89 ms on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py), 1.05x the gather model, against 4.01 ms for the
// one-warp-per-row kernel before it, 1.18 ms of which was the tail of the
// 54 hub rows. Registers (nvcc -Xptxas -v, sm_90a): 80 in f32 with 12
// bytes of spill, 91 in f64 with none.
//
// The narrow entry (csr_spmm_narrow_kernel, csr_spmm_narrow_f32/_f64),
// which core/csr_kernel.py takes up to 32 columns (NARROW_WIDTH). What
// bounds it: at S <= 8 in f32 x is at most 32 MB at 2^20 vertices and stays in
// the 50 MB L2, so the least time is the CSR's own bytes (cols, vals,
// rowptr) and y: 0.044 ms at path A's 16.8M stored entries, 0.021 ms at
// Sensor(2^20)'s 7.4M. The wide entry leaves 31 of a warp's 32 lanes idle
// at one column and walks its edges one at a time (1.21 ms at one column
// on path A). Design: the same walk, segments, destinations and join as
// above, the lanes over edges. A group of L = next_pow2(ceil(S / V))
// lanes takes one edge, V values a lane (up to 16 bytes), so a warp takes
// 32 / L edges a step with one coalesced load of cols and vals and as many
// gathers in flight; each lane finds its edge's row among the next 32 row
// ends, which the warp holds one a lane, by a binary search of shuffles,
// and the groups add their products by row in a segmented scan across the
// warp. So a row sums in a fixed order (the scan's tree within a step, the
// carried sum of the earlier steps first, the join in segment order): two
// launches are bit-equal, with no atomics. The wrapper's segments are 512
// steps (shorter on small matrices, so that enough warps run), the table
// kept on rowptr, and it skips the join where no row crosses a segment.
// Registers (nvcc -Xptxas -v, sm_90a): 32-40 in f32, 32-44 in f64, no
// spills. On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): at one
// column 0.181 ms on path A's graph (torch.sparse.mm 0.169) and 0.091 on
// Sensor(2^20) (0.082), against 1.262 and 0.640 for the wide entry; at 8
// columns 0.314 and 0.175 (library 1.191 and 0.643); at 32 columns 0.887
// on path A (wide 1.502). At one column it is 4x its byte bound and 1.07x
// the library's device time: a warp's steps wait on their gathers and
// shuffles in turn. A variant that found the rows from a mask of row
// starts (one __reduce_or_sync) instead of the binary search was no faster
// at one column and 12 % slower at 8 (tools/kernel_ab.py).
//
// The fused entry (csr_spmm_sddmm_kernel, csr_spmm_sddmm_f32/_f64), which
// the backward of A @ t through A's stored values takes above 32 columns
// (core/csr_kernel.py:csr_spmm_sddmm, fused_width). Replaces: the two
// passes of that backward over A's edges, each a transpose of
// pygsp_tpu/core/sparse.py:spmm (lines 282-289) under jax.grad: the
// cotangent of x, u's rows gathered and summed by A's columns (this
// kernel's wide entry on A^T), and the cotangent of the values, a dot of
// u[i] and t[j] for each stored (i, j) (csrc/csr_sddmm.cu, which gathers
// t's rows again). Walked by A^T's rows, one gather serves both: row j of
// A^T gathers u[i] for each edge (i, j), which the SpMM needs, and the dot
// needs only the row's own t[j], read once a row. What bounds it on this
// card: the gathers, one row of u per stored edge (8.6 GB at path A's
// 16.8M edges at S = 128 f32, 2.6 ms at 3.35 TB/s), beside which the
// bytes read or written once (A^T, u, t, y and the cotangents, about
// 1.9 GB) and the 4S flops an edge are small. Design: the wide entry's
// walk, segments, destinations and join, with all passes of an edge's
// columns in registers at once (K = kInFlight / P edges in flight, P
// passes each, so the per-column sums keep the wide entry's order and its
// bits). A lane dots the row pieces it gathered for the SpMM with t's row
// of the row in progress, which it loads one row ahead and keeps in
// registers, and the K edges' dots are reduced across the warp in the
// order of csr_sddmm's butterfly (split_dots, then butterfly), so each
// edge's cotangent is bit-equal to csr_sddmm's; a chunk's 32 dots are
// added to the cotangent with one coalesced load and store. Each edge lies
// in one segment, so no atomics, and two launches are bit-equal. The
// diagonal's dot <u[r], t[r]> is taken by the warp where row r begins,
// with u's row loaded when the row starts. Padding entries lie past
// rowptr[n_rows]: the walk never reaches them. At path A's A^T (S = 128
// f32, with the diagonal): 3.49 ms on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py), 1.17x the gather model, against 6.16 ms for the two
// launches it replaces. Registers (nvcc -Xptxas -v, sm_90a): 104 in f32
// and 106 in f64 at one pass (2 blocks an SM, the wide entry 3), 117-173
// at two and four, no spill; f64 at eight passes (above 256 columns) 255
// with 16 bytes of spill.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSegSteps = 256;  // walk steps (row ends and edges) per warp
constexpr int kInFlight = 8;    // edges whose x rows are loaded at once
constexpr unsigned kFull = 0xffffffffu;

// A lane's share of one pass: 16 bytes of a row, kVec values.
template <typename T>
struct Lane16;

template <>
struct Lane16<float> {
  static constexpr int kVec = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Lane16<double> {
  static constexpr int kVec = 2;
  __device__ static void load(const double* p, double (&v)[2]) {
    const double2 u = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = u.x, v[1] = u.y;
  }
  __device__ static void store(double* p, const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

// Load the lane's columns c0 .. c0 + kVec - 1 of row p (masked at s): one
// 16-byte load where rows are whole 16-byte units (vec), else scalars.
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, int c0, int s,
                                          bool vec,
                                          T (&v)[Lane16<T>::kVec]) {
  constexpr int V = Lane16<T>::kVec;
  if (vec && c0 < s) {
    Lane16<T>::load(p + c0, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = c0 + i < s ? p[c0 + i] : T(0);
}

template <typename T>
__device__ __forceinline__ void store_cols(T* p, int c0, int s, bool vec,
                                           const T (&v)[Lane16<T>::kVec]) {
  constexpr int V = Lane16<T>::kVec;
  if (vec) {
    if (c0 < s) Lane16<T>::store(p + c0, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c0 + i < s) p[c0 + i] = v[i];
}

// One warp per segment w. It starts with row r_begin in progress at edge
// e0 (seg[w], seg[n_seg + w]) and ends where segment w + 1 starts, with row
// r_stop in progress at edge e1 (the last segment: n_rows, nnz): it ends
// the rows r_begin .. r_stop - 1 and adds the edges [e0, e1). A row is
// flushed to
//   partials[w]               if it began before e0 (its first row),
//   y[r]                      else, if it ends here (empty rows too),
//   partials[n_seg + w]       else: r_stop, begun here, goes on past e1.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
csr_spmm_segment_kernel(const int* __restrict__ rowptr,
                        const int* __restrict__ cols,
                        const T* __restrict__ vals, const T* __restrict__ x,
                        T* __restrict__ y, const int* __restrict__ seg,
                        T* __restrict__ partials, int n_rows, int s, int n_seg,
                        bool vec) {
  constexpr int V = Lane16<T>::kVec;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_seg) return;  // uniform across the warp
  const int r_begin = seg[w];
  if (r_begin >= n_rows) return;  // past the end of the walk
  const int nnz = rowptr[n_rows];
  const int e0 = min(seg[n_seg + w], nnz);
  const bool last = w + 1 == n_seg;
  const int r_stop = last ? n_rows : seg[w + 1];
  const int e1 = last ? nnz : min(seg[n_seg + w + 1], nnz);

  for (int s0 = 0; s0 < s; s0 += 32 * V) {
    const int c0 = s0 + lane * V;
    // rowptr[rb + lane], 32 entries at a time, read by __shfl_sync
    int rb = r_begin;
    int rp = rb + lane <= n_rows ? rowptr[rb + lane] : nnz;
    auto row_ptr = [&](int i) {  // rowptr[i] for a warp-uniform i >= rb
      if (i - rb >= 32) {
        rb = i;
        rp = rb + lane <= n_rows ? rowptr[rb + lane] : nnz;
      }
      return __shfl_sync(kFull, rp, i - rb);
    };
    int r = r_begin;
    int rs = row_ptr(r), re = row_ptr(r + 1);  // row r's edges [rs, re)
    T acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = T(0);
    auto flush = [&]() {
      T* dst = rs < e0    ? partials + static_cast<size_t>(w) * s
               : r < r_stop ? y + static_cast<size_t>(r) * s
                            : partials + static_cast<size_t>(n_seg + w) * s;
      store_cols(dst, c0, s, vec, acc);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = T(0);
      ++r;
      rs = re;
      re = r < n_rows ? row_ptr(r + 1) : nnz;
    };

    for (int c = e0; c < e1; c += 32) {
      const int n = min(32, e1 - c);
      int col = 0;
      T val = T(0);
      if (lane < n) {
        col = cols[c + lane];
        val = vals[c + lane];
      }
      for (int j = 0; j < n; j += kInFlight) {
        T xv[kInFlight][V], v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int cj = __shfl_sync(kFull, col, (j + u) & 31);
          v[u] = __shfl_sync(kFull, val, (j + u) & 31);
          if (j + u < n) {
            load_cols(x + static_cast<size_t>(cj) * s, c0, s, vec, xv[u]);
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) xv[u][i] = T(0);
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (j + u < n) {
            while (c + j + u >= re) flush();  // rows that end before it
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] += v[u] * xv[u][i];
          }
        }
      }
    }
    // the rows that end in this segment, then r_stop if it has edges here
    // or began before
    while (r < n_rows && (r < r_stop || rs < e1)) flush();
  }
}

// One warp per segment boundary b (1 <= b < n_seg): the row rc in progress
// there, if it began in segment b - 1 (at or after its first edge, before
// edge seg[n_seg + b]), is the sum of that segment's last-row partial and
// the first-row partials of segments b, b + 1, ... that it spans, in that
// order.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
csr_spmm_join_kernel(const int* __restrict__ rowptr, T* __restrict__ y,
                     const int* __restrict__ seg,
                     const T* __restrict__ partials, int n_rows, int s,
                     int n_seg, bool vec) {
  constexpr int V = Lane16<T>::kVec;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5) + 1;
  if (b >= n_seg) return;
  const int rc = seg[b];
  if (rc >= n_rows) return;
  const int rs = rowptr[rc];
  // no crossing, or not its first
  if (rs >= seg[n_seg + b] || rs < seg[n_seg + b - 1]) return;
  int b_end = b + 1;
  while (b_end < n_seg && seg[b_end] == rc) ++b_end;
  for (int s0 = 0; s0 < s; s0 += 32 * V) {
    const int c0 = s0 + lane * V;
    T acc[V], part[V];
    load_cols(partials + static_cast<size_t>(n_seg + b - 1) * s, c0, s, vec,
              acc);
    for (int k = b; k < b_end; ++k) {
      load_cols(partials + static_cast<size_t>(k) * s, c0, s, vec, part);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += part[i];
    }
    store_cols(y + static_cast<size_t>(rc) * s, c0, s, vec, acc);
  }
}

// The narrow entry's share of a row for one lane: V values of T, loaded or
// stored as one aligned access where rows are whole packs (vec), else as
// masked scalars.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_pack(const T* p, int c0, int s,
                                          bool vec, T (&v)[V]) {
  if (vec && c0 < s) {
    const Pack<T, V> u = *reinterpret_cast<const Pack<T, V>*>(p + c0);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = u.v[i];
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = c0 + i < s ? __ldg(p + c0 + i) : T(0);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, int c0, int s, bool vec,
                                           const T (&v)[V]) {
  if (vec) {
    if (c0 < s) {
      Pack<T, V> u;
#pragma unroll
      for (int i = 0; i < V; ++i) u.v[i] = v[i];
      *reinterpret_cast<Pack<T, V>*>(p + c0) = u;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c0 + i < s) p[c0 + i] = v[i];
}

// The narrow entry: one warp per segment, as csr_spmm_segment_kernel, with
// the same destinations (y, or the partials that csr_spmm_join_kernel adds),
// but its lanes over edges. A group of L lanes takes one edge, each lane V of
// its columns (V * L >= s), so a step takes the G = 32 / L edges
// c .. c + G - 1. A lane finds its edge's row among the next 32 row ends,
// rowptr[rb + 1 ..], held one a lane (a binary search by __shfl_sync); the
// groups then add their products by row, a segmented inclusive scan over
// the groups (Kogge-Stone, by __shfl_up_sync), so the group that holds a
// row's last edge of the step has the row's sum over the step. The row in
// progress at the end of a step is carried into the next, whose first run
// adds it first. A step is cut short where the 32 row ends held do not
// reach its last edge (runs of empty rows): the window then moves on. The
// next step's cols and vals are loaded before this step's products.
template <typename T, int V, int L>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
csr_spmm_narrow_kernel(const int* __restrict__ rowptr,
                       const int* __restrict__ cols,
                       const T* __restrict__ vals, const T* __restrict__ x,
                       T* __restrict__ y, const int* __restrict__ seg,
                       T* __restrict__ partials, int n_rows, int s, int n_seg,
                       bool vec) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const int q = lane / L;       // the lane's group: edge c + q of a step
  const int c0 = (lane % L) * V;  // the lane's first column
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_seg) return;  // uniform across the warp
  const int r_begin = seg[w];
  if (r_begin >= n_rows) return;  // past the end of the walk
  const int nnz = rowptr[n_rows];
  const int e0 = min(seg[n_seg + w], nnz);
  const bool last = w + 1 == n_seg;
  const int r_stop = last ? n_rows : seg[w + 1];
  const int e1 = last ? nnz : min(seg[n_seg + w + 1], nnz);
  const bool begun = rowptr[r_begin] < e0;  // r_begin began before e0
  // where row r's sum over this segment goes (csr_spmm_segment_kernel's
  // flush)
  auto dst = [&](int r) {
    return r == r_begin && begun ? partials + static_cast<size_t>(w) * s
           : r < r_stop          ? y + static_cast<size_t>(r) * s
                          : partials + static_cast<size_t>(n_seg + w) * s;
  };

  // rows that end here with no edge in [e0, e1): empty rows, and r_begin
  // when its last edge lies in an earlier segment
  for (int r = r_begin + lane; r < r_stop; r += 32) {
    if (rowptr[r + 1] <= max(rowptr[r], e0)) {
      T* d = dst(r);
      for (int c = 0; c < s; ++c) d[c] = T(0);
    }
  }

  // lane k holds the end of row rb + k, rowptr[rb + 1 + k]
  int rb = r_begin;
  auto window = [&](int base) {
    const int i = base + 1 + lane;
    return i <= n_rows ? rowptr[i] : INT_MAX;
  };
  int end = window(rb);
  T carry[V];
#pragma unroll
  for (int i = 0; i < V; ++i) carry[i] = T(0);
  int cur = -1;  // the row whose sum so far `carry` holds, or -1
  int c = e0;
  int col = 0;
  T val = T(0);
  if (c + q < e1) {
    col = cols[c + q];
    val = vals[c + q];
  }
  while (c < e1) {
    int e_last = __shfl_sync(kFull, end, 31);
    while (e_last - c < min(G, e1 - c)) {
      const int done = __popc(__ballot_sync(kFull, end <= c));
      if (done == 0) break;  // the window starts at edge c's row
      rb += done;
      end = window(rb);
      e_last = __shfl_sync(kFull, end, 31);
    }
    const int n = min(min(G, e1 - c), e_last - c);  // edges in this step
    int col_next = 0;
    T val_next = T(0);
    if (c + n + q < e1) {
      col_next = cols[c + n + q];
      val_next = vals[c + n + q];
    }
    const bool live = q < n;
    const int e = c + q;
    T v[V];
    if (live) {
      load_pack<T, V>(x + static_cast<size_t>(col) * s, c0, s, vec, v);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = val * v[i];
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = T(0);
    }
    // the edge's row: rb + the number of held row ends at or before e
    int j = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(kFull, end, j + step - 1) <= e) j += step;
    const int row = rb + j;
    const int row_end = __shfl_sync(kFull, end, j);
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const int r_up = __shfl_up_sync(kFull, row, off * L);
      T u[V];
#pragma unroll
      for (int i = 0; i < V; ++i) u[i] = __shfl_up_sync(kFull, v[i], off * L);
      if (q >= off && r_up == row) {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = u[i] + v[i];
      }
    }
    if (cur >= 0 && row == cur) {  // the step's first run goes on from cur
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = carry[i] + v[i];
    }
    const int row_below = __shfl_down_sync(kFull, row, L);
    if (live && (q == n - 1 || row_below != row) && e + 1 == row_end &&
        row < r_stop)
      store_pack<T, V>(dst(row), c0, s, vec, v);
    // the step's last run: ended, or carried into the next step
    const int tail = (n - 1) * L;
    const int row_tail = __shfl_sync(kFull, row, tail);
    const int end_tail = __shfl_sync(kFull, row_end, tail);
#pragma unroll
    for (int i = 0; i < V; ++i)
      carry[i] = __shfl_sync(kFull, v[i], tail + lane % L);
    cur = c + n == end_tail && row_tail < r_stop ? -1 : row_tail;
    c += n;
    col = col_next;
    val = val_next;
  }
  // r_stop, begun here (or before) and going on past e1
  if (cur >= 0 && q == 0) store_pack<T, V>(dst(cur), c0, s, vec, carry);
}

template <typename T>
int launch(const void* rowptr, const void* cols, const void* vals,
           const void* x, void* y, const void* seg, void* partials,
           int n_rows, int s, int n_seg, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  // 16-byte loads need 16-byte-aligned rows of whole 16-byte units
  const bool vec = reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(y) % 16 == 0 &&
                   reinterpret_cast<size_t>(partials) % 16 == 0 &&
                   s * sizeof(T) % 16 == 0;
  const dim3 block(32 * kWarpsPerBlock);
  csr_spmm_segment_kernel<T><<<(n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock,
                               block, 0, st>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(cols),
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), static_cast<const int*>(seg),
      static_cast<T*>(partials), n_rows, s, n_seg, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_seg < 2) return static_cast<int>(err);
  csr_spmm_join_kernel<T><<<(n_seg - 1 + kWarpsPerBlock - 1) / kWarpsPerBlock,
                            block, 0, st>>>(
      static_cast<const int*>(rowptr), static_cast<T*>(y),
      static_cast<const int*>(seg), static_cast<const T*>(partials),
      n_rows, s, n_seg, vec);
  return static_cast<int>(cudaGetLastError());
}

// The narrow entry's instance for s columns: V values a lane (at most 16
// bytes), L = next_pow2(ceil(s / V)) lanes an edge.
template <typename T, int V, int L>
void launch_narrow_instance(const void* rowptr, const void* cols,
                            const void* vals, const void* x, void* y,
                            const void* seg, void* partials, int n_rows,
                            int s, int n_seg, bool vec, cudaStream_t st) {
  csr_spmm_narrow_kernel<T, V, L>
      <<<(n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock,
         0, st>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(cols),
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), static_cast<const int*>(seg),
      static_cast<T*>(partials), n_rows, s, n_seg, vec);
}

template <typename T>
int launch_narrow(const void* rowptr, const void* cols, const void* vals,
                  const void* x, void* y, const void* seg, void* partials,
                  int n_rows, int s, int n_seg, int join, void* stream) {
  constexpr int kV = 16 / sizeof(T);  // values of a 16-byte load
  if (s < 1 || s > 32 * kV) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int v = s >= kV ? kV : (s > 2 ? 4 : s);  // min(kV, next_pow2(s))
  const int lanes = (s + v - 1) / v;
  const size_t pack = v * sizeof(T);
  const bool vec = s % v == 0 && reinterpret_cast<size_t>(x) % pack == 0 &&
                   reinterpret_cast<size_t>(y) % pack == 0 &&
                   reinterpret_cast<size_t>(partials) % pack == 0;
  const auto go = [&](auto instance) {
    instance(rowptr, cols, vals, x, y, seg, partials, n_rows, s, n_seg, vec,
             st);
  };
  if (v == 1)
    go(launch_narrow_instance<T, 1, 1>);
  else if (v < kV)  // f32 at s = 2
    go(launch_narrow_instance<T, 2, 1>);
  else if (lanes == 1)
    go(launch_narrow_instance<T, kV, 1>);
  else if (lanes == 2)
    go(launch_narrow_instance<T, kV, 2>);
  else if (lanes <= 4)
    go(launch_narrow_instance<T, kV, 4>);
  else if (lanes <= 8)
    go(launch_narrow_instance<T, kV, 8>);
  else if (lanes <= 16)
    go(launch_narrow_instance<T, kV, 16>);
  else
    go(launch_narrow_instance<T, kV, 32>);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !join || n_seg < 2) return static_cast<int>(err);
  const bool vec16 = reinterpret_cast<size_t>(y) % 16 == 0 &&
                     reinterpret_cast<size_t>(partials) % 16 == 0 &&
                     s * sizeof(T) % 16 == 0;
  csr_spmm_join_kernel<T><<<(n_seg - 1 + kWarpsPerBlock - 1) / kWarpsPerBlock,
                            32 * kWarpsPerBlock, 0, st>>>(
      static_cast<const int*>(rowptr), static_cast<T*>(y),
      static_cast<const int*>(seg), static_cast<const T*>(partials), n_rows,
      s, n_seg, vec16);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The fused entry: the transpose's SpMM and the weights' SDDMM in one walk
// ---------------------------------------------------------------------------

// The first log2(K) levels of csr_sddmm.cu's butterfly over K edges' lane
// partials d[0..K-1] at once, the first at offset h (= L / 2). At each
// level a lane keeps half of its edges and sends its partner the other
// half, so a level costs K / 2 shuffles where a butterfly an edge costs
// K. Each kept value is the butterfly's own pair sum (x + y == y + x in
// IEEE arithmetic, and after a full butterfly every lane holds lane 0's
// bits), so the sums are bit-equal to csr_sddmm's. After them edge u lies
// in d[0] of the lanes whose bits h, h / 2, ... spell u from the top.
template <int K, typename T, int N>
__device__ __forceinline__ void split_dots(T (&d)[N], int lane, int& h) {
  if constexpr (K > 1) {
    const bool upper = (lane & h) != 0;
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const T send = upper ? d[i] : d[i + K / 2];
      const T recv = __shfl_xor_sync(kFull, send, h);
      d[i] = (upper ? d[i + K / 2] : d[i]) + recv;
    }
    h >>= 1;
    split_dots<K / 2>(d, lane, h);
  }
}

// csr_sddmm.cu's butterfly of one value from offset h down to 1.
template <typename T>
__device__ __forceinline__ T butterfly(T v, int h) {
  for (; h > 0; h >>= 1) v += __shfl_xor_sync(kFull, v, h);
  return v;
}

// One warp per segment w, as csr_spmm_segment_kernel, on the same walk,
// segments, destinations and join: y = M x for the CSR M (rowptr, cols,
// vals), and in the same pass
//   out[e]      += alpha * <x[cols[e]], t[r]>   for each edge e of row r,
//   out_diag[r] += alpha * <x[r], t[r]>          (optional; M square).
// The backward of A @ t calls it with M = A^T, x = the cotangent u: an edge
// (j, i) of A^T is A's (i, j), so out (in A^T's edge order) takes
// <u[i], t[j]>, the weights' cotangent of A's entry. All P passes of the
// columns are walked at once (kernel A's wide entry walks them one after
// another), so that an edge's dot is whole when its last pass is added:
// K = kInFlight / P edges in flight, each with its P row pieces. A
// column's sum over the edges, and so y, keeps kernel A's order.
template <typename T, int P>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
csr_spmm_sddmm_kernel(const int* __restrict__ rowptr,
                      const int* __restrict__ cols,
                      const T* __restrict__ vals, const T* __restrict__ x,
                      const T* __restrict__ t, T* __restrict__ y,
                      const int* __restrict__ seg, T* __restrict__ partials,
                      T* __restrict__ out, T* __restrict__ out_diag,
                      const T* __restrict__ alpha_p, int n_rows, int s,
                      int n_seg, bool vec, int half) {
  constexpr int V = Lane16<T>::kVec;
  constexpr int K = kInFlight / P > 0 ? kInFlight / P : 1;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_seg) return;  // uniform across the warp
  const int r_begin = seg[w];
  if (r_begin >= n_rows) return;  // past the end of the walk
  const int nnz = rowptr[n_rows];
  const int e0 = min(seg[n_seg + w], nnz);
  const bool last = w + 1 == n_seg;
  const int r_stop = last ? n_rows : seg[w + 1];
  const int e1 = last ? nnz : min(seg[n_seg + w + 1], nnz);
  const bool diag = out_diag != nullptr;
  const T alpha = *alpha_p;

  // the lane's columns of row r of a (n, s) tensor, every pass
  auto load_row = [&](const T* base, int r, T (&v)[P][V]) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      load_cols(base + static_cast<size_t>(r) * s, p * 32 * V + lane * V, s,
                vec, v[p]);
  };
  auto zero = [](T (&v)[P][V]) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < V; ++i) v[p][i] = T(0);
  };

  // rowptr[rb + lane], 32 entries at a time, read by __shfl_sync
  int rb = r_begin;
  int rp = rb + lane <= n_rows ? rowptr[rb + lane] : nnz;
  auto row_ptr = [&](int i) {  // rowptr[i] for a warp-uniform i >= rb
    if (i - rb >= 32) {
      rb = i;
      rp = rb + lane <= n_rows ? rowptr[rb + lane] : nnz;
    }
    return __shfl_sync(kFull, rp, i - rb);
  };
  int r = r_begin;
  int rs = row_ptr(r), re = row_ptr(r + 1);  // row r's edges [rs, re)
  T acc[P][V], tr[P][V], tn[P][V], ud[P][V];
  zero(acc);
  // t's row of the row in progress (tr) and of the next (tn, loaded a row
  // ahead), and x's row of the row in progress for the diagonal (ud)
  load_row(t, r, tr);
  if (r + 1 < n_rows) load_row(t, r + 1, tn); else zero(tn);
  if (diag && rs >= e0) load_row(x, r, ud); else zero(ud);
  auto flush = [&]() {
    T* dst = rs < e0    ? partials + static_cast<size_t>(w) * s
             : r < r_stop ? y + static_cast<size_t>(r) * s
                          : partials + static_cast<size_t>(n_seg + w) * s;
#pragma unroll
    for (int p = 0; p < P; ++p)
      store_cols(dst, p * 32 * V + lane * V, s, vec, acc[p]);
    zero(acc);
    if (diag && rs >= e0) {  // the row began here: its diagonal is ours
      T dd = T(0);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < V; ++i) dd = fma(ud[p][i], tr[p][i], dd);
      dd = butterfly(dd, half);
      if (lane == 0) out_diag[r] = fma(alpha, dd, out_diag[r]);
    }
    ++r;
    rs = re;
    re = r < n_rows ? row_ptr(r + 1) : nnz;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < V; ++i) tr[p][i] = tn[p][i];
    if (r + 1 < n_rows) load_row(t, r + 1, tn);
    if (diag && r < n_rows) load_row(x, r, ud);
  };

  for (int c = e0; c < e1; c += 32) {
    const int n = min(32, e1 - c);
    int col = 0;
    T val = T(0), o = T(0), mine = T(0);
    if (lane < n) {
      col = cols[c + lane];
      val = vals[c + lane];
      o = out[c + lane];
    }
    for (int j = 0; j < n; j += K) {
      T xv[K][P][V], v[K], d[K];
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int cj = __shfl_sync(kFull, col, (j + u) & 31);
        v[u] = __shfl_sync(kFull, val, (j + u) & 31);
        if (j + u < n)
          load_row(x, cj, xv[u]);
        else
          zero(xv[u]);
      }
#pragma unroll
      for (int u = 0; u < K; ++u) {
        d[u] = T(0);
        if (j + u < n) {
          while (c + j + u >= re) flush();  // rows that end before it
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int i = 0; i < V; ++i) acc[p][i] += v[u] * xv[u][p][i];
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int i = 0; i < V; ++i)
              d[u] = fma(xv[u][p][i], tr[p][i], d[u]);
        }
      }
      int h = half;
      split_dots<K>(d, lane, h);
      const T dot = butterfly(d[0], h);
      // edge j + u's dot to lane j + u, for one coalesced store a chunk
      const T got =
          __shfl_sync(kFull, dot, ((lane - j) & (K - 1)) * (2 * half / K));
      if (lane >= j && lane < j + K) mine = got;
    }
    if (lane < n) out[c + lane] = fma(alpha, mine, o);
  }
  // the rows that end in this segment, then r_stop if it has edges here
  // or began before
  while (r < n_rows && (r < r_stop || rs < e1)) flush();
}

template <typename T, int P>
int launch_sddmm_instance(const void* rowptr, const void* cols,
                          const void* vals, const void* x, const void* t,
                          void* y, const void* seg, void* partials, void* out,
                          void* out_diag, const void* alpha, int n_rows,
                          int s, int n_seg, bool vec, int half,
                          cudaStream_t st) {
  csr_spmm_sddmm_kernel<T, P>
      <<<(n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock,
         0, st>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(cols),
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<const T*>(t), static_cast<T*>(y),
      static_cast<const int*>(seg), static_cast<T*>(partials),
      static_cast<T*>(out), static_cast<T*>(out_diag),
      static_cast<const T*>(alpha), n_rows, s, n_seg, vec, half);
  return static_cast<int>(cudaGetLastError());
}

// P = next_pow2(passes of 32 lanes * 16 bytes), as csr_sddmm.cu's P at
// 32 lanes; half = L / 2 with L = next_pow2(ceil(s / V)) lanes an edge
// there (at least 8: K = 8 edges split over 8 lanes), so that each dot's
// butterfly is csr_sddmm's. s up to 512, as one csr_sddmm launch.
template <typename T>
int launch_sddmm(const void* rowptr, const void* cols, const void* vals,
                 const void* x, const void* t, void* y, const void* seg,
                 void* partials, void* out, void* out_diag,
                 const void* alpha, int n_rows, int s, int n_seg,
                 void* stream) {
  constexpr int V = Lane16<T>::kVec;
  const int lanes = (s + V - 1) / V;
  int l = 1;
  while (l < lanes && l < 32) l *= 2;
  if (s < 1 || s > 512 || l < 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int passes = (s + 32 * V - 1) / (32 * V);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(t) % 16 == 0 &&
                   reinterpret_cast<size_t>(y) % 16 == 0 &&
                   reinterpret_cast<size_t>(partials) % 16 == 0 &&
                   s * sizeof(T) % 16 == 0;
  int err;
#define SDDMM_GO(P_)                                                        \
  err = launch_sddmm_instance<T, P_>(rowptr, cols, vals, x, t, y, seg,      \
                                     partials, out, out_diag, alpha,        \
                                     n_rows, s, n_seg, vec, l / 2, st)
  if (passes <= 1) {
    SDDMM_GO(1);
  } else if (passes <= 2) {
    SDDMM_GO(2);
  } else if (passes <= 4) {
    SDDMM_GO(4);
  } else {
    if constexpr (V == 2)  // f64 above 256 columns; f32 takes at most 4
      SDDMM_GO(8);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SDDMM_GO
  if (err != cudaSuccess || n_seg < 2) return err;
  csr_spmm_join_kernel<T><<<(n_seg - 1 + kWarpsPerBlock - 1) / kWarpsPerBlock,
                            32 * kWarpsPerBlock, 0, st>>>(
      static_cast<const int*>(rowptr), static_cast<T*>(y),
      static_cast<const int*>(seg), static_cast<const T*>(partials), n_rows,
      s, n_seg, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int csr_spmm_f32(const void* rowptr, const void* cols,
                            const void* vals, const void* x, void* y,
                            const void* seg, void* partials, int n_rows,
                            int s, int n_seg, void* stream) {
  return launch<float>(rowptr, cols, vals, x, y, seg, partials, n_rows,
                       s, n_seg, stream);
}

extern "C" int csr_spmm_f64(const void* rowptr, const void* cols,
                            const void* vals, const void* x, void* y,
                            const void* seg, void* partials, int n_rows,
                            int s, int n_seg, void* stream) {
  return launch<double>(rowptr, cols, vals, x, y, seg, partials, n_rows,
                        s, n_seg, stream);
}

extern "C" int csr_spmm_narrow_f32(const void* rowptr, const void* cols,
                                   const void* vals, const void* x, void* y,
                                   const void* seg, void* partials,
                                   int n_rows, int s, int n_seg, int join,
                                   void* stream) {
  return launch_narrow<float>(rowptr, cols, vals, x, y, seg, partials,
                              n_rows, s, n_seg, join, stream);
}

extern "C" int csr_spmm_narrow_f64(const void* rowptr, const void* cols,
                                   const void* vals, const void* x, void* y,
                                   const void* seg, void* partials,
                                   int n_rows, int s, int n_seg, int join,
                                   void* stream) {
  return launch_narrow<double>(rowptr, cols, vals, x, y, seg, partials,
                               n_rows, s, n_seg, join, stream);
}

extern "C" int csr_spmm_sddmm_f32(const void* rowptr, const void* cols,
                                  const void* vals, const void* x,
                                  const void* t, void* y, const void* seg,
                                  void* partials, void* out, void* out_diag,
                                  const void* alpha, int n_rows, int s,
                                  int n_seg, void* stream) {
  return launch_sddmm<float>(rowptr, cols, vals, x, t, y, seg, partials, out,
                             out_diag, alpha, n_rows, s, n_seg, stream);
}

extern "C" int csr_spmm_sddmm_f64(const void* rowptr, const void* cols,
                                  const void* vals, const void* x,
                                  const void* t, void* y, const void* seg,
                                  void* partials, void* out, void* out_diag,
                                  const void* alpha, int n_rows, int s,
                                  int n_seg, void* stream) {
  return launch_sddmm<double>(rowptr, cols, vals, x, t, y, seg, partials,
                              out, out_diag, alpha, n_rows, s, n_seg, stream);
}
