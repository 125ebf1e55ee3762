// Windowed-compact SpMM for Hopper (sm_90a), and the repo's two Pallas
// probe kernels.
//
// The windowed-compact format (pygsp_tpu_torch/core/windowed.py) packs the
// stored edges of each (out chunk i, P-row output window w, source chunk c)
// into slots: a column local to source chunk c (sentinel == R, the chunk
// size), a value, and a row id in [0, K*P) relative to the window's first
// row (ids at or above P address the K-1 following windows: borrowed
// slack). The SpMM y = A @ x is
//   (a) windowed_fold:
//       t[i, w, r, :] = sum_{c, l : rowid[i,w,c,l] = r}
//                       vals[i,w,c,l] * x[c*R + cols[i,w,c,l], :]
//   (b) window_strip, the overlap-add of the window tensor t:
//       y[i*R + w*P + r, :] = sum_{d < K, d <= w} t[i, w-d, d*P + r, :]
// plus the residue tiers, which stay in plain PyTorch.
//
// Replaces: (a) TPU kernel #2, benchmarks/pallas_fold_probe.py
// make_pallas_fold (the pl.pallas_call at line 103), the one-hot fold
// out[w, k, :] = sum_{l : rid[w,l] = k} p[w, l, :], fused with the slot
// gather and product that pygsp_tpu/core/windowed.py:298-303 makes before
// its one-hot einsum (:320); (b) the XLA overlap-add of
// pygsp_tpu/core/windowed.py:336-345; (c) fold_products is #2's function as
// it stands, products in, and at NW = 1 TPU kernel #3
// (benchmarks/pallas_smoke.py fold_kernel, pallas_call at line 52);
// (d) double is TPU kernel #4 (pallas_smoke.py dbl_kernel, line 28), the
// toolchain canary.
//
// What bounds (a) on this card: device-memory bytes. Each live slot pulls
// one row of x (S values) and does 2S flops. The least traffic is x read
// once plus the slot arrays plus t written once; the gathers re-read rows
// of x that the 50 MB L2 cache only partly holds. (b) and (c) stream their
// input and output once.
//
// Design of (a), simple first: one block per (window, S tile); thread s
// owns column s of the tile. The (K*P, S_tile) accumulator lives in shared
// memory, and thread s only ever touches its own column of it, so a warp
// updates one shared row with consecutive words (no bank conflicts), needs
// no atomics and sums each row in slot order (deterministic). The window's
// n_src*L slot triples are staged in shared memory 512 at a time, by all
// threads, with sentinel and out-of-range slots marked dead there: a dead
// slot is skipped and x is never read for it. Each thread issues kUnroll
// gathers of x before it folds them, so several loads are in flight per
// warp; a warp reads 128 contiguous bytes of one x row per load. The
// accumulator sums in the input type (f32 or f64), as the JAX fold does for
// those inputs. Tensor cores (the one-hot product as a wgmma), TMA and
// clusters are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 512;  // slot triples staged in shared memory at once
constexpr int kUnroll = 8;   // gathers in flight per thread

// Shared-memory bytes of a fold block: the accumulator plus the staged
// batch (value, source row, row id).
template <typename TAcc>
size_t fold_smem_bytes(int kp, int s_tile) {
  return static_cast<size_t>(kp) * s_tile * sizeof(TAcc) +
         kBatch * (sizeof(TAcc) + 2 * sizeof(int));
}

// Fold the n_slots slots of one window into out (kp rows of stride s):
//   acc[rid(j), col] += val(j) * src.load(row(j), col)
// Src::stage(j, row, val, rid) gives slot j's source row (-1: dead), value
// and row id; Src::load(row, col) reads one source value.
template <typename TAcc, typename Src>
__device__ void fold_window(const Src& src, int n_slots, int kp, int s_tile,
                            int col, bool active, TAcc* __restrict__ out,
                            int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  TAcc* acc = reinterpret_cast<TAcc*>(smem);  // (kp, s_tile)
  TAcc* s_val = acc + static_cast<size_t>(kp) * s_tile;
  int* s_row = reinterpret_cast<int*>(s_val + kBatch);
  int* s_rid = s_row + kBatch;
  const int tid = threadIdx.x;

  if (active)
    for (int r = 0; r < kp; ++r) acc[r * s_tile + tid] = TAcc(0);

  for (int j0 = 0; j0 < n_slots; j0 += kBatch) {
    const int nb = min(kBatch, n_slots - j0);
    __syncthreads();  // the previous batch is consumed
    for (int j = tid; j < nb; j += blockDim.x) {
      int row, rid;
      TAcc val;
      src.stage(j0 + j, row, val, rid);
      const bool live = row >= 0 && rid >= 0 && rid < kp;
      s_row[j] = live ? row : -1;
      s_rid[j] = rid;
      s_val[j] = val;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nb; j += kUnroll) {
      TAcc v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = j + u < nb ? s_row[j + u] : -1;
        v[u] = row >= 0 ? src.load(row, col) : TAcc(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u < nb && s_row[j + u] >= 0)
          acc[s_rid[j + u] * s_tile + tid] += s_val[j + u] * v[u];
      }
    }
  }
  if (!active) return;
  for (int r = 0; r < kp; ++r)
    out[static_cast<size_t>(r) * s + col] = acc[r * s_tile + tid];
}

// (a) slots of one window of the windowed-compact slabs, gathered from x.
template <typename T, typename RowId>
struct SlabSource {
  const int* cols;
  const T* vals;
  const RowId* rowid;
  const T* x;
  size_t base;  // first slot of the window
  int L, R, n_cols, s;

  __device__ void stage(int j, int& row, T& val, int& rid) const {
    const int c = j / L;
    const int lc = cols[base + j];
    const int g = c * R + lc;
    row = (lc >= 0 && lc < R && g < n_cols) ? g : -1;  // lc == R: sentinel
    val = vals[base + j];
    rid = static_cast<int>(rowid[base + j]);
  }
  __device__ T load(int row, int col) const {
    return x[static_cast<size_t>(row) * s + col];
  }
};

template <typename T, typename RowId>
__global__ void __launch_bounds__(128)
windowed_fold_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                     const RowId* __restrict__ rowid, const T* __restrict__ x,
                     T* __restrict__ t, int n_src, int L, int R, int kp,
                     int n_cols, int s, int s_tile) {
  const int n_slots = n_src * L;
  const size_t window = blockIdx.x;
  const int col = blockIdx.y * s_tile + threadIdx.x;
  const bool active = threadIdx.x < s_tile && col < s;
  const SlabSource<T, RowId> src{cols, vals, rowid, x,
                                 window * n_slots, L, R, n_cols, s};
  fold_window<T>(src, n_slots, kp, s_tile, col, active,
                 t + window * kp * s, s);
}

// (c) products of one window, read as they are; f32 accumulation.
template <typename P>
struct ProductSource {
  const int* rid;
  const P* p;
  size_t base;  // first slot of the window
  int s;

  __device__ void stage(int j, int& row, float& val, int& r) const {
    row = j;
    val = 1.0f;  // 1 * p is exact: the fold sums the products as they are
    r = rid[base + j];
  }
  __device__ float load(int row, int col) const {
    return to_float(p[(base + row) * s + col]);
  }
  __device__ static float to_float(float v) { return v; }
  __device__ static float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

template <typename P>
__global__ void __launch_bounds__(128)
fold_products_kernel(const int* __restrict__ rid, const P* __restrict__ p,
                     float* __restrict__ out, int lt, int kp, int s,
                     int s_tile) {
  const size_t window = blockIdx.x;
  const int col = blockIdx.y * s_tile + threadIdx.x;
  const bool active = threadIdx.x < s_tile && col < s;
  const ProductSource<P> src{rid, p, window * lt, s};
  fold_window<float>(src, lt, kp, s_tile, col, active,
                     out + window * kp * s, s);
}

// (b) overlap-add: one warp per output row, lanes over the columns of S,
// the K addends summed in order d = 0..K-1. Rows at or past n_rows (the
// ragged last chunk) are not written.
constexpr int kStripRows = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kStripRows)
window_strip_kernel(const T* __restrict__ t, T* __restrict__ y, int n_rows,
                    int s, int nw, int p, int k) {
  const int row = blockIdx.x * kStripRows + threadIdx.y;
  if (row >= n_rows) return;
  const int r_chunk = nw * p;
  const int i = row / r_chunk;
  const int w = (row - i * r_chunk) / p;
  const int r = row - i * r_chunk - w * p;
  for (int col = threadIdx.x; col < s; col += 32) {
    T sum = T(0);
    for (int d = 0; d < k && d <= w; ++d) {
      const size_t win = static_cast<size_t>(i) * nw + (w - d);
      sum += t[(win * k * p + d * p + r) * s + col];
    }
    y[static_cast<size_t>(row) * s + col] = sum;
  }
}

// (d) y = 2 x.
__global__ void double_kernel(const float* __restrict__ x,
                              float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = 2.0f * x[i];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int threads_for(int s_tile) { return 32 * ((s_tile + 31) / 32); }

template <typename T, typename RowId>
int launch_fold(const void* cols, const void* vals, const void* rowid,
                const void* x, void* t, int n_windows, int n_src, int L,
                int R, int kp, int n_cols, int s, int s_tile, void* stream) {
  const size_t smem = fold_smem_bytes<T>(kp, s_tile);
  auto kernel = windowed_fold_kernel<T, RowId>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_windows, (s + s_tile - 1) / s_tile);
  kernel<<<grid, threads_for(s_tile), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const T*>(vals),
      static_cast<const RowId*>(rowid), static_cast<const T*>(x),
      static_cast<T*>(t), n_src, L, R, kp, n_cols, s, s_tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch_products(const void* rid, const void* p, void* out, int nw,
                    int lt, int kp, int s, int s_tile, void* stream) {
  const size_t smem = fold_smem_bytes<float>(kp, s_tile);
  auto kernel = fold_products_kernel<P>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nw, (s + s_tile - 1) / s_tile);
  kernel<<<grid, threads_for(s_tile), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rid), static_cast<const P*>(p),
      static_cast<float*>(out), lt, kp, s, s_tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_strip(const void* t, void* y, int n_rows, int s, int nw, int p,
                 int k, void* stream) {
  const dim3 block(32, kStripRows);
  const dim3 grid((n_rows + kStripRows - 1) / kStripRows);
  window_strip_kernel<T><<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(t), static_cast<T*>(y), n_rows, s, nw, p, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define WINDOWED_FOLD(NAME, T, ROWID)                                        \
  extern "C" int NAME(const void* cols, const void* vals, const void* rowid, \
                      const void* x, void* t, int n_windows, int n_src,      \
                      int L, int R, int kp, int n_cols, int s, int s_tile,   \
                      void* stream) {                                        \
    return launch_fold<T, ROWID>(cols, vals, rowid, x, t, n_windows, n_src,  \
                                 L, R, kp, n_cols, s, s_tile, stream);       \
  }

WINDOWED_FOLD(windowed_fold_f32_u8, float, unsigned char)
WINDOWED_FOLD(windowed_fold_f32_i32, float, int)
WINDOWED_FOLD(windowed_fold_f64_u8, double, unsigned char)
WINDOWED_FOLD(windowed_fold_f64_i32, double, int)

extern "C" int fold_products_bf16(const void* rid, const void* p, void* out,
                                  int nw, int lt, int kp, int s, int s_tile,
                                  void* stream) {
  return launch_products<__nv_bfloat16>(rid, p, out, nw, lt, kp, s, s_tile,
                                        stream);
}

extern "C" int fold_products_f32(const void* rid, const void* p, void* out,
                                 int nw, int lt, int kp, int s, int s_tile,
                                 void* stream) {
  return launch_products<float>(rid, p, out, nw, lt, kp, s, s_tile, stream);
}

extern "C" int window_strip_f32(const void* t, void* y, int n_rows, int s,
                                int nw, int p, int k, void* stream) {
  return launch_strip<float>(t, y, n_rows, s, nw, p, k, stream);
}

extern "C" int window_strip_f64(const void* t, void* y, int n_rows, int s,
                                int nw, int p, int k, void* stream) {
  return launch_strip<double>(t, y, n_rows, s, nw, p, k, stream);
}

extern "C" int double_f32(const void* x, void* y, int n, void* stream) {
  double_kernel<<<(n + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
