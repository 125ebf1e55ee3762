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
// it stands, and at NW = 1 TPU kernel #3 (benchmarks/pallas_smoke.py
// fold_kernel, pallas_call at line 52); (d) double is TPU kernel #4
// (pallas_smoke.py dbl_kernel, line 28), the toolchain canary.
//
// What bounds (a) on this card: gathers. Each live slot pulls one row of x
// (S values, 512 bytes at S = 128 in f32) from anywhere in x, and x (0.5 GB
// at the bench graph) does not stay in the 50 MB L2 cache, so the least
// time is one row per live slot at the memory rate (the gather model,
// 2.87 ms at the bench path), not x read once (0.53 ms).
//
// Design of (a): one block per (window, S tile), split into two roles that
// meet at mbarriers in shared memory (full: a ring part is ready; empty: it
// was folded), kGroups parts ahead:
//   - two producer warps. Warp 0 stages the window's slot triples, 128 at a
//     time and one round ahead in registers; dead slots (sentinel or
//     out-of-range column, row id outside [0, K*P)) are dropped with a warp
//     ballot, keeping slot order, and the live ones queued as (row offset,
//     value) pairs with their x row. It publishes the queue a part at a time
//     (the part's live-slot count, -1 when the window is done); where rows
//     are whole 16-byte units (S * itemsize % 16 == 0, x 16-byte aligned)
//     both warps copy the part's x rows into the ring with TMA bulk copies
//     (cp.async.bulk, one per row, alternate rows each), counted on the
//     part's full barrier. So x is never read for a dead slot, and no
//     folding thread spends an instruction on a copy;
//   - one folding thread per column of the S tile (up to 4 warps). Thread s
//     owns column s of the (K*P, S_tile) accumulator in shared memory, so
//     no two threads touch one word, no atomics are needed, and each row
//     sums in slot order: two launches give bit-equal t. It reads each
//     slot's (offset, value) as one 8-byte (16 in f64) word and the row
//     from the ring, or, for other widths, from x itself.
// The wrapper (core/windowed_kernel.py:fold_layout) chooses S_tile, the
// ring depth and the queue length under the shared-memory budget and
// passes them; the kernel sizes its shared memory from them
// (fold_smem_bytes, exported as windowed_fold_smem_bytes_f32/_f64 so that
// a card test holds the wrapper's byte count to it). At the bench path
// (f32, K*P = 128, S = 128) that is a 64 KB accumulator, a 64-row (32 KB)
// ring and a 256-slot queue, 101,536 bytes: two blocks per SM.
// Why this shape: a fold in which every thread copies its own column
// (4-byte cp.async) or gathers it with plain loads (the first port) spends
// its time issuing the copies, not waiting for them: the load/store unit
// holds only so many requests per warp, so its time follows the warps per
// SM, and the accumulator's 64 KB allows two blocks of four warps. TMA
// takes the rows off that path; issued by one thread behind a block barrier
// per part it is slower still, so the copies go to producer warps of their
// own, two of them because a warp issues its lanes' TMA requests one after
// another, and the folding threads read one word per slot where they read
// two. What binds now is the producers' TMA issue and the folding threads'
// shared-memory traffic, about equally. At the bench path: 4.56 ms on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), against 7.31 ms for the
// first port. Registers (nvcc -Xptxas -v, sm_90a): 56 in f32 with 8 bytes
// of spill, 80 in f64 with none.
//
// (c) keeps the design of the first port: the same accumulator, slots
// staged 512 at a time with dead ones marked, and kUnroll plain gathers in
// flight per thread; its bf16 products are 2 bytes, below the smallest
// copy. (b) and (c) stream their input and output once. The accumulators
// sum in the input type (f32 or f64; f32 for the products), as the JAX fold
// does for those inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// (a) windowed_fold
// ---------------------------------------------------------------------------

constexpr int kGroups = 8;            // ring parts, each with a full and an
                                      // empty mbarrier
constexpr int kProducers = 2;         // producer warps
constexpr int kStageK = 4;            // raw slots per producer lane per round
constexpr int kRound = 32 * kStageK;  // raw slots per staging round
constexpr int kFoldUnroll = 8;

// A queued live slot: the offset of its accumulator row (row id * S_tile)
// and its value, read by a consumer in one 8- or 16-byte access.
template <typename T>
struct alignas(2 * sizeof(T)) Slot {
  int off;
  T val;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the producer warps' barrier (named barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * kProducers) : "memory");
}

// Shared-memory bytes of a fold block: the full and empty mbarriers and the
// count of each ring part (20 bytes a part), the accumulator, the ring and
// the queue (a Slot of 2 * sizeof(T) and its x row, an int, per entry).
// fold_layout in the wrapper budgets the same sum.
template <typename T>
size_t fold_smem_bytes(int kp, int s_tile, int ring, int queue) {
  return 2 * kGroups * sizeof(unsigned long long) + kGroups * sizeof(int) +
         (static_cast<size_t>(kp) + ring) * s_tile * sizeof(T) +
         static_cast<size_t>(queue) * (sizeof(Slot<T>) + sizeof(int));
}

template <typename T, typename RowId>
__global__ void __launch_bounds__(128 + 32 * kProducers)
windowed_fold_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                     const RowId* __restrict__ rowid, const T* __restrict__ x,
                     T* __restrict__ t, int n_src, int L, int R, int kp,
                     int n_cols, int s, int s_tile, int ring, int queue,
                     int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* full = reinterpret_cast<unsigned long long*>(smem);   // kGroups
  unsigned long long* empty = full + kGroups;                 // kGroups
  int* count = reinterpret_cast<int*>(empty + kGroups);       // kGroups
  T* acc = reinterpret_cast<T*>(count + kGroups);             // (kp, s_tile)
  T* rows = acc + static_cast<size_t>(kp) * s_tile;           // (ring, s_tile)
  auto* q_slot = reinterpret_cast<Slot<T>*>(rows + static_cast<size_t>(ring) *
                                                       s_tile);
  int* q_row = reinterpret_cast<int*>(q_slot + queue);  // x row of the slot

  const int consumers = blockDim.x - 32 * kProducers;
  const int tid = threadIdx.x, lane = tid & 31;
  const int s0 = blockIdx.y * s_tile;
  const int part = ring / kGroups;  // rows per ring part
  const int q_mask = queue - 1;     // queue >= ring + kRound, a power of 2

  if (tid == 0) {
    for (int k = 0; k < kGroups; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int col = s0 + tid;
  const bool active = tid < consumers && tid < s_tile && col < s;
  if (active)
    for (int r = 0; r < kp; ++r) acc[r * s_tile + tid] = T(0);
  __syncthreads();

  if (tid >= consumers) {
    // Producers. Warp 0 stages the window's live slots into the queue in
    // slot order and publishes them a part at a time, kGroups parts ahead
    // of the fold: the part's slot count, and on the bulk route its x rows,
    // which both producer warps copy into the ring, alternating rows.
    const int w = (tid - consumers) >> 5;
    const unsigned row_bytes = min(s_tile, s - s0) * sizeof(T);
    const int n_slots = n_src * L;
    const size_t base = static_cast<size_t>(blockIdx.x) * n_slots;
    int pre_col[kStageK], pre_rid[kStageK];
    T pre_val[kStageK];
    auto load_round = [&](int j0) {  // raw slots of a round, one round ahead
#pragma unroll
      for (int k = 0; k < kStageK; ++k) {
        const int j = j0 + k * 32 + lane;
        pre_col[k] = -1;
        if (j < n_slots) {
          pre_col[k] = cols[base + j];
          pre_rid[k] = static_cast<int>(rowid[base + j]);
          pre_val[k] = vals[base + j];
        }
      }
    };
    int staged = 0, queued = 0;  // raw slots examined, live slots queued
    // Append the live slots of the round loaded last, in slot order, to
    // the queue (a warp ballot compacts them), and load the next round.
    auto stage = [&]() {
      int c_[kStageK], r_[kStageK];
      T v_[kStageK];
#pragma unroll
      for (int k = 0; k < kStageK; ++k) {
        c_[k] = pre_col[k];
        r_[k] = pre_rid[k];
        v_[k] = pre_val[k];
      }
      const int j0 = staged;
      if (j0 + kRound < n_slots) load_round(j0 + kRound);
#pragma unroll
      for (int k = 0; k < kStageK; ++k) {
        const int j = j0 + k * 32 + lane;
        const int g = (j / L) * R + c_[k];  // c_ == R: sentinel
        const bool live = j < n_slots && c_[k] >= 0 && c_[k] < R &&
                          g < n_cols && r_[k] >= 0 && r_[k] < kp;
        const unsigned m = __ballot_sync(0xffffffffu, live);
        if (live) {
          const int e = (queued + __popc(m & ((1u << lane) - 1u))) & q_mask;
          q_slot[e] = Slot<T>{r_[k] * s_tile, v_[k]};
          q_row[e] = g;
        }
        queued += __popc(m);
      }
      __syncwarp();
      staged = j0 + kRound;
    };
    if (w == 0) load_round(0);
    for (int q = 0;; ++q) {
      const int k = q % kGroups;
      if (w == 0) {
        if (q >= kGroups) mbar_wait(&empty[k], (q / kGroups - 1) & 1);
        const int end = (q + 1) * part;
        while (queued < end && staged < n_slots) stage();
        const int n = min(end, queued) - q * part;
        if (lane == 0) {
          count[k] = n > 0 ? n : -1;  // -1: the window is done
          mbar_arrive_expect_tx(&full[k], bulk && n > 0 ? n * row_bytes : 0);
        }
      }
      producers_sync();  // the part's count and queue entries are written
      const int n = count[k];
      if (n < 0) break;
      if (bulk)
        for (int i = kProducers * lane + w; i < n; i += 32 * kProducers)
          bulk_copy(rows + static_cast<size_t>(k * part + i) * s_tile,
                    x + static_cast<size_t>(q_row[(q * part + i) & q_mask]) *
                            s + s0,
                    row_bytes, &full[k]);
    }
    return;
  }

  // Consumers: thread tid folds column s0 + tid of every published part in
  // slot order, reading the rows from the ring (bulk) or from x.
  for (int q = 0;; ++q) {
    const int k = q % kGroups;
    mbar_wait(&full[k], (q / kGroups) & 1);
    const int n = count[k];
    if (n < 0) break;
    if (active) {
      const int lo = q * part;
      const T* src = rows + static_cast<size_t>(k) * part * s_tile + tid;
      for (int g = 0; g < n; g += kFoldUnroll) {
        T v[kFoldUnroll], p[kFoldUnroll];
        int off[kFoldUnroll];
#pragma unroll
        for (int u = 0; u < kFoldUnroll; ++u) {
          if (g + u < n) {
            const int e = (lo + g + u) & q_mask;
            const Slot<T> slot = q_slot[e];
            off[u] = slot.off;
            v[u] = slot.val;
            p[u] = bulk ? src[(g + u) * s_tile]
                        : x[static_cast<size_t>(q_row[e]) * s + col];
          }
        }
#pragma unroll
        for (int u = 0; u < kFoldUnroll; ++u)
          if (g + u < n) acc[off[u] + tid] += v[u] * p[u];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[k]);
  }
  if (!active) return;
  T* out = t + static_cast<size_t>(blockIdx.x) * kp * s + col;
  for (int r = 0; r < kp; ++r)
    out[static_cast<size_t>(r) * s] = acc[r * s_tile + tid];
}

// ---------------------------------------------------------------------------
// (c) fold_products
// ---------------------------------------------------------------------------

constexpr int kBatch = 512;  // slot triples staged in shared memory at once
constexpr int kUnroll = 8;   // gathers in flight per thread

// Shared-memory bytes of a products block: the accumulator plus the staged
// batch (value, source row, row id).
template <typename TAcc>
size_t products_smem_bytes(int kp, int s_tile) {
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

// ---------------------------------------------------------------------------
// (b) window_strip, (d) double
// ---------------------------------------------------------------------------

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
                int R, int kp, int n_cols, int s, int s_tile, int ring,
                int queue, void* stream) {
  // the kernel's contract with fold_layout: at most 128 folding threads,
  // whole ring parts, and a queue that outlasts the ring plus one staging
  // round; a block that asks for more shared memory than the card has
  // fails in allow_smem
  if (s_tile < 1 || s_tile > 128 || ring < kGroups || ring % kGroups ||
      queue < ring + kRound || (queue & (queue - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fold_smem_bytes<T>(kp, s_tile, ring, queue);
  // bulk copies need 16-byte-aligned rows of whole 16-byte units
  const int bulk = reinterpret_cast<size_t>(x) % 16 == 0 &&
                   s * sizeof(T) % 16 == 0 && s_tile * sizeof(T) % 16 == 0;
  auto kernel = windowed_fold_kernel<T, RowId>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_windows, (s + s_tile - 1) / s_tile);
  kernel<<<grid, threads_for(s_tile) + 32 * kProducers, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const T*>(vals),
      static_cast<const RowId*>(rowid), static_cast<const T*>(x),
      static_cast<T*>(t), n_src, L, R, kp, n_cols, s, s_tile, ring, queue,
      bulk);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch_products(const void* rid, const void* p, void* out, int nw,
                    int lt, int kp, int s, int s_tile, void* stream) {
  const size_t smem = products_smem_bytes<float>(kp, s_tile);
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
                      int ring, int queue, void* stream) {                   \
    return launch_fold<T, ROWID>(cols, vals, rowid, x, t, n_windows, n_src,  \
                                 L, R, kp, n_cols, s, s_tile, ring, queue,   \
                                 stream);                                    \
  }

WINDOWED_FOLD(windowed_fold_f32_u8, float, unsigned char)
WINDOWED_FOLD(windowed_fold_f32_i32, float, int)
WINDOWED_FOLD(windowed_fold_f64_u8, double, unsigned char)
WINDOWED_FOLD(windowed_fold_f64_i32, double, int)

extern "C" int windowed_fold_smem_bytes_f32(int kp, int s_tile, int ring,
                                            int queue) {
  return static_cast<int>(fold_smem_bytes<float>(kp, s_tile, ring, queue));
}

extern "C" int windowed_fold_smem_bytes_f64(int kp, int s_tile, int ring,
                                            int queue) {
  return static_cast<int>(fold_smem_bytes<double>(kp, s_tile, ring, queue));
}

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
