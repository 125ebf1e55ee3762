// The ELL and chunked SpMMs, y = A @ x, for the multi-level ELL format
// (core/sparse.py ELLMatrix) and the chunked format (core/chunked.py
// ChunkedELLMatrix); wrappers and plain version in core/ell_kernel.py.
//
// What they replace: XLA compositions, no Pallas kernel.
//   - ell_spmm: pygsp_tpu/core/sparse.py:411-420 (ell_spmm): level 0 a
//     gather-sum of every row's ell_width slots (_slot_block_sum), then
//     each overflow level added to its unique rows with y.at[rows].add.
//   - chunked_spmm: pygsp_tpu/core/chunked.py:206-250
//     (chunked_spmm_chunks): per output chunk the _slot_block_sum of each
//     of its (out, src) blocks, then one y.at[level_rows].add of every
//     overflow tier, in which rows repeat.
//
// The operands, the same for both (core/ell_kernel.py):
//   - the slot table: out chunk i's slot positions [chunk_ptr[i],
//     chunk_ptr[i+1]), each (base, stride, col_base, limit): row lr of the
//     chunk reads the slot base + lr * stride of the flat cols/vals; it is
//     live iff col < limit (the formats' sentinel is limit itself) and then
//     reads x row col_base + col. A chunked block is `width` positions (one
//     per slot column, blocks in ascending source chunk); ELL's level 0 is
//     one block. The matrix's blocks are read where the format keeps them,
//     with no copy, and one launch covers every block of an SpMM.
//   - the overflow levels as one list sorted by output row (the windowed
//     tail's residue list, built by the same code): row r's live slots are
//     [entptr[rowptr[r]], entptr[rowptr[r+1]]), each a global x row and a
//     value, in the order of the format's level_rows; dead slots dropped.
//
// What bounds them: bytes, or the gathers. At the bench graph (N = 2^20,
// 16.8M stored edges, S = 128 f32) each reads its slots' columns and values
// once (ELL 25.1M slots, chunked 29.6M plus the live overflow slots, about
// 0.2-0.3 GB), x once and y once (0.54 GB each): about 0.38 and 0.41 ms at
// 3.35 TB/s. Every live slot gathers a 512-byte x row from anywhere in x
// (16.8M rows, 8.6 GB), so a kernel that finds none of them in L2 takes
// about 2.56 ms (the gather model).
//
// Design: each output row has one owner, which writes it once; there are
// no atomics, and two launches are bit-equal.
//   - Row blocks: a group of lanes per row, each lane owning 16-byte
//     pieces of it (float4, double2, eight bf16) or one value where the
//     row is not whole 16-byte pieces. From 8 pieces a row up (an f32 or
//     bf16 row of 64 columns and more) the group is a whole warp, whose
//     lanes read 32 of the row's positions at once (table entry, column,
//     value: one a lane), keep the live ones by a ballot and hand them
//     round by shuffles, loading kSlots x pieces at a time; then the
//     row's overflow slots the same way. A chunked row walks about 190
//     positions, mostly dead padding of its 16 blocks: read one at a time,
//     each a column load before its x row, they held a first build at
//     7.0 ms per SpMM on the bench graph. Narrower rows take fewer lanes,
//     each of which walks the positions kSlots at a time. Either way the
//     products are added in position order, then the overflow slots in
//     order: the two paths give the same sums. The products are formed in
//     the promotion of x's and the values' types (bf16 * bf16 rounds to
//     bf16, __hmul) and summed in f32 (f64 for f64), each product and sum
//     rounded once (__fmul_rn, __fadd_rn), the row rounded once to x's
//     type at the store.
//   - Heavy rows: a row with kHeavySlots (256) live overflow slots or
//     more (the hub rows of a power-law graph: 6616 edges at most on the
//     bench graph) is left by the row blocks to a block of its own, placed
//     first in the grid, the longest rows first (the wrapper's heavy
//     list). The block cuts the row's positions and overflow slots into
//     units of kUnit slots; worker w (a group of lanes) sums units w, w +
//     W, ... in order into its own sums, and after a barrier the thread
//     that owns a column adds the W workers' sums in worker order. The
//     order is fixed by the data and the block size alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kSlots = 8;          // slots whose x pieces a lane loads together
constexpr int kHeavySlots = 256;   // overflow slots that make a row heavy:
                                   // the wrapper's HEAVY_SLOTS, by which the
                                   // upload lists the heavy rows
constexpr int kUnit = 32;          // slots per unit of a heavy row's block
constexpr int kThreads = 32 * kWarps;

// The type sums are taken in: float, or double for double operands.
template <typename T>
struct SumOf {
  using type = float;
};
template <>
struct SumOf<double> {
  using type = double;
};

// The bits of E values of T taken in one access: 16 bytes, or one value.
template <typename T, int E>
struct Bits {
  using type = uint4;
};
template <>
struct Bits<float, 1> {
  using type = unsigned;
};
template <>
struct Bits<double, 1> {
  using type = unsigned long long;
};
template <>
struct Bits<__nv_bfloat16, 1> {
  using type = unsigned short;
};

// The E values of T in `b`, widened to the sums' type A.
template <typename T, int E, typename A>
__device__ __forceinline__ void unpack(const typename Bits<T, E>::type& b,
                                       A (&a)[E]) {
  if constexpr (E == 1) {
    if constexpr (sizeof(T) == 2)
      a[0] = __uint_as_float(static_cast<unsigned>(b) << 16);
    else if constexpr (sizeof(T) == 4)
      a[0] = __uint_as_float(b);
    else
      a[0] = __longlong_as_double(static_cast<long long>(b));
  } else {
    const unsigned w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if constexpr (sizeof(T) == 2) {
        a[2 * m] = __uint_as_float(w[m] << 16);
        a[2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
      } else if constexpr (sizeof(T) == 4) {
        a[m] = __uint_as_float(w[m]);
      } else if (m < 2) {
        a[m] = __hiloint2double(static_cast<int>(w[2 * m + 1]),
                                static_cast<int>(w[2 * m]));
      }
    }
  }
}

__device__ __forceinline__ unsigned bf16_word(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The bits of E values of T, from sums of type A (rounded to T once).
template <typename T, int E, typename A>
__device__ __forceinline__ typename Bits<T, E>::type pack(const A (&a)[E]) {
  if constexpr (E == 1) {
    if constexpr (sizeof(T) == 2)
      return static_cast<unsigned short>(bf16_word(a[0]));
    else if constexpr (sizeof(T) == 4)
      return __float_as_uint(a[0]);
    else
      return static_cast<unsigned long long>(__double_as_longlong(a[0]));
  } else {
    unsigned w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if constexpr (sizeof(T) == 2)
        w[m] = bf16_word(a[2 * m]) | bf16_word(a[2 * m + 1]) << 16;
      else if constexpr (sizeof(T) == 4)
        w[m] = __float_as_uint(a[m]);
      else
        w[m] = static_cast<unsigned>(m % 2 ? __double2hiint(a[m / 2])
                                           : __double2loint(a[m / 2]));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// The bf16 value that a float widened from bf16 holds (its upper 16 bits).
__device__ __forceinline__ __nv_bfloat16 as_bf16(float v) {
  return __ushort_as_bfloat16(
      static_cast<unsigned short>(__float_as_uint(v) >> 16));
}

// A slot's product in the promotion of x's type X and the values' type V
// (bf16 when both are), widened to the sums' type.
template <typename X, typename V, typename A>
__device__ __forceinline__ A product(A xv, A vv) {
  if constexpr (sizeof(X) == 2 && sizeof(V) == 2)
    return __bfloat162float(__hmul(as_bf16(xv), as_bf16(vv)));
  else if constexpr (sizeof(A) == 8)
    return __dmul_rn(xv, vv);
  else
    return __fmul_rn(xv, vv);
}

template <typename V, typename A>
__device__ __forceinline__ A load_val(const V* p) {
  if constexpr (sizeof(V) == 2)
    return __uint_as_float(
        static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
        << 16);
  else
    return static_cast<A>(__ldg(p));
}

template <typename T, typename V>
struct Args {
  const int* chunk_ptr;   // (n_out + 1): each out chunk's positions
  const long long* pos;   // (n_pos, 4): base, stride, col_base, limit
  const int* cols;        // the flat slot arrays
  const V* vals;
  const int* rowptr;      // (n_rows + 1): each row's overflow entries; or null
  const int* entptr;      // (entries + 1): each entry's slots
  const int* rcols;       // per overflow slot: its row of x
  const V* rvals;         // per overflow slot: its value
  const int* heavy;       // the rows with at least kHeavySlots overflow slots
  const T* x;             // (n_cols, s)
  T* y;                   // (n_rows, s)
  int n_rows, s, chunk_rows, n_heavy;
  int group;              // lanes per row (a power of two up to 32)
};

// Where row `row` starts and ends in the table and in the overflow list.
struct RowSpan {
  long long lr;   // the row inside its out chunk
  int k0, k1;     // its positions
  int q0, q1;     // its overflow slots
};

template <typename T, typename V>
__device__ __forceinline__ RowSpan row_span(const Args<T, V>& a, int row) {
  RowSpan r;
  const int i = row / a.chunk_rows;
  r.lr = row - static_cast<long long>(i) * a.chunk_rows;
  r.k0 = __ldg(a.chunk_ptr + i);
  r.k1 = __ldg(a.chunk_ptr + i + 1);
  r.q0 = r.q1 = 0;
  if (a.rowptr != nullptr) {
    r.q0 = __ldg(a.entptr + __ldg(a.rowptr + row));
    r.q1 = __ldg(a.entptr + __ldg(a.rowptr + row + 1));
  }
  return r;
}

// sum += the products of positions [k0, k1) of row lr, piece v (columns
// v * E ..), in position order; dead slots add nothing and read no x.
template <typename T, typename V, int E, typename A>
__device__ __forceinline__ void add_positions(const Args<T, V>& a, int k0,
                                              int k1, long long lr, int v,
                                              A (&sum)[E]) {
  using B = typename Bits<T, E>::type;
  for (int k = k0; k < k1; k += kSlots) {
    long long xr[kSlots];
    A val[kSlots];
    bool live[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      live[j] = false;
      if (k + j < k1) {
        const longlong2* p = reinterpret_cast<const longlong2*>(a.pos) +
                             2 * static_cast<size_t>(k + j);
        const longlong2 bs = __ldg(p), cl = __ldg(p + 1);
        const long long q = bs.x + lr * bs.y;
        const int c = __ldg(a.cols + q);
        live[j] = c < cl.y;
        xr[j] = cl.x + c;
        val[j] = load_val<V, A>(a.vals + q);
      }
    }
    B xb[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (live[j])
        xb[j] = __ldg(reinterpret_cast<const B*>(
            a.x + xr[j] * a.s + static_cast<size_t>(v) * E));
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (!live[j]) continue;
      A xv[E];
      unpack<T, E>(xb[j], xv);
#pragma unroll
      for (int m = 0; m < E; ++m)
        sum[m] = add_rn(sum[m], product<T, V>(xv[m], val[j]));
    }
  }
}

// sum += the products of overflow slots [q0, q1), piece v, in slot order.
template <typename T, typename V, int E, typename A>
__device__ __forceinline__ void add_overflow(const Args<T, V>& a, int q0,
                                             int q1, int v, A (&sum)[E]) {
  using B = typename Bits<T, E>::type;
  for (int q = q0; q < q1; q += kSlots) {
    int c[kSlots];
    A val[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (q + j < q1) {
        c[j] = __ldg(a.rcols + q + j);
        val[j] = load_val<V, A>(a.rvals + q + j);
      }
    B xb[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (q + j < q1)
        xb[j] = __ldg(reinterpret_cast<const B*>(
            a.x + static_cast<size_t>(c[j]) * a.s + static_cast<size_t>(v) * E));
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (q + j >= q1) break;
      A xv[E];
      unpack<T, E>(xb[j], xv);
#pragma unroll
      for (int m = 0; m < E; ++m)
        sum[m] = add_rn(sum[m], product<T, V>(xv[m], val[j]));
    }
  }
}

constexpr unsigned kFull = 0xffffffffu;

// sum += the products of the live slots whose (x row, value) lane j of the
// warp holds for each set bit j of `live` (a warp-uniform mask), in
// ascending j, kSlots x pieces in flight; piece v of each x row, read only
// by the lanes with `act`.
template <typename T, typename V, int E, typename A>
__device__ __forceinline__ void add_warp_slots(const Args<T, V>& a,
                                               unsigned live, long long xr,
                                               A val, int v, bool act,
                                               A (&sum)[E]) {
  using B = typename Bits<T, E>::type;
  while (live) {
    long long r[kSlots];
    A w[kSlots];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int src = live ? __ffs(live) - 1 : 0;
      if (live) {
        live &= live - 1;
        cnt = j + 1;
      }
      r[j] = __shfl_sync(kFull, xr, src);
      w[j] = __shfl_sync(kFull, val, src);
    }
    if (!act) continue;
    B xb[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (j < cnt)
        xb[j] = __ldg(reinterpret_cast<const B*>(
            a.x + r[j] * a.s + static_cast<size_t>(v) * E));
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (j >= cnt) break;
      A xv[E];
      unpack<T, E>(xb[j], xv);
#pragma unroll
      for (int m = 0; m < E; ++m)
        sum[m] = add_rn(sum[m], product<T, V>(xv[m], w[j]));
    }
  }
}

// One row by a whole warp (a.group == 32), lane l owning pieces l, l + 32,
// ...: 32 of the row's positions, then 32 of its overflow slots, are read at
// once, one a lane (table entry, column, value); a ballot keeps the live
// ones, whose x pieces are then loaded kSlots at a time and added in order.
// The sums are the same, in the same order, as spmm_rows's; the row's
// dependent loads come 32 slots at a time instead of kSlots.
template <typename T, typename V, int E>
__device__ __forceinline__ void spmm_row_warp(const Args<T, V>& a,
                                              int row) {
  using A = typename SumOf<T>::type;
  using B = typename Bits<T, E>::type;
  const int lane = threadIdx.x & 31;
  const RowSpan r = row_span(a, row);
  if (r.q1 - r.q0 >= kHeavySlots) return;
  const int nvec = a.s / E;
  for (int vb = 0; vb < nvec; vb += 32) {
    const int v = vb + lane;
    const bool act = v < nvec;
    A sum[E];
#pragma unroll
    for (int m = 0; m < E; ++m) sum[m] = A(0);
    for (int kb = r.k0; kb < r.k1; kb += 32) {
      long long xr = 0;
      A val = A(0);
      bool live = false;
      if (kb + lane < r.k1) {
        const longlong2* p = reinterpret_cast<const longlong2*>(a.pos) +
                             2 * static_cast<size_t>(kb + lane);
        const longlong2 bs = __ldg(p), cl = __ldg(p + 1);
        const long long q = bs.x + r.lr * bs.y;
        const int c = __ldg(a.cols + q);
        live = c < cl.y;
        xr = cl.x + c;
        val = load_val<V, A>(a.vals + q);
      }
      add_warp_slots<T, V, E>(a, __ballot_sync(kFull, live), xr, val, v,
                              act, sum);
    }
    for (int qb = r.q0; qb < r.q1; qb += 32) {
      const bool have = qb + lane < r.q1;
      const long long xr = have ? __ldg(a.rcols + qb + lane) : 0;
      const A val = have ? load_val<V, A>(a.rvals + qb + lane) : A(0);
      add_warp_slots<T, V, E>(a, __ballot_sync(kFull, have), xr, val, v,
                              act, sum);
    }
    if (act)
      *reinterpret_cast<B*>(a.y + static_cast<size_t>(row) * a.s +
                            static_cast<size_t>(v) * E) = pack<T, E>(sum);
  }
}

// The rows of row block `block`, a group of a.group lanes per row (a warp
// per row when a.group is 32); a row with kHeavySlots overflow slots or
// more is left to its heavy block.
template <typename T, typename V, int E>
__device__ __forceinline__ void spmm_rows(const Args<T, V>& a, int block) {
  using A = typename SumOf<T>::type;
  using B = typename Bits<T, E>::type;
  const int sub = threadIdx.x / a.group, gl = threadIdx.x - sub * a.group;
  const long long row =
      static_cast<long long>(block) * (kThreads / a.group) + sub;
  if (row >= a.n_rows) return;   // warp-uniform when a.group is 32
  if (a.group == 32) {
    spmm_row_warp<T, V, E>(a, static_cast<int>(row));
    return;
  }
  const RowSpan r = row_span(a, static_cast<int>(row));
  if (r.q1 - r.q0 >= kHeavySlots) return;
  const int nvec = a.s / E;
  for (int v = gl; v < nvec; v += a.group) {
    A sum[E];
#pragma unroll
    for (int m = 0; m < E; ++m) sum[m] = A(0);
    add_positions<T, V, E>(a, r.k0, r.k1, r.lr, v, sum);
    add_overflow<T, V, E>(a, r.q0, r.q1, v, sum);
    *reinterpret_cast<B*>(a.y + row * a.s + static_cast<size_t>(v) * E) =
        pack<T, E>(sum);
  }
}

// One heavy row by the whole block: its positions and overflow slots cut
// into units of kUnit; worker w (a group of a.group lanes, one piece a
// lane) sums units w, w + W, ... in order, and the workers' sums are added
// in worker order by the thread that owns a column.
template <typename T, typename V, int E>
__device__ __forceinline__ void spmm_heavy(const Args<T, V>& a, int row) {
  using A = typename SumOf<T>::type;
  __shared__ A part[kThreads * E];   // (W, a.group * E)
  const int workers = kThreads / a.group;
  const int wk = threadIdx.x / a.group, gl = threadIdx.x - wk * a.group;
  const RowSpan r = row_span(a, row);
  const int n_main = (r.k1 - r.k0 + kUnit - 1) / kUnit;
  const int n_units = n_main + (r.q1 - r.q0 + kUnit - 1) / kUnit;
  const int nvec = a.s / E;
  const int piece = a.group * E;
  for (int vb = 0; vb < nvec; vb += a.group) {
    const int v = vb + gl;
    A sum[E];
#pragma unroll
    for (int m = 0; m < E; ++m) sum[m] = A(0);
    if (v < nvec) {
      for (int u = wk; u < n_units; u += workers) {
        if (u < n_main) {
          const int k = r.k0 + u * kUnit;
          add_positions<T, V, E>(a, k, min(k + kUnit, r.k1), r.lr, v, sum);
        } else {
          const int q = r.q0 + (u - n_main) * kUnit;
          add_overflow<T, V, E>(a, q, min(q + kUnit, r.q1), v, sum);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < E; ++m) part[wk * piece + gl * E + m] = sum[m];
    __syncthreads();
    const int width = min(a.group, nvec - vb) * E;
    for (int c = threadIdx.x; c < width; c += kThreads) {
      A t = A(0);
      for (int w = 0; w < workers; ++w) t = add_rn(t, part[w * piece + c]);
      const A one[1] = {t};
      *reinterpret_cast<typename Bits<T, 1>::type*>(
          a.y + static_cast<size_t>(row) * a.s + static_cast<size_t>(vb) * E +
          c) = pack<T, 1>(one);
    }
    __syncthreads();
  }
}

// Blocks [0, n_heavy) take one heavy row each, the longest first; the
// others kThreads / group rows each. `vec`: 16-byte pieces (s a multiple
// of a piece, x and y 16-byte aligned), else one value a lane. Three blocks
// an SM (80 registers, a few hundred bytes of spill): the gathers want
// warps in flight. With two (128 registers, no spill) the f32 SpMM at the
// bench graph took 3.254 ms (ELL) and 3.670 (chunked), with three 3.014
// and 3.288, with four (64 registers, up to 948 bytes of spill) 4.434 and
// 4.989 (NVIDIA H100 80GB HBM3 at 700 W, tools/slot_variants.py on copies).
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads, 3)
slot_spmm_kernel(const Args<T, V> a, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int b = static_cast<int>(blockIdx.x);
  if (b < a.n_heavy) {
    const int row = __ldg(a.heavy + b);
    if (vec)
      spmm_heavy<T, V, kVec>(a, row);
    else
      spmm_heavy<T, V, 1>(a, row);
  } else if (vec) {
    spmm_rows<T, V, kVec>(a, b - a.n_heavy);
  } else {
    spmm_rows<T, V, 1>(a, b - a.n_heavy);
  }
}

template <typename T, typename V>
int launch_slot_spmm(const void* chunk_ptr, const void* pos, const void* cols,
                     const void* vals, const void* rowptr, const void* entptr,
                     const void* rcols, const void* rvals, const void* heavy,
                     const void* x, void* y, int n_rows, int s,
                     int chunk_rows, int n_heavy, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (n_rows < 1 || s < 1 || chunk_rows < 1 || n_heavy < 0 ||
      (n_heavy > 0 && rowptr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* q) {
    return reinterpret_cast<size_t>(q) % 16 == 0;
  };
  const int vec = s % kVec == 0 && aligned(x) && aligned(y);
  const int nvec = vec ? s / kVec : s;
  // a warp per row from 8 pieces a row up (the warp's lanes read the row's
  // slots together), else the fewest lanes that cover a row
  int group = 1;
  while (group < 32 && group < nvec) group *= 2;
  if (nvec >= 8) group = 32;
  const long long rows_per_block = kThreads / group;
  const long long blocks =
      n_heavy + (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const Args<T, V> a{
      static_cast<const int*>(chunk_ptr), static_cast<const long long*>(pos),
      static_cast<const int*>(cols),      static_cast<const V*>(vals),
      static_cast<const int*>(rowptr),    static_cast<const int*>(entptr),
      static_cast<const int*>(rcols),     static_cast<const V*>(rvals),
      static_cast<const int*>(heavy),     static_cast<const T*>(x),
      static_cast<T*>(y), n_rows, s, chunk_rows, n_heavy, group};
  slot_spmm_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One instance per (x type, values type) that the wrappers' _ELL_TYPES and
// _CHUNKED_TYPES name; y has x's type.
#define SLOT_SPMM(NAME, T, V)                                                \
  extern "C" int NAME(const void* chunk_ptr, const void* pos,                \
                      const void* cols, const void* vals,                    \
                      const void* rowptr, const void* entptr,                \
                      const void* rcols, const void* rvals,                  \
                      const void* heavy, const void* x, void* y, int n_rows, \
                      int s, int chunk_rows, int n_heavy, void* stream) {    \
    return launch_slot_spmm<T, V>(chunk_ptr, pos, cols, vals, rowptr,        \
                                  entptr, rcols, rvals, heavy, x, y, n_rows, \
                                  s, chunk_rows, n_heavy, stream);           \
  }

SLOT_SPMM(ell_spmm_f32, float, float)
SLOT_SPMM(ell_spmm_f64, double, double)
SLOT_SPMM(chunked_spmm_f32, float, float)
SLOT_SPMM(chunked_spmm_f64, double, double)
SLOT_SPMM(chunked_spmm_bf16_f32, __nv_bfloat16, float)
SLOT_SPMM(chunked_spmm_bf16, __nv_bfloat16, __nv_bfloat16)
SLOT_SPMM(chunked_spmm_f32_bf16, float, __nv_bfloat16)
