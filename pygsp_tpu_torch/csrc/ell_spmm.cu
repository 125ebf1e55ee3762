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
// Design of the wide entry (slot_wide_kernel: ell_spmm_f32/_f64 and
// chunked_spmm_<pair> above SLOT_NARROW_WIDTH), redesigned for Hopper
// after its first build: each output row has one owner, which writes it
// once; there are no atomics, and two launches are bit-equal.
//   - Row groups: G = 8, 16 or 32 lanes a row, the fewest that cover the
//     row's 16-byte pieces (float4, double2, eight bf16; G = 32 with one
//     value a lane where S is not whole pieces or x or y is unaligned), so
//     32 / G rows share a warp: at 128 bf16 columns two rows a warp, no
//     lane idle in a gather (a whole warp a row idles half its lanes
//     there). Past 32 pieces a group
//     walks its row once for each 32 (512 f32 columns: four passes), the
//     row's first slots kept in registers across the passes.
//   - A group reads its row's first 32 positions (table entry, column,
//     value, 32 / G a lane) and its first 32 overflow slots together,
//     before any gather; ballots keep the live ones, shuffles hand them
//     round, and a lane loads their x pieces in rounds of
//     Wide<T, G>::kSlots. The products are added in position order, then
//     the overflow slots in order. They are formed in the promotion of x's
//     and the values' types (bf16 * bf16 rounds to bf16, __hmul) and summed
//     in f32 (f64 for f64), each product and sum rounded once (__fmul_rn,
//     __fadd_rn), the row rounded once to x's type at the store: the sums
//     of the heavy blocks' and of the narrow entry's walks, in the same
//     order.
//   - What binds: the gathers. A build with the x loads taken out ran the
//     metadata alone in 0.65 ms (ELL) and 0.70 (chunked) of 2.93 and 3.04
//     at 128 f32 columns; the card gathers at about 3.0 TB/s (kernel A's
//     wide entry 2.85 ms, a device copy 3.03 TB/s). So the kernel wants
//     the most gathers in flight an SM without spill (Wide<T, G>): five
//     blocks an SM of three slots a round with f32 x at 32 lanes a row,
//     four of four otherwise, beat three blocks of eight (80 registers, up
//     to 472 bytes of spill) by 4-20 %. Measured and dropped
//     (tools/slot_variants.py, NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md):
//     loading the next row's positions during this row's gathers (four
//     and eight rows a warp were slower than one), rounds that run on from
//     the positions into the overflow slots (more registers, slower in
//     bf16), twelve or sixteen slots a round, and the narrow entry's walk
//     at 128 columns (ELL 2.86 ms, chunked 4.17).
//   - Heavy rows: a row with kHeavySlots (256) live overflow slots or
//     more (the hub rows of a power-law graph: 6616 edges at most on the
//     bench graph) is skipped by the row groups and summed by a block of
//     its own (slot_heavy_kernel), launched on a side stream beside the
//     row kernel, the longest rows first (the wrapper's heavy list), so
//     the heavy code sets no register count of the row kernel. The block
//     cuts the row's positions and overflow slots into units of kUnit
//     slots; worker w (a group of lanes) sums units w, w + W, ... in order
//     into its own sums, and after a barrier the thread that owns a column
//     adds the W workers' sums in worker order. The order is fixed by the
//     data and the block size alone (slot_args' lanes a row: a warp from 8
//     pieces up, whatever G the row kernel takes).
//   - Rows under 8 pieces (bf16 under 64 columns): slot_rows_kernel, each
//     of the fewest lanes that cover a row walking the positions kSlots at
//     a time, its grid led by the heavy rows' blocks.
//
// The narrow entry (slot_narrow_kernel: ell_spmm_narrow_f32/_f64 and
// chunked_spmm_narrow_<pair>), which core/ell_kernel.py takes up to
// SLOT_NARROW_WIDTH columns (32 f32 and f64, 1 with bf16 x). It replaces
// the same XLA compositions (pygsp_tpu/core/sparse.py:411-420 and
// pygsp_tpu/core/chunked.py:206-250, no Pallas kernel) at the widths of
// lambda_max's Lanczos, CG, LOBPCG and the zoo graphs' banks.
//   - What bounds it: at one column x (4 MB at 2^20 vertices) stays in L2,
//     so the least time is the slots' own bytes (path H's graph: 25.1M ELL
//     slots, 0.055 ms; path I's: 29.6M chunked slots, 0.083 ms); but every
//     live slot's gather brings a 32-byte L2 sector for 4 bytes, 537 MB a
//     call for the 16.8M stored edges, the wall kernel A's narrow entry
//     and torch.sparse.mm meet (0.166 ms there).
//   - The wide entry at one column gives each row one thread, which reads
//     per position a 32-byte table entry (the same for every row of the
//     chunk) before the column, the value and the x row, and leaves the
//     heavy rows' blocks to lead its grid.
//   - Design: a warp owns a tile of 32 / L consecutive rows of one out
//     chunk (halved on small matrices, kSlotMinTiles; the launcher chooses
//     P, L and the tile); L lanes a row, P values a lane (up to 16 bytes).
//     The block table is read once per warp
//     (32 entries, one a lane, handed round by shuffles), so a slot costs
//     its column and value and, if live, its x row; kFlight x rows are in
//     flight a lane, the chain running on across the chunked format's thin
//     blocks; ELL's level 0 (whole, 16-byte aligned 4-slot groups) is read
//     4 columns and 4 values a load. Each row sums its positions, then its
//     overflow slots, in order: the wide entry's order, so the two entries
//     give the same bits. The heavy rows keep the wide entry's blocks: on
//     ELL at one column they lead this kernel's grid, else they are a
//     launch on a side stream that runs beside the tiles (launched before
//     the tiles on the same stream they cost the tiles' wait: path H's graph
//     in f64 at 5 columns 0.472 ms, on the side stream 0.450; BA(2^16) at 8
//     f32 columns 0.064, side stream 0.052; on ELL at one column the side
//     stream took 0.196 ms, the grid 0.183; on the chunked format at one
//     column the grid took 0.209, the side stream 0.193, where the heavy
//     code no longer sets the register count; NVIDIA H100 80GB HBM3 at
//     700.00 W, device time, tools/slot_narrow_sweep.py on copies).
//   - Tried first and measured (tools/slot_narrow_sweep.py, NVIDIA H100
//     80GB HBM3 at 700.00 W, one column, path H / path I, ms of device
//     time, the wide entry 0.219-0.222 / 0.241-0.244 in the same runs):
//     lanes over slots, 32 a step with a segmented scan by row across the
//     warp, 0.239 / 0.361 (the scan's shuffles and a step per 32 slots,
//     dead padding included); the tile's slots staged in shared memory by
//     coalesced loads, each row's lanes adding its staged slots, at best
//     0.238 / 0.310 (each stage waits for its loads before its gathers);
//     this design 0.183 / 0.212.
//   - Measured (same card and tool, ms of device time, narrow / wide /
//     torch.sparse.mm): path H at 1, 8, 32 f32 columns 0.183 / 0.219 /
//     0.166, 0.291 / 0.466 / 1.282, 0.724 / 1.752 / 1.639, f64 at 5 0.450 /
//     0.839 / 1.457; path I at 1, 8, 32 f32 columns 0.194 / 0.242 / 0.168,
//     0.401 / 0.614 / 1.284, 1.223 / 2.104 / 1.638, bf16 x and values at
//     one column 0.186 / 0.242 / 0.176; BA(2^16) at 1 and 8 columns 0.028 /
//     0.047 / 0.017, 0.052 / 0.062 / 0.077. At one column it stays 1.10x
//     (H) and 1.15x (I) the library: the ELL and chunked formats read 1.5x
//     and 1.8x the slots of the CSR the library reads, and every live
//     slot's sector.
//     Registers (nvcc -Xptxas -v, sm_90a), no spills: f32 61-64, 78 on ELL
//     at one column (the heavy rows' code in the grid); f64 60-64, 78 at
//     two columns, 122 on ELL at one; bf16 x 64-92, f32 x with bf16 values
//     57-64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

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

// The rows of row block `block` when a row is under 8 pieces: a group of
// a.group lanes a row (the fewest that cover it), each lane walking the
// row's positions kSlots at a time, then its overflow slots; a row with
// kHeavySlots overflow slots or more is left to its heavy block.
template <typename T, typename V, int E>
__device__ __forceinline__ void spmm_rows(const Args<T, V>& a, int block) {
  using A = typename SumOf<T>::type;
  using B = typename Bits<T, E>::type;
  const int sub = threadIdx.x / a.group, gl = threadIdx.x - sub * a.group;
  const long long row =
      static_cast<long long>(block) * (kThreads / a.group) + sub;
  if (row >= a.n_rows) return;
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

// A block a heavy row, the longest first (a.heavy); `vec`: 16-byte pieces.
// Both entries launch it on the side stream, beside their row kernels.
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads, 3)
slot_heavy_kernel(const Args<T, V> a, int vec) {
  const int row = __ldg(a.heavy + blockIdx.x);
  if (vec)
    spmm_heavy<T, V, 16 / sizeof(T)>(a, row);
  else
    spmm_heavy<T, V, 1>(a, row);
}

// Rows under 8 pieces: blocks [0, n_heavy) take a heavy row each, the
// longest first, the others kThreads / a.group rows each (spmm_rows); at
// these widths the heavy blocks on a side stream measured slower (PERF.md).
// `vec`: 16-byte pieces, else one value a lane.
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads, 3)
slot_rows_kernel(const Args<T, V> a, int vec) {
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

// The wide kernel's tuning by x's type and the lanes a row: live slots
// whose x pieces a lane loads together (a round), and blocks an SM it is
// compiled for (registers: 65536 / (blocks * kThreads)). The most gathers
// in flight an SM without spill won the sweeps of tools/slot_variants.py
// (PERF.md): with f32 x at 32 lanes a row three slots at five blocks (48
// registers), else four at four (64; at five blocks the f32 rows of 16
// lanes spilled and lost 4 %).
template <typename T, int G>
struct Wide {
  static constexpr int kSlots = 4, kBlocks = 4;
};
template <>
struct Wide<float, 32> {
  static constexpr int kSlots = 3, kBlocks = 5;
};

// Positions kb + m * G + gl (m < NB) of row r, one a lane of the row's
// group: the x row (-1 where dead or past the row's positions) and value.
template <typename T, typename V, int G, int NB, typename A>
__device__ __forceinline__ void load_positions(const Args<T, V>& a,
                                               const RowSpan& r, int kb,
                                               int gl, int* xr, A* val) {
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    const int k = kb + m * G + gl;
    xr[m] = -1;
    val[m] = A(0);
    if (k < r.k1) {
      const longlong2* p = reinterpret_cast<const longlong2*>(a.pos) +
                           2 * static_cast<size_t>(k);
      const longlong2 bs = __ldg(p), cl = __ldg(p + 1);
      const long long q = bs.x + r.lr * bs.y;
      const int c = __ldg(a.cols + q);
      val[m] = load_val<V, A>(a.vals + q);
      if (c < cl.y) xr[m] = static_cast<int>(cl.x) + c;
    }
  }
}

// Overflow slots qb + m * G + gl (m < NB) below q1: x row and value, or -1.
template <typename T, typename V, int G, int NB, typename A>
__device__ __forceinline__ void load_overflow(const Args<T, V>& a, int qb,
                                              int q1, int gl, int* xr,
                                              A* val) {
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    const int q = qb + m * G + gl;
    xr[m] = -1;
    val[m] = A(0);
    if (q < q1) {
      xr[m] = __ldg(a.rcols + q);
      val[m] = load_val<V, A>(a.rvals + q);
    }
  }
}

// sum += the products of the slots that the lanes of `group` (a mask of
// the warp's lanes, the caller's row group) hold, lane j an x row xr (-1
// for none) and a value val, in ascending lane order: handed round by
// shuffles in rounds of Wide<T, G>::kSlots x rows in flight a lane, of
// which a lane reads the E values at column `col`, where `act`. The whole
// warp calls it together.
template <typename T, typename V, int E, int G, typename A>
__device__ __forceinline__ void add_group_slots(const Args<T, V>& a,
                                                unsigned group, int xr,
                                                A val, size_t col, bool act,
                                                A (&sum)[E]) {
  using B = typename Bits<T, E>::type;
  const int lane = threadIdx.x & 31;
  unsigned live = __ballot_sync(kFull, xr >= 0) & group;
  while (__any_sync(kFull, live != 0)) {
    int r[Wide<T, G>::kSlots];
    A w[Wide<T, G>::kSlots];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < Wide<T, G>::kSlots; ++j) {
      const int src = live ? __ffs(live) - 1 : lane;
      if (live) {
        live &= live - 1;
        cnt = j + 1;
      }
      r[j] = __shfl_sync(kFull, xr, src);
      w[j] = __shfl_sync(kFull, val, src);
    }
    if (!act) continue;
    B xb[Wide<T, G>::kSlots];
#pragma unroll
    for (int j = 0; j < Wide<T, G>::kSlots; ++j)
      if (j < cnt)
        xb[j] = __ldg(reinterpret_cast<const B*>(
            a.x + static_cast<size_t>(r[j]) * a.s + col));
#pragma unroll
    for (int j = 0; j < Wide<T, G>::kSlots; ++j) {
      if (j >= cnt) break;
      A xv[E];
      unpack<T, E>(xb[j], xv);
#pragma unroll
      for (int m = 0; m < E; ++m)
        sum[m] = add_rn(sum[m], product<T, V>(xv[m], w[j]));
    }
  }
}

// The wide entry's rows: a group of G lanes a row (G = 8, 16, 32: the
// fewest that cover a row of 8 pieces or more, so 32 / G rows share a warp
// and no lane idles for want of a piece), lane gl owning pieces gl, gl + G,
// ... of E values, 32 / G consecutive rows a warp. A group reads its row's
// first 32 positions (NB = 32 / G a lane: table entry, column, value) and
// its first 32 overflow slots before any gather, keeps the live ones by
// ballots and adds their x rows in rounds of Wide<T, G>::kSlots, the
// positions in order, then the overflow slots in order: the sums of the
// heavy blocks' add_positions and add_overflow, in the same order. A row
// of more than 32 positions or overflow slots (the warp's longest, so that
// every loop is warp-uniform) reads the rest 32 at a time. A heavy row
// (kHeavySlots overflow slots or more) is skipped: its block on the side
// stream writes it.
template <typename T, typename V, int E, int G>
__global__ void __launch_bounds__(kThreads, Wide<T, G>::kBlocks)
slot_wide_kernel(const Args<T, V> a) {
  using A = typename SumOf<T>::type;
  using B = typename Bits<T, E>::type;
  constexpr int NB = 32 / G;   // positions a lane reads a batch; rows a warp
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const unsigned group =
      G == 32 ? kFull : ((1u << (G & 31)) - 1u) << (lane - gl);
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long row = warp * NB + lane / G;
  if (__all_sync(kFull, row >= a.n_rows)) return;
  RowSpan r = row < a.n_rows ? row_span(a, static_cast<int>(row)) : RowSpan{};
  const bool adds = row < a.n_rows && r.q1 - r.q0 < kHeavySlots;
  if (!adds) r.k1 = r.q1 = -1;   // loads nothing, adds nothing
  int pxr[NB], oxr[NB];
  A pval[NB], oval[NB];
  load_positions<T, V, G, NB>(a, r, r.k0, gl, pxr, pval);
  load_overflow<T, V, G, NB>(a, r.q0, r.q1, gl, oxr, oval);
  const int k_len = __reduce_max_sync(kFull, adds ? r.k1 - r.k0 : 0);
  const int q_len = __reduce_max_sync(kFull, adds ? r.q1 - r.q0 : 0);
  const int nvec = a.s / E;
  for (int vb = 0; vb < nvec; vb += G) {
    const int v = vb + gl;
    const bool act = adds && v < nvec;
    const size_t col = static_cast<size_t>(v) * E;
    A sum[E];
#pragma unroll
    for (int m = 0; m < E; ++m) sum[m] = A(0);
#pragma unroll
    for (int m = 0; m < NB; ++m)
      add_group_slots<T, V, E, G>(a, group, pxr[m], pval[m], col, act, sum);
    for (int kb = 32; kb < k_len; kb += 32) {
      int bx[NB];
      A bv[NB];
      load_positions<T, V, G, NB>(a, r, r.k0 + kb, gl, bx, bv);
#pragma unroll
      for (int m = 0; m < NB; ++m)
        add_group_slots<T, V, E, G>(a, group, bx[m], bv[m], col, act, sum);
    }
#pragma unroll
    for (int m = 0; m < NB; ++m)
      add_group_slots<T, V, E, G>(a, group, oxr[m], oval[m], col, act, sum);
    for (int qb = 32; qb < q_len; qb += 32) {
      int bx[NB];
      A bv[NB];
      load_overflow<T, V, G, NB>(a, r.q0 + qb, r.q1, gl, bx, bv);
#pragma unroll
      for (int m = 0; m < NB; ++m)
        add_group_slots<T, V, E, G>(a, group, bx[m], bv[m], col, act, sum);
    }
    if (act)
      *reinterpret_cast<B*>(a.y + row * a.s + col) = pack<T, E>(sum);
  }
}

// Whether the wide kernel takes rows as 16-byte pieces: s a multiple of a
// piece, x and y 16-byte aligned.
template <typename T>
int wide_vec(const void* x, const void* y, int s) {
  auto aligned = [](const void* q) {
    return reinterpret_cast<size_t>(q) % 16 == 0;
  };
  return s % (16 / sizeof(T)) == 0 && aligned(x) && aligned(y);
}

// The kernels' operands, with the lanes a row of the heavy blocks and of
// the rows under 8 pieces: a warp per row from 8 pieces a row up, else the
// fewest lanes that cover a row. The heavy blocks' sums depend on it, so
// both entries give their heavy rows the same.
template <typename T, typename V>
Args<T, V> slot_args(const void* chunk_ptr, const void* pos, const void* cols,
                     const void* vals, const void* rowptr, const void* entptr,
                     const void* rcols, const void* rvals, const void* heavy,
                     const void* x, void* y, int n_rows, int s,
                     int chunk_rows, int n_heavy) {
  const int nvec = wide_vec<T>(x, y, s) ? s / (16 / sizeof(T)) : s;
  int group = 1;
  while (group < 32 && group < nvec) group *= 2;
  if (nvec >= 8) group = 32;
  return Args<T, V>{
      static_cast<const int*>(chunk_ptr), static_cast<const long long*>(pos),
      static_cast<const int*>(cols),      static_cast<const V*>(vals),
      static_cast<const int*>(rowptr),    static_cast<const int*>(entptr),
      static_cast<const int*>(rcols),     static_cast<const V*>(rvals),
      static_cast<const int*>(heavy),     static_cast<const T*>(x),
      static_cast<T*>(y), n_rows, s, chunk_rows, n_heavy, group};
}

// The stream and events on which both entries run the heavy rows' blocks
// beside their row kernels: one set per device, made at the first call that
// has heavy rows, at the highest priority, so that those blocks, the
// longest first, take the SMs before the rows do. The lock keeps the fork,
// the two launches and the join of one call together.
struct SideStream {
  std::mutex lock;
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

constexpr int kMaxDevices = 64;

cudaError_t side_stream(SideStream** out) {
  static SideStream sides[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  SideStream& side = sides[dev];
  std::lock_guard<std::mutex> hold(side.lock);
  if (side.join == nullptr) {
    int least = 0, greatest = 0;
    err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (err == cudaSuccess && side.stream == nullptr)
      err = cudaStreamCreateWithPriority(&side.stream, cudaStreamNonBlocking,
                                         greatest);
    if (err == cudaSuccess && side.fork == nullptr)
      err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
  }
  *out = &side;
  return cudaSuccess;
}

// The heavy rows' blocks (slot_heavy_kernel) on the side stream after the
// work queued on `st`; `hold` keeps the side stream until heavy_join.
template <typename T, typename V>
cudaError_t heavy_fork(const Args<T, V>& a, int vec, cudaStream_t st,
                       SideStream** side,
                       std::unique_lock<std::mutex>& hold) {
  cudaError_t err = side_stream(side);
  if (err != cudaSuccess) return err;
  hold = std::unique_lock<std::mutex>((*side)->lock);
  err = cudaEventRecord((*side)->fork, st);
  if (err == cudaSuccess)
    err = cudaStreamWaitEvent((*side)->stream, (*side)->fork);
  if (err != cudaSuccess) return err;
  slot_heavy_kernel<T, V><<<a.n_heavy, kThreads, 0, (*side)->stream>>>(
      a, vec);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaEventRecord((*side)->join, (*side)->stream);
  return err;
}

// `st` waits for the heavy rows (if forked); the first error of the call.
int heavy_join(SideStream* side, cudaStream_t st, cudaError_t err) {
  if (side != nullptr) {
    const cudaError_t joined = cudaStreamWaitEvent(st, side->join);
    if (err == cudaSuccess) err = joined;
  }
  return static_cast<int>(err);
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
  const Args<T, V> a = slot_args<T, V>(chunk_ptr, pos, cols, vals, rowptr,
                                       entptr, rcols, rvals, heavy, x, y,
                                       n_rows, s, chunk_rows, n_heavy);
  const int vec = wide_vec<T>(x, y, s);
  const int nvec = vec ? s / kVec : s;
  // lanes a row: G of the wide kernel from 8 pieces up (32 with one value
  // a lane), else a.group
  const int g = nvec < 8 ? 0 : !vec || nvec > 16 ? 32 : nvec > 8 ? 16 : 8;
  const long long rows_per_block =
      g ? static_cast<long long>(kWarps) * (32 / g)
        : kThreads / a.group;
  // the heavy rows' blocks: leading the rows kernel's grid, else on the
  // side stream
  const long long blocks = (g ? 0 : n_heavy) +
                           (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  SideStream* side = nullptr;
  std::unique_lock<std::mutex> hold;
  if (n_heavy > 0 && g) {
    const cudaError_t err = heavy_fork(a, vec, st, &side, hold);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto nb = static_cast<unsigned>(blocks);
  if (g == 0)
    slot_rows_kernel<T, V><<<nb, kThreads, 0, st>>>(a, vec);
  else if (!vec)
    slot_wide_kernel<T, V, 1, 32><<<nb, kThreads, 0, st>>>(a);
  else if (g == 8)
    slot_wide_kernel<T, V, kVec, 8><<<nb, kThreads, 0, st>>>(a);
  else if (g == 16)
    slot_wide_kernel<T, V, kVec, 16><<<nb, kThreads, 0, st>>>(a);
  else
    slot_wide_kernel<T, V, kVec, 32><<<nb, kThreads, 0, st>>>(a);
  return heavy_join(side, st, cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The narrow entry: a warp a tile of rows, the blocks from the block table
// ---------------------------------------------------------------------------

// The bits a value of T is stored in (bf16 as its 16 bits), and P of them
// as one aligned access.
template <typename T>
struct Raw {
  using type = T;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = unsigned short;
};

template <typename T, int P>
struct alignas(sizeof(T) * P) Pack {
  typename Raw<T>::type v[P];
};

template <typename T, typename A>
__device__ __forceinline__ A widen(typename Raw<T>::type b) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  else
    return static_cast<A>(b);
}

template <typename T, typename A>
__device__ __forceinline__ typename Raw<T>::type narrow(A v) {
  if constexpr (sizeof(T) == 2)
    return static_cast<unsigned short>(bf16_word(v));
  else
    return static_cast<T>(v);
}

// A lane's P columns c0 .. c0 + P - 1 of the row at p, as stored: one
// aligned access where rows are whole packs (vec), else masked scalars.
template <typename T, int P>
__device__ __forceinline__ Pack<T, P> load_row(const T* p, int c0, int s,
                                               int vec) {
  using R = typename Raw<T>::type;
  Pack<T, P> u;
  if (vec && c0 < s) return *reinterpret_cast<const Pack<T, P>*>(p + c0);
  const R* r = reinterpret_cast<const R*>(p);
#pragma unroll
  for (int m = 0; m < P; ++m) u.v[m] = c0 + m < s ? r[c0 + m] : R(0);
  return u;
}

template <typename T, int P, typename A>
__device__ __forceinline__ void store_row(T* p, int c0, int s, int vec,
                                          const A (&a)[P]) {
  using R = typename Raw<T>::type;
  Pack<T, P> u;
#pragma unroll
  for (int m = 0; m < P; ++m) u.v[m] = narrow<T>(a[m]);
  if (vec) {
    if (c0 < s) *reinterpret_cast<Pack<T, P>*>(p + c0) = u;
    return;
  }
  R* r = reinterpret_cast<R*>(p);
#pragma unroll
  for (int m = 0; m < P; ++m)
    if (c0 + m < s) r[c0 + m] = u.v[m];
}

// Slots whose x rows a lane loads together: 8, or 4 from 8 bytes a row.
template <typename T, int P>
constexpr int kFlight = P * sizeof(T) >= 8 ? 4 : 8;

// acc += the products of the F slots (x row xr, -1 for a dead slot, which
// adds nothing and reads no x; value val) in order, the lane's columns c0
// .. of each x row, all F x rows loaded before the first product.
template <typename T, typename V, int P, int F, typename A>
__device__ __forceinline__ void add_chain(const Args<T, V>& a,
                                          const int (&xr)[F],
                                          const A (&val)[F], int c0, int vec,
                                          A (&acc)[P]) {
  Pack<T, P> xb[F];
#pragma unroll
  for (int u = 0; u < F; ++u)
    if (xr[u] >= 0)
      xb[u] = load_row<T, P>(a.x + static_cast<long long>(xr[u]) * a.s, c0,
                             a.s, vec);
#pragma unroll
  for (int u = 0; u < F; ++u) {
    if (xr[u] < 0) continue;
#pragma unroll
    for (int m = 0; m < P; ++m)
      acc[m] = add_rn(acc[m], product<T, V>(widen<T, A>(xb[u].v[m]), val[u]));
  }
}

// The per-block table as a warp reads it: lane j holds block wb + j's entry
// (off, width, col_base, limit), 32 at a time, and the current block's entry
// is handed round by shuffles. Every call is warp-uniform.
struct BlockWindow {
  int wb = 0;
  long long e_off = 0;
  int e_width = 0, e_base = 0, e_limit = 0;
  long long off = 0;   // the current block
  int width = 0, col_base = 0, limit = 0;

  // the entries from block `from` on, and block `from` current
  __device__ __forceinline__ void read(const long long* table, int from,
                                       int end, int lane) {
    wb = from;
    if (wb + lane < end) {
      const longlong2* p =
          reinterpret_cast<const longlong2*>(table) + 2 * (wb + lane);
      const longlong2 u = __ldg(p), v = __ldg(p + 1);
      e_off = u.x;
      e_width = static_cast<int>(u.y);
      e_base = static_cast<int>(v.x);
      e_limit = static_cast<int>(v.y);
    }
    take(from);
  }

  // block kb (>= wb) current
  __device__ __forceinline__ void at(const long long* table, int kb, int end,
                                     int lane) {
    if (kb - wb >= 32)
      read(table, kb, end, lane);
    else
      take(kb);
  }

  __device__ __forceinline__ void take(int kb) {
    off = __shfl_sync(kFull, e_off, kb - wb);
    width = __shfl_sync(kFull, e_width, kb - wb);
    col_base = __shfl_sync(kFull, e_base, kb - wb);
    limit = __shfl_sync(kFull, e_limit, kb - wb);
  }
};

// One warp per tile of `tile` (<= 32 / L) consecutive rows of one out chunk;
// group q (L lanes, P columns a lane) owns the tile's row q, sums it in
// registers and writes it once. The row's positions are walked in order,
// block by block in table order (row lr of a block of width w reads the
// slots off + lr * w .. + w - 1 of the flat cols/vals), then its overflow
// slots in order: the wide entry's order. The per-block table (off, width,
// col_base, limit), block kb of chunk i at [block_ptr[i], block_ptr[i + 1]),
// is read once by the warp, 32 entries at a time, one a lane, and handed
// round by shuffles, so no slot reads a table entry. The slots are taken
// kFlight at a time, their x rows all loaded before the first product; a
// chain runs on across block boundaries, and where a block starts whole
// 4-slot groups, 16-byte aligned (ELL's level 0), a lane reads its columns
// and values four at a time. A heavy row (kHeavySlots overflow slots or
// more) belongs to a block of the heavy rows (spmm_heavy), the wide
// entry's:
// the tile reads none of its slots and does not write it. With Lead (the
// ELL instances at one column) those blocks lead this kernel's grid and
// start before the tiles; else they are a launch of slot_heavy_kernel on
// the side stream that runs beside this one (heavy_fork), which keeps the
// heavy code's registers out of this kernel.
template <typename T, typename V, int P, int L, bool Lead>
__device__ __forceinline__ void narrow_tile(const Args<T, V>& a,
                                            const int* block_ptr,
                                            const long long* block_table,
                                            int tile, int vec) {
  using A = typename SumOf<T>::type;
  using RV = typename Raw<V>::type;
  constexpr int F = kFlight<T, P>;
  int b = static_cast<int>(blockIdx.x);
  if constexpr (Lead) {   // the heavy rows' blocks lead
    if (b < a.n_heavy) {
      spmm_heavy<T, V, 1>(a, __ldg(a.heavy + b));
      return;
    }
    b -= a.n_heavy;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane / L, c0 = (lane % L) * P;
  const long long w = static_cast<long long>(b) * kWarps + warp;
  const int per_chunk = (a.chunk_rows + tile - 1) / tile;
  const long long i = w / per_chunk;
  const int lr0 = static_cast<int>(w - i * per_chunk) * tile;
  const long long row0 = i * a.chunk_rows + lr0;
  if (row0 >= a.n_rows) return;   // warp-uniform
  const int nt = static_cast<int>(
      min(static_cast<long long>(min(tile, a.chunk_rows - lr0)),
          a.n_rows - row0));
  const bool own = q < nt;
  int q0 = 0, q1 = 0;   // the owned row's overflow slots
  if (own && a.rowptr != nullptr) {
    q0 = __ldg(a.entptr + __ldg(a.rowptr + row0 + q));
    q1 = __ldg(a.entptr + __ldg(a.rowptr + row0 + q + 1));
  }
  const bool adds = own && q1 - q0 < kHeavySlots;
  const long long lr = lr0 + q;   // the owned row in its chunk
  A acc[P];
#pragma unroll
  for (int m = 0; m < P; ++m) acc[m] = A(0);

  // the dense blocks; the current one's entry in bw
  const int kb0 = __ldg(block_ptr + i), kb1 = __ldg(block_ptr + i + 1);
  BlockWindow bw;
  if (kb0 < kb1) bw.read(block_table, kb0, kb1, lane);
  int kb = kb0, j = 0;   // the next position: slot j of block kb
  while (kb < kb1) {
    int xr[F];
    A val[F];
    const RV* vals = reinterpret_cast<const RV*>(a.vals);
    if (j == 0 && bw.width % 4 == 0 && (bw.off & 3) == 0 &&
        reinterpret_cast<size_t>(a.cols) % 16 == 0 &&
        reinterpret_cast<size_t>(vals) % (4 * sizeof(RV)) == 0) {
      // a whole aligned block, four slots a load
      const long long at = bw.off + lr * bw.width;
      for (; j < bw.width; j += F) {
#pragma unroll
        for (int g = 0; g < F; g += 4) {
          int4 c4 = make_int4(bw.limit, bw.limit, bw.limit, bw.limit);
          Pack<V, 4> v4 = {};
          if (adds && j + g < bw.width) {
            c4 = __ldg(reinterpret_cast<const int4*>(a.cols + at + j + g));
            v4 = *reinterpret_cast<const Pack<V, 4>*>(vals + at + j + g);
          }
          const int cg[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            xr[g + e] = cg[e] < bw.limit ? bw.col_base + cg[e] : -1;
            val[g + e] = xr[g + e] >= 0 ? widen<V, A>(v4.v[e]) : A(0);
          }
        }
        add_chain<T, V, P>(a, xr, val, c0, vec, acc);
      }
      j = 0;
      if (++kb < kb1) bw.at(block_table, kb, kb1, lane);
      continue;
    }
    // F positions one at a time, across block boundaries
#pragma unroll
    for (int u = 0; u < F; ++u) {
      xr[u] = -1;
      val[u] = A(0);
      if (kb < kb1) {
        if (adds) {
          const long long src = bw.off + lr * bw.width + j;
          const int c = __ldg(a.cols + src);
          val[u] = load_val<V, A>(a.vals + src);
          xr[u] = c < bw.limit ? bw.col_base + c : -1;
        }
        if (++j == bw.width) {
          j = 0;
          if (++kb < kb1) bw.at(block_table, kb, kb1, lane);
        }
      }
    }
    add_chain<T, V, P>(a, xr, val, c0, vec, acc);
  }

  // the overflow slots [q0, q1), in order
  if (adds) {
    for (int k = q0; k < q1; k += F) {
      int xr[F];
      A val[F];
#pragma unroll
      for (int u = 0; u < F; ++u) {
        xr[u] = -1;
        val[u] = A(0);
        if (k + u < q1) {
          xr[u] = __ldg(a.rcols + k + u);
          val[u] = load_val<V, A>(a.rvals + k + u);
        }
      }
      add_chain<T, V, P>(a, xr, val, c0, vec, acc);
    }
    store_row<T, P>(a.y + (row0 + q) * a.s, c0, a.s, vec, acc);
  }
}

// The instance that ptxas, left to its own register target, spills (12
// bytes at 64 registers: f64 at two columns) takes at least two blocks an
// SM, up to 128 registers, and spills nothing; the others keep ptxas's
// choice (one column in f32 at 78, where a bound of one or two blocks made
// it take 106 or 122).
template <typename T, typename V, int P, int L>
constexpr bool kRoomy = sizeof(T) == 8 && P == 2 && L == 1;

template <typename T, typename V, int P, int L, bool Lead>
__global__ void __launch_bounds__(kThreads)
slot_narrow_kernel(const Args<T, V> a, const int* __restrict__ block_ptr,
                   const long long* __restrict__ block_table, int tile,
                   int vec) {
  narrow_tile<T, V, P, L, Lead>(a, block_ptr, block_table, tile, vec);
}

template <typename T, typename V, int P, int L>
__global__ void __launch_bounds__(kThreads, 2)
slot_narrow_kernel_roomy(const Args<T, V> a,
                         const int* __restrict__ block_ptr,
                         const long long* __restrict__ block_table, int tile,
                         int vec) {
  narrow_tile<T, V, P, L, false>(a, block_ptr, block_table, tile, vec);
}

template <typename T, typename V, int P, int L, bool Lead = false>
void launch_narrow_instance(unsigned blocks, cudaStream_t st,
                            const Args<T, V>& a, const void* block_ptr,
                            const void* block_table, int tile, int vec) {
  const auto* bp = static_cast<const int*>(block_ptr);
  const auto* bt = static_cast<const long long*>(block_table);
  if constexpr (kRoomy<T, V, P, L>)
    slot_narrow_kernel_roomy<T, V, P, L><<<blocks, kThreads, 0, st>>>(
        a, bp, bt, tile, vec);
  else
    slot_narrow_kernel<T, V, P, L, Lead><<<blocks, kThreads, 0, st>>>(
        a, bp, bt, tile, vec);
}

// The narrow entry's tiles: 32 / L rows (a group of L lanes each), halved
// while the matrix has fewer than kSlotMinTiles tiles, down to one row: on
// a small matrix a few long tiles leave the card idle while each warp waits
// on its gathers in turn (kernel A's NARROW_MIN_SEGMENTS).
constexpr int kSlotMinTiles = 2048;

int narrow_tile_rows(int n_rows, int chunk_rows, int lanes) {
  const long long full = n_rows / chunk_rows, rest = n_rows % chunk_rows;
  const auto tiles = [&](int t) {
    return full * ((chunk_rows + t - 1) / t) + (rest + t - 1) / t;
  };
  int tile = 32 / lanes;
  while (tile > 1 && tiles(tile) < kSlotMinTiles) tile /= 2;
  return tile;
}

template <typename T, typename V, bool Ell>
int launch_slot_narrow(const void* chunk_ptr, const void* pos,
                       const void* block_ptr, const void* block_table,
                       const void* cols, const void* vals, const void* rowptr,
                       const void* entptr, const void* rcols,
                       const void* rvals, const void* heavy, const void* x,
                       void* y, int n_rows, int s, int chunk_rows,
                       int n_heavy, void* stream) {
  constexpr int kV = 16 / sizeof(T);   // values of a 16-byte access
  // P = min(kV, next_pow2(s)) values a lane, L = next_pow2(ceil(s / P))
  // lanes a row
  int p = 1;
  while (p < kV && p < s) p *= 2;
  int lanes = 1;
  while (lanes * p < s) lanes *= 2;
  if (n_rows < 1 || s < 1 || lanes > 32 || chunk_rows < 1 || n_heavy < 0 ||
      (n_heavy > 0 && rowptr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = narrow_tile_rows(n_rows, chunk_rows, lanes);
  const size_t pack = p * sizeof(T);
  const int vec = s % p == 0 && reinterpret_cast<size_t>(x) % pack == 0 &&
                  reinterpret_cast<size_t>(y) % pack == 0;
  const long long n_out = (n_rows + chunk_rows - 1LL) / chunk_rows;
  const long long warps = n_out * ((chunk_rows + tile - 1LL) / tile);
  // the heavy rows' blocks: leading the grid for ELL at one column (Lead),
  // else on the side stream
  const bool lead = Ell && p == 1;
  const long long blocks =
      (lead ? n_heavy : 0) + (warps + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const Args<T, V> a = slot_args<T, V>(
      chunk_ptr, pos, cols, vals, rowptr, entptr, rcols, rvals, heavy, x, y,
      n_rows, s, chunk_rows, n_heavy);
  SideStream* side = nullptr;
  std::unique_lock<std::mutex> hold;
  if (n_heavy > 0 && !lead) {   // the heavy rows' blocks on the side stream
    const cudaError_t err = heavy_fork(a, wide_vec<T>(x, y, s), st, &side,
                                       hold);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto go = [&](auto launch) {
    launch(static_cast<unsigned>(blocks), st, a, block_ptr, block_table,
           tile, vec);
  };
  if (p < kV) {   // s below one 16-byte access: one lane a row
    if (p == 1) {
      if constexpr (Ell)
        go(launch_narrow_instance<T, V, 1, 1, true>);
      else
        go(launch_narrow_instance<T, V, 1, 1>);
    } else if (p == 2)
      go(launch_narrow_instance<T, V, 2, 1>);
    else if constexpr (kV > 4)
      go(launch_narrow_instance<T, V, 4, 1>);
  } else if (lanes == 1) {
    go(launch_narrow_instance<T, V, kV, 1>);
  } else if (lanes == 2) {
    go(launch_narrow_instance<T, V, kV, 2>);
  } else if (lanes == 4) {
    go(launch_narrow_instance<T, V, kV, 4>);
  } else if (lanes == 8) {
    go(launch_narrow_instance<T, V, kV, 8>);
  } else if (lanes == 16) {
    go(launch_narrow_instance<T, V, kV, 16>);
  } else {
    go(launch_narrow_instance<T, V, kV, 32>);
  }
  return heavy_join(side, st, cudaGetLastError());
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

// The narrow entry's instances, one per pair as above; ELL's take the heavy
// rows into the grid at one column (Lead).
#define SLOT_NARROW(NAME, T, V, ELL)                                          \
  extern "C" int NAME(const void* chunk_ptr, const void* pos,                 \
                      const void* block_ptr, const void* block_table,         \
                      const void* cols, const void* vals,                     \
                      const void* rowptr, const void* entptr,                 \
                      const void* rcols, const void* rvals,                   \
                      const void* heavy, const void* x, void* y, int n_rows,  \
                      int s, int chunk_rows, int n_heavy, void* stream) {     \
    return launch_slot_narrow<T, V, ELL>(                                     \
        chunk_ptr, pos, block_ptr, block_table, cols, vals, rowptr, entptr,   \
        rcols, rvals, heavy, x, y, n_rows, s, chunk_rows, n_heavy, stream);   \
  }

SLOT_NARROW(ell_spmm_narrow_f32, float, float, true)
SLOT_NARROW(ell_spmm_narrow_f64, double, double, true)
SLOT_NARROW(chunked_spmm_narrow_f32, float, float, false)
SLOT_NARROW(chunked_spmm_narrow_f64, double, double, false)
SLOT_NARROW(chunked_spmm_narrow_bf16_f32, __nv_bfloat16, float, false)
SLOT_NARROW(chunked_spmm_narrow_bf16, __nv_bfloat16, __nv_bfloat16, false)
SLOT_NARROW(chunked_spmm_narrow_f32_bf16, float, __nv_bfloat16, false)
