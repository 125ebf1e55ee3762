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
//   (b) window_strip, the SpMM's tail: the overlap-add of the window
//       tensor t,
//       y[i*R + w*P + r, :] = sum_{d < K, d <= w} t[i, w-d, d*P + r, :],
//       then each row's residue entries (the slots that spilled from the
//       slabs, one row-sorted list: core/windowed_kernel.py Residue),
//       y[row, :] += sum_{slots q of entry e} vals[q] * x[cols[q], :]
//       entry by entry, in the order of the JAX package's index_add.
//
// Replaces: (a) TPU kernel #2, benchmarks/pallas_fold_probe.py
// make_pallas_fold (the pl.pallas_call at line 103), the one-hot fold
// out[w, k, :] = sum_{l : rid[w,l] = k} p[w, l, :], fused with the slot
// gather and product that pygsp_tpu/core/windowed.py:298-303 makes before
// its one-hot einsum (:320); (b) the XLA overlap-add of
// pygsp_tpu/core/windowed.py:336-345 with the residue tiers' gather-sums
// and scatter-add that follow it (:406-414, core/sparse.py
// _slot_block_sum :363); (c) fold_products is #2's function as
// it stands, and at NW = 1 TPU kernel #3 (benchmarks/pallas_smoke.py
// fold_kernel, pallas_call at line 52); (d) double is TPU kernel #4
// (pallas_smoke.py dbl_kernel, line 28), the toolchain canary, and beside
// it an empty kernel (launch_floor) whose device time is double's bound.
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
// first port.
// The fold of several matrices into one window tensor (windowed_fold_multi,
// y = sum_m A_m @ x_m, the 2-D engine's ring fold) is the same kernel's
// kMulti instance: the matrices' slabs and x's come in a table in the
// kernel's parameters, warp 0 queues every matrix's live slots of the window
// one matrix after another, and each queued slot carries its matrix, whose
// x the copy reads. The single-matrix fold is the instance with a table of
// one and no matrix index in the queue; warp 0 reads the staged matrix's
// fields from the table at each round, so that without kMulti they are
// plain kernel parameters. Against a single-matrix kernel of its own, that
// instance gives bit-equal window tensors at path C, in the same time in
// f32 and in bf16 (within 1 %), and 3 % more in the bf16-carry pair (3.31
// against 3.21 ms), on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/fold_instances.py); a build that kept the matrix's fields in
// registers lost 4 % in f32. Registers (nvcc -Xptxas -v, sm_90a), no
// spill: 64 in f32, 62 in bf16, 56 and 64 in the mixed pairs, 80 in f64;
// the kMulti instances 56, and 80 in f64.
//
// (c) is TPU kernel #2's own design carried to this card's tensor cores:
// per window, the one-hot (KP, Lt) times the products (Lt, S), bf16
// operands with f32 sums (the TPU kernel's MXU product,
// pallas_fold_probe.py:94-100). What bounds it: bytes (at #2's probe shape
// p is 302 MB of bf16 and the output 134 MB of f32; 0.132 ms at the memory
// rate), since the product's 77 GFLOP take 0.078 ms at the dense bf16
// rate. The route is mma.sync m16n8k16 (bf16, f32 accumulators) with the
// one-hot built in registers from the staged row ids, never stored, and the
// products read from shared memory with ldmatrix.trans (p is N-contiguous,
// so its K x N slice is the transposed B that ldmatrix.trans gives). It is
// chosen over wgmma because the one-hot is made per lane in exactly
// mma.sync's A-fragment layout, and because the time goes to moving p, not
// to the products. A block owns a KP tile of 64, 128 or 256 rows and 128
// columns of S (grid: windows x KP tiles x S tiles, so #3's single window
// runs 4 blocks). Each block reads its window's p, so at #2's probe shape,
// where the time follows the bytes the SMs read from L2, one 256-row tile
// per window is fastest (tools/profile_torch_port.py times each tile);
// experiment builds with a deeper ring, or that skipped the mma of
// all-zero one-hot tiles, were no faster there. A block walks the window's
// slots 32 at a time through a ring of 4 shared stages that cp.async fills
// 3 stages ahead (a first build that loaded one stage ahead through
// registers took twice as long at #3's single window, where no other
// block hides the memory's latency), and masks ragged KP, Lt and S. A dead
// slot (row id outside [0, KP)) or one past Lt is zero-filled in the ring,
// its products never read, and its row id staged as -1, so that even a
// non-finite product in it adds nothing. f32 products are split exactly
// into three bf16 terms (hi, mid, lo) and multiplied three times against
// the exact one-hot, which keeps f32 accuracy. Every output element sums
// in a fixed order: two launches are bit-equal. At #2's probe shape:
// 0.297 ms on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), against
// 2.27 ms for the shared-memory scatter it replaces; 122 to 168
// registers, no spills.
//
// What bounds (b): bytes. It reads t once (1.07 GB in f32 at the bench
// path, K = 2), writes y once (0.54 GB) and gathers one x row per live
// residue slot (654,596 rows, 0.34 GB), about 0.58 ms at the memory rate
// (0.29 ms in bf16). Before, it was a warp per row with one value a lane
// (64 bytes a load in bf16) and the residue tiers were 32 gathers, sums
// and casts and an index_add_ in plain PyTorch, that wrote every residue
// row of y a second time and, on the card, summed repeated rows in no
// fixed order. Design of (b): each row has one owner, which writes it
// once; so there are no atomics, and two launches are bit-equal.
//   - Row blocks: a group of lanes per row (32 for an f32 row of 128,
//     16 for a bf16 one, so a warp takes two rows), each lane owning a
//     16-byte piece of it (float4, double2, eight bf16); a block of 8
//     warps takes 4 such row groups a warp. The first two addends of all
//     4 are loaded at once with evict-first loads (ld.global.cs: t is read
//     once, and L2 keeps x for the gathers), 8 pieces a lane in flight,
//     with each row's residue pointers and its first entry's slot range
//     beside them; then row by row the addends are summed in order
//     d = 0..K-1 in f32 (f64 for f64) and rounded once to t's type, and y
//     is stored with st.global.cs. A row's residue entries (most rows have
//     none) are added in order before the store: per entry its slots'
//     (x row, value) pairs and then up to 4 x rows are loaded together
//     through the read-only path, the products formed in the promotion of
//     x's and the values' types (bf16 * bf16 rounds to bf16, as in (a))
//     and summed in slot order in f32 or f64, the sum rounded to t's type
//     and added to the row, rounded again: the order and the roundings of
//     the plain version (the JAX package's tiers, each summed and cast,
//     then index_add in the output's type).
//   - Heavy rows: a row with kHeavyMin (8) entries or more (2965
//     rows at the bench graph; the 233 hub rows have up to about 860
//     entries of 8 slots) is left by the row blocks to a block of its own,
//     placed first in the grid, the longest rows first. Its warps sum 32
//     entries a round, 4 each: the round's slot ranges come in one load
//     (an entry a lane), an entry's (x row, value) pairs in one load (a
//     slot a lane) handed round by shuffles, and 8 x rows at a time are
//     loaded; each sum goes to shared memory, and after a barrier the
//     thread that owns a column adds them to the row in entry order.
//     Still, the heavy rows cost about 0.1 ms of the launch on an NVIDIA
//     H100 80GB HBM3 at 700 W: a heavy block waits on dependent loads
//     while it holds one of its SM's two block slots
//     (tools/tail_variants.py; PERF.md, Findings).
//   - Rows whose pieces are not whole 16-byte units (S * itemsize not a
//     multiple of 16, or t, y or x not 16-byte aligned) take the same code
//     with one value a lane, in the same kernel.
// Each sum and product rounds once (__fadd_rn, __fmul_rn), as PyTorch's
// single operations do. At the bench path: 0.766 ms in f32 and 0.492 in
// bf16 on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), against byte
// bounds of 0.545 and 0.273. Registers (nvcc -Xptxas -v, sm_90a): 128 in
// every instance, 12 to 68 bytes of spill; a build held to 64 registers
// spilled up to 964 bytes and took twice as long.
//
// (e) fold_strip_multi is the fused multi-matrix SpMM y = sum_m A_m @ x_m
// (the 2-D engine's ring fold) in one launch that writes y and no window
// tensor: what windowed_fold_multi and then window_strip compute, with the
// same roundings, so the two routes give the same bits. It replaces the
// XLA-composed pygsp_tpu/core/windowed.py:windowed_spmm_chunks_multi
// (:201-418: the slot gathers, the one-hot fold of #2, the overlap-add
// :336-345 and the residue tiers :406-414), no Pallas kernel of its own.
// What bounds it: bytes, or the gathers. The two-launch route writes the
// window tensor t (K*P rows a window, K = 2: twice y) and reads it back;
// at the 2-D engine's fragmented density (about 250 live slots a window
// over four matrices) that round trip cost as much as the whole SpMM of
// torch.sparse.mm. Here each window's slabs are read K times (a few bytes a
// slot) and t never leaves the block. What else bounds the fold's design at
// this density: one TMA request per live slot (about 37 ns an SM on this
// card, which sets the fold's time at path C and most of it at L3) and a
// 64 KB shared accumulator, which leaves room for two blocks an SM. So this
// kernel gathers with plain loads into registers and sums there. Design: a
// block (8 warps) takes one window's P rows and a tile of 32 x E columns
// (E values a lane: a 16-byte piece, 4 f32 or 2 f64 values; in bf16 an
// 8-byte piece of 4 values, so a bf16 row takes as many loads as an f32
// one). It stages the window's raw
// slots, one stream over the segments (d, m), d-major: the slots of matrix
// m in window w - d, in slot order, live where their row id lies in
// [d P, d P + P) (part d of the window's rows). Each warp compacts a
// contiguous range of the stream into shared memory (a ballot) and counts
// the row ids; warp 0 sorts the staged slots by row id, stably (a scan of
// the counts, then match_any ranks), so each row id's slots stand in
// stream order, the order in which the fold sums them. Then a warp takes a
// row: part d sums its slots in registers, each lane loading its piece of
// the slot's x row, by the fold's own expression (acc += v * x, an FMA as
// in the fold), and is rounded to x's type: the window tensor's value, bit
// for bit. The parts are added in order d = 0..K-1 and rounded once, then
// the row's residue entries (each entry's sum by the warp, in slot order,
// rounded, and each add rounded), and the row is stored: the strip's
// roundings. A heavy row (kHeavyMin entries or more) does not serialise a
// warp: every warp of the block sums its entries, kEntryRound a round,
// into shared memory, and warp 0 adds them in entry order. The windows
// holding heavy rows lead the grid, most entries first (a block per heavy
// row, the block of the window's leading heavy row folds it, the others
// return). Each row of y has one writer: no atomics, two launches are
// bit-equal. A window whose raw slots do not fit a block's shared memory
// is refused (fold_strip_fits in the wrapper); spmm_multi_internal keeps
// the two launches there.
//
// The bf16 instances of (a) and (b), for the recurrence's fast modes
// (pygsp_tpu/ops/chebyshev.py:102-121, :223-236): x (the carried term) in
// bf16 with f32 values, x and values both in bf16, and f32 x with bf16
// values. This is TPU kernel #2's own regime: bf16 operands, f32 sums
// (pallas_fold_probe.py:86-100). Each product is formed in the promotion of
// the two types, so a bf16 * bf16 product is rounded to bf16 as the JAX
// fold's einsum operand is (pygsp_tpu/core/windowed.py:298), and summed in
// f32 in shared memory; the window tensor is written in x's type, bf16 in
// the carry mode (the JAX package narrows the fold's output for the traffic
// of t and of the strip, :241-248). The queue holds each value in the sums'
// type, the ring x's rows as they are: a bf16 row is half the bytes, so the
// ring holds twice the rows for the same 64 KB per SM, but it is still one
// TMA request per live slot, so the producers' issue rate, one of the two
// limits above, does not halve. (b) has an instance for each of (a)'s
// pairs; it sums a bf16 t in f32 and rounds once: at K = 2 (two addends)
// that is the JAX package's bf16 add bit for bit; for K > 2 the JAX package
// rounds after every add.

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
// and its value in the sums' type, read by a consumer in one 8- or 16-byte
// access.
template <typename A>
struct alignas(2 * sizeof(A)) Slot {
  int off;
  A val;
};

// The type sums are taken in: float, or double for double operands.
template <typename T>
struct SumOf {
  using type = float;
};
template <>
struct SumOf<double> {
  using type = double;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(typename SumOf<T>::type v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The bf16 value that a float widened from bf16 holds (its upper 16 bits).
__device__ __forceinline__ __nv_bfloat16 as_bf16(float v) {
  return __ushort_as_bfloat16(
      static_cast<unsigned short>(__float_as_uint(v) >> 16));
}

// A slot's product in the promotion of the operand types: rounded to bf16
// when both are bf16, as the JAX fold forms it. The bf16 multiply rounds
// once to nearest even, as rounding the float product does (the product
// of two bf16 values is exact in float), and costs the folding threads
// less than __float2bfloat16_rn of the float product
// (tools/fold_instances.py).
template <bool kBf16Product, typename A>
__device__ __forceinline__ A product(A v, A x) {
  if constexpr (kBf16Product)
    return __bfloat162float(__hmul(as_bf16(v), as_bf16(x)));
  else
    return v * x;
}

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

// The matrices of a fold: per matrix its slabs (cols, values, row ids), its
// x, its source chunks and slab width, and x's rows. The table rides in the
// kernel's parameters (__grid_constant__, read from the constant bank),
// filled by the launcher at each launch: no device copy, no allocation. The
// single-matrix fold passes a table of one.
constexpr int kMaxMats = 16;
struct FoldMat {
  const int* cols;
  const void* vals;
  const void* rowid;
  const void* x;
  int n_src, L, n_cols, pad;
};
struct FoldMats {
  FoldMat m[kMaxMats];
  int n;
};

// Shared-memory bytes of a fold block: the full and empty mbarriers and the
// count of each ring part (20 bytes a part), the accumulator of sums A, the
// ring of x rows X and the queue (a Slot of 2 * sizeof(A) and its x row, an
// int, per entry; kMulti: and its matrix, an int). fold_layout in the
// wrapper budgets the same sum.
template <bool kMulti, typename X>
size_t fold_smem_bytes(int kp, int s_tile, int ring, int queue) {
  using A = typename SumOf<X>::type;
  return 2 * kGroups * sizeof(unsigned long long) + kGroups * sizeof(int) +
         static_cast<size_t>(kp) * s_tile * sizeof(A) +
         static_cast<size_t>(ring) * s_tile * sizeof(X) +
         static_cast<size_t>(queue) *
             (sizeof(Slot<A>) + (kMulti ? 2 : 1) * sizeof(int));
}

// X: x's type (and t's); V: the values' type. kMulti: the fold of several
// matrices into one window tensor (windowed_fold_multi). Warp 0 stages
// matrix 0's slots of the window, then matrix 1's, ..., into the one queue,
// each live slot with its matrix (q_mat), so that its x row is read from
// that matrix's x; the folding threads add every slot into the one
// accumulator in queue order (matrix by matrix, each in slot order), so two
// launches are bit-equal and t is written once. The matrices share R, K*P,
// (n_out, NW) and the operand types; their slab width L and source-chunk
// count may differ. Without kMulti the table holds one matrix, and the
// queue no matrix index.
template <bool kMulti, typename X, typename V, typename RowId>
__global__ void __launch_bounds__(128 + 32 * kProducers)
windowed_fold_kernel(const __grid_constant__ FoldMats mats, X* __restrict__ t,
                     int R, int kp, int s, int s_tile, int ring, int queue,
                     int bulk) {
  using A = typename SumOf<X>::type;
  constexpr bool kBf16Product = sizeof(X) == 2 && sizeof(V) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* full = reinterpret_cast<unsigned long long*>(smem);   // kGroups
  unsigned long long* empty = full + kGroups;                 // kGroups
  int* count = reinterpret_cast<int*>(empty + kGroups);       // kGroups
  A* acc = reinterpret_cast<A*>(count + kGroups);             // (kp, s_tile)
  X* rows = reinterpret_cast<X*>(acc + static_cast<size_t>(kp) *
                                           s_tile);           // (ring, s_tile)
  auto* q_slot = reinterpret_cast<Slot<A>*>(rows + static_cast<size_t>(ring) *
                                                       s_tile);
  int* q_row = reinterpret_cast<int*>(q_slot + queue);  // x row of the slot
  int* q_mat = q_row + queue;                           // its matrix (kMulti)
  // the x that queue entry e's row is read from
  auto x_of = [&](int e) {
    return static_cast<const X*>(mats.m[kMulti ? q_mat[e] : 0].x);
  };

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
    for (int r = 0; r < kp; ++r) acc[r * s_tile + tid] = A(0);
  __syncthreads();

  if (tid >= consumers) {
    // Producers. Warp 0 stages the window's live slots into the queue in
    // slot order, matrix by matrix, and publishes them a part at a time,
    // kGroups parts ahead of the fold: the part's slot count, and on the
    // bulk route its x rows, which both producer warps copy into the ring,
    // alternating rows.
    const int w = (tid - consumers) >> 5;
    const unsigned row_bytes = min(s_tile, s - s0) * sizeof(X);
    // the matrix warp 0 stages, mi (its slabs for this window are read
    // from the table at each round; without kMulti, matrix 0's fields are
    // plain kernel parameters)
    int mi = 0, staged = 0, queued = 0;  // mi's raw slots examined; queued
    auto mat = [&]() -> const FoldMat& { return mats.m[kMulti ? mi : 0]; };
    auto n_slots = [&]() { return mat().n_src * mat().L; };
    int pre_col[kStageK], pre_rid[kStageK];
    V pre_val[kStageK];
    auto load_round = [&](int j0) {  // raw slots of a round, one round ahead
      const FoldMat& fm = mat();
      const int ns = fm.n_src * fm.L;
      const size_t base = static_cast<size_t>(blockIdx.x) * ns;
      const V* vals = static_cast<const V*>(fm.vals);
      const RowId* rowid = static_cast<const RowId*>(fm.rowid);
#pragma unroll
      for (int k = 0; k < kStageK; ++k) {
        const int j = j0 + k * 32 + lane;
        pre_col[k] = -1;
        if (j < ns) {
          pre_col[k] = fm.cols[base + j];
          pre_rid[k] = static_cast<int>(rowid[base + j]);
          pre_val[k] = vals[base + j];
        }
      }
    };
    // Append the live slots of the round loaded last, in slot order, to
    // the queue (a warp ballot compacts them), and load the next round.
    auto stage = [&]() {
      int c_[kStageK], r_[kStageK];
      V v_[kStageK];
#pragma unroll
      for (int k = 0; k < kStageK; ++k) {
        c_[k] = pre_col[k];
        r_[k] = pre_rid[k];
        v_[k] = pre_val[k];
      }
      const int j0 = staged;
      const int ns = n_slots(), L = mat().L, n_cols = mat().n_cols;
      if (j0 + kRound < ns) load_round(j0 + kRound);
#pragma unroll
      for (int k = 0; k < kStageK; ++k) {
        const int j = j0 + k * 32 + lane;
        const int g = (j / L) * R + c_[k];  // c_ == R: sentinel
        const bool live = j < ns && c_[k] >= 0 && c_[k] < R &&
                          g < n_cols && r_[k] >= 0 && r_[k] < kp;
        const unsigned m = __ballot_sync(0xffffffffu, live);
        if (live) {
          const int e = (queued + __popc(m & ((1u << lane) - 1u))) & q_mask;
          q_slot[e] = Slot<A>{r_[k] * s_tile, widen(v_[k])};
          q_row[e] = g;
          if constexpr (kMulti) q_mat[e] = mi;
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
        while (queued < end && mi < mats.n) {
          if (staged < n_slots()) {
            stage();
          } else if (++mi < mats.n) {  // on to the next matrix's slots
            staged = 0;
            load_round(0);
          }
        }
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
        for (int i = kProducers * lane + w; i < n; i += 32 * kProducers) {
          const int e = (q * part + i) & q_mask;
          bulk_copy(rows + static_cast<size_t>(k * part + i) * s_tile,
                    x_of(e) + static_cast<size_t>(q_row[e]) * s + s0,
                    row_bytes, &full[k]);
        }
    }
    return;
  }

  // Consumers: thread tid folds column s0 + tid of every published part in
  // queue order, reading the rows from the ring (bulk) or from x.
  for (int q = 0;; ++q) {
    const int k = q % kGroups;
    mbar_wait(&full[k], (q / kGroups) & 1);
    const int n = count[k];
    if (n < 0) break;
    if (active) {
      const int lo = q * part;
      const X* src = rows + static_cast<size_t>(k) * part * s_tile + tid;
      for (int g = 0; g < n; g += kFoldUnroll) {
        A v[kFoldUnroll], p[kFoldUnroll];
        int off[kFoldUnroll];
#pragma unroll
        for (int u = 0; u < kFoldUnroll; ++u) {
          if (g + u < n) {
            const int e = (lo + g + u) & q_mask;
            const Slot<A> slot = q_slot[e];
            off[u] = slot.off;
            v[u] = slot.val;
            p[u] = widen(bulk ? src[(g + u) * s_tile]
                              : x_of(e)[static_cast<size_t>(q_row[e]) * s +
                                        col]);
          }
        }
#pragma unroll
        for (int u = 0; u < kFoldUnroll; ++u)
          if (g + u < n) acc[off[u] + tid] += product<kBf16Product>(v[u], p[u]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[k]);
  }
  if (!active) return;
  X* out = t + static_cast<size_t>(blockIdx.x) * kp * s + col;
  for (int r = 0; r < kp; ++r)
    out[static_cast<size_t>(r) * s] = narrow<X>(acc[r * s_tile + tid]);
}

// ---------------------------------------------------------------------------
// (c) fold_products
// ---------------------------------------------------------------------------

// D[w] = OH[w] . P[w] on the tensor cores: the one-hot (KP, Lt) times the
// window's products (Lt, S), bf16 operands, f32 sums. A block owns a
// (32 * WM, kProdN) tile of one window's output with WM * 2 warps, each
// warp a 32 x 64 tile (2 x 8 mma tiles of 16 x 8). The K loop walks the
// window's slots kProdK at a time through a ring of kProdStages stages,
// filled by cp.async kProdStages - 1 stages ahead of the warps that
// multiply: a stage whose loads wait behind the memory's latency while the
// block multiplies is what keeps the memory busy.
constexpr int kProdK = 32;               // slots per stage
constexpr int kProdN = 128;              // columns of S per block
constexpr int kProdStages = 4;           // ring depth
constexpr int kProdPitch = kProdN + 8;   // bf16 per plane row: the 16-byte
                                         // pad puts the 8 rows of an
                                         // ldmatrix on 8 distinct bank groups
constexpr int kWarpN = 64;               // columns per warp

// A stage of the ring holds its slots' products as loaded (a row of
// kProdN values and a 16-byte pad) and their row ids.
template <typename P>
constexpr int kRawPitch = kProdN * sizeof(P) + 16;  // bytes
template <typename P>
constexpr int kRawStage = kProdK * kRawPitch<P>;    // bytes

// Shared-memory bytes of a products block: the ring and its row ids, and
// for f32 products the three bf16 planes (hi, mid, lo) that a stage is
// split into before its products; bf16 products are multiplied from the
// ring as they are. products_layout in the wrapper budgets the same sum.
template <typename P>
constexpr size_t products_smem_bytes() {
  return kProdStages * (kRawStage<P> + kProdK * sizeof(int)) +
         (sizeof(P) == 2 ? 0 : 3 * kProdK * kProdPitch * 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           unsigned src_bytes) {
  // copies src_bytes (16 or 0) and fills the rest of the 16 with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ unsigned short bf16_bits(float v, float& rest) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  rest = v - __bfloat162float(h);
  return __bfloat16_as_ushort(h);
}

// A-fragment register of the one-hot: the bf16 pair (row m, slots k, k+1)
// is 1 where the slot's row id is m (dead slots hold -1).
__device__ __forceinline__ unsigned one_hot(int rid_k, int rid_k1, int m) {
  return (rid_k == m ? 0x3F80u : 0u) | (rid_k1 == m ? 0x3F800000u : 0u);
}

__device__ __forceinline__ void ldmatrix_x4_trans(const void* p,
                                                  unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid: x = window * m_tiles + the block's KP tile (a window's tiles run
// side by side and share its p in L2), y = the S tile.
template <typename P, int WM>
__global__ void __launch_bounds__(64 * WM)
fold_products_kernel(const int* __restrict__ rid, const P* __restrict__ p,
                     float* __restrict__ out, int lt, int kp, int s,
                     int m_tiles, bool vec) {
  constexpr int kThreads = 64 * WM;
  constexpr int kVec = 16 / sizeof(P);                  // values per chunk
  constexpr int kPerRow = kProdN / kVec;                // chunks per slot
  constexpr int kChunks = kProdK * kPerRow / kThreads;  // chunks per thread
  constexpr bool kSplit = sizeof(P) == 4;               // f32: three planes
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                           // kProdStages stages
  int* rid_ring = reinterpret_cast<int*>(ring + kProdStages * kRawStage<P>);
  auto* planes = reinterpret_cast<unsigned short*>(rid_ring +
                                                   kProdStages * kProdK);

  const int w = blockIdx.x / m_tiles;
  const int m0 = (blockIdx.x % m_tiles) * 32 * WM;
  const int n0 = blockIdx.y * kProdN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp % WM, warp_n = warp / WM;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = m0 + warp_m * 32 + g;  // the lane's first A/D row
  const int* rid_w = rid + static_cast<size_t>(w) * lt;
  const P* p_w = p + static_cast<size_t>(w) * lt * s;
  const int n_stages = (lt + kProdK - 1) / kProdK;

  // The row ids of the chunks this thread copies for a stage, loaded one
  // stage before its copies are issued and first read then, so that no
  // thread waits for them (slots past Lt: -1). Dead slots (outside
  // [0, kp)) and slots past Lt are staged as -1 and their products are not
  // read but zero-filled, so that even a non-finite one adds nothing.
  int rid_next[kChunks];
  auto fetch_rids = [&](int stage) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int slot = stage * kProdK + (tid + c * kThreads) / kPerRow;
      rid_next[c] = slot < lt ? __ldg(rid_w + slot) : -1;
    }
  };
  auto issue = [&](int stage) {
    if (stage < n_stages) {
      const int buf = stage % kProdStages;
      unsigned char* raw = ring + buf * kRawStage<P>;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int idx = tid + c * kThreads;
        const int k = idx / kPerRow, nl = (idx % kPerRow) * kVec;
        const int slot = stage * kProdK + k, n = n0 + nl;
        const int r = rid_next[c] >= 0 && rid_next[c] < kp ? rid_next[c] : -1;
        if (nl == 0) rid_ring[buf * kProdK + k] = r;
        unsigned char* dst = raw + k * kRawPitch<P> + nl * sizeof(P);
        const P* src = p_w + static_cast<size_t>(slot) * s + n;
        if (vec) {
          const bool read = r >= 0 && n < s;
          cp_async16(dst, read ? src : p_w, read ? 16u : 0u);
          continue;
        }
        // rows that are not whole 16-byte units: plain loads
        alignas(16) P v[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          v[i] = r >= 0 && n + i < s ? src[i] : P(0.0f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
    cp_async_commit();  // an empty group past the last stage keeps the count
  };

  float acc[2][8][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][j][i] = 0.0f;

  for (int st = 0; st < kProdStages - 1; ++st) {
    fetch_rids(st);
    issue(st);
  }
  fetch_rids(kProdStages - 1);
  // the lane's ldmatrix row: matrices 0-3 are (slots 0-7 | 8-15) x
  // (columns 0-7 | 8-15) of a 16 x 16 block
  const int ld_k = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ld_n = warp_n * kWarpN + 8 * (lane >> 4);
  for (int st = 0; st < n_stages; ++st) {
    const int buf = st % kProdStages;
    cp_async_wait<kProdStages - 2>();  // this thread's copies of stage st
    __syncthreads();  // everyone's; and stage st - 1 is multiplied
    issue(st + kProdStages - 1);       // into the buffer of stage st - 1
    fetch_rids(st + kProdStages);
    const int* rids = rid_ring + buf * kProdK;
    const unsigned char* raw = ring + buf * kRawStage<P>;
    const unsigned char* b_base = raw;
    int b_pitch = kRawPitch<P>;
    if constexpr (kSplit) {
      // split the stage's f32 products into the hi, mid and lo planes
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int idx = tid + c * kThreads;
        const int k = idx / kPerRow, nl = (idx % kPerRow) * kVec;
        const float4 v = *reinterpret_cast<const float4*>(
            raw + k * kRawPitch<P> + nl * sizeof(P));
        const float f[4] = {v.x, v.y, v.z, v.w};
        unsigned short h[4], m[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float rest, rest2;
          h[i] = bf16_bits(f[i], rest);
          m[i] = bf16_bits(rest, rest2);
          l[i] = bf16_bits(rest2, rest);
        }
        unsigned short* dst = planes + k * kProdPitch + nl;
        constexpr int plane = kProdK * kProdPitch;
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            h[0] | unsigned(h[1]) << 16, h[2] | unsigned(h[3]) << 16);
        *reinterpret_cast<uint2*>(dst + plane) = make_uint2(
            m[0] | unsigned(m[1]) << 16, m[2] | unsigned(m[3]) << 16);
        *reinterpret_cast<uint2*>(dst + 2 * plane) = make_uint2(
            l[0] | unsigned(l[1]) << 16, l[2] | unsigned(l[3]) << 16);
      }
      __syncthreads();
      b_base = reinterpret_cast<const unsigned char*>(planes);
      b_pitch = kProdPitch * 2;
    }
#pragma unroll
    for (int kk = 0; kk < kProdK; kk += 16) {
      const int r0 = rids[kk + 2 * q], r1 = rids[kk + 2 * q + 1];
      const int r8 = rids[kk + 2 * q + 8], r9 = rids[kk + 2 * q + 9];
      unsigned a[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int m = row0 + 16 * t;
        a[t][0] = one_hot(r0, r1, m);
        a[t][1] = one_hot(r0, r1, m + 8);
        a[t][2] = one_hot(r8, r9, m);
        a[t][3] = one_hot(r8, r9, m + 8);
      }
#pragma unroll
      for (int pl = 0; pl < (kSplit ? 3 : 1); ++pl) {
        const unsigned char* tile = b_base + pl * kProdK * kProdPitch * 2 +
                                    (kk + ld_k) * b_pitch + ld_n * 2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // n8 tiles 2j and 2j + 1
          unsigned b[4];
          ldmatrix_x4_trans(tile + 32 * j, b);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            mma_bf16(acc[t][2 * j], a[t], b[0], b[1]);
            mma_bf16(acc[t][2 * j + 1], a[t], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // D fragment: (row0 + 16t [+ 8], column 8j + 2q [+ 1]) of the warp's tile
  float* out_w = out + static_cast<size_t>(w) * kp * s;
  const bool pairs = s % 2 == 0;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 16 * t + 8 * h;
      if (m >= kp) continue;
      float* dst = out_w + static_cast<size_t>(m) * s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + warp_n * kWarpN + 8 * j + 2 * q;
        const float v0 = acc[t][j][2 * h], v1 = acc[t][j][2 * h + 1];
        if (pairs && n + 1 < s) {
          *reinterpret_cast<float2*>(dst + n) = make_float2(v0, v1);
        } else {
          if (n < s) dst[n] = v0;
          if (n + 1 < s) dst[n + 1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------------
// (b) window_strip, the tail; (d) double
// ---------------------------------------------------------------------------

// (b) the tail: see the note at the head of this file.
constexpr int kTailWarps = 8;     // warps per block
constexpr int kTailIters = 4;     // row groups a warp takes in a row block
constexpr int kTailSlots = 4;     // residue slots whose x rows load together
constexpr int kHeavyMin = 8;      // entries that make a row heavy: the
                                  // wrapper's TAIL_HEAVY_ENTRIES, by which
                                  // the upload lists the heavy rows
constexpr int kHeavyRound = 32;   // a heavy row's entries summed per round
constexpr int kHeavySlots = 8;    // slots whose x rows a heavy warp loads together
constexpr int kTailTile = 128;    // columns per pass of a heavy row's block

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

// A load that streams (evict-first: t, read once) or one through the
// read-only path (x rows and the residue list, which L2 may keep).
template <bool kStream, typename B>
__device__ __forceinline__ B load_bits(const void* p) {
  if constexpr (kStream)
    return __ldcs(static_cast<const B*>(p));
  else
    return __ldg(static_cast<const B*>(p));
}

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

// The bits of E values that hold values of T (widened to A).
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

// Each sum and product rounds once, as PyTorch's single operations do
// (no contraction into an FMA).
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// v rounded to T, held in the sums' type.
template <typename T>
__device__ __forceinline__ typename SumOf<T>::type round_to(
    typename SumOf<T>::type v) {
  return widen(narrow<T>(v));
}

// A residue slot's product in the promotion of x's type X and the values'
// type V (bf16 when both are, as windowed_fold forms it).
template <typename X, typename V, typename A>
__device__ __forceinline__ A tail_product(A xv, A vv) {
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
struct TailArgs {
  const T* t;          // (n_out, nw, k * p, s)
  T* y;                // (n_rows, s)
  const int* rowptr;   // (n_rows + 1): each row's residue entries; or null
  const int* entptr;   // (entries + 1): each entry's slots
  const int* cols;     // per slot: its row of x
  const V* vals;       // per slot: its value
  const T* x;          // (n_cols, s)
  const int* heavy;    // the rows with at least kHeavyMin entries
  const int* emat;     // per entry: its matrix, whose x it reads (multi)
  int n_rows, s, nw, p, k, n_heavy;
  int group;           // lanes per row (a power of two up to 32)
  int tile;            // columns per pass of a heavy row's block
};

// The x of each matrix of a multi-matrix strip, in the kernel's parameters.
template <typename T>
struct XTable {
  const T* p[kMaxMats];
};

// The x that entry e's slots read: the one x, or (kMulti) its matrix's.
template <bool kMulti, typename T, typename V>
__device__ __forceinline__ const T* entry_x(const TailArgs<T, V>& a,
                                            const XTable<T>& xs, int e) {
  if constexpr (kMulti)
    return xs.p[__ldg(a.emat + e)];
  else
    return a.x;
}

// The sum over an entry's live slots [q0, q1), in slot order, of the E
// columns of piece v (columns v * E ..) of their rows of x: kTailSlots rows
// in flight.
template <typename T, typename V, int E, typename A>
__device__ __forceinline__ void entry_sum(const TailArgs<T, V>& a,
                                          const T* x, int q0, int q1, int v,
                                          A (&sum)[E]) {
  using B = typename Bits<T, E>::type;
#pragma unroll
  for (int m = 0; m < E; ++m) sum[m] = A(0);
  for (int q = q0; q < q1; q += kTailSlots) {
    int c[kTailSlots];
    A val[kTailSlots];
    B xb[kTailSlots];
#pragma unroll
    for (int j = 0; j < kTailSlots; ++j)
      if (q + j < q1) {
        c[j] = __ldg(a.cols + q + j);
        val[j] = load_val<V, A>(a.vals + q + j);
      }
#pragma unroll
    for (int j = 0; j < kTailSlots; ++j)
      if (q + j < q1)
        xb[j] = load_bits<false, B>(x + static_cast<size_t>(c[j]) * a.s +
                                    static_cast<size_t>(v) * E);
#pragma unroll
    for (int j = 0; j < kTailSlots; ++j) {
      if (q + j >= q1) break;
      A xv[E];
      unpack<T, E>(xb[j], xv);
#pragma unroll
      for (int m = 0; m < E; ++m)
        sum[m] = add_rn(sum[m], tail_product<T, V>(xv[m], val[j]));
    }
  }
}

// Where row `row`'s window part 0 lies in t; part d lies `step` values
// further back for each d (window w - d, rows d * p ..).
template <typename T, typename V>
__device__ __forceinline__ const T* strip_base(const TailArgs<T, V>& a,
                                               long long row, int& nd,
                                               size_t& step) {
  const int r_chunk = a.nw * a.p;
  const int i = static_cast<int>(row / r_chunk);
  const int rem = static_cast<int>(row - static_cast<long long>(i) * r_chunk);
  const int w = rem / a.p, r = rem - w * a.p;
  const size_t kp = static_cast<size_t>(a.k) * a.p;
  nd = min(a.k, w + 1);
  step = (kp - a.p) * a.s;
  return a.t + ((static_cast<size_t>(i) * a.nw + w) * kp + r) * a.s;
}

// The rows of row block `block`: a group of a.group lanes per row, each
// lane owning E contiguous columns (16 bytes when E > 1) of every piece it
// covers, kTailIters rows a group. The first two addends of all of them are
// loaded together, and each row's residue pointers and the slot range of
// its first entry beside them; then row by row the addends are summed in
// order d = 0..K-1 and rounded once to T, the row's residue entries added
// in order (each sum rounded to T, and each add too), and the row stored
// once. Rows with kHeavyMin entries or more are left to the heavy blocks.
template <bool kMulti, typename T, typename V, int E>
__device__ __forceinline__ void tail_rows(const TailArgs<T, V>& a,
                                          const XTable<T>& xs, int block) {
  using A = typename SumOf<T>::type;
  using B = typename Bits<T, E>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows_per_warp = 32 / a.group;
  const int sub = lane / a.group, gl = lane - sub * a.group;
  const int nvec = a.s / E;
  long long row[kTailIters];
  int e0[kTailIters], e1[kTailIters], nd[kTailIters];
  const T* t0[kTailIters];
  size_t step = 0;
#pragma unroll
  for (int it = 0; it < kTailIters; ++it) {
    row[it] = (static_cast<long long>(block) * kTailIters * kTailWarps +
               it * kTailWarps + warp) * rows_per_warp + sub;
    e0[it] = e1[it] = nd[it] = 0;
    t0[it] = a.t;
    if (row[it] < a.n_rows) {
      t0[it] = strip_base(a, row[it], nd[it], step);
      if (a.rowptr != nullptr) {
        e0[it] = __ldg(a.rowptr + row[it]);
        e1[it] = __ldg(a.rowptr + row[it] + 1);
      }
    }
  }
  for (int v = gl; v < nvec; v += a.group) {
    const size_t off = static_cast<size_t>(v) * E;
    B part[kTailIters][2];
    int q0[kTailIters], q1[kTailIters];
#pragma unroll
    for (int it = 0; it < kTailIters; ++it) {
      if (nd[it] > 0) part[it][0] = load_bits<true, B>(t0[it] + off);
      if (nd[it] > 1) part[it][1] = load_bits<true, B>(t0[it] - step + off);
    }
#pragma unroll
    for (int it = 0; it < kTailIters; ++it)
      if (e1[it] > e0[it]) {
        q0[it] = __ldg(a.entptr + e0[it]);
        q1[it] = __ldg(a.entptr + e0[it] + 1);
      }
#pragma unroll
    for (int it = 0; it < kTailIters; ++it) {
      // past n_rows, or a heavy block's row
      if (nd[it] == 0 || e1[it] - e0[it] >= kHeavyMin) continue;
      A acc[E];
      unpack<T, E>(part[it][0], acc);
      for (int d = 1; d < nd[it]; ++d) {
        A add[E];
        unpack<T, E>(d == 1 ? part[it][1]
                            : load_bits<true, B>(t0[it] - d * step + off),
                     add);
#pragma unroll
        for (int m = 0; m < E; ++m) acc[m] = add_rn(acc[m], add[m]);
      }
#pragma unroll
      for (int m = 0; m < E; ++m) acc[m] = round_to<T>(acc[m]);
      for (int e = e0[it]; e < e1[it]; ++e) {
        A sum[E];
        const T* x = entry_x<kMulti>(a, xs, e);
        if (e == e0[it])
          entry_sum<T, V, E>(a, x, q0[it], q1[it], v, sum);
        else
          entry_sum<T, V, E>(a, x, __ldg(a.entptr + e),
                             __ldg(a.entptr + e + 1), v, sum);
#pragma unroll
        for (int m = 0; m < E; ++m)
          acc[m] = round_to<T>(add_rn(acc[m], round_to<T>(sum[m])));
      }
      __stcs(reinterpret_cast<B*>(a.y + row[it] * a.s + off),
             pack<T, E>(acc));
    }
  }
}

// An entry's sum as entry_sum forms it, by a whole warp for the pieces
// vb + lane of its row (lanes past nv idle but shuffle): the entry's slots
// read once, one (x row, value) a lane, and handed round by shuffles, so
// that only the x rows are loaded per slot, kHeavySlots at a time.
template <typename T, typename V, int E, typename A>
__device__ __forceinline__ void warp_entry_sum(const TailArgs<T, V>& a,
                                               const T* x, int q0, int q1,
                                               int v,
                                               bool active, int lane,
                                               A (&sum)[E]) {
  using B = typename Bits<T, E>::type;
#pragma unroll
  for (int m = 0; m < E; ++m) sum[m] = A(0);
  for (int qb = q0; qb < q1; qb += 32) {
    const int nq = min(32, q1 - qb);
    int col = 0;
    A val = A(0);
    if (lane < nq) {
      col = __ldg(a.cols + qb + lane);
      val = load_val<V, A>(a.vals + qb + lane);
    }
    for (int j0 = 0; j0 < nq; j0 += kHeavySlots) {
      B xb[kHeavySlots];
      A vv[kHeavySlots];
#pragma unroll
      for (int j = 0; j < kHeavySlots; ++j) {
        const int c = __shfl_sync(0xffffffffu, col, (j0 + j) & 31);
        vv[j] = __shfl_sync(0xffffffffu, val, (j0 + j) & 31);
        if (active && j0 + j < nq)
          xb[j] = load_bits<false, B>(x + static_cast<size_t>(c) * a.s +
                                      static_cast<size_t>(v) * E);
      }
      if (!active) continue;
#pragma unroll
      for (int j = 0; j < kHeavySlots; ++j) {
        if (j0 + j >= nq) break;
        A xv[E];
        unpack<T, E>(xb[j], xv);
#pragma unroll
        for (int m = 0; m < E; ++m)
          sum[m] = add_rn(sum[m], tail_product<T, V>(xv[m], vv[j]));
      }
    }
  }
}

// One row with kHeavyMin residue entries or more, by a whole block, a.tile
// columns at a time: the strip (one thread per column), then the entries
// kHeavyRound at a time (their slot ranges read in one load, one entry a
// lane), kHeavyRound / kTailWarps a warp, each entry's sum put in shared
// memory; after a barrier the thread that owns a column adds them to the
// row in entry order.
template <bool kMulti, typename T, typename V, int E>
__device__ __forceinline__ void tail_heavy(const TailArgs<T, V>& a,
                                           const XTable<T>& xs, int row) {
  using A = typename SumOf<T>::type;
  using B1 = typename Bits<T, 1>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A* part = reinterpret_cast<A*>(smem);   // (kHeavyRound, tile)
  A* yt = part + kHeavyRound * a.tile;    // (tile): the row, in T's values
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e0 = __ldg(a.rowptr + row), e1 = __ldg(a.rowptr + row + 1);
  int nd;
  size_t step;
  const T* t0 = strip_base(a, row, nd, step);
  for (int c0 = 0; c0 < a.s; c0 += a.tile) {
    const int width = min(a.tile, a.s - c0);
    const int nv = width / E;
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      A sum[1];
      unpack<T, 1>(load_bits<true, B1>(t0 + c0 + c), sum);
      for (int d = 1; d < nd; ++d) {
        A add[1];
        unpack<T, 1>(load_bits<true, B1>(t0 - d * step + c0 + c), add);
        sum[0] = add_rn(sum[0], add[0]);
      }
      yt[c] = round_to<T>(sum[0]);
    }
    for (int eb = e0; eb < e1; eb += kHeavyRound) {
      const int n = min(kHeavyRound, e1 - eb);
      int lo = 0, hi = 0;   // entry eb + lane's slots
      if (lane < n) {
        lo = __ldg(a.entptr + eb + lane);
        hi = __ldg(a.entptr + eb + lane + 1);
      }
      for (int j = warp; j < n; j += kTailWarps) {
        const int q0 = __shfl_sync(0xffffffffu, lo, j);
        const int q1 = __shfl_sync(0xffffffffu, hi, j);
        const T* x = entry_x<kMulti>(a, xs, eb + j);
        for (int vb = 0; vb < nv; vb += 32) {
          const int v = vb + lane;
          A sum[E];
          warp_entry_sum<T, V, E>(a, x, q0, q1, c0 / E + v, v < nv, lane,
                                  sum);
          if (v < nv) {
#pragma unroll
            for (int m = 0; m < E; ++m) part[j * a.tile + v * E + m] = sum[m];
          }
        }
      }
      __syncthreads();
      for (int c = threadIdx.x; c < width; c += blockDim.x) {
        A yv = yt[c];
        for (int j = 0; j < n; ++j)
          yv = round_to<T>(add_rn(yv, round_to<T>(part[j * a.tile + c])));
        yt[c] = yv;
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      const A v[1] = {yt[c]};
      __stcs(reinterpret_cast<B1*>(a.y + static_cast<size_t>(row) * a.s +
                                   c0 + c),
             pack<T, 1>(v));
    }
  }
}

// Blocks [0, n_heavy) take one heavy row each, the longest rows first, so
// that they start first; the others kTailIters * kTailWarps row groups
// each; `vec`: 16-byte pieces (every row of t, y and x 16-byte aligned),
// else one value a lane. kMulti: the strip of a multi-matrix fold, whose
// residue list is every matrix's, each entry reading its matrix's x (xs,
// by a.emat).
template <bool kMulti, typename T, typename V>
__global__ void __launch_bounds__(32 * kTailWarps, 2)
window_strip_kernel(const TailArgs<T, V> a, int vec,
                    const __grid_constant__ XTable<T> xs) {
  constexpr int kVec = 16 / sizeof(T);
  const int b = static_cast<int>(blockIdx.x);
  if (b < a.n_heavy) {
    const int row = __ldg(a.heavy + b);
    if (vec)
      tail_heavy<kMulti, T, V, kVec>(a, xs, row);
    else
      tail_heavy<kMulti, T, V, 1>(a, xs, row);
  } else if (vec) {
    tail_rows<kMulti, T, V, kVec>(a, xs, b - a.n_heavy);
  } else {
    tail_rows<kMulti, T, V, 1>(a, xs, b - a.n_heavy);
  }
}

// ---------------------------------------------------------------------------
// (e) fold_strip_multi: the fused multi-matrix SpMM, fold and tail in one
// ---------------------------------------------------------------------------

// The leading heavy row of the window whose first row is row0: the row with
// the most residue entries (kHeavyMin at least), the lower row of a tie, or
// -1. The wrapper's heavy list (most entries first, ties by row) names each
// window's leading row before its other heavy rows. By a whole warp.
template <typename T, typename V>
__device__ __forceinline__ int leading_heavy(const TailArgs<T, V>& a,
                                             long long row0, int lane) {
  long long best = -1;  // (entries << 32) | (INT_MAX - row)
  for (int r = lane; r < a.p && row0 + r < a.n_rows; r += 32) {
    const long long row = row0 + r;
    const int n = __ldg(a.rowptr + row + 1) - __ldg(a.rowptr + row);
    if (n >= kHeavyMin)
      best = max(best, static_cast<long long>(n) << 32 |
                           (0x7fffffff - static_cast<int>(row)));
  }
  for (int o = 16; o > 0; o >>= 1)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, o));
  return best < 0 ? -1 : 0x7fffffff - static_cast<int>(best & 0xffffffff);
}

constexpr int kStripWarps = 8;   // warps of a fold_strip block
constexpr int kEntryRound = 16;  // a heavy row's entries summed per round
constexpr int kSlotUnroll = 4;   // x pieces a lane loads together
constexpr int kStageRounds = 4;  // raw slots a lane stages together
constexpr int kSrcBits = 27;     // a staged slot's x row, below its matrix

// The bits of kBytes bytes, loaded or stored in one access.
template <int kBytes>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

// The E values of T at p (E * sizeof(T) bytes, aligned to that), widened.
template <typename T, int E, typename A>
__device__ __forceinline__ void load_piece(const T* p, A (&v)[E]) {
  using B = typename Raw<E * sizeof(T)>::type;
  const B b = __ldg(reinterpret_cast<const B*>(p));
  const T* t = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int m = 0; m < E; ++m) v[m] = widen(t[m]);
}

template <typename T, int E, typename A>
__device__ __forceinline__ void store_piece(T* p, const A (&v)[E]) {
  using B = typename Raw<E * sizeof(T)>::type;
  B b;
  T* t = reinterpret_cast<T*>(&b);
#pragma unroll
  for (int m = 0; m < E; ++m) t[m] = narrow<T>(v[m]);
  *reinterpret_cast<B*>(p) = b;
}

// Shared-memory bytes of a fold_strip block: per raw slot of a window (up
// to n_cap) its staged value (A) and row id, x row and sorted place (three
// ints); a round of a heavy row's entry sums (kEntryRound rows of the
// tile); the row ids' counts and starts and the scatter's cursors
// (2 kp + 1 ints), each warp's staged count, a word for the leading heavy
// row and the window's rows' first residue entries (P + 1 ints, P = kp / K
// at most kp). fold_strip_layout in the wrapper budgets the same sum.
template <typename X>
size_t fold_strip_smem_bytes(int kp, int n_cap, int tile) {
  using A = typename SumOf<X>::type;
  return (static_cast<size_t>(n_cap) + static_cast<size_t>(kEntryRound) *
                                           tile) * sizeof(A) +
         (3 * static_cast<size_t>(n_cap) + 3 * kp + 2 + kStripWarps + 1) *
             sizeof(int);
}

// One residue entry's sum over its slots, in slot order, of the lane's E
// columns (x + c * s + col) of their rows of x, by a whole warp (lanes
// past the columns idle but shuffle): each slot's (x row, value) loaded by
// one lane and handed round, kSlotUnroll x pieces in flight.
template <typename X, typename V, int E, typename A>
__device__ __forceinline__ void strip_entry(const TailArgs<X, V>& a,
                                            const X* x, int q0, int q1,
                                            int col, bool active, int lane,
                                            A (&sum)[E]) {
#pragma unroll
  for (int m = 0; m < E; ++m) sum[m] = A(0);
  for (int qb = q0; qb < q1; qb += 32) {
    const int nq = min(32, q1 - qb);
    int c = 0;
    A w = A(0);
    if (lane < nq) {
      c = __ldg(a.cols + qb + lane);
      w = load_val<V, A>(a.vals + qb + lane);
    }
    for (int j0 = 0; j0 < nq; j0 += kSlotUnroll) {
      A xp[kSlotUnroll][E], wv[kSlotUnroll];
#pragma unroll
      for (int j = 0; j < kSlotUnroll; ++j) {
        const int cj = __shfl_sync(0xffffffffu, c, (j0 + j) & 31);
        wv[j] = __shfl_sync(0xffffffffu, w, (j0 + j) & 31);
        if (active && j0 + j < nq)
          load_piece<X, E>(x + static_cast<size_t>(cj) * a.s + col, xp[j]);
      }
#pragma unroll
      for (int j = 0; j < kSlotUnroll; ++j) {
        if (j0 + j >= nq) break;
#pragma unroll
        for (int m = 0; m < E; ++m)
          sum[m] = add_rn(sum[m], tail_product<X, V>(xp[j][m], wv[j]));
      }
    }
  }
}

// y = sum_m A_m @ x_m for the P rows of one window and an S tile of 32 E
// columns, written once: what window_strip(windowed_fold_multi) gives, bit
// for bit (see the note at the head of this file). Blocks [0, n_heavy) take
// the windows of the heavy rows, most entries first, each window by the
// block of its leading heavy row (the others return); the rest take the
// windows in order, skipping those. a: the merged residue list (rowptr
// null: none), y, n_rows, S, NW, P and K (a.t, a.x, a.group and a.tile are
// not read). n_cap: the most raw slots a window has (K times the matrices'
// slots of one window), which sizes the staging in shared memory.
template <typename X, typename V, typename RowId, int E>
__global__ void __launch_bounds__(32 * kStripWarps, 4)
fold_strip_kernel(const __grid_constant__ FoldMats mats,
                  const __grid_constant__ TailArgs<X, V> a, int R,
                  int n_cap) {
  using A = typename SumOf<X>::type;
  constexpr bool kBf16Product = sizeof(X) == 2 && sizeof(V) == 2;
  constexpr int kTile = 32 * E;
  constexpr int kSrcMask = (1 << kSrcBits) - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.p, kp = a.k * a.p, s = a.s;
  A* val = reinterpret_cast<A*>(smem);         // n_cap: staged values
  A* sums = val + n_cap;                       // (kEntryRound, kTile)
  int* key = reinterpret_cast<int*>(sums + kEntryRound * kTile);  // row ids
  int* src = key + n_cap;                      // x row | matrix << kSrcBits
  int* order = src + n_cap;                    // staged slots by row id
  int* start = order + n_cap;                  // kp + 1: row ids' starts
  int* cursor = start + kp + 1;                // kp: the scatter's cursors
  int* staged = cursor + kp;                   // kStripWarps: staged counts
  int* lead_word = staged + kStripWarps;
  int* rp = lead_word + 1;                     // P + 1: the rows' entries

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.y * kTile;
  const int col = s0 + E * lane;  // the lane's first column
  const bool active = col < s;
  const int b = static_cast<int>(blockIdx.x);
  const int win = b < a.n_heavy ? __ldg(a.heavy + b) / P : b - a.n_heavy;
  const long long row0 = static_cast<long long>(win) * P;
  if (row0 >= a.n_rows) return;
  const int n_here = static_cast<int>(min(static_cast<long long>(P),
                                          a.n_rows - row0));
  int e_lo = 0, e_hi = 0;  // the window's residue entries
  if (a.rowptr != nullptr) {
    e_lo = __ldg(a.rowptr + row0);
    e_hi = __ldg(a.rowptr + row0 + n_here);
  }
  for (int i = tid; i <= kp; i += blockDim.x) start[i] = 0;
  if (a.rowptr != nullptr)
    for (int i = tid; i <= n_here; i += blockDim.x)
      rp[i] = __ldg(a.rowptr + row0 + i);
  // A window that holds a heavy row holds kHeavyMin entries at least, and
  // is folded by the block of its leading heavy row, among the first
  // n_heavy; the other blocks return.
  const bool heavy_here = e_hi - e_lo >= kHeavyMin;
  if (heavy_here && warp == 0) {
    const int l = leading_heavy(a, row0, lane);
    if (lane == 0) *lead_word = l;
  }
  __syncthreads();
  if (heavy_here) {
    const int lead = *lead_word;
    if (b < a.n_heavy ? lead != __ldg(a.heavy + b) : lead >= 0) return;
  }

  // Staging. The window's raw slots are one stream: the segments (d, m),
  // d-major, each the slots of matrix m in window w - d in slot order; a
  // slot is live where its row id lies in [d P, d P + P) (the rows of part
  // d of the window's sums). Warp w stages a contiguous range of it,
  // compacting its live slots (a ballot) from the range's start, in stream
  // order, and counts each row id.
  const int nd = min(a.k, win % a.nw + 1);
  int per_window = 0;  // raw slots of one window, over the matrices
  for (int m = 0; m < mats.n; ++m) per_window += mats.m[m].n_src * mats.m[m].L;
  const int n_raw = nd * per_window;
  const int chunk = ((n_raw + kStripWarps - 1) / kStripWarps + 31) / 32 * 32;
  const int t_lo = warp * chunk, t_hi = min(n_raw, t_lo + chunk);
  int n_live = 0;
  for (int t0 = t_lo; t0 < t_hi; t0 += 32 * kStageRounds) {
    int c_[kStageRounds], r_[kStageRounds], g_[kStageRounds],
        m_[kStageRounds], lo_[kStageRounds];
    V v_[kStageRounds];
#pragma unroll
    for (int k = 0; k < kStageRounds; ++k) {
      const int t = t0 + k * 32 + lane;
      c_[k] = -1;
      g_[k] = m_[k] = lo_[k] = 0;
      if (t < t_hi) {
        const int d = t / per_window;
        int jj = t - d * per_window, m = 0;
        while (jj >= mats.m[m].n_src * mats.m[m].L) {
          jj -= mats.m[m].n_src * mats.m[m].L;
          ++m;
        }
        const FoldMat& fm = mats.m[m];
        const size_t at = static_cast<size_t>(win - d) * (fm.n_src * fm.L) + jj;
        c_[k] = fm.cols[at];
        r_[k] = static_cast<int>(static_cast<const RowId*>(fm.rowid)[at]);
        v_[k] = static_cast<const V*>(fm.vals)[at];
        g_[k] = (jj / fm.L) * R;
        m_[k] = m;
        lo_[k] = d * P;
      }
    }
#pragma unroll
    for (int k = 0; k < kStageRounds; ++k) {
      const int g = g_[k] + c_[k];  // c_ == R: sentinel
      const bool live = c_[k] >= 0 && c_[k] < R &&
                        g < mats.m[m_[k]].n_cols && r_[k] >= lo_[k] &&
                        r_[k] < lo_[k] + P;
      const unsigned bits = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int pos = t_lo + n_live + __popc(bits & ((1u << lane) - 1u));
        val[pos] = widen(v_[k]);
        key[pos] = r_[k];
        src[pos] = g | m_[k] << kSrcBits;
        atomicAdd(&start[r_[k]], 1);
      }
      n_live += __popc(bits);
    }
  }
  if (lane == 0) staged[warp] = n_live;
  __syncthreads();

  // The stable counting sort by row id (warp 0): the counts' exclusive scan
  // into start (start[kp]: the live slots), then the staged slots in
  // stream order (warp by warp), each placed after the earlier slots of its
  // row id (the lanes of one row id ranked by match_any).
  if (warp == 0) {
    const int per_lane = (kp + 32) / 32;  // kp + 1 entries
    int sum = 0;
    for (int i = lane * per_lane; i < min(kp + 1, (lane + 1) * per_lane); ++i)
      sum += start[i];
    int before = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, before, o);
      if (lane >= o) before += n;
    }
    before -= sum;  // the lanes before this one
    for (int i = lane * per_lane; i < min(kp + 1, (lane + 1) * per_lane); ++i) {
      const int n = start[i];
      start[i] = before;
      if (i < kp) cursor[i] = before;
      before += n;
    }
    __syncwarp();
    for (int w = 0; w < kStripWarps; ++w) {
      const int lo = w * chunk, hi = lo + staged[w];
      for (int i0 = lo; i0 < hi; i0 += 32) {
        const int i = i0 + lane;
        const int k = i < hi ? key[i] : -1 - lane;  // distinct when idle
        const unsigned peers = __match_any_sync(0xffffffffu, k);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        int pos = 0;
        if (i < hi) pos = cursor[k] + rank;
        __syncwarp();
        if (i < hi) {
          order[pos] = i;
          if (lane == 31 - __clz(peers)) cursor[k] = pos + 1;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // A row's sum by one warp, each lane its E columns: part d sums the
  // slots of row id d P + r in stream order, in registers, by the fold's
  // own expression, and is rounded to X (the window tensor's value); the
  // parts are added in order d = 0..nd-1 and rounded once.
  auto fold_row = [&](int r, A (&v)[E]) {
    for (int d = 0; d < nd; ++d) {
      const int k0 = start[d * P + r], k1 = start[d * P + r + 1];
      A acc[E];
#pragma unroll
      for (int m = 0; m < E; ++m) acc[m] = A(0);
      for (int i = k0; i < k1; i += kSlotUnroll) {
        A p[kSlotUnroll][E], w[kSlotUnroll];
#pragma unroll
        for (int u = 0; u < kSlotUnroll; ++u) {
          if (i + u < k1) {
            const int q = order[i + u];
            const int g = src[q];
            w[u] = val[q];
            if (active)
              load_piece<X, E>(static_cast<const X*>(mats.m[g >> kSrcBits].x) +
                                   static_cast<size_t>(g & kSrcMask) * s + col,
                               p[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kSlotUnroll; ++u)
          if (i + u < k1) {
#pragma unroll
            for (int m = 0; m < E; ++m)
              acc[m] += product<kBf16Product>(w[u], p[u][m]);
          }
      }
#pragma unroll
      for (int m = 0; m < E; ++m) {
        const A t = widen(narrow<X>(acc[m]));
        v[m] = d == 0 ? t : add_rn(v[m], t);
      }
    }
#pragma unroll
    for (int m = 0; m < E; ++m) v[m] = round_to<X>(v[m]);
  };
  auto entry_x = [&](int e) {
    return static_cast<const X*>(mats.m[__ldg(a.emat + e)].x);
  };

  // Rows with fewer than kHeavyMin residue entries: a warp a row, its
  // entries added in order, each sum rounded and each add too.
  for (int r = warp; r < n_here; r += kStripWarps) {
    const long long row = row0 + r;
    int e0 = 0, e1 = 0;
    if (a.rowptr != nullptr) {
      e0 = rp[r];
      e1 = rp[r + 1];
    }
    if (e1 - e0 >= kHeavyMin) continue;
    A v[E];
    fold_row(r, v);
    for (int e = e0; e < e1; ++e) {
      A sum[E];
      strip_entry<X, V, E>(a, entry_x(e), __ldg(a.entptr + e),
                           __ldg(a.entptr + e + 1), col, active, lane, sum);
#pragma unroll
      for (int m = 0; m < E; ++m)
        v[m] = round_to<X>(add_rn(v[m], round_to<X>(sum[m])));
    }
    if (active) store_piece<X, E>(a.y + row * s + col, v);
  }
  if (!heavy_here) return;
  // Heavy rows, one at a time: warp 0 folds the row; every warp sums
  // entries, kEntryRound a round, into shared memory; warp 0 adds them in
  // entry order and writes the row.
  for (int r = 0; r < n_here; ++r) {
    const long long row = row0 + r;
    const int e0 = rp[r], e1 = rp[r + 1];
    if (e1 - e0 < kHeavyMin) continue;
    A v[E];
    if (warp == 0) fold_row(r, v);
    for (int eb = e0; eb < e1; eb += kEntryRound) {
      const int ne = min(kEntryRound, e1 - eb);
      __syncthreads();  // the previous round's sums are added
      for (int j = warp; j < ne; j += kStripWarps) {
        A sum[E];
        strip_entry<X, V, E>(a, entry_x(eb + j), __ldg(a.entptr + eb + j),
                             __ldg(a.entptr + eb + j + 1), col, active, lane,
                             sum);
#pragma unroll
        for (int m = 0; m < E; ++m) sums[j * kTile + E * lane + m] = sum[m];
      }
      __syncthreads();
      if (warp == 0)
        for (int j = 0; j < ne; ++j)
#pragma unroll
          for (int m = 0; m < E; ++m)
            v[m] = round_to<X>(
                add_rn(v[m], round_to<X>(sums[j * kTile + E * lane + m])));
    }
    if (warp == 0 && active) store_piece<X, E>(a.y + row * s + col, v);
  }
}

// (d) y = 2 x.
__global__ void double_kernel(const float* __restrict__ x,
                              float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = 2.0f * x[i];
}

// An empty kernel, one warp: it replaces no TPU kernel and computes
// nothing. Its device time is the least any launch takes on the card, the
// bound of a kernel whose bytes take less (double at (8, 128): 8 KB moved,
// under 0.00001 ms at 3.35 TB/s); chip_smoke.py times it beside double.
__global__ void launch_floor_kernel() {}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int threads_for(int s_tile) { return 32 * ((s_tile + 31) / 32); }

// The launch of a fold of mats.n matrices; the caller fills the table.
template <bool kMulti, typename X, typename V, typename RowId>
int launch_fold(const FoldMats& mats, void* t, int n_windows, int R, int kp,
                int s, int s_tile, int ring, int queue, void* stream) {
  // the kernel's contract with fold_layout: at most 128 folding threads,
  // whole ring parts, and a queue that outlasts the ring plus one staging
  // round; a block that asks for more shared memory than the card has
  // fails in allow_smem
  if (mats.n < 1 || mats.n > kMaxMats || s_tile < 1 || s_tile > 128 ||
      ring < kGroups || ring % kGroups || queue < ring + kRound ||
      (queue & (queue - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fold_smem_bytes<kMulti, X>(kp, s_tile, ring, queue);
  // bulk copies need 16-byte-aligned rows of whole 16-byte units
  bool aligned = true;
  for (int m = 0; m < mats.n; ++m)
    aligned = aligned && reinterpret_cast<size_t>(mats.m[m].x) % 16 == 0;
  const int bulk = aligned && s * sizeof(X) % 16 == 0 &&
                   s_tile * sizeof(X) % 16 == 0;
  auto kernel = windowed_fold_kernel<kMulti, X, V, RowId>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_windows, (s + s_tile - 1) / s_tile);
  kernel<<<grid, threads_for(s_tile) + 32 * kProducers, smem,
           static_cast<cudaStream_t>(stream)>>>(mats, static_cast<X*>(t), R,
                                                kp, s, s_tile, ring, queue,
                                                bulk);
  return static_cast<int>(cudaGetLastError());
}

// The single-matrix fold: a table of one.
template <typename X, typename V, typename RowId>
int launch_fold_one(const void* cols, const void* vals, const void* rowid,
                    const void* x, void* t, int n_windows, int n_src, int L,
                    int R, int kp, int n_cols, int s, int s_tile, int ring,
                    int queue, void* stream) {
  FoldMats mats{};
  mats.n = 1;
  mats.m[0] = FoldMat{static_cast<const int*>(cols), vals, rowid, x,
                      n_src, L, n_cols, 0};
  return launch_fold<false, X, V, RowId>(mats, t, n_windows, R, kp, s, s_tile,
                                         ring, queue, stream);
}

// The kernel parameters' table of n_mats (1 to kMaxMats) matrices from the
// wrapper's: per matrix, 7 int64 (cols, vals, rowid and x as addresses,
// n_src, L, n_cols).
FoldMats fold_mats(const long long* table, int n_mats) {
  FoldMats mats{};
  mats.n = n_mats;
  for (int m = 0; m < n_mats; ++m) {
    const long long* e = table + 7 * m;
    mats.m[m] = FoldMat{reinterpret_cast<const int*>(e[0]),
                        reinterpret_cast<const void*>(e[1]),
                        reinterpret_cast<const void*>(e[2]),
                        reinterpret_cast<const void*>(e[3]),
                        static_cast<int>(e[4]), static_cast<int>(e[5]),
                        static_cast<int>(e[6]), 0};
  }
  return mats;
}

// The multi-matrix fold: the wrapper's table copied into the kernel's
// parameters.
template <typename X, typename V, typename RowId>
int launch_fold_multi(const long long* table, void* t, int n_mats,
                      int n_windows, int R, int kp, int s, int s_tile,
                      int ring, int queue, void* stream) {
  if (n_mats < 1 || n_mats > kMaxMats)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fold<true, X, V, RowId>(fold_mats(table, n_mats), t,
                                        n_windows, R, kp, s, s_tile, ring,
                                        queue, stream);
}

template <typename P>
int launch_products(const void* rid, const void* p, void* out, int nw,
                    int lt, int kp, int s, int block_m, void* stream) {
  // the kernel's contract with products_layout: a KP tile of 64, 128 or
  // 256 rows
  if (block_m != 64 && block_m != 128 && block_m != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m_tiles = (kp + block_m - 1) / block_m;
  const dim3 grid(nw * m_tiles, (s + kProdN - 1) / kProdN);
  // 16-byte loads need 16-byte-aligned rows of whole 16-byte units
  const bool vec = reinterpret_cast<size_t>(p) % 16 == 0 &&
                   s * sizeof(P) % 16 == 0;
  constexpr size_t smem = products_smem_bytes<P>();
  auto kernel = block_m == 64    ? fold_products_kernel<P, 2>
                : block_m == 128 ? fold_products_kernel<P, 4>
                                 : fold_products_kernel<P, 8>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 2 * block_m, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rid), static_cast<const P*>(p),
      static_cast<float*>(out), lt, kp, s, m_tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

// The fused multi-matrix SpMM: the table as launch_fold_multi's; the merged
// residue list (rowptr null: none) and its heavy rows; vec: pieces of kE
// values of x and y (16 bytes, 8 in bf16), whose rows are aligned to them; n_cap: the most
// raw slots a window has, K times the matrices' slots of one window.
template <typename X, typename V, typename RowId>
int launch_fold_strip(const long long* table, void* y, const void* rowptr,
                      const void* entptr, const void* cols, const void* vals,
                      const void* emat, const void* heavy, int n_mats,
                      int n_heavy, int n_out, int nw, int R, int P, int K,
                      int n_rows, int s, int vec, int n_cap, void* stream) {
  constexpr int kE = 16 / (sizeof(X) < 4 ? 4 : sizeof(X));
  if (n_mats < 1 || n_mats > kMaxMats || P < 1 || K < 1 || n_rows < 1 ||
      s < 1 || n_heavy < 0 || (rowptr == nullptr && n_heavy > 0) ||
      (rowptr != nullptr && emat == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = n_heavy + static_cast<long long>(n_out) * nw;
  if (items > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const FoldMats mats = fold_mats(table, n_mats);
  long long per_window = 0;
  bool aligned = reinterpret_cast<size_t>(y) % (kE * sizeof(X)) == 0;
  for (int m = 0; m < n_mats; ++m) {
    per_window += static_cast<long long>(mats.m[m].n_src) * mats.m[m].L;
    aligned = aligned &&
              reinterpret_cast<size_t>(mats.m[m].x) % (kE * sizeof(X)) == 0;
    // a staged slot keeps its x row below its matrix in one int
    if (mats.m[m].n_cols > (1 << kSrcBits))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (K * per_window > n_cap || (vec && (!aligned || s % kE)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = 32 * (vec ? kE : 1);
  const TailArgs<X, V> a{
      nullptr, static_cast<X*>(y), static_cast<const int*>(rowptr),
      static_cast<const int*>(entptr), static_cast<const int*>(cols),
      static_cast<const V*>(vals), nullptr, static_cast<const int*>(heavy),
      static_cast<const int*>(emat), n_rows, s, nw, P, K, n_heavy, 0, 0};
  const size_t smem = fold_strip_smem_bytes<X>(K * P, n_cap, tile);
  auto kernel = vec ? fold_strip_kernel<X, V, RowId, kE>
                    : fold_strip_kernel<X, V, RowId, 1>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(items), (s + tile - 1) / tile);
  kernel<<<grid, 32 * kStripWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      mats, a, R, n_cap);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMulti, typename T, typename V>
int launch_strip(const void* t, void* y, const void* rowptr,
                 const void* entptr, const void* cols, const void* vals,
                 const void* x, const void* heavy, const void* emat,
                 const long long* x_table, int n_x, int n_rows, int s,
                 int nw, int p, int k, int n_heavy, void* stream) {
  using A = typename SumOf<T>::type;
  constexpr int kVec = 16 / sizeof(T);
  if (n_rows < 1 || s < 1 || n_heavy < 0 ||
      (n_heavy > 0 && rowptr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* q) {
    return reinterpret_cast<size_t>(q) % 16 == 0;
  };
  XTable<T> xs{};
  if (kMulti) {
    if (n_x < 1 || n_x > kMaxMats || emat == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int m = 0; m < n_x; ++m)
      xs.p[m] = reinterpret_cast<const T*>(x_table[m]);
  }
  bool x_aligned = x == nullptr || aligned(x);
  for (int m = 0; kMulti && m < n_x; ++m) x_aligned &= aligned(xs.p[m]);
  const int vec = s % kVec == 0 && aligned(t) && aligned(y) && x_aligned;
  const int nvec = vec ? s / kVec : s;
  int group = 1;
  while (group < 32 && group < nvec) group *= 2;
  const long long rows_per_block =
      static_cast<long long>(kTailWarps) * kTailIters * (32 / group);
  const long long blocks =
      n_heavy + (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  // a heavy row's pass: a multiple of the piece, since s is one where
  // vec holds and kTailTile is one of every piece
  const int tile = s < kTailTile ? s : kTailTile;
  const size_t smem =
      n_heavy ? (kHeavyRound + 1) * static_cast<size_t>(tile) * sizeof(A) : 0;
  const TailArgs<T, V> a{
      static_cast<const T*>(t),      static_cast<T*>(y),
      static_cast<const int*>(rowptr), static_cast<const int*>(entptr),
      static_cast<const int*>(cols), static_cast<const V*>(vals),
      static_cast<const T*>(x),      static_cast<const int*>(heavy),
      static_cast<const int*>(emat),
      n_rows, s, nw, p, k, n_heavy, group, tile};
  window_strip_kernel<kMulti, T, V>
      <<<static_cast<unsigned>(blocks), 32 * kTailWarps, smem,
         static_cast<cudaStream_t>(stream)>>>(a, vec, xs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One instance per (x type, values type) that the wrapper's _FOLD_TYPES
// names, each for uint8 and int32 row ids, and the shared-memory count of
// each x type (the values' type does not change it).
#define WINDOWED_FOLD(NAME, X, V, ROWID)                                     \
  extern "C" int NAME(const void* cols, const void* vals, const void* rowid, \
                      const void* x, void* t, int n_windows, int n_src,      \
                      int L, int R, int kp, int n_cols, int s, int s_tile,   \
                      int ring, int queue, void* stream) {                   \
    return launch_fold_one<X, V, ROWID>(cols, vals, rowid, x, t, n_windows,  \
                                        n_src, L, R, kp, n_cols, s, s_tile,  \
                                        ring, queue, stream);                \
  }
#define FOLD_SMEM_BYTES(NAME, X)                                             \
  extern "C" int NAME(int kp, int s_tile, int ring, int queue) {             \
    return static_cast<int>(                                                 \
        fold_smem_bytes<false, X>(kp, s_tile, ring, queue));                 \
  }

WINDOWED_FOLD(windowed_fold_f32_u8, float, float, unsigned char)
WINDOWED_FOLD(windowed_fold_f32_i32, float, float, int)
WINDOWED_FOLD(windowed_fold_f64_u8, double, double, unsigned char)
WINDOWED_FOLD(windowed_fold_f64_i32, double, double, int)
WINDOWED_FOLD(windowed_fold_bf16_f32_u8, __nv_bfloat16, float, unsigned char)
WINDOWED_FOLD(windowed_fold_bf16_f32_i32, __nv_bfloat16, float, int)
WINDOWED_FOLD(windowed_fold_bf16_u8, __nv_bfloat16, __nv_bfloat16,
              unsigned char)
WINDOWED_FOLD(windowed_fold_bf16_i32, __nv_bfloat16, __nv_bfloat16, int)
WINDOWED_FOLD(windowed_fold_f32_bf16_u8, float, __nv_bfloat16, unsigned char)
WINDOWED_FOLD(windowed_fold_f32_bf16_i32, float, __nv_bfloat16, int)

FOLD_SMEM_BYTES(windowed_fold_smem_bytes_f32, float)
FOLD_SMEM_BYTES(windowed_fold_smem_bytes_f64, double)
FOLD_SMEM_BYTES(windowed_fold_smem_bytes_bf16, __nv_bfloat16)

// The multi-matrix fold, for the same (x type, values type) pairs.
#define WINDOWED_FOLD_MULTI(NAME, X, V, ROWID)                               \
  extern "C" int NAME(const void* table, void* t, int n_mats,                \
                      int n_windows, int R, int kp, int s, int s_tile,       \
                      int ring, int queue, void* stream) {                   \
    return launch_fold_multi<X, V, ROWID>(                                   \
        static_cast<const long long*>(table), t, n_mats, n_windows, R, kp,   \
        s, s_tile, ring, queue, stream);                                     \
  }
#define FOLD_MULTI_SMEM_BYTES(NAME, X)                                       \
  extern "C" int NAME(int kp, int s_tile, int ring, int queue) {             \
    return static_cast<int>(                                                 \
        fold_smem_bytes<true, X>(kp, s_tile, ring, queue));                  \
  }

WINDOWED_FOLD_MULTI(windowed_fold_multi_f32_u8, float, float, unsigned char)
WINDOWED_FOLD_MULTI(windowed_fold_multi_f32_i32, float, float, int)
WINDOWED_FOLD_MULTI(windowed_fold_multi_f64_u8, double, double,
                    unsigned char)
WINDOWED_FOLD_MULTI(windowed_fold_multi_f64_i32, double, double, int)
WINDOWED_FOLD_MULTI(windowed_fold_multi_bf16_f32_u8, __nv_bfloat16, float,
                    unsigned char)
WINDOWED_FOLD_MULTI(windowed_fold_multi_bf16_f32_i32, __nv_bfloat16, float,
                    int)
WINDOWED_FOLD_MULTI(windowed_fold_multi_bf16_u8, __nv_bfloat16,
                    __nv_bfloat16, unsigned char)
WINDOWED_FOLD_MULTI(windowed_fold_multi_bf16_i32, __nv_bfloat16,
                    __nv_bfloat16, int)
WINDOWED_FOLD_MULTI(windowed_fold_multi_f32_bf16_u8, float, __nv_bfloat16,
                    unsigned char)
WINDOWED_FOLD_MULTI(windowed_fold_multi_f32_bf16_i32, float, __nv_bfloat16,
                    int)

FOLD_MULTI_SMEM_BYTES(windowed_fold_multi_smem_bytes_f32, float)
FOLD_MULTI_SMEM_BYTES(windowed_fold_multi_smem_bytes_f64, double)
FOLD_MULTI_SMEM_BYTES(windowed_fold_multi_smem_bytes_bf16, __nv_bfloat16)

extern "C" int fold_products_bf16(const void* rid, const void* p, void* out,
                                  int nw, int lt, int kp, int s, int block_m,
                                  void* stream) {
  return launch_products<__nv_bfloat16>(rid, p, out, nw, lt, kp, s, block_m,
                                        stream);
}

extern "C" int fold_products_f32(const void* rid, const void* p, void* out,
                                 int nw, int lt, int kp, int s, int block_m,
                                 void* stream) {
  return launch_products<float>(rid, p, out, nw, lt, kp, s, block_m, stream);
}

extern "C" int fold_products_smem_bytes_bf16() {
  return static_cast<int>(products_smem_bytes<__nv_bfloat16>());
}

extern "C" int fold_products_smem_bytes_f32() {
  return static_cast<int>(products_smem_bytes<float>());
}

// One instance per (x type, values type) that the wrapper's _FOLD_TYPES
// names: without the residue list the values' type is not read, and the
// wrapper takes the one named by t's type alone (f32, f64, bf16).
#define WINDOW_STRIP(NAME, T, V)                                             \
  extern "C" int NAME(const void* t, void* y, const void* rowptr,            \
                      const void* entptr, const void* cols,                  \
                      const void* vals, const void* x, const void* heavy,    \
                      int n_rows, int s, int nw, int p, int k, int n_heavy,  \
                      void* stream) {                                        \
    return launch_strip<false, T, V>(t, y, rowptr, entptr, cols, vals, x,    \
                                     heavy, nullptr, nullptr, 0, n_rows, s,  \
                                     nw, p, k, n_heavy, stream);             \
  }

WINDOW_STRIP(window_strip_f32, float, float)
WINDOW_STRIP(window_strip_f64, double, double)
WINDOW_STRIP(window_strip_bf16, __nv_bfloat16, __nv_bfloat16)
WINDOW_STRIP(window_strip_bf16_f32, __nv_bfloat16, float)
WINDOW_STRIP(window_strip_f32_bf16, float, __nv_bfloat16)

// The strip of a multi-matrix fold: the residue list of every matrix
// (emat: each entry's matrix) and the table of their x's (x_table: n_x
// addresses).
#define WINDOW_STRIP_MULTI(NAME, T, V)                                       \
  extern "C" int NAME(const void* t, void* y, const void* rowptr,            \
                      const void* entptr, const void* cols,                  \
                      const void* vals, const void* emat,                    \
                      const void* x_table, const void* heavy, int n_x,       \
                      int n_rows, int s, int nw, int p, int k, int n_heavy,  \
                      void* stream) {                                        \
    return launch_strip<true, T, V>(                                         \
        t, y, rowptr, entptr, cols, vals, nullptr, heavy, emat,              \
        static_cast<const long long*>(x_table), n_x, n_rows, s, nw, p, k,    \
        n_heavy, stream);                                                    \
  }

WINDOW_STRIP_MULTI(window_strip_multi_f32, float, float)
WINDOW_STRIP_MULTI(window_strip_multi_f64, double, double)
WINDOW_STRIP_MULTI(window_strip_multi_bf16, __nv_bfloat16, __nv_bfloat16)
WINDOW_STRIP_MULTI(window_strip_multi_bf16_f32, __nv_bfloat16, float)
WINDOW_STRIP_MULTI(window_strip_multi_f32_bf16, float, __nv_bfloat16)

// The fused multi-matrix SpMM (fold and strip in one launch), for the fold's
// (x type, values type) pairs and row ids, and its shared-memory count.
#define FOLD_STRIP_MULTI(NAME, X, V, ROWID)                                  \
  extern "C" int NAME(const void* table, void* y, const void* rowptr,        \
                      const void* entptr, const void* cols,                  \
                      const void* vals, const void* emat, const void* heavy, \
                      int n_mats, int n_heavy, int n_out, int nw, int R,     \
                      int P, int K, int n_rows, int s, int vec, int n_cap,   \
                      void* stream) {                                        \
    return launch_fold_strip<X, V, ROWID>(                                   \
        static_cast<const long long*>(table), y, rowptr, entptr, cols, vals, \
        emat, heavy, n_mats, n_heavy, n_out, nw, R, P, K, n_rows, s, vec,    \
        n_cap, stream);                                                      \
  }
#define FOLD_STRIP_SMEM_BYTES(NAME, X)                                       \
  extern "C" int NAME(int kp, int n_cap, int tile) {                         \
    return static_cast<int>(fold_strip_smem_bytes<X>(kp, n_cap, tile));      \
  }

FOLD_STRIP_MULTI(fold_strip_multi_f32_u8, float, float, unsigned char)
FOLD_STRIP_MULTI(fold_strip_multi_f32_i32, float, float, int)
FOLD_STRIP_MULTI(fold_strip_multi_f64_u8, double, double, unsigned char)
FOLD_STRIP_MULTI(fold_strip_multi_f64_i32, double, double, int)
FOLD_STRIP_MULTI(fold_strip_multi_bf16_f32_u8, __nv_bfloat16, float,
                 unsigned char)
FOLD_STRIP_MULTI(fold_strip_multi_bf16_f32_i32, __nv_bfloat16, float, int)
FOLD_STRIP_MULTI(fold_strip_multi_bf16_u8, __nv_bfloat16, __nv_bfloat16,
                 unsigned char)
FOLD_STRIP_MULTI(fold_strip_multi_bf16_i32, __nv_bfloat16, __nv_bfloat16, int)
FOLD_STRIP_MULTI(fold_strip_multi_f32_bf16_u8, float, __nv_bfloat16,
                 unsigned char)
FOLD_STRIP_MULTI(fold_strip_multi_f32_bf16_i32, float, __nv_bfloat16, int)

FOLD_STRIP_SMEM_BYTES(fold_strip_multi_smem_bytes_f32, float)
FOLD_STRIP_SMEM_BYTES(fold_strip_multi_smem_bytes_f64, double)
FOLD_STRIP_SMEM_BYTES(fold_strip_multi_smem_bytes_bf16, __nv_bfloat16)

extern "C" int double_f32(const void* x, void* y, int n, void* stream) {
  double_kernel<<<(n + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
