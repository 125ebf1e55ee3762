// The fused Chebyshev step for Hopper (sm_90a): the elementwise work of one
// step of the three-term recurrence, and the accumulation of its terms into
// the filter bank, each in one pass over memory.
//   (a) cheby_step:        out = carry((fd . t + sc * y) - t_old)
//   (b) cheby_acc_group:   acc[f] = acc[f] + sum_j cg[j, f] * terms[j]
//   (c) cheby_acc_contract: acc = acc + sum_f ck[f] * t[..., f]
//   (d) cheby_dot_group:    out[j, f] = <gbar[..., f], terms[j]>, the
//                           coefficient gradient of the fixed-graph VJP
// t, t_old, y and out are (N, S) row-major in the carry type C; fd (N,), sc,
// ck and cg, and the accumulators (Nf, N, S) are in the signal's type M, in
// which all arithmetic is done. y is the SpMM's output: A t on the windowed
// format (which applies the scale sc to it), or (scaled A) t with sc = 1 on
// the CSR and banded formats (whose step scales a copy of the values).
//
// Replaces: the XLA fusions that the JAX package gets for free inside its
// lax.scan bodies, which eager PyTorch runs as one pass over memory per
// operator: the step of cheby_op (pygsp_tpu/ops/chebyshev.py:186-190:
// matvec(factor, t) - t_old) on the CSR and banded formats; the windowed
// recur (:264-268, the carry cast of :223-236); the accumulation of the terms
// into the bank, per step on CSR and banded (:189) and grouped on the
// windowed format (:323-334), which the port groups on every format; and the
// synthesis accumulation acc + sum(ck * t_new, axis=-1) (:621, :697). No
// Pallas kernel.
//
// What bounds it on this card: device-memory bytes. Every value is read or
// written once per step and used for a handful of operations, two orders of
// magnitude under the card's ratio of FP32 rate to memory rate. (a) at the
// bench path (f32, N = 2^20, S = 128) reads y, t, t_old and writes out: 4 x
// 0.537 GB per step. (b) reads the g terms once for all Nf accumulators,
// which are read and written once per g steps instead of once per step: at
// g = 14 and Nf = 4, (14 + 8) x 0.537 GB per 14 steps, where a per-step
// update would move 8 x 0.537 GB per step.
//
// Design: one thread per pack of 16 bytes of the carry type (4 f32, 2 f64,
// 8 bf16 values), grid-stride, where S is a multiple of the pack and every
// pointer is aligned to it; one value per thread otherwise. A pack lies in
// one row, so it reads one value of fd. The arithmetic is __fmul_rn,
// __fadd_rn and __fsub_rn (__d*_rn in f64): no contraction to FMA, each
// operation rounded as the plain PyTorch version's single operations round,
// so kernel and plain version are bit-equal; a bf16 carry is stored by
// round-to-nearest-even, as .to(torch.bfloat16) does. (b) loads the packs
// of its group's g terms into registers once (g <= kGroup = 14, the group
// rule's cap; the g loads issued together), then takes the filters
// kFilters at a time, their accumulator packs loaded together, so that a
// group's terms are read once whatever Nf is; each filter's sum runs
// j = 0..g-1 left to right and the accumulator is added last, as in
// pygsp_tpu/ops/chebyshev.py:331-334. The coefficients cg (g x Nf, 1400 at
// Nf = 100) are copied to shared memory once a block. Before, the filters
// were passes of four outside the loop over the terms, which read them
// ceil(Nf / 4) times; that loop stays for a group of more than 14 terms,
// which only the tests' override of the group rule gives. Registers
// (nvcc -Xptxas -v, sm_90a): 126 in f32 and f64, 201 with bf16 terms (one
// block an SM), no spills. On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py; before in brackets): Nf = 100, g = 14 at (2048, 2048)
// 1.270 ms [2.989] against a 1.072 ms bound and addmm_'s 1.601; Nf = 6,
// g = 13 at path A's (2^20, 128) 4.309 [6.392], bound 4.006; Nf = 4,
// g = 14 there 3.762 [4.111], bound 3.526; with bf16 terms 3.032 [3.337],
// bound 2.404. The terms are a ring of (N, S) buffers (core/cheby_kernel.py): the group is g
// consecutive entries from `start`, wrapping, so the recurrence writes each
// term where it will be accumulated from and never copies one.
//
// (d) replaces dot_all of the JAX package's fixed-graph VJP
// (pygsp_tpu/ops/chebyshev.py:431-433; its chunked form :707-723, an XLA
// dot_general per step, no Pallas kernel): c_bar[f, k] = <T_k x, gbar_f>
// over all N*S values. The cotangent bank gbar is (N, ..., Nf), the filter
// axis last, as the VJP's synthesis reads it. Bound: bytes, like (b): a
// group reads its g terms and gbar once, (g + Nf) * N * S values, where a
// dot per step would read gbar again at every step. Design: two passes and
// no atomics. Pass 1 walks packs of 16 bytes of the terms, grid-stride over
// a grid of exactly the blocks that fit the card at once; a thread loads
// the Nf gbar values of its pack's elements (Nf packs of 16 bytes, the
// filter axis being contiguous) and the pack of each of the g terms, and
// keeps the g x Nf sums in registers, in float64 for both instances: a
// product of two floats is exact there, so the f32 instance rounds only
// its output (the f64 units are idle at this byte count). The g loads are
// issued together, before the first product: they are predicated on the
// group's size, where a loop that broke out at g would wait for each term
// in turn. The sums take most of the registers, so the instance for a
// group of up to 14 is held to 3 blocks an SM (a few registers spill; at
// 2 blocks it is slower, PERF.md) and a group of one, the recurrence's
// first terms, runs an instance that keeps one term's sums. Each block
// sums its threads in a fixed order (warp shuffles, then the warps in
// order) into its row of partials (blocks, g, Nf), float64. Pass 2, one
// block, sums each (j, f) over the blocks in a fixed order and rounds once
// to the output's type. Two launches are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFilters = 4;  // accumulators (b) loads and stores together
constexpr int kGroup = 14;   // terms (b) keeps in registers: the group
                             // rule's cap (ops/chebyshev.py:_MAX_GROUP)
constexpr size_t kGroupSharedBytes = 48 * 1024;  // cg in shared memory
constexpr int kDotThreads = 128;
constexpr int kDotTerms = 14;  // terms a pass of (d) keeps sums for
constexpr int kDotBlocksPerSM = 3;  // (d)'s blocks an SM holds, at most
                                    // 168 registers a thread

template <typename M>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
};

// carry -> signal type (exact) and back (round to nearest even)
template <typename M>
__device__ __forceinline__ M widen(M v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename C, typename M>
__device__ __forceinline__ C narrow(M v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

// V values of T in one aligned access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* base, long long i) {
  return reinterpret_cast<const Pack<T, V>*>(base)[i];
}

template <typename T, int V>
__device__ __forceinline__ void store(T* base, long long i,
                                      const Pack<T, V>& p) {
  reinterpret_cast<Pack<T, V>*>(base)[i] = p;
}

// (a) one pack of V values per thread; the row of pack i is i / (s / V).
template <typename M, typename C, int V>
__global__ void __launch_bounds__(kThreads)
cheby_step_kernel(const C* __restrict__ y, const C* __restrict__ t,
                  const C* __restrict__ t_old, const M* __restrict__ fdiag,
                  const M* __restrict__ sc, C* __restrict__ out, long long n,
                  int s) {
  using A = Arith<M>;
  const long long packs = n / V, per_row = s / V;
  const M scale = *sc;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < packs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const M fd = fdiag[i / per_row];
    const Pack<C, V> py = load<C, V>(y, i), pt = load<C, V>(t, i),
                     po = load<C, V>(t_old, i);
    Pack<C, V> pn;
#pragma unroll
    for (int u = 0; u < V; ++u)
      pn.v[u] = narrow<C, M>(A::sub(A::add(A::mul(fd, widen(pt.v[u])),
                                           A::mul(scale, widen(py.v[u]))),
                                    widen(po.v[u])));
    store<C, V>(out, i, pn);
  }
}

// (b) a group of up to NT terms, entries start .. start + g - 1 (mod
// slots) of the ring: a thread loads the g packs of its terms once, all
// issued before the first product, then takes the filters kFilters at a
// time (their accumulator packs loaded together), each filter's sum
// running j = 0..g-1 left to right and the accumulator added last. cg
// (g, nf) is copied to shared memory once a block where it fits
// (cg_shared), else read where it lies, one address for all threads. A
// group of one term (the recurrence's first terms) runs the instance with
// NT = 1, whose few registers let more blocks share an SM.
template <typename M, typename C, int V, int NT>
__global__ void __launch_bounds__(kThreads)
cheby_acc_group_kernel(M* __restrict__ acc, const C* __restrict__ ring,
                       const M* __restrict__ cg, long long n, int slots,
                       int start, int g, int nf, bool cg_shared) {
  using A = Arith<M>;
  extern __shared__ __align__(16) unsigned char smem[];
  M* cg_s = reinterpret_cast<M*>(smem);
  if (cg_shared) {
    for (int k = threadIdx.x; k < g * nf; k += blockDim.x) cg_s[k] = cg[k];
    __syncthreads();
  }
  const M* c_gf = cg_shared ? cg_s : cg;
  const long long packs = n / V;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < packs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    Pack<C, V> pt[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < g) {
        const int slot = start + j < slots ? start + j : start + j - slots;
        pt[j] = load<C, V>(ring + static_cast<long long>(slot) * n, i);
      }
    }
    for (int f0 = 0; f0 < nf; f0 += kFilters) {
      const int nff = min(kFilters, nf - f0);
      Pack<M, V> pa[kFilters];
#pragma unroll
      for (int ff = 0; ff < kFilters; ++ff)
        if (ff < nff) pa[ff] = load<M, V>(acc + (f0 + ff) * n, i);
#pragma unroll
      for (int ff = 0; ff < kFilters; ++ff) {
        if (ff >= nff) break;
        M sum[V];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < g) {
            const M c = c_gf[j * nf + f0 + ff];
#pragma unroll
            for (int u = 0; u < V; ++u) {
              const M p = A::mul(c, widen(pt[j].v[u]));
              sum[u] = j == 0 ? p : A::add(sum[u], p);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < V; ++u) pa[ff].v[u] = A::add(pa[ff].v[u], sum[u]);
        store<M, V>(acc + (f0 + ff) * n, i, pa[ff]);
      }
    }
  }
}

// (b) for a group of more than kGroup terms (only from the tests' override
// of the group rule, PYGSP_CHEBY_ACC_GROUP): the terms are read once per
// pass of up to kFilters accumulators.
template <typename M, typename C, int V>
__global__ void __launch_bounds__(kThreads)
cheby_acc_group_passes_kernel(M* __restrict__ acc, const C* __restrict__ ring,
                              const M* __restrict__ cg, long long n,
                              int slots, int start, int g, int nf) {
  using A = Arith<M>;
  const long long packs = n / V;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < packs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    for (int f0 = 0; f0 < nf; f0 += kFilters) {
      const int nff = min(kFilters, nf - f0);
      M sum[kFilters][V];
      for (int j = 0; j < g; ++j) {
        const C* term = ring + static_cast<long long>((start + j) % slots) * n;
        const Pack<C, V> pt = load<C, V>(term, i);
#pragma unroll
        for (int ff = 0; ff < kFilters; ++ff) {
          if (ff >= nff) break;
          const M c = cg[j * nf + f0 + ff];
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const M p = A::mul(c, widen(pt.v[u]));
            sum[ff][u] = j == 0 ? p : A::add(sum[ff][u], p);
          }
        }
      }
#pragma unroll
      for (int ff = 0; ff < kFilters; ++ff) {
        if (ff >= nff) break;
        M* acc_f = acc + (f0 + ff) * n;
        Pack<M, V> pa = load<M, V>(acc_f, i);
#pragma unroll
        for (int u = 0; u < V; ++u) pa.v[u] = A::add(pa.v[u], sum[ff][u]);
        store<M, V>(acc_f, i, pa);
      }
    }
  }
}

// (c) one accumulator value per thread, its nf terms in filter order.
template <typename M, typename C>
__global__ void __launch_bounds__(kThreads)
cheby_acc_contract_kernel(M* __restrict__ acc, const C* __restrict__ t,
                          const M* __restrict__ ck, long long n, int nf) {
  using A = Arith<M>;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const C* ti = t + i * nf;
    M sum = A::mul(ck[0], widen(ti[0]));
    for (int f = 1; f < nf; ++f) sum = A::add(sum, A::mul(ck[f], widen(ti[f])));
    acc[i] = A::add(acc[i], sum);
  }
}

// (d) pass 1: the sums of one block's packs for terms j0 .. j0 + nj - 1 of
// the group and filters f0 .. f0 + nff - 1. With V > 1 (16-byte packs) NF
// is nf and f0 is 0: element u of a pack has its NF gbar values at
// gb[u * NF + f]. With V = 1, NF is kFilters and nff <= NF of the nf
// filters are summed. NT: the terms a thread keeps sums for (nj <= NT).
template <typename T, int V, int NF, int NT>
__global__ void __launch_bounds__(kDotThreads, kDotBlocksPerSM)
cheby_dot_partial_kernel(double* __restrict__ partials,
                         const T* __restrict__ gbar,
                         const T* __restrict__ ring, long long n, int slots,
                         int start, int g, int j0, int nj, int nf, int f0,
                         int nff) {
  double sum[NT][NF];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int f = 0; f < NF; ++f) sum[j][f] = 0.0;
  const long long packs = n / V;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < packs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    T gb[V * NF];
    if (V > 1) {
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const Pack<T, V> p = load<T, V>(gbar, i * NF + q);
#pragma unroll
        for (int u = 0; u < V; ++u) gb[q * V + u] = p.v[u];
      }
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f)
        gb[f] = f < nff ? gbar[i * nf + f0 + f] : T(0);
    }
    // every term's load is issued before the first product: predicated,
    // not broken out of, so that the group's loads are in flight together
    Pack<T, V> pt[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nj)
        pt[j] = load<T, V>(
            ring + static_cast<long long>((start + j0 + j) % slots) * n, i);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nj)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int u = 0; u < V; ++u)
            sum[j][f] = fma(static_cast<double>(gb[u * NF + f]),
                            static_cast<double>(pt[j].v[u]), sum[j][f]);
  }
  __shared__ double red[kDotThreads / 32][NT * NF];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nj) break;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      double v = sum[j][f];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][j * NF + f] = v;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nj * NF; o += blockDim.x) {
    const int j = o / NF, f = o % NF;
    if (f >= nff) continue;
    double v = red[0][o];
    for (int w = 1; w < kDotThreads / 32; ++w) v += red[w][o];
    partials[(static_cast<long long>(blockIdx.x) * g + j0 + j) * nf + f0 +
             f] = v;
  }
}

// (d) pass 2: out[o] = sum over the blocks of partials[b, o], one warp per
// output, the lanes' strided sums then a shuffle tree: a fixed order.
template <typename T>
__global__ void __launch_bounds__(kDotThreads)
cheby_dot_sum_kernel(T* __restrict__ out, const double* __restrict__ partials,
                     int blocks, int outputs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = warp; o < outputs; o += kDotThreads / 32) {
    double v = 0.0;
    for (int b = lane; b < blocks; b += 32)
      v += partials[static_cast<long long>(b) * outputs + o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) out[o] = static_cast<T>(v);
  }
}

unsigned blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b > 1048576 ? 1048576 : b));
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<size_t>(p) % bytes == 0;
}

template <typename M, typename C>
int launch_step(const void* y, const void* t, const void* t_old,
                const void* fdiag, const void* sc, void* out, int n_rows,
                int s, void* stream) {
  constexpr int V = 16 / sizeof(C);
  const long long n = static_cast<long long>(n_rows) * s;
  if (n == 0) return 0;
  const bool vec = s % V == 0 && aligned(y, 16) && aligned(t, 16) &&
                   aligned(t_old, 16) && aligned(out, 16);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto kernel, long long packs) {
    kernel<<<blocks_for(packs), kThreads, 0, st>>>(
        static_cast<const C*>(y), static_cast<const C*>(t),
        static_cast<const C*>(t_old), static_cast<const M*>(fdiag),
        static_cast<const M*>(sc), static_cast<C*>(out), n, s);
  };
  if (vec)
    args(cheby_step_kernel<M, C, V>, n / V);
  else
    args(cheby_step_kernel<M, C, 1>, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename M, typename C, int V>
void group_instance(void* acc, const void* ring, const void* cg, long long n,
                    int slots, int start, int g, int nf, cudaStream_t st) {
  const unsigned blocks = blocks_for(n / V);
  if (g > kGroup) {
    cheby_acc_group_passes_kernel<M, C, V><<<blocks, kThreads, 0, st>>>(
        static_cast<M*>(acc), static_cast<const C*>(ring),
        static_cast<const M*>(cg), n, slots, start, g, nf);
    return;
  }
  const size_t cg_bytes = sizeof(M) * g * nf;
  const bool cg_shared = cg_bytes <= kGroupSharedBytes;
  const auto kernel = g == 1 ? cheby_acc_group_kernel<M, C, V, 1>
                             : cheby_acc_group_kernel<M, C, V, kGroup>;
  kernel<<<blocks, kThreads, cg_shared ? cg_bytes : 0, st>>>(
      static_cast<M*>(acc), static_cast<const C*>(ring),
      static_cast<const M*>(cg), n, slots, start, g, nf, cg_shared);
}

template <typename M, typename C>
int launch_group(void* acc, const void* ring, const void* cg, int n_rows,
                 int s, int slots, int start, int g, int nf, void* stream) {
  constexpr int V = 16 / sizeof(C);
  const long long n = static_cast<long long>(n_rows) * s;
  if (n == 0 || g == 0 || nf == 0) return 0;
  if (slots < g || start < 0 || start >= slots)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % V == 0 && aligned(ring, 16) &&
                   aligned(acc, V * sizeof(M));
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    group_instance<M, C, V>(acc, ring, cg, n, slots, start, g, nf, st);
  else
    group_instance<M, C, 1>(acc, ring, cg, n, slots, start, g, nf, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename M, typename C>
int launch_contract(void* acc, const void* t, const void* ck, int n_rows,
                    int s, int nf, void* stream) {
  const long long n = static_cast<long long>(n_rows) * s;
  if (n == 0 || nf == 0) return 0;
  cheby_acc_contract_kernel<M, C><<<blocks_for(n), kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<M*>(acc), static_cast<const C*>(t),
      static_cast<const M*>(ck), n, nf);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of pass 1 that fit the card at once, at most max_blocks (the
// rows of the caller's partials) and no more than the packs need.
template <typename K>
int dot_grid(K kernel, long long packs, int max_blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDotThreads,
                                                0);
  const long long need = (packs + kDotThreads - 1) / kDotThreads;
  long long b = static_cast<long long>(sms) * (per_sm < 1 ? 1 : per_sm);
  if (b > need) b = need;
  if (b > max_blocks) b = max_blocks;
  return static_cast<int>(b < 1 ? 1 : b);
}

template <typename T, int V, int NF, int NT>
int dot_pass_terms(void* partials, const void* gbar, const void* ring,
                   long long n, int slots, int start, int g, int nf,
                   int max_blocks, cudaStream_t st) {
  const auto kernel = cheby_dot_partial_kernel<T, V, NF, NT>;
  const int blocks = dot_grid(kernel, n / V, max_blocks);
  for (int f0 = 0; f0 < nf; f0 += NF)
    for (int j0 = 0; j0 < g; j0 += NT)
      kernel<<<blocks, kDotThreads, 0, st>>>(
          static_cast<double*>(partials), static_cast<const T*>(gbar),
          static_cast<const T*>(ring), n, slots, start, g, j0,
          g - j0 < NT ? g - j0 : NT, nf, f0, nf - f0 < NF ? nf - f0 : NF);
  return blocks;
}

// A group of one term runs an instance that keeps one term's sums, so that
// more blocks fit an SM; larger groups keep kDotTerms.
template <typename T, int V, int NF>
int dot_pass(void* partials, const void* gbar, const void* ring, long long n,
             int slots, int start, int g, int nf, int max_blocks,
             cudaStream_t st) {
  return g == 1 ? dot_pass_terms<T, V, NF, 1>(partials, gbar, ring, n,
                                              slots, start, g, nf,
                                              max_blocks, st)
                : dot_pass_terms<T, V, NF, kDotTerms>(partials, gbar, ring, n,
                                                      slots, start, g, nf,
                                                      max_blocks, st);
}

template <typename T>
int launch_dot(void* out, void* partials, const void* gbar, const void* ring,
               int n_rows, int s, int slots, int start, int g, int nf,
               int max_blocks, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const long long n = static_cast<long long>(n_rows) * s;
  if (g == 0 || nf == 0) return 0;
  if (slots < g || start < 0 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(T) * g * nf, st));
  const bool vec = nf <= kFilters && n % V == 0 && aligned(gbar, 16) &&
                   aligned(ring, 16);
  int blocks;
  if (!vec)
    blocks = dot_pass<T, 1, kFilters>(partials, gbar, ring, n, slots, start,
                                      g, nf, max_blocks, st);
  else if (nf == 1)
    blocks = dot_pass<T, V, 1>(partials, gbar, ring, n, slots, start, g, nf,
                               max_blocks, st);
  else if (nf == 2)
    blocks = dot_pass<T, V, 2>(partials, gbar, ring, n, slots, start, g, nf,
                               max_blocks, st);
  else if (nf == 3)
    blocks = dot_pass<T, V, 3>(partials, gbar, ring, n, slots, start, g, nf,
                               max_blocks, st);
  else
    blocks = dot_pass<T, V, 4>(partials, gbar, ring, n, slots, start, g, nf,
                               max_blocks, st);
  cheby_dot_sum_kernel<T><<<1, kDotThreads, 0, st>>>(
      static_cast<T*>(out), static_cast<const double*>(partials), blocks,
      g * nf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (d) one instance per type: the VJP carries its terms in the signal's type.
#define CHEBY_DOT(SUFFIX, T)                                                  \
  extern "C" int cheby_dot_group_##SUFFIX(                                    \
      void* out, void* partials, const void* gbar, const void* ring,         \
      int n_rows, int s, int slots, int start, int g, int nf, int max_blocks, \
      void* stream) {                                                         \
    return launch_dot<T>(out, partials, gbar, ring, n_rows, s, slots, start,  \
                         g, nf, max_blocks, stream);                          \
  }

CHEBY_DOT(f32, float)
CHEBY_DOT(f64, double)

// One instance per (signal type, carry type): f32, f64, and f32 with a bf16
// carry.
#define CHEBY_STEP(SUFFIX, M, C)                                              \
  extern "C" int cheby_step_##SUFFIX(                                         \
      const void* y, const void* t, const void* t_old, const void* fdiag,     \
      const void* sc, void* out, int n_rows, int s, void* stream) {           \
    return launch_step<M, C>(y, t, t_old, fdiag, sc, out, n_rows, s, stream); \
  }                                                                           \
  extern "C" int cheby_acc_group_##SUFFIX(void* acc, const void* ring,        \
                                          const void* cg, int n_rows, int s,  \
                                          int slots, int start, int g,        \
                                          int nf, void* stream) {             \
    return launch_group<M, C>(acc, ring, cg, n_rows, s, slots, start, g, nf,  \
                              stream);                                        \
  }                                                                           \
  extern "C" int cheby_acc_contract_##SUFFIX(void* acc, const void* t,        \
                                             const void* ck, int n_rows,      \
                                             int s, int nf, void* stream) {   \
    return launch_contract<M, C>(acc, t, ck, n_rows, s, nf, stream);          \
  }

CHEBY_STEP(f32, float, float)
CHEBY_STEP(f64, double, double)
CHEBY_STEP(f32_bf16, float, __nv_bfloat16)
