// Block-banded SpMM for Hopper (sm_90a):
//   y[i*128 + a, :] = sum_{d=0}^{2b} sum_c tiles[i, d, a, c] * x[(i+d-b)*128 + c, :]
// with tiles (nb, 2b+1, 128, 128), x (n_cols, S), y (n_rows, S), row-major.
// Blocks i+d-b outside [0, nb) are skipped (their tiles are zero).
//
// Replaces: pygsp_tpu/ops/pallas_banded.py:banded_spmm_pallas (the
// pl.pallas_call at line 69, body _make_kernel at lines 26-37), whose einsum
// twin is pygsp_tpu/core/sparse.py:banded_spmm.
//
// What bounds it on this card: bytes, and for the f32 kernel its TF32x3
// products just above them. Every tile is multiplied into S columns of x,
// 2*128 flops per tile element and column; at the 262k-vertex grid (b = 4,
// S = 128) that is 77 GFLOP (0.16 ms at the dense TF32 rate, 495 TFLOP/s)
// against 1.48 GB of tiles, x and y (0.44 ms at 3.35 TB/s): the function's
// least time is its bytes. Plain FP32 FFMA stops at 1.15 ms (67 TFLOP/s),
// so the f32 kernel runs on the tensor cores; to keep f32 accuracy it
// issues three TF32 products per product, 232 GFLOP, 0.47 ms at the TF32
// rate, which is the least time of this design.
//
// f32 design (banded_spmm_tf32x3_kernel): one block per (row tile, 128
// S columns); blocks run in any order, so nothing carries between them.
// The block walks K = (2b+1)*128 in 32-wide slices through a 3-stage ring
// in shared memory filled by cp.async (the tile slice in 16-byte copies; the
// x slice in 16-byte copies when S is a multiple of 4 and x is 16-byte
// aligned, else 4-byte ones; rows past n_cols and columns past S are filled
// with zeros by the copy, so x needs no padded copy), so the next two
// slices load while the current one multiplies: one __syncthreads per
// slice. 8 warps, each a 32 x 64 piece of the 128 x 128 output, issue
// mma.sync m16n8k8 TF32 with f32 accumulators in registers. One TF32 pass
// keeps 10 mantissa bits (about 5e-4 relative per product), too coarse for
// an f32 result, so each operand is split in registers into
// big = cvt.rna.tf32(v) and small = v - big, and each product is
// accumulated as small*big + big*small + big*big. The dropped small*small
// term and the truncation of small to TF32 by the multiply are of order
// 2^-21 relative, the size of f32 rounding (measured: 1.7e-7 of the largest
// value against the f32 einsum at the grid). Row pitches of 36 (tile slice)
// and 136 (x slice) floats make every fragment read free of bank
// conflicts. mma.sync rather than wgmma: wgmma's TF32 form takes its shared
// operands K-major only (x's slice would be written transposed) and needs
// descriptors and warpgroup fences; mma.sync already beats the FP32 bound.
// Registers (nvcc -Xptxas -v, sm_90a): 128, the cap for two 256-thread
// blocks per SM, with 24 bytes of spill; 107,520 bytes of shared memory.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 1.31 ms
// at the grid, 3.0x the byte bound, its TF32 products at 36 % of the TF32
// peak, against 2.97 for the FFMA kernel it replaces and 1.45 for torch.bmm
// in FP32.
//
// f64 design (banded_spmm_f64_kernel, the first port's kernel): the
// block loops over the band (d) and 16-wide K slices staged in shared
// memory synchronously; 256 threads each keep an 8x8 output micro-tile in
// registers and accumulate with FP64 FFMA.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;     // BAND_TILE: rows and columns of one tile
constexpr int kBlockS = 128;   // S columns per block
constexpr int kMicro = 8;      // each thread: 8 rows x 8 columns
constexpr int kThreads = 256;  // 16 x 16 threads

constexpr int kK = 16;         // K slice of the f64 kernel

__global__ void __launch_bounds__(kThreads)
banded_spmm_f64_kernel(const double* __restrict__ tiles,
                       const double* __restrict__ x, double* __restrict__ y,
                       int nb, int half_bw, int n_rows, int n_cols, int s) {
  // +1 column: the two rows a warp reads fall in different banks
  __shared__ double a_tile[kTile][kK + 1];
  __shared__ double x_tile[kK][kBlockS];

  const int i = blockIdx.x;
  const int s0 = blockIdx.y * kBlockS;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_diag = 2 * half_bw + 1;

  double acc[kMicro][kMicro];
#pragma unroll
  for (int m = 0; m < kMicro; ++m)
#pragma unroll
    for (int n = 0; n < kMicro; ++n) acc[m][n] = 0.0;

  for (int d = 0; d < n_diag; ++d) {
    const int j = i + d - half_bw;
    if (j < 0 || j >= nb) continue;  // uniform across the block
    const double* tile =
        tiles + (static_cast<size_t>(i) * n_diag + d) * kTile * kTile;
    for (int k0 = 0; k0 < kTile; k0 += kK) {
      for (int idx = threadIdx.x; idx < kTile * kK; idx += kThreads) {
        const int a = idx / kK, k = idx % kK;
        a_tile[a][k] = tile[a * kTile + k0 + k];
      }
      for (int idx = threadIdx.x; idx < kK * kBlockS; idx += kThreads) {
        const int k = idx / kBlockS, n = idx % kBlockS;
        const int r = j * kTile + k0 + k, c = s0 + n;
        x_tile[k][n] = (r < n_cols && c < s)
                           ? x[static_cast<size_t>(r) * s + c] : 0.0;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        double av[kMicro], xv[kMicro];
#pragma unroll
        for (int m = 0; m < kMicro; ++m) av[m] = a_tile[ty + 16 * m][k];
#pragma unroll
        for (int n = 0; n < kMicro; ++n) xv[n] = x_tile[k][tx + 16 * n];
#pragma unroll
        for (int m = 0; m < kMicro; ++m)
#pragma unroll
          for (int n = 0; n < kMicro; ++n) acc[m][n] += av[m] * xv[n];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < kMicro; ++m) {
    const int row = i * kTile + ty + 16 * m;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < kMicro; ++n) {
      const int c = s0 + tx + 16 * n;
      if (c < s) y[static_cast<size_t>(row) * s + c] = acc[m][n];
    }
  }
}

constexpr int kK32 = 32;                  // K slice of the f32 kernel
constexpr int kStages = 3;                // cp.async ring depth, in slices
constexpr int kThreads32 = 256;           // 8 warps: 4 along rows x 2 along S
constexpr int kApitch = kK32 + 4;         // tile-slice row pitch, floats
constexpr int kXpitch = kBlockS + 8;      // x-slice row pitch, floats
constexpr int kStageFloats = kTile * kApitch + kK32 * kXpitch;
constexpr int kSmem32 = kStages * kStageFloats * sizeof(float);  // 107,520

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// v = big + small: big = v rounded to TF32, small = v - big (exact in f32),
// handed to the tensor core as it is; the TF32 multiply reads its top 19
// bits, so small enters truncated to TF32 (a relative error of 2^-10 on a
// term already below 2^-11 of v), without a second conversion.
__device__ __forceinline__ void split_tf32(float v, unsigned& big,
                                           unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(v));
  small = __float_as_uint(v - __uint_as_float(big));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads32, 2)
banded_spmm_tf32x3_kernel(const float* __restrict__ tiles,
                          const float* __restrict__ x, float* __restrict__ y,
                          int nb, int half_bw, int n_rows, int n_cols, int s,
                          int vec) {
  extern __shared__ __align__(16) float smem32[];
  const int i = blockIdx.x;
  const int s0 = blockIdx.y * kBlockS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int n_diag = 2 * half_bw + 1;
  // band entries whose x block j = i + d - b lies in [0, nb)
  const int d_lo = max(0, half_bw - i);
  const int d_hi = min(n_diag, nb + half_bw - i);
  constexpr int kSlices = kTile / kK32;
  const int n_iter = (d_hi - d_lo) * kSlices;

  // Start the copies of K slice `it` into ring stage `stage`.
  auto load = [&](int it, int stage) {
    float* a_s = smem32 + stage * kStageFloats;
    float* x_s = a_s + kTile * kApitch;
    const int d = d_lo + it / kSlices, k0 = (it % kSlices) * kK32;
    const float* tile =
        tiles + (static_cast<size_t>(i) * n_diag + d) * kTile * kTile + k0;
#pragma unroll
    for (int u = 0; u < kTile * kK32 / 4 / kThreads32; ++u) {
      const int c = u * kThreads32 + tid, a = c / (kK32 / 4),
                k = (c % (kK32 / 4)) * 4;
      cp_async16(a_s + a * kApitch + k, tile + a * kTile + k, 16);
    }
    const int r0 = (i + d - half_bw) * kTile + k0;
    if (vec) {
#pragma unroll
      for (int u = 0; u < kK32 * kBlockS / 4 / kThreads32; ++u) {
        const int c = u * kThreads32 + tid, k = c / (kBlockS / 4),
                  n = (c % (kBlockS / 4)) * 4;
        const bool in = r0 + k < n_cols && s0 + n < s;
        cp_async16(x_s + k * kXpitch + n,
                   in ? x + static_cast<size_t>(r0 + k) * s + s0 + n : x,
                   in ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < kK32 * kBlockS / kThreads32; ++u) {
        const int e = u * kThreads32 + tid, k = e / kBlockS, n = e % kBlockS;
        const bool in = r0 + k < n_cols && s0 + n < s;
        cp_async4(x_s + k * kXpitch + n,
                  in ? x + static_cast<size_t>(r0 + k) * s + s0 + n : x,
                  in ? 4 : 0);
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_iter) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();  // slice it has landed (own copies)
    __syncthreads();               // everyone's copies; slice it-1 consumed
    if (it + kStages - 1 < n_iter)
      load(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const float* a_s = smem32 + (it % kStages) * kStageFloats;
    const float* x_s = a_s + kTile * kApitch;
#pragma unroll
    for (int kk = 0; kk < kK32; kk += 8) {
      unsigned a_big[2][4], a_small[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a = a_s + (wm + mt * 16 + g) * kApitch + kk + t4;
        split_tf32(a[0], a_big[mt][0], a_small[mt][0]);
        split_tf32(a[8 * kApitch], a_big[mt][1], a_small[mt][1]);
        split_tf32(a[4], a_big[mt][2], a_small[mt][2]);
        split_tf32(a[8 * kApitch + 4], a_big[mt][3], a_small[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* b = x_s + (kk + t4) * kXpitch + wn + nt * 8 + g;
        unsigned b0_big, b0_small, b1_big, b1_small;
        split_tf32(b[0], b0_big, b0_small);
        split_tf32(b[4 * kXpitch], b1_big, b1_small);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], a_small[mt], b0_big, b1_big);
          mma_tf32(acc[mt][nt], a_big[mt], b0_small, b1_small);
          mma_tf32(acc[mt][nt], a_big[mt], b0_big, b1_big);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i * kTile + wm + mt * 16 + g + 8 * h;
      if (row >= n_rows) continue;
      float* yr = y + static_cast<size_t>(row) * s;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = s0 + wn + nt * 8 + 2 * t4;
        if (c < s) yr[c] = acc[mt][nt][2 * h];
        if (c + 1 < s) yr[c + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

int launch_f32(const void* tiles, const void* x, void* y, int nb,
               int half_bw, int n_rows, int n_cols, int s, void* stream) {
  // 16-byte tile copies need 16-byte-aligned tiles; x takes 16-byte copies
  // only where every row start is 16-byte aligned
  if (reinterpret_cast<size_t>(tiles) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int vec = reinterpret_cast<size_t>(x) % 16 == 0 && s % 4 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      banded_spmm_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem32);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nb, (s + kBlockS - 1) / kBlockS);
  banded_spmm_tf32x3_kernel<<<grid, kThreads32, kSmem32,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tiles), static_cast<const float*>(x),
      static_cast<float*>(y), nb, half_bw, n_rows, n_cols, s, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_f64(const void* tiles, const void* x, void* y, int nb,
               int half_bw, int n_rows, int n_cols, int s, void* stream) {
  const dim3 grid(nb, (s + kBlockS - 1) / kBlockS);
  banded_spmm_f64_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(tiles), static_cast<const double*>(x),
      static_cast<double*>(y), nb, half_bw, n_rows, n_cols, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int banded_spmm_f32(const void* tiles, const void* x, void* y,
                               int nb, int half_bw, int n_rows, int n_cols,
                               int s, void* stream) {
  return launch_f32(tiles, x, y, nb, half_bw, n_rows, n_cols, s, stream);
}

extern "C" int banded_spmm_f64(const void* tiles, const void* x, void* y,
                               int nb, int half_bw, int n_rows, int n_cols,
                               int s, void* stream) {
  return launch_f64(tiles, x, y, nb, half_bw, n_rows, n_cols, s, stream);
}
