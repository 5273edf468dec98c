// l2 distance tiles of the BSS engine: the unmasked (m, n) distance matrix
// (query -> pivot distances) and the masked exact phase.
//
// Replaces the Pallas kernels in src/repro/kernels/pairwise_dist.py:
// _l2_tile_kernel (:82) under _pairwise_call (pallas_call at :140), and the
// same tile under _masked_tile_kernel (:98) / _masked_call (pallas_call at
// :168).  Both compute
//     out[i, j] = sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0))
// (or the squared value), fp32 accumulation, in that order.
//
// What bounds it on the H100: the exact phase at the main path's shapes
// (512 queries x 101,504 corpus rows x K = 112) is 2*m*n*K fp32 operations
// on its live tiles -- 11.6 GFLOP if every tile lived, 0.17 ms at the
// 67 TFLOP/s of fp32 outside the tensor cores -- against 0.06 ms to write
// the 208 MB output at 3.35 TB/s.  So it is bound by operations, on the
// CUDA cores: the only fp32 tensor-core path on Hopper is TF32, whose 10-bit
// mantissa breaks the 1e-5 contract and moves hits near the threshold.
//
// Design: a 64 x 64 output tile per 256-thread block; K streams through
// shared memory in chunks of 16, stored K-major so each thread reads its
// 4 rows and 4 columns as broadcasts / conflict-free words and does a
// 4 x 4 micro-tile of IEEE fmaf (16 FMAs per 8 shared loads).  The squared
// row norms are summed by 128 of the threads from the same staged chunks,
// so x and y are read from device memory once.  Ragged edges are masked in
// the kernel (no padded copies).  The mask has one flag per (bm x bn) cell
// -- the engine's query tile x index block -- independent of the CUDA tile:
// a block none of whose cells is live writes +inf and exits before loading
// anything; a partly live block computes and writes +inf into dead cells.
// The output comes from torch.empty, so every element is written.
//
// y may be float32 or bfloat16 (the engines' bf16 corpus mirror, which
// replaces the same Pallas calls compiled for a bf16 y: the Pallas tile
// upcasts on entry, pairwise_dist.py:83-84).  A bf16 element is loaded as
// __nv_bfloat16 and widened with __bfloat162float, which is exact; every
// operation after that load is the float32 kernel's, in the same order.
// x stays float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;        // output rows per block
constexpr int TN = 64;        // output columns per block
constexpr int KC = 16;        // K chunk staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;        // keeps rows 16-byte aligned

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// y's element as float32: exact for both element types
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename YT, bool MASKED, bool SQUARED>
__global__ void __launch_bounds__(THREADS)
l2_tile_kernel(const float* __restrict__ x, const YT* __restrict__ y,
               const int* __restrict__ mask, float* __restrict__ out,
               int m, int n, int k, int bm, int bn, int mask_cols) {
  const int r0 = blockIdx.y * TM;
  const int c0 = blockIdx.x * TN;
  const int rows = min(TM, m - r0);
  const int cols = min(TN, n - c0);

  if (MASKED) {
    bool live = false;
    const int rt_hi = (r0 + rows - 1) / bm;
    const int ct_hi = (c0 + cols - 1) / bn;
    for (int rt = r0 / bm; rt <= rt_hi && !live; ++rt) {
      for (int ct = c0 / bn; ct <= ct_hi; ++ct) {
        if (mask[(size_t)rt * mask_cols + ct] != 0) {
          live = true;
          break;
        }
      }
    }
    if (!live) {
      for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
        const int r = i / TN, c = i % TN;
        if (r < rows && c < cols) out[(size_t)(r0 + r) * n + c0 + c] = pos_inf();
      }
      return;
    }
  }

  __shared__ __align__(16) float xs[KC][TM + PAD];
  __shared__ __align__(16) float ys[KC][TN + PAD];
  __shared__ float xn[TM];
  __shared__ float yn[TN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float norm = 0.0f;  // threads [0, TM): |x_r|^2; [TM, TM + TN): |y_c|^2

  for (int k0 = 0; k0 < k; k0 += KC) {
    for (int i = threadIdx.x; i < TM * KC; i += THREADS) {
      const int r = i / KC, kk = i % KC, gk = k0 + kk;
      xs[kk][r] = (r < rows && gk < k) ? x[(size_t)(r0 + r) * k + gk] : 0.0f;
      ys[kk][r] = (r < cols && gk < k) ? widen(y[(size_t)(c0 + r) * k + gk]) : 0.0f;
    }
    __syncthreads();
    if (threadIdx.x < TM) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) norm = fmaf(xs[kk][threadIdx.x], xs[kk][threadIdx.x], norm);
    } else if (threadIdx.x < TM + TN) {
      const int c = threadIdx.x - TM;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) norm = fmaf(ys[kk][c], ys[kk][c], norm);
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (threadIdx.x < TM) {
    xn[threadIdx.x] = norm;
  } else if (threadIdx.x < TM + TN) {
    yn[threadIdx.x - TM] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const int gr = r0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c >= cols) continue;
      const int gc = c0 + c;
      float v;
      if (MASKED && mask[(size_t)(gr / bm) * mask_cols + gc / bn] == 0) {
        v = pos_inf();
      } else {
        // reference order: (xx + yy) - 2 xy, clamp, sqrt (2 xy is exact,
        // so a contracted fma rounds the same way)
        const float sq = fmaxf(xn[r] + yn[c] - 2.0f * acc[i][j], 0.0f);
        v = SQUARED ? sq : sqrtf(sq);
      }
      out[(size_t)gr * n + gc] = v;
    }
  }
}

template <typename YT, bool MASKED>
int launch(const float* x, const YT* y, const int* mask, float* out, int m,
           int n, int k, int bm, int bn, int squared, void* stream) {
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  const int mask_cols = MASKED ? (n + bn - 1) / bn : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (squared) {
    l2_tile_kernel<YT, MASKED, true><<<grid, THREADS, 0, s>>>(x, y, mask, out, m, n, k, bm, bn, mask_cols);
  } else {
    l2_tile_kernel<YT, MASKED, false><<<grid, THREADS, 0, s>>>(x, y, mask, out, m, n, k, bm, bn, mask_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k), y (n, k), out (m, n): float32, row-major, contiguous, on the
// current device.  Returns the cudaError_t of the launch.
extern "C" int pairwise_l2(const float* x, const float* y, float* out, int m,
                           int n, int k, int squared, void* stream) {
  return launch<float, false>(x, y, nullptr, out, m, n, k, 1, 1, squared, stream);
}

// As pairwise_l2, with mask (ceil(m / bm), ceil(n / bn)) int32: +inf in
// every element of a cell whose flag is 0.
extern "C" int masked_pairwise_l2(const float* x, const float* y,
                                  const int* mask, float* out, int m, int n,
                                  int k, int bm, int bn, int squared,
                                  void* stream) {
  return launch<float, true>(x, y, mask, out, m, n, k, bm, bn, squared, stream);
}

// The same two entry points with a bfloat16 y (the bf16 corpus mirror).
extern "C" int pairwise_l2_bf16(const float* x, const __nv_bfloat16* y,
                                float* out, int m, int n, int k, int squared,
                                void* stream) {
  return launch<__nv_bfloat16, false>(x, y, nullptr, out, m, n, k, 1, 1, squared, stream);
}

extern "C" int masked_pairwise_l2_bf16(const float* x, const __nv_bfloat16* y,
                                       const int* mask, float* out, int m,
                                       int n, int k, int bm, int bn,
                                       int squared, void* stream) {
  return launch<__nv_bfloat16, true>(x, y, mask, out, m, n, k, bm, bn, squared, stream);
}
