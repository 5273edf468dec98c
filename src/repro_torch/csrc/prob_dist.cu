// Jensen-Shannon and Triangular distance tiles of the BSS engine over
// probability vectors: the unmasked (m, n) distance matrix (query -> pivot
// distances, and the standalone JSD entry point) and the masked exact phase.
//
// Replaces the Pallas kernels
//   * _jsd_tile_kernel (src/repro/kernels/jsd_dist.py:50), standalone under
//     pairwise_jsd_kernel_call (pallas_call at jsd_dist.py:91), unmasked under
//     _pairwise_call (pairwise_dist.py:140) and masked under _masked_call
//     (pairwise_dist.py:168);
//   * _tri_tile_kernel (src/repro/kernels/tri_dist.py:41) under the same two
//     calls of pairwise_dist.py (:140, :168).
// They compute
//   jsd: sqrt(max(sum_k (x/2 log x + y/2 log y - m log m), 0) / ln 2),
//        m = (x + y) / 2, with xlogx(v) = v > 1e-12 ? v log max(v, 1e-12) : 0
//   tri: sqrt(max(0.5 * sum_k (x - y)^2 / max(x + y, 1e-12), 0))
//
// Order of the JSD sum.  The Pallas tile sums three entropies and subtracts
// (Hx/2 + Hy/2 - Hm); each is O(ln K), so the difference cancels: in fp32
// over colors-like histograms (K = 112) its error near the range thresholds
// is 5.7e-6.  This kernel sums the per-k term (x/2 log x + y/2 log y) -
// m log m instead -- the order of the reference registry
// (src/repro/core/distances.py:101-113) and of ref.pairwise_jsd_ref, and of
// this port's plain version.  Each term is >= 0 (xlogx is convex), so the
// sum does not cancel: its error there is 3.1e-7.
//
// What bounds it on the H100: neither function is a contraction, so there
// is no tensor-core form; both are elementwise fp32 work on the CUDA cores
// per (i, j, k).  The exact phase at the main path's shapes (512 queries x
// 101,504 corpus rows x K = 112) has 5.8e9 (i, j, k) per batch.  Counted
// from `cuobjdump -sass` of this file for sm_90a (the inner loop, an FFMA
// as two operations): JSD does about 11 FFMA and 15 other fp32
// instructions per (i, j, k), 37 operations -- logf is no MUFU instruction
// here but an inlined range reduction and polynomial -- so 2.1e11 per batch,
// 3.2 ms at 67 TFLOP/s.  Triangular does about 5 FFMA and 8 others, 18
// operations (its IEEE division is a MUFU.RCP, Newton steps and a fix-up
// check), 1.0e11, 1.6 ms.  Bytes: x, y read once and the 208 MB output
// written once take 0.08 ms at 3.35 TB/s.  Both are bound by operations,
// 20-40x over their bytes.
//
// Design (as the l2 tile): a 64 x 64 output tile per 256-thread block, a
// 4 x 4 micro-tile per thread, K staged through shared memory in chunks of
// 16, K-major.  For JSD the staging thread also stores x/2 log x per staged
// (row, k) and y/2 log y per staged (column, k), so the two row entropies
// cost one logf per element, not one per (i, j, k); the inner loop does the
// one unavoidable logf of the mixture.  Built with -fmad=false and never
// --use_fast_math: no FMA contraction (each product rounds as the plain
// version's), the accurate logf (not __logf), IEEE division (not
// __fdividef) and fp32 denormals kept (no -ftz): colors histograms have many
// bins near zero, and the 1e-12 guard has to behave as the reference's.
// Ragged edges are masked in the kernel (no padded copies).  The mask has
// one flag per (bm x bn) cell -- the engine's query tile x index block -- so
// a CUDA block none of whose cells is live writes +inf and exits before
// loading anything; a partly live block computes and writes +inf into its
// dead cells.  The output comes from torch.empty, so every element is
// written.
//
// y may be float32 or bfloat16 (the engines' bf16 corpus mirror; the Pallas
// tiles upcast y on entry).  A bf16 element is loaded as __nv_bfloat16 and
// widened with __bfloat162float, which is exact; everything after that load
// is the float32 kernel's arithmetic in the same order.  x stays float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;        // output rows per block
constexpr int TN = 64;        // output columns per block
constexpr int KC = 16;        // K chunk staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;        // keeps rows 16-byte aligned

constexpr int JSD = 0;
constexpr int TRI = 1;

constexpr float EPS = 1e-12f;
constexpr float LN2 = 0.693147180559945309f;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// y's element as float32: exact for both element types
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float xlogx(float v) {
  return v > EPS ? __fmul_rn(v, logf(fmaxf(v, EPS))) : 0.0f;
}

template <typename YT, int METRIC, bool MASKED>
__global__ void __launch_bounds__(THREADS)
prob_tile_kernel(const float* __restrict__ x, const YT* __restrict__ y,
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
  // JSD: x/2 log x and y/2 log y of the staged elements (unused for TRI)
  __shared__ __align__(16) float xh[METRIC == JSD ? KC : 1][TM + PAD];
  __shared__ __align__(16) float yh[METRIC == JSD ? KC : 1][TN + PAD];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += KC) {
    for (int i = threadIdx.x; i < TM * KC; i += THREADS) {
      const int r = i / KC, kk = i % KC, gk = k0 + kk;
      // zero padding: xlogx(0) = 0, and (0 - 0)^2 / 1e-12 = 0
      const float xv = (r < rows && gk < k) ? x[(size_t)(r0 + r) * k + gk] : 0.0f;
      const float yv = (r < cols && gk < k) ? widen(y[(size_t)(c0 + r) * k + gk]) : 0.0f;
      xs[kk][r] = xv;
      ys[kk][r] = yv;
      if (METRIC == JSD) {
        xh[kk][r] = 0.5f * xlogx(xv);
        yh[kk][r] = 0.5f * xlogx(yv);
      }
    }
    __syncthreads();
    // past the end of K every staged value is 0 and adds exactly 0
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ys[kk][tx + 16 * j];
      if (METRIC == JSD) {
        float ah[4], bh[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ah[i] = xh[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bh[j] = yh[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // (x/2 log x + y/2 log y) - m log m, as the plain version
            const float mix = 0.5f * (a[i] + b[j]);
            acc[i][j] += (ah[i] + bh[j]) - xlogx(mix);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d = a[i] - b[j];
            acc[i][j] += (d * d) / fmaxf(a[i] + b[j], EPS);
          }
      }
    }
    __syncthreads();
  }

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
      } else if (METRIC == JSD) {
        v = sqrtf(fmaxf(acc[i][j], 0.0f) / LN2);
      } else {
        v = sqrtf(fmaxf(0.5f * acc[i][j], 0.0f));
      }
      out[(size_t)gr * n + gc] = v;
    }
  }
}

template <typename YT, int METRIC, bool MASKED>
int launch(const float* x, const YT* y, const int* mask, float* out, int m,
           int n, int k, int bm, int bn, void* stream) {
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  const int mask_cols = MASKED ? (n + bn - 1) / bn : 0;
  prob_tile_kernel<YT, METRIC, MASKED><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, mask, out, m, n, k, bm, bn, mask_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k), y (n, k), out (m, n): float32, row-major, contiguous, on the
// current device; rows of x and y are probability vectors.  Each returns
// the cudaError_t of its launch.
extern "C" int pairwise_jsd(const float* x, const float* y, float* out, int m,
                            int n, int k, void* stream) {
  return launch<float, JSD, false>(x, y, nullptr, out, m, n, k, 1, 1, stream);
}

extern "C" int pairwise_tri(const float* x, const float* y, float* out, int m,
                            int n, int k, void* stream) {
  return launch<float, TRI, false>(x, y, nullptr, out, m, n, k, 1, 1, stream);
}

// As above, with mask (ceil(m / bm), ceil(n / bn)) int32: +inf in every
// element of a cell whose flag is 0.
extern "C" int masked_pairwise_jsd(const float* x, const float* y,
                                   const int* mask, float* out, int m, int n,
                                   int k, int bm, int bn, void* stream) {
  return launch<float, JSD, true>(x, y, mask, out, m, n, k, bm, bn, stream);
}

extern "C" int masked_pairwise_tri(const float* x, const float* y,
                                   const int* mask, float* out, int m, int n,
                                   int k, int bm, int bn, void* stream) {
  return launch<float, TRI, true>(x, y, mask, out, m, n, k, bm, bn, stream);
}

// The same four entry points with a bfloat16 y (the bf16 corpus mirror).
extern "C" int pairwise_jsd_bf16(const float* x, const __nv_bfloat16* y,
                                 float* out, int m, int n, int k,
                                 void* stream) {
  return launch<__nv_bfloat16, JSD, false>(x, y, nullptr, out, m, n, k, 1, 1, stream);
}

extern "C" int pairwise_tri_bf16(const float* x, const __nv_bfloat16* y,
                                 float* out, int m, int n, int k,
                                 void* stream) {
  return launch<__nv_bfloat16, TRI, false>(x, y, nullptr, out, m, n, k, 1, 1, stream);
}

extern "C" int masked_pairwise_jsd_bf16(const float* x,
                                        const __nv_bfloat16* y,
                                        const int* mask, float* out, int m,
                                        int n, int k, int bm, int bn,
                                        void* stream) {
  return launch<__nv_bfloat16, JSD, true>(x, y, mask, out, m, n, k, bm, bn, stream);
}

extern "C" int masked_pairwise_tri_bf16(const float* x,
                                        const __nv_bfloat16* y,
                                        const int* mask, float* out, int m,
                                        int n, int k, int bm, int bn,
                                        void* stream) {
  return launch<__nv_bfloat16, TRI, true>(x, y, mask, out, m, n, k, bm, bn, stream);
}
