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
//        m = (x + y) / 2, with xlogx(v) = v > 1e-12 ? v log v : 0
//   tri: sqrt(max(0.5 * sum_k (x - y)^2 / max(x + y, 1e-12), 0))
// and write +inf into every element of a dead (bm x bn) cell of the masked
// form.
//
// Arithmetic.  JSD is summed in log2 units, so the 1 / ln 2 disappears:
// with s = x + y, m log2 m = s/2 (log2 s - 1), and twice the per-k term is
//   t_k = (x log2 x + x) + (y log2 y + y) - s l,   l = s > 2e-12 ? lg2(s) : 1
// (the select is the mixture's 1e-12 guard: at l = 1 the mixture drops out
// and t_k = x log2 x + y log2 y, each guarded at 1e-12 as before), and a bin
// with x = y adds nothing (its term is exactly 0, so identical rows give 0).
// The bracketed per-element terms are computed once per staged element with
// the accurate log2f; the inner loop per (i, j, k) is one FADD (s), one
// MUFU.LG2 (lg2.approx.ftz), a compare and select (the guard), one FADD, one
// FFMA, and a compare and predicated FADD into the sum: 8 issue slots.  The
// sum is of the per-k terms, each >= 0 (xlogx is convex),
// not the Pallas tile's difference of three O(log K) entropies, which
// cancels.  jsd = sqrt(max(sum_k t_k / 2, 0)).  Triangular's division is one
// MUFU.RCP (rcp.approx.ftz; its argument is >= 1e-12, a normal number) and
// an FFMA into the sum: sum += (x - y)^2 * rcp(max(x + y, 1e-12)).  Every
// rounding step is an explicit intrinsic (__fadd_rn, __fmul_rn, __fmaf_rn),
// so no build flag changes it.
//
// Error budget (u = 2^-24; CUDA Math API: __log2f, the lg2.approx above,
// absolute error 2^-22 on [0.5, 2] and 2 ulp elsewhere; rcp.approx 1 ulp;
// log2f 1 ulp).  JSD: write S = sum_k t_k / 2 (JSD^2 in bits).  The FFMA
// forms s l exactly, so an error dl_k of lg2 moves S by s_k dl_k / 2, with
// dl_k <= 2^-22 for s_k in [0.5, 2] and <= 2 ulp(l_k) <= 2^-22 |log2 s_k|
// below; since sum_k s_k = 2 and, with p = s / 2, sum_k s_k |log2 s_k| <=
// 2 (H(p) - 1) + 2 <= 2 log2 K,
//   |dS|, lg2:  <= 2^-23 sum_k s_k max(1, |log2 s_k|) <= 2^-22 (1 + log2 K).
// The fp32 roundings (the per-element terms, s, the FFMA, the running sum
// of K terms >= 0) add
//   |dS|, fp32: <= u (6 log2 K + 2) + (K + 1) u S,
// using sum_k x |log2 x| <= log2 K for each row.  At K = 112 the lg2 part is
// 1.86e-6.  Near a threshold t a comparison d <= t flips only when
// |d^2 - t^2| <= |dS|, so |dd| <= |dS| / 2t (+ u t for the sqrt): the lg2
// part is 3.8e-6 and the whole 9.9e-6 at the smallest JSD threshold of
// SISAP colors (t = 0.2435), 2.0e-5 for the two passes of the bf16 proof,
// inside the margin's fp32 arithmetic term ARITH_ULPS * eps_f32 * sqrt(K)
// = 8.07e-5 (core/precision.py).  Triangular: every term is >= 0; rcp moves
// each by at most 2u relative and the fp32 roundings by (K + 3) u in all,
// so |dd| / d <= u (rcp) + ((K + 3) / 2 + 1) u (fp32), 3.5e-6 at K = 112.
// chip_smoke.py prints the largest |d - d_float64| it sees near each
// threshold beside this budget.
//
// Near duplicates.  The lg2 part of |dS| does not shrink with S, so it
// grows as 1 / 2d in d: below d = 0.05 the fast sum would err several times
// more than the plain fp32 version.  So a JSD cell whose fast sum S falls
// below S_0 = 0.05^2 + |dS| (the fast sum's bound above at S = 0.05^2;
// jsd_accurate_below) is recomputed, after the epilogue's stores, by the
// thread that owns it (jsd_accurate): the plain version's per-k form
// sum_k (x/2 ln x + y/2 ln y) - m ln m with the accurate logf (1 ulp),
// summed in k order, then sqrt(max(sum, 0) / ln 2).  Every cell whose
// exact distance is below 0.05 has S < S_0 and is recomputed; a cell that
// is not comes out at sqrt(S_0) > 0.05 or above.  The decision reads only S, which does not
// depend on the launch, and so does the recompute: the bits stay the
// launch's own.  The hot loop is unchanged; the epilogue adds one compare
// a cell, and the recompute is rare (no pair of the SISAP colors corpus
// lies within 0.05 of another).  Its error, from the same roundings in
// nats (per k: three logf of 1 ulp, their products, the halving, the
// sums; sum_k x |ln x| <= ln K), then the division by ln 2:
//   |dS|, accurate: <= u (8 log2 K + 1 / ln 2) + (K + 3) u S,
// no approximate part; |dd| <= |dS| / 2d + u d.
// core/precision.py::prob_error_budget gives this budget below d = 0.05
// and the fast one above.
//
// What bounds it on the H100: neither function is a contraction, so there
// is no tensor-core form.  The work is one transcendental per live
// (i, j, k) on the SFU, whose documented rate on compute capability 9.0 is
// 16 results per SM per clock: 132 x 16 x 1.98 GHz = 4.18e12/s.  The main
// path's exact phase (512 queries x 101,504 corpus rows x K = 112, ~75%
// live) has 5.8e9 live (i, j, k) a batch: 1.39 ms.  Bytes (x, y once, the
// 208 MB output once) take 0.08 ms at 3.35 TB/s.  One SFU result leaves 8
// issue slots of its SM sub-partition; the inner loop above takes 8 (JSD)
// or 6 (Triangular: FADD, FADD, FMNMX, MUFU.RCP, FMUL, FFMA) with the
// MUFU, plus 1/8 (JSD) or 1/16 shared loads.
//
// Design.  256 threads a block, 16 x 16, each an R x C micro-tile.  Two
// shapes, chosen by m and n: 128 x 128 outputs (8 x 8 a thread; one block is
// one 128 x 128 engine cell) when that grid fills the card, else 16 x 16
// (1 x 1 a thread), so the 512 x 16 query -> pivot tile still spreads over
// 32 blocks.  K is staged in chunks of 16 through two raw shared-memory
// stages filled by cp.async (16-byte copies, neighbouring threads on
// neighbouring addresses; 8 bf16 values a copy) while the previous chunk is
// computed.  A transform pass turns the landed chunk into the k-major
// compute layout, widening a bf16 y exactly (__bfloat162float) and, for
// JSD, adding the per-element v log2 v + v; the compute loop then reads
// four rows or columns per 16-byte shared load.  Rows whose K or base
// address does not allow 16-byte copies are staged by plain loads.
// Determinism: each (i, j) is summed in the order k = 0, 1, ..., K - 1 into
// one register with the same instructions whatever the block shape, the
// mask or where the tile falls (padding past K adds exactly 0), so the bf16
// re-check, which recomputes band tiles under another mask, reads the fp32
// pass's bits, and the bf16-y form equals the fp32 form on the widened y.
// The kernel has no atomics.  Ragged edges are masked in the kernel.  A block none of whose
// mask cells is live writes +inf and exits before loading anything; a partly
// live block computes and writes +inf into its dead cells.  The output comes
// from torch.empty, so every element is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int KC = 16;        // K chunk staged in shared memory
constexpr int TY = 16;        // thread rows of a block
constexpr int TX = 16;        // thread columns of a block
constexpr int THREADS = TY * TX;
constexpr int PAD = 4;        // compute rows stay 16-byte aligned
constexpr int WIDE = 128;     // output rows and columns of the wide shape

constexpr int JSD = 0;
constexpr int TRI = 1;

constexpr float EPS = 1e-12f;
constexpr float TWO_EPS = 2.0f * EPS;  // m > EPS  <=>  s = 2 m > 2 EPS, exactly

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// y's element as float32: exact for both element types
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// MUFU.LG2 and MUFU.RCP, with no subnormal fix-up around them
__device__ __forceinline__ float lg2_approx(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// v log2 v + v, with v log2 v guarded at 1e-12 (accurate log2f)
__device__ __forceinline__ float entropy_term(float v) {
  const float vl = v > EPS ? __fmul_rn(v, log2f(fmaxf(v, EPS))) : 0.0f;
  return __fadd_rn(vl, v);
}

constexpr float LN2 = 0.693147180559945309f;

// v ln v, guarded at 1e-12 (accurate logf)
__device__ __forceinline__ float xlogx(float v) {
  return v > EPS ? __fmul_rn(v, logf(fmaxf(v, EPS))) : 0.0f;
}

// JSD of row xr against row yr with the accurate logarithm, in the plain
// version's per-k form and k order: sum_k (x/2 ln x + y/2 ln y) - m ln m,
// then sqrt(max(sum, 0) / ln 2).  The near-duplicate path (note at the top).
template <typename YT>
__device__ float jsd_accurate(const float* __restrict__ xr, const YT* __restrict__ yr, int k) {
  float sum = 0.0f;
  for (int kk = 0; kk < k; ++kk) {
    const float a = xr[kk];
    const float b = widen(yr[kk]);
    const float half = __fadd_rn(__fmul_rn(0.5f, xlogx(a)), __fmul_rn(0.5f, xlogx(b)));
    const float mix = __fmul_rn(0.5f, __fadd_rn(a, b));
    sum = __fadd_rn(sum, __fsub_rn(half, xlogx(mix)));
  }
  return __fsqrt_rn(__fdiv_rn(fmaxf(sum, 0.0f), LN2));
}

// one (i, j, k) step into the running sum; see the note at the top
template <int METRIC>
__device__ __forceinline__ float step(float acc, float a, float b, float ah, float bh) {
  if (METRIC == JSD) {
    const float s = __fadd_rn(a, b);
    const float lg = lg2_approx(s);
    const float l = s > TWO_EPS ? lg : 1.0f;
    const float t = __fmaf_rn(-s, l, __fadd_rn(ah, bh));
    // an equal bin's term is exactly 0: skip it (a predicated add), so
    // identical rows give 0 as the float64 function does
    asm("{\n .reg .pred p;\n setp.neu.f32 p, %1, %2;\n @p add.rn.f32 %0, %0, %3;\n}"
        : "+f"(acc) : "f"(a), "f"(b), "f"(t));
    return acc;
  } else {
    const float d = __fsub_rn(a, b);
    const float s = fmaxf(__fadd_rn(a, b), EPS);
    return __fmaf_rn(__fmul_rn(d, d), rcp_approx(s), acc);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage K columns [k0, k0 + KC) of rows [row0, row0 + rows) of g (row
// stride ld) into raw[tile_rows][KC], zero past the rows and past K.
// vec: 16-byte cp.async copies (ld and g allow them); else plain loads.
template <typename T>
__device__ __forceinline__ void stage(T* raw, const T* __restrict__ g, int row0, int rows,
                                      int tile_rows, int ld, int k0, int k, bool vec) {
  constexpr int V = 16 / sizeof(T);  // elements a copy: 4 fp32, 8 bf16
  constexpr int SEGS = KC / V;
  if (vec) {
    for (int e = threadIdx.x; e < tile_rows * SEGS; e += THREADS) {
      const int r = e / SEGS, sg = e % SEGS, gk = k0 + sg * V;
      const bool in = r < rows && gk < k;  // ld % V == 0: a copy is all in or all out
      cp_async16(raw + r * KC + sg * V, in ? g + (size_t)(row0 + r) * ld + gk : g, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < tile_rows * KC; e += THREADS) {
      const int r = e / KC, kk = e % KC, gk = k0 + kk;
      raw[e] = (r < rows && gk < k) ? g[(size_t)(row0 + r) * ld + gk] : zero<T>();
    }
  }
}

// raw[tile_rows][KC] -> v[KC][tile_rows + PAD] (and, for JSD, h: v log2 v + v)
template <int METRIC, typename T>
__device__ __forceinline__ void transform(const T* raw, float* v, float* h, int tile_rows) {
  for (int e = threadIdx.x; e < tile_rows * KC; e += THREADS) {
    const int r = e / KC, kk = e % KC;
    const float val = widen(raw[e]);
    v[kk * (tile_rows + PAD) + r] = val;
    if (METRIC == JSD) h[kk * (tile_rows + PAD) + r] = entropy_term(val);
  }
}

// the R values of a thread's rows (or columns) at one k: groups of VR
// neighbours, groups TY * VR apart
template <int R>
__device__ __forceinline__ void load_frag(float (&f)[R], const float* p, int t) {
  constexpr int VR = R < 4 ? R : 4;
  if (VR == 4) {
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      const float4 q = *reinterpret_cast<const float4*>(p + g * TY * 4 + t * 4);
      f[4 * g] = q.x;
      f[4 * g + 1] = q.y;
      f[4 * g + 2] = q.z;
      f[4 * g + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) f[i] = p[i * TY + t];
  }
}

template <int R>
__device__ __forceinline__ int frag_index(int i, int t) {
  constexpr int VR = R < 4 ? R : 4;
  return (i / VR) * (TY * VR) + t * VR + i % VR;
}

template <typename YT, int METRIC, bool MASKED, int R, int C>
__global__ void __launch_bounds__(THREADS, R * C > 1 ? 2 : 1)
prob_tile_kernel(const float* __restrict__ x, const YT* __restrict__ y,
                 const int* __restrict__ mask, float* __restrict__ out,
                 int m, int n, int k, int bm, int bn, int mask_cols, bool vec_x, bool vec_y,
                 float accurate_below) {
  constexpr int TM = TY * R;
  constexpr int TN = TX * C;
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

  extern __shared__ __align__(16) unsigned char smem[];
  float* raw_x = reinterpret_cast<float*>(smem);                 // [2][TM][KC]
  YT* raw_y = reinterpret_cast<YT*>(raw_x + 2 * TM * KC);        // [2][TN][KC]
  float* xs = reinterpret_cast<float*>(raw_y + 2 * TN * KC);     // [KC][TM + PAD]
  float* ys = xs + KC * (TM + PAD);                              // [KC][TN + PAD]
  float* xh = ys + KC * (TN + PAD);                              // JSD: x log2 x + x
  float* yh = xh + KC * (TM + PAD);                              // JSD: y log2 y + y

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;

  const int chunks = (k + KC - 1) / KC;
  if (chunks > 0) {
    stage(raw_x, x, r0, rows, TM, k, 0, k, vec_x);
    stage(raw_y, y, c0, cols, TN, k, 0, k, vec_y);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    // the stage written here was last read by the transform of chunk c - 1,
    // which every thread finished before the barrier ahead of its compute
    if (c + 1 < chunks) {
      const int nb = (c + 1) & 1;
      stage(raw_x + nb * TM * KC, x, r0, rows, TM, k, (c + 1) * KC, k, vec_x);
      stage(raw_y + nb * TN * KC, y, c0, cols, TN, k, (c + 1) * KC, k, vec_y);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c landed; every thread is done computing c - 1
    const int b = c & 1;
    transform<METRIC>(raw_x + b * TM * KC, xs, xh, TM);
    transform<METRIC>(raw_y + b * TN * KC, ys, yh, TN);
    __syncthreads();
    // past the end of K every staged value is 0 and adds exactly 0; JSD's
    // 8 x 8 micro-tile with its entropy terms leaves no registers for two
    // k steps in flight
#pragma unroll(METRIC == JSD ? 1 : 2)
    for (int kk = 0; kk < KC; ++kk) {
      float a[R], bv[C], ah[R], bh[C];
      load_frag<R>(a, xs + kk * (TM + PAD), ty);
      load_frag<C>(bv, ys + kk * (TN + PAD), tx);
      if (METRIC == JSD) {
        load_frag<R>(ah, xh + kk * (TM + PAD), ty);
        load_frag<C>(bh, yh + kk * (TN + PAD), tx);
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) ah[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < C; ++j) bh[j] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = step<METRIC>(acc[i][j], a[i], bv[j], ah[i], bh[j]);
    }
  }

  constexpr int VC = C < 4 ? C : 4;
  const bool vec_out = VC == 4 && (n % 4) == 0;
  // JSD: the live cells (bit i * C + j) whose fast sum is below
  // accurate_below, recomputed after the stores by jsd_accurate
  unsigned long long recheck = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = frag_index<R>(i, ty);
    if (r >= rows) continue;
    const int gr = r0 + r;
    float* orow = out + (size_t)gr * n;
#pragma unroll
    for (int g = 0; g < C / VC; ++g) {
      float v[VC];
#pragma unroll
      for (int q = 0; q < VC; ++q) {
        const int gc = c0 + frag_index<C>(g * VC + q, tx);
        const float s = __fmul_rn(0.5f, acc[i][g * VC + q]);
        v[q] = sqrtf(fmaxf(s, 0.0f));
        if (MASKED && gc < n && mask[(size_t)(gr / bm) * mask_cols + gc / bn] == 0)
          v[q] = pos_inf();
        else if (METRIC == JSD && s < accurate_below && gc < n)
          recheck |= 1ull << (i * C + g * VC + q);
      }
      const int c = frag_index<C>(g * VC, tx);
      if (vec_out && c + VC <= cols) {
        *reinterpret_cast<float4*>(orow + c0 + c) = make_float4(v[0], v[VC > 1 ? 1 : 0],
                                                                v[VC > 2 ? 2 : 0], v[VC > 3 ? 3 : 0]);
      } else {
#pragma unroll
        for (int q = 0; q < VC; ++q)
          if (c + q < cols) orow[c0 + c + q] = v[q];
      }
    }
  }
  if (METRIC == JSD) {
    static_assert(R * C <= 64, "one recheck bit a cell");
    while (recheck != 0) {  // rare: near duplicates only
      const int e = __ffsll(static_cast<long long>(recheck)) - 1;
      recheck &= recheck - 1;
      const int gr = r0 + frag_index<R>(e / C, ty);
      const int gc = c0 + frag_index<C>(e % C, tx);
      out[(size_t)gr * n + gc] = jsd_accurate(x + (size_t)gr * k, y + (size_t)gc * k, k);
    }
  }
}

// The fast sum S (JSD^2 in bits) below which a JSD cell is recomputed by
// jsd_accurate: S at d = 0.05 plus the fast sum's own error bound there
// (note at the top), so every cell whose exact distance is below 0.05 is
// recomputed, and every cell that is not comes out at 0.05 or above.
// core/precision.py::jsd_accurate_below computes the same.
float jsd_accurate_below(int k) {
  const double u = 0x1p-24, s = 0.05 * 0.05;
  const double log_k = std::log2(static_cast<double>(k > 1 ? k : 1));
  return static_cast<float>(s + 0x1p-22 * (1 + log_k) + u * (6 * log_k + 2) +
                            (k + 1) * u * 2 * s);
}

constexpr int MAX_DEVICES = 64;  // devices whose SM count and attributes are cached

int sm_count(int dev) {
  static std::atomic<int> cached[MAX_DEVICES];
  int sms = dev < MAX_DEVICES ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (dev < MAX_DEVICES) cached[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

template <typename YT, int METRIC, bool MASKED, int R, int C>
int launch_shape(const float* x, const YT* y, const int* mask, float* out, int m, int n,
                 int k, int bm, int bn, int dev, cudaStream_t stream) {
  constexpr int TM = TY * R;
  constexpr int TN = TX * C;
  constexpr int SIDES = METRIC == JSD ? 2 : 1;  // JSD adds the entropy-term arrays
  constexpr size_t SMEM = 2 * TM * KC * sizeof(float) + 2 * TN * KC * sizeof(YT) +
                          SIDES * KC * (TM + PAD + TN + PAD) * sizeof(float);
  auto kernel = prob_tile_kernel<YT, METRIC, MASKED, R, C>;
  // the shared-memory limit is an attribute of the function on a device:
  // set once per device
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (dev >= MAX_DEVICES || !smem_set[dev].load(std::memory_order_acquire)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) smem_set[dev].store(true, std::memory_order_release);
  }
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec_x = k % 4 == 0 && aligned(x);
  const bool vec_y = (k * sizeof(YT)) % 16 == 0 && aligned(y);
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  const int mask_cols = MASKED ? (n + bn - 1) / bn : 0;
  kernel<<<grid, THREADS, SMEM, stream>>>(x, y, mask, out, m, n, k, bm, bn, mask_cols, vec_x,
                                          vec_y, METRIC == JSD ? jsd_accurate_below(k) : 0.0f);
  return static_cast<int>(cudaGetLastError());
}

template <typename YT, int METRIC, bool MASKED>
int launch(const float* x, const YT* y, const int* mask, float* out, int m, int n, int k,
           int bm, int bn, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wide_blocks = (long long)((m + WIDE - 1) / WIDE) * ((n + WIDE - 1) / WIDE);
  if (wide_blocks >= sm_count(dev))
    return launch_shape<YT, METRIC, MASKED, 8, 8>(x, y, mask, out, m, n, k, bm, bn, dev, s);
  return launch_shape<YT, METRIC, MASKED, 1, 1>(x, y, mask, out, m, n, k, bm, bn, dev, s);
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
