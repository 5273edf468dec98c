// l2 distance tiles of the BSS engine: the unmasked (m, n) distance matrix
// (query -> pivot distances) and the masked exact phase.
//
// Replaces the Pallas kernels in src/repro/kernels/pairwise_dist.py:
// _l2_tile_kernel (:82) under _pairwise_call (pallas_call at :140), and the
// same tile under _masked_tile_kernel (:98) / _masked_call (pallas_call at
// :168).  Both compute
//     out[i, j] = sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0))
// (or the squared value), fp32 accumulation, in that order, and the masked
// form writes +inf into every element of a dead (bm x bn) cell.
//
// What bounds it on the H100.  The work is 2 fp32 operations (one FFMA)
// per live (i, j, k).  The CUDA cores do 132 SMs x 128 lanes x 2 operations
// per clock, 67 TFLOP/s at clocks.max.sm 1,980 MHz; the only fp32
// tensor-core path on Hopper is TF32 (a 10-bit mantissa), which breaks the
// 1e-5 contract and moves hits near a threshold, so there is no tensor-core
// form.  The main path's exact phase (512 queries x 101,504 corpus rows x
// K = 112) is 11.6 GFLOP if every cell lives: 0.17 ms.  Bytes (x and y
// once, the 208 MB output once, at 3.35 TB/s) take 0.06 ms.  So the tile is
// bound by operations, and the design has to keep the FFMA pipes fed: the
// shared loads, the staging and the output stores must hide behind FFMAs.
//
// Design (the staging of csrc/prob_dist.cu).  256 threads a block, 16 x 16,
// each an R x C micro-tile.  Two shapes, chosen by m and n: 128 x 128
// outputs (8 x 8 a thread; one block is one 128 x 128 engine cell) when
// that grid fills the card, else 16 x 16 (1 x 1 a thread), so the 512 x 16
// query -> pivot call still spreads over 32 blocks.  K is staged in chunks
// of 16 through two raw shared-memory stages filled by cp.async (16-byte
// copies, neighbouring threads on neighbouring addresses; 8 bf16 values a
// copy) while the previous chunk is computed; rows whose K or base address
// does not allow 16-byte copies are staged by plain loads.  A transform pass
// gives one thread each row of the chunk: it reads the row's 16 values
// (16-byte loads; the raw rows are padded so that these hit distinct
// banks), widens a bf16 y exactly (__bfloat162float), writes them into the
// k-major compute layout and adds them into the row's squared norm, so x
// and y are read from device memory once.  The compute loop reads a
// thread's 8 rows and 8 columns at one k with four 16-byte shared loads and
// does 64 FFMAs.  The epilogue stores 16 bytes at a time.  A block none of
// whose mask cells is live writes +inf with 16-byte stores and exits before
// loading anything; when the mask's cells are multiples of the block's
// tile (the engine's 128 x 128 cells), a live block is live everywhere and
// the epilogue tests no mask.  The wide shape is limited to 128 registers
// a thread, so that two blocks share an SM.
//
// Bits.  Each (i, j) is accumulated acc = fma(x_k, y_k, acc) for k = 0, 1,
// ..., K - 1 from 0 in one register (past K the staged values are 0 and add
// exactly 0); each squared norm is summed the same way; the epilogue is
// fma(-2, acc, |x|^2 + |y|^2) (2 acc is exact, so this is the reference's
// (xx + yy) - 2 xy), max with 0, and sqrt, all IEEE with explicit
// intrinsics.  So every (i, j) has the same bits whatever the mask, the
// block shape or the launch -- the bf16 re-check, which recomputes band
// cells under another mask, reads the fp32 pass's bits -- and the bf16-y
// form equals the fp32 form on the widened y.  These are also the bits of
// this port's first l2 tile (a 64 x 64 block, 4 x 4 a thread), which
// summed in the same order.  The kernel has no atomics.  Ragged edges are
// masked in the kernel (no padded copies).  The output comes from
// torch.empty, so every element is written.
//
// y may be float32 or bfloat16 (the engines' bf16 corpus mirror, which
// replaces the same Pallas calls compiled for a bf16 y: the Pallas tile
// upcasts on entry, pairwise_dist.py:83-84).  x stays float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int KC = 16;        // K chunk staged in shared memory
constexpr int TY = 16;        // thread rows of a block
constexpr int TX = 16;        // thread columns of a block
constexpr int THREADS = TY * TX;
constexpr int PAD = 4;        // compute rows stay 16-byte aligned
constexpr int WIDE = 128;     // output rows and columns of the wide shape

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// Elements a raw staged row holds: the chunk, then 16 bytes of padding, so
// that the transform's 16-byte row reads (rows 80 or 48 bytes apart) fall
// in distinct banks.
template <typename T>
__host__ __device__ constexpr int raw_ld() { return KC + 16 / static_cast<int>(sizeof(T)); }

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
// stride k) into raw[tile_rows][raw_ld], zero past the rows and past K.
// vec: 16-byte cp.async copies (k and g allow them); else plain loads.
template <typename T>
__device__ __forceinline__ void stage(T* raw, const T* __restrict__ g, int row0, int rows,
                                      int tile_rows, int k0, int k, bool vec) {
  constexpr int V = 16 / sizeof(T);  // elements a copy: 4 fp32, 8 bf16
  constexpr int SEGS = KC / V;
  constexpr int LD = raw_ld<T>();
  if (vec) {
    for (int e = threadIdx.x; e < tile_rows * SEGS; e += THREADS) {
      const int r = e / SEGS, sg = e % SEGS, gk = k0 + sg * V;
      const bool in = r < rows && gk < k;  // k % V == 0: a copy is all in or all out
      cp_async16(raw + r * LD + sg * V, in ? g + (size_t)(row0 + r) * k + gk : g, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < tile_rows * KC; e += THREADS) {
      const int r = e / KC, kk = e % KC, gk = k0 + kk;
      raw[r * LD + kk] = (r < rows && gk < k) ? g[(size_t)(row0 + r) * k + gk] : zero<T>();
    }
  }
}

// the KC values of one raw staged row as float32 (exact for both types)
__device__ __forceinline__ void load_row(const float* p, float (&v)[KC]) {
#pragma unroll
  for (int q = 0; q < KC / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&v)[KC]) {
#pragma unroll
  for (int q = 0; q < KC / 8; ++q) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[q];
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[8 * q + 2 * e] = __bfloat162float(__ushort_as_bfloat16(w[e] & 0xffffu));
      v[8 * q + 2 * e + 1] = __bfloat162float(__ushort_as_bfloat16(w[e] >> 16));
    }
  }
}

// One row of the landed chunk: raw row -> column `col` of the k-major
// compute layout v[KC][ldv], its squares added into `norm` in k order.
template <typename T>
__device__ __forceinline__ void transform_row(const T* raw_row, float* v, int ldv, int col,
                                              float& norm) {
  float vals[KC];
  load_row(raw_row, vals);
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    v[kk * ldv + col] = vals[kk];
    norm = __fmaf_rn(vals[kk], vals[kk], norm);
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

// +inf into rows x cols of the tile at (r0, c0)
template <int TM, int TN>
__device__ __forceinline__ void fill_dead(float* __restrict__ out, int n, int r0, int c0,
                                          int rows, int cols, bool vec_out) {
  if (vec_out && cols == TN && TN % 4 == 0) {
    const float4 inf4 = make_float4(pos_inf(), pos_inf(), pos_inf(), pos_inf());
    for (int e = threadIdx.x; e < rows * (TN / 4); e += THREADS) {
      const int r = e / (TN / 4), c = (e % (TN / 4)) * 4;
      *reinterpret_cast<float4*>(out + (size_t)(r0 + r) * n + c0 + c) = inf4;
    }
  } else {
    for (int e = threadIdx.x; e < TM * TN; e += THREADS) {
      const int r = e / TN, c = e % TN;
      if (r < rows && c < cols) out[(size_t)(r0 + r) * n + c0 + c] = pos_inf();
    }
  }
}

template <typename YT, bool MASKED, bool SQUARED, int R, int C>
__global__ void __launch_bounds__(THREADS, R * C > 1 ? 2 : 1)
l2_tile_kernel(const float* __restrict__ x, const YT* __restrict__ y,
               const int* __restrict__ mask, float* __restrict__ out,
               int m, int n, int k, int bm, int bn, int mask_cols, bool one_cell,
               bool vec_x, bool vec_y, bool vec_out) {
  constexpr int TM = TY * R;
  constexpr int TN = TX * C;
  constexpr int LDX = raw_ld<float>();
  constexpr int LDY = raw_ld<YT>();
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
      fill_dead<TM, TN>(out, n, r0, c0, rows, cols, vec_out);
      return;
    }
  }

  extern __shared__ __align__(16) unsigned char smem[];
  float* raw_x = reinterpret_cast<float*>(smem);                 // [2][TM][LDX]
  YT* raw_y = reinterpret_cast<YT*>(raw_x + 2 * TM * LDX);       // [2][TN][LDY]
  float* xs = reinterpret_cast<float*>(raw_y + 2 * TN * LDY);    // [KC][TM + PAD]
  float* ys = xs + KC * (TM + PAD);                              // [KC][TN + PAD]
  float* xn = ys + KC * (TN + PAD);                              // [TM] |x_r|^2
  float* yn = xn + TM;                                           // [TN] |y_c|^2

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;
  // threads [0, TM) own row threadIdx.x of x, [TM, TM + TN) row
  // threadIdx.x - TM of y: they transform it and sum its squared norm
  const bool owns_x = threadIdx.x < TM;
  const bool owns_y = !owns_x && threadIdx.x < TM + TN;
  const int own = owns_x ? threadIdx.x : threadIdx.x - TM;
  float norm = 0.0f;

  const int chunks = (k + KC - 1) / KC;
  if (chunks > 0) {
    stage(raw_x, x, r0, rows, TM, 0, k, vec_x);
    stage(raw_y, y, c0, cols, TN, 0, k, vec_y);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    // the stage written here was last read by the transform of chunk c - 1,
    // which every thread finished before the barrier ahead of its compute
    if (c + 1 < chunks) {
      const int nb = (c + 1) & 1;
      stage(raw_x + nb * TM * LDX, x, r0, rows, TM, (c + 1) * KC, k, vec_x);
      stage(raw_y + nb * TN * LDY, y, c0, cols, TN, (c + 1) * KC, k, vec_y);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c landed; every thread is done computing c - 1
    const int b = c & 1;
    if (owns_x) {
      transform_row(raw_x + (b * TM + own) * LDX, xs, TM + PAD, own, norm);
    } else if (owns_y) {
      transform_row(raw_y + (b * TN + own) * LDY, ys, TN + PAD, own, norm);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[R], bv[C];
      load_frag<R>(a, xs + kk * (TM + PAD), ty);
      load_frag<C>(bv, ys + kk * (TN + PAD), tx);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
    }
  }
  if (owns_x) {
    xn[own] = norm;
  } else if (owns_y) {
    yn[own] = norm;
  }
  __syncthreads();

  constexpr int VC = C < 4 ? C : 4;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = frag_index<R>(i, ty);
    if (r >= rows) continue;
    const int gr = r0 + r;
    const float xr = xn[r];
    float* orow = out + (size_t)gr * n;
#pragma unroll
    for (int g = 0; g < C / VC; ++g) {
      const int c = frag_index<C>(g * VC, tx);
      float v[VC];
#pragma unroll
      for (int q = 0; q < VC; ++q) {
        // reference order: (xx + yy) - 2 xy (2 xy is exact), clamp, sqrt
        const float sq =
            fmaxf(__fmaf_rn(-2.0f, acc[i][g * VC + q], __fadd_rn(xr, yn[c + q])), 0.0f);
        v[q] = SQUARED ? sq : __fsqrt_rn(sq);
        const int gc = c0 + c + q;
        if (MASKED && !one_cell && gc < n &&
            mask[(size_t)(gr / bm) * mask_cols + gc / bn] == 0)
          v[q] = pos_inf();
      }
      if (VC == 4 && vec_out && c + VC <= cols) {
        *reinterpret_cast<float4*>(orow + c0 + c) =
            make_float4(v[0], v[VC > 1 ? 1 : 0], v[VC > 2 ? 2 : 0], v[VC > 3 ? 3 : 0]);
      } else {
#pragma unroll
        for (int q = 0; q < VC; ++q)
          if (c + q < cols) orow[c0 + c + q] = v[q];
      }
    }
  }
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

template <typename YT, bool MASKED, bool SQUARED, int R, int C>
int launch_shape(const float* x, const YT* y, const int* mask, float* out, int m, int n,
                 int k, int bm, int bn, int dev, cudaStream_t stream) {
  constexpr int TM = TY * R;
  constexpr int TN = TX * C;
  constexpr size_t SMEM = 2 * TM * raw_ld<float>() * sizeof(float) +
                          2 * TN * raw_ld<YT>() * sizeof(YT) +
                          (KC * (TM + PAD + TN + PAD) + TM + TN) * sizeof(float);
  auto kernel = l2_tile_kernel<YT, MASKED, SQUARED, R, C>;
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
  const bool vec_out = n % 4 == 0 && aligned(out);
  // mask cells that are whole multiples of the tile: a block lies in one cell
  const bool one_cell = MASKED && bm % TM == 0 && bn % TN == 0;
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  const int mask_cols = MASKED ? (n + bn - 1) / bn : 0;
  kernel<<<grid, THREADS, SMEM, stream>>>(x, y, mask, out, m, n, k, bm, bn, mask_cols, one_cell,
                                          vec_x, vec_y, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename YT, bool MASKED, bool SQUARED>
int launch_sq(const float* x, const YT* y, const int* mask, float* out, int m, int n, int k,
              int bm, int bn, int dev, cudaStream_t s) {
  const long long wide_blocks = (long long)((m + WIDE - 1) / WIDE) * ((n + WIDE - 1) / WIDE);
  if (wide_blocks >= sm_count(dev))
    return launch_shape<YT, MASKED, SQUARED, 8, 8>(x, y, mask, out, m, n, k, bm, bn, dev, s);
  return launch_shape<YT, MASKED, SQUARED, 1, 1>(x, y, mask, out, m, n, k, bm, bn, dev, s);
}

template <typename YT, bool MASKED>
int launch(const float* x, const YT* y, const int* mask, float* out, int m, int n, int k,
           int bm, int bn, int squared, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (squared) return launch_sq<YT, MASKED, true>(x, y, mask, out, m, n, k, bm, bn, dev, s);
  return launch_sq<YT, MASKED, false>(x, y, mask, out, m, n, k, bm, bn, dev, s);
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
