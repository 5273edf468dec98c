// Planar lower bound of the BSS bound phase:
//     lb[q, b] = max_m dist2d(apex_m(q), box[b, m])
// with the apex of query q on plane m projected from its distances (d1, d2)
// to the plane's two pivots:
//     delta = max(raw_delta, MIN_DELTA)
//     x = raw_delta < DEGENERATE_DELTA ? 0 : (d1*d1 - d2*d2) / (2*delta)
//     y = sqrt(max(d1*d1 - (x + delta/2)^2, 0))
//
// Replaces the Pallas kernel _lb_tile_kernel (src/repro/kernels/
// planar_exclusion.py:41) under planar_lower_bound_kernel_call (:73,
// pallas_call at :105).
//
// What bounds it on the H100: operations.  At the main path's shapes
// (512 queries x 793 blocks x 24 planes) it does ~11 fp32 operations per
// (query, block, plane) -- 107 M in all, 1.6 us at 67 TFLOP/s -- against
// 1.8 MB of inputs and output, 0.5 us at 3.35 TB/s.  Both are far below a
// launch, so in practice it is bound by latency.
//
// Design: one thread per (query, block).  A block of 8 queries x 32 index
// blocks first projects its 8 queries onto all M planes into shared memory
// (each apex once, not once per index block), then each thread walks the M
// planes reading its box row as one float4 and keeps max_m (dx^2 + dy^2);
// the sqrt is taken once at the end, which is bitwise the same as max_m of
// the square roots because sqrtf is monotone and correctly rounded.
// Threads along x cover consecutive blocks, so the output row is written
// coalesced.  Built with -fmad=false: no product is contracted into an FMA,
// so the bound equals its plain PyTorch version bit for bit (sqrtf and the
// division stay IEEE: never --use_fast_math).  Padded blocks carry +-3e38
// sentinel boxes; dx*dx overflows to +inf and the bound is +inf, with no
// special case.

#include <cuda_runtime.h>

namespace {

constexpr int BT = 32;  // index blocks per CUDA block (x)
constexpr int QT = 8;   // queries per CUDA block (y)
// repro_torch/core/constants.py
constexpr float MIN_DELTA = 1e-12f;
constexpr float DEGENERATE_DELTA = 1e-6f;

__global__ void __launch_bounds__(BT * QT)
planar_lb_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                 const float* __restrict__ deltas,
                 const float4* __restrict__ boxes, float* __restrict__ out,
                 int q, int m, int b) {
  extern __shared__ float apex[];  // qx[QT][m], then qy[QT][m]
  float* sqx = apex;
  float* sqy = apex + QT * m;
  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.y * BT + threadIdx.x;
  for (int i = tid; i < QT * m; i += BT * QT) {
    const int row = q0 + i / m, mi = i % m;
    float ax = 0.0f, ay = 0.0f;
    if (row < q) {
      const float a = d1[(size_t)row * m + mi];
      const float c = d2[(size_t)row * m + mi];
      const float raw = deltas[mi];
      const float delta = fmaxf(raw, MIN_DELTA);
      ax = raw < DEGENERATE_DELTA ? 0.0f : (a * a - c * c) / (2.0f * delta);
      const float h = ax + delta / 2.0f;
      ay = sqrtf(fmaxf(a * a - h * h, 0.0f));
    }
    sqx[i] = ax;
    sqy[i] = ay;
  }
  __syncthreads();

  const int bi = blockIdx.x * BT + threadIdx.x;
  const int row = q0 + threadIdx.y;
  if (bi >= b || row >= q) return;
  const float* px = sqx + threadIdx.y * m;
  const float* py = sqy + threadIdx.y * m;
  const float4* box = boxes + (size_t)bi * m;
  float best = 0.0f;
  for (int mi = 0; mi < m; ++mi) {
    const float4 bx = box[mi];  // x_lo, x_hi, y_lo, y_hi
    const float dx = fmaxf(fmaxf(bx.x - px[mi], px[mi] - bx.y), 0.0f);
    const float dy = fmaxf(fmaxf(bx.z - py[mi], py[mi] - bx.w), 0.0f);
    best = fmaxf(best, dx * dx + dy * dy);
  }
  out[(size_t)row * b + bi] = sqrtf(best);
}

}  // namespace

// d1, d2 (q, m), deltas (m,), boxes (b, m, 4) 16-byte aligned, out (q, b):
// float32, row-major, contiguous, on the current device.  Needs
// 2 * 8 * m floats of shared memory.  Returns the cudaError_t of the launch.
extern "C" int planar_lower_bound(const float* d1, const float* d2,
                                  const float* deltas, const float* boxes,
                                  float* out, int q, int m, int b,
                                  void* stream) {
  const dim3 grid((b + BT - 1) / BT, (q + QT - 1) / QT);
  const dim3 block(BT, QT);
  const size_t smem = 2 * QT * (size_t)m * sizeof(float);
  planar_lb_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      d1, d2, deltas, reinterpret_cast<const float4*>(boxes), out, q, m, b);
  return static_cast<int>(cudaGetLastError());
}
