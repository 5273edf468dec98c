// Planar lower bound of the BSS bound phase:
//     lb[q, b] = max_m dist2d(apex_m(q), box[b, m])
// with the apex of query q on plane m projected from its distances (d1, d2)
// to the plane's two pivots:
//     delta = max(raw_delta, MIN_DELTA)
//     x = raw_delta < DEGENERATE_DELTA ? 0 : (d1*d1 - d2*d2) / (2*delta)
//     y = sqrt(max(d1*d1 - (x + delta/2)^2, 0))
// Two entry points run the one kernel: planar_lower_bound takes d1 and d2
// as (Q, M) matrices; planar_lower_bound_pairs takes the (Q, P)
// query -> pivot matrix and the (M, 2) int64 pivot pairs, and reads
// d1 = dqp[q, pairs[m, 0]], d2 = dqp[q, pairs[m, 1]] itself (a gather is
// exact, so both give the same bits).
//
// Replaces the Pallas kernel _lb_tile_kernel (src/repro/kernels/
// planar_exclusion.py:41) under planar_lower_bound_kernel_call (:73,
// pallas_call at :105); the pairs form also replaces the two gathers its
// callers made before it.
//
// What bounds it on the H100: instruction issue.  Each (query, block,
// plane) term is 9.5 instructions: 4 FADD (the subtractions), 2 FMUL,
// 1 FADD, 2 VIMNMX for max(lo - p, p - hi, 0) of x and y, and half a
// 3-way VIMNMX for the running max over planes (two planes a time).  A
// scheduler issues one warp instruction a clock: 128 lanes per SM per
// clock, the fp32 add / multiply rate.  Integer min / max runs at 64 per
// SM per clock (CUDA C++ Programming Guide, arithmetic instruction
// throughput, compute capability 9.0; it has no row for the DPX
// instructions, taken at that rate), so the 2.5 fit beside the issue of
// 9.5.  At the main path's shapes (512 queries x 793 blocks x 24 planes,
// 9.7 M terms) that is 93 M instructions: 2.8 us on 132 SMs at 1,980 MHz
// (3.5 us for the 12 of fmaxf's form, 5 FMNMX), against 1.8 MB of inputs
// and output, 0.5 us at 3.35 TB/s.
//
// Design:
// - A warp owns 4 queries x 64 blocks: lane l keeps the running maxima of
//   blocks l and l + 32 for the 4 queries, a 4 x 2 register micro-tile.
//   One box float4 feeds 4 queries and one apex float4 (two queries'
//   (x, y)) feeds 4 terms.  A CTA is 16 such warps, 64 queries x 64
//   blocks: 8 x 13 = 104 CTAs at the main shape, one wave, 4 warp tiles on
//   each busy scheduler -- as many as 8-warp CTAs (208, two on most SMs)
//   give, but each box is staged for 64 queries, not 32: half the bytes
//   from L2, which all CTAs ask for at once.  A warp past the last query
//   stages and projects but skips the chunk loop.
// - The planes go in chunks of 24, so shared memory does not grow with M.
//   A chunk's boxes for the CTA's 64 blocks are copied with 16-byte
//   cp.async, neighbouring threads on neighbouring float4s of a block's
//   row, into rows padded to 25 float4s, so the 8 lanes of each
//   quarter-warp's 16-byte read hit 8 distinct bank groups.
// - Before the copy is issued (it would queue ahead of them), each lane
//   loads the pivot distances of 3 of the warp's 4 x 24 (query, plane)
//   apexes -- reading the plane's pivot pair itself in the pairs form --
//   and projects them (one IEEE division and sqrt each) while the boxes
//   land, into the warp's slice of shared memory, read back as
//   broadcasts.
// - The output row is written by consecutive lanes (4-byte stores, 128
//   bytes a warp), whatever the parity of B.
// What holds it on the card (PERF.md; chip_smoke.py --tiles-only, "planar
// alone", times it at 24 and 48 planes): a fixed cost a launch -- the
// launch, the copy and the projection before the first plane, the stores
// -- beside a chunk loop that issues below the scheduler's rate.
//
// Bits: every product, sum and difference is spelled as an _rn intrinsic,
// so no FMA contraction can change a rounding and the bound equals its
// plain PyTorch version bit for bit with no compiler flag (never
// --use_fast_math: the division and the sqrt stay IEEE).  delta/2 is taken
// as delta * 0.5, the same correctly rounded value.  The max over planes is
// taken of dx^2 + dy^2, as int bits (every one is >= +0, so ints order them
// as floats), and the sqrt once at the end: sqrt is monotone and correctly
// rounded, so that is max_m of the square roots.  Padded blocks carry
// +-3e38 sentinel boxes; dx*dx overflows to +inf and the bound is +inf,
// with no special case.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int R = 4;            // queries per warp, all in each thread
constexpr int C = 2;            // blocks per lane: lane and lane + 32
constexpr int QT = WARPS * R;   // queries per CTA
constexpr int BT = 32 * C;      // blocks per CTA
constexpr int MC = 24;          // planes per staged chunk
constexpr int STRIDE = MC + 1;  // float4s per staged box row (odd)
constexpr int AK = (R * MC + 31) / 32;  // apexes per lane per chunk
// repro_torch/core/constants.py
constexpr float MIN_DELTA = 1e-12f;
constexpr float DEGENERATE_DELTA = 1e-6f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int bits(float x) { return __float_as_int(x); }

// max(a, b, 0) as one DPX instruction on the floats' bit patterns: a
// non-negative float orders as its bits do as an int, and any negative
// float (-0 too) is a negative int, so the result is the float max(a, b)
// when that is positive and +0 otherwise -- fmaxf(fmaxf(a, b), 0) up to
// the sign of a zero, which the square that follows removes
__device__ __forceinline__ float relu_max(float a, float b) {
  return __int_as_float(__vimax_s32_relu(bits(a), bits(b)));
}

// dist2d(apex, box)^2 of one (query, block, plane) term
__device__ __forceinline__ float box_term(const float4 bx, float px, float py) {
  const float dx = relu_max(__fsub_rn(bx.x, px), __fsub_rn(px, bx.y));
  const float dy = relu_max(__fsub_rn(bx.z, py), __fsub_rn(py, bx.w));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// the apex (x, y) of a query at distances (u, v) from a plane's pivots
__device__ __forceinline__ float2 apex(float u, float v, float raw) {
  const float delta = fmaxf(raw, MIN_DELTA);
  const float uu = __fmul_rn(u, u);
  const float x = raw < DEGENERATE_DELTA
                      ? 0.0f
                      : __fdiv_rn(__fsub_rn(uu, __fmul_rn(v, v)), __fmul_rn(2.0f, delta));
  const float h = __fadd_rn(x, __fmul_rn(delta, 0.5f));
  return make_float2(x, __fsqrt_rn(fmaxf(__fsub_rn(uu, __fmul_rn(h, h)), 0.0f)));
}

// d1 of query row at plane mi is d1[row * ld + c1], d2 is d2[row * ld + c2]
// with (c1, c2) = pairs[mi] when pairs is given, else (mi, mi)
__global__ void __launch_bounds__(THREADS)
planar_lb_kernel(const float* __restrict__ d1, const float* __restrict__ d2, int ld,
                 const long long* __restrict__ pairs, const float* __restrict__ deltas,
                 const float4* __restrict__ boxes, float* __restrict__ out,
                 int q, int m, int b) {
  __shared__ float4 sbox[BT * STRIDE];
  // per warp and plane, the (x, y) of its R queries
  __shared__ __align__(16) float2 sapex[WARPS][MC][R];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * BT;
  const int qw = blockIdx.y * QT + warp * R;  // the warp's first query
  const float4* row0 = sbox + lane * STRIDE;
  const float4* row1 = sbox + (lane + 32) * STRIDE;
  // running max over planes of dist2d^2, as int bits (all are >= +0)
  int best[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) best[r][c] = 0;

  auto terms = [&](int j, int (&s)[R][C]) {
    const float4 a01 = reinterpret_cast<const float4*>(sapex[warp][j])[0];
    const float4 a23 = reinterpret_cast<const float4*>(sapex[warp][j])[1];
    const float px[R] = {a01.x, a01.z, a23.x, a23.z};
    const float py[R] = {a01.y, a01.w, a23.y, a23.w};
    const float4 bx[C] = {row0[j], row1[j]};
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) s[r][c] = bits(box_term(bx[c], px[r], py[r]));
  };

  for (int m0 = 0; m0 < m; m0 += MC) {
    const int mc = min(MC, m - m0);
    if (m0 > 0) __syncthreads();  // every warp is done with the last chunk
    // the warp's R x mc apexes, AK per lane: their distances are loaded
    // first, or the box copy below would queue ahead of them
    int jk[AK], rk[AK];
    float raw[AK], u[AK], v[AK];
#pragma unroll
    for (int k = 0; k < AK; ++k) {
      const int e = lane + 32 * k;
      rk[k] = e / MC;
      jk[k] = e % MC;
      const int mi = m0 + min(jk[k], mc - 1);
      int c1 = mi, c2 = mi;
      if (pairs != nullptr) {
        c1 = static_cast<int>(pairs[2 * mi]);
        c2 = static_cast<int>(pairs[2 * mi + 1]);
      }
      raw[k] = deltas[mi];
      // rows past q (and lanes past R x MC) read row q - 1
      const size_t row = min(qw + min(rk[k], R - 1), q - 1);
      u[k] = d1[row * ld + c1];
      v[k] = d2[row * ld + c2];
    }
    // the chunk's boxes for the CTA's BT blocks: neighbouring threads copy
    // neighbouring float4s of a block's row
    for (int e = threadIdx.x; e < BT * MC; e += THREADS) {
      const int i = e / MC, j = e % MC;
      if (j < mc && b0 + i < b)
        cp_async16(&sbox[i * STRIDE + j], boxes + (size_t)(b0 + i) * m + m0 + j);
    }
    // while they land, project
#pragma unroll
    for (int k = 0; k < AK; ++k)
      if (rk[k] < R && jk[k] < mc) sapex[warp][jk[k]][rk[k]] = apex(u[k], v[k], raw[k]);
    cp_async_wait_all();
    __syncthreads();

    if (qw >= q) continue;  // a warp past the last query only stages
    // two planes at a time: one 3-way DPX max per output
    int j = 0;
#pragma unroll 2
    for (; j + 1 < mc; j += 2) {
      int s0[R][C], s1[R][C];
      terms(j, s0);
      terms(j + 1, s1);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) best[r][c] = __vimax3_s32(best[r][c], s0[r][c], s1[r][c]);
    }
    if (j < mc) {
      int s0[R][C];
      terms(j, s0);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) best[r][c] = max(best[r][c], s0[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = qw + r;
    if (row >= q) break;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int bi = b0 + lane + 32 * c;
      if (bi < b) out[(size_t)row * b + bi] = __fsqrt_rn(__int_as_float(best[r][c]));
    }
  }
}

int launch(const float* d1, const float* d2, int ld, const long long* pairs,
           const float* deltas, const float* boxes, float* out, int q, int m, int b,
           void* stream) {
  const dim3 grid((b + BT - 1) / BT, (q + QT - 1) / QT);
  planar_lb_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      d1, d2, ld, pairs, deltas, reinterpret_cast<const float4*>(boxes), out, q, m, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d1, d2 (q, m), deltas (m,), boxes (b, m, 4) 16-byte aligned, out (q, b):
// float32, row-major, contiguous, on the current device.  Returns the
// cudaError_t of the launch.
extern "C" int planar_lower_bound(const float* d1, const float* d2,
                                  const float* deltas, const float* boxes,
                                  float* out, int q, int m, int b,
                                  void* stream) {
  return launch(d1, d2, m, nullptr, deltas, boxes, out, q, m, b, stream);
}

// dqp (q, p) float32 and pairs (m, 2) int64 with every entry in [0, p) (the
// caller checks that once, where the index is built), the rest as above.
extern "C" int planar_lower_bound_pairs(const float* dqp, const long long* pairs,
                                        const float* deltas, const float* boxes,
                                        float* out, int q, int p, int m, int b,
                                        void* stream) {
  return launch(dqp, dqp, p, pairs, deltas, boxes, out, q, m, b, stream);
}
