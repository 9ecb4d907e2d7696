// Barnes-Hut grouped force sweep for Hopper (sm_90a).
//
// Replaces: nbody_simulation_tpu/ops/traversal.py:_sweep_kernel (monopole),
// as called by _grouped_force (the full sweep) and _grouped_force_bucketed
// (the occupancy-bucketed sweep). The per-group column bound `col_limit`
// takes the place of the bucketed variant's two static-width calls, its
// scalar-prefetch block permutation and its lax.cond budget guard, with the
// same result: trailing zero-mass columns add exactly +-0.
//
// Computes, for every group g and target s:
//   out[g,s] = sum_{c < col_limit[g] (or C)} f(src[g,c] - tgt[g,s], m[g,c])
// with f the reference law of mono_tile (nbody_simulation_tpu/ops/
// allpairs.py:52-100; reference src/main.rs:234-253) in one of five modes:
//   0 exact         IEEE division, numerator first (ops/force.py:49)
//   1 newton        rcp.approx.f32 plus one Newton step
//   2 approx        rcp.approx.f32 alone
//   3 newton+clamp  as 1, max(s, L1_CLAMP) in place of the is_normal mask
//   4 approx+clamp  as 2, likewise
// Every arithmetic step is an explicit round-to-nearest intrinsic so nvcc
// contracts nothing into an FMA: the per-pair terms follow the reference's
// operation order. rcp.approx.f32 is the non-.ftz form, because the
// s >= FLT_MIN_NORMAL guard assumes subnormal denominators are not flushed.
// Build without --use_fast_math.
//
// What bounds it: at the galaxy's main-path shape (G=1024 groups, S=256
// targets, C=1280 columns) the sources are 15.7 MB, read once, and there
// are 335M pair evaluations, each about 20 FP32 operations and one MUFU
// reciprocal. So the FP32 and reciprocal pipes bound it, not memory (a
// data-sheet estimate, to be replaced by the time measured on the card).
//
// What the design does about it: one reciprocal per pair and no reduction
// across threads. One block per (group, 256-target chunk), one target per
// thread, sums in registers in column order (deterministic, no atomics).
// The group's (x, y, m) columns are staged through shared memory in tiles
// of 1024 columns and read as broadcasts.
//
// Summation: each run of 32 columns is summed on its own and the run sums
// are added into the total. A plain running sum loses every term below half
// an ulp of the partial sum; on the galaxy a heavy node's COM often comes
// first, and then most of the later terms were lost (measured 5.4e-5 of
// sum|c| against the pairwise torch sum on an H100). The two-level sum bounds
// the error by about (32 + C/32) ulps of sum|c|, for one extra add per run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // targets per block
constexpr int kTile = 1024;    // source columns staged per pass
constexpr int kRun = 32;       // columns per inner sum (divides kTile)
constexpr float kFltMinNormal = 1.17549435e-38f;
constexpr float kFltMax = 3.4028235e38f;
constexpr float kL1Clamp = 1e-12f;  // ops/allpairs.py:L1_CLAMP

enum Mode { kExact = 0, kNewton = 1, kApprox = 2, kNewtonClamp = 3,
            kApproxClamp = 4 };

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Accumulate the contribution of one source (displacement dx, dy; mass m)
// into (ax, ay).
template <int MODE>
__device__ __forceinline__ void mono_pair(float dx, float dy, float m,
                                          float soft2, float& ax, float& ay) {
  const float s = __fadd_rn(fabsf(dx), fabsf(dy));
  const float d2 =
      fmaxf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), soft2);
  float cx, cy;
  if (MODE == kExact) {
    // pair_accel: is_normal mask, dead lanes divide by 1, select 0.
    const bool normal = (s >= kFltMinNormal) && (s <= kFltMax);
    const float den = normal ? __fmul_rn(s, d2) : 1.0f;
    cx = normal ? __fdiv_rn(__fmul_rn(dx, m), den) : 0.0f;
    cy = normal ? __fdiv_rn(__fmul_rn(dy, m), den) : 0.0f;
  } else {
    float den, r;
    if (MODE == kNewtonClamp || MODE == kApproxClamp) {
      den = __fmul_rn(fmaxf(s, kL1Clamp), d2);
      r = rcp_approx(den);
      if (MODE == kNewtonClamp)
        r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(den, r)));
    } else {
      const bool normal = (s >= kFltMinNormal) && (s <= kFltMax);
      den = __fmul_rn(s, d2);
      r = rcp_approx(den);
      if (MODE == kNewton)
        r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(den, r)));
      r = normal ? r : 0.0f;
    }
    const float w = __fmul_rn(m, r);
    cx = __fmul_rn(dx, w);
    cy = __fmul_rn(dy, w);
  }
  ax = __fadd_rn(ax, cx);
  ay = __fadd_rn(ay, cy);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
grouped_sweep_kernel(const float2* __restrict__ tgt,
                     const float* __restrict__ src_x,
                     const float* __restrict__ src_y,
                     const float* __restrict__ src_m,
                     const int* __restrict__ col_limit,
                     float2* __restrict__ out, int S, int C, float soft2) {
  __shared__ float sh_x[kTile];
  __shared__ float sh_y[kTile];
  __shared__ float sh_m[kTile];

  const int g = blockIdx.x;
  const int s = blockIdx.y * kThreads + threadIdx.x;
  const bool live = s < S;
  const size_t trow = static_cast<size_t>(g) * S;
  const float2 t = live ? tgt[trow + s] : make_float2(0.0f, 0.0f);

  int limit = C;
  if (col_limit != nullptr) limit = min(max(col_limit[g], 0), C);
  const size_t srow = static_cast<size_t>(g) * C;
  const float* gx = src_x + srow;
  const float* gy = src_y + srow;
  const float* gm = src_m + srow;

  float ax = 0.0f, ay = 0.0f;
  for (int base = 0; base < limit; base += kTile) {
    const int n = min(kTile, limit - base);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < n; i += kThreads) {
      sh_x[i] = gx[base + i];
      sh_y[i] = gy[base + i];
      sh_m[i] = gm[base + i];
    }
    __syncthreads();
    if (live) {
      for (int j0 = 0; j0 < n; j0 += kRun) {
        const int j1 = min(j0 + kRun, n);
        float rx = 0.0f, ry = 0.0f;
#pragma unroll 4
        for (int j = j0; j < j1; ++j) {
          const float dx = __fsub_rn(sh_x[j], t.x);
          const float dy = __fsub_rn(sh_y[j], t.y);
          mono_pair<MODE>(dx, dy, sh_m[j], soft2, rx, ry);
        }
        ax = __fadd_rn(ax, rx);
        ay = __fadd_rn(ay, ry);
      }
    }
  }
  if (live) out[trow + s] = make_float2(ax, ay);
}

template <int MODE>
void launch(dim3 grid, cudaStream_t stream, const void* tgt, const void* sx,
            const void* sy, const void* sm, const void* col_limit, void* out,
            int S, int C, float soft2) {
  grouped_sweep_kernel<MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const float2*>(tgt), static_cast<const float*>(sx),
      static_cast<const float*>(sy), static_cast<const float*>(sm),
      static_cast<const int*>(col_limit), static_cast<float2*>(out), S, C,
      soft2);
}

}  // namespace

extern "C" {

// tgt f32[G,S,2], src_{x,y,m} f32[G,C], col_limit i32[G] or null,
// out f32[G,S,2]; all contiguous on `device`. Launches on `stream` and
// returns cudaGetLastError() (0 on success) without synchronising.
int grouped_sweep_launch(const void* tgt, const void* src_x,
                         const void* src_y, const void* src_m,
                         const void* col_limit, void* out, int G, int S,
                         int C, float softening2, int mode, int device,
                         void* stream) {
  if (G <= 0 || S <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G, (S + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kExact:
      launch<kExact>(grid, st, tgt, src_x, src_y, src_m, col_limit, out, S,
                     C, softening2);
      break;
    case kNewton:
      launch<kNewton>(grid, st, tgt, src_x, src_y, src_m, col_limit, out, S,
                      C, softening2);
      break;
    case kApprox:
      launch<kApprox>(grid, st, tgt, src_x, src_y, src_m, col_limit, out, S,
                      C, softening2);
      break;
    case kNewtonClamp:
      launch<kNewtonClamp>(grid, st, tgt, src_x, src_y, src_m, col_limit, out,
                           S, C, softening2);
      break;
    case kApproxClamp:
      launch<kApproxClamp>(grid, st, tgt, src_x, src_y, src_m, col_limit, out,
                           S, C, softening2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
