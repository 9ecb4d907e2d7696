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
// with f the reference law of mono_tile in one of the five rcp modes, from
// pair_law.cuh (shared with the all-pairs kernels).
//
// What bounds it: at the galaxy's main-path shape (G=1024 groups, S=256
// targets, C=1280 columns) the sources are 15.7 MB, read once, and there
// are 335M pair evaluations (166M within the per-group bounds), each one
// MUFU reciprocal and 28 SASS instructions in the hot loop (rcp=approx,
// sm_90a build by nvcc 12.9). So instruction issue bounds it, not memory:
// chip_smoke.py computes the bound from the card's clock and the
// instruction count of the built code (PERF.md).
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

#include "pair_law.cuh"

namespace {

using namespace pair_law;

constexpr int kThreads = 256;  // targets per block
constexpr int kTile = 1024;    // source columns staged per pass
constexpr int kRun = 32;       // columns per inner sum (divides kTile)

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
          float cx, cy;
          mono_pair<MODE>(dx, dy, sh_m[j], soft2, cx, cy);
          rx = __fadd_rn(rx, cx);
          ry = __fadd_rn(ry, cy);
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
