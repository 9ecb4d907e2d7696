// Barnes-Hut grouped force sweep for Hopper (sm_90a).
//
// Replaces: nbody_simulation_tpu/ops/traversal.py:_sweep_kernel, as called
// by _grouped_force (the full sweep, pallas_call at :637) and
// _grouped_force_bucketed (the occupancy-bucketed sweep, :753), in both of
// its forms:
//   K3 (QUAD=false)  the monopole, mono_tile's law;
//   K4 (QUAD=true)   monopole plus quadrupole correction, _quad_tile's law
//                    (:149-207), with three more source columns: the
//                    accepted nodes' second moments (qxx, qxy, qyy).
// The per-group column bound `col_limit` takes the place of the bucketed
// variant's two static-width calls, its scalar-prefetch block permutation
// and its lax.cond budget guard, with the same result: trailing columns with
// zero mass (and, for K4, zero moments) add exactly +-0.
//
// Computes, for every group g and target s:
//   out[g,s] = sum_{c < col_limit[g] (or C)} f(src[g,c] - tgt[g,s], ...)
// with f mono_pair or quad_pair of pair_law.cuh (shared with the all-pairs
// kernels) in one of the five rcp modes.
//
// What bounds it: K3 at the galaxy's main-path shape (G=1024 groups, S=256
// targets, C=1280 columns) reads 15.7 MB of sources once and evaluates 335M
// pairs (166M within the per-group bounds), each one MUFU reciprocal and
// 16 FP32 operations of the law at rcp=approx. K4 on the 65,536-body Plummer
// cluster at θ=0.5 evaluates 1.14e9 pairs (G=1024, S=64, C=17,408 at one leaf
// per planning row, 8.4e8 within the bounds; G=256, S=256 at the CLI's four,
// 1.0e9), each two MUFU reciprocals and 98 FP32 operations at rcp=newton,
// from 428 MB or 107 MB of sources. Both are bound by FP32 issue, not memory:
// chip_smoke.py computes each bound from the card's clock and the law's
// operation count (PERF.md).
//
// What the design does about it: one thread per target and no reduction
// across threads. One block per (group, target chunk), the chunk S rounded
// up to a warp and capped at 256 (a 64-target group would leave 3/4 of a
// 256-thread block idle); sums in registers in column order (deterministic,
// no atomics). The group's source columns are staged through shared memory
// in tiles of 1024 (12 KB for K3, 24 KB for K4) and read as broadcasts.
//
// Summation: each run of 32 columns is summed in f32 on its own, and the run
// sums are added in f64 and rounded once, as the all-pairs kernels do: the
// error of a 32-term f32 sum at any C. A plain running f32 sum loses every
// term below half an ulp of the partial sum, and on the galaxy a heavy
// node's COM often comes first (5.4e-5 of sum|c| against the pairwise torch
// sum on an H100); adding the run sums in f32 bounds the error by about
// (32 + C/32) ulps of sum|c|, ~3.4e-5 at K4's C of 17-18k, above the 1e-5
// gate. One f64 add per 32 pairs costs K3 nothing measurable (PERF.md).

#include <cuda_runtime.h>

#include "pair_law.cuh"

namespace {

using namespace pair_law;

constexpr int kMaxThreads = 256;  // targets per block, at most
constexpr int kTile = 1024;       // source columns staged per pass
constexpr int kRun = 32;          // columns per inner sum (divides kTile)

template <int MODE, bool QUAD>
__global__ void __launch_bounds__(kMaxThreads)
grouped_sweep_kernel(const float2* __restrict__ tgt,
                     const float* __restrict__ src_x,
                     const float* __restrict__ src_y,
                     const float* __restrict__ src_m,
                     const float* __restrict__ src_qxx,
                     const float* __restrict__ src_qxy,
                     const float* __restrict__ src_qyy,
                     const int* __restrict__ col_limit,
                     float2* __restrict__ out, int S, int C, float soft2) {
  constexpr int kCols = QUAD ? 6 : 3;
  __shared__ float sh[kCols][kTile];

  const int g = blockIdx.x;
  const int s = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = s < S;
  const size_t trow = static_cast<size_t>(g) * S;
  const float2 t = live ? tgt[trow + s] : make_float2(0.0f, 0.0f);

  int limit = C;
  if (col_limit != nullptr) limit = min(max(col_limit[g], 0), C);
  const size_t srow = static_cast<size_t>(g) * C;
  const float* cols[6] = {src_x + srow, src_y + srow, src_m + srow,
                          nullptr, nullptr, nullptr};
  if (QUAD) {
    cols[3] = src_qxx + srow;
    cols[4] = src_qxy + srow;
    cols[5] = src_qyy + srow;
  }

  double ax = 0.0, ay = 0.0;
  for (int base = 0; base < limit; base += kTile) {
    const int n = min(kTile, limit - base);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) sh[k][i] = cols[k][base + i];
    }
    __syncthreads();
    if (live) {
      for (int j0 = 0; j0 < n; j0 += kRun) {
        const int j1 = min(j0 + kRun, n);
        float rx = 0.0f, ry = 0.0f;
#pragma unroll 4
        for (int j = j0; j < j1; ++j) {
          const float dx = __fsub_rn(sh[0][j], t.x);
          const float dy = __fsub_rn(sh[1][j], t.y);
          float cx, cy;
          if constexpr (QUAD)
            quad_pair<MODE>(dx, dy, sh[2][j], sh[3][j], sh[4][j], sh[5][j],
                            soft2, cx, cy);
          else
            mono_pair<MODE>(dx, dy, sh[2][j], soft2, cx, cy);
          rx = __fadd_rn(rx, cx);
          ry = __fadd_rn(ry, cy);
        }
        ax = __dadd_rn(ax, static_cast<double>(rx));
        ay = __dadd_rn(ay, static_cast<double>(ry));
      }
    }
  }
  if (live)
    out[trow + s] = make_float2(static_cast<float>(ax), static_cast<float>(ay));
}

struct Args {
  const void *tgt, *sx, *sy, *sm, *qxx, *qxy, *qyy, *col_limit;
  void* out;
  int S, C;
  float soft2;
};

template <int MODE, bool QUAD>
void launch_form(dim3 grid, int threads, cudaStream_t stream, const Args& a) {
  grouped_sweep_kernel<MODE, QUAD><<<grid, threads, 0, stream>>>(
      static_cast<const float2*>(a.tgt), static_cast<const float*>(a.sx),
      static_cast<const float*>(a.sy), static_cast<const float*>(a.sm),
      static_cast<const float*>(a.qxx), static_cast<const float*>(a.qxy),
      static_cast<const float*>(a.qyy), static_cast<const int*>(a.col_limit),
      static_cast<float2*>(a.out), a.S, a.C, a.soft2);
}

template <int MODE>
void launch(dim3 grid, int threads, cudaStream_t stream, const Args& a) {
  if (a.qxx != nullptr)
    launch_form<MODE, true>(grid, threads, stream, a);
  else
    launch_form<MODE, false>(grid, threads, stream, a);
}

}  // namespace

extern "C" {

// tgt f32[G,S,2], src_{x,y,m} f32[G,C], src_{qxx,qxy,qyy} f32[G,C] (all
// three, for K4) or null (K3), col_limit i32[G] or null, out f32[G,S,2]; all
// contiguous on `device`. Launches on `stream` and returns
// cudaGetLastError() (0 on success) without synchronising.
int grouped_sweep_launch(const void* tgt, const void* src_x,
                         const void* src_y, const void* src_m,
                         const void* src_qxx, const void* src_qxy,
                         const void* src_qyy, const void* col_limit,
                         void* out, int G, int S, int C, float softening2,
                         int mode, int device, void* stream) {
  if (G <= 0 || S <= 0) return 0;
  if ((src_qxx == nullptr) != (src_qxy == nullptr) ||
      (src_qxx == nullptr) != (src_qyy == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = min(kMaxThreads, (S + 31) / 32 * 32);
  const dim3 grid(G, (S + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{tgt,     src_x,   src_y,     src_m, src_qxx, src_qxy,
               src_qyy, col_limit, out,     S,     C,       softening2};
  switch (mode) {
    case kExact:
      launch<kExact>(grid, threads, st, a);
      break;
    case kNewton:
      launch<kNewton>(grid, threads, st, a);
      break;
    case kApprox:
      launch<kApprox>(grid, threads, st, a);
      break;
    case kNewtonClamp:
      launch<kNewtonClamp>(grid, threads, st, a);
      break;
    case kApproxClamp:
      launch<kApproxClamp>(grid, threads, st, a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
