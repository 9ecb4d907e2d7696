// Barnes-Hut grouped force sweeps for Hopper (sm_90a).
//
// Replaces: nbody_simulation_tpu/ops/traversal.py:_sweep_kernel, as called
// by _grouped_force (the full sweep, pallas_call at :637) and
// _grouped_force_bucketed (the occupancy-bucketed sweep, :753), in both of
// its forms:
//   K3 (grouped_sweep_kernel)  the monopole, mono_tile's law;
//   K4 (quad_sweep_kernel)     monopole plus quadrupole correction,
//                              _quad_tile's law (:149-207), with three more
//                              source columns: the accepted nodes' second
//                              moments (qxx, qxy, qyy).
// The per-group column bound `col_limit` takes the place of the bucketed
// variant's two static-width calls, its scalar-prefetch block permutation
// and its lax.cond budget guard, with the same result: trailing columns with
// zero mass (and, for K4, zero moments) add exactly +-0.
//
// Computes, for every group g and target s:
//   out[g,s] = sum_{c < col_limit[g] (or C)} f(src[g,c] - tgt[g,s], ...)
// with f mono_pair or K4's quad law of pair_law.cuh (shared with the
// all-pairs kernels) in one of the five rcp modes.
//
// What bounds them: K3 at the galaxy's main-path shape (G=1024 groups,
// S=256 targets, C=1280 columns) reads 15.7 MB of sources once and
// evaluates 335M pairs (166M within the per-group bounds), each one MUFU
// reciprocal and 16 FP32 operations of the law at rcp=approx (14 where a
// tile's bound drops a compare and the mask's select, below). K4 on the
// 65,536-body Plummer cluster at θ=0.5 evaluates 1.14e9 pairs (G=1024, S=64,
// C=17,408 at one leaf per planning row, 8.4e8 within the bounds; G=256,
// S=256 at the CLI's four, 1.0e9), each two MUFU reciprocals and 98 FP32
// operations at rcp=newton (97 where a tile's coordinate bound drops a
// compare, below), from 428 MB or 107 MB of sources. Both are bound
// by FP32 issue, not memory: chip_smoke.py computes each bound from the
// card's clock and the law's operation count (PERF.md).
//
// K3's design. One block per group left K3 to its longest groups: on the
// galaxy 1024 blocks of 256 threads, one wave, whose ~590 groups of real
// bodies hold 24 to 40 runs of columns and the rest one, so each SM waited
// on its heaviest few groups with few warps left. Now each thread holds
// kMonoTargets targets of its group, which share every staged column (one
// float4 (x, y, m) and one shared load per column for all of them), and a
// block of kMonoThreads threads is `lanes` target lanes times `slices`
// column slices: block (g, b) takes targets [b * lanes * kMonoTargets, ...)
// of group g, lane l targets l + t * lanes, and slice w the runs of 32
// columns whose index is w modulo `slices`. The host picks `lanes` from S
// alone (ops/traversal.py:mono_sweep_plan), so a group's bounded work is
// spread over `slices` warps and over S / (lanes * kMonoTargets) blocks,
// and the grid has several short blocks per group. Each slice adds its
// runs' f32 sums in f64 in run order; the block then adds the slices'
// partials for each target in slice order in shared memory (no global
// slots, no second launch, no atomics). The split depends on S alone, not
// on G, C or col_limit: two calls are bitwise equal, a group's sums do not
// depend on how many groups a call holds (a P-way sharded call sums as
// the single-device one), and the bounded sweep is bitwise the full one (a
// run past the bound adds +0). Each staged tile checks a bound on its
// coordinates and masses once (__syncthreads_and); a tile within it takes
// mono_pair_bounded (rcp.approx.ftz.f32, the one-compare mask, a
// predicated sum), bitwise mono_pair there, and any other tile (a NaN, inf,
// huge or tiny coordinate, an inf mass, a tiny eps) takes mono_pair.
//
// K4's design. One block per group left K4 to the longest group: at the
// CLI's Plummer shape 256 blocks on 132 SMs, one partial wave, and on the
// θ=0.5 galaxy groups whose bounds differ several-fold. So the columns of
// every group are cut into chunks of `chunk` columns (whole runs of 32,
// fixed by the host from the grid's shape alone, ops/split.py:
// chunk_plan), and the grid is every (group, target block, chunk): a
// block whose chunk starts at or past col_limit[g] returns at once, the
// others are of one size, so the card runs many even waves. Each block
// writes its f64 sums to its own slot (chunk, group, target); quad_fold
// adds a target's written slots in chunk order and rounds to f32 once. No
// atomics: two calls are bitwise equal, and as the chunk boundaries do not
// depend on col_limit, the bounded sweep is bitwise the full one (the
// chunks past the bound sum to +0). Inside a block each thread holds
// kQuadTargets targets, which share every staged column: a column is
// staged as one float4 (x, y, m, qxx) and one float2 (qxy, qyy) in tiles of
// kQuadStage, so a step costs two shared loads for kQuadTargets pairs. The
// reciprocals take rcp.approx.ftz.f32 (MUFU.RCP alone) and the mask one
// compare where a bound on the block's coordinates, checked once per
// stage, makes that bitwise the general form (quad_run, pair_law.cuh:
// quad_rcp), and the non-.ftz form with its range fix-up otherwise.
//
// Summation: each run of 32 columns is summed in f32 on its own, and the run
// sums are added in f64 and rounded once, as the all-pairs kernels do: the
// error of a 32-term f32 sum at any C. A plain running f32 sum loses every
// term below half an ulp of the partial sum, and on the galaxy a heavy
// node's COM often comes first (5.4e-5 of sum|c| against the pairwise torch
// sum on an H100); adding the run sums in f32 bounds the error by about
// (32 + C/32) ulps of sum|c|, ~3.4e-5 at K4's C of 17-18k, above the 1e-5
// gate. One f64 add per 32 pairs costs K3 nothing measurable (PERF.md). K4's
// runs are K3's; its chunks add the f64 run sums of a chunk, then the fold
// the chunks, so a chunked K4 differs from one unchunked block per group
// only in the association of the f64 sum (tools/sweep_kernel_ab.py).

#include <cuda_runtime.h>

#include "pair_law.cuh"

namespace {

using namespace pair_law;

constexpr int kRun = 32;  // columns per inner sum

constexpr int kMonoThreads = 256;  // K3: threads per block
constexpr int kMonoTargets = 4;    // K3: targets per thread
constexpr int kMonoStage = 1024;   // K3: columns staged per pass
// K3: resident blocks per SM that ptxas must allow: 4 caps it at 64
// registers; left free it takes 90 and 2 blocks per SM, as fast on the
// galaxy and 17% slower at bh_accel_diff's S=64 (tools/sweep_kernel_ab.py).
constexpr int kMonoMinBlocks = 4;
static_assert(kMonoStage % kRun == 0, "a stage holds whole runs");

constexpr int kQuadThreads = 128;  // K4: threads per block, at most
constexpr int kQuadTargets = 2;    // K4: targets per thread
constexpr int kQuadStage = 256;    // K4: columns staged per pass
static_assert(kQuadStage % kRun == 0, "a stage holds whole runs");

// K3's tile bound: a tile takes mono_pair_bounded when every target of the
// block and every staged column has each coordinate 0 or of magnitude in
// [2^-64, 2^40] and a finite mass, and eps lies in [2^-39, 2^83]. Every
// coordinate is then a multiple of 2^-87 (the ulp at 2^-64), so |d|_1 is 0
// or at least 2^-87, and at most 2^42; |d|_2^2 <= 2^83; so a pair with s !=
// 0 has s * max(d2, eps) in [2^-87 * 2^-39, 2^42 * 2^83] = [2^-126, 2^125]
// (and max(s, L1_CLAMP) * max(d2, eps) too), which is what
// mono_pair_bounded needs. The upper bound is 2^40, not K4's 2^61, because
// K3 takes one reciprocal of the product.
constexpr float kMonoCoordLo = 0x1p-64f;
constexpr float kMonoCoordHi = 0x1p40f;
constexpr float kMonoSoftLo = 0x1p-39f;
constexpr float kMonoSoftHi = 0x1p83f;

__device__ __forceinline__ bool mono_coord_bounded(float c) {
  const float a = fabsf(c);
  return c == 0.0f || (a >= kMonoCoordLo && a <= kMonoCoordHi);
}

// One run of K3: staged columns [j0, j1) against the thread's kMonoTargets
// targets, summed in column order into rx, ry.
template <int MODE, bool FAST>
__device__ __forceinline__ void mono_run(const float4* __restrict__ sh,
                                         int j0, int j1,
                                         const float (&tx)[kMonoTargets],
                                         const float (&ty)[kMonoTargets],
                                         float soft2,
                                         float (&rx)[kMonoTargets],
                                         float (&ry)[kMonoTargets]) {
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const float4 p = sh[j];  // x, y, m
#pragma unroll
    for (int t = 0; t < kMonoTargets; ++t) {
      const float dx = __fsub_rn(p.x, tx[t]);
      const float dy = __fsub_rn(p.y, ty[t]);
      float cx, cy;
      if (FAST) {
        if (mono_pair_bounded<MODE>(dx, dy, p.z, soft2, cx, cy)) {
          rx[t] = __fadd_rn(rx[t], cx);
          ry[t] = __fadd_rn(ry[t], cy);
        }
      } else {
        mono_pair<MODE>(dx, dy, p.z, soft2, cx, cy);
        rx[t] = __fadd_rn(rx[t], cx);
        ry[t] = __fadd_rn(ry[t], cy);
      }
    }
  }
}

// Block g * tpg + b, thread w * lanes + l: targets s0 + l + t * lanes (t <
// kMonoTargets, s0 = b * lanes * kMonoTargets) of group g against the runs
// w, w + slices, ... of its columns below the bound, then the slices'
// partials added in slice order. A thread past S computes on target S - 1
// and writes nothing. allow_fast = false keeps every tile on mono_pair.
template <int MODE>
__global__ void __launch_bounds__(kMonoThreads, kMonoMinBlocks)
grouped_sweep_kernel(const float2* __restrict__ tgt,
                     const float* __restrict__ src_x,
                     const float* __restrict__ src_y,
                     const float* __restrict__ src_m,
                     const int* __restrict__ col_limit,
                     float2* __restrict__ out, int S, int C, int lanes,
                     int tpg, bool allow_fast, float soft2) {
  constexpr int kT = kMonoTargets;
  __shared__ union {
    float4 cols[kMonoStage];         // the staged tile: x, y, m
    double2 part[kMonoThreads * kT];  // then the slices' partials
  } sh;

  const int g = blockIdx.x / tpg;
  const int per_block = lanes * kT;
  const int slices = blockDim.x / lanes;
  const int w = threadIdx.x / lanes;
  const int l = threadIdx.x - w * lanes;
  const int s0 = (blockIdx.x - g * tpg) * per_block;
  const size_t trow = static_cast<size_t>(g) * S;

  float tx[kT], ty[kT];
  double ax[kT], ay[kT];
  bool tgt_bounded =
      allow_fast && soft2 >= kMonoSoftLo && soft2 <= kMonoSoftHi;
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const float2 p = tgt[trow + min(s0 + l + t * lanes, S - 1)];
    tx[t] = p.x;
    ty[t] = p.y;
    tgt_bounded &= mono_coord_bounded(p.x) && mono_coord_bounded(p.y);
    ax[t] = ay[t] = 0.0;
  }

  int limit = C;
  if (col_limit != nullptr) limit = min(max(col_limit[g], 0), C);
  const size_t srow = static_cast<size_t>(g) * C;
  for (int base = 0; base < limit; base += kMonoStage) {
    const int n = min(kMonoStage, limit - base);
    __syncthreads();  // the previous tile is fully consumed
    bool bounded = tgt_bounded;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const size_t at = srow + base + i;
      const float x = src_x[at], y = src_y[at], m = src_m[at];
      sh.cols[i] = make_float4(x, y, m, 0.0f);
      bounded &= mono_coord_bounded(x) && mono_coord_bounded(y) &&
                 fabsf(m) <= kFltMax;
    }
    const bool fast = __syncthreads_and(bounded);
    // This slice's runs of the tile: global run index = w modulo slices.
    const int first = (w - (base / kRun) % slices + slices) % slices;
    for (int j0 = first * kRun; j0 < n; j0 += slices * kRun) {
      const int j1 = min(j0 + kRun, n);
      float rx[kT] = {}, ry[kT] = {};
      if (fast)
        mono_run<MODE, true>(sh.cols, j0, j1, tx, ty, soft2, rx, ry);
      else
        mono_run<MODE, false>(sh.cols, j0, j1, tx, ty, soft2, rx, ry);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        ax[t] = __dadd_rn(ax[t], static_cast<double>(rx[t]));
        ay[t] = __dadd_rn(ay[t], static_cast<double>(ry[t]));
      }
    }
  }

  __syncthreads();  // the last tile is consumed: its memory takes partials
#pragma unroll
  for (int t = 0; t < kT; ++t)
    sh.part[w * per_block + l + t * lanes] = make_double2(ax[t], ay[t]);
  __syncthreads();
  for (int i = threadIdx.x; i < per_block; i += blockDim.x) {
    double sx = 0.0, sy = 0.0;
    for (int k = 0; k < slices; ++k) {
      const double2 p = sh.part[k * per_block + i];
      sx = __dadd_rn(sx, p.x);
      sy = __dadd_rn(sy, p.y);
    }
    if (s0 + i < S)
      out[trow + s0 + i] =
          make_float2(static_cast<float>(sx), static_cast<float>(sy));
  }
}

struct MonoArgs {
  const float2* tgt;
  const float *sx, *sy, *sm;
  const int* col_limit;
  float2* out;
  int G, S, C, lanes;
  bool allow_fast;
  float soft2;
};

template <int MODE>
int mono_launch(cudaStream_t st, const MonoArgs& a) {
  const int tpg = (a.S + a.lanes * kMonoTargets - 1) / (a.lanes * kMonoTargets);
  grouped_sweep_kernel<MODE><<<a.G * tpg, kMonoThreads, 0, st>>>(
      a.tgt, a.sx, a.sy, a.sm, a.col_limit, a.out, a.S, a.C, a.lanes, tpg,
      a.allow_fast, a.soft2);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int mono_occupancy(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, grouped_sweep_kernel<MODE>, kMonoThreads, 0));
}

template <int MODE>
int mono_regs(int* regs) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, grouped_sweep_kernel<MODE>);
  *regs = attr.numRegs;
  return static_cast<int>(err);
}

// K4's stage bound: a stage takes the fast form of the law (FAST in
// pair_law.cuh: rcp.approx.ftz.f32, and the mask as s >= FLT_MIN_NORMAL)
// when every target of the block and every staged column has |x|, |y| <=
// 2^61 and FLT_MIN_NORMAL <= eps <= 2^126. Then every |d| <= 2^62 per
// axis, so d2 lies in [2^-126, 2^125] and s <= 2^63, where the fast form is
// bitwise the general one. Otherwise (a NaN, inf or huge coordinate, a
// tiny eps) the stage takes the general form, rcp.approx.f32 with its range
// fix-up and the full mask.
constexpr float kQuadCoordBound = 0x1p61f;

__device__ __forceinline__ bool quad_bounded(float x, float y) {
  return fabsf(x) <= kQuadCoordBound && fabsf(y) <= kQuadCoordBound;
}

// One run of K4's stage: staged columns [j0, j1) against the thread's
// kQuadTargets targets, summed in column order into rx, ry.
template <int MODE, bool FAST>
__device__ __forceinline__ void quad_run(const float4* __restrict__ sh_a,
                                         const float2* __restrict__ sh_b,
                                         int j0, int j1,
                                         const float (&tx)[kQuadTargets],
                                         const float (&ty)[kQuadTargets],
                                         float soft2,
                                         float (&rx)[kQuadTargets],
                                         float (&ry)[kQuadTargets]) {
#pragma unroll 2
  for (int j = j0; j < j1; ++j) {
    const float4 p = sh_a[j];  // x, y, m, qxx
    const float2 q = sh_b[j];  // qxy, qyy
#pragma unroll
    for (int t = 0; t < kQuadTargets; ++t) {
      const float dx = __fsub_rn(p.x, tx[t]);
      const float dy = __fsub_rn(p.y, ty[t]);
      float s, d2, a, b, cx, cy;
      quad_den(dx, dy, soft2, s, d2);
      quad_rcp<MODE, FAST>(s, d2, a, b);
      quad_terms<FAST>(dx, dy, s, a, b, p.z, p.w, q.x, q.y, cx, cy);
      rx[t] = __fadd_rn(rx[t], cx);
      ry[t] = __fadd_rn(ry[t], cy);
    }
  }
}

// Block (g * tpg + target block, chunk k): targets s0 + t * blockDim.x of
// group g against its columns [k * chunk, min((k + 1) * chunk, limit)),
// f64 sums into slots[k, g, s]. A thread past S computes on target S - 1
// and writes nothing.
template <int MODE>
__global__ void __launch_bounds__(kQuadThreads)
quad_sweep_kernel(const float2* __restrict__ tgt,
                  const float* __restrict__ src_x,
                  const float* __restrict__ src_y,
                  const float* __restrict__ src_m,
                  const float* __restrict__ src_qxx,
                  const float* __restrict__ src_qxy,
                  const float* __restrict__ src_qyy,
                  const int* __restrict__ col_limit,
                  double2* __restrict__ slots, int G, int S, int C, int chunk,
                  int tpg, float soft2) {
  __shared__ float4 sh_a[kQuadStage];  // x, y, m, qxx
  __shared__ float2 sh_b[kQuadStage];  // qxy, qyy

  const int g = blockIdx.x / tpg;
  int limit = C;
  if (col_limit != nullptr) limit = min(max(col_limit[g], 0), C);
  const int c0 = blockIdx.y * chunk;
  if (c0 >= limit) return;  // the whole block: a chunk past the bound
  const int c1 = min(c0 + chunk, limit);

  const int s0 = (blockIdx.x % tpg) * (blockDim.x * kQuadTargets) +
                 static_cast<int>(threadIdx.x);
  const size_t trow = static_cast<size_t>(g) * S;
  float tx[kQuadTargets], ty[kQuadTargets];
  double ax[kQuadTargets], ay[kQuadTargets];
  bool tgt_bounded = soft2 >= kFltMinNormal && soft2 <= 0x1p126f;
#pragma unroll
  for (int t = 0; t < kQuadTargets; ++t) {
    const float2 p = tgt[trow + min(s0 + t * static_cast<int>(blockDim.x),
                                    S - 1)];
    tx[t] = p.x;
    ty[t] = p.y;
    tgt_bounded &= quad_bounded(p.x, p.y);
    ax[t] = ay[t] = 0.0;
  }

  const size_t srow = static_cast<size_t>(g) * C;
  for (int base = c0; base < c1; base += kQuadStage) {
    const int n = min(kQuadStage, c1 - base);
    __syncthreads();  // the previous stage is fully consumed
    bool bounded = tgt_bounded;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const size_t at = srow + base + i;
      const float x = src_x[at], y = src_y[at];
      sh_a[i] = make_float4(x, y, src_m[at], src_qxx[at]);
      sh_b[i] = make_float2(src_qxy[at], src_qyy[at]);
      bounded &= quad_bounded(x, y);
    }
    const bool fast = __syncthreads_and(bounded);
    for (int j0 = 0; j0 < n; j0 += kRun) {
      const int j1 = min(j0 + kRun, n);
      float rx[kQuadTargets] = {}, ry[kQuadTargets] = {};
      if (fast)
        quad_run<MODE, true>(sh_a, sh_b, j0, j1, tx, ty, soft2, rx, ry);
      else
        quad_run<MODE, false>(sh_a, sh_b, j0, j1, tx, ty, soft2, rx, ry);
#pragma unroll
      for (int t = 0; t < kQuadTargets; ++t) {
        ax[t] = __dadd_rn(ax[t], static_cast<double>(rx[t]));
        ay[t] = __dadd_rn(ay[t], static_cast<double>(ry[t]));
      }
    }
  }
  double2* slot = slots + static_cast<size_t>(blockIdx.y) * G * S + trow;
#pragma unroll
  for (int t = 0; t < kQuadTargets; ++t) {
    const int s = s0 + t * static_cast<int>(blockDim.x);
    if (s < S) slot[s] = make_double2(ax[t], ay[t]);
  }
}

// K4's fold: target i = g * S + s adds the slots its chunks wrote, those
// that start before col_limit[g], in chunk order, and rounds once.
__global__ void quad_fold(const double2* __restrict__ slots,
                          const int* __restrict__ col_limit,
                          float2* __restrict__ out, int G, int S, int C,
                          int chunk) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t gs = static_cast<size_t>(G) * S;
  if (i >= gs) return;
  int limit = C;
  if (col_limit != nullptr)
    limit = min(max(col_limit[i / static_cast<size_t>(S)], 0), C);
  const int chunks = (limit + chunk - 1) / chunk;
  double ax = 0.0, ay = 0.0;
  for (int k = 0; k < chunks; ++k) {
    const double2 p = slots[static_cast<size_t>(k) * gs + i];
    ax = __dadd_rn(ax, p.x);
    ay = __dadd_rn(ay, p.y);
  }
  out[i] = make_float2(static_cast<float>(ax), static_cast<float>(ay));
}

// K4's threads per block for S targets per group: S / kQuadTargets rounded
// up to a warp, at most kQuadThreads.
int quad_threads(int S) {
  const int per_thread = (S + kQuadTargets - 1) / kQuadTargets;
  return min(kQuadThreads, (per_thread + 31) / 32 * 32);
}

struct QuadArgs {
  const float2* tgt;
  const float *sx, *sy, *sm, *qxx, *qxy, *qyy;
  const int* col_limit;
  double2* slots;
  float2* out;
  int G, S, C, chunk;
  float soft2;
};

template <int MODE>
int quad_launch(cudaStream_t st, const QuadArgs& a) {
  const int threads = quad_threads(a.S);
  const int tpg = (a.S + threads * kQuadTargets - 1) / (threads * kQuadTargets);
  const int chunks = (a.C + a.chunk - 1) / a.chunk;
  if (chunks > 0) {
    quad_sweep_kernel<MODE><<<dim3(a.G * tpg, chunks), threads, 0, st>>>(
        a.tgt, a.sx, a.sy, a.sm, a.qxx, a.qxy, a.qyy, a.col_limit, a.slots,
        a.G, a.S, a.C, a.chunk, tpg, a.soft2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t gs = static_cast<size_t>(a.G) * a.S;
  quad_fold<<<static_cast<unsigned>((gs + 255) / 256), 256, 0, st>>>(
      a.slots, a.col_limit, a.out, a.G, a.S, a.C, a.chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int quad_occupancy(int threads, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, quad_sweep_kernel<MODE>, threads, 0));
}

}  // namespace

extern "C" {

// K3. tgt f32[G,S,2], src_{x,y,m} f32[G,C], col_limit i32[G] or null, out
// f32[G,S,2]; all contiguous on `device`. `lanes` (a divisor of the block's
// threads, grouped_sweep_shape) target lanes per block, the rest of the
// block's threads column slices; allow_fast 0 keeps every tile on the
// general law. Launches on `stream` and returns cudaGetLastError() (0 on
// success) without synchronising.
int grouped_sweep_launch(const void* tgt, const void* src_x,
                         const void* src_y, const void* src_m,
                         const void* col_limit, void* out, int G, int S,
                         int C, int lanes, int allow_fast, float softening2,
                         int mode, int device, void* stream) {
  if (G <= 0 || S <= 0) return 0;
  if (C < 0 || lanes <= 0 || lanes > kMonoThreads ||
      kMonoThreads % lanes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const MonoArgs a{static_cast<const float2*>(tgt),
                   static_cast<const float*>(src_x),
                   static_cast<const float*>(src_y),
                   static_cast<const float*>(src_m),
                   static_cast<const int*>(col_limit),
                   static_cast<float2*>(out),
                   G, S, C, lanes, allow_fast != 0, softening2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kExact:
      return mono_launch<kExact>(st, a);
    case kNewton:
      return mono_launch<kNewton>(st, a);
    case kApprox:
      return mono_launch<kApprox>(st, a);
    case kNewtonClamp:
      return mono_launch<kNewtonClamp>(st, a);
    case kApproxClamp:
      return mono_launch<kApproxClamp>(st, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3's launch shape in rcp mode `mode` (S is not used: the block is
// always kMonoThreads threads): threads per block, targets per thread and
// resident blocks per SM, into the three pointers; returns the CUDA error
// (0 on success).
int grouped_sweep_shape(int S, int mode, int device, int* threads,
                        int* targets, int* blocks) {
  (void)S;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = kMonoThreads;
  *targets = kMonoTargets;
  switch (mode) {
    case kExact:
      return mono_occupancy<kExact>(blocks);
    case kNewton:
      return mono_occupancy<kNewton>(blocks);
    case kApprox:
      return mono_occupancy<kApprox>(blocks);
    case kNewtonClamp:
      return mono_occupancy<kNewtonClamp>(blocks);
    case kApproxClamp:
      return mono_occupancy<kApproxClamp>(blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3's registers per thread in rcp mode `mode`, into `regs`; returns the
// CUDA error (0 on success).
int grouped_sweep_regs(int mode, int device, int* regs) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (mode) {
    case kExact:
      return mono_regs<kExact>(regs);
    case kNewton:
      return mono_regs<kNewton>(regs);
    case kApprox:
      return mono_regs<kApprox>(regs);
    case kNewtonClamp:
      return mono_regs<kNewtonClamp>(regs);
    case kApproxClamp:
      return mono_regs<kApproxClamp>(regs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4. tgt f32[G,S,2], src_{x,y,m,qxx,qxy,qyy} f32[G,C], col_limit i32[G] or
// null, out f32[G,S,2]; slots f64[ceil(C/chunk),G,S,2] scratch, written
// where a chunk starts before the group's bound and read by the fold; chunk
// a positive multiple of 32. All contiguous on `device`. Launches the sweep
// and its fold on `stream` and returns the first CUDA error (0 on success)
// without synchronising.
int quad_sweep_launch(const void* tgt, const void* src_x, const void* src_y,
                      const void* src_m, const void* src_qxx,
                      const void* src_qxy, const void* src_qyy,
                      const void* col_limit, void* slots, void* out, int G,
                      int S, int C, int chunk, float softening2, int mode,
                      int device, void* stream) {
  if (G <= 0 || S <= 0) return 0;
  if (chunk <= 0 || chunk % kRun != 0 || C < 0 ||
      (C + chunk - 1) / chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const QuadArgs a{static_cast<const float2*>(tgt),
                   static_cast<const float*>(src_x),
                   static_cast<const float*>(src_y),
                   static_cast<const float*>(src_m),
                   static_cast<const float*>(src_qxx),
                   static_cast<const float*>(src_qxy),
                   static_cast<const float*>(src_qyy),
                   static_cast<const int*>(col_limit),
                   static_cast<double2*>(slots),
                   static_cast<float2*>(out),
                   G, S, C, chunk, softening2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kExact:
      return quad_launch<kExact>(st, a);
    case kNewton:
      return quad_launch<kNewton>(st, a);
    case kApprox:
      return quad_launch<kApprox>(st, a);
    case kNewtonClamp:
      return quad_launch<kNewtonClamp>(st, a);
    case kApproxClamp:
      return quad_launch<kApproxClamp>(st, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4's launch shape for S targets per group in rcp mode `mode`: threads per
// block, targets per thread and resident blocks per SM, into the three
// pointers; returns the CUDA error (0 on success).
int quad_sweep_shape(int S, int mode, int device, int* threads, int* targets,
                     int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = quad_threads(S);
  *targets = kQuadTargets;
  switch (mode) {
    case kExact:
      return quad_occupancy<kExact>(*threads, blocks);
    case kNewton:
      return quad_occupancy<kNewton>(*threads, blocks);
    case kApprox:
      return quad_occupancy<kApprox>(*threads, blocks);
    case kNewtonClamp:
      return quad_occupancy<kNewtonClamp>(*threads, blocks);
    case kApproxClamp:
      return quad_occupancy<kApproxClamp>(*threads, blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
