// All-pairs kernels for Hopper (sm_90a): the ordered force sweep (K1), the
// symmetric third-law force sweep (K2) and its cross-shard form (K9), all in
// the five rcp modes of pair_law.cuh, and the ordered potential sweep (K6).
//
// K1 replaces nbody_simulation_tpu/ops/allpairs.py:_allpairs_kernel (called
// by allpairs_accel, pallas_call at :537):
//   out[i] = sum_j mono_pair(src_j - tgt_i, m_j)
// for targets f32[Ni,2] against sources f32[Nj,2] with masses f32[Nj].
// K6 replaces nbody_simulation_tpu/ops/energy.py:_potential_kernel (called
// by allpairs_potential, pallas_call at :118):
//   phi[i] = sum_j -m_j / sqrt(max(|p_j - p_i|^2, eps))
// over pairs whose |d|_1 is a normal float (pot_term in pair_law.cuh),
// giving f32[Ni]. Its reciprocal square root is __frsqrt_rn, correctly
// rounded, so each term is within 1 ulp of -m_j/sqrt(d2); the plain
// version's torch.rsqrt on the card is CUDA's rsqrtf (at most 2 ulp). Every
// term has the sign of -m_j, so sum|c| = |phi| and the bound is relative.
// Both are one kernel, ordered_kernel, templated on the pair term: one
// thread per target, 256 targets per block; the sources are staged through
// shared memory as (x, y, m) in tiles of 1024 and read as broadcasts. No
// reduction across threads, so no atomics, and the result does not depend
// on the schedule.
//
// K2 replaces _allpairs_sym_kernel (called by allpairs_accel_sym,
// pallas_call at :290; pair kernel _sym_r :103): each unordered pair's
// k(d) is evaluated once and applied to both particles,
//   a_i += m_j * d * k(d),  a_j -= m_i * d * k(d),  d = p_j - p_i.
// The TPU kernel read-modify-writes aliased accumulators over a sequential
// grid. On a GPU the blocks run at once, so the j side would race. The
// schedule here is the same tournament, one launch per round: the particles
// are cut into nt tiles of 256, and round k pairs tile b with tile
// (b + k) mod nt, one block each (round 0 is the diagonal, i side only;
// for even nt, round nt/2 runs only b < nt/2, since its other half repeats
// the first). Inside a round every tile is an i tile once and a j tile once,
// so no two blocks touch the same accumulator. Rounds follow one another
// on the stream. Inside a block, warp w owns 32 targets and takes the j
// tile in chunks of 32: lane l starts with source l of the chunk, and after
// each pair the sources rotate one lane down by shuffle, carrying their
// j-side sums with them. After 32 steps every lane has met every source and
// each source is home with its sum over the warp's 32 targets. The warps'
// sums are then added in warp order through shared memory. Every sum has a
// fixed order, so two calls on the same input are bitwise equal; there is
// no float atomic anywhere. This was chosen over per-tile partials (N^2/T
// floats of scratch: gigabytes at N=1M) and over float atomicAdd (order of
// arrival changes the bits from run to run).
//
// Summation (the sweep kernel's lesson: a plain running sum behind a heavy
// term lost 5.4e-5 of sum|c| on the galaxy, in the sweep kernel's first
// chip_smoke.py run on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md): every
// sum of pair terms runs over at most 32 terms in f32; those run sums are
// added in f64, in registers and in the f64 accumulators that carry K2's
// sums from round to round; the result is rounded to f32 once. So the
// error is that of a 32-term f32 sum and does not grow with N.
//
// K9 replaces _allpairs_sym_pair_kernel (called by allpairs_accel_sym_pair,
// pallas_call at :441), the compute side of the symmetric ring
// (parallel/ring.py): two different blocks of L particles, the local i side
// and the visiting j side, and every (i, j) pair once,
//   a_i += m_j * d * k(d),  a_j -= m_i * d * k(d),  d = p_j - p_i.
// It is K2's round kernel with separate i-side and j-side pointers, run on
// K2's schedule without its two special cases: the i x j rectangle has no
// diagonal and no pair twice, so all nt rounds k = 0..nt-1 are full, each
// with nt blocks, and in each round every i tile and every j tile is owned
// by one block. Its f64 accumulators and finish are K2's; it is bitwise
// deterministic too. The TPU kernel's flattened (nt, nt) grid and its
// per-round calls for small nt exist for the TPU's aliased accumulators and
// are not carried over. At the ring's shard size (L = 51,200 on the galaxy
// at P=3) a round is 200 blocks, 1.5 waves on 132 SMs: a smaller tile or a
// split round is the lever for a later change.
//
// What bounds them: at N=1M the inputs are 12 MB and the output 8 MB, while
// K1 evaluates N^2 = 1.1e12 pairs and K2 N^2/2 (K6, once per energy
// sample, N^2 like K1; K9 L^2 per call on 40 L bytes). Each pair is one MUFU
// reciprocal or rsqrt (an IEEE division in `exact`) and a dozen to two dozen
// FP32 operations of the law itself, so FP32 issue bounds them, not memory:
// chip_smoke.py computes each bound from the card's clock and the law's
// operation count per pair (PERF.md). The pair of K2 and K9 also rotates
// five registers by shuffle, which the law does not count.

#include <cuda_runtime.h>

#include "pair_law.cuh"

namespace {

using namespace pair_law;

constexpr int kThreads = 256;  // K1, K6: targets per block
constexpr int kTile = 1024;    // K1, K6: sources staged per pass
constexpr int kRun = 32;       // K1, K6: terms per f32 run sum (divides kTile)

constexpr int kWarps = 8;               // K2: warps per block
constexpr int kSymTile = 32 * kWarps;   // K2: particles per tile

// The ordered sweep. POT: K6, the potential into out f32[Ni]; else K1, the
// force in rcp mode MODE into out f32[Ni,2].
template <int MODE, bool POT>
__global__ void __launch_bounds__(kThreads)
ordered_kernel(const float2* __restrict__ tgt, const float2* __restrict__ src,
               const float* __restrict__ src_m, float* __restrict__ out,
               int ni, int nj, float soft2) {
  __shared__ float4 sh[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < ni;
  const float2 t = live ? tgt[i] : make_float2(0.0f, 0.0f);
  double ax = 0.0, ay = 0.0;
  for (int base = 0; base < nj; base += kTile) {
    const int n = min(kTile, nj - base);
    __syncthreads();  // the previous tile is fully consumed
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float2 p = src[base + j];
      sh[j] = make_float4(p.x, p.y, src_m[base + j], 0.0f);
    }
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += kRun) {
      const int j1 = min(j0 + kRun, n);
      float rx = 0.0f, ry = 0.0f;
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const float4 q = sh[j];
        const float dx = __fsub_rn(q.x, t.x);
        const float dy = __fsub_rn(q.y, t.y);
        if constexpr (POT) {
          rx = __fadd_rn(rx, pot_term(dx, dy, q.z, soft2));
        } else {
          float cx, cy;
          mono_pair<MODE>(dx, dy, q.z, soft2, cx, cy);
          rx = __fadd_rn(rx, cx);
          ry = __fadd_rn(ry, cy);
        }
      }
      ax = __dadd_rn(ax, static_cast<double>(rx));
      if constexpr (!POT) ay = __dadd_rn(ay, static_cast<double>(ry));
    }
  }
  if (!live) return;
  if constexpr (POT)
    out[i] = static_cast<float>(ax);
  else
    reinterpret_cast<float2*>(out)[i] =
        make_float2(static_cast<float>(ax), static_cast<float>(ay));
}

// One tournament round k: block b pairs i tile b (targets) with j tile
// (b + k) mod nt (sources). K2 passes one particle block as both sides, K9
// two blocks of the same length n. DIAG is K2's round 0: the i side over the
// block's own tile, every ordered pair, and no j side (it would count each
// pair twice), as the JAX kernel does with its k != 0 mass factor.
template <int MODE, bool DIAG>
__global__ void __launch_bounds__(kSymTile)
allpairs_sym_round(const float2* __restrict__ pos_i,
                   const float* __restrict__ mass_i,
                   const float2* __restrict__ pos_j,
                   const float* __restrict__ mass_j,
                   double2* __restrict__ acc_i, double2* __restrict__ acc_j,
                   int n, int nt, int k, float soft2) {
  __shared__ float sh_x[kWarps][kSymTile];
  __shared__ float sh_y[kWarps][kSymTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int next = (lane + 1) & 31;
  int tj = blockIdx.x + k;
  if (tj >= nt) tj -= nt;

  // A slot past n is an inert particle: mass 0 at the origin.
  const int i = blockIdx.x * kSymTile + threadIdx.x;
  const bool ilive = i < n;
  const float2 pi = ilive ? pos_i[i] : make_float2(0.0f, 0.0f);
  const float mi = ilive ? mass_i[i] : 0.0f;

  double ax = 0.0, ay = 0.0;
  for (int c = 0; c < kWarps; ++c) {
    const int j = tj * kSymTile + c * 32 + lane;
    const bool jlive = j < n;
    const float2 pj = jlive ? pos_j[j] : make_float2(0.0f, 0.0f);
    float xj = pj.x, yj = pj.y;
    float mj = jlive ? mass_j[j] : 0.0f;
    float bx = 0.0f, by = 0.0f;  // j side of the source this lane holds
    float rx = 0.0f, ry = 0.0f;  // i side over this chunk
#pragma unroll 4
    for (int r = 0; r < 32; ++r) {
      const float dx = __fsub_rn(xj, pi.x);
      const float dy = __fsub_rn(yj, pi.y);
      const float kr = sym_r<MODE>(dx, dy, soft2);
      const float wi = __fmul_rn(mj, kr);
      rx = __fadd_rn(rx, __fmul_rn(dx, wi));
      ry = __fadd_rn(ry, __fmul_rn(dy, wi));
      if (!DIAG) {
        const float wj = __fmul_rn(mi, kr);
        bx = __fadd_rn(bx, __fmul_rn(dx, wj));
        by = __fadd_rn(by, __fmul_rn(dy, wj));
        bx = __shfl_sync(0xffffffffu, bx, next);
        by = __shfl_sync(0xffffffffu, by, next);
      }
      xj = __shfl_sync(0xffffffffu, xj, next);
      yj = __shfl_sync(0xffffffffu, yj, next);
      mj = __shfl_sync(0xffffffffu, mj, next);
    }
    ax = __dadd_rn(ax, static_cast<double>(rx));
    ay = __dadd_rn(ay, static_cast<double>(ry));
    if (!DIAG) {  // 32 rotations: source c*32 + lane is back in this lane
      sh_x[warp][c * 32 + lane] = bx;
      sh_y[warp][c * 32 + lane] = by;
    }
  }
  if (ilive) {
    double2 a = acc_i[i];
    a.x = __dadd_rn(a.x, ax);
    a.y = __dadd_rn(a.y, ay);
    acc_i[i] = a;
  }
  if (!DIAG) {
    __syncthreads();
    const int jt = tj * kSymTile + threadIdx.x;
    if (jt < n) {
      double sx = 0.0, sy = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sx = __dadd_rn(sx, static_cast<double>(sh_x[w][threadIdx.x]));
        sy = __dadd_rn(sy, static_cast<double>(sh_y[w][threadIdx.x]));
      }
      double2 a = acc_j[jt];
      a.x = __dsub_rn(a.x, sx);
      a.y = __dsub_rn(a.y, sy);
      acc_j[jt] = a;
    }
  }
}

// K9's finish: the f64 accumulators (2n double2: i side, then j side)
// rounded once to f32.
__global__ void sym_pair_finish(const double2* __restrict__ acc,
                                float2* __restrict__ out, int n2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n2) {
    const double2 a = acc[i];
    out[i] = make_float2(static_cast<float>(a.x), static_cast<float>(a.y));
  }
}

__global__ void sym_finish(const double2* __restrict__ acc_i,
                           const double2* __restrict__ acc_j,
                           float2* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const double2 a = acc_i[i];
    const double2 b = acc_j[i];
    out[i] = make_float2(static_cast<float>(__dadd_rn(a.x, b.x)),
                         static_cast<float>(__dadd_rn(a.y, b.y)));
  }
}

template <int MODE, bool POT = false>
int launch_ordered(cudaStream_t st, const void* tgt, const void* src,
                   const void* src_m, void* out, int ni, int nj, float soft2) {
  const int blocks = (ni + kThreads - 1) / kThreads;
  ordered_kernel<MODE, POT><<<blocks, kThreads, 0, st>>>(
      static_cast<const float2*>(tgt), static_cast<const float2*>(src),
      static_cast<const float*>(src_m), static_cast<float*>(out), ni, nj,
      soft2);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_sym(cudaStream_t st, const void* pos, const void* mass, void* acc,
               void* out, int n, float soft2) {
  const float2* p = static_cast<const float2*>(pos);
  const float* m = static_cast<const float*>(mass);
  double2* acc_i = static_cast<double2*>(acc);
  double2* acc_j = acc_i + n;
  const int nt = (n + kSymTile - 1) / kSymTile;
  for (int k = 0; k <= nt / 2; ++k) {
    const int blocks = (nt % 2 == 0 && k == nt / 2) ? nt / 2 : nt;
    if (k == 0)
      allpairs_sym_round<MODE, true><<<blocks, kSymTile, 0, st>>>(
          p, m, p, m, acc_i, acc_j, n, nt, k, soft2);
    else
      allpairs_sym_round<MODE, false><<<blocks, kSymTile, 0, st>>>(
          p, m, p, m, acc_i, acc_j, n, nt, k, soft2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sym_finish<<<(n + 255) / 256, 256, 0, st>>>(acc_i, acc_j,
                                               static_cast<float2*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_sym_pair(cudaStream_t st, const void* pos_i, const void* mass_i,
                    const void* pos_j, const void* mass_j, void* acc,
                    void* out, int n, float soft2) {
  const float2* pi = static_cast<const float2*>(pos_i);
  const float* mi = static_cast<const float*>(mass_i);
  const float2* pj = static_cast<const float2*>(pos_j);
  const float* mj = static_cast<const float*>(mass_j);
  double2* acc_i = static_cast<double2*>(acc);
  double2* acc_j = acc_i + n;
  const int nt = (n + kSymTile - 1) / kSymTile;
  for (int k = 0; k < nt; ++k) {
    allpairs_sym_round<MODE, false><<<nt, kSymTile, 0, st>>>(
        pi, mi, pj, mj, acc_i, acc_j, n, nt, k, soft2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sym_pair_finish<<<(2 * n + 255) / 256, 256, 0, st>>>(
      acc_i, static_cast<float2*>(out), 2 * n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1. tgt f32[Ni,2], src f32[Nj,2], src_m f32[Nj], out f32[Ni,2]; all
// contiguous on `device`. Launches on `stream` and returns
// cudaGetLastError() (0 on success) without synchronising.
int allpairs_launch(const void* tgt, const void* src, const void* src_m,
                    void* out, int ni, int nj, float softening2, int mode,
                    int device, void* stream) {
  if (ni <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kExact:
      return launch_ordered<kExact>(st, tgt, src, src_m, out, ni, nj,
                                    softening2);
    case kNewton:
      return launch_ordered<kNewton>(st, tgt, src, src_m, out, ni, nj,
                                     softening2);
    case kApprox:
      return launch_ordered<kApprox>(st, tgt, src, src_m, out, ni, nj,
                                     softening2);
    case kNewtonClamp:
      return launch_ordered<kNewtonClamp>(st, tgt, src, src_m, out, ni, nj,
                                          softening2);
    case kApproxClamp:
      return launch_ordered<kApproxClamp>(st, tgt, src, src_m, out, ni, nj,
                                          softening2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2. pos f32[N,2], mass f32[N], acc f64[2,N,2] zeroed by the caller
// (scratch: the i-side and j-side accumulators), out f32[N,2]; all
// contiguous on `device`. Launches nt/2 + 2 kernels on `stream` (nt =
// ceil(N/256)) and returns the first CUDA error (0 on success) without
// synchronising.
int allpairs_sym_launch(const void* pos, const void* mass, void* acc,
                        void* out, int n, float softening2, int mode,
                        int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kExact:
      return launch_sym<kExact>(st, pos, mass, acc, out, n, softening2);
    case kNewton:
      return launch_sym<kNewton>(st, pos, mass, acc, out, n, softening2);
    case kApprox:
      return launch_sym<kApprox>(st, pos, mass, acc, out, n, softening2);
    case kNewtonClamp:
      return launch_sym<kNewtonClamp>(st, pos, mass, acc, out, n, softening2);
    case kApproxClamp:
      return launch_sym<kApproxClamp>(st, pos, mass, acc, out, n, softening2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9. pos_i, pos_j f32[N,2], mass_i, mass_j f32[N], acc f64[2,N,2] zeroed
// by the caller (scratch: the i-side and j-side accumulators), out
// f32[2,N,2] (acc_i, then acc_j); all contiguous on `device`. Launches nt + 1
// kernels on `stream` (nt = ceil(N/256)) and returns the first CUDA error
// (0 on success) without synchronising.
int allpairs_sym_pair_launch(const void* pos_i, const void* mass_i,
                             const void* pos_j, const void* mass_j, void* acc,
                             void* out, int n, float softening2, int mode,
                             int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kExact:
      return launch_sym_pair<kExact>(st, pos_i, mass_i, pos_j, mass_j, acc,
                                     out, n, softening2);
    case kNewton:
      return launch_sym_pair<kNewton>(st, pos_i, mass_i, pos_j, mass_j, acc,
                                      out, n, softening2);
    case kApprox:
      return launch_sym_pair<kApprox>(st, pos_i, mass_i, pos_j, mass_j, acc,
                                      out, n, softening2);
    case kNewtonClamp:
      return launch_sym_pair<kNewtonClamp>(st, pos_i, mass_i, pos_j, mass_j,
                                           acc, out, n, softening2);
    case kApproxClamp:
      return launch_sym_pair<kApproxClamp>(st, pos_i, mass_i, pos_j, mass_j,
                                           acc, out, n, softening2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6. tgt f32[Ni,2], src f32[Nj,2], src_m f32[Nj], out f32[Ni]; all
// contiguous on `device`. Launches on `stream` and returns
// cudaGetLastError() (0 on success) without synchronising.
int potential_launch(const void* tgt, const void* src, const void* src_m,
                     void* out, int ni, int nj, float softening2, int device,
                     void* stream) {
  if (ni <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_ordered<kExact, true>(static_cast<cudaStream_t>(stream), tgt,
                                      src, src_m, out, ni, nj, softening2);
}

}  // extern "C"
