// All-pairs kernels for Hopper (sm_90a): the ordered force sweep (K1), the
// symmetric third-law force sweep (K2) and its cross-shard form (K9), all in
// the five rcp modes of pair_law.cuh, and the ordered potential sweep (K6).
//
// K1 replaces nbody_simulation_tpu/ops/allpairs.py:_allpairs_kernel (called
// by allpairs_accel, pallas_call at :537):
//   out[i] = sum_j mono_pair(src_j - tgt_i, m_j)
// for targets f32[Ni,2] against sources f32[Nj,2] with masses f32[Nj].
// One thread per target, 256 targets per block; the sources are staged
// through shared memory as (x, y, m) in tiles of 1024 and read as
// broadcasts. No reduction across threads, so no atomics, and the result
// does not depend on the schedule.
//
// K6 replaces nbody_simulation_tpu/ops/energy.py:_potential_kernel (called
// by allpairs_potential, pallas_call at :118):
//   phi[i] = sum_j -m_j / sqrt(max(|p_j - p_i|^2, eps))
// over pairs whose |d|_1 is a normal float (pot_term in pair_law.cuh),
// giving f32[Ni]. It is FP32-bound like K1 (the JAX law's 12 operations
// per pair besides the root; 10 in the form run here, below). Two things
// held it to a quarter of that bound when it was K1's skeleton: a correctly rounded root, a software
// sequence of two dozen instructions; and one thread per target, each
// block's loop serial over all Nj sources, which gave the galaxy half a
// wave of blocks and the ring's shards (Ni = Nj = 51,200) 200 blocks on 132
// SMs. So the root is rsqrt.approx (one MUFU.RSQ, relative error below
// 2^-22.9, as the TPU kernel's lax.rsqrt; its .ftz form when eps is a
// normal float); the mask is one compare where a bound on the block's
// coordinates, checked once per stage, proves |d|_1 finite (pot_run); each
// thread holds kPotTargets targets, which share every staged source; and
// the sources are cut into chunks of whole runs, one block per (target
// block, chunk), the chunk chosen by the host so that the grid makes
// several whole waves of the kernel's resident blocks (ops/split.py:
// chunk_plan). Each block writes its f64 sums to its own slot (chunk,
// target), and potential_fold adds a target's slots in chunk order and
// rounds once: no atomics, two calls bitwise equal. Every term has the sign
// of -m_j, so sum|c| = |phi| and the error bound is relative.
//
// K2 replaces _allpairs_sym_kernel (called by allpairs_accel_sym,
// pallas_call at :290; pair kernel _sym_r :103): each unordered pair's
// k(d) is evaluated once and applied to both particles,
//   a_i += m_j * d * k(d),  a_j -= m_i * d * k(d),  d = p_j - p_i.
// The TPU kernel read-modify-writes aliased accumulators over a sequential
// grid. On a GPU the blocks run at once, so the j side would race. The
// schedule here is the same tournament: the particles are cut into nt tiles
// of 256, and round k pairs tile b with tile (b + k) mod nt, one block each
// (round 0 is the diagonal, i side only; for even nt, round nt/2 runs only
// b < nt/2, since its other half repeats the first). One launch runs R
// consecutive rounds, so R * nt blocks (fewer in K2's half round): a round
// alone is 200 blocks at the ring's shard size, too few to fill 132 SMs.
// Block (round k0 + s, tile b) writes its i-side f64 sums to slot s of the
// i side at tile b and its j-side sums to slot s of the j side at tile
// (b + k) mod nt; inside a round every tile is an i tile once and a j tile
// once, so no two blocks of a launch share a slot. A fold after the launch
// adds slot 0, 1, ... R-1 into the f64 accumulators, the i side with + and
// the j side with -, so each accumulator takes its partials in round order.
// The schedule is a table of (round, i tile, j tile, slot), one row per
// block, built in Python (ops/allpairs.py:sym_schedule, tested on the CPU)
// and read by blockIdx.x; R is chosen there so that a launch holds a few
// waves of the kernel's resident blocks, within a bound on the slots'
// bytes. Inside a block each lane holds kTargets i targets, and a group of
// kGroup = 32 / kTargets lanes takes the j tile in chunks of kGroup sources:
// lane q starts with source q of the chunk, and after each step the sources
// rotate one lane down the group by shuffle, carrying their j-side sums with
// them. After kGroup steps every target has met every source of the chunk
// and each source is home with its sum over the group's 32 targets. So the
// three source shuffles and the two j-sum shuffles of a step serve kTargets
// pairs, and the kTargets reciprocal chains of a step are independent. The
// 8 groups' sums per source are then added in group order through shared
// memory. Every sum has a fixed order, so two calls on the same input are
// bitwise equal; there is no float atomic anywhere. This was chosen over
// float atomicAdd (order of arrival changes the bits from run to run); the
// slots bound the per-tile partials to R rounds' worth, where all of them
// would be N^2/T floats (gigabytes at N=1M). With kTargets = 1 the in-block
// arithmetic is the one-launch-per-round kernel this replaced, and the
// result is bitwise that kernel's (tools/sym_kernel_ab.py).
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
// by one block. Its slots, fold and f64 accumulators are K2's; it is
// bitwise deterministic too. The TPU kernel's flattened (nt, nt) grid and
// its per-round calls for small nt exist for the TPU's aliased accumulators
// and are not carried over.
//
// What bounds them: at N=1M the inputs are 12 MB and the output 8 MB, while
// K1 evaluates N^2 = 1.1e12 pairs and K2 N^2/2 (K6, once per energy
// sample, N^2 like K1; K9 L^2 per call on 40 L bytes). Each pair is one MUFU
// reciprocal or rsqrt (an IEEE division in the forces' `exact`) and a dozen
// to two dozen FP32 operations of the law itself, so FP32 issue bounds them,
// not memory: chip_smoke.py computes each bound from the card's clock and
// the law's operation count per pair (PERF.md). A step of K2 and K9 also
// rotates five registers by shuffle, 5 / kTargets per pair, which the law
// does not count, and the slots move 32 bytes per particle and round through
// memory (written by the blocks, read by the fold).

#include <cuda_runtime.h>

#include "pair_law.cuh"

namespace {

using namespace pair_law;

constexpr int kThreads = 256;  // K1: targets per block
constexpr int kTile = 1024;    // K1: sources staged per pass
constexpr int kRun = 32;       // K1, K6: terms per f32 run sum (divides kTile)

constexpr int kPotThreads = 256;   // K6: threads per block
constexpr int kPotTargets = 16;    // K6: targets per thread
constexpr int kPotStage = 1024;    // K6: sources staged per pass
static_assert(kPotStage % kRun == 0, "a stage holds whole runs");

// K2, K9. kTargets is the number of i targets each lane holds: a group of
// kGroup = 32 / kTargets lanes rotates a chunk of kGroup sources, so each
// source's j-side run sum collects kGroup * kTargets = 32 terms per chunk,
// and each target's i-side run sum is flushed to f64 after kTargets chunks
// (32 terms). Every tile of 256 targets is cut into kParts parts of 32,
// whatever kTargets is, so a source's j side has kParts partials per tile.
constexpr int kSymTile = 256;                     // particles per tile
constexpr int kTargets = 4;                       // i targets per lane
constexpr int kGroup = 32 / kTargets;             // lanes per source chunk
constexpr int kSymThreads = kSymTile / kTargets;  // threads per block
constexpr int kParts = kSymTile / 32;             // j-side partials per source

// K1, the ordered force sweep in rcp mode MODE into out f32[Ni,2].
template <int MODE>
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
        float cx, cy;
        mono_pair<MODE>(dx, dy, q.z, soft2, cx, cy);
        rx = __fadd_rn(rx, cx);
        ry = __fadd_rn(ry, cy);
      }
      ax = __dadd_rn(ax, static_cast<double>(rx));
      ay = __dadd_rn(ay, static_cast<double>(ry));
    }
  }
  if (!live) return;
  reinterpret_cast<float2*>(out)[i] =
      make_float2(static_cast<float>(ax), static_cast<float>(ay));
}

// K6's stage bound: where every target of the block and every staged
// source has |x|, |y| <= 2^125 (or is NaN), every |d| <= 2^126 per axis and
// s = |d|_1 is finite or NaN, so the mask is one compare
// (pair_counts<true>); a stage holding an inf or a larger coordinate takes
// the full mask.
constexpr float kPotCoordBound = 0x1p125f;

__device__ __forceinline__ bool pot_bounded(float x, float y) {
  return !(fabsf(x) > kPotCoordBound) && !(fabsf(y) > kPotCoordBound);
}

// One run of K6's stage: staged sources [j0, j1) against the thread's
// kPotTargets targets, summed in source order into r.
template <bool FTZ, bool BOUNDED>
__device__ __forceinline__ void pot_run(const float4* __restrict__ sh,
                                        int j0, int j1,
                                        const float (&tx)[kPotTargets],
                                        const float (&ty)[kPotTargets],
                                        float soft2,
                                        float (&r)[kPotTargets]) {
#pragma unroll 8
  for (int j = j0; j < j1; ++j) {
    const float4 q = sh[j];
#pragma unroll
    for (int t = 0; t < kPotTargets; ++t) {
      float phi;
      if (pot_term<FTZ, BOUNDED>(__fsub_rn(q.x, tx[t]),
                                 __fsub_rn(q.y, ty[t]), q.z, soft2, phi))
        r[t] = __fadd_rn(r[t], phi);
    }
  }
}

// K6. Block (target block blockIdx.x, chunk blockIdx.y): targets i0 + t *
// kPotThreads against sources [k * chunk, min((k + 1) * chunk, nj)), f64
// sums into slots[k, i]. A thread past ni computes on target ni - 1 and
// writes nothing.
template <bool FTZ>
__global__ void __launch_bounds__(kPotThreads)
potential_kernel(const float2* __restrict__ tgt,
                 const float2* __restrict__ src,
                 const float* __restrict__ src_m, double* __restrict__ slots,
                 int ni, int nj, int chunk, float soft2) {
  __shared__ float4 sh[kPotStage];
  const int k = blockIdx.y;
  const int j_end = min((k + 1) * chunk, nj);
  const int i0 = blockIdx.x * (kPotThreads * kPotTargets) + threadIdx.x;
  float tx[kPotTargets], ty[kPotTargets];
  double acc[kPotTargets];
  bool tgt_bounded = true;
#pragma unroll
  for (int t = 0; t < kPotTargets; ++t) {
    const float2 p = tgt[min(i0 + t * kPotThreads, ni - 1)];
    tx[t] = p.x;
    ty[t] = p.y;
    tgt_bounded &= pot_bounded(p.x, p.y);
    acc[t] = 0.0;
  }
  for (int base = k * chunk; base < j_end; base += kPotStage) {
    const int n = min(kPotStage, j_end - base);
    __syncthreads();  // the previous stage is fully consumed
    bool bounded = tgt_bounded;
    for (int j = threadIdx.x; j < n; j += kPotThreads) {
      const float2 p = src[base + j];
      sh[j] = make_float4(p.x, p.y, src_m[base + j], 0.0f);
      bounded &= pot_bounded(p.x, p.y);
    }
    const bool fast = __syncthreads_and(bounded);
    for (int j0 = 0; j0 < n; j0 += kRun) {
      const int j1 = min(j0 + kRun, n);
      float r[kPotTargets] = {};
      if (fast)
        pot_run<FTZ, true>(sh, j0, j1, tx, ty, soft2, r);
      else
        pot_run<FTZ, false>(sh, j0, j1, tx, ty, soft2, r);
#pragma unroll
      for (int t = 0; t < kPotTargets; ++t)
        acc[t] = __dadd_rn(acc[t], static_cast<double>(r[t]));
    }
  }
#pragma unroll
  for (int t = 0; t < kPotTargets; ++t) {
    const int i = i0 + t * kPotThreads;
    if (i < ni) slots[static_cast<size_t>(k) * ni + i] = acc[t];
  }
}

// K6's fold: target i adds its chunks' slots in chunk order, rounds once.
__global__ void potential_fold(const double* __restrict__ slots,
                               float* __restrict__ out, int ni, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ni) return;
  double a = 0.0;
  for (int k = 0; k < chunks; ++k)
    a = __dadd_rn(a, slots[static_cast<size_t>(k) * ni + i]);
  out[i] = static_cast<float>(a);
}

// One block's share of a round: i tile ti (targets) against j tile tj
// (sources). DIAG is K2's round 0: the i side over the block's own tile,
// every ordered pair, and no j side (it would count each pair twice), as the
// JAX kernel does with its k != 0 mass factor. Writes the block's i-side
// sums, f64, to out_i[p] for the tile's particles p, and (not DIAG) its
// j-side sums, before the sign, to out_j[p] for the j tile's particles.
template <int MODE, bool DIAG>
__device__ __forceinline__ void sym_block(
    const float2* __restrict__ pos_i, const float* __restrict__ mass_i,
    const float2* __restrict__ pos_j, const float* __restrict__ mass_j,
    int ti, int tj, int n, float soft2, float (*sh_x)[kSymTile],
    float (*sh_y)[kSymTile], double2* __restrict__ out_i,
    double2* __restrict__ out_j) {
  const int lane = threadIdx.x & 31;
  const int q = lane % kGroup;  // lane within its group
  // The part of the tile this group's targets are: lane q holds targets
  // part * 32 + t * kGroup + q, t < kTargets.
  const int part = (threadIdx.x >> 5) * kTargets + lane / kGroup;
  const int base = ti * kSymTile + part * 32 + q;

  // A slot past n is an inert particle: mass 0 at the origin.
  float xi[kTargets], yi[kTargets], mi[kTargets], rx[kTargets], ry[kTargets];
  double ax[kTargets], ay[kTargets];
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = base + t * kGroup;
    const bool live = i < n;
    const float2 p = live ? pos_i[i] : make_float2(0.0f, 0.0f);
    xi[t] = p.x;
    yi[t] = p.y;
    mi[t] = live ? mass_i[i] : 0.0f;
    rx[t] = ry[t] = 0.0f;  // i side over the current kTargets chunks
    ax[t] = ay[t] = 0.0;
  }
  for (int c = 0; c < kSymTile / kGroup; ++c) {
    const int j = tj * kSymTile + c * kGroup + q;
    const bool jlive = j < n;
    const float2 pj = jlive ? pos_j[j] : make_float2(0.0f, 0.0f);
    float xj = pj.x, yj = pj.y;
    float mj = jlive ? mass_j[j] : 0.0f;
    float bx = 0.0f, by = 0.0f;  // j side of the source this lane holds
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      float dx[kTargets], dy[kTargets], sl[kTargets], den[kTargets];
      float rc[kTargets] = {};
      bool in_range = true;
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        dx[t] = __fsub_rn(xj, xi[t]);
        dy[t] = __fsub_rn(yj, yi[t]);
        den[t] = sym_den<MODE>(dx[t], dy[t], soft2, sl[t]);
        in_range = in_range && rcp_in_range(den[t]);
      }
      // The reciprocals of the step's kTargets pairs: bitwise rcp_approx,
      // without its range fix-up where the whole warp is inside the range
      // (pair_law.cuh); the warp takes one branch or the other.
      if (MODE != kExact) {
        if (__all_sync(0xffffffffu, in_range)) {
#pragma unroll
          for (int t = 0; t < kTargets; ++t) rc[t] = rcp_approx_ftz(den[t]);
        } else {
#pragma unroll
          for (int t = 0; t < kTargets; ++t) rc[t] = rcp_approx(den[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        const float kr = sym_k<MODE>(sl[t], den[t], rc[t]);
        const float wi = __fmul_rn(mj, kr);
        rx[t] = __fadd_rn(rx[t], __fmul_rn(dx[t], wi));
        ry[t] = __fadd_rn(ry[t], __fmul_rn(dy[t], wi));
        if (!DIAG) {
          const float wj = __fmul_rn(mi[t], kr);
          bx = __fadd_rn(bx, __fmul_rn(dx[t], wj));
          by = __fadd_rn(by, __fmul_rn(dy[t], wj));
        }
      }
      // The sources, with their j-side sums, move one lane down the group.
      if (!DIAG) {
        bx = __shfl_sync(0xffffffffu, bx, q + 1, kGroup);
        by = __shfl_sync(0xffffffffu, by, q + 1, kGroup);
      }
      xj = __shfl_sync(0xffffffffu, xj, q + 1, kGroup);
      yj = __shfl_sync(0xffffffffu, yj, q + 1, kGroup);
      mj = __shfl_sync(0xffffffffu, mj, q + 1, kGroup);
    }
    if (c % kTargets == kTargets - 1) {  // 32 terms in each i-side run
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        ax[t] = __dadd_rn(ax[t], static_cast<double>(rx[t]));
        ay[t] = __dadd_rn(ay[t], static_cast<double>(ry[t]));
        rx[t] = ry[t] = 0.0f;
      }
    }
    if (!DIAG) {  // kGroup rotations: source c*kGroup + q is back home
      sh_x[part][c * kGroup + q] = bx;
      sh_y[part][c * kGroup + q] = by;
    }
  }
#pragma unroll
  for (int t = 0; t < kTargets; ++t)
    out_i[base + t * kGroup] = make_double2(ax[t], ay[t]);
  if (!DIAG) {
    __syncthreads();
    for (int s = threadIdx.x; s < kSymTile; s += kSymThreads) {
      double sx = 0.0, sy = 0.0;
#pragma unroll
      for (int w = 0; w < kParts; ++w) {
        sx = __dadd_rn(sx, static_cast<double>(sh_x[w][s]));
        sy = __dadd_rn(sy, static_cast<double>(sh_y[w][s]));
      }
      out_j[tj * kSymTile + s] = make_double2(sx, sy);
    }
  }
}

// Several tournament rounds in one launch. Block b runs row b of `sched`,
// (round k, i tile, j tile, slot s), and writes its i-side sums to slot s
// of slot_i and its j-side sums to slot s of slot_j; each slot is n_pad
// double2 long. The schedule gives no two blocks of a launch the same i or
// j slot entry. SELF is K2 (one particle block on both sides), whose round 0
// is the diagonal; else K9 (two blocks, no diagonal).
template <int MODE, bool SELF>
__global__ void __launch_bounds__(kSymThreads)
allpairs_sym_rounds(const float2* __restrict__ pos_i,
                    const float* __restrict__ mass_i,
                    const float2* __restrict__ pos_j,
                    const float* __restrict__ mass_j,
                    const int4* __restrict__ sched,
                    double2* __restrict__ slot_i,
                    double2* __restrict__ slot_j, int n, int n_pad,
                    float soft2) {
  __shared__ float sh_x[kParts][kSymTile];
  __shared__ float sh_y[kParts][kSymTile];
  const int4 e = sched[blockIdx.x];
  const size_t off = static_cast<size_t>(e.w) * n_pad;
  if (SELF && e.x == 0)
    sym_block<MODE, true>(pos_i, mass_i, pos_j, mass_j, e.y, e.z, n, soft2,
                          sh_x, sh_y, slot_i + off, nullptr);
  else
    sym_block<MODE, false>(pos_i, mass_i, pos_j, mass_j, e.y, e.z, n, soft2,
                           sh_x, sh_y, slot_i + off, slot_j + off);
}

// The fold after each launch: particle p of tile t adds the launch's slots
// into the f64 accumulators in round order, the i side with + and the j side
// with -, where fold[s * nt + t] says which sides slot s wrote for tile t
// (bit 0: i, bit 1: j).
__global__ void sym_fold(const double2* __restrict__ slot_i,
                         const double2* __restrict__ slot_j,
                         const unsigned char* __restrict__ fold,
                         double2* __restrict__ acc_i,
                         double2* __restrict__ acc_j, int n, int n_pad,
                         int nt, int rounds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = i / kSymTile;
  double2 a = acc_i[i];
  double2 b = acc_j[i];
  for (int s = 0; s < rounds; ++s) {
    const unsigned char f = fold[s * nt + t];
    const size_t at = static_cast<size_t>(s) * n_pad + i;
    if (f & 1) {
      const double2 p = slot_i[at];
      a.x = __dadd_rn(a.x, p.x);
      a.y = __dadd_rn(a.y, p.y);
    }
    if (f & 2) {
      const double2 p = slot_j[at];
      b.x = __dsub_rn(b.x, p.x);
      b.y = __dsub_rn(b.y, p.y);
    }
  }
  acc_i[i] = a;
  acc_j[i] = b;
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

template <int MODE>
int launch_ordered(cudaStream_t st, const void* tgt, const void* src,
                   const void* src_m, void* out, int ni, int nj, float soft2) {
  const int blocks = (ni + kThreads - 1) / kThreads;
  ordered_kernel<MODE><<<blocks, kThreads, 0, st>>>(
      static_cast<const float2*>(tgt), static_cast<const float2*>(src),
      static_cast<const float*>(src_m), static_cast<float*>(out), ni, nj,
      soft2);
  return static_cast<int>(cudaGetLastError());
}

// The launches of one K2 (SELF) or K9 call. `launches` is a host array of
// n_launches rows (first row of `sched`, blocks, first round, rounds), each
// one launch of allpairs_sym_rounds and its fold; `slots` holds 2 * r_max
// slots of n_pad double2 (the i side's, then the j side's).
template <int MODE, bool SELF>
int launch_rounds(cudaStream_t st, const void* pos_i, const void* mass_i,
                  const void* pos_j, const void* mass_j, const void* sched,
                  const void* fold, const int* launches, int n_launches,
                  void* slots, int r_max, void* acc, void* out, int n,
                  float soft2) {
  const int nt = (n + kSymTile - 1) / kSymTile;
  const int n_pad = nt * kSymTile;
  double2* acc_i = static_cast<double2*>(acc);
  double2* acc_j = acc_i + n;
  double2* slot_i = static_cast<double2*>(slots);
  double2* slot_j = slot_i + static_cast<size_t>(r_max) * n_pad;
  const int4* rows = static_cast<const int4*>(sched);
  const unsigned char* bits = static_cast<const unsigned char*>(fold);
  for (int l = 0; l < n_launches; ++l) {
    const int* at = launches + 4 * l;
    allpairs_sym_rounds<MODE, SELF><<<at[1], kSymThreads, 0, st>>>(
        static_cast<const float2*>(pos_i), static_cast<const float*>(mass_i),
        static_cast<const float2*>(pos_j), static_cast<const float*>(mass_j),
        rows + at[0], slot_i, slot_j, n, n_pad, soft2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sym_fold<<<(n + 255) / 256, 256, 0, st>>>(
        slot_i, slot_j, bits + static_cast<size_t>(at[2]) * nt, acc_i, acc_j,
        n, n_pad, nt, at[3]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (SELF)
    sym_finish<<<(n + 255) / 256, 256, 0, st>>>(acc_i, acc_j,
                                                 static_cast<float2*>(out), n);
  else
    sym_pair_finish<<<(2 * n + 255) / 256, 256, 0, st>>>(
        acc_i, static_cast<float2*>(out), 2 * n);
  return static_cast<int>(cudaGetLastError());
}

template <bool SELF>
int sym_call(int mode, cudaStream_t st, const void* pos_i,
             const void* mass_i, const void* pos_j, const void* mass_j,
             const void* sched, const void* fold, const int* launches,
             int n_launches, void* slots, int r_max, void* acc, void* out,
             int n, float soft2) {
#define SYM_CASE(M)                                                         \
  case M:                                                                   \
    return launch_rounds<M, SELF>(st, pos_i, mass_i, pos_j, mass_j, sched,  \
                                  fold, launches, n_launches, slots, r_max, \
                                  acc, out, n, soft2);
  switch (mode) {
    SYM_CASE(kExact)
    SYM_CASE(kNewton)
    SYM_CASE(kApprox)
    SYM_CASE(kNewtonClamp)
    SYM_CASE(kApproxClamp)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SYM_CASE
}

template <bool SELF>
int sym_occupancy(int mode, int* blocks) {
  switch (mode) {
#define OCC_CASE(M)                                              \
  case M:                                                        \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor( \
        blocks, allpairs_sym_rounds<M, SELF>, kSymThreads, 0));
    OCC_CASE(kExact)
    OCC_CASE(kNewton)
    OCC_CASE(kApprox)
    OCC_CASE(kNewtonClamp)
    OCC_CASE(kApproxClamp)
#undef OCC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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

// K2. pos f32[N,2], mass f32[N], acc f64[2,N,2] zeroed by the caller (the
// i-side and j-side accumulators), out f32[N,2]; the schedule of
// ops/allpairs.py:sym_schedule for nt = ceil(N/256) tiles: sched int32[B,4]
// and fold uint8[K,nt] on the device, `launches` int32[n_launches,4] on the
// host; slots f64[2,r_max,nt*256,2] scratch, r_max at least the rounds of
// any launch. All device arrays contiguous on `device`. Launches
// 2 * n_launches + 1 kernels on `stream` and returns the first CUDA error (0
// on success) without synchronising.
int allpairs_sym_launch(const void* pos, const void* mass, const void* sched,
                        const void* fold, const int* launches, int n_launches,
                        void* slots, int r_max, void* acc, void* out, int n,
                        float softening2, int mode, int device,
                        void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return sym_call<true>(mode, static_cast<cudaStream_t>(stream), pos, mass,
                        pos, mass, sched, fold, launches, n_launches, slots,
                        r_max, acc, out, n, softening2);
}

// K9. pos_i, pos_j f32[N,2], mass_i, mass_j f32[N], out f32[2,N,2] (acc_i,
// then acc_j); the rest as K2's, with K9's schedule.
int allpairs_sym_pair_launch(const void* pos_i, const void* mass_i,
                             const void* pos_j, const void* mass_j,
                             const void* sched, const void* fold,
                             const int* launches, int n_launches, void* slots,
                             int r_max, void* acc, void* out, int n,
                             float softening2, int mode, int device,
                             void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return sym_call<false>(mode, static_cast<cudaStream_t>(stream), pos_i,
                         mass_i, pos_j, mass_j, sched, fold, launches,
                         n_launches, slots, r_max, acc, out, n, softening2);
}

// The launch shape of K2's (self_pairs != 0) or K9's round kernel in rcp
// mode `mode`: threads per block, targets per lane and resident blocks per
// SM, into the three pointers; returns the CUDA error (0 on success).
int allpairs_sym_shape(int self_pairs, int mode, int device, int* threads,
                       int* targets, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = kSymThreads;
  *targets = kTargets;
  return self_pairs ? sym_occupancy<true>(mode, blocks)
                    : sym_occupancy<false>(mode, blocks);
}

// K6. tgt f32[Ni,2], src f32[Nj,2], src_m f32[Nj], out f32[Ni]; slots
// f64[ceil(Nj/chunk),Ni] scratch; chunk a positive multiple of 32. All
// contiguous on `device`. FTZ takes the .ftz root, for softening2 >=
// FLT_MIN_NORMAL. Launches the sweep and its fold on `stream` and returns
// the first CUDA error (0 on success) without synchronising.
int potential_launch(const void* tgt, const void* src, const void* src_m,
                     void* slots, void* out, int ni, int nj, int chunk,
                     float softening2, int device, void* stream) {
  if (ni <= 0) return 0;
  if (chunk <= 0 || chunk % kRun != 0 || nj < 0 ||
      (nj + chunk - 1) / chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (nj + chunk - 1) / chunk;
  if (chunks > 0) {
    const dim3 grid((ni + kPotThreads * kPotTargets - 1) /
                        (kPotThreads * kPotTargets),
                    chunks);
    const auto* t = static_cast<const float2*>(tgt);
    const auto* s = static_cast<const float2*>(src);
    const auto* m = static_cast<const float*>(src_m);
    auto* sl = static_cast<double*>(slots);
    if (softening2 >= kFltMinNormal)
      potential_kernel<true><<<grid, kPotThreads, 0, st>>>(
          t, s, m, sl, ni, nj, chunk, softening2);
    else
      potential_kernel<false><<<grid, kPotThreads, 0, st>>>(
          t, s, m, sl, ni, nj, chunk, softening2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  potential_fold<<<(ni + 255) / 256, 256, 0, st>>>(
      static_cast<const double*>(slots), static_cast<float*>(out), ni,
      chunks);
  return static_cast<int>(cudaGetLastError());
}

// K6's launch shape: threads per block, targets per thread and the
// resident blocks per SM of the form softening2 picks, into the three
// pointers; returns the CUDA error (0 on success).
int potential_shape(float softening2, int device, int* threads,
                    int* targets, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = kPotThreads;
  *targets = kPotTargets;
  return static_cast<int>(
      softening2 >= kFltMinNormal
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                blocks, potential_kernel<true>, kPotThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                blocks, potential_kernel<false>, kPotThreads, 0));
}

}  // extern "C"
