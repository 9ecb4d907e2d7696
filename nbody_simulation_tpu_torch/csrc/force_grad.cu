// Backward kernels of the differentiable force paths for Hopper (sm_90a):
// the two all-pairs backward sweeps (K7) and the two grouped Barnes-Hut
// backward sweeps (K8). Every pair goes through grad_pair of pair_law.cuh,
// the closed-form J^T g of the ordered force law with u the cotangent of
// d = p_src - p_tgt:
//
// K7a allpairs_bwd_i replaces nbody_simulation_tpu/ops/allpairs_grad.py:
//   _bwd_i_kernel (called by bwd_sweeps, pallas_call at :183):
//     pbar_i = -sum_j u(p_j - p_i, g_i, m_j)                      f32[Ni,2]
// K7b allpairs_bwd_j replaces _bwd_j_kernel (pallas_call at :198):
//     pbar_j = sum_i u(p_j - p_i, g_i, m_j)                       f32[Nj,2]
//     mbar_j = sum_i r*t                                          f32[Nj]
// K8a grouped_bwd_tgt replaces nbody_simulation_tpu/ops/traversal_grad.py:
//   _gf_bwd_tgt_kernel (called by _gf_bwd, pallas_call at :128):
//     tbar[g,s] = -sum_c u(src[g,c] - tgt[g,s], gbar[g,s], m[g,c])  f32[G,S,2]
// K8b grouped_bwd_src replaces _gf_bwd_src_kernel (pallas_call at :143):
//     sbar_x/y[g,c] = sum_s u,   mbar[g,c] = sum_s r*t             f32[G,C] x3
//
// On a TPU the grid runs in order and the kernels accumulate into their
// output blocks from one grid step to the next. On Hopper the blocks run at
// once, so each output here is owned by one thread that loops over the other
// axis: no reduction across threads, no float atomics, and two calls on the
// same input are bitwise equal.
//
// K7a and K8a: one thread per target, holding its position and cotangent;
// the block stages the sources (x, y, m) through shared memory in tiles of
// 1024 and reads them as broadcasts, as the forward sweeps do. K8a's block
// is the group's S targets rounded up to a warp and capped at 256, and it
// loops over all C columns: past a group's last nonzero-mass column u is
// m*(...) = 0 only where the law is finite, and mbar = sum r*t does not
// scale with m at all, so the forward's column bound does not carry over.
// K7b and K8b: one thread per source, holding (x, y, m); the block stages
// the targets (x, y, gx, gy) in tiles of 1024. K8b runs one block per
// (group, tile of up to 256 columns) and writes each of its three outputs
// exactly once, as _gf_bwd_src_kernel does.
//
// Summation: every sum runs over at most 32 terms in f32; the run sums are
// added in f64 and rounded to f32 once, as in the forward kernels, so the
// heavy bodies of the galaxy do not swamp the small terms (a plain running
// f32 sum lost 5.4e-5 of sum|c| in the forward sweep on an H100; PERF.md).
//
// What bounds them: each pair costs one MUFU reciprocal and 43 (target
// side) or 45 (source side) FP32 operations of the law (chip_smoke.py,
// law_ops "grad_i", "grad_j"), against at most 16 bytes per pair read from
// shared memory and a few bytes per target or column from device memory.
// At the padded galaxy (N=151,552) each K7 sweep evaluates 2.3e10 pairs
// from 3 MB of inputs; K8 at bh_accel_diff's galaxy shape (G=4096, S=64,
// C=1472) 3.9e8 pairs from 77 MB. Both are bound by FP32 throughput, not
// memory: chip_smoke.py computes each bound from the card's clock and the
// law's operation count (PERF.md). The design keeps the inner loop free of
// global loads and of any reduction across threads; the rest (more targets
// per thread to reuse each staged source, fewer operations per pair) is
// later work.

#include <cuda_runtime.h>

#include "pair_law.cuh"

namespace {

using namespace pair_law;

constexpr int kThreads = 256;  // K7: outputs per block; K8: at most
constexpr int kTile = 1024;    // staged sources or targets per pass
constexpr int kRun = 32;       // terms per f32 run sum (divides kTile)

// K7a. One thread per target i against every source j.
__global__ void __launch_bounds__(kThreads)
allpairs_bwd_i(const float2* __restrict__ pos_i,
               const float2* __restrict__ g_i,
               const float2* __restrict__ pos_j,
               const float* __restrict__ mass_j, float2* __restrict__ out,
               int ni, int nj, float soft2) {
  __shared__ float4 sh[kTile];  // (x_j, y_j, m_j, -)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < ni;
  const float2 p = live ? pos_i[i] : make_float2(0.0f, 0.0f);
  const float2 g = live ? g_i[i] : make_float2(0.0f, 0.0f);
  double ax = 0.0, ay = 0.0;
  for (int base = 0; base < nj; base += kTile) {
    const int n = min(kTile, nj - base);
    __syncthreads();  // the previous tile is fully consumed
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float2 q = pos_j[base + j];
      sh[j] = make_float4(q.x, q.y, mass_j[base + j], 0.0f);
    }
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += kRun) {
      const int j1 = min(j0 + kRun, n);
      float rx = 0.0f, ry = 0.0f;
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const float4 q = sh[j];
        float ux, uy, r, t;
        grad_pair(__fsub_rn(q.x, p.x), __fsub_rn(q.y, p.y), g.x, g.y, q.z,
                  soft2, ux, uy, r, t);
        rx = __fadd_rn(rx, ux);
        ry = __fadd_rn(ry, uy);
      }
      ax = __dadd_rn(ax, static_cast<double>(rx));
      ay = __dadd_rn(ay, static_cast<double>(ry));
    }
  }
  if (live)
    out[i] = make_float2(-static_cast<float>(ax), -static_cast<float>(ay));
}

// K7b. One thread per source j against every target i.
__global__ void __launch_bounds__(kThreads)
allpairs_bwd_j(const float2* __restrict__ pos_i,
               const float2* __restrict__ g_i,
               const float2* __restrict__ pos_j,
               const float* __restrict__ mass_j, float2* __restrict__ out_p,
               float* __restrict__ out_m, int ni, int nj, float soft2) {
  __shared__ float4 sh[kTile];  // (x_i, y_i, gx_i, gy_i)
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool live = j < nj;
  const float2 p = live ? pos_j[j] : make_float2(0.0f, 0.0f);
  const float m = live ? mass_j[j] : 0.0f;
  double ax = 0.0, ay = 0.0, am = 0.0;
  for (int base = 0; base < ni; base += kTile) {
    const int n = min(kTile, ni - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float2 q = pos_i[base + i];
      const float2 g = g_i[base + i];
      sh[i] = make_float4(q.x, q.y, g.x, g.y);
    }
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += kRun) {
      const int i1 = min(i0 + kRun, n);
      float rx = 0.0f, ry = 0.0f, rm = 0.0f;
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        const float4 q = sh[i];
        float ux, uy, r, t;
        grad_pair(__fsub_rn(p.x, q.x), __fsub_rn(p.y, q.y), q.z, q.w, m,
                  soft2, ux, uy, r, t);
        rx = __fadd_rn(rx, ux);
        ry = __fadd_rn(ry, uy);
        rm = __fadd_rn(rm, __fmul_rn(r, t));
      }
      ax = __dadd_rn(ax, static_cast<double>(rx));
      ay = __dadd_rn(ay, static_cast<double>(ry));
      am = __dadd_rn(am, static_cast<double>(rm));
    }
  }
  if (live) {
    out_p[j] = make_float2(static_cast<float>(ax), static_cast<float>(ay));
    out_m[j] = static_cast<float>(am);
  }
}

// K8a. Block (g, chunk of targets); one thread per target of group g
// against all C of the group's columns.
__global__ void __launch_bounds__(kThreads)
grouped_bwd_tgt(const float2* __restrict__ tgt,
                const float2* __restrict__ gbar,
                const float* __restrict__ src_x,
                const float* __restrict__ src_y,
                const float* __restrict__ src_m, float2* __restrict__ out,
                int S, int C, float soft2) {
  __shared__ float sh[3][kTile];
  const int g = blockIdx.x;
  const int s = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = s < S;
  const size_t trow = static_cast<size_t>(g) * S;
  const float2 p = live ? tgt[trow + s] : make_float2(0.0f, 0.0f);
  const float2 gg = live ? gbar[trow + s] : make_float2(0.0f, 0.0f);
  const size_t srow = static_cast<size_t>(g) * C;
  double ax = 0.0, ay = 0.0;
  for (int base = 0; base < C; base += kTile) {
    const int n = min(kTile, C - base);
    __syncthreads();
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      sh[0][c] = src_x[srow + base + c];
      sh[1][c] = src_y[srow + base + c];
      sh[2][c] = src_m[srow + base + c];
    }
    __syncthreads();
    if (live) {
      for (int c0 = 0; c0 < n; c0 += kRun) {
        const int c1 = min(c0 + kRun, n);
        float rx = 0.0f, ry = 0.0f;
#pragma unroll 4
        for (int c = c0; c < c1; ++c) {
          float ux, uy, r, t;
          grad_pair(__fsub_rn(sh[0][c], p.x), __fsub_rn(sh[1][c], p.y), gg.x,
                    gg.y, sh[2][c], soft2, ux, uy, r, t);
          rx = __fadd_rn(rx, ux);
          ry = __fadd_rn(ry, uy);
        }
        ax = __dadd_rn(ax, static_cast<double>(rx));
        ay = __dadd_rn(ay, static_cast<double>(ry));
      }
    }
  }
  if (live)
    out[trow + s] =
        make_float2(-static_cast<float>(ax), -static_cast<float>(ay));
}

// K8b. Block (g, tile of columns); one thread per column of group g
// against the group's S targets.
__global__ void __launch_bounds__(kThreads)
grouped_bwd_src(const float2* __restrict__ tgt,
                const float2* __restrict__ gbar,
                const float* __restrict__ src_x,
                const float* __restrict__ src_y,
                const float* __restrict__ src_m, float* __restrict__ out_x,
                float* __restrict__ out_y, float* __restrict__ out_m, int S,
                int C, float soft2) {
  __shared__ float4 sh[kTile];  // (x, y, gx, gy) of the group's targets
  const int g = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = c < C;
  const size_t srow = static_cast<size_t>(g) * C;
  const float x = live ? src_x[srow + c] : 0.0f;
  const float y = live ? src_y[srow + c] : 0.0f;
  const float m = live ? src_m[srow + c] : 0.0f;
  const size_t trow = static_cast<size_t>(g) * S;
  double ax = 0.0, ay = 0.0, am = 0.0;
  for (int base = 0; base < S; base += kTile) {
    const int n = min(kTile, S - base);
    __syncthreads();
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      const float2 q = tgt[trow + base + s];
      const float2 gg = gbar[trow + base + s];
      sh[s] = make_float4(q.x, q.y, gg.x, gg.y);
    }
    __syncthreads();
    if (live) {
      for (int s0 = 0; s0 < n; s0 += kRun) {
        const int s1 = min(s0 + kRun, n);
        float rx = 0.0f, ry = 0.0f, rm = 0.0f;
#pragma unroll 4
        for (int s = s0; s < s1; ++s) {
          const float4 q = sh[s];
          float ux, uy, r, t;
          grad_pair(__fsub_rn(x, q.x), __fsub_rn(y, q.y), q.z, q.w, m, soft2,
                    ux, uy, r, t);
          rx = __fadd_rn(rx, ux);
          ry = __fadd_rn(ry, uy);
          rm = __fadd_rn(rm, __fmul_rn(r, t));
        }
        ax = __dadd_rn(ax, static_cast<double>(rx));
        ay = __dadd_rn(ay, static_cast<double>(ry));
        am = __dadd_rn(am, static_cast<double>(rm));
      }
    }
  }
  if (live) {
    out_x[srow + c] = static_cast<float>(ax);
    out_y[srow + c] = static_cast<float>(ay);
    out_m[srow + c] = static_cast<float>(am);
  }
}

int warp_block(int n) { return min(kThreads, (n + 31) / 32 * 32); }

}  // namespace

extern "C" {

// K7a. pos_i f32[Ni,2], g_i f32[Ni,2], pos_j f32[Nj,2], mass_j f32[Nj],
// out f32[Ni,2]; all contiguous on `device`. Launches on `stream` and
// returns cudaGetLastError() (0 on success) without synchronising.
int allpairs_bwd_i_launch(const void* pos_i, const void* g_i,
                          const void* pos_j, const void* mass_j, void* out,
                          int ni, int nj, float softening2, int device,
                          void* stream) {
  if (ni <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  allpairs_bwd_i<<<(ni + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(pos_i), static_cast<const float2*>(g_i),
      static_cast<const float2*>(pos_j), static_cast<const float*>(mass_j),
      static_cast<float2*>(out), ni, nj, softening2);
  return static_cast<int>(cudaGetLastError());
}

// K7b. The inputs of K7a; out_p f32[Nj,2], out_m f32[Nj].
int allpairs_bwd_j_launch(const void* pos_i, const void* g_i,
                          const void* pos_j, const void* mass_j, void* out_p,
                          void* out_m, int ni, int nj, float softening2,
                          int device, void* stream) {
  if (nj <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  allpairs_bwd_j<<<(nj + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(pos_i), static_cast<const float2*>(g_i),
      static_cast<const float2*>(pos_j), static_cast<const float*>(mass_j),
      static_cast<float2*>(out_p), static_cast<float*>(out_m), ni, nj,
      softening2);
  return static_cast<int>(cudaGetLastError());
}

// K8a. tgt f32[G,S,2], gbar f32[G,S,2], src_{x,y,m} f32[G,C], out
// f32[G,S,2]; all contiguous on `device`.
int grouped_bwd_tgt_launch(const void* tgt, const void* gbar,
                           const void* src_x, const void* src_y,
                           const void* src_m, void* out, int G, int S, int C,
                           float softening2, int device, void* stream) {
  if (G <= 0 || S <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = warp_block(S);
  const dim3 grid(G, (S + threads - 1) / threads);
  grouped_bwd_tgt<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(tgt), static_cast<const float2*>(gbar),
      static_cast<const float*>(src_x), static_cast<const float*>(src_y),
      static_cast<const float*>(src_m), static_cast<float2*>(out), S, C,
      softening2);
  return static_cast<int>(cudaGetLastError());
}

// K8b. The inputs of K8a; out_{x,y,m} f32[G,C].
int grouped_bwd_src_launch(const void* tgt, const void* gbar,
                           const void* src_x, const void* src_y,
                           const void* src_m, void* out_x, void* out_y,
                           void* out_m, int G, int S, int C, float softening2,
                           int device, void* stream) {
  if (G <= 0 || C <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = warp_block(C);
  const dim3 grid(G, (C + threads - 1) / threads);
  grouped_bwd_src<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(tgt), static_cast<const float2*>(gbar),
      static_cast<const float*>(src_x), static_cast<const float*>(src_y),
      static_cast<const float*>(src_m), static_cast<float*>(out_x),
      static_cast<float*>(out_y), static_cast<float*>(out_m), S, C,
      softening2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
