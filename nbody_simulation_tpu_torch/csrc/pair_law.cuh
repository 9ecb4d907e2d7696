// The reference pair law on the device, shared by every kernel of csrc/.
//
// The reference's interaction (reference src/main.rs:234-253) is
//   a_i += m_j * d / (|d|_1 * max(|d|_2^2, softening2)),  d = p_j - p_i,
// skipped when |d|_1 is not a normal float. These forms are used:
//   mono_pair  the ordered law of mono_tile (nbody_simulation_tpu/ops/
//              allpairs.py:52-100): K1 and the Barnes-Hut sweep (K3/K5),
//              whose tiles within a coordinate bound take its bitwise-equal
//              form mono_pair_bounded;
//   quad_den,  monopole plus quadrupole correction of _quad_tile
//   quad_rcp,  (nbody_simulation_tpu/ops/traversal.py:149-207) in three
//   quad_terms steps: K4;
//   sym_den,   the shared pair kernel k(d) of _sym_r (allpairs.py:103-137),
//   sym_k      in two steps: K2 and K9 apply m_j*d*k to i and -m_i*d*k to j;
//   pot_term   the counterpart potential of pot_tile (nbody_simulation_tpu/
//              ops/energy.py:46-56): K6;
//   grad_pair  the backward law of _pair_terms + _u_terms (nbody_simulation_
//              tpu/ops/allpairs_grad.py:39-68): K7 and K8, always rcp.approx
//              plus one Newton step (the rcp modes below do not apply).
// The forward forms come in the five rcp modes of config.RCP_MODES:
//   0 exact         IEEE division
//   1 newton        rcp.approx.f32 plus one Newton step
//   2 approx        rcp.approx.f32 alone
//   3 newton+clamp  as 1, max(s, L1_CLAMP) in place of the is_normal mask
//   4 approx+clamp  as 2, likewise
// Every arithmetic step is an explicit round-to-nearest intrinsic so nvcc
// contracts nothing into an FMA: the terms follow the JAX package's
// operation order. rcp.approx.f32 is the non-.ftz form, because the
// s >= FLT_MIN_NORMAL guard assumes subnormal denominators are not flushed;
// a kernel takes the .ftz form only where it is bitwise the same (a warp
// vote on rcp_in_range in K2 and K9, a bound on the coordinates in K4, and
// in K3 mono_pair_bounded under the bound of grouped_sweep.cu).
// K6's root is rsqrt.approx (rsqrt_approx).
// Every max is max_nan, which returns NaN when an operand is NaN, as
// jnp.maximum does (fmaxf returns the other operand): under +clamp a
// non-finite position then propagates as NaN, as the JAX kernels document.
// Build without --use_fast_math.

#pragma once

#include <cuda_runtime.h>

namespace pair_law {

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

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ bool is_normal(float s) {
  return (s >= kFltMinNormal) && (s <= kFltMax);
}

// The mask's test where |d|_1 is known to be finite or NaN: a BOUNDED
// caller has proved s <= FLT_MAX for every pair it evaluates (every
// coordinate within a bound, checked per staged tile), so s >= FLT_MIN_
// NORMAL alone is is_normal(s), NaN included.
template <bool BOUNDED>
__device__ __forceinline__ bool pair_counts(float s) {
  return BOUNDED ? s >= kFltMinNormal : is_normal(s);
}

// rcp.approx.f32 (the non-.ftz form) scales a denominator outside [2^-126,
// 2^126] before and after the hardware reciprocal, which costs each call a
// range test and two multiplies; inside that range it is the hardware
// reciprocal alone, which is what rcp.approx.ftz.f32 gives there. So where
// every x of a warp lies in the range (rcp_in_range), rcp_approx_ftz(x) is
// bitwise rcp_approx(x) at a third of the instructions.
__device__ __forceinline__ bool rcp_in_range(float x) {
  const float a = fabsf(x);
  return a >= kFltMinNormal && a <= 0x1p126f;  // false for NaN
}

__device__ __forceinline__ float rcp_approx_ftz(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Ordered law: the contribution (cx, cy) of one source (displacement dx, dy;
// mass m). `exact` is pair_accel's numerator-first division; the other
// modes multiply by the reciprocal, as mono_tile does.
template <int MODE>
__device__ __forceinline__ void mono_pair(float dx, float dy, float m,
                                          float soft2, float& cx, float& cy) {
  const float s = __fadd_rn(fabsf(dx), fabsf(dy));
  const float d2 =
      max_nan(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), soft2);
  if (MODE == kExact) {
    // pair_accel: is_normal mask, dead lanes divide by 1, select 0.
    const bool normal = is_normal(s);
    const float den = normal ? __fmul_rn(s, d2) : 1.0f;
    cx = normal ? __fdiv_rn(__fmul_rn(dx, m), den) : 0.0f;
    cy = normal ? __fdiv_rn(__fmul_rn(dy, m), den) : 0.0f;
  } else {
    float den, r;
    if (MODE == kNewtonClamp || MODE == kApproxClamp) {
      den = __fmul_rn(max_nan(s, kL1Clamp), d2);
      r = rcp_approx(den);
      if (MODE == kNewtonClamp)
        r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(den, r)));
    } else {
      const bool normal = is_normal(s);
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
}

// mono_pair where the caller has proved, for every pair it evaluates, that
// |d|_1 is 0 or lies in [2^-87, 2^42], that |d|_2^2 <= 2^83, that eps lies
// in [2^-39, 2^83] and that m is finite (K3 checks a bound on the
// coordinates and masses per staged tile, grouped_sweep.cu). Then the
// denominator of every pair with s != 0 lies in [2^-126, 2^125], where
// rcp.approx.ftz.f32 is bitwise rcp_approx, and is_normal(s) is s >=
// FLT_MIN_NORMAL. Returns whether the pair counts; the caller adds (cx, cy)
// only then. Where mono_pair masks a pair it gives dx * (m * 0) (or 0 in
// `exact`), which is +-0 for a finite m and dx, and a run sum that starts
// at +0 is never -0, so skipping that add is bitwise adding it. In the
// +clamp modes every pair counts, as in mono_pair.
template <int MODE>
__device__ __forceinline__ bool mono_pair_bounded(float dx, float dy, float m,
                                                  float soft2, float& cx,
                                                  float& cy) {
  const float s = __fadd_rn(fabsf(dx), fabsf(dy));
  const float d2 =
      max_nan(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), soft2);
  if (MODE == kExact) {
    const float den = __fmul_rn(s, d2);
    cx = __fdiv_rn(__fmul_rn(dx, m), den);
    cy = __fdiv_rn(__fmul_rn(dy, m), den);
    return s >= kFltMinNormal;
  }
  constexpr bool kClamp = MODE == kNewtonClamp || MODE == kApproxClamp;
  const float den = __fmul_rn(kClamp ? max_nan(s, kL1Clamp) : s, d2);
  float r = rcp_approx_ftz(den);
  if (MODE == kNewton || MODE == kNewtonClamp)
    r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(den, r)));
  const float w = __fmul_rn(m, r);
  cx = __fmul_rn(dx, w);
  cy = __fmul_rn(dy, w);
  return kClamp || s >= kFltMinNormal;
}

// Monopole + quadrupole law: the contribution (cx, cy) of a source node
// with mass m and second moments (qxx, qxy, qyy) about its COM, displaced
// by (dx, dy): d*m*g(d) + 1/2 Q : grad grad f(d), with g = 1/(|d|_1 |d|_2^2)
// and f = d*g, in _quad_tile's operation order. It takes two reciprocals,
// a = 1/s and b = 1/d2: IEEE divisions in `exact`; elsewhere rcp.approx of
// each (2 MUFU), with one Newton step each in the newton modes. The "+clamp"
// suffix is ignored (the correction carries no dx or dy factor, so a clamp
// would turn a coincident COM into a huge finite force): the clamp modes run
// as their base mode, with the is_normal mask. The correction is computed
// for every pair, Q = 0 included, so that where a^3 b overflows 0 * inf
// gives NaN as the JAX kernel does; it does not scale with m.
//
// In three steps: quad_den gives s = |d|_1 and d2 = max(|d|_2^2, eps);
// quad_rcp<MODE, FAST> the reciprocals a and b; quad_terms<FAST> the rest.
// FAST is for a caller that has proved every d2 in [2^-126, 2^126] and s
// <= 2^126 (K4 checks a bound on the coordinates per staged tile): then
// rcp.approx.ftz.f32 is bitwise rcp_approx for every pair that the mask
// keeps (a normal s >= 2^-126; a pair whose s is not normal is selected to
// 0 whatever a and b are), and the mask is pair_counts<true>.
__device__ __forceinline__ void quad_den(float dx, float dy, float soft2,
                                         float& s, float& d2) {
  s = __fadd_rn(fabsf(dx), fabsf(dy));
  d2 = max_nan(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), soft2);
}

template <int MODE, bool FAST>
__device__ __forceinline__ void quad_rcp(float s, float d2, float& a,
                                         float& b) {
  if (MODE == kExact) {
    a = __fdiv_rn(1.0f, s);
    b = __fdiv_rn(1.0f, d2);
    return;
  }
  a = FAST ? rcp_approx_ftz(s) : rcp_approx(s);
  b = FAST ? rcp_approx_ftz(d2) : rcp_approx(d2);
  if (MODE == kNewton || MODE == kNewtonClamp) {
    a = __fmul_rn(a, __fsub_rn(2.0f, __fmul_rn(s, a)));
    b = __fmul_rn(b, __fsub_rn(2.0f, __fmul_rn(d2, b)));
  }
}

template <bool FAST>
__device__ __forceinline__ void quad_terms(float dx, float dy, float s,
                                           float a, float b, float m,
                                           float qxx, float qxy, float qyy,
                                           float& cx, float& cy) {
  const float adx = fabsf(dx);
  const float ady = fabsf(dy);
  const bool normal = pair_counts<FAST>(s);
  const float ab = __fmul_rn(a, b);
  const float w = __fmul_rn(m, ab);
  const float sx = dx >= 0.0f ? 1.0f : -1.0f;
  const float sy = dy >= 0.0f ? 1.0f : -1.0f;
  const float a2b = __fmul_rn(a, ab);
  const float ab2 = __fmul_rn(b, ab);
  const float a3b = __fmul_rn(a, a2b);
  const float a2b2 = __fmul_rn(b, a2b);
  const float ab3 = __fmul_rn(b, ab2);
  const float dx2 = __fmul_rn(2.0f, dx);
  const float dy2 = __fmul_rn(2.0f, dy);
  const float dx8 = __fmul_rn(8.0f, dx);
  const float dy8 = __fmul_rn(8.0f, dy);
  // g_x, g_y and g_xx, g_yy, g_xy of g(d).
  const float gx = -__fadd_rn(__fmul_rn(sx, a2b), __fmul_rn(dx2, ab2));
  const float gy = -__fadd_rn(__fmul_rn(sy, a2b), __fmul_rn(dy2, ab2));
  const float t1 = __fmul_rn(2.0f, a3b);
  const float t2 = __fmul_rn(2.0f, ab2);
  const float gxx = __fadd_rn(
      __fsub_rn(__fadd_rn(t1, __fmul_rn(__fmul_rn(4.0f, adx), a2b2)), t2),
      __fmul_rn(__fmul_rn(dx8, dx), ab3));
  const float gyy = __fadd_rn(
      __fsub_rn(__fadd_rn(t1, __fmul_rn(__fmul_rn(4.0f, ady), a2b2)), t2),
      __fmul_rn(__fmul_rn(dy8, dy), ab3));
  const float gxy = __fadd_rn(
      __fadd_rn(
          __fmul_rn(__fmul_rn(__fmul_rn(2.0f, sx), sy), a3b),
          __fmul_rn(__fmul_rn(2.0f, __fadd_rn(__fmul_rn(sx, dy),
                                              __fmul_rn(sy, dx))),
                    a2b2)),
      __fmul_rn(__fmul_rn(dx8, dy), ab3));
  const float corr_x = __fmul_rn(
      0.5f,
      __fadd_rn(
          __fadd_rn(
              __fmul_rn(__fadd_rn(__fmul_rn(2.0f, gx), __fmul_rn(dx, gxx)),
                        qxx),
              __fmul_rn(__fmul_rn(2.0f, __fadd_rn(gy, __fmul_rn(dx, gxy))),
                        qxy)),
          __fmul_rn(__fmul_rn(dx, gyy), qyy)));
  const float corr_y = __fmul_rn(
      0.5f,
      __fadd_rn(
          __fadd_rn(
              __fmul_rn(__fmul_rn(dy, gxx), qxx),
              __fmul_rn(__fmul_rn(2.0f, __fadd_rn(gx, __fmul_rn(dy, gxy))),
                        qxy)),
          __fmul_rn(__fadd_rn(__fmul_rn(2.0f, gy), __fmul_rn(dy, gyy)),
                    qyy)));
  cx = normal ? __fadd_rn(__fmul_rn(dx, w), corr_x) : 0.0f;
  cy = normal ? __fadd_rn(__fmul_rn(dy, w), corr_y) : 0.0f;
}

// Symmetric pair kernel k(d) = 1/(|d|_1 * max(|d|_2^2, eps)), 0 where the
// mask guard drops the pair, in two steps so that a caller can take the
// reciprocals of several pairs together (rcp_in_range). sym_den
// gives s = |d|_1 and the denominator: s * max(d2, eps), max(s, clamp) *
// max(d2, eps) under +clamp, and in `exact` 1 where the mask drops the pair.
// sym_k finishes k from s, the denominator and, outside `exact`, its
// rcp.approx r: the Newton step in the newton modes, then the mask. `exact`
// is 1/den, then the caller multiplies: not pair_accel's numerator-first
// order (<= 2 ulp apart, as _sym_r says); the JAX order is kept. A masked
// pair gives k = 0, and the caller's d * (m * k) is then NaN where d is NaN:
// the JAX kernel's NaN pattern.
template <int MODE>
__device__ __forceinline__ float sym_den(float dx, float dy, float soft2,
                                         float& s) {
  s = __fadd_rn(fabsf(dx), fabsf(dy));
  const float d2 =
      max_nan(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), soft2);
  if (MODE == kNewtonClamp || MODE == kApproxClamp)
    return __fmul_rn(max_nan(s, kL1Clamp), d2);
  if (MODE == kExact) return is_normal(s) ? __fmul_rn(s, d2) : 1.0f;
  return __fmul_rn(s, d2);
}

template <int MODE>
__device__ __forceinline__ float sym_k(float s, float den, float r) {
  if (MODE == kExact) {
    const float q = __fdiv_rn(1.0f, den);
    return is_normal(s) ? q : 0.0f;
  }
  if (MODE == kNewton || MODE == kNewtonClamp)
    r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(den, r)));
  if (MODE == kNewtonClamp || MODE == kApproxClamp) return r;
  return is_normal(s) ? r : 0.0f;
}

// rsqrt.approx.f32, one MUFU.RSQ (relative error below 2^-22.9, PTX ISA),
// as the TPU kernel's lax.rsqrt is its chip's hardware approximation. FTZ
// takes the .ftz form, which is the same result for every normal x and
// skips the non-.ftz form's scaling of a subnormal x: the potential's x is
// max(d2, eps), normal whenever eps >= FLT_MIN_NORMAL (or NaN or inf, where
// both forms agree), so the host picks FTZ from eps.
template <bool FTZ>
__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  if (FTZ)
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  else
    asm("rsqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Counterpart potential term phi = -m / sqrt(max(r^2, eps)) of pot_tile;
// returns whether the pair counts (|d|_1 a normal float; BOUNDED as
// pair_counts). A caller adds phi only where it counts, which is the same
// sum as adding pot_tile's 0: a running sum that starts at +0 is never -0,
// and r + 0 = r. Every term has the sign of -m, so the approximate root's
// relative error bounds that of the sum's terms.
template <bool FTZ, bool BOUNDED>
__device__ __forceinline__ bool pot_term(float dx, float dy, float m,
                                         float soft2, float& phi) {
  const float s = __fadd_rn(fabsf(dx), fabsf(dy));
  const float d2 =
      max_nan(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), soft2);
  phi = __fmul_rn(-m, rsqrt_approx<FTZ>(d2));
  return pair_counts<BOUNDED>(s);
}

// Backward law: one pair's share of the vector-Jacobian product of the
// ordered force c = m * d * r, r = 1/(s * q), s = |d|_1, q = max(|d|_2^2,
// eps), for the target's cotangent g:
//   t  = d . g
//   u  = m*r*g - (m*r^2*t) * (psign(d)*q + 2*s*kappa*d),  kappa = [d2 > eps]
// u is the cotangent of d = p_src - p_tgt (the source gets +u, the target
// -u) and r*t that of the source mass. psign(x) is +1 at x == 0, the JAX
// subgradient of |x| (select(x >= 0, 1, -1)); kappa is strict, so at
// d2 == eps the clamp's branch is the constant one. The reciprocal is
// rcp.approx plus one Newton step, whatever the forward's mode, as the JAX
// backward runs on its chip; a masked pair (|d|_1 not a normal float) gets
// r = 0. Every product is computed, never branched on: where r*r overflows
// or d is not finite, 0 * inf gives NaN as in the JAX kernels. The operation
// order is _u_terms': (m*r)*g, (m*(r*r))*t, (2*s)*kappa.
__device__ __forceinline__ void grad_pair(float dx, float dy, float gx,
                                          float gy, float m, float soft2,
                                          float& ux, float& uy, float& r,
                                          float& t) {
  const float s = __fadd_rn(fabsf(dx), fabsf(dy));
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float kappa = d2 > soft2 ? 1.0f : 0.0f;
  const float q = max_nan(d2, soft2);
  const float den = __fmul_rn(s, q);
  float rr = rcp_approx(den);
  rr = __fmul_rn(rr, __fsub_rn(2.0f, __fmul_rn(den, rr)));
  r = is_normal(s) ? rr : 0.0f;
  t = __fadd_rn(__fmul_rn(dx, gx), __fmul_rn(dy, gy));
  const float mr = __fmul_rn(m, r);
  const float mr2t = __fmul_rn(__fmul_rn(m, __fmul_rn(r, r)), t);
  const float two_sk = __fmul_rn(__fmul_rn(2.0f, s), kappa);
  const float px = dx >= 0.0f ? 1.0f : -1.0f;
  const float py = dy >= 0.0f ? 1.0f : -1.0f;
  ux = __fsub_rn(__fmul_rn(mr, gx),
                 __fmul_rn(mr2t, __fadd_rn(__fmul_rn(px, q),
                                           __fmul_rn(two_sk, dx))));
  uy = __fsub_rn(__fmul_rn(mr, gy),
                 __fmul_rn(mr2t, __fadd_rn(__fmul_rn(py, q),
                                           __fmul_rn(two_sk, dy))));
}

}  // namespace pair_law
