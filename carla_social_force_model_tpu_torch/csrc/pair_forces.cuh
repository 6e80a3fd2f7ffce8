// The pair laws of the kernels in pair_forces.cu, for one (pedestrian,
// partner) pair: the Moussaid et al. (2009) force, the Karamouzas et al.
// (2014) time-to-collision power law and the Helbing-Molnar (1995) ellipse.
//
// Moussaid: the math, masks and zero-guards are those of the plain version,
// ops/forces.py::_moussaid_pair_force (and of the JAX package's
// ops/forces.py:76-113), so that
//   * a pair with d2 == 0 (self pair, coincident agents) gives exactly 0;
//   * a vanishing interaction vector (t2 == 0, so B == 0) gives exactly 0 --
//     with radii subtracted d can be negative there, and -d/B would be +inf;
//   * sign(theta) is exactly 0 at theta == 0, so epsilon = 0 produces no
//     tangential force for equal-velocity pairs;
//   * masked pairs select 0 instead of multiplying, so an inf or NaN inside a
//     masked pair never leaks into the sum.
// Plain C++ apart from the qualifiers, so the host compiler can check it too.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SFM_HD __host__ __device__ __forceinline__
#define SFM_RSQRT(v) rsqrtf(v)
#else
#define SFM_HD inline
#define SFM_RSQRT(v) (1.0f / sqrtf(v))
#endif

// (the intrinsics exist in device code only: the host pass of nvcc and the
// host compiler take the plain operators)
#ifdef __CUDA_ARCH__
#define SFM_MUL_RN(a, b) __fmul_rn(a, b)
#define SFM_ADD_RN(a, b) __fadd_rn(a, b)
#define SFM_SUB_RN(a, b) __fsub_rn(a, b)
#define SFM_DIV_RN(a, b) __fdiv_rn(a, b)
#define SFM_SQRT_RN(a) __fsqrt_rn(a)
#else
#define SFM_MUL_RN(a, b) ((a) * (b))
#define SFM_ADD_RN(a, b) ((a) + (b))
#define SFM_SUB_RN(a, b) ((a) - (b))
#define SFM_DIV_RN(a, b) ((a) / (b))
#define SFM_SQRT_RN(a) sqrtf(a)
#endif

// dx*dx + dy*dy, each operation rounded (no contraction).  Every squared
// distance that decides something -- a pair within the cutoff, a box test,
// a closest point -- is taken so: nvcc would otherwise contract it into one
// FMA, which the plain version's separate PyTorch multiplications and
// addition never do, and a pair at the boundary would then be in on one
// side and out on the other.
SFM_HD float sq_norm_rn(float dx, float dy) {
  return SFM_ADD_RN(SFM_MUL_RN(dx, dx), SFM_MUL_RN(dy, dy));
}

// Squared gap between a row box and a column box, each [min_x, max_x,
// min_y, max_y] over alive agents (ops/pair_grid.py _bbox_hits).  It never
// exceeds sq_norm_rn of any (row, column) pair of the two boxes: max,
// subtraction and rounding are monotonic, and fl(a - b) = -fl(b - a).  So
// a tile pair whose gap exceeds the squared cutoff holds no pair within
// it.  An empty box is (+inf, -inf, +inf, -inf): its gap is +inf.
SFM_HD float box_gap2(float rx0, float rx1, float ry0, float ry1, float cx0,
                      float cx1, float cy0, float cy1) {
  const float gx = fmaxf(fmaxf(cx0 - rx1, rx0 - cx1), 0.0f);
  const float gy = fmaxf(fmaxf(cy0 - ry1, ry0 - cy1), 0.0f);
  return sq_norm_rn(gx, gy);
}

struct MoussaidPrm {
  float lam, A, gamma, n, n_prime, eps;
};

// Force on the pedestrian from its partner.  (dx, dy) = x_partner - x_ped,
// (dvx, dvy) = v_ped - v_partner, rsub = radii to subtract (0 when radii are
// off), ok_in = liveness and pair mask.
SFM_HD void moussaid_pair(float dx, float dy, float dvx, float dvy, float rsub,
                          bool ok_in, const MoussaidPrm& p, float& fx,
                          float& fy) {
  const float d2 = dx * dx + dy * dy;
  const float r = SFM_RSQRT(d2 == 0.0f ? 1.0f : d2);
  const float ex = dx * r;  // zero-safe unit vector toward the partner
  const float ey = dy * r;
  const float d = d2 * r - rsub;

  const float tx = p.lam * dvx + ex;
  const float ty = p.lam * dvy + ey;
  const float t2 = tx * tx + ty * ty;
  const float rt = SFM_RSQRT(t2 == 0.0f ? 1.0f : t2);
  const float thx = tx * rt;
  const float thy = ty * rt;
  const float t_len = t2 * rt;

  const float B = p.gamma * t_len;
  const bool ok = ok_in && (B > 0.0f) && (d2 > 0.0f);

  // signed angle from t_hat to e as one atan2 of (cross, dot)
  const float cross = ok ? thx * ey - thy * ex : 0.0f;
  const float dot = ok ? ex * thx + ey * thy : 1.0f;
  const float theta = atan2f(cross, dot) + B * (-p.eps);
  const float common = -d / (ok ? B : 1.0f);
  const float Bt = B * theta;
  const float wv = p.n_prime * Bt;
  const float wt = p.n * Bt;
  const float f_v = -p.A * expf(common - wv * wv);
  const float sgn = (float)((theta > 0.0f) - (theta < 0.0f));
  const float f_t = -p.A * sgn * expf(common - wt * wt);
  // f = f_v * t_hat + f_t * left_normal(t_hat)
  fx = ok ? f_v * thx - f_t * thy : 0.0f;
  fy = ok ? f_v * thy + f_t * thx : 0.0f;
}

// Karamouzas et al. (2014) time-to-collision power law: the plain version is
// ops/forces.py::_powerlaw_pair_force (the JAX package's forces.py:231-270).
// With x = x_ped - x_partner, v = v_ped - v_partner, R the summed disc radii,
// a = v.v, b = x.v, c = x.x - R^2 and D = b^2 - a*c, the time to collision
// is tau = (-b - sqrt(D)) / a.  A pair contributes only on a collision
// course: c > 0, D > 0, a > 1e-8 and 0 < tau < tau_max, with tau then
// clipped to [tau_min, tau_max].  These gates are hard thresholds, and near
// c = 0 or D = 0 the force is singular, so every value a gate reads is
// rounded after each operation (no FMA contraction) and the root and the
// division are the correctly rounded ones, as the plain version's separate
// PyTorch operations compute them: both sides decide every gate alike.  The
// law is antisymmetric sign-exactly (a, b, c, D and tau are unchanged by the
// swap, the force vector negates), so the Newton's-third-law kernels apply.
struct PowerLawPrm {
  float k, tau0, tau_max, tau_min;
};

// Force on the pedestrian from its partner.  (dx, dy) = x_partner - x_ped,
// (dvx, dvy) = v_ped - v_partner, rsum = the summed radii, ok_in =
// liveness and pair mask.
SFM_HD void powerlaw_pair(float dx, float dy, float dvx, float dvy,
                          float rsum, bool ok_in, const PowerLawPrm& p,
                          float& fx, float& fy) {
  const float xx = -dx;  // x = x_ped - x_partner
  const float xy = -dy;
  const float a = sq_norm_rn(dvx, dvy);
  const float b = SFM_ADD_RN(SFM_MUL_RN(xx, dvx), SFM_MUL_RN(xy, dvy));
  const float c = SFM_SUB_RN(sq_norm_rn(xx, xy), SFM_MUL_RN(rsum, rsum));
  const float disc = SFM_SUB_RN(SFM_MUL_RN(b, b), SFM_MUL_RN(a, c));
  bool ok = ok_in && (c > 0.0f) && (disc > 0.0f) && (a > 1e-8f);
  const float a_s = ok ? a : 1.0f;
  const float s = SFM_SQRT_RN(ok ? disc : 1.0f);
  float tau = SFM_DIV_RN(-b - s, a_s);
  ok = ok && (tau > 0.0f) && (tau < p.tau_max);
  tau = fminf(fmaxf(tau, p.tau_min), p.tau_max);
  const float mag = p.k * expf(-tau / p.tau0) * (2.0f / tau + 1.0f / p.tau0) /
                    (tau * tau);
  const float scale = mag / (a_s * s);
  const float sb = s + b;
  fx = ok ? scale * (a * xx - sb * dvx) : 0.0f;
  fy = ok ? scale * (a * xy - sb * dvy) : 0.0f;
}

// Helbing-Molnar (1995) elliptical repulsion with field-of-view weight: the
// plain version is ops/forces.py::_helbing_pair_force (the JAX package's
// forces.py:365-408).  V(b) = v0*exp(-b/sigma), 2b the minor axis of the
// ellipse through the pedestrian around the partner and its anticipated
// step y = step_width * v_partner; the force is -grad V, weighted by
// fov_factor when the partner lies outside the pedestrian's +-phi field of
// view around its desired direction e.  Pairs with b == 0 or a vanishing
// |d| or |d - y| give exactly 0, and b is floored at b_min (the equal-speed
// follower's b -> 0).  The ellipse gates and the field-of-view test are
// thresholds: every value they read is rounded after each operation, with
// correctly rounded roots and divisions, as the plain version computes
// them.  The law reads neither radii nor the pedestrian's own velocity, and
// it is not antisymmetric: only the dense kernels take it.
struct HelbingPrm {
  float v0, sigma, cos_phi, fov_factor, step_width, b_min;
};

// Force on the pedestrian from its partner.  (dx, dy) = x_partner - x_ped,
// (vxj, vyj) = v_partner, (ex, ey) = the pedestrian's unit desired
// direction, ok_in = liveness and pair mask.
SFM_HD void helbing_pair(float dx, float dy, float vxj, float vyj, float ex,
                         float ey, bool ok_in, const HelbingPrm& p, float& fx,
                         float& fy) {
  const float ddx = -dx;  // d = x_ped - x_partner
  const float ddy = -dy;
  const float yx = SFM_MUL_RN(p.step_width, vxj);
  const float yy = SFM_MUL_RN(p.step_width, vyj);
  const float mx = SFM_SUB_RN(ddx, yx);  // d - y
  const float my = SFM_SUB_RN(ddy, yy);
  const float nd = SFM_SQRT_RN(sq_norm_rn(ddx, ddy));
  const float nm = SFM_SQRT_RN(sq_norm_rn(mx, my));
  const float s = SFM_ADD_RN(nd, nm);
  const float y2 = sq_norm_rn(yx, yy);
  const float b2 =
      SFM_MUL_RN(fmaxf(SFM_SUB_RN(SFM_MUL_RN(s, s), y2), 0.0f), 0.25f);
  const float b = SFM_SQRT_RN(b2);
  const bool ok = ok_in && (b > 0.0f) && (nd > 0.0f) && (nm > 0.0f);
  const float nd_s = nd == 0.0f ? 1.0f : nd;
  const float nm_s = nm == 0.0f ? 1.0f : nm;
  const float b_s = fmaxf(ok ? b : 1.0f, p.b_min);
  const float g = SFM_DIV_RN(s, SFM_MUL_RN(4.0f, b_s));
  const float e = SFM_MUL_RN(SFM_DIV_RN(p.v0, p.sigma),
                             expf(SFM_DIV_RN(-b_s, p.sigma)));
  const float f_x = SFM_MUL_RN(
      e, SFM_MUL_RN(g, SFM_ADD_RN(SFM_DIV_RN(ddx, nd_s),
                                  SFM_DIV_RN(mx, nm_s))));
  const float f_y = SFM_MUL_RN(
      e, SFM_MUL_RN(g, SFM_ADD_RN(SFM_DIV_RN(ddy, nd_s),
                                  SFM_DIV_RN(my, nm_s))));
  // field of view (Helbing eq. 7): -f points from the pedestrian toward
  // the source
  const float tx = -f_x;
  const float ty = -f_y;
  const bool seen =
      SFM_ADD_RN(SFM_MUL_RN(ex, tx), SFM_MUL_RN(ey, ty)) >=
      SFM_MUL_RN(SFM_SQRT_RN(sq_norm_rn(tx, ty)), p.cos_phi);
  const float w = seen ? 1.0f : p.fov_factor;
  fx = ok ? w * f_x : 0.0f;
  fy = ok ? w * f_y : 0.0f;
}
