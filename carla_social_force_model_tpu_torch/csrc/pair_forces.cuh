// Moussaid et al. (2009) pair force for one (pedestrian, partner) pair.
//
// Shared by the kernels in pair_forces.cu.  The math, masks and zero-guards
// are those of the plain version, ops/forces.py::_moussaid_pair_force (and of
// the JAX package's ops/forces.py:76-113), so that
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
#else
#define SFM_MUL_RN(a, b) ((a) * (b))
#define SFM_ADD_RN(a, b) ((a) + (b))
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
