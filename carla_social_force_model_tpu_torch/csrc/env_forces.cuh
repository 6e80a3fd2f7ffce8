// Per-(segment, pedestrian) math of the environment kernels in
// env_forces.cu, plain C++ apart from the qualifiers so that the host
// compiler can check it against the plain version (ops/forces.py
// env_exp_force / env_moussaid_force).
//
// The squared distances that decide something -- which sampled point is the
// closest, whether a pedestrian is inside a segment's filter circle, whether
// a segment's circle touches a block's box -- are rounded after every
// operation (__fmul_rn / __fadd_rn).  nvcc would otherwise contract
// dx*dx + dy*dy into one FMA, which the plain version's separate PyTorch
// multiplications and addition never do; two points equidistant to an ulp
// would then be picked differently, and near a wall the force direction
// would differ by up to (point spacing)/d radians.  With the rounding kept,
// the kernel selects the same point and the same filter outcome as the
// plain version on the same inputs.  (The rounding macros and sq_norm_rn
// live in pair_forces.cuh.)
#pragma once

#include <math.h>

#include "pair_forces.cuh"

// squared distances at or above this are padding (PAD_COORD = 1e8), not a
// closest point: ops/forces.py PAD_DIST2
constexpr float kPadDist2 = 1e13f;

// One step of the first-occurrence argmin over a segment's points for one
// lane of a split scan: the lane takes every L-th slot in ascending order
// and keeps, with strict <, its earliest least distance and that slot j
// (bj), so that the lanes' results merge into the sequential scan's (the
// reference's np.argmin) by the least (distance, slot) (env_forces.cu).
SFM_HD void closest_update_at(float ptx, float pty, float px, float py,
                              int j, float& best, int& bj, float& bx,
                              float& by) {
  const float d2 = sq_norm_rn(ptx - px, pty - py);
  if (d2 < best) {
    best = d2;
    bj = j;
    bx = ptx;
    by = pty;
  }
}

// The closest point ON the segment a + t*u to the pedestrian (the analytic
// border tier and the ORCA segment features; ops/geometry.py
// closest_on_segments): t = clip(((p - a) . u) * il2, 0, 1), c = a + t*u,
// every operation that decides the argmin rounded on its own, the clamp as
// torch.clamp (min, then max).  A padding segment (a at PAD_COORD,
// u = il2 = 0) lands on the PAD sentinel; a single point (u = il2 = 0) on
// itself.
SFM_HD float closest_on_segment(float ax, float ay, float ux, float uy,
                                float il2, float px, float py, float& cx,
                                float& cy) {
  const float dxa = px - ax;
  const float dya = py - ay;
  float t = SFM_MUL_RN(SFM_ADD_RN(SFM_MUL_RN(dxa, ux), SFM_MUL_RN(dya, uy)),
                       il2);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  cx = SFM_ADD_RN(ax, SFM_MUL_RN(t, ux));
  cy = SFM_ADD_RN(ay, SFM_MUL_RN(t, uy));
  return sq_norm_rn(px - cx, py - cy);
}

// One step of the first-occurrence argmin over a section's segments, in
// ascending order, keeping the winning segment j (as closest_update_at).
SFM_HD void closest_seg_update(float ax, float ay, float ux, float uy,
                               float il2, float px, float py, int j,
                               float& best, int& bj, float& bx, float& by) {
  float cx, cy;
  const float d2 = closest_on_segment(ax, ay, ux, uy, il2, px, py, cx, cy);
  if (d2 < best) {
    best = d2;
    bj = j;
    bx = cx;
    by = cy;
  }
}

// |center - ped|^2 < r2, the segment filter (ops/geometry.py
// segment_filter_mask); inactive or padded segments carry r2 = -1.
SFM_HD bool in_filter(float cx, float cy, float r2, float px, float py) {
  return sq_norm_rn(cx - px, cy - py) < r2;
}

// The exp-magnitude term of one (segment, ped) pair: a * exp(-d/b) along
// the unit vector from the closest point (bx, by) to the pedestrian, with
// d = |ped - point| - rsub.  A pedestrian on the point gets 0 (its
// direction vector is 0); a masked pair selects 0.
SFM_HD void exp_term(float px, float py, float bx, float by, float rsub,
                     float a, float b, bool ok, float& fx, float& fy) {
  const float dx = px - bx;
  const float dy = py - by;
  const float d2 = sq_norm_rn(dx, dy);
  const float r = SFM_RSQRT(d2 == 0.0f ? 1.0f : d2);
  const float d = SFM_ADD_RN(SFM_MUL_RN(d2, r), -rsub);
  const float mag = ok ? SFM_MUL_RN(a * expf(-d / b), r) : 0.0f;
  fx = SFM_MUL_RN(mag, dx);
  fy = SFM_MUL_RN(mag, dy);
}
