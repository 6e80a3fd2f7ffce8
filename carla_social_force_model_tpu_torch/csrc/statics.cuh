// Per-(feature, pedestrian) math of the ORCA wall-feed kernels in
// statics.cu, plain C++ apart from the qualifiers so that the host compiler
// can check it against the plain versions (ops/geometry.py
// feature_closest_planes, closest_point_per_chunk and k_smallest_features).
//
// The candidates' squared distances are those of env_forces.cuh
// (closest_on_segment for a segment feature, closest_update_at or
// argmin_step over a chunk's points), rounded per operation as the plain
// versions compute them, so that both pick the same closest point and the
// same k nearest features.
#pragma once

#include <math.h>

#include "env_forces.cuh"

// The most nearest features a pedestrian keeps (ops/statics.py MAX_K).
constexpr int kTopK = 8;

// The coordinate of padding slots (env/pointsets.py PAD_COORD).
constexpr float kPadCoord = 1e8f;

// A squared filter radius: a feature circle of radius `rad` (negative: an
// empty chunk, never hit) inflated by the neighbour distance, with a
// relative and an absolute margin over the rounding of the circle's centre
// and radius (a skip only has to be conservative: the in-kernel
// d2 <= neigh_dist^2 test decides what is kept).
SFM_HD float feature_reach2(float rad, float nd) {
  if (rad < 0.0f) return -1.0f;
  const float r = rad + nd;
  return r * r * 1.0001f + 1e-3f;
}

// Insert candidate (cd, cx, cy) into the running ascending list d/x/y of
// kTopK slots: it takes the first slot whose distance is strictly larger,
// so it never passes an equal one inserted earlier (a lower feature index),
// and every later slot shifts down one, ties keeping their order -- the
// selection and order of k_smallest_features's first-occurrence
// extractions.  (A compare-swap with strict < all the way down would let a
// displaced entry stop behind an equal later one.)  A padding candidate
// (kPadDist2) never displaces anything.
SFM_HD void topk_insert(float cd, float cx, float cy, float* d, float* x,
                        float* y) {
  bool placed = false;
#pragma unroll
  for (int s = 0; s < kTopK; ++s) {
    const bool swap = placed || cd < d[s];
    placed = swap;
    const float nd = swap ? cd : d[s];
    const float nx = swap ? cx : x[s];
    const float ny = swap ? cy : y[s];
    cd = swap ? d[s] : cd;
    cx = swap ? x[s] : cx;
    cy = swap ? y[s] : cy;
    d[s] = nd;
    x[s] = nx;
    y[s] = ny;
  }
}

// topk_insert into a list of S slots with each candidate's feature index
// ci kept beside it (id; INT_MAX in an empty slot).  One lane of a split
// scan visits its features in ascending index, so its list is ascending in
// (distance, index), and the lanes' lists merge into the sequential list by
// the least (distance, index) (statics.cu seg_topk_kernel).
template <int S>
SFM_HD void topk_insert_at(float cd, float cx, float cy, int ci, float* d,
                           float* x, float* y, int* id) {
  bool placed = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool swap = placed || cd < d[s];
    placed = swap;
    const float nd = swap ? cd : d[s];
    const float nx = swap ? cx : x[s];
    const float ny = swap ? cy : y[s];
    const int ni = swap ? ci : id[s];
    cd = swap ? d[s] : cd;
    cx = swap ? x[s] : cx;
    cy = swap ? y[s] : cy;
    ci = swap ? id[s] : ci;
    d[s] = nd;
    x[s] = nx;
    y[s] = ny;
    id[s] = ni;
  }
}
