// The pair laws as the pair kernels instantiate them, the tile-box test and
// the law ids of the C entries, shared by pair_forces.cu and ring.cu.
// Device code: included by .cu files only (the per-pair math itself is in
// pair_forces.cuh, which the host compiler checks too).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_box.cuh"
#include "pair_forces.cuh"

// The law ids of the C entries (ops/cuda_forces.py LAW_IDS).
enum LawId { kLawMoussaid = 0, kLawPowerLaw = 1, kLawHelbing = 2 };

// Each law reads its parameter vector (models/params.py *_vector), says
// whether it reads radii and whether it is antisymmetric, and evaluates one
// pair from the row's position and velocity slots (u, v) and the column's
// position, velocity (cu, cv) and radius.  The row slots hold v_i, except
// for Helbing, whose row planes carry the row's desired direction e_i there.
// pair<true> is the walks' call: the Moussaid law's fast tail
// (pair_forces.cuh); the other laws have one form.
struct Moussaid {
  using Prm = MoussaidPrm;
  static constexpr bool kRadius = true;
  static constexpr bool kAntisymmetric = true;
  static __device__ __forceinline__ Prm load(const float* __restrict__ prm) {
    return Prm{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5]};
  }
  template <bool kFast = false>
  static __device__ __forceinline__ void pair(float dx, float dy, float u,
                                              float v, float cu, float cv,
                                              float ri, float rj,
                                              int use_radius, bool ok,
                                              const Prm& p, float& fx,
                                              float& fy) {
    const float rsub = use_radius ? ri + rj : 0.0f;
    moussaid_pair<kFast>(dx, dy, u - cu, v - cv, rsub, ok, p, fx, fy);
  }
};

struct PowerLaw {  // disc radii always participate
  using Prm = PowerLawPrm;
  static constexpr bool kRadius = true;
  static constexpr bool kAntisymmetric = true;
  static __device__ __forceinline__ Prm load(const float* __restrict__ prm) {
    return Prm{prm[0], prm[1], prm[2], prm[3]};
  }
  template <bool kFast = false>
  static __device__ __forceinline__ void pair(float dx, float dy, float u,
                                              float v, float cu, float cv,
                                              float ri, float rj, int,
                                              bool ok, const Prm& p,
                                              float& fx, float& fy) {
    powerlaw_pair(dx, dy, u - cu, v - cv, ri + rj, ok, p, fx, fy);
  }
};

struct Helbing {  // (u, v) = e_i; reads the column velocity, no radii
  using Prm = HelbingPrm;
  static constexpr bool kRadius = false;
  static constexpr bool kAntisymmetric = false;
  static __device__ __forceinline__ Prm load(const float* __restrict__ prm) {
    return Prm{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5]};
  }
  template <bool kFast = false>
  static __device__ __forceinline__ void pair(float dx, float dy, float u,
                                              float v, float cu, float cv,
                                              float, float, int, bool ok,
                                              const Prm& p, float& fx,
                                              float& fy) {
    helbing_pair(dx, dy, cu, cv, u, v, ok, p, fx, fy);
  }
};
static_assert(!Helbing::kAntisymmetric,
              "Helbing is not antisymmetric: it has the dense entries only");

// fn(Law{}) for the law of id `law`: every law (dense walks), or only the
// antisymmetric ones (the Newton's-third-law walks); another id is refused.
template <class Fn>
int with_any_law(int law, Fn&& fn) {
  switch (law) {
    case kLawMoussaid: return fn(Moussaid{});
    case kLawPowerLaw: return fn(PowerLaw{});
    case kLawHelbing: return fn(Helbing{});
  }
  return (int)cudaErrorInvalidValue;
}

template <class Fn>
int with_antisymmetric_law(int law, Fn&& fn) {
  switch (law) {
    case kLawMoussaid: return fn(Moussaid{});
    case kLawPowerLaw: return fn(PowerLaw{});
  }
  return (int)cudaErrorInvalidValue;
}

// Box test of row box (rx0, rx1, ry0, ry1) against column tile t of a
// (4, n_tiles) box array.
__device__ __forceinline__ bool box_hits(const float* __restrict__ bb,
                                         long long n_tiles, long long t,
                                         float rx0, float rx1, float ry0,
                                         float ry1, float c2) {
  return box_gap2(rx0, rx1, ry0, ry1, bb[t], bb[n_tiles + t],
                  bb[2 * n_tiles + t], bb[3 * n_tiles + t]) <= c2;
}

// ---------------------------------------------------------------------------
// The dense walk's inner loop, shared by pair_force_dense_kernel
// (pair_forces.cu) and ring_force_kernel (ring.cu): a lane's R rows, held in
// registers, against one 32-column chunk of a column tile staged in shared
// memory.  All 32 lanes of a warp read the same column at each step (a
// broadcast), so one float4 and one float2 load serve R pairs.

constexpr int kColTile = 256;  // columns per staged tile (pair_grid COL_TILE)
constexpr int kChunk = 32;     // columns per chunk: a warp's culling unit
constexpr int kTileChunks = kColTile / kChunk;
constexpr unsigned kAllLanes = 0xffffffffu;

// A staged column tile: position and velocity slots as one float4, radius
// and liveness (1 or 0) as one float2; with a cutoff, the box of each
// chunk's alive columns.
struct ColTile {
  float4 pv[kColTile];
  float2 ra[kColTile];
  float box[kTileChunks][4];
};

// Stage column c of the tile.  With kBox every lane of the warp must call
// it, for the 32 consecutive columns of one chunk: the warp takes the
// chunk's box.
template <bool kBox>
__device__ __forceinline__ void stage_column(ColTile& t, int c, float x,
                                             float y, float u, float v,
                                             float r, bool a) {
  t.pv[c] = make_float4(x, y, u, v);
  t.ra[c] = make_float2(r, a ? 1.0f : 0.0f);
  if (kBox) {
    const float x0 = warp_min(a ? x : INFINITY);
    const float x1 = warp_max(a ? x : -INFINITY);
    const float y0 = warp_min(a ? y : INFINITY);
    const float y1 = warp_max(a ? y : -INFINITY);
    if (c % kChunk == 0) {
      float* b = t.box[c / kChunk];
      b[0] = x0;
      b[1] = x1;
      b[2] = y0;
      b[3] = y1;
    }
  }
}

// A lane's R rows: row r is the lane's row of the r-th set of 32 rows the
// warp holds.  (u, v): the row's velocity, or Helbing's desired direction;
// g: its global slot; (ax, ay): its running sums; box: with a cutoff, the
// box of the alive rows of set r (the same in every lane of the warp).
template <int kR>
struct RowSet {
  float x[kR], y[kR], u[kR], v[kR], r[kR];
  bool a[kR];
  int g[kR];
  float ax[kR], ay[kR];
  float box[kR][4];

  // set row k (the caller passes zeros and dead for a row that does not
  // exist; gk: its global slot); with kCutoff every lane of the warp must
  // call it, with the same k
  template <bool kCutoff>
  __device__ __forceinline__ void load(int k, float xv, float yv, float uv,
                                       float vv, float rv, bool alive,
                                       int gk) {
    x[k] = xv;
    y[k] = yv;
    u[k] = uv;
    v[k] = vv;
    r[k] = rv;
    a[k] = alive;
    g[k] = gk;
    ax[k] = 0.0f;
    ay[k] = 0.0f;
    if (kCutoff) {
      box[k][0] = warp_min(a[k] ? x[k] : INFINITY);
      box[k][1] = warp_max(a[k] ? x[k] : -INFINITY);
      box[k][2] = warp_min(a[k] ? y[k] : INFINITY);
      box[k][3] = warp_max(a[k] ? y[k] : -INFINITY);
    }
  }
};

// The lane's R rows against columns [chunk * 32, chunk * 32 + cnt) of the
// staged tile, whose first column has global slot g0, added to the rows'
// running sums in ascending column order; false when the chunk was culled
// whole (nothing added).  Warp-uniform.  With kCutoff, a row set
// whose box lies beyond the cutoff from the chunk's box skips the chunk,
// and at each column step the law runs for a row set only when some lane's
// pair lies within the cutoff (a ballot).  A skipped pair's force is
// exactly the +0 the law's mask gives, and a running sum that starts at +0
// never becomes -0, so skipping leaves every sum bitwise as it was.
// Without a cutoff nothing branches between the R law evaluations, so the
// compiler can interleave them.
template <bool kCutoff, bool kFast, class Law, int kR>
__device__ __forceinline__ bool rows_vs_chunk(
    RowSet<kR>& rw, const ColTile& t, int chunk, int cnt, int g0,
    const typename Law::Prm& p, int use_radius, float c2) {
  bool hit[kR];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    hit[r] = !kCutoff ||
             box_gap2(rw.box[r][0], rw.box[r][1], rw.box[r][2], rw.box[r][3],
                      t.box[chunk][0], t.box[chunk][1], t.box[chunk][2],
                      t.box[chunk][3]) <= c2;
    any = any || hit[r];
  }
  if (!any) return false;
  const int c0 = chunk * kChunk;
  auto step = [&](int k) {
    const float4 pv = t.pv[c0 + k];  // x, y, u, v of the column
    const float2 ra = t.ra[c0 + k];  // radius, alive
    const bool ca = ra.y != 0.0f;
    const int gj = g0 + k;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (kCutoff && !hit[r]) continue;
      const float dx = pv.x - rw.x[r];
      const float dy = pv.y - rw.y[r];
      bool ok = rw.a[r] && ca && gj != rw.g[r];
      if (kCutoff) {
        ok = ok && sq_norm_rn(dx, dy) <= c2;
        if (!__any_sync(kAllLanes, ok)) continue;
      }
      float fxk, fyk;
      Law::template pair<kFast>(dx, dy, rw.u[r], rw.v[r], pv.z, pv.w,
                                rw.r[r], ra.x, use_radius, ok, p, fxk, fyk);
      rw.ax[r] += fxk;
      rw.ay[r] += fyk;
    }
  };
  // two column steps per trip without a cutoff (their laws interleave),
  // one with it (the ballot branches around each law)
  if constexpr (kCutoff) {
#pragma unroll 1
    for (int k = 0; k < cnt; ++k) step(k);
  } else {
#pragma unroll 2
    for (int k = 0; k < cnt; ++k) step(k);
  }
  return true;
}
