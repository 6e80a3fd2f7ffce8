// The pair laws as the pair kernels instantiate them, the tile-box test and
// the law ids of the C entries, shared by pair_forces.cu and ring.cu.
// Device code: included by .cu files only (the per-pair math itself is in
// pair_forces.cuh, which the host compiler checks too).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_forces.cuh"

// The law ids of the C entries (ops/cuda_forces.py LAW_IDS).
enum LawId { kLawMoussaid = 0, kLawPowerLaw = 1, kLawHelbing = 2 };

// Each law reads its parameter vector (models/params.py *_vector), says
// whether it reads radii and whether it is antisymmetric, and evaluates one
// pair from the row's position and velocity slots (u, v) and the column's
// position, velocity (cu, cv) and radius.  The row slots hold v_i, except
// for Helbing, whose row planes carry the row's desired direction e_i there.
// pair<true> is the symmetric walks' call: the Moussaid law's fast tail
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
