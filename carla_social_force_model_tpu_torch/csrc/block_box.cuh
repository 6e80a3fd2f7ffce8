// The box of a block's alive pedestrians and the block-uniform test of a
// filter circle against it, shared by the environment kernels
// (env_forces.cu) and the wall-feed kernels (statics.cu); and the SM count
// that the launches sizing their grids by blocks per SM read (statics.cu,
// pair_forces.cu).  Device code: included by .cu files only.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "pair_forces.cuh"

constexpr int kBoxPeds = 128;     // pedestrians per block, one per thread

struct Box {
  float minx, maxx, miny, maxy;
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Bounding box of the block's alive pedestrians (blocks of kThreads
// threads; several threads may hold the same pedestrian); a block with
// none gets the inverted infinite box, which no circle touches.  Every
// thread of the block must call it.
template <int kThreads = kBoxPeds>
static __device__ Box block_box(float x, float y, bool live) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0, "whole warps");
  __shared__ float part[4][kWarps];
  const float x_lo = warp_min(live ? x : INFINITY);
  const float x_hi = warp_max(live ? x : -INFINITY);
  const float y_lo = warp_min(live ? y : INFINITY);
  const float y_hi = warp_max(live ? y : -INFINITY);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part[0][warp] = x_lo;
    part[1][warp] = x_hi;
    part[2][warp] = y_lo;
    part[3][warp] = y_hi;
  }
  __syncthreads();
  Box box{INFINITY, -INFINITY, INFINITY, -INFINITY};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    box.minx = fminf(box.minx, part[0][w]);
    box.maxx = fmaxf(box.maxx, part[1][w]);
    box.miny = fminf(box.miny, part[2][w]);
    box.maxy = fmaxf(box.maxy, part[3][w]);
  }
  return box;
}

// Does the filter circle (cx, cy, r2) touch the box?  Block-uniform.  Each
// gap is at most the matching |center - ped| of any pedestrian in the box
// (rounding is monotone), so a pedestrian inside the circle always lies in
// a touching box.
__device__ __forceinline__ bool touches(float cx, float cy, float r2,
                                        const Box& box) {
  const float gx = fmaxf(fmaxf(cx - box.maxx, box.minx - cx), 0.0f);
  const float gy = fmaxf(fmaxf(cy - box.maxy, box.miny - cy), 0.0f);
  return sq_norm_rn(gx, gy) <= r2;
}

// The current device's number of SMs.
static inline cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}
