// ORCA wall-feed kernels and the chunk scan of the chunked environment
// forces for Hopper (sm_90a), with a plain C interface for ctypes
// (utils/cuda_build.py builds this file, ops/statics.py binds it).  Their
// plain PyTorch versions are ops/geometry.py feature_closest_planes,
// closest_point_per_chunk, k_smallest_features and chunk_argmin_plain.
//
// What each function replaces (JAX package):
//   topk_kernel<kSegments> ("seg_topk")  <- ops/pallas_statics.py
//       _seg_topk_kernel (:111) with _merge_topk (:57), _tile_hit (:96) and
//       _tile_circles (:181): per pedestrian, a running top-k (k <= 8) of
//       (d2, wx, wy) over the Douglas-Peucker segment features of the walls
//       that simplify, the closest point taken exactly ON each segment, only
//       features within neighbor_dist.
//   topk_kernel<kChunks> ("chunk_topk")  <- _chunk_topk_kernel (:137): the
//       same over 128-point chunks of the walls that do not simplify (config
//       #3's ellipse cars), each chunk's first-occurrence closest point being
//       one candidate.
//   chunk_closest_kernel ("chunk_closest")  <- ops/geometry.py _cpc_kernel
//       (:214): every chunk's closest point as three (C, N) planes, the chunk
//       scan of chunk_topk without the merge.
//   chunk_argmin_kernel ("chunk_argmin")  <- ops/geometry.py _cp_kernel
//       (:117, pallas_call :181): for every (128-point chunk, pedestrian)
//       the minimum squared distance over the chunk's points and the flat
//       index of the first point that reaches it, as (C, N) f32 and i32
//       planes; no filter and no skip.  The segmented minimum over each
//       segment's chunks stays in PyTorch (ops/geometry.py
//       closest_point_per_segment), as it stayed in jnp.
//
// What bounds them on this card.  Per (feature, pedestrian) pair that
// survives the block skip: a projection (about 15 flops) or a scan of the
// chunk's points (about 5 flops each), and an 8-slot insertion; the outputs
// are 3 k floats per pedestrian, the features a few hundred kB.  At the ORCA
// path's N = 10,000 that is of the order of 1e7-1e8 flops, microseconds at
// the card's f32 rate, and a few hundred kB of traffic: the bound is a few
// microseconds either way, and what decides the time is latency (79 blocks
// of 4 warps at N = 10,000) and the barriers of the staging.
//
// What the design does about that.  One block is 128 consecutive
// pedestrians of the caller's order (ORCA's windowed path passes its
// Hilbert-sorted planes, so a block's box is tight), one thread per
// pedestrian.  The block reduces its alive pedestrians' box (block_box.cuh)
// and walks the features in ascending index, a tile of 128 at a time: each
// thread loads one feature of the tile into shared memory and tests its
// filter circle, inflated by neighbor_dist, against the box; a tile with no
// hit is skipped by the whole block, and inside a tile only the hit features
// are computed.  The skip is exact, because the circle holds every point of
// its feature and the kernel keeps only candidates with d2 <= nd2 (nd2 a
// runtime argument: neighbor_dist is a sweepable parameter).  A chunk's
// points are staged the same way, 128 at a time.  The running list lives in
// registers: 8 slots, an unrolled compare-swap insertion with strict <, so
// with features in ascending index it holds the k_smallest_features
// selection in its order (first occurrence on ties); an invalid candidate
// never enters (it would carry kPadDist2, which no slot is above).  The
// distances are rounded per operation as the plain versions compute them,
// so kernel and plain version pick the same features and points bitwise.
//
// chunk_argmin scans every (point, pedestrian) pair: about 8 operations
// each, 2e8 pairs at the Town02 crowd's shape (2e4 padded points, 1e4
// pedestrians), 25 us at the card's f32 rate, against 12 MB of (C, N)
// output, 4 us at its memory rate: bound by the operations.  Its grid is
// (pedestrian blocks of 128, groups of kArgminChunks chunks), so that a
// crowd of 10,000 still fills the card with blocks; each block stages one
// chunk's points in shared memory at a time and each thread scans them for
// its pedestrian with a strict <, every squared distance rounded per
// operation, so that dmin and idx equal the plain version's bitwise.
//
// Where the TPU design does not carry over.  The TPU kept the running list
// in the revisited (8, ped tile) output block over a sequential feature grid
// axis, and merged a tile's candidates by k min-extraction passes; here the
// feature loop runs inside the block and each candidate is inserted as it
// comes, which selects the same set in the same order.  The TPU tested one
// union circle per feature tile; here each feature's own circle is tested
// too.  A pedestrian that is dead while `alive` is given is outside its
// block's box: its row is undefined (the callers mask it).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_box.cuh"
#include "statics.cuh"

namespace {

constexpr int kPeds = kBoxPeds;   // pedestrians per block, one per thread
constexpr int kTile = kBoxPeds;   // features (or chunk points) per stage

enum Source { kSegments, kChunks };

// Load chunk c's points [p0, p0 + kTile) into shared memory (PAD past the
// row) and scan them for the first-occurrence closest point.  Every thread
// of the block must call it; `scan` says whether this thread scans.
__device__ __forceinline__ void chunk_piece(
    const float* __restrict__ x, const float* __restrict__ y, size_t row,
    int kk, int p0, float* sx, float* sy, bool scan, float px, float py,
    float& best, float& bx, float& by) {
  __syncthreads();  // the previous piece is consumed
  const int j = p0 + threadIdx.x;
  sx[threadIdx.x] = j < kk ? x[row + j] : kPadCoord;
  sy[threadIdx.x] = j < kk ? y[row + j] : kPadCoord;
  __syncthreads();
  if (scan) {
    const int cnt = min(kTile, kk - p0);
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) closest_update(sx[t], sy[t], px, py, best, bx, by);
  }
}

// kSegments: f features, planes a0..a4 = ax, ay, ux, uy, il2 and the filter
// circles (ccx, ccy, rad).  kChunks: f chunks of kk points, a0/a1 = the
// (f, kk) x/y planes (PAD_COORD in invalid slots), circles (ccx, ccy, rad)
// with rad < 0 for an empty chunk.  Outputs (k, n) d2 (inf in an empty
// slot), wx, wy (0 in an empty slot).
template <Source kSrc>
__global__ void __launch_bounds__(kPeds)
topk_kernel(const float* __restrict__ px_, const float* __restrict__ py_,
            const uint8_t* __restrict__ alive_,
            const float* __restrict__ a0, const float* __restrict__ a1,
            const float* __restrict__ a2, const float* __restrict__ a3,
            const float* __restrict__ a4, const float* __restrict__ ccx,
            const float* __restrict__ ccy, const float* __restrict__ rad,
            int f, int kk, float nd, float nd2, int k, int n,
            float* __restrict__ out_d2, float* __restrict__ out_x,
            float* __restrict__ out_y) {
  __shared__ float sa[5][kTile];
  __shared__ int shit[kTile];

  const int i = blockIdx.x * kPeds + threadIdx.x;
  const bool in = i < n;
  const bool live = in && (alive_ == nullptr || alive_[i] != 0);
  const float px = in ? px_[i] : 0.0f;
  const float py = in ? py_[i] : 0.0f;
  const Box box = block_box(px, py, live);

  float d[kTopK], x[kTopK], y[kTopK];
#pragma unroll
  for (int s = 0; s < kTopK; ++s) {
    d[s] = kPadDist2;
    x[s] = 0.0f;
    y[s] = 0.0f;
  }

  for (int f0 = 0; f0 < f; f0 += kTile) {
    // each thread loads and tests one feature of the tile
    const int fi = f0 + threadIdx.x;
    int hit = 0;
    float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (fi < f) {
      hit = touches(ccx[fi], ccy[fi], feature_reach2(rad[fi], nd), box);
      if (kSrc == kSegments) {
        v[0] = a0[fi];
        v[1] = a1[fi];
        v[2] = a2[fi];
        v[3] = a3[fi];
        v[4] = a4[fi];
      }
    }
    __syncthreads();  // the previous tile is consumed
    shit[threadIdx.x] = hit;
    if (kSrc == kSegments) {
#pragma unroll
      for (int p = 0; p < 5; ++p) sa[p][threadIdx.x] = v[p];
    }
    if (!__syncthreads_or(hit)) continue;
    const int cnt = min(kTile, f - f0);
    for (int t = 0; t < cnt; ++t) {
      if (!shit[t]) continue;  // block-uniform
      float cd, cx, cy;
      if (kSrc == kSegments) {
        cd = closest_on_segment(sa[0][t], sa[1][t], sa[2][t], sa[3][t],
                                sa[4][t], px, py, cx, cy);
      } else {
        // the chunk's points through sa[0], sa[1] (the segment planes are
        // unused for chunks)
        float best = INFINITY, bx = 0.0f, by = 0.0f;
        const size_t row = (size_t)(f0 + t) * kk;
        for (int p0 = 0; p0 < kk; p0 += kTile)
          chunk_piece(a0, a1, row, kk, p0, sa[0], sa[1], in, px, py, best, bx,
                      by);
        cd = best;
        cx = bx;
        cy = by;
      }
      if (in && cd <= nd2) topk_insert(cd, cx, cy, d, x, y);
    }
  }
  if (!in) return;
#pragma unroll
  for (int s = 0; s < kTopK; ++s) {
    if (s < k) {
      out_d2[(size_t)s * n + i] = d[s] < kPadDist2 ? d[s] : INFINITY;
      out_x[(size_t)s * n + i] = x[s];
      out_y[(size_t)s * n + i] = y[s];
    }
  }
}

// Every chunk's first-occurrence closest point: (f, n) planes d2 (inf
// beyond nd2, and for a chunk skipped by the block), wx, wy (0 for a
// skipped chunk).
__global__ void __launch_bounds__(kPeds)
chunk_closest_kernel(const float* __restrict__ px_,
                     const float* __restrict__ py_,
                     const uint8_t* __restrict__ alive_,
                     const float* __restrict__ cxs,
                     const float* __restrict__ cys, int f, int kk,
                     const float* __restrict__ ccx,
                     const float* __restrict__ ccy,
                     const float* __restrict__ rad, float nd, float nd2,
                     int n, float* __restrict__ out_d2,
                     float* __restrict__ out_x, float* __restrict__ out_y) {
  __shared__ float sx[kTile], sy[kTile];
  const int i = blockIdx.x * kPeds + threadIdx.x;
  const bool in = i < n;
  const bool live = in && (alive_ == nullptr || alive_[i] != 0);
  const float px = in ? px_[i] : 0.0f;
  const float py = in ? py_[i] : 0.0f;
  const Box box = block_box(px, py, live);

  for (int c = 0; c < f; ++c) {
    float best = INFINITY, bx = 0.0f, by = 0.0f;
    if (touches(ccx[c], ccy[c], feature_reach2(rad[c], nd), box)) {
      const size_t row = (size_t)c * kk;
      for (int p0 = 0; p0 < kk; p0 += kTile)
        chunk_piece(cxs, cys, row, kk, p0, sx, sy, in, px, py, best, bx, by);
    }
    if (in) {
      out_d2[(size_t)c * n + i] = best <= nd2 ? best : INFINITY;
      out_x[(size_t)c * n + i] = bx;
      out_y[(size_t)c * n + i] = by;
    }
  }
}

// Every (chunk, pedestrian)'s minimum squared distance over the chunk's kk
// points of the staged planes fx, fy ((c, kk), PAD_COORD in invalid slots)
// and the flat index chunk * kk + j of the first point that reaches it.
// Grid: (pedestrian blocks, groups of kArgminChunks chunks).
constexpr int kArgminChunks = 8;

__global__ void __launch_bounds__(kPeds)
chunk_argmin_kernel(const float* __restrict__ px_,
                    const float* __restrict__ py_,
                    const float* __restrict__ fx,
                    const float* __restrict__ fy, int c, int kk, int n,
                    float* __restrict__ out_d2, int* __restrict__ out_idx) {
  __shared__ float sx[kTile], sy[kTile];
  const int i = blockIdx.x * kPeds + threadIdx.x;
  const bool in = i < n;
  const float px = in ? px_[i] : 0.0f;
  const float py = in ? py_[i] : 0.0f;
  const int c0 = blockIdx.y * kArgminChunks;
  const int c1 = min(c0 + kArgminChunks, c);
  for (int ch = c0; ch < c1; ++ch) {
    const size_t row = (size_t)ch * kk;
    float best = INFINITY;
    int arg = 0;
    for (int p0 = 0; p0 < kk; p0 += kTile) {
      __syncthreads();  // the previous piece is consumed
      const int j = p0 + threadIdx.x;
      sx[threadIdx.x] = j < kk ? fx[row + j] : kPadCoord;
      sy[threadIdx.x] = j < kk ? fy[row + j] : kPadCoord;
      __syncthreads();
      if (in) {
        const int cnt = min(kTile, kk - p0);
#pragma unroll 4
        for (int t = 0; t < cnt; ++t) {
          const float d2 = sq_norm_rn(sx[t] - px, sy[t] - py);
          if (d2 < best) {  // strict: the first of equal distances
            best = d2;
            arg = p0 + t;
          }
        }
      }
    }
    if (in) {
      out_d2[(size_t)ch * n + i] = best;
      out_idx[(size_t)ch * n + i] = (int)(row + arg);
    }
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError(): non-zero
// means the launch was refused.  Pedestrian planes (n,); alive (n,) bool or
// null (every pedestrian in the boxes); nd the neighbour distance and nd2
// its float32 square.  Every output element of a row < n is written.
int sfm_seg_topk(const float* px, const float* py, const uint8_t* alive,
                 const float* ax, const float* ay, const float* ux,
                 const float* uy, const float* il2, const float* ccx,
                 const float* ccy, const float* rad, int f, float nd,
                 float nd2, int k, int n, float* d2, float* wx, float* wy,
                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kTopK) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kPeds - 1) / kPeds;
  topk_kernel<kSegments><<<blocks, kPeds, 0, (cudaStream_t)stream>>>(
      px, py, alive, ax, ay, ux, uy, il2, ccx, ccy, rad, f, 0, nd, nd2, k, n,
      d2, wx, wy);
  return (int)cudaGetLastError();
}

// x, y (c, kk) chunk point planes, PAD_COORD in invalid slots; cx, cy, rad
// (c,) chunk circles (rad < 0: an empty chunk).
int sfm_chunk_topk(const float* px, const float* py, const uint8_t* alive,
                   const float* x, const float* y, int c, int kk,
                   const float* cx, const float* cy, const float* rad,
                   float nd, float nd2, int k, int n, float* d2, float* wx,
                   float* wy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kTopK) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kPeds - 1) / kPeds;
  topk_kernel<kChunks><<<blocks, kPeds, 0, (cudaStream_t)stream>>>(
      px, py, alive, x, y, nullptr, nullptr, nullptr, cx, cy, rad, c, kk, nd,
      nd2, k, n, d2, wx, wy);
  return (int)cudaGetLastError();
}

int sfm_chunk_closest(const float* px, const float* py, const uint8_t* alive,
                      const float* x, const float* y, int c, int kk,
                      const float* cx, const float* cy, const float* rad,
                      float nd, float nd2, int n, float* d2, float* wx,
                      float* wy, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  const int blocks = (n + kPeds - 1) / kPeds;
  chunk_closest_kernel<<<blocks, kPeds, 0, (cudaStream_t)stream>>>(
      px, py, alive, x, y, c, kk, cx, cy, rad, nd, nd2, n, d2, wx, wy);
  return (int)cudaGetLastError();
}

// fx, fy (c, kk) staged chunk planes (PAD_COORD in invalid slots); d2 (c, n)
// f32 and idx (c, n) i32 outputs.
int sfm_chunk_argmin(const float* px, const float* py, const float* fx,
                     const float* fy, int c, int kk, int n, float* d2,
                     int* idx, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kPeds - 1) / kPeds,
                  (c + kArgminChunks - 1) / kArgminChunks);
  chunk_argmin_kernel<<<grid, kPeds, 0, (cudaStream_t)stream>>>(
      px, py, fx, fy, c, kk, n, d2, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
