// ORCA wall-feed kernels and the chunk scan of the chunked environment
// forces for Hopper (sm_90a), with a plain C interface for ctypes
// (utils/cuda_build.py builds this file, ops/statics.py binds it).  Their
// plain PyTorch versions are ops/geometry.py feature_closest_planes,
// closest_point_per_chunk, k_smallest_features and chunk_argmin_plain.
//
// What each function replaces (JAX package):
//   seg_topk_kernel ("seg_topk")  <- ops/pallas_statics.py
//       _seg_topk_kernel (:111) with _merge_topk (:57), _tile_hit (:96) and
//       _tile_circles (:181): per pedestrian, a running top-k (k <= 8) of
//       (d2, wx, wy) over the Douglas-Peucker segment features of the walls
//       that simplify, the closest point taken exactly ON each segment, only
//       features within neighbor_dist.
//   chunk_topk_kernel ("chunk_topk")  <- _chunk_topk_kernel (:137): the
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
//   chunk_argmin_percrowd_kernel ("chunk_argmin_percrowd")  <- _cp_kernel
//       under vmap with batched chunks: a batch of crowds that each scan
//       their own chunks (a batch of fleets' vehicle outlines), crowd b
//       equal to chunk_argmin on its own planes.
//
// What bounds them on this card.  Per (feature, pedestrian) pair that
// survives the block skip: a projection (about 15 flops) or a scan of the
// chunk's points (about 5 flops each), and an 8-slot insertion; the outputs
// are 3 k floats per pedestrian, the features a few hundred kB.  At the ORCA
// path's N = 10,000 that is of the order of 1e7-1e8 flops, microseconds at
// the card's f32 rate, and a few hundred kB of traffic: the bound is a few
// microseconds either way, and what decides the time is latency and the
// barriers of the staging.
//
// The three wall-feed kernels (and their batched forms, below) share one
// layout, the environment kernels' (env_forces.cu): a block is 32
// consecutive pedestrians of the caller's
// order (ORCA's windowed path passes its Hilbert-sorted planes, so a
// block's box is tight) x L lanes each (313 blocks at N = 10,000, where
// one thread per pedestrian gave 79 blocks of 128 and left 53 of the 132
// SMs idle; L = 4 for the segment top-k and chunk_closest, 8 for the chunk
// top-k, PERF.md).  The block reduces its alive pedestrians' box
// (block_box.cuh) and walks the features in ascending index, a tile of
// 32 L at a time: each thread tests one feature's filter circle, inflated
// by neighbor_dist, against the box, and the hits are compacted in
// ascending order with ballots (hit_rank).  The skip is exact, because
// the circle holds every point of its feature and the kernels keep only
// candidates with d2 <= nd2 (nd2 a runtime argument: neighbor_dist is a
// sweepable parameter).  A running list lives in registers: 8 slots, an
// insertion before the first strictly larger entry (topk_insert), so with
// features in ascending index it holds the k_smallest_features selection
// in its order (first occurrence on ties); an invalid candidate never
// enters (it would carry kPadDist2, which no slot is above).  The
// distances are rounded per operation as the plain versions compute them,
// so kernel and plain version pick the same features and points bitwise.
//
// The segment top-k (seg_topk_kernel): the five planes of a tile's hit
// features are staged in shared memory at their compacted places, and
// lane l of each pedestrian projects the hit features h = l, l + L, ... in
// ascending order (one projection a feature pair), inserting each within
// nd2 into its own list with the feature's index (topk_insert_at).  So a
// lane's list is ascending in (d2, index), and the k nearest of the
// pedestrian are the k least (d2, index) over its L lists: k rounds of a
// shuffle minimum over the lanes' heads, the winning lane dropping its
// head.  A tie of equal d2 in different lanes goes to the lower feature
// index, k_smallest_features's order.  The k x 32 results are staged in
// shared memory and stored as rows of 32 pedestrians.  The lists hold 4
// slots for k <= 4 (ORCA's k = 3: fewer registers, more blocks an SM).
//
// The chunk top-k (chunk_topk_kernel) tests the circles of a tile of 256
// chunks against the box, one chunk a thread;
// it stages the real points of up to kTopkStage / K hit chunks at once as
// float2 behind one pair of barriers (each chunk's real length, the slots
// up to its last valid one, comes with the feed: ChunkFeatures.lengths),
// and each pedestrian whose own circle test passes scans every L-th point
// of each staged chunk with a strict <, keeping the slot of its best.  A
// shuffle merge takes the least (distance, slot), the lower slot on a tie:
// the sequential scan's first occurrence.  Lane 0 inserts the candidate.
//
// chunk_closest (chunk_closest_kernel) writes three (C, N) planes, 20 MB
// at config #3's 169 car chunks and N = 10,000: it is bound by those bytes.
// Its grid is (pedestrian blocks, chunk splits), split y taking the chunks
// y, y + Y, ... (a block's hit chunks lie near each other in index, so the
// strides spread them), with Y chosen so that about kClosestBlocksPerSM
// blocks per SM run.  A skipped chunk's rows are stored as inf / 0 at
// once, each warp a row of 32 pedestrians (128 bytes a plane), with no
// scan and no barrier.  The real points of up to kClosestStage / K hit
// chunks are staged at once as float2; the L lanes of every pedestrian of
// the block scan every L-th point of each chunk with a strict <, keeping
// the distance and the slot (argmin_step), a shuffle merge takes the least
// (distance, slot), and lane 0 reads that slot's point and stages the
// result, which the block stores as whole rows.
//
// chunk_argmin scans every (point, pedestrian) pair: five operations for
// the distance and three for the first-occurrence minimum, 2e8 pairs at
// the Town02 crowd's shape (2e4 padded points, 1e4 pedestrians), against
// 12 MB of (C, N) output: bound by the operations, and by the issue rate
// above that (tools/sass_census.py counts the loop).  A thread holds R =
// kArgminRows pedestrians, so one shared load of four points' x (and one
// of their y) serves 4 R pairs, in 32-point sub-groups unrolled whole.  A
// block stages a group of whole chunks (kArgminStage points, the K-slot
// rows padded to a multiple of four) with cp.async into a two-stage
// buffer, so the next group's copy overlaps this group's scan; the grid is
// (pedestrian blocks, chunk splits) with the splits chosen so that about
// kArgminBlocksPerSM blocks per SM run at the Town02 shape.  A two-pass
// minimum (fminf over a sub-group, its first index searched again only
// when it beats the running best) measured 2.6x slower at that shape: the
// pedestrians of a warp improve in different sub-groups, so nearly every
// sub-group was scanned twice (PERF.md).
//
// Batches (ensembles and parameter sweeps).  Under the JAX package's vmap
// the wall-feed kernels gain a leading batch axis on the pedestrian planes
// and, in a sweep of orca_neighbor_dist, on the neighbour distance, while
// the features stay shared (parallel/sweeps.py).  seg_topk_batched_kernel,
// chunk_topk_batched_kernel (crowd blockIdx.y) and
// chunk_closest_batched_kernel (crowd blockIdx.z; y is its chunk split)
// hand their crowd's planes, alive mask, outputs and neighbour distance to
// the body the unbatched kernel runs (seg_topk_walk, chunk_topk_walk,
// chunk_closest_walk), so row b equals the unbatched launch on row b
// bitwise and the unbatched kernels compile with no batch offset (an offset
// read inside a shared body slowed the dense pair walk 8%, PERF.md).  The
// pedestrians are not flattened into one unbatched launch, as the chunk
// scan's are: a block must not straddle two crowds (its box, and so which
// chunks chunk_closest stores as skipped, would change), and each crowd of
// a sweep has its own filter and gate.
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
#include <limits.h>
#include <stdint.h>

#include "block_box.cuh"
#include "statics.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;

// the segment top-k: L lanes per pedestrian (a divisor of 32), 32
// pedestrians a block, one feature a thread in a tile, and the slots of
// the lists for k up to 4
constexpr int kSegLanes = 4;
constexpr int kSegSlotsSmall = 4;
constexpr int kSegPeds = 32;
constexpr int kSegThreads = kSegPeds * kSegLanes;
static_assert(32 % kSegLanes == 0 && kSegLanes < 32,
              "a pedestrian's lanes lie in one warp, with others");

// the chunk top-k: L lanes per pedestrian, 32 pedestrians a block, and the
// points of hit chunks staged per batch
constexpr int kTopkLanes = 8;
constexpr int kTopkPeds = 32;
constexpr int kTopkThreads = kTopkPeds * kTopkLanes;
constexpr int kTopkStage = 1024;
static_assert(32 % kTopkLanes == 0, "a pedestrian's lanes lie in one warp");

// chunk_closest: L lanes per pedestrian, 32 pedestrians a block, points
// staged per batch, the most hit chunks of a batch, and the blocks per SM
// the grid aims at
constexpr int kClosestLanes = 4;
constexpr int kClosestPeds = 32;
constexpr int kClosestThreads = kClosestPeds * kClosestLanes;
constexpr int kClosestStage = 1024;
constexpr int kClosestBatch = 16;
constexpr int kClosestBlocksPerSM = 4;
static_assert(32 % kClosestLanes == 0, "a pedestrian's lanes lie in one warp");

// chunk_argmin: R pedestrians per thread (PERF.md: 2 and 4 measured),
// threads per block, points per stage (two stages), points per unrolled
// sub-group, and the blocks per SM the grid aims at
constexpr int kArgminRows = 4;
constexpr int kArgminThreads = 128;
constexpr int kArgminStage = 1024;
constexpr int kArgminSub = 32;
constexpr int kArgminBlocksPerSM = 4;
static_assert(kArgminStage % kArgminSub == 0, "whole sub-groups per stage");

// This thread's place among the hits of a tile of kThreads items (one a
// thread, hit or not), in ascending thread order, and the tile's number of
// hits; wball[w] keeps warp w's ballot.  Every thread of the block must
// call it.  It begins with a barrier (the previous tile's lists and stages
// are consumed); the caller writes its hit at the place, and a barrier
// must pass before another thread reads it.
template <int kThreads>
__device__ __forceinline__ int hit_rank(bool hit, unsigned* wball,
                                        int& nhit) {
  const int tid = threadIdx.x;
  const unsigned ballot = __ballot_sync(kAll, hit);
  __syncthreads();
  if (tid % 32 == 0) wball[tid / 32] = ballot;
  __syncthreads();
  int before = 0;
  nhit = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int c = __popc(wball[w]);
    before += w < tid / 32 ? c : 0;
    nhit += c;
  }
  return before + __popc(ballot & ((1u << (tid % 32)) - 1u));
}

// One step of the first-occurrence argmin at slot j: the squared distance
// rounded per operation as the plain version computes it, kept with a
// strict < (the first of equal distances).  The running minimum is an
// fminf (the same value: no distance is NaN or -0), so the chain from one
// point to the next is one instruction and the index select hangs off it.
__device__ __forceinline__ void argmin_step(float x, float y, float px,
                                            float py, int j, float& best,
                                            int& arg) {
  const float d2 = sq_norm_rn(x - px, y - py);
  arg = d2 < best ? j : arg;
  best = fminf(best, d2);
}

// The least (distance, slot) over the L lanes of each pedestrian, in
// every lane (the point is read from the winning slot).
template <int L>
__device__ __forceinline__ void lanes_min_slot(float& best, int& bj) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    const float o_best = __shfl_xor_sync(kAll, best, o);
    const int o_bj = __shfl_xor_sync(kAll, bj, o);
    if (o_best < best || (o_best == best && o_bj < bj)) {
      best = o_best;
      bj = o_bj;
    }
  }
}

// The least (distance, slot) over the L lanes of each pedestrian, with its
// point, in every lane: the lower slot on a tie, so the lanes' strided
// scans give the sequential scan's first occurrence.
template <int L>
__device__ __forceinline__ void lanes_min(float& best, int& bj, float& bx,
                                          float& by) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    const float o_best = __shfl_xor_sync(kAll, best, o);
    const int o_bj = __shfl_xor_sync(kAll, bj, o);
    const float o_bx = __shfl_xor_sync(kAll, bx, o);
    const float o_by = __shfl_xor_sync(kAll, by, o);
    if (o_best < best || (o_best == best && o_bj < bj)) {
      best = o_best;
      bj = o_bj;
      bx = o_bx;
      by = o_by;
    }
  }
}

// The segment top-k's body: seg_topk_kernel runs it on its arguments,
// seg_topk_batched_kernel on its crowd's.  f segment features, planes a0..a4
// = ax, ay, ux, uy, il2 and the filter circles (ccx, ccy, rad).  Outputs
// (k, n) d2 (inf in an empty slot), wx, wy (0 in an empty slot).  S slots a
// list (k <= S): 4 for ORCA's k = 3 (fewer registers, more blocks an SM),
// else kTopK.
template <int S>
__device__ __forceinline__ void seg_topk_walk(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const uint8_t* __restrict__ alive_, const float* __restrict__ a0,
    const float* __restrict__ a1, const float* __restrict__ a2,
    const float* __restrict__ a3, const float* __restrict__ a4,
    const float* __restrict__ ccx, const float* __restrict__ ccy,
    const float* __restrict__ rad, int f, float nd, float nd2, int k, int n,
    float* __restrict__ out_d2, float* __restrict__ out_x,
    float* __restrict__ out_y) {
  constexpr int L = kSegLanes;
  constexpr int T = kSegThreads;
  __shared__ float sa[5][T];
  __shared__ int sidx[T];
  __shared__ unsigned wball[T / 32];
  __shared__ float res[3][S][kSegPeds];

  const int tid = threadIdx.x;
  const int lane = tid % L;  // this pedestrian's lane
  const int ped = tid / L;
  const int i = blockIdx.x * kSegPeds + ped;
  const bool in = i < n;
  const bool live = in && (alive_ == nullptr || alive_[i] != 0);
  const float px = in ? px_[i] : 0.0f;
  const float py = in ? py_[i] : 0.0f;
  const Box box = block_box<T>(px, py, live);

  float d[S], x[S], y[S];
  int id[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    d[s] = kPadDist2;
    x[s] = 0.0f;
    y[s] = 0.0f;
    id[s] = INT_MAX;
  }

  for (int f0 = 0; f0 < f; f0 += T) {
    // each thread tests one feature of the tile; the hits are staged at
    // their places in ascending order
    const int fi = f0 + tid;
    bool hit = false;
    float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (fi < f) {
      hit = touches(ccx[fi], ccy[fi], feature_reach2(rad[fi], nd), box);
      v[0] = a0[fi];
      v[1] = a1[fi];
      v[2] = a2[fi];
      v[3] = a3[fi];
      v[4] = a4[fi];
    }
    int nhit;
    const int at = hit_rank<T>(hit, wball, nhit);
    if (hit) {
#pragma unroll
      for (int p = 0; p < 5; ++p) sa[p][at] = v[p];
      sidx[at] = fi;
    }
    __syncthreads();
    if (in) {
      for (int h = lane; h < nhit; h += L) {
        float cx, cy;
        const float cd = closest_on_segment(sa[0][h], sa[1][h], sa[2][h],
                                            sa[3][h], sa[4][h], px, py, cx,
                                            cy);
        if (cd <= nd2) topk_insert_at<S>(cd, cx, cy, sidx[h], d, x, y, id);
      }
    }
  }

  // k rounds: the least head (d2, index) over the pedestrian's lanes; the
  // winner drops its head (several lanes win only with empty heads)
  const unsigned lanes = ((1u << L) - 1u) << (tid % 32 / L * L);
  for (int s = 0; s < k; ++s) {
    float md = d[0];
    int mi = id[0];
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(kAll, md, o);
      const int oi = __shfl_xor_sync(kAll, mi, o);
      if (od < md || (od == md && oi < mi)) {
        md = od;
        mi = oi;
      }
    }
    const bool win = d[0] == md && id[0] == mi;
    const int from = __ffs(__ballot_sync(kAll, win) & lanes) - 1;
    const float wx = __shfl_sync(kAll, x[0], from);
    const float wy = __shfl_sync(kAll, y[0], from);
    if (lane == 0) {
      res[0][s][ped] = md < kPadDist2 ? md : INFINITY;
      res[1][s][ped] = wx;
      res[2][s][ped] = wy;
    }
    if (win) {
#pragma unroll
      for (int t = 0; t + 1 < S; ++t) {
        d[t] = d[t + 1];
        x[t] = x[t + 1];
        y[t] = y[t + 1];
        id[t] = id[t + 1];
      }
      d[S - 1] = kPadDist2;
      x[S - 1] = 0.0f;
      y[S - 1] = 0.0f;
      id[S - 1] = INT_MAX;
    }
  }
  __syncthreads();
  // slot s of the block's 32 pedestrians: a row of 128 bytes a plane
  for (int e = tid; e < k * kSegPeds; e += T) {
    const int s = e / kSegPeds;
    const int q = e - s * kSegPeds;
    const int r = blockIdx.x * kSegPeds + q;
    if (r < n) {
      out_d2[(size_t)s * n + r] = res[0][s][q];
      out_x[(size_t)s * n + r] = res[1][s][q];
      out_y[(size_t)s * n + r] = res[2][s][q];
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kSegThreads)
seg_topk_kernel(const float* __restrict__ px_, const float* __restrict__ py_,
                const uint8_t* __restrict__ alive_,
                const float* __restrict__ a0, const float* __restrict__ a1,
                const float* __restrict__ a2, const float* __restrict__ a3,
                const float* __restrict__ a4, const float* __restrict__ ccx,
                const float* __restrict__ ccy, const float* __restrict__ rad,
                int f, float nd, float nd2, int k, int n,
                float* __restrict__ out_d2, float* __restrict__ out_x,
                float* __restrict__ out_y) {
  seg_topk_walk<S>(px_, py_, alive_, a0, a1, a2, a3, a4, ccx, ccy, rad, f,
                   nd, nd2, k, n, out_d2, out_x, out_y);
}

// The segment top-k of a batch of crowds of n pedestrians: crowd
// blockIdx.y's planes and alive mask at blockIdx.y * n, its (k, n) outputs
// at blockIdx.y * k * n, its neighbour distance and square at blockIdx.y of
// nd_rows and nd2_rows (null: nd and nd2 for every crowd); every crowd reads
// the one set of features.
template <int S>
__global__ void __launch_bounds__(kSegThreads)
seg_topk_batched_kernel(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const uint8_t* __restrict__ alive_, const float* __restrict__ a0,
    const float* __restrict__ a1, const float* __restrict__ a2,
    const float* __restrict__ a3, const float* __restrict__ a4,
    const float* __restrict__ ccx, const float* __restrict__ ccy,
    const float* __restrict__ rad, int f, float nd, float nd2,
    const float* __restrict__ nd_rows, const float* __restrict__ nd2_rows,
    int k, int n, float* __restrict__ out_d2, float* __restrict__ out_x,
    float* __restrict__ out_y) {
  const int b = blockIdx.y;
  const size_t bo = (size_t)b * n;
  const size_t oo = bo * k;
  seg_topk_walk<S>(px_ + bo, py_ + bo, alive_ ? alive_ + bo : nullptr, a0,
                   a1, a2, a3, a4, ccx, ccy, rad, f,
                   nd_rows ? nd_rows[b] : nd, nd2_rows ? nd2_rows[b] : nd2, k,
                   n, out_d2 + oo, out_x + oo, out_y + oo);
}

// The chunk top-k's body (chunk_topk_kernel, chunk_topk_batched_kernel): f
// chunks of kk slots in the (f, kk) planes cxs, cys (PAD_COORD in invalid
// slots), lens (f,) the slots up to each chunk's last valid one, circles
// (ccx, ccy, rad) with rad < 0 for an empty chunk.  Outputs as
// seg_topk_walk's.
__device__ __forceinline__ void chunk_topk_walk(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const uint8_t* __restrict__ alive_, const float* __restrict__ cxs,
    const float* __restrict__ cys, int f, int kk,
    const int* __restrict__ lens, const float* __restrict__ ccx,
    const float* __restrict__ ccy, const float* __restrict__ rad, float nd,
    float nd2, int k, int n, float* __restrict__ out_d2,
    float* __restrict__ out_x, float* __restrict__ out_y) {
  __shared__ __align__(16) float2 sxy[kTopkStage];
  __shared__ int hits[kTopkThreads];
  __shared__ unsigned wball[kTopkThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid % kTopkLanes;  // this pedestrian's lane
  const int i = blockIdx.x * kTopkPeds + tid / kTopkLanes;
  const bool in = i < n;
  const bool live = in && (alive_ == nullptr || alive_[i] != 0);
  const float px = in ? px_[i] : 0.0f;
  const float py = in ? py_[i] : 0.0f;
  const Box box = block_box<kTopkThreads>(px, py, live);
  const Box mine{px, px, py, py};  // this pedestrian's own circle test

  float d[kTopK], x[kTopK], y[kTopK];
#pragma unroll
  for (int s = 0; s < kTopK; ++s) {
    d[s] = kPadDist2;
    x[s] = 0.0f;
    y[s] = 0.0f;
  }

  auto len_of = [&](int c) { return min(lens[c], kk); };
  // the lanes' merge of one chunk's scan and lane 0's insertion
  auto finish = [&](float best, int bj, float bx, float by, bool scan) {
    lanes_min<kTopkLanes>(best, bj, bx, by);
    if (lane == 0 && scan && best <= nd2) topk_insert(best, bx, by, d, x, y);
  };
  // chunks per batch (kk <= kTopkStage), or pieces of one chunk
  const int per_batch = kk <= kTopkStage ? kTopkStage / kk : 1;

  for (int f0 = 0; f0 < f; f0 += kTopkThreads) {
    // each thread tests one chunk of the tile against the block's box; the
    // hits are listed in ascending order
    const int fi = f0 + tid;
    const bool hit = fi < f && touches(ccx[fi], ccy[fi],
                                       feature_reach2(rad[fi], nd), box);
    int nhit;
    const int at = hit_rank<kTopkThreads>(hit, wball, nhit);
    if (hit) hits[at] = fi;
    __syncthreads();

    for (int h0 = 0; h0 < nhit; h0 += per_batch) {
      const int nb = min(per_batch, nhit - h0);
      if (kk <= kTopkStage) {
        __syncthreads();  // the previous batch is consumed
        for (int e = tid; e < nb * kk; e += kTopkThreads) {
          const int b = e / kk;
          const int j = e - b * kk;
          const int c = hits[h0 + b];
          if (j < len_of(c)) {
            const size_t g = (size_t)c * kk + j;
            sxy[e] = make_float2(cxs[g], cys[g]);
          }
        }
        __syncthreads();
        for (int b = 0; b < nb; ++b) {
          const int c = hits[h0 + b];
          const int len = len_of(c);
          const bool scan =
              in && touches(ccx[c], ccy[c], feature_reach2(rad[c], nd), mine);
          float best = INFINITY, bx = 0.0f, by = 0.0f;
          int bj = INT_MAX;
          if (scan) {
            const float2* row = sxy + b * kk;
#pragma unroll 4
            for (int j = lane; j < len; j += kTopkLanes) {
              const float2 pt = row[j];
              closest_update_at(pt.x, pt.y, px, py, j, best, bj, bx, by);
            }
          }
          finish(best, bj, bx, by, scan);
        }
      } else {  // one chunk of more than kTopkStage slots, piece by piece
        const int c = hits[h0];
        const int len = len_of(c);
        const bool scan =
            in && touches(ccx[c], ccy[c], feature_reach2(rad[c], nd), mine);
        float best = INFINITY, bx = 0.0f, by = 0.0f;
        int bj = INT_MAX;
        for (int p0 = 0; p0 < len; p0 += kTopkStage) {
          const int cnt = min(kTopkStage, len - p0);
          __syncthreads();  // the previous piece is consumed
          for (int j = tid; j < cnt; j += kTopkThreads) {
            const size_t g = (size_t)c * kk + p0 + j;
            sxy[j] = make_float2(cxs[g], cys[g]);
          }
          __syncthreads();
          if (scan) {
            for (int j = lane; j < cnt; j += kTopkLanes) {
              const float2 pt = sxy[j];
              closest_update_at(pt.x, pt.y, px, py, p0 + j, best, bj, bx,
                                by);
            }
          }
        }
        finish(best, bj, bx, by, scan);
      }
    }
  }
  if (!in || lane != 0) return;
#pragma unroll
  for (int s = 0; s < kTopK; ++s) {
    if (s < k) {
      out_d2[(size_t)s * n + i] = d[s] < kPadDist2 ? d[s] : INFINITY;
      out_x[(size_t)s * n + i] = x[s];
      out_y[(size_t)s * n + i] = y[s];
    }
  }
}

__global__ void __launch_bounds__(kTopkThreads)
chunk_topk_kernel(const float* __restrict__ px_, const float* __restrict__ py_,
                  const uint8_t* __restrict__ alive_,
                  const float* __restrict__ cxs, const float* __restrict__ cys,
                  int f, int kk, const int* __restrict__ lens,
                  const float* __restrict__ ccx,
                  const float* __restrict__ ccy,
                  const float* __restrict__ rad, float nd, float nd2, int k,
                  int n, float* __restrict__ out_d2,
                  float* __restrict__ out_x, float* __restrict__ out_y) {
  chunk_topk_walk(px_, py_, alive_, cxs, cys, f, kk, lens, ccx, ccy, rad, nd,
                  nd2, k, n, out_d2, out_x, out_y);
}

// The chunk top-k of a batch of crowds, laid out as
// seg_topk_batched_kernel's.
__global__ void __launch_bounds__(kTopkThreads)
chunk_topk_batched_kernel(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const uint8_t* __restrict__ alive_, const float* __restrict__ cxs,
    const float* __restrict__ cys, int f, int kk,
    const int* __restrict__ lens, const float* __restrict__ ccx,
    const float* __restrict__ ccy, const float* __restrict__ rad, float nd,
    float nd2, const float* __restrict__ nd_rows,
    const float* __restrict__ nd2_rows, int k, int n,
    float* __restrict__ out_d2, float* __restrict__ out_x,
    float* __restrict__ out_y) {
  const int b = blockIdx.y;
  const size_t bo = (size_t)b * n;
  const size_t oo = bo * k;
  chunk_topk_walk(px_ + bo, py_ + bo, alive_ ? alive_ + bo : nullptr, cxs,
                  cys, f, kk, lens, ccx, ccy, rad,
                  nd_rows ? nd_rows[b] : nd, nd2_rows ? nd2_rows[b] : nd2, k,
                  n, out_d2 + oo, out_x + oo, out_y + oo);
}

// chunk_closest's body (chunk_closest_kernel, chunk_closest_batched_kernel):
// every chunk's first-occurrence closest point, as (f, n) planes d2 (inf
// beyond nd2, and for a chunk skipped by the block), wx, wy (0 for a
// skipped chunk); the chunks as chunk_topk_walk's.  Grid (pedestrian
// blocks, chunk splits): split y takes the chunks y, y + Y, ...  Its
// shared arrays are the calling kernel's own: as the body's statics they
// moved block_box's scratch in the unbatched kernel's layout and changed
// its SASS.
__device__ __forceinline__ void chunk_closest_walk(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const uint8_t* __restrict__ alive_, const float* __restrict__ cxs,
    const float* __restrict__ cys, int f, int kk,
    const int* __restrict__ lens, const float* __restrict__ ccx,
    const float* __restrict__ ccy, const float* __restrict__ rad, float nd,
    float nd2, int n, float* __restrict__ out_d2,
    float* __restrict__ out_x, float* __restrict__ out_y, float2* sxy,
    int* hits, int* hlen, unsigned* wball,
    float (*res)[kClosestBatch][kClosestPeds]) {
  constexpr int L = kClosestLanes;
  constexpr int T = kClosestThreads;
  constexpr int P = kClosestPeds;

  const int tid = threadIdx.x;
  const int lane = tid % L;  // this pedestrian's lane
  const int ped = tid / L;
  const int r0 = blockIdx.x * P;  // the block's first row
  const int i = r0 + ped;
  const bool in = i < n;
  const bool live = in && (alive_ == nullptr || alive_[i] != 0);
  const float px = in ? px_[i] : 0.0f;
  const float py = in ? py_[i] : 0.0f;
  const Box box = block_box<T>(px, py, live);

  const int ys = gridDim.y;
  const int y0 = blockIdx.y;
  const int m = y0 < f ? (f - y0 + ys - 1) / ys : 0;  // this split's chunks
  const int row = r0 + tid % 32;  // a lane's row in a warp's store of 32
  // hit chunks per batch (kk <= kClosestStage), or pieces of one chunk
  const int per_batch =
      kk <= kClosestStage ? min(kClosestBatch, kClosestStage / max(kk, 1)) : 1;

  for (int j0 = 0; j0 < m; j0 += T) {
    // each thread tests one chunk of the tile against the block's box; the
    // hits are listed in ascending order
    const int j = j0 + tid;
    const int c = y0 + ys * j;
    bool hit = false;
    int len = 0;
    if (j < m) {
      hit = touches(ccx[c], ccy[c], feature_reach2(rad[c], nd), box);
      len = min(lens[c], kk);
    }
    int nhit;
    const int at = hit_rank<T>(hit, wball, nhit);
    if (hit) {
      hits[at] = c;
      hlen[at] = len;
    }
    // the skipped chunks' rows, warp w the tile's chunks w, w + T / 32, ...
    const int cnt = min(T, m - j0);
    for (int t = tid / 32; t < cnt; t += T / 32) {
      if (!((wball[t / 32] >> (t % 32)) & 1u) && row < n) {
        const size_t g = (size_t)(y0 + ys * (j0 + t)) * n + row;
        out_d2[g] = INFINITY;
        out_x[g] = 0.0f;
        out_y[g] = 0.0f;
      }
    }

    for (int h0 = 0; h0 < nhit; h0 += per_batch) {
      const int nb = min(per_batch, nhit - h0);
      __syncthreads();  // the list is written; the previous batch is stored
      if (kk <= kClosestStage) {
        for (int e = tid; e < nb * kk; e += T) {
          const int b = e / kk;
          const int s = e - b * kk;
          if (s < hlen[h0 + b]) {
            const size_t g = (size_t)hits[h0 + b] * kk + s;
            sxy[e] = make_float2(cxs[g], cys[g]);
          }
        }
        __syncthreads();
        for (int b = 0; b < nb; ++b) {
          const int hl = hlen[h0 + b];
          const float2* pts = sxy + b * kk;
          float best = INFINITY;
          int bj = INT_MAX;
#pragma unroll 4
          for (int s = lane; s < hl; s += L) {
            const float2 pt = pts[s];
            argmin_step(pt.x, pt.y, px, py, s, best, bj);
          }
          lanes_min_slot<L>(best, bj);
          if (lane == 0) {
            const float2 w = bj < hl ? pts[bj] : make_float2(0.0f, 0.0f);
            res[0][b][ped] = best <= nd2 ? best : INFINITY;
            res[1][b][ped] = w.x;
            res[2][b][ped] = w.y;
          }
        }
      } else {  // one chunk of more than kClosestStage slots, piece by piece
        const int hl = hlen[h0];
        const size_t base = (size_t)hits[h0] * kk;
        float best = INFINITY;
        int bj = INT_MAX;
        for (int p0 = 0; p0 < hl; p0 += kClosestStage) {
          const int pc = min(kClosestStage, hl - p0);
          __syncthreads();  // the previous piece is consumed
          for (int s = tid; s < pc; s += T)
            sxy[s] = make_float2(cxs[base + p0 + s], cys[base + p0 + s]);
          __syncthreads();
          for (int s = lane; s < pc; s += L) {
            const float2 pt = sxy[s];
            argmin_step(pt.x, pt.y, px, py, p0 + s, best, bj);
          }
        }
        lanes_min_slot<L>(best, bj);
        if (lane == 0) {
          const bool any = bj < hl;
          res[0][0][ped] = best <= nd2 ? best : INFINITY;
          res[1][0][ped] = any ? cxs[base + bj] : 0.0f;
          res[2][0][ped] = any ? cys[base + bj] : 0.0f;
        }
      }
      __syncthreads();
      // the batch's rows of 32 pedestrians
      for (int e = tid; e < nb * P; e += T) {
        const int b = e / P;
        const int q = e - b * P;
        if (r0 + q < n) {
          const size_t g = (size_t)hits[h0 + b] * n + r0 + q;
          out_d2[g] = res[0][b][q];
          out_x[g] = res[1][b][q];
          out_y[g] = res[2][b][q];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kClosestThreads)
chunk_closest_kernel(const float* __restrict__ px_,
                     const float* __restrict__ py_,
                     const uint8_t* __restrict__ alive_,
                     const float* __restrict__ cxs,
                     const float* __restrict__ cys, int f, int kk,
                     const int* __restrict__ lens,
                     const float* __restrict__ ccx,
                     const float* __restrict__ ccy,
                     const float* __restrict__ rad, float nd, float nd2,
                     int n, float* __restrict__ out_d2,
                     float* __restrict__ out_x, float* __restrict__ out_y) {
  __shared__ __align__(16) float2 sxy[kClosestStage];
  __shared__ int hits[kClosestThreads], hlen[kClosestThreads];
  __shared__ unsigned wball[kClosestThreads / 32];
  __shared__ float res[3][kClosestBatch][kClosestPeds];
  chunk_closest_walk(px_, py_, alive_, cxs, cys, f, kk, lens, ccx, ccy, rad,
                     nd, nd2, n, out_d2, out_x, out_y, sxy, hits, hlen, wball,
                     res);
}

// chunk_closest of a batch of crowds of n pedestrians on the grid's third
// axis: crowd blockIdx.z's planes and alive mask at blockIdx.z * n, its
// (f, n) planes of the (B, f, n) outputs at blockIdx.z * f * n, its
// neighbour distance and square as seg_topk_batched_kernel reads them.
__global__ void __launch_bounds__(kClosestThreads)
chunk_closest_batched_kernel(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const uint8_t* __restrict__ alive_, const float* __restrict__ cxs,
    const float* __restrict__ cys, int f, int kk,
    const int* __restrict__ lens, const float* __restrict__ ccx,
    const float* __restrict__ ccy, const float* __restrict__ rad, float nd,
    float nd2, const float* __restrict__ nd_rows,
    const float* __restrict__ nd2_rows, int n, float* __restrict__ out_d2,
    float* __restrict__ out_x, float* __restrict__ out_y) {
  __shared__ __align__(16) float2 sxy[kClosestStage];
  __shared__ int hits[kClosestThreads], hlen[kClosestThreads];
  __shared__ unsigned wball[kClosestThreads / 32];
  __shared__ float res[3][kClosestBatch][kClosestPeds];
  const int b = blockIdx.z;
  const size_t bo = (size_t)b * n;
  const size_t oo = bo * f;
  chunk_closest_walk(px_ + bo, py_ + bo, alive_ ? alive_ + bo : nullptr, cxs,
                     cys, f, kk, lens, ccx, ccy, rad,
                     nd_rows ? nd_rows[b] : nd, nd2_rows ? nd2_rows[b] : nd2,
                     n, out_d2 + oo, out_x + oo, out_y + oo, sxy, hits, hlen,
                     wball, res);
}

// cp.async of 4 or 16 bytes from global into shared memory, and its group
// fences
__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The geometry of chunk_argmin's stages: the (c, kk) rows padded to kkp
// slots in shared memory; a group is cps whole chunks (kkp <= kArgminStage)
// or one chunk in ppc pieces of kArgminStage points.
struct ArgminStages {
  int kk, kkp, cps, ppc, groups;
  __host__ __device__ ArgminStages(int c, int kk_) : kk(kk_) {
    kkp = (kk + 3) & ~3;
    cps = kkp <= kArgminStage ? kArgminStage / kkp : 1;
    ppc = kkp <= kArgminStage ? 1 : (kk + kArgminStage - 1) / kArgminStage;
    groups = (c + cps - 1) / cps;
  }
};

// Every (chunk, pedestrian)'s minimum squared distance over the chunk's kk
// points of the staged planes fx, fy ((c, kk), PAD_COORD in invalid slots)
// and the flat index chunk * kk + j of the first point that reaches it.
// Grid: (pedestrian blocks of kArgminThreads * kArgminRows, chunk splits);
// split y takes groups [y * groups / Y, (y + 1) * groups / Y).  vec: the
// planes' rows can be copied 16 bytes at a time (kk % 4 == 0, aligned).
// The walk body: chunk_argmin_kernel runs it on its arguments, the
// per-crowd kernel on its crowd's pointers; the two stages sx, sy are the
// kernel's own shared arrays (as function statics they would move, and
// the unbatched kernel's SASS with them).
__device__ __forceinline__ void chunk_argmin_walk(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const float* __restrict__ fx, const float* __restrict__ fy, int c,
    int kk, int n, int vec, float* __restrict__ out_d2,
    int* __restrict__ out_idx, float (*sx)[kArgminStage],
    float (*sy)[kArgminStage]) {
  constexpr int R = kArgminRows;
  constexpr int T = kArgminThreads;

  const ArgminStages g(c, kk);
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * T * R + tid;  // row r: i0 + r * T
  float px[R], py[R], best[R];
  int arg[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T;
    px[r] = i < n ? px_[i] : 0.0f;
    py[r] = i < n ? py_[i] : 0.0f;
    best[r] = INFINITY;
    arg[r] = 0;
  }
  const int g0 = (int)((long long)blockIdx.y * g.groups / gridDim.y);
  const int g1 = (int)((long long)(blockIdx.y + 1) * g.groups / gridDim.y);
  const int nst = (g1 - g0) * g.ppc;  // stages of this block

  // stage q's chunks [ch0, ch0 + nch) and slots [p0, p0 + len) of each
  auto stage_of = [&](int q, int& ch0, int& nch, int& p0, int& len) {
    const int grp = g0 + q / g.ppc;
    const int piece = q % g.ppc;
    ch0 = grp * g.cps;
    nch = min(g.cps, c - ch0);
    p0 = piece * kArgminStage;
    len = min(kk - p0, kArgminStage);
  };
  auto load = [&](int q) {
    int ch0, nch, p0, len;
    stage_of(q, ch0, nch, p0, len);
    float* dx = sx[q & 1];
    float* dy = sy[q & 1];
    if (vec) {
      const int quads = len / 4;
      for (int e = tid; e < nch * quads; e += T) {
        const int t = e / quads;
        const int j = 4 * (e - t * quads);
        const size_t src = (size_t)(ch0 + t) * kk + p0 + j;
        cp_async16(dx + t * g.kkp + j, fx + src);
        cp_async16(dy + t * g.kkp + j, fy + src);
      }
    } else {
      for (int e = tid; e < nch * len; e += T) {
        const int t = e / len;
        const int j = e - t * len;
        const size_t src = (size_t)(ch0 + t) * kk + p0 + j;
        cp_async4(dx + t * g.kkp + j, fx + src);
        cp_async4(dy + t * g.kkp + j, fy + src);
      }
    }
  };

  if (nst > 0) load(0);
  cp_async_commit();
  for (int q = 0; q < nst; ++q) {
    if (q + 1 < nst) load(q + 1);
    cp_async_commit();
    cp_async_wait_one();  // stage q has landed (for this thread)
    __syncthreads();      // ... and for every thread
    int ch0, nch, p0, len;
    stage_of(q, ch0, nch, p0, len);
    for (int t = 0; t < nch; ++t) {
      const float* rx = sx[q & 1] + t * g.kkp;
      const float* ry = sy[q & 1] + t * g.kkp;
      // whole 32-point sub-groups four points a load, then the tail
      const int full = len / kArgminSub * kArgminSub;
      for (int s0 = 0; s0 < full; s0 += kArgminSub) {
#pragma unroll
        for (int u = 0; u < kArgminSub; u += 4) {
          const float4 X = *reinterpret_cast<const float4*>(rx + s0 + u);
          const float4 Y = *reinterpret_cast<const float4*>(ry + s0 + u);
          const int j = p0 + s0 + u;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            argmin_step(X.x, Y.x, px[r], py[r], j, best[r], arg[r]);
            argmin_step(X.y, Y.y, px[r], py[r], j + 1, best[r], arg[r]);
            argmin_step(X.z, Y.z, px[r], py[r], j + 2, best[r], arg[r]);
            argmin_step(X.w, Y.w, px[r], py[r], j + 3, best[r], arg[r]);
          }
        }
      }
      for (int j = full; j < len; ++j) {
        const float x = rx[j], y = ry[j];
#pragma unroll
        for (int r = 0; r < R; ++r)
          argmin_step(x, y, px[r], py[r], p0 + j, best[r], arg[r]);
      }
      if (p0 + len == kk) {  // the chunk's last piece: its result
        const int ch = ch0 + t;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = i0 + r * T;
          if (i < n) {
            out_d2[(size_t)ch * n + i] = best[r];
            out_idx[(size_t)ch * n + i] = ch * kk + arg[r];
          }
          best[r] = INFINITY;
          arg[r] = 0;
        }
      }
    }
    __syncthreads();  // buffer q & 1 is consumed before stage q + 2 fills it
  }
}

__global__ void __launch_bounds__(kArgminThreads)
chunk_argmin_kernel(const float* __restrict__ px_,
                    const float* __restrict__ py_,
                    const float* __restrict__ fx,
                    const float* __restrict__ fy, int c, int kk, int n,
                    int vec, float* __restrict__ out_d2,
                    int* __restrict__ out_idx) {
  __shared__ __align__(16) float sx[2][kArgminStage];
  __shared__ __align__(16) float sy[2][kArgminStage];
  chunk_argmin_walk(px_, py_, fx, fy, c, kk, n, vec, out_d2, out_idx, sx,
                    sy);
}

// chunk_argmin of a batch of crowds that each scan their own chunks (a
// batch of fleets' vehicle outlines; the JAX package's _cp_kernel under
// vmap with batched chunks), crowd blockIdx.z (y is the chunk split, as in
// the unbatched grid): its n pedestrians at blockIdx.z * n, its (c, kk)
// staged planes at blockIdx.z * c * kk and its (c, n) outputs at
// blockIdx.z * c * n.  A block holds one crowd's pedestrians only, so
// crowd b's results are the unbatched launch's on its own planes.
__global__ void __launch_bounds__(kArgminThreads)
chunk_argmin_percrowd_kernel(const float* __restrict__ px_,
                             const float* __restrict__ py_,
                             const float* __restrict__ fx,
                             const float* __restrict__ fy, int c, int kk,
                             int n, int vec, float* __restrict__ out_d2,
                             int* __restrict__ out_idx) {
  __shared__ __align__(16) float sx[2][kArgminStage];
  __shared__ __align__(16) float sy[2][kArgminStage];
  const size_t b = blockIdx.z;
  const size_t po = b * (size_t)c * kk;
  const size_t oo = b * (size_t)c * n;
  chunk_argmin_walk(px_ + b * n, py_ + b * n, fx + po, fy + po, c, kk, n,
                    vec, out_d2 + oo, out_idx + oo, sx, sy);
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
  const int blocks = (n + kSegPeds - 1) / kSegPeds;
  auto kernel = k <= kSegSlotsSmall ? seg_topk_kernel<kSegSlotsSmall>
                                    : seg_topk_kernel<kTopK>;
  kernel<<<blocks, kSegThreads, 0, (cudaStream_t)stream>>>(
      px, py, alive, ax, ay, ux, uy, il2, ccx, ccy, rad, f, nd, nd2, k, n, d2,
      wx, wy);
  return (int)cudaGetLastError();
}

// x, y (c, kk) chunk point planes, PAD_COORD in invalid slots; lens (c,)
// the slots up to each chunk's last valid one; cx, cy, rad (c,) chunk
// circles (rad < 0: an empty chunk).
int sfm_chunk_topk(const float* px, const float* py, const uint8_t* alive,
                   const float* x, const float* y, int c, int kk,
                   const int* lens, const float* cx, const float* cy,
                   const float* rad, float nd, float nd2, int k, int n,
                   float* d2, float* wx, float* wy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kTopK) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kTopkPeds - 1) / kTopkPeds;
  chunk_topk_kernel<<<blocks, kTopkThreads, 0, (cudaStream_t)stream>>>(
      px, py, alive, x, y, c, kk, lens, cx, cy, rad, nd, nd2, k, n, d2, wx,
      wy);
  return (int)cudaGetLastError();
}

int sfm_chunk_closest(const float* px, const float* py, const uint8_t* alive,
                      const float* x, const float* y, int c, int kk,
                      const int* lens, const float* cx, const float* cy,
                      const float* rad, float nd, float nd2, int n, float* d2,
                      float* wx, float* wy, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  int sms = 0;
  const cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const int ped_blocks = (n + kClosestPeds - 1) / kClosestPeds;
  const int want = (kClosestBlocksPerSM * sms + ped_blocks - 1) / ped_blocks;
  const int splits = max(1, min(c, want));
  chunk_closest_kernel<<<dim3(ped_blocks, splits), kClosestThreads, 0,
                         (cudaStream_t)stream>>>(px, py, alive, x, y, c, kk,
                                                 lens, cx, cy, rad, nd, nd2,
                                                 n, d2, wx, wy);
  return (int)cudaGetLastError();
}

// The batched entries: batch crowds of n pedestrians, planes and alive
// (batch, n) row-major, one set of features or chunks; nd_rows and nd2_rows
// (batch,) each crowd's neighbour distance and its float32 square, or null
// (nd and nd2 for every crowd: an ensemble).  Outputs (batch, k, n) for the
// top-k entries, (batch, c, n) for sfm_chunk_closest_batched.
int sfm_seg_topk_batched(const float* px, const float* py,
                         const uint8_t* alive, const float* ax,
                         const float* ay, const float* ux, const float* uy,
                         const float* il2, const float* ccx, const float* ccy,
                         const float* rad, int f, float nd, float nd2,
                         const float* nd_rows, const float* nd2_rows, int k,
                         int n, int batch, float* d2, float* wx, float* wy,
                         void* stream) {
  if (n <= 0 || batch == 0) return (int)cudaSuccess;
  if (k < 1 || k > kTopK || batch < 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kSegPeds - 1) / kSegPeds, batch);
  auto kernel = k <= kSegSlotsSmall ? seg_topk_batched_kernel<kSegSlotsSmall>
                                    : seg_topk_batched_kernel<kTopK>;
  kernel<<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(
      px, py, alive, ax, ay, ux, uy, il2, ccx, ccy, rad, f, nd, nd2, nd_rows,
      nd2_rows, k, n, d2, wx, wy);
  return (int)cudaGetLastError();
}

int sfm_chunk_topk_batched(const float* px, const float* py,
                           const uint8_t* alive, const float* x,
                           const float* y, int c, int kk, const int* lens,
                           const float* cx, const float* cy, const float* rad,
                           float nd, float nd2, const float* nd_rows,
                           const float* nd2_rows, int k, int n, int batch,
                           float* d2, float* wx, float* wy, void* stream) {
  if (n <= 0 || batch == 0) return (int)cudaSuccess;
  if (k < 1 || k > kTopK || batch < 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTopkPeds - 1) / kTopkPeds, batch);
  chunk_topk_batched_kernel<<<grid, kTopkThreads, 0, (cudaStream_t)stream>>>(
      px, py, alive, x, y, c, kk, lens, cx, cy, rad, nd, nd2, nd_rows,
      nd2_rows, k, n, d2, wx, wy);
  return (int)cudaGetLastError();
}

int sfm_chunk_closest_batched(const float* px, const float* py,
                              const uint8_t* alive, const float* x,
                              const float* y, int c, int kk, const int* lens,
                              const float* cx, const float* cy,
                              const float* rad, float nd, float nd2,
                              const float* nd_rows, const float* nd2_rows,
                              int n, int batch, float* d2, float* wx,
                              float* wy, void* stream) {
  if (n <= 0 || c <= 0 || batch == 0) return (int)cudaSuccess;
  if (batch < 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  // the splits aim at kClosestBlocksPerSM blocks per SM over all crowds
  const long long blocks = (long long)((n + kClosestPeds - 1) / kClosestPeds)
                           * batch;
  const int want =
      (int)((kClosestBlocksPerSM * (long long)sms + blocks - 1) / blocks);
  const int splits = max(1, min(c, want));
  chunk_closest_batched_kernel<<<
      dim3((n + kClosestPeds - 1) / kClosestPeds, splits, batch),
      kClosestThreads, 0, (cudaStream_t)stream>>>(
      px, py, alive, x, y, c, kk, lens, cx, cy, rad, nd, nd2, nd_rows,
      nd2_rows, n, d2, wx, wy);
  return (int)cudaGetLastError();
}

// fx, fy (c, kk) staged chunk planes (PAD_COORD in invalid slots); d2 (c, n)
// f32 and idx (c, n) i32 outputs.
int sfm_chunk_argmin(const float* px, const float* py, const float* fx,
                     const float* fy, int c, int kk, int n, float* d2,
                     int* idx, void* stream) {
  if (n <= 0 || c <= 0 || kk <= 0) return (int)cudaSuccess;
  int sms = 0;
  const cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const ArgminStages g(c, kk);
  const int ped_blocks =
      (n + kArgminThreads * kArgminRows - 1) / (kArgminThreads * kArgminRows);
  const int want = (kArgminBlocksPerSM * sms + ped_blocks - 1) / ped_blocks;
  const int splits = max(1, min(g.groups, want));
  const int vec = kk % 4 == 0 && ((uintptr_t)fx % 16) == 0 &&
                  ((uintptr_t)fy % 16) == 0;
  chunk_argmin_kernel<<<dim3(ped_blocks, splits), kArgminThreads, 0,
                        (cudaStream_t)stream>>>(px, py, fx, fy, c, kk, n, vec,
                                                d2, idx);
  return (int)cudaGetLastError();
}

// The per-crowd scan: px, py (batch, n); fx, fy (batch, c, kk) each crowd's
// staged chunk planes; d2, idx (batch, c, n), crowd b's flat indices into
// its own (c, kk) planes.  The splits aim at kArgminBlocksPerSM blocks per
// SM over all crowds.
int sfm_chunk_argmin_percrowd(const float* px, const float* py,
                              const float* fx, const float* fy, int c,
                              int kk, int n, int batch, float* d2, int* idx,
                              void* stream) {
  if (n <= 0 || c <= 0 || kk <= 0 || batch == 0) return (int)cudaSuccess;
  if (batch < 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const ArgminStages g(c, kk);
  const long long ped_blocks =
      (n + kArgminThreads * kArgminRows - 1) / (kArgminThreads * kArgminRows);
  const long long blocks = ped_blocks * batch;
  const int want =
      (int)((kArgminBlocksPerSM * (long long)sms + blocks - 1) / blocks);
  const int splits = max(1, min(g.groups, want));
  const int vec = kk % 4 == 0 && ((uintptr_t)fx % 16) == 0 &&
                  ((uintptr_t)fy % 16) == 0;
  chunk_argmin_percrowd_kernel<<<dim3((unsigned)ped_blocks, splits, batch),
                                 kArgminThreads, 0, (cudaStream_t)stream>>>(
      px, py, fx, fy, c, kk, n, vec, d2, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
