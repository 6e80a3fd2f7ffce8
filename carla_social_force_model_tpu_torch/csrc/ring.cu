// The in-kernel ring of the pair force under agent sharding, for Hopper
// (sm_90a), with a plain C interface for ctypes (ops/cuda_ring.py binds it).
// It replaces the JAX package's _ring_kernel (ops/pallas_ring.py:65, wrapper
// :199): every device's rows against all D column blocks, the column block
// rotating around the ring from device to device inside one kernel.  Its
// plain PyTorch version is the plain ring (ops/cuda_ring.py::
// ring_force_plain: ops/forces.py's rectangular pair forces, block by block).
//
// One card holds all D virtual devices in one address space, so one launch
// covers them all: blockIdx.y is the device, and its gridDim.x blocks share
// its rows.  Each device has a two-slot buffer of column blocks.  At ring
// step k a device computes against the block it holds (its own columns at
// step 0, its slot k % 2 after) and, before that, forwards the block into
// its right neighbour's other slot, (k + 1) % 2, as the TPU kernel forwards
// block k by a remote copy into its neighbour's other VMEM slot.  Device d
// therefore holds the block of device (d - k) mod D at step k.  The block's
// per-tile boxes travel with it (the last 4 * n_col_tiles floats of a slot).
//
// Flow control, by two counters per (device, slot) in device memory, which
// the wrapper zeroes on the stream before each launch (the TPU kernel drains
// its semaphores to zero instead, pallas_ring.py:12-18):
//   * fill: each block of the left neighbour adds 1 once its share of a
//     forwarded block has landed in the slot (data stores, __threadfence,
//     then a release add).  Step k >= 1 reads slot k % 2 once all G blocks
//     of the sender have filled it for the ((k + 1) / 2)-th time (acquire
//     loads), the TPU kernel's receive semaphore.
//   * done: each block of the device adds 1 once it has computed against
//     slot k % 2 with all of its row sets and forwarded it (steps k >= 1).
//     A sender at step k >= 2 writes into its neighbour's slot (k + 1) % 2
//     only after the neighbour has finished with it at step k - 1, i.e.
//     after k / 2 uses by all G blocks: the TPU kernel's credit.
// Both counters count blocks, not row sets: a block forwards its share of
// a column block (every G-th 256-float piece of the slot, G the blocks of
// a device) once per step and signals once per step, however many row
// sets it walks, so the targets G * ((k + 1) / 2) and G * (k / 2) hold for
// any G.  Blocks that spin on a neighbour must never wait for a block that
// has not been scheduled, so the launch is cooperative: the grid holds at
// most as many blocks as the card keeps resident (the occupancy
// calculator): one block per 32 * R-row set where they fit, else that many
// blocks, each walking the row sets blockIdx.x, blockIdx.x + G, ... of its
// device (kMulti), so any shard that fits in memory runs.  Every spin is
// bounded: on overrun a block sets the error word and exits, every other
// spin then stops too, and the wrapper raises.
//
// What bounds it on this card.  The pairs: each device's n_local rows meet
// all N = D * n_local columns, N^2 pairs in all without a cutoff (each at the
// cost of the dense kernels', pair_forces.cu), beside which the bytes of the
// D * (D - 1) block copies are small.  What the design does about it: the
// dense walk's inner loop (pair_laws.cuh rows_vs_chunk: R rows per thread
// in registers, 256-column tiles staged as float4 + float2 and
// read by broadcast, the block's eight warps sharing each tile, and
// with a cutoff the chunk culling and the ballot), each row's sums kept
// across all D steps, so the forces are written once, at the end; with a
// cutoff a column tile is skipped when the row set's box misses its box.
// Blocks must all be resident (the spins), so the grid cannot split a
// row's columns over blocks as the dense walk does.  A block with one row
// set keeps its rows' sums in registers across all D steps; with several
// (kMulti: more than 32 R rows per resident block of a device, 3,168
// agents per device at D = 4 with R = 1 on 132 SMs) a block walks them in
// turn at every step and keeps each one's per-warp sums between steps in
// its own slice of a global accumulator (acc), which no other block
// touches.  Every row is summed in one fixed order whatever the number of
// row sets a block walks (each warp's chunk over the ring steps, tiles and
// columns, then the warps in order): a float stored and loaded again is
// the same float, so the grid never changes a result.  Data of the
// rotating block is read and written through L2 (__ldcg / __stcg): L1 is
// not coherent across SMs.  Copies across cards (peer pointers) are later
// work.
//
// A batch of crowds (ring_force_batched_kernel, entry sfm_ring_force_batched:
// the JAX package's _ring_kernel under vmap, a batch sharded over a 2-D
// (batch, agents) mesh) runs B rings of D devices in the same launch, every
// crowd with its own column blocks, slots and counters, through a body of
// its own (ring_batch_walk, below ring_force_kernel).  The items of a
// device are its (crowd, group) pairs, a group being `sets` consecutive
// 32-row sets (1-8, from the shapes), item b * groups + s on block (b *
// groups + s) mod G: crowd b's groups sit on min(groups, G) blocks of each
// device, the same blocks on every device, which alone forward crowd b's
// blocks and count in crowd b's counters.  Every block walks its crowds in
// ascending order, a crowd's D ring steps in order before the next crowd's
// (kMulti: ring step by ring step, its crowds in order at each step).  So
// a block waits only on a (crowd, step) that comes earlier in that order,
// on blocks of other devices that walk that crowd too; the earliest
// (crowd, step) that any block has not finished can always go on, as
// every block is resident: no block waits for a crowd its neighbour
// reaches later.  (With one group a crowd and more crowds than blocks, a
// device's blocks take its crowds in ascending order from a counter as
// they come free, which keeps that argument.)  A crowd's rows are summed
// in the unbatched kernel's order (each 32-column chunk slot over the ring
// steps, tiles and columns, then the slots in order), so crowd b's forces
// equal the unbatched launch on crowd b bitwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "pair_laws.cuh"

namespace {

// The dense walk's layout (pair_laws.cuh): R = kRingRows rows per thread,
// a row set of 32 * R rows, and the block's eight warps share each staged
// tile, one 32-column chunk each (PERF.md: 4, 8 and 16 warps measured; 16
// keep too few blocks resident for N = 10,000 under the power law and
// Helbing).  kRingMinBlocks blocks stay resident an SM (at most 80
// registers a thread; with a minimum of 1 block ptxas gave R = 1 96
// registers and the ring 1.45x its time at N = 10,000, PERF.md), so one
// row set per block covers 3 x 132 x 32 R agents over all devices; beyond
// that the blocks loop over row sets.
constexpr int kRingRows = 1;
constexpr int kRingMinBlocks = 3;
constexpr int kThreads = 32 * kTileChunks;
constexpr bool kRingFastTail = true;  // as the dense walks
constexpr int kPlanes = 6;    // x, y, vx, vy, radius, alive (0 or 1)
constexpr long long kSpinLimit = 1LL << 26;

struct RingArgs {
  int n_dev, n_local, n_col_tiles, slot;  // slot: floats per column block
  // the rows of every device, (n_dev * n_local,) each; (u, v) = v, or e
  const float* rx;
  const float* ry;
  const float* ru;
  const float* rv;
  const float* rrad;
  const uint8_t* ralive;
  const float* cols;  // (n_dev, slot): each device's own block
  float* comm;        // (n_dev, 2, slot)
  int* fill;          // (n_dev, 2)
  int* done;          // (n_dev, 2)
  int* err;           // (1,)
  float* acc;         // per row set: kTileChunks x 2 x 32 R floats
  const float* prm;
  int use_radius;
  float c2;
  float* fx;          // (n_dev * n_local,)
  float* fy;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Thread 0 spins until *p >= want (or the error word is set, or the spin
// overruns: then it sets the error word); the block then learns the
// outcome.  Every thread of the block must call it.
__device__ bool wait_at_least(const int* p, int want, int* err,
                              int* s_ok) {
  if (threadIdx.x == 0) {
    int ok = 1;
    long long spins = 0;
    while (ld_acquire(p) < want) {
      if (ld_acquire(err) != 0) {
        ok = 0;
        break;
      }
      if (++spins > kSpinLimit) {
        atomicExch(err, 1);
        ok = 0;
        break;
      }
      __nanosleep(64);
    }
    __threadfence();
    *s_ok = ok;
  }
  __syncthreads();
  const bool ok = *s_ok != 0;
  __syncthreads();  // s_ok may be written again by the next wait
  return ok;
}

// One crowd's ring on device blockIdx.y: block blockIdx.x walks the row
// sets rank, rank + P, ... of the device (P = G, rank = blockIdx.x in the
// unbatched kernel), and the crowd's P blocks of each device forward its
// column blocks and count in its counters.  a's pointers are the crowd's.
// kMulti: the blocks walk several row sets each (keeping their sums in
// acc); else one row set a block, its sums in registers.  False: a wait
// failed (the error word is set).
template <bool kCutoff, class Law, int kR, bool kMulti>
__device__ __forceinline__ bool ring_walk(const RingArgs& a,
                                          const typename Law::Prm& p,
                                          unsigned rank, int P) {
  constexpr int kBlockRows = 32 * kR;
  __shared__ ColTile tile;
  __shared__ float part_x[kTileChunks][kBlockRows];
  __shared__ float part_y[kTileChunks][kBlockRows];
  __shared__ int s_ok;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;  // and the chunk of each tile it walks
  const int d = blockIdx.y;
  const int D = a.n_dev;
  const int G = gridDim.x;
  const int n = a.n_local;
  const int right = (d + 1) % D;
  const int base = d * n;  // this device's first row
  // this block's row sets: rank + q * G for q < sets
  const int nsets = (n + kBlockRows - 1) / kBlockRows;
  const int sets = kMulti ? (nsets - (int)rank + G - 1) / G : 1;
  constexpr bool keep = !kMulti;  // the sums stay in registers

  // a row set's rows, R per lane, in registers (every warp holds them all),
  // its box, and this warp's slice of the accumulator
  RowSet<kR> rw;
  float bx0 = INFINITY, bx1 = -INFINITY, by0 = INFINITY, by1 = -INFINITY;
  auto load_rows = [&](int set) {
    const int i_blk = set * kBlockRows;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = i_blk + lane + 32 * r;
      const bool in = i < n;
      rw.template load<kCutoff>(
          r, in ? a.rx[base + i] : 0.0f, in ? a.ry[base + i] : 0.0f,
          in ? a.ru[base + i] : 0.0f, in ? a.rv[base + i] : 0.0f,
          (in && Law::kRadius) ? a.rrad[base + i] : 0.0f,
          in && a.ralive[base + i] != 0, base + i);
    }
    if (kCutoff) {  // the row set's box
      bx0 = INFINITY, bx1 = -INFINITY, by0 = INFINITY, by1 = -INFINITY;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        bx0 = fminf(bx0, rw.box[r][0]);
        bx1 = fmaxf(bx1, rw.box[r][1]);
        by0 = fminf(by0, rw.box[r][2]);
        by1 = fmaxf(by1, rw.box[r][3]);
      }
    }
  };
  auto acc_of = [&](int set) {
    return a.acc + (((long long)d * nsets + set) * kTileChunks + warp) * 2 *
                       kBlockRows;
  };
  if (keep) load_rows(rank);

  const int nct = a.n_col_tiles;
  for (int k = 0; k < D; ++k) {
    const int src = ((d - k) % D + D) % D;  // the block's home device
    const float* blk =
        k == 0 ? a.cols + (long long)d * a.slot
               : a.comm + ((long long)d * 2 + (k & 1)) * a.slot;
    if (k > 0 && !wait_at_least(&a.fill[d * 2 + (k & 1)], P * ((k + 1) / 2),
                                a.err, &s_ok))
      return false;
    if (k < D - 1) {
      // forward this block (and its boxes) into the right neighbour's other
      // slot, once the neighbour is done with that slot's previous block:
      // this block's share is every P-th piece from its rank
      const int dst_slot = (k + 1) & 1;
      if (k >= 2 && !wait_at_least(&a.done[right * 2 + dst_slot],
                                   P * (k / 2), a.err, &s_ok))
        return false;
      float* dst = a.comm + ((long long)right * 2 + dst_slot) * a.slot;
      for (long long e = (long long)rank * kThreads + tid; e < a.slot;
           e += (long long)P * kThreads)
        __stcg(dst + e, __ldcg(blk + e));
      __threadfence();
      __syncthreads();
      if (tid == 0) add_release(&a.fill[right * 2 + dst_slot], 1);
    }

    const float* bb = blk + kPlanes * n;  // (4, n_col_tiles) boxes
    const int g_src = src * n;
    for (int q = 0; q < sets; ++q) {
      float* acc = nullptr;
      if (!keep) {  // this row set's sums so far
        load_rows(rank + q * G);
        acc = acc_of(rank + q * G);
        if (k > 0) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            rw.ax[r] = acc[lane + 32 * r];
            rw.ay[r] = acc[kBlockRows + lane + 32 * r];
          }
        }
      }
      for (int t = 0; t < nct; ++t) {
        if (kCutoff &&  // block-uniform
            box_gap2(bx0, bx1, by0, by1, __ldcg(bb + t), __ldcg(bb + nct + t),
                     __ldcg(bb + 2 * nct + t),
                     __ldcg(bb + 3 * nct + t)) > a.c2)
          continue;
        const int j0 = t * kColTile;
        __syncthreads();  // the previous column tile is consumed
        for (int c = tid; c < kColTile; c += kThreads) {
          const int j = j0 + c;
          const bool in = j < n;
          stage_column<kCutoff>(
              tile, c, in ? __ldcg(blk + j) : 0.0f,
              in ? __ldcg(blk + n + j) : 0.0f,
              in ? __ldcg(blk + 2 * n + j) : 0.0f,
              in ? __ldcg(blk + 3 * n + j) : 0.0f,
              in ? __ldcg(blk + 4 * n + j) : 0.0f,
              in && __ldcg(blk + 5 * n + j) != 0.0f);
        }
        __syncthreads();
        const int jc = j0 + warp * kChunk;
        if (jc < n)
          rows_vs_chunk<kCutoff, kRingFastTail, Law, kR>(
              rw, tile, warp, min(kChunk, n - jc), g_src + jc, p,
              a.use_radius, a.c2);
      }
      if (!keep) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          acc[lane + 32 * r] = rw.ax[r];
          acc[kBlockRows + lane + 32 * r] = rw.ay[r];
        }
      }
    }
    if (k > 0) {
      // this block has computed against slot k % 2 and forwarded it
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        add_release(&a.done[d * 2 + (k & 1)], 1);
      }
    }
  }

  // each row's sum over the warps, in order
  for (int q = 0; q < sets; ++q) {
    const int set = rank + q * G;
    if (!keep) {
      const float* acc = acc_of(set);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        rw.ax[r] = acc[lane + 32 * r];
        rw.ay[r] = acc[kBlockRows + lane + 32 * r];
      }
    }
    __syncthreads();  // the previous row set's parts are consumed
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      part_x[warp][lane + 32 * r] = rw.ax[r];
      part_y[warp][lane + 32 * r] = rw.ay[r];
    }
    __syncthreads();
    for (int row = tid; row < kBlockRows; row += kThreads) {
      const int i = set * kBlockRows + row;
      if (i >= n) continue;
      float sx = part_x[0][row], sy = part_y[0][row];
#pragma unroll
      for (int g = 1; g < kTileChunks; ++g) {
        sx += part_x[g][row];
        sy += part_y[g][row];
      }
      a.fx[base + i] = sx;
      a.fy[base + i] = sy;
    }
  }
  return true;
}

template <bool kCutoff, class Law, int kR, bool kMulti>
__global__ void __launch_bounds__(kThreads, kRingMinBlocks)
ring_force_kernel(RingArgs a) {
  const typename Law::Prm p = Law::load(a.prm);
  ring_walk<kCutoff, Law, kR, kMulti>(a, p, blockIdx.x, gridDim.x);
}

// ---------------------------------------------------------------------------
// The batched ring's own body (ring_batch_walk; ring_force_kernel keeps
// ring_walk, whose SASS a shared body would change).  At the 2-D mesh's
// shapes (256 crowds x 4 devices x 250 rows) ring_walk gave each block one
// 32-row set per ring step, 32 law steps a warp between waits, fences and
// polls that took a third of each step (PERF.md row 6-b).  Here an item is a
// (crowd, device, group of `sets` row sets): warp w holds row set w % sets
// of the group and walks the chunk slots w / sets, w / sets + 8 / sets, ...
// of every tile, so a ring step gives each warp `sets` chunks (8 with one
// item per (crowd, device): 250 law steps a wait at that shape).  A row's
// sum of each chunk slot lives in the block's shared memory (or, kMulti, in
// acc) and the slots are added in order at the end, as the unbatched
// kernel adds its warps' parts, so every crowd's forces equal the unbatched
// launch bitwise whatever `sets` is.  `sets` comes from the shapes
// (ring_batch_sets): large enough that a block walks many law steps a
// wait, small enough that the items fill the resident blocks evenly.
//
// A ring step: thread 0 polls fill (and, before overwriting the right
// neighbour's slot, its done credit) with acquire loads, at first without
// sleeping, then one barrier; the block forwards its tiles of the column
// block (tile t by rank t % P) and stages its first tile, keeping the
// columns it forwarded in registers; after the staging barrier thread 0
// fences once and adds fill, and adds done once its last tile of the slot
// is staged: a block that holds the whole slot in one tile hands the slot
// back before it walks it.  Tiles go to two shared buffers in turn, so one
// barrier a tile.
constexpr int kRingBatchMinBlocks = 4;  // resident blocks an SM (PERF.md)
constexpr int kRingBatchRows = 1;       // rows a lane holds: one row set a warp
static_assert(kRingBatchRows == 1, "a warp's rows are one 32-row set");
constexpr int kRingSpinFast = 64;       // polls before the spins sleep
static_assert(kThreads == kColTile, "one staged column a thread");

struct RingBatchArgs {
  RingArgs ring;  // crowd 0's: (n_batch, ...) planes, blocks and counters
  int n_batch;
  int prm_stride;  // prm: (n_batch, P), rows prm_stride apart
  int sets;        // row sets of 32 an item holds: 1, 2, 4 or 8
  int dynamic;     // blocks take crowds from their device's counter
};

struct RingBatchShared {
  ColTile tile[2];
  // [chunk slot][x, y][row of the item]: the rows' sums (keep)
  float acc[kTileChunks][2][kTileChunks * 32];
  float box[2][kTileChunks][4];  // each warp's row set box, by group parity
  int crowd;  // the crowd this block took from its device's counter
};

// Thread 0 spins until *p >= want, polling with acquire loads, sleeping
// only after kRingSpinFast polls; on overrun it sets the error word.
// Returns the polls that found *p short, or -1: overrun, or another block
// set the error word.
__device__ __forceinline__ long long ring_spin(const int* p, int want,
                                               int* err) {
  long long polls = 0;
  while (ld_acquire(p) < want) {
    if (ld_acquire(err) != 0) return -1;
    if (++polls > kSpinLimit) {
      atomicExch(err, 1);
      return -1;
    }
    if (polls > kRingSpinFast) __nanosleep(64);
  }
  return polls;
}

// The rings of the crowds this block walks on device blockIdx.y: for crowd
// b its rank (blockIdx.x - b * groups) mod G among the crowd's P =
// min(groups, G) blocks of each device, and its groups rank, rank + G, ...
// Without kMulti a block holds one group of each of its crowds and walks
// them crowd by crowd, its sums in shared memory; the launch takes that
// form only where every crowd's blocks hold it at the same place of their
// lists (G a multiple of groups, or one item a block), or a crowd would
// wait on blocks still busy with an earlier crowd while others idle.
// With one group a crowd and more crowds than blocks (dynamic), a free
// block takes the next crowd from its device's counter instead: the
// blocks of an SM walk at their arrival order's pace (PERF.md row 6-b),
// and the fast ones take more crowds.  Each device hands out its crowds
// in ascending order, so the lowest unfinished crowd has a block on
// every device, and its ring goes on.
// kMulti walks ring step by ring step over all its (crowd, group) items,
// their sums in acc: a step of a crowd waits only on the previous step of
// the same crowd, which every block walks before it, so the blocks stay as
// even as their item counts.  False: a wait failed.
template <bool kCutoff, class Law, bool kMulti>
__device__ __forceinline__ bool ring_batch_walk(const RingBatchArgs& ab,
                                                RingBatchShared& sm) {
  const RingArgs& a = ab.ring;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int d = blockIdx.y;
  const int D = a.n_dev;
  const int G = gridDim.x;
  const int n = a.n_local;
  const int right = (d + 1) % D;
  const int nct = a.n_col_tiles;
  const int sets = ab.sets;
  const int ir = warp % sets;      // this warp's row set of the item
  const int cq = warp / sets;      // its first chunk slot of each tile
  const int cstep = kTileChunks / sets;
  const int rows = sets * 32;      // rows of an item
  const int nsets = (n + 31) / 32;
  const int groups = (nsets + sets - 1) / sets;
  const int P = groups < G ? groups : G;
  const long long rows_pad = (long long)(n + 255) / 256 * 256;
  int par = 0;   // the tile buffer staged next
  int bpar = 0;  // the box slot written next

  auto rank_of = [&](int b) {
    return (int)((((long long)blockIdx.x - (long long)b * groups) % G + G) %
                 G);
  };
  // crowd b's sums of group grp: [chunk slot][x, y][row], stride rs
  auto acc_of = [&](int b, int grp) {
    return kMulti ? a.acc + ((long long)b * D + d) * rows_pad * 2 *
                                kTileChunks +
                        (long long)grp * rows * 2 * kTileChunks
                  : &sm.acc[0][0][0];
  };
  const int rs = kMulti ? rows : kTileChunks * 32;

  RowSet<kRingBatchRows> rw;
  float ux0 = INFINITY, ux1 = -INFINITY, uy0 = INFINITY, uy1 = -INFINITY;
  float wb[4] = {INFINITY, -INFINITY, INFINITY, -INFINITY};
  // crowd b's group grp: this warp's row set, its box and the group's
  // union box; zero: this warp's sums start from +0
  auto load_group = [&](int b, int grp, bool zero) {
    const long long base = ((long long)b * D + d) * n;
    const int i = (grp * sets + ir) * 32 + lane;
    const bool in = i < n;
    rw.template load<kCutoff>(
        0, in ? a.rx[base + i] : 0.0f, in ? a.ry[base + i] : 0.0f,
        in ? a.ru[base + i] : 0.0f, in ? a.rv[base + i] : 0.0f,
        (in && Law::kRadius) ? a.rrad[base + i] : 0.0f,
        in && a.ralive[base + i] != 0, d * n + i);
    if (kCutoff) {
#pragma unroll
      for (int c = 0; c < 4; ++c) wb[c] = rw.box[0][c];
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sm.box[bpar][warp][c] = wb[c];
      }
    }
    __syncthreads();  // the boxes; the previous crowd's sums are read
    if (kCutoff) {
      ux0 = INFINITY, ux1 = -INFINITY, uy0 = INFINITY, uy1 = -INFINITY;
      for (int w = 0; w < kTileChunks; ++w) {
        ux0 = fminf(ux0, sm.box[bpar][w][0]);
        ux1 = fmaxf(ux1, sm.box[bpar][w][1]);
        uy0 = fminf(uy0, sm.box[bpar][w][2]);
        uy1 = fmaxf(uy1, sm.box[bpar][w][3]);
      }
    }
    bpar ^= 1;
    if (zero) {
      float* s = acc_of(b, grp);
      for (int j = 0; j < sets; ++j) {
        const int g = cq + cstep * j;
        s[(g * 2) * rs + ir * 32 + lane] = 0.0f;
        s[(g * 2 + 1) * rs + ir * 32 + lane] = 0.0f;
      }
    }
  };

  // ring step k of crowd b: the block's groups rank, rank + G, ... (nq of
  // them; without kMulti the one group is loaded already)
  auto step = [&](int b, int k, int rank, int nq) {
    const typename Law::Prm p =
        Law::load(a.prm + (long long)b * ab.prm_stride);
    const int src = ((d - k) % D + D) % D;  // the column block's home
    float* comm = a.comm + (long long)b * D * 2 * a.slot;
    int* fill = a.fill + (long long)b * D * 2;
    int* done = a.done + (long long)b * D * 2;
    const float* blk =
        k == 0 ? a.cols + ((long long)b * D + d) * a.slot
               : comm + ((long long)d * 2 + (k & 1)) * a.slot;
    const bool fwd = k < D - 1;
    const int dst_slot = (k + 1) & 1;
    if (k > 0) {  // the slot is filled; the neighbour's is free
      int ok = 1;
      if (tid == 0) {
        const long long pf =
            ring_spin(&fill[d * 2 + (k & 1)], P * ((k + 1) / 2), a.err);
        const long long pd =
            pf < 0 || !(fwd && k >= 2)
                ? 0
                : ring_spin(&done[right * 2 + dst_slot], P * (k / 2), a.err);
        ok = pf >= 0 && pd >= 0;
      }
      if (!__syncthreads_and(ok)) return false;
    }
    // forward this block's tiles t = rank, rank + P, ... of the column
    // block (rank 0: and the tile boxes) into the right neighbour's slot;
    // tile 0's columns stay in registers for the staging below
    float h[kPlanes];
    bool held = false;
    if (fwd) {
      float* dst = comm + ((long long)right * 2 + dst_slot) * a.slot;
      for (int t = rank; t < nct; t += P) {
        const int j = t * kColTile + tid;
        if (j < n) {
#pragma unroll
          for (int pl = 0; pl < kPlanes; ++pl) {
            const float v = __ldcg(blk + (long long)pl * n + j);
            __stcg(dst + (long long)pl * n + j, v);
            if (t == 0) h[pl] = v;
          }
        }
      }
      held = rank == 0;
      if (rank == 0)
        for (int e = tid; e < 4 * nct; e += kThreads)
          __stcg(dst + kPlanes * n + e, __ldcg(blk + kPlanes * n + e));
    }
    bool fill_due = fwd;
    bool done_due = k > 0;
    // thread 0, after a barrier that follows the forward and the staging
    // of `last` (the block's last tile of this slot): one fence, then the
    // counters
    auto release = [&](bool last) {
      const bool f = fill_due, dn = done_due && last;
      fill_due = false;
      done_due = done_due && !last;
      if (tid != 0 || !(f || dn)) return;
      __threadfence();
      if (f) atomicAdd(&fill[right * 2 + dst_slot], 1);
      if (dn) atomicAdd(&done[d * 2 + (k & 1)], 1);
    };
    const float* bb = blk + kPlanes * n;  // (4, n_col_tiles) boxes
    const int g_src = src * n;
    for (int q = 0; q < nq; ++q) {
      const int grp = rank + q * G;
      if (kMulti) load_group(b, grp, k == 0);
      float* accb = acc_of(b, grp);
      for (int t = 0; t < nct; ++t) {
        float tb[4];
        if (kCutoff) {
#pragma unroll
          for (int c = 0; c < 4; ++c) tb[c] = __ldcg(bb + c * nct + t);
          if (box_gap2(ux0, ux1, uy0, uy1, tb[0], tb[1], tb[2], tb[3]) >
              a.c2)
            continue;  // block-uniform: no row of the group reaches it
        }
        ColTile& tl = sm.tile[par];
        par ^= 1;
        const int j = t * kColTile + tid;
        const bool in = j < n;
        if (held && q == 0 && t == 0) {
          stage_column<kCutoff>(tl, tid, in ? h[0] : 0.0f, in ? h[1] : 0.0f,
                                in ? h[2] : 0.0f, in ? h[3] : 0.0f,
                                in ? h[4] : 0.0f, in && h[5] != 0.0f);
        } else {
          stage_column<kCutoff>(
              tl, tid, in ? __ldcg(blk + j) : 0.0f,
              in ? __ldcg(blk + n + j) : 0.0f,
              in ? __ldcg(blk + 2 * n + j) : 0.0f,
              in ? __ldcg(blk + 3 * n + j) : 0.0f,
              in ? __ldcg(blk + 4 * n + j) : 0.0f,
              in && __ldcg(blk + 5 * n + j) != 0.0f);
        }
        __syncthreads();  // the tile is staged (the other buffer free)
        release(q == nq - 1 && t == nct - 1);
        if (kCutoff && box_gap2(wb[0], wb[1], wb[2], wb[3], tb[0], tb[1],
                                tb[2], tb[3]) > a.c2)
          continue;  // warp-uniform: no row of this warp reaches it
        for (int jj = 0; jj < sets; ++jj) {  // this warp's chunk slots
          const int g = cq + cstep * jj;
          const int jc = t * kColTile + g * kChunk;
          if (jc >= n) break;
          float* px = accb + (g * 2) * rs + ir * 32 + lane;
          float* py = px + rs;
          rw.ax[0] = *px;
          rw.ay[0] = *py;
          const bool walked = rows_vs_chunk<kCutoff, kRingFastTail, Law,
                                            kRingBatchRows>(
              rw, tl, g, min(kChunk, n - jc), g_src + jc, p, a.use_radius,
              a.c2);
          if (walked) {  // else nothing was added
            *px = rw.ax[0];
            *py = rw.ay[0];
          }
        }
      }
    }
    if (fill_due || done_due) {  // tiles skipped: nothing released yet
      __syncthreads();
      release(true);
    }
    return true;
  };

  // each row of crowd b's group grp: its sum over the chunk slots, in order
  auto store = [&](int b, int grp) {
    const long long base = ((long long)b * D + d) * n;
    const float* s = acc_of(b, grp);
    for (int row = tid; row < rows; row += kThreads) {
      const int i = grp * rows + row;
      if (i >= n) continue;
      float sx = s[row], sy = s[rs + row];
#pragma unroll
      for (int g = 1; g < kTileChunks; ++g) {
        sx += s[(g * 2) * rs + row];
        sy += s[(g * 2 + 1) * rs + row];
      }
      a.fx[base + i] = sx;
      a.fy[base + i] = sy;
    }
  };

  if (!kMulti) {  // crowd by crowd, one group each
    auto walk = [&](int b, int rank) {
      load_group(b, rank, true);
      for (int k = 0; k < D; ++k)
        if (!step(b, k, rank, 1)) return false;
      __syncthreads();  // every warp's sums are written
      store(b, rank);
      return true;
    };
    if (ab.dynamic) {  // the next crowd of this device's counter
      for (;;) {
        if (tid == 0) sm.crowd = atomicAdd(&a.err[1 + d], 1);
        __syncthreads();
        const int b = sm.crowd;  // written again only after walk's barriers
        if (b >= ab.n_batch) return true;
        if (!walk(b, 0)) return false;
      }
    }
    for (int b = 0; b < ab.n_batch; ++b) {
      const int rank = rank_of(b);
      if (rank < P && !walk(b, rank)) return false;  // block-uniform
    }
    return true;
  }
  for (int k = 0; k < D; ++k)  // ring step by ring step over every item
    for (int b = 0; b < ab.n_batch; ++b) {
      const int rank = rank_of(b);
      if (rank < P && !step(b, k, rank, (groups - rank + G - 1) / G))
        return false;
    }
  __syncthreads();  // every warp's sums are written
  for (int b = 0; b < ab.n_batch; ++b) {
    const int rank = rank_of(b);
    if (rank >= P) continue;
    for (int grp = rank; grp < groups; grp += G) store(b, grp);
  }
  return true;
}

// The ring over a batch of crowds: its own body (ring_batch_walk), with
// sets row sets an item from the launch (ring_batch_sets).  kMulti: a
// crowd has more groups than a device has blocks, so blocks hold several
// and keep their sums in acc.
template <bool kCutoff, class Law, bool kMulti>
__global__ void __launch_bounds__(kThreads, kRingBatchMinBlocks)
ring_force_batched_kernel(RingBatchArgs ab) {
  __shared__ RingBatchShared sm;
  ring_batch_walk<kCutoff, Law, kMulti>(ab, sm);
}

// Row sets an item of the batched ring holds (1, 2, 4 or 8), by the shapes:
// the least rounds x (sets x tiles + 1), where rounds = ceil(items / blocks
// of a device) is the items the busiest block walks, sets x tiles the
// chunks a warp walks a ring step and the 1 a step's waits and staging;
// ties go to more sets (fewer waits).  A block is taken to go no faster
// when its SM holds fewer blocks (at 2 blocks an SM the counters showed a
// law step at 1.3x the cycles a warp gets at 4, latency-bound).
// tools/walk_model.py --ring replays it.
int ring_batch_sets(long long crowds, int n_dev, int n_local, int per_sm,
                    int sms) {
  const long long per_dev = (long long)per_sm * sms / n_dev;
  if (per_dev < 1) return 1;  // refused by the launch
  const long long nsets = (n_local + 31) / 32;
  const long long nct = (n_local + kColTile - 1) / kColTile;
  int best = 1;
  long long best_cost = 0;
  for (int s = 1; s <= kTileChunks; s *= 2) {
    const long long items = crowds * ((nsets + s - 1) / s);
    const long long g = items < per_dev ? items : per_dev;
    const long long cost = (items + g - 1) / g * (s * nct + 1);
    if (s == 1 || cost <= best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// Launch the ring: ring_force_kernel with R = kRingRows rows per thread
// on one block per row set where the card keeps them all resident, else on
// as many blocks per device as it keeps resident, each walking several row
// sets (kMulti); or, for a batch of `crowds`, ring_force_batched_kernel
// with ring_batch_sets row sets an item, crowd by crowd where a block of a
// device holds one item of a crowd at the same place of every block's list
// as the crowd's other blocks (G a multiple of the items of a crowd),
// else step by step over its items (kMulti), on at most the resident
// blocks.
template <bool kCutoff, class Law, bool kMulti, class Args>
cudaError_t ring_try(Args a, const RingArgs& r, int crowds, int sms,
                     void* stream, bool* fits) {
  constexpr bool kBatched = !std::is_same<Args, RingArgs>::value;
  const void* kernel;
  if constexpr (!kBatched)
    kernel = (const void*)ring_force_kernel<kCutoff, Law, kRingRows, kMulti>;
  else
    kernel = (const void*)ring_force_batched_kernel<kCutoff, Law, kMulti>;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  const long long per_dev = (long long)per_sm * sms / r.n_dev;
  long long rows = 32 * kRingRows;  // of an item
  if constexpr (kBatched) {
    a.sets = ring_batch_sets(crowds, r.n_dev, r.n_local, per_sm, sms);
    rows = 32LL * a.sets;
  }
  const long long nsets = (r.n_local + rows - 1) / rows;  // items a crowd
  const long long items = nsets * crowds;
  const long long g = items < per_dev ? items : per_dev;
  if constexpr (kBatched) a.dynamic = !kMulti && nsets == 1 && items > g;
  *fits = kMulti ? per_dev >= 1
                 : nsets <= per_dev && (!kBatched || g % nsets == 0);
  if (!*fits) return cudaSuccess;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)g, (unsigned)r.n_dev),
                                  dim3(kThreads), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kCutoff, class Law, class Args>
int ring_launch(Args a, const RingArgs& r, int crowds, void* stream) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  bool fits = false;
  e = ring_try<kCutoff, Law, false>(a, r, crowds, sms, stream, &fits);
  if (!fits && e == cudaSuccess)
    e = ring_try<kCutoff, Law, true>(a, r, crowds, sms, stream, &fits);
  if (!fits && e == cudaSuccess)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  return (int)e;
}

// The arguments of `crowds` rings of n_dev devices of n_local agents each
// (sync: their 2 * crowds * n_dev fill counters, as many done counters,
// then the error word).
RingArgs ring_args(int crowds, int n_dev, int n_local, const float* rx,
                   const float* ry, const float* ru, const float* rv,
                   const float* rrad, const uint8_t* ralive, const float* cols,
                   float* comm, int* sync, float* acc, const float* prm,
                   int use_radius, float c2, float* fx, float* fy) {
  RingArgs a;
  a.n_dev = n_dev;
  a.n_local = n_local;
  a.n_col_tiles = (n_local + kColTile - 1) / kColTile;
  a.slot = kPlanes * n_local + 4 * a.n_col_tiles;
  a.rx = rx;
  a.ry = ry;
  a.ru = ru;
  a.rv = rv;
  a.rrad = rrad;
  a.ralive = ralive;
  a.cols = cols;
  a.comm = comm;
  a.fill = sync;
  a.done = sync + 2 * crowds * n_dev;
  a.err = sync + 4 * crowds * n_dev;
  a.acc = acc;
  a.prm = prm;
  a.use_radius = use_radius;
  a.c2 = c2;
  a.fx = fx;
  a.fy = fy;
  return a;
}

}  // namespace

extern "C" {

// One launch of the ring over n_dev virtual devices of n_local agents each,
// on `stream`; returns cudaGetLastError() (non-zero: the launch was refused,
// for example cudaErrorCooperativeLaunchTooLarge when not even one block
// per device can be resident).
// law: a LawId, as for the sfm_pair_* entries (Helbing: ru, rv carry the
// rows' desired directions; rrad is not read).  rx .. ralive: every
// device's rows, device d's at [d * n_local, (d + 1) * n_local).  cols: each
// device's own column block as (n_dev, slot) floats, slot = 6 * n_local +
// 4 * n_col_tiles: the planes x, y, vx, vy, radius, alive (1 or 0) and then
// the (4, n_col_tiles) boxes of its 256-column tiles (read with cutoff only;
// n_col_tiles = ceil(n_local / 256)).  comm: (n_dev, 2, slot) floats of
// scratch; sync: 4 * n_dev + 1 ints, zero on entry (the fill and done
// counters, then the error word, which is non-zero after a spin overran);
// acc: at least n_dev * ceil(n_local / 128) * 128 * 16 floats of scratch
// (the row sets' per-warp sums of blocks that walk several).
// cutoff != 0 applies c2, the squared cutoff, per pair and per tile box.
int sfm_ring_force(int law, int n_dev, int n_local, const float* rx,
                   const float* ry, const float* ru, const float* rv,
                   const float* rrad, const uint8_t* ralive, const float* cols,
                   float* comm, int* sync, float* acc, const float* prm,
                   int use_radius, int cutoff, float c2, float* fx, float* fy,
                   void* stream) {
  if (n_dev < 1 || n_local < 0) return (int)cudaErrorInvalidValue;
  if (n_local == 0) return (int)cudaSuccess;
  const RingArgs a =
      ring_args(1, n_dev, n_local, rx, ry, ru, rv, rrad, ralive, cols, comm,
                sync, acc, prm, use_radius, c2, fx, fy);
  return with_any_law(law, [&](auto l) {
    using L = decltype(l);
    return cutoff ? ring_launch<true, L>(a, a, 1, stream)
                  : ring_launch<false, L>(a, a, 1, stream);
  });
}

// One launch of the ring over n_batch crowds of n_dev virtual devices of
// n_local agents each (a batch of crowds sharded over a 2-D mesh), as
// sfm_ring_force for every crowd: rx .. ralive, fx, fy (n_batch, n_dev *
// n_local), crowd b's device d rows at [(b * n_dev + d) * n_local, ...);
// cols (n_batch, n_dev, slot) each crowd's devices' own blocks; prm
// (n_batch, P) with rows prm_stride apart (0: one vector for every crowd);
// comm (n_batch, n_dev, 2, slot) floats of scratch; sync 4 * n_batch *
// n_dev + 1 + n_dev ints, zero on entry (the fill and done counters of
// every crowd, the error word, then each device's next crowd); acc at
// least n_batch * n_dev * ceil(n_local / 256) * 256 * 16 floats of
// scratch.
int sfm_ring_force_batched(int law, int n_batch, int n_dev, int n_local,
                           const float* rx, const float* ry, const float* ru,
                           const float* rv, const float* rrad,
                           const uint8_t* ralive, const float* cols,
                           float* comm, int* sync, float* acc,
                           const float* prm, int prm_stride, int use_radius,
                           int cutoff, float c2, float* fx, float* fy,
                           void* stream) {
  if (n_batch < 1 || n_dev < 1 || n_local < 0 || prm_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (n_local == 0) return (int)cudaSuccess;
  const RingBatchArgs a = {
      ring_args(n_batch, n_dev, n_local, rx, ry, ru, rv, rrad, ralive, cols,
                comm, sync, acc, prm, use_radius, c2, fx, fy),
      n_batch, prm_stride, 1, 0};
  return with_any_law(law, [&](auto l) {
    using L = decltype(l);
    return cutoff ? ring_launch<true, L>(a, a.ring, n_batch, stream)
                  : ring_launch<false, L>(a, a.ring, n_batch, stream);
  });
}

}  // extern "C"
