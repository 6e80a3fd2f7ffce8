// Pair-force kernels for Hopper (sm_90a), with a plain C interface for ctypes
// (utils/cuda_build.py builds this file, ops/cuda_forces.py binds it).  Each
// kernel is a template over its walk (which tile pairs a block visits) and
// its pair law (pair_laws.cuh): the Moussaid force, the Karamouzas power
// law and the Helbing ellipse.  There is one C entry per walk, sfm_pair_<form>,
// which takes the law's id (LawId) first and switches on it.  The plain
// PyTorch versions are ops/forces.py::pedestrian_force, ::powerlaw_force and
// ::ped_repulsive_force (with ``cutoff`` for the cutoff forms, and
// ``cols``/``row_offset`` for the rectangular ones).
//
// The laws replace the JAX package's per-law tile functions
// (ops/pallas_forces.py, all launched through _tile_fn :608): _pair_tile
// (:375, Moussaid), _pair_tile_powerlaw (:462) and _pair_tile_helbing
// (:528).  Moussaid and the power law take every walk below; Helbing, which
// is not antisymmetric, takes the dense walks only (the JAX package forces
// symmetric=False for it, :714-719).
//
// Rows and columns.  The dense walks and the full-block walk take row planes
// and column planes, each with its own count and the global slot of its
// first agent: under agent sharding a shard's rows meet the gathered
// columns (``gather``) or one shard's block at a time (``ring``), the JAX
// package's _slab_call(row_args, row_bb, col_args, col_bb) (:1000).  The
// square call passes the same planes twice.  The self-pair test compares
// global slots.  Helbing's row planes carry the desired directions in their
// velocity slots and its column planes the true velocities, as the JAX
// package staged them (pallas_ring.py:218-225).
//
// What each walk replaces (JAX package, ops/pallas_forces.py):
//   pair_force_dense_kernel<kAllTiles>  <- _pair_kernel (:162), the dense
//       per-row sum over all column tiles (_slab_call with surv=None).
//   pair_force_dense_kernel<kBoxSkip>   <- _pair_kernel with a cutoff: the
//       per-pair cutoff (_pair_tile :430-433) and the tile-box skip
//       (:180-190), block-uniform per staged column tile.
//   pair_force_dense_kernel<kTable>     <- _pair_kernel_compact (:205): a
//       block walks only its row's surviving column tiles, ascending, from
//       a per-step table (_bbox_hits + spatial.surv_table).
//   pair_force_sym_kernel<kTriangle>    <- _pair_kernel_sym (:239) with
//       _pair_tile (:375) and _triangle_table (:344): each unordered pair
//       once, +f to the row, -f to the column.  The polynomial _atan2
//       (:129) existed only because Mosaic has no atan2; here it is atan2f.
//   pair_force_sym_kernel<kTriangleBox> <- _pair_kernel_sym with a cutoff on
//       the static triangle (:280-287): a block whose tile pair fails the
//       box test exits before it stages anything.
//   pair_force_sym_kernel<kSymTable>    <- _pair_kernel_sym driven by the
//       per-step table of hits AND triangle (:924-938).
//   pair_force_sym_dense_kernel<kFullBlock(Box)> <- _pair_kernel_sym_dense
//       (:296), the off-diagonal step of the half-ring: every pair of a
//       rectangular (rows x columns) block once, +f to the row output and -f
//       to a separate column output, with no triangle (rows and columns are
//       different shards' agents); with a cutoff, the box skip of both
//       sides' 128-agent tiles.
//
// Batches (ensembles and parameter sweeps).  Under the JAX package's vmap
// _pair_kernel_sym and _pair_kernel gain a leading batch axis on every
// plane and a batched parameter vector (pallas_forces.py:167-168).  Here
// the kAllTiles and kTriangle walks take B independent crowds in one launch
// (pair_force_dense_batched_kernel, pair_force_sym_batched_kernel; entries
// sfm_pair_dense_batched, sfm_pair_sym_batched): the grid's y index is the
// crowd, whose planes and outputs lie at blockIdx.y * n and whose
// parameters at blockIdx.y * prm_stride (0: every crowd shares one vector).
// A batched kernel hands its crowd's pointers to the walk body the
// unbatched kernel runs (dense_walk, sym_walk), so row b of the dense walk
// sums in the unbatched launch's order and equals it bitwise, and the
// unbatched kernels compile without a batch offset (one read from
// blockIdx.y inside the shared bodies cost 8% on the dense walk at 10k).
// The dense walk's cluster split sees the whole grid (B row sets).
//
// What bounds them on this card.  Each Moussaid pair costs about 85 f32
// operations and 6 special-function operations (2 rsqrt, atan2, 2 exp, a
// division); a power-law pair about 40 and 7 (a root, an exp, 5
// divisions), a Helbing pair about 50 and 11 (4 roots, an exp, 6
// divisions); a kernel reads O(N) state and writes O(N) forces.  So the
// pair count bounds them: N^2/2 (N^2) pairs without a cutoff, and under a
// cutoff the pairs within it, about pi*c^2*density per agent -- at 0.25
// agents/m^2 and c = 30 m, 707 per agent.  Above that bound sits the issue
// rate: the symmetric walk's loop issues about 168 SASS instructions per
// Moussaid pair (tools/sass_census.py), of which the special functions
// take 106 -- atan2f alone 65, and it stays: sign(theta) is a hard gate --
// while the bound counts 85 operations as if every one were an FMA, which
// the per-operation rounding up to cross and dot forbids.  At N = 10,000
// that floor is about 0.25 ms against the 0.072 ms bound, and the dense
// walk's (about 168 per pair, R = 2) 0.50 ms for its 1e8 ordered pairs
// (PERF.md).
//
// What the design does about that.  Every block stages its column tile in
// shared memory once and each thread keeps its rows' sums in registers, so
// the only device-memory traffic is O(N) per tile.  Both families give each
// thread R rows (lane + 32 r of its warp's row group): each column value
// read from shared memory serves R pairs.  The symmetric walks (grid: the
// upper triangle of 128 x 128 tile pairs, or the table's slots; R =
// kSymRows, kSymRowsCut in the cutoff walks, SymLayout) also sum each
// column's reaction over the R rows in registers before one shared update.
// The dense walks (R = kDenseRows) stage 256-column tiles as one float4
// (x, y, u, v) and one float2 (radius, alive) per column, which all 32
// lanes of a warp read at once (a broadcast); the block's eight warps
// share each staged tile, one 32-column chunk each (pair_laws.cuh
// rows_vs_chunk, which the ring shares).  Where the rows give fewer blocks
// than the card holds, a launch splits each row's columns over up to
// kMaxSplit blocks of one thread block cluster, which fold their sums in a
// fixed order through distributed shared memory (dense_splits: a function
// of the shapes only).  The cutoff walks cull twice inside a tile,
// warp-uniformly: a (32 rows, 32 columns) chunk pair whose alive boxes lie
// beyond the cutoff is skipped, and a column step runs the law only when
// some lane's pair is within it (a ballot).  They test their candidate
// tiles' boxes together, one per thread, and walk the compacted hit list:
// every tile of the block's parts (the box-skip walk and an overflowing
// table row) or the tiles its table row lists.  A block holds 32 rows, so
// the four blocks of a 128-row table row each stage the listed tiles their
// own box reaches: one 128-row block per table row, staging each tile
// once, measured slower (its barriers wait for the warp with the most
// pairs left after culling).  Past the hard gates every walk takes the
// Moussaid law's fast tail (pair_forces.cuh: both exponentials as
// __expf).
// Parameters are read through a device pointer, and the compacted forms
// decide an overflowing row on the device, so a step never synchronises
// with the host.  The eager launches (CUDA graphs) are later work.
//
// Where the TPU design does not carry over.  The TPU walks its grid in order
// and kept one (1, n_cols) column accumulator resident in VMEM for the whole
// launch (pallas_forces.py:264-272, :453-459, :1065-1071).  Blocks here run
// in parallel and in no order, so the symmetric kernels reduce their column
// partials inside the block (per-warp rows of shared memory, written without
// conflicts in a staggered order) and then add them with one atomicAdd per
// column per block; rows need atomicAdd too, because every tile pair of a row
// tile is its own block.  The order of those float additions varies from run
// to run, so the symmetric result matches the plain version only up to f32
// summation order.  The dense kernels use no atomics: each row's sum is
// taken in one fixed order (over its column parts, the chunk slots, the
// part's tiles, the chunk's columns: pair_force_dense_kernel), the same in
// every walk whatever its layout, so their results are deterministic and
// the compacted kernel equals the dense cutoff kernel bitwise: a tile or
// chunk one walk skips holds no pair within the cutoff, whose terms are
// exactly +0 in a walk that evaluates them.  The TPU's compacted grid fell
// back to the whole dense grid with a lax.cond when any row overflowed its
// table; here only the overflowing row walks its tiles with the box test.
// The TPU's 1 MB SMEM bounded its static triangle table and survivor
// table; here the triangle is decoded from the block index and the table
// lives in device memory.
//
// Liveness is an explicit mask (alive, one byte per agent): dead agents give
// and receive nothing, and dead rows come out exactly 0.  The JAX kernels
// instead parked dead agents at a far sentinel; the mask needs no position
// bound.  Boxes are taken over alive agents only, so a tile without an alive
// agent never hits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "block_box.cuh"
#include "pair_laws.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSymTile = 128;  // rows == columns of one tile pair
constexpr int kSymWarps = kSymTile / 32;  // threads per block: kSymTile
// R: rows per thread of the symmetric walks: kSymRows for the walks
// without a cutoff, kSymRowsCut for the cutoff walks, where the per-row
// culling branches between the rows' law evaluations and R = 1 measured
// faster (PERF.md: R = 1, 2 and 4 measured)
constexpr int kSymRows = 4;
constexpr int kSymRowsCut = 1;
// The dense walks: a block of kDenseCols warps holds 32 * R rows, R =
// kDenseRows per lane (lane + 32 r), and each warp walks kDenseChunks
// 32-column chunks of every staged tile (PERF.md: R = 1, 2 and 4, 2 to 8
// warps and 128-row table blocks measured).  Each row's columns fall into
// at most kMaxSplit parts, which up to that many blocks of one cluster
// share.  The launch bounds ask for 2,048 resident threads an SM, so at
// most 32 registers a thread: the law spills some bytes to local memory,
// which measured faster than fewer resident warps.  The dense walks take
// the Moussaid law's fast tail too (pair_forces.cuh).
constexpr int kDenseRows = 1;
constexpr int kDenseCols = 8;
constexpr int kDenseChunks = kTileChunks / kDenseCols;
constexpr int kDenseThreads = 32 * kDenseCols;
constexpr int kDenseBlockRows = 32 * kDenseRows;
constexpr int kMaxSplit = 8;
constexpr bool kDenseFastTail = true;
static_assert(kSymTile % kDenseBlockRows == 0,
              "a survivor-table row covers whole blocks");

// how a dense-layout block chooses its column tiles
enum DenseWalk { kAllTiles, kBoxSkip, kTable };
// how a symmetric block finds its tile pair(s)
enum SymWalk { kTriangle, kTriangleBox, kSymTable };

// One side of a launch: the planes of n agents whose first has global slot
// off.  (u, v) are the velocity slots: v for the columns; v, or Helbing's
// desired direction e, for the rows.  rad may be null for Helbing.
struct Planes {
  const float* __restrict__ x;
  const float* __restrict__ y;
  const float* __restrict__ u;
  const float* __restrict__ v;
  const float* __restrict__ rad;
  const uint8_t* __restrict__ alive;
  int n;
  int off;
};

// The (128-row tile, block) pairs a launch of a walk aims for: the cutoff
// walks' blocks are cheaper and uneven, so they want fewer splits.
constexpr int dense_fill(int walk) { return walk == kAllTiles ? 640 : 120; }

// Parts of a row's nct column tiles: part p is tiles [p * nct / P,
// (p + 1) * nct / P), P = min(kMaxSplit, nct) -- a function of the column
// count only.
__host__ __device__ __forceinline__ int dense_parts(int nct) {
  return nct < kMaxSplit ? (nct < 1 ? 1 : nct) : kMaxSplit;
}

// The blocks that share a row block's parts: the least power of two that
// gives about dense_fill (128-row tile, block) pairs (so that they share
// kMaxSplit parts evenly), at most one per part.  A function of the
// launch's shapes only.
template <int kWalk>
int dense_splits(int n_rows, int n_cols, int batch) {
  const long long row_tiles =
      (long long)((n_rows + kSymTile - 1) / kSymTile) * batch;
  const int parts = dense_parts(n_cols / kColTile + (n_cols % kColTile != 0));
  int s = 1;
  while (s < parts && (long long)s * row_tiles < dense_fill(kWalk)) s *= 2;
  return s < parts ? s : parts;
}

// The dense walks.  Block b holds row block b / S and parts [s * P / S,
// (s + 1) * P / S) of its columns, s = b % S, walked in ascending tile
// order (the batched kernel passes its crowd's planes, parameters and
// outputs).  Each row's sum is one fixed order of additions, whatever the
// walk, R, kDenseCols or S: over the parts, of the sum over a tile's eight
// 32-column chunk slots, of the slot's sum over the part's tiles, of the
// chunk's 32 columns (each level a left fold from +0).  A tile or chunk a
// walk skips holds no pair within the cutoff, whose terms are exactly +0
// where a walk evaluates them, and adding +0 to a sum that started at +0
// changes nothing: so the walks agree bitwise.  The S blocks of a row
// block form one cluster and fold their parts' sums in order through
// distributed shared memory.
template <int kWalk, class Law>
__device__ __forceinline__ void dense_walk(
    const Planes& rows, const Planes& cols, const float* __restrict__ prm,
    int use_radius, const float* __restrict__ col_bb,
    const int* __restrict__ surv, const int* __restrict__ counts,
    int max_surv, float c2, int n_split, float* __restrict__ fx,
    float* __restrict__ fy) {
  constexpr int kR = kDenseRows;
  constexpr bool kCut = kWalk != kAllTiles;
  constexpr int kWarps = kDenseCols;
  constexpr int kRows = kDenseBlockRows;
  __shared__ ColTile tile;
  __shared__ float slot_x[kTileChunks][kRows], slot_y[kTileChunks][kRows];
  __shared__ float part_x[kMaxSplit][kRows], part_y[kMaxSplit][kRows];
  __shared__ int list[kCut ? kDenseThreads : 1];
  __shared__ int wcount[kWarps];

  const typename Law::Prm p = Law::load(prm);
  const int tid = threadIdx.x;
  const int warp = tid / 32;  // the column group
  const int lane = tid % 32;
  const int rb = blockIdx.x / n_split;
  const int split = (int)(blockIdx.x % n_split);
  const int n = cols.n;
  const int nct = n / kColTile + (n % kColTile != 0);
  const int n_parts = dense_parts(nct);
  const int p_lo = split * n_parts / n_split;
  const int p_hi = (split + 1) * n_parts / n_split;
  const int t0 = p_lo * nct / n_parts;  // this block's tiles
  const int t1 = p_hi * nct / n_parts;
  const int i_blk = rb * kRows;

  RowSet<kR> rw;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i_blk + lane + 32 * r;
    const bool in = i < rows.n;
    rw.template load<kCut>(
        r, in ? rows.x[i] : 0.0f, in ? rows.y[i] : 0.0f,
        in ? rows.u[i] : 0.0f, in ? rows.v[i] : 0.0f,
        (in && Law::kRadius) ? rows.rad[i] : 0.0f,
        in && rows.alive[i] != 0, rows.off + i);
  }
  for (int e = tid; e < kTileChunks * kRows; e += kDenseThreads) {
    slot_x[e / kRows][e % kRows] = 0.0f;
    slot_y[e / kRows][e % kRows] = 0.0f;
  }
  for (int e = tid; e < kMaxSplit * kRows; e += kDenseThreads) {
    part_x[e / kRows][e % kRows] = 0.0f;
    part_y[e / kRows][e % kRows] = 0.0f;
  }

  // the sum of the current part's slots, into part_[x|y][part - p_lo]; the
  // slots start again from 0 (the next tile's first barrier orders that
  // before any warp adds)
  int cur = -1;
  auto flush = [&]() {
    __syncthreads();
    for (int row = tid; row < kRows; row += kDenseThreads) {
      float sx = slot_x[0][row], sy = slot_y[0][row];
      slot_x[0][row] = 0.0f;
      slot_y[0][row] = 0.0f;
#pragma unroll
      for (int q = 1; q < kTileChunks; ++q) {
        sx += slot_x[q][row];
        sy += slot_y[q][row];
        slot_x[q][row] = 0.0f;
        slot_y[q][row] = 0.0f;
      }
      part_x[cur - p_lo][row] = sx;
      part_y[cur - p_lo][row] = sy;
    }
  };

  // stage column tile t and add each of the column group's chunks to the
  // rows' slots
  auto run_tile = [&](int t) {
    const int part = ((t + 1) * n_parts - 1) / nct;
    if (part != cur) {  // block-uniform
      if (cur >= 0) flush();
      cur = part;
    }
    const int j0 = (int)(t * kColTile);
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < kColTile; c += kDenseThreads) {
      const int j = j0 + c;
      const bool in = j < n;
      stage_column<kCut>(tile, c, in ? cols.x[j] : 0.0f,
                         in ? cols.y[j] : 0.0f,
                         in ? cols.u[j] : 0.0f,
                         in ? cols.v[j] : 0.0f,
                         (in && Law::kRadius) ? cols.rad[j] : 0.0f,
                         in && cols.alive[j] != 0);
    }
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < kDenseChunks; ++q) {
      const int chunk = warp * kDenseChunks + q;
      const int jc = j0 + chunk * kChunk;
      if (jc >= n) break;
#pragma unroll
      for (int r = 0; r < kR; ++r) rw.ax[r] = rw.ay[r] = 0.0f;
      if (rows_vs_chunk<kCut, kDenseFastTail, Law, kR>(
              rw, tile, chunk, min(kChunk, n - jc), cols.off + jc, p,
              use_radius, c2)) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {  // this warp's slot of these rows
          slot_x[chunk][lane + 32 * r] += rw.ax[r];
          slot_y[chunk][lane + 32 * r] += rw.ay[r];
        }
      }
    }
  };

  if constexpr (kWalk == kAllTiles) {
    for (int t = t0; t < t1; ++t) run_tile(t);
  } else {
    // the block's box: its row sets' boxes (every warp holds them all)
    float bx0 = INFINITY, bx1 = -INFINITY, by0 = INFINITY, by1 = -INFINITY;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      bx0 = fminf(bx0, rw.box[r][0]);
      bx1 = fmaxf(bx1, rw.box[r][1]);
      by0 = fminf(by0, rw.box[r][2]);
      by1 = fmaxf(by1, rw.box[r][3]);
    }
    // the candidate tiles: the listed tiles of this block's parts in its
    // 128-row survivor-table row, or, in the box-skip walk and for a table
    // row that overflowed, every tile of its parts; those whose box the
    // block's box reaches, tested kDenseThreads at a time, one per thread,
    // and compacted in ascending order
    const int trow = i_blk / kSymTile;
    bool table = false;
    if constexpr (kWalk == kTable) table = counts[trow] <= max_surv;
    const int n_cand = table ? max_surv : t1 - t0;
    for (int base = 0; base < n_cand; base += kDenseThreads) {
      const int k = base + tid;
      int t = -1;
      bool h = false;
      if (k < n_cand) {
        if (table) {
          t = surv[(long long)trow * max_surv + k];
          h = t >= t0 && t < t1 &&
              box_hits(col_bb, nct, t, bx0, bx1, by0, by1, c2);
        } else {
          t = t0 + k;
          h = box_hits(col_bb, nct, t, bx0, bx1, by0, by1, c2);
        }
      }
      const unsigned m = __ballot_sync(kAllLanes, h);
      if (lane == 0) wcount[warp] = __popc(m);
      __syncthreads();
      int off = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        off += w < warp ? wcount[w] : 0;
        total += wcount[w];
      }
      if (h) list[off + __popc(m & ((1u << lane) - 1u))] = t;
      __syncthreads();
      for (int q = 0; q < total; ++q) run_tile(list[q]);
    }
  }
  if (cur >= 0) flush();

  // each row: its parts' sums in order, from every block of the cluster
  // (at n_split = 1 the cluster is this block alone)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's part sums are in its shared memory
  const int per = (kRows + n_split - 1) / n_split;
  for (int k = tid; k < per; k += kDenseThreads) {
    const int row = split * per + k;
    const int i = i_blk + row;
    if (row >= kRows || i >= rows.n) continue;
    float sx = 0.0f, sy = 0.0f;
    for (int b = 0; b < n_split; ++b) {
      const float* px = cluster.map_shared_rank(&part_x[0][0], b);
      const float* py = cluster.map_shared_rank(&part_y[0][0], b);
      const int q_n = (b + 1) * n_parts / n_split - b * n_parts / n_split;
      for (int q = 0; q < q_n; ++q) {
        sx += px[q * kRows + row];
        sy += py[q * kRows + row];
      }
    }
    fx[i] = sx;
    fy[i] = sy;
  }
  cluster.sync();  // no block leaves while another reads its sums
}

template <int kWalk, class Law>
__global__ void __launch_bounds__(kDenseThreads, 2048 / kDenseThreads)
pair_force_dense_kernel(Planes rows, Planes cols,
                        const float* __restrict__ prm, int use_radius,
                        const float* __restrict__ col_bb,
                        const int* __restrict__ surv,
                        const int* __restrict__ counts, int max_surv, float c2,
                        int n_split, float* __restrict__ fx,
                        float* __restrict__ fy) {
  dense_walk<kWalk, Law>(rows, cols, prm, use_radius, col_bb, surv, counts,
                         max_surv, c2, n_split, fx, fy);
}

// A crowd's planes in a batch: every pointer advanced by off agents (rad
// may be null).
__device__ __forceinline__ Planes batch_row(Planes p, int off) {
  p.x += off;
  p.y += off;
  p.u += off;
  p.v += off;
  if (p.rad != nullptr) p.rad += off;
  p.alive += off;
  return p;
}

// The kAllTiles walk over a batch of square crowds of rows.n agents: crowd
// blockIdx.y's planes and outputs at blockIdx.y * rows.n, its parameters
// at blockIdx.y * prm_stride.  The walk itself is the unbatched one.
template <class Law>
__global__ void __launch_bounds__(kDenseThreads, 2048 / kDenseThreads)
pair_force_dense_batched_kernel(Planes rows, Planes cols,
                                const float* __restrict__ prm, int prm_stride,
                                int use_radius, int n_split,
                                float* __restrict__ fx,
                                float* __restrict__ fy) {
  const int bo = (int)blockIdx.y * rows.n;
  dense_walk<kAllTiles, Law>(batch_row(rows, bo), batch_row(cols, bo),
                             prm + (int)blockIdx.y * prm_stride, use_radius,
                             nullptr, nullptr, nullptr, 1, 0.0f, n_split,
                             fx + bo, fy + bo);
}

// Row-major position of tile pair (ti, tj), tj >= ti, in the upper triangle
// of an n_tiles x n_tiles grid: row ti starts at ti*n_tiles - ti*(ti-1)/2.
__device__ __forceinline__ long long tri_start(long long ti, long long nt) {
  return ti * nt - ti * (ti - 1) / 2;
}

// The symmetric walks' thread layout for R rows per thread: a block's
// four warps cover its 128 x 128 tile pair as kRowGroups row groups of
// 32 * R rows times R column groups of 128 / R columns.  Each lane holds
// its R rows in registers, so each column value read from shared memory
// serves R pairs, and the column's reaction is summed over the R rows in
// registers before one shared update per column step.
template <int kR>
struct SymLayout {
  static_assert(kSymWarps % kR == 0, "R divides the block's warps");
  static constexpr int kRowGroups = kSymWarps / kR;
  static constexpr int kColGroups = kR;
  static constexpr int kWarpRows = 32 * kR;
  static constexpr int kWarpChunks = kRowGroups;  // 32-column chunks
};

struct SymShared {
  float cx[kSymTile], cy[kSymTile], cvx[kSymTile], cvy[kSymTile];
  float cr[kSymTile];
  uint8_t ca[kSymTile];
  // -f partials of each column, one row per row group; +f partials of each
  // row, one row per column group
  float col_x[kSymWarps][kSymTile];
  float col_y[kSymWarps][kSymTile];
  float row_x[kSymWarps][kSymTile];
  float row_y[kSymWarps][kSymTile];
  // the box of each 32-column chunk's alive agents (the cutoff walks)
  float cbox[kSymWarps][4];
};

// One tile pair (row tile ti, column tile tj) of a Newton's-third-law walk:
// +f to the row (atomics into fx, fy) and -f to the column (atomics into
// fxc, fyc).  kTriangle: rows and columns are the same planes, and only the
// pairs with column index above row index count (each unordered pair once);
// otherwise every pair of the two tiles counts once (the full block of two
// different shards).  fxc, fyc may be fx, fy (the square walks).
// Block-uniform; may be called repeatedly.
//
// Culling, all warp-uniform: a warp skips a 32-column chunk when the
// triangle leaves none of its rows a pair there.  With kCutoff, a (32
// rows, 32 columns) chunk pair is skipped when the box of the 32 rows'
// alive agents lies beyond the cutoff from the chunk's box (box_gap2,
// exact as the tile-pair test), and then, per column step and row, the
// law runs only when some lane's pair lies within the cutoff (a ballot).
// A skipped pair's force is exactly the +0 the law's mask gives.  Without
// a cutoff nothing branches between a lane's R law evaluations, so the
// compiler can interleave them.
template <int kR, bool kTri, bool kCutoff, class Law>
__device__ __forceinline__ void sym_tile_pair(
    SymShared& sm, long long ti, long long tj, const Planes& rows,
    const Planes& cols, const typename Law::Prm& p, int use_radius, float c2,
    float* fx, float* fy, float* fxc, float* fyc) {
  static_assert(Law::kAntisymmetric,
                "the Newton's-third-law walk needs an antisymmetric law");
  constexpr unsigned kAll = 0xffffffffu;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  using L = SymLayout<kR>;
  const int rg = warp % L::kRowGroups;  // this warp's row group
  const int cg = warp / L::kRowGroups;  // and column group

  __syncthreads();  // the previous tile pair's sums are read
  const int j0 = (int)(tj * kSymTile);
  const int jt = j0 + tid;
  const bool col_in = jt < cols.n;
  const float cxt = col_in ? cols.x[jt] : 0.0f;
  const float cyt = col_in ? cols.y[jt] : 0.0f;
  const uint8_t cat = col_in ? cols.alive[jt] : 0;
  sm.cx[tid] = cxt;
  sm.cy[tid] = cyt;
  sm.cvx[tid] = col_in ? cols.u[jt] : 0.0f;
  sm.cvy[tid] = col_in ? cols.v[jt] : 0.0f;
  sm.cr[tid] = col_in ? cols.rad[jt] : 0.0f;
  sm.ca[tid] = cat;
#pragma unroll
  for (int g = 0; g < L::kRowGroups; ++g) {
    sm.col_x[g][tid] = 0.0f;
    sm.col_y[g][tid] = 0.0f;
  }
  if (kCutoff) {  // warp w stages chunk w: its box
    const float bx0 = warp_min(cat ? cxt : INFINITY);
    const float bx1 = warp_max(cat ? cxt : -INFINITY);
    const float by0 = warp_min(cat ? cyt : INFINITY);
    const float by1 = warp_max(cat ? cyt : -INFINITY);
    if (lane == 0) {
      sm.cbox[warp][0] = bx0;
      sm.cbox[warp][1] = bx1;
      sm.cbox[warp][2] = by0;
      sm.cbox[warp][3] = by1;
    }
  }

  // this lane's R rows: local rows lr0 + 32 r
  const int lr0 = rg * L::kWarpRows + lane;
  const int i0 = (int)(ti * kSymTile);
  float xi[kR], yi[kR], vxi[kR], vyi[kR];
  float ri[kR], ax[kR], ay[kR];
  float rbox[kR][4];
  bool ai[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + lr0 + 32 * r;
    const bool row_in = i < rows.n;
    xi[r] = row_in ? rows.x[i] : 0.0f;
    yi[r] = row_in ? rows.y[i] : 0.0f;
    vxi[r] = row_in ? rows.u[i] : 0.0f;
    vyi[r] = row_in ? rows.v[i] : 0.0f;
    ri[r] = row_in ? rows.rad[i] : 0.0f;
    ai[r] = row_in && rows.alive[i] != 0;
    ax[r] = 0.0f;
    ay[r] = 0.0f;
    if (kCutoff) {  // the box of these 32 rows' alive agents
      rbox[r][0] = warp_min(ai[r] ? xi[r] : INFINITY);
      rbox[r][1] = warp_max(ai[r] ? xi[r] : -INFINITY);
      rbox[r][2] = warp_min(ai[r] ? yi[r] : INFINITY);
      rbox[r][3] = warp_max(ai[r] ? yi[r] : -INFINITY);
    }
  }
  const int gi0 = rows.off + i0 + lr0;  // global slot of row r: gi0 + 32 r
  const int g0 = cols.off + j0;
  __syncthreads();

#pragma unroll 1
  for (int q = 0; q < L::kWarpChunks; ++q) {
    const int chunk = cg * L::kWarpChunks + q;
    const int c0 = chunk * 32;
    bool hit[kR];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      // the triangle: some column of the chunk above some row of the 32
      hit[r] = !kTri || j0 + c0 + 31 > i0 + lr0 - lane + 32 * r;
      if (kCutoff)
        hit[r] = hit[r] &&
                 box_gap2(rbox[r][0], rbox[r][1], rbox[r][2], rbox[r][3],
                          sm.cbox[chunk][0], sm.cbox[chunk][1],
                          sm.cbox[chunk][2], sm.cbox[chunk][3]) <= c2;
      any = any || hit[r];
    }
    if (!any) continue;  // (the rows' own triangle test is in ok below)
#pragma unroll 1
    for (int k = 0; k < 32; ++k) {
      // staggered: at each step the 32 lanes of a warp hold 32 distinct
      // columns, so the row group's column partials are written without
      // races or bank conflicts
      const int jj = c0 + ((lane + k) & 31);
      const float cxj = sm.cx[jj], cyj = sm.cy[jj];
      const float cvxj = sm.cvx[jj], cvyj = sm.cvy[jj], crj = sm.cr[jj];
      const bool caj = sm.ca[jj] != 0;
      float cfx = 0.0f, cfy = 0.0f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (kCutoff && !hit[r]) continue;
        const float dx = cxj - xi[r];
        const float dy = cyj - yi[r];
        bool ok = ai[r] && caj;
        ok = ok && (kTri ? (j0 + jj) > (i0 + lr0 + 32 * r)
                         : (g0 + jj) != (gi0 + 32 * r));
        if (kCutoff) {
          ok = ok && sq_norm_rn(dx, dy) <= c2;
          if (!__any_sync(kAll, ok)) continue;
        }
        float fxk, fyk;
        Law::template pair<true>(dx, dy, vxi[r], vyi[r], cvxj, cvyj, ri[r],
                                 crj, use_radius, ok, p, fxk, fyk);
        ax[r] += fxk;
        ay[r] += fyk;
        cfx += fxk;
        cfy += fyk;
      }
      sm.col_x[rg][jj] -= cfx;  // Newton's third law: f_ji = -f_ij
      sm.col_y[rg][jj] -= cfy;
      __syncwarp();
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    sm.row_x[cg][lr0 + 32 * r] = ax[r];
    sm.row_y[cg][lr0 + 32 * r] = ay[r];
  }
  __syncthreads();
  // thread t adds row t's and column t's partials, in a fixed order
  const int it = i0 + tid;
  if (it < rows.n && rows.alive[it] != 0) {
    float sx_sum = 0.0f, sy_sum = 0.0f;
#pragma unroll
    for (int g = 0; g < L::kColGroups; ++g) {
      sx_sum += sm.row_x[g][tid];
      sy_sum += sm.row_y[g][tid];
    }
    atomicAdd(&fx[it], sx_sum);
    atomicAdd(&fy[it], sy_sum);
  }
  if (col_in && cat != 0) {
    float sx_sum = 0.0f, sy_sum = 0.0f;
#pragma unroll
    for (int g = 0; g < L::kRowGroups; ++g) {
      sx_sum += sm.col_x[g][tid];
      sy_sum += sm.col_y[g][tid];
    }
    atomicAdd(&fxc[jt], sx_sum);
    atomicAdd(&fyc[jt], sy_sum);
  }
}

// Block b: tile pair b (or table slot b) of the planes pl (the batched
// kernel passes its crowd's planes, parameters and outputs).
template <int kWalk, class Law>
__device__ __forceinline__ void sym_walk(
    const Planes& pl, const float* __restrict__ prm, int use_radius,
    int n_tiles, const float* __restrict__ bb, const int* __restrict__ surv,
    const int* __restrict__ counts, int max_surv, float c2,
    float* __restrict__ fx, float* __restrict__ fy) {
  __shared__ SymShared sm;
  const typename Law::Prm p = Law::load(prm);
  const long long b = blockIdx.x;
  const long long nt = n_tiles;
  // block-uniform box test of tile pair (ti, tj)
  auto hits = [&](long long ti, long long tj) {
    return box_hits(bb, nt, tj, bb[ti], bb[nt + ti], bb[2 * nt + ti],
                    bb[3 * nt + ti], c2);
  };

  if (kWalk == kSymTable) {
    // slot s of table row r: its s-th surviving tile pair, or, when the row
    // overflowed its table, every s-th column tile of its triangle that
    // passes the box test
    const long long r = b / max_surv;
    const long long s = b % max_surv;
    if (counts[r] <= max_surv) {
      const int tj = surv[r * max_surv + s];
      if (tj >= 0)
        sym_tile_pair<kSymRowsCut, true, true, Law>(
            sm, r, tj, pl, pl, p, use_radius, c2, fx, fy, fx, fy);
    } else {
      for (long long tj = r + s; tj < nt; tj += max_surv)
        if (hits(r, tj))
          sym_tile_pair<kSymRowsCut, true, true, Law>(
              sm, r, tj, pl, pl, p, use_radius, c2, fx, fy, fx, fy);
    }
    return;
  }

  // block -> tile pair (ti, tj) with tj >= ti
  const double q = (double)(2 * nt + 1);
  long long ti = (long long)((q - sqrt(q * q - 8.0 * (double)b)) * 0.5);
  if (ti < 0) ti = 0;
  if (ti > nt - 1) ti = nt - 1;
  while (ti > 0 && tri_start(ti, nt) > b) --ti;
  while (ti + 1 < nt && tri_start(ti + 1, nt) <= b) ++ti;
  const long long tj = ti + (b - tri_start(ti, nt));
  if (kWalk == kTriangleBox && !hits(ti, tj)) return;  // before any staging
  constexpr bool kCut = kWalk == kTriangleBox;
  sym_tile_pair<kCut ? kSymRowsCut : kSymRows, true, kCut, Law>(
      sm, ti, tj, pl, pl, p, use_radius, c2, fx, fy, fx, fy);
}

template <int kWalk, class Law>
__global__ void __launch_bounds__(kSymTile)
pair_force_sym_kernel(Planes pl, const float* __restrict__ prm,
                      int use_radius, int n_tiles, const float* __restrict__ bb,
                      const int* __restrict__ surv,
                      const int* __restrict__ counts, int max_surv, float c2,
                      float* __restrict__ fx, float* __restrict__ fy) {
  sym_walk<kWalk, Law>(pl, prm, use_radius, n_tiles, bb, surv, counts,
                       max_surv, c2, fx, fy);
}

// The kTriangle walk over a batch of crowds of pl.n agents: crowd
// blockIdx.y's planes and outputs at blockIdx.y * pl.n, its parameters at
// blockIdx.y * prm_stride.
template <class Law>
__global__ void __launch_bounds__(kSymTile)
pair_force_sym_batched_kernel(Planes pl, const float* __restrict__ prm,
                              int prm_stride, int use_radius, int n_tiles,
                              float* __restrict__ fx,
                              float* __restrict__ fy) {
  const int bo = (int)blockIdx.y * pl.n;
  sym_walk<kTriangle, Law>(batch_row(pl, bo),
                           prm + (int)blockIdx.y * prm_stride, use_radius,
                           n_tiles, nullptr, nullptr, nullptr, 1, 0.0f,
                           fx + bo, fy + bo);
}

// The full-block walk: block b is tile pair (b / n_col_tiles, b %
// n_col_tiles) of the rectangular (rows x columns) grid of 128-agent tiles.
// kBox: the pair runs only when the rows' tile box (row_bb) and the
// columns' (col_bb) lie within the cutoff.
template <bool kBox, class Law>
__global__ void __launch_bounds__(kSymTile)
pair_force_sym_dense_kernel(Planes rows, Planes cols,
                            const float* __restrict__ prm, int use_radius,
                            int n_row_tiles, int n_col_tiles,
                            const float* __restrict__ row_bb,
                            const float* __restrict__ col_bb, float c2,
                            float* __restrict__ fx, float* __restrict__ fy,
                            float* __restrict__ fxc, float* __restrict__ fyc) {
  __shared__ SymShared sm;
  const typename Law::Prm p = Law::load(prm);
  const long long ti = blockIdx.x / n_col_tiles;
  const long long tj = blockIdx.x % n_col_tiles;
  const long long nr = n_row_tiles;
  if (kBox && !box_hits(col_bb, n_col_tiles, tj, row_bb[ti], row_bb[nr + ti],
                        row_bb[2 * nr + ti], row_bb[3 * nr + ti], c2))
    return;  // before any staging
  sym_tile_pair<kBox ? kSymRowsCut : kSymRows, false, kBox, Law>(
      sm, ti, tj, rows, cols, p, use_radius, c2, fx, fy, fxc, fyc);
}

// Launch of a dense walk with law Law: one block per row block and split,
// the splits of a row block one cluster (of one block when n_split = 1).
// With prm_stride >= 0 the launch is the batched kAllTiles walk over
// batch square crowds of rows.n agents (pair_force_dense_batched_kernel).
template <int kWalk, class Law>
int dense_launch(const Planes& rows, const Planes& cols, const float* prm,
                 int use_radius, const float* col_bb, const int* surv,
                 const int* counts, int max_surv, float c2, float* fx,
                 float* fy, void* stream, int batch = 1,
                 int prm_stride = -1) {
  const bool batched = prm_stride >= 0;
  if (rows.n <= 0) return (int)cudaSuccess;
  if (cols.n < 0 || batch < 1 || batch > 65535 ||
      (batched && (kWalk != kAllTiles || cols.n != rows.n)))
    return (int)cudaErrorInvalidValue;
  if (kWalk == kTable && max_surv < 1) return (int)cudaErrorInvalidValue;
  const int n_split = dense_splits<kWalk>(rows.n, cols.n, batch);
  const long long blocks =
      (long long)((rows.n + kDenseBlockRows - 1) / kDenseBlockRows) * n_split;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)batch);
  cfg.blockDim = dim3(kDenseThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      batched ? cudaLaunchKernelEx(&cfg, pair_force_dense_batched_kernel<Law>,
                                   rows, cols, prm, prm_stride, use_radius,
                                   n_split, fx, fy)
              : cudaLaunchKernelEx(&cfg, pair_force_dense_kernel<kWalk, Law>,
                                   rows, cols, prm, use_radius, col_bb, surv,
                                   counts, max_surv, c2, n_split, fx, fy);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Launch of a symmetric walk with law Law: one block per tile pair of the
// upper triangle (kTriangle, kTriangleBox) or per table slot (kSymTable).
// With prm_stride >= 0 the launch is the batched kTriangle walk over batch
// crowds of pl.n agents (pair_force_sym_batched_kernel).
template <int kWalk, class Law>
int sym_launch(const Planes& pl, const float* prm, int use_radius,
               const float* bb, const int* surv, const int* counts,
               int max_surv, float c2, float* fx, float* fy, void* stream,
               int batch = 1, int prm_stride = -1) {
  const bool batched = prm_stride >= 0;
  const int n = pl.n;
  if (n <= 0) return (int)cudaSuccess;
  if (batch < 1 || batch > 65535 || (batched && kWalk != kTriangle))
    return (int)cudaErrorInvalidValue;
  if (kWalk == kSymTable && max_surv < 1) return (int)cudaErrorInvalidValue;
  const long long nt = (n + kSymTile - 1) / kSymTile;
  const long long blocks =
      kWalk == kSymTable ? nt * max_surv : nt * (nt + 1) / 2;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  if (batched)
    pair_force_sym_batched_kernel<Law>
        <<<grid, kSymTile, 0, (cudaStream_t)stream>>>(
            pl, prm, prm_stride, use_radius, (int)nt, fx, fy);
  else
    pair_force_sym_kernel<kWalk, Law>
        <<<grid, kSymTile, 0, (cudaStream_t)stream>>>(
            pl, prm, use_radius, (int)nt, bb, surv, counts, max_surv, c2, fx,
            fy);
  return (int)cudaGetLastError();
}

// Launch of the full-block walk with law Law: one block per tile pair.
template <bool kBox, class Law>
int sym_dense_launch(const Planes& rows, const Planes& cols, const float* prm,
                     int use_radius, const float* row_bb, const float* col_bb,
                     float c2, float* fx, float* fy, float* fxc, float* fyc,
                     void* stream) {
  if (rows.n <= 0 || cols.n <= 0) return (int)cudaSuccess;
  const long long nr = (rows.n + kSymTile - 1) / kSymTile;
  const long long nc = (cols.n + kSymTile - 1) / kSymTile;
  if (nr * nc > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pair_force_sym_dense_kernel<kBox, Law><<<(unsigned)(nr * nc), kSymTile, 0,
                                           (cudaStream_t)stream>>>(
      rows, cols, prm, use_radius, (int)nr, (int)nc, row_bb, col_bb, c2, fx,
      fy, fxc, fyc);
  return (int)cudaGetLastError();
}

Planes planes(const float* x, const float* y, const float* u, const float* v,
              const float* rad, const uint8_t* alive, int n, int off) {
  return Planes{x, y, u, v, rad, alive, n, off};
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError(): non-zero
// means the launch was refused (an unknown law id, or a law the walk does
// not take: cudaErrorInvalidValue).  `law` is a LawId: 0 the Moussaid law
// (prm: lambda, A, gamma, n, n_prime, epsilon; use_radius subtracts the
// radii from the distance), 1 the power law (prm: k, tau0, tau_max,
// tau_min; disc radii always participate, use_radius is not read), 2 the
// Helbing ellipse (prm: v0, sigma, cos_phi, fov_factor, step_width, b_min;
// dense walks only; rad is not read, and the row planes ru, rv carry each
// row's unit desired direction).
//
// The dense walks take row planes (rx, ry, ru, rv, rrad, ralive: n_rows
// agents from global slot row_off) and column planes (cx, cy, cvx, cvy,
// crad, calive: n_cols agents from global slot col_off) and overwrite every
// row of fx, fy; the square call passes the same planes twice with both
// offsets 0.  The symmetric walks take one set of planes and accumulate into
// fx, fy, which must hold zeros on entry.  The full-block walks take row and
// column planes and accumulate +f into the rows' fx, fy and -f into the
// columns' fxc, fyc, all zero on entry.
//
// Cutoff forms: c2 is the squared cutoff; col_bb / bb / row_bb hold tile
// boxes of alive agents as (4, n_tiles) rows [min_x, max_x, min_y, max_y]:
// 256-column tiles for the dense forms, 128-agent tiles for the symmetric
// and full-block forms; surv is the (ceil(n_rows / 128), max_surv) survivor
// table, ascending and padded with -1, and counts each table row's number
// of hits.
int sfm_pair_dense(int law, const float* rx, const float* ry, const float* ru,
                   const float* rv, const float* rrad, const uint8_t* ralive,
                   int n_rows, int row_off, const float* cx, const float* cy,
                   const float* cvx, const float* cvy, const float* crad,
                   const uint8_t* calive, int n_cols, int col_off,
                   const float* prm, int use_radius, float* fx, float* fy,
                   void* stream) {
  const Planes rows = planes(rx, ry, ru, rv, rrad, ralive, n_rows, row_off);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n_cols, col_off);
  return with_any_law(law, [&](auto l) {
    return dense_launch<kAllTiles, decltype(l)>(rows, cols, prm, use_radius,
                                                nullptr, nullptr, nullptr, 1,
                                                0.0f, fx, fy, stream);
  });
}

int sfm_pair_dense_cutoff(int law, const float* rx, const float* ry,
                          const float* ru, const float* rv, const float* rrad,
                          const uint8_t* ralive, int n_rows, int row_off,
                          const float* cx, const float* cy, const float* cvx,
                          const float* cvy, const float* crad,
                          const uint8_t* calive, int n_cols, int col_off,
                          const float* prm, int use_radius,
                          const float* col_bb, float c2, float* fx, float* fy,
                          void* stream) {
  const Planes rows = planes(rx, ry, ru, rv, rrad, ralive, n_rows, row_off);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n_cols, col_off);
  return with_any_law(law, [&](auto l) {
    return dense_launch<kBoxSkip, decltype(l)>(rows, cols, prm, use_radius,
                                               col_bb, nullptr, nullptr, 1,
                                               c2, fx, fy, stream);
  });
}

int sfm_pair_compact(int law, const float* rx, const float* ry,
                     const float* ru, const float* rv, const float* rrad,
                     const uint8_t* ralive, int n_rows, int row_off,
                     const float* cx, const float* cy, const float* cvx,
                     const float* cvy, const float* crad,
                     const uint8_t* calive, int n_cols, int col_off,
                     const float* prm, int use_radius, const float* col_bb,
                     const int* surv, const int* counts, int max_surv,
                     float c2, float* fx, float* fy, void* stream) {
  const Planes rows = planes(rx, ry, ru, rv, rrad, ralive, n_rows, row_off);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n_cols, col_off);
  return with_any_law(law, [&](auto l) {
    return dense_launch<kTable, decltype(l)>(rows, cols, prm, use_radius,
                                             col_bb, surv, counts, max_surv,
                                             c2, fx, fy, stream);
  });
}

int sfm_pair_sym(int law, const float* x, const float* y, const float* vx,
                 const float* vy, const float* rad, const uint8_t* alive,
                 const float* prm, int use_radius, int n, float* fx,
                 float* fy, void* stream) {
  const Planes pl = planes(x, y, vx, vy, rad, alive, n, 0);
  return with_antisymmetric_law(law, [&](auto l) {
    return sym_launch<kTriangle, decltype(l)>(pl, prm, use_radius, nullptr,
                                              nullptr, nullptr, 1, 0.0f, fx,
                                              fy, stream);
  });
}

int sfm_pair_sym_cutoff(int law, const float* x, const float* y,
                        const float* vx, const float* vy, const float* rad,
                        const uint8_t* alive, const float* prm,
                        int use_radius, int n, const float* bb, float c2,
                        float* fx, float* fy, void* stream) {
  const Planes pl = planes(x, y, vx, vy, rad, alive, n, 0);
  return with_antisymmetric_law(law, [&](auto l) {
    return sym_launch<kTriangleBox, decltype(l)>(pl, prm, use_radius, bb,
                                                 nullptr, nullptr, 1, c2, fx,
                                                 fy, stream);
  });
}

int sfm_pair_sym_compact(int law, const float* x, const float* y,
                         const float* vx, const float* vy, const float* rad,
                         const uint8_t* alive, const float* prm,
                         int use_radius, int n, const float* bb,
                         const int* surv, const int* counts, int max_surv,
                         float c2, float* fx, float* fy, void* stream) {
  const Planes pl = planes(x, y, vx, vy, rad, alive, n, 0);
  return with_antisymmetric_law(law, [&](auto l) {
    return sym_launch<kSymTable, decltype(l)>(pl, prm, use_radius, bb, surv,
                                              counts, max_surv, c2, fx, fy,
                                              stream);
  });
}

int sfm_pair_sym_dense(int law, const float* rx, const float* ry,
                       const float* rvx, const float* rvy, const float* rrad,
                       const uint8_t* ralive, int n_rows, int row_off,
                       const float* cx, const float* cy, const float* cvx,
                       const float* cvy, const float* crad,
                       const uint8_t* calive, int n_cols, int col_off,
                       const float* prm, int use_radius, float* fx, float* fy,
                       float* fxc, float* fyc, void* stream) {
  const Planes rows = planes(rx, ry, rvx, rvy, rrad, ralive, n_rows, row_off);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n_cols, col_off);
  return with_antisymmetric_law(law, [&](auto l) {
    return sym_dense_launch<false, decltype(l)>(rows, cols, prm, use_radius,
                                                nullptr, nullptr, 0.0f, fx,
                                                fy, fxc, fyc, stream);
  });
}

int sfm_pair_sym_dense_cutoff(int law, const float* rx, const float* ry,
                              const float* rvx, const float* rvy,
                              const float* rrad, const uint8_t* ralive,
                              int n_rows, int row_off, const float* cx,
                              const float* cy, const float* cvx,
                              const float* cvy, const float* crad,
                              const uint8_t* calive, int n_cols, int col_off,
                              const float* prm, int use_radius,
                              const float* row_bb, const float* col_bb,
                              float c2, float* fx, float* fy, float* fxc,
                              float* fyc, void* stream) {
  const Planes rows = planes(rx, ry, rvx, rvy, rrad, ralive, n_rows, row_off);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n_cols, col_off);
  return with_antisymmetric_law(law, [&](auto l) {
    return sym_dense_launch<true, decltype(l)>(rows, cols, prm, use_radius,
                                               row_bb, col_bb, c2, fx, fy,
                                               fxc, fyc, stream);
  });
}

// The batched walks: batch independent crowds of n agents, every plane
// (batch, n) row-major, prm (batch, P) with rows prm_stride apart (0: one
// vector for every crowd); one launch.  sym_batched accumulates into fx,
// fy (zeros on entry) like sfm_pair_sym; dense_batched takes the square
// call's row and column planes (Helbing's rows carry the desired
// directions) and overwrites every row.
int sfm_pair_sym_batched(int law, const float* x, const float* y,
                         const float* vx, const float* vy, const float* rad,
                         const uint8_t* alive, const float* prm,
                         int prm_stride, int use_radius, int n, int batch,
                         float* fx, float* fy, void* stream) {
  const Planes pl = planes(x, y, vx, vy, rad, alive, n, 0);
  return with_antisymmetric_law(law, [&](auto l) {
    return sym_launch<kTriangle, decltype(l)>(pl, prm, use_radius, nullptr,
                                              nullptr, nullptr, 1, 0.0f, fx,
                                              fy, stream, batch, prm_stride);
  });
}

int sfm_pair_dense_batched(int law, const float* rx, const float* ry,
                           const float* ru, const float* rv,
                           const float* rrad, const uint8_t* ralive,
                           const float* cx, const float* cy,
                           const float* cvx, const float* cvy,
                           const float* crad, const uint8_t* calive,
                           const float* prm, int prm_stride, int use_radius,
                           int n, int batch, float* fx, float* fy,
                           void* stream) {
  const Planes rows = planes(rx, ry, ru, rv, rrad, ralive, n, 0);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n, 0);
  return with_any_law(law, [&](auto l) {
    return dense_launch<kAllTiles, decltype(l)>(
        rows, cols, prm, use_radius, nullptr, nullptr, nullptr, 1, 0.0f, fx,
        fy, stream, batch, prm_stride);
  });
}

const char* sfm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
