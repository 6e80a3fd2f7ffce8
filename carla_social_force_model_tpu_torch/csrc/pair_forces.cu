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
// _pair_kernel_sym, _pair_kernel and _pair_kernel_compact gain a leading
// batch axis on every plane, box, table and parameter vector
// (pallas_forces.py:167-168).  Here every square walk takes B independent
// crowds in one launch (pair_force_dense_batched_kernel<kWalk>,
// pair_force_sym_batched_kernel<kWalk>; entries sfm_pair_<form>_batched):
// the grid's y index is the crowd, whose planes and outputs lie at
// blockIdx.y * n, whose parameters at blockIdx.y * prm_stride (0: every
// crowd shares one vector), and, in the cutoff walks, whose tile boxes at
// blockIdx.y * 4 * n_tiles, survivor table at blockIdx.y * nt * max_surv
// and counts at blockIdx.y * nt (nt: 128-row table rows).  A crowd's
// table overflows on its own.  A batched kernel hands its crowd's pointers
// to the walk body the unbatched kernel runs (dense_walk, sym_walk), so
// row b of a dense walk sums in the unbatched launch's order and equals it
// bitwise, and the unbatched kernels compile without a batch offset (one
// read from blockIdx.y inside the shared bodies cost 8% on the dense walk
// at 10k).  The batched table walk and, above kBoxSkipTileWalk column
// tiles, the batched box-skip walk are the exception: their body is their
// own (chunk_walk, which culls and stages single 32-column chunks and lets
// each lane walk its own pairs), in dense_walk's order of additions, so
// they too equal the unbatched launch bitwise.  So is the batched all-tiles
// walk's (dense_batch_walk: a block holds up to eight 32-row sets of one
// crowd and stages its columns once for all of them).  The batched symmetric
// cutoff walks have a body of their own too (sym_rows_walk: one block per
// crowd and 128-row tile, walking its row's column tiles), and so have the
// batched symmetric walks without a cutoff, the triangle and the full
// block (sym_batch_walk: a block holds a 128-row tile in registers across
// a run of column tiles); like the unbatched walk, these equal the plain
// version up to f32 summation order.
// The dense walks' cluster split sees the whole grid (B row sets).  A
// batch of crowds whose slots
// are sharded over an agent axis (the JAX package's
// make_sharded_ensemble_rollout: the kernels of _slab_call
// under vmap) takes the same dense kernel in rectangular form (entries
// sfm_pair_<dense|dense_cutoff|compact>_rect_batched: _pair_kernel and
// _pair_kernel_compact with a batch axis; the square entries are its case
// cols.n = rows.n) and pair_force_sym_dense_batched_kernel<kBox>
// (sfm_pair_sym_dense[_cutoff]_batched: _pair_kernel_sym_dense with a batch
// axis), crowd b's rows at blockIdx.y * n_rows and its columns at
// blockIdx.y * n_cols, the global slots of both sides the same in every
// crowd.  They too hand their crowd's pointers to a walk body: the
// unbatched ones (dense_walk; sym_tile_pair for the full block's box
// form) or their own (dense_batch_walk, chunk_walk, sym_batch_walk).
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

#include <algorithm>
#include <cooperative_groups.h>
#include <type_traits>

#include "block_box.cuh"
#include "pair_laws.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSymTile = 128;  // rows == columns of one tile pair
constexpr int kSymWarps = kSymTile / 32;  // threads per block: kSymTile
// R: rows per thread of the symmetric tile pair (sym_tile_pair): kSymRows
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
// The batched box-skip and table walks (chunk_walk): each warp keeps a
// window of kChunkWindow staged chunks (PERF.md: 2 and 3 measured).  Its
// launch bounds ask for kChunkBlocks blocks an SM for the Moussaid law (40
// registers a thread) and kChunkBlocksLean for the power law and Helbing
// (48, no spills): 7 and 8 blocks give 32 registers, and the pair loop
// then spills (PERF.md: 5-8 measured).
constexpr int kChunkWindow = 3;
constexpr int kChunkBlocks = 6;
constexpr int kChunkBlocksLean = 5;
constexpr int kChunkFields = 5;  // a staged column: x, y, u, v, radius
// A batched box-skip launch whose columns span at most kBoxSkipTileWalk
// 256-column tiles takes dense_walk (kBoxSkipTiles) instead: there a row
// block's box reaches nearly every tile and most of their chunks, so
// culling by chunk saves few law steps and chunk_walk's dearer step loses
// (PERF.md: chunk_walk slower at 1 and 4 tiles, faster at 49 and 196).
// A function of the launch's shapes only.
constexpr int kBoxSkipTileWalk = 8;

// how a dense-layout block chooses its column tiles: kBoxSkipTiles is the
// box-skip walk by tile (dense_walk<kBoxSkip>) where a batched launch's
// columns are few (kBoxSkipTileWalk)
enum DenseWalk { kAllTiles, kBoxSkip, kTable, kBoxSkipTiles };
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

// The blocks that share a row block's parts in the batched box-skip and
// table walks (chunk_walk):
// dense_splits, and at least 2 where the columns are two or more shards'
// worth of the rows gathered (D runs each sorted on its own curve, whose
// halves of the parts both hold a row block's hits; in one sorted crowd a
// row block's hits lie in one part or two, and the idle block of a pair
// would hold its SM slot until the fold).  A function of the launch's
// shapes only.
int chunk_splits(int n_rows, int n_cols, int batch) {
  const int parts =
      dense_parts(n_cols / kColTile + (n_cols % kColTile != 0));
  const int s = dense_splits<kTable>(n_rows, n_cols, batch);
  const int least = parts >= 2 && n_cols >= 2 * (long long)n_rows ? 2 : 1;
  return s > least ? s : least;
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

// cp.async of 4 bytes from global into shared memory, and the wait for
// every copy of the thread
__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// The batched box-skip and table walks (pair_force_dense_batched_kernel<
// kBoxSkip | kTable, Law>), designed for the shapes they run: B crowds, and
// a shard's rows against the gathered columns or another shard's block,
// each sorted on its own curve, so that a 32-row block and a 256-column
// tile span about twice the width they span in one sorted crowd and most
// of a hit tile's chunks hold no pair (PERF.md).  The block's 32 rows and
// its parts are dense_walk's, but nothing is staged or tested by tile:
// warp q owns chunk slot q of every tile and walks it alone.  It tests the
// 32-column boxes of its candidates' slot-q chunks (chunk_bb: every tile
// of the block's parts in the box-skip walk and where a table row
// overflowed, else the table row's listed tiles in the block's parts), 32
// at a time, one per lane, and compacts the hits with a ballot.  It stages
// its hit chunks into its own window of kChunkWindow shared-memory buffers
// (cp.async; __syncwarp, never a block barrier), where each lane marks the
// columns within the cutoff of its row (a mask a chunk, in registers).
// Then each lane walks its own marked pairs, in column order, up to
// kChunkWindow chunks ahead of the slowest lane: a warp's law evaluations
// are about the most pairs of one lane, where dense_walk's are every
// column that any lane reaches.  A lane adds each chunk's sum (a fold from
// +0 over its pairs) to its slot sum of the chunk's part, in shared
// memory; the block's only barrier is before the parts are folded.  So a
// row's sum is dense_walk's order of additions (parts, chunk slots, tiles,
// columns), every skipped chunk and column adding exactly +0: each crowd
// equals the unbatched launch bitwise.
template <int kWalk, class Law>
__device__ __forceinline__ void chunk_walk(
    const Planes& rows, const Planes& cols, const float* __restrict__ prm,
    int use_radius, const float* __restrict__ chunk_bb,
    const int* __restrict__ surv, const int* __restrict__ counts,
    int max_surv, float c2, int n_split, float* __restrict__ fx,
    float* __restrict__ fy) {
  constexpr int kWarps = kDenseCols;
  constexpr int kWin = kChunkWindow;
  static_assert(kWarps == kTileChunks && kDenseRows == 1,
                "warp q walks chunk slot q of 32 rows, one a lane");
  // the staged columns, one plane of 32 words a field: a lane's pair reads
  // its column's word of each (lanes at different columns of a chunk hit
  // different banks), all five at fixed offsets from one address
  __shared__ float win[kWarps][kWin][kChunkFields][kChunk];
  __shared__ int win_t[kWarps][kWin];       // the chunk's tile
  __shared__ int win_p[kWarps][kWin];       // its part, from p_lo
  __shared__ unsigned win_a[kWarps][kWin];  // its alive columns
  __shared__ float slot_x[kMaxSplit][kTileChunks][kChunk];
  __shared__ float slot_y[kMaxSplit][kTileChunks][kChunk];

  const typename Law::Prm p = Law::load(prm);
  const int tid = threadIdx.x;
  const int warp = tid / 32;  // the chunk slot
  const int lane = tid % 32;
  const int rb = blockIdx.x / n_split;
  const int split = (int)(blockIdx.x % n_split);
  const int n = cols.n;
  const int nct = n / kColTile + (n % kColTile != 0);
  const int n_chunks = n / kChunk + (n % kChunk != 0);
  const int n_parts = dense_parts(nct);
  const int p_lo = split * n_parts / n_split;
  const int p_hi = (split + 1) * n_parts / n_split;
  const int t0 = p_lo * nct / n_parts;  // this block's tiles
  const int t1 = p_hi * nct / n_parts;
  const int i_blk = rb * kChunk;

  const int i = i_blk + lane;
  const bool in = i < rows.n;
  const float x = in ? rows.x[i] : 0.0f;
  const float y = in ? rows.y[i] : 0.0f;
  const float u = in ? rows.u[i] : 0.0f;
  const float v = in ? rows.v[i] : 0.0f;
  const float r = (in && Law::kRadius) ? rows.rad[i] : 0.0f;
  const bool ra = in && rows.alive[i] != 0;
  const int g = rows.off + i;
  const float bx0 = warp_min(ra ? x : INFINITY);
  const float bx1 = warp_max(ra ? x : -INFINITY);
  const float by0 = warp_min(ra ? y : INFINITY);
  const float by1 = warp_max(ra ? y : -INFINITY);
  for (int pp = 0; pp < p_hi - p_lo; ++pp) {  // this lane's own slot sums
    slot_x[pp][warp][lane] = 0.0f;
    slot_y[pp][warp][lane] = 0.0f;
  }

  // the next hit chunk of slot `warp`, in ascending tile order, or -1: the
  // candidates 32 at a time, one per lane, compacted by a ballot
  const int trow = i_blk / kSymTile;
  bool table = false;
  if constexpr (kWalk == kTable) table = counts[trow] <= max_surv;
  const int n_cand = table ? counts[trow] : t1 - t0;
  int base = 0, cand = -1;
  unsigned hits = 0;
  auto next_hit = [&]() -> int {
    while (hits == 0) {
      if (base >= n_cand) return -1;
      const int k = base + lane;
      int t = -1;
      bool h = false;
      if (k < n_cand) {
        t = table ? surv[(long long)trow * max_surv + k] : t0 + k;
        h = t >= t0 && t < t1 && t * kColTile + warp * kChunk < n &&
            box_hits(chunk_bb, n_chunks, (long long)t * kTileChunks + warp,
                     bx0, bx1, by0, by1, c2);
      }
      cand = t;
      hits = __ballot_sync(kAllLanes, h);
      base += kChunk;
    }
    const int b = __ffs(hits) - 1;
    hits &= hits - 1;
    return __shfl_sync(kAllLanes, cand, b);
  };

  // the window: hit chunks [tail, staged) are staged, chunk s in buffer
  // s % kWin with this lane's pairs in wm[s % kWin] and bit s % kWin of
  // newp set where its part is not the previous chunk's; the lane is at
  // chunk cur, in buffer cb (its columns at wb), whose pairs left are m,
  // the chunk's sum so far (cx, cy) and its part pcur's slot sum so far
  // (ax, ay)
  unsigned wm[kWin] = {};
  unsigned newp = 0;
  int staged = 0, cur = 0, cb = 0, tail = 0, t_next = next_hit();
  int last_part = -1, pcur = -1;
  const float* wb = &win[warp][0][0][0];
  unsigned m = 0;
  float cx = 0.0f, cy = 0.0f, ax = 0.0f, ay = 0.0f;
  // the lane enters the chunk in buffer cb: its pairs, and at a new part
  // the slot sum of the part it leaves
  auto enter = [&]() {
    unsigned got = 0;
#pragma unroll
    for (int q = 0; q < kWin; ++q) got = q == cb ? wm[q] : got;
    m = got;
    if ((newp >> cb) & 1u) {
      if (pcur >= 0) {
        slot_x[pcur][warp][lane] = ax;
        slot_y[pcur][warp][lane] = ay;
      }
      ax = 0.0f;
      ay = 0.0f;
      pcur = win_p[warp][cb];
    }
  };
  while (tail < staged || t_next >= 0) {
    // stage hits while the window has room; each lane marks its pairs
    const int first = staged;
    for (; t_next >= 0 && staged < tail + kWin; ++staged) {
      const int b = staged % kWin;
      const int j = t_next * kColTile + warp * kChunk + lane;
      const bool col = j < n;
      if (col) {
        float* w = &win[warp][b][0][lane];
        cp_async4(w, cols.x + j);
        cp_async4(w + kChunk, cols.y + j);
        cp_async4(w + 2 * kChunk, cols.u + j);
        cp_async4(w + 3 * kChunk, cols.v + j);
        if (Law::kRadius) cp_async4(w + 4 * kChunk, cols.rad + j);
      }
      const unsigned am = __ballot_sync(kAllLanes, col && cols.alive[j]);
      const int part = ((t_next + 1) * n_parts - 1) / nct - p_lo;
      newp = part != last_part ? newp | 1u << b : newp & ~(1u << b);
      last_part = part;
      if (lane == 0) {
        win_t[warp][b] = t_next;
        win_p[warp][b] = part;
        win_a[warp][b] = am;
      }
      t_next = next_hit();
    }
    cp_async_wait_all();
    __syncwarp();
    for (int s = first; s < staged; ++s) {
      const int b = s % kWin;
      const int g0 = cols.off + win_t[warp][b] * kColTile + warp * kChunk;
      unsigned mine = 0;
      for (unsigned am = win_a[warp][b]; am != 0; am &= am - 1) {
        const int c = __ffs(am) - 1;
        const float* w = &win[warp][b][0][c];
        if (ra && g0 + c != g && sq_norm_rn(w[0] - x, w[kChunk] - y) <= c2)
          mine |= 1u << c;
      }
#pragma unroll
      for (int q = 0; q < kWin; ++q) wm[q] = q == b ? mine : wm[q];
    }
    if (cur == first && cur < staged) enter();
    // the law steps, one pair a lane, until the slowest lane has moved on
    // (room for the next hit) or every lane is through the staged chunks
    for (;;) {
      // close the lane's chunks with no pair left: the chunk's sum into
      // the slot sum of its part
#pragma unroll 1
      while (m == 0 && cur < staged) {
        ax += cx;
        ay += cy;
        cx = 0.0f;
        cy = 0.0f;
        cb = cb + 1 == kWin ? 0 : cb + 1;
        wb = &win[warp][cb][0][0];
        if (++cur < staged) enter();
      }
      if (__all_sync(kAllLanes, cur > tail)) {  // the slowest lane moved
        tail = __reduce_min_sync(kAllLanes, cur);
        if (tail == staged || (t_next >= 0 && staged < tail + kWin)) break;
      }
      const bool ok = m != 0;
      const int c = ok ? __ffs(m) - 1 : 0;
      m &= m - 1;
      const float* w = wb + c;
      float fxk, fyk;
      Law::template pair<kDenseFastTail>(
          w[0] - x, w[kChunk] - y, u, v, w[2 * kChunk], w[3 * kChunk], r,
          Law::kRadius ? w[4 * kChunk] : 0.0f, use_radius, ok, p, fxk, fyk);
      cx += fxk;
      cy += fyk;
    }
    __syncwarp();  // every lane is done with the buffers refilled next
  }
  if (pcur >= 0) {  // the last part's slot sum
    slot_x[pcur][warp][lane] = ax;
    slot_y[pcur][warp][lane] = ay;
  }

  // each row: its parts' sums (a fold over the chunk slots) in order, from
  // every block of the cluster
  __syncthreads();
  for (int row = tid; row < kChunk; row += kDenseThreads) {
    for (int pp = 0; pp < p_hi - p_lo; ++pp) {
      float sx = slot_x[pp][0][row], sy = slot_y[pp][0][row];
#pragma unroll
      for (int q = 1; q < kTileChunks; ++q) {
        sx += slot_x[pp][q][row];
        sy += slot_y[pp][q][row];
      }
      slot_x[pp][0][row] = sx;  // the part's sum
      slot_y[pp][0][row] = sy;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (kChunk + n_split - 1) / n_split;
  for (int k = tid; k < per; k += kDenseThreads) {
    const int row = split * per + k;
    const int ir = i_blk + row;
    if (row >= kChunk || ir >= rows.n) continue;
    float sx = 0.0f, sy = 0.0f;
    for (int b = 0; b < n_split; ++b) {
      const float* px = cluster.map_shared_rank(&slot_x[0][0][0], b);
      const float* py = cluster.map_shared_rank(&slot_y[0][0][0], b);
      const int q_n = (b + 1) * n_parts / n_split - b * n_parts / n_split;
      for (int q = 0; q < q_n; ++q) {
        sx += px[q * kTileChunks * kChunk + row];
        sy += py[q * kTileChunks * kChunk + row];
      }
    }
    fx[ir] = sx;
    fy[ir] = sy;
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// The batched all-tiles walk's own body (dense_batch_walk, run by
// pair_force_dense_batched_kernel<kAllTiles, Law>; pair_force_dense_kernel
// and the batched box-skip walk by tile keep dense_walk and its SASS).  At
// the batches' shapes (config #5: 256 crowds of 1,000; the 2-D mesh: 128
// crowds of a shard's 250 rows against the 1,000 gathered columns or a
// 250-column ring block) dense_walk gave each block one 32-row set, whose
// warps walked 125 law steps (32 on the ring block) against a fixed cost:
// zeroing the slot and part sums, a staging between two barriers a tile, a
// flush behind a barrier a part and two cluster syncs (PERF.md rows 2b and
// 2r-b).  Here a block holds `sets` 32-row sets of one crowd: warp w holds
// row set w % sets and walks chunk slots w / sets, w / sets + 8 / sets, ...
// of each tile, `sets` chunks a tile.  The block stages up to
// kDenseBatchWindow column tiles at once for all its row sets (a crowd's
// 1,000 columns, the mesh's gathered columns and its ring block: all of
// them), with 4-byte cp.async copies of each plane's word into its slot of
// the tile (no 16-byte copy fits: a crowd's planes start at b x n x 4
// bytes, and the tile interleaves five planes and a byte plane), so the
// pair loop runs without a barrier; it restages only where the block's
// columns are wider.  A row's sum keeps dense_walk's order of additions:
// over the parts (a left fold from +0), of the sum over a tile's eight
// chunk slots, of the slot's sum over the part's tiles, of the chunk's
// columns (each from +0).  A warp walks each part slot by slot, each slot
// over the part's tiles: with sets = 8 it holds all eight slots of its rows
// and folds them in registers; with fewer, the slot sums go to shared
// memory (two buffers by the part's parity) and, after a barrier, thread r
// folds block row r's in slot order.  So every crowd equals the unbatched
// launch bitwise.  `sets` and the blocks a row block's parts are split
// over (a cluster that folds its part sums through distributed shared
// memory; no cluster without a split) come from the shapes
// (dense_batch_layout).
constexpr int kDenseBatchRows = 1;    // rows a lane holds: one row set a warp
constexpr int kDenseBatchBlocks = 4;  // resident blocks an SM (PERF.md)
constexpr int kDenseBatchWindow = 4;  // column tiles staged at once
static_assert(kDenseBatchRows == 1, "a warp's rows are one 32-row set");

// dense_batch_walk's dynamic shared memory, in floats: the part sums of a
// split row block ([the block's parts][x, y][block row]), then the slot
// sums where a warp holds fewer than the eight slots of its rows ([part
// parity][slot][x, y][block row]); the staged column tiles (ColTile)
// follow.  Functions of the launch's shapes, so every block of a cluster
// lays them out alike.
__host__ __device__ constexpr int dense_batch_part_floats(int n_parts,
                                                        int splits,
                                                        int sets) {
  return splits > 1 ? (n_parts + splits - 1) / splits * 2 * 32 * sets : 0;
}

__host__ __device__ constexpr int dense_batch_slot_floats(int sets) {
  return sets < kTileChunks ? 2 * kTileChunks * 2 * 32 * sets : 0;
}

static_assert(4 * (dense_batch_part_floats(kMaxSplit, 2, 4) +
                   dense_batch_slot_floats(4)) +
                      kDenseBatchWindow * sizeof(ColTile) <=
                  48 * 1024,
              "dense_batch_walk's largest layout needs no opt-in to more "
              "than 48 KB of dynamic shared memory");

template <class Law>
__device__ __forceinline__ void dense_batch_walk(
    const Planes& rows, const Planes& cols, const float* __restrict__ prm,
    int use_radius, int sets, int n_split, float* __restrict__ fx,
    float* __restrict__ fy) {
  extern __shared__ float4 dense_batch_smem[];
  const typename Law::Prm p = Law::load(prm);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ir = warp % sets;  // this warp's row set of the block
  const int cq = warp / sets;  // its first chunk slot of each tile
  const int cstep = kTileChunks / sets;
  const int brows = 32 * sets;  // rows of a block
  const int rb = blockIdx.x / n_split;
  const int split = (int)(blockIdx.x % n_split);
  const int n = cols.n;
  const int nct = n / kColTile + (n % kColTile != 0);
  const int n_parts = dense_parts(nct);
  const int p_lo = split * n_parts / n_split;
  const int p_hi = (split + 1) * n_parts / n_split;
  const int t0 = p_lo * nct / n_parts;  // this block's tiles
  const int t1 = p_hi * nct / n_parts;
  const int win = min(kDenseBatchWindow, t1 - t0);  // tiles staged at once
  float* part = reinterpret_cast<float*>(dense_batch_smem);
  float* slot = part + dense_batch_part_floats(n_parts, n_split, sets);
  ColTile* tiles =
      reinterpret_cast<ColTile*>(slot + dense_batch_slot_floats(sets));
  const int i_blk = rb * brows;
  // thread tid folds block row tid (sets = 8: its own lane's row)
  const bool owner = tid < brows;

  RowSet<kDenseBatchRows> rw;
  {
    const int i = i_blk + ir * 32 + lane;
    const bool in = i < rows.n;
    rw.template load<false>(0, in ? rows.x[i] : 0.0f, in ? rows.y[i] : 0.0f,
                            in ? rows.u[i] : 0.0f, in ? rows.v[i] : 0.0f,
                            (in && Law::kRadius) ? rows.rad[i] : 0.0f,
                            in && rows.alive[i] != 0, rows.off + i);
  }

  // stage tiles [s0, s1) = [t, min(t + win, t1)) once the staged ones are
  // consumed: each column's x, y, u, v and radius by cp.async into its
  // slots of the tile, its liveness (a byte) through a register; columns
  // past n are never read
  int s0 = 0, s1 = 0;
  auto stage = [&](int t) {
    if (s1 > s0) __syncthreads();  // the staged tiles are consumed
    s0 = t;
    s1 = min(t + win, t1);
    const int m = min((s1 - s0) * kColTile, n - s0 * kColTile);
    for (int c = tid; c < m; c += kDenseThreads) {
      const int j = s0 * kColTile + c;
      ColTile& tl = tiles[c / kColTile];
      const int k = c % kColTile;
      float* pv = reinterpret_cast<float*>(&tl.pv[k]);
      cp_async4(pv, cols.x + j);
      cp_async4(pv + 1, cols.y + j);
      cp_async4(pv + 2, cols.u + j);
      cp_async4(pv + 3, cols.v + j);
      if (Law::kRadius)
        cp_async4(&tl.ra[k].x, cols.rad + j);
      else
        tl.ra[k].x = 0.0f;
      tl.ra[k].y = cols.alive[j] != 0 ? 1.0f : 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();  // the tiles are staged
  };

  float tx = 0.0f, ty = 0.0f;  // without a split: the row's sum
  for (int pp = p_lo; pp < p_hi; ++pp) {
    const int a = pp * nct / n_parts;  // the part's tiles [a, b)
    const int b = (pp + 1) * nct / n_parts;
    float px = 0.0f, py = 0.0f;  // the part's sum over its slots
    for (int jj = 0; jj < sets; ++jj) {
      const int q = cq + cstep * jj;  // the chunk slot
      float sx = 0.0f, sy = 0.0f;     // its sum over the part's tiles
      for (int t = a; t < b; ++t) {
        if (t < s0 || t >= s1) stage(t);  // block-uniform
        const int jc = t * kColTile + q * kChunk;
        if (jc >= n) continue;
        rw.ax[0] = rw.ay[0] = 0.0f;
        rows_vs_chunk<false, kDenseFastTail, Law, kDenseBatchRows>(
            rw, tiles[t - s0], q, min(kChunk, n - jc), cols.off + jc, p,
            use_radius, 0.0f);
        sx += rw.ax[0];
        sy += rw.ay[0];
      }
      if (sets == kTileChunks) {  // the warp holds every slot, in order
        px = jj == 0 ? sx : px + sx;
        py = jj == 0 ? sy : py + sy;
      } else {
        float* s = slot + ((pp & 1) * kTileChunks + q) * 2 * brows;
        s[ir * 32 + lane] = sx;
        s[brows + ir * 32 + lane] = sy;
      }
    }
    if (sets < kTileChunks) {  // block row tid: the part's slots in order
      __syncthreads();  // every warp's slot sums of the part are written
      if (owner) {
        const float* s = slot + (pp & 1) * kTileChunks * 2 * brows;
        px = s[tid];
        py = s[brows + tid];
#pragma unroll
        for (int q = 1; q < kTileChunks; ++q) {
          px += s[q * 2 * brows + tid];
          py += s[q * 2 * brows + brows + tid];
        }
      }
    }
    if (n_split == 1) {
      tx += px;
      ty += py;
    } else if (owner) {
      part[(pp - p_lo) * 2 * brows + tid] = px;
      part[(pp - p_lo) * 2 * brows + brows + tid] = py;
    }
  }
  if (n_split == 1) {  // grid-uniform: no cluster
    if (owner && i_blk + tid < rows.n) {
      fx[i_blk + tid] = tx;
      fy[i_blk + tid] = ty;
    }
    return;
  }

  // each row: its parts' sums in order, from every block of the cluster
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's part sums are in its shared memory
  const int per = (brows + n_split - 1) / n_split;
  for (int k = tid; k < per; k += kDenseThreads) {
    const int r = split * per + k;
    const int i = i_blk + r;
    if (r >= brows || i >= rows.n) continue;
    float sx = 0.0f, sy = 0.0f;
    for (int bk = 0; bk < n_split; ++bk) {
      const float* pb = cluster.map_shared_rank(part, bk);
      const int q_n = (bk + 1) * n_parts / n_split - bk * n_parts / n_split;
      for (int q = 0; q < q_n; ++q) {
        sx += pb[q * 2 * brows + r];
        sy += pb[q * 2 * brows + brows + r];
      }
    }
    fx[i] = sx;
    fy[i] = sy;
  }
  cluster.sync();  // no block leaves while another reads its part sums
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

// A dense walk over a batch of crowds: crowd blockIdx.y's rows.n rows at
// blockIdx.y * rows.n against its cols.n columns at blockIdx.y * cols.n,
// the global slots rows.off and cols.off the same in every crowd (a square
// crowd: cols.n = rows.n, both offsets 0; a batch of crowds whose slots are
// sharded over an agent axis: a shard's rows against gathered or rotated
// columns); its parameters at blockIdx.y * prm_stride, its 32-column
// chunk boxes (kBoxSkip, kTable) or 256-column tile boxes (kBoxSkipTiles),
// table and counts at its own offsets.  `width` is the table's slots a row
// (max_surv: kTable) or the all-tiles walk's row sets a block (sets:
// kAllTiles, dense_batch_layout).  The all-tiles walk is its own body
// (dense_batch_walk); the box-skip walk by tile is the unbatched body
// (dense_walk); the box-skip and table walks are chunk_walk (every tile of
// the block's parts, or the table row's listed ones); all in dense_walk's
// order of additions: row b equals the unbatched launch on row b bitwise.
template <int kWalk, class Law>
__global__ void __launch_bounds__(
    kDenseThreads,
    kWalk == kAllTiles ? kDenseBatchBlocks
    : kWalk == kBoxSkipTiles ? 2048 / kDenseThreads
    : std::is_same<Law, Moussaid>::value ? kChunkBlocks
                                         : kChunkBlocksLean)
pair_force_dense_batched_kernel(Planes rows, Planes cols,
                                const float* __restrict__ prm, int prm_stride,
                                int use_radius,
                                const float* __restrict__ col_bb,
                                const int* __restrict__ surv,
                                const int* __restrict__ counts, int width,
                                float c2, int n_split, float* __restrict__ fx,
                                float* __restrict__ fy) {
  const long long crowd = blockIdx.y;
  const int ro = (int)crowd * rows.n;
  const int co = (int)crowd * cols.n;
  if constexpr (kWalk == kAllTiles) {
    dense_batch_walk<Law>(batch_row(rows, ro), batch_row(cols, co),
                          prm + (int)crowd * prm_stride, use_radius, width,
                          n_split, fx + ro, fy + ro);
  } else if constexpr (kWalk == kBoxSkipTiles) {
    const long long nct = cols.n / kColTile + (cols.n % kColTile != 0);
    col_bb += crowd * 4 * nct;
    dense_walk<kBoxSkip, Law>(batch_row(rows, ro), batch_row(cols, co),
                              prm + (int)crowd * prm_stride, use_radius,
                              col_bb, surv, counts, width, c2, n_split,
                              fx + ro, fy + ro);
  } else {  // col_bb: the 32-column chunk boxes
    const long long nch = cols.n / kChunk + (cols.n % kChunk != 0);
    const long long nt = (rows.n + kSymTile - 1) / kSymTile;
    if constexpr (kWalk == kTable) {
      surv += crowd * nt * width;
      counts += crowd * nt;
    }
    chunk_walk<kWalk, Law>(batch_row(rows, ro), batch_row(cols, co),
                           prm + (int)crowd * prm_stride, use_radius,
                           col_bb + crowd * 4 * nch, surv, counts, width,
                           c2, n_split, fx + ro, fy + ro);
  }
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

// The batched symmetric cutoff walks (pair_force_sym_batched_kernel<
// kTriangleBox | kSymTable, Law>: ensembles and sweeps with a cutoff),
// designed for the shapes they run (config #5's 256 crowds of 1,000 and
// 8 crowds of 50,000; PERF.md).  The unbatched walk gives each tile pair
// its own block: it stages 128 columns, reduces eight boxes, passes two
// barriers and ends with 512 atomics for about 45 warp law steps a warp,
// the table launches max_surv blocks a table row, most of them empty,
// and each warp walks its own 32 rows, so the block waits at its barriers
// for the warp whose rows reach the most chunks.  Here a block holds one
// 128-row tile of one crowd, staged once in shared memory, and walks the
// column tiles of its row: the triangle's tiles from ti on with the
// tile-box test, or the tiles its table row lists (every tile from ti on
// with the box test where the row overflowed).  The candidates are tested
// kSymTile at a time, one a thread, and compacted with ballots.  A row's
// candidates are dealt out to kSymRowSplits blocks in turn (candidate k
// to split k mod S), so that the long rows do not set the launch's end;
// S is a function of the shapes only.  Each thread reads its column of the
// next tile into registers while the block walks the current one, so a
// tile's loads are never waited for.  Staging a tile writes it to shared
// memory, and warp w lists the work of column chunk w: for each row chunk
// whose box its box reaches, two items of 16 steps of the staggered
// schedule of sym_tile_pair (lane L meets column (L + s) mod 32 at step s,
// so the lanes' partials never collide), steps 0-15 and 16-31.  On the
// diagonal tile only the row chunks r <= w: r < w both items, and r = w
// one item of steps 1-16 (pair {L, L + s} appears at steps s and 32 - s;
// at step 16 only lanes below 16): each unordered pair once.  The warps
// take the tile's items in turn from a shared counter, so they reach the
// tile's barrier together.  An item runs the law only at steps where some
// lane's pair lies within the cutoff (a ballot), and adds its rows' sums
// and its columns' reactions to the warp's own partials in shared memory.
// Dead rows and columns are staged at x = +inf, so that the cutoff test
// alone drops their pairs (their squared distance is +inf or NaN), and
// the law's mask gives them exactly 0.
// After each tile one barrier closes its columns: thread t adds column
// t's four warp partials in order and makes one atomic per component
// where the sum is not zero (fx starts at +0 and never becomes -0, so an
// atomic of +-0 changes nothing); the rows' sums go out so once a block.
constexpr int kSymBatchRows = 1;  // rows a lane holds in sym_rows_walk
// launch bounds of sym_rows_walk: resident blocks of kSymTile threads an
// SM (PERF.md: 8, 10, 12 and 16 measured; 8 leaves the loop unspilled),
// and the most blocks a row's candidates are dealt out to (PERF.md: 1, 2,
// 4 and 8 measured)
constexpr int kSymRowBlocks = 8;
constexpr int kSymRowSplits = 4;

struct SymRowShared {
  // the block's rows and the staged column tile (dead ones at x = +inf)
  float rx[kSymTile], ry[kSymTile], ru[kSymTile], rv[kSymTile];
  float rr[kSymTile];
  float cx[kSymTile], cy[kSymTile], cu[kSymTile], cv[kSymTile];
  float cr[kSymTile];
  // +f partials of each row and -f partials of each column, one row per
  // warp
  float row_x[kSymWarps][kSymTile], row_y[kSymWarps][kSymTile];
  float col_x[kSymWarps][kSymTile], col_y[kSymWarps][kSymTile];
  float rbox[kSymWarps][4];  // each row chunk's box of alive rows
  // each column chunk's items (row chunk | kind << 2: kind 0 steps 0-15,
  // 1 steps 16-31, 2 steps 1-16 of a chunk against itself), their count
  // and the next item a warp takes
  unsigned char items[kSymWarps][2 * kSymWarps];
  int n_items[kSymWarps];
  int next;
  int list[kSymTile];  // the hit candidates being walked
  int wcount[kSymWarps];
};

// Block (crowd, ti, split) of a batched symmetric cutoff walk over the
// planes pl of one crowd (the kernel passes its crowd's planes,
// parameters, boxes, table and outputs): row tile ti against the column
// tiles of its row dealt to this split.
template <int kWalk, class Law>
__device__ __forceinline__ void sym_rows_walk(
    const Planes& pl, const float* __restrict__ prm, int use_radius,
    int n_tiles, const float* __restrict__ bb, const int* __restrict__ surv,
    const int* __restrict__ counts, int max_surv, float c2, int ti,
    int split, int n_split, float* __restrict__ fx, float* __restrict__ fy) {
  static_assert(Law::kAntisymmetric,
                "the Newton's-third-law walk needs an antisymmetric law");
  static_assert(kSymBatchRows == 1 && kSymWarps * kChunk == kSymTile,
                "an item gives a lane one row of a 32-row chunk");
  __shared__ SymRowShared sm;
  const typename Law::Prm p = Law::load(prm);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n = pl.n;
  const long long nt = n_tiles;

  // the row's candidates: its table row's listed tiles, or, in the
  // triangle-box walk and where the table row overflowed, tiles ti .. nt-1
  // with the tile-box test; this split takes every n_split-th from split
  bool table = false;
  if constexpr (kWalk == kSymTable) table = counts[ti] <= max_surv;
  const int n_row = table ? counts[ti] : (int)(nt - ti);
  const int n_cand = n_row > split ? (n_row - split - 1) / n_split + 1 : 0;
  const float bx0 = bb[ti], bx1 = bb[nt + ti];
  const float by0 = bb[2 * nt + ti], by1 = bb[3 * nt + ti];

  // row tid of tile ti, staged; each row chunk's box
  {
    const int i = ti * kSymTile + tid;
    const bool in = i < n;
    const float x = in ? pl.x[i] : 0.0f;
    const float y = in ? pl.y[i] : 0.0f;
    const bool a = in && pl.alive[i] != 0;
    sm.rx[tid] = a ? x : INFINITY;
    sm.ry[tid] = y;
    sm.ru[tid] = in ? pl.u[i] : 0.0f;
    sm.rv[tid] = in ? pl.v[i] : 0.0f;
    sm.rr[tid] = in ? pl.rad[i] : 0.0f;
    const float x0 = warp_min(a ? x : INFINITY);
    const float x1 = warp_max(a ? x : -INFINITY);
    const float y0 = warp_min(a ? y : INFINITY);
    const float y1 = warp_max(a ? y : -INFINITY);
    if (lane == 0) {
      sm.rbox[warp][0] = x0;
      sm.rbox[warp][1] = x1;
      sm.rbox[warp][2] = y0;
      sm.rbox[warp][3] = y1;
    }
  }
#pragma unroll
  for (int w = 0; w < kSymWarps; ++w) {
    sm.row_x[w][tid] = 0.0f;
    sm.row_y[w][tid] = 0.0f;
    sm.col_x[w][tid] = 0.0f;
    sm.col_y[w][tid] = 0.0f;
  }

  // column tid of the next tile, read ahead into registers, and its
  // staging (warp w holds column chunk w): the columns and the chunk's
  // items
  float qx = 0.0f, qy = 0.0f, qu = 0.0f, qv = 0.0f, qr = 0.0f;
  bool qa = false;
  auto fetch = [&](int t) {
    const int j = t * kSymTile + tid;
    const bool jin = j < n;
    qx = jin ? pl.x[j] : 0.0f;
    qy = jin ? pl.y[j] : 0.0f;
    qu = jin ? pl.u[j] : 0.0f;
    qv = jin ? pl.v[j] : 0.0f;
    qr = jin ? pl.rad[j] : 0.0f;
    qa = jin && pl.alive[j] != 0;
  };
  auto stage = [&](bool diag) {
    sm.cx[tid] = qa ? qx : INFINITY;
    sm.cy[tid] = qy;
    sm.cu[tid] = qu;
    sm.cv[tid] = qv;
    sm.cr[tid] = qr;
    const float x0 = warp_min(qa ? qx : INFINITY);
    const float x1 = warp_max(qa ? qx : -INFINITY);
    const float y0 = warp_min(qa ? qy : INFINITY);
    const float y1 = warp_max(qa ? qy : -INFINITY);
    if (lane == 0) {
      int k = 0;
      for (int r = 0; r < (diag ? warp + 1 : kSymWarps); ++r) {
        if (box_gap2(sm.rbox[r][0], sm.rbox[r][1], sm.rbox[r][2],
                     sm.rbox[r][3], x0, x1, y0, y1) > c2)
          continue;  // the chunk pair holds no pair within the cutoff
        if (diag && r == warp) {
          sm.items[warp][k++] = (unsigned char)(r | 2 << 2);
        } else {
          sm.items[warp][k++] = (unsigned char)r;
          sm.items[warp][k++] = (unsigned char)(r | 1 << 2);
        }
      }
      sm.n_items[warp] = k;
    }
    if (tid == 0) sm.next = 0;
  };

  // the tile's items, taken in turn by the warps; item (r, kind) of column
  // chunk c: lane L holds row 32 r + L and meets column 32 c + (L + s) mod
  // 32 at step s
  auto walk = [&]() {
#pragma unroll 1
    for (;;) {
      int k = 0;
      if (lane == 0) k = atomicAdd(&sm.next, 1);
      k = __shfl_sync(kAllLanes, k, 0);
      int c = 0;
      while (c < kSymWarps && k >= sm.n_items[c]) k -= sm.n_items[c++];
      if (c == kSymWarps) break;  // warp-uniform
      const int item = sm.items[c][k];
      const int kind = item >> 2;
      const int li = (item & 3) * kChunk + lane;  // the lane's row
      const int s0 = kind == 1 ? kChunk / 2 : kind == 2 ? 1 : 0;
      const int s1 = kind == 0 ? kChunk / 2 - 1 : kind == 2 ? kChunk / 2
                                                            : kChunk - 1;
      const float x = sm.rx[li], y = sm.ry[li];
      const float u = sm.ru[li], v = sm.rv[li], r = sm.rr[li];
      // a chunk against itself: lanes 16-31 stop before step 16
      const int s_end = kind == 2 && lane >= kChunk / 2 ? kChunk / 2 : kChunk;
      const int c0 = c * kChunk;
      float ax = 0.0f, ay = 0.0f;
#pragma unroll 1
      for (int s = s0; s <= s1; ++s) {
        const int cc = (lane + s) & (kChunk - 1);
        const int jj = c0 + cc;
        const float dx = sm.cx[jj] - x;
        const float dy = sm.cy[jj] - y;
        const bool ok = s < s_end && sq_norm_rn(dx, dy) <= c2;
        if (!__any_sync(kAllLanes, ok)) continue;  // no lane's pair within
        float fxk, fyk;
        Law::template pair<true>(dx, dy, u, v, sm.cu[jj], sm.cv[jj], r,
                                 sm.cr[jj], use_radius, ok, p, fxk, fyk);
        ax += fxk;
        ay += fyk;
        sm.col_x[warp][jj] -= fxk;  // Newton's third law: f_ji = -f_ij
        sm.col_y[warp][jj] -= fyk;
        __syncwarp();
      }
      sm.row_x[warp][li] += ax;
      sm.row_y[warp][li] += ay;
      __syncwarp();
    }
  };

  for (int base = 0; base < n_cand; base += kSymTile) {
    const int k = base + tid;
    int t = -1;
    bool h = false;
    if (k < n_cand) {
      const int q = split + k * n_split;
      if (table) {
        t = surv[(long long)ti * max_surv + q];
        h = true;
      } else {
        t = ti + q;
        h = box_hits(bb, nt, t, bx0, bx1, by0, by1, c2);
      }
    }
    const unsigned m = __ballot_sync(kAllLanes, h);
    if (lane == 0) sm.wcount[warp] = __popc(m);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < kSymWarps; ++w) {
      off += w < warp ? sm.wcount[w] : 0;
      total += sm.wcount[w];
    }
    if (h) sm.list[off + __popc(m & ((1u << lane) - 1u))] = t;
    __syncthreads();
    if (total > 0) fetch(sm.list[0]);
    for (int q = 0; q < total; ++q) {
      const int tj = sm.list[q];
      stage(tj == ti);
      if (q + 1 < total) fetch(sm.list[q + 1]);
      __syncthreads();  // the tile and its items are staged
      walk();
      __syncthreads();  // its columns' partials are complete
      float sx = 0.0f, sy = 0.0f;
#pragma unroll
      for (int w = 0; w < kSymWarps; ++w) {
        sx += sm.col_x[w][tid];
        sy += sm.col_y[w][tid];
        sm.col_x[w][tid] = 0.0f;
        sm.col_y[w][tid] = 0.0f;
      }
      const int j = tj * kSymTile + tid;  // dead beyond n: both sums 0
      if (sx != 0.0f) atomicAdd(&fx[j], sx);
      if (sy != 0.0f) atomicAdd(&fy[j], sy);
    }
  }
  // (the last tile's barrier, or the candidates', orders the row partials)
  float sx = 0.0f, sy = 0.0f;
#pragma unroll
  for (int w = 0; w < kSymWarps; ++w) {
    sx += sm.row_x[w][tid];
    sy += sm.row_y[w][tid];
  }
  const int i = ti * kSymTile + tid;  // dead beyond n: both sums 0
  if (sx != 0.0f) atomicAdd(&fx[i], sx);
  if (sy != 0.0f) atomicAdd(&fy[i], sy);
}

// The batched symmetric all-pairs walks (pair_force_sym_batched_kernel<
// kTriangle, Law>, row 1b: each crowd's triangle; pair_force_sym_dense_
// batched_kernel<false, Law>, row 4-b: a crowd's rows of one shard against
// another shard's columns, +f to the rows and -f to the columns), designed
// for the shapes they run (config #5's 256 crowds of 1,000; on the 2-D mesh
// 128 crowds of a shard's 250 agents, alone and against a 250-column block;
// PERF.md).  The unbatched body gave each 128 x 128 tile pair its own block
// of four warps: it evaluated a diagonal tile's 128 x 128 pairs and masked
// half of them, and at the mesh's shapes its 384-512 blocks left about 16
// warps on an SM.  Here a block of kSymAllWarps warps holds one crowd's
// 128-row tile in registers, R = kSymAllRows rows a lane (warp w holds row
// group w / 4, rows 64 (w / 4) + lane + 32 r), and walks a run of column
// tiles: for the triangle its candidates are tiles ti .. nt - 1, for the
// full block every column tile, and candidate k goes to split k mod S of
// the row (sym_all_splits: a rule of the shapes).  A tile is staged with
// 4-byte cp.async copies into the other of two buffers while the block
// walks the current one (a crowd's planes start at b x n x 4 bytes, so no
// 16-byte copy fits without a head and a tail; the alive byte goes through
// a register), so a tile costs one barrier.  Off the diagonal, warp w walks
// column chunk w % 4 against its row group's 64 rows in 32 steps of the
// staggered schedule (lane L meets column (L + s) mod 32 at step s); each
// lane sums a column's reaction over its R rows and passes the running sum
// to the lane below at every step (a shuffle), so that after 32 steps lane
// L holds column L's reaction over the row group; the two row groups'
// sums go to shared memory, and after the next barrier thread t adds
// column t % 128's component t / 128 and makes one atomic where it is not
// zero.  The diagonal tile is walked once, with sym_rows_walk's half
// schedule: row chunk r against column chunk c, two items of 16 steps (0-15
// and 16-31) where r != c and one of steps 1-16 where r = c (at step 16
// only lanes below 16), 16 items, two to a warp from its row group's list
// (sym_all_diag_item: the pairs of chunks 0-1 and 2-3 with chunk 3 held as
// the row, the antisymmetric image of the pairs it meets), all of one
// length, so the warps reach the next barrier together; there the
// reactions go to the warp's own partial row of shared memory, not out as
// atomics.  Dead and missing agents are masked (alive and present on both
// sides, and in the full block a self-pair by global slot): without a
// cutoff no distance test can drop them.  A row's sum (its register sums
// and the eight warps' diagonal partials) goes out once a block, one atomic
// per component where it is not zero.  The order of the float additions
// is fixed within a block, not across blocks (atomics): the forces equal
// the plain version up to f32 summation order, as before.  Like the
// unbatched walk it is bound by the law's issue rate (PERF.md rows 1b and
// 4-b): two rows a lane and eight warps a block hold 64 registers, so four
// blocks (32 warps) share an SM, against the unbatched body's four rows
// (72 registers, 28 warps); that costs about 6 more SASS instructions a
// pair and hides more of the law's latency (PERF.md: three blocks an SM
// measured slower).
constexpr int kSymAllRows = 2;    // rows a lane holds
constexpr int kSymAllWarps = 8;   // a block: 2 row groups x 4 column chunks
constexpr int kSymAllThreads = 32 * kSymAllWarps;
constexpr int kSymAllBlocks = 4;  // resident blocks an SM (launch bounds)
// the rule's costs, in 16-step items of one law step a lane: a column tile
// off the diagonal (R rows x 32 steps), the diagonal tile (two items a
// warp), a block's fixed cost (its row loads, first staging, last barrier
// and flush)
constexpr int kSymAllTileItems = kSymAllRows * kChunk / 16;
constexpr int kSymAllDiagItems = 2;
constexpr int kSymAllBlockItems = 1;
static_assert(kSymAllWarps / 4 * 32 * kSymAllRows == kSymTile &&
                  kSymAllThreads == 2 * kSymTile,
              "two row groups of 64 rows, four column chunks; a thread a "
              "(column, component) of a tile");

// Item k (0-7) of row group g's list of the diagonal tile: row chunk r,
// column chunk c, and the steps (kind 0: 0-15, 1: 16-31, 2: 1-16, at step
// 16 only lanes below 16), as r | c << 2 | kind << 4, byte k of the group's
// word.  Group 0 holds chunks 0-1: (0, 0) and (1, 1) halves, (0, 1), (0, 2)
// and (1, 2); group 1 chunks 2-3: (2, 2) and (3, 3) halves, (2, 3), (3, 0)
// and (3, 1).  Warp w takes items w % 4 and w % 4 + 4 of its group's.
__device__ __forceinline__ int sym_all_diag_item(int g, int k) {
  const unsigned long long word =
      g == 0 ? 0x1909180825140420ull : 0x170713032f1e0e2aull;
  return (int)((word >> (8 * k)) & 0xff);
}

struct SymAllShared {
  // the staged column tiles, two buffers: (x, y, u, v) and (radius, alive)
  float4 pv[2][kSymTile];
  float2 ra[2][kSymTile];
  // the two row groups' reactions of each column, by the tile's parity
  float col[2][2][2][kSymTile];  // [parity][group][x, y][column]
  // each warp's partial sums of the tile's rows (the diagonal's reactions,
  // then its rows' register sums)
  float part[kSymAllWarps][2][kSymTile];  // [warp][x, y][row]
};

// Block (crowd, ti, split) of a batched symmetric all-pairs walk over the
// planes of one crowd (the kernels pass its crowd's planes, parameters and
// outputs): row tile ti against the column tiles of its run dealt to this
// split.  kTri: rows and cols are the same planes and fxc, fyc are fx, fy.
template <bool kTri, class Law>
__device__ __forceinline__ void sym_batch_walk(
    const Planes& rows, const Planes& cols, const float* __restrict__ prm,
    int use_radius, int ti, int split, int n_split, float* __restrict__ fx,
    float* __restrict__ fy, float* __restrict__ fxc, float* __restrict__ fyc) {
  static_assert(Law::kAntisymmetric,
                "the Newton's-third-law walk needs an antisymmetric law");
  constexpr int kR = kSymAllRows;
  __shared__ SymAllShared sm;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = warp / 4;  // the warp's row group
  const int nct = cols.n / kSymTile + (cols.n % kSymTile != 0);
  const int t_first = (kTri ? ti : 0) + split;  // candidate k: t_first + k S
  if (t_first >= nct) return;  // block-uniform: a split without a tile
  const int n_cand = (nct - 1 - t_first) / n_split + 1;
  const typename Law::Prm p = Law::load(prm);

  // this lane's rows i0 + 64 g + lane + 32 r
  const int i0 = ti * kSymTile;
  float xi[kR], yi[kR], ui[kR], vi[kR], ri[kR], ax[kR], ay[kR];
  bool ai[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + 64 * g + lane + 32 * r;
    const bool in = i < rows.n;
    xi[r] = in ? rows.x[i] : 0.0f;
    yi[r] = in ? rows.y[i] : 0.0f;
    ui[r] = in ? rows.u[i] : 0.0f;
    vi[r] = in ? rows.v[i] : 0.0f;
    ri[r] = in ? rows.rad[i] : 0.0f;
    ai[r] = in && rows.alive[i] != 0;
    ax[r] = 0.0f;
    ay[r] = 0.0f;
  }
  for (int e = lane; e < 2 * kSymTile; e += 32)
    sm.part[warp][e / kSymTile][e % kSymTile] = 0.0f;
  const int gi0 = rows.off + i0 + 64 * g + lane;  // row r: gi0 + 32 r

  // stage tile t into buffer b: thread t < 128 copies column t's x, y, u,
  // v, the others column t - 128's radius, and read its alive byte into a
  // register (stored at the next barrier); zeros and dead past cols.n
  const int sc = tid % kSymTile;  // the column a thread stages
  bool qa = false;
  auto stage = [&](int t, int b) {
    const int j = t * kSymTile + sc;
    const bool in = j < cols.n;
    if (tid < kSymTile) {
      float* pv = reinterpret_cast<float*>(&sm.pv[b][sc]);
      if (in) {
        cp_async4(pv, cols.x + j);
        cp_async4(pv + 1, cols.y + j);
        cp_async4(pv + 2, cols.u + j);
        cp_async4(pv + 3, cols.v + j);
      } else {
        sm.pv[b][sc] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else if (in) {
      cp_async4(&sm.ra[b][sc].x, cols.rad + j);
    } else {
      sm.ra[b][sc].x = 0.0f;
    }
    qa = in && tid >= kSymTile && cols.alive[j] != 0;
  };
  // the columns of the last tile off the diagonal: thread t adds column t
  // % 128's component t / 128 over the two row groups, one atomic where
  // it is not zero
  auto flush = [&](int t, int par) {
    const int j = t * kSymTile + sc;
    const int k = tid / kSymTile;
    const float s = sm.col[par][0][k][sc] + sm.col[par][1][k][sc];
    if (j < cols.n && s != 0.0f) atomicAdd(k == 0 ? &fxc[j] : &fyc[j], s);
  };

  stage(t_first, 0);
  int prev = -1;  // the last tile off the diagonal, not yet flushed
  for (int q = 0; q < n_cand; ++q) {
    const int tj = t_first + q * n_split;
    const int b = q & 1;
    cp_async_wait_all();
    if (tid >= kSymTile) sm.ra[b][sc].y = qa ? 1.0f : 0.0f;
    // tile q is staged, and every warp is done with tile q - 1 (so buffer
    // b ^ 1 is free, and tile q - 1's column sums are complete)
    __syncthreads();
    if (prev >= 0) flush(prev, (q - 1) & 1);
    prev = -1;
    if (q + 1 < n_cand) stage(tj + n_split, b ^ 1);
    const int j0 = tj * kSymTile;
    const float4* pv = sm.pv[b];
    const float2* ra = sm.ra[b];
    if (kTri && tj == ti) {
      // the diagonal tile: items w % 4 and w % 4 + 4 of the group's list
#pragma unroll 1
      for (int k = warp % 4; k < 8; k += 4) {
        const int item = sym_all_diag_item(g, k);
        const int r = item & 3, c = (item >> 2) & 3, kind = item >> 4;
        const bool half = kind == 2;
        const int s0 = half ? 1 : kind * (kChunk / 2);
        if (j0 + kChunk * (r > c ? r : c) >= cols.n) continue;  // uniform
        float x = 0.0f, y = 0.0f, u = 0.0f, v = 0.0f, rad = 0.0f;
        bool a = false;
#pragma unroll
        for (int rr = 0; rr < kR; ++rr)
          if (2 * g + rr == r) {
            x = xi[rr];
            y = yi[rr];
            u = ui[rr];
            v = vi[rr];
            rad = ri[rr];
            a = ai[rr];
          }
        float sx = 0.0f, sy = 0.0f, cx = 0.0f, cy = 0.0f;
#pragma unroll 1
        for (int s = s0; s < s0 + kChunk / 2; ++s) {
          const int jj = kChunk * c + ((lane + s) & (kChunk - 1));
          const float4 cp = pv[jj];
          const float2 cr = ra[jj];
          const bool ok = a && cr.y != 0.0f &&
                          !(half && s == kChunk / 2 && lane >= kChunk / 2);
          float fxk, fyk;
          Law::template pair<true>(cp.x - x, cp.y - y, u, v, cp.z, cp.w, rad,
                                   cr.x, use_radius, ok, p, fxk, fyk);
          sx += fxk;
          sy += fyk;
          // Newton's third law: f_ji = -f_ij, passed on with the column
          cx = __shfl_sync(kAllLanes, cx - fxk, (lane + 1) & (kChunk - 1));
          cy = __shfl_sync(kAllLanes, cy - fyk, (lane + 1) & (kChunk - 1));
        }
#pragma unroll
        for (int rr = 0; rr < kR; ++rr)
          if (2 * g + rr == r) {
            ax[rr] += sx;
            ay[rr] += sy;
          }
        // lane L now holds the reaction of column (L + s0 + 16) mod 32
        const int jc = kChunk * c + ((lane + s0 + kChunk / 2) & (kChunk - 1));
        sm.part[warp][0][jc] += cx;
        sm.part[warp][1][jc] += cy;
        __syncwarp();
      }
    } else {
      // column chunk w % 4 against the row group's 64 rows
      const int c0 = kChunk * (warp % 4);
      float cx = 0.0f, cy = 0.0f;
      if (j0 + c0 < cols.n) {  // warp-uniform
        const int g0 = cols.off + j0 + c0;
#pragma unroll 1
        for (int s = 0; s < kChunk; ++s) {
          const int cc = (lane + s) & (kChunk - 1);
          const float4 cp = pv[c0 + cc];
          const float2 cr = ra[c0 + cc];
          const bool ca = cr.y != 0.0f;
          float cfx = 0.0f, cfy = 0.0f;
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            bool ok = ai[r] && ca;
            if (!kTri) ok = ok && g0 + cc != gi0 + 32 * r;
            float fxk, fyk;
            Law::template pair<true>(cp.x - xi[r], cp.y - yi[r], ui[r],
                                     vi[r], cp.z, cp.w, ri[r], cr.x,
                                     use_radius, ok, p, fxk, fyk);
            ax[r] += fxk;
            ay[r] += fyk;
            cfx += fxk;
            cfy += fyk;
          }
          // Newton's third law: f_ji = -f_ij, passed on with the column
          cx = __shfl_sync(kAllLanes, cx - cfx, (lane + 1) & (kChunk - 1));
          cy = __shfl_sync(kAllLanes, cy - cfy, (lane + 1) & (kChunk - 1));
        }
      }
      // lane L holds column c0 + L's reaction over the row group (0 where
      // the chunk lies past the columns: the flush skips those)
      sm.col[b][g][0][c0 + lane] = cx;
      sm.col[b][g][1][c0 + lane] = cy;
      prev = tj;
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    sm.part[warp][0][64 * g + lane + 32 * r] += ax[r];
    sm.part[warp][1][64 * g + lane + 32 * r] += ay[r];
  }
  __syncthreads();  // every warp's partials of the block's rows
  if (prev >= 0) flush(prev, (n_cand - 1) & 1);
  // thread t: row t % 128's component t / 128 over the eight warps
  const int k = tid / kSymTile;
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kSymAllWarps; ++w) s += sm.part[w][k][sc];
  const int i = i0 + sc;  // a dead row's sums are 0
  if (i < rows.n && s != 0.0f) atomicAdd(k == 0 ? &fx[i] : &fy[i], s);
}

// A symmetric walk over a batch of crowds of pl.n agents: crowd b's planes
// and outputs at b * pl.n, its parameters at b * prm_stride, its tile
// boxes, table and counts at its own offsets (kTriangleBox, kSymTable).
// Block (crowd blockIdx.x, row tile blockIdx.y / S, split blockIdx.y % S),
// S = gridDim.y / n_tiles: the triangle walk is sym_batch_walk (S from
// sym_all_splits), the cutoff walks are sym_rows_walk (S = kSymRowSplits).
template <int kWalk, class Law>
__global__ void __launch_bounds__(
    kWalk == kTriangle ? kSymAllThreads : kSymTile,
    kWalk == kTriangle ? kSymAllBlocks : kSymRowBlocks)
pair_force_sym_batched_kernel(Planes pl, const float* __restrict__ prm,
                              int prm_stride, int use_radius, int n_tiles,
                              const float* __restrict__ bb,
                              const int* __restrict__ surv,
                              const int* __restrict__ counts, int max_surv,
                              float c2, float* __restrict__ fx,
                              float* __restrict__ fy) {
  if constexpr (kWalk == kTriangle) {
    const long long crowd = blockIdx.x;
    const int bo = (int)crowd * pl.n;
    const int n_split = (int)(gridDim.y / n_tiles);
    const Planes crowd_pl = batch_row(pl, bo);
    sym_batch_walk<true, Law>(crowd_pl, crowd_pl,
                              prm + (int)crowd * prm_stride, use_radius,
                              (int)(blockIdx.y / n_split),
                              (int)(blockIdx.y % n_split), n_split, fx + bo,
                              fy + bo, fx + bo, fy + bo);
  } else {
    const long long crowd = blockIdx.x;
    const int bo = (int)crowd * pl.n;
    const int n_split = (int)(gridDim.y / n_tiles);
    bb += crowd * 4 * n_tiles;
    if constexpr (kWalk == kSymTable) {
      surv += crowd * n_tiles * max_surv;
      counts += crowd * n_tiles;
    }
    sym_rows_walk<kWalk, Law>(
        batch_row(pl, bo), prm + (int)crowd * prm_stride, use_radius,
        n_tiles, bb, surv, counts, max_surv, c2, (int)(blockIdx.y / n_split),
        (int)(blockIdx.y % n_split), n_split, fx + bo, fy + bo);
  }
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

// The full-block walk over a batch of crowds: crowd b's rows at b * rows.n
// and columns at b * cols.n (their global slots rows.off and cols.off the
// same in every crowd), its parameters at b * prm_stride, its rows' and
// columns' tile boxes (kBox) at its own offsets, +f into its rows of fx, fy
// and -f into its columns of fxc, fyc.  Without the box test, block (crowd
// b = blockIdx.x, row tile blockIdx.y / S, split blockIdx.y % S), S =
// gridDim.y / n_row_tiles, of sym_batch_walk; with it, the unbatched
// kernel's tile pair (sym_tile_pair), tile pair blockIdx.x of crowd b =
// blockIdx.y.  (A minimum of 0 blocks asks for none: the box form keeps the
// unbatched kernel's register budget, and its SASS.)
template <bool kBox, class Law>
__global__ void __launch_bounds__(kBox ? kSymTile : kSymAllThreads,
                                  kBox ? 0 : kSymAllBlocks)
pair_force_sym_dense_batched_kernel(Planes rows, Planes cols,
                                    const float* __restrict__ prm,
                                    int prm_stride, int use_radius,
                                    int n_row_tiles, int n_col_tiles,
                                    const float* __restrict__ row_bb,
                                    const float* __restrict__ col_bb,
                                    float c2, float* __restrict__ fx,
                                    float* __restrict__ fy,
                                    float* __restrict__ fxc,
                                    float* __restrict__ fyc) {
  if constexpr (kBox) {
    __shared__ SymShared sm;
    const long long crowd = blockIdx.y;
    const int ro = (int)crowd * rows.n;
    const int co = (int)crowd * cols.n;
    const typename Law::Prm p = Law::load(prm + (int)crowd * prm_stride);
    const long long ti = blockIdx.x / n_col_tiles;
    const long long tj = blockIdx.x % n_col_tiles;
    const long long nr = n_row_tiles;
    row_bb += crowd * 4 * nr;
    col_bb += crowd * 4 * n_col_tiles;
    if (!box_hits(col_bb, n_col_tiles, tj, row_bb[ti], row_bb[nr + ti],
                  row_bb[2 * nr + ti], row_bb[3 * nr + ti], c2))
      return;  // before any staging
    sym_tile_pair<kSymRowsCut, false, true, Law>(
        sm, ti, tj, batch_row(rows, ro), batch_row(cols, co), p, use_radius,
        c2, fx + ro, fy + ro, fxc + co, fyc + co);
  } else {
    const long long crowd = blockIdx.x;
    const int ro = (int)crowd * rows.n;
    const int co = (int)crowd * cols.n;
    const int n_split = (int)(gridDim.y / n_row_tiles);
    sym_batch_walk<false, Law>(
        batch_row(rows, ro), batch_row(cols, co),
        prm + (int)crowd * prm_stride, use_radius,
        (int)(blockIdx.y / n_split), (int)(blockIdx.y % n_split), n_split,
        fx + ro, fy + ro, fxc + co, fyc + co);
  }
}

// The batched all-tiles walk's layout (dense_batch_walk) by the shapes:
// `sets` (1, 2, 4 or 8 row sets a block) and `splits` (1, 2, 4 or 8
// blocks a row block's parts are split over, at most the parts), the
// least (chunks a warp walks + 1 + 1 for a cluster) x (blocks + per_sm x
// sms): the blocks' work spread over the resident slots plus one block's
// length, by which the last blocks to start end after the rest (blocks
// come and go, so waves do not line up; a block holding more rows walks
// longer: PERF.md run 3 timed sets 1-8 at config #5 and on the 2-D
// mesh).  The 1 is a block's staging, folds and stores, the other a
// cluster's fold.  Ties go to more sets (more law steps a barrier), then
// to fewer splits.  tools/walk_model.py --dense replays it.
struct DenseBatchLayout {
  int sets;
  int splits;
};

DenseBatchLayout dense_batch_layout(long long batch, int n_rows, int n_cols,
                                    int per_sm, int sms) {
  const long long cap =
      (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  const long long nsets = (n_rows + 31) / 32;
  const int nct = n_cols / kColTile + (n_cols % kColTile != 0);
  const int parts = dense_parts(nct);
  const long long per_part = (nct + parts - 1) / parts;  // tiles at most
  DenseBatchLayout best{1, 1};
  long long best_cost = -1;
  for (int s = kTileChunks; s >= 1; s /= 2)
    for (int sp = 1; sp <= parts && sp <= kMaxSplit; sp *= 2) {
      const long long blocks = batch * ((nsets + s - 1) / s) * sp;
      const long long tiles = (long long)((parts + sp - 1) / sp) * per_part;
      const long long cost = (s * tiles + 1 + (sp > 1)) * (blocks + cap);
      if (best_cost < 0 || cost < best_cost) {
        best = DenseBatchLayout{s, sp};
        best_cost = cost;
      }
    }
  return best;
}

// Launch of the batched all-tiles walk (pair_force_dense_batched_kernel<
// kAllTiles, Law>): dense_batch_layout's blocks of 32 x sets rows, the
// splits of a row block one cluster (none without a split), with the
// dynamic shared memory of its widest block.
template <class Law>
int dense_batch_launch(const Planes& rows, const Planes& cols,
                       const float* prm, int prm_stride, int use_radius,
                       float* fx, float* fy, void* stream, int batch) {
  int sms = 0;
  cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const DenseBatchLayout l =
      dense_batch_layout(batch, rows.n, cols.n, kDenseBatchBlocks, sms);
  const int nct = cols.n / kColTile + (cols.n % kColTile != 0);
  const int n_parts = dense_parts(nct);
  int win = 0;  // the most tiles a block stages at once
  for (int sp = 0; sp < l.splits; ++sp) {
    const int t0 = sp * n_parts / l.splits * nct / n_parts;
    const int t1 = (sp + 1) * n_parts / l.splits * nct / n_parts;
    const int w = t1 - t0 < kDenseBatchWindow ? t1 - t0 : kDenseBatchWindow;
    win = w > win ? w : win;
  }
  const long long blocks =
      (long long)((rows.n + 32 * l.sets - 1) / (32 * l.sets)) * l.splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)batch);
  cfg.blockDim = dim3(kDenseThreads);
  cfg.dynamicSmemBytes =
      4 * (dense_batch_part_floats(n_parts, l.splits, l.sets) +
           dense_batch_slot_floats(l.sets)) +
      win * sizeof(ColTile);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)l.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = l.splits > 1 ? 1 : 0;
  const float* no_bb = nullptr;
  const int* no_table = nullptr;
  e = cudaLaunchKernelEx(&cfg, pair_force_dense_batched_kernel<kAllTiles, Law>,
                         rows, cols, prm, prm_stride, use_radius, no_bb,
                         no_table, no_table, l.sets, 0.0f, l.splits, fx, fy);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Launch of a dense walk with law Law: one block per row block and split,
// the splits of a row block one cluster (of one block when n_split = 1).
// With prm_stride >= 0 the launch is the batched walk over batch blocks of
// rows.n rows and cols.n columns (pair_force_dense_batched_kernel; the
// all-tiles walk: dense_batch_launch).
template <int kWalk, class Law>
int dense_launch(const Planes& rows, const Planes& cols, const float* prm,
                 int use_radius, const float* col_bb, const int* surv,
                 const int* counts, int max_surv, float c2, float* fx,
                 float* fy, void* stream, int batch = 1,
                 int prm_stride = -1) {
  const bool batched = prm_stride >= 0;
  if (rows.n <= 0) return (int)cudaSuccess;
  if (cols.n < 0 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (kWalk == kTable && max_surv < 1) return (int)cudaErrorInvalidValue;
  if constexpr (kWalk == kAllTiles)
    if (batched)
      return dense_batch_launch<Law>(rows, cols, prm, prm_stride, use_radius,
                                     fx, fy, stream, batch);
  const int n_split = (batched && (kWalk == kBoxSkip || kWalk == kTable))
                          ? chunk_splits(rows.n, cols.n, batch)
                          : dense_splits<kWalk>(rows.n, cols.n, batch);
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
  cudaError_t e = cudaErrorInvalidValue;  // kBoxSkipTiles: batched only
  if (batched) {
    if constexpr (kWalk != kAllTiles)  // (dense_batch_launch above)
      e = cudaLaunchKernelEx(
          &cfg, pair_force_dense_batched_kernel<kWalk, Law>, rows, cols, prm,
          prm_stride, use_radius, col_bb, surv, counts, max_surv, c2, n_split,
          fx, fy);
  } else if constexpr (kWalk != kBoxSkipTiles) {
    e = cudaLaunchKernelEx(&cfg, pair_force_dense_kernel<kWalk, Law>, rows,
                           cols, prm, use_radius, col_bb, surv, counts,
                           max_surv, c2, n_split, fx, fy);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Launch of the batched box-skip walk: by tile (dense_walk, the tile boxes
// col_bb) where the columns span at most kBoxSkipTileWalk tiles, else by
// chunk (chunk_walk, the chunk boxes chunk_bb).
template <class Law>
int box_skip_batched_launch(const Planes& rows, const Planes& cols,
                            const float* prm, int use_radius,
                            const float* col_bb, const float* chunk_bb,
                            float c2, float* fx, float* fy, void* stream,
                            int batch, int prm_stride) {
  const int nct = cols.n / kColTile + (cols.n % kColTile != 0);
  return nct <= kBoxSkipTileWalk
             ? dense_launch<kBoxSkipTiles, Law>(
                   rows, cols, prm, use_radius, col_bb, nullptr, nullptr, 1,
                   c2, fx, fy, stream, batch, prm_stride)
             : dense_launch<kBoxSkip, Law>(rows, cols, prm, use_radius,
                                           chunk_bb, nullptr, nullptr, 1, c2,
                                           fx, fy, stream, batch,
                                           prm_stride);
}

// The splits S of a row tile's column run in the batched symmetric
// all-pairs walk (sym_batch_walk): a power of two, at most the longest
// run's candidates (the triangle's n_tiles, the full block's column
// tiles), from the shapes and the SM count only.  In items (16 law steps a
// lane: kSymAllTileItems a column tile, kSymAllDiagItems the diagonal,
// kSymAllBlockItems a block's fixed cost) it takes the least estimate of
// the launch's length: where the blocks fit the resident slots (per_sm x
// sms) at once, the longest block (row tile 0's first or second split);
// else the blocks' work over the slots plus the length of the last block
// to start (blocks start longest row first: the triangle's last row is its
// diagonal alone), and no less than the longest block.  Ties go to fewer
// splits (fewer blocks and atomics).  tools/walk_model.py --sym-all
// replays it.
int sym_all_splits(long long batch, int n_row_tiles, int n_col_tiles,
                   bool tri, int per_sm, int sms) {
  const long long cap =
      (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  const long long nr = n_row_tiles;
  const long long most = tri ? nr : n_col_tiles;  // row 0's candidates
  const long long tile = kSymAllTileItems, diag = kSymAllDiagItems;
  const long long fixed = kSymAllBlockItems;
  const long long items =  // of a crowd
      tri ? nr * diag + nr * (nr - 1) / 2 * tile : nr * most * tile;
  int best = 1;
  long long best_cost = -1;
  for (long long s = 1; s <= most && nr * s <= 65535; s *= 2) {
    // the blocks of a crowd: every row's min(S, its candidates)
    const long long per_crowd =
        tri ? s * (s + 1) / 2 + (nr - s) * s : nr * s;
    const long long blocks = batch * per_crowd;
    const long long longest =
        tri ? std::max(diag + (most - 1) / s * tile,
                       s > 1 ? ((most - 2) / s + 1) * tile : 0)
            : (most + s - 1) / s * tile;
    const long long last = tri ? diag : most / s * tile;
    const long long whole = (longest + fixed) * cap;
    const long long cost =
        blocks <= cap ? whole
                      : std::max(batch * (items + per_crowd * fixed) +
                                     (last + fixed) * cap,
                                 whole);
    if (best_cost < 0 || cost < best_cost) {
      best = (int)s;
      best_cost = cost;
    }
  }
  return best;
}

// Launch of a symmetric walk with law Law: one block per tile pair of the
// upper triangle (kTriangle, kTriangleBox) or per table slot (kSymTable).
// With prm_stride >= 0 the launch is the batched walk over batch crowds of
// pl.n agents (pair_force_sym_batched_kernel): one block per crowd,
// 128-row tile and split (sym_batch_walk, S from sym_all_splits; the
// cutoff walks' sym_rows_walk, S = kSymRowSplits), the crowds fastest so
// that the rows with the most candidates start first.
template <int kWalk, class Law>
int sym_launch(const Planes& pl, const float* prm, int use_radius,
               const float* bb, const int* surv, const int* counts,
               int max_surv, float c2, float* fx, float* fy, void* stream,
               int batch = 1, int prm_stride = -1) {
  const int n = pl.n;
  if (n <= 0) return (int)cudaSuccess;
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (kWalk == kSymTable && max_surv < 1) return (int)cudaErrorInvalidValue;
  const long long nt = (n + kSymTile - 1) / kSymTile;
  if (prm_stride >= 0) {  // batched
    long long s = nt < kSymRowSplits ? nt : kSymRowSplits;
    int threads = kSymTile;
    if constexpr (kWalk == kTriangle) {
      int sms = 0;
      const cudaError_t e = sm_count(sms);
      if (e != cudaSuccess) return (int)e;
      if (nt > 65535) return (int)cudaErrorInvalidConfiguration;
      s = sym_all_splits(batch, (int)nt, (int)nt, true, kSymAllBlocks, sms);
      threads = kSymAllThreads;
    }
    if (nt * s > 65535) return (int)cudaErrorInvalidConfiguration;
    pair_force_sym_batched_kernel<kWalk, Law>
        <<<dim3((unsigned)batch, (unsigned)(nt * s)), threads, 0,
           (cudaStream_t)stream>>>(pl, prm, prm_stride, use_radius, (int)nt,
                                   bb, surv, counts, max_surv, c2, fx, fy);
    return (int)cudaGetLastError();
  }
  const long long blocks =
      kWalk == kSymTable ? nt * max_surv : nt * (nt + 1) / 2;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pair_force_sym_kernel<kWalk, Law>
      <<<(unsigned)blocks, kSymTile, 0, (cudaStream_t)stream>>>(
          pl, prm, use_radius, (int)nt, bb, surv, counts, max_surv, c2, fx,
          fy);
  return (int)cudaGetLastError();
}

// Launch of the full-block walk with law Law: one block per tile pair.
// With prm_stride >= 0 the launch is the batched walk over batch crowds
// (pair_force_sym_dense_batched_kernel): without the box test one block per
// crowd, 128-row tile and split (sym_batch_walk, S from sym_all_splits),
// the crowds fastest.
template <bool kBox, class Law>
int sym_dense_launch(const Planes& rows, const Planes& cols, const float* prm,
                     int use_radius, const float* row_bb, const float* col_bb,
                     float c2, float* fx, float* fy, float* fxc, float* fyc,
                     void* stream, int batch = 1, int prm_stride = -1) {
  if (rows.n <= 0 || cols.n <= 0) return (int)cudaSuccess;
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const long long nr = (rows.n + kSymTile - 1) / kSymTile;
  const long long nc = (cols.n + kSymTile - 1) / kSymTile;
  if (nr * nc > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)(nr * nc), (unsigned)batch);
  int threads = kSymTile;
  if (prm_stride >= 0 && !kBox) {  // sym_batch_walk
    int sms = 0;
    const cudaError_t e = sm_count(sms);
    if (e != cudaSuccess) return (int)e;
    if (nr > 65535 || nc > 65535) return (int)cudaErrorInvalidConfiguration;
    const int s = sym_all_splits(batch, (int)nr, (int)nc, false,
                                 kSymAllBlocks, sms);
    grid = dim3((unsigned)batch, (unsigned)(nr * s));
    threads = kSymAllThreads;
  }
  if (prm_stride >= 0)
    pair_force_sym_dense_batched_kernel<kBox, Law>
        <<<grid, threads, 0, (cudaStream_t)stream>>>(
            rows, cols, prm, prm_stride, use_radius, (int)nr, (int)nc,
            row_bb, col_bb, c2, fx, fy, fxc, fyc);
  else
    pair_force_sym_dense_kernel<kBox, Law>
        <<<(unsigned)(nr * nc), kSymTile, 0, (cudaStream_t)stream>>>(
            rows, cols, prm, use_radius, (int)nr, (int)nc, row_bb, col_bb,
            c2, fx, fy, fxc, fyc);
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
// vector for every crowd); one launch.  The symmetric forms accumulate into
// fx, fy (zeros on entry) like sfm_pair_sym; the dense forms take the
// square call's row and column planes (Helbing's rows carry the desired
// directions) and overwrite every row.  The cutoff forms take each crowd's
// grid stacked: bb / col_bb (batch, 4, n_tiles), surv (batch, nt,
// max_surv) and counts (batch, nt), nt = ceil(n / 128); the table form
// (sfm_pair_compact_batched) reads 32-column chunk boxes (batch, 4,
// ceil(n / 32)) as col_bb, and the box-skip form
// (sfm_pair_dense_cutoff_batched) takes them as chunk_bb beside the tile
// boxes (box_skip_batched_launch reads one of the two).
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

int sfm_pair_sym_cutoff_batched(int law, const float* x, const float* y,
                                const float* vx, const float* vy,
                                const float* rad, const uint8_t* alive,
                                const float* prm, int prm_stride,
                                int use_radius, int n, int batch,
                                const float* bb, float c2, float* fx,
                                float* fy, void* stream) {
  const Planes pl = planes(x, y, vx, vy, rad, alive, n, 0);
  return with_antisymmetric_law(law, [&](auto l) {
    return sym_launch<kTriangleBox, decltype(l)>(pl, prm, use_radius, bb,
                                                 nullptr, nullptr, 1, c2, fx,
                                                 fy, stream, batch,
                                                 prm_stride);
  });
}

int sfm_pair_sym_compact_batched(int law, const float* x, const float* y,
                                 const float* vx, const float* vy,
                                 const float* rad, const uint8_t* alive,
                                 const float* prm, int prm_stride,
                                 int use_radius, int n, int batch,
                                 const float* bb, const int* surv,
                                 const int* counts, int max_surv, float c2,
                                 float* fx, float* fy, void* stream) {
  const Planes pl = planes(x, y, vx, vy, rad, alive, n, 0);
  return with_antisymmetric_law(law, [&](auto l) {
    return sym_launch<kSymTable, decltype(l)>(pl, prm, use_radius, bb, surv,
                                              counts, max_surv, c2, fx, fy,
                                              stream, batch, prm_stride);
  });
}

int sfm_pair_dense_cutoff_batched(int law, const float* rx, const float* ry,
                                  const float* ru, const float* rv,
                                  const float* rrad, const uint8_t* ralive,
                                  const float* cx, const float* cy,
                                  const float* cvx, const float* cvy,
                                  const float* crad, const uint8_t* calive,
                                  const float* prm, int prm_stride,
                                  int use_radius, int n, int batch,
                                  const float* col_bb, const float* chunk_bb,
                                  float c2, float* fx, float* fy,
                                  void* stream) {
  const Planes rows = planes(rx, ry, ru, rv, rrad, ralive, n, 0);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n, 0);
  return with_any_law(law, [&](auto l) {
    return box_skip_batched_launch<decltype(l)>(
        rows, cols, prm, use_radius, col_bb, chunk_bb, c2, fx, fy, stream,
        batch, prm_stride);
  });
}

int sfm_pair_compact_batched(int law, const float* rx, const float* ry,
                             const float* ru, const float* rv,
                             const float* rrad, const uint8_t* ralive,
                             const float* cx, const float* cy,
                             const float* cvx, const float* cvy,
                             const float* crad, const uint8_t* calive,
                             const float* prm, int prm_stride, int use_radius,
                             int n, int batch, const float* col_bb,
                             const int* surv, const int* counts, int max_surv,
                             float c2, float* fx, float* fy, void* stream) {
  const Planes rows = planes(rx, ry, ru, rv, rrad, ralive, n, 0);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n, 0);
  return with_any_law(law, [&](auto l) {
    return dense_launch<kTable, decltype(l)>(
        rows, cols, prm, use_radius, col_bb, surv, counts, max_surv, c2, fx,
        fy, stream, batch, prm_stride);
  });
}

// The batched rectangular walks (a batch of crowds whose slots are sharded
// over an agent axis): batch crowds, each with n_rows rows from global slot
// row_off against n_cols columns from global slot col_off, the row planes
// (batch, n_rows) and the column planes (batch, n_cols) row-major, prm
// (batch, P) with rows prm_stride apart (0: one vector for every crowd).
// The dense forms overwrite every row of fx, fy (batch, n_rows); the
// full-block forms accumulate +f into fx, fy and -f into fxc, fyc (batch,
// n_cols), all zero on entry.  The cutoff forms take each crowd's grid
// stacked: col_bb (batch, 4, n_col_tiles; the table form
// sfm_pair_compact_rect_batched: 32-column chunk boxes, (batch, 4,
// ceil(n_cols / 32)); the box-skip form sfm_pair_dense_cutoff_rect_batched
// takes those as chunk_bb beside the tile boxes), row_bb (batch, 4,
// n_row_tiles), surv (batch, nt, max_surv) and counts (batch, nt), nt =
// ceil(n_rows / 128).
int sfm_pair_dense_rect_batched(int law, const float* rx, const float* ry,
                                const float* ru, const float* rv,
                                const float* rrad, const uint8_t* ralive,
                                int n_rows, int row_off, const float* cx,
                                const float* cy, const float* cvx,
                                const float* cvy, const float* crad,
                                const uint8_t* calive, int n_cols,
                                int col_off, const float* prm, int prm_stride,
                                int use_radius, int batch, float* fx,
                                float* fy, void* stream) {
  const Planes rows = planes(rx, ry, ru, rv, rrad, ralive, n_rows, row_off);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n_cols, col_off);
  return with_any_law(law, [&](auto l) {
    return dense_launch<kAllTiles, decltype(l)>(
        rows, cols, prm, use_radius, nullptr, nullptr, nullptr, 1, 0.0f, fx,
        fy, stream, batch, prm_stride);
  });
}

int sfm_pair_dense_cutoff_rect_batched(
    int law, const float* rx, const float* ry, const float* ru,
    const float* rv, const float* rrad, const uint8_t* ralive, int n_rows,
    int row_off, const float* cx, const float* cy, const float* cvx,
    const float* cvy, const float* crad, const uint8_t* calive, int n_cols,
    int col_off, const float* prm, int prm_stride, int use_radius, int batch,
    const float* col_bb, const float* chunk_bb, float c2, float* fx,
    float* fy, void* stream) {
  const Planes rows = planes(rx, ry, ru, rv, rrad, ralive, n_rows, row_off);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n_cols, col_off);
  return with_any_law(law, [&](auto l) {
    return box_skip_batched_launch<decltype(l)>(
        rows, cols, prm, use_radius, col_bb, chunk_bb, c2, fx, fy, stream,
        batch, prm_stride);
  });
}

int sfm_pair_compact_rect_batched(
    int law, const float* rx, const float* ry, const float* ru,
    const float* rv, const float* rrad, const uint8_t* ralive, int n_rows,
    int row_off, const float* cx, const float* cy, const float* cvx,
    const float* cvy, const float* crad, const uint8_t* calive, int n_cols,
    int col_off, const float* prm, int prm_stride, int use_radius, int batch,
    const float* col_bb, const int* surv, const int* counts, int max_surv,
    float c2, float* fx, float* fy, void* stream) {
  const Planes rows = planes(rx, ry, ru, rv, rrad, ralive, n_rows, row_off);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n_cols, col_off);
  return with_any_law(law, [&](auto l) {
    return dense_launch<kTable, decltype(l)>(
        rows, cols, prm, use_radius, col_bb, surv, counts, max_surv, c2, fx,
        fy, stream, batch, prm_stride);
  });
}

int sfm_pair_sym_dense_batched(int law, const float* rx, const float* ry,
                               const float* rvx, const float* rvy,
                               const float* rrad, const uint8_t* ralive,
                               int n_rows, int row_off, const float* cx,
                               const float* cy, const float* cvx,
                               const float* cvy, const float* crad,
                               const uint8_t* calive, int n_cols, int col_off,
                               const float* prm, int prm_stride,
                               int use_radius, int batch, float* fx,
                               float* fy, float* fxc, float* fyc,
                               void* stream) {
  const Planes rows = planes(rx, ry, rvx, rvy, rrad, ralive, n_rows, row_off);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n_cols, col_off);
  return with_antisymmetric_law(law, [&](auto l) {
    return sym_dense_launch<false, decltype(l)>(
        rows, cols, prm, use_radius, nullptr, nullptr, 0.0f, fx, fy, fxc, fyc,
        stream, batch, prm_stride);
  });
}

int sfm_pair_sym_dense_cutoff_batched(
    int law, const float* rx, const float* ry, const float* rvx,
    const float* rvy, const float* rrad, const uint8_t* ralive, int n_rows,
    int row_off, const float* cx, const float* cy, const float* cvx,
    const float* cvy, const float* crad, const uint8_t* calive, int n_cols,
    int col_off, const float* prm, int prm_stride, int use_radius, int batch,
    const float* row_bb, const float* col_bb, float c2, float* fx, float* fy,
    float* fxc, float* fyc, void* stream) {
  const Planes rows = planes(rx, ry, rvx, rvy, rrad, ralive, n_rows, row_off);
  const Planes cols = planes(cx, cy, cvx, cvy, crad, calive, n_cols, col_off);
  return with_antisymmetric_law(law, [&](auto l) {
    return sym_dense_launch<true, decltype(l)>(
        rows, cols, prm, use_radius, row_bb, col_bb, c2, fx, fy, fxc, fyc,
        stream, batch, prm_stride);
  });
}

const char* sfm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
