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
// What bounds them on this card.  Each Moussaid pair costs about 85 f32
// operations and 6 special-function operations (2 rsqrt, atan2, 2 exp, a
// division); a power-law pair about 40 and 7 (a root, an exp, 5
// divisions), a Helbing pair about 50 and 11 (4 roots, an exp, 6
// divisions); a kernel reads O(N) state and writes O(N) forces.  So the
// pair count bounds them: N^2/2 (N^2) pairs without a cutoff, and under a
// cutoff the pairs within it, about pi*c^2*density per agent -- at 0.25
// agents/m^2 and c = 30 m, 707 per agent.  A tile-granular walk evaluates
// every pair of a surviving tile pair, several times the pairs within the
// cutoff; the per-pair mask keeps the result that of the pairs within it.
// The power law's gates make most pairs do no work beyond the gate values,
// but a warp pays for every lane whose pair passes.
//
// What the design does about that.  Every block stages its column tile in
// shared memory once and each thread keeps its row sum in registers, so the
// only device-memory traffic is O(N) per tile.  The symmetric kernel's grid
// is the upper triangle of 128 x 128 tile pairs (or the table's slots); the
// dense kernels give each row 8 threads so that N = 10k still yields 313
// blocks of 256 threads.  Parameters are read through a device pointer, and
// the compacted forms decide an overflowing row on the device, so a step
// never synchronises with the host.  Making the kernels themselves faster
// and removing the eager launches (CUDA graphs) are later work.
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
// summation order.  The dense kernels use no atomics: each row's eight
// partial sums are combined in a fixed order, so their results are
// deterministic, and the compacted kernel equals the dense cutoff kernel
// bitwise: it stages the same tiles in the same ascending order (each block
// re-tests every listed tile against its own 32-row box, the test the dense
// cutoff kernel applies to every tile) and sums them the same way.  The
// TPU's compacted grid fell back to the whole dense grid with a lax.cond when
// any row overflowed its table; here only the overflowing row walks every
// column tile with the box test.  The TPU's 1 MB SMEM bounded its static
// triangle table and survivor table; here the triangle is decoded from the
// block index and the table lives in device memory.
//
// Liveness is an explicit mask (alive, one byte per agent): dead agents give
// and receive nothing, and dead rows come out exactly 0.  The JAX kernels
// instead parked dead agents at a far sentinel; the mask needs no position
// bound.  Boxes are taken over alive agents only, so a tile without an alive
// agent never hits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_laws.cuh"

namespace {

constexpr int kSymTile = 128;  // rows == columns of one tile pair
constexpr int kSymWarps = kSymTile / 32;
constexpr int kDenseRows = 32;  // rows per block
constexpr int kDenseSplit = 8;  // threads per row
constexpr int kDenseThreads = kDenseRows * kDenseSplit;  // == columns staged
// a survivor-table row covers one 128-row tile: kTableBlocks dense blocks
constexpr int kTableBlocks = kSymTile / kDenseRows;

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

template <int kWalk, class Law>
__global__ void __launch_bounds__(kDenseThreads)
pair_force_dense_kernel(Planes rows, Planes cols,
                        const float* __restrict__ prm, int use_radius,
                        const float* __restrict__ col_bb,
                        const int* __restrict__ surv,
                        const int* __restrict__ counts, int max_surv, float c2,
                        float* __restrict__ fx, float* __restrict__ fy) {
  __shared__ float sx[kDenseThreads], sy[kDenseThreads];
  __shared__ float svx[kDenseThreads], svy[kDenseThreads], sr[kDenseThreads];
  __shared__ uint8_t sa[kDenseThreads];
  __shared__ float part_x[kDenseRows][kDenseSplit + 1];
  __shared__ float part_y[kDenseRows][kDenseSplit + 1];
  __shared__ float rbox[4];

  const typename Law::Prm p = Law::load(prm);
  const int tid = threadIdx.x;
  const int lrow = tid / kDenseSplit;
  const int lane = tid % kDenseSplit;
  const int i = blockIdx.x * kDenseRows + lrow;
  const int n = cols.n;
  const bool row_in = i < rows.n;
  const float xi = row_in ? rows.x[i] : 0.0f;
  const float yi = row_in ? rows.y[i] : 0.0f;
  const float ui = row_in ? rows.u[i] : 0.0f;  // the row slots: v_i, or e_i
  const float vi = row_in ? rows.v[i] : 0.0f;
  float ri = 0.0f;
  if constexpr (Law::kRadius) ri = row_in ? rows.rad[i] : 0.0f;
  const bool ai = row_in && rows.alive[i] != 0;
  const int gi = rows.off + i;  // the row's global slot
  const long long n_col_tiles = (n + kDenseThreads - 1) / kDenseThreads;

  if (kWalk != kAllTiles) {
    // the box of the block's alive rows (warp 0, one row per lane)
    if (tid < 32) {
      const int r = blockIdx.x * kDenseRows + tid;
      const bool a = r < rows.n && rows.alive[r] != 0;
      float x0 = a ? rows.x[r] : INFINITY, x1 = a ? rows.x[r] : -INFINITY;
      float y0 = a ? rows.y[r] : INFINITY, y1 = a ? rows.y[r] : -INFINITY;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x0 = fminf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
        y0 = fminf(y0, __shfl_xor_sync(0xffffffffu, y0, off));
        y1 = fmaxf(y1, __shfl_xor_sync(0xffffffffu, y1, off));
      }
      if (tid == 0) {
        rbox[0] = x0;
        rbox[1] = x1;
        rbox[2] = y0;
        rbox[3] = y1;
      }
    }
    __syncthreads();
  }

  float ax = 0.0f, ay = 0.0f;
  // stage column tile t and add its pairs to this thread's row sum
  auto run_tile = [&](long long t) {
    const int c0 = (int)(t * kDenseThreads);
    __syncthreads();  // the previous column tile is consumed
    const int jt = c0 + tid;
    const bool col_in = jt < n;
    sx[tid] = col_in ? cols.x[jt] : 0.0f;
    sy[tid] = col_in ? cols.y[jt] : 0.0f;
    svx[tid] = col_in ? cols.u[jt] : 0.0f;
    svy[tid] = col_in ? cols.v[jt] : 0.0f;
    if constexpr (Law::kRadius) sr[tid] = col_in ? cols.rad[jt] : 0.0f;
    sa[tid] = col_in ? cols.alive[jt] : 0;
    __syncthreads();
    const int cnt = min(kDenseThreads, n - c0);
    const int g0 = cols.off + c0;
    for (int k = lane; k < cnt; k += kDenseSplit) {
      const float dx = sx[k] - xi;
      const float dy = sy[k] - yi;
      bool ok = ai && sa[k] != 0 && (g0 + k) != gi;
      if (kWalk != kAllTiles) ok = ok && sq_norm_rn(dx, dy) <= c2;
      float fxk, fyk;
      Law::pair(dx, dy, ui, vi, svx[k], svy[k], ri,
                Law::kRadius ? sr[k] : 0.0f, use_radius, ok, p, fxk, fyk);
      ax += fxk;
      ay += fyk;
    }
  };
  // block-uniform: rbox and the column boxes are the same for every thread
  auto hits = [&](long long t) {
    return box_hits(col_bb, n_col_tiles, t, rbox[0], rbox[1], rbox[2],
                    rbox[3], c2);
  };

  const long long trow = blockIdx.x / kTableBlocks;
  if (kWalk == kTable && counts[trow] <= max_surv) {
    // the row's surviving tiles, ascending (a superset of the tiles this
    // block's own box hits: the table row's box contains it)
    for (int s = 0; s < max_surv; ++s) {
      const int t = surv[trow * max_surv + s];
      if (t < 0) break;
      if (hits(t)) run_tile(t);
    }
  } else {
    // every column tile (an overflowing table row walks them all too)
    for (long long t = 0; t < n_col_tiles; ++t)
      if (kWalk == kAllTiles || hits(t)) run_tile(t);
  }

  part_x[lrow][lane] = ax;
  part_y[lrow][lane] = ay;
  __syncthreads();
  if (lane == 0 && row_in) {
    float sx_sum = 0.0f, sy_sum = 0.0f;
    for (int s = 0; s < kDenseSplit; ++s) {  // fixed order: deterministic
      sx_sum += part_x[lrow][s];
      sy_sum += part_y[lrow][s];
    }
    fx[i] = sx_sum;
    fy[i] = sy_sum;
  }
}

// Row-major position of tile pair (ti, tj), tj >= ti, in the upper triangle
// of an n_tiles x n_tiles grid: row ti starts at ti*n_tiles - ti*(ti-1)/2.
__device__ __forceinline__ long long tri_start(long long ti, long long nt) {
  return ti * nt - ti * (ti - 1) / 2;
}

struct SymShared {
  float cx[kSymTile], cy[kSymTile], cvx[kSymTile], cvy[kSymTile];
  float cr[kSymTile];
  uint8_t ca[kSymTile];
  float col_x[kSymWarps][kSymTile];
  float col_y[kSymWarps][kSymTile];
};

// One tile pair (row tile ti, column tile tj) of a Newton's-third-law walk:
// +f to the row (atomics into fx, fy) and -f to the column (atomics into
// fxc, fyc).  kTriangle: rows and columns are the same planes, and only the
// pairs with column index above row index count (each unordered pair once);
// otherwise every pair of the two tiles counts once (the full block of two
// different shards).  fxc, fyc may be fx, fy (the square walks).
// Block-uniform; may be called repeatedly.
template <bool kTri, bool kCutoff, class Law>
__device__ __forceinline__ void sym_tile_pair(
    SymShared& sm, long long ti, long long tj, const Planes& rows,
    const Planes& cols, const typename Law::Prm& p, int use_radius, float c2,
    float* fx, float* fy, float* fxc, float* fyc) {
  static_assert(Law::kAntisymmetric,
                "the Newton's-third-law walk needs an antisymmetric law");
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  __syncthreads();  // the previous tile pair's column sums are read
  const int jt = (int)(tj * kSymTile) + tid;
  const bool col_in = jt < cols.n;
  sm.cx[tid] = col_in ? cols.x[jt] : 0.0f;
  sm.cy[tid] = col_in ? cols.y[jt] : 0.0f;
  sm.cvx[tid] = col_in ? cols.u[jt] : 0.0f;
  sm.cvy[tid] = col_in ? cols.v[jt] : 0.0f;
  sm.cr[tid] = col_in ? cols.rad[jt] : 0.0f;
  sm.ca[tid] = col_in ? cols.alive[jt] : 0;
#pragma unroll
  for (int w = 0; w < kSymWarps; ++w) {
    sm.col_x[w][tid] = 0.0f;
    sm.col_y[w][tid] = 0.0f;
  }

  const int i = (int)(ti * kSymTile) + tid;
  const bool row_in = i < rows.n;
  const float xi = row_in ? rows.x[i] : 0.0f;
  const float yi = row_in ? rows.y[i] : 0.0f;
  const float vxi = row_in ? rows.u[i] : 0.0f;
  const float vyi = row_in ? rows.v[i] : 0.0f;
  const float ri = row_in ? rows.rad[i] : 0.0f;
  const bool ai = row_in && rows.alive[i] != 0;
  const int j0 = (int)(tj * kSymTile);
  const int gi = rows.off + i;
  const int g0 = cols.off + j0;
  __syncthreads();

  float ax = 0.0f, ay = 0.0f;
  for (int c0 = 0; c0 < kSymTile; c0 += 32) {
    for (int k = 0; k < 32; ++k) {
      // staggered: at each step the 32 lanes of a warp hold 32 distinct
      // columns, so the warp's row of col_x/col_y is written without races
      const int jj = c0 + ((lane + k) & 31);
      const float dx = sm.cx[jj] - xi;
      const float dy = sm.cy[jj] - yi;
      bool ok = ai && sm.ca[jj] != 0;
      ok = ok && (kTri ? (j0 + jj) > i : (g0 + jj) != gi);
      if (kCutoff) ok = ok && sq_norm_rn(dx, dy) <= c2;
      float fxk, fyk;
      Law::pair(dx, dy, vxi, vyi, sm.cvx[jj], sm.cvy[jj], ri, sm.cr[jj],
                use_radius, ok, p, fxk, fyk);
      ax += fxk;
      ay += fyk;
      sm.col_x[warp][jj] -= fxk;  // Newton's third law: f_ji = -f_ij
      sm.col_y[warp][jj] -= fyk;
      __syncwarp();
    }
  }
  if (ai) {
    atomicAdd(&fx[i], ax);
    atomicAdd(&fy[i], ay);
  }
  __syncthreads();
  if (col_in && sm.ca[tid] != 0) {
    float sx_sum = 0.0f, sy_sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kSymWarps; ++w) {
      sx_sum += sm.col_x[w][tid];
      sy_sum += sm.col_y[w][tid];
    }
    atomicAdd(&fxc[jt], sx_sum);
    atomicAdd(&fyc[jt], sy_sum);
  }
}

template <int kWalk, class Law>
__global__ void __launch_bounds__(kSymTile)
pair_force_sym_kernel(Planes pl, const float* __restrict__ prm,
                      int use_radius, int n_tiles, const float* __restrict__ bb,
                      const int* __restrict__ surv,
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
        sym_tile_pair<true, true, Law>(sm, r, tj, pl, pl, p, use_radius, c2,
                                       fx, fy, fx, fy);
    } else {
      for (long long tj = r + s; tj < nt; tj += max_surv)
        if (hits(r, tj))
          sym_tile_pair<true, true, Law>(sm, r, tj, pl, pl, p, use_radius,
                                         c2, fx, fy, fx, fy);
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
  sym_tile_pair<true, kWalk == kTriangleBox, Law>(sm, ti, tj, pl, pl, p,
                                                  use_radius, c2, fx, fy, fx,
                                                  fy);
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
  sym_tile_pair<false, kBox, Law>(sm, ti, tj, rows, cols, p, use_radius, c2,
                                  fx, fy, fxc, fyc);
}

// Launch of a dense-layout walk with law Law: one block of kDenseRows rows
// per 32 row agents.
template <int kWalk, class Law>
int dense_launch(const Planes& rows, const Planes& cols, const float* prm,
                 int use_radius, const float* col_bb, const int* surv,
                 const int* counts, int max_surv, float c2, float* fx,
                 float* fy, void* stream) {
  if (rows.n <= 0) return (int)cudaSuccess;
  if (cols.n < 0) return (int)cudaErrorInvalidValue;
  if (kWalk == kTable && max_surv < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (rows.n + kDenseRows - 1) / kDenseRows;
  pair_force_dense_kernel<kWalk, Law><<<blocks, kDenseThreads, 0,
                                        (cudaStream_t)stream>>>(
      rows, cols, prm, use_radius, col_bb, surv, counts, max_surv, c2, fx, fy);
  return (int)cudaGetLastError();
}

// Launch of a symmetric walk with law Law: one block per tile pair of the
// upper triangle (kTriangle, kTriangleBox) or per table slot (kSymTable).
template <int kWalk, class Law>
int sym_launch(const Planes& pl, const float* prm, int use_radius,
               const float* bb, const int* surv, const int* counts,
               int max_surv, float c2, float* fx, float* fy, void* stream) {
  const int n = pl.n;
  if (n <= 0) return (int)cudaSuccess;
  if (kWalk == kSymTable && max_surv < 1) return (int)cudaErrorInvalidValue;
  const long long nt = (n + kSymTile - 1) / kSymTile;
  const long long blocks =
      kWalk == kSymTable ? nt * max_surv : nt * (nt + 1) / 2;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pair_force_sym_kernel<kWalk, Law><<<(unsigned)blocks, kSymTile, 0,
                                      (cudaStream_t)stream>>>(
      pl, prm, use_radius, (int)nt, bb, surv, counts, max_surv, c2, fx, fy);
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

const char* sfm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
