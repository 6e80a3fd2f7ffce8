// Pair-force kernels for Hopper (sm_90a), with a plain C interface for ctypes
// (utils/cuda_build.py builds this file, ops/cuda_forces.py binds it).  Each
// kernel is a template over its walk (which tile pairs a block visits) and
// its pair law (pair_forces.cuh): the Moussaid force, the Karamouzas power
// law and the Helbing ellipse.  The plain PyTorch versions are
// ops/forces.py::pedestrian_force, ::powerlaw_force and
// ::ped_repulsive_force (with ``cutoff`` for the cutoff forms).
//
// The laws replace the JAX package's per-law tile functions
// (ops/pallas_forces.py, all launched through _tile_fn :608): _pair_tile
// (:375, Moussaid), _pair_tile_powerlaw (:462) and _pair_tile_helbing
// (:528).  Moussaid and the power law take every walk below; Helbing, which
// is not antisymmetric, takes the dense walks only (the JAX package forces
// symmetric=False for it, :714-719).  The TPU kernel staged Helbing's row
// desired directions in the row velocity slots, because its row and column
// planes were separate arrays; here rows and columns are read from the same
// planes, so the Helbing entries take explicit ex, ey row planes beside the
// column velocities.
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
// in parallel and in no order, so the symmetric kernel reduces its column
// partials inside the block (per-warp rows of shared memory, written without
// conflicts in a staggered order) and then adds them with one atomicAdd per
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

#include "pair_forces.cuh"

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

// The pair laws the kernels are instantiated for.  Each reads its
// parameter vector (models/params.py *_vector), says whether it reads radii
// and whether it is antisymmetric, and evaluates one pair from the row's
// position and velocity slots (u, v) and the column's position, velocity
// (cu, cv) and radius.  The row slots hold v_i, except for Helbing, whose
// entries pass the row's desired direction e_i there.
struct Moussaid {
  using Prm = MoussaidPrm;
  static constexpr bool kRadius = true;
  static constexpr bool kAntisymmetric = true;
  static __device__ __forceinline__ Prm load(const float* __restrict__ prm) {
    return Prm{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5]};
  }
  static __device__ __forceinline__ void pair(float dx, float dy, float u,
                                              float v, float cu, float cv,
                                              float ri, float rj,
                                              int use_radius, bool ok,
                                              const Prm& p, float& fx,
                                              float& fy) {
    const float rsub = use_radius ? ri + rj : 0.0f;
    moussaid_pair(dx, dy, u - cu, v - cv, rsub, ok, p, fx, fy);
  }
};

struct PowerLaw {  // disc radii always participate
  using Prm = PowerLawPrm;
  static constexpr bool kRadius = true;
  static constexpr bool kAntisymmetric = true;
  static __device__ __forceinline__ Prm load(const float* __restrict__ prm) {
    return Prm{prm[0], prm[1], prm[2], prm[3]};
  }
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

// Box test of row box (rx0, rx1, ry0, ry1) against column tile t of a
// (4, n_tiles) box array.
__device__ __forceinline__ bool box_hits(const float* __restrict__ bb,
                                         long long n_tiles, long long t,
                                         float rx0, float rx1, float ry0,
                                         float ry1, float c2) {
  return box_gap2(rx0, rx1, ry0, ry1, bb[t], bb[n_tiles + t],
                  bb[2 * n_tiles + t], bb[3 * n_tiles + t]) <= c2;
}

template <int kWalk, class Law>
__global__ void __launch_bounds__(kDenseThreads)
pair_force_dense_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        const float* __restrict__ vx,
                        const float* __restrict__ vy,
                        const float* __restrict__ ru,
                        const float* __restrict__ rv,
                        const float* __restrict__ rad,
                        const uint8_t* __restrict__ alive,
                        const float* __restrict__ prm, int use_radius, int n,
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
  const bool row_in = i < n;
  const float xi = row_in ? x[i] : 0.0f;
  const float yi = row_in ? y[i] : 0.0f;
  const float ui = row_in ? ru[i] : 0.0f;  // the row slots: v_i, or e_i
  const float vi = row_in ? rv[i] : 0.0f;
  float ri = 0.0f;
  if constexpr (Law::kRadius) ri = row_in ? rad[i] : 0.0f;
  const bool ai = row_in && alive[i] != 0;
  const long long n_col_tiles = (n + kDenseThreads - 1) / kDenseThreads;

  if (kWalk != kAllTiles) {
    // the box of the block's alive rows (warp 0, one row per lane)
    if (tid < 32) {
      const int r = blockIdx.x * kDenseRows + tid;
      const bool a = r < n && alive[r] != 0;
      float x0 = a ? x[r] : INFINITY, x1 = a ? x[r] : -INFINITY;
      float y0 = a ? y[r] : INFINITY, y1 = a ? y[r] : -INFINITY;
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
    sx[tid] = col_in ? x[jt] : 0.0f;
    sy[tid] = col_in ? y[jt] : 0.0f;
    svx[tid] = col_in ? vx[jt] : 0.0f;
    svy[tid] = col_in ? vy[jt] : 0.0f;
    if constexpr (Law::kRadius) sr[tid] = col_in ? rad[jt] : 0.0f;
    sa[tid] = col_in ? alive[jt] : 0;
    __syncthreads();
    const int cnt = min(kDenseThreads, n - c0);
    for (int k = lane; k < cnt; k += kDenseSplit) {
      const float dx = sx[k] - xi;
      const float dy = sy[k] - yi;
      bool ok = ai && sa[k] != 0 && (c0 + k) != i;
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

// One tile pair (ti, tj), tj >= ti, of the symmetric kernel: every pair
// with column index above row index once, +f to the row and -f to the
// column (atomics into fx, fy).  Block-uniform; may be called repeatedly.
template <bool kCutoff, class Law>
__device__ __forceinline__ void sym_tile_pair(
    SymShared& sm, long long ti, long long tj, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ vx,
    const float* __restrict__ vy, const float* __restrict__ rad,
    const uint8_t* __restrict__ alive, const typename Law::Prm& p,
    int use_radius, int n, float c2, float* __restrict__ fx,
    float* __restrict__ fy) {
  static_assert(Law::kAntisymmetric,
                "the Newton's-third-law walk needs an antisymmetric law");
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  __syncthreads();  // the previous tile pair's column sums are read
  const int jt = (int)(tj * kSymTile) + tid;
  const bool col_in = jt < n;
  sm.cx[tid] = col_in ? x[jt] : 0.0f;
  sm.cy[tid] = col_in ? y[jt] : 0.0f;
  sm.cvx[tid] = col_in ? vx[jt] : 0.0f;
  sm.cvy[tid] = col_in ? vy[jt] : 0.0f;
  sm.cr[tid] = col_in ? rad[jt] : 0.0f;
  sm.ca[tid] = col_in ? alive[jt] : 0;
#pragma unroll
  for (int w = 0; w < kSymWarps; ++w) {
    sm.col_x[w][tid] = 0.0f;
    sm.col_y[w][tid] = 0.0f;
  }

  const int i = (int)(ti * kSymTile) + tid;
  const bool row_in = i < n;
  const float xi = row_in ? x[i] : 0.0f;
  const float yi = row_in ? y[i] : 0.0f;
  const float vxi = row_in ? vx[i] : 0.0f;
  const float vyi = row_in ? vy[i] : 0.0f;
  const float ri = row_in ? rad[i] : 0.0f;
  const bool ai = row_in && alive[i] != 0;
  const int j0 = (int)(tj * kSymTile);
  __syncthreads();

  float ax = 0.0f, ay = 0.0f;
  for (int c0 = 0; c0 < kSymTile; c0 += 32) {
    for (int k = 0; k < 32; ++k) {
      // staggered: at each step the 32 lanes of a warp hold 32 distinct
      // columns, so the warp's row of col_x/col_y is written without races
      const int jj = c0 + ((lane + k) & 31);
      const float dx = sm.cx[jj] - xi;
      const float dy = sm.cy[jj] - yi;
      bool ok = ai && sm.ca[jj] != 0 && (j0 + jj) > i;
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
    atomicAdd(&fx[jt], sx_sum);
    atomicAdd(&fy[jt], sy_sum);
  }
}

template <int kWalk, class Law>
__global__ void __launch_bounds__(kSymTile)
pair_force_sym_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ vx, const float* __restrict__ vy,
                      const float* __restrict__ rad,
                      const uint8_t* __restrict__ alive,
                      const float* __restrict__ prm, int use_radius, int n,
                      int n_tiles, const float* __restrict__ bb,
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
        sym_tile_pair<true, Law>(sm, r, tj, x, y, vx, vy, rad, alive, p,
                                 use_radius, n, c2, fx, fy);
    } else {
      for (long long tj = r + s; tj < nt; tj += max_surv)
        if (hits(r, tj))
          sym_tile_pair<true, Law>(sm, r, tj, x, y, vx, vy, rad, alive, p,
                                   use_radius, n, c2, fx, fy);
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
  sym_tile_pair<kWalk == kTriangleBox, Law>(sm, ti, tj, x, y, vx, vy, rad,
                                            alive, p, use_radius, n, c2, fx,
                                            fy);
}

// Launch of a dense-layout walk with law Law: one block of kDenseRows rows
// per 32 agents.  ru, rv are the row slots (vx, vy; Helbing: ex, ey).
template <int kWalk, class Law>
int dense_launch(const float* x, const float* y, const float* vx,
                 const float* vy, const float* ru, const float* rv,
                 const float* rad, const uint8_t* alive, const float* prm,
                 int use_radius, int n, const float* col_bb, const int* surv,
                 const int* counts, int max_surv, float c2, float* fx,
                 float* fy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (kWalk == kTable && max_surv < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kDenseRows - 1) / kDenseRows;
  pair_force_dense_kernel<kWalk, Law><<<blocks, kDenseThreads, 0,
                                        (cudaStream_t)stream>>>(
      x, y, vx, vy, ru, rv, rad, alive, prm, use_radius, n, col_bb, surv,
      counts, max_surv, c2, fx, fy);
  return (int)cudaGetLastError();
}

// Launch of a symmetric walk with law Law: one block per tile pair of the
// upper triangle (kTriangle, kTriangleBox) or per table slot (kSymTable).
template <int kWalk, class Law>
int sym_launch(const float* x, const float* y, const float* vx,
               const float* vy, const float* rad, const uint8_t* alive,
               const float* prm, int use_radius, int n, const float* bb,
               const int* surv, const int* counts, int max_surv, float c2,
               float* fx, float* fy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (kWalk == kSymTable && max_surv < 1) return (int)cudaErrorInvalidValue;
  const long long nt = (n + kSymTile - 1) / kSymTile;
  const long long blocks =
      kWalk == kSymTable ? nt * max_surv : nt * (nt + 1) / 2;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pair_force_sym_kernel<kWalk, Law><<<(unsigned)blocks, kSymTile, 0,
                                      (cudaStream_t)stream>>>(
      x, y, vx, vy, rad, alive, prm, use_radius, n, (int)nt, bb, surv, counts,
      max_surv, c2, fx, fy);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError(): non-zero
// means the launch was refused.  fx and fy must hold zeros on entry for the
// symmetric kernels (they accumulate); the dense ones overwrite every row.
// Cutoff forms: c2 is the squared cutoff; col_bb / bb hold the column
// tiles' boxes of alive agents as (4, n_tiles) rows [min_x, max_x, min_y,
// max_y] (256-column tiles for the dense forms, 128 for the symmetric);
// surv is the (ceil(n / 128), max_surv) survivor table, ascending and
// padded with -1, and counts each table row's number of hits.
//
// sfm_pair_force_*: the Moussaid law (prm: lambda, A, gamma, n, n_prime,
// epsilon; use_radius subtracts the radii from the distance).
int sfm_pair_force_dense(const float* x, const float* y, const float* vx,
                         const float* vy, const float* rad,
                         const uint8_t* alive, const float* prm,
                         int use_radius, int n, float* fx, float* fy,
                         void* stream) {
  return dense_launch<kAllTiles, Moussaid>(
      x, y, vx, vy, vx, vy, rad, alive, prm, use_radius, n, nullptr, nullptr,
      nullptr, 1, 0.0f, fx, fy, stream);
}

int sfm_pair_force_dense_cutoff(const float* x, const float* y,
                                const float* vx, const float* vy,
                                const float* rad, const uint8_t* alive,
                                const float* prm, int use_radius, int n,
                                const float* col_bb, float c2, float* fx,
                                float* fy, void* stream) {
  return dense_launch<kBoxSkip, Moussaid>(
      x, y, vx, vy, vx, vy, rad, alive, prm, use_radius, n, col_bb, nullptr,
      nullptr, 1, c2, fx, fy, stream);
}

int sfm_pair_force_compact(const float* x, const float* y, const float* vx,
                           const float* vy, const float* rad,
                           const uint8_t* alive, const float* prm,
                           int use_radius, int n, const float* col_bb,
                           const int* surv, const int* counts, int max_surv,
                           float c2, float* fx, float* fy, void* stream) {
  return dense_launch<kTable, Moussaid>(
      x, y, vx, vy, vx, vy, rad, alive, prm, use_radius, n, col_bb, surv,
      counts, max_surv, c2, fx, fy, stream);
}

int sfm_pair_force_sym(const float* x, const float* y, const float* vx,
                       const float* vy, const float* rad, const uint8_t* alive,
                       const float* prm, int use_radius, int n, float* fx,
                       float* fy, void* stream) {
  return sym_launch<kTriangle, Moussaid>(
      x, y, vx, vy, rad, alive, prm, use_radius, n, nullptr, nullptr,
      nullptr, 1, 0.0f, fx, fy, stream);
}

int sfm_pair_force_sym_cutoff(const float* x, const float* y, const float* vx,
                              const float* vy, const float* rad,
                              const uint8_t* alive, const float* prm,
                              int use_radius, int n, const float* bb,
                              float c2, float* fx, float* fy, void* stream) {
  return sym_launch<kTriangleBox, Moussaid>(
      x, y, vx, vy, rad, alive, prm, use_radius, n, bb, nullptr, nullptr, 1,
      c2, fx, fy, stream);
}

int sfm_pair_force_sym_compact(const float* x, const float* y,
                               const float* vx, const float* vy,
                               const float* rad, const uint8_t* alive,
                               const float* prm, int use_radius, int n,
                               const float* bb, const int* surv,
                               const int* counts, int max_surv, float c2,
                               float* fx, float* fy, void* stream) {
  return sym_launch<kSymTable, Moussaid>(
      x, y, vx, vy, rad, alive, prm, use_radius, n, bb, surv, counts,
      max_surv, c2, fx, fy, stream);
}

// sfm_powerlaw_*: the power law (prm: k, tau0, tau_max, tau_min), the same
// forms and arguments as the Moussaid entries without use_radius (disc
// radii always participate).
int sfm_powerlaw_dense(const float* x, const float* y, const float* vx,
                       const float* vy, const float* rad, const uint8_t* alive,
                       const float* prm, int n, float* fx, float* fy,
                       void* stream) {
  return dense_launch<kAllTiles, PowerLaw>(
      x, y, vx, vy, vx, vy, rad, alive, prm, 0, n, nullptr, nullptr, nullptr,
      1, 0.0f, fx, fy, stream);
}

int sfm_powerlaw_dense_cutoff(const float* x, const float* y, const float* vx,
                              const float* vy, const float* rad,
                              const uint8_t* alive, const float* prm, int n,
                              const float* col_bb, float c2, float* fx,
                              float* fy, void* stream) {
  return dense_launch<kBoxSkip, PowerLaw>(
      x, y, vx, vy, vx, vy, rad, alive, prm, 0, n, col_bb, nullptr, nullptr,
      1, c2, fx, fy, stream);
}

int sfm_powerlaw_compact(const float* x, const float* y, const float* vx,
                         const float* vy, const float* rad,
                         const uint8_t* alive, const float* prm, int n,
                         const float* col_bb, const int* surv,
                         const int* counts, int max_surv, float c2, float* fx,
                         float* fy, void* stream) {
  return dense_launch<kTable, PowerLaw>(
      x, y, vx, vy, vx, vy, rad, alive, prm, 0, n, col_bb, surv, counts,
      max_surv, c2, fx, fy, stream);
}

int sfm_powerlaw_sym(const float* x, const float* y, const float* vx,
                     const float* vy, const float* rad, const uint8_t* alive,
                     const float* prm, int n, float* fx, float* fy,
                     void* stream) {
  return sym_launch<kTriangle, PowerLaw>(
      x, y, vx, vy, rad, alive, prm, 0, n, nullptr, nullptr, nullptr, 1,
      0.0f, fx, fy, stream);
}

int sfm_powerlaw_sym_cutoff(const float* x, const float* y, const float* vx,
                            const float* vy, const float* rad,
                            const uint8_t* alive, const float* prm, int n,
                            const float* bb, float c2, float* fx, float* fy,
                            void* stream) {
  return sym_launch<kTriangleBox, PowerLaw>(
      x, y, vx, vy, rad, alive, prm, 0, n, bb, nullptr, nullptr, 1, c2, fx,
      fy, stream);
}

int sfm_powerlaw_sym_compact(const float* x, const float* y, const float* vx,
                             const float* vy, const float* rad,
                             const uint8_t* alive, const float* prm, int n,
                             const float* bb, const int* surv,
                             const int* counts, int max_surv, float c2,
                             float* fx, float* fy, void* stream) {
  return sym_launch<kSymTable, PowerLaw>(
      x, y, vx, vy, rad, alive, prm, 0, n, bb, surv, counts, max_surv, c2, fx,
      fy, stream);
}

// sfm_helbing_*: the Helbing ellipse (prm: v0, sigma, cos_phi, fov_factor,
// step_width, b_min), dense forms only.  vx, vy are the partners'
// velocities; ex, ey each pedestrian's unit desired direction.
int sfm_helbing_dense(const float* x, const float* y, const float* vx,
                      const float* vy, const float* ex, const float* ey,
                      const uint8_t* alive, const float* prm, int n,
                      float* fx, float* fy, void* stream) {
  return dense_launch<kAllTiles, Helbing>(
      x, y, vx, vy, ex, ey, nullptr, alive, prm, 0, n, nullptr, nullptr,
      nullptr, 1, 0.0f, fx, fy, stream);
}

int sfm_helbing_dense_cutoff(const float* x, const float* y, const float* vx,
                             const float* vy, const float* ex,
                             const float* ey, const uint8_t* alive,
                             const float* prm, int n, const float* col_bb,
                             float c2, float* fx, float* fy, void* stream) {
  return dense_launch<kBoxSkip, Helbing>(
      x, y, vx, vy, ex, ey, nullptr, alive, prm, 0, n, col_bb, nullptr,
      nullptr, 1, c2, fx, fy, stream);
}

int sfm_helbing_compact(const float* x, const float* y, const float* vx,
                        const float* vy, const float* ex, const float* ey,
                        const uint8_t* alive, const float* prm, int n,
                        const float* col_bb, const int* surv,
                        const int* counts, int max_surv, float c2, float* fx,
                        float* fy, void* stream) {
  return dense_launch<kTable, Helbing>(
      x, y, vx, vy, ex, ey, nullptr, alive, prm, 0, n, col_bb, surv, counts,
      max_surv, c2, fx, fy, stream);
}

const char* sfm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
