// Moussaid pair-force kernels for Hopper (sm_90a), with a plain C interface
// for ctypes (utils/cuda_build.py builds this file, ops/cuda_forces.py binds
// it).  The plain PyTorch version of both is ops/forces.py::pedestrian_force.
//
// What each function replaces (JAX package, ops/pallas_forces.py):
//   pair_force_dense_kernel  <- _pair_kernel (:162), the dense per-row sum
//                               over all column tiles, launched by _slab_call
//                               with surv=None.
//   pair_force_sym_kernel    <- _pair_kernel_sym (:239) with _pair_tile
//                               (:375) and _triangle_table (:344): each
//                               unordered pair once, +f to the row, -f to the
//                               column.  The polynomial _atan2 (:129) existed
//                               only because Mosaic has no atan2; here it is
//                               atan2f.
//
// What bounds them on this card.  At N = 10,000 the symmetric kernel computes
// about N^2/2 = 5e7 pairs per step, each about 40 flops and 5 transcendentals
// (2 rsqrt, atan2, 2 exp) plus one division; it reads O(N) state (200 KB) and
// writes O(N) forces, so it is compute-bound, and small: a fraction of a
// millisecond on 132 SMs.  The step around it is a few dozen element-wise
// PyTorch launches of O(N) each, so the eager step is expected to be bound by
// launch overhead, not by this kernel.
//
// What the design does about that.  Every block stages its column tile in
// shared memory once and each thread keeps its row sum in registers, so the
// only device-memory traffic is O(N) per tile.  The symmetric kernel's grid
// is the upper triangle of 128 x 128 tile pairs (3,160 blocks at N = 10k,
// enough to fill the card); the dense kernel gives each row 8 threads so that
// N = 10k still yields 313 blocks of 256 threads.  Parameters are read
// through a device pointer, so a step never synchronises with the host.
// Making the kernel itself faster (wgmma-free tile tuning, fewer
// transcendentals) and removing the eager launches (CUDA graphs) are later
// work.
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
// summation order.  The dense kernel uses no atomics: each row's eight partial
// sums are combined in a fixed order, so its result is deterministic.
//
// Liveness is an explicit mask (alive, one byte per agent): dead agents give
// and receive nothing, and dead rows come out exactly 0.  The JAX kernels
// instead parked dead agents at a far sentinel; the mask needs no position
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_forces.cuh"

namespace {

constexpr int kSymTile = 128;  // rows == columns of one tile pair
constexpr int kSymWarps = kSymTile / 32;
constexpr int kDenseRows = 32;  // rows per block
constexpr int kDenseSplit = 8;  // threads per row
constexpr int kDenseThreads = kDenseRows * kDenseSplit;  // == columns staged

__device__ __forceinline__ MoussaidPrm load_prm(const float* __restrict__ prm) {
  MoussaidPrm p;
  p.lam = prm[0];
  p.A = prm[1];
  p.gamma = prm[2];
  p.n = prm[3];
  p.n_prime = prm[4];
  p.eps = prm[5];
  return p;
}

__global__ void __launch_bounds__(kDenseThreads)
pair_force_dense_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        const float* __restrict__ vx, const float* __restrict__ vy,
                        const float* __restrict__ rad,
                        const uint8_t* __restrict__ alive,
                        const float* __restrict__ prm, int use_radius, int n,
                        float* __restrict__ fx, float* __restrict__ fy) {
  __shared__ float sx[kDenseThreads], sy[kDenseThreads];
  __shared__ float svx[kDenseThreads], svy[kDenseThreads], sr[kDenseThreads];
  __shared__ uint8_t sa[kDenseThreads];
  __shared__ float part_x[kDenseRows][kDenseSplit + 1];
  __shared__ float part_y[kDenseRows][kDenseSplit + 1];

  const MoussaidPrm p = load_prm(prm);
  const int tid = threadIdx.x;
  const int lrow = tid / kDenseSplit;
  const int lane = tid % kDenseSplit;
  const int i = blockIdx.x * kDenseRows + lrow;
  const bool row_in = i < n;
  const float xi = row_in ? x[i] : 0.0f;
  const float yi = row_in ? y[i] : 0.0f;
  const float vxi = row_in ? vx[i] : 0.0f;
  const float vyi = row_in ? vy[i] : 0.0f;
  const float ri = row_in ? rad[i] : 0.0f;
  const bool ai = row_in && alive[i] != 0;

  float ax = 0.0f, ay = 0.0f;
  for (int c0 = 0; c0 < n; c0 += kDenseThreads) {
    __syncthreads();  // the previous column tile is consumed
    const int jt = c0 + tid;
    const bool col_in = jt < n;
    sx[tid] = col_in ? x[jt] : 0.0f;
    sy[tid] = col_in ? y[jt] : 0.0f;
    svx[tid] = col_in ? vx[jt] : 0.0f;
    svy[tid] = col_in ? vy[jt] : 0.0f;
    sr[tid] = col_in ? rad[jt] : 0.0f;
    sa[tid] = col_in ? alive[jt] : 0;
    __syncthreads();
    const int cnt = min(kDenseThreads, n - c0);
    for (int k = lane; k < cnt; k += kDenseSplit) {
      const bool ok = ai && sa[k] != 0 && (c0 + k) != i;
      const float rsub = use_radius ? ri + sr[k] : 0.0f;
      float fxk, fyk;
      moussaid_pair(sx[k] - xi, sy[k] - yi, vxi - svx[k], vyi - svy[k], rsub,
                    ok, p, fxk, fyk);
      ax += fxk;
      ay += fyk;
    }
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

__global__ void __launch_bounds__(kSymTile)
pair_force_sym_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ vx, const float* __restrict__ vy,
                      const float* __restrict__ rad,
                      const uint8_t* __restrict__ alive,
                      const float* __restrict__ prm, int use_radius, int n,
                      int n_tiles, float* __restrict__ fx,
                      float* __restrict__ fy) {
  __shared__ float cx[kSymTile], cy[kSymTile], cvx[kSymTile], cvy[kSymTile];
  __shared__ float cr[kSymTile];
  __shared__ uint8_t ca[kSymTile];
  __shared__ float col_x[kSymWarps][kSymTile];
  __shared__ float col_y[kSymWarps][kSymTile];

  // block -> tile pair (ti, tj) with tj >= ti
  const long long b = blockIdx.x;
  const long long nt = n_tiles;
  const double q = (double)(2 * nt + 1);
  long long ti = (long long)((q - sqrt(q * q - 8.0 * (double)b)) * 0.5);
  if (ti < 0) ti = 0;
  if (ti > nt - 1) ti = nt - 1;
  while (ti > 0 && tri_start(ti, nt) > b) --ti;
  while (ti + 1 < nt && tri_start(ti + 1, nt) <= b) ++ti;
  const long long tj = ti + (b - tri_start(ti, nt));

  const MoussaidPrm p = load_prm(prm);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int jt = (int)(tj * kSymTile) + tid;
  const bool col_in = jt < n;
  cx[tid] = col_in ? x[jt] : 0.0f;
  cy[tid] = col_in ? y[jt] : 0.0f;
  cvx[tid] = col_in ? vx[jt] : 0.0f;
  cvy[tid] = col_in ? vy[jt] : 0.0f;
  cr[tid] = col_in ? rad[jt] : 0.0f;
  ca[tid] = col_in ? alive[jt] : 0;
#pragma unroll
  for (int w = 0; w < kSymWarps; ++w) {
    col_x[w][tid] = 0.0f;
    col_y[w][tid] = 0.0f;
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
      const bool ok = ai && ca[jj] != 0 && (j0 + jj) > i;
      const float rsub = use_radius ? ri + cr[jj] : 0.0f;
      float fxk, fyk;
      moussaid_pair(cx[jj] - xi, cy[jj] - yi, vxi - cvx[jj], vyi - cvy[jj],
                    rsub, ok, p, fxk, fyk);
      ax += fxk;
      ay += fyk;
      col_x[warp][jj] -= fxk;  // Newton's third law: f_ji = -f_ij
      col_y[warp][jj] -= fyk;
      __syncwarp();
    }
  }
  if (ai) {
    atomicAdd(&fx[i], ax);
    atomicAdd(&fy[i], ay);
  }
  __syncthreads();
  if (col_in && ca[tid] != 0) {
    float sx_sum = 0.0f, sy_sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kSymWarps; ++w) {
      sx_sum += col_x[w][tid];
      sy_sum += col_y[w][tid];
    }
    atomicAdd(&fx[jt], sx_sum);
    atomicAdd(&fy[jt], sy_sum);
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError(): non-zero
// means the launch was refused.  fx and fy must hold zeros on entry for the
// symmetric kernel (it accumulates); the dense kernel overwrites every row.
int sfm_pair_force_dense(const float* x, const float* y, const float* vx,
                         const float* vy, const float* rad,
                         const uint8_t* alive, const float* prm,
                         int use_radius, int n, float* fx, float* fy,
                         void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kDenseRows - 1) / kDenseRows;
  pair_force_dense_kernel<<<blocks, kDenseThreads, 0, (cudaStream_t)stream>>>(
      x, y, vx, vy, rad, alive, prm, use_radius, n, fx, fy);
  return (int)cudaGetLastError();
}

int sfm_pair_force_sym(const float* x, const float* y, const float* vx,
                       const float* vy, const float* rad, const uint8_t* alive,
                       const float* prm, int use_radius, int n, float* fx,
                       float* fy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long nt = (n + kSymTile - 1) / kSymTile;
  const long long pairs = nt * (nt + 1) / 2;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pair_force_sym_kernel<<<(unsigned)pairs, kSymTile, 0,
                          (cudaStream_t)stream>>>(
      x, y, vx, vy, rad, alive, prm, use_radius, n, (int)nt, fx, fy);
  return (int)cudaGetLastError();
}

const char* sfm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
