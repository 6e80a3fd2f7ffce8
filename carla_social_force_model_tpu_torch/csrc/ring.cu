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
//     slot k % 2 and forwarded it (steps k >= 1).  A sender at step k >= 2
//     writes into its neighbour's slot (k + 1) % 2 only after the neighbour
//     has finished with it at step k - 1, i.e. after k / 2 uses by all G
//     blocks: the TPU kernel's credit.
// Blocks that spin on a neighbour must never wait for a block that has not
// been scheduled, so the launch is cooperative: the wrapper sizes the grid
// from the occupancy calculator so that every block is resident at once,
// and the launch fails rather than run a grid that does not fit.  Every
// spin is bounded: on overrun a block sets the error word and exits, every
// other spin then stops too, and the wrapper raises.
//
// What bounds it on this card.  The pairs: each device's n_local rows meet
// all N = D * n_local columns, N^2 pairs in all without a cutoff (each at the
// cost of the dense kernels', pair_forces.cu), beside which the bytes of the
// D * (D - 1) block copies are small.  What
// the design does about it: the layout of the dense kernel (32 rows of 8
// threads each per row tile, 256 columns staged in shared memory), with
// each block keeping the sums of up to kMaxRowTiles row tiles in registers
// across all D steps, so the forces are written once, at the end; with a
// cutoff a staged column tile is skipped when no row tile of the block
// reaches its box.  Data of the rotating block is read and written through
// L2 (__ldcg / __stcg): L1 is not coherent across SMs.  Making it fast
// (overlapping the forward with the compute, wgmma) and copies across cards
// (peer pointers) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_laws.cuh"

namespace {

constexpr int kRows = 32;     // rows per row tile
constexpr int kSplit = 8;     // threads per row
constexpr int kThreads = kRows * kSplit;  // == columns per column tile
constexpr int kMaxRowTiles = 4;           // row tiles a block may hold
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

template <bool kCutoff, class Law>
__global__ void __launch_bounds__(kThreads)
ring_force_kernel(RingArgs a) {
  __shared__ float sx[kThreads], sy[kThreads], svx[kThreads], svy[kThreads];
  __shared__ float sr[kThreads], sa[kThreads];
  __shared__ float part_x[kRows][kSplit + 1], part_y[kRows][kSplit + 1];
  __shared__ float rbox[kMaxRowTiles][4];
  __shared__ int s_ok;

  const typename Law::Prm p = Law::load(a.prm);
  const int tid = threadIdx.x;
  const int lrow = tid / kSplit;
  const int lane = tid % kSplit;
  const int d = blockIdx.y;
  const int D = a.n_dev;
  const int G = gridDim.x;
  const int n = a.n_local;
  const int n_row_tiles = (n + kRows - 1) / kRows;
  const int right = (d + 1) % D;
  const long long base = (long long)d * n;  // this device's first row

  // this block's row tiles b, b + G, ... and their rows, in registers
  float xi[kMaxRowTiles], yi[kMaxRowTiles], ui[kMaxRowTiles],
      vi[kMaxRowTiles], ri[kMaxRowTiles];
  bool ai[kMaxRowTiles];
  float ax[kMaxRowTiles], ay[kMaxRowTiles];
#pragma unroll
  for (int r = 0; r < kMaxRowTiles; ++r) {
    const int t = blockIdx.x + r * G;
    const int i = t * kRows + lrow;
    const bool in = t < n_row_tiles && i < n;
    xi[r] = in ? a.rx[base + i] : 0.0f;
    yi[r] = in ? a.ry[base + i] : 0.0f;
    ui[r] = in ? a.ru[base + i] : 0.0f;
    vi[r] = in ? a.rv[base + i] : 0.0f;
    ri[r] = (in && Law::kRadius) ? a.rrad[base + i] : 0.0f;
    ai[r] = in && a.ralive[base + i] != 0;
    ax[r] = 0.0f;
    ay[r] = 0.0f;
    if (kCutoff && tid < 32) {
      // the box of the tile's alive rows (warp 0, one row per lane)
      const int rr = t * kRows + tid;
      const bool live =
          t < n_row_tiles && rr < n && a.ralive[base + rr] != 0;
      float x0 = live ? a.rx[base + rr] : INFINITY;
      float x1 = live ? a.rx[base + rr] : -INFINITY;
      float y0 = live ? a.ry[base + rr] : INFINITY;
      float y1 = live ? a.ry[base + rr] : -INFINITY;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x0 = fminf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
        y0 = fminf(y0, __shfl_xor_sync(0xffffffffu, y0, off));
        y1 = fmaxf(y1, __shfl_xor_sync(0xffffffffu, y1, off));
      }
      if (tid == 0) {
        rbox[r][0] = x0;
        rbox[r][1] = x1;
        rbox[r][2] = y0;
        rbox[r][3] = y1;
      }
    }
  }
  __syncthreads();

  const int nct = a.n_col_tiles;
  for (int k = 0; k < D; ++k) {
    const int src = ((d - k) % D + D) % D;  // the block's home device
    const float* blk =
        k == 0 ? a.cols + (long long)d * a.slot
               : a.comm + ((long long)d * 2 + (k & 1)) * a.slot;
    if (k > 0 && !wait_at_least(&a.fill[d * 2 + (k & 1)], G * ((k + 1) / 2),
                                a.err, &s_ok))
      return;
    if (k < D - 1) {
      // forward this block (and its boxes) into the right neighbour's other
      // slot, once the neighbour is done with that slot's previous block
      const int dst_slot = (k + 1) & 1;
      if (k >= 2 && !wait_at_least(&a.done[right * 2 + dst_slot],
                                   G * (k / 2), a.err, &s_ok))
        return;
      float* dst = a.comm + ((long long)right * 2 + dst_slot) * a.slot;
      for (long long e = (long long)blockIdx.x * kThreads + tid; e < a.slot;
           e += (long long)G * kThreads)
        __stcg(dst + e, __ldcg(blk + e));
      __threadfence();
      __syncthreads();
      if (tid == 0) add_release(&a.fill[right * 2 + dst_slot], 1);
    }

    const float* bb = blk + kPlanes * n;  // (4, n_col_tiles) boxes
    const long long g_src = (long long)src * n;
    for (int t = 0; t < nct; ++t) {
      bool hit[kMaxRowTiles];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kMaxRowTiles; ++r) {
        hit[r] = (int)blockIdx.x + r * G < n_row_tiles;
        if (kCutoff && hit[r])
          hit[r] = box_gap2(rbox[r][0], rbox[r][1], rbox[r][2], rbox[r][3],
                            __ldcg(bb + t), __ldcg(bb + nct + t),
                            __ldcg(bb + 2 * nct + t),
                            __ldcg(bb + 3 * nct + t)) <= a.c2;
        any = any || hit[r];
      }
      if (!any) continue;  // block-uniform
      const int c0 = t * kThreads;
      __syncthreads();  // the previous column tile is consumed
      const int jt = c0 + tid;
      const bool col_in = jt < n;
      sx[tid] = col_in ? __ldcg(blk + jt) : 0.0f;
      sy[tid] = col_in ? __ldcg(blk + n + jt) : 0.0f;
      svx[tid] = col_in ? __ldcg(blk + 2 * n + jt) : 0.0f;
      svy[tid] = col_in ? __ldcg(blk + 3 * n + jt) : 0.0f;
      sr[tid] = col_in ? __ldcg(blk + 4 * n + jt) : 0.0f;
      sa[tid] = col_in ? __ldcg(blk + 5 * n + jt) : 0.0f;
      __syncthreads();
      const int cnt = min(kThreads, n - c0);
#pragma unroll
      for (int r = 0; r < kMaxRowTiles; ++r) {
        if (!hit[r]) continue;
        const long long gi =
            base + (long long)(blockIdx.x + r * G) * kRows + lrow;
        for (int c = lane; c < cnt; c += kSplit) {
          const float dx = sx[c] - xi[r];
          const float dy = sy[c] - yi[r];
          bool ok = ai[r] && sa[c] != 0.0f && (g_src + c0 + c) != gi;
          if (kCutoff) ok = ok && sq_norm_rn(dx, dy) <= a.c2;
          float fxk, fyk;
          Law::pair(dx, dy, ui[r], vi[r], svx[c], svy[c], ri[r], sr[c],
                    a.use_radius, ok, p, fxk, fyk);
          ax[r] += fxk;
          ay[r] += fyk;
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

#pragma unroll
  for (int r = 0; r < kMaxRowTiles; ++r) {
    const int t = blockIdx.x + r * G;
    if (t >= n_row_tiles) break;  // block-uniform
    __syncthreads();
    part_x[lrow][lane] = ax[r];
    part_y[lrow][lane] = ay[r];
    __syncthreads();
    const int i = t * kRows + lrow;
    if (lane == 0 && i < n) {
      float sx_sum = 0.0f, sy_sum = 0.0f;
      for (int s = 0; s < kSplit; ++s) {  // fixed order
        sx_sum += part_x[lrow][s];
        sy_sum += part_y[lrow][s];
      }
      a.fx[base + i] = sx_sum;
      a.fy[base + i] = sy_sum;
    }
  }
}

template <bool kCutoff, class Law>
int ring_launch(RingArgs a, void* stream) {
  auto kernel = ring_force_kernel<kCutoff, Law>;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const int n_row_tiles = (a.n_local + kRows - 1) / kRows;
  // every block of every device resident at once; at most kMaxRowTiles
  // row tiles per block
  const int resident = per_sm * sms / a.n_dev;
  const int g = min(n_row_tiles, resident);
  if (g < 1 || (long long)g * kMaxRowTiles < n_row_tiles)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel,
                                  dim3((unsigned)g, (unsigned)a.n_dev),
                                  dim3(kThreads), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of the ring over n_dev virtual devices of n_local agents each,
// on `stream`; returns cudaGetLastError() (non-zero: the launch was refused,
// for example cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// resident at once).
// law: a LawId, as for the sfm_pair_* entries (Helbing: ru, rv carry the
// rows' desired directions; rrad is not read).  rx .. ralive: every
// device's rows, device d's at [d * n_local, (d + 1) * n_local).  cols: each
// device's own column block as (n_dev, slot) floats, slot = 6 * n_local +
// 4 * n_col_tiles: the planes x, y, vx, vy, radius, alive (1 or 0) and then
// the (4, n_col_tiles) boxes of its 256-column tiles (read with cutoff only;
// n_col_tiles = ceil(n_local / 256)).  comm: (n_dev, 2, slot) floats of
// scratch; sync: 4 * n_dev + 1 ints, zero on entry (the fill and done
// counters, then the error word, which is non-zero after a spin overran).
// cutoff != 0 applies c2, the squared cutoff, per pair and per tile box.
int sfm_ring_force(int law, int n_dev, int n_local, const float* rx,
                   const float* ry, const float* ru, const float* rv,
                   const float* rrad, const uint8_t* ralive, const float* cols,
                   float* comm, int* sync, const float* prm, int use_radius,
                   int cutoff, float c2, float* fx, float* fy, void* stream) {
  if (n_dev < 1 || n_local < 0) return (int)cudaErrorInvalidValue;
  if (n_local == 0) return (int)cudaSuccess;
  RingArgs a;
  a.n_dev = n_dev;
  a.n_local = n_local;
  a.n_col_tiles = (n_local + kThreads - 1) / kThreads;
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
  a.done = sync + 2 * n_dev;
  a.err = sync + 4 * n_dev;
  a.prm = prm;
  a.use_radius = use_radius;
  a.c2 = c2;
  a.fx = fx;
  a.fy = fy;
  return with_any_law(law, [&](auto l) {
    using L = decltype(l);
    return cutoff ? ring_launch<true, L>(a, stream)
                  : ring_launch<false, L>(a, stream);
  });
}

}  // extern "C"
