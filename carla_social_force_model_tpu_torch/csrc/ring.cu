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
// D * (D - 1) block copies are small.  What the design does about it: the
// dense walk's inner loop (pair_laws.cuh rows_vs_chunk: R rows per thread
// in registers, 256-column tiles staged as float4 + float2 and
// read by broadcast, the block's eight warps sharing each tile, and
// with a cutoff the chunk culling and the ballot), each block keeping its
// rows' sums in registers across all D steps, so the forces are written
// once, at the end; with a cutoff a column tile is skipped when the
// block's box misses its box.  Blocks must all be resident (the spins), so
// the grid cannot split a row's columns over blocks as the dense walk
// does: a block holds 32 * R rows, so a launch takes up to 32 * R agents
// per resident block of the card.  It takes R = 1 where that grid fits and
// R = 2 or 4 where only a larger R fits (more rows per block, more
// registers, fewer resident blocks), and fails beyond.  Every R sums each
// row in the same order (each warp's chunk over the ring steps, tiles and
// columns, then the warps in order), so R never changes a result.  Data of the
// rotating block is read and written through L2 (__ldcg / __stcg): L1 is
// not coherent across SMs.  Copies across cards (peer pointers) are later
// work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_laws.cuh"

namespace {

// The dense walk's layout (pair_laws.cuh): R rows per thread, a block
// holds 32 * R rows of one device and its eight warps share each staged
// tile, one 32-column chunk each (PERF.md: 4, 8 and 16 warps measured; 16
// keep too few blocks resident for N = 10,000 under the power law and
// Helbing).  A launch takes the least R of kRingRows, 2 kRingRows and 4
// kRingRows whose grid is resident at once: R = 1 measured faster than R =
// 2, and a larger R takes more agents.  Every R keeps at least kRingMinBlocks
// blocks resident an SM (at most 80 registers a thread; without that bound
// R = 4 keeps 2 under the power law and the cutoff forms), so R = 4 takes
// 128 rows a block at 3 blocks an SM: 50,688 agents over all devices on
// 132 SMs.  The bound holds for R = 1 and 2 too: with a minimum of 1
// block for them, ptxas gave R = 1 96 registers and the ring 1.45x its
// time at N = 10,000 (PERF.md).
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

template <bool kCutoff, class Law, int kR>
__global__ void __launch_bounds__(kThreads, kRingMinBlocks)
ring_force_kernel(RingArgs a) {
  constexpr int kBlockRows = 32 * kR;
  __shared__ ColTile tile;
  __shared__ float part_x[kTileChunks][kBlockRows];
  __shared__ float part_y[kTileChunks][kBlockRows];
  __shared__ int s_ok;

  const typename Law::Prm p = Law::load(a.prm);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;  // and the chunk of each tile it walks
  const int d = blockIdx.y;
  const int D = a.n_dev;
  const int G = gridDim.x;
  const int n = a.n_local;
  const int right = (d + 1) % D;
  const int base = d * n;  // this device's first row
  const int i_blk = blockIdx.x * kBlockRows;

  // this block's rows, R per lane, in registers (every warp holds them all)
  RowSet<kR> rw;
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
  float bx0 = INFINITY, bx1 = -INFINITY, by0 = INFINITY, by1 = -INFINITY;
  if (kCutoff) {  // the block's box
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      bx0 = fminf(bx0, rw.box[r][0]);
      bx1 = fmaxf(bx1, rw.box[r][1]);
      by0 = fminf(by0, rw.box[r][2]);
      by1 = fmaxf(by1, rw.box[r][3]);
    }
  }

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
    const int g_src = src * n;
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
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    part_x[warp][lane + 32 * r] = rw.ax[r];
    part_y[warp][lane + 32 * r] = rw.ay[r];
  }
  __syncthreads();
  for (int row = tid; row < kBlockRows; row += kThreads) {
    const int i = i_blk + row;
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

// Launch the ring with R = kR rows per thread if every block of every
// device, one per 32 * R rows, can be resident at once; *fits says whether
// it could.
template <bool kCutoff, class Law, int kR>
cudaError_t ring_try(RingArgs a, int sms, void* stream, bool* fits) {
  auto kernel = ring_force_kernel<kCutoff, Law, kR>;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  const long long g = (a.n_local + 32 * kR - 1) / (32 * kR);
  *fits = e == cudaSuccess && (long long)per_sm * sms >= g * a.n_dev;
  if (!*fits) return e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel,
                                  dim3((unsigned)g, (unsigned)a.n_dev),
                                  dim3(kThreads), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kCutoff, class Law>
int ring_launch(RingArgs a, void* stream) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  // the least R whose grid fits
  bool fits = false;
  e = ring_try<kCutoff, Law, kRingRows>(a, sms, stream, &fits);
  if (!fits && e == cudaSuccess)
    e = ring_try<kCutoff, Law, 2 * kRingRows>(a, sms, stream, &fits);
  if (!fits && e == cudaSuccess)
    e = ring_try<kCutoff, Law, 4 * kRingRows>(a, sms, stream, &fits);
  if (!fits && e == cudaSuccess)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  return (int)e;
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
