// Environment-force kernels for Hopper (sm_90a), with a plain C interface
// for ctypes (utils/cuda_build.py builds this file, ops/cuda_env.py binds
// it).  Their plain PyTorch versions are ops/forces.py env_exp_force and
// env_moussaid_force; the compacted forms' launch plan is ops/env_grid.py.
//
// What each function replaces (JAX package, ops/pallas_env.py):
//   env_force_kernel<false, kAllSections> ("env_exp")  <- _exp_kernel (:235)
//       with _closest_sel (:82), _exp_tilework (:156) and _tile_hit (:131):
//       the border force and the space-repulsive force, a * exp(-d/b) away
//       from each segment's closest sampled point, summed over the segments
//       whose filter circle holds the pedestrian.
//   env_force_kernel<true, kAllSections> ("env_moussaid")  <- _moussaid_kernel
//       (:268) with _moussaid_tilework (:180): the static and dynamic
//       obstacle forces, the Moussaid interaction against each obstacle's
//       closest point with the relative velocity v_ped - v_obstacle.  The
//       per-pair math is moussaid_pair of pair_forces.cuh, the pair
//       kernels' own.
//   env_force_kernel<false, kTable> ("env_exp_compact")  <-
//       _exp_kernel_compact (:297), and env_force_kernel<true, kTable>
//       ("env_moussaid_compact")  <- _moussaid_kernel_compact (:327): the
//       same terms over the surviving groups of sections of each block only
//       (the urban path's borders; parked cars under env_compact).
// The analytic closest point (_closest_seg) is not on these paths.
//
// What bounds them on this card.  The work is data-dependent: per
// (segment, pedestrian) pair inside the segment's filter circle, a scan of
// the segment's K points (about 5 flops each) and one force term.  At
// N = 10,000 in BASELINE config #3 that is of the order of 1e5 in-filter
// pairs times a few hundred points: a few times 1e8 flops, a few
// microseconds at the card's f32 rate; the inputs are under 1 MB.  So the
// bound is the operations.  What decides the time is the work the segment
// skip cannot remove (a block scans all of a touched segment for all of
// its pedestrians) and latency: at N = 10,000 the 79 blocks of 4 warps
// leave one warp per scheduler, so the scan runs at its dependent-chain
// latency, far above the bound (PERF.md).
//
// What the design does about that.  One block is 128 consecutive
// pedestrians of the Hilbert-sorted order (ops/cuda_env.py sorts once per
// step), one thread per pedestrian.  The block reduces its alive
// pedestrians' bounding box and walks the segments in ascending order;
// a segment whose filter circle misses the box is skipped by the whole
// block (the TPU's _tile_hit at segment granularity).  The skip is exact:
// the box test is a lower bound of every pedestrian's own filter test,
// computed with the same rounding.  A touched segment's points are staged
// through shared memory in pieces of 1,024 (8 KB for x and y), so any row
// length works, and each thread scans them from shared memory (all lanes
// read the same word: a broadcast).  The force accumulates in registers in
// ascending segment order: deterministic, no atomics.  Sorting is what
// makes the skip work: 128 pedestrians spread over a 200 m arena would
// touch nearly every section.  Faster forms (several threads per
// pedestrian, skipping the padding of a row) are later work.
//
// The compacted walk (kTable).  Block b reads counts[b].  Up to max_surv
// hits it walks its table row surv[b, 0..counts[b]) (ascending group
// indices) and, in each group, sections g*gs .. g*gs+gs-1 with the same box
// test; above it (a block that overflowed its row) it walks every section
// as the dense form does, decided on the device: no host sync, no second
// grid.  The table (ops/env_grid.py) is built from the same sorted planes,
// alive mask and squared radii with the same per-operation rounding, so it
// lists every group holding a section the box test accepts: the compacted
// form visits exactly the dense form's sections in the same order and its
// output equals the dense kernel's bitwise.  On this card it saves only the
// skipped sections' three-float box tests; the scans of touched sections
// are the same work in both forms.
//
// Where the TPU design does not carry over.  The TPU grid walked
// (ped tile, point tile) pairs in order and accumulated into one resident
// output block; here the segment loop runs inside the block, so nothing is
// carried between blocks.  The TPU's compacted grid summed a tile of gs
// sections at a time and equalled its dense grid only up to f32 grouping;
// here every form sums section by section.  The TPU staged dead
// pedestrians at a far sentinel; here `alive` is read, and a dead
// pedestrian's output is exactly 0.  The TPU chose its closest point with
// an iota-min over a tile; here a sequential strict-< scan gives the same
// first occurrence.

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_forces.cuh"

namespace {

constexpr int kEnvPeds = 128;     // pedestrians per block, one per thread
constexpr int kEnvWarps = kEnvPeds / 32;
constexpr int kEnvStage = 1024;   // points of a row staged per piece

struct Box {
  float minx, maxx, miny, maxy;
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Bounding box of the block's alive pedestrians; a block with none gets
// the inverted infinite box, which no segment touches.
__device__ Box block_box(float x, float y, bool live) {
  __shared__ float part[4][kEnvWarps];
  const float x_lo = warp_min(live ? x : INFINITY);
  const float x_hi = warp_max(live ? x : -INFINITY);
  const float y_lo = warp_min(live ? y : INFINITY);
  const float y_hi = warp_max(live ? y : -INFINITY);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part[0][warp] = x_lo;
    part[1][warp] = x_hi;
    part[2][warp] = y_lo;
    part[3][warp] = y_hi;
  }
  __syncthreads();
  Box box{INFINITY, -INFINITY, INFINITY, -INFINITY};
#pragma unroll
  for (int w = 0; w < kEnvWarps; ++w) {
    box.minx = fminf(box.minx, part[0][w]);
    box.maxx = fmaxf(box.maxx, part[1][w]);
    box.miny = fminf(box.miny, part[2][w]);
    box.maxy = fmaxf(box.maxy, part[3][w]);
  }
  return box;
}

// Does the filter circle (cx, cy, r2) touch the box?  Block-uniform.  Each
// gap is at most the matching |center - ped| of any pedestrian in the box
// (rounding is monotone), so a pedestrian that passes in_filter always
// lies in a touched segment.
__device__ __forceinline__ bool touches(float cx, float cy, float r2,
                                        const Box& box) {
  const float gx = fmaxf(fmaxf(cx - box.maxx, box.minx - cx), 0.0f);
  const float gy = fmaxf(fmaxf(cy - box.maxy, box.miny - cy), 0.0f);
  return sq_norm_rn(gx, gy) <= r2;
}

// Which sections a block walks: all of them (the dense form), or the
// groups its survivor-table row lists (the compacted form).
enum Walk { kAllSections, kTable };

// kMoussaid = false: the exp form (a, b by value; pvx, pvy, ov, prm unused).
// kMoussaid = true: the Moussaid form (ov = (S, 2) obstacle velocities,
// prm = the six Moussaid parameters on the device).
// kWalk = kTable: surv (blocks, max_surv) ascending group indices, counts
// (blocks,) hits per block, gs sections per group; unused for kAllSections.
template <bool kMoussaid, Walk kWalk>
__global__ void __launch_bounds__(kEnvPeds)
env_force_kernel(const float* __restrict__ px_, const float* __restrict__ py_,
                 const float* __restrict__ pvx_, const float* __restrict__ pvy_,
                 const float* __restrict__ prad_,
                 const uint8_t* __restrict__ alive_,
                 const float* __restrict__ ptx, const float* __restrict__ pty,
                 int k, const float* __restrict__ cx,
                 const float* __restrict__ cy, const float* __restrict__ r2,
                 const float* __restrict__ ov, int s_count,
                 const float* __restrict__ prm, float a, float b,
                 int use_radius, int n, const int* __restrict__ surv,
                 const int* __restrict__ counts, int max_surv, int gs,
                 float* __restrict__ fx, float* __restrict__ fy) {
  __shared__ float sx[kEnvStage], sy[kEnvStage];

  const int i = blockIdx.x * kEnvPeds + threadIdx.x;
  const bool in = i < n;
  const bool live = in && alive_[i] != 0;
  const float px = in ? px_[i] : 0.0f;
  const float py = in ? py_[i] : 0.0f;
  const float rsub = (in && use_radius) ? prad_[i] : 0.0f;
  float pvx = 0.0f, pvy = 0.0f;
  MoussaidPrm p{};
  if (kMoussaid) {
    pvx = in ? pvx_[i] : 0.0f;
    pvy = in ? pvy_[i] : 0.0f;
    p.lam = prm[0];
    p.A = prm[1];
    p.gamma = prm[2];
    p.n = prm[3];
    p.n_prime = prm[4];
    p.eps = prm[5];
  }
  const Box box = block_box(px, py, live);

  float ax = 0.0f, ay = 0.0f;
  // one section: skipped by the whole block unless its circle touches the
  // box (block-uniform, so the barriers inside are reached by all threads)
  auto section = [&](int s) {
    const float scx = cx[s], scy = cy[s], sr2 = r2[s];
    if (!touches(scx, scy, sr2, box)) return;

    const float* row_x = ptx + (size_t)s * k;
    const float* row_y = pty + (size_t)s * k;
    float best = INFINITY, bx = 0.0f, by = 0.0f;
    for (int c0 = 0; c0 < k; c0 += kEnvStage) {
      const int cnt = min(kEnvStage, k - c0);
      __syncthreads();  // the previous piece is consumed
      for (int j = threadIdx.x; j < cnt; j += kEnvPeds) {
        sx[j] = row_x[c0 + j];
        sy[j] = row_y[c0 + j];
      }
      __syncthreads();
      if (live) {
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) closest_update(sx[j], sy[j], px, py, best, bx, by);
      }
    }
    if (!live) return;

    const bool ok = in_filter(scx, scy, sr2, px, py) && best < kPadDist2;
    float fxs, fys;
    if (kMoussaid) {
      moussaid_pair(bx - px, by - py, pvx - ov[2 * s], pvy - ov[2 * s + 1],
                    rsub, ok, p, fxs, fys);
    } else {
      exp_term(px, py, bx, by, rsub, a, b, ok, fxs, fys);
    }
    ax += fxs;
    ay += fys;
  };

  const int hits = kWalk == kTable ? counts[blockIdx.x] : 0;
  if (kWalk == kTable && hits <= max_surv) {
    const int* row = surv + (size_t)blockIdx.x * max_surv;
    for (int t = 0; t < hits; ++t) {
      const int g = row[t];
      const int end = min(s_count, (g + 1) * gs);
      for (int s = g * gs; s < end; ++s) section(s);
    }
  } else {
    for (int s = 0; s < s_count; ++s) section(s);
  }
  if (in) {
    fx[i] = live ? ax : 0.0f;
    fy[i] = live ? ay : 0.0f;
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError(): non-zero
// means the launch was refused.  Pedestrian planes (n,) in the sorted order;
// ptx/pty (s_count, k) row-major, PAD_COORD-padded; cx/cy/r2 (s_count,) with
// r2 = -1 for segments that must not act.  Every output row is written.
// The _compact entries also take the survivor table surv (ceil(n/128),
// max_surv) int32, its counts (ceil(n/128),) and gs sections per group.
int sfm_env_exp(const float* px, const float* py, const float* prad,
                const uint8_t* alive, const float* ptx, const float* pty,
                int k, const float* cx, const float* cy, const float* r2,
                int s_count, float a, float b, int use_radius, int n,
                float* fx, float* fy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kEnvPeds - 1) / kEnvPeds;
  env_force_kernel<false, kAllSections>
      <<<blocks, kEnvPeds, 0, (cudaStream_t)stream>>>(
          px, py, nullptr, nullptr, prad, alive, ptx, pty, k, cx, cy, r2,
          nullptr, s_count, nullptr, a, b, use_radius, n, nullptr, nullptr,
          0, 1, fx, fy);
  return (int)cudaGetLastError();
}

int sfm_env_moussaid(const float* px, const float* py, const float* pvx,
                     const float* pvy, const float* prad, const uint8_t* alive,
                     const float* ptx, const float* pty, int k,
                     const float* cx, const float* cy, const float* r2,
                     const float* ov, int s_count, const float* prm,
                     int use_radius, int n, float* fx, float* fy,
                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kEnvPeds - 1) / kEnvPeds;
  env_force_kernel<true, kAllSections>
      <<<blocks, kEnvPeds, 0, (cudaStream_t)stream>>>(
          px, py, pvx, pvy, prad, alive, ptx, pty, k, cx, cy, r2, ov,
          s_count, prm, 0.0f, 1.0f, use_radius, n, nullptr, nullptr, 0, 1,
          fx, fy);
  return (int)cudaGetLastError();
}

int sfm_env_exp_compact(const float* px, const float* py, const float* prad,
                        const uint8_t* alive, const float* ptx,
                        const float* pty, int k, const float* cx,
                        const float* cy, const float* r2, int s_count,
                        float a, float b, int use_radius, int n,
                        const int* surv, const int* counts, int max_surv,
                        int gs, float* fx, float* fy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kEnvPeds - 1) / kEnvPeds;
  env_force_kernel<false, kTable>
      <<<blocks, kEnvPeds, 0, (cudaStream_t)stream>>>(
          px, py, nullptr, nullptr, prad, alive, ptx, pty, k, cx, cy, r2,
          nullptr, s_count, nullptr, a, b, use_radius, n, surv, counts,
          max_surv, gs, fx, fy);
  return (int)cudaGetLastError();
}

int sfm_env_moussaid_compact(const float* px, const float* py,
                             const float* pvx, const float* pvy,
                             const float* prad, const uint8_t* alive,
                             const float* ptx, const float* pty, int k,
                             const float* cx, const float* cy,
                             const float* r2, const float* ov, int s_count,
                             const float* prm, int use_radius, int n,
                             const int* surv, const int* counts, int max_surv,
                             int gs, float* fx, float* fy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kEnvPeds - 1) / kEnvPeds;
  env_force_kernel<true, kTable>
      <<<blocks, kEnvPeds, 0, (cudaStream_t)stream>>>(
          px, py, pvx, pvy, prad, alive, ptx, pty, k, cx, cy, r2, ov,
          s_count, prm, 0.0f, 1.0f, use_radius, n, surv, counts, max_surv,
          gs, fx, fy);
  return (int)cudaGetLastError();
}

}  // extern "C"
