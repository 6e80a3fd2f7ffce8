// Environment-force kernels for Hopper (sm_90a), with a plain C interface
// for ctypes (utils/cuda_build.py builds this file, ops/cuda_env.py binds
// it).  Their plain PyTorch versions are ops/forces.py env_exp_force and
// env_moussaid_force; the compacted forms' launch plan is ops/env_grid.py.
//
// What each function replaces (JAX package, ops/pallas_env.py):
//   env_force_kernel<false, kAllSections, kSampled> ("env_exp")  <-
//       _exp_kernel (:235) with _closest_sel (:82), _exp_tilework (:156)
//       and _tile_hit (:131): the border force and the space-repulsive
//       force, a * exp(-d/b) away from each segment's closest sampled point,
//       summed over the segments whose filter circle holds the pedestrian.
//   env_force_kernel<true, kAllSections, kSampled> ("env_moussaid")  <-
//       _moussaid_kernel (:268) with _moussaid_tilework (:180): the static
//       and dynamic obstacle forces, the Moussaid interaction against each
//       obstacle's closest point with the relative velocity v_ped -
//       v_obstacle.  The per-pair math is moussaid_pair of pair_forces.cuh,
//       the pair kernels' own.
//   env_force_kernel<false, kTable, kSampled> ("env_exp_compact")  <-
//       _exp_kernel_compact (:297), and env_force_kernel<true, kTable,
//       kSampled> ("env_moussaid_compact")  <- _moussaid_kernel_compact
//       (:327): the same terms over the surviving groups of sections of
//       each block only (the urban path's borders; parked cars under
//       env_compact).
//   env_force_kernel<false, kAllSections, kAnalytic> ("env_exp_analytic")
//       and <false, kTable, kAnalytic> ("env_exp_analytic_compact")  <-
//       _exp_kernel and _exp_kernel_compact with analytic=True, whose
//       _closest_seg (:97) takes each section's closest point ON its up to
//       M Douglas-Peucker segments (planes ax, ay, ux, uy, il2 of shape
//       (S, M)) instead of over its sampled points: the analytic border tier
//       (StepConfig.env_analytic).  The geometry is one template parameter,
//       so both scans share the walk, the block box test and the table
//       walk; the segment projection is closest_on_segment of
//       env_forces.cuh, rounded per operation like the sampled distance.
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

#include "block_box.cuh"
#include "env_forces.cuh"

namespace {

constexpr int kEnvPeds = kBoxPeds;  // pedestrians per block, one per thread
constexpr int kEnvStage = 1024;     // points of a row staged per piece
// segments of an analytic row staged per piece (five planes in the same
// shared memory as the sampled pieces' two)
constexpr int kGeomStage = 2 * kEnvStage / 5;

// Which sections a block walks: all of them (the dense form), or the
// groups its survivor-table row lists (the compacted form).
enum Walk { kAllSections, kTable };

// What a section row holds: K sampled points (ptx, pty), or M line segments
// (ptx = ax, pty = ay, pux, puy, pil2).
enum Geom { kSampled, kAnalytic };

// kMoussaid = false: the exp form (a, b by value; pvx, pvy, ov, prm unused).
// kMoussaid = true: the Moussaid form (ov = (S, 2) obstacle velocities,
// prm = the six Moussaid parameters on the device).
// kWalk = kTable: surv (blocks, max_surv) ascending group indices, counts
// (blocks,) hits per block, gs sections per group; unused for kAllSections.
// kGeom = kAnalytic: k = M segments per row, pux/puy/pil2 the segment
// vectors and 1/|u|^2; unused (null) for kSampled.
template <bool kMoussaid, Walk kWalk, Geom kGeom>
__global__ void __launch_bounds__(kEnvPeds)
env_force_kernel(const float* __restrict__ px_, const float* __restrict__ py_,
                 const float* __restrict__ pvx_, const float* __restrict__ pvy_,
                 const float* __restrict__ prad_,
                 const uint8_t* __restrict__ alive_,
                 const float* __restrict__ ptx, const float* __restrict__ pty,
                 const float* __restrict__ pux, const float* __restrict__ puy,
                 const float* __restrict__ pil2,
                 int k, const float* __restrict__ cx,
                 const float* __restrict__ cy, const float* __restrict__ r2,
                 const float* __restrict__ ov, int s_count,
                 const float* __restrict__ prm, float a, float b,
                 int use_radius, int n, const int* __restrict__ surv,
                 const int* __restrict__ counts, int max_surv, int gs,
                 float* __restrict__ fx, float* __restrict__ fy) {
  __shared__ float stage[2 * kEnvStage];
  float* const sx = stage;
  float* const sy = stage + kEnvStage;

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

    const size_t row = (size_t)s * k;
    float best = INFINITY, bx = 0.0f, by = 0.0f;
    if constexpr (kGeom == kSampled) {
      for (int c0 = 0; c0 < k; c0 += kEnvStage) {
        const int cnt = min(kEnvStage, k - c0);
        __syncthreads();  // the previous piece is consumed
        for (int j = threadIdx.x; j < cnt; j += kEnvPeds) {
          sx[j] = ptx[row + c0 + j];
          sy[j] = pty[row + c0 + j];
        }
        __syncthreads();
        if (live) {
#pragma unroll 4
          for (int j = 0; j < cnt; ++j) closest_update(sx[j], sy[j], px, py, best, bx, by);
        }
      }
    } else {
      float* const sax = stage;
      float* const say = stage + kGeomStage;
      float* const sux = stage + 2 * kGeomStage;
      float* const suy = stage + 3 * kGeomStage;
      float* const sil = stage + 4 * kGeomStage;
      for (int c0 = 0; c0 < k; c0 += kGeomStage) {
        const int cnt = min(kGeomStage, k - c0);
        __syncthreads();  // the previous piece is consumed
        for (int j = threadIdx.x; j < cnt; j += kEnvPeds) {
          sax[j] = ptx[row + c0 + j];
          say[j] = pty[row + c0 + j];
          sux[j] = pux[row + c0 + j];
          suy[j] = puy[row + c0 + j];
          sil[j] = pil2[row + c0 + j];
        }
        __syncthreads();
        if (live) {
          for (int j = 0; j < cnt; ++j)
            closest_seg_update(sax[j], say[j], sux[j], suy[j], sil[j], px, py, best, bx, by);
        }
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
// The _analytic entries take the segment planes ax, ay, ux, uy, il2
// (s_count, m) in place of the point rows.
int sfm_env_exp(const float* px, const float* py, const float* prad,
                const uint8_t* alive, const float* ptx, const float* pty,
                int k, const float* cx, const float* cy, const float* r2,
                int s_count, float a, float b, int use_radius, int n,
                float* fx, float* fy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kEnvPeds - 1) / kEnvPeds;
  env_force_kernel<false, kAllSections, kSampled>
      <<<blocks, kEnvPeds, 0, (cudaStream_t)stream>>>(
          px, py, nullptr, nullptr, prad, alive, ptx, pty, nullptr, nullptr,
          nullptr, k, cx, cy, r2, nullptr, s_count, nullptr, a, b, use_radius,
          n, nullptr, nullptr, 0, 1, fx, fy);
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
  env_force_kernel<true, kAllSections, kSampled>
      <<<blocks, kEnvPeds, 0, (cudaStream_t)stream>>>(
          px, py, pvx, pvy, prad, alive, ptx, pty, nullptr, nullptr, nullptr,
          k, cx, cy, r2, ov, s_count, prm, 0.0f, 1.0f, use_radius, n, nullptr,
          nullptr, 0, 1, fx, fy);
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
  env_force_kernel<false, kTable, kSampled>
      <<<blocks, kEnvPeds, 0, (cudaStream_t)stream>>>(
          px, py, nullptr, nullptr, prad, alive, ptx, pty, nullptr, nullptr,
          nullptr, k, cx, cy, r2, nullptr, s_count, nullptr, a, b, use_radius,
          n, surv, counts, max_surv, gs, fx, fy);
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
  env_force_kernel<true, kTable, kSampled>
      <<<blocks, kEnvPeds, 0, (cudaStream_t)stream>>>(
          px, py, pvx, pvy, prad, alive, ptx, pty, nullptr, nullptr, nullptr,
          k, cx, cy, r2, ov, s_count, prm, 0.0f, 1.0f, use_radius, n, surv,
          counts, max_surv, gs, fx, fy);
  return (int)cudaGetLastError();
}

int sfm_env_exp_analytic(const float* px, const float* py, const float* prad,
                         const uint8_t* alive, const float* ax,
                         const float* ay, const float* ux, const float* uy,
                         const float* il2, int m, const float* cx,
                         const float* cy, const float* r2, int s_count,
                         float a, float b, int use_radius, int n, float* fx,
                         float* fy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kEnvPeds - 1) / kEnvPeds;
  env_force_kernel<false, kAllSections, kAnalytic>
      <<<blocks, kEnvPeds, 0, (cudaStream_t)stream>>>(
          px, py, nullptr, nullptr, prad, alive, ax, ay, ux, uy, il2, m, cx,
          cy, r2, nullptr, s_count, nullptr, a, b, use_radius, n, nullptr,
          nullptr, 0, 1, fx, fy);
  return (int)cudaGetLastError();
}

int sfm_env_exp_analytic_compact(const float* px, const float* py,
                                 const float* prad, const uint8_t* alive,
                                 const float* ax, const float* ay,
                                 const float* ux, const float* uy,
                                 const float* il2, int m, const float* cx,
                                 const float* cy, const float* r2,
                                 int s_count, float a, float b,
                                 int use_radius, int n, const int* surv,
                                 const int* counts, int max_surv, int gs,
                                 float* fx, float* fy, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kEnvPeds - 1) / kEnvPeds;
  env_force_kernel<false, kTable, kAnalytic>
      <<<blocks, kEnvPeds, 0, (cudaStream_t)stream>>>(
          px, py, nullptr, nullptr, prad, alive, ax, ay, ux, uy, il2, m, cx,
          cy, r2, nullptr, s_count, nullptr, a, b, use_radius, n, surv, counts,
          max_surv, gs, fx, fy);
  return (int)cudaGetLastError();
}

}  // extern "C"
