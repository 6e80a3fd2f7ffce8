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
// (section, pedestrian) pair inside the section's filter circle, a scan of
// the section's real points (5 f32 operations each; PAD_COORD slots are
// not needed) and one force term.  At N = 10,000 in BASELINE config #3
// that is about 1e5 in-filter pairs times 285 points: about 1e8
// operations, a few microseconds at the card's f32 rate; the inputs are
// under 1 MB.  So the bound is the operations.  The issue rate sets a
// floor above it: the scan's loop issues about a dozen instructions per
// point (the distance, the strict-< select of three values, the shared
// loads, the loop), which tools/sass_census.py counts; PERF.md carries
// both beside the times.  What keeps the time above that floor is the
// scan of sections the box test cannot skip (a block scans every touched
// section for all of its pedestrians) and the latency of its dependent
// chain where few warps share a scheduler.
//
// What the design does about that.  A block is 32 consecutive pedestrians
// of the Hilbert-sorted order (ops/cuda_env.py sorts once per step) and
// L = kEnvLanes threads per pedestrian (256 threads): 313 blocks at
// N = 10,000, eight warps each, where one thread per pedestrian gave 79
// blocks of four warps and left 53 of the 132 SMs idle.  The block reduces
// its alive pedestrians' bounding box and walks the sections in ascending
// order; a section whose filter circle misses the box is skipped by the
// whole block (the TPU's _tile_hit at section granularity; exact: the box
// test is a lower bound of every pedestrian's own filter test, computed
// with the same rounding).  A touched section's real points (lens[s] of
// them, from the point set's per-row lengths; all of the row when lens is
// null) are staged through shared memory in pieces of 1,024 (8 KB of (x,
// y) pairs), so any row length works.  The L lanes of a pedestrian scan
// every L-th point of a piece, each keeping its own strict-< running best
// and that point's slot; then a shuffle merge takes the least (distance,
// slot) -- the lower slot on a tie -- which is exactly the point the
// sequential first-occurrence scan picks (the reference's np.argmin).
// Padding is never nearer than a real point, and a row without one keeps
// best = inf, masked like the padding's 1e16 by best < kPadDist2.  The
// force terms are deferred: lane q of a pedestrian keeps the closest
// point of the q-th touched section of a batch of L, so one pass of the
// term code evaluates L sections, and rows of at most kEnvShortRow slots
// (the analytic geometry's M) are not staged at all: lane q scans the
// q-th section's whole row from global memory in order, with no barrier
// and no merge, because a section's fixed cost (two barriers, the merge)
// outweighs such a scan; and the batch's terms are added to the
// pedestrian's sum in ascending section order by shuffles -- the same
// additions in the same order as a section-by-section sum, so the result
// is deterministic (no atomics).
//
// The compacted walk (kTable).  A survivor-table row covers 128 sorted
// pedestrians (ops/env_grid.py ENV_BLOCK), four blocks of 32; block b
// reads counts[b / 4].  Up to max_surv hits it walks its table row
// (ascending group indices) and, in each group, sections g*gs ..
// g*gs+gs-1 with its own 32-pedestrian box test; above it (an overflowing
// row) it walks every section as the dense form does, decided on the
// device: no host sync, no second grid.  The table is built from the same
// sorted planes, alive mask and squared radii with the same per-operation
// rounding, over the 128-pedestrian box that holds the block's box, so it
// lists every group holding a section the block's test accepts: the
// compacted form visits exactly the dense form's sections in the same
// order, batches them alike, and its output equals the dense kernel's
// bitwise.  It saves only the skipped sections' box tests; the scans of
// touched sections are the same work in both forms.
//
// Batches (ensembles and parameter sweeps).  Under the JAX package's vmap
// every environment kernel gains a leading batch axis on the pedestrian
// planes, the swept parameters and the survivor table (sweeps.py:81-84;
// pallas_env.py:662 builds each row's table over its own sorted crowd),
// while the geometry stays shared.  Here every walk and geometry takes B
// crowds in one launch (env_force_batched_kernel<kMoussaid, kWalk, kGeom>;
// sfm_env_exp_batched, sfm_env_moussaid_batched, their _compact_batched
// forms and sfm_env_exp_analytic_batched, _analytic_compact_batched): the
// grid's y index is the crowd, whose sorted planes and outputs lie at
// blockIdx.y * n, its parameters (exp: a, b; Moussaid: the six) at
// blockIdx.y * prm_stride, its squared filter radii at blockIdx.y *
// r2_stride (0: shared; a swept perception threshold gives each crowd its
// own) and its table rows at blockIdx.y * ceil(n / 128); every crowd reads
// the one set of point rows or segment planes.  A crowd whose table row
// overflows walks every section for that row's blocks, as the unbatched
// kernel does (the TPU fell back to its whole dense grid by lax.cond; the
// values are the same).  The batched kernel hands its crowd's pointers to
// the walk body the unbatched kernel runs (env_walk), so row b equals the
// unbatched launch on row b bitwise, and the unbatched kernels compile
// without a batch offset (offsets read from blockIdx.y inside the body
// cost 30% on env_exp_analytic).
//
// Per-crowd geometry (a batch of fleets).  Under the JAX package's vmap
// each row of an ensemble or sweep carries its own AutopilotState, so each
// row's vehicles, and the point set fused_environment_terms builds from
// them (pallas_env.py:545-550), are batched: _moussaid_kernel (:268) and
// _moussaid_kernel_compact (:327) then run with per-row points, circles and
// obstacle velocities.  env_force_percrowd_kernel<kWalk> is a second
// __global__ over the same walk body: it hands env_walk crowd blockIdx.y's
// point rows (at blockIdx.y * s_count * k), centers, lengths and obstacle
// velocities (at blockIdx.y * s_count) besides everything the batched
// kernel hands it (sfm_env_moussaid_percrowd and
// sfm_env_moussaid_compact_percrowd; the compacted form's table was built
// from each crowd's own circles).  Row b equals the unbatched launch on
// crowd b's own set bitwise.  Crowd strides in env_force_batched_kernel
// itself, 0 for the shared sets, cost its shared forms 9-41% (PERF.md
// row 8a-p), so the shared forms keep their kernel.
//
// Where the TPU design does not carry over.  The TPU grid walked
// (ped tile, point tile) pairs in order and accumulated into one resident
// output block; here the section loop runs inside the block, so nothing is
// carried between blocks.  The TPU's compacted grid summed a tile of gs
// sections at a time and equalled its dense grid only up to f32 grouping;
// here every form sums section by section.  The TPU staged dead
// pedestrians at a far sentinel; here `alive` is read, and a dead
// pedestrian's output is exactly 0.  The TPU chose its closest point with
// an iota-min over a tile; here the split scan's merge by (distance, slot)
// gives the same first occurrence.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_box.cuh"
#include "env_forces.cuh"

namespace {

// L: lanes per pedestrian (a divisor of 32; PERF.md: L = 4, 8 and 16
// measured)
constexpr int kEnvLanes = 8;
constexpr int kEnvPeds = 32;                        // pedestrians per block
constexpr int kEnvThreads = kEnvPeds * kEnvLanes;   // threads per block
// pedestrians per survivor-table row (ops/env_grid.py ENV_BLOCK)
constexpr int kEnvTableRow = 128;
constexpr int kEnvTableBlocks = kEnvTableRow / kEnvPeds;
constexpr int kEnvStage = 1024;     // points of a row staged per piece
// segments of an analytic row staged per piece (five planes in the same
// shared memory as the sampled pieces' two)
constexpr int kGeomStage = 2 * kEnvStage / 5;
// rows of at most this many slots (the analytic geometry's M segments)
// skip the staging and the split scan: lane q of a pedestrian scans the
// whole row of the q-th section of a batch itself
constexpr int kEnvShortRow = 16;
static_assert(32 % kEnvLanes == 0, "a pedestrian's lanes lie in one warp");
static_assert(kEnvTableRow % kEnvPeds == 0, "blocks tile a table row");

// Which sections a block walks: all of them (the dense form), or the
// groups its survivor-table row lists (the compacted form).
enum Walk { kAllSections, kTable };

// What a section row holds: K sampled points (ptx, pty), or M line segments
// (ptx = ax, pty = ay, pux, puy, pil2).
enum Geom { kSampled, kAnalytic };

// kMoussaid = false: the exp form (a, b by value; pvx, pvy, ov, prm unused).
// kMoussaid = true: the Moussaid form (ov = (S, 2) obstacle velocities,
// prm = the six Moussaid parameters on the device).
// kWalk = kTable: surv (table rows, max_surv) ascending group indices,
// counts (table rows,) hits per row, gs sections per group; unused for
// kAllSections.
// kGeom = kAnalytic: k = M segments per row, pux/puy/pil2 the segment
// vectors and 1/|u|^2; unused (null) for kSampled.
// lens: the real points (segments) of each row, all before its padding;
// null: every slot of every row.
// The walk body: env_force_kernel runs it on its arguments, the batched
// kernel on its crowd's pointers.
template <bool kMoussaid, Walk kWalk, Geom kGeom>
__device__ __forceinline__ void env_walk(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const float* __restrict__ pvx_, const float* __restrict__ pvy_,
    const float* __restrict__ prad_, const uint8_t* __restrict__ alive_,
    const float* __restrict__ ptx, const float* __restrict__ pty,
    const float* __restrict__ pux, const float* __restrict__ puy,
    const float* __restrict__ pil2, int k, const int* __restrict__ lens,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ r2, const float* __restrict__ ov, int s_count,
    const float* __restrict__ prm, float a, float b, int use_radius, int n,
    const int* __restrict__ surv, const int* __restrict__ counts,
    int max_surv, int gs, float* __restrict__ fx, float* __restrict__ fy) {
  __shared__ __align__(16) float stage[2 * kEnvStage];
  constexpr unsigned kAll = 0xffffffffu;

  const int lane = threadIdx.x % kEnvLanes;  // this pedestrian's lane
  const int i = blockIdx.x * kEnvPeds + threadIdx.x / kEnvLanes;
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
  const Box box = block_box<kEnvThreads>(px, py, live);

  float ax = 0.0f, ay = 0.0f;
  // the deferred batch: nb touched sections so far (block-uniform); lane q
  // holds the q-th one's section and closest point
  int nb = 0, q_s = 0;
  float q_best = INFINITY, q_bx = 0.0f, q_by = 0.0f;

  // short rows: no staging, no barrier, no merge (block-uniform)
  const bool short_rows = k <= kEnvShortRow;

  // the batch's force terms, one section per lane, added to the sum in
  // ascending section order
  auto flush = [&]() {
    float tx = 0.0f, ty = 0.0f;
    if (lane < nb && live) {
      if (short_rows) {  // this lane's section: the whole row, in order
        const int len = lens != nullptr ? min(lens[q_s], k) : k;
        const size_t row = (size_t)q_s * k;
        float best = INFINITY, bx = 0.0f, by = 0.0f;
        int bj = INT_MAX;
        for (int j = 0; j < len; ++j) {
          if constexpr (kGeom == kSampled) {
            closest_update_at(ptx[row + j], pty[row + j], px, py, j, best,
                              bj, bx, by);
          } else {
            closest_seg_update(ptx[row + j], pty[row + j], pux[row + j],
                               puy[row + j], pil2[row + j], px, py, j, best,
                               bj, bx, by);
          }
        }
        q_best = best;
        q_bx = bx;
        q_by = by;
      }
      const bool ok = in_filter(cx[q_s], cy[q_s], r2[q_s], px, py) &&
                      q_best < kPadDist2;
      if (kMoussaid) {
        moussaid_pair(q_bx - px, q_by - py, pvx - ov[2 * q_s],
                      pvy - ov[2 * q_s + 1], rsub, ok, p, tx, ty);
      } else {
        exp_term(px, py, q_bx, q_by, rsub, a, b, ok, tx, ty);
      }
    }
    for (int q = 0; q < nb; ++q) {
      ax += __shfl_sync(kAll, tx, q, kEnvLanes);
      ay += __shfl_sync(kAll, ty, q, kEnvLanes);
    }
    nb = 0;
  };

  // one section: skipped by the whole block unless its circle touches the
  // box (block-uniform, so the barriers and shuffles inside are reached by
  // all threads)
  auto section = [&](int s) {
    if (!touches(cx[s], cy[s], r2[s], box)) return;
    if (short_rows) {  // scanned in flush, one section per lane
      if (lane == nb) q_s = s;
      if (++nb == kEnvLanes) flush();
      return;
    }
    const int len = lens != nullptr ? min(lens[s], k) : k;
    const size_t row = (size_t)s * k;
    float best = INFINITY, bx = 0.0f, by = 0.0f;
    int bj = INT_MAX;
    if constexpr (kGeom == kSampled) {
      // (x, y) pairs side by side: one 8-byte shared load per point
      float2* const sxy = reinterpret_cast<float2*>(stage);
      for (int c0 = 0; c0 < len; c0 += kEnvStage) {
        const int cnt = min(kEnvStage, len - c0);
        __syncthreads();  // the previous piece is consumed
        for (int j = threadIdx.x; j < cnt; j += kEnvThreads)
          sxy[j] = make_float2(ptx[row + c0 + j], pty[row + c0 + j]);
        __syncthreads();
        if (live) {
#pragma unroll 4
          for (int j = lane; j < cnt; j += kEnvLanes) {
            const float2 pt = sxy[j];
            closest_update_at(pt.x, pt.y, px, py, c0 + j, best, bj, bx, by);
          }
        }
      }
    } else {
      float* const sax = stage;
      float* const say = stage + kGeomStage;
      float* const sux = stage + 2 * kGeomStage;
      float* const suy = stage + 3 * kGeomStage;
      float* const sil = stage + 4 * kGeomStage;
      for (int c0 = 0; c0 < len; c0 += kGeomStage) {
        const int cnt = min(kGeomStage, len - c0);
        __syncthreads();  // the previous piece is consumed
        for (int j = threadIdx.x; j < cnt; j += kEnvThreads) {
          sax[j] = ptx[row + c0 + j];
          say[j] = pty[row + c0 + j];
          sux[j] = pux[row + c0 + j];
          suy[j] = puy[row + c0 + j];
          sil[j] = pil2[row + c0 + j];
        }
        __syncthreads();
        if (live) {
          for (int j = lane; j < cnt; j += kEnvLanes)
            closest_seg_update(sax[j], say[j], sux[j], suy[j], sil[j], px,
                               py, c0 + j, best, bj, bx, by);
        }
      }
    }
    // the lanes' merge: the least (distance, slot), so a tie goes to the
    // earlier slot, as in one ascending strict-< scan
#pragma unroll
    for (int o = kEnvLanes / 2; o > 0; o >>= 1) {
      const float o_best = __shfl_xor_sync(kAll, best, o);
      const int o_bj = __shfl_xor_sync(kAll, bj, o);
      const float o_bx = __shfl_xor_sync(kAll, bx, o);
      const float o_by = __shfl_xor_sync(kAll, by, o);
      if (o_best < best || (o_best == best && o_bj < bj)) {
        best = o_best;
        bj = o_bj;
        bx = o_bx;
        by = o_by;
      }
    }
    if (lane == nb) {
      q_s = s;
      q_best = best;
      q_bx = bx;
      q_by = by;
    }
    if (++nb == kEnvLanes) flush();
  };

  const int trow = blockIdx.x / kEnvTableBlocks;
  const int hits = kWalk == kTable ? counts[trow] : 0;
  if (kWalk == kTable && hits <= max_surv) {
    const int* row = surv + (size_t)trow * max_surv;
    for (int t = 0; t < hits; ++t) {
      const int g = row[t];
      const int end = min(s_count, (g + 1) * gs);
      for (int s = g * gs; s < end; ++s) section(s);
    }
  } else {
    for (int s = 0; s < s_count; ++s) section(s);
  }
  flush();
  if (in && lane == 0) {
    fx[i] = live ? ax : 0.0f;
    fy[i] = live ? ay : 0.0f;
  }
}

template <bool kMoussaid, Walk kWalk, Geom kGeom>
__global__ void __launch_bounds__(kEnvThreads)
env_force_kernel(const float* __restrict__ px_, const float* __restrict__ py_,
                 const float* __restrict__ pvx_, const float* __restrict__ pvy_,
                 const float* __restrict__ prad_,
                 const uint8_t* __restrict__ alive_,
                 const float* __restrict__ ptx, const float* __restrict__ pty,
                 const float* __restrict__ pux, const float* __restrict__ puy,
                 const float* __restrict__ pil2,
                 int k, const int* __restrict__ lens,
                 const float* __restrict__ cx, const float* __restrict__ cy,
                 const float* __restrict__ r2, const float* __restrict__ ov,
                 int s_count, const float* __restrict__ prm, float a, float b,
                 int use_radius, int n, const int* __restrict__ surv,
                 const int* __restrict__ counts, int max_surv, int gs,
                 float* __restrict__ fx, float* __restrict__ fy) {
  env_walk<kMoussaid, kWalk, kGeom>(px_, py_, pvx_, pvy_, prad_, alive_, ptx,
                                    pty, pux, puy, pil2, k, lens, cx, cy, r2,
                                    ov, s_count, prm, a, b, use_radius, n,
                                    surv, counts, max_surv, gs, fx, fy);
}

// Every walk over a batch of crowds of n pedestrians: crowd blockIdx.y's
// sorted planes and outputs at blockIdx.y * n, its parameters (exp: a, b;
// Moussaid: the six) at blockIdx.y * prm_stride, its squared filter radii
// at blockIdx.y * r2_stride (0: shared) and, for kTable, its survivor-table
// rows at blockIdx.y * ceil(n / kEnvTableRow) (surv rows max_surv wide);
// every crowd reads the one set of point rows or segment planes.  The walk
// is the unbatched one: env_walk reads its table row at blockIdx.x /
// kEnvTableBlocks of the crowd's table, which is where the unbatched
// kernel reads a crowd's.
template <bool kMoussaid, Walk kWalk, Geom kGeom>
__global__ void __launch_bounds__(kEnvThreads)
env_force_batched_kernel(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const float* __restrict__ pvx_, const float* __restrict__ pvy_,
    const float* __restrict__ prad_, const uint8_t* __restrict__ alive_,
    const float* __restrict__ ptx, const float* __restrict__ pty,
    const float* __restrict__ pux, const float* __restrict__ puy,
    const float* __restrict__ pil2, int k, const int* __restrict__ lens,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ r2, int r2_stride,
    const float* __restrict__ ov, int s_count,
    const float* __restrict__ prm, int prm_stride, int use_radius, int n,
    const int* __restrict__ surv, const int* __restrict__ counts,
    int max_surv, int gs, float* __restrict__ fx, float* __restrict__ fy) {
  const int bo = (int)blockIdx.y * n;
  const float* row_prm = prm + (long long)blockIdx.y * prm_stride;
  const long long trow0 =
      (long long)blockIdx.y * ((n + kEnvTableRow - 1) / kEnvTableRow);
  env_walk<kMoussaid, kWalk, kGeom>(
      px_ + bo, py_ + bo, kMoussaid ? pvx_ + bo : nullptr,
      kMoussaid ? pvy_ + bo : nullptr, prad_ + bo, alive_ + bo, ptx, pty,
      pux, puy, pil2, k, lens, cx, cy,
      r2 + (long long)blockIdx.y * r2_stride, ov, s_count, row_prm,
      kMoussaid ? 0.0f : row_prm[0], kMoussaid ? 1.0f : row_prm[1],
      use_radius, n, kWalk == kTable ? surv + trow0 * max_surv : nullptr,
      kWalk == kTable ? counts + trow0 : nullptr, max_surv, gs, fx + bo,
      fy + bo);
}

// The Moussaid walk of a batch of crowds that each read their own sampled
// segment set: env_force_batched_kernel's arguments for crowd blockIdx.y,
// and its point rows at blockIdx.y * s_count * k, its centers and lengths
// at blockIdx.y * s_count and its obstacle velocities at blockIdx.y *
// s_count * 2.
template <Walk kWalk>
__global__ void __launch_bounds__(kEnvThreads)
env_force_percrowd_kernel(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const float* __restrict__ pvx_, const float* __restrict__ pvy_,
    const float* __restrict__ prad_, const uint8_t* __restrict__ alive_,
    const float* __restrict__ ptx, const float* __restrict__ pty, int k,
    const int* __restrict__ lens, const float* __restrict__ cx,
    const float* __restrict__ cy, const float* __restrict__ r2,
    int r2_stride, const float* __restrict__ ov, int s_count,
    const float* __restrict__ prm, int prm_stride, int use_radius, int n,
    const int* __restrict__ surv, const int* __restrict__ counts,
    int max_surv, int gs, float* __restrict__ fx, float* __restrict__ fy) {
  const int bo = (int)blockIdx.y * n;
  const long long so = (long long)blockIdx.y * s_count;
  const long long po = so * k;
  const long long trow0 =
      (long long)blockIdx.y * ((n + kEnvTableRow - 1) / kEnvTableRow);
  env_walk<true, kWalk, kSampled>(
      px_ + bo, py_ + bo, pvx_ + bo, pvy_ + bo, prad_ + bo, alive_ + bo,
      ptx + po, pty + po, nullptr, nullptr, nullptr, k,
      lens != nullptr ? lens + so : nullptr, cx + so, cy + so,
      r2 + (long long)blockIdx.y * r2_stride, ov + 2 * so, s_count,
      prm + (long long)blockIdx.y * prm_stride, 0.0f, 1.0f, use_radius, n,
      kWalk == kTable ? surv + trow0 * max_surv : nullptr,
      kWalk == kTable ? counts + trow0 : nullptr, max_surv, gs, fx + bo,
      fy + bo);
}

template <bool kMoussaid, Walk kWalk, Geom kGeom>
int env_launch(const float* px, const float* py, const float* pvx,
               const float* pvy, const float* prad, const uint8_t* alive,
               const float* ptx, const float* pty, const float* pux,
               const float* puy, const float* pil2, int k, const int* lens,
               const float* cx, const float* cy, const float* r2,
               const float* ov, int s_count, const float* prm, float a,
               float b, int use_radius, int n, const int* surv,
               const int* counts, int max_surv, int gs, float* fx, float* fy,
               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kEnvPeds - 1) / kEnvPeds;
  env_force_kernel<kMoussaid, kWalk, kGeom>
      <<<blocks, kEnvThreads, 0, (cudaStream_t)stream>>>(
          px, py, pvx, pvy, prad, alive, ptx, pty, pux, puy, pil2, k, lens,
          cx, cy, r2, ov, s_count, prm, a, b, use_radius, n, surv, counts,
          max_surv, gs, fx, fy);
  return (int)cudaGetLastError();
}

template <bool kMoussaid, Walk kWalk, Geom kGeom>
int env_batched_launch(const float* px, const float* py, const float* pvx,
                       const float* pvy, const float* prad,
                       const uint8_t* alive, const float* ptx,
                       const float* pty, const float* pux, const float* puy,
                       const float* pil2, int k, const int* lens,
                       const float* cx, const float* cy, const float* r2,
                       int r2_stride, const float* ov, int s_count,
                       const float* prm, int prm_stride, int use_radius,
                       int n, int batch, const int* surv, const int* counts,
                       int max_surv, int gs, float* fx, float* fy,
                       void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kEnvPeds - 1) / kEnvPeds;
  env_force_batched_kernel<kMoussaid, kWalk, kGeom>
      <<<dim3(blocks, batch), kEnvThreads, 0, (cudaStream_t)stream>>>(
          px, py, pvx, pvy, prad, alive, ptx, pty, pux, puy, pil2, k, lens,
          cx, cy, r2, r2_stride, ov, s_count, prm, prm_stride, use_radius, n,
          surv, counts, max_surv, gs, fx, fy);
  return (int)cudaGetLastError();
}

template <Walk kWalk>
int env_percrowd_launch(const float* px, const float* py, const float* pvx,
                        const float* pvy, const float* prad,
                        const uint8_t* alive, const float* ptx,
                        const float* pty, int k, const int* lens,
                        const float* cx, const float* cy, const float* r2,
                        int r2_stride, const float* ov, int s_count,
                        const float* prm, int prm_stride, int use_radius,
                        int n, int batch, const int* surv, const int* counts,
                        int max_surv, int gs, float* fx, float* fy,
                        void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kEnvPeds - 1) / kEnvPeds;
  env_force_percrowd_kernel<kWalk>
      <<<dim3(blocks, batch), kEnvThreads, 0, (cudaStream_t)stream>>>(
          px, py, pvx, pvy, prad, alive, ptx, pty, k, lens, cx, cy, r2,
          r2_stride, ov, s_count, prm, prm_stride, use_radius, n, surv,
          counts, max_surv, gs, fx, fy);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError(): non-zero
// means the launch was refused.  Pedestrian planes (n,) in the sorted order;
// ptx/pty (s_count, k) row-major, PAD_COORD-padded; lens (s_count,) int32
// the real points of each row, all before its padding, or null (every
// slot); cx/cy/r2 (s_count,) with r2 = -1 for segments that must not act.
// Every output row is written.  The _compact entries also take the
// survivor table surv (ceil(n/128), max_surv) int32, its counts
// (ceil(n/128),) and gs sections per group.  The _analytic entries take
// the segment planes ax, ay, ux, uy, il2 (s_count, m) in place of the
// point rows, and lens counts segments.
int sfm_env_exp(const float* px, const float* py, const float* prad,
                const uint8_t* alive, const float* ptx, const float* pty,
                int k, const int* lens, const float* cx, const float* cy,
                const float* r2, int s_count, float a, float b,
                int use_radius, int n, float* fx, float* fy, void* stream) {
  return env_launch<false, kAllSections, kSampled>(
      px, py, nullptr, nullptr, prad, alive, ptx, pty, nullptr, nullptr,
      nullptr, k, lens, cx, cy, r2, nullptr, s_count, nullptr, a, b,
      use_radius, n, nullptr, nullptr, 0, 1, fx, fy, stream);
}

int sfm_env_moussaid(const float* px, const float* py, const float* pvx,
                     const float* pvy, const float* prad, const uint8_t* alive,
                     const float* ptx, const float* pty, int k,
                     const int* lens, const float* cx, const float* cy,
                     const float* r2, const float* ov, int s_count,
                     const float* prm, int use_radius, int n, float* fx,
                     float* fy, void* stream) {
  return env_launch<true, kAllSections, kSampled>(
      px, py, pvx, pvy, prad, alive, ptx, pty, nullptr, nullptr, nullptr, k,
      lens, cx, cy, r2, ov, s_count, prm, 0.0f, 1.0f, use_radius, n, nullptr,
      nullptr, 0, 1, fx, fy, stream);
}

int sfm_env_exp_compact(const float* px, const float* py, const float* prad,
                        const uint8_t* alive, const float* ptx,
                        const float* pty, int k, const int* lens,
                        const float* cx, const float* cy, const float* r2,
                        int s_count, float a, float b, int use_radius, int n,
                        const int* surv, const int* counts, int max_surv,
                        int gs, float* fx, float* fy, void* stream) {
  return env_launch<false, kTable, kSampled>(
      px, py, nullptr, nullptr, prad, alive, ptx, pty, nullptr, nullptr,
      nullptr, k, lens, cx, cy, r2, nullptr, s_count, nullptr, a, b,
      use_radius, n, surv, counts, max_surv, gs, fx, fy, stream);
}

int sfm_env_moussaid_compact(const float* px, const float* py,
                             const float* pvx, const float* pvy,
                             const float* prad, const uint8_t* alive,
                             const float* ptx, const float* pty, int k,
                             const int* lens, const float* cx,
                             const float* cy, const float* r2,
                             const float* ov, int s_count, const float* prm,
                             int use_radius, int n, const int* surv,
                             const int* counts, int max_surv, int gs,
                             float* fx, float* fy, void* stream) {
  return env_launch<true, kTable, kSampled>(
      px, py, pvx, pvy, prad, alive, ptx, pty, nullptr, nullptr, nullptr, k,
      lens, cx, cy, r2, ov, s_count, prm, 0.0f, 1.0f, use_radius, n, surv,
      counts, max_surv, gs, fx, fy, stream);
}

int sfm_env_exp_analytic(const float* px, const float* py, const float* prad,
                         const uint8_t* alive, const float* ax,
                         const float* ay, const float* ux, const float* uy,
                         const float* il2, int m, const int* lens,
                         const float* cx, const float* cy, const float* r2,
                         int s_count, float a, float b, int use_radius, int n,
                         float* fx, float* fy, void* stream) {
  return env_launch<false, kAllSections, kAnalytic>(
      px, py, nullptr, nullptr, prad, alive, ax, ay, ux, uy, il2, m, lens,
      cx, cy, r2, nullptr, s_count, nullptr, a, b, use_radius, n, nullptr,
      nullptr, 0, 1, fx, fy, stream);
}

int sfm_env_exp_analytic_compact(const float* px, const float* py,
                                 const float* prad, const uint8_t* alive,
                                 const float* ax, const float* ay,
                                 const float* ux, const float* uy,
                                 const float* il2, int m, const int* lens,
                                 const float* cx, const float* cy,
                                 const float* r2, int s_count, float a,
                                 float b, int use_radius, int n,
                                 const int* surv, const int* counts,
                                 int max_surv, int gs, float* fx, float* fy,
                                 void* stream) {
  return env_launch<false, kTable, kAnalytic>(
      px, py, nullptr, nullptr, prad, alive, ax, ay, ux, uy, il2, m, lens,
      cx, cy, r2, nullptr, s_count, nullptr, a, b, use_radius, n, surv,
      counts, max_surv, gs, fx, fy, stream);
}

// The batched walks: batch crowds of n pedestrians, planes and outputs
// (batch, n) row-major, one set of point rows (or segment planes); r2
// (s_count,) shared (r2_stride 0) or (batch, s_count) (r2_stride s_count);
// prm (batch, 2) of (a, b) for exp and (batch, 6) for Moussaid, rows
// prm_stride apart (0: shared).  The _compact_batched entries also take the
// crowds' survivor tables surv (batch, ceil(n/128), max_surv) int32 and
// counts (batch, ceil(n/128)), and gs sections per group.
int sfm_env_exp_batched(const float* px, const float* py, const float* prad,
                        const uint8_t* alive, const float* ptx,
                        const float* pty, int k, const int* lens,
                        const float* cx, const float* cy, const float* r2,
                        int r2_stride, int s_count, const float* prm,
                        int prm_stride, int use_radius, int n, int batch,
                        float* fx, float* fy, void* stream) {
  return env_batched_launch<false, kAllSections, kSampled>(
      px, py, nullptr, nullptr, prad, alive, ptx, pty, nullptr, nullptr,
      nullptr, k, lens, cx, cy, r2, r2_stride, nullptr, s_count, prm,
      prm_stride, use_radius, n, batch, nullptr, nullptr, 0, 1, fx, fy,
      stream);
}

int sfm_env_moussaid_batched(const float* px, const float* py,
                             const float* pvx, const float* pvy,
                             const float* prad, const uint8_t* alive,
                             const float* ptx, const float* pty, int k,
                             const int* lens, const float* cx,
                             const float* cy, const float* r2, int r2_stride,
                             const float* ov, int s_count, const float* prm,
                             int prm_stride, int use_radius, int n,
                             int batch, float* fx, float* fy, void* stream) {
  return env_batched_launch<true, kAllSections, kSampled>(
      px, py, pvx, pvy, prad, alive, ptx, pty, nullptr, nullptr, nullptr, k,
      lens, cx, cy, r2, r2_stride, ov, s_count, prm, prm_stride, use_radius,
      n, batch, nullptr, nullptr, 0, 1, fx, fy, stream);
}

int sfm_env_exp_compact_batched(const float* px, const float* py,
                                const float* prad, const uint8_t* alive,
                                const float* ptx, const float* pty, int k,
                                const int* lens, const float* cx,
                                const float* cy, const float* r2,
                                int r2_stride, int s_count, const float* prm,
                                int prm_stride, int use_radius, int n,
                                int batch, const int* surv, const int* counts,
                                int max_surv, int gs, float* fx, float* fy,
                                void* stream) {
  return env_batched_launch<false, kTable, kSampled>(
      px, py, nullptr, nullptr, prad, alive, ptx, pty, nullptr, nullptr,
      nullptr, k, lens, cx, cy, r2, r2_stride, nullptr, s_count, prm,
      prm_stride, use_radius, n, batch, surv, counts, max_surv, gs, fx, fy,
      stream);
}

int sfm_env_moussaid_compact_batched(
    const float* px, const float* py, const float* pvx, const float* pvy,
    const float* prad, const uint8_t* alive, const float* ptx,
    const float* pty, int k, const int* lens, const float* cx,
    const float* cy, const float* r2, int r2_stride, const float* ov,
    int s_count, const float* prm, int prm_stride, int use_radius, int n,
    int batch, const int* surv, const int* counts, int max_surv, int gs,
    float* fx, float* fy, void* stream) {
  return env_batched_launch<true, kTable, kSampled>(
      px, py, pvx, pvy, prad, alive, ptx, pty, nullptr, nullptr, nullptr, k,
      lens, cx, cy, r2, r2_stride, ov, s_count, prm, prm_stride, use_radius,
      n, batch, surv, counts, max_surv, gs, fx, fy, stream);
}

int sfm_env_exp_analytic_batched(
    const float* px, const float* py, const float* prad,
    const uint8_t* alive, const float* ax, const float* ay, const float* ux,
    const float* uy, const float* il2, int m, const int* lens,
    const float* cx, const float* cy, const float* r2, int r2_stride,
    int s_count, const float* prm, int prm_stride, int use_radius, int n,
    int batch, float* fx, float* fy, void* stream) {
  return env_batched_launch<false, kAllSections, kAnalytic>(
      px, py, nullptr, nullptr, prad, alive, ax, ay, ux, uy, il2, m, lens,
      cx, cy, r2, r2_stride, nullptr, s_count, prm, prm_stride, use_radius,
      n, batch, nullptr, nullptr, 0, 1, fx, fy, stream);
}

int sfm_env_exp_analytic_compact_batched(
    const float* px, const float* py, const float* prad,
    const uint8_t* alive, const float* ax, const float* ay, const float* ux,
    const float* uy, const float* il2, int m, const int* lens,
    const float* cx, const float* cy, const float* r2, int r2_stride,
    int s_count, const float* prm, int prm_stride, int use_radius, int n,
    int batch, const int* surv, const int* counts, int max_surv, int gs,
    float* fx, float* fy, void* stream) {
  return env_batched_launch<false, kTable, kAnalytic>(
      px, py, nullptr, nullptr, prad, alive, ax, ay, ux, uy, il2, m, lens,
      cx, cy, r2, r2_stride, nullptr, s_count, prm, prm_stride, use_radius,
      n, batch, surv, counts, max_surv, gs, fx, fy, stream);
}

// The Moussaid walks over a batch of crowds that each read their own
// segment set (a batch of fleets' vehicles): ptx/pty (batch, s_count, k),
// cx/cy (batch, s_count), ov (batch, s_count, 2), lens (batch, s_count) or
// null, r2 as in sfm_env_moussaid_batched; the _compact_ entry's table was
// built from each crowd's own circles.
int sfm_env_moussaid_percrowd(const float* px, const float* py,
                              const float* pvx, const float* pvy,
                              const float* prad, const uint8_t* alive,
                              const float* ptx, const float* pty, int k,
                              const int* lens, const float* cx,
                              const float* cy, const float* r2,
                              int r2_stride, const float* ov, int s_count,
                              const float* prm, int prm_stride,
                              int use_radius, int n, int batch, float* fx,
                              float* fy, void* stream) {
  return env_percrowd_launch<kAllSections>(
      px, py, pvx, pvy, prad, alive, ptx, pty, k, lens, cx, cy, r2,
      r2_stride, ov, s_count, prm, prm_stride, use_radius, n, batch, nullptr,
      nullptr, 0, 1, fx, fy, stream);
}

int sfm_env_moussaid_compact_percrowd(
    const float* px, const float* py, const float* pvx, const float* pvy,
    const float* prad, const uint8_t* alive, const float* ptx,
    const float* pty, int k, const int* lens, const float* cx,
    const float* cy, const float* r2, int r2_stride, const float* ov,
    int s_count, const float* prm, int prm_stride, int use_radius, int n,
    int batch, const int* surv, const int* counts, int max_surv, int gs,
    float* fx, float* fy, void* stream) {
  return env_percrowd_launch<kTable>(
      px, py, pvx, pvy, prad, alive, ptx, pty, k, lens, cx, cy, r2,
      r2_stride, ov, s_count, prm, prm_stride, use_radius, n, batch, surv,
      counts, max_surv, gs, fx, fy, stream);
}

}  // extern "C"
