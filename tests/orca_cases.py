"""Shared cases of the ORCA slice's kernels (the analytic form of the border
kernel and the wall-feed kernels) for ``tests/test_torch_cuda.py`` and
``chip_smoke.py``: the config #3 scene as ORCA with the analytic tier sees
it, one launch of each kernel, its plain version and the checks both hold
it to.

This module imports neither JAX nor the JAX package, so ``chip_smoke.py``
imports it on a machine without them.
"""
import dataclasses

import numpy as np
import torch

from carla_social_force_model_tpu_torch.api.synthetic import (benchmark_bundle,
                                                              urban_bundle)
from carla_social_force_model_tpu_torch.models import modes, stepper
from carla_social_force_model_tpu_torch.models.spawn import apply_spawn
from carla_social_force_model_tpu_torch.ops import (cuda_env, forces,
                                                    geometry, statics)
from carla_social_force_model_tpu_torch.ops.spatial import morton_order

#: the analytic border kernel against its plain version: both pick the same
#: segment and the same closest point (every operation of the projection
#: and of the distance rounded on its own on both sides), so what is left
#: is last-ulp differences of rsqrt and exp
ENV_ATOL = ENV_RTOL = 1e-5
#: ORCA's default neighbour distance [m] (models/params.py OrcaParams)
NEIGHBOR_DIST = 15.0


def feed_scene(n, device, seed=5, extent=None, mode="obstacles"):
    """BASELINE config #3 at ``n`` (``benchmark_bundle``, the street-grid
    borders and the parked-car grid; ``mode`` as bench.py's BENCH_MODE:
    ``borders`` config #2, ``urban`` ``urban_bundle``'s curbs) prepared for
    ORCA and the analytic tier, and the spawned crowd with 10% dead and 10%
    on the road, as Hilbert-sorted planes x, y, vx, vy, radius, alive (the
    order ORCA's windowed path and the environment kernels give the
    kernels).  Returns ``(scene, params, planes)``."""
    if mode == "urban":
        scene, params, _, state = urban_bundle(n, num_steps_hint=20,
                                               device=device)
    else:
        scene, params, _, state = benchmark_bundle(
            n, extent=extent, with_borders=True,
            with_obstacles=mode == "obstacles", num_steps_hint=20,
            device=device)
    scene = stepper.prepare_scene(scene, analytic=True, orca=True)
    state = apply_spawn(state, scene.spawn, 0)
    rng = np.random.default_rng(seed)
    dead = torch.from_numpy(rng.uniform(size=n) < 0.1).to(device)
    cross = torch.from_numpy(rng.uniform(size=n) < 0.1).to(device)
    state = dataclasses.replace(
        state, alive=state.alive & ~dead,
        mode=torch.where(cross, modes.CROSSING_ROAD, state.mode))
    perm, _ = morton_order(state.pos_x, state.pos_y, state.alive, "hilbert")
    planes = [a[perm].contiguous() for a in (
        state.pos_x, state.pos_y, state.vel_x, state.vel_y, state.radius,
        state.alive)]
    return scene, params, planes


def analytic_run(planes, geom, a, b, use_radius=False, grid=None,
                 plain=False):
    """The analytic border kernel (``grid``: its compacted form) or its
    plain version on ``planes``, as a (2, N) tensor."""
    x, y, _, _, rad, alive = planes
    if plain:
        out = forces.env_exp_force(x, y, rad, alive, geom, a, b,
                                   use_radius=use_radius)
    elif grid is None:
        out = cuda_env.env_exp_analytic(x, y, rad, alive, geom, a, b,
                                        use_radius=use_radius)
    else:
        out = cuda_env.env_exp_analytic_compact(x, y, rad, alive, geom, a, b,
                                                grid, use_radius=use_radius)
    return torch.stack(out)


def feed_call(kind, planes, src, k=3, use_alive=True, plain=False,
              neigh_dist=NEIGHBOR_DIST):
    """One wall-feed kernel (``seg_topk``, ``chunk_topk``,
    ``chunk_closest``) or its plain version on ``planes``: its (d2, wx, wy)
    planes, (k, N) or (C, N) each.  ``use_alive``: the kernel's boxes hold
    only the alive rows (ORCA's call); else every row.  A batch's ``(B,
    n)`` planes launch the kernel's batched form (``neigh_dist`` a number
    or a sweep's ``(B,)`` tensor): (B, k, n) or (C, B, n) each."""
    x, y, alive = planes[0], planes[1], planes[5]
    live = alive if use_alive else None
    batched = x.dim() == 2
    if kind == "chunk_closest":
        if plain:
            return geometry.chunk_closest_plain(x, y, src, neigh_dist)
        fn = (statics.chunk_closest_batched if batched
              else statics.chunk_closest)
        return fn(x, y, src, neigh_dist, live)
    if plain:
        return statics.topk_plain(x, y, src, k, neigh_dist)
    fn = getattr(statics, kind + ("_batched" if batched else ""))
    return fn(x, y, src, k, neigh_dist, live)


def feed_run(kind, planes, src, k=3, use_alive=True, plain=False,
             neigh_dist=NEIGHBOR_DIST):
    """:func:`feed_call` as one (3, k, N) or (3, C, N) tensor; a batch's
    as (3, k, B, n) or (3, C, B, n), so that a ``(B, n)`` row mask indexes
    its last two axes (:func:`feed_mismatch`)."""
    out = torch.stack(feed_call(kind, planes, src, k, use_alive, plain,
                                neigh_dist))
    if planes[0].dim() == 2 and kind != "chunk_closest":
        return out.movedim(1, 2)
    return out


def feed_mismatch(kind, got, want, rows):
    """Where a wall-feed kernel's output differs from its plain version's
    on the ``rows`` mask: d2 must be equal bitwise (inf in the same slots),
    and the points where d2 is finite (``chunk_closest`` writes 0 for a
    chunk its block skipped; its plain version writes the point).  Returns
    the number of differing elements (0 when the kernel is right)."""
    g, w = got[..., rows], want[..., rows]
    bad = g[0] != w[0]
    fin = torch.isfinite(w[0])
    for p in (1, 2):
        bad |= fin & (g[p] != w[p])
        if kind != "chunk_closest":
            bad |= ~fin & (g[p] != 0)
    return int(bad.sum())


# -- the batched wall feeds ---------------------------------------------------

def batch_feed_planes(planes, batch, seed, dead_rows=()):
    """``batch`` crowds from one crowd's planes (:func:`feed_scene`'s): row
    b shifted by a seeded offset of up to 6 m, with its own 10% dead (every
    agent dead in ``dead_rows``), each row in its own Hilbert order, as
    ORCA's batched path gives them to the kernels.  Returns ``(batch, n)``
    planes x, y, vx, vy, radius, alive."""
    rng = np.random.default_rng(seed)
    dev, n = planes[0].device, planes[0].shape[0]
    off = torch.from_numpy(rng.uniform(-6.0, 6.0, (batch, 2, 1)).astype(
        np.float32)).to(dev)
    dead = torch.from_numpy(rng.uniform(size=(batch, n)) < 0.1).to(dev)
    for r in dead_rows:
        dead[r] = True
    rows = [planes[0] + off[:, 0], planes[1] + off[:, 1],
            *(p.expand(batch, n) for p in planes[2:5]),
            planes[5] & ~dead]
    perm, _ = morton_order(rows[0], rows[1], rows[5], "hilbert")
    return [p.gather(-1, perm).contiguous() for p in rows]


def feed_rows_equal(kind, planes, src, k, neigh_dist, got, use_alive=True):
    """Whether every row of a batched launch's :func:`feed_run` output
    ``got`` equals the unbatched kernel's launch on that row (with that
    row's neighbour distance), bitwise, dead rows included."""
    b = planes[0].shape[0]
    nds = (neigh_dist.tolist() if isinstance(neigh_dist, torch.Tensor)
           else [neigh_dist] * b)
    for r in range(b):
        one = feed_run(kind, [None if p is None else p[r].contiguous()
                              for p in planes], src, k, use_alive,
                       neigh_dist=nds[r])
        if not torch.equal(got[..., r, :], one):
            return False
    return True


# -- tie cases of the segment top-k and chunk_closest ------------------------

#: the 12 lattice points 5 m from the origin: equal squared distances (25)
#: at different points
RING5 = np.array([[3, 4], [4, 3], [0, 5], [5, 0], [-3, 4], [-4, 3], [-5, 0],
                  [0, -5], [3, -4], [4, -3], [-3, -4], [-4, -3]], np.float32)
#: the centres the tie cases' pedestrians stand on
TIE_CENTRES = np.array([[0, 0], [20, 0], [0, 20], [20, 20]], np.float32)


def grid_coords(rng, lo, hi, size):
    """Coordinates on a 1/8 m grid: every difference, product and sum the
    distances take stays exact in float32 (so fused and unfused roundings
    agree, and equal distances are equal bitwise)."""
    return (np.round(rng.uniform(lo, hi, size) * 8) / 8).astype(np.float32)


def tie_segment_planes(f, lanes=4, seed=0):
    """The (f,) numpy planes ax, ay, ux, uy, il2, ccx, ccy, rad of segment
    features that tie: around each of ``TIE_CENTRES`` the 12 points of
    ``RING5`` as point features (12 equal distances for a pedestrian on
    the centre, more than k = 8), in a shuffled order at feature indices
    1, L, L + 1, 1, ... apart (``lanes`` L), as far as ``f`` reaches; the
    other features axis-parallel or diagonal segments of 1-8 m on the 1/8 m
    grid (exact projections), near and beyond the neighbour distance."""
    rng = np.random.default_rng(seed)
    ax, ay = grid_coords(rng, -20.0, 40.0, f), grid_coords(rng, -20.0, 40.0, f)
    step = rng.choice(np.float32([1.0, 2.0, 4.0, 8.0]), f)
    kind = rng.integers(0, 3, f)        # along x, along y, diagonal
    sign = rng.choice(np.float32([-1.0, 1.0]), (2, f))
    ux = np.where(kind != 1, step * sign[0], 0.0).astype(np.float32)
    uy = np.where(kind != 0, step * sign[1], 0.0).astype(np.float32)
    ties = np.concatenate([c + rng.permutation(RING5) for c in TIE_CENTRES])
    at = 3 + np.cumsum([(1, lanes, lanes + 1)[j % 3]
                        for j in range(len(ties))]) - 1
    keep = at < f
    ax[at[keep]], ay[at[keep]] = ties[keep, 0], ties[keep, 1]
    ux[at[keep]] = uy[at[keep]] = 0.0
    l2 = ux * ux + uy * uy
    il2 = np.where(l2 > 0, np.float32(1.0) / np.where(l2 > 0, l2, 1.0),
                   0.0).astype(np.float32)
    half = np.float32(0.5)
    return dict(ax=ax, ay=ay, ux=ux, uy=uy, il2=il2, ccx=ax + half * ux,
                ccy=ay + half * uy, rad=(half * np.sqrt(l2)).astype(
                    np.float32))


def tie_chunk_set(c, kk, seed=0):
    """A host-side ChunkedPointSet (numpy) of ``c`` chunks of ``kk`` slots
    whose closest points tie: each chunk holds points 5 m or 10 m from one
    of ``TIE_CENTRES`` (``RING5`` once or twice), so a pedestrian on the
    centre meets equal distances at different points in neighbouring slots
    and slots a lane stride apart; a random real length (ragged lengths:
    the slots after it invalid), about one slot in ten before it invalid,
    and every sixth chunk with every slot invalid (an empty chunk)."""
    from carla_social_force_model_tpu_torch.env.pointsets import (
        PAD_COORD, ChunkedPointSet)
    rng = np.random.default_rng(seed)
    points = np.full((c, kk, 2), PAD_COORD, np.float32)
    valid = np.zeros((c, kk), bool)
    for ch in range(c):
        length = int(rng.integers(1, kk + 1))
        cen = TIE_CENTRES[rng.integers(0, len(TIE_CENTRES))]
        points[ch, :length] = cen + RING5[rng.integers(0, 12, length)] * \
            rng.choice(np.float32([1.0, 2.0]), (length, 1))
        if ch % 6 == 5:
            continue
        valid[ch, :length] = rng.uniform(size=length) >= 0.1
        valid[ch, length - 1] = True
    return ChunkedPointSet(points, valid, np.arange(c, dtype=np.int32),
                           np.zeros((c, 2), np.float32),
                           np.ones(c, np.float32), c)


def tie_crowd(n, seed=0):
    """``(x, y, alive)`` numpy planes of a crowd for the tie cases: 64
    pedestrians on ``TIE_CENTRES``, 64 on integer points, the rest on the
    1/8 m grid; 10% of the others dead."""
    rng = np.random.default_rng(seed)
    x, y = grid_coords(rng, -10.0, 30.0, n), grid_coords(rng, -10.0, 30.0, n)
    on = min(n, 64)
    x[:on], y[:on] = TIE_CENTRES[np.arange(on) % 4].T
    lat = slice(on, min(n, 128))
    x[lat], y[lat] = np.round(x[lat]), np.round(y[lat])
    alive = rng.uniform(size=n) >= 0.1
    alive[:min(n, 128)] = True
    return x, y, alive
