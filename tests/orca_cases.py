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

from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
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


def feed_scene(n, device, seed=5, extent=None):
    """BASELINE config #3 at ``n`` (``benchmark_bundle``, the street-grid
    borders and the parked-car grid) prepared for ORCA and the analytic
    tier, and the spawned crowd with 10% dead and 10% on the road, as
    Hilbert-sorted planes x, y, vx, vy, radius, alive (the order ORCA's
    windowed path and the environment kernels give the kernels).  Returns
    ``(scene, params, planes)``."""
    scene, params, _, state = benchmark_bundle(
        n, extent=extent, with_borders=True, with_obstacles=True,
        num_steps_hint=20, device=device)
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


def feed_run(kind, planes, src, k=3, use_alive=True, plain=False,
             neigh_dist=NEIGHBOR_DIST):
    """One wall-feed kernel (``seg_topk``, ``chunk_topk``,
    ``chunk_closest``) or its plain version on ``planes``: a (3, k, N) or
    (3, C, N) tensor of d2, wx, wy.  ``use_alive``: the kernel's boxes
    hold only the alive rows (ORCA's call); else every row."""
    x, y, alive = planes[0], planes[1], planes[5]
    if kind == "chunk_closest":
        out = (geometry.chunk_closest_plain(x, y, src, neigh_dist) if plain
               else statics.chunk_closest(x, y, src, neigh_dist,
                                          alive if use_alive else None))
    elif plain:
        out = statics.topk_plain(x, y, src, k, neigh_dist)
    else:
        fn = statics.seg_topk if kind == "seg_topk" else statics.chunk_topk
        out = fn(x, y, src, k, neigh_dist, alive if use_alive else None)
    return torch.stack(out)


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
