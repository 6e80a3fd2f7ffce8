"""Shared cases of the agent-sharding kernels (the rectangular forms of the
dense pair kernels, the full-block kernel ``pair_force_sym_dense`` and the
in-kernel ring ``ring_force``) for ``tests/test_torch_cuda.py``,
``tests/test_torch_parallel_schedules.py`` and ``chip_smoke.py``: seeded
crowds split into shards, one launch of a form, its plain version and the
one tolerance they are held to.

This module imports neither JAX nor the JAX package, so ``chip_smoke.py``
imports it on a machine without them.
"""
import numpy as np
import torch

from carla_social_force_model_tpu_torch.models.params import (
    MoussaidParams, PedRepulsiveParams, PowerLawParams)
from carla_social_force_model_tpu_torch.ops import cuda_forces, forces
from carla_social_force_model_tpu_torch.ops.pair_grid import (
    COL_TILE, SYM_TILE, block_grid, box_planes, rect_grid)
from carla_social_force_model_tpu_torch.ops.spatial import morton_order

#: kernel vs plain version: |got - want| <= ATOL + RTOL * S, with S the
#: row's (or column's) sum of |f_ij| for the power law (its pair forces
#: reach 1e6 near contact and cancel in a sum) and |f| for the Moussaid law
#: and Helbing (tests/family_cases.py's tolerance)
ATOL = RTOL = 1e-4
LAWS = ("moussaid", "powerlaw", "helbing")


def law_params(law):
    return {"moussaid": MoussaidParams, "powerlaw": PowerLawParams,
            "helbing": PedRepulsiveParams}[law]()


def shard_planes(n, seed, device, extent=None, n_shards=1, sort=False):
    """A seeded crowd of ``n`` (extent sqrt(n) by default, random headings,
    15% dead with the dead share uneven across the ``n_shards`` shards, one
    coincident live pair) as planes x, y, vx, vy, radius, alive, ex, ey
    (unit desired directions, one of them zero); with ``sort`` each shard's
    slots in their own Hilbert order (what the cutoff path launches)."""
    m = max(n, 7)
    extent = float(np.sqrt(m)) if extent is None else extent
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (m, 2)).astype(np.float32)
    vel = rng.uniform(-2.0, 2.0, (m, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, m).astype(np.float32)
    # shard d loses about 5 * d percent of its agents
    shard = np.arange(m) * n_shards // m
    alive = rng.uniform(size=m) >= 0.05 * (shard % 4)
    pos[5] = pos[6]
    alive[5] = alive[6] = True
    e = rng.normal(size=(m, 2))
    e = (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32)
    e[2] = 0.0
    planes = [torch.from_numpy(np.ascontiguousarray(a[:n])).to(device)
              for a in (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], radius,
                        alive, e[:, 0], e[:, 1])]
    if sort:
        k = n // n_shards
        for d in range(n_shards):
            sl = slice(d * k, (d + 1) * k)
            perm, _ = morton_order(planes[0][sl], planes[1][sl],
                                   planes[5][sl], "hilbert")
            for a in planes:
                a[sl] = a[sl][perm]
    return planes


def split(planes, lo, hi):
    return [a[lo:hi].contiguous() for a in planes]


def plain_pairs(law, rows, cols, row_offset=0, col_offset=0, cutoff=None,
                magnitudes=False, mirror=False):
    """The plain pair force of ``law`` of the ``rows`` planes against the
    ``cols`` planes (both as :func:`shard_planes` gives them), ``(2, R)``;
    with ``mirror`` also minus the column sums, ``(2, C)``; with
    ``magnitudes`` the sums of |f_ij| per component instead."""
    x, y, vx, vy, rad, alive, ex, ey = rows
    cx, cy, cvx, cvy, crad, calive = cols[:6]
    p = law_params(law)

    def pair(r, dx, dy, ok):
        if law == "moussaid":
            f = forces._moussaid_pair_force(
                dx, dy, 0.0, vx[r, None] - cvx[None, :],
                vy[r, None] - cvy[None, :], p, ok)
        elif law == "powerlaw":
            f = forces._powerlaw_pair_force(
                dx, dy, rad[r, None] + crad[None, :],
                vx[r, None] - cvx[None, :], vy[r, None] - cvy[None, :], p,
                ok)
        else:
            f = forces._helbing_pair_force(
                -dx, -dy, p.step_width * cvx[None, :],
                p.step_width * cvy[None, :], ex[r, None], ey[r, None], p, ok)
        return tuple(c.abs() for c in f) if magnitudes else f

    out = forces._pair_sum(x, y, alive, pair, 1024, cutoff, None,
                           (cx, cy, calive), row_offset, col_offset,
                           mirror=mirror)
    if mirror:
        return torch.stack(out[:2]), torch.stack(out[2:])
    return torch.stack(out)


def limit(law, want, scale):
    """The elementwise bound of a kernel's error against ``want``:
    ``scale`` is the matching sum of |f_ij| (used for the power law)."""
    return ATOL + RTOL * (scale if law == "powerlaw" else want.abs())


def rect_case(law, planes, n_shards, shard, cutoff=None, gathered=True,
              compact=True, max_surv=0):
    """Shard ``shard``'s rows of ``planes`` against all the columns
    (``gathered``) or against the next shard's block, through the
    rectangular dense kernel (or its cutoff form): ``(got, want, lim)`` as
    (2, R) tensors."""
    n = planes[0].shape[0]
    k = n // n_shards
    rows = split(planes, shard * k, (shard + 1) * k)
    if gathered:
        c0, c1 = 0, n
    else:
        src = (shard + 1) % n_shards
        c0, c1 = src * k, (src + 1) * k
    cols = split(planes, c0, c1)
    x, y, vx, vy, rad, alive, ex, ey = rows
    grid = None
    if cutoff is not None:
        grid = rect_grid(x, y, alive, box_planes(cols[0], cols[1], cols[5],
                                                 COL_TILE),
                         c1 - c0, cutoff, compact=compact, max_surv=max_surv)
    prm = cuda_forces.law_vector(law, law_params(law), x.device)
    hel = law == "helbing"
    got = torch.stack(cuda_forces.pair_force_rect(
        x, y, vx, vy, None if hel else rad, alive, prm, tuple(cols[:6]),
        row_offset=shard * k, col_offset=c0, grid=grid, law=law,
        desired=(ex, ey) if hel else None))
    want = plain_pairs(law, rows, cols, shard * k, c0, cutoff)
    scale = plain_pairs(law, rows, cols, shard * k, c0, cutoff,
                        magnitudes=True)
    return got, want, limit(law, want, scale)


def sym_dense_case(law, rows, cols, cutoff=None, row_offset=0,
                   col_offset=None):
    """The full-block kernel of ``rows`` against ``cols`` (two shards'
    planes): ``(got_rows, got_cols, want_rows, want_cols, lim_rows,
    lim_cols)``, the plain version taking the rows' sums and minus the
    columns' sums of one pair matrix."""
    x, y, vx, vy, rad, alive = rows[:6]
    if col_offset is None:
        col_offset = row_offset + x.shape[0]
    grid = None
    if cutoff is not None:
        grid = block_grid(box_planes(x, y, alive, SYM_TILE),
                          box_planes(cols[0], cols[1], cols[5], SYM_TILE),
                          cutoff)
    prm = cuda_forces.law_vector(law, law_params(law), x.device)
    fx, fy, fxc, fyc = cuda_forces.pair_force_sym_dense(
        x, y, vx, vy, rad, alive, prm, tuple(cols[:6]),
        row_offset=row_offset, col_offset=col_offset, grid=grid, law=law)
    want_r, want_c = plain_pairs(law, rows, cols, row_offset, col_offset,
                                 cutoff, mirror=True)
    mag_r, mag_c = plain_pairs(law, rows, cols, row_offset, col_offset,
                               cutoff, magnitudes=True, mirror=True)
    return (torch.stack((fx, fy)), torch.stack((fxc, fyc)), want_r, want_c,
            limit(law, want_r, mag_r), limit(law, want_c, -mag_c))


def ring_case(law, planes, n_shards, cutoff=None):
    """One launch of the in-kernel ring over ``n_shards`` virtual devices of
    ``planes``, with its plain version (the plain ring) and the bound
    ``(got, want, lim)``, each (2, N); and the gathered dense kernel's
    result on the same rows (``dense``, (2, N))."""
    from carla_social_force_model_tpu_torch.ops import cuda_ring
    x, y, vx, vy, rad, alive, ex, ey = planes
    p = law_params(law)
    prm = cuda_forces.law_vector(law, p, x.device)
    hel = law == "helbing"
    desired = (ex, ey) if hel else None
    got = torch.stack(cuda_ring.ring_force(
        x, y, vx, vy, None if hel else rad, alive, prm, n_shards, law=law,
        desired=desired, cutoff=cutoff))
    want = torch.stack(cuda_ring.ring_force_plain(
        x, y, vx, vy, None if hel else rad, alive, p, n_shards, law=law,
        desired=desired, cutoff=cutoff))
    n = x.shape[0]
    k = n // n_shards
    scale = torch.cat([plain_pairs(law, split(planes, d * k, (d + 1) * k),
                                   planes, d * k, 0, cutoff,
                                   magnitudes=True)
                       for d in range(n_shards)], dim=1)
    dense = torch.cat([rect_case(law, planes, n_shards, d, cutoff)[0]
                       for d in range(n_shards)], dim=1)
    return got, want, limit(law, want, scale), dense
