"""Shared cases of the agent-sharding kernels (the rectangular forms of the
dense pair kernels, the full-block kernel ``pair_force_sym_dense`` and the
in-kernel ring ``ring_force``, and their batched forms for a batch of
crowds sharded over a 2-D mesh) for ``tests/test_torch_cuda.py``,
``tests/test_torch_parallel_schedules.py``,
``tests/test_torch_ensemble_sharded.py`` and ``chip_smoke.py``: seeded
crowds split into shards, one launch of a form, its plain version and the
one tolerance they are held to.

This module imports neither JAX nor the JAX package, so ``chip_smoke.py``
imports it on a machine without them.
"""
import numpy as np
import torch

from carla_social_force_model_tpu_torch.models.params import (
    MoussaidParams, PedRepulsiveParams, PowerLawParams, law_rows,
    section_rows)
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
                magnitudes=False, mirror=False, p=None):
    """The plain pair force of ``law`` (params ``p``, by default
    :func:`law_params`) of the ``rows`` planes against the ``cols`` planes
    (both as :func:`shard_planes` gives them), ``(2, R)``; with ``mirror``
    also minus the column sums, ``(2, C)``; with ``magnitudes`` the sums of
    |f_ij| per component instead."""
    x, y, vx, vy, rad, alive, ex, ey = rows
    cx, cy, cvx, cvy, crad, calive = cols[:6]
    p = law_params(law) if p is None else p

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


# -- the batched forms (a batch of crowds sharded over a 2-D mesh) ------------

def batch_shard_planes(batch, n, seed, device, extent=None, n_shards=1,
                       sort=False):
    """``batch`` crowds of :func:`shard_planes` (crowd b from seed ``seed +
    b``) as ``(batch, n)`` planes x, y, vx, vy, radius, alive, ex, ey."""
    rows = [shard_planes(n, seed + b, device, extent, n_shards, sort)
            for b in range(batch)]
    return [torch.stack(col).contiguous() for col in zip(*rows)]


def _crowd(planes, b):
    """Crowd b of ``(B, n)`` planes (None entries stay None)."""
    return [None if a is None else a[b] for a in planes]


def _row_grid(grid, b):
    """Crowd b's grid of a batched grid (boxes, row boxes, table; the
    unbatched walks read no chunk boxes)."""
    def row(t):
        return None if t is None else t[b].contiguous()
    return grid._replace(boxes=row(grid.boxes), surv=row(grid.surv),
                         counts=row(grid.counts),
                         row_boxes=row(grid.row_boxes), chunk_boxes=None)


def law_args(law, planes):
    """The kernels' arguments of ``law`` from planes x .. ey: the six
    planes (no radius for Helbing) and the keywords."""
    x, y, vx, vy, rad, alive, ex, ey = planes
    hel = law == "helbing"
    return ((x, y, vx, vy, None if hel else rad, alive),
            dict(law=law, desired=(ex, ey) if hel else None))


def rect_batch_case(law, planes, n_shards, shard, cutoff=None, gathered=True,
                    compact=True, max_surv=0, kernel=True):
    """:func:`rect_case` on a batch of crowds (``(B, n)`` planes, every crowd
    sharded alike): shard ``shard``'s rows of each crowd against all of its
    columns (``gathered``) or its next shard's block.  ``(got, want, lim,
    one)``, each ``(2, B, R)``: the batched kernel
    (``pair_force_rect_batched``, with the batched ``rect_grid`` under a
    cutoff), its plain version (``plain_batched_force`` with ``cols``), the
    bound of ``limit`` from each crowd's pair magnitudes, and each crowd
    through the unbatched kernel (``pair_force_rect`` on its own grid).
    ``kernel=False`` (the CPU) leaves ``got`` and ``one`` None."""
    batch, n = planes[0].shape
    k = n // n_shards
    src = shard if gathered else (shard + 1) % n_shards
    c0, c1 = (0, n) if gathered else (src * k, (src + 1) * k)
    rows = [a[:, shard * k:(shard + 1) * k].contiguous() for a in planes]
    cols = [a[:, c0:c1].contiguous() for a in planes]
    args, kw = law_args(law, rows)
    cols6 = tuple(cols[:6])
    p = law_params(law)
    off = dict(row_offset=shard * k, col_offset=c0)
    want = torch.stack(cuda_forces.plain_batched_force(
        law, *args, p, cutoff=cutoff, desired=kw["desired"], cols=cols6,
        **off))
    lim = torch.stack([limit(law, want[:, b], plain_pairs(
        law, _crowd(rows, b), _crowd(cols, b), shard * k, c0, cutoff,
        magnitudes=True)) for b in range(batch)], dim=1)
    if not kernel:
        return None, want, lim, None
    x, y, alive = rows[0], rows[1], rows[5]
    grid = None if cutoff is None else rect_grid(
        x, y, alive, box_planes(cols[0], cols[1], cols[5], COL_TILE),
        c1 - c0, cutoff, compact=compact, max_surv=max_surv,
        cols=(cols[0], cols[1], cols[5]))
    prm = law_rows(law, p, batch, x.device)
    got = torch.stack(cuda_forces.pair_force_rect_batched(
        *args, prm, cols6, grid=grid, **off, **kw))
    one = []
    for b in range(batch):
        rk = dict(kw, desired=(None if kw["desired"] is None
                               else _crowd(kw["desired"], b)))
        one.append(torch.stack(cuda_forces.pair_force_rect(
            *_crowd(args, b), prm[b].contiguous(), tuple(_crowd(cols6, b)),
            grid=None if grid is None else _row_grid(grid, b), **off,
            **rk)))
    return got, want, lim, torch.stack(one, dim=1)


def sym_dense_batch_case(law, rows, cols, cutoff=None, row_offset=0,
                         col_offset=None, kernel=True, p=None):
    """:func:`sym_dense_case` on a batch of crowds: ``rows`` and ``cols``
    two shards' ``(B, R)`` and ``(B, C)`` planes, params ``p`` (shared or
    with ``(B,)`` leaves; by default :func:`law_params`).  ``(got_r,
    got_c, want_r, want_c, lim_r, lim_c, one_r, one_c)``, ``(2, B, R)`` or
    ``(2, B, C)``: the batched full-block kernel (with the batched
    ``block_grid`` under a cutoff), its plain version
    (``plain_batched_force`` with ``mirror``), the bounds, and each crowd
    through the unbatched kernel.  ``kernel=False`` leaves the kernels'
    entries None."""
    batch = rows[0].shape[0]
    if col_offset is None:
        col_offset = row_offset + rows[0].shape[1]
    args, _ = law_args(law, rows)
    cols6 = tuple(cols[:6])
    p = law_params(law) if p is None else p
    off = dict(row_offset=row_offset, col_offset=col_offset)
    fx, fy, fxc, fyc = cuda_forces.plain_batched_force(
        law, *args, p, cutoff=cutoff, cols=cols6, mirror=True, **off)
    want_r, want_c = torch.stack((fx, fy)), torch.stack((fxc, fyc))
    lims_r, lims_c = [], []
    for b, pb in enumerate(section_rows(p, batch)):
        mag_r, mag_c = plain_pairs(law, _crowd(rows, b), _crowd(cols, b),
                                   row_offset, col_offset, cutoff,
                                   magnitudes=True, mirror=True, p=pb)
        lims_r.append(limit(law, want_r[:, b], mag_r))
        lims_c.append(limit(law, want_c[:, b], -mag_c))
    lim_r, lim_c = torch.stack(lims_r, dim=1), torch.stack(lims_c, dim=1)
    if not kernel:
        return None, None, want_r, want_c, lim_r, lim_c, None, None
    x, y, alive = rows[0], rows[1], rows[5]
    grid = None if cutoff is None else block_grid(
        box_planes(x, y, alive, SYM_TILE),
        box_planes(cols[0], cols[1], cols[5], SYM_TILE), cutoff)
    prm = law_rows(law, p, batch, x.device)
    gx, gy, gxc, gyc = cuda_forces.pair_force_sym_dense_batched(
        *args, prm, cols6, grid=grid, law=law, **off)
    ones = [cuda_forces.pair_force_sym_dense(
        *_crowd(args, b), prm[b].contiguous(), tuple(_crowd(cols6, b)),
        grid=None if grid is None else _row_grid(grid, b), law=law, **off)
        for b in range(batch)]
    one_r = torch.stack([torch.stack(o[:2]) for o in ones], dim=1)
    one_c = torch.stack([torch.stack(o[2:]) for o in ones], dim=1)
    return (torch.stack((gx, gy)), torch.stack((gxc, gyc)), want_r, want_c,
            lim_r, lim_c, one_r, one_c)


def ring_batch_case(law, planes, n_shards, cutoff=None, kernel=True):
    """:func:`ring_case` on a batch of crowds (``(B, N)`` planes, every
    crowd over the same ``n_shards`` virtual devices): ``(got, want, lim,
    one)``, each ``(2, B, N)``: one launch of ``ring_force_batched``, its
    plain version (``ring_force_batched_plain``), the bound from each
    crowd's pair magnitudes, and each crowd through the unbatched
    ``ring_force``.  ``kernel=False`` leaves ``got`` and ``one`` None."""
    from carla_social_force_model_tpu_torch.ops import cuda_ring
    batch, n = planes[0].shape
    k = n // n_shards
    args, kw = law_args(law, planes)
    p = law_params(law)
    want = torch.stack(cuda_ring.ring_force_batched_plain(
        *args, p, n_shards, cutoff=cutoff, **kw))
    lim = torch.stack([limit(law, want[:, b], torch.cat([
        plain_pairs(law, split(_crowd(planes, b), d * k, (d + 1) * k),
                    _crowd(planes, b), d * k, 0, cutoff, magnitudes=True)
        for d in range(n_shards)], dim=1)) for b in range(batch)], dim=1)
    if not kernel:
        return None, want, lim, None
    prm = law_rows(law, p, batch, planes[0].device)
    got = torch.stack(cuda_ring.ring_force_batched(
        *args, prm, n_shards, cutoff=cutoff, **kw))
    one = []
    for b in range(batch):
        rk = dict(kw, desired=(None if kw["desired"] is None
                               else _crowd(kw["desired"], b)))
        one.append(torch.stack(cuda_ring.ring_force(
            *_crowd(args, b), prm[b].contiguous(), n_shards, cutoff=cutoff,
            **rk)))
    return got, want, lim, torch.stack(one, dim=1)
