"""Social forces as plain, masked PyTorch functions (port of ops/forces.py).

This module is the plain PyTorch version of the kernels in ``csrc/``: the
CPU path, the reference the kernels are held against on the card, and the
parity target of the CPU tests against the JAX package.

* :func:`pedestrian_force` -- the pair-force kernels
  (``csrc/pair_forces.cu``), with ``cutoff`` their cutoff forms.  The masks
  and zero-guards are those of the JAX package's
  ``forces._moussaid_pair_force`` (forces.py:76-113): a pair contributes
  only when both agents are alive, it is not a self pair, the positions
  differ (``d2 > 0``) and the interaction vector does not vanish
  (``B > 0``), so coincident agents give exactly zero, never NaN.
* :func:`powerlaw_force` and :func:`ped_repulsive_force` -- the
  power-law and Helbing forms of the pair kernels (the JAX package's
  forces.py:231-335 and :365-468), with the same ``cutoff`` and row
  blocking.  Each decides its gates (collision course, ellipse, field of
  view) on values rounded after every operation, as the kernels compute
  them.
* :func:`env_exp_force` and :func:`env_moussaid_force` -- the environment
  kernels (``csrc/env_forces.cu``), on the segment-major layout they read
  (``env/pointsets.SegmentPointSet``) or, for the analytic border tier, on
  the line-segment geometry (``env/pointsets.SegmentGeomSet``: the closest
  point is taken on each section's segments,
  ``geometry.closest_on_segments``).
  :func:`border_force`,
  :func:`space_repulsive_force` and :func:`obstacle_force` are the JAX
  package's environment forces (forces.py:338-362, :471-511) on top of them.
* :func:`env_exp_force_batched` and :func:`env_moussaid_force_batched` --
  the plain versions of the batched environment kernels: each row of
  ``(B, N)`` planes through the functions above with that row's
  parameters (the pair forces' counterpart is
  ``cuda_forces.plain_batched_force``).
* Their ``_chunked`` forms (and :func:`chunked_environment_terms`, the
  terms of ``StepConfig.env_chunked``) take each segment's closest point
  from a :class:`..env.pointsets.ChunkedPointSet` through
  ``geometry.closest_point_per_segment`` (the ``chunk_argmin`` kernel on a
  card), as the JAX package's jnp path does; the force math after the
  closest point is the same function for both layouts.

Every function takes and returns planar ``(N,)`` x/y tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import vecmath
from .geometry import (PAD_DIST2, closest_on_segments,
                       closest_point_per_segment, section_column,
                       segment_filter_mask)
from .pair_grid import cutoff_sq
from ..env.pointsets import SegmentGeomSet, SegmentPointSet, per_crowd
from ..models import modes
from ..models.params import (AccelerationParams, BorderParams, MoussaidParams,
                             PedRepulsiveParams, PowerLawParams,
                             SpaceRepulsiveParams, as_column,
                             helbing_cos_phi, refuse_grad, section_rows)

def acceleration_force_xy(pos_x, pos_y, vel_x, vel_y, wp_x, wp_y,
                          applied_target, p: AccelerationParams):
    """Relaxation toward the target speed along the desired direction
    (reference forces.py:46-53, zero-safe direction); returns ``(fx, fy)``."""
    ex, ey, _ = vecmath.normalize_xy(wp_x - pos_x, wp_y - pos_y)
    return ((applied_target * ex - vel_x) / p.tau,
            (applied_target * ey - vel_y) / p.tau)


def _moussaid_pair_force(dx, dy, radius_sub, dvx, dvy, p: MoussaidParams,
                         pair_ok):
    """Moussaid et al. (2009) interaction term, per pair.

    ``(dx, dy)`` is the raw vector from the pedestrian toward its partner
    (x_j - x_i), ``(dvx, dvy)`` the relative velocity v_i - v_j,
    ``radius_sub`` the radii subtracted from the distance (0 when disabled)
    and ``pair_ok`` the mask of pairs that may contribute.  Returns the
    force planes ``(fx, fy)`` on the pedestrian, one value per pair.
    Reference math: forces.py:85-115.
    """
    d2 = dx * dx + dy * dy
    r = torch.rsqrt(torch.where(d2 == 0.0, 1.0, d2))
    ex = dx * r                                # zero-safe unit vector
    ey = dy * r
    d = d2 * r - radius_sub                    # = |diff| - radii

    tx = p.lambda_ * dvx + ex
    ty = p.lambda_ * dvy + ey
    t2 = tx * tx + ty * ty
    rt = torch.rsqrt(torch.where(t2 == 0.0, 1.0, t2))
    thx = tx * rt
    thy = ty * rt
    t_len = t2 * rt

    B = p.gamma * t_len
    ok = pair_ok & (B > 0.0) & (d2 > 0.0)

    # signed angle from t_hat to e via one atan2, with the inputs of masked
    # pairs guarded so the backward pass stays finite
    cross = torch.where(ok, thx * ey - thy * ex, 0.0)
    dot = torch.where(ok, ex * thx + ey * thy, 1.0)
    theta = torch.atan2(cross, dot) + B * (-p.epsilon)
    B_safe = torch.where(ok, B, 1.0)
    common = -d / B_safe
    Bt = B * theta
    f_v = -p.A * torch.exp(common - torch.square(p.n_prime * Bt))
    f_t = -p.A * torch.sign(theta) * torch.exp(common - torch.square(p.n * Bt))
    # f = f_v * t_hat + f_t * left_normal(t_hat)
    fx = torch.where(ok, f_v * thx - f_t * thy, 0.0)
    fy = torch.where(ok, f_v * thy + f_t * thx, 0.0)
    return fx, fy


def _pair_sum(pos_x, pos_y, alive, pair_fn, row_block: int,
              cutoff: float | None, rows, cols=None, row_offset: int = 0,
              col_offset: int = 0, mirror: bool = False):
    """Row-blocked sum over partners of a pair law: ``(fx, fy)``.

    ``pair_fn(r, dx, dy, pair_ok)`` returns the ``(rows, C)`` force planes
    of row index (or slice) ``r`` against every column, with ``(dx, dy)``
    the raw vector x_j - x_i and ``pair_ok`` the mask of pairs that may
    contribute: both alive, not a self pair and, with ``cutoff``, within
    it (the JAX package's per-pair ``d2 <= cutoff * cutoff``).  Blocks of
    ``row_block`` rows bound the intermediates; ``rows`` optionally lists
    the rows to compute, in its order.

    ``cols``: the partners' ``(x, y, alive)`` when they are not the rows
    (a shard's rows against gathered or rotated columns); the self-pair
    test then compares global slots, ``row_offset + i`` with
    ``col_offset + j`` (the JAX package's ``row_offset``, forces.py:149).
    ``mirror``: also return minus the column sums of the same pair forces,
    ``(fx, fy, fxc, fyc)`` -- the plain version of the full-block kernel,
    whose columns take -f of every pair."""
    cx, cy, calive = (pos_x, pos_y, alive) if cols is None else cols
    n = pos_x.shape[0]
    col = torch.arange(cx.shape[0], device=pos_x.device)
    ids = torch.arange(n, device=pos_x.device) if rows is None else rows
    m = ids.shape[0]
    c2 = None if cutoff is None else cutoff_sq(cutoff)
    fx_out = torch.empty(m, dtype=pos_x.dtype, device=pos_x.device)
    fy_out = torch.empty(m, dtype=pos_y.dtype, device=pos_y.device)
    fxc = torch.zeros(cx.shape[0], dtype=pos_x.dtype, device=pos_x.device)
    fyc = torch.zeros_like(fxc)
    for lo in range(0, m, row_block):
        hi = min(lo + row_block, m)
        r = slice(lo, hi) if rows is None else rows[lo:hi]
        dx = cx[None, :] - pos_x[r, None]               # x_j - x_i
        dy = cy[None, :] - pos_y[r, None]
        not_self = (ids[lo:hi, None] + row_offset) != (col[None, :]
                                                       + col_offset)
        pair_ok = alive[r, None] & calive[None, :] & not_self
        if c2 is not None:
            pair_ok = pair_ok & (dx * dx + dy * dy <= c2)
        fx, fy = pair_fn(r, dx, dy, pair_ok)
        fx_out[lo:hi] = fx.sum(dim=1)
        fy_out[lo:hi] = fy.sum(dim=1)
        if mirror:
            fxc -= fx.sum(dim=0)
            fyc -= fy.sum(dim=0)
    if mirror:
        return fx_out, fy_out, fxc, fyc
    return fx_out, fy_out


def _columns(cols, pos_x, pos_y, vel_x, vel_y, radius, alive):
    """The partners' planes ``(x, y, vx, vy, radius, alive)``: ``cols``, or
    the rows' own."""
    return ((pos_x, pos_y, vel_x, vel_y, radius, alive) if cols is None
            else cols)


def pedestrian_force(pos_x, pos_y, vel_x, vel_y, radius, alive,
                     p: MoussaidParams, use_ped_radius: bool = False,
                     row_block: int = 1024, cutoff: float | None = None,
                     rows=None, cols=None, row_offset: int = 0,
                     col_offset: int = 0, mirror: bool = False):
    """Full N x N pedestrian interaction force (reference forces.py:74-117),
    planar: returns ``(fx, fy)``.

    Row-blocked so the pairwise intermediates stay ``(row_block, N)``
    regardless of the population.  Dead rows come out exactly zero.

    ``cutoff`` [m]: pairs farther apart contribute nothing -- the plain
    version of the cutoff kernels (the JAX package's per-pair
    ``d2 <= cutoff * cutoff`` in ``_pair_tile``), with no sort and no
    tiles.  ``rows``: an optional index tensor; only those rows' forces are
    computed (against every column) and returned, in its order.  ``cols``:
    the partners' planes ``(x, y, vx, vy, radius, alive)`` when they are
    not the rows -- the rectangular form of the kernels, with global slots
    ``row_offset + i`` and ``col_offset + j`` for the self-pair test;
    ``mirror`` also returns minus the column sums (see :func:`_pair_sum`).
    """
    cx, cy, cvx, cvy, crad, calive = _columns(cols, pos_x, pos_y, vel_x,
                                              vel_y, radius, alive)

    def pair(r, dx, dy, pair_ok):
        dvx = vel_x[r, None] - cvx[None, :]             # v_i - v_j
        dvy = vel_y[r, None] - cvy[None, :]
        radius_sub = ((radius[r, None] + crad[None, :])
                      if use_ped_radius else 0.0)
        return _moussaid_pair_force(dx, dy, radius_sub, dvx, dvy, p, pair_ok)

    return _pair_sum(pos_x, pos_y, alive, pair, row_block, cutoff, rows,
                     (cx, cy, calive), row_offset, col_offset, mirror)


def _f32_ratio(a, b):
    """``a / b`` rounded to float32, as the kernels read such a
    coefficient: a number, or a tensor that carries the gradient where
    ``a`` or ``b`` is one (calibration's leaves)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a / b
    return float(np.float32(a) / np.float32(b))


def _powerlaw_pair_force(dx, dy, rad_sum, dvx, dvy, p: PowerLawParams,
                         pair_ok):
    """Karamouzas et al. (2014) time-to-collision pair force (the JAX
    package's forces.py:231-270), per pair, with the conventions of
    :func:`_moussaid_pair_force`: ``(dx, dy)`` = x_j - x_i, ``(dvx, dvy)``
    = v_i - v_j, ``rad_sum`` the summed disc radii.

    With x = x_i - x_j, a = v.v, b = x.v, c = x.x - R^2 and D = b^2 - a*c,
    tau = (-b - sqrt(D)) / a is the time to collision, and the force is
    k*exp(-tau/tau0)*(2/tau + 1/tau0)/tau^2 * (a*x - (sqrt(D) + b)*v) /
    (a*sqrt(D)).  Only pairs on a collision course contribute: c > 0
    (not overlapping), D > 0, a > 1e-8 and 0 < tau < tau_max; tau is then
    clipped to [tau_min, tau_max].  Masked pairs select 0.  The
    coefficient ``1/tau0`` is taken in float32, as the kernels read it."""
    xx = -dx                                   # x = x_i - x_j
    xy = -dy
    a = dvx * dvx + dvy * dvy
    b = xx * dvx + xy * dvy
    c = xx * xx + xy * xy - rad_sum * rad_sum
    disc = b * b - a * c
    ok = pair_ok & (c > 0.0) & (disc > 0.0) & (a > 1e-8)
    disc_safe = torch.where(ok, disc, 1.0)
    a_safe = torch.where(ok, a, 1.0)
    s = torch.sqrt(disc_safe)
    tau = (-b - s) / a_safe
    ok = ok & (tau > 0.0) & (tau < p.tau_max)
    tau = vecmath.minimum(vecmath.maximum(tau, p.tau_min), p.tau_max)
    inv_tau0 = _f32_ratio(1.0, p.tau0)
    mag = (p.k * torch.exp(-tau / p.tau0)
           * (2.0 / tau + inv_tau0) / (tau * tau))
    scale = mag / (a_safe * s)
    sb = s + b
    fx = torch.where(ok, scale * (a * xx - sb * dvx), 0.0)
    fy = torch.where(ok, scale * (a * xy - sb * dvy), 0.0)
    return fx, fy


def powerlaw_force(pos_x, pos_y, vel_x, vel_y, radius, alive,
                   p: PowerLawParams, row_block: int = 1024,
                   cutoff: float | None = None, rows=None, cols=None,
                   row_offset: int = 0, col_offset: int = 0,
                   mirror: bool = False):
    """Full N x N Karamouzas power-law interaction (the JAX package's
    forces.py:273-335), planar: ``(fx, fy)``.  The plain version of the
    ``powerlaw_*`` kernels; disc radii always participate (the law is
    defined on discs).  ``row_block``, ``cutoff``, ``rows``, ``cols``, the
    offsets and ``mirror`` as in :func:`pedestrian_force`.  Dead rows come
    out exactly zero."""
    cx, cy, cvx, cvy, crad, calive = _columns(cols, pos_x, pos_y, vel_x,
                                              vel_y, radius, alive)

    def pair(r, dx, dy, pair_ok):
        return _powerlaw_pair_force(
            dx, dy, radius[r, None] + crad[None, :],
            vel_x[r, None] - cvx[None, :], vel_y[r, None] - cvy[None, :],
            p, pair_ok)

    return _pair_sum(pos_x, pos_y, alive, pair, row_block, cutoff, rows,
                     (cx, cy, calive), row_offset, col_offset, mirror)


def _helbing_pair_force(dx, dy, yx, yy, ex, ey, p: PedRepulsiveParams,
                        pair_ok):
    """Helbing-Molnar (1995) elliptical pair force with field-of-view
    weight (the JAX package's forces.py:365-408), per pair.

    ``(dx, dy)`` = r_i - r_j, ``(yx, yy)`` = step_width * v_j the
    partner's anticipated step, ``(ex, ey)`` the pedestrian's desired
    direction.  V(b) = v0*exp(-b/sigma), with 2b the minor axis of the
    ellipse through r_i around r_j and r_j + y; the force on i is -grad V,
    weighted by ``fov_factor`` when the partner lies outside i's field of
    view.  Pairs with b == 0 or a vanishing |d| or |d - y| contribute 0; b
    is floored at ``b_min``.  The law reads neither radii nor v_i.  The
    coefficient ``v0/sigma`` is taken in float32, as the kernels read it."""
    mx = dx - yx                               # d - y
    my = dy - yy
    nd = torch.sqrt(dx * dx + dy * dy)
    nm = torch.sqrt(mx * mx + my * my)
    s = nd + nm
    y2 = yx * yx + yy * yy
    b2 = vecmath.maximum(s * s - y2, 0.0) * 0.25
    b = torch.sqrt(b2)
    ok = pair_ok & (b > 0.0) & (nd > 0.0) & (nm > 0.0)
    nd_s = torch.where(nd == 0.0, 1.0, nd)
    nm_s = torch.where(nm == 0.0, 1.0, nm)
    b_s = vecmath.maximum(torch.where(ok, b, 1.0), p.b_min)
    g = s / (4.0 * b_s)
    coef = _f32_ratio(p.v0, p.sigma)
    e = coef * torch.exp(-b_s / p.sigma)
    fx = e * (g * (dx / nd_s + mx / nm_s))
    fy = e * (g * (dy / nd_s + my / nm_s))
    # field of view (Helbing eq. 7): -f points from i toward the source j
    tx, ty = -fx, -fy
    seen = (ex * tx + ey * ty
            >= torch.sqrt(tx * tx + ty * ty) * helbing_cos_phi(p))
    w = torch.where(seen, 1.0, p.fov_factor)
    return torch.where(ok, w * fx, 0.0), torch.where(ok, w * fy, 0.0)


def ped_repulsive_force(pos_x, pos_y, vel_x, vel_y, ex, ey, alive,
                        p: PedRepulsiveParams, row_block: int = 1024,
                        cutoff: float | None = None, rows=None, cols=None,
                        row_offset: int = 0, col_offset: int = 0):
    """Helbing-Molnar (1995) elliptical pedestrian repulsion with field of
    view (the JAX package's forces.py:411-468), planar: ``(fx, fy)``.  The
    plain version of the ``helbing_*`` kernels.  ``(ex, ey)``: each
    pedestrian's unit desired direction (zero at its waypoint).  The law is
    not antisymmetric: it anticipates the partner's step and never reads
    the pedestrian's own velocity.  ``row_block``, ``cutoff``, ``rows``,
    ``cols`` (whose radius entry is not read) and the offsets as in
    :func:`pedestrian_force`."""
    cx, cy, cvx, cvy, _, calive = _columns(cols, pos_x, pos_y, vel_x, vel_y,
                                           None, alive)

    def pair(r, dx, dy, pair_ok):
        return _helbing_pair_force(
            -dx, -dy, p.step_width * cvx[None, :],
            p.step_width * cvy[None, :], ex[r, None], ey[r, None], p,
            pair_ok)

    return _pair_sum(pos_x, pos_y, alive, pair, row_block, cutoff, rows,
                     (cx, cy, calive), row_offset, col_offset)


def section_slots(seg) -> int:
    """Points (sampled set) or segments (analytic set) per section row."""
    return (seg.max_segments if isinstance(seg, SegmentGeomSet)
            else seg.points_per_segment)


def _ped_blocks(n: int, seg, max_group_elems: int):
    """Pedestrian row blocks bounding the (S, K, rows) temporaries of the
    closest-point search to about ``max_group_elems`` elements."""
    rows = max(1, max_group_elems // max(1, seg.num_segments
                                         * section_slots(seg)))
    return ((lo, min(lo + rows, n)) for lo in range(0, n, rows))


def _closest_points(pos_x, pos_y, seg):
    """Per (segment, ped) closest point: ``(dmin2, bx, by)`` of shape
    (S, B), with the first-occurrence argmin of the reference's
    ``np.argmin`` over a sampled row, or over a section's line segments
    for an analytic set (:class:`..env.pointsets.SegmentGeomSet`, the
    JAX package's ``_closest_seg``).  Padded slots sit at ``PAD_COORD``: a
    segment with no point in reach gives ``dmin2 >= PAD_DIST2``."""
    if isinstance(seg, SegmentGeomSet):
        d2, cx, cy = closest_on_segments(
            pos_x[None, None, :], pos_y[None, None, :],
            *(a[:, :, None] for a in (seg.ax, seg.ay, seg.ux, seg.uy,
                                      seg.inv_len2)))        # (S, M, B)
        idx = torch.argmin(d2, dim=1)[:, None, :]            # first
        return tuple(torch.gather(a, 1, idx)[:, 0, :] for a in (d2, cx, cy))
    dx = seg.x[:, :, None] - pos_x[None, None, :]          # (S, K, B)
    dy = seg.y[:, :, None] - pos_y[None, None, :]
    d2 = dx * dx + dy * dy
    idx = torch.argmin(d2, dim=1)                          # (S, B), first
    dmin2 = torch.gather(d2, 1, idx[:, None, :])[:, 0, :]
    return dmin2, torch.gather(seg.x, 1, idx), torch.gather(seg.y, 1, idx)


def _segment_ok(pos_x, pos_y, alive, seg, has_point, active):
    """(S, B) mask of the (segment, ped) pairs that contribute: a real
    closest point (``has_point``), inside the segment's filter circle, an
    alive pedestrian and (when given) an active segment.  ``(B, N)``
    planes give ``(S, B, N)``; the sums below then take ``(B, 1)``
    parameter columns."""
    ok = has_point & segment_filter_mask(pos_x, pos_y, seg) & alive[None]
    if active is not None:
        ok = ok & section_column(active, pos_x)
    return ok


def _exp_sum(pos_x, pos_y, bx, by, ok, radius, a: float, b: float):
    """The exponential terms ``a * exp(-d/b)`` away from the (S, B) closest
    points ``(bx, by)``, summed over the segments where ``ok``:
    ``(fx, fy)`` of shape (B,).  ``d`` is the distance to the point, less
    ``radius`` when one is given.  A pedestrian standing on its point gets
    0 from it (the direction vector is 0), never NaN."""
    dx = pos_x[None, :] - bx                               # point -> ped
    dy = pos_y[None, :] - by
    d2 = dx * dx + dy * dy
    r = torch.rsqrt(torch.where(d2 == 0.0, 1.0, d2))
    d = d2 * r
    if radius is not None:
        d = d - radius[None, :]
    mag = torch.where(ok, (a * torch.exp(-d / b)) * r, 0.0)
    return (mag * dx).sum(dim=0), (mag * dy).sum(dim=0)


def _moussaid_sum(pos_x, pos_y, vel_x, vel_y, bx, by, ok, radius,
                  obstacle_vel, p: MoussaidParams):
    """The Moussaid terms against the (S, B) closest points ``(bx, by)``
    with the relative velocity ``v_ped - obstacle_vel[s]``, summed over the
    segments where ``ok``: ``(fx, fy)``.  ``radius`` (or None) is
    subtracted from the distance."""
    dvx = vel_x[None] - section_column(obstacle_vel[..., 0], vel_x)
    dvy = vel_y[None] - section_column(obstacle_vel[..., 1], vel_y)
    radius_sub = 0.0 if radius is None else radius[None, :]
    fx, fy = _moussaid_pair_force(bx - pos_x[None, :], by - pos_y[None, :],
                                  radius_sub, dvx, dvy, p, ok)
    return fx.sum(dim=0), fy.sum(dim=0)


def env_exp_force(pos_x, pos_y, radius, alive, seg, a: float, b: float,
                  use_radius: bool = False, active=None,
                  max_group_elems: int = 4_000_000):
    """Exponential repulsion ``a * exp(-d/b)`` away from each segment's
    closest point, summed over the segments whose filter circle holds the
    pedestrian; ``(fx, fy)``.  The plain version of the ``env_exp`` kernel.

    ``d`` is the distance to the point, less the pedestrian's radius when
    ``use_radius`` (``radius`` may be None otherwise).  A pedestrian
    standing on a point gets 0 from it (its direction vector is 0), never
    NaN.  Dead pedestrians get exactly 0.
    """
    fx_out = torch.empty_like(pos_x)
    fy_out = torch.empty_like(pos_y)
    for lo, hi in _ped_blocks(pos_x.shape[0], seg, max_group_elems):
        px, py = pos_x[lo:hi], pos_y[lo:hi]
        dmin2, bx, by = _closest_points(px, py, seg)
        ok = _segment_ok(px, py, alive[lo:hi], seg, dmin2 < PAD_DIST2,
                         active)
        fx_out[lo:hi], fy_out[lo:hi] = _exp_sum(
            px, py, bx, by, ok, radius[lo:hi] if use_radius else None, a, b)
    return fx_out, fy_out


def env_moussaid_force(pos_x, pos_y, vel_x, vel_y, radius, alive, seg,
                       obstacle_vel, p: MoussaidParams,
                       use_radius: bool = False, active=None,
                       max_group_elems: int = 4_000_000):
    """Moussaid interaction against each segment's closest point, with the
    relative velocity ``v_ped - obstacle_vel[s]``, summed over the segments
    whose filter circle holds the pedestrian; ``(fx, fy)``.  The plain
    version of the ``env_moussaid`` kernel.  ``active``: optional (S,) mask
    of segments that exist this step (despawned vehicles)."""
    fx_out = torch.empty_like(pos_x)
    fy_out = torch.empty_like(pos_y)
    for lo, hi in _ped_blocks(pos_x.shape[0], seg, max_group_elems):
        px, py = pos_x[lo:hi], pos_y[lo:hi]
        dmin2, bx, by = _closest_points(px, py, seg)
        ok = _segment_ok(px, py, alive[lo:hi], seg, dmin2 < PAD_DIST2,
                         active)
        fx_out[lo:hi], fy_out[lo:hi] = _moussaid_sum(
            px, py, vel_x[lo:hi], vel_y[lo:hi], bx, by, ok,
            radius[lo:hi] if use_radius else None, obstacle_vel, p)
    return fx_out, fy_out


def number_rows(x, batch: int) -> list:
    """Row b's value of a parameter: a ``(B,)`` tensor's entries (read once,
    as float32 values), or a number shared by every row.  A leaf that
    requires grad raises (``models/params.refuse_grad``)."""
    refuse_grad("number_rows", x)
    return x.tolist() if isinstance(x, torch.Tensor) else [x] * batch


def _segment_row(seg, b: int):
    """Row b's view of a point set whose filter radii are per row (``(B,
    S)``: a swept perception threshold) or that holds each crowd's own
    geometry (``env/pointsets.per_crowd``: a batch of fleets' vehicles);
    a shared set unchanged."""
    upd = {}
    if seg.filter_radius.dim() == 2:
        upd["filter_radius"] = seg.filter_radius[b]
    if per_crowd(seg):
        names = (("x", "y", "center_x", "center_y", "lengths")
                 if isinstance(seg, SegmentPointSet)
                 else ("points", "valid", "centers"))
        upd.update({f: getattr(seg, f)[b] for f in names
                    if getattr(seg, f) is not None})
    return dataclasses.replace(seg, **upd) if upd else seg


def _crowd_row(t, b: int, shared_dims: int):
    """Row b of a per-crowd plane (obstacle velocities, the active mask)
    with one dimension more than ``shared_dims``; a shared one (or None)
    unchanged."""
    return t[b] if t is not None and t.dim() > shared_dims else t


def env_exp_force_batched(pos_x, pos_y, radius, alive, seg, a, b,
                          use_radius: bool = False, active=None):
    """:func:`env_exp_force` on ``(B, N)`` planes against one point set:
    row r with ``a[r]``, ``b[r]`` (``(B,)`` tensors, or numbers shared by
    every row).  The plain version of the batched ``env_exp`` kernel."""
    batch = pos_x.shape[0]
    return _stacked(
        env_exp_force(pos_x[r], pos_y[r], radius[r], alive[r],
                      _segment_row(seg, r), ar, br, use_radius=use_radius,
                      active=active)
        for r, (ar, br) in enumerate(zip(number_rows(a, batch),
                                         number_rows(b, batch))))


def env_moussaid_force_batched(pos_x, pos_y, vel_x, vel_y, radius, alive,
                               seg, obstacle_vel, p: MoussaidParams,
                               use_radius: bool = False, active=None):
    """:func:`env_moussaid_force` on ``(B, N)`` planes against one point
    set, or each crowd against its own (a batch of fleets' vehicles, with
    ``(B, S, 2)`` velocities and a ``(B, S)`` active mask): row r with row
    r of ``p`` (a section with ``(B,)`` leaves, or one shared by every
    row).  The plain version of the batched ``env_moussaid`` kernel and of
    its per-crowd form."""
    return _stacked(
        env_moussaid_force(pos_x[r], pos_y[r], vel_x[r], vel_y[r], radius[r],
                           alive[r], _segment_row(seg, r),
                           _crowd_row(obstacle_vel, r, 2), pr,
                           use_radius=use_radius,
                           active=_crowd_row(active, r, 1))
        for r, pr in enumerate(section_rows(p, pos_x.shape[0])))


def _stacked(rows):
    """``(fx, fy)`` of ``(B, N)`` planes from each row's ``(fx, fy)``."""
    fx, fy = zip(*rows)
    return torch.stack(fx), torch.stack(fy)


def _rows_apart(pos_x) -> bool:
    """Whether a batch's chunked terms go row by row, each with its row's
    numbers on contiguous rows: on the CPU, so that row b equals the
    unbatched path bitwise (its vector loops round ``atan2`` and the sum
    over the sections by where an element falls).  On a card the batch's
    terms are one pass over ``(S, B, N)`` with ``(B, 1)`` parameter
    columns, a few launches for every row where the loop takes a few for
    each (PERF.md §6); a row then differs from the unbatched path in
    last bits (a card divides by a number as a product by its reciprocal,
    and a sum's order follows its shape)."""
    return pos_x.device.type == "cpu"


def _closest_row(closest, r):
    """Row r's ``(S, N)`` closest-point planes of a batch's ``(S, B, N)``
    ones, contiguous: the layout of one crowd's, so that the row runs the
    operations of the unbatched path on the same layout."""
    return tuple(t[:, r].contiguous() for t in closest)


def _exp_chunked_terms(pos_x, pos_y, radius, alive, pset, closest, a, b,
                       use_radius, active):
    ok = _segment_ok(pos_x, pos_y, alive, pset, closest[3], active)
    return _exp_sum(pos_x, pos_y, closest[1], closest[2], ok,
                    radius if use_radius else None, a, b)


def _moussaid_chunked_terms(pos_x, pos_y, vel_x, vel_y, radius, alive, pset,
                            closest, obstacle_vel, p, use_radius, active):
    ok = _segment_ok(pos_x, pos_y, alive, pset, closest[3], active)
    return _moussaid_sum(pos_x, pos_y, vel_x, vel_y, closest[1], closest[2],
                         ok, radius if use_radius else None, obstacle_vel, p)


def env_exp_force_chunked(pos_x, pos_y, radius, alive, pset, a, b,
                          use_radius: bool = False, active=None,
                          plain: bool = False):
    """:func:`env_exp_force` on a :class:`..env.pointsets.ChunkedPointSet`
    of tensors: the closest points from
    :func:`.geometry.closest_point_per_segment` (the ``chunk_argmin``
    kernel on a card; its plain version on the CPU or with ``plain``),
    the same force math.  The JAX package's jnp environment path.

    ``(B, N)`` planes (a batch of crowds): one chunk scan for every row,
    then row r's terms with ``a[r]``, ``b[r]`` (``(B,)`` tensors, or
    numbers shared by every row) and its own filter radii (``(B, S)``):
    one pass for every row, or on the CPU (:func:`_rows_apart`) the
    operations of the unbatched path on each row."""
    closest = closest_point_per_segment(pos_x, pos_y, pset, plain=plain)
    if pos_x.dim() == 1:
        return _exp_chunked_terms(pos_x, pos_y, radius, alive, pset, closest,
                                  a, b, use_radius, active)
    if not _rows_apart(pos_x):
        return _exp_chunked_terms(pos_x, pos_y, radius, alive, pset, closest,
                                  as_column(a), as_column(b), use_radius,
                                  active)
    batch = pos_x.shape[0]
    return _stacked(
        _exp_chunked_terms(pos_x[r], pos_y[r],
                           None if radius is None else radius[r], alive[r],
                           _segment_row(pset, r), _closest_row(closest, r),
                           ar, br, use_radius, active)
        for r, (ar, br) in enumerate(zip(number_rows(a, batch),
                                         number_rows(b, batch))))


def env_moussaid_force_chunked(pos_x, pos_y, vel_x, vel_y, radius, alive,
                               pset, obstacle_vel, p: MoussaidParams,
                               use_radius: bool = False, active=None,
                               plain: bool = False):
    """:func:`env_moussaid_force` on a
    :class:`..env.pointsets.ChunkedPointSet` of tensors (see
    :func:`env_exp_force_chunked`; row r of ``(B, N)`` planes with row r
    of ``p``, a section with ``(B,)`` leaves or one shared by every row,
    against the one set or, for a batch of fleets' vehicles, its own
    chunks with ``(B, S, 2)`` velocities and a ``(B, S)`` active mask)."""
    closest = closest_point_per_segment(pos_x, pos_y, pset, plain=plain)
    if pos_x.dim() == 1 or not _rows_apart(pos_x):
        return _moussaid_chunked_terms(
            pos_x, pos_y, vel_x, vel_y, radius, alive, pset, closest,
            obstacle_vel, p if pos_x.dim() == 1 else as_column(p),
            use_radius, active)
    return _stacked(
        _moussaid_chunked_terms(pos_x[r], pos_y[r], vel_x[r], vel_y[r],
                                radius[r], alive[r], _segment_row(pset, r),
                                _closest_row(closest, r),
                                _crowd_row(obstacle_vel, r, 2), pr,
                                use_radius, _crowd_row(active, r, 1))
        for r, pr in enumerate(section_rows(p, pos_x.shape[0])))


def crossing_mask(mode):
    """Pedestrians on the road, for whom the border-family forces are off
    (reference forces.py:176-177)."""
    return (mode == modes.CROSSING_ROAD) | (mode == modes.ROAD_TO_SIDEWALK)


def border_force(pos_x, pos_y, mode, radius, alive, borders,
                 p: BorderParams, use_ped_radius: bool = False):
    """Exponential repulsion from the nearest point of each relevant border
    section (reference forces.py:138-179): ``a * exp(-d/b)`` away from it,
    off for pedestrians crossing the road.  ``borders`` is a
    :class:`..env.pointsets.SegmentPointSet`."""
    fx, fy = env_exp_force(pos_x, pos_y, radius, alive, borders, p.a, p.b,
                           use_radius=use_ped_radius)
    crossing = crossing_mask(mode)
    return torch.where(crossing, 0.0, fx), torch.where(crossing, 0.0, fy)


def space_repulsive_force(pos_x, pos_y, mode, alive, borders,
                          p: SpaceRepulsiveParams):
    """Helbing-Molnar (1995) boundary repulsion U(d) = u0 * exp(-d/r) from
    the nearest point of each relevant border section: the border force's
    form with ``a = u0/r``, ``b = r`` and no radii, with the same filter
    and crossing-mode rule."""
    fx, fy = env_exp_force(pos_x, pos_y, None, alive, borders,
                           p.u0 / p.r, p.r)
    crossing = crossing_mask(mode)
    return torch.where(crossing, 0.0, fx), torch.where(crossing, 0.0, fy)


def obstacle_force(pos_x, pos_y, vel_x, vel_y, radius, alive, obstacles,
                   obstacle_vel, p: MoussaidParams,
                   use_ped_radius: bool = False, obstacle_active=None):
    """Moussaid interaction force against the closest point of each
    obstacle in perception range (reference forces.py:182-283): the static
    variant (zero ``obstacle_vel``) and the dynamic one (vehicle
    velocities, ``obstacle_active`` for vehicles that exist this step)."""
    return env_moussaid_force(pos_x, pos_y, vel_x, vel_y, radius, alive,
                              obstacles, obstacle_vel, p,
                              use_radius=use_ped_radius,
                              active=obstacle_active)


def border_force_chunked(pos_x, pos_y, mode, radius, alive, borders,
                         p: BorderParams, use_ped_radius: bool = False,
                         plain: bool = False):
    """:func:`border_force` on a :class:`..env.pointsets.ChunkedPointSet`
    of tensors (the JAX package's forces.py:338-362)."""
    fx, fy = env_exp_force_chunked(pos_x, pos_y, radius, alive, borders,
                                   p.a, p.b, use_radius=use_ped_radius,
                                   plain=plain)
    crossing = crossing_mask(mode)
    return torch.where(crossing, 0.0, fx), torch.where(crossing, 0.0, fy)


def space_repulsive_force_chunked(pos_x, pos_y, mode, alive, borders,
                                  p: SpaceRepulsiveParams,
                                  plain: bool = False):
    """:func:`space_repulsive_force` on a
    :class:`..env.pointsets.ChunkedPointSet` of tensors (the JAX package's
    forces.py:471-489)."""
    fx, fy = env_exp_force_chunked(pos_x, pos_y, None, alive, borders,
                                   p.u0 / p.r, p.r, plain=plain)
    crossing = crossing_mask(mode)
    return torch.where(crossing, 0.0, fx), torch.where(crossing, 0.0, fy)


def obstacle_force_chunked(pos_x, pos_y, vel_x, vel_y, radius, alive,
                           obstacles, obstacle_vel, p: MoussaidParams,
                           use_ped_radius: bool = False,
                           obstacle_active=None, plain: bool = False):
    """:func:`obstacle_force` on a :class:`..env.pointsets.ChunkedPointSet`
    of tensors (the JAX package's forces.py:492-511): static obstacles, or
    the vehicles of ``models.vehicles.snapshot_pointset`` with
    ``obstacle_active``."""
    return env_moussaid_force_chunked(
        pos_x, pos_y, vel_x, vel_y, radius, alive, obstacles, obstacle_vel,
        p, use_radius=use_ped_radius, active=obstacle_active, plain=plain)


def chunked_environment_terms(state, scene, params, veh_snap,
                              plain: bool = False) -> dict:
    """The environment terms of ``StepConfig.env_chunked``, keyed like
    ``models.stepper.force_terms``: the JAX package's jnp environment path
    (stepper.py:319-450), each term from its own closest points over the
    scene's chunked sets on the device (``prepare_scene(chunked=True)``:
    ``borders_chunked``, ``static_obstacles_chunked``) and, for the
    vehicles, ``models.vehicles.snapshot_pointset``.  ``plain`` runs the
    plain chunk scan on a card too."""
    from ..models.vehicles import snapshot_pointset
    terms = {}
    args = (state.pos_x, state.pos_y)
    if params.enable_border and scene.borders_chunked is not None:
        terms["border_force"] = border_force_chunked(
            *args, state.mode, state.radius, state.alive,
            scene.borders_chunked, params.border,
            use_ped_radius=params.use_ped_radius, plain=plain)
    if (params.enable_static_obstacle
            and scene.static_obstacles_chunked is not None):
        terms["static_obstacle_force"] = obstacle_force_chunked(
            *args, state.vel_x, state.vel_y, state.radius, state.alive,
            scene.static_obstacles_chunked, scene.static_obstacle_vel,
            params.static_obstacle, use_ped_radius=params.use_ped_radius,
            plain=plain)
    if params.enable_space_repulsive and scene.borders_chunked is not None:
        terms["space_repulsive_force"] = space_repulsive_force_chunked(
            *args, state.mode, state.alive, scene.borders_chunked,
            params.space_repulsive, plain=plain)
    if params.enable_dynamic_obstacle and veh_snap is not None:
        vset, vvel, vact = snapshot_pointset(
            veh_snap, params.dynamic_obstacle.perception_threshold)
        terms["dynamic_obstacle_force"] = obstacle_force_chunked(
            *args, state.vel_x, state.vel_y, state.radius, state.alive,
            vset, vvel, params.dynamic_obstacle,
            use_ped_radius=params.use_ped_radius, obstacle_active=vact,
            plain=plain)
    return terms
