"""Social forces as plain, masked PyTorch functions (port of ops/forces.py).

This module is the plain PyTorch version of the kernels in ``csrc/``: the
CPU path, the reference the kernels are held against on the card, and the
parity target of the CPU tests against the JAX package.

* :func:`pedestrian_force` -- the pair-force kernels
  (``csrc/pair_forces.cu``).  The masks and zero-guards are those of the
  JAX package's ``forces._moussaid_pair_force`` (forces.py:76-113): a pair
  contributes only when both agents are alive, it is not a self pair, the
  positions differ (``d2 > 0``) and the interaction vector does not vanish
  (``B > 0``), so coincident agents give exactly zero, never NaN.
* :func:`env_exp_force` and :func:`env_moussaid_force` -- the environment
  kernels (``csrc/env_forces.cu``), on the segment-major layout they read
  (``env/pointsets.SegmentPointSet``).  :func:`border_force`,
  :func:`space_repulsive_force` and :func:`obstacle_force` are the JAX
  package's environment forces (forces.py:338-362, :471-511) on top of them.

Every function takes and returns planar ``(N,)`` x/y tensors.
"""
from __future__ import annotations

import torch

from . import vecmath
from .geometry import segment_filter_mask
from ..models import modes
from ..models.params import (AccelerationParams, BorderParams, MoussaidParams,
                             SpaceRepulsiveParams)

#: squared distances at or above this are padding (PAD_COORD = 1e8 puts a
#: padded slot ~1e16 away), not a closest point
PAD_DIST2 = 1e13


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


def pedestrian_force(pos_x, pos_y, vel_x, vel_y, radius, alive,
                     p: MoussaidParams, use_ped_radius: bool = False,
                     row_block: int = 1024):
    """Full N x N pedestrian interaction force (reference forces.py:74-117),
    planar: returns ``(fx, fy)``.

    Row-blocked so the pairwise intermediates stay ``(row_block, N)``
    regardless of the population.  Dead rows come out exactly zero.
    """
    n = pos_x.shape[0]
    col = torch.arange(n, device=pos_x.device)
    fx_out = torch.empty_like(pos_x)
    fy_out = torch.empty_like(pos_y)
    for lo in range(0, n, row_block):
        hi = min(lo + row_block, n)
        dx = pos_x[None, :] - pos_x[lo:hi, None]        # x_j - x_i
        dy = pos_y[None, :] - pos_y[lo:hi, None]
        dvx = vel_x[lo:hi, None] - vel_x[None, :]       # v_i - v_j
        dvy = vel_y[lo:hi, None] - vel_y[None, :]
        radius_sub = ((radius[lo:hi, None] + radius[None, :])
                      if use_ped_radius else 0.0)
        not_self = col[lo:hi, None] != col[None, :]
        pair_ok = alive[lo:hi, None] & alive[None, :] & not_self
        fx, fy = _moussaid_pair_force(dx, dy, radius_sub, dvx, dvy, p,
                                      pair_ok)
        fx_out[lo:hi] = fx.sum(dim=1)
        fy_out[lo:hi] = fy.sum(dim=1)
    return fx_out, fy_out


def _ped_blocks(n: int, seg, max_group_elems: int):
    """Pedestrian row blocks bounding the (S, K, rows) temporaries of the
    closest-point search to about ``max_group_elems`` elements."""
    rows = max(1, max_group_elems // max(1, seg.num_segments
                                         * seg.points_per_segment))
    return ((lo, min(lo + rows, n)) for lo in range(0, n, rows))


def _closest_points(pos_x, pos_y, seg):
    """Per (segment, ped) closest sampled point: ``(dmin2, bx, by)`` of
    shape (S, B), with the first-occurrence argmin of the reference's
    ``np.argmin``.  Padded slots sit at ``PAD_COORD``: a segment with no
    point in reach gives ``dmin2 >= PAD_DIST2``."""
    dx = seg.x[:, :, None] - pos_x[None, None, :]          # (S, K, B)
    dy = seg.y[:, :, None] - pos_y[None, None, :]
    d2 = dx * dx + dy * dy
    idx = torch.argmin(d2, dim=1)                          # (S, B), first
    dmin2 = torch.gather(d2, 1, idx[:, None, :])[:, 0, :]
    return dmin2, torch.gather(seg.x, 1, idx), torch.gather(seg.y, 1, idx)


def _segment_ok(pos_x, pos_y, alive, seg, dmin2, active):
    """(S, B) mask of the (segment, ped) pairs that contribute: a real
    closest point, inside the segment's filter circle, an alive pedestrian
    and (when given) an active segment."""
    ok = ((dmin2 < PAD_DIST2) & segment_filter_mask(pos_x, pos_y, seg)
          & alive[None, :])
    if active is not None:
        ok = ok & active[:, None]
    return ok


def env_exp_force(pos_x, pos_y, radius, alive, seg, a: float, b: float,
                  use_radius: bool = False, active=None,
                  max_group_elems: int = 4_000_000):
    """Exponential repulsion ``a * exp(-d/b)`` away from each segment's
    closest point, summed over the segments whose filter circle holds the
    pedestrian; ``(fx, fy)``.  The plain version of the ``env_exp`` kernel.

    ``d`` is the distance to the point, less the pedestrian's radius when
    ``use_radius`` (``radius`` may be None otherwise).  A pedestrian standing on a point gets 0 from it (its
    direction vector is 0), never NaN.  Dead pedestrians get exactly 0.
    """
    fx_out = torch.empty_like(pos_x)
    fy_out = torch.empty_like(pos_y)
    for lo, hi in _ped_blocks(pos_x.shape[0], seg, max_group_elems):
        px, py = pos_x[lo:hi], pos_y[lo:hi]
        dmin2, bx, by = _closest_points(px, py, seg)
        ok = _segment_ok(px, py, alive[lo:hi], seg, dmin2, active)
        dx = px[None, :] - bx                              # point -> ped
        dy = py[None, :] - by
        d2 = dx * dx + dy * dy
        r = torch.rsqrt(torch.where(d2 == 0.0, 1.0, d2))
        d = d2 * r
        if use_radius:
            d = d - radius[None, lo:hi]
        mag = torch.where(ok, (a * torch.exp(-d / b)) * r, 0.0)
        fx_out[lo:hi] = (mag * dx).sum(dim=0)
        fy_out[lo:hi] = (mag * dy).sum(dim=0)
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
        ok = _segment_ok(px, py, alive[lo:hi], seg, dmin2, active)
        dvx = vel_x[None, lo:hi] - obstacle_vel[:, 0, None]
        dvy = vel_y[None, lo:hi] - obstacle_vel[:, 1, None]
        radius_sub = radius[None, lo:hi] if use_radius else 0.0
        fx, fy = _moussaid_pair_force(bx - px[None, :], by - py[None, :],
                                      radius_sub, dvx, dvy, p, ok)
        fx_out[lo:hi] = fx.sum(dim=0)
        fy_out[lo:hi] = fy.sum(dim=0)
    return fx_out, fy_out


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
