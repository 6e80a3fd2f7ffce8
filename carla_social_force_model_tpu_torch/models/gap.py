"""Vectorized gap-acceptance road-crossing check (port of models/gap.py).

Branchless replacement for the reference's Shapely-based ``check_traffic``
(check_traffic.py:7-61): a pedestrian in CHECKING_TRAFFIC may start crossing
unless a moving vehicle's swept segment (back -> front + v * (t_ped +
margin)) intersects the pedestrian's crossing segment with a
time-to-intersection conflict.

The reference applies the *first* vehicle's (x, y) extent elementwise to all
vehicles' direction vectors (check_traffic.py:35-36); the per-vehicle
longitudinal extent is used by default and the quirk is reproduced under
``strict_parity``, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..ops import vecmath
from ..ops.geometry import segment_intersection_xy


def gap_ready(pos_x, pos_y, goal_x, goal_y, crossing_speed, margin,
              veh_center, veh_vel, veh_extent, veh_active,
              strict_parity: bool = False):
    """Per-pedestrian readiness to cross, ``(N,)`` bool (``(B, N)`` for
    a batch of crowds, against one set of vehicles or each crowd's own).

    ``pos``/``goal``: the crossing segment's endpoints (current location ->
    waypoint) as ``(N,)`` planes; ``crossing_speed``, ``margin``: ``(N,)``;
    ``veh_center``, ``veh_vel``: ``(V, 2)``, or a batch of fleets' ``(B, V,
    2)``; ``veh_extent``: ``(V, 2)`` bbox half extents; ``veh_active``:
    ``(V,)`` or ``(B, V)``.  Pedestrians with a negative margin always
    cross (check_traffic.py:23-24).
    """
    speed_safe = torch.where(crossing_speed == 0.0, 1.0, crossing_speed)
    t_ped = vecmath.norm_xy(goal_x - pos_x, goal_y - pos_y) / speed_safe

    dir_x, dir_y, veh_speed = vecmath.normalize_xy(veh_vel[..., 0],
                                                   veh_vel[..., 1])
    if strict_parity:
        ext_x, ext_y = veh_extent[0, 0], veh_extent[0, 1]    # quirk
    else:
        ext_x = ext_y = veh_extent[:, 0]                     # longitudinal
    off_x, off_y = dir_x * ext_x, dir_y * ext_y
    front_x = veh_center[..., 0] + off_x
    front_y = veh_center[..., 1] + off_y
    back_x = veh_center[..., 0] - off_x
    back_y = veh_center[..., 1] - off_y

    def veh(a):
        """A vehicle plane against the (..., N, V) planes."""
        return a[..., None, :]

    # the vehicle's goal depends on the pedestrian's crossing time: (N, V)
    horizon = (t_ped + margin)[..., None]
    veh_goal_x = veh(front_x) + veh(veh_vel[..., 0]) * horizon
    veh_goal_y = veh(front_y) + veh(veh_vel[..., 1]) * horizon

    px, py = pos_x[..., None], pos_y[..., None]
    hit, ipx, ipy = segment_intersection_xy(
        px, py, goal_x[..., None], goal_y[..., None],
        veh(back_x), veh(back_y), veh_goal_x, veh_goal_y)

    tti_ped = vecmath.norm_xy(ipx - px, ipy - py) / speed_safe[..., None]
    vs_safe = veh(torch.where(veh_speed == 0.0, 1.0, veh_speed))
    tti_front = vecmath.norm_xy(ipx - veh(front_x),
                                ipy - veh(front_y)) / vs_safe
    tti_back = vecmath.norm_xy(ipx - veh(back_x),
                               ipy - veh(back_y)) / vs_safe

    blocked = (hit & veh(veh_active) & veh(veh_speed != 0.0)
               & (tti_front - margin[..., None] < tti_ped)
               & (tti_ped < tti_back + margin[..., None]))
    return (margin < 0.0) | ~blocked.any(dim=-1)
