"""Geometry: the segment filter and 2-D segment intersection (port of the
plain parts of ops/geometry.py).

``segment_filter_mask`` is the reference's coarse per-border / per-obstacle
relevance filter; the environment kernels apply the same test per
(segment, pedestrian).  ``segment_intersection_xy`` is the branchless
replacement for the Shapely calls in the reference's gap-acceptance check
(check_traffic.py:30-48).

The JAX module's chunked closest-point path and its two TPU kernels
(``_cp_kernel``, ``_cpc_kernel``) are not here: the port's environment
forces read the segment-major layout (``env/pointsets.SegmentPointSet``)
directly, and the ORCA feed that ``_cpc_kernel`` serves belongs to a later
slice.
"""
from __future__ import annotations

import torch


def segment_filter_mask(pos_x, pos_y, pset):
    """Per-(segment, ped) relevance filter ``|pos - center| < radius``,
    ``(S, N)`` bool.

    Matches the reference's border section filter (forces.py:149-151) and
    the obstacle perception filter (forces.py:222-224), both strict ``<``,
    as a squared comparison with the radius clamped at 0.  ``pset`` is a
    :class:`..env.pointsets.SegmentPointSet`.
    """
    dx = pset.center_x[:, None] - pos_x[None, :]
    dy = pset.center_y[:, None] - pos_y[None, :]
    d2 = dx * dx + dy * dy
    r = torch.clamp(pset.filter_radius, min=0.0)
    return d2 < (r * r)[:, None]


def segment_intersection_xy(p0x, p0y, p1x, p1y, q0x, q0y, q1x, q1y,
                            eps: float = 0.0):
    """Intersection of segments ``[p0, p1]`` and ``[q0, q1]`` on x/y planes
    (broadcasting).  Returns ``(hit, ipx, ipy)`` with the intersection
    coordinates zeroed where there is no hit.  Parallel and collinear
    segments report no hit (the reference delegates those measure-zero
    cases to Shapely)."""
    rx, ry = p1x - p0x, p1y - p0y
    sx, sy = q1x - q0x, q1y - q0y
    denom = rx * sy - ry * sx
    qpx, qpy = q0x - p0x, q0y - p0y
    t_num = qpx * sy - qpy * sx
    u_num = qpx * ry - qpy * rx
    safe = torch.where(denom == 0.0, 1.0, denom)
    t = t_num / safe
    u = u_num / safe
    hit = ((denom != 0.0) & (t >= -eps) & (t <= 1.0 + eps)
           & (u >= -eps) & (u <= 1.0 + eps))
    ipx = torch.where(hit, p0x + t * rx, 0.0)
    ipy = torch.where(hit, p0y + t * ry, 0.0)
    return hit, ipx, ipy


def segment_intersection(p0, p1, q0, q1, eps: float = 0.0):
    """:func:`segment_intersection_xy` on ``(..., 2)`` tensors: returns
    ``(hit, point)`` with ``point`` zero where there is no hit."""
    hit, ipx, ipy = segment_intersection_xy(
        p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1],
        q0[..., 0], q0[..., 1], q1[..., 0], q1[..., 1], eps=eps)
    return hit, torch.stack([ipx, ipy], dim=-1)
