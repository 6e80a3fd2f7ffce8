"""Geometry: the segment filter, 2-D segment intersection and the closest
wall features of the ORCA feed (port of ops/geometry.py).

``segment_filter_mask`` is the reference's coarse per-border / per-obstacle
relevance filter; the environment kernels apply the same test per
(segment, pedestrian).  ``segment_intersection_xy`` is the branchless
replacement for the Shapely calls in the reference's gap-acceptance check
(check_traffic.py:30-48).

The ORCA wall feed's (F, N) planes: :func:`feature_closest_planes` (the
exact closest point on each segment feature), :func:`closest_point_per_chunk`
(each 128-point chunk's first-occurrence closest point; on a card the
``chunk_closest`` kernel of ``csrc/statics.cu``, the JAX package's
``_cpc_kernel``) and :func:`k_smallest_features` (the ``k`` nearest, first
occurrence on ties).  ``ops/statics.py`` fuses them into one running top-k
on the card.

The JAX module's ``closest_point_per_segment`` and its ``_cp_kernel`` are
not here: the port's environment forces read the segment-major layout
(``env/pointsets.SegmentPointSet``) directly.
"""
from __future__ import annotations

import numpy as np
import torch


def closest_on_segments(pos_x, pos_y, ax, ay, ux, uy, il2):
    """Closest point ON the segments ``a + t*u`` (broadcasting planes):
    ``t = clip(((p - a) . u) * il2, 0, 1)``, then ``c = a + t*u`` and the
    squared distance ``|p - c|^2``, every operation rounded on its own as
    the kernels compute it (``closest_on_segment``, csrc/env_forces.cuh).
    Returns ``(d2, cx, cy)``.  A padding segment (``a`` at PAD_COORD,
    ``u = il2 = 0``) projects to the PAD sentinel; a single point
    (``u = il2 = 0``) to itself."""
    dxa = pos_x - ax
    dya = pos_y - ay
    t = torch.clamp((dxa * ux + dya * uy) * il2, 0.0, 1.0)
    cx = ax + t * ux
    cy = ay + t * uy
    ddx = pos_x - cx
    ddy = pos_y - cy
    return ddx * ddx + ddy * ddy, cx, cy


def squared_reach(neigh_dist: float) -> float:
    """``neigh_dist ** 2`` in float32, as the JAX package's
    ``jnp.float32(neigh_dist) ** 2`` and the kernels compare against it."""
    nd = np.float32(neigh_dist)
    return float(nd * nd)


def feature_closest_planes(pos_x, pos_y, feat, neigh_dist: float,
                           max_group_elems: int = 4_000_000):
    """Per (segment feature, pedestrian) squared distance and the exact
    closest point ON the segment (``env/pointsets.SegmentFeatures``):
    ``(d2, wx, wy)`` of shape (F, N), ``d2 = inf`` where the feature is
    farther than ``neigh_dist``.  Features are taken in blocks bounding the
    temporaries to about ``max_group_elems`` elements.  The plain version
    of the ``seg_topk`` kernel's scan (JAX package geometry.py:454-501)."""
    f, n = feat.ax.shape[0], pos_x.shape[0]
    nd2 = squared_reach(neigh_dist)
    g = max(1, min(f, max_group_elems // max(1, n)))
    parts = [closest_on_segments(pos_x[None, :], pos_y[None, :],
                                 *(a[lo:lo + g, None] for a in (
                                     feat.ax, feat.ay, feat.ux, feat.uy,
                                     feat.il2)))
             for lo in range(0, f, g)]
    if not parts:
        return (pos_x.new_empty((0, n)),) * 3
    d2, wx, wy = (torch.cat(p, dim=0) for p in zip(*parts))
    return torch.where(d2 <= nd2, d2, torch.inf), wx, wy


def chunk_closest_plain(pos_x, pos_y, chunks, neigh_dist: float,
                        max_group_elems: int = 4_000_000):
    """The plain version of the ``chunk_closest`` kernel: each chunk's
    first-occurrence closest point (the reference's ``np.argmin``), in
    groups of chunks bounding the (G, K, N) temporaries; ``d2 = inf``
    beyond ``neigh_dist``, the point written everywhere."""
    nd2 = squared_reach(neigh_dist)
    c, kk = chunks.x.shape
    n = pos_x.shape[0]
    g = max(1, min(c, max_group_elems // max(1, kk * n)))
    parts = []
    for lo in range(0, c, g):
        gx, gy = chunks.x[lo:lo + g], chunks.y[lo:lo + g]
        dx = gx[:, :, None] - pos_x[None, None, :]           # (G, K, N)
        dy = gy[:, :, None] - pos_y[None, None, :]
        d2 = dx * dx + dy * dy
        idx = torch.argmin(d2, dim=1)[:, None, :]            # first
        parts.append((torch.gather(d2, 1, idx)[:, 0],
                      torch.gather(gx[:, :, None].expand(-1, -1, n), 1,
                                   idx)[:, 0],
                      torch.gather(gy[:, :, None].expand(-1, -1, n), 1,
                                   idx)[:, 0]))
    if not parts:
        return (pos_x.new_empty((0, n)),) * 3
    d2, wx, wy = (torch.cat(p, dim=0) for p in zip(*parts))
    return torch.where(d2 <= nd2, d2, torch.inf), wx, wy


def closest_point_per_chunk(pos_x, pos_y, chunks, neigh_dist: float,
                            alive=None):
    """Per (chunk, pedestrian) squared distance and closest-point planes
    (``env/pointsets.ChunkFeatures``; the JAX package's geometry.py:
    285-361): ``(d2, wx, wy)`` of shape (C, N), ``d2 = inf`` where the
    chunk has no point within ``neigh_dist`` of the pedestrian.

    On CUDA tensors this launches the ``chunk_closest`` kernel
    (``ops/statics.chunk_closest``), which skips every chunk whose circle,
    inflated by ``neigh_dist``, misses the box of a block of 128
    pedestrians (the alive ones, where ``alive`` is given; a dead row's
    result is then undefined): a skipped chunk leaves ``wx = wy = 0``
    beside ``d2 = inf``.  On CPU tensors it runs the plain version, which
    writes the closest point everywhere."""
    if pos_x.device.type == "cuda":
        from .statics import chunk_closest
        return chunk_closest(pos_x, pos_y, chunks, neigh_dist, alive)
    return chunk_closest_plain(pos_x, pos_y, chunks, neigh_dist)


def k_smallest_features(d2, planes, k: int):
    """The ``k`` smallest of the (F, N) squared distances ``d2`` of each
    pedestrian (column), ascending, ties to the lower feature index (the
    JAX package's ``k_smallest_features``: k first-occurrence
    min-extractions; a stable sort is the same selection).  ``inf`` marks
    an invalid entry; ``planes`` are (F, N) payloads.  Returns
    ``(sel_planes, valid)`` of shape (k, N); an invalid slot's payloads
    are 0."""
    f, n = d2.shape
    if f < k:
        pad = d2.new_full((k - f, n), torch.inf)
        d2 = torch.cat([d2, pad])
        planes = tuple(torch.cat([p, torch.zeros_like(pad)]) for p in planes)
    idx = torch.sort(d2, dim=0, stable=True).indices[:k]
    valid = torch.isfinite(torch.gather(d2, 0, idx))
    return (tuple(torch.where(valid, torch.gather(p, 0, idx), 0.0)
                  for p in planes), valid)


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
