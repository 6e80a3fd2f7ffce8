"""Geometry: the segment filter, 2-D segment intersection, the chunked
closest point of the environment forces and the closest wall features of
the ORCA feed (port of ops/geometry.py).

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

:func:`closest_point_per_segment` is the closest point of each segment of a
:class:`..env.pointsets.ChunkedPointSet` (the JAX package's function of the
same name): every 128-point chunk's first-occurrence minimum and flat
argmin, as (C, N) planes, then the segmented minimum over each segment's
chunks and the first chunk that reaches it.  On a card the chunk scan is
the ``chunk_argmin`` kernel of ``csrc/statics.cu`` (the JAX package's
``_cp_kernel``), on the CPU its plain version :func:`chunk_argmin_plain`;
``(B, N)`` planes of a batch of crowds take one scan of the flattened
pedestrians, or, where each crowd has its own chunks (a batch of fleets'
vehicles), one scan with each crowd against its own
(``chunk_argmin_percrowd`` on a card).
The scenarios' default engine reaches it through the chunked environment
forces (``ops/forces.py``, ``StepConfig.env_chunked``); the fused
environment kernels read the segment-major layout
(``env/pointsets.SegmentPointSet``) instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..env.pointsets import PAD_COORD, ChunkedPointSet
from . import vecmath

#: squared distances at or above this are padding (PAD_COORD = 1e8 puts a
#: padded slot ~1e16 away), not a closest point
PAD_DIST2 = 1e13
#: the "no chunk" sentinel of the first-chunk reduction (int32 max)
_BIG_INDEX = 2**31 - 1


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
    t = vecmath.minimum(vecmath.maximum((dxa * ux + dya * uy) * il2, 0.0),
                        1.0)
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


def reach_rows(neigh_dist):
    """The squared neighbour distance the plain wall feeds compare against:
    :func:`squared_reach` of a number, or of a sweep's ``(B,)`` tensor each
    row's float32 square as a ``(B, 1)`` column (against ``(..., B, N)``
    planes), the value the kernels read from their ``nd2`` rows and the
    JAX package's vmapped ``jnp.float32(neigh_dist) ** 2`` gives.  A 0-d
    tensor is one value: a mask's bound, through which no gradient
    passes (as in the JAX package)."""
    if isinstance(neigh_dist, torch.Tensor):
        if neigh_dist.dim() == 0:
            return squared_reach(float(neigh_dist))
        nd = neigh_dist.to(torch.float32)
        return (nd * nd)[:, None]
    return squared_reach(neigh_dist)


def feature_closest_planes(pos_x, pos_y, feat, neigh_dist,
                           max_group_elems: int = 4_000_000):
    """Per (segment feature, pedestrian) squared distance and the exact
    closest point ON the segment (``env/pointsets.SegmentFeatures``):
    ``(d2, wx, wy)`` of shape (F, N), ``d2 = inf`` where the feature is
    farther than ``neigh_dist``.  Features are taken in blocks bounding the
    temporaries to about ``max_group_elems`` elements.  The plain version
    of the ``seg_topk`` kernel's scan (JAX package geometry.py:454-501).
    A batch's ``(B, N)`` planes give (F, B, N), ``neigh_dist`` a number or
    a sweep's ``(B,)`` tensor (:func:`reach_rows`); every operation is
    per element, so row b equals the function on row b bitwise."""
    f, shape = feat.ax.shape[0], pos_x.shape
    px, py = pos_x.reshape(-1), pos_y.reshape(-1)
    n = px.shape[0]
    nd2 = reach_rows(neigh_dist)
    g = max(1, min(f, max_group_elems // max(1, n)))
    parts = [closest_on_segments(px[None, :], py[None, :],
                                 *(a[lo:lo + g, None] for a in (
                                     feat.ax, feat.ay, feat.ux, feat.uy,
                                     feat.il2)))
             for lo in range(0, f, g)]
    if not parts:
        return (pos_x.new_empty((0, *shape)),) * 3
    d2, wx, wy = (torch.cat(p, dim=0).view(f, *shape) for p in zip(*parts))
    return torch.where(d2 <= nd2, d2, torch.inf), wx, wy


def chunk_closest_plain(pos_x, pos_y, chunks, neigh_dist,
                        max_group_elems: int = 4_000_000):
    """The plain version of the ``chunk_closest`` kernel: each chunk's
    first-occurrence closest point (the reference's ``np.argmin``), in
    groups of chunks bounding the (G, K, N) temporaries; ``d2 = inf``
    beyond ``neigh_dist``, the point written everywhere.  A batch's ``(B,
    N)`` planes give (C, B, N), ``neigh_dist`` a number or a sweep's
    ``(B,)`` tensor (the layout of ``chunk_closest_batched``)."""
    nd2 = reach_rows(neigh_dist)
    c, kk = chunks.x.shape
    shape = pos_x.shape
    pos_x, pos_y = pos_x.reshape(-1), pos_y.reshape(-1)
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
        return (pos_x.new_empty((0, *shape)),) * 3
    d2, wx, wy = (torch.cat(p, dim=0).view(c, *shape) for p in zip(*parts))
    return torch.where(d2 <= nd2, d2, torch.inf), wx, wy


def closest_point_per_chunk(pos_x, pos_y, chunks, neigh_dist, alive=None):
    """Per (chunk, pedestrian) squared distance and closest-point planes
    (``env/pointsets.ChunkFeatures``; the JAX package's geometry.py:
    285-361): ``(d2, wx, wy)`` of shape (C, N), ``d2 = inf`` where the
    chunk has no point within ``neigh_dist`` of the pedestrian.

    On CUDA tensors this launches the ``chunk_closest`` kernel
    (``ops/statics.chunk_closest``), which skips every chunk whose circle,
    inflated by ``neigh_dist``, misses the box of a block of 32
    pedestrians (the alive ones, where ``alive`` is given; a dead row's
    result is then undefined): a skipped chunk leaves ``wx = wy = 0``
    beside ``d2 = inf``.  On CPU tensors it runs the plain version, which
    writes the closest point everywhere.

    A batch of crowds' ``(B, N)`` planes (``alive`` too) give (C, B, N),
    the layout of :func:`chunk_argmin` (the JAX entry under vmap):
    ``neigh_dist`` a number, or a sweep's ``(B,)`` tensor; on a card the
    ``chunk_closest_batched`` kernel, one launch for every row."""
    if pos_x.device.type == "cuda":
        from . import statics
        fn = (statics.chunk_closest if pos_x.dim() == 1
              else statics.chunk_closest_batched)
        return fn(pos_x, pos_y, chunks, neigh_dist, alive)
    return chunk_closest_plain(pos_x, pos_y, chunks, neigh_dist)


def k_smallest_features(d2, planes, k: int):
    """The ``k`` smallest of the (F, N) squared distances ``d2`` of each
    pedestrian (column), ascending, ties to the lower feature index (the
    JAX package's ``k_smallest_features``: k first-occurrence
    min-extractions; a stable sort is the same selection).  ``inf`` marks
    an invalid entry; ``planes`` are (F, N) payloads.  Returns
    ``(sel_planes, valid)`` of shape (k, N); an invalid slot's payloads
    are 0.  A leading batch axis, ``(B, F, N)``, gives ``(B, k, N)``."""
    *lead, f, n = d2.shape
    if f < k:
        pad = d2.new_full((*lead, k - f, n), torch.inf)
        d2 = torch.cat([d2, pad], dim=-2)
        planes = tuple(torch.cat([p, torch.zeros_like(pad)], dim=-2)
                       for p in planes)
    idx = torch.sort(d2, dim=-2, stable=True).indices[..., :k, :]
    valid = torch.isfinite(torch.gather(d2, -2, idx))
    return (tuple(torch.where(valid, torch.gather(p, -2, idx), 0.0)
                  for p in planes), valid)


def staged_chunk_planes(pset: ChunkedPointSet):
    """The (C, K) x/y planes the chunk scan reads: each chunk's points with
    its invalid slots moved to ``PAD_COORD`` (live templates of inactive
    vehicles keep real coordinates with ``valid`` False; the JAX package's
    geometry.py:159-166)."""
    return (torch.where(pset.valid, pset.points[..., 0], PAD_COORD),
            torch.where(pset.valid, pset.points[..., 1], PAD_COORD))


def chunk_argmin_plain(pos_x, pos_y, fx, fy,
                       max_group_elems: int = 4_000_000):
    """The plain version of the ``chunk_argmin`` kernel: for every (chunk,
    pedestrian), the minimum of ``dx*dx + dy*dy`` over the chunk's points
    of the staged planes ``fx, fy`` (C, K) and the global flat index
    ``c*K + j`` of the first point that reaches it (the reference's
    ``np.argmin``; the JAX package's ``_cp_kernel``).  Returns ``(dmin,
    idx)`` of shape (C, N), float32 and int32.  Pedestrians are taken in
    blocks bounding the (C, K, B) temporaries to about ``max_group_elems``
    elements."""
    c, k = fx.shape
    n = pos_x.shape[0]
    dmin = torch.empty((c, n), dtype=torch.float32, device=pos_x.device)
    idx = torch.empty((c, n), dtype=torch.int32, device=pos_x.device)
    base = (torch.arange(c, dtype=torch.int64, device=pos_x.device)
            * k)[:, None]
    rows = max(1, max_group_elems // max(1, c * k))
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        dx = fx[:, :, None] - pos_x[None, None, lo:hi]        # (C, K, B)
        dy = fy[:, :, None] - pos_y[None, None, lo:hi]
        d2 = dx * dx + dy * dy
        first = torch.argmin(d2, dim=1)                        # (C, B)
        dmin[:, lo:hi] = torch.gather(d2, 1, first[:, None, :])[:, 0, :]
        idx[:, lo:hi] = (base + first).to(torch.int32)
    return dmin, idx


def chunk_argmin(pos_x, pos_y, fx, fy, plain: bool = False):
    """Per (chunk, pedestrian) minimum squared distance and flat argmin
    (:func:`chunk_argmin_plain`'s ``(dmin, idx)``).  On CUDA tensors the
    ``chunk_argmin`` kernel (``ops/statics.chunk_argmin``), bitwise equal to
    the plain version; on CPU tensors, or with ``plain``, the plain
    version.  ``(B, N)`` planes (a batch of crowds) give ``(C, B, N)``: one
    launch over the flattened planes (``ops/statics.chunk_argmin_batched``),
    or the plain version on them.  ``(B, C, K)`` planes ``fx, fy`` (each
    crowd's own chunks) give the same layout, crowd b's indices into its own
    planes: one launch of ``ops/statics.chunk_argmin_percrowd``, or the
    plain version row by row."""
    if pos_x.device.type == "cuda" and not plain:
        from . import statics
        fn = statics.chunk_argmin if pos_x.dim() == 1 else (
            statics.chunk_argmin_batched if fx.dim() == 2
            else statics.chunk_argmin_percrowd)
        return fn(pos_x, pos_y, fx, fy)
    if fx.dim() == 3:
        rows = [chunk_argmin_plain(pos_x[b], pos_y[b], fx[b], fy[b])
                for b in range(pos_x.shape[0])]
        return tuple(torch.stack(r, dim=1) for r in zip(*rows))
    dmin, idx = chunk_argmin_plain(pos_x.reshape(-1), pos_y.reshape(-1),
                                   fx, fy)
    return (dmin.view(fx.shape[0], *pos_x.shape),
            idx.view(fx.shape[0], *pos_x.shape))


def closest_point_per_segment(pos_x, pos_y, pset: ChunkedPointSet,
                              plain: bool = False):
    """Per (segment, pedestrian) closest outline point of a
    :class:`..env.pointsets.ChunkedPointSet` of tensors on the pedestrians'
    device (the JAX package's ``closest_point_per_segment`` with its chunk
    scan ``_cp_kernel``, geometry.py:36-211).

    The chunk scan (:func:`chunk_argmin`) gives each chunk's minimum and
    first-occurrence flat index; the segmented minimum over each segment's
    chunks and the first chunk that reaches it follow, so ties go to the
    lower chunk and, within it, to the lower point (the reference's
    ``np.argmin`` over the segment).  Returns ``(dist, bx, by, has_point)``
    of shape (S, N): ``has_point`` is False where no real point is within
    reach (``dmin^2 >= PAD_DIST2``: a segment with no valid point, or a
    pedestrian parked at the dead sentinel), and ``dist`` is 0 there.  The
    point is the set's own coordinate, as the JAX package gathers it.
    ``plain`` runs the plain chunk scan on a card too.

    ``(B, N)`` planes (a batch of crowds against the one set) give ``(S,
    B, N)``: one scan of the flattened pedestrians, then the segmented
    minimum along the flattened axis; a set of each crowd's own chunks
    (``env/pointsets.per_crowd``, a batch of fleets' vehicles) one scan of
    each crowd against its own, each point gathered from its crowd's set.
    Every step is exact (differences, products, sums, minima, gathers, a
    square root), so row b equals the function on row b (and its own set)
    bitwise."""
    c, k = pset.valid.shape[-2:]
    s, shape = pset.num_segments, pos_x.shape
    fx, fy = staged_chunk_planes(pset)
    dmin, idx = chunk_argmin(pos_x, pos_y, fx.contiguous(), fy.contiguous(),
                             plain=plain)
    dmin, idx = dmin.reshape(c, -1), idx.reshape(c, -1)
    n = dmin.shape[1]
    seg = pset.chunk_segment.to(torch.int64)[:, None].expand(c, n)
    dseg2 = pos_x.new_full((s, n), torch.inf).scatter_reduce(
        0, seg, dmin, "amin")
    chunk = torch.arange(c, dtype=torch.int64, device=pos_x.device)[:, None]
    cand = torch.where(dmin == torch.gather(dseg2, 0, seg), chunk,
                       _BIG_INDEX)
    first = torch.full((s, n), _BIG_INDEX, dtype=torch.int64,
                       device=pos_x.device).scatter_reduce(0, seg, cand,
                                                           "amin")
    has_point = (dseg2 < PAD_DIST2) & (first < _BIG_INDEX)
    flat = torch.gather(idx, 0, first.clamp(0, max(c - 1, 0))).to(
        torch.int64)
    if pset.points.dim() == 4:
        # crowd b's indices into its own planes, at b * C * K of the set's
        crowd = torch.arange(shape[0], device=pos_x.device) * (c * k)
        flat = flat + crowd.repeat_interleave(shape[1])
    bx = pset.points[..., 0].reshape(-1)[flat]
    by = pset.points[..., 1].reshape(-1)[flat]
    dist = torch.sqrt(torch.where(has_point, dseg2, 0.0))
    return tuple(t.view(s, *shape) for t in (dist, bx, by, has_point))


def segment_filter_mask(pos_x, pos_y, pset):
    """Per-(segment, ped) relevance filter ``|pos - center| < radius``,
    ``(S, N)`` bool; ``(S, B, N)`` for ``(B, N)`` planes, whose rows may
    have their own radii (``(B, S)``) and centers (``(B, S)``: a batch of
    fleets' vehicles).

    Matches the reference's border section filter (forces.py:149-151) and
    the obstacle perception filter (forces.py:222-224), both strict ``<``,
    as a squared comparison with the radius clamped at 0.  ``pset`` is a
    :class:`..env.pointsets.SegmentPointSet` (or another set with
    ``center_x``/``center_y`` planes) or a
    :class:`..env.pointsets.ChunkedPointSet` of tensors (``centers``, the
    JAX package's geometry.py:531-543).
    """
    if isinstance(pset, ChunkedPointSet):
        cx, cy = pset.centers[..., 0], pset.centers[..., 1]
    else:
        cx, cy = pset.center_x, pset.center_y
    dx = section_column(cx, pos_x) - pos_x[None]
    dy = section_column(cy, pos_y) - pos_y[None]
    d2 = dx * dx + dy * dy
    r = torch.clamp(pset.filter_radius, min=0.0)
    return d2 < section_column(r * r, pos_x)


def section_column(t, pos):
    """A per-section plane, ``(S,)`` or per row ``(B, S)``, laid against
    ``(N,)`` or ``(B, N)`` pedestrian planes: ``(S, 1)``, ``(S, 1, 1)`` or
    ``(S, B, 1)``."""
    if t.dim() == 2:
        return t.t()[:, :, None]
    return t.view(-1, *(1,) * pos.dim())


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
