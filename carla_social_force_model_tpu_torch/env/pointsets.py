"""Point-cloud containers for borders and obstacles (port of env/pointsets.py).

The reference stores border and obstacle outlines as ragged lists of numpy
arrays and takes, per pedestrian and per outline, the single closest sampled
point (forces.py:145-155, :217-229).  Two layouts carry them here:

* :class:`ChunkedPointSet` -- the host-side packing the JAX package builds
  from a scenario: all points of all segments (a segment = one border
  section or one obstacle outline) in fixed-size chunks with a per-chunk
  segment id.  numpy arrays, equal to the JAX package's for the same input.
* :class:`SegmentPointSet` -- the segment-major layout the environment
  kernels (``csrc/env_forces.cu``) and their plain versions
  (``ops/forces.py``) read: one ``PAD_COORD``-padded row of points per
  segment, as x and y planes on the device.  Within a row the
  first-occurrence argmin is the reference's ``np.argmin``.

:func:`segment_major` turns the first into the second, and
:func:`chunked_on` moves the first to the device as tensors (the layout the
chunked environment forces read: ``ops/geometry.closest_point_per_segment``).  The JAX package caps
a row at 4,096 points (a TPU VMEM limit, beyond which it keeps the chunked
path); the CUDA kernels stage a row in fixed pieces, so here any row length
is taken and there is no second path.

Two more layouts carry the line-segment form of the same walls, built on
the host from a Douglas-Peucker simplification of each section
(:func:`analytic_split`, with the JAX package's safety gates) and moved to
the device once:

* :class:`SegmentGeomSet` -- up to ``M`` segments per section, the
  ``env_analytic`` border tier's geometry: the closest point of a section is
  taken exactly ON its segments.  Sections that do not simplify stay
  sampled (the split's remainder, a :class:`ChunkedPointSet`).
* :class:`StaticFeatures` -- the ORCA wall feed
  (:func:`build_static_features`): flat :class:`SegmentFeatures` (one
  feature per segment) for the sections that simplify, and
  :class:`ChunkFeatures` (one feature per 128-point chunk of the sampled
  remainder) for the rest.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device

#: coordinate written into padding slots (never the nearest point)
PAD_COORD = 1.0e8


@dataclass(frozen=True)
class ChunkedPointSet:
    """``num_segments`` point-sampled outlines in fixed-size chunks.

    ``centers``/``filter_radius`` drive the reference's coarse relevance
    filters: for sidewalk borders the section center/length pair
    (forces.py:149-151), for obstacles the center and the perception
    threshold (forces.py:222-224).  Built on the host by
    :func:`build_chunked_pointset` (numpy arrays); the per-step vehicle set
    of :func:`..models.vehicles.snapshot_pointset` holds tensors instead,
    and a batch of fleets' set holds each crowd's own vehicles: points
    ``(B, C, K, 2)``, valid ``(B, C, K)``, centers ``(B, S, 2)`` and radii
    ``(S,)`` or ``(B, S)``, with ``chunk_segment`` shared
    (:func:`per_crowd`).
    """

    points: np.ndarray         # (C, K, 2) f32, padded with PAD_COORD
    valid: np.ndarray          # (C, K) bool
    chunk_segment: np.ndarray  # (C,) int32 segment id per chunk
    centers: np.ndarray        # (S, 2) per-segment filter center
    filter_radius: np.ndarray  # (S,) per-segment filter radius
    num_segments: int

    @property
    def num_chunks(self) -> int:
        return self.points.shape[-3]

    @property
    def chunk_size(self) -> int:
        return self.points.shape[-2]


@dataclass(frozen=True)
class SegmentPointSet:
    """Segment-major point layout: one fixed-size row per segment.

    ``x[s]``/``y[s]`` hold the sampled points of segment ``s`` in their
    original order, padded with ``PAD_COORD`` to a common ``K`` (a multiple
    of the chunk size).  Planar, as the kernels read them.  ``lengths[s]``
    is the number of real points of row ``s``, all before its padding:
    the environment kernels scan no further (a padding slot is never the
    closest point).  None (the per-step vehicle rows) means every slot.
    A batch of fleets' vehicle rows are each crowd's own: x, y ``(B, S,
    K)``, centers ``(B, S)`` and radii ``(S,)`` or ``(B, S)``
    (:func:`per_crowd`).
    """

    x: torch.Tensor              # (S, K) f32, PAD_COORD in padding slots
    y: torch.Tensor              # (S, K)
    center_x: torch.Tensor       # (S,) per-segment filter center
    center_y: torch.Tensor       # (S,)
    filter_radius: torch.Tensor  # (S,) per-segment filter radius
    lengths: torch.Tensor | None = None  # (S,) int32 real points per row

    @property
    def num_segments(self) -> int:
        return self.x.shape[-2]

    @property
    def points_per_segment(self) -> int:
        return self.x.shape[-1]

    @property
    def points(self) -> torch.Tensor:
        """(S, K, 2) assembly view (host-side consumers and tests)."""
        return torch.stack([self.x, self.y], dim=-1)

    @property
    def centers(self) -> torch.Tensor:
        """(S, 2) assembly view."""
        return torch.stack([self.center_x, self.center_y], dim=-1)


def per_crowd(pset) -> bool:
    """Whether a point set (:class:`SegmentPointSet` or a
    :class:`ChunkedPointSet` of tensors) holds each crowd of a batch's own
    geometry (a batch of fleets' vehicles) rather than one set that every
    crowd reads."""
    if isinstance(pset, SegmentPointSet):
        return pset.x.dim() == 3
    return isinstance(pset, ChunkedPointSet) and pset.points.ndim == 4


@dataclass(frozen=True)
class SegmentGeomSet:
    """Analytic per-section line-segment geometry (the ``env_analytic``
    border tier, ``csrc/env_forces.cu``'s analytic scan).

    Each section is up to ``M`` line segments (the Douglas-Peucker vertices
    of its sampled polyline): start ``(ax, ay)``, vector ``(ux, uy)`` and
    ``inv_len2`` = 1/|u|^2, as (S, M) planes on the device.  Padding
    segments carry ``ax = ay = PAD_COORD`` and ``ux = uy = inv_len2 = 0``, so
    their closest point is the PAD sentinel; a single-point section is one
    segment with ``ux = uy = inv_len2 = 0`` whose closest point is the point
    itself.  The filter circle of each section is the sampled set's.
    ``lengths[s]``: the real segments of row ``s``, all before its padding
    (None: every slot), as :class:`SegmentPointSet`'s."""

    ax: torch.Tensor             # (S, M) f32 segment start x, PAD_COORD pad
    ay: torch.Tensor             # (S, M)
    ux: torch.Tensor             # (S, M) segment vector (b - a) x, 0 pad
    uy: torch.Tensor             # (S, M)
    inv_len2: torch.Tensor       # (S, M) 1/|u|^2 (0: degenerate or padding)
    center_x: torch.Tensor       # (S,) per-section filter center
    center_y: torch.Tensor       # (S,)
    filter_radius: torch.Tensor  # (S,) per-section filter radius
    lengths: torch.Tensor | None = None  # (S,) int32 real segments per row

    @property
    def num_segments(self) -> int:
        return self.ax.shape[0]

    @property
    def max_segments(self) -> int:
        return self.ax.shape[1]

    @property
    def centers(self) -> torch.Tensor:
        """(S, 2) assembly view."""
        return torch.stack([self.center_x, self.center_y], dim=-1)


@dataclass(frozen=True)
class SegmentFeatures:
    """Flat line-segment wall features, the ORCA feed of the walls that
    simplify: one feature per Douglas-Peucker segment, so a straight wall is
    one exact half-plane and a corner within a section two.  ``(ccx, ccy,
    rad)`` is each feature's filter circle (segment midpoint, half length),
    which the top-k kernel inflates by the neighbour distance to skip
    features.  Single-point features carry ``ux = uy = il2 = 0`` and
    ``rad = 0``.  (F,) planes on the device."""

    ax: torch.Tensor    # (F,) f32 segment start x
    ay: torch.Tensor
    ux: torch.Tensor    # (F,) segment vector (b - a)
    uy: torch.Tensor
    il2: torch.Tensor   # (F,) 1/|u|^2 (0 for single points)
    ccx: torch.Tensor   # (F,) filter-circle centre
    ccy: torch.Tensor
    rad: torch.Tensor   # (F,) filter-circle radius (not inflated)

    @property
    def num_features(self) -> int:
        return self.ax.shape[0]


@dataclass(frozen=True)
class ChunkFeatures:
    """A :class:`ChunkedPointSet` as the ORCA feed reads it: one feature per
    chunk (its first-occurrence closest point), the chunks' points as
    ``(C, K)`` x/y planes on the device with invalid slots at ``PAD_COORD``,
    and each chunk's filter circle (the centre and half diagonal of its
    valid points' box; ``radius = -1`` for a chunk with no valid point).
    ``lengths[c]``: the slots of chunk ``c`` up to its last valid one (0
    for an empty chunk), where the chunk top-k kernel's scan stops."""

    x: torch.Tensor              # (C, K) f32, PAD_COORD in invalid slots
    y: torch.Tensor
    center_x: torch.Tensor       # (C,)
    center_y: torch.Tensor
    radius: torch.Tensor         # (C,) -1 for empty chunks
    lengths: torch.Tensor        # (C,) int32 slots to scan

    @property
    def num_chunks(self) -> int:
        return self.x.shape[0]

    @property
    def chunk_size(self) -> int:
        return self.x.shape[1]


@dataclass(frozen=True)
class StaticFeatures:
    """The ORCA wall feed of one point set (:func:`build_static_features`):
    analytic segment features for every section that simplifies safely,
    and the chunks of the sampled remainder, so no geometry is lost."""

    seg: SegmentFeatures | None = None
    rest: ChunkFeatures | None = None


def _per_segment_points(pset: ChunkedPointSet) -> list[np.ndarray]:
    """Each segment's valid points in original order (host-side)."""
    pts = np.asarray(pset.points)
    valid = np.asarray(pset.valid)
    seg = np.asarray(pset.chunk_segment)
    per_seg: list[np.ndarray] = [np.zeros((0, 2), pts.dtype)
                                 for _ in range(pset.num_segments)]
    for c in range(pts.shape[0]):
        v = valid[c]
        if v.any():
            per_seg[seg[c]] = np.concatenate([per_seg[seg[c]], pts[c][v]],
                                             axis=0)
    return per_seg


def segment_major(pset: ChunkedPointSet | None,
                  device: torch.device | str = DEFAULT_DEVICE
                  ) -> SegmentPointSet | None:
    """Repack a host-side :class:`ChunkedPointSet` into the segment-major
    layout on ``device``, or None when the set is None or holds no point.

    The row length ``K`` is the longest segment rounded up to the chunk
    size, with no upper bound.  Scene builders call this once per scenario
    through :func:`..models.stepper.prepare_scene`.
    """
    if pset is None:
        return None
    device = resolve_device(device)
    per_seg = _per_segment_points(pset)
    longest = max((p.shape[0] for p in per_seg), default=0)
    if longest == 0:
        return None
    k_chunk = pset.chunk_size
    k = -(-longest // k_chunk) * k_chunk
    out = np.full((pset.num_segments, k, 2), PAD_COORD,
                  np.asarray(pset.points).dtype)
    for si, p in enumerate(per_seg):
        out[si, : p.shape[0]] = p
    lengths = np.array([p.shape[0] for p in per_seg], np.int32)
    centers = np.asarray(pset.centers)
    return SegmentPointSet(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in (out[..., 0], out[..., 1], centers[:, 0], centers[:, 1],
                    np.asarray(pset.filter_radius), lengths)))


def chunked_on(pset: ChunkedPointSet | None,
               device: torch.device | str = DEFAULT_DEVICE
               ) -> ChunkedPointSet | None:
    """A host-side :class:`ChunkedPointSet` with every array moved to
    ``device`` as a tensor (``chunk_segment`` as int64), the form
    ``ops/geometry.closest_point_per_segment`` reads; None for None.
    Scenes take this once per scenario through
    :func:`..models.stepper.prepare_scene` with ``chunked``."""
    if pset is None:
        return None
    device = resolve_device(device)
    points, valid, seg, centers, radius = _on(
        device, np.asarray(pset.points, np.float32), np.asarray(pset.valid),
        np.asarray(pset.chunk_segment, np.int64),
        np.asarray(pset.centers, np.float32),
        np.asarray(pset.filter_radius, np.float32))
    return ChunkedPointSet(points=points, valid=valid, chunk_segment=seg,
                           centers=centers, filter_radius=radius,
                           num_segments=pset.num_segments)


def _on(device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def chunk_features(pset: ChunkedPointSet,
                   device: torch.device | str = DEFAULT_DEVICE
                   ) -> ChunkFeatures:
    """The ORCA chunk feed of a host-side :class:`ChunkedPointSet` on
    ``device``: invalid slots moved to ``PAD_COORD`` and each chunk's
    filter circle, in float32 as the JAX package's Pallas chunk feed
    computes them (ops/geometry.py:381-396 of that package), and each
    chunk's length up to its last valid slot."""
    device = resolve_device(device)
    pts = np.asarray(pset.points, np.float32)
    valid = np.asarray(pset.valid)
    fx = np.where(valid, pts[..., 0], np.float32(PAD_COORD))
    fy = np.where(valid, pts[..., 1], np.float32(PAD_COORD))
    inf = np.float32(np.inf)
    lo_x = np.where(valid, fx, inf).min(axis=1)
    hi_x = np.where(valid, fx, -inf).max(axis=1)
    lo_y = np.where(valid, fy, inf).min(axis=1)
    hi_y = np.where(valid, fy, -inf).max(axis=1)
    real = valid.any(axis=1)
    half = np.float32(0.5)
    with np.errstate(invalid="ignore"):
        cx = np.where(real, half * (lo_x + hi_x), np.float32(0.0))
        cy = np.where(real, half * (lo_y + hi_y), np.float32(0.0))
        rad = np.where(real, np.sqrt(np.square(half * (hi_x - lo_x))
                                     + np.square(half * (hi_y - lo_y))),
                       np.float32(-1.0))
    k = valid.shape[1]
    lengths = np.where(real, k - np.argmax(valid[:, ::-1], axis=1),
                       0).astype(np.int32)
    return ChunkFeatures(*_on(device, fx, fy, cx.astype(np.float32),
                              cy.astype(np.float32), rad.astype(np.float32),
                              lengths))


def segment_features(gset: SegmentGeomSet | None) -> SegmentFeatures | None:
    """Flatten a per-section :class:`SegmentGeomSet` into flat
    :class:`SegmentFeatures` on its device (host-side float32 arithmetic,
    as the JAX package's ``segment_features``); None when no segment is
    real."""
    if gset is None:
        return None
    ax, ay, ux, uy, il2 = (t.cpu().numpy().astype(np.float32).reshape(-1)
                           for t in (gset.ax, gset.ay, gset.ux, gset.uy,
                                     gset.inv_len2))
    real = ax < PAD_COORD / 2          # padding rows carry ax = PAD_COORD
    if not real.any():
        return None
    ax, ay, ux, uy, il2 = (v[real] for v in (ax, ay, ux, uy, il2))
    return SegmentFeatures(*_on(
        gset.ax.device, ax, ay, ux, uy, il2, ax + 0.5 * ux, ay + 0.5 * uy,
        0.5 * np.sqrt(ux * ux + uy * uy)))


def build_static_features(pset: ChunkedPointSet | None,
                          device: torch.device | str = DEFAULT_DEVICE,
                          tol: float = 1e-3, max_segments: int = 8
                          ) -> StaticFeatures | None:
    """The ORCA wall feed of a host-side point set on ``device``:
    :func:`analytic_split` (the same safety gates), its analytic part
    flattened to :class:`SegmentFeatures` and its sampled remainder as
    :class:`ChunkFeatures`.  A set with no real point at all keeps its
    chunks, as the JAX package does."""
    if pset is None:
        return None
    gset, rest = analytic_split(pset, tol=tol, max_segments=max_segments,
                                device=device)
    seg = segment_features(gset)
    if seg is None and rest is None:
        rest = pset
    return StaticFeatures(
        seg=seg, rest=None if rest is None else chunk_features(rest, device))


def _douglas_peucker(pts: np.ndarray, tol: float) -> np.ndarray:
    """Indices of the Douglas-Peucker-simplified vertices of a polyline.

    Iterative (stack-based); keeps the first and last point and every point
    whose perpendicular distance to the current chord exceeds ``tol``.
    """
    n = pts.shape[0]
    keep = np.zeros((n,), dtype=bool)
    keep[0] = keep[n - 1] = True
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if j <= i + 1:
            continue
        a, b = pts[i], pts[j]
        u = b - a
        seg = pts[i + 1: j] - a
        len2 = float(u @ u)
        if len2 == 0.0:
            d2 = np.einsum("ij,ij->i", seg, seg)
        else:
            cross = seg[:, 0] * u[1] - seg[:, 1] * u[0]
            d2 = cross * cross / len2
        k = int(np.argmax(d2))
        if d2[k] > tol * tol:
            m = i + 1 + k
            keep[m] = True
            stack.append((i, m))
            stack.append((m, j))
    return np.flatnonzero(keep)


def _chain_covers(p: np.ndarray, verts: np.ndarray, tol: float) -> bool:
    """Is every point of ``p`` within ``tol`` of the polyline ``verts``
    (distance to the SEGMENTS, not their infinite lines)?  Douglas-Peucker
    only bounds the distance to chord lines, so a collinear out-and-back
    section ([(0,0)..(10,0),(10,0)..(5,0)] simplifies to (0,0)-(5,0))
    passes it but leaves sampled points far from the simplified chain."""
    a, b = verts[:-1], verts[1:]
    u = b - a                                                # (M, 2)
    l2 = np.einsum("ij,ij->i", u, u)
    d = p[:, None, :] - a[None, :, :]                        # (P, M, 2)
    t = np.clip(np.einsum("pmi,mi->pm", d, u)
                / np.where(l2 > 0, l2, 1.0), 0.0, 1.0)
    c = a[None] + t[..., None] * u[None]
    d2 = np.sum((p[:, None, :] - c) ** 2, axis=-1)
    return bool(np.sqrt(d2.min(axis=1)).max() <= tol)


def analytic_split(pset: ChunkedPointSet | None, tol: float = 1e-3,
                   max_segments: int = 8,
                   device: torch.device | str = DEFAULT_DEVICE,
                   ) -> tuple[SegmentGeomSet | None, ChunkedPointSet | None]:
    """Split a host-side point set into (analytic geometry on ``device``,
    host-side sampled remainder).

    Sections whose sampled points form a connected polyline AND
    Douglas-Peucker-simplify (at ``tol`` meters) to at most
    ``max_segments`` segments become a :class:`SegmentGeomSet`; the rest
    stay sampled (tightly curved outlines such as 0.1 m-sampled ellipses,
    and every section where the polyline assumption is unsafe).  The safety
    gates (sections are point clouds under the reference's argmin, with no
    connectivity contract):

    * a jump between consecutive points larger than 4x the median spacing
      (at least 0.5 m) means a multi-piece or reordered section: a chord
      across it would make a wall the sampled argmin never sees;
    * every sampled point must lie within ``tol`` of the simplified chain's
      segments (:func:`_chain_covers`).

    ``M`` is the longest chain rounded up to a multiple of 8, as in the JAX
    package, whose arrays these equal.  The environment force is a sum over
    sections, so the two parts are evaluated apart and added."""
    if pset is None:
        return None, None
    centers = np.asarray(pset.centers)
    radius = np.asarray(pset.filter_radius)
    per_seg = _per_segment_points(pset)

    geom: list[tuple[int, np.ndarray]] = []   # (section, (V, 2) vertices)
    rest: list[int] = []
    for si, p in enumerate(per_seg):
        if p.shape[0] == 0:
            continue
        if p.shape[0] == 1:
            geom.append((si, p))
            continue
        p64 = p.astype(np.float64)
        gaps = np.sqrt(np.sum(np.diff(p64, axis=0) ** 2, axis=1))
        if gaps.max() > max(4.0 * float(np.median(gaps)), 0.5):
            rest.append(si)
            continue
        idx = _douglas_peucker(p64, tol)
        if (idx.shape[0] - 1 <= max_segments
                and _chain_covers(p64, p64[idx], max(tol, 1e-6))):
            geom.append((si, p[idx]))
        else:
            rest.append(si)

    gset = None
    if geom:
        m = max(1, max(v.shape[0] - 1 for _, v in geom))
        m = -(-m // 8) * 8
        s_g = len(geom)
        ax = np.full((s_g, m), PAD_COORD, np.float32)
        ay = np.full((s_g, m), PAD_COORD, np.float32)
        ux = np.zeros((s_g, m), np.float32)
        uy = np.zeros((s_g, m), np.float32)
        il2 = np.zeros((s_g, m), np.float32)
        c_g = np.zeros((s_g, 2), np.float32)
        r_g = np.zeros((s_g,), np.float32)
        n_g = np.array([max(v.shape[0] - 1, 1) for _, v in geom], np.int32)
        for row, (si, v) in enumerate(geom):
            nv = v.shape[0]
            if nv == 1:                        # single-point section
                ax[row, 0], ay[row, 0] = v[0]
            else:
                a, b = v[:-1], v[1:]
                u = b - a
                l2 = np.einsum("ij,ij->i", u, u)
                ax[row, : nv - 1] = a[:, 0]
                ay[row, : nv - 1] = a[:, 1]
                ux[row, : nv - 1] = u[:, 0]
                uy[row, : nv - 1] = u[:, 1]
                il2[row, : nv - 1] = np.where(l2 > 0.0, 1.0 / np.maximum(
                    l2, 1e-30), 0.0)
            c_g[row] = centers[si]
            r_g[row] = radius[si]
        gset = SegmentGeomSet(*_on(resolve_device(device), ax, ay, ux, uy,
                                   il2, c_g[:, 0], c_g[:, 1], r_g, n_g))

    rset = None
    if rest:
        rset = build_chunked_pointset(
            [per_seg[si] for si in rest], centers[rest], radius[rest],
            chunk_size=pset.chunk_size)
    return gset, rset


def build_chunked_pointset(
    point_lists: Sequence[np.ndarray],
    centers: np.ndarray,
    filter_radius: np.ndarray,
    chunk_size: int = 128,
    dtype=np.float32,
) -> ChunkedPointSet:
    """Pack ragged per-segment point arrays into a :class:`ChunkedPointSet`.

    ``point_lists[s]`` is an ``(P_s, 2)`` array of sampled outline points of
    segment ``s`` (may be empty).  Point order within a segment is preserved
    so closest-point tie-breaking matches the reference's ``np.argmin``.
    """
    num_segments = len(point_lists)
    chunks = []
    valids = []
    seg_ids = []
    for s, pts in enumerate(point_lists):
        pts = np.asarray(pts, dtype=dtype).reshape(-1, 2)
        n = pts.shape[0]
        if n == 0:
            continue
        n_chunks = -(-n // chunk_size)
        padded = np.full((n_chunks * chunk_size, 2), PAD_COORD, dtype=dtype)
        padded[:n] = pts
        v = np.zeros((n_chunks * chunk_size,), dtype=bool)
        v[:n] = True
        chunks.append(padded.reshape(n_chunks, chunk_size, 2))
        valids.append(v.reshape(n_chunks, chunk_size))
        seg_ids.append(np.full((n_chunks,), s, dtype=np.int32))

    if chunks:
        points = np.concatenate(chunks, axis=0)
        valid = np.concatenate(valids, axis=0)
        chunk_segment = np.concatenate(seg_ids, axis=0)
    else:
        points = np.full((1, chunk_size, 2), PAD_COORD, dtype=dtype)
        valid = np.zeros((1, chunk_size), dtype=bool)
        chunk_segment = np.zeros((1,), dtype=np.int32)
        num_segments = max(num_segments, 1)

    centers = np.asarray(centers, dtype=dtype).reshape(-1, 2)
    filter_radius = np.asarray(filter_radius, dtype=dtype).reshape(-1)
    if centers.shape[0] != num_segments or filter_radius.shape[0] != num_segments:
        # pad filter metadata for empty sets
        c = np.zeros((num_segments, 2), dtype=dtype)
        r = np.zeros((num_segments,), dtype=dtype)
        c[: centers.shape[0]] = centers
        r[: filter_radius.shape[0]] = filter_radius
        centers, filter_radius = c, r

    return ChunkedPointSet(
        points=points, valid=valid, chunk_segment=chunk_segment,
        centers=centers, filter_radius=filter_radius,
        num_segments=num_segments)
