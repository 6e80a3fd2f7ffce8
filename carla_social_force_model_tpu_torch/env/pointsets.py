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

:func:`segment_major` turns the first into the second.  The JAX package caps
a row at 4,096 points (a TPU VMEM limit, beyond which it keeps the chunked
path); the CUDA kernels stage a row in fixed pieces, so here any row length
is taken and there is no second path.
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
    of :func:`..models.vehicles.snapshot_pointset` holds tensors instead.
    """

    points: np.ndarray         # (C, K, 2) f32, padded with PAD_COORD
    valid: np.ndarray          # (C, K) bool
    chunk_segment: np.ndarray  # (C,) int32 segment id per chunk
    centers: np.ndarray        # (S, 2) per-segment filter center
    filter_radius: np.ndarray  # (S,) per-segment filter radius
    num_segments: int

    @property
    def num_chunks(self) -> int:
        return self.points.shape[0]

    @property
    def chunk_size(self) -> int:
        return self.points.shape[1]


@dataclass(frozen=True)
class SegmentPointSet:
    """Segment-major point layout: one fixed-size row per segment.

    ``x[s]``/``y[s]`` hold the sampled points of segment ``s`` in their
    original order, padded with ``PAD_COORD`` to a common ``K`` (a multiple
    of the chunk size).  Planar, as the kernels read them.
    """

    x: torch.Tensor              # (S, K) f32, PAD_COORD in padding slots
    y: torch.Tensor              # (S, K)
    center_x: torch.Tensor       # (S,) per-segment filter center
    center_y: torch.Tensor       # (S,)
    filter_radius: torch.Tensor  # (S,) per-segment filter radius

    @property
    def num_segments(self) -> int:
        return self.x.shape[0]

    @property
    def points_per_segment(self) -> int:
        return self.x.shape[1]

    @property
    def points(self) -> torch.Tensor:
        """(S, K, 2) assembly view (host-side consumers and tests)."""
        return torch.stack([self.x, self.y], dim=-1)

    @property
    def centers(self) -> torch.Tensor:
        """(S, 2) assembly view."""
        return torch.stack([self.center_x, self.center_y], dim=-1)


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
    centers = np.asarray(pset.centers)
    return SegmentPointSet(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in (out[..., 0], out[..., 1], centers[:, 0], centers[:, 1],
                    np.asarray(pset.filter_radius))))


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
