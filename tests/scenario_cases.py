"""The chunked closest point's cases, shared by the CPU tests, the CUDA tests
and ``chip_smoke.py`` phase 21 (no JAX: the card's machine has none).

A seeded :class:`ChunkedPointSet` holds what the chunk scan must get right:
padded slots, a chunk whose slots are all invalid while its coordinates are
real (the live template of an inactive vehicle), a segment with no valid
point, and exact ties across the chunks of one segment (duplicated points).
The crowd holds dead agents parked at the far sentinel and a coincident
pair.
"""
import dataclasses

import numpy as np
import torch

from carla_social_force_model_tpu_torch.env.pointsets import (
    build_chunked_pointset, chunked_on)
from carla_social_force_model_tpu_torch.ops import geometry

#: where a dead agent is parked (the pair kernels' far sentinel)
DEAD_COORD = 1e7


def seeded_chunk_set(seed=0, n_segments=9, extent=10.0, chunk_size=128):
    """A host-side ChunkedPointSet (numpy) of ``n_segments`` outlines of
    1-300 points: segment 2 repeats its first 130 points (ties across its
    chunks), segment 5 is empty, and segment 3's first chunk keeps its
    coordinates with every slot invalid."""
    rng = np.random.default_rng(seed)
    lists = [rng.uniform(-extent, extent, (int(rng.integers(1, 300)), 2))
             for _ in range(n_segments)]
    lists[2] = np.concatenate([lists[2][:130], lists[2][:130]])
    lists[3] = rng.uniform(-extent, extent, (200, 2))
    lists[5] = np.zeros((0, 2))
    centers = rng.uniform(-extent / 2, extent / 2, (n_segments, 2))
    radius = rng.uniform(0.0, 2 * extent, n_segments)
    radius[1] = -1.0                 # a negative radius clamps to 0
    pset = build_chunked_pointset(lists, centers, radius,
                                  chunk_size=chunk_size)
    valid = pset.valid.copy()
    valid[np.flatnonzero(pset.chunk_segment == 3)[0]] = False
    return dataclasses.replace(pset, valid=valid)


def seeded_crowd_planes(n, seed=1, extent=12.0, dead_frac=0.1):
    """Pedestrian x/y planes (numpy float32): uniform over the box, a
    coincident pair, and ``dead_frac`` of them parked at ``DEAD_COORD``;
    returns ``(x, y, alive)``."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    alive = rng.uniform(size=n) >= dead_frac
    if n > 3:
        pos[3] = pos[2]
        alive[2:4] = True
    pos[~alive] = DEAD_COORD
    return pos[:, 0].copy(), pos[:, 1].copy(), alive


def to_device(x, y, alive, device):
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device),
            torch.from_numpy(alive).to(device))


def stacked_chunk_planes(c, k, seed=0):
    """Staged (c, k) chunk planes (numpy float32) that stack exact ties:
    every chunk repeats the four points (+-1, 0), (0, +-1) around one of
    four centres in blocks whose order puts equal distances in every
    sub-group and at both ends of each 32-point sub-group, a tail of
    ``PAD_COORD`` after a random real length, every fifth chunk a copy of
    the one before (ties across chunks), and every seventh chunk all
    ``PAD_COORD``.  Returns ``(fx, fy, centres)``: the pedestrians that
    meet the most ties stand on the centres."""
    from carla_social_force_model_tpu_torch.env.pointsets import PAD_COORD
    rng = np.random.default_rng(seed)
    centres = np.array([[0.0, 0.0], [3.0, -2.0], [-4.0, 5.0], [7.5, 7.5]],
                       np.float32)
    ring = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]],
                    np.float32)
    fx = np.full((c, k), PAD_COORD, np.float32)
    fy = np.full((c, k), PAD_COORD, np.float32)
    for ch in range(c):
        if ch % 7 == 6:
            continue
        if ch % 5 == 4:
            fx[ch], fy[ch] = fx[ch - 1], fy[ch - 1]
            continue
        length = int(rng.integers(1, k + 1))
        cen = centres[rng.integers(0, 4, length)]
        pts = cen + ring[rng.integers(0, 4, length)] * rng.choice(
            [1.0, 2.0], (length, 1)).astype(np.float32)
        pts[31::32] = pts[0::32][:len(pts[31::32])]   # ends of sub-groups
        fx[ch, :length], fy[ch, :length] = pts[:, 0], pts[:, 1]
    return fx, fy, centres


def chunk_scan_pair(px, py, pset_dev):
    """The chunk scan through its entry (the kernel on a card) and its
    plain version on the same inputs: ``((dmin, idx), (dmin, idx))``."""
    fx, fy = (a.contiguous() for a in geometry.staged_chunk_planes(pset_dev))
    return (geometry.chunk_argmin(px, py, fx, fy),
            geometry.chunk_argmin_plain(px, py, fx, fy))


def closest_pair(px, py, pset_dev):
    """:func:`geometry.closest_point_per_segment` through the kernel and
    through the plain scan: two ``(dist, bx, by, has_point)`` tuples."""
    return (geometry.closest_point_per_segment(px, py, pset_dev),
            geometry.closest_point_per_segment(px, py, pset_dev, plain=True))


def scan_mismatches(got, want):
    """Elements of the (C, N) ``dmin``/``idx`` planes that differ (bitwise
    for the distances: NaN never occurs)."""
    return int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())


def closest_mismatches(got, want):
    """Elements of the (S, N) closest-point planes that differ bitwise."""
    return int(sum((g != w).sum() for g, w in zip(got, want)))


__all__ = ["DEAD_COORD", "seeded_chunk_set", "seeded_crowd_planes",
           "stacked_chunk_planes", "to_device", "chunk_scan_pair", "closest_pair", "scan_mismatches",
           "closest_mismatches", "chunked_on"]
