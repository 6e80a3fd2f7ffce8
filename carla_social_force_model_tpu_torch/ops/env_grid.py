"""Launch plan of the compacted environment kernels (port of the plain
parts of ops/pallas_env.py: ``_tile_hits``, the compaction gate and the
survivor table of ``fused_environment_terms``).

The environment kernels of ``csrc/env_forces.cu`` give each block 128
consecutive Hilbert-sorted pedestrians.  The dense form walks every
section and skips, per block, the sections whose filter circle misses the
block's box.  The compacted form walks a per-step survivor table instead:
the groups of ``group`` consecutive sections that hold at least one section
touching the block's box, ascending.  Everything here is plain PyTorch on
the planes' device; nothing synchronises with the host.

* :func:`env_gate` is the JAX package's static gate (pallas_env.py:
  584-589), so the port compacts exactly the jobs the JAX package
  compacts: groups of ``round_up(max(1, 512 // K), 8)`` sections (512 is
  the JAX package's ``env_point_tile`` default), a table width of
  ``env_max_surv`` or, at 0, a third of the groups (at least 8), and the
  table only when there are more groups than its width.
* :func:`group_hits` is ``_tile_hits`` on the kernel's blocks: the filter
  circle against the block's box with every operation rounded on its own,
  exactly as the kernel's ``touches`` computes it, from the same sorted
  planes, alive mask and squared radii.  So the table lists every group
  that holds a section the kernel would accept, and the compacted kernel
  visits the sections the dense kernel visits, in the same order.
* A block with more hits than the table is wide walks every section (the
  kernel reads ``counts``), where the TPU fell back to the whole dense grid
  with a ``lax.cond``.
* Under a batch of crowds (``(B, n)`` planes, each row sorted on its own)
  every function gains a leading batch axis: each crowd's boxes, hits and
  table over its own blocks, against the shared sections (with each
  crowd's own radii for a swept perception threshold), or against each
  crowd's own sections (a batch of fleets' vehicles, ``(B, S)``
  centers), as the JAX package's ``_tile_hits`` under ``vmap``.  The gate
  stays one for all.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .pair_grid import _round_up, box_planes
from .spatial import surv_counts

#: pedestrians per block of the environment kernels (csrc/env_forces.cu
#: kEnvPeds) and per row of the survivor table
ENV_BLOCK = 128
#: the JAX package's ``StepConfig.env_point_tile`` default, which sizes its
#: groups of sections
JAX_POINT_TILE = 512


class EnvGrid(NamedTuple):
    """What a compacted environment launch reads besides the planes:
    ``surv`` (blocks, max_surv) int32 ascending group indices padded with
    -1, ``counts`` (blocks,) int32 hits per block, and the group size in
    sections.  The grid of a batch of crowds (:func:`env_grid` of ``(B,
    n)`` planes) has one ``max_surv`` and ``group`` for every crowd and a
    leading batch axis: ``surv`` (B, blocks, max_surv), ``counts`` (B,
    blocks)."""

    surv: torch.Tensor
    counts: torch.Tensor
    max_surv: int
    group: int


def env_gate(num_segments: int, slots: int, compact: bool,
             max_surv: int) -> tuple[bool, int, int]:
    """``(engage, group, max_surv)`` for one environment job: whether the
    survivor table drives its launch, the sections per group and the
    table's width.  ``slots``: points per section row, or segments (M) for
    the analytic geometry, as the JAX package gates either.  Static, from
    shapes only (pallas_env.py:584-589), so it is the same for every crowd
    of a batch."""
    group = _round_up(max(1, JAX_POINT_TILE // max(slots, 1)), 8)
    n_groups = -(-num_segments // group)
    ms = max_surv if max_surv > 0 else min(n_groups,
                                           max(8, -(-n_groups // 3)))
    return compact and n_groups > ms, group, ms


def block_boxes(x, y, alive):
    """(4, blocks) boxes of each block's alive pedestrians, [min_x, max_x,
    min_y, max_y] as rows; a block without one gets the inverted infinite
    box, which touches nothing (the kernel's ``block_box``).  ``(B, n)``
    planes give ``(B, 4, blocks)``, each crowd's own blocks."""
    return box_planes(x, y, alive, ENV_BLOCK)


def group_hits(boxes, center_x, center_y, r2, group: int):
    """(blocks, groups) bool: does some section of the group have a filter
    circle ``(center, r2)`` that touches the block's box?  Sections past
    the last fill the last group with ``r2 = -1`` (never a hit).  Boxes
    ``(B, 4, blocks)`` give ``(B, blocks, groups)``, each crowd's blocks
    against the shared circles, with ``r2`` ``(S,)`` or each crowd's own
    ``(B, S)``, or against each crowd's own circles (``(B, S)`` centers: a
    batch of fleets' vehicles)."""
    s = center_x.shape[-1]
    s_pad = _round_up(max(s, 1), group)

    def padded(a, fill):
        pad = a.new_full((*a.shape[:-1], s_pad - s), fill)
        return torch.cat([a, pad], dim=-1) if s_pad > s else a

    cx, cy, rr = (padded(a, fill)[..., None, :] for a, fill in (
        (center_x, 0.0), (center_y, 0.0), (r2, -1.0)))

    def box(k):
        return boxes[..., k, :, None]

    gx = torch.maximum(cx - box(1), box(0) - cx).clamp_(min=0.0)
    gy = torch.maximum(cy - box(3), box(2) - cy).clamp_(min=0.0)
    hit = (gx * gx + gy * gy) <= rr
    return hit.reshape(*hit.shape[:-1], s_pad // group, group).any(dim=-1)


def env_grid(x, y, alive, seg, r2, group: int, max_surv: int) -> EnvGrid:
    """The survivor table of one compacted launch over sorted planes ``x``,
    ``y``, ``alive`` and the segment set ``seg`` with the squared filter
    radii ``r2`` the kernel reads (``ops/cuda_env.filter_r2``).  ``(B, n)``
    planes (each row sorted on its own) give the table of one batched
    launch, row b equal to the table of row b alone (``r2`` ``(S,)`` or
    ``(B, S)``; ``seg`` shared, or each crowd's own with ``(B, S)``
    centers)."""
    hits = group_hits(block_boxes(x, y, alive), seg.center_x, seg.center_y,
                      r2, group)
    surv, counts = surv_counts(hits, max_surv)
    return EnvGrid(surv.contiguous(), counts, max_surv, group)
