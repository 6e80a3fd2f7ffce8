"""Tile geometry of the cutoff pair kernels (port of the plain parts of
ops/pallas_forces.py: ``_round_up``, ``_bbox_hits``, the triangle of
``_triangle_table``, the compaction gate and the survivor table).

The pair kernels of ``csrc/pair_forces.cu`` work on Hilbert-sorted planes.
Under a cutoff they skip every tile pair whose bounding boxes lie farther
apart than the cutoff, and above a static gate they walk a per-step
survivor table instead of the whole grid.  Everything here is plain
PyTorch on the planes' device; nothing synchronises with the host, so a
step can queue its launches without waiting.

Tile geometry of this port (the TPU's 192 x 512 tiles, auto ``max_surv`` of
32 and 64-tile gate were sized for v5e SMEM; these are sized for the H100):

* ``SYM_TILE`` = 128: the symmetric kernel's square tile pair (one thread
  per row, the column tile staged in shared memory), and the row unit of
  both survivor tables.
* ``COL_TILE`` = 256 columns staged per step by the dense and compacted
  kernels, whose blocks hold 32 rows (the dense kernel's layout without a
  cutoff).  A table row (128 rows) serves four such blocks; each block
  re-tests every listed tile against the box of its own 32 rows, so the
  compacted kernel walks exactly the tiles the dense cutoff kernel walks.
* ``AUTO_MAX_SURV`` = 32 table slots per row.  At a uniform 0.25
  pedestrians/m^2 a 128-agent box is about 22 m wide, so a 30 m cutoff
  reaches about 13 tiles of 256 (dense) or 11 of 128 after the triangle
  (symmetric); the slots leave room for denser patches.  A row with more
  hits overflows alone: its blocks walk every column tile with the box
  test, decided on the device, so the result is exact either way.
* ``GATE_COL_TILES`` = 64: the table engages above 64 column tiles of 256
  (N > 16,384).  Below it the whole grid is small (at most 64 box tests
  per block, or 8,256 triangle blocks) and the table's extra launches cost
  the host-bound eager step more than the skipped tests save.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .spatial import surv_counts, tile_bboxes

SYM_TILE = 128
COL_TILE = 256
AUTO_MAX_SURV = 32
GATE_COL_TILES = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cutoff_sq(cutoff: float) -> float:
    """The squared cutoff as every comparison here and in the kernels reads
    it: the float32 rounding of the double ``cutoff * cutoff`` (what the
    JAX package's ``d2 <= cutoff * cutoff`` compares against)."""
    return float(np.float32(float(cutoff) * float(cutoff)))


def box_planes(x, y, alive, tile: int):
    """(4, n_tiles) contiguous float32 boxes of alive agents per ``tile``
    consecutive slots, [min_x, max_x, min_y, max_y] as rows (the JAX
    package's transposed box layout); the last tile is padded with dead
    slots, and a tile without an alive agent gets the inverted infinite box
    that no test hits."""
    n = x.shape[0]
    pad = _round_up(n, tile) - n

    def padded(a, fill):
        return torch.cat([a, a.new_full((pad,), fill)]) if pad else a

    return tile_bboxes(padded(x, 0.0), padded(y, 0.0), padded(alive, False),
                       tile).T.contiguous()


def _bbox_hits(row_bb, col_bb, cutoff: float):
    """(R, C) bool: is the gap between row tile i's and column tile j's
    bounding boxes within the cutoff?  The plain version of the kernels'
    box test: boxes as (4, n_tiles), every operation rounded on its own,
    empty tiles never hit.  The gap never exceeds the distance of any pair
    the two boxes hold (max, subtraction and rounding are monotonic), so a
    miss holds no pair within the cutoff."""
    gx = col_bb[0][None, :] - row_bb[1][:, None]
    torch.maximum(gx, row_bb[0][:, None] - col_bb[1][None, :], out=gx)
    gx.clamp_(min=0.0)
    gx.mul_(gx)
    gy = col_bb[2][None, :] - row_bb[3][:, None]
    torch.maximum(gy, row_bb[2][:, None] - col_bb[3][None, :], out=gy)
    gy.clamp_(min=0.0)
    gy.mul_(gy)
    return gx.add_(gy) <= cutoff_sq(cutoff)


def triangle_mask(n_row_tiles: int, n_col_tiles: int, tr: int, tc: int,
                  device=None):
    """(R, C) bool: tile pairs that hold some column index above some row
    index (``j*tc + tc - 1 > i*tr``), the ones the symmetric kernel visits.
    The mask form of the JAX package's ``_triangle_table``: each row's true
    columns, ascending, are that table's column."""
    i = torch.arange(n_row_tiles, device=device)[:, None] * tr
    j = torch.arange(n_col_tiles, device=device)[None, :] * tc + tc - 1
    return j > i


def compact_gate(n: int, symmetric: bool, compact: bool,
                 max_surv: int) -> tuple[bool, int]:
    """``(engage, max_surv)``: whether the survivor table drives the launch
    for ``n`` agents, and its width.  Static, from shapes only.  An
    explicit ``max_surv`` engages whenever the table is narrower than a
    row of column tiles; ``0`` picks ``AUTO_MAX_SURV`` above the
    ``GATE_COL_TILES`` gate."""
    n_col_tiles = -(-n // (SYM_TILE if symmetric else COL_TILE))
    if not compact or n == 0:
        return False, 0
    if max_surv > 0:
        return n_col_tiles > max_surv, max_surv
    return -(-n // COL_TILE) > GATE_COL_TILES, AUTO_MAX_SURV


class CutoffGrid(NamedTuple):
    """What a cutoff launch reads besides the planes.

    ``form``: the launch form, read by the kernel ``pair_force_<form>``:
    ``"sym_cutoff"`` (static triangle with the box test),
    ``"sym_compact"`` (survivor table over tile pairs), ``"dense_cutoff"``
    (every column tile, box test per block) or ``"compact"`` (survivor
    table per 128-row table row), or ``"sym_dense_cutoff"`` (the full
    block of two shards' agents, the box test on both sides' 128-agent
    tiles).  ``boxes``: (4, n) column-tile boxes (128 for the symmetric
    forms, 256 for the others).  ``surv``/``counts``:
    the table and each row's hit count (None without a table)."""

    form: str
    boxes: torch.Tensor
    surv: torch.Tensor | None
    counts: torch.Tensor | None
    max_surv: int
    c2: float
    #: the rows' 128-agent tile boxes of a ``"sym_dense_cutoff"`` launch
    #: (the other forms take the rows' boxes from the same planes)
    row_boxes: torch.Tensor | None = None


def cutoff_grid(x, y, alive, cutoff: float, symmetric: bool = True,
                compact: bool = True, max_surv: int = 0) -> CutoffGrid:
    """The boxes and, above the gate, the survivor table of one cutoff
    launch over sorted planes ``x``, ``y``, ``alive``."""
    n = x.shape[0]
    engage, ms = compact_gate(n, symmetric, compact, max_surv)
    row_bb = box_planes(x, y, alive, SYM_TILE)
    col_bb = row_bb if symmetric else box_planes(x, y, alive, COL_TILE)
    c2 = cutoff_sq(cutoff)
    if not engage:
        return CutoffGrid("sym_cutoff" if symmetric else "dense_cutoff",
                          col_bb, None, None, 0, c2)
    hits = _bbox_hits(row_bb, col_bb, cutoff)
    if symmetric:
        nt = row_bb.shape[1]
        hits &= triangle_mask(nt, nt, SYM_TILE, SYM_TILE, hits.device)
    surv, counts = surv_counts(hits, ms)
    return CutoffGrid("sym_compact" if symmetric else "compact", col_bb,
                      surv.contiguous(), counts, ms, c2)


def rect_grid(row_x, row_y, row_alive, col_bb, n_cols: int, cutoff: float,
              compact: bool = True, max_surv: int = 0) -> CutoffGrid:
    """The grid of a dense cutoff launch of sorted row planes against a
    block of ``n_cols`` sorted columns with 256-column tile boxes ``col_bb``
    (:func:`box_planes`): the box test alone, or above the gate (on the
    column count) the survivor table of the rows' 128-row tiles against the
    column tiles.  The square grid of :func:`cutoff_grid` with
    ``symmetric=False`` is this grid with the rows as the columns."""
    engage, ms = compact_gate(n_cols, False, compact, max_surv)
    c2 = cutoff_sq(cutoff)
    if not engage:
        return CutoffGrid("dense_cutoff", col_bb, None, None, 0, c2)
    hits = _bbox_hits(box_planes(row_x, row_y, row_alive, SYM_TILE), col_bb,
                      cutoff)
    surv, counts = surv_counts(hits, ms)
    return CutoffGrid("compact", col_bb, surv.contiguous(), counts, ms, c2)


def block_grid(row_bb, col_bb, cutoff: float) -> CutoffGrid:
    """The grid of a full-block (``"sym_dense_cutoff"``) launch: the rows'
    and the columns' 128-agent tile boxes (:func:`box_planes`)."""
    return CutoffGrid("sym_dense_cutoff", col_bb, None, None, 0,
                      cutoff_sq(cutoff), row_bb)
