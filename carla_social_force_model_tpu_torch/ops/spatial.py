"""Spatial locality ordering and tile bookkeeping for the kernels that skip
work by distance (port of ops/spatial.py).

Sorting pedestrians along a space-filling curve puts nearby agents in the
same kernel block, so a block's bounding box is tight: the environment
kernels skip every segment whose filter circle misses it, and the cutoff
pair kernels every tile pair whose boxes lie farther apart than the cutoff
(:func:`tile_bboxes`, :func:`surv_table`).  The force sums are per
pedestrian, so the order changes no result beyond f32 summation order.

Keys are int64 holding the JAX package's uint32 values exactly (torch's sort
of ``uint32`` is not dependable): dead slots key to ``0xFFFFFFFF``, alive
slots are clamped to ``0xFFFFFFFE`` so that "dead slots sort last" holds
even for an alive agent at the quantization corner.
"""
from __future__ import annotations

import torch

_MAX_KEY = 0xFFFFFFFF
_U32 = 0xFFFFFFFF
_HILBERT_BITS = 15


def _part1by1(x):
    """Interleave 16-bit integer bits with zeros (Morton helper)."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _quantize(c, alive, levels: int):
    """Coordinates to integer levels over the alive agents' span (float32
    arithmetic as in the JAX package, then truncation), int64.  The span
    is each row's own for ``(B, N)`` planes, as under the JAX package's
    vmap."""
    lo = torch.where(alive, c, torch.inf).amin(dim=-1, keepdim=True)
    hi = torch.where(alive, c, -torch.inf).amax(dim=-1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-6)
    top = float(levels - 1)
    return torch.clamp((c - lo) / span * top, 0.0, top).to(torch.int64)


def _hilbert_d(x, y, bits: int = _HILBERT_BITS):
    """Vectorized 2-D Hilbert index (the classic xy2d rotation walk,
    unrolled over ``bits`` levels; branchless).  The flips are taken modulo
    2^32, as the JAX package's uint32 arithmetic does."""
    d = torch.zeros_like(x)
    for level in range(bits - 1, -1, -1):
        s = 1 << level
        rx = ((x & s) > 0).to(torch.int64)
        ry = ((y & s) > 0).to(torch.int64)
        d = d + s * s * ((3 * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        xf = torch.where(flip, (s - 1 - x) & _U32, x)
        yf = torch.where(flip, (s - 1 - y) & _U32, y)
        x = torch.where(swap, yf, xf)
        y = torch.where(swap, xf, yf)
    return d


def _morton_key(pos_x, pos_y, alive, order: str = "morton"):
    """(N,) int64 space-filling-curve keys with uint32 values; dead slots
    key to the maximum (sort last).

    ``order``: ``"morton"`` (Z-order, 16 bits/axis) or ``"hilbert"`` (15
    bits/axis, no Z-jumps, so tighter boxes of consecutive agents)."""
    if order == "hilbert":
        levels = 1 << _HILBERT_BITS
        key = _hilbert_d(_quantize(pos_x, alive, levels),
                         _quantize(pos_y, alive, levels))
    elif order == "morton":
        key = ((_part1by1(_quantize(pos_x, alive, 65536)) << 1)
               | _part1by1(_quantize(pos_y, alive, 65536)))
    else:
        raise ValueError(f"unknown spatial order {order!r}")
    return torch.where(alive, torch.clamp(key, max=_MAX_KEY - 1), _MAX_KEY)


def morton_order(pos_x, pos_y, alive, order: str = "morton"):
    """Permutation sorting alive pedestrians along a space-filling curve
    (dead slots last, stable).  Returns ``(perm, inv_perm)`` int64.
    ``(B, N)`` planes sort each row on its own (along the last axis)."""
    perm = torch.sort(_morton_key(pos_x, pos_y, alive, order), dim=-1,
                      stable=True).indices
    inv = torch.empty_like(perm)
    ids = torch.arange(perm.shape[-1], device=perm.device)
    inv.scatter_(-1, perm, ids.expand_as(perm))
    return perm, inv


def morton_sort(pos_x, pos_y, alive, arrays, order: str = "morton"):
    """Curve-sort ``arrays`` (a tuple of (N,) planes).  Returns
    ``(sorted_arrays, inv_perm)``: ``out[inv_perm]`` scatters a
    sorted-order result back to slot order.  Stable, so the order is the
    JAX package's ``lax.sort`` order exactly."""
    perm, inv = morton_order(pos_x, pos_y, alive, order)
    return tuple(a[perm] for a in arrays), inv


def surv_counts(hits, max_surv: int):
    """Each row's surviving column indices, ascending, compacted to the
    front: ``(surv, counts)`` with ``surv`` (R, max_surv) int32 padded with
    -1 and ``counts`` (R,) int32, the number of hits of each row (a row
    with ``counts > max_surv`` has overflowed: its table lists only its
    first ``max_surv`` hits).  ``hits`` may carry a leading batch axis,
    ``(B, R, C)``: then ``(B, R, max_surv)`` and ``(B, R)``, row b the
    table of ``hits[b]``.

    No sort and no host synchronisation: a row-wise running count of the
    hits gives each hit its slot, and a batched binary search finds the
    column where the count first reaches ``s + 1`` -- the ``s``-th hit."""
    *lead, r, c = hits.shape
    cum = torch.cumsum(hits, dim=-1, dtype=torch.int32)
    counts = (cum[..., -1].contiguous() if c
              else torch.zeros((*lead, r), dtype=torch.int32,
                               device=hits.device))
    want = torch.arange(1, max_surv + 1, dtype=torch.int32,
                        device=hits.device).expand(*lead, r,
                                                   max_surv).contiguous()
    col = torch.searchsorted(cum, want, out_int32=True) if c else want * 0
    return torch.where(want <= counts[..., None], col, -1), counts


def surv_table(hits, max_surv: int):
    """Compact each row's surviving column-tile indices to the front.

    ``hits``: (R, C) bool tile-pair hit matrix.  Returns ``(surv, fits)``:
    ``surv`` (R, max_surv) int32 of ascending surviving column indices with
    -1 padding, ``fits`` a 0-d bool tensor -- True iff no row overflows
    ``max_surv``.  The ascending order makes a compacted kernel's
    accumulation order that of the dense grid."""
    surv, counts = surv_counts(hits, max_surv)
    return surv, (counts <= max_surv).all()


def tile_bboxes(x, y, alive, tile: int):
    """Per-tile bounding boxes of alive agents.

    ``x``/``y``/``alive``: (n_pad,) with n_pad a multiple of ``tile``, or
    ``(B, n_pad)`` (each row's own tiles).  Returns (n_tiles, 4) f32
    [min_x, max_x, min_y, max_y] (``(B, n_tiles, 4)``); empty tiles get
    (+inf, -inf, +inf, -inf) so any distance test skips them."""
    *lead, n_pad = x.shape
    shape = (*lead, n_pad // tile, tile)
    xm = torch.where(alive, x, torch.inf).reshape(shape)
    xM = torch.where(alive, x, -torch.inf).reshape(shape)
    ym = torch.where(alive, y, torch.inf).reshape(shape)
    yM = torch.where(alive, y, -torch.inf).reshape(shape)
    return torch.stack([xm.amin(dim=-1), xM.amax(dim=-1),
                        ym.amin(dim=-1), yM.amax(dim=-1)], dim=-1)
