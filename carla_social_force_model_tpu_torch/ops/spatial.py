"""Spatial locality ordering for the environment kernels (port of
ops/spatial.py: the curve keys and the sort).

Sorting pedestrians along a space-filling curve puts nearby agents in the
same kernel block, so a block's bounding box is tight and the environment
kernels skip every segment whose filter circle misses it.  The force sums
are per pedestrian, so the order changes no result.

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
    arithmetic as in the JAX package, then truncation), int64."""
    lo = torch.where(alive, c, torch.inf).min()
    hi = torch.where(alive, c, -torch.inf).max()
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
    (dead slots last, stable).  Returns ``(perm, inv_perm)`` int64."""
    perm = torch.sort(_morton_key(pos_x, pos_y, alive, order),
                      stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def morton_sort(pos_x, pos_y, alive, arrays, order: str = "morton"):
    """Curve-sort ``arrays`` (a tuple of (N,) planes).  Returns
    ``(sorted_arrays, inv_perm)``: ``out[inv_perm]`` scatters a
    sorted-order result back to slot order.  Stable, so the order is the
    JAX package's ``lax.sort`` order exactly."""
    perm, inv = morton_order(pos_x, pos_y, alive, order)
    return tuple(a[perm] for a in arrays), inv
