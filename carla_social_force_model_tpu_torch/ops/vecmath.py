"""Branchless 2-D vector math on planar tensors (port of ops/vecmath.py).

Zero-safe normalisation and velocity capping, with the zero guard applied
to the squared norm before the square root, exactly as in the JAX package
(so the forward values match it and autograd stays finite at zero).
"""
from __future__ import annotations

import functools

import torch


def split_xy(v):
    """``(x, y)`` planes of ``v``: a pass-through for an (x, y) tuple, the
    column split of an ``(..., 2)`` tensor."""
    if isinstance(v, (tuple, list)):
        x, y = v
        return x, y
    return v[..., 0], v[..., 1]


def stack_xy(x, y):
    """Assemble an ``(..., 2)`` tensor from x/y planes (host-side views and
    record assembly, never inside the per-step hot path)."""
    return torch.stack([x, y], dim=-1)


def norm_xy(x, y):
    """Euclidean norm of planar components (no zero guard)."""
    return torch.sqrt(x * x + y * y)


def normalize_xy(x, y):
    """Zero-safe planar normalize: ``(ux, uy, norm)``; zero vectors map to
    zero directions."""
    n2 = x * x + y * y
    inv = torch.sqrt(torch.where(n2 == 0.0, 1.0, n2))
    return x / inv, y / inv, torch.sqrt(n2)


@functools.lru_cache(maxsize=256)
def _scalar(v: float, dtype: torch.dtype) -> torch.Tensor:
    """A number as a 0-d CPU tensor, made once per value and dtype."""
    return torch.tensor(v, dtype=dtype)


def minimum(x, v):
    """``jnp.minimum(x, v)`` for a tensor ``x`` and a number or tensor
    ``v``: equal to ``torch.clamp(x, max=v)``, but a tie passes half the
    gradient to each side, as JAX's does (``torch.clamp`` passes all of it
    to ``x``).  A number goes in as a CPU scalar (no copy to the card)."""
    return torch.minimum(x, v if isinstance(v, torch.Tensor)
                         else _scalar(float(v), x.dtype))


def maximum(x, v):
    """``jnp.maximum(x, v)``, as :func:`minimum`."""
    return torch.maximum(x, v if isinstance(v, torch.Tensor)
                         else _scalar(float(v), x.dtype))


def cap_velocity_xy(vx, vy, max_speed):
    """Scale planar velocities down so their speed does not exceed
    ``max_speed`` (reference stateutils.py:18-23; zero speeds pass
    through unchanged)."""
    s2 = vx * vx + vy * vy
    safe = torch.sqrt(torch.where(s2 == 0.0, 1.0, s2))
    factor = minimum(max_speed / safe, 1.0)
    return vx * factor, vy * factor


def atan2_rows(y, x, batched: bool):
    """``torch.atan2(y, x)``; with ``batched``, the rows of a batch (the
    leading axis) taken apart on the CPU, so that row b equals the function
    on row b alone bitwise: the CPU's vector loop rounds an element by where
    it falls in the tensor (a card computes every element alike)."""
    if not batched or y.device.type != "cpu":
        return torch.atan2(y, x)
    y, x = torch.broadcast_tensors(y, x)
    return torch.stack([torch.atan2(y[b].contiguous(), x[b].contiguous())
                        for b in range(y.shape[0])])
