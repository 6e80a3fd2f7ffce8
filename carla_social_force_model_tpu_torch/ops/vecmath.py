"""Branchless 2-D vector math on planar tensors (port of ops/vecmath.py).

Zero-safe normalisation and velocity capping, with the zero guard applied
to the squared norm before the square root, exactly as in the JAX package
(so the forward values match it and autograd stays finite at zero).
"""
from __future__ import annotations

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


def cap_velocity_xy(vx, vy, max_speed):
    """Scale planar velocities down so their speed does not exceed
    ``max_speed`` (reference stateutils.py:18-23; zero speeds pass
    through unchanged)."""
    s2 = vx * vx + vy * vy
    safe = torch.sqrt(torch.where(s2 == 0.0, 1.0, s2))
    factor = torch.clamp(max_speed / safe, max=1.0)
    return vx * factor, vy * factor
