"""Social forces as plain, masked PyTorch functions (port of ops/forces.py).

This module is the plain PyTorch version of the pair-force kernels in
``csrc/pair_forces.cu``: the CPU path, the reference the kernels are held
against on the card, and the parity target of the CPU tests against the
JAX package.  The masks and zero-guards are those of the JAX package's
``forces._moussaid_pair_force`` (forces.py:76-113): a pair contributes only
when both agents are alive, it is not a self pair, the positions differ
(``d2 > 0``) and the interaction vector does not vanish (``B > 0``), so
coincident agents give exactly zero, never NaN.

Every function takes and returns planar ``(N,)`` x/y tensors.
"""
from __future__ import annotations

import torch

from . import vecmath
from ..models.params import AccelerationParams, MoussaidParams


def acceleration_force_xy(pos_x, pos_y, vel_x, vel_y, wp_x, wp_y,
                          applied_target, p: AccelerationParams):
    """Relaxation toward the target speed along the desired direction
    (reference forces.py:46-53, zero-safe direction); returns ``(fx, fy)``."""
    ex, ey, _ = vecmath.normalize_xy(wp_x - pos_x, wp_y - pos_y)
    return ((applied_target * ex - vel_x) / p.tau,
            (applied_target * ey - vel_y) / p.tau)


def _moussaid_pair_force(dx, dy, radius_sub, dvx, dvy, p: MoussaidParams,
                         pair_ok):
    """Moussaid et al. (2009) interaction term, per pair.

    ``(dx, dy)`` is the raw vector from the pedestrian toward its partner
    (x_j - x_i), ``(dvx, dvy)`` the relative velocity v_i - v_j,
    ``radius_sub`` the radii subtracted from the distance (0 when disabled)
    and ``pair_ok`` the mask of pairs that may contribute.  Returns the
    force planes ``(fx, fy)`` on the pedestrian, one value per pair.
    Reference math: forces.py:85-115.
    """
    d2 = dx * dx + dy * dy
    r = torch.rsqrt(torch.where(d2 == 0.0, 1.0, d2))
    ex = dx * r                                # zero-safe unit vector
    ey = dy * r
    d = d2 * r - radius_sub                    # = |diff| - radii

    tx = p.lambda_ * dvx + ex
    ty = p.lambda_ * dvy + ey
    t2 = tx * tx + ty * ty
    rt = torch.rsqrt(torch.where(t2 == 0.0, 1.0, t2))
    thx = tx * rt
    thy = ty * rt
    t_len = t2 * rt

    B = p.gamma * t_len
    ok = pair_ok & (B > 0.0) & (d2 > 0.0)

    # signed angle from t_hat to e via one atan2, with the inputs of masked
    # pairs guarded so the backward pass stays finite
    cross = torch.where(ok, thx * ey - thy * ex, 0.0)
    dot = torch.where(ok, ex * thx + ey * thy, 1.0)
    theta = torch.atan2(cross, dot) + B * (-p.epsilon)
    B_safe = torch.where(ok, B, 1.0)
    common = -d / B_safe
    Bt = B * theta
    f_v = -p.A * torch.exp(common - torch.square(p.n_prime * Bt))
    f_t = -p.A * torch.sign(theta) * torch.exp(common - torch.square(p.n * Bt))
    # f = f_v * t_hat + f_t * left_normal(t_hat)
    fx = torch.where(ok, f_v * thx - f_t * thy, 0.0)
    fy = torch.where(ok, f_v * thy + f_t * thx, 0.0)
    return fx, fy


def pedestrian_force(pos_x, pos_y, vel_x, vel_y, radius, alive,
                     p: MoussaidParams, use_ped_radius: bool = False,
                     row_block: int = 1024):
    """Full N x N pedestrian interaction force (reference forces.py:74-117),
    planar: returns ``(fx, fy)``.

    Row-blocked so the pairwise intermediates stay ``(row_block, N)``
    regardless of the population.  Dead rows come out exactly zero.
    """
    n = pos_x.shape[0]
    col = torch.arange(n, device=pos_x.device)
    fx_out = torch.empty_like(pos_x)
    fy_out = torch.empty_like(pos_y)
    for lo in range(0, n, row_block):
        hi = min(lo + row_block, n)
        dx = pos_x[None, :] - pos_x[lo:hi, None]        # x_j - x_i
        dy = pos_y[None, :] - pos_y[lo:hi, None]
        dvx = vel_x[lo:hi, None] - vel_x[None, :]       # v_i - v_j
        dvy = vel_y[lo:hi, None] - vel_y[None, :]
        radius_sub = ((radius[lo:hi, None] + radius[None, :])
                      if use_ped_radius else 0.0)
        not_self = col[lo:hi, None] != col[None, :]
        pair_ok = alive[lo:hi, None] & alive[None, :] & not_self
        fx, fy = _moussaid_pair_force(dx, dy, radius_sub, dvx, dvy, p,
                                      pair_ok)
        fx_out[lo:hi] = fx.sum(dim=1)
        fy_out[lo:hi] = fy.sum(dim=1)
    return fx_out, fy_out
