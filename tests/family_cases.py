"""Shared cases of the model-family pair kernels (the power law and the
Helbing ellipse) for ``tests/test_torch_cuda.py`` and ``chip_smoke.py``:
seeded crowds, one launch of a kernel form, its plain version and the one
tolerance both hold it to.

This module imports neither JAX nor the JAX package, so ``chip_smoke.py``
imports it on a machine without them.
"""
import numpy as np
import torch

from carla_social_force_model_tpu_torch.models.params import (
    PedRepulsiveParams, PowerLawParams)
from carla_social_force_model_tpu_torch.ops import cuda_forces, forces
from carla_social_force_model_tpu_torch.ops.spatial import morton_order

#: kernel vs plain version, elementwise |got - want| <= ATOL + RTOL * S: S
#: is the row's sum of |f_ij| for the power law (its pair forces reach 1e6
#: near contact and cancel in a row's sum, and f32 summation order moves
#: the sum by about 1e-7 * S) and |f| itself for Helbing (pair forces of a
#: few N; both sides decide every gate on values rounded after each
#: operation)
ATOL = RTOL = 1e-4
TOLERANCE = {"powerlaw": f"{ATOL:g} + {RTOL:g}*sum_j |f_ij|",
             "helbing": f"{ATOL:g} + {RTOL:g}*|f|"}


def family_planes(n, seed, device, extent=None, sort=False):
    """A seeded crowd (extent sqrt(N) by default; random headings, so that
    many pairs are on a collision course; 10% dead, one coincident live
    pair) with unit desired directions (one of them zero), as planes x, y,
    vx, vy, radius, alive, ex, ey; in the Hilbert order of the cutoff path
    when ``sort``."""
    m = max(n, 7)
    extent = float(np.sqrt(m)) if extent is None else extent
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (m, 2)).astype(np.float32)
    vel = rng.uniform(-2.0, 2.0, (m, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, m).astype(np.float32)
    alive = rng.uniform(size=m) < 0.9
    pos[5] = pos[6]
    alive[5] = alive[6] = True
    e = rng.normal(size=(m, 2))
    e = (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32)
    e[2] = 0.0
    planes = [torch.from_numpy(np.ascontiguousarray(a[:n])).to(device)
              for a in (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], radius,
                        alive, e[:, 0], e[:, 1])]
    if sort:
        perm, _ = morton_order(planes[0], planes[1], planes[5], "hilbert")
        planes = [a[perm].contiguous() for a in planes]
    return planes


def family_params(law):
    return PowerLawParams() if law == "powerlaw" else PedRepulsiveParams()


def family_plain(law, planes, cutoff=None, magnitudes=False):
    """The plain version of ``law`` on ``planes`` as a (2, N) tensor; with
    ``magnitudes`` the row sums of |f_ij| per component instead."""
    x, y, vx, vy, rad, alive, ex, ey = planes
    p = family_params(law)

    def pair(r, dx, dy, ok):
        if law == "powerlaw":
            f = forces._powerlaw_pair_force(
                dx, dy, rad[r, None] + rad[None, :],
                vx[r, None] - vx[None, :], vy[r, None] - vy[None, :], p, ok)
        else:
            f = forces._helbing_pair_force(
                -dx, -dy, p.step_width * vx[None, :],
                p.step_width * vy[None, :], ex[r, None], ey[r, None], p, ok)
        return tuple(c.abs() for c in f) if magnitudes else f

    return torch.stack(forces._pair_sum(x, y, alive, pair, 1024, cutoff,
                                        None))


def family_reference(law, planes, cutoff=None):
    """``(want, limit)``: the plain version and the elementwise limit of a
    kernel's error against it (see ``ATOL``)."""
    want = family_plain(law, planes, cutoff)
    scale = (family_plain(law, planes, cutoff, magnitudes=True)
             if law == "powerlaw" else want.abs())
    return want, ATOL + RTOL * scale


def family_run(law, planes, form, grid=None):
    """One launch of ``law``'s kernel in ``form`` (with ``grid``, its cutoff
    form) on ``planes``, as a (2, N) tensor."""
    x, y, vx, vy, rad, alive, ex, ey = planes
    prm = cuda_forces.law_vector(law, family_params(law), x.device)
    kw = dict(law=law)
    if law == "helbing":
        rad, kw["desired"] = None, (ex, ey)
    if grid is not None:
        return torch.stack(cuda_forces.pair_force_cutoff(
            x, y, vx, vy, rad, alive, prm, grid, **kw))
    fn = (cuda_forces.pair_force_sym if form == "sym"
          else cuda_forces.pair_force_dense)
    return torch.stack(fn(x, y, vx, vy, rad, alive, prm, **kw))
