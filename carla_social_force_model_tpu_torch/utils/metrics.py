"""Crowd-analysis metrics over recorded rollouts (a numpy copy of the JAX
package's utils/metrics.py).

Post-hoc analysis utilities for the quantities crowd studies actually
report: flow through a gate, density fields, speed-density (fundamental
diagram) samples, evacuation curves, and the counterflow lane order
parameter.  The reference framework records trajectories
(the reference's output_generator.py:32-51) but ships no analysis at all;
these functions accept exactly what a rollout returns
(:class:`~..models.stepper.StepRecord`, ``pos``/``vel`` (T, N, 2) +
``alive`` (T, N)) -- which is also what ``utils.csvout.read_pedestrian_csv``
reconstructs from this framework's or the reference's ``pedestrian.csv``,
so recorded files and live records analyze identically.

Everything here is host-side numpy on recorded arrays (analysis, not the
per-step device path); inputs may be tensors on any device or numpy arrays
(a tensor is copied to the host once per call).

The JAX package's physics-validation suite (tests/test_physics.py) is built
on the same definitions: lane formation uses :func:`lane_order_parameter`,
the fundamental-diagram test uses region-mean speeds.
"""
from __future__ import annotations

import numpy as np


def _np(a):
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def mean_speed(rec, region=None):
    """Per-frame mean speed [m/s] of alive pedestrians.

    ``region``: optional (xmin, xmax, ymin, ymax) axis-aligned window;
    only pedestrians inside it count.  Frames with no (selected)
    pedestrians yield NaN.  Returns (T,) float64.
    """
    pos, vel, alive = _np(rec.pos), _np(rec.vel), _np(rec.alive)
    sel = alive.copy()
    if region is not None:
        xmin, xmax, ymin, ymax = region
        sel &= ((pos[..., 0] >= xmin) & (pos[..., 0] <= xmax)
                & (pos[..., 1] >= ymin) & (pos[..., 1] <= ymax))
    speed = np.linalg.norm(vel, axis=-1)
    cnt = sel.sum(axis=1)
    with np.errstate(invalid="ignore"):
        return np.where(cnt > 0, (speed * sel).sum(axis=1)
                        / np.maximum(cnt, 1), np.nan)


def density_grid(rec, bounds, cell: float = 1.0, frames=None):
    """Time-averaged pedestrian density field [peds/m^2].

    ``bounds``: (xmin, xmax, ymin, ymax); ``cell``: grid cell edge [m];
    ``frames``: optional frame index array/slice (default: all frames).
    Returns ``(grid, xedges, yedges)`` with ``grid`` shaped
    (len(xedges)-1, len(yedges)-1).
    """
    pos, alive = _np(rec.pos), _np(rec.alive)
    if frames is not None:
        pos, alive = pos[frames], alive[frames]
    xmin, xmax, ymin, ymax = bounds
    xedges = np.arange(xmin, xmax + cell * 0.5, cell)
    yedges = np.arange(ymin, ymax + cell * 0.5, cell)
    m = alive.reshape(-1)
    x = pos[..., 0].reshape(-1)[m]
    y = pos[..., 1].reshape(-1)[m]
    grid, _, _ = np.histogram2d(x, y, bins=(xedges, yedges))
    t = max(pos.shape[0], 1)
    return grid / (t * cell * cell), xedges, yedges


def region_density(rec, region):
    """Per-frame density [peds/m^2] inside an (xmin, xmax, ymin, ymax)
    window.  Returns (T,) float64."""
    pos, alive = _np(rec.pos), _np(rec.alive)
    xmin, xmax, ymin, ymax = region
    sel = (alive & (pos[..., 0] >= xmin) & (pos[..., 0] <= xmax)
           & (pos[..., 1] >= ymin) & (pos[..., 1] <= ymax))
    return sel.sum(axis=1) / ((xmax - xmin) * (ymax - ymin))


def gate_crossings(rec, gate_a, gate_b):
    """Signed gate crossings per frame.

    ``gate_a``/``gate_b``: the gate segment's endpoints (2,).  A pedestrian
    crossing the segment between consecutive frames counts +1 when passing
    left-to-right of the a->b direction (the side whose cross product flips
    negative -> positive counts -1, i.e. sign follows the a->b normal
    (-dy, dx)).  Pedestrians must be alive in both frames; despawn/respawn
    teleports do not count.  Returns (T-1,) int arrays ``(plus, minus)``.
    """
    pos, alive = _np(rec.pos), _np(rec.alive)
    a = np.asarray(gate_a, np.float64)
    b = np.asarray(gate_b, np.float64)
    d = b - a
    p0, p1 = pos[:-1], pos[1:]
    ok = alive[:-1] & alive[1:]
    # side of the infinite gate line (cross product sign)
    s0 = (p0[..., 0] - a[0]) * d[1] - (p0[..., 1] - a[1]) * d[0]
    s1 = (p1[..., 0] - a[0]) * d[1] - (p1[..., 1] - a[1]) * d[0]
    crossed_line = (s0 > 0) != (s1 > 0)
    # and the motion segment intersects within the gate's extent:
    # parameterize the gate a + u*d, solve for u at the crossing point
    den = s0 - s1
    with np.errstate(divide="ignore", invalid="ignore"):
        tpar = np.where(den != 0.0, s0 / den, 0.0)
    px = p0[..., 0] + tpar * (p1[..., 0] - p0[..., 0])
    py = p0[..., 1] + tpar * (p1[..., 1] - p0[..., 1])
    dd = float(d @ d)
    u = ((px - a[0]) * d[0] + (py - a[1]) * d[1]) / max(dd, 1e-300)
    hit = ok & crossed_line & (u >= 0.0) & (u <= 1.0)
    plus = (hit & (s0 <= 0)).sum(axis=1)
    minus = (hit & (s0 > 0)).sum(axis=1)
    return plus, minus


def flow_rate(rec, gate_a, gate_b, dt: float):
    """Gate throughput summary.

    Returns a dict: ``total`` (all crossings), ``net`` (signed), ``rate``
    [peds/s] and ``specific`` [peds/(m s)] over the record's span (the
    standard J = N / (T * b) specific-flow definition for a gate of
    width b).
    """
    plus, minus = gate_crossings(rec, gate_a, gate_b)
    span = max(len(plus), 1) * dt
    width = float(np.linalg.norm(np.asarray(gate_b, np.float64)
                                 - np.asarray(gate_a, np.float64)))
    total = int(plus.sum() + minus.sum())
    return {
        "total": total,
        "net": int(plus.sum() - minus.sum()),
        "rate": total / span,
        "specific": total / (span * max(width, 1e-300)),
    }


def evacuation_curve(rec, dt: float):
    """Completion curve for despawn-on-arrival runs.

    Returns ``(t, remaining)``: simulation time per frame and the number of
    alive pedestrians, plus -- via :func:`evacuation_time` -- the instant
    the population empties.
    """
    alive = _np(rec.alive)
    t = np.arange(alive.shape[0]) * dt
    return t, alive.sum(axis=1)


def evacuation_time(rec, dt: float):
    """Time [s] of the first frame with zero alive pedestrians after the
    population peak; NaN if the record never empties."""
    alive = _np(rec.alive).sum(axis=1)
    peak = int(np.argmax(alive))
    after = np.nonzero(alive[peak:] == 0)[0]
    return float((peak + after[0]) * dt) if after.size else float("nan")


def fundamental_diagram(rec, region, dt: float, bins=8, min_frames: int = 3):
    """Speed-density samples from one record: per-frame (density, mean
    speed) inside ``region``, binned by density.

    Returns ``(rho_centers, v_means, counts)`` -- the classic flow-study
    presentation (speed falls with density; tests/test_physics.py pins the
    monotone trend on the counterflow corridor).  Bins with fewer than
    ``min_frames`` frames return NaN means.
    """
    rho = region_density(rec, region)
    v = mean_speed(rec, region)
    ok = np.isfinite(v)
    rho, v = rho[ok], v[ok]
    if rho.size == 0:
        return np.array([]), np.array([]), np.array([], int)
    edges = np.linspace(0.0, max(float(rho.max()), 1e-9), int(bins) + 1)
    idx = np.clip(np.digitize(rho, edges) - 1, 0, int(bins) - 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    means = np.full(int(bins), np.nan)
    counts = np.zeros(int(bins), int)
    for b in range(int(bins)):
        m = idx == b
        counts[b] = int(m.sum())
        if counts[b] >= min_frames:
            means[b] = float(v[m].mean())
    return centers, means, counts


def lane_order_parameter(pos, dirs, region, bins: int = 8, slices: int = 6,
                         min_per_slice: int = 10):
    """Counterflow lane (band) order parameter at one instant.

    ``pos``: (N, 2) alive positions; ``dirs``: (N,) walking direction signs
    (+1 east, -1 west); ``region``: (xmin, xmax, ymin, ymax) window.  Per
    x-slice, per lateral y-bin direction purity
    ``Y = sum_b w_b * ((n_+ - n_-) / (n_+ + n_-))^2`` averaged over
    populated x-slices: 1.0 = every band single-direction (perfect lanes),
    ~1/k for randomly mixed k-per-bin crowds.  Lateral-only, so pure
    downstream transport cannot inflate it.  Compare against a
    shuffled-``dirs`` null on the same positions to test lane FORMATION
    (see tests/test_physics.py::band_excess).  Returns NaN when no x-slice
    holds ``min_per_slice`` pedestrians.
    """
    pos = _np(pos)
    dirs = _np(dirs)
    xmin, xmax, ymin, ymax = region
    out = []
    edges_x = np.linspace(xmin, xmax, slices + 1)
    edges_y = np.linspace(ymin, ymax, bins + 1)
    for si in range(slices):
        m = (pos[:, 0] >= edges_x[si]) & (pos[:, 0] < edges_x[si + 1])
        if m.sum() < min_per_slice:
            continue
        yb = np.clip(np.digitize(pos[m, 1], edges_y) - 1, 0, bins - 1)
        d = dirs[m]
        num = 0.0
        den = 0.0
        for b in range(bins):
            mb = yb == b
            nb = int(mb.sum())
            if nb == 0:
                continue
            num += nb * (d[mb].sum() / nb) ** 2
            den += nb
        out.append(num / den)
    return float(np.mean(out)) if out else float("nan")
