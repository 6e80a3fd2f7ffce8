"""ORCA (Optimal Reciprocal Collision Avoidance) as a velocity law (port of
ops/orca.py).

ORCA (van den Berg, Guy, Lin, Manocha, "Reciprocal n-body collision
avoidance", ISRR 2011) projects each agent's preferred velocity onto the
intersection of half-planes of velocities that avoid every neighbour for a
horizon ``tau``, each party of a pair taking half the correction; vehicles
do not reciprocate (the walker takes the whole correction), and static
walls enter as hard half-planes against the nearest wall features.

Plain PyTorch on x/y planes, as the JAX package has it in plain jnp (a few
hundred operations per agent and step, nothing for a kernel of its own to
win); the wall feed under it runs the ``seg_topk`` and ``chunk_topk``
kernels on a card (``ops/statics.py``).  The pieces follow the JAX
package's, operation for operation, so that the two pick the same
candidate of the linear program on the same inputs:

* neighbours: the ``k`` nearest alive agents within ``neighbor_dist`` out
  of a circular band of ``window`` positions of the Hilbert-sorted order
  (:func:`_window_neighbors`: one gather of the band), or of all agents
  when ``window`` is 0 or at least N (:func:`_full_neighbors`);
* the exact 2-D program by candidate enumeration (:func:`solve_lp2`: the
  clipped preference, the projections on each line, the line/disc and
  line/line intersections, in that order, the first best feasible one
  taken), with the exact minimax fallback (:func:`solve_lp3`) on the rows
  whose program is empty.  The JAX package runs the fallback on every row
  under one ``lax.cond``; here it runs on the infeasible rows only (a
  ``nonzero``, one host synchronisation per step that has any), which
  gives the same rows the same values;
* every square root and reciprocal root sees a safe value under its mask
  (:func:`_safe_unit`), so no NaN reaches a masked row or a gradient.

A batch of crowds (``parallel/sweeps.py``, the JAX package's vmap) runs
on ``(B, N)`` planes: each row's band, neighbours, vehicles (shared, or
each crowd's own fleet) and wall feed along its last axis (the feed one
batched launch for every row on a card), the programs over the flattened
``B * N`` rows (one ``nonzero`` for all of them), and a sweep's ``tau``,
``neighbor_dist`` and ``tau_static`` as ``(B,)`` leaves viewed as
columns.  Every operation is per element or per row, so row b equals one
crowd's solve on row b bitwise.

Over an agent axis (the JAX package's ``axis_name``) every shard gathers
the crowd, solves it whole and keeps its own rows; under a batch each
crowd is gathered along the last axis and each shard keeps its own
columns.
"""
from __future__ import annotations

import functools
from itertools import combinations

import torch

from . import vecmath
from .spatial import morton_order

#: feasibility slack [m/s]: half-plane clearances down to -_TOL count as
#: satisfied (f32 candidate arithmetic noise, not a behavioural knob)
_TOL = 1e-4
#: least |determinant| for a line-line intersection to count
_DET_EPS = 1e-9
#: elements of the largest (rows, candidates, constraints) temporary of the
#: linear programs: rows are taken in blocks under it (rows are independent,
#: so the blocks change no value)
LP_BLOCK_ELEMS = 1 << 26


def _safe_unit(x, y, fallback_x: float = 1.0):
    """Zero-safe unit vector and length: (0, 0) maps to (fallback_x, 0)
    with length 0.  ``sqrt`` and ``rsqrt`` never see 0 (their gradients
    would be NaN on masked rows)."""
    n2 = x * x + y * y
    bad = n2 <= 0.0
    safe = torch.where(bad, 1.0, n2)
    inv = torch.rsqrt(safe)
    return (torch.where(bad, fallback_x, x * inv),
            torch.where(bad, 0.0, y * inv),
            torch.where(bad, 0.0, torch.sqrt(safe)))


def orca_halfplane(px, py, rvx, rvy, r, tau, dt: float):
    """The ORCA half-plane of (agent, neighbour) pairs, broadcasting.

    ``p`` = neighbour position minus agent position, ``rv`` = agent
    velocity minus neighbour velocity, ``r`` = summed radii.  Returns
    ``(ux, uy, nx, ny)``: ``u`` the smallest change of ``rv`` onto the
    boundary of the velocity obstacle truncated at ``tau`` (pairs already
    in collision resolve over one step ``dt``), ``n`` its outward unit
    normal there.  The agent's constraint is ``(v - (v_agent + zeta*u)) .
    n >= 0`` with ``zeta`` its share of the correction.  ``tau`` is a
    number, or a sweep's float32 column that broadcasts against the planes
    (``1 / tau`` is then a float32 division, the value a number's double
    division rounds to).  (JAX package orca.py:87-164.)"""
    d2 = px * px + py * py
    r2 = r * r
    colliding = d2 <= r2

    # not colliding: the cone with horizon tau, truncated at its disc
    inv_tau = 1.0 / tau
    wx = rvx - px * inv_tau
    wy = rvy - py * inv_tau
    w2 = wx * wx + wy * wy
    dot1 = wx * px + wy * py
    on_arc = (dot1 < 0.0) & (dot1 * dot1 > r2 * w2)

    uwx, uwy, wlen = _safe_unit(wx, wy)
    arc_ux = (r * inv_tau - wlen) * uwx
    arc_uy = (r * inv_tau - wlen) * uwy

    # the tangent legs; colliding rows (which take the other branch) get 1
    # under the root and in the division
    safe_d2 = torch.where(colliding, 1.0, d2)
    leg = torch.sqrt(torch.where(colliding, 1.0,
                                 vecmath.maximum(d2 - r2, 0.0)))
    left_side = (px * wy - py * wx) > 0.0
    ldx = torch.where(left_side, px * leg - py * r, px * leg + py * r) \
        / safe_d2
    ldy = torch.where(left_side, px * r + py * leg, py * leg - px * r) \
        / safe_d2
    t_on = rvx * ldx + rvy * ldy
    leg_ux = t_on * ldx - rvx
    leg_uy = t_on * ldy - rvy
    leg_nx = torch.where(left_side, -ldy, ldy)
    leg_ny = torch.where(left_side, ldx, -ldx)

    nc_ux = torch.where(on_arc, arc_ux, leg_ux)
    nc_uy = torch.where(on_arc, arc_uy, leg_uy)
    nc_nx = torch.where(on_arc, uwx, leg_nx)
    nc_ny = torch.where(on_arc, uwy, leg_ny)

    # colliding: out of the disc D(p/dt, r/dt) within one step
    inv_dt = 1.0 / dt
    cwx = rvx - px * inv_dt
    cwy = rvy - py * inv_dt
    cux, cuy, cwlen = _safe_unit(cwx, cwy)
    c_ux = (r * inv_dt - cwlen) * cux
    c_uy = (r * inv_dt - cwlen) * cuy

    return (torch.where(colliding, c_ux, nc_ux),
            torch.where(colliding, c_uy, nc_uy),
            torch.where(colliding, cux, nc_nx),
            torch.where(colliding, cuy, nc_ny))


@functools.lru_cache(maxsize=None)
def _pair_indices(c: int, device):
    """The upper-triangle index pairs (i < j) in row-major order."""
    iu, ju = zip(*combinations(range(c), 2))
    return (torch.tensor(iu, dtype=torch.int64, device=device),
            torch.tensor(ju, dtype=torch.int64, device=device))


@functools.lru_cache(maxsize=None)
def _triple_indices(c: int, device):
    """The index triples (i < j < k) in lexicographic order."""
    ii, jj, kk = zip(*combinations(range(c), 3))
    return tuple(torch.tensor(v, dtype=torch.int64, device=device)
                 for v in (ii, jj, kk))


def _first_of(hit, cx, cy):
    """The first candidate where ``hit`` (JAX's ``cumsum(hit) == 1``): its
    coordinates as a sum over a one-hot, 0 where no candidate hits."""
    first = hit & (torch.cumsum(hit.to(torch.int32), dim=-1) == 1)
    fsel = first.to(cx.dtype)
    return (cx * fsel).sum(dim=-1), (cy * fsel).sum(dim=-1)


def _min_clearance(cx, cy, ptx, pty, nx, ny, valid):
    """(..., Ncand) least signed clearance of each candidate over the valid
    constraints (inf where none is valid)."""
    clear = ((cx[..., :, None] - ptx[..., None, :]) * nx[..., None, :]
             + (cy[..., :, None] - pty[..., None, :]) * ny[..., None, :])
    return torch.where(valid[..., None, :], clear, torch.inf).amin(dim=-1)


def _row_blocks(rows: int, per_row: int):
    step = max(1, LP_BLOCK_ELEMS // max(1, per_row))
    return [(lo, min(lo + step, rows)) for lo in range(0, rows, step)]


def solve_lp2(pref_x, pref_y, ptx, pty, nx, ny, valid, vmax):
    """Exact 2-D program by candidate enumeration, over rows: minimize
    ``|v - pref|`` subject to ``(v - pt_k) . n_k >= 0`` for every valid
    constraint and ``|v| <= vmax``.  ``pref_*``/``vmax`` (R,), constraints
    (R, C).  Returns ``(vx, vy, feasible)``; a row with an empty feasible
    region gets its best-scoring candidate anyway (see
    :func:`solve_orca_lp`).  (JAX package orca.py:173-252.)"""
    c = ptx.shape[-1]
    n_cand = 1 + 3 * c + c * (c - 1) // 2
    outs = [_lp2_rows(*(a[lo:hi] for a in (pref_x, pref_y, ptx, pty, nx, ny,
                                            valid, vmax)))
            for lo, hi in _row_blocks(ptx.shape[0], n_cand * c)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(o) for o in zip(*outs))


def _lp2_rows(pref_x, pref_y, ptx, pty, nx, ny, valid, vmax):
    c = ptx.shape[-1]
    b = ptx * nx + pty * ny          # line offsets: n . v == b on the line
    vmax2 = (vmax * vmax)[:, None]
    cands_x, cands_y, cands_ok = [], [], []

    def add(cx, cy, ok):
        cands_x.append(torch.where(ok, cx, 0.0))
        cands_y.append(torch.where(ok, cy, 0.0))
        cands_ok.append(ok)

    # 1. the preferred velocity, clipped into the speed disc
    p2 = pref_x * pref_x + pref_y * pref_y
    scale = vecmath.minimum(
        vmax * torch.rsqrt(torch.where(p2 == 0, 1.0, p2)), 1.0)
    add((pref_x * scale)[:, None], (pref_y * scale)[:, None],
        torch.ones_like(valid[:, :1]))

    # 2. the projection of pref onto each line, where inside the disc
    s = b - (pref_x[:, None] * nx + pref_y[:, None] * ny)
    qx = pref_x[:, None] + s * nx
    qy = pref_y[:, None] + s * ny
    add(qx, qy, valid & (qx * qx + qy * qy <= vmax2))

    # 3. the line / speed-circle intersections (line points pt + t*d,
    #    d = perp(n))
    dx, dy = -ny, nx
    pd = ptx * dx + pty * dy
    disc = pd * pd - (ptx * ptx + pty * pty) + vmax2
    ok_c = valid & (disc >= 0.0)
    root = torch.sqrt(torch.where(ok_c, vecmath.maximum(disc, 0.0), 1.0))
    for sgn in (-1.0, 1.0):
        t = -pd + sgn * root
        add(ptx + t * dx, pty + t * dy, ok_c)

    # 4. the constraint-pair intersections
    if c >= 2:
        iu, ju = _pair_indices(c, ptx.device)
        n1x, n1y, b1 = nx[:, iu], ny[:, iu], b[:, iu]
        n2x, n2y, b2 = nx[:, ju], ny[:, ju], b[:, ju]
        det = n1x * n2y - n1y * n2x
        ok_p = valid[:, iu] & valid[:, ju] & (torch.abs(det) > _DET_EPS)
        safe = torch.where(ok_p, det, 1.0)
        add((b1 * n2y - b2 * n1y) / safe, (n1x * b2 - n2x * b1) / safe, ok_p)

    cx = torch.cat(cands_x, dim=-1)      # (R, Ncand)
    cy = torch.cat(cands_y, dim=-1)
    ok = torch.cat(cands_ok, dim=-1)

    # feasible: least clearance >= -tol, inside the (slackened) disc
    min_clear = _min_clearance(cx, cy, ptx, pty, nx, ny, valid)
    in_disc = cx * cx + cy * cy <= vmax2 * (1.0 + 4e-6) + _TOL
    feas = ok & (min_clear >= -_TOL) & in_disc

    ex = cx - pref_x[:, None]
    ey = cy - pref_y[:, None]
    score = torch.where(feas, ex * ex + ey * ey, torch.inf)
    best = score.amin(dim=-1, keepdim=True)
    vx, vy = _first_of((score == best) & feas, cx, cy)
    return vx, vy, feas.any(dim=-1)


def solve_lp3(ptx, pty, nx, ny, valid, vmax):
    """Exact minimax fallback for rows whose half-plane intersection is
    empty: maximize ``m(v) = min_k (v - pt_k) . n_k`` over ``|v| <= vmax``
    (RVO2's ``linearProgram3`` objective), by enumerating its candidates:
    each constraint's disc argmax, the circle hits of every two-constraint
    tie line and every three-constraint tie point, clamped into the disc.
    Returns ``(vx, vy)``.  (JAX package orca.py:255-338.)"""
    c = ptx.shape[-1]
    n_cand = c + c * (c - 1) + c * (c - 1) * (c - 2) // 6
    outs = [_lp3_rows(*(a[lo:hi] for a in (ptx, pty, nx, ny, valid, vmax)))
            for lo, hi in _row_blocks(ptx.shape[0], n_cand * c)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(o) for o in zip(*outs))


def _lp3_rows(ptx, pty, nx, ny, valid, vmax):
    c = ptx.shape[-1]
    b = ptx * nx + pty * ny
    vmax_c = vmax[:, None]
    cands_x, cands_y, cands_ok = [], [], []

    def add(cx, cy, ok):
        # clamp into the disc (tie vertices can fall outside)
        c2 = cx * cx + cy * cy
        sc = vecmath.minimum(
            vmax_c * torch.rsqrt(torch.where(c2 == 0, 1.0, c2)), 1.0)
        cands_x.append(torch.where(ok, cx * sc, 0.0))
        cands_y.append(torch.where(ok, cy * sc, 0.0))
        cands_ok.append(ok)

    # each constraint's argmax over the disc
    add(vmax_c * nx, vmax_c * ny, valid)

    if c >= 2:
        iu, ju = _pair_indices(c, ptx.device)
        # tie line of constraints (i, j): (n_i - n_j) . v = b_i - b_j
        tx = nx[:, iu] - nx[:, ju]
        ty = ny[:, iu] - ny[:, ju]
        tb = b[:, iu] - b[:, ju]
        t2 = tx * tx + ty * ty
        ok_t = valid[:, iu] & valid[:, ju] & (t2 > _DET_EPS)
        safe_t2 = torch.where(ok_t, t2, 1.0)
        # the tie line's closest point to the origin and its circle hits
        px0 = tx * tb / safe_t2
        py0 = ty * tb / safe_t2
        ddx, ddy = -ty, tx
        h2 = (vmax * vmax)[:, None] - (px0 * px0 + py0 * py0)
        ok_c = ok_t & (h2 >= 0.0)
        h = (torch.sqrt(torch.where(ok_c, vecmath.maximum(h2, 0.0), 1.0))
             * torch.rsqrt(safe_t2))
        for sgn in (-1.0, 1.0):
            add(px0 + sgn * h * ddx, py0 + sgn * h * ddy, ok_c)

        if c >= 3:
            # three-way ties: g_i = g_j, g_j = g_k (2 x 2)
            ii, jj, kk = _triple_indices(c, ptx.device)
            a1x = nx[:, ii] - nx[:, jj]
            a1y = ny[:, ii] - ny[:, jj]
            c1 = b[:, ii] - b[:, jj]
            a2x = nx[:, jj] - nx[:, kk]
            a2y = ny[:, jj] - ny[:, kk]
            c2_ = b[:, jj] - b[:, kk]
            det = a1x * a2y - a1y * a2x
            ok3 = (valid[:, ii] & valid[:, jj] & valid[:, kk]
                   & (torch.abs(det) > _DET_EPS))
            safe = torch.where(ok3, det, 1.0)
            add((c1 * a2y - c2_ * a1y) / safe, (a1x * c2_ - a2x * c1) / safe,
                ok3)

    cx = torch.cat(cands_x, dim=-1)
    cy = torch.cat(cands_y, dim=-1)
    ok = torch.cat(cands_ok, dim=-1)
    m = torch.where(ok, _min_clearance(cx, cy, ptx, pty, nx, ny, valid),
                    -torch.inf)
    best = m.amax(dim=-1, keepdim=True)
    return _first_of((m == best) & ok, cx, cy)


def solve_orca_lp(pref_x, pref_y, ptx, pty, nx, ny, valid, vmax):
    """:func:`solve_lp2`, with :func:`solve_lp3` on the rows whose program
    is infeasible.  The rows are independent, so solving the fallback on
    those rows alone (one ``nonzero``: a host synchronisation on a card)
    gives each row what the JAX package's all-rows ``lax.cond`` gives it.
    (JAX package orca.py:341-353.)"""
    vx, vy, feasible = solve_lp2(pref_x, pref_y, ptx, pty, nx, ny, valid,
                                 vmax)
    rows = torch.nonzero(~feasible).squeeze(1)
    if rows.numel() == 0:
        return vx, vy
    fx, fy = solve_lp3(ptx[rows], pty[rows], nx[rows], ny[rows], valid[rows],
                       vmax[rows])
    return vx.index_put((rows,), fx), vy.index_put((rows,), fy)


def _k_nearest(d2, planes, k: int):
    """The ``k`` nearest candidates of each row of (..., W) squared
    distances (``inf`` = not a candidate), ties to the lower candidate
    position: the JAX package's ``k`` first-occurrence min-extractions, as
    one stable sort along the last axis.  Returns ``(sel_planes, valid)``
    of shape (..., k); an empty slot's payloads are 0."""
    *lead, w = d2.shape
    if w < k:
        pad = d2.new_full((*lead, k - w), torch.inf)
        d2 = torch.cat([d2, pad], dim=-1)
        planes = tuple(torch.cat([p, torch.zeros_like(pad)], dim=-1)
                       for p in planes)
    idx = torch.sort(d2, dim=-1, stable=True).indices[..., :k]
    valid = torch.isfinite(torch.gather(d2, -1, idx))
    return (tuple(torch.where(valid, torch.gather(p, -1, idx), 0.0)
                  for p in planes), valid)


def _window_neighbors(sx, sy, svx, svy, sr, salive, window: int, k: int,
                      neigh_dist):
    """The ``k`` nearest alive neighbours within ``neigh_dist`` out of the
    circular band of offsets ``-window//2 .. window//2`` (0 excluded, in
    that order) of the sorted planes: one gather of ``(i + o) mod N``
    along the last axis, the JAX package's ``jnp.roll`` shifts.  Returns
    (..., N, k) planes ``(nx, ny, nvx, nvy, nr)`` and their validity."""
    n = sx.shape[-1]
    half = window // 2
    offs = [o for o in range(-half, half + 1) if o != 0]
    idx = (torch.arange(n, device=sx.device)[:, None]
           + torch.tensor(offs, device=sx.device)[None, :]) % n   # (N, W)
    cx, cy, cvx, cvy, cr, ca = (a[..., idx] for a in (sx, sy, svx, svy, sr,
                                                      salive))
    dx = cx - sx[..., None]
    dy = cy - sy[..., None]
    d2 = dx * dx + dy * dy
    ok = ca & (d2 <= neigh_dist * neigh_dist) & salive[..., None]
    d2 = torch.where(ok, d2, torch.inf)
    (nx, ny, nvx, nvy, nr), valid = _k_nearest(d2, (cx, cy, cvx, cvy, cr), k)
    return nx, ny, nvx, nvy, nr, valid


def _full_neighbors(px, py, vx, vy, radius, alive, k: int, neigh_dist):
    """The exact ``k`` nearest over all N x N pairs (small N; a batch's
    rows each over their own (N, N))."""
    n = px.shape[-1]
    dx = px[..., None, :] - px[..., :, None]
    dy = py[..., None, :] - py[..., :, None]
    d2 = dx * dx + dy * dy
    eye = torch.eye(n, dtype=torch.bool, device=px.device)
    ok = (alive[..., None, :] & alive[..., :, None] & ~eye
          & (d2 <= neigh_dist * neigh_dist))
    d2 = torch.where(ok, d2, torch.inf)
    (nx, ny, nvx, nvy, nr), valid = _k_nearest(
        d2, tuple(a[..., None, :].expand(d2.shape)
                  for a in (px, py, vx, vy, radius)), k)
    return nx, ny, nvx, nvy, nr, valid


def _vehicle_constraints(ex, ey, evx, evy, er, veh_snap, k: int,
                         neigh_dist, tau, dt: float):
    """Half-planes against the ``k`` nearest active vehicles as bounding
    discs (the circle around the extent box); the walker takes the whole
    correction.  Ego planes (..., N), the vehicles shared or, for a batch
    of fleets, each crowd's own ``(B, V)``; returns (..., N, k) constraint
    planes and their validity."""
    def veh(a):
        """A vehicle plane against the (..., N, V) planes."""
        return a[..., None, :]

    cvx, cvy = veh(veh_snap.center[..., 0]), veh(veh_snap.center[..., 1])
    vvx, vvy = veh(veh_snap.vel[..., 0]), veh(veh_snap.vel[..., 1])
    vr = torch.sqrt(veh_snap.extent[:, 0] ** 2 + veh_snap.extent[:, 1] ** 2)
    act = veh(veh_snap.active.to(torch.bool))
    dx = cvx - ex[..., None]                  # (..., N, V)
    dy = cvy - ey[..., None]
    d2 = dx * dx + dy * dy
    ok = act & (d2 <= neigh_dist * neigh_dist)
    d2 = torch.where(ok, d2, torch.inf)
    shp = d2.shape
    (sx, sy, svx, svy, sr), valid = _k_nearest(
        d2, tuple(a.expand(shp) for a in (cvx, cvy, vvx, vvy, vr)),
        min(k, vr.shape[0]))
    ux, uy, nx, ny = orca_halfplane(
        sx - ex[..., None], sy - ey[..., None], evx[..., None] - svx,
        evy[..., None] - svy, er[..., None] + sr, tau, dt)
    return evx[..., None] + ux, evy[..., None] + uy, nx, ny, valid


def _as_source(src, device):
    """A wall source as the feed reads it: a
    :class:`..env.pointsets.StaticFeatures` as it is, a host-side
    ``ChunkedPointSet`` as its chunks on ``device``."""
    from ..env.pointsets import (ChunkedPointSet, StaticFeatures,
                                 chunk_features)
    if isinstance(src, ChunkedPointSet):
        return StaticFeatures(rest=chunk_features(src, device))
    return src


def _static_topk(ex, ey, src, k: int, neigh_dist, alive,
                 plain: bool = False):
    """(k, N) nearest-wall-feature planes ``(d2, wx, wy)`` (``d2 = inf`` in
    empty slots) of one wall source: each part of the split
    (:class:`..env.pointsets.StaticFeatures`) gives its own top-k, and a
    (2k, N) merge picks the overall ``k`` (exact: a feature lives in one
    part).  ``plain``: the plain version on any device.  A batch's ``(B,
    N)`` planes give (B, k, N), ``neigh_dist`` a number or a sweep's
    ``(B,)`` tensor.  (JAX package orca.py:461-495.)"""
    from .geometry import k_smallest_features
    from .statics import nearest_features_topk, topk_plain
    parts = [topk_plain(ex, ey, part, k, neigh_dist) if plain
             else nearest_features_topk(ex, ey, part, k, neigh_dist,
                                        alive=alive)
             for part in (src.seg, src.rest) if part is not None]
    if not parts:
        shape = (*ex.shape[:-1], k, ex.shape[-1])
        z = ex.new_zeros(shape)
        return ex.new_full(shape, torch.inf), z, z
    if len(parts) == 1:
        return parts[0]
    d2, wx, wy = (torch.cat(p, dim=-2) for p in zip(*parts))
    dfin = torch.where(torch.isfinite(d2), d2, 0.0)
    (swx, swy, sd2), valid = k_smallest_features(d2, (wx, wy, dfin), k)
    return torch.where(valid, sd2, torch.inf), swx, swy


def _static_constraints(ex, ey, er, exempt, alive, src, k: int,
                        tau_static, dt: float, neigh_dist,
                        plain: bool = False):
    """Hard half-planes against the ``k`` nearest wall features: for a
    straight wall at body gap ``g = d - r`` the velocities that stay clear
    for ``tau_static`` are ``v . n >= -g / tau_static`` (``n`` the unit
    normal away from the wall); a penetrating row (``g < 0``) gets the
    one-step push-out ``v . n >= -g / dt``.  ``exempt`` rows (road-crossing
    modes, which step over the curb) get no constraint.  Returns (N, k)
    constraint planes and their validity; a batch's (B, N, k), with
    ``tau_static`` a number or a sweep's ``(B, 1, 1)`` column.  (JAX
    package orca.py:498-543.)"""
    sd2, swx, swy = _static_topk(ex, ey, src, k, neigh_dist, alive, plain)
    valid = torch.isfinite(sd2) & ~exempt[..., None, :]        # (..., k, N)
    sd = torch.where(valid, torch.sqrt(torch.where(valid, sd2, 1.0)), 0.0)
    nx, ny, _ = _safe_unit(ex[..., None, :] - swx, ey[..., None, :] - swy)
    gap = sd - er[..., None, :]
    horizon = torch.where(gap >= 0.0,
                          tau_static if isinstance(tau_static, torch.Tensor)
                          else gap.new_tensor(tau_static),
                          gap.new_tensor(dt))
    rhs = -gap / horizon             # the constraint: v . n >= rhs
    return tuple(a.transpose(-1, -2)
                 for a in (rhs * nx, rhs * ny, nx, ny, valid))


def orca_velocities(pos, vel, radius, alive, pref, vmax, params, dt: float,
                    veh_snap=None, spatial_order: str = "hilbert",
                    borders=None, obstacles=None, static_exempt=None,
                    order=None, plain_feed: bool = False, axis=None):
    """New velocities of every agent under ORCA (the JAX package's
    orca.py:546-663).

    ``pos``/``vel``/``pref``: (x, y) plane pairs (N,); ``radius``/``vmax``
    (N,); ``alive`` (N,) bool.  ``pref`` is the preferred velocity (the
    force-integrated, capped velocity of the step).  ``params`` an
    ``OrcaParams``.  ``veh_snap`` this step's vehicles.  ``borders`` /
    ``obstacles``: wall sources (a :class:`..env.pointsets.StaticFeatures`
    split, or a host-side ``ChunkedPointSet``) for the ``max_statics``
    nearest wall features each; ``static_exempt`` (N,) bool rows that the
    walls skip.  ``order``: an optional ``(perm, inv)`` of
    :func:`.spatial.morton_order` with ``spatial_order`` on these positions
    and ``alive``, so that a step sorting for another kernel sorts once.
    ``plain_feed``: the wall feed's plain version even on a card (the
    reference its kernels are compared with).  ``axis``: the planes are
    this shard's slots of an agent axis; they are all-gathered, every
    shard solves the whole crowd (neighbour windows span the shards as on
    one device) and keeps its own rows (orca.py:591-597, :659-660);
    ``order`` must then be None.

    A batch of B crowds: every plane ``(B, N)`` (``order`` each row's
    permutation), ``params`` shared or a sweep's with ``(B,)`` leaves of
    ``tau``, ``neighbor_dist`` and ``tau_static``; the walls shared, the
    vehicles shared or each crowd's own fleet (``(B, V)`` snapshot planes).
    With ``axis``, each shard's ``(B, n)`` slots: every crowd gathered along
    the last axis and solved whole, each shard keeping its own columns (the
    JAX package's sharded ORCA under vmap).

    Returns ``(vx, vy)``, valid where ``alive`` (dead rows undefined)."""
    px, py = pos
    vx, vy = vel
    prx, pry = pref
    use_statics = ((borders is not None or obstacles is not None)
                   and params.max_statics > 0)
    exm = (static_exempt if static_exempt is not None
           else torch.zeros_like(alive))
    # a sweep's leaves as columns against the (B, N, k) and (B, k, N)
    # planes; the wall feed takes the (B,) neighbour distance itself (a
    # 0-d leaf is one value, as calibration fits it)
    tau, nd, tau_static = (
        v[:, None, None] if isinstance(v, torch.Tensor) and v.dim() == 1
        else v
        for v in (params.tau, params.neighbor_dist, params.tau_static))
    if axis is not None:
        if order is not None:
            raise ValueError("a sharded ORCA sorts the gathered crowd: pass "
                             "no order")
        local_n = px.shape[-1]
        px, py, vx, vy, radius, alive, prx, pry, vmax, exm = (
            axis.all_gather(a) for a in (px, py, vx, vy, radius, alive, prx,
                                         pry, vmax, exm))
    n = px.shape[-1]
    k = params.max_neighbors
    window = params.window if params.window else n

    if window >= n:
        nx, ny, nvx, nvy, nr, valid = _full_neighbors(
            px, py, vx, vy, radius, alive, k, nd)
        ex, ey, evx, evy, er = px, py, vx, vy, radius
        eprx, epry, evmax, eexm, ealive = prx, pry, vmax, exm, alive
        inv = None
    else:
        perm, inv = order if order is not None else morton_order(
            px, py, alive, spatial_order)
        (ex, ey, evx, evy, er, eprx, epry, evmax, ealive, eexm) = (
            torch.gather(a, -1, perm) for a in (px, py, vx, vy, radius, prx,
                                                pry, vmax, alive, exm))
        nx, ny, nvx, nvy, nr, valid = _window_neighbors(
            ex, ey, evx, evy, er, ealive, window, k, nd)

    # agent-agent half-planes (reciprocal: each takes u/2)
    ux, uy, hx, hy = orca_halfplane(
        nx - ex[..., None], ny - ey[..., None], evx[..., None] - nvx,
        evy[..., None] - nvy, er[..., None] + nr, tau, dt)
    cons = [(evx[..., None] + 0.5 * ux, evy[..., None] + 0.5 * uy, hx, hy,
             valid)]
    if veh_snap is not None and params.max_vehicles > 0:
        cons.append(_vehicle_constraints(
            ex, ey, evx, evy, er, veh_snap, params.max_vehicles, nd, tau,
            dt))
    if use_statics:
        for src in (borders, obstacles):
            if src is not None:
                cons.append(_static_constraints(
                    ex, ey, er, eexm, ealive, _as_source(src, px.device),
                    params.max_statics, tau_static, dt,
                    params.neighbor_dist, plain_feed))
    ptx, pty, hx, hy, valid = (torch.cat(c, dim=-1) for c in zip(*cons))

    # the programs over every row of every crowd, (B * N, C)
    c = ptx.shape[-1]
    ovx, ovy = solve_orca_lp(
        eprx.reshape(-1), epry.reshape(-1), ptx.reshape(-1, c),
        pty.reshape(-1, c), hx.reshape(-1, c), hy.reshape(-1, c),
        valid.reshape(-1, c), evmax.reshape(-1))
    ovx, ovy = ovx.view(px.shape), ovy.view(px.shape)
    if inv is not None:
        ovx, ovy = torch.gather(ovx, -1, inv), torch.gather(ovy, -1, inv)
    if axis is not None:
        rows = slice(axis.index * local_n, (axis.index + 1) * local_n)
        ovx, ovy = ovx[..., rows], ovy[..., rows]
    return ovx, ovy
