"""Moussaid et al. (2010) social-group forces (port of models/groups.py).

The three group terms of Moussaid, Perozo, Garnier, Helbing & Theraulaz,
"The walking behaviour of pedestrian social groups and its impact on crowd
dynamics" (PLoS ONE 5(4):e10047), on top of any pair-force family: a gaze
term that slows a member who must turn its head to keep the others in view,
an attraction toward the other members' centroid beyond a size-dependent
distance, and a repulsion between members closer than ``rep_distance``.

Membership is static: the host builds a ``(G, M)`` table of member slots
(:func:`build_groups`) from the per-slot group ids.  Each step gathers the
members' state in one packed gather, computes the terms in the small
``(G, M)`` member space and adds them back to the slots in one
``index_add_``, so the cost follows the grouped members, not the crowd.
Plain tensor math: the JAX package has no kernel here, and the port adds
none.  Single device (the JAX package's sharded form belongs to the
multi-device slice).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device
from .params import GroupParams


@dataclass(frozen=True)
class GroupSet:
    """Static group structure (host-built; see :func:`build_groups`).

    ``member_slot``: (G, M) int64 slot indices of each group's members,
    ascending, padded with -1 (the JAX package holds the same table as
    int32; int64 is what ``torch`` indexes with)."""

    member_slot: torch.Tensor

    @property
    def n_groups(self) -> int:
        return self.member_slot.shape[0]

    @property
    def max_members(self) -> int:
        return self.member_slot.shape[1]


def build_groups(group_id, max_members: int = 8,
                 device: torch.device | str = DEFAULT_DEVICE
                 ) -> GroupSet | None:
    """The (G, M) member table from per-slot group ids, on ``device``.

    ``group_id``: (N,) ints, -1 = not in a group; ids need not be
    contiguous, and groups come in ascending id order.  Returns None when
    no slot is grouped.  A group larger than ``max_members`` raises."""
    device = resolve_device(device)
    group_id = np.asarray(group_id)
    ids = np.unique(group_id[group_id >= 0])
    if ids.size == 0:
        return None
    counts = {g: int((group_id == g).sum()) for g in ids}
    biggest = max(counts.values())
    if biggest > max_members:
        raise ValueError(
            f"group of {biggest} members exceeds max_members={max_members}; "
            f"raise max_members in build_groups")
    table = np.full((ids.size, max_members), -1, np.int64)
    for row, g in enumerate(ids):
        slots = np.nonzero(group_id == g)[0]
        table[row, : slots.size] = slots
    return GroupSet(member_slot=torch.from_numpy(table).to(device))


def group_force(pos_x, pos_y, vel_x, vel_y, ex, ey, alive, groups: GroupSet,
                p: GroupParams, axis=None):
    """``(fx, fy)`` planes of the Moussaid-2010 group force on every slot.

    ``ex, ey``: the members' desired (gaze) directions; the stepper passes
    the unit direction toward the next waypoint.  Slots in no group, dead
    members and the last alive member of a group get exactly 0, and no
    operand that vanishes (a member on the others' centroid, a zero gaze,
    two coincident members) reaches a root, a division or an atan2.

    ``axis``: the planes are this shard's slots of an agent axis; the
    member table holds global slots, so the planes are all-gathered and
    each shard keeps the forces of its own slots (the JAX package's
    groups.py:85-99)."""
    n = pos_x.shape[0]
    planes = (pos_x, pos_y, vel_x, vel_y, ex, ey, alive)
    offset = 0
    if axis is not None:
        planes = tuple(axis.all_gather(a) for a in planes)
        offset = axis.index * n
    n_global = planes[0].shape[0]
    ms = groups.member_slot                               # (G, M)
    valid = ms >= 0
    idx = ms.clamp(min=0)
    # one packed gather of the members' seven planes
    packed = torch.stack([*planes[:6], planes[6].to(pos_x.dtype)],
                         dim=-1)                          # (N, 7)
    m = packed[idx]                                       # (G, M, 7)
    mpx, mpy, mvx, mvy, mex, mey = m.unbind(-1)[:6]
    mal = (m[..., 6] > 0.0) & valid                       # member liveness

    w = mal.to(mpx.dtype)
    cnt = w.sum(dim=1, keepdim=True)                      # (G, 1)
    sx = (mpx * w).sum(dim=1, keepdim=True)
    sy = (mpy * w).sum(dim=1, keepdim=True)
    # the centroid of the OTHER alive members, per member
    others = torch.clamp(cnt - 1.0, min=1.0)
    ocx = (sx - mpx * w) / others
    ocy = (sy - mpy * w) / others
    act = mal & (cnt >= 2.0)                              # needs 2 members

    dx = ocx - mpx                                        # member -> others
    dy = ocy - mpy
    d2 = dx * dx + dy * dy
    use = act & (d2 > 0.0)
    dist = torch.sqrt(torch.where(use, d2, 1.0))
    inv = torch.where(use, 1.0 / dist, 0.0)
    ux = dx * inv
    uy = dy * inv

    # gaze: alpha = |angle(e_i, direction to the others' centroid)| damps
    # the velocity (f_vis = -beta_vis * alpha * v_i); a zero gaze vector
    # on a used lane is re-based to alpha = 0
    cross = torch.where(use, mex * dy - mey * dx, 0.0)
    dot = torch.where(use, mex * dx + mey * dy, 1.0)
    dot = torch.where((cross == 0.0) & (dot == 0.0), 1.0, dot)
    alpha = torch.atan2(cross, dot).abs()
    aw = torch.where(use, p.beta_vis * alpha, 0.0)
    fx = -aw * mvx
    fy = -aw * mvy

    # attraction toward the others' centroid beyond (M - 1)/2 m, M the
    # alive group size
    q_att = use & (dist > (cnt - 1.0) * 0.5)
    fx = fx + torch.where(q_att, p.beta_att * ux, 0.0)
    fy = fy + torch.where(q_att, p.beta_att * uy, 0.0)

    # within-group repulsion away from each member closer than
    # rep_distance
    rdx = mpx[:, :, None] - mpx[:, None, :]               # (G, M, M): k -> i
    rdy = mpy[:, :, None] - mpy[:, None, :]
    rd2 = rdx * rdx + rdy * rdy
    rinv = torch.where(rd2 == 0.0, 0.0,
                       1.0 / torch.sqrt(torch.where(rd2 == 0.0, 1.0, rd2)))
    pair = (mal[:, :, None] & mal[:, None, :] & (rd2 > 0.0)
            & (rd2 < p.rep_distance * p.rep_distance))
    rw = torch.where(pair, p.beta_rep * rinv, 0.0)
    fx = fx + (rw * rdx).sum(dim=2)
    fy = fy + (rw * rdy).sum(dim=2)

    # one packed scatter back to this shard's slots; padded and dead
    # members, and other shards' members, go to a spare row that is dropped
    tgt = torch.where(mal, idx, n_global).reshape(-1) - offset
    tgt = torch.where((tgt >= 0) & (tgt < n), tgt, n)
    out = torch.zeros((n + 1, 2), dtype=pos_x.dtype, device=pos_x.device)
    out.index_add_(0, tgt, torch.stack([fx.reshape(-1), fy.reshape(-1)],
                                       dim=-1))
    return out[:n, 0], out[:n, 1]
