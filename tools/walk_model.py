#!/usr/bin/env python3
"""A replay, on the CPU, of what the dense walks of
``csrc/pair_forces.cu`` do per 32-row block at phase 30's and phase 33's
shapes: the work a walk's culling rule leaves, counted from the data, not
timed.

Row sets against their columns, 50,000 agents at 0.25 a square metre
(``tests/shard_cases.shard_planes``, seed 35), 30 m cutoff:

* ``shard``: shard 1 of 4 quarter-density shards, each sorted on its own
  curve (the 2-D mesh's rows), against the 50,000 gathered columns (four
  runs each sorted on its own curve): the batched table walk 3r-b and the
  batched box-skip walk 2r-b (gathered);
* ``ring block``: the same rows against shard 2's 12,500-column block:
  the batched box-skip walk 2r-b on a ring step;
* ``whole``: the same crowd sorted as one, against itself: the unbatched
  table walk at 50,000;
* ``config #5``: with ``--square`` crowds of phase 30's config #5 + 30 m
  cutoff (``tests/batch_cases.batch_planes(256, 1000, seed=30,
  extent=35.0)``, each sorted on its own curve), every 32-row block of
  each against its own 1,000 columns: the batched box-skip walk 2c.

With ``--sym`` it replays instead the batched symmetric cutoff walks
(``pair_force_sym_batched_kernel<kTriangleBox | kSymTable, Law>``, rows 1c
of PERF.md) on phase 30's crowds: config #5 + 30 m (every 128-row tile of
crowds 0-3 of ``batch_planes(256, 1000, seed=30, extent=35.0)``) and 8 x
50,000 (``--blocks`` sampled 128-row tiles of crowds 0-1 of
``batch_planes(8, 50000, seed=31)``), each crowd sorted on its own curve
(:func:`sym_counts`).

With ``--dense`` it replays instead the layout of the batched all-tiles
walk (``pair_force_dense_batched_kernel<kAllTiles, Law>``, rows 2b and
2r-b of PERF.md) at phase 27's and phase 33's shapes, for the parent's
layout (``dense_walk``: one 32-row set a block, the cluster split of
``dense_splits``, 8 resident blocks an SM) and the redesign's
(``dense_batch_walk``: ``sets`` row sets a block and ``splits`` blocks a
row block from ``dense_batch_layout``, ``kDenseBatchBlocks`` an SM): the
blocks, the chunks a warp walks in each, the law steps a warp walks
between two block barriers, and the blocks' makespan over 132 SMs
(:func:`dense_replay`).  No data: without a cutoff every pair is walked.

With ``--ring`` it replays instead the schedule of the batched in-kernel
ring (``ring_force_batched_kernel`` of ``csrc/ring.cu``, row 6-b of
PERF.md) at phase 33's shapes, for the parent's assignment (one 32-row set
an item, 3 resident blocks an SM) and the redesign's (``sets`` row sets an
item from ``ring_batch_sets``, ``kRingBatchMinBlocks`` blocks an SM):
items and block-steps per block, and the makespan of the fill and done
dependencies under steps whose cost is the chunks a warp walks
(:func:`ring_replay`), with and without a wait latency.  No data: the
cutoff's culling is not replayed.

For ``--blocks`` sampled 32-row blocks (every warp of a block holds the
same 32 rows, one a lane) it counts the 256-column tiles with a chunk
whose box the block's alive rows reach (``tiles``) and the tiles whose own
box they reach (``tiles_box``: what ``dense_walk``'s box skip stages), the
32-column chunks whose boxes they reach (the chunks ``dense_walk`` tests
and ``chunk_walk`` stages) and those of them that hold a pair within the
cutoff (``chunks_with_pair``), the columns that some lane reaches (the
warp's law steps in ``dense_walk``: every column step where a lane's pair
is within the cutoff evaluates the law on all 32 lanes), the pairs within
the cutoff, and the warp's law steps when each lane walks its own pairs of
the chunk slot a warp owns with at most K chunks between the fastest and
the slowest lane (``--window``; 0 unbounded): K = 1 is one chunk at a
time, where a step serves every lane with a pair in that chunk, and
``chunk_walk``'s window is ``kChunkWindow``.  Per block, summed over its 8
chunk slots.

With ``--sym-all`` it replays instead the splits of the batched symmetric
all-pairs walk (``sym_batch_walk``: ``pair_force_sym_batched_kernel<
kTriangle, Law>`` and ``pair_force_sym_dense_batched_kernel<false, Law>``,
rows 1b and 4-b of PERF.md) at config #5's and the 2-D mesh's shapes, for
the parent's grid (a block a 128 x 128 tile pair) and the redesign's
(``sym_all_splits``): blocks, law evaluations and the makespan in items
over 132 SMs (:func:`sym_all_replay`).  No data: without a cutoff every
pair is walked.

    python3 tools/walk_model.py [--blocks 24] [--window 1,2,3,4,0] \
        [--square 3] [--sym] [--ring] [--dense] [--sym-all]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
N, SHARDS, CUTOFF, SEED = 50_000, 4, 30.0, 35
CHUNK, TILE_CHUNKS = 32, 8


def window_steps(pairs, window):
    """Warp steps to walk ``pairs`` ((chunks, 32): each lane's pairs in
    each chunk, in walk order) when a step serves each lane whose current
    chunk lies fewer than ``window`` chunks past the slowest lane's (0:
    no bound)."""
    n = pairs.shape[0]
    if n == 0:
        return 0
    if window <= 0 or window >= n:
        return int(pairs.sum(0).max())
    rem = pairs.clone()
    cur = torch.zeros(32, dtype=torch.long)
    steps = 0

    def advance():
        for lane in range(32):
            while cur[lane] < n and rem[cur[lane], lane] == 0:
                cur[lane] += 1

    advance()
    while (cur < n).any():
        tail = int(cur.min())
        live = ((cur < n) & (cur < tail + window)).nonzero()[:, 0]
        rem[cur[live], live] -= 1
        advance()
        steps += 1
    return steps


def block_counts(rows, cols, blocks, windows, seed=0, row_off=0, col_off=0):
    """Mean counts per sampled 32-row block of rows (x, y, alive) against
    cols (x, y, alive), whose first slots are global slots ``row_off`` and
    ``col_off`` (a pair of one slot is no pair); ``blocks`` None: every
    block."""
    x, y, a = rows
    cx, cy, ca = cols
    n_ch = -(-cx.shape[0] // CHUNK)
    pad = n_ch * CHUNK - cx.shape[0]

    def chunked(t, fill):
        return torch.cat([t, t.new_full((pad,), fill)]).view(n_ch, CHUNK)

    X, Y, A = chunked(cx, 0.0), chunked(cy, 0.0), chunked(ca, False)
    inf = torch.tensor(float("inf"))
    box = [torch.where(A, X, inf).amin(1), torch.where(A, X, -inf).amax(1),
           torch.where(A, Y, inf).amin(1), torch.where(A, Y, -inf).amax(1)]
    n_t = -(-n_ch // TILE_CHUNKS)
    tpad = n_t * TILE_CHUNKS - n_ch
    tbox = [torch.cat([b, b.new_full((tpad,), f)]).view(n_t, TILE_CHUNKS)
            for b, f in zip(box, (float("inf"), -float("inf"),
                                  float("inf"), -float("inf")))]
    tbox = [tbox[0].amin(1), tbox[1].amax(1), tbox[2].amin(1),
            tbox[3].amax(1)]
    c2 = CUTOFF * CUTOFF
    n_blk = -(-x.shape[0] // 32)
    pick = (range(n_blk) if blocks is None else np.random.default_rng(
        seed).choice(n_blk, blocks, replace=False))
    gj = torch.arange(n_ch * CHUNK).view(n_ch, CHUNK) + col_off
    tot = {"tiles": 0, "tiles_box": 0, "chunks": 0, "chunks_with_pair": 0,
           "law_steps": 0, "pairs": 0, **{f"window_{k}": 0 for k in windows}}
    done = 0
    for b in pick:
        sl = slice(32 * b, 32 * (b + 1))
        rx, ry, ra = x[sl], y[sl], a[sl]
        if not ra.any():
            continue
        gi = torch.arange(32 * b, 32 * b + rx.shape[0]) + row_off

        def reach(bx):
            gx = torch.clamp(torch.maximum(bx[0] - rx[ra].max(),
                                           rx[ra].min() - bx[1]), min=0)
            gy = torch.clamp(torch.maximum(bx[2] - ry[ra].max(),
                                           ry[ra].min() - bx[3]), min=0)
            return gx * gx + gy * gy <= c2

        hit = reach(box)
        tiles = torch.cat([hit, hit.new_zeros(-n_ch % TILE_CHUNKS)])
        tot["tiles"] += int(tiles.view(-1, TILE_CHUNKS).any(1).sum())
        tot["tiles_box"] += int(reach(tbox).sum())
        tot["chunks"] += int(hit.sum())
        for q in range(TILE_CHUNKS):
            idx = [c for c in hit.nonzero()[:, 0].tolist()
                   if c % TILE_CHUNKS == q]
            if not idx:
                continue
            idx = torch.tensor(idx)
            dx = X[idx][:, :, None] - rx[None, None, :]
            dy = Y[idx][:, :, None] - ry[None, None, :]
            ok = ((dx * dx + dy * dy <= c2) & A[idx][:, :, None]
                  & ra[None, None, :]
                  & (gj[idx][:, :, None] != gi[None, None, :]))
            tot["chunks_with_pair"] += int(ok.flatten(1).any(1).sum())
            tot["law_steps"] += int(ok.any(2).sum())
            per_lane = ok.sum(1)
            tot["pairs"] += int(per_lane.sum())
            for k in windows:
                tot[f"window_{k}"] += window_steps(per_lane, k)
        done += 1
    return {k: round(v / done, 2) for k, v in tot.items()}


SYM_TILE, SYM_WARPS = 128, 4


def _boxes(x, y, a, size):
    """(k, 4) float32 boxes [min_x, max_x, min_y, max_y] of the alive
    agents of each ``size`` consecutive slots (padded planes), inverted
    infinite where none is alive."""
    inf = torch.tensor(float("inf"))
    X, Y, A = (t.view(-1, size) for t in (x, y, a))
    return torch.stack([torch.where(A, X, inf).amin(1),
                        torch.where(A, X, -inf).amax(1),
                        torch.where(A, Y, inf).amin(1),
                        torch.where(A, Y, -inf).amax(1)], 1)


def _reach(rb, cb, c2):
    """``box_gap2(rb, cb) <= c2`` of ``csrc/pair_forces.cuh``, each
    operation rounded in float32 (boxes ``(..., 4)``)."""
    gx = torch.clamp(torch.maximum(cb[..., 0] - rb[..., 1],
                                   rb[..., 0] - cb[..., 1]), min=0.0)
    gy = torch.clamp(torch.maximum(cb[..., 2] - rb[..., 3],
                                   rb[..., 2] - cb[..., 3]), min=0.0)
    return gx * gx + gy * gy <= c2


#: the staggered schedule: lane L meets column (L + s) mod 32 at step s
_STAGGER = (torch.arange(32)[:, None] + torch.arange(32)[None, :]) % 32


def change_steps(diag, r, c):
    """Steps ``(s0, s1, half)`` of row chunk ``r`` against column chunk
    ``c`` in ``sym_rows_walk`` (``csrc/pair_forces.cu``; two items of 16
    steps each, 0-15 and 16-31), or None: every step off the diagonal; on
    it every step of a chunk pair with ``r < c``, steps 1-16 of a chunk
    against itself (at step 16 only lanes below 16), none with ``r > c``
    (the pair ``(c, r)`` takes those pairs)."""
    if not diag or r < c:
        return 0, 31, False
    return (1, 16, True) if r == c else None


def sym_counts(planes, cutoff, windows, rows=None, max_surv=32,
               splits=2):
    """What the batched symmetric cutoff walks do on one crowd sorted on
    its curve, ``planes`` = (x, y, alive): for row tiles ``rows`` (None:
    every one), the column tiles from the row's own on that the tile-box
    test keeps (the triangle-box walk's tile pairs, and the table's
    listed ones), and in each kept tile pair, for each warp of 32 rows and
    each 32-column chunk:

    * the parent (``sym_walk`` -> ``sym_tile_pair``, one block a tile
      pair): chunk pairs tested and kept (the triangle leaves the chunk a
      pair above a row, and the chunk's box is within the cutoff of the
      rows'), the staggered schedule's warp law steps (a step where some
      lane's pair with column index above its row's lies within the
      cutoff: the ballot) and its column steps without a law evaluation,
      the pairs within the cutoff, and the warp steps if each lane walked
      its own pairs with a window of K chunks (``windows``; 0 unbounded)
      within the tile pair and across the row tile;
    * the change (``sym_rows_walk``): chunk pairs kept (the box test, on
      the diagonal tile the pairs of row chunk r and column chunk c >= r),
      its law steps and steps without a law on the schedule of
      :func:`change_steps`, and its pairs (each unordered pair once, as
      the parent's).

    Returns ``(per_tile_pair, per_row)``: means over the kept tile pairs,
    and over the row tiles (``tiles``: kept tile pairs a row, with the
    table of ``max_surv`` slots the rows that overflow it, and the blocks
    each walk launches for the row: the parent's table ``max_surv``, the
    triangle's ``nt - ti``, the change's ``splits``)."""
    x, y, a = planes
    n = x.shape[0]
    nt = -(-n // SYM_TILE)
    pad = nt * SYM_TILE - n
    X = torch.cat([x, x.new_zeros(pad)])
    Y = torch.cat([y, y.new_zeros(pad)])
    A = torch.cat([a, a.new_zeros(pad, dtype=torch.bool)])
    tbox = _boxes(X, Y, A, SYM_TILE)
    cbox = _boxes(X, Y, A, 32)
    wbox = cbox  # a warp's 32 rows are a chunk of the same planes
    c2 = float(np.float32(cutoff * cutoff))
    lanes = torch.arange(32)[:, None]
    keys = ("chunk_pairs_tested", "chunk_pairs_kept", "law_steps",
            "steps_without_law", "pairs", "change_chunk_pairs_kept",
            "change_law_steps", "change_steps_without_law", "change_pairs",
            *(f"window_{k}_tile" for k in windows),
            *(f"window_{k}_row" for k in windows))
    tot = dict.fromkeys(keys, 0)
    rows_tot = {"tiles": 0, "overflowing_rows": 0, "parent_table_blocks": 0,
                "parent_triangle_blocks": 0, "change_blocks": 0,
                "change_blocks_without_tile": 0}
    kept_pairs = 0
    pick = range(nt) if rows is None else rows
    for ti in pick:
        kept = [tj for tj in range(ti, nt)
                if bool(_reach(tbox[ti], tbox[tj], c2))]
        rows_tot["tiles"] += len(kept)
        rows_tot["overflowing_rows"] += len(kept) > max_surv
        rows_tot["parent_table_blocks"] += max_surv
        rows_tot["parent_triangle_blocks"] += nt - ti
        s = min(splits, nt)
        rows_tot["change_blocks"] += s
        rows_tot["change_blocks_without_tile"] += sum(
            1 for k in range(s) if k >= len(kept))
        kept_pairs += len(kept)
        rs = slice(ti * SYM_TILE, (ti + 1) * SYM_TILE)
        gi = torch.arange(rs.start, rs.stop)
        row_seq = [[] for _ in range(SYM_WARPS)]
        for tj in kept:
            cs = slice(tj * SYM_TILE, (tj + 1) * SYM_TILE)
            gj = torch.arange(cs.start, cs.stop)
            dx = X[cs][None, :] - X[rs][:, None]
            dy = Y[cs][None, :] - Y[rs][:, None]
            full = (A[rs][:, None] & A[cs][None, :] & (gi[:, None] != gj)
                    & (dx * dx + dy * dy <= c2))
            upper = full & (gj[None, :] > gi[:, None])
            for w in range(SYM_WARPS):
                tile_seq = []
                for c in range(SYM_WARPS):
                    rw, cc = slice(32 * w, 32 * w + 32), slice(32 * c,
                                                               32 * c + 32)
                    box = bool(_reach(wbox[ti * SYM_WARPS + w],
                                      cbox[tj * SYM_WARPS + c], c2))
                    tot["chunk_pairs_tested"] += 1
                    tri = tj * SYM_TILE + 32 * c + 31 > ti * SYM_TILE + 32 * w
                    if tri and box:
                        tot["chunk_pairs_kept"] += 1
                        ok = upper[rw, cc]
                        law = int(ok[lanes, _STAGGER].any(0).sum())
                        tot["law_steps"] += law
                        tot["steps_without_law"] += 32 - law
                        tot["pairs"] += int(ok.sum())
                        tile_seq.append(ok.sum(1))
                    steps = change_steps(tj == ti, w, c)
                    if box and steps is not None:
                        tot["change_chunk_pairs_kept"] += 1
                        s0, s1, half = steps
                        ok = full[rw, cc][lanes, _STAGGER][:, s0:s1 + 1]
                        if half:
                            ok = ok.clone()
                            ok[16:, -1] = False
                        law = int(ok.any(0).sum())
                        tot["change_law_steps"] += law
                        tot["change_steps_without_law"] += s1 - s0 + 1 - law
                        tot["change_pairs"] += int(ok.sum())
                if tile_seq:
                    seq = torch.stack(tile_seq)
                    for k in windows:
                        tot[f"window_{k}_tile"] += window_steps(seq, k)
                    row_seq[w] += tile_seq
        for w in range(SYM_WARPS):
            if row_seq[w]:
                seq = torch.stack(row_seq[w])
                for k in windows:
                    tot[f"window_{k}_row"] += window_steps(seq, k)
    per_pair = {k: round(v / max(kept_pairs, 1), 2) for k, v in tot.items()}
    per_pair["lane_use"] = round(tot["pairs"] / max(
        32 * tot["law_steps"], 1), 3)
    per_pair["change_lane_use"] = round(tot["change_pairs"] / max(
        32 * tot["change_law_steps"], 1), 3)
    per_row = {k: round(v / max(len(pick), 1), 2)
               for k, v in rows_tot.items()}
    return per_pair, {**per_row, "rows": len(pick),
                      "tile_pairs": kept_pairs, "totals": tot}


def sym_main(args, windows):
    """``--sym``: :func:`sym_counts` at phase 30's two shapes."""
    import batch_cases as bc
    small = bc.sort_rows(bc.batch_planes(4, 1000, seed=30, device="cpu",
                                         extent=35.0))
    big = bc.sort_rows(bc.batch_planes(2, 50_000, seed=31, device="cpu",
                                       extent=max(25.0, 50_000 ** 0.5)))
    for name, planes, sample in (("config #5 + 30 m", small, None),
                                 ("8 x 50,000", big, args.blocks)):
        nt = -(-planes[0].shape[1] // SYM_TILE)
        for b in range(planes[0].shape[0]):
            rows = (None if sample is None else sorted(
                np.random.default_rng(b).choice(nt, sample,
                                                replace=False).tolist()))
            pair, row = sym_counts((planes[0][b], planes[1][b],
                                    planes[5][b]), CUTOFF, windows, rows)
            print(json.dumps({"rows": name, "crowd": b,
                              "per_tile_pair": pair,
                              "per_row": row}), flush=True)


#: the card's SMs, and the parent's resident blocks an SM (kRingMinBlocks)
SMS, RING_PARENT_PER_SM = 132, 3


def ring_batch_min_blocks(root=ROOT):
    """``kRingBatchMinBlocks`` of ``csrc/ring.cu`` at ``root``: the
    redesign's resident blocks an SM (its launch bounds; at 256 threads
    and 64 registers no more fit)."""
    import re
    src = (root / "carla_social_force_model_tpu_torch" / "csrc"
           / "ring.cu").read_text()
    return int(re.search(r"constexpr int kRingBatchMinBlocks = (\d+);",
                         src).group(1))


def ring_sets(crowds, n_dev, n_local, per_sm, sms=SMS):
    """``ring_batch_sets`` of ``csrc/ring.cu``: the row sets an item of the
    batched ring holds, the least rounds x (sets x tiles + 1), ties to more
    sets."""
    per_dev = per_sm * sms // n_dev
    if per_dev < 1:
        return 1
    nsets = -(-n_local // 32)
    nct = -(-n_local // 256)
    best, best_cost = 1, 0
    for s in (1, 2, 4, 8):
        items = crowds * -(-nsets // s)
        cost = -(-items // min(items, per_dev)) * (s * nct + 1)
        if s == 1 or cost <= best_cost:
            best, best_cost = s, cost
    return best


def ring_layout(crowds, n_dev, n_local, new, per_sm, sms=SMS):
    """``(sets, groups, G, multi)`` of one launch (``ring_try``): row sets
    an item, items (groups of sets) of a (crowd, device), blocks of a
    device, and the kMulti form.  The parent's item is one 32-row set, and
    its kMulti form (a block holds several groups of a crowd) walks crowd
    by crowd as its other form; the redesign walks crowd by crowd only
    where G is a multiple of the groups, else step by step (kMulti)."""
    per_dev = per_sm * sms // n_dev
    sets = ring_sets(crowds, n_dev, n_local, per_sm, sms) if new else 1
    groups = -(-(-(-n_local // 32)) // sets)
    g = min(crowds * groups, per_dev)
    multi = groups > per_dev or (new and g % groups != 0)
    return sets, groups, g, multi


def ring_assignment(crowds, groups, G):
    """{block: [(crowd, [groups])]} of one device by the kernel's rule:
    block x walks crowd b with rank (x - b * groups) mod G when that rank
    is below P = min(groups, G), and then its groups rank, rank + G, ...;
    crowds in ascending order."""
    P = min(groups, G)
    out = {}
    for x in range(G):
        mine = []
        for b in range(crowds):
            rank = (x - b * groups) % G
            if rank < P:
                mine.append((b, list(range(rank, groups, G))))
        out[x] = mine
    return out


def ring_replay(crowds, n_dev, n_local, new, per_sm, latency=0.0,
                sms=SMS):
    """The batched ring's schedule on one launch, replayed: every block of
    every device walks its crowds' D ring steps in order (same blocks on
    every device); a step costs the chunks a warp walks (the parent's one
    chunk a tile, the redesign's ``sets`` chunks a tile, for each group the
    block holds) and starts once the block is free, the left neighbour's
    blocks of the crowd have forwarded into the slot (step k >= 1) and,
    before the block forwards at step k >= 2, the right neighbour's blocks
    have handed back the slot it fills; each hand-over lands ``latency``
    units after it is made.  A block forwards at the start of a step; the
    parent hands a slot back at the end of the step, the redesign once it
    has staged the slot's last tile (the start of the step's last tile).
    The redesign's kMulti form takes a block's (crowd, step) tasks step by
    step, the others crowd by crowd.  No SM is modelled: blocks walk at
    one pace (on the card they do not, which is what the redesign's
    per-device crowd counters answer).  Returns the counts per device
    (the same on every device)."""
    sets, groups, G, multi = ring_layout(crowds, n_dev, n_local, new, per_sm,
                                         sms)
    nct = -(-n_local // 256)
    assign = ring_assignment(crowds, groups, G)
    holders = {}  # crowd -> its blocks of a device
    for x, items in assign.items():
        for b, _ in items:
            holders.setdefault(b, []).append(x)
    fwd, back, free, pos = {}, {}, {}, {}
    step_major = new and multi
    tasks = {(x, d): sorted(((b, len(g), k) for b, g in assign[x]
                             for k in range(n_dev)),
                            key=(lambda t: (t[2], t[0])) if step_major
                            else (lambda t: (t[0], t[2])))
             for x in range(G) for d in range(n_dev)}
    for key in tasks:
        free[key], pos[key] = 0.0, 0
    left = sum(len(t) for t in tasks.values())
    while left:
        moved = False
        for (x, d), todo in tasks.items():
            while pos[(x, d)] < len(todo):
                b, nq, k = todo[pos[(x, d)]]
                deps = []
                if k >= 1:
                    deps += [fwd.get((y, (d - 1) % n_dev, b, k - 1))
                             for y in holders[b]]
                if 2 <= k < n_dev - 1:
                    deps += [back.get((y, (d + 1) % n_dev, b, k - 1))
                             for y in holders[b]]
                if any(t is None for t in deps):
                    break
                start = max([free[(x, d)]] + [t + latency for t in deps])
                per_group = (sets if new else 1) * nct
                cost = nq * per_group
                fwd[(x, d, b, k)] = start
                back[(x, d, b, k)] = (start + cost - (sets if new else 1)
                                      if new else start + cost)
                free[(x, d)] = start + cost
                pos[(x, d)] += 1
                left -= 1
                moved = True
        if not moved:
            raise RuntimeError("the replayed schedule deadlocks")
    steps = [len(tasks[(x, 0)]) for x in range(G)]
    units = [sum(nq * (sets if new else 1) * nct
                 for _, nq, _ in tasks[(x, 0)]) for x in range(G)]
    span = max(free.values())
    # one group a crowd and more crowds than blocks: the kernel's blocks
    # take crowds from their device's counter as they come free, which
    # with steps of equal cost is the order replayed here
    dynamic = new and not multi and groups == 1 and crowds > G
    return {"sets": sets, "groups": groups, "blocks": G, "multi": multi,
            "dynamic": dynamic,
            "blocks_per_sm": per_sm,
            "items_per_block": {
                "max": max(sum(len(g) for _, g in assign[x])
                           for x in range(G)),
                "mean": round(crowds * groups / G, 3)},
            "block_steps": {"busiest": max(steps),
                            "mean": round(sum(steps) / G, 3)},
            "units": {"busiest": max(units),
                      "mean": round(sum(units) / G, 3)},
            "makespan": round(span, 3),
            # a block's unit takes the SM's share of each of the blocks an
            # SM holds (the grid spread evenly)
            "sm_time": round(span * min(per_sm, G * n_dev / sms), 3)}


#: phase 33's ring shapes and the bench's: (label, crowds, devices, rows)
RING_SHAPES = (("256 x 4 x 250 (Moussaid)", 256, 4, 250),
               ("32 x 4 x 250 (power law, Helbing, 30 m)", 32, 4, 250),
               ("8 x 4 x 12,500 (30 m)", 8, 4, 12_500),
               ("B = 1 x 4 x 2,500", 1, 4, 2_500))


def ring_main(latencies=(0.0, 0.3)):
    """``--ring``: :func:`ring_replay` of the parent's and the redesign's
    rules at :data:`RING_SHAPES`, with and without a wait latency (in
    units of one chunk a warp)."""
    new_per_sm = ring_batch_min_blocks()
    for label, b, d, n in RING_SHAPES:
        for rule, new, per_sm in (("parent", False, RING_PARENT_PER_SM),
                                  ("change", True, new_per_sm)):
            row = {"shape": label, "rule": rule}
            for lat in latencies:
                got = ring_replay(b, d, n, new, per_sm, lat)
                row.update({k: v for k, v in got.items()
                            if k not in ("makespan", "sm_time")})
                row[f"makespan latency={lat:g}"] = got["makespan"]
                row[f"sm_time latency={lat:g}"] = got["sm_time"]
            print(json.dumps(row), flush=True)


#: the parent's resident blocks an SM of the all-tiles walk (dense_walk's
#: launch bounds: 2,048 threads of 256), the columns of a tile and the
#: most parts of a row
DENSE_PARENT_PER_SM, COL_TILE, MAX_SPLIT = 8, 256, 8


def pair_constant(name, root=ROOT):
    """The ``constexpr int`` ``name`` of ``csrc/pair_forces.cu`` at
    ``root``."""
    import re
    src = (root / "carla_social_force_model_tpu_torch" / "csrc"
           / "pair_forces.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def dense_batch_blocks(root=ROOT):
    """``kDenseBatchBlocks``: the redesign's resident blocks an SM (its
    launch bounds), which its layout rule takes."""
    return pair_constant("kDenseBatchBlocks", root)


def dense_parts(nct):
    """``dense_parts`` of ``csrc/pair_forces.cu``: the parts of a row's
    ``nct`` column tiles, a function of the column count only."""
    return max(nct, 1) if nct < MAX_SPLIT else MAX_SPLIT


def dense_layout(batch, n_rows, n_cols, per_sm, sms=SMS):
    """``dense_batch_layout`` of ``csrc/pair_forces.cu``: ``(sets,
    splits)`` of the batched all-tiles walk, the least (chunks a warp
    walks + 1 + 1 with a cluster) x (blocks + ``per_sm`` x ``sms``): the
    blocks' work over the resident slots plus one block's length; ties to
    more sets, then to fewer splits."""
    cap = max(per_sm, 1) * max(sms, 1)
    nsets = -(-n_rows // 32)
    nct = -(-n_cols // COL_TILE)
    parts = dense_parts(nct)
    per_part = -(-nct // parts)
    best, best_cost = (1, 1), None
    for s in (8, 4, 2, 1):
        sp = 1
        while sp <= min(parts, MAX_SPLIT):
            blocks = batch * -(-nsets // s) * sp
            tiles = -(-parts // sp) * per_part
            cost = (s * tiles + 1 + (sp > 1)) * (blocks + cap)
            if best_cost is None or cost < best_cost:
                best, best_cost = (s, sp), cost
            sp *= 2
    return best


def dense_splits(n_rows, n_cols, batch):
    """``dense_splits<kAllTiles>`` of ``csrc/pair_forces.cu``: the parent's
    blocks a 32-row block's parts are split over (about 640 (128-row tile,
    block) pairs)."""
    row_tiles = -(-n_rows // 128) * batch
    parts = dense_parts(-(-n_cols // COL_TILE))
    s = 1
    while s < parts and s * row_tiles < 640:
        s *= 2
    return min(s, parts)


def dense_replay(batch, n_rows, n_cols, new, per_sm, sms=SMS):
    """The batched all-tiles walk's blocks on one launch, replayed over
    ``sms`` SMs of ``per_sm`` resident blocks each: blocks in launch order
    (row blocks and splits fastest, then the crowds) each take the slot
    that frees first; a block costs the chunks a warp walks (``sets``
    chunks of each of its tiles; the parent's one) plus 1 for its staging,
    folds and stores, whatever its SM holds.  Returns the layout, the
    blocks, the chunks a warp walks in the busiest block, the law steps a
    warp walks between two block barriers (the parent: one chunk a tile
    between its two staging barriers; the redesign: all its chunks where
    its columns fit one staging window and it holds the eight slots of its
    rows, else a part's between the part's folds), the makespan, the SM
    time's mean and the share of SM time the blocks fill."""
    import heapq
    nct = -(-n_cols // COL_TILE)
    parts = dense_parts(nct)
    if new:
        sets, splits = dense_layout(batch, n_rows, n_cols, per_sm, sms)
    else:
        sets, splits = 1, dense_splits(n_rows, n_cols, batch)
    row_blocks = -(-n_rows // (32 * sets))
    costs = []
    for sp in range(splits):
        t0 = sp * parts // splits * nct // parts
        t1 = (sp + 1) * parts // splits * nct // parts
        costs.append(sets * (t1 - t0) + 1)
    slots = [(0.0, x) for x in range(sms * per_sm)]
    heapq.heapify(slots)
    busy = [0.0] * sms
    span = 0.0
    for _ in range(batch * row_blocks):
        for c in costs:
            free, x = heapq.heappop(slots)
            end = free + c
            busy[x // per_sm] += c
            span = max(span, end)
            heapq.heappush(slots, (end, x))
    per_part = -(-nct // parts)
    window = pair_constant("kDenseBatchWindow")  # tiles staged at once
    if not new:
        between = 32
    elif sets == 8 and -(-parts // splits) * per_part <= window:
        between = 32 * (max(costs) - 1)
    else:
        between = 32 * sets * min(per_part, window)
    return {"sets": sets, "splits": splits, "blocks": batch * row_blocks
            * splits, "blocks_per_sm": per_sm,
            "chunks_a_warp": max(costs) - 1,
            "law_steps_between_barriers": between,
            "makespan": span,
            "sm_time_mean": round(sum(busy) / sms / per_sm, 3),
            "fill": round(sum(busy) / (span * sms * per_sm), 4)}


#: phase 27's and phase 33's all-tiles shapes and the bench's B = 1:
#: (label, crowds, rows, columns)
DENSE_SHAPES = (("config #5: 256 x 1,000", 256, 1_000, 1_000),
                ("mesh gathered: 128 x 250 x 1,000", 128, 250, 1_000),
                ("mesh ring block: 128 x 250 x 250", 128, 250, 250),
                ("B = 1 x 10,000", 1, 10_000, 10_000))


def dense_main():
    """``--dense``: :func:`dense_replay` of the parent's and the redesign's
    layouts at :data:`DENSE_SHAPES`."""
    per_sm = dense_batch_blocks()
    for label, b, r, c in DENSE_SHAPES:
        for rule, new, k in (("parent", False, DENSE_PARENT_PER_SM),
                             ("change", True, per_sm)):
            print(json.dumps({"shape": label, "rule": rule,
                              **dense_replay(b, r, c, new, k)}), flush=True)


#: the batched symmetric all-pairs walk's costs in 16-step items a warp
#: (``kSymAllTileItems``, ``kSymAllDiagItems``, ``kSymAllBlockItems`` of
#: ``csrc/pair_forces.cu``: a column tile off the diagonal, the diagonal
#: tile, a block's fixed cost), its rows a lane and warps a block, and its
#: parent's resident blocks of four warps an SM (``sym_tile_pair`` without
#: a minimum: 72 registers, 7 blocks)
SYM_ALL_TILE, SYM_ALL_DIAG, SYM_ALL_FIXED = 4, 2, 1
SYM_ALL_ROWS, SYM_ALL_WARPS, SYM_PARENT_PER_SM = 2, 8, 7
#: the diagonal tile's items of each row group, ``(r, c, kind)``: row chunk
#: r against column chunk c, steps 0-15 (kind 0), 16-31 (1) or 1-16 with
#: only lanes below 16 at step 16 (2); ``sym_all_diag_item``'s words
SYM_ALL_DIAG_ITEMS = (
    ((0, 0, 2), (0, 1, 0), (0, 1, 1), (1, 1, 2), (0, 2, 0), (0, 2, 1),
     (1, 2, 0), (1, 2, 1)),
    ((2, 2, 2), (2, 3, 0), (2, 3, 1), (3, 3, 2), (3, 0, 0), (3, 0, 1),
     (3, 1, 0), (3, 1, 1)))


def sym_all_blocks(root=ROOT):
    """``kSymAllBlocks``: the redesign's resident blocks an SM (its launch
    bounds), which its split rule takes."""
    return pair_constant("kSymAllBlocks", root)


def sym_all_splits(batch, n_row_tiles, n_col_tiles, tri, per_sm, sms=SMS):
    """``sym_all_splits`` of ``csrc/pair_forces.cu``: the splits S of a row
    tile's column run in ``sym_batch_walk``, a power of two up to the
    longest run's candidates, the least estimate (in items) of the launch's
    length: the longest block where the blocks fit the resident slots at
    once, else the blocks' work over the slots plus the last block to
    start's length, and no less than the longest block; ties to fewer
    splits."""
    cap = max(per_sm, 1) * max(sms, 1)
    nr = n_row_tiles
    most = nr if tri else n_col_tiles
    tile, diag, fixed = SYM_ALL_TILE, SYM_ALL_DIAG, SYM_ALL_FIXED
    items = nr * diag + nr * (nr - 1) // 2 * tile if tri else nr * most * tile
    best, best_cost = 1, None
    s = 1
    while s <= most and nr * s <= 65535:
        per_crowd = s * (s + 1) // 2 + (nr - s) * s if tri else nr * s
        blocks = batch * per_crowd
        if tri:
            longest = max(diag + (most - 1) // s * tile,
                          ((most - 2) // s + 1) * tile if s > 1 else 0)
        else:
            longest = -(-most // s) * tile
        last = diag if tri else most // s * tile
        whole = (longest + fixed) * cap
        cost = whole if blocks <= cap else max(
            batch * (items + per_crowd * fixed) + (last + fixed) * cap,
            whole)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
        s *= 2
    return best


def sym_all_diag_words():
    """The two 64-bit words of ``sym_all_diag_item`` (byte k of word g:
    item k of row group g as r | c << 2 | kind << 4)."""
    return tuple(sum((r | c << 2 | kind << 4) << (8 * k)
                     for k, (r, c, kind) in enumerate(items))
                 for items in SYM_ALL_DIAG_ITEMS)


def sym_all_block_pairs(ti, split, n_split, n_rows, n_cols, tri):
    """Every (row, column) slot pair that block (ti, split) of
    ``sym_batch_walk`` hands the law (live or masked), in its order: its
    candidate tiles t_first + k S, each tile off the diagonal as warp w's
    column chunk w % 4 against row group w // 4's 64 rows (lane L's row 64
    g + 32 r + L meets column 32 c + (L + s) mod 32 at step s), the
    diagonal tile as warp w's items w % 4 and w % 4 + 4 of its group's
    :data:`SYM_ALL_DIAG_ITEMS` (skipped where a chunk starts past the
    agents); a chunk off the diagonal that starts past the columns is
    skipped.  Slots are of the block's own planes (rows and columns of one
    crowd); ``(rows, cols)`` int64 arrays, padded slots included."""
    nct = -(-n_cols // 128)
    first = (ti if tri else 0) + split
    lanes = np.arange(32)
    out_i, out_j = [], []
    for tj in range(first, nct, n_split):
        i0, j0 = 128 * ti, 128 * tj
        for w in range(SYM_ALL_WARPS):
            g, c = w // 4, w % 4
            if tri and tj == ti:
                for k in (w % 4, w % 4 + 4):
                    r, c, kind = SYM_ALL_DIAG_ITEMS[g][k]
                    if j0 + 32 * max(r, c) >= n_cols:
                        continue
                    s0 = 1 if kind == 2 else 16 * kind
                    for s in range(s0, s0 + 16):
                        ln = lanes[:16] if kind == 2 and s == 16 else lanes
                        out_i.append(i0 + 32 * r + ln)
                        out_j.append(j0 + 32 * c + (ln + s) % 32)
                continue
            if j0 + 32 * c >= n_cols:
                continue
            s = np.arange(32)[:, None, None]
            r = np.arange(SYM_ALL_ROWS)[None, None, :]
            ln = lanes[None, :, None]
            shape = (32, 32, SYM_ALL_ROWS)
            out_i.append(np.broadcast_to(i0 + 64 * g + ln + 32 * r,
                                         shape).ravel())
            out_j.append(np.broadcast_to(j0 + 32 * c + (ln + s) % 32,
                                         shape).ravel())
    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return (np.concatenate(out_i).astype(np.int64),
            np.concatenate(out_j).astype(np.int64))


def sym_all_costs(n_row_tiles, n_col_tiles, tri, n_split):
    """The items of each block (ti, split) of one crowd in launch order
    (row tiles, then splits; a split without a tile left out), without the
    fixed cost."""
    most = n_col_tiles
    out = []
    for ti in range(n_row_tiles):
        first = ti if tri else 0
        for sp in range(n_split):
            tiles = range(first + sp, most, n_split)
            if len(tiles):
                out.append(sum(SYM_ALL_DIAG if tri and t == ti
                               else SYM_ALL_TILE for t in tiles))
    return out


def sym_all_replay(batch, n_rows, n_cols, tri, new, per_sm, sms=SMS):
    """One launch of the batched symmetric all-pairs walk replayed over
    ``sms`` SMs of ``per_sm`` resident blocks: blocks in launch order
    (crowds fastest, then row tiles and splits) each take the slot that
    frees first, and cost their items (16 law steps a lane) plus the fixed
    cost.  ``new``: ``sym_batch_walk`` with :func:`sym_all_splits`; else
    the parent (``sym_tile_pair``: a block of four warps a tile pair, 8
    items a warp, a diagonal tile's too, whose masked half it walks; its
    items are twice the length of the redesign's, whose blocks hold twice
    the warps).  Returns the splits, blocks, the pairs handed to the law
    over the launch (``evaluations``: items x 16 steps x 32 lanes x the
    warps), its makespan in the redesign's items and the share of slot time
    the blocks fill."""
    import heapq
    nr, nc = -(-n_rows // 128), -(-n_cols // 128)
    if new:
        s = sym_all_splits(batch, nr, nc, tri, per_sm, sms)
        costs = sym_all_costs(nr, nc, tri, s)
        warps = SYM_ALL_WARPS
    else:
        s = None
        costs = [2 * SYM_ALL_TILE] * (nr * (nr + 1) // 2 if tri
                                      else nr * nc)
        warps = 4
    slots = [(0, x) for x in range(sms * per_sm)]
    heapq.heapify(slots)
    span = busy = 0
    for c in costs:  # each group of `batch` crowds' blocks
        for _ in range(batch):
            free, x = heapq.heappop(slots)
            end = free + c + SYM_ALL_FIXED
            busy += c + SYM_ALL_FIXED
            span = max(span, end)
            heapq.heappush(slots, (end, x))
    evaluations = batch * sum(costs) * 16 * 32 * warps
    return {"splits": s, "blocks": batch * len(costs),
            "evaluations": evaluations, "makespan": span,
            "fill": round(busy / (span * sms * per_sm), 4)}


#: 1b's and 4-b's shapes (config #5, the 2-D mesh's square part and its
#: full blocks, the bench's B = 1): (label, crowds, rows, columns, triangle)
SYM_ALL_SHAPES = (("1b config #5: 256 x 1,000", 256, 1_000, 1_000, True),
                  ("1b mesh: 128 x 250", 128, 250, 250, True),
                  ("4-b mesh: 128 x 250 x 250", 128, 250, 250, False),
                  ("1b B = 1 x 10,000", 1, 10_000, 10_000, True))


def sym_all_main():
    """``--sym-all``: :func:`sym_all_replay` of the parent and the redesign
    at :data:`SYM_ALL_SHAPES` (the parent at its 7 blocks of four warps an
    SM, as many warps as 3.5 of the redesign's)."""
    per_sm = sym_all_blocks()
    for label, b, r, c, tri in SYM_ALL_SHAPES:
        for rule, new, k in (("parent", False, SYM_PARENT_PER_SM),
                             ("change", True, per_sm)):
            print(json.dumps({"shape": label, "rule": rule,
                              **sym_all_replay(b, r, c, tri, new, k)}),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=24)
    ap.add_argument("--window", default="1,2,3,4,0")
    ap.add_argument("--square", type=int, default=0,
                    help="crowds of config #5 + 30 m to replay whole (2c)")
    ap.add_argument("--sym", action="store_true",
                    help="replay the batched symmetric cutoff walks (1c)")
    ap.add_argument("--ring", action="store_true",
                    help="replay the batched ring's schedule (6-b)")
    ap.add_argument("--dense", action="store_true",
                    help="replay the batched all-tiles walk's layout (2b, "
                    "2r-b)")
    ap.add_argument("--sym-all", action="store_true",
                    help="replay the batched symmetric all-pairs walk's "
                    "splits (1b, 4-b)")
    args = ap.parse_args()
    if args.sym_all:
        sym_all_main()
        return 0
    if args.ring:
        ring_main()
        return 0
    if args.dense:
        dense_main()
        return 0
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    windows = [int(k) for k in args.window.split(",")]
    torch.set_num_threads(4)
    if args.sym:
        sym_main(args, windows)
        return 0
    import shard_cases as sc
    sharded = sc.shard_planes(N, SEED, "cpu", n_shards=SHARDS, sort=True)
    k = N // SHARDS
    whole = sc.shard_planes(N, SEED, "cpu", n_shards=1, sort=True)
    rows = [sharded[i][k:2 * k] for i in (0, 1, 5)]
    for name, cols, col_off in (
            ("shard", [sharded[i] for i in (0, 1, 5)], 0),
            ("ring block", [sharded[i][2 * k:3 * k] for i in (0, 1, 5)],
             2 * k)):
        print(json.dumps({"rows": name, "blocks": args.blocks,
                          "per_block": block_counts(
                              rows, cols, args.blocks, windows, row_off=k,
                              col_off=col_off)}), flush=True)
    print(json.dumps({"rows": "whole", "blocks": args.blocks,
                      "per_block": block_counts(
                          [whole[i] for i in (0, 1, 5)],
                          [whole[i] for i in (0, 1, 5)], args.blocks,
                          windows)}), flush=True)
    if args.square:
        import batch_cases as bc
        planes = bc.sort_rows(bc.batch_planes(args.square, 1000, seed=30,
                                              device="cpu", extent=35.0))
        per = [block_counts([planes[i][b] for i in (0, 1, 5)],
                            [planes[i][b] for i in (0, 1, 5)], None,
                            windows) for b in range(args.square)]
        print(json.dumps({"rows": "config #5", "crowds": args.square,
                          "per_block": {key: round(sum(
                              p[key] for p in per) / len(per), 2)
                              for key in per[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
