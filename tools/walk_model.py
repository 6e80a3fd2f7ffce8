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

    python3 tools/walk_model.py [--blocks 24] [--window 1,2,3,4,0] \
        [--square 3]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=24)
    ap.add_argument("--window", default="1,2,3,4,0")
    ap.add_argument("--square", type=int, default=0,
                    help="crowds of config #5 + 30 m to replay whole (2c)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import shard_cases as sc
    windows = [int(k) for k in args.window.split(",")]
    torch.set_num_threads(4)
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
