#!/usr/bin/env python3
"""A replay, on the CPU, of what the dense table walks of
``csrc/pair_forces.cu`` do per 32-row block at phase 33's shapes: the
work a walk's culling rule leaves, counted from the data, not timed.

Two row sets against their columns, 50,000 agents at 0.25 a square metre
(``tests/shard_cases.shard_planes``, seed 35), 30 m cutoff:

* ``shard``: shard 1 of 4 quarter-density shards, each sorted on its own
  curve (the 2-D mesh's rows), against the 50,000 gathered columns (four
  runs each sorted on its own curve): the batched table walk 3r-b;
* ``whole``: the same crowd sorted as one, against itself: the unbatched
  table walk at 50,000.

For ``--blocks`` sampled 32-row blocks (every warp of a block holds the
same 32 rows, one a lane) it counts the 256-column tiles and 32-column
chunks whose boxes the block's alive rows reach (the tiles ``dense_walk``
stages, the chunks it tests), the columns that some lane reaches (the
warp's law steps in ``dense_walk``: every column step where a lane's pair
is within the cutoff evaluates the law on all 32 lanes), the pairs within
the cutoff, and the warp's law steps when each lane walks its own pairs of
the chunk slot a warp owns with at most K chunks between the fastest and
the slowest lane (``--window``; 0 unbounded): K = 1 is one chunk at a
time, where a step serves every lane with a pair in that chunk, and
``chunk_walk``'s window is ``kChunkWindow``.  Per block, summed over its 8
chunk slots.

    python3 tools/walk_model.py [--blocks 24] [--window 1,2,3,4,0]
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


def block_counts(rows, cols, blocks, windows, seed=0):
    """Mean counts per sampled 32-row block of rows (x, y, alive) against
    cols (x, y, alive)."""
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
    c2 = CUTOFF * CUTOFF
    pick = np.random.default_rng(seed).choice(x.shape[0] // 32, blocks,
                                              replace=False)
    tot = {"tiles": 0, "chunks": 0, "law_steps": 0, "pairs": 0,
           **{f"window_{k}": 0 for k in windows}}
    done = 0
    for b in pick:
        sl = slice(32 * b, 32 * (b + 1))
        rx, ry, ra = x[sl], y[sl], a[sl]
        if not ra.any():
            continue
        gx = torch.clamp(torch.maximum(box[0] - rx[ra].max(),
                                       rx[ra].min() - box[1]), min=0)
        gy = torch.clamp(torch.maximum(box[2] - ry[ra].max(),
                                       ry[ra].min() - box[3]), min=0)
        hit = gx * gx + gy * gy <= c2
        tiles = torch.cat([hit, hit.new_zeros(-n_ch % TILE_CHUNKS)])
        tot["tiles"] += int(tiles.view(-1, TILE_CHUNKS).any(1).sum())
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
                  & ra[None, None, :])
            tot["law_steps"] += int(ok.any(2).sum())
            per_lane = ok.sum(1)
            tot["pairs"] += int(per_lane.sum())
            for k in windows:
                tot[f"window_{k}"] += window_steps(per_lane, k)
        done += 1
    return {k: round(v / done, 1) for k, v in tot.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=24)
    ap.add_argument("--window", default="1,2,3,4,0")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import shard_cases as sc
    windows = [int(k) for k in args.window.split(",")]
    torch.set_num_threads(4)
    sharded = sc.shard_planes(N, SEED, "cpu", n_shards=SHARDS, sort=True)
    k = N // SHARDS
    whole = sc.shard_planes(N, SEED, "cpu", n_shards=1, sort=True)
    for name, rows, cols in (
            ("shard", [sharded[i][k:2 * k] for i in (0, 1, 5)],
             [sharded[i] for i in (0, 1, 5)]),
            ("whole", [whole[i] for i in (0, 1, 5)],
             [whole[i] for i in (0, 1, 5)])):
        print(json.dumps({"rows": name, "blocks": args.blocks,
                          "per_block": block_counts(rows, cols, args.blocks,
                                                    windows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
