"""The CPU replay of the batched symmetric cutoff walks
(``tools/walk_model.py --sym``), which predicts their work on the card
before a timing run: on small seeded crowds its counts agree with a
brute-force count over all pairs, and its two schedules (the unbatched
walk's and ``sym_rows_walk``'s) each take every unordered pair within the
cutoff exactly once.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import walk_model as wm  # noqa: E402
from family_cases import family_planes  # noqa: E402


def crowd(n, seed, extent):
    x, y, _, _, _, alive, _, _ = family_planes(n, seed, "cpu", extent,
                                               sort=True)
    return x, y, alive


@pytest.mark.parametrize("n, seed, extent, cutoff", [
    (300, 1, 12.0, 5.0), (700, 2, 20.0, 10.0), (513, 3, 30.0, 4.0)])
def test_sym_counts_equal_a_brute_force_count(n, seed, extent, cutoff):
    """Pairs within the cutoff (both schedules), kept tile pairs, table
    rows that overflow and chunk pairs with a pair, against the same
    counts taken over every pair of the crowd; each walked chunk pair's
    steps are law steps or steps without a law."""
    x, y, a = crowd(n, seed, extent)
    pair, row = wm.sym_counts((x, y, a), cutoff, [1, 3, 0], max_surv=2)
    tot = row["totals"]
    c2 = float(np.float32(cutoff * cutoff))
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    within = a[:, None] & a[None, :] & (dx * dx + dy * dy <= c2)
    upper = torch.triu(within, 1)
    assert tot["pairs"] == tot["change_pairs"] == int(upper.sum())

    nt = -(-n // 128)
    pad = nt * 128 - n
    X, Y = (torch.cat([t, t.new_zeros(pad)]) for t in (x, y))
    A = torch.cat([a, a.new_zeros(pad)])
    tb = wm._boxes(X, Y, A, 128)
    kept = [[tj for tj in range(ti, nt) if bool(wm._reach(tb[ti], tb[tj],
                                                          c2))]
            for ti in range(nt)]
    assert row["tile_pairs"] == sum(map(len, kept))
    assert row["rows"] == nt
    assert row["overflowing_rows"] == pytest.approx(
        sum(len(k) > 2 for k in kept) / nt, abs=0.01)
    # a tile pair the box test drops holds no pair within the cutoff
    up = torch.nn.functional.pad(upper, (0, pad, 0, pad))
    tiles = up.view(nt, 128, nt, 128).any(3).any(1)
    for ti in range(nt):
        assert set(tiles[ti].nonzero()[:, 0].tolist()) <= set(kept[ti])
    # every chunk pair with a pair is walked, by each schedule
    chunks = up.view(nt * 4, 32, nt * 4, 32).any(3).any(1)
    with_pair = int(chunks.sum())
    assert tot["chunk_pairs_kept"] >= with_pair
    assert tot["chunk_pairs_tested"] == 16 * row["tile_pairs"]
    assert (tot["law_steps"] + tot["steps_without_law"]
            == 32 * tot["chunk_pairs_kept"])
    assert tot["change_law_steps"] * 32 >= tot["change_pairs"]
    assert tot["law_steps"] * 32 >= tot["pairs"]
    # a lane walking its own pairs needs no more steps with a wider window
    assert (tot["window_0_tile"] <= tot["window_3_tile"]
            <= tot["window_1_tile"] <= tot["law_steps"])
    assert tot["window_0_row"] <= tot["window_3_row"] <= tot["window_1_row"]
    assert pair["lane_use"] == pytest.approx(
        tot["pairs"] / (32 * tot["law_steps"]), abs=1e-3)


def test_change_schedule_takes_each_pair_of_the_diagonal_once():
    """On the diagonal tile, the steps of ``change_steps`` over the four
    row chunks and the four column chunks meet every unordered pair of
    distinct slots exactly once, in 256 steps (16 items of 16)."""
    seen = torch.zeros(128, 128, dtype=torch.int64)
    steps = 0
    for r in range(4):
        for c in range(4):
            got = wm.change_steps(True, r, c)
            if got is None:
                continue
            s0, s1, half = got
            steps += s1 - s0 + 1
            for s in range(s0, s1 + 1):
                for lane in range(32):
                    if half and s == 16 and lane >= 16:
                        continue
                    i, j = 32 * r + lane, 32 * c + (lane + s) % 32
                    seen[min(i, j), max(i, j)] += 1
    assert steps == 256
    assert torch.equal(seen, torch.triu(torch.ones(128, 128,
                                                   dtype=torch.int64), 1))
    assert wm.change_steps(False, 3, 0) == (0, 31, False)
