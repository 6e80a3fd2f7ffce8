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


# -- the batched ring's schedule (tools/walk_model.py --ring) ---------------

def brute_force_items(crowds, groups, G):
    """{block: sorted (crowd, group) items} of one device, item i = b *
    groups + s on block i mod G: the rule the kernel's rank arithmetic
    implements (csrc/ring.cu)."""
    out = {x: [] for x in range(G)}
    for i in range(crowds * groups):
        out[i % G].append(divmod(i, groups))
    return out


@pytest.mark.parametrize("new", [False, True], ids=["parent", "change"])
@pytest.mark.parametrize("crowds, n_dev, n_local, per_sm, sms", [
    (5, 4, 250, 4, 3), (7, 2, 130, 3, 5), (3, 3, 1200, 2, 4),
    (1, 4, 2500, 4, 2), (9, 1, 70, 1, 3), (4, 8, 520, 3, 11)])
def test_ring_items_equal_a_brute_force_enumeration(new, crowds, n_dev,
                                                    n_local, per_sm, sms):
    """On tiny schedules, the items per block that the replay walks (the
    kernel's rank rule: crowds in ascending order, groups rank, rank + G,
    ...) equal a brute-force enumeration of item i on block i mod G, for
    the parent's rule (one 32-row set an item) and the redesign's (sets
    row sets an item from ring_batch_sets); the replay's units and steps
    add up to every item's work, and no schedule deadlocks."""
    sets, groups, G, multi = wm.ring_layout(crowds, n_dev, n_local, new,
                                            per_sm, sms)
    assert sets in (1, 2, 4, 8) and (new or sets == 1)
    assert groups == -(-(-(-n_local // 32)) // sets)
    assert G == min(crowds * groups, per_sm * sms // n_dev)
    got = {x: sorted((b, g) for b, grps in items for g in grps)
           for x, items in wm.ring_assignment(crowds, groups, G).items()}
    assert got == brute_force_items(crowds, groups, G)
    for items in wm.ring_assignment(crowds, groups, G).values():
        assert [b for b, _ in items] == sorted({b for b, _ in items})
    rep = wm.ring_replay(crowds, n_dev, n_local, new, per_sm, 0.3, sms)
    nct = -(-n_local // 256)
    assert rep["units"]["mean"] == pytest.approx(
        crowds * groups * sets * nct * n_dev / G, abs=1e-3)
    assert rep["units"]["busiest"] >= rep["units"]["mean"]
    assert rep["makespan"] >= rep["units"]["busiest"]
    assert rep["items_per_block"]["max"] == max(map(len, got.values()))


def test_ring_sets_follows_the_kernels_rule():
    """ring_sets (the replay's copy of csrc/ring.cu ring_batch_sets) at
    phase 33's shapes on 132 SMs: 8 row sets an item for 256 crowds of 4 x
    250 and for 8 x 4 x 12,500, 2 for 32 crowds of 4 x 250 (128 items: a
    block each), 1 for one crowd of 4 x 2,500; the parent's rule replayed
    gives the 88 block-steps of its makespan, the redesign none above its
    busiest block, and its blocks take crowds from their device's counter
    only with one group a crowd and more crowds than blocks."""
    assert wm.ring_sets(256, 4, 250, 4) == 8
    assert wm.ring_sets(32, 4, 250, 4) == 2
    assert wm.ring_sets(8, 4, 12_500, 4) == 8
    assert wm.ring_sets(1, 4, 2_500, 4) == 1
    assert wm.ring_sets(3, 4, 250, 0) == 1
    parent = wm.ring_replay(256, 4, 250, False, 3)
    assert parent["blocks"] == 99 and parent["makespan"] == 88.0
    assert parent["block_steps"]["busiest"] == 84
    change = wm.ring_replay(256, 4, 250, True, 4)
    assert change["blocks"] == 132 and not change["multi"]
    assert change["dynamic"] and not parent["dynamic"]
    assert not wm.ring_replay(32, 4, 250, True, 4)["dynamic"]
    assert change["makespan"] == change["units"]["busiest"] == 64
    # a crowd's groups straddle blocks: the step-by-step form, no chains
    big = wm.ring_replay(8, 4, 12_500, True, 4)
    assert big["multi"] and big["makespan"] == big["units"]["busiest"]


# -- the batched all-tiles walk's layout (tools/walk_model.py --dense) -------

def test_dense_layout_follows_the_kernels_rule():
    """dense_layout (the replay's copy of csrc/pair_forces.cu
    dense_batch_layout) at phase 27's and phase 33's shapes on 132 SMs of
    the kernel's kDenseBatchBlocks resident blocks: config #5 (256 crowds
    of 1,000) two row sets a block and no split; the mesh's gathered
    columns (128 crowds x 250 rows x 1,000) and its ring block (x 250) one
    row set a block, no split (the layouts that timed fastest there);
    B = 1 x 10,000 one row set over a cluster of eight, the parent's
    layout; a batch of 3,000 crowds of 256 eight row sets a block.  The
    rule walks sets from 8 down and splits from 1 up, keeping the first
    least cost, as the kernel's does; the replay's blocks fill the card no
    worse than the parent's and walk no fewer law steps between
    barriers."""
    per_sm = wm.dense_batch_blocks()
    assert per_sm == 4
    assert wm.dense_layout(256, 1_000, 1_000, per_sm) == (2, 1)
    assert wm.dense_layout(128, 250, 1_000, per_sm) == (1, 1)
    assert wm.dense_layout(128, 250, 250, per_sm) == (1, 1)
    assert wm.dense_layout(1, 10_000, 10_000, per_sm) == (1, 8)
    assert wm.dense_layout(3_000, 256, 256, per_sm) == (8, 1)
    src = (ROOT / "carla_social_force_model_tpu_torch" / "csrc"
           / "pair_forces.cu").read_text()
    rule = src[src.index("DenseBatchLayout dense_batch_layout("):]
    rule = rule[:rule.index("\n}\n")]
    assert "for (int s = kTileChunks; s >= 1; s /= 2)" in rule
    assert "for (int sp = 1; sp <= parts && sp <= kMaxSplit; sp *= 2)" in rule
    assert "(s * tiles + 1 + (sp > 1)) * (blocks + cap)" in rule
    assert "cost < best_cost" in rule
    for b, r, c in ((256, 1_000, 1_000), (128, 250, 1_000),
                    (128, 250, 250), (1, 10_000, 10_000)):
        new = wm.dense_replay(b, r, c, True, per_sm)
        old = wm.dense_replay(b, r, c, False, wm.DENSE_PARENT_PER_SM)
        assert new["fill"] >= old["fill"] - 1e-9
        assert (new["law_steps_between_barriers"]
                >= old["law_steps_between_barriers"])


@pytest.mark.parametrize("new", [False, True], ids=["parent", "change"])
@pytest.mark.parametrize("batch, n_rows, n_cols, per_sm, sms", [
    (3, 100, 100, 2, 3), (5, 250, 1_000, 4, 7), (1, 1_000, 2_600, 3, 5),
    (7, 33, 9_000, 1, 4), (2, 20, 0, 4, 2), (40, 64, 300, 8, 11)])
def test_dense_replay_covers_every_row_and_tile(new, batch, n_rows, n_cols,
                                                per_sm, sms):
    """On small launches the replayed layout covers every row (sets x 32
    rows a block) and, over a row block's splits, every column tile once,
    the parts of each split whole; the replay's makespan is no less than
    its busiest block and than the blocks' total over the card's slots."""
    got = wm.dense_replay(batch, n_rows, n_cols, new, per_sm, sms)
    sets, splits = got["sets"], got["splits"]
    assert sets in (1, 2, 4, 8) and (new or sets == 1)
    nct = -(-n_cols // 256)
    parts = wm.dense_parts(nct)
    assert 1 <= splits <= max(parts, 1) and splits <= 8
    row_blocks = -(-n_rows // (32 * sets))
    assert row_blocks * 32 * sets >= n_rows > (row_blocks - 1) * 32 * sets
    assert got["blocks"] == batch * row_blocks * splits
    tiles = []
    for sp in range(splits):
        lo, hi = sp * parts // splits, (sp + 1) * parts // splits
        assert hi > lo  # every split holds a part
        tiles += range(lo * nct // parts, hi * nct // parts)
    assert tiles == list(range(nct))
    total = batch * row_blocks * sum(
        sets * ((sp + 1) * parts // splits * nct // parts
                - sp * parts // splits * nct // parts) + 1
        for sp in range(splits))
    assert got["makespan"] >= got["chunks_a_warp"] + 1
    assert got["makespan"] >= total / (sms * per_sm) - 1e-9
    assert 0.0 < got["fill"] <= 1.0


# -- the batched symmetric all-pairs walk (tools/walk_model.py --sym-all) ----

def sym_all_pairs(n_rows, n_cols, tri, n_split):
    """Every (row, column) pair of real slots that the blocks of one crowd
    hand the law in sym_batch_walk (the replay's copy of its items), over
    all row tiles and splits: two int64 arrays."""
    rows, cols = [], []
    for ti in range(-(-n_rows // 128)):
        for split in range(n_split):
            i, j = wm.sym_all_block_pairs(ti, split, n_split, n_rows,
                                          n_cols, tri)
            real = (i < n_rows) & (j < n_cols)
            rows.append(i[real])
            cols.append(j[real])
    return np.concatenate(rows), np.concatenate(cols)


@pytest.mark.parametrize("tri", [True, False],
                         ids=["triangle", "full block"])
@pytest.mark.parametrize("n", [1, 31, 129, 250, 1_000, 4_000])
def test_sym_all_items_take_every_pair_once(n, tri):
    """The items of the batched symmetric all-pairs walk (sym_batch_walk)
    against a brute-force enumeration: in the triangle every unordered
    pair of distinct slots of a crowd exactly once and no slot against
    itself (the triangle walk masks no self-pair), in the full block every
    (row, column) pair exactly once; under one split and under the splits
    the rule gives one crowd of n and 256 of them.  Slots past n reach the
    law only masked."""
    nt = -(-n // 128)
    splits = {1, wm.sym_all_splits(1, nt, nt, tri, 4),
              wm.sym_all_splits(256, nt, nt, tri, 4)}
    for s in sorted(splits):
        i, j = sym_all_pairs(n, n, tri, s)
        if tri:
            assert not bool((i == j).any())
            key = np.minimum(i, j) * n + np.maximum(i, j)
            want = n * (n - 1) // 2
        else:
            key = i * n + j
            want = n * n
        key.sort()
        assert key.size == want, (s, key.size, want)
        assert not bool((np.diff(key) == 0).any()), s


def test_sym_all_splits_follows_the_kernels_rule():
    """sym_all_splits (the replay's copy of csrc/pair_forces.cu
    sym_all_splits) at config #5's and the 2-D mesh's shapes on 132 SMs of
    the kernel's kSymAllBlocks resident blocks: config #5 (256 crowds of
    1,000, eight row tiles) one split, so that row tile 0 walks its whole
    run of eight tiles; the mesh's square part (128 crowds of 250) and its
    full blocks (128 x 250 x 250) two, so that no block walks more than
    one column tile off the diagonal and the blocks fit the card at once;
    B = 1 x 10,000 sixteen.  The copy's constants, its diagonal items and
    the rule's lines are the kernel's, and the redesign hands the law no
    more pairs than the parent."""
    per_sm = wm.sym_all_blocks()
    assert per_sm == 4
    for name, value in (("kSymAllRows", wm.SYM_ALL_ROWS),
                        ("kSymAllWarps", wm.SYM_ALL_WARPS),
                        ("kSymAllDiagItems", wm.SYM_ALL_DIAG),
                        ("kSymAllBlockItems", wm.SYM_ALL_FIXED)):
        assert wm.pair_constant(name) == value
    assert wm.SYM_ALL_TILE == wm.SYM_ALL_ROWS * 32 // 16
    assert wm.sym_all_splits(256, 8, 8, True, per_sm) == 1
    assert wm.sym_all_splits(128, 2, 2, True, per_sm) == 2
    assert wm.sym_all_splits(128, 2, 2, False, per_sm) == 2
    assert wm.sym_all_splits(1, 79, 79, True, per_sm) == 16
    src = (ROOT / "carla_social_force_model_tpu_torch" / "csrc"
           / "pair_forces.cu").read_text()
    rule = src[src.index("int sym_all_splits("):]
    rule = rule[:rule.index("\n}\n")]
    assert "for (long long s = 1; s <= most && nr * s <= 65535; s *= 2)" in rule
    assert "tri ? s * (s + 1) / 2 + (nr - s) * s : nr * s" in rule
    assert "tri ? diag : most / s * tile" in rule
    assert "best_cost < 0 || cost < best_cost" in rule
    assert ("kSymAllTileItems = kSymAllRows * kChunk / 16" in src)
    words = wm.sym_all_diag_words()
    assert (f"g == 0 ? 0x{words[0]:016x}ull : 0x{words[1]:016x}ull" in src)
    for label, b, r, c, tri in wm.SYM_ALL_SHAPES:
        new = wm.sym_all_replay(b, r, c, tri, True, per_sm)
        old = wm.sym_all_replay(b, r, c, tri, False, wm.SYM_PARENT_PER_SM)
        assert new["evaluations"] <= old["evaluations"], label
        assert 0.0 < new["fill"] <= 1.0


@pytest.mark.parametrize("batch, n_rows, n_cols, tri, per_sm, sms", [
    (3, 100, 100, True, 2, 3), (5, 250, 250, False, 4, 7),
    (2, 1_000, 1_000, True, 4, 5), (7, 1_000, 129, False, 1, 4),
    (40, 300, 300, True, 8, 11)])
def test_sym_all_replay_counts_every_block(batch, n_rows, n_cols, tri,
                                           per_sm, sms):
    """On small launches the replay's blocks are the rule's grid less the
    splits without a tile, its law evaluations the items' (16 steps of 32
    lanes and 4 warps each) and no fewer than the pairs, and its makespan
    no less than the longest block and the blocks' work over the slots."""
    got = wm.sym_all_replay(batch, n_rows, n_cols, tri, True, per_sm, sms)
    nr, nc = -(-n_rows // 128), -(-n_cols // 128)
    s = got["splits"]
    assert s == wm.sym_all_splits(batch, nr, nc, tri, per_sm, sms)
    costs = wm.sym_all_costs(nr, nc, tri, s)
    per_row = [min(s, (nc - ti) if tri else nc) for ti in range(nr)]
    assert got["blocks"] == batch * len(costs) == batch * sum(per_row)
    assert got["evaluations"] == batch * sum(costs) * 16 * 32 * 8
    pairs = n_rows * (n_rows - 1) // 2 if tri else n_rows * n_cols
    assert got["evaluations"] >= batch * pairs
    assert got["makespan"] >= max(costs) + wm.SYM_ALL_FIXED
    assert got["makespan"] >= batch * (sum(costs) + len(costs)) / (
        sms * per_sm) - 1e-9
