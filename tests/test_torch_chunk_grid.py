"""PyTorch port: the launch plan of the batched box-skip and table walks
(``ops/pair_grid.py``: the 32-column chunk boxes of a batched
``dense_cutoff`` or ``compact`` grid) against a numpy brute force, on the
CPU.

The batched box-skip and table kernels
(``pair_force_dense_batched_kernel<kBoxSkip | kTable>``,
``csrc/pair_forces.cu`` ``chunk_walk``) walk, for each 32-row block, the
chunks of every tile (the box-skip walk), or of the tiles its 128-row table
row lists (every tile where the row overflows its ``max_surv`` slots),
whose chunk box lies within the cutoff of the block's box of alive rows.
Their results equal the unbatched launch bitwise only if that rule never
drops a (row block, chunk) pair that holds an alive pair within the
cutoff.  These tests apply the rule, as the kernel does, in float32 numpy
with every operation rounded on its own, to the grid's boxes and table,
and check that invariant against every pair; the chunk boxes against their
brute-force definition; and that the sharded schedules hand the batched
walk the chunk boxes of the columns it is given (a ring block's ride with
it).
"""
import numpy as np
import pytest
import torch

from carla_social_force_model_tpu_torch.ops import cuda_forces, pair_grid
from carla_social_force_model_tpu_torch.parallel import make_mesh
import shard_cases as sc

CHUNK, TILE, TROW = pair_grid.CHUNK, pair_grid.COL_TILE, pair_grid.SYM_TILE
F32 = np.float32


def brute_boxes(x, y, alive, width):
    """(4, ceil(n / width)) float32 boxes of alive agents per ``width``
    slots, [min_x, max_x, min_y, max_y], empty groups (+inf, -inf, +inf,
    -inf): the definition, one group at a time."""
    n = x.shape[0]
    out = np.empty((4, -(-n // width)), F32)
    for k in range(out.shape[1]):
        sl = slice(k * width, (k + 1) * width)
        a = alive[sl]
        if not a.any():
            out[:, k] = (np.inf, -np.inf, np.inf, -np.inf)
            continue
        xs, ys = x[sl][a], y[sl][a]
        out[:, k] = (xs.min(), xs.max(), ys.min(), ys.max())
    return out


def gap2(r, c):
    """The kernels' box_gap2 in float32, every operation rounded on its
    own: row box ``r`` (4,) against column boxes ``c`` (4, m)."""
    gx = np.maximum(np.maximum(c[0] - r[1], r[0] - c[1]), F32(0))
    gy = np.maximum(np.maximum(c[2] - r[3], r[2] - c[3]), F32(0))
    return (gx * gx).astype(F32) + (gy * gy).astype(F32)


def assert_no_pair_dropped(rows, cols, grid, row_off, col_off):
    """Crowd by crowd, every (32-row block, chunk) pair holding an alive,
    non-self pair within the grid's cutoff is walked: its tile is listed in
    the block's table row (or the row overflows, or the grid has no table:
    the box-skip walk) and its chunk box passes the box test against the
    block's alive rows.  Returns the number of
    such (block, chunk) pairs and of the walked ones that hold none."""
    c2 = F32(grid.c2)
    held = extra = 0
    for b in range(rows[0].shape[0]):
        rx, ry, ra = (t[b].numpy() for t in rows)
        cx, cy, ca = (t[b].numpy() for t in cols)
        chunks = grid.chunk_boxes[b].numpy()
        table = grid.surv is not None
        if table:
            surv, counts = grid.surv[b].numpy(), grid.counts[b].numpy()
        n_rows, n_cols = rx.shape[0], cx.shape[0]
        gi = np.arange(n_rows) + row_off
        gj = np.arange(n_cols) + col_off
        for i0 in range(0, n_rows, 32):
            sl = slice(i0, i0 + 32)
            live = ra[sl]
            dx = (cx[None, :] - rx[sl, None]).astype(F32)
            dy = (cy[None, :] - ry[sl, None]).astype(F32)
            d2 = (dx * dx).astype(F32) + (dy * dy).astype(F32)
            ok = ((d2 <= c2) & live[:, None] & ca[None, :]
                  & (gi[sl, None] != gj[None, :]))
            pad = -n_cols % CHUNK
            need = np.pad(ok.any(axis=0), (0, pad)).reshape(-1, CHUNK).any(1)
            if live.any():
                box = np.array([rx[sl][live].min(), rx[sl][live].max(),
                                ry[sl][live].min(), ry[sl][live].max()], F32)
                hit = gap2(box, chunks) <= c2
            else:
                hit = np.zeros(chunks.shape[1], bool)
            trow = i0 // TROW
            tiles = np.arange(chunks.shape[1]) * CHUNK // TILE
            if table and counts[trow] <= grid.max_surv:
                listed = np.isin(tiles, surv[trow][surv[trow] >= 0])
            else:
                listed = np.ones(chunks.shape[1], bool)
            walked = hit & listed
            assert not (need & ~walked).any(), (b, i0)
            held += int(need.sum())
            extra += int((walked & ~need).sum())
    return held, extra


@pytest.mark.parametrize("form", ["compact", "dense_cutoff"])
def test_chunk_boxes_match_the_brute_force(form):
    """The chunk boxes of a batched ``compact`` or ``dense_cutoff`` grid,
    crowd by crowd: an empty chunk (every agent dead) gets the inverted
    box, the ragged last chunk only its own slots; the unbatched grid holds
    none."""
    planes = sc.batch_shard_planes(3, 1000 + 37, seed=5, device="cpu",
                                   n_shards=1, sort=True)
    planes[5][1, 64:96] = False
    kw = dict(max_surv=2) if form == "compact" else dict(compact=False)
    grid = pair_grid.cutoff_grid(planes[0], planes[1], planes[5], 8.0,
                                 symmetric=False, **kw)
    assert grid.form == form
    assert grid.chunk_boxes.shape == (3, 4, -(-1037 // CHUNK))
    for b in range(3):
        want = brute_boxes(planes[0][b].numpy(), planes[1][b].numpy(),
                           planes[5][b].numpy(), CHUNK)
        assert np.array_equal(grid.chunk_boxes[b].numpy(), want)
    assert np.isinf(grid.chunk_boxes[1, :, 2].numpy()).all()
    one = pair_grid.cutoff_grid(planes[0][0], planes[1][0], planes[5][0],
                                8.0, symmetric=False, **kw)
    assert one.form == form and one.chunk_boxes is None


@pytest.mark.parametrize("symmetric,compact,max_surv,batched",
                         [(True, True, 2, True), (True, False, 0, True),
                          (False, False, 0, False), (False, True, 2, False),
                          (False, True, 40, False)])
def test_no_chunk_boxes_where_no_batched_table_walk_reads_them(
        symmetric, compact, max_surv, batched):
    """Only the batched box-skip and table walks read chunk boxes: a
    batch's symmetric grids (table and box test) and the unbatched grids
    (box skip, a table, and a table wide enough not to engage) carry
    none."""
    planes = sc.batch_shard_planes(2, 2000, seed=6, device="cpu",
                                   n_shards=1, sort=True)
    x, y, alive = (planes[a] if batched else planes[a][0] for a in (0, 1, 5))
    grid = pair_grid.cutoff_grid(x, y, alive, 8.0, symmetric=symmetric,
                                 compact=compact, max_surv=max_surv)
    assert grid.chunk_boxes is None


@pytest.mark.parametrize("form", ["compact", "dense_cutoff"])
@pytest.mark.parametrize("with_cols", [True, False])
def test_rect_grid_chunk_boxes_of_the_columns(with_cols, form):
    """``rect_grid`` of a batch, with a table or the box skip alone, takes
    the chunk boxes from the column planes it is given (without them, or
    unbatched, it has none)."""
    planes = sc.batch_shard_planes(2, 4 * 517, seed=7, device="cpu",
                                   n_shards=4, sort=True)
    rows = [a[:, 517:1034].contiguous() for a in planes]
    col_bb = pair_grid.box_planes(planes[0], planes[1], planes[5], TILE)
    kw = dict(max_surv=2) if form == "compact" else dict(compact=False)
    grid = pair_grid.rect_grid(
        rows[0], rows[1], rows[5], col_bb, 4 * 517, 8.0,
        cols=(planes[0], planes[1], planes[5]) if with_cols else None, **kw)
    assert grid.form == form
    if not with_cols:
        assert grid.chunk_boxes is None
        return
    for b in range(2):
        assert np.array_equal(grid.chunk_boxes[b].numpy(), brute_boxes(
            planes[0][b].numpy(), planes[1][b].numpy(),
            planes[5][b].numpy(), CHUNK))
    one = pair_grid.rect_grid(rows[0][0], rows[1][0], rows[5][0],
                              col_bb[0], 4 * 517, 8.0,
                              cols=(planes[0][0], planes[1][0],
                                    planes[5][0]), **kw)
    assert one.form == form and one.chunk_boxes is None


@pytest.mark.parametrize("gathered", [True, False])
@pytest.mark.parametrize("max_surv", [1, 2, 0, None])
def test_quarter_density_shards_never_drop_a_chunk_with_a_pair(gathered,
                                                                max_surv):
    """Shard 1's rows of 4 quarter-density shards (each sorted on its own
    curve, as the 2-D mesh launches them) against the gathered columns or
    the next shard's block, 8 m cutoff, 4 x 1,037 agents a crowd (columns
    not a multiple of 32 or 256), 15% dead unevenly: tables of 1 and 2
    slots, which overflow, one a tile narrower than a row of tiles
    (``max_surv`` 0 here), where rows fit, and the box skip alone
    (``max_surv`` None: every tile)."""
    k = 1037
    planes = sc.batch_shard_planes(2, 4 * k, seed=8 + (max_surv or 0),
                                   device="cpu", n_shards=4, sort=True)
    rows = [planes[a][:, k:2 * k].contiguous() for a in (0, 1, 5)]
    c0, c1 = (0, 4 * k) if gathered else (2 * k, 3 * k)
    cols = [planes[a][:, c0:c1].contiguous() for a in (0, 1, 5)]
    ms = max_surv or -(-(c1 - c0) // TILE) - 1
    grid = pair_grid.rect_grid(
        *rows, pair_grid.box_planes(*cols, TILE), c1 - c0, 8.0,
        compact=max_surv is not None, max_surv=ms, cols=tuple(cols))
    assert grid.form == ("dense_cutoff" if max_surv is None else "compact")
    if max_surv is not None:
        over = grid.counts > ms
        assert bool(over.any()) if max_surv == 1 else bool((~over).any())
    held, extra = assert_no_pair_dropped(rows, cols, grid, k, c0)
    assert held > 0 and extra >= 0


@pytest.mark.parametrize("n,max_surv,dead_crowd", [(3000, 0, False),
                                                  (2500, 3, True),
                                                  (2600, None, True),
                                                  (1000, None, False)])
def test_square_batches_never_drop_a_chunk_with_a_pair(n, max_surv,
                                                       dead_crowd):
    """The square batched grid (``cutoff_grid`` of ``(B, n)`` planes, each
    sorted on its own curve) at 0.25 agents/m^2 with a 10 m cutoff: a
    table of ``max_surv`` slots (0: as wide as a row of tiles minus one)
    or the box skip alone (None; 1,000 agents: config #5's crowds), one
    crowd with most agents dead (different alive counts)."""
    planes = sc.batch_shard_planes(3, n, seed=n, device="cpu", n_shards=1,
                                   sort=True)
    if dead_crowd:
        planes[5][2, 40:] = False
    ms = max_surv or -(-n // TILE) - 1
    grid = pair_grid.cutoff_grid(planes[0], planes[1], planes[5], 10.0,
                                 symmetric=False,
                                 compact=max_surv is not None, max_surv=ms)
    assert grid.form == ("dense_cutoff" if max_surv is None else "compact")
    xya = [planes[a] for a in (0, 1, 5)]
    held, _ = assert_no_pair_dropped(xya, xya, grid, 0, 0)
    assert held > 0


@pytest.mark.parametrize("comm", ["ring", "gather"])
def test_sharded_batches_hand_the_walk_its_columns_chunk_boxes(monkeypatch,
                                                               comm):
    """``kernel_sharded_force`` on a batch of crowds over 4 shards, 8 m
    cutoff, the box skip (``compact=False``): every launch's grid passes
    the launch's own check and holds the chunk boxes of exactly the
    columns it is handed, built from those planes: the gathered columns',
    or, on the ring, the block's after each rotation (they ride with it;
    D launches a shard, each shard's block once)."""
    d, k, b = 4, 300, 2
    planes = sc.batch_shard_planes(b, d * k, seed=9, device="cpu",
                                   n_shards=d, sort=True)
    planes[5][1, k:2 * k:3] = False
    seen = []

    def launch(law, form, x, y, vx, vy, rad, alive, prm, use_radius,
               grid=None, desired=None, cols=None, row_offset=0,
               col_offset=0):
        cuda_forces._check_grid(grid, x.shape[-1], cols[0].shape[-1],
                                x.device, x.shape[0])
        want = pair_grid.box_planes(cols[0], cols[1], cols[5], CHUNK)
        seen.append((form, int(row_offset) // k, int(col_offset) // k,
                     torch.equal(grid.chunk_boxes, want)))
        return torch.zeros_like(x), torch.zeros_like(x)

    monkeypatch.setattr(cuda_forces, "_launch", launch)

    def body(ax, s):
        sl = slice(s * k, (s + 1) * k)
        return cuda_forces.kernel_sharded_force(
            "moussaid", *(t[:, sl] for t in planes[:6]),
            sc.law_params("moussaid"), ax, comm, symmetric=False,
            cutoff=8.0, compact=False)

    make_mesh(d, device="cpu").run(body, list(range(d)))
    assert all(form == "dense_cutoff_rect_batched" and same
               for form, _, _, same in seen), seen
    blocks = sorted((r, c) for _, r, c, _ in seen)
    assert blocks == ([(r, c) for r in range(d) for c in range(d)]
                      if comm == "ring" else [(r, 0) for r in range(d)])
