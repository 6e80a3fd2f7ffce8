#!/usr/bin/env python3
"""Device times of the redesigned pair, ring, environment and chunk-scan
kernels at the main paths' shapes, for one checkout of the port, on one
card.

The shapes, and the builders of their inputs, are ``chip_smoke.py``'s (of
this checkout): phase 3 (config #1's seeded crowd, N = 10,000:
``pair_force_sym`` and ``pair_force_dense``; the power law's and Helbing's
forms of phase 15), phase 9 (the 30 m cutoff on Hilbert-sorted seeded
crowds: ``pair_force_sym_cutoff`` and ``pair_force_dense_cutoff`` at
10,000, ``pair_force_sym_compact`` and ``pair_force_compact`` at 50,000
and 1,000,000, and ``pair_force_dense_cutoff`` at 1,000,000, the table's
overflow walk), phase 24 (``pair_force_sym_dense`` on a 2,500 x 2,500
block, its cutoff form on the 50k path's sorted 12,500 x 12,500 block; the
rectangular dense kernel on one shard's 2,500 rows against the 10,000
gathered columns; ``ring_force`` at D = 4 and D = 1 over N = 10,000, and
at D = 4 over the most agents it must take, 128 per 3 / 4 of an SM:
N = 50,688 on 132 SMs, ``"ms": null`` where the launch is refused),
phase 6 (config #3 at 10,000: ``env_exp`` on the borders,
``env_moussaid`` on the parked cars and the vehicles,
``env_moussaid_compact`` on the parked cars), phase 12
(``env_exp_compact`` on the urban borders) and phase 18
(``env_exp_analytic`` on config #3's analytic borders,
``env_exp_analytic_compact`` on the urban ones with a table of width 4),
and with ``--cases statics`` phase 21 (``chunk_argmin`` at the Town02
crowd's shape: its 150 border chunks of 128 points against its 10,008
pedestrians after 10 steps) and phase 18 (``chunk_topk`` and
``chunk_closest`` over config #3's 169 parked-car chunks at N = 10,000,
``seg_topk`` over the border features of config #3 and of the urban path
at N = 10,000 and of config #2 at N = 50,000; k = 3, the alive rows'
boxes).  Each time is the device time of the named kernel over 20
launches (5 at 1M), ``chip_smoke.device_ms``: the profiler, or a CUDA
graph of the calls where the profiler misses or doubles launches (each
line's ``timed_by``); before them, the errors of the Moussaid pair
kernels against their plain versions as phases 3, 9 and 24 check them
(the fast tail moves them).

    python3 tools/kernel_redesign_bench.py [--root DIR] [--label NAME] \\
        [--out FILE] [--counters] [--clock-seconds S] \\
        [--cases sym,env,dense,statics,feed,capacity,batched,mesh,all_tiles,\\
                 sym_all] [--only NAME,...]

``--only`` keeps the cases whose name holds one of the given substrings
(a layout variant's cases, say ``--cases batched --only sym_``).

``--cases capacity`` asks, for each law with and without the cutoff and at
D = 1, 4 and 8, whether one ``ring_force`` launch takes twice the agents
per device that one resident block per 128 rows could hold (3 blocks an
SM: 2 x floor(3 x SMs / D) x 128; one JSON line each), and times the ring
at D = 4 over N = 10,000 and over N = 2 x 50,688 agents (on 132 SMs) at
D = 4 and D = 1 (``"ms": null`` where the launch is refused).

``--cases batched`` times the square batched dense walks at phase 27's
and phase 30's shapes (config #5 under each law with bounds and issue
floors, and B = 1 x 10,000 beside the unbatched ``pair_force_dense`` on
the same crowd; its 30 m cutoff under
each law, the table at 8 x 50,000 under each law and the box skip at 8 x
50,000, the cutoff forms with bounds and issue floors), the square
batched symmetric walks under the Moussaid law and the power law with
bounds and issue floors (the triangle walk at config #5, row 1b; the
triangle-box walk at config #5 + 30 m and the table at 8 x 50,000, row
1c) and the batched environment walks on one shared set at phase 31's
(256 crowds of 1,000 over config #3's geometry: the borders sampled and
analytic and the parked cars, dense and on the survivor tables).

``--cases all_tiles`` times only the batched all-tiles walk's cases of
``batched`` and ``mesh`` (:func:`all_tiles_cases`; rows 2b and 2r-b).

``--cases sym_all`` times the batched symmetric walks without a cutoff
(:func:`sym_all_cases`; rows 1b and 4-b) under both antisymmetric laws:
1b at config #5 and, at phase 33's shapes, on a shard's 128 crowds x 250
(the half-ring's square part), 4-b on the half-ring's 128 x 250 x 250
blocks and its box form there (sorted, 30 m), and 1b at B = 1 x 10,000
beside the unbatched ``pair_force_sym``; each with its bound, the issue
floor of its live pairs and of the pairs the walk hands the law
(``eval_floor_ms``).  ``mesh`` holds the mesh ones too.

``--cases mesh`` times the rectangular batched walks at phase 33's shapes:
the table walk ``compact_rect_batched`` on one shard's 4 crowds x 12,500
rows of 8 x 50,000 (2 x 4 mesh, quarter-density shards each sorted on its
own curve) against the 50,000 gathered columns with 32 slots, and the
box-skip walk ``dense_cutoff_rect_batched`` under each law at the same
shapes and on the 12,500-column block of the next shard, and at phase
33's config #5 shapes (128 crowds x 250 rows x 1,000 gathered columns,
and x the 250-column block), and there the all-tiles walk
``dense_rect_batched`` under each law; beside them, on the same candidate
pairs, the unbatched ``pair_force_compact_rect`` on crowd 0's shard and
``pair_force_compact`` at 50,000 on crowd 0 sorted as one crowd, and the
batched table walk on that crowd alone (B = 1: what the batched walk gives
the unbatched problem).  Each line carries its bound (``chip_smoke.bound``
of the pairs within 30 m) and the issue floor of those pairs through the
kernel's inner loop (``tools/sass_census.py``).  Then the batched ring
``ring_force_batched`` (row 6-b, :func:`ring_cases`): phase 33's 256
crowds x 4 shards x 250 under the Moussaid law, 32 crowds x 4 x 250 under
each law, the 30 m cutoff on the sorted shards at 32 and 256 crowds, and
8 x 4 x 12,500 with the cutoff (the kMulti shape); beside them the
batched all-tiles walk 2b on the same 256 crowds of 1,000, and the batched
ring at B = 1 against the unbatched ``ring_force`` at D = 4, N = 10,000;
each with its bound and issue floor.

``--counters`` runs the Moussaid mesh cases, the square table walk at 8 x
50,000 and the square box skip at config #5 + 30 m once each through a
debug build and prints, per 32-row block, what the walks did: column
tiles staged (``dense_walk``), chunks staged (or walked) and tested,
chunks with a pair, law evaluations (32 a warp step), pairs within the
cutoff, blocks whose table row overflowed, and the blocks and table rows
behind them; then the batched symmetric cutoff walks under both laws (the
triangle-box walk at config #5 + 30 m, the table at 8 x 50,000 with 32
slots and with 8), per tile pair staged and per 128-row table row: tile
pairs staged, chunk pairs tested and walked, chunk pairs with a pair,
law evaluations, pairs within the cutoff, atomics, blocks without a tile
and blocks on an overflowing table row; then the batched ring's Moussaid
cases (:func:`ring_counters`), per block-step: polls on fill and on done,
thread 0's cycles of the step and of its waits, forward, staging and
walk, chunk steps, tiles staged and visited, law evaluations and pairs
within the cutoff, with the ring kernels' registers and resident blocks;
for its cases of 250 agents a device without a cutoff also a step trace
of its own body (:func:`ring_trace`: each block's SM and each step's
global-timer stamps, ``ring_trace_<label>.json`` beside ``--out``).
Before the ring, the all-tiles walk's Moussaid cases (:func:`dense_counters`:
config #5, B = 1 x 10,000 and the unbatched walk beside it, the mesh's
gathered columns and ring block), per block: thread 0's cycles in
zeroing, staging, barriers, walking and folding (:data:`DENSE_COUNTERS`);
and before those the batched symmetric walks' Moussaid cases without a
cutoff (:func:`sym_warp_counters`: 1b at config #5 and B = 1 x 10,000
with the unbatched walk beside it, the mesh's 1b and 4-b and 4-b's box
form), per block: every warp's own cycles in loads and staging,
barriers, walking and the flush, its law steps and atomics, as the mean
warp, the slowest and warp 0 (:data:`SYM_WARP_COUNTERS`).
``--only`` keeps the counted cases whose name holds a substring.  The
debug build is the checkout at ``--root`` with counters patched into its sources
(:func:`instrument`: atomic adds at the walks' staging, culling and law
calls, and C entries that read and reset them); never give it a copy you
time, nor this checkout.  The recipe, on the card::

    git archive HEAD | tar -x -C archive_check/change_counters
    python3 tools/kernel_redesign_bench.py --counters \\
        --root archive_check/change_counters --label change

``--root`` is the checkout whose package is imported and whose kernels are
built (into its own ``build/``); the cases' builders (``chip_smoke.py``
and ``tests/``) are this tool's own, so every root runs the same
inputs.  One JSON line per time goes to standard
output (and to ``--out``).  To compare two commits, unpack each into a
directory that ``.gitignore`` lists and run the tool on each in one call on
the card, in turns (parent, change, change, parent); to compare a layout
constant (``kSymRows``, ``kSymRowsCut``, ``kDenseRows``, ``kDenseCols``
in ``csrc/pair_forces.cu``, ``kRingRows`` in ``csrc/ring.cu``,
``kEnvLanes`` in ``csrc/env_forces.cu``, ``kArgminRows``,
``kTopkLanes``, ``kSegLanes``, ``kClosestLanes`` and
``kClosestBlocksPerSM`` in ``csrc/statics.cu``), edit it in such a copy.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

from sass_census import box_skip_walk

HERE = Path(__file__).resolve().parent.parent
N = 10_000
CUTOFF_M = 30.0
#: (N, seed, reps) of the cutoff cases, phase 9's crowds
CUT_CASES = ((N, 11, 20), (50_000, 11, 20), (1_000_000, 13, 5))
CUT_BLOCK_N = 50_000


def smoke():
    """This tool's checkout's ``chip_smoke`` module (its case builders and
    ``device_ms``), whichever checkout ``--root`` names."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", HERE / "chip_smoke.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


def sym_cases(dev):
    """(name, call, kernel name filter, reps) of the symmetric kernel."""
    import numpy as np
    import shard_cases as sc
    from carla_social_force_model_tpu_torch.models.params import (
        MoussaidParams, PowerLawParams, moussaid_vector)
    from carla_social_force_model_tpu_torch.ops import cuda_forces, pair_grid
    cs = smoke()
    prm = moussaid_vector(MoussaidParams(), dev)
    planes = cs.to_planes(*cs.seeded_crowd(N, 7, float(np.sqrt(N))), dev)
    pl_prm = cuda_forces.law_vector("powerlaw", PowerLawParams(), dev)
    out = [("sym 10k", lambda: cuda_forces.pair_force_sym(*planes, prm),
            "pair_force_sym_kernel", 20),
           ("sym powerlaw 10k", lambda: cuda_forces.pair_force_sym(
               *planes, pl_prm, law="powerlaw"), "pair_force_sym_kernel", 20)]
    for n, seed, reps in CUT_CASES:
        sp = cs.sorted_crowd(n, seed, dev)
        grid = pair_grid.cutoff_grid(sp[0], sp[1], sp[5], CUTOFF_M,
                                     symmetric=True)
        out.append((f"{grid.form} N={n}", lambda sp=sp, g=grid:
                    cuda_forces.pair_force_cutoff(*sp, prm, g),
                    "pair_force_sym_kernel", reps))
    k = N // 4
    pl = sc.shard_planes(N, 28, dev, n_shards=4)
    rows, blk = sc.split(pl, 0, k), sc.split(pl, k, 2 * k)
    out.append((f"sym_dense {k} x {k}",
                lambda rows=rows, blk=blk: cuda_forces.pair_force_sym_dense(
                    *rows[:6], prm, tuple(blk[:6]), col_offset=k),
                "pair_force_sym_dense_kernel", 20))
    kb = CUT_BLOCK_N // 4
    pl = sc.shard_planes(CUT_BLOCK_N, 29, dev, n_shards=4, sort=True)
    rows, blk = sc.split(pl, 0, kb), sc.split(pl, kb, 2 * kb)
    grid = pair_grid.block_grid(
        pair_grid.box_planes(rows[0], rows[1], rows[5], pair_grid.SYM_TILE),
        pair_grid.box_planes(blk[0], blk[1], blk[5], pair_grid.SYM_TILE),
        CUTOFF_M)
    out.append((f"sym_dense_cutoff {kb} x {kb}", lambda: cuda_forces.
                pair_force_sym_dense(*rows[:6], prm, tuple(blk[:6]),
                                     col_offset=kb, grid=grid),
                "pair_force_sym_dense_kernel", 20))
    return out


def dense_cases(dev):
    """(name, call, kernel name filter, reps) of the dense walks and the
    ring at the shapes of the main paths."""
    import numpy as np
    import torch
    import shard_cases as sc
    from family_cases import family_planes, family_run
    from carla_social_force_model_tpu_torch.models.params import (
        MoussaidParams, moussaid_vector)
    from carla_social_force_model_tpu_torch.ops import (cuda_forces,
                                                        cuda_ring, pair_grid)
    cs = smoke()
    prm = moussaid_vector(MoussaidParams(), dev)
    planes = cs.to_planes(*cs.seeded_crowd(N, 7, float(np.sqrt(N))), dev)
    fam = family_planes(N, 31, dev)
    dense = "pair_force_dense_kernel"
    out = [("dense 10k", lambda: cuda_forces.pair_force_dense(*planes, prm),
            dense, 20)]
    out += [(f"{law} dense 10k", lambda law=law: family_run(law, fam,
                                                             "dense"),
             dense, 20) for law in ("powerlaw", "helbing")]
    for n, seed, reps in CUT_CASES:
        sp = cs.sorted_crowd(n, seed, dev)
        forms = [pair_grid.cutoff_grid(sp[0], sp[1], sp[5], CUTOFF_M,
                                       symmetric=False)]
        if forms[0].form == "compact":  # the overflow walk at the same N
            forms.append(pair_grid.cutoff_grid(
                sp[0], sp[1], sp[5], CUTOFF_M, symmetric=False,
                compact=False))
        out += [(f"{g.form} N={n}", lambda sp=sp, g=g: cuda_forces.
                 pair_force_cutoff(*sp, prm, g), dense, reps) for g in forms]
    k = N // 4
    pl = sc.shard_planes(N, 28, dev, n_shards=4)
    rows = sc.split(pl, 0, k)
    out.append((f"dense rect {k} x {N}", lambda: cuda_forces.pair_force_rect(
        *rows[:6], prm, tuple(pl[:6])), dense, 20))
    out += [(f"ring_force D={d} N={N}", lambda d=d: cuda_ring.ring_force(
        *pl[:6], prm, d), "ring_force_kernel", 20) for d in (4, 1)]
    # the most agents the ring must take at D = 4: 128 rows a block at 3
    # resident blocks an SM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    big = 3 * sms // 4 * 128 * 4
    bpl = sc.shard_planes(big, 31, dev, n_shards=4)
    out.append((f"ring_force D=4 N={big}", lambda: cuda_ring.ring_force(
        *bpl[:6], prm, 4), "ring_force_kernel", 5))
    return out


#: the law structs' names in the kernels' census labels
LAW_TYPES = {"moussaid": "Moussaid", "powerlaw": "PowerLaw",
             "helbing": "Helbing"}


#: law_work's pair counts by (law, planes, c2, offsets), so that the cases
#: of one set of planes count its pairs once
_PAIR_COUNTS: dict = {}


def law_work(law, rows, cols, c2, row_off, col_off, tables=0, sym=False,
             mirror=False):
    """``work()`` of one dense launch of ``law`` (``mesh_cases``): rows
    ``(B, R)`` against columns ``(B, C)`` (planes x, y, vx, vy, radius,
    alive; Helbing's rows read their desired directions in the velocity
    slots and no radius), ``tables`` further words of grid read once.
    ``(bound, units)``: the bound of ``chip_smoke.bound`` (every plane
    read once, the forces written once, the law's operations on the
    ordered pairs within ``c2`` that this data holds: the power law's
    gates counted as ``chip_smoke.family_work`` counts them) and those
    pairs, the issue floor's units.  With ``sym`` (a Newton's-third-law
    launch on square planes, ``rows`` = ``cols``) the unordered pairs,
    each evaluated once, and the planes read once; with ``mirror`` (the
    full block: every (row, column) pair once) the columns' forces are
    written too."""
    import torch
    import shard_cases as sc
    cs = smoke()
    key = (law, id(rows[0]), id(cols[0]), c2, row_off, col_off)
    if key not in _PAIR_COUNTS:
        tau_max = sc.law_params("powerlaw").tau_max
        x, y, vx, vy, rad, alive = rows[:6]
        cx, cy, cvx, cvy, crad, calive = cols[:6]
        ri = torch.arange(x.shape[1], device=x.device) + row_off
        ci = torch.arange(cx.shape[1], device=x.device) + col_off
        pairs = course = active = 0
        for b in range(x.shape[0]):
            for lo in range(0, x.shape[1], 1024):
                hi = lo + 1024
                dx = cx[b, None, :] - x[b, lo:hi, None]
                dy = cy[b, None, :] - y[b, lo:hi, None]
                ok = (alive[b, lo:hi, None] & calive[b, None, :]
                      & (ri[lo:hi, None] != ci[None, :])
                      & (dx * dx + dy * dy <= c2))
                pairs += int(ok.sum())
                if law != "powerlaw":
                    continue
                dvx = vx[b, lo:hi, None] - cvx[b, None, :]
                dvy = vy[b, lo:hi, None] - cvy[b, None, :]
                a = dvx * dvx + dvy * dvy
                bb = -dx * dvx - dy * dvy
                rs = rad[b, lo:hi, None] + crad[b, None, :]
                c = dx * dx + dy * dy - rs * rs
                disc = bb * bb - a * c
                on = ok & (c > 0.0) & (disc > 0.0) & (a > 1e-8)
                tau = ((-bb - torch.sqrt(torch.where(on, disc, 1.0)))
                       / torch.where(on, a, 1.0))
                course += int(on.sum())
                active += int((on & (tau > 0.0) & (tau < tau_max)).sum())
        _PAIR_COUNTS[key] = pairs, course, active
    # a Newton's-third-law launch evaluates each unordered pair once (the
    # gates are symmetric: the ordered counts are even)
    pairs, course, active = (k // 2 if sym else k
                             for k in _PAIR_COUNTS[key])
    if law == "moussaid":
        ops, mufu = pairs * cs.PAIR_OPS, pairs * cs.PAIR_MUFU
    elif law == "powerlaw":
        ops = (pairs * cs.PL_GATE_OPS + course * cs.PL_TAU_OPS
               + active * cs.PL_FORCE_OPS)
        mufu = course * cs.PL_TAU_MUFU + active * cs.PL_FORCE_MUFU
    else:
        ops, mufu = pairs * cs.HB_OPS, pairs * cs.HB_MUFU
    plane_bytes = 4 * (4 if law == "helbing" else 5) + 1
    nb, nr = rows[0].shape
    nc = cols[0].shape[1]
    n_bytes = (nb * ((nr if sym else nr + nc) * plane_bytes
                     + 8 * (nr + (nc if mirror else 0)))
               + 4 * (tables + 6 * nb))
    return cs.bound(n_bytes, ops, mufu), pairs


def batched_cases(dev):
    """(name, call, kernel name filter, reps[, work]) of the square batched
    dense walks (``pair_force_dense_batched_kernel``) at the smoke's
    shapes: phase 27's config #5 (256 crowds x 1,000) under each law, and
    phase 30's box-skip form at config #5 + 30 m and its table form at 8 x
    50,000 under each law, and the box-skip form at 8 x 50,000, these with
    their bounds and issue floors (``work``, as in :func:`mesh_cases`);
    then the square batched symmetric walks
    (``pair_force_sym_batched_kernel``) under the Moussaid law and the
    power law, with bounds and floors: the triangle walk at config #5
    and B = 1 x 10,000 (1b, :func:`sym_all_cases`) and the triangle-box
    and table walks at phase 30's shapes (1c); then
    :func:`batched_env_cases`."""
    import batch_cases as bc
    from carla_social_force_model_tpu_torch.ops import pair_grid
    cs = smoke()
    root = Path(pair_grid.__file__).resolve().parents[2]
    small = bc.sort_rows(bc.batch_planes(cs.BATCH, cs.BATCH_N, seed=30,
                                         device=dev, extent=35.0))
    big = bc.sort_rows(bc.batch_planes(
        cs.CUT_TABLE_BATCH, cs.CUT_TABLE_N, seed=31, device=dev,
        extent=max(25.0, cs.CUT_TABLE_N ** 0.5)))
    kernel = "pair_force_dense_batched_kernel"
    out = all_tiles_cases(dev, square=True)
    c2 = pair_grid.cutoff_sq(cs.CUTOFF_M)
    for form, pl, laws in (
            ("dense_cutoff", small, ("moussaid", "powerlaw", "helbing")),
            ("compact", big, ("moussaid", "powerlaw", "helbing")),
            ("dense_cutoff", big, ("moussaid",))):
        grid = bc.cutoff_grid_of(form, pl, cs.CUTOFF_M)
        b, n = pl[0].shape
        walk = (box_skip_walk(n, root) if form == "dense_cutoff"
                else "kTable")
        tables = sum(t.numel() for t in (
            grid.boxes if walk == "kBoxSkipTiles"
            or getattr(grid, "chunk_boxes", None) is None
            else grid.chunk_boxes, grid.surv, grid.counts) if t is not None)
        for law in laws:
            def work(pl=pl, law=law, walk=walk, tables=tables):
                bnd, pairs = law_work(law, pl, pl, c2, 0, 0, tables)
                return (bnd, f"pair_force_dense_batched<{walk}, "
                        f"{LAW_TYPES[law]}>", pairs)
            out.append((f"{form}_batched {b} x {n}"
                        + ("" if law == "moussaid" else f" {law}"),
                        lambda pl=pl, g=grid, f=form, law=law: bc.batch_run(
                            law, f, pl, bc.law_params(law), g),
                        kernel, 20, work))
    # the symmetric walks: 1b (config #5, no cutoff: sym_all_cases) and
    # 1c's triangle-box and table forms at phase 30's shapes, under each
    # antisymmetric law
    out += sym_all_cases(dev, square=True)
    for form, pl, walk in (("sym_cutoff", small, "kTriangleBox"),
                           ("sym_compact", big, "kSymTable")):
        grid = bc.cutoff_grid_of(form, pl, cs.CUTOFF_M)
        b, n = pl[0].shape
        tables = sum(t.numel() for t in (grid.boxes, grid.surv, grid.counts)
                     if t is not None)
        for law in ("moussaid", "powerlaw"):
            def work(pl=pl, law=law, walk=walk, tables=tables):
                bnd, pairs = law_work(law, pl, pl, c2, 0, 0, tables,
                                      sym=True)
                return (bnd, f"pair_force_sym_batched<{walk}, "
                        f"{LAW_TYPES[law]}>", pairs)
            out.append((f"{form}_batched {b} x {n}"
                        + ("" if law == "moussaid" else f" {law}"),
                        lambda pl=pl, g=grid, f=form, law=law: bc.batch_run(
                            law, f, pl, bc.law_params(law), g),
                        "pair_force_sym_batched_kernel", 20, work))
    return out + batched_env_cases(dev)


def all_tiles_cases(dev, square=False, mesh=False,
                    laws=("moussaid", "powerlaw", "helbing")):
    """(name, call, kernel name filter, reps, work) of the batched all-tiles
    walk (``pair_force_dense_batched_kernel<kAllTiles, Law>``, rows 2b and
    2r-b) under each of ``laws``: with ``square`` phase 27's config #5
    (256 crowds of 1,000, seed 27) and the batched ring's crowds of the
    same shape (:func:`ring_planes`, seed 34: the ring's pairs without a
    ring), and under the Moussaid law B = 1 x 10,000 (the dense cases'
    crowd) beside the unbatched ``pair_force_dense`` on the same crowd
    (held bitwise first); with
    ``mesh`` phase 33's config #5 shapes (one shard's 128 crowds x 250
    rows, seed 33, against the 1,000 gathered columns and against the next
    shard's 250-column ring block).  ``work()``: the bound (every plane
    read once, the forces written once, the law's operations on the pairs
    the data holds) and the issue floor's units, every (row, column) pair
    the walk evaluates."""
    import numpy as np
    import torch
    import batch_cases as bc
    import shard_cases as sc
    from carla_social_force_model_tpu_torch.models.params import law_rows
    from carla_social_force_model_tpu_torch.ops import cuda_forces
    cs = smoke()
    kernel = "pair_force_dense_batched_kernel"

    def work(law, rows, cols, row_off, col_off, label):
        def fn():
            nb, nr = rows[0].shape
            bnd, _ = law_work(law, rows, cols, float("inf"), row_off,
                              col_off)
            return bnd, label, nb * nr * cols[0].shape[-1]
        return fn

    def label(law):
        return f"pair_force_dense_batched<kAllTiles, {LAW_TYPES[law]}>"

    out = []
    if square:
        planes = bc.batch_planes(cs.BATCH, cs.BATCH_N, seed=27, device=dev,
                                 extent=35.0)
        ring = ring_planes(dev, cs.BATCH, cs.MESH_AGENTS, cs.BATCH_N, False)
        out += [(f"dense_batched {law} {cs.BATCH} x {cs.BATCH_N}" + what,
                 lambda law=law, pl=pl: bc.batch_run(law, "dense", pl,
                                                     bc.law_params(law)),
                 kernel, 20, work(law, pl, pl, 0, 0, label(law)))
                for pl, what in ((planes, ""), (ring, ", the ring's pairs"))
                for law in laws]
        if "moussaid" in laws:
            one = cs.to_planes(*cs.seeded_crowd(N, 7, float(np.sqrt(N))),
                               dev)
            prm = cuda_forces.law_vector("moussaid",
                                         sc.law_params("moussaid"), dev)
            b1 = [a[None].contiguous() for a in one]

            def batched():
                return cuda_forces.pair_force_dense_batched(*b1, prm[None])

            got = torch.stack(batched())[:, 0]
            want = torch.stack(cuda_forces.pair_force_dense(*one, prm))
            if not torch.equal(got, want):
                raise RuntimeError("dense_batched B=1 differs from "
                                   "pair_force_dense")
            out += [(f"dense_batched moussaid B=1 x {N}", batched, kernel, 20,
                     work("moussaid", b1, b1, 0, 0, label("moussaid"))),
                    (f"dense (unbatched) {N}",
                     lambda: cuda_forces.pair_force_dense(*one, prm),
                     "pair_force_dense_kernel", 20,
                     lambda: (work("moussaid", b1, b1, 0, 0, "")()[0],
                              "pair_force_dense<kAllTiles, Moussaid>",
                              N * N))]
    if mesh:
        d = cs.MESH_AGENTS
        k = cs.BATCH_N // d
        pl = sc.batch_shard_planes(cs.BATCH // cs.MESH_BATCH_SHARDS,
                                   cs.BATCH_N, seed=33, device=dev,
                                   extent=35.0, n_shards=d)
        rows = [a[:, k:2 * k].contiguous() for a in pl]
        blk = [a[:, 2 * k:3 * k].contiguous() for a in pl]
        nb = rows[0].shape[0]
        for law in laws:
            args, kw = sc.law_args(law, rows)
            lprm = law_rows(law, sc.law_params(law), nb, dev)
            for cols, off, what in ((pl, 0, f"{cs.BATCH_N}"),
                                    (blk, 2 * k, f"{k} ring block")):
                out.append((
                    f"dense_rect_batched {nb} x {k} x {what}"
                    + ("" if law == "moussaid" else f" {law}"),
                    lambda args=args, kw=kw, lprm=lprm, cols=cols, off=off:
                    cuda_forces.pair_force_rect_batched(
                        *args, lprm, tuple(cols[:6]), row_offset=k,
                        col_offset=off, **kw),
                    kernel, 20, work(law, rows, cols, k, off, label(law))))
    return out


def sym_all_walk(root: Path) -> bool:
    """Whether the checkout at ``root`` runs the batched symmetric walks
    without a cutoff on their own body (``sym_batch_walk``)."""
    return "void sym_batch_walk(" in (
        root / "carla_social_force_model_tpu_torch" / "csrc"
        / "pair_forces.cu").read_text()


def sym_all_evaluations(root, batch, n_rows, n_cols, tri):
    """The (row, column) pairs one launch of 1b (``tri``) or 4-b hands the
    law, masked ones included, in the checkout at ``root``: the parent's
    128 x 128 a tile pair of the triangle (its diagonal tiles whole) or of
    the full block; ``sym_batch_walk``'s by the replay of its items
    (``tools/walk_model.py``)."""
    import walk_model as wm
    nr, nc = -(-n_rows // 128), -(-n_cols // 128)
    if not sym_all_walk(root):
        return batch * 128 * 128 * (nr * (nr + 1) // 2 if tri else nr * nc)
    return wm.sym_all_replay(batch, n_rows, n_cols, tri, True,
                             wm.sym_all_blocks(root))["evaluations"]


def sym_all_cases(dev, square=False, mesh=False,
                  laws=("moussaid", "powerlaw")):
    """(name, call, kernel name filter, reps, work) of the batched
    symmetric walks without a cutoff (row 1b, ``pair_force_sym_batched``,
    and row 4-b, ``pair_force_sym_dense_batched``) under each of ``laws``:
    with ``square`` 1b at phase 27's config #5 (256 crowds of 1,000, seed
    27) and, under the Moussaid law, at B = 1 x 10,000 (the sym cases'
    crowd) beside the unbatched ``pair_force_sym`` on the same crowd; with
    ``mesh`` phase 33's config #5 shapes (one shard's 128 crowds x 250
    agents, seed 33): 1b on the shard's own agents (the half-ring's square
    part), 4-b on its rows against the next shard's 250-agent block, and
    4-b's box form on the same shards sorted, with the 30 m cutoff (for the
    record).  ``work()``: the bound (every plane read once, the forces
    written once, the law's operations on the live pairs), the issue
    floor's units (the live pairs, each once), and the pairs the walk
    hands the law (:func:`sym_all_evaluations`)."""
    import numpy as np
    import batch_cases as bc
    import shard_cases as sc
    from carla_social_force_model_tpu_torch.models.params import law_rows
    from carla_social_force_model_tpu_torch.ops import cuda_forces, pair_grid
    cs = smoke()
    root = Path(cuda_forces.__file__).resolve().parents[2]
    c2 = pair_grid.cutoff_sq(CUTOFF_M)

    def tri_work(law, pl, label):
        def fn():
            b, n = pl[0].shape
            bnd, pairs = law_work(law, pl, pl, float("inf"), 0, 0, sym=True)
            return (bnd, label, pairs,
                    sym_all_evaluations(root, b, n, n, True))
        return fn

    out = []
    if square:
        planes = bc.batch_planes(cs.BATCH, cs.BATCH_N, seed=27, device=dev,
                                 extent=35.0)
        out += [(f"sym_batched (1b) {law} {cs.BATCH} x {cs.BATCH_N}",
                 lambda law=law: bc.batch_run(law, "sym", planes,
                                              bc.law_params(law)),
                 "pair_force_sym_batched_kernel", 20,
                 tri_work(law, planes, "pair_force_sym_batched<kTriangle, "
                          f"{LAW_TYPES[law]}>")) for law in laws]
        if "moussaid" in laws:
            one = cs.to_planes(*cs.seeded_crowd(N, 7, float(np.sqrt(N))),
                               dev)
            prm = cuda_forces.law_vector("moussaid",
                                         sc.law_params("moussaid"), dev)
            b1 = [a[None].contiguous() for a in one]
            out += [(f"sym_batched (1b) moussaid B=1 x {N}",
                     lambda: cuda_forces.pair_force_sym_batched(*b1,
                                                                prm[None]),
                     "pair_force_sym_batched_kernel", 20,
                     tri_work("moussaid", b1,
                              "pair_force_sym_batched<kTriangle, Moussaid>")),
                    (f"sym (unbatched) {N}",
                     lambda: cuda_forces.pair_force_sym(*one, prm),
                     "pair_force_sym_kernel", 20,
                     lambda: (law_work("moussaid", b1, b1, float("inf"), 0,
                                       0, sym=True)[0],
                              "pair_force_sym<kTriangle, Moussaid>",
                              law_work("moussaid", b1, b1, float("inf"), 0,
                                       0, sym=True)[1],
                              128 * 128 * (-(-N // 128)) * (
                                  -(-N // 128) + 1) // 2))]
    if mesh:
        d = cs.MESH_AGENTS
        k = cs.BATCH_N // d
        nb = cs.BATCH // cs.MESH_BATCH_SHARDS
        for sort in (False, True):
            pl = sc.batch_shard_planes(nb, cs.BATCH_N, seed=33, device=dev,
                                       extent=35.0, n_shards=d, sort=sort)
            rows = [a[:, k:2 * k].contiguous() for a in pl]
            blk = [a[:, 2 * k:3 * k].contiguous() for a in pl]
            grid = None if not sort else pair_grid.block_grid(
                pair_grid.box_planes(rows[0], rows[1], rows[5],
                                     pair_grid.SYM_TILE),
                pair_grid.box_planes(blk[0], blk[1], blk[5],
                                     pair_grid.SYM_TILE), CUTOFF_M)
            for law in laws:
                args, _ = sc.law_args(law, rows)
                lprm = law_rows(law, sc.law_params(law), nb, dev)
                what = "" if law == "moussaid" else f" {law}"
                if not sort:
                    out.append((
                        f"sym_batched (1b) {nb} x {k}" + what,
                        lambda args=args, lprm=lprm, law=law:
                        cuda_forces.pair_force_sym_batched(
                            *args[:6], lprm, law=law),
                        "pair_force_sym_batched_kernel", 20,
                        tri_work(law, rows, "pair_force_sym_batched<"
                                 f"kTriangle, {LAW_TYPES[law]}>")))

                def work(law=law, rows=rows, blk=blk, cut=sort):
                    bnd, pairs = law_work(
                        law, rows, blk, c2 if cut else float("inf"), k,
                        2 * k, 0 if grid is None else
                        grid.boxes.numel() + grid.row_boxes.numel(),
                        mirror=True)
                    label = (f"pair_force_sym_dense_batched<"
                             f"{'true' if cut else 'false'}, "
                             f"{LAW_TYPES[law]}>")
                    return (bnd, label, pairs, None if cut else
                            sym_all_evaluations(root, nb, k, k, False))
                out.append((
                    f"sym_dense_batched (4-b) {nb} x {k} x {k}"
                    + (f", sorted, {CUTOFF_M:g} m" if sort else "") + what,
                    lambda args=args, lprm=lprm, law=law, blk=blk, g=grid:
                    cuda_forces.pair_force_sym_dense_batched(
                        *args[:6], lprm, tuple(blk[:6]), row_offset=k,
                        col_offset=2 * k, grid=g, law=law),
                    "pair_force_sym_dense_batched_kernel", 20, work))
    return out


def rect_grid_of(rows, cols, cutoff, **kw):
    """``pair_grid.rect_grid`` of the imported checkout for ``rows`` against
    ``cols`` (planes x, y, .., alive): with the column planes where that
    checkout's table walk reads their chunk boxes (older checkouts do
    not take them)."""
    import inspect
    from carla_social_force_model_tpu_torch.ops import pair_grid as pg
    if "cols" in inspect.signature(pg.rect_grid).parameters:
        kw["cols"] = (cols[0], cols[1], cols[5])
    return pg.rect_grid(rows[0], rows[1], rows[5],
                        pg.box_planes(cols[0], cols[1], cols[5],
                                      pg.COL_TILE),
                        cols[0].shape[-1], cutoff, **kw)


def mesh_cases(dev, with_work=True):
    """(name, call, kernel name filter, reps[, work]) of the rectangular
    batched walks at phase 33's shapes and, on the same candidate pairs,
    the unbatched table walks (see the module's docstring); ``work()``
    gives the bound, the census label and the pairs within the cutoff."""
    import torch
    import shard_cases as sc
    from carla_social_force_model_tpu_torch.models.params import law_rows
    from carla_social_force_model_tpu_torch.ops import cuda_forces, pair_grid
    cs = smoke()
    d, n, slots = cs.MESH_AGENTS, cs.MESH_TABLE_N, cs.MESH_TABLE_MAX_SURV
    b = cs.MESH_TABLE_BATCH // cs.MESH_BATCH_SHARDS
    k = n // d
    c2 = pair_grid.cutoff_sq(cs.CUTOFF_M)
    p = sc.law_params("moussaid")
    tpl = sc.batch_shard_planes(b, n, seed=35, device=dev, n_shards=d,
                                sort=True)
    six = lambda q: tuple(q[:6])  # noqa: E731
    rows = [a[:, k:2 * k].contiguous() for a in tpl]
    blk = [a[:, 2 * k:3 * k].contiguous() for a in tpl]
    prm = law_rows("moussaid", p, b, dev)
    table = rect_grid_of(rows, tpl, cs.CUTOFF_M, max_surv=slots)
    skip = rect_grid_of(rows, tpl, cs.CUTOFF_M, compact=False)
    skip_blk = rect_grid_of(rows, blk, cs.CUTOFF_M, compact=False)
    one_rows = [a[0].contiguous() for a in rows]
    one_cols = [a[0].contiguous() for a in tpl]
    one_grid = rect_grid_of(one_rows, one_cols, cs.CUTOFF_M, max_surv=slots)
    whole = sc.shard_planes(n, 35, dev, n_shards=1, sort=True)  # crowd 0
    wgrid = pair_grid.cutoff_grid(whole[0], whole[1], whole[5], cs.CUTOFF_M,
                                  symmetric=False, max_surv=slots)
    wb = [a[None].contiguous() for a in whole]
    wbgrid = pair_grid.cutoff_grid(wb[0], wb[1], wb[5], cs.CUTOFF_M,
                                   symmetric=False, max_surv=slots)
    prm1 = cuda_forces.law_vector("moussaid", p, dev)

    def work(r, c, grid, row_off, col_off, label):
        def fn():
            r2, cc = ([t if t is None or t.dim() == 2 else t[None] for t in q]
                      for q in (r, c))
            tabs = sum(t.numel() for t in (
                grid.chunk_boxes if getattr(grid, "chunk_boxes", None)
                is not None else grid.boxes, grid.surv, grid.counts)
                if t is not None)
            bnd, pairs = law_work("moussaid", r2, cc, c2, row_off, col_off,
                                  tabs)
            return bnd, label, pairs
        return fn

    batched = "pair_force_dense_batched_kernel"
    unbatched = "pair_force_dense_kernel"
    root = Path(cuda_forces.__file__).resolve().parents[2]

    def box_skip(law, rows, cols, row_off, col_off, grid, what):
        """The box-skip walk of ``law`` on ``rows`` against ``cols``, with
        the census label of the walk its shapes choose."""
        nb, nr = rows[0].shape
        args, kw = sc.law_args(law, rows)
        lprm = law_rows(law, sc.law_params(law), nb, dev)
        walk = box_skip_walk(cols[0].shape[-1], root)

        def fn():
            return cuda_forces.pair_force_rect_batched(
                *args, lprm, six(cols), row_offset=row_off,
                col_offset=col_off, grid=grid, **kw)

        def law_fn():
            tables = (grid.boxes if walk == "kBoxSkipTiles"
                      or getattr(grid, "chunk_boxes", None) is None
                      else grid.chunk_boxes)
            bnd, pairs = law_work(law, rows, cols, c2, row_off, col_off,
                                  tables.numel())
            return (bnd, f"pair_force_dense_batched<{walk}, "
                    f"{LAW_TYPES[law]}>", pairs)
        return (f"dense_cutoff_rect_batched {nb} x {nr} x {what}"
                + ("" if law == "moussaid" else f" {law}"), fn, batched, 20,
                law_fn)

    cases = [
        (f"compact_rect_batched {b} x {k} x {n}, {slots} slots", lambda:
         cuda_forces.pair_force_rect_batched(*six(rows), prm, six(tpl),
                                             row_offset=k, grid=table),
         batched, 20, work(rows, tpl, table, k, 0,
                           "pair_force_dense_batched<kTable, Moussaid>")),
        box_skip("moussaid", rows, tpl, k, 0, skip, f"{n}"),
        box_skip("moussaid", rows, blk, k, 2 * k, skip_blk,
                 f"{k} ring block"),
        (f"compact_rect (unbatched) crowd 0's {k} x {n}, {slots} slots",
         lambda: cuda_forces.pair_force_rect(
             *six(one_rows), prm1, six(one_cols), row_offset=k,
             grid=one_grid),
         unbatched, 20, work(one_rows, one_cols, one_grid, k, 0,
                             "pair_force_dense<kTable, Moussaid>")),
        (f"compact (unbatched) {n}, crowd 0 sorted as one, {slots} slots",
         lambda: cuda_forces.pair_force_cutoff(*six(whole), prm1, wgrid),
         unbatched, 20, work(whole, whole, wgrid, 0, 0,
                             "pair_force_dense<kTable, Moussaid>")),
        (f"compact_batched B=1 x {n}, crowd 0 sorted as one, {slots} slots",
         lambda: cuda_forces.pair_force_cutoff_batched(
             *six(wb), prm1[None], wbgrid),
         batched, 20, work(wb, wb, wbgrid, 0, 0,
                           "pair_force_dense_batched<kTable, Moussaid>")),
    ]
    for got, want, label in (
            (cases[0][1](), cuda_forces.pair_force_rect_batched(
                *six(rows), prm, six(tpl), row_offset=k, grid=skip), "3r-b"),
            (cases[5][1](), cuda_forces.pair_force_cutoff(*six(whole), prm1,
                                                          wgrid), "B=1")):
        torch.cuda.synchronize()
        if not torch.equal(torch.stack(got).reshape(-1),
                           torch.stack(want).reshape(-1)):
            raise RuntimeError(f"mesh case {label}: the table walk differs "
                               f"from the walk it must equal bitwise")
    # the power law's and Helbing's box-skip walks, gathered and on the ring
    # block (Helbing takes the box skip in every ring step)
    cases += [box_skip(law, rows, cols, k, off, grid, what)
              for law in ("powerlaw", "helbing")
              for cols, off, grid, what in (
                  (tpl, 0, skip, f"{n}"),
                  (blk, 2 * k, skip_blk, f"{k} ring block"))]
    # the box-skip walk at phase 33's config #5 shapes (2 x 4 mesh: one
    # shard's 128 crowds x 250 rows against the 1,000 gathered columns and
    # the next shard's 250-column block)
    ck = cs.BATCH_N // d
    cpl = sc.batch_shard_planes(cs.BATCH // cs.MESH_BATCH_SHARDS, cs.BATCH_N,
                                seed=33, device=dev, extent=35.0,
                                n_shards=d, sort=True)
    crows = [a[:, ck:2 * ck].contiguous() for a in cpl]
    cblk = [a[:, 2 * ck:3 * ck].contiguous() for a in cpl]
    cases += [box_skip("moussaid", crows, cols, ck, off,
                       rect_grid_of(crows, cols, cs.CUTOFF_M, compact=False),
                       what)
              for cols, off, what in (
                  (cpl, 0, f"{cs.BATCH_N}"),
                  (cblk, 2 * ck, f"{ck} ring block"))]
    # the all-tiles walk (2r-b without a cutoff) at the same shapes, under
    # each law
    cases += all_tiles_cases(dev, mesh=True)
    return cases if with_work else [c[:4] for c in cases]


#: the batched ring's shapes (``ring_cases``): crowds, devices, agents a
#: crowd, the laws timed, and whether the planes are sorted with a 30 m
#: cutoff; phase 33 times the first, checks the others at 32 crowds
RING_SHAPES = ((256, 4, 1_000, ("moussaid",), False),
               (32, 4, 1_000, ("moussaid", "powerlaw", "helbing"), False),
               (32, 4, 1_000, ("moussaid", "powerlaw", "helbing"), True),
               (256, 4, 1_000, ("moussaid",), True),
               (8, 4, 50_000, ("moussaid",), True))


def ring_label(root: Path, law: str, cutoff: bool) -> str:
    """The census label of the batched ring kernel of ``law`` in the
    checkout at ``root``: its own body (``ring_batch_walk``), or the
    parent's (``ring_walk``, labelled "(parent)")."""
    src = (root / "carla_social_force_model_tpu_torch" / "csrc"
           / "ring.cu").read_text()
    label = (f"ring_force_batched<{'true' if cutoff else 'false'}, "
             f"{LAW_TYPES[law]}>")
    return label if "ring_batch_walk(" in src else label + " (parent)"


def ring_planes(dev, batch, n_dev, n, sort):
    """The batched ring's ``(batch, n)`` planes (x .. ey) of
    :data:`RING_SHAPES`: phase 33's (seed 34, 35 m) at 1,000 agents,
    quarter-density shards of 50,000 (seed 35) above."""
    import shard_cases as sc
    if n <= 1_000:
        return sc.batch_shard_planes(batch, n, seed=34, device=dev,
                                     extent=35.0, n_shards=n_dev, sort=sort)
    return sc.batch_shard_planes(batch, n, seed=35, device=dev,
                                 n_shards=n_dev, sort=sort)


def ring_cases(dev, with_work=True):
    """(name, call, kernel name filter, reps[, work]) of the batched ring
    (``ring_force_batched``, row 6-b) at :data:`RING_SHAPES` under each
    law timed there; beside them the batched all-tiles walk 2b on the same
    256 crowds of 1,000 (the same pairs without a ring), and the batched
    ring at B = 1 against the unbatched ``ring_force`` at D = 4 over N =
    10,000 (the dense cases' crowd).  ``work()``: the bound (every plane
    read once, the column blocks and their D (D - 1) copies, the forces
    written once, the law's operations on the pairs the data holds) and the
    issue floor's units: every pair the walk evaluates without a cutoff
    (B N^2), the pairs within 30 m with it.  Before the times, each shape's
    first crowds are held bitwise to the unbatched ring."""
    import torch
    import batch_cases as bc
    import shard_cases as sc
    from carla_social_force_model_tpu_torch.models.params import law_rows
    from carla_social_force_model_tpu_torch.ops import (cuda_forces,
                                                        cuda_ring, pair_grid)
    cs = smoke()
    root = Path(cuda_ring.__file__).resolve().parents[2]
    c2 = pair_grid.cutoff_sq(CUTOFF_M)
    kernel = "ring_force_batched_kernel"

    def ring_work(law, pl, n_dev, cut, label):
        def fn():
            b, n = pl[0].shape
            k = n // n_dev
            slot = 6 * k + 4 * -(-k // pair_grid.COL_TILE)
            bnd, pairs = law_work(law, pl, pl, c2 if cut else float("inf"),
                                  0, 0, b * n_dev * (2 * n_dev - 1) * slot)
            return bnd, label, pairs if cut else b * n * n
        return fn

    def batched(law, pl, n_dev, cut):
        args, kw = sc.law_args(law, pl)
        prm = law_rows(law, sc.law_params(law), pl[0].shape[0], dev)
        return lambda: cuda_ring.ring_force_batched(
            *args, prm, n_dev, cutoff=CUTOFF_M if cut else None, **kw)

    out = []
    for b, n_dev, n, laws, cut in RING_SHAPES:
        pl = ring_planes(dev, b, n_dev, n, cut)
        for law in laws:
            fn = batched(law, pl, n_dev, cut)
            # the first two crowds against the unbatched ring, bitwise
            got = torch.stack(fn())[:, :2]
            args, kw = sc.law_args(law, pl)
            prm = law_rows(law, sc.law_params(law), b, dev)
            for r in range(2):
                rk = dict(kw, desired=None if kw["desired"] is None else
                          tuple(t[r] for t in kw["desired"]))
                want = torch.stack(cuda_ring.ring_force(
                    *(None if t is None else t[r] for t in args),
                    prm[r].contiguous(), n_dev,
                    cutoff=CUTOFF_M if cut else None, **rk))
                if not torch.equal(got[:, r], want):
                    raise RuntimeError(f"ring_batched {law} {b} x {n_dev} x "
                                       f"{n // n_dev}: crowd {r} differs "
                                       f"from the unbatched ring")
            out.append((f"ring_batched {law} {b} x {n_dev} x {n // n_dev}"
                        + (f", {CUTOFF_M:g} m" if cut else ""), fn, kernel,
                        20 if n <= 1_000 else 3,
                        ring_work(law, pl, n_dev, cut,
                                  ring_label(root, law, cut))))
    # 2b on the 256 crowds' pairs, without a ring
    pl = ring_planes(dev, cs.BATCH, cs.MESH_AGENTS, cs.BATCH_N, False)
    out.append((f"dense_batched (2b) moussaid {cs.BATCH} x {cs.BATCH_N}, "
                "the ring's pairs", lambda: bc.batch_run(
                    "moussaid", "dense", pl, bc.law_params("moussaid")),
                "pair_force_dense_batched_kernel", 20,
                lambda: (law_work("moussaid", pl, pl, float("inf"), 0, 0)[0],
                         "pair_force_dense_batched<kAllTiles, Moussaid>",
                         cs.BATCH * cs.BATCH_N ** 2)))
    # B = 1 against the unbatched ring on the same crowd
    one = sc.shard_planes(N, 27, dev, n_shards=4)
    prm = cuda_forces.law_vector("moussaid", sc.law_params("moussaid"), dev)
    b1 = [a[None].contiguous() for a in one]
    got = torch.stack(batched("moussaid", b1, 4, False)())[:, 0]
    want = torch.stack(cuda_ring.ring_force(*one[:6], prm, 4))
    if not torch.equal(got, want):
        raise RuntimeError("ring_batched B=1 differs from ring_force")
    out += [(f"ring_batched moussaid B=1 x 4 x {N // 4}",
             batched("moussaid", b1, 4, False), kernel, 20,
             ring_work("moussaid", b1, 4, False,
                       ring_label(root, "moussaid", False))),
            (f"ring_force (unbatched) D=4 N={N}", lambda: cuda_ring.ring_force(
                *one[:6], prm, 4), "ring_force_kernel", 20,
             lambda: (law_work("moussaid", b1, b1, float("inf"), 0, 0)[0],
                      "ring_force<false, Moussaid>", N * N))]
    return out if with_work else [c[:4] for c in out]


#: the counters of a debug build (:func:`instrument`), in order
COUNTERS = ("tiles staged", "chunks staged", "law evaluations",
            "pairs within the cutoff", "overflowing blocks", "blocks",
            "chunks tested", "chunks with a pair", "atomics",
            "blocks without a tile")

#: the dense walks' phase counters in a debug build (``sfm_dense_counters``
#: of ``csrc/pair_forces.cu``), in order: thread 0 of a block takes the
#: cycles of its own phases.  In ``dense_walk`` (the unbatched walks, the
#: parent's batched all-tiles walk): zeroing its slot and part sums, staging
#: its tiles (the loads and shared stores), the two barriers around each
#: tile's staging, walking its warp's chunks, and folding (each part's
#: flush behind its barrier, the cluster's two syncs and the fold between
#: them, the stores).  In ``dense_batch_walk``: staging (the cp.async copies
#: and their wait), the barriers around each staging, walking its warp's
#: chunks, and folding (each part's barrier and slot fold where a warp
#: holds fewer than eight slots, the cluster part, the stores).  "stagings"
#: counts the tiles (``dense_walk``) or windows (``dense_batch_walk``) a
#: block stages, "chunks walked" the chunks thread 0's warp walks.
DENSE_COUNTERS = ("blocks", "block cycles", "zeroing cycles",
                  "staging cycles", "barrier cycles", "walking cycles",
                  "fold cycles", "stagings", "chunks walked")

#: the C entry of a debug build that gives a kernel's attributes, and the
#: kernels it knows by ``which`` (label, instantiation, threads a block;
#: None for the 1b and 4-b block, the checkout's: :func:`_sym_all_threads`)
ATTRIBUTE_KERNELS = (
    ("pair_force_dense_batched<kTable, Moussaid>",
     "pair_force_dense_batched_kernel<kTable, Moussaid>", "kDenseThreads"),
    ("pair_force_dense<kTable, Moussaid>",
     "pair_force_dense_kernel<kTable, Moussaid>", "kDenseThreads"),
    ("pair_force_dense_batched<kBoxSkip, Moussaid>",
     "pair_force_dense_batched_kernel<kBoxSkip, Moussaid>", "kDenseThreads"),
    ("pair_force_sym_batched<kTriangleBox, Moussaid>",
     "pair_force_sym_batched_kernel<kTriangleBox, Moussaid>", "kSymTile"),
    ("pair_force_sym_batched<kSymTable, Moussaid>",
     "pair_force_sym_batched_kernel<kSymTable, Moussaid>", "kSymTile"),
    ("pair_force_sym_batched<kTriangleBox, PowerLaw>",
     "pair_force_sym_batched_kernel<kTriangleBox, PowerLaw>", "kSymTile"),
    ("pair_force_sym_batched<kSymTable, PowerLaw>",
     "pair_force_sym_batched_kernel<kSymTable, PowerLaw>", "kSymTile"),
    *((f"pair_force_dense_batched<kAllTiles, {law}>",
       f"pair_force_dense_batched_kernel<kAllTiles, {law}>", "kDenseThreads")
      for law in ("Moussaid", "PowerLaw", "Helbing")),
    *((f"pair_force_sym_batched<kTriangle, {law}>",
       f"pair_force_sym_batched_kernel<kTriangle, {law}>", None)
      for law in ("Moussaid", "PowerLaw")),
    *((f"pair_force_sym_dense_batched<{box}, {law}>",
       f"pair_force_sym_dense_batched_kernel<{box}, {law}>",
       "kSymTile" if box == "true" else None)
      for law in ("Moussaid", "PowerLaw") for box in ("false", "true")))


#: the batched ring's counters in a debug build (``sfm_ring_counters`` of
#: ``csrc/ring.cu``), in order; thread 0 of a block takes the cycles of its
#: own phases (the walk: its warp's chunks); "chunk steps" counts the
#: column steps of every chunk a warp walks (the law steps without a
#: cutoff), "tile visits" the tiles a block considers before its box test
RING_COUNTERS = ("block-steps", "fill polls", "done polls", "step cycles",
                 "wait cycles", "forward cycles", "staging cycles",
                 "walking cycles", "chunk steps", "tiles staged",
                 "tile visits")

#: the ring kernels ``sfm_ring_attributes`` knows, by ``which``: (label,
#: instantiation in a checkout with ``ring_batch_walk``, in one without)
RING_ATTRIBUTE_KERNELS = tuple(
    (f"ring_force_batched<{cut}, Moussaid{', kMulti' if multi else ''}>",
     f"ring_force_batched_kernel<{cut}, Moussaid, {multi}>",
     f"ring_force_batched_kernel<{cut}, Moussaid, kRingRows, {multi}>")
    for multi in ("false", "true") for cut in ("false", "true")) + (
    ("ring_force<false, Moussaid>",
     "ring_force_kernel<false, Moussaid, kRingRows, false>",
     "ring_force_kernel<false, Moussaid, kRingRows, false>"),)


#: the batched symmetric walks' per-warp counters in a debug build
#: (``sfm_sym_warps`` of ``csrc/pair_forces.cu``): for each of the first
#: SYM_WARP_BLOCKS blocks of a launch (blockIdx.y * gridDim.x +
#: blockIdx.x) and each of its four warps, the warp's own cycles (lane 0's
#: clock) in loading its rows and staging columns, at block barriers,
#: walking (its law steps and their shared or shuffled reactions) and
#: flushing (the forces' atomics and the rows' partials), its cycles in
#: all, its warp law steps (32 lanes each) and its global atomics; in
#: ``sym_tile_pair`` (the parent's 1b and 4-b, and 4-b's box form) and
#: ``sym_batch_walk``
SYM_WARP_COUNTERS = ("loads and staging cycles", "barrier cycles",
                     "walking cycles", "flush cycles", "warp cycles",
                     "law steps", "atomics")
SYM_WARP_BLOCKS = 16384
#: the warps a block's record holds (sym_batch_walk's eight; the parent's
#: tile pair fills four)
SYM_WARP_SLOTS = 8


def _sym_stamp(k: int) -> str:
    """The warp's cycles since its last stamp, added to phase ``k``."""
    return ("{ const long long sfm_c1_ = clock64(); sfm_ph_[" + str(k)
            + "] += sfm_c1_ - sfm_c0_; sfm_c0_ = sfm_c1_; }")


def _sym_begin() -> str:
    """The start of a walk: the warp's phase counters and first stamps (its
    clock, and the global timer for the block's trace)."""
    return ("  long long sfm_ph_[" + str(len(SYM_WARP_COUNTERS))
            + "] = {0};\n  const long long sfm_t0_ = clock64();\n"
            "  long long sfm_c0_ = sfm_t0_;\n"
            "  unsigned long long sfm_g0_;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(sfm_g0_));\n")


def _sym_record() -> str:
    """The end of a walk: the warp's cycles in all, and its counters added
    to its block's record (lane 0); thread 0 writes the block's trace: its
    SM, and the global timer at its start and at its end."""
    n = len(SYM_WARP_COUNTERS)
    return ("  sfm_ph_[4] += clock64() - sfm_t0_;\n"
            "  { const unsigned sfm_b_ = blockIdx.y * gridDim.x + blockIdx.x;"
            f" if (lane == 0 && sfm_b_ < {SYM_WARP_BLOCKS}u) for (int k_ = 0;"
            f" k_ < {n}; ++k_) atomicAdd(&sfm_sym_warps[(sfm_b_ * "
            f"{SYM_WARP_SLOTS}u + (unsigned)warp) * {n}u + k_], "
            "(unsigned long long)sfm_ph_[k_]);"
            f" if (threadIdx.x == 0 && sfm_b_ < {SYM_WARP_BLOCKS}u) {{ "
            "unsigned long long sfm_g1_; unsigned sfm_sm_; asm volatile(\"mov."
            "u64 %0, %%globaltimer;\" : \"=l\"(sfm_g1_)); asm volatile(\"mov."
            "u32 %0, %%smid;\" : \"=r\"(sfm_sm_)); sfm_sym_trace[sfm_b_ * 3u] "
            "= sfm_sm_; sfm_sym_trace[sfm_b_ * 3u + 1u] = sfm_g0_; "
            "sfm_sym_trace[sfm_b_ * 3u + 2u] = sfm_g1_; }"
            " }\n")


def _sym_atomics(*conds: str) -> str:
    """The warp's atomics: one for each lane and true condition."""
    terms = " + ".join(f"__popc(__ballot_sync(kAllLanes, {c}))"
                       for c in conds)
    return ("  { const int sfm_a_ = " + terms + "; if (lane == 0) "
            "sfm_ph_[6] += sfm_a_; }\n")


#: the debug build's step trace of the batched ring's own body: per block
#: (blockIdx.y * gridDim.x + blockIdx.x, at most RING_TRACE_BLOCKS) and
#: step (at most RING_TRACE_STEPS), the global timer at the step's start,
#: after its wait, after its first staging barrier and at its end; and
#: each block's SM
RING_TRACE_BLOCKS, RING_TRACE_STEPS = 1024, 16


def _ring_stamp(phase: int) -> str:
    """Thread 0's global-timer stamp ``phase`` of the current step."""
    return ("if (tid == 0 && sfm_tk_ < " + str(RING_TRACE_STEPS) + ") { "
            "const unsigned sfm_blk_ = blockIdx.y * gridDim.x + blockIdx.x; "
            "if (sfm_blk_ < " + str(RING_TRACE_BLOCKS) + ") { "
            "unsigned long long sfm_t_; asm volatile(\"mov.u64 %0, "
            "%%globaltimer;\" : \"=l\"(sfm_t_)); sfm_ring_trace[(sfm_blk_ "
            "* " + str(RING_TRACE_STEPS) + " + sfm_tk_) * 4 + " + str(phase)
            + "] = sfm_t_; } }")


def _ring_entries(own_body: bool) -> str:
    """The C source of the debug build's ring entries: read and reset
    ``sfm_ring_counters`` (and this file's copy of the walk counters:
    law evaluations and pairs within the cutoff of ``rows_vs_chunk``), and
    ``sfm_ring_attributes(which, out)`` as ``sfm_walk_attributes``."""
    n, m = len(RING_COUNTERS), len(COUNTERS)
    cases = "".join(
        f"    case {k}: f = (const void*){new if own_body else old}; "
        "break;\n"
        for k, (_, new, old) in enumerate(RING_ATTRIBUTE_KERNELS))
    return (
        "int sfm_ring_counters_read(unsigned long long* out) {\n"
        f"  cudaError_t e = cudaMemcpyFromSymbol(out, sfm_ring_counters, {n} "
        "* sizeof(unsigned long long));\n"
        f"  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + {n}, "
        f"sfm_walk_counters, {m} * sizeof(unsigned long long));\n"
        "  return (int)e;\n}\n"
        "int sfm_ring_counters_reset() {\n"
        f"  unsigned long long z[{n + m}] = {{0}};\n"
        f"  cudaError_t e = cudaMemcpyToSymbol(sfm_ring_counters, z, {n} * "
        "sizeof(unsigned long long));\n"
        f"  if (e == cudaSuccess) e = cudaMemcpyToSymbol(sfm_walk_counters, "
        f"z, {m} * sizeof(unsigned long long));\n"
        "  void* tr = nullptr;\n"
        "  if (e == cudaSuccess) e = cudaGetSymbolAddress(&tr, "
        "sfm_ring_trace);\n"
        "  if (e == cudaSuccess) e = cudaMemset(tr, 0, "
        "sizeof(sfm_ring_trace));\n"
        "  return (int)e;\n}\n"
        "int sfm_ring_trace_read(unsigned long long* out, int* smid) {\n"
        "  cudaError_t e = cudaMemcpyFromSymbol(out, sfm_ring_trace, "
        "sizeof(sfm_ring_trace));\n"
        "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(smid, "
        "sfm_ring_smid, sizeof(sfm_ring_smid));\n"
        "  return (int)e;\n}\n"
        "int sfm_ring_attributes(int which, int* out) {\n"
        "  const void* f = nullptr;\n  switch (which) {\n" + cases +
        "    default: return (int)cudaErrorInvalidValue;\n  }\n"
        "  cudaFuncAttributes a;\n"
        "  cudaError_t e = cudaFuncGetAttributes(&a, f);\n"
        "  if (e == cudaSuccess) e = "
        "cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, f, kThreads, 0);"
        "\n  out[1] = a.numRegs; out[2] = (int)a.sharedSizeBytes; "
        "out[3] = (int)a.localSizeBytes;\n"
        "  return (int)e;\n}\n\n")


def _sym_all_threads(root: Path) -> str:
    """The threads of a 1b and 4-b block in the checkout at ``root``:
    ``kSymAllThreads`` where it has ``sym_batch_walk``, else the parent's
    ``kSymTile``."""
    return "kSymAllThreads" if sym_all_walk(root) else "kSymTile"


def _attributes_entry(root: Path) -> str:
    """The C source of ``sfm_walk_attributes(which, out)`` for the checkout
    at ``root``: the resident blocks an SM, registers, static shared and
    local bytes of kernel ``which`` of :data:`ATTRIBUTE_KERNELS`."""
    sym_all = _sym_all_threads(root)
    cases = "".join(
        f"    case {k}: f = (const void*){inst}; threads = "
        f"{threads or sym_all}; break;\n"
        for k, (_, inst, threads) in enumerate(ATTRIBUTE_KERNELS))
    return ("int sfm_walk_attributes(int which, int* out) {\n"
            "  const void* f = nullptr;\n  int threads = 0;\n"
            "  switch (which) {\n" + cases +
            "    default: return (int)cudaErrorInvalidValue;\n  }\n"
            "  cudaFuncAttributes a;\n"
            "  cudaError_t e = cudaFuncGetAttributes(&a, f);\n"
            "  if (e == cudaSuccess) e = "
            "cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, f, threads, "
            "0);\n"
            "  out[1] = a.numRegs; out[2] = (int)a.sharedSizeBytes; "
            "out[3] = (int)a.localSizeBytes;\n"
            "  return (int)e;\n}\n\n")


def instrument(root: Path) -> None:
    """Patch counters into the pair walks of the checkout at ``root`` (a
    debug build for ``--counters``; idempotent).  Each insertion follows
    (or, marked so, precedes) an anchor line of ``csrc/``: the parent's
    walks (``dense_walk`` and the inner loop ``rows_vs_chunk``; the
    symmetric walk ``sym_walk`` and its tile pair ``sym_tile_pair``) and,
    where the checkout has them, the batched box-skip and table walk
    ``chunk_walk`` and the batched symmetric cutoff walk
    ``sym_rows_walk``.  A missing anchor of the dense walk raises, and so
    does one of ``sym_rows_walk`` in a checkout that has it.  "tiles
    staged" counts the column tiles ``dense_walk`` stages and the tile
    pairs the symmetric walks stage; "chunks staged" the chunks
    ``dense_walk`` walks (those its box test passes) and ``chunk_walk``
    stages, and the (32-row, 32-column) chunk pairs the symmetric walks
    walk ("chunks tested": those they test); "chunks with a pair" those
    of them where some lane holds a pair within the cutoff (in
    ``sym_rows_walk``: of its 16-step items, two a chunk pair off the
    diagonal tile); "atomics" the
    symmetric walks' global atomic adds of the forces; "blocks without a
    tile" the symmetric walks' blocks that stage none."""
    csrc = root / "carla_social_force_model_tpu_torch" / "csrc"

    def add(k, v="1ull"):
        return f"atomicAdd(&sfm_walk_counters[{k}], {v})"

    law = ("{ const unsigned okm_ = __ballot_sync(kAllLanes, ok); "
           "if ((threadIdx.x & 31) == 0) { " + add(2, "32ull") + "; "
           + add(3, "(unsigned long long)__popc(okm_)") + "; } }")

    def warp_atomics(a, b):
        return ("{ const unsigned m1_ = __ballot_sync(kAllLanes, " + a
                + " != 0.0f), m2_ = __ballot_sync(kAllLanes, " + b
                + " != 0.0f); if ((threadIdx.x & 31) == 0) "
                + add(8, "(unsigned long long)(__popc(m1_) + __popc(m2_))")
                + "; }")

    def ring(k, v="1"):
        return (f"atomicAdd(&sfm_ring_counters[{k}], "
                f"(unsigned long long)({v}))")

    def dense(k, v="1"):  # thread 0's phase counters of the dense walks
        return (f"atomicAdd(&sfm_dense_counters[{k}], "
                f"(unsigned long long)({v}))")

    sym = "sym_rows_walk"  # its anchors are required where it exists
    batch = "dense_batch_walk"  # likewise
    sym_all = "sym_batch_walk"  # likewise
    n_sym = len(SYM_WARP_COUNTERS)
    n_dense = len(DENSE_COUNTERS)
    old_ring, new_ring = "ring_walk", "ring_batch_walk"
    ring_src = (csrc / "ring.cu").read_text()
    own_body = re.search(r"\b(?:void|bool) ring_batch_walk\(", ring_src)
    edits = {
        "pair_laws.cuh": [
            ('#include "pair_forces.cuh"\n',
             "static __device__ unsigned long long sfm_walk_counters[10];\n",
             True),
            ("  if (!any) return false;\n", "  bool sfm_pair_ = false;\n",
             True),
            ("        if (!__any_sync(kAllLanes, ok)) continue;\n",
             "        " + law + " sfm_pair_ = true;\n", True),
            ("#pragma unroll 2\n    for (int k = 0; k < cnt; ++k) step(k);"
             "\n  }\n",
             "  if (sfm_pair_ && (threadIdx.x & 31) == 0) "
             + add(7) + ";\n", True)],
        "pair_forces.cu": [
            ('#include "pair_laws.cuh"\n',
             f"static __device__ unsigned long long sfm_dense_counters["
             f"{n_dense}];\n", True),
            ("  RowSet<kR> rw;\n",
             "  if (threadIdx.x == 0) " + add(5) + ";\n", True),
            # dense_walk's phases (thread 0's cycles)
            ("  const int warp = tid / 32;  // the column group\n",
             "  const long long sfm_b0_ = clock64();\n"
             "  if (tid == 0) " + dense(0) + ";\n", True),
            ("  for (int e = tid; e < kTileChunks * kRows; e += kDenseThreads)"
             " {\n", "  const long long sfm_z0_ = clock64();\n", True,
             "before"),
            ("  // the sum of the current part's slots, into part_[x|y][part - "
             "p_lo]; the\n",
             "  if (tid == 0) " + dense(2, "clock64() - sfm_z0_") + ";\n",
             True, "before"),
            ("  auto flush = [&]() {\n    __syncthreads();\n",
             "  auto flush = [&]() {\n    const long long sfm_f0_ = clock64();"
             "\n    __syncthreads();\n", True, "replace"),
            ("      part_x[cur - p_lo][row] = sx;\n      part_y[cur - p_lo]"
             "[row] = sy;\n    }\n",
             "    if (tid == 0) " + dense(6, "clock64() - sfm_f0_") + ";\n",
             True),
            ("    __syncthreads();  // the previous tile is consumed\n",
             "    const long long sfm_r0_ = clock64();\n", True, "before"),
            ("    __syncthreads();  // the previous tile is consumed\n",
             "    const long long sfm_r1_ = clock64();\n    if (tid == 0) { "
             + dense(4, "sfm_r1_ - sfm_r0_") + "; " + dense(7) + "; }\n",
             True),
            ("    __syncthreads();\n#pragma unroll 1\n    for (int q = 0; q < "
             "kDenseChunks; ++q) {\n",
             "    const long long sfm_r2_ = clock64();\n    if (tid == 0) "
             + dense(3, "sfm_r2_ - sfm_r1_") + ";\n    __syncthreads();\n"
             "    const long long sfm_r3_ = clock64();\n    if (tid == 0) "
             + dense(4, "sfm_r3_ - sfm_r2_") + ";\n#pragma unroll 1\n"
             "    for (int q = 0; q < kDenseChunks; ++q) {\n", True,
             "replace"),
            ("              use_radius, c2)) {\n",
             "        if (tid == 0) " + dense(8) + ";\n", True),
            ("  };\n\n  if constexpr (kWalk == kAllTiles) {\n    for (int t = "
             "t0; t < t1; ++t) run_tile(t);\n",
             "    if (tid == 0) " + dense(5, "clock64() - sfm_r3_") + ";\n",
             True, "before"),
            ("  cg::cluster_group cluster = cg::this_cluster();\n  cluster."
             "sync();  // every block's part sums are in its shared memory\n"
             "  const int per = (kRows + n_split - 1) / n_split;\n",
             "  const long long sfm_e0_ = clock64();\n", True, "before"),
            ("  cluster.sync();  // no block leaves while another reads its "
             "sums\n}\n\ntemplate <int kWalk, class Law>\n__global__ void "
             "__launch_bounds__(kDenseThreads, 2048 / kDenseThreads)\n",
             "  cluster.sync();  // no block leaves while another reads its "
             "sums\n  if (tid == 0) { " + dense(6, "clock64() - sfm_e0_")
             + "; " + dense(1, "clock64() - sfm_b0_") + "; }\n}\n\n"
             "template <int kWalk, class Law>\n__global__ void "
             "__launch_bounds__(kDenseThreads, 2048 / kDenseThreads)\n", True,
             "replace"),
            # dense_batch_walk's phases (the batched all-tiles walk)
            ("  const bool owner = tid < brows;\n",
             "  const long long sfm_b0_ = clock64();\n"
             "  if (tid == 0) " + dense(0) + ";\n", batch),
            ("    if (s1 > s0) __syncthreads();  // the staged tiles are "
             "consumed\n",
             "    const long long sfm_g0_ = clock64();\n", batch, "before"),
            ("    if (s1 > s0) __syncthreads();  // the staged tiles are "
             "consumed\n",
             "    const long long sfm_g1_ = clock64();\n    if (tid == 0) { "
             + dense(4, "sfm_g1_ - sfm_g0_") + "; " + dense(7) + "; }\n",
             batch),
            ("    cp_async_wait_all();\n    __syncthreads();  // the tiles are "
             "staged\n",
             "    cp_async_wait_all();\n    const long long sfm_g2_ = "
             "clock64();\n    if (tid == 0) " + dense(3, "sfm_g2_ - sfm_g1_")
             + ";\n    __syncthreads();  // the tiles are staged\n"
             "    if (tid == 0) " + dense(4, "clock64() - sfm_g2_") + ";\n",
             batch, "replace"),
            ("        rw.ax[0] = rw.ay[0] = 0.0f;\n        rows_vs_chunk<false, "
             "kDenseFastTail, Law, kDenseBatchRows>(\n",
             "        const long long sfm_w0_ = clock64();\n", batch,
             "before"),
            ("        sx += rw.ax[0];\n        sy += rw.ay[0];\n",
             "        if (tid == 0) { " + dense(5, "clock64() - sfm_w0_") + "; "
             + dense(8) + "; }\n", batch),
            ("    if (sets < kTileChunks) {  // block row tid: the part's slots "
             "in order\n",
             "    const long long sfm_f0_ = clock64();\n", batch, "before"),
            ("      part[(pp - p_lo) * 2 * brows + brows + tid] = py;\n    }\n",
             "    if (tid == 0) " + dense(6, "clock64() - sfm_f0_") + ";\n",
             batch),
            ("  if (n_split == 1) {  // grid-uniform: no cluster\n",
             "  const long long sfm_e0_ = clock64();\n", batch, "before"),
            ("    return;\n  }\n\n  // each row: its parts' sums in order, "
             "from every block of the cluster\n",
             "    if (tid == 0) { " + dense(6, "clock64() - sfm_e0_") + "; "
             + dense(1, "clock64() - sfm_b0_") + "; }\n    return;\n  }\n\n"
             "  // each row: its parts' sums in order, from every block of the"
             " cluster\n", batch, "replace"),
            ("  cluster.sync();  // no block leaves while another reads its "
             "part sums\n",
             "  if (tid == 0) { " + dense(6, "clock64() - sfm_e0_") + "; "
             + dense(1, "clock64() - sfm_b0_") + "; }\n", batch),
            ("    const int j0 = (int)(t * kColTile);\n",
             "    if (tid == 0) " + add(0) + ";\n", True),
            ("              use_radius, c2)) {\n",
             "        if (lane == 0) " + add(1) + ";\n", True),
            ("    if constexpr (kWalk == kTable) table = counts[trow] <= "
             "max_surv;\n",
             "    if constexpr (kWalk == kTable) { if (tid == 0 && !table) "
             + add(4) + "; }\n", True),
            # chunk_walk (the batched box-skip and table walks)
            ("  const float by1 = warp_max(ra ? y : -INFINITY);\n",
             "  if (tid == 0) " + add(5) + ";\n", False),
            ("  const bool table = counts[trow] <= max_surv;\n",
             "  if (tid == 0 && !table) " + add(4) + ";\n", False),
            ("\n  if constexpr (kWalk == kTable) table = counts[trow] <= "
             "max_surv;\n",
             "  if constexpr (kWalk == kTable) { if (tid == 0 && !table) "
             + add(4) + "; }\n", False),
            ("      for (int q = 0; q < kWin; ++q) wm[q] = q == b ? mine : "
             "wm[q];\n",
             "      if (__any_sync(kAllLanes, mine != 0) && lane == 0) "
             + add(7) + ";\n", False),
            ("        win_t[warp][b] = t_next;\n",
             "        " + add(1) + ";\n", False),
            ("      hits = __ballot_sync(kAllLanes, h);\n",
             "      { const unsigned tst_ = __ballot_sync(kAllLanes, t >= t0 "
             "&& t < t1); if (lane == 0) " + add(
                 6, "(unsigned long long)__popc(tst_)") + "; }\n", False),
            ("      const bool ok = m != 0;\n", "      " + law + "\n", False),
            # sym_walk and sym_tile_pair (the unbatched symmetric walks,
            # the parent's batched ones)
            ("  const long long b = blockIdx.x;\n  const long long nt = "
             "n_tiles;\n", "  if (threadIdx.x == 0) " + add(5) + ";\n",
             False),
            ("    const long long s = b % max_surv;\n",
             "    if (threadIdx.x == 0 && counts[r] > max_surv) " + add(4)
             + ";\n", False),
            ("      const int tj = surv[r * max_surv + s];\n",
             "      if (threadIdx.x == 0 && tj < 0) " + add(9) + ";\n",
             False),
            ("    return;\n  }\n\n  // block -> tile pair (ti, tj) with tj "
             ">= ti\n",
             "    if (threadIdx.x == 0 && counts[r] > max_surv) { bool f_ = "
             "false; for (long long t_ = r + s; t_ < nt; t_ += max_surv) "
             "f_ = f_ || hits(r, t_); if (!f_) " + add(9) + "; }\n",
             False, "before"),
            ("  if (kWalk == kTriangleBox && !hits(ti, tj)) return;  // "
             "before any staging\n",
             "  if (threadIdx.x == 0 && kWalk == kTriangleBox && !hits(ti, "
             "tj)) " + add(9) + ";\n", False, "before"),
            ("  __syncthreads();  // the previous tile pair's sums are "
             "read\n", "  if (threadIdx.x == 0) " + add(0) + ";\n", False),
            ("    const int chunk = cg * L::kWarpChunks + q;\n",
             "    if (lane == 0) " + add(6) + ";\n", False),
            ("    if (!any) continue;  // (the rows' own triangle test is in "
             "ok below)\n",
             "    bool sfm_cp_ = false; if (lane == 0) " + add(1) + ";\n",
             False),
            ("          if (!__any_sync(kAll, ok)) continue;\n",
             "          " + law + " sfm_cp_ = true;\n", False),
            ("      sm.col_y[rg][jj] -= cfy;\n      __syncwarp();\n    }\n",
             "    if (sfm_cp_ && lane == 0) " + add(7) + ";\n", False),
            ("  if (it < rows.n && rows.alive[it] != 0) {\n",
             "    " + add(8, "2ull") + ";\n", False),
            ("  if (col_in && cat != 0) {\n",
             "    " + add(8, "2ull") + ";\n", False),
            # sym_rows_walk (the batched symmetric cutoff walks)
            ("  const float by0 = bb[2 * nt + ti], by1 = bb[3 * nt + ti];\n",
             "  if (threadIdx.x == 0) " + add(5) + ";\n"
             "  if constexpr (kWalk == kSymTable) { if (threadIdx.x == 0 && "
             "!table) " + add(4) + "; }\n  bool sfm_found_ = false;\n", sym),
            ("    if (total > 0) fetch(sm.list[0]);\n",
             "    sfm_found_ = sfm_found_ || total > 0;\n", sym),
            ("      stage(tj == ti);\n",
             "      if (tid == 0) " + add(0) + ";\n", sym),
            ("      for (int r = 0; r < (diag ? warp + 1 : kSymWarps); ++r) "
             "{\n", "        " + add(6) + ";\n", sym),
            ("          continue;  // the chunk pair holds no pair within "
             "the cutoff\n", "        " + add(1) + ";\n", sym),
            ("      const int c0 = c * kChunk;\n      float ax = 0.0f, ay = "
             "0.0f;\n", "      bool sfm_cp_ = false;\n", sym),
            ("        if (!__any_sync(kAllLanes, ok)) continue;  // no lane's "
             "pair within\n", "        " + law + " sfm_cp_ = true;\n", sym),
            ("        sm.col_y[warp][jj] -= fyk;\n        __syncwarp();\n"
             "      }\n", "      if (sfm_cp_ && lane == 0) " + add(7)
             + ";\n", sym),
            ("      if (sy != 0.0f) atomicAdd(&fy[j], sy);\n",
             "      " + warp_atomics("sx", "sy") + "\n", sym),
            ("  if (sy != 0.0f) atomicAdd(&fy[i], sy);\n",
             "  " + warp_atomics("sx", "sy") + "\n  if (tid == 0 && "
             "!sfm_found_) " + add(9) + ";\n", sym),
            ("const char* sfm_cuda_error_string(int err) {\n",
             "int sfm_walk_counters_read(unsigned long long* out) {\n"
             "  return (int)cudaMemcpyFromSymbol(out, sfm_walk_counters,\n"
             f"                                   {len(COUNTERS)} * "
             "sizeof(unsigned long long));\n}\n"
             "int sfm_walk_counters_reset() {\n"
             f"  unsigned long long z[{len(COUNTERS)}] = {{0}};\n"
             "  return (int)cudaMemcpyToSymbol(sfm_walk_counters, z, "
             "sizeof(z));\n}\n" + _attributes_entry(root), True, "before"),
            # the symmetric walks' per-warp counters: sym_tile_pair (the
            # parent's 1b and 4-b, 4-b's box form)
            ('#include "pair_laws.cuh"\n',
             "static __device__ unsigned long long sfm_sym_warps["
             f"{SYM_WARP_BLOCKS * SYM_WARP_SLOTS * n_sym}];\n"
             "static __device__ unsigned long long sfm_sym_trace["
             f"{SYM_WARP_BLOCKS * 3}];\n", True),
            ("  __syncthreads();  // the previous tile pair's sums are "
             "read\n", _sym_begin(), True, "before"),
            ("  __syncthreads();  // the previous tile pair's sums are "
             "read\n", "  " + _sym_stamp(1) + "\n", True),
            ("  const int g0 = cols.off + j0;\n  __syncthreads();\n",
             "  const int g0 = cols.off + j0;\n  " + _sym_stamp(0)
             + "\n  __syncthreads();\n  " + _sym_stamp(1) + "\n", True,
             "replace"),
            ("      sm.col_x[rg][jj] -= cfx;  // Newton's third law: f_ji = "
             "-f_ij\n", "      if (lane == 0) sfm_ph_[5] += kR;\n", True),
            ("  __syncthreads();\n  // thread t adds row t's and column t's "
             "partials, in a fixed order\n",
             "  " + _sym_stamp(2) + "\n", True, "before"),
            ("  // thread t adds row t's and column t's partials, in a fixed "
             "order\n", "  " + _sym_stamp(1) + "\n", True),
            ("    atomicAdd(&fxc[jt], sx_sum);\n    atomicAdd(&fyc[jt], "
             "sy_sum);\n  }\n}\n",
             "    atomicAdd(&fxc[jt], sx_sum);\n    atomicAdd(&fyc[jt], "
             "sy_sum);\n  }\n"
             + _sym_atomics("it < rows.n && rows.alive[it] != 0",
                            "col_in && cat != 0").replace(
                 "sfm_a_ = ", "sfm_a_ = 2 * (") .replace("; if", "); if", 1)
             + "  " + _sym_stamp(3) + "\n" + _sym_record() + "}\n", True,
             "replace"),
            # sym_batch_walk (the redesign's 1b and 4-b)
            ("  const typename Law::Prm p = Law::load(prm);\n\n  // this "
             "lane's rows i0 + 64 g + lane + 32 r\n",
             _sym_begin(), sym_all),
            ("    if (tid >= kSymTile) sm.ra[b][sc].y = qa ? 1.0f : 0.0f;\n",
             "    " + _sym_stamp(0) + "\n", sym_all),
            ("    __syncthreads();\n    if (prev >= 0) flush(prev, (q - 1) & "
             "1);\n",
             "    __syncthreads();\n    " + _sym_stamp(1) + "\n    if (prev "
             ">= 0) flush(prev, (q - 1) & 1);\n    " + _sym_stamp(3) + "\n",
             sym_all, "replace"),
            ("    if (q + 1 < n_cand) stage(tj + n_split, b ^ 1);\n",
             "    " + _sym_stamp(0) + "\n", sym_all),
            ("        float sx = 0.0f, sy = 0.0f, cx = 0.0f, cy = 0.0f;\n",
             "        if (lane == 0) sfm_ph_[5] += kChunk / 2;\n", sym_all),
            ("        sm.part[warp][1][jc] += cy;\n        __syncwarp();\n"
             "      }\n", "      " + _sym_stamp(2) + "\n", sym_all),
            ("#pragma unroll 1\n        for (int s = 0; s < kChunk; ++s) {\n"
             "          const int cc = (lane + s) & (kChunk - 1);\n",
             "        if (lane == 0) sfm_ph_[5] += kChunk * kR;\n", sym_all,
             "before"),
            ("      prev = tj;\n    }\n  }\n",
             "      prev = tj;\n      " + _sym_stamp(2) + "\n    }\n  }\n",
             sym_all, "replace"),
            ("    if (j < cols.n && s != 0.0f) atomicAdd(k == 0 ? &fxc[j] : "
             "&fyc[j], s);\n",
             "  " + _sym_atomics("j < cols.n && s != 0.0f"), sym_all),
            ("  __syncthreads();  // every warp's partials of the block's "
             "rows\n",
             "  " + _sym_stamp(3) + "\n  __syncthreads();  // every warp's "
             "partials of the block's rows\n  " + _sym_stamp(1) + "\n",
             sym_all, "replace"),
            ("  if (i < rows.n && s != 0.0f) atomicAdd(k == 0 ? &fx[i] : "
             "&fy[i], s);\n}\n",
             "  if (i < rows.n && s != 0.0f) atomicAdd(k == 0 ? &fx[i] : "
             "&fy[i], s);\n" + _sym_atomics("i < rows.n && s != 0.0f")
             + "  " + _sym_stamp(3) + "\n" + _sym_record() + "}\n",
             sym_all, "replace"),
            ("const char* sfm_cuda_error_string(int err) {\n",
             "int sfm_sym_warps_read(unsigned long long* out) {\n"
             "  return (int)cudaMemcpyFromSymbol(out, sfm_sym_warps, "
             "sizeof(sfm_sym_warps));\n}\n"
             "int sfm_sym_trace_read(unsigned long long* out) {\n"
             "  return (int)cudaMemcpyFromSymbol(out, sfm_sym_trace, "
             "sizeof(sfm_sym_trace));\n}\n"
             "int sfm_sym_warps_reset() {\n  void* p = nullptr;\n"
             "  cudaError_t e = cudaGetSymbolAddress(&p, sfm_sym_warps);\n"
             "  if (e == cudaSuccess) e = cudaMemset(p, 0, "
             "sizeof(sfm_sym_warps));\n"
             "  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, "
             "sfm_sym_trace);\n"
             "  if (e == cudaSuccess) e = cudaMemset(p, 0, "
             "sizeof(sfm_sym_trace));\n  return (int)e;\n}\n\n", True,
             "before"),
            ("const char* sfm_cuda_error_string(int err) {\n",
             "int sfm_dense_counters_read(unsigned long long* out) {\n"
             "  return (int)cudaMemcpyFromSymbol(out, sfm_dense_counters,\n"
             f"                                   {n_dense} * "
             "sizeof(unsigned long long));\n}\n"
             "int sfm_dense_counters_reset() {\n"
             f"  unsigned long long z[{n_dense}] = {{0}};\n"
             "  return (int)cudaMemcpyToSymbol(sfm_dense_counters, z, "
             "sizeof(z));\n}\n\n", True, "before")],
        "ring.cu": [
            ('#include "pair_laws.cuh"\n',
             "static __device__ unsigned long long sfm_ring_counters["
             f"{len(RING_COUNTERS)}];\n"
             "static __device__ unsigned long long sfm_ring_trace["
             f"{RING_TRACE_BLOCKS * RING_TRACE_STEPS * 4}];\n"
             f"static __device__ int sfm_ring_smid[{RING_TRACE_BLOCKS}];\n",
             True),
            ('extern "C" {\n', _ring_entries(bool(own_body)), True),
            # both bodies: the tiles a block considers
            ("      for (int t = 0; t < nct; ++t) {\n",
             "        if (tid == 0) " + ring(10) + ";\n", True),
            # ring_walk (the unbatched ring; the parent's batched ring):
            # its polls count fill and done together
            ("    const int src = ((d - k) % D + D) % D;  // the block's home "
             "device\n", "    const long long sfm_s0_ = clock64();\n"
             "    if (tid == 0) " + ring(0) + ";\n", old_ring),
            ("      __nanosleep(64);\n", "      " + ring(1) + ";\n",
             old_ring, "before"),
            ("    if (k < D - 1) {\n      // forward this block (and its "
             "boxes) into the right neighbour's other\n",
             "    if (tid == 0) " + ring(4, "clock64() - sfm_s0_") + ";\n"
             "    const long long sfm_f0_ = clock64();\n", old_ring,
             "before"),
            ("      if (tid == 0) add_release(&a.fill[right * 2 + dst_slot], "
             "1);\n    }\n",
             "    if (tid == 0) " + ring(5, "clock64() - sfm_f0_") + ";\n",
             old_ring),
            ("        __syncthreads();  // the previous column tile is "
             "consumed\n", "        const long long sfm_g0_ = clock64();\n"
             "        if (tid == 0) " + ring(9) + ";\n", old_ring,
             "before"),
            ("        const int jc = j0 + warp * kChunk;\n",
             "        if (tid == 0) " + ring(6, "clock64() - sfm_g0_")
             + ";\n        const long long sfm_c0_ = clock64();\n",
             old_ring, "before"),
            ("        const int jc = j0 + warp * kChunk;\n",
             "        bool sfm_walked_ = false;\n", old_ring),
            ("          rows_vs_chunk<kCutoff, kRingFastTail, Law, kR>(\n",
             "          sfm_walked_ =\n", old_ring, "before"),
            ("              a.use_radius, a.c2);\n",
             "        if (tid == 0) " + ring(7, "clock64() - sfm_c0_")
             + ";\n        if (sfm_walked_ && lane == 0) "
             + ring(8, "min(kChunk, n - jc)") + ";\n", old_ring),
            ("        add_release(&a.done[d * 2 + (k & 1)], 1);\n      }\n"
             "    }\n", "    if (tid == 0) " + ring(3, "clock64() - sfm_s0_")
             + ";\n", old_ring),
            # ring_batch_walk (the batched ring's own body)
            ("  // ring step k of crowd b: the block's groups rank, rank + G, "
             "... (nq of\n", "  int sfm_tk_ = 0;  // the block's steps\n"
             "  if (tid == 0 && blockIdx.y * gridDim.x + blockIdx.x < "
             f"{RING_TRACE_BLOCKS}) {{ unsigned sfm_sm_; asm volatile(\"mov."
             "u32 %0, %%smid;\" : \"=r\"(sfm_sm_)); sfm_ring_smid[blockIdx.y "
             "* gridDim.x + blockIdx.x] = (int)sfm_sm_; }\n", new_ring,
             "before"),
            ("    const int src = ((d - k) % D + D) % D;  // the column "
             "block's home\n", "    const long long sfm_s0_ = clock64();\n"
             "    if (tid == 0) " + ring(0) + ";\n    " + _ring_stamp(0)
             + "\n", new_ring),
            ("        ok = pf >= 0 && pd >= 0;\n",
             "        " + ring(1, "pf > 0 ? pf : 0") + ";\n        "
             + ring(2, "pd > 0 ? pd : 0") + ";\n", new_ring),
            ("      if (!__syncthreads_and(ok)) return false;\n    }\n",
             "    if (tid == 0) " + ring(4, "clock64() - sfm_s0_") + ";\n    "
             + _ring_stamp(1) + "\n", new_ring),
            ("    float h[kPlanes];\n",
             "    const long long sfm_f0_ = clock64();\n", new_ring),
            ("    bool fill_due = fwd;\n",
             "    if (tid == 0) " + ring(5, "clock64() - sfm_f0_") + ";\n",
             new_ring, "before"),
            ("        ColTile& tl = sm.tile[par];\n",
             "        const long long sfm_g0_ = clock64();\n"
             "        if (tid == 0) " + ring(9) + ";\n", new_ring, "before"),
            ("        __syncthreads();  // the tile is staged (the other "
             "buffer free)\n",
             "        if (tid == 0) " + ring(6, "clock64() - sfm_g0_") + ";\n"
             "        if (q == 0 && t == 0) { " + _ring_stamp(2) + " }\n",
             new_ring),
            ("          const bool walked = rows_vs_chunk<kCutoff, "
             "kRingFastTail, Law,\n",
             "          const long long sfm_c0_ = clock64();\n", new_ring,
             "before"),
            ("          if (walked) {  // else nothing was added\n",
             "          if (tid == 0) " + ring(7, "clock64() - sfm_c0_")
             + ";\n          if (walked && lane == 0) "
             + ring(8, "min(kChunk, n - jc)") + ";\n", new_ring, "before"),
            ("    return true;\n  };\n",
             "    if (tid == 0) " + ring(3, "clock64() - sfm_s0_") + ";\n    "
             + _ring_stamp(3) + "\n    ++sfm_tk_;\n", new_ring, "before")],
    }
    for name, items in edits.items():
        path = csrc / name
        text = path.read_text()
        if "sfm_walk_counters" in text:
            continue
        for anchor, line, required, *where in items:
            if isinstance(required, str):  # required where the walk exists
                required = re.search(rf"\b(?:void|bool) {required}\(",
                                     text) is not None
            if anchor not in text:
                if required:
                    raise RuntimeError(f"{name}: no anchor {anchor!r}")
                continue
            text = text.replace(anchor, line if where == ["replace"]
                                else line + anchor if where
                                else anchor + line)
        path.write_text(text)


def walk_counters(dev, label, card, sink, only=None, trace_out=None):
    """One launch of each Moussaid mesh case, of the square table walk at 8
    x 50,000 and of the square box-skip walk at config #5 + 30 m (phase
    30's 256 x 1,000) through the debug build: its counters per 32-row
    block (one JSON line each); then the batched symmetric cutoff walks
    under each law at phase 30's shapes (the triangle-box walk at config
    #5 + 30 m, the table at 8 x 50,000 with 32 slots and with 8, where
    some rows overflow): their counters per tile pair staged and per
    128-row table row, with the table rows that overflow; and first the
    kernels' resident blocks, registers and shared and local bytes
    (:data:`ATTRIBUTE_KERNELS`); then :func:`ring_counters`.  ``only``:
    substrings of the case names to run (the attributes print anyway)."""
    import ctypes
    import torch
    import batch_cases as bc
    from carla_social_force_model_tpu_torch.utils import cuda_build
    lib = cuda_build.load_kernels()

    def kept(name):
        return only is None or any(k in name for k in only)
    lib.sfm_walk_counters_read.argtypes = [ctypes.c_void_p]
    lib.sfm_walk_attributes.argtypes = [ctypes.c_int, ctypes.c_void_p]
    cs = smoke()
    for which, (kernel, _, _) in enumerate(ATTRIBUTE_KERNELS):
        attrs = (ctypes.c_int * 4)()
        err = lib.sfm_walk_attributes(which, attrs)
        line = json.dumps({"root": label, "kernel": kernel, "error": err,
                           "blocks_per_sm": attrs[0], "registers": attrs[1],
                           "static_shared_bytes": attrs[2],
                           "local_bytes": attrs[3], "card": card})
        print(line, flush=True)
        sink.append(line)
    big = bc.sort_rows(bc.batch_planes(
        cs.CUT_TABLE_BATCH, cs.CUT_TABLE_N, seed=31, device=dev,
        extent=max(25.0, cs.CUT_TABLE_N ** 0.5)))
    sq_grid = bc.cutoff_grid_of("compact", big, cs.CUTOFF_M)
    small = bc.sort_rows(bc.batch_planes(cs.BATCH, cs.BATCH_N, seed=30,
                                         device=dev, extent=35.0))
    skip_grid = bc.cutoff_grid_of("dense_cutoff", small, cs.CUTOFF_M)
    cases = [c for c in mesh_cases(dev, with_work=False)
             if "powerlaw" not in c[0] and "helbing" not in c[0]
             and not c[0].startswith("dense_rect_batched")]
    cases.append((f"compact_batched {cs.CUT_TABLE_BATCH} x {cs.CUT_TABLE_N}",
                  lambda: bc.batch_run("moussaid", "compact", big,
                                       bc.law_params("moussaid"), sq_grid),
                  None, 1))
    cases.append((f"dense_cutoff_batched {cs.BATCH} x {cs.BATCH_N}",
                  lambda: bc.batch_run("moussaid", "dense_cutoff", small,
                                       bc.law_params("moussaid"), skip_grid),
                  None, 1))
    sym = []  # (name, call, grid)
    for form, planes, slots in (("sym_cutoff", small, 0),
                                ("sym_compact", big, 0),
                                ("sym_compact", big,
                                 cs.CUT_OVERFLOW_MAX_SURV)):
        grid = bc.cutoff_grid_of(form, planes, cs.CUTOFF_M, slots)
        b, n = planes[0].shape
        for law in ("moussaid", "powerlaw"):
            sym.append((f"{form}_batched {b} x {n}"
                        + (f", {grid.max_surv} slots" if grid.counts
                           is not None else "")
                        + ("" if law == "moussaid" else f" {law}"),
                        lambda law=law, f=form, pl=planes, g=grid:
                        bc.batch_run(law, f, pl, bc.law_params(law), g),
                        grid))
    out = (ctypes.c_ulonglong * len(COUNTERS))()

    def count(fn):
        torch.cuda.synchronize()
        if lib.sfm_walk_counters_reset() != 0:
            raise RuntimeError("cannot reset the walk counters")
        fn()
        torch.cuda.synchronize()
        if lib.sfm_walk_counters_read(out) != 0:
            raise RuntimeError("cannot read the walk counters")
        return dict(zip(COUNTERS, list(out)))

    for name, fn, _, _ in cases:
        if not kept(name):
            continue
        got = count(fn)
        # 32-row blocks (each split of a row block counts once in "blocks")
        blocks = max(got["blocks"], 1)
        row = {"root": label, "case": name, "counters": got,
               "per_block": {k: v / blocks for k, v in got.items()
                             if k != "blocks"}, "card": card}
        line = json.dumps(row)
        print(line, flush=True)
        sink.append(line)
    for name, fn, grid in sym:
        if not kept(name):
            continue
        got = count(fn)
        rows = grid.boxes.shape[0] * grid.boxes.shape[-1]
        pairs = max(got["tiles staged"], 1)
        row = {"root": label, "case": name, "counters": got,
               "table_rows": rows, "overflowing_table_rows": (
                   None if grid.counts is None
                   else int((grid.counts > grid.max_surv).sum())),
               "per_tile_pair": {k: v / pairs for k, v in got.items()},
               "per_table_row": {k: v / rows for k, v in got.items()},
               "card": card}
        line = json.dumps(row)
        print(line, flush=True)
        sink.append(line)
    sym_warp_counters(lib, label, card, sink, kept)
    dense_counters(lib, label, card, sink, kept)
    ring_counters(lib, label, card, sink, kept, trace_out)


def block_trace(trace):
    """What the blocks' trace (rows of SM, start and end on the global
    timer, ns; zero rows unrecorded) says of a launch's residency: its span,
    a block's mean length, the most blocks an SM held at once and the SMs
    used, and the blocks that started after the first block ended (a
    later wave)."""
    import numpy as np
    t = trace[trace[:, 2] > 0].astype(np.int64)
    if t.shape[0] == 0:
        return None
    sm, start, end = t[:, 0], t[:, 1] - t[:, 1].min(), t[:, 2] - t[:, 1].min()
    most = 0
    for k in np.unique(sm):
        ev = sorted([(s, 1) for s in start[sm == k]]
                    + [(e, -1) for e in end[sm == k]])
        cur = 0
        for _, d in ev:
            cur += d
            most = max(most, cur)
    return {"span_us": float(end.max()) / 1e3,
            "block_us": float((end - start).mean()) / 1e3,
            "most_blocks_an_sm": int(most), "sms": int(np.unique(sm).size),
            "started_late": int((start > end.min()).sum())}


def sym_warp_counters(lib, label, card, sink, kept=lambda name: True):
    """The batched symmetric walks' per-warp counters (``sfm_sym_warps`` of
    a debug build, :data:`SYM_WARP_COUNTERS`) for one launch of each
    Moussaid case of :func:`sym_all_cases` (1b at config #5, B = 1 x
    10,000 and the unbatched walk beside it, the mesh's 1b and 4-b, 4-b's
    box form): per block (its first :data:`SYM_WARP_BLOCKS`), the mean of
    its warps' counters (the parent's four, the redesign's eight), its
    slowest warp's (the most cycles: the block ends with it) and warp 0's
    (thread 0's, the oldest), averaged over the blocks, with the law steps
    (evaluations a lane: R a step off the diagonal) and atomics a
    block."""
    import ctypes
    import numpy as np
    import torch
    n = len(SYM_WARP_COUNTERS)
    lib.sfm_sym_warps_read.argtypes = [ctypes.c_void_p]
    lib.sfm_sym_trace_read.argtypes = [ctypes.c_void_p]
    out = np.zeros((SYM_WARP_BLOCKS, SYM_WARP_SLOTS, n), dtype=np.uint64)
    trace = np.zeros((SYM_WARP_BLOCKS, 3), dtype=np.uint64)
    dev = torch.device("cuda", 0)
    for name, fn, _, _, _ in sym_all_cases(dev, square=True, mesh=True,
                                           laws=("moussaid",)):
        if not kept(name):
            continue
        torch.cuda.synchronize()
        if lib.sfm_sym_warps_reset() != 0:
            raise RuntimeError("cannot reset the symmetric warp counters")
        fn()
        torch.cuda.synchronize()
        if lib.sfm_sym_warps_read(out.ctypes.data) != 0:
            raise RuntimeError("cannot read the symmetric warp counters")
        rec = out.astype(np.float64)
        rec = rec[rec[:, :, 4].sum(1) > 0]  # the blocks that walked
        blocks = rec.shape[0]
        if blocks == 0:
            continue
        if lib.sfm_sym_trace_read(trace.ctypes.data) != 0:
            raise RuntimeError("cannot read the symmetric walks' trace")
        warps = int((rec[:, :, 4] > 0).sum(1).max())  # a block's warps
        rec = rec[:, :warps]
        slow = rec[np.arange(blocks), rec[:, :, 4].argmax(1)]

        def named(v):
            return {k: float(x) for k, x in zip(SYM_WARP_COUNTERS, v)}
        row = {"root": label, "case": name, "blocks": blocks,
               "warps": warps,
               "mean_warp": named(rec.mean(axis=(0, 1))),
               "slowest_warp": named(slow.mean(0)),
               "warp_0": named(rec[:, 0].mean(0)),
               "per_block": {"law steps": float(rec[:, :, 5].sum(1).mean()),
                             "atomics": float(rec[:, :, 6].sum(1).mean())},
               "trace": block_trace(trace),
               "card": card}
        line = json.dumps(row)
        print(line, flush=True)
        sink.append(line)


def dense_counters(lib, label, card, sink, kept=lambda name: True):
    """The dense walks' phase counters (``sfm_dense_counters`` of a debug
    build, :data:`DENSE_COUNTERS`) for one launch of each Moussaid case of
    :func:`all_tiles_cases` (config #5, B = 1 x 10,000 and the unbatched
    walk beside it, the 2-D mesh's gathered columns and ring block): thread
    0's cycles a block in each phase, per block, with the share of the
    block's cycles each phase takes."""
    import ctypes
    import torch
    lib.sfm_dense_counters_read.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * len(DENSE_COUNTERS))()
    dev = torch.device("cuda", 0)
    for name, fn, _, _, _ in all_tiles_cases(dev, square=True, mesh=True,
                                             laws=("moussaid",)):
        if not kept(name):
            continue
        torch.cuda.synchronize()
        if lib.sfm_dense_counters_reset() != 0:
            raise RuntimeError("cannot reset the dense counters")
        fn()
        torch.cuda.synchronize()
        if lib.sfm_dense_counters_read(out) != 0:
            raise RuntimeError("cannot read the dense counters")
        got = dict(zip(DENSE_COUNTERS, list(out)))
        blocks = max(got["blocks"], 1)
        cycles = max(got["block cycles"], 1)
        row = {"root": label, "case": name, "counters": got,
               "per_block": {k: v / blocks for k, v in got.items()
                             if k != "blocks"},
               "share_of_block": {k: v / cycles for k, v in got.items()
                                  if k.endswith("cycles")
                                  and k != "block cycles"},
               "card": card}
        line = json.dumps(row)
        print(line, flush=True)
        sink.append(line)


def ring_counters(lib, label, card, sink, kept=lambda name: True,
                  trace_out=None):
    """The batched ring's counters (``sfm_ring_counters`` of a debug build)
    for one launch of each Moussaid case of :func:`ring_cases`, per
    block-step, with the law evaluations and pairs within the cutoff of
    its inner loop (``rows_vs_chunk``'s counters in ``ring.cu``; cutoff
    forms only); first the ring kernels' resident blocks, registers and
    shared and local bytes (:data:`RING_ATTRIBUTE_KERNELS`)."""
    import ctypes
    import torch
    lib.sfm_ring_counters_read.argtypes = [ctypes.c_void_p]
    lib.sfm_ring_attributes.argtypes = [ctypes.c_int, ctypes.c_void_p]
    for which, (kernel, _, _) in enumerate(RING_ATTRIBUTE_KERNELS):
        attrs = (ctypes.c_int * 4)()
        err = lib.sfm_ring_attributes(which, attrs)
        line = json.dumps({"root": label, "kernel": kernel, "error": err,
                           "blocks_per_sm": attrs[0], "registers": attrs[1],
                           "static_shared_bytes": attrs[2],
                           "local_bytes": attrs[3], "card": card})
        print(line, flush=True)
        sink.append(line)
    names = RING_COUNTERS + ("law evaluations", "pairs within the cutoff")
    out = (ctypes.c_ulonglong * (len(RING_COUNTERS) + len(COUNTERS)))()
    dev = torch.device("cuda", 0)
    for name, fn, _, _ in ring_cases(dev, with_work=False):
        if ("powerlaw" in name or "helbing" in name or "2b" in name
                or not kept(name)):
            continue
        torch.cuda.synchronize()
        if lib.sfm_ring_counters_reset() != 0:
            raise RuntimeError("cannot reset the ring counters")
        fn()
        torch.cuda.synchronize()
        if lib.sfm_ring_counters_read(out) != 0:
            raise RuntimeError("cannot read the ring counters")
        vals = list(out)
        got = dict(zip(RING_COUNTERS, vals))
        got["law evaluations"] = vals[len(RING_COUNTERS) + 2]
        got["pairs within the cutoff"] = vals[len(RING_COUNTERS) + 3]
        steps = max(got["block-steps"], 1)
        row = {"root": label, "case": name,
               "counters": {k: got[k] for k in names},
               "per_block_step": {k: got[k] / steps for k in names
                                  if k != "block-steps"},
               "card": card}
        line = json.dumps(row)
        print(line, flush=True)
        sink.append(line)
        if trace_out is not None and "x 250" in name and "m" not in name[-4:]:
            ring_trace(lib, name, trace_out, sink)


def ring_trace(lib, name, out, sink):
    """The debug build's step trace of the batched ring's own body after a
    launch (a build without it has no ``sfm_ring_trace_read``): per block
    its SM and each step's stamps, written to ``out``; printed: by ring
    step k, the mean microseconds of a step's wait, of its forward and
    staging and of its walk, and the share of blocks whose wait exceeded
    a tenth of the walk (one JSON line a case appended to ``out``)."""
    import ctypes
    if not hasattr(lib, "sfm_ring_trace_read"):
        return
    n = RING_TRACE_BLOCKS * RING_TRACE_STEPS * 4
    stamps = (ctypes.c_ulonglong * n)()
    smid = (ctypes.c_int * RING_TRACE_BLOCKS)()
    lib.sfm_ring_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    if lib.sfm_ring_trace_read(stamps, smid) != 0:
        raise RuntimeError("cannot read the ring trace")
    blocks = []
    for blk in range(RING_TRACE_BLOCKS):
        steps = [list(stamps[(blk * RING_TRACE_STEPS + k) * 4:
                             (blk * RING_TRACE_STEPS + k) * 4 + 4])
                 for k in range(RING_TRACE_STEPS)]
        steps = [st for st in steps if st[0] and st[3]]
        if steps:
            blocks.append({"block": blk, "sm": smid[blk], "steps": steps})
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        f.write(json.dumps({"case": name, "blocks": blocks}) + "\n")
    by_k = {}
    for b in blocks:
        for i, (t0, t1, t2, t3) in enumerate(b["steps"]):
            by_k.setdefault(i, []).append((t1 - t0, t2 - t1, t3 - t2))
    for i, v in sorted(by_k.items()):
        line = json.dumps({"case": name, "trace step": i, "blocks": len(v),
                           "wait_us": sum(a for a, _, _ in v) / len(v) / 1e3,
                           "stage_us": sum(b for _, b, _ in v) / len(v) / 1e3,
                           "walk_us": sum(c for _, _, c in v) / len(v) / 1e3,
                           "waiting_share": sum(a > c / 10 for a, _, c in v)
                           / len(v)})
        print(line, flush=True)
        sink.append(line)


def batched_env_cases(dev):
    """(name, call, kernel name filter, reps) of the batched environment
    walks on one shared set (``env_force_batched_kernel``) at phase 31's
    shape: 256 crowds of 1,000 over config #3's N = 10,000 geometry (its
    borders sampled and analytic, its parked cars), dense and on the
    survivor tables."""
    import dataclasses
    import numpy as np
    import torch
    import batch_cases as bc
    from carla_social_force_model_tpu_torch.api.synthetic import (
        batched_crowds, benchmark_bundle)
    from carla_social_force_model_tpu_torch.models import stepper
    from carla_social_force_model_tpu_torch.models.state import PedState
    cs = smoke()
    scene, params, cfg, _ = benchmark_bundle(
        cs.ENV_GEOM_N, with_borders=True, with_obstacles=True,
        num_steps_hint=8, device=dev)
    scene = stepper.prepare_scene(scene, analytic=True)
    ens = dataclasses.replace(scene, spawn=batched_crowds(
        cs.BATCH, cs.BATCH_N, extent=cs.ENV_CROWD_EXTENT, seed=32,
        device=dev))
    st, _ = stepper.rollout(PedState.empty(cs.BATCH_N, device=dev,
                                           batch=cs.BATCH),
                            ens, params, cfg, 1, record=False)
    dead = torch.from_numpy(np.random.default_rng(32).uniform(
        size=(cs.BATCH, cs.BATCH_N)) < 0.1).to(dev)
    planes = bc.sorted_rows(dataclasses.replace(st, alive=st.alive & ~dead))
    border = (params.border.a, params.border.b)
    jobs = (("env_exp", "borders", scene.borders_seg, border, None),
            ("env_exp", "borders", scene.borders_seg, border, 0),
            ("env_moussaid", "cars", scene.static_obstacles_seg,
             (scene.static_obstacle_vel, params.static_obstacle), None),
            ("env_moussaid", "cars", scene.static_obstacles_seg,
             (scene.static_obstacle_vel, params.static_obstacle), 0),
            ("env_exp_analytic", "analytic borders", scene.borders_geom,
             border, None),
            ("env_exp_analytic", "analytic borders", scene.borders_geom,
             border, cs.ENV_ANALYTIC_MAX_SURV))
    out = []
    for kernel, what, seg, args, width in jobs:
        grid = (None if width is None
                else bc.env_grid_of(planes, seg, None, width))
        out.append((f"{bc.env_batched_name(kernel, grid)} ({what}) "
                    f"{cs.BATCH} x {cs.BATCH_N}",
                    lambda k=kernel, s=seg, a=args, g=grid: bc.env_batch_run(
                        k, planes, s, a, None, grid=g),
                    "env_force_batched_kernel", 20))
    return out


def statics_cases(dev):
    """(name, call, kernel name filter, reps) of the chunk scan at the
    Town02 crowd's shape (phase 21), then :func:`feed_cases`."""
    from carla_social_force_model_tpu_torch.models import stepper
    from carla_social_force_model_tpu_torch.ops import geometry, statics
    cs = smoke()
    sim, _ = cs.town_crowd(dev)
    b = sim.bundle
    scene = stepper.prepare_scene(b.scene, chunked=True)
    later, _ = stepper.make_rollout_fn(scene, b.params, b.cfg, 10,
                                       record=False)(b.initial_state)
    fx, fy = (a.contiguous() for a in geometry.staged_chunk_planes(
        scene.borders_chunked))
    px, py = later.pos_x, later.pos_y
    return [(f"chunk_argmin Town02 {fx.shape[0]} x {fx.shape[1]} N="
             f"{px.shape[0]}", lambda: statics.chunk_argmin(px, py, fx, fy),
             "chunk_argmin_kernel", 20)] + feed_cases(dev)


def feed_cases(dev):
    """(name, call, kernel name filter, reps, work) of the wall-feed
    kernels (phase 18): the chunk top-k and chunk_closest over config #3's
    parked cars (chunk_closest also with a neighbour distance of 0, where
    few chunks are hit and its time is mostly its stores), and the segment
    top-k over the border features of config #3, the urban path (both N =
    10,000) and config #2 (N = 50,000); k = 3, the alive rows' boxes.
    ``work()`` gives the case's bound (``chip_smoke.feed_work``) and its
    census label and units (scanned points, or feature pairs of the
    segment top-k)."""
    from orca_cases import NEIGHBOR_DIST, feed_call, feed_scene
    feed_work = smoke().feed_work

    def case(name, kind, planes, src, k, nd=NEIGHBOR_DIST):
        def work():
            bnd = feed_work(kind, planes, src, k, nd)
            return bnd[:2], kind, bnd[2] if kind == "seg_topk" else bnd[4]
        return (name, lambda: feed_call(kind, planes, src, k, neigh_dist=nd),
                f"{kind}_kernel", 20, work)

    scene3, _, planes = feed_scene(N, dev)
    cars = scene3.obstacles_feat.rest
    out = [case(f"chunk_topk config #3 cars {cars.num_chunks} N={N} k=3",
                "chunk_topk", planes, cars, 3),
           case(f"chunk_closest config #3 cars {cars.num_chunks} N={N}",
                "chunk_closest", planes, cars, 0),
           case(f"chunk_closest config #3 cars {cars.num_chunks} N={N} "
                f"neighbour distance 0 (few hits: its stores)",
                "chunk_closest", planes, cars, 0, 0.0)]
    for label, mode, n in (("config #3", "obstacles", N),
                           ("urban", "urban", N),
                           ("config #2", "borders", 50_000)):
        sc, _, pl = (scene3, None, planes) if mode == "obstacles" else \
            feed_scene(n, dev, mode=mode)
        seg = sc.borders_feat.seg
        out.append(case(f"seg_topk {label} borders F={seg.num_features} "
                        f"N={n} k=3", "seg_topk", pl, seg, 3))
    return out


def capacity_cases(dev):
    """(name, call, kernel name filter, reps): the ring at D = 4 over N =
    10,000 (one row set a block), and over twice the agents one resident
    block per 128 rows could hold at D = 4 (N = 101,376 on 132 SMs), at
    D = 4 and D = 1."""
    import torch
    import shard_cases as sc
    from carla_social_force_model_tpu_torch.models.params import (
        MoussaidParams, moussaid_vector)
    from carla_social_force_model_tpu_torch.ops import cuda_ring
    prm = moussaid_vector(MoussaidParams(), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    big = 2 * (3 * sms // 4 * 128) * 4
    pl = sc.shard_planes(big, 33, dev, n_shards=4)
    small = sc.shard_planes(N, 27, dev, n_shards=4)
    return [(f"ring_force D=4 N={N}", lambda: cuda_ring.ring_force(
        *small[:6], prm, 4), "ring_force_kernel", 20)] + [
        (f"ring_force D={d} N={big}", lambda d=d: cuda_ring.ring_force(
            *pl[:6], prm, d), "ring_force_kernel", 3) for d in (4, 1)]


def ring_capacity(dev):
    """Whether one launch of ``ring_force`` takes twice the agents per
    device that one resident block per 128 rows could hold (3 blocks an
    SM), by law, cutoff and device count D: {case: (n_local, taken)}; a
    refusal is CUDA error 720."""
    import torch
    from carla_social_force_model_tpu_torch.ops import cuda_forces, cuda_ring
    import shard_cases as sc
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}

    def takes(law, prm, n_dev, n_local, cutoff):
        n = n_dev * n_local
        pos = torch.rand((2, n), generator=gen, device=dev) * 400.0
        vel = torch.rand((2, n), generator=gen, device=dev) - 0.5
        rad = torch.full((n,), 0.3, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        hel = law == "helbing"
        try:
            cuda_ring.ring_force(
                pos[0], pos[1], vel[0], vel[1], None if hel else rad, alive,
                prm, n_dev, law=law, desired=(vel[0], vel[1]) if hel
                else None, cutoff=cutoff)
        except RuntimeError as e:
            if "CUDA error 720" not in str(e):
                raise
            return False
        torch.cuda.synchronize()
        return True

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for law in ("moussaid", "powerlaw", "helbing"):
        prm = cuda_forces.law_vector(law, sc.law_params(law), dev)
        for cutoff in (None, CUTOFF_M):
            for n_dev in (1, 4, 8):
                n_local = 2 * (3 * sms // n_dev * 128)
                out[f"ring_force {law} cutoff={cutoff} D={n_dev}"] = (
                    n_local, takes(law, prm, n_dev, n_local, cutoff))
    return out


def dense_errors(dev):
    """The Moussaid dense walks' and the ring's errors as phases 3, 9 and
    24 check them: {case: (max abs err, max err / limit)}, the limit
    1e-4 + 1e-4 * |f|."""
    import dataclasses
    import numpy as np
    import torch
    import shard_cases as sc
    from carla_social_force_model_tpu_torch.models.params import (
        MoussaidParams, moussaid_vector)
    from carla_social_force_model_tpu_torch.ops import (cuda_forces, forces,
                                                        pair_grid)
    cs = smoke()
    out = {}

    def held(name, got, want, lim=None):
        err = (got - want).abs()
        lim = 1e-4 + 1e-4 * want.abs() if lim is None else lim
        out[name] = (err.max().item(), (err / lim).max().item())

    planes = cs.to_planes(*cs.seeded_crowd(N, 7, float(np.sqrt(N))), dev)
    for eps, use_radius in ((0.005, False), (0.005, True), (0.0, False),
                            (0.0, True)):
        p = dataclasses.replace(MoussaidParams(), epsilon=eps)
        held(f"phase 3 dense 10k eps={eps} use_radius={use_radius}",
             torch.stack(cuda_forces.pair_force_dense(
                 *planes, moussaid_vector(p, dev), use_radius=use_radius)),
             torch.stack(forces.pedestrian_force(
                 *planes, p, use_ped_radius=use_radius)))
    p = MoussaidParams()
    prm = moussaid_vector(p, dev)
    for n in (N, 50_000):
        sp = cs.sorted_crowd(n, 11, dev)
        g = pair_grid.cutoff_grid(sp[0], sp[1], sp[5], CUTOFF_M,
                                  symmetric=False)
        for use_radius in (False, True):
            held(f"phase 9 {g.form} N={n} use_radius={use_radius}",
                 torch.stack(cuda_forces.pair_force_cutoff(
                     *sp, prm, g, use_radius=use_radius)),
                 torch.stack(forces.pedestrian_force(
                     *sp, p, use_ped_radius=use_radius, cutoff=CUTOFF_M)))
    pl = sc.shard_planes(N, 24, dev, n_shards=4, sort=True)
    got, want, lim = sc.rect_case("moussaid", pl, 4, 1, None, True)
    held(f"phase 24 dense rect {N // 4} x {N}", got, want, lim)
    pl = sc.shard_planes(N, 27, dev, n_shards=4)
    got, want, lim, _ = sc.ring_case("moussaid", pl, 4, None)
    held(f"phase 24 ring_force D=4 N={N}", got, want, lim)
    return out


def sym_errors(dev):
    """Phase 3's checks of ``pair_force_sym`` against its plain version:
    {case: (max abs err, max err / (1 + |f|))} for each epsilon and radius
    mode on config #1's seeded crowd."""
    import dataclasses
    import numpy as np
    import torch
    from carla_social_force_model_tpu_torch.models.params import (
        MoussaidParams, moussaid_vector)
    from carla_social_force_model_tpu_torch.ops import cuda_forces, forces
    cs = smoke()
    planes = cs.to_planes(*cs.seeded_crowd(N, 7, float(np.sqrt(N))), dev)
    out = {}
    for eps, use_radius in ((0.005, False), (0.005, True), (0.0, False),
                            (0.0, True)):
        p = dataclasses.replace(MoussaidParams(), epsilon=eps)
        want = torch.stack(forces.pedestrian_force(*planes, p,
                                                   use_ped_radius=use_radius))
        got = torch.stack(cuda_forces.pair_force_sym(
            *planes, moussaid_vector(p, dev), use_radius=use_radius))
        err = (got - want).abs()
        out[f"sym 10k eps={eps} use_radius={use_radius}"] = (
            err.max().item(), (err / (1.0 + want.abs())).max().item())
    return out


def env_cases(dev):
    """(name, call, kernel name filter, reps) of the environment kernel."""
    from orca_cases import feed_scene
    from carla_social_force_model_tpu_torch.api.synthetic import urban_bundle
    from carla_social_force_model_tpu_torch.models import stepper
    from carla_social_force_model_tpu_torch.models.spawn import apply_spawn
    from carla_social_force_model_tpu_torch.ops import cuda_env, env_grid
    cs = smoke()

    def table(pl, seg, max_surv):
        rows = seg.x if hasattr(seg, "x") else seg.ax
        _, group, ms = env_grid.env_gate(seg.num_segments, rows.shape[1],
                                         True, max_surv)
        return env_grid.env_grid(pl[0], pl[1], pl[5], seg,
                                 cuda_env.filter_r2(seg), group, ms)

    scene, params, _, _, _, pl, (dyn, dvel, dact) = cs.config3_env_inputs(
        dev)
    px, py, vx, vy, rad, alive = pl
    b, so = params.border, params.static_obstacle
    cars, cvel = scene.static_obstacles_seg, scene.static_obstacle_vel
    cars_grid = table(pl, cars, 0)
    ascene, _, apl = feed_scene(N, dev)
    out = [
        ("env_exp borders", lambda: cuda_env.env_exp(
            px, py, rad, alive, scene.borders_seg, b.a, b.b), 20),
        ("env_moussaid parked cars", lambda: cuda_env.env_moussaid(
            px, py, vx, vy, rad, alive, cars, cvel, so), 20),
        ("env_moussaid vehicles", lambda: cuda_env.env_moussaid(
            px, py, vx, vy, rad, alive, dyn, dvel, params.dynamic_obstacle,
            active=dact), 20),
        ("env_moussaid_compact parked cars", lambda: cuda_env.
         env_moussaid_compact(px, py, vx, vy, rad, alive, cars, cvel, so,
                              cars_grid), 20),
        ("env_exp_analytic borders", lambda: cuda_env.env_exp_analytic(
            apl[0], apl[1], apl[4], apl[5], ascene.borders_geom, b.a, b.b),
         20)]
    uscene, uparams, _, ustate = urban_bundle(N, num_steps_hint=1_000,
                                              device=dev)
    uscene = stepper.prepare_scene(uscene, analytic=True)
    upl, _ = cs.sorted_env_state(apply_spawn(ustate, uscene.spawn, 0), 21)
    ub = uparams.border
    ugrid = table(upl, uscene.borders_seg, 0)
    ageom = uscene.borders_geom
    agrid = table(upl, ageom, 4)
    out += [
        ("env_exp_compact urban borders", lambda: cuda_env.env_exp_compact(
            upl[0], upl[1], upl[4], upl[5], uscene.borders_seg, ub.a, ub.b,
            ugrid), 20),
        ("env_exp_analytic_compact urban borders", lambda: cuda_env.
         env_exp_analytic_compact(upl[0], upl[1], upl[4], upl[5], ageom,
                                  ub.a, ub.b, agrid), 20)]
    return [(name, fn, "env_force_kernel", reps) for name, fn, reps in out]


def run(cases, label, card, sink, census, clock_seconds=0.0):
    """Time each case and print its JSON line, with the median SM clock
    that ``nvidia-smi`` read (``chip_smoke.ClockSampler``) while the cases
    ran (``"sm_clock_of": "cases"``; the lines print once the last case is
    timed) or, with ``clock_seconds``, while the case ran and then that
    many seconds more with the card kept on it (``"case"``); a case with a
    ``work`` callable adds its bound and the issue floor of its units
    through the SASS census of this checkout's kernels (``census``: label
    -> census, null where the checkout lacks the kernel), which assumes a
    1.98 GHz clock, and that floor at the median clock; a ``work`` that
    also gives the pairs the walk hands the law, masked or not, adds their
    floor (``eval_floor_ms``)."""
    import contextlib
    import time
    import torch
    from sass_census import CLOCK_HZ, floor_ms
    cs = smoke()

    def median(sampler):
        mhz = sorted(r[0] for r in sampler.rows)
        return mhz[len(mhz) // 2] if mhz else None

    rows = []  # (row, the case's sampler or None)
    try:
        with cs.ClockSampler() as group:
            for name, fn, kernel, reps, *work in cases:
                with (cs.ClockSampler() if clock_seconds
                      else contextlib.nullcontext()) as clock:
                    try:
                        ms = cs.device_ms(fn, kernel, reps=reps)
                    except RuntimeError as e:  # a ring grid this checkout
                        if "CUDA error 720" not in str(e):  # cannot hold
                            raise
                        ms = None
                    # keep the card on the case while the sampler (an
                    # nvidia-smi that prints every 200 ms once started)
                    # reads its clock
                    end = time.monotonic() + clock_seconds
                    while ms is not None and time.monotonic() < end:
                        fn()
                        torch.cuda.synchronize()
                row = {"root": label, "case": name, "ms": ms,
                       "timed_by": cs.TIMED_BY[0] if ms else None}
                if work:
                    (bound_ms, bound_by), unit_of, units, *evals = work[0]()
                    c = census.get(unit_of)
                    row.update(bound_ms=bound_ms, bound_by=bound_by,
                               units=units,
                               floor_ms=floor_ms(c["per_unit"], units)
                               if c else None,
                               per_unit=c["per_unit"] if c else None)
                    if evals and evals[0] is not None:  # pairs the walk
                        row.update(evaluations=evals[0],  # hands the law
                                   eval_floor_ms=floor_ms(c["per_unit"],
                                                          evals[0])
                                   if c else None)
                rows.append((row, clock))
    finally:
        for row, clock in rows:
            mhz = median(clock if clock is not None else group)
            row.update(sm_clock_mhz=mhz,
                       sm_clock_of="case" if clock is not None else "cases")
            if row.get("floor_ms") is not None and mhz:  # the floor at the
                row["floor_ms_at_clock"] = (  # clock the card ran at
                    row["floor_ms"] * CLOCK_HZ / (1e6 * mhz))
            line = json.dumps(dict(row, card=card))
            print(line, flush=True)
            sink.append(line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--cases", default="sym,env,dense",
                    help="comma-separated groups: sym, env, dense, "
                    "statics, feed (statics without chunk_argmin), "
                    "capacity, batched, mesh, all_tiles (the batched "
                    "all-tiles walk's cases of batched and mesh alone), "
                    "sym_all (the batched symmetric walks without a "
                    "cutoff, 1b and 4-b, and 4-b's box form)")
    ap.add_argument("--only", default=None,
                    help="comma-separated substrings: time only the cases "
                    "whose name holds one of them")
    ap.add_argument("--clock-seconds", type=float, default=0.0,
                    help="keep the card on each timed case this many "
                    "seconds more and give each line the SM clock read "
                    "under its case (default: the clock read under all "
                    "the cases)")
    ap.add_argument("--counters", action="store_true",
                    help="patch counters into the checkout at --root (a "
                    "copy made for it) and print the walks' counters "
                    "instead of times")
    args = ap.parse_args()
    groups = set(args.cases.split(","))
    root = args.root.resolve()
    if args.counters:
        if root == HERE:
            print("--counters patches the sources at --root: give it a "
                  "copy of the checkout, not this one", file=sys.stderr)
            return 2
        instrument(root)
    sys.path[:0] = [str(root), str(HERE / "tests"), str(root / "tests")]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from carla_social_force_model_tpu_torch.utils import cuda_build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cuda_build.load_kernels()
    lines: list[str] = []
    if args.counters:
        walk_counters(dev, args.label, card, lines,
                      None if args.only is None else args.only.split(","),
                      None if args.out is None else args.out.with_name(
                          f"ring_trace_{args.label}.json"))
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write("".join(line + "\n" for line in lines))
        return 0
    errors = {}
    if "sym" in groups:
        errors.update(sym_errors(dev))
    if "dense" in groups:
        errors.update(dense_errors(dev))
    for case, (err, rel) in errors.items():
        lines.append(json.dumps({"root": args.label, "case": case,
                                 "max_abs_err": err, "max_rel_err": rel}))
        print(lines[-1], flush=True)
    if "capacity" in groups:
        for case, (n_local, taken) in ring_capacity(dev).items():
            lines.append(json.dumps({"root": args.label, "case": case,
                                     "n_local": n_local, "taken": taken,
                                     "card": card}))
            print(lines[-1], flush=True)
    cases = {"sym": sym_cases, "env": env_cases, "dense": dense_cases,
             "statics": statics_cases, "feed": feed_cases,
             "capacity": capacity_cases, "batched": batched_cases,
             "mesh": lambda dev: (mesh_cases(dev) + ring_cases(dev)
                                  + sym_all_cases(dev, mesh=True)),
             "all_tiles": lambda dev: all_tiles_cases(dev, square=True,
                                                      mesh=True),
             "sym_all": lambda dev: sym_all_cases(dev, square=True,
                                                  mesh=True)}
    census = {}
    if groups & {"statics", "feed", "mesh", "batched", "all_tiles",
                 "sym_all"}:
        from sass_census import census as sass
        census = sass(cuda_build.LIBRARY, root=root)
    only = None if args.only is None else args.only.split(",")
    run([c for g in ("sym", "env", "dense", "statics", "feed", "capacity",
                     "batched", "mesh", "all_tiles", "sym_all")
         if g in groups for c in cases[g](dev)
         if only is None or any(k in c[0] for k in only)], args.label, card,
        lines, census, args.clock_seconds)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            f.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
