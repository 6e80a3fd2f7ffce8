"""PyTorch port: the large-N cutoff path against the JAX package.

Inputs are drawn with numpy from a seed and fed to both packages.  The tile
bookkeeping (boxes, hit matrix, survivor table, triangle) must equal the JAX
package's functions exactly; the cutoff pair force runs the JAX package's
Pallas kernels in interpret mode on the CPU, and the port's plain PyTorch
version after its own sort (on the CPU the kernel wrappers take the plain
version; the CUDA kernels are held against it on the card, in
``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from carla_social_force_model_tpu.api.synthetic import (
    benchmark_bundle as jax_benchmark_bundle)
from carla_social_force_model_tpu.models import stepper as jstepper
from carla_social_force_model_tpu.models.params import (
    MoussaidParams as JaxMoussaidParams)
from carla_social_force_model_tpu.ops import pallas_forces as jpf
from carla_social_force_model_tpu.ops import spatial as jspatial
from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.models import stepper
from carla_social_force_model_tpu_torch.models.params import MoussaidParams
from carla_social_force_model_tpu_torch.ops import (cuda_forces, forces,
                                                    pair_grid, spatial)
from carla_social_force_model_tpu_torch.utils import convert

CUTOFF = 30.0
#: the port's plain version against the JAX Pallas kernel: f32 summation
#: order (the JAX symmetric kernel's own tolerance) and the kernel's
#: polynomial atan2 and rsqrt(d2 + tiny) at the ulp level
FORCE_TOL = 2e-4
#: positions over a 10-step rollout (the stepper parity tests' bound)
POS_TOL_M = 1e-4


def fields_of(obj):
    """A JAX-package dataclass as nested dicts of numpy arrays and Python
    values (what utils/convert.py takes)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def clustered_cloud(n, n_clusters, spread, seed=21):
    """Spatially clustered agents (the JAX package's compact-grid test
    cloud, tests/test_pallas_forces.py): after the sort each row tile's
    30 m neighbourhood covers only its own cluster's column tiles, when the
    clusters lie farther apart than the cutoff."""
    rng = np.random.default_rng(seed)
    centers = np.arange(n_clusters) * spread
    cx = centers[rng.integers(0, n_clusters, n)]
    pos = np.column_stack([cx + rng.uniform(-8, 8, n),
                           rng.uniform(-8, 8, n)]).astype(np.float32)
    vel = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    return pos, vel, np.full((n,), 0.3, np.float32), rng.uniform(size=n) < 0.9


def planes_of(pos, vel, radius, alive):
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], radius,
                      alive)]


def stacked(f):
    return np.stack([f[0].numpy(), f[1].numpy()], axis=-1)


def test_tile_bboxes_equal_jax_with_empty_tiles():
    rng = np.random.default_rng(1)
    n, tile = 96, 8
    x = rng.uniform(-50, 50, n).astype(np.float32)
    y = rng.uniform(-50, 50, n).astype(np.float32)
    alive = rng.uniform(size=n) < 0.7
    alive[16:24] = False                     # an empty tile
    alive[40:48] = True
    want = np.asarray(jspatial.tile_bboxes(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(alive), tile))
    got = spatial.tile_bboxes(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(alive), tile).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[2]).all()
    # box_planes pads a ragged last tile with dead slots: the JAX layout
    # of the padded planes, transposed
    m = 90
    got = pair_grid.box_planes(torch.from_numpy(x[:m]),
                               torch.from_numpy(y[:m]),
                               torch.from_numpy(alive[:m]), tile).numpy()
    pad_alive = alive.copy()
    pad_alive[m:] = False
    want = np.asarray(jspatial.tile_bboxes(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(pad_alive), tile)).T
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_surv", [1, 5, 29])
def test_surv_table_equals_jax(max_surv):
    """Ascending survivors, -1 padding and the overflow flag, with an empty
    row and a full (overflowing) row."""
    rng = np.random.default_rng(max_surv)
    hits = rng.uniform(size=(13, 29)) < 0.2
    hits[3] = False
    hits[7] = True
    want_surv, want_fits = jspatial.surv_table(jnp.asarray(hits), max_surv)
    got_surv, got_fits = spatial.surv_table(torch.from_numpy(hits), max_surv)
    assert got_surv.dtype == torch.int32
    np.testing.assert_array_equal(got_surv.numpy(), np.asarray(want_surv))
    assert bool(got_fits) == bool(want_fits)
    _, counts = spatial.surv_counts(torch.from_numpy(hits), max_surv)
    np.testing.assert_array_equal(counts.numpy(), hits.sum(axis=1))


def test_bbox_hits_equal_jax():
    rng = np.random.default_rng(3)
    lo = rng.uniform(-100, 100, (2, 17)).astype(np.float32)
    row_bb = np.stack([lo[0], lo[0] + rng.uniform(0, 20, 17),
                       lo[1], lo[1] + rng.uniform(0, 20, 17)]).astype(
                           np.float32)
    lo = rng.uniform(-100, 100, (2, 11)).astype(np.float32)
    col_bb = np.stack([lo[0], lo[0] + rng.uniform(0, 40, 11),
                       lo[1], lo[1] + rng.uniform(0, 40, 11)]).astype(
                           np.float32)
    empty = np.array([np.inf, -np.inf, np.inf, -np.inf], np.float32)
    row_bb[:, 4] = empty
    col_bb[:, 2] = empty
    for cutoff in (7.5, 30.0):
        want = np.asarray(jpf._bbox_hits(jnp.asarray(row_bb),
                                         jnp.asarray(col_bb), cutoff))
        got = pair_grid._bbox_hits(torch.from_numpy(row_bb),
                                   torch.from_numpy(col_bb), cutoff).numpy()
        np.testing.assert_array_equal(got, want)
        assert not got[4].any() and not got[:, 2].any()
    assert got.any() and not got.all()


@pytest.mark.parametrize("rows,cols,tr,tc", [(10, 4, 8, 128), (7, 7, 128, 128),
                                             (16, 3, 32, 256),
                                             (5, 9, 128, 256)])
def test_triangle_mask_is_jax_triangle_table(rows, cols, tr, tc):
    """Each row's true columns, ascending, are the JAX package's static
    triangle table (rows past all columns: none)."""
    want = jpf._triangle_table(rows, cols, tr, tc).T
    mask = pair_grid.triangle_mask(rows, cols, tr, tc)
    got, _ = spatial.surv_table(mask, want.shape[1])
    np.testing.assert_array_equal(got.numpy(), want)
    assert pair_grid._round_up(rows * tr, tc) == jpf._round_up(rows * tr, tc)


def test_compact_gate():
    gate = pair_grid.compact_gate
    assert gate(10_000, True, True, 0) == (False, pair_grid.AUTO_MAX_SURV)
    assert gate(16_384, False, True, 0)[0] is False
    assert gate(16_385, False, True, 0) == (True, pair_grid.AUTO_MAX_SURV)
    assert gate(50_000, True, True, 0) == (True, pair_grid.AUTO_MAX_SURV)
    # an explicit width engages whenever a row has more column tiles
    assert gate(10_000, True, True, 32) == (True, 32)      # 79 tiles of 128
    assert gate(10_000, False, True, 40) == (False, 40)    # 40 tiles of 256
    assert gate(10_000, False, True, 39) == (True, 39)
    assert gate(1_000_000, True, False, 0) == (False, 0)
    assert gate(0, True, True, 4) == (False, 0)


def sorted_cloud(n=3000, n_clusters=4, spread=90.0, seed=5):
    pos, vel, radius, alive = clustered_cloud(n, n_clusters, spread, seed)
    planes = planes_of(pos, vel, radius, alive)
    perm, _ = spatial.morton_order(planes[0], planes[1], planes[5], "hilbert")
    return [t[perm] for t in planes]


@pytest.mark.parametrize("max_surv", [11, 1])
@pytest.mark.parametrize("symmetric", [False, True])
def test_cutoff_grid_covers_every_pair_within_the_cutoff(symmetric,
                                                         max_surv):
    """The launch plan of the kernels, on the CPU: every pair within the
    cutoff lies in a tile pair that the launch visits (a listed survivor,
    or a row that overflowed and walks every tile), and most tile pairs are
    skipped.  ``max_surv=1`` overflows rows."""
    x, y, _, _, _, alive = sorted_cloud()
    grid = pair_grid.cutoff_grid(x, y, alive, CUTOFF, symmetric=symmetric,
                                 compact=True, max_surv=max_surv)
    assert grid.form == ("sym_compact" if symmetric else "compact")
    col_tile = pair_grid.SYM_TILE if symmetric else pair_grid.COL_TILE
    ii, jj = np.nonzero(
        ((x[:, None] - x[None, :]) ** 2 + (y[:, None] - y[None, :]) ** 2
         <= pair_grid.cutoff_sq(CUTOFF)).numpy()
        & alive.numpy()[:, None] & alive.numpy()[None, :])
    if symmetric:
        ii, jj = ii[ii < jj], jj[ii < jj]
    rt, ct = ii // pair_grid.SYM_TILE, jj // col_tile
    surv, counts = grid.surv.numpy(), grid.counts.numpy()
    overflow = counts[rt] > grid.max_surv
    listed = (surv[rt] == ct[:, None]).any(axis=1)
    assert (listed | overflow).all()
    assert overflow.any() == (max_surv == 1)
    n_tiles = grid.boxes.shape[1]
    assert counts.max() < n_tiles and counts.mean() < 0.5 * n_tiles
    # and the dense cutoff form's boxes are those of the same tiles
    plain = pair_grid.cutoff_grid(x, y, alive, CUTOFF, symmetric=symmetric,
                                  compact=False)
    assert plain.form == ("sym_cutoff" if symmetric else "dense_cutoff")
    assert plain.surv is None
    torch.testing.assert_close(plain.boxes, grid.boxes, rtol=0, atol=0)


def jax_true_max_surv(pos, alive, tr=8, tc=128):
    """The JAX kernel's per-row survivor bound for this geometry (its own
    staging replicated, as tests/test_pallas_forces.py does)."""
    px, py = jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])
    jalive = jnp.asarray(alive)
    (spx, spy, salive), _ = jspatial.morton_sort(
        (px, py), jalive, (px, py, jalive), order="hilbert")
    n = pos.shape[0]
    zero = spx * 0
    row = jpf._stage(spx, spy, zero, zero, zero, salive, jpf._round_up(n, tr))
    col = jpf._stage(spx, spy, zero, zero, zero, salive, jpf._round_up(n, tc))
    hits = jpf._bbox_hits(jpf._bboxes(row, salive, n, tr),
                          jpf._bboxes(col, salive, n, tc), CUTOFF)
    ms = int(hits.sum(axis=1).max())
    assert ms < hits.shape[1], "the gate needs n_col_tiles > max_surv"
    return ms


@pytest.mark.parametrize("use_radius", [False, True])
@pytest.mark.parametrize("compact", ["off", "fits", "overflow"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_sorted_force_matches_jax_pallas_sorted(symmetric, compact,
                                                use_radius):
    """The port's pedestrian_force_sorted (sort, plain cutoff force,
    unsort) against pedestrian_force_pallas_sorted in interpret mode, over
    the JAX launch forms: dense or symmetric grid, compacted with a table
    that fits, one that overflows, or not at all."""
    pos, vel, radius, alive = clustered_cloud(1280, 5, 300.0)
    kw = dict(cutoff=CUTOFF, row_tile=8, col_tile=128, interpret=True,
              symmetric=symmetric, use_ped_radius=use_radius)
    if compact != "off":
        kw.update(compact=True, max_surv=(jax_true_max_surv(pos, alive)
                                          if compact == "fits" else 1))
    want = np.asarray(jpf.pedestrian_force_pallas_sorted(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(radius),
        jnp.asarray(alive), JaxMoussaidParams(), **kw))
    got = stacked(cuda_forces.pedestrian_force_sorted(
        *planes_of(pos, vel, radius, alive), MoussaidParams(), CUTOFF,
        use_ped_radius=use_radius, symmetric=symmetric, row_block=128))
    np.testing.assert_allclose(got, want, rtol=FORCE_TOL, atol=FORCE_TOL)
    assert np.all(got[~alive] == 0.0)
    assert np.abs(want).max() > 1.0


@pytest.mark.parametrize("use_radius", [False, True])
def test_cutoff_truncation_matches_float64_oracle(use_radius):
    """Against tests/oracle.py's per-pair Moussaid term with the pairs
    beyond the cutoff removed (float64): 1e-4 + 1e-4*|f|, the f32 rounding
    of the sum, on a crowd where the cutoff removes most pairs."""
    rng = np.random.default_rng(11)
    n, cutoff = 150, 6.0
    pos = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, n).astype(np.float32)
    alive = rng.uniform(size=n) < 0.9
    p = MoussaidParams()
    want = np.zeros((n, 2))
    p64, v64, r64 = (a.astype(np.float64) for a in (pos, vel, radius))
    for i in np.nonzero(alive)[0]:
        for j in np.nonzero(alive)[0]:
            diff = p64[j] - p64[i]
            dist = float(np.linalg.norm(diff))
            if j == i or dist > cutoff:
                continue
            d = dist - (r64[i] + r64[j]) if use_radius else dist
            want[i] += oracle.moussaid_term(diff / dist, d, v64[i] - v64[j],
                                            p.lambda_, p.A, p.gamma, p.n,
                                            p.n_prime, p.epsilon)
    planes = planes_of(pos, vel, radius, alive)
    for got in (forces.pedestrian_force(*planes, p, use_ped_radius=use_radius,
                                        cutoff=cutoff),
                cuda_forces.pedestrian_force_sorted(
                    *planes, p, cutoff, use_ped_radius=use_radius)):
        got = stacked(got)
        assert np.all(np.abs(got - want) <= 1e-4 * (1 + np.abs(want)))
    full = stacked(forces.pedestrian_force(*planes, p,
                                           use_ped_radius=use_radius))
    assert np.abs(full - want).max() > 1e-3       # the cutoff truncates


def test_f32_exact_threshold():
    """A cutoff >= 110*gamma*(2*lambda*v_max+1) gives the no-cutoff result
    bitwise (every skipped pair's exponential underflows to +0); 30 m does
    not."""
    rng = np.random.default_rng(2)
    n, v_max = 96, 2.0
    p = MoussaidParams()
    thresh = 110.0 * p.gamma * (2.0 * p.lambda_ * v_max + 1.0)
    pos = rng.uniform(-600, 600, (n, 2)).astype(np.float32)
    vel = rng.uniform(-v_max, v_max, (n, 2)).astype(np.float32)
    alive = rng.uniform(size=n) < 0.9
    planes = planes_of(pos, vel, np.full(n, 0.3, np.float32), alive)
    exact = stacked(forces.pedestrian_force(*planes, p))
    at = stacked(forces.pedestrian_force(*planes, p,
                                         cutoff=float(np.ceil(thresh))))
    np.testing.assert_array_equal(at, exact)
    low = stacked(forces.pedestrian_force(*planes, p, cutoff=30.0))
    assert not np.array_equal(low, exact)


def test_sorted_path_on_the_cpu_is_the_plain_version():
    """On CPU tensors the cutoff path sorts, runs the plain version and
    unsorts: no kernel launch, the same forces as the unsorted plain
    version up to f32 summation order, and a given permutation is used."""
    pos, vel, radius, alive = clustered_cloud(400, 2, 40.0, seed=4)
    planes = planes_of(pos, vel, radius, alive)
    p = MoussaidParams()
    cuda_forces.reset_launch_counts()
    got = cuda_forces.pedestrian_force_sorted(*planes, p, CUTOFF)
    assert not any(cuda_forces.LAUNCHES.values())
    want = forces.pedestrian_force(*planes, p, cutoff=CUTOFF)
    np.testing.assert_allclose(stacked(got), stacked(want), rtol=2e-5,
                               atol=2e-5)
    order = spatial.morton_order(planes[0], planes[1], planes[5], "morton")
    given = cuda_forces.pedestrian_force_sorted(*planes, p, CUTOFF,
                                                order=order)
    again = cuda_forces.pedestrian_force_sorted(*planes, p, CUTOFF,
                                                spatial_order="morton")
    np.testing.assert_array_equal(stacked(given), stacked(again))
    with pytest.raises(ValueError, match="CUDA tensors"):
        grid = pair_grid.cutoff_grid(planes[0], planes[1], planes[5], CUTOFF)
        cuda_forces.pair_force_cutoff(*planes, torch.zeros(6), grid)


def test_plain_force_for_chosen_rows():
    """``rows`` computes only those rows, each against every column: the
    same values as the full computation."""
    pos, vel, radius, alive = clustered_cloud(300, 2, 30.0, seed=8)
    planes = planes_of(pos, vel, radius, alive)
    p = MoussaidParams()
    rows = torch.tensor([299, 0, 17, 150, 17])
    full = forces.pedestrian_force(*planes, p, cutoff=12.0, row_block=64)
    part = forces.pedestrian_force(*planes, p, cutoff=12.0, rows=rows,
                                   row_block=2)
    for f, g in zip(full, part):
        np.testing.assert_allclose(g.numpy(), f[rows].numpy(), rtol=1e-6,
                                   atol=1e-6)


def both_bundles(n, extent, cutoff, num_steps_hint=12, **jcfg):
    """(JAX scene, params, cfg, state), (port ...): config #1 (or #2 with
    ``with_borders``) from both packages' benchmark_bundle, the JAX step on
    its Pallas cutoff path in interpret mode with 8 x 128 tiles."""
    with_borders = jcfg.pop("with_borders", False)
    js, jp, jc, jst = jax_benchmark_bundle(
        n, extent=extent, use_pallas=True, with_borders=with_borders,
        num_steps_hint=num_steps_hint)
    jc = dataclasses.replace(jc, pallas_interpret=True, pallas_row_tile=8,
                             pallas_col_tile=128, interaction_cutoff=cutoff,
                             **jcfg)
    ps, pp, _, pst = benchmark_bundle(n, extent=extent,
                                      with_borders=with_borders,
                                      num_steps_hint=num_steps_hint,
                                      device="cpu")
    pc = convert.step_config_from_fields(fields_of(jc))
    assert pc.interaction_cutoff == cutoff
    return (js, jp, jc, jst), (ps, pp, pc, pst)


def assert_records_match(jrec, prec):
    np.testing.assert_array_equal(prec.alive.numpy(), np.asarray(jrec.alive))
    np.testing.assert_array_equal(prec.mode.numpy(), np.asarray(jrec.mode))
    err = np.abs(prec.pos.numpy() - np.asarray(jrec.pos)).max(axis=(1, 2))
    assert err.max() <= POS_TOL_M, f"per-step position error {err}"


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_cutoff_rollout_matches_jax_step_by_step(symmetric, compact):
    """Config #1 at N = 256 in a 50 m square with a 4 m cutoff (tile pairs
    skip, and the cutoff truncates forces that matter): ten steps of the
    port against the JAX Pallas cutoff path, step by step.  ``compact``
    engages the JAX survivor table (max_surv 1 of 2 column tiles)."""
    jcfg = dict(pallas_symmetric=symmetric, pallas_compact=compact,
                pallas_max_surv=1 if compact else 0)
    (js, jp, jc, jst), (ps, pp, pc, pst) = both_bundles(256, 25.0, 4.0,
                                                        **jcfg)
    assert (pc.symmetric_pairs, pc.compact_pairs) == (symmetric, compact)
    _, jrec = jstepper.make_rollout_fn(js, jp, jc, 10)(jst)
    _, prec = stepper.make_rollout_fn(ps, pp, pc, 10)(pst)
    assert_records_match(jrec, prec)


def test_cutoff_with_borders_rollout_matches_jax():
    """Config #2 with a cutoff: the pair force and the border force share
    one Hilbert sort in the port; ten steps against the JAX step (Pallas
    cutoff pair force, jnp border force)."""
    (js, jp, jc, jst), (ps, pp, pc, pst) = both_bundles(
        64, 10.0, 3.0, with_borders=True, use_pallas_env=False)
    assert pp.enable_border
    _, jrec = jstepper.make_rollout_fn(js, jp, jc, 10)(jst)
    _, prec = stepper.make_rollout_fn(ps, pp, pc, 10)(pst)
    assert_records_match(jrec, prec)


def test_step_config_conversion_maps_the_cutoff_fields():
    jcfg = jstepper.StepConfig(dt=0.1, interaction_cutoff=12.5,
                               pallas_compact=False, pallas_max_surv=7,
                               spatial_order="morton")
    got = convert.step_config_from_fields(fields_of(jcfg))
    assert got == stepper.StepConfig(dt=0.1, interaction_cutoff=12.5,
                                     compact_pairs=False, pair_max_surv=7,
                                     spatial_order="morton")
    default = convert.step_config_from_fields(fields_of(
        jstepper.StepConfig(dt=0.1)))
    assert default == stepper.StepConfig(dt=0.1)
    assert default.compact_pairs and default.spatial_order == "hilbert"
