"""PyTorch port: ensembles and parameter sweeps with an interaction cutoff
(ROADMAP item 19b.1) against the JAX package, and the batched launch plan.

The JAX package applies ``interaction_cutoff`` on its Pallas path only; its
jnp path sums every pair.  So the rollouts are held against its Pallas path
in interpret mode (the small tiles of ``tests/test_torch_ensemble.py``)
with a cutoff that truncates forces that matter, and against its jnp path
with ``EXACT_CUTOFF_M``, a cutoff above 110*gamma*(2*lambda*v_max + 1),
where the Moussaid force's truncation is exact in f32 and only the sort,
the launch plan and the unsort remain.  Positions agree within
``POS_TOL_M`` at every recorded step, alive masks and modes exactly.

On the CPU the port's batched cutoff path sorts each row along its own
Hilbert curve and runs the plain version row by row, so every row equals
the port's unbatched cutoff path on that crowd bitwise.  The batched
launch plan (boxes, hits, survivor table) of row b equals the unbatched
plan of row b exactly.  The batched cutoff kernels themselves are held on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 30).
"""
import dataclasses

import numpy as np
import pytest
import torch

from carla_social_force_model_tpu.api import synthetic as jax_synthetic
from carla_social_force_model_tpu.models.params import (
    SfmParams as JaxSfmParams)
from carla_social_force_model_tpu.parallel import sweeps as jax_sweeps
from carla_social_force_model_tpu_torch.models import stepper
from carla_social_force_model_tpu_torch.models.params import (
    MoussaidParams, PedRepulsiveParams, PowerLawParams, param_batch,
    section_rows)
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.ops import (cuda_env, cuda_forces,
                                                    pair_grid, spatial)
from carla_social_force_model_tpu_torch.ops.spatial import morton_order
from carla_social_force_model_tpu_torch.parallel import sweeps
from carla_social_force_model_tpu_torch.utils import convert
from test_torch_ensemble import (PALLAS, POS_TOL_M, assert_records_close,
                                 fields_of, jax_crowd_ensemble,
                                 jax_sweep_scene, port_of)

#: cutoffs that truncate forces that matter: against the same rollout
#: without a cutoff, positions move by 0.06 m (an 8 m crowd of 12, the
#: Moussaid law; the power law 0.04 m, Helbing 3e-4 m) and by 2.6e-3 m
#: (a 25 m crowd of 10 among config #2's borders), all above POS_TOL_M
CUTOFF_M = 3.0
GEOMETRY_CUTOFF_M = 2.0
#: f32-exact for the Moussaid law at the default parameters (110 * 0.35 *
#: (2 * 2.0 * v_max + 1) m is about 300 m at v_max = 1.7 m/s): the JAX
#: package's jnp path, which ignores the cutoff, is the reference
EXACT_CUTOFF_M = 400.0
STEPS = 12


def with_cutoff(cfg, cutoff, pallas, **kw):
    """The JAX config with ``cutoff`` and, on the Pallas path, the
    interpret-mode small tiles."""
    return dataclasses.replace(cfg, interaction_cutoff=cutoff,
                               **(PALLAS if pallas else {}), **kw)


def row_spawn(spawn, row):
    """Crowd ``row`` of a batched spawn schedule."""
    return dataclasses.replace(
        spawn, routes=dataclasses.replace(
            spawn.routes, **{f: getattr(spawn.routes, f)[row]
                             for f in ("wp_x", "wp_y", "crossing", "count")}),
        **{f: getattr(spawn, f)[row]
           for f in ("step", "pos_x", "pos_y", "vel_x", "vel_y", "speed",
                     "crossing_speed", "margin", "radius", "initial_mode",
                     "fwp_x", "fwp_y")})


# -- ensembles and sweeps against the JAX package ---------------------------

@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("geometry,b,n", [(None, 3, 12), ("config2", 2, 10),
                                          ("config3", 2, 10)])
def test_ensemble_cutoff_rollout_matches_the_jax_package(geometry, b, n,
                                                         pallas):
    """make_ensemble_rollout with a cutoff, port vs JAX package, at every
    recorded step: on the Pallas path with a truncating cutoff, on the jnp
    path with the f32-exact one."""
    scene, params, cfg = jax_crowd_ensemble(b, n, geometry)
    cutoff = (EXACT_CUTOFF_M if not pallas
              else CUTOFF_M if geometry is None else GEOMETRY_CUTOFF_M)
    cfg = with_cutoff(cfg, cutoff, pallas)
    want = jax_sweeps.make_ensemble_rollout(scene, params, cfg, STEPS,
                                            record=True)(scene)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    assert pcfg.interaction_cutoff == cutoff
    got = sweeps.make_ensemble_rollout(pscene, pparams, pcfg, STEPS,
                                       record=True)(pscene)
    assert got[0].pos_x.shape == (b, n)
    assert_records_close(want, got, f"{geometry} pallas={pallas}")


@pytest.mark.parametrize("symmetric,compact,max_surv", [
    (False, False, 0), (False, True, 1), (True, True, 1)])
def test_ensemble_cutoff_forms_match_the_jax_package(symmetric, compact,
                                                     max_surv):
    """The dense walk and a forced one-slot survivor table on both sides
    (the JAX package's ``pallas_symmetric``, ``pallas_compact`` and
    ``pallas_max_surv`` carried over): the same rollout at every step."""
    scene, params, cfg = jax_crowd_ensemble(2, 40, None)
    cfg = with_cutoff(cfg, CUTOFF_M, True, pallas_symmetric=symmetric,
                      pallas_compact=compact, pallas_max_surv=max_surv)
    want = jax_sweeps.make_ensemble_rollout(scene, params, cfg, STEPS,
                                            record=True)(scene)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    assert (pcfg.symmetric_pairs, pcfg.compact_pairs,
            pcfg.pair_max_surv) == (symmetric, compact, max_surv)
    got = sweeps.make_ensemble_rollout(pscene, pparams, pcfg, STEPS,
                                       record=True)(pscene)
    assert_records_close(want, got, f"symmetric={symmetric} "
                                    f"max_surv={max_surv}")


@pytest.mark.parametrize("pallas", [False, True])
def test_sweep_cutoff_rollout_matches_the_jax_package(pallas):
    """make_sweep_rollout of pedestrian_A with a cutoff, port vs JAX
    package, at every recorded step."""
    scene, params, cfg, kw = jax_sweep_scene("pedestrian_A")
    cfg = with_cutoff(cfg, CUTOFF_M if pallas else EXACT_CUTOFF_M, pallas)
    swept = jax_sweeps.batch_params(params, **dict(kw))
    want = jax_sweeps.make_sweep_rollout(scene, cfg, STEPS,
                                         record=True)(swept)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    got = sweeps.make_sweep_rollout(pscene, pcfg, STEPS, record=True)(
        convert.params_from_fields(fields_of(swept)))
    assert_records_close(want, got, f"sweep pallas={pallas}")
    pos = got[0].pos
    assert (pos[0] - pos[-1]).abs().max() > 1e-3  # the rows differ


@pytest.mark.parametrize("law,symmetric", [("powerlaw", True),
                                           ("powerlaw", False),
                                           ("helbing", False)])
def test_family_cutoff_ensemble_matches_the_jax_package(law, symmetric):
    """The power law (both walks) and the Helbing ellipse under a batch
    with a truncating cutoff, against the JAX package's Pallas cutoff path
    at every recorded step."""
    scene, params, cfg = jax_crowd_ensemble(3, 12, None)
    params = dataclasses.replace(
        params, enable_pedestrian=False,
        **{"enable_powerlaw" if law == "powerlaw"
           else "enable_ped_repulsive": True})
    cfg = with_cutoff(cfg, CUTOFF_M, True, pallas_symmetric=symmetric)
    want = jax_sweeps.make_ensemble_rollout(scene, params, cfg, STEPS,
                                            record=True)(scene)
    got = sweeps.make_ensemble_rollout(*port_of(scene, params, cfg), STEPS,
                                       record=True)(
        convert.scene_from_fields(fields_of(scene), "cpu"))
    assert_records_close(want, got, f"{law} symmetric={symmetric}")


# -- every row is the unbatched cutoff path ---------------------------------

@pytest.mark.parametrize("geometry", [None, "config2", "config3"])
def test_ensemble_cutoff_rows_equal_unbatched_rollouts(geometry):
    """Row b of the port's cutoff ensemble equals the port's unbatched
    cutoff rollout of crowd b bitwise (each sorts the crowd along its own
    curve; the same plain operations)."""
    b, n = 3, 12
    scene, params, cfg = port_of(*jax_crowd_ensemble(b, n, geometry))
    cfg = dataclasses.replace(cfg, interaction_cutoff=(
        CUTOFF_M if geometry is None else GEOMETRY_CUTOFF_M))
    final, rec = sweeps.make_ensemble_rollout(scene, params, cfg, STEPS,
                                              record=True)(scene)
    for row in range(b):
        f1, r1 = stepper.make_rollout_fn(
            dataclasses.replace(scene, spawn=row_spawn(scene.spawn, row)),
            params, cfg, STEPS)(PedState.empty(n, device="cpu"))
        assert torch.equal(rec.pos[row], r1.pos), row
        assert torch.equal(rec.mode[row], r1.mode)
        assert torch.equal(final.pos[row], f1.pos)


def test_sweep_cutoff_rows_equal_unbatched_rollouts():
    """Row b of a cutoff sweep of pedestrian_A equals the unbatched cutoff
    rollout with row b's parameters, bitwise."""
    scene, params, cfg, kw = jax_sweep_scene("pedestrian_A")
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    pcfg = dataclasses.replace(pcfg, interaction_cutoff=CUTOFF_M)
    swept = sweeps.batch_params(pparams, **dict(kw))
    final, rec = sweeps.make_sweep_rollout(pscene, pcfg, STEPS,
                                           record=True)(swept)
    rows = section_rows(swept.pedestrian, param_batch(swept))
    for row, p_row in enumerate(rows):
        f1, r1 = stepper.make_rollout_fn(
            pscene, dataclasses.replace(pparams, pedestrian=p_row), pcfg,
            STEPS)(PedState.empty(pscene.spawn.capacity, device="cpu"))
        assert torch.equal(rec.pos[row], r1.pos), row
        assert torch.equal(final.alive[row], f1.alive)


# -- the batched launch plan --------------------------------------------------

def sorted_batch(b, n, seed, extent):
    """``b`` seeded crowds of ``n`` (10% dead, a coincident pair), each row
    in its own Hilbert order: ``(x, y, alive)``, ``(b, n)``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-extent, extent, (b, n)).astype(
        np.float32))
    y = torch.from_numpy(rng.uniform(-extent, extent, (b, n)).astype(
        np.float32))
    alive = torch.from_numpy(rng.uniform(size=(b, n)) < 0.9)
    x[:, 1], y[:, 1] = x[:, 0], y[:, 0]
    perm, _ = morton_order(x, y, alive, "hilbert")
    return tuple(t.gather(-1, perm) for t in (x, y, alive))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("case", ["box skip", "auto table", "fits",
                                  "overflow"])
def test_batched_cutoff_grid_rows_equal_the_unbatched_grid(symmetric, case):
    """cutoff_grid of (B, n) planes: one form and width for every crowd
    (the gate from n), and row b of the boxes, table and counts equal to
    the unbatched grid of row b exactly -- below the gate, above the
    automatic gate (more than 16,384 agents a crowd), with a table wide
    enough for every row, and with one that some rows overflow."""
    b, n, extent = (2, 16_641, 129.0) if case == "auto table" else (
        3, 4_000, 100.0)
    x, y, alive = sorted_batch(b, n, seed=len(case), extent=extent)
    tile = pair_grid.SYM_TILE if symmetric else pair_grid.COL_TILE
    max_surv = {"box skip": 0, "auto table": 0, "overflow": 2}.get(case)
    if case == "fits":  # the widest row's hits, below a row of tiles
        probe = pair_grid.cutoff_grid(x, y, alive, 30.0, symmetric,
                                      max_surv=-(-n // tile) - 1)
        max_surv = int(probe.counts.max())
        assert max_surv < -(-n // tile)
    grid = pair_grid.cutoff_grid(x, y, alive, 30.0, symmetric=symmetric,
                                 compact=case != "box skip",
                                 max_surv=max_surv)
    table = case != "box skip"
    assert grid.form == {(True, False): "sym_cutoff",
                         (True, True): "sym_compact",
                         (False, False): "dense_cutoff",
                         (False, True): "compact"}[symmetric, table]
    assert grid.boxes.shape == (b, 4, -(-n // tile))
    nt = -(-n // pair_grid.SYM_TILE)
    if table:
        assert grid.surv.shape == (b, nt, grid.max_surv)
        assert grid.counts.shape == (b, nt)
        assert grid.surv.dtype == grid.counts.dtype == torch.int32
        over = bool((grid.counts > grid.max_surv).any())
        assert over if case == "overflow" else case != "fits" or not over
    for row in range(b):
        one = pair_grid.cutoff_grid(x[row], y[row], alive[row], 30.0,
                                    symmetric=symmetric, compact=table,
                                    max_surv=max_surv)
        assert (one.form, one.max_surv, one.c2) == (grid.form, grid.max_surv,
                                                   grid.c2)
        assert torch.equal(grid.boxes[row], one.boxes)
        if table:
            assert torch.equal(grid.surv[row], one.surv)
            assert torch.equal(grid.counts[row], one.counts)


def test_batched_survivor_table_and_boxes_equal_each_row():
    """spatial.surv_counts, surv_table and tile_bboxes with a leading batch
    axis, row by row, with an empty row of hits and an empty tile."""
    rng = np.random.default_rng(3)
    hits = torch.from_numpy(rng.uniform(size=(3, 5, 9)) < 0.4)
    hits[1] = False
    surv, counts = spatial.surv_counts(hits, 4)
    fits = spatial.surv_table(hits, 4)[1]
    assert bool(fits) == all(bool(spatial.surv_table(h, 4)[1]) for h in hits)
    for row in range(3):
        s1, c1 = spatial.surv_counts(hits[row], 4)
        assert torch.equal(surv[row], s1) and torch.equal(counts[row], c1)
    x, y = (torch.from_numpy(rng.uniform(-5, 5, (2, 256)).astype(
        np.float32)) for _ in range(2))
    alive = torch.ones(2, 256, dtype=torch.bool)
    alive[1, 128:] = False
    boxes = spatial.tile_bboxes(x, y, alive, 128)
    assert boxes.shape == (2, 2, 4)
    for row in range(2):
        assert torch.equal(boxes[row], spatial.tile_bboxes(
            x[row], y[row], alive[row], 128))
    assert torch.equal(boxes[1, 1], torch.tensor(
        [np.inf, -np.inf, np.inf, -np.inf]))


# -- the batched pair force with a cutoff on the CPU --------------------------

def batch_planes(b, n, seed, extent=8.0):
    """Seeded ``(b, n)`` planes x, y, vx, vy, radius, alive, ex, ey."""
    rng = np.random.default_rng(seed)
    t = lambda lo, hi: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, (b, n)).astype(np.float32))
    x, y, vx, vy = t(-extent, extent), t(-extent, extent), t(-2, 2), t(-2, 2)
    rad = t(0.2, 0.4)
    alive = torch.from_numpy(rng.uniform(size=(b, n)) < 0.85)
    ang = t(-np.pi, np.pi)
    return [x, y, vx, vy, rad, alive, torch.cos(ang), torch.sin(ang)]


LAW_PARAMS = {"moussaid": MoussaidParams, "powerlaw": PowerLawParams,
              "helbing": PedRepulsiveParams}
SWEPT_LEAF = {"moussaid": "A", "powerlaw": "k", "helbing": "v0"}


def law_args(law, planes):
    x, y, vx, vy, rad, alive, ex, ey = planes
    return ((x, y, vx, vy, None if law == "helbing" else rad, alive),
            (ex, ey) if law == "helbing" else None)


@pytest.mark.parametrize("sweep", [False, True])
@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
def test_plain_batched_force_takes_the_cutoff(law, sweep):
    """plain_batched_force with a cutoff: row b equals plain_law_force of
    row b with row b's parameters and the same cutoff, bitwise, and the
    cutoff changes the result."""
    b, n = 3, 40
    planes = batch_planes(b, n, seed=7)
    p = LAW_PARAMS[law]()
    if sweep:
        p = dataclasses.replace(p, **{SWEPT_LEAF[law]: torch.tensor(
            [0.5, 1.0, 2.0]) * getattr(p, SWEPT_LEAF[law])})
    args, desired = law_args(law, planes)
    got = cuda_forces.plain_batched_force(law, *args, p, desired=desired,
                                          cutoff=CUTOFF_M)
    full = cuda_forces.plain_batched_force(law, *args, p, desired=desired)
    assert got[0].shape == (b, n)
    assert not torch.equal(got[0], full[0])
    for row, pb in enumerate(section_rows(p, b)):
        want = cuda_forces.plain_law_force(
            law, *(None if t is None else t[row] for t in args), pb, False,
            1024, CUTOFF_M,
            None if desired is None else tuple(t[row] for t in desired))
        assert torch.equal(got[0][row], want[0]), row
        assert torch.equal(got[1][row], want[1]), row


@pytest.mark.parametrize("shared_order", [False, True])
@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
def test_batched_cutoff_force_on_the_cpu_is_the_sorted_path_per_row(
        law, shared_order):
    """pedestrian_force_batched with a cutoff on CPU tensors: each row
    sorted along its own curve (or by a given (B, N) permutation), the
    plain version, the unsort -- row b equal to pedestrian_force_sorted of
    row b bitwise; with ``plain`` the unsorted plain version; no launch."""
    b, n = 3, 48
    planes = batch_planes(b, n, seed=11)
    p = LAW_PARAMS[law]()
    args, desired = law_args(law, planes)
    order = (morton_order(planes[0], planes[1], planes[5], "hilbert")
             if shared_order else None)
    before = dict(cuda_forces.LAUNCHES)
    got = cuda_forces.pedestrian_force_batched(
        *args, p, law=law, desired=desired, cutoff=CUTOFF_M, order=order)
    plain = cuda_forces.pedestrian_force_batched(
        *args, p, law=law, desired=desired, cutoff=CUTOFF_M, plain=True)
    assert cuda_forces.LAUNCHES == before
    for row in range(b):
        want = cuda_forces.pedestrian_force_sorted(
            *(t[row] for t in planes[:6]), p, CUTOFF_M, law=law,
            desired=None if desired is None
            else tuple(t[row] for t in desired))
        assert torch.equal(got[0][row], want[0]), row
        assert torch.equal(got[1][row], want[1]), row
        ref = cuda_forces.plain_law_force(
            law, *(None if t is None else t[row] for t in args), p, False,
            1024, CUTOFF_M,
            None if desired is None else tuple(t[row] for t in desired))
        assert torch.equal(plain[0][row], ref[0])
        torch.testing.assert_close(got[0][row], ref[0], rtol=1e-4,
                                   atol=1e-4)


def test_batched_cutoff_step_sorts_once(monkeypatch):
    """One batched step with a cutoff and config #3's geometry computes
    one (B, N) Hilbert permutation, which the pair force and the batched
    environment terms share, and matches the plain versions' step."""
    scene, params, cfg = port_of(*jax_crowd_ensemble(2, 10, "config3"))
    cfg = dataclasses.replace(cfg, interaction_cutoff=GEOMETRY_CUTOFF_M)
    scene = stepper.prepare_scene(scene)
    state, _ = stepper.simulation_step(
        PedState.empty(10, device="cpu", batch=2), scene, params, cfg, 0)
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return spatial.morton_order(*args, **kwargs)

    for mod in (stepper, cuda_forces, cuda_env):
        monkeypatch.setattr(mod, "morton_order", counted)
    nxt, _ = stepper.simulation_step(state, scene, params, cfg, 1)
    assert calls == [(2, 10)]
    ref = dataclasses.replace(cfg, plain_pair_force=True,
                              plain_env_force=True)
    want, _ = stepper.simulation_step(state, scene, params, ref, 1)
    torch.testing.assert_close(nxt.pos_x, want.pos_x, rtol=0, atol=1e-5)
    torch.testing.assert_close(nxt.pos_y, want.pos_y, rtol=0, atol=1e-5)
    assert torch.equal(nxt.alive, want.alive)


def test_batched_environment_terms_take_a_shared_order():
    """fused_environment_terms of a batch with the caller's (B, N) order
    equals the terms it sorts for itself, bitwise, and so do its compacted
    and analytic forms."""
    scene, params, _ = port_of(*jax_crowd_ensemble(2, 10, "config3"))
    scene = stepper.prepare_scene(scene)
    state = PedState.empty(10, device="cpu", batch=2)
    state, _ = stepper.simulation_step(state, scene, params,
                                       stepper.StepConfig(), 0)
    snap = stepper.vehicle_snapshot_at(scene.vehicles, 1)
    order = morton_order(state.pos_x, state.pos_y, state.alive, "hilbert")
    got = cuda_env.fused_environment_terms(state, scene, params, snap,
                                           order=order)
    want = cuda_env.fused_environment_terms(state, scene, params, snap)
    assert sorted(got) == sorted(want)
    for name in got:
        assert torch.equal(got[name][0], want[name][0]), name
        assert torch.equal(got[name][1], want[name][1]), name
    scene = stepper.prepare_scene(scene, analytic=True)
    for kw in (dict(compact=True, max_surv=1), dict(analytic=True)):
        got = cuda_env.fused_environment_terms(state, scene, params, snap,
                                               order=order, **kw)
        want = cuda_env.fused_environment_terms(state, scene, params, snap,
                                                **kw)
        assert sorted(got) == sorted(want), kw
        for name in got:
            assert torch.equal(got[name][0], want[name][0]), (kw, name)
            assert torch.equal(got[name][1], want[name][1]), (kw, name)
