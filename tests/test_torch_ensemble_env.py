"""PyTorch port: ensembles and sweeps on the compacted, analytic and chunked
environment paths (ROADMAP item 19b.2) against the JAX package.

The JAX package vmaps its rollout over these paths: the compacted sampled
kernels and the analytic border kernels on its Pallas path (interpret
mode, ``test_torch_ensemble.PALLAS``'s small tiles), the chunked closest
point on its jnp path (``use_pallas=False``, its default and the
scenarios' engine, the port's ``env_chunked``).  The port steps ``(B, N)``
planes, on the CPU through the plain versions of the batched kernels, with
each crowd's own survivor table (``ops/env_grid.py``) and one chunk scan
over every row's pedestrians.  Positions agree within ``POS_TOL_M`` at
every recorded step, alive masks and modes exactly; every row of a batched
rollout equals the port's unbatched rollout of that crowd bitwise.  The
card-only cases (the batched kernels themselves) are in
``tests/test_torch_cuda.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ensemble import (PALLAS, assert_records_close, fields_of,
                                 port_of)
from carla_social_force_model_tpu.api import scenario as jax_scenario
from carla_social_force_model_tpu.api import synthetic as jax_synthetic
from carla_social_force_model_tpu.env import borders as jax_borders
from carla_social_force_model_tpu.models import stepper as jax_stepper
from carla_social_force_model_tpu.models.params import (
    SfmParams as JaxSfmParams)
from carla_social_force_model_tpu.parallel import sweeps as jax_sweeps
from carla_social_force_model_tpu_torch.api import scenario
from carla_social_force_model_tpu_torch.api import synthetic
from carla_social_force_model_tpu_torch.env import borders
from carla_social_force_model_tpu_torch.env import pointsets
from carla_social_force_model_tpu_torch.models import stepper
from carla_social_force_model_tpu_torch.models.params import (
    SfmParams, param_batch, section_rows)
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.models.vehicles import (
    ellipse_template, snapshot_pointset, vehicle_snapshot_at)
from carla_social_force_model_tpu_torch.ops import (cuda_env, env_grid,
                                                    forces, geometry,
                                                    statics)
from carla_social_force_model_tpu_torch.ops.spatial import morton_order
from carla_social_force_model_tpu_torch.parallel import sweeps
from carla_social_force_model_tpu_torch.utils import convert
from scenario_cases import seeded_chunk_set, seeded_crowd_planes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
#: recorded steps of every rollout here
STEPS = 10
#: config #3's geometry at this N (benchmark_bundle: a 50 m half-width, 48
#: border sections of 256 slots and 49 parked cars of 128, each set in
#: groups of 8): enough groups for a narrow table to compact both sets
GEOM_N = 2500
#: the compacted ensemble's table width: crowds in a 6-12 m box touch at
#: most 4 groups of each set (every table fits), a crowd over the whole
#: arena 6 (its table overflows)
COMPACT_MAX_SURV = 4
CROWD_N = 10


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Tiny tensors, and the test workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stacked_crowds(extents, n=CROWD_N, seed=3):
    """A JAX ensemble schedule whose row b is a synthetic crowd in a box of
    half-width ``extents[b]`` (rows of different spread, so that some
    crowds' tables fit and others overflow)."""
    rows = [jax_synthetic.synthetic_crowd(n, extent=e, seed=seed + b)
            for b, e in enumerate(extents)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *rows)


def config3_ensemble(extents, geom_n=GEOM_N):
    """(scene, params, cfg) of a JAX ensemble in config #3's geometry at
    ``geom_n`` (borders, parked cars, vehicles) with crowds of CROWD_N."""
    scene1, params, cfg, _ = jax_synthetic.benchmark_bundle(
        geom_n, with_borders=True, with_obstacles=True,
        num_steps_hint=STEPS + 4)
    return (dataclasses.replace(scene1, spawn=stacked_crowds(extents)),
            params, cfg)


def analytic_lines():
    """A street grid of short (5 m) straight wall sections, 80 of them (two
    groups of 64 for the analytic gate, K = M = 8 segments), and two
    parked-car ellipses that do not simplify: the split keeps a sampled
    remainder (``borders_seg_rest``)."""
    lines, centers, lengths = [], [], []
    for c in np.arange(-20.0, 20.0 + 1e-6, 10.0):
        synthetic._wall_sections(lines, centers, lengths, (-20.0, c),
                                 (20.0, c), 5.0)
        synthetic._wall_sections(lines, centers, lengths, (c, -20.0),
                                 (c, 20.0), 5.0)
    for cx, cy in ((-5.0, 4.0), (6.0, -3.0)):
        lines.append(ellipse_template(2.4, 1.1, 0.1) + np.array([cx, cy]))
        centers.append(np.array([cx, cy]))
        lengths.append(8.0)
    return lines, centers, lengths


def analytic_ensemble(extents):
    lines, centers, lengths = analytic_lines()
    scene = jax_stepper.Scene(
        spawn=stacked_crowds(extents),
        borders=jax_borders.build_border_set(lines, centers, lengths))
    params = JaxSfmParams(enable_acceleration=True, enable_pedestrian=True,
                          enable_border=True, enable_space_repulsive=True)
    return scene, params, jax_stepper.StepConfig(despawn_on_arrival=False)


class GridSpy:
    """Records every survivor table ``fused_environment_terms`` builds:
    ``(sections, counts, max_surv)``."""

    def __init__(self, monkeypatch):
        self.tables = []
        real = env_grid.env_grid

        def spy(x, y, alive, seg, r2, group, max_surv):
            grid = real(x, y, alive, seg, r2, group, max_surv)
            self.tables.append((seg.num_segments, grid.counts.clone(),
                                max_surv))
            return grid

        monkeypatch.setattr(cuda_env, "env_grid", spy)

    def sections(self):
        return {s for s, _, _ in self.tables}

    def rows(self):
        """Per table, per crowd: did it fit (every block's hits within the
        width)?"""
        return [(c <= ms).all(dim=-1).tolist() for _, c, ms in self.tables]


# -- ensembles and sweeps against the JAX package ---------------------------

@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_compact_ensemble_matches_the_jax_package(case, monkeypatch):
    """make_ensemble_rollout with env_compact in config #3's geometry, the
    table narrow enough to compact the borders and the parked cars: every
    crowd's table fits, or some crowds' overflow (their blocks walk every
    section, where the JAX package falls back to its dense grid)."""
    extents = (6.0, 12.0) if case == "fits" else (6.0, 45.0)
    scene, params, cfg = config3_ensemble(extents)
    cfg = dataclasses.replace(cfg, env_compact=True,
                              env_max_surv=COMPACT_MAX_SURV, **PALLAS)
    want = jax_sweeps.make_ensemble_rollout(scene, params, cfg, STEPS,
                                            record=True)(scene)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    spy = GridSpy(monkeypatch)
    got = sweeps.make_ensemble_rollout(pscene, pparams, pcfg, STEPS,
                                       record=True)(pscene)
    assert_records_close(want, got, case)
    prepared = stepper.prepare_scene(pscene)
    assert spy.sections() == {prepared.borders_seg.num_segments,
                              prepared.static_obstacles_seg.num_segments}
    fits = [all(row) for row in zip(*spy.rows())]
    assert fits == ([True, True] if case == "fits" else [True, False])


@pytest.mark.parametrize("compact", [False, True])
def test_analytic_ensemble_matches_the_jax_package(compact, monkeypatch):
    """make_ensemble_rollout with env_analytic on walls that simplify and
    ellipses that stay sampled (the ``#rest`` job summed into its term),
    dense and with a one-group table (env_max_surv = 1)."""
    scene, params, cfg = analytic_ensemble((8.0, 15.0))
    cfg = dataclasses.replace(cfg, env_analytic=True, env_compact=compact,
                              env_max_surv=1 if compact else 0, **PALLAS)
    want = jax_sweeps.make_ensemble_rollout(scene, params, cfg, STEPS,
                                            record=True)(scene)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    prepared = stepper.prepare_scene(pscene, analytic=True)
    assert prepared.borders_geom.num_segments == 80
    assert prepared.borders_seg_rest is not None
    spy = GridSpy(monkeypatch)
    got = sweeps.make_ensemble_rollout(pscene, pparams, pcfg, STEPS,
                                       record=True)(pscene)
    assert_records_close(want, got, f"compact={compact}")
    assert spy.sections() == ({80} if compact else set())


def test_chunked_ensemble_matches_the_jax_package():
    """make_ensemble_rollout on the scenarios' engine (env_chunked) in
    config #3's geometry, vehicles included, against the JAX package's jnp
    path (use_pallas=False, its default)."""
    scene, params, cfg = config3_ensemble((10.0, 20.0), geom_n=CROWD_N)
    assert not cfg.use_pallas
    want = jax_sweeps.make_ensemble_rollout(scene, params, cfg, STEPS,
                                            record=True)(scene)
    pscene = convert.scene_from_fields(fields_of(scene), CPU)
    pcfg = convert.step_config_from_fields(fields_of(cfg), engine_path=True)
    assert pcfg.env_chunked
    statics.reset_launch_counts()
    got = sweeps.make_ensemble_rollout(
        pscene, convert.params_from_fields(fields_of(params)), pcfg, STEPS,
        record=True)(pscene)
    assert_records_close(want, got, "env_chunked")
    # the CPU runs the plain scan: no launch is counted
    assert statics.LAUNCHES["chunk_argmin_batched"] == 0


SWEEP_CASES = {
    "borders compact": dict(border_a=[0.5, 3.0, 12.0],
                            border_b=[0.1, 0.2, 0.35]),
    "perception compact": dict(
        static_obstacle_perception_threshold=[5.0, 20.0, 50.0],
        dynamic_obstacle_perception_threshold=[3.0, 12.0, 50.0],
        static_obstacle_A=[2.0, 5.0, 9.0]),
    "perception chunked": dict(
        dynamic_obstacle_perception_threshold=[3.0, 12.0, 50.0],
        border_b=[0.1, 0.2, 0.35]),
}


def sweep_case(case):
    """(JAX scene, params, cfg, port cfg, sweep) of a sweep in config #3's
    geometry at CROWD_N: env_compact with a one-slot table on the Pallas
    path, or env_chunked on the jnp path."""
    scene, params, cfg, _ = jax_synthetic.benchmark_bundle(
        CROWD_N, with_borders=True, with_obstacles=True,
        num_steps_hint=STEPS + 4)
    if case.endswith("compact"):
        cfg = dataclasses.replace(cfg, env_compact=True, env_max_surv=1,
                                  **PALLAS)
    pcfg = convert.step_config_from_fields(
        fields_of(cfg), engine_path=case.endswith("chunked"))
    return scene, params, cfg, pcfg, SWEEP_CASES[case]


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_sweep_matches_the_jax_package(case):
    """make_sweep_rollout of the border parameters and of the perception
    thresholds (the vehicles' per-row filter radii) on the compacted and
    chunked paths, at every recorded step."""
    scene, params, cfg, pcfg, kw = sweep_case(case)
    swept = jax_sweeps.batch_params(params, **dict(kw))
    want = jax_sweeps.make_sweep_rollout(scene, cfg, STEPS,
                                         record=True)(swept)
    pscene = convert.scene_from_fields(fields_of(scene), CPU)
    run = sweeps.make_sweep_rollout(pscene, pcfg, STEPS, record=True)
    got = run(convert.params_from_fields(fields_of(swept)))
    assert_records_close(want, got, case)
    own = run(sweeps.batch_params(
        convert.params_from_fields(fields_of(params)), **dict(kw)))
    assert torch.equal(own[1].pos, got[1].pos)


def test_scenario_sweep_matches_the_jax_package():
    """A sweep of border_a on a small routed scenario with walls
    (routed_town_walled.toml: A* routes, sidewalk borders) through the
    scenarios' engine, env_chunked, both packages building it from the
    same TOML."""
    path = os.path.join(REPO, "configs", "scenarios",
                        "routed_town_walled.toml")
    sfm = os.path.join(REPO, "configs", "sfm.toml")
    steps = 40
    jb = jax_scenario.build_scenario(path, sfm, steps)
    pb = scenario.build_scenario(path, sfm, steps, device=CPU)
    assert pb.cfg.env_chunked and not jb.cfg.use_pallas
    kw = dict(border_a=[0.5, 3.0, 60.0])
    want = jax_sweeps.make_sweep_rollout(jb.scene, jb.cfg, steps, record=True)(
        jax_sweeps.batch_params(jb.params, **dict(kw)))
    got = sweeps.make_sweep_rollout(pb.scene, pb.cfg, steps, record=True)(
        sweeps.batch_params(pb.params, **dict(kw)))
    assert_records_close(want, got, "routed_town_walled")
    alive = got[1].alive[0]
    assert bool(alive[-1].any()) and torch.equal(alive, got[1].alive[-1])
    apart = (got[1].pos[0] - got[1].pos[-1]).abs().amax(dim=-1)[alive]
    assert apart.max().item() > 1e-3  # the walls push the rows apart


# -- every row is the unbatched rollout -------------------------------------

def row_spawn(spawn, row):
    """Row ``row`` of a batched spawn schedule (one crowd)."""
    return dataclasses.replace(
        spawn, routes=dataclasses.replace(
            spawn.routes, **{f: getattr(spawn.routes, f)[row]
                             for f in ("wp_x", "wp_y", "crossing", "count")}),
        **{f: getattr(spawn, f)[row]
           for f in ("step", "pos_x", "pos_y", "vel_x", "vel_y", "speed",
                     "crossing_speed", "margin", "radius", "initial_mode",
                     "fwp_x", "fwp_y")})


ENSEMBLE_ROWS = {
    "compact": ("config3", (6.0, 12.0, 45.0),
                dict(env_compact=True, env_max_surv=COMPACT_MAX_SURV)),
    "compact auto": ("config3", (6.0, 45.0), dict(env_compact=True)),
    "analytic": ("analytic", (8.0, 15.0), dict(env_analytic=True)),
    "analytic compact": ("analytic", (8.0, 15.0, 4.0),
                         dict(env_analytic=True, env_compact=True,
                              env_max_surv=1)),
    "chunked": ("config3", (6.0, 45.0), dict(env_chunked=True)),
}


@pytest.mark.parametrize("case", sorted(ENSEMBLE_ROWS))
def test_ensemble_rows_equal_unbatched_rollouts(case):
    """Row b of the port's ensemble equals the port's unbatched rollout of
    crowd b, bitwise: each crowd's own table, and one chunk scan for all
    rows."""
    geometry, extents, knobs = ENSEMBLE_ROWS[case]
    scene, params, cfg = port_of(*(config3_ensemble(extents)
                                   if geometry == "config3"
                                   else analytic_ensemble(extents)))
    cfg = dataclasses.replace(cfg, **knobs)
    final, rec = sweeps.make_ensemble_rollout(scene, params, cfg, STEPS,
                                              record=True)(scene)
    for row in range(len(extents)):
        one = dataclasses.replace(scene, spawn=row_spawn(scene.spawn, row))
        f1, r1 = stepper.make_rollout_fn(one, params, cfg, STEPS)(
            PedState.empty(CROWD_N, device=CPU))
        assert torch.equal(rec.pos[row], r1.pos), (case, row)
        assert torch.equal(rec.mode[row], r1.mode)
        assert torch.equal(final.pos[row], f1.pos)
        assert torch.equal(final.alive[row], f1.alive)


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_sweep_rows_equal_unbatched_rollouts(case):
    """Row b of a sweep equals the unbatched rollout with row b's
    parameters (a swept perception threshold: row b's own filter, in the
    table and in the chunked terms)."""
    scene, params, _, pcfg, kw = sweep_case(case)
    pscene = convert.scene_from_fields(fields_of(scene), CPU)
    pparams = convert.params_from_fields(fields_of(params))
    swept = sweeps.batch_params(pparams, **dict(kw))
    final, rec = sweeps.make_sweep_rollout(pscene, pcfg, STEPS,
                                           record=True)(swept)
    b = param_batch(swept)
    rows = {s: section_rows(getattr(swept, s), b)
            for s in ("acceleration", "pedestrian", "border",
                      "static_obstacle", "dynamic_obstacle",
                      "space_repulsive")}
    for row in range(b):
        p_row = dataclasses.replace(
            pparams, max_speed_factor=swept.max_speed_factor[row].item(),
            **{s: r[row] for s, r in rows.items()})
        f1, r1 = stepper.make_rollout_fn(pscene, p_row, pcfg, STEPS)(
            PedState.empty(pscene.spawn.capacity, device=CPU))
        assert torch.equal(rec.pos[row], r1.pos), (case, row)
        assert torch.equal(final.alive[row], f1.alive)


# -- the batched pieces row by row ------------------------------------------

def sorted_batch(b, n, seed, extent):
    """``b`` seeded crowds of ``n`` (20% dead), each row in its own Hilbert
    order: ``(x, y, alive)`` ``(b, n)``."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (b, n, 2)).astype(np.float32)
    pos[1] *= 0.2                  # a tight crowd beside spread ones
    alive = torch.from_numpy(rng.uniform(size=(b, n)) < 0.8)
    x, y = (torch.from_numpy(pos[..., k].copy()) for k in (0, 1))
    perm, _ = morton_order(x, y, alive, "hilbert")
    return x.gather(-1, perm), y.gather(-1, perm), alive.gather(-1, perm)


@pytest.mark.parametrize("radii", ["shared", "per row"])
@pytest.mark.parametrize("job", ["borders", "cars", "analytic"])
def test_batched_env_grid_rows_equal_env_grid(job, radii):
    """The batched launch plan (boxes, hits, table, counts) of ``(B, n)``
    planes: row b equals ``env_grid`` of row b alone exactly, with shared
    ``(S,)`` radii or each crowd's own ``(B, S)``."""
    b, n = 4, 300
    if job == "analytic":
        scene = stepper.prepare_scene(stepper.Scene(
            spawn=synthetic.synthetic_crowd(4, device=CPU),
            borders=borders.build_border_set(*analytic_lines())),
            analytic=True)
        seg, extent, width = scene.borders_geom, 20.0, 1
    else:
        scene = stepper.prepare_scene(synthetic.benchmark_bundle(
            GEOM_N, with_borders=True, with_obstacles=True, device=CPU)[0])
        seg = (scene.borders_seg if job == "borders"
               else scene.static_obstacles_seg)
        extent, width = 50.0, 2
    if radii == "per row":
        scale = torch.tensor([0.25, 1.0, 2.0, 0.5])[:, None]
        seg = dataclasses.replace(
            seg, filter_radius=(seg.filter_radius[None, :] * scale))
    x, y, alive = sorted_batch(b, n, 7, extent)
    engage, group, ms = env_grid.env_gate(
        seg.num_segments, forces.section_slots(seg), True, width)
    assert engage
    r2 = cuda_env.filter_r2(seg)
    assert r2.shape == ((b, seg.num_segments) if radii == "per row"
                        else (seg.num_segments,))
    grid = env_grid.env_grid(x, y, alive, seg, r2, group, ms)
    blocks = -(-n // env_grid.ENV_BLOCK)
    assert grid.surv.shape == (b, blocks, ms)
    assert grid.counts.shape == (b, blocks)
    assert grid.surv.is_contiguous()
    counts = []
    for row in range(b):
        one = env_grid.env_grid(x[row], y[row], alive[row], seg,
                                r2[row] if r2.dim() == 2 else r2, group, ms)
        assert torch.equal(grid.surv[row], one.surv), row
        assert torch.equal(grid.counts[row], one.counts), row
        assert (grid.max_surv, grid.group) == (one.max_surv, one.group)
        counts.append(one.counts)
    # the crowds differ: some block overflows its row of the table while
    # another fits
    counts = torch.stack(counts)
    assert bool((counts > ms).any()) and bool((counts <= ms).any())


@pytest.mark.parametrize("b", [1, 3])
def test_batched_chunk_scan_rows_equal_each_row(b):
    """The chunk scan and the chunked closest point of ``(B, N)`` planes
    (one scan of the flattened pedestrians): row b equals the unbatched
    function on row b bitwise, and the scan equals its plain version."""
    pset = pointsets.chunked_on(seeded_chunk_set(4), CPU)
    planes = [seeded_crowd_planes(150, seed=10 + r) for r in range(b)]
    px, py = (torch.from_numpy(np.stack([p[k] for p in planes]))
              for k in (0, 1))
    fx, fy = (a.contiguous() for a in geometry.staged_chunk_planes(pset))
    dmin, idx = geometry.chunk_argmin(px, py, fx, fy)
    assert dmin.shape == idx.shape == (fx.shape[0], b, 150)
    close = geometry.closest_point_per_segment(px, py, pset)
    assert close[0].shape == (pset.num_segments, b, 150)
    for r in range(b):
        d1, i1 = geometry.chunk_argmin(px[r], py[r], fx, fy)
        assert torch.equal(dmin[:, r], d1) and torch.equal(idx[:, r], i1)
        one = geometry.closest_point_per_segment(px[r], py[r], pset)
        for got, want in zip(close, one):
            assert torch.equal(got[:, r], want)
    d2, i2 = geometry.chunk_argmin_plain(px.reshape(-1), py.reshape(-1), fx,
                                         fy)
    assert torch.equal(dmin.reshape(d2.shape), d2)
    assert torch.equal(idx.reshape(i2.shape), i2)


def test_chunked_vehicles_take_per_row_radii():
    """A swept perception threshold gives the chunked vehicle set ``(B,
    V)`` filter radii, and the chunked terms of row b use row b's."""
    scene, _, _, _ = synthetic.benchmark_bundle(
        CROWD_N, with_borders=True, with_obstacles=True, num_steps_hint=8,
        device=CPU)
    snap = vehicle_snapshot_at(scene.vehicles, 2)
    thr = torch.tensor([3.0, 12.0, 50.0])
    vset, vvel, vact = snapshot_pointset(snap, thr)
    v = snap.center.shape[0]
    assert vset.filter_radius.shape == (3, v)
    one, _, _ = snapshot_pointset(snap, 12.0)
    assert torch.equal(vset.filter_radius[1], one.filter_radius)
    x, y, alive = sorted_batch(3, 40, 5, 20.0)
    rng = np.random.default_rng(2)
    vx, vy, rad = (torch.from_numpy(rng.uniform(0.1, 1.0, (3, 40)).astype(
        np.float32)) for _ in range(3))
    p = dataclasses.replace(SfmParams().dynamic_obstacle,
                            perception_threshold=thr)
    fx, fy = forces.env_moussaid_force_chunked(x, y, vx, vy, rad, alive,
                                               vset, vvel, p, active=vact)
    rows = section_rows(p, 3)
    for r in range(3):
        ox, oy = forces.env_moussaid_force_chunked(
            x[r], y[r], vx[r], vy[r], rad[r], alive[r],
            snapshot_pointset(snap, float(thr[r]))[0], vvel, rows[r],
            active=vact)
        assert torch.equal(fx[r], ox) and torch.equal(fy[r], oy), r


#: the chunked terms in one pass against the row loop, abs + rel to |f|
#: (the environment kernels' tolerance)
ONE_PASS_TOL = 1e-5


def one_pass(monkeypatch):
    """Run a batch's chunked terms in one pass on the CPU too, as on a
    card (``forces._rows_apart``)."""
    monkeypatch.setattr(forces, "_rows_apart", lambda pos_x: False)


@pytest.mark.parametrize("case", ["borders swept", "borders shared",
                                  "vehicles swept", "parked cars"])
def test_chunked_terms_in_one_pass_match_the_row_loop(case, monkeypatch):
    """The card's form of a batch's chunked terms (one pass over (S, B, N)
    with (B, 1) parameter columns and (B, S) radii) against the CPU's row
    loop, within ONE_PASS_TOL."""
    scene, params, _, _ = synthetic.benchmark_bundle(
        CROWD_N, with_borders=True, with_obstacles=True, num_steps_hint=8,
        device=CPU)
    scene = stepper.prepare_scene(scene, chunked=True)
    x, y, alive = sorted_batch(3, 40, 7, 30.0)
    rng = np.random.default_rng(8)
    vx, vy, rad = (torch.from_numpy(rng.uniform(0.1, 1.0, (3, 40)).astype(
        np.float32)) for _ in range(3))
    snap = vehicle_snapshot_at(scene.vehicles, 2)
    thr = torch.tensor([3.0, 12.0, 50.0])
    vset, vvel, vact = snapshot_pointset(snap, thr)
    call = {
        "borders swept": lambda: forces.env_exp_force_chunked(
            x, y, rad, alive, scene.borders_chunked,
            torch.tensor([0.5, 3.0, 12.0]), torch.tensor([0.1, 0.2, 0.35]),
            use_radius=True),
        "borders shared": lambda: forces.env_exp_force_chunked(
            x, y, None, alive, scene.borders_chunked, params.border.a,
            params.border.b),
        "vehicles swept": lambda: forces.env_moussaid_force_chunked(
            x, y, vx, vy, rad, alive, vset, vvel, dataclasses.replace(
                params.dynamic_obstacle, perception_threshold=thr,
                A=torch.tensor([1.0, 4.0, 9.0])),
            use_radius=True, active=vact),
        "parked cars": lambda: forces.env_moussaid_force_chunked(
            x, y, vx, vy, rad, alive, scene.static_obstacles_chunked,
            scene.static_obstacle_vel, params.static_obstacle),
    }[case]
    assert forces._rows_apart(x)
    loop = torch.stack(call())
    one_pass(monkeypatch)
    got = torch.stack(call())
    assert bool((loop != 0).any()), case
    torch.testing.assert_close(got, loop, rtol=ONE_PASS_TOL,
                               atol=ONE_PASS_TOL)


@pytest.mark.parametrize("case", ["ensemble", "perception sweep"])
def test_chunked_rollouts_in_one_pass_match_the_jax_package(case,
                                                            monkeypatch):
    """The card's form of the chunked terms under a batch, run on the CPU:
    an env_chunked ensemble in config #3's geometry and a sweep of the
    vehicles' perception threshold and border_b against the JAX package's
    jnp path, at every recorded step."""
    one_pass(monkeypatch)
    if case == "ensemble":
        scene, params, cfg = config3_ensemble((10.0, 20.0), geom_n=CROWD_N)
        want = jax_sweeps.make_ensemble_rollout(scene, params, cfg, STEPS,
                                                record=True)(scene)
        pscene = convert.scene_from_fields(fields_of(scene), CPU)
        pcfg = convert.step_config_from_fields(fields_of(cfg),
                                               engine_path=True)
        got = sweeps.make_ensemble_rollout(
            pscene, convert.params_from_fields(fields_of(params)), pcfg,
            STEPS, record=True)(pscene)
    else:
        scene, params, cfg, pcfg, kw = sweep_case("perception chunked")
        swept = jax_sweeps.batch_params(params, **dict(kw))
        want = jax_sweeps.make_sweep_rollout(scene, cfg, STEPS,
                                             record=True)(swept)
        pscene = convert.scene_from_fields(fields_of(scene), CPU)
        got = sweeps.make_sweep_rollout(pscene, pcfg, STEPS, record=True)(
            convert.params_from_fields(fields_of(swept)))
    assert pcfg.env_chunked
    assert_records_close(want, got, f"one pass, {case}")


BATCHED_WRAPPERS = ["env_exp_compact_batched", "env_moussaid_compact_batched",
                    "env_exp_analytic_batched",
                    "env_exp_analytic_compact_batched"]


@pytest.mark.parametrize("name", BATCHED_WRAPPERS)
def test_batched_wrappers_on_the_cpu_are_the_plain_versions(name):
    """On CPU tensors the new batched wrappers run the plain batched
    version (the table changes no value) and count no launch."""
    scene, params, _, _ = synthetic.benchmark_bundle(
        GEOM_N, with_borders=True, with_obstacles=True, device=CPU)
    scene = stepper.prepare_scene(scene, analytic=True)
    x, y, alive = sorted_batch(3, 200, 9, 50.0)
    rng = np.random.default_rng(4)
    vx, vy, rad = (torch.from_numpy(rng.uniform(0.1, 1.0, (3, 200)).astype(
        np.float32)) for _ in range(3))
    seg = (scene.static_obstacles_seg if "moussaid" in name
           else scene.borders_geom if "analytic" in name
           else scene.borders_seg)
    fn = getattr(cuda_env, name)
    table = ()
    if "compact" in name:
        _, group, ms = env_grid.env_gate(seg.num_segments,
                                         forces.section_slots(seg), True, 2)
        table = (env_grid.env_grid(x, y, alive, seg, cuda_env.filter_r2(seg),
                                   group, ms),)
    cuda_env.reset_launch_counts()
    if "moussaid" in name:
        args = (scene.static_obstacle_vel, params.static_obstacle)
        got = fn(x, y, vx, vy, rad, alive, seg, *args, *table)
        want = forces.env_moussaid_force_batched(x, y, vx, vy, rad, alive,
                                                 seg, *args)
    else:
        a = torch.tensor([0.5, 3.0, 12.0])
        got = fn(x, y, rad, alive, seg, a, params.border.b, *table)
        want = forces.env_exp_force_batched(x, y, rad, alive, seg, a,
                                            params.border.b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (3, 200) and bool(got[0].abs().sum() > 0)
    assert not any(cuda_env.LAUNCHES.values())


def test_batched_checks_refuse_bad_tables_radii_and_planes():
    """The batched wrappers' checks (run before a launch on a card): a
    table of the wrong batch or row count, radii of the wrong shape; the
    batched scan takes (B, n) planes on a card only."""
    scene = stepper.prepare_scene(synthetic.benchmark_bundle(
        GEOM_N, with_borders=True, device=CPU)[0])
    seg = scene.borders_seg
    s = seg.num_segments
    x, y, alive = sorted_batch(3, 300, 1, 50.0)
    _, group, ms = env_grid.env_gate(s, forces.section_slots(seg), True, 2)
    grid = env_grid.env_grid(x, y, alive, seg, cuda_env.filter_r2(seg),
                             group, ms)
    cuda_env._check_grid(grid, 300, x.device, 3)
    with pytest.raises(ValueError, match="survivor table surv"):
        cuda_env._check_grid(grid, 300, x.device, 2)
    with pytest.raises(ValueError, match="survivor table surv"):
        cuda_env._check_grid(grid, 100, x.device, 3)
    with pytest.raises(ValueError, match="survivor table counts"):
        cuda_env._check_grid(grid._replace(counts=grid.counts[:, :1]), 300,
                             x.device, 3)
    rad = torch.zeros_like(x)
    for r2 in (torch.zeros(s + 1), torch.zeros(2, s), torch.zeros(3, s, 1)):
        with pytest.raises(ValueError, match="filter radii"):
            cuda_env._batched_args(x, y, None, None, rad, alive, seg, r2,
                                   False)
    cuda_env._batched_args(x, y, None, None, rad, alive, seg,
                           torch.zeros(3, s), False)
    fx, fy = (a.contiguous() for a in geometry.staged_chunk_planes(
        pointsets.chunked_on(seeded_chunk_set(1), CPU)))
    with pytest.raises(ValueError, match=r"\(B, n\) planes"):
        statics.chunk_argmin_batched(x[0], y[0], fx, fy)
    with pytest.raises(ValueError, match="CUDA tensors"):
        statics.chunk_argmin_batched(x, y, fx, fy)


def test_plain_environment_terms_take_the_analytic_sets_under_a_batch():
    """plain_environment_terms of a batch with the analytic geometry (the
    ``#rest`` job included) equals the plain terms of each row, and the
    fused terms on the CPU."""
    scene, params, cfg = port_of(*analytic_ensemble((8.0, 15.0)))
    scene = stepper.prepare_scene(scene, analytic=True)
    state, _ = stepper.simulation_step(
        PedState.empty(CROWD_N, device=CPU, batch=2), scene, params,
        dataclasses.replace(cfg, env_analytic=True), 0)
    got = cuda_env.plain_environment_terms(state, scene, params, None,
                                           analytic=True)
    fused = cuda_env.fused_environment_terms(state, scene, params, None,
                                             analytic=True)
    assert sorted(got) == sorted(fused) == ["border_force",
                                            "space_repulsive_force"]
    for row in range(2):
        one = dataclasses.replace(state, **{
            f.name: getattr(state, f.name)[row]
            for f in dataclasses.fields(state)})
        want = cuda_env.plain_environment_terms(one, scene, params, None,
                                                analytic=True)
        for name in got:
            assert torch.equal(got[name][0][row], want[name][0]), name
            assert torch.equal(got[name][1][row], want[name][1]), name
    for name in got:
        torch.testing.assert_close(fused[name][0], got[name][0], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("knob", ["env_compact", "env_analytic",
                                  "env_chunked"])
def test_batched_step_runs_the_environment_paths(knob, monkeypatch):
    """Under a batch, check_supported passes the compacted, analytic and
    chunked environment paths (groups and the fleet still raise,
    tests/test_torch_ensemble.py; ORCA and the per-agent columns run,
    tests/test_torch_ensemble_orca.py), and make_ensemble_rollout prepares
    the shared geometry once."""
    scene, params, cfg, _ = synthetic.benchmark_bundle(
        8, extent=10.0, with_borders=True, device=CPU)
    batched = dataclasses.replace(scene, spawn=synthetic.batched_crowds(
        2, 8, extent=10.0, device=CPU))
    cfg = dataclasses.replace(cfg, **{knob: True})
    stepper.check_supported(batched, params, cfg,
                            PedState.empty(8, device=CPU, batch=2))
    calls = []
    for name in ("segment_major", "analytic_split", "chunked_on"):
        real = getattr(stepper, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(stepper, name, counted)
    final, rec = sweeps.make_ensemble_rollout(batched, params, cfg, 4,
                                              record=True)(batched)
    assert rec.pos.shape == (2, 4, 8, 2) and torch.isfinite(rec.pos).all()
    want = {"env_compact": ["segment_major"],
            "env_analytic": ["segment_major", "analytic_split",
                             "segment_major"],
            "env_chunked": ["chunked_on"]}[knob]
    assert calls == want
