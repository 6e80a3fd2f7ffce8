"""PyTorch port: ensembles and sweeps with the reactive autopilot fleet
(ROADMAP item 19b.3a) against the JAX package.

Under ``jax.vmap`` every row of an ensemble or sweep carries its own
``AutopilotState``: the fleet of row b brakes for row b's walkers, so each
row's vehicles, their gap check, their ORCA discs and the outline points of
the dynamic-obstacle force are its own.  The port steps a ``(B, V)`` fleet
state beside the ``(B, N)`` pedestrians; on the CPU its per-crowd
environment forms (``cuda_env.env_moussaid_percrowd``, its compacted form,
the per-crowd chunk scan) run their plain versions row by row.

The scene is a small urban street grid (``urban_bundle`` with three roads
and nine vehicles, so that the vehicle rows make two groups of sections and
an ``env_max_surv`` of 1 engages the compacted form), with each row's
spawn schedule jittered and, in row 1, three walkers standing in the lane
of road 0's first vehicle: that row's fleet brakes where the others'
accelerate.  The JAX package runs its jnp path or its Pallas path in
interpret mode.

Tolerances.  ``autopilot_step`` on ``(B, N)`` walkers against ``jax.vmap``
of the JAX step: floats within 1e-6, flags and indices equal (the
unbatched test's rule, ``tests/test_torch_urban.py``).  Step by step from
the JAX package's own vmapped state: positions and the fleet's positions,
speeds, headings and lane offsets within ``POS_TOL_M`` (1e-4 m), modes,
alive, ``active``, ``wp_idx`` and ``overtaking`` equal.  The plain per-crowd
versions and every row of a batched rollout against the unbatched ones on
that row's own set: bitwise.  The card-only cases (the per-crowd kernels)
are in ``tests/test_torch_cuda.py``; groups and the 2-D mesh in
``tests/test_torch_ensemble_groups.py`` and
``tests/test_torch_ensemble_sharded.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batch_cases as bc
from test_torch_ensemble import PALLAS, fields_of, port_of
from test_torch_ensemble_orca import REPO, BatchFallbackRows, row_spawn
from test_torch_urban import STEP_CASES, _step_inputs
from carla_social_force_model_tpu.api import scenario as jscenario
from carla_social_force_model_tpu.api import synthetic as jsyn
from carla_social_force_model_tpu.models import autopilot as jap
from carla_social_force_model_tpu.models import spawn as jspawn
from carla_social_force_model_tpu.models import stepper as jstepper
from carla_social_force_model_tpu.models.state import PedState as JaxState
from carla_social_force_model_tpu.parallel import sweeps as jsweeps
from carla_social_force_model_tpu_torch.api import scenario as pscenario
from carla_social_force_model_tpu_torch.api import synthetic as psyn
from carla_social_force_model_tpu_torch.models import autopilot as pap
from carla_social_force_model_tpu_torch.models import stepper, vehicles
from carla_social_force_model_tpu_torch.models.params import (
    param_batch, section_rows)
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.ops import (cuda_env, env_grid,
                                                    forces, geometry)
from carla_social_force_model_tpu_torch.parallel import sweeps
from carla_social_force_model_tpu_torch.utils import convert

CPU = "cpu"
DT = 0.05
#: positions (pedestrians and vehicles), port vs JAX package [m]
POS_TOL_M = 1e-4
B, N = 2, 24
#: three roads of a 120 m grid, three vehicles a road: nine vehicles (two
#: groups of eight 128-point rows), of which the first of each road drives
#: within the tests' steps
URBAN_KW = dict(num_steps_hint=240, n_routes=4, n_roads=3, width=120.0,
                cross_spacing=60.0, vehicles_per_road=3)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Tiny tensors, and the test workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the scenes -----------------------------------------------------------------

def lane_spawns(spawn, b, seed):
    """``b`` rows of a JAX spawn schedule: every row's spawn points and
    steps jittered from a seed, and row 1's first three walkers spawned at
    once in the lane of road 0's first vehicle (x = 10..14 m, y = -2 m),
    where it brakes for them."""
    rng = np.random.default_rng(seed)
    rows = jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.asarray(a)[None],
                                  (b,) + np.shape(a)).copy(), spawn)
    n = rows.pos_x.shape[1]
    px = rows.pos_x + rng.uniform(-3.0, 3.0, (b, n)).astype(np.float32)
    py = rows.pos_y.copy()
    step = rng.integers(0, 10, (b, n)).astype(np.int32)
    if b > 1:
        px[1, :3] = (10.0, 12.0, 14.0)
        py[1, :3] = -2.0
        step[1, :3] = 0
    rows = dataclasses.replace(rows, pos_x=px, pos_y=py, step=step)
    return jax.tree_util.tree_map(jnp.asarray, rows)


def jax_urban(b=B, n=N, pallas=False, **cfg_kw):
    """A JAX ensemble of ``b`` crowds of ``n`` on the small street grid:
    ``(scene, params, cfg)``, the Pallas path in interpret mode with
    ``pallas`` (env_compact, the bundle's own knob), else the jnp path."""
    scene, params, cfg, _ = jsyn.urban_bundle(n, use_pallas=pallas,
                                              **URBAN_KW)
    if pallas:
        cfg = dataclasses.replace(cfg, **PALLAS, env_ped_tile=128)
    else:
        cfg = dataclasses.replace(cfg, env_compact=False)
    cfg = dataclasses.replace(cfg, **cfg_kw)
    return (dataclasses.replace(scene, spawn=lane_spawns(scene.spawn, b, 1)),
            params, cfg)


def jax_rows(tree, b):
    """``b`` copies of a JAX pytree along a new leading axis."""
    return jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf[None], (b,) + leaf.shape), tree)


def jax_tick(js, jp, jc, kind):
    """One tick of the JAX package's rollout body (stepper.py:711-745,
    the fleet stepped before the pedestrians; without a fleet the plain
    step) vmapped as its rollouts vmap it: ``step(state, fleet_state,
    k)``."""
    fleet = js.autopilot

    def tick(st, ap, scene, params, k):
        if fleet is None:
            return jstepper.simulation_step(st, scene, params, jc, k)[0], ap
        st = jspawn.apply_spawn(st, scene.spawn, k)
        ap = jap.autopilot_step(fleet, ap, (st.pos_x, st.pos_y),
                                (st.vel_x, st.vel_y), st.alive, k, jc.dt)
        snap = jap.autopilot_snapshot(fleet, ap)
        return jstepper.simulation_step(st, scene, params, jc, k,
                                        veh_snap=snap)[0], ap

    if kind == "ensemble":
        f = jax.jit(jax.vmap(
            lambda st, ap, spawn, k: tick(
                st, ap, dataclasses.replace(js, spawn=spawn), jp, k),
            in_axes=(0, 0, 0, None)))
        return lambda st, ap, k: f(st, ap, js.spawn, k)
    f = jax.jit(jax.vmap(lambda st, ap, p, k: tick(st, ap, js, p, k),
                         in_axes=(0, 0, 0, None)))
    return lambda st, ap, k: f(st, ap, jp, k)


def assert_fleet_close(got, want, tol=POS_TOL_M):
    """The port's (batched) fleet state against the JAX package's: flags
    and waypoint indices equal, the rest within ``tol``."""
    w = fields_of(want)
    for name in ("active", "wp_idx", "overtaking"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), w[name],
                                      err_msg=name)
    for name in ("pos", "speed", "heading", "lane_off"):
        err = np.abs(getattr(got, name).numpy() - w[name])
        assert err.max() <= tol, (name, err.max())


def fleet_step_by_step(jax_side, port_side, kind, steps, monkeypatch,
                       tol=POS_TOL_M):
    """The port's batched tick (with the fleet: ``stepper.fleet_tick``)
    from the JAX package's own vmapped state at every step: alive and
    modes equal, positions within ``tol`` (a cell whose ORCA program is
    infeasible: ``BatchFallbackRows``), the fleet state as
    :func:`assert_fleet_close`.  ``kind``: ``ensemble`` or ``sweep``.
    Returns ``(worst, alive cells seen, whether the rows' fleets
    differ)``."""
    js, jp, jc = jax_side
    ps, pp, pc = port_side
    js = jstepper.prepare_scene(js, analytic=jc.env_analytic,
                                orca=jp.enable_orca)
    ps = stepper.prepare_scene(ps, analytic=pc.env_analytic,
                               orca=pp.enable_orca, chunked=pc.env_chunked)
    b = (ps.spawn.step.shape[0] if kind == "ensemble"
         else param_batch(pp))
    step = jax_tick(js, jp, jc, kind)
    jst = jax_rows(JaxState.empty(ps.spawn.capacity), b)
    jfl = (None if js.autopilot is None
           else jax_rows(js.autopilot.initial_state(), b))
    fallback = BatchFallbackRows(monkeypatch) if pp.enable_orca else None
    worst, seen, differ = 0.0, 0, False
    for k in range(steps):
        pst = convert.ped_state_from_fields(fields_of(jst), CPU)
        if jfl is None:
            got, _ = stepper.simulation_step(pst, ps, pp, pc, k)
        else:
            pfl = convert.autopilot_state_from_fields(fields_of(jfl), CPU)
            assert pfl.batch == b
            got, gfl, _ = stepper.fleet_tick(pst, pfl, ps, pp, pc, k)
        jst, jfl = step(jst, jfl, k)
        want = fields_of(jst)
        np.testing.assert_array_equal(got.alive.numpy(), want["alive"])
        np.testing.assert_array_equal(got.mode.numpy(), want["mode"])
        skip = (False if fallback is None else fallback.check(
            (got.vel_x.numpy(), got.vel_y.numpy()),
            (want["vel_x"], want["vel_y"])))
        err = np.maximum(np.abs(got.pos_x.numpy() - want["pos_x"]),
                         np.abs(got.pos_y.numpy() - want["pos_y"]))
        worst = max(worst, float(np.where(skip, 0.0, err).max()))
        seen += int(want["alive"].sum())
        if jfl is not None:
            assert_fleet_close(gfl, jfl, tol)
            differ |= any(not torch.equal(gfl.pos[0], gfl.pos[r])
                          for r in range(1, b))
    assert worst <= tol, worst
    return worst, seen, differ


def count_forms(monkeypatch):
    """Count the calls of the per-crowd forms (their plain versions run on
    the CPU): ``{name: calls}``."""
    seen = {}
    for mod, name in ((cuda_env, "env_moussaid_percrowd"),
                      (cuda_env, "env_moussaid_compact_percrowd"),
                      (geometry, "chunk_argmin")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            if _name != "chunk_argmin" or a[2].dim() == 3:
                seen[_name] = seen.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return seen


# -- the fleet step on (B, N) walkers -----------------------------------------

@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_batched_autopilot_step_equals_jax_vmap(case):
    """``autopilot_step`` with a ``(B, V)`` fleet state on ``(B, N)``
    walkers against ``jax.vmap`` of the JAX step (floats within 1e-6, flags
    and indices equal), and every row against the port's step of that row
    alone, bitwise: the unbatched test's cases, row 1 slower and its
    walkers 0.8 m to the left, row 2 with every walker dead."""
    (pfleet, jfleet), st, walk, t_idx = _step_inputs(case)
    states = {k: np.stack([v, v, v]) for k, v in st.items()}
    states["speed"][1] *= 0.5
    pos = np.stack([walk["pos"], walk["pos"] + np.float32([0.0, 0.8]),
                    walk["pos"]])
    vel = np.stack([walk["vel"]] * 3)
    alive = np.stack([walk["alive"], walk["alive"],
                      np.zeros_like(walk["alive"])])
    pst = pap.AutopilotState(**{k: torch.from_numpy(v)
                                for k, v in states.items()})
    got = pap.autopilot_step(
        pfleet, pst, (torch.from_numpy(pos[..., 0].copy()),
                      torch.from_numpy(pos[..., 1].copy())),
        torch.from_numpy(vel), torch.from_numpy(alive), t_idx, DT)
    jst = jap.AutopilotState(**{k: jnp.asarray(v)
                                for k, v in states.items()})
    want = jax.vmap(lambda s, p, v, a: jap.autopilot_step(
        jfleet, s, p, v, a, t_idx, DT))(jst, jnp.asarray(pos),
                                         jnp.asarray(vel),
                                         jnp.asarray(alive))
    assert got.batch == 3 and got.pos.shape[:2] == (3, pfleet.num_vehicles)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    for r in range(3):
        one = pap.autopilot_step(
            pfleet, pap.AutopilotState(**{k: torch.from_numpy(v[r])
                                          for k, v in states.items()}),
            (torch.from_numpy(pos[r, :, 0].copy()),
             torch.from_numpy(pos[r, :, 1].copy())),
            torch.from_numpy(vel[r]), torch.from_numpy(alive[r]), t_idx, DT)
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(got, f.name)[r],
                               getattr(one, f.name)), (r, f.name)
    snap = pap.autopilot_snapshot(pfleet, got)
    assert snap.batch == 3 and snap.vel.shape == (3, pfleet.num_vehicles, 2)


# -- the plain per-crowd versions, row by row ----------------------------------

def fleet_snapshots(b=3, seed=5):
    """A batch of ``b`` fleets of the small street grid with every row's
    vehicles in their own places (``batch_cases.fleet_batch``):
    ``(batched snapshot, [each row's snapshot], crowd planes (B, n) x, y,
    vx, vy, radius, alive around each row's vehicles, sorted per row)``."""
    scene, _, _, _ = psyn.urban_bundle(64, device=CPU, **URBAN_KW)
    state = bc.fleet_batch(scene.autopilot, b, seed)
    snap, rows = bc.fleet_rows(scene.autopilot, state)
    return snap, rows, bc.fleet_crowd(state, 300, seed)


@pytest.mark.parametrize("threshold", ["shared", "swept"])
def test_plain_percrowd_forms_equal_each_row(threshold):
    """The per-crowd plain versions against the unbatched ones on each
    row's own set, bitwise: the segment-major Moussaid force (the plain
    version of ``env_moussaid_percrowd``), the survivor table of each
    crowd's circles (``env_moussaid_compact_percrowd``'s plan), the chunk
    scan of each crowd's own chunks and the chunked closest points and
    force (the scenarios' engine); with a swept perception threshold each
    row's own radii too."""
    from carla_social_force_model_tpu_torch.models.params import (
        MoussaidParams)
    snap, rows, planes = fleet_snapshots()
    b = len(rows)
    pt = (4.0 if threshold == "shared"
          else torch.tensor([2.0, 4.0, 9.0], dtype=torch.float32))
    p = MoussaidParams()
    px, py, vx, vy, rad, alive = planes
    job, row_jobs = bc.percrowd_jobs(snap, rows, pt)
    seg, ov, act = job
    assert seg.x.shape[0] == b and seg.num_segments == rows[0].extent.shape[0]
    got = bc.percrowd_run(planes, job, p)
    err, over, equal = bc.percrowd_mismatch(planes, job, row_jobs, p, got)
    assert err == 0.0 and over == 0 and equal
    grid = bc.percrowd_grid(planes, seg, act, 1)
    group, ms = grid.group, grid.max_surv
    compact = bc.percrowd_run(planes, job, p, grid)
    assert torch.equal(compact, got)
    assert bc.percrowd_mismatch(planes, job, row_jobs, p, compact, grid)[2]
    cset, cvel, cact = vehicles.snapshot_pointset(snap, pt)
    closest = geometry.closest_point_per_segment(px, py, cset)
    scan, scan_rows, _ = bc.percrowd_scan(planes, snap, rows)
    chunked = forces.obstacle_force_chunked(px, py, vx, vy, rad, alive, cset,
                                            cvel, p, obstacle_active=cact)
    hits = 0
    for r in range(b):
        ptr = pt if threshold == "shared" else float(pt[r])
        rseg, _, ract = row_jobs[r]
        args = [t[r].contiguous() for t in planes]
        rgrid = env_grid.env_grid(args[0], args[1], args[5], rseg,
                                  cuda_env.filter_r2(rseg, ract), group, ms)
        assert torch.equal(grid.surv[r], rgrid.surv)
        assert torch.equal(grid.counts[r], rgrid.counts)
        hits += int(rgrid.counts.sum())
        for g, w in zip(scan, scan_rows[r]):
            assert torch.equal(g[:, r], w), r
        rset, rvel, ract2 = vehicles.snapshot_pointset(rows[r], ptr)
        one_closest = geometry.closest_point_per_segment(args[0], args[1],
                                                         rset)
        for g, w in zip(closest, one_closest):
            assert torch.equal(g[:, r], w), r
        one_force = forces.obstacle_force_chunked(
            *args, rset, rvel, p, obstacle_active=ract2)
        assert torch.equal(chunked[0][r], one_force[0])
        assert torch.equal(chunked[1][r], one_force[1])
    assert hits > 0 and bool((got[0] != 0).any(dim=1).all())
    assert not torch.equal(got[0][0], got[0][1])


# -- the fleet ensemble and sweep, step by step against the JAX package --------

@pytest.mark.parametrize("path", ["jnp, dense", "pallas, env_max_surv=1"])
def test_fleet_ensemble_matches_jax_step_by_step(path, monkeypatch):
    """The fleet ensemble from the JAX package's vmapped state at every
    step: on its jnp path against the port's dense per-crowd form, and on
    its interpret-mode Pallas path with ``env_compact`` and a table of one
    slot (the vehicles' two groups of rows: the compacted per-crowd form
    runs).  Row 1's fleet brakes for its walkers, so the rows' fleets
    differ."""
    pallas = path.startswith("pallas")
    js, jp, jc = jax_urban(pallas=pallas,
                           **(dict(env_max_surv=1) if pallas else {}))
    ps, pp, pc = port_of(js, jp, jc)
    assert pc.env_compact == pallas
    seen = count_forms(monkeypatch)
    _, alive, differ = fleet_step_by_step((js, jp, jc), (ps, pp, pc),
                                          "ensemble", 6, monkeypatch)
    assert alive > 0 and differ
    form = ("env_moussaid_compact_percrowd" if pallas
            else "env_moussaid_percrowd")
    assert seen == {form: 6}, seen


def test_fleet_sweep_matches_jax_step_by_step(monkeypatch):
    """A sweep of the dynamic-obstacle force (A and the perception
    threshold: each row's own radii on its own vehicles) over three rows
    on the Pallas path with the compacted per-crowd form."""
    js, jp, jc = jax_urban(b=1, pallas=True, env_max_surv=1)
    js = dataclasses.replace(js, spawn=jax.tree_util.tree_map(
        lambda a: a[0], js.spawn))
    kw = dict(dynamic_obstacle_A=[1.0, 3.0, 6.0],
              dynamic_obstacle_perception_threshold=[2.0, 5.0, 12.0])
    swept = jsweeps.batch_params(jp, **kw)
    ps, _, pc = port_of(js, jp, jc)
    pswept = convert.params_from_fields(fields_of(swept))
    seen = count_forms(monkeypatch)
    _, alive, _ = fleet_step_by_step((js, swept, jc), (ps, pswept, pc),
                                     "sweep", 6, monkeypatch)
    assert alive > 0 and seen == {"env_moussaid_compact_percrowd": 6}


def test_urban_orca_ensemble_matches_jax_step_by_step(monkeypatch):
    """ORCA with the fleet under a batch: each crowd's walkers take
    half-planes against its own vehicles' discs (``_vehicle_constraints``
    on ``(B, V)`` snapshots) and the curbs' wall feed, stepped from the
    JAX package's vmapped state on its jnp path."""
    js, jp, jc = jax_urban()
    jp = dataclasses.replace(jp, enable_orca=True, enable_pedestrian=False)
    ps, pp, pc = port_of(js, jp, jc)
    _, alive, differ = fleet_step_by_step((js, jp, jc), (ps, pp, pc),
                                          "ensemble", 6, monkeypatch)
    assert alive > 0 and differ


def scenario_bundles(name, sfm, steps):
    """Both packages' bundles of a shipped scenario built from the same
    TOML files, on the scenarios' engine (the JAX jnp path, the port's
    ``env_chunked``)."""
    path = os.path.join(REPO, "configs", "scenarios", f"{name}.toml")
    sfm = os.path.join(REPO, "configs", sfm)
    jb = jscenario.build_scenario(path, sfm, steps)
    pb = pscenario.build_scenario(path, sfm, steps, device=CPU)
    assert pb.cfg.env_chunked and not jb.cfg.use_pallas
    return jb, pb


#: the shipped scenarios with a reactive fleet (sfm.toml), swept over the
#: pedestrian and the dynamic-obstacle force
FLEET_SCENARIOS = ("destination_vehicle", "jaywalking_reactive",
                   "overtaking", "vehicle_evasion")


@pytest.mark.parametrize("case", FLEET_SCENARIOS)
def test_fleet_scenario_sweep_matches_jax_step_by_step(case, monkeypatch):
    """The shipped scenarios that were refused under a batch for their
    fleet, swept over two rows on the scenarios' engine (the port's
    ``env_chunked``: the per-crowd chunk scan of each row's vehicles),
    stepped from the JAX package's vmapped state for 40 steps."""
    steps = 40
    jb, pb = scenario_bundles(case, "sfm.toml", steps)
    assert pb.scene.autopilot is not None
    kw = dict(pedestrian_A=[2.0, 4.5], dynamic_obstacle_A=[1.0, 4.0])
    swept = jsweeps.batch_params(jb.params, **kw)
    pswept = convert.params_from_fields(fields_of(swept))
    seen = count_forms(monkeypatch)
    _, alive, _ = fleet_step_by_step((jb.scene, swept, jb.cfg),
                                     (pb.scene, pswept, pb.cfg), "sweep",
                                     steps, monkeypatch)
    assert alive > 0
    assert seen.get("chunk_argmin", 0) > 0, seen


# -- the rollouts: records, resume, and every row the unbatched rollout --------

def test_fleet_ensemble_records_match_jax():
    """``make_ensemble_rollout`` with the fleet in both packages (the JAX
    package's jnp path): the ``(StepRecord, AutopilotRecord)`` pair, the
    fleet's ``(B, T, V)`` records carried over by
    ``convert.autopilot_record_from_fields``, within POS_TOL_M, flags
    equal."""
    steps = 10
    js, jp, jc = jax_urban()
    _, (jrec, jveh) = jsweeps.make_ensemble_rollout(js, jp, jc, steps,
                                                    record=True)(js)
    ps, pp, pc = port_of(js, jp, jc)
    final, (rec, veh) = sweeps.make_ensemble_rollout(ps, pp, pc, steps,
                                                     record=True)(ps)
    want = convert.autopilot_record_from_fields(
        jax.tree_util.tree_map(np.asarray, tuple(jveh)), CPU)
    v = ps.autopilot.num_vehicles
    assert veh.pos.shape == want.pos.shape == (B, steps, v, 2)
    assert torch.equal(veh.active, want.active)
    for name in ("pos", "speed", "heading"):
        assert (getattr(veh, name) - getattr(want, name)).abs().max() <= \
            POS_TOL_M, name
    np.testing.assert_array_equal(rec.alive.numpy(), np.asarray(jrec.alive))
    np.testing.assert_array_equal(rec.mode.numpy(), np.asarray(jrec.mode))
    assert np.abs(rec.pos.numpy() - np.asarray(jrec.pos)).max() <= POS_TOL_M
    assert not torch.equal(veh.pos[0], veh.pos[1])


@pytest.mark.parametrize("kind", ["ensemble", "ensemble env_max_surv=1",
                                  "sweep"])
def test_fleet_rows_equal_unbatched_rollouts(kind):
    """Row b of a fleet ensemble (or sweep) equals the port's unbatched
    rollout of crowd b (or with row b's parameters) bitwise, the fleet's
    record too; a batched run resumed from its returned ``(B, V)`` fleet
    state continues the record bitwise."""
    steps = 8
    js, jp, jc = jax_urban()
    scene, params, cfg = port_of(js, jp, jc)
    if kind == "ensemble env_max_surv=1":
        cfg = dataclasses.replace(cfg, env_compact=True, env_max_surv=1)
    if kind == "sweep":
        scene = dataclasses.replace(scene, spawn=row_spawn(scene.spawn, 1))
        swept = sweeps.batch_params(params, dynamic_obstacle_A=[1.0, 5.0],
                                    pedestrian_A=[2.0, 3.0])
        final, (rec, veh) = sweeps.make_sweep_rollout(
            scene, cfg, steps, record=True)(swept)
        b = 2
    else:
        final, (rec, veh) = sweeps.make_ensemble_rollout(
            scene, params, cfg, steps, record=True)(scene)
        b = scene.spawn.step.shape[0]
    n = scene.spawn.capacity
    for row in range(b):
        if kind == "sweep":
            p1 = dataclasses.replace(
                params, dynamic_obstacle=section_rows(
                    swept.dynamic_obstacle, b)[row],
                pedestrian=section_rows(swept.pedestrian, b)[row])
            one = scene
        else:
            p1 = params
            one = dataclasses.replace(scene,
                                      spawn=row_spawn(scene.spawn, row))
        f1, (r1, v1) = stepper.make_rollout_fn(one, p1, cfg, steps)(
            PedState.empty(n, device=CPU))
        assert torch.equal(rec.pos[row], r1.pos), (kind, row)
        assert torch.equal(rec.mode[row], r1.mode)
        assert torch.equal(final.alive[row], f1.alive)
        for g, w in zip(veh, v1):
            assert torch.equal(g[row], w), (kind, row)
    if kind == "ensemble":
        state = PedState.empty(n, device=CPU, batch=b)
        sc = stepper.prepare_scene(scene)
        (mid, fl), _ = stepper.rollout(state, sc, params, cfg, 4,
                                       return_autopilot_state=True)
        assert fl.batch == b
        _, (rest, vrest) = stepper.rollout(mid, sc, params, cfg, 4,
                                           start_step=4, autopilot_state=fl)
        assert torch.equal(rest.pos, rec.pos[:, 4:])
        assert torch.equal(vrest.pos, veh.pos[:, 4:])
        with pytest.raises(ValueError, match="batch"):
            stepper.rollout(mid, sc, params, cfg, 1, start_step=4,
                            autopilot_state=scene.autopilot.initial_state())
