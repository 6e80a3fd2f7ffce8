"""PyTorch port: ensembles and parameter sweeps (BASELINE config #5) against
the JAX package.

Both packages build the same batched inputs (``batched_crowds``, spawn
schedules from spawner specs, ``batch_params``); the JAX package's are
flattened to numpy and carried into the port with ``utils/convert.py``.
The JAX package vmaps its rollout (on its jnp path and on its Pallas path
in interpret mode); the port steps ``(B, N)`` planes, on the CPU through
the plain versions of the batched kernels.  Positions agree within
``POS_TOL_M`` at every recorded step, alive masks and modes exactly.  The
card-only cases (the batched kernels themselves) are in
``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_social_force_model_tpu.api import synthetic as jax_synthetic
from carla_social_force_model_tpu.models import spawn as jax_spawn
from carla_social_force_model_tpu.models import stepper as jax_stepper
from carla_social_force_model_tpu.models.params import (
    SfmParams as JaxSfmParams)
from carla_social_force_model_tpu.parallel import sweeps as jax_sweeps
from carla_social_force_model_tpu_torch.api import synthetic
from carla_social_force_model_tpu_torch.models import gap, stepper
from carla_social_force_model_tpu_torch.models.groups import build_groups
from carla_social_force_model_tpu_torch.models.params import (
    SfmParams, as_column, law_rows, moussaid_vector, param_batch,
    section_rows)
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.ops import cuda_env, cuda_forces
from carla_social_force_model_tpu_torch.ops.spatial import morton_order
from carla_social_force_model_tpu_torch.parallel import make_mesh, sweeps
from carla_social_force_model_tpu_torch.utils import convert

#: positions, port vs JAX package, at every recorded step [m]: f32
#: summation order and last-ulp differences of the special functions,
#: amplified by a few steps of the dynamics
POS_TOL_M = 1e-4
#: the JAX package's Pallas path in interpret mode, with the small tiles
#: of its own tests (tests/test_parallel.py)
PALLAS = dict(use_pallas=True, pallas_interpret=True, pallas_row_tile=8,
              pallas_col_tile=128)


def fields_of(obj):
    """A JAX-package dataclass as nested dicts of numpy arrays and Python
    values (what utils/convert.py takes)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def port_of(scene, params, cfg):
    """The port's counterparts of a JAX scene, params and config (CPU)."""
    return (convert.scene_from_fields(fields_of(scene), "cpu"),
            convert.params_from_fields(fields_of(params)),
            convert.step_config_from_fields(fields_of(cfg)))


def assert_records_close(jax_out, port_out, label=""):
    """The JAX package's ``(final, record)`` against the port's: every
    recorded step's positions within POS_TOL_M, alive and modes equal."""
    (jf, jrec), (pf, prec) = jax_out, port_out
    assert prec.pos.shape == np.asarray(jrec.pos).shape, label
    np.testing.assert_array_equal(prec.alive.numpy(), np.asarray(jrec.alive),
                                  err_msg=label)
    np.testing.assert_array_equal(prec.mode.numpy(), np.asarray(jrec.mode),
                                  err_msg=label)
    np.testing.assert_allclose(prec.pos.numpy(), np.asarray(jrec.pos),
                               rtol=0, atol=POS_TOL_M, err_msg=label)
    np.testing.assert_allclose(pf.pos.numpy(), np.asarray(jf.pos), rtol=0,
                               atol=POS_TOL_M, err_msg=label)
    np.testing.assert_array_equal(pf.alive.numpy(), np.asarray(jf.alive),
                                  err_msg=label)


# -- batch_params, batched_crowds, the conversions --------------------------

SWEEPS = {
    "pedestrian_A": dict(pedestrian_A=[0.5, 2.0, 4.5, 12.0]),
    "lambda and tau": dict(pedestrian_lambda=[1.0, 2.0, 3.0],
                           acceleration_tau=np.array([0.3, 0.5, 0.9])),
    "borders and speed": dict(border_a=[1.0, 3.0], border_b=[0.1, 0.2],
                              max_speed_factor=[1.1, 1.5]),
    "obstacles": dict(dynamic_obstacle_perception_threshold=[10.0, 50.0],
                      space_repulsive_u0=[5.0, 10.0]),
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_batch_params_matches_the_jax_package(case):
    """Every leaf as the JAX package batches it: the swept ones, the
    broadcast ones (float32) and the static ORCA knobs left numbers."""
    kw = SWEEPS[case]
    got = sweeps.batch_params(SfmParams(), **dict(kw))
    want = fields_of(jax_sweeps.batch_params(JaxSfmParams(), **dict(kw)))
    b = len(next(iter(kw.values())))
    assert param_batch(got) == b
    for section, fields in want.items():
        if not isinstance(fields, dict):
            leaf = getattr(got, section)
            if isinstance(fields, np.ndarray):
                np.testing.assert_array_equal(leaf.numpy(), fields, section)
                assert leaf.dtype == torch.float32
            else:
                assert leaf == fields, section
            continue
        for name, value in fields.items():
            leaf = getattr(getattr(got, section), name)
            if isinstance(value, np.ndarray):
                assert leaf.shape == (b,) and leaf.dtype == torch.float32
                np.testing.assert_array_equal(leaf.numpy(), value,
                                              f"{section}.{name}")
            else:
                assert not isinstance(leaf, torch.Tensor) and leaf == value


@pytest.mark.parametrize("kw", [dict(pedestrian_A=[1.0, 2.0],
                                     border_b=[0.1, 0.2, 0.3]),
                                dict(pedestrian_A=[1.0], nonsense_x=[2.0]),
                                dict(orca_window=[8.0, 16.0]),
                                {}])
def test_batch_params_raises_as_the_jax_package(kw):
    with pytest.raises(ValueError) as jax_err:
        jax_sweeps.batch_params(JaxSfmParams(), **dict(kw))
    with pytest.raises(ValueError) as port_err:
        sweeps.batch_params(SfmParams(), **dict(kw))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("b,n,seed", [(3, 12, 0), (2, 40, 5)])
def test_batched_crowds_equal_the_jax_package(b, n, seed):
    got = synthetic.batched_crowds(b, n, extent=8.0, seed=seed, device="cpu")
    want = fields_of(jax_synthetic.batched_crowds(b, n, extent=8.0,
                                                  seed=seed))
    assert got.capacity == n and got.routes.max_waypoints == 1
    for name, value in want.items():
        if name == "routes":
            for r, rv in value.items():
                np.testing.assert_array_equal(
                    getattr(got.routes, r).numpy(), rv, r)
        elif value is None:
            assert getattr(got, name) is None
        else:
            np.testing.assert_array_equal(getattr(got, name).numpy(), value,
                                          name)


def test_batched_crowds_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        synthetic.batched_crowds(2, 4)


def test_conversions_carry_batched_params_and_schedules():
    jp = jax_sweeps.batch_params(JaxSfmParams(),
                                 pedestrian_gamma=jnp.linspace(0.2, 0.6, 3))
    pp = convert.params_from_fields(fields_of(jp))
    assert param_batch(pp) == 3
    np.testing.assert_array_equal(pp.pedestrian.gamma.numpy(),
                                  np.asarray(jp.pedestrian.gamma))
    assert pp.orca.window == 64 and not pp.enable_group
    spawn = convert.spawn_schedule_from_fields(
        fields_of(jax_synthetic.batched_crowds(3, 5)), "cpu")
    assert spawn.pos_x.shape == (3, 5) and spawn.capacity == 5
    assert spawn.routes.wp_x.shape == (3, 5, 1)


def test_batched_state_and_parameter_helpers():
    state = PedState.empty(6, device="cpu", batch=4)
    assert state.pos_x.shape == (4, 6) and state.capacity == 6
    assert state.batch == 4 and PedState.empty(6, device="cpu").batch is None
    swept = sweeps.batch_params(SfmParams(), pedestrian_A=[1.0, 2.0, 3.0])
    rows = section_rows(swept.pedestrian, 3)
    assert [r.A for r in rows] == [1.0, 2.0, 3.0]
    assert all(isinstance(r.gamma, float) for r in rows)
    assert as_column(swept.acceleration).tau.shape == (3, 1)
    assert as_column(0.5) == 0.5
    # shared params expand the cached vector with stride 0 (no copy); swept
    # ones never reach the cache (tensor leaves hash by identity)
    shared = law_rows("moussaid", SfmParams().pedestrian, 5, "cpu")
    assert shared.shape == (5, 6) and shared.stride() == (0, 1)
    assert shared.data_ptr() == moussaid_vector(SfmParams().pedestrian,
                                                "cpu").data_ptr()
    before = moussaid_vector.cache_info().currsize
    swept_rows = law_rows("moussaid", swept.pedestrian, 3, "cpu")
    assert moussaid_vector.cache_info().currsize == before
    np.testing.assert_array_equal(swept_rows[:, 1].numpy(), [1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="in a batch of 4"):
        law_rows("moussaid", swept.pedestrian, 4, "cpu")
    hel = law_rows("helbing", sweeps.batch_params(
        SfmParams(), ped_repulsive_fov_phi=[100.0, 60.0]).ped_repulsive, 2,
        "cpu")
    assert hel[0, 2].item() == law_rows("helbing", SfmParams().ped_repulsive,
                                        1, "cpu")[0, 2].item()


def test_batch_sizes_must_agree():
    scene = stepper.Scene(spawn=synthetic.batched_crowds(3, 4,
                                                         device="cpu"))
    swept = sweeps.batch_params(SfmParams(), pedestrian_A=[1.0, 2.0])
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        stepper.simulation_step(PedState.empty(4, device="cpu", batch=3),
                                scene, swept, stepper.StepConfig(), 0)
    with pytest.raises(ValueError, match=r"needs \(B, N\) state planes"):
        stepper.simulation_step(PedState.empty(4, device="cpu"), scene,
                                SfmParams(), stepper.StepConfig(), 0)


# -- the per-row pieces of the step ----------------------------------------

def seeded_rows(b, n, seed, extent=10.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (b, n, 2)).astype(np.float32)
    alive = rng.uniform(size=(b, n)) < 0.8
    pos[:, 3] = pos[:, 4]   # ties of the curve key
    return (torch.from_numpy(pos[..., 0].copy()),
            torch.from_numpy(pos[..., 1].copy()), torch.from_numpy(alive))


@pytest.mark.parametrize("order", ["hilbert", "morton"])
def test_morton_order_sorts_each_row_on_its_own(order):
    """Row b's order over its own alive span equals the order of row b
    alone (the JAX package's order under vmap)."""
    x, y, alive = seeded_rows(4, 37, 3)
    x[2] = x[2] * 100.0  # a row with another span
    perm, inv = morton_order(x, y, alive, order)
    for b in range(4):
        p1, i1 = morton_order(x[b], y[b], alive[b], order)
        assert torch.equal(perm[b], p1) and torch.equal(inv[b], i1)
    assert torch.equal(perm.gather(-1, inv),
                       torch.arange(37).expand(4, 37))


def test_gap_check_of_a_batch_equals_each_row():
    rng = np.random.default_rng(11)
    b, n, v = 3, 9, 4
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.uniform(-10, 10, shape).astype(np.float32))
    planes = (t(b, n), t(b, n), t(b, n), t(b, n),
              torch.from_numpy(rng.uniform(0.5, 2, (b, n)).astype(np.float32)),
              torch.from_numpy(rng.uniform(-0.5, 2, (b, n)).astype(
                  np.float32)))
    veh = (t(v, 2), t(v, 2) / 3, torch.full((v, 2), 2.0),
           torch.tensor([True, True, False, True]))
    got = gap.gap_ready(*planes, *veh)
    assert got.shape == (b, n)
    for r in range(b):
        assert torch.equal(got[r], gap.gap_ready(*(p[r] for p in planes),
                                                 *veh))


# -- ensembles and sweeps against the JAX package ---------------------------

def jax_crowd_ensemble(b, n, geometry):
    """(scene, params, cfg) of a JAX ensemble of synthetic crowds: none
    (tests/test_parallel.py:109-129), config #2's borders (:132-153) or
    config #3's borders, parked cars and vehicles."""
    if geometry is None:
        return (jax_stepper.Scene(spawn=jax_synthetic.batched_crowds(
                    b, n, extent=8.0)),
                JaxSfmParams(enable_acceleration=True,
                             enable_pedestrian=True),
                jax_stepper.StepConfig(despawn_on_arrival=False))
    scene1, params, cfg, _ = jax_synthetic.benchmark_bundle(
        n, with_borders=True, with_obstacles=geometry == "config3",
        num_steps_hint=16)
    return (dataclasses.replace(scene1, spawn=jax_synthetic.batched_crowds(
                b, n, extent=25.0)), params, cfg)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("geometry,b,n", [(None, 3, 12),
                                          ("config2", 2, 10),
                                          ("config3", 2, 10)])
def test_ensemble_rollout_matches_the_jax_package(geometry, b, n, pallas):
    """make_ensemble_rollout, port vs JAX package, at every recorded step:
    on the JAX package's jnp path and on its Pallas path (interpret mode,
    small tiles)."""
    scene, params, cfg = jax_crowd_ensemble(b, n, geometry)
    if pallas:
        cfg = dataclasses.replace(cfg, **PALLAS)
    steps = 12
    want = jax_sweeps.make_ensemble_rollout(scene, params, cfg, steps,
                                            record=True)(scene)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    got = sweeps.make_ensemble_rollout(pscene, pparams, pcfg, steps,
                                       record=True)(pscene)
    assert got[0].pos_x.shape == (b, n)
    assert_records_close(want, got, f"{geometry} pallas={pallas}")
    # a bare SpawnSchedule batch runs the same rollout
    bare = sweeps.make_ensemble_rollout(pscene, pparams, pcfg, steps,
                                        record=True)(pscene.spawn)
    assert torch.equal(bare[1].pos, got[1].pos)


def corridor_spawners():
    """Counterflow walkers and a multi-waypoint route across a road (the
    JAX package's corridor scene, tests/test_stepper.py): routes of
    several waypoints and the mode changes of a crossing."""
    specs = []
    for k in range(2):
        for x0, x1 in ((-10.0, 10.0), (10.0, -10.0)):
            y = -0.8 + k * 0.9
            specs.append(jax_spawn.SpawnerSpec(
                spawn_location=np.array([x0, y]),
                waypoints=np.array([[x0 + 0.25 * (x1 - x0), y + 0.3],
                                    [x1, y]]),
                crossing_road=[False, True], speed=1.2 + 0.1 * k,
                quantity=2, spawn_time=0.2 * k, spawn_interval=1.1))
    specs.append(jax_spawn.SpawnerSpec(
        spawn_location=np.array([0.5, -9.0]),
        waypoints=np.array([[0.5, -6.5], [0.5, -4.5], [0.5, 4.0],
                            [3.0, 6.0]]),
        crossing_road=[False, False, True, False], speed=1.4, quantity=2,
        spawn_time=0.0, spawn_interval=0.6))
    return specs


def jax_corridor(seed, steps):
    return jax_spawn.build_spawn_schedule(corridor_spawners(), 0.05, steps,
                                          pedestrian_seed=seed,
                                          variate_speed=0.3)


@pytest.mark.parametrize("pallas", [False, True])
def test_ensemble_of_routed_schedules_matches_the_jax_package(pallas):
    """Schedules with staggered spawns, routes of several waypoints (the
    batched waypoint advance) and road crossings against scripted
    vehicles (the batched gap check)."""
    import jax
    steps = 60
    spawn = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                   *(jax_corridor(s, steps)
                                     for s in (3, 4, 5)))
    scene = jax_stepper.Scene(
        spawn=spawn, vehicles=jax_synthetic.synthetic_vehicles(
            10.0, 2, 0.05, steps))
    params = JaxSfmParams(enable_acceleration=True, enable_pedestrian=True)
    cfg = jax_stepper.StepConfig(waypoint_threshold=1.0,
                                 **(PALLAS if pallas else {}))
    want = jax_sweeps.make_ensemble_rollout(scene, params, cfg, steps,
                                            record=True)(scene)
    got = sweeps.make_ensemble_rollout(*port_of(scene, params, cfg), steps,
                                       record=True)(
        convert.scene_from_fields(fields_of(scene), "cpu"))
    # walkers advanced to a crossing waypoint (the mode change) in every row
    crossing = (np.asarray(want[1].mode) == 2).any(axis=(1, 2))
    assert crossing.all(), crossing
    assert_records_close(want, got, f"corridor pallas={pallas}")


def jax_sweep_scene(kind):
    if kind == "pedestrian_A":
        scene, params, cfg, _ = jax_synthetic.benchmark_bundle(16,
                                                               extent=10.0)
        return scene, params, cfg, dict(pedestrian_A=[0.5, 2.0, 4.5, 12.0])
    if kind == "border_a":
        scene, params, cfg, _ = jax_synthetic.benchmark_bundle(
            10, with_borders=True)
        return scene, params, cfg, dict(border_a=[0.5, 3.0, 12.0])
    scene, params, cfg, _ = jax_synthetic.benchmark_bundle(
        10, with_borders=True, with_obstacles=True, num_steps_hint=16)
    return scene, params, cfg, dict(
        static_obstacle_A=[2.0, 9.0],
        dynamic_obstacle_perception_threshold=[5.0, 50.0])


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("kind", ["pedestrian_A", "border_a", "obstacles"])
def test_sweep_rollout_matches_the_jax_package(kind, pallas):
    """make_sweep_rollout, port vs JAX package, at every recorded step;
    the port's own batch_params gives the same rollout as the JAX
    package's params carried over."""
    scene, params, cfg, kw = jax_sweep_scene(kind)
    if pallas:
        cfg = dataclasses.replace(cfg, **PALLAS)
    steps = 12
    swept = jax_sweeps.batch_params(params, **dict(kw))
    want = jax_sweeps.make_sweep_rollout(scene, cfg, steps,
                                         record=True)(swept)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    run = sweeps.make_sweep_rollout(pscene, pcfg, steps, record=True)
    got = run(convert.params_from_fields(fields_of(swept)))
    assert_records_close(want, got, f"{kind} pallas={pallas}")
    own = run(sweeps.batch_params(pparams, **dict(kw)))
    assert torch.equal(own[1].pos, got[1].pos)
    if kind != "obstacles":
        pos = got[0].pos
        assert (pos[0] - pos[-1]).abs().max() > 1e-3  # the rows differ


# -- every row is the unbatched rollout -------------------------------------

@pytest.mark.parametrize("geometry", [None, "config2", "config3"])
def test_ensemble_rows_equal_unbatched_rollouts(geometry):
    """Row b of the port's ensemble equals the port's unbatched rollout of
    crowd b (the plain versions row by row: the same operations)."""
    b, n, steps = 3, 12, 12
    scene, params, cfg = port_of(*jax_crowd_ensemble(b, n, geometry))
    final, rec = sweeps.make_ensemble_rollout(scene, params, cfg, steps,
                                              record=True)(scene)
    for row in range(b):
        spawn = dataclasses.replace(
            scene.spawn, routes=dataclasses.replace(
                scene.spawn.routes,
                **{f: getattr(scene.spawn.routes, f)[row]
                   for f in ("wp_x", "wp_y", "crossing", "count")}),
            **{f: getattr(scene.spawn, f)[row]
               for f in ("step", "pos_x", "pos_y", "vel_x", "vel_y", "speed",
                         "crossing_speed", "margin", "radius",
                         "initial_mode", "fwp_x", "fwp_y")})
        f1, r1 = stepper.make_rollout_fn(
            dataclasses.replace(scene, spawn=spawn), params, cfg, steps)(
            PedState.empty(n, device="cpu"))
        assert torch.equal(rec.pos[row], r1.pos), row
        assert torch.equal(rec.mode[row], r1.mode)
        assert torch.equal(final.pos[row], f1.pos)


@pytest.mark.parametrize("kind", ["pedestrian_A", "border_a", "obstacles"])
def test_sweep_rows_equal_unbatched_rollouts(kind):
    """Row b of a sweep equals the unbatched rollout with row b's
    parameters (a swept perception threshold: row b's own filter)."""
    scene, params, cfg, kw = jax_sweep_scene(kind)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    swept = sweeps.batch_params(pparams, **dict(kw))
    steps = 12
    final, rec = sweeps.make_sweep_rollout(pscene, pcfg, steps,
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
        f1, r1 = stepper.make_rollout_fn(pscene, p_row, pcfg, steps)(
            PedState.empty(pscene.spawn.capacity, device="cpu"))
        assert torch.equal(rec.pos[row], r1.pos), row
        assert torch.equal(final.alive[row], f1.alive)


def test_batched_terms_on_the_cpu_are_the_plain_versions():
    """On CPU tensors the batched wrappers are the plain batched versions,
    and the fused environment terms of a batch equal the plain terms."""
    scene, params, cfg = port_of(*jax_crowd_ensemble(2, 10, "config3"))
    scene = stepper.prepare_scene(scene)
    state = PedState.empty(10, device="cpu", batch=2)
    state, _ = stepper.simulation_step(state, scene, params, cfg, 0)
    snap = stepper.vehicle_snapshot_at(scene.vehicles, 1)
    got = cuda_env.fused_environment_terms(state, scene, params, snap)
    want = cuda_env.plain_environment_terms(state, scene, params, snap)
    assert sorted(got) == sorted(want) == ["border_force",
                                           "dynamic_obstacle_force",
                                           "static_obstacle_force"]
    for name in got:
        assert torch.equal(got[name][0], want[name][0]), name
    fx, fy = cuda_forces.pedestrian_force_batched(
        state.pos_x, state.pos_y, state.vel_x, state.vel_y, state.radius,
        state.alive, params.pedestrian)
    assert fx.shape == (2, 10) and torch.isfinite(fx).all()
    before = dict(cuda_forces.LAUNCHES, **cuda_env.LAUNCHES)
    assert dict(cuda_forces.LAUNCHES, **cuda_env.LAUNCHES) == before


# -- refusals ----------------------------------------------------------------

def refusal_cases():
    scene, params, cfg, _ = synthetic.benchmark_bundle(
        8, extent=10.0, with_borders=True, device="cpu")
    batched = dataclasses.replace(scene, spawn=synthetic.batched_crowds(
        2, 8, extent=10.0, device="cpu"))
    urban, uparams, ucfg, _ = synthetic.urban_bundle(
        8, num_steps_hint=4, n_routes=2, n_roads=2, width=100.0,
        cross_spacing=40.0, device="cpu")
    groups = build_groups([0, 0, 1, 1, -1, -1, -1, -1], device="cpu")
    col = torch.ones((2, 8))
    return {
        "interaction_cutoff": (batched, params, dataclasses.replace(
            cfg, interaction_cutoff=30.0)),
        "env_compact": (batched, params, dataclasses.replace(
            cfg, env_compact=True)),
        "env_analytic": (batched, params, dataclasses.replace(
            cfg, env_analytic=True)),
        "env_chunked": (batched, params, dataclasses.replace(
            cfg, env_chunked=True)),
        "ORCA": (batched, dataclasses.replace(params, enable_orca=True,
                                              enable_pedestrian=False), cfg),
        "groups": (dataclasses.replace(batched, groups=groups),
                   dataclasses.replace(params, enable_group=True), cfg),
        "autopilot fleet": (dataclasses.replace(
            urban, spawn=synthetic.batched_crowds(2, 8, device="cpu")),
            uparams, dataclasses.replace(ucfg, env_compact=False)),
        "pair_scale": (dataclasses.replace(batched, spawn=dataclasses.replace(
            batched.spawn, pair_scale=col)), params, cfg),
        "law_id": (dataclasses.replace(batched, spawn=dataclasses.replace(
            batched.spawn, law_id=col.to(torch.int32))), params, cfg),
    }


@pytest.mark.parametrize("case", ["interaction_cutoff", "env_compact",
                                  "env_analytic", "env_chunked", "ORCA",
                                  "groups", "autopilot fleet", "pair_scale",
                                  "law_id"])
def test_batched_step_refuses_what_is_not_ported(case):
    """Under a batch every configuration that is not batched yet raises
    NotImplementedError naming ROADMAP item 19b, from make_ensemble_rollout
    and from one step alike: nothing runs another path instead."""
    scene, params, cfg = refusal_cases()[case]
    with pytest.raises(NotImplementedError, match="item 19b"):
        sweeps.make_ensemble_rollout(scene, params, cfg, 2)
    state = PedState.empty(8, device="cpu", batch=2)
    with pytest.raises(NotImplementedError, match="item 19b"):
        stepper.simulation_step(state, stepper.prepare_scene(scene), params,
                                cfg, 0)


@pytest.mark.parametrize("case", ["agent axis", "ensemble mesh",
                                  "sweep mesh", "sweep orca",
                                  "sharded ensemble", "batch shards",
                                  "sweep cutoff", "fused env table"])
def test_batch_sharding_and_sweep_options_refused(case):
    scene, params, cfg, _ = synthetic.benchmark_bundle(8, extent=10.0,
                                                       device="cpu")
    batched = dataclasses.replace(scene, spawn=synthetic.batched_crowds(
        2, 8, extent=10.0, device="cpu"))
    swept = sweeps.batch_params(params, pedestrian_A=[1.0, 2.0])
    state = PedState.empty(8, device="cpu", batch=2)
    calls = {
        "agent axis": lambda: stepper.simulation_step(
            state, batched, params, cfg, 0, axis=make_mesh(
                1, device="cpu")),
        "ensemble mesh": lambda: sweeps.make_ensemble_rollout(
            batched, params, cfg, 2, mesh=make_mesh(1, device="cpu")),
        "sweep mesh": lambda: sweeps.make_sweep_rollout(
            scene, cfg, 2, mesh=make_mesh(1, device="cpu")),
        "sweep orca": lambda: sweeps.make_sweep_rollout(scene, cfg, 2,
                                                        orca=True),
        "sharded ensemble": lambda: sweeps.make_sharded_ensemble_rollout(
            None, batched, params, cfg, 2),
        "batch shards": lambda: make_mesh(1, n_batch_shards=2,
                                          device="cpu"),
        "sweep cutoff": lambda: sweeps.make_sweep_rollout(
            scene, dataclasses.replace(cfg, interaction_cutoff=30.0),
            2)(swept),
        "fused env table": lambda: cuda_env.fused_environment_terms(
            state, stepper.prepare_scene(synthetic.benchmark_bundle(
                8, extent=10.0, with_borders=True, device="cpu")[0]),
            dataclasses.replace(params, enable_border=True), None,
            compact=True),
    }
    with pytest.raises(NotImplementedError, match="item 19b"):
        calls[case]()
