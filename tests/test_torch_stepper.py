"""PyTorch port: the headless tick and rollouts against the JAX package.

Scenes are built on the host by the JAX package (spawn schedules, params,
step configs), flattened to numpy with ``dataclasses.fields`` and carried
into the port with ``utils/convert.py``; then both packages roll out and
their records are compared step by step.
"""
import dataclasses
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from carla_social_force_model_tpu.api.synthetic import (
    benchmark_bundle as jax_benchmark_bundle)
from carla_social_force_model_tpu.models import stepper as jax_stepper
from carla_social_force_model_tpu.models.params import (
    SfmParams as JaxSfmParams)
from carla_social_force_model_tpu.models.spawn import (
    SpawnerSpec, apply_spawn as jax_apply_spawn, build_spawn_schedule)
from carla_social_force_model_tpu.models.state import PedState as JaxPedState
from carla_social_force_model_tpu.utils.config import (
    load_config as jax_load_config)
from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.models import modes, stepper
from carla_social_force_model_tpu_torch.models.params import SfmParams
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.utils import convert
from carla_social_force_model_tpu_torch.utils.config import load_config

DT = 0.05
SFM_TOML = Path(__file__).resolve().parent.parent / "configs" / "sfm.toml"

SFM_DICT = {
    "max_speed_multiplier": 1.3,
    "forces": {"acceleration_force": True, "pedestrian_force": True},
    "acceleration_force": {"tau": 0.5},
    "pedestrian_force": {"lambda": 2.0, "A": 4.5, "gamma": 0.35, "n": 2.0,
                         "n_prime": 3.0, "epsilon": 0.005},
}


def fields_of(obj):
    """A JAX-package dataclass as nested dicts of numpy arrays and Python
    values (what utils/convert.py takes)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def corridor_specs():
    """Bidirectional counterflow with staggered spawn intervals (the JAX
    package's corridor scene, tests/test_stepper.py), plus walkers on a
    multi-waypoint route that crosses a road; as spawner dicts."""
    specs = []
    for k in range(3):
        for (x0, x1) in [(-12.0, 12.0), (12.0, -12.0)]:
            y = -1.0 + k * 0.9
            specs.append(dict(
                spawn_location=[x0, y, 1.0], waypoints=[[x1, y]],
                crossing_road=[False], speed=1.2 + 0.1 * k, quantity=2,
                spawn_time=0.3 * k, spawn_interval=1.7))
    specs.append(dict(
        spawn_location=[0.5, -9.0],
        waypoints=[[0.5, -6.5], [0.5, -4.5], [0.5, 4.0], [3.0, 6.0]],
        crossing_road=[False, False, True, False], speed=1.4, quantity=2,
        spawn_time=0.0, spawn_interval=0.6))
    return specs


def corridor_spawners():
    return [SpawnerSpec(**dict(spec,
                               spawn_location=np.array(spec["spawn_location"]),
                               waypoints=np.array(spec["waypoints"])))
            for spec in corridor_specs()]


def both_scenes(num_steps, **cfg_kw):
    """(JAX scene, params, cfg, state), (port scene, params, cfg, state)."""
    schedule = build_spawn_schedule(corridor_spawners(), DT, num_steps)
    jparams = JaxSfmParams.from_dict(SFM_DICT)
    jcfg = jax_stepper.StepConfig(dt=DT, waypoint_threshold=1.0,
                                  despawn_on_arrival=True, **cfg_kw)
    jstate = JaxPedState.empty(schedule.capacity)
    port = (stepper.Scene(spawn=convert.spawn_schedule_from_fields(
                fields_of(schedule), "cpu")),
            convert.params_from_fields(fields_of(jparams)),
            convert.step_config_from_fields(fields_of(jcfg)),
            convert.ped_state_from_fields(fields_of(jstate), "cpu"))
    return (jax_stepper.Scene(spawn=schedule), jparams, jcfg, jstate), port


def assert_records_match(jrec, prec, tol):
    jalive, palive = np.asarray(jrec.alive), prec.alive.numpy()
    jmode, pmode = np.asarray(jrec.mode), prec.mode.numpy()
    for t in range(jalive.shape[0]):
        np.testing.assert_array_equal(palive[t], jalive[t], err_msg=f"t={t}")
        np.testing.assert_array_equal(pmode[t], jmode[t], err_msg=f"t={t}")
    err = np.abs(prec.pos.numpy() - np.asarray(jrec.pos)).max(axis=(1, 2))
    assert err.max() <= tol, f"per-step position error {err}"
    verr = np.abs(prec.vel.numpy() - np.asarray(jrec.vel)).max()
    assert verr <= 10 * tol


@pytest.mark.parametrize("use_pallas,num_steps", [(False, 60), (True, 10)])
def test_rollout_matches_jax_step_by_step(use_pallas, num_steps):
    """Alive and mode equal at every step, positions within 1e-4 m: once
    against the JAX reference path and once against the Pallas kernel in
    interpret mode."""
    cfg_kw = dict(use_pallas=use_pallas, pallas_interpret=use_pallas)
    (js, jp, jc, jst), (ps, pp, pc, pst) = both_scenes(num_steps, **cfg_kw)
    jfinal, jrec = jax_stepper.make_rollout_fn(js, jp, jc, num_steps)(jst)
    pfinal, prec = stepper.make_rollout_fn(ps, pp, pc, num_steps)(pst)
    assert_records_match(jrec, prec, tol=1e-4)
    for f in dataclasses.fields(PedState):
        want = np.asarray(getattr(jfinal, f.name))
        got = getattr(pfinal, f.name).numpy()
        if want.dtype == np.float32:
            np.testing.assert_allclose(got, want, atol=1e-3, err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_crossing_route_goes_through_the_mode_machine():
    """The multi-waypoint walker reaches CROSSING_ROAD (via CHECKING_TRAFFIC)
    and ROAD_TO_SIDEWALK within the horizon, in both packages alike."""
    num_steps = 160
    (js, jp, jc, jst), (ps, pp, pc, pst) = both_scenes(num_steps)
    _, prec = stepper.make_rollout_fn(ps, pp, pc, num_steps)(pst)
    _, jrec = jax_stepper.make_rollout_fn(js, jp, jc, num_steps)(jst)
    seen = set(np.unique(prec.mode.numpy()[prec.alive.numpy()]).tolist())
    assert {modes.CROSSING_ROAD, modes.ROAD_TO_SIDEWALK} <= seen
    np.testing.assert_array_equal(prec.mode.numpy(), np.asarray(jrec.mode))
    np.testing.assert_array_equal(prec.alive.numpy(), np.asarray(jrec.alive))


def test_rollout_matches_float64_oracle_simulator():
    """The port against tests/oracle_sim.py, the float64 re-derivation of
    the reference tick: same spawn/despawn structure and modes, positions
    within 2e-3 m over 120 steps (the JAX package's own bound)."""
    from oracle_sim import OracleSim
    num_steps = 120
    _, (ps, pp, pc, pst) = both_scenes(num_steps)
    _, rec = stepper.make_rollout_fn(ps, pp, pc, num_steps)(pst)
    sim = OracleSim(dict(acceleration=SFM_DICT["acceleration_force"],
                         pedestrian=SFM_DICT["pedestrian_force"],
                         max_speed_factor=1.3),
                    dt=DT, waypoint_threshold=1.0, despawn_on_arrival=True)
    for spec in corridor_specs():
        sim.add_spawner(**spec)
    history = sim.run(num_steps)
    n = ps.spawn.capacity
    opos = np.zeros((num_steps, n, 2))
    omode = np.full((num_steps, n), -1)
    oalive = np.zeros((num_steps, n), bool)
    for t, rows in enumerate(history):
        for name, pos, _, mode in rows:
            slot = int(name.split("_")[-1])
            opos[t, slot], omode[t, slot], oalive[t, slot] = pos, mode, True
    alive = rec.alive.numpy()
    np.testing.assert_array_equal(alive, oalive)
    np.testing.assert_array_equal(np.where(alive, rec.mode.numpy(), -1),
                                  omode)
    err = np.abs(np.where(alive[..., None], rec.pos.numpy() - opos, 0.0))
    assert err.max() < 2e-3, f"max position error {err.max()}"


def test_benchmark_bundle_is_the_jax_scene():
    """Same seed, same crowd: the port draws the synthetic scene with numpy
    in the JAX package's order, and the two roll out alike."""
    js, jp, jc, jst = jax_benchmark_bundle(64, extent=10.0, use_pallas=False)
    ps, pp, pc, pst = benchmark_bundle(64, extent=10.0, device="cpu")
    jsched = fields_of(js.spawn)
    for f in dataclasses.fields(ps.spawn):
        got = getattr(ps.spawn, f.name)
        if f.name == "routes":
            for g in dataclasses.fields(got):
                np.testing.assert_array_equal(getattr(got, g.name).numpy(),
                                              jsched["routes"][g.name])
        elif got is None:
            assert jsched[f.name] is None
        else:
            np.testing.assert_array_equal(got.numpy(), jsched[f.name])
    assert pp == convert.params_from_fields(fields_of(jp))
    assert pc == convert.step_config_from_fields(fields_of(jc))
    _, jrec = jax_stepper.make_rollout_fn(js, jp, jc, 20)(jst)
    _, prec = stepper.make_rollout_fn(ps, pp, pc, 20)(pst)
    assert_records_match(jrec, prec, tol=1e-4)


def test_sim_time_is_float32_product():
    """sim_time = float32(step) * float32(dt), rounded in float32, as the JAX
    step computes it; a double product rounds differently at step 9."""
    for t in range(0, 400, 7):
        want = np.asarray(jnp.asarray(t, jnp.int32) * DT)
        assert stepper.sim_time_of(t, DT) == float(want)
    assert np.float32(9 * DT) != np.float32(stepper.sim_time_of(9, DT))


def test_idle_promotion_at_a_float32_boundary_tick():
    """An IDLE walker whose deadline is exactly the float32 time of step 9
    is promoted at step 9 in both packages (a double sim_time would keep it
    IDLE one tick longer)."""
    schedule = build_spawn_schedule(corridor_spawners()[:1], DT, 20)
    jparams = JaxSfmParams.from_dict(SFM_DICT)
    jcfg = jax_stepper.StepConfig(dt=DT, waypoint_threshold=1.0)
    jscene = jax_stepper.Scene(spawn=schedule)
    deadline = np.float32(9) * np.float32(DT)
    jstate = jax_apply_spawn(JaxPedState.empty(schedule.capacity), schedule, 0)
    jstate = dataclasses.replace(
        jstate, mode=jnp.full_like(jstate.mode, modes.IDLE),
        next_mode_time=jnp.full_like(jstate.next_mode_time, deadline))
    jfinal, _ = jax_stepper.rollout(jstate, jscene, jparams, jcfg, 1,
                                    record=False, start_step=9)
    pscene = stepper.Scene(spawn=convert.spawn_schedule_from_fields(
        fields_of(schedule), "cpu"))
    pfinal, _ = stepper.rollout(
        convert.ped_state_from_fields(fields_of(jstate), "cpu"), pscene,
        convert.params_from_fields(fields_of(jparams)),
        convert.step_config_from_fields(fields_of(jcfg)), 1, record=False,
        start_step=9)
    alive = np.asarray(jfinal.alive)
    assert np.all(np.asarray(jfinal.mode)[alive] == modes.WALKING_SIDEWALK)
    np.testing.assert_array_equal(pfinal.mode.numpy(), np.asarray(jfinal.mode))


def test_record_stride_keeps_first_of_each_stride():
    ps, pp, pc, pst = benchmark_bundle(32, extent=8.0, device="cpu")
    _, full = stepper.make_rollout_fn(ps, pp, pc, 12)(pst)
    final, strided = stepper.make_rollout_fn(ps, pp, pc, 12,
                                             record_stride=3)(pst)
    for a, b in zip(strided, full):
        np.testing.assert_array_equal(a.numpy(), b[::3].numpy())
    _, none = stepper.make_rollout_fn(ps, pp, pc, 12, record=False)(pst)
    assert none is None
    with pytest.raises(ValueError, match="multiple of record_stride"):
        stepper.make_rollout_fn(ps, pp, pc, 10, record_stride=3)(pst)


def test_rollout_leaves_the_initial_state_untouched():
    ps, pp, pc, pst = benchmark_bundle(16, extent=6.0, device="cpu")
    before = {f.name: getattr(pst, f.name).clone()
              for f in dataclasses.fields(pst)}
    stepper.make_rollout_fn(ps, pp, pc, 5, record=False)(pst)
    for name, t in before.items():
        assert torch.equal(getattr(pst, name), t), name


def test_pair_scale_and_law_id_raise():
    """Per-agent ``pair_scale``/``law_id`` columns step when they are
    (N,) float32 / int32 tensors, and raise when they are of another shape
    or type."""
    ps, pp, pc, pst = benchmark_bundle(8, extent=5.0, device="cpu")
    for col, good, bads in (
            ("pair_scale", torch.ones(8), (torch.ones(7),
                                           torch.ones(8, dtype=torch.int32))),
            ("law_id", torch.zeros(8, dtype=torch.int32),
             (torch.ones(8), np.zeros(8, np.int32)))):
        spawn = dataclasses.replace(ps.spawn, **{col: good})
        stepper.make_rollout_fn(dataclasses.replace(ps, spawn=spawn),
                                pp, pc, 2)(pst)
        for bad in bads:
            spawn = dataclasses.replace(ps.spawn, **{col: bad})
            with pytest.raises(ValueError, match="pair_scale/law_id"):
                stepper.make_rollout_fn(dataclasses.replace(ps, spawn=spawn),
                                        pp, pc, 2)(pst)


def test_benchmark_bundle_raises_for_environment_configs():
    """Configs #2 and #3 (formerly refused here) build the JAX package's
    scene: the same border and obstacle point sets, vehicle timeline and
    params for the same arguments."""
    for kw in (dict(with_borders=True), dict(with_obstacles=True),
               dict(with_borders=True, with_obstacles=True)):
        js, jp, _, _ = jax_benchmark_bundle(8, use_pallas=False,
                                            num_steps_hint=30, **kw)
        ps, pp, _, _ = benchmark_bundle(8, num_steps_hint=30, device="cpu",
                                        **kw)
        assert pp == convert.params_from_fields(fields_of(jp))
        for name in ("borders", "static_obstacles", "vehicles"):
            want, got = getattr(js, name), getattr(ps, name)
            assert (got is None) == (want is None), name
            if got is None:
                continue
            want = fields_of(want)
            for f in dataclasses.fields(got):
                value = getattr(got, f.name)
                if isinstance(value, torch.Tensor):
                    value = value.numpy()
                np.testing.assert_array_equal(value, want[f.name])


@pytest.mark.parametrize("strict", [False, True])
def test_shipped_sfm_config_parses_like_jax(strict):
    cfg = load_config(SFM_TOML)
    want = JaxSfmParams.from_dict(jax_load_config(SFM_TOML),
                                  strict_parity=strict)
    got = SfmParams.from_dict(cfg, strict_parity=strict)
    assert got == convert.params_from_fields(fields_of(want))
    assert got.pedestrian.lambda_ == 2.0 and got.border.a == 6.0


def test_step_config_conversion_maps_the_symmetric_flag():
    for sym in (False, True):
        jcfg = jax_stepper.StepConfig(dt=0.1, pallas_symmetric=sym,
                                      use_pallas=True, row_block=64)
        got = convert.step_config_from_fields(fields_of(jcfg))
        assert got == stepper.StepConfig(dt=0.1, row_block=64,
                                         symmetric_pairs=sym)
