"""PyTorch port: the CARLA bridge's tick-synchronised runner on the
in-process ``FakeWorld``, on the CPU.

The port's ``BridgeRunner`` against the port's headless ``Simulation`` of
the same scenario (280 ticks), and against the JAX package's
``BridgeRunner`` on the same ``FakeWorld`` scene, with and without
scripted vehicles (100 ticks): every tick within 1e-4 m, modes and alive
masks equal.  Then the host-side behaviour the runner keeps from the
reference: a failed spawn reusing its slot, the seeded per-walker draws,
gap acceptance at the curb, the drawing hooks, and the card by default.
"""
import numpy as np
import pytest
import torch

from scenario_jax import one_torch_thread  # noqa: F401
from test_bridge import SCENARIO, SFM, _reference_jitter_oracle
from carla_social_force_model_tpu.bridge.runner import (
    BridgeRunner as JBridgeRunner)
from carla_social_force_model_tpu.bridge.world import FakeWorld as JFakeWorld
from carla_social_force_model_tpu.models.vehicles import (
    VehicleSpec as JVehicleSpec, build_vehicle_states as jbuild_vehicles)
from carla_social_force_model_tpu_torch.api.simulation import Simulation
from carla_social_force_model_tpu_torch.bridge.runner import BridgeRunner
from carla_social_force_model_tpu_torch.bridge.world import FakeWorld
from carla_social_force_model_tpu_torch.models import modes
from carla_social_force_model_tpu_torch.models.vehicles import (
    VehicleSpec, build_vehicle_states)

CPU = "cpu"
TOL_M = 1e-4


def gap_scene(length=140, steps=260):
    """tests/test_bridge.py's gap-acceptance scene: a walker at a curb, a
    scripted vehicle passing at 8 m/s.  Returns the scenario, the sfm
    config and the vehicle spec's arrays."""
    speed, y0, x = 8.0, -30.0, 12.0
    ys = y0 + speed * 0.05 * np.arange(length)
    traj = dict(trajectory=np.column_stack([np.full(length, x), ys]),
                headings=np.full(length, np.pi / 2),
                speeds=np.full(length, speed))
    scenario = {
        "step_length": 0.05,
        "walker": {
            "despawn_on_arrival": True, "waypoint_threshold": 1,
            "ped_spawner": [{
                "spawn_location": [4.0, 0.0, 1.0],
                "waypoints": [[9.0, 0.0], [15.0, 0.0]],
                "crossing_road_bools": [False, True, False],
                "destination": [20.0, 0.0, 0.0],
                "speed": 1.5, "quantity": 1,
                "crossing_speed_factor": 1.5,
                "crossing_safety_margin": 1.5}],
        },
    }
    sfm = dict(SFM)
    sfm["forces"] = dict(SFM["forces"], dynamic_obstacle_force=True,
                         border_force=False)
    sfm["dynamic_obstacle_force"] = {
        "lambda": 2.0, "A": 50.0, "gamma": 0.4, "n": 1.0, "n_prime": 3.0,
        "epsilon": 0.005, "perception_threshold": 50.0}
    return scenario, sfm, traj, steps


def assert_records_agree(got, want, tol=TOL_M):
    """Alive masks and (alive) modes equal, every alive position within
    ``tol`` at every tick."""
    alive = np.asarray(got.alive)
    np.testing.assert_array_equal(alive, np.asarray(want.alive))
    np.testing.assert_array_equal(np.asarray(got.mode)[alive],
                                  np.asarray(want.mode)[alive])
    err = np.abs(np.asarray(got.pos) - np.asarray(want.pos))
    err = np.where(alive[..., None], err, 0.0).max(axis=(1, 2))
    assert err.max() < tol, (int(err.argmax()), float(err.max()))
    return alive


def test_bridge_matches_headless():
    """280 ticks of the corridor through the bridge equal the headless
    rollout of the same scenario (the world integrates in float32 with the
    engine's op order)."""
    runner = BridgeRunner(FakeWorld(dt=0.05, walker_radius=0.3), SCENARIO,
                          SFM, device=CPU)
    runner.run(280)
    sim = Simulation.from_config(SCENARIO, SFM, num_steps=280, device=CPU)
    _, want = sim.run()
    alive = assert_records_agree(runner.records(), want)
    assert alive.any() and alive[-1].sum() == 0   # everyone arrived


@pytest.mark.parametrize("vehicles", [False, True])
def test_bridge_matches_jax_bridge(vehicles):
    """The port's runner and the JAX package's on the same FakeWorld scene,
    100 ticks: every tick within 1e-4 m, modes and alive masks equal, the
    mirrors' FSM planes equal at the end."""
    if vehicles:
        scenario, sfm, traj, _ = gap_scene()
        world = FakeWorld(dt=0.05, vehicle_timeline=build_vehicle_states(
            [VehicleSpec(**traj)], 0.05, 260, device=CPU))
        jworld = JFakeWorld(dt=0.05, vehicle_timeline=jbuild_vehicles(
            [JVehicleSpec(**traj)], 0.05, 260))
    else:
        scenario, sfm = SCENARIO, SFM
        world, jworld = FakeWorld(dt=0.05), JFakeWorld(dt=0.05)
    runner = BridgeRunner(world, scenario, sfm, device=CPU)
    jrunner = JBridgeRunner(jworld, scenario, sfm)
    runner.run(100)
    jrunner.run(100)
    alive = assert_records_agree(runner.records(), jrunner.records())
    assert alive.any()
    for name in ("mode", "waypoint_idx", "alive", "spawned"):
        np.testing.assert_array_equal(runner.h[name], jrunner.h[name], name)
    for name in ("fsm_target", "applied_target", "next_mode_time"):
        np.testing.assert_allclose(runner.h[name], jrunner.h[name],
                                   rtol=0, atol=1e-6, err_msg=name)
    if vehicles:
        assert len(runner.veh_history) == 100
        assert [len(o) for o in runner.veh_history] == \
            [len(o) for o in jrunner.veh_history]
        mode = np.asarray(runner.records().mode)[:, 0]
        assert (mode[alive[:, 0]] == modes.CHECKING_TRAFFIC).any()


def test_bridge_spawn_failure_reuses_slot():
    """A failed world spawn does not leak a state slot (the reference just
    skips, pedestrian_spawner.py:152-153): the next success takes it, and
    the name counter advances on the failure."""
    runner = BridgeRunner(FakeWorld(dt=0.05, fail_spawns={1}), SCENARIO, SFM,
                          device=CPU)
    runner.run(60)
    alive = np.asarray(runner.records().alive)
    assert alive[:, 0].any() and alive[:, 1].any() and alive[:, 2].any()
    assert not alive[:, 3].any()
    assert runner._next_slot == 3
    assert runner._ped_index == 4
    assert runner.slot_name[:3] == ["ped_0", "ped_2", "ped_3"]


def test_bridge_seeded_jitter_matches_reference_oracle():
    """The per-walker seeded draws in the reference's order: a failed spawn
    consumes its seed, the blueprint draw's entropy precedes the jitter,
    and an explicit blueprint skips the library draw."""
    from carla_social_force_model_tpu_torch.models.spawn import (
        WALKER_BLUEPRINT_COUNT)
    scenario = {
        "step_length": 0.05,
        "walker": {
            "pedestrian_seed": 77, "variate_speed": 0.25,
            "despawn_on_arrival": False, "waypoint_threshold": 1,
            "ped_spawner": [
                {"spawn_location": [-6.0, 0.0, 1.0],
                 "destination": [6.0, 0.0, 0.0],
                 "speed": 1.3, "quantity": 4, "spawn_interval": 0.5}],
        },
    }
    expect = _reference_jitter_oracle(77, 0.25, 1.3, [True] * 4,
                                      WALKER_BLUEPRINT_COUNT)
    runner = BridgeRunner(FakeWorld(dt=0.05, fail_spawns={1}), scenario, SFM,
                          device=CPU)
    runner.run(40)
    got = [float(runner.h["base_speed"][s]) for s in range(3)]
    np.testing.assert_allclose(got, [expect[0], expect[2], expect[3]],
                               rtol=0, atol=1e-6)

    scenario["walker"]["ped_spawner"][0]["blueprint"] = \
        "walker.pedestrian.0001"
    expect_bp = _reference_jitter_oracle(77, 0.25, 1.3, [False] * 4,
                                         WALKER_BLUEPRINT_COUNT)
    runner = BridgeRunner(FakeWorld(dt=0.05), scenario, SFM, device=CPU)
    runner.run(40)
    np.testing.assert_allclose(runner.h["base_speed"], expect_bp, rtol=0,
                               atol=1e-6)
    assert not np.allclose(expect_bp, expect)


def test_bridge_with_vehicles_gap_acceptance():
    """A walker at a curb waits for the scripted vehicle (CHECKING_TRAFFIC
    on several ticks), then crosses and despawns."""
    scenario, sfm, traj, steps = gap_scene()
    world = FakeWorld(dt=0.05, vehicle_timeline=build_vehicle_states(
        [VehicleSpec(**traj)], 0.05, steps, device=CPU))
    runner = BridgeRunner(world, scenario, sfm, device=CPU)
    runner.run(steps)
    recs = runner.records()
    mode, alive = recs.mode[:, 0], recs.alive[:, 0]
    assert (mode[alive] == modes.CHECKING_TRAFFIC).sum() > 3
    assert (mode[alive] == modes.CROSSING_ROAD).any()
    assert not alive[-1]
    # one template uploaded for the one vehicle, reused every tick
    assert runner._bank_xy.shape[0] == 2


class _DrawCountingWorld(FakeWorld):
    """FakeWorld recording draw_points calls (debug-draw wiring test)."""

    def __post_init__(self):
        super().__post_init__()
        self.draw_calls = []

    def draw_points(self, points, life_time) -> None:
        self.draw_calls.append((np.asarray(points).shape[0], float(life_time)))


def test_bridge_draw_obstacles_wiring():
    """map.draw_obstacles draws the static geometry at startup (life 30 s,
    run_simulation.py:194-197) and the vehicle outlines each tick (life dt,
    run_simulation.py:97-99); nothing without the flag."""
    speed, length = 8.0, 40
    ys = -30.0 + speed * 0.05 * np.arange(length)
    spec = VehicleSpec(trajectory=np.column_stack([np.full(length, 12.0), ys]),
                       headings=np.full(length, np.pi / 2),
                       speeds=np.full(length, speed))
    timeline = build_vehicle_states([spec], 0.05, 30, device=CPU)
    world = _DrawCountingWorld(dt=0.05, vehicle_timeline=timeline)
    scenario = dict(SCENARIO, map={"draw_obstacles": True})
    runner = BridgeRunner(world, scenario, SFM, device=CPU)
    startup = [c for c in world.draw_calls if c[1] == 30.0]
    assert len(startup) == len(runner.border_lines)
    runner.run(10)
    assert len([c for c in world.draw_calls if c[1] == runner.cfg.dt]) >= 8
    quiet = _DrawCountingWorld(dt=0.05, vehicle_timeline=timeline)
    BridgeRunner(quiet, SCENARIO, SFM, device=CPU).run(5)
    assert quiet.draw_calls == []


def test_bridge_runner_defaults_to_the_card(monkeypatch):
    """The runner builds on the card unless asked for the CPU: without one
    it raises, and nothing falls back."""
    import inspect
    assert inspect.signature(BridgeRunner).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        BridgeRunner(FakeWorld(), SCENARIO, SFM)
