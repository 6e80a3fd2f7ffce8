"""PyTorch port: the live-CARLA side of the bridge on the in-process fake
server and fake maps (tests/fake_carla.py), on the CPU.

``CarlaWorld`` setup, restore and the walker round trip;
``BridgeVehicleManager`` in its three modes; the port's ``BridgeRunner``
through ``CarlaWorld``; the whole CARLA-attached loop (``run_with_carla``)
on the multi-road Town2 fake; random pedestrians from the live nav mesh;
and the map extraction, the CARLA nav graph and the driving graph, each
equal to the JAX package's output on the same fake map (float64 host code
in both: exact).
"""
import csv
import os
import types

import numpy as np
import pytest
import torch

import fake_carla
from scenario_jax import one_torch_thread  # noqa: F401
from test_carla_extraction import _env_world

CPU = "cpu"

SCENARIO = {
    "scenario_name": "fake-server-corridor",
    "step_length": 0.05,
    "map": {},
    "walker": {
        "pedestrian_seed": 2000,
        "despawn_on_arrival": True,
        "waypoint_threshold": 1.0,
        "initial_velocity": "zero",
        "ped_spawner": [
            {"spawn_location": [-6.0, 0.0, 1.0], "destination": [6.0, 0.0, 0.0],
             "speed": 1.3, "quantity": 2, "spawn_interval": 1.0}],
    },
}

SFM = {
    "forces": {"acceleration_force": True, "pedestrian_force": True},
    "acceleration_force": {"tau": 0.5},
}

#: the fake maps of tests/fake_carla.py, by name
MAPS = {"road": lambda: fake_carla.Map(),
        "junction": lambda: fake_carla.Map(with_junction=True),
        "town2": lambda: fake_carla.Town2Map(),
        "crosstown": lambda: fake_carla.CrossTownMap()}


@pytest.fixture()
def server(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return fake_carla.install_server()


def carla_world(scenario):
    from carla_social_force_model_tpu_torch.bridge.carla_world import (
        CarlaWorld)
    return CarlaWorld("localhost", 2000, scenario)


def test_carla_world_setup_and_restore(server):
    _, world = server
    cw = carla_world(SCENARIO)
    s = world._settings
    assert s.synchronous_mode and s.deterministic_ragdolls
    assert s.fixed_delta_seconds == 0.05
    assert world.pedestrians_seed == 2000
    assert cw.walker_blueprint_count() == 41
    cw.close()
    assert not world._settings.synchronous_mode


def test_carla_world_walker_roundtrip(server):
    _, world = server
    cw = carla_world(SCENARIO)
    aid = cw.spawn_walker(3, np.array([1.0, 2.0, 1.0]), 0.0,
                          role_name="ped_0")
    assert aid > 0
    assert world.get_actor(aid).type_id == "walker.pedestrian.0004"
    assert abs(cw.get_walker_radius(aid) - 0.19) < 1e-9
    cw.set_walker_velocity(aid, np.array([1.0, 0.0, 0.0]), 2.0)
    cw.tick()
    loc, vel = cw.get_walker_state(aid)
    np.testing.assert_allclose(loc[:2], [1.1, 2.0], atol=1e-9)
    np.testing.assert_allclose(vel[:2], [2.0, 0.0], atol=1e-9)
    assert abs(cw.get_sim_time() - 0.05) < 1e-9
    cw.destroy_actor(aid)
    assert world.get_actor(aid) is None
    cw.close()


def test_bridge_runner_on_fake_server(server):
    """The port's runner through the real CarlaWorld adapter: batched
    spawns, WalkerControl velocities integrated by the server, everyone
    crosses the corridor."""
    from carla_social_force_model_tpu_torch.bridge.runner import BridgeRunner
    cw = carla_world(SCENARIO)
    runner = BridgeRunner(cw, SCENARIO, SFM, device=CPU)
    runner.run(260)
    recs = runner.records()
    assert recs.alive.any() and recs.alive[-1].sum() == 0
    assert recs.pos[recs.alive].max() > 4.0
    cw.close()


def test_bridge_runner_spawn_failure_on_server(server):
    """The server refuses the first walker: its slot goes to the second."""
    from carla_social_force_model_tpu_torch.bridge.runner import BridgeRunner
    fake_carla.Client.fail_walker_spawns = {0}
    cw = carla_world(SCENARIO)
    runner = BridgeRunner(cw, SCENARIO, SFM, device=CPU)
    runner.run(40)
    assert runner._next_slot == 1 and runner._ped_index == 2
    assert runner.slot_name[0] == "ped_1"
    cw.close()


def manager(scenario):
    from carla_social_force_model_tpu_torch.bridge.vehicle_spawner import (
        BridgeVehicleManager)
    cw = carla_world(scenario)
    return cw, BridgeVehicleManager(cw, scenario)


def test_vehicle_manager_traffic_manager_mode(server):
    """TrafficManager autopilot: batched spawn + SetAutopilot, the
    per-vehicle percentage knobs, the seeded blueprint draw, exhaustion."""
    _, world = server
    scenario = dict(SCENARIO, vehicle={
        "vehicle_seed": 2000, "no_bikes": True,
        "vehicle_spawner": [{
            "spawn_point": 0, "auto_pilot": True, "use_traffic_manager": True,
            "speed_reduction_factor": 40,
            "ignore_walkers_percentage": 25, "ignore_lights_percentage": 50,
            "quantity": 2, "spawn_time": 0.0, "spawn_interval": 1.0}]})
    cw, mgr = manager(scenario)
    assert all(int(b.get_attribute("number_of_wheels")) == 4
               for b in mgr.blueprints)
    assert mgr.tm.synchronous and mgr.tm.seed == 2000
    mgr.tick(0.0)
    v0 = world.get_actor(mgr.vehicle_ids[0])
    assert v0.autopilot
    assert {c[0]: c[2] for c in mgr.tm.calls if c[1] == v0.id} == {
        "speed_difference": 40.0, "ignore_walkers": 25.0,
        "ignore_lights": 50.0}
    cw.tick()
    cw.tick()
    obs = cw.get_vehicles()
    assert len(obs) == 1 and np.linalg.norm(obs[0].velocity) > 0.1
    mgr.tick(1.0)
    mgr.tick(2.0)
    assert len(mgr.vehicle_ids) == 2 and mgr.spawners == []
    mgr.close()
    assert all(world.get_actor(v) is None for v in mgr.vehicle_ids)
    cw.close()


def test_vehicle_manager_scripted_mode(server):
    """Scripted trajectories: the spawn consumes index 0, CarlaWorld
    teleports through the rest before each tick and destroys the vehicle
    when the list runs out."""
    _, world = server
    traj = [[0.0, -5.0], [0.0, -4.0], [0.0, -3.0], [0.0, -2.0]]
    scenario = dict(SCENARIO, vehicle={"vehicle_spawner": [{
        "auto_pilot": False, "blueprint": "vehicle.audi.tt",
        "trajectory": traj, "headings": [np.pi / 2] * 4,
        "speeds": [20.0] * 4, "quantity": 1}]})
    cw, mgr = manager(scenario)
    mgr.tick(0.0)
    vid = mgr.vehicle_ids[0]
    ys = []
    for _ in range(4):
        cw.tick()
        actor = world.get_actor(vid)
        ys.append(actor.get_transform().location.y if actor else None)
    assert ys == [-4.0, -3.0, -2.0, None]
    cw.close()


def test_vehicle_manager_behavior_agent_mode(server):
    """BehaviorAgent: the (fake) agents package drives the vehicle to the
    destination spawn point with per-tick run_step controls."""
    _, world = server
    fake_carla.install_agents()
    scenario = dict(SCENARIO, vehicle={
        "vehicle_seed": 2000,
        "vehicle_spawner": [{
            "spawn_point": 0, "auto_pilot": True,
            "use_traffic_manager": False, "destination": 1,
            "ignore_lights_percentage": 100, "quantity": 1,
            "spawn_time": 0.0}]})
    cw, mgr = manager(scenario)
    mgr.tick(0.0)
    vid, agent = next(iter(mgr.agents.items()))
    assert agent._ignore_lights and not world.get_actor(vid).autopilot
    dest = cw.carla_map.get_spawn_points()[1].location
    d0 = world.get_actor(vid).get_location().distance(dest)
    for i in range(400):
        mgr.tick(0.05 * (i + 1))
        cw.tick()
        if agent.done():
            break
    d1 = world.get_actor(vid).get_location().distance(dest)
    assert agent.run_steps > 0 and agent.done() and d1 < d0 and d1 < 3.0
    mgr.close()
    cw.close()


TOWN2_SCENARIO = {
    "scenario_name": "town2-bridge",
    "step_length": 0.05,
    "map": {},
    "walker": {
        "pedestrian_seed": 7, "despawn_on_arrival": True,
        "waypoint_threshold": 1.5, "waypoint_distance": 10,
        "ped_spawner": [{
            "spawn_location": [30.0, -7.5, 0.3],
            "destination": [66.0, -7.5, 0.0],
            "generate_route": "NO_JAYWALKING",
            "speed": 1.4, "quantity": 2, "spawn_interval": 1.0}],
    },
    "vehicle": {
        "vehicle_seed": 9,
        "vehicle_spawner": [{
            "spawn_point": 0, "auto_pilot": True,
            "use_traffic_manager": True, "quantity": 1}],
    },
    "obstacles": {"resolution": 0.5},
}
TOWN2_SFM = {"forces": {"acceleration_force": True, "pedestrian_force": True,
                        "border_force": True},
             "border_force": {"a": 3.0, "b": 0.3}}


def test_full_bridge_stack_on_town2(tmp_path, monkeypatch):
    """The whole CARLA-attached loop (run_with_carla: CarlaWorld, sidewalk
    extraction, nav-graph routing, BridgeVehicleManager, BridgeRunner, CSV
    teardown) on the Town2 fake server, 300 ticks: the reference schemas,
    the walkers on their routed way, the TrafficManager vehicle moving."""
    from carla_social_force_model_tpu_torch.bridge.carla_bridge import (
        run_with_carla)
    monkeypatch.chdir(tmp_path)
    fake_carla.install_server(fake_carla.Town2Map())
    args = types.SimpleNamespace(
        scenario_config=TOWN2_SCENARIO, carla_host="localhost",
        carla_port=2000, csv=True, output=str(tmp_path / "out"),
        strict_parity=False)
    assert run_with_carla(args, TOWN2_SFM, max_steps=300, pace=False,
                          device=CPU) == 0
    (run_dir,) = (tmp_path / "out").iterdir()
    rows = list(csv.reader(open(run_dir / "pedestrian.csv")))
    assert rows[0] == ["ped_id", "frame", "time", "x", "y", "v_x", "v_y",
                       "mode"]
    xs = np.array([float(r[3]) for r in rows[1:]])
    assert len(rows) > 300 and xs.max() - xs.min() > 10.0
    assert len(list(csv.reader(open(run_dir / "borders.csv")))) > 500
    veh = list(csv.DictReader(open(run_dir / "vehicle.csv")))
    assert len({r["frame"] for r in veh}) == 300
    assert max(float(r["vel"]) for r in veh) > 0.1
    # the cache holds the port's own entries only
    cached = os.listdir(tmp_path / "cache" / "map_geometry")
    assert cached and all(f.startswith("torch_") for f in cached)


def test_run_with_carla_defaults_to_the_card(tmp_path, monkeypatch):
    """Without a card run_with_carla raises before it connects; nothing
    falls back to the CPU."""
    import inspect
    from carla_social_force_model_tpu_torch.bridge.carla_bridge import (
        run_with_carla)
    assert inspect.signature(run_with_carla).parameters["device"].default \
        == "cuda"
    monkeypatch.chdir(tmp_path)
    fake_carla.install_server()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = types.SimpleNamespace(scenario_config=SCENARIO,
                                 carla_host="localhost", carla_port=2000,
                                 csv=False, output=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_with_carla(args, SFM, max_steps=1, pace=False)


def test_random_pedestrians_from_live_nav_mesh(tmp_path, monkeypatch):
    """random_pedestrians over the port's CARLA nav graph draw origins and
    destinations from the server's nav mesh, and a recorded sample set
    replays through nav_mesh_sampler."""
    from carla_social_force_model_tpu_torch.api.scenario import (
        nav_mesh_sampler, random_ped_spawners)
    from carla_social_force_model_tpu_torch.routing.carla_graph import (
        build_carla_nav_graph, make_waypoint_locator)
    from carla_social_force_model_tpu_torch.routing.planner import (
        PedPathPlanner)
    monkeypatch.chdir(tmp_path)
    m, world = fake_carla.install_server(fake_carla.Town2Map())
    world.set_pedestrians_seed(5)
    graph = build_carla_nav_graph(m, waypoint_distance=10.0)
    planner = PedPathPlanner(graph, waypoint_locator=make_waypoint_locator(m))

    def live(rng):
        loc = world.get_random_location_from_navigation()
        return [loc.x, loc.y, loc.z]

    specs = random_ped_spawners(planner, 4, seed=11, location_sampler=live)
    assert len(specs) == 4
    for s in specs:
        assert len(s.waypoints) >= 1
        d = np.linalg.norm(graph.nodes[:, :2] - s.spawn_location[:2], axis=1)
        assert d.min() > 1e-9       # nav-mesh points, not graph nodes
    pts = np.array([[world.get_random_location_from_navigation().x,
                     world.get_random_location_from_navigation().y, 0.0]
                    for _ in range(64)])
    np.save(tmp_path / "navmesh.npy", pts)
    specs2 = random_ped_spawners(planner, 4, seed=11,
                                 location_sampler=nav_mesh_sampler(
                                     str(tmp_path / "navmesh.npy")))
    assert len(specs2) == 4


@pytest.fixture()
def fake_map_dir(tmp_path, monkeypatch):
    fake_carla.install()
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("name", sorted(MAPS))
def test_extract_sidewalk_equals_jax(fake_map_dir, name):
    """The port's sidewalk extraction equals the JAX package's on the same
    fake map, point for point, from a fresh extraction and from each
    package's own cache entry (the names never collide)."""
    from carla_social_force_model_tpu.bridge import extract as jextract
    from carla_social_force_model_tpu_torch.bridge import extract
    fmap = MAPS[name]()
    for _ in range(2):   # extraction, then the cache hit
        lines, centers, lengths = extract.extract_sidewalk(fmap, 0.5)
        jlines, jcenters, jlengths = jextract.extract_sidewalk(fmap, 0.5)
        assert len(lines) == len(jlines) > 0
        for a, b in zip(lines, jlines):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(centers),
                                      np.asarray(jcenters))
        np.testing.assert_array_equal(np.asarray(lengths),
                                      np.asarray(jlengths))
    names = sorted(os.listdir(fake_map_dir / "cache" / "map_geometry"))
    assert len(names) == 2 and names[1].startswith("torch_sidewalk_")
    assert names[0] == names[1][len("torch_"):]


@pytest.mark.parametrize("ellipse", [True, False])
def test_extract_obstacles_equals_jax(fake_map_dir, ellipse):
    """Ellipse and rectangle outlines of the environment objects, with the
    z cutoff, equal to the JAX package's."""
    from carla_social_force_model_tpu.bridge import extract as jextract
    from carla_social_force_model_tpu_torch.bridge import extract
    for z in (0.3, 10.0):
        got = extract.extract_obstacles(_env_world(), 0.25, ellipse, z)
        want = jextract.extract_obstacles(_env_world(), 0.25, ellipse, z)
        assert len(got[0]) == len(want[0]) == (2 if z < 1.0 else 3)
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(MAPS))
def test_carla_nav_graph_equals_jax(fake_map_dir, name):
    """build_carla_nav_graph: nodes, edges, lengths, types and the road
    index equal to the JAX package's graph, and a route over it equal."""
    from carla_social_force_model_tpu.routing import carla_graph as jcg
    from carla_social_force_model_tpu_torch.routing import carla_graph
    fmap = MAPS[name]()
    got = carla_graph.build_carla_nav_graph(fmap, waypoint_distance=10.0)
    want = jcg.build_carla_nav_graph(fmap, waypoint_distance=10.0)
    for f in ("nodes", "edge_u", "edge_v", "edge_length", "edge_type",
              "edge_rsl"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    cached = carla_graph.build_carla_nav_graph(fmap, waypoint_distance=10.0)
    np.testing.assert_array_equal(cached.edge_rsl, want.edge_rsl)
    loc = carla_graph.make_waypoint_locator(fmap)
    jloc = jcg.make_waypoint_locator(fmap)
    for p in ([2.0, -7.5, 0.0], [20.0, 7.0, 0.0]):
        a, b = loc(p), jloc(p)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("name", sorted(MAPS))
def test_carla_driving_graph_equals_jax(fake_map_dir, name):
    """build_carla_driving_graph: the directed driving-lane graph equal to
    the JAX package's (nodes, edges, lengths, spawn points)."""
    from carla_social_force_model_tpu.routing import driving as jdriving
    from carla_social_force_model_tpu_torch.routing import driving
    fmap = MAPS[name]()
    try:
        want = jdriving.build_carla_driving_graph(fmap, waypoint_distance=4.0)
    except ValueError as e:     # a map without driving lanes
        with pytest.raises(ValueError, match=str(e)):
            driving.build_carla_driving_graph(fmap, waypoint_distance=4.0)
        return
    got = driving.build_carla_driving_graph(fmap, waypoint_distance=4.0)
    for f in ("nodes", "edge_u", "edge_v", "edge_length", "spawn_xyz",
              "spawn_yaw"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.num_edges > 0
