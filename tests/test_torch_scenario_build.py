"""PyTorch port: building scenarios (``api/scenario.build_scenario``) and
the driving-lane graph against the JAX package.

Every shipped scenario file is built by both packages from the same TOML;
the port's ``ScenarioBundle`` must equal the JAX package's array for array
(spawn schedule and routes, point sets, scripted vehicles, the reactive
fleet, social groups, per-agent laws and scales), and its step
configuration must be the JAX package's under the engine mapping (the jnp
environment path by default, the fused kernels with ``--pallas``).
"""
import dataclasses
import logging
import os
import time

import numpy as np
import pytest
import torch

from scenario_jax import one_torch_thread  # noqa: F401
from carla_social_force_model_tpu.api import scenario as jscenario
from carla_social_force_model_tpu.routing import driving as jdriving
from carla_social_force_model_tpu_torch.api import scenario as pscenario
from carla_social_force_model_tpu_torch.models.stepper import StepConfig
from carla_social_force_model_tpu_torch.routing import driving as pdriving
from carla_social_force_model_tpu_torch.utils import convert
from carla_social_force_model_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCEN = os.path.join(REPO, "configs", "scenarios")
CPU = "cpu"
#: each shipped scenario with the force configuration its golden uses
SHIPPED = [("corridor_counterflow", None), ("road_crossing", None),
           ("obstacle_evasion", None), ("circle_holding", None),
           ("orthogonal_crossing", None), ("jaywalking_reactive", None),
           ("sidewalk_counterflow", None), ("routed_town", None),
           ("routed_town_walled", None), ("vehicle_evasion", None),
           ("destination_vehicle", None), ("grouped_crossing",
                                           "sfm_groups.toml"),
           ("mixed_crossing", "sfm_mixed.toml"), ("antipodal_circle", None),
           ("overtaking", None)]
#: the Scene fields both packages build (the rest are prepared layouts)
SCENE_FIELDS = ("spawn", "borders", "static_obstacles", "static_obstacle_vel",
                "vehicles", "autopilot", "groups")


def jax_native_astar():
    """The JAX planner searches with its native core, which g++ builds at
    its first use; a worker that loaded the library while another was still
    writing it falls back to the heapq search, which breaks ties otherwise.
    Retry the load until it succeeds."""
    from carla_social_force_model_tpu.routing import astar as jastar
    from carla_social_force_model_tpu.utils import nativelib
    for _ in range(20):
        if jastar._load_native() is not None:
            return
        nativelib._CACHE.pop("astar", None)
        time.sleep(0.5)


def fields_of(obj):
    """A JAX-package object as nested dicts of numpy arrays and Python
    values (lists element by element)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [fields_of(a) for a in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def assert_same(got, want, name):
    """A port value (dataclass, tensor, array, list, scalar) against the
    JAX package's flattened one, exactly."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            assert_same(getattr(got, f.name), want[f.name],
                        f"{name}.{f.name}")
    elif got is None:
        assert want is None, name
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), name
        for k, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{name}[{k}]")
    elif isinstance(got, (bool, int, float, str)):
        assert got == want, name
    else:
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_array_equal(g, want, err_msg=name)


def both(scen, sfm=None, num_steps=300, engine=None, config=None):
    jax_native_astar()
    path = config if config is not None else os.path.join(SCEN,
                                                          f"{scen}.toml")
    sfm = os.path.join(REPO, "configs", sfm or "sfm.toml")
    jb = jscenario.build_scenario(path, sfm, num_steps, engine=engine)
    pb = pscenario.build_scenario(path, sfm, num_steps, engine=engine,
                                  device=CPU)
    return jb, pb


def assert_bundles_equal(jb, pb):
    for name in SCENE_FIELDS:
        assert_same(getattr(pb.scene, name), fields_of(getattr(jb.scene, name)),
                    name)
    assert_same(pb.initial_state, fields_of(jb.initial_state), "state")
    assert_same(pb.params, fields_of(jb.params), "params")
    for name in ("num_steps", "dt", "scenario_name"):
        assert getattr(pb, name) == getattr(jb, name), name
    for name in ("border_lines", "obstacle_outlines", "obstacle_centers"):
        assert_same(getattr(pb, name), fields_of(getattr(jb, name)), name)
    assert pb.cfg == convert.step_config_from_fields(fields_of(jb.cfg),
                                                     engine_path=True)


@pytest.mark.parametrize("scen,sfm", SHIPPED)
def test_bundle_equals_jax(scen, sfm):
    """The port's bundle of a shipped file equals the JAX package's, array
    for array, on the jnp environment path."""
    jb, pb = both(scen, sfm)
    assert_bundles_equal(jb, pb)
    assert pb.cfg.env_chunked and pb.cfg.interaction_cutoff is None
    assert pb.scene.spawn.step.device.type == CPU


def test_engine_mapping(caplog):
    """``--pallas`` runs the fused kernels with the cutoff and the env
    knobs; a cutoff or an env knob without it is dropped with the JAX
    package's warning (the JAX package ignores them there); a TPU launch
    knob raises, and ``axis_comm`` carries over."""
    scen = "sidewalk_counterflow"
    knobs = {"interaction_cutoff": 30.0, "env_compact": True,
             "env_max_surv": 4, "pallas_symmetric": False}
    jb, pb = both(scen, num_steps=40, engine=dict(knobs, use_pallas=True))
    assert_bundles_equal(jb, pb)
    wt = {"waypoint_threshold": 1.0}      # the file's
    assert pb.cfg == StepConfig(interaction_cutoff=30.0, env_compact=True,
                                env_max_surv=4, symmetric_pairs=False, **wt)
    with caplog.at_level(logging.WARNING,
                         logger="carla_social_force_model_tpu_torch"):
        jb, pb = both(scen, num_steps=40, engine=knobs)
    assert_bundles_equal(jb, pb)
    assert pb.cfg == StepConfig(env_chunked=True, symmetric_pairs=False,
                                **wt)
    said = " ".join(r.getMessage() for r in caplog.records)
    assert "interaction_cutoff only takes effect" in said
    assert "env_compact only takes effect" in said
    jb, pb = both(scen, num_steps=40, engine={"use_pallas": True,
                                              "env_analytic": True})
    assert pb.cfg.env_analytic and not pb.cfg.env_chunked
    path = os.path.join(SCEN, f"{scen}.toml")
    sfm = os.path.join(REPO, "configs", "sfm.toml")
    for engine in ({"pallas_exact_div": True}, {"pallas_vmem_mb": 64},
                   {"env_point_tile": 256}):
        with pytest.raises(ValueError, match="no counterpart"):
            pscenario.build_scenario(path, sfm, 40, engine=engine,
                                     device=CPU)
    pscenario.build_scenario(path, sfm, 40, device=CPU, engine={
        "pallas_exact_div": False, "pallas_vmem_mb": 32, "axis_comm":
        "gather"})
    for comm in ("ring", "ring_kernel"):
        pb = pscenario.build_scenario(path, sfm, 40, device=CPU,
                                      engine={"axis_comm": comm})
        assert pb.cfg.axis_comm == comm


def test_random_pedestrians_on_town_routes_equal_jax():
    """``walker.random_pedestrians`` on the Town02 nav graph: the random
    origins, destinations and A* routes of 20 walkers (the port's A*
    follows the JAX package's native core) and the full Town02 borders."""
    cfg = load_config(os.path.join(SCEN, "routed_town.toml"))
    cfg["map"] = {
        "nav_graph_npz": os.path.join(REPO, "configs", "data",
                                      "town2_navgraph.npz"),
        "sidewalk_borders_npz": os.path.join(REPO, "configs", "data",
                                             "town2_sidewalks_full.npz")}
    cfg["walker"]["random_pedestrians"] = 20
    jb, pb = both(None, num_steps=60, config=cfg)
    assert_bundles_equal(jb, pb)
    assert pb.capacity == 4 + 20     # 4 of the file's walkers by step 60
    assert pb.scene.borders.num_segments == 38


def test_scenario_bundle_from_fields_steps_like_the_port_bundle():
    """The JAX bundle carried over by utils/convert.py gives the port's own
    bundle's first steps bitwise."""
    from carla_social_force_model_tpu_torch.models import stepper
    jb, pb = both("vehicle_evasion", num_steps=20)
    cb = convert.scenario_bundle_from_fields(fields_of(jb), CPU)
    assert cb.cfg == pb.cfg
    _, want = stepper.make_rollout_fn(pb.scene, pb.params, pb.cfg,
                                      20)(pb.initial_state)
    _, got = stepper.make_rollout_fn(cb.scene, cb.params, cb.cfg,
                                     20)(cb.initial_state)
    for got_rec, want_rec in zip(got, want):   # walkers, then the fleet
        for g, w in zip(got_rec, want_rec):
            assert torch.equal(g, w)


def test_step_config_engine_path_keyword():
    """``step_config_from_fields`` keeps every knob by default (the earlier
    parity tests' path) and maps the JAX package's path only when asked."""
    from carla_social_force_model_tpu.models.stepper import (
        StepConfig as JaxStepConfig)
    jc = JaxStepConfig(interaction_cutoff=30.0, env_analytic=True)
    d = fields_of(jc)
    assert convert.step_config_from_fields(d) == StepConfig(
        interaction_cutoff=30.0, env_analytic=True)
    assert convert.step_config_from_fields(d, engine_path=True) == \
        StepConfig(env_chunked=True)
    d = fields_of(dataclasses.replace(jc, use_pallas=True))
    assert convert.step_config_from_fields(d, engine_path=True) == \
        StepConfig(interaction_cutoff=30.0, env_analytic=True)
    d = fields_of(dataclasses.replace(jc, use_pallas=True,
                                      use_pallas_env=False))
    assert convert.step_config_from_fields(d, engine_path=True) == \
        StepConfig(interaction_cutoff=30.0, env_chunked=True)


def test_driving_graph_equals_jax():
    """The driving-lane graph capture, its A* routes, lane adjacency and
    spawn transforms, against the JAX package's module."""
    path = os.path.join(REPO, "configs", "data", "town2_driving.npz")
    jg, pg = jdriving.DrivingGraph.load_npz(path), \
        pdriving.DrivingGraph.load_npz(path)
    for name in ("nodes", "edge_u", "edge_v", "edge_length", "spawn_xyz",
                 "spawn_yaw"):
        np.testing.assert_array_equal(getattr(pg, name), getattr(jg, name))
    rng = np.random.default_rng(3)
    lo, hi = pg.nodes[:, :2].min(0), pg.nodes[:, :2].max(0)
    routes = 0
    for _ in range(12):
        a, b = rng.uniform(lo, hi), rng.uniform(lo, hi)
        try:
            want = jg.route(a, b)
        except ValueError:
            with pytest.raises(ValueError):
                pg.route(a, b)
            continue
        got = pg.route(a, b)
        np.testing.assert_array_equal(got, want)
        for g, w in zip(pg.lane_adjacency(got[:, :2]),
                        jg.lane_adjacency(want[:, :2])):
            np.testing.assert_array_equal(g, w)
        routes += 1
    assert routes >= 3
    for k in range(len(pg.spawn_xyz)):
        for g, w in zip(pg.spawn_transform(k), jg.spawn_transform(k)):
            np.testing.assert_array_equal(g, w)
    builder = pdriving.DrivingGraphBuilder()
    builder.add_chain([[0, 0, 0], [10, 0, 0], [20, 0, 0]])
    g = builder.build()
    assert g.num_nodes == 3 and g.num_edges == 2
