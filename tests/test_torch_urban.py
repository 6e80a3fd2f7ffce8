"""PyTorch port: the urban slice (BASELINE config #4: nav-graph routes, the
reactive autopilot fleet, gap-acceptance crossing, the compacted
environment kernels) against the JAX package.

Inputs are drawn with numpy from a seed and fed to both packages.  The JAX
package runs its jnp path on the CPU (``use_pallas=False``) and, for the
compacted environment grid, its Pallas kernels in interpret mode, as its
own tests do; the port runs its plain PyTorch versions (on the CPU the
kernel wrappers take them).  The CUDA kernels are held against those plain
versions, and against the dense kernels bitwise, on the card
(``tests/test_torch_cuda.py``).
"""
import dataclasses
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from carla_social_force_model_tpu.api import synthetic as jsyn
from carla_social_force_model_tpu.env.borders import (
    build_border_set as jbuild_border_set)
from carla_social_force_model_tpu.models import autopilot as jap
from carla_social_force_model_tpu.models import spawn as jspawn
from carla_social_force_model_tpu.models import stepper as jstepper
from carla_social_force_model_tpu.models.params import (
    SfmParams as JaxSfmParams)
from carla_social_force_model_tpu.models.state import PedState as JaxPedState
from carla_social_force_model_tpu.ops import pallas_env as jpallas_env
from carla_social_force_model_tpu.ops import spatial as jspatial
from carla_social_force_model_tpu.routing import graph as jgraph
from carla_social_force_model_tpu.routing.planner import (
    PedPathPlanner as JaxPlanner)
from carla_social_force_model_tpu_torch.api import synthetic as psyn
from carla_social_force_model_tpu_torch.env.borders import build_border_set
from carla_social_force_model_tpu_torch.env.pointsets import segment_major
from carla_social_force_model_tpu_torch.models import autopilot as pap
from carla_social_force_model_tpu_torch.models import modes, stepper
from carla_social_force_model_tpu_torch.models.params import SfmParams
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.ops import cuda_env, env_grid
from carla_social_force_model_tpu_torch.ops.spatial import morton_order
from carla_social_force_model_tpu_torch.routing import (
    EdgeType, GraphType, NavGraphBuilder, PedPathPlanner)
from carla_social_force_model_tpu_torch.utils import convert

CPU = "cpu"
DT = 0.05
#: the small urban scene of tests/test_urban.py
URBAN_KW = dict(n_routes=8, n_roads=3, width=200.0, cross_spacing=80.0,
                vehicles_per_road=1)


@pytest.fixture(autouse=True, scope="module")
def jax_native_astar():
    """The JAX planner searches with its native core, which g++ builds at
    its first use.  A test worker that loaded the library while another
    was still writing it falls back to the heapq search for good, and the
    two break ties differently; so retry the load until it succeeds."""
    from carla_social_force_model_tpu.routing import astar as jastar
    from carla_social_force_model_tpu.utils import nativelib
    for _ in range(20):
        if jastar._load_native() is not None:
            return
        nativelib._CACHE.pop("astar", None)
        time.sleep(0.5)


def fields_of(obj):
    """A JAX-package dataclass as nested dicts of numpy arrays and Python
    values (what utils/convert.py takes)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def assert_fields_equal(got, want):
    """A port dataclass against the JAX one, field by field (nested ones
    too), exactly."""
    _assert_fields(got, fields_of(want))


def _assert_fields(got, want):
    for f in dataclasses.fields(got):
        g = getattr(got, f.name)
        if dataclasses.is_dataclass(g):
            _assert_fields(g, want[f.name])
        elif g is None:
            assert want[f.name] is None, f.name
        else:
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_array_equal(g, want[f.name], err_msg=f.name)


# -- graph and routes -----------------------------------------------------------

def build_street_graph(builder_cls, edge_type, n_roads=3, width=200.0,
                       cross_spacing=80.0, jaywalks=True):
    """The urban bundle's street grid (by default 3 roads, crosswalks and
    block connectors every 80 m) plus, with ``jaywalks``, mid-block
    jaywalking edges, sidewalk-to-road edges and a junction jaywalk, built
    with either package's builder."""
    b = builder_cls()
    xs = np.arange(0.0, width + 1e-6, 20.0)
    cross_xs = np.arange(cross_spacing, width - 1e-6, cross_spacing)
    road_ys = np.arange(n_roads, dtype=np.float64) * 60.0
    for y in road_ys:
        for off in (-6.0, 6.0):
            b.add_polyline([np.array([x, y + off, 0.0]) for x in xs],
                           edge_type.SIDEWALK)
        for x in cross_xs:
            b.add_edge([x, y - 6.0, 0.0], [x, y + 6.0, 0.0],
                       edge_type.CROSSWALK)
        if not jaywalks:
            continue
        for x in (20.0, 140.0):
            b.add_edge([x, y - 6.0, 0.0], [x, y + 6.0, 0.0],
                       edge_type.JAYWALKING)
        b.add_edge([180.0, y - 6.0, 0.0], [200.0, y + 6.0, 0.0],
                   edge_type.JAYWALKING_JUNCTION)
        b.add_edge([100.0, y + 6.0, 0.0], [100.0, y + 2.0, 0.0],
                   edge_type.SIDEWALK_TO_ROAD)
    for y0, y1 in zip(road_ys[:-1], road_ys[1:]):
        ys = np.append(np.arange(y0 + 6.0, y1 - 6.0 + 1e-6, 20.0), y1 - 6.0)
        for x in cross_xs:
            b.add_polyline([np.array([x, yy, 0.0]) for yy in ys],
                           edge_type.SIDEWALK)
    return b.build()


def test_nav_graph_and_csr_equal_jax():
    pg = build_street_graph(NavGraphBuilder, EdgeType)
    jg = build_street_graph(jgraph.NavGraphBuilder, jgraph.EdgeType)
    for name in ("nodes", "edge_u", "edge_v", "edge_length", "edge_type"):
        np.testing.assert_array_equal(getattr(pg, name), getattr(jg, name))
    assert pg.edge_rsl is None and jg.edge_rsl is None
    for a, b in zip(pg.csr(), jg.csr()):
        np.testing.assert_array_equal(a, b)
    for gt in GraphType:
        assert pg.allowed_mask(gt) == jg.allowed_mask(jgraph.GraphType(gt))
        np.testing.assert_array_equal(
            pg.nodes_in_subgraph(gt),
            jg.nodes_in_subgraph(jgraph.GraphType(gt)))


@pytest.mark.parametrize("graph_type", list(GraphType), ids=lambda g: g.name)
def test_routes_equal_jax(graph_type):
    """Seeded origin/destination pairs, including off-graph points: equal
    waypoints and crossing flags.  The JAX planner searches with its native
    core where g++ builds it (the port follows that core's tie-breaking;
    the JAX package's heapq fallback breaks ties otherwise)."""
    pg = build_street_graph(NavGraphBuilder, EdgeType)
    jg = build_street_graph(jgraph.NavGraphBuilder, jgraph.EdgeType)
    pp, jp = PedPathPlanner(pg), JaxPlanner(jg)
    rng = np.random.default_rng(int(graph_type))
    pts = np.column_stack([rng.uniform(-5.0, 205.0, (60, 1)),
                           rng.uniform(-10.0, 130.0, (60, 1))])
    crossings = 0
    for k in range(0, 60, 2):
        got = pp.generate_route(pts[k], pts[k + 1], graph_type)
        want = jp.generate_route(pts[k], pts[k + 1],
                                 jgraph.GraphType(graph_type))
        assert len(got) == len(want), k
        for (gw, gc), (ww, wc) in zip(got, want):
            np.testing.assert_array_equal(gw, ww)
            assert gc == wc
        crossings += sum(c for _, c in got)
    assert crossings > 0


@pytest.mark.parametrize("n_roads,width,cross_spacing,differ", [
    (8, 600.0, 100.0, 29), (3, 200.0, 80.0, 21)])
def test_jax_heapq_fallback_breaks_ties_otherwise(n_roads, width,
                                                  cross_spacing, differ):
    """On the urban grid the JAX package's two searches (its native core
    and its heapq fallback) find equal-cost routes that differ in about 1
    of 10 draws (29 and 21 of 300): the port follows the native core, which the JAX package runs
    wherever g++ builds it.  300 seeded draws between sidewalk nodes of
    different roads, as the urban bundle draws them."""
    kw = dict(n_roads=n_roads, width=width, cross_spacing=cross_spacing,
              jaywalks=False)
    jg = build_street_graph(jgraph.NavGraphBuilder, jgraph.EdgeType, **kw)
    native, heapq_ = JaxPlanner(jg), JaxPlanner(jg, use_native=False)
    if not native.router.native:
        pytest.skip("the JAX package's native A* did not build here")
    port = PedPathPlanner(build_street_graph(NavGraphBuilder, EdgeType,
                                             **kw))
    xs = np.arange(0.0, width + 1e-6, 20.0)
    side = [(i, np.array([x, 60.0 * i + off, 0.0])) for i in range(n_roads)
            for off in (-6.0, 6.0) for x in xs]
    rng = np.random.default_rng(0)

    def key(route):
        return [(tuple(w), c) for w, c in route]

    seen = other = 0
    while seen < 300:
        a, b = rng.integers(len(side)), rng.integers(len(side))
        if side[a][0] == side[b][0]:
            continue
        seen += 1
        want = key(native.generate_route(side[a][1], side[b][1]))
        assert key(port.generate_route(side[a][1], side[b][1])) == want
        other += key(heapq_.generate_route(side[a][1], side[b][1])) != want
    assert other == differ


def test_urban_routes_equal_jax_native_search():
    """The bundle's own route draw on the full-size grid (8 roads, 600 m):
    the planner the urban bundle builds gives the JAX planner's routes."""
    scene_p, *_ = psyn.urban_bundle(64, device=CPU)
    scene_j, *_ = jsyn.urban_bundle(64, use_pallas=False)
    assert_fields_equal(scene_p.spawn.routes, scene_j.spawn.routes)


# -- the bundle -----------------------------------------------------------------

@pytest.fixture(scope="module")
def bundles():
    steps = 40
    j = jsyn.urban_bundle(48, num_steps_hint=steps, use_pallas=False,
                          **URBAN_KW)
    p = psyn.urban_bundle(48, num_steps_hint=steps, device=CPU, **URBAN_KW)
    return j, p


def test_urban_bundle_equals_jax(bundles):
    (js, jp, jc, jst), (ps, pp, pc, pst) = bundles
    assert_fields_equal(ps.spawn, js.spawn)
    assert_fields_equal(ps.borders, js.borders)
    assert_fields_equal(ps.autopilot, js.autopilot)
    assert ps.vehicles is None and js.vehicles is None
    assert pp == convert.params_from_fields(fields_of(jp))
    assert pc == convert.step_config_from_fields(fields_of(jc))
    assert pc.env_compact and pc.env_max_surv == 0
    assert_fields_equal(pst, jst)
    assert ps.autopilot.num_vehicles == js.autopilot.num_vehicles == 3


# -- the fleet build ------------------------------------------------------------

def fleet_specs(module, overtake_ok):
    """Three spawners: a slow overtaking-capable looping ring, a bus with a
    fixed blueprint and explicit pass legality, and a quantity-3 stream."""
    ring = np.array([[0.0, 0.0], [80.0, 0.0], [80.0, 4.0], [0.0, 4.0]])
    line = np.array([[-20.0, -3.0], [40.0, -3.0], [120.0, -3.0]])
    return [
        module.AutopilotSpec(waypoints=ring, speed_reduction_factor=20.0,
                             ignore_walkers_percentage=40.0,
                             ignore_lights_percentage=60.0, loop=True,
                             overtake=True, spawn_interval=1.0, quantity=2),
        module.AutopilotSpec(waypoints=line, blueprint="vehicle.bus",
                             extent=(5.0, 1.4), overtake=True,
                             overtake_ok=overtake_ok, spawn_time=0.3,
                             ignore_walkers_percentage=90.0),
        module.AutopilotSpec(waypoints=line[::-1], spawn_time=0.1,
                             spawn_interval=0.5, quantity=3,
                             ignore_lights_percentage=100.0),
    ]


@pytest.mark.parametrize("case", ["plain", "variate", "blueprints",
                                  "lights", "overtake_ok", "none"])
def test_fleet_build_equals_jax(case):
    ok = (np.array([True, False, True]) if case == "overtake_ok" else None)
    kw = dict(vehicle_seed=31)
    if case == "variate":
        kw["variate_speed_factor"] = 12.5
    if case == "blueprints":
        kw.update(variate_speed_factor=5.0,
                  blueprint_count=pap.VEHICLE_BLUEPRINT_COUNT_NO_BIKES)
    num_steps = 2 if case == "none" else 60
    specs = fleet_specs(pap, ok)
    jspecs = fleet_specs(jap, ok)
    if case == "none":
        for s, j in zip(specs, jspecs):
            s.spawn_time = j.spawn_time = 10.0
    lights = None
    if case == "lights":
        lights = [(np.array([30.0, -3.0]), 4.0, 6.0, 1.0),
                  (np.array([60.0, 0.0]), 5.0, 5.0, 0.0)]
        kw["traffic_lights"] = [pap.TrafficLightSpec(*a) for a in lights]
    got = pap.build_autopilot_fleet(specs, DT, num_steps, device=CPU, **kw)
    if lights is not None:
        kw["traffic_lights"] = [jap.TrafficLightSpec(*a) for a in lights]
    want = jap.build_autopilot_fleet(jspecs, DT, num_steps, **kw)
    if case == "none":
        assert got is None and want is None
        return
    assert_fields_equal(got, want)
    assert got.num_vehicles == want.num_vehicles == 6
    if case == "lights":
        assert got.ignore_lights is not None
    init = got.initial_state()
    assert_fields_equal(init, want.initial_state())


def test_fleet_build_rejects_misaligned_overtake_ok():
    with pytest.raises(ValueError, match="overtake_ok length"):
        pap.build_autopilot_fleet(fleet_specs(pap, np.array([True])), DT, 20,
                                  device=CPU)


# -- one autopilot step ----------------------------------------------------------

#: one fleet step on the route (-50, 0) -> (200, 0) -> (200, 40): vehicles
#: (x, y, speed, heading, wp_idx, lane_off, overtaking, active), walkers
#: (x, y, vx, vy, alive), spec keywords (and traffic lights), step
STEP_CASES = {
    "walker_in_corridor": (
        [(0.0, 0.0, 5.0, 0.0, 1, 0.0, False, True)],
        [(8.0, 0.5, 0.0, 0.0, True), (6.0, -0.4, 0.0, 0.0, False)], {}, 7),
    "walker_stepping_in": (
        [(0.0, 0.0, 5.0, 0.0, 1, 0.0, False, True)],
        [(8.0, 3.0, 0.0, -1.5, True)], {}, 7),
    "walker_ignored": (
        [(0.0, 0.0, 5.0, 0.0, 1, 0.0, False, True)],
        [(8.0, 0.5, 0.0, 0.0, True)], dict(ignore_walkers_percentage=100.0),
        7),
    "leader": (
        [(0.0, 0.0, 6.0, 0.0, 1, 0.0, False, True),
         (9.0, 0.2, 2.0, 0.0, 1, 0.0, False, True)], [], {}, 3),
    "overtake_start": (
        [(0.0, 0.0, 6.0, 0.0, 1, 0.0, False, True),
         (9.0, 0.0, 1.0, 0.0, 1, 0.0, False, True)], [],
        dict(overtake=True), 3),
    "overtake_blocked_by_walker": (
        [(0.0, 0.0, 6.0, 0.0, 1, 0.0, False, True),
         (9.0, 0.0, 1.0, 0.0, 1, 0.0, False, True)],
        [(20.0, 3.4, 0.0, 0.0, True)], dict(overtake=True), 3),
    "overtake_pass": (
        [(8.0, 3.5, 7.0, 0.0, 1, 3.5, True, True),
         (9.0, 0.0, 1.0, 0.0, 1, 0.0, False, True)], [],
        dict(overtake=True), 4),
    "overtake_merge": (
        [(30.0, 3.5, 7.0, 0.0, 1, 3.5, True, True),
         (9.0, 0.0, 1.0, 0.0, 1, 0.0, False, True)], [],
        dict(overtake=True), 4),
    "red_light": (
        [(0.0, 0.0, 5.0, 0.0, 1, 0.0, False, True)], [],
        dict(lights=[(np.array([9.0, 0.3]), 5.0, 5.0, 0.5)]), 30),
    "green_light": (
        [(0.0, 0.0, 5.0, 0.0, 1, 0.0, False, True)], [],
        dict(lights=[(np.array([9.0, 0.3]), 5.0, 5.0, 0.5)]), 130),
    "spawn_this_step": (
        [(-50.0, 0.0, 0.0, 0.0, 1, 0.0, False, False)],
        [(-30.0, 6.0, 0.0, 0.0, True)], {}, 0),
    "waypoint_reached": (
        [(199.8, 0.0, 5.0, 0.0, 1, 0.0, False, True)], [], {}, 9),
    "route_end_parks": (
        [(200.0, 39.9, 5.0, 1.5707964, 2, 0.0, False, True)], [], {}, 9),
    "route_end_loops": (
        [(200.0, 39.9, 5.0, 1.5707964, 2, 0.0, False, True)], [],
        dict(loop=True), 9),
}


def _step_inputs(case):
    vehicles, walkers, fleet_kw, t_idx = STEP_CASES[case]
    fleet_kw = dict(fleet_kw)
    lights = fleet_kw.pop("lights", None)
    fleets = []
    for module in (pap, jap):
        specs = [module.AutopilotSpec(
            waypoints=np.array([[-50.0, 0.0], [200.0, 0.0], [200.0, 40.0]]),
            speed_reduction_factor=0.0, **fleet_kw)
            for _ in range(len(vehicles))]
        kw = {}
        if lights is not None:
            kw["traffic_lights"] = [module.TrafficLightSpec(*a)
                                    for a in lights]
        if module is pap:
            kw["device"] = CPU
        fleets.append(module.build_autopilot_fleet(specs, DT, 10, **kw))
    arr = np.asarray(vehicles, np.float64)
    state = dict(pos=arr[:, :2].astype(np.float32),
                 speed=arr[:, 2].astype(np.float32),
                 heading=arr[:, 3].astype(np.float32),
                 wp_idx=arr[:, 4].astype(np.int32),
                 lane_off=arr[:, 5].astype(np.float32),
                 overtaking=arr[:, 6].astype(bool),
                 active=arr[:, 7].astype(bool))
    rng = np.random.default_rng(len(case))
    far = np.column_stack([rng.uniform(-60, 220, 40), rng.uniform(10, 50, 40),
                           rng.uniform(-1, 1, (40, 2)),
                           rng.uniform(size=40) < 0.8])
    w = np.vstack([np.asarray(walkers, np.float64).reshape(-1, 5), far])
    walk = dict(pos=w[:, :2].astype(np.float32),
                vel=w[:, 2:4].astype(np.float32), alive=w[:, 4] > 0.5)
    return fleets, state, walk, t_idx


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_autopilot_step_equals_jax(case):
    """One fleet step from the same seeded state: every field equal (bool
    and int exactly, floats within 1e-6), and the case's behaviour shows
    (a brake, a pass, a merge, a light, a spawn, a waypoint, a loop)."""
    (pfleet, jfleet), st, walk, t_idx = _step_inputs(case)
    pst = pap.AutopilotState(**{k: torch.from_numpy(v)
                                for k, v in st.items()})
    jst = jap.AutopilotState(**{k: jnp.asarray(v) for k, v in st.items()})
    got = pap.autopilot_step(
        pfleet, pst,
        (torch.from_numpy(walk["pos"][:, 0]),
         torch.from_numpy(walk["pos"][:, 1])),
        torch.from_numpy(walk["vel"]), torch.from_numpy(walk["alive"]),
        t_idx, DT)
    want = jap.autopilot_step(jfleet, jst, jnp.asarray(walk["pos"]),
                              jnp.asarray(walk["vel"]),
                              jnp.asarray(walk["alive"]), t_idx, DT)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    speed0, speed1 = st["speed"][0], got.speed[0].item()
    braking = speed1 < speed0
    expect = {
        "walker_in_corridor": braking, "walker_stepping_in": braking,
        "walker_ignored": not braking, "leader": braking,
        "overtake_start": bool(got.overtaking[0]) and got.lane_off[0] > 0,
        "overtake_blocked_by_walker": not bool(got.overtaking[0]),
        "overtake_pass": bool(got.overtaking[0]),
        "overtake_merge": not bool(got.overtaking[0])
        and got.lane_off[0] < 3.5,
        "red_light": braking, "green_light": not braking,
        "spawn_this_step": bool(got.active[0]) and speed1 > 0,
        "waypoint_reached": got.wp_idx[0].item() == 2,
        "route_end_parks": not bool(got.active[0]),
        "route_end_loops": bool(got.active[0]) and got.wp_idx[0].item() == 0,
    }[case]
    assert expect, case
    snap_p = pap.autopilot_snapshot(pfleet, got)
    snap_j = jap.autopilot_snapshot(jfleet, want)
    for name in ("center", "vel", "heading", "extent", "active", "template",
                 "template_valid"):
        np.testing.assert_allclose(getattr(snap_p, name).numpy(),
                                   np.asarray(getattr(snap_j, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


# -- the compacted environment grid --------------------------------------------

def _grid_borders(builder):
    """tests/test_env_pallas.py's many short wall sections, three rows far
    apart: enough groups for the compacted grid to engage."""
    lines, centers, lengths = [], [], []
    for y in np.linspace(-200.0, 200.0, 3):
        for k in range(40):
            x0 = -200.0 + k * 10.0
            xs = np.arange(x0, x0 + 10.0, 0.1)
            lines.append(np.column_stack([xs, np.full(len(xs), y)]))
            centers.append(lines[-1][len(xs) // 2])
            lengths.append(12.0)
    return builder(lines, centers, lengths)


def _clustered(n):
    """tests/test_env_pallas.py's clustered crowd (n = 97), or a larger one
    spread over the middle wall row and the outer rows."""
    rng = np.random.default_rng(5)
    if n == 97:
        pos = np.column_stack([rng.uniform(-30, 30, n), rng.uniform(-6, 6, n)])
    else:
        pos = np.column_stack([rng.uniform(-190, 190, n),
                               rng.choice([-200.0, 0.0, 200.0], n)
                               + rng.uniform(-6, 6, n)])
    vel = rng.uniform(-2, 2, (n, 2))
    alive = rng.uniform(size=n) > 0.1
    return (pos.astype(np.float32), vel.astype(np.float32),
            np.full(n, 0.3, np.float32), alive)


def _jax_state(pos, vel, radius, alive, mode=None):
    n = pos.shape[0]
    return JaxPedState.empty(n).replace_coords(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel), radius=jnp.asarray(radius),
        alive=jnp.asarray(alive),
        mode=jnp.asarray(np.full(n, modes.WALKING_SIDEWALK, np.int32)
                         if mode is None else mode))


def _port_state(pos, vel, radius, alive, mode=None):
    n = pos.shape[0]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return dataclasses.replace(
        PedState.empty(n, device=CPU), pos_x=t(pos[:, 0]), pos_y=t(pos[:, 1]),
        vel_x=t(vel[:, 0]), vel_y=t(vel[:, 1]), radius=t(radius),
        alive=t(alive),
        mode=t(np.full(n, modes.WALKING_SIDEWALK, np.int32)
               if mode is None else mode))


@pytest.mark.parametrize("n", [97, 700])
def test_env_plan_equals_jax_tile_hits_and_table(n):
    """Boxes, (blocks, groups) hits, survivor table and counts of
    ops/env_grid.py against the JAX package's staging, ``_tile_hits`` and
    ``surv_table`` at its ped tile of 128 and group of 8 sections."""
    pos, vel, radius, alive = _clustered(n)
    jstate = _jax_state(pos, vel, radius, alive)
    jseg = jstepper.prepare_scene(jstepper.Scene(
        spawn=None, borders=_grid_borders(jbuild_border_set))).borders_seg
    seg = segment_major(_grid_borders(build_border_set), CPU)
    engage, group, ms = env_grid.env_gate(seg.num_segments,
                                          seg.points_per_segment, True, 0)
    assert (engage, group, ms) == (True, 8, 8)

    (spx, spy, salive), _ = jspatial.morton_sort(
        (jstate.pos_x, jstate.pos_y), jstate.alive,
        (jstate.pos_x, jstate.pos_y, jstate.alive), order="hilbert")
    n_pad = -(-n // 128) * 128
    px = jpallas_env._stage_lane(spx, 1e8, salive, n_pad)
    py = jpallas_env._stage_lane(spy, 1e8, salive, n_pad)
    alive_pad = jnp.zeros((n_pad,), bool).at[:n].set(salive)
    jbb = jspatial.tile_bboxes(px, py, alive_pad, 128).T
    s_pad = -(-jseg.num_segments // 8) * 8
    circ = jnp.concatenate(
        [jpallas_env._stage_seg_plane(jseg.centers[:, 0], 1e8, s_pad),
         jpallas_env._stage_seg_plane(jseg.centers[:, 1], 1e8, s_pad),
         jpallas_env._stage_seg_plane(
             jnp.maximum(jseg.filter_radius, 0.0) ** 2, -1.0, s_pad)],
        axis=1).T
    jhits = jpallas_env._tile_hits(jbb, circ, 8, s_pad // 8)
    jsurv, jfits = jspatial.surv_table(jhits, ms)

    perm, _ = morton_order(torch.from_numpy(pos[:, 0]),
                           torch.from_numpy(pos[:, 1]),
                           torch.from_numpy(alive), "hilbert")
    x, y, live = (torch.from_numpy(a)[perm] for a in
                  (pos[:, 0], pos[:, 1], alive))
    boxes = env_grid.block_boxes(x, y, live)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jbb))
    r2 = cuda_env.filter_r2(seg)
    hits = env_grid.group_hits(boxes, seg.center_x, seg.center_y, r2, group)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    grid = env_grid.env_grid(x, y, live, seg, r2, group, ms)
    np.testing.assert_array_equal(grid.surv.numpy(), np.asarray(jsurv))
    np.testing.assert_array_equal(grid.counts.numpy(),
                                  np.asarray(jhits).sum(axis=1))
    assert bool(jfits) == bool((grid.counts <= ms).all())
    assert grid.counts.sum().item() > 0


@pytest.mark.parametrize("shape,expect", [
    ((320, 384, True, 0), (True, 8, 14)),     # urban borders: 40 groups
    ((169, 70, True, 0), (True, 8, 8)),       # config #3 parked cars
    ((16, 128, True, 0), (False, 8, 2)),      # urban fleet outlines
    ((154, 384, True, 0), (True, 8, 8)),      # config #3 borders
    ((16, 128, True, 1), (True, 8, 1)),       # explicit env_max_surv
    ((320, 384, False, 0), (False, 8, 14)),   # env_compact off
    ((200, 40, True, 0), (True, 16, 8)),      # short rows: groups of 16
])
def test_env_gate_is_the_jax_gate(shape, expect):
    """The static gate of pallas_env.py:584-589 at the JAX package's
    default env_point_tile of 512."""
    s, kk, compact, max_surv = shape
    gs_c = jpallas_env._round_up(max(1, 512 // kk), 8)
    n_tiles_c = jpallas_env._round_up(s, gs_c) // gs_c
    ms = max_surv if max_surv > 0 else min(
        n_tiles_c, max(8, -(-n_tiles_c // 3)))
    assert (compact and n_tiles_c > ms, gs_c, ms) == expect
    assert env_grid.env_gate(s, kk, compact, max_surv) == expect


@pytest.mark.parametrize("max_surv", [0, 1])
@pytest.mark.parametrize("n", [97, 700])
def test_compact_terms_match_jax_compact_grid(monkeypatch, n, max_surv):
    """The port's fused terms with ``compact`` against the JAX package's
    compacted Pallas grid in interpret mode (ped tile 128), with the auto
    table and with one slot (every block overflows): the border and space
    terms within the environment tolerance, through the compacted
    wrappers."""
    pos, vel, radius, alive = _clustered(n)
    mode = np.random.default_rng(3).integers(0, 5, n).astype(np.int32)
    jscene = jstepper.prepare_scene(jstepper.Scene(
        spawn=None, borders=_grid_borders(jbuild_border_set)))
    pscene = stepper.prepare_scene(stepper.Scene(
        spawn=psyn.synthetic_crowd(n, device=CPU),
        borders=_grid_borders(build_border_set)))
    kw = dict(enable_border=True, enable_space_repulsive=True,
              use_ped_radius=True)
    want = jpallas_env.fused_environment_terms(
        _jax_state(pos, vel, radius, alive, mode), jscene, JaxSfmParams(**kw),
        None, ped_tile=128, interpret=True, compact=True, max_surv=max_surv)
    calls = []
    real = cuda_env.env_exp_compact

    def spy(*args, **kwargs):
        calls.append(args[7])
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_env, "env_exp_compact", spy)
    got = cuda_env.fused_environment_terms(
        _port_state(pos, vel, radius, alive, mode), pscene, SfmParams(**kw),
        None, compact=True, max_surv=max_surv)
    assert len(calls) == 2
    assert all(g.max_surv == (max_surv or 8) for g in calls)
    assert sorted(got) == sorted(want) == ["border_force",
                                           "space_repulsive_force"]
    for name in got:
        g = torch.stack(got[name], dim=-1).numpy()
        w = np.stack([np.asarray(a) for a in want[name]], axis=-1)
        assert np.all(np.abs(g - w) <= 1e-5 + 1e-5 * np.abs(w)), name
    assert np.abs(g).max() > 0


def _spy_wrappers(monkeypatch):
    """Record the name of every environment wrapper called."""
    seen = []

    def spy(name, real):
        def call(*args, **kwargs):
            seen.append(name)
            return real(*args, **kwargs)
        return call

    for name in ("env_exp", "env_exp_compact", "env_moussaid",
                 "env_moussaid_compact"):
        monkeypatch.setattr(cuda_env, name, spy(name, getattr(cuda_env, name)))
    return seen


@pytest.mark.parametrize("compact,max_surv,expect", [
    (True, 2, ["env_exp_compact", "env_moussaid"]),
    (True, 0, ["env_exp", "env_moussaid"]),
    (False, 2, ["env_exp", "env_moussaid"])])
def test_gate_picks_the_wrappers(monkeypatch, compact, max_surv, expect):
    """The small urban scene (42 border sections: 6 groups of 8; 3 vehicle
    outlines: 1 group): a table of 2 slots compacts the borders; the auto
    width (6) and ``compact`` off leave every job dense, as does the fleet's
    single group."""
    ps, pp, pc, pst = psyn.urban_bundle(300, num_steps_hint=40, device=CPU,
                                        **URBAN_KW)
    scene = stepper.prepare_scene(ps)
    assert scene.borders_seg.num_segments == 42
    state, ap, _ = stepper.fleet_tick(pst, ps.autopilot.initial_state(),
                                      scene, pp, pc, 0)
    snap = pap.autopilot_snapshot(ps.autopilot, ap)
    seen = _spy_wrappers(monkeypatch)
    cuda_env.fused_environment_terms(state, scene, pp, snap, compact=compact,
                                     max_surv=max_surv)
    assert seen == expect


# -- the slice as a whole ---------------------------------------------------------

def _jax_tick(st, ap, scene, params, cfg, t_idx):
    """One tick of the JAX package's fleet rollout body
    (stepper.py:711-745), eagerly."""
    st = jspawn.apply_spawn(st, scene.spawn, t_idx)
    ap = jap.autopilot_step(scene.autopilot, ap, (st.pos_x, st.pos_y),
                            (st.vel_x, st.vel_y), st.alive, t_idx, cfg.dt)
    snap = jap.autopilot_snapshot(scene.autopilot, ap)
    st, _ = jstepper.simulation_step(st, scene, params, cfg, t_idx,
                                     veh_snap=snap)
    return st, ap


def assert_ped_close(got, want, tol=1e-4):
    w = fields_of(want)
    np.testing.assert_array_equal(got.alive.numpy(), w["alive"])
    np.testing.assert_array_equal(got.mode.numpy(), w["mode"])
    for name in ("pos_x", "pos_y"):
        err = np.abs(getattr(got, name).numpy() - w[name])
        assert err.max() <= tol, (name, err.max())


def assert_fleet_close(got, want, tol=1e-4):
    w = fields_of(want)
    for name in ("active", "wp_idx", "overtaking"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), w[name])
    for name in ("pos", "speed", "heading", "lane_off"):
        err = np.abs(getattr(got, name).numpy() - w[name])
        assert err.max() <= tol, (name, err.max())


def test_urban_rollout_matches_jax_step_by_step(bundles):
    """40 urban steps, the port stepped from the JAX package's own state
    at every step: pedestrian positions and fleet within 1e-4 m, modes,
    alive and fleet flags equal; walkers check traffic and cross, and the
    fleet drives (its braking cases are test_autopilot_step_equals_jax's)."""
    (js, jp, jc, jst), (ps, pp, pc, _) = bundles
    js = jstepper.prepare_scene(js)
    scene = stepper.prepare_scene(ps)
    pc = dataclasses.replace(pc, env_max_surv=2)   # the borders' table runs
    jap_state = js.autopilot.initial_state()
    seen, moved = set(), False
    for k in range(40):
        pst = convert.ped_state_from_fields(fields_of(jst), CPU)
        pap_state = convert.autopilot_state_from_fields(fields_of(jap_state),
                                                        CPU)
        got, gap_, _ = stepper.fleet_tick(pst, pap_state, scene, pp, pc, k)
        jst, jap_state = _jax_tick(jst, jap_state, js, jp, jc, k)
        assert_ped_close(got, jst)
        assert_fleet_close(gap_, jap_state)
        seen |= set(got.mode[got.alive].tolist())
        moved |= bool((gap_.active & (gap_.speed > 0)).any())
    assert {modes.CHECKING_TRAFFIC, modes.CROSSING_ROAD} <= seen
    assert moved


def test_urban_rollout_records_and_resume(bundles):
    """The whole rollout: the free-running record against the JAX
    package's within 1e-4 m, ``record_stride`` keeps the first of each
    stride of both records, ``return_autopilot_state`` hands back the fleet
    state a resumed run continues from, and a resume without it raises."""
    (js, jp, jc, jst), (ps, pp, pc, pst) = bundles
    _, (jrec, jveh) = jstepper.make_rollout_fn(js, jp, jc, 40)(jst)
    final, (rec, veh) = stepper.make_rollout_fn(ps, pp, pc, 40)(pst)
    assert isinstance(final, PedState)
    np.testing.assert_array_equal(rec.alive.numpy(), np.asarray(jrec.alive))
    np.testing.assert_array_equal(rec.mode.numpy(), np.asarray(jrec.mode))
    assert np.abs(rec.pos.numpy() - np.asarray(jrec.pos)).max() <= 1e-4
    np.testing.assert_array_equal(veh.active.numpy(), np.asarray(jveh.active))
    assert np.abs(veh.pos.numpy() - np.asarray(jveh.pos)).max() <= 1e-4
    assert rec.pos.shape == (40, 48, 2) and veh.pos.shape == (40, 3, 2)

    _, (srec, sveh) = stepper.make_rollout_fn(ps, pp, pc, 40,
                                              record_stride=4)(pst)
    assert srec.pos.shape == (10, 48, 2) and sveh.speed.shape == (10, 3)
    for a, b in zip(srec, rec):
        np.testing.assert_array_equal(a.numpy(), b[::4].numpy())
    for a, b in zip(sveh, veh):
        np.testing.assert_array_equal(a.numpy(), b[::4].numpy())

    (end, ap_end), _ = stepper.rollout(pst, ps, pp, pc, 40, record=False,
                                       return_autopilot_state=True)
    (mid, ap_mid), _ = stepper.rollout(pst, ps, pp, pc, 20,
                                       return_autopilot_state=True)
    (end2, ap_end2), rest = stepper.rollout(
        mid, ps, pp, pc, 20, start_step=20, autopilot_state=ap_mid,
        return_autopilot_state=True)
    np.testing.assert_array_equal(rest[0].pos.numpy(), rec.pos[20:].numpy())
    np.testing.assert_array_equal(rest[1].pos.numpy(), veh.pos[20:].numpy())
    for f in dataclasses.fields(ap_end):
        assert torch.equal(getattr(ap_end2, f.name), getattr(ap_end, f.name))
    assert torch.equal(end2.pos_x, end.pos_x)
    assert torch.equal(end.pos_y, final.pos_y)
    with pytest.raises(NotImplementedError, match="start_step"):
        stepper.rollout(mid, ps, pp, pc, 5, start_step=20)
    vs = pap.records_to_vehicle_states(ps.autopilot, veh)
    jvs = jap.records_to_vehicle_states(js.autopilot, jveh)
    np.testing.assert_allclose(vs.vel.numpy(), np.asarray(jvs.vel),
                               rtol=1e-5, atol=1e-4)
    assert vs.num_steps == 40 and vs.num_vehicles == 3


def test_converted_urban_scene_runs_the_same_rollout(bundles):
    """The JAX scene, params, config and state carried over by
    utils/convert.py give the port's own bundle's rollout, bitwise."""
    (js, jp, jc, jst), (ps, pp, pc, pst) = bundles
    cs = convert.scene_from_fields(fields_of(js), CPU)
    assert_fields_equal(cs.autopilot, js.autopilot)
    cp = convert.params_from_fields(fields_of(jp))
    cc = convert.step_config_from_fields(fields_of(jc))
    cst = convert.ped_state_from_fields(fields_of(jst), CPU)
    _, (crec, cveh) = stepper.make_rollout_fn(cs, cp, cc, 20)(cst)
    _, (rec, veh) = stepper.make_rollout_fn(ps, pp, pc, 20)(pst)
    for a, b in zip((*crec, *cveh), (*rec, *veh)):
        assert torch.equal(a, b)
