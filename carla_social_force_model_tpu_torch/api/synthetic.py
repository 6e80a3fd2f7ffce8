"""Synthetic large-N crowds and their environment for benchmarks (port of
api/synthetic.py).

The scene is drawn on the host with ``np.random.default_rng(seed)`` and
numpy in the JAX package's order, so both packages simulate the identical
scene for the same seed; the arrays then move to ``device`` once.  Every
builder defaults to the card; ``device="cpu"`` asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import modes
from ..models.autopilot import AutopilotSpec, build_autopilot_fleet
from ..models.params import SfmParams
from ..models.routes import RouteBuffer
from ..models.spawn import SpawnSchedule
from ..models.state import PedState
from ..models.stepper import Scene, StepConfig
from ..models.vehicles import (VehicleSpec, build_vehicle_states,
                               ellipse_template)
from ..env.borders import build_border_set, sample_borderline
from ..env.obstacles_gen import build_obstacle_set
from ..routing.graph import EdgeType, GraphType, NavGraphBuilder
from ..routing.planner import PedPathPlanner
from ..utils.device import DEFAULT_DEVICE, resolve_device


def synthetic_crowd(n: int, extent: float = 100.0, speed: float = 1.3,
                    seed: int = 0, radius: float = 0.3,
                    device: torch.device | str = DEFAULT_DEVICE
                    ) -> SpawnSchedule:
    """N pedestrians spawning at step 0, uniformly placed in a square of
    half-size ``extent``, each walking to the antipodal point (sustained
    counterflow through the center -- a dense interaction workload)."""
    device = resolve_device(device)
    dtype = np.float32
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(dtype)
    dest = (-pos).astype(dtype)
    direction = dest - pos
    nrm = np.linalg.norm(direction, axis=-1, keepdims=True)
    direction = direction / np.where(nrm == 0, 1, nrm)
    speeds = np.full((n,), speed, dtype) + rng.uniform(-0.2, 0.2, n).astype(dtype)
    vel = direction * speeds[:, None]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    routes = RouteBuffer(
        wp_x=dev(dest[:, None, 0]), wp_y=dev(dest[:, None, 1]),
        crossing=torch.zeros((n, 1), dtype=torch.bool, device=device),
        count=torch.ones((n,), dtype=torch.int32, device=device))
    return SpawnSchedule(
        step=torch.zeros((n,), dtype=torch.int32, device=device),
        pos_x=dev(pos[:, 0]), pos_y=dev(pos[:, 1]),
        vel_x=dev(vel[:, 0]), vel_y=dev(vel[:, 1]),
        speed=dev(speeds), crossing_speed=dev(speeds * 1.5),
        margin=torch.full((n,), 1.5, dtype=torch.float32, device=device),
        radius=torch.full((n,), radius, dtype=torch.float32, device=device),
        initial_mode=torch.full((n,), modes.WALKING_SIDEWALK,
                                dtype=torch.int32, device=device),
        fwp_x=dev(dest[:, 0]), fwp_y=dev(dest[:, 1]),
        routes=routes)


def batched_crowds(batch: int, n: int, extent: float = 35.0,
                   speed: float = 1.3, seed: int = 0, radius: float = 0.3,
                   device: torch.device | str = DEFAULT_DEVICE
                   ) -> SpawnSchedule:
    """A batch of independent synthetic crowds for ensemble rollouts: row b
    is ``synthetic_crowd(n, seed=seed + b)``, every plane stacked along a
    leading batch axis (``(B, N)``; routes ``(B, N, W)``)."""
    device = resolve_device(device)
    rows = [synthetic_crowd(n, extent=extent, speed=speed, seed=seed + b,
                            radius=radius, device="cpu")
            for b in range(batch)]

    def stack(*planes):
        return torch.stack(planes).to(device)

    routes = RouteBuffer(*(stack(*(getattr(r.routes, f) for r in rows))
                           for f in ("wp_x", "wp_y", "crossing", "count")))
    return SpawnSchedule(**{
        f: routes if f == "routes" else stack(*(getattr(r, f) for r in rows))
        for f in ("step", "pos_x", "pos_y", "vel_x", "vel_y", "speed",
                  "crossing_speed", "margin", "radius", "initial_mode",
                  "fwp_x", "fwp_y", "routes")})


def _wall_sections(lines, centers, lengths, a, b,
                   section_length: float = 30.0, resolution: float = 0.1):
    """Append one sampled wall split into <=section_length sections (the
    reference's section-center/length coarse-filter granularity,
    forces.py:149-151)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    total = float(np.linalg.norm(b - a))
    n_sec = max(1, int(np.ceil(total / section_length)))
    for k in range(n_sec):
        s = a + (b - a) * (k / n_sec)
        e = a + (b - a) * ((k + 1) / n_sec)
        lines.append(sample_borderline(s, e, resolution))
        centers.append((s + e) / 2.0)
        lengths.append(float(np.linalg.norm(e - s)))


def synthetic_borders(extent: float, spacing: float = 20.0,
                      section_length: float = 30.0, resolution: float = 0.1):
    """Street-grid walls across the arena, sampled at the reference's 0.1 m
    border resolution and split into <=30 m sections.  BASELINE config #2's
    workload shape.  A host-side ``ChunkedPointSet``."""
    lines, centers, lengths = [], [], []
    coords = np.arange(-extent, extent + 1e-6, spacing)
    for c in coords:
        _wall_sections(lines, centers, lengths, (-extent, c), (extent, c),
                       section_length, resolution)   # horizontal street wall
        _wall_sections(lines, centers, lengths, (c, -extent), (c, extent),
                       section_length, resolution)   # vertical street wall
    return build_border_set(lines, centers, lengths)


def synthetic_obstacles(extent: float, spacing: float = 15.0,
                        resolution: float = 0.1,
                        perception_threshold: float = 20.0):
    """A grid of parked-car-sized static obstacles (ellipse outlines at the
    reference's sampling, obstacles.py:269-281).  BASELINE config #3's
    static workload shape.  A host-side ``ChunkedPointSet``."""
    outlines, centers = [], []
    coords = np.arange(-extent + spacing / 2, extent, spacing)
    tmpl = ellipse_template(2.4, 1.1, resolution)
    for cx in coords:
        for cy in coords:
            outlines.append(tmpl + np.array([cx, cy]))
            centers.append(np.array([cx, cy]))
    return build_obstacle_set(outlines, centers, perception_threshold)


def synthetic_vehicles(extent: float, count: int, dt: float, num_steps: int,
                       device: torch.device | str = DEFAULT_DEVICE):
    """Moving vehicles sweeping the arena (BASELINE config #3's dynamic
    obstacles): ``count`` lanes at 8 m/s, a timeline of ``num_steps``."""
    specs = []
    speed = 8.0
    length = num_steps + 2
    for v in range(count):
        y = -extent + (v + 0.5) * (2 * extent / count)
        xs = -extent + speed * dt * np.arange(length)
        specs.append(VehicleSpec(
            trajectory=np.column_stack([xs, np.full(length, y)]),
            headings=np.zeros(length), speeds=np.full(length, speed)))
    return build_vehicle_states(specs, dt, num_steps, device=device)


def urban_bundle(n: int, seed: int = 0, num_steps_hint: int = 512,
                 n_routes: int = 256, n_roads: int = 8, width: float = 600.0,
                 road_spacing: float = 60.0, sidewalk_offset: float = 6.0,
                 curb_offset: float = 4.5, cross_spacing: float = 100.0,
                 wp_spacing: float = 20.0, vehicles_per_road: int = 2,
                 device: torch.device | str = DEFAULT_DEVICE):
    """(scene, params, cfg, state) for BASELINE config #4, urban navigation
    at scale: nav-graph-routed pedestrians on a synthetic Manhattan-style
    street grid with curb borders, crosswalk mode transitions,
    gap-acceptance road crossing, and a reactive autopilot fleet looping
    the roads (the reference's whole tick, run_simulation.py:47-132).

    Geometry: ``n_roads`` horizontal roads (y = i*road_spacing) spanning x
    in [0, width], sidewalks at +-sidewalk_offset, curb walls at
    +-curb_offset sampled at the reference's 0.1 m, crosswalks and block
    connectors every ``cross_spacing``.  ``n_routes`` A* routes are planned
    on the host between random sidewalk nodes of different roads;
    pedestrians round-robin over them with jittered spawn points.  The same
    graph, borders, fleet, routes and schedule as the JAX package's
    ``urban_bundle`` for the same arguments (drawn from
    ``np.random.default_rng(seed)`` in its order), on ``device``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    # nav graph
    b = NavGraphBuilder()
    xs = np.arange(0.0, width + 1e-6, wp_spacing)
    cross_xs = np.arange(cross_spacing, width - 1e-6, cross_spacing)
    road_ys = np.arange(n_roads, dtype=np.float64) * road_spacing
    for y in road_ys:
        for off in (-sidewalk_offset, sidewalk_offset):
            b.add_polyline([np.array([x, y + off, 0.0]) for x in xs],
                           EdgeType.SIDEWALK)
        for x in cross_xs:
            b.add_edge([x, y - sidewalk_offset, 0.0],
                       [x, y + sidewalk_offset, 0.0], EdgeType.CROSSWALK)
    for y0, y1 in zip(road_ys[:-1], road_ys[1:]):
        lo, hi = y0 + sidewalk_offset, y1 - sidewalk_offset
        ys = np.arange(lo, hi + 1e-6, wp_spacing)
        if ys[-1] < hi - 1e-6:
            ys = np.append(ys, hi)
        for x in cross_xs:
            b.add_polyline([np.array([x, yy, 0.0]) for yy in ys],
                           EdgeType.SIDEWALK)
    planner = PedPathPlanner(b.build())

    # curb borders (the reference's 0.1 m sampling, <= 30 m sections)
    lines, centers, lengths = [], [], []
    for y in road_ys:
        for off in (-curb_offset, curb_offset):
            _wall_sections(lines, centers, lengths,
                           (0.0, y + off), (width, y + off))
    borders = build_border_set(lines, centers, lengths)

    # reactive vehicle fleet: a looping two-lane ring per road
    ap_specs = []
    for y in road_ys:
        ring = np.array([[5.0, y - 2.0], [width - 5.0, y - 2.0],
                         [width - 5.0, y + 2.0], [5.0, y + 2.0]])
        ap_specs.append(AutopilotSpec(
            waypoints=ring, speed_limit=8.33, speed_reduction_factor=0.0,
            quantity=vehicles_per_road,
            spawn_interval=0.4 * width / 8.33, loop=True))
    fleet = build_autopilot_fleet(ap_specs, 0.05, num_steps_hint,
                                  device=device)

    # host-side A* routes over the grid
    side_nodes = []  # (road_i, node_xyz) on horizontal sidewalks
    for i, y in enumerate(road_ys):
        for off in (-sidewalk_offset, sidewalk_offset):
            for x in xs:
                side_nodes.append((i, np.array([x, y + off, 0.0])))
    route_xy, route_cross = [], []
    w_max = 1
    while len(route_xy) < n_routes:
        oi = rng.integers(len(side_nodes))
        di = rng.integers(len(side_nodes))
        if side_nodes[oi][0] == side_nodes[di][0]:
            continue  # same road: force routes that cross roads
        route = planner.generate_route(side_nodes[oi][1], side_nodes[di][1],
                                       GraphType.NO_JAYWALKING)
        route_xy.append(np.asarray([wp[:2] for wp, _ in route], np.float32))
        route_cross.append(np.asarray([c for _, c in route], bool))
        w_max = max(w_max, len(route))
    rk_x = np.zeros((n_routes, w_max), np.float32)
    rk_y = np.zeros((n_routes, w_max), np.float32)
    rk_c = np.zeros((n_routes, w_max), bool)
    rk_n = np.zeros((n_routes,), np.int32)
    for k, (xy, cr) in enumerate(zip(route_xy, route_cross)):
        rk_x[k, : len(xy)] = xy[:, 0]
        rk_y[k, : len(xy)] = xy[:, 1]
        rk_c[k, : len(xy)] = cr
        rk_n[k] = len(xy)

    # spawn schedule: round-robin routes, jittered spawn points
    ridx = np.arange(n) % n_routes
    ox = rk_x[ridx, 0] + rng.uniform(-18.0, 18.0, n).astype(np.float32)
    oy = rk_y[ridx, 0] + rng.uniform(-1.2, 1.2, n).astype(np.float32)
    ox = np.clip(ox, 0.0, width).astype(np.float32)
    speeds = (1.3 + rng.uniform(-0.2, 0.2, n)).astype(np.float32)
    dx = rk_x[ridx, 0] - ox
    dy = rk_y[ridx, 0] - oy
    nrm = np.maximum(np.hypot(dx, dy), 1e-6)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    routes = RouteBuffer(wp_x=dev(rk_x[ridx]), wp_y=dev(rk_y[ridx]),
                         crossing=dev(rk_c[ridx]), count=dev(rk_n[ridx]))
    schedule = SpawnSchedule(
        step=torch.zeros((n,), dtype=torch.int32, device=device),
        pos_x=dev(ox), pos_y=dev(oy),
        vel_x=dev(speeds * dx / nrm), vel_y=dev(speeds * dy / nrm),
        speed=dev(speeds), crossing_speed=dev(speeds * 1.5),
        margin=torch.full((n,), 1.5, dtype=torch.float32, device=device),
        radius=torch.full((n,), 0.3, dtype=torch.float32, device=device),
        initial_mode=dev(np.where(rk_c[ridx, 0], modes.CROSSING_ROAD,
                                  modes.WALKING_SIDEWALK).astype(np.int32)),
        fwp_x=dev(rk_x[ridx, 0]), fwp_y=dev(rk_y[ridx, 0]),
        routes=routes)

    scene = Scene(spawn=schedule, borders=borders, autopilot=fleet)
    params = SfmParams(enable_acceleration=True, enable_pedestrian=True,
                       enable_border=True, enable_dynamic_obstacle=True)
    # the street network's border sections are sparse against the routed
    # crowd's blocks: the compacted environment kernels, as the JAX package
    cfg = StepConfig(dt=0.05, waypoint_threshold=2.0, despawn_on_arrival=True,
                     env_compact=True)
    return scene, params, cfg, PedState.empty(n, device=device)


def benchmark_bundle(n: int, extent: float | None = None, seed: int = 0,
                     with_borders: bool = False, with_obstacles: bool = False,
                     num_steps_hint: int = 512,
                     device: torch.device | str = DEFAULT_DEVICE):
    """(scene, params, cfg, state) for the BASELINE.json benchmarks:

    * default: config #1 -- acceleration + pedestrian forces, headless, N
      pedestrians at about one per 4 m^2;
    * ``with_borders``: config #2 -- + the border force over a street-grid
      wall point cloud at 0.1 m resolution;
    * ``with_obstacles``: config #3 -- + static (parked-car grid) and
      dynamic (eight moving vehicles, a timeline of ``num_steps_hint``
      steps) obstacle forces.
    """
    device = resolve_device(device)
    if extent is None:
        extent = max(25.0, float(np.sqrt(n) * 1.0))
    static_obstacles = synthetic_obstacles(extent) if with_obstacles else None
    scene = Scene(
        spawn=synthetic_crowd(n, extent=extent, seed=seed, device=device),
        borders=synthetic_borders(extent) if with_borders else None,
        static_obstacles=static_obstacles,
        static_obstacle_vel=(
            torch.zeros((static_obstacles.num_segments, 2),
                        dtype=torch.float32, device=device)
            if with_obstacles else None),
        vehicles=(synthetic_vehicles(extent, count=8, dt=0.05,
                                     num_steps=num_steps_hint, device=device)
                  if with_obstacles else None))
    params = SfmParams(enable_acceleration=True, enable_pedestrian=True,
                       enable_border=with_borders,
                       enable_static_obstacle=with_obstacles,
                       enable_dynamic_obstacle=with_obstacles)
    cfg = StepConfig(dt=0.05, waypoint_threshold=2.0, despawn_on_arrival=False)
    return scene, params, cfg, PedState.empty(n, device=device)
