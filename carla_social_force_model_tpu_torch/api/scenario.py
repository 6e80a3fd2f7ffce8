"""Scenario TOML -> a prepared-to-run Scene on a device (port of
api/scenario.py; host-side build pipeline).

Parses the reference's scenario surface (README.md:114-189; defaults match
the reference's ``dict.get`` call sites cited per field) and assembles the
padded arrays on the host with numpy, equal to the JAX package's array for
array, then moves them to ``device`` once: spawn schedule, route buffers,
border/obstacle point sets, scripted-vehicle timelines, the reactive
fleet and the social groups.

The ``[engine]`` table (and the CLI's overrides) maps onto the port's
:class:`..models.stepper.StepConfig` so that both packages compute the same
simulation from the same file:

* ``use_pallas`` false (the default; no shipped scenario sets it): the JAX
  package's jnp path.  ``env_chunked`` is set: the environment forces take
  each segment's closest point from the chunked point sets (the
  ``chunk_argmin`` kernel on a card).  The pair forces run the port's pair
  kernels, which compute the JAX package's jnp pair force.
  ``interaction_cutoff``, ``env_compact``, ``env_analytic`` and
  ``env_max_surv`` act only on the JAX package's Pallas path, so they are
  dropped here with its warning, never applied.
* ``use_pallas`` true (``--pallas``): the fused environment kernels, and
  the cutoff and the environment knobs carry over as
  ``utils/convert.step_config_from_fields`` carries them.

The TPU launch knobs (``pallas_exact_div``, ``pallas_vmem_mb``,
``env_ped_tile``, ``env_point_tile``) other than at their defaults have no
counterpart and raise ``ValueError``.  ``axis_comm`` carries over into
``StepConfig.axis_comm``, as in the JAX package, whose ``Simulation`` never
shards either: it acts under ``parallel.sharding.make_sharded_rollout``
only.

Headless coverage notes:
* ``generate_route`` requires a navigation graph; headless it is served by
  the routing package from a cached/explicit graph (routing/).  Manual
  ``waypoints`` + ``destination`` work everywhere.
* Vehicles with ``auto_pilot = true`` are CARLA-TrafficManager/agent driven
  in the reference (vehicle_spawner.py:125-138); headless they require a
  ``waypoints`` route or a ``destination`` and a driving graph (the
  reactive fleet), or a scripted ``trajectory`` (an exact reference
  feature).
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..env.borders import borders_from_config, build_border_set
from ..env.obstacles_gen import build_obstacle_set, static_obstacles_from_config
from ..models.params import SfmParams
from ..models.spawn import (WALKER_BLUEPRINT_COUNT, SpawnerSpec,
                            build_spawn_schedule)
from ..models.state import PedState
from ..models.stepper import Scene, StepConfig
from ..models.vehicles import VehicleSpec, build_vehicle_states
from ..utils.config import load_config
from ..utils.device import DEFAULT_DEVICE, resolve_device

log = logging.getLogger(__name__)


@dataclass
class ScenarioBundle:
    """Everything needed to run one headless scenario (tensors on one
    device)."""

    scene: Scene
    cfg: StepConfig
    params: SfmParams
    initial_state: PedState
    num_steps: int
    dt: float
    scenario_name: str
    # host-side geometry kept for CSV output (reference schemas)
    border_lines: list
    obstacle_outlines: list
    obstacle_centers: list

    @property
    def capacity(self) -> int:
        return self.initial_state.capacity


def extract_ped_spawners(scenario: dict, route_provider=None) -> list[SpawnerSpec]:
    """``[[walker.ped_spawner]]`` -> SpawnerSpecs (pedestrian_spawner.py:61-104).

    ``route_provider(origin, destination, graph_type_name) -> (waypoints,
    crossing_bools)`` serves ``generate_route`` entries (routing package or
    CARLA bridge in the JAX package); without one, such spawners raise.
    """
    walker = scenario.get("walker", {})
    specs = []
    for sp in walker.get("ped_spawner", []) or []:
        spawn_location = np.asarray(sp["spawn_location"], np.float64)
        destination = np.asarray(sp["destination"], np.float64)
        generate_route = sp.get("generate_route")
        if generate_route:
            if route_provider is None:
                raise ValueError(
                    "ped_spawner uses generate_route but no route provider is "
                    "available (attach a nav graph via routing/ or the CARLA bridge)")
            waypoints, crossing = route_provider(spawn_location, destination,
                                                 generate_route)
            waypoints = np.asarray(waypoints, np.float64)
        else:
            wp_list = [np.asarray(w, np.float64) for w in sp.get("waypoints", [])]
            wp_list.append(destination)
            # normalize 2-D waypoints to 3-D (z = 0)
            wp_list = [np.r_[w, 0.0][:3] if w.shape[0] == 2 else w[:3]
                       for w in wp_list]
            waypoints = np.stack(wp_list, axis=0)
            crossing = sp.get("crossing_road_bools", [False] * len(waypoints))
            if len(waypoints) != len(crossing):
                log.warning("Length of waypoints and crossing_road_bools is not "
                            "equal! Waypoints may get cut off!")
        specs.append(SpawnerSpec(
            spawn_location=spawn_location,
            waypoints=waypoints,
            crossing_road=list(crossing),
            speed=float(sp.get("speed", 1.2)),
            blueprint=sp.get("blueprint"),
            quantity=int(sp.get("quantity", 1)),
            spawn_time=float(sp.get("spawn_time", 0.0)),
            spawn_interval=float(sp.get("spawn_interval", 3.0)),
            crossing_speed_factor=float(sp.get("crossing_speed_factor", 1.5)),
            crossing_safety_margin=float(sp.get("crossing_safety_margin", 1.5)),
            radius=float(sp.get("radius", walker.get("default_radius", 0.3))),
            group_size=int(sp.get("group_size", 0)),
            interaction_scale=float(sp.get("interaction_scale", 1.0)),
            variate_interaction=float(sp.get("variate_interaction", 0.0)),
            pair_force=sp.get("pair_force"),
        ))
    return specs


def extract_autopilot_specs(scenario: dict, driving_router=None) -> list:
    """Reactive ``[[vehicle.vehicle_spawner]]`` entries: ``auto_pilot = true``
    plus a headless route -> kinematic waypoint-follower specs (the
    headless stand-in for TrafficManager autopilot,
    vehicle_spawner.py:125-130; models/autopilot.py).

    The route comes from an explicit ``waypoints`` polyline, or -- like the
    reference's BehaviorAgent mode (vehicle_spawner.py:131-138) -- from a
    ``destination`` planned over the town's driving lanes when a
    ``driving_router`` (routing.driving.DrivingGraph, usually loaded from
    the ``[map] driving_graph_npz`` capture) is available.  ``spawn_point``
    and integer ``destination`` values index the map's spawn-point list
    exactly as the reference does (vehicle_spawner.py:96-98, :131-132);
    coordinate pairs are accepted headless as well.

    Destination-routed vehicles additionally derive per-waypoint overtake
    legality (and the passing-lane width) from the graph's lane adjacency
    (DrivingGraph.lane_adjacency) -- the BehaviorAgent takes lane-change
    permission from the map, so routed vehicles may pass by default
    wherever an adjacent lane runs alongside, and nowhere else.  Explicit
    ``overtake``/``lane_width`` keys override (and remain the only
    mechanism for waypoints-authored routes, which carry no map).
    """
    from ..models.autopilot import AutopilotSpec
    vehicle_cfg = scenario.get("vehicle", {})
    specs = []
    for sp in vehicle_cfg.get("vehicle_spawner", []) or []:
        if not sp.get("auto_pilot", True):
            continue
        waypoints = sp.get("waypoints", [])
        derived_ok, derived_width = None, None
        if len(waypoints) == 0 and sp.get("destination") is not None:
            if driving_router is None:
                log.warning(
                    "Skipping destination-routed vehicle spawner headless: "
                    "no driving graph (set [map] driving_graph_npz or "
                    "attach the CARLA bridge): %s", sp)
                continue
            waypoints = _plan_destination_route(sp, driving_router)
            if waypoints is None:
                continue
            # BehaviorAgent parity: lane-change legality comes from the
            # map, not the scenario (vehicle_spawner.py:131-138 -- the
            # agent's local planner reads OpenDRIVE markings).  Headless,
            # derive the per-waypoint mask from driving-lane adjacency;
            # explicit overtake/lane_width keys still override.
            derived_ok, derived_width = driving_router.lane_adjacency(
                np.asarray(waypoints, np.float64)[:, :2])
        if len(waypoints) == 0:
            continue
        ot_default = derived_ok is not None and bool(np.any(derived_ok))
        specs.append(AutopilotSpec(
            waypoints=np.asarray(waypoints, np.float64)[:, :2],
            speed_limit=float(sp.get("speed_limit", 8.33)),
            speed_reduction_factor=float(
                sp.get("speed_reduction_factor", 30)),
            ignore_walkers_percentage=float(
                sp.get("ignore_walkers_percentage", 0)),
            ignore_lights_percentage=float(
                sp.get("ignore_lights_percentage", 0)),
            extent=tuple(sp.get("extent", (2.4, 1.1))),
            spawn_time=float(sp.get("spawn_time", 0.0)),
            spawn_interval=float(sp.get("spawn_interval", 5.0)),
            quantity=int(sp.get("quantity", 1)),
            loop=bool(sp.get("loop", False)),
            blueprint=sp.get("blueprint"),
            overtake=bool(sp.get("overtake", ot_default)),
            overtake_ok=derived_ok,
            lane_width=float(sp.get(
                "lane_width",
                derived_width if derived_width is not None else 3.5)),
            overtake_speed_gain=float(sp.get("overtake_speed_gain", 0.5)),
            overtake_clear_ahead=float(sp.get("overtake_clear_ahead", 40.0)),
            overtake_clear_behind=float(sp.get("overtake_clear_behind", 8.0)),
            lane_change_rate=float(sp.get("lane_change_rate", 1.75)),
        ))
    return specs


def _plan_destination_route(sp: dict, router):
    """Plan ``spawn_point``/``spawn_location`` -> ``destination`` over the
    driving-lane graph; None (with a warning) when unresolvable."""
    def resolve(value):
        if isinstance(value, int) and not isinstance(value, bool):
            xyz, _ = router.spawn_transform(value)
            return xyz[:2]
        return np.asarray(value, np.float64).reshape(-1)[:2]

    try:
        if sp.get("spawn_point") is not None:
            origin = resolve(sp["spawn_point"])
        elif sp.get("spawn_location") is not None:
            origin = resolve(sp["spawn_location"])
        else:
            log.warning("Skipping destination-routed vehicle spawner "
                        "without spawn_point/spawn_location: %s", sp)
            return None
        return router.route(origin, resolve(sp["destination"]))
    except (ValueError, IndexError) as exc:
        # covers unresolvable routes, out-of-range spawn_point indices,
        # and captures saved without spawn points -- warn-and-skip like
        # every other malformed-spawner path
        log.warning("Skipping destination-routed vehicle spawner: %s", exc)
        return None


def extract_vehicle_specs(scenario: dict) -> list[VehicleSpec]:
    """Scripted ``[[vehicle.vehicle_spawner]]`` entries (trajectory mode,
    vehicle_spawner.py:139-144).  Autopilot vehicles with a ``waypoints``
    route go to the reactive fleet (extract_autopilot_specs); TM/agent
    vehicles without one need the CARLA bridge."""
    vehicle_cfg = scenario.get("vehicle", {})
    specs = []
    for sp in vehicle_cfg.get("vehicle_spawner", []) or []:
        trajectory = sp.get("trajectory", [])
        waypoints = sp.get("waypoints", [])
        if sp.get("auto_pilot", True):
            if not waypoints and sp.get("destination") is None:
                log.warning("Skipping TM/agent vehicle spawner headless "
                            "(requires the CARLA bridge, a waypoints route, "
                            "or a destination + driving graph): %s", sp)
            continue
        if not (trajectory or waypoints):
            log.warning("Skipping vehicle spawner without trajectory or "
                        "waypoints: %s", sp)
            continue
        if waypoints and not trajectory:
            # headless authoring sugar: waypoints + speed -> teleport list
            from ..models.vehicles import trajectory_from_waypoints
            trajectory, headings, speeds = trajectory_from_waypoints(
                waypoints, float(sp.get("speed", 8.0)),
                float(scenario.get("step_length", 0.05)))
        else:
            headings = np.asarray(sp.get("headings", []), np.float64)
            speeds = np.asarray(sp.get("speeds", []), np.float64)
        specs.append(VehicleSpec(
            trajectory=np.asarray(trajectory, np.float64),
            headings=np.asarray(headings, np.float64),
            speeds=np.asarray(speeds, np.float64),
            extent=tuple(sp.get("extent", (2.4, 1.1))),
            spawn_time=float(sp.get("spawn_time", 0.0)),
            spawn_interval=float(sp.get("spawn_interval", 5.0)),
            quantity=int(sp.get("quantity", 1)),
        ))
    return specs


def nav_mesh_sampler(points, z_offset: float = 0.0):
    """Sampler over recorded ``get_random_location_from_navigation`` points.

    ``points``: (N, 2/3) array or a path to an .npy/.npz (key ``points``)
    capture of CARLA nav-mesh samples -- record once against a live server,
    replay headless for distributional parity with the reference's random
    pedestrians (pedestrian_spawner.py:113-114).
    """
    if isinstance(points, (str, bytes)):
        loaded = np.load(points)
        points = loaded["points"] if hasattr(loaded, "files") else loaded
    points = np.asarray(points, np.float64)
    if points.shape[1] == 2:
        points = np.concatenate(
            [points, np.zeros((len(points), 1))], axis=1)

    def sample(rng):
        return points[int(rng.integers(0, len(points)))] + \
            np.array([0.0, 0.0, z_offset])

    return sample


def random_ped_spawners(planner, count: int, seed: int, speed: float = 1.0,
                        location_sampler=None) -> list[SpawnerSpec]:
    """Random-pedestrian spawners (reference pedestrian_spawner.py:106-124:
    random origin/destination, route with jaywalking allowed at junctions,
    origin included).

    ``location_sampler(rng) -> xyz`` supplies origin/destination draws --
    the CARLA bridge passes the live ``get_random_location_from_navigation``
    and headless runs can replay a recorded nav-mesh sample set
    (:func:`nav_mesh_sampler`).  Without one, random nav-graph nodes are
    drawn (documented deviation: node positions, not nav-mesh area)."""
    from ..routing.graph import GraphType
    rng = np.random.default_rng(seed)
    nodes = planner.graph.nodes
    specs = []
    made = 0
    attempts = 0
    while made < count and attempts < count * 10:
        attempts += 1
        if location_sampler is not None:
            a_loc = np.asarray(location_sampler(rng), np.float64)
            b_loc = np.asarray(location_sampler(rng), np.float64)
        else:
            a, b = rng.integers(0, len(nodes), 2)
            if a == b:
                continue
            a_loc, b_loc = nodes[a], nodes[b]
        try:
            tuples = planner.generate_route(
                a_loc, b_loc, GraphType.JAYWALKING_AT_JUNCTION,
                with_origin=True)
        except ValueError:
            continue
        if len(tuples) < 2:
            continue
        origin = tuples.pop(0)[0]
        waypoints = np.stack([t[0] for t in tuples], axis=0)
        crossing = [bool(t[1]) for t in tuples]
        specs.append(SpawnerSpec(
            spawn_location=origin, waypoints=waypoints, crossing_road=crossing,
            speed=speed, quantity=1, spawn_time=0.0, spawn_interval=1.0))
        made += 1
    return specs


#: engine keys of the JAX package's TPU launch (no counterpart here), with
#: the JAX package's defaults, which are accepted
_TPU_ENGINE_DEFAULTS = {"pallas_exact_div": False, "pallas_vmem_mb": 32,
                        "env_ped_tile": 512, "env_point_tile": 512}
#: engine keys that act only on the JAX package's Pallas path
_PALLAS_ONLY_KEYS = ("interaction_cutoff", "env_compact", "env_analytic",
                     "env_max_surv")


def step_config_from_engine(eng: dict, dt: float, waypoint_threshold: float,
                            despawn_on_arrival: bool) -> StepConfig:
    """The port's StepConfig from a scenario's merged ``[engine]`` table,
    deciding the path as the JAX package does (its scenario.py:416-438 and
    stepper.py:273): without ``use_pallas`` the jnp environment path
    (``env_chunked``), with the Pallas-only knobs dropped under the JAX
    package's warning; with it the fused environment kernels and every
    knob, and ``axis_comm`` on both.  Raises ``ValueError`` for a TPU
    launch knob."""
    for key, default in _TPU_ENGINE_DEFAULTS.items():
        if key in eng and eng[key] != default:
            raise ValueError(f"engine.{key} = {eng[key]!r} is a TPU launch "
                             f"knob with no counterpart on the port")
    use_pallas = bool(eng.get("use_pallas", False))
    common = dict(dt=dt, waypoint_threshold=waypoint_threshold,
                  despawn_on_arrival=despawn_on_arrival,
                  symmetric_pairs=bool(eng.get("pallas_symmetric", True)),
                  spatial_order=str(eng.get("spatial_order", "hilbert")),
                  axis_comm=str(eng.get("axis_comm", "gather")))
    if not use_pallas:
        if eng.get("interaction_cutoff") is not None:
            log.warning("interaction_cutoff only takes effect on the fused "
                        "Pallas kernel; pass --pallas / engine.use_pallas")
        for key in _PALLAS_ONLY_KEYS[1:]:
            if eng.get(key):
                log.warning("%s only takes effect on the fused environment "
                            "kernels; pass --pallas / engine.use_pallas", key)
        return StepConfig(env_chunked=True, **common)
    cutoff = eng.get("interaction_cutoff")
    return StepConfig(
        interaction_cutoff=float(cutoff) if cutoff is not None else None,
        compact_pairs=bool(eng.get("pallas_compact", True)),
        pair_max_surv=int(eng.get("pallas_max_surv", 0)),
        env_compact=bool(eng.get("env_compact", False)),
        env_analytic=bool(eng.get("env_analytic", False)),
        env_max_surv=int(eng.get("env_max_surv", 0)), **common)


def build_scenario(scenario_config, sfm_config, num_steps: int,
                   route_provider=None, planner=None,
                   strict_parity: bool = False,
                   extra_borders=None, extra_border_sections=None,
                   extra_obstacles=None, extra_obstacle_centers=None,
                   engine: dict | None = None,
                   device: torch.device | str = DEFAULT_DEVICE
                   ) -> ScenarioBundle:
    """Assemble a ScenarioBundle on ``device`` from parsed/loadable configs.

    ``planner`` (a routing.PedPathPlanner) serves ``generate_route``
    spawners and ``random_pedestrians``; ``route_provider`` is a lower-level
    alternative for just the former.  ``extra_*`` lets the CARLA bridge (or
    cached map extractions) inject sidewalk borders and map obstacles
    alongside the config-defined ones, mirroring run_simulation.py:174-192's
    merge.  ``engine`` overrides the scenario's ``[engine]`` table (the
    CLI's ``--pallas``, ``--cutoff``, ...); see the module docstring for
    how it maps onto :class:`..models.stepper.StepConfig`.
    """
    device = resolve_device(device)
    config_dir = (os.path.dirname(os.path.abspath(scenario_config))
                  if isinstance(scenario_config, (str, bytes)) else None)
    scenario = load_config(scenario_config)
    sfm = load_config(sfm_config)

    def resolve_path(p):
        """Relative resource paths resolve against the scenario config's
        directory first, then the cwd."""
        if os.path.isabs(p):
            return p
        for base in ([config_dir] if config_dir else []) + [os.getcwd()]:
            cand = os.path.join(base, p)
            if os.path.exists(cand):
                return cand
        return p

    # map-extracted navigation graph replayed from a cached capture: routing
    # scenarios (the reference's routing/routing2 classes,
    # config/scenarios/routing*_scenario_config.toml) become runnable
    # headless -- the graph a live run would build via the CARLA topology
    # walk (path_planner.py:210-574 semantics, routing/carla_graph.py) is
    # serialized once and loaded here
    ng_npz = scenario.get("map", {}).get("nav_graph_npz")
    if ng_npz and planner is None:
        from ..routing.graph import NavGraph
        from ..routing.planner import PedPathPlanner
        planner = PedPathPlanner(NavGraph.load_npz(resolve_path(ng_npz)))
    if planner is not None and route_provider is None:
        route_provider = planner.route_provider()

    # map-extracted sidewalk borders replayed from a cached capture
    # (the reference's .npz sidewalk cache, obstacles.py:27-64, made
    # loadable without a CARLA server)
    sw_npz = scenario.get("map", {}).get("sidewalk_borders_npz")
    if sw_npz:
        from ..env import cache as _cache
        path = resolve_path(sw_npz)
        with np.load(path, allow_pickle=True) as data:
            hit = dict(data)
        lines = _cache.arrays_to_ragged(hit)
        extra_borders = list(extra_borders or []) + lines
        # "lengths" is the ragged point-count index; section lengths in
        # meters (the reference's coarse-filter radius, forces.py:149-151)
        # ride in "section_lengths".  Older captures without it fall back
        # to point-count * sampling resolution ("resolution" in the capture
        # when the writer recorded it; 0.1 m -- extract_sidewalk's default
        # -- otherwise, with a warning: a capture sampled at another step
        # would get coarse-filter radii off by the resolution ratio).
        if "section_lengths" in hit:
            sec_len = hit["section_lengths"]
        else:
            counts = np.asarray(hit["lengths"], np.float64)
            if not np.all(counts == np.round(counts)):
                raise ValueError(
                    f"{path}: 'lengths' holds non-integer values, so it "
                    "cannot be the ragged point-count index (pre-fix "
                    "captures stored section meters there, corrupting the "
                    "point splits) -- re-export the capture")
            if "resolution" in hit:
                res = float(hit["resolution"])
            else:
                res = 0.1
                log.warning(
                    "%s: capture has neither 'section_lengths' nor "
                    "'resolution'; approximating section lengths as "
                    "point-count * 0.1 m (the default sampling step)", path)
            sec_len = counts * res
        extra_border_sections = (list(extra_border_sections or [])
                                 + list(zip(hit["centers"], sec_len)))

    params = SfmParams.from_dict(sfm, strict_parity=strict_parity)
    dt = float(scenario.get("step_length", 0.05))
    walker = scenario.get("walker", {})
    # engine knobs (headless extension): scenario [engine] table, overridden
    # by the caller's engine= dict (the CLI's --pallas/--cutoff/--comm)
    eng = dict(scenario.get("engine", {}))
    eng.update({k: v for k, v in (engine or {}).items() if v is not None})
    cfg = step_config_from_engine(
        eng, dt=dt,
        waypoint_threshold=float(walker.get("waypoint_threshold", 2.0)),
        despawn_on_arrival=bool(walker.get("despawn_on_arrival", True)))

    obstacles_cfg = scenario.get("obstacles")
    border_lines, border_centers, border_lengths = borders_from_config(obstacles_cfg)
    if extra_borders:
        border_lines = border_lines + list(extra_borders)
        for center, length in extra_border_sections or []:
            border_centers.append(np.asarray(center, np.float64))
            border_lengths.append(float(length))
    borders = build_border_set(border_lines, border_centers, border_lengths)

    outlines, centers = static_obstacles_from_config(obstacles_cfg)
    if extra_obstacles:
        outlines = outlines + list(extra_obstacles)
        centers = centers + [np.asarray(c, np.float64) for c in
                             (extra_obstacle_centers or [])]
    static_obstacles = build_obstacle_set(
        outlines, centers, params.static_obstacle.perception_threshold)

    resolution = float((obstacles_cfg or {}).get("resolution", 0.1))
    vehicle_specs = extract_vehicle_specs(scenario)
    vehicles = build_vehicle_states(vehicle_specs, dt, num_steps,
                                    resolution=resolution, device=device)
    vehicle_cfg = scenario.get("vehicle", {})
    # driving-lane route graph capture: destination-routed vehicles (the
    # reference's BehaviorAgent mode, vehicle_spawner.py:131-138) become
    # runnable headless (routing/driving.py)
    dg_npz = scenario.get("map", {}).get("driving_graph_npz")
    driving_router = None
    if dg_npz:
        from ..routing.driving import DrivingGraph
        driving_router = DrivingGraph.load_npz(resolve_path(dg_npz))
    ap_specs = extract_autopilot_specs(scenario, driving_router)
    autopilot = None
    if ap_specs:
        from ..models.autopilot import (VEHICLE_BLUEPRINT_COUNT,
                                        VEHICLE_BLUEPRINT_COUNT_NO_BIKES,
                                        build_autopilot_fleet)
        if vehicles is not None:
            raise ValueError(
                "mixing scripted-trajectory and reactive-autopilot vehicles "
                "in one headless scenario is not supported yet")
        # default library size matches CARLA 0.9.13 under the scenario's
        # no_bikes filter, so seeded speed jitter matches the reference
        # out of the box (vehicle_spawner.py:27-31, :100-118)
        default_bc = (VEHICLE_BLUEPRINT_COUNT_NO_BIKES
                      if vehicle_cfg.get("no_bikes", False)
                      else VEHICLE_BLUEPRINT_COUNT)
        # headless traffic lights (timed red/green stop-points; PARITY.md)
        from ..models.autopilot import TrafficLightSpec
        tl_specs = [
            TrafficLightSpec(
                position=np.asarray(tl["position"], np.float64)[:2],
                red=float(tl.get("red", 5.0)),
                green=float(tl.get("green", 5.0)),
                offset=float(tl.get("offset", 0.0)))
            for tl in vehicle_cfg.get("traffic_lights", []) or []]
        autopilot = build_autopilot_fleet(
            ap_specs, dt, num_steps,
            vehicle_seed=int(vehicle_cfg.get("vehicle_seed", 2000)),
            variate_speed_factor=float(
                vehicle_cfg.get("variate_speed_factor", 0.0)),
            blueprint_count=int(vehicle_cfg.get("blueprint_count",
                                                default_bc)),
            resolution=resolution,
            traffic_lights=tl_specs or None, device=device)

    ped_specs = extract_ped_spawners(scenario, route_provider=route_provider)
    n_random = int(walker.get("random_pedestrians", 0))
    if n_random > 0:
        if planner is None:
            raise ValueError("random_pedestrians requires a nav-graph planner "
                             "(routing/ or the CARLA bridge)")
        nav_samples = walker.get("nav_mesh_samples")
        if isinstance(nav_samples, str):
            nav_samples = resolve_path(nav_samples)
        sampler = (nav_mesh_sampler(nav_samples)
                   if nav_samples is not None else None)
        ped_specs += random_ped_spawners(
            planner, n_random, int(walker.get("pedestrian_seed", 2000)),
            location_sampler=sampler)
    schedule = build_spawn_schedule(
        ped_specs, dt, num_steps,
        pedestrian_seed=int(walker.get("pedestrian_seed", 2000)),
        variate_speed=float(walker.get("variate_speed", 0.0)),
        blueprint_count=int(walker.get("blueprint_count",
                                       WALKER_BLUEPRINT_COUNT)),
        initial_velocity=walker.get("initial_velocity", "forward"),
        device=device,
    )

    static_vel = None
    if static_obstacles is not None:
        static_vel = torch.zeros((static_obstacles.num_segments, 2),
                                 dtype=torch.float32, device=device)

    if schedule.law_id is not None:
        # a spawner's pair_force only works if its family's force flag is
        # on -- fail at build time with the flag name, not silently at run
        from ..models.spawn import LAW_IDS
        enabled = {0: params.enable_pedestrian, 1: params.enable_powerlaw,
                   2: params.enable_ped_repulsive, 3: params.enable_orca}
        flags = {0: "pedestrian_force", 1: "powerlaw_force",
                 2: "ped_repulsive_force", 3: "orca_law"}
        names = {v: k for k, v in LAW_IDS.items()}
        for fid in np.unique(schedule.law_id.cpu().numpy()):
            if fid >= 0 and not enabled[int(fid)]:
                raise ValueError(
                    f"a ped_spawner sets pair_force = "
                    f"{names[int(fid)]!r} but [forces] "
                    f"{flags[int(fid)]} is not enabled")

    groups = None
    if schedule.group_id is not None:
        from ..models.groups import build_groups
        gid = schedule.group_id.cpu().numpy()
        # size the member table to the largest configured party: a spawner
        # with group_size > 8 must work from TOML, where build_groups'
        # "raise max_members" advice is not actionable
        biggest = (int(np.bincount(gid[gid >= 0]).max())
                   if (gid >= 0).any() else 0)
        groups = build_groups(gid, max_members=max(8, biggest),
                              device=device)

    scene = Scene(spawn=schedule, borders=borders,
                  static_obstacles=static_obstacles,
                  static_obstacle_vel=static_vel, vehicles=vehicles,
                  autopilot=autopilot, groups=groups)
    return ScenarioBundle(
        scene=scene, cfg=cfg, params=params,
        initial_state=PedState.empty(schedule.capacity, device=device),
        num_steps=num_steps, dt=dt,
        scenario_name=scenario.get("scenario_name", ""),
        border_lines=border_lines,
        obstacle_outlines=outlines, obstacle_centers=centers,
    )
