"""CARLA-attached main loop (port of bridge/carla_bridge.py: the
reference's simulation_loop with the SFM core on the card).

Wires the pieces for interactive use against a live CARLA server:
map-geometry extraction (cached), nav-graph routing, vehicle management
(TrafficManager / BehaviorAgent / scripted), the BridgeRunner tick sync, and
real-time pacing (run_simulation.py:160-229).  Headless use never imports
this module.
"""
from __future__ import annotations

import logging
import time

import torch

from ..utils.config import load_config
from ..utils import csvout
from ..utils.device import DEFAULT_DEVICE, resolve_device

log = logging.getLogger(__name__)


def run_with_carla(args, sfm_config, max_steps: int | None = None,
                   pace: bool = True,
                   device: torch.device | str = DEFAULT_DEVICE) -> int:
    """``args``: ``scenario_config``, ``carla_host``, ``carla_port``,
    ``csv``, ``output`` and optionally ``strict_parity`` (the CLI's
    namespace).  ``max_steps`` bounds the loop (None = the reference's
    infinite real-time loop); ``pace=False`` disables the real-time sleep
    (test / as-fast-as-possible runs).  The SFM core runs on ``device``
    (default the card: raises without one before connecting)."""
    device = resolve_device(device)
    scenario = load_config(args.scenario_config)
    sfm = load_config(sfm_config)

    from .carla_world import CarlaWorld
    from .extract import extract_obstacles, extract_sidewalk
    from .runner import BridgeRunner
    from .vehicle_spawner import BridgeVehicleManager

    world = CarlaWorld(args.carla_host, args.carla_port, scenario)
    obstacles_cfg = scenario.get("obstacles", {})
    resolution = float(obstacles_cfg.get("resolution", 0.1))

    lines, centers, lengths = extract_sidewalk(world.carla_map, resolution)
    outlines, ocenters = extract_obstacles(
        world.world, resolution,
        ellipse_shape=bool(obstacles_cfg.get("ellipse_shape", True)),
        max_obstacle_z_pos=float(obstacles_cfg.get("max_obstacle_z_pos", 0.3)))

    route_provider = None
    extra_ped_specs = None
    walker_cfg = scenario.get("walker", {})
    spawners = walker_cfg.get("ped_spawner", []) or []
    n_random = int(walker_cfg.get("random_pedestrians", 0))
    if any(sp.get("generate_route") for sp in spawners) or n_random > 0:
        from ..api.scenario import random_ped_spawners
        from ..routing.carla_graph import (build_carla_nav_graph,
                                           make_waypoint_locator)
        from ..routing.planner import PedPathPlanner
        graph = build_carla_nav_graph(
            world.carla_map,
            waypoint_distance=float(walker_cfg.get("waypoint_distance", 10)),
            jaywalking_weight_factor=float(walker_cfg.get("jaywalking_weight", 2)))
        planner = PedPathPlanner(
            graph, waypoint_locator=make_waypoint_locator(world.carla_map))
        route_provider = planner.route_provider()
        if n_random > 0:
            # live nav-mesh draws, like the reference's random pedestrians
            # (pedestrian_spawner.py:113-114)
            def nav_sampler(rng):
                loc = world.world.get_random_location_from_navigation()
                return [loc.x, loc.y, loc.z]

            extra_ped_specs = random_ped_spawners(
                planner, n_random,
                int(walker_cfg.get("pedestrian_seed", 2000)),
                location_sampler=nav_sampler)

    runner = BridgeRunner(
        world, scenario, sfm,
        strict_parity=getattr(args, "strict_parity", False),
        route_provider=route_provider,
        extra_borders=lines,
        extra_border_sections=list(zip(centers, lengths)),
        extra_obstacles=outlines, extra_obstacle_centers=ocenters,
        extra_ped_specs=extra_ped_specs, device=device)
    vehicles = BridgeVehicleManager(world, scenario)

    dt = world.dt
    steps = 0
    try:
        while max_steps is None or steps < max_steps:
            start = time.time()
            vehicles.tick(world.get_sim_time())
            runner.tick()
            steps += 1
            elapsed = time.time() - start
            if pace and elapsed < dt:
                time.sleep(dt - elapsed)
    except KeyboardInterrupt:
        log.info("Cancelled by user.")
    finally:
        log.info("Cleaning Simulation")
        vehicles.close()
        world.close()
        if getattr(args, "csv", False):
            records = runner.records()
            if records is not None:
                import os
                out = csvout.write_all(
                    args.output, scenario.get("scenario_name"), records, dt,
                    vehicles=None, num_steps=len(runner.history),
                    border_lines=runner.border_lines,
                    obstacle_outlines=runner.obstacle_outlines,
                    obstacle_centers=runner.obstacle_centers)
                csvout.write_vehicle_obs_csv(
                    os.path.join(out, "vehicle.csv"), runner.veh_history, dt)
                log.info("CSV output written to %s", out)
    return 0
