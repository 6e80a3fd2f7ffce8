"""Bridge-side vehicle spawning (reference vehicle_spawner.py semantics; a
copy of the JAX package's bridge/vehicle_spawner.py).

Three control modes per ``[[vehicle.vehicle_spawner]]`` entry:
(a) TrafficManager autopilot with per-vehicle speed-difference /
    ignore-walkers / ignore-lights percentages,
(b) CARLA BehaviorAgent driving to a destination (requires CARLA's agents
    package on sys.path),
(c) scripted teleport trajectories (handled by CarlaWorld each tick).
Seeded blueprint choice + cumulative speed-factor jitter replicate
vehicle_spawner.py:100-118.
"""
from __future__ import annotations

import logging
import random

log = logging.getLogger(__name__)


class _VehicleSpawnerRuntime:
    def __init__(self, spec: dict):
        self.spec = spec
        self.next_time = float(spec.get("spawn_time", 0.0))
        self.remaining = int(spec.get("quantity", 1))
        self.speed_reduction = float(spec.get("speed_reduction_factor", 30))
        self.trajectory = list(spec.get("trajectory", []))
        self.headings = list(spec.get("headings", []))
        self.speeds = list(spec.get("speeds", []))[1:]

    def ready(self, sim_time: float) -> bool:
        if self.remaining > 0 and self.next_time <= sim_time:
            self.next_time += float(self.spec.get("spawn_interval", 5.0))
            self.remaining -= 1
            return True
        return False


class BridgeVehicleManager:
    """Spawns and drives vehicles on a live CARLA server."""

    def __init__(self, carla_world, scenario_config: dict):
        import carla

        self._carla = carla
        self.world = carla_world  # CarlaWorld adapter
        cfg = scenario_config.get("vehicle", {})
        self.seed = int(cfg.get("vehicle_seed", 2000))
        self.variate = float(cfg.get("variate_speed_factor", 0.0))
        no_bikes = bool(cfg.get("no_bikes", False))

        bps = carla_world.world.get_blueprint_library().filter("vehicle")
        if no_bikes:
            self.blueprints = [b for b in bps
                               if int(b.get_attribute("number_of_wheels")) == 4]
        else:
            self.blueprints = list(bps)

        self.tm = carla_world.client.get_trafficmanager(8000)
        self.tm.set_synchronous_mode(True)
        self.tm.set_random_device_seed(self.seed)
        self.spawn_points = carla_world.carla_map.get_spawn_points()

        self.spawners = [_VehicleSpawnerRuntime(s)
                         for s in cfg.get("vehicle_spawner", []) or []]
        self.agents = {}       # actor_id -> BehaviorAgent
        self.vehicle_ids = []

    def tick(self, sim_time: float):
        # drop exhausted spawners (reference vehicle_spawner.py:53)
        self.spawners = [s for s in self.spawners if s.remaining > 0]
        for s in self.spawners:
            if s.ready(sim_time):
                self._spawn(s)
        # drive agent-controlled vehicles (run_simulation.py:70-73)
        for veh_id, agent in list(self.agents.items()):
            if not agent.done():
                control = agent.run_step()
                actor = self.world.world.get_actor(veh_id)
                actor.apply_control(control)

    def _spawn(self, s: _VehicleSpawnerRuntime):
        carla = self._carla
        spec = s.spec
        rng = random.Random()
        rng.seed(self.seed)
        bp_name = spec.get("blueprint")
        if bp_name:
            bp = next(b for b in self.blueprints if b.id == bp_name)
        else:
            bp = rng.choice(self.blueprints)
        if self.variate != 0.0:
            s.speed_reduction += rng.uniform(-self.variate, self.variate)
        self.seed += 1

        auto_pilot = bool(spec.get("auto_pilot", True))
        use_tm = bool(spec.get("use_traffic_manager", True))
        if spec.get("spawn_point") is not None:
            tf = self.spawn_points[int(spec["spawn_point"])]
        else:
            loc = s.trajectory.pop(0)
            heading = s.headings.pop(0)
            import math
            tf = carla.Transform(
                carla.Location(float(loc[0]), float(loc[1]), 1.0),
                carla.Rotation(0.0, math.degrees(heading), 0.0))

        batch = [carla.command.SpawnActor(bp, tf).then(
            carla.command.SetAutopilot(carla.command.FutureActor,
                                       auto_pilot and use_tm,
                                       self.tm.get_port()))]
        response = self.world.client.apply_batch_sync(batch, False)[0]
        if response.error:
            log.error("Spawn carla vehicle failed. %s", response.error)
            return
        actor_id = response.actor_id
        self.vehicle_ids.append(actor_id)
        vehicle = self.world.world.get_actor(actor_id)

        if auto_pilot and use_tm:
            self.tm.vehicle_percentage_speed_difference(vehicle, s.speed_reduction)
            self.tm.ignore_walkers_percentage(
                vehicle, spec.get("ignore_walkers_percentage", 0))
            self.tm.ignore_lights_percentage(
                vehicle, spec.get("ignore_lights_percentage", 0))
        elif auto_pilot:
            self.world.tick()
            from agents.navigation.behavior_agent import BehaviorAgent
            agent = BehaviorAgent(vehicle)
            dest = spec.get("destination")
            if dest is not None:
                agent.set_destination(self.spawn_points[int(dest)].location,
                                      tf.location)
            agent.ignore_traffic_lights(
                spec.get("ignore_lights_percentage", 0) > 0)
            self.agents[actor_id] = agent
        else:
            self.world.add_scripted_vehicle(actor_id, s.trajectory,
                                            s.headings, s.speeds)
        log.info("Spawned vehicle %s of type %s.", actor_id, vehicle.type_id)

    def close(self):
        for actor_id in self.vehicle_ids:
            self.world.destroy_actor(actor_id)
