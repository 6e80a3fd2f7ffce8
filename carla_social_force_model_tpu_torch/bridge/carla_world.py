"""Real-CARLA World adapter (lazy ``import carla``; a copy of the JAX
package's bridge/carla_world.py, host-side numpy).

Implements the bridge's World protocol over a live CARLA server, replicating
the reference's client setup (carla_simulation.py): synchronous mode with a
fixed timestep and deterministic ragdolls, map load-if-different, optional
prop unloading, spectator placement, batched spawning, WalkerControl pushes,
and settings restore on close.  Scripted-trajectory vehicles are teleported
before each world tick (run_simulation.py:56-67 contract); TrafficManager /
BehaviorAgent vehicles are driven by CARLA itself.
"""
from __future__ import annotations

import logging
import math

import numpy as np

from .world import VehicleObs

log = logging.getLogger(__name__)


class CarlaWorld:
    """World over a CARLA server (reference carla_simulation.py semantics)."""

    def __init__(self, host: str, port: int, scenario_config: dict,
                 timeout: float = 10.0):
        import carla  # lazy: bridge-only dependency
        self._carla = carla
        self.config = scenario_config
        map_cfg = scenario_config.get("map", {})

        self.client = carla.Client(host, port)
        self.client.set_timeout(timeout)
        self.world = self.client.get_world()
        self.carla_map = self.world.get_map()
        map_name = map_cfg.get("map_name")
        map_path = map_cfg.get("map_path", "")
        if map_name and self.carla_map.name != map_path + map_name:
            self.world = self.client.load_world(map_name)
            self.carla_map = self.world.get_map()

        if map_cfg.get("unload_props", False):
            for layer in (carla.MapLayer.Props, carla.MapLayer.StreetLights,
                          carla.MapLayer.Walls, carla.MapLayer.Foliage):
                self.world.unload_map_layer(layer)

        self.dt = float(scenario_config.get("step_length", 0.05))
        self._original_settings = self.world.get_settings()
        settings = self.world.get_settings()
        settings.synchronous_mode = True
        settings.deterministic_ragdolls = True
        settings.fixed_delta_seconds = self.dt
        sub_step = float(scenario_config.get("sub_step_length", -1))
        if sub_step > 0:
            settings.substepping = True
            settings.max_substep_delta_time = sub_step
            settings.max_substeps = math.ceil(self.dt / sub_step)
        self.world.apply_settings(settings)
        self._start_time = self.world.get_snapshot().timestamp.elapsed_seconds

        spec_loc = map_cfg.get("spectator_location")
        spec_rot = map_cfg.get("spectator_rotation")
        if spec_loc is not None and spec_rot is not None:
            spectator = self.world.get_spectator()
            tf = carla.Transform(
                carla.Location(*[float(v) for v in spec_loc]),
                carla.Rotation(*[float(v) for v in spec_rot]))
            spectator.set_transform(tf)

        walker_cfg = scenario_config.get("walker", {})
        seed = int(walker_cfg.get("pedestrian_seed", 2000))
        self.world.set_pedestrians_seed(seed)
        self._blueprints = list(self.world.get_blueprint_library().filter(
            "walker.pedestrian.*"))
        self._spawned = []
        self._trajectory_vehicles: dict[int, dict] = {}

    # -- clock ------------------------------------------------------------
    def tick(self) -> None:
        self._advance_scripted_vehicles()
        self.world.tick()

    def get_sim_time(self) -> float:
        ts = self.world.get_snapshot().timestamp.elapsed_seconds
        return ts - self._start_time

    # -- walkers ----------------------------------------------------------
    def walker_blueprint_count(self) -> int:
        return len(self._blueprints)

    def spawn_walker(self, blueprint, location, yaw, role_name=None) -> int:
        """``blueprint``: id string, library index (the runner's seeded
        per-walker draw, reference pedestrian_spawner.py:133-138), or None
        (first library entry as a last resort)."""
        carla = self._carla
        if isinstance(blueprint, str) and blueprint:
            bp = next((b for b in self._blueprints if b.id == blueprint),
                      None)
            if bp is None:
                raise ValueError(
                    f"unknown walker blueprint {blueprint!r} (library has "
                    f"{len(self._blueprints)} walker.pedestrian.* entries)")
        elif isinstance(blueprint, int):
            bp = self._blueprints[blueprint]
        else:
            bp = self._blueprints[0]
        if bp.has_attribute("role_name"):
            # always (re)set: blueprints are shared library objects, so a
            # stale role_name from an earlier spawn would leak otherwise
            bp.set_attribute("role_name", role_name or "")
        loc = np.asarray(location, float)
        z = loc[2] if loc.shape[0] > 2 else 1.0
        tf = carla.Transform(carla.Location(float(loc[0]), float(loc[1]), float(z)),
                             carla.Rotation(0.0, math.degrees(yaw), 0.0))
        batch = [carla.command.SpawnActor(bp, tf)]
        response = self.client.apply_batch_sync(batch, False)[0]
        if response.error:
            log.error("Spawn carla actor failed. %s", response.error)
            return -1
        self._spawned.append(response.actor_id)
        return response.actor_id

    def destroy_actor(self, actor_id) -> None:
        actor = self.world.get_actor(actor_id)
        if actor is not None:
            actor.destroy()
        if actor_id in self._spawned:
            self._spawned.remove(actor_id)

    def get_walker_state(self, actor_id):
        walker = self.world.get_actor(actor_id)
        loc = walker.get_location()
        vel = walker.get_velocity()
        return (np.array([loc.x, loc.y, loc.z]),
                np.array([vel.x, vel.y, vel.z]))

    def set_walker_velocity(self, actor_id, direction, speed) -> None:
        carla = self._carla
        walker = self.world.get_actor(actor_id)
        control = carla.WalkerControl(
            carla.Vector3D(float(direction[0]), float(direction[1]),
                           float(direction[2]) if len(direction) > 2 else 0.0),
            float(speed), False)
        walker.apply_control(control)

    def get_walker_radius(self, actor_id) -> float:
        walker = self.world.get_actor(actor_id)
        extent = walker.bounding_box.extent
        return max(extent.x, extent.y)

    # -- vehicles ---------------------------------------------------------
    def add_scripted_vehicle(self, actor_id: int, trajectory, headings, speeds):
        """Register a teleport-list vehicle (reference trajectory mode)."""
        self._trajectory_vehicles[actor_id] = {
            "trajectory": list(trajectory), "headings": list(headings),
            "speeds": list(speeds)}

    def _advance_scripted_vehicles(self):
        carla = self._carla
        for veh_id, values in list(self._trajectory_vehicles.items()):
            if values["trajectory"]:
                loc = values["trajectory"].pop(0)
                heading = values["headings"].pop(0)
                speed = values["speeds"].pop(0)
                actor = self.world.get_actor(veh_id)
                tf = carla.Transform(
                    carla.Location(float(loc[0]), float(loc[1]), 0.0),
                    carla.Rotation(0.0, math.degrees(heading), 0.0))
                actor.set_transform(tf)
                actor.set_target_velocity(tf.get_forward_vector() * speed)
            else:
                self.destroy_actor(veh_id)
                self._trajectory_vehicles.pop(veh_id)
                log.info("Despawned vehicle %s.", veh_id)

    def get_vehicles(self) -> list[VehicleObs]:
        out = []
        for v in self.world.get_actors().filter("*vehicle*"):
            tf = v.get_transform()
            vel = v.get_velocity()
            bb = v.bounding_box
            out.append(VehicleObs(
                actor_id=v.id,
                center=np.array([tf.location.x, tf.location.y]),
                heading=math.radians(tf.rotation.yaw),
                velocity=np.array([vel.x, vel.y]),
                extent=np.array([bb.extent.x, bb.extent.y])))
        return out

    # -- debug/visual hooks (reference carla_simulation.py:148-160,
    #    pedestrian_spawner.py:167-172) -----------------------------------
    def draw_bounding_box(self, actor_id, life_time) -> None:
        carla = self._carla
        actor = self.world.get_actor(actor_id)
        bb = carla.BoundingBox(actor.get_location(), actor.bounding_box.extent)
        self.world.debug.draw_box(bb, actor.get_transform().rotation,
                                  color=carla.Color(0, 0, 0, 0),
                                  thickness=0.01, life_time=life_time + 1e-8)

    def draw_points(self, points, life_time) -> None:
        carla = self._carla
        for p in points:
            self.world.debug.draw_point(
                carla.Location(float(p[0]), float(p[1]), 0.5), size=0.05,
                life_time=life_time + 1e-8)

    def focus_spectator_on(self, actor_id) -> None:
        carla = self._carla
        actor = self.world.get_actor(actor_id)
        tf = actor.get_transform()
        spectator = self.world.get_spectator()
        spec_tf = carla.Transform()
        spec_tf.location = tf.transform(carla.Vector3D(-2.0, 0.0, 2.0))
        spec_tf.rotation = tf.rotation
        spectator.set_transform(spec_tf)

    # -- teardown ---------------------------------------------------------
    def close(self) -> None:
        for actor_id in list(self._spawned):
            self.destroy_actor(actor_id)
        self.world.apply_settings(self._original_settings)
