"""Tick-synchronized bridge runner (port of bridge/runner.py: the
reference's SimulationRunner role).

Couples the port's SFM core (``models.stepper.tick_core``, on the card) to
an external world (CARLA or the in-process fake) with the reference's
per-tick contract (run_simulation.py:47-132):

  spawn due walkers -> world.tick() -> read back walker loc/vel ->
  read back vehicles -> SFM core -> push WalkerControl velocities ->
  waypoint arrival / despawn

The world owns position integration (exactly like CARLA in the reference);
the device owns forces, FSM, gap acceptance and waypoint bookkeeping.  The
step takes the scenarios' default engine (``StepConfig.env_chunked``, the
JAX package's jnp path, as ``api/scenario.step_config_from_engine`` builds
it without ``use_pallas``): on a card the pair kernel (``pair_force_sym``)
and the chunk scan (``chunk_argmin``) over the borders, the static
obstacles and the vehicle outlines rebuilt from the world every tick.

Host and device traffic per tick is a fixed number of copies, not one per
walker: the numpy mirrors of ``PedState`` and the tick's vehicles go up as
one packed float32 buffer and one packed int32 buffer (the routes' planes
only after a spawn), and the commanded velocities, the FSM planes,
``finished`` and the recorded mode come back as one packed float32 buffer,
whose copy is the tick's one synchronisation (the world needs the
velocities).  On a card the host side of each copy is pinned memory.  Each
vehicle's outline template is uploaded once, when the actor is first seen,
into a device bank that the tick indexes.
"""
from __future__ import annotations

import dataclasses
import logging
import random

import numpy as np
import torch

from ..api.scenario import extract_ped_spawners, step_config_from_engine
from ..env.borders import borders_from_config, build_border_set
from ..env.obstacles_gen import build_obstacle_set, static_obstacles_from_config
from ..models import modes
from ..models.params import SfmParams
from ..models.routes import RouteBuffer, build_route_buffer
from ..models.spawn import SpawnSchedule, SpawnerSpec
from ..models.state import PedState
from ..models.stepper import Scene, StepRecord, prepare_scene, tick_core
from ..models.vehicles import VehicleSnapshot, ellipse_template
from ..utils.config import load_config
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .world import World

log = logging.getLogger(__name__)

#: PedState's float32 planes, in the order of the packed upload
_FLOAT_PLANES = ("pos_x", "pos_y", "vel_x", "vel_y", "radius", "base_speed",
                 "crossing_speed", "safety_margin", "fsm_target",
                 "applied_target", "next_mode_time", "wp_x", "wp_y")
#: PedState's int32 and bool planes, in the order of the packed upload
_INT_PLANES = ("mode", "waypoint_idx", "alive", "spawned")
#: planes the core's outputs persist into the mirrors (JAX runner :317-319)
_FSM_PLANES = ("fsm_target", "applied_target", "next_mode_time", "wp_x",
               "wp_y")
#: points of a vehicle's outline template (one chunk of the snapshot)
_TEMPLATE_POINTS = 128
#: the template's padding: far from every pedestrian, and invalid
_TEMPLATE_PAD = 1.0e8


class _SpawnerRuntime:
    """Host-side greedy spawner timing (pedestrian_spawner.py:46-59,218-228)."""

    def __init__(self, spec: SpawnerSpec):
        self.spec = spec
        self.next_time = spec.spawn_time
        self.remaining = spec.quantity
        self.speed = float(spec.speed)  # mutated cumulatively by jitter

    def ready(self, sim_time: float) -> bool:
        if self.remaining > 0 and self.next_time <= sim_time:
            self.next_time += self.spec.spawn_interval
            self.remaining -= 1
            return True
        return False


class BridgeRunner:
    """Run a scenario against a World adapter, one tick at a time, with the
    SFM core on ``device`` (default the card; ``device="cpu"`` runs the
    plain PyTorch versions on the CPU)."""

    def __init__(self, world: World, scenario_config, sfm_config,
                 strict_parity: bool = False, route_provider=None,
                 max_vehicles: int = 16, extra_borders=None,
                 extra_border_sections=None, extra_obstacles=None,
                 extra_obstacle_centers=None, extra_ped_specs=None,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.world = world
        scenario = load_config(scenario_config)
        sfm = load_config(sfm_config)
        self.scenario_name = scenario.get("scenario_name", "")
        self.params = SfmParams.from_dict(sfm, strict_parity=strict_parity)
        walker = scenario.get("walker", {})
        self.cfg = step_config_from_engine(
            {}, dt=float(scenario.get("step_length", 0.05)),
            waypoint_threshold=float(walker.get("waypoint_threshold", 2.0)),
            despawn_on_arrival=bool(walker.get("despawn_on_arrival", True)))

        obstacles_cfg = scenario.get("obstacles")
        lines, centers, lengths = borders_from_config(obstacles_cfg)
        if extra_borders:
            lines += list(extra_borders)
            for c, l in extra_border_sections or []:
                centers.append(np.asarray(c, np.float64))
                lengths.append(float(l))
        self.border_lines = lines
        borders = build_border_set(lines, centers, lengths)

        outlines, ocenters = static_obstacles_from_config(obstacles_cfg)
        if extra_obstacles:
            outlines += list(extra_obstacles)
            ocenters += [np.asarray(c) for c in (extra_obstacle_centers or [])]
        self.obstacle_outlines, self.obstacle_centers = outlines, ocenters
        static_obstacles = build_obstacle_set(
            outlines, ocenters, self.params.static_obstacle.perception_threshold)

        specs = extract_ped_spawners(scenario, route_provider=route_provider)
        if extra_ped_specs:
            specs = specs + list(extra_ped_specs)
        self.spawners = [_SpawnerRuntime(s) for s in specs]
        self.capacity = max(1, sum(s.quantity for s in specs))
        self.ped_seed = int(walker.get("pedestrian_seed", 2000))
        self.variate_speed = float(walker.get("variate_speed", 0.0))
        # blueprint library size for the seeded per-walker draw: the world's
        # actual library unless the scenario overrides it
        bc = walker.get("blueprint_count")
        self.blueprint_count = (int(bc) if bc is not None
                                else world.walker_blueprint_count())
        self.draw_bounding_boxes = bool(walker.get("draw_bounding_boxes", False))
        self.draw_obstacles = bool(
            scenario.get("map", {}).get("draw_obstacles", False))
        self.spectator_focus = walker.get("spectator_focus")

        # route buffer sized for all slots (filled at spawn time)
        n = self.capacity
        w_max = max([1] + [len(s.waypoints) for s in specs])
        self._routes_wp = np.zeros((n, w_max, 2), np.float32)
        self._routes_cr = np.zeros((n, w_max), bool)
        self._routes_cnt = np.zeros((n,), np.int32)
        self._routes_dirty = True

        # host mirrors of PedState
        empty = PedState.empty(n, device="cpu")
        self.h = {f.name: getattr(empty, f.name).numpy().copy()
                  for f in dataclasses.fields(PedState)}
        self.slot_actor = np.full((n,), -1, np.int64)
        self.slot_name = [None] * n
        self._next_slot = 0   # advances only on successful spawns
        self._ped_index = 0   # advances on every attempt (reference naming)

        self.max_vehicles = max_vehicles
        self._veh_resolution = float((obstacles_cfg or {}).get("resolution", 0.1))
        self._veh_templates: dict[int, np.ndarray] = {}
        self._veh_bank: dict[int, int] = {}   # actor id -> bank row
        pad = np.full((1, _TEMPLATE_POINTS, 2), _TEMPLATE_PAD, np.float32)
        self._bank_xy = torch.from_numpy(pad).to(self.device)
        self._bank_valid = torch.zeros((1, _TEMPLATE_POINTS), dtype=torch.bool,
                                       device=self.device)

        # the packed transfer buffers (pinned on the host side of a card)
        v = max_vehicles
        self._up_f, self._dev_f = self._buffers(
            len(_FLOAT_PLANES) * n + 7 * v, torch.float32)
        self._up_i, self._dev_i = self._buffers(len(_INT_PLANES) * n + v,
                                                torch.int32)
        self._down = torch.zeros((11 * n,), dtype=torch.float32,
                                 pin_memory=self.device.type == "cuda")

        self._scene = prepare_scene(
            Scene(spawn=self._dummy_schedule(), borders=borders,
                  static_obstacles=static_obstacles, vehicles=None),
            orca=self.params.enable_orca, chunked=True)
        self.history = []     # per-tick StepRecord snapshots (numpy)
        self.veh_history = []  # per-tick list of VehicleObs

        # startup obstacle drawing (reference run_simulation.py:194-197:
        # all static border + obstacle outline points, 30 s lifetime)
        if self.draw_obstacles:
            for line in self.border_lines:
                self.world.draw_points(np.asarray(line), 30.0)
            for outline in self.obstacle_outlines:
                self.world.draw_points(np.asarray(outline), 30.0)

    # ------------------------------------------------------------------
    def _buffers(self, size: int, dtype):
        """An upload buffer of ``size`` elements on the host (pinned with a
        card) and its device twin (the host buffer itself on the CPU)."""
        card = self.device.type == "cuda"
        host = torch.zeros((size,), dtype=dtype, pin_memory=card)
        return host, (torch.zeros((size,), dtype=dtype, device=self.device)
                      if card else host)

    def _upload(self, host: torch.Tensor, dev: torch.Tensor) -> None:
        if dev is not host:
            dev.copy_(host, non_blocking=True)

    def _dummy_schedule(self) -> SpawnSchedule:
        """Routes live in the scene for tick_core's waypoint advance."""
        n, dev = self.capacity, self.device
        z = torch.zeros((n,), dtype=torch.float32, device=dev)
        return SpawnSchedule(
            step=torch.full((n,), -1, dtype=torch.int32, device=dev),
            pos_x=z, pos_y=z, vel_x=z, vel_y=z,
            speed=z, crossing_speed=z, margin=z, radius=z,
            initial_mode=torch.zeros((n,), dtype=torch.int32, device=dev),
            fwp_x=z, fwp_y=z,
            routes=build_route_buffer([], [], capacity=n, device=dev))

    def _upload_routes(self) -> None:
        """The routes' (capacity, W) planes from the host mirrors: two
        copies, after a tick that spawned."""
        n, w = self._routes_cr.shape
        fl = np.concatenate([self._routes_wp[..., 0].reshape(-1),
                             self._routes_wp[..., 1].reshape(-1)])
        it = np.concatenate([self._routes_cr.reshape(-1).astype(np.int32),
                             self._routes_cnt])
        fl_d = torch.from_numpy(fl).to(self.device, non_blocking=False)
        it_d = torch.from_numpy(it).to(self.device, non_blocking=False)
        routes = RouteBuffer(wp_x=fl_d[:n * w].view(n, w),
                             wp_y=fl_d[n * w:].view(n, w),
                             crossing=it_d[:n * w].view(n, w) != 0,
                             count=it_d[n * w:])
        spawn = dataclasses.replace(self._scene.spawn, routes=routes)
        self._scene = dataclasses.replace(self._scene, spawn=spawn)
        self._routes_dirty = False

    # ------------------------------------------------------------------
    def _spawn_due(self, sim_time: float):
        self.spawners = [s for s in self.spawners if s.remaining > 0]
        for s in self.spawners:
            if not s.ready(sim_time):
                continue
            spec = s.spec
            name = f"ped_{self._ped_index}"
            self._ped_index += 1

            # per-walker seeded draws in the reference's order
            # (pedestrian_spawner.py:133-150): seed, blueprint choice (only
            # when none is configured), speed jitter, seed increment --
            # performed whether or not the world spawn succeeds.
            rng = random.Random()
            rng.seed(self.ped_seed)
            bp = spec.blueprint
            if not bp and self.blueprint_count > 0:
                bp = rng.choice(range(self.blueprint_count))
            if self.variate_speed != 0.0:
                s.speed += rng.uniform(-self.variate_speed, self.variate_speed)
            self.ped_seed += 1

            wps = np.asarray(spec.waypoints, np.float64)[:, :2]
            loc = np.asarray(spec.spawn_location, np.float64)[:2]
            direction = wps[0] - loc
            yaw = float(np.arctan2(direction[1], direction[0]))
            actor_id = self.world.spawn_walker(bp, loc, yaw, role_name=name)
            if actor_id == -1:
                # failed spawns burn a seed + a name but never a state slot
                # (reference pedestrian_spawner.py:152-153 just skips)
                log.info("Failed to spawn pedestrian %s.", name)
                continue
            slot = self._next_slot
            self._next_slot += 1

            flags = list(spec.crossing_road) or [False] * len(wps)
            k = min(len(wps), len(flags))
            self._routes_wp[slot, :k] = wps[:k]
            self._routes_cr[slot, :k] = flags[:k]
            self._routes_cnt[slot] = k
            self._routes_dirty = True

            h = self.h
            h["pos_x"][slot], h["pos_y"][slot] = loc
            nrm = np.linalg.norm(direction)
            v0 = (direction / nrm * s.speed) if nrm > 0 else np.zeros(2)
            h["vel_x"][slot], h["vel_y"][slot] = v0
            h["radius"][slot] = self.world.get_walker_radius(actor_id)
            h["base_speed"][slot] = s.speed
            h["crossing_speed"][slot] = spec.crossing_speed_factor * s.speed
            h["safety_margin"][slot] = spec.crossing_safety_margin
            h["fsm_target"][slot] = s.speed
            h["applied_target"][slot] = s.speed
            h["mode"][slot] = (modes.CROSSING_ROAD if (flags and flags[0])
                               else modes.WALKING_SIDEWALK)
            h["next_mode_time"][slot] = -1.0
            h["wp_x"][slot], h["wp_y"][slot] = wps[0]
            h["waypoint_idx"][slot] = 0
            h["alive"][slot] = True
            h["spawned"][slot] = True
            self.slot_actor[slot] = actor_id
            self.slot_name[slot] = name
            if self.spectator_focus == name:
                self.world.focus_spectator_on(actor_id)
            log.info("Spawned pedestrian %s.", name)

    def _bank_row(self, o) -> int:
        """The device bank row of actor ``o``'s outline template, uploaded
        when the actor is first seen."""
        row = self._veh_bank.get(o.actor_id)
        if row is not None:
            return row
        tmpl = ellipse_template(float(o.extent[0]), float(o.extent[1]),
                                self._veh_resolution)
        self._veh_templates[o.actor_id] = tmpl
        p = _TEMPLATE_POINTS
        xy = np.full((1, p, 2), _TEMPLATE_PAD, np.float32)
        valid = np.zeros((1, p), bool)
        k = min(len(tmpl), p)
        xy[0, :k] = tmpl[:k]
        valid[0, :k] = True
        self._bank_xy = torch.cat(
            [self._bank_xy, torch.from_numpy(xy).to(self.device)])
        self._bank_valid = torch.cat(
            [self._bank_valid, torch.from_numpy(valid).to(self.device)])
        row = self._veh_bank[o.actor_id] = self._bank_xy.shape[0] - 1
        return row

    def _pack_vehicles(self, fl: np.ndarray, it: np.ndarray) -> None:
        """This tick's vehicles into the packed buffers, in the world's
        readback order: centres, velocities, headings, extents (floats) and
        each slot's bank row (0: the padding row, an inactive slot)."""
        obs = self.world.get_vehicles()
        self.veh_history.append(obs)
        v = self.max_vehicles
        center, vel, heading, extent = (
            fl[:2 * v].reshape(v, 2), fl[2 * v:4 * v].reshape(v, 2),
            fl[4 * v:5 * v], fl[5 * v:7 * v].reshape(v, 2))
        fl[:] = 0.0
        it[:] = 0
        for i, o in enumerate(obs[:v]):
            it[i] = self._bank_row(o)
            if self.draw_obstacles:
                # per-tick dynamic-obstacle outline drawing
                # (reference run_simulation.py:97-99)
                tmpl = self._veh_templates[o.actor_id][:_TEMPLATE_POINTS]
                c, s = np.cos(o.heading), np.sin(o.heading)
                pts = tmpl @ np.array([[c, s], [-s, c]]) + o.center
                self.world.draw_points(pts, self.cfg.dt)
            center[i] = o.center
            vel[i] = o.velocity
            heading[i] = o.heading
            extent[i] = o.extent

    def _vehicle_snapshot(self, fl: torch.Tensor,
                          it: torch.Tensor) -> VehicleSnapshot:
        """The port's VehicleSnapshot on the device from the uploaded
        buffers (``points_per_chunk`` 128, ``max_vehicles`` slots)."""
        v = self.max_vehicles
        row = it.long()
        return VehicleSnapshot(
            center=fl[:2 * v].view(v, 2), vel=fl[2 * v:4 * v].view(v, 2),
            heading=fl[4 * v:5 * v], extent=fl[5 * v:7 * v].view(v, 2),
            active=row > 0, template=self._bank_xy[row],
            template_valid=self._bank_valid[row],
            points_per_chunk=_TEMPLATE_POINTS)

    def _core(self, state: PedState, snap: VehicleSnapshot, sim_time: float):
        """The SFM core of one tick: ``tick_core`` on the device."""
        return tick_core(state, self._scene, self.params, self.cfg, sim_time,
                         snap)

    # ------------------------------------------------------------------
    def tick(self):
        """One synchronized step (reference SimulationRunner.tick order)."""
        sim_time = self.world.get_sim_time()
        self._spawn_due(sim_time)
        self.world.tick()

        h = self.h
        for slot in np.nonzero(h["alive"])[0]:
            loc, vel = self.world.get_walker_state(int(self.slot_actor[slot]))
            h["pos_x"][slot], h["pos_y"][slot] = loc[:2]
            h["vel_x"][slot], h["vel_y"][slot] = vel[:2]
            if self.draw_bounding_boxes:
                self.world.draw_bounding_box(int(self.slot_actor[slot]),
                                             self.cfg.dt)

        # the record's walker planes are the readback (tick_core records
        # the state it is given, with the mode after gap acceptance)
        n = self.capacity
        rec_pos = np.stack([h["pos_x"], h["pos_y"]], axis=-1)
        rec_vel = np.stack([h["vel_x"], h["vel_y"]], axis=-1)
        rec_alive = h["alive"].copy()

        # one packed float32 and one packed int32 upload
        fl, it = self._up_f.numpy(), self._up_i.numpy()
        for k, name in enumerate(_FLOAT_PLANES):
            fl[k * n:(k + 1) * n] = h[name]
        for k, name in enumerate(_INT_PLANES):
            it[k * n:(k + 1) * n] = h[name]
        nf, ni = len(_FLOAT_PLANES) * n, len(_INT_PLANES) * n
        self._pack_vehicles(fl[nf:], it[ni:])
        if self._routes_dirty:
            self._upload_routes()
        self._upload(self._up_f, self._dev_f)
        self._upload(self._up_i, self._dev_i)

        dev_f, dev_i = self._dev_f, self._dev_i
        planes = dev_f[:nf].view(len(_FLOAT_PLANES), n)
        ints = dev_i[:ni].view(len(_INT_PLANES), n)
        state = PedState(
            **{name: planes[k] for k, name in enumerate(_FLOAT_PLANES)},
            mode=ints[0], waypoint_idx=ints[1], alive=ints[2] != 0,
            spawned=ints[3] != 0)
        snap = self._vehicle_snapshot(dev_f[nf:], dev_i[ni:])
        # tick_core's contract: a Python float holding a float32 value
        state2, (vx, vy), finished, record = self._core(
            state, snap, float(np.float32(sim_time)))
        out = torch.stack([vx, vy, *(getattr(state2, f) for f in _FSM_PLANES),
                           state2.mode.float(), state2.waypoint_idx.float(),
                           finished.float(), record.mode.float()])
        # the tick's one synchronisation: the world needs the velocities
        if self.device.type == "cuda":
            self._down.view(11, n).copy_(out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            back = self._down.numpy().reshape(11, n)
        else:
            back = out.numpy()

        v_np = np.stack([back[0], back[1]], axis=-1)
        for slot in np.nonzero(h["alive"])[0]:
            v = v_np[slot]
            speed = float(np.linalg.norm(v))
            direction = v / speed if speed != 0.0 else v
            self.world.set_walker_velocity(
                int(self.slot_actor[slot]), np.r_[direction, 0.0], speed)

        # persist FSM/waypoint outputs
        for k, name in enumerate(_FSM_PLANES):
            h[name][...] = back[2 + k]
        h["mode"][...] = back[7]
        h["waypoint_idx"][...] = back[8]

        fin = back[9] > 0
        if self.cfg.despawn_on_arrival:
            for slot in np.nonzero(fin & h["alive"])[0]:
                self.world.destroy_actor(int(self.slot_actor[slot]))
                h["alive"][slot] = False
                log.info("Despawned pedestrian %s.", self.slot_name[slot])

        self.history.append((rec_pos, rec_vel, back[10].astype(np.int32),
                             rec_alive))

    def run(self, num_steps: int):
        for _ in range(num_steps):
            self.tick()

    # ------------------------------------------------------------------
    def records(self):
        """History as a StepRecord of stacked numpy arrays (CSV-writer
        input)."""
        if not self.history:
            return None
        pos, vel, mode, alive = zip(*self.history)
        return StepRecord(pos=np.stack(pos), vel=np.stack(vel),
                          mode=np.stack(mode), alive=np.stack(alive))
