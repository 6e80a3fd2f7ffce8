"""World-adapter protocol + an in-process fake world (a numpy copy of the
JAX package's bridge/world.py).

The bridge runner talks to an abstract world with the narrow API slice the
reference uses from CARLA (SURVEY.md layer L1): tick, walker spawn/destroy,
walker state readback, WalkerControl-style velocity commands, and
dynamic-obstacle (vehicle) readback.  ``FakeWorld`` implements the contract
in-process -- walkers integrate the commanded velocity over one fixed step,
exactly CARLA's effective behavior for WalkerControl -- which makes the
bridge's synchronization logic testable without a CARLA server (the fake
backend SURVEY.md section 4 calls for).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol

import numpy as np


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class VehicleObs:
    """One vehicle as seen by the pedestrian simulation
    (reference obstacles.py:297-329 readback tuple; heading in radians)."""

    actor_id: int
    center: np.ndarray   # (2,)
    heading: float
    velocity: np.ndarray  # (2,)
    extent: np.ndarray   # (2,)


class World(Protocol):
    """The bridge's view of the external simulator."""

    dt: float

    def tick(self) -> None: ...
    def get_sim_time(self) -> float: ...
    def walker_blueprint_count(self) -> int: ...
    def spawn_walker(self, blueprint: str | int | None, location, yaw: float,
                     role_name: str | None = None) -> int: ...
    def destroy_actor(self, actor_id: int) -> None: ...
    def get_walker_state(self, actor_id: int): ...
    def set_walker_velocity(self, actor_id: int, direction, speed: float) -> None: ...
    def get_walker_radius(self, actor_id: int) -> float: ...
    def get_vehicles(self) -> list[VehicleObs]: ...
    # optional debug/visual hooks (no-ops outside CARLA)
    def draw_bounding_box(self, actor_id: int, life_time: float) -> None: ...
    def draw_points(self, points, life_time: float) -> None: ...
    def focus_spectator_on(self, actor_id: int) -> None: ...


@dataclass
class _FakeWalker:
    pos: np.ndarray
    cmd_vel: np.ndarray


@dataclass
class FakeWorld:
    """Deterministic in-process world: commanded-velocity walkers + scripted
    teleport vehicles (a ``models.vehicles.VehicleStates`` timeline, read on
    the host: its tensors are copied to numpy once)."""

    dt: float = 0.05
    walker_radius: float = 0.3
    vehicle_timeline: object = None  # models.vehicles.VehicleStates or None
    fail_spawns: set = field(default_factory=set)  # walker indices that fail
    # emulated walker-blueprint library size (CARLA 0.9.13's by default) so
    # the runner's seeded blueprint draw consumes reference-equal entropy
    blueprint_count: int = 41

    def __post_init__(self):
        tl = self.vehicle_timeline
        self._timeline = None if tl is None else {
            name: _host(getattr(tl, name))
            for name in ("pos", "heading", "vel", "active", "extent")}
        self._walkers: dict[int, _FakeWalker] = {}
        self._next_id = 1
        self._spawn_count = 0
        self._step = 0

    # -- clock ------------------------------------------------------------
    def tick(self) -> None:
        # integrate in float32 with the engine's op order (pos + dt*v) so a
        # bridge run is bit-comparable to the headless device rollout
        dt = np.float32(self.dt)
        for w in self._walkers.values():
            step = np.append(w.cmd_vel.astype(np.float32) * dt, np.float32(0.0))
            w.pos = (w.pos.astype(np.float32) + step).astype(np.float32)
        self._step += 1

    def get_sim_time(self) -> float:
        return self._step * self.dt

    # -- walkers ----------------------------------------------------------
    def walker_blueprint_count(self) -> int:
        return self.blueprint_count

    def spawn_walker(self, blueprint, location, yaw, role_name=None) -> int:
        idx = self._spawn_count
        self._spawn_count += 1
        if idx in self.fail_spawns:
            return -1
        actor_id = self._next_id
        self._next_id += 1
        loc = np.asarray(location, float)
        if loc.shape[0] == 2:
            loc = np.r_[loc, 0.0]
        self._walkers[actor_id] = _FakeWalker(pos=loc.copy(),
                                              cmd_vel=np.zeros(2))
        return actor_id

    def destroy_actor(self, actor_id) -> None:
        self._walkers.pop(actor_id, None)

    def get_walker_state(self, actor_id):
        w = self._walkers[actor_id]
        vel3 = np.r_[w.cmd_vel, 0.0]
        return w.pos.copy(), vel3

    def set_walker_velocity(self, actor_id, direction, speed) -> None:
        self._walkers[actor_id].cmd_vel = np.asarray(direction, float)[:2] * speed

    def get_walker_radius(self, actor_id) -> float:
        return self.walker_radius

    # -- debug hooks (no-ops in the fake) -----------------------------------
    def draw_bounding_box(self, actor_id, life_time) -> None:
        pass

    def draw_points(self, points, life_time) -> None:
        pass

    def focus_spectator_on(self, actor_id) -> None:
        pass

    # -- vehicles ---------------------------------------------------------
    def get_vehicles(self) -> list[VehicleObs]:
        tl = self._timeline
        if tl is None:
            return []
        t = min(self._step, tl["pos"].shape[0] - 1)
        out = []
        for v in np.nonzero(tl["active"][t])[0]:
            out.append(VehicleObs(
                actor_id=int(v),
                center=tl["pos"][t, v],
                heading=float(tl["heading"][t, v]),
                velocity=tl["vel"][t, v],
                extent=tl["extent"][v]))
        return out
