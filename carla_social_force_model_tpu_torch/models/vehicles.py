"""Headless vehicle model: scripted trajectories as dense rollout tensors
(port of models/vehicles.py).

The reference's scripted vehicles are teleported to the next trajectory
point each tick with a target velocity along their heading
(run_simulation.py:56-67, carla_simulation.py:107-111); their state is read
back every tick as "dynamic obstacles" with a regenerated ellipse outline
(obstacles.py:297-329).  Headless, the whole trajectory is precomputable:
``(T, V)`` state tensors indexed by the step, and a static per-vehicle local
ellipse template rotated and translated on the device each tick.

Reference timing contract, as in the JAX package: a vehicle spawned at step
s with trajectory/headings/speeds lists appears to the pedestrian simulation
at position ``trajectory[1+j]``, heading ``headings[1+j]``, speed
``speeds[1+j]`` on step ``s+j``, and despawns when the list is exhausted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..env.pointsets import PAD_COORD, ChunkedPointSet, SegmentPointSet
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .spawn import realized_spawn_steps


@dataclass
class VehicleSpec:
    """Host-side description of one scripted ``[[vehicle.vehicle_spawner]]``."""

    trajectory: np.ndarray        # (L, 2) teleport points (index 0 = spawn)
    headings: np.ndarray          # (L,) radians (reference config convention)
    speeds: np.ndarray            # (L,) speeds; speeds[0] unused
    extent: tuple[float, float] = (2.4, 1.1)  # bbox half-extents (x, y)
    spawn_time: float = 0.0
    spawn_interval: float = 5.0
    quantity: int = 1             # reference shares popped lists; keep 1


def trajectory_from_waypoints(waypoints, speed: float, dt: float):
    """Expand a sparse waypoint polyline into per-tick teleport arrays.

    Positions are interpolated at ``speed*dt`` spacing and headings follow
    the segment directions.  Returns ``(trajectory (L,2), headings (L,),
    speeds (L,))`` in the reference's scripted-vehicle format.
    """
    wps = np.asarray(waypoints, np.float64).reshape(-1, 2)
    pts = [wps[0]]
    heads = []
    step = speed * dt
    for a, b in zip(wps[:-1], wps[1:]):
        seg = b - a
        dist = float(np.linalg.norm(seg))
        if dist == 0.0:
            continue
        heading = float(np.arctan2(seg[1], seg[0]))
        n_steps = max(1, int(round(dist / step)))
        for k in range(1, n_steps + 1):
            pts.append(a + seg * (k / n_steps))
            heads.append(heading)
    trajectory = np.asarray(pts)
    headings = np.asarray([heads[0]] + heads if heads else [0.0])
    speeds = np.full(len(trajectory), speed)
    return trajectory, headings, speeds


def ellipse_template(extent_x: float, extent_y: float, resolution: float,
                     size_factor: float = float(np.sqrt(2.0))) -> np.ndarray:
    """Local-frame ellipse outline points (reference obstacles.py:269-281)."""
    circumference = 2.0 * extent_x + 2.0 * extent_y
    samples = max(6, int(circumference / resolution))
    theta = 2.0 * np.pi * np.arange(samples) / samples
    return np.stack([extent_x * np.cos(theta) * size_factor,
                     extent_y * np.sin(theta) * size_factor], axis=-1)


@dataclass(frozen=True)
class VehicleStates:
    """Dense scripted-vehicle rollout state on the device."""

    pos: torch.Tensor        # (T, V, 2)
    heading: torch.Tensor    # (T, V) radians
    vel: torch.Tensor        # (T, V, 2)
    active: torch.Tensor     # (T, V) bool
    extent: torch.Tensor     # (V, 2)
    template: torch.Tensor   # (V, P, 2) local outline, padded
    template_valid: torch.Tensor  # (V, P) bool
    points_per_chunk: int = 128

    @property
    def num_vehicles(self) -> int:
        return self.extent.shape[0]

    @property
    def num_steps(self) -> int:
        return self.pos.shape[0]


def build_vehicle_states(specs: Sequence[VehicleSpec], dt: float,
                         num_steps: int, resolution: float = 0.1,
                         points_per_chunk: int = 128, dtype=np.float32,
                         device: torch.device | str = DEFAULT_DEVICE
                         ) -> VehicleStates | None:
    """Expand scripted vehicle specs into dense per-step tensors on
    ``device`` (drawn on the host exactly as the JAX package does)."""
    device = resolve_device(device)
    rows = []  # (spawn_step, spec)
    for spec in specs:
        for s in realized_spawn_steps(spec.spawn_time, spec.spawn_interval,
                                      min(spec.quantity, 1), dt, num_steps):
            rows.append((s, spec))
    if not rows:
        return None

    v = len(rows)
    pos = np.zeros((num_steps, v, 2), dtype)
    heading = np.zeros((num_steps, v), dtype)
    vel = np.zeros((num_steps, v, 2), dtype)
    active = np.zeros((num_steps, v), bool)
    extent = np.zeros((v, 2), dtype)
    templates = []
    for vi, (s, spec) in enumerate(rows):
        traj = np.asarray(spec.trajectory, dtype).reshape(-1, 2)
        heads = np.asarray(spec.headings, dtype).reshape(-1)
        spds = np.asarray(spec.speeds, dtype).reshape(-1)
        length = min(len(traj), len(heads), len(spds))
        extent[vi] = spec.extent
        templates.append(ellipse_template(spec.extent[0], spec.extent[1],
                                          resolution))
        # visible from index 1 (spawn consumed index 0, same-tick teleport -> 1)
        for j in range(length - 1):
            t = s + j
            if t >= num_steps:
                break
            idx = 1 + j
            pos[t, vi] = traj[idx]
            heading[t, vi] = heads[idx]
            vel[t, vi] = spds[idx] * np.array(
                [np.cos(heads[idx]), np.sin(heads[idx])], dtype)
            active[t, vi] = True

    p_raw = max(len(t) for t in templates)
    p = -(-p_raw // points_per_chunk) * points_per_chunk
    template = np.full((v, p, 2), PAD_COORD, dtype)
    template_valid = np.zeros((v, p), bool)
    for vi, t in enumerate(templates):
        template[vi, : len(t)] = t
        template_valid[vi, : len(t)] = True

    def dev(a):
        return torch.from_numpy(a).to(device)

    return VehicleStates(
        pos=dev(pos), heading=dev(heading), vel=dev(vel), active=dev(active),
        extent=dev(extent), template=dev(template),
        template_valid=dev(template_valid), points_per_chunk=points_per_chunk)


@dataclass(frozen=True)
class VehicleSnapshot:
    """Per-tick vehicle state.  Gap acceptance and the dynamic-obstacle
    force consume this.  A batch of fleets (each crowd of an ensemble or
    sweep steps its own, ``models/autopilot.py``) holds ``(B, V)`` planes
    of center, vel, heading and active; the extents and templates stay
    shared, as the JAX package's vmap leaves them."""

    center: torch.Tensor         # (V, 2), a batch's (B, V, 2)
    vel: torch.Tensor            # (V, 2), a batch's (B, V, 2)
    heading: torch.Tensor        # (V,), a batch's (B, V)
    extent: torch.Tensor         # (V, 2)
    active: torch.Tensor         # (V,), a batch's (B, V)
    template: torch.Tensor       # (V, P, 2)
    template_valid: torch.Tensor  # (V, P)
    points_per_chunk: int = 128

    @property
    def batch(self) -> int | None:
        """B of a batch of fleets, None for one."""
        return self.heading.shape[0] if self.heading.dim() == 2 else None


def vehicle_snapshot_at(vehicles: VehicleStates, t_idx: int) -> VehicleSnapshot:
    """The scripted timeline at step ``t_idx``.

    A step beyond the timeline reads its last row, as the JAX package's
    traced index does (JAX clamps an out-of-range gather index, where a
    torch index would raise), so a rollout longer than the timeline keeps
    the vehicles where the timeline left them."""
    t = min(max(int(t_idx), 0), vehicles.num_steps - 1)
    return VehicleSnapshot(
        center=vehicles.pos[t], vel=vehicles.vel[t],
        heading=vehicles.heading[t], extent=vehicles.extent,
        active=vehicles.active[t], template=vehicles.template,
        template_valid=vehicles.template_valid,
        points_per_chunk=vehicles.points_per_chunk)


def _world_outline(snap: VehicleSnapshot, valid_only: bool):
    """World-frame outline planes ``(wx, wy)`` of shape (V, P) (a batch of
    fleets': (B, V, P)): R(heading) @ template + center, the headless
    equivalent of regenerating the CARLA ellipse border each tick
    (obstacles.py:297-329)."""
    c = torch.cos(snap.heading)[..., None]
    s = torch.sin(snap.heading)[..., None]
    tx, ty = snap.template[..., 0], snap.template[..., 1]
    if valid_only:
        tx = torch.where(snap.template_valid, tx, 0.0)
        ty = torch.where(snap.template_valid, ty, 0.0)
    wx = c * tx - s * ty + snap.center[..., None, 0]
    wy = s * tx + c * ty + snap.center[..., None, 1]
    return wx, wy


def _radii(snap: VehicleSnapshot, perception_threshold, like):
    """The vehicles' filter radii: ``(V,)`` of one threshold, ``(B, V)`` of
    a sweep's ``(B,)`` thresholds."""
    v = snap.extent.shape[0]
    if isinstance(perception_threshold, torch.Tensor):
        return perception_threshold.to(like)[:, None].expand(-1, v)
    return torch.full((v,), float(perception_threshold), dtype=like.dtype,
                      device=like.device)


def snapshot_segment_pointset(snap: VehicleSnapshot, perception_threshold):
    """Segment-major dynamic-obstacle point set from a snapshot (on the
    device): one row per vehicle, for the environment kernels.  A swept
    ``perception_threshold`` (a ``(B,)`` tensor) gives each of the B
    crowds its own filter radii, ``(B, V)``.  A batch of fleets gives each
    crowd its own rows: ``(B, V, P)`` points, ``(B, V)`` centers.

    Returns ``(SegmentPointSet, obstacle_vel (V, 2), active (V,))`` (a
    batch of fleets': ``(B, V, 2)`` and ``(B, V)``)."""
    wx, wy = _world_outline(snap, valid_only=True)
    wx = torch.where(snap.template_valid, wx, PAD_COORD)
    wy = torch.where(snap.template_valid, wy, PAD_COORD)
    pset = SegmentPointSet(
        x=wx, y=wy, center_x=snap.center[..., 0].contiguous(),
        center_y=snap.center[..., 1].contiguous(),
        filter_radius=_radii(snap, perception_threshold, wx))
    return pset, snap.vel, snap.active


def snapshot_pointset(snap: VehicleSnapshot, perception_threshold):
    """Chunked dynamic-obstacle point set from a snapshot (tensors on the
    device; the JAX package's jnp path reads this form).  A swept
    ``perception_threshold`` (a ``(B,)`` tensor) gives each of the B crowds
    its own filter radii, ``(B, V)``; a batch of fleets each crowd its own
    chunks, ``(B, C, K, 2)`` (``chunk_segment`` shared).  Returns
    ``(ChunkedPointSet, obstacle_vel (V, 2), active (V,))`` (a batch of
    fleets': ``(B, V, 2)`` and ``(B, V)``)."""
    wx, wy = _world_outline(snap, valid_only=False)
    world = torch.stack([wx, wy], dim=-1)                 # (..., V, P, 2)
    *lead, v, p, _ = world.shape
    k = snap.points_per_chunk
    n_chunks_per_v = p // k
    valid = (snap.template_valid & snap.active[..., None]).reshape(
        *lead, v * n_chunks_per_v, k)
    chunk_segment = torch.arange(
        v, dtype=torch.int32, device=world.device).repeat_interleave(
            n_chunks_per_v)
    pset = ChunkedPointSet(
        points=world.reshape(*lead, v * n_chunks_per_v, k, 2), valid=valid,
        chunk_segment=chunk_segment, centers=snap.center,
        filter_radius=_radii(snap, perception_threshold, world),
        num_segments=v)
    return pset, snap.vel, snap.active
