"""The headless simulation tick and rollouts (port of models/stepper.py).

One step keeps the reference's per-tick order (see the JAX package):

1. spawn due pedestrians;
2. capture the applied target speeds, before any transition this tick;
3. IDLE promotion;
4. gap acceptance for CHECKING_TRAFFIC pedestrians against this step's
   scripted vehicles (with no vehicles every gap is accepted);
5. the recorded snapshot;
6. the force sum: acceleration, the Moussaid pair force, and the
   environment forces (borders, space repulsion, static and dynamic
   obstacles);
7. v' = cap(v + dt*F, applied_target * factor);
8. waypoint arrival: advance and mode change, or despawn;
9. x' = x + dt*v'.

This covers the headless crowd (BASELINE config #1), its environment
(configs #2 and #3) and the interaction cutoff of large crowds.  Terms the
JAX step computes and this port does not have yet raise
``NotImplementedError`` naming the slice that brings them, rather than
being skipped.

The device chooses the kernel path: the CUDA kernels on a card, the plain
PyTorch versions on the CPU (ops/cuda_forces.py, ops/cuda_env.py).  A
rollout is an eager Python loop over steps; capturing it as a CUDA graph is
later work.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..env.pointsets import ChunkedPointSet, SegmentPointSet, segment_major
from ..ops import forces, vecmath
from ..ops.cuda_env import fused_environment_terms
from ..ops.cuda_forces import pedestrian_force_kernel, pedestrian_force_sorted
from ..ops.spatial import morton_order
from . import modes
from .gap import gap_ready
from .params import SfmParams
from .spawn import SpawnSchedule, apply_spawn
from .state import PedState
from .vehicles import (VehicleSnapshot, VehicleStates,
                       snapshot_segment_pointset, vehicle_snapshot_at)


@dataclass(frozen=True)
class Scene:
    """Everything the stepper needs besides the pedestrian state.

    ``borders`` and ``static_obstacles`` are the host-side point sets;
    :func:`prepare_scene` adds their segment-major layouts on the spawn
    schedule's device (``borders_seg``, ``static_obstacles_seg``), which is
    what the forces read.  ``autopilot`` and ``groups`` exist so that a
    scene carrying them fails loudly instead of being simulated without
    them."""

    spawn: SpawnSchedule
    borders: ChunkedPointSet | None = None
    static_obstacles: ChunkedPointSet | None = None
    static_obstacle_vel: torch.Tensor | None = None  # (S, 2), zeros
    vehicles: VehicleStates | None = None
    autopilot: object | None = None
    groups: object | None = None
    borders_seg: SegmentPointSet | None = None
    static_obstacles_seg: SegmentPointSet | None = None


def prepare_scene(scene: Scene) -> Scene:
    """Add the segment-major layouts of the scene's borders and static
    obstacles on the spawn schedule's device, and zero obstacle velocities
    where none are given.  Host-side work, done once per scenario;
    idempotent.  (The JAX package's ``analytic`` and ``orca`` layouts
    belong to later slices of the port.)"""
    device = scene.spawn.step.device
    upd = {}
    if scene.borders is not None and scene.borders_seg is None:
        upd["borders_seg"] = segment_major(scene.borders, device)
    if scene.static_obstacles is not None:
        if scene.static_obstacles_seg is None:
            upd["static_obstacles_seg"] = segment_major(
                scene.static_obstacles, device)
        if scene.static_obstacle_vel is None:
            upd["static_obstacle_vel"] = torch.zeros(
                (scene.static_obstacles.num_segments, 2),
                dtype=torch.float32, device=device)
    return dataclasses.replace(scene, **upd) if upd else scene


@dataclass(frozen=True)
class StepConfig:
    """Per-rollout configuration."""

    dt: float = 0.05
    waypoint_threshold: float = 2.0
    despawn_on_arrival: bool = True
    #: rows per block of the plain pair force (bounds its (rows, N)
    #: intermediates; the kernels do not read it)
    row_block: int = 1024
    #: Newton's-third-law pair kernel (each unordered pair once, results
    #: equal up to f32 summation order); False runs the dense kernel.  The
    #: JAX package's ``pallas_symmetric``
    symmetric_pairs: bool = True
    #: run the plain PyTorch pair force even on a card: the reference the
    #: kernel path is compared with, never the default
    plain_pair_force: bool = False
    #: run the plain PyTorch environment forces even on a card (no sort, no
    #: kernel): the reference the kernel path is compared with, never the
    #: default
    plain_env_force: bool = False
    #: the JAX package's compacted environment grid (the urban slice of the
    #: port) and analytic border geometry (the analytic slice); True raises
    env_compact: bool = False
    env_analytic: bool = False
    #: interaction cutoff [m]: pairs farther apart contribute nothing, and
    #: the pair force runs on curve-sorted planes whose tile pairs beyond
    #: the cutoff are skipped (ops/cuda_forces.pedestrian_force_sorted).
    #: None = all pairs.  A cutoff >= 110*gamma*(2*lambda*v_max + 1) is
    #: f32-exact; smaller ones truncate the interaction range
    interaction_cutoff: float | None = None
    #: with a cutoff, drive the launch by a per-step survivor table above
    #: the static gate of ops/pair_grid.compact_gate (exact either way).
    #: The JAX package's ``pallas_compact``
    compact_pairs: bool = True
    #: survivor-table width (0 = auto); the JAX package's ``pallas_max_surv``
    pair_max_surv: int = 0
    #: space-filling curve of the cutoff sort: "hilbert" or "morton"
    spatial_order: str = "hilbert"


class StepRecord(NamedTuple):
    """Per-step snapshot; ``pos``/``vel`` are (T, N, 2)."""

    pos: torch.Tensor
    vel: torch.Tensor
    mode: torch.Tensor
    alive: torch.Tensor


class RecordXY(NamedTuple):
    """Planar per-step snapshot (see StepRecord)."""

    pos_x: torch.Tensor
    pos_y: torch.Tensor
    vel_x: torch.Tensor
    vel_y: torch.Tensor
    mode: torch.Tensor
    alive: torch.Tensor

    def assemble(self) -> StepRecord:
        return StepRecord(
            pos=vecmath.stack_xy(self.pos_x, self.pos_y),
            vel=vecmath.stack_xy(self.vel_x, self.vel_y),
            mode=self.mode, alive=self.alive)


def _not_ported(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} is not ported to PyTorch yet (the {slice_name} slice of "
        f"the port); run it on the JAX package")


def check_supported(scene: Scene, params: SfmParams, cfg: StepConfig) -> None:
    """Raise ``NotImplementedError`` for every term the JAX step would
    compute for this (scene, params, cfg) that this slice does not have."""
    if cfg.env_compact:
        _not_ported("env_compact (the compacted environment kernels)",
                    "urban")
    if cfg.env_analytic:
        _not_ported("env_analytic (the analytic border geometry)",
                    "analytic border")
    if scene.autopilot is not None:
        _not_ported("the autopilot vehicle fleet", "urban")
    if params.enable_powerlaw:
        _not_ported("the power-law pair force", "model-family")
    if params.enable_ped_repulsive:
        _not_ported("the Helbing pair force", "model-family")
    if params.enable_group and scene.groups is not None:
        _not_ported("the social-group force", "model-family")
    if params.enable_orca:
        _not_ported("ORCA", "model-family")
    if scene.spawn.pair_scale is not None or scene.spawn.law_id is not None:
        _not_ported("per-agent pair_scale/law_id", "model-family")


def _segments(pset, seg, name):
    """The segment-major layout of a scene's point set: raises when the
    scene was not prepared; None when the set holds no point (its force is
    zero)."""
    if seg is None and pset is not None and bool(np.asarray(pset.valid).any()):
        raise ValueError(f"scene.{name} has no segment-major layout: build "
                         f"the scene with prepare_scene (make_rollout_fn "
                         f"and rollout do)")
    return seg


def force_terms(state: PedState, scene: Scene, params: SfmParams,
                cfg: StepConfig, veh_snap: VehicleSnapshot | None = None
                ) -> dict:
    """Enabled force terms by name, each an ``(fx, fy)`` plane pair, in the
    JAX package's order.  ``veh_snap``: this step's vehicles."""
    check_supported(scene, params, cfg)
    borders = _segments(scene.borders, scene.borders_seg, "borders")
    statics = _segments(scene.static_obstacles, scene.static_obstacles_seg,
                        "static_obstacles")
    cutoff = cfg.interaction_cutoff
    order = None
    if (cutoff is not None and params.enable_pedestrian
            and not cfg.plain_pair_force and not cfg.plain_env_force
            and cfg.spatial_order == "hilbert"):
        # the environment kernels sort by the same key with the same stable
        # sort: one permutation serves both (it changes no result)
        order = morton_order(state.pos_x, state.pos_y, state.alive, "hilbert")
    env = ({} if cfg.plain_env_force
           else fused_environment_terms(state, scene, params, veh_snap,
                                        order=order))
    zero = torch.zeros_like(state.pos_x)
    terms: dict = {}
    if params.enable_acceleration:
        terms["acceleration_force"] = forces.acceleration_force_xy(
            state.pos_x, state.pos_y, state.vel_x, state.vel_y,
            state.wp_x, state.wp_y, state.applied_target,
            params.acceleration)
    if params.enable_pedestrian:
        args = (state.pos_x, state.pos_y, state.vel_x, state.vel_y,
                state.radius, state.alive, params.pedestrian)
        if cfg.plain_pair_force:
            terms["pedestrian_force"] = forces.pedestrian_force(
                *args, use_ped_radius=params.use_ped_radius,
                row_block=cfg.row_block, cutoff=cutoff)
        elif cutoff is not None:
            terms["pedestrian_force"] = pedestrian_force_sorted(
                *args, cutoff, use_ped_radius=params.use_ped_radius,
                symmetric=cfg.symmetric_pairs, compact=cfg.compact_pairs,
                max_surv=cfg.pair_max_surv, spatial_order=cfg.spatial_order,
                row_block=cfg.row_block, order=order)
        else:
            terms["pedestrian_force"] = pedestrian_force_kernel(
                *args, use_ped_radius=params.use_ped_radius,
                symmetric=cfg.symmetric_pairs, row_block=cfg.row_block)
    if params.enable_border and scene.borders is not None:
        terms["border_force"] = (
            env["border_force"] if "border_force" in env
            else (zero, zero) if borders is None
            else forces.border_force(
                state.pos_x, state.pos_y, state.mode, state.radius,
                state.alive, borders, params.border,
                use_ped_radius=params.use_ped_radius))
    if params.enable_static_obstacle and scene.static_obstacles is not None:
        terms["static_obstacle_force"] = (
            env["static_obstacle_force"] if "static_obstacle_force" in env
            else (zero, zero) if statics is None
            else forces.obstacle_force(
                state.pos_x, state.pos_y, state.vel_x, state.vel_y,
                state.radius, state.alive, statics, scene.static_obstacle_vel,
                params.static_obstacle, use_ped_radius=params.use_ped_radius))
    if params.enable_space_repulsive and scene.borders is not None:
        terms["space_repulsive_force"] = (
            env["space_repulsive_force"] if "space_repulsive_force" in env
            else (zero, zero) if borders is None
            else forces.space_repulsive_force(
                state.pos_x, state.pos_y, state.mode, state.alive, borders,
                params.space_repulsive))
    if params.enable_dynamic_obstacle and veh_snap is not None:
        if "dynamic_obstacle_force" in env:
            terms["dynamic_obstacle_force"] = env["dynamic_obstacle_force"]
        else:
            p = params.dynamic_obstacle
            vset, vvel, vact = snapshot_segment_pointset(
                veh_snap, p.perception_threshold)
            terms["dynamic_obstacle_force"] = forces.obstacle_force(
                state.pos_x, state.pos_y, state.vel_x, state.vel_y,
                state.radius, state.alive, vset, vvel, p,
                use_ped_radius=params.use_ped_radius, obstacle_active=vact)
    return terms


def compute_forces(state: PedState, scene: Scene, params: SfmParams,
                   cfg: StepConfig, veh_snap: VehicleSnapshot | None = None):
    """Sum of enabled forces, masked to alive pedestrians: ``(fx, fy)``."""
    terms = force_terms(state, scene, params, cfg, veh_snap)
    fx = torch.zeros_like(state.pos_x)
    fy = torch.zeros_like(state.pos_y)
    for tx, ty in terms.values():
        fx = fx + tx
        fy = fy + ty
    return (torch.where(state.alive, fx, 0.0),
            torch.where(state.alive, fy, 0.0))


def tick_core(state: PedState, scene: Scene, params: SfmParams,
              cfg: StepConfig, sim_time: float,
              veh_snap: VehicleSnapshot | None = None):
    """Steps 2-8 of the tick (everything except spawn and integration).

    ``sim_time`` is a Python float holding a float32 value; ``veh_snap``
    this step's vehicles.  Returns ``(state', (vx, vy), finished,
    record)``: the commanded velocity and the pedestrians that arrived at
    their final waypoint this tick."""
    check_supported(scene, params, cfg)
    alive = state.alive

    # 2. applied target speed = FSM target at tick start
    applied = torch.where(alive, state.fsm_target, state.applied_target)

    # 3. IDLE promotion
    mode, fsm_t, nmt = modes.tick_idle(
        state.mode, state.fsm_target, state.next_mode_time,
        state.base_speed, state.crossing_speed, alive, sim_time)

    # 4. gap acceptance: with no vehicles in the scene every gap is accepted
    checking = alive & (mode == modes.CHECKING_TRAFFIC)
    if veh_snap is not None:
        checking = checking & gap_ready(
            state.pos_x, state.pos_y, state.wp_x, state.wp_y,
            state.crossing_speed, state.safety_margin, veh_snap.center,
            veh_snap.vel, veh_snap.extent, veh_snap.active,
            strict_parity=params.strict_parity)
    mode, fsm_t, nmt = modes.set_mode(
        mode, fsm_t, nmt, state.base_speed, state.crossing_speed,
        modes.CROSSING_ROAD, checking, sim_time)

    state = dataclasses.replace(
        state, fsm_target=fsm_t, applied_target=applied, mode=mode,
        next_mode_time=nmt)

    # 5. snapshot (reference records after transitions, before forces)
    record = RecordXY(pos_x=state.pos_x, pos_y=state.pos_y,
                      vel_x=state.vel_x, vel_y=state.vel_y,
                      mode=state.mode, alive=state.alive)

    # 6-7. forces and commanded velocity
    fx, fy = compute_forces(state, scene, params, cfg, veh_snap)
    vx, vy = vecmath.cap_velocity_xy(state.vel_x + cfg.dt * fx,
                                     state.vel_y + cfg.dt * fy,
                                     state.max_speed(params.max_speed_factor))
    vx = torch.where(alive, vx, 0.0)
    vy = torch.where(alive, vy, 0.0)

    # 8. waypoint arrival (2-D distance)
    dist_wp = vecmath.norm_xy(state.wp_x - state.pos_x,
                              state.wp_y - state.pos_y)
    arrived = alive & (dist_wp < cfg.waypoint_threshold)
    routes = scene.spawn.routes
    if routes.max_waypoints == 1:
        # single-waypoint routes never advance: arrival is route exhaustion
        return state, (vx, vy), arrived, record
    has_next = (state.waypoint_idx + 1) < routes.count
    advance = arrived & has_next
    new_idx = torch.where(advance, state.waypoint_idx + 1, state.waypoint_idx)
    # one-hot masked reduction over the (small) W axis, as in the JAX step
    onehot = (torch.arange(routes.max_waypoints, dtype=new_idx.dtype,
                           device=new_idx.device) == new_idx[:, None])
    next_crossing = (onehot & routes.crossing).any(dim=-1)
    next_wp_x = torch.where(onehot, routes.wp_x, 0.0).sum(dim=-1)
    next_wp_y = torch.where(onehot, routes.wp_y, 0.0).sum(dim=-1)
    wp_x = torch.where(advance, next_wp_x, state.wp_x)
    wp_y = torch.where(advance, next_wp_y, state.wp_y)
    desired_mode = torch.where(next_crossing, modes.CROSSING_ROAD,
                               modes.WALKING_SIDEWALK).to(torch.int32)
    mode, fsm_t, nmt = modes.set_mode(
        state.mode, state.fsm_target, state.next_mode_time,
        state.base_speed, state.crossing_speed, desired_mode, advance, sim_time)
    finished = arrived & ~has_next

    state = dataclasses.replace(
        state, fsm_target=fsm_t, mode=mode, next_mode_time=nmt,
        wp_x=wp_x, wp_y=wp_y, waypoint_idx=new_idx)
    return state, (vx, vy), finished, record


def sim_time_of(t_idx: int, dt: float) -> float:
    """Simulation time of step ``t_idx`` as the JAX step computes it:
    ``float32(step) * float32(dt)``, rounded in float32 (a double product
    can land on the other side of an IDLE deadline)."""
    return float(np.float32(t_idx) * np.float32(dt))


def simulation_step(state: PedState, scene: Scene, params: SfmParams,
                    cfg: StepConfig, t_idx: int):
    """One headless tick (spawn, core, Euler step) of a prepared scene
    (:func:`prepare_scene`).  Returns ``(new_state, RecordXY)``."""
    check_supported(scene, params, cfg)
    sim_time = sim_time_of(t_idx, cfg.dt)

    # 1. spawn
    state = apply_spawn(state, scene.spawn, t_idx)

    veh_snap = (vehicle_snapshot_at(scene.vehicles, t_idx)
                if scene.vehicles is not None else None)
    state, (vx, vy), finished, record = tick_core(
        state, scene, params, cfg, sim_time, veh_snap)

    alive = state.alive
    if cfg.despawn_on_arrival:
        alive = alive & ~finished

    # 9. integrate (headless CARLA-equivalent position update)
    pos_x = torch.where(alive, state.pos_x + cfg.dt * vx, state.pos_x)
    pos_y = torch.where(alive, state.pos_y + cfg.dt * vy, state.pos_y)
    vel_x = torch.where(alive, vx, 0.0)
    vel_y = torch.where(alive, vy, 0.0)
    return dataclasses.replace(state, pos_x=pos_x, pos_y=pos_y,
                               vel_x=vel_x, vel_y=vel_y, alive=alive), record


def rollout(state: PedState, scene: Scene, params: SfmParams, cfg: StepConfig,
            num_steps: int, record: bool = True, start_step: int = 0,
            record_stride: int = 1):
    """Run ``num_steps`` ticks from ``start_step``.

    Returns ``(final_state, StepRecord)`` with ``(T, N)`` planes
    (``(T, N, 2)`` for pos/vel) when ``record``, else
    ``(final_state, None)``.  ``record_stride=k`` keeps every k-th tick's
    snapshot (the first of each stride); ``num_steps`` must then be a
    multiple of ``k``.  The records are preallocated and filled in place.
    The scene is prepared first (:func:`prepare_scene`; a no-op when it
    already is).
    """
    check_supported(scene, params, cfg)
    scene = prepare_scene(scene)
    recs = None
    if record:
        if record_stride < 1:
            raise ValueError("record_stride must be positive")
        if num_steps % record_stride != 0:
            raise ValueError("num_steps must be a multiple of record_stride")
        t_rec = num_steps // record_stride
        n, dev = state.capacity, state.device
        recs = RecordXY(
            *(torch.empty((t_rec, n), dtype=torch.float32, device=dev)
              for _ in range(4)),
            mode=torch.empty((t_rec, n), dtype=torch.int32, device=dev),
            alive=torch.empty((t_rec, n), dtype=torch.bool, device=dev))
    for k in range(num_steps):
        state, rec = simulation_step(state, scene, params, cfg,
                                     start_step + k)
        if record and k % record_stride == 0:
            for buf, val in zip(recs, rec):
                buf[k // record_stride].copy_(val)
    return state, (recs.assemble() if record else None)


def make_rollout_fn(scene: Scene, params: SfmParams, cfg: StepConfig,
                    num_steps: int, record: bool = True,
                    record_stride: int = 1):
    """Rollout closure ``run(state) -> (final_state, StepRecord | None)``,
    the counterpart of the JAX package's jitted closure.  The scene is
    prepared once, here.  The state is not modified, so callers may reuse
    it across runs."""
    check_supported(scene, params, cfg)
    scene = prepare_scene(scene)

    def run(state: PedState):
        return rollout(state, scene, params, cfg, num_steps, record=record,
                       record_stride=record_stride)

    return run
