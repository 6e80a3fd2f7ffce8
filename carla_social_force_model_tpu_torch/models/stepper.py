"""The headless simulation tick and rollouts (port of models/stepper.py).

One step keeps the reference's per-tick order (see the JAX package):

1. spawn due pedestrians;
2. capture the applied target speeds, before any transition this tick;
3. IDLE promotion;
4. gap acceptance for CHECKING_TRAFFIC pedestrians (with no vehicles every
   gap is accepted);
5. the recorded snapshot;
6. the force sum: acceleration plus the Moussaid pair force;
7. v' = cap(v + dt*F, applied_target * factor);
8. waypoint arrival: advance and mode change, or despawn;
9. x' = x + dt*v'.

This slice covers the headless crowd (BASELINE config #1).  Terms the JAX
step computes and this port does not have yet raise ``NotImplementedError``
naming the slice that brings them, rather than being skipped.

The device chooses the pair-force path: the CUDA kernels on a card, the
plain PyTorch version on the CPU (ops/cuda_forces.py).  A rollout is an
eager Python loop over steps; capturing it as a CUDA graph is later work.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import forces, vecmath
from ..ops.cuda_forces import pedestrian_force_kernel
from . import modes
from .params import SfmParams
from .spawn import SpawnSchedule, apply_spawn
from .state import PedState


@dataclass(frozen=True)
class Scene:
    """Everything the stepper needs besides the pedestrian state.

    Only ``spawn`` is supported by this slice; the other fields exist so
    that a scene carrying them fails loudly instead of being simulated
    without them."""

    spawn: SpawnSchedule
    borders: object | None = None
    static_obstacles: object | None = None
    vehicles: object | None = None
    autopilot: object | None = None
    groups: object | None = None


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
    #: interaction cutoff [m]; not supported by this slice (raises)
    interaction_cutoff: float | None = None


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
    if cfg.interaction_cutoff is not None:
        _not_ported("interaction_cutoff", "large-N cutoff")
    if scene.borders is not None and (params.enable_border
                                      or params.enable_space_repulsive):
        _not_ported("the border and space-repulsive forces", "environment")
    if scene.static_obstacles is not None and params.enable_static_obstacle:
        _not_ported("the static obstacle force", "environment")
    if scene.vehicles is not None:
        _not_ported("vehicles (gap acceptance, dynamic obstacle force)",
                    "environment")
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


def force_terms(state: PedState, scene: Scene, params: SfmParams,
                cfg: StepConfig) -> dict:
    """Enabled force terms by name, each an ``(fx, fy)`` plane pair."""
    check_supported(scene, params, cfg)
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
                row_block=cfg.row_block)
        else:
            terms["pedestrian_force"] = pedestrian_force_kernel(
                *args, use_ped_radius=params.use_ped_radius,
                symmetric=cfg.symmetric_pairs, row_block=cfg.row_block)
    return terms


def compute_forces(state: PedState, scene: Scene, params: SfmParams,
                   cfg: StepConfig):
    """Sum of enabled forces, masked to alive pedestrians: ``(fx, fy)``."""
    terms = force_terms(state, scene, params, cfg)
    fx = torch.zeros_like(state.pos_x)
    fy = torch.zeros_like(state.pos_y)
    for tx, ty in terms.values():
        fx = fx + tx
        fy = fy + ty
    return (torch.where(state.alive, fx, 0.0),
            torch.where(state.alive, fy, 0.0))


def tick_core(state: PedState, scene: Scene, params: SfmParams,
              cfg: StepConfig, sim_time: float):
    """Steps 2-8 of the tick (everything except spawn and integration).

    ``sim_time`` is a Python float holding a float32 value.  Returns
    ``(state', (vx, vy), finished, record)``: the commanded velocity and the
    pedestrians that arrived at their final waypoint this tick."""
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
    fx, fy = compute_forces(state, scene, params, cfg)
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
    """One headless tick (spawn, core, Euler step).  Returns
    ``(new_state, RecordXY)``."""
    sim_time = sim_time_of(t_idx, cfg.dt)

    # 1. spawn
    state = apply_spawn(state, scene.spawn, t_idx)

    state, (vx, vy), finished, record = tick_core(
        state, scene, params, cfg, sim_time)

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
    """
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
    the counterpart of the JAX package's jitted closure.  The state is not
    modified, so callers may reuse it across runs."""

    def run(state: PedState):
        return rollout(state, scene, params, cfg, num_steps, record=record,
                       record_stride=record_stride)

    return run
