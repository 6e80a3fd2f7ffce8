"""Spawn schedules and the per-step spawn (port of models/spawn.py).

A schedule is computed up front on the host (the reference's spawner timing
is deterministic); on the device, spawning is a masked write at the slot
when the rollout reaches the slot's spawn step.  Building schedules from
scenario spawner specs (``build_spawn_schedule``) belongs to the scenario
slice of the port; until then schedules come from :mod:`..api.synthetic` or
from the JAX package through :mod:`..utils.convert`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .routes import RouteBuffer
from .state import PedState

#: pair-force model families selectable per spawner (``pair_force`` key);
#: ids index SpawnSchedule.law_id
LAW_IDS = {"moussaid": 0, "powerlaw": 1, "helbing": 2, "orca": 3}


@dataclass(frozen=True)
class SpawnSchedule:
    """Per-slot spawn data; ``step == -1`` means the slot is never used."""

    step: torch.Tensor            # (N,) int32 realized spawn step
    pos_x: torch.Tensor           # (N,)
    pos_y: torch.Tensor
    vel_x: torch.Tensor           # (N,) initial velocity (toward first wp)
    vel_y: torch.Tensor
    speed: torch.Tensor           # (N,) target walking speed (jittered)
    crossing_speed: torch.Tensor  # (N,)
    margin: torch.Tensor          # (N,) gap-acceptance safety margin
    radius: torch.Tensor          # (N,)
    initial_mode: torch.Tensor    # (N,) int32
    fwp_x: torch.Tensor           # (N,) first waypoint
    fwp_y: torch.Tensor
    routes: RouteBuffer
    #: (N,) int32 social-group id per slot, -1 = ungrouped (host metadata)
    group_id: torch.Tensor | None = None
    #: (N,) f32 per-agent pair-interaction sensitivity (None = homogeneous)
    pair_scale: torch.Tensor | None = None
    #: (N,) int32 per-agent pair-force family (LAW_IDS; -1 = every family)
    law_id: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.step.shape[0]


def apply_spawn(state: PedState, schedule: SpawnSchedule, t_idx: int) -> PedState:
    """Activate slots whose spawn step is ``t_idx`` (masked write-at-slot).

    Initial FSM state replicates PedModeManager.__init__ (reference :18-28):
    the target speed starts at the walking speed even when the initial mode
    is CROSSING_ROAD.
    """
    newly = (schedule.step == t_idx) & ~state.spawned

    def sel(new, old):
        return torch.where(newly, new, old)

    return PedState(
        pos_x=sel(schedule.pos_x, state.pos_x),
        pos_y=sel(schedule.pos_y, state.pos_y),
        vel_x=sel(schedule.vel_x, state.vel_x),
        vel_y=sel(schedule.vel_y, state.vel_y),
        radius=sel(schedule.radius, state.radius),
        base_speed=sel(schedule.speed, state.base_speed),
        crossing_speed=sel(schedule.crossing_speed, state.crossing_speed),
        safety_margin=sel(schedule.margin, state.safety_margin),
        fsm_target=sel(schedule.speed, state.fsm_target),
        applied_target=sel(schedule.speed, state.applied_target),
        mode=sel(schedule.initial_mode, state.mode),
        next_mode_time=torch.where(newly, -1.0, state.next_mode_time),
        wp_x=sel(schedule.fwp_x, state.wp_x),
        wp_y=sel(schedule.fwp_y, state.wp_y),
        waypoint_idx=torch.where(newly, 0, state.waypoint_idx),
        alive=state.alive | newly,
        spawned=state.spawned | newly,
    )
