"""Pedestrian mode finite-state machine as masked tensor updates (port of
models/modes.py).

The whole population's FSM state lives in three ``(N,)`` tensors (``mode``,
``fsm_target``, ``next_mode_time``) and every transition is a
``torch.where``.  The reference's quirks are kept exactly as in the JAX
package: ``ROAD_TO_SIDEWALK`` keeps the previous target speed, and the
applied target speed is captured by the stepper before any transition.

``sim_time`` is a Python float holding a float32 value (the stepper computes
it as ``float32(step) * float32(dt)``, as the JAX package does), so the
comparisons and the IDLE deadline below round exactly as they do there.
"""
from __future__ import annotations

import numpy as np
import torch

# PedMode enum values (reference ped_mode_manager.py:4-9)
IDLE = 0
WALKING_SIDEWALK = 1
CROSSING_ROAD = 2
ROAD_TO_SIDEWALK = 3
CHECKING_TRAFFIC = 4

#: seconds an IDLE pedestrian waits before auto-promoting to WALKING_SIDEWALK
#: (reference ped_mode_manager.py:28 ``waiting_time = 5``)
IDLE_WAITING_TIME = 5.0

MODE_NAMES = {
    IDLE: "IDLE",
    WALKING_SIDEWALK: "WALKING_SIDEWALK",
    CROSSING_ROAD: "CROSSING_ROAD",
    ROAD_TO_SIDEWALK: "ROAD_TO_SIDEWALK",
    CHECKING_TRAFFIC: "CHECKING_TRAFFIC",
}


def activate_mode(mode, fsm_target, next_mode_time, base_speed, crossing_speed,
                  new_mode, who, sim_time: float):
    """Vectorized ``PedModeManager._activate_mode`` (reference :49-70).

    ``who`` is a boolean mask of pedestrians whose mode becomes ``new_mode``
    (an int tensor or a Python int).  Returns updated
    ``(mode, fsm_target, next_mode_time)``.
    """
    if not torch.is_tensor(new_mode):
        new_mode = torch.full_like(mode, int(new_mode))
    # per-mode target speeds; ROAD_TO_SIDEWALK keeps the previous target
    target_by_mode = torch.where(
        new_mode == WALKING_SIDEWALK, base_speed,
        torch.where(new_mode == CROSSING_ROAD, crossing_speed,
                    torch.where(new_mode == ROAD_TO_SIDEWALK, fsm_target, 0.0)))
    fsm_target = torch.where(who, target_by_mode, fsm_target)
    deadline = float(np.float32(sim_time) + np.float32(IDLE_WAITING_TIME))
    next_mode_time = torch.where(who & (new_mode == IDLE), deadline,
                                 next_mode_time)
    mode = torch.where(who, new_mode, mode)
    return mode, fsm_target, next_mode_time


def set_mode(mode, fsm_target, next_mode_time, base_speed, crossing_speed,
             new_mode, who, sim_time: float):
    """Vectorized ``PedModeManager.set_mode`` (reference :37-47).

    Inserts the intermediate modes: WALKING->CROSSING detours through
    CHECKING_TRAFFIC and CROSSING->WALKING through ROAD_TO_SIDEWALK.
    """
    if not torch.is_tensor(new_mode):
        new_mode = torch.full_like(mode, int(new_mode))
    to_checking = (mode == WALKING_SIDEWALK) & (new_mode == CROSSING_ROAD)
    to_road_to_sw = (mode == CROSSING_ROAD) & (new_mode == WALKING_SIDEWALK)
    actual = torch.where(to_checking, CHECKING_TRAFFIC,
                         torch.where(to_road_to_sw, ROAD_TO_SIDEWALK, new_mode))
    return activate_mode(mode, fsm_target, next_mode_time, base_speed,
                         crossing_speed, actual, who, sim_time)


def tick_idle(mode, fsm_target, next_mode_time, base_speed, crossing_speed,
              alive, sim_time: float):
    """Vectorized ``PedModeManager.tick`` (reference :30-35): IDLE pedestrians
    whose waiting time elapsed start walking."""
    promote = alive & (mode == IDLE) & (next_mode_time <= sim_time)
    return activate_mode(mode, fsm_target, next_mode_time, base_speed,
                         crossing_speed, WALKING_SIDEWALK, promote, sim_time)
