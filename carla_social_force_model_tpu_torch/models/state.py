"""Fixed-capacity planar pedestrian state (port of models/state.py).

The population lives in ``(capacity,)`` tensors with ``alive`` / ``spawned``
masks: spawn is a masked write at the slot, despawn clears the mask.
Coordinates are separate x/y planes, as in the JAX package, so the port's
public functions take and return the same planes; ``pos`` / ``vel`` /
``waypoint`` assemble ``(N, 2)`` views for host-side consumers.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.vecmath import stack_xy
from ..utils.device import DEFAULT_DEVICE, resolve_device
from . import modes


@dataclass(frozen=True)
class PedState:
    """Per-slot pedestrian state tensors (all shaped ``(capacity,)``)."""

    pos_x: torch.Tensor          # (N,) location [m]
    pos_y: torch.Tensor
    vel_x: torch.Tensor          # (N,) velocity [m/s]
    vel_y: torch.Tensor
    radius: torch.Tensor         # (N,)  pedestrian radius [m]
    base_speed: torch.Tensor     # (N,)  configured walking target speed
    crossing_speed: torch.Tensor  # (N,) crossing_speed_factor * base_speed
    safety_margin: torch.Tensor  # (N,)  gap-acceptance safety margin [s]
    fsm_target: torch.Tensor     # (N,)  FSM-internal target speed
    applied_target: torch.Tensor  # (N,) target speed applied this tick
    mode: torch.Tensor           # (N,)  int32 PedMode
    next_mode_time: torch.Tensor  # (N,) IDLE promotion deadline [s]
    wp_x: torch.Tensor           # (N,) current next waypoint
    wp_y: torch.Tensor
    waypoint_idx: torch.Tensor   # (N,)  int32 index into the route buffer
    alive: torch.Tensor          # (N,)  bool: currently simulated
    spawned: torch.Tensor        # (N,)  bool: slot has been activated

    @property
    def capacity(self) -> int:
        return self.pos_x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos_x.device

    @property
    def pos(self) -> torch.Tensor:
        return stack_xy(self.pos_x, self.pos_y)

    @property
    def vel(self) -> torch.Tensor:
        return stack_xy(self.vel_x, self.vel_y)

    @property
    def waypoint(self) -> torch.Tensor:
        return stack_xy(self.wp_x, self.wp_y)

    def max_speed(self, max_speed_factor: float) -> torch.Tensor:
        """Speed cap = applied target speed * factor (reference
        pedestrian_state.py:72-73 with the effective default factor)."""
        return self.applied_target * max_speed_factor

    @staticmethod
    def empty(capacity: int, device: torch.device | str = DEFAULT_DEVICE,
              dtype: torch.dtype = torch.float32) -> "PedState":
        device = resolve_device(device)

        def z():
            return torch.zeros((capacity,), dtype=dtype, device=device)
        return PedState(
            pos_x=z(), pos_y=z(), vel_x=z(), vel_y=z(), radius=z(),
            base_speed=z(), crossing_speed=z(), safety_margin=z(),
            fsm_target=z(), applied_target=z(),
            mode=torch.full((capacity,), modes.WALKING_SIDEWALK,
                            dtype=torch.int32, device=device),
            next_mode_time=torch.full((capacity,), -1.0, dtype=dtype,
                                      device=device),
            wp_x=z(), wp_y=z(),
            waypoint_idx=torch.zeros((capacity,), dtype=torch.int32,
                                     device=device),
            alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
            spawned=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )
