"""Spawn schedules and the per-step spawn (port of models/spawn.py).

A schedule is computed up front on the host (the reference's spawner timing
is deterministic); on the device, spawning is a masked write at the slot
when the rollout reaches the slot's spawn step.  :func:`build_spawn_schedule`
expands a scenario's spawner specs (``api/scenario.py``) into the schedule
on the host, with the reference's seeded per-walker draws, exactly as the
JAX package does, and moves it to the device once.  Scripted vehicles
(:mod:`.vehicles`) share :func:`realized_spawn_steps`.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device
from . import modes
from .routes import RouteBuffer, build_route_buffer
from .state import PedState

#: pair-force model families selectable per spawner (``pair_force`` key);
#: ids index SpawnSchedule.law_id
LAW_IDS = {"moussaid": 0, "powerlaw": 1, "helbing": 2, "orca": 3}

# Size of CARLA 0.9.13's walker blueprint library (walker.pedestrian.0001 ..
# .0041; the reference pins carla==0.9.13 in requirements.txt:1).  The
# reference's seeded per-walker `random.choice(walker_blueprints)`
# (pedestrian_spawner.py:133-138) consumes RNG entropy that depends only on
# the library size, so emulating the draw with the right count makes the
# subsequent speed-jitter draw match the reference bit-for-bit.  Override
# with the `walker.blueprint_count` scenario key for other CARLA versions.
WALKER_BLUEPRINT_COUNT = 41


@dataclass
class SpawnerSpec:
    """Host-side description of one ``[[walker.ped_spawner]]`` entry."""

    spawn_location: np.ndarray          # (2,) or (3,) - z ignored
    waypoints: np.ndarray               # (W, 2/3) including final destination
    crossing_road: Sequence[bool]       # aligned with waypoints
    speed: float = 1.2
    blueprint: str | None = None
    quantity: int = 1
    spawn_time: float = 0.0
    spawn_interval: float = 3.0
    crossing_speed_factor: float = 1.5
    crossing_safety_margin: float = 1.5
    radius: float = 0.3                 # headless substitute for CARLA bbox
    #: social-group size (Moussaid-2010 group forces, models/groups.py):
    #: consecutive walkers of this spawner form groups of this many members
    #: (0/1 = no groups).  Beyond-reference capability.
    group_size: int = 0
    #: per-agent pair-interaction sensitivity (beyond-reference crowd
    #: heterogeneity): scales the pedestrian-interaction force each walker
    #: FEELS (row-wise F_i *= s_i after the pairwise sum, so it composes
    #: exactly with every kernel path incl. the Newton's-third-law and
    #: ring launches).  0 = oblivious (others still avoid it), 1 =
    #: reference behavior.
    interaction_scale: float = 1.0
    #: uniform +-jitter half-width on interaction_scale, drawn per walker
    #: from a DEDICATED seeded stream (never perturbs the reference's
    #: blueprint/speed draw parity)
    variate_interaction: float = 0.0
    #: per-agent pair-force model family (mixed-model crowds): "moussaid",
    #: "powerlaw", or "helbing" restricts THIS spawner's walkers to
    #: perceiving the crowd through that one family (the family must be
    #: enabled in ``[forces]``); None (default) = the walker feels every
    #: enabled family, the homogeneous behavior.  Row-masked after the
    #: pairwise sum, so it composes with every kernel path.
    pair_force: str | None = None


@dataclass(frozen=True)
class SpawnSchedule:
    """Per-slot spawn data; ``step == -1`` means the slot is never used.
    An ensemble's schedules carry a leading batch axis on every plane
    (``(B, N)``, routes ``(B, N, W)``)."""

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
        return self.step.shape[-1]


def realized_spawn_steps(spawn_time: float, spawn_interval: float,
                         quantity: int, dt: float, num_steps: int) -> list[int]:
    """Steps at which a spawner spawns: the reference's greedy
    one-spawn-per-tick readiness loop (a copy of the JAX package's)."""
    steps = []
    next_time = spawn_time
    remaining = quantity
    for step in range(num_steps):
        if remaining <= 0:
            break
        if next_time <= step * dt:
            steps.append(step)
            next_time += spawn_interval
            remaining -= 1
    return steps


def build_spawn_schedule(
    spawners: Sequence[SpawnerSpec],
    dt: float,
    num_steps: int,
    pedestrian_seed: int = 2000,
    variate_speed: float = 0.0,
    blueprint_count: int = WALKER_BLUEPRINT_COUNT,
    initial_velocity: str = "forward",
    dtype=np.float32,
    device: torch.device | str = DEFAULT_DEVICE,
) -> SpawnSchedule:
    """Expand spawner specs into a flat per-slot schedule.

    Slot order is the reference's spawn order: ticks ascending, spawners in
    config order within a tick (matching the ``ped_<index>`` naming,
    pedestrian_spawner.py:176-183).

    ``blueprint_count``: size of the walker blueprint library to emulate for
    seeded-randomness parity; 0 skips the blueprint draw (the value is only
    observable headless through the entropy it consumes before the speed
    jitter draw).  Defaults to CARLA 0.9.13's library size so headless
    ``variate_speed`` jitter matches what the reference would produce for
    the same seed out of the box.

    ``initial_velocity``: ``"forward"`` gives new pedestrians their declared
    initial velocity toward the first waypoint (the reference's initial SFM
    state, pedestrian_spawner.py:215-216); ``"zero"`` reproduces what the
    reference actually simulates with CARLA attached, where the first
    readback overwrites that velocity with the fresh walker's ~zero velocity
    (run_simulation.py:78-87) -- use it to match bridge runs exactly.

    The schedule is built with numpy (equal to the JAX package's array for
    array) and moved to ``device`` once.
    """
    device = resolve_device(device)
    # per-spawner realized steps
    per_spawner = [
        realized_spawn_steps(s.spawn_time, s.spawn_interval, s.quantity, dt, num_steps)
        for s in spawners
    ]
    # (step, spawner_idx, occurrence) in reference spawn order
    events: list[tuple[int, int]] = []
    cursor = [0] * len(spawners)
    for step in range(num_steps):
        for si, steps in enumerate(per_spawner):
            if cursor[si] < len(steps) and steps[cursor[si]] == step:
                events.append((step, si))
                cursor[si] += 1

    n = max(1, len(events))
    step_arr = np.full((n,), -1, np.int32)
    pos = np.zeros((n, 2), dtype)
    vel = np.zeros((n, 2), dtype)
    speed = np.zeros((n,), dtype)
    crossing_speed = np.zeros((n,), dtype)
    margin = np.zeros((n,), dtype)
    radius = np.zeros((n,), dtype)
    initial_mode = np.full((n,), modes.WALKING_SIDEWALK, np.int32)
    first_wp = np.zeros((n, 2), dtype)
    routes: list[np.ndarray] = []
    crossings: list[list[bool]] = []

    ped_seed = pedestrian_seed
    spawner_speed = [float(s.speed) for s in spawners]  # mutated cumulatively

    # social-group assignment (models/groups.py): a spawner with
    # group_size > 1 chunks ITS walkers, in spawn order, into consecutive
    # groups; ids are globally unique across spawners.  A trailing
    # partial chunk (including a singleton) keeps its id -- the group
    # force masks <2-member groups to zero.
    group_arr = np.full((n,), -1, np.int32)
    # per-agent interaction sensitivity: jitter draws come from a DEDICATED
    # stream (np Generator, not the reference-parity random.Random chain)
    # so enabling heterogeneity never shifts the seeded blueprint/speed
    # draw order the parity tests pin
    scale_arr = np.ones((n,), dtype)
    scale_rng = np.random.default_rng(pedestrian_seed)
    law_arr = np.full((n,), -1, np.int32)
    for s in spawners:
        if s.pair_force is not None and s.pair_force not in LAW_IDS:
            raise ValueError(
                f"pair_force must be one of {sorted(LAW_IDS)}, "
                f"got {s.pair_force!r}")
    spawn_counter = [0] * len(spawners)
    group_base = [0] * len(spawners)
    next_base = 0
    for si, s in enumerate(spawners):
        group_base[si] = next_base
        if s.group_size > 1:
            next_base += -(-len(per_spawner[si]) // s.group_size)

    for slot, (step, si) in enumerate(events):
        s = spawners[si]
        rng = random.Random()
        rng.seed(ped_seed)
        if not s.blueprint and blueprint_count > 0:
            rng.choice(range(blueprint_count))  # consume the blueprint draw
        if variate_speed != 0.0:
            spawner_speed[si] += rng.uniform(-variate_speed, variate_speed)
        ped_seed += 1

        wps = np.asarray(s.waypoints, dtype)[:, :2].reshape(-1, 2)
        flags = list(s.crossing_road)
        loc = np.asarray(s.spawn_location, dtype)[:2]
        direction = wps[0] - loc
        nrm = np.linalg.norm(direction)
        direction = direction / nrm if nrm > 0 else np.zeros(2)

        step_arr[slot] = step
        pos[slot] = loc
        if initial_velocity == "forward":
            vel[slot] = direction * spawner_speed[si]
        speed[slot] = spawner_speed[si]
        crossing_speed[slot] = s.crossing_speed_factor * spawner_speed[si]
        margin[slot] = s.crossing_safety_margin
        radius[slot] = s.radius
        initial_mode[slot] = (
            modes.CROSSING_ROAD if (flags and flags[0]) else modes.WALKING_SIDEWALK
        )
        first_wp[slot] = wps[0]
        routes.append(wps)
        crossings.append(flags if flags else [False] * len(wps))
        if s.group_size > 1:
            group_arr[slot] = (group_base[si]
                               + spawn_counter[si] // s.group_size)
        scale_arr[slot] = s.interaction_scale
        if s.variate_interaction != 0.0:
            scale_arr[slot] += scale_rng.uniform(-s.variate_interaction,
                                                 s.variate_interaction)
        if s.pair_force is not None:
            law_arr[slot] = LAW_IDS[s.pair_force]
        spawn_counter[si] += 1

    route_buffer = build_route_buffer(routes, crossings, capacity=n,
                                      device=device)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SpawnSchedule(
        step=dev(step_arr),
        pos_x=dev(pos[:, 0]), pos_y=dev(pos[:, 1]),
        vel_x=dev(vel[:, 0]), vel_y=dev(vel[:, 1]),
        speed=dev(speed), crossing_speed=dev(crossing_speed),
        margin=dev(margin), radius=dev(radius),
        initial_mode=dev(initial_mode),
        fwp_x=dev(first_wp[:, 0]), fwp_y=dev(first_wp[:, 1]),
        routes=route_buffer,
        group_id=dev(group_arr) if (group_arr >= 0).any() else None,
        pair_scale=dev(scale_arr) if (scale_arr != 1.0).any() else None,
        law_id=dev(law_arr) if (law_arr >= 0).any() else None,
    )


def apply_spawn(state: PedState, schedule: SpawnSchedule, t_idx: int) -> PedState:
    """Activate slots whose spawn step is ``t_idx`` (masked write-at-slot).
    Broadcasts: a ``(B, N)`` state takes a ``(N,)`` schedule (a sweep) or
    a ``(B, N)`` one (an ensemble).

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
