"""Headless reactive vehicle autopilot, a kinematic waypoint follower (port
of models/autopilot.py).

The reference's autopilot vehicles are driven by CARLA's TrafficManager
with per-vehicle knobs: percentage speed difference below the limit,
ignore-walkers and ignore-lights percentages (vehicle_spawner.py:125-138).
Headless, the fleet is a vectorized controller stepped inside the rollout,
its state carried beside the pedestrians':

* it follows a waypoint polyline at a per-vehicle target speed
  (``speed_limit * (1 - speed_reduction_factor/100)``);
* it brakes for alive pedestrians inside its braking corridor, now or at
  its predicted arrival, unless its seeded ignore-walkers draw says not to;
* it brakes for red scenario-declared traffic lights ahead on its lane
  unless its seeded ignore-lights draw says not to;
* it brakes for fleet vehicles ahead in its lane (car following);
* with ``overtake``, it passes a slower leader through the left lane when
  that lane is clear, and merges back once its own lane is clear;
* it may loop its route.

Every decision is a threshold on plain tensor math over (V,), (V, N) and
(V, V) planes, with the JAX package's formulas kept literally (norms as the
square root of a sum of squares, the same ``max(.., 1e-6)`` guards): an ulp
there can flip a brake.  The JAX version is plain jnp and reaches no TPU
kernel, so plain PyTorch is its port.

Under a batch of crowds (an ensemble or a sweep, ``parallel/sweeps.py``)
every crowd steps its own fleet from its own walkers, as the JAX package's
vmap carries one ``AutopilotState`` per row: the state's planes are ``(B,
V)``, the hazard and passing-lane masks ``(B, V, N)``, car following ``(B,
V, V)`` and the lights ``(B, V, L)``, while the fleet (routes, spawn
steps, seeded draws, lights) is shared.  Row b equals the step of row b
alone bitwise.

Spawn-time seeding replicates the reference's vehicle spawner call order
(vehicle_spawner.py:100-118): ``random.seed(vehicle_seed)``; blueprint
``random.choice`` (entropy only); cumulative ``speed_reduction_factor``
jitter; ``vehicle_seed += 1``.  The ignore-walkers and ignore-lights draws
come from independent derived streams, as in the JAX package.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..env.pointsets import PAD_COORD
from ..ops.vecmath import atan2_rows, split_xy
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .spawn import realized_spawn_steps
from .vehicles import VehicleSnapshot, VehicleStates, ellipse_template

#: CARLA 0.9.13's vehicle blueprint library: 38 blueprints, 31 without the
#: two-wheelers (the reference's ``no_bikes`` filter).  The seeded
#: blueprint draw consumes entropy that depends only on the library size.
VEHICLE_BLUEPRINT_COUNT = 38
VEHICLE_BLUEPRINT_COUNT_NO_BIKES = 31

#: seconds of travel an oncoming vehicle is projected forward when judging
#: whether the passing lane is clear
_PASS_HORIZON = 5.0


@dataclass
class AutopilotSpec:
    """Host-side description of one reactive ``[[vehicle.vehicle_spawner]]``
    (``auto_pilot = true`` + a headless ``waypoints`` route)."""

    waypoints: np.ndarray               # (W, 2) route polyline
    speed_limit: float = 8.33           # m/s (30 km/h urban default)
    speed_reduction_factor: float = 30.0  # TM percentage below the limit
    ignore_walkers_percentage: float = 0.0
    ignore_lights_percentage: float = 0.0
    extent: tuple[float, float] = (2.4, 1.1)
    spawn_time: float = 0.0
    spawn_interval: float = 5.0
    quantity: int = 1
    loop: bool = False                  # wrap the route (TM-style endless)
    blueprint: str | None = None
    acceleration: float = 2.0           # m/s^2 throttle
    deceleration: float = 4.5           # m/s^2 braking
    brake_margin: float = 4.0           # m kept clear ahead of the bumper
    lateral_margin: float = 1.0         # m beyond the half-width
    overtake: bool = False              # may pass through the left lane
    lane_width: float = 3.5             # lateral offset of the passing lane
    #: (W,) bool aligned with ``waypoints``: where a pass may START (None =
    #: the whole route, when ``overtake``)
    overtake_ok: np.ndarray | None = None
    overtake_speed_gain: float = 0.5    # m/s the leader must be slower by
    overtake_clear_ahead: float = 40.0  # m of clear passing lane required
    overtake_clear_behind: float = 8.0  # m of clear lane behind required
    lane_change_rate: float = 1.75      # m/s lateral side-step speed


@dataclass
class TrafficLightSpec:
    """A headless traffic light: a timed red/green stop-point on the road
    (``[[vehicle.traffic_lights]]``)."""

    position: np.ndarray        # (2,) stop-point on the lane
    red: float = 5.0            # seconds of red per cycle
    green: float = 5.0          # seconds of green per cycle
    offset: float = 0.0         # phase offset [s]; t=offset starts a red


@dataclass(frozen=True)
class AutopilotState:
    """Per-vehicle dynamic state, carried through the rollout; a batch of
    fleets' planes lead with B."""

    pos: torch.Tensor         # (V, 2), a batch's (B, V, 2)
    heading: torch.Tensor     # (V,) radians, a batch's (B, V)
    speed: torch.Tensor       # (V,)
    wp_idx: torch.Tensor      # (V,) int32 current route target
    active: torch.Tensor      # (V,) bool
    lane_off: torch.Tensor    # (V,) lateral offset off the route [m]
    overtaking: torch.Tensor  # (V,) bool: committed to the passing lane

    @property
    def batch(self) -> int | None:
        """B of a batch of fleets, None for one."""
        return self.heading.shape[0] if self.heading.dim() == 2 else None


@dataclass(frozen=True)
class AutopilotFleet:
    """Static fleet description on one device."""

    route: torch.Tensor           # (V, W, 2) padded polylines
    route_count: torch.Tensor     # (V,) int32 valid waypoints per vehicle
    spawn_step: torch.Tensor      # (V,) int32
    target_speed: torch.Tensor    # (V,)
    ignore_walkers: torch.Tensor  # (V,) bool
    loop: torch.Tensor            # (V,) bool
    accel: torch.Tensor           # (V,)
    decel: torch.Tensor           # (V,)
    brake_margin: torch.Tensor    # (V,)
    lateral_margin: torch.Tensor  # (V,)
    overtake: torch.Tensor        # (V,) bool
    overtake_ok: torch.Tensor     # (V, W) bool
    lane_width: torch.Tensor      # (V,)
    ot_speed_gain: torch.Tensor   # (V,)
    ot_clear_ahead: torch.Tensor  # (V,)
    ot_clear_behind: torch.Tensor  # (V,)
    lane_rate: torch.Tensor       # (V,) lateral m/s
    extent: torch.Tensor          # (V, 2)
    template: torch.Tensor        # (V, P, 2) local ellipse outline
    template_valid: torch.Tensor  # (V, P)
    #: scenario-declared traffic lights (None = none): stop points, red
    #: duration, full cycle, phase offset, and the per-vehicle seeded
    #: ignore-lights draw
    light_x: torch.Tensor | None = None        # (L,)
    light_y: torch.Tensor | None = None        # (L,)
    light_red: torch.Tensor | None = None      # (L,)
    light_cycle: torch.Tensor | None = None    # (L,)
    light_offset: torch.Tensor | None = None   # (L,)
    ignore_lights: torch.Tensor | None = None  # (V,) bool
    points_per_chunk: int = 64

    @property
    def num_vehicles(self) -> int:
        return self.extent.shape[0]

    @property
    def device(self) -> torch.device:
        return self.route.device

    def initial_state(self, batch: int | None = None) -> AutopilotState:
        """The state before the first tick; ``batch``: B copies of it, one
        fleet for each crowd of a batch."""
        v, dev, dt = self.num_vehicles, self.device, self.route.dtype
        lead = () if batch is None else (batch,)

        def plane(dtype, fill=0):
            return torch.full((*lead, v), fill, dtype=dtype, device=dev)

        return AutopilotState(
            pos=self.route[:, 0, :].expand(*lead, v, 2).clone(),
            heading=plane(dt), speed=plane(dt),
            wp_idx=plane(torch.int32, 1), active=plane(torch.bool, False),
            lane_off=plane(dt), overtaking=plane(torch.bool, False))


class AutopilotRecord(NamedTuple):
    """Per-step fleet snapshot (the vehicle.csv source of reactive runs);
    a rollout's record stacks it ``(T, V, ...)``, a batch's ``(B, T, V,
    ...)`` (the JAX package's vmapped layout)."""

    pos: torch.Tensor      # (V, 2)
    heading: torch.Tensor  # (V,)
    speed: torch.Tensor    # (V,)
    active: torch.Tensor   # (V,)


def build_autopilot_fleet(
    specs: Sequence[AutopilotSpec],
    dt: float,
    num_steps: int,
    vehicle_seed: int = 2000,
    variate_speed_factor: float = 0.0,
    blueprint_count: int = 0,
    resolution: float = 0.1,
    points_per_chunk: int = 64,
    traffic_lights: Sequence[TrafficLightSpec] | None = None,
    dtype=np.float32,
    device: torch.device | str = DEFAULT_DEVICE,
) -> AutopilotFleet | None:
    """Expand specs into a fleet on ``device``, drawn on the host in the
    JAX package's order (the reference's seeded per-vehicle draws,
    vehicle_spawner.py:100-118).  Spawn order is ticks ascending, spec order
    within a tick.  None when no vehicle spawns within ``num_steps``."""
    device = resolve_device(device)
    per_spec = [realized_spawn_steps(s.spawn_time, s.spawn_interval,
                                     s.quantity, dt, num_steps)
                for s in specs]
    events: list[tuple[int, int]] = []
    cursor = [0] * len(specs)
    for step in range(num_steps):
        for si, steps in enumerate(per_spec):
            if cursor[si] < len(steps) and steps[cursor[si]] == step:
                events.append((step, si))
                cursor[si] += 1
    if not events:
        return None

    v = len(events)
    w_max = max(len(np.atleast_2d(s.waypoints)) for s in specs)
    route = np.zeros((v, w_max, 2), dtype)
    ints = {k: np.zeros((v,), np.int32) for k in ("route_count",
                                                  "spawn_step")}
    flags = {k: np.zeros((v,), bool) for k in (
        "ignore_walkers", "ignore_lights", "loop", "overtake")}
    reals = {k: np.zeros((v,), dtype) for k in (
        "target_speed", "accel", "decel", "brake_margin", "lateral_margin",
        "lane_width", "ot_speed_gain", "ot_clear_ahead", "ot_clear_behind",
        "lane_rate")}
    overtake_ok = np.zeros((v, w_max), bool)
    extent = np.zeros((v, 2), dtype)
    templates = []

    seed = vehicle_seed
    reduction = [float(s.speed_reduction_factor) for s in specs]  # cumulative
    for vi, (step, si) in enumerate(events):
        s = specs[si]
        rng = random.Random()
        rng.seed(seed)
        if not s.blueprint and blueprint_count > 0:
            rng.choice(range(blueprint_count))   # entropy-only blueprint draw
        if variate_speed_factor != 0.0:
            reduction[si] += rng.uniform(-variate_speed_factor,
                                         variate_speed_factor)
        ign = random.Random(seed * 7919 + 13).uniform(0.0, 100.0)
        ign_l = random.Random(seed * 6047 + 29).uniform(0.0, 100.0)
        seed += 1

        wps = np.atleast_2d(np.asarray(s.waypoints, dtype))[:, :2]
        route[vi, : len(wps)] = wps
        # padding repeats the last waypoint so a clamped gather is harmless
        route[vi, len(wps):] = wps[-1]
        ints["route_count"][vi] = len(wps)
        ints["spawn_step"][vi] = step
        reals["target_speed"][vi] = s.speed_limit * (1.0 - reduction[si]
                                                     / 100.0)
        flags["ignore_walkers"][vi] = ign < s.ignore_walkers_percentage
        flags["ignore_lights"][vi] = ign_l < s.ignore_lights_percentage
        flags["loop"][vi] = s.loop
        flags["overtake"][vi] = s.overtake
        for key, val in (("accel", s.acceleration),
                         ("decel", s.deceleration),
                         ("brake_margin", s.brake_margin),
                         ("lateral_margin", s.lateral_margin),
                         ("lane_width", s.lane_width),
                         ("ot_speed_gain", s.overtake_speed_gain),
                         ("ot_clear_ahead", s.overtake_clear_ahead),
                         ("ot_clear_behind", s.overtake_clear_behind),
                         ("lane_rate", s.lane_change_rate)):
            reals[key][vi] = val
        if s.overtake_ok is not None:
            ok = np.asarray(s.overtake_ok, bool).reshape(-1)
            if len(ok) != len(wps):
                raise ValueError(
                    f"overtake_ok length {len(ok)} != route length "
                    f"{len(wps)} for spawner {si}")
            overtake_ok[vi, : len(wps)] = ok
            # padding repeats the last value (clamped wp gather, like route)
            overtake_ok[vi, len(wps):] = bool(ok[-1]) if len(ok) else False
        else:
            overtake_ok[vi, :] = True    # whole-route; gated by `overtake`
        extent[vi] = s.extent
        templates.append(ellipse_template(s.extent[0], s.extent[1],
                                          resolution))

    p_raw = max(len(t) for t in templates)
    p = -(-p_raw // points_per_chunk) * points_per_chunk
    template = np.full((v, p, 2), PAD_COORD, dtype)
    template_valid = np.zeros((v, p), bool)
    for vi, t in enumerate(templates):
        template[vi, : len(t)] = t
        template_valid[vi, : len(t)] = True

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lights = {}
    if traffic_lights:
        def plane(vals):
            return dev(np.asarray(vals, dtype))
        lights = dict(
            light_x=plane([float(np.asarray(tl.position)[0])
                           for tl in traffic_lights]),
            light_y=plane([float(np.asarray(tl.position)[1])
                           for tl in traffic_lights]),
            light_red=plane([tl.red for tl in traffic_lights]),
            light_cycle=plane([tl.red + tl.green for tl in traffic_lights]),
            light_offset=plane([tl.offset for tl in traffic_lights]),
            ignore_lights=dev(flags["ignore_lights"]))

    return AutopilotFleet(
        route=dev(route), overtake_ok=dev(overtake_ok), extent=dev(extent),
        template=dev(template), template_valid=dev(template_valid),
        points_per_chunk=points_per_chunk,
        **{k: dev(a) for k, a in ints.items()},
        **{k: dev(a) for k, a in flags.items() if k != "ignore_lights"},
        **{k: dev(a) for k, a in reals.items()},
        **lights)


def _norm(x, y):
    """``jnp.linalg.norm`` of 2-vectors: the root of a sum of squares."""
    return torch.sqrt(x * x + y * y)


def autopilot_step(fleet: AutopilotFleet, st: AutopilotState, ped_pos,
                   ped_vel, ped_alive: torch.Tensor, t_idx: int,
                   dt: float) -> AutopilotState:
    """Advance the fleet one tick.

    ``ped_pos``/``ped_vel``: the walkers as (x, y) plane tuples or (N, 2)
    tensors (all slots; ``ped_alive`` masks them).  Runs before the pedestrian core each tick,
    as in the reference (vehicles move inside ``world.tick()`` and are then
    read back as dynamic obstacles, run_simulation.py:70-95).  ``t_idx`` is
    the step; the lights' clock is ``float32(t_idx) * float32(dt)``.

    A batch of fleets (``st`` with ``(B, V)`` planes) steps each crowd's
    fleet from that crowd's walkers, ``(B, N)`` planes."""
    from .stepper import sim_time_of
    ppx, ppy = split_xy(ped_pos)
    pvx, pvy = split_xy(ped_vel)
    dt32 = float(np.float32(dt))
    batched = st.batch is not None
    active = st.active | (fleet.spawn_step == int(t_idx))
    px, py = st.pos[..., 0], st.pos[..., 1]
    cos_h, sin_h = torch.cos(st.heading), torch.sin(st.heading)

    # current target waypoint (clamped gather), side-stepped by the lane
    # offset along the route segment's left normal
    v_idx = torch.arange(fleet.num_vehicles, device=st.pos.device)
    wp_i = torch.minimum(st.wp_idx, fleet.route_count - 1).long()
    wp = fleet.route[v_idx, wp_i]
    prev = fleet.route[v_idx, torch.clamp(wp_i - 1, min=0)]
    sx, sy = wp[..., 0] - prev[..., 0], wp[..., 1] - prev[..., 1]
    seg_n = _norm(sx, sy)
    has_seg = seg_n > 1e-6
    seg_d = torch.clamp(seg_n, min=1e-6)
    segx = torch.where(has_seg, sx / seg_d, cos_h)
    segy = torch.where(has_seg, sy / seg_d, sin_h)
    tx = wp[..., 0] + st.lane_off * -segy
    ty = wp[..., 1] + st.lane_off * segx
    to_x, to_y = tx - px, ty - py
    dist = _norm(to_x, to_y)
    has_dir = dist > 1e-6
    dist_d = torch.clamp(dist, min=1e-6)
    dirx = torch.where(has_dir, to_x / dist_d, cos_h)
    diry = torch.where(has_dir, to_y / dist_d, sin_h)
    heading = torch.where(has_dir, atan2_rows(diry, dirx, batched),
                          st.heading)

    # walker hazard: an alive walker inside (or predicted to enter) the
    # braking corridor; (V, N) planes, a batch's (B, V, N)
    def col(a):
        return a[..., :, None]

    def row(a):
        return a[..., None, :]

    rel_x = row(ppx) - col(px)
    rel_y = row(ppy) - col(py)
    fwd = rel_x * col(dirx) + rel_y * col(diry)
    lat = -rel_x * col(diry) + rel_y * col(dirx)
    lat_vel = -row(pvx) * col(diry) + row(pvy) * col(dirx)
    t_arrive = torch.clamp(
        fwd / col(torch.clamp(st.speed, min=0.5)), 0.0, 3.0)
    lat_pred = lat + lat_vel * t_arrive
    stop_dist = (st.speed * st.speed) / (2.0 * fleet.decel) + fleet.brake_margin
    half_len = fleet.extent[:, 0]
    band = (fleet.extent[:, 1] + fleet.lateral_margin)[:, None]
    near = ((fwd > -half_len[:, None])
            & (fwd < col(stop_dist + half_len))
            & ((lat.abs() < band) | (lat_pred.abs() < band)))
    hazard = (near & row(ped_alive)).any(dim=-1) & ~fleet.ignore_walkers

    if fleet.light_x is not None and fleet.light_x.shape[0] > 0:
        # a red stop point ahead in the lane within braking range; the
        # phase t in [offset, offset + red) mod cycle is red
        sim_t = torch.tensor(sim_time_of(t_idx, dt), dtype=torch.float32,
                             device=st.pos.device)
        phase = torch.remainder(sim_t - fleet.light_offset[None, :],
                                fleet.light_cycle[None, :])
        is_red = phase < fleet.light_red[None, :]              # (1, L)
        lrel_x = fleet.light_x[None, :] - col(px)              # (V, L)
        lrel_y = fleet.light_y[None, :] - col(py)
        lfwd = lrel_x * col(dirx) + lrel_y * col(diry)
        llat = -lrel_x * col(diry) + lrel_y * col(dirx)
        at_light = ((lfwd > 0.0) & (lfwd < col(stop_dist + half_len))
                    & (llat.abs() < band))
        hazard = hazard | ((at_light & is_red).any(dim=-1)
                           & ~fleet.ignore_lights)

    # vehicle-vehicle car following and overtaking, (V, V) in each
    # vehicle's frame
    vrel_x = row(px) - col(px)
    vrel_y = row(py) - col(py)
    vfwd = vrel_x * col(dirx) + vrel_y * col(diry)
    vlat = -vrel_x * col(diry) + vrel_y * col(dirx)
    other = (row(active) & col(active)
             & ~torch.eye(fleet.num_vehicles, dtype=torch.bool,
                          device=st.pos.device))
    gap_len = half_len[:, None] + half_len[None, :]
    veh_band = fleet.extent[:, 1][:, None] + fleet.extent[None, :, 1] + 0.3
    follow_window = col(stop_dist) + gap_len
    leader = (other & (vfwd > 0.0) & (vfwd < follow_window)
              & (vlat.abs() < veh_band))
    hazard = hazard | leader.any(dim=-1)

    blocked = (leader & (row(st.speed) < (
        fleet.target_speed - fleet.ot_speed_gain)[:, None])).any(dim=-1)
    j_fwd_speed = row(st.speed) * (row(cos_h) * col(dirx)
                                   + row(sin_h) * col(diry))
    fore_window = (fleet.ot_clear_ahead[:, None]
                   + torch.clamp(-j_fwd_speed, min=0.0) * _PASS_HORIZON)
    pass_busy = (other & (vfwd > -fleet.ot_clear_behind[:, None])
                 & (vfwd < fore_window)
                 & ((vlat - fleet.lane_width[:, None]).abs() < veh_band)
                 ).any(dim=-1)
    ped_pass = (row(ped_alive) & (fwd > -fleet.ot_clear_behind[:, None])
                & (fwd < fleet.ot_clear_ahead[:, None])
                & ((lat - fleet.lane_width[:, None]).abs() < band)
                ).any(dim=-1)
    pass_busy = pass_busy | (ped_pass & ~fleet.ignore_walkers)
    merge_ahead = follow_window + fleet.brake_margin[:, None]
    orig_busy = (other & (vfwd > -fleet.ot_clear_behind[:, None])
                 & (vfwd < merge_ahead)
                 & ((vlat + col(st.lane_off)).abs() < veh_band)
                 ).any(dim=-1)
    ok_here = fleet.overtake_ok[v_idx, wp_i]
    start = (blocked & ~pass_busy & fleet.overtake & ok_here & active
             & ~st.overtaking)
    overtaking = (st.overtaking | start) & ~(st.overtaking & ~orig_busy)
    target_off = torch.where(overtaking, fleet.lane_width, 0.0)
    lane_step = fleet.lane_rate * dt32
    lane_off = st.lane_off + torch.clamp(target_off - st.lane_off,
                                         -lane_step, lane_step)
    lane_off = torch.where(active, lane_off, 0.0)

    speed = torch.where(
        hazard, torch.clamp(st.speed - fleet.decel * dt32, min=0.0),
        torch.minimum(fleet.target_speed, st.speed + fleet.accel * dt32))
    speed = torch.where(active, speed, 0.0)

    # the lane change is an explicit lateral translation along the route
    # normal; with lane_off pinned at 0 the delta is exactly 0
    step_len = speed * dt32
    d_off = lane_off - st.lane_off
    pos_x = px + torch.where(active, step_len * dirx + d_off * -segy, 0.0)
    pos_y = py + torch.where(active, step_len * diry + d_off * segx, 0.0)

    # waypoint advance (within one step + 0.5 m)
    arrived = active & (dist <= step_len + 0.5)
    nxt = st.wp_idx + 1
    exhausted = nxt >= fleet.route_count
    wp_idx = torch.where(arrived,
                         torch.where(exhausted & fleet.loop,
                                     torch.zeros_like(nxt), nxt),
                         st.wp_idx)
    # route done and not looping: the vehicle parks (inactive)
    active = active & ~(arrived & exhausted & ~fleet.loop)

    return AutopilotState(pos=torch.stack([pos_x, pos_y], dim=-1),
                          heading=heading, speed=speed, wp_idx=wp_idx,
                          active=active, lane_off=lane_off,
                          overtaking=overtaking)


def autopilot_snapshot(fleet: AutopilotFleet,
                       st: AutopilotState) -> VehicleSnapshot:
    """The fleet state as the VehicleSnapshot that gap acceptance and the
    dynamic-obstacle force read (a batch of fleets': ``(B, V)`` planes)."""
    vel = st.speed[..., None] * torch.stack(
        [torch.cos(st.heading), torch.sin(st.heading)], dim=-1)
    return VehicleSnapshot(
        center=st.pos, vel=vel, heading=st.heading, extent=fleet.extent,
        active=st.active, template=fleet.template,
        template_valid=fleet.template_valid,
        points_per_chunk=fleet.points_per_chunk)


def records_to_vehicle_states(fleet: AutopilotFleet,
                              rec: AutopilotRecord) -> VehicleStates:
    """Stacked per-step AutopilotRecords as a VehicleStates timeline (so
    reactive runs read back like scripted ones)."""
    vel = rec.speed[..., None] * torch.stack(
        [torch.cos(rec.heading), torch.sin(rec.heading)], dim=-1)
    return VehicleStates(
        pos=rec.pos, heading=rec.heading, vel=vel, active=rec.active,
        extent=fleet.extent, template=fleet.template,
        template_valid=fleet.template_valid,
        points_per_chunk=fleet.points_per_chunk)
