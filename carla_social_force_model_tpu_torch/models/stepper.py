"""The headless simulation tick and rollouts (port of models/stepper.py).

One step keeps the reference's per-tick order (see the JAX package):

1. spawn due pedestrians;
2. capture the applied target speeds, before any transition this tick;
3. IDLE promotion;
4. gap acceptance for CHECKING_TRAFFIC pedestrians against this step's
   scripted vehicles (with no vehicles every gap is accepted);
5. the recorded snapshot;
6. the force sum: acceleration, the pair forces (the Moussaid force, the
   Karamouzas power law, the Helbing ellipse), the social-group force and
   the environment forces (borders, space repulsion, static and dynamic
   obstacles), with the per-agent ``law_id``/``pair_scale`` row masks on
   the pair families;
7. v' = cap(v + dt*F, applied_target * factor);
8. waypoint arrival: advance and mode change, or despawn;
9. x' = x + dt*v'.

This covers the headless crowd (BASELINE config #1), its environment
(configs #2 and #3) with the sampled or the analytic border geometry
(``StepConfig.env_analytic``), the interaction cutoff of large crowds, the
urban slice (config #4): a reactive autopilot fleet stepped before the
pedestrians each tick (``models/autopilot.py``) and the compacted
environment kernels, the model families: the power-law and Helbing pair
laws, mixed-law crowds and social groups (``models/groups.py``), and the
ORCA velocity law: after step 7 the capped velocity is the preferred
velocity of a projection onto the half-planes of the neighbours, the
vehicles and the nearest wall features (``ops/orca.py``), for the agents
whose ``law_id`` is ORCA's (every agent without a ``law_id`` column).

The scenarios (``api/scenario.build_scenario``, ``api/simulation.Simulation``
and the CLI) take the JAX package's default engine: with
``StepConfig.env_chunked`` the environment forces read each segment's
closest point from the chunked point sets (``ops/forces.
chunked_environment_terms``; on a card the ``chunk_argmin`` kernel), as the
JAX package's jnp environment path does, in place of the fused environment
kernels.

Agent sharding (``parallel/``): with ``axis``, every function from
``force_terms`` to ``rollout`` runs one shard's slots of an agent axis;
the pair forces bring in their columns by ``StepConfig.axis_comm``, the
group force, ORCA and the fleet's hazard check all-gather what they read,
and the rest is slot-local (``parallel/sharding.make_sharded_rollout``).

Batches of crowds (``parallel/sweeps.py``): every function from
``force_terms`` to ``rollout`` also steps B independent crowds at once,
the layout of the JAX package's vmap: ``(B, N)`` state planes, a spawn
schedule that is ``(B, N)`` (an ensemble) or shared ``(N,)`` (a sweep),
parameters whose leaves are ``(B,)`` tensors (a sweep, viewed as ``(B,
1)`` against the planes) or numbers shared by every row, and one scene
geometry for all rows; ``sim_time`` stays one scalar.  The pair and
environment forces launch the batched kernels once per step for every
row (``cuda_forces.pedestrian_force_batched``, ``cuda_env.
fused_environment_terms``); the records are ``(B, T, N)``.
:func:`check_supported` refuses what is not batched yet (ROADMAP item
19b) with ``NotImplementedError``.

The device chooses the kernel path: the CUDA kernels on a card, the plain
PyTorch versions on the CPU (ops/cuda_forces.py, ops/cuda_env.py,
ops/statics.py).  A
rollout is an eager Python loop over steps; capturing it as a CUDA graph is
later work.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..env.pointsets import (ChunkedPointSet, SegmentGeomSet,
                             SegmentPointSet, StaticFeatures, analytic_split,
                             build_static_features, chunked_on, segment_major)
from ..ops import cuda_forces, forces, vecmath
from ..ops.cuda_env import fused_environment_terms, plain_environment_terms
from ..ops.cuda_forces import pedestrian_force_kernel, pedestrian_force_sorted
from ..ops.orca import orca_velocities
from ..ops.spatial import morton_order
from . import modes
from .autopilot import (AutopilotFleet, AutopilotRecord, AutopilotState,
                        autopilot_snapshot, autopilot_step)
from .gap import gap_ready
from .groups import GroupSet, group_force
from .params import SfmParams, as_column, param_batch
from .spawn import LAW_IDS, SpawnSchedule, apply_spawn
from .state import PedState
from .vehicles import VehicleSnapshot, VehicleStates, vehicle_snapshot_at


@dataclass(frozen=True)
class Scene:
    """Everything the stepper needs besides the pedestrian state.

    ``borders`` and ``static_obstacles`` are the host-side point sets;
    :func:`prepare_scene` adds their segment-major layouts on the spawn
    schedule's device (``borders_seg``, ``static_obstacles_seg``), which is
    what the forces read; with ``analytic`` the line-segment form of the
    borders (``borders_geom``, and ``borders_seg_rest`` for the sections
    that stay sampled); with ``orca`` the ORCA wall feeds of both
    (``borders_feat``, ``obstacles_feat``); with ``chunked`` the point sets
    themselves as tensors on the device (``borders_chunked``,
    ``static_obstacles_chunked``), which the chunked environment forces of
    ``StepConfig.env_chunked`` read.  ``autopilot`` is a reactive
    fleet, stepped before the pedestrians each tick (its snapshot replaces
    ``vehicles``).  ``groups`` is the social-group member table
    (:class:`.groups.GroupSet`, from :func:`.groups.build_groups`), read
    when the group force is enabled."""

    spawn: SpawnSchedule
    borders: ChunkedPointSet | None = None
    static_obstacles: ChunkedPointSet | None = None
    static_obstacle_vel: torch.Tensor | None = None  # (S, 2), zeros
    vehicles: VehicleStates | None = None
    autopilot: AutopilotFleet | None = None
    groups: GroupSet | None = None
    borders_seg: SegmentPointSet | None = None
    static_obstacles_seg: SegmentPointSet | None = None
    borders_geom: SegmentGeomSet | None = None
    borders_seg_rest: SegmentPointSet | None = None
    borders_feat: StaticFeatures | None = None
    obstacles_feat: StaticFeatures | None = None
    borders_chunked: ChunkedPointSet | None = None
    static_obstacles_chunked: ChunkedPointSet | None = None


def prepare_scene(scene: Scene, analytic: bool = False,
                  orca: bool = False, chunked: bool = False) -> Scene:
    """Add the segment-major layouts of the scene's borders and static
    obstacles on the spawn schedule's device, and zero obstacle velocities
    where none are given.  ``analytic``: also the Douglas-Peucker border
    geometry of ``StepConfig.env_analytic`` (``env/pointsets.
    analytic_split``); ``orca``: also the ORCA wall feeds of the borders
    and the static obstacles (``env/pointsets.build_static_features``);
    ``chunked``: the chunked point sets on the device
    (``env/pointsets.chunked_on``) in place of the segment-major layouts,
    for ``StepConfig.env_chunked``.  Host-side work, done once per
    scenario; idempotent.  ``make_rollout_fn`` and ``rollout`` pass
    ``cfg.env_analytic``, ``params.enable_orca`` and ``cfg.env_chunked``
    (the JAX package's stepper.py:83-119)."""
    device = scene.spawn.step.device
    upd = {}
    if chunked:
        if scene.borders is not None and scene.borders_chunked is None:
            upd["borders_chunked"] = chunked_on(scene.borders, device)
        if (scene.static_obstacles is not None
                and scene.static_obstacles_chunked is None):
            upd["static_obstacles_chunked"] = chunked_on(
                scene.static_obstacles, device)
    elif scene.borders is not None and scene.borders_seg is None:
        upd["borders_seg"] = segment_major(scene.borders, device)
    if (analytic and scene.borders is not None
            and scene.borders_geom is None):
        gset, rest = analytic_split(scene.borders, device=device)
        upd["borders_geom"] = gset
        upd["borders_seg_rest"] = segment_major(rest, device)
    if orca and scene.borders is not None and scene.borders_feat is None:
        upd["borders_feat"] = build_static_features(scene.borders, device)
    if (orca and scene.static_obstacles is not None
            and scene.obstacles_feat is None):
        upd["obstacles_feat"] = build_static_features(scene.static_obstacles,
                                                      device)
    if scene.static_obstacles is not None:
        if not chunked and scene.static_obstacles_seg is None:
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
    #: JAX package's ``pallas_symmetric``; the Helbing law, which is not
    #: antisymmetric, always runs the dense kernels
    symmetric_pairs: bool = True
    #: run the plain PyTorch pair forces (every family) even on a card: the
    #: reference the kernel path is compared with, never the default
    plain_pair_force: bool = False
    #: run the plain PyTorch environment forces and ORCA's wall feed even on
    #: a card (no sort, no kernel): the reference the kernel path is
    #: compared with, never the default
    plain_env_force: bool = False
    #: the compacted environment kernels: each term whose job passes the
    #: JAX package's static gate walks a per-step survivor table of its
    #: groups of sections (ops/env_grid.py); exact either way.  The urban
    #: bundle sets it
    env_compact: bool = False
    #: survivor-table width of the compacted environment kernels (0 = auto:
    #: a third of the groups, at least 8)
    env_max_surv: int = 0
    #: analytic border geometry: the border-family forces take each
    #: section's closest point ON its Douglas-Peucker line segments
    #: (``prepare_scene(analytic=True)``, the ``env_exp_analytic`` kernels);
    #: sections that do not simplify stay sampled and their term is added
    env_analytic: bool = False
    #: the JAX package's default (jnp) environment path, which its
    #: scenarios take: each term takes every segment's closest point from
    #: the chunked point sets (``prepare_scene(chunked=True)``) through
    #: ``ops/geometry.closest_point_per_segment`` -- on a card the
    #: ``chunk_argmin`` kernel, the JAX package's ``_cp_kernel`` -- in place
    #: of the fused environment kernels' segment-major scan.  The same
    #: forces; not combined with ``env_analytic`` or ``env_compact``, which
    #: belong to the fused path (the JAX package's stepper.py:273)
    env_chunked: bool = False
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
    #: column communication of the pair forces when the slots are sharded
    #: over an agent axis (``parallel/``): "gather" (all-gather the column
    #: planes), "ring" (rotate one shard's block per step; with
    #: ``symmetric_pairs`` the half-ring) or "ring_kernel" (the in-kernel
    #: ring).  The plain path runs the plain ring for both rings, as the JAX
    #: package's jnp path does; one device ignores it
    axis_comm: str = "gather"


class StepRecord(NamedTuple):
    """Per-step snapshot; ``pos``/``vel`` are (T, N, 2) (a batch's: (B, T,
    N, 2), the other planes (B, T, N))."""

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


#: what a refusal under a batch names: the slice that will port it
BATCH_ITEM = "ROADMAP item 19b"


def batch_of(state: PedState | None, scene: Scene,
             params: SfmParams) -> int | None:
    """B of a batched step (a ``(B, N)`` state, a ``(B, N)`` spawn schedule
    or ``(B,)`` parameter leaves), None for one crowd.  Raises
    ``ValueError`` when they disagree, or when a batched schedule or sweep
    meets a state of one crowd."""
    sizes = {}
    if state is not None and state.batch is not None:
        sizes["state"] = state.batch
    if scene.spawn.step.dim() == 2:
        sizes["spawn schedule"] = scene.spawn.step.shape[0]
    if param_batch(params) is not None:
        sizes["params"] = param_batch(params)
    if len(set(sizes.values())) > 1:
        raise ValueError(f"inconsistent batch sizes: {sizes}")
    if sizes and state is not None and state.batch is None:
        raise ValueError(f"a batched {' and '.join(sizes)} needs (B, N) "
                         f"state planes (PedState.empty(n, batch=B))")
    return next(iter(sizes.values()), None)


def _check_batched(scene: Scene, params: SfmParams, cfg: StepConfig,
                   axis) -> None:
    """Refuse, under a batch, every configuration the batched step does not
    run: ``NotImplementedError`` naming ROADMAP item 19b (nothing runs
    another path instead)."""
    refused = (
        (axis is not None, "an agent axis (sharding a batch of crowds)"),
        (cfg.interaction_cutoff is not None,
         "interaction_cutoff (the batched cutoff pair kernels)"),
        (cfg.env_compact, "env_compact (the batched compacted environment "
                          "kernels)"),
        (cfg.env_analytic, "env_analytic (the batched analytic border "
                           "kernels)"),
        (cfg.env_chunked, "env_chunked (the batched chunk scan)"),
        (params.enable_orca, "ORCA"),
        (params.enable_group and scene.groups is not None, "social groups"),
        (scene.autopilot is not None, "the reactive autopilot fleet"),
        (scene.spawn.pair_scale is not None or scene.spawn.law_id is not None,
         "per-agent pair_scale/law_id columns"),
    )
    for hit, what in refused:
        if hit:
            raise NotImplementedError(
                f"{what} under a batch of crowds is not ported yet "
                f"({BATCH_ITEM})")


def check_supported(scene: Scene, params: SfmParams, cfg: StepConfig,
                    state: PedState | None = None, axis=None) -> None:
    """Raise ``ValueError`` or ``TypeError`` for per-agent columns and
    groups of the wrong form, and for ``env_chunked`` together with a knob
    of the fused environment path; under a batch (:func:`batch_of` of
    ``state``, the schedule and the params), ``NotImplementedError`` for
    what the batched step does not run yet (ROADMAP item 19b)."""
    if batch_of(state, scene, params) is not None:
        _check_batched(scene, params, cfg, axis)
    if cfg.env_chunked and (cfg.env_analytic or cfg.env_compact):
        raise ValueError("env_chunked (the jnp environment path) does not "
                         "combine with env_analytic or env_compact, which "
                         "belong to the fused environment kernels")
    if (params.enable_group and scene.groups is not None
            and not isinstance(scene.groups, GroupSet)):
        raise TypeError(f"scene.groups must be a GroupSet (models/groups."
                        f"build_groups), got {type(scene.groups).__name__}")
    n = scene.spawn.capacity
    if scene.spawn.step.dim() == 2:
        return  # no per-agent column under a batch (refused above)
    for name, kinds in (("pair_scale", (torch.float32,)),
                        ("law_id", (torch.int32, torch.int64))):
        col = getattr(scene.spawn, name)
        if col is not None and (not isinstance(col, torch.Tensor)
                                or col.shape != (n,) or col.dtype not in kinds):
            raise ValueError(
                f"spawn.{name} (per-agent pair_scale/law_id) must be a ({n},) "
                f"tensor of {' or '.join(map(str, kinds))}")


#: the pair families by SpawnSchedule.law_id (models/spawn.LAW_IDS)
_FAMILY_ID = {"pedestrian_force": LAW_IDS["moussaid"],
              "powerlaw_force": LAW_IDS["powerlaw"],
              "ped_repulsive_force": LAW_IDS["helbing"]}


def _segments(pset, seg, name, layout="segment-major"):
    """The prepared layout of a scene's point set: raises when the scene
    was not prepared; None when the set holds no point (its force is
    zero)."""
    if seg is None and pset is not None and bool(np.asarray(pset.valid).any()):
        raise ValueError(f"scene.{name} has no {layout} layout: build the "
                         f"scene with prepare_scene (make_rollout_fn and "
                         f"rollout do, with cfg.env_analytic and "
                         f"cfg.env_chunked)")
    return seg


def force_terms(state: PedState, scene: Scene, params: SfmParams,
                cfg: StepConfig, veh_snap: VehicleSnapshot | None = None,
                order=None, axis=None) -> dict:
    """Enabled force terms by name, each an ``(fx, fy)`` plane pair, in the
    JAX package's order.  ``veh_snap``: this step's vehicles.  ``order``:
    an optional ``(perm, inv)`` Hilbert permutation of the state's
    positions and liveness (:func:`..ops.spatial.morton_order`), which the
    sorting kernels then share.  ``axis``: the state holds this shard's
    slots of an agent axis (:mod:`..parallel`); the pair forces bring in
    their columns by ``cfg.axis_comm`` and the group force all-gathers its
    members, every other term is slot-local (and ``order`` the shard's
    own).  A batch of crowds (``(B, N)`` planes) launches the batched
    kernels, one launch per term for every row."""
    check_supported(scene, params, cfg, state, axis)
    batch = state.batch
    if cfg.env_chunked:
        _segments(scene.borders, scene.borders_chunked, "borders", "chunked")
        _segments(scene.static_obstacles, scene.static_obstacles_chunked,
                  "static_obstacles", "chunked")
    else:
        _segments(scene.borders, scene.borders_seg, "borders")
        _segments(scene.static_obstacles, scene.static_obstacles_seg,
                  "static_obstacles")
    if (cfg.env_analytic and scene.borders_geom is None
            and scene.borders_seg_rest is None):
        # the split of a prepared scene always has a part
        _segments(scene.borders, None, "borders (analytic)")
    cutoff = cfg.interaction_cutoff
    families = (params.enable_pedestrian or params.enable_powerlaw
                or params.enable_ped_repulsive)
    if (order is None and cutoff is not None and families
            and not cfg.plain_pair_force and cfg.spatial_order == "hilbert"):
        # the pair kernels of every family and the environment kernels sort
        # by the same key with the same stable sort: one permutation serves
        # them all (it changes no result)
        order = morton_order(state.pos_x, state.pos_y, state.alive, "hilbert")
    if cfg.env_chunked:
        env = forces.chunked_environment_terms(state, scene, params, veh_snap,
                                               plain=cfg.plain_env_force)
    elif cfg.plain_env_force:
        env = plain_environment_terms(state, scene, params, veh_snap,
                                      analytic=cfg.env_analytic)
    else:
        env = fused_environment_terms(state, scene, params, veh_snap,
                                      compact=cfg.env_compact,
                                      max_surv=cfg.env_max_surv,
                                      analytic=cfg.env_analytic, order=order)
    zero = torch.zeros_like(state.pos_x)
    desired = None
    if params.enable_ped_repulsive or (params.enable_group
                                       and scene.groups is not None):
        ex, ey, _ = vecmath.normalize_xy(state.wp_x - state.pos_x,
                                         state.wp_y - state.pos_y)
        desired = (ex, ey)

    def pair_term(law, p, radius, use_radius=False, desired=None):
        args = (state.pos_x, state.pos_y, state.vel_x, state.vel_y, radius,
                state.alive, p)
        if batch is not None:
            return cuda_forces.pedestrian_force_batched(
                *args, use_ped_radius=use_radius,
                symmetric=cfg.symmetric_pairs, row_block=cfg.row_block,
                law=law, desired=desired, plain=cfg.plain_pair_force)
        if axis is not None and cfg.plain_pair_force:
            return cuda_forces.plain_sharded_force(
                law, *args, axis, cfg.axis_comm, use_radius, cfg.row_block,
                cutoff, desired)
        sharded = ({} if axis is None
                   else dict(axis=axis, comm=cfg.axis_comm))
        if cfg.plain_pair_force:
            return cuda_forces.plain_law_force(
                law, *args, use_radius, cfg.row_block, cutoff, desired)
        if cutoff is not None:
            return pedestrian_force_sorted(
                *args, cutoff, use_ped_radius=use_radius,
                symmetric=cfg.symmetric_pairs, compact=cfg.compact_pairs,
                max_surv=cfg.pair_max_surv, spatial_order=cfg.spatial_order,
                row_block=cfg.row_block, order=order, law=law,
                desired=desired, **sharded)
        return pedestrian_force_kernel(
            *args, use_ped_radius=use_radius, symmetric=cfg.symmetric_pairs,
            row_block=cfg.row_block, law=law, desired=desired, **sharded)

    terms: dict = {}
    if params.enable_acceleration:
        terms["acceleration_force"] = forces.acceleration_force_xy(
            state.pos_x, state.pos_y, state.vel_x, state.vel_y,
            state.wp_x, state.wp_y, state.applied_target,
            params.acceleration if batch is None
            else as_column(params.acceleration))
    if params.enable_pedestrian:
        terms["pedestrian_force"] = pair_term(
            "moussaid", params.pedestrian, state.radius,
            use_radius=params.use_ped_radius)
    # the environment terms: every job of an empty point set (no layout) is
    # absent, and its term is zero
    if params.enable_border and scene.borders is not None:
        terms["border_force"] = env.get("border_force", (zero, zero))
    if params.enable_static_obstacle and scene.static_obstacles is not None:
        terms["static_obstacle_force"] = env.get("static_obstacle_force",
                                                 (zero, zero))
    if params.enable_powerlaw:
        terms["powerlaw_force"] = pair_term("powerlaw", params.powerlaw,
                                            state.radius)
    if params.enable_ped_repulsive:
        terms["ped_repulsive_force"] = pair_term(
            "helbing", params.ped_repulsive, None, desired=desired)
    if params.enable_group and scene.groups is not None:
        terms["group_force"] = group_force(
            state.pos_x, state.pos_y, state.vel_x, state.vel_y, *desired,
            state.alive, scene.groups, params.group, axis=axis)
    if params.enable_space_repulsive and scene.borders is not None:
        terms["space_repulsive_force"] = env.get("space_repulsive_force",
                                                 (zero, zero))
    if params.enable_dynamic_obstacle and veh_snap is not None:
        terms["dynamic_obstacle_force"] = env["dynamic_obstacle_force"]
    # per-agent heterogeneity of the pair families (the JAX package's
    # stepper.py:452-477): F_i = s_i * sum_j g_ij is a row-wise post-scale
    # of the summed term, so it composes with every kernel (the symmetric
    # ones compute the unscaled antisymmetric g); law_id keeps each family
    # on the agents that perceive the crowd through it (-1 = every enabled
    # family).  Borders, obstacles and groups are not scaled.
    ps, law = scene.spawn.pair_scale, scene.spawn.law_id
    if ps is not None or law is not None:
        for name, fid in _FAMILY_ID.items():
            if name not in terms:
                continue
            fx, fy = terms[name]
            if law is not None:
                m = ((law < 0) | (law == fid)).to(fx.dtype)
                fx, fy = fx * m, fy * m
            if ps is not None:
                fx, fy = fx * ps, fy * ps
            terms[name] = (fx, fy)
    return terms


def compute_forces(state: PedState, scene: Scene, params: SfmParams,
                   cfg: StepConfig, veh_snap: VehicleSnapshot | None = None,
                   order=None, axis=None):
    """Sum of enabled forces, masked to alive pedestrians: ``(fx, fy)``
    (``order`` and ``axis`` as in :func:`force_terms`)."""
    terms = force_terms(state, scene, params, cfg, veh_snap, order, axis)
    fx = torch.zeros_like(state.pos_x)
    fy = torch.zeros_like(state.pos_y)
    for tx, ty in terms.values():
        fx = fx + tx
        fy = fy + ty
    return (torch.where(state.alive, fx, 0.0),
            torch.where(state.alive, fy, 0.0))


def tick_core(state: PedState, scene: Scene, params: SfmParams,
              cfg: StepConfig, sim_time: float,
              veh_snap: VehicleSnapshot | None = None, axis=None):
    """Steps 2-8 of the tick (everything except spawn and integration).

    ``sim_time`` is a Python float holding a float32 value; ``veh_snap``
    this step's vehicles; ``axis`` as in :func:`force_terms` (ORCA then
    sees the all-gathered crowd).  Returns ``(state', (vx, vy), finished,
    record)``: the commanded velocity and the pedestrians that arrived at
    their final waypoint this tick."""
    check_supported(scene, params, cfg, state, axis)
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
    n = state.capacity
    order = None
    if (axis is None and params.enable_orca
            and cfg.spatial_order == "hilbert"
            and 0 < params.orca.window < n):
        # ORCA's neighbour band and the sorting kernels sort by the same
        # key with the same stable sort: one permutation serves them all
        # (under sharding ORCA sorts the gathered crowd, the kernels each
        # shard's own slots)
        order = morton_order(state.pos_x, state.pos_y, alive, "hilbert")
    fx, fy = compute_forces(state, scene, params, cfg, veh_snap, order, axis)
    vmax = state.max_speed(params.max_speed_factor if state.batch is None
                           else as_column(params.max_speed_factor))
    vx, vy = vecmath.cap_velocity_xy(state.vel_x + cfg.dt * fx,
                                     state.vel_y + cfg.dt * fy, vmax)
    vx = torch.where(alive, vx, 0.0)
    vy = torch.where(alive, vy, 0.0)

    # ORCA (the JAX package's stepper.py:552-584): the capped velocity is
    # the preferred one, and the projection replaces it for the agents of
    # the ORCA law; road-crossing modes are exempt from the walls (they
    # step over the curb, as the border force's crossing rule has it)
    if params.enable_orca:
        ovx, ovy = orca_velocities(
            (state.pos_x, state.pos_y), (state.vel_x, state.vel_y),
            state.radius, alive, (vx, vy), vmax, params.orca, cfg.dt,
            veh_snap=veh_snap, spatial_order=cfg.spatial_order,
            borders=(scene.borders_feat if scene.borders_feat is not None
                     else scene.borders),
            obstacles=(scene.obstacles_feat if scene.obstacles_feat
                       is not None else scene.static_obstacles),
            static_exempt=forces.crossing_mask(state.mode), order=order,
            plain_feed=cfg.plain_env_force, axis=axis)
        law = scene.spawn.law_id
        om = alive if law is None else alive & (law == LAW_IDS["orca"])
        vx = torch.where(om, ovx, vx)
        vy = torch.where(om, ovy, vy)

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
                           device=new_idx.device) == new_idx[..., None])
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
                    cfg: StepConfig, t_idx: int,
                    veh_snap: VehicleSnapshot | None = None, axis=None):
    """One headless tick (spawn, core, Euler step) of a prepared scene
    (:func:`prepare_scene`).  Returns ``(new_state, RecordXY)``.
    ``veh_snap`` overrides the scene's scripted vehicles (the autopilot
    rollout passes its fleet's snapshot here).  ``axis``: the state and
    ``scene.spawn`` hold this shard's slots of an agent axis (see
    :func:`force_terms`)."""
    check_supported(scene, params, cfg, state, axis)
    sim_time = sim_time_of(t_idx, cfg.dt)

    # 1. spawn
    state = apply_spawn(state, scene.spawn, t_idx)

    if veh_snap is None and scene.vehicles is not None:
        veh_snap = vehicle_snapshot_at(scene.vehicles, t_idx)
    state, (vx, vy), finished, record = tick_core(
        state, scene, params, cfg, sim_time, veh_snap, axis)

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


def fleet_tick(state: PedState, ap: AutopilotState, scene: Scene,
               params: SfmParams, cfg: StepConfig, t_idx: int, axis=None):
    """One tick with the reactive fleet, in the reference's order
    (run_simulation.py:53-95; JAX package stepper.py:711-745): the walkers
    spawn, the vehicles move seeing this tick's walkers, then the
    pedestrian tick reads the fleet's snapshot (its own ``apply_spawn`` is
    then a no-op).  Returns ``(new_state, new_fleet_state, RecordXY)``.
    ``axis``: the state holds this shard's slots; the fleet's hazard check
    reads the all-gathered walkers, and every shard steps the same fleet
    (stepper.py:724-731)."""
    check_supported(scene, params, cfg, state, axis)
    state = apply_spawn(state, scene.spawn, t_idx)
    walkers = (state.pos_x, state.pos_y, state.vel_x, state.vel_y,
               state.alive)
    if axis is not None:
        walkers = tuple(axis.all_gather(a) for a in walkers)
    ap = autopilot_step(scene.autopilot, ap, walkers[:2], walkers[2:4],
                        walkers[4], t_idx, cfg.dt)
    snap = autopilot_snapshot(scene.autopilot, ap)
    state, rec = simulation_step(state, scene, params, cfg, t_idx,
                                 veh_snap=snap, axis=axis)
    return state, ap, rec


def rollout(state: PedState, scene: Scene, params: SfmParams, cfg: StepConfig,
            num_steps: int, record: bool = True, start_step: int = 0,
            record_stride: int = 1,
            autopilot_state: AutopilotState | None = None,
            return_autopilot_state: bool = False, axis=None):
    """Run ``num_steps`` ticks from ``start_step``.

    Returns ``(final_state, StepRecord)`` with ``(T, N)`` planes
    (``(T, N, 2)`` for pos/vel; a batch's ``(B, T, N)`` and ``(B, T, N,
    2)``) when ``record``, else ``(final_state, None)``.
    ``record_stride=k`` keeps every k-th tick's snapshot (the first of
    each stride); ``num_steps`` must then be a multiple of ``k``.  The
    records are preallocated and filled in place.  The scene is prepared
    first (:func:`prepare_scene`; a no-op when it already is).

    With a reactive fleet (``scene.autopilot``) each tick runs
    :func:`fleet_tick`, and the record is a ``(StepRecord,
    AutopilotRecord)`` pair.  The fleet starts from ``autopilot_state``
    (default: the fleet's initial state, allowed only at ``start_step``
    0); ``return_autopilot_state`` makes the first element the
    ``(PedState, AutopilotState)`` pair.  ``axis``: the state and
    ``scene.spawn`` are this shard's slots of an agent axis
    (:func:`..parallel.sharding.make_sharded_rollout` calls this for every
    shard).
    """
    check_supported(scene, params, cfg, state, axis)
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca, chunked=cfg.env_chunked)
    fleet = scene.autopilot
    if fleet is not None and autopilot_state is None and start_step != 0:
        raise NotImplementedError(
            "rollouts with a reactive autopilot fleet cannot resume from "
            "start_step != 0 without the saved fleet state: a fresh "
            "AutopilotState restarts vehicles from their route origins "
            "(pass autopilot_state from the checkpoint)")
    ap = None
    if fleet is not None:
        ap = (autopilot_state if autopilot_state is not None
              else fleet.initial_state())
    recs = ap_recs = None
    if record:
        if record_stride < 1:
            raise ValueError("record_stride must be positive")
        if num_steps % record_stride != 0:
            raise ValueError("num_steps must be a multiple of record_stride")
        t_rec = num_steps // record_stride
        n, dev, batch = state.capacity, state.device, state.batch

        def buf(shape, dtype=torch.float32, device=dev):
            return torch.empty((t_rec, *shape), dtype=dtype, device=device)

        def plane_buf(dtype=torch.float32):
            # a batch's records are (B, T, N), the JAX vmap's layout
            if batch is None:
                return buf((n,), dtype)
            return torch.empty((batch, t_rec, n), dtype=dtype, device=dev)

        recs = RecordXY(*(plane_buf() for _ in range(4)),
                        mode=plane_buf(torch.int32),
                        alive=plane_buf(torch.bool))
        if fleet is not None:
            v, fdev = fleet.num_vehicles, fleet.device
            ap_recs = AutopilotRecord(
                pos=buf((v, 2), device=fdev), heading=buf((v,), device=fdev),
                speed=buf((v,), device=fdev),
                active=buf((v,), torch.bool, fdev))
    for k in range(num_steps):
        t_idx = start_step + k
        if fleet is None:
            state, rec = simulation_step(state, scene, params, cfg, t_idx,
                                         axis=axis)
        else:
            state, ap, rec = fleet_tick(state, ap, scene, params, cfg, t_idx,
                                        axis)
        if record and k % record_stride == 0:
            for b, val in zip(recs, rec):
                (b[k // record_stride] if batch is None
                 else b[:, k // record_stride]).copy_(val)
            if fleet is not None:
                for b, val in zip(ap_recs, (ap.pos, ap.heading, ap.speed,
                                            ap.active)):
                    b[k // record_stride].copy_(val)
    final = (state, ap) if fleet is not None and return_autopilot_state \
        else state
    if not record:
        return final, None
    return final, (recs.assemble() if fleet is None
                   else (recs.assemble(), ap_recs))


def make_rollout_fn(scene: Scene, params: SfmParams, cfg: StepConfig,
                    num_steps: int, record: bool = True,
                    record_stride: int = 1):
    """Rollout closure ``run(state) -> (final_state, record | None)``, the
    counterpart of the JAX package's jitted closure (see :func:`rollout`
    for the record of a scene with a reactive fleet).  The scene is
    prepared once, here.  The state is not modified, so callers may reuse
    it across runs."""
    check_supported(scene, params, cfg)
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca, chunked=cfg.env_chunked)

    def run(state: PedState):
        return rollout(state, scene, params, cfg, num_steps, record=record,
                       record_stride=record_stride)

    return run
