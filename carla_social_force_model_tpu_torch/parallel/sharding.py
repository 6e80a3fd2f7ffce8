"""Agent sharding: pedestrian slots split over the shards of an agent axis
(port of parallel/sharding.py).

Every per-slot tensor (the state, the spawn schedule and its route buffer)
is split along its first dimension into equal shards; the scene's geometry,
its vehicles, its fleet and its group table are the same on every shard.
The pair forces communicate their column state over the axis (all-gather,
or a ring: ``StepConfig.axis_comm``); the group force, ORCA and the
reactive fleet's hazard check all-gather the planes they read; everything
else is slot-local.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.routes import RouteBuffer
from ..models.spawn import SpawnSchedule
from ..models.state import PedState
from ..models.stepper import Scene, StepConfig, StepRecord, prepare_scene, \
    rollout
from ..models.params import SfmParams
from .mesh import LocalMesh, round_up


def _map_slots(obj, fn):
    """``obj`` (a SpawnSchedule, RouteBuffer or PedState) with ``fn``
    applied to every per-slot tensor."""
    upd = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            upd[f.name] = fn(v)
        elif isinstance(v, RouteBuffer):
            upd[f.name] = _map_slots(v, fn)
    return dataclasses.replace(obj, **upd)


def pad_spawn_schedule(schedule: SpawnSchedule,
                       new_capacity: int) -> SpawnSchedule:
    """Grow the slot dimension with zeros; padding slots never spawn
    (``step = -1``)."""
    pad = new_capacity - schedule.capacity
    if pad < 0:
        raise ValueError(f"cannot shrink a schedule of {schedule.capacity} "
                         f"slots to {new_capacity}")
    if pad == 0:
        return schedule

    def grow(t):
        return torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])

    padded = _map_slots(schedule, grow)
    step = padded.step.clone()
    step[schedule.capacity:] = -1
    return dataclasses.replace(padded, step=step)


def prepare_sharded_scene(scene: Scene, n_shards: int):
    """Pad the slot tensors to a multiple of ``n_shards``; returns
    ``(scene, capacity)``."""
    cap = round_up(scene.spawn.capacity, n_shards)
    return (dataclasses.replace(scene,
                                spawn=pad_spawn_schedule(scene.spawn, cap)),
            cap)


def shard_of(obj, index: int, n_shards: int):
    """Shard ``index`` of the per-slot tensors of ``obj`` (a PedState or a
    SpawnSchedule)."""
    n = obj.capacity
    if n % n_shards:
        raise ValueError(f"{n} slots do not split into {n_shards} shards: "
                         f"pad the scene with prepare_sharded_scene")
    m = n // n_shards
    return _map_slots(obj, lambda t: t[index * m:(index + 1) * m])


def make_sharded_rollout(axis, scene: Scene, params: SfmParams,
                         cfg: StepConfig, num_steps: int,
                         record: bool = False, start_step: int = 0):
    """Rollout closure with the pedestrian slots sharded over ``axis``.

    On a :class:`.mesh.LocalMesh` (``make_mesh``), ``run(state)`` takes the
    global state and returns the global final state and record, the shards
    stepping in their threads::

        mesh = make_mesh(8, device="cpu")
        scene, cap = prepare_sharded_scene(scene, 8)
        run = make_sharded_rollout(mesh, scene, params, cfg, steps)
        final, rec = run(PedState.empty(cap, device="cpu"))

    On one process's axis (:class:`.mesh.ProcessGroupAxis`), ``run(state)``
    takes the same global state and returns this process's shard of the
    final state and of the record.  A reactive fleet's record is the same on
    every shard.  ``start_step`` offsets the tick index, as in
    :func:`..models.stepper.rollout`."""
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca, chunked=cfg.env_chunked)
    n_shards = axis.size
    scenes = [dataclasses.replace(scene,
                                  spawn=shard_of(scene.spawn, d, n_shards))
              for d in range(n_shards)]

    def body(ax, state, scn):
        return rollout(state, scn, params, cfg, num_steps, record=record,
                       start_step=start_step, axis=ax)

    if not isinstance(axis, LocalMesh):
        def run_shard(state: PedState):
            return body(axis, shard_of(state, axis.index, n_shards),
                        scenes[axis.index])
        return run_shard

    def run(state: PedState):
        outs = axis.run(body, [shard_of(state, d, n_shards)
                               for d in range(n_shards)], scenes)
        final = PedState(**{f.name: torch.cat([getattr(o[0], f.name)
                                          for o in outs])
                            for f in dataclasses.fields(PedState)})
        if not record:
            return final, None
        recs = [o[1] for o in outs]
        if scene.autopilot is None:
            return final, StepRecord(*(torch.cat(parts, 1)
                                       for parts in zip(*recs)))
        ped = StepRecord(*(torch.cat(parts, 1)
                           for parts in zip(*(r[0] for r in recs))))
        return final, (ped, recs[0][1])

    return run
