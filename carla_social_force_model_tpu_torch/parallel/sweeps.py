"""Ensembles and parameter sweeps: B independent rollouts in one batched
step (port of parallel/sweeps.py).

The JAX package vmaps the rollout over a batch of spawn schedules (an
ensemble: shared geometry and params) or of parameter pytrees (a sweep:
one scene), so that its Pallas kernels gain a leading batch axis.  Here
the batch is written out: the state is ``(B, N)`` planes, an ensemble's
schedule ``(B, N)``, a sweep's parameter leaves ``(B,)`` tensors, and the
stepper launches each batched kernel once per step for every row
(``models/stepper.py``).  The records are ``(B, T, N)``, the vmap's
layout.  ``StepConfig.interaction_cutoff`` runs here as in one crowd:
each row sorted along its own curve, the batched cutoff pair kernels
(below the gate the box-skip walks, above it or with ``pair_max_surv``
each crowd's survivor table), with ``symmetric_pairs`` or without, for
every pair law.  So do the environment paths: ``env_compact`` (each
crowd's own survivor table over the shared sections, the batched
compacted kernels), ``env_analytic`` (the shared line-segment geometry,
dense or compacted, plus its sampled remainder) and ``env_chunked``, the
scenarios' engine (one chunk scan over every row's pedestrians).  So does
ORCA (its wall feeds prepared here, each part one batched launch a step;
a sweep of ``orca_tau``, ``orca_neighbor_dist`` and ``orca_tau_static``
per row), with the per-agent ``pair_scale``/``law_id`` columns of mixed
crowds: ``(B, N)`` in an ensemble's schedules, ``(N,)`` shared by a
sweep's rows.  So do social groups (one member table for every row) and
a reactive fleet: every row steps its own fleet from its own walkers, as
the JAX package's vmap carries one fleet state per row, and the record is
then the pair ``(StepRecord, AutopilotRecord)`` with the fleet's ``(B, T,
V)`` planes.  The geometry is prepared once here and shared by every
row; nothing here is specific to a path.

A mesh (``parallel/mesh.make_mesh(n_agent_shards, n_batch_shards)``, a
:class:`.mesh.LocalMesh` of virtual shards on one device) shards the
batch: the ``mesh`` argument of :func:`make_ensemble_rollout` and
:func:`make_sweep_rollout` splits the rows over its batch axis, each batch
row stepping its rows as one batched step (the agent axis is not used:
the JAX package replicates the rows over it), and
:func:`make_sharded_ensemble_rollout` also splits every crowd's slots over
the agent axis (the JAX package's composed 2-D parallelism): each shard
steps its crowds' slots as one batched step, and the pair forces bring in
their columns over the shard's batch row by ``StepConfig.axis_comm``
through the batched sharded kernels; ORCA, the group force and the
fleet's hazard check gather each crowd's slots over the row.  Every
configuration the three factories of the JAX package take runs.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.params import SECTIONS, SfmParams, map_leaves, param_batch
from ..models.spawn import SpawnSchedule
from ..models.state import PedState
from ..models.stepper import (Scene, StepConfig, StepRecord, check_supported,
                              prepare_scene, rollout)
from .sharding import join_shards, prepare_sharded_scene, shard_of


def _batch_rows(mesh, batch: int) -> int:
    """Rows per batch shard of ``mesh``; ``ValueError`` when ``batch`` does
    not divide over its batch axis."""
    if batch % mesh.n_batch_shards:
        raise ValueError(f"ensemble batch {batch} must divide over the "
                         f"mesh's {mesh.n_batch_shards}-way batch axis")
    return batch // mesh.n_batch_shards


def rows_of(obj, lo: int, hi: int):
    """Rows ``[lo, hi)`` of a batched SpawnSchedule, PedState or swept
    SfmParams (every tensor leaf's leading axis)."""
    if isinstance(obj, SfmParams):
        return map_leaves(obj, lambda t: t[lo:hi])
    upd = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            upd[f.name] = v[lo:hi]
        elif dataclasses.is_dataclass(v):
            upd[f.name] = rows_of(v, lo, hi)
    return dataclasses.replace(obj, **upd)


def _join_rows(outs):
    """The batch rows' ``(final, record | None)`` joined along the batch
    axis (states ``(B, N)``, records ``(B, T, N)``; with a fleet the
    ``(StepRecord, AutopilotRecord)`` pair, the fleet's ``(B, T, V)``)."""
    final = PedState(**{f.name: torch.cat([getattr(o[0], f.name)
                                           for o in outs])
                        for f in dataclasses.fields(PedState)})
    recs = [o[1] for o in outs]
    if recs[0] is None:
        return final, None

    def cat(parts):
        return type(parts[0])(*(torch.cat(p) for p in zip(*parts)))

    if isinstance(recs[0], StepRecord):
        return final, cat(recs)
    return final, (cat([r[0] for r in recs]), cat([r[1] for r in recs]))


def _over_batch_axis(mesh, batch: int, step_rows):
    """``step_rows(lo, hi)`` for each batch shard of ``mesh`` (rows ``[lo,
    hi)``), on the first agent shard of its batch row (the others hold
    the same rows: the JAX package replicates them over the agent axis),
    with the results joined along the batch axis."""
    per = _batch_rows(mesh, batch)

    def body(ax, r):
        return step_rows(r * per, (r + 1) * per) if ax.index == 0 else None

    return _join_rows([o for o in mesh.run(body, [
        k // mesh.size for k in range(mesh.n_shards)]) if o is not None])


def batch_params(params: SfmParams, **leaf_batches) -> SfmParams:
    """Broadcast selected numeric parameter leaves to a batch.

    Example::

        swept = batch_params(params, pedestrian_A=torch.linspace(2, 8, 256))

    names are ``<section>_<field>`` (e.g. ``pedestrian_A``, ``border_b``,
    ``acceleration_tau``, ``pedestrian_lambda``) and ``max_speed_factor``.
    All named leaves must share the batch size; every other numeric leaf
    is broadcast to it (the shape knobs of ``OrcaParams`` stay numbers).
    The leaves are float32 ``(B,)`` tensors on the device of the first
    tensor given (else the CPU); the rollouts move them to the scene's
    device."""
    sizes = {torch.as_tensor(v).shape[0] for v in leaf_batches.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent sweep batch sizes: {sizes}")
    (b,) = sizes
    device = next((v.device for v in leaf_batches.values()
                   if isinstance(v, torch.Tensor)), torch.device("cpu"))

    def leaf(value):
        return torch.as_tensor(value, dtype=torch.float32).to(device)

    def expand(section_params, section_name):
        updates = {}
        for f in dataclasses.fields(section_params):
            if f.metadata.get("static", False):
                continue
            key = f"{section_name}_{f.name}".rstrip("_")
            if key in leaf_batches:
                updates[f.name] = leaf(leaf_batches.pop(key))
            else:
                updates[f.name] = leaf(getattr(section_params, f.name)
                                       ).expand(b)
        return dataclasses.replace(section_params, **updates)

    new = dataclasses.replace(
        params, **{s: expand(getattr(params, s), s) for s in SECTIONS},
        max_speed_factor=leaf(leaf_batches.pop(
            "max_speed_factor", params.max_speed_factor)).expand(b))
    if leaf_batches:
        raise ValueError(f"unknown sweep parameters: {sorted(leaf_batches)}")
    return new


def make_ensemble_rollout(scene_batch: Scene, params: SfmParams,
                          cfg: StepConfig, num_steps: int,
                          record: bool = False, mesh=None):
    """Rollouts of a batch of scenarios (batched spawn schedules, shared
    geometry, shared params): BASELINE.json config #5's shape, hundreds of
    independent crowds of 1k+ pedestrians in one batched step.

    ``scene_batch.spawn`` planes carry a leading batch axis (``(B, N)``,
    :func:`..api.synthetic.batched_crowds`); the geometry, the fleet and
    the group table are shared (each row steps its own fleet state).  The
    returned ``run(scenes)`` takes a Scene (only its ``spawn`` batch is
    read: the geometry prepared here is what runs) or a bare
    SpawnSchedule batch, and returns ``(final_state, record | None)`` with
    ``(B, N)`` state planes and ``(B, T, N)`` records (with a fleet the
    ``(StepRecord, AutopilotRecord)`` pair).  ``mesh`` (a
    :class:`.mesh.LocalMesh`): the rows split over its batch axis
    (``ValueError`` when B does not divide over it), each batch shard
    stepping its rows as one batched step."""
    check_supported(scene_batch, params, cfg)
    scene_prepared = prepare_scene(scene_batch, analytic=cfg.env_analytic,
                                   orca=params.enable_orca,
                                   chunked=cfg.env_chunked)
    b, capacity = scene_prepared.spawn.step.shape
    if mesh is not None:
        _batch_rows(mesh, b)

    def rows(spawn):
        state = PedState.empty(capacity, device=spawn.step.device,
                               batch=spawn.step.shape[0])
        return rollout(state, dataclasses.replace(scene_prepared,
                                                  spawn=spawn),
                       params, cfg, num_steps, record=record)

    def run(scenes):
        spawn = scenes if isinstance(scenes, SpawnSchedule) else scenes.spawn
        if mesh is None:
            return rows(spawn)
        return _over_batch_axis(mesh, spawn.step.shape[0],
                                lambda lo, hi: rows(rows_of(spawn, lo, hi)))

    return run


def make_sharded_ensemble_rollout(mesh, scene_batch: Scene,
                                  params: SfmParams, cfg: StepConfig,
                                  num_steps: int, record: bool = False):
    """Ensembles over a 2-D ``(batch, agents)`` mesh (``make_mesh(
    n_agent_shards, n_batch_shards)``), the JAX package's composed
    parallelism: the B crowds of ``scene_batch.spawn`` (``(B, N)``) split
    over the batch axis (``ValueError`` when B does not divide over it),
    every crowd's slots padded to a multiple of the agent axis (padding
    slots never spawn) and split over it.  Shard ``(r, d)`` steps its
    crowds' slots as one batched step, with ``axis`` its batch row's agent
    axis: the pair forces bring in their columns by ``cfg.axis_comm``
    (each sharded kernel launched once per shard and step for all of its
    crowds; ``ring_kernel`` once for every shard and crowd), the rest is
    slot-local; ORCA, the group force and a fleet's hazard check gather
    each crowd's slots over the row, and every shard of a row steps the
    same fleets.  ``run()`` returns ``(final_state, record | None)`` with
    ``(B, N_padded)`` state planes and ``(B, T, N_padded)`` records (with a
    fleet the ``(StepRecord, AutopilotRecord)`` pair, the fleets' ``(B, T,
    V)`` from each row's first shard)."""
    if scene_batch.spawn.step.dim() != 2:
        raise ValueError("make_sharded_ensemble_rollout takes a batch of "
                         "spawn schedules, (B, N) (batched_crowds)")
    check_supported(scene_batch, params, cfg, axis=mesh)
    scene_prepared = prepare_scene(scene_batch, analytic=cfg.env_analytic,
                                   orca=params.enable_orca,
                                   chunked=cfg.env_chunked)
    b = scene_prepared.spawn.step.shape[0]
    per = _batch_rows(mesh, b)
    n_agents = mesh.size
    scene_prepared, cap = prepare_sharded_scene(scene_prepared, n_agents)
    device = scene_prepared.spawn.step.device
    scenes = [dataclasses.replace(scene_prepared, spawn=shard_of(
        rows_of(scene_prepared.spawn, r * per, (r + 1) * per), d,
        n_agents))
        for r in range(mesh.n_batch_shards) for d in range(n_agents)]

    def body(ax, scn):
        state = PedState.empty(cap // n_agents, device=device, batch=per)
        return rollout(state, scn, params, cfg, num_steps, record=record,
                       axis=ax)

    def row_out(row):
        """A batch row's shards joined along the slot axis, the fleet's
        record (the same on every shard) from its first."""
        if not record:
            return join_shards([o[0] for o in row])
        if scene_prepared.autopilot is None:
            return join_shards([o[0] for o in row], [o[1] for o in row])
        final, ped = join_shards([o[0] for o in row],
                                 [o[1][0] for o in row])
        return final, (ped, row[0][1][1])

    def run():
        outs = mesh.run(body, scenes)
        return _join_rows([row_out(outs[k:k + n_agents])
                           for k in range(0, len(outs), n_agents)])

    return run


def make_sweep_rollout(scene: Scene, cfg: StepConfig, num_steps: int,
                       record: bool = False, mesh=None, orca: bool = False):
    """Rollouts of one scene under a batch of parameters
    (:func:`batch_params`): ``run(params_batch)`` returns ``(final_state,
    record | None)`` with ``(B, N)`` state planes and ``(B, T, N)``
    records (with a fleet the ``(StepRecord, AutopilotRecord)`` pair, one
    fleet for each row), row b stepped with row b's parameters.
    ``orca``: the swept params' ``enable_orca``, so that the ORCA wall
    feeds are prepared here (the JAX package's argument).  ``mesh``: the
    rows split over its batch axis as in :func:`make_ensemble_rollout`."""
    scene = prepare_scene(scene, analytic=cfg.env_analytic, orca=orca,
                          chunked=cfg.env_chunked)
    device = scene.spawn.step.device

    def rows(params_batch: SfmParams):
        params_batch = map_leaves(params_batch,
                                  lambda t: t.to(device).contiguous())
        state = PedState.empty(scene.spawn.capacity, device=device,
                               batch=param_batch(params_batch))
        return rollout(state, scene, params_batch, cfg, num_steps,
                       record=record)

    def run(params_batch: SfmParams):
        batch = param_batch(params_batch)
        if batch is None:
            raise ValueError("make_sweep_rollout takes params with batched "
                             "leaves (batch_params)")
        if mesh is None:
            return rows(params_batch)
        return _over_batch_axis(
            mesh, batch, lambda lo, hi: rows(rows_of(params_batch, lo, hi)))

    return run
