"""Ensembles and parameter sweeps: B independent rollouts in one batched
step (port of parallel/sweeps.py).

The JAX package vmaps the rollout over a batch of spawn schedules (an
ensemble: shared geometry and params) or of parameter pytrees (a sweep:
one scene), so that its Pallas kernels gain a leading batch axis.  Here
the batch is written out: the state is ``(B, N)`` planes, an ensemble's
schedule ``(B, N)``, a sweep's parameter leaves ``(B,)`` tensors, and the
stepper launches each batched kernel once per step for every row
(``models/stepper.py``).  The records are ``(B, T, N)``, the vmap's
layout.

Sharding the batch over a mesh (the JAX package's ``mesh`` argument and
``make_sharded_ensemble_rollout``) is not ported yet: it raises and names
ROADMAP item 19b, as does every configuration the batched step refuses
(``stepper.check_supported``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.params import SECTIONS, SfmParams, map_leaves, param_batch
from ..models.spawn import SpawnSchedule
from ..models.state import PedState
from ..models.stepper import (BATCH_ITEM, Scene, StepConfig, check_supported,
                              prepare_scene, rollout)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"sharding a batch of rollouts over a mesh is not ported yet "
            f"({BATCH_ITEM})")


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
    :func:`..api.synthetic.batched_crowds`); the geometry is shared.  The
    returned ``run(scenes)`` takes a Scene (only its ``spawn`` batch is
    read: the geometry prepared here is what runs) or a bare
    SpawnSchedule batch, and returns ``(final_state, record | None)`` with
    ``(B, N)`` state planes and ``(B, T, N)`` records."""
    _no_mesh(mesh)
    check_supported(scene_batch, params, cfg)
    scene_prepared = prepare_scene(scene_batch, analytic=cfg.env_analytic,
                                   orca=params.enable_orca,
                                   chunked=cfg.env_chunked)
    b, capacity = scene_prepared.spawn.step.shape

    def run(scenes):
        spawn = scenes if isinstance(scenes, SpawnSchedule) else scenes.spawn
        state = PedState.empty(capacity, device=spawn.step.device,
                               batch=spawn.step.shape[0])
        return rollout(state, dataclasses.replace(scene_prepared,
                                                  spawn=spawn),
                       params, cfg, num_steps, record=record)

    return run


def make_sharded_ensemble_rollout(mesh, scene_batch: Scene,
                                  params: SfmParams, cfg: StepConfig,
                                  num_steps: int, record: bool = False):
    """The JAX package's 2-D ``(batch, agents)`` mesh: not ported yet."""
    raise NotImplementedError(
        f"ensembles over a 2-D (batch, agents) mesh are not ported yet "
        f"({BATCH_ITEM})")


def make_sweep_rollout(scene: Scene, cfg: StepConfig, num_steps: int,
                       record: bool = False, mesh=None, orca: bool = False):
    """Rollouts of one scene under a batch of parameters
    (:func:`batch_params`): ``run(params_batch)`` returns ``(final_state,
    record | None)`` with ``(B, N)`` state planes and ``(B, T, N)``
    records, row b stepped with row b's parameters.  ``orca`` (the swept
    params' ``enable_orca``, which prepares the ORCA wall feeds in the JAX
    package) and ``mesh`` are not ported under a batch yet and raise."""
    _no_mesh(mesh)
    if orca:
        raise NotImplementedError(f"ORCA under a batch of crowds is not "
                                  f"ported yet ({BATCH_ITEM})")
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          chunked=cfg.env_chunked)
    device = scene.spawn.step.device

    def run(params_batch: SfmParams):
        batch = param_batch(params_batch)
        if batch is None:
            raise ValueError("make_sweep_rollout takes params with batched "
                             "leaves (batch_params)")
        params_batch = map_leaves(params_batch,
                                  lambda t: t.to(device).contiguous())
        state = PedState.empty(scene.spawn.capacity, device=device,
                               batch=batch)
        return rollout(state, scene, params_batch, cfg, num_steps,
                       record=record)

    return run
