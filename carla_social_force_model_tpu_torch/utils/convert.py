"""Carry parameters and state over from the JAX package.

Each function takes one JAX-package object flattened to a dict keyed by its
field names -- nested dataclasses as nested dicts, arrays as numpy arrays,
settings as Python values -- and builds the port's counterpart on a given
device.  The port never sees a JAX type: the caller flattens, for example::

    def fields_of(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: fields_of(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return obj
        return np.asarray(obj)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..api.scenario import ScenarioBundle
from ..env.pointsets import ChunkedPointSet
from ..models import params as P
from ..models.autopilot import (AutopilotFleet, AutopilotRecord,
                                AutopilotState)
from ..models.groups import GroupSet
from ..models.routes import RouteBuffer
from ..models.spawn import SpawnSchedule
from ..models.state import PedState
from ..models.stepper import Scene, StepConfig
from ..models.vehicles import VehicleStates

#: nested parameter groups of SfmParams and their dataclasses
_PARAM_GROUPS = {
    "acceleration": P.AccelerationParams, "pedestrian": P.MoussaidParams,
    "border": P.BorderParams, "static_obstacle": P.MoussaidParams,
    "dynamic_obstacle": P.MoussaidParams,
    "ped_repulsive": P.PedRepulsiveParams,
    "space_repulsive": P.SpaceRepulsiveParams,
    "powerlaw": P.PowerLawParams, "group": P.GroupParams,
    "orca": P.OrcaParams,
}


def _scalar(v):
    """A Python number from a Python or numpy scalar (0-d array)."""
    return v.item() if isinstance(v, (np.ndarray, np.generic)) else v


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf(v, device):
    """A parameter leaf: a Python number, or a batched (swept) leaf's
    ``(B,)`` array as a float32 tensor on ``device``."""
    if np.ndim(v) >= 1:
        return torch.from_numpy(np.asarray(v, np.float32).copy()).to(device)
    return _scalar(v)


def params_from_fields(d: dict, device: torch.device | str = "cpu"
                       ) -> P.SfmParams:
    """The port's SfmParams from a flattened JAX ``SfmParams``; the ``(B,)``
    leaves of a batched one (``parallel/sweeps.batch_params``) become
    float32 tensors on ``device``."""
    kw = {}
    for f in dataclasses.fields(P.SfmParams):
        v = d[f.name]
        if f.name in _PARAM_GROUPS:
            kw[f.name] = _PARAM_GROUPS[f.name](
                **{k: _leaf(x, device) for k, x in v.items()})
        else:
            kw[f.name] = _leaf(v, device)
    return P.SfmParams(**kw)


def step_config_from_fields(d: dict, engine_path: bool = False
                            ) -> StepConfig:
    """The port's StepConfig from a flattened JAX ``StepConfig``.

    ``pallas_symmetric`` becomes ``symmetric_pairs``, ``pallas_compact``
    ``compact_pairs`` and ``pallas_max_surv`` ``pair_max_surv``;
    ``interaction_cutoff`` and ``spatial_order`` carry over (the port
    applies the cutoff on every device, where the JAX package applies it on
    its Pallas path only).  ``use_pallas``, ``use_pallas_env``, the tile,
    VMEM, interpret and division knobs are TPU launch choices with no
    counterpart: the device chooses the path here.  ``env_compact``,
    ``env_max_surv``, ``env_analytic`` and ``axis_comm`` carry over (the port's compacted
    environment kernels run on the gate of the JAX package's default
    ``env_point_tile``).  The port applies ``env_analytic`` on every
    device, where the JAX package applies it on its Pallas path only.

    ``engine_path``: decide the path as the JAX package does from its
    ``use_pallas``/``use_pallas_env`` (the mapping of ``api/scenario.py``):
    without both, the jnp environment path (``env_chunked``) with the
    environment knobs dropped; without ``use_pallas``, no cutoff either
    (the JAX package applies them on its Pallas path only).  The existing
    parity tests keep the default, which carries every knob."""
    if engine_path:
        pallas = bool(d["use_pallas"])
        fused = pallas and bool(d["use_pallas_env"])
        d = dict(d, env_compact=d["env_compact"] and fused,
                 env_max_surv=d["env_max_surv"] if fused else 0,
                 env_analytic=d["env_analytic"] and fused,
                 interaction_cutoff=(d["interaction_cutoff"] if pallas
                                     else None))
        return dataclasses.replace(step_config_from_fields(d),
                                   env_chunked=not fused)
    return StepConfig(
        dt=float(d["dt"]), waypoint_threshold=float(d["waypoint_threshold"]),
        despawn_on_arrival=bool(d["despawn_on_arrival"]),
        row_block=int(d["row_block"]),
        symmetric_pairs=bool(d["pallas_symmetric"]),
        interaction_cutoff=(None if d["interaction_cutoff"] is None
                            else float(d["interaction_cutoff"])),
        compact_pairs=bool(d["pallas_compact"]),
        pair_max_surv=int(d["pallas_max_surv"]),
        spatial_order=str(d["spatial_order"]),
        env_compact=bool(d["env_compact"]),
        env_max_surv=int(d["env_max_surv"]),
        env_analytic=bool(d["env_analytic"]),
        axis_comm=str(d["axis_comm"]))


def ped_state_from_fields(d: dict, device: torch.device | str) -> PedState:
    """The port's PedState from a flattened JAX ``PedState``."""
    return PedState(**{f.name: _tensor(d[f.name], device)
                       for f in dataclasses.fields(PedState)})


def route_buffer_from_fields(d: dict, device: torch.device | str) -> RouteBuffer:
    """The port's RouteBuffer from a flattened JAX ``RouteBuffer``."""
    return RouteBuffer(**{f.name: _tensor(d[f.name], device)
                          for f in dataclasses.fields(RouteBuffer)})


def spawn_schedule_from_fields(d: dict,
                               device: torch.device | str) -> SpawnSchedule:
    """The port's SpawnSchedule (with its RouteBuffer) from a flattened JAX
    ``SpawnSchedule``, a batch of them (leading batch axis, as
    ``api/synthetic.batched_crowds`` builds) too."""
    kw = {}
    for f in dataclasses.fields(SpawnSchedule):
        v = d[f.name]
        if f.name == "routes":
            kw[f.name] = route_buffer_from_fields(v, device)
        else:
            kw[f.name] = None if v is None else _tensor(v, device)
    return SpawnSchedule(**kw)


def chunked_pointset_from_fields(d: dict | None) -> ChunkedPointSet | None:
    """The port's host-side ChunkedPointSet (numpy arrays) from a flattened
    JAX ``ChunkedPointSet``."""
    if d is None:
        return None
    return ChunkedPointSet(
        **{f.name: (int(d[f.name]) if f.name == "num_segments"
                    else np.array(d[f.name], copy=True))
           for f in dataclasses.fields(ChunkedPointSet)})


def vehicle_states_from_fields(d: dict | None, device: torch.device | str
                               ) -> VehicleStates | None:
    """The port's VehicleStates from a flattened JAX ``VehicleStates``."""
    if d is None:
        return None
    return VehicleStates(
        **{f.name: (int(d[f.name]) if f.name == "points_per_chunk"
                    else _tensor(d[f.name], device))
           for f in dataclasses.fields(VehicleStates)})


def autopilot_fleet_from_fields(d: dict | None, device: torch.device | str
                                ) -> AutopilotFleet | None:
    """The port's AutopilotFleet from a flattened JAX ``AutopilotFleet``
    (traffic-light fields stay None where the JAX fleet has none)."""
    if d is None:
        return None
    return AutopilotFleet(
        **{f.name: (int(d[f.name]) if f.name == "points_per_chunk"
                    else None if d[f.name] is None
                    else _tensor(d[f.name], device))
           for f in dataclasses.fields(AutopilotFleet)})


def autopilot_state_from_fields(d: dict, device: torch.device | str
                                ) -> AutopilotState:
    """The port's AutopilotState from a flattened JAX ``AutopilotState``:
    one fleet's ``(V,)`` planes, or a vmapped batch's ``(B, V)`` (one fleet
    for each crowd)."""
    return AutopilotState(**{f.name: _tensor(d[f.name], device)
                             for f in dataclasses.fields(AutopilotState)})


def autopilot_record_from_fields(d, device: torch.device | str
                                 ) -> AutopilotRecord:
    """The port's AutopilotRecord from a JAX ``AutopilotRecord`` (a
    NamedTuple, flattened as a dict of its fields or as the tuple of its
    arrays): a rollout's ``(T, V)`` planes or a vmapped batch's ``(B, T,
    V)``."""
    if not isinstance(d, dict):
        d = dict(zip(AutopilotRecord._fields, d))
    return AutopilotRecord(**{f: _tensor(d[f], device)
                              for f in AutopilotRecord._fields})


def group_set_from_fields(d: dict | None, device: torch.device | str
                          ) -> GroupSet | None:
    """The port's GroupSet from a flattened JAX ``GroupSet`` (its int32
    member table as the port's int64 one)."""
    if d is None:
        return None
    return GroupSet(member_slot=torch.from_numpy(
        np.asarray(d["member_slot"], np.int64)).to(device))


def scene_from_fields(d: dict, device: torch.device | str) -> Scene:
    """The port's Scene from a flattened JAX ``Scene``: the spawn schedule
    (with its per-slot ``group_id``, ``pair_scale`` and ``law_id``), the
    border and static-obstacle point sets, the obstacle velocities, the
    scripted vehicles, the autopilot fleet and the social groups' member
    table.  The JAX scene's derived layouts (segment-major, analytic, ORCA
    features) are not carried: the port's ``prepare_scene`` builds its
    own from the point sets."""
    vel = d.get("static_obstacle_vel")
    return Scene(
        spawn=spawn_schedule_from_fields(d["spawn"], device),
        borders=chunked_pointset_from_fields(d.get("borders")),
        static_obstacles=chunked_pointset_from_fields(
            d.get("static_obstacles")),
        static_obstacle_vel=None if vel is None else _tensor(vel, device),
        vehicles=vehicle_states_from_fields(d.get("vehicles"), device),
        autopilot=autopilot_fleet_from_fields(d.get("autopilot"), device),
        groups=group_set_from_fields(d.get("groups"), device))


def scenario_bundle_from_fields(d: dict, device: torch.device | str
                                ) -> ScenarioBundle:
    """The port's ScenarioBundle from a flattened JAX ``ScenarioBundle``:
    its scene, its parameters, its step configuration under the
    scenarios' engine mapping (``step_config_from_fields(...,
    engine_path=True)``) and its initial state, so that both packages can
    step the same objects.  ``border_lines``, ``obstacle_outlines`` and
    ``obstacle_centers`` are lists of arrays."""
    return ScenarioBundle(
        scene=scene_from_fields(d["scene"], device),
        cfg=step_config_from_fields(d["cfg"], engine_path=True),
        params=params_from_fields(d["params"]),
        initial_state=ped_state_from_fields(d["initial_state"], device),
        num_steps=int(d["num_steps"]), dt=float(d["dt"]),
        scenario_name=str(d["scenario_name"]),
        border_lines=[np.array(a, copy=True) for a in d["border_lines"]],
        obstacle_outlines=[np.array(a, copy=True)
                           for a in d["obstacle_outlines"]],
        obstacle_centers=[np.array(a, copy=True)
                          for a in d["obstacle_centers"]])
