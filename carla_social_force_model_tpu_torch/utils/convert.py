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

from ..models import params as P
from ..models.routes import RouteBuffer
from ..models.spawn import SpawnSchedule
from ..models.state import PedState
from ..models.stepper import StepConfig

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


def params_from_fields(d: dict) -> P.SfmParams:
    """The port's SfmParams from a flattened JAX ``SfmParams``."""
    kw = {}
    for f in dataclasses.fields(P.SfmParams):
        v = d[f.name]
        if f.name in _PARAM_GROUPS:
            kw[f.name] = _PARAM_GROUPS[f.name](
                **{k: _scalar(x) for k, x in v.items()})
        else:
            kw[f.name] = _scalar(v)
    return P.SfmParams(**kw)


def step_config_from_fields(d: dict) -> StepConfig:
    """The port's StepConfig from a flattened JAX ``StepConfig``.

    ``pallas_symmetric`` becomes ``symmetric_pairs``.  ``use_pallas``, the
    tile, VMEM, interpret and division knobs and the environment-kernel
    settings are TPU launch choices with no counterpart: the device chooses
    the path here.  ``interaction_cutoff`` carries over (and raises when a
    step runs, until the cutoff slice is ported)."""
    return StepConfig(
        dt=float(d["dt"]), waypoint_threshold=float(d["waypoint_threshold"]),
        despawn_on_arrival=bool(d["despawn_on_arrival"]),
        row_block=int(d["row_block"]),
        symmetric_pairs=bool(d["pallas_symmetric"]),
        interaction_cutoff=(None if d["interaction_cutoff"] is None
                            else float(d["interaction_cutoff"])))


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
    ``SpawnSchedule``."""
    kw = {}
    for f in dataclasses.fields(SpawnSchedule):
        v = d[f.name]
        if f.name == "routes":
            kw[f.name] = route_buffer_from_fields(v, device)
        else:
            kw[f.name] = None if v is None else _tensor(v, device)
    return SpawnSchedule(**kw)
