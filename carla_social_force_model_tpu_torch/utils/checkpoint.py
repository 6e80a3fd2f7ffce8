"""Simulation checkpoint / resume (port of utils/checkpoint.py, npz only).

The rollout carry is a ``PedState`` (and, with a reactive fleet, an
``AutopilotState``) of tensors, so a snapshot is one compressed npz file
and resume is exact: a segmented rollout that checkpoints every K steps
gives the trajectories of an uninterrupted one (bitwise on the CPU; on a
card up to the summation order of the kernels that accumulate with atomics,
the symmetric pair kernel).

The files carry the JAX package's keys (``state__<field>`` for each
PedState field, ``ap__<field>`` for the fleet, ``step``), so a checkpoint
written by either package resumes in the other.  ``load_state`` reads the
JAX package's two older layouts too: snapshots from before the planar state
(``state__pos`` ``(N, 2)`` etc.) and fleet snapshots from before the
overtaking fields (no ``ap__lane_off``/``ap__overtaking``: both restore to
their rest value).

The JAX package's second backend, orbax, is a JAX library's format: the
port refuses it (an ``.orbax`` path or ``backend="orbax"`` raises
``ValueError``) rather than writing or reading something else in its place.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..models.state import PedState
from ..utils.device import DEFAULT_DEVICE, resolve_device

#: why the orbax backend is refused
ORBAX_REFUSED = ("the orbax checkpoint backend is the JAX package's (a JAX "
                 "library's format); the port writes and reads npz only")


def _refuse_orbax(path: str) -> None:
    if path.rstrip("/").endswith(".orbax"):
        raise ValueError(f"{path}: {ORBAX_REFUSED}")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def save_state(path: str, state: PedState, step: int,
               autopilot=None) -> str:
    """Snapshot the rollout carry at ``step`` to the npz file ``path``.

    ``autopilot``: the AutopilotState of a reactive-fleet rollout, saved
    alongside so a resumed rollout restores vehicles mid-route."""
    _refuse_orbax(path)
    payload = {f"state__{f.name}": _host(getattr(state, f.name))
               for f in dataclasses.fields(PedState)}
    if autopilot is not None:
        for f in dataclasses.fields(type(autopilot)):
            payload[f"ap__{f.name}"] = _host(getattr(autopilot, f.name))
    payload["step"] = np.asarray(step, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **payload)
    return path


def load_state(path: str, with_autopilot: bool = False,
               device: torch.device | str = DEFAULT_DEVICE):
    """Returns ``(state, step)`` with the state's tensors on ``device``, or
    ``(state, step, autopilot_or_None)`` when ``with_autopilot`` (None for
    checkpoints without a fleet)."""
    _refuse_orbax(path)
    device = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    with np.load(path) as data:
        files = data.files
        if "state__pos" in files:
            # pre-planar snapshot (state__pos (N, 2) etc.): migrate the
            # coordinate arrays into the planar fields on load
            def field_arr(name):
                for c in ("pos", "vel"):
                    if name in (f"{c}_x", f"{c}_y"):
                        return data[f"state__{c}"][:, 0 if name.endswith("x")
                                                   else 1]
                if name in ("wp_x", "wp_y"):
                    return data["state__waypoint"][:, 0 if name == "wp_x"
                                                   else 1]
                return data[f"state__{name}"]
        else:
            def field_arr(name):
                return data[f"state__{name}"]
        state = PedState(**{f.name: tensor(field_arr(f.name))
                            for f in dataclasses.fields(PedState)})
        step = int(data["step"])
        ap = None
        if with_autopilot and any(k.startswith("ap__") for k in files):
            from ..models.autopilot import AutopilotState

            def ap_arr(name):
                # fields added after a snapshot was written restore to
                # their rest value (pre-overtaking checkpoints carry no
                # lane_off/overtaking planes: both are zero at rest)
                if f"ap__{name}" in files:
                    return data[f"ap__{name}"]
                base = data["ap__speed"]
                return (np.zeros(base.shape, bool) if name == "overtaking"
                        else np.zeros(base.shape, base.dtype))
            ap = AutopilotState(**{
                f.name: tensor(ap_arr(f.name))
                for f in dataclasses.fields(AutopilotState)})
    if with_autopilot:
        return state, step, ap
    return state, step


def _concat(parts, batch: bool):
    """Records of consecutive segments along their time axis (a batch's
    records are ``(B, T, ...)``)."""
    return torch.cat(parts, dim=1 if batch else 0)


def run_segmented(state: PedState, scene, params, cfg, num_steps: int,
                  segment_steps: int, checkpoint_dir: str | None = None,
                  start_step: int = 0, record: bool = True,
                  autopilot_state=None, backend: str = "npz"):
    """Rollout in segments of ``segment_steps`` with a checkpoint after
    each (``ckpt_<step>.npz`` in ``checkpoint_dir``).

    Returns ``(final_state, stacked_records_or_None)``.  Resume by loading
    the newest checkpoint and passing its step as ``start_step``; with a
    reactive autopilot fleet, also pass its saved ``autopilot_state``
    (``load_state(..., with_autopilot=True)``) -- the record output is then
    a ``(StepRecord, AutopilotRecord)`` pair like ``rollout``'s."""
    from ..models.autopilot import AutopilotRecord
    from ..models.stepper import StepRecord, prepare_scene, rollout

    if backend != "npz":
        raise ValueError(f"checkpoint backend {backend!r}: "
                         + (ORBAX_REFUSED if backend == "orbax"
                            else "the port writes npz only"))
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca, chunked=cfg.env_chunked)
    fleet = scene.autopilot
    ap = autopilot_state
    if fleet is not None and ap is None:
        if start_step != 0:
            raise ValueError(
                "resuming a reactive-fleet rollout needs the checkpointed "
                "autopilot_state (load_state(..., with_autopilot=True))")
        ap = fleet.initial_state(state.batch)

    records = []
    step = start_step
    end = start_step + num_steps
    while step < end:
        n = min(segment_steps, end - step)
        out, rec = rollout(state, scene, params, cfg, n, record=record,
                           start_step=step, autopilot_state=ap,
                           return_autopilot_state=fleet is not None)
        state, ap = out if fleet is not None else (out, None)
        if record:
            records.append(rec)
        step += n
        if checkpoint_dir is not None:
            save_state(os.path.join(checkpoint_dir, f"ckpt_{step:08d}.npz"),
                       state, step, autopilot=ap)
    if not (record and records):
        return state, None
    batch = state.batch is not None

    def stack(parts, cls):
        return cls(*[_concat([getattr(r, f) for r in parts], batch)
                     for f in cls._fields])
    if fleet is not None:
        return state, (stack([r[0] for r in records], StepRecord),
                       stack([r[1] for r in records], AutopilotRecord))
    return state, stack(records, StepRecord)


def latest_checkpoint(checkpoint_dir: str):
    """Newest ``ckpt_*.npz`` snapshot in ``checkpoint_dir``, or None.  An
    orbax snapshot of the JAX package there is refused, not skipped: a
    resume would otherwise start from an older step."""
    if not os.path.isdir(checkpoint_dir):
        return None
    files = sorted((f for f in os.listdir(checkpoint_dir)
                    if f.startswith("ckpt_")
                    and (f.endswith(".npz") or f.endswith(".orbax"))),
                   key=lambda f: f.split(".")[0])
    if not files:
        return None
    path = os.path.join(checkpoint_dir, files[-1])
    _refuse_orbax(path)
    return path
