"""CSV trajectory output with the reference's schemas (port of
utils/csvout.py; host I/O, byte-identical to the JAX package's writers).

Column layouts match the reference's output_generator.py exactly:
  pedestrian.csv: ped_id, frame, time, x, y, v_x, v_y, mode
  vehicle.csv:    veh_id, frame, time, x, y, heading, vel, ext_x, ext_y
  borders.csv:    x, y
  obstacles.csv:  obs_id, obs_pos_x, obs_pos_y, x, y

``mode`` is written as the PedMode integer by default; ``mode_text=True``
(implied by ``strict_parity`` at the API level) writes the reference's
stringified enum instead -- ``csv.writer`` stringifies the recorded
``PedMode`` IntEnum (output_generator.py:49) as ``PedMode.<NAME>`` on the
Python 3.7/3.8 the reference targets (3.11+ changed IntEnum.__str__, so the
text form is version-dependent upstream; we pin the 3.7/3.8 form).
Headings are radians, as the reference converts CARLA's degrees before
writing (output_generator.py:68).

Records and vehicle timelines arrive as tensors on any device and are
copied to the host once per call.
"""
from __future__ import annotations

import csv
import os
import time as _time

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _output_dir(output_path: str, scenario_name: str | None) -> str:
    stamp = _time.strftime("%Y%m%d-%H%M%S")
    name = f"{stamp}-{scenario_name}" if scenario_name else stamp
    out = os.path.join(output_path, name)
    os.makedirs(out, exist_ok=True)
    return out


def write_pedestrian_csv(path, records, dt, use_native: bool = True,
                         mode_text: bool = False, frame_offset: int = 0,
                         append: bool = False):
    """records: a StepRecord of (T, N, ...) tensors (models/stepper.py).

    Serialization goes through the native writer (native/trajio.cpp) when a
    toolchain is available -- recorded rollouts at large N reach gigabytes of
    CSV; it writes the same bytes as the Python path (Python's float
    formatting, covered by tests).  ``mode_text`` writes the reference's
    ``PedMode.<NAME>`` strings (Python path only).

    ``frame_offset``/``append`` support the streaming writer
    (api/simulation.Simulation.run_streamed): each chunk appends its rows
    with shifted frame/time columns, and only the first writes the header.
    """
    pos = np.ascontiguousarray(_host(records.pos), np.float32)
    vel = np.ascontiguousarray(_host(records.vel), np.float32)
    mode = np.ascontiguousarray(_host(records.mode), np.int32)
    alive = np.ascontiguousarray(_host(records.alive), np.uint8)

    if mode_text:
        use_native = False
    if use_native:
        import ctypes
        from .nativelib import load
        lib = load("trajio")
        if lib is not None:
            fn = lib.write_pedestrian_csv_chunk
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_int32),
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_double,
                           ctypes.c_int64, ctypes.c_int32]
            rows = fn(path.encode(), pos.shape[0], pos.shape[1],
                      pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      vel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      mode.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                      alive.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      float(dt), int(frame_offset), int(bool(append)))
            if rows >= 0:
                return

    if mode_text:
        from ..models.modes import MODE_NAMES
        fmt = {k: f"PedMode.{v}" for k, v in MODE_NAMES.items()}
        mode_of = lambda m: fmt[int(m)]
    else:
        mode_of = int
    with open(path, "a" if append else "w", encoding="UTF8", newline="") as f:
        w = csv.writer(f)
        if not append:
            w.writerow(["ped_id", "frame", "time", "x", "y", "v_x", "v_y",
                        "mode"])
        for t in range(pos.shape[0]):
            frame = frame_offset + t
            time = frame * dt
            for slot in np.nonzero(alive[t])[0]:
                w.writerow([int(slot), frame, time,
                            pos[t, slot, 0], pos[t, slot, 1],
                            vel[t, slot, 0], vel[t, slot, 1],
                            mode_of(mode[t, slot])])


def read_pedestrian_csv(path, capacity: int | None = None):
    """Inverse of :func:`write_pedestrian_csv`: load a ``pedestrian.csv``
    (this framework's or the reference's, output_generator.py:32-51) into a
    ``StepRecord`` of CPU tensors -- the observation format of the JAX
    package's differentiable calibration API (api/calibrate.py), so
    recorded runs and real CARLA captures can be fitted directly.

    Pedestrian ids are mapped to record columns in first-appearance order
    (the reference writes CARLA actor ids; this framework writes slot
    indices -- both become dense columns).  Frames are mapped to rows in
    sorted order, so ``record_stride`` outputs load naturally.  ``mode``
    accepts both the integer form and the reference's ``PedMode.<NAME>``
    strings.  Returns ``(record, dt)`` with ``dt`` estimated from the
    time/frame columns (0.0 for single-frame files).
    """
    from ..models.modes import MODE_NAMES
    from ..models.stepper import StepRecord
    name_to_mode = {f"PedMode.{v}": k for k, v in MODE_NAMES.items()}
    rows = []
    with open(path, newline="", encoding="UTF8") as f:
        r = csv.reader(f)
        header = next(r)
        if header[:3] != ["ped_id", "frame", "time"]:
            raise ValueError(f"{path}: not a pedestrian.csv (header {header[:3]})")
        for row in r:
            if row:
                rows.append(row)
    frames = sorted({int(row[1]) for row in rows})
    frame_idx = {fr: i for i, fr in enumerate(frames)}
    col_of: dict = {}
    for row in rows:
        col_of.setdefault(row[0], len(col_of))
    n = len(col_of)
    if capacity is not None:
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} distinct ped ids")
        n = capacity
    t = max(len(frames), 1)
    pos = np.zeros((t, n, 2), np.float32)
    vel = np.zeros((t, n, 2), np.float32)
    mode = np.zeros((t, n), np.int32)
    alive = np.zeros((t, n), bool)
    dt = 0.0
    for row in rows:
        ti = frame_idx[int(row[1])]
        ci = col_of[row[0]]
        pos[ti, ci] = (float(row[3]), float(row[4]))
        vel[ti, ci] = (float(row[5]), float(row[6]))
        m = row[7]
        mode[ti, ci] = name_to_mode[m] if m in name_to_mode else int(m)
        alive[ti, ci] = True
    if len(frames) > 1:
        # dt from the first two distinct frames (time = frame * dt)
        first = next(row for row in rows if int(row[1]) == frames[0])
        second = next(row for row in rows if int(row[1]) == frames[1])
        dt = ((float(second[2]) - float(first[2]))
              / (frames[1] - frames[0]))
    return StepRecord(pos=torch.from_numpy(pos), vel=torch.from_numpy(vel),
                      mode=torch.from_numpy(mode),
                      alive=torch.from_numpy(alive)), dt


def write_vehicle_csv(path, vehicles, dt, num_steps, frame_offset: int = 0,
                      append: bool = False):
    """vehicles: models.vehicles.VehicleStates (or None)."""
    with open(path, "a" if append else "w", encoding="UTF8", newline="") as f:
        w = csv.writer(f)
        if not append:
            w.writerow(["veh_id", "frame", "time", "x", "y", "heading", "vel",
                        "ext_x", "ext_y"])
        if vehicles is None:
            return
        pos = _host(vehicles.pos)
        heading = _host(vehicles.heading)
        vel = _host(vehicles.vel)
        active = _host(vehicles.active)
        extent = _host(vehicles.extent)
        for t in range(min(num_steps, pos.shape[0])):
            frame = frame_offset + t
            time = frame * dt
            for v in np.nonzero(active[t])[0]:
                w.writerow([int(v), frame, time,
                            pos[t, v, 0], pos[t, v, 1],
                            heading[t, v],
                            float(np.linalg.norm(vel[t, v])),
                            extent[v, 0], extent[v, 1]])


def write_vehicle_obs_csv(path, veh_history, dt):
    """Vehicle CSV from a per-tick list of bridge VehicleObs readbacks."""
    with open(path, "w", encoding="UTF8", newline="") as f:
        w = csv.writer(f)
        w.writerow(["veh_id", "frame", "time", "x", "y", "heading", "vel",
                    "ext_x", "ext_y"])
        for frame, obs_list in enumerate(veh_history):
            t = frame * dt
            for o in obs_list:
                w.writerow([o.actor_id, frame, t, o.center[0], o.center[1],
                            o.heading, float(np.linalg.norm(o.velocity)),
                            o.extent[0], o.extent[1]])


def write_borders_csv(path, border_lines):
    with open(path, "w", encoding="UTF8", newline="") as f:
        w = csv.writer(f)
        w.writerow(["x", "y"])
        for border in border_lines:
            for point in np.asarray(border):
                w.writerow([point[0], point[1]])


def write_obstacles_csv(path, outlines, centers):
    with open(path, "w", encoding="UTF8", newline="") as f:
        w = csv.writer(f)
        w.writerow(["obs_id", "obs_pos_x", "obs_pos_y", "x", "y"])
        for obs_id, (center, outline) in enumerate(zip(centers, outlines)):
            cx, cy = np.asarray(center)[:2]
            for point in np.asarray(outline):
                w.writerow([obs_id, cx, cy, point[0], point[1]])


def write_all(output_path: str, scenario_name: str | None, records, dt,
              vehicles=None, num_steps: int = 0, border_lines=(),
              obstacle_outlines=(), obstacle_centers=(),
              mode_text: bool = False):
    """Dump all four reference CSVs into a timestamped directory; returns it."""
    out = _output_dir(output_path, scenario_name)
    write_pedestrian_csv(os.path.join(out, "pedestrian.csv"), records, dt,
                         mode_text=mode_text)
    write_vehicle_csv(os.path.join(out, "vehicle.csv"), vehicles, dt, num_steps)
    write_borders_csv(os.path.join(out, "borders.csv"), border_lines)
    write_obstacles_csv(os.path.join(out, "obstacles.csv"),
                        obstacle_outlines, obstacle_centers)
    return out
