"""Synthetic large-N crowds for benchmarks (port of api/synthetic.py).

The scene is drawn on the host with ``np.random.default_rng(seed)`` in the
JAX package's draw order, so both packages simulate the identical crowd for
the same seed; the arrays then move to ``device`` once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import modes
from ..models.params import SfmParams
from ..models.routes import RouteBuffer
from ..models.spawn import SpawnSchedule
from ..models.state import PedState
from ..models.stepper import Scene, StepConfig


def synthetic_crowd(n: int, extent: float = 100.0, speed: float = 1.3,
                    seed: int = 0, radius: float = 0.3,
                    device: torch.device | str = "cpu") -> SpawnSchedule:
    """N pedestrians spawning at step 0, uniformly placed in a square of
    half-size ``extent``, each walking to the antipodal point (sustained
    counterflow through the center -- a dense interaction workload)."""
    dtype = np.float32
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(dtype)
    dest = (-pos).astype(dtype)
    direction = dest - pos
    nrm = np.linalg.norm(direction, axis=-1, keepdims=True)
    direction = direction / np.where(nrm == 0, 1, nrm)
    speeds = np.full((n,), speed, dtype) + rng.uniform(-0.2, 0.2, n).astype(dtype)
    vel = direction * speeds[:, None]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    routes = RouteBuffer(
        wp_x=dev(dest[:, None, 0]), wp_y=dev(dest[:, None, 1]),
        crossing=torch.zeros((n, 1), dtype=torch.bool, device=device),
        count=torch.ones((n,), dtype=torch.int32, device=device))
    return SpawnSchedule(
        step=torch.zeros((n,), dtype=torch.int32, device=device),
        pos_x=dev(pos[:, 0]), pos_y=dev(pos[:, 1]),
        vel_x=dev(vel[:, 0]), vel_y=dev(vel[:, 1]),
        speed=dev(speeds), crossing_speed=dev(speeds * 1.5),
        margin=torch.full((n,), 1.5, dtype=torch.float32, device=device),
        radius=torch.full((n,), radius, dtype=torch.float32, device=device),
        initial_mode=torch.full((n,), modes.WALKING_SIDEWALK,
                                dtype=torch.int32, device=device),
        fwp_x=dev(dest[:, 0]), fwp_y=dev(dest[:, 1]),
        routes=routes)


def benchmark_bundle(n: int, extent: float | None = None, seed: int = 0,
                     with_borders: bool = False, with_obstacles: bool = False,
                     device: torch.device | str = "cpu"):
    """(scene, params, cfg, state) for BASELINE config #1: acceleration and
    Moussaid pedestrian forces, headless, N pedestrians at about one per
    4 m^2.  Configs #2 (``with_borders``) and #3 (``with_obstacles``) belong
    to the environment slice of the port and raise here."""
    if with_borders or with_obstacles:
        raise NotImplementedError(
            "benchmark configs #2/#3 (borders, obstacles) are not ported to "
            "PyTorch yet (the environment slice of the port)")
    if extent is None:
        extent = max(25.0, float(np.sqrt(n) * 1.0))
    scene = Scene(spawn=synthetic_crowd(n, extent=extent, seed=seed,
                                        device=device))
    params = SfmParams(enable_acceleration=True, enable_pedestrian=True,
                       enable_border=False, enable_static_obstacle=False,
                       enable_dynamic_obstacle=False)
    cfg = StepConfig(dt=0.05, waypoint_threshold=2.0, despawn_on_arrival=False)
    return scene, params, cfg, PedState.empty(n, device=device)
