"""Synthetic large-N crowds and their environment for benchmarks (port of
api/synthetic.py).

The scene is drawn on the host with ``np.random.default_rng(seed)`` and
numpy in the JAX package's order, so both packages simulate the identical
scene for the same seed; the arrays then move to ``device`` once.  Every
builder defaults to the card; ``device="cpu"`` asks for the CPU.
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
from ..models.vehicles import (VehicleSpec, build_vehicle_states,
                               ellipse_template)
from ..env.borders import build_border_set, sample_borderline
from ..env.obstacles_gen import build_obstacle_set
from ..utils.device import DEFAULT_DEVICE, resolve_device


def synthetic_crowd(n: int, extent: float = 100.0, speed: float = 1.3,
                    seed: int = 0, radius: float = 0.3,
                    device: torch.device | str = DEFAULT_DEVICE
                    ) -> SpawnSchedule:
    """N pedestrians spawning at step 0, uniformly placed in a square of
    half-size ``extent``, each walking to the antipodal point (sustained
    counterflow through the center -- a dense interaction workload)."""
    device = resolve_device(device)
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


def _wall_sections(lines, centers, lengths, a, b,
                   section_length: float = 30.0, resolution: float = 0.1):
    """Append one sampled wall split into <=section_length sections (the
    reference's section-center/length coarse-filter granularity,
    forces.py:149-151)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    total = float(np.linalg.norm(b - a))
    n_sec = max(1, int(np.ceil(total / section_length)))
    for k in range(n_sec):
        s = a + (b - a) * (k / n_sec)
        e = a + (b - a) * ((k + 1) / n_sec)
        lines.append(sample_borderline(s, e, resolution))
        centers.append((s + e) / 2.0)
        lengths.append(float(np.linalg.norm(e - s)))


def synthetic_borders(extent: float, spacing: float = 20.0,
                      section_length: float = 30.0, resolution: float = 0.1):
    """Street-grid walls across the arena, sampled at the reference's 0.1 m
    border resolution and split into <=30 m sections.  BASELINE config #2's
    workload shape.  A host-side ``ChunkedPointSet``."""
    lines, centers, lengths = [], [], []
    coords = np.arange(-extent, extent + 1e-6, spacing)
    for c in coords:
        _wall_sections(lines, centers, lengths, (-extent, c), (extent, c),
                       section_length, resolution)   # horizontal street wall
        _wall_sections(lines, centers, lengths, (c, -extent), (c, extent),
                       section_length, resolution)   # vertical street wall
    return build_border_set(lines, centers, lengths)


def synthetic_obstacles(extent: float, spacing: float = 15.0,
                        resolution: float = 0.1,
                        perception_threshold: float = 20.0):
    """A grid of parked-car-sized static obstacles (ellipse outlines at the
    reference's sampling, obstacles.py:269-281).  BASELINE config #3's
    static workload shape.  A host-side ``ChunkedPointSet``."""
    outlines, centers = [], []
    coords = np.arange(-extent + spacing / 2, extent, spacing)
    tmpl = ellipse_template(2.4, 1.1, resolution)
    for cx in coords:
        for cy in coords:
            outlines.append(tmpl + np.array([cx, cy]))
            centers.append(np.array([cx, cy]))
    return build_obstacle_set(outlines, centers, perception_threshold)


def synthetic_vehicles(extent: float, count: int, dt: float, num_steps: int,
                       device: torch.device | str = DEFAULT_DEVICE):
    """Moving vehicles sweeping the arena (BASELINE config #3's dynamic
    obstacles): ``count`` lanes at 8 m/s, a timeline of ``num_steps``."""
    specs = []
    speed = 8.0
    length = num_steps + 2
    for v in range(count):
        y = -extent + (v + 0.5) * (2 * extent / count)
        xs = -extent + speed * dt * np.arange(length)
        specs.append(VehicleSpec(
            trajectory=np.column_stack([xs, np.full(length, y)]),
            headings=np.zeros(length), speeds=np.full(length, speed)))
    return build_vehicle_states(specs, dt, num_steps, device=device)


def benchmark_bundle(n: int, extent: float | None = None, seed: int = 0,
                     with_borders: bool = False, with_obstacles: bool = False,
                     num_steps_hint: int = 512,
                     device: torch.device | str = DEFAULT_DEVICE):
    """(scene, params, cfg, state) for the BASELINE.json benchmarks:

    * default: config #1 -- acceleration + pedestrian forces, headless, N
      pedestrians at about one per 4 m^2;
    * ``with_borders``: config #2 -- + the border force over a street-grid
      wall point cloud at 0.1 m resolution;
    * ``with_obstacles``: config #3 -- + static (parked-car grid) and
      dynamic (eight moving vehicles, a timeline of ``num_steps_hint``
      steps) obstacle forces.
    """
    device = resolve_device(device)
    if extent is None:
        extent = max(25.0, float(np.sqrt(n) * 1.0))
    static_obstacles = synthetic_obstacles(extent) if with_obstacles else None
    scene = Scene(
        spawn=synthetic_crowd(n, extent=extent, seed=seed, device=device),
        borders=synthetic_borders(extent) if with_borders else None,
        static_obstacles=static_obstacles,
        static_obstacle_vel=(
            torch.zeros((static_obstacles.num_segments, 2),
                        dtype=torch.float32, device=device)
            if with_obstacles else None),
        vehicles=(synthetic_vehicles(extent, count=8, dt=0.05,
                                     num_steps=num_steps_hint, device=device)
                  if with_obstacles else None))
    params = SfmParams(enable_acceleration=True, enable_pedestrian=True,
                       enable_border=with_borders,
                       enable_static_obstacle=with_obstacles,
                       enable_dynamic_obstacle=with_obstacles)
    cfg = StepConfig(dt=0.05, waypoint_threshold=2.0, despawn_on_arrival=False)
    return scene, params, cfg, PedState.empty(n, device=device)
