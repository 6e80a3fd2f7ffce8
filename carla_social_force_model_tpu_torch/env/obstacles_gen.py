"""Headless static-obstacle outline generation (port of env/obstacles_gen.py).

The reference extracts obstacle outlines from the CARLA world's bounding
boxes (obstacles.py:176-266: ellipse or rectangle outline around each
bbox).  Headless scenarios describe obstacles directly in the scenario TOML
(an extension -- the reference has no manual obstacle config):

    [[obstacles.static]]
    center = [x, y]
    extent = [ex, ey]          # bbox half extents
    heading = 0.0              # radians
    shape = "ellipse"          # or "rectangle"

and this module generates the same outlines the CARLA path would.  numpy
only, a copy of the JAX package's module.
"""
from __future__ import annotations

import numpy as np

from .pointsets import ChunkedPointSet, build_chunked_pointset
from ..models.vehicles import ellipse_template


def _rotate(points: np.ndarray, heading: float) -> np.ndarray:
    c, s = np.cos(heading), np.sin(heading)
    # row-vector form of w = R(heading) @ p
    return points @ np.array([[c, s], [-s, c]])


def ellipse_outline(center, extent, heading: float, resolution: float) -> np.ndarray:
    """World-frame ellipse outline (reference obstacles.py:269-281 semantics,
    sqrt(2) size factor, >= 6 samples)."""
    local = ellipse_template(float(extent[0]), float(extent[1]), resolution)
    return _rotate(local, heading) + np.asarray(center, np.float64)[:2]


def rectangle_outline(center, extent, heading: float, resolution: float) -> np.ndarray:
    """World-frame rectangle outline: the 4 bbox edges sampled at
    ``max(2, int(len/resolution))`` points each (reference obstacles.py:232-257,
    which picks the 4 shortest vertex-pair connections = the edges)."""
    ex, ey = float(extent[0]), float(extent[1])
    corners = np.array([[-ex, -ey], [ex, -ey], [ex, ey], [-ex, ey]])
    edges = []
    for i in range(4):
        a, b = corners[i], corners[(i + 1) % 4]
        length = np.linalg.norm(b - a)
        samples = max(2, int(length / resolution))
        edges.append(np.column_stack([np.linspace(a[0], b[0], samples),
                                      np.linspace(a[1], b[1], samples)]))
    local = np.concatenate(edges, axis=0)
    return _rotate(local, heading) + np.asarray(center, np.float64)[:2]


def static_obstacles_from_config(obstacle_config: dict | None):
    """Returns ``(outlines, centers)`` for ``[[obstacles.static]]`` entries."""
    outlines: list[np.ndarray] = []
    centers: list[np.ndarray] = []
    if obstacle_config:
        resolution = float(obstacle_config.get("resolution", 0.1))
        default_ellipse = bool(obstacle_config.get("ellipse_shape", True))
        for obs in obstacle_config.get("static", []):
            center = np.asarray(obs["center"], np.float64)[:2]
            extent = obs.get("extent", [0.5, 0.5])
            heading = float(obs.get("heading", 0.0))
            shape = obs.get("shape", "ellipse" if default_ellipse else "rectangle")
            gen = ellipse_outline if shape == "ellipse" else rectangle_outline
            outlines.append(gen(center, extent, heading, resolution))
            centers.append(center)
    return outlines, centers


def build_obstacle_set(outlines, centers, perception_threshold: float,
                       chunk_size: int = 128) -> ChunkedPointSet | None:
    """Pack obstacle outlines into a ChunkedPointSet filtered by the
    perception threshold (reference forces.py:222-224)."""
    if not outlines:
        return None
    centers = np.asarray(centers, np.float32).reshape(-1, 2)
    radius = np.full((len(outlines),), perception_threshold, np.float32)
    return build_chunked_pointset(outlines, centers, radius, chunk_size=chunk_size)
