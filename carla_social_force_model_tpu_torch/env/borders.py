"""Manual border geometry from scenario configs (port of env/borders.py).

Host-side sampling of straight borderlines defined in the scenario TOML
(``[[obstacles.borders]]``), replicating the reference's sampling semantics
exactly (obstacles.py:332-359): ``int(length/resolution)`` inclusive
linspace samples, section center = middle sample, section length =
sample_count * resolution (the coarse relevance-filter radius of the border
force).  numpy only, a copy of the JAX package's module.
"""
from __future__ import annotations

import numpy as np

from .pointsets import ChunkedPointSet, build_chunked_pointset


def sample_borderline(start_point, end_point, resolution: float) -> np.ndarray:
    """Sample a straight border as the reference does (obstacles.py:344-351)."""
    start = np.asarray(start_point, np.float64)[:2]
    end = np.asarray(end_point, np.float64)[:2]
    samples = int(np.linalg.norm(end - start) / resolution)
    return np.column_stack([np.linspace(start[0], end[0], samples),
                            np.linspace(start[1], end[1], samples)])


def borders_from_config(obstacle_config: dict | None):
    """Extract manual borders: returns ``(border_lines, centers, lengths)``.

    Matches ``extract_borders_from_config`` (obstacles.py:332-359); scenario
    TOMLs of the reference parse unchanged.
    """
    lines: list[np.ndarray] = []
    centers: list[np.ndarray] = []
    lengths: list[float] = []
    if obstacle_config:
        resolution = float(obstacle_config.get("resolution", 0.1))
        for border in obstacle_config.get("borders", []):
            line = sample_borderline(border["start_point"], border["end_point"],
                                     resolution)
            if len(line) == 0:
                continue
            lines.append(line)
            centers.append(line[len(line) // 2])
            lengths.append(len(line) * resolution)
    return lines, centers, lengths


def build_border_set(lines, centers, lengths, chunk_size: int = 128
                     ) -> ChunkedPointSet | None:
    """Pack border lines + section info into a ChunkedPointSet (or None)."""
    if not lines:
        return None
    return build_chunked_pointset(
        lines, np.asarray(centers, np.float32), np.asarray(lengths, np.float32),
        chunk_size=chunk_size)
