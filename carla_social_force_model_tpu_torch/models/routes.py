"""Padded per-pedestrian waypoint buffers (port of models/routes.py).

Each slot owns a padded row of ``(capacity, max_waypoints)`` x/y planes
plus a per-waypoint crossing-road flag; arrival advances an index.
:func:`build_route_buffer` packs the host-side lists with numpy and moves
the result to the device once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device


@dataclass(frozen=True)
class RouteBuffer:
    wp_x: torch.Tensor       # (N, W) f32
    wp_y: torch.Tensor       # (N, W) f32
    crossing: torch.Tensor   # (N, W) bool: road crossed when heading to wp
    count: torch.Tensor      # (N,) int32 number of valid waypoints

    @property
    def max_waypoints(self) -> int:
        return self.wp_x.shape[1]

    @property
    def waypoints(self) -> torch.Tensor:
        """(N, W, 2) assembly view (host-side consumers)."""
        return torch.stack([self.wp_x, self.wp_y], dim=-1)


def build_route_buffer(routes: Sequence[np.ndarray],
                       crossing_flags: Sequence[Sequence[bool]],
                       capacity: int | None = None,
                       device: torch.device | str = DEFAULT_DEVICE,
                       dtype=np.float32) -> RouteBuffer:
    """Pack per-ped waypoint lists into a RouteBuffer on ``device``.

    ``routes[i]`` is an (W_i, 2) array; ``crossing_flags[i]`` aligns with it.
    Mismatched lengths are trimmed to the shorter (the reference's zip
    semantics, pedestrian_spawner.py:209).
    """
    device = resolve_device(device)
    n = capacity if capacity is not None else len(routes)
    w_max = max([1] + [min(len(r), len(c)) for r, c in zip(routes, crossing_flags)])
    wp = np.zeros((n, w_max, 2), dtype=dtype)
    cr = np.zeros((n, w_max), dtype=bool)
    cnt = np.zeros((n,), dtype=np.int32)
    for i, (r, c) in enumerate(zip(routes, crossing_flags)):
        k = min(len(r), len(c))
        wp[i, :k] = np.asarray(r, dtype=dtype).reshape(-1, 2)[:k]
        cr[i, :k] = np.asarray(c, dtype=bool)[:k]
        cnt[i] = k
    return RouteBuffer(
        wp_x=torch.from_numpy(np.ascontiguousarray(wp[..., 0])).to(device),
        wp_y=torch.from_numpy(np.ascontiguousarray(wp[..., 1])).to(device),
        crossing=torch.from_numpy(cr).to(device),
        count=torch.from_numpy(cnt).to(device))
