"""Host-side navigation graph + A* routing (port of routing/)."""

from .graph import EdgeType, GraphType, NavGraph, NavGraphBuilder  # noqa: F401
from .planner import PedPathPlanner  # noqa: F401

__all__ = ["EdgeType", "GraphType", "NavGraph", "NavGraphBuilder",
           "PedPathPlanner"]
