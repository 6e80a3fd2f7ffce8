"""Pedestrian path planner: routes over a NavGraph (port of
routing/planner.py; host-side numpy, as in the JAX package).

Host-side counterpart of the reference's ``PedPathPlanner.generate_route``
(path_planner.py:45-172): A* with euclidean heuristic over
the graph-type-filtered subgraph, detour-removing start/end pruning, and
per-waypoint crossing-road flags derived from edge types.  The graph itself
comes from the CARLA bridge's map extraction, a cached ``.npz``, or
programmatic builders (routing/graph.py); this module is map-source-agnostic.
"""
from __future__ import annotations

import numpy as np

from .astar import AStarRouter
from .graph import CROSSING_EDGE_TYPES, GraphType, NavGraph


class PedPathPlanner:
    """Generates pedestrian routes as ``[(xyz, crossing_road_bool)]``.

    ``waypoint_locator``: optional callable ``location ->
    ((road_id, section_id, lane_id), snapped_xyz) | None`` (a map's
    ``get_waypoint(loc, lane_type=Sidewalk)``).  With it -- and a graph
    carrying per-edge OpenDRIVE coordinates -- origin/destination snapping
    uses the reference's road/section/lane edge index
    (path_planner.py:119-143); without it, euclidean nearest node over the
    subgraph (documented fallback for map-free graphs).  ``use_native``:
    the router's native core (:class:`.astar.AStarRouter`; the same
    routes either way).
    """

    def __init__(self, graph: NavGraph, use_native: bool = True,
                 waypoint_locator=None):
        self.graph = graph
        self.router = AStarRouter(graph, use_native=use_native)
        self.waypoint_locator = waypoint_locator
        # (u, v) -> edge type for crossing flags (undirected)
        self._edge_types = {}
        for u, v, t in zip(graph.edge_u, graph.edge_v, graph.edge_type):
            self._edge_types[(int(u), int(v))] = int(t)
            self._edge_types[(int(v), int(u))] = int(t)

    def nearest_node(self, location, graph_type: GraphType) -> int:
        """Reference lookup: snap to the nearest sidewalk lane via the map,
        then pick the closest endpoint among the graph edges built on that
        (road, section, lane) -- distances measured from the *snapped*
        waypoint, exactly as path_planner.py:129-141.  Falls back to
        euclidean when the map/index can't resolve the location (where the
        reference would return None and crash in nx.astar_path)."""
        location = _as_xyz(location)
        if self.waypoint_locator is not None and self.graph.edge_rsl is not None:
            hit = self.waypoint_locator(location)
            if hit is not None:
                rsl, snapped = hit
                edges = self.graph.road_index().get(tuple(int(x) for x in rsl))
                if edges:
                    snapped = _as_xyz(snapped)
                    best, best_d = None, np.inf
                    for e in edges:
                        for node in (int(self.graph.edge_u[e]),
                                     int(self.graph.edge_v[e])):
                            d = float(np.linalg.norm(
                                self.graph.nodes[node] - snapped))
                            if d < best_d:
                                best, best_d = node, d
                    return best
        return self.router.nearest_node(location, graph_type)

    def generate_route(self, origin, destination,
                       graph_type: GraphType = GraphType.NO_JAYWALKING,
                       with_origin: bool = False):
        """Route from origin to destination (reference :45-101 semantics).

        Returns a list of ``(np.array([x, y, z]), crossing_road)`` tuples:
        the entry node, the path nodes flagged by the edge type used to reach
        them, and finally the raw destination (always flag False).
        """
        origin = _as_xyz(origin)
        destination = _as_xyz(destination)
        if isinstance(graph_type, str):
            graph_type = GraphType[graph_type]

        start = self.nearest_node(origin, graph_type)
        goal = self.nearest_node(destination, graph_type)
        node_path = self.router.shortest_path(start, goal, graph_type)
        if not node_path:
            raise ValueError(
                f"no route between {origin[:2]} and {destination[:2]} "
                f"in subgraph {graph_type.name}")
        node_path = self._prune_detour_ends(node_path, origin, destination)

        route = []
        if with_origin:
            route.append((origin.copy(), False))
        nodes = self.graph.nodes
        for i in range(len(node_path) - 1):
            if i == 0:
                route.append((nodes[node_path[0]].copy(), False))
            etype = self._edge_types.get((node_path[i], node_path[i + 1]), -1)
            crossing = etype in {int(t) for t in CROSSING_EDGE_TYPES}
            route.append((nodes[node_path[i + 1]].copy(), crossing))
        # single-node path: the reference emits only the raw destination
        # (generate_route's loop body never runs, path_planner.py:79-96)
        route.append((destination.copy(), False))
        return route

    def _prune_detour_ends(self, path, origin, destination):
        """Drop the first/last node when going through it is a detour
        (reference _remove_unnecessary_start_end_nodes :154-172)."""
        if len(path) > 1:
            nodes = self.graph.nodes
            first, second = nodes[path[0]], nodes[path[1]]
            last, second_last = nodes[path[-1]], nodes[path[-2]]
            drop_first = (np.linalg.norm(first - second)
                          > np.linalg.norm(origin - second))
            drop_last = (np.linalg.norm(last - second_last)
                         > np.linalg.norm(destination - second_last))
            if drop_first:
                path = path[1:]
            if drop_last and len(path) > 1:
                path = path[:-1]
        return path

    def route_provider(self):
        """Adapter for api.scenario.extract_ped_spawners: returns
        ``(origin, destination, graph_type_name) -> (waypoints, crossing)``."""

        def provide(origin, destination, graph_type_name):
            tuples = self.generate_route(origin, destination,
                                         GraphType[graph_type_name])
            waypoints = np.stack([t[0] for t in tuples], axis=0)
            crossing = [bool(t[1]) for t in tuples]
            return waypoints, crossing

        return provide


def _as_xyz(p) -> np.ndarray:
    p = np.asarray(p, np.float64).reshape(-1)
    if p.shape[0] == 2:
        p = np.r_[p, 0.0]
    return p[:3]
