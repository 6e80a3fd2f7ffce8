"""Driving-lane route graph: destination routing for headless vehicles (a
copy of the JAX package's routing/driving.py, numpy only).

The reference's ``auto_pilot = true`` + ``destination`` vehicles hand route
planning to CARLA's ``BehaviorAgent``, which plans over the town's driving
lanes (the reference's vehicle_spawner.py:131-138; the agent's
GlobalRoutePlanner walks ``map.get_topology()``).  Headless there is no
CARLA road network, so this module provides the headless equivalent: a
*directed* graph over driving-lane waypoint chains, serializable to ``.npz``
for headless replay (the ``[map] driving_graph_npz`` scenario key), routed
with A*, and built from a live CARLA map's topology walk by
:func:`build_carla_driving_graph`.

The planned polyline feeds :class:`models.autopilot.AutopilotSpec` --
destination-only reactive vehicles then run headless exactly like
waypoints-authored ones.

Directedness matters: driving lanes are one-way (a vehicle on lane -1
cannot legally travel the lane-1 chain backwards), so unlike the
pedestrian NavGraph (undirected CSR, routing/graph.py:58) edges are
materialized in their travel direction only.
"""
from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger(__name__)


@dataclass
class DrivingGraph:
    """Directed driving-lane graph (nodes = lane-center waypoints)."""

    nodes: np.ndarray        # (V, 3) float64 positions
    edge_u: np.ndarray       # (E,) int32 (directed: u -> v)
    edge_v: np.ndarray       # (E,) int32
    edge_length: np.ndarray  # (E,) float64
    # optional map spawn points (``map.get_spawn_points()`` parity: the
    # reference's ``spawn_point`` / ``destination`` integer indices resolve
    # against this list, vehicle_spawner.py:96-98, :131-132)
    spawn_xyz: np.ndarray | None = None   # (S, 3)
    spawn_yaw: np.ndarray | None = None   # (S,) radians
    _offsets: np.ndarray | None = field(default=None, repr=False)
    _nbr: np.ndarray | None = field(default=None, repr=False)
    _nbr_len: np.ndarray | None = field(default=None, repr=False)

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_u.shape[0]

    def csr(self):
        """Directed CSR adjacency (one direction only)."""
        if self._offsets is None:
            u = np.asarray(self.edge_u)
            order = np.argsort(u, kind="stable")
            v = np.asarray(self.edge_v)[order]
            ln = np.asarray(self.edge_length)[order]
            offsets = np.zeros(self.num_nodes + 1, np.int64)
            np.add.at(offsets, u[order] + 1, 1)
            self._offsets = np.cumsum(offsets).astype(np.int64)
            self._nbr = v.astype(np.int32)
            self._nbr_len = ln.astype(np.float64)
        return self._offsets, self._nbr, self._nbr_len

    def nearest_node(self, location) -> int:
        loc = _as_xyz(location)
        return int(np.argmin(np.linalg.norm(self.nodes - loc, axis=1)))

    def route(self, origin, destination) -> np.ndarray:
        """(K, 2) lane-center polyline origin -> destination.

        Origin/destination snap to the nearest graph node (the agent's
        planner snaps to the nearest driving waypoint the same way).
        Raises ValueError when no directed path exists.
        """
        start = self.nearest_node(origin)
        goal = self.nearest_node(destination)
        path = self._astar(start, goal)
        if not path:
            raise ValueError(
                f"no driving route between {_as_xyz(origin)[:2]} and "
                f"{_as_xyz(destination)[:2]} (directed graph, "
                f"{self.num_nodes} nodes)")
        return np.asarray(self.nodes[path][:, :2], np.float64)

    def _astar(self, start: int, goal: int) -> list[int]:
        if start == goal:
            return [start]
        offsets, nbr, nbr_len = self.csr()
        nodes = self.nodes

        def h(n):
            return float(np.linalg.norm(nodes[n] - nodes[goal]))

        dist = {start: 0.0}
        prev: dict[int, int] = {}
        open_heap = [(h(start), start)]
        closed: set[int] = set()
        while open_heap:
            _, u = heapq.heappop(open_heap)
            if u == goal:
                break
            if u in closed:
                continue
            closed.add(u)
            for i in range(offsets[u], offsets[u + 1]):
                v = int(nbr[i])
                nd = dist[u] + float(nbr_len[i])
                if nd < dist.get(v, np.inf):
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(open_heap, (nd + h(v), v))
        if goal not in dist:
            return []
        path = [goal]
        while path[-1] != start:
            path.append(prev[path[-1]])
        return path[::-1]

    def _node_dirs(self):
        """(V, 2) unit lane tangents per node (mean of touching edge
        directions; zero rows = isolated nodes), cached."""
        if getattr(self, "_dirs", None) is None:
            d = np.zeros((self.num_nodes, 2), np.float64)
            seg = (self.nodes[self.edge_v, :2]
                   - self.nodes[self.edge_u, :2])
            ln = np.linalg.norm(seg, axis=1)
            unit = seg / np.maximum(ln, 1e-9)[:, None]
            np.add.at(d, self.edge_u, unit)
            np.add.at(d, self.edge_v, unit)
            n = np.linalg.norm(d, axis=1)
            self._dirs = d / np.maximum(n, 1e-9)[:, None]
            self._dirs_valid = n > 1e-6
        return self._dirs, self._dirs_valid

    def lane_adjacency(self, route_xy, min_width: float = 2.0,
                       max_width: float = 5.5, parallel_cos: float = 0.7,
                       along_tol: float | None = None):
        """Per-route-point overtake legality from lane adjacency.

        CARLA's BehaviorAgent takes lane-change permission from the
        OpenDRIVE lane markings its local planner reads
        (the reference's vehicle_spawner.py:131-138).  The serialized
        driving graph carries no markings, but it DOES carry every lane's
        waypoint chain -- so the headless stand-in is geometric: a pass
        may start at route point ``i`` iff some OTHER lane chain runs
        alongside on the left (lateral offset in ``(min_width,
        max_width)``, longitudinally within ``along_tol`` of abreast,
        direction parallel or antiparallel within ``parallel_cos``).
        Same-direction neighbors model multi-lane one-ways; antiparallel
        ones the opposing lane of a two-way road (usable when clear --
        the maneuver's own oncoming-traffic window handles *when*).

        Returns ``(ok, est_width)``: a (K,) bool mask aligned with
        ``route_xy`` and the median lateral offset of the matched
        adjacent-lane nodes (None when nothing matched) -- the natural
        ``lane_width`` for the maneuver.
        """
        route = np.asarray(route_xy, np.float64).reshape(-1, 2)
        k = route.shape[0]
        if k == 0 or self.num_nodes == 0:
            return np.zeros((k,), bool), None
        if along_tol is None:
            med = float(np.median(self.edge_length)) if self.num_edges \
                else 4.0
            along_tol = max(1.25 * med, 2.0)

        # local route tangents (central differences, clamped ends)
        nxt = route[np.minimum(np.arange(k) + 1, k - 1)]
        prv = route[np.maximum(np.arange(k) - 1, 0)]
        tang = nxt - prv
        tn = np.linalg.norm(tang, axis=1)
        tang = tang / np.maximum(tn, 1e-9)[:, None]

        dirs, dirs_valid = self._node_dirs()
        nodes = self.nodes[:, :2]
        rel = nodes[None, :, :] - route[:, None, :]            # (K, V, 2)
        fwd = rel[..., 0] * tang[:, None, 0] + rel[..., 1] * tang[:, None, 1]
        lat = (tang[:, None, 0] * rel[..., 1]
               - tang[:, None, 1] * rel[..., 0])               # left > 0
        par = np.abs(dirs[None, :, 0] * tang[:, None, 0]
                     + dirs[None, :, 1] * tang[:, None, 1]) > parallel_cos
        match = (par & dirs_valid[None, :]
                 & (lat > min_width) & (lat < max_width)
                 & (np.abs(fwd) < along_tol)
                 & (tn > 1e-9)[:, None])
        ok = match.any(axis=1)
        est = float(np.median(lat[match])) if match.any() else None
        return ok, est

    def spawn_transform(self, index: int) -> tuple[np.ndarray, float]:
        """(xyz, yaw) of map spawn point ``index`` (reference
        ``self.spawn_points[int(...)]``, vehicle_spawner.py:96-98)."""
        if self.spawn_xyz is None:
            raise ValueError("driving graph carries no spawn points")
        return (np.asarray(self.spawn_xyz[index], np.float64),
                float(self.spawn_yaw[index]))

    def save_npz(self, path) -> None:
        extra = {}
        if self.spawn_xyz is not None:
            extra["spawn_xyz"] = self.spawn_xyz
            extra["spawn_yaw"] = self.spawn_yaw
        np.savez_compressed(path, nodes=self.nodes, edge_u=self.edge_u,
                            edge_v=self.edge_v, edge_length=self.edge_length,
                            **extra)

    @staticmethod
    def load_npz(path) -> "DrivingGraph":
        d = np.load(path)
        return DrivingGraph(
            nodes=d["nodes"], edge_u=d["edge_u"], edge_v=d["edge_v"],
            edge_length=d["edge_length"],
            spawn_xyz=d["spawn_xyz"] if "spawn_xyz" in d else None,
            spawn_yaw=d["spawn_yaw"] if "spawn_yaw" in d else None)


class DrivingGraphBuilder:
    """Incremental directed builder, node-deduplicating by rounded position
    (one decimal: opposite-direction lanes are metres apart, so they never
    fuse, while chain endpoints shared between topology segments do)."""

    def __init__(self, round_decimals: int = 1):
        self.round_decimals = round_decimals
        self._id_map: dict[tuple, int] = {}
        self._nodes: list[np.ndarray] = []
        self._edges: dict[tuple[int, int], float] = {}
        self.chain_ends: list[int] = []    # exit nodes of added chains
        self.chain_starts: list[int] = []  # entry nodes of added chains

    def node_id(self, xyz) -> int:
        xyz = _as_xyz(xyz)
        key = tuple(np.round(xyz, self.round_decimals))
        if key not in self._id_map:
            self._id_map[key] = len(self._nodes)
            self._nodes.append(xyz)
        return self._id_map[key]

    def add_edge(self, a_xyz, b_xyz, length: float | None = None) -> None:
        a, b = self.node_id(a_xyz), self.node_id(b_xyz)
        if a == b:
            return
        if length is None:
            length = float(np.linalg.norm(self._nodes[a] - self._nodes[b]))
        self._edges.setdefault((a, b), length)

    def add_chain(self, points) -> None:
        """Directed polyline along the travel direction; endpoints are
        recorded for the junction stitch pass."""
        pts = [_as_xyz(p) for p in points]
        ids = [self.node_id(p) for p in pts]
        kept_any = False
        for a, b in zip(ids[:-1], ids[1:]):
            if a != b:
                self.add_edge(self._nodes[a], self._nodes[b])
                kept_any = True
        if kept_any:
            self.chain_starts.append(ids[0])
            self.chain_ends.append(ids[-1])

    def stitch(self, radius: float) -> int:
        """Connect chain exits to nearby chain entries (directed).

        Real CARLA topology guarantees a junction segment joins each road's
        exit waypoint to the next road's entry waypoint; synthetic/fake maps
        may leave gaps at junctions instead.  Any exit-entry pair within
        ``radius`` gets a connecting edge, which is exactly the lane-change/
        turn freedom a junction grants.  Returns the number of edges added.
        """
        if radius <= 0.0 or not self.chain_ends:
            return 0
        nodes = np.asarray(self._nodes)
        starts = np.asarray(sorted(set(self.chain_starts)), np.int64)
        added = 0
        for e in sorted(set(self.chain_ends)):
            d = np.linalg.norm(nodes[starts] - nodes[e], axis=1)
            for s, ds in zip(starts[(d > 1e-9) & (d <= radius)],
                             d[(d > 1e-9) & (d <= radius)]):
                key = (int(e), int(s))
                if key not in self._edges:
                    self._edges[key] = float(ds)
                    added += 1
        return added

    def build(self, spawn_xyz=None, spawn_yaw=None) -> DrivingGraph:
        if not self._edges:
            raise ValueError("driving graph has no edges")
        keys = np.array(sorted(self._edges), np.int64)
        return DrivingGraph(
            nodes=np.asarray(self._nodes, np.float64),
            edge_u=keys[:, 0].astype(np.int32),
            edge_v=keys[:, 1].astype(np.int32),
            edge_length=np.asarray(
                [self._edges[tuple(k)] for k in keys], np.float64),
            spawn_xyz=(np.asarray(spawn_xyz, np.float64)
                       if spawn_xyz is not None else None),
            spawn_yaw=(np.asarray(spawn_yaw, np.float64)
                       if spawn_yaw is not None else None))


def build_carla_driving_graph(carla_map, waypoint_distance: float = 4.0,
                              stitch_radius: float = 25.0) -> DrivingGraph:
    """Directed driving graph from a CARLA(-like) map's topology walk.

    Mirrors the chain walk the pedestrian graph does for sidewalks
    (routing/carla_graph.py:100-124 / reference path_planner.py:210-240)
    but keeps the driving-lane waypoints themselves: for each topology
    segment entered on a Driving lane, the waypoint chain at
    ``waypoint_distance`` spacing becomes a directed polyline.  A stitch
    pass then joins segment exits to nearby segment entries (junction
    connectivity; real topology already provides junction segments, fake
    maps may not).  Map spawn points ride along when the map exposes
    ``get_spawn_points()``.
    """
    import sys
    carla = sys.modules.get("carla")
    # carla.LaneType.Driving is an enum in the real client, a string in the
    # test fakes; resolve whichever module is registered
    driving = carla.LaneType.Driving if carla is not None else "Driving"

    builder = DrivingGraphBuilder()
    for segment in carla_map.get_topology():
        wp_start, wp_end = segment[0], segment[1]
        if wp_start.lane_type != driving:
            continue
        chain = [wp_start] + wp_start.next_until_lane_end(waypoint_distance)
        pts = [_wp_xyz(w) for w in chain]
        # close the tail gap to the segment's exit waypoint -- but only when
        # it lies ahead within a chain step (some maps return an
        # entry-adjacent waypoint as the pair's second element, which would
        # otherwise add a backward edge)
        end_xyz = _wp_xyz(wp_end)
        gap = float(np.linalg.norm(pts[-1] - end_xyz))
        if 1e-6 < gap <= waypoint_distance * 1.5:
            pts.append(end_xyz)
        builder.add_chain(pts)
    n = builder.stitch(stitch_radius)
    if n:
        log.info("driving graph: stitched %d junction connections", n)

    spawn_xyz = spawn_yaw = None
    if hasattr(carla_map, "get_spawn_points"):
        tfs = carla_map.get_spawn_points()
        if tfs:
            spawn_xyz = np.array([[t.location.x, t.location.y, t.location.z]
                                  for t in tfs], np.float64)
            spawn_yaw = np.radians([t.rotation.yaw for t in tfs])
    return builder.build(spawn_xyz=spawn_xyz, spawn_yaw=spawn_yaw)


def _wp_xyz(waypoint) -> np.ndarray:
    loc = waypoint.transform.location
    return np.array([loc.x, loc.y, loc.z], np.float64)


def _as_xyz(p) -> np.ndarray:
    p = np.asarray(p, np.float64).reshape(-1)
    if p.shape[0] == 2:
        p = np.r_[p, 0.0]
    return p[:3].astype(np.float64)
