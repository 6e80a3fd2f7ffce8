"""Pedestrian navigation graph, host-side (a copy of the JAX package's
routing/graph.py, which imports no JAX; the port keeps its own).

Array-backed replacement for the reference's networkx graph
(the reference's path_planner.py:438-501): nodes are 3-D positions, edges
carry length + EdgeType, and routing-time subgraphs are edge-type masks
instead of copied graphs (path_planner.py:564-588).  Jaywalking-type edges
are weighted by ``jaywalking_weight_factor`` at build time
(path_planner.py:473-475).

Graphs come from three sources: the CARLA bridge's map extraction
(``routing/carla_graph.py``), a cached ``.npz``, or programmatic
construction (headless scenarios).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np


class EdgeType(IntEnum):
    """Reference path_planner.py:9-15."""

    VOID = -1
    SIDEWALK = 1
    CROSSWALK = 2
    JAYWALKING = 3
    JAYWALKING_JUNCTION = 4
    SIDEWALK_TO_ROAD = 5


class GraphType(IntEnum):
    """Reference path_planner.py:18-21."""

    NO_JAYWALKING = 1
    JAYWALKING_AT_JUNCTION = 2
    JAYWALKING = 3


#: edge types excluded per graph type (reference _extract_subgraphs :564-574)
EXCLUDED_EDGE_TYPES = {
    GraphType.JAYWALKING: frozenset(),
    GraphType.JAYWALKING_AT_JUNCTION: frozenset(
        {EdgeType.JAYWALKING, EdgeType.SIDEWALK_TO_ROAD}),
    GraphType.NO_JAYWALKING: frozenset(
        {EdgeType.JAYWALKING, EdgeType.SIDEWALK_TO_ROAD,
         EdgeType.JAYWALKING_JUNCTION}),
}

#: heading to a waypoint over these edge types means crossing a road
#: (reference generate_route path_planner.py:84-86)
CROSSING_EDGE_TYPES = frozenset(
    {EdgeType.CROSSWALK, EdgeType.JAYWALKING, EdgeType.JAYWALKING_JUNCTION})


@dataclass
class NavGraph:
    """Undirected graph in CSR form (both directions materialized)."""

    nodes: np.ndarray        # (V, 3) float64 positions
    edge_u: np.ndarray       # (E,) int32
    edge_v: np.ndarray       # (E,) int32
    edge_length: np.ndarray  # (E,) float64 weighted length
    edge_type: np.ndarray    # (E,) int32
    # per-edge OpenDRIVE (road_id, section_id, lane_id) of the entry
    # waypoint, -1 where unknown (the reference's ``road_id_to_edge`` index
    # source, path_planner.py:479-496); None on map-free graphs
    edge_rsl: np.ndarray | None = None   # (E, 3) int64
    # CSR adjacency (built lazily)
    _offsets: np.ndarray | None = field(default=None, repr=False)
    _nbr: np.ndarray | None = field(default=None, repr=False)
    _nbr_len: np.ndarray | None = field(default=None, repr=False)
    _nbr_type: np.ndarray | None = field(default=None, repr=False)
    _road_index: dict | None = field(default=None, repr=False)

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_u.shape[0]

    def csr(self):
        """(offsets, neighbors, lengths, types) with both edge directions."""
        if self._offsets is None:
            u = np.concatenate([self.edge_u, self.edge_v])
            v = np.concatenate([self.edge_v, self.edge_u])
            ln = np.concatenate([self.edge_length, self.edge_length])
            ty = np.concatenate([self.edge_type, self.edge_type])
            order = np.argsort(u, kind="stable")
            u, v, ln, ty = u[order], v[order], ln[order], ty[order]
            offsets = np.zeros(self.num_nodes + 1, np.int64)
            np.add.at(offsets, u + 1, 1)
            offsets = np.cumsum(offsets)
            self._offsets = offsets.astype(np.int64)
            self._nbr = v.astype(np.int32)
            self._nbr_len = ln.astype(np.float64)
            self._nbr_type = ty.astype(np.int32)
        return self._offsets, self._nbr, self._nbr_len, self._nbr_type

    def allowed_mask(self, graph_type: GraphType) -> int:
        """Bitmask over edge types allowed for ``graph_type`` (bit = type+1,
        so VOID=-1 maps to bit 0)."""
        mask = 0
        for t in EdgeType:
            if t not in EXCLUDED_EDGE_TYPES[graph_type]:
                mask |= 1 << (int(t) + 1)
        return mask

    def nodes_in_subgraph(self, graph_type: GraphType) -> np.ndarray:
        """Bool mask of nodes touched by at least one allowed edge."""
        excluded = EXCLUDED_EDGE_TYPES[graph_type]
        keep = ~np.isin(self.edge_type,
                        [int(t) for t in excluded]) if excluded else \
            np.ones(self.num_edges, bool)
        mask = np.zeros(self.num_nodes, bool)
        mask[self.edge_u[keep]] = True
        mask[self.edge_v[keep]] = True
        return mask

    def road_index(self) -> dict:
        """``{(road_id, section_id, lane_id): [edge_idx, ...]}`` over edges
        with known OpenDRIVE coordinates (reference ``road_id_to_edge``)."""
        if self._road_index is None:
            idx: dict = {}
            if self.edge_rsl is not None:
                for e, (r, s, l) in enumerate(np.asarray(self.edge_rsl)):
                    if r < 0 and s < 0 and l < 0:
                        continue
                    idx.setdefault((int(r), int(s), int(l)), []).append(e)
            self._road_index = idx
        return self._road_index

    def save_npz(self, path):
        extra = {}
        if self.edge_rsl is not None:
            extra["edge_rsl"] = self.edge_rsl
        np.savez_compressed(path, nodes=self.nodes, edge_u=self.edge_u,
                            edge_v=self.edge_v, edge_length=self.edge_length,
                            edge_type=self.edge_type, **extra)

    @staticmethod
    def load_npz(path) -> "NavGraph":
        d = np.load(path)
        return NavGraph(nodes=d["nodes"], edge_u=d["edge_u"],
                        edge_v=d["edge_v"], edge_length=d["edge_length"],
                        edge_type=d["edge_type"],
                        edge_rsl=d["edge_rsl"] if "edge_rsl" in d else None)


class NavGraphBuilder:
    """Incremental builder deduplicating nodes by rounded position.

    The reference keys nodes by coordinates rounded to integers
    (path_planner.py:421-423 ``np.round(..., 0)``); later edges between the
    same rounded nodes override earlier ones' type (networkx add_edge
    semantics the reference depends on for junction straights,
    path_planner.py:303-306) -- replicated here.
    """

    def __init__(self, jaywalking_weight_factor: float = 2.0,
                 round_decimals: int = 0):
        self.jaywalking_weight_factor = jaywalking_weight_factor
        self.round_decimals = round_decimals
        self._id_map: dict[tuple, int] = {}
        self._nodes: list[np.ndarray] = []
        self._edges: dict[tuple[int, int], tuple[float, int]] = {}

    def node_id(self, xyz) -> int:
        xyz = np.asarray(xyz, np.float64)
        if xyz.shape[0] == 2:
            xyz = np.array([xyz[0], xyz[1], 0.0])
        key = tuple(np.round(xyz, self.round_decimals))
        if key not in self._id_map:
            self._id_map[key] = len(self._nodes)
            self._nodes.append(xyz)
        return self._id_map[key]

    def add_edge(self, a_xyz, b_xyz, edge_type: EdgeType,
                 length: float | None = None, rsl=None) -> None:
        """``rsl``: the entry waypoint's (road_id, section_id, lane_id) for
        the reference's road index (path_planner.py:479-487); None = off-map
        edge (indexed as -1/-1/-1)."""
        a, b = self.node_id(a_xyz), self.node_id(b_xyz)
        if a == b:
            return
        if length is None:
            length = float(np.linalg.norm(self._nodes[a] - self._nodes[b]))
        if edge_type in (EdgeType.JAYWALKING, EdgeType.JAYWALKING_JUNCTION):
            length = length * self.jaywalking_weight_factor
        key = (min(a, b), max(a, b))
        rsl = (-1, -1, -1) if rsl is None else tuple(int(x) for x in rsl)
        self._edges[key] = (length, int(edge_type), rsl)  # later edges override

    def add_polyline(self, points, edge_type: EdgeType, rsls=None) -> None:
        """``rsls``: per-sub-edge entry (road, section, lane), aligned with
        ``points[:-1]`` (or one tuple for the whole polyline)."""
        for i, (a, b) in enumerate(zip(points[:-1], points[1:])):
            if rsls is None:
                rsl = None
            elif isinstance(rsls, tuple):
                rsl = rsls
            else:
                rsl = rsls[i]
            self.add_edge(a, b, edge_type, rsl=rsl)

    def build(self) -> NavGraph:
        if not self._edges:
            raise ValueError("nav graph has no edges")
        keys = np.array(sorted(self._edges), np.int32)
        vals = [self._edges[tuple(k)] for k in keys]
        rsl = np.asarray([v[2] for v in vals], np.int64)
        return NavGraph(
            nodes=np.asarray(self._nodes, np.float64),
            edge_u=keys[:, 0].astype(np.int32),
            edge_v=keys[:, 1].astype(np.int32),
            edge_length=np.asarray([v[0] for v in vals], np.float64),
            edge_type=np.asarray([v[1] for v in vals], np.int32),
            edge_rsl=rsl if (rsl >= 0).any() else None,
        )
