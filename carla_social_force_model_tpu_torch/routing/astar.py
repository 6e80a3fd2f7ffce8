"""A* path search over a NavGraph, host-side (port of routing/astar.py).

The JAX package searches with a native C++ core (native/astar.cpp, built
with g++ at first use) and falls back to a ``heapq`` search without a
toolchain.  The two find paths of equal cost but break ties between equal
``f`` values differently, and a street grid is full of such ties (the
horizontal leg of a route can run along any sidewalk it passes): on the
urban bundle's graph about one route in ten differs.  This router follows
the native core step for step, in Python: the same open list (a binary
heap ordered by ``f`` alone, pushed and popped as libstdc++'s
``std::priority_queue`` does), the same stale-entry test instead of a
closed set, and the same squared-distance nearest node, so the port plans
the routes the JAX package plans wherever its native core builds.  A native
core of the port's own belongs to the scenario slice.
"""
from __future__ import annotations

import math

import numpy as np

from .graph import GraphType, NavGraph


def _sift_up(heap, hole, top, item):
    """libstdc++ ``__push_heap`` for a min-heap on ``f``: move ``item`` up
    from ``hole`` while its parent's ``f`` is larger."""
    parent = (hole - 1) // 2
    while hole > top and heap[parent][0] > item[0]:
        heap[hole] = heap[parent]
        hole = parent
        parent = (hole - 1) // 2
    heap[hole] = item


def _heap_push(heap, item):
    """``std::priority_queue<..., std::greater>::push``."""
    heap.append(item)
    _sift_up(heap, len(heap) - 1, 0, item)


def _heap_pop(heap):
    """``std::priority_queue<..., std::greater>::pop`` (libstdc++'s
    ``__pop_heap`` and ``__adjust_heap``); returns the former top."""
    top = heap[0]
    last = heap.pop()
    n = len(heap)
    if n == 0:
        return top
    hole, child = 0, 0
    while child < (n - 1) // 2:
        child = 2 * (child + 1)
        if heap[child][0] > heap[child - 1][0]:
            child -= 1
        heap[hole] = heap[child]
        hole = child
    if n % 2 == 0 and child == (n - 2) // 2:
        child = 2 * (child + 1)
        heap[hole] = heap[child - 1]
        hole = child - 1
    _sift_up(heap, hole, 0, last)
    return top


class AStarRouter:
    """Routing engine over one NavGraph (the native core's search order)."""

    def __init__(self, graph: NavGraph):
        self.graph = graph
        offsets, nbr, nbr_len, nbr_type = graph.csr()
        self._csr = (offsets.tolist(), nbr.tolist(), nbr_len.tolist(),
                     nbr_type.tolist())
        self._nodes = np.ascontiguousarray(graph.nodes, np.float64)
        self._xyz = self._nodes.tolist()
        self._subgraph_nodes = {}

    def nearest_node(self, location, graph_type: GraphType) -> int:
        """Closest node among those the subgraph reaches: the first one of
        least squared distance, in node order."""
        if graph_type not in self._subgraph_nodes:
            self._subgraph_nodes[graph_type] = \
                self.graph.nodes_in_subgraph(graph_type)
        mask = self._subgraph_nodes[graph_type]
        loc = np.asarray(location, np.float64).reshape(-1)
        if loc.shape[0] == 2:
            loc = np.r_[loc, 0.0]
        d = self._nodes - loc
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        d2[~mask] = np.inf
        return int(np.argmin(d2))

    def _h(self, a: int, b: int) -> float:
        pa, pb = self._xyz[a], self._xyz[b]
        dx, dy, dz = pa[0] - pb[0], pa[1] - pb[1], pa[2] - pb[2]
        return math.sqrt(dx * dx + dy * dy + dz * dz)

    def shortest_path(self, start: int, goal: int,
                      graph_type: GraphType) -> list[int]:
        """A* node path start..goal; empty list when unreachable."""
        allowed = self.graph.allowed_mask(graph_type)
        offsets, nbr, nbr_len, nbr_type = self._csr
        inf = 1e300
        dist = [inf] * self.graph.num_nodes
        prev = [-1] * self.graph.num_nodes
        dist[start] = 0.0
        heap = [(self._h(start, goal), start)]
        while heap:
            f, u = _heap_pop(heap)
            if u == goal:
                break
            if f > dist[u] + self._h(u, goal) + 1e-12:
                continue  # stale entry
            for i in range(offsets[u], offsets[u + 1]):
                if not (allowed >> (nbr_type[i] + 1)) & 1:
                    continue
                v = nbr[i]
                nd = dist[u] + nbr_len[i]
                if nd < dist[v]:
                    dist[v] = nd
                    prev[v] = u
                    _heap_push(heap, (nd + self._h(v, goal), v))
        if dist[goal] >= inf:
            return []
        path = [goal]
        while prev[path[-1]] != -1:
            path.append(prev[path[-1]])
        return path[::-1]
