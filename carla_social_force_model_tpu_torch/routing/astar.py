"""A* path search over a NavGraph, host-side (port of routing/astar.py):
a native C++ core with a Python search of the same order.

The native core (``native/astar.cpp``, the JAX package's C ABI) is built
with g++ at first use by ``utils/nativelib.load`` into ``native/build/``
and loaded through ctypes; without a toolchain, or with
``use_native=False``, the router searches in Python.  The JAX package's
own fallback is a ``heapq`` search that finds paths of equal cost but
breaks ties between equal ``f`` values differently, and a street grid is
full of such ties (the horizontal leg of a route can run along any
sidewalk it passes): on the urban bundle's graph about one route in ten
differs.  The port's Python search follows the native core step for step
instead: the same open list (a binary heap ordered by ``f`` alone, pushed
and popped as libstdc++'s ``std::priority_queue`` does), the same
stale-entry test instead of a closed set, and the same squared-distance
nearest node.  So the native core and the Python search plan the same
routes, and both plan the JAX package's native routes.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np

from .graph import GraphType, NavGraph
from ..utils import nativelib

_CONFIGURED = False


def _load_native():
    """The native core's library with its ctypes signatures, or None
    without a toolchain."""
    global _CONFIGURED
    lib = nativelib.load("astar")
    if lib is None or _CONFIGURED:
        return lib
    _CONFIGURED = True
    lib.astar_graph_create.restype = ctypes.c_void_p
    lib.astar_graph_create.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)]
    lib.astar_graph_destroy.argtypes = [ctypes.c_void_p]
    lib.astar_route.restype = ctypes.c_int64
    lib.astar_route.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.astar_nearest_nodes.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)]
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


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
    """Routing engine over one NavGraph: the native core when
    ``use_native`` and it builds, else the Python search (the same
    routes)."""

    def __init__(self, graph: NavGraph, use_native: bool = True):
        self.graph = graph
        offsets, nbr, nbr_len, nbr_type = graph.csr()
        self._nodes = np.ascontiguousarray(graph.nodes, np.float64)
        self._subgraph_nodes = {}
        self._handle = None
        self._lib = _load_native() if use_native else None
        if self._lib is not None:
            # the core copies the arrays it is given
            self._handle = self._lib.astar_graph_create(
                graph.num_nodes, _ptr(self._nodes, ctypes.c_double),
                nbr.shape[0], _ptr(offsets, ctypes.c_int64),
                _ptr(nbr, ctypes.c_int32), _ptr(nbr_len, ctypes.c_double),
                _ptr(nbr_type, ctypes.c_int32))
        else:
            self._csr = (offsets.tolist(), nbr.tolist(), nbr_len.tolist(),
                         nbr_type.tolist())
            self._xyz = self._nodes.tolist()

    def __del__(self):
        if self._handle:
            self._lib.astar_graph_destroy(self._handle)

    @property
    def native(self) -> bool:
        """Whether the native core searches (else the Python search)."""
        return self._handle is not None

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
        if self.native:
            q = np.ascontiguousarray(loc[:3])
            m = np.ascontiguousarray(mask, np.uint8)
            out = np.zeros(1, np.int32)
            self._lib.astar_nearest_nodes(
                self._handle, _ptr(q, ctypes.c_double), 1,
                _ptr(m, ctypes.c_uint8), _ptr(out, ctypes.c_int32))
            return int(out[0])
        d = self._nodes - loc
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        d2[~mask] = np.inf
        return int(np.argmin(d2))

    def shortest_path(self, start: int, goal: int,
                      graph_type: GraphType) -> list[int]:
        """A* node path start..goal; empty list when unreachable."""
        allowed = self.graph.allowed_mask(graph_type)
        if self.native:
            cap = self.graph.num_nodes + 1
            out = np.zeros(cap, np.int32)
            n = self._lib.astar_route(self._handle, start, goal, allowed,
                                      _ptr(out, ctypes.c_int32), cap)
            if n < 0:
                raise RuntimeError("native astar_route failed")
            return out[:n].tolist()
        return self._python_astar(start, goal, allowed)

    def _h(self, a: int, b: int) -> float:
        pa, pb = self._xyz[a], self._xyz[b]
        dx, dy, dz = pa[0] - pb[0], pa[1] - pb[1], pa[2] - pb[2]
        return math.sqrt(dx * dx + dy * dy + dz * dz)

    def _python_astar(self, start: int, goal: int,
                      allowed: int) -> list[int]:
        """The native core's search in Python."""
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
