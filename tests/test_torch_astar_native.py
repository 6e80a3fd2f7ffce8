"""PyTorch port: the native A* core (``native/astar.cpp``) against the
port's Python search and the JAX package's native router.

The port's ``AStarRouter`` searches with its own copy of the native core
(built with g++ at first use) and falls back to a Python search that
follows the core's order step for step: a binary heap on ``f`` alone
pushed and popped as libstdc++'s ``std::priority_queue`` does, the
stale-entry test, the first node of least squared distance.  So the two
give equal routes, ties included, and both give the JAX package's native
routes (whose own ``heapq`` fallback breaks ties otherwise,
``tests/test_torch_urban.py``).  The graphs: the urban bundle's street
grid, full of equal-cost ties, and the Town02 nav graph of the scenarios
(``configs/data/town2_navgraph.npz``).
"""
import os
import time

import numpy as np
import pytest

from carla_social_force_model_tpu.routing import astar as jastar
from carla_social_force_model_tpu.routing import graph as jgraph
from carla_social_force_model_tpu.utils import nativelib as jnativelib
from carla_social_force_model_tpu_torch.routing import astar
from carla_social_force_model_tpu_torch.routing.graph import (
    EdgeType, GraphType, NavGraph, NavGraphBuilder)
from carla_social_force_model_tpu_torch.utils import nativelib
from test_torch_urban import build_street_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOWN2 = os.path.join(REPO, "configs", "data", "town2_navgraph.npz")
#: seeded (start, goal) pairs per graph and graph type
PAIRS = 300


def _loaded(load):
    """``load()`` of a native library, retried while another test worker
    may still be building the JAX package's copy (which it writes in
    place); None when it never loads."""
    for _ in range(20):
        lib = load()
        if lib is not None:
            return lib
        jnativelib._CACHE.pop("astar", None)
        time.sleep(0.5)
    return None


@pytest.fixture(scope="module")
def routers_of():
    """``graph name -> (port native, port Python, JAX native)`` routers."""
    if _loaded(astar._load_native) is None:
        pytest.fail("the port's native A* core did not build (g++)")
    if _loaded(jastar._load_native) is None:
        pytest.fail("the JAX package's native A* core did not build (g++)")
    graphs = {
        "street_grid": (build_street_graph(NavGraphBuilder, EdgeType),
                        build_street_graph(jgraph.NavGraphBuilder,
                                           jgraph.EdgeType)),
        "town2": (NavGraph.load_npz(TOWN2),
                  jgraph.NavGraph.load_npz(TOWN2))}
    out = {}
    for name, (pg, jg) in graphs.items():
        native = astar.AStarRouter(pg)
        python = astar.AStarRouter(pg, use_native=False)
        jax_native = jastar.AStarRouter(jg, use_native=True)
        assert native.native and not python.native and jax_native.native
        out[name] = (native, python, jax_native)
    return out


@pytest.mark.parametrize("graph_type", list(GraphType), ids=lambda g: g.name)
@pytest.mark.parametrize("name", ["street_grid", "town2"])
def test_native_routes_equal_python_and_jax(routers_of, name, graph_type):
    """PAIRS seeded (start, goal) node pairs of the subgraph: the port's
    native core, its Python search and the JAX package's native core give
    the same node paths (unreachable pairs: all empty)."""
    native, python, jax_native = routers_of[name]
    nodes = np.nonzero(native.graph.nodes_in_subgraph(graph_type))[0]
    rng = np.random.default_rng([int(graph_type), len(nodes)])
    found = 0
    for a, b in rng.choice(nodes, size=(PAIRS, 2)):
        a, b = int(a), int(b)
        got = native.shortest_path(a, b, graph_type)
        assert got == python.shortest_path(a, b, graph_type), (a, b)
        assert got == jax_native.shortest_path(
            a, b, jgraph.GraphType(graph_type)), (a, b)
        found += bool(got)
    assert found > PAIRS // 2


@pytest.mark.parametrize("graph_type", list(GraphType), ids=lambda g: g.name)
@pytest.mark.parametrize("name", ["street_grid", "town2"])
def test_native_nearest_nodes_equal_python_and_jax(routers_of, name,
                                                   graph_type):
    """Seeded query points, 2-D and 3-D, among them every node's own
    position and the midpoints of edges (two nodes at the same distance:
    the first in node order wins): equal nearest nodes."""
    native, python, jax_native = routers_of[name]
    g = native.graph
    rng = np.random.default_rng(int(graph_type))
    lo, hi = g.nodes.min(axis=0) - 5.0, g.nodes.max(axis=0) + 5.0
    queries = [rng.uniform(lo, hi) for _ in range(PAIRS)]
    queries += [rng.uniform(lo[:2], hi[:2]) for _ in range(PAIRS // 3)]
    queries += list(g.nodes)
    queries += [0.5 * (g.nodes[u] + g.nodes[v])
                for u, v in zip(g.edge_u, g.edge_v)]
    for q in queries:
        got = native.nearest_node(q, graph_type)
        assert got == python.nearest_node(q, graph_type), q
        assert got == jax_native.nearest_node(
            q, jgraph.GraphType(graph_type)), q


def test_python_search_never_loads_the_library(monkeypatch):
    """``use_native=False`` builds and loads nothing: it routes with the
    Python search even where the library would build."""
    def refuse(name):
        raise AssertionError(f"nativelib.load({name!r}) was called")

    monkeypatch.setattr(nativelib, "load", refuse)
    router = astar.AStarRouter(NavGraph.load_npz(TOWN2), use_native=False)
    assert not router.native
    path = router.shortest_path(0, router.graph.num_nodes - 1,
                                GraphType.JAYWALKING)
    assert path and path[0] == 0
    assert router.nearest_node([0.0, 0.0], GraphType.JAYWALKING) >= 0
