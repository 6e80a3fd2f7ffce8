// Native A* router over the pedestrian navigation graph.
//
// Routing is host-side and latency-sensitive when thousands of random
// pedestrians request routes (the reference's pedestrian_spawner.py:106-124,
// whose planner runs networkx's astar_path, path_planner.py:113), so the
// search core is C++ over the CSR arrays of routing/graph.py.  Exposed
// through a minimal C ABI consumed via ctypes (routing/astar.py, which
// falls back to a Python search of the same order without a toolchain).
// The same ABI and search order as the JAX package's native/astar.cpp:
// a binary heap ordered by f alone (std::priority_queue), a stale-entry
// test instead of a closed set, and the first node of least squared
// distance as the nearest node.
//
// Edge filtering: `allowed_mask` is a bitmask over edge types with bit index
// (type + 1), matching NavGraph.allowed_mask.
#include <cstdint>
#include <cmath>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Graph {
  int64_t num_nodes;
  std::vector<double> nodes;      // (V, 3)
  std::vector<int64_t> offsets;   // (V + 1)
  std::vector<int32_t> nbr;       // (2E,)
  std::vector<double> nbr_len;    // (2E,)
  std::vector<int32_t> nbr_type;  // (2E,)
};

struct QueueItem {
  double f;
  int32_t node;
  bool operator>(const QueueItem& o) const { return f > o.f; }
};

inline double heuristic(const Graph& g, int32_t a, int32_t b) {
  const double* pa = &g.nodes[3 * a];
  const double* pb = &g.nodes[3 * b];
  const double dx = pa[0] - pb[0], dy = pa[1] - pb[1], dz = pa[2] - pb[2];
  return std::sqrt(dx * dx + dy * dy + dz * dz);
}

}  // namespace

extern "C" {

void* astar_graph_create(int64_t num_nodes, const double* nodes,
                         int64_t adj_size, const int64_t* offsets,
                         const int32_t* nbr, const double* nbr_len,
                         const int32_t* nbr_type) {
  auto* g = new Graph();
  g->num_nodes = num_nodes;
  g->nodes.assign(nodes, nodes + 3 * num_nodes);
  g->offsets.assign(offsets, offsets + num_nodes + 1);
  g->nbr.assign(nbr, nbr + adj_size);
  g->nbr_len.assign(nbr_len, nbr_len + adj_size);
  g->nbr_type.assign(nbr_type, nbr_type + adj_size);
  return g;
}

void astar_graph_destroy(void* handle) { delete static_cast<Graph*>(handle); }

// Returns path length (#nodes) written into out_path (capacity out_cap),
// 0 if unreachable, -1 on error.  Path is start..goal inclusive.
int64_t astar_route(void* handle, int32_t start, int32_t goal,
                    uint32_t allowed_mask, int32_t* out_path,
                    int64_t out_cap) {
  const Graph& g = *static_cast<Graph*>(handle);
  if (start < 0 || goal < 0 || start >= g.num_nodes || goal >= g.num_nodes)
    return -1;
  const double kInf = 1e300;
  std::vector<double> dist(g.num_nodes, kInf);
  std::vector<int32_t> prev(g.num_nodes, -1);
  std::priority_queue<QueueItem, std::vector<QueueItem>, std::greater<QueueItem>>
      open;
  dist[start] = 0.0;
  open.push({heuristic(g, start, goal), start});
  while (!open.empty()) {
    const QueueItem item = open.top();
    open.pop();
    const int32_t u = item.node;
    if (u == goal) break;
    if (item.f > dist[u] + heuristic(g, u, goal) + 1e-12) continue;  // stale
    for (int64_t i = g.offsets[u]; i < g.offsets[u + 1]; ++i) {
      const int32_t type_bit = g.nbr_type[i] + 1;
      if (!((allowed_mask >> type_bit) & 1u)) continue;
      const int32_t v = g.nbr[i];
      const double nd = dist[u] + g.nbr_len[i];
      if (nd < dist[v]) {
        dist[v] = nd;
        prev[v] = u;
        open.push({nd + heuristic(g, v, goal), v});
      }
    }
  }
  if (dist[goal] >= kInf) return 0;
  // reconstruct
  std::vector<int32_t> rev;
  for (int32_t n = goal; n != -1; n = prev[n]) rev.push_back(n);
  const int64_t len = static_cast<int64_t>(rev.size());
  if (len > out_cap) return -1;
  for (int64_t i = 0; i < len; ++i) out_path[i] = rev[len - 1 - i];
  return len;
}

// Batched nearest-node query (euclidean, optionally restricted by node mask).
void astar_nearest_nodes(void* handle, const double* queries, int64_t num_q,
                         const uint8_t* node_mask, int32_t* out_ids) {
  const Graph& g = *static_cast<Graph*>(handle);
  for (int64_t q = 0; q < num_q; ++q) {
    const double* p = &queries[3 * q];
    double best = 1e300;
    int32_t best_id = -1;
    for (int64_t n = 0; n < g.num_nodes; ++n) {
      if (node_mask && !node_mask[n]) continue;
      const double dx = g.nodes[3 * n] - p[0];
      const double dy = g.nodes[3 * n + 1] - p[1];
      const double dz = g.nodes[3 * n + 2] - p[2];
      const double d = dx * dx + dy * dy + dz * dz;
      if (d < best) {
        best = d;
        best_id = static_cast<int32_t>(n);
      }
    }
    out_ids[q] = best_id;
  }
}

}  // extern "C"
