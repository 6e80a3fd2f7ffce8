"""Navigation-graph construction from a CARLA map (bridge-only; a copy of
the JAX package's routing/carla_graph.py, float64 host code).

Re-implements the reference's pedestrian topology pipeline
(path_planner.py:174-562) on top of NavGraphBuilder:

* sidewalk waypoint chains along each road segment at ``waypoint_distance``
  spacing, collected left/right of the driving lanes (:210-240),
* junction corner edges (mid-corner waypoint) vs junction straight edges,
  plus corner-connection jaywalking edges with diagonal filtering (:242-344),
* crosswalk edges from ``map.get_crosswalks()`` with the 5/7-point cleanup,
  connected to nearby topology waypoints (:346-406),
* jaywalking edges to the opposite sidewalk with lane-id sign handling and
  sidewalk->shoulder connection edges (:503-562).

Every edge carries its entry waypoint's (road_id, section_id, lane_id), so
routing-time origin/destination snapping uses the reference's
road/section/lane edge index (path_planner.py:119-143) via
``make_waypoint_locator`` + ``PedPathPlanner(waypoint_locator=...)``.

The build-time opposite-sidewalk snap during jaywalking-edge generation also
uses the road index over the pre-jaywalking topology snapshot, skipping the
edge when the lookup can't resolve -- exactly the reference's
``_find_closest_node_id`` usage at :548-552.

The cached graphs carry the port's own name prefix (``cache.PORT_PREFIX``),
apart from the JAX package's entries for the same map.
"""
from __future__ import annotations

import itertools
import logging

import numpy as np

from ..env import cache
from .graph import EdgeType, NavGraph, NavGraphBuilder

log = logging.getLogger(__name__)


def _loc_xyz(waypoint):
    loc = waypoint.transform.location
    return np.array([loc.x, loc.y, loc.z])


def _rsl(waypoint):
    """Entry-waypoint OpenDRIVE coordinates for the road index
    (reference path_planner.py:479)."""
    return (waypoint.road_id, waypoint.section_id, waypoint.lane_id)


def make_waypoint_locator(carla_map):
    """Reference origin/destination snapping (path_planner.py:123-128):
    ``map.get_waypoint(loc, lane_type=Sidewalk)`` ->
    ``((road, section, lane), snapped_xyz)``."""
    import carla

    def locate(location):
        wp = carla_map.get_waypoint(
            carla.Location(float(location[0]), float(location[1]),
                           float(location[2]) if len(location) > 2 else 0.0),
            lane_type=carla.LaneType.Sidewalk)
        if wp is None:
            return None
        return _rsl(wp), _loc_xyz(wp)

    return locate


def build_carla_nav_graph(carla_map, waypoint_distance: float = 20.0,
                          jaywalking_weight_factor: float = 2.0,
                          cache_dir: str | None = None) -> NavGraph:
    """Build (or load from content-cache) the pedestrian NavGraph."""
    key = cache.content_key(carla_map.to_opendrive(), waypoint_distance,
                            jaywalking_weight_factor)
    town = carla_map.name.split("/")[-1]
    name = f"{cache.PORT_PREFIX}navgraph_{town}"
    cdir = cache_dir or cache.DEFAULT_CACHE_DIR
    hit = cache.load(name, key, cdir)
    if hit is not None and "edge_rsl" in hit:
        log.info("Using cached nav graph.")
        return NavGraph(nodes=hit["nodes"], edge_u=hit["edge_u"],
                        edge_v=hit["edge_v"], edge_length=hit["edge_length"],
                        edge_type=hit["edge_type"], edge_rsl=hit["edge_rsl"])

    graph = _build(carla_map, waypoint_distance, jaywalking_weight_factor)
    cache.store(name, key, {
        "nodes": graph.nodes, "edge_u": graph.edge_u, "edge_v": graph.edge_v,
        "edge_length": graph.edge_length, "edge_type": graph.edge_type,
        "edge_rsl": (graph.edge_rsl if graph.edge_rsl is not None
                     else np.full((graph.num_edges, 3), -1, np.int64))}, cdir)
    return graph


def _build(carla_map, waypoint_distance, jaywalking_weight_factor) -> NavGraph:
    import carla

    builder = NavGraphBuilder(jaywalking_weight_factor=jaywalking_weight_factor)
    topology = carla_map.get_topology()
    all_sidewalk_wps: list = []

    # --- sidewalk chains along road segments (:210-240) -------------------
    for segment in topology:
        wp_start = segment[0]
        segment_wps = [wp_start]
        if not wp_start.is_junction:
            segment_wps.extend(wp_start.next_until_lane_end(waypoint_distance))

        lanes_left: dict[int, list] = {}
        lanes_right: dict[int, list] = {}
        for w in segment_wps:
            lane = w.get_left_lane()
            while lane and lane.lane_type != carla.LaneType.Driving:
                if lane.lane_type == carla.LaneType.Sidewalk:
                    lanes_left.setdefault(lane.lane_id, []).append(lane)
                lane = lane.get_left_lane()
            lane = w.get_right_lane()
            while lane and lane.lane_type != carla.LaneType.Driving:
                if lane.lane_type == carla.LaneType.Sidewalk:
                    lanes_right.setdefault(lane.lane_id, []).append(lane)
                lane = lane.get_right_lane()
        for side in (lanes_left, lanes_right):
            for chain in side.values():
                pts = [_loc_xyz(w) for w in chain]
                builder.add_polyline(pts, EdgeType.SIDEWALK,
                                     rsls=[_rsl(w) for w in chain[:-1]])
                all_sidewalk_wps.extend(chain)

    # --- junction edges (:242-344) ----------------------------------------
    junctions, seen = [], set()
    for seg in topology:
        if seg[0].is_junction:
            j = seg[0].get_junction()
            if j.id not in seen:
                junctions.append(j)
                seen.add(j.id)

    for junction in junctions:
        corners = []
        straight_polylines = []
        for wp_start, wp_end in junction.get_waypoints(carla.LaneType.Sidewalk):
            is_corner = True
            lane = wp_start.get_left_lane()
            while lane and is_corner:
                if lane.lane_type == carla.LaneType.Driving:
                    is_corner = False
                lane = lane.get_left_lane()
            lane = wp_start.get_right_lane()
            while lane and is_corner:
                if lane.lane_type == carla.LaneType.Driving:
                    is_corner = False
                lane = lane.get_right_lane()

            if is_corner:
                chain = wp_start.next_until_lane_end(0.5)
                middle = chain[len(chain) // 2]
                builder.add_polyline(
                    [_loc_xyz(wp_start), _loc_xyz(middle), _loc_xyz(wp_end)],
                    EdgeType.SIDEWALK,
                    rsls=[_rsl(wp_start), _rsl(middle)])
                corners.append(middle)
                all_sidewalk_wps.extend([wp_start, middle, wp_end])
            else:
                wp_1 = wp_start.next(wp_start.lane_width)[0]
                wp_2 = wp_end.previous(wp_start.lane_width)[0]
                straight_polylines.append((
                    [_loc_xyz(wp_start), _loc_xyz(wp_1), _loc_xyz(wp_2),
                     _loc_xyz(wp_end)],
                    [_rsl(wp_start), _rsl(wp_1), _rsl(wp_2)]))
                corners.extend([wp_1, wp_2])
                all_sidewalk_wps.extend([wp_start, wp_1, wp_2, wp_end])

        # corner-connection jaywalking edges; for the typical 4-corner
        # junction keep only the 4 shortest (drop diagonals, :324-344)
        pairs = list(itertools.combinations(corners, 2))
        lengths = [np.linalg.norm(_loc_xyz(a) - _loc_xyz(b)) for a, b in pairs]
        if len(corners) == 4 and len(pairs) >= 4:
            keep = np.argpartition(lengths, 4)[:4]
            pairs = [pairs[i] for i in keep]
        for a, b in pairs:
            builder.add_edge(_loc_xyz(a), _loc_xyz(b),
                             EdgeType.JAYWALKING_JUNCTION, rsl=_rsl(a))
        # straights appended after corner connections so their SIDEWALK type
        # overrides the equivalent connection edge (:303-306)
        for pts, rsls in straight_polylines:
            builder.add_polyline(pts, EdgeType.SIDEWALK, rsls=rsls)

    # --- crosswalk edges (:346-406) ----------------------------------------
    crosswalk_corners = carla_map.get_crosswalks()
    filtered, current = [], []
    for point in crosswalk_corners:
        if point not in current:
            current.append(point)
        else:
            if len(current) == 4:
                filtered.extend(current)
            elif len(current) == 6:
                del current[4]
                del current[1]
                filtered.extend(current)
            current = []
    if filtered:
        pts = np.array([[p.x, p.y, p.z] for p in filtered]).reshape(-1, 2, 2, 3)
        for crosswalk in pts:
            ends = []
            for side in crosswalk:
                middle = (side[0] + side[1]) / 2.0
                wp = carla_map.get_waypoint(
                    carla.Location(float(middle[0]), float(middle[1]),
                                   float(middle[2])),
                    lane_type=carla.LaneType.Shoulder)
                if wp is not None:
                    ends.append(wp)
            if len(ends) == 2:
                # connection edges first, crosswalk edge after: the reference
                # extends ped_topology with connections then crosswalks
                # (:205-208), so on shared node pairs the CROSSWALK type wins
                for wp in ends:
                    loc = wp.transform.location
                    for n in all_sidewalk_wps:
                        if (n.road_id == wp.road_id
                                and loc.distance(n.transform.location) < 10.0):
                            builder.add_edge(_loc_xyz(wp), _loc_xyz(n),
                                             EdgeType.SIDEWALK, rsl=_rsl(wp))
                builder.add_edge(_loc_xyz(ends[0]), _loc_xyz(ends[1]),
                                 EdgeType.CROSSWALK, rsl=_rsl(ends[0]))

    # --- jaywalking edges to the opposite sidewalk (:503-562) ---------------
    # snapshot of the pre-jaywalking topology's road index, exactly what the
    # reference's _find_closest_node_id sees during this pass (:548-552)
    rsl_to_nodes: dict = {}
    for (a, b), (_, _, rsl) in builder._edges.items():
        if rsl != (-1, -1, -1):
            rsl_to_nodes.setdefault(rsl, []).append((a, b))
    node_positions = np.asarray(builder._nodes)

    def closest_node_via_index(location_xyz):
        loc = carla.Location(float(location_xyz[0]), float(location_xyz[1]),
                             float(location_xyz[2]))
        swp = carla_map.get_waypoint(loc, lane_type=carla.LaneType.Sidewalk)
        if swp is None:
            return None
        pairs = rsl_to_nodes.get(_rsl(swp))
        if not pairs:
            return None
        snapped = _loc_xyz(swp)
        best, best_d = None, np.inf
        for a, b in pairs:
            for n in (a, b):
                d = float(np.linalg.norm(node_positions[n] - snapped))
                if d < best_d:
                    best, best_d = n, d
        return best

    for wp in all_sidewalk_wps:
        if wp.lane_type != carla.LaneType.Sidewalk:
            continue
        opposite = _find_opposite_sidewalk(carla, wp)
        if opposite is None:
            continue
        # snap to the closest existing node via the road index; unresolvable
        # -> no jaywalking edge, as in the reference (:549-550 ``if
        # opposite_id:``)
        opposite_id = closest_node_via_index(_loc_xyz(opposite))
        if opposite_id is None:
            continue
        snapped = node_positions[opposite_id]
        shoulder = carla_map.get_waypoint(wp.transform.location,
                                          lane_type=carla.LaneType.Shoulder)
        opp_shoulder = carla_map.get_waypoint(
            carla.Location(float(snapped[0]), float(snapped[1]),
                           float(snapped[2])),
            lane_type=carla.LaneType.Shoulder)
        if shoulder is None or opp_shoulder is None:
            continue
        builder.add_edge(_loc_xyz(wp), _loc_xyz(shoulder),
                         EdgeType.SIDEWALK_TO_ROAD, rsl=_rsl(wp))
        builder.add_edge(snapped, _loc_xyz(opp_shoulder),
                         EdgeType.SIDEWALK_TO_ROAD, rsl=_rsl(opposite))
        builder.add_edge(_loc_xyz(shoulder), _loc_xyz(opp_shoulder),
                         EdgeType.JAYWALKING, rsl=_rsl(shoulder))

    return builder.build()


def _find_opposite_sidewalk(carla, wp):
    """Walk laterally across the road to the first sidewalk on the other
    side, handling the left/right flip at the lane-id sign change
    (reference :512-543)."""
    sign = np.sign(wp.lane_id)
    for first_dir in ("left", "right"):
        lane = (wp.get_left_lane() if first_dir == "left"
                else wp.get_right_lane())
        while lane is not None:
            if lane.lane_type == carla.LaneType.Sidewalk:
                return lane
            same_side = np.sign(lane.lane_id) == sign
            if first_dir == "left":
                lane = lane.get_left_lane() if same_side else lane.get_right_lane()
            else:
                lane = lane.get_right_lane() if same_side else lane.get_left_lane()
    return None
