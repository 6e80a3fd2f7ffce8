"""CARLA map-geometry extraction (bridge-only; ``import carla`` is lazy; a
copy of the JAX package's bridge/extract.py, float64 host code).

Re-implements the reference's map pipeline with identical semantics:
* sidewalk border extraction with the content-addressed cache
  (the reference's obstacles.py:12-173),
* static obstacle outlines from environment-object bounding boxes
  (obstacles.py:176-294, ellipse and rectangle modes, pole handling,
  bbox-center vs transform-location containment choice, z cutoff).

Outputs are plain numpy point lists consumed by env/ builders, so everything
downstream is CARLA-free.  The cache entries carry the port's own name
prefix (``cache.PORT_PREFIX``): the two packages never read, overwrite or
evict each other's entries in a shared cache directory.
"""
from __future__ import annotations

import itertools
import logging
import time

import numpy as np

from ..env import cache

log = logging.getLogger(__name__)


def extract_sidewalk(carla_map, resolution: float = 0.1,
                     cache_dir: str | None = None):
    """Sidewalk borders as point lists + section info, content-cached.

    Returns ``(border_lines, section_centers, section_lengths)``.
    """
    t0 = time.time()
    # "v2" bumps past caches that stored section meters under "lengths",
    # clobbering the ragged point-count index ragged_to_arrays needs
    key = cache.content_key(carla_map.to_opendrive(), resolution, "v2")
    town = carla_map.name.split("/")[-1]
    name = f"{cache.PORT_PREFIX}sidewalk_{town}"
    cdir = cache_dir or cache.DEFAULT_CACHE_DIR
    hit = cache.load(name, key, cdir)
    if hit is not None:
        log.info("Using cached sidewalk borders.")
        lines = cache.arrays_to_ragged(hit)
        centers = hit["centers"]
        lengths = hit["section_lengths"]
        return lines, list(centers), list(lengths)

    lines, centers, lengths = _extract_sidewalk_borders(carla_map, resolution)
    payload = cache.ragged_to_arrays(lines)
    payload["centers"] = np.asarray(centers, np.float64).reshape(-1, 2)
    payload["section_lengths"] = np.asarray(lengths, np.float64)
    payload["resolution"] = np.float64(resolution)
    cache.store(name, key, payload, cdir)
    log.info("Finished extracting sidewalks. Time: %s", time.time() - t0)
    return lines, centers, lengths


def _extract_sidewalk_borders(carla_map, resolution):
    """Topology walk (reference obstacles.py:72-166)."""
    import carla

    topology = [seg[0] for seg in carla_map.get_topology()]

    # junction sidewalks are separate (not attached to driving lanes)
    junctions, seen = [], set()
    for w in topology:
        if w.is_junction:
            j = w.get_junction()
            if j.id not in seen:
                junctions.append(j)
                seen.add(j.id)
    junction_waypoints = []
    for junction in junctions:
        pairs = junction.get_waypoints(carla.LaneType.Sidewalk)
        junction_waypoints.extend(p[0] for p in pairs)

    filtered, seen_wp = [], set()
    for w in topology:
        if not w.is_junction and w.id not in seen_wp:
            filtered.append(w)
            seen_wp.add(w.id)
    filtered.extend(junction_waypoints)

    lines, centers, lengths = [], [], []
    for waypoint in filtered:
        chain = [waypoint]
        nxt = waypoint.next(resolution)
        if nxt:
            nxt = nxt[0]
            while nxt.road_id == waypoint.road_id:
                chain.append(nxt)
                nxt = nxt.next(resolution)
                if nxt:
                    nxt = nxt[0]
                else:
                    break

        middle = chain[len(chain) // 2].transform.location
        section_center = np.array([middle.x, middle.y])
        section_length = len(chain) * resolution

        sidewalk_wps = []
        for w in chain:
            if w.lane_type == carla.LaneType.Sidewalk:
                sidewalk_wps.append(w)
            lane = w.get_left_lane()
            while lane and lane.lane_type != carla.LaneType.Driving:
                if lane.lane_type == carla.LaneType.Sidewalk:
                    sidewalk_wps.append(lane)
                lane = lane.get_left_lane()
            lane = w.get_right_lane()
            while lane and lane.lane_type != carla.LaneType.Driving:
                if lane.lane_type == carla.LaneType.Sidewalk:
                    sidewalk_wps.append(lane)
                lane = lane.get_right_lane()

        if sidewalk_wps:
            for sign in (-1.0, 1.0):
                pts = [_lateral_shift(w.transform, sign * w.lane_width * 0.5)
                       for w in sidewalk_wps]
                lines.append(np.asarray([[p.x, p.y] for p in pts]))
                centers.append(section_center)
                lengths.append(section_length)
    return lines, centers, lengths


def _lateral_shift(transform, shift):
    """Reference obstacles.py:169-173."""
    transform.rotation.yaw += 90
    transform.location.z = 0.5
    return transform.location + shift * transform.get_forward_vector()


def extract_obstacles(carla_world, resolution: float = 0.1,
                      ellipse_shape: bool = True,
                      max_obstacle_z_pos: float = 0.3):
    """Static obstacle outlines from environment objects
    (reference obstacles.py:176-266).  Returns ``(outlines, centers)``."""
    import carla

    env_objects = list(carla_world.get_environment_objects(
        carla.CityObjectLabel.Static))
    for label in (carla.CityObjectLabel.Poles, carla.CityObjectLabel.Walls,
                  carla.CityObjectLabel.Vehicles):
        env_objects.extend(carla_world.get_environment_objects(label))

    outlines, centers = [], []
    for o in env_objects:
        bb = o.bounding_box
        vertices = bb.get_local_vertices()[::2]
        if vertices[0].z > max_obstacle_z_pos:
            continue

        if ellipse_shape:
            tolerance = (bb.location - o.transform.location) * 0.1
            object_loc = o.transform.location + tolerance
            rot = carla.Rotation(-bb.rotation.pitch, -bb.rotation.yaw,
                                 -bb.rotation.roll)
            if (_bb_contains(bb, object_loc, carla.Transform(rotation=rot))
                    and o.type is not carla.CityObjectLabel.Walls):
                transform = o.transform
            else:
                loc = carla.Location(bb.location.x, bb.location.y, vertices[0].z)
                transform = carla.Transform(loc, bb.rotation)
            center = np.array([transform.location.x, transform.location.y])
            if o.type is carla.CityObjectLabel.Poles:
                ext = min(bb.extent.x, bb.extent.y)
                ext_x = ext_y = ext
            else:
                ext_x, ext_y = bb.extent.x, bb.extent.y
            pts = _carla_ellipse(transform, ext_x, ext_y, resolution)
        else:
            if len(vertices) != 4:
                continue
            segments, seg_lengths = [], []
            for a, b in itertools.combinations(vertices, 2):
                start = np.array([a.x, a.y])
                end = np.array([b.x, b.y])
                length = np.linalg.norm(end - start)
                seg_lengths.append(length)
                samples = max(2, int(length / resolution))
                segments.append(np.column_stack([
                    np.linspace(start[0], end[0], samples),
                    np.linspace(start[1], end[1], samples)]))
            idx = np.argpartition(seg_lengths, 4)[:4]
            pts = np.concatenate([segments[i] for i in idx], axis=0)
            center = np.array([bb.location.x, bb.location.y])

        outlines.append(np.asarray(pts, np.float64).reshape(-1, 2))
        centers.append(center)
    return outlines, centers


def _carla_ellipse(transform, extent_x, extent_y, resolution,
                   size_factor=float(np.sqrt(2.0))):
    """Reference obstacles.py:269-281 (world frame via the CARLA transform)."""
    import carla

    circumference = 2 * extent_x + 2 * extent_y
    samples = max(6, int(circumference / resolution))
    out = []
    for i in range(samples):
        theta = 2 * np.pi * i / samples
        loc = transform.transform(carla.Location(
            extent_x * np.cos(theta) * size_factor,
            extent_y * np.sin(theta) * size_factor, 0.0))
        out.append([loc.x, loc.y])
    return np.asarray(out)


def _bb_contains(bounding_box, location, transform):
    """Reference obstacles.py:284-294."""
    diff = bounding_box.location - location
    diff = transform.transform(diff)
    return (abs(diff.x) < bounding_box.extent.x
            and abs(diff.y) < bounding_box.extent.y
            and abs(diff.z) < bounding_box.extent.z)
