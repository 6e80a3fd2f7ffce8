"""Standalone visualization CLI (reference utils/draw_routing_graph.py role;
the port's copy of the JAX package's utils/viz_cli.py).

Subcommands:
  graph         render a NavGraph (.npz, or built live from a CARLA map)
                to a PNG, or draw it into a running CARLA world
  trajectories  render a simulation run's CSV output to a PNG
  animate       render a run's CSV output as a GIF/MP4 animation
                (mode-colored peds, trails, vehicle rectangles)
  metrics       crowd-analysis report (utils/metrics.py definitions) from a
                run's pedestrian.csv -- this framework's or the
                reference's (output_generator.py:32-51) -- as ONE JSON
                object: population/speed summaries, evacuation time,
                optional gate flow (--gate) and window density/fundamental-
                diagram samples (--region)

Examples:
  python -m carla_social_force_model_tpu_torch.utils.viz_cli graph \
      --npz cache/map_geometry/torch_navgraph_Town10HD_Opt_<hash>.npz --out graph.png
  python -m carla_social_force_model_tpu_torch.utils.viz_cli trajectories \
      --csv-dir output/20260816-061022-scenario --out run.png
"""
from __future__ import annotations

import argparse
import csv
import logging

import numpy as np

log = logging.getLogger(__name__)


def _csv_floats(label: str, n: int):
    """argparse type: exactly ``n`` comma-separated floats.

    Values starting with a negative number (e.g. ``-5,0,5,0``) look like an
    option to argparse -- use the ``--gate=X1,Y1,X2,Y2`` form for those.
    Malformed input raises a clean argparse error instead of a reshape
    traceback."""
    def parse(s: str):
        try:
            vals = tuple(float(v) for v in s.split(","))
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{label} must be {n} comma-separated numbers, got {s!r}")
        if len(vals) != n:
            raise argparse.ArgumentTypeError(
                f"{label} needs exactly {n} comma-separated numbers, "
                f"got {len(vals)} in {s!r}")
        return vals
    return parse


def _cmd_graph(args) -> int:
    from ..routing.graph import NavGraph
    if args.npz:
        graph = NavGraph.load_npz(args.npz)
    else:
        import carla  # noqa: F401  (availability check)
        from ..bridge.carla_world import CarlaWorld
        from ..routing.carla_graph import build_carla_nav_graph
        world = CarlaWorld(args.carla_host, args.carla_port,
                           {"map": {"map_name": args.map} if args.map else {}})
        graph = build_carla_nav_graph(world.carla_map,
                                      waypoint_distance=args.waypoint_distance,
                                      jaywalking_weight_factor=args.jaywalking_weight)
        if args.draw_in_world:
            _draw_graph_in_carla(graph, world)
            return 0
    from .visualize import plot_nav_graph
    out = plot_nav_graph(graph, args.out)
    log.info("wrote %s (%d nodes, %d edges)", out, graph.num_nodes,
             graph.num_edges)
    return 0


def _draw_graph_in_carla(graph, world, life_time: float = 60.0):
    """Debug-draw the graph edges into a CARLA world, color-coded by type
    (reference draw_routing_graph.py:116-161)."""
    import carla
    from .visualize import EDGE_COLORS
    from matplotlib.colors import to_rgb
    from ..routing.graph import EdgeType
    for u, v, t in zip(graph.edge_u, graph.edge_v, graph.edge_type):
        r, g, b = (int(c * 255) for c in to_rgb(EDGE_COLORS[EdgeType(int(t))]))
        a = graph.nodes[u]
        bnode = graph.nodes[v]
        world.world.debug.draw_line(
            carla.Location(float(a[0]), float(a[1]), float(a[2]) + 0.5),
            carla.Location(float(bnode[0]), float(bnode[1]), float(bnode[2]) + 0.5),
            thickness=0.08, color=carla.Color(r, g, b), life_time=life_time)


def _cmd_trajectories(args) -> int:
    import os
    peds: dict[int, list] = {}
    with open(os.path.join(args.csv_dir, "pedestrian.csv")) as f:
        for row in csv.DictReader(f):
            peds.setdefault(int(row["ped_id"]), []).append(
                (float(row["x"]), float(row["y"])))
    borders = []
    bpath = os.path.join(args.csv_dir, "borders.csv")
    if os.path.exists(bpath):
        with open(bpath) as f:
            borders = [(float(r["x"]), float(r["y"]))
                       for r in csv.DictReader(f)]

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 8))
    if borders:
        b = np.asarray(borders)
        ax.plot(b[:, 0], b[:, 1], ".", ms=1, color="0.4")
    cmap = plt.get_cmap("tab20")
    for ped_id, pts in sorted(peds.items()):
        p = np.asarray(pts)
        ax.plot(p[:, 0], p[:, 1], lw=1.0, color=cmap(ped_id % 20))
    ax.set_aspect("equal")
    ax.set_title(args.csv_dir)
    fig.savefig(args.out, dpi=130, bbox_inches="tight")
    log.info("wrote %s (%d pedestrians)", args.out, len(peds))
    return 0


def _records_from_csv(csv_dir: str):
    """Rebuild dense (T, N)-shaped record arrays from a run's CSV output
    (the reference schemas, output_generator.py:32-73) for animation."""
    import os
    from types import SimpleNamespace

    rows = []
    with open(os.path.join(csv_dir, "pedestrian.csv")) as f:
        for r in csv.DictReader(f):
            try:
                m = int(r["mode"])
            except ValueError:      # strict-parity runs write the enum text
                from ..models.modes import MODE_NAMES
                by_name = {v: k for k, v in MODE_NAMES.items()}
                m = by_name[r["mode"].split(".")[-1]]
            rows.append((int(r["ped_id"]), int(r["frame"]),
                         float(r["x"]), float(r["y"]), m))
    if not rows:
        raise SystemExit(f"no pedestrian rows in {csv_dir}/pedestrian.csv "
                         "(nothing to animate)")
    ids = sorted({r[0] for r in rows})
    id_slot = {p: i for i, p in enumerate(ids)}
    T = max(r[1] for r in rows) + 1
    pos = np.zeros((T, len(ids), 2), np.float32)
    alive = np.zeros((T, len(ids)), bool)
    mode = np.zeros((T, len(ids)), np.int8)
    for pid, fr, x, y, m in rows:
        s = id_slot[pid]
        pos[fr, s] = (x, y)
        alive[fr, s] = True
        mode[fr, s] = m
    recs = SimpleNamespace(pos=pos, alive=alive, mode=mode)

    veh = None
    vpath = os.path.join(csv_dir, "vehicle.csv")
    if os.path.exists(vpath):
        vrows = []
        with open(vpath) as f:
            for r in csv.DictReader(f):
                vrows.append((int(r["veh_id"]), int(r["frame"]), float(r["x"]),
                              float(r["y"]), float(r["heading"]),
                              float(r["ext_x"]), float(r["ext_y"])))
        if vrows:
            vids = sorted({r[0] for r in vrows})
            vslot = {v: i for i, v in enumerate(vids)}
            vT = max(T, max(r[1] for r in vrows) + 1)
            v_pos = np.zeros((vT, len(vids), 2), np.float32)
            v_head = np.zeros((vT, len(vids)), np.float32)
            v_act = np.zeros((vT, len(vids)), bool)
            v_ext = np.full((len(vids), 2), (2.4, 1.1), np.float32)
            for vid, fr, x, y, h, ex, ey in vrows:
                s = vslot[vid]
                v_pos[fr, s] = (x, y)
                v_head[fr, s] = h
                v_act[fr, s] = True
                v_ext[s] = (ex, ey)
            veh = SimpleNamespace(pos=v_pos[:T], heading=v_head[:T],
                                  active=v_act[:T], extents=v_ext)

    borders = []
    bpath = os.path.join(csv_dir, "borders.csv")
    if os.path.exists(bpath):
        with open(bpath) as f:
            pts = [(float(r["x"]), float(r["y"])) for r in csv.DictReader(f)]
        if pts:
            borders = [np.asarray(pts)]
    obstacles = []
    opath = os.path.join(csv_dir, "obstacles.csv")
    if os.path.exists(opath):
        with open(opath) as f:
            pts = [(float(r["x"]), float(r["y"])) for r in csv.DictReader(f)]
        if pts:
            obstacles = [np.asarray(pts)]
    return recs, veh, borders, obstacles


def _cmd_animate(args) -> int:
    from .visualize import animate_trajectories
    recs, veh, borders, obstacles = _records_from_csv(args.csv_dir)
    out = animate_trajectories(
        recs, args.out, border_lines=borders, obstacle_outlines=obstacles,
        vehicle_records=veh, dt=args.dt, stride=args.stride, fps=args.fps,
        trail=args.trail)
    log.info("wrote %s (%d frames, %d peds%s)", out,
             recs.pos.shape[0] // args.stride, recs.pos.shape[1],
             f", {veh.pos.shape[1]} vehicles" if veh is not None else "")
    return 0


def _cmd_metrics(args) -> int:
    import json
    import os
    from . import metrics
    from .csvout import read_pedestrian_csv

    rec, dt_est = read_pedestrian_csv(
        os.path.join(args.csv_dir, "pedestrian.csv"))
    dt = args.dt if args.dt is not None else (dt_est or 0.05)
    alive = np.asarray(rec.alive)
    speeds = metrics.mean_speed(rec)
    spd = np.linalg.norm(np.asarray(rec.vel), axis=-1)
    report = {
        "csv_dir": args.csv_dir,
        "dt": dt,
        "frames": int(alive.shape[0]),
        "duration_s": float(alive.shape[0] * dt),
        "pedestrians": int(alive.any(axis=0).sum()),
        "peak_population": int(alive.sum(axis=1).max(initial=0)),
        "mean_speed": (float(np.nanmean(speeds))
                       if np.isfinite(speeds).any() else None),
        "peak_speed": float(np.where(alive, spd, 0.0).max(initial=0.0)),
    }
    evac = metrics.evacuation_time(rec, dt)
    if np.isfinite(evac):
        report["evacuation_time_s"] = float(evac)
    if args.gate:
        a, b = np.asarray(args.gate, np.float64).reshape(2, 2)
        report["gate"] = {"a": list(a), "b": list(b),
                          **metrics.flow_rate(rec, a, b, dt)}
    if args.region:
        region = tuple(args.region)
        rho = metrics.region_density(rec, region)
        rv = metrics.mean_speed(rec, region)
        rho_c, v_m, counts = metrics.fundamental_diagram(rec, region, dt)
        report["region"] = {
            "bounds": list(region),
            "mean_density": float(rho.mean()),
            "peak_density": float(rho.max(initial=0.0)),
            "mean_speed": (float(np.nanmean(rv))
                           if np.isfinite(rv).any() else None),
            "fundamental_diagram": [
                {"density": float(r), "speed": float(v), "frames": int(c)}
                for r, v, c in zip(rho_c, v_m, counts) if np.isfinite(v)],
        }
    print(json.dumps(report, indent=2))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(format="%(levelname)s: %(message)s", level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("graph")
    g.add_argument("--npz", type=str, default=None)
    g.add_argument("--out", type=str, default="nav_graph.png")
    g.add_argument("--carla-host", default="127.0.0.1")
    g.add_argument("--carla-port", default=2000, type=int)
    g.add_argument("--map", type=str, default=None)
    g.add_argument("--waypoint-distance", type=float, default=10.0)
    g.add_argument("--jaywalking-weight", type=float, default=2.0)
    g.add_argument("--draw-in-world", action="store_true",
                   help="debug-draw into the CARLA world instead of a PNG")
    g.set_defaults(fn=_cmd_graph)

    t = sub.add_parser("trajectories")
    t.add_argument("--csv-dir", type=str, required=True)
    t.add_argument("--out", type=str, default="trajectories.png")
    t.set_defaults(fn=_cmd_trajectories)

    a = sub.add_parser("animate", help="render a run's CSV output as an "
                       "animation (gif, or mp4 with ffmpeg)")
    a.add_argument("--csv-dir", type=str, required=True)
    a.add_argument("--out", type=str, default="run.gif")
    a.add_argument("--dt", type=float, default=0.05)
    a.add_argument("--stride", type=int, default=2,
                   help="render every k-th recorded frame")
    a.add_argument("--fps", type=int, default=20)
    a.add_argument("--trail", type=int, default=40)
    a.set_defaults(fn=_cmd_animate)

    m = sub.add_parser("metrics", help="crowd-analysis JSON report from a "
                       "run's pedestrian.csv (flow, density, speeds, "
                       "evacuation)")
    m.add_argument("--csv-dir", type=str, required=True)
    m.add_argument("--dt", type=float, default=None,
                   help="override the dt estimated from the time column")
    m.add_argument("--gate", type=_csv_floats("--gate", 4), default=None,
                   metavar="X1,Y1,X2,Y2",
                   help="gate segment for flow/specific-flow (write "
                        "--gate=X1,Y1,X2,Y2 when X1 is negative)")
    m.add_argument("--region", type=_csv_floats("--region", 4), default=None,
                   metavar="XMIN,XMAX,YMIN,YMAX",
                   help="analysis window for density + fundamental diagram "
                        "(write --region=XMIN,... when XMIN is negative)")
    m.set_defaults(fn=_cmd_metrics)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
