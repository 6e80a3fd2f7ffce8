"""Offline visualization (headless equivalent of the reference's dev tools;
a copy of the JAX package's utils/visualize.py).

The reference draws the routing graph and debug geometry into the CARLA
world (utils/draw_routing_graph.py, carla_simulation.py:148-160); headless
we render matplotlib figures to files: the nav graph color-coded by edge
type, and scenario trajectories/geometry from a rollout or its CSV output.
matplotlib is imported inside each function: nothing on the card's host
imports it.  Records may hold tensors on any device or numpy arrays.
"""
from __future__ import annotations

import numpy as np

from ..routing.graph import EdgeType, NavGraph
from .metrics import _np as _host

EDGE_COLORS = {
    EdgeType.SIDEWALK: "tab:green",
    EdgeType.CROSSWALK: "tab:blue",
    EdgeType.JAYWALKING: "tab:red",
    EdgeType.JAYWALKING_JUNCTION: "tab:orange",
    EdgeType.SIDEWALK_TO_ROAD: "tab:purple",
    EdgeType.VOID: "gray",
}


def plot_nav_graph(graph: NavGraph, path: str, show_nodes: bool = True):
    """Render the routing graph color-coded by EdgeType (reference
    draw_routing_graph.py:116-161's color scheme intent)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 12))
    for etype in EdgeType:
        mask = graph.edge_type == int(etype)
        if not mask.any():
            continue
        segs = np.stack([graph.nodes[graph.edge_u[mask]][:, :2],
                         graph.nodes[graph.edge_v[mask]][:, :2]], axis=1)
        from matplotlib.collections import LineCollection
        ax.add_collection(LineCollection(
            segs, colors=EDGE_COLORS[etype], label=etype.name, linewidths=1.2))
    if show_nodes:
        ax.scatter(graph.nodes[:, 0], graph.nodes[:, 1], s=4, c="k", zorder=3)
    ax.autoscale()
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title("pedestrian navigation graph")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_trajectories(records, path: str, border_lines=(), obstacle_outlines=(),
                      dt: float = 0.05):
    """Render pedestrian trajectories (+ borders/obstacles) from a
    StepRecord pytree."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos = _host(records.pos)
    alive = _host(records.alive)
    fig, ax = plt.subplots(figsize=(10, 8))
    for border in border_lines:
        b = np.asarray(border)
        ax.plot(b[:, 0], b[:, 1], ".", ms=1, color="0.4")
    for outline in obstacle_outlines:
        o = np.asarray(outline)
        ax.plot(o[:, 0], o[:, 1], ".", ms=1, color="0.6")
    cmap = plt.get_cmap("tab20")
    for slot in range(pos.shape[1]):
        m = alive[:, slot]
        if not m.any():
            continue
        ax.plot(pos[m, slot, 0], pos[m, slot, 1], "-", lw=1.0,
                color=cmap(slot % 20))
    ax.set_aspect("equal")
    ax.set_title(f"trajectories ({pos.shape[0]} steps, dt={dt})")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path


def animate_trajectories(records, path: str, border_lines=(),
                         obstacle_outlines=(), vehicle_records=None,
                         vehicle_extents=None, dt: float = 0.05,
                         stride: int = 1, fps: int = 20,
                         trail: int = 40, view=None):
    """Render a rollout as an animation (GIF via Pillow, MP4 via ffmpeg if
    the extension asks for it).

    The headless live-viewer analogue of watching the run inside CARLA
    (the reference's only runtime visualization, SURVEY.md section 4
    "visual inspection"): pedestrian dots colored by mode, fading trails,
    borders/obstacle outlines, and optionally the vehicle fleet as
    heading-aligned rectangles (``vehicle_records`` = AutopilotRecord or
    any object with (T, V)-shaped ``pos/heading/active``; half-extents
    come from its ``extents`` attribute if present, else from the
    ``vehicle_extents`` (V, 2) argument, else the reference's default
    walker-vehicle 2.4 x 1.1 m).

    ``records``: StepRecord (or any pytree with (T, N, 2) ``pos``,
    (T, N) ``alive`` and optionally ``mode``).  ``stride`` subsamples
    frames; ``trail`` is the per-ped trail length in *recorded* frames;
    ``view`` fixes the axis bounds as ((x0, x1), (y0, y1)).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    pos = _host(records.pos)[::stride]
    alive = _host(records.alive)[::stride]
    mode = (_host(records.mode)[::stride]
            if getattr(records, "mode", None) is not None else
            np.zeros(alive.shape, np.int8))
    T = pos.shape[0]

    # mode colors follow the FSM (models/modes.py): IDLE, WALKING_SIDEWALK,
    # CROSSING_ROAD, ROAD_TO_SIDEWALK, CHECKING_TRAFFIC
    mode_colors = np.asarray([[0.5, 0.5, 0.5, 1.0],   # IDLE gray
                              [0.12, 0.47, 0.71, 1.0],  # WALKING blue
                              [0.84, 0.15, 0.16, 1.0],  # CROSSING red
                              [1.0, 0.5, 0.05, 1.0],   # ROAD_TO_SIDEWALK
                              [0.58, 0.4, 0.74, 1.0]])  # CHECKING purple

    fig, ax = plt.subplots(figsize=(9, 7))
    for pts, color in [(border_lines, "0.4"), (obstacle_outlines, "0.6")]:
        for line in pts:
            b = np.asarray(line)
            ax.plot(b[:, 0], b[:, 1], ".", ms=1, color=color, zorder=1)

    live = alive.any(axis=0)
    if view is None:
        p = pos[alive] if alive.any() else pos.reshape(-1, 2)
        lo, hi = p.min(axis=0) - 3.0, p.max(axis=0) + 3.0
    else:
        (lo_x, hi_x), (lo_y, hi_y) = view
        lo, hi = np.asarray([lo_x, lo_y]), np.asarray([hi_x, hi_y])
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_aspect("equal")

    scat = ax.scatter([], [], s=26, zorder=4)
    trails = [ax.plot([], [], "-", lw=0.8, alpha=0.5,
                      color="0.3", zorder=2)[0]
              for _ in range(int(live.sum()))]
    slot_of_trail = np.flatnonzero(live)
    title = ax.set_title("")

    veh_patches = []
    if vehicle_records is not None:
        from matplotlib.patches import Rectangle
        v_pos = _host(vehicle_records.pos)[::stride]
        v_head = _host(vehicle_records.heading)[::stride]
        v_act = _host(vehicle_records.active)[::stride]
        ext = getattr(vehicle_records, "extents", None)
        if ext is None:
            ext = vehicle_extents
        v_ext = (_host(ext) if ext is not None
                 else np.full((v_pos.shape[1], 2), (2.4, 1.1)))
        for v in range(v_pos.shape[1]):
            ex, ey = float(v_ext[v, 0]), float(v_ext[v, 1])
            r = Rectangle((0, 0), 2 * ex, 2 * ey, facecolor="tab:olive",
                          edgecolor="k", lw=0.5, zorder=3, visible=False)
            ax.add_patch(r)
            veh_patches.append((r, ex, ey))

    def draw(t):
        m = alive[t]
        scat.set_offsets(pos[t][m] if m.any() else np.empty((0, 2)))
        scat.set_facecolor(mode_colors[np.clip(mode[t][m], 0, 4)]
                           if m.any() else np.empty((0, 4)))
        t0 = max(0, t - trail)
        for line, slot in zip(trails, slot_of_trail):
            seg = alive[t0:t + 1, slot]
            line.set_data(pos[t0:t + 1, slot, 0][seg],
                          pos[t0:t + 1, slot, 1][seg])
        if vehicle_records is not None:
            import matplotlib.transforms as mtrans
            for v, (r, ex, ey) in enumerate(veh_patches):
                if not v_act[t, v]:
                    r.set_visible(False)
                    continue
                r.set_visible(True)
                cx, cy = v_pos[t, v]
                tr = (mtrans.Affine2D()
                      .translate(-ex, -ey)
                      .rotate(float(v_head[t, v]))
                      .translate(float(cx), float(cy)))
                r.set_transform(tr + ax.transData)
        title.set_text(f"t = {t * stride * dt:6.2f} s   "
                       f"alive = {int(m.sum())}")
        return [scat, title, *trails, *(p for p, _, _ in veh_patches)]

    anim = animation.FuncAnimation(fig, draw, frames=T, blit=False)
    if path.endswith(".mp4"):
        writer = animation.FFMpegWriter(fps=fps)
    else:
        writer = animation.PillowWriter(fps=fps)
    anim.save(path, writer=writer)
    plt.close(fig)
    return path
