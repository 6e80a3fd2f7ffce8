"""PyTorch port: the ORCA velocity law against the JAX package.

The half-planes, the two linear programs, the neighbour band, the vehicle
and wall constraints and ``orca_velocities`` (``ops/orca.py``), the ORCA
block of the step (``models/stepper.py``) and its guarantees.  Inputs are
drawn with numpy from a seed and fed to both packages; the JAX side runs
its jnp path (the ORCA law is plain jnp there; its wall feed runs the jnp
fallback on the CPU, and the analytic border kernels in interpret mode),
and the float64 oracles of tests/oracle_orca.py check the geometry and the
programs.

Tolerances.  Against the JAX package, 1e-5 on velocities (a few ulps of
the candidates' arithmetic, tests/test_orca.py's bound for two solves of
the same program) and, stepping from the JAX package's own state, 3e-5 m
on positions per step (tests/test_orca.py's 2e-5 to 3e-5 m).  Both pick
the same candidate of the program: a flip would move a velocity by far
more.  The one exception is a row whose program is infeasible: the minimax
fallback's optimum can be a segment, and planes that differ by ulps (the
JAX package's CPU arithmetic contracts multiply-adds, PyTorch's does not)
may select different points of it; such a row is held to the same minimax
value (:class:`FallbackRows`).  Against the oracles, tests/test_orca.py's
own bounds.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle_orca
from carla_social_force_model_tpu.api import synthetic as jsyn
from carla_social_force_model_tpu.env import borders as jborders
from carla_social_force_model_tpu.env import pointsets as jps
from carla_social_force_model_tpu.models import autopilot as jap
from carla_social_force_model_tpu.models import spawn as jspawn
from carla_social_force_model_tpu.models import stepper as jstepper
from carla_social_force_model_tpu.models import vehicles as jvehicles
from carla_social_force_model_tpu.models.params import (
    OrcaParams as JaxOrcaParams, SfmParams as JaxSfmParams)
from carla_social_force_model_tpu.models.spawn import (SpawnerSpec,
                                                       build_spawn_schedule)
from carla_social_force_model_tpu.ops import orca as jorca
from carla_social_force_model_tpu_torch.api import synthetic as psyn
from carla_social_force_model_tpu_torch.env import borders as pborders
from carla_social_force_model_tpu_torch.env import pointsets as pps
from carla_social_force_model_tpu_torch.models import modes, stepper
from carla_social_force_model_tpu_torch.models import vehicles as pvehicles
from carla_social_force_model_tpu_torch.models.params import OrcaParams
from carla_social_force_model_tpu_torch.models.spawn import LAW_IDS
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.ops import orca
from carla_social_force_model_tpu_torch.ops.spatial import morton_order
from carla_social_force_model_tpu_torch.utils import convert

CPU = "cpu"
DT = 0.05
#: velocities against the JAX package
VEL_TOL = 1e-5
#: positions per step from the JAX package's own state
POS_TOL_M = 3e-5
#: the same with power-law agents in the crowd (tests/test_torch_families.py)
POWERLAW_POS_TOL_M = 1e-4


def fields_of(obj):
    """A JAX-package dataclass as nested dicts of numpy arrays and Python
    values (what utils/convert.py takes)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(np.ascontiguousarray(a))


def assert_close(got, want, tol=VEL_TOL, mask=None):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        if mask is not None:
            g, w = g[..., mask], w[..., mask]
        assert np.isfinite(g).all()
        err = np.abs(g - w)
        assert err.max(initial=0.0) <= tol, err.max()


# -- the half-plane --------------------------------------------------------------

def test_halfplane_equals_jax_and_oracle():
    """Seeded pairs, colliding ones and coincident ones among them: the
    port's half-planes against the JAX package's, and against the sampled
    velocity-obstacle boundary of tests/oracle_orca.py (the checks of
    tests/test_orca.py)."""
    rng = np.random.default_rng(0)
    m = 400
    d = rng.uniform(0.0, 10.0, m)
    ang = rng.uniform(0, 2 * np.pi, m)
    p = np.stack([d * np.cos(ang), d * np.sin(ang)]).astype(np.float32)
    rv = rng.uniform(-3, 3, (2, m)).astype(np.float32)
    r = rng.uniform(0.3, 1.2, m).astype(np.float32)
    p[:, :3] = 0.0
    rv[:, 1] = 0.0
    got = orca.orca_halfplane(t(p[0]), t(p[1]), t(rv[0]), t(rv[1]), t(r),
                              2.0, DT)
    want = jorca.orca_halfplane(j(p[0]), j(p[1]), j(rv[0]), j(rv[1]), j(r),
                                2.0, DT)
    assert_close(got, want, tol=2e-5 * 25)   # |u| reaches r/dt = 24 m/s
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
    u = np.stack([got[0].numpy(), got[1].numpy()], 1).astype(np.float64)
    n = np.stack([got[2].numpy(), got[3].numpy()], 1).astype(np.float64)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
    for i in range(3, 43):
        pi, rvi, ri = p[:, i].astype(float), rv[:, i].astype(float), float(r[i])
        u_o, n_o = oracle_orca.vo_closest_boundary(pi, rvi, ri, 2.0, DT)
        if np.linalg.norm(pi) <= ri:
            np.testing.assert_allclose(u[i], u_o, atol=1e-3)
            assert n[i] @ n_o > 0.999
            continue
        scale = max(1.0, np.linalg.norm(rvi), np.linalg.norm(pi))
        assert np.linalg.norm(u[i]) <= np.linalg.norm(u_o) + 2e-3 * scale
        eps = 1e-3 * scale
        assert not oracle_orca.in_vo(rvi + u[i] + eps * n[i], pi, ri, 2.0)
        assert oracle_orca.in_vo(rvi + u[i] - eps * n[i], pi, ri * (1 + 1e-9),
                                 2.0)


# -- the linear programs ---------------------------------------------------------

def random_programs(rng, rows, c, infeasible_share=0.3):
    """Seeded constraint sets: ``c`` planes per row, some invalid; a share
    of the rows made infeasible by planes far out along spread normals."""
    ang = rng.uniform(0, 2 * np.pi, (rows, c))
    nx, ny = np.cos(ang), np.sin(ang)
    ptx = rng.uniform(-1.5, 1.5, (rows, c))
    pty = rng.uniform(-1.5, 1.5, (rows, c))
    bad = rng.uniform(size=rows) < infeasible_share
    ptx[bad] = 2.5 * nx[bad] + rng.uniform(-0.5, 0.5, (int(bad.sum()), c))
    pty[bad] = 2.5 * ny[bad] + rng.uniform(-0.5, 0.5, (int(bad.sum()), c))
    valid = rng.random((rows, c)) < 0.8
    valid[bad] = True
    pref = rng.uniform(-2.5, 2.5, (2, rows))
    vmax = rng.uniform(1.5, 2.5, rows)
    f32 = np.float32
    return (pref[0].astype(f32), pref[1].astype(f32), ptx.astype(f32),
            pty.astype(f32), nx.astype(f32), ny.astype(f32), valid,
            vmax.astype(f32))


@pytest.mark.parametrize("c", [1, 6, 20])
def test_lp2_equals_jax_and_grid(c):
    """The projection program over 300 rows: the same velocity and
    feasibility as the JAX package, and no worse than the grid oracle
    where the grid can be trusted."""
    rng = np.random.default_rng(c)
    prog = random_programs(rng, 300, c)
    got = orca.solve_lp2(*(t(a) for a in prog))
    want = jorca.solve_lp2(*(j(a) for a in prog))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert_close(got[:2], want[:2])
    feas = got[2].numpy()
    assert feas.any() and (~feas).any()
    pref_x, pref_y, ptx, pty, nx, ny, valid, vmax = prog
    checked = 0
    for i in range(40):
        grid = oracle_orca.lp_grid(
            (pref_x[i], pref_y[i]), list(zip(ptx[i], pty[i])),
            list(zip(nx[i], ny[i])), valid[i], float(vmax[i]), res=401)
        cell = 2 * vmax[i] / 400
        if not grid["feasible"] or grid["minimax_m"] < 2 * cell:
            continue
        checked += 1
        assert feas[i]
        v = np.array([got[0][i].item(), got[1][i].item()])
        clear = (v[0] - ptx[i]) * nx[i] + (v[1] - pty[i]) * ny[i]
        assert clear[valid[i]].min(initial=np.inf) >= -1e-3
        assert np.linalg.norm(v - (pref_x[i], pref_y[i])) \
            <= grid["best_dist"] + 2 * cell
    # twenty random planes rarely leave a region wide enough for the grid
    assert checked >= (5 if c <= 6 else 0)


@pytest.mark.parametrize("c", [2, 5, 20])
def test_lp3_equals_jax_and_grid(c):
    """The minimax fallback on the same rows: the same velocity as the JAX
    package, and at least the grid oracle's least clearance on the
    infeasible rows."""
    rng = np.random.default_rng(10 + c)
    prog = random_programs(rng, 200, c, infeasible_share=0.6)
    got = orca.solve_lp3(*(t(a) for a in prog[2:]))
    want = jorca.solve_lp3(*(j(a) for a in prog[2:]))
    assert_close(got, want)
    _, _, ptx, pty, nx, ny, valid, vmax = prog
    checked = 0
    for i in range(60):
        grid = oracle_orca.lp_grid(np.zeros(2), list(zip(ptx[i], pty[i])),
                                   list(zip(nx[i], ny[i])), valid[i],
                                   float(vmax[i]), res=401)
        cell = 2 * vmax[i] / 400
        if grid["feasible"] or grid["minimax_m"] > -2 * cell:
            continue
        checked += 1
        v = np.array([got[0][i].item(), got[1][i].item()])
        m = (((v[0] - ptx[i]) * nx[i] + (v[1] - pty[i]) * ny[i])[valid[i]]
             ).min()
        assert np.linalg.norm(v) <= vmax[i] * (1 + 1e-4) + 1e-3
        assert m >= grid["minimax_m"] - 2.5 * cell
    assert checked >= 3


def test_solve_orca_lp_runs_the_fallback_on_the_infeasible_rows_only(
        monkeypatch):
    """The JAX package solves the fallback on every row under one
    ``lax.cond``; the port on the infeasible rows only.  The rows are
    independent, so the velocities are the JAX package's."""
    rng = np.random.default_rng(5)
    prog = random_programs(rng, 256, 8)
    seen = []
    real = orca.solve_lp3

    def spy(ptx, *args):
        seen.append(ptx.shape[0])
        return real(ptx, *args)

    monkeypatch.setattr(orca, "solve_lp3", spy)
    got = orca.solve_orca_lp(*(t(a) for a in prog))
    want = jorca.solve_orca_lp(*(j(a) for a in prog))
    assert_close(got, want)
    n_bad = int((~orca.solve_lp2(*(t(a) for a in prog))[2]).sum())
    assert seen == [n_bad] and 0 < n_bad < 256
    feasible_only = tuple(t(a[:1]) for a in prog)
    seen.clear()
    if bool(orca.solve_lp2(*feasible_only)[2].all()):
        orca.solve_orca_lp(*feasible_only)
        assert seen == []


def test_lp_row_blocks_change_nothing(monkeypatch):
    rng = np.random.default_rng(6)
    prog = tuple(t(a) for a in random_programs(rng, 64, 6))
    whole = orca.solve_lp2(*prog)
    monkeypatch.setattr(orca, "LP_BLOCK_ELEMS", 500)
    blocked = orca.solve_lp2(*prog)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


# -- neighbours -----------------------------------------------------------------

def crowd(n, seed, extent, dead=0.1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.25, 0.35, n).astype(np.float32)
    alive = rng.uniform(size=n) >= dead
    return pos, vel, radius, alive


def test_window_neighbors_equal_jax():
    """The band of the sorted order (circular, offsets -32..-1, 1..32) and
    the k nearest alive within neighbor_dist: the same neighbours in the
    same slots, ties to the lower band position."""
    pos, vel, radius, alive = crowd(300, 1, 12.0)
    pos[5] = pos[4]                     # a coincident pair
    pos[7:11] = pos[6] + np.float32(1.0)  # equal distances: slot order
    perm, _ = morton_order(t(pos[:, 0]), t(pos[:, 1]), t(alive), "hilbert")
    sp = [a[perm.numpy()] for a in (pos[:, 0], pos[:, 1], vel[:, 0],
                                    vel[:, 1], radius, alive)]
    for window, k in ((64, 10), (16, 4), (8, 10)):
        got = orca._window_neighbors(*(t(a) for a in sp), window, k, 4.0)
        want = jorca._window_neighbors(*(j(a) for a in sp), window, k, 4.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_full_neighbors_equal_jax():
    pos, vel, radius, alive = crowd(90, 2, 6.0)
    pos[3] = pos[2]
    for k in (4, 10, 120):
        got = orca._full_neighbors(*(t(a) for a in (
            pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], radius, alive)), k,
            5.0)
        want = jorca._full_neighbors(*(j(a) for a in (
            pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], radius, alive)), k,
            5.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- orca_velocities --------------------------------------------------------------

def walls():
    """Street walls and a pair of parked cars, from both packages."""
    lines, centers, lengths = [], [], []
    for a, b in (((-12.0, 3.0), (12.0, 3.0)), ((-12.0, -3.0), (12.0, -3.0)),
                 ((4.0, -12.0), (4.0, 12.0))):
        psyn._wall_sections(lines, centers, lengths, a, b, 10.0)
    from carla_social_force_model_tpu.env.obstacles_gen import (
        build_obstacle_set as jobst)
    from carla_social_force_model_tpu_torch.env.obstacles_gen import (
        build_obstacle_set as pobst, ellipse_outline)
    cars = [ellipse_outline(c, (2.4, 1.1), 0.2, 0.1)
            for c in ((-5.0, 1.5), (7.0, -1.0))]
    centers_c = [np.array([-5.0, 1.5]), np.array([7.0, -1.0])]
    return ((jborders.build_border_set(lines, centers, lengths),
             jobst(cars, centers_c, 10.0)),
            (pborders.build_border_set(lines, centers, lengths),
             pobst(cars, centers_c, 10.0)))


def vehicle_snaps():
    specs = [dict(trajectory=np.column_stack([np.linspace(-12, 12, 30),
                                              np.full(30, 0.5)]),
                  headings=np.zeros(30), speeds=np.full(30, 6.0)),
             dict(trajectory=np.column_stack([np.full(30, -1.0),
                                              np.linspace(8, -8, 30)]),
                  headings=np.full(30, -np.pi / 2), speeds=np.full(30, 5.0),
                  spawn_time=0.2)]
    jv = jvehicles.build_vehicle_states(
        [jvehicles.VehicleSpec(**s) for s in specs], DT, 30)
    pv = pvehicles.build_vehicle_states(
        [pvehicles.VehicleSpec(**s) for s in specs], DT, 30, device=CPU)
    return (jvehicles.vehicle_snapshot_at(jv, 8),
            pvehicles.vehicle_snapshot_at(pv, 8))


@pytest.mark.parametrize("window", [32, 0])
@pytest.mark.parametrize("source", ["features", "pointsets"])
def test_orca_velocities_equal_jax(window, source):
    """A crowd among walls, parked cars and two vehicles, some agents exempt
    from the walls: the windowed band (window < N) and the full pass
    (window 0), with the walls as the analytic feature split or as the
    raw point sets."""
    pos, vel, radius, alive = crowd(160, 3, 11.0)
    pos[1] = pos[0]
    rng = np.random.default_rng(4)
    pref = rng.uniform(-1.8, 1.8, (160, 2)).astype(np.float32)
    vmax = rng.uniform(1.5, 2.0, 160).astype(np.float32)
    exempt = rng.uniform(size=160) < 0.15
    (jb, jo), (pb, po) = walls()
    if source == "features":
        jb, jo = jps.build_static_features(jb), jps.build_static_features(jo)
        pb, po = (pps.build_static_features(pb, CPU),
                  pps.build_static_features(po, CPU))
    jsnap, psnap = vehicle_snaps()
    kw = dict(max_neighbors=6, window=window, neighbor_dist=6.0)
    got = orca.orca_velocities(
        (t(pos[:, 0]), t(pos[:, 1])), (t(vel[:, 0]), t(vel[:, 1])),
        t(radius), t(alive), (t(pref[:, 0]), t(pref[:, 1])), t(vmax),
        OrcaParams(**kw), DT, veh_snap=psnap, borders=pb, obstacles=po,
        static_exempt=t(exempt))
    want = jorca.orca_velocities(
        (j(pos[:, 0]), j(pos[:, 1])), (j(vel[:, 0]), j(vel[:, 1])),
        j(radius), j(alive), (j(pref[:, 0]), j(pref[:, 1])), j(vmax),
        JaxOrcaParams(**kw), DT, veh_snap=jsnap, borders=jb, obstacles=jo,
        static_exempt=j(exempt))
    assert_close(got, want, mask=alive)
    moved = np.abs(got[0].numpy() - pref[:, 0]) > 1e-3
    assert moved[alive].sum() > 20
    # a permutation of this step given by the caller changes nothing
    order = morton_order(t(pos[:, 0]), t(pos[:, 1]), t(alive), "hilbert")
    again = orca.orca_velocities(
        (t(pos[:, 0]), t(pos[:, 1])), (t(vel[:, 0]), t(vel[:, 1])),
        t(radius), t(alive), (t(pref[:, 0]), t(pref[:, 1])), t(vmax),
        OrcaParams(**kw), DT, veh_snap=psnap, borders=pb, obstacles=po,
        static_exempt=t(exempt), order=order)
    for a, b in zip(again, got):
        assert torch.equal(a[t(alive)], b[t(alive)])


def test_coincident_agents_give_finite_velocities():
    """Coincident agents at rest, a zero preference, an agent on a wall:
    every sqrt sees a safe value, so every velocity is finite and capped."""
    pos, vel, radius, alive = crowd(40, 4, 2.0, dead=0.0)
    pos[1] = pos[0]
    pos[2] = pos[0]
    vel[:3] = 0.0
    pos[3] = (0.0, 3.0)                     # on the wall y = 3
    (_, _), (pb, po) = walls()
    for window in (0, 8):
        for pref in (vel, np.zeros_like(vel)):
            vx, vy = orca.orca_velocities(
                (t(pos[:, 0]), t(pos[:, 1])), (t(vel[:, 0]), t(vel[:, 1])),
                t(radius), t(alive), (t(pref[:, 0]), t(pref[:, 1])),
                torch.full((40,), 1.56), OrcaParams(window=window), DT,
                borders=pps.build_static_features(pb, CPU))
            assert torch.isfinite(vx).all() and torch.isfinite(vy).all()
            assert bool((torch.hypot(vx, vy) <= 1.56 * (1 + 1e-4) + 1e-3)
                        .all())


# -- the guarantees of tests/test_orca.py, on the port -----------------------------

def wall_set(segs, module):
    lines = [module.sample_borderline(s, e, 0.1) for s, e in segs]
    return module.build_border_set(lines, [ln[len(ln) // 2] for ln in lines],
                                   [len(ln) * 0.1 for ln in lines])


def orca_specs(starts_goals, speed=1.3, radius=0.4):
    return [SpawnerSpec(spawn_location=np.array([sx, sy, 0.3]),
                        waypoints=np.array([[gx, gy]]),
                        crossing_road=[False], speed=speed + 0.015 * i,
                        radius=radius, quantity=1, spawn_time=0.0,
                        pair_force="orca")
            for i, (sx, sy, gx, gy) in enumerate(starts_goals)]


def sfm_orca(**orca_kw):
    p = JaxSfmParams.from_dict({
        "forces": {"acceleration_force": True, "orca_law": True}})
    if orca_kw:
        p = dataclasses.replace(p, orca=JaxOrcaParams(**orca_kw))
    return convert.params_from_fields(fields_of(p))


def port_rollout(specs, steps, params, borders=None, **cfg_kw):
    schedule = build_spawn_schedule(specs, DT, steps)
    scene = stepper.Scene(
        spawn=convert.spawn_schedule_from_fields(fields_of(schedule), CPU),
        borders=borders)
    cfg = stepper.StepConfig(dt=DT, **cfg_kw)
    return stepper.make_rollout_fn(scene, params, cfg, steps)(
        PedState.empty(schedule.capacity, device=CPU))


@pytest.mark.parametrize("feed", ["features", "pointset"])
def test_wall_halfplane_bounds_approach_rate(feed):
    """Agents charging a wall: the wall-ward speed never exceeds
    gap / tau_static, and an exempt agent keeps its preference."""
    pset = wall_set([([-10.0, 2.0], [10.0, 2.0])], pborders)
    src = pps.build_static_features(pset, CPU) if feed == "features" else pset
    # under wall samples (the normal is then exactly (0, 1) on both feeds)
    xs = np.sort(pset.points[..., 0][pset.valid])[[5, 30, 55, 80, 105, 130,
                                                   155, 180]]
    rng = np.random.default_rng(7)
    n = len(xs)
    px = t(xs.astype(np.float32))
    py = t(rng.uniform(-1.0, 1.6, n).astype(np.float32))
    z = torch.zeros(n)
    r = torch.full((n,), 0.3)
    pref = (z, torch.full((n,), 1.8))
    vmax = torch.full((n,), 2.0)
    p = OrcaParams(tau_static=2.0)
    _, ovy = orca.orca_velocities((px, py), (z, z), r,
                                  torch.ones(n, dtype=torch.bool), pref, vmax,
                                  p, DT, borders=src)
    gap = (2.0 - py.numpy()) - 0.3
    slack = 1e-5 if feed == "features" else 1e-3
    assert (ovy.numpy() <= gap / 2.0 + slack).all()
    _, evy = orca.orca_velocities(
        (px[:1], py[:1]), (z[:1], z[:1]), r[:1],
        torch.ones(1, dtype=torch.bool), (z[:1], pref[1][:1]), vmax[:1], p,
        DT, borders=src, static_exempt=torch.ones(1, dtype=torch.bool))
    np.testing.assert_allclose(evy.numpy(), 1.8, atol=1e-5)


def test_goal_behind_wall_is_blocked_only_with_statics():
    steps = 200
    specs = orca_specs([(0.0, 0.0, 0.0, 6.0)], radius=0.3)
    walls_ = wall_set([([-10, 2.0], [10, 2.0])], pborders)

    def max_y(params):
        _, rec = port_rollout(specs, steps, params, borders=walls_,
                              waypoint_threshold=0.2,
                              despawn_on_arrival=False)
        y = rec.pos[..., 1].numpy()
        return np.where(rec.alive.numpy(), y, -np.inf).max()

    assert max_y(sfm_orca(max_statics=0)) > 2.5
    assert max_y(sfm_orca()) <= 2.0 - 0.3 + 0.01


def test_corridor_counterflow_has_zero_wall_penetration():
    """Counterflow in a walled corridor with the border force off: no body
    crosses a wall, everyone arrives, nobody touches."""
    walls_ = wall_set([([-12.0, 2.0], [12.0, 2.0]),
                       ([-12.0, -2.0], [12.0, -2.0])], pborders)
    lanes = [-1.2, -0.45, 0.45, 1.2]
    sg, waves = [], []
    for wave in range(2):
        for y in lanes:
            sg.append((-8.0, y, 8.0, y))
            waves.append(2.5 * wave)
        for y in lanes:
            sg.append((8.0, y + 0.11, -8.0, y + 0.11))
            waves.append(2.5 * wave + 1.1)
    specs = orca_specs(sg, radius=0.3)
    for s, t0 in zip(specs, waves):
        s.spawn_time = t0
    final, rec = port_rollout(specs, 640, sfm_orca(), borders=walls_,
                              waypoint_threshold=0.8)
    alive = rec.alive.numpy()
    y = rec.pos[..., 1].numpy()
    assert np.where(alive, np.abs(y), 0.0).max() <= 2.0 - 0.3 + 0.01
    assert not final.alive.any()
    pos = rec.pos.numpy()
    best = np.inf
    for k in range(pos.shape[0]):
        pts = pos[k, alive[k]]
        if len(pts) > 1:
            d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
            best = min(best, d[~np.eye(len(pts), dtype=bool)].min())
    assert best >= 0.6 - 0.06


# -- the slice, step by step against the JAX package --------------------------------

def bench_scene(scene, params, switch, jax_side):
    """bench.py's BENCH_LAW=orca and BENCH_MIX switches (bench.py:111-156)
    on a bundle of either package."""
    if switch == "orca":
        return scene, dataclasses.replace(params, enable_pedestrian=False,
                                          enable_orca=True)
    fams = switch.split(",")
    cap = scene.spawn.capacity
    law = np.full(cap, -1, np.int32)
    for fam, chunk in zip(fams, np.array_split(np.arange(cap), len(fams))):
        law[chunk] = LAW_IDS[fam]
    law = jnp.asarray(law) if jax_side else t(law)
    return (dataclasses.replace(scene, spawn=dataclasses.replace(
                scene.spawn, law_id=law)),
            dataclasses.replace(params, enable_pedestrian="moussaid" in fams,
                                enable_powerlaw="powerlaw" in fams,
                                enable_orca="orca" in fams))


class FallbackRows:
    """Records, for each ORCA solve of the port's step, the rows whose
    program is infeasible (slot order) with their constraint planes: the
    minimax fallback's optimum can be a whole segment (tests/test_orca.py:
    196-198, "any |v| <= vmax with vx = 0 is optimal"), and there the two
    packages may pick different points of it from planes that differ by
    ulps (the JAX package's CPU arithmetic contracts multiply-adds).  Such a
    row is held to the same minimax value instead."""

    def __init__(self, monkeypatch):
        self.rows = []
        real_solve, real_orca = orca.solve_orca_lp, stepper.orca_velocities
        order = {}

        def solve(pref_x, pref_y, ptx, pty, nx, ny, valid, vmax):
            bad = ~orca.solve_lp2(pref_x, pref_y, ptx, pty, nx, ny, valid,
                                  vmax)[2]
            perm = order.get("perm")
            slots = (perm[bad] if perm is not None
                     else torch.nonzero(bad).squeeze(1))
            self.rows.append((slots, ptx[bad], pty[bad], nx[bad], ny[bad],
                              valid[bad]))
            return real_solve(pref_x, pref_y, ptx, pty, nx, ny, valid, vmax)

        def velocities(pos, *args, **kwargs):
            n = pos[0].shape[0]
            window = args[5].window or n
            given = kwargs.get("order")
            order["perm"] = (None if window >= n else given[0]
                             if given is not None else morton_order(
                                 pos[0], pos[1], args[2],
                                 kwargs.get("spatial_order", "hilbert"))[0])
            return real_orca(pos, *args, **kwargs)

        monkeypatch.setattr(orca, "solve_orca_lp", solve)
        monkeypatch.setattr(stepper, "orca_velocities", velocities)

    def check(self, got, want, tol):
        """Positions of every other row within ``tol``; a fallback row's
        velocities of equal minimax value (1e-5) on the port's planes."""
        err = np.maximum(np.abs(got.pos_x.numpy() - want["pos_x"]),
                         np.abs(got.pos_y.numpy() - want["pos_y"]))
        fallback = np.zeros(err.shape, bool)
        for slots, ptx, pty, nx, ny, valid in self.rows:
            for r, slot in enumerate(slots.tolist()):
                fallback[slot] = True
                vals = []
                for vx, vy in ((got.vel_x[slot].item(),
                                got.vel_y[slot].item()),
                               (want["vel_x"][slot], want["vel_y"][slot])):
                    clear = (vx - ptx[r]) * nx[r] + (vy - pty[r]) * ny[r]
                    vals.append(clear[valid[r]].min().item())
                assert abs(vals[0] - vals[1]) <= 1e-5, (slot, vals)
        self.rows.clear()
        return float(np.where(fallback, 0.0, err).max())


def step_by_step(jax_side, port_side, steps, monkeypatch, tol=POS_TOL_M):
    """The port stepped from the JAX package's own state at every step:
    alive and modes equal, positions within ``tol`` (the rows of the
    minimax fallback: see :class:`FallbackRows`).  Returns the worst
    position error."""
    js, jp, jc, jst = jax_side
    ps, pp, pc = port_side
    js = jstepper.prepare_scene(js, analytic=jc.env_analytic, orca=True)
    ps = stepper.prepare_scene(ps, analytic=pc.env_analytic, orca=True)

    def step(s, k):
        # op by op: compiled, XLA's CPU compiler contracts products into
        # fused multiply-adds as the host's CPU allows, and the port rounds
        # every operation on its own
        with jax.disable_jit():
            return jstepper.simulation_step(s, js, jp, jc, k)[0]

    fallback = FallbackRows(monkeypatch)
    worst = 0.0
    for k in range(steps):
        pst = convert.ped_state_from_fields(fields_of(jst), CPU)
        got, _ = stepper.simulation_step(pst, ps, pp, pc, k)
        jst = step(jst, k)
        want = fields_of(jst)
        np.testing.assert_array_equal(got.alive.numpy(), want["alive"])
        np.testing.assert_array_equal(got.mode.numpy(), want["mode"])
        worst = max(worst, fallback.check(got, want, tol))
    assert worst <= tol, worst
    return worst


@pytest.mark.parametrize("switch", ["orca", "moussaid,powerlaw,orca"])
def test_config1_orca_matches_jax_step_by_step(switch, monkeypatch):
    """Config #1 (128 agents, the windowed band: window 64 < N) under
    BENCH_LAW=orca and BENCH_MIX=moussaid,powerlaw,orca, 12 steps.  The
    mixed crowd's power-law rows carry that law's own bound
    (tests/test_torch_families.py POS_TOL_M: the law is singular at
    contact)."""
    js, jp, jc, jst = jsyn.benchmark_bundle(128, extent=9.0,
                                            use_pallas=False)
    ps, pp, pc, _ = psyn.benchmark_bundle(128, extent=9.0, device=CPU)
    js, jp = bench_scene(js, jp, switch, True)
    ps, pp = bench_scene(ps, pp, switch, False)
    step_by_step((js, jp, jc, jst), (ps, pp, pc), 12, monkeypatch,
                 tol=POS_TOL_M if switch == "orca" else POWERLAW_POS_TOL_M)


def test_config3_orca_analytic_matches_jax_step_by_step(monkeypatch):
    """Config #3 under BENCH_MODE=obstacles BENCH_LAW=orca
    BENCH_ENV_ANALYTIC=1: walls as the analytic feed, parked cars as
    chunks, vehicles, the analytic border tier (the JAX package's
    interpret-mode kernels), 8 steps."""
    kw = dict(extent=12.0, with_borders=True, with_obstacles=True,
              num_steps_hint=10)
    js, jp, jc, jst = jsyn.benchmark_bundle(72, use_pallas=True, **kw)
    ps, pp, pc, _ = psyn.benchmark_bundle(72, device=CPU, **kw)
    js, jp = bench_scene(js, jp, "orca", True)
    ps, pp = bench_scene(ps, pp, "orca", False)
    jc = dataclasses.replace(jc, pallas_interpret=True, env_analytic=True,
                             env_ped_tile=128)
    pc = dataclasses.replace(pc, env_analytic=True)
    orca_kw = dict(window=32)
    jp = dataclasses.replace(jp, orca=dataclasses.replace(jp.orca, **orca_kw))
    pp = dataclasses.replace(pp, orca=dataclasses.replace(pp.orca, **orca_kw))
    step_by_step((js, jp, jc, jst), (ps, pp, pc), 8, monkeypatch)


def test_urban_orca_matches_jax_step_by_step(monkeypatch):
    """A small urban bundle (BASELINE config #4) with ORCA and the
    analytic tier: the fleet's snapshot feeds the vehicle half-planes, and
    walkers crossing the road are exempt from the walls.  24 ticks, fleet
    and pedestrians stepped from the JAX package's own state."""
    kw = dict(n_routes=8, n_roads=3, width=200.0, cross_spacing=80.0,
              vehicles_per_road=1)
    js, jp, jc, jst = jsyn.urban_bundle(48, num_steps_hint=30,
                                        use_pallas=False, **kw)
    ps, pp, pc, _ = psyn.urban_bundle(48, num_steps_hint=30, device=CPU,
                                      **kw)
    js, jp = bench_scene(js, jp, "orca", True)
    ps, pp = bench_scene(ps, pp, "orca", False)
    js = jstepper.prepare_scene(js, orca=True)
    ps = stepper.prepare_scene(ps, orca=True)
    jap_state = js.autopilot.initial_state()
    fallback = FallbackRows(monkeypatch)
    seen, worst = set(), 0.0
    for k in range(24):
        pst = convert.ped_state_from_fields(fields_of(jst), CPU)
        pap = convert.autopilot_state_from_fields(fields_of(jap_state), CPU)
        got, _, _ = stepper.fleet_tick(pst, pap, ps, pp, pc, k)
        jst = jspawn.apply_spawn(jst, js.spawn, k)
        jap_state = jap.autopilot_step(js.autopilot, jap_state,
                                       (jst.pos_x, jst.pos_y),
                                       (jst.vel_x, jst.vel_y), jst.alive, k,
                                       jc.dt)
        snap = jap.autopilot_snapshot(js.autopilot, jap_state)
        jst, _ = jstepper.simulation_step(jst, js, jp, jc, k, veh_snap=snap)
        want = fields_of(jst)
        np.testing.assert_array_equal(got.alive.numpy(), want["alive"])
        np.testing.assert_array_equal(got.mode.numpy(), want["mode"])
        worst = max(worst, fallback.check(got, want, POS_TOL_M))
        seen |= set(got.mode[got.alive].tolist())
    assert worst <= POS_TOL_M, worst
    assert modes.CROSSING_ROAD in seen


def test_orca_rows_follow_law_id_and_crossing_walkers_skip_walls(monkeypatch):
    """The step's ORCA block: only alive agents of ORCA's ``law_id`` take
    the projection, and the wall constraints skip road-crossing modes."""
    ps, pp, pc, pst = psyn.benchmark_bundle(64, extent=8.0,
                                            with_borders=True, device=CPU)
    ps, pp = bench_scene(ps, pp, "moussaid,orca", False)
    ps = stepper.prepare_scene(ps, orca=True)
    state, _ = stepper.rollout(pst, ps, pp, pc, 3, record=False)
    state = dataclasses.replace(state, mode=torch.where(
        torch.arange(64) % 5 == 0, modes.CROSSING_ROAD, state.mode))
    seen = {}
    real = orca.orca_velocities

    def spy(*args, **kwargs):
        seen.update(kwargs)
        vx, vy = real(*args, **kwargs)
        return vx + 100.0, vy      # mark the rows that take it

    monkeypatch.setattr(stepper, "orca_velocities", spy)
    _, (vx, _), _, _ = stepper.tick_core(state, ps, pp, pc, 3)
    taken = (vx > 50.0).numpy()
    law = ps.spawn.law_id.numpy()
    np.testing.assert_array_equal(taken, state.alive.numpy()
                                  & (law == LAW_IDS["orca"]))
    np.testing.assert_array_equal(
        seen["static_exempt"].numpy(),
        (state.mode == modes.CROSSING_ROAD).numpy()
        | (state.mode == modes.ROAD_TO_SIDEWALK).numpy())
    assert seen["borders"] is ps.borders_feat


# -- conversion ------------------------------------------------------------------

def test_conversion_carries_env_analytic_and_orca_params():
    jcfg = jstepper.StepConfig(dt=DT, env_analytic=True, use_pallas=True)
    assert convert.step_config_from_fields(fields_of(jcfg)).env_analytic
    jp = dataclasses.replace(
        JaxSfmParams(), enable_orca=True, enable_pedestrian=False,
        orca=JaxOrcaParams(tau=1.5, neighbor_dist=9.0, tau_static=1.2,
                           max_neighbors=7, window=48, max_vehicles=2,
                           max_statics=5))
    pp = convert.params_from_fields(fields_of(jp))
    assert pp.enable_orca and not pp.enable_pedestrian
    assert pp.orca == OrcaParams(tau=1.5, neighbor_dist=9.0, tau_static=1.2,
                                 max_neighbors=7, window=48, max_vehicles=2,
                                 max_statics=5)
    assert fields_of(pp.orca) == fields_of(jp.orca)
