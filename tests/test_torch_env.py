"""PyTorch port: the environment slice (sidewalk borders, static and dynamic
obstacles) against the JAX package and the float64 oracle.

Inputs are drawn with numpy from a seed and fed to both packages; the JAX
package runs its plain jnp path on the CPU (``use_pallas=False``), the
reference its own Pallas environment kernels are tested against.  The port
runs its plain PyTorch versions: on the CPU the kernel wrappers of
``ops/cuda_env.py`` take them.  The CUDA kernels themselves are held against
those plain versions on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from carla_social_force_model_tpu.api import synthetic as jsyn
from carla_social_force_model_tpu.env import borders as jborders
from carla_social_force_model_tpu.env import obstacles_gen as jobstacles
from carla_social_force_model_tpu.env import pointsets as jpointsets
from carla_social_force_model_tpu.models import gap as jgap
from carla_social_force_model_tpu.models import modes as jmodes
from carla_social_force_model_tpu.models import stepper as jstepper
from carla_social_force_model_tpu.models import vehicles as jvehicles
from carla_social_force_model_tpu.models.params import (
    SfmParams as JaxSfmParams)
from carla_social_force_model_tpu.models.spawn import (
    SpawnerSpec, build_spawn_schedule, realized_spawn_steps as jrealized)
from carla_social_force_model_tpu.models.state import PedState as JaxPedState
from carla_social_force_model_tpu.ops import forces as jforces
from carla_social_force_model_tpu.ops import geometry as jgeometry
from carla_social_force_model_tpu.ops import spatial as jspatial
from carla_social_force_model_tpu_torch.api import synthetic as psyn
from carla_social_force_model_tpu_torch.env import borders as pborders
from carla_social_force_model_tpu_torch.env import obstacles_gen as pobstacles
from carla_social_force_model_tpu_torch.env import pointsets as ppointsets
from carla_social_force_model_tpu_torch.models import gap as pgap
from carla_social_force_model_tpu_torch.models import modes, stepper
from carla_social_force_model_tpu_torch.models import vehicles as pvehicles
from carla_social_force_model_tpu_torch.models.params import (
    BorderParams, MoussaidParams, SfmParams, SpaceRepulsiveParams)
from carla_social_force_model_tpu_torch.models.spawn import (
    realized_spawn_steps)
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.ops import cuda_env, forces, spatial
from carla_social_force_model_tpu_torch.ops import geometry as pgeometry
from carla_social_force_model_tpu_torch.utils import convert

CPU = "cpu"
DT = 0.05


def fields_of(obj):
    """A JAX-package dataclass as nested dicts of numpy arrays and Python
    values (what utils/convert.py takes)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


# -- scenes drawn with numpy ----------------------------------------------------

def border_geometry(long_segment=False):
    """(lines, centers, lengths): walls around a 12 m box, split in sections
    at the reference's 0.1 m sampling; optionally one 450 m wall (4,501
    points, beyond the JAX package's 4,096-point segment-major cap) through
    the box."""
    lines, centers, lengths = [], [], []
    for a, b in (((-6, -6), (6, -6)), ((6, -6), (6, 6)), ((6, 6), (-6, 6)),
                 ((-6, 6), (-6, -6)), ((-6, 0.3), (2, 0.3))):
        psyn._wall_sections(lines, centers, lengths, a, b, 5.0)
    if long_segment:
        psyn._wall_sections(lines, centers, lengths, (-225.0, -2.05),
                            (225.0, -2.05), 450.0)
    return lines, centers, lengths


def obstacle_geometry():
    """(outlines, centers): a parked car and a box, sampled as the CARLA
    path would (ellipse and rectangle outlines)."""
    outlines = [pobstacles.ellipse_outline((1.5, 2.0), (2.4, 1.1), 0.3, 0.1),
                pobstacles.rectangle_outline((-3.0, -3.5), (0.8, 0.5), 1.1,
                                             0.1)]
    centers = [np.array([1.5, 2.0]), np.array([-3.0, -3.5])]
    return outlines, centers


def crowd(n, seed, extent=6.5):
    """Seeded crowd with dead slots, every mode, and pedestrian 0 standing
    exactly on a sampled border point."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, n).astype(np.float32)
    alive = rng.uniform(size=n) < 0.85
    mode = rng.integers(0, 5, n).astype(np.int32)
    pos[0] = np.asarray(border_geometry()[0][0][7], np.float32)
    alive[0] = True
    mode[0] = modes.WALKING_SIDEWALK
    return pos, vel, radius, alive, mode


def vehicle_specs():
    """Two scripted vehicles (one spawning late, one leaving early) and a
    third from waypoints."""
    specs = []
    for k, (y, length) in enumerate(((1.0, 40), (-2.5, 12))):
        xs = -8.0 + 4.0 * DT * np.arange(length)
        specs.append(dict(trajectory=np.column_stack([xs, np.full(length, y)]),
                          headings=np.zeros(length),
                          speeds=np.full(length, 4.0), spawn_time=0.2 * k))
    traj, heads, speeds = pvehicles.trajectory_from_waypoints(
        [[4.0, -7.0], [4.0, 0.0], [0.0, 4.0]], 3.0, DT)
    specs.append(dict(trajectory=traj, headings=heads, speeds=speeds,
                      extent=(2.0, 0.9), spawn_time=0.5))
    return specs


def both_vehicle_states(num_steps):
    specs = vehicle_specs()
    jv = jvehicles.build_vehicle_states(
        [jvehicles.VehicleSpec(**s) for s in specs], DT, num_steps)
    pv = pvehicles.build_vehicle_states(
        [pvehicles.VehicleSpec(**s) for s in specs], DT, num_steps,
        device=CPU)
    return jv, pv


# -- builders -----------------------------------------------------------------

def assert_fields_equal(got, want):
    """A port dataclass against the JAX one, field by field, exactly."""
    want = fields_of(want)
    for f in dataclasses.fields(got):
        g = getattr(got, f.name)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, want[f.name], err_msg=f.name)


def test_border_and_obstacle_sets_equal_jax():
    lines, centers, lengths = border_geometry(long_segment=True)
    assert_fields_equal(pborders.build_border_set(lines, centers, lengths),
                        jborders.build_border_set(lines, centers, lengths))
    outlines, ocenters = obstacle_geometry()
    assert_fields_equal(pobstacles.build_obstacle_set(outlines, ocenters, 7.5),
                        jobstacles.build_obstacle_set(outlines, ocenters, 7.5))
    for a, b in ((pborders.sample_borderline((0, 0), (3.3, 1.2), 0.1),
                  jborders.sample_borderline((0, 0), (3.3, 1.2), 0.1)),
                 (pobstacles.ellipse_outline((1, 2), (2.4, 1.1), 0.7, 0.1),
                  jobstacles.ellipse_outline((1, 2), (2.4, 1.1), 0.7, 0.1))):
        np.testing.assert_array_equal(a, b)


def test_config_geometry_readers_equal_jax():
    cfg = {"resolution": 0.1,
           "borders": [{"start_point": [0, 0], "end_point": [4, 0]},
                       {"start_point": [4, 0], "end_point": [4, 3]}],
           "static": [{"center": [1, 2], "extent": [2, 1], "heading": 0.4,
                       "shape": "ellipse"},
                      {"center": [-1, 0], "extent": [0.5, 0.5],
                       "shape": "rectangle"}]}
    for got, want in ((pborders.borders_from_config(cfg),
                       jborders.borders_from_config(cfg)),
                      (pobstacles.static_obstacles_from_config(cfg),
                       jobstacles.static_obstacles_from_config(cfg))):
        assert len(got) == len(want)
        for g, w in zip(got, want):         # lists of arrays or floats
            assert len(g) == len(w) > 0
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["borders", "long_border", "obstacles"])
def test_segment_major_equals_jax(which):
    """The segment-major rows equal the JAX package's, with no 4,096-point
    cap on the port (the JAX call lifts its own cap to compare)."""
    if which == "obstacles":
        jset = jobstacles.build_obstacle_set(*obstacle_geometry(), 7.5)
        pset = pobstacles.build_obstacle_set(*obstacle_geometry(), 7.5)
    else:
        geo = border_geometry(long_segment=which == "long_border")
        jset, pset = (jborders.build_border_set(*geo),
                      pborders.build_border_set(*geo))
    got = ppointsets.segment_major(pset, CPU)
    want = jpointsets.segment_major(jset, max_points_per_segment=1 << 30)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.centers.numpy(),
                                  np.asarray(want.centers))
    np.testing.assert_array_equal(got.filter_radius.numpy(),
                                  np.asarray(want.filter_radius))
    assert got.num_segments == want.num_segments
    if which == "long_border":
        assert got.points_per_segment > 4096
        assert jpointsets.segment_major(jset) is None   # the TPU's cap
    assert pborders.build_border_set([], [], []) is None
    empty = ppointsets.build_chunked_pointset([], [], [])
    assert ppointsets.segment_major(empty, CPU) is None
    assert ppointsets.segment_major(None, CPU) is None


def test_synthetic_environment_equals_jax():
    for extent in (10.0, 30.0):
        assert_fields_equal(psyn.synthetic_borders(extent),
                            jsyn.synthetic_borders(extent))
        assert_fields_equal(psyn.synthetic_obstacles(extent),
                            jsyn.synthetic_obstacles(extent))
        assert_fields_equal(
            psyn.synthetic_vehicles(extent, 8, DT, 40, device=CPU),
            jsyn.synthetic_vehicles(extent, 8, DT, 40))


def test_vehicle_states_equal_jax():
    for num_steps in (1, 30, 80):
        jv, pv = both_vehicle_states(num_steps)
        assert_fields_equal(pv, jv)
    for args in ((0.0, 5.0, 3, DT, 400), (0.33, 0.4, 5, DT, 40),
                 (2.0, 1.0, 2, DT, 10)):
        assert realized_spawn_steps(*args) == jrealized(*args)
    traj, heads, speeds = pvehicles.trajectory_from_waypoints(
        [[0, 0], [3, 0], [3, 0], [3, 4]], 2.5, DT)
    for a, b in zip((traj, heads, speeds), jvehicles.trajectory_from_waypoints(
            [[0, 0], [3, 0], [3, 0], [3, 4]], 2.5, DT)):
        np.testing.assert_array_equal(a, b)


def test_vehicle_snapshot_clamps_past_the_timeline():
    """A step beyond ``num_steps_hint`` reads the timeline's last row, as
    the JAX package's traced index does (a torch index would raise)."""
    jv, pv = both_vehicle_states(25)
    for step in (0, 7, 24, 25, 31, 400):
        got = pvehicles.vehicle_snapshot_at(pv, step)
        want = jvehicles.vehicle_snapshot_at(jv, jnp.asarray(step, jnp.int32))
        assert_fields_equal(got, want)
    last = pvehicles.vehicle_snapshot_at(pv, 24)
    assert torch.equal(pvehicles.vehicle_snapshot_at(pv, 99).center,
                       last.center)


@pytest.mark.parametrize("step", [3, 20])
def test_snapshot_pointsets_equal_jax(step):
    jv, pv = both_vehicle_states(40)
    jsnap = jvehicles.vehicle_snapshot_at(jv, step)
    psnap = pvehicles.vehicle_snapshot_at(pv, step)
    jseg, jvel, jact = jvehicles.snapshot_segment_pointset(jsnap, 12.0)
    pseg, pvel, pact = pvehicles.snapshot_segment_pointset(psnap, 12.0)
    np.testing.assert_allclose(pseg.points.numpy(), np.asarray(jseg.points),
                               rtol=0, atol=2e-6)
    np.testing.assert_array_equal(pseg.filter_radius.numpy(),
                                  np.asarray(jseg.filter_radius))
    np.testing.assert_array_equal(pact.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(pvel.numpy(), np.asarray(jvel))
    jch, _, _ = jvehicles.snapshot_pointset(jsnap, 12.0)
    pch, _, _ = pvehicles.snapshot_pointset(psnap, 12.0)
    np.testing.assert_allclose(pch.points.numpy(), np.asarray(jch.points),
                               rtol=0, atol=2e-6)
    np.testing.assert_array_equal(pch.valid.numpy(), np.asarray(jch.valid))
    np.testing.assert_array_equal(pch.chunk_segment.numpy(),
                                  np.asarray(jch.chunk_segment))


# -- spatial sort, gap acceptance, geometry -------------------------------------

def sort_positions(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-50, 50, (n, 2)).astype(np.float32)
    alive = rng.uniform(size=n) < 0.8
    # an alive agent at the quantization corner (the clamp), a dead one
    # beyond it, and ties
    pos[3] = pos[:, 0].max() + 1, pos[:, 1].max() + 1
    alive[3] = True
    pos[4] = pos[3] + 10.0
    alive[4] = False
    pos[9] = pos[8]
    return pos, alive


@pytest.mark.parametrize("order", ["morton", "hilbert"])
def test_curve_keys_and_sort_equal_jax(order):
    for n, seed in ((1, 0), (37, 1), (2048, 2)):
        pos, alive = sort_positions(max(n, 10), seed)
        pos, alive = pos[:n], alive[:n]
        px, py, pa = t(pos[:, 0]), t(pos[:, 1]), t(alive)
        jkey = np.asarray(jspatial._morton_key((jnp.asarray(pos[:, 0]),
                                                jnp.asarray(pos[:, 1])),
                                               jnp.asarray(alive), order))
        key = spatial._morton_key(px, py, pa, order)
        assert key.dtype == torch.int64
        np.testing.assert_array_equal(key.numpy(), jkey.astype(np.int64))
        assert bool((key[~pa] == 0xFFFFFFFF).all())
        assert bool((key[pa] <= 0xFFFFFFFE).all())
        (sx, sy, sa), inv = spatial.morton_sort(px, py, pa, (px, py, pa),
                                                order)
        (jx, jy, ja), jinv = jspatial.morton_sort(
            (jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])),
            jnp.asarray(alive),
            (jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]),
             jnp.asarray(alive)), order)
        np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
        for a, b in ((sx, jx), (sy, jy), (sa, ja)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        torch.testing.assert_close(sx[inv], px, rtol=0, atol=0)


def test_curve_order_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown spatial order"):
        spatial._morton_key(torch.zeros(2), torch.zeros(2),
                            torch.ones(2, dtype=torch.bool), "peano")


def gap_scene(n, v, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-10, 10, (n, 2)).astype(np.float32)
    goal = (pos + rng.uniform(-8, 8, (n, 2))).astype(np.float32)
    speed = rng.uniform(0.8, 2.0, n).astype(np.float32)
    speed[0] = 0.0
    margin = rng.uniform(-0.5, 2.0, n).astype(np.float32)
    center = rng.uniform(-12, 12, (v, 2)).astype(np.float32)
    vel = rng.uniform(-8, 8, (v, 2)).astype(np.float32)
    vel[0] = 0.0
    extent = rng.uniform(1.0, 2.5, (v, 2)).astype(np.float32)
    active = rng.uniform(size=v) < 0.8
    return pos, goal, speed, margin, center, vel, extent, active


@pytest.mark.parametrize("strict", [False, True])
def test_gap_ready_equals_jax_and_oracle(strict):
    pos, goal, speed, margin, center, vel, extent, active = gap_scene(
        300, 6, seed=5)
    got = pgap.gap_ready(t(pos[:, 0]), t(pos[:, 1]), t(goal[:, 0]),
                         t(goal[:, 1]), t(speed), t(margin), t(center),
                         t(vel), t(extent), t(active), strict_parity=strict)
    want = jgap.gap_ready(
        (jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])),
        (jnp.asarray(goal[:, 0]), jnp.asarray(goal[:, 1])),
        jnp.asarray(speed), jnp.asarray(margin), jnp.asarray(center),
        jnp.asarray(vel), jnp.asarray(extent), jnp.asarray(active),
        strict_parity=strict)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.shape[0]     # both outcomes occur
    if not strict:
        f64 = np.float64
        want = [oracle.gap_acceptance_ready(
            pos[i].astype(f64), goal[i].astype(f64), f64(speed[i]),
            f64(margin[i]), center.astype(f64), vel.astype(f64),
            extent[:, 0].astype(f64), active)
            for i in range(1, pos.shape[0])]      # the oracle divides by
        np.testing.assert_array_equal(got.numpy()[1:], want)  # the speed


def test_segment_intersection_equals_jax():
    rng = np.random.default_rng(11)
    p = rng.uniform(-5, 5, (4, 500, 2)).astype(np.float32)
    p[3, :5] = p[2, :5]                                   # parallel segments
    hit, pt = pgeometry.segment_intersection(*(t(a) for a in p))
    jhit, jpt = jgeometry.segment_intersection(*(jnp.asarray(a) for a in p))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    assert 0 < int(hit.sum()) < 500


# -- the environment forces ------------------------------------------------------

def force_case(seed):
    """(port planes, JAX arrays, numpy arrays) of a seeded crowd."""
    pos, vel, radius, alive, mode = crowd(200, seed)
    planes = dict(pos_x=t(pos[:, 0]), pos_y=t(pos[:, 1]), vel_x=t(vel[:, 0]),
                  vel_y=t(vel[:, 1]), radius=t(radius), alive=t(alive),
                  mode=t(mode))
    jarr = dict(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                radius=jnp.asarray(radius), alive=jnp.asarray(alive),
                mode=jnp.asarray(mode))
    return planes, jarr, (pos, vel, radius, alive, mode)


def assert_force_close(got, want, rtol=1e-5, atol=1e-5):
    got = torch.stack(got, dim=-1).numpy()
    want = np.asarray(want)
    err = np.abs(got - want)
    assert np.all(err <= atol + rtol * np.abs(want)), (
        f"max abs err {err.max()}, max |f| {np.abs(want).max()}")


@pytest.mark.parametrize("use_radius", [False, True])
@pytest.mark.parametrize("long_segment", [False, True])
def test_border_force_matches_jax_and_oracle(use_radius, long_segment):
    planes, jarr, raw = force_case(3)
    geo = border_geometry(long_segment)
    jset = jborders.build_border_set(*geo)
    seg = ppointsets.segment_major(pborders.build_border_set(*geo), CPU)
    p = BorderParams()
    got = forces.border_force(planes["pos_x"], planes["pos_y"], planes["mode"],
                              planes["radius"], planes["alive"], seg, p,
                              use_ped_radius=use_radius)
    want = jforces.border_force(jarr["pos"], jarr["mode"], jarr["radius"],
                                jarr["alive"], jset, p,
                                use_ped_radius=use_radius)
    assert_force_close(got, want)
    fx, fy = got
    crossing = forces.crossing_mask(planes["mode"])
    assert bool((fx[crossing | ~planes["alive"]] == 0).all())
    assert fx[0].item() != 0.0 or fy[0].item() != 0.0  # other sections act
    assert torch.isfinite(fx).all() and torch.isfinite(fy).all()
    pos, _, radius, alive, mode = raw
    pts = [np.asarray(ln, np.float32).astype(np.float64) for ln in geo[0]]
    ref = oracle.border_force(pos.astype(np.float64), mode, radius, alive,
                              pts, np.asarray(geo[1]), np.asarray(geo[2]),
                              p.a, p.b, use_radius=use_radius)
    assert_force_close(got, ref, rtol=1e-4, atol=1e-4)


def test_space_repulsive_force_matches_jax_and_oracle():
    planes, jarr, raw = force_case(4)
    geo = border_geometry(long_segment=True)
    jset = jborders.build_border_set(*geo)
    seg = ppointsets.segment_major(pborders.build_border_set(*geo), CPU)
    p = SpaceRepulsiveParams()
    got = forces.space_repulsive_force(planes["pos_x"], planes["pos_y"],
                                       planes["mode"], planes["alive"], seg, p)
    want = jforces.space_repulsive_force(jarr["pos"], jarr["mode"],
                                         jarr["alive"], jset, p)
    assert_force_close(got, want)
    pos, _, _, alive, mode = raw
    pts = [np.asarray(ln, np.float32).astype(np.float64) for ln in geo[0]]
    ref = oracle.space_repulsive_force(pos.astype(np.float64), mode, alive,
                                       pts, np.asarray(geo[1]),
                                       np.asarray(geo[2]), p.u0, p.r)
    assert_force_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_radius", [False, True])
def test_static_obstacle_force_matches_jax_and_oracle(use_radius):
    planes, jarr, raw = force_case(5)
    outlines, centers = obstacle_geometry()
    jset = jobstacles.build_obstacle_set(outlines, centers, 7.5)
    seg = ppointsets.segment_major(
        pobstacles.build_obstacle_set(outlines, centers, 7.5), CPU)
    rng = np.random.default_rng(6)
    ovel = rng.uniform(-1, 1, (2, 2)).astype(np.float32)  # moving obstacles
    p = MoussaidParams()
    got = forces.obstacle_force(
        planes["pos_x"], planes["pos_y"], planes["vel_x"], planes["vel_y"],
        planes["radius"], planes["alive"], seg, t(ovel), p,
        use_ped_radius=use_radius)
    want = jforces.obstacle_force(jarr["pos"], jarr["vel"], jarr["radius"],
                                  jarr["alive"], jset, jnp.asarray(ovel), p,
                                  use_ped_radius=use_radius)
    assert_force_close(got, want)
    assert bool((got[0][~planes["alive"]] == 0).all())
    pos, vel, radius, alive, _ = raw
    pts = [np.asarray(o, np.float32).astype(np.float64) for o in outlines]
    ref = oracle.obstacle_force(
        pos.astype(np.float64), vel.astype(np.float64), radius, alive, pts,
        np.asarray(centers), ovel.astype(np.float64), p.lambda_, p.A,
        p.gamma, p.n, p.n_prime, p.epsilon, 7.5, use_radius=use_radius)
    assert_force_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("step", [0, 6, 30])
def test_dynamic_obstacle_force_matches_jax_and_oracle(step):
    """Vehicles from the scripted timeline, with inactive ones (not yet
    spawned at step 0, despawned at step 30)."""
    planes, jarr, raw = force_case(7)
    jv, pv = both_vehicle_states(40)
    p = MoussaidParams(perception_threshold=9.0)
    psnap = pvehicles.vehicle_snapshot_at(pv, step)
    jsnap = jvehicles.vehicle_snapshot_at(jv, step)
    pseg, pvel, pact = pvehicles.snapshot_segment_pointset(
        psnap, p.perception_threshold)
    jset, jvel, jact = jvehicles.snapshot_pointset(jsnap,
                                                   p.perception_threshold)
    assert not bool(pact.all())
    got = forces.obstacle_force(
        planes["pos_x"], planes["pos_y"], planes["vel_x"], planes["vel_y"],
        planes["radius"], planes["alive"], pseg, pvel, p,
        obstacle_active=pact)
    want = jforces.obstacle_force(jarr["pos"], jarr["vel"], jarr["radius"],
                                  jarr["alive"], jset, jvel, p,
                                  obstacle_active=jact)
    assert_force_close(got, want)
    pos, vel, radius, alive, _ = raw
    valid = psnap.template_valid.numpy()
    outlines = [pts[v] for pts, v in zip(
        pseg.points.numpy().astype(np.float64), valid)]
    ref = oracle.obstacle_force(
        pos.astype(np.float64), vel.astype(np.float64), radius, alive,
        outlines, psnap.center.numpy().astype(np.float64),
        pvel.numpy().astype(np.float64), p.lambda_, p.A, p.gamma, p.n,
        p.n_prime, p.epsilon, p.perception_threshold,
        active=pact.numpy())
    assert_force_close(got, ref, rtol=1e-4, atol=1e-4)


def test_row_blocks_do_not_change_the_plain_force():
    planes, _, _ = force_case(8)
    seg = ppointsets.segment_major(
        pborders.build_border_set(*border_geometry()), CPU)
    args = (planes["pos_x"], planes["pos_y"], planes["radius"],
            planes["alive"], seg, 3.0, 0.1)
    whole = forces.env_exp_force(*args, use_radius=True)
    blocked = forces.env_exp_force(*args, use_radius=True,
                                   max_group_elems=5000)
    for a, b in zip(whole, blocked):   # torch's reduction order may differ
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# -- the kernel wrappers and the fused terms on the CPU ---------------------------

def env_scene(n=160, seed=9, num_steps=40):
    """A prepared port scene with borders, static obstacles and vehicles,
    plus a state with crossing and dead pedestrians."""
    pos, vel, radius, alive, mode = crowd(n, seed)
    spawn = psyn.synthetic_crowd(n, extent=6.0, seed=seed, device=CPU)
    outlines, centers = obstacle_geometry()
    _, pv = both_vehicle_states(num_steps)
    scene = stepper.prepare_scene(stepper.Scene(
        spawn=spawn,
        borders=pborders.build_border_set(*border_geometry(True)),
        static_obstacles=pobstacles.build_obstacle_set(outlines, centers, 7.5),
        vehicles=pv))
    state = dataclasses.replace(
        PedState.empty(n, device=CPU), pos_x=t(pos[:, 0]),
        pos_y=t(pos[:, 1]), vel_x=t(vel[:, 0]), vel_y=t(vel[:, 1]),
        radius=t(radius), alive=t(alive), mode=t(mode))
    params = SfmParams(enable_border=True, enable_static_obstacle=True,
                       enable_dynamic_obstacle=True,
                       enable_space_repulsive=True, use_ped_radius=True)
    return scene, params, state


def test_fused_environment_terms_equal_the_plain_versions():
    scene, params, state = env_scene()
    snap = pvehicles.vehicle_snapshot_at(scene.vehicles, 12)
    cuda_env.reset_launch_counts()
    fused = cuda_env.fused_environment_terms(state, scene, params, snap)
    assert cuda_env.LAUNCHES == dict.fromkeys(cuda_env.LAUNCHES, 0)
    assert sorted(cuda_env.LAUNCHES) == [
        "env_exp", "env_exp_analytic", "env_exp_analytic_batched",
        "env_exp_analytic_compact", "env_exp_analytic_compact_batched",
        "env_exp_batched", "env_exp_compact", "env_exp_compact_batched",
        "env_moussaid", "env_moussaid_batched", "env_moussaid_compact",
        "env_moussaid_compact_batched", "env_moussaid_compact_percrowd",
        "env_moussaid_percrowd"]
    plain = stepper.force_terms(
        state, scene, params, stepper.StepConfig(plain_env_force=True), snap)
    assert sorted(fused) == ["border_force", "dynamic_obstacle_force",
                             "space_repulsive_force", "static_obstacle_force"]
    for name, (fx, fy) in fused.items():   # f32 reduction order only
        torch.testing.assert_close(fx, plain[name][0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(fy, plain[name][1], rtol=1e-6, atol=1e-6)
        assert bool((fx[~state.alive] == 0).all())
    assert bool(fused["border_force"][0].abs().sum() > 0)
    assert bool(fused["dynamic_obstacle_force"][0].abs().sum() > 0)


def test_force_terms_need_a_prepared_scene():
    scene, params, state = env_scene(n=16)
    raw = dataclasses.replace(scene, borders_seg=None)
    with pytest.raises(ValueError, match="prepare_scene"):
        stepper.force_terms(state, raw, params, stepper.StepConfig(), None)
    assert stepper.prepare_scene(scene) is scene          # idempotent
    again = stepper.prepare_scene(raw)
    torch.testing.assert_close(again.borders_seg.x, scene.borders_seg.x)


def test_filter_r2_marks_inactive_segments():
    seg = ppointsets.segment_major(
        pobstacles.build_obstacle_set(*obstacle_geometry(), 7.5), CPU)
    r2 = cuda_env.filter_r2(seg, torch.tensor([True, False]))
    assert r2.tolist() == [56.25, -1.0]


# -- the slice as a whole ----------------------------------------------------------

def assert_records_match(jrec, prec, tol=1e-4):
    np.testing.assert_array_equal(prec.alive.numpy(), np.asarray(jrec.alive))
    np.testing.assert_array_equal(prec.mode.numpy(), np.asarray(jrec.mode))
    err = np.abs(prec.pos.numpy() - np.asarray(jrec.pos)).max(axis=(1, 2))
    assert err.max() <= tol, f"per-step position error {err}"


@pytest.mark.parametrize("config", ["borders", "obstacles"])
def test_benchmark_bundle_configs_match_jax_step_by_step(config):
    """BASELINE configs #2 and #3 at N = 64: the same scene from both
    packages' ``benchmark_bundle`` and the same rollout, step by step.  The
    vehicles' timeline (12 steps) is shorter than the rollout (20), so the
    clamp past its end runs."""
    kw = dict(with_borders=True, with_obstacles=config == "obstacles",
              num_steps_hint=12)
    js, jp, jc, jst = jsyn.benchmark_bundle(64, extent=10.0, use_pallas=False,
                                            **kw)
    ps, pp, pc, pst = psyn.benchmark_bundle(64, extent=10.0, device=CPU, **kw)
    assert_fields_equal(ps.borders, js.borders)
    if config == "obstacles":
        assert_fields_equal(ps.static_obstacles, js.static_obstacles)
        assert_fields_equal(ps.vehicles, js.vehicles)
        np.testing.assert_array_equal(ps.static_obstacle_vel.numpy(),
                                      np.asarray(js.static_obstacle_vel))
    else:
        assert ps.vehicles is None and ps.static_obstacles is None
    assert pp == convert.params_from_fields(fields_of(jp))
    _, jrec = jstepper.make_rollout_fn(js, jp, jc, 20)(jst)
    _, prec = stepper.make_rollout_fn(ps, pp, pc, 20)(pst)
    assert_records_match(jrec, prec)


def corridor_environment_scene(num_steps):
    """A routed corridor whose walkers wait at a curb (CHECKING_TRAFFIC),
    cross a road ahead of or behind scripted vehicles, between borders and
    parked obstacles: every environment term and gap acceptance act."""
    spawners = []
    for k in range(3):
        for (x0, x1) in ((-5.5, 5.5), (5.5, -5.5)):
            y = -4.5 + k * 0.8
            spawners.append(SpawnerSpec(
                spawn_location=np.array([x0, y, 1.0]),
                waypoints=np.array([[x1, y]]), crossing_road=[False],
                speed=1.2 + 0.1 * k, quantity=2, spawn_time=0.3 * k,
                spawn_interval=1.7))
    spawners.append(SpawnerSpec(
        spawn_location=np.array([0.5, -5.0]),
        waypoints=np.array([[0.5, -1.0], [0.5, 4.0], [3.0, 5.0]]),
        crossing_road=[False, True, False], speed=1.4, quantity=3,
        spawn_time=0.0, spawn_interval=0.5))
    schedule = build_spawn_schedule(spawners, DT, num_steps)
    outlines, centers = obstacle_geometry()
    jv, _ = both_vehicle_states(num_steps - 20)
    scene = jstepper.Scene(
        spawn=schedule,
        borders=jborders.build_border_set(*border_geometry()),
        static_obstacles=jobstacles.build_obstacle_set(outlines, centers, 7.5),
        static_obstacle_vel=jnp.zeros((2, 2), jnp.float32), vehicles=jv)
    params = JaxSfmParams(use_ped_radius=True, enable_border=True,
                          enable_static_obstacle=True,
                          enable_dynamic_obstacle=True,
                          enable_space_repulsive=True)
    cfg = jstepper.StepConfig(dt=DT, waypoint_threshold=1.0,
                              despawn_on_arrival=True, use_pallas=False)
    return scene, params, cfg, JaxPedState.empty(schedule.capacity)


def test_converted_environment_scene_matches_jax_step_by_step():
    """A JAX scene with borders, static obstacles, vehicles and a road
    crossing, carried over by utils/convert.py: the two rollouts agree
    step by step, and the crossing walkers go through gap acceptance."""
    num_steps = 120
    js, jp, jc, jst = corridor_environment_scene(num_steps)
    ps = convert.scene_from_fields(fields_of(js), CPU)
    pp = convert.params_from_fields(fields_of(jp))
    pc = convert.step_config_from_fields(fields_of(jc))
    pst = convert.ped_state_from_fields(fields_of(jst), CPU)
    assert_fields_equal(ps.vehicles, js.vehicles)
    _, jrec = jstepper.make_rollout_fn(js, jp, jc, num_steps)(jst)
    _, prec = stepper.make_rollout_fn(ps, pp, pc, num_steps)(pst)
    assert_records_match(jrec, prec)
    seen = set(np.unique(prec.mode.numpy()[prec.alive.numpy()]).tolist())
    assert {jmodes.CHECKING_TRAFFIC, modes.CROSSING_ROAD} <= seen
