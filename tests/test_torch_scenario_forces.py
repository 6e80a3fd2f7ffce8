"""PyTorch port: the chunked environment forces of the scenarios' default
engine (``StepConfig.env_chunked``) against the JAX package's jnp
environment forces and against the port's own segment-major path, and the
stepper's handling of the chunked layout.

The closest points come from ``geometry.closest_point_per_segment`` (its
plain version on the CPU; ``tests/test_torch_scenario_geometry.py`` holds
it against the JAX package); the force math after it is the segment-major
path's, so only the order of the sums over segments differs.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scenario_jax import one_torch_thread  # noqa: F401
from carla_social_force_model_tpu.env import pointsets as jpointsets
from carla_social_force_model_tpu.models import vehicles as jvehicles
from carla_social_force_model_tpu.models.params import (
    SfmParams as JaxSfmParams)
from carla_social_force_model_tpu.ops import forces as jforces
from carla_social_force_model_tpu_torch.api import synthetic as psyn
from carla_social_force_model_tpu_torch.env.pointsets import (
    chunked_on, segment_major)
from carla_social_force_model_tpu_torch.models import stepper
from carla_social_force_model_tpu_torch.models import vehicles as pvehicles
from carla_social_force_model_tpu_torch.models.params import SfmParams
from carla_social_force_model_tpu_torch.ops import forces

CPU = "cpu"
DT = 0.05
#: chunked vs segment-major and vs the JAX package: the same closest
#: points, the sums over segments in another order (test_torch_env.py's)
RTOL = ATOL = 1e-5


def jax_set(pset):
    """The JAX package's ChunkedPointSet of a host-side port set."""
    return jpointsets.ChunkedPointSet(
        points=jnp.asarray(pset.points), valid=jnp.asarray(pset.valid),
        chunk_segment=jnp.asarray(pset.chunk_segment),
        centers=jnp.asarray(pset.centers),
        filter_radius=jnp.asarray(pset.filter_radius),
        num_segments=pset.num_segments)


def walls():
    """Walls around a 12 m box in 5 m sections at 0.1 m, and a cross wall:
    host-side (lines, centers, lengths)."""
    lines, centers, lengths = [], [], []
    for a, b in (((-6, -6), (6, -6)), ((6, -6), (6, 6)), ((6, 6), (-6, 6)),
                 ((-6, 6), (-6, -6)), ((-6, 0.3), (2, 0.3))):
        psyn._wall_sections(lines, centers, lengths, a, b, 5.0)
    return lines, centers, lengths


def crowd(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-6.5, 6.5, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, n).astype(np.float32)
    alive = rng.uniform(size=n) < 0.85
    mode = rng.integers(0, 5, n).astype(np.int32)
    lines = walls()[0]
    pos[0] = np.asarray(lines[0][7], np.float32)   # on a border point
    alive[0], mode[0] = True, 1
    return pos, vel, radius, alive, mode


def vehicles(num_steps):
    """Scripted vehicles for both packages: one spawning late, one leaving
    early (its template stays live with valid False), one from
    waypoints."""
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
    jv = jvehicles.build_vehicle_states(
        [jvehicles.VehicleSpec(**s) for s in specs], DT, num_steps)
    pv = pvehicles.build_vehicle_states(
        [pvehicles.VehicleSpec(**s) for s in specs], DT, num_steps,
        device=CPU)
    return jv, pv


def both_sets():
    from carla_social_force_model_tpu_torch.env import obstacles_gen as pobs
    from carla_social_force_model_tpu_torch.env.borders import (
        build_border_set)
    lines, centers, lengths = walls()
    borders = build_border_set(lines, centers, lengths)
    outlines = [pobs.ellipse_outline((1.5, 2.0), (2.4, 1.1), 0.3, 0.1),
                pobs.rectangle_outline((-3.0, -3.5), (0.8, 0.5), 1.1, 0.1)]
    obstacles = pobs.build_obstacle_set(
        outlines, [np.array([1.5, 2.0]), np.array([-3.0, -3.5])], 20.0)
    return borders, obstacles


def assert_force_close(got, want):
    got = np.stack([g.numpy() for g in got], -1)
    want = np.asarray(want)
    err = np.abs(got - want)
    assert np.all(err <= ATOL + RTOL * np.abs(want)), err.max()


@pytest.mark.parametrize("use_radius", [False, True])
def test_chunked_forces_match_jax(use_radius):
    """border_force, space_repulsive_force and obstacle_force (the static
    obstacles, and the vehicles of a snapshot with ``obstacle_active``)
    on chunked sets against the JAX package's jnp forces."""
    borders, obstacles = both_sets()
    pos, vel, radius, alive, mode = crowd(160, seed=5)
    jp, pp = JaxSfmParams(), SfmParams()
    pos_j, vel_j = jnp.asarray(pos), jnp.asarray(vel)
    rad_j, alive_j, mode_j = (jnp.asarray(a) for a in (radius, alive, mode))
    px, py, vx, vy, rad, al, md = (torch.from_numpy(np.ascontiguousarray(a))
                                   for a in (pos[:, 0], pos[:, 1], vel[:, 0],
                                             vel[:, 1], radius, alive, mode))
    bset, oset = chunked_on(borders, CPU), chunked_on(obstacles, CPU)
    assert_force_close(
        forces.border_force_chunked(px, py, md, rad, al, bset, pp.border,
                                    use_ped_radius=use_radius),
        jforces.border_force(pos_j, mode_j, rad_j, alive_j, jax_set(borders),
                             jp.border, use_ped_radius=use_radius))
    assert_force_close(
        forces.space_repulsive_force_chunked(px, py, md, al, bset,
                                             pp.space_repulsive),
        jforces.space_repulsive_force(pos_j, mode_j, alive_j,
                                      jax_set(borders), jp.space_repulsive))
    zeros = np.zeros((obstacles.num_segments, 2), np.float32)
    assert_force_close(
        forces.obstacle_force_chunked(px, py, vx, vy, rad, al, oset,
                                      torch.from_numpy(zeros),
                                      pp.static_obstacle,
                                      use_ped_radius=use_radius),
        jforces.obstacle_force(pos_j, vel_j, rad_j, alive_j,
                               jax_set(obstacles), jnp.asarray(zeros),
                               jp.static_obstacle,
                               use_ped_radius=use_radius))
    jv, pv = vehicles(40)
    for t in (3, 15, 30):    # before, during and after the despawn
        jset, jvel, jact = jvehicles.snapshot_pointset(
            jvehicles.vehicle_snapshot_at(jv, t),
            jp.dynamic_obstacle.perception_threshold)
        vset, vvel, vact = pvehicles.snapshot_pointset(
            pvehicles.vehicle_snapshot_at(pv, t),
            pp.dynamic_obstacle.perception_threshold)
        assert_force_close(
            forces.obstacle_force_chunked(
                px, py, vx, vy, rad, al, vset, vvel, pp.dynamic_obstacle,
                use_ped_radius=use_radius, obstacle_active=vact),
            jforces.obstacle_force(pos_j, vel_j, rad_j, alive_j, jset, jvel,
                                   jp.dynamic_obstacle,
                                   use_ped_radius=use_radius,
                                   obstacle_active=jact))


@pytest.mark.parametrize("use_radius", [False, True])
def test_chunked_forces_match_segment_major(use_radius):
    """The two layouts take the same closest points and the same force
    math: the chunked forces equal the segment-major plain path up to the
    order of the sums over segments."""
    borders, obstacles = both_sets()
    pos, vel, radius, alive, mode = crowd(200, seed=6)
    px, py, vx, vy, rad, al = (torch.from_numpy(np.ascontiguousarray(a))
                               for a in (pos[:, 0], pos[:, 1], vel[:, 0],
                                         vel[:, 1], radius, alive))
    p = SfmParams()
    for kind, hset in (("exp", borders), ("moussaid", obstacles)):
        cset, seg = chunked_on(hset, CPU), segment_major(hset, CPU)
        if kind == "exp":
            args = (p.border.a, p.border.b)
            got = forces.env_exp_force_chunked(px, py, rad, al, cset, *args,
                                               use_radius=use_radius)
            want = forces.env_exp_force(px, py, rad, al, seg, *args,
                                        use_radius=use_radius)
        else:
            ov = torch.zeros((hset.num_segments, 2))
            got = forces.env_moussaid_force_chunked(
                px, py, vx, vy, rad, al, cset, ov, p.static_obstacle,
                use_radius=use_radius)
            want = forces.env_moussaid_force(
                px, py, vx, vy, rad, al, seg, ov, p.static_obstacle,
                use_radius=use_radius)
        assert_force_close(got, np.stack([w.numpy() for w in want], -1))
        assert not torch.stack(got)[:, ~al].any()


def test_env_chunked_scene_and_refusals():
    """``prepare_scene(chunked=True)`` builds the chunked sets and no
    segment-major layout, and ``force_terms`` takes them; an unprepared
    scene raises; ``env_chunked`` refuses the fused path's knobs; the
    chunked step equals the fused path's plain step."""
    borders, obstacles = both_sets()
    scene, _, cfg, state = psyn.benchmark_bundle(
        64, extent=6.0, num_steps_hint=10, device=CPU)
    params = SfmParams(enable_static_obstacle=True,
                       enable_space_repulsive=True)
    scene = stepper.Scene(spawn=scene.spawn, borders=borders,
                          static_obstacles=obstacles)
    chunked = dataclasses.replace(cfg, env_chunked=True)
    prepared = stepper.prepare_scene(scene, chunked=True)
    assert prepared.borders_seg is None and prepared.borders_chunked is not None
    assert prepared.static_obstacles_seg is None
    assert stepper.prepare_scene(prepared, chunked=True) is prepared
    with pytest.raises(ValueError, match="chunked layout"):
        stepper.force_terms(state, scene, params, chunked)
    for knob in ("env_analytic", "env_compact"):
        with pytest.raises(ValueError, match="env_chunked"):
            stepper.check_supported(scene, params, dataclasses.replace(
                chunked, **{knob: True}))
    s = state
    for k in range(3):
        s, _ = stepper.simulation_step(s, stepper.prepare_scene(scene), params,
                                       cfg, k)
    got = stepper.force_terms(s, prepared, params, chunked)
    want = stepper.force_terms(s, stepper.prepare_scene(scene), params, cfg)
    assert set(got) == set(want)
    for name in ("border_force", "static_obstacle_force",
                 "space_repulsive_force"):
        assert_force_close(got[name], np.stack([w.numpy()
                                                for w in want[name]], -1))
