"""PyTorch port on an NVIDIA card: the CUDA pair-force and environment-force
kernels (with the cutoff forms of the pair kernels and the compacted forms
of the environment kernels) against their plain PyTorch versions, and the
rollouts through them (the urban slice's too).

Every test here needs a card and skips without one.  This file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.models import stepper
from carla_social_force_model_tpu_torch.models.params import (
    MoussaidParams, moussaid_vector)
from carla_social_force_model_tpu_torch.models import vehicles
from carla_social_force_model_tpu_torch.ops import (cuda_env, cuda_forces,
                                                    env_grid, forces,
                                                    pair_grid)
from carla_social_force_model_tpu_torch.ops.spatial import morton_order

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def crowd_planes(n, seed, device, extent=20.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    vel = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, (n,)).astype(np.float32)
    alive = rng.uniform(size=n) < 0.8
    pos[5] = pos[6]              # a coincident live pair
    alive[5] = alive[6] = True
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], radius,
                      alive)]


@pytest.mark.parametrize("epsilon", [0.005, 0.0])
@pytest.mark.parametrize("use_radius", [False, True])
@pytest.mark.parametrize("n", [1, 130, 1000])
@pytest.mark.parametrize("kernel", ["pair_force_sym", "pair_force_dense"])
def test_kernel_matches_plain_version(cuda_device, kernel, n, use_radius,
                                      epsilon):
    """Each kernel against the plain version on the same card, with dead
    agents and a coincident pair: |err| <= 1e-4 + 1e-4*|f| (f32 summation
    order; the symmetric kernel's atomics vary it from run to run)."""
    planes = crowd_planes(max(n, 7), seed=n, device=cuda_device)
    planes = [t[:n].contiguous() for t in planes]
    p = dataclasses.replace(MoussaidParams(), epsilon=epsilon)
    want = torch.stack(forces.pedestrian_force(*planes, p,
                                               use_ped_radius=use_radius))
    got = torch.stack(getattr(cuda_forces, kernel)(
        *planes, moussaid_vector(p, cuda_device), use_radius=use_radius))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert bool((got[:, ~planes[5]] == 0).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_launch_counts_and_dispatch(cuda_device):
    planes = crowd_planes(300, seed=1, device=cuda_device)
    cuda_forces.reset_launch_counts()
    for symmetric in (True, False, True):
        cuda_forces.pedestrian_force_kernel(*planes, MoussaidParams(),
                                            symmetric=symmetric)
    assert cuda_forces.LAUNCHES == dict(
        dict.fromkeys(cuda_forces.LAUNCHES, 0), pair_force_sym=2,
        pair_force_dense=1)


def test_kernel_rejects_bad_inputs(cuda_device):
    planes = crowd_planes(64, seed=2, device=cuda_device)
    prm = moussaid_vector(MoussaidParams(), cuda_device)
    strided = torch.zeros(128, device=cuda_device)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        cuda_forces.pair_force_sym(strided, *planes[1:], prm)
    with pytest.raises(ValueError, match="prm"):
        cuda_forces.pair_force_dense(*planes, prm.cpu())


def test_rollout_through_kernel_matches_plain_rollout(cuda_device):
    """Twenty steps of a 2,000-agent crowd through the kernel and through
    the plain version on the same card: alive and mode equal, positions
    within 1e-4 m (f32 summation order over a short horizon)."""
    scene, params, cfg, state = benchmark_bundle(2000, device=cuda_device)
    _, plain = stepper.make_rollout_fn(
        scene, params, dataclasses.replace(cfg, plain_pair_force=True),
        20)(state)
    for symmetric in (True, False):
        _, kern = stepper.make_rollout_fn(
            scene, params, dataclasses.replace(cfg, symmetric_pairs=symmetric),
            20)(state)
        assert torch.equal(kern.alive, plain.alive)
        assert torch.equal(kern.mode, plain.mode)
        assert (kern.pos - plain.pos).abs().max().item() <= 1e-4


def env_case(n, seed, device, sort):
    """Config #3's environment (street-grid borders, parked cars, moving
    vehicles at step 5) around a seeded crowd with dead agents, a
    pedestrian on a border point and a 4,501-point wall; the planes in the
    Hilbert order the main path gives the kernels, or unsorted."""
    from carla_social_force_model_tpu_torch.api import synthetic
    from carla_social_force_model_tpu_torch.env.pointsets import (
        _per_segment_points, build_chunked_pointset, segment_major)
    extent = 30.0
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    vel = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, n).astype(np.float32)
    alive = rng.uniform(size=n) < 0.85
    borders = synthetic.synthetic_borders(extent)
    pos[0] = borders.points[0, 3]
    alive[0] = True
    long_wall = np.column_stack([np.linspace(-225, 225, 4501),
                                 np.full(4501, 0.35)])
    border_rows = build_chunked_pointset(
        [long_wall] + _per_segment_points(borders),
        np.vstack([[0.0, 0.35], borders.centers]),
        np.concatenate([[450.0], borders.filter_radius]))
    statics = synthetic.synthetic_obstacles(extent)
    vstates = synthetic.synthetic_vehicles(extent, 8, 0.05, 40,
                                           device=device)
    snap = vehicles.vehicle_snapshot_at(vstates, 5)
    dyn, dvel, dact = vehicles.snapshot_segment_pointset(snap, 50.0)
    planes = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], radius,
                        alive)]
    if sort:
        perm, _ = morton_order(planes[0], planes[1], planes[5], "hilbert")
        planes = [a[perm].contiguous() for a in planes]
    seg_statics = segment_major(statics, device)
    return planes, {
        "borders": (segment_major(border_rows, device), None, None),
        "statics": (seg_statics,
                    torch.zeros((seg_statics.num_segments, 2),
                                device=device), None),
        "vehicles": (dyn, dvel.contiguous(), dact)}


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("use_radius", [False, True])
@pytest.mark.parametrize("n", [1, 130, 3000])
@pytest.mark.parametrize("kernel,sets", [("env_exp", "borders"),
                                         ("env_moussaid", "statics"),
                                         ("env_moussaid", "vehicles")])
def test_env_kernel_matches_plain_version(cuda_device, kernel, sets, n,
                                          use_radius, sort):
    """Each environment kernel against its plain version on the same card:
    |err| <= 1e-5 + 1e-5*|f|.  Both select the same closest point and the
    same filter outcome (squared distances rounded after every operation
    on both sides); the rest is last-ulp differences of rsqrt, exp, atan2
    and the division, and f32 summation order.  Dead agents get exactly 0."""
    planes, env = env_case(max(n, 2), seed=n, device=cuda_device, sort=sort)
    planes = [t[:n].contiguous() for t in planes]
    px, py, vx, vy, rad, alive = planes
    seg, ovel, active = env[sets]
    if kernel == "env_exp":
        args = (px, py, rad, alive, seg, 3.0, 0.1)
        want = forces.env_exp_force(*args, use_radius=use_radius)
        got = cuda_env.env_exp(*args, use_radius=use_radius)
    else:
        args = (px, py, vx, vy, rad, alive, seg, ovel, MoussaidParams())
        want = forces.env_moussaid_force(*args, use_radius=use_radius,
                                         active=active)
        got = cuda_env.env_moussaid(*args, use_radius=use_radius,
                                    active=active)
    torch.cuda.synchronize()
    got, want = torch.stack(got), torch.stack(want)
    assert torch.isfinite(got).all()
    assert bool((got[:, ~alive] == 0).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_env_launch_counts_and_fused_terms(cuda_device):
    """One launch per environment term and step, and the fused terms (one
    sort, crossing agents zeroed) equal the plain force terms."""
    scene, params, cfg, state = benchmark_bundle(
        3000, with_borders=True, with_obstacles=True, num_steps_hint=20,
        device=cuda_device)
    params = dataclasses.replace(params, enable_space_repulsive=True,
                                 use_ped_radius=True)
    scene = stepper.prepare_scene(scene)
    state, _ = stepper.rollout(state, scene, params, cfg, 3, record=False)
    rng = np.random.default_rng(0)
    mode = torch.from_numpy(rng.integers(0, 5, 3000).astype(np.int32))
    state = dataclasses.replace(state, mode=mode.to(cuda_device))
    snap = vehicles.vehicle_snapshot_at(scene.vehicles, 3)
    cuda_env.reset_launch_counts()
    fused = cuda_env.fused_environment_terms(state, scene, params, snap)
    assert cuda_env.LAUNCHES == dict(dict.fromkeys(cuda_env.LAUNCHES, 0),
                                     env_exp=2, env_moussaid=2)
    plain = stepper.force_terms(
        state, scene, params, dataclasses.replace(cfg, plain_env_force=True),
        snap)
    for name, (fx, fy) in fused.items():
        torch.testing.assert_close(torch.stack((fx, fy)),
                                   torch.stack(plain[name]),
                                   rtol=1e-5, atol=1e-5)


def test_env_kernel_rejects_bad_inputs(cuda_device):
    planes, env = env_case(64, seed=3, device=cuda_device, sort=False)
    px, py, vx, vy, rad, alive = planes
    seg = env["borders"][0]
    with pytest.raises(ValueError, match="contiguous"):
        cuda_env.env_exp(torch.zeros(128, device=cuda_device)[::2], py, rad,
                         alive, seg, 3.0, 0.1)
    cpu_seg = dataclasses.replace(seg, x=seg.x.cpu())
    with pytest.raises(ValueError, match="segment x"):
        cuda_env.env_exp(px, py, rad, alive, cpu_seg, 3.0, 0.1)


@pytest.mark.parametrize("with_obstacles", [False, True])
def test_env_rollout_through_kernels_matches_plain_rollout(cuda_device,
                                                           with_obstacles):
    """Configs #2 and #3 at N = 2,000, twenty steps through the kernels and
    through the plain versions on the same card: alive and mode equal,
    positions within 1e-4 m, and the launch counts of the path."""
    scene, params, cfg, state = benchmark_bundle(
        2000, with_borders=True, with_obstacles=with_obstacles,
        num_steps_hint=20, device=cuda_device)
    _, plain = stepper.make_rollout_fn(
        scene, params, dataclasses.replace(cfg, plain_pair_force=True,
                                           plain_env_force=True), 20)(state)
    cuda_env.reset_launch_counts()
    _, kern = stepper.make_rollout_fn(scene, params, cfg, 20)(state)
    assert cuda_env.LAUNCHES == dict(
        dict.fromkeys(cuda_env.LAUNCHES, 0), env_exp=20,
        env_moussaid=40 if with_obstacles else 0)
    assert torch.equal(kern.alive, plain.alive)
    assert torch.equal(kern.mode, plain.mode)
    assert (kern.pos - plain.pos).abs().max().item() <= 1e-4


def cutoff_case(n, seed, device):
    """A seeded crowd at 0.25 agents/m^2 (half-width sqrt(n)), in the
    Hilbert order the cutoff path gives the kernels."""
    planes = crowd_planes(max(n, 7), seed, device, extent=float(np.sqrt(n)))
    planes = [t[:n].contiguous() for t in planes]
    perm, _ = morton_order(planes[0], planes[1], planes[5], "hilbert")
    return [t[perm].contiguous() for t in planes]


def cutoff_run(planes, grid, use_radius=False):
    prm = moussaid_vector(MoussaidParams(), planes[0].device)
    return torch.stack(cuda_forces.pair_force_cutoff(
        *planes, prm, grid, use_radius=use_radius))


@pytest.mark.parametrize("use_radius", [False, True])
@pytest.mark.parametrize("n", [1, 130, 3000, 20000])
@pytest.mark.parametrize("symmetric,compact,max_surv", [
    (True, False, 0), (True, True, 8), (True, True, 1),
    (False, False, 0), (False, True, 8), (False, True, 1)])
def test_cutoff_kernels_match_plain_version(cuda_device, symmetric, compact,
                                            max_surv, n, use_radius):
    """Each cutoff kernel (static grid with the box test, survivor table
    that fits or overflows) against the plain version with a 10 m cutoff:
    |err| <= 1e-4 + 1e-4*|f| (f32 summation order; the per-pair cutoff
    decides alike on both sides, its squared distance rounded the same)."""
    planes = cutoff_case(n, seed=n + 5, device=cuda_device)
    grid = pair_grid.cutoff_grid(planes[0], planes[1], planes[5], 10.0,
                                 symmetric=symmetric, compact=compact,
                                 max_surv=max_surv)
    want = torch.stack(forces.pedestrian_force(
        *planes, MoussaidParams(), use_ped_radius=use_radius, cutoff=10.0))
    got = cutoff_run(planes, grid, use_radius)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert bool((got[:, ~planes[5]] == 0).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [3000, 20000])
def test_compact_kernel_equals_dense_cutoff_kernel_bitwise(cuda_device, n):
    """The compacted kernel walks the same tiles in the same order as the
    dense cutoff kernel and sums them alike: equal bitwise, with a table
    that fits and with one slot (every row overflows)."""
    planes = cutoff_case(n, seed=3, device=cuda_device)
    x, y, alive = planes[0], planes[1], planes[5]
    dense = pair_grid.cutoff_grid(x, y, alive, 30.0, symmetric=False,
                                  compact=False)
    want = cutoff_run(planes, dense)
    for max_surv in (dense.boxes.shape[1] - 1, 1):
        grid = pair_grid.cutoff_grid(x, y, alive, 30.0, symmetric=False,
                                     max_surv=max_surv)
        assert grid.form == "compact"
        assert torch.equal(cutoff_run(planes, grid), want)


def test_f32_exact_cutoff_equals_the_dense_kernel_bitwise(cuda_device):
    """At a cutoff >= 110*gamma*(2*lambda*v_max + 1) every skipped pair's
    exponential underflows to +0, so the dense cutoff kernel equals the
    no-cutoff dense kernel bitwise."""
    planes = cutoff_case(40000, seed=4, device=cuda_device)
    p = MoussaidParams()
    v_max = torch.sqrt(planes[2] ** 2 + planes[3] ** 2).max().item()
    exact = float(np.ceil(110 * p.gamma * (2 * p.lambda_ * v_max + 1)))
    grid = pair_grid.cutoff_grid(planes[0], planes[1], planes[5], exact,
                                 symmetric=False, compact=False)
    want = torch.stack(cuda_forces.pair_force_dense(
        *planes, moussaid_vector(p, cuda_device)))
    assert torch.equal(cutoff_run(planes, grid), want)


@pytest.mark.parametrize("symmetric", [True, False])
def test_cutoff_rollout_through_kernels_matches_plain_rollout(cuda_device,
                                                              symmetric):
    """Twenty steps of a 3,000-agent crowd with a 30 m cutoff, the table
    forced by an explicit width, through the kernels and through the plain
    version: alive and mode equal, positions within 1e-4 m, one launch of
    the compacted kernel per step and none of another pair kernel."""
    scene, params, cfg, state = benchmark_bundle(3000, device=cuda_device)
    cfg = dataclasses.replace(cfg, interaction_cutoff=30.0, pair_max_surv=8,
                              symmetric_pairs=symmetric)
    _, plain = stepper.make_rollout_fn(
        scene, params, dataclasses.replace(cfg, plain_pair_force=True),
        20)(state)
    cuda_forces.reset_launch_counts()
    _, kern = stepper.make_rollout_fn(scene, params, cfg, 20)(state)
    name = "pair_force_sym_compact" if symmetric else "pair_force_compact"
    assert cuda_forces.LAUNCHES == dict(
        dict.fromkeys(cuda_forces.LAUNCHES, 0), **{name: 20})
    assert torch.equal(kern.alive, plain.alive)
    assert torch.equal(kern.mode, plain.mode)
    assert (kern.pos - plain.pos).abs().max().item() <= 1e-4


def env_compact_run(kernel, planes, seg, ovel, active, grid, use_radius):
    px, py, vx, vy, rad, alive = planes
    if kernel == "env_exp":
        args = (px, py, rad, alive, seg, 3.0, 0.1)
    else:
        args = (px, py, vx, vy, rad, alive, seg, ovel, MoussaidParams())
    if grid is None:
        out = getattr(cuda_env, kernel)(*args, use_radius=use_radius,
                                        active=active)
    else:
        out = getattr(cuda_env, kernel + "_compact")(
            *args, grid, use_radius=use_radius, active=active)
    return torch.stack(out)


def env_compact_grids(planes, seg, active):
    """The table of the widest block (the compact walk) and one slot
    (every block with two or more groups overflows)."""
    px, py, alive = planes[0], planes[1], planes[5]
    r2 = cuda_env.filter_r2(seg, active)
    hits = env_grid.group_hits(env_grid.block_boxes(px, py, alive),
                               seg.center_x, seg.center_y, r2, 8)
    widest = max(int(hits.sum(dim=1).max()), 1)
    return [env_grid.env_grid(px, py, alive, seg, r2, 8, ms)
            for ms in (widest, 1)]


@pytest.mark.parametrize("use_radius", [False, True])
@pytest.mark.parametrize("n", [1, 130, 3000])
@pytest.mark.parametrize("kernel,sets", [("env_exp", "borders"),
                                         ("env_moussaid", "statics"),
                                         ("env_moussaid", "vehicles")])
def test_env_compact_kernel_matches_plain_and_dense(cuda_device, kernel, sets,
                                                    n, use_radius):
    """Each compacted environment kernel, on Hilbert-sorted planes with a
    table that fits and with one slot: within 1e-5 + 1e-5*|f| of the plain
    version, and equal to the dense kernel bitwise (the same sections in
    the same order); dead agents get exactly 0."""
    planes, env = env_case(max(n, 2), seed=n + 1, device=cuda_device,
                           sort=True)
    planes = [t[:n].contiguous() for t in planes]
    seg, ovel, active = env[sets]
    dense = env_compact_run(kernel, planes, seg, ovel, active, None,
                            use_radius)
    px, py, vx, vy, rad, alive = planes
    if kernel == "env_exp":
        want = torch.stack(forces.env_exp_force(
            px, py, rad, alive, seg, 3.0, 0.1, use_radius=use_radius))
    else:
        want = torch.stack(forces.env_moussaid_force(
            px, py, vx, vy, rad, alive, seg, ovel, MoussaidParams(),
            use_radius=use_radius, active=active))
    for grid in env_compact_grids(planes, seg, active):
        got = env_compact_run(kernel, planes, seg, ovel, active, grid,
                              use_radius)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert bool((got[:, ~alive] == 0).all())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, dense), grid.max_surv


def test_env_compact_launch_counts_and_bad_tables(cuda_device):
    planes, env = env_case(300, seed=4, device=cuda_device, sort=True)
    seg = env["borders"][0]
    grid, _ = env_compact_grids(planes, seg, None)
    px, py, _, _, rad, alive = planes
    cuda_env.reset_launch_counts()
    cuda_env.env_exp_compact(px, py, rad, alive, seg, 3.0, 0.1, grid)
    assert cuda_env.LAUNCHES == dict(dict.fromkeys(cuda_env.LAUNCHES, 0),
                                     env_exp_compact=1)
    with pytest.raises(ValueError, match="survivor table surv"):
        cuda_env.env_exp_compact(px, py, rad, alive, seg, 3.0, 0.1,
                                 grid._replace(surv=grid.surv.long()))
    with pytest.raises(ValueError, match="survivor table counts"):
        cuda_env.env_exp_compact(px, py, rad, alive, seg, 3.0, 0.1,
                                 grid._replace(counts=grid.counts[:1]))


@pytest.mark.parametrize("config", ["urban", "obstacles"])
def test_compact_rollout_through_kernels_matches_plain_rollout(cuda_device,
                                                               config):
    """Twenty steps through the kernels and through the plain versions on
    the same card: the urban bundle at N = 2,000 (its compacted border
    kernel, the fleet's dense obstacle kernel) and config #3 with
    ``env_compact`` (compacted border and parked-car kernels): alive and
    mode equal, positions within 1e-4 m, and the launch counts."""
    from carla_social_force_model_tpu_torch.api.synthetic import urban_bundle
    if config == "urban":
        scene, params, cfg, state = urban_bundle(2000, num_steps_hint=20,
                                                 device=cuda_device)
        expect = dict(env_exp_compact=20, env_moussaid=20)
    else:
        scene, params, cfg, state = benchmark_bundle(
            2000, with_borders=True, with_obstacles=True, num_steps_hint=20,
            device=cuda_device)
        cfg = dataclasses.replace(cfg, env_compact=True, env_max_surv=2)
        expect = dict(env_exp_compact=20, env_moussaid_compact=20,
                      env_moussaid=20)
    _, plain = stepper.make_rollout_fn(
        scene, params, dataclasses.replace(cfg, plain_pair_force=True,
                                           plain_env_force=True), 20)(state)
    cuda_env.reset_launch_counts()
    _, kern = stepper.make_rollout_fn(scene, params, cfg, 20)(state)
    assert cuda_env.LAUNCHES == dict(dict.fromkeys(cuda_env.LAUNCHES, 0),
                                     **expect)
    if config == "urban":
        plain, kern = plain[0], kern[0]
    assert torch.equal(kern.alive, plain.alive)
    assert torch.equal(kern.mode, plain.mode)
    assert (kern.pos - plain.pos).abs().max().item() <= 1e-4
