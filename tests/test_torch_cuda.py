"""PyTorch port on an NVIDIA card: the CUDA pair-force and environment-force
kernels (with the cutoff forms of the pair kernels, their power-law and
Helbing forms, the compacted forms of the environment kernels and the
analytic form of the border kernel), the ORCA wall-feed kernels, the
chunk scan of the chunked environment forces, and the agent-sharding
kernels (the rectangular forms of the dense kernels, the full-block kernel
and the in-kernel ring) against their plain PyTorch versions, and the
rollouts through them (the urban slice's, the model families', the ORCA
slice's, a scenario's and the sharded schedules' too).

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
    MoussaidParams, PedRepulsiveParams, PowerLawParams, moussaid_vector)
from carla_social_force_model_tpu_torch.models import vehicles
from carla_social_force_model_tpu_torch.ops import (cuda_env, cuda_forces,
                                                    env_grid, forces,
                                                    pair_grid)
from carla_social_force_model_tpu_torch.ops.spatial import morton_order
from family_cases import family_planes, family_reference, family_run
from orca_cases import (ENV_ATOL, ENV_RTOL, analytic_run, feed_mismatch,
                        feed_run, feed_scene)
from shard_cases import (law_params, rect_case, ring_case, shard_planes,
                         split, sym_dense_case)
from scenario_cases import (chunk_scan_pair, chunked_on, closest_mismatches,
                            closest_pair, scan_mismatches, seeded_chunk_set,
                            seeded_crowd_planes, to_device)

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


@pytest.mark.parametrize("kernel", ["pair_force_sym", "pair_force_dense"])
def test_kernel_matches_plain_version_on_stacked_starts(cuda_device, kernel):
    """Agents that spawned on the same point and took one step apart sit on
    the branch cut of the force's atan2 (t_hat anti-parallel to e, cross
    exactly 0 for many pairs), where the tangential term flips with the
    sign of cross: the kernels round cross and dot per operation, with the
    rsqrtf that PyTorch's rsqrt uses, so both take the same side
    (|err| <= 1e-4 + 1e-4*|f|; with FMA-contracted math 44 elements of
    these eight crowds were off by up to 4.8)."""
    p = MoussaidParams()
    for seed in range(8):
        rng = np.random.default_rng(seed)
        n_nodes, per_node = 64, 24
        nodes = rng.uniform(-30, 30, (n_nodes, 2)).astype(np.float32)
        heading = rng.uniform(-np.pi, np.pi, (n_nodes, per_node))
        speed = rng.uniform(1.0, 1.6, (n_nodes, per_node))
        vel = np.stack([speed * np.cos(heading), speed * np.sin(heading)],
                       -1).reshape(-1, 2).astype(np.float32)
        start = torch.from_numpy(np.repeat(nodes, per_node, axis=0)).to(
            cuda_device)
        v = torch.from_numpy(vel).to(cuda_device)
        pos = start + 0.05 * v                  # one Euler step apart
        n = pos.shape[0]
        planes = [pos[:, 0].contiguous(), pos[:, 1].contiguous(),
                  v[:, 0].contiguous(), v[:, 1].contiguous(),
                  torch.full((n,), 0.3, device=cuda_device),
                  torch.ones(n, dtype=torch.bool, device=cuda_device)]
        want = torch.stack(forces.pedestrian_force(*planes, p))
        got = torch.stack(getattr(cuda_forces, kernel)(
            *planes, moussaid_vector(p, cuda_device)))
        torch.cuda.synchronize()
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


# -- the model families: the power-law and Helbing forms of the pair kernels --

def assert_family_close(law, got, planes, cutoff=None):
    """Within the shared limit of the plain version (``family_cases.ATOL``),
    finite, dead rows exactly 0."""
    want, limit = family_reference(law, planes, cutoff)
    assert torch.isfinite(got).all()
    assert bool((got[:, ~planes[5]] == 0).all())
    err = (got - want).abs()
    assert bool((err <= limit).all()), err.max().item()


@pytest.mark.parametrize("n", [1, 130, 1000])
@pytest.mark.parametrize("law,form", [("powerlaw", "sym"),
                                      ("powerlaw", "dense"),
                                      ("helbing", "dense")])
def test_family_kernel_matches_plain_version(cuda_device, law, form, n):
    planes = family_planes(n, seed=n + 11, device=cuda_device, extent=20.0)
    got = family_run(law, planes, form)
    torch.cuda.synchronize()
    assert_family_close(law, got, planes)


@pytest.mark.parametrize("n", [130, 3000, 20000])
@pytest.mark.parametrize("law,symmetric,compact,max_surv", [
    ("powerlaw", True, False, 0), ("powerlaw", True, True, 8),
    ("powerlaw", True, True, 1), ("powerlaw", False, False, 0),
    ("powerlaw", False, True, 8), ("powerlaw", False, True, 1),
    ("helbing", False, False, 0), ("helbing", False, True, 8),
    ("helbing", False, True, 1)])
def test_family_cutoff_kernels_match_plain_version(cuda_device, law,
                                                   symmetric, compact,
                                                   max_surv, n):
    """Each cutoff form of each family law (static grid with the box test,
    survivor table that fits or overflows) against the plain version with
    a 10 m cutoff, on Hilbert-sorted planes at 0.25 agents/m^2."""
    planes = family_planes(n, seed=n + 3, device=cuda_device,
                           extent=float(np.sqrt(n)), sort=True)
    grid = pair_grid.cutoff_grid(planes[0], planes[1], planes[5], 10.0,
                                 symmetric=symmetric, compact=compact,
                                 max_surv=max_surv)
    got = family_run(law, planes, grid.form, grid)
    torch.cuda.synchronize()
    assert_family_close(law, got, planes, cutoff=10.0)


@pytest.mark.parametrize("law", ["powerlaw", "helbing"])
def test_family_compact_equals_dense_cutoff_bitwise(cuda_device, law):
    planes = family_planes(20000, seed=8, device=cuda_device,
                           extent=float(np.sqrt(20000)), sort=True)
    x, y, alive = planes[0], planes[1], planes[5]
    dense = pair_grid.cutoff_grid(x, y, alive, 30.0, symmetric=False,
                                  compact=False)
    want = family_run(law, planes, "dense_cutoff", dense)
    for max_surv in (dense.boxes.shape[1] - 1, 1):
        grid = pair_grid.cutoff_grid(x, y, alive, 30.0, symmetric=False,
                                     max_surv=max_surv)
        assert grid.form == "compact"
        assert torch.equal(family_run(law, planes, "compact", grid), want)


def test_family_launch_counts_dispatch_and_checks(cuda_device):
    """One launch per call under each law's name; Helbing launches the
    dense kernel whatever ``symmetric`` says; a parameter vector of another
    law's length is refused."""
    planes = family_planes(300, seed=1, device=cuda_device)
    x, y, vx, vy, rad, alive, ex, ey = planes
    cuda_forces.reset_launch_counts()
    for symmetric in (True, False, True):
        cuda_forces.pedestrian_force_kernel(x, y, vx, vy, rad, alive,
                                            PowerLawParams(), law="powerlaw",
                                            symmetric=symmetric)
        cuda_forces.pedestrian_force_kernel(x, y, vx, vy, None, alive,
                                            PedRepulsiveParams(),
                                            law="helbing", desired=(ex, ey),
                                            symmetric=symmetric)
    assert cuda_forces.LAUNCHES == dict(
        dict.fromkeys(cuda_forces.LAUNCHES, 0), powerlaw_sym=2,
        powerlaw_dense=1, helbing_dense=3)
    with pytest.raises(ValueError, match="prm"):
        cuda_forces.pair_force_dense(x, y, vx, vy, rad, alive,
                                     moussaid_vector(MoussaidParams(),
                                                     cuda_device),
                                     law="powerlaw")


@pytest.mark.parametrize("switch,cutoff", [
    ("powerlaw", None), ("helbing", None),
    ("mix-moussaid-powerlaw-helbing", None), ("groups-0.5:4", None),
    ("powerlaw", 30.0), ("mix-moussaid-powerlaw-helbing", 10.0)])
def test_family_steps_through_kernels_match_plain_steps(cuda_device, switch,
                                                        cutoff):
    """The bench.py family scenes at N = 2,000: twenty steps through the
    kernels, each against the same step through the plain versions from
    the kernels' own state: positions within 1e-4 m, modes and alive
    equal; and the launches of the path."""
    from carla_social_force_model_tpu_torch.models import groups
    from carla_social_force_model_tpu_torch.models.spawn import LAW_IDS
    scene, params, cfg, state = benchmark_bundle(2000, device=cuda_device)
    n = 2000
    if switch in ("powerlaw", "helbing"):
        flag = ("enable_powerlaw" if switch == "powerlaw"
                else "enable_ped_repulsive")
        params = dataclasses.replace(params, enable_pedestrian=False,
                                     **{flag: True})
    elif switch.startswith("mix-"):
        law = np.full(n, -1, np.int32)
        for fam, chunk in zip(("moussaid", "powerlaw", "helbing"),
                              np.array_split(np.arange(n), 3)):
            law[chunk] = LAW_IDS[fam]
        scene = dataclasses.replace(scene, spawn=dataclasses.replace(
            scene.spawn, law_id=torch.from_numpy(law).to(cuda_device)))
        params = dataclasses.replace(params, enable_powerlaw=True,
                                     enable_ped_repulsive=True)
    else:
        gid = np.full(n, -1, np.int32)
        gid[:n // 2] = np.arange(n // 2) // 4
        scene = dataclasses.replace(scene, groups=groups.build_groups(
            gid, max_members=4, device=cuda_device))
        params = dataclasses.replace(params, enable_group=True)
    cfg = dataclasses.replace(cfg, interaction_cutoff=cutoff)
    ref_cfg = dataclasses.replace(cfg, plain_pair_force=True)
    scene = stepper.prepare_scene(scene)
    cuda_forces.reset_launch_counts()
    s = state
    for k in range(20):
        nxt, _ = stepper.simulation_step(s, scene, params, cfg, k)
        ref, _ = stepper.simulation_step(s, scene, params, ref_cfg, k)
        assert torch.equal(nxt.alive, ref.alive)
        assert torch.equal(nxt.mode, ref.mode)
        err = max((nxt.pos_x - ref.pos_x).abs().max().item(),
                  (nxt.pos_y - ref.pos_y).abs().max().item())
        assert err <= 1e-4, (k, err)
        s = nxt
    launched = {k: v for k, v in cuda_forces.LAUNCHES.items() if v}
    form = ("sym" if cutoff is None else "sym_cutoff")
    dense = ("dense" if cutoff is None else "dense_cutoff")
    expect = {"powerlaw": {f"powerlaw_{form}": 20},
              "helbing": {f"helbing_{dense}": 20},
              "groups-0.5:4": {f"pair_force_{form}": 20}}.get(
        switch, {f"pair_force_{form}": 20, f"powerlaw_{form}": 20,
                 f"helbing_{dense}": 20})
    assert launched == expect


# -- the ORCA slice: the analytic border kernel and the wall feed ---------------

@pytest.mark.parametrize("use_radius", [False, True])
@pytest.mark.parametrize("n", [1, 130, 3000])
def test_analytic_env_kernel_matches_plain_and_dense(cuda_device, n,
                                                     use_radius):
    """The analytic border kernel on config #3's borders (Hilbert-sorted,
    10% dead) against its plain version, and its compacted form with the
    auto table, a fitting one and one slot equal to it bitwise."""
    scene, params, planes = feed_scene(n, cuda_device)
    geom, b = scene.borders_geom, params.border
    want = analytic_run(planes, geom, b.a, b.b, use_radius, plain=True)
    dense = analytic_run(planes, geom, b.a, b.b, use_radius)
    torch.cuda.synchronize()
    assert torch.isfinite(dense).all()
    assert bool((dense[:, ~planes[5]] == 0).all())
    assert bool(((dense - want).abs() <= ENV_ATOL + ENV_RTOL * want.abs())
                .all())
    r2 = cuda_env.filter_r2(geom)
    _, group, ms = env_grid.env_gate(geom.num_segments, geom.max_segments,
                                     True, 0)
    x, y, alive = planes[0], planes[1], planes[5]
    hits = env_grid.group_hits(env_grid.block_boxes(x, y, alive),
                               geom.center_x, geom.center_y, r2, group)
    for width in (ms, max(int(hits.sum(dim=1).max()), 1), 1):
        grid = env_grid.env_grid(x, y, alive, geom, r2, group, width)
        got = analytic_run(planes, geom, b.a, b.b, use_radius, grid=grid)
        torch.cuda.synchronize()
        assert torch.equal(got, dense), width


@pytest.mark.parametrize("use_alive", [True, False])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("kind", ["seg_topk", "chunk_topk",
                                  "chunk_closest"])
def test_feed_kernels_match_plain_version_bitwise(cuda_device, kind, k,
                                                  use_alive):
    """Each wall-feed kernel on config #3's sets at N = 3,000 (the border
    segment features, the parked cars' chunks) against its plain version:
    d2, the points and the selection equal bitwise on every row its boxes
    hold (the alive rows with ``alive``, else all)."""
    if kind == "chunk_closest" and k != 1:
        pytest.skip("chunk_closest keeps every chunk (no k)")
    scene, _, planes = feed_scene(3000, cuda_device)
    src = (scene.borders_feat.seg if kind == "seg_topk"
           else scene.obstacles_feat.rest)
    got = feed_run(kind, planes, src, k, use_alive=use_alive)
    want = feed_run(kind, planes, src, k, plain=True)
    torch.cuda.synchronize()
    rows = planes[5] if use_alive else torch.ones_like(planes[5])
    assert feed_mismatch(kind, got, want, rows) == 0
    assert bool(torch.isfinite(want[0][..., planes[5]]).any())


@pytest.mark.parametrize("k", [2, 8])
def test_feed_kernels_keep_tie_order(cuda_device, k):
    """Every feature twice (exact ties in d2 and the point): the kernels
    keep the lower index first among equals, as k_smallest_features does,
    so the selection equals the plain version's bitwise."""
    from carla_social_force_model_tpu_torch.env.pointsets import (
        ChunkFeatures, SegmentFeatures)
    scene, _, planes = feed_scene(1000, cuda_device)
    seg, cars = scene.borders_feat.seg, scene.obstacles_feat.rest
    twice = lambda src, cls: cls(*(torch.cat([getattr(src, f.name)] * 2)
                                   for f in dataclasses.fields(cls)))
    for kind, src in (("seg_topk", twice(seg, SegmentFeatures)),
                      ("chunk_topk", twice(cars, ChunkFeatures))):
        got = feed_run(kind, planes, src, k)
        want = feed_run(kind, planes, src, k, plain=True)
        torch.cuda.synchronize()
        assert feed_mismatch(kind, got, want, planes[5]) == 0, kind


def test_feed_launch_counts_and_checks(cuda_device):
    from carla_social_force_model_tpu_torch.ops import geometry, statics
    scene, _, planes = feed_scene(500, cuda_device)
    seg, rest = scene.borders_feat.seg, scene.obstacles_feat.rest
    x, y, alive = planes[0], planes[1], planes[5]
    statics.reset_launch_counts()
    statics.nearest_features_topk(x, y, seg, 3, 15.0, alive)
    statics.nearest_features_topk(x, y, rest, 3, 15.0, alive)
    geometry.closest_point_per_chunk(x, y, rest, 15.0, alive)
    assert statics.LAUNCHES == {"seg_topk": 1, "chunk_topk": 1,
                                "chunk_closest": 1, "chunk_argmin": 0}
    with pytest.raises(ValueError, match="k must be"):
        statics.seg_topk(x, y, seg, 9, 15.0)
    with pytest.raises(ValueError, match="contiguous float32"):
        statics.seg_topk(x[::2], y[::2], seg, 3, 15.0)
    with pytest.raises(ValueError, match="CUDA"):
        statics.chunk_topk(x.cpu(), y.cpu(), rest, 3, 15.0)
    assert statics.LAUNCHES["seg_topk"] == 1


def test_orca_steps_through_kernels_match_plain_steps(cuda_device):
    """Config #3 with ORCA and the analytic tier at N = 2,000 (window 64 <
    N): twenty steps through the kernels, each against the same step
    through the plain versions from the kernels' own state: positions
    within 1e-4 m, modes and alive equal; and the launches of the path."""
    from carla_social_force_model_tpu_torch.ops import statics
    scene, params, cfg, state = benchmark_bundle(
        2000, with_borders=True, with_obstacles=True, num_steps_hint=20,
        device=cuda_device)
    params = dataclasses.replace(params, enable_pedestrian=False,
                                 enable_orca=True)
    cfg = dataclasses.replace(cfg, env_analytic=True)
    ref_cfg = dataclasses.replace(cfg, plain_pair_force=True,
                                  plain_env_force=True)
    scene = stepper.prepare_scene(scene, analytic=True, orca=True)
    for m in (cuda_forces, cuda_env, statics):
        m.reset_launch_counts()
    s = state
    for k in range(20):
        nxt, _ = stepper.simulation_step(s, scene, params, cfg, k)
        ref, _ = stepper.simulation_step(s, scene, params, ref_cfg, k)
        assert torch.equal(nxt.alive, ref.alive)
        assert torch.equal(nxt.mode, ref.mode)
        err = max((nxt.pos_x - ref.pos_x).abs().max().item(),
                  (nxt.pos_y - ref.pos_y).abs().max().item())
        assert err <= 1e-4, (k, err)
        s = nxt
    launched = {k: v for m in (cuda_forces, cuda_env, statics)
                for k, v in m.LAUNCHES.items() if v}
    assert launched == {"env_exp_analytic": 20, "env_moussaid": 40,
                        "seg_topk": 20, "chunk_topk": 20}


# -- the chunk scan of the chunked environment forces (kernel #11) -----------

@pytest.mark.parametrize("chunk_size", [128, 64, 200])
@pytest.mark.parametrize("n", [1, 129, 1000])
def test_chunk_argmin_matches_plain_version_bitwise(cuda_device, n,
                                                    chunk_size):
    """The chunk scan against its plain version on the card: pads, an
    all-invalid chunk with real coordinates, an empty segment, ties across
    the chunks of a segment, dead agents at the far sentinel: dmin and idx
    bitwise, then the segmented closest points bitwise."""
    from carla_social_force_model_tpu_torch.ops import statics
    pset = chunked_on(seeded_chunk_set(n, chunk_size=chunk_size),
                      cuda_device)
    x, y, _ = seeded_crowd_planes(n, seed=n + 7)
    px, py, _ = to_device(x, y, np.ones(n, bool), cuda_device)
    before = statics.LAUNCHES["chunk_argmin"]
    got, want = chunk_scan_pair(px, py, pset)
    torch.cuda.synchronize()
    assert statics.LAUNCHES["chunk_argmin"] == before + 1
    assert scan_mismatches(got, want) == 0
    got, want = closest_pair(px, py, pset)
    torch.cuda.synchronize()
    assert closest_mismatches(got, want) == 0


def test_chunk_argmin_checks_and_empty(cuda_device):
    """The wrapper refuses CPU, non-contiguous and mistyped planes and
    launches nothing for an empty crowd."""
    from carla_social_force_model_tpu_torch.ops import geometry, statics
    pset = chunked_on(seeded_chunk_set(1), cuda_device)
    fx, fy = (a.contiguous() for a in geometry.staged_chunk_planes(pset))
    x = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError):
        statics.chunk_argmin(x.cpu(), x.cpu(), fx, fy)
    with pytest.raises(ValueError):
        statics.chunk_argmin(x, x, fx.t(), fy)
    with pytest.raises(ValueError):
        statics.chunk_argmin(x, x, fx.double(), fy)
    before = statics.LAUNCHES["chunk_argmin"]
    dmin, idx = statics.chunk_argmin(x[:0], x[:0], fx, fy)
    assert dmin.shape == (fx.shape[0], 0) and idx.dtype == torch.int32
    assert statics.LAUNCHES["chunk_argmin"] == before


def test_scenario_steps_through_kernels_match_plain_steps(cuda_device):
    """A shipped scenario with borders, parked cars and the chunked
    environment path (obstacle_evasion): 30 steps through the kernels, each
    against the plain versions' step from the same state (1e-4 m), with
    the chunk scan launched on every step."""
    import os
    from carla_social_force_model_tpu_torch.api.simulation import Simulation
    from carla_social_force_model_tpu_torch.ops import statics
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sim = Simulation.from_config(
        os.path.join(root, "configs", "scenarios", "obstacle_evasion.toml"),
        os.path.join(root, "configs", "sfm.toml"), num_steps=30,
        device=cuda_device)
    b = sim.bundle
    assert b.cfg.env_chunked
    scene = stepper.prepare_scene(b.scene, chunked=True)
    ref = dataclasses.replace(b.cfg, plain_pair_force=True,
                              plain_env_force=True)
    s = b.initial_state
    before = statics.LAUNCHES["chunk_argmin"]
    for k in range(30):
        nxt, _ = stepper.simulation_step(s, scene, b.params, b.cfg, k)
        want, _ = stepper.simulation_step(s, scene, b.params, ref, k)
        assert torch.equal(nxt.alive, want.alive)
        assert torch.equal(nxt.mode, want.mode)
        err = max((nxt.pos_x - want.pos_x).abs().max().item(),
                  (nxt.pos_y - want.pos_y).abs().max().item())
        assert err <= 1e-4, (k, err)
        s = nxt
    assert statics.LAUNCHES["chunk_argmin"] - before >= 30


# -- agent sharding --------------------------------------------------------

@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
@pytest.mark.parametrize("form", ["dense", "dense_cutoff", "compact"])
def test_rect_forms_equal_square_forms_bitwise(cuda_device, law, form):
    """The rectangular entry on equal row and column planes (offsets 0) is
    the square call: the same kernel, bitwise."""
    planes = shard_planes(3000, seed=3, device=cuda_device, sort=True)
    x, y, vx, vy, rad, alive, ex, ey = planes
    hel = law == "helbing"
    rad = None if hel else rad
    kw = dict(law=law, desired=(ex, ey) if hel else None)
    prm = cuda_forces.law_vector(law, law_params(law), cuda_device)
    grid = None
    if form != "dense":
        grid = pair_grid.cutoff_grid(x, y, alive, 10.0, symmetric=False,
                                     compact=form == "compact",
                                     max_surv=4 if form == "compact" else 0)
        assert grid.form == form
        square = cuda_forces.pair_force_cutoff(x, y, vx, vy, rad, alive, prm,
                                               grid, **kw)
    else:
        square = cuda_forces.pair_force_dense(x, y, vx, vy, rad, alive, prm,
                                              **kw)
    rect = cuda_forces.pair_force_rect(x, y, vx, vy, rad, alive, prm,
                                       (x, y, vx, vy, rad, alive),
                                       grid=grid, **kw)
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(square), torch.stack(rect))


@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
@pytest.mark.parametrize("gathered", [True, False])
@pytest.mark.parametrize("cutoff,max_surv", [(None, 0), (8.0, 0), (8.0, 2)])
def test_rect_forms_match_plain_version(cuda_device, law, gathered, cutoff,
                                        max_surv):
    """A shard's rows against the gathered columns or the next shard's
    block (4 shards of 2,000), all three dense walks, against the plain
    rectangular force with the global self-pair test."""
    planes = shard_planes(8000, seed=4, device=cuda_device, n_shards=4,
                          sort=cutoff is not None)
    for shard in (0, 3):
        got, want, lim = rect_case(law, planes, 4, shard, cutoff, gathered,
                                   max_surv=max_surv)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert bool(((got - want).abs() <= lim).all()), (law, shard)


@pytest.mark.parametrize("law", ["moussaid", "powerlaw"])
@pytest.mark.parametrize("cutoff", [None, 8.0])
@pytest.mark.parametrize("n_rows,n_cols", [(1, 1), (130, 257), (2500, 2500)])
def test_sym_dense_matches_plain_version(cuda_device, law, cutoff, n_rows,
                                         n_cols):
    """The full-block kernel (the JAX package's ``_pair_kernel_sym_dense``):
    +f on the rows and -f on the columns of one pair matrix, against the
    plain version's row sums and minus its column sums."""
    planes = shard_planes(n_rows + n_cols, seed=5, device=cuda_device,
                          extent=30.0, n_shards=2, sort=cutoff is not None)
    rows = split(planes, 0, n_rows)
    cols = split(planes, n_rows, n_rows + n_cols)
    got_r, got_c, want_r, want_c, lim_r, lim_c = sym_dense_case(
        law, rows, cols, cutoff)
    torch.cuda.synchronize()
    for got, want, lim in ((got_r, want_r, lim_r), (got_c, want_c, lim_c)):
        assert torch.isfinite(got).all()
        assert bool(((got - want).abs() <= lim).all())
    assert bool((got_r[:, ~rows[5]] == 0).all())
    assert bool((got_c[:, ~cols[5]] == 0).all())


@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("cutoff", [None, 8.0])
def test_ring_kernel_matches_gather_and_plain(cuda_device, law, n_shards,
                                              cutoff):
    """The in-kernel ring over 1, 2, 3 and 8 virtual devices against the
    plain ring and against the gathered dense kernel, launched twice on the
    same buffers (its counters reset on every launch)."""
    from carla_social_force_model_tpu_torch.ops import cuda_ring
    n = 480 * n_shards
    planes = shard_planes(n, seed=6, device=cuda_device, n_shards=n_shards,
                          sort=cutoff is not None)
    for _ in range(2):
        before = cuda_ring.LAUNCHES["ring_force"]
        got, want, lim, dense = ring_case(law, planes, n_shards, cutoff)
        torch.cuda.synchronize()
        assert cuda_ring.LAUNCHES["ring_force"] == before + 1
        assert torch.isfinite(got).all()
        assert bool(((got - want).abs() <= lim).all())
        assert bool(((got - dense).abs() <= 2 * lim).all())
        assert bool((got[:, ~planes[5]] == 0).all())


@pytest.mark.parametrize("comm,symmetric", [
    ("gather", True), ("ring", False), ("ring", True), ("ring_kernel", True)])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
@pytest.mark.parametrize("cutoff", [None, 10.0])
def test_sharded_steps_through_kernels_match_single_device(
        cuda_device, comm, symmetric, n_shards, cutoff):
    """Config #1 on a mesh of virtual shards on the card: ten steps of each
    schedule, every step against the single-device kernel path's step from
    the same state (1e-4 m, modes and alive equal), and the schedule's own
    kernels launched on every step."""
    from carla_social_force_model_tpu_torch.models.state import PedState
    from carla_social_force_model_tpu_torch.ops import cuda_ring
    from carla_social_force_model_tpu_torch.parallel import make_mesh
    from carla_social_force_model_tpu_torch.parallel.sharding import (
        prepare_sharded_scene, shard_of)
    scene, params, cfg, _ = benchmark_bundle(1000, device=cuda_device)
    cfg = dataclasses.replace(cfg, axis_comm=comm, symmetric_pairs=symmetric,
                              interaction_cutoff=cutoff)
    scene, cap = prepare_sharded_scene(scene, n_shards)
    scene = stepper.prepare_scene(scene)
    mesh = make_mesh(n_shards, device=cuda_device)
    scenes = [dataclasses.replace(scene, spawn=shard_of(scene.spawn, d,
                                                        n_shards))
              for d in range(n_shards)]
    state = PedState.empty(cap, device=cuda_device)
    for k in range(10):
        want, _ = stepper.simulation_step(state, scene, params, cfg, k)
        cuda_forces.reset_launch_counts()
        cuda_ring.reset_launch_counts()
        outs = mesh.run(
            lambda ax, st, sc: stepper.simulation_step(st, sc, params, cfg,
                                                       k, axis=ax)[0],
            [shard_of(state, d, n_shards) for d in range(n_shards)], scenes)
        got = {f: torch.cat([getattr(o, f) for o in outs])
               for f in ("pos_x", "pos_y", "alive", "mode")}
        torch.cuda.synchronize()
        assert torch.equal(got["alive"], want.alive)
        assert torch.equal(got["mode"], want.mode)
        err = max((got["pos_x"] - want.pos_x).abs().max().item(),
                  (got["pos_y"] - want.pos_y).abs().max().item())
        assert err <= 1e-4, (k, err)
        launched = {**cuda_forces.LAUNCHES, **cuda_ring.LAUNCHES}
        if comm == "ring_kernel":
            assert launched["ring_force"] == 1
        elif comm == "ring" and symmetric:
            assert launched["pair_force_sym" + ("_cutoff" if cutoff else "")
                             ] == n_shards
            # each cross-shard block pair once
            assert launched["pair_force_sym_dense"
                            + ("_cutoff" if cutoff else "")] == (
                n_shards * (n_shards - 1) // 2)
        else:
            name = "pair_force_dense" + ("_cutoff" if cutoff else "")
            want_n = n_shards * (n_shards if comm == "ring" else 1)
            assert launched[name] == want_n, launched
        state = PedState(**{
            f.name: torch.cat([getattr(o, f.name) for o in outs])
            for f in dataclasses.fields(PedState)})
