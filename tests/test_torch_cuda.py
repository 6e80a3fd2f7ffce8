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
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.ops import (cuda_env, cuda_forces,
                                                    env_grid, forces,
                                                    pair_grid)
from carla_social_force_model_tpu_torch.ops.spatial import morton_order
import batch_cases as bc
from family_cases import family_planes, family_reference, family_run
from orca_cases import (ENV_ATOL, ENV_RTOL, analytic_run, feed_mismatch,
                        feed_run, feed_scene)
from shard_cases import (law_params, limit, plain_pairs, rect_case,
                         ring_case, shard_planes, split, sym_dense_case)
from scenario_cases import (chunk_scan_pair, chunked_on, closest_mismatches,
                            closest_pair, scan_mismatches, seeded_chunk_set,
                            seeded_crowd_planes, stacked_chunk_planes,
                            to_device)

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


def theta_zero_pairs(device, p, attempts=200, spread=32, seed=7):
    """Two-agent crowds whose pair has atan2(cross, dot) equal to minus the
    float32 product B * -eps: the plain version's theta is then exactly 0
    (no tangential term), where a sum that kept the product's rounding
    error (an FMA) would give theta a sign and the pair a tangential term
    of A exp(-d / B).  Agent 0 stands at the origin with velocity (dv, 0),
    agent 1 at rest near the root of theta(psi) = 0 on a circle of radius
    r (float64 bisection); its position is varied by up to ``spread`` ulps
    in x and y, and the plain version's float32 arithmetic on the card
    keeps the positions where theta is 0 and the fused sum is not.  Returns
    a list of planes (x, y, vx, vy, radius, alive)."""
    rng = np.random.default_rng(seed)
    lam, gamma = np.float64(p.lambda_), np.float64(p.gamma)
    eps = np.float64(np.float32(p.epsilon))
    r = rng.uniform(0.4, 1.2, attempts)
    dv = rng.uniform(0.5, 2.0, attempts).astype(np.float32)

    def g(psi):  # theta of the pair with the partner at angle psi
        tx, ty = lam * dv + np.cos(psi), np.sin(psi)
        t_len = np.hypot(tx, ty)
        ang = np.arctan2(tx * np.sin(psi) - ty * np.cos(psi),
                         tx * np.cos(psi) + ty * np.sin(psi))
        return ang - gamma * t_len * eps

    lo, hi = np.full(attempts, -0.5), np.full(attempts, 0.5)
    assert bool((np.sign(g(lo)) != np.sign(g(hi))).all())
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        left = np.sign(g(mid)) == np.sign(g(lo))
        lo, hi = np.where(left, mid, lo), np.where(left, hi, mid)
    x0 = (r * np.cos(lo)).astype(np.float32)
    y0 = (r * np.sin(lo)).astype(np.float32)
    k = np.arange(-spread, spread + 1, dtype=np.float32)
    xs = x0[:, None, None] + k[None, :, None] * np.spacing(x0)[:, None, None]
    ys = y0[:, None, None] + k[None, None, :] * np.spacing(y0)[:, None, None]
    xs, ys = np.broadcast_arrays(xs, ys)
    dx = torch.from_numpy(np.ascontiguousarray(xs.reshape(attempts, -1))).to(
        device)
    dy = torch.from_numpy(np.ascontiguousarray(ys.reshape(attempts, -1))).to(
        device)
    dvx = torch.from_numpy(dv).to(device)[:, None].expand_as(dx)
    # the plain version's arithmetic (ops/forces.py _moussaid_pair_force)
    d2 = dx * dx + dy * dy
    rr = torch.rsqrt(d2)
    ex, ey = dx * rr, dy * rr
    tx = p.lambda_ * dvx + ex
    ty = p.lambda_ * torch.zeros_like(dvx) + ey
    t2 = tx * tx + ty * ty
    rt = torch.rsqrt(t2)
    thx, thy = tx * rt, ty * rt
    b = p.gamma * (t2 * rt)
    ang = torch.atan2(thx * ey - thy * ex, ex * thx + ey * thy)
    theta = ang + b * (-p.epsilon)
    fused = ang.double() + b.double() * (-eps)
    hit = (theta == 0) & (fused != 0)
    out = []
    for a in range(attempts):
        idx = torch.nonzero(hit[a])
        if idx.numel() == 0:
            continue
        j = int(idx[0, 0])
        xj, yj = dx[a, j].item(), dy[a, j].item()
        out.append([torch.tensor(v, dtype=dt, device=device) for v, dt in (
            ([0.0, xj], torch.float32), ([0.0, yj], torch.float32),
            ([float(dv[a]), 0.0], torch.float32), ([0.0, 0.0], torch.float32),
            ([0.3, 0.3], torch.float32), ([True, True], torch.bool))])
    return out


@pytest.mark.parametrize("kernel", ["pair_force_sym", "pair_force_dense"])
def test_kernel_keeps_a_zero_theta(cuda_device, kernel):
    """Pairs whose theta is exactly 0 in the plain version (atan2 equal to
    minus the rounded product B * -eps): the kernels add the two rounded
    on their own, so the tangential term stays 0 and the force matches
    (|err| <= 1e-4 + 1e-4*|f|).  With the product fused into the sum the
    kernels gave these pairs a tangential term of A exp(-d / B)."""
    p = MoussaidParams()
    cases = theta_zero_pairs(cuda_device, p)
    assert len(cases) >= 8
    prm = moussaid_vector(p, cuda_device)
    for planes in cases:
        want = torch.stack(forces.pedestrian_force(*planes, p))
        got = torch.stack(getattr(cuda_forces, kernel)(*planes, prm))
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


@pytest.mark.parametrize("c, k, n", [
    (19, 128, 1), (19, 128, 513), (150, 128, 10_008), (9, 200, 1_007),
    (13, 64, 2_049), (7, 130, 777), (3, 1_100, 600), (2, 1_030, 129)])
def test_chunk_argmin_on_stacked_ties_is_bitwise(cuda_device, c, k, n):
    """The chunk scan where equal distances stack: four points around each
    of four centres repeated through every chunk, equal points at both
    ends of each 32-point sub-group, whole chunks repeated, all-PAD chunks,
    pedestrians standing on the centres; crowds that fill no whole block,
    chunk counts that fill no whole group of staged chunks, rows of 64-200
    slots (whole groups), 130 (copied a float at a time) and over 1,024
    (a chunk staged in pieces).  dmin and idx equal the plain version's
    bitwise."""
    from carla_social_force_model_tpu_torch.ops import geometry, statics
    fx, fy, centres = stacked_chunk_planes(c, k, seed=c + k)
    rng = np.random.default_rng(n)
    xy = rng.uniform(-6.0, 9.0, (n, 2)).astype(np.float32)
    on = min(n, 64)
    xy[:on] = centres[np.arange(on) % 4]
    px, py = (torch.from_numpy(xy[:, i].copy()).to(cuda_device)
              for i in (0, 1))
    fxt, fyt = (torch.from_numpy(a).to(cuda_device) for a in (fx, fy))
    before = statics.LAUNCHES["chunk_argmin"]
    got = statics.chunk_argmin(px, py, fxt, fyt)
    want = geometry.chunk_argmin_plain(px, py, fxt, fyt)
    torch.cuda.synchronize()
    assert statics.LAUNCHES["chunk_argmin"] == before + 1
    assert scan_mismatches(got, want) == 0
    # the case holds ties: some minimum is met again after its first slot
    d2 = ((fxt[:, :, None] - px[None, None, :on]) ** 2
          + (fyt[:, :, None] - py[None, None, :on]) ** 2)
    assert int((d2 == want[0][:, None, :on]).sum()) > c * on


def tie_chunk_features(seed, device):
    """ORCA chunk features whose points repeat at neighbouring slots (two
    lanes of the chunk top-k) and eight slots apart (one lane), with four
    whole segments repeated (ties across chunks), and a seeded crowd of
    3,000 with some pedestrians standing on points, Hilbert-sorted with
    10% dead: ``(features, planes)``."""
    from carla_social_force_model_tpu_torch.env.pointsets import (
        build_chunked_pointset, chunk_features)
    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(12):
        pts = rng.uniform(-15.0, 15.0, (int(rng.integers(20, 300)), 2))
        pts[1::9] = pts[0::9][:len(pts[1::9])]
        pts[8::17] = pts[0::17][:len(pts[8::17])]
        lists.append(pts.astype(np.float32))
    lists += lists[:4]
    s = len(lists)
    pset = build_chunked_pointset(lists, np.zeros((s, 2), np.float32),
                                  np.ones(s, np.float32))
    n = 3000
    xy = rng.uniform(-20.0, 20.0, (n, 2)).astype(np.float32)
    xy[:50] = lists[0][:50]
    alive = rng.uniform(size=n) >= 0.1
    planes = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (xy[:, 0], xy[:, 1], alive)]
    perm, _ = morton_order(planes[0], planes[1], planes[2], "hilbert")
    x, y, alive = (a[perm].contiguous() for a in planes)
    return chunk_features(pset, device), [x, y, None, None, None, alive]


@pytest.mark.parametrize("k", [1, 3, 8])
def test_chunk_topk_keeps_ties_across_chunks_and_lanes(cuda_device, k):
    """The chunk top-k on ties across chunks (repeated segments) and
    across the lanes of one chunk's scan (equal points one slot and eight
    slots apart): d2, the points and the selection equal the plain
    version's bitwise, with the alive rows' boxes and with every row's,
    and scanning each chunk to its real length or every slot."""
    from carla_social_force_model_tpu_torch.ops import statics
    src, planes = tie_chunk_features(40 + k, cuda_device)
    assert int(src.lengths.max()) == src.chunk_size
    assert int(src.lengths.min()) < src.chunk_size
    want = feed_run("chunk_topk", planes, src, k, plain=True)
    every = dataclasses.replace(src, lengths=torch.full_like(
        src.lengths, src.chunk_size))
    for lens in (src, every):
        for use_alive in (True, False):
            before = statics.LAUNCHES["chunk_topk"]
            got = feed_run("chunk_topk", planes, lens, k, use_alive=use_alive)
            torch.cuda.synchronize()
            assert statics.LAUNCHES["chunk_topk"] == before + 1
            rows = planes[5] if use_alive else torch.ones_like(planes[5])
            assert feed_mismatch("chunk_topk", got, want, rows) == 0
    assert bool(torch.isfinite(want[0]).any())


def tie_planes(x, y, alive, device):
    """The tie cases' crowd (numpy planes) on the card, Hilbert-sorted as
    ORCA passes it: ``[x, y, None, None, None, alive]``."""
    planes = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (x, y, alive)]
    perm, _ = morton_order(planes[0], planes[1], planes[2], "hilbert")
    x, y, alive = (a[perm].contiguous() for a in planes)
    return [x, y, None, None, None, alive]


def feed_rows_check(kind, planes, src, k, want):
    """Launch ``kind`` with the alive rows' boxes and with every row's,
    twice each: one launch a call, the plain version's bits on the rows
    the boxes hold, and the same bits again."""
    from carla_social_force_model_tpu_torch.ops import statics
    for use_alive in (True, False):
        before = statics.LAUNCHES[kind]
        got = feed_run(kind, planes, src, k, use_alive=use_alive)
        again = feed_run(kind, planes, src, k, use_alive=use_alive)
        torch.cuda.synchronize()
        assert statics.LAUNCHES[kind] == before + 2
        rows = planes[5] if use_alive else torch.ones_like(planes[5])
        assert feed_mismatch(kind, got, want, rows) == 0, use_alive
        assert torch.equal(got, again), use_alive


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("f", [0, 13, 157, 301, 700])
def test_seg_topk_keeps_ties_across_lanes_and_tiles(cuda_device, f, k):
    """The segment top-k on features whose equal distances lie 1, L and
    L + 1 indices apart (L = 4 lanes), more equal candidates than k, F not
    a multiple of L nor of the 128-feature tile (0, 13, 157, 301, 700: no
    tile, two, three, six) and N = 1,007 (no whole number of 32-pedestrian
    blocks): d2, the points and the selection equal the plain version's
    bitwise with the alive rows' boxes and with every row's, and a
    relaunch gives the same bits."""
    from carla_social_force_model_tpu_torch.env.pointsets import (
        SegmentFeatures)
    from orca_cases import tie_crowd, tie_segment_planes
    feat = SegmentFeatures(**{a: torch.from_numpy(v).to(cuda_device)
                              for a, v in tie_segment_planes(f, seed=f)
                              .items()})
    planes = tie_planes(*tie_crowd(1007, seed=f + k), cuda_device)
    want = feed_run("seg_topk", planes, feat, k, plain=True)
    feed_rows_check("seg_topk", planes, feat, k, want)
    assert bool(torch.isfinite(want[0]).any()) == (f > 0)


@pytest.mark.parametrize("c, kk, n", [
    (13, 64, 1007), (37, 128, 1007), (170, 128, 4099), (9, 200, 1007),
    (7, 1100, 1007)])
def test_chunk_closest_keeps_ties_across_lanes_bitwise(cuda_device, c, kk,
                                                       n):
    """chunk_closest on chunks whose closest points tie at different points
    in neighbouring slots and slots a lane stride apart, with ragged
    lengths, invalid slots and an empty chunk (radius < 0); chunk counts
    that the grid's splits do not divide, chunks of 64, 128, 200 and 1,100
    slots (more than a stage of 1,024 points: staged in pieces), crowds of
    1,007 and 4,099 (no whole number of blocks): d2 bitwise everywhere and
    the points where d2 is finite, with the alive rows' boxes and every
    row's, each chunk scanned to its real length or over every slot; a
    relaunch gives the same bits."""
    from carla_social_force_model_tpu_torch.env.pointsets import (
        chunk_features)
    from orca_cases import tie_chunk_set, tie_crowd
    src = chunk_features(tie_chunk_set(c, kk, seed=c + kk), cuda_device)
    assert bool((src.radius < 0).any())
    assert bool(((src.lengths > 0) & (src.lengths < kk)).any())
    planes = tie_planes(*tie_crowd(n, seed=n), cuda_device)
    want = feed_run("chunk_closest", planes, src, plain=True)
    every = dataclasses.replace(src, lengths=torch.full_like(src.lengths, kk))
    for lens in (src, every):
        feed_rows_check("chunk_closest", planes, lens, 0, want)
    assert bool(torch.isfinite(want[0]).any())


@pytest.mark.parametrize("kind", ["seg_topk", "chunk_closest"])
def test_feed_kernels_with_every_row_dead(cuda_device, kind):
    """Every pedestrian dead (N = 1,007): with the alive rows' boxes every
    block's box is empty, nothing is hit and every entry is empty (d2 inf,
    the point 0); with every row's, the plain version's bits."""
    from carla_social_force_model_tpu_torch.env.pointsets import (
        SegmentFeatures, chunk_features)
    from orca_cases import tie_chunk_set, tie_crowd, tie_segment_planes
    x, y, alive = tie_crowd(1007, seed=2)
    planes = tie_planes(x, y, np.zeros_like(alive), cuda_device)
    if kind == "seg_topk":
        src = SegmentFeatures(**{a: torch.from_numpy(v).to(cuda_device)
                                 for a, v in tie_segment_planes(301).items()})
    else:
        src = chunk_features(tie_chunk_set(37, 128), cuda_device)
    for k in ((1, 8) if kind == "seg_topk" else (0,)):
        want = feed_run(kind, planes, src, k, plain=True)
        got = feed_run(kind, planes, src, k, use_alive=False)
        empty = feed_run(kind, planes, src, k, use_alive=True)
        torch.cuda.synchronize()
        assert feed_mismatch(kind, got, want,
                             torch.ones_like(planes[5])) == 0
        assert bool(torch.isinf(empty[0]).all())
        assert not bool(empty[1:].any())
        assert bool(torch.isfinite(want[0]).any())


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


# -- the symmetric walk's row tiles and culling; the environment kernel's ------
# -- split scan, real row lengths and deferred terms ----------------------------

def sym_form_run(planes, form, p, cutoff=None, max_surv=0):
    """``(got, want)``: one symmetric-walk launch in ``form`` (``"sym"``,
    ``"sym_cutoff"`` or ``"sym_compact"`` with a table ``max_surv`` wide)
    and the plain version, both (2, N)."""
    prm = moussaid_vector(p, planes[0].device)
    if form == "sym":
        got = cuda_forces.pair_force_sym(*planes, prm)
        want = forces.pedestrian_force(*planes, p)
    else:
        grid = pair_grid.cutoff_grid(
            planes[0], planes[1], planes[5], cutoff, symmetric=True,
            compact=form == "sym_compact", max_surv=max_surv)
        assert grid.form == form
        got = cuda_forces.pair_force_cutoff(*planes, prm, grid)
        want = forces.pedestrian_force(*planes, p, cutoff=cutoff)
    torch.cuda.synchronize()
    return torch.stack(got), torch.stack(want)


@pytest.mark.parametrize("form,n", [
    (form, n) for form in ("sym", "sym_cutoff", "sym_compact")
    for n in (31, 33, 127, 129, 255, 257, 383, 1000)
    if form != "sym_compact" or n > 128])  # a table needs two tiles
def test_sym_walks_on_ragged_n_match_plain_version(cuda_device, form, n):
    """N that is not a multiple of a thread's 32 * R rows nor of the
    128-agent tile: the last tile pair's missing rows and columns take no
    part, in every symmetric form (|err| <= 1e-4 + 1e-4*|f|)."""
    planes = cutoff_case(n, seed=n + 40, device=cuda_device)
    got, want = sym_form_run(planes, form, MoussaidParams(), cutoff=10.0,
                             max_surv=1)
    assert torch.isfinite(got).all()
    assert bool((got[:, ~planes[5]] == 0).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("form", ["sym", "sym_cutoff", "sym_compact"])
def test_sym_walks_with_dead_agents_in_every_lane_position(cuda_device,
                                                           form):
    """Dead agents at every lane position of every 32-row group, a whole
    dead 32-row group and a whole dead 128-agent tile: their rows stay
    exactly 0, the chunk boxes ignore them, the rest matches the plain
    version."""
    n = 1101
    planes = cutoff_case(n, seed=9, device=cuda_device)
    idx = torch.arange(n, device=cuda_device)
    dead = (((idx // 32 + idx) % 5 == 0) | ((idx >= 256) & (idx < 288))
            | ((idx >= 512) & (idx < 640)))
    planes[5] = planes[5] & ~dead
    got, want = sym_form_run(planes, form, MoussaidParams(), cutoff=10.0,
                             max_surv=1)
    assert torch.isfinite(got).all()
    assert bool((got[:, ~planes[5]] == 0).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def stacked_crowd(seed, device):
    """64 nodes with 24 agents each that spawned on their node and took one
    Euler step apart: many pairs sit on the atan2 branch cut."""
    rng = np.random.default_rng(seed)
    n_nodes, per_node = 64, 24
    nodes = rng.uniform(-30, 30, (n_nodes, 2)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, (n_nodes, per_node))
    speed = rng.uniform(1.0, 1.6, (n_nodes, per_node))
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading)],
                   -1).reshape(-1, 2).astype(np.float32)
    start = torch.from_numpy(np.repeat(nodes, per_node, axis=0)).to(device)
    v = torch.from_numpy(vel).to(device)
    pos = start + 0.05 * v
    n = pos.shape[0]
    return [pos[:, 0].contiguous(), pos[:, 1].contiguous(),
            v[:, 0].contiguous(), v[:, 1].contiguous(),
            torch.full((n,), 0.3, device=device),
            torch.ones(n, dtype=torch.bool, device=device)]


@pytest.mark.parametrize("form", ["sym", "sym_cutoff", "sym_compact"])
def test_sym_walks_on_stacked_starts(cuda_device, form):
    """The eight stacked crowds of the branch-cut test through every
    symmetric form (sorted along the Hilbert curve for the cutoff forms):
    the row tiles, the culling and the fast tail leave cross, dot and
    sign(theta) as the plain version computes them."""
    for seed in range(8):
        planes = stacked_crowd(seed, cuda_device)
        if form != "sym":
            perm, _ = morton_order(planes[0], planes[1], planes[5],
                                   "hilbert")
            planes = [t[perm].contiguous() for t in planes]
        got, want = sym_form_run(planes, form, MoussaidParams(),
                                 cutoff=10.0, max_surv=1)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_sym_table_with_overflowing_rows_matches_plain_version(cuda_device):
    """The 1M crowd's pattern at N = 20,000: 0.25 agents/m^2, Hilbert-
    sorted, the 30 m cutoff, a table that some rows overflow (they walk
    every column tile of their triangle with the box test) and others fit;
    against the plain version."""
    planes = cutoff_case(20_000, seed=13, device=cuda_device)
    grid = pair_grid.cutoff_grid(planes[0], planes[1], planes[5], 30.0,
                                 symmetric=True, max_surv=8)
    assert grid.form == "sym_compact"
    assert bool((grid.counts > 8).any()) and bool((grid.counts <= 8).any())
    got = torch.stack(cuda_forces.pair_force_cutoff(
        *planes, moussaid_vector(MoussaidParams(), cuda_device), grid))
    want = torch.stack(forces.pedestrian_force(*planes, MoussaidParams(),
                                               cutoff=30.0))
    torch.cuda.synchronize()
    assert bool((got[:, ~planes[5]] == 0).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def point_rows(rows, k, centers, radius, device, lengths=True):
    """A SegmentPointSet of the given rows of points, each padded with
    PAD_COORD to ``k`` slots, with its real lengths (or None)."""
    from carla_social_force_model_tpu_torch.env.pointsets import (
        PAD_COORD, SegmentPointSet)
    s = len(rows)
    x = np.full((s, k), PAD_COORD, np.float32)
    y = np.full((s, k), PAD_COORD, np.float32)
    for i, pts in enumerate(rows):
        pts = np.asarray(pts, np.float32).reshape(-1, 2)
        x[i, :len(pts)], y[i, :len(pts)] = pts[:, 0], pts[:, 1]
    centers = np.asarray(centers, np.float32)
    lens = np.array([len(np.asarray(r).reshape(-1, 2)) for r in rows],
                    np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (x, y, centers[:, 0], centers[:, 1],
                   np.full(s, radius, np.float32), lens)]
    return SegmentPointSet(*t[:5], lengths=t[5] if lengths else None)


def env_pair(kernel, planes, seg, plain=False):
    """One launch of ``kernel`` (``env_exp`` or ``env_moussaid``, the
    obstacles at rest) or its plain version, as a (2, N) tensor."""
    px, py, vx, vy, rad, alive = planes
    if kernel == "env_exp":
        args = (px, py, rad, alive, seg, 3.0, 0.4)
        fn = forces.env_exp_force if plain else cuda_env.env_exp
    else:
        ovel = torch.zeros((seg.num_segments, 2), device=px.device)
        args = (px, py, vx, vy, rad, alive, seg, ovel, MoussaidParams())
        fn = forces.env_moussaid_force if plain else cuda_env.env_moussaid
    return torch.stack(fn(*args))


@pytest.mark.parametrize("k,slot_sets", [
    (1103, [(3, 12, 13, 40), (5, 8, 9, 24), (7, 9, 15, 16), (0, 31, 32, 33),
            (9, 1025, 1026, 1030), (1023, 1024, 1027, 1100)]),
    (14, [(3, 9, 10, 12), (0, 5, 7, 11), (8, 9, 10, 11)])])
@pytest.mark.parametrize("kernel", ["env_exp", "env_moussaid"])
def test_env_scan_keeps_the_first_of_tied_points(cuda_device, kernel, k,
                                                 slot_sets):
    """Pedestrian s stands at equal distance (exactly 1 m) from four points
    of row s, placed in slots that fall to different lanes of the split
    scan (an earlier slot in a later lane, a later slot in lane 0, both
    sides of a staged piece of 1,024), or in a row short enough for one
    lane's whole scan: the kernel takes the earliest slot, as the
    sequential scan and the plain version's argmin do, so the force points
    away from that point."""
    rows, centers, peds = [], [], []
    for s, slots in enumerate(slot_sets):
        cx = 100.0 * s
        pts = np.stack([cx + 50.0 + np.arange(k, dtype=np.float32),
                        np.full(k, 50.0, np.float32)], -1)
        for slot, (dx, dy) in zip(slots, ((1, 0), (-1, 0), (0, 1), (0, -1))):
            pts[slot] = (cx + dx, dy)
        rows.append(pts[:slots[-1] + 3])
        centers.append((cx, 0.0))
        peds.append((cx, 0.0))
    seg = point_rows(rows, k, centers, 5.0, cuda_device)
    n = len(peds)
    pos = np.asarray(peds, np.float32)
    planes = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
              for a in (pos[:, 0], pos[:, 1], np.full(n, 0.5, np.float32),
                        np.zeros(n, np.float32), np.full(n, 0.3, np.float32),
                        np.ones(n, bool))]
    got = env_pair(kernel, planes, seg)
    want = env_pair(kernel, planes, seg, plain=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if kernel == "env_exp":   # away from (cx + 1, 0): along -x
        assert bool((got[0] < 0).all()) and bool((got[1] == 0).all())


@pytest.mark.parametrize("n", [1, 31, 45, 130])
@pytest.mark.parametrize("kernel", ["env_exp", "env_moussaid"])
def test_env_rows_of_padding_and_ragged_k(cuda_device, kernel, n):
    """Rows of 13 slots (not a multiple of the lanes per pedestrian): one
    all padding, one of one point, one full, one of five; N not a multiple
    of the 32 pedestrians of a block.  Against the plain version, and equal
    bitwise to the same set without its lengths (every slot scanned):
    padding is never the closest point, and an empty row stays masked."""
    rng = np.random.default_rng(n)
    rows = [np.zeros((0, 2)), [[1.0, 2.0]],
            rng.uniform(-6, 6, (13, 2)), rng.uniform(-6, 6, (5, 2))]
    seg = point_rows(rows, 13, [(0, 0), (1, 2), (0, 0), (0, 0)], 8.0,
                     cuda_device)
    bare = dataclasses.replace(seg, lengths=None)
    planes = crowd_planes(max(n, 7), seed=n, device=cuda_device, extent=8.0)
    planes = [t[:n].contiguous() for t in planes]
    got = env_pair(kernel, planes, seg)
    want = env_pair(kernel, planes, seg, plain=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert bool((got[:, ~planes[5]] == 0).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, env_pair(kernel, planes, bare))


@pytest.mark.parametrize("kernel,sets", [("env_exp", "borders"),
                                         ("env_moussaid", "statics"),
                                         ("analytic", "borders")])
def test_env_compact_equals_dense_bitwise_on_ragged_n(cuda_device, kernel,
                                                      sets):
    """N = 1,013 (not a multiple of 32 nor 128): four 32-pedestrian blocks
    read one table row and re-test its groups against their own boxes, so
    the compacted forms equal the dense ones bitwise -- with a table that
    fits and one that overflows -- and the dense ones without the row
    lengths."""
    n = 1013
    if kernel == "analytic":
        scene, params, planes = feed_scene(n, cuda_device)
        geom, b = scene.borders_geom, params.border
        dense = analytic_run(planes, geom, b.a, b.b, False)
        bare = analytic_run(planes, dataclasses.replace(geom, lengths=None),
                            b.a, b.b, False)
        r2 = cuda_env.filter_r2(geom)
        x, y, alive = planes[0], planes[1], planes[5]
        hits = env_grid.group_hits(env_grid.block_boxes(x, y, alive),
                                   geom.center_x, geom.center_y, r2, 8)
        outs = [analytic_run(planes, geom, b.a, b.b, False,
                             grid=env_grid.env_grid(x, y, alive, geom, r2, 8,
                                                    w))
                for w in (max(int(hits.sum(dim=1).max()), 1), 1)]
    else:
        planes, env = env_case(n, seed=n, device=cuda_device, sort=True)
        seg, ovel, active = env[sets]
        dense = env_compact_run(kernel, planes, seg, ovel, active, None,
                                False)
        bare = env_compact_run(kernel, planes,
                               dataclasses.replace(seg, lengths=None), ovel,
                               active, None, False)
        outs = [env_compact_run(kernel, planes, seg, ovel, active, g, False)
                for g in env_compact_grids(planes, seg, active)]
    torch.cuda.synchronize()
    assert torch.equal(dense, bare)
    for got in outs:
        assert torch.equal(got, dense)


def test_env_lengths_are_checked(cuda_device):
    planes, env = env_case(64, seed=3, device=cuda_device, sort=False)
    px, py, vx, vy, rad, alive = planes
    seg = env["borders"][0]
    with pytest.raises(ValueError, match="segment lengths"):
        cuda_env.env_exp(px, py, rad, alive,
                         dataclasses.replace(seg, lengths=seg.lengths.long()),
                         3.0, 0.1)



# -- the dense walk's split columns, culling and fast tail; the ring on it ----

def dense_launch(law, planes, n_rows, form, cutoff=10.0, max_surv=0):
    """One launch of the dense walk in ``form`` (``"dense"``,
    ``"dense_cutoff"`` or ``"compact"`` with a table ``max_surv`` wide) of
    the first ``n_rows`` rows of ``planes`` (as :func:`shard_planes` gives
    them) against all of its columns: ``(got, grid)``, got (2, n_rows)."""
    x, y, vx, vy, rad, alive, ex, ey = planes
    rows = split(planes, 0, n_rows)
    grid = None
    if form != "dense":
        grid = pair_grid.rect_grid(
            rows[0], rows[1], rows[5],
            pair_grid.box_planes(x, y, alive, pair_grid.COL_TILE),
            x.shape[0], cutoff, compact=form == "compact",
            max_surv=max_surv)
        assert grid.form == form
    hel = law == "helbing"
    prm = cuda_forces.law_vector(law, law_params(law), x.device)
    got = torch.stack(cuda_forces.pair_force_rect(
        *rows[:4], None if hel else rows[4], rows[5], prm, tuple(planes[:6]),
        grid=grid, law=law, desired=(rows[6], rows[7]) if hel else None))
    return got, grid


def assert_dense_walk_close(law, planes, n_rows, form, cutoff=10.0,
                            max_surv=0):
    """The dense walk against the plain version within the shared limit
    (``shard_cases.limit``), finite, dead rows exactly 0; returns got."""
    got, _ = dense_launch(law, planes, n_rows, form, cutoff, max_surv)
    rows = split(planes, 0, n_rows)
    cut = None if form == "dense" else cutoff
    want = plain_pairs(law, rows, planes, 0, 0, cut)
    lim = limit(law, want, plain_pairs(law, rows, planes, 0, 0, cut,
                                       magnitudes=True))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert bool((got[:, ~rows[5]] == 0).all())
    err = (got - want).abs()
    assert bool((err <= lim).all()), (err / lim).max().item()
    return got


@pytest.mark.parametrize("form", ["dense", "dense_cutoff", "compact"])
@pytest.mark.parametrize("n_rows", [1, 31, 33, 255, 257, 2500])
def test_dense_walks_on_ragged_rows_split_columns(cuda_device, n_rows,
                                                  form):
    """1 to 2,500 rows against 10,000 columns: each row's columns split
    over up to eight blocks of one cluster, partial row tiles and a partial
    last column tile, the splits added in a fixed order.  Within the plain
    version's limit; the compacted walk (a four-slot table: some rows fit,
    others overflow) equals the box-skip walk bitwise."""
    planes = shard_planes(10_000, seed=n_rows, device=cuda_device,
                          sort=form != "dense")
    got = assert_dense_walk_close("moussaid", planes, n_rows, form,
                                  max_surv=4)
    if form == "compact":
        box, _ = dense_launch("moussaid", planes, n_rows, "dense_cutoff")
        assert torch.equal(got, box)


@pytest.mark.parametrize("form", ["dense", "dense_cutoff", "compact"])
@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
def test_dense_walks_with_dead_agents_in_every_lane_position(cuda_device,
                                                             law, form):
    """Dead agents at every lane position of every 32-row set, a whole dead
    32-row set and a whole dead 128-row tile, through every dense walk of
    every law (a one-slot table: every row with two hits overflows): their
    rows stay exactly 0, the chunk boxes ignore them, the rest is within
    the plain version's limit."""
    n = 1101
    planes = shard_planes(n, seed=9, device=cuda_device,
                          sort=form != "dense")
    idx = torch.arange(n, device=cuda_device)
    dead = (((idx // 32 + idx) % 5 == 0) | ((idx >= 256) & (idx < 288))
            | ((idx >= 512) & (idx < 640)))
    planes[5] = planes[5] & ~dead
    assert_dense_walk_close(law, planes, n, form, max_surv=1)


@pytest.mark.parametrize("form", ["dense", "dense_cutoff", "compact"])
@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
def test_dense_walks_on_stacked_starts(cuda_device, law, form):
    """Four of the stacked crowds of the branch-cut test (Helbing's desired
    direction along the velocity) through every dense walk of every law:
    the row sets, the culling and the fast tail leave cross, dot, sign
    (theta) and the power law's and Helbing's gates as the plain version
    decides them."""
    for seed in range(4):
        planes = stacked_crowd(seed, cuda_device)
        speed = torch.sqrt(planes[2] ** 2 + planes[3] ** 2)
        planes += [(planes[2] / speed).contiguous(),
                   (planes[3] / speed).contiguous()]
        if form != "dense":
            perm, _ = morton_order(planes[0], planes[1], planes[5],
                                   "hilbert")
            planes = [t[perm].contiguous() for t in planes]
        assert_dense_walk_close(law, planes, planes[0].shape[0], form,
                                max_surv=1)


@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
def test_dense_table_with_overflowing_rows_matches_plain_version(
        cuda_device, law):
    """The 1M crowd's pattern at N = 20,000: 0.25 agents/m^2, Hilbert-
    sorted, the 30 m cutoff, a table of eight slots that some rows
    overflow (they walk their splits' tiles with the box test) and others
    fit; every law against the plain version."""
    planes = shard_planes(20_000, seed=13, device=cuda_device, sort=True)
    _, grid = dense_launch(law, planes, 20_000, "compact", 30.0, 8)
    assert bool((grid.counts > 8).any()) and bool((grid.counts <= 8).any())
    assert_dense_walk_close(law, planes, 20_000, "compact", 30.0, 8)


@pytest.mark.parametrize("form", ["dense", "dense_cutoff", "compact"])
@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
def test_dense_walks_are_deterministic(cuda_device, law, form):
    """Two launches of each dense walk on the same inputs are equal
    bitwise: no float atomics, the splits added in a fixed order."""
    planes = shard_planes(5_000, seed=21, device=cuda_device,
                          sort=form != "dense")
    first, _ = dense_launch(law, planes, 5_000, form, max_surv=4)
    again, _ = dense_launch(law, planes, 5_000, form, max_surv=4)
    assert torch.equal(first, again)


@pytest.mark.parametrize("cutoff", [None, 8.0])
@pytest.mark.parametrize("n_local", [31, 257, 1001])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_ring_kernel_on_ragged_shards(cuda_device, n_shards, n_local,
                                      cutoff):
    """The ring on shards whose size is no multiple of a block's rows or of
    a column tile, every law: against the plain ring and the gathered
    dense kernel, and relaunched on the same buffers bitwise equal."""
    n = n_local * n_shards
    planes = shard_planes(n, seed=n_local, device=cuda_device,
                          n_shards=n_shards, sort=cutoff is not None)
    for law in ("moussaid", "powerlaw", "helbing"):
        got, want, lim, dense = ring_case(law, planes, n_shards, cutoff)
        again, *_ = ring_case(law, planes, n_shards, cutoff)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert bool(((got - want).abs() <= lim).all()), law
        assert bool(((got - dense).abs() <= 2 * lim).all()), law
        assert bool((got[:, ~planes[5]] == 0).all())
        assert torch.equal(got, again)


@pytest.mark.parametrize("cutoff", [None, 8.0])
@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
def test_ring_kernel_takes_large_shards(cuda_device, law, cutoff):
    """The ring at twice the agents that one block per 128-row set could
    hold resident (3 blocks an SM): D = 4 virtual devices of
    2 * floor(3 * SMs / 4) * 128 agents each (N = 101,376 on 132 SMs), and
    D = 1 over the same N, where each block walks several row sets.
    Against the plain ring and the gathered dense kernel, and relaunched
    bitwise equal."""
    from carla_social_force_model_tpu_torch.ops import cuda_ring
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n = 2 * (3 * sms // 4 * 128) * 4
    for n_shards in (4, 1):
        planes = shard_planes(n, seed=31, device=cuda_device,
                              n_shards=n_shards, sort=cutoff is not None)
        before = cuda_ring.LAUNCHES["ring_force"]
        got, want, lim, dense = ring_case(law, planes, n_shards, cutoff)
        x, y, vx, vy, rad, alive, ex, ey = planes
        hel = law == "helbing"
        again = torch.stack(cuda_ring.ring_force(
            x, y, vx, vy, None if hel else rad, alive,
            cuda_forces.law_vector(law, law_params(law), cuda_device),
            n_shards, law=law, desired=(ex, ey) if hel else None,
            cutoff=cutoff))
        torch.cuda.synchronize()
        assert cuda_ring.LAUNCHES["ring_force"] == before + 2
        assert torch.isfinite(got).all()
        assert bool(((got - want).abs() <= lim).all()), n_shards
        assert bool(((got - dense).abs() <= 2 * lim).all()), n_shards
        assert bool((got[:, ~alive] == 0).all())
        assert torch.equal(got, again)


# -- ensembles and sweeps: the batched kernels ------------------------------

@pytest.mark.parametrize("sweep", [False, True])
@pytest.mark.parametrize("b,n", [(1, 130), (3, 1000), (37, 257)])
@pytest.mark.parametrize("law,form", sorted(bc.PAIR_FORMS))
def test_batched_pair_kernel_matches_plain_and_unbatched(cuda_device, law,
                                                         form, b, n, sweep):
    """Each batched pair kernel, one launch for every row, against its
    plain batched version (the tolerance of its unbatched kernel) and
    against the unbatched kernel on each row with that row's parameters:
    bitwise for the dense walk (the same summation order), within the
    tolerance for the symmetric walk (atomics)."""
    planes = bc.batch_planes(b, n, seed=n + b, device=cuda_device,
                             extent=20.0)
    p = bc.law_params(law)
    if sweep:
        p = bc.swept(p, b, cuda_device)
    cuda_forces.reset_launch_counts()
    got = bc.batch_run(law, form, planes, p)
    torch.cuda.synchronize()
    assert cuda_forces.LAUNCHES[bc.PAIR_FORMS[law, form]] == 1
    assert torch.isfinite(got).all()
    assert bool((got[:, ~planes[5]] == 0).all())
    m = bc.pair_mismatch(law, form, planes, p, got)
    assert m["over"] == 0, m
    if form == "dense":
        assert m["rows_equal"], m
    else:
        assert m["row_over"] == 0, m


def test_batched_pair_kernels_share_one_parameter_vector(cuda_device):
    """Shared params reach the kernels as a stride-0 (B, P) view of the
    cached vector; a contiguous copy of the same rows gives the same
    forces bitwise (dense)."""
    planes = bc.batch_planes(5, 300, seed=2, device=cuda_device)
    p = MoussaidParams()
    prm = cuda_forces.law_rows("moussaid", p, 5, cuda_device)
    assert prm.stride(0) == 0
    x, y, vx, vy, rad, alive = planes[:6]
    a = cuda_forces.pair_force_dense_batched(x, y, vx, vy, rad, alive, prm)
    c = cuda_forces.pair_force_dense_batched(x, y, vx, vy, rad, alive,
                                             prm.contiguous())
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


def test_batched_kernels_reject_bad_inputs(cuda_device):
    planes = bc.batch_planes(3, 50, seed=4, device=cuda_device)
    x, y, vx, vy, rad, alive = planes[:6]
    prm = cuda_forces.law_rows("moussaid", MoussaidParams(), 3, cuda_device)
    with pytest.raises(ValueError, match="prm"):
        cuda_forces.pair_force_sym_batched(x, y, vx, vy, rad, alive,
                                           prm[:2])
    with pytest.raises(ValueError, match="planes"):
        cuda_forces.pair_force_dense_batched(x, y[:, :49].contiguous(), vx,
                                             vy, rad, alive, prm)
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        cuda_forces.pair_force_sym_batched(x[0], y[0], vx[0], vy[0], rad[0],
                                           alive[0], prm)
    with pytest.raises(ValueError, match="no sym_batched"):
        cuda_forces.pair_force_sym_batched(x, y, vx, vy, None, alive, prm,
                                           law="helbing")
    scene = stepper.prepare_scene(benchmark_bundle(
        50, with_borders=True, device=cuda_device)[0])
    seg = scene.borders_seg
    with pytest.raises(ValueError, match="in a batch of 3"):
        cuda_env.env_moussaid_batched(
            x, y, vx, vy, rad, alive, seg,
            torch.zeros((seg.num_segments, 2), device=cuda_device),
            dataclasses.replace(MoussaidParams(),
                                A=torch.ones(2, device=cuda_device)))


def batched_env_case(b, n, device, sweep):
    """Config #3's environment around ``b`` crowds of ``n`` (one step in,
    10% dead), each row in its own Hilbert order; with ``sweep`` the border
    ``a``, the parked cars' ``A`` and the vehicles' perception threshold
    (per-row filter radii) differ by row."""
    from carla_social_force_model_tpu_torch.api.synthetic import (
        batched_crowds)
    from carla_social_force_model_tpu_torch.parallel.sweeps import (
        batch_params)
    from carla_social_force_model_tpu_torch.models.params import map_leaves
    scene, params, cfg, _ = benchmark_bundle(
        n, with_borders=True, with_obstacles=True, num_steps_hint=20,
        device=device)
    scene = stepper.prepare_scene(dataclasses.replace(
        scene, spawn=batched_crowds(b, n, extent=float(np.sqrt(n)),
                                    device=device)))
    if sweep:
        params = batch_params(
            params, border_a=torch.linspace(0.5, 12.0, b),
            static_obstacle_A=torch.linspace(1.0, 9.0, b),
            dynamic_obstacle_perception_threshold=torch.linspace(5.0, 60.0,
                                                                 b))
        params = map_leaves(params, lambda t: t.to(device).contiguous())
    state, _ = stepper.rollout(PedState.empty(n, device=device, batch=b),
                               scene, params, cfg, 1, record=False)
    rng = np.random.default_rng(b)
    dead = torch.from_numpy(rng.uniform(size=(b, n)) < 0.1).to(device)
    state = dataclasses.replace(state, alive=state.alive & ~dead)
    snap = vehicles.vehicle_snapshot_at(scene.vehicles, 3)
    return bc.sorted_rows(state), bc.env_jobs(scene, snap, params)


@pytest.mark.parametrize("sweep", [False, True])
@pytest.mark.parametrize("b,n", [(1, 130), (4, 1000)])
def test_batched_env_kernels_match_plain_and_unbatched(cuda_device, b, n,
                                                       sweep):
    """The batched environment kernels on config #3's jobs (borders,
    parked cars, vehicles), one launch for every row: against their plain
    batched versions (1e-5 + 1e-5*|f|) and equal to the unbatched kernel on
    each row with that row's parameters and filter radii, bitwise."""
    planes, jobs = batched_env_case(b, n, cuda_device, sweep)
    for label, (kernel, seg, args, active) in jobs.items():
        cuda_env.reset_launch_counts()
        got = bc.env_batch_run(kernel, planes, seg, args, active)
        torch.cuda.synchronize()
        assert cuda_env.LAUNCHES[kernel + "_batched"] == 1
        assert torch.isfinite(got).all()
        assert bool((got[:, ~planes[5]] == 0).all())
        err, over, equal = bc.env_mismatch(kernel, planes, seg, args, active,
                                           got)
        assert over == 0, (label, err)
        assert equal, label


@pytest.mark.parametrize("case", ["config1 sym", "config1 dense",
                                  "config3", "sweep config3",
                                  "powerlaw", "helbing"])
def test_batched_steps_through_kernels_match_plain_steps(cuda_device, case):
    """Every step of a 20-step batched rollout through the kernels within
    1e-4 m (L-inf, each row) of the plain versions' step from the same
    state, with equal modes and alive masks; one launch of each batched
    kernel per step."""
    from carla_social_force_model_tpu_torch.api.synthetic import (
        batched_crowds)
    from carla_social_force_model_tpu_torch.parallel.sweeps import (
        batch_params)
    b, n, steps = 4, 400, 20
    geometry = case.endswith("config3")
    scene, params, cfg, _ = benchmark_bundle(
        n, with_borders=geometry, with_obstacles=geometry,
        num_steps_hint=steps, device=cuda_device)
    scene = dataclasses.replace(scene, spawn=batched_crowds(
        b, n, extent=float(np.sqrt(n)), device=cuda_device))
    cfg = dataclasses.replace(cfg, symmetric_pairs=case != "config1 dense")
    if case == "powerlaw":
        params = dataclasses.replace(params, enable_pedestrian=False,
                                     enable_powerlaw=True)
    if case == "helbing":
        params = dataclasses.replace(params, enable_pedestrian=False,
                                     enable_ped_repulsive=True)
    if case.startswith("sweep"):
        params = batch_params(params, pedestrian_A=torch.linspace(
            1.0, 9.0, b, device=cuda_device), border_b=torch.linspace(
            0.1, 0.3, b, device=cuda_device))
    cuda_forces.reset_launch_counts()
    cuda_env.reset_launch_counts()
    for k, gap, equal, finite in bc.one_step_gaps(
            scene, params, cfg, PedState.empty(n, device=cuda_device,
                                               batch=b), steps):
        assert equal and finite, k
        assert gap.max().item() <= 1e-4, (k, gap)
    launched = {k: v for m in (cuda_forces, cuda_env)
                for k, v in m.LAUNCHES.items() if v}
    pair = {"config1 dense": "pair_force_dense_batched",
            "powerlaw": "powerlaw_sym_batched",
            "helbing": "helbing_dense_batched"}.get(case,
                                                    "pair_force_sym_batched")
    want = {pair: steps}
    if geometry:
        want.update(env_exp_batched=steps, env_moussaid_batched=2 * steps)
    assert launched == want
