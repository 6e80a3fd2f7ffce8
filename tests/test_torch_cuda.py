"""PyTorch port on an NVIDIA card: the CUDA pair-force and environment-force
kernels against their plain PyTorch versions, and the rollouts through them.

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
from carla_social_force_model_tpu_torch.ops import cuda_env, cuda_forces, forces
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
    assert cuda_forces.LAUNCHES == {"pair_force_sym": 2,
                                    "pair_force_dense": 1}


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
    assert cuda_env.LAUNCHES == {"env_exp": 2, "env_moussaid": 2}
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
    assert cuda_env.LAUNCHES == {"env_exp": 20,
                                 "env_moussaid": 40 if with_obstacles else 0}
    assert torch.equal(kern.alive, plain.alive)
    assert torch.equal(kern.mode, plain.mode)
    assert (kern.pos - plain.pos).abs().max().item() <= 1e-4
