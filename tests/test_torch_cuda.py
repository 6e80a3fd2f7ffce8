"""PyTorch port on an NVIDIA card: the CUDA pair-force kernels against their
plain PyTorch version, and the rollout through them.

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
from carla_social_force_model_tpu_torch.ops import cuda_forces, forces

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
