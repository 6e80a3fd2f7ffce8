"""PyTorch port: pair forces against the JAX package, and the CUDA kernels
against their plain PyTorch version.

The same numpy-seeded inputs go through the JAX function and the port.  On
the CPU the port's pair-force path is the plain PyTorch version; the tests
marked ``cuda`` compare the hand-written kernels with it on a card and skip
without one.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from carla_social_force_model_tpu.models.params import (
    MoussaidParams as JaxMoussaidParams)
from carla_social_force_model_tpu.ops import forces as jax_forces
from carla_social_force_model_tpu.ops.pallas_forces import (
    pedestrian_force_pallas)
from carla_social_force_model_tpu_torch.models.params import (
    MoussaidParams, moussaid_vector)
from carla_social_force_model_tpu_torch.ops import cuda_forces, forces


def crowd(n, seed, extent=15.0, alive_frac=0.8):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    vel = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, (n,)).astype(np.float32)
    alive = rng.uniform(size=n) < alive_frac
    return pos, vel, radius, alive


def port_force(pos, vel, radius, alive, p=MoussaidParams(), device="cpu",
               **kw):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in dict(px=pos[:, 0], py=pos[:, 1], vx=vel[:, 0],
                          vy=vel[:, 1], r=radius, a=alive).items()}
    fx, fy = forces.pedestrian_force(t["px"], t["py"], t["vx"], t["vy"],
                                     t["r"], t["a"], p, **kw)
    return np.stack([fx.cpu().numpy(), fy.cpu().numpy()], axis=-1)


def jax_args(pos, vel, radius, alive):
    return (jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(radius),
            jnp.asarray(alive))


@pytest.mark.parametrize("use_radius", [False, True])
@pytest.mark.parametrize("n", [16, 130])
def test_plain_matches_jax_forces(n, use_radius):
    """Port plain pedestrian_force == JAX forces.pedestrian_force (f32,
    identical formulation: rtol = atol = 2e-5)."""
    pos, vel, radius, alive = crowd(n, seed=n + use_radius)
    want = jax_forces.pedestrian_force(*jax_args(pos, vel, radius, alive),
                                       JaxMoussaidParams(),
                                       use_ped_radius=use_radius)
    got = port_force(pos, vel, radius, alive, use_ped_radius=use_radius,
                     row_block=48)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    assert np.all(got[~alive] == 0.0)


@pytest.mark.parametrize("symmetric", [False, True])
def test_plain_matches_jax_pallas_kernel(symmetric):
    """Port plain pedestrian_force == the JAX Pallas kernel in interpret
    mode, dense and symmetric launches: 2e-4, the f32 summation-order
    tolerance the JAX package uses for its own symmetric kernel."""
    pos, vel, radius, alive = crowd(130, seed=7)
    want = pedestrian_force_pallas(*jax_args(pos, vel, radius, alive),
                                   JaxMoussaidParams(), interpret=True,
                                   row_tile=8, col_tile=128,
                                   symmetric=symmetric)
    got = port_force(pos, vel, radius, alive)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_coincident_pedestrians_give_exact_zero():
    pos = np.array([[1.0, 2.0], [1.0, 2.0], [4.0, 2.0]], np.float32)
    vel = np.array([[1.0, 0.0], [1.0, 0.0], [-1.0, 0.0]], np.float32)
    radius = np.full((3,), 0.3, np.float32)
    alive = np.ones((3,), bool)
    for use_radius in (False, True):
        got = port_force(pos, vel, radius, alive, use_ped_radius=use_radius)
        assert np.isfinite(got).all()
        # the coincident pair adds nothing: each feels only the third agent
        solo = port_force(pos[[0, 2]], vel[[0, 2]], radius[[0, 2]],
                          alive[[0, 2]], use_ped_radius=use_radius)
        np.testing.assert_array_equal(got[0], solo[0])
        np.testing.assert_array_equal(got[1], solo[0])


def test_epsilon_zero_no_spurious_tangential():
    """epsilon = 0 and mutually stationary agents: theta == 0 exactly and
    sign(0) = 0, so there is no sideways force (JAX package regression)."""
    p = dataclasses.replace(MoussaidParams(), epsilon=0.0)
    pos = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
    vel = np.zeros((2, 2), np.float32)
    radius = np.full((2,), 0.3, np.float32)
    alive = np.ones((2,), bool)
    got = port_force(pos, vel, radius, alive, p=p)
    want = jax_forces.pedestrian_force(
        *jax_args(pos, vel, radius, alive),
        dataclasses.replace(JaxMoussaidParams(), epsilon=0.0))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    assert got[0, 1] == 0.0 and got[1, 1] == 0.0
    assert got[0, 0] < 0.0 < got[1, 0]


def test_overlapping_radii_zero_interaction_vector():
    """use_ped_radius, overlapping agents, lambda*dv + e == 0: d < 0 and
    B == 0, and the rule is zero force, not exp(+inf)*0 = NaN."""
    pos = np.array([[0.0, 0.0], [0.4, 0.0]], np.float32)
    vel = np.array([[0.0, 0.0], [0.5, 0.0]], np.float32)   # lam*dv = -e
    radius = np.full((2,), 0.3, np.float32)
    alive = np.ones((2,), bool)
    got = port_force(pos, vel, radius, alive, use_ped_radius=True)
    assert np.isfinite(got).all()
    assert np.all(got[0] == 0.0)
    want = jax_forces.pedestrian_force(*jax_args(pos, vel, radius, alive),
                                       JaxMoussaidParams(),
                                       use_ped_radius=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_dead_rows_exactly_zero_and_invisible():
    pos, vel, radius, alive = crowd(40, seed=3, alive_frac=0.5)
    got = port_force(pos, vel, radius, alive, row_block=16)
    assert np.all(got[~alive] == 0.0)
    # moving the dead agents anywhere changes nothing for the living
    pos2 = pos.copy()
    pos2[~alive] = np.float32(3.0)
    np.testing.assert_array_equal(port_force(pos2, vel, radius, alive,
                                             row_block=16), got)


def test_kernel_dispatch_uses_plain_version_on_cpu():
    pos, vel, radius, alive = crowd(50, seed=5)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], radius, alive)]
    cuda_forces.reset_launch_counts()
    for symmetric in (True, False):
        fx, fy = cuda_forces.pedestrian_force_kernel(
            *t, MoussaidParams(), symmetric=symmetric)
        np.testing.assert_array_equal(
            np.stack([fx.numpy(), fy.numpy()], -1),
            port_force(pos, vel, radius, alive))
    assert set(cuda_forces.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("kernel", ["pair_force_sym", "pair_force_dense"])
def test_kernels_refuse_cpu_tensors(kernel):
    """A kernel wrapper never computes on the CPU itself: the plain path is
    chosen by pedestrian_force_kernel, not by a fallback."""
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(cuda_forces, kernel)(z, z, z, z, z, torch.ones(4, dtype=bool),
                                     torch.zeros(6))


def test_kernel_dispatch_rejects_other_devices():
    z = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no pair-force path"):
        cuda_forces.pedestrian_force_kernel(
            z, z, z, z, z, torch.ones(4, dtype=bool, device="meta"),
            MoussaidParams())


def test_moussaid_vector_layout():
    p = MoussaidParams(lambda_=1.5, A=3.0, gamma=0.4, n=2.5, n_prime=3.5,
                       epsilon=0.01)
    v = moussaid_vector(p, torch.device("cpu"))
    assert v.dtype == torch.float32 and v.shape == (6,)
    np.testing.assert_array_equal(
        v.numpy(), np.float32([1.5, 3.0, 0.4, 2.5, 3.5, 0.01]))
