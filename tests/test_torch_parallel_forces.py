"""PyTorch port: the sharded pair forces against the JAX package.

The same numpy-seeded crowd (15% dead, the dead share uneven across the
shards, one coincident live pair, N = 61 padded with dead agents to 64)
goes through the JAX package's pair forces under ``jax.shard_map`` on its
8-device virtual CPU mesh (``axis_comm`` ``gather`` and ``ring``, the jnp
path) and through the port's plain sharded forms on a ``LocalMesh`` of 8
(``gather``, and the plain ring that ``ring`` and ``ring_kernel`` run
there), for all three laws, with and without ``use_ped_radius``.  With a
cutoff, the JAX package's sorted Pallas kernels (interpret mode, its own
sharded schedules) are the reference.

Tolerance: 1e-4 + 1e-4 * S, S the row's sum of |f_ij| for the power law
and |f| otherwise (tests/family_cases.py); against the Pallas kernels
2e-4 + 2e-4 * S, their polynomial atan2 and rsqrt(d2 + tiny) differing at
the ulp level (tests/test_torch_cutoff.py's FORCE_TOL).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from carla_social_force_model_tpu.models import params as jparams
from carla_social_force_model_tpu.ops import forces as jforces
from carla_social_force_model_tpu.ops import pallas_forces as jpf
from carla_social_force_model_tpu.parallel.mesh import make_mesh as jmesh
from carla_social_force_model_tpu_torch.ops import cuda_forces
from carla_social_force_model_tpu_torch.parallel import make_mesh
from shard_cases import law_params, plain_pairs, shard_planes

N, D = 61, 8
PAD = 64
CUTOFF = 3.0
KERNEL_TOL = 2e-4


@functools.lru_cache(maxsize=None)
def crowd():
    """numpy planes x, y, vx, vy, radius, alive, ex, ey of N agents padded
    with dead ones to PAD."""
    planes = [a.numpy() for a in shard_planes(N, seed=17, device="cpu",
                                              extent=5.0, n_shards=D)]
    out = []
    for a in planes:
        pad = np.zeros(PAD - N, a.dtype)
        out.append(np.concatenate([a, pad]))
    return out


def jax_params(law):
    return {"moussaid": jparams.MoussaidParams,
            "powerlaw": jparams.PowerLawParams,
            "helbing": jparams.PedRepulsiveParams}[law]()


@functools.lru_cache(maxsize=None)
def jax_sharded(law, use_radius, comm):
    """The JAX package's jnp pair force of ``law`` under shard_map."""
    x, y, vx, vy, rad, alive, ex, ey = crowd()
    pos = jnp.stack([x, y], -1)
    vel = jnp.stack([vx, vy], -1)
    p = jax_params(law)
    mesh = jmesh(n_agent_shards=D)
    if law == "moussaid":
        def f(pos, vel, rad, alive, des):
            return jforces.pedestrian_force(pos, vel, rad, alive, p,
                                            use_ped_radius=use_radius,
                                            axis_name="agents",
                                            axis_comm=comm)
    elif law == "powerlaw":
        def f(pos, vel, rad, alive, des):
            return jforces.powerlaw_force(pos, vel, rad, alive, p,
                                          axis_name="agents", axis_comm=comm)
    else:
        def f(pos, vel, rad, alive, des):
            return jforces.ped_repulsive_force(pos, vel, des, alive, p,
                                               axis_name="agents",
                                               axis_comm=comm)
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("agents"),) * 5,
                               out_specs=P("agents"), check_vma=False))
    out = fn(pos, vel, jnp.asarray(rad), jnp.asarray(alive),
             jnp.stack([ex, ey], -1))
    return np.asarray(out).T[:, :N]


@functools.lru_cache(maxsize=None)
def jax_sharded_cutoff(law, comm):
    """The JAX package's sorted Pallas kernels with the cutoff under
    shard_map (interpret mode)."""
    x, y, vx, vy, rad, alive, ex, ey = crowd()
    pos = jnp.stack([x, y], -1)
    vel = jnp.stack([vx, vy], -1)
    p = jax_params(law)
    mesh = jmesh(n_agent_shards=D)

    def f(pos, vel, rad, alive, ex, ey):
        return jpf.pedestrian_force_pallas_sorted(
            pos, vel, rad, alive, p, cutoff=CUTOFF, row_tile=8,
            col_tile=128, interpret=True, axis_name="agents", axis_comm=comm,
            law=law, desired=(ex, ey) if law == "helbing" else None)

    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("agents"),) * 6,
                               out_specs=P("agents"), check_vma=False))
    out = fn(pos, vel, jnp.asarray(rad), jnp.asarray(alive), jnp.asarray(ex),
             jnp.asarray(ey))
    return np.asarray(out).T[:, :N]


def port_sharded(law, use_radius, comm, cutoff=None):
    """The port's plain sharded force on a LocalMesh of D, with each
    shard's slots Hilbert-sorted under a cutoff (the sorted path)."""
    planes = [torch.from_numpy(a.copy()) for a in crowd()]
    x, y, vx, vy, rad, alive, ex, ey = planes
    k = PAD // D
    mesh = make_mesh(D, device="cpu")
    p = law_params(law)

    def body(ax, d):
        sl = slice(d * k, (d + 1) * k)
        hel = law == "helbing"
        args = (x[sl], y[sl], vx[sl], vy[sl], None if hel else rad[sl],
                alive[sl], p)
        kw = dict(use_ped_radius=use_radius, law=law,
                  desired=(ex[sl], ey[sl]) if hel else None, axis=ax,
                  comm=comm)
        if cutoff is None:
            return cuda_forces.pedestrian_force_kernel(*args, **kw)
        return cuda_forces.pedestrian_force_sorted(*args, cutoff, **kw)

    outs = mesh.run(body, list(range(D)))
    return torch.stack([torch.cat([o[0] for o in outs]),
                        torch.cat([o[1] for o in outs])]).numpy()[:, :N]


def bound(law, use_radius, cutoff=None, tol=1e-4):
    """``(want, lim)``: the port's one-device plain force and the bound."""
    planes = [torch.from_numpy(a.copy()) for a in crowd()]
    if law == "moussaid" and use_radius:
        x, y, vx, vy, rad, alive = planes[:6]
        want = torch.stack(cuda_forces.plain_law_force(
            law, x, y, vx, vy, rad, alive, law_params(law), True, 1024,
            cutoff, None))
        scale = want.abs()
    else:
        want = plain_pairs(law, planes, planes, cutoff=cutoff)
        mag = plain_pairs(law, planes, planes, cutoff=cutoff,
                          magnitudes=True)
        scale = mag if law == "powerlaw" else want.abs()
    return want.numpy()[:, :N], (tol + tol * scale).numpy()[:, :N]


VARIANTS = [("moussaid", False), ("moussaid", True), ("powerlaw", False),
            ("helbing", False)]


@pytest.mark.parametrize("law,use_radius", VARIANTS)
@pytest.mark.parametrize("comm", ["gather", "ring", "ring_kernel"])
def test_sharded_plain_forces_match_jax_shard_map(law, use_radius, comm):
    """The port's sharded forms against the JAX package's ``gather`` and
    ``ring`` under shard_map and against one device (the port's, which the
    single-device tests hold to the JAX package's)."""
    got = port_sharded(law, use_radius, comm)
    want, lim = bound(law, use_radius)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= lim).all()
    for jcomm in ("gather", "ring"):
        ref = jax_sharded(law, use_radius, jcomm)
        assert (np.abs(got - ref) <= lim).all(), jcomm
    alive = crowd()[5][:N]
    assert (got[:, ~alive] == 0).all()


@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
@pytest.mark.parametrize("comm", ["gather", "ring"])
def test_sharded_cutoff_forces_match_jax_kernels(law, comm):
    """With a 3 m cutoff each shard sorts its own slots: the port's sorted
    sharded path against the JAX package's sorted Pallas kernels under
    shard_map, and against the port's one-device cutoff force."""
    got = port_sharded(law, False, comm, cutoff=CUTOFF)
    want, lim = bound(law, False, cutoff=CUTOFF)
    assert (np.abs(got - want) <= lim).all()
    ref = jax_sharded_cutoff(law, comm)
    _, klim = bound(law, False, cutoff=CUTOFF, tol=KERNEL_TOL)
    assert (np.abs(got - ref) <= klim).all()
