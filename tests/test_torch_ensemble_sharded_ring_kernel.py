"""PyTorch port: ensembles over a 2-D ``(batch, agents)`` mesh (ROADMAP item
19b.4) under the ``ring_kernel`` column schedule against the JAX package.

On the CPU the port's ``ring_kernel`` runs the plain ring (the card's
in-kernel ring, ``ring_force_batched``, is held in
``tests/test_torch_cuda.py``); the JAX package's jnp path maps
``ring_kernel`` to its ``ring`` (its stepper.py:343).  Helpers from
``tests/test_torch_ensemble_sharded.py``.
"""
import dataclasses

import pytest
import torch

from carla_social_force_model_tpu_torch.api import synthetic
from carla_social_force_model_tpu_torch.parallel import make_mesh, sweeps
from test_torch_ensemble_sharded import (B, LAW_SWITCHES, N, STEPS,
                                         WIDE_CUTOFF_M, case_against_jax)


@pytest.mark.parametrize("law", sorted(LAW_SWITCHES))
@pytest.mark.parametrize("cutoff,n", [(None, 24), (WIDE_CUTOFF_M, 22)])
def test_ring_kernel_matches_the_jax_package(law, cutoff, n):
    """``ring_kernel`` on the 2 x 4 mesh, every law, without and with a
    cutoff."""
    case_against_jax("ring_kernel", law, cutoff, n)


def test_batch_rows_are_isolated():
    """Changing row 1's crowd leaves row 0 bitwise unchanged: the
    collectives stay inside a batch row and the crowds of one shard are
    independent rows (``ring_kernel``: one launch for every row)."""
    scene, params, cfg, _ = synthetic.benchmark_bundle(N, extent=12.0,
                                                       device="cpu")
    spawn = synthetic.batched_crowds(B, N, extent=12.0, device="cpu")
    other = synthetic.batched_crowds(B, N, extent=12.0, seed=7, device="cpu")
    moved = dataclasses.replace(spawn, **{
        f: torch.cat([getattr(spawn, f)[:1], getattr(other, f)[1:2],
                      getattr(spawn, f)[2:]])
        for f in ("pos_x", "pos_y", "vel_x", "vel_y")})
    assert not torch.equal(moved.pos_x[1], spawn.pos_x[1])
    cfg = dataclasses.replace(cfg, axis_comm="ring_kernel")
    mesh = make_mesh(4, n_batch_shards=2, device="cpu")
    runs = [sweeps.make_sharded_ensemble_rollout(
        mesh, dataclasses.replace(scene, spawn=s), params, cfg, STEPS,
        record=True)() for s in (spawn, moved)]
    (f0, r0), (f1, r1) = runs
    assert torch.equal(r0.pos[0], r1.pos[0])
    assert torch.equal(f0.pos[0], f1.pos[0])
    assert not torch.equal(r0.pos[1], r1.pos[1])
    assert torch.equal(r0.pos[2:], r1.pos[2:])
