"""PyTorch port: ensembles over a 2-D ``(batch, agents)`` mesh (ROADMAP item
19b.4) under the ``ring`` column schedule against the JAX package, and
every row against the port's own unbatched sharded rollout.

As ``tests/test_torch_ensemble_sharded.py`` (whose helpers this file
uses): the JAX package's ``make_sharded_ensemble_rollout`` on its 2 x 4
mesh of virtual CPU devices, the port's on a ``LocalMesh`` of 2 x 4
virtual shards, where the ring is the plain ring row by row.  The
``ring_kernel`` schedule is in
``tests/test_torch_ensemble_sharded_ring_kernel.py``.
"""
import dataclasses

import pytest
import torch

from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.parallel import make_mesh
from carla_social_force_model_tpu_torch.parallel.sharding import (
    make_sharded_rollout, prepare_sharded_scene)
from test_torch_ensemble import port_of
from test_torch_ensemble_cutoff import row_spawn
from test_torch_ensemble_sharded import (B, LAW_SWITCHES, N, STEPS,
                                         WIDE_CUTOFF_M, case_against_jax,
                                         jax_ensemble, port_sharded)

@pytest.mark.parametrize("law", sorted(LAW_SWITCHES))
@pytest.mark.parametrize("cutoff,n", [(None, 24), (WIDE_CUTOFF_M, 22)])
def test_ring_matches_the_jax_package(law, cutoff, n):
    """``ring`` on the 2 x 4 mesh, every law, without and with a cutoff:
    the port's plain ring (i -> i + 1) against the JAX package's."""
    case_against_jax("ring", law, cutoff, n)


@pytest.mark.parametrize("comm,cutoff", [("gather", None), ("ring", 3.0)])
def test_rows_equal_the_unbatched_sharded_rollout(comm, cutoff):
    """Row b of the 2-D mesh rollout against the port's own
    ``make_sharded_rollout`` of crowd b over a 1-D mesh of the same 4
    agent shards (with a truncating cutoff too): bitwise equal.  On the
    CPU the batched sharded pair force takes each row through the same
    unbatched plain functions on the same slots in the same order, and
    every other term of the step is elementwise or a per-row reduction, so
    no "position-dependent rounding" (ROADMAP Queue 3) parts them."""
    scene, params, cfg = port_of(*jax_ensemble(B, N))
    cfg = dataclasses.replace(cfg, axis_comm=comm, interaction_cutoff=cutoff)
    final, rec = port_sharded(scene, params, cfg)
    mesh = make_mesh(4, device="cpu")
    for row in range(B):
        one, cap = prepare_sharded_scene(dataclasses.replace(
            scene, spawn=row_spawn(scene.spawn, row)), 4)
        f1, r1 = make_sharded_rollout(mesh, one, params, cfg, STEPS,
                                      record=True)(
            PedState.empty(cap, device="cpu"))
        assert torch.equal(rec.alive[row], r1.alive), row
        assert torch.equal(rec.mode[row], r1.mode), row
        assert torch.equal(rec.pos[row], r1.pos), row
        assert torch.equal(final.pos[row], f1.pos), row
