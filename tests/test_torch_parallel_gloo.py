"""PyTorch port: agent sharding over ``torch.distributed`` (gloo, CPU).

D processes (D = 2 and 3), started with ``torch.multiprocessing`` and
joined through a ``FileStore`` under the test's temporary directory (no
TCP port, so parallel test workers cannot collide), each run their shard
of config #1 through ``make_sharded_rollout`` on a ``ProcessGroupAxis``:
``all_gather`` over ``dist.all_gather``, ``ppermute`` over
``dist.batch_isend_irecv``.  Their shards, put together, must equal the
``LocalMesh`` rollout bitwise for every schedule: the same plain
operations in the same order (one intra-op thread on both sides).
"""
import dataclasses

import pytest
import torch
import torch.multiprocessing as mp

from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.parallel import (LocalMesh,
                                                         ProcessGroupAxis)
from carla_social_force_model_tpu_torch.parallel.sharding import (
    make_sharded_rollout, prepare_sharded_scene)

COMMS = ("gather", "ring", "ring_kernel")
STEPS = 12


def rollouts(axis, n_shards):
    """``{comm: (final state, record)}`` of config #1 (N = 50) on ``axis``
    (a LocalMesh, or this process's ProcessGroupAxis)."""
    scene, params, cfg, _ = benchmark_bundle(50, extent=7.0, device="cpu")
    scene, cap = prepare_sharded_scene(scene, n_shards)
    out = {}
    for comm in COMMS:
        run = make_sharded_rollout(axis, scene, params,
                                   dataclasses.replace(cfg, axis_comm=comm),
                                   STEPS, record=True)
        out[comm] = run(PedState.empty(cap, device="cpu"))
    return out


def worker(rank, world, store_path, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        axis = ProcessGroupAxis()
        assert (axis.index, axis.size) == (rank, world)
        # the collectives on their own: bool travels as uint8
        got = axis.all_gather(torch.tensor([rank % 2 == 0, True]))
        assert got.dtype == torch.bool and got.shape == (2 * world,)
        perm = [(i, (i + 1) % world) for i in range(world)]
        assert int(axis.ppermute(torch.tensor([rank]), perm)) == \
            (rank - 1) % world
        torch.save(rollouts(axis, world), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 3])
def test_process_group_rollout_equals_local_mesh_bitwise(tmp_path, world):
    mp.spawn(worker, args=(world, str(tmp_path / "store"), str(tmp_path)),
             nprocs=world, join=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = rollouts(LocalMesh(world, device="cpu"), world)
    finally:
        torch.set_num_threads(threads)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    for comm in COMMS:
        final, rec = want[comm]
        for f in dataclasses.fields(PedState):
            got = torch.cat([getattr(r[comm][0], f.name) for r in ranks])
            assert torch.equal(got, getattr(final, f.name)), (comm, f.name)
        for i, plane in enumerate(rec):
            got = torch.cat([r[comm][1][i] for r in ranks], dim=1)
            assert torch.equal(got, plane), (comm, i)
        assert rec.alive[-1].any()
