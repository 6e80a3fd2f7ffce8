"""PyTorch port: the agent axis (``parallel/mesh.py``) and the padding of
``parallel/sharding.py`` on the CPU.

A :class:`LocalMesh` runs D shards as threads of one process; its
collectives must have ``jax.lax.all_gather(tiled=True)``'s and
``jax.lax.ppermute``'s semantics, and a shard that raises must stop the run
at once instead of leaving the others waiting at a barrier.
"""
import time

import pytest
import torch

from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.parallel import (LocalMesh,
                                                         make_mesh, round_up)
from carla_social_force_model_tpu_torch.parallel.sharding import (
    pad_spawn_schedule, prepare_sharded_scene, shard_of)


def shard_values(d, width=3):
    return torch.arange(width, dtype=torch.float32) + 10.0 * d


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_all_gather_tiles_in_shard_order(n_shards):
    mesh = make_mesh(n_shards, device="cpu")
    outs = mesh.run(lambda ax, d: (ax.index, ax.size,
                                   ax.all_gather(shard_values(d))),
                    list(range(n_shards)))
    want = torch.cat([shard_values(d) for d in range(n_shards)])
    for d, (index, size, got) in enumerate(outs):
        assert (index, size) == (d, n_shards)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("shift", ["up", "down", "home"])
def test_ppermute_follows_source_destination_pairs(n_shards, shift):
    """``perm`` lists (source, destination): up is the plain ring's
    i -> i + 1, down the Pallas ring's d -> d - 1, home the half-ring's
    last hop of +(D // 2 + 1)."""
    step = {"up": 1, "down": -1, "home": n_shards // 2 + 1}[shift]
    perm = [(i, (i + step) % n_shards) for i in range(n_shards)]
    mesh = make_mesh(n_shards, device="cpu")
    outs = mesh.run(lambda ax, d: ax.ppermute(shard_values(d), perm),
                    list(range(n_shards)))
    for d, got in enumerate(outs):
        assert torch.equal(got, shard_values((d - step) % n_shards))


def test_ppermute_gives_zeros_where_no_pair_arrives():
    mesh = make_mesh(3, device="cpu")
    outs = mesh.run(lambda ax, d: ax.ppermute(shard_values(d) + 1.0,
                                              [(0, 1)]), [0, 1, 2])
    assert torch.equal(outs[1], shard_values(0) + 1.0)
    assert torch.equal(outs[0], torch.zeros(3))
    assert torch.equal(outs[2], torch.zeros(3))


def test_host_collective_hands_each_shard_its_part():
    mesh = make_mesh(4, device="cpu")
    outs = mesh.run(lambda ax, d: ax.host_collective(
        lambda vals: [sum(vals) * 10 + i for i in range(len(vals))], d),
        [0, 1, 2, 3])
    assert outs == [60, 61, 62, 63]


def test_a_raising_shard_stops_the_run():
    """Shard 2 raises before its first collective: the others, waiting at
    the barrier, fail at once and ``run`` re-raises shard 2's error."""
    mesh = LocalMesh(4, device="cpu", timeout=60.0)

    def body(ax, d):
        if d == 2:
            raise RuntimeError("shard 2 failed")
        return ax.all_gather(shard_values(d))

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        mesh.run(body, [0, 1, 2, 3])
    assert time.perf_counter() - t0 < 30.0
    # the mesh runs again afterwards
    outs = mesh.run(lambda ax, d: ax.all_gather(shard_values(d)),
                    [0, 1, 2, 3])
    assert outs[0].shape == (12,)


def test_a_raising_collective_stops_the_run():
    mesh = LocalMesh(3, device="cpu", timeout=60.0)

    def boom(vals):
        raise ValueError("launch refused")

    with pytest.raises(ValueError, match="launch refused"):
        mesh.run(lambda ax, d: ax.host_collective(boom, d), [0, 1, 2])


def test_make_mesh_refuses_batch_shards_and_empty_meshes():
    with pytest.raises(NotImplementedError, match="item 19"):
        make_mesh(2, n_batch_shards=2, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    assert round_up(10, 4) == 12 and round_up(12, 4) == 12


def test_padding_slots_never_spawn_and_shards_split_evenly():
    """``prepare_sharded_scene`` pads every slot tensor (the route buffer,
    ``law_id`` and ``pair_scale`` too) to a multiple of D; padding slots
    have ``step = -1``."""
    scene, _, _, _ = benchmark_bundle(10, device="cpu")
    spawn = scene.spawn
    spawn = type(spawn)(**{**spawn.__dict__,
                           "law_id": torch.zeros(10, dtype=torch.int32),
                           "pair_scale": torch.ones(10)})
    scene = type(scene)(**{**scene.__dict__, "spawn": spawn})
    padded, cap = prepare_sharded_scene(scene, 4)
    assert cap == 12
    s = padded.spawn
    assert s.capacity == 12 and s.routes.wp_x.shape[0] == 12
    assert s.law_id.shape == (12,) and s.pair_scale.shape == (12,)
    assert torch.equal(s.step[10:], torch.tensor([-1, -1], dtype=s.step.dtype))
    assert torch.equal(s.step[:10], spawn.step)
    parts = [shard_of(s, d, 4) for d in range(4)]
    assert all(p.capacity == 3 for p in parts)
    assert torch.equal(torch.cat([p.pos_x for p in parts]), s.pos_x)
    assert pad_spawn_schedule(spawn, 10) is spawn
    with pytest.raises(ValueError, match="prepare_sharded_scene"):
        shard_of(spawn, 0, 4)


def test_collectives_under_thread_stress():
    """More shards than cores, a switch interval of a microsecond, and 200
    rounds of all-gather and ppermute in both directions: every round's
    result is every shard's own (a slot overwritten before all shards read
    it would break it)."""
    import os
    import sys
    n_shards = 2 * (os.cpu_count() or 1) + 3
    up = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    down = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def body(ax, d):
        for r in range(200):
            t = torch.tensor([float(d * 1000 + r)])
            want = torch.arange(n_shards, dtype=torch.float32) * 1000 + r
            if not torch.equal(ax.all_gather(t), want):
                return False
            if float(ax.ppermute(t, up)) != ((d - 1) % n_shards) * 1000 + r:
                return False
            if float(ax.ppermute(t, down)) != ((d + 1) % n_shards) * 1000 + r:
                return False
        return True

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        outs = LocalMesh(n_shards, device="cpu", timeout=120.0).run(
            body, list(range(n_shards)))
    finally:
        sys.setswitchinterval(old)
    assert all(outs)
    assert time.perf_counter() - t0 < 120.0
