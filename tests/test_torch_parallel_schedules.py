"""PyTorch port: the kernel schedules of the sharded pair force on the CPU.

``ops/cuda_forces.kernel_sharded_force`` drives the CUDA kernels on a card:
the gathered rectangular launch, the ring (shard d -> d - 1), the
half-ring (the local triangle, D // 2 full-block launches whose mirrored
column sums travel with the block, the home hop) and the in-kernel ring.
Here every kernel is replaced by its plain version (which also checks the
grid it is given and that the columns it is handed are the block its
offset names), so the schedules themselves run on a ``LocalMesh`` of
threads: each cross-shard block pair once, every accumulator home, and the
forces those of one device.  The plain ring of the CPU path is checked for
its own direction (shard i -> i + 1).
"""
import math

import numpy as np
import pytest
import torch

from carla_social_force_model_tpu_torch.ops import cuda_forces, cuda_ring
from carla_social_force_model_tpu_torch.ops.pair_grid import cutoff_sq
from carla_social_force_model_tpu_torch.parallel import make_mesh
from shard_cases import ATOL, RTOL, law_params, plain_pairs, shard_planes

CPU = torch.device("cpu")


class FakeKernels:
    """Plain stand-ins for ``cuda_forces._launch`` and
    ``cuda_ring.ring_force`` that record every launch as ``(form, row
    shard, column shard)`` and check that a rectangular launch's columns
    are the global planes at its column offset."""

    def __init__(self, monkeypatch, law, cutoff, global_x, n_local):
        self.law, self.cutoff = law, cutoff
        self.global_x, self.n = global_x, n_local
        self.calls = []
        monkeypatch.setattr(cuda_forces, "_launch", self.launch)
        monkeypatch.setattr(cuda_ring, "ring_force", self.ring)

    def launch(self, law, form, x, y, vx, vy, rad, alive, prm, use_radius,
               grid=None, desired=None, cols=None, row_offset=0,
               col_offset=0):
        assert law == self.law
        if grid is not None:
            assert grid.form == form and grid.c2 == cutoff_sq(self.cutoff)
            n_cols = x.shape[0] if cols is None else cols[0].shape[0]
            cuda_forces._check_grid(grid, x.shape[0], n_cols, x.device)
        else:
            assert self.cutoff is None or form in ("dense", "sym",
                                                   "sym_dense")
        if cols is not None:
            c0 = int(col_offset)
            assert torch.equal(cols[0],
                               self.global_x[c0:c0 + cols[0].shape[0]])
        self.calls.append((form, int(row_offset) // self.n,
                           int(col_offset) // self.n))
        p = law_params(law)
        out = cuda_forces.plain_law_force(
            law, x, y, vx, vy, rad, alive, p, use_radius, 1024, self.cutoff,
            desired, cols=cols, row_offset=row_offset, col_offset=col_offset,
            mirror=form.startswith("sym_dense"))
        return out

    def ring(self, x, y, vx, vy, radius, alive, prm, n_dev,
             use_radius=False, law="moussaid", desired=None, cutoff=None):
        self.calls.append(("ring_force", n_dev, x.shape[0]))
        return cuda_ring.ring_force_plain(x, y, vx, vy, radius, alive,
                                          law_params(law), n_dev,
                                          use_radius, law, desired, cutoff)


def run_schedule(planes, n_shards, law, comm, symmetric, cutoff):
    """Every shard's rows of the kernel schedule on a LocalMesh: (2, N)."""
    x, y, vx, vy, rad, alive, ex, ey = planes
    k = x.shape[0] // n_shards
    mesh = make_mesh(n_shards, device="cpu")

    def body(ax, d):
        sl = slice(d * k, (d + 1) * k)
        hel = law == "helbing"
        return cuda_forces.kernel_sharded_force(
            law, x[sl], y[sl], vx[sl], vy[sl], None if hel else rad[sl],
            alive[sl], law_params(law), ax, comm, symmetric=symmetric,
            desired=(ex[sl], ey[sl]) if hel else None, cutoff=cutoff)

    outs = mesh.run(body, list(range(n_shards)))
    return torch.stack([torch.cat([o[0] for o in outs]),
                        torch.cat([o[1] for o in outs])])


def single_device(planes, law, cutoff):
    want = plain_pairs(law, planes, planes, cutoff=cutoff)
    scale = plain_pairs(law, planes, planes, cutoff=cutoff, magnitudes=True)
    return want, ATOL + RTOL * (scale if law == "powerlaw" else want.abs())


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
def test_half_ring_computes_each_block_pair_once(monkeypatch, n_shards):
    """The half-ring at D = 2, 3, 4, 8: the diagonal once per shard, every
    unordered pair of different shards' blocks in exactly one full-block
    launch (the opposite pair of an even D by the lower id), and with
    every mirrored accumulator home the forces are one device's."""
    planes = shard_planes(24 * n_shards, seed=n_shards, device=CPU,
                          extent=6.0, n_shards=n_shards)
    fake = FakeKernels(monkeypatch, "moussaid", None, planes[0], 24)
    got = run_schedule(planes, n_shards, "moussaid", "ring", True, None)
    # the square triangle launch of each shard's own block
    assert [c[0] for c in fake.calls].count("sym") == n_shards
    blocks = [(r, c) for form, r, c in fake.calls if form == "sym_dense"]
    pairs = sorted(tuple(sorted(b)) for b in blocks)
    assert pairs == [(i, j) for i in range(n_shards)
                     for j in range(i + 1, n_shards)]
    if n_shards % 2 == 0:
        half = n_shards // 2
        opposite = [(r, c) for r, c in blocks if (c - r) % n_shards == half]
        assert opposite == [] or all(r < half for r, _ in opposite)
        assert len(opposite) == half
    # the Pallas ring's direction: shard d holds shard d + s at step s
    for r, c in blocks:
        assert 1 <= (c - r) % n_shards <= n_shards // 2
    want, lim = single_device(planes, "moussaid", None)
    assert bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("law", ["moussaid", "powerlaw", "helbing"])
@pytest.mark.parametrize("comm,symmetric", [
    ("gather", True), ("ring", False), ("ring", True), ("ring_kernel", True)])
@pytest.mark.parametrize("cutoff", [None, 3.0])
def test_kernel_schedules_match_one_device(monkeypatch, law, comm,
                                           symmetric, cutoff):
    """Each schedule on 3 shards (odd D) with uneven dead shares, sorted
    per shard under a cutoff, against the one-device plain force; the
    launches are the schedule's own (Helbing never takes the half-ring)."""
    n_shards, k = 3, 40
    planes = shard_planes(n_shards * k, seed=11, device=CPU, extent=7.0,
                          n_shards=n_shards, sort=cutoff is not None)
    fake = FakeKernels(monkeypatch, law, cutoff, planes[0], k)
    got = run_schedule(planes, n_shards, law, comm, symmetric, cutoff)
    want, lim = single_device(planes, law, cutoff)
    assert bool(((got - want).abs() <= lim).all())
    forms = sorted({c[0] for c in fake.calls})
    sfx = "_cutoff" if cutoff is not None else ""
    if comm == "ring_kernel":
        assert fake.calls == [("ring_force", n_shards, n_shards * k)]
    elif comm == "ring" and symmetric and law != "helbing":
        assert forms == ["sym" + sfx, "sym_dense" + sfx]
    else:
        assert forms == ["dense" + sfx]
        per = n_shards if comm == "ring" else 1
        assert len(fake.calls) == n_shards * per


@pytest.mark.parametrize("n_shards", [2, 5])
def test_plain_ring_rotates_up_the_axis(monkeypatch, n_shards):
    """The plain ring (the CPU path of ``ring`` and ``ring_kernel``)
    rotates the column block and its global slot shard i -> i + 1, as the
    JAX package's ``_ring_force``: at step s shard d holds shard d - s."""
    k = 10
    planes = shard_planes(n_shards * k, seed=2, device=CPU, extent=5.0)
    x, y, vx, vy, rad, alive = planes[:6]
    seen = []
    real = cuda_forces.plain_law_force

    def spy(*args, cols=None, row_offset=0, col_offset=0, **kw):
        c0 = int(col_offset)
        assert torch.equal(cols[0], x[c0:c0 + k])
        seen.append((row_offset // k, c0 // k))
        return real(*args, cols=cols, row_offset=row_offset,
                    col_offset=col_offset, **kw)

    monkeypatch.setattr(cuda_forces, "plain_law_force", spy)
    mesh = make_mesh(n_shards, device="cpu")
    outs = mesh.run(lambda ax, d: cuda_forces.plain_sharded_force(
        "moussaid", x[d * k:(d + 1) * k], y[d * k:(d + 1) * k],
        vx[d * k:(d + 1) * k], vy[d * k:(d + 1) * k], rad[d * k:(d + 1) * k],
        alive[d * k:(d + 1) * k], law_params("moussaid"), ax, "ring"),
        list(range(n_shards)))
    by_shard = {}
    for r, c in seen:
        by_shard.setdefault(r, []).append(c)
    for d in range(n_shards):
        assert by_shard[d] == [(d - s) % n_shards for s in range(n_shards)]
    got = torch.stack([torch.cat([o[0] for o in outs]),
                       torch.cat([o[1] for o in outs])])
    want, lim = single_device(planes, "moussaid", None)
    assert bool(((got - want).abs() <= lim).all())


def test_half_ring_accumulator_needs_its_home_hop(monkeypatch):
    """Without the home hop of +(D // 2 + 1) the mirrored column sums land
    on the wrong shards: the check above would see it."""
    n_shards, k = 8, 8
    planes = shard_planes(n_shards * k, seed=9, device=CPU, extent=4.0)
    FakeKernels(monkeypatch, "moussaid", None, planes[0], k)
    real = cuda_forces._rotate

    def no_home(axis, tensors, perm):
        if perm == [(i, (i + n_shards // 2 + 1) % n_shards)
                    for i in range(n_shards)]:
            return tuple(tensors)
        return real(axis, tensors, perm)

    monkeypatch.setattr(cuda_forces, "_rotate", no_home)
    got = run_schedule(planes, n_shards, "moussaid", "ring", True, None)
    want, lim = single_device(planes, "moussaid", None)
    assert not bool(((got - want).abs() <= lim).all())
    assert math.isfinite(float(got.abs().max()))
    assert np.isfinite(want.numpy()).all()
