"""PyTorch port: the chunked closest point (the JAX package's
``closest_point_per_segment`` and its ``_cp_kernel``), the chunk scan of
the scenarios' default environment path.

The same numpy-seeded point sets and crowds go through the JAX package's
jnp path, its Pallas kernel in interpret mode, and the port's plain version
(on the CPU the kernel wrapper takes it).  The CUDA kernel is held against
the plain version bitwise on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from scenario_cases import (seeded_chunk_set, seeded_crowd_planes,
                            to_device)
from scenario_jax import one_torch_thread  # noqa: F401
from carla_social_force_model_tpu.env import pointsets as jpointsets
from carla_social_force_model_tpu.ops import geometry as jgeometry
from carla_social_force_model_tpu_torch.env.pointsets import (
    build_chunked_pointset, chunked_on)
from carla_social_force_model_tpu_torch.ops import geometry

CPU = "cpu"


def jax_set(pset):
    """The JAX package's ChunkedPointSet of a host-side port set."""
    return jpointsets.ChunkedPointSet(
        points=jnp.asarray(pset.points), valid=jnp.asarray(pset.valid),
        chunk_segment=jnp.asarray(pset.chunk_segment),
        centers=jnp.asarray(pset.centers),
        filter_radius=jnp.asarray(pset.filter_radius),
        num_segments=pset.num_segments)


def port_closest(x, y, pset):
    px, py, _ = to_device(x, y, np.ones(x.shape, bool), CPU)
    dist, bx, by, has = geometry.closest_point_per_segment(
        px, py, chunked_on(pset, CPU))
    return (dist.numpy(), np.stack([bx.numpy(), by.numpy()], -1),
            has.numpy())


def assert_closest_equal(got, want, rows):
    """``point`` and ``has_point`` equal on ``rows``, ``dist`` within 1e-6
    relative (sqrt and the squared distance may round differently)."""
    dist, point, has = got
    wdist, wpoint, whas = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(has[:, rows], whas[:, rows])
    np.testing.assert_array_equal(point[:, rows], wpoint[:, rows])
    np.testing.assert_allclose(dist[:, rows], wdist[:, rows], rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closest_point_matches_jax_jnp_and_pallas(seed):
    """Pads, an all-invalid chunk with real coordinates, an empty segment,
    ties across the chunks of a segment, dead agents at the far sentinel
    and a coincident pair: the JAX package's interpret-mode Pallas path
    on every row, its jnp path on the live rows.  (The jnp path gives a
    dead agent at 1e7 a point ~1e14 m^2 away; the kernel's padding test
    and the port drop it: its force is masked either way.)"""
    pset = seeded_chunk_set(seed)
    x, y, alive = seeded_crowd_planes(300, seed=seed + 10)
    got = port_closest(x, y, pset)
    pos = jnp.asarray(np.stack([x, y], -1))
    jset = jax_set(pset)
    every = np.ones(x.shape, bool)
    assert_closest_equal(got, jgeometry._closest_point_pallas(
        pos, jset, interpret=True), every)
    assert_closest_equal(got, jgeometry.closest_point_per_segment(
        pos, jset, use_pallas=False), alive)
    assert not got[2][:, ~alive].any()
    # the cases are there: a tie across chunks, an empty segment
    assert got[2][2].any() and not got[2][5].any()


@settings(max_examples=6, deadline=None)
@given(n_segments=st.integers(1, 6), n=st.integers(1, 70),
       chunk_size=st.sampled_from([8, 32, 128]), seed=st.integers(0, 999))
def test_closest_point_matches_jax_jnp_any_shape(n_segments, n, chunk_size,
                                                 seed):
    """Any segment, chunk and crowd count: the port's chunk scan and
    segmented reduction against the JAX package's jnp path."""
    rng = np.random.default_rng(seed)
    lists = [rng.uniform(-5, 5, (int(rng.integers(0, 3 * chunk_size)), 2))
             for _ in range(n_segments)]
    pset = build_chunked_pointset(lists, rng.uniform(-2, 2, (n_segments, 2)),
                                  rng.uniform(0, 8, n_segments),
                                  chunk_size=chunk_size)
    pos = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    got = port_closest(pos[:, 0].copy(), pos[:, 1].copy(), pset)
    want = jgeometry.closest_point_per_segment(jnp.asarray(pos),
                                               jax_set(pset),
                                               use_pallas=False)
    assert_closest_equal(got, want, np.ones(n, bool))


def test_chunk_scan_plain_on_cpu_and_segment_filter():
    """On CPU tensors the chunk scan's entry runs the plain version (no
    build, no launch); the flat index addresses the staged planes' minimum;
    the segment filter of a chunked set equals the JAX package's (strict
    <, negative radius clamped)."""
    from carla_social_force_model_tpu_torch.ops import statics
    pset = chunked_on(seeded_chunk_set(3), CPU)
    x, y, _ = seeded_crowd_planes(64, seed=4)
    px, py, _ = to_device(x, y, np.ones(64, bool), CPU)
    fx, fy = geometry.staged_chunk_planes(pset)
    before = dict(statics.LAUNCHES)
    dmin, idx = geometry.chunk_argmin(px, py, fx, fy)
    assert statics.LAUNCHES == before
    assert dmin.dtype == torch.float32 and idx.dtype == torch.int32
    fxx, fyy = fx.reshape(-1), fy.reshape(-1)
    d2 = ((fxx[idx.long()] - px[None, :]) ** 2
          + (fyy[idx.long()] - py[None, :]) ** 2)
    torch.testing.assert_close(d2, dmin, rtol=1e-6, atol=0)
    c = fx.shape[0]
    assert torch.equal(idx.long() // fx.shape[1],
                       torch.arange(c)[:, None].expand(c, 64))
    host = seeded_chunk_set(3)
    want = jgeometry.segment_filter_mask(
        jnp.asarray(np.stack([x, y], -1)), jax_set(host))
    np.testing.assert_array_equal(
        geometry.segment_filter_mask(px, py, pset).numpy(), np.asarray(want))
