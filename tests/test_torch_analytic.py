"""PyTorch port: the analytic border tier and the ORCA wall feed against the
JAX package.

The Douglas-Peucker split (``env/pointsets.analytic_split``), the flat
segment features and the chunk feed of ORCA (``build_static_features``), the
plain versions of the feed's kernels (``ops/geometry.py``,
``ops/statics.py``) and the analytic border-family terms
(``ops/cuda_env.fused_environment_terms(analytic=True)``).  Inputs are drawn
with numpy from a seed and fed to both packages; the JAX side runs its jnp
path and its Pallas kernels in interpret mode (as tests/test_orca_statics.py
and tests/test_env_pallas.py run them), and the float64 oracles of
tests/test_env_pallas.py and tests/oracle.py.  On the CPU the port's kernel
wrappers take the plain versions; the CUDA kernels are held against those on
the card (tests/test_torch_cuda.py).

Tolerances.  The split is host numpy on both sides: its arrays are equal
exactly.  The feed's distances follow tests/test_orca_statics.py's
``_assert_topk_equal`` (d2 rtol/atol 1e-6, the same empty slots,
coordinates 1e-5).  The terms use test_torch_env.py's bound for the sampled
terms, 1e-5 + 1e-5 |f|, on each pedestrian's force vector: the projection
``c = a + t*u`` rounds at the wall-length scale, which turns the force by
about 1e-6 rad, so the component across the force of a pedestrian that hugs
a wall carries an error of about 1e-6 |f| that a componentwise bound on the
near-zero component would flag (tests/test_env_pallas.py compares vectors
for the same reason).  Against the float64 oracle, the JAX package's own
vector bound, 3e-4 |f| + 3e-5.  The tie cases of the plain versions that
the wall-feed kernels are held to bitwise are bitwise too: their
coordinates lie on a 1/8 m grid, where every operation is exact.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from test_env_pallas import _analytic_lines, _border_oracle_f64
from carla_social_force_model_tpu.api import synthetic as jsyn
from carla_social_force_model_tpu.env import borders as jborders
from carla_social_force_model_tpu.env import pointsets as jps
from carla_social_force_model_tpu.models import stepper as jstepper
from carla_social_force_model_tpu.models.params import (
    SfmParams as JaxSfmParams)
from carla_social_force_model_tpu.models.state import PedState as JaxPedState
from carla_social_force_model_tpu.ops import geometry as jgeo
from carla_social_force_model_tpu.ops import orca as jorca
from carla_social_force_model_tpu.ops import pallas_env as jpe
from carla_social_force_model_tpu.ops import pallas_statics as jstatics
from carla_social_force_model_tpu_torch.api import synthetic as psyn
from carla_social_force_model_tpu_torch.env import borders as pborders
from carla_social_force_model_tpu_torch.env import pointsets as pps
from carla_social_force_model_tpu_torch.models import modes, stepper
from carla_social_force_model_tpu_torch.models.params import SfmParams
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.ops import (cuda_env, forces,
                                                    geometry, orca, statics)

CPU = "cpu"
#: the feed against the JAX package (tests/test_orca_statics.py)
D2_TOL, XY_TOL = 1e-6, 1e-5
#: the terms against the JAX package (tests/test_torch_env.py)
TERM_TOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the geometry sets of configs #2/#3 and the unsafe sections --------------

def unsafe_lines():
    """tests/test_env_pallas.py:557's sections: a side-jump point cloud and
    a collinear out-and-back chain (both must stay sampled) beside a
    straight wall, plus a corner that simplifies to two segments."""
    jump = np.concatenate([
        np.column_stack([np.linspace(0, 10, 101), np.full(101, -3.0)]),
        np.column_stack([np.linspace(0, 10, 101), np.full(101, 3.0)])])
    outback = np.concatenate([
        np.column_stack([np.linspace(0, 10, 101), np.zeros(101)]),
        np.column_stack([np.linspace(9.9, 5, 50), np.zeros(50)])])
    straight = np.column_stack([np.linspace(0, 10, 101), np.full(101, 8.0)])
    corner = np.concatenate([
        jborders.sample_borderline([-8.0, 2.0], [0.0, 2.0], 0.1),
        jborders.sample_borderline([0.0, 2.0], [0.0, 10.0], 0.1)])
    lines = [jump, outback, straight, corner]
    return lines, [ln[len(ln) // 2] for ln in lines], [12.0, 12.0, 12.0, 16.0]


def both_sets(which):
    """The same point set from both packages: config #2/#3's street-grid
    borders, config #3's parked cars (ellipses that never simplify), the
    analytic test lines of tests/test_env_pallas.py and the unsafe
    sections."""
    if which == "borders":
        return jsyn.synthetic_borders(40.0), psyn.synthetic_borders(40.0)
    if which == "cars":
        return jsyn.synthetic_obstacles(40.0), psyn.synthetic_obstacles(40.0)
    lines, centers, lengths = (_analytic_lines() if which == "analytic"
                               else unsafe_lines())
    return (jborders.build_border_set(lines, centers, lengths),
            pborders.build_border_set(lines, centers, lengths))


def assert_pointset_equal(got, want):
    for name in ("points", "valid", "chunk_segment", "centers",
                 "filter_radius"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.num_segments == want.num_segments


SETS = ["borders", "cars", "analytic", "unsafe"]


@pytest.mark.parametrize("which", SETS)
def test_analytic_split_equals_jax(which):
    """Section by section the same split, the same simplified vertices and
    the same (S, M) planes, bit for bit; the sampled remainder re-chunked
    alike."""
    jset, pset = both_sets(which)
    jg, jr = jps.analytic_split(jset)
    pg, pr = pps.analytic_split(pset, device=CPU)
    assert (pg is None) == (jg is None) and (pr is None) == (jr is None)
    if jg is not None:
        for name, jname in (("ax", "ax"), ("ay", "ay"), ("ux", "ux"),
                            ("uy", "uy"), ("inv_len2", "inv_len2"),
                            ("filter_radius", "filter_radius")):
            np.testing.assert_array_equal(getattr(pg, name).numpy(),
                                          np.asarray(getattr(jg, jname)),
                                          err_msg=name)
        np.testing.assert_array_equal(pg.centers.numpy(),
                                      np.asarray(jg.centers))
        assert pg.max_segments % 8 == 0 and pg.num_segments == jg.num_segments
    if jr is not None:
        assert_pointset_equal(pr, jr)
    expect = {"borders": (True, False), "cars": (False, True),
              "analytic": (True, True), "unsafe": (True, True)}[which]
    assert (pg is not None, pr is not None) == expect
    if which == "unsafe":
        assert pg.num_segments == 2 and pr.num_segments == 2
        assert sorted((pg.inv_len2 > 0).sum(dim=1).tolist()) == [1, 2]


def test_douglas_peucker_and_chain_cover_equal_jax():
    """Random walks and noisy polylines: the same kept vertices and the
    same coverage verdicts."""
    rng = np.random.default_rng(3)
    for trial in range(40):
        m = int(rng.integers(2, 300))
        steps = rng.normal(size=(m, 2)) * rng.choice([0.01, 0.1, 1.0])
        pts = np.cumsum(steps, axis=0)
        if trial % 3 == 0:     # nearly straight with a kink
            pts = np.column_stack([np.linspace(0, 10, m), np.zeros(m)])
            pts[m // 2:, 1] += np.linspace(0, 2, m - m // 2)
        for tol in (1e-3, 0.05):
            got = pps._douglas_peucker(pts, tol)
            np.testing.assert_array_equal(got, jps._douglas_peucker(pts, tol))
            assert (pps._chain_covers(pts, pts[got], tol)
                    == jps._chain_covers(pts, pts[got], tol))


@pytest.mark.parametrize("which", SETS)
def test_static_features_equal_jax(which):
    """The ORCA feed of a point set: the flat segment features exactly, and
    the chunk planes of the remainder equal to the JAX package's chunks
    with their invalid slots at PAD_COORD."""
    jset, pset = both_sets(which)
    jf = jps.build_static_features(jset)
    pf = pps.build_static_features(pset, CPU)
    assert (pf.seg is None) == (jf.seg is None)
    assert (pf.rest is None) == (jf.rest is None)
    if jf.seg is not None:
        for name in ("ax", "ay", "ux", "uy", "il2", "ccx", "ccy", "rad"):
            np.testing.assert_array_equal(getattr(pf.seg, name).numpy(),
                                          np.asarray(getattr(jf.seg, name)),
                                          err_msg=name)
        assert pf.seg.num_features == jf.seg.num_features
        jg, _ = jps.analytic_split(jset)
        direct = pps.segment_features(pps.analytic_split(pset, device=CPU)[0])
        np.testing.assert_array_equal(direct.ax.numpy(),
                                      np.asarray(jps.segment_features(jg).ax))
    if jf.rest is not None:
        valid = np.asarray(jf.rest.valid)
        for k, plane in enumerate((pf.rest.x, pf.rest.y)):
            want = np.where(valid, np.asarray(jf.rest.points[..., k]),
                            np.float32(pps.PAD_COORD))
            np.testing.assert_array_equal(plane.numpy(), want)
        real = valid.any(axis=1)
        assert (pf.rest.radius.numpy() >= 0).tolist() == real.tolist()


# -- the feed: closest planes, the top-k selection, the entry -----------------

def crowd(n, seed, extent):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    alive = rng.uniform(size=n) < 0.9
    return pos, alive


def assert_topk_equal(got, want):
    """tests/test_orca_statics.py's ``_assert_topk_equal``."""
    d2a, wxa, wya = (v.numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v) for v in got)
    d2b, wxb, wyb = (np.asarray(v) for v in want)
    np.testing.assert_allclose(d2a, d2b, rtol=D2_TOL, atol=D2_TOL)
    v = np.isfinite(d2a)
    assert (v == np.isfinite(d2b)).all()
    np.testing.assert_allclose(np.where(v, wxa, 0), np.where(v, wxb, 0),
                               atol=XY_TOL)
    np.testing.assert_allclose(np.where(v, wya, 0), np.where(v, wyb, 0),
                               atol=XY_TOL)


def test_feature_closest_planes_equal_jax():
    jset, pset = both_sets("analytic")
    jf, pf = jps.build_static_features(jset), pps.build_static_features(
        pset, CPU)
    pos, _ = crowd(300, 1, 22.0)
    for nd in (4.0, 15.0):
        got = geometry.feature_closest_planes(t(pos[:, 0]), t(pos[:, 1]),
                                              pf.seg, nd)
        want = jgeo.feature_closest_planes(jnp.asarray(pos[:, 0]),
                                           jnp.asarray(pos[:, 1]), jf.seg, nd)
        assert_topk_equal(got, want)
        # feature blocks change nothing
        blocked = geometry.feature_closest_planes(
            t(pos[:, 0]), t(pos[:, 1]), pf.seg, nd, max_group_elems=700)
        for a, b in zip(blocked, got):
            assert torch.equal(a, b)


def test_closest_point_per_chunk_equals_jax():
    """The chunk planes against the JAX jnp path and its interpret-mode
    kernel (finite entries; the kernel leaves a skipped chunk's point at
    0), and the distances against a numpy brute force."""
    jset, pset = both_sets("cars")
    pf = pps.build_static_features(pset, CPU)
    pos, alive = crowd(150, 2, 42.0)
    nd = 12.0
    px, py = jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])
    got = geometry.closest_point_per_chunk(t(pos[:, 0]), t(pos[:, 1]),
                                           pf.rest, nd)
    want = jgeo.closest_point_per_chunk(px, py, jset, nd, use_pallas=False)
    assert_topk_equal(got, want)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    kern = jgeo.closest_point_per_chunk(px, py, jset, nd,
                                        alive=jnp.asarray(alive),
                                        use_pallas=True, interpret=True)
    d2 = got[0].numpy()
    assert (np.isfinite(d2[:, alive])
            == np.isfinite(np.asarray(kern[0])[:, alive])).all()
    fin = np.isfinite(d2) & np.isfinite(np.asarray(kern[0]))
    for a, b in zip(got, kern):
        np.testing.assert_allclose(a.numpy()[fin], np.asarray(b)[fin],
                                   rtol=D2_TOL, atol=XY_TOL)
    pts, val = np.asarray(jset.points), np.asarray(jset.valid)
    for c in range(pts.shape[0]):
        q = pts[c][val[c]].astype(np.float64)
        ref = ((q[:, None, :] - pos[None].astype(np.float64)) ** 2).sum(
            -1).min(0)
        ok = np.isfinite(d2[c])
        np.testing.assert_allclose(d2[c][ok], ref[ok], rtol=1e-5, atol=1e-4)
        assert (ref[~ok] > nd * nd * (1 - 1e-5)).all()


def test_k_smallest_features_equals_jax_with_ties():
    """Distances drawn from a few values (many exact ties) and empty
    entries: the same selection in the same order, the lowest feature
    index first among equals."""
    rng = np.random.default_rng(11)
    d2 = rng.choice(np.float32([0.5, 1.0, 2.0, 3.5]),
                    size=(37, 64)).astype(np.float32)
    d2[rng.random((37, 64)) < 0.3] = np.inf
    pay = rng.normal(size=(2, 37, 64)).astype(np.float32)
    payf = np.where(np.isfinite(d2), pay, 0.0).astype(np.float32)
    for k in (1, 3, 8, 40):
        (gx, gy), gv = geometry.k_smallest_features(t(d2),
                                                    (t(payf[0]), t(payf[1])),
                                                    k)
        (wx, wy), wv = jgeo.k_smallest_features(
            jnp.asarray(d2), (jnp.asarray(payf[0]), jnp.asarray(payf[1])), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


TOPK_CASES = [(k, src) for k in (1, 3, 8) for src in ("segment", "chunk")]


@pytest.mark.parametrize("k,src", TOPK_CASES)
def test_nearest_features_topk_equals_jax(k, src):
    """``nearest_features_topk`` on the CPU (the plain version) against the
    JAX jnp path and its interpret-mode kernel: config #2/#3's street-grid
    segment features, config #3's car chunks."""
    jset, pset = both_sets("borders" if src == "segment" else "cars")
    jf = jps.build_static_features(jset)
    pf = pps.build_static_features(pset, CPU)
    jsrc, psrc = (jf.seg, pf.seg) if src == "segment" else (jset, pf.rest)
    pos, alive = crowd(256, 10 + k, 42.0)
    px, py = jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])
    nd = 15.0
    got = statics.nearest_features_topk(t(pos[:, 0]), t(pos[:, 1]), psrc, k,
                                        nd, alive=t(alive))
    want = jstatics.nearest_features_topk(px, py, jsrc, k, nd,
                                          use_pallas=False)
    assert_topk_equal(got, want)
    assert np.isfinite(got[0].numpy()).any()
    kern = jstatics.nearest_features_topk(px, py, jsrc, k, nd,
                                          alive=jnp.asarray(alive),
                                          use_pallas=True, interpret=True)
    assert_topk_equal(tuple(a[:, alive] for a in got),
                      tuple(np.asarray(a)[:, alive] for a in kern))


def test_mixed_split_merges_both_parts_like_jax():
    """An analytic part and a sampled remainder (the unsafe sections): each
    gives its own top-k and the (2k, N) merge picks the overall k, as the
    JAX package's ``_static_topk``."""
    jset, pset = both_sets("unsafe")
    jf = jps.build_static_features(jset)
    pf = pps.build_static_features(pset, CPU)
    assert pf.seg is not None and pf.rest is not None
    pos, alive = crowd(200, 5, 13.0)
    for k in (2, 3):
        got = orca._static_topk(t(pos[:, 0]), t(pos[:, 1]), pf, k, 12.0,
                                t(alive))
        want = jorca._static_topk(jnp.asarray(pos[:, 0]),
                                  jnp.asarray(pos[:, 1]), jf, k, 12.0, None)
        assert_topk_equal(got, want)


def test_topk_ties_across_feature_tiles_follow_the_jnp_path():
    """Two features at exactly the same distance in the first tile of 128
    and a nearer one in the second: the lower index stays first among the
    equals, as the JAX package's jnp path keeps it (k_smallest_features),
    the order the port's kernels keep too (tests/test_torch_cuda.py)."""
    f = 130
    ax = np.full(f, 50.0, np.float32)
    ay = np.zeros(f, np.float32)
    ax[0], ax[1], ay[129] = 1.0, -1.0, 0.5
    ax[129] = 0.0
    z = np.zeros(f, np.float32)
    planes = dict(ax=ax, ay=ay, ux=z, uy=z, il2=z, ccx=ax, ccy=ay, rad=z)
    want = jstatics.nearest_features_topk(
        jnp.zeros(1), jnp.zeros(1), jps.SegmentFeatures(
            **{k: jnp.asarray(v) for k, v in planes.items()},
            num_features=f), 2, 10.0, use_pallas=False)
    got = statics.nearest_features_topk(
        torch.zeros(1), torch.zeros(1),
        pps.SegmentFeatures(**{k: t(v) for k, v in planes.items()}), 2, 10.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1][:, 0].tolist() == [0.0, 1.0]


@pytest.mark.parametrize("k", [1, 3, 8])
def test_topk_plain_keeps_ties_a_lane_stride_apart_like_jax(k):
    """``topk_plain``, the plain version the segment top-k kernel is held
    to bitwise on the card, on segment features whose equal distances lie
    at feature indices 1, 4 and 5 apart (the kernel's four lanes take
    every fourth hit feature), more equal candidates than k, against the JAX
    package's jnp path: d2, the points and so the selection equal
    bitwise.  The coordinates lie on a 1/8 m grid, where every operation
    is exact: the jnp path on the CPU fuses a product into the sum after
    it (one rounding where the port rounds twice)."""
    from orca_cases import tie_crowd, tie_segment_planes
    f, nd = 301, 15.0
    planes = tie_segment_planes(f)
    x, y, _ = tie_crowd(500, seed=k)
    feat = pps.SegmentFeatures(**{a: t(v) for a, v in planes.items()})
    got = statics.topk_plain(t(x), t(y), feat, k, nd)
    want = jstatics.nearest_features_topk(
        jnp.asarray(x), jnp.asarray(y), jps.SegmentFeatures(
            **{a: jnp.asarray(v) for a, v in planes.items()},
            num_features=f), k, nd, use_pallas=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the k-th slot cuts through equal candidates: the order among equals
    # decides the selection
    d2 = got[0].numpy()
    full = geometry.feature_closest_planes(t(x), t(y), feat, nd)[0].numpy()
    kth = d2[k - 1]
    cut = np.isfinite(kth) & ((full == kth).sum(axis=0)
                              > (d2 == kth).sum(axis=0))
    assert int(cut.sum()) > 0


@pytest.mark.parametrize("kk", [64, 200])
def test_chunk_closest_plain_equals_jax_on_ragged_chunks(kk):
    """``chunk_closest_plain``, the plain version the chunk_closest kernel
    is held to bitwise on the card, on chunks of 64 and 200 slots with
    ragged valid slots, empty chunks and equal distances at different
    points inside a chunk, against the JAX package's jnp path: d2 and the
    points equal bitwise (coordinates on the 1/8 m grid, as above)."""
    from orca_cases import tie_chunk_set, tie_crowd
    nd = 15.0
    pset = tie_chunk_set(23, kk, seed=kk)
    x, y, _ = tie_crowd(300, seed=kk)
    got = geometry.chunk_closest_plain(t(x), t(y),
                                       pps.chunk_features(pset, CPU), nd)
    jset = jps.ChunkedPointSet(
        **{a: jnp.asarray(getattr(pset, a)) for a in (
            "points", "valid", "chunk_segment", "centers", "filter_radius")},
        num_segments=pset.num_segments)
    want = jgeo.closest_point_per_chunk(jnp.asarray(x), jnp.asarray(y), jset,
                                        nd, use_pallas=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # some pedestrian meets its chunk minimum, within reach, at two slots
    real = np.where(pset.valid[..., None], pset.points, np.inf)
    d2 = ((real[:, :, None, :] - np.stack([x, y], 1)[None, None]) ** 2).sum(-1)
    low = d2.min(axis=1, keepdims=True)
    assert bool((((d2 == low).sum(axis=1) > 1) & (low[:, 0] <= nd * nd)).any())
    assert not pset.valid.all(axis=1).all() and not pset.valid.any(axis=1).all()


def test_nearest_features_topk_refuses_k_above_8():
    jset, pset = both_sets("analytic")
    pf = pps.build_static_features(pset, CPU)
    z = torch.zeros(4)
    for k in (0, 9):
        with pytest.raises(ValueError, match="k must be"):
            statics.nearest_features_topk(z, z, pf.seg, k, 10.0)


def test_feed_kernels_need_cuda_tensors():
    """The kernel wrappers launch or raise: CPU tensors are refused, never
    run another way."""
    pf = pps.build_static_features(both_sets("analytic")[1], CPU)
    z = torch.zeros(4)
    for fn, src in ((statics.seg_topk, pf.seg), (statics.chunk_topk, pf.rest)):
        with pytest.raises(ValueError, match="CUDA"):
            fn(z, z, src, 2, 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        statics.chunk_closest(z, z, pf.rest, 10.0)


# -- the analytic border-family terms ------------------------------------------

def states(n, seed):
    """The same state in both packages: dead agents and crossing ones."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-22, 22, (n, 2)).astype(np.float32)
    vel = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.15
    mode = np.where(rng.uniform(size=n) < 0.2, modes.CROSSING_ROAD,
                    modes.WALKING_SIDEWALK).astype(np.int32)
    jst = JaxPedState.empty(n).replace_coords(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel),
        radius=jnp.asarray(radius), alive=jnp.asarray(alive),
        mode=jnp.asarray(mode))
    pst = dataclasses.replace(
        PedState.empty(n, device=CPU), pos_x=t(pos[:, 0]), pos_y=t(pos[:, 1]),
        vel_x=t(vel[:, 0]), vel_y=t(vel[:, 1]), radius=t(radius),
        alive=t(alive), mode=t(mode))
    return jst, pst


def both_scenes(which):
    jset, pset = both_sets(which)
    js = jstepper.prepare_scene(jstepper.Scene(spawn=None, borders=jset),
                                analytic=True)
    spawn = psyn.synthetic_crowd(4, device=CPU)
    ps = stepper.prepare_scene(stepper.Scene(spawn=spawn, borders=pset),
                               analytic=True)
    return js, ps, pset


def term_array(pair):
    return np.stack([np.asarray(a) if not isinstance(a, torch.Tensor)
                     else a.numpy() for a in pair], axis=-1)


def assert_terms_close(got, want, label):
    """Per pedestrian, |got - want| <= TERM_TOL * (1 + |want|) on the force
    vectors (see the module docstring)."""
    err = np.linalg.norm(got - want, axis=1)
    lim = TERM_TOL + TERM_TOL * np.linalg.norm(want, axis=1)
    assert np.all(err <= lim), (label, (err / lim).max())


@pytest.mark.parametrize("use_radius", [False, True])
def test_analytic_border_terms_match_jax_and_oracle(use_radius):
    """The border and space-repulsive terms of the analytic tier (three
    walls, a single point, an ellipse in the ``#rest`` part) against the
    JAX package's interpret-mode kernels and the float64 oracle."""
    js, ps, _ = both_scenes("analytic")
    assert ps.borders_geom is not None and ps.borders_seg_rest is not None
    jst, pst = states(83, 4)
    kw = dict(enable_border=True, enable_space_repulsive=True,
              use_ped_radius=use_radius)
    jp, pp = JaxSfmParams(**kw), SfmParams(**kw)
    want = jpe.fused_environment_terms(jst, js, jp, None, ped_tile=128,
                                       interpret=True, analytic=True)
    got = cuda_env.fused_environment_terms(pst, ps, pp, None, analytic=True)
    plain = cuda_env.plain_environment_terms(pst, ps, pp, None, analytic=True)
    assert sorted(got) == sorted(want) == ["border_force",
                                           "space_repulsive_force"]
    for name in got:
        g, w = term_array(got[name]), term_array(want[name])
        assert_terms_close(g, w, name)
        np.testing.assert_allclose(g, term_array(plain[name]), rtol=1e-6,
                                   atol=1e-6)
        assert np.all(g[~pst.alive.numpy()] == 0.0)
        crossing = forces.crossing_mask(pst.mode).numpy()
        assert np.all(g[crossing] == 0.0) and np.abs(g).max() > 0
    lines, centers, lengths = _analytic_lines()
    ref = _border_oracle_f64(lines, centers, lengths, jst, pp.border,
                             use_radius, analytic_idx={0, 1, 2, 3})
    g = term_array(got["border_force"])
    err = np.linalg.norm(g - ref, axis=1)
    assert np.all(err <= 3e-4 * np.linalg.norm(ref, axis=1) + 3e-5)


def test_unsafe_split_sums_its_parts():
    """Where only a straight wall and a corner simplify, the analytic term
    plus its ``#rest`` part (the side jump and the out-and-back chain)
    against the JAX package and the float64 oracle (chain distance on the
    two sections that simplify, sampled argmin on the rest)."""
    js, ps, _ = both_scenes("unsafe")
    jst, pst = states(64, 6)
    p = SfmParams(enable_border=True)
    got = term_array(cuda_env.fused_environment_terms(
        pst, ps, p, None, analytic=True)["border_force"])
    want = jpe.fused_environment_terms(jst, js, JaxSfmParams(
        enable_border=True), None, ped_tile=128, interpret=True,
        analytic=True)["border_force"]
    assert_terms_close(got, term_array(want), "border_force")
    lines, centers, lengths = unsafe_lines()
    ref = _border_oracle_f64(lines, centers, lengths, jst, p.border, False,
                             analytic_idx={2, 3})
    err = np.linalg.norm(got - ref, axis=1)
    assert np.all(err <= 3e-4 * np.linalg.norm(ref, axis=1) + 3e-5)


def test_sets_that_do_not_simplify_stay_sampled():
    """Config #3's ellipse cars as borders: nothing simplifies, so the
    analytic tier computes the sampled terms bit for bit, which match the
    reference's sampled argmin (tests/oracle.py) at test_torch_env.py's
    oracle bound."""
    js, ps, pset = both_scenes("cars")
    assert ps.borders_geom is None
    _, pst = states(96, 7)
    p = SfmParams(enable_border=True, enable_space_repulsive=True)
    got = cuda_env.fused_environment_terms(pst, ps, p, None, analytic=True)
    sampled = cuda_env.fused_environment_terms(pst, ps, p, None)
    for name in got:
        for a, b in zip(got[name], sampled[name]):
            assert torch.equal(a, b), name
    from carla_social_force_model_tpu_torch.env.pointsets import (
        _per_segment_points)
    pts = [a.astype(np.float64) for a in _per_segment_points(pset)]
    ref = oracle.border_force(
        pst.pos.numpy().astype(np.float64), pst.mode.numpy(),
        pst.radius.numpy(), pst.alive.numpy(), pts,
        np.asarray(pset.centers, np.float64),
        np.asarray(pset.filter_radius, np.float64), p.border.a, p.border.b)
    np.testing.assert_allclose(term_array(got["border_force"]), ref,
                               rtol=1e-4, atol=1e-4)


def test_analytic_compact_equals_dense():
    """The compacted form (the gate on K = M segments per section, a table
    forced narrow) gives the dense form's terms."""
    js, ps, _ = both_scenes("borders")
    _, pst = states(120, 8)
    pst = dataclasses.replace(pst, pos_x=pst.pos_x * 1.8,
                              pos_y=pst.pos_y * 1.8)
    p = SfmParams(enable_border=True, enable_space_repulsive=True)
    dense = cuda_env.fused_environment_terms(pst, ps, p, None, analytic=True)
    for ms in (1, 4):
        comp = cuda_env.fused_environment_terms(pst, ps, p, None,
                                                analytic=True, compact=True,
                                                max_surv=ms)
        for name in dense:
            for a, b in zip(comp[name], dense[name]):
                assert torch.equal(a, b), name


def test_prepare_scene_analytic_and_orca_are_lazy_and_idempotent():
    jset, pset = both_sets("analytic")
    spawn = psyn.synthetic_crowd(4, device=CPU)
    off = stepper.prepare_scene(stepper.Scene(spawn=spawn, borders=pset,
                                              static_obstacles=pset))
    assert off.borders_seg is not None and off.borders_geom is None
    assert off.borders_feat is None and off.obstacles_feat is None
    on = stepper.prepare_scene(off, analytic=True, orca=True)
    assert on.borders_geom is not None and on.borders_seg_rest is not None
    assert on.borders_feat.seg is not None and on.obstacles_feat is not None
    again = stepper.prepare_scene(on, analytic=True, orca=True)
    assert again.borders_geom is on.borders_geom
    assert again.borders_feat is on.borders_feat
    jon = jstepper.prepare_scene(jstepper.Scene(spawn=None, borders=jset),
                                 analytic=True, orca=True)
    np.testing.assert_array_equal(on.borders_geom.ax.numpy(),
                                  np.asarray(jon.borders_geom.ax))
    assert_pointset_equal(pps.analytic_split(pset, device=CPU)[1],
                          jps.analytic_split(jset)[1])
